"""The benchmark of `gmix_tpu_torch` on an NVIDIA H100:

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding BENCHMARK.json. Everything a cell is made
of is data found by its name: the configuration in `configs/<name>.json`,
the traffic mix in `traffic/<name>.json`, each per-layer metric's reader in
`metrics/<name>.py`, the card's peaks in `peaks.json`. `reference/` is the
plain torch reference the archives are held against (`check.py`).
Importing this package imports neither torch nor the program.
"""
