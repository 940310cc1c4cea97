"""The control of `correct`: the reference put in the program's place with
its state held in bfloat16, the next precision below the spec's float32
(every float leaf rounded after each byte), at the cell's own size: the
same file, streams and bytes a run's check codes. Its code bytes stand as
the program's archive (`check.archive`) and go through the run's own
comparison (`check.judge`, `check.correct`), which must come out not
correct. The reference has no decoder, so the control stands in for the
encode alone: its archive is the only job's, and no decode is judged.

    python3 -m h100_bench.control --workload <cell> --seeds <n> [<n> ...] [--out FILE]

CPU work alone (the reference runs on the CPU), the seeds side by side; on
the machine that holds the card it reads what a run there would. One JSON
line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from . import check, registry, traffic


def reading(config: dict, mix: dict, seed: int) -> dict:
    """The control's verdict for one seed of a cell: `correct` and each
    number compared beside its limit."""
    data = traffic.make_file(mix, seed)
    streams = traffic.check_streams(mix, seed)
    spec, S, chunk = config["spec"], mix["streams"], mix["chunk"]
    t0 = time.perf_counter()
    low = check.reference_prefixes(spec, data, S, chunk, streams, mix["check_bytes"], seed, bfloat16_state=True)
    blob = check.archive(check.expected_header(spec, data, S, chunk), S, low)
    verdict = check.judge(spec, data, mix, seed, blob, [blob], [], streams)
    numbers = verdict["numbers"]
    return {"seed": seed, "streams": streams, "check_bytes": mix["check_bytes"],
            "reference_code_bytes": verdict["reference_bytes"], "control_code_bytes": sum(map(len, low.values())),
            "correct": check.correct(numbers, 0), "seconds": time.perf_counter() - t0,
            "checks": {k: {"value": v, "limit": check.LIMITS[k]} for k, v in numbers.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bench = registry.benchmark(Path.cwd())
    cell = registry.workload(bench, args.workload)
    config, mix = registry.config(cell["config"]), registry.traffic(cell["traffic"])
    with ThreadPoolExecutor(len(args.seeds)) as pool:  # each seed's reference processes side by side
        rows = [{"workload": args.workload, **r} for r in pool.map(lambda n: reading(config, mix, n), args.seeds)]
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
