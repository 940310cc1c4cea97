"""One run of one cell of the benchmark:

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (BENCHMARK.json names the cell's configuration
and traffic mix). It needs as many CUDA devices as the cell asks for and
exits with 2 without a result otherwise. The last line of standard output
is the result, one JSON object: with `--trace 0` the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics; `correct` holds when every
number compared (its last key, `checks`) is within its limit. The same
numbers close standard error. The program's kernels are built under the
checkout's build/ on the first run and loaded from there after it.
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gmix_tpu")


def loaded_forbidden(modules=None) -> list:
    """Top-level names of the loaded modules (`sys.modules` unless given),
    compared whole, that the port must not bring in."""
    return sorted({m.split(".")[0] for m in (sys.modules if modules is None else modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def metric(value, unit: str) -> dict:
    return {"value": value, "unit": unit}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    # the program's caches inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / sub)

    from . import registry

    bench = registry.benchmark(root)
    cell = registry.workload(bench, args.workload)
    config = registry.config(cell["config"])
    mix = registry.traffic(cell["traffic"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100_bench: the cell {args.workload} needs {cell['chips']} CUDA device(s), found {n}", file=sys.stderr)
        return 2

    from .check import LIMITS, correct
    from .harness import run_cell

    torch.set_num_threads(1)  # the host's work between replays is small; no idle pool of threads beside it

    def log(msg: str) -> None:
        print(f"h100_bench: {msg}", file=sys.stderr, flush=True)

    kind = torch.cuda.get_device_name(0)
    card = power_limit()
    log(f"{args.workload} seed {args.seed}: {kind} ({card})")
    out = run_cell(config, mix, args.seed, args.seconds, bool(args.trace), "cuda:0", START, log)
    run, verdict = out["run"], out["verdict"]
    run.peaks = registry.peaks(kind)

    bad = loaded_forbidden()
    if bad:
        print(f"h100_bench: the process loaded {bad}: the benchmark runs the port alone", file=sys.stderr)
        return 3

    jobs = run.jobs
    if args.trace:
        metrics = {}
        for name, m in registry.per_layer_for(bench, args.workload).items():
            value = registry.metric_reader(name)(run)
            if value is not None:
                metrics[name] = metric(value, m["unit"])
        for note in run.notes:
            log(note)
    else:
        values = {
            "encode_Bps": run.file_bytes * len(jobs) / sum(j.encode_s for j in jobs),
            "decode_Bps": run.file_bytes * len(jobs) / sum(j.decode_s for j in jobs),
            "bpb": 8 * out["archive_bytes"] / run.file_bytes,
            "peak_mem_GB": out["peak"] / 1e9,
            "setup_s": out["setup_s"],
        }
        metrics = {name: metric(values[name], m["unit"])
                   for name, m in registry.end_to_end_for(bench, args.workload).items()}
    numbers = verdict["numbers"]
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
    device = {"platform": "gpu", "kind": kind, "count": 1, "memory_peak_bytes": int(out["peak"])}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_ns() / 1e9
        device["window_s"] = run.trace.window_ns / 1e9
    result = {"correct": correct(numbers, out["failed"]), "attempted": len(jobs), "failed": out["failed"], "metrics": metrics,
              "device": device}
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
    result["card"] = card
    result["window_s"] = out["window_s"]
    result["reference_s"] = verdict["reference_s"]
    result["checks"] = checks
    for k, c in checks.items():
        print(f"h100_bench: check {k} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
