"""Probes of the port's own tracing (gmix_tpu_torch/obs.py) on the card, at
one cell of the benchmark (h100_bench, BENCHMARK.json):

    python tools/torch_obs_probe.py slow --workload ref-s54 [--seconds 90] [--every 5] [--seed N] [--out FILE]
    python tools/torch_obs_probe.py cost --workload ref-s1 [--jobs 4] [--seed N] [--out FILE]

`slow` is one fresh process: `obs.enable()` from its start, then the cell's
jobs (reset, compress, reset, decompress) back to back until `--seconds`
after the start. Every `--every` seconds it prints a row: the replays timed
in that interval (`obs.samples()`: the median `device_step_us`, the median
and the sum over the interval of `device_gap_us`, the device's idle time
before a replay, both from CUDA events, no profiler), the median host time
of a `gmix.replay.*` span, the host's wall a byte step of the passes that
ended in it, and nvidia-smi's SM and memory clocks, power draw and
temperature read at its end; its last row holds every timed replay
(seconds since the start, variant, step us, gap us). Run it in several
fresh processes: a slow phase that lies in the device's step shows in
`device_step_us`, one on the host's side in `device_gap_us` and the
passes' wall.

`cost` is one process: after the settling, untraced jobs with `obs` off and
on in turns (the compress pass's wall a byte step each), then the harness's
traced window (`Cell.traced`) with the port's spans and with them switched
off, in turns (its wall a step).

Prints one JSON object a line (also to `--out`). Needs a CUDA device.
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SMI = "clocks.sm,clocks.mem,power.draw,temperature.gpu"


def smi() -> dict:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={SMI}", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30)
    vals = out.stdout.strip().splitlines()[0].split(", ") if out.returncode == 0 and out.stdout.strip() else []
    return dict(zip(SMI.split(","), vals))


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip()


def cell_for(name: str, seed: int):
    from h100_bench import harness, registry

    bench = registry.benchmark(Path.cwd())
    w = registry.workload(bench, name)
    cfg, mix = registry.config(w["config"]), registry.traffic(w["traffic"])
    return harness.Cell(cfg, mix, seed, "cuda:0"), mix


def median(xs):
    return statistics.median(xs) if xs else None


def slow(args, emit) -> None:
    import torch

    from gmix_tpu_torch import obs

    wall0_ns, perf0 = time.time_ns(), time.perf_counter()

    def since_start_ns(ns: int) -> float:
        """A Unix-ns stamp as seconds since the process's start."""
        return (ns - wall0_ns) / 1e9 + (perf0 - START)

    obs.enable()
    clocks, stop = [], threading.Event()

    def sample_clocks() -> None:
        while not stop.wait(args.every - (time.perf_counter() - START) % args.every):
            clocks.append((time.perf_counter() - START, smi()))

    thread = threading.Thread(target=sample_clocks, daemon=True)
    thread.start()
    cell, mix = cell_for(args.workload, args.seed)
    per = -(-len(cell.data) // cell.S)
    per = -(-per // cell.chunk) * cell.chunk
    passes = []  # (end since start, compress wall a step, decompress wall a step)
    while time.perf_counter() - START < args.seconds:
        job = cell.job()
        passes.append((time.perf_counter() - START, job.compress_s / per, job.decompress_s / per))
    stop.set()
    thread.join(timeout=60)
    samples = obs.samples()
    spans = [(since_start_ns(e), (e - s) / 1e3) for n, s, e in obs.spans() if n.startswith("gmix.replay.")]
    obs.disable()
    cell.close()
    emit({"probe": "slow", "workload": args.workload, "seed": args.seed, "card": card(), "torch": torch.__version__,
          "samples": len(samples), "jobs": len(passes)})
    edges = [args.every * k for k in range(int(args.seconds // args.every) + 2)]
    for lo, hi in zip(edges, edges[1:]):
        got = [r for r in samples if lo <= since_start_ns(r["t_ns"]) < hi and r["variant"].endswith("/byte")]
        reps = [us for t, us in spans if lo <= t < hi]
        done = [p for p in passes if lo <= p[0] < hi]
        smi_at = [c for t, c in clocks if lo < t <= hi + 0.5]
        if not (got or reps or done):
            continue
        emit({"t0_s": lo, "t1_s": hi, "timed": len(got),
              "device_step_us": median([r["device_step_us"] for r in got]),
              "device_gap_us": median([r["device_gap_us"] for r in got]),
              "device_gap_us_sum": sum(r["device_gap_us"] for r in got),
              "replays": len(reps), "replay_span_us": median(reps),
              "compress_ms_per_step": median([1e3 * p[1] for p in done]),
              "decompress_ms_per_step": median([1e3 * p[2] for p in done]),
              "smi": smi_at[-1] if smi_at else None})
    emit({"timed_replays": [[round(since_start_ns(r["t_ns"]), 3), r["variant"], round(r["device_step_us"], 1),
                              round(r["device_gap_us"], 2)] for r in samples]})


@contextlib.contextmanager
def spans_off():
    """The port's spans and timed replays switched off, while a profiler
    records too."""
    from gmix_tpu_torch import obs

    saved = obs.replays, obs.span
    obs.replays, obs.span = (lambda: None), (lambda name: contextlib.nullcontext())
    try:
        yield
    finally:
        obs.replays, obs.span = saved


def cost(args, emit) -> None:
    import torch

    from gmix_tpu_torch import obs

    cell, mix = cell_for(args.workload, args.seed)
    cell.job()  # captures
    while time.perf_counter() - START < args.settle:
        cell.job()
    per = -(-len(cell.data) // cell.S)
    per = -(-per // cell.chunk) * cell.chunk
    rows = {"off": [], "on": []}
    for i in range(2 * args.jobs):
        on = i % 4 in (1, 2)  # off, on, on, off, ...
        if on:
            obs.enable()
        job = cell.job()
        if on:
            obs.disable()
        rows["on" if on else "off"].append(1e3 * job.compress_s / per)
    traced = {"spans": [], "no_spans": []}
    for i in range(4):
        with spans_off() if i in (1, 2) else contextlib.nullcontext():
            t = cell.traced(mix["trace_steps"])
        traced["no_spans" if i in (1, 2) else "spans"].append(t.window_ns / 1e6 / t.steps)
    cell.close()
    emit({"probe": "cost", "workload": args.workload, "seed": args.seed, "card": card(), "torch": torch.__version__,
          "untraced_compress_ms_per_step": rows,
          "obs_enable_cost": median(rows["on"]) / median(rows["off"]) - 1,
          "traced_wall_ms_per_step": traced,
          "span_cost": median(traced["spans"]) / median(traced["no_spans"]) - 1})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=("slow", "cost"))
    ap.add_argument("--workload", default="ref-s54")
    ap.add_argument("--seed", type=int, default=271828182845)
    ap.add_argument("--seconds", type=float, default=90.0)
    ap.add_argument("--every", type=float, default=5.0)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--settle", type=float, default=50.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_obs_probe: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # as the benchmark runs
    out = open(args.out, "a") if args.out else None

    def emit(row) -> None:
        line = json.dumps(row)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    try:
        (slow if args.probe == "slow" else cost)(args, emit)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
