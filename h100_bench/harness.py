"""One run of one cell: set-up, the measured window of whole jobs, the traced
window (`--trace 1`), then the check against the reference.

Set-up (counted in `setup_s`, from the process's start to the end of the
capturing job): the program's import and kernel library, a predictor of S
fresh streams (the LSTM's weights from the seed), the fresh one-stream
state it is reset to, and one whole job, which captures every CUDA graph
the window replays (encode and decode, the byte that wraps the LSTM's
window, the backward pass). The program captures a graph only when its
chunk first needs it and runs the whole chunk, so one job is the shortest
run that captures them all.

Settling (in neither `setup_s` nor the window): whole jobs until
`SETTLE_S` after the process's start. On some machines a fresh process ran
the step 15-22% slower for its first 10-60 s, a job at one speed or the
other, with the SM clock at its maximum; the cause is not known. The
settling jobs are judged with the window's.

A job codes the run's file (traffic.make_file): reset the predictor in
place to the fresh state (the program's `bench.reset_to_warm`), compress,
reset, decompress. Each reset counts in the time of the pass it precedes.
The window holds the whole jobs that start inside `seconds`. Nothing is
compared inside it: the archives and decodes are kept and judged after it,
once the program's state is freed (check.py).
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from . import check, traffic
from .counts import port_spec

SETTLE_S = 50.0  # settling jobs run until this long after the process's start


@dataclass
class Job:
    blob: bytes
    decoded: bytes
    encode_s: float  # reset + compress
    decode_s: float  # reset + decompress
    compress_s: float
    decompress_s: float
    reset_s: List[float]
    error: Optional[str] = None  # what a pass that raised said; its output is then empty


@dataclass
class Run:
    """What a run recorded, for the per-layer readers (metrics/*.py)."""

    config: dict
    mix: dict
    S: int
    per: int  # byte steps a stream in a pass
    file_bytes: int
    jobs: List[Job]
    peaks: Optional[dict] = None
    trace: Optional[object] = None  # trace.Trace
    notes: List[str] = field(default_factory=list)  # what the readers say of what they read (standard error)

    def encode_step_s(self) -> float:
        """The wall of an encode byte step: the window's compress time over
        its byte steps (resets left out)."""
        return sum(j.compress_s for j in self.jobs) / (len(self.jobs) * self.per)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pinned(tree: dict) -> dict:
    return {k: _pinned(v) if isinstance(v, dict) else v.pin_memory() for k, v in tree.items()}


class Cell:
    """The program under test, held for one run: a predictor of the mix's S
    streams at the configuration's spec, on `device`."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from gmix_tpu_torch.bench import reset_to_warm
        from gmix_tpu_torch.core.codec import Predictor
        from gmix_tpu_torch.state import init_state

        traffic.validate(mix)
        if mix["bytes_per_stream"] != config["stream_bytes"]:
            raise ValueError(f"the mix codes {mix['bytes_per_stream']} bytes a stream, the configuration is cut "
                             f"to {config['stream_bytes']}")
        self.config, self.mix, self.seed = config, mix, seed
        self.dev = torch.device(device)
        self.spec = port_spec(config["spec"])
        self.S, self.chunk = mix["streams"], mix["chunk"]
        self.data = traffic.make_file(mix, seed)
        self.pred = Predictor(self.spec, self.S, seed=seed, device=self.dev, analysis=False)
        fresh = init_state(self.pred.meta, 1, seed, "cpu")
        self.fresh = _pinned(fresh) if self.dev.type == "cuda" else fresh
        self._reset = reset_to_warm

    def reset(self) -> float:
        """The predictor back to S fresh streams; the synchronised seconds."""
        t0 = time.perf_counter()
        self._reset(self.pred, self.fresh)
        _sync(self.dev)
        return time.perf_counter() - t0

    def job(self) -> Job:
        from gmix_tpu_torch.core.codec import compress_bytes, decompress_bytes

        blob = out = b""
        error = None
        r1 = self.reset()
        t0 = time.perf_counter()
        try:
            blob = compress_bytes(self.data, self.spec, self.S, self.chunk, pred=self.pred)
            _sync(self.dev)
        except Exception as e:  # a pass that raises fails its job (check.py counts it), the run goes on
            error = f"compress: {e!r}"
        c = time.perf_counter() - t0
        r2 = self.reset()
        t0 = time.perf_counter()
        try:
            out = decompress_bytes(blob, self.spec, self.chunk, pred=self.pred)
            _sync(self.dev)
        except Exception as e:
            error = f"{error}; decompress: {e!r}" if error else f"decompress: {e!r}"
        d = time.perf_counter() - t0
        return Job(blob, out, r1 + c, r2 + d, c, d, [r1, r2], error)

    def graphs(self) -> int:
        """CUDA graphs the predictor holds."""
        return sum(len(getattr(fn, "graphs", {})) for fn in self.pred.plan.fn_cache.values())

    def traced(self, steps: int):
        """`steps` encode byte steps of every stream (the file's first bytes
        a stream) under torch.profiler, after the window: the window's graphs
        released, the traced chunk's captured by one untraced run first."""
        from torch.profiler import ProfilerActivity, profile, record_function

        from gmix_tpu_torch.core.codec import _pad_streams, run_chunks

        from .trace import WINDOW, from_profiler

        self.pred.plan.release_graphs()
        gc.collect()
        torch.cuda.empty_cache()
        window = torch.as_tensor(_pad_streams(self.data, self.S, self.chunk)[0][:, :steps].copy(), device=self.dev)
        code = torch.zeros((self.S, 1), dtype=torch.uint8, device=self.dev)  # encode never reads it

        def encode() -> None:
            run_chunks(self.pred, window, code, steps, decode=False, chunk=steps)
            _sync(self.dev)

        self.reset()
        encode()
        self.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                encode()
        return from_profiler(prof, steps)

    def close(self) -> None:
        """Drop the predictor, its graphs and the fresh state; what they held
        goes back to the device."""
        self.pred.plan.release_graphs()
        del self.pred, self.fresh
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(config: dict, mix: dict, seed: int, seconds: float, trace: bool, device, start: float,
             log: Callable[[str], None] = lambda s: None, settle_s: float = SETTLE_S) -> dict:
    """One run (module docstring). Returns the window's jobs, set-up and
    peak, the trace, and the check's numbers; `start` is the process's
    start on `time.perf_counter`."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()  # the allocator's statistics exist once CUDA is initialised
        torch.cuda.reset_peak_memory_stats(dev)
    cell = Cell(config, mix, seed, dev)
    warm = cell.job()  # captures every graph of the window
    graphs = cell.graphs()
    setup_s = time.perf_counter() - start
    log(f"set-up {setup_s:.3f} s (the capturing job {warm.encode_s + warm.decode_s:.3f} s), {graphs} graphs")
    settle = []
    while time.perf_counter() - start < settle_s:
        settle.append(cell.job())
    log(f"settling: {len(settle)} jobs, to {time.perf_counter() - start:.3f} s after the start")

    jobs = []
    t0 = time.perf_counter()
    while not jobs or time.perf_counter() - t0 < seconds:
        jobs.append(cell.job())
    window_s = time.perf_counter() - t0
    if cell.graphs() != graphs:
        raise RuntimeError(f"the window captured {cell.graphs() - graphs} CUDA graphs: it must replay the set-up's")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    log(f"window {window_s:.3f} s, {len(jobs)} jobs")
    for i, j in enumerate([warm] + settle + jobs):
        log(f"job {i}: encode {j.encode_s:.4f} s (compress {j.compress_s:.4f}), decode {j.decode_s:.4f} s "
            f"(decompress {j.decompress_s:.4f}), resets {j.reset_s[0]:.4f} {j.reset_s[1]:.4f} s"
            + (f"; FAILED: {j.error}" if j.error else ""))

    per = -(-(-(-len(cell.data) // cell.S)) // cell.chunk) * cell.chunk  # compress_bytes' byte steps a stream
    run = Run(config, mix, cell.S, per, len(cell.data), jobs)
    if trace and dev.type == "cuda":
        t1 = time.perf_counter()
        run.trace = cell.traced(mix["trace_steps"])
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
        log(f"traced {mix['trace_steps']} steps in {time.perf_counter() - t1:.3f} s")
    data, spec_dict, S = cell.data, config["spec"], cell.S
    cell.close()
    del cell

    streams = traffic.check_streams(mix, seed)
    verdict = check.judge(spec_dict, data, mix, seed, warm.blob, [j.blob for j in settle + jobs],
                          [j.decoded for j in [warm] + settle + jobs], streams)
    log(f"reference: streams {streams}, {mix['check_bytes']} bytes each, {verdict['reference_s']:.3f} s "
        f"({verdict['reference_coding_s']:.3f} s coding in the slowest process)")
    failed = sum(j.error is not None or j.blob != warm.blob or j.decoded != data for j in jobs)
    return {"run": run, "setup_s": setup_s, "window_s": window_s, "peak": peak, "graphs": graphs,
            "failed": failed, "verdict": verdict, "archive_bytes": check.payload_bytes(warm.blob, S)}
