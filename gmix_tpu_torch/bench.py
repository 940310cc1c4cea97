"""Encode and decode throughput at an exact roundtrip, on one CUDA device:

    python -m gmix_tpu_torch.bench [--profile ref|scaled-<bits>] [--streams N|auto]
        [--chunk 4000] [--bytes N] [--warm 131072] [--offset N] [--passes 2]
        [--budget BYTES] [--device cuda:0|cpu] [--out FILE]

The port of the repository's `bench.py` (gmix_tpu on a TPU). One stream is
trained on the corpus' first `--warm` bytes (`pretrain_state`), its state is
tiled into every stream of one predictor with fresh coder registers and
metrics (`warm_predictor`), and the next `--bytes` bytes of
`data/corpus_1m.bin` (from `--offset`, by default the warm start's end: the
measured bytes never repeat the warm ones) are encoded `--passes` times and
the archive decoded as often, each pass from the same warm start
(`run_once`). Every archive must be the same bytes and every decode the
input, and the model's cross-entropy must stay finite at every chunk, or the
run raises. The CUDA graphs of the byte step are captured before the timed
passes, on one chunk each way, and reported on their own.

Every knob also reads bench.py's environment variable: GMIX_BENCH_PROFILE
(`ref`, the published table sizes, or `scaled-<bits>`; a trailing `x<S>`
sets the streams, as in bench.py), GMIX_BENCH_BYTES, GMIX_BENCH_WARM,
GMIX_BENCH_CHUNK, GMIX_BENCH_PASSES and GMIX_HBM_BUDGET (the device bytes a
run may take; default: the card's total memory). `--streams auto` (the
default) takes the most streams whose state estimate
(`state_bytes_estimate`) plus `headroom_bytes` fits the budget; a
configuration that does not fit is refused before anything is allocated.

Printed on stdout, one JSON object a line: the configuration (with the
card's name and power limit as nvidia-smi reports them) before any timed
work, one line a pass, and the result. `--out FILE` also writes all of them
to FILE. Nothing else is written.

Left behind from bench.py: the v5e ladder of configurations, the subprocess
per attempt with its walk-down on out-of-memory and transient faults (a
fault here ends the run with a non-zero exit), the idle second lane of the
pretraining (an S=1 TPU miscompile), the doubled corpus (the warm prefix
recurred in the measured bytes) and the write to data/parity.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from .config import ApmStage, EnsembleSpec, reference_spec, scale_tables
from .core.codec import (_WORST_PER_BYTE, Predictor, compress_bytes, decompress_bytes, default_device, entropy_bits,
                         run_chunks)
from .core.meta import build_meta
from .state import coder_state, copy_into, init_state, metrics_state, state_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "data", "corpus_1m.bin")
# the reference binary's encode+decode rate on one CPU core (read, never written)
BASELINE = os.path.join(ROOT, "data", "baseline_measured.json")
# the pretraining's chunk is min(chunk, WARM_CHUNK), as in bench.py
WARM_CHUNK = 1000
# device bytes a run holds besides its state (`headroom_bytes`): a fixed
# reserve for the CUDA context, the allocator's slack and one leaf of the
# warm state on its way into the streams, and per stream the CUDA graphs'
# pool (153.1 MB at 16 streams of the published sizes) and its buffers
RESERVE_BYTES = 2 << 30
POOL_BYTES_PER_STREAM = 16 << 20


def spec_for(bits: Optional[int]) -> EnsembleSpec:
    """bench.py's spec: `reference_spec()` with the two SSE/APM stages of
    `best_spec()`, its tables clamped to 2^bits entries (history 2^(bits+4),
    at most 2^24); `bits=None` keeps the published table sizes."""
    spec = dataclasses.replace(
        reference_spec(),
        apm=(
            ApmStage("apm_lb", "last_byte", 8, lr=0.010, weight=0.50),
            ApmStage("apm_h2", "h2", 16, lr=0.010, weight=0.25),
        ),
    )
    return spec if bits is None else scale_tables(spec, bits, history_bits=min(24, bits + 4))


def state_bytes_estimate(spec: EnsembleSpec, num_streams: int) -> int:
    """The bytes of a predictor's state, from the leaves' shapes and dtypes
    alone (tensors on the "meta" device allocate nothing): what
    `Predictor.memory_bytes()` will report, the port's int64-carried u32
    lanes included."""
    return state_bytes(init_state(build_meta(spec), num_streams, device="meta"))


def padded_per(n: int, num_streams: int, chunk: int) -> int:
    """Byte steps a stream for n input bytes (`compress_bytes`' padding)."""
    per = -(-max(n, 1) // num_streams)
    return -(-per // chunk) * chunk


def code_cap(per: int, chunk: int) -> int:
    """The coder's bound on a stream's code bytes for `per` byte steps
    (`decompress_bytes` refuses an archive past it)."""
    return per + per // 2 + _WORST_PER_BYTE * chunk + 4096


def headroom_bytes(num_streams: int, per: int, chunk: int) -> int:
    """Device bytes a run holds besides the state: `RESERVE_BYTES`, and per
    stream the graph pool's share, the data buffer in and out, the code
    stream (the decoder's copy and the graphs' static buffer, a power of two
    at most twice the coder's bound) and a chunk's input window and renorm
    bytes."""
    return RESERVE_BYTES + num_streams * (POOL_BYTES_PER_STREAM + 2 * per + 3 * code_cap(per, chunk) + 42 * chunk)


def auto_streams(spec: EnsembleSpec, n: int, chunk: int, budget: int) -> int:
    """The most streams whose state estimate plus headroom fits `budget`; 0
    if not even one does."""
    one, two = state_bytes_estimate(spec, 1), state_bytes_estimate(spec, 2)
    S = max(0, (budget - (2 * one - two)) // (two - one))  # the state alone, every leaf linear in S
    while S > 0 and state_bytes_estimate(spec, S) + headroom_bytes(S, padded_per(n, S, chunk), chunk) > budget:
        S -= 1
    return S


def corpus(n: Optional[int] = None, offset: int = 0) -> bytes:
    """Bytes [offset, offset + n) of data/corpus_1m.bin (n=None: to its
    end). A range past the file's end raises: the corpus is never repeated."""
    with open(CORPUS, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if n is None:
            n = size - offset
        if offset < 0 or n < 0 or offset + n > size:
            raise ValueError(f"bytes [{offset}, {offset + n}) of the {size}-byte corpus {CORPUS}")
        f.seek(offset)
        return f.read(n)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def finite_guard(pred: Predictor, what: str, chunk: int):
    """A `progress` callback for `run_chunks` / `compress_bytes` /
    `decompress_bytes`: after each chunk, between graph replays, it reads
    the streams' cross-entropy (`metrics.ent`) once and raises RuntimeError
    naming the chunk if any is not finite."""

    def check(done: int) -> None:
        ent = pred.state["metrics"]["ent"]
        if not bool(torch.isfinite(ent).all()):
            bad = torch.nonzero(~torch.isfinite(ent)).flatten().tolist()
            raise RuntimeError(f"bench {what}: the cross-entropy of streams {bad[:8]} is not finite after chunk "
                               f"{done // chunk} (bytes {done - chunk} to {done} of each stream)")

    return check


def _host_copy(tree: Dict) -> Dict:
    return {k: _host_copy(v) if isinstance(v, dict) else v.detach().to("cpu", copy=True) for k, v in tree.items()}


def pretrain_state(spec: EnsembleSpec, warm_bytes: bytes, chunk: int, device=None) -> Dict:
    """One stream trained on `warm_bytes` (bench.py's `_pretrain_host_state`
    without its idle second lane): encoded in chunks of min(chunk, 1000),
    the bytes past the last whole chunk dropped, analysis off. Returns the
    stream's state (S=1) as CPU tensors; with no whole chunk, the fresh
    state. Runs on `device` (default: the current CUDA device)."""
    pred = Predictor(spec, 1, device=device, analysis=False)
    wchunk = min(chunk, WARM_CHUNK)
    wb = len(warm_bytes) // wchunk * wchunk
    if wb:
        data = torch.as_tensor(np.frombuffer(warm_bytes, np.uint8, count=wb)[None].copy(), device=pred.device)
        code = torch.zeros((1, 1), dtype=torch.uint8, device=pred.device)  # encode never reads it
        run_chunks(pred, data, code, wb, decode=False, chunk=wchunk,
                   progress=finite_guard(pred, "warm start", wchunk))
    out = _host_copy(pred.state)
    device = pred.device
    del pred
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _tile_into(held: Dict, one: Dict, device: torch.device, prefix: tuple = ()) -> None:
    """Every leaf of the one-stream state `one` into the leaf of `held` at
    the same path, in place, repeated over the stream axis; 0-d leaves as
    they are. Each leaf goes to the device first and is tiled there through
    an expanded view, one leaf at a time."""
    if sorted(held) != sorted(one):
        raise ValueError(f"warm state at {'/'.join(prefix) or 'the root'}: keys {sorted(one)} for {sorted(held)}")
    for k, d in held.items():
        path, v = prefix + (k,), one[k]
        if isinstance(d, dict):
            _tile_into(d, v, device, path)
            continue
        want = (1,) + tuple(d.shape[1:]) if d.dim() else ()
        if tuple(v.shape) != want or v.dtype != d.dtype:
            raise ValueError(f"warm state leaf {'/'.join(path)}: {tuple(v.shape)} {v.dtype} for {want} {d.dtype}")
        d.copy_(v.to(device).expand(d.shape))


def reset_to_warm(pred: Predictor, warm: Dict) -> None:
    """Put every stream of `pred` at the one-stream state `warm`
    (`pretrain_state`), with a fresh stream's coder registers and metrics,
    in the predictor's own leaves: no second S-stream state is made, and the
    predictor's CUDA graphs stay valid (bench.py's `_broadcast_warm`, which
    builds a predictor each time)."""
    st = pred.state
    _tile_into({k: v for k, v in st.items() if k not in ("coder", "metrics")},
               {k: v for k, v in warm.items() if k not in ("coder", "metrics")}, pred.device)
    copy_into(st["coder"], coder_state(pred.num_streams, pred.device))
    copy_into(st["metrics"], metrics_state(pred.meta, pred.num_streams, pred.device))
    pred.plan.forget_epoch()


def warm_predictor(spec: EnsembleSpec, num_streams: int, warm: Dict, device=None) -> Predictor:
    """A predictor of `num_streams` streams, analysis off, each stream at
    the one-stream state `warm` (`reset_to_warm`)."""
    pred = Predictor(spec, num_streams, device=device, analysis=False)
    reset_to_warm(pred, warm)
    return pred


def _capture(pred: Predictor, chunk: int, per: int) -> None:
    """One chunk of zeros encoded and one decoded, so that every CUDA graph
    the passes replay (encode and decode, the byte that wraps the LSTM's
    window, the backward pass) is captured before them. The decode's code
    buffer is as wide as the coder's bound for `per` byte steps: no pass
    needs a wider one, which would capture the decode graphs again."""
    S, dev = pred.num_streams, pred.device
    data = torch.zeros((S, chunk), dtype=torch.uint8, device=dev)
    run_chunks(pred, data, torch.zeros((S, 1), dtype=torch.uint8, device=dev), chunk, decode=False, chunk=chunk)
    code = torch.zeros((S, code_cap(per, chunk)), dtype=torch.uint8, device=dev)
    run_chunks(pred, data, code, chunk, decode=True, chunk=chunk)


def _emit(out: list, kind: str, **fields) -> None:
    row = {"bench": kind, **fields}
    out.append(row)
    print(json.dumps(row), flush=True)


def run_once(spec: EnsembleSpec, num_streams: int, chunk: int, data: bytes, warm: bytes = b"", passes: int = 2,
             device=None, lines: Optional[list] = None) -> dict:
    """Encode `data` over `num_streams` streams `passes` times, then decode
    the archive as often, each pass from the warm start that `warm` trains
    (`pretrain_state`; b"": the fresh state), on one predictor that is put
    back to it before each pass (bench.py's `_run_once`). Each pass is timed
    alone and printed; an archive unlike the first pass's, a decode that is
    not `data`, or a cross-entropy that is not finite raises RuntimeError.
    Returns the result: rates per pass, best and median, bpb and model bpb,
    state and peak bytes, the graphs' capture and the warm start's seconds.
    Printed rows are also appended to `lines`.

    With an LSTM, `chunk` and the pretraining's chunk must be multiples of
    its horizon (the deferred backward pass), or ValueError: a chunk of the
    other order decodes other bytes with no error."""
    lines = [] if lines is None else lines
    dev = default_device() if device is None else torch.device(device)
    if spec.lstm is not None:
        hz = spec.lstm.horizon
        if chunk % hz or min(chunk, WARM_CHUNK) % hz:
            raise ValueError(f"chunk {chunk}: the LSTM's horizon {hz} must divide it and min(chunk, {WARM_CHUNK})")
    if passes < 1:
        raise ValueError(f"{passes} passes")
    n, S = len(data), num_streams
    per = padded_per(n, S, chunk)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    warm_state = pretrain_state(spec, warm, chunk, dev)
    warm_s = time.perf_counter() - t0
    pred = warm_predictor(spec, S, warm_state, dev)
    t0 = time.perf_counter()
    capture_s = 0.0
    if dev.type == "cuda":  # the CPU runs the byte step op by op: nothing to capture
        _capture(pred, chunk, per)
        _sync(dev)
        capture_s = sum(g.capture_s for fn in pred.plan.fn_cache.values() for g in fn.graphs.values())
    warmup_s = time.perf_counter() - t0

    def timed(fn):
        reset_to_warm(pred, warm_state)
        _sync(dev)
        t = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, time.perf_counter() - t

    enc_s, dec_s, blob = [], [], None
    for i in range(passes):
        b, t = timed(lambda: compress_bytes(data, spec, S, chunk, pred=pred,
                                            progress=finite_guard(pred, f"encode pass {i + 1}", chunk)))
        if blob is not None and b != blob:
            raise RuntimeError(f"bench: encode pass {i + 1} wrote {len(b)} bytes unlike pass 1's {len(blob)}")
        blob = b
        enc_s.append(t)
        model_bits = entropy_bits(pred)
        _emit(lines, "pass", direction="encode", index=i + 1, seconds=t, bytes_per_s=n / t)
    for i in range(passes):
        out, t = timed(lambda: decompress_bytes(blob, spec, chunk, pred=pred,
                                                progress=finite_guard(pred, f"decode pass {i + 1}", chunk)))
        if out != data:
            at = next((j for j, (a, b) in enumerate(zip(out, data)) if a != b), min(len(out), n))
            raise RuntimeError(f"bench: decode pass {i + 1} differs from the input at byte {at} of {n}")
        dec_s.append(t)
        _emit(lines, "pass", direction="decode", index=i + 1, seconds=t, bytes_per_s=n / t)

    def rates(times):
        return {"best": n / min(times), "median": n / statistics.median(times)}

    return {
        "streams": S, "chunk": chunk, "bytes": n, "warm_bytes": len(warm), "passes": passes, "byte_steps": per,
        "encode_s": enc_s, "decode_s": dec_s,
        "encode_bytes_per_s": rates(enc_s), "decode_bytes_per_s": rates(dec_s),
        "encdec_mbps": 2 * n / (min(enc_s) + min(dec_s)) / 1e6,
        "archive_bytes": len(blob), "bpb": 8 * len(blob) / n, "model_bpb": model_bits / n,
        "state_gb": pred.memory_bytes() / 1e9,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None,
        "peak_reserved_gb": torch.cuda.max_memory_reserved(dev) / 1e9 if dev.type == "cuda" else None,
        "capture_s": capture_s, "capture_warmup_s": warmup_s, "warm_s": warm_s, "exact": True,
    }


def _device_info(dev: torch.device) -> dict:
    """The device's name, and on a card its name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them."""
    if dev.type != "cuda":
        return {"device": str(dev), "nvidia_smi": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi[min(dev.index or 0, len(smi) - 1)]}


def _default_budget(dev: torch.device) -> int:
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _vs_baseline(mbps: float) -> Optional[float]:
    if not os.path.exists(BASELINE):
        return None
    with open(BASELINE) as f:
        ref = json.load(f).get("ref_encdec_mbps", 0.0)
    return mbps / ref if ref > 0 else None


def main(argv=None) -> int:
    env = os.environ
    p = argparse.ArgumentParser(prog="python -m gmix_tpu_torch.bench",
                                description="encode + decode bytes/s at an exact roundtrip from a warm start")
    p.add_argument("--profile", default=env.get("GMIX_BENCH_PROFILE", "ref"),
                   help="ref (the published table sizes) or scaled-<bits>; a trailing x<S> sets the streams")
    p.add_argument("--streams", default=None, help="N, or auto: the most that fit the budget (default)")
    p.add_argument("--chunk", type=int, default=int(env.get("GMIX_BENCH_CHUNK", 4000)))
    p.add_argument("--bytes", type=int, default=int(env["GMIX_BENCH_BYTES"]) if "GMIX_BENCH_BYTES" in env else None,
                   help="bytes coded (default: the rest of the corpus after the warm start)")
    p.add_argument("--warm", type=int, default=int(env.get("GMIX_BENCH_WARM", 1 << 17)),
                   help="the corpus' first bytes, on which one stream is trained for the warm start")
    p.add_argument("--offset", type=int, default=None,
                   help="the corpus byte the coded bytes start at, at or past the warm start's end (default: there)")
    p.add_argument("--passes", type=int, default=int(env.get("GMIX_BENCH_PASSES", 2)))
    p.add_argument("--budget", type=int, default=int(env["GMIX_HBM_BUDGET"]) if "GMIX_HBM_BUDGET" in env else None,
                   help="device bytes the run may take (default: the device's total memory)")
    p.add_argument("--device", default=None, help="a torch device (default: the current CUDA device; cpu runs the "
                                                  "plain torch path)")
    p.add_argument("--out", default=None, help="also write the printed rows to this JSON file")
    args = p.parse_args(argv)

    m = re.fullmatch(r"(ref|scaled-(\d+))(?:x(\d+))?", args.profile)
    if m is None:
        raise SystemExit(f"bench: unknown profile {args.profile!r}: use 'ref' or 'scaled-<bits>', optionally x<streams>")
    bits = int(m.group(2)) if m.group(2) else None
    streams = args.streams or m.group(3) or "auto"
    if args.device is not None:
        dev = torch.device(args.device)
    else:
        try:
            dev = default_device()
        except RuntimeError as e:
            raise SystemExit(f"bench: {e}; here: --device cpu")
    offset = args.warm if args.offset is None else args.offset
    if offset < args.warm:
        raise SystemExit(f"bench: --offset {offset} is inside the warm start's {args.warm} bytes")
    spec = spec_for(bits)
    warm, data = corpus(args.warm, 0), corpus(args.bytes, offset)
    budget = _default_budget(dev) if args.budget is None else args.budget
    S = auto_streams(spec, len(data), args.chunk, budget) if streams == "auto" else int(streams)
    estimate = state_bytes_estimate(spec, max(S, 1))
    headroom = headroom_bytes(max(S, 1), padded_per(len(data), max(S, 1), args.chunk), args.chunk)
    lines: list = []
    _emit(lines, "config", spec=m.group(1), streams=S, streams_asked=streams, chunk=args.chunk, bytes=len(data),
          offset=offset, warm_bytes=args.warm, passes=args.passes, state_estimate_bytes=estimate,
          headroom_bytes=headroom, budget_bytes=budget, **_device_info(dev))
    if S < 1 or estimate + headroom > budget:
        raise SystemExit(f"bench: refused: {max(S, 1)} streams of {m.group(1)} need {estimate} bytes of state and "
                         f"{headroom} of headroom, over the budget of {budget} bytes")
    res = run_once(spec, S, args.chunk, data, warm, args.passes, dev, lines)
    _emit(lines, "result", spec=m.group(1), **res, vs_baseline=_vs_baseline(res["encdec_mbps"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
