"""Encode and decode throughput at an exact roundtrip, on one CUDA device:

    python -m gmix_tpu_torch.bench [--profile PROFILE[,PROFILE...]]
        [--streams N|auto] [--chunk 4000] [--bytes N] [--warm 131072] [--offset N]
        [--passes 2] [--encode-only] [--analysis] [--warm-checkpoint PATH]
        [--trace N] [--budget BYTES] [--device cuda:0|cpu] [--out FILE]

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

Profiles (`--profile`), each at the published table sizes: `ref`
(`spec_for(None)`: `reference_spec()` with bench.py's two APM stages),
`ref-ppm` (ref without the LSTM), `ref-noppm` (ref-ppm without PPM and the
rolling contexts only PPM reads) and `best` (`best_spec()`, the spec of
tools/tpu_sequential.py's `best`). `scaled-<bits>` is ref with its tables
clamped to 2^bits entries (`spec_for(bits)`), and any profile may be
clamped the same way as `<profile>:scaled-<bits>` (`ref-noppm:scaled-12`).
A trailing `x<S>` sets the streams, as in bench.py.

Ensemble variants (variants.py, the spec constructors of the three
ensemble-variant tools), applied after the clamp as the tools apply them:
`<profile>[:scaled-<bits>]:ladder-<v>` (tools/tpu_fast_ladder.py: `base`,
`no4sel`, `noskipind`, `noih`, `nolstm`, `noskipind-noih`, `lean`) and
`<profile>[:scaled-<bits>]:ablate-<v>` (tools/tpu_ablate.py: `full`,
`nolstm`, `noppm`, `nolstmppm`, `nomatch`, `noih`, `nomix12`, `mixtb0`,
`mixtb4`, `mix6`, `indonly`), either with a trailing `x<S>`;
`quality:<name>` is tools/tpu_quality.py's variant of that name
(`quality:ref-x4-oldppm`, `quality:boost-1-18x4`, ...), whose streams come
from the name: a `--streams` that says otherwise is refused. A bare
`:noih` or `:nolstm` is refused: the two tools mean different specs by it.
Several profiles, comma-separated, run one after the other in one process
(a ladder is compared inside one call: host-timed numbers move between
calls), each with its config, pass and result rows; at most one predictor
is on the device at a time (the previous one's graphs released, the
predictor dropped and the cache emptied before the next is built; each
config row holds the device bytes allocated when its run starts).
`--encode-only` (the ladder's and quality's mode) runs no decode: the
result says `"decoded": false`, and the encode passes must still give one
archive. `--analysis` (quality's mode) runs the predictor with the
per-column entropy EMA on; the result gets `model_ema`, the EMA averaged
over the streams after the last encode pass, keyed by `analysis_columns`.

`--warm-checkpoint PATH` (tools/tpu_warm_sweep.py's snapshot): the warm
start is read from PATH, a gmix_tpu checkpoint of the one stream, when it
exists; otherwise it is trained and written there (a temporary name, then
`os.replace`). The sidecar PATH.json names what made it (the spec's
`stable_hash`, the warm bytes, their sha256 and the warm chunk); a PATH
whose sidecar is missing or names something else is refused before any
predictor is allocated, and never trained over. With several profiles
PATH must hold `{profile}`, which each run fills with its profile's name
(`:` as `_`): one file a profile. `--trace N`
(tools/tpu_profile.py): after the timed passes, the predictor is put back
to the warm start, the passes' CUDA graphs are released, a window of N
encode byte steps is captured, and then run again under torch.profiler
(`trace_window`): one `trace` row of device busy time, idle shares, the
kernels with the most device time and each part of the byte step's device
time (the replays mapped onto the graphs' layouts, obs.replay_parts). With an LSTM, N must be a multiple of
its horizon, so that the window runs the passes' deferred backward pass.

Every knob also reads bench.py's environment variable: GMIX_BENCH_PROFILE,
GMIX_BENCH_BYTES, GMIX_BENCH_WARM,
GMIX_BENCH_CHUNK, GMIX_BENCH_PASSES and GMIX_HBM_BUDGET (the device bytes a
run may take; default: the card's total memory). `--streams auto` (the
default) takes the most streams whose state estimate
(`state_bytes_estimate`) plus `headroom_bytes` fits the budget; a
configuration that does not fit is refused before anything is allocated.

Printed on stdout, one JSON object a line: the configuration (with the
card's name and power limit as nvidia-smi reports them) before any timed
work, one line a pass, the trace, and the result (with `ref_bpb`, the
reference binary's bpb on the corpus, read from data/baseline_measured.json
as bench.py reads it). `--out FILE` also writes all of them to FILE.

The result also holds the step's roofline (roofline.py, the cost-analysis
half of tools/tpu_profile.py): the work of a byte step counted from the
spec (`work_per_step`: bytes, float and integer operations, a step, a bit
and by part), the least time the card could take for it (`bound_ms`,
`bound_by`), and against the best encode pass's step the shares of the
card's peaks (`mfu`, `hbm_share`, `roofline_share`) and the achieved rates;
the trace row the same shares against the device's busy time a step. On
the CPU the count and the bound are printed and every share reads "not
measured"; so does every share of an `--analysis` run, whose step also
updates the EMA that the count leaves out.
Nothing else is written but the warm checkpoint, and nothing under data/.

Left behind from bench.py: the v5e ladder of configurations, the subprocess
per attempt with its walk-down on out-of-memory and transient faults (a
fault here ends the run with a non-zero exit), the idle second lane of the
pretraining (an S=1 TPU miscompile), the doubled corpus (the warm prefix
recurred in the measured bytes) and the write to data/parity.json. Left
behind from the variant tools: their appends to data/parity.json and
data/quality_ablations.json (the bench writes nothing under data/), the
`fused` key (`GMIX_FUSED`: the port has one step), tools/tpu_ablate.py's
compile timing and its uniform random bytes (the corpus is coded instead),
and tools/tpu_quality.py's throwaway warm-up predictor (the graphs'
capture is timed apart from the passes here).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import obs, variants
from .config import ApmStage, EnsembleSpec, best_spec, reference_spec, scale_tables
from .core.codec import (_WORST_PER_BYTE, Predictor, _pad_streams, analysis_columns, analysis_snapshot, compress_bytes,
                         decompress_bytes, default_device, entropy_bits, run_chunks)
from .core.meta import build_meta
from .roofline import RATES, SHARES, bound, roofline, step_work
from .state import coder_state, copy_into, init_state, metrics_state, state_bytes, state_from_numpy
from .utils.serialization import load_state, save_state

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


def ref_ppm_spec() -> EnsembleSpec:
    """Profile `ref-ppm`: `spec_for(None)` without the LSTM."""
    return dataclasses.replace(spec_for(None), lstm=None)


def ref_noppm_spec() -> EnsembleSpec:
    """Profile `ref-noppm`: `ref_ppm_spec()` without PPM and the rolling
    contexts that only PPM reads."""
    return dataclasses.replace(ref_ppm_spec(), ppm=None, roll_ctxs=())


# the profiles but `ref` (`spec_for`), at the published table sizes
PROFILES: Dict[str, Callable[[], EnsembleSpec]] = {"ref-ppm": ref_ppm_spec, "ref-noppm": ref_noppm_spec,
                                                   "best": best_spec}
# the variant tools by their prefix in a profile: (names, spec constructor)
VARIANT_TOOLS = {"ladder": (variants.LADDER, variants.ladder), "ablate": (variants.ABLATE, variants.ablate)}
_VARIANT_NAMES = "|".join(sorted(set(variants.LADDER + variants.ABLATE), key=len, reverse=True))
PROFILE_RE = re.compile(r"(?P<name>(?:(?P<base>ref-ppm|ref-noppm|ref|best)(?::scaled-(?P<bits>\d+))?"
                        r"|scaled-(?P<ref_bits>\d+))"
                        r"(?::(?P<tool>ladder|ablate)-(?P<variant>" + _VARIANT_NAMES + r"))?)(?:x(?P<streams>\d+))?")
BARE_VARIANT_RE = re.compile(r".*:(?P<variant>" + _VARIANT_NAMES + r")(?:x\d+)?")
QUALITY = "quality:"
# what each tool means by the names they share
TWO_MEANINGS = {
    "noih": "ladder-noih drops the ind_ih_* models (tools/tpu_fast_ladder.py); ablate-noih also drops the "
            "indirect-hash contexts and gates their mixers on last_byte (tools/tpu_ablate.py)",
    "nolstm": "ladder-nolstm drops the LSTM and the models and mixers gated on lstm_ctx "
              "(tools/tpu_fast_ladder.py); ablate-nolstm drops the LSTM alone (tools/tpu_ablate.py)",
}


def parse_profile(text: str) -> Tuple[str, EnsembleSpec, Optional[str]]:
    """(name, spec, streams) of a `--profile`: `ref`, `ref-ppm`,
    `ref-noppm` or `best`, optionally `:scaled-<bits>` (tables clamped as
    `spec_for` clamps them); `scaled-<bits>` is `ref`'s; then optionally
    `:ladder-<v>` or `:ablate-<v>` (`variants.ladder` / `variants.ablate` of
    that spec). A trailing `x<S>` gives the streams (None without it). The
    name is the profile without `x<S>`. `quality:<name>` is
    `variants.quality(name)`, its streams from the name. An unknown profile,
    or a variant without its tool's prefix, raises ValueError."""
    if text.startswith(QUALITY):
        spec, S = variants.quality(text[len(QUALITY):])
        return text, spec, str(S)
    m = PROFILE_RE.fullmatch(text)
    if m is None:
        bare = BARE_VARIANT_RE.fullmatch(text)
        if bare is not None:
            v = bare.group("variant")
            tools = [t for t, (names, _) in VARIANT_TOOLS.items() if v in names]
            raise ValueError(f"profile {text!r}: name the tool of variant {v!r}, "
                             f"{' or '.join(f':{t}-{v}' for t in tools)}"
                             + (f"; the two mean different specs: {TWO_MEANINGS[v]}" if v in TWO_MEANINGS else ""))
        raise ValueError(f"unknown profile {text!r}: use ref, ref-ppm, ref-noppm, best or scaled-<bits>, a profile "
                         f"may end in :scaled-<bits>, then in :ladder-<variant> or :ablate-<variant>, and any in "
                         f"x<streams>; or quality:<variant>")
    base = m.group("base") or "ref"
    bits = m.group("bits") or m.group("ref_bits")
    bits = int(bits) if bits else None
    if base == "ref":
        spec = spec_for(bits)
    else:
        spec = PROFILES[base]()
        if bits is not None:
            spec = scale_tables(spec, bits, history_bits=min(24, bits + 4))
    if m.group("tool"):
        spec = VARIANT_TOOLS[m.group("tool")][1](spec, m.group("variant"))
    return m.group("name"), spec, m.group("streams")


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


def sync(device: torch.device) -> None:
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
    release_device(device)
    return out


def warm_sidecar(spec: EnsembleSpec, warm_bytes: bytes, chunk: int) -> dict:
    """What makes a warm start (`pretrain_state`): the spec, the bytes and
    the chunk they were trained in. A warm checkpoint's sidecar holds it."""
    return {"spec_hash": spec.stable_hash(), "warm_bytes": len(warm_bytes), "warm_chunk": min(chunk, WARM_CHUNK),
            "warm_sha256": hashlib.sha256(warm_bytes).hexdigest()}


def check_warm_checkpoint(path: str, want: dict) -> bool:
    """Whether the warm checkpoint `path` exists. One whose sidecar
    (`path` + ".json") is missing or is not `want` (`warm_sidecar`) raises
    SystemExit: it is never read as another warm start, nor trained over."""
    if not os.path.exists(path):
        return False
    side = path + ".json"
    if not os.path.exists(side):
        raise SystemExit(f"bench: refused: the warm checkpoint {path} has no sidecar {side}; it cannot be known to "
                         f"be this warm start")
    with open(side) as f:
        got = json.load(f)
    if got != want:
        raise SystemExit(f"bench: refused: the warm checkpoint {path} was made by {got}, this run's warm start is "
                         f"{want}; remove it or name another path")
    return True


def replace_file(path: str, write: Callable[[str], None]) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_warm_checkpoint(path: str, warm: Dict, sidecar: dict) -> None:
    """The one-stream warm state `warm` to `path` in gmix_tpu's checkpoint
    format (`utils/serialization.save_state`) and `sidecar` to
    `path` + ".json", each under a temporary name first and then
    `os.replace`d: the sidecar first, so that a checkpoint never stands
    beside another one's sidecar."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)

    def write_json(tmp: str) -> None:
        with open(tmp, "w") as f:
            json.dump(sidecar, f, indent=1)

    replace_file(path + ".json", write_json)
    replace_file(path, lambda tmp: save_state(tmp, warm))


def load_warm_checkpoint(path: str) -> Dict:
    """The warm state in `path` as CPU tensors, the port's dtypes: what
    `pretrain_state` returned when it was written, every leaf bitwise."""
    return state_from_numpy(load_state(path))


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
    with obs.span("gmix.reset"):
        st = pred.state
        _tile_into({k: v for k, v in st.items() if k not in ("coder", "metrics")},
                   {k: v for k, v in warm.items() if k not in ("coder", "metrics")}, pred.device)
        copy_into(st["coder"], coder_state(pred.num_streams, pred.device))
        copy_into(st["metrics"], metrics_state(pred.meta, pred.num_streams, pred.device))
        pred.plan.forget_epoch()


def warm_predictor(spec: EnsembleSpec, num_streams: int, warm: Dict, device=None,
                   analysis: bool = False) -> Predictor:
    """A predictor of `num_streams` streams, analysis off unless asked, each
    stream at the one-stream state `warm` (`reset_to_warm`)."""
    pred = Predictor(spec, num_streams, device=device, analysis=analysis)
    reset_to_warm(pred, warm)
    return pred


def capture(pred: Predictor, chunk: int, per: int, decode: bool = True) -> None:
    """One chunk of zeros encoded and (with `decode`) one decoded, so that
    every CUDA graph the passes replay (encode and decode, the byte that
    wraps the LSTM's window, the backward pass) is captured before them.
    The decode's code buffer is as wide as the coder's bound for `per` byte
    steps: no pass needs a wider one, which would capture the decode graphs
    again."""
    S, dev = pred.num_streams, pred.device
    data = torch.zeros((S, chunk), dtype=torch.uint8, device=dev)
    run_chunks(pred, data, torch.zeros((S, 1), dtype=torch.uint8, device=dev), chunk, decode=False, chunk=chunk)
    if decode:
        code = torch.zeros((S, code_cap(per, chunk)), dtype=torch.uint8, device=dev)
        run_chunks(pred, data, code, chunk, decode=True, chunk=chunk)


def release_device(device) -> None:
    """What a dropped predictor held goes back: a garbage collection (a
    reference cycle would keep a state of tens of GB until the next one) and
    on a CUDA device the caching allocator's free blocks."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _launch_counts() -> Tuple[int, ...]:
    """The hand-written kernels' launches so far (obs.launches): (gather,
    scatter, fused, PPM update, PPM prediction, contexts boundary, match
    pointers)."""
    n = obs.launches()
    return (n.get("gather_rows", 0) + n.get("gather_rows_many", 0),
            n.get("scatter_rows", 0) + n.get("scatter_rows_many", 0), n.get("fused_substeps", 0),
            n.get("ppm_update", 0), n.get("ppm_predict", 0), n.get("contexts_boundary", 0), n.get("match_pointer", 0))


# the hand-written kernels, by a part of their name in a trace
OWN_KERNELS = ("fused_substeps_kernel", "gather_rows_many_kernel", "scatter_rows_many_kernel", "ppm_update_kernel",
               "ppm_predict_kernel", "contexts_boundary_kernel", "match_pointer_kernel")
TOP_KERNELS, KERNEL_NAME_CHARS = 10, 120


def trace_window(run: Callable[[], None], n: int, device) -> dict:
    """`run()` (n byte steps, ending in a synchronize) under torch.profiler,
    read from the profiler's raw events: CUDA kernels and device operations
    a byte step, the device's busy time a step (the union of its
    operations' intervals: overlaps count once) and its idle share of the
    traced window, each hand-written kernel's device time a launch, the
    TOP_KERNELS kernels with the most device time (name cut to
    KERNEL_NAME_CHARS, launches and us a step), and over the graph replays
    (obs.replay_parts) each part's device us a step and the replays' busy us
    a step. A trace without device time raises. On the CPU, where the profiler would
    record no device activity, `run()` is timed alone and the device
    numbers read "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if cuda else contextlib.nullcontext() as prof:
        t0 = time.time_ns()
        run()
        t1 = time.time_ns()
    out = {"traced_wall_ms_per_step": (t1 - t0) / 1e6 / n}
    if not cuda:
        out["device_trace"] = f"not measured: no device activity on {device}"
        return out
    ops, host = obs.profile_events(prof)
    ops = [(k, name, s, min(e, t1)) for k, name, s, e in ops if t0 <= s < t1]
    busy = obs.union_ns([(s, e) for _, _, s, e in ops])
    if not ops or busy <= 0:
        raise RuntimeError(f"the profiler recorded no device time in {n} byte steps on {device}")
    by_kernel: Dict[str, list] = {}
    for kind, name, s, e in ops:
        if kind == "kernel":
            row = by_kernel.setdefault(name, [0, 0])
            row[0] += e - s
            row[1] += 1
    own_us = {own: {"us_per_launch": ns / 1e3 / count, "launches_per_step": count / n}
              for own in OWN_KERNELS for name, (ns, count) in by_kernel.items() if own in name}
    top = sorted(by_kernel.items(), key=lambda r: -r[1][0])[:TOP_KERNELS]
    out.update(cuda_kernels_per_step=sum(c for _, c in by_kernel.values()) / n, device_ops_per_step=len(ops) / n,
               device_busy_ms_per_step=busy / 1e6 / n, device_idle_share=1.0 - busy / (t1 - t0),
               own_kernel_us_per_launch=own_us,
               top_kernels=[{"name": name[:KERNEL_NAME_CHARS], "launches_per_step": count / n, "us_per_step": ns / 1e3 / n}
                            for name, (ns, count) in top])
    parts = obs.replay_parts(ops, host, obs.layouts(), ("fused_substeps_kernel",))
    if parts is None:
        out["part_us_per_step"] = "not measured: the window's device operations do not align onto the graphs' layouts"
    else:
        out["part_us_per_step"] = {p: ns / 1e3 / n for p, ns in sorted(parts["parts"].items(), key=str)}
        out["replays_busy_us_per_step"] = parts["busy_ns"] / 1e3 / n
        out["replays_aligned"] = f"{parts['aligned']} of {parts['replays']}"
    return out


NO_SHARE_CPU = "not measured: the CPU"
NO_SHARE_ANALYSIS = "not measured: an --analysis run (work_per_step counts the step without the entropy EMA)"


def _roofline_row(work: dict, step_ms: Optional[float], keys, why: str = NO_SHARE_CPU) -> dict:
    """`keys` of `roofline(work, step_ms)`. Without a step time (a CPU run,
    which gives counts, never a share of the card's peaks, or an analysis
    run, whose step is not the one counted) the bound alone, every share and
    rate reading `why`."""
    got = bound(work["bytes"], work["float_ops"]) if step_ms is None else roofline(work, step_ms)
    return {k: got.get(k, why) for k in keys}


def _trace_run(pred: Predictor, warm: Dict, data: bytes, chunk: int, n: int, encode_step_ms: float,
               work: dict) -> dict:
    """The `trace` row: the passes' compiled chunks and their graph pool
    released, the predictor put back to `warm`, the first `n` bytes of
    every stream (as `compress_bytes` lays them out) encoded in one chunk to
    capture the window's graphs, then put back and encoded again under
    torch.profiler (`trace_window`). `encode_step_ms` is the best encode
    pass's wall a byte step, against which the device's busy time gives a
    second idle share (the profiler's own host work stretches the traced
    wall). The roofline's shares (`work`, `step_work`'s count of a step)
    are taken against the device's busy time a step."""
    dev, S = pred.device, pred.num_streams
    released = 0.0
    if dev.type == "cuda":
        before = torch.cuda.memory_reserved(dev)
        pred.plan.release_graphs()
        torch.cuda.empty_cache()
        released = (before - torch.cuda.memory_reserved(dev)) / 1e9
    window = torch.as_tensor(_pad_streams(data, S, chunk)[0][:, :n].copy(), device=dev)
    code = torch.zeros((S, 1), dtype=torch.uint8, device=dev)  # encode never reads it

    def encode() -> None:
        run_chunks(pred, window, code, n, decode=False, chunk=n)
        sync(dev)

    reset_to_warm(pred, warm)
    encode()  # captures the window's graphs
    reset_to_warm(pred, warm)
    sync(dev)
    before = _launch_counts()
    row = trace_window(encode, n, dev)
    launches = [b - a for a, b in zip(before, _launch_counts())]
    row.update(byte_steps=n, backward_passes=n // pred.spec.lstm.horizon if pred.spec.lstm is not None else 0,
               encode_pass_ms_per_step=encode_step_ms, graphs_released_gb=released)
    if dev.type == "cuda":
        row["hand_written_launches_per_step"] = [x / n for x in launches]
        row["idle_share_of_passes"] = 1.0 - row["device_busy_ms_per_step"] / encode_step_ms
        if pred.analysis:
            row.update(_roofline_row(work, None, SHARES, NO_SHARE_ANALYSIS))
        else:
            row.update(_roofline_row(work, row["device_busy_ms_per_step"], SHARES))
    else:
        row["hand_written_launches_per_step"] = "not measured: the plain versions run on the CPU"
        row.update(_roofline_row(work, None, SHARES))
    return row


def emit(out: list, kind: str, **fields) -> None:
    row = {"bench": kind, **fields}
    out.append(row)
    print(json.dumps(row), flush=True)


def run_once(spec: EnsembleSpec, num_streams: int, chunk: int, data: bytes, warm: bytes = b"", passes: int = 2,
             device=None, lines: Optional[list] = None, warm_checkpoint: Optional[str] = None,
             trace: int = 0, encode_only: bool = False, analysis: bool = False) -> dict:
    """Encode `data` over `num_streams` streams `passes` times, then decode
    the archive as often, each pass from the warm start that `warm` trains
    (`pretrain_state`; b"": the fresh state), on one predictor that is put
    back to it before each pass (bench.py's `_run_once`). Each pass is timed
    alone and printed; an archive unlike the first pass's, a decode that is
    not `data`, or a cross-entropy that is not finite raises RuntimeError.
    Returns the result: rates per pass, best and median, bpb and model bpb,
    the archive's sha256, state and peak bytes, the graphs' capture and the
    warm start's seconds and source, and the step's roofline: its work
    (`step_work`: bytes, float and integer operations a byte step, a bit
    and by part), the bound, and the shares of the card's peaks that the
    best encode pass's step reaches (`roofline`). Printed rows are also
    appended to `lines`.

    With `warm_checkpoint`, the warm start is read from that file when it
    exists and trained and written there otherwise; a file made by another
    warm start raises SystemExit before anything is allocated
    (`check_warm_checkpoint`). With `trace` > 0, a `trace` row of that many
    encode byte steps follows the passes (`_trace_run`).

    With `encode_only` no decode pass runs (`decoded` False, no decode
    rates). With `analysis` the predictor runs the per-column entropy EMA,
    the result holds `model_ema` (`analysis_snapshot` after the last encode
    pass, averaged over the streams, by `analysis_columns`) and no share of
    the card's peaks (the count is of the step without the EMA).

    The predictor is dropped before the result returns: its graphs
    released, and what it held given back (`release_device`).

    With an LSTM, `chunk` and the pretraining's chunk must be multiples of
    its horizon (the deferred backward pass), or ValueError: a chunk of the
    other order decodes other bytes with no error; so must `trace`, so that
    the traced window runs the passes' kind of graphs."""
    lines = [] if lines is None else lines
    dev = default_device() if device is None else torch.device(device)
    n, S = len(data), num_streams
    per = padded_per(n, S, chunk)
    if spec.lstm is not None:
        hz = spec.lstm.horizon
        if chunk % hz or min(chunk, WARM_CHUNK) % hz:
            raise ValueError(f"chunk {chunk}: the LSTM's horizon {hz} must divide it and min(chunk, {WARM_CHUNK})")
        if trace % hz:
            raise ValueError(f"a trace of {trace} byte steps: the LSTM's horizon {hz} must divide it")
    if passes < 1:
        raise ValueError(f"{passes} passes")
    if not 0 <= trace <= per:
        raise ValueError(f"a trace of {trace} byte steps: a stream has {per}")
    sidecar = warm_sidecar(spec, warm, chunk)
    from_file = warm_checkpoint is not None and check_warm_checkpoint(warm_checkpoint, sidecar)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    warm_state = load_warm_checkpoint(warm_checkpoint) if from_file else pretrain_state(spec, warm, chunk, dev)
    warm_s = time.perf_counter() - t0
    warm_write_s = None
    if warm_checkpoint is not None and not from_file:
        t0 = time.perf_counter()
        save_warm_checkpoint(warm_checkpoint, warm_state, sidecar)
        warm_write_s = time.perf_counter() - t0
    pred = warm_predictor(spec, S, warm_state, dev, analysis)
    t0 = time.perf_counter()
    capture_s = 0.0
    if dev.type == "cuda":  # the CPU runs the byte step op by op: nothing to capture
        capture(pred, chunk, per, decode=not encode_only)
        sync(dev)
        capture_s = sum(g.record.capture_s for fn in pred.plan.fn_cache.values() for g in fn.graphs.values())
    warmup_s = time.perf_counter() - t0

    def timed(fn):
        reset_to_warm(pred, warm_state)
        sync(dev)
        t = time.perf_counter()
        out = fn()
        sync(dev)
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
        emit(lines, "pass", direction="encode", index=i + 1, seconds=t, bytes_per_s=n / t)
    ema = dict(zip(analysis_columns(spec), analysis_snapshot(pred).mean(axis=0).tolist())) if analysis else None
    for i in range(0 if encode_only else passes):
        out, t = timed(lambda: decompress_bytes(blob, spec, chunk, pred=pred,
                                                progress=finite_guard(pred, f"decode pass {i + 1}", chunk)))
        if out != data:
            at = next((j for j, (a, b) in enumerate(zip(out, data)) if a != b), min(len(out), n))
            raise RuntimeError(f"bench: decode pass {i + 1} differs from the input at byte {at} of {n}")
        dec_s.append(t)
        emit(lines, "pass", direction="decode", index=i + 1, seconds=t, bytes_per_s=n / t)
    step_ms = 1e3 * min(enc_s) / per
    work = step_work(pred.meta, S)
    if trace:
        emit(lines, "trace", **_trace_run(pred, warm_state, data, chunk, trace, step_ms, work))

    def rates(times):
        return {"best": n / min(times), "median": n / statistics.median(times)} if times else None

    if dev.type != "cuda":
        roof = _roofline_row(work, None, ("bound_ms", "bound_by") + SHARES + RATES)
    elif analysis:
        roof = _roofline_row(work, None, ("bound_ms", "bound_by") + SHARES + RATES, NO_SHARE_ANALYSIS)
    else:
        roof = _roofline_row(work, step_ms, ("bound_ms", "bound_by") + SHARES + RATES)
    out = {
        "streams": S, "chunk": chunk, "bytes": n, "warm_bytes": len(warm), "passes": passes, "byte_steps": per,
        "decoded": not encode_only, "analysis": analysis,
        "encode_s": enc_s, "decode_s": dec_s,
        "encode_bytes_per_s": rates(enc_s), "decode_bytes_per_s": rates(dec_s),
        "encdec_mbps": None if encode_only else 2 * n / (min(enc_s) + min(dec_s)) / 1e6,
        "archive_bytes": len(blob), "archive_sha256": hashlib.sha256(blob).hexdigest(),
        "bpb": 8 * len(blob) / n, "model_bpb": model_bits / n,
        "state_gb": pred.memory_bytes() / 1e9,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None,
        "peak_reserved_gb": torch.cuda.max_memory_reserved(dev) / 1e9 if dev.type == "cuda" else None,
        "capture_s": capture_s, "capture_warmup_s": warmup_s, "warm_s": warm_s,
        "warm_source": "checkpoint" if from_file else "trained", "warm_write_s": warm_write_s,
        "trace_steps": trace, "exact": True,
        **({"model_ema": ema} if analysis else {}),
        "work_per_step": work, **roof,
    }
    pred.plan.release_graphs()
    del pred
    release_device(dev)
    return out


def device_info(dev: torch.device) -> dict:
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


def baseline() -> dict:
    """data/baseline_measured.json (read, never written); {} without it."""
    if not os.path.exists(BASELINE):
        return {}
    with open(BASELINE) as f:
        return json.load(f)


def _vs_baseline(mbps: float) -> Optional[float]:
    ref = baseline().get("ref_encdec_mbps", 0.0)
    return mbps / ref if ref > 0 else None


def _checkpoint_path(template: Optional[str], name: str) -> Optional[str]:
    """The warm checkpoint of the profile `name`: `template` with
    `{profile}` filled with the name (`:` as `_`)."""
    return None if template is None else template.replace("{profile}", name.replace(":", "_"))


def main(argv=None) -> int:
    env = os.environ
    p = argparse.ArgumentParser(prog="python -m gmix_tpu_torch.bench",
                                description="encode + decode bytes/s at an exact roundtrip from a warm start")
    p.add_argument("--profile", default=env.get("GMIX_BENCH_PROFILE", "ref"),
                   help="ref, ref-ppm, ref-noppm or best (the published table sizes), scaled-<bits> (ref's tables "
                        "clamped to 2^bits) or <profile>:scaled-<bits>, then optionally :ladder-<variant> or "
                        ":ablate-<variant>; a trailing x<S> sets the streams; or quality:<variant>; several, "
                        "comma-separated, run one after the other")
    p.add_argument("--streams", default=None, help="N, or auto: the most that fit the budget (default)")
    p.add_argument("--chunk", type=int, default=int(env.get("GMIX_BENCH_CHUNK", 4000)))
    p.add_argument("--bytes", type=int, default=int(env["GMIX_BENCH_BYTES"]) if "GMIX_BENCH_BYTES" in env else None,
                   help="bytes coded (default: the rest of the corpus after the warm start)")
    p.add_argument("--warm", type=int, default=int(env.get("GMIX_BENCH_WARM", 1 << 17)),
                   help="the corpus' first bytes, on which one stream is trained for the warm start")
    p.add_argument("--offset", type=int, default=None,
                   help="the corpus byte the coded bytes start at, at or past the warm start's end (default: there)")
    p.add_argument("--passes", type=int, default=int(env.get("GMIX_BENCH_PASSES", 2)))
    p.add_argument("--encode-only", action="store_true", help="no decode passes (the result says decoded: false)")
    p.add_argument("--analysis", action="store_true",
                   help="run the per-column entropy EMA; the result gets model_ema, and no share of the peaks")
    p.add_argument("--warm-checkpoint", default=None, metavar="PATH",
                   help="read the warm start from PATH (a checkpoint with its sidecar PATH.json), or train it and "
                        "write it there if PATH does not exist (e.g. build/warm/ref-131072.gxt); with several "
                        "profiles PATH holds {profile}")
    p.add_argument("--trace", type=int, default=0, metavar="N",
                   help="after the passes, trace N encode byte steps under torch.profiler (with an LSTM a multiple "
                        "of its horizon; 100 at ref)")
    p.add_argument("--budget", type=int, default=int(env["GMIX_HBM_BUDGET"]) if "GMIX_HBM_BUDGET" in env else None,
                   help="device bytes the run may take (default: the device's total memory)")
    p.add_argument("--device", default=None, help="a torch device (default: the current CUDA device; cpu runs the "
                                                  "plain torch path)")
    p.add_argument("--out", default=None, help="also write the printed rows to this JSON file")
    args = p.parse_args(argv)

    try:
        profiles = [parse_profile(text) for text in args.profile.split(",")]
    except ValueError as e:
        raise SystemExit(f"bench: {e}")
    if len(profiles) > 1 and args.warm_checkpoint is not None and "{profile}" not in args.warm_checkpoint:
        raise SystemExit(f"bench: refused: {len(profiles)} profiles share the warm checkpoint "
                         f"{args.warm_checkpoint}; name one file a profile with {{profile}} in the path")
    for name, _, profile_streams in profiles:
        if name.startswith(QUALITY) and args.streams not in (None, profile_streams):
            raise SystemExit(f"bench: refused: --streams {args.streams} for {name}, whose streams are "
                             f"{profile_streams}")
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
    warm, data = corpus(args.warm, 0), corpus(args.bytes, offset)
    budget = _default_budget(dev) if args.budget is None else args.budget
    plans = []
    for name, spec, profile_streams in profiles:
        streams = args.streams or profile_streams or "auto"
        S = auto_streams(spec, len(data), args.chunk, budget) if streams == "auto" else int(streams)
        estimate = state_bytes_estimate(spec, max(S, 1))
        headroom = headroom_bytes(max(S, 1), padded_per(len(data), max(S, 1), args.chunk), args.chunk)
        config = dict(spec=name, streams=S, streams_asked=streams, chunk=args.chunk, bytes=len(data), offset=offset,
                      warm_bytes=args.warm, passes=args.passes, encode_only=args.encode_only,
                      analysis=args.analysis, warm_checkpoint=_checkpoint_path(args.warm_checkpoint, name),
                      trace=args.trace, state_estimate_bytes=estimate, headroom_bytes=headroom, budget_bytes=budget)
        plans.append((spec, S, config))
    lines: list = []
    for spec, S, config in plans:  # every configuration is checked before any runs
        if S < 1 or config["state_estimate_bytes"] + config["headroom_bytes"] > budget:
            emit(lines, "config", **config, **device_info(dev))
            raise SystemExit(f"bench: refused: {max(S, 1)} streams of {config['spec']} need "
                             f"{config['state_estimate_bytes']} bytes of state and {config['headroom_bytes']} of "
                             f"headroom, over the budget of {budget} bytes")
    for spec, S, config in plans:
        held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
        emit(lines, "config", **config, allocated_bytes=held, **device_info(dev))
        res = run_once(spec, S, args.chunk, data, warm, args.passes, dev, lines, config["warm_checkpoint"],
                       args.trace, args.encode_only, args.analysis)
        emit(lines, "result", spec=config["spec"], **res,
              vs_baseline=None if res["encdec_mbps"] is None else _vs_baseline(res["encdec_mbps"]),
              ref_bpb=baseline().get("ref_1m", {}).get("bpb"))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
