"""The host side of the codec: the GXTC v4 container, the byte loop, the
flush, temperature sampling, and the predictor's checkpoints.

Port of `gmix_tpu.core.codec` (the predictor with save/load/copy,
compress/decompress, generation). The input is split into `num_streams`
contiguous blocks, each coded by an independent model replica (one lane of
every batched state tensor). Streams are padded to a common length that is a
multiple of `chunk`; the port runs eagerly, so `chunk` only sets that
padding, which keeps the container identical to gmix_tpu's, the order of an
LSTM's backward pass (`run_chunks`), and how often `progress` is called and
generation draws its uniforms.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..config import EnsembleSpec
from ..ops import coder as coder_ops
from ..state import init_state, numpy_layout, state_bytes, state_from_numpy
from ..utils import threefry
from ..utils.serialization import copy_state, load_state, save_state
from .meta import Meta, analysis_names, build_meta
from .step import CODER_WIN, StepPlan, _byte_step, gen_chunk, lstm_bptt

MAGIC = b"GXTC"
# the container version of gmix_tpu.core.codec (v4: deterministic polynomial
# transcendentals); archives of the two packages share it
VERSION = 4
# worst-case output bytes per input byte (4 renorm bytes * 8 bits + slack)
_WORST_PER_BYTE = 33


def default_device() -> torch.device:
    """The device the entry points run on unless the caller names one: the
    current CUDA device. Without one they raise; the CPU is never a silent
    substitute (pass device="cpu" to ask for it)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "gmix_tpu_torch runs on a CUDA device by default and found none; "
            'pass device="cpu" to run the plain torch path on the CPU'
        )
    return torch.device("cuda", torch.cuda.current_device())


class Predictor:
    """Owns the batched model state of S streams on one device (the current
    CUDA device unless `device` says otherwise)."""

    def __init__(
        self,
        spec: EnsembleSpec,
        num_streams: int = 1,
        seed: int = 0xDEADBEEF,
        device=None,
        analysis: bool = True,
    ):
        self.spec = spec
        self.meta: Meta = build_meta(spec)
        self.num_streams = num_streams
        self.seed = seed
        self.device = default_device() if device is None else torch.device(device)
        # analysis=False runs no per-column entropy-EMA ops
        self.analysis = analysis
        self.plan = StepPlan(self.meta, num_streams, self.device)
        self.state = init_state(self.meta, num_streams, seed, self.device)

    # --- checkpoint / copy (gmix_tpu codec.py:116-143) ---
    def save(self, path: str) -> None:
        save_state(path, self.state)

    def load(self, path: str) -> None:
        """Take the state in the checkpoint `path`, onto this predictor's
        device. Every leaf's path, shape and dtype must be this spec's."""
        loaded = load_state(path)
        want = numpy_layout(self.state)
        got = numpy_layout(loaded)
        if sorted(got) != sorted(want):
            missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
            raise RuntimeError(f"{path}: checkpoint does not match the spec (missing {missing}, unexpected {extra})")
        for k, (shape, dtype) in want.items():
            if got[k] != (shape, dtype):
                raise RuntimeError(
                    f"{path}: checkpoint mismatch at {k}: {got[k][0]}/{got[k][1]} vs {shape}/{dtype}")
        self.state = state_from_numpy(loaded, self.device)

    def copy(self) -> "Predictor":
        """An independent predictor in the same state: every tensor is
        cloned, and the copy has its own StepPlan, so that it and this one
        run side by side with no read-back from the device."""
        p = object.__new__(Predictor)
        p.spec, p.meta, p.num_streams, p.seed = self.spec, self.meta, self.num_streams, self.seed
        p.device, p.analysis = self.device, self.analysis
        p.plan = StepPlan(self.meta, self.num_streams, self.device)
        p.state = copy_state(self.state)
        if self.spec.lstm is not None:
            p.plan.take_epoch(self.plan, self.state["stm"]["lstm"], p.state["stm"]["lstm"])
        return p

    def memory_bytes(self) -> int:
        return state_bytes(self.state)


@dataclass
class CodecResult:
    payloads: list  # list[bytes] per stream
    entropy_bits: float  # total cross-entropy over all coded bits


def _pad_streams(data: bytes, num_streams: int, chunk: int):
    orig = len(data)
    per = -(-max(orig, 1) // num_streams)  # ceil, >=1
    per = -(-per // chunk) * chunk  # round up to chunk multiple
    arr = np.zeros((num_streams, per), np.uint8)
    flat = np.frombuffer(data, np.uint8)
    for s in range(num_streams):
        seg = flat[s * per : (s + 1) * per]
        arr[s, : len(seg)] = seg
    return arr, per


def _compact_emits(win: np.ndarray, nw: np.ndarray, S: int):
    """Per-stream code bytes from the per-byte (win, nw) outputs: stream s's
    bytes are the concatenation over input bytes t of win[t, s, :nw[t, s]]."""
    mask = np.arange(win.shape[2])[None, None, :] < nw[:, :, None]
    return [win[:, s][mask[:, s]].tobytes() for s in range(S)]


def run_chunks(
    pred: Predictor,
    data_buf: torch.Tensor,
    code_buf: torch.Tensor,
    n_bytes: int,
    decode: bool,
    learn: bool = True,
    t0: int = 0,
    chunk: int = 4096,
    progress: Optional[Callable[[int], None]] = None,
):
    """Run the byte step over [t0, t0+n_bytes). The buffers stay on the
    predictor's device; the encoder's per-byte renorm bytes come back to the
    host once per chunk. Returns (data_buf, code_buf, payloads), payloads
    being the per-stream code bytes emitted by this call (encode; empty byte
    strings for decode). `progress(t + chunk)` is called after each chunk
    [t, t + chunk).

    `chunk` also decides when an LSTM's backward pass runs, by gmix_tpu's
    rule (`make_chunk_fn_raw`): when learning and the horizon divides
    `chunk`, it is deferred to after every horizon-th byte of the chunk, and
    `t0` must then be horizon-aligned; otherwise it runs inside the byte that
    wraps the window, before that byte's output-layer SGD. The two orders
    give different weights, so encoder and decoder must use the same chunk."""
    if n_bytes % chunk:
        raise ValueError("n_bytes must be a chunk multiple")
    S = data_buf.shape[0]
    Hz = pred.spec.lstm.horizon if pred.spec.lstm is not None else 0
    defer = learn and Hz > 0 and chunk % Hz == 0
    if defer and t0 % Hz:
        raise ValueError("t0 must be a multiple of the LSTM horizon when the horizon divides chunk")
    wins, nws = [], []
    for c0 in range(t0, t0 + n_bytes, chunk):
        cw, cn = [], []
        for t in range(c0, c0 + chunk):
            win, nw = _byte_step(pred.state, data_buf, code_buf, t, decode, pred.plan,
                                 learn=learn, analysis=pred.analysis, bptt=not defer)
            if defer and (t + 1 - c0) % Hz == 0:
                lstm_bptt(pred.state, pred.plan)
            if not decode:
                cw.append(win)
                cn.append(nw)
        if not decode:
            wins.append(torch.stack(cw).cpu().numpy())
            nws.append(torch.stack(cn).cpu().numpy())
        if progress is not None:
            progress(c0 + chunk)
    if decode:
        return data_buf, code_buf, [b""] * S
    win = np.concatenate(wins) if wins else np.zeros((0, S, CODER_WIN), np.uint8)
    nw = np.concatenate(nws) if nws else np.zeros((0, S), np.uint8)
    return data_buf, code_buf, _compact_emits(win, nw, S)


def _header(spec: EnsembleSpec, S: int, orig: int, per: int) -> bytes:
    return MAGIC + struct.pack("<BBHQQQQ", VERSION, 0, S, orig, per, spec.stable_hash(), 0)


def compress_bytes(
    data: bytes,
    spec: EnsembleSpec,
    num_streams: int = 1,
    chunk: int = 4096,
    pred: Optional[Predictor] = None,
    progress: Optional[Callable[[int], None]] = None,
    device=None,
) -> bytes:
    """Full-file compression into the GXTC container. The model runs on
    `pred.device`, or, when no predictor is given, on `device` (default: the
    current CUDA device). `progress` receives the bytes per stream coded so
    far after each chunk (`run_chunks`)."""
    orig = len(data)
    if orig == 0:
        return _header(spec, num_streams, 0, 0)
    arr, per = _pad_streams(data, num_streams, chunk)
    S = num_streams
    if pred is None:
        pred = Predictor(spec, S, device=device)
    dev = pred.device
    data_buf = torch.as_tensor(arr, device=dev)
    # encode never reads the code buffer
    code_buf = torch.zeros((S, 1), dtype=torch.uint8, device=dev)
    data_buf, code_buf, bodies = run_chunks(
        pred, data_buf, code_buf, per, decode=False, chunk=chunk, progress=progress
    )
    coder = {k: v.cpu().numpy() for k, v in pred.state["coder"].items()}
    tails = coder_ops.flush_bytes(coder["x1"], coder["x2"])
    for s in range(S):
        if len(bodies[s]) != int(coder["wpos"][s]):
            raise RuntimeError("emitted byte count disagrees with the coder's write cursor")
    payloads = [bodies[s] + tails[s] for s in range(S)]
    sizes = struct.pack(f"<{S}Q", *[len(p) for p in payloads])
    return _header(spec, S, orig, per) + sizes + b"".join(payloads)


def decompress_bytes(
    blob: bytes,
    spec: EnsembleSpec,
    chunk: int = 4096,
    pred: Optional[Predictor] = None,
    progress: Optional[Callable[[int], None]] = None,
    device=None,
) -> bytes:
    """The bytes of a GXTC archive; `pred`, `progress` and `device` as in
    `compress_bytes`."""
    if len(blob) < 40 or blob[:4] != MAGIC:
        raise ValueError("not a GXTC archive (bad magic or truncated header)")
    ver, _flags, S, orig, per, spec_hash, _rsv = struct.unpack("<BBHQQQQ", blob[4:40])
    if ver != VERSION:
        raise ValueError(f"unsupported GXTC container version {ver}")
    if spec_hash != spec.stable_hash():
        raise ValueError("spec mismatch: wrong profile for this archive")
    if orig == 0:
        return b""
    # every size must be provable from the blob before any allocation is
    # sized from it
    if S == 0 or per == 0 or per % chunk != 0:
        raise ValueError(f"malformed GXTC header: streams={S} per={per} chunk={chunk}")
    if orig > S * per:
        raise ValueError(f"malformed GXTC header: orig {orig} > streams*per {S * per}")
    off = 40
    if len(blob) < off + 8 * S:
        raise ValueError("truncated GXTC size table")
    sizes = struct.unpack(f"<{S}Q", blob[off : off + 8 * S])
    off += 8 * S
    if sum(sizes) != len(blob) - off:
        raise ValueError(
            f"malformed GXTC size table: payloads claim {sum(sizes)} bytes, "
            f"{len(blob) - off} present"
        )
    # the same capacity bound as gmix_tpu's codec
    cap = int(per + per // 2 + _WORST_PER_BYTE * chunk + 4096)
    if max(sizes) + 8 > cap:
        raise ValueError(
            f"malformed GXTC payload: stream size {max(sizes)} exceeds the "
            f"coder's worst-case bound {cap - 8} for per={per}"
        )
    if pred is None:
        pred = Predictor(spec, S, device=device)
    dev = pred.device
    # code bytes past a payload read as 0, as in gmix_tpu's zero-filled
    # buffer (the step masks reads past the buffer's end)
    codes = np.zeros((S, max(max(sizes), 4)), np.uint8)
    for s, sz in enumerate(sizes):
        codes[s, :sz] = np.frombuffer(blob, np.uint8, count=sz, offset=off)
        off += sz
    # prime the decoder window with the first 4 code bytes (decoder.cpp:5-8)
    x0 = np.zeros((S,), np.int64)
    for i in range(4):
        x0 = (x0 << 8) | codes[:, i]
    pred.state["coder"]["x"] = torch.as_tensor(x0, device=dev)
    pred.state["coder"]["rpos"] = torch.full((S,), 4, dtype=torch.int64, device=dev)
    data_buf = torch.zeros((S, per), dtype=torch.uint8, device=dev)
    code_buf = torch.as_tensor(codes, device=dev)
    data_buf, code_buf, _ = run_chunks(
        pred, data_buf, code_buf, per, decode=True, chunk=chunk, progress=progress
    )
    return data_buf.cpu().numpy().reshape(-1)[:orig].tobytes()


def generate_bytes(
    pred: Predictor,
    prompt: bytes,
    out_size: int,
    temperature: float = 1.0,
    chunk: int = 256,
    seed: int = 1234,
    progress: Optional[Callable[[int], None]] = None,
    return_all: bool = False,
):
    """Temperature sampling with learning off (gmix_tpu codec.py:324-381,
    runner-utils.cpp:158-221), on the predictor's device.

    The prompt is replayed WITH learning through `run_chunks` (the reference
    learns during the prompt), front-padded with zeros to a chunk multiple,
    the same prompt for every stream, so that the prompt's last byte sits
    where sampling starts. (The padding is gmix_tpu's documented deviation
    from the reference's exact-length replay, mirrored.) Sampling then runs
    from there with every learn stage off, so long-term memory stays as it
    is: per chunk, `key, sub = split(key)` from `key(seed)` and
    (chunk * 8, S) uniforms from `sub`, drawn on the host as jax.random does
    (utils/threefry.py) and moved to the device once. The bits are drawn
    against logistic(logit(p) * inv_temp) with inv_temp = float32(1 /
    max(temperature, 0.001)), a device tensor. `progress` receives the
    sampled bytes per stream after each chunk.

    Generates num_streams independent samples. Returns stream 0's bytes, or
    all streams' as a list with return_all=True."""
    S = pred.num_streams
    dev = pred.device
    temperature = max(temperature, 0.001)
    # ---- prompt replay (encode, learning on; code output dropped) ----
    if prompt:
        per = -(-len(prompt) // chunk) * chunk
        arr = np.zeros((1, per), np.uint8)
        arr[0, per - len(prompt):] = np.frombuffer(prompt, np.uint8)
        data_buf = torch.as_tensor(np.broadcast_to(arr, (S, per)).copy(), device=dev)
        code_buf = torch.zeros((S, 1), dtype=torch.uint8, device=dev)
        run_chunks(pred, data_buf, code_buf, per, decode=False, chunk=chunk)
        t0 = per
    else:
        t0 = 0
    # ---- sampling ----
    n = -(-out_size // chunk) * chunk
    data_buf = torch.zeros((S, t0 + n), dtype=torch.uint8, device=dev)
    key = threefry.key(seed)
    inv_temp = torch.tensor([np.float32(1.0 / temperature)], dtype=torch.float32, device=dev)
    for t in range(t0, t0 + n, chunk):
        key, sub = threefry.split(key)
        u = torch.as_tensor(threefry.uniform(sub, (chunk * 8, S), 0.0, 1.0), device=dev)
        gen_chunk(pred.state, data_buf, t, u, inv_temp, pred.plan)
        if progress is not None:
            progress(t - t0 + chunk)
    out = data_buf.cpu().numpy()
    if return_all:
        return [out[s, t0 : t0 + out_size].tobytes() for s in range(S)]
    return out[0, t0 : t0 + out_size].tobytes()


def entropy_bits(pred: Predictor) -> float:
    return float(pred.state["metrics"]["ent"].double().sum())


def analysis_columns(spec: EnsembleSpec) -> List[str]:
    return analysis_names(spec)


def analysis_snapshot(pred: Predictor) -> np.ndarray:
    """(S, C) per-column entropy EMA in bits (reference: analysis/entropy.tsv,
    predictor.cpp:471-503), read back from the device once."""
    return pred.state["metrics"]["ema"].cpu().numpy()


def memory_report(pred: Predictor) -> List[Tuple[str, int]]:
    """(component, bytes) rows (reference: analysis/memory.tsv via
    Model::GetMemoryUsage, predictor.cpp:488-503). The rows are named and
    ordered as gmix_tpu's: `jax.tree_util.keystr` of each leaf's path, such
    as `['ltm']['ind']['st']`, with the keys sorted at every level. The bytes
    are those the port holds on its device, so the rows sum to
    `pred.memory_bytes()`: the u32 lanes the port carries as int64 (state.py:
    `stm` `bits_seen`, `ctx`, `recent` and every other leaf of
    `init_state`'s int64 default) show twice gmix_tpu's bytes."""
    rows = []

    def walk(tree, prefix):
        for k in sorted(tree):
            v, name = tree[k], f"{prefix}['{k}']"
            if isinstance(v, dict):
                walk(v, name)
            else:
                rows.append((name, v.numel() * v.element_size()))

    walk(pred.state, "")
    return rows
