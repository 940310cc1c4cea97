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

A predictor may hold its streams split over the devices of a mesh
(`sharding=parallel.mesh.stream_sharding(mesh)`, gmix_tpu's `sharding=`):
then it holds one unsharded predictor per mesh entry, and every entry point
steps them all. The streams never interact, so the archives, checkpoints
and generated bytes are those of the unsharded predictor.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..config import EnsembleSpec
from ..ops import coder as coder_ops
from ..parallel.mesh import gather_state, shard_rows, shard_state
from ..state import init_state, numpy_layout, state_from_numpy
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
    CUDA device unless `device` says otherwise), or, with a `sharding`
    (`parallel.mesh.stream_sharding(mesh)`), split over the mesh's devices:
    `shards` is then one unsharded predictor per mesh entry, in stream order,
    each with S / n streams, its own StepPlan and its state on its device."""

    def __init__(
        self,
        spec: EnsembleSpec,
        num_streams: int = 1,
        seed: int = 0xDEADBEEF,
        device=None,
        analysis: bool = True,
        sharding=None,
    ):
        self.spec = spec
        self.meta: Meta = build_meta(spec)
        self.num_streams = num_streams
        self.seed = seed
        # analysis=False runs no per-column entropy-EMA ops
        self.analysis = analysis
        self.sharding = sharding
        self.shards: Optional[List["Predictor"]] = None
        if sharding is not None:
            if device is not None:
                raise ValueError("a sharded predictor runs on its mesh's devices: pass no device")
            mesh = sharding.mesh
            self.shards = [Predictor(spec, b - a, seed, device=d, analysis=analysis)
                           for (a, b), d in zip(shard_rows(num_streams, mesh), mesh.devices)]
            return
        self.device = default_device() if device is None else torch.device(device)
        self.plan = StepPlan(self.meta, num_streams, self.device)
        self.state = init_state(self.meta, num_streams, seed, self.device)

    @property
    def state(self):
        """The model state: a dict of tensors, or for a sharded predictor the
        list of its shards' states in stream order (`shard_state`'s form,
        which is also what assigning to it takes)."""
        return self._state if self.shards is None else [p.state for p in self.shards]

    @state.setter
    def state(self, value) -> None:
        if self.shards is None:
            self._state = value
            return
        if len(value) != len(self.shards):
            raise ValueError(f"{len(value)} shard states for {len(self.shards)} shards")
        for p, st in zip(self.shards, value):
            p.state = st

    def _parts(self) -> List["Predictor"]:
        """The unsharded predictors that hold the streams, in stream order."""
        return [self] if self.shards is None else self.shards

    # --- checkpoint / copy (gmix_tpu codec.py:116-143) ---
    def save(self, path: str) -> None:
        """Write the state to `path`; sharded or not, the same file."""
        save_state(path, self.state if self.shards is None else gather_state(self.state))

    def load(self, path: str) -> None:
        """Take the state in the checkpoint `path`, onto this predictor's
        device (or split over its mesh). Every leaf's path, shape and dtype
        must be this spec's."""
        loaded = load_state(path)
        if self.shards is None:
            want = numpy_layout(self.state)
        else:  # the whole state's layout; "meta" tensors allocate nothing
            want = numpy_layout(init_state(self.meta, self.num_streams, device="meta"))
        got = numpy_layout(loaded)
        if sorted(got) != sorted(want):
            missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
            raise RuntimeError(f"{path}: checkpoint does not match the spec (missing {missing}, unexpected {extra})")
        for k, (shape, dtype) in want.items():
            if got[k] != (shape, dtype):
                raise RuntimeError(
                    f"{path}: checkpoint mismatch at {k}: {got[k][0]}/{got[k][1]} vs {shape}/{dtype}")
        if self.shards is None:
            self.state = state_from_numpy(loaded, self.device)
        else:
            self.state = shard_state(state_from_numpy(loaded), self.sharding.mesh)

    def copy(self) -> "Predictor":
        """An independent predictor in the same state (and the same
        sharding): every tensor is cloned, and the copy has its own StepPlans,
        so that it and this one run side by side with no read-back from the
        device."""
        p = object.__new__(Predictor)
        p.spec, p.meta, p.num_streams, p.seed = self.spec, self.meta, self.num_streams, self.seed
        p.analysis, p.sharding, p.shards = self.analysis, self.sharding, None
        if self.shards is not None:
            p.shards = [s.copy() for s in self.shards]
            return p
        p.device = self.device
        p.plan = StepPlan(self.meta, self.num_streams, self.device)
        p.state = copy_state(self.state)
        if self.spec.lstm is not None:
            p.plan.take_epoch(self.plan, self.state["stm"]["lstm"], p.state["stm"]["lstm"])
        return p

    def memory_bytes(self) -> int:
        """The state's bytes on the device(s); a replicated leaf counts once."""
        return sum(n for _, n in memory_report(self))


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


def _rows(pred: Predictor, arr: np.ndarray) -> List[torch.Tensor]:
    """The rows of a host (S, n) array, one tensor per shard on its device
    (for an unsharded predictor one tensor)."""
    out, a = [], 0
    for p in pred._parts():
        out.append(torch.as_tensor(arr[a : a + p.num_streams], device=p.device))
        a += p.num_streams
    return out


def _stream_leaf(pred: Predictor, *path: str) -> torch.Tensor:
    """A leaf with the streams on axis 0, on the CPU, the shards' rows in
    stream order."""
    rows = []
    for p in pred._parts():
        x = p.state
        for k in path:
            x = x[k]
        rows.append(x.cpu())
    return torch.cat(rows)


def run_chunks(
    pred: Predictor,
    data_buf,
    code_buf,
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

    A sharded predictor takes (and returns) a list of buffers for each, one
    per shard on its device, holding its rows of the (S, ·) buffer. Its
    shards are stepped in turn at every byte, so one device runs a byte
    while the host dispatches the next shard's; the streams never interact,
    so the order changes no bit.

    `chunk` also decides when an LSTM's backward pass runs, by gmix_tpu's
    rule (`make_chunk_fn_raw`): when learning and the horizon divides
    `chunk`, it is deferred to after every horizon-th byte of the chunk, and
    `t0` must then be horizon-aligned; otherwise it runs inside the byte that
    wraps the window, before that byte's output-layer SGD. The two orders
    give different weights, so encoder and decoder must use the same chunk."""
    if pred.shards is None:
        return data_buf, code_buf, _run(pred, [data_buf], [code_buf], n_bytes, decode, learn, t0, chunk, progress)
    data_bufs, code_bufs = list(data_buf), list(code_buf)
    return data_bufs, code_bufs, _run(pred, data_bufs, code_bufs, n_bytes, decode, learn, t0, chunk, progress)


def _run(pred: Predictor, data_bufs: List[torch.Tensor], code_bufs: List[torch.Tensor], n_bytes: int,
         decode: bool, learn: bool, t0: int, chunk: int, progress) -> List[bytes]:
    """`run_chunks` on one buffer per shard; returns the payloads."""
    if n_bytes % chunk:
        raise ValueError("n_bytes must be a chunk multiple")
    parts = pred._parts()
    if len(data_bufs) != len(parts) or len(code_bufs) != len(parts):
        raise ValueError(f"{len(data_bufs)} data and {len(code_bufs)} code buffers for {len(parts)} shards")
    S = sum(d.shape[0] for d in data_bufs)
    Hz = pred.spec.lstm.horizon if pred.spec.lstm is not None else 0
    defer = learn and Hz > 0 and chunk % Hz == 0
    if defer and t0 % Hz:
        raise ValueError("t0 must be a multiple of the LSTM horizon when the horizon divides chunk")
    wins, nws = [[] for _ in parts], [[] for _ in parts]
    for c0 in range(t0, t0 + n_bytes, chunk):
        cw, cn = [[] for _ in parts], [[] for _ in parts]
        for t in range(c0, c0 + chunk):
            for i, p in enumerate(parts):
                win, nw = _byte_step(p.state, data_bufs[i], code_bufs[i], t, decode, p.plan,
                                     learn=learn, analysis=p.analysis, bptt=not defer)
                if defer and (t + 1 - c0) % Hz == 0:
                    lstm_bptt(p.state, p.plan)
                if not decode:
                    cw[i].append(win)
                    cn[i].append(nw)
        if not decode:
            for i in range(len(parts)):
                wins[i].append(torch.stack(cw[i]).cpu().numpy())
                nws[i].append(torch.stack(cn[i]).cpu().numpy())
        if progress is not None:
            progress(c0 + chunk)
    if decode:
        return [b""] * S
    payloads = []
    for i in range(len(parts)):
        n = data_bufs[i].shape[0]
        win = np.concatenate(wins[i]) if wins[i] else np.zeros((0, n, CODER_WIN), np.uint8)
        nw = np.concatenate(nws[i]) if nws[i] else np.zeros((0, n), np.uint8)
        payloads += _compact_emits(win, nw, n)
    return payloads


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
    `pred.device` (a sharded predictor: on its mesh), or, when no predictor
    is given, on `device` (default: the current CUDA device). `progress`
    receives the bytes per stream coded so far after each chunk
    (`run_chunks`)."""
    orig = len(data)
    if orig == 0:
        return _header(spec, num_streams, 0, 0)
    arr, per = _pad_streams(data, num_streams, chunk)
    S = num_streams
    if pred is None:
        pred = Predictor(spec, S, device=device)
    payloads = _encode_streams(pred, arr, chunk, progress)
    sizes = struct.pack(f"<{S}Q", *[len(p) for p in payloads])
    return _header(spec, S, orig, per) + sizes + b"".join(payloads)


def _encode_streams(pred: Predictor, arr: np.ndarray, chunk: int, progress=None) -> List[bytes]:
    """The flushed code bytes of each stream of `arr` ((S, per) u8, padded
    by `_pad_streams`), coded by `pred`, in stream order."""
    S, per = arr.shape
    if pred.num_streams != S:
        raise ValueError(f"the predictor has {pred.num_streams} streams, the input {S}")
    # encode never reads the code buffer
    code_bufs = [torch.zeros((p.num_streams, 1), dtype=torch.uint8, device=p.device) for p in pred._parts()]
    bodies = _run(pred, _rows(pred, arr), code_bufs, per, False, True, 0, chunk, progress)
    coder = {k: _stream_leaf(pred, "coder", k).numpy() for k in ("x1", "x2", "wpos")}
    tails = coder_ops.flush_bytes(coder["x1"], coder["x2"])
    for s in range(S):
        if len(bodies[s]) != int(coder["wpos"][s]):
            raise RuntimeError("emitted byte count disagrees with the coder's write cursor")
    return [bodies[s] + tails[s] for s in range(S)]


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
    if pred.num_streams != S:
        raise ValueError(f"the predictor has {pred.num_streams} streams, the archive {S}")
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
    parts = pred._parts()
    for p, x in zip(parts, _rows(pred, x0)):
        p.state["coder"]["x"] = x
        p.state["coder"]["rpos"] = torch.full((p.num_streams,), 4, dtype=torch.int64, device=p.device)
    data_bufs = [torch.zeros((p.num_streams, per), dtype=torch.uint8, device=p.device) for p in parts]
    _run(pred, data_bufs, _rows(pred, codes), per, True, True, 0, chunk, progress)
    return torch.cat([d.cpu() for d in data_bufs]).numpy().reshape(-1)[:orig].tobytes()


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
    parts = pred._parts()
    temperature = max(temperature, 0.001)
    # ---- prompt replay (encode, learning on; code output dropped) ----
    if prompt:
        per = -(-len(prompt) // chunk) * chunk
        arr = np.zeros((1, per), np.uint8)
        arr[0, per - len(prompt):] = np.frombuffer(prompt, np.uint8)
        code_bufs = [torch.zeros((p.num_streams, 1), dtype=torch.uint8, device=p.device) for p in parts]
        _run(pred, _rows(pred, np.broadcast_to(arr, (S, per)).copy()), code_bufs, per, False, True, 0, chunk, None)
        t0 = per
    else:
        t0 = 0
    # ---- sampling ----
    n = -(-out_size // chunk) * chunk
    data_bufs = [torch.zeros((p.num_streams, t0 + n), dtype=torch.uint8, device=p.device) for p in parts]
    key = threefry.key(seed)
    inv_temp = [torch.tensor([np.float32(1.0 / temperature)], dtype=torch.float32, device=p.device) for p in parts]
    for t in range(t0, t0 + n, chunk):
        key, sub = threefry.split(key)
        # one draw for all S streams; each shard takes its columns
        u = threefry.uniform(sub, (chunk * 8, S), 0.0, 1.0)
        a = 0
        for i, p in enumerate(parts):
            u_p = torch.as_tensor(np.ascontiguousarray(u[:, a : a + p.num_streams]), device=p.device)
            gen_chunk(p.state, data_bufs[i], t, u_p, inv_temp[i], p.plan)
            a += p.num_streams
        if progress is not None:
            progress(t - t0 + chunk)
    out = torch.cat([d.cpu() for d in data_bufs]).numpy()
    if return_all:
        return [out[s, t0 : t0 + out_size].tobytes() for s in range(S)]
    return out[0, t0 : t0 + out_size].tobytes()


def entropy_bits(pred: Predictor) -> float:
    """Total cross-entropy in bits: one float64 sum over the streams, in
    stream order, on the host (the same for a sharded predictor)."""
    return float(_stream_leaf(pred, "metrics", "ent").double().sum())


def analysis_columns(spec: EnsembleSpec) -> List[str]:
    return analysis_names(spec)


def analysis_snapshot(pred: Predictor) -> np.ndarray:
    """(S, C) per-column entropy EMA in bits (reference: analysis/entropy.tsv,
    predictor.cpp:471-503), read back from the device once."""
    return _stream_leaf(pred, "metrics", "ema").numpy()


def memory_report(pred: Predictor) -> List[Tuple[str, int]]:
    """(component, bytes) rows (reference: analysis/memory.tsv via
    Model::GetMemoryUsage, predictor.cpp:488-503). The rows are named and
    ordered as gmix_tpu's: `jax.tree_util.keystr` of each leaf's path, such
    as `['ltm']['ind']['st']`, with the keys sorted at every level. The bytes
    are those the port holds on its device, so the rows sum to
    `pred.memory_bytes()`: the u32 lanes the port carries as int64 (state.py:
    `stm` `bits_seen`, `ctx`, `recent` and every other leaf of
    `init_state`'s int64 default) show twice gmix_tpu's bytes. A sharded
    predictor gives the same rows: a split leaf's bytes summed over its
    shards, a replicated one's counted once."""
    rows = []

    def walk(trees, prefix):
        for k in sorted(trees[0]):
            vs, name = [t[k] for t in trees], f"{prefix}['{k}']"
            if isinstance(vs[0], dict):
                walk(vs, name)
            else:
                rows.append((name, sum(v.numel() * v.element_size() for v in (vs if vs[0].dim() else vs[:1]))))

    walk([p.state for p in pred._parts()], "")
    return rows
