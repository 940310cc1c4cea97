"""The host side of the codec: the GXTC v4 container, the byte loop, the
flush, temperature sampling, and the predictor's checkpoints.

Port of `gmix_tpu.core.codec` (the predictor with save/load/copy,
compress/decompress, generation). The input is split into `num_streams`
contiguous blocks, each coded by an independent model replica (one lane of
every batched state tensor). Streams are padded to a common length that is a
multiple of `chunk`, the length of the compiled chunk that codes them
(`Predictor.chunk_fn`, gmix_tpu's jitted chunk program): on a CUDA device
the byte step replayed as CUDA graphs, on the CPU the same step op by op.
`chunk` also sets the order of an LSTM's backward pass (`run_chunks`), how
often `progress` is called and generation draws its uniforms, and how often
the encoder's bytes come back to the host.

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

from .. import obs
from ..config import EnsembleSpec
from ..ops import coder as coder_ops
from ..parallel.mesh import gather_state, make_mesh, shard_rows, shard_state
from ..state import copy_into, gmix_nbytes, init_state, into_storage, numpy_layout, state_from_numpy
from ..utils import threefry
from ..utils.serialization import copy_state, load_state, save_state
from .meta import Meta, analysis_names, build_meta
from .step import CODER_WIN, StepPlan, get_chunk_fn, get_gen_chunk_fn

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
    each with S / n streams, its own StepPlan and its state on its device.

    On a CUDA device the predictor codes through CUDA graphs of the byte step
    (`chunk_fn`, `gen_fn`), captured at their first use against the
    storage of its state's leaves. Those leaves keep their storage for the
    predictor's life: a state assigned (`state = st`: `st` becomes the
    state, holding them) or loaded is copied into them, and a leaf replaced
    in the dict is copied into its place before the next chunk runs."""

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
            held = getattr(self, "_state", None)
            if held is not None and value is not held:
                # the compiled chunks' graphs hold the leaves' storage: the
                # dict given becomes the state, with the held leaves refilled
                # from it, and the LSTM's epoch is read again
                into_storage(value, held)
                self.plan.forget_epoch()
            self._state = value
            return
        if len(value) != len(self.shards):
            raise ValueError(f"{len(value)} shard states for {len(self.shards)} shards")
        for p, st in zip(self.shards, value):
            p.state = st

    def _parts(self) -> List["Predictor"]:
        """The unsharded predictors that hold the streams, in stream order."""
        return [self] if self.shards is None else self.shards

    # --- compiled chunks (gmix_tpu codec.py:85-112) ---
    def chunk_fn(self, n: int, learn: bool = True):
        """The compiled chunk of `n` byte steps (`core.step.get_chunk_fn`:
        made once per shard and kept with its plan). `fn(data_buf, code_buf,
        t0, decode=False)` runs bytes [t0, t0 + n) of this predictor's state
        and returns the encoder's (win, nw) of each byte; a sharded
        predictor's takes and returns lists, one per shard, each shard's
        graphs on its device (gmix_tpu's `make_sharded_chunk_fn`)."""
        fns = [(p, get_chunk_fn(p.plan, n, learn, p.analysis)) for p in self._parts()]

        def fn(data_buf, code_buf, t0: int, decode: bool = False):
            if self.shards is None:
                return fns[0][1](self.state, self.plan, data_buf, code_buf, t0, decode)
            outs = [f(p.state, p.plan, d, c, t0, decode) for (p, f), d, c in zip(fns, data_buf, code_buf)]
            return [w for w, _ in outs], [nw for _, nw in outs]

        return fn

    def gen_fn(self, n: int):
        """The compiled sampling chunk of `n` bytes (`core.step.
        get_gen_chunk_fn`). `fn(data_buf, t0, u, inv_temp)` samples bytes
        [t0, t0 + n) into `data_buf` from `u`, the (n * 8, S) uniforms;
        a sharded predictor's takes lists of data buffers, uniforms and
        inverse temperatures, one per shard (gmix_tpu's
        `make_sharded_gen_fn`)."""
        fns = [(p, get_gen_chunk_fn(p.plan, n)) for p in self._parts()]

        def fn(data_buf, t0: int, u, inv_temp) -> None:
            if self.shards is None:
                fns[0][1](self.state, self.plan, data_buf, t0, u, inv_temp)
                return
            for (p, f), d, u_p, it in zip(fns, data_buf, u, inv_temp):
                f(p.state, p.plan, d, t0, u_p, it)

        return fn

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
            # converted and copied into the leaves one at a time
            copy_into(self.state, loaded)
            self.plan.forget_epoch()
        else:
            # split on the CPU; each shard copies its part onto its device
            self.state = shard_state(state_from_numpy(loaded), make_mesh(devices=["cpu"] * self.sharding.mesh.size))

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
        """The state's bytes on the device(s), at the port's dtypes; a
        replicated leaf counts once."""
        return sum(n for _, n in _leaf_rows(self, lambda path, t: t.numel() * t.element_size()))


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

    The bytes run through the predictor's compiled chunk of `chunk` bytes
    (`Predictor.chunk_fn`): on a CUDA device CUDA graphs of the byte step,
    replayed once a byte; on the CPU the same steps op by op.

    A sharded predictor takes (and returns) a list of buffers for each, one
    per shard on its device, holding its rows of the (S, ·) buffer. Each
    chunk runs on every shard in turn (on CUDA devices the replays are
    queued without waiting, so shards on different cards run side by side);
    the streams never interact, so the order changes no bit.

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
    if learn and Hz > 0 and chunk % Hz == 0 and t0 % Hz:
        raise ValueError("t0 must be a multiple of the LSTM horizon when the horizon divides chunk")
    fn = pred.chunk_fn(chunk, learn)
    sharded = pred.shards is not None
    wins, nws = [[] for _ in parts], [[] for _ in parts]
    for c0 in range(t0, t0 + n_bytes, chunk):
        # every shard's chunk is queued before any output is read back
        if sharded:
            out_w, out_n = fn(data_bufs, code_bufs, c0, decode)
        else:
            out_w, out_n = ([x] for x in fn(data_bufs[0], code_bufs[0], c0, decode))
        if not decode:
            with obs.span("gmix.readback"):
                for i in range(len(parts)):
                    wins[i].append(out_w[i].cpu().numpy())
                    nws[i].append(out_n[i].cpu().numpy())
        if progress is not None:
            progress(c0 + chunk)
    if decode:
        return [b""] * S
    payloads = []
    with obs.span("gmix.compact"):
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
    with obs.span("gmix.encode"):
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
    with obs.span("gmix.compact"):
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
    with obs.span("gmix.decode"):
        parts = pred._parts()
        for p, x in zip(parts, _rows(pred, x0)):
            # into the leaves' own storage (the compiled chunks hold it)
            p.state["coder"]["x"].copy_(x)
            p.state["coder"]["rpos"].fill_(4)
        data_bufs = [torch.zeros((p.num_streams, per), dtype=torch.uint8, device=p.device) for p in parts]
        _run(pred, data_bufs, _rows(pred, codes), per, True, True, 0, chunk, progress)
        with obs.span("gmix.readback"):
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
    fn = pred.gen_fn(chunk)
    for t in range(t0, t0 + n, chunk):
        key, sub = threefry.split(key)
        # one draw for all S streams; each shard takes its columns
        u = threefry.uniform(sub, (chunk * 8, S), 0.0, 1.0)
        cols = np.cumsum([0] + [p.num_streams for p in parts])
        u_parts = [torch.as_tensor(np.ascontiguousarray(u[:, a:b]), device=p.device)
                   for a, b, p in zip(cols[:-1], cols[1:], parts)]
        if pred.shards is None:
            fn(data_bufs[0], t, u_parts[0], inv_temp[0])
        else:
            fn(data_bufs, t, u_parts, inv_temp)
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


def _leaf_rows(pred: Predictor, nbytes: Callable[[tuple, torch.Tensor], int]) -> List[Tuple[str, int]]:
    """(component, bytes) of every leaf of the predictor's state, named by
    `jax.tree_util.keystr` of its path, such as `['ltm']['ind']['st']`,
    with the keys sorted at every level, as gmix_tpu names them; the bytes
    are `nbytes(path, leaf)`, summed over the shards of a split leaf, a
    replicated (0-d) one's counted once."""
    rows = []

    def walk(trees, prefix, path):
        for k in sorted(trees[0]):
            vs, name = [t[k] for t in trees], f"{prefix}['{k}']"
            if isinstance(vs[0], dict):
                walk(vs, name, path + (k,))
            else:
                rows.append((name, sum(nbytes(path + (k,), v) for v in (vs if vs[0].dim() else vs[:1]))))

    walk([p.state for p in pred._parts()], "", ())
    return rows


def memory_report(pred: Predictor) -> List[Tuple[str, int]]:
    """(component, bytes) rows (reference: analysis/memory.tsv via
    Model::GetMemoryUsage, predictor.cpp:488-503): gmix_tpu's rows, each
    leaf at its bytes in gmix_tpu's layout (`state.gmix_nbytes`: a u32 lane
    the port carries as int64 counts 4 bytes), so that memory.tsv is
    gmix_tpu's. `pred.memory_bytes()` is the bytes on the device, which are
    more. A sharded predictor gives the same rows."""
    return _leaf_rows(pred, gmix_nbytes)
