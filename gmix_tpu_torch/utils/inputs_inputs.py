"""Seeded samples for the byte step's inputs part (`core.inputs`): the leaves
it reads, the input bytes, the code stream and the step's mode.

The tests and `chip_smoke.py` hold the kernel (csrc/inputs.cu) against the
plain version on the same samples, made with numpy so that every side gets
the same bits. `random_sample` draws a step as the codec runs it (u32
contexts, bytes, coder registers, a dense arena whose entries are now and
then -0.0 or a denormal, the decoder's read position anywhere in its code
stream or past its end); `to_state` puts one on a device, for all streams or
a few.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.meta import Meta

U32 = 2**32
# the step's modes: (decode, sampling, the read position past the stream's end)
MODES = {"encode": (False, False, False), "decode": (True, False, False), "decode-past-end": (True, False, True),
         "sample": (False, True, False)}
# the input bytes and code bytes a stream holds
DATA_COLS, CODE_CAP = 24, 96


def _u32(rng, shape) -> np.ndarray:
    return rng.integers(0, U32, shape, dtype=np.uint64).astype(np.int64)


def _dense(rng, shape) -> np.ndarray:
    """Float32 values of every kind: normal, +-0.0, denormals of both signs,
    the smallest normal, and the bitcast steps counters that gmix_tpu stores
    in the last lane (denormals below 2^23)."""
    x = rng.standard_normal(shape).astype(np.float32)
    kind = rng.random(shape)
    bits = rng.integers(1, 1 << 23, shape, dtype=np.int64).astype(np.uint32)
    sign = np.where(rng.random(shape) < 0.5, np.uint32(0x80000000), np.uint32(0))
    x = np.where(kind < 0.05, np.float32(0.0), x)
    x = np.where((kind >= 0.05) & (kind < 0.1), np.float32(-0.0), x)
    x = np.where((kind >= 0.1) & (kind < 0.2), (bits | sign).view(np.float32), x)
    x = np.where((kind >= 0.2) & (kind < 0.22), np.float32(np.finfo(np.float32).tiny) * np.where(sign, -1, 1), x)
    x[..., -1] = bits[..., -1].view(np.float32)  # the steps counter
    return x.astype(np.float32)


def random_sample(meta: Meta, S: int, seed: int, mode: str = "encode", t: int = 5) -> Dict:
    """A step of S streams at byte `t` in `mode` (`MODES`): {"stm", "coder",
    "dense": numpy leaves, "data" (S, DATA_COLS) u8, "code" (S, CODE_CAP) u8,
    "t", "col", "decode", "sample_u" ((8, S) float32, or None)}."""
    spec = meta.spec
    decode, sampling, past_end = MODES[mode]
    rng = np.random.default_rng(seed)
    ctx = _u32(rng, (S, meta.n_ctx))
    ctx[rng.random((S, meta.n_ctx)) < 0.05] = U32 - 1
    stm = {"ctx": ctx, "last_byte": rng.integers(0, 256, S), "recent": rng.integers(0, 256, (S, meta.recent_size)),
           "acc": rng.integers(0, 256, S), "bits_seen": rng.integers(0, 9, S), "new_bit": rng.integers(0, 2, S)}
    if spec.ppm is not None:
        for name in ("ppm_top", "ppm_bot", "ppm_mid"):
            stm[name] = rng.integers(-(2**31), 2**31, S).astype(np.int32)
    rpos = rng.integers(0, CODE_CAP - 40, S)
    if past_end:  # the window runs past the end by 0 to 40 bytes, or starts past it
        rpos = rng.integers(CODE_CAP - 40, CODE_CAP + 4, S)
    coder = {"x1": _u32(rng, S), "x2": _u32(rng, S), "x": _u32(rng, S), "wpos": rng.integers(0, 2**20, S),
             "rpos": rpos.astype(np.int64)}
    return {
        "stm": {k: np.asarray(v) for k, v in stm.items()}, "coder": coder,
        "dense": _dense(rng, (S, meta.mix_dense_total, meta.mix_width_pad)),
        "data": rng.integers(0, 256, (S, DATA_COLS)).astype(np.uint8),
        "code": rng.integers(0, 256, (S, CODE_CAP)).astype(np.uint8),
        "t": t, "col": int(rng.integers(0, DATA_COLS)), "decode": decode,
        "sample_u": rng.random((8, S)).astype(np.float32) if sampling else None,
    }


# the values of `edge_sample`'s dense arenas, one a stream
EDGE_VALUES = np.array([-0.0, 0.0, 1e-40, -1e-40, np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny],
                       np.float32)


def edge_sample(meta: Meta, seed: int = 0) -> Dict:
    """A decode step of len(EDGE_VALUES) streams whose windows run past the
    code stream's end, stream i's whole dense arena EDGE_VALUES[i]: -0.0,
    +0.0, a denormal of either sign, FLT_MIN of either sign (a ctx-dense
    table of T > 1 rows reads the first four as +0.0, a one-row table keeps
    every bit)."""
    sample = random_sample(meta, len(EDGE_VALUES), seed, "decode-past-end")
    sample["dense"][:] = EDGE_VALUES[:, None, None]
    return sample


def to_state(sample: Dict, device, streams: Optional[Sequence[int]] = None) -> Tuple[Dict, Dict]:
    """(state, args) on `device`: a state dict with the leaves the part reads
    (`stm`, `coder`, `ltm["mix_dense"]`), and the other arguments of
    `core.inputs.byte_inputs` by name (data_buf, code_buf, t, col, decode,
    sample_u); only the streams `streams` (all by default)."""
    S = len(sample["stm"]["acc"])
    keep = np.arange(S) if streams is None else np.asarray(streams, np.int64)

    def dev(a):
        a = np.ascontiguousarray(a[keep])
        return torch.as_tensor(a if a.dtype != np.uint32 else a.astype(np.int64), device=device)

    stm = {k: dev(v) for k, v in sample["stm"].items()}
    state = {"stm": stm, "coder": {k: dev(v) for k, v in sample["coder"].items()}, "ltm": {}}
    if sample["dense"].shape[1]:
        state["ltm"]["mix_dense"] = dev(sample["dense"])
    u = sample["sample_u"]
    args = {"data_buf": dev(sample["data"]), "code_buf": dev(sample["code"]),
            "t": torch.full((), sample["t"], dtype=torch.int64, device=device),
            "col": torch.full((), sample["col"], dtype=torch.int64, device=device), "decode": sample["decode"],
            "sample_u": None if u is None else torch.as_tensor(np.ascontiguousarray(u[:, keep]), device=device)}
    return state, args
