# Frozen copy of gmix_tpu_torch/ops/coder.py at commit 334906b, plain torch on the CPU only;
# imports nothing of gmix_tpu_torch, gmix_tpu or jax (h100_bench/reference/__init__.py).
"""Carry-less binary arithmetic coder as branch-free u32 lane math.

Port of `gmix_tpu.ops.coder` (reference: src/coder/encoder.cpp:8-34,
src/coder/decoder.cpp:17-39). Registers are (S,) int64 tensors holding u32
values, one lane per stream. Encode and decode share one function; `decode`
is a Python bool or, as in gmix_tpu, one bool lane per stream. The renormalisation loop
(0-4 iterations per bit, monotone) is unrolled to 4 masked steps.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


class CoderState(NamedTuple):
    """(S,) u32 lanes as int64. x is only meaningful in decode mode."""

    x1: torch.Tensor
    x2: torch.Tensor
    x: torch.Tensor


def discretize(p: torch.Tensor) -> torch.Tensor:
    """f32 probability in (0,1) -> u32 in [1, 65535] (encoder.cpp:8)."""
    return (1.0 + 65534.0 * p).to(torch.int64)


def coder_bit(
    st: CoderState,
    p16: torch.Tensor,
    enc_bit: torch.Tensor,
    in_bytes,
    decode,
):
    """One coder bit for all streams.

    Args:
      st: coder registers, (S,) u32 lanes each.
      p16: discretised probability of bit==1, (S,).
      enc_bit: the known bit in encode mode, (S,) in {0, 1}.
      in_bytes: (S, 4) lookahead bytes of the code stream at the current
        read positions (decode mode; ignored, and may be None, for encode).
      decode: False: encode, True: decode; a bool, or an (S,) bool tensor
        giving each stream its direction.

    Returns:
      (bit (S,), new_state, emit_bytes (S, 4), n_renorm (S,) int32). The
      encoder appends emit_bytes[:, :n_renorm] to the code stream; the
      decoder advances its read position by n_renorm.
    """
    x1, x2, x = st
    dec = decode if torch.is_tensor(decode) else torch.full(x1.shape, bool(decode), dtype=torch.bool, device=x1.device)
    d = (x2 - x1) & MASK32
    xmid = (x1 + (d >> 16) * p16 + (((d & 0xFFFF) * p16) >> 16)) & MASK32
    bit = torch.where(dec, (x <= xmid).to(torch.int64), enc_bit)
    take = bit.to(torch.bool)
    x2 = torch.where(take, xmid, x2)  # bit==1 keeps [x1, xmid]
    x1 = torch.where(take, x1, (xmid + 1) & MASK32)  # bit==0 keeps [xmid+1, x2]

    emits = []
    counts = torch.zeros(x1.shape, dtype=torch.int32, device=x1.device)
    for i in range(4):
        cond = ((x1 ^ x2) & 0xFF000000) == 0
        emits.append(torch.where(cond, x2 >> 24, 0))
        x1 = torch.where(cond, (x1 << 8) & MASK32, x1)
        x2 = torch.where(cond, ((x2 << 8) & MASK32) | 255, x2)
        if in_bytes is not None:
            x = torch.where(cond & dec, ((x << 8) & MASK32) | in_bytes[:, i], x)
        counts = counts + cond.to(torch.int32)

    return bit, CoderState(x1, x2, x), torch.stack(emits, dim=1), counts


def flush_bytes(x1: np.ndarray, x2: np.ndarray) -> list[bytes]:
    """Host-side per-stream flush, identical to Encoder::Flush (encoder.cpp:27-34)."""
    out = []
    for a, b in zip(np.asarray(x1, np.uint64), np.asarray(x2, np.uint64)):
        a, b = int(a), int(b)
        tail = bytearray()
        while ((a ^ b) & 0xFF000000) == 0:
            tail.append((b >> 24) & 0xFF)
            a = (a << 8) & 0xFFFFFFFF
            b = ((b << 8) + 255) & 0xFFFFFFFF
        tail.append((b >> 24) & 0xFF)
        out.append(bytes(tail))
    return out
