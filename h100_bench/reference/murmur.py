# Frozen copy of gmix_tpu_torch/ops/murmur.py at commit 334906b, plain torch on the CPU only;
# imports nothing of gmix_tpu_torch, gmix_tpu or jax (h100_bench/reference/__init__.py).
"""Vectorised MurmurHash3_x86_32 on u32 lanes carried as int64 tensors.

Port of `gmix_tpu.ops.murmur`. The reference hashes byte contexts with
MurmurHash3_x86_32 (src/contexts/murmur-hash.cpp, seed 0xDEADBEEF), always
over fixed-size little-endian keys: 8-byte keys for skip/recent-byte and outer
indirect-hash contexts, a 4-byte key for the inner indirect-hash context.

Torch's uint32 has no add, multiply or shift on the CPU, so every u32 value
of the port is an int64 tensor holding a value in [0, 2^32). Each operation
below masks its result back into that range. Multiplies by a 32-bit constant
are split into 16-bit halves so that no int64 product overflows.
"""
from __future__ import annotations

import torch

SEED = 0xDEADBEEF
MASK32 = 0xFFFFFFFF

_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for lanes a in [0, 2^32) and a constant c < 2^32.

    a * c_lo < 2^48 and (a * c_hi mod 2^16) << 16 < 2^32, so int64 never
    overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def _mix_block(h1, k1: torch.Tensor) -> torch.Tensor:
    k1 = mul32(k1, _C1)
    k1 = _rotl32(k1, 15)
    k1 = mul32(k1, _C2)
    h1 = k1 ^ h1
    h1 = _rotl32(h1, 13)
    return (mul32(h1, 5) + 0xE6546B64) & MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def murmur3_u64(lo: torch.Tensor, hi: torch.Tensor, seed: int = SEED) -> torch.Tensor:
    """Hash an 8-byte little-endian key given as two u32 halves (int64 lanes).

    Equivalent to MurmurHash3_x86_32(&key, 8, seed) on a little-endian host,
    where key = (hi << 32) | lo."""
    h1 = _mix_block(seed, lo)
    h1 = _mix_block(h1, hi)
    return _fmix32(h1 ^ 8)


def murmur3_u32(x: torch.Tensor, seed: int = SEED) -> torch.Tensor:
    """Hash a 4-byte key. Equivalent to MurmurHash3_x86_32(&key, 4, seed)."""
    return _fmix32(_mix_block(seed, x) ^ 4)
