# Frozen copy of gmix_tpu_torch/utils/threefry.py at commit 334906b, plain torch on the CPU only;
# imports nothing of gmix_tpu_torch, gmix_tpu or jax (h100_bench/reference/__init__.py).
"""The Threefry-2x32 counter PRNG with the key handling of `jax.random`,
in numpy: `key`, `split` and float32 `uniform`.

gmix_tpu draws the LSTM's initial weights with `jax.random.PRNGKey`,
`split` and `uniform` (gmix_tpu/state.py). An encoder and a decoder must
start from the same weights, and an archive written by one package should
start the other from the same model, so the port reproduces those draws bit
for bit without JAX. What is reproduced is what JAX 0.9 does with its
defaults (`jax_threefry_partitionable=True`, 32-bit mode):

- a key is two u32 words; `key(seed)` is `(0, seed mod 2^32)`: in 32-bit
  mode the seed is narrowed to 32 bits before its high word is taken;
- the counters of a draw of shape `shape` are the flat (row-major) element
  indices as 64-bit values, high word first: element i is hashed as the
  block `(i >> 32, i mod 2^32)`. `split` keeps both output words of block i
  as key i; 32 random bits of element i are the XOR of the two output words;
- `uniform` keeps the top 23 bits as the mantissa of a float in [1, 2),
  subtracts 1 and maps to [minval, maxval) as
  `max(minval, u * (maxval - minval) + minval)`. JAX jits that expression,
  and XLA's CPU compiler contracts the multiply and the add into one fused
  multiply-add (a single rounding). The port computes it in float64, where
  the product of two float32 values is exact, and rounds the sum once to
  float32 by way of a round-to-odd float64 sum (the construction of
  `core/fused.py:_matmul_fma`).

tests/test_torch_threefry.py holds all three bitwise against `jax.random`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The 20-round Threefry-2x32 block function on u32 arrays `x0`, `x1`
    under the two-word `key`."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` in 32-bit mode: (2,) u32."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _blocks(k: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    i = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        return threefry2x32(k, (i >> np.uint64(32)).astype(np.uint32), i.astype(np.uint32))


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """`jax.random.split(k, num)`: (num, 2) u32."""
    b0, b1 = _blocks(k, num)
    return np.stack([b0, b1], axis=1)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """32 random bits for every element of `shape`."""
    b0, b1 = _blocks(k, int(np.prod(shape, dtype=np.int64)))
    return (b0 ^ b1).reshape(shape)


def _fma_f32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """a * b + c of float32 values with the single rounding of a hardware
    fused multiply-add: the product is exact in float64; its float64 sum with
    c is rounded to odd (TwoSum says on which side the exact value lies), so
    the final rounding to float32 rounds the exact value once."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = np.broadcast_to(c.astype(np.float64), p.shape)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # exact: p + c == s + err
    even = (s.view(np.int64) & 1) == 0
    toward = np.copysign(np.inf, err)
    s = np.where((err != 0) & even, np.nextafter(s, toward), s)
    return s.astype(np.float32)


def uniform(k: np.ndarray, shape, minval: float, maxval: float) -> np.ndarray:
    """`jax.random.uniform(k, shape, float32, minval, maxval)` as XLA's CPU
    compiler evaluates it (see the module docstring)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(k, shape)
    u = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma_f32(u, np.float32(hi - lo), lo))
