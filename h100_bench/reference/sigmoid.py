# Frozen copy of gmix_tpu_torch/ops/sigmoid.py at commit 334906b, plain torch on the CPU only;
# imports nothing of gmix_tpu_torch, gmix_tpu or jax (h100_bench/reference/__init__.py).
"""Clamped logistic/logit and the deterministic polynomial transcendentals.

Port of `gmix_tpu.ops.sigmoid`, op for op. Every function is built from
operations that IEEE 754 rounds exactly (+, -, *, /, round, compares and
integer bit operations; the square root by way of float64, `sqrt_det`), each
its own torch op, so the bits are the same on the CPU and on a CUDA device
and equal those of the JAX package run eagerly.

Two torch habits would break that and are avoided here:
- `scalar / tensor` is `tensor.reciprocal() * scalar` in torch (two
  roundings), so a scalar numerator goes through `rdiv`;
- a CUDA division by a host scalar is a multiply by its reciprocal, so no
  division here has a Python scalar as divisor.

All math is float32.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32

LOGIT_EPS = 1e-4

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
_SQRT2 = 1.4142135623730951
# Cody-Waite split of ln2: C1 exact in f32, C1 + C2 = ln2 to ~1e-11
_LN2_HI = 0.693359375
_LN2_LO = -2.12194440e-4


def rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """c / t as one correctly rounded f32 division."""
    return torch.full_like(t, c) / t


def sqrt_det(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, the same bits on every
    device. `torch.sqrt` on float32 is not: the CPU's vectorised root is off
    by one ulp in about 0.7% of random inputs, where an H100's is correctly
    rounded. A
    float64 square root rounded to float32 is the correctly rounded float32
    root, because 53 bits are more than twice 24 plus 2, so the second
    rounding cannot change the result."""
    return torch.sqrt(x.to(torch.float64)).to(F32)


def _exp_scaled(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """e**u * 2**n for |u| <= ln2/2 and integer-valued f32 n in [-126, 126]:
    degree-7 Taylor + exact exponent-field scaling."""
    p = u * (1.0 / 5040.0) + (1.0 / 720.0)
    for c in (1.0 / 120, 1.0 / 24, 1.0 / 6, 0.5, 1.0, 1.0):
        p = p * u + c
    scale = ((n.to(torch.int32) + 127) << 23).view(F32)
    return p * scale


def exp2_det(t: torch.Tensor) -> torch.Tensor:
    """2**t for f32 t in [-126, 126]."""
    t = torch.clamp(t, -126.0, 126.0)
    n = torch.round(t)
    u = (t - n) * _LN2
    return _exp_scaled(u, n)


def exp_det(x: torch.Tensor) -> torch.Tensor:
    """e**x with a Cody-Waite reduction; underflows to ~1e-38 below -87."""
    x = torch.clamp(x, -87.0, 87.0)
    n = torch.round(x * _LOG2E)
    u = (x - n * _LN2_HI) - n * _LN2_LO
    return _exp_scaled(u, n)


def log2_det(x: torch.Tensor) -> torch.Tensor:
    """log2(x) for finite x > 0: mantissa/exponent split by integer bit ops,
    ln(m) for m in [1/sqrt2, sqrt2) via the atanh series, degree 7."""
    xb = x.view(torch.int32)
    e = ((xb >> 23) & 0xFF) - 127
    m = ((xb & 0x007FFFFF) | 0x3F800000).view(F32)  # [1, 2)
    big = m > _SQRT2
    m = torch.where(big, m * 0.5, m)
    e = e + big.to(torch.int32)
    z = (m - 1.0) / (m + 1.0)
    z2 = z * z
    p = z2 * (2.0 / 7.0) + (2.0 / 5.0)
    for c in (2.0 / 3.0, 2.0):
        p = p * z2 + c
    lnm = p * z
    return e.to(F32) + lnm * _LOG2E


def log_det(x: torch.Tensor) -> torch.Tensor:
    """ln(x) for finite x > 0."""
    return log2_det(x) * _LN2


def pow_det(x: torch.Tensor, a: float) -> torch.Tensor:
    """x**a for x > 0 and a static exponent."""
    return exp2_det(log2_det(x) * float(a))


def powc_det(base: float, t: torch.Tensor) -> torch.Tensor:
    """base**t for a static base > 0 (log2(base) computed on the host in f64)."""
    return exp2_det(t * math.log2(base))


def tanh_det(x: torch.Tensor) -> torch.Tensor:
    """tanh(x) as 1 - 2/(e**2x + 1)."""
    return 1.0 - rdiv(2.0, exp_det(x + x) + 1.0)


def logistic(x: torch.Tensor) -> torch.Tensor:
    return rdiv(1.0, 1.0 + exp_det(-x))


def logit(p: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(p, LOGIT_EPS, 1.0 - LOGIT_EPS)
    return log_det(p / (1.0 - p))


def clamp_prob(p: torch.Tensor) -> torch.Tensor:
    """Clamp the final mixed probability like Predictor::Predict."""
    return torch.clamp(p, LOGIT_EPS, 1.0 - LOGIT_EPS)
