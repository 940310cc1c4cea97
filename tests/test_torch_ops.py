"""gmix_tpu_torch.ops against gmix_tpu.ops run eagerly: murmur, every
polynomial transcendental, the coder. All comparisons are bitwise."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmix_tpu.ops import coder as j_coder
from gmix_tpu.ops import murmur as j_murmur
from gmix_tpu.ops import sigmoid as j_sig
from gmix_tpu_torch.ops import coder as t_coder
from gmix_tpu_torch.ops import murmur as t_murmur
from gmix_tpu_torch.ops import sigmoid as t_sig

torch.set_num_threads(1)

U32_EDGES = np.array([0, 1, 2, 255, 256, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _u32(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([U32_EDGES, rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)])


def _to_t(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(a.astype(np.int64) if a.dtype == np.uint32 else a)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a.astype(np.uint64)


def test_murmur3_u32_bitwise():
    x = _u32(4000, 1)
    want = np.asarray(j_murmur.murmur3_u32(jnp.asarray(x)))
    got = t_murmur.murmur3_u32(_to_t(x)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_murmur3_u64_bitwise():
    lo, hi = _u32(4000, 2), _u32(4000, 3)[::-1].copy()
    want = np.asarray(j_murmur.murmur3_u64(jnp.asarray(lo), jnp.asarray(hi)))
    got = t_murmur.murmur3_u64(_to_t(lo), _to_t(hi)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def _f32(lo, hi, edges, seed, n=5000, log=False):
    rng = np.random.default_rng(seed)
    if log:
        r = np.exp(rng.uniform(np.log(lo), np.log(hi), n))
    else:
        r = rng.uniform(lo, hi, n)
    return np.concatenate([np.asarray(edges, np.float64), r]).astype(np.float32)


_EXP_EDGES = [0.0, 0.5, -0.5, 1.0, -1.0, 86.9, -86.9, 87.0, -87.0, 90.0, -90.0, 126.0, -126.0, 130.0, -130.0]
_POS_EDGES = [1.0, 2.0, 0.5, 1.4142135, 1.4142137, 1e-4, 0.9999, 1e-30, 3e30, 1.1754944e-38]
_PROB_EDGES = [0.0, 1.0, 1e-4, 1.0 - 1e-4, 0.5, 1e-6, 0.999999, -0.5, 1.5]

CASES = {
    "exp2_det": (j_sig.exp2_det, t_sig.exp2_det, _f32(-130, 130, _EXP_EDGES, 10)),
    "exp_det": (j_sig.exp_det, t_sig.exp_det, _f32(-90, 90, _EXP_EDGES, 11)),
    "log2_det": (j_sig.log2_det, t_sig.log2_det, _f32(1e-30, 1e30, _POS_EDGES, 12, log=True)),
    "log_det": (j_sig.log_det, t_sig.log_det, _f32(1e-30, 1e30, _POS_EDGES, 13, log=True)),
    "pow_det": (lambda x: j_sig.pow_det(x, 0.8), lambda x: t_sig.pow_det(x, 0.8),
                _f32(1e-6, 1e6, _POS_EDGES, 14, log=True)),
    "powc_det": (lambda t: j_sig.powc_det(0.9999, t), lambda t: t_sig.powc_det(0.9999, t),
                 _f32(-1e5, 1e5, [0.0, 1.0, -1.0, 3000.0], 15)),
    "tanh_det": (j_sig.tanh_det, t_sig.tanh_det, _f32(-20, 20, [0.0, 1e-3, -1e-3, 10.0, -10.0, 50.0, -50.0], 16)),
    "logistic": (j_sig.logistic, t_sig.logistic, _f32(-100, 100, _EXP_EDGES, 17)),
    "logit": (j_sig.logit, t_sig.logit, _f32(0, 1, _PROB_EDGES, 18)),
    "clamp_prob": (j_sig.clamp_prob, t_sig.clamp_prob, _f32(-0.5, 1.5, _PROB_EDGES, 19)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sigmoid_polynomials_bitwise(name):
    j_fn, t_fn, x = CASES[name]
    want = np.asarray(j_fn(jnp.asarray(x)))
    got = t_fn(torch.tensor(x)).numpy()
    assert got.dtype == np.float32
    bad = np.flatnonzero(want.view(np.uint32) != got.view(np.uint32))
    assert bad.size == 0, f"{name}: {bad.size} inputs differ, first x={x[bad[0]]!r}: {want[bad[0]]!r} vs {got[bad[0]]!r}"


def test_discretize_bitwise():
    p = _f32(1e-4, 1 - 1e-4, [1e-4, 1 - 1e-4, 0.5], 20)
    want = np.asarray(j_coder.discretize(jnp.asarray(p)))
    got = t_coder.discretize(torch.tensor(p)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def _coder_inputs(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, n, dtype=np.uint64)
    b = rng.integers(0, 2**32, n, dtype=np.uint64)
    x1, x2 = np.minimum(a, b), np.maximum(a, b)
    # edges: the full range, a near-empty range, ranges that share top bytes
    x1[:4] = [0, 0x12345600, 0xABCDEF00, 0xFFFFFF00]
    x2[:4] = [0xFFFFFFFF, 0x123456FF, 0xABCDEF01, 0xFFFFFFFF]
    x = np.where(rng.random(n) < 0.5, x1, x2) - rng.integers(0, 2, n, dtype=np.uint64) * (x2 > x1)
    x = np.clip(x, x1, x2)
    p16 = rng.integers(1, 65536, n, dtype=np.uint64)
    p16[:3] = [1, 65535, 32768]
    bit = rng.integers(0, 2, n, dtype=np.uint64)
    in_bytes = rng.integers(0, 256, (n, 4), dtype=np.uint64)
    return [v.astype(np.uint32) for v in (x1, x2, x, p16, bit, in_bytes)]


@pytest.mark.parametrize("decode", [False, True])
def test_coder_bit_bitwise(decode):
    x1, x2, x, p16, bit, in_bytes = _coder_inputs(3000, 21 + decode)
    j_st = j_coder.CoderState(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(x))
    jb, jst, jem, jn = j_coder.coder_bit(j_st, jnp.asarray(p16), jnp.asarray(bit), jnp.asarray(in_bytes),
                                         jnp.asarray(decode))
    t_st = t_coder.CoderState(_to_t(x1), _to_t(x2), _to_t(x))
    tb, tst, tem, tn = t_coder.coder_bit(t_st, _to_t(p16), _to_t(bit), _to_t(in_bytes), decode)
    for name, want, got in (("bit", jb, tb), ("x1", jst.x1, tst.x1), ("x2", jst.x2, tst.x2),
                            ("emits", jem, tem), ("n_renorm", jn, tn)):
        np.testing.assert_array_equal(got.numpy().astype(np.uint64), np.asarray(want).astype(np.uint64), name)
    if decode:
        np.testing.assert_array_equal(tst.x.numpy().astype(np.uint32), np.asarray(jst.x))


def test_flush_bytes_equal():
    x1, x2 = _coder_inputs(200, 23)[:2]
    assert t_coder.flush_bytes(x1, x2) == j_coder.flush_bytes(x1, x2)


def test_sqrt_det_is_correctly_rounded():
    """The float32 root by way of float64: the correctly rounded value (numpy
    rounds float64's root once more to float32: innocuous, 53 > 2 * 24 + 2),
    which is also eager gmix_tpu's `jnp.sqrt`, denormal inputs aside (XLA
    flushes them)."""
    x = _f32(1e-30, 3e30, [0.0, 1.0, 2.0, 4.0, 1e-6, 1.00001, 1.1754944e-38, 3.4e38], 31, n=200000, log=True)
    got = t_sig.sqrt_det(torch.tensor(x)).numpy()
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), _bits(jnp.sqrt(jnp.asarray(x))))
