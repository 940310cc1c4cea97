"""gmix_tpu_torch.utils.threefry against `jax.random`, bit for bit: the key
of a seed, `split`, and the float32 `uniform` that draws the LSTM's initial
weights (gmix_tpu/state.py), at the weight shapes of 16 and 50 cells."""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gmix_tpu_torch.utils import threefry

SEEDS = (0xDEADBEEF, 1, 123456789012)


def _raw(key):
    return np.asarray(jax.random.key_data(key) if jnp.issubdtype(key.dtype, jax.dtypes.prng_key) else key)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_equal_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = threefry.key(seed)
    assert tk.dtype == np.uint32 and np.array_equal(_raw(jk), tk)
    for num in (2, 5):
        assert np.array_equal(_raw(jax.random.split(jk, num)), threefry.split(tk, num))


@pytest.mark.parametrize("cells", (16, 50))
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_equals_jax_bitwise(seed, cells):
    """`(3, C, 256)` from the first half of the split key and `(3, C, LI)`
    from the second, as `init_state` draws `w_sym` and `w_in`."""
    val = math.sqrt(6.0 / 512.0)
    jks = jax.random.split(jax.random.PRNGKey(seed))
    tks = threefry.split(threefry.key(seed))
    for jk, tk, shape in zip(jks, tks, ((3, cells, 256), (3, cells, 256 + cells + 1))):
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, -val, val))
        got = threefry.uniform(tk, shape, -val, val)
        assert got.dtype == np.float32 and got.shape == shape
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        assert got.min() >= np.float32(-val) and got.max() < np.float32(val)


def test_uniform_is_a_fused_multiply_add():
    """XLA's CPU compiler contracts `u * (hi - lo) + lo` into one rounding;
    the two-rounding expression differs from `jax.random.uniform` in about a
    third of the elements, so the emulation is what makes the draw equal."""
    val = math.sqrt(6.0 / 512.0)
    tk = threefry.split(threefry.key(SEEDS[0]))[0]
    bits = threefry.random_bits(tk, (3, 16, 256))
    u = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(-val), np.float32(val)
    two_roundings = np.maximum(lo, u * (hi - lo) + lo)
    got = threefry.uniform(tk, (3, 16, 256), -val, val)
    differ = int((two_roundings != got).sum())
    assert 0 < differ < got.size
    assert np.abs(two_roundings - got).max() <= np.spacing(np.float32(val))
