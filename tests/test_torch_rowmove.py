"""The row movers' plain torch gather/scatter against gmix_tpu's (which
takes its XLA path on the CPU), bitwise, at the four arena row shapes of the
byte step. The CUDA kernels are held against the plain versions in
test_torch_kernels.py, which runs on a GPU machine without JAX."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmix_tpu.ops import rowmove as j_rm
from gmix_tpu_torch.ops import rowmove as t_rm

torch.set_num_threads(1)

# (numpy dtype, row width): ind.st, mix_w, mix_pos, apm
SHAPES = [(np.uint16, 256), (np.float32, 128), (np.float32, 1024), (np.float32, 264)]
S, N, M = 3, 37, 9


def _case(dtype, W, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.uint16:
        tbl = rng.integers(0, 2**16, (S, N, W), dtype=np.uint64).astype(np.uint16)
        upd = rng.integers(0, 2**16, (S, M, W), dtype=np.uint64).astype(np.uint16)
    else:
        tbl = rng.standard_normal((S, N, W)).astype(np.float32)
        upd = rng.standard_normal((S, M, W)).astype(np.float32)
    idx = np.stack([rng.choice(N, M, replace=False) for _ in range(S)]).astype(np.int32)
    return tbl, idx, upd


def _t(a):
    """numpy -> torch with the port's storage dtype (u16 arenas are int16)."""
    return torch.tensor(a.view(np.int16) if a.dtype == np.uint16 else a)


def _np(t, dtype):
    a = t.numpy()
    return a.view(np.uint16) if dtype == np.uint16 else a


@pytest.mark.parametrize("dtype,W", SHAPES)
def test_plain_gather_matches_gmix_tpu(dtype, W):
    tbl, idx, _ = _case(dtype, W, W)
    want = np.asarray(j_rm.gather_rows(jnp.asarray(tbl), jnp.asarray(idx)))
    got = _np(t_rm.gather_rows(_t(tbl), torch.tensor(idx)), dtype)
    assert got.dtype == want.dtype and np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("dtype,W", SHAPES)
def test_plain_scatter_matches_gmix_tpu(dtype, W):
    tbl, idx, upd = _case(dtype, W, W + 1)
    want = np.asarray(j_rm.scatter_rows(jnp.asarray(tbl), jnp.asarray(idx), jnp.asarray(upd)))
    t_tbl = _t(tbl)
    out = t_rm.scatter_rows(t_tbl, torch.tensor(idx), _t(upd))
    assert out is t_tbl  # in place
    got = _np(t_tbl, dtype)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def test_cpu_tensors_never_launch_a_kernel():
    tbl, idx, upd = _case(np.float32, 128, 5)
    g0, s0 = t_rm.gather_rows.launches, t_rm.scatter_rows.launches
    t_rm.scatter_rows(_t(tbl), torch.tensor(idx), t_rm.gather_rows(_t(tbl), torch.tensor(idx)))
    assert (t_rm.gather_rows.launches, t_rm.scatter_rows.launches) == (g0, s0)


def test_other_devices_raise_instead_of_falling_back():
    # a tensor that is neither on the CPU nor on a CUDA device must not reach
    # the plain path
    tbl = torch.empty((S, N, 128), device="meta")
    idx = torch.zeros((S, M), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA or CPU tensor"):
        t_rm.gather_rows(tbl, idx)
    with pytest.raises(ValueError, match="expected a CUDA or CPU tensor"):
        t_rm.scatter_rows(tbl, idx, torch.empty((S, M, 128), device="meta"))
