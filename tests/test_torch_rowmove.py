"""The row movers' plain torch gather/scatter against gmix_tpu's (which
takes its XLA path on the CPU), bitwise, at the four arena row shapes of the
byte step, one arena at a time and all four in one grouped call. The CUDA kernels are held against the plain versions in
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


def _group(shapes, seed0=11):
    """One (table, indices) pair per (dtype, width), as numpy arrays."""
    return [_case(dtype, W, seed0 + i)[:2] for i, (dtype, W) in enumerate(shapes)]


@pytest.mark.parametrize("entry", ["gather_rows_many", "gather_rows_many_plain"])
def test_grouped_gather_matches_gmix_tpu(entry):
    """All four arena shapes of the byte step in ONE call, each arena bitwise
    equal to gmix_tpu's gather of it."""
    cases = _group(SHAPES)
    got = getattr(t_rm, entry)([(_t(tbl), torch.tensor(idx)) for tbl, idx in cases])
    assert len(got) == len(cases)
    for (dtype, W), (tbl, idx), out in zip(SHAPES, cases, got):
        want = np.asarray(j_rm.gather_rows(jnp.asarray(tbl), jnp.asarray(idx)))
        out = _np(out, dtype)
        assert out.shape == (S, M, W) and out.dtype == want.dtype
        assert np.array_equal(out.view(np.uint8), want.view(np.uint8)), (dtype, W)


@pytest.mark.parametrize("n_arenas", [0, 1, 8])
def test_grouped_gather_is_the_list_of_single_gathers(n_arenas):
    cases = _group([SHAPES[i % len(SHAPES)] for i in range(n_arenas)], seed0=31)
    pairs = [(_t(tbl), torch.tensor(idx)) for tbl, idx in cases]
    got = t_rm.gather_rows_many(pairs)
    assert len(got) == n_arenas
    for (tbl, idx), out in zip(pairs, got):
        assert torch.equal(out, t_rm.gather_rows(tbl, idx))


def test_cpu_tensors_never_launch_a_kernel():
    tbl, idx, upd = _case(np.float32, 128, 5)
    counters = (t_rm.gather_rows, t_rm.gather_rows_many, t_rm.scatter_rows)
    before = [w.launches for w in counters]
    t_rm.scatter_rows(_t(tbl), torch.tensor(idx), t_rm.gather_rows(_t(tbl), torch.tensor(idx)))
    t_rm.gather_rows_many([(_t(tbl), torch.tensor(idx))] * 3)
    assert [w.launches for w in counters] == before


def test_other_devices_raise_instead_of_falling_back():
    # a tensor that is neither on the CPU nor on a CUDA device must not reach
    # the plain path
    tbl = torch.empty((S, N, 128), device="meta")
    idx = torch.zeros((S, M), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA or CPU tensor"):
        t_rm.gather_rows(tbl, idx)
    with pytest.raises(ValueError, match="expected a CUDA or CPU tensor"):
        t_rm.scatter_rows(tbl, idx, torch.empty((S, M, 128), device="meta"))
    with pytest.raises(ValueError, match="expected a CUDA or CPU tensor"):
        t_rm.gather_rows_many([(tbl, idx), (tbl, idx)])


def test_grouped_gather_takes_one_device_only():
    tbl, idx, _ = _case(np.float32, 128, 9)
    meta_tbl = torch.empty((S, N, 128), device="meta")
    meta_idx = torch.zeros((S, M), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="one device"):
        t_rm.gather_rows_many([(_t(tbl), torch.tensor(idx)), (meta_tbl, meta_idx)])
    with pytest.raises(ValueError, match="one device"):
        t_rm.gather_rows_many([(meta_tbl, meta_idx), (_t(tbl), torch.tensor(idx))])
    with pytest.raises(ValueError, match="1 to 8 arenas"):
        t_rm.gather_rows_many([(meta_tbl, meta_idx)] * 9)
