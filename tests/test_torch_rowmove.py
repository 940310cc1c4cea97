"""The row movers' plain torch gather/scatter against gmix_tpu's (which
takes its XLA path on the CPU), bitwise, at the five arena row shapes of the
byte step (the PPM rows, u16 W=272, among them), one arena at a time and all
in one grouped call, either direction. The CUDA kernels are held against the
plain versions in test_torch_kernels.py, which runs on a GPU machine without
JAX."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmix_tpu.ops import rowmove as j_rm
from gmix_tpu_torch import obs
from gmix_tpu_torch.ops import rowmove as t_rm

torch.set_num_threads(1)

# (numpy dtype, row width): ind.st, mix_w, mix_pos, apm
SHAPES = [(np.uint16, 256), (np.float32, 128), (np.float32, 1024), (np.float32, 264)]
# with ppm_tbl
SHAPES5 = SHAPES + [(np.uint16, 272)]
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


def test_ppm_row_shape_matches_gmix_tpu():
    """u16 rows of 272 lanes (34 16-byte words, no power of two), both ways."""
    tbl, idx, upd = _case(np.uint16, 272, 272)
    want = np.asarray(j_rm.gather_rows(jnp.asarray(tbl), jnp.asarray(idx)))
    assert np.array_equal(_np(t_rm.gather_rows(_t(tbl), torch.tensor(idx)), np.uint16), want)
    want = np.asarray(j_rm.scatter_rows(jnp.asarray(tbl), jnp.asarray(idx), jnp.asarray(upd)))
    assert np.array_equal(_np(t_rm.scatter_rows(_t(tbl), torch.tensor(idx), _t(upd)), np.uint16), want)


def _triples(shapes, seed0):
    """One (table, indices, rows) triple per (dtype, width), as numpy arrays."""
    return [_case(dtype, W, seed0 + i) for i, (dtype, W) in enumerate(shapes)]


@pytest.mark.parametrize("entry", ["scatter_rows_many", "scatter_rows_many_plain"])
@pytest.mark.parametrize("n_arenas", [0, 1, 5, 8])
def test_grouped_scatter_matches_gmix_tpu(entry, n_arenas):
    """Up to 8 arenas scattered in ONE call, each table bitwise equal to
    gmix_tpu's scatter into it; the tables are updated in place and returned."""
    shapes = [SHAPES5[i % len(SHAPES5)] for i in range(n_arenas)]
    cases = _triples(shapes, 51)
    triples = [(_t(tbl), torch.tensor(idx), _t(upd)) for tbl, idx, upd in cases]
    got = getattr(t_rm, entry)(triples)
    assert len(got) == n_arenas
    for (dtype, W), (tbl, idx, upd), (t_tbl, _, _), out in zip(shapes, cases, triples, got):
        want = np.asarray(j_rm.scatter_rows(jnp.asarray(tbl), jnp.asarray(idx), jnp.asarray(upd)))
        assert out is t_tbl  # in place
        assert np.array_equal(_np(t_tbl, dtype).view(np.uint8), want.view(np.uint8)), (dtype, W)


@pytest.mark.parametrize("n_arenas", [0, 1, 5, 8])
def test_grouped_scatter_is_the_list_of_single_scatters(n_arenas):
    cases = _triples([SHAPES5[i % len(SHAPES5)] for i in range(n_arenas)], 71)
    grouped = [(_t(tbl), torch.tensor(idx), _t(upd)) for tbl, idx, upd in cases]
    t_rm.scatter_rows_many(grouped)
    for (tbl, idx, upd), (g_tbl, _, _) in zip(cases, grouped):
        assert torch.equal(g_tbl, t_rm.scatter_rows(_t(tbl), torch.tensor(idx), _t(upd)))


def test_cpu_tensors_never_launch_a_kernel():
    tbl, idx, upd = _case(np.float32, 128, 5)
    before = obs.launches()
    t_rm.scatter_rows(_t(tbl), torch.tensor(idx), t_rm.gather_rows(_t(tbl), torch.tensor(idx)))
    t_rm.gather_rows_many([(_t(tbl), torch.tensor(idx))] * 3)
    t_rm.scatter_rows_many([(_t(tbl), torch.tensor(idx), _t(upd)), (_t(tbl), torch.tensor(idx), _t(upd))])
    assert obs.launches() == before


def test_other_devices_raise_instead_of_falling_back():
    # a tensor that is neither on the CPU nor on a CUDA device must not reach
    # the plain path
    tbl = torch.empty((S, N, 128), device="meta")
    idx = torch.zeros((S, M), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="the kernel takes CUDA tensors"):
        t_rm.gather_rows(tbl, idx)
    with pytest.raises(ValueError, match="the kernel takes CUDA tensors"):
        t_rm.scatter_rows(tbl, idx, torch.empty((S, M, 128), device="meta"))
    with pytest.raises(ValueError, match="the kernel takes CUDA tensors"):
        t_rm.gather_rows_many([(tbl, idx), (tbl, idx)])
    upd = torch.empty((S, M, 128), device="meta")
    with pytest.raises(ValueError, match="the kernel takes CUDA tensors"):
        t_rm.scatter_rows_many([(tbl, idx, upd), (tbl, idx, upd)])


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


def test_grouped_scatter_takes_one_device_only():
    tbl, idx, upd = _case(np.float32, 128, 9)
    cpu = (_t(tbl), torch.tensor(idx), _t(upd))
    meta = (torch.empty((S, N, 128), device="meta"), torch.zeros((S, M), dtype=torch.int32, device="meta"),
            torch.empty((S, M, 128), device="meta"))
    with pytest.raises(ValueError, match="one device"):
        t_rm.scatter_rows_many([cpu, meta])
    with pytest.raises(ValueError, match="one device"):
        t_rm.scatter_rows_many([meta, cpu])
    with pytest.raises(ValueError, match="1 to 8 arenas"):
        t_rm.scatter_rows_many([meta] * 9)
    assert torch.equal(cpu[0], _t(tbl))  # nothing was written
