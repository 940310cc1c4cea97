"""The CUDA row-mover kernels against their plain torch versions, on a GPU.

Imports torch and gmix_tpu_torch only, so it runs on a GPU machine that has
no JAX: `python -m pytest tests/test_torch_kernels.py -q`. Without a CUDA
device every test skips (the kernels have no CPU mode)."""
import numpy as np
import pytest
import torch

from gmix_tpu_torch.ops import rowmove

# (dtype, row width) of the four arenas the byte step moves rows of:
# ind.st (u16 bits in int16), mix_w, mix_pos, apm
SHAPES = [(torch.int16, 256), (torch.float32, 128), (torch.float32, 1024), (torch.float32, 264)]
S, N, M = 5, 300, 41


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the row-mover kernels have no CPU mode")
    return torch.device("cuda")


def _fill(t, gen):
    return t.normal_(generator=gen) if t.is_floating_point() else t.random_(generator=gen)


def _case(dtype, W, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    tbl = _fill(torch.empty((S, N, W), dtype=dtype, device=dev), gen)
    upd = _fill(torch.empty((S, M, W), dtype=dtype, device=dev), gen)
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(N, M, replace=False) for _ in range(S)]).astype(np.int32)
    return tbl, torch.as_tensor(idx, device=dev), upd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,W", SHAPES)
def test_gather_kernel_matches_plain(cuda, dtype, W):
    tbl, idx, _ = _case(dtype, W, cuda, W)
    n0 = rowmove.gather_rows.launches
    got = rowmove.gather_rows(tbl, idx)
    assert rowmove.gather_rows.launches == n0 + 1
    assert torch.equal(got, rowmove.gather_rows_plain(tbl, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,W", SHAPES)
def test_scatter_kernel_matches_plain(cuda, dtype, W):
    tbl, idx, upd = _case(dtype, W, cuda, W + 1)
    ref = tbl.clone()
    n0 = rowmove.scatter_rows.launches
    assert rowmove.scatter_rows(tbl, idx, upd) is tbl
    assert rowmove.scatter_rows.launches == n0 + 1
    rowmove.scatter_rows_plain(ref, idx, upd)
    torch.cuda.synchronize()
    assert torch.equal(tbl, ref)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    tbl, idx, upd = _case(torch.float32, 128, cuda, 7)
    with pytest.raises(ValueError, match="int32"):
        rowmove.gather_rows(tbl, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        rowmove.gather_rows(tbl[:, :, :64], idx)
    with pytest.raises(ValueError, match="share one device"):
        rowmove.scatter_rows(tbl, idx.cpu(), upd)
    with pytest.raises(ValueError, match="multiple of 16"):
        rowmove.gather_rows(torch.zeros((S, N, 6), device=cuda), idx)
