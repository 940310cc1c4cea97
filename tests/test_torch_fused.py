"""The port's 8-sub-step function (plain version) against gmix_tpu's fused
kernel body, and the two packages' kernel layouts and constants.

gmix_tpu's `_kernel_body` is written for Pallas refs, but it only reads its
inputs with `ref[:]` and writes its outputs with `ref[:] = value`, so under
`jax.disable_jit()` it runs eagerly on plain jnp arrays and a small holder
class: every op rounds on its own, as in the port. (Pallas interpret mode
is far too slow here for a tier-1 test.) The same numpy inputs go through
both sides. Every output that can reach an archive must be bitwise equal;
`ent` and `ema` go through log2, which XLA and torch approximate on their
own: `ent` within 2 ulp per sub-step (16 ulp over the byte), `ema` within
1e-6 relative. Inputs are finite, valid codec states (utils/fused_inputs.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gmix_tpu as g
from gmix_tpu.core import fused as j_fused
from gmix_tpu.core.meta import build_meta as j_build_meta
import gmix_tpu_torch as gt
from gmix_tpu_torch.core import fused as t_fused
from gmix_tpu_torch.core.meta import build_meta as t_build_meta
from gmix_tpu_torch.utils.fused_inputs import random_inputs

torch.set_num_threads(1)

S = 2
_J_DTYPE = {jnp.uint32: torch.int64, jnp.int32: torch.int32, jnp.float32: torch.float32}


class _OutRef:
    """Stands in for a Pallas output ref: keeps what `ref[:] = value` stores."""

    def __setitem__(self, idx, value):
        self.value = value


def _to_jax(name, a, dtype):
    if name == "ind_blk":  # int16 bit patterns of u16 pairs -> gmix_tpu's int32
        a = a.view(np.uint16)
    return jnp.asarray(a.astype(np.dtype(dtype)))


def _spec(pkg, full):
    """tiny_spec(full), or for full == "ppm" the full spec without its LSTM:
    the PPM head alone, the prediction columns shifted by one."""
    if full == "ppm":
        return dataclasses.replace(pkg.tiny_spec(True), lstm=None)
    return pkg.tiny_spec(full)


def _run_jax(full, learn: bool, analysis: bool, inputs):
    meta = j_build_meta(_spec(g, full))
    ins, outs = j_fused._io_layout(meta, learn, analysis)
    consts = j_fused.const_inputs(meta, learn)
    refs = [consts[n] if kind == "c" else _to_jax(n, inputs[n], dt) for n, _, dt, kind in ins]
    out_refs = [_OutRef() for _ in outs]
    with jax.disable_jit():
        j_fused._kernel_body(meta, learn, analysis, ins, outs, refs + out_refs)
    return {n: np.asarray(r.value) for (n, _, _, _), r in zip(outs, out_refs)}


def _run_torch(full, learn: bool, analysis: bool, inputs):
    meta = t_build_meta(_spec(gt, full))
    consts = t_fused.const_inputs(meta, learn)
    fin = {n: torch.as_tensor(inputs[n]) for n, _, _, kind in t_fused.io_layout(meta, learn, analysis)[0] if kind == "s"}
    fo = t_fused.fused_substeps(meta, consts, fin, learn, analysis)
    return {n: v.numpy() for n, v in fo.items()}


# (full spec: PPM and LSTM heads and the skip column, learn, decode, analysis, not_first)
CASES = [
    (False, True, False, True, True),
    (False, True, True, True, True),
    (False, False, False, False, True),
    (False, True, False, False, False),
    (True, True, False, True, True),
    (True, True, True, False, True),
    (True, False, True, True, False),
    (True, True, False, True, False),
    (True, False, False, False, True),
    (False, False, True, True, True),
    (False, True, True, False, False),
]


@pytest.mark.parametrize("full,learn,decode,analysis,not_first", CASES)
def test_plain_substeps_match_eager_gmix_tpu_kernel_body(full, learn, decode, analysis, not_first):
    seed = 100 + CASES.index((full, learn, decode, analysis, not_first))
    _check_substeps(full, learn, decode, analysis, not_first, seed)


@pytest.mark.parametrize("learn,decode,analysis,not_first", [(True, False, True, True), (False, True, False, False)])
def test_plain_substeps_with_the_ppm_head_alone_match_eager_gmix_tpu_kernel_body(learn, decode, analysis, not_first):
    """The layout of a spec with PPM and without an LSTM (`ppm=1, lstm=0`)."""
    _check_substeps("ppm", learn, decode, analysis, not_first, 200 + int(decode))


def _check_substeps(full, learn, decode, analysis, not_first, seed):
    meta = t_build_meta(_spec(gt, full))
    inputs = random_inputs(meta, S, seed, decode=decode, not_first=not_first)
    want = _run_jax(full, learn, analysis, inputs)
    got = _run_torch(full, learn, analysis, inputs)
    assert sorted(got) == sorted(want)
    for name in want:
        a, b = want[name], got[name]
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        if name == "ind_blk":
            a = a.astype(np.uint16).view(np.int16)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), name
        if name == "ent":
            np.testing.assert_array_max_ulp(b, a, maxulp=16)
        elif name == "ema":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
        else:
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), f"{name} differs"
    # the case ran what it names: a decoded bit comes from the code value,
    # an encoded one from the data byte
    acc = got["coder"][:, t_fused.CR_ACC]
    if not decode:
        np.testing.assert_array_equal(acc, inputs["sc"][:, t_fused.SC_DATA])


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("learn,analysis", [(True, True), (False, False)])
def test_io_layout_matches_gmix_tpu(full, learn, analysis):
    j_ins, j_outs = j_fused._io_layout(j_build_meta(g.tiny_spec(full)), learn, analysis)
    t_ins, t_outs = t_fused.io_layout(t_build_meta(gt.tiny_spec(full)), learn, analysis)
    for j_list, t_list in ((j_ins, t_ins), (j_outs, t_outs)):
        assert [(n, tuple(tail), kind) for n, tail, _, kind in j_list] == [
            (n, tuple(tail), kind) for n, tail, _, kind in t_list
        ]
        for (n, _, j_dt, _), (_, _, t_dt, _) in zip(j_list, t_list):
            # the port's dtypes: int64 for u32 lanes, the int16 arena bits for ind_blk
            assert t_dt == (torch.int16 if n == "ind_blk" else _J_DTYPE[j_dt]), n


@pytest.mark.parametrize("full", [False, True])
def test_const_inputs_match_gmix_tpu(full):
    j_meta, t_meta = j_build_meta(g.tiny_spec(full)), t_build_meta(gt.tiny_spec(full))
    for learn in (True, False):
        want = j_fused.const_inputs(j_meta, learn)
        got = t_fused.const_inputs(t_meta, learn)
        assert set(want) <= set(got)
        for name, a in want.items():
            a, b = np.asarray(a), got[name].numpy()
            assert (a.shape, a.dtype) == (b.shape, b.dtype), name
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), name
    # the descriptor the CUDA kernel reads: class and index of every mixer
    # row, in k-order, invert the class index lists
    K = t_meta.mix_n0 + t_meta.mix_n1 + 1
    desc = got["desc_i"].numpy()
    classes = (t_meta.mix_st_ix, t_meta.mix_pos_ix, t_meta.mix_cd_ix, t_meta.mix_pd_ix, t_meta.mix_lm_ix)
    for k in range(K):
        assert classes[desc[k]][desc[K + k]] == k
    wg = np.asarray(t_meta.apm_weights, np.float32)
    np.testing.assert_array_equal(got["desc_f"].numpy()[: 2 * len(wg)], np.concatenate([wg, np.float32(1.0) - wg]))


def test_cuda_tensors_never_take_the_plain_path():
    """On a CUDA tensor the wrapper launches the kernel or raises; only CPU
    tensors reach the plain version (there is no card here, so the kernel's
    own test is tests/test_torch_kernels.py)."""
    meta = t_build_meta(gt.tiny_spec(False))
    fin = {"sc": torch.zeros((S, 8), dtype=torch.int64, device="meta")}
    with pytest.raises(ValueError, match="the kernel takes CUDA tensors"):
        t_fused.fused_substeps(meta, {}, fin, True, True)


def test_matmul_fma_rounds_once():
    """acc = fma(x, y, acc) must round the exact value once, as the CUDA
    kernel's __fmaf_rn and XLA's product do. Here acc = 1 and x * y =
    2^-24 + 2^-54 exactly: a float64 add drops the 2^-54, lands on the
    float32 tie 1 + 2^-24 and rounds to even, 1.0; the single rounding of
    the exact sum goes up, to 1 + 2^-23."""
    x, y = np.float32(1025 * 2.0**-27), np.float32(1047553 * 2.0**-27)
    assert float(x) * float(y) == 2.0**-24 + 2.0**-54  # exact in float64
    a = np.zeros((1, 2, 2), np.float32)
    b = np.zeros((1, 2, 2), np.float32)
    a[0, 0], b[:, 0, 0], b[:, 1, 0] = (1.0, x), 1.0, y  # out[0, 0] = fma(x, y, fma(1, 1, +0))
    got = t_fused._matmul_fma(torch.tensor(a), torch.tensor(b)).numpy()[0, 0, 0]
    assert got == np.nextafter(np.float32(1.0), np.float32(2.0))
    assert np.float32(np.float64(1.0) + np.float64(x) * np.float64(y)) == np.float32(1.0)  # the double rounding
