"""The byte step's boundary contexts and match pointers (core/contexts.py)
against gmix_tpu's, run eagerly, bitwise: `boundary_plain` against
`gmix_tpu.core.step._boundary` of a spec without PPM and LSTM (which is the
contexts alone), `match_plain` against the match block of
`gmix_tpu.core.step._byte_step`, on seeded states and on the corners that
the kernels of csrc/contexts.cu are held to on the card
(`utils/contexts_inputs.py`), at the first byte of a stream and after it.
The kernels' argument structures and their refusal of CPU tensors are
tests/test_torch_kernel_table.py's."""
import dataclasses
import inspect
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gmix_tpu as g
from gmix_tpu.core import step as j_step
from gmix_tpu.core.meta import build_meta as j_build_meta
import gmix_tpu_torch as gt
from gmix_tpu_torch.core import contexts as t_ctx
from gmix_tpu_torch.core import step as t_step
from gmix_tpu_torch.core.meta import build_meta
from gmix_tpu_torch.ops.murmur import murmur3_u32
from gmix_tpu_torch.state import state_to_numpy
from gmix_tpu_torch.utils.contexts_inputs import EDGE_STREAMS, edge_state, random_state, to_state

torch.set_num_threads(1)

S = 6
EDGE = {name: s for s, name in enumerate(EDGE_STREAMS)}


def _spec(pkg, name):
    """The contexts of tiny_spec(True) and of the reference wiring (its
    tables cut to 12 bits), without PPM and LSTM: gmix_tpu's `_boundary` is
    then the contexts alone. The rolling-hash contexts stay."""
    if name == "tiny":
        return dataclasses.replace(pkg.tiny_spec(True), ppm=None, lstm=None)
    return pkg.scale_tables(dataclasses.replace(pkg.reference_spec(), ppm=None, lstm=None), 12, history_bits=16)


def _metas(name):
    return j_build_meta(_spec(g, name)), build_meta(_spec(gt, name))


def _sample(meta, kind, seed):
    return edge_state(meta, seed) if kind == "edge" else random_state(meta, S, seed)


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert (got.shape, got.dtype) == (want.shape, want.dtype), what
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), f"{what} differs"


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("t", [0, 7])
@pytest.mark.parametrize("kind", ["random", "edge"])
@pytest.mark.parametrize("name", ["tiny", "ref"])
def test_boundary_plain_matches_eager_gmix_tpu(name, kind, t):
    j_meta, meta = _metas(name)
    sample = _sample(meta, kind, 11 + t)
    stm, _ = to_state(meta, sample, "cpu")
    n = stm["acc"].shape[0]
    before = {k: v.copy() for k, v in state_to_numpy(stm).items()}  # ih_tbl is written in place
    with jax.disable_jit():
        want, _ = j_step._boundary(_j(dict(before, bits_seen=np.zeros(n, np.uint32))), {}, jnp.int32(t), j_meta)
    t_ctx.boundary_plain(stm, torch.tensor(t), t_step.StepPlan(meta, n, "cpu"))
    got = state_to_numpy(stm)
    assert sorted(got) == sorted(set(want) - {"bits_seen"})
    for k in got:
        _same(got[k], want[k], k)
    assert (got["acc"] == 0).all()
    assert (got["recent"] == before["recent"]).all() == (t == 0)
    if kind == "edge":
        # the read of the new index sees this byte's write
        s = EDGE["ih-new-is-old"]
        hit = (before["ih_outer_hash"][s] & meta.ih_masks) == (got["ih_outer_hash"][s] & meta.ih_masks)
        assert hit.all()
        idx = (got["ih_outer_hash"][s].astype(np.int64) & meta.ih_masks) + meta.ih_offsets
        inner = ((before["ih_tbl"][s, idx].astype(np.int64) & (meta.ih_inner_mods.astype(np.int64) - 1)) << 8) \
            + int(got["last_byte"][s])
        assert (got["ih_tbl"][s, idx] == inner.astype(np.uint32)).all()
        out = murmur3_u32(torch.as_tensor(inner & 0xFFFFFFFF)).numpy()
        assert (got["ctx"][s, meta.ih_out_slots] == out).all()
        for b in ("byte-0", "byte-255"):
            assert got["last_byte"][EDGE[b]] == (0 if b == "byte-0" else 255)


def _gmix_tpu_match_block(stm, ltm, meta):
    """gmix_tpu's own match block, run eagerly on jnp leaves: the lines of
    `_byte_step` between its "match byte-boundary pointer logic" and
    "gather the per-byte working sets" comments, in the module's namespace.
    Returns (stm, match_ix)."""
    src = inspect.getsource(j_step._byte_step)
    block = src[src.index("    # ---- match byte-boundary pointer logic"):src.index("    # ---- gather the per-byte")]
    scope = dict(vars(j_step), stm=stm, ltm=ltm, meta=meta, spec=meta.spec,
                 s_ix=jnp.arange(stm["ctx"].shape[0])[:, None])
    exec(textwrap.dedent(block), scope)
    return scope["stm"], scope["match_ix"]


@pytest.mark.parametrize("kind", ["random", "edge"])
@pytest.mark.parametrize("name", ["tiny", "ref"])
def test_match_plain_matches_eager_gmix_tpu(name, kind):
    j_meta, meta = _metas(name)
    sample = _sample(meta, kind, 21)
    stm, ltm = to_state(meta, sample, "cpu")
    n = stm["acc"].shape[0]
    s_np, l_np = state_to_numpy(stm), state_to_numpy(ltm)
    with jax.disable_jit():
        want, want_ix = _gmix_tpu_match_block(_j(s_np), _j(l_np), j_meta)
    match_ix = t_ctx.match_plain(stm, ltm, t_step.StepPlan(meta, n, "cpu"))
    got = state_to_numpy(stm)
    for k in ("match_ptr", "match_byte", "match_len"):
        _same(got[k], want[k], k)
    assert match_ix.dtype == torch.int64
    _same(match_ix.numpy().astype(np.int32), np.asarray(want_ix), "match_ix")
    if kind == "edge":
        assert (got["match_len"][EDGE["match-len-255"]] == 255).all()
        assert (got["match_len"][EDGE["ptr-at-hist-end"]] == 0).all()
        s = EDGE["hist-empty"]
        assert (got["match_byte"][s] == s_np["match_byte"][s]).all() and (got["match_len"][s, ::2] == 0).all()
        s = EDGE["ptr-wraps"]
        assert (got["match_len"][s] == 101).all() and (got["match_ptr"][s] == 0).all()


@pytest.mark.parametrize("spec_name", ["tiny", "tiny-nolstm", "reference", "best", "ref-noppm"])
def test_boundary_table_holds_each_context_once(spec_name):
    """The boundary kernel's table (core/contexts.py `boundary_table`): its
    length from the spec's context counts, and each written slot once."""
    from gmix_tpu_torch import bench

    spec = {"tiny": lambda: gt.tiny_spec(True), "tiny-nolstm": lambda: gt.tiny_spec(False),
            "reference": gt.reference_spec, "best": gt.best_spec, "ref-noppm": bench.ref_noppm_spec}[spec_name]()
    meta = build_meta(spec)
    NI, NSK, NR, NIH = len(spec.interval_ctxs), len(spec.skip_ctxs), len(spec.roll_ctxs), len(spec.ihash_ctxs)
    table = t_ctx.boundary_table(meta)
    assert table.dtype == np.int64
    assert len(table) == t_ctx.BYTE_COLS + NI * (3 + 256) + NSK * t_ctx.PER_SKIP + NR * 3 + NIH * 5
    assert len(t_ctx.match_table(meta)) == 3 * len(spec.matches)
    assert t_ctx.BYTE_COLS <= meta.recent_size <= t_ctx.MAX_RECENT
