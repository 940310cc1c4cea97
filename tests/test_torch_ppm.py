"""The PPM byte model's boundary functions (core/ppm.py) and the rolling-hash
context update against gmix_tpu's, run eagerly, bitwise, on seeded numpy
states built to hit the corners: u16 counts of 32768 and more (a row that
rescales, a row that does not), a tag mismatch, an empty order, every symbol
excluded by the top order, and a `ppm_see` holding a denormal and a -0.0 in
the bucket the cascade selects; and at the corners that the kernels of
csrc/ppm.cu are held to on the card (`utils/ppm_inputs.py` `edge_inputs`),
with the integer sums the kernels take in place of the float tree."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gmix_tpu as g
from gmix_tpu.core import step as j_step
from gmix_tpu.core.meta import build_meta as j_build_meta
import gmix_tpu_torch as gt
from gmix_tpu_torch.core import ppm as t_ppm
from gmix_tpu_torch.core import step as t_step
from gmix_tpu_torch.core.fused import _tree_sum
from gmix_tpu_torch.core.meta import PPM_ROW_W, PPM_TAG_LANE, build_meta
from gmix_tpu_torch.ops.rowmove import gather_rows
from gmix_tpu_torch.state import init_state, state_from_numpy, state_to_numpy
from gmix_tpu_torch.utils.ppm_inputs import EDGE_STREAMS, U16_MAX, edge_inputs

torch.set_num_threads(1)

S = 6
DENORMAL = np.float32(1e-41)


def _spec(pkg, **ppm_changes):
    spec = dataclasses.replace(pkg.tiny_spec(True), lstm=None)
    return dataclasses.replace(spec, ppm=dataclasses.replace(spec.ppm, **ppm_changes))


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert (got.shape, got.dtype) == (want.shape, want.dtype), what
    assert np.array_equal(_bits(got), _bits(want)), f"{what} differs"


def _state(seed):
    """gmix_tpu's short-term state of the tiny PPM spec with seeded contexts,
    count rows and escape offsets, as numpy arrays."""
    meta = j_build_meta(_spec(g))
    rng = np.random.default_rng(seed)
    NO = len(meta.spec.ppm.orders)
    stm = {
        "bits_seen": np.zeros((S,), np.uint32),
        "ctx": rng.integers(0, 2**32, (S, meta.n_ctx), dtype=np.uint64).astype(np.uint32),
        "ppm_tbl": np.zeros((S, meta.ppm_total_rows, PPM_ROW_W), np.uint16),
        "ppm_see": (rng.standard_normal((S, NO, meta.spec.ppm.see_buckets)) * 0.5).astype(np.float32),
    }
    cv = stm["ctx"][:, meta.ppm_slots]
    h = (cv & meta.ppm_masks[None, :]).astype(np.int64) + meta.ppm_row_offsets[None, :]
    tag = ((cv >> 24) & 255).astype(np.uint16)
    tbl = stm["ppm_tbl"]
    # every other row of the arena: random sparse counts under a random tag
    tbl[:, :, :256] = rng.integers(0, 40, tbl[:, :, :256].shape) * (rng.random(tbl[:, :, :256].shape) < 0.05)
    tbl[:, :, PPM_TAG_LANE] = rng.integers(0, 256, tbl.shape[:2])
    for s in range(S):
        for i in range(NO):
            row = np.zeros((PPM_ROW_W,), np.uint16)
            sym = rng.choice(256, size=int(rng.integers(1, 12)), replace=False)
            row[sym] = rng.integers(1, 200, len(sym))
            row[PPM_TAG_LANE] = tag[s, i]
            tbl[s, h[s, i]] = row
    # stream 0: counts past int16 at the top order, total over rescale_total
    tbl[0, h[0, NO - 1], :256] = 0
    tbl[0, h[0, NO - 1], [7, 99, 200]] = (40000, 33000, 65535)
    # stream 1: counts past int16 that do not rescale; a tag mismatch above
    tbl[1, h[1, 0], :256] = 0
    tbl[1, h[1, 0], [3, 250]] = (32768, 15000)
    tbl[1, h[1, NO - 1], PPM_TAG_LANE] = (int(tag[1, NO - 1]) + 1) & 255
    # stream 2: an empty order in the middle, its tag matching
    tbl[2, h[2, 1], :256] = 0
    # stream 3: the top order has seen every symbol: all excluded below
    tbl[3, h[3, NO - 1], :256] = rng.integers(1, 9, 256)
    # streams 3 and 4: many distinct symbols select the last bucket, which
    # holds a denormal and a -0.0; stream 5: a whole order of -0.0 offsets
    tbl[4, h[4, 1], :256] = rng.integers(0, 3, 256)
    stm["ppm_see"][3, NO - 1, -1] = DENORMAL
    stm["ppm_see"][4, 1, -1] = np.float32(-0.0)
    stm["ppm_see"][5, 0, :] = np.float32(-0.0)
    stm["ppm_see"][2, 0, 3] = -DENORMAL
    # the completed byte: seen at the top order (0), under a mismatched tag
    # (1), in no order (2), anywhere (3, 4, 5)
    completed = rng.integers(0, 256, (S,)).astype(np.uint32)
    completed[0], completed[1] = 99, 250
    unseen = np.flatnonzero((tbl[2, h[2], :256] == 0).all(axis=0))
    completed[2] = unseen[0]
    return meta, stm, completed


def _port(stm_np, streams=S, **ppm_changes):
    meta = build_meta(_spec(gt, **ppm_changes))
    plan = t_step.StepPlan(meta, streams, "cpu")
    return plan, state_from_numpy(stm_np)


def _j(stm_np):
    return {k: jnp.asarray(v) for k, v in stm_np.items()}


def test_ppm_rows_match_eager_gmix_tpu():
    meta, stm_np, _ = _state(1)
    with jax.disable_jit():
        h, rows, my_tag, old_tag, tag_ok, raw = j_step._ppm_rows(_j(stm_np), jnp.asarray(stm_np["ctx"]), meta)
    plan, stm = _port(stm_np)
    cv, t_h = t_ppm._ppm_index(stm["ctx"], plan)
    t_raw = gather_rows(stm["ppm_tbl"], t_h)
    t_rows, t_my, t_old, t_ok = t_ppm._ppm_rows(t_raw, cv)
    _same(t_h.numpy(), h, "row indices")
    _same(t_raw.numpy().view(np.uint16), raw, "raw rows")
    # the port widens u16 to int32 before any compare
    assert t_rows.dtype == torch.int32 and int(t_rows.max()) == 65535
    _same(t_rows.numpy().astype(np.uint16), rows, "counts")
    _same(t_my.numpy().astype(np.uint16), my_tag, "context tags")
    _same(t_old.numpy().astype(np.uint16), old_tag, "stored tags")
    _same(t_ok.numpy(), tag_ok, "tag match")
    assert not t_ok.numpy()[1, -1] and t_ok.numpy()[0].all()


@pytest.mark.parametrize("exclusion", [True, False])
def test_ppm_cascade_matches_eager_gmix_tpu(exclusion):
    meta, stm_np, _ = _state(2)
    sp = dataclasses.replace(meta.spec.ppm, exclusion=exclusion)
    with jax.disable_jit():
        rows = j_step._ppm_rows(_j(stm_np), jnp.asarray(stm_np["ctx"]), meta)[1]
        want = j_step._ppm_cascade(rows.astype(jnp.float32), jnp.asarray(stm_np["ppm_see"]), sp)
    plan, stm = _port(stm_np, exclusion=exclusion)
    cv, h = t_ppm._ppm_index(stm["ctx"], plan)
    t_rows = t_ppm._ppm_rows(gather_rows(stm["ppm_tbl"], h), cv)[0]
    got = t_ppm._ppm_cascade(t_rows.to(torch.float32), stm["ppm_see"], plan.meta.spec.ppm, plan)
    for name, a, b in zip(("masked rows", "totals", "has", "escapes", "bucket one-hots"), got, want):
        _same(a.numpy(), np.stack([np.asarray(x) for x in b], axis=1), name)
    _same(got[5].numpy(), want[5], "exclusion mask")
    if exclusion:
        assert got[5].numpy()[3].all()  # stream 3: every symbol excluded
        assert not got[2].numpy()[3, :-1].any()  # so no lower order has counts left
    assert not got[2].numpy()[2, 1]  # stream 2: the empty order


@pytest.mark.parametrize("update_exclusion", [True, False])
def test_ppm_update_matches_eager_gmix_tpu(update_exclusion):
    meta, stm_np, completed = _state(3)
    sp = dataclasses.replace(meta.spec.ppm, update_exclusion=update_exclusion)
    j_meta = j_build_meta(dataclasses.replace(meta.spec, ppm=sp))
    with jax.disable_jit():
        want = j_step._ppm_update(_j(stm_np), jnp.asarray(completed), j_meta)
    plan, stm = _port(stm_np, update_exclusion=update_exclusion)
    before = stm["ppm_tbl"].clone()
    t_ppm._ppm_update(stm, torch.tensor(completed.astype(np.int64)), plan)
    got = state_to_numpy({"ppm_tbl": stm["ppm_tbl"], "ppm_see": stm["ppm_see"]})
    _same(got["ppm_tbl"], want["ppm_tbl"], "ppm_tbl")
    _same(got["ppm_see"], want["ppm_see"], "ppm_see")
    assert not torch.equal(before, stm["ppm_tbl"])
    # stream 0's top row was rescaled: (40000, 33000 + inc, 65535) halved, rounding up
    _, h = t_ppm._ppm_index(stm["ctx"], plan)
    row = got["ppm_tbl"][0, int(h[0, -1])]
    assert list(row[[7, 99, 200]]) == [20000, (33000 + sp.inc + 1) // 2, 32768]
    # stream 1's low row keeps a count past int16 and gains the increment
    row = got["ppm_tbl"][1, int(h[1, 0])]
    assert list(row[[3, 250]]) == [32768, 15000 + sp.inc]


def test_ppm_predict_matches_eager_gmix_tpu():
    meta, stm_np, _ = _state(4)
    with jax.disable_jit():
        want = j_step._ppm_predict(_j(stm_np), meta)
    plan, stm = _port(stm_np)
    cv, h = t_ppm._ppm_index(stm["ctx"], plan)
    t_ppm._ppm_predict(stm, gather_rows(stm["ppm_tbl"], h), cv, plan)
    for k in ("ppm_probs", "ppm_top", "ppm_bot"):
        _same(stm[k].numpy(), want[k], k)
    p = stm["ppm_probs"].numpy()
    assert np.isfinite(p).all() and (p >= 0).all()
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-5)  # a distribution (float32 sums)


@pytest.mark.parametrize("t", [0, 5])
def test_boundary_with_rolling_hash_matches_eager_gmix_tpu(t):
    """`_boundary` at the tiny PPM spec: the count update on the pre-update
    contexts, then the contexts, the rolling hash among them (u32 arithmetic
    whose difference wraps below zero), held at the stream's first byte."""
    spec = _spec(g)
    meta = j_build_meta(spec)
    rng = np.random.default_rng(5 + t)
    _, seeded, completed = _state(6)
    state_np = jax.device_get(g.state.init_state(meta, S))
    stm_np = dict(state_np["stm"], **{k: seeded[k] for k in ("ctx", "ppm_tbl", "ppm_see")})
    stm_np["acc"] = completed
    stm_np["recent"] = rng.integers(0, 256, stm_np["recent"].shape).astype(np.uint32)
    stm_np["roll_h"] = rng.integers(0, 2**32, stm_np["roll_h"].shape, dtype=np.uint64).astype(np.uint32)
    stm_np["roll_h"][0] = 0  # h - leaving * B^(n-1) < 0 for any leaving byte
    stm_np["last_byte"] = rng.integers(0, 256, (S,)).astype(np.uint32)
    with jax.disable_jit():
        want, _ = j_step._boundary(_j(stm_np), {}, jnp.int32(t), meta)
    plan = t_step.StepPlan(build_meta(_spec(gt)), S, "cpu")
    stm = state_from_numpy(stm_np)
    t_step._boundary(stm, t, plan)
    got = state_to_numpy(stm)
    # the port's _boundary leaves the prediction to the grouped gather
    for k in sorted(set(want) - {"ppm_probs", "ppm_top", "ppm_bot"}):
        _same(got[k], want[k], k)
    assert (got["roll_h"] == stm_np["roll_h"]).all() == (t == 0)


def test_ppm_state_leaves_cross_both_ways():
    """The PPM leaves of a fresh state equal gmix_tpu's (names, shapes,
    dtypes, values), and a state with counts past int16 and u32 hashes past
    int32 goes to the port and back unchanged."""
    meta = j_build_meta(_spec(g))
    want = jax.device_get(g.state.init_state(meta, S))["stm"]
    fresh = state_to_numpy(init_state(build_meta(_spec(gt)), S))["stm"]
    assert sorted(fresh) == sorted(want)
    for k in ("roll_h", "ppm_tbl", "ppm_top", "ppm_bot", "ppm_mid", "ppm_see", "ppm_probs"):
        _same(fresh[k], want[k], k)
    _, seeded, _ = _state(7)
    seeded["roll_h"] = np.array([[0xFFFFFFFF]] * S, np.uint32)
    port = state_from_numpy(seeded)
    assert port["ppm_tbl"].dtype == torch.int16 and port["roll_h"].dtype == torch.int64
    assert int(port["ppm_tbl"].min()) < 0  # bit patterns of counts >= 32768
    back = state_to_numpy(port)
    for k, v in seeded.items():
        _same(back[k], v, k)


# ---------------------------------------------------------------------------
# the corners the kernels (csrc/ppm.cu) are held to, here on the plain version
# ---------------------------------------------------------------------------

EDGE = {name: s for s, name in enumerate(EDGE_STREAMS)}
EXCLUSIONS = {"both": {}, "no-exclusion": {"exclusion": False}, "no-update-exclusion": {"update_exclusion": False}}


def _edge_state(**ppm_changes):
    """gmix_tpu's meta and short-term state of the tiny PPM spec whose rows
    at the contexts' indices are `edge_inputs`' corners, one stream each, as
    numpy arrays; and the completed bytes."""
    meta = j_build_meta(_spec(g, **ppm_changes))
    sp = meta.spec.ppm
    n = len(EDGE_STREAMS)
    ctx = np.random.default_rng(8).integers(0, 2**32, (n, meta.n_ctx), dtype=np.uint64).astype(np.uint32)
    cv = ctx[:, meta.ppm_slots].astype(np.int64)
    edge = edge_inputs(cv, sp.see_buckets, sp.inc, sp.rescale_total)
    h = (cv & meta.ppm_masks[None, :].astype(np.int64)) + meta.ppm_row_offsets[None, :]
    tbl = np.zeros((n, meta.ppm_total_rows, PPM_ROW_W), np.uint16)
    for s in range(n):
        tbl[s, h[s]] = edge["raw"][s]
    stm = {"bits_seen": np.zeros((n,), np.uint32), "ctx": ctx, "ppm_tbl": tbl, "ppm_see": edge["see"]}
    return meta, stm, edge["completed"].astype(np.uint32), h


@pytest.mark.parametrize("variant", list(EXCLUSIONS))
def test_ppm_update_at_the_kernel_edges_matches_eager_gmix_tpu(variant):
    """The count update at each corner, bitwise: the top order's total after
    the increment at rescale_total (kept) and one above (halved), a count of
    65535 that gains the increment, rows of other contexts reclaimed, every
    symbol excluded, denormal and signed-zero escape offsets, empty rows,
    rows of 65535 in every lane."""
    changes = EXCLUSIONS[variant]
    meta, stm_np, completed, h = _edge_state(**changes)
    sp = meta.spec.ppm
    with jax.disable_jit():
        want = j_step._ppm_update(_j(stm_np), jnp.asarray(completed), meta)
    plan, stm = _port(stm_np, streams=len(EDGE_STREAMS), **changes)
    t_ppm._ppm_update(stm, torch.tensor(completed.astype(np.int64)), plan)
    got = state_to_numpy({"ppm_tbl": stm["ppm_tbl"], "ppm_see": stm["ppm_see"]})
    _same(got["ppm_tbl"], want["ppm_tbl"], "ppm_tbl")
    _same(got["ppm_see"], want["ppm_see"], "ppm_see")

    def row(name, i):
        return got["ppm_tbl"][EDGE[name], h[EDGE[name], i]]

    assert int(row("total-at-rescale", -1)[:256].sum()) == sp.rescale_total
    assert int(row("total-past-rescale", -1)[:256].sum()) < sp.rescale_total // 2 + 256
    assert list(row("lane-at-u16-max", -1)[[40, 41]]) == [(U16_MAX + sp.inc + 1) // 2, (U16_MAX + 1) // 2]
    s = EDGE["tags-reclaimed"]
    assert int(row("tags-reclaimed", -1)[PPM_TAG_LANE]) == int(stm_np["ctx"][s, meta.ppm_slots[-1]]) >> 24
    assert (row("all-at-u16-max", -1)[:256] >= (U16_MAX + 1) // 2).all()
    # the learned offsets never hold a denormal
    assert not ((got["ppm_see"] != 0) & (np.abs(got["ppm_see"]) < np.finfo(np.float32).tiny)).any()


@pytest.mark.parametrize("exclusion", [True, False])
def test_ppm_predict_at_the_kernel_edges_matches_eager_gmix_tpu(exclusion):
    """The prediction at each corner, bitwise: with every symbol excluded,
    order -1 falls back to 1/256 for all; with every row empty, the whole
    mass is order -1's."""
    meta, stm_np, _, _ = _edge_state(exclusion=exclusion)
    with jax.disable_jit():
        want = j_step._ppm_predict(_j(stm_np), meta)
    plan, stm = _port(stm_np, streams=len(EDGE_STREAMS), exclusion=exclusion)
    cv, h = t_ppm._ppm_index(stm["ctx"], plan)
    t_ppm._ppm_predict(stm, gather_rows(stm["ppm_tbl"], h), cv, plan)
    for k in ("ppm_probs", "ppm_top", "ppm_bot"):
        _same(stm[k].numpy(), want[k], k)
    p = stm["ppm_probs"].numpy()
    assert (p[EDGE["all-empty"]] == np.float32(1 / 256)).all()
    assert (p[EDGE["all-excluded"]] > 0).all()
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("rows", ["all-at-u16-max", "random", "sparse"])
def test_integer_row_sums_equal_the_float_tree(rows):
    """The kernels take a row's total as an integer sum converted to float,
    where the plain version sums a fixed float tree (`_tree_sum`). Counts are
    u16 and a row has 256 lanes, so a total reaches 256 x 65535 = 16 776 960
    and no more, below 2^24: every partial sum is an exact float and the two
    agree bit for bit, as does total + distinct."""
    rng = np.random.default_rng(3)
    x = {"all-at-u16-max": np.full((2, 9, 256), U16_MAX),
         "random": rng.integers(0, U16_MAX + 1, (64, 9, 256)),
         "sparse": rng.integers(0, U16_MAX + 1, (64, 9, 256)) * (rng.random((64, 9, 256)) < 0.05)}[rows]
    ints = torch.tensor(x, dtype=torch.int64).sum(dim=2)
    tree = _tree_sum(torch.tensor(x, dtype=torch.float32))
    assert int(ints.max()) <= 256 * U16_MAX < 2**24
    assert torch.equal(ints.to(torch.float32), tree)
    distinct = torch.tensor((x > 0).sum(axis=2), dtype=torch.float32)
    assert torch.equal((ints + distinct.to(torch.int64)).to(torch.float32), tree + distinct)
    if rows == "all-at-u16-max":
        assert int(ints.max()) == 16_776_960
