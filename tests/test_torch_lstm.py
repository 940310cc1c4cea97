"""The port's LSTM byte model (core/lstm.py) against gmix_tpu's, run eagerly,
function by function on the same seeded states.

What has no inexact reduction must agree bit for bit: the per-byte SGD of
the output layer, and the whole backward pass with Adam once its reductions
are made exact (one nonzero term each). The forward and backward passes sum
in a fixed tree where gmix_tpu leaves the order to XLA, so their float leaves
agree within `RTOL` relative with an absolute floor of `ATOL`; integer
leaves (the symbol history, the epoch, the `lstm_ctx` context) are exact.
The worst |got - want| / (ATOL + RTOL * |want|) seen over these cases is
0.214 (forward), 0.027 (backward pass and Adam), 0.016 (both orders).

The plain versions of the per-byte work (`lstm_forward_plain`,
`lstm_perceive_plain`), which csrc/lstm.cu's kernels equal bit for bit on
the card, are held here on the states the kernels are tested on
(`utils/lstm_inputs.py`), with the same tolerance; the kernels' limits
against csrc/lstm.cu's (their argument structures and their refusal of CPU
tensors are tests/test_torch_kernel_table.py's).
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gmix_tpu.config as j_cfg
import gmix_tpu_torch.config as t_cfg
from gmix_tpu.core import step as j_step
from gmix_tpu.core.meta import build_meta as j_build_meta
from gmix_tpu.state import init_state as j_init_state
from gmix_tpu_torch.core import lstm as t_lstm
from gmix_tpu_torch.core.meta import build_meta as t_build_meta
from gmix_tpu_torch.state import state_from_numpy, state_to_numpy
from gmix_tpu_torch.utils import lstm_inputs

torch.set_num_threads(1)

S = 2
HZ = 10
RTOL, ATOL = 1e-5, 1e-6


def _spec(cfg, cells):
    return dataclasses.replace(cfg.tiny_spec(True), lstm=cfg.LstmSpec(num_cells=cells, horizon=HZ, update_limit=30))


def _softmax(x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)


def _state(cells, warm, epoch, seed=11):
    """gmix_tpu's fresh state as numpy arrays; `warm` fills every LSTM leaf,
    the aux input and the last byte with seeded values of the size a running
    model holds."""
    tree = jax.device_get(j_init_state(j_build_meta(_spec(j_cfg, cells)), S))
    tree = jax.tree_util.tree_map(np.array, tree)
    lst, lw, stm = tree["stm"]["lstm"], tree["ltm"]["lstm"], tree["stm"]
    lst["epoch"] = np.array(epoch, np.int32)
    if not warm:
        return tree
    rng = np.random.default_rng(seed)

    def normal(a, scale, shift=0.0):
        return (shift + scale * rng.standard_normal(a.shape)).astype(np.float32)

    def unit(a, lo, hi):
        return rng.uniform(lo, hi, a.shape).astype(np.float32)

    for k in ("w_sym", "w_in"):
        lw[k] = lw[k] + normal(lw[k], 0.05)
    for k in ("sym_m", "in_m", "gamma_m", "beta_m"):
        lw[k] = normal(lw[k], 1e-2)
    for k in ("sym_v", "in_v", "gamma_v", "beta_v"):
        lw[k] = np.abs(normal(lw[k], 1e-4))
    lw["gamma"], lw["beta"] = normal(lw["gamma"], 0.1, 1.0), normal(lw["beta"], 0.1)
    lw["out_w"] = normal(lw["out_w"], 0.05)
    lst["cell"], lst["last_state"] = normal(lst["cell"], 0.5), normal(lst["last_state"], 0.5)
    lst["hidden"][:, :cells] = unit(lst["hidden"][:, :cells], -1, 1)
    lst["state_err"], lst["stored_err"] = normal(lst["state_err"], 0.1), normal(lst["stored_err"], 0.1)
    lst["old_input"] = rng.integers(0, 256, (S,)).astype(np.int32)
    lst["in_hist"] = rng.integers(0, 256, (S, HZ)).astype(np.int32)
    lst["norm"], lst["ivar"] = normal(lst["norm"], 1.0), unit(lst["ivar"], 0.5, 2.0)
    lst["gate_state"] = unit(lst["gate_state"], 0, 1)
    lst["gate_state"][:, 1] = unit(lst["gate_state"][:, 1], -1, 1)
    lst["tanh_state"] = unit(lst["tanh_state"], -1, 1)
    lst["in_gate"] = np.float32(1.0) - lst["gate_state"][:, 0]
    lst["outputs"] = _softmax(3 * rng.standard_normal(lst["outputs"].shape))
    lst["probs"] = lst["outputs"][:, 0].copy()
    lst["layer_input"][:, :, :256] = _softmax(3 * rng.standard_normal((S, HZ, 256)))
    lst["layer_input"][:, :, 256 : 256 + cells] = unit(lst["layer_input"][:, :, 256 : 256 + cells], -1, 1)
    lst["update_steps"] = np.array(7, np.int32)
    stm["ppm_probs"] = _softmax(3 * rng.standard_normal((S, 256)))
    stm["last_byte"] = rng.integers(0, 256, (S,)).astype(np.uint32)
    return tree


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _compare(want_tree, got_tree, exact: bool, same_zero_sign: bool = True):
    """Every leaf of `got_tree` against `want_tree`: shapes and dtypes, the
    integers exactly, the floats bit for bit (`exact`; `same_zero_sign=False`
    lets -0 equal +0) or within the tolerance. Returns the worst ratio."""
    want, got = dict(_flat(want_tree)), dict(_flat(got_tree))
    assert sorted(got) == sorted(want)
    worst = 0.0
    for k, a in want.items():
        b = np.ascontiguousarray(got[k]).reshape(got[k].shape)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), k
        if a.dtype != np.float32 or (exact and same_zero_sign):
            assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)), k
        elif exact:
            assert np.array_equal(a, b), k
        else:
            ratio = float((np.abs(a - b) / (ATOL + RTOL * np.abs(a))).max())
            assert ratio <= 1.0, f"{k}: {ratio:.3f} times the tolerance"
            worst = max(worst, ratio)
    return worst


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _plan(cells):
    return t_lstm.LstmPlan(_spec(t_cfg, cells).lstm, S, "cpu")


@pytest.mark.parametrize("warm", (True, False), ids=("warm", "fresh"))
@pytest.mark.parametrize("cells", (16, 50))
def test_forward_matches_eager_gmix_tpu(cells, warm):
    """Mid-window and at the last epoch (the epoch leaf wraps to 0)."""
    meta = j_build_meta(_spec(j_cfg, cells))
    slot = int(meta.slots["lstm_ctx"])
    for epoch in (3, HZ - 1):
        tree = _state(cells, warm, epoch)
        with jax.disable_jit():
            j_stm, j_ltm = j_step._lstm_forward(_jax_tree(tree["stm"]), _jax_tree(tree["ltm"]), meta)
        st = state_from_numpy(tree)
        t_lstm._lstm_forward(st["stm"], st["ltm"], _plan(cells), slot)
        got = state_to_numpy(st)
        _compare(jax.device_get({"stm": j_stm, "ltm": j_ltm}), {"stm": got["stm"], "ltm": got["ltm"]}, exact=False)
        assert int(got["stm"]["lstm"]["epoch"]) == (epoch + 1) % HZ
        probs = got["stm"]["lstm"]["probs"]
        assert np.array_equal(got["stm"]["ctx"][:, slot], probs.argmax(axis=1).astype(np.uint32))


@pytest.mark.parametrize("cells", (16, 50))
def test_perceive_without_bptt_is_bitwise(cells):
    """The symbol history, `old_input` at the window's wrap and the output
    layer's SGD step have no reduction: every leaf bit for bit, mid-window
    and at the wrap with the backward pass left to the caller ("defer")."""
    meta = j_build_meta(_spec(j_cfg, cells))
    inp = np.array([65, 200], np.uint32)
    for e_cur in (4, 0):
        tree = _state(cells, True, e_cur)
        with jax.disable_jit():
            j_stm, j_ltm = j_step._lstm_perceive(
                _jax_tree(tree["stm"]), _jax_tree(tree["ltm"]), jnp.asarray(inp.astype(np.int32)), meta, "defer")
        st = state_from_numpy(tree)
        t_lstm._lstm_perceive(st["stm"], st["ltm"], torch.tensor(inp.astype(np.int64)), _plan(cells), e_cur == 0,
                              bptt=False)
        got = state_to_numpy(st)
        _compare(jax.device_get({"stm": j_stm, "ltm": j_ltm}), {"stm": got["stm"], "ltm": got["ltm"]}, exact=True)
        last_e = (e_cur - 1) % HZ
        assert not np.array_equal(got["ltm"]["lstm"]["out_w"][:, e_cur], tree["ltm"]["lstm"]["out_w"][:, last_e])


def _bptt_both(tree, cells):
    meta = j_build_meta(_spec(j_cfg, cells))
    with jax.disable_jit():
        j_lst, j_lw = j_step._lstm_bptt(_jax_tree(tree["stm"]["lstm"]), _jax_tree(tree["ltm"]["lstm"]), meta)
    st = state_from_numpy(tree)
    t_lstm._lstm_bptt(st["stm"]["lstm"], st["ltm"]["lstm"], _plan(cells))
    got = state_to_numpy(st)
    return jax.device_get({"lst": j_lst, "lw": j_lw}), {"lst": got["stm"]["lstm"], "lw": got["ltm"]["lstm"]}


@pytest.mark.parametrize("warm", (True, False), ids=("warm", "fresh"))
@pytest.mark.parametrize("cells", (16, 50))
def test_bptt_matches_eager_gmix_tpu(cells, warm):
    tree = _state(cells, warm, 0)
    want, got = _bptt_both(tree, cells)
    _compare(want, got, exact=False)
    assert int(got["lst"]["update_steps"]) == (8 if warm else 1)
    if warm:
        assert not np.array_equal(got["lw"]["w_in"], tree["ltm"]["lstm"]["w_in"])


@pytest.mark.parametrize("cells", (16, 50))
def test_bptt_with_exact_reductions_is_bitwise(cells):
    """With one nonzero term in each of the backward pass's three sums (one
    output weight per cell and epoch, one normalised cell per gate and
    epoch, one hidden weight per hidden lane) every order of summation gives
    the same gradients, and everything after them (the carried errors, the
    gradient accumulation in epoch order, Adam's moments and steps, given
    the same gradients) must be the same bits; a zero may differ in sign,
    which a sum of zeros does not define."""
    tree = _state(cells, True, 0)
    rng = np.random.default_rng(5)
    lst, lw = tree["stm"]["lstm"], tree["ltm"]["lstm"]

    def keep_one(a, axis):
        """Zero all but one seeded position along `axis`."""
        keep = rng.integers(0, a.shape[axis], a.shape[:axis] + a.shape[axis + 1 :])
        mask = np.expand_dims(keep, axis) == np.arange(a.shape[axis]).reshape((-1,) + (1,) * (a.ndim - axis - 1))
        return np.where(mask, a, np.float32(0.0))

    lw["out_w"][:, :, :cells] = keep_one(lw["out_w"][:, :, :cells], 3)
    lst["norm"] = keep_one(lst["norm"], 3)
    w_hid = lw["w_in"][:, :, :, 256 : 256 + cells]  # (S, 3, C, C): one (gate, cell) per hidden lane
    lw["w_in"][:, :, :, 256 : 256 + cells] = keep_one(w_hid.reshape(S, 3 * cells, cells), 1).reshape(w_hid.shape)
    want, got = _bptt_both(tree, cells)
    _compare(want, got, exact=True, same_zero_sign=False)
    for k in ("w_sym", "w_in", "gamma", "beta", "sym_v", "in_m"):
        assert not np.array_equal(got["lw"][k], lw[k]), k


def test_both_bptt_orders_match_gmix_tpu_and_differ():
    """At the byte that wraps the window gmix_tpu runs the backward pass
    either inside the byte end, before the output layer's SGD ("cond"), or
    after it, at the end of the segment ("defer"). The backward pass reads
    every epoch's output weights and the SGD writes slot 0, so the two orders
    give different gate weights, in gmix_tpu and in the port alike; each order
    of the port is held to the same order of gmix_tpu."""
    cells = 16
    meta = j_build_meta(_spec(j_cfg, cells))
    tree = _state(cells, True, 0)
    inp = np.array([65, 200], np.uint32)
    j_inp, t_inp = jnp.asarray(inp.astype(np.int32)), torch.tensor(inp.astype(np.int64))
    lp = _plan(cells)
    results = {}
    for mode in ("cond", "defer"):
        with jax.disable_jit():
            j_stm, j_ltm = j_step._lstm_perceive(_jax_tree(tree["stm"]), _jax_tree(tree["ltm"]), j_inp, meta, mode)
            if mode == "defer":
                j_lst, j_lw = j_step._lstm_bptt(j_stm["lstm"], j_ltm["lstm"], meta)
                j_stm, j_ltm = dict(j_stm, lstm=j_lst), dict(j_ltm, lstm=j_lw)
        st = state_from_numpy(tree)
        t_lstm._lstm_perceive(st["stm"], st["ltm"], t_inp, lp, True, bptt=mode == "cond")
        if mode == "defer":
            t_lstm._lstm_bptt(st["stm"]["lstm"], st["ltm"]["lstm"], lp)
        got = state_to_numpy(st)
        want = jax.device_get({"stm": j_stm, "ltm": j_ltm})
        _compare(want, {"stm": got["stm"], "ltm": got["ltm"]}, exact=False)
        results[mode] = (want["ltm"]["lstm"]["w_in"], got["ltm"]["lstm"]["w_in"])
    # the same SGD step either way; different gate weights
    for pkg in (0, 1):
        a, b = results["cond"][pkg], results["defer"][pkg]
        assert np.abs(a - b).max() > 100 * (ATOL + RTOL * np.abs(a).max())


def test_tree_sum_dim_is_the_fixed_tree():
    """Any axis, any length: the halves-added tree of `fused._tree_sum`, and
    the plain sum where that is exact."""
    from gmix_tpu_torch.core.fused import _tree_sum

    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((3, 51, 7, 19)).astype(np.float32))
    for dim in range(4):
        want = _tree_sum(x.movedim(dim, -1).contiguous())
        assert torch.equal(t_lstm._tree_sum_dim(x, dim), want)
    ints = torch.tensor(rng.integers(-50, 50, (4, 307)).astype(np.float32))
    assert torch.equal(t_lstm._tree_sum_dim(ints, 1), ints.sum(dim=1))


# ---------------------------------------------------------------------------
# the plain versions on the kernels' states, and what the kernels are held to
# ---------------------------------------------------------------------------


def _kernel_sample(cells, kind, epoch):
    """(gmix_tpu's state tree with the sample's leaves, the sample) of
    `utils/lstm_inputs.py` at `epoch`: three seeded streams, or one stream
    per edge."""
    meta = t_build_meta(_spec(t_cfg, cells))
    if kind == "edge":
        sample = lstm_inputs.edge_state(meta, 17 + cells, epoch)
    else:
        sample = lstm_inputs.random_state(meta, 3, 29 + cells + epoch, epoch)
    n = len(sample["stm"]["acc"])
    tree = jax.tree_util.tree_map(np.array, jax.device_get(j_init_state(j_build_meta(_spec(j_cfg, cells)), n)))

    def overlay(dst, src):
        for k, v in src.items():
            if isinstance(v, dict):
                overlay(dst[k], v)
            else:
                assert (dst[k].shape, dst[k].dtype) == (v.shape, v.dtype), k
                dst[k] = v.copy()

    overlay(tree, sample)
    return tree, sample


def _port_plan(cells, n):
    return t_lstm.LstmPlan(_spec(t_cfg, cells).lstm, n, "cpu")


@pytest.mark.parametrize("epoch", (0, HZ - 1), ids=("epoch0", "last-epoch"))
@pytest.mark.parametrize("kind", ("random", "edge"))
@pytest.mark.parametrize("cells", (16, 50))
def test_plain_forward_on_the_kernel_states_matches_eager_gmix_tpu(cells, kind, epoch):
    """`lstm_forward_plain` on the kernels' seeded and edge states against
    gmix_tpu's forward pass, within the tolerance; at the last epoch the
    epoch leaf wraps to 0. On the tied stream the argmax is the plain
    version's alone (the first of the two maxima), since gmix_tpu's
    probabilities differ from the port's in the last bits."""
    meta = j_build_meta(_spec(j_cfg, cells))
    slot = int(meta.slots["lstm_ctx"])
    tree, sample = _kernel_sample(cells, kind, epoch)
    n = len(sample["stm"]["acc"])
    with jax.disable_jit():
        j_stm, j_ltm = j_step._lstm_forward(_jax_tree(tree["stm"]), _jax_tree(tree["ltm"]), meta)
    want = jax.device_get({"stm": j_stm, "ltm": j_ltm})
    st = state_from_numpy(tree)
    regs = t_lstm.lstm_forward_plain(st["stm"], st["ltm"], _port_plan(cells, n), slot)
    got = state_to_numpy(st)
    got = {"stm": got["stm"], "ltm": got["ltm"]}
    if kind == "edge":
        tie = lstm_inputs.EDGE_STREAMS.index("argmax-tie")
        probs = got["stm"]["lstm"]["probs"][tie]
        a, b = lstm_inputs.TIE
        assert probs[a] == probs[b] == probs.max()
        assert int(got["stm"]["ctx"][tie, slot]) == a
        got["stm"]["ctx"][tie, slot] = want["stm"]["ctx"][tie, slot]
        flat = lstm_inputs.EDGE_STREAMS.index("logits-negative")
        assert (got["stm"]["lstm"]["probs"][flat] == got["stm"]["lstm"]["probs"][flat, 0]).all()
        assert int(got["stm"]["ctx"][flat, slot]) == 0
    _compare(want, got, exact=False)
    assert int(got["stm"]["lstm"]["epoch"]) == (epoch + 1) % HZ
    assert regs.dtype == torch.int32 and regs.shape == (n, 4)
    assert torch.equal(regs[:, 2], st["stm"]["lstm"]["mid"]) and (regs[:, 0] == 255).all() and (regs[:, 1] == 0).all()


@pytest.mark.parametrize("kind", ("random", "edge"))
@pytest.mark.parametrize("cells", (16, 50))
def test_plain_perceive_on_the_kernel_states_is_bitwise(cells, kind):
    """`lstm_perceive_plain` on the kernels' states (bytes 0 and 255 at the
    edges) against gmix_tpu's byte end, every leaf bit for bit, mid-window
    and at the wrap with the backward pass left to the caller."""
    meta = j_build_meta(_spec(j_cfg, cells))
    for e_cur in (HZ - 1, 0):
        tree, sample = _kernel_sample(cells, kind, e_cur)
        inp = sample["stm"]["acc"]
        with jax.disable_jit():
            j_stm, j_ltm = j_step._lstm_perceive(
                _jax_tree(tree["stm"]), _jax_tree(tree["ltm"]), jnp.asarray(inp.astype(np.int32)), meta, "defer")
        st = state_from_numpy(tree)
        t_lstm.lstm_perceive_plain(st["stm"], st["ltm"], torch.tensor(inp.astype(np.int64)), _port_plan(cells, len(inp)),
                                   e_cur == 0, bptt=False)
        got = state_to_numpy(st)
        _compare(jax.device_get({"stm": j_stm, "ltm": j_ltm}), {"stm": got["stm"], "ltm": got["ltm"]}, exact=True)


def test_padded_tree_adds_its_zeros():
    """The rule the kernels keep: `_tree_sum_dim` pads the axis with +0.0
    and adds the padding. A row of -0.0 products (the edge state
    negative-zero-products) sums to +0.0 over a padded axis (307 lanes: the
    layer input at 50 cells), and to -0.0 over an axis that needs no
    padding; skipping the padding would leave -0.0 and change the bits of
    the layer norm's record."""
    neg = torch.full((2, 307), -0.0)
    assert torch.equal(t_lstm._tree_sum_dim(neg, 1).view(torch.int32), torch.zeros(2, dtype=torch.int32))
    unpadded = t_lstm._tree_sum_dim(neg[:, :256], 1)
    assert torch.equal(unpadded.view(torch.int32), torch.full((2,), -(2**31), dtype=torch.int32))
    # the same row through the plain forward pass: every gate value +0.0
    meta = t_build_meta(_spec(t_cfg, 50))
    sample = lstm_inputs.edge_state(meta, 3, 4)
    s = lstm_inputs.EDGE_STREAMS.index("negative-zero-products")
    stm, ltm = lstm_inputs.to_state(sample, "cpu", [s])
    lst = ltm["lstm"]
    li = torch.cat([stm["ppm_probs"], stm["lstm"]["hidden"][:, :50], torch.ones((1, 1))], dim=1)
    prods = lst["w_in"] * li[:, None, None, :]
    assert (prods == 0).all() and torch.signbit(prods).all()
    f = lst["w_sym"][0, :, :, int(stm["last_byte"][0])] + t_lstm._tree_sum_dim(prods, 3)[0]
    assert not torch.signbit(f).any()


def test_lstm_kernel_limits_are_the_c_constants():
    """The wrappers' limits are csrc/lstm.cu's, and the cluster size they
    choose fills the H100's 132 SMs at the benchmark's stream counts while
    its blocks' rows of w_in fit shared memory."""
    src = (Path(t_lstm.__file__).parents[1] / "csrc" / "lstm.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]*);", src).group(1))

    assert (const("kMaxInput"), const("kMaxHidden"), const("kMaxOut"), const("kMaxDynamicSmem"),
            const("kMaxCluster")) == (t_lstm.MAX_INPUT, t_lstm.MAX_HIDDEN, t_lstm.MAX_OUT, t_lstm.MAX_DYNAMIC_SMEM,
                                      t_lstm.MAX_CLUSTER)
    ls = t_cfg.LstmSpec()
    # one block a stream would need 184 KB of w_in and 52 KB of out_w
    assert t_lstm.forward_smem(ls, 1) > t_lstm.MAX_DYNAMIC_SMEM >= t_lstm.forward_smem(ls, 2)
    assert [t_lstm.forward_cluster(S, ls, 132) for S in (1, 16, 30, 54, 66, 67, 256)] == [8, 8, 4, 2, 2, 2, 2]
    wide = dataclasses.replace(ls, num_cells=63, input_size=448)  # 189 rows of 512 floats: 387 KB
    assert t_lstm.forward_cluster(256, wide, 132) == 4
    tiny = t_cfg.tiny_spec(True).lstm
    assert [t_lstm.forward_cluster(S, tiny, 132) for S in (1, 100)] == [8, 1]
