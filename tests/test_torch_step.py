"""The port's byte step against gmix_tpu's, run eagerly, from a warm state.

gmix_tpu's jitted programs let XLA:CPU contract a*b+c into one fused
multiply-add, so they round differently from a program whose ops round one
by one. The port keeps every op separate, as gmix_tpu does when run under
`jax.disable_jit()`, and is held bitwise against that.

With an LSTM the port sums in fixed trees where gmix_tpu leaves the order to
XLA (tests/test_torch_lstm.py), so what the LSTM's output reaches (its own
leaves, the mixer weights, the APM rows, the metrics) is held within a
relative tolerance of 1e-5 with an absolute floor of 1e-6 (worst seen: 0.27
of it over 12 bytes), and everything else, every integer included, bit for
bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gmix_tpu as g
from gmix_tpu.core import step as j_step
from gmix_tpu.core.codec import Predictor as JPredictor
from gmix_tpu.core.codec import _pad_streams, run_chunks as j_run_chunks
import gmix_tpu_torch as gt
from gmix_tpu_torch.core import step as t_step
from gmix_tpu_torch.core.codec import Predictor as TPredictor
from gmix_tpu_torch.state import state_from_numpy, state_to_numpy

torch.set_num_threads(1)

S = 2
WARM = 160
CHUNK = 40
# with the LSTM (horizon 10): warm up to two bytes before the window wraps, in
# chunks the horizon does not divide (the backward pass inside the byte)
WARM_LSTM = 168
CHUNK_LSTM = 8
# float leaves that the LSTM's prediction reaches within a byte step
LSTM_REACH = ("stm.lstm.", "ltm.lstm.", "ltm.mix_w", "ltm.mix_pos", "ltm.mix_dense", "ltm.apm", "metrics.")
RTOL, ATOL = 1e-5, 1e-6


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _ppm_spec(pkg):
    """The tiny spec with its PPM byte model and rolling context, without the
    LSTM."""
    return dataclasses.replace(pkg.tiny_spec(True), lstm=None)


def _warm(spec, warm=WARM, chunk=CHUNK):
    """gmix_tpu's state after `warm` bytes of corpus_100k, coded by its jitted
    chunk program, and the padded input."""
    with open("data/corpus_100k.bin", "rb") as f:
        data = f.read(S * (warm + chunk))
    arr, _ = _pad_streams(data, S, chunk)
    jp = JPredictor(spec, S)
    j_run_chunks(jp, jnp.asarray(arr), jnp.zeros((S, 64), jnp.uint8), warm, decode=False, chunk=chunk)
    return jp.meta, jax.device_get(jp.state), arr


@pytest.fixture(scope="module")
def warm():
    return _warm(g.tiny_spec(False))


@pytest.fixture(scope="module")
def warm_ppm():
    return _warm(_ppm_spec(g))


@pytest.fixture(scope="module")
def warm_lstm():
    return _warm(g.tiny_spec(True), WARM_LSTM, CHUNK_LSTM)


def test_byte_steps_match_eager_gmix_tpu(warm):
    _check_byte_steps(warm, gt.tiny_spec(False), (WARM, WARM + 1, WARM + 2))


def test_ppm_byte_steps_match_eager_gmix_tpu(warm_ppm):
    """With the PPM byte model: its count update, rolling-hash context,
    prediction and bit head, every state leaf (`ppm_tbl`, `ppm_see`,
    `ppm_probs`, the interval registers, `roll_h`) bitwise."""
    _check_byte_steps(warm_ppm, _ppm_spec(gt), (WARM, WARM + 1, WARM + 2))


def test_ppm_first_byte_matches_eager_gmix_tpu():
    """t == 0: the count update still runs (on the zero contexts); the
    rolling hash and the recent ring stay."""
    spec = _ppm_spec(g)
    jp = JPredictor(spec, S)
    with open("data/corpus_100k.bin", "rb") as f:
        arr, _ = _pad_streams(f.read(S * CHUNK), S, CHUNK)
    _check_byte_steps((jp.meta, jax.device_get(jp.state), arr), _ppm_spec(gt), (0, 1, 2))


def test_lstm_byte_steps_match_eager_gmix_tpu(warm_lstm):
    """With PPM and the LSTM: a mid-window byte, the byte that wraps the
    horizon window (backward pass and Adam inside the byte end, then the
    output layer's SGD into slot 0), and a decode step after it."""
    _, state_np, _ = warm_lstm
    assert int(state_np["stm"]["lstm"]["epoch"]) == WARM_LSTM % 10 and int(state_np["stm"]["lstm"]["update_steps"]) == 16
    tp = _check_byte_steps(warm_lstm, gt.tiny_spec(True), (WARM_LSTM, WARM_LSTM + 1, WARM_LSTM + 2), LSTM_REACH)
    lst = tp.state["stm"]["lstm"]
    assert int(lst["update_steps"]) == 17 and int(lst["epoch"]) == 1


def _check_byte_steps(warm, t_spec, ts, reach=("metrics.",)):
    meta, state_np, arr = warm
    j_state = jax.tree_util.tree_map(jnp.asarray, state_np)
    j_data = jnp.asarray(arr)
    tp = TPredictor(t_spec, S, device="cpu")
    tp.state = state_from_numpy(state_np)
    t_data = torch.tensor(arr)
    code = np.random.default_rng(3).integers(0, 256, (S, 512), dtype=np.uint8)
    # two bytes in encode mode, then one in decode mode on arbitrary code bytes
    for t, decode in zip(ts, (False, False, True)):
        code_buf = code if decode else np.zeros_like(code)
        with jax.disable_jit():
            stm, ltm, coder, metrics, j_data, _, j_win, j_nw = j_step._byte_step(
                j_state["stm"], j_state["ltm"], j_state["coder"], j_state["metrics"], j_data,
                jnp.asarray(code_buf), j_step._code_words(jnp.asarray(code_buf)), jnp.int32(t),
                jnp.asarray(decode), meta, True, "cond", bit_scan=False, analysis=True,
            )
        j_state = {"stm": stm, "ltm": ltm, "coder": coder, "metrics": metrics}
        t_win, t_nw = t_step._byte_step(tp.state, t_data, torch.tensor(code_buf), t, decode, tp.plan)

        want = dict(_flat(jax.device_get(j_state)))
        got = dict(_flat(state_to_numpy(tp.state)))
        assert sorted(got) == sorted(want)
        for k in want:
            a = want[k]
            b = np.ascontiguousarray(got[k]).reshape(a.shape)  # register leaves are columns of a packed output
            assert (a.shape, a.dtype) == (b.shape, b.dtype), k
            if a.dtype == np.float32 and k.startswith(reach) and len(reach) > 1:
                assert (np.abs(a - b) <= ATOL + RTOL * np.abs(a)).all(), f"byte {t}: {k} outside the tolerance"
            elif k.startswith("metrics."):
                # the entropy metrics go through jnp.log2, XLA's own log
                # approximation (its vector path differs with the host's
                # ISA); they never reach an archive
                np.testing.assert_array_max_ulp(b, a, maxulp=2)
            else:
                assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)), f"byte {t}: {k} differs"
        np.testing.assert_array_equal(t_win.numpy(), np.asarray(j_win))
        np.testing.assert_array_equal(t_nw.numpy(), np.asarray(j_nw))
        np.testing.assert_array_equal(t_data.numpy(), np.asarray(j_data))
    return tp


def test_byte_step_gathers_every_arena_in_one_call(warm, monkeypatch):
    """The byte step computes all row indices first and hands the four arenas
    (indirect blocks, stable and position-gated mixer rows, APM rows) to one
    grouped gather, whose rows are gmix_tpu's gathers of the same indices."""
    from gmix_tpu.ops import rowmove as j_rm

    _, state_np, arr = warm
    tp = TPredictor(gt.tiny_spec(False), S, device="cpu")
    tp.state = state_from_numpy(state_np)
    calls = []
    real = t_step.gather_rows_many

    def spy(pairs):
        outs = real(pairs)
        calls.append((pairs, outs))
        return outs

    monkeypatch.setattr(t_step, "gather_rows_many", spy)
    code = torch.zeros((S, 64), dtype=torch.uint8)
    _, work, ix = t_step._byte_inputs(tp.state, torch.tensor(arr), code, WARM, False, tp.plan)
    assert len(calls) == 1
    pairs, outs = calls[0]
    ltm = tp.state["ltm"]
    assert [t.data_ptr() for t, _ in pairs] == [
        ltm["ind"]["st"].data_ptr(), ltm["mix_w"].data_ptr(), ltm["mix_pos"].data_ptr(), ltm["apm"].data_ptr()]
    assert [i.data_ptr() for _, i in pairs] == [ix[n].data_ptr() for n in ("blk_ix", "rowix_st", "posix", "apm_ix")]
    for name, (tbl, idx), out in zip(("ind_blk", "rows_st", "rows_pos", "apm_rows"), pairs, outs):
        want = np.asarray(j_rm.gather_rows(jnp.asarray(tbl.numpy()), jnp.asarray(idx.numpy())))
        assert np.array_equal(out.numpy().view(np.uint8), want.view(np.uint8)), name
        assert work[name].data_ptr() == out.data_ptr(), name


def test_ppm_byte_step_groups_its_row_moves(warm_ppm, monkeypatch):
    """With PPM a byte step makes one grouped gather of five arenas (`ppm_tbl`
    the fifth) and one grouped scatter of four; the count update before them
    gathers and scatters its own `ppm_tbl` rows, a group of one each way, and
    the scattered rows are gmix_tpu's scatters of the same indices."""
    from gmix_tpu.ops import rowmove as j_rm
    from gmix_tpu_torch.core import ppm as t_ppm

    _, state_np, arr = warm_ppm
    tp = TPredictor(_ppm_spec(gt), S, device="cpu")
    tp.state = state_from_numpy(state_np)
    stm, ltm = tp.state["stm"], tp.state["ltm"]
    calls = []

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapped(*args):
            before = [t.clone() for t, *_ in args[0]] if name == "scatter_rows_many" else None
            out = real(*args)
            calls.append((name, args, before))
            return out

        monkeypatch.setattr(mod, name, wrapped)

    spy(t_ppm, "gather_rows")
    spy(t_ppm, "scatter_rows")
    spy(t_step, "gather_rows_many")
    spy(t_step, "scatter_rows_many")
    code = torch.zeros((S, 64), dtype=torch.uint8)
    t_step._byte_step(tp.state, torch.tensor(arr), code, WARM, False, tp.plan)
    assert [c[0] for c in calls] == ["gather_rows", "scatter_rows", "gather_rows_many", "scatter_rows_many"]
    assert calls[0][1][0] is stm["ppm_tbl"] and calls[1][1][0] is stm["ppm_tbl"]
    assert torch.equal(calls[0][1][1], calls[1][1][1])  # the update writes the rows it read
    five = [t.data_ptr() for t, _ in calls[2][1][0]]
    tables = [ltm["ind"]["st"], ltm["mix_w"], ltm["mix_pos"], ltm["apm"]]
    assert five == [t.data_ptr() for t in tables] + [stm["ppm_tbl"].data_ptr()]
    assert calls[2][1][0][4][0].shape[2] == 272
    _, (triples,), before = calls[3]
    assert [t.data_ptr() for t, _, _ in triples] == [t.data_ptr() for t in tables]
    for (tbl, idx, upd), old in zip(triples, before):
        want = np.asarray(j_rm.scatter_rows(jnp.asarray(old.numpy()), jnp.asarray(idx.numpy()), jnp.asarray(upd.numpy())))
        assert np.array_equal(tbl.numpy().view(np.uint8), want.view(np.uint8))


def test_lstm_byte_step_gathers_ppm_rows_before_the_forward_pass(warm_lstm, monkeypatch):
    """With PPM and an LSTM the forward pass reads the PPM prediction and
    sets the `lstm_ctx` context before any row index is taken: the count
    update's gather and scatter, the prediction's own gather of `ppm_tbl`
    rows, the forward pass, then one grouped gather of the four other arenas
    and one grouped scatter: 3 + 2 moves and the sub-steps, 6 launches."""
    from gmix_tpu_torch.core import ppm as t_ppm

    _, state_np, arr = warm_lstm
    tp = TPredictor(gt.tiny_spec(True), S, device="cpu")
    tp.state = state_from_numpy(state_np)
    stm, ltm = tp.state["stm"], tp.state["ltm"]
    calls = []

    def spy(mod, name, label):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *args: calls.append((label, args)) or real(*args))

    spy(t_ppm, "gather_rows", "update gather")
    spy(t_ppm, "scatter_rows", "update scatter")
    spy(t_step, "gather_rows", "predict gather")
    spy(t_step, "_lstm_forward", "forward")
    spy(t_step, "gather_rows_many", "grouped gather")
    spy(t_step, "fused_substeps", "sub-steps")
    spy(t_step, "scatter_rows_many", "grouped scatter")
    t_step._byte_step(tp.state, torch.tensor(arr), torch.zeros((S, 64), dtype=torch.uint8), WARM_LSTM, False, tp.plan)
    assert [c[0] for c in calls] == ["update gather", "update scatter", "predict gather", "forward", "grouped gather",
                                     "sub-steps", "grouped scatter"]
    assert all(calls[i][1][0] is stm["ppm_tbl"] for i in (0, 1, 2))
    tables = [ltm["ind"]["st"], ltm["mix_w"], ltm["mix_pos"], ltm["apm"]]
    assert [t.data_ptr() for t, _ in calls[4][1][0]] == [t.data_ptr() for t in tables]
    assert [t.data_ptr() for t, _, _ in calls[6][1][0]] == [t.data_ptr() for t in tables]


def test_lstm_epoch_is_kept_on_the_host(warm_lstm, monkeypatch):
    """The 0-d `epoch` leaf is read from the device once, when a state comes
    from outside; after that the byte step converts no tensor to a Python
    number, across the window's wrap and its backward pass, and the leaf
    still holds the epoch."""
    _, state_np, arr = warm_lstm
    tp = TPredictor(gt.tiny_spec(True), S, device="cpu")
    tp.state = state_from_numpy(state_np)
    data, code = torch.tensor(arr), torch.zeros((S, 64), dtype=torch.uint8)
    t_step._byte_step(tp.state, data, code, WARM_LSTM, False, tp.plan)

    def no_read(*a, **k):
        raise AssertionError("a tensor was read back to the host inside the byte step")

    with monkeypatch.context() as m:
        for name in ("item", "__int__", "__index__", "__float__", "__bool__", "tolist"):
            m.setattr(torch.Tensor, name, no_read)
        for t in range(WARM_LSTM + 1, WARM_LSTM + 4):
            t_step._byte_step(tp.state, data, code, t, False, tp.plan)
    lst = tp.state["stm"]["lstm"]
    assert lst["epoch"].shape == () and int(lst["epoch"]) == (WARM_LSTM + 4) % 10 and int(lst["update_steps"]) == 17
    # a state from outside: its epoch is taken over
    state_np["stm"]["lstm"]["epoch"] = np.array(7, np.int32)
    tp.state = state_from_numpy(state_np)
    t_step._byte_step(tp.state, data, code, WARM_LSTM, False, tp.plan)
    assert int(tp.state["stm"]["lstm"]["epoch"]) == 8


def test_byte_step_scatters_every_arena_in_one_call(warm, monkeypatch):
    """Without PPM: one grouped scatter of the four arenas at the byte end, no
    single-arena move anywhere in the step."""
    from gmix_tpu_torch.ops import rowmove as t_rm

    _, state_np, arr = warm
    tp = TPredictor(gt.tiny_spec(False), S, device="cpu")
    tp.state = state_from_numpy(state_np)
    calls = []
    real = t_step.scatter_rows_many
    monkeypatch.setattr(t_step, "scatter_rows_many", lambda triples: calls.append(len(triples)) or real(triples))
    for name in ("gather_rows", "scatter_rows"):
        monkeypatch.setattr(t_rm, name, lambda *a: pytest.fail("a single-arena move on the byte step"))
    t_step._byte_step(tp.state, torch.tensor(arr), torch.zeros((S, 64), dtype=torch.uint8), WARM, False, tp.plan)
    assert calls == [4]


@pytest.mark.parametrize("n", [6, 24])
def test_tri_solve_matches_eager_gmix_tpu(n):
    rng = np.random.default_rng(n)
    lmat = (rng.standard_normal((3, n, n)) * 0.3).astype(np.float32)
    d = rng.standard_normal((3, n)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(j_step._tri_solve(jnp.asarray(lmat), jnp.asarray(d)))
    got = t_step._tri_solve(torch.tensor(lmat), torch.tensor(d)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_unported_specs_raise():
    """No spec is left unported: specs with an LSTM (they raised
    NotImplementedError before it was ported) build and step, the scaled
    reference and best profiles among them."""
    code = torch.zeros((S, 64), dtype=torch.uint8)
    data = torch.tensor(np.frombuffer(b"ab" * S, np.uint8).reshape(S, 2).copy())
    for spec in (gt.tiny_spec(True), gt.scale_tables(gt.reference_spec(), 8, history_bits=10),
                 gt.scale_tables(gt.best_spec(), 8, history_bits=10)):
        tp = TPredictor(spec, S, device="cpu")
        for t in (0, 1):
            win, nw = t_step._byte_step(tp.state, data, code, t, False, tp.plan)
        lst = tp.state["stm"]["lstm"]
        assert int(lst["epoch"]) == 2 and torch.isfinite(lst["probs"]).all()
        assert win.shape == (S, 40) and nw.shape == (S,)
    assert "ppm_tbl" in TPredictor(_ppm_spec(gt), S, device="cpu").state["stm"]
