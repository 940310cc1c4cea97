"""gmix_tpu_torch.state against gmix_tpu.state: the same leaves (names,
shapes, values, and dtypes once converted back), and a lossless trip
between the two packages' representations."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

import gmix_tpu.config as j_cfg
import gmix_tpu_torch.config as t_cfg
from gmix_tpu.core.meta import build_meta as j_build_meta
from gmix_tpu.state import init_state as j_init_state
from gmix_tpu_torch.core.meta import build_meta as t_build_meta
from gmix_tpu_torch.state import init_state, state_bytes, state_from_numpy, state_to_numpy

torch.set_num_threads(1)

S = 2
SPECS = {
    "tiny": lambda c: c.tiny_spec(False),
    "reference_noppm_scaled8": lambda c: c.scale_tables(
        dataclasses.replace(c.reference_spec(), ppm=None, lstm=None, roll_ctxs=()), 8, history_bits=10),
    "tiny_ppm": lambda c: dataclasses.replace(c.tiny_spec(True), lstm=None),
    "reference_ppm_scaled8": lambda c: c.scale_tables(dataclasses.replace(c.reference_spec(), lstm=None), 8, history_bits=10),
    "tiny_lstm": lambda c: c.tiny_spec(True),
    "tiny_lstm_noppm": lambda c: dataclasses.replace(c.tiny_spec(True), ppm=None, roll_ctxs=()),
    "reference_scaled8": lambda c: c.scale_tables(c.reference_spec(), 8, history_bits=10),
    "best_scaled8": lambda c: c.scale_tables(c.best_spec(), 8, history_bits=10),
}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_same(a_tree, b_tree):
    a, b = dict(_flat(a_tree)), dict(_flat(b_tree))
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert (x.shape, x.dtype) == (y.shape, y.dtype), k
        assert np.array_equal(x.reshape(-1).view(np.uint8), y.reshape(-1).view(np.uint8)), k


@pytest.mark.parametrize("name", sorted(SPECS))
def test_init_state_matches_gmix_tpu(name):
    j_state = jax.device_get(j_init_state(j_build_meta(SPECS[name](j_cfg)), S))
    t_state = init_state(t_build_meta(SPECS[name](t_cfg)), S)
    _assert_same(j_state, state_to_numpy(t_state))
    # the arenas take the bytes they take in gmix_tpu; only the small u32
    # registers are widened to int64
    big = {"ltm.ind.st", "ltm.ind.p", "ltm.mix_w", "ltm.mix_pos", "ltm.hist", "ltm.match_tbl",
           "stm.ih_tbl", "ltm.apm", "stm.ppm_tbl"}
    j_big = sum(v.nbytes for k, v in _flat(j_state) if k in big)
    t_big = sum(t.numel() * t.element_size() for k, t in _flat(t_state) if k in big)
    assert t_big == j_big
    assert state_bytes(t_state) >= j_big


@pytest.mark.parametrize("seed", [0xDEADBEEF, 1, 123456789012])
@pytest.mark.parametrize("name", ["tiny_lstm", "reference_scaled8"])
def test_init_state_lstm_leaves_match_gmix_tpu_for_seed(name, seed):
    """The LSTM's initial weights are drawn from the seed (16 and 50 cells):
    the 13 long-term and 20 short-term LSTM leaves bit for bit, the 0-d
    `epoch` and `update_steps` among them."""
    j_state = jax.device_get(j_init_state(j_build_meta(SPECS[name](j_cfg)), S, seed))
    t_state = state_to_numpy(init_state(t_build_meta(SPECS[name](t_cfg)), S, seed))
    assert len(j_state["ltm"]["lstm"]) == 13 and len(j_state["stm"]["lstm"]) == 20
    _assert_same({"ltm": j_state["ltm"]["lstm"], "stm": j_state["stm"]["lstm"]},
                 {"ltm": t_state["ltm"]["lstm"], "stm": t_state["stm"]["lstm"]})
    assert t_state["stm"]["lstm"]["epoch"].shape == () and t_state["stm"]["lstm"]["update_steps"].shape == ()
    w_in = t_state["ltm"]["lstm"]["w_in"]
    assert (w_in[:, 0, :, -1] == 1.0).all() and np.array_equal(w_in[0], w_in[1])


def test_numpy_round_trip_is_identity():
    _check_round_trip("tiny")


def test_numpy_round_trip_is_identity_with_lstm():
    """Every LSTM leaf, the 0-d ones included."""
    _check_round_trip("tiny_lstm")


def test_numpy_round_trip_is_identity_with_ppm():
    _check_round_trip("tiny_ppm")


def _check_round_trip(name):
    # a state whose leaves hold arbitrary bits, including u32 values >= 2^31
    # and u16 values >= 2^15 (`ind.st`, and `ppm_tbl` with PPM)
    template = jax.device_get(j_init_state(j_build_meta(SPECS[name](j_cfg)), S))
    rng = np.random.default_rng(7)

    def scramble(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = scramble(v)
            elif v.dtype == np.float32:
                out[k] = rng.standard_normal(v.shape).astype(np.float32)
            else:
                info = np.iinfo(v.dtype)
                out[k] = rng.integers(info.min, info.max, v.shape, dtype=np.int64, endpoint=True).astype(v.dtype)
        return out

    tree = scramble(template)
    back = state_to_numpy(state_from_numpy(tree))
    _assert_same(tree, back)


def test_state_from_numpy_copies():
    tree = jax.device_get(j_init_state(j_build_meta(j_cfg.tiny_spec(False)), S))
    st = state_from_numpy(tree)
    st["ltm"]["ind"]["p"] += 1.0
    assert not tree["ltm"]["ind"]["p"].any()


def test_unported_specs_raise():
    """No spec is left unported: specs with an LSTM, with or without PPM,
    build their state (they raised NotImplementedError before the LSTM was
    ported)."""
    with_lstm = init_state(t_build_meta(t_cfg.tiny_spec(True)), S)
    assert "lstm" in with_lstm["stm"] and "lstm" in with_lstm["ltm"]
    no_ppm = init_state(t_build_meta(dataclasses.replace(t_cfg.tiny_spec(True), ppm=None, roll_ctxs=())), S)
    assert "ppm_tbl" not in no_ppm["stm"] and "lstm" in no_ppm["ltm"]
    # every LSTM leaf keeps its dtype, so the LSTM takes gmix_tpu's bytes
    j_state = jax.device_get(j_init_state(j_build_meta(j_cfg.tiny_spec(True)), S))
    j_lstm = sum(v.nbytes for k, v in _flat(j_state) if ".lstm." in k)
    assert sum(t.numel() * t.element_size() for k, t in _flat(with_lstm) if ".lstm." in k) == j_lstm
