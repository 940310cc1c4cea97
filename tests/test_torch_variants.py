"""The ensemble variants (`gmix_tpu_torch/variants.py`), the port's copy of
the spec constructors of tools/tpu_fast_ladder.py, tools/tpu_ablate.py and
tools/tpu_quality.py, against the tools themselves (imported from tools/
here only), and the variant shapes through the port against gmix_tpu on the
CPU:

- every name of the three tools' docstrings and branches gives the tool's
  spec: the same `stable_hash()` and every field of the Meta;
- one byte step of `ablate-indonly`, `ablate-nomix12` and `ablate-noih`
  (the latter two without the LSTM) at 8-bit tables, from a warm state,
  equals eager gmix_tpu's in every leaf (contract 1);
- (tests/test_torch_variants_lstm.py: `ablate-nomatch` and `ablate-mixtb0`
  with the LSTM against jitted gmix_tpu, contract 3);
- the PPM of `quality:ref-x4-oldppm` (no exclusion, no update exclusion, no
  SEE learning), its count update and prediction from a warm state, equals
  eager gmix_tpu's bitwise.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench as j_bench
import gmix_tpu.config as j_cfg
from gmix_tpu.core import step as j_step
from gmix_tpu.core.meta import build_meta as j_build_meta
from gmix_tpu_torch import bench as tb
from gmix_tpu_torch import variants
from gmix_tpu_torch.config import reference_spec, scale_tables
from gmix_tpu_torch.core import ppm as t_ppm
from gmix_tpu_torch.core import step as t_step
from gmix_tpu_torch.core.codec import Predictor, run_chunks
from gmix_tpu_torch.core.meta import build_meta
from gmix_tpu_torch.ops.rowmove import gather_rows
from gmix_tpu_torch.state import state_from_numpy, state_to_numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import tpu_ablate  # noqa: E402
import tpu_fast_ladder  # noqa: E402
import tpu_quality  # noqa: E402

torch.set_num_threads(1)

ABLATE_BITS = 8
S = 2
J_APM = (
    j_cfg.ApmStage("apm_lb", "last_byte", 8, lr=0.010, weight=0.50),
    j_cfg.ApmStage("apm_h2", "h2", 16, lr=0.010, weight=0.25),
)
# tools/tpu_quality.py's names: its docstring's, one of each family of its
# branches, and every variant data/quality_ablations.json records
QUALITY = ("ref-x4", "ref-x4-noppm", "ref-x4-oldppm", "scaled-14x16", "scaled-14x16-noppm", "scaled-14x16-oldppm",
           "scaled-12x64", "apm-20-75-8x4", "apm2-20-75-8x4", "apm2-10-50-8x4", "apm2-5-50-8x4", "apm2-10-35-8x4",
           "shallowppm-12x16", "boost-1-18x4", "boost-1-17x4", "boost-1-16x4", "best-x4", "tuned-x4",
           "ppmtune-4-48000-20x4", "ppmtune-2-30000-0x8")


def _ablated(v):
    return variants.ablate(scale_tables(reference_spec(), ABLATE_BITS, history_bits=ABLATE_BITS + 4), v)


def _tool_ablated(v, monkeypatch):
    monkeypatch.setenv("GMIX_ABLATE_BITS", str(ABLATE_BITS))
    return tpu_ablate.variant(v)


def _same_meta(t_spec, j_spec):
    """The same spec (fields, `stable_hash`) and every field of the Meta."""
    assert dataclasses.asdict(t_spec) == dataclasses.asdict(j_spec)
    assert t_spec.stable_hash() == j_spec.stable_hash()
    jm, tm = j_build_meta(j_spec), build_meta(t_spec)
    fields = [f.name for f in dataclasses.fields(jm)]
    assert [f.name for f in dataclasses.fields(tm)] == fields
    for field in fields:
        a, b = getattr(jm, field), getattr(tm, field)
        if field == "spec":
            assert b.stable_hash() == a.stable_hash()
        elif isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray) and b.dtype == a.dtype and np.array_equal(a, b), field
        else:
            assert type(b) is type(a) and b == a, field


@pytest.mark.parametrize("bits", [11, None])
@pytest.mark.parametrize("v", variants.LADDER)
def test_ladder_is_the_tools_spec(v, bits):
    """At the tool's default clamp (11 bits) and at the published sizes."""
    j_base = j_bench._spec_for(bits) if bits else dataclasses.replace(j_cfg.reference_spec(), apm=J_APM)
    _same_meta(variants.ladder(tb.spec_for(bits), v), tpu_fast_ladder.trim_spec(j_base, v))


@pytest.mark.parametrize("v", variants.ABLATE)
def test_ablate_is_the_tools_spec(v, monkeypatch):
    _same_meta(_ablated(v), _tool_ablated(v, monkeypatch))


def test_ablate_refuses_a_name_the_tool_refuses(monkeypatch):
    """`mixonly`, in the tool's docstring, has no branch there."""
    with pytest.raises(ValueError):
        _tool_ablated("mixonly", monkeypatch)
    with pytest.raises(ValueError, match="unknown ablate variant"):
        _ablated("mixonly")


@pytest.mark.parametrize("name", QUALITY)
def test_quality_is_the_tools_spec(name):
    spec, S_ = variants.quality(name)
    j_spec, j_S = tpu_quality.make_variant(name)
    assert S_ == j_S
    _same_meta(spec, j_spec)


@pytest.mark.parametrize("name", ["ladder-x", "ref-x4-foo", "foo-12x4", "best", "apm-1-2-3", "scaled-12"])
def test_an_unknown_variant_raises(name):
    """The ladder's tool returns an unknown name's spec unchanged, and
    quality's reads an unknown family as scaled-: the port refuses both."""
    with pytest.raises(ValueError):
        if name.startswith("ladder-"):
            variants.ladder(tb.spec_for(11), name[len("ladder-"):])
        else:
            variants.quality(name)


@pytest.mark.parametrize("profile, tool, v", [("ref:ladder-noih", "ladder", "noih"),
                                              ("ref:ablate-noih", "ablate", "noih"),
                                              ("ref:ladder-nolstm", "ladder", "nolstm"),
                                              ("ref:ablate-nolstm", "ablate", "nolstm")])
def test_the_two_tools_names_stay_apart(profile, tool, v):
    """noih and nolstm are other specs in each tool."""
    spec = tb.parse_profile(profile)[1]
    other = (variants.ablate if tool == "ladder" else variants.ladder)(tb.spec_for(None), v)
    assert spec.stable_hash() != other.stable_hash()
    if v == "nolstm":
        gated = [m for m in spec.indirects + spec.mixers if m.ctx == "lstm_ctx"]
        assert bool(gated) == (tool == "ablate") and spec.lstm is None
    else:
        assert bool(spec.ihash_ctxs) == (tool == "ladder")
        assert not [m for m in spec.indirects if m.name.startswith("ind_ih_")]


# ---------------------------------------------------------------------------
# the variant shapes through the port against gmix_tpu
# ---------------------------------------------------------------------------

WARM = 24


def _corpus(n):
    with open("data/corpus_100k.bin", "rb") as f:
        return f.read(n)


def _warm_state(spec, warm=WARM):
    """The port's state after `warm` corpus bytes a stream, and the bytes."""
    arr = np.frombuffer(_corpus(S * 64), np.uint8).reshape(S, 64).copy()
    pred = Predictor(spec, S, device="cpu")
    run_chunks(pred, torch.tensor(arr), torch.zeros((S, 1), dtype=torch.uint8), warm, decode=False, chunk=warm)
    return state_to_numpy(pred.state), arr


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("v", ["indonly", "nomix12", "noih"])
def test_ablate_byte_step_is_eager_gmix_tpus(v, monkeypatch):
    """One encode byte step from a warm state, every leaf bitwise but the
    entropy metrics (jnp.log2: 2 ulp), the coder's bytes and the data."""
    t_spec = dataclasses.replace(_ablated(v), lstm=None)
    j_spec = dataclasses.replace(_tool_ablated(v, monkeypatch), lstm=None)
    state_np, arr = _warm_state(t_spec)
    code = np.zeros((S, 512), np.uint8)
    js = jax.tree_util.tree_map(jnp.asarray, state_np)
    with jax.disable_jit():
        stm, ltm, coder, metrics, j_data, _, j_win, j_nw = j_step._byte_step(
            js["stm"], js["ltm"], js["coder"], js["metrics"], jnp.asarray(arr), jnp.asarray(code),
            j_step._code_words(jnp.asarray(code)), jnp.int32(WARM), jnp.asarray(False), j_build_meta(j_spec), True,
            "cond", bit_scan=False, analysis=True)
    pred = Predictor(t_spec, S, device="cpu")
    pred.state = state_from_numpy(state_np)
    t_data = torch.tensor(arr)
    t_win, t_nw = t_step._byte_step(pred.state, t_data, torch.tensor(code), WARM, False, pred.plan)
    want = dict(_flat(jax.device_get({"stm": stm, "ltm": ltm, "coder": coder, "metrics": metrics})))
    got = dict(_flat(state_to_numpy(pred.state)))
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        b = np.ascontiguousarray(got[k]).reshape(a.shape)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), k
        if k.startswith("metrics."):
            np.testing.assert_array_max_ulp(b, a, maxulp=2)
        else:
            assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)), f"{v}: {k} differs"
    np.testing.assert_array_equal(t_win.numpy(), np.asarray(j_win))
    np.testing.assert_array_equal(t_nw.numpy(), np.asarray(j_nw))
    np.testing.assert_array_equal(t_data.numpy(), np.asarray(j_data))


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def test_old_ppm_is_eager_gmix_tpus():
    """quality:ref-x4-oldppm's PPM at 8-bit tables, without the LSTM (which
    only reads the distribution): from a warm state, the count update with
    the next byte, then the prediction from the updated rows, bitwise."""
    t_spec = dataclasses.replace(scale_tables(variants.quality("ref-x4-oldppm")[0], 8, history_bits=12), lstm=None)
    j_spec = dataclasses.replace(j_cfg.scale_tables(tpu_quality.make_variant("ref-x4-oldppm")[0], 8, history_bits=12),
                                 lstm=None)
    assert not (t_spec.ppm.exclusion or t_spec.ppm.update_exclusion) and t_spec.ppm.see_lr == 0.0
    state_np, arr = _warm_state(t_spec, warm=48)
    stm_np = state_np["stm"]
    assert stm_np["ppm_tbl"][:, :, :256].any()
    completed = arr[:, 48].astype(np.uint32)
    with jax.disable_jit():
        j_stm = j_step._ppm_update({k: jnp.asarray(v) for k, v in stm_np.items()}, jnp.asarray(completed),
                                   j_build_meta(j_spec))
        j_stm = j_step._ppm_predict(j_stm, j_build_meta(j_spec))
    plan = t_step.StepPlan(build_meta(t_spec), S, "cpu")
    stm = state_from_numpy(stm_np)
    t_ppm._ppm_update(stm, torch.tensor(completed.astype(np.int64)), plan)
    cv, h = t_ppm._ppm_index(stm["ctx"], plan)
    t_ppm._ppm_predict(stm, gather_rows(stm["ppm_tbl"], h), cv, plan)
    got = state_to_numpy({k: stm[k] for k in ("ppm_tbl", "ppm_see", "ppm_probs", "ppm_top", "ppm_bot")})
    for k, b in got.items():
        a = np.asarray(j_stm[k])
        assert (a.shape, a.dtype) == (b.shape, b.dtype), k
        assert np.array_equal(_bits(a), _bits(b)), f"{k} differs"
    assert not np.array_equal(got["ppm_tbl"], stm_np["ppm_tbl"])
