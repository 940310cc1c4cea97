"""The port's bench entry point (`gmix_tpu_torch/bench.py`) against the
repository's `bench.py` and gmix_tpu, on the CPU at tiny and small scaled
specs.

The warm start is held against gmix_tpu's `_pretrain_host_state` run
eagerly (lane 0 of its two-lane program): bitwise without the LSTM
(contract 1: the entropy metrics, which go through jnp.log2, within 2 ulp),
within contract 3's tolerance with it (integers exact, floats 1e-5
relative with a floor of 1e-6). A whole `run_once` is held against
`bench._run_once` run jitted, which contracts a*b+c into fused
multiply-adds: within 1% in bpb and 0.5% in model bpb, as the codec tests
hold the archives (ROADMAP.md contract 1).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

import bench
import gmix_tpu as g
from gmix_tpu.config import ApmStage as JApmStage
from gmix_tpu.utils import serialization as j_serialization
import gmix_tpu_torch as gt
from gmix_tpu_torch import bench as tb
from gmix_tpu_torch.core.codec import Predictor
from gmix_tpu_torch.core.meta import build_meta
from gmix_tpu_torch.state import init_state, state_bytes, state_from_numpy, state_to_numpy

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
# (spec, warm bytes, chunk) of the eager warm starts: the tiny spec's LSTM
# horizon (10) divides the chunk, so its one backward pass is deferred
WARM_RUNS = {"tiny": (False, 16, 8), "lstm": (True, 10, 10)}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _torch_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _torch_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_states(want_tree, got_tree, lstm: bool):
    """Every leaf bitwise, the entropy metrics within 2 ulp; with the LSTM
    float leaves within the tolerance."""
    want, got = dict(_flat(want_tree)), dict(_flat(got_tree))
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        b = got[k]
        assert (a.shape, a.dtype) == (b.shape, b.dtype), k
        if lstm and a.dtype == np.float32:
            assert (np.abs(a - b) <= ATOL + RTOL * np.abs(a)).all(), f"{k} outside the tolerance"
        elif k.startswith("metrics."):
            np.testing.assert_array_max_ulp(b, a, maxulp=2)
        else:
            assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)), f"{k} differs"


@pytest.fixture(scope="module", params=sorted(WARM_RUNS))
def warm_run(request):
    """(name, gmix_tpu's one-lane host state run eagerly, the port's
    pretrain_state) on the corpus' first bytes."""
    lstm, warm, chunk = WARM_RUNS[request.param]
    with jax.disable_jit():
        j_host = bench._pretrain_host_state(g.tiny_spec(lstm), warm, chunk)
    t_state = tb.pretrain_state(gt.tiny_spec(lstm), tb.corpus(warm), chunk, "cpu")
    return request.param, jax.device_get(j_host), t_state


@pytest.mark.parametrize("bits", [8, 11])
def test_spec_for_is_bench_py_spec(bits):
    t_spec, j_spec = tb.spec_for(bits), bench._spec_for(bits)
    assert dataclasses.asdict(t_spec) == dataclasses.asdict(j_spec)
    assert t_spec.stable_hash() == j_spec.stable_hash()


def test_spec_for_none_is_the_published_reference_with_two_apm_stages():
    j_spec = dataclasses.replace(g.reference_spec(), apm=(
        JApmStage("apm_lb", "last_byte", 8, lr=0.010, weight=0.50),
        JApmStage("apm_h2", "h2", 16, lr=0.010, weight=0.25),
    ))
    t_spec = tb.spec_for(None)
    assert dataclasses.asdict(t_spec) == dataclasses.asdict(j_spec)
    assert t_spec.stable_hash() == j_spec.stable_hash()
    # no table clamped: the spec of chip_smoke.py's ref-full
    assert t_spec.stable_hash() != tb.spec_for(22).stable_hash()


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("name", ["tiny", "scaled-8", "ref-ppm:scaled-8", "ref-noppm:scaled-8", "best:scaled-8"])
def test_state_bytes_estimate_is_the_allocated_state(name, S):
    spec = gt.tiny_spec(True) if name == "tiny" else tb.parse_profile(name)[1]
    assert tb.state_bytes_estimate(spec, S) == state_bytes(init_state(build_meta(spec), S))


def test_pretrain_state_is_lane_0_of_eager_gmix_tpu(warm_run):
    name, j_host, t_state = warm_run
    got = state_to_numpy(t_state)
    assert got["stm"]["bits_seen"].shape == (1,)
    _assert_states(j_host, got, lstm=name == "lstm")


def _save_warm(warm_run, path) -> dict:
    """The port's warm start of `warm_run` written as a warm checkpoint;
    returns its sidecar."""
    name, _, t_state = warm_run
    lstm, warm, chunk = WARM_RUNS[name]
    side = tb.warm_sidecar(gt.tiny_spec(lstm), tb.corpus(warm), chunk)
    tb.save_warm_checkpoint(str(path), t_state, side)
    return side


def test_warm_checkpoint_reads_back_the_warm_start_bitwise(warm_run, tmp_path):
    """`pretrain_state`'s CPU tensors written and read: every leaf the same
    shape, dtype and bits (the int64-carried u32 lanes, the int16-carried
    u16 arenas and, with the LSTM, the 0-d leaves among them)."""
    name, _, t_state = warm_run
    path = tmp_path / "warm.gxt"
    side = _save_warm(warm_run, path)
    assert json.loads((tmp_path / "warm.gxt.json").read_text()) == side
    assert tb.check_warm_checkpoint(str(path), side)
    want, got = dict(_torch_leaves(t_state)), dict(_torch_leaves(tb.load_warm_checkpoint(str(path))))
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        b = got[k]
        assert (b.device.type, b.shape, b.dtype) == ("cpu", a.shape, a.dtype), k
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)), k
    assert {torch.int64, torch.int16, torch.int32, torch.float32} <= {a.dtype for a in want.values()}
    assert any(a.dim() == 0 for a in want.values()) == (name == "lstm")


def test_warm_checkpoint_is_gmix_tpu_lane_0(warm_run, tmp_path):
    """The port-written file read by gmix_tpu's `load_state` is the port's
    warm start with gmix_tpu's dtypes, every leaf bitwise, and so lane 0 of
    eager gmix_tpu's `_pretrain_host_state` as `pretrain_state` is."""
    name, j_host, t_state = warm_run
    path = tmp_path / "warm.gxt"
    _save_warm(warm_run, path)
    got = j_serialization.load_state(str(path))
    want = dict(_flat(state_to_numpy(t_state)))
    assert sorted(dict(_flat(got))) == sorted(want)
    for k, b in _flat(got):
        assert (b.shape, b.dtype) == (want[k].shape, want[k].dtype), k
        assert np.array_equal(b.reshape(-1).view(np.uint8), want[k].reshape(-1).view(np.uint8)), k
    _assert_states(j_host, got, lstm=name == "lstm")


def test_warm_predictor_is_broadcast_warm_and_resets_in_place(warm_run):
    name, j_host, t_state = warm_run
    lstm, S = name == "lstm", 3
    j_pred = bench._broadcast_warm(j_host, g.tiny_spec(lstm), S)
    # from the same one-stream state: a copy, every leaf bitwise
    pred = tb.warm_predictor(gt.tiny_spec(lstm), S, state_from_numpy(j_host), "cpu")
    _assert_states(jax.device_get(j_pred.state), state_to_numpy(pred.state), lstm=False)
    # after some bytes, reset_to_warm gives the warm start again in the
    # predictor's own leaves (a CUDA graph holds their storage)
    want = state_to_numpy(pred.state)
    leaves = dict(_torch_leaves(pred.state))
    gt.compress_bytes(tb.corpus(3 * 20, 500), gt.tiny_spec(lstm), S, 10, pred=pred)
    assert not np.array_equal(state_to_numpy(pred.state)["coder"]["wpos"], want["coder"]["wpos"])
    tb.reset_to_warm(pred, state_from_numpy(j_host))
    _assert_states(want, state_to_numpy(pred.state), lstm=False)
    assert all(leaves[k] is v for k, v in _torch_leaves(pred.state))


def test_run_once_is_exact_every_pass_and_close_to_bench_py(capsys):
    warm, n, S, chunk = 80, 160, 2, 40
    data = tb.corpus(n, warm)
    res = tb.run_once(gt.tiny_spec(True), S, chunk, data, tb.corpus(warm), 2, "cpu")
    passes = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["direction"], r["index"]) for r in passes] == [("encode", 1), ("encode", 2), ("decode", 1), ("decode", 2)]
    assert res["exact"] and len(res["encode_s"]) == len(res["decode_s"]) == 2
    assert res["warm_bytes"] == warm and res["bytes"] == n and res["streams"] == S
    _, bpb, model_bpb, exact, *_ = bench._run_once(g.tiny_spec(True), S, chunk, data, warm_bytes=warm)
    assert exact
    assert abs(res["bpb"] - bpb) <= 0.01 * bpb
    assert abs(res["model_bpb"] - model_bpb) <= 0.005 * model_bpb


def test_run_once_refuses_a_chunk_of_the_other_backward_order():
    with pytest.raises(ValueError, match="horizon"):
        tb.run_once(gt.tiny_spec(True), 2, 45, b"x" * 90, b"", 1, "cpu")


def test_finite_guard_raises_at_the_chunk_after_a_nan():
    spec, S, chunk = gt.tiny_spec(False), 2, 10
    pred = Predictor(spec, S, device="cpu", analysis=False)
    guard = tb.finite_guard(pred, "encode", chunk)

    def progress(done):
        guard(done)
        if done == chunk:
            pred.state["metrics"]["ent"][1] = float("nan")

    with pytest.raises(RuntimeError, match=r"encode: the cross-entropy of streams \[1\] is not finite after chunk 2 "):
        gt.compress_bytes(tb.corpus(S * 3 * chunk), spec, S, chunk, pred=pred, progress=progress)


def test_auto_streams_takes_the_most_that_fit():
    spec, n, chunk = tb.spec_for(8), 5000, 100
    need = tb.state_bytes_estimate(spec, 5) + tb.headroom_bytes(5, tb.padded_per(n, 5, chunk), chunk)
    assert tb.auto_streams(spec, n, chunk, need) == 5
    assert tb.auto_streams(spec, n, chunk, need - 1) == 4
    assert tb.auto_streams(spec, n, chunk, tb.RESERVE_BYTES) == 0


@pytest.mark.parametrize("streams", ["4", "auto"])
def test_a_configuration_over_the_budget_is_refused_before_allocating(streams, monkeypatch, capsys):
    def allocates(*a, **k):
        raise AssertionError("the refused configuration allocated")

    monkeypatch.setattr(tb, "run_once", allocates)
    monkeypatch.setattr(tb, "Predictor", allocates)
    monkeypatch.setenv("GMIX_HBM_BUDGET", str(3 << 30))
    with pytest.raises(SystemExit, match="refused") as e:
        tb.main(["--device", "cpu", "--profile", "ref", "--streams", streams, "--warm", "0", "--bytes", "1000"])
    assert e.value.code != 0
    config = json.loads(capsys.readouterr().out.splitlines()[0])
    assert config["bench"] == "config" and config["budget_bytes"] == 3 << 30
    assert config["state_estimate_bytes"] + config["headroom_bytes"] > config["budget_bytes"]


def test_corpus_never_repeats():
    size = os.path.getsize(tb.CORPUS)
    assert tb.corpus(None, 1 << 17) == tb.corpus(size)[1 << 17:]
    assert len(tb.corpus(None, 1 << 17)) == 917504
    for n, offset in ((10, size - 5), (None, size + 1), (size + 1, 0)):
        with pytest.raises(ValueError, match="corpus"):
            tb.corpus(n, offset)


def test_main_without_cuda_exits_with_the_no_device_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tb.main([])
    assert "runs on a CUDA device by default and found none" in str(e.value.code)


def test_main_on_the_cpu_prints_and_writes_every_row(monkeypatch, capsys, tmp_path):
    """main() through run_once, its knobs from bench.py's environment
    variables, with the tiny spec standing in for the profile's (the
    reference wiring is too slow on the CPU); nothing written under data/."""
    monkeypatch.setattr(tb, "spec_for", lambda bits: gt.tiny_spec(True))
    for k, v in {"GMIX_BENCH_CHUNK": 40, "GMIX_BENCH_WARM": 40, "GMIX_BENCH_BYTES": 80, "GMIX_BENCH_PASSES": 2,
                 "GMIX_BENCH_PROFILE": "scaled-8x2"}.items():
        monkeypatch.setenv(k, str(v))
    data_dir = sorted((f, os.path.getmtime(os.path.join("data", f))) for f in os.listdir("data"))
    out = tmp_path / "bench.json"
    assert tb.main(["--device", "cpu", "--offset", "1000", "--out", str(out)]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rows == json.loads(out.read_text())
    config, result = rows[0], rows[-1]
    assert config["bench"] == "config" and result["bench"] == "result"
    assert (config["spec"], config["streams"], config["chunk"], config["bytes"], config["offset"]) == (
        "scaled-8", 2, 40, 80, 1000)
    assert [r["direction"] for r in rows[1:-1]] == ["encode", "encode", "decode", "decode"]
    assert result["exact"] and result["warm_bytes"] == 40 and "vs_baseline" not in result
    assert sorted((f, os.path.getmtime(os.path.join("data", f))) for f in os.listdir("data")) == data_dir
