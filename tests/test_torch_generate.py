"""Temperature sampling in the port against gmix_tpu run eagerly.

gmix_tpu samples in its unfused sub-step (`step.py:1111-1119`); its fused
kernel never samples. The port samples in its fused sub-steps
(`core/fused.py`, the plain version here on the CPU), so what is held here
is the byte step and `generate_bytes` of the two packages on the same state,
uniforms and temperature: bitwise without the LSTM, and within contract 3's
tolerance (1e-5 relative, floor 1e-6) with it (ROADMAP.md), where the bytes
must still be the same.
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
from gmix_tpu.core.codec import generate_bytes as j_generate_bytes
from gmix_tpu.core.meta import build_meta
import gmix_tpu_torch as gt
from gmix_tpu_torch.core import step as t_step
from gmix_tpu_torch.core.codec import Predictor as TPredictor
from gmix_tpu_torch.state import state_from_numpy, state_to_numpy
from gmix_tpu_torch.utils import threefry

torch.set_num_threads(1)

S = 2
WARM = 48
RTOL, ATOL = 1e-5, 1e-6
# 1 / temperature: the default, gmix_tpu's CLI example (0.8), and the
# temperature floor of generate_bytes (0.001), where logistic saturates
INV_TEMPS = (1.0, 1 / 0.8, 1000.0)


def _specs(pkg, name):
    return {"tiny": lambda: pkg.tiny_spec(False),
            "ppm": lambda: dataclasses.replace(pkg.tiny_spec(True), lstm=None),
            "lstm": lambda: pkg.tiny_spec(True)}[name]()


def _corpus(n, offset=0):
    with open("data/corpus_100k.bin", "rb") as f:
        f.seek(offset)
        return f.read(n)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _assert_states(j_state, t_state, lstm: bool, where: str):
    """Every leaf bitwise, the entropy metrics (jnp.log2) within 2 ulp; with
    the LSTM its float leaves and what they reach within the tolerance."""
    want = dict(_flat(jax.device_get(j_state)))
    got = dict(_flat(state_to_numpy(t_state)))
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        b = np.ascontiguousarray(got[k]).reshape(a.shape)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), k
        if lstm and a.dtype == np.float32:
            assert (np.abs(a - b) <= ATOL + RTOL * np.abs(a)).all(), f"{where}: {k} outside the tolerance"
        elif k.startswith("metrics."):
            np.testing.assert_array_max_ulp(b, a, maxulp=2)
        else:
            assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)), f"{where}: {k} differs"


@pytest.mark.parametrize("seed", [1234, 7])
def test_uniforms_are_jax_randoms(seed):
    """Three successive chunks' (chunk * 8, S) uniforms, drawn as
    generate_bytes draws them, equal jax.random's bit for bit."""
    chunk = 16
    jk, tk = jax.random.PRNGKey(seed), threefry.key(seed)
    for _ in range(3):
        jk, jsub = jax.random.split(jk)
        tk, tsub = threefry.split(tk)
        want = np.asarray(jax.random.uniform(jsub, (chunk * 8, S), jnp.float32))
        got = threefry.uniform(tsub, (chunk * 8, S), 0.0, 1.0)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.fixture(scope="module")
def warm_states():
    """A state after WARM bytes coded by the port, per spec: the same state
    for both packages."""
    out = {}
    for name in ("tiny", "ppm"):
        spec = _specs(gt, name)
        tp = TPredictor(spec, S, device="cpu")
        gt.compress_bytes(_corpus(S * WARM), spec, S, WARM, pred=tp)
        out[name] = state_to_numpy(tp.state)
    return out


@pytest.mark.parametrize("inv_temp", INV_TEMPS, ids=["t1", "t0.8", "floor"])
@pytest.mark.parametrize("name", ["tiny", "ppm"])
def test_sampling_byte_step_matches_eager_gmix_tpu(warm_states, name, inv_temp):
    """One sampling byte step (learn off) from a warm state: every state leaf
    and the drawn byte bitwise."""
    state_np = warm_states[name]
    meta = build_meta(_specs(g, name))
    u = np.random.default_rng(int(inv_temp * 7)).random((8, S)).astype(np.float32)
    it = np.float32(inv_temp)
    t = WARM
    data = np.zeros((S, t + 1), np.uint8)
    code = np.zeros((S, 8), np.uint8)
    j_state = jax.tree_util.tree_map(jnp.asarray, state_np)
    with jax.disable_jit():
        stm, ltm, coder, metrics, j_data, _, _, _ = j_step._byte_step(
            j_state["stm"], j_state["ltm"], j_state["coder"], j_state["metrics"], jnp.asarray(data),
            jnp.asarray(code), jnp.zeros((S, 2), jnp.uint32), jnp.int32(t), jnp.asarray(False), meta, False, "cond",
            sample_u=jnp.asarray(u), inv_temp=jnp.float32(it), bit_scan=False,
        )
    tp = TPredictor(_specs(gt, name), S, device="cpu")
    tp.state = state_from_numpy(state_np)
    t_data = torch.tensor(data)
    t_step._byte_step(tp.state, t_data, torch.tensor(code), t, False, tp.plan, learn=False,
                      sample_u=torch.tensor(u), inv_temp=torch.tensor([it]))
    _assert_states({"stm": stm, "ltm": ltm, "coder": coder, "metrics": metrics}, tp.state, False, name)
    np.testing.assert_array_equal(t_data.numpy(), np.asarray(j_data))


def _generate_both(monkeypatch, name, prompt_len, out_size, chunk, seed, temperature=0.8):
    """generate_bytes of both packages from the same fresh state (S streams,
    every stream's bytes); the progress values of each. gmix_tpu runs its
    sub-steps unrolled, as in the byte step test above, which makes its eager
    run faster here; its tests hold the scanned form (its CPU default) equal
    to it (tests/test_serialization.py)."""
    monkeypatch.setenv("GMIX_BIT_SCAN", "0")
    j_step.get_chunk_fn.cache_clear()
    j_step.get_gen_chunk_fn.cache_clear()
    jp = JPredictor(_specs(g, name), S)
    tp = TPredictor(_specs(gt, name), S, device="cpu")
    tp.state = state_from_numpy(jax.device_get(jp.state))
    prompt = _corpus(prompt_len, 1000)
    j_prog, t_prog = [], []
    with jax.disable_jit():
        want = j_generate_bytes(jp, prompt, out_size, temperature, chunk, seed, j_prog.append, return_all=True)
    got = gt.generate_bytes(tp, prompt, out_size, temperature, chunk, seed, t_prog.append, return_all=True)
    return jp, tp, want, got, j_prog, t_prog


def test_generate_bytes_matches_eager_gmix_tpu(monkeypatch):
    """With PPM, without the LSTM: a prompt of one chunk (front-padded), two
    sampled chunks of which the last is cut; the bytes of both streams, every
    state leaf bitwise, and the progress values."""
    jp, tp, want, got, j_prog, t_prog = _generate_both(monkeypatch, "ppm", 2, 5, 3, seed=11)
    assert got == want and [len(b) for b in got] == [5, 5]
    _assert_states(jp.state, tp.state, False, "ppm generation")
    assert t_prog == j_prog == [3, 6]


def test_lstm_generate_bytes_matches_eager_gmix_tpu(monkeypatch):
    """tiny_spec(True): the LSTM's floats within contract 3's tolerance, the
    bytes the same. A draw that fell within that tolerance of its tempered
    probability could flip a bit between the packages; with seed 3 and these
    sizes none does (the bytes agree), so the seed is part of the test."""
    jp, tp, want, got, j_prog, t_prog = _generate_both(monkeypatch, "lstm", 4, 4, 4, seed=3)
    assert got == want
    _assert_states(jp.state, tp.state, True, "lstm generation")
    assert t_prog == j_prog == [4]


def test_generation_freezes_ltm():
    """Tester invariant 5 on the port: after training, generation leaves
    every long-term-memory leaf bitwise as it was and moves short-term
    memory (tests/test_invariants.py re-targeted)."""
    spec = gt.tiny_spec(True)
    tp = TPredictor(spec, 1, device="cpu")
    gt.compress_bytes(_corpus(64), spec, 1, 32, pred=tp)
    ltm_before = {k: v.copy() for k, v in _flat(state_to_numpy(tp.state["ltm"]))}
    stm_before = {k: v.copy() for k, v in _flat(state_to_numpy(tp.state["stm"]))}
    out = gt.generate_bytes(tp, b"", 16, temperature=0.8, chunk=16)
    assert len(out) == 16
    for k, a in _flat(state_to_numpy(tp.state["ltm"])):
        assert np.array_equal(a, ltm_before[k]), f"LTM changed during generation: {k}"
    assert any(not np.array_equal(a, stm_before[k]) for k, a in _flat(state_to_numpy(tp.state["stm"])))


def test_progress_of_compress_and_decompress_is_gmix_tpus():
    """`progress` of compress_bytes, decompress_bytes and (through them)
    run_chunks is called with gmix_tpu's values: the bytes per stream done
    after each chunk."""
    spec_j, spec_t = g.tiny_spec(False), gt.tiny_spec(False)
    data = _corpus(100)
    j_enc, t_enc, j_dec, t_dec = [], [], [], []
    blob = g.compress_bytes(data, spec_j, S, 20, progress=j_enc.append)
    t_blob = gt.compress_bytes(data, spec_t, S, 20, progress=t_enc.append, device="cpu")
    g.decompress_bytes(blob, spec_j, 20, progress=j_dec.append)
    assert gt.decompress_bytes(t_blob, spec_t, 20, progress=t_dec.append, device="cpu") == data
    assert t_enc == j_enc == [20, 40, 60] and t_dec == j_dec == [20, 40, 60]


def test_sampling_runs_with_learn_off():
    """gmix_tpu's generation chunk passes learn=False: the sampling mode
    refuses to learn, on the CPU as on the card."""
    from gmix_tpu_torch.core import fused
    from gmix_tpu_torch.core.meta import build_meta as t_build_meta

    meta = t_build_meta(gt.tiny_spec(False))
    with pytest.raises(ValueError, match="learn off"):
        fused.io_layout(meta, True, True, sample=True)
    with pytest.raises(ValueError, match="learn off"):
        fused.fused_substeps_plain(meta, fused.const_inputs(meta, True), {}, True, True, sample=True)
