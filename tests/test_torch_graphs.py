"""The compiled chunk (core/step.py `ChunkFn`, `GenChunkFn`) on the CPU.

On a CUDA device the byte step is captured as CUDA graphs and replayed. The
CPU has no graphs, so these tests stand a recorder in for
`step.CapturedStep`: it keeps the body that a graph would capture and runs it
at every replay, under a dispatch mode that fails on any read of a device
value back to the host (a capture would fail on it, or bake in the value of
the byte it was captured on). What the tests hold:

(a) no byte step, deferred backward pass or sampling step reads a value back
    to the host, at the stream's first byte and later ones, on the byte that
    wraps the LSTM's window, in every variant the host picks;
(b) every state leaf keeps its storage through a step, a chunk, and a state
    assigned, loaded or copied;
(c) the graphs' loop (buffers in, one body a byte, buffers out) equals the
    eager loop bit for bit, and both equal eager gmix_tpu at the stream's
    first byte, on the wrap byte and across a whole window, to contract 1
    (contract 3 where the LSTM's prediction reaches: tests/test_torch_step.py).
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import gmix_tpu as g
from gmix_tpu.core import step as j_step
from gmix_tpu.core.codec import Predictor as JPredictor
from gmix_tpu.core.codec import _pad_streams, run_chunks as j_run_chunks
import gmix_tpu_torch as gt
from gmix_tpu_torch.core import step as t_step
from gmix_tpu_torch.core.codec import Predictor, run_chunks
from gmix_tpu_torch.parallel.mesh import make_mesh, shard_state, stream_sharding
from gmix_tpu_torch.state import state_from_numpy, state_to_numpy
from gmix_tpu_torch.utils.serialization import copy_state

torch.set_num_threads(1)

S = 2
HZ = 10  # tiny_spec(True)'s horizon
# float leaves that the LSTM's prediction reaches within a byte step, and
# their tolerance (tests/test_torch_step.py)
LSTM_REACH = ("stm.lstm.", "ltm.lstm.", "ltm.mix_w", "ltm.mix_pos", "ltm.mix_dense", "ltm.apm", "metrics.")
RTOL, ATOL = 1e-5, 1e-6
aten = torch.ops.aten


class NoHostRead(TorchDispatchMode):
    """Fails on every op that brings a tensor's value to the host: a scalar
    read (`item`, `int()`, `bool()` of a tensor), `nonzero`, `masked_select`
    and indexing with a boolean mask (whose result's size depends on the
    data)."""

    READS = (aten._local_scalar_dense, aten.nonzero, aten.masked_select)
    INDEXING = (aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        packet = func.overloadpacket
        if packet in self.READS:
            raise AssertionError(f"{func} reads a tensor back to the host")
        if packet in self.INDEXING:
            for ix in args[1]:
                if ix is not None and ix.dtype == torch.bool:
                    raise AssertionError(f"{func} indexes with a boolean mask")
        return func(*args, **(kwargs or {}))


class Recorded:
    """Stands in for step.CapturedStep on the CPU: a graph of the body, whose
    replay runs the body under NoHostRead."""

    made = []

    def __init__(self, plan, body):
        self.body = body
        self.launches = []
        self.capture_s = 0.0
        Recorded.made.append(self)

    def replay(self):
        with NoHostRead():
            self.body()


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(t_step, "CapturedStep", Recorded)
    monkeypatch.setattr(t_step._fused, "prepare", lambda *a, **k: None)
    Recorded.made = []
    return Recorded


def _corpus(n, offset=0):
    with open("data/corpus_100k.bin", "rb") as f:
        f.seek(offset)
        return f.read(n)


def _ppm_spec(pkg):
    return dataclasses.replace(pkg.tiny_spec(True), lstm=None)


SPECS = {"plain": lambda pkg: pkg.tiny_spec(False), "ppm": _ppm_spec, "lstm": lambda pkg: pkg.tiny_spec(True)}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_same_state(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        assert torch.equal(la[k].view(-1).view(torch.uint8), lb[k].view(-1).view(torch.uint8)), k


def _ptrs(state):
    return {k: v.data_ptr() for k, v in _leaves(state) if v.numel()}


def _warm_pred(spec, n_bytes, chunk, offset=0):
    """A CPU predictor after `n_bytes` a stream of the corpus, and the input."""
    p = Predictor(spec, S, device="cpu")
    data = np.frombuffer(_corpus(S * (n_bytes + 64), offset), np.uint8).reshape(S, -1).copy()
    code = torch.zeros((S, 1), dtype=torch.uint8)
    if n_bytes:
        run_chunks(p, torch.tensor(data), code, n_bytes, decode=False, chunk=chunk)
    return p, data


# ---------------------------------------------------------------------------
# (a) + (c): the graphs' loop against the eager loop, every variant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t0", [0, 20], ids=["first-byte", "later"])
@pytest.mark.parametrize("name", ["plain", "lstm"])
def test_graph_loop_encode_equals_eager_and_reads_nothing(recorded, name, t0):
    """Encode a chunk through the graphs' loop and through the eager loop
    from the same state: the same state leaves, bytes and (win, nw), bit for
    bit, no body reading a device value. At t0 = 0 the chunk starts at the
    stream's first byte; with the LSTM (horizon 10, chunk 12, the backward
    pass inside the byte) it crosses the window's wrap."""
    spec = SPECS[name](gt)
    chunk = 12
    p, data = _warm_pred(spec, t0, 20)
    q = p.copy()
    fn = t_step.get_chunk_fn(p.plan, chunk)
    assert not fn.defer
    d_p, d_q = torch.tensor(data), torch.tensor(data)
    code = torch.zeros((S, 1), dtype=torch.uint8)
    win_g, nw_g = fn._replayed(p.state, p.plan, d_p, code, t0)
    win_e, nw_e = t_step.get_chunk_fn(q.plan, chunk)._eager(q.state, q.plan, d_q, code, t0)
    _assert_same_state(p.state, q.state)
    assert torch.equal(win_g, win_e) and torch.equal(nw_g, nw_e) and torch.equal(d_p, d_q)
    assert set(fn.graphs) == ({("encode", "byte"), ("encode", "wrap")} if name == "lstm" else {("encode", "byte")})


def _graph_loop(m):
    """Every compiled chunk called on CPU tensors runs the graphs' loop (with
    recorded graphs) instead of the eager loop."""
    m.setattr(t_step, "CapturedStep", Recorded)
    m.setattr(t_step._fused, "prepare", lambda *a, **k: None)
    m.setattr(t_step.ChunkFn, "__call__", t_step.ChunkFn._replayed)
    m.setattr(t_step.GenChunkFn, "__call__", t_step.GenChunkFn._replayed)


@pytest.mark.parametrize("name,chunk", [("plain", 16), ("ppm", 16), ("lstm", 16), ("lstm", 20)],
                         ids=["plain", "ppm", "lstm-cond", "lstm-defer"])
def test_codec_through_the_graph_loop_equals_eager(name, chunk, monkeypatch, tmp_path):
    """compress_bytes, decompress_bytes and generate_bytes through the
    graphs' loop give the eager loop's archive, generated bytes and
    checkpoint, and the graphs' loop decodes the archive."""
    spec = SPECS[name](gt)
    data = _corpus(70, offset=700)
    outs = {}
    for kind in ("eager", "graphs"):
        with monkeypatch.context() as m:
            if kind == "graphs":
                _graph_loop(m)
            p = Predictor(spec, S, device="cpu")
            blob = gt.compress_bytes(data, spec, S, chunk, pred=p)
            gen = gt.generate_bytes(p, data[:7], 12, temperature=0.8, chunk=8, seed=3, return_all=True)
            p.save(str(tmp_path / f"{kind}.gxt"))
            outs[kind] = blob, gen
    assert outs["eager"] == outs["graphs"]
    assert (tmp_path / "eager.gxt").read_bytes() == (tmp_path / "graphs.gxt").read_bytes()
    with monkeypatch.context() as m:
        _graph_loop(m)
        assert gt.decompress_bytes(outs["eager"][0], spec, chunk, device="cpu") == data


@pytest.mark.parametrize("name", ["ppm", "lstm"])
def test_graph_loop_defers_the_backward_pass_as_the_eager_loop(recorded, name):
    """A chunk that the horizon divides (learning on): the backward pass runs
    as a graph of its own after every horizon-th byte; two chunks of 20 from
    the stream's first byte, every leaf as the eager loop leaves it."""
    spec = SPECS[name](gt)
    p, data = _warm_pred(spec, 0, 20)
    q = p.copy()
    fn, fe = t_step.get_chunk_fn(p.plan, 2 * HZ), t_step.get_chunk_fn(q.plan, 2 * HZ)
    code = torch.zeros((S, 1), dtype=torch.uint8)
    d_p, d_q = torch.tensor(data), torch.tensor(data)
    for t0 in (0, 2 * HZ):
        out_g = fn._replayed(p.state, p.plan, d_p, code, t0)
        out_e = fe._eager(q.state, q.plan, d_q, code, t0)
        assert all(torch.equal(a, b) for a, b in zip(out_g, out_e))
    _assert_same_state(p.state, q.state)
    if name == "lstm":
        assert fn.defer and set(fn.graphs) == {("encode", "byte"), ("encode", "wrap"), ("bptt",)}
        assert int(p.state["stm"]["lstm"]["update_steps"]) == 4
    else:
        assert not fn.defer and set(fn.graphs) == {("encode", "byte")}
    with pytest.raises(ValueError, match="multiple of the LSTM horizon"):
        if name == "lstm":
            fn._replayed(p.state, p.plan, d_p, code, 5)
        else:
            raise ValueError("t0 must be a multiple of the LSTM horizon (no LSTM: nothing to check)")


@pytest.mark.parametrize("name", ["plain", "lstm"])
def test_graph_loop_samples_as_the_eager_loop(recorded, name):
    """The sampling chunk: one graph, learn off; the same sampled bytes and
    state as the eager loop, from the stream's first byte and from a warm
    state, across the LSTM's wrap."""
    spec = SPECS[name](gt)
    for warm in (0, 16):
        p, _ = _warm_pred(spec, warm, 16)
        q = p.copy()
        chunk, t0 = 12, warm
        rng = np.random.default_rng(5)
        u = torch.tensor(rng.random((chunk * 8, S), dtype=np.float32))
        inv_temp = torch.tensor([np.float32(1.25)])
        d_p = torch.zeros((S, t0 + chunk), dtype=torch.uint8)
        d_q = d_p.clone()
        fn = t_step.get_gen_chunk_fn(p.plan, chunk)
        fn._replayed(p.state, p.plan, d_p, t0, u, inv_temp)
        t_step.get_gen_chunk_fn(q.plan, chunk)._eager(q.state, q.plan, d_q, t0, u, inv_temp)
        _assert_same_state(p.state, q.state)
        assert torch.equal(d_p, d_q) and set(fn.graphs) == {("sample",)}


def test_graph_loop_captures_each_variant_once(recorded):
    """Graphs are made when their variant is first needed and replayed after;
    a longer code stream makes a larger code buffer, and only the decode
    graphs are captured again."""
    spec = gt.tiny_spec(False)
    p, data = _warm_pred(spec, 0, 8)
    fn = t_step.get_chunk_fn(p.plan, 8)
    d = torch.tensor(data)
    for t0 in (0, 8, 16):
        fn._replayed(p.state, p.plan, d, torch.zeros((S, 1), dtype=torch.uint8), t0)
    assert len(Recorded.made) == 1
    small, large = torch.zeros((S, 40), dtype=torch.uint8), torch.zeros((S, 300), dtype=torch.uint8)
    fn._replayed(p.state, p.plan, d, small, 24, decode=True)
    assert len(Recorded.made) == 2 and fn.buf["code"].shape[1] == 64
    fn._replayed(p.state, p.plan, d, small, 32, decode=True)
    assert len(Recorded.made) == 2
    fn._replayed(p.state, p.plan, d, large, 40, decode=True)
    assert len(Recorded.made) == 3 and fn.buf["code"].shape[1] == 512
    assert set(fn.graphs) == {("encode", "byte"), ("decode", "byte")}
    assert t_step.get_chunk_fn(p.plan, 8) is fn and t_step.get_chunk_fn(p.plan, 16) is not fn


def test_no_host_read_in_any_step_variant():
    """(a) each variant of the byte step as a graph would capture it
    (`_step`, with the host's choices made), and the deferred backward pass,
    read no device value: encode, decode, sampling, the byte that wraps the
    window with the backward pass inside it, at t == 0 and t > 0, for
    tiny_spec(False) and tiny_spec(True)."""
    for spec in (gt.tiny_spec(False), gt.tiny_spec(True)):
        p, data = _warm_pred(spec, 0, 8)
        plan, st = p.plan, p.state
        d = torch.tensor(data)
        code = torch.tensor(np.random.default_rng(1).integers(0, 256, (S, 256), dtype=np.uint8))
        u = torch.rand((8, S), generator=torch.Generator().manual_seed(2))
        inv_temp = torch.tensor([1.25])
        has_lstm = spec.lstm is not None
        for t in (0, 1, HZ - 1, HZ):
            ti = torch.tensor(t)
            for kind in ("encode", "decode", "sample", "wrap"):
                if kind == "wrap" and not has_lstm:
                    continue
                q = p.copy()
                if has_lstm:
                    # the epoch leaf as a state at this byte holds it
                    q.state["stm"]["lstm"]["epoch"].fill_(HZ - 1 if kind == "wrap" else t % HZ)
                sample = kind == "sample"
                with NoHostRead():
                    t_step._step(q.state, d, code, ti, ti, kind == "decode", q.plan, not sample, True, True,
                                 kind == "wrap", sample_u=u if sample else None, inv_temp=inv_temp if sample else None)
                if kind == "wrap":
                    assert int(q.state["stm"]["lstm"]["update_steps"]) == 1
        if has_lstm:
            with NoHostRead():
                t_step.lstm_bptt(st, plan)
            assert int(st["stm"]["lstm"]["update_steps"]) == 1


# ---------------------------------------------------------------------------
# (b) fixed storage
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["plain", "lstm"])
def test_every_leaf_keeps_its_storage(recorded, name, tmp_path):
    """Through eager byte steps, the graphs' loop, generation, a state
    assigned (Predictor.state = ...), a checkpoint loaded and a copy made,
    every state leaf stays in the storage it had; what was assigned or
    loaded is what the leaves then hold, and the LSTM's epoch is read
    again."""
    spec = SPECS[name](gt)
    p, data = _warm_pred(spec, 0, 8)
    ptrs = _ptrs(p.state)
    d, code = torch.tensor(data), torch.zeros((S, 1), dtype=torch.uint8)
    for t in range(3):
        t_step._byte_step(p.state, d, code, t, False, p.plan)
    t_step.get_chunk_fn(p.plan, 8)._replayed(p.state, p.plan, d, code, 8)
    gt.generate_bytes(p, b"", 8, chunk=8)
    assert _ptrs(p.state) == ptrs
    other, _ = _warm_pred(spec, 24, 24, offset=5000)
    p.state = copy_state(other.state)
    assert _ptrs(p.state) == ptrs
    _assert_same_state(p.state, other.state)
    if spec.lstm is not None:
        assert p.plan.host_epoch(p.state["stm"]["lstm"]) == 24 % HZ
    p.save(str(tmp_path / "a.gxt"))
    fresh = Predictor(spec, S, device="cpu")
    fresh_ptrs = _ptrs(fresh.state)
    fresh.load(str(tmp_path / "a.gxt"))
    assert _ptrs(fresh.state) == fresh_ptrs
    _assert_same_state(fresh.state, other.state)
    c = p.copy()
    assert _ptrs(p.state) == ptrs and not set(_ptrs(c.state).values()) & set(ptrs.values())


def test_sharded_leaves_keep_their_storage(tmp_path):
    """A sharded predictor's shards keep their leaves' storage when a state
    is assigned to it or loaded into it."""
    spec = gt.tiny_spec(False)
    mesh = make_mesh(devices=["cpu"] * 2)
    p = Predictor(spec, 4, device=None, sharding=stream_sharding(mesh))
    ptrs = [_ptrs(s.state) for s in p.shards]
    one = Predictor(spec, 4, device="cpu")
    gt.compress_bytes(_corpus(160), spec, 4, 40, pred=one)
    p.state = shard_state(one.state, mesh)
    one.save(str(tmp_path / "one.gxt"))
    p.load(str(tmp_path / "one.gxt"))
    assert [_ptrs(s.state) for s in p.shards] == ptrs
    for s, want in zip(p.shards, shard_state(one.state, mesh)):
        _assert_same_state(s.state, want)


@pytest.mark.parametrize("how", ["dict-leaves", "assigned"])
def test_a_state_set_between_chunks_is_taken(recorded, how):
    """Between two chunks, every leaf replaced in the state dict (not through
    the predictor), or a whole state assigned to the predictor: the graphs'
    loop codes on from the new state, with its LSTM epoch, as a predictor
    that started from it does, and its graphs' leaves stay the ones they
    hold."""
    spec = gt.tiny_spec(True)
    p, data = _warm_pred(spec, 16, 16)
    other, _ = _warm_pred(spec, 32, 16, offset=3000)
    fn = t_step.get_chunk_fn(p.plan, 16)
    d = torch.tensor(data)
    code = torch.zeros((S, 1), dtype=torch.uint8)
    fn._replayed(p.state, p.plan, d, code, 16)
    ptrs = _ptrs(p.state)
    if how == "assigned":
        p.state = copy_state(other.state)
    else:
        new = copy_state(other.state)
        for (d_old, k, _), (_, _, v) in zip(t_step._leaf_refs(p.state), t_step._leaf_refs(new)):
            d_old[k] = v
    ref = other.copy()
    d_ref = d.clone()
    out = fn._replayed(p.state, p.plan, d, code, 32)
    want = t_step.get_chunk_fn(ref.plan, 16)._eager(ref.state, ref.plan, d_ref, code, 32)
    _assert_same_state(p.state, ref.state)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert _ptrs(p.state) == ptrs


# ---------------------------------------------------------------------------
# (c) against eager gmix_tpu
# ---------------------------------------------------------------------------


def _flat_np(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_np(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _compare_to_gmix(j_state, t_state, reach):
    want = dict(_flat_np(jax.device_get(j_state)))
    got = dict(_flat_np(state_to_numpy(t_state)))
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        b = np.ascontiguousarray(got[k]).reshape(a.shape)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), k
        if a.dtype == np.float32 and reach and k.startswith(reach):
            assert (np.abs(a - b) <= ATOL + RTOL * np.abs(a)).all(), f"{k} outside the tolerance"
        elif k.startswith("metrics."):
            np.testing.assert_array_max_ulp(b, a, maxulp=2)
        else:
            assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)), f"{k} differs"


def _gmix_chunk(meta, j_state, arr, t0, chunk, mode):
    """gmix_tpu's byte steps over [t0, t0 + chunk), eagerly, in the backward
    pass's order `mode`."""
    j_data = jnp.asarray(arr)
    code = jnp.zeros((S, 64), jnp.uint8)
    wins, nws = [], []
    with jax.disable_jit():
        for t in range(t0, t0 + chunk):
            stm, ltm, coder, metrics, j_data, _, win, nw = j_step._byte_step(
                j_state["stm"], j_state["ltm"], j_state["coder"], j_state["metrics"], j_data, code,
                j_step._code_words(code), jnp.int32(t), jnp.asarray(False), meta, True, mode,
                bit_scan=False, analysis=True)
            if mode == "defer" and (t + 1 - t0) % HZ == 0:
                lst, lw = j_step._lstm_bptt(stm["lstm"], ltm["lstm"], meta)
                stm, ltm = dict(stm, lstm=lst), dict(ltm, lstm=lw)
            j_state = {"stm": stm, "ltm": ltm, "coder": coder, "metrics": metrics}
            wins.append(np.asarray(win))
            nws.append(np.asarray(nw))
    return j_state, np.asarray(j_data), np.stack(wins), np.stack(nws)


def _j_warm(spec, warm, chunk):
    data = _corpus(S * (warm + 2 * chunk + 16))
    arr, _ = _pad_streams(data, S, chunk)
    jp = JPredictor(spec, S)
    if warm:
        j_run_chunks(jp, jnp.asarray(arr), jnp.zeros((S, 64), jnp.uint8), warm, decode=False, chunk=chunk)
    return jp.meta, jax.device_get(jp.state), arr


@pytest.mark.parametrize("name", ["plain", "lstm"])
def test_first_bytes_through_the_graph_loop_match_eager_gmix_tpu(recorded, name):
    """From a fresh state: bytes 0-3 (the stream's first, where `t > 0`
    selects on the device) through the graphs' loop equal eager gmix_tpu's,
    every leaf, the bytes and the encoder's (win, nw)."""
    meta, state_np, arr = _j_warm(SPECS[name](g), 0, 4)
    j_state, j_data, j_win, j_nw = _gmix_chunk(meta, jax.tree_util.tree_map(jnp.asarray, state_np), arr, 0, 4, "cond")
    p = Predictor(SPECS[name](gt), S, device="cpu")
    d = torch.tensor(arr)
    win, nw = t_step.get_chunk_fn(p.plan, 4)._replayed(p.state, p.plan, d, torch.zeros((S, 1), dtype=torch.uint8), 0)
    _compare_to_gmix(j_state, p.state, LSTM_REACH if name == "lstm" else ())
    np.testing.assert_array_equal(d.numpy(), j_data)
    np.testing.assert_array_equal(win.numpy(), j_win)
    np.testing.assert_array_equal(nw.numpy(), j_nw)


@pytest.mark.parametrize("mode", ["cond", "defer"])
def test_a_window_through_the_graph_loop_matches_eager_gmix_tpu(recorded, mode):
    """tiny_spec(True) from a warm state, across the window's wrap: "cond" a
    chunk of 4 from two bytes before the wrap (the backward pass inside the
    wrapping byte), "defer" a whole window of 10 from its first byte (the
    backward pass as its own graph after the tenth). Every leaf against eager
    gmix_tpu, to contract 3 where the LSTM reaches, exactly elsewhere."""
    warm, chunk = (8 * 21, 4) if mode == "cond" else (160, HZ)
    meta, state_np, arr = _j_warm(g.tiny_spec(True), warm, 8 if mode == "cond" else 40)
    assert int(state_np["stm"]["lstm"]["epoch"]) == warm % HZ
    j_state, j_data, j_win, j_nw = _gmix_chunk(meta, jax.tree_util.tree_map(jnp.asarray, state_np), arr, warm, chunk,
                                               mode)
    p = Predictor(gt.tiny_spec(True), S, device="cpu")
    p.state = state_from_numpy(state_np)
    d = torch.tensor(arr)
    fn = t_step.get_chunk_fn(p.plan, chunk)
    assert fn.defer == (mode == "defer")
    win, nw = fn._replayed(p.state, p.plan, d, torch.zeros((S, 1), dtype=torch.uint8), warm)
    assert ("encode", "wrap") in fn.graphs and (("bptt",) in fn.graphs) == (mode == "defer")
    assert int(p.state["stm"]["lstm"]["update_steps"]) == int(state_np["stm"]["lstm"]["update_steps"]) + 1
    _compare_to_gmix(j_state, p.state, LSTM_REACH)
    np.testing.assert_array_equal(d.numpy(), j_data)
    np.testing.assert_array_equal(win.numpy(), j_win)
    np.testing.assert_array_equal(nw.numpy(), j_nw)
