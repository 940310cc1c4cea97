"""The compiled chunk on a GPU: CUDA graphs of the byte step against the
same steps dispatched op by op (the chunk's `_eager` loop).

Imports torch and gmix_tpu_torch only, so it runs on a GPU machine that has
no JAX: `python -m pytest tests/test_torch_graphs_cuda.py -q`. Without a
CUDA device every test skips (a CUDA graph has no CPU mode;
tests/test_torch_graphs.py holds the graphs' loop on the CPU)."""
import dataclasses

import numpy as np
import pytest
import torch

import gmix_tpu_torch as gt
from gmix_tpu_torch import obs
from gmix_tpu_torch.config import ApmStage
from gmix_tpu_torch.core import codec
from gmix_tpu_torch.core import step as t_step
from gmix_tpu_torch.core.meta import build_meta
from gmix_tpu_torch.ops import kernels
from gmix_tpu_torch.parallel.mesh import make_mesh, stream_sharding
from gmix_tpu_torch.utils.serialization import copy_state

S = 2
# every name a hand-written kernel's launches are counted under
KERNELS = tuple(w for k in kernels.KERNELS for w in k.wrappers)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _ref_full():
    return dataclasses.replace(gt.reference_spec(), apm=(
        ApmStage("apm_lb", "last_byte", 8, lr=0.010, weight=0.50), ApmStage("apm_h2", "h2", 16, lr=0.010, weight=0.25)))


def _spec(name):
    """tiny_spec(False / True), and the reference wirings of chip_smoke.py
    at scale_tables(..., 12, history_bits=16)."""
    if name.startswith("tiny"):
        return gt.tiny_spec(name == "tiny-lstm")
    full = _ref_full()
    spec = {"ref-full": full, "ref-ppm": dataclasses.replace(full, lstm=None),
            "ref-noppm": dataclasses.replace(full, lstm=None, ppm=None, roll_ctxs=())}[name]
    return gt.scale_tables(spec, 12, history_bits=16)


def _corpus(n, offset=0):
    with open("data/corpus_1m.bin", "rb") as f:
        f.seek(offset)
        return f.read(n)


def _counts():
    n = obs.launches()
    return [n.get(k, 0) for k in KERNELS]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _host_state(state):
    return {k: v.detach().cpu() for k, v in _leaves(state)}


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k].reshape(-1).view(torch.uint8), b[k].reshape(-1).view(torch.uint8)), k


def _round_trip(spec, dev, chunk, eager, n_bytes=256, gen_chunk=16):
    """compress, decompress and generate on the card through the graphs or
    through the eager loop (the compiled chunks' `_eager`); returns what came
    out, the states and the launch counts of each call."""
    mp = pytest.MonkeyPatch()
    if eager:
        mp.setattr(t_step.ChunkFn, "__call__", t_step.ChunkFn._eager)
        mp.setattr(t_step.GenChunkFn, "__call__", t_step.GenChunkFn._eager)
    try:
        data = _corpus(n_bytes, 4096)
        out, launches = {}, {}
        p = codec.Predictor(spec, S, device=dev)
        c0 = _counts()
        out["archive"] = gt.compress_bytes(data, spec, S, chunk, pred=p)
        launches["encode"] = [a - b for a, b in zip(_counts(), c0)]
        out["encoded_state"] = _host_state(p.state)
        c0 = _counts()
        out["generated"] = gt.generate_bytes(p, data[:9], 24, temperature=0.8, chunk=gen_chunk, seed=5, return_all=True)
        launches["generate"] = [a - b for a, b in zip(_counts(), c0)]
        out["generated_state"] = _host_state(p.state)
        q = codec.Predictor(spec, S, device=dev)
        c0 = _counts()
        out["decoded"] = gt.decompress_bytes(out["archive"], spec, chunk, pred=q)
        launches["decode"] = [a - b for a, b in zip(_counts(), c0)]
        out["decoded_state"] = _host_state(q.state)
        assert out["decoded"] == data
        return out, launches, (p, q)
    finally:
        mp.undo()


def _compare(graphs, eager):
    for k in ("archive", "generated", "decoded"):
        assert graphs[k] == eager[k], k
    for k in ("encoded_state", "generated_state", "decoded_state"):
        _assert_same(graphs[k], eager[k])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny", "tiny-lstm", "ref-noppm", "ref-ppm", "ref-full"])
def test_graphs_equal_the_eager_loop(cuda, name):
    """Encode (the backward pass inside the wrapping byte), generation and
    decode through the graphs and through the eager loop: the same archive,
    bytes and generated bytes, every state leaf bit for bit, and the same
    launches of each hand-written kernel, counted per replay."""
    spec = _spec(name)
    graphs, g_launch, (p, _) = _round_trip(spec, cuda, 32, eager=False)
    eager, e_launch, _ = _round_trip(spec, cuda, 32, eager=True)
    _compare(graphs, eager)
    assert g_launch == e_launch
    per = 256 // S  # byte steps a stream: one fused launch each
    assert g_launch["encode"][4] == per and g_launch["decode"][4] == per
    fn = t_step.get_chunk_fn(p.plan, 32)
    want = {("encode", "byte")} | ({("encode", "wrap")} if spec.lstm is not None else set())
    assert set(fn.graphs) == want
    assert set(t_step.get_gen_chunk_fn(p.plan, 16).graphs) == {("sample",)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny-lstm", "tiny-ppm"])
def test_ppm_kernels_in_the_graphs_give_the_cpu_archive(cuda, name):
    """The PPM count update and prediction as csrc/ppm.cu's kernels inside
    the captured graphs (the prediction's rows gathered alone before the
    LSTM, or in the grouped gather without it): encode and decode of 300
    bytes on the card give the archive and the state of the eager CPU path,
    which runs the plain versions, and every byte step launches each kernel
    once."""
    spec = gt.tiny_spec(True)
    if name == "tiny-ppm":
        spec = dataclasses.replace(spec, lstm=None)
    data, chunk = _corpus(300, 8192), 50
    per = len(data) // S

    def launched(before):
        now = obs.launches()
        return [now.get(k, 0) - before.get(k, 0) for k in ("ppm_update", "ppm_predict")]

    p = codec.Predictor(spec, S, device=cuda)
    c0 = obs.launches()
    archive = gt.compress_bytes(data, spec, S, chunk, pred=p)
    assert launched(c0) == [per, per]
    host = codec.Predictor(spec, S, device="cpu")
    assert archive == gt.compress_bytes(data, spec, S, chunk, pred=host)
    # the analysis leaves go through log2f on the card and torch.log2 on the
    # CPU, which need not agree to the bit; every other leaf is bitwise
    card, cpu = _host_state(p.state), _host_state(host.state)
    analysis = {"metrics.ent", "metrics.ema"}
    for k in analysis & set(card):
        torch.testing.assert_close(card.pop(k), cpu.pop(k), rtol=1e-6, atol=0)
    _assert_same(card, cpu)
    c0 = obs.launches()
    assert gt.decompress_bytes(archive, spec, chunk, pred=codec.Predictor(spec, S, device=cuda)) == data
    assert launched(c0) == [per, per]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny-lstm", "tiny"])
def test_contexts_kernels_in_the_graphs_give_the_cpu_archive(cuda, name):
    """The boundary contexts and the match pointers as csrc/contexts.cu's
    kernels inside the captured graphs, with PPM and the LSTM (tiny-lstm)
    and without either (tiny): encode and decode of 300 bytes on the card
    give the archive and the state of the eager CPU path, which runs the
    plain versions, every byte step launches each kernel once, and every
    generated byte too."""
    spec = _spec(name)
    data, chunk = _corpus(300, 12288), 50
    per = len(data) // S

    def launched(before):
        now = obs.launches()
        return [now.get(k, 0) - before.get(k, 0) for k in ("contexts_boundary", "match_pointer")]

    p = codec.Predictor(spec, S, device=cuda)
    c0 = obs.launches()
    archive = gt.compress_bytes(data, spec, S, chunk, pred=p)
    assert launched(c0) == [per, per]
    host = codec.Predictor(spec, S, device="cpu")
    assert archive == gt.compress_bytes(data, spec, S, chunk, pred=host)
    card, cpu = _host_state(p.state), _host_state(host.state)
    for k in {"metrics.ent", "metrics.ema"} & set(card):  # log2f against torch.log2
        torch.testing.assert_close(card.pop(k), cpu.pop(k), rtol=1e-6, atol=0)
    _assert_same(card, cpu)
    c0 = obs.launches()
    assert gt.decompress_bytes(archive, spec, chunk, pred=codec.Predictor(spec, S, device=cuda)) == data
    assert launched(c0) == [per, per]
    c0 = obs.launches()
    gt.generate_bytes(p, b"", 16, chunk=16, seed=3)
    assert launched(c0) == [16, 16]


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["cond", "defer"])
def test_lstm_kernels_in_the_graphs_give_the_cpu_archive(cuda, order):
    """The LSTM's forward pass and output-layer SGD as csrc/lstm.cu's kernels
    inside the captured graphs, with the backward pass inside the byte that
    wraps the window (a chunk that is no multiple of the horizon) or after
    it: encode and decode on the card give the archive and the state of the
    eager CPU path, which runs the plain versions; every byte step launches
    each kernel once, and every generated byte the forward pass alone."""
    spec = _spec("tiny-lstm")
    chunk = 48 if order == "cond" else 50
    data = _corpus(6 * chunk, 16384)
    per = len(data) // S

    def launched(before):
        now = obs.launches()
        return [now.get(k, 0) - before.get(k, 0) for k in ("lstm_forward", "lstm_perceive")]

    p = codec.Predictor(spec, S, device=cuda)
    c0 = obs.launches()
    archive = gt.compress_bytes(data, spec, S, chunk, pred=p)
    assert launched(c0) == [per, per]
    host = codec.Predictor(spec, S, device="cpu")
    assert archive == gt.compress_bytes(data, spec, S, chunk, pred=host)
    card, cpu = _host_state(p.state), _host_state(host.state)
    for k in {"metrics.ent", "metrics.ema"} & set(card):  # log2f against torch.log2
        torch.testing.assert_close(card.pop(k), cpu.pop(k), rtol=1e-6, atol=0)
    _assert_same(card, cpu)
    c0 = obs.launches()
    assert gt.decompress_bytes(archive, spec, chunk, pred=codec.Predictor(spec, S, device=cuda)) == data
    assert launched(c0) == [per, per]
    c0 = obs.launches()
    gt.generate_bytes(p, b"", 16, chunk=16, seed=3)
    assert launched(c0) == [16, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny-lstm", "ref-full"])
def test_deferred_backward_pass_graphs_equal_the_eager_loop(cuda, name):
    """A chunk the horizon divides: the backward pass as a graph of its own
    after every horizon-th byte, equal to the eager loop's order."""
    spec = _spec(name)
    chunk = 2 * spec.lstm.horizon
    graphs, g_launch, (p, _) = _round_trip(spec, cuda, chunk, eager=False, n_bytes=2 * chunk)
    eager, e_launch, _ = _round_trip(spec, cuda, chunk, eager=True, n_bytes=2 * chunk)
    _compare(graphs, eager)
    assert g_launch == e_launch
    assert ("bptt",) in t_step.get_chunk_fn(p.plan, chunk).graphs
    assert int(graphs["encoded_state"]["stm.lstm.update_steps"]) == 2  # chunk / horizon windows a stream


@pytest.mark.cuda
def test_a_two_entry_mesh_on_one_card_replays_its_own_graphs(cuda):
    """Two shards on one card: each shard captures its own graphs on its
    device; the archive and decode are the unsharded predictor's."""
    spec = _spec("tiny-lstm")
    data = _corpus(120, 9000)
    one = codec.Predictor(spec, 4, device=cuda)
    two = codec.Predictor(spec, 4, sharding=stream_sharding(make_mesh(devices=[cuda, cuda])))
    blobs = [gt.compress_bytes(data, spec, 4, 16, pred=p) for p in (one, two)]
    assert blobs[0] == blobs[1]
    for shard in two.shards:
        fn = t_step.get_chunk_fn(shard.plan, 16)
        assert fn.graphs and fn.buf["t"].device == shard.device
    fresh = codec.Predictor(spec, 4, sharding=stream_sharding(make_mesh(devices=[cuda, cuda])))
    assert gt.decompress_bytes(blobs[0], spec, 16, pred=fresh) == data
    gens = [gt.generate_bytes(p, b"", 16, chunk=16, seed=2, return_all=True) for p in (one, two)]
    assert gens[0] == gens[1]


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["assigned", "loaded", "dict-leaf"])
def test_a_state_set_from_outside_between_chunks_is_taken(cuda, how, tmp_path):
    """After a chunk has captured the graphs, a state assigned to the
    predictor, loaded into it, or a leaf replaced in its dict: the next
    chunks code from that state, as a predictor that started from it does,
    and every leaf keeps its storage."""
    spec = _spec("tiny-lstm")
    data = np.frombuffer(_corpus(S * 64, 2000), np.uint8).reshape(S, 64).copy()
    p = codec.Predictor(spec, S, device=cuda)
    other = codec.Predictor(spec, S, device=cuda)
    code = torch.zeros((S, 1), dtype=torch.uint8, device=cuda)
    codec.run_chunks(p, torch.tensor(data, device=cuda), code, 16, False, chunk=16)
    codec.run_chunks(other, torch.tensor(data[::-1].copy(), device=cuda), code, 32, False, chunk=16)
    ptrs = {k: v.data_ptr() for k, v in _leaves(p.state) if v.numel()}
    if how == "assigned":
        p.state = copy_state(other.state)
    elif how == "loaded":
        other.save(str(tmp_path / "o.gxt"))
        p.load(str(tmp_path / "o.gxt"))
    else:
        for (d, k, _), (_, _, v) in zip(t_step._leaf_refs(p.state), t_step._leaf_refs(copy_state(other.state))):
            d[k] = v
    ref = other.copy()
    _, _, got = codec.run_chunks(p, torch.tensor(data, device=cuda), code, 32, False, t0=32, chunk=16)
    _, _, want = codec.run_chunks(ref, torch.tensor(data, device=cuda), code, 32, False, t0=32, chunk=16)
    assert got == want
    _assert_same(_host_state(p.state), _host_state(ref.state))
    assert {k: v.data_ptr() for k, v in _leaves(p.state) if v.numel()} == ptrs


@pytest.mark.cuda
def test_a_capture_that_reads_the_device_raises(cuda):
    """A host read inside a capture is an error, not a quiet eager step; the
    launch counters are left as they were."""
    plan = t_step.StepPlan(build_meta(gt.tiny_spec(False)), S, cuda)
    before = _counts()
    x = torch.ones((), device=cuda)
    with pytest.raises(RuntimeError):
        t_step.CapturedStep(plan, lambda: float(x * 2), "encode/byte")
    assert _counts() == before
