"""Stream sharding in the port (`gmix_tpu_torch.parallel.mesh`, `Predictor(...,
sharding=)`) on a mesh of four CPU entries, against the unsharded port and
against gmix_tpu's sharded codec on its 8 virtual CPU devices.

The streams never interact, so a sharded predictor must give the unsharded
one's archives, checkpoints, generated bytes and metrics bit for bit. Against
gmix_tpu (jitted, so FMA-contracted on the CPU) the archives agree within
contract 1: 1% in size, 0.5% in total cross-entropy."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gmix_tpu as g
from gmix_tpu.core.meta import build_meta as j_build_meta
from gmix_tpu.parallel import mesh as j_mesh
import gmix_tpu_torch as gt
from gmix_tpu_torch.core.codec import Predictor, analysis_snapshot, memory_report, run_chunks
from gmix_tpu_torch.core.meta import build_meta
from gmix_tpu_torch.parallel.mesh import (broadcast_pretrained, gather_state, make_mesh, shard_rows, shard_state,
                                          state_specs, stream_sharding)
from gmix_tpu_torch.state import init_state, state_to_numpy

torch.set_num_threads(1)

S, SHARDS, N = 8, 4, 160
# (spec, chunk): tiny_spec(True) with both orders of the LSTM's backward pass
# (horizon 10: chunk 20 defers it to the segment ends, 25 runs it inside the
# wrapping byte)
CONFIGS = {"plain": (lambda: gt.tiny_spec(False), 20), "lstm-defer": (lambda: gt.tiny_spec(True), 20),
           "lstm-cond": (lambda: gt.tiny_spec(True), 25)}


def _corpus(n, offset=0):
    with open("data/corpus_100k.bin", "rb") as f:
        return f.read(offset + n)[offset:]


def _mesh(n=SHARDS):
    return make_mesh(devices=["cpu"] * n)


def _sharded(spec, n=SHARDS, streams=S):
    return Predictor(spec, streams, sharding=stream_sharding(_mesh(n)))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_same_state(want, got):
    _assert_same_leaves(state_to_numpy(want), state_to_numpy(got))


def _assert_same_leaves(want, got):
    """Two states as numpy trees: the same leaves, shapes, dtypes and bits."""
    want, got = dict(_leaves(want)), dict(_leaves(got))
    assert sorted(want) == sorted(got)
    for k, a in want.items():
        b = got[k]
        assert (a.shape, a.dtype) == (b.shape, b.dtype), k
        assert np.array_equal(np.ascontiguousarray(a).view(np.uint8), np.ascontiguousarray(b).view(np.uint8)), k


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def run(request):
    """The unsharded and the 4-shard predictor of one config after coding N
    bytes, and their archives."""
    make, chunk = CONFIGS[request.param]
    spec = make()
    data = _corpus(N)
    pu = Predictor(spec, S, device="cpu")
    blob_u = gt.compress_bytes(data, spec, S, chunk, pred=pu)
    ps = _sharded(spec)
    blob_s = gt.compress_bytes(data, spec, S, chunk, pred=ps)
    return dict(name=request.param, spec=spec, chunk=chunk, data=data, pu=pu, ps=ps, blob_u=blob_u, blob_s=blob_s)


def test_sharded_archive_is_the_unsharded_archive(run):
    assert len(run["ps"].shards) == SHARDS and all(p.num_streams == S // SHARDS for p in run["ps"].shards)
    assert run["blob_s"] == run["blob_u"]


def _flat_sizes(tree, prefix, out):
    """gmix_tpu's memory.tsv names (`jax.tree_util.keystr`) -> bytes."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat_sizes(v, f"{prefix}['{k}']", out)
        else:
            out[f"{prefix}['{k}']"] = v.size * v.dtype.itemsize


def test_each_decodes_the_others_archive(run):
    spec, chunk, data = run["spec"], run["chunk"], run["data"]
    assert gt.decompress_bytes(run["blob_s"], spec, chunk, device="cpu") == data
    assert gt.decompress_bytes(run["blob_u"], spec, chunk, pred=_sharded(spec)) == data


def test_metrics_and_state_are_the_unsharded_ones(run):
    """entropy_bits (one float64 sum over the streams in stream order),
    analysis_snapshot, memory_report (gmix_tpu's bytes of each leaf, over
    the shards) and memory_bytes (the devices' bytes) equal exactly, and the
    gathered state equals the unsharded one leaf for leaf."""
    pu, ps = run["pu"], run["ps"]
    assert gt.entropy_bits(ps) == gt.entropy_bits(pu) > 0
    assert np.array_equal(analysis_snapshot(ps), analysis_snapshot(pu))
    assert memory_report(ps) == memory_report(pu)
    gmix = {}
    _flat_sizes(state_to_numpy(gather_state(ps.state)), "", gmix)
    assert dict(memory_report(ps)) == gmix
    assert ps.memory_bytes() == pu.memory_bytes()
    _assert_same_state(pu.state, gather_state(ps.state))


def test_sharded_checkpoint_is_the_unsharded_file(run, tmp_path):
    """The same file; it loads into a mesh of another size and into an
    unsharded predictor, each then holding the saved state."""
    pu, ps, spec = run["pu"], run["ps"], run["spec"]
    pu.save(str(tmp_path / "u.gxt"))
    ps.save(str(tmp_path / "s.gxt"))
    assert (tmp_path / "u.gxt").read_bytes() == (tmp_path / "s.gxt").read_bytes()
    two = _sharded(spec, n=2)
    two.load(str(tmp_path / "s.gxt"))
    assert [p.num_streams for p in two.shards] == [4, 4]
    _assert_same_state(pu.state, gather_state(two.state))
    one = Predictor(spec, S, device="cpu")
    one.load(str(tmp_path / "s.gxt"))
    _assert_same_state(pu.state, one.state)
    with pytest.raises(RuntimeError, match="mismatch at"):
        _sharded(spec, n=2, streams=4).load(str(tmp_path / "s.gxt"))


def test_generate_bytes_of_a_sharded_copy_is_the_unsharded(run, tmp_path):
    """generate_bytes on copies of the trained predictors: every stream's
    bytes equal (each shard takes its columns of the one uniform draw), so
    do the states after it; the copies leave their parents as they were."""
    pu, ps = run["pu"], run["ps"]
    ps.save(str(tmp_path / "before.gxt"))
    cu, cs = pu.copy(), ps.copy()
    assert cs.sharding is ps.sharding and len(cs.shards) == SHARDS
    prompt = _corpus(5, offset=N)
    want = gt.generate_bytes(cu, prompt, 5, temperature=0.8, chunk=5, seed=7, return_all=True)
    got = gt.generate_bytes(cs, prompt, 5, temperature=0.8, chunk=5, seed=7, return_all=True)
    assert got == want and len(got) == S and all(len(b) == 5 for b in got)
    assert len(set(want)) > 1  # the streams draw different uniforms
    _assert_same_state(cu.state, gather_state(cs.state))
    ps.save(str(tmp_path / "after.gxt"))
    assert (tmp_path / "before.gxt").read_bytes() == (tmp_path / "after.gxt").read_bytes()


@pytest.mark.parametrize("run", ["plain", "lstm-defer"], indirect=True)
def test_sharded_archive_within_contract_1_of_gmix_tpus_sharded(run):
    """gmix_tpu's `Predictor(spec, 8, sharding=stream_sharding(make_mesh(8)))`
    against the port's 4-shard predictor: the same header, sizes within 1%,
    cross-entropy within 0.5% (the LSTM in the deferred order of its
    backward pass, which gmix_tpu compiles fastest)."""
    j_spec = g.tiny_spec(run["spec"].lstm is not None)
    jp = g.Predictor(j_spec, S, sharding=j_mesh.stream_sharding(j_mesh.make_mesh(8)))
    j_blob = g.compress_bytes(run["data"], j_spec, S, run["chunk"], pred=jp)
    blob = run["blob_s"]
    assert blob[:40] == j_blob[:40]
    assert abs(len(blob) - len(j_blob)) <= 0.01 * len(j_blob)
    assert abs(gt.entropy_bits(run["ps"]) - g.entropy_bits(jp)) <= 0.005 * g.entropy_bits(jp)


def test_run_chunks_takes_one_buffer_per_shard():
    """A sharded predictor's run_chunks takes and returns a list of buffers,
    one per shard on its device; the payloads are the unsharded ones."""
    spec = gt.tiny_spec(False)
    arr = np.frombuffer(_corpus(S * 8), np.uint8).reshape(S, 8).copy()
    pu, ps = Predictor(spec, S, device="cpu"), _sharded(spec)
    d, c, want = run_chunks(pu, torch.as_tensor(arr), torch.zeros((S, 1), dtype=torch.uint8), 8, False, chunk=8)
    bufs = [torch.as_tensor(arr[a:b]) for a, b in shard_rows(S, ps.sharding.mesh)]
    codes = [torch.zeros((b - a, 1), dtype=torch.uint8) for a, b in shard_rows(S, ps.sharding.mesh)]
    ds, cs, got = run_chunks(ps, bufs, codes, 8, False, chunk=8)
    assert got == want and len(ds) == len(cs) == SHARDS
    with pytest.raises(ValueError, match="for 4 shards"):
        run_chunks(ps, bufs[:2], codes[:2], 8, False, chunk=8)


def test_placement_is_gmix_tpus_state_specs():
    """Every leaf of the port's state is 0-d or has the streams on axis 0,
    so the port's rule (split a leaf with S on axis 0, replicate the rest)
    and gmix_tpu's looser `shard_state` rule (`shape[0] % n == 0`) agree;
    the placement equals gmix_tpu's `_state_specs` at tiny_spec(True)."""
    for streams in (S, 3):
        st = init_state(build_meta(gt.tiny_spec(True)), streams, device="meta")
        assert all(t.dim() == 0 or t.shape[0] == streams for _, t in _leaves(st))
    port = dict(_leaves(state_specs(init_state(build_meta(gt.tiny_spec(True)), S, device="meta"), S)))
    specs = j_mesh._state_specs(j_build_meta(g.tiny_spec(True)), S, "streams")
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    want = {"/".join(k.key for k in path): ("streams" if tuple(p) == ("streams",) else None) for path, p in flat}
    assert port == want
    assert sorted(k for k, v in port.items() if v is None) == ["stm/lstm/epoch", "stm/lstm/update_steps"]


def test_broadcast_pretrained_over_a_mesh_matches_gmix_tpu():
    """A 1-stream tiny_spec(True) state after 20 bytes, tiled to 8 streams
    over the 4-entry mesh: shard i holds streams 2i, 2i+1, each tiled on its
    device, and the gathered state equals gmix_tpu's
    `broadcast_pretrained(state, 8, mesh)` leaf for leaf."""
    spec = gt.tiny_spec(True)
    one = Predictor(spec, 1, device="cpu")
    gt.compress_bytes(_corpus(20), spec, 1, 20, pred=one)
    shards = broadcast_pretrained(one.state, S, _mesh())
    assert len(shards) == SHARDS and all(st["ltm"]["mix_w"].shape[0] == 2 for st in shards)
    assert shards[0]["ltm"]["mix_w"].data_ptr() != shards[1]["ltm"]["mix_w"].data_ptr()
    want = j_mesh.broadcast_pretrained(jax.tree_util.tree_map(jnp.asarray, state_to_numpy(one.state)), S,
                                       mesh=j_mesh.make_mesh(8))
    _assert_same_leaves(jax.tree_util.tree_map(np.asarray, jax.device_get(want)), state_to_numpy(gather_state(shards)))
    _assert_same_state(broadcast_pretrained(one.state, S), gather_state(shards))
    # a sharded predictor takes the tiled shards as its state
    p = _sharded(spec)
    p.state = shards
    assert p.shards[3].state is shards[3]


def test_shard_state_and_gather_state_are_inverse():
    st = init_state(build_meta(gt.tiny_spec(True)), S, device="cpu")
    st["ltm"]["mix_w"].normal_(generator=torch.Generator().manual_seed(1))
    shards = shard_state(st, _mesh())
    assert [s["ltm"]["mix_w"].shape[0] for s in shards] == [2] * SHARDS
    assert torch.equal(shards[1]["ltm"]["mix_w"], st["ltm"]["mix_w"][2:4])
    assert shards[0]["stm"]["lstm"]["epoch"] is not shards[1]["stm"]["lstm"]["epoch"]
    assert shards[0]["ltm"]["mix_w"].data_ptr() != st["ltm"]["mix_w"].data_ptr()
    _assert_same_state(st, gather_state(shards))
    shards[2]["stm"]["lstm"]["update_steps"] = shards[2]["stm"]["lstm"]["update_steps"] + 1
    with pytest.raises(RuntimeError, match="update_steps differs between shards 0 and 2"):
        gather_state(shards)


def test_streams_must_divide_over_the_mesh():
    spec = gt.tiny_spec(False)
    with pytest.raises(ValueError, match="do not split over a mesh of 4"):
        _sharded(spec, streams=6)
    with pytest.raises(ValueError, match="do not split"):
        broadcast_pretrained(Predictor(spec, 1, device="cpu").state, 6, _mesh())
    with pytest.raises(ValueError, match="pass no device"):
        Predictor(spec, S, device="cpu", sharding=stream_sharding(_mesh()))


def test_make_mesh_takes_cuda_devices_and_never_the_cpu():
    """Without `devices` a mesh is of CUDA devices; with none present it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        mesh = make_mesh()
        assert mesh.size == torch.cuda.device_count() and all(d.type == "cuda" for d in mesh.devices)
        with pytest.raises(RuntimeError, match="CUDA devices asked for"):
            make_mesh(torch.cuda.device_count() + 1)
        return
    with pytest.raises(RuntimeError, match="CUDA devices asked for, 0 present"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA devices asked for, 0 present"):
        make_mesh(2)
    mesh = make_mesh(devices=["cpu", "cpu"], axis="s")
    assert mesh.devices == (torch.device("cpu"),) * 2 and mesh.axis == "s" and mesh.size == 2
    with pytest.raises(ValueError, match="n_devices=3"):
        make_mesh(3, devices=["cpu", "cpu"])
