"""Checkpoints of the port: the same file as gmix_tpu's, both ways, and the
reference tester's restart invariants (tests/test_invariants.py:88-135)
re-targeted at the port on the CPU; `broadcast_pretrained` against
gmix_tpu's; a predictor's copy beside its parent."""
import dataclasses
import os
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gmix_tpu as g
from gmix_tpu.parallel.mesh import broadcast_pretrained as j_broadcast_pretrained
from gmix_tpu.utils import serialization as j_ser
import gmix_tpu_torch as gt
from gmix_tpu_torch.core import step as t_step
from gmix_tpu_torch.core.codec import Predictor, _pad_streams, run_chunks
from gmix_tpu_torch.ops import coder as coder_ops
from gmix_tpu_torch.state import state_from_numpy, state_to_numpy
from gmix_tpu_torch.utils import serialization as t_ser

torch.set_num_threads(1)

CHUNK = 32
N_INV = 128  # bytes a pass of the invariants (one stream, tiny_spec(True))


def _corpus(n):
    with open("data/corpus_100k.bin", "rb") as f:
        return f.read(n)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.ascontiguousarray(v)


def _assert_same_leaves(want, got):
    want, got = dict(_flat(want)), dict(_flat(got))
    assert sorted(want) == sorted(got)
    for k, a in want.items():
        b = got[k]
        assert (a.shape, a.dtype) == (b.shape, b.dtype), k
        assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)), k


@pytest.fixture(scope="module")
def trained():
    """tiny_spec(True) at 4 streams after 64 bytes a stream: `mix_w` (1 MiB)
    goes to disk sparse, the LSTM's `epoch` and `update_steps` are 0-d."""
    spec = gt.tiny_spec(True)
    pred = Predictor(spec, 4, device="cpu")
    gt.compress_bytes(_corpus(256), spec, 4, 32, pred=pred)
    return pred


def test_port_checkpoint_is_gmix_tpus_file(trained, tmp_path):
    """From the same state the port writes gmix_tpu's file byte for byte,
    with at least one sparse leaf and the 0-d leaves; gmix_tpu's file loads
    in the port leaf for leaf."""
    mine, theirs = tmp_path / "port.gxt", tmp_path / "gmix.gxt"
    trained.save(str(mine))
    j_ser.save_state(str(theirs), state_to_numpy(trained.state))
    assert mine.read_bytes() == theirs.read_bytes()
    names = zipfile.ZipFile(mine).namelist()
    assert "ltm/mix_w.sp.idx" in names and "stm/lstm/epoch.npy0" in names
    leaves = [n.rpartition(".sp.")[0] or n.rpartition(".")[0] for n in names]
    assert leaves == sorted(leaves)  # leaves in sorted order, a sparse leaf's four members together
    assert zipfile.ZipFile(mine).comment == b"gmix-tpu-ckpt v3"
    _assert_same_leaves(j_ser.load_state(str(theirs)), t_ser.load_state(str(theirs)))
    fresh = Predictor(gt.tiny_spec(True), 4, device="cpu")
    fresh.load(str(theirs))
    _assert_same_leaves(state_to_numpy(trained.state), state_to_numpy(fresh.state))


def test_save_load_save_is_the_identity(trained, tmp_path):
    a, b = tmp_path / "a.gxt", tmp_path / "b.gxt"
    trained.save(str(a))
    other = Predictor(gt.tiny_spec(True), 4, device="cpu")
    other.load(str(a))
    other.save(str(b))
    assert a.read_bytes() == b.read_bytes()
    assert other.memory_bytes() == trained.memory_bytes()


def test_foreign_or_mismatched_checkpoints_raise(trained, tmp_path):
    foreign = tmp_path / "foreign.gxt"
    with zipfile.ZipFile(foreign, "w") as zf:
        zf.writestr("stm/x.npy", b"\x93NUMPY junk")
    with pytest.raises(gt.CheckpointVersionError, match="versioned format"):
        Predictor(gt.tiny_spec(True), 4, device="cpu").load(str(foreign))
    ck = tmp_path / "ck.gxt"
    trained.save(str(ck))
    with pytest.raises(RuntimeError, match="does not match the spec"):
        Predictor(gt.tiny_spec(False), 4, device="cpu").load(str(ck))
    with pytest.raises(RuntimeError, match="mismatch at"):
        Predictor(gt.tiny_spec(True), 2, device="cpu").load(str(ck))


def test_broadcast_pretrained_matches_gmix_tpu():
    spec = dataclasses.replace(gt.tiny_spec(True), lstm=None)
    one = Predictor(spec, 1, device="cpu")
    gt.compress_bytes(_corpus(40), spec, 1, 40, pred=one)
    got = gt.broadcast_pretrained(one.state, 3)
    want = j_broadcast_pretrained(jax.tree_util.tree_map(jnp.asarray, state_to_numpy(one.state)), 3)
    _assert_same_leaves(jax.device_get(want), state_to_numpy(got))
    lstm = Predictor(gt.tiny_spec(True), 1, device="cpu").state
    tiled = gt.broadcast_pretrained(lstm, 3)
    assert tiled["stm"]["lstm"]["epoch"].shape == () and tiled["ltm"]["lstm"]["out_w"].shape[0] == 3
    assert tiled["ltm"]["mix_w"].data_ptr() != lstm["ltm"]["mix_w"].data_ptr()


def test_copy_runs_beside_its_parent_without_reading_the_device(trained, monkeypatch):
    """A copy shares no tensor with its parent and has its own epoch: the
    two step in turn, as gmix_tpu's trainer runs them, and no byte step of
    either converts a tensor to a Python number; both end as one predictor
    stepped alone would."""
    parent = trained.copy()
    copy = parent.copy()
    leaves = [t for _, t in _flat_tensors(parent.state)]
    assert all(a.data_ptr() != b.data_ptr() for a, (_, b) in zip(leaves, _flat_tensors(copy.state)) if a.numel())
    data = torch.tensor(np.frombuffer(_corpus(4 * 80), np.uint8).reshape(4, 80).copy())
    code = torch.zeros((4, 8), dtype=torch.uint8)
    t_step._byte_step(parent.state, data, code, 64, False, parent.plan)  # the parent's leaf is its own from here

    def no_read(*a, **k):
        raise AssertionError("a tensor was read back to the host inside a byte step")

    with monkeypatch.context() as m:
        for name in ("item", "__int__", "__index__", "__float__", "__bool__", "tolist"):
            m.setattr(torch.Tensor, name, no_read)
        t_step._byte_step(copy.state, data.clone(), code, 64, False, copy.plan)
        for t in range(65, 76):  # across the horizon's wrap (10) and its backward pass
            t_step._byte_step(parent.state, data, code, t, False, parent.plan)
            t_step._byte_step(copy.state, data.clone(), code, t, False, copy.plan)
    _assert_same_leaves(state_to_numpy(parent.state), state_to_numpy(copy.state))


def _flat_tensors(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_tensors(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------------------
# the tester's restart invariants (tests/test_invariants.py), on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def oneshot():
    """The archive of DATA coded in one go."""
    spec = gt.tiny_spec(True)
    return gt.compress_bytes(_corpus(N_INV), spec, 1, CHUNK, device="cpu")


@pytest.fixture(scope="module")
def halfway():
    """A predictor stopped at the chunk boundary nearest half of DATA."""
    arr, per = _pad_streams(_corpus(N_INV), 1, CHUNK)
    pred = Predictor(gt.tiny_spec(True), 1, device="cpu")
    data_buf = torch.as_tensor(arr)
    code_buf = torch.zeros((1, 1), dtype=torch.uint8)
    half = (per // 2 // CHUNK) * CHUNK
    _, _, body_a = run_chunks(pred, data_buf, code_buf, half, decode=False, chunk=CHUNK)
    return pred, arr, per, half, body_a[0]


def _finish(pred2, halfway):
    _, arr, per, half, body_a = halfway
    _, _, body_b = run_chunks(pred2, torch.as_tensor(arr), torch.zeros((1, 1), dtype=torch.uint8), per - half,
                              decode=False, t0=half, chunk=CHUNK)
    coder = {k: v.numpy() for k, v in pred2.state["coder"].items()}
    return body_a + body_b[0] + coder_ops.flush_bytes(coder["x1"], coder["x2"])[0]


def test_checkpoint_restart_bitexact(oneshot, halfway, tmp_path):
    """Invariant 2: a checkpoint mid-stream restarted in a fresh predictor
    gives the same archive, and serialize . deserialize = identity."""
    ck, ck2 = str(tmp_path / "ck.gxt"), str(tmp_path / "ck2.gxt")
    halfway[0].save(ck)
    pred2 = Predictor(gt.tiny_spec(True), 1, device="cpu")
    pred2.load(ck)
    pred2.save(ck2)
    assert open(ck, "rb").read() == open(ck2, "rb").read()
    assert _finish(pred2, halfway) == oneshot[48:]


def test_copy_restart_bitexact(oneshot, halfway):
    """Invariant 3: an in-memory copy behaves as the disk roundtrip."""
    assert _finish(halfway[0].copy(), halfway) == oneshot[48:]


def test_decompression_with_restart(oneshot, tmp_path):
    """Invariant 4: decoding survives a checkpoint and restart mid-stream."""
    spec = gt.tiny_spec(True)
    payload = oneshot[48:]
    per = int.from_bytes(oneshot[16:24], "little")  # the GXTC header's per-stream length
    pred = Predictor(spec, 1, device="cpu")
    codes = np.zeros((1, len(payload) + 8), np.uint8)
    codes[0, : len(payload)] = np.frombuffer(payload, np.uint8)
    pred.state["coder"]["x"] = torch.tensor([int.from_bytes(payload[:4], "big")], dtype=torch.int64)
    pred.state["coder"]["rpos"] = torch.full((1,), 4, dtype=torch.int64)
    data_buf = torch.zeros((1, per), dtype=torch.uint8)
    code_buf = torch.as_tensor(codes)
    half = (per // 2 // CHUNK) * CHUNK
    run_chunks(pred, data_buf, code_buf, half, decode=True, chunk=CHUNK)
    ck = str(tmp_path / "dck.gxt")
    pred.save(ck)
    pred2 = Predictor(spec, 1, device="cpu")
    pred2.load(ck)
    run_chunks(pred2, data_buf, code_buf, per - half, decode=True, t0=half, chunk=CHUNK)
    assert data_buf.numpy().reshape(-1)[:N_INV].tobytes() == _corpus(N_INV)
