"""The port's compress/decompress: exact self-roundtrips, the GXTC container
layout, and agreement with gmix_tpu's jitted codec in size and entropy.

Jitted gmix_tpu contracts a*b+c into fused multiply-adds on the CPU, which
the port (like gmix_tpu run eagerly) does not, so the two archives are not
byte-identical; they must agree in size and total cross-entropy.

With an LSTM (`tiny_spec(True)`) `chunk` also picks the order of the
backward pass, by the same rule in both packages: a chunk the horizon
divides defers it to the segment ends, any other chunk runs it inside the
byte that wraps the window."""
import dataclasses
import struct

import numpy as np
import pytest
import torch

import gmix_tpu as g
import gmix_tpu_torch as gt
from gmix_tpu_torch.core.codec import MAGIC, VERSION, Predictor

torch.set_num_threads(1)

S, CHUNK, N = 2, 40, 640


@pytest.fixture(scope="module")
def corpus():
    with open("data/corpus_100k.bin", "rb") as f:
        return f.read(N)


@pytest.fixture(scope="module")
def port_run(corpus):
    pred = Predictor(gt.tiny_spec(False), S, device="cpu")
    blob = gt.compress_bytes(corpus, gt.tiny_spec(False), S, CHUNK, pred=pred)
    return blob, gt.entropy_bits(pred)


def test_roundtrip_exact(port_run, corpus):
    blob, _ = port_run
    assert gt.decompress_bytes(blob, gt.tiny_spec(False), CHUNK, device="cpu") == corpus


@pytest.mark.parametrize("data", [b"", b"x"])
def test_roundtrip_empty_and_one_byte(data):
    spec = gt.tiny_spec(False)
    blob = gt.compress_bytes(data, spec, S, CHUNK, device="cpu")
    assert gt.decompress_bytes(blob, spec, CHUNK, device="cpu") == data


def test_size_and_entropy_close_to_jitted_gmix_tpu(port_run, corpus):
    blob, ent = port_run
    jp = g.Predictor(g.tiny_spec(False), S)
    j_blob = g.compress_bytes(corpus, g.tiny_spec(False), S, CHUNK, pred=jp)
    j_ent = g.entropy_bits(jp)
    assert abs(len(blob) - len(j_blob)) <= 0.01 * len(j_blob)
    assert abs(ent - j_ent) <= 0.005 * j_ent


def test_ppm_spec_roundtrips_and_stays_close_to_jitted_gmix_tpu(corpus):
    """The tiny spec with its PPM byte model (no LSTM): exact self round trip,
    archive within 1% in size and 0.5% in total cross-entropy of gmix_tpu's."""
    data = corpus[:320]
    spec = dataclasses.replace(gt.tiny_spec(True), lstm=None)
    pred = Predictor(spec, S, device="cpu")
    blob = gt.compress_bytes(data, spec, S, CHUNK, pred=pred)
    assert gt.decompress_bytes(blob, spec, CHUNK, device="cpu") == data
    j_spec = dataclasses.replace(g.tiny_spec(True), lstm=None)
    jp = g.Predictor(j_spec, S)
    j_blob = g.compress_bytes(data, j_spec, S, CHUNK, pred=jp)
    assert abs(len(blob) - len(j_blob)) <= 0.01 * len(j_blob)
    assert abs(gt.entropy_bits(pred) - g.entropy_bits(jp)) <= 0.005 * g.entropy_bits(jp)
    assert blob[:40] == j_blob[:40]  # the same header: container, sizes, spec hash


# with the LSTM (horizon 10): 120 bytes a stream, a multiple of both chunks, so
# both runs code the same bytes and differ only in the backward pass's order
N_LSTM = 240
LSTM_CHUNKS = {"defer": 40, "cond": 24}


@pytest.fixture(scope="module")
def lstm_runs(corpus):
    """(archive, entropy, LSTM gate weights) of the port and of jitted
    gmix_tpu at tiny_spec(True), for a chunk of each backward-pass order."""
    data = corpus[:N_LSTM]
    out = {}
    for mode, chunk in LSTM_CHUNKS.items():
        pred = Predictor(gt.tiny_spec(True), S, device="cpu")
        blob = gt.compress_bytes(data, gt.tiny_spec(True), S, chunk, pred=pred)
        jp = g.Predictor(g.tiny_spec(True), S)
        j_blob = g.compress_bytes(data, g.tiny_spec(True), S, chunk, pred=jp)
        out[mode] = dict(
            blob=blob, ent=gt.entropy_bits(pred), w_in=pred.state["ltm"]["lstm"]["w_in"].numpy(),
            steps=int(pred.state["stm"]["lstm"]["update_steps"]),
            j_blob=j_blob, j_ent=g.entropy_bits(jp), j_w_in=np.asarray(jp.state["ltm"]["lstm"]["w_in"]),
            j_steps=int(jp.state["stm"]["lstm"]["update_steps"]),
        )
    return out


@pytest.mark.parametrize("mode", sorted(LSTM_CHUNKS))
def test_lstm_spec_roundtrips_exactly(lstm_runs, corpus, mode):
    blob = lstm_runs[mode]["blob"]
    assert gt.decompress_bytes(blob, gt.tiny_spec(True), LSTM_CHUNKS[mode], device="cpu") == corpus[:N_LSTM]


@pytest.mark.parametrize("mode", sorted(LSTM_CHUNKS))
def test_lstm_spec_stays_close_to_jitted_gmix_tpu(lstm_runs, mode):
    """Archive within 1% in size and 0.5% in total cross-entropy of jitted
    gmix_tpu's at the same chunk; the same header; 12 backward passes each."""
    r = lstm_runs[mode]
    assert abs(len(r["blob"]) - len(r["j_blob"])) <= 0.01 * len(r["j_blob"])
    assert abs(r["ent"] - r["j_ent"]) <= 0.005 * r["j_ent"]
    assert r["blob"][:40] == r["j_blob"][:40]
    assert r["steps"] == r["j_steps"] == N_LSTM // S // 10


def test_lstm_backward_pass_order_follows_chunk_as_in_gmix_tpu(lstm_runs):
    """gmix_tpu's docstrings call the two orders equivalent; they are not
    (the deferred pass reads the output weights the wrapping byte's SGD has
    just written): after 120 bytes a stream the gate weights of its two runs
    differ by far more than either differs from the port's run at the same
    chunk (tolerance: 1e-5 absolute on weights of size 0.1-1; seen 1.8e-7,
    against 1.7e-2 between the orders), and the port's two runs differ
    likewise."""
    d, c = lstm_runs["defer"], lstm_runs["cond"]
    same = max(np.abs(d["w_in"] - d["j_w_in"]).max(), np.abs(c["w_in"] - c["j_w_in"]).max())
    assert same <= 1e-5
    assert np.abs(d["j_w_in"] - c["j_w_in"]).max() > 1e-3
    assert np.abs(d["w_in"] - c["w_in"]).max() > 1e-3
    assert np.abs(d["w_in"] - c["j_w_in"]).max() > 1e-3


def test_deferred_backward_pass_needs_an_aligned_start():
    """The deferred order counts horizon-long segments from `t0`."""
    from gmix_tpu_torch.core.codec import run_chunks

    pred = Predictor(gt.tiny_spec(True), S, device="cpu")
    data = torch.zeros((S, 40), dtype=torch.uint8)
    code = torch.zeros((S, 1), dtype=torch.uint8)
    with pytest.raises(ValueError, match="horizon"):
        run_chunks(pred, data, code, 20, decode=False, t0=5, chunk=20)
    run_chunks(pred, data, code, 20, decode=False, t0=10, chunk=20)
    assert int(pred.state["stm"]["lstm"]["update_steps"]) == 2
    # learning off: no byte end, no backward pass, any start
    run_chunks(pred, data, code, 8, decode=False, learn=False, t0=3, chunk=8)
    assert int(pred.state["stm"]["lstm"]["update_steps"]) == 2


def test_header_layout_matches_gmix_tpu(port_run, corpus):
    blob, _ = port_run
    j_blob = g.compress_bytes(b"", g.tiny_spec(False), S, CHUNK)
    assert gt.compress_bytes(b"", gt.tiny_spec(False), S, CHUNK) == j_blob
    ver, flags, s, orig, per, spec_hash, rsv = struct.unpack("<BBHQQQQ", blob[4:40])
    assert blob[:4] == MAGIC == b"GXTC" and ver == VERSION == 4
    assert (flags, s, orig, per, rsv) == (0, S, N, N // S, 0)
    assert spec_hash == g.tiny_spec(False).stable_hash()
    sizes = struct.unpack(f"<{S}Q", blob[40 : 40 + 8 * S])
    assert 40 + 8 * S + sum(sizes) == len(blob)


def test_bad_magic_and_spec_mismatch_raise(port_run):
    blob, _ = port_run
    with pytest.raises(ValueError, match="bad magic"):
        gt.decompress_bytes(b"XXXX" + blob[4:], gt.tiny_spec(False), CHUNK)
    other = gt.scale_tables(gt.tiny_spec(False), 4)
    with pytest.raises(ValueError, match="spec mismatch"):
        gt.decompress_bytes(blob, other, CHUNK)


def test_entry_points_default_to_cuda_and_raise_without_it():
    """The port runs on the card unless the caller asks for the CPU: with no
    `device` and no CUDA device it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert Predictor(gt.tiny_spec(False), S).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA device"):
        Predictor(gt.tiny_spec(False), S)
    with pytest.raises(RuntimeError, match="CUDA device"):
        gt.compress_bytes(b"abc", gt.tiny_spec(False), S, CHUNK)
