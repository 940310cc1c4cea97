"""The port's compress/decompress: exact self-roundtrips, the GXTC container
layout, and agreement with gmix_tpu's jitted codec in size and entropy.

Jitted gmix_tpu contracts a*b+c into fused multiply-adds on the CPU, which
the port (like gmix_tpu run eagerly) does not, so the two archives are not
byte-identical; they must agree in size and total cross-entropy."""
import dataclasses
import struct

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
