"""The frozen reference gives the program's archive byte for byte at a tiny
spec on the CPU (every model kind, PPM, the LSTM with its deferred backward
pass, two APM stages), and its prefixes are prefixes of the payloads; the
same at the shape of gmix-ref-noppm (the tiny spec without the LSTM, PPM
and the rolling contexts that only PPM reads, its two APM stages kept)."""
import dataclasses
import json

import pytest

from gmix_tpu_torch.config import tiny_spec
from gmix_tpu_torch.core.codec import Predictor, compress_bytes
from h100_bench import check
from h100_bench.reference import codec as ref
from h100_bench.reference.config import spec_from_dict

SEED = 2**33 + 17


def _archive(spec):
    data = open(check.__file__.replace("check.py", "data/corpus_1m.bin"), "rb").read()[7000 : 7000 + 3 * 40]
    pred = Predictor(spec, 3, seed=SEED, device="cpu", analysis=False)
    return spec, data, compress_bytes(data, spec, 3, 20, pred=pred)


@pytest.fixture(scope="module")
def archive():
    return _archive(tiny_spec(True))


@pytest.fixture(scope="module")
def noppm_archive():
    spec = dataclasses.replace(tiny_spec(True), lstm=None, ppm=None, roll_ctxs=())
    assert len(spec.apm) == 2
    return _archive(spec)


def test_reference_is_the_programs_archive(archive):
    _reference_is_the_archive(archive)


def test_reference_is_the_programs_archive_without_lstm_and_ppm(noppm_archive):
    _reference_is_the_archive(noppm_archive)


def test_judge_reads_zero_on_the_programs_archive(archive):
    _judge_reads_zero(archive)


def test_judge_reads_zero_without_lstm_and_ppm(noppm_archive):
    _judge_reads_zero(noppm_archive)


def _reference_is_the_archive(archive):
    spec, data, blob = archive
    rspec = spec_from_dict(json.loads(json.dumps(dataclasses.asdict(spec))))
    assert rspec.stable_hash() == spec.stable_hash()
    arr = ref.split_streams(data, 3, 20)
    assert blob[: check.HEADER] == ref.header(rspec, 3, len(data), arr.shape[1])
    for s, pay in enumerate(check.payloads(blob, 3)):
        assert ref.encode_prefix(rspec, arr[s], arr.shape[1], 20, SEED) == pay
        part = ref.encode_prefix(rspec, arr[s], 15, 20, SEED)  # past the first backward pass (horizon 10)
        assert part and pay.startswith(part)


def _judge_reads_zero(archive):
    spec, data, blob = archive
    mix = {"streams": 3, "chunk": 20, "check_bytes": 15}
    got = check.judge(json.loads(json.dumps(dataclasses.asdict(spec))), data, mix, SEED, blob, [blob], [data], [0, 2])
    assert got["numbers"] == {"archive_mismatch_bytes": 0, "job_archive_diffs": 0, "decode_mismatch_bytes": 0}
    assert got["reference_bytes"] > 0
