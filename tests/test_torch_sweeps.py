"""The port's sweeps (`gmix_tpu_torch/sweeps.py`) and its dump generator
(`gmix_tpu_torch/preprocess/wiki_corpus.py`) against the repository's
tools and gmix_tpu, on the CPU at tiny specs.

The warm sweep's snapshots are held against gmix_tpu run eagerly the
tool's way (tools/tpu_warm_sweep.py phase 1: one stream continued segment
by segment, each segment coded from byte index 0, lane 0 of a two-lane
program): bitwise without the LSTM (the entropy metrics within 2 ulp),
within contract 3's tolerance with it, as tests/test_torch_bench.py holds
the bench's warm start. The ring sweep's archive is held against jitted
gmix_tpu within the codec tests' 1% in bpb and 0.5% in model bpb. No test
may change data/parity.json, the TPU's records, which the sweeps only read.
"""
import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench
import gmix_tpu as g
from gmix_tpu.config import scale_tables as j_scale_tables
from gmix_tpu.core import codec as j_codec
from gmix_tpu.preprocess import dictionary as j_dictionary
from gmix_tpu.preprocess import wiki as j_wiki
from gmix_tpu.utils import serialization as j_serialization
from tools import make_wiki_corpus
import gmix_tpu_torch as gt
from gmix_tpu_torch import bench as tb
from gmix_tpu_torch import sweeps
from gmix_tpu_torch.preprocess import wiki_corpus
from gmix_tpu_torch.state import state_to_numpy
from tests.test_torch_bench import _assert_states

torch.set_num_threads(1)

CPU = torch.device("cpu")
PARITY_SHA = hashlib.sha256(open(sweeps.PARITY, "rb").read()).hexdigest()
# (tiny spec with the LSTM, sizes, chunk) of the warm snapshots held against
# eager gmix_tpu: the chunk a multiple of the tiny LSTM's horizon (10), the
# second size leaving a remainder that the tool carries into no segment
WARM_RUNS = {"tiny": (False, (8, 20), 8), "lstm": (True, (10, 25), 10)}


@pytest.fixture(autouse=True)
def parity_json_untouched():
    yield
    assert hashlib.sha256(open(sweeps.PARITY, "rb").read()).hexdigest() == PARITY_SHA


def _rows(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("seed", [20260821, 7])
@pytest.mark.parametrize("size", [1000, 65536, 1 << 20])
def test_make_corpus_is_the_tools_bytes(size, seed):
    got = wiki_corpus.make_corpus(size, seed)
    assert got == make_wiki_corpus.make_corpus(size, seed)
    assert len(got) > size and got.startswith(b"<mediawiki")


def test_the_specs_are_the_tools():
    """scaling and wiki: reference_spec() clamped, not the bench's spec with
    its two APM stages; sequential: reference_spec() as it is (no APM) and
    best_spec(); ring: the root bench.py's spec with another history."""
    for bits in (11, 12):
        want = j_scale_tables(g.reference_spec(), bits, history_bits=min(24, bits + 4))
        assert sweeps.scaling_spec(bits).stable_hash() == want.stable_hash()
        assert sweeps.scaling_spec(bits).stable_hash() != bench._spec_for(bits).stable_hash()
    assert sweeps.sequential_spec("ref").stable_hash() == g.reference_spec().stable_hash()
    assert sweeps.sequential_spec("ref").apm == ()
    assert sweeps.sequential_spec("ref").stable_hash() != tb.spec_for(None).stable_hash()
    assert sweeps.sequential_spec("best").stable_hash() == g.best_spec().stable_hash()
    for hb in (16, 17, 18, 19, 20):
        want = dataclasses.replace(bench._spec_for(11), history_bits=hb)
        assert sweeps.ring_spec(11, hb).stable_hash() == want.stable_hash()
    with pytest.raises(ValueError):
        sweeps.sequential_spec("tiny")
    assert sweeps.parse_bits_streams("11x128") == sweeps.parse_bits_streams("scaled-11x128") == (11, 128)


def test_warm_segments_are_the_tools_warm_bytes_actual():
    targets = sweeps.warm_targets(sweeps.WARM_SIZES, 4000)
    assert [start + trained for _, start, trained in targets] == [32000, 128000, 524000, 1048000]
    records = [r for r in sweeps.tpu_record("warm_sweep") if r["profile"] == "scaled-11x128"]
    assert [(r["warm_bytes"], r["warm_bytes_actual"]) for r in records] == [
        (t, start + trained) for t, start, trained in targets]
    # phase 9's cut sizes
    assert [start + trained for _, start, trained in sweeps.warm_targets((8192, 32768), 4000)] == [8000, 32000]
    # the tool's bench bytes repeat the corpus from byte 0: they hold the warm bytes
    data = sweeps.repeated_corpus(1 << 22)
    one = tb.corpus()
    assert len(data) == 1 << 22 and data[: len(one)] == one and data[len(one) : 2 * len(one)] == one


def _eager_tool_snapshots(lstm: bool, sizes, chunk):
    """tools/tpu_warm_sweep.py's phase 1 in eager gmix_tpu: a two-lane
    predictor, lane 1 idle, continued over each segment from byte index 0;
    lane 0 at each size."""
    spec = g.tiny_spec(lstm)
    data = tb.corpus(max(sizes))
    out = []
    with jax.disable_jit():
        pred = j_codec.Predictor(spec, 2, analysis=False)
        for target, start, trained in sweeps.warm_targets(sizes, chunk):
            if trained:
                arr = np.zeros((2, trained), np.uint8)
                arr[0] = np.frombuffer(data[start : start + trained], np.uint8)
                j_codec.run_chunks(pred, jnp.asarray(arr), jnp.zeros((2, 4096), jnp.uint8), trained, decode=False,
                                   chunk=chunk)
            host = jax.device_get(pred.state)
            out.append(jax.tree_util.tree_map(lambda x: x[0:1] if getattr(x, "ndim", 0) >= 1 and x.shape[0] == 2
                                              else x, host))
    return out


@pytest.fixture(scope="module", params=sorted(WARM_RUNS))
def warm_run(request, tmp_path_factory):
    """(name, the sweep's rows and snapshots at S=2, eager gmix_tpu's lane 0
    at each size)."""
    lstm, sizes, chunk = WARM_RUNS[request.param]
    d = tmp_path_factory.mktemp(f"warm-{request.param}")
    lines = []
    rc = sweeps.warm(gt.tiny_spec(lstm), 6, 2, sizes, chunk, 2 * chunk, CPU, lines, directory=str(d))
    return request.param, rc, lines, _eager_tool_snapshots(lstm, sizes, chunk)


def test_warm_snapshots_are_eager_gmix_tpu_the_tools_way(warm_run):
    name, rc, lines, want = warm_run
    lstm, sizes, chunk = WARM_RUNS[name]
    snaps = [r for r in lines if r["bench"] == "warm-snapshot"]
    assert rc == 0 and [r["warm_bytes"] for r in snaps] == list(sizes)
    assert [r["warm_bytes_actual"] for r in snaps] == [chunk, 2 * chunk]
    for row, j_host in zip(snaps, want):
        path = os.path.join(tb.ROOT, row["path"])
        # the file is gmix_tpu's checkpoint format
        _assert_states(j_host, j_serialization.load_state(path), lstm=lstm)
        side = json.load(open(path + ".json"))
        assert side["warm_chunk"] == chunk and side["warm_bytes"] == row["warm_bytes_actual"]
        # the bench refuses it as its own warm start of the same bytes
        with pytest.raises(SystemExit):
            tb.check_warm_checkpoint(path, tb.warm_sidecar(gt.tiny_spec(lstm), tb.corpus(side["warm_bytes"]), chunk))


def test_warm_snapshot_is_the_bench_warm_start_then_segments_restart(warm_run):
    """The first snapshot is the bench's warm start over the same prefix
    (`pretrain_state`, which tests/test_torch_bench.py holds against eager
    gmix_tpu's `_pretrain_host_state`); the second is not one run over its
    prefix: the tool codes each segment from byte index 0, whose byte
    counts as a stream's first."""
    name, _, lines, _ = warm_run
    lstm, sizes, chunk = WARM_RUNS[name]
    snaps = [r for r in lines if r["bench"] == "warm-snapshot"]
    first, second = (j_serialization.load_state(os.path.join(tb.ROOT, r["path"])) for r in snaps)
    _assert_states(state_to_numpy(tb.pretrain_state(gt.tiny_spec(lstm), tb.corpus(chunk), chunk, "cpu")), first,
                   lstm=False)
    whole = state_to_numpy(tb.pretrain_state(gt.tiny_spec(lstm), tb.corpus(2 * chunk), chunk, "cpu"))
    assert not np.array_equal(whole["stm"]["bits_seen"], second["stm"]["bits_seen"])


def test_warm_rows_encode_the_bench_bytes_from_each_snapshot(warm_run):
    name, _, lines, _ = warm_run
    lstm, sizes, chunk = WARM_RUNS[name]
    rows = [r for r in lines if r["bench"] == "warm"]
    assert [r["warm_bytes"] for r in rows] == list(sizes)
    for r in rows:
        assert r["profile"] == "scaled-6x2" and r["bench_bytes"] == 2 * chunk and r["byte_steps"] == chunk
        assert r["overlaps_warm"] is True and r["repeats_corpus"] is False
        assert np.isfinite(r["bpb"]) and np.isfinite(r["model_bpb"])
        for key in ("profile", "warm_bytes", "warm_bytes_actual", "bench_bytes", "chunk", "bpb", "model_bpb", "enc_s"):
            assert key in r
    # from another warm start, other bytes
    assert rows[0]["archive_sha256"] != rows[1]["archive_sha256"]


def test_warm_continued_in_chunks_of_one_or_two_horizons_is_the_same_state(tmp_path):
    """Both chunks are multiples of the LSTM's horizon: the deferred
    backward pass runs at the same bytes, so the snapshots are the same bits."""
    spec, data = gt.tiny_spec(True), tb.corpus(40)
    snaps = {c: sweeps.warm_snapshots(spec, "tiny", data, (20, 40), c, CPU, [], str(tmp_path / str(c)))
             for c in (10, 20)}
    for a, b in zip(snaps[10], snaps[20]):
        assert a["warm_bytes_actual"] == b["warm_bytes_actual"]
        _assert_states(j_serialization.load_state(a["path"]), j_serialization.load_state(b["path"]), lstm=False)


@pytest.fixture(scope="module")
def ring_data(tmp_path_factory):
    cache = tmp_path_factory.mktemp("ring")
    old, sweeps.RING_CACHE = sweeps.RING_CACHE, str(cache)
    try:
        data = sweeps.ring_corpus(3000)
        again = sweeps.ring_corpus(3000)  # read from the cache
    finally:
        sweeps.RING_CACHE = old
    assert again == data and os.listdir(cache) == ["ring-3000.bin"]
    return data


def test_ring_corpus_is_the_tools(ring_data):
    raw = make_wiki_corpus.make_corpus(3000)
    assert ring_data == j_dictionary.load(None).encode(j_wiki.encode(raw))


def test_ring_row_that_wraps_is_gmix_tpu_within_contract_and_roundtrips(ring_data):
    data, S, chunk = ring_data[:240], 2, 40
    spec = dataclasses.replace(gt.tiny_spec(False), history_bits=6)
    row, blob = sweeps.ring_row(data, spec, S, chunk, CPU)
    assert row["ring_bytes"] == 64 < row["per_stream_bytes"] == 120 and row["wraps"]
    j_spec = dataclasses.replace(g.tiny_spec(False), history_bits=6)
    j_pred = j_codec.Predictor(j_spec, S, analysis=False)
    j_blob = j_codec.compress_bytes(data, j_spec, S, chunk, pred=j_pred)
    j_bpb, j_model = 8 * len(j_blob) / len(data), j_codec.entropy_bits(j_pred) / len(data)
    assert abs(row["bpb"] - j_bpb) <= 0.01 * j_bpb
    assert abs(row["model_bpb"] - j_model) <= 0.005 * j_model
    assert gt.decompress_bytes(blob, spec, chunk, device="cpu") == data
    assert row["byte_steps"] == 120 and row["archive_sha256"] == hashlib.sha256(blob).hexdigest()


def test_ring_failing_history_size_gives_an_error_row_and_a_non_zero_exit(ring_data):
    def spec_of(hb):
        if hb == 5:
            raise RuntimeError("out of memory")
        return dataclasses.replace(gt.tiny_spec(False), history_bits=hb)

    lines = []
    rc = sweeps.ring(ring_data[:40], spec_of, "tiny", [5, 6], 2, 20, CPU, lines)
    assert rc == 1
    assert lines[0]["history_bits"] == 5 and lines[0]["error"] == "RuntimeError: out of memory"
    assert lines[1]["history_bits"] == 6 and "error" not in lines[1] and np.isfinite(lines[1]["bpb"])


SEQ_KEYS = ("status", "corpus_bytes", "chunk", "streams", "ref_bpb_sequential", "state_gib", "bpb", "model_bpb",
            "enc_s", "enc_mbps", "dec_s", "roundtrip_exact", "encdec_mbps")


def test_sequential_is_compress_bytes_at_one_stream_and_decodes(monkeypatch):
    spec, data, chunk = gt.tiny_spec(False), tb.corpus(60), 20
    lines = []
    assert sweeps.sequential("ref", spec, data, chunk, CPU, lines) == 0
    encoded, done = lines
    assert encoded["status"] == "encoded" and done["status"] == "done" and done["roundtrip_exact"] is True
    for key in SEQ_KEYS:
        assert key in done, key
    assert done["streams"] == 1 and done["ref_bpb_sequential"] == 1.9627
    assert encoded["byte_steps"] == done["byte_steps"] == 60
    blob = gt.compress_bytes(data, spec, 1, chunk, device="cpu")
    assert done["archive_sha256"] == hashlib.sha256(blob).hexdigest() and done["bpb"] == 8 * len(blob) / len(data)
    assert done["tpu_record"]["ref"]["status"] == "invalid_s1_miscompile"
    assert done["tpu_record"]["ref_idle2"]["bpb"] == 1.9647
    # a decode that is not the input exits non-zero
    monkeypatch.setattr(sweeps, "decompress_bytes", lambda *a, **k: data[:-1] + b"?")
    lines = []
    assert sweeps.sequential("ref", spec, data, chunk, CPU, lines) == 1
    assert lines[-1]["roundtrip_exact"] is False


def test_sequential_capture_only_and_encode_only():
    spec, lines = gt.tiny_spec(True), []
    assert sweeps.sequential_capture("ref", spec, 20, CPU, lines) == 0
    assert lines[0]["byte_steps"] == 40 and lines[0]["graphs"] == 0  # the CPU runs the step op by op
    lines = []
    assert sweeps.sequential("best", spec, tb.corpus(20), 20, CPU, lines, encode_only=True) == 0
    assert len(lines) == 1 and lines[0]["roundtrip_exact"] == "not run: --encode-only"
    assert lines[0]["tpu_record"]["best_idle2"]["bpb"] == 1.9451


def test_wiki_chain_gives_the_dump_back():
    lines = []
    assert sweeps.wiki_chain(20_000, gt.tiny_spec(False), "tiny", 128, 40, CPU, lines) == 0
    (row,) = lines
    assert row["chain_byte_identical"] is True and row["codec_exact"] is True
    raw = make_wiki_corpus.make_corpus(20_000)
    wblob = j_wiki.encode(raw)
    assert (row["wiki_bytes"], row["dict_bytes"]) == (len(wblob), len(j_dictionary.load(None).encode(wblob)))
    assert row["tpu_record"]["dict_bytes"] == sweeps.RING_CORPUS_BYTES


def test_main_scaling_on_the_cpu_prints_and_writes_its_rows(tmp_path, capsys):
    out = tmp_path / "rows.json"
    rc = sweeps.main(["scaling", "1", "2", "--profile", "scaled-6", "--chunk", "4", "--device", "cpu",
                      "--out", str(out)])
    rows = _rows(capsys)
    assert rc == 0 and json.loads(out.read_text()) == rows
    config, *body = rows
    assert config["bench"] == "config" and config["sweep"] == "scaling" and config["nvidia_smi"] is None
    assert [r["S"] for r in body] == [1, 2] and all(r["byte_steps"] == 12 for r in body)
    assert body[1]["mem_gb"] == pytest.approx(2 * body[0]["mem_gb"], rel=1e-3)


def test_main_without_a_device_refuses_on_a_machine_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit, match="--device cpu"):
        sweeps.main(["scaling", "1"])
