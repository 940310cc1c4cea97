"""gmix_tpu_torch.cli against gmix_tpu.cli, on the CPU.

The seven tests of tests/test_cli.py run against the port with --device
cpu, and the same argv runs through both command lines once (module
fixtures), so that their files can be held against each other: the archive
within 1% in size and 0.5% in model entropy (contract 3 of ROADMAP.md: every
CLI profile has the LSTM), entropy.tsv with gmix_tpu's header, rows and bit
counts, memory.tsv with gmix_tpu's components and bytes (twice them where
the port carries a u32 lane as int64), training.tsv with gmix_tpu's byte
counts and entropies within 0.5%. A checkpoint of gmix_tpu's train
generates in the port, and a decode with a chunk of the other order of the
LSTM's backward pass goes wrong in the port exactly where it does in
gmix_tpu.
"""
import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from gmix_tpu import cli as gmix_cli
from gmix_tpu_torch import cli

torch.set_num_threads(1)

TEXT = (
    b"The quick brown fox jumps over the lazy dog; pack my box with five "
    b"dozen liquor jugs. " * 24
)
N = 400  # bytes coded: 200 byte steps a direction at 2 streams
ARGS = ["--profile", "tiny", "--streams", "2", "--chunk", "40"]  # --chunk last
CPU = ["--device", "cpu"]
# tiny's LSTM horizon is 10: chunk 40 defers the backward pass to the
# segment ends, chunk 25 runs it inside the byte that wraps the window
OTHER_ORDER_CHUNK = "25"


def _main(main, argv):
    """rc and standard output of one command."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _drive(main, args, d):
    """compress --analysis, decompress, train (cwd d: analysis/training.tsv)
    and a decode of the archive with a chunk of the other order, in d."""
    (d / "in.txt").write_bytes(TEXT[:N])
    run = {}
    with contextlib.chdir(d):
        run["compress"] = _main(main, args + ["compress", "--analysis", "an", "in.txt", "out.gxtc"])
        run["decompress"] = _main(main, args + ["decompress", "out.gxtc", "back.txt"])
        run["train"] = _main(main, args + ["train", "in.txt", "in.txt", "--out-checkpoint", "ck.gxt"])
        other = args[:-2] + ["--chunk", OTHER_ORDER_CHUNK]
        run["other_order"] = _main(main, other + ["decompress", "out.gxtc", "back_other.txt"])
    return run


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_cli")
    return d, _drive(cli.main, CPU + ARGS, d)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("gmix_cli")
    return d, _drive(gmix_cli.main, ARGS, d)


def _lines(path):
    return open(path).read().splitlines()


def _model_entropy(printed):
    return float(re.search(r"model entropy ([0-9.]+) bits/byte", printed).group(1))


# ---- the seven tests of tests/test_cli.py, against the port ----


def test_cli_compress_decompress_roundtrip(port):
    d, run = port
    assert run["compress"][0] == 0 and run["decompress"][0] == 0
    assert os.path.getsize(d / "out.gxtc") < N  # learned something
    assert (d / "back.txt").read_bytes() == TEXT[:N]


def test_cli_decompress_wrong_profile_rejected(port):
    d, _ = port
    with pytest.raises(ValueError, match="spec mismatch"):
        cli.main(CPU + ["--profile", "scaled-8", "--streams", "2", "--chunk", "40",
                        "decompress", str(d / "out.gxtc"), str(d / "never.txt")])


def test_cli_compress_analysis_writers(port):
    d, _ = port
    ent = _lines(d / "an" / "entropy.tsv")
    assert ent[0].startswith("bits\t") and "final" in ent[0]
    assert len(ent) >= 2  # at least one sampled row
    last = np.array([float(v) for v in ent[-1].split("\t")[1:]])
    assert np.all(np.isfinite(last))
    mem = _lines(d / "an" / "memory.tsv")
    assert mem[0] == "component\tbytes"
    assert mem[-1].startswith("TOTAL\t")
    total = int(mem[-1].split("\t")[1])
    assert total == sum(int(r.split("\t")[1]) for r in mem[1:-1])


def test_cli_train_writes_tsv_and_checkpoint(port):
    d, run = port
    assert run["train"][0] == 0
    assert os.path.exists(d / "ck.gxt")
    rows = _lines(d / "analysis" / "training.tsv")
    assert rows[0] == "bytes\ttrain_entropy\ttest_entropy"
    assert len(rows) >= 2
    n_bytes, tr, te = rows[-1].split("\t")
    assert int(n_bytes) > 0 and float(tr) > 0
    # test entropy after a full pass over the identical file must be far
    # below the cold train entropy (the deep-copy evaluation path works)
    assert float(te) < float(tr)


def test_cli_generate_from_checkpoint(port, tmp_path):
    d, _ = port
    (tmp_path / "prompt.txt").write_bytes(TEXT[:100])
    rc = cli.main(CPU + ARGS + ["generate", "-k", str(d / "ck.gxt"), str(tmp_path / "prompt.txt"),
                                str(tmp_path / "gen.txt"), "120", "0.5"])
    assert rc == 0
    assert len((tmp_path / "gen.txt").read_bytes()) == 120


def test_cli_dict_roundtrip(tmp_path):
    (tmp_path / "in.txt").write_bytes(TEXT[:1600])
    enc, dec = str(tmp_path / "d.enc"), str(tmp_path / "d.dec")
    assert cli.main(["dict-encode", str(tmp_path / "in.txt"), enc]) == 0
    assert cli.main(["dict-decode", enc, dec]) == 0
    assert open(dec, "rb").read() == TEXT[:1600]


def test_cli_unknown_profile_errors(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(CPU + ["--profile", "nope", "compress", str(tmp_path / "in.txt"), str(tmp_path / "x")])


def test_cli_without_device_needs_cuda(tmp_path):
    """Without --device the model runs on the current CUDA device; with none
    the command exits with default_device()'s error and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the command would run on it")
    (tmp_path / "in.txt").write_bytes(TEXT[:80])
    with pytest.raises(SystemExit, match="found none.*--device cpu"):
        cli.main(ARGS + ["compress", str(tmp_path / "in.txt"), str(tmp_path / "out.gxtc")])
    assert not (tmp_path / "out.gxtc").exists()


# ---- the same argv through both command lines ----


def test_archive_within_contract_3_of_gmix_tpus(port, ref):
    """Size within 1%, model entropy (as printed, 4 decimals) within 0.5%."""
    (pd, prun), (rd, rrun) = port, ref
    a, b = os.path.getsize(pd / "out.gxtc"), os.path.getsize(rd / "out.gxtc")
    assert abs(a - b) <= 0.01 * b
    ea, eb = _model_entropy(prun["compress"][1]), _model_entropy(rrun["compress"][1])
    assert abs(ea - eb) <= 0.005 * eb


def test_entropy_tsv_rows_are_gmix_tpus(port, ref):
    """The same header, rows and bit counts (one row a chunk); the EMA
    columns within 1e-3 (contract 3; printed to 5 decimals)."""
    a, b = _lines(port[0] / "an" / "entropy.tsv"), _lines(ref[0] / "an" / "entropy.tsv")
    assert a[0] == b[0]
    assert len(a) == len(b) == 1 + (N // 2) // 40
    va = np.array([[float(v) for v in r.split("\t")] for r in a[1:]])
    vb = np.array([[float(v) for v in r.split("\t")] for r in b[1:]])
    assert np.array_equal(va[:, 0], vb[:, 0])
    np.testing.assert_allclose(va[:, 1:], vb[:, 1:], rtol=0, atol=1e-3)


def test_memory_tsv_is_gmix_tpus(port, ref):
    """gmix_tpu's file, line for line: its components in its order, each at
    gmix_tpu's bytes (a u32 leaf that the port carries as int64 at 4 bytes
    an element), and TOTAL their sum."""
    a, b = _lines(port[0] / "an" / "memory.tsv"), _lines(ref[0] / "an" / "memory.tsv")
    assert a == b
    assert a[-1] == "TOTAL\t%d" % sum(int(r.split("\t")[1]) for r in a[1:-1])


def test_training_tsv_is_gmix_tpus(port, ref):
    """The same byte counts; train and test entropy within 0.5%."""
    a, b = _lines(port[0] / "analysis" / "training.tsv"), _lines(ref[0] / "analysis" / "training.tsv")
    assert a[0] == b[0] and len(a) == len(b)
    for ra, rb in zip(a[1:], b[1:]):
        (na, *ea), (nb, *eb) = ra.split("\t"), rb.split("\t")
        assert na == nb
        np.testing.assert_allclose(np.float64(ea), np.float64(eb), rtol=0.005)


def test_gmix_tpu_checkpoint_generates_in_port(ref, tmp_path):
    """A checkpoint written by gmix_tpu.cli train loads into the port's
    generate."""
    (tmp_path / "prompt.txt").write_bytes(TEXT[:20])
    rc, printed = _main(cli.main, CPU + ARGS + ["generate", "-k", str(ref[0] / "ck.gxt"),
                                                str(tmp_path / "prompt.txt"), str(tmp_path / "gen.txt"), "40", "0.5"])
    assert rc == 0 and printed.startswith("generated 40 bytes")
    assert len((tmp_path / "gen.txt").read_bytes()) == 40


def test_other_chunk_order_fails_as_in_gmix_tpu(port, ref):
    """An archive made with --chunk 40 and decoded with --chunk 25 (the
    other order of the backward pass): in both packages no error, N bytes,
    each stream right up to the same byte and wrong from there on."""
    per = N // 2
    firsts = []
    for d, run in (port, ref):
        assert run["other_order"][0] == 0
        got = (d / "back_other.txt").read_bytes()
        assert len(got) == N and got != TEXT[:N]
        first = []
        for s in range(2):
            a, b = got[s * per:(s + 1) * per], TEXT[s * per:(s + 1) * per]
            first.append(next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None))
        firsts.append(first)
    assert firsts[0] == firsts[1]
    # the first backward pass is after byte 10 of a stream: what comes
    # before it decodes right
    assert all(f is not None and f >= 10 for f in firsts[0])
