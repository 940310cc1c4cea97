"""gmix_tpu_torch.preprocess against gmix_tpu.preprocess, byte for byte, and
the port's codec behind them.

The dictionary transform (both engines) and the Wikipedia-dump transform
give gmix_tpu's bytes on tests/test_dictionary.py's samples, on
tests/test_wiki.py's page builders and on the generated dump of
tools/make_wiki_corpus.py; the port's assets are gmix_tpu's files; the
wiki -> dict -> port codec -> inverse chain is byte-identical (the pattern
of tests/test_wiki_corpus.py); and a warm predictor beats a cold one
(tests/test_invariants.py, tester invariant of the fine-tuning path).
"""
import hashlib
import os

import pytest
import torch

import gmix_tpu_torch as gt
from gmix_tpu.preprocess import dictionary as gmix_dict
from gmix_tpu.preprocess import wiki as gmix_wiki
from gmix_tpu_torch.preprocess import dictionary as D
from gmix_tpu_torch.preprocess import wiki
from tests.test_dictionary import SAMPLES
from tests.test_wiki import CODA, INTRO, _corpus, _page
from tools.make_wiki_corpus import make_corpus

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = ("english.dic", "enwik9_article_order")
CORPUS_100K = os.path.join(ROOT, "data", "corpus_100k.bin")


@pytest.fixture(scope="module")
def dumps():
    """name -> (dump, similarity order): tests/test_wiki.py's cases and the
    generated dump with the asset order."""
    pages = "".join(_page(1000 + i, f"Page {i}", [f"body of page {i}"]) for i in range(50))
    odd = _page(30, "Odd", ["text body"]).replace(
        "      <contributor>", "      <comment deleted=\"deleted\" />\n      <contributor>"
    ).replace("<timestamp>2004-06-12T09:33:17Z</timestamp>", "<timestamp>2004-6-12T09:33:17Z</timestamp>")
    evil = ["binary\x01\x02\x03\x04\x05\x06\x07\x08\x0bstuff", "\x0b", "lines pretending: &amp; &quot; &#960;",
            "[[de:Fake]]"]
    order = open(wiki.DEFAULT_ORDER, "rb").read()
    return {
        "pages": (_corpus(), b""),
        "pages reordered": (_corpus(), b"3\n0\n2\n"),
        "permutation": (_corpus().replace(b"<id>10</id>", b"<id>99</id>", 1), b""),
        "stored": (b"just some plain text\nwith no pages at all\n" * 10, b""),
        "control bytes": ((INTRO + _page(1, "Evil", evil) + CODA).encode(), b""),
        "raw headers": ((INTRO + odd).encode(), b""),
        "id deltas": ((INTRO + pages).encode(), b""),
        "empty": (b"", b""),
        "one byte": (b"x", b""),
        "generated": (make_corpus(60000, seed=7), order),
    }


def test_assets_are_gmix_tpus():
    for name in ASSETS:
        ours = open(os.path.join(ROOT, "gmix_tpu_torch", "assets", name), "rb").read()
        theirs = open(os.path.join(ROOT, "gmix_tpu", "assets", name), "rb").read()
        assert hashlib.sha256(ours).hexdigest() == hashlib.sha256(theirs).hexdigest(), name
    assert wiki.DEFAULT_ORDER == os.path.join(ROOT, "gmix_tpu_torch", "assets", "enwik9_article_order")


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_dictionary_is_gmix_tpus(native):
    """Both engines encode to gmix_tpu's bytes and decode them back."""
    ours = D.load(None, native=native)
    assert isinstance(ours, D.NativeDictionary if native else D.Dictionary)
    theirs = gmix_dict.Dictionary(open(os.path.join(ROOT, "gmix_tpu", "assets", "english.dic"), "rb").read())
    for data in SAMPLES + [open(CORPUS_100K, "rb").read()[:20000]]:
        enc = ours.encode(data)
        assert enc == theirs.encode(data)
        assert ours.decode(enc) == data == theirs.decode(enc)


def test_dictionary_native_library_is_built_beside_the_kernels():
    lib = D._load_native()
    assert lib is not None
    assert os.path.dirname(lib._name) == os.path.join(ROOT, "build")


@pytest.mark.parametrize("case", ["pages", "pages reordered", "permutation", "stored", "control bytes",
                                  "raw headers", "id deltas", "empty", "one byte", "generated"])
def test_wiki_is_gmix_tpus(dumps, case):
    data, order = dumps[case]
    blob = wiki.encode(data, order)
    assert blob == gmix_wiki.encode(data, order)
    assert wiki.decode(blob) == data


def test_wiki_files_are_gmix_tpus(tmp_path):
    """encode_file with the default order (the port's asset) writes
    gmix_tpu's file; decode_file inverts it."""
    (tmp_path / "dump.xml").write_bytes(make_corpus(60000, seed=7))
    n = wiki.encode_file(str(tmp_path / "dump.xml"), str(tmp_path / "ours.gwp"))
    gmix_wiki.encode_file(str(tmp_path / "dump.xml"), str(tmp_path / "theirs.gwp"))
    assert (tmp_path / "ours.gwp").read_bytes() == (tmp_path / "theirs.gwp").read_bytes()
    assert n == os.path.getsize(tmp_path / "ours.gwp")
    wiki.decode_file(str(tmp_path / "ours.gwp"), str(tmp_path / "back.xml"))
    assert (tmp_path / "back.xml").read_bytes() == (tmp_path / "dump.xml").read_bytes()


def test_full_chain_byte_identical_small():
    """wiki -> dict -> the port's codec on the CPU -> inverse. The
    dictionary's output (1990 bytes) is split over 10 streams: one chunk of
    200 byte steps a direction."""
    data = make_corpus(60000, seed=7)[:4000]
    wblob = wiki.encode(data)
    d = D.load(None)
    dblob = d.encode(wblob)
    spec = gt.tiny_spec(with_lstm=False)
    blob = gt.compress_bytes(dblob, spec, num_streams=10, chunk=200, device="cpu")
    out = gt.decompress_bytes(blob, spec, chunk=200, device="cpu")
    assert wiki.decode(d.decode(out)) == data


def test_pretrained_warmstart_improves():
    """Fine-tuning path (tests/test_invariants.py): a predictor pre-trained
    on the same distribution compresses a fresh file smaller than a cold
    one. The pretraining pass is the cold run itself (the same spec, seed and
    bytes give the same state), copied; 256 bytes of the reference test's
    2048, one stream, chunk 256."""
    data = (b"Compression is the art of prediction; prediction, the art of memory. " * 30)[:256]
    spec = gt.tiny_spec(with_lstm=True)
    cold = gt.Predictor(spec, 1, device="cpu")
    blob_cold = gt.compress_bytes(data, spec, 1, 256, pred=cold)
    warm = cold.copy()
    # reuse the learned state; reset the coder (the port's lanes: int64,
    # x2 = 0xFFFFFFFF) and the metrics
    warm.state["coder"] = {
        "x1": torch.zeros((1,), dtype=torch.int64),
        "x2": torch.full((1,), 0xFFFFFFFF, dtype=torch.int64),
        "x": torch.zeros((1,), dtype=torch.int64),
        "wpos": torch.zeros((1,), dtype=torch.int64),
        "rpos": torch.zeros((1,), dtype=torch.int64),
    }
    warm.state["metrics"] = {k: torch.zeros_like(v) for k, v in warm.state["metrics"].items()}
    blob_warm = gt.compress_bytes(data, spec, 1, 256, pred=warm)
    assert len(blob_warm) < len(blob_cold)
