"""The bench's measurement modes (`gmix_tpu_torch/bench.py`), the
counterparts of the repository's tools/: its profiles against gmix_tpu's
specs, the warm checkpoint (tools/tpu_warm_sweep.py's snapshot), the traced
window (tools/tpu_profile.py), `ref_bpb` (bench.py) and the ensemble
variants of tools/tpu_fast_ladder.py, tools/tpu_ablate.py and
tools/tpu_quality.py with their modes (several profiles a call,
`--encode-only`, `--analysis`, a warm checkpoint a profile), on the CPU at
tiny and small scaled specs.
"""
import dataclasses
import json
import os

import pytest
import torch

import bench
import gmix_tpu.config as j_cfg
import gmix_tpu_torch as gt
from gmix_tpu_torch import bench as tb
from gmix_tpu_torch import variants
from gmix_tpu_torch.core.codec import analysis_columns

torch.set_num_threads(1)

J_APM = (
    j_cfg.ApmStage("apm_lb", "last_byte", 8, lr=0.010, weight=0.50),
    j_cfg.ApmStage("apm_h2", "h2", 16, lr=0.010, weight=0.25),
)
# a small run of main() at the tiny spec with an LSTM (horizon 10), the
# bench's spec patched as in tests/test_torch_bench.py: 2 streams of 40
# bytes in one chunk after a 40-byte warm start, one pass each way
SMALL = ["--device", "cpu", "--profile", "scaled-8x2", "--chunk", "40", "--warm", "40", "--bytes", "80",
         "--offset", "1000", "--passes", "1"]
TRACE_STEPS = 10


def _j_ref():
    return dataclasses.replace(j_cfg.reference_spec(), apm=J_APM)


def _j_scaled(spec, bits):
    return j_cfg.scale_tables(spec, bits, history_bits=min(24, bits + 4))


# each profile's gmix_tpu counterpart: tools/tpu_sequential.py's best, and
# bench.py's reference wiring without the LSTM / without PPM
J_SPECS = {
    "best": j_cfg.best_spec,
    "ref-ppm": lambda: dataclasses.replace(_j_ref(), lstm=None),
    "ref-noppm": lambda: dataclasses.replace(_j_ref(), lstm=None, ppm=None, roll_ctxs=()),
    "ref-noppm:scaled-12": lambda: _j_scaled(dataclasses.replace(_j_ref(), lstm=None, ppm=None, roll_ctxs=()), 12),
    "best:scaled-10x4": lambda: _j_scaled(j_cfg.best_spec(), 10),
    "ref:scaled-11": lambda: bench._spec_for(11),
}


@pytest.mark.parametrize("profile", sorted(J_SPECS))
def test_profile_is_its_gmix_tpu_spec(profile):
    name, spec, streams = tb.parse_profile(profile)
    j_spec = J_SPECS[profile]()
    assert dataclasses.asdict(spec) == dataclasses.asdict(j_spec)
    assert spec.stable_hash() == j_spec.stable_hash()
    assert name == profile.split("x")[0] and streams == ("4" if profile.endswith("x4") else None)


def test_the_profiles_share_one_spec_each():
    assert tb.parse_profile("ref")[1] == tb.spec_for(None)
    assert tb.parse_profile("ref-ppm")[1] == tb.ref_ppm_spec() == dataclasses.replace(tb.spec_for(None), lstm=None)
    assert tb.parse_profile("ref-noppm")[1] == tb.ref_noppm_spec()
    assert tb.parse_profile("best")[1] == gt.best_spec()
    assert tb.parse_profile("ref:scaled-9")[1] == tb.parse_profile("scaled-9")[1] == tb.spec_for(9)


# every spelling that worked before the profiles: (profile, bits, streams)
OLD_SPELLINGS = {"ref": (None, None), "refx16": (None, "16"), "scaled-11x128": (11, "128"), "scaled-8": (8, None)}


@pytest.mark.parametrize("how", ["flag", "environment"])
@pytest.mark.parametrize("profile", sorted(OLD_SPELLINGS))
def test_old_profile_spellings_keep_their_spec(profile, how, monkeypatch, capsys):
    """--profile or GMIX_BENCH_PROFILE as before: bench.py's spec (`spec_for`
    of the bits) and the streams, handed to run_once."""
    bits, streams = OLD_SPELLINGS[profile]
    got = {}

    def run_once(spec, S, *a, **k):
        got.update(spec=spec, S=S)
        raise SystemExit(0)

    monkeypatch.setattr(tb, "run_once", run_once)
    argv = ["--device", "cpu", "--warm", "0", "--bytes", "1000"] + (["--profile", profile] if how == "flag" else [])
    if how == "environment":
        monkeypatch.setenv("GMIX_BENCH_PROFILE", profile)
    if streams is None:
        argv += ["--streams", "3"]
    with pytest.raises(SystemExit):
        tb.main(argv)
    assert got["spec"] == tb.spec_for(bits)
    assert got["spec"].stable_hash() == (bench._spec_for(bits) if bits else _j_ref()).stable_hash()
    assert got["S"] == int(streams or 3)
    config = json.loads(capsys.readouterr().out.splitlines()[0])
    assert config["spec"] == profile.split("x")[0]


@pytest.mark.parametrize("profile", ["reff", "ppm", "best-ppm", "scaled-", "ref:scaled", "scaled-8:scaled-9", "x4"])
def test_an_unknown_profile_exits(profile, monkeypatch):
    monkeypatch.setattr(tb, "run_once", lambda *a, **k: pytest.fail("an unknown profile ran"))
    with pytest.raises(SystemExit, match="unknown profile") as e:
        tb.main(["--device", "cpu", "--profile", profile])
    assert e.value.code != 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """main() three times on the same bytes: without a warm checkpoint;
    with one that does not exist yet (trained and written) and a traced
    window; with the same one (read). The printed rows by run, and the
    checkpoint's path."""
    d = tmp_path_factory.mktemp("bench")
    ckpt = str(d / "warm" / "tiny-40.gxt")
    rows = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tb, "spec_for", lambda bits: gt.tiny_spec(True))
        for key, extra in (("plain", []), ("written", ["--warm-checkpoint", ckpt, "--trace", str(TRACE_STEPS)]),
                           ("read", ["--warm-checkpoint", ckpt])):
            assert tb.main(SMALL + extra + ["--out", str(d / f"{key}.json")]) == 0
            rows[key] = json.loads((d / f"{key}.json").read_text())
    return rows, ckpt


def test_a_warm_checkpoint_gives_the_same_archive(runs):
    rows, ckpt = runs
    results = {k: r[-1] for k, r in rows.items()}
    assert [results[k]["warm_source"] for k in ("plain", "written", "read")] == ["trained", "trained", "checkpoint"]
    assert results["plain"]["warm_write_s"] is None and results["written"]["warm_write_s"] >= 0
    assert len({(r["archive_bytes"], r["archive_sha256"], r["bpb"]) for r in results.values()}) == 1
    assert all(r["exact"] for r in results.values())
    with open(ckpt + ".json") as f:
        side = json.load(f)
    assert side == tb.warm_sidecar(gt.tiny_spec(True), tb.corpus(40), 40)
    assert sorted(os.listdir(os.path.dirname(ckpt))) == ["tiny-40.gxt", "tiny-40.gxt.json"]


def test_trace_on_the_cpu_is_one_row_after_the_passes(runs):
    """The window runs after the timed passes (the archive is the one
    without it); its device numbers read "not measured" on the CPU."""
    rows, _ = runs
    kinds = [r["bench"] for r in rows["written"]]
    assert kinds == ["config", "pass", "pass", "trace", "result"]
    trace = rows["written"][3]
    assert (trace["byte_steps"], trace["backward_passes"]) == (TRACE_STEPS, 1)
    assert trace["device_trace"].startswith("not measured")
    assert trace["hand_written_launches_per_step"].startswith("not measured")
    assert trace["traced_wall_ms_per_step"] > 0 and trace["encode_pass_ms_per_step"] > 0
    assert rows["written"][-1]["trace_steps"] == TRACE_STEPS and rows["plain"][-1]["trace_steps"] == 0
    assert "trace" not in [r["bench"] for r in rows["plain"]]


def test_the_result_row_carries_ref_bpb(runs):
    rows, _ = runs
    for r in rows.values():
        assert r[-1]["ref_bpb"] == 1.9627  # data/baseline_measured.json ref_1m.bpb


# a run at a spec without an LSTM (any chunk is of its one order), and
# sidecars of other warm starts than its own (the spec, the corpus' first
# 40 bytes, chunk 40), or none
REFUSED = ["--device", "cpu", "--profile", "ref-noppm:scaled-8x2", "--chunk", "40", "--warm", "40", "--bytes", "80"]
OTHER_WARM = {
    "spec": lambda: tb.warm_sidecar(tb.parse_profile("ref-noppm:scaled-9")[1], tb.corpus(40), 40),
    "warm bytes": lambda: tb.warm_sidecar(tb.parse_profile("ref-noppm:scaled-8")[1], tb.corpus(40, 1), 40),
    "warm length": lambda: tb.warm_sidecar(tb.parse_profile("ref-noppm:scaled-8")[1], tb.corpus(48), 40),
    "chunk": lambda: tb.warm_sidecar(tb.parse_profile("ref-noppm:scaled-8")[1], tb.corpus(40), 20),
    "missing": lambda: None,
}


@pytest.mark.parametrize("other", sorted(OTHER_WARM))
def test_a_checkpoint_of_another_warm_start_is_refused_before_allocating(other, tmp_path, monkeypatch):
    def allocates(*a, **k):
        raise AssertionError("the refused checkpoint was read, trained over or allocated for")

    for name in ("Predictor", "pretrain_state", "load_warm_checkpoint", "save_warm_checkpoint"):
        monkeypatch.setattr(tb, name, allocates)
    ckpt = tmp_path / "w.gxt"
    ckpt.write_bytes(b"a checkpoint")
    side = OTHER_WARM[other]()
    if side is not None:
        (tmp_path / "w.gxt.json").write_text(json.dumps(side))
    with pytest.raises(SystemExit, match="refused: the warm checkpoint") as e:
        tb.main(REFUSED + ["--warm-checkpoint", str(ckpt)])
    assert e.value.code != 0
    assert ckpt.read_bytes() == b"a checkpoint"
    assert sorted(os.listdir(tmp_path)) == sorted(["w.gxt"] + (["w.gxt.json"] if side is not None else []))


@pytest.mark.parametrize("trace, why", [(15, "horizon"), (50, "a stream has 40"), (-10, "a stream has")])
def test_a_trace_the_run_cannot_hold_is_refused_before_allocating(trace, why, monkeypatch):
    monkeypatch.setattr(tb, "Predictor", lambda *a, **k: pytest.fail("allocated"))
    monkeypatch.setattr(tb, "pretrain_state", lambda *a, **k: pytest.fail("trained"))
    with pytest.raises(ValueError, match=why):
        tb.run_once(gt.tiny_spec(True), 2, 40, tb.corpus(80, 1000), tb.corpus(40), 1, "cpu", trace=trace)


# ---------------------------------------------------------------------------
# the ensemble variants (gmix_tpu_torch/variants.py) as profiles
# ---------------------------------------------------------------------------

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


def _tool(name):
    """A module of tools/ (the test alone imports them)."""
    import importlib
    import sys

    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    return importlib.import_module(name)


@pytest.mark.parametrize("profile, bits, v, streams", [("ref:ladder-lean", None, "lean", None),
                                                       ("ref:scaled-11:ladder-noskipind-noihx128", 11,
                                                        "noskipind-noih", "128"),
                                                       ("scaled-9:ladder-no4selx4", 9, "no4sel", "4")])
def test_a_ladder_profile_is_the_tools_spec(profile, bits, v, streams):
    """After :scaled-<bits> and before x<S>, the variant of
    tools/tpu_fast_ladder.py on bench.py's spec."""
    name, spec, got_streams = tb.parse_profile(profile)
    j_base = bench._spec_for(bits) if bits else _j_ref()
    assert spec.stable_hash() == _tool("tpu_fast_ladder").trim_spec(j_base, v).stable_hash()
    assert name == (profile[: -len("x" + streams)] if streams else profile) and got_streams == streams


@pytest.mark.parametrize("profile, base, v, streams", [("ref-ppm:scaled-10:ablate-mix6x2", "ref-ppm:scaled-10", "mix6", "2"),
                                                       ("ref:ablate-mix6", "ref", "mix6", None),
                                                       ("best:ablate-nomatch", "best", "nomatch", None),
                                                       ("ref:ablate-indonlyx8", "ref", "indonly", "8")])
def test_an_ablate_profile_applies_the_variant_after_the_clamp(profile, base, v, streams):
    _, spec, got_streams = tb.parse_profile(profile)
    assert spec == variants.ablate(tb.parse_profile(base)[1], v)
    assert got_streams == streams


@pytest.mark.parametrize("name, streams", [("ref-x4-oldppm", "4"), ("best-x4", "4"), ("boost-1-18x4", "4"),
                                           ("scaled-12x64-noppm", "64"), ("apm2-10-50-8x4", "4")])
def test_a_quality_profile_is_the_tools_variant_and_streams(name, streams):
    got_name, spec, got_streams = tb.parse_profile("quality:" + name)
    j_spec, j_S = _tool("tpu_quality").make_variant(name)
    assert (got_name, got_streams, int(got_streams)) == ("quality:" + name, streams, j_S)
    assert spec.stable_hash() == j_spec.stable_hash()


@pytest.mark.parametrize("profile", ["ref:noih", "ref:nolstmx4", "ref-ppm:scaled-9:noih"])
def test_a_bare_shared_variant_is_refused_with_both_meanings(profile, monkeypatch):
    monkeypatch.setattr(tb, "run_once", lambda *a, **k: pytest.fail("a bare variant ran"))
    with pytest.raises(SystemExit, match="ladder-.*ablate-") as e:
        tb.main(["--device", "cpu", "--profile", profile])
    assert "tpu_fast_ladder.py" in str(e.value) and "tpu_ablate.py" in str(e.value)


@pytest.mark.parametrize("streams", ["2", "auto"])
def test_streams_against_a_quality_name_are_refused(streams, monkeypatch):
    monkeypatch.setattr(tb, "run_once", lambda *a, **k: pytest.fail("ran"))
    with pytest.raises(SystemExit, match="refused: --streams"):
        tb.main(["--device", "cpu", "--profile", "quality:ref-x4-oldppm", "--streams", streams])


def test_streams_that_agree_with_a_quality_name_run(monkeypatch):
    got = {}

    def run_once(spec, S, *a, **k):
        got.update(spec=spec, S=S)
        raise SystemExit(0)

    monkeypatch.setattr(tb, "run_once", run_once)
    with pytest.raises(SystemExit):
        tb.main(["--device", "cpu", "--warm", "0", "--bytes", "1000", "--profile", "quality:ref-x4-noppm",
                 "--streams", "4"])
    assert got["S"] == 4 and got["spec"] == variants.quality("ref-x4-noppm")[0]


def test_profiles_sharing_one_warm_checkpoint_are_refused(monkeypatch, tmp_path):
    monkeypatch.setattr(tb, "run_once", lambda *a, **k: pytest.fail("ran"))
    with pytest.raises(SystemExit, match=r"\{profile\}"):
        tb.main(["--device", "cpu", "--profile", "ref:ablate-indonly,ref:ladder-lean", "--warm-checkpoint",
                 str(tmp_path / "w.gxt")])
    assert os.listdir(tmp_path) == []


# two variant profiles in one call at 8-bit tables, 2 streams of 40 bytes
# after a 40-byte warm start, one encode pass each with the entropy EMA, a
# warm checkpoint each
VARIANT_PROFILES = ("ref:scaled-8:ablate-indonlyx2", "ref-noppm:scaled-8:ladder-basex2")


@pytest.fixture(scope="module")
def variant_rows(tmp_path_factory):
    d = tmp_path_factory.mktemp("variants")
    argv = ["--device", "cpu", "--profile", ",".join(VARIANT_PROFILES), "--chunk", "40", "--warm", "40",
            "--bytes", "80", "--offset", "1000", "--passes", "2", "--encode-only", "--analysis",
            "--warm-checkpoint", str(d / "warm-{profile}.gxt"), "--out", str(d / "rows.json")]
    assert tb.main(argv) == 0
    return json.loads((d / "rows.json").read_text()), d


def test_two_profiles_print_a_result_row_each(variant_rows):
    rows, _ = variant_rows
    assert [r["bench"] for r in rows] == ["config", "pass", "pass", "result"] * 2
    names = [p.rpartition("x")[0] for p in VARIANT_PROFILES]
    assert [r["spec"] for r in rows if r["bench"] == "result"] == names
    assert [r["spec"] for r in rows if r["bench"] == "config"] == names
    for r in rows:
        if r["bench"] == "result":
            assert r["exact"] and r["streams"] == 2 and len(r["encode_s"]) == 2


def test_encode_only_decodes_nothing(variant_rows):
    rows, _ = variant_rows
    for r in rows:
        if r["bench"] == "pass":
            assert r["direction"] == "encode"
        if r["bench"] == "result":
            assert r["decoded"] is False and r["decode_s"] == [] and r["decode_bytes_per_s"] is None
            assert r["encdec_mbps"] is None


def test_analysis_gives_the_ema_of_every_column(variant_rows):
    rows, _ = variant_rows
    results = [r for r in rows if r["bench"] == "result"]
    for profile, r in zip(VARIANT_PROFILES, results):
        spec = tb.parse_profile(profile)[1]
        assert list(r["model_ema"]) == analysis_columns(spec)
        assert all(0 < v < 2 for v in r["model_ema"].values())
        assert r["analysis"] is True and r["mfu"] == "not measured: the CPU"


def test_each_profile_has_its_own_warm_checkpoint(variant_rows):
    rows, d = variant_rows
    files = sorted(p.name for p in d.iterdir() if p.name.startswith("warm-"))
    want = [f"warm-{p.rpartition('x')[0].replace(':', '_')}.gxt" for p in VARIANT_PROFILES]
    assert files == sorted(want + [w + ".json" for w in want])
    for profile, config in zip(VARIANT_PROFILES, [r for r in rows if r["bench"] == "config"]):
        assert config["warm_checkpoint"] == str(d / f"warm-{profile.rpartition('x')[0].replace(':', '_')}.gxt")
        with open(config["warm_checkpoint"] + ".json") as f:
            assert json.load(f)["spec_hash"] == tb.parse_profile(profile)[1].stable_hash()
