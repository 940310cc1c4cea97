"""BENCHMARK.json against the benchmark's contract: names, units, keys,
the files every entry names, and the limits a later check enforces."""
import json
import re
from pathlib import Path

import pytest

from h100_bench import registry, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
ALL_NAMES = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for word in BENCH["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("name", sorted(set(ALL_NAMES)))
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_entries(m):
    e2e = "bound" in m
    keys = {"name", "unit", "better", "bound", "source"} if e2e else {"name", "unit", "better", "source", "layer",
                                                                       "moves"}
    assert set(m) - {"workloads"} == keys
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", [])) <= cells
    if e2e:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert (registry.HERE / "metrics" / f"{m['name']}.py").is_file()
    if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_unique_names_and_setup():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workloads(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4) and TEXT.match(w["why"])
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    mix = registry.traffic(w["traffic"])
    traffic.validate(mix)
    assert registry.config(w["config"])["stream_bytes"] == mix["bytes_per_stream"]
    e2e = registry.end_to_end_for(BENCH, w["name"])
    assert "setup_s" in e2e and len(e2e) >= 2 and registry.per_layer_for(BENCH, w["name"])
    pairs = [(x["config"], x["traffic"]) for x in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(x["chips"] == 4 for x in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["source"].startswith("https://") and TEXT.match(c["source"]) and TEXT.match(c["why"])
    assert c["file"] == f"h100_bench/configs/{c['name']}.json" and c["file"].startswith(BENCH["paths"][0] + "/")
    cfg = registry.config(c["name"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    assert len(c["reduced"]) <= 16 and all(k in cfg for k in c["reduced"])
    widths = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|experts_per")
    assert not any(widths.search(k) for k in c["reduced"])
    assert set(cfg["kernels"]) == {"fused", "movers"}
    files = [x["file"] for x in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_every_file_is_named_from_names():
    for p in registry.HERE.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
