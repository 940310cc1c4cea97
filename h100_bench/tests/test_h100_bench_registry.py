"""A new configuration, traffic mix and per-layer metric are taken up from
new files alone: nothing of the benchmark's code is edited."""
import json

from h100_bench import registry
from h100_bench.harness import Job, Run


def test_new_files_are_found_by_name(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    cfg = registry.config("gmix-ref")
    cfg["name"] = "new-config"
    (tmp_path / "configs" / "new-config.json").write_text(json.dumps(cfg))
    mix = dict(registry.traffic("split54-l2000"), streams=7)
    (tmp_path / "traffic" / "split7-l2000.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "jobs_in_window.py").write_text("def read(run):\n    return float(len(run.jobs))\n")
    bench = json.loads((registry.HERE.parent / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "new-s7", "config": "new-config", "traffic": "split7-l2000", "chips": 1,
                               "why": "a new cell"})
    bench["per_layer"].append({"name": "jobs_in_window", "unit": "jobs", "better": "higher", "source": "host_clock",
                               "layer": "codec (core/codec.py and the reset)", "moves": "encode_Bps",
                               "workloads": ["new-s7"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    got = registry.benchmark(tmp_path)
    cell = registry.workload(got, "new-s7")
    assert registry.config(cell["config"], tmp_path)["name"] == "new-config"
    assert registry.traffic(cell["traffic"], tmp_path)["streams"] == 7
    layer = registry.per_layer_for(got, "new-s7")
    assert list(layer) == ["jobs_in_window"]
    assert "jobs_in_window" not in registry.per_layer_for(got, "ref-s54")
    job = Job(b"", b"", 1.0, 1.0, 0.9, 0.9, [0.1, 0.1])
    run = Run(cfg, mix, 7, 2000, 14000, [job, job])
    assert registry.metric_reader("jobs_in_window", tmp_path)(run) == 2.0


def test_every_metric_reader_is_silent_without_a_trace():
    """A reader that finds nothing to read returns None (never 0 for a
    share); the readers of the window's host numbers read them."""
    bench = registry.benchmark(registry.HERE.parent)
    cfg, mix = registry.config("gmix-ref"), registry.traffic("split54-l2000")
    job = Job(b"", b"", 3.6, 3.6, 3.5, 3.5, [0.1, 0.12])
    run = Run(cfg, mix, 54, 2000, 108000, [job], peaks=registry.peaks("NVIDIA H100 80GB HBM3"))
    for name in [m["name"] for m in bench["per_layer"]]:
        value = registry.metric_reader(name)(run)
        if registry.workload(bench, "ref-s54") and name in ("reset_ms", "mfu.enc", "step_roofline.enc"):
            assert value is not None and value > 0
        else:
            assert value is None, name
    assert abs(registry.metric_reader("reset_ms")(run) - 110.0) < 1e-9
    run.peaks = None
    assert registry.metric_reader("mfu.enc")(run) is None
