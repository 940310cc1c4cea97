"""Where a cell's parts are found: by their names in BENCHMARK.json, each in
a file of its own under the benchmark's folder, so that a configuration, a
traffic mix or a per-layer metric is added by adding files alone."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, Optional

HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    """BENCHMARK.json at the root of the checkout."""
    return load_json(Path(root) / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {[w['name'] for w in bench['workloads']]})")


def config(name: str, base: Path = HERE) -> dict:
    """configs/<name>.json: the spec as it is run, its source, its cuts, the
    frozen work counts a stream and encode step, the kernels' trace names."""
    return load_json(Path(base) / "configs" / f"{name}.json")


def traffic(name: str, base: Path = HERE) -> dict:
    """traffic/<name>.json: the parameters the one generator reads
    (traffic.py)."""
    return load_json(Path(base) / "traffic" / f"{name}.json")


def peaks(kind: str, base: Path = HERE) -> Optional[dict]:
    """The published peaks of the card named `kind` (peaks.json), or None
    for a card the table does not hold."""
    for row in load_json(Path(base) / "peaks.json")["cards"]:
        if row["match"] in kind:
            return row
    return None


def metric_reader(name: str, base: Path = HERE) -> Callable:
    """The `read(run)` function of metrics/<name>.py. It returns the metric's
    value from what the run recorded, or None where it finds nothing to
    read."""
    path = Path(base) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100_bench_metric_{name.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_for(bench: dict, cell: str) -> Dict[str, dict]:
    """The per-layer metrics that `cell` reports: those that list it, and
    those without a `workloads` key that move an end-to-end metric the cell
    reports."""
    e2e = {m["name"] for m in end_to_end_for(bench, cell).values()}
    return {m["name"]: m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)}


def end_to_end_for(bench: dict, cell: str) -> Dict[str, dict]:
    return {m["name"]: m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]}
