"""Each configuration's frozen counts are the program's counting functions
(gmix_tpu_torch/roofline.py) at each of its cells' stream counts, on the
"meta" device, and its spec is the one its `spec_builder` names."""
import dataclasses
import json
import math

import pytest
import torch

from gmix_tpu_torch.core import fused
from gmix_tpu_torch.core.meta import build_meta
from gmix_tpu_torch.roofline import fused_bound, fused_float_ops, step_work
from h100_bench import registry
from h100_bench.counts import per_stream_counts, port_spec, spec_builder

BENCH = registry.benchmark(registry.HERE.parent)
CELLS = [(w["config"], registry.traffic(w["traffic"])["streams"]) for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_spec_is_the_builders(name):
    cfg = registry.config(name)
    want = spec_builder(cfg["spec_builder"])
    assert cfg["spec"] == json.loads(json.dumps(dataclasses.asdict(want)))
    assert port_spec(cfg["spec"]).stable_hash() == want.stable_hash()
    assert cfg["counts_per_stream"] == per_stream_counts(want)


@pytest.mark.parametrize("name,S", CELLS)
def test_counts_scale_with_streams(name, S):
    cfg = registry.config(name)
    spec = port_spec(cfg["spec"])
    meta = build_meta(spec)
    c = cfg["counts_per_stream"]
    work = step_work(meta, S)
    assert math.isclose(work["bytes"], S * c["step"]["bytes"], rel_tol=1e-12)
    assert math.isclose(work["float_ops"], S * c["step"]["float_ops"], rel_tol=1e-12)
    assert fused_float_ops(meta, S, True, False) == S * c["fused"]["float_ops"]
    # the fused count is fused_bound's rule: at the flags fused_bound takes (analysis on) the same sum
    ins, outs = fused.io_layout(meta, True, True)
    fin = {n: torch.empty((S,) + tail, dtype=dt, device="meta") for n, tail, dt, kind in ins if kind == "s"}
    consts = fused.const_inputs(meta, True, "cpu")
    ema = 2 * S * fused._dims(meta)["nc"] * 4  # the analysis EMA in and out, float32
    assert fused_bound(meta, consts, fin, S)["bytes_moved"] == S * c["fused"]["bytes"] + c["fused"]["bytes_const"] + ema
