"""The work counts a configuration file freezes, a stream and an encode byte
step, worked out by the program's own counting functions at this commit
(gmix_tpu_torch/roofline.py): so that a later change to the program cannot
move the yardstick its cells are judged by. h100_bench/tests ties each
config's frozen numbers to these functions.

- `step`: `roofline.step_work` (every count there is S times one stream's);
- `fused`: the fused kernel's bytes (every per-stream input read once and
  every output written once, as `roofline.fused_bound` counts them, at the
  benchmark's flags: learning on, analysis off) and `fused_float_ops`; the
  spec's constants (`bytes_const`) do not grow with S;
- `movers`: the gathers' and scatters' bytes, as chip_smoke.py bounds the
  movers (`tensor_bytes` of the int32 row indices, and the rows twice: read
  and written), for every arena row the step moves.

A configuration names the program's function that builds its spec
(`spec_builder`, read by `spec_builder`), so a configuration joins the
benchmark by its files alone.

    python -m h100_bench.counts <config>   # prints the counts of configs/<config>.json's spec
"""
from __future__ import annotations

import ast
import importlib
import json
import math
import re
import sys

from .reference.config import spec_from_dict
from .registry import config


def port_spec(spec_dict: dict):
    """The program's EnsembleSpec for a configuration file's `spec`."""
    from gmix_tpu_torch import config as port_config

    return spec_from_dict(spec_dict, port_config)


PROGRAM = "gmix_tpu_torch"
BUILDER = re.compile(r"(?P<path>[A-Za-z_]\w*(?:\.[A-Za-z_]\w*)+)\((?P<args>[^()]*)\)", re.ASCII)


def spec_builder(text: str):
    """The program's EnsembleSpec that a configuration's `spec_builder`
    names: `gmix_tpu_torch.<module path>.<function>(<int literals,
    comma-separated, or none>)`. The leading name is compared whole (the
    JAX package `gmix_tpu` and anything outside the port are refused), the
    arguments are read with `ast.literal_eval`: no text runs as code.
    Anything else raises ValueError, naming the string."""
    from gmix_tpu_torch.config import EnsembleSpec

    m = BUILDER.fullmatch(text)
    if m is None or m["path"].split(".")[0] != PROGRAM:
        raise ValueError(f"spec_builder {text!r}: not {PROGRAM}.<module path>.<function>(<int literals>)")
    try:
        args = ast.literal_eval(f"({m['args']},)") if m["args"].strip() else ()
    except (ValueError, SyntaxError):
        args = None
    if args is None or not all(type(a) is int for a in args):
        raise ValueError(f"spec_builder {text!r}: the arguments must be int literals")
    module, name = m["path"].rsplit(".", 1)
    try:
        build = getattr(importlib.import_module(module), name, None)
    except ImportError:
        build = None
    if not callable(build):
        raise ValueError(f"spec_builder {text!r}: {module} has no function {name}")
    spec = build(*args)
    if not isinstance(spec, EnsembleSpec):
        raise ValueError(f"spec_builder {text!r}: gives {type(spec).__name__}, not an EnsembleSpec")
    return spec


def _rows_moved(meta, spec) -> list:
    """(arena leaf, rows a stream) of every gather and every scatter of an
    encode byte step (core/step.py, core/ppm.py)."""
    moves = []
    if spec.ppm is not None:
        NO = len(spec.ppm.orders)
        moves += [("stm/ppm_tbl", NO)] * 3  # the count update's gather and scatter, the prediction's gather
    grouped = [("ltm/ind/st", len(spec.indirects)), ("ltm/mix_w", len(meta.mix_st_ix)),
               ("ltm/mix_pos", len(meta.mix_pos_ix)), ("ltm/apm", len(spec.apm))]
    grouped = [(p, n) for p, n in grouped if n]
    return moves + grouped + grouped  # the grouped gather, then the grouped scatter


def per_stream_counts(spec) -> dict:
    """The frozen counts of `spec` (the program's EnsembleSpec)."""
    import torch
    from gmix_tpu_torch.core import fused
    from gmix_tpu_torch.core.meta import build_meta
    from gmix_tpu_torch.roofline import fused_float_ops, step_work, tensor_bytes
    from gmix_tpu_torch.state import init_state

    meta = build_meta(spec)
    work = step_work(meta, 1)
    ins, outs = fused.io_layout(meta, True, False)
    consts = fused.const_inputs(meta, True, "cpu")
    per = sum(math.prod(tail) * dt.itemsize for _, tail, dt, kind in ins if kind == "s")
    per += sum(math.prod(tail) * dt.itemsize for _, tail, dt, _ in outs)
    const = tensor_bytes([consts[n] for n, _, _, kind in ins if kind == "c" and n not in fused.CALL_INPUTS])
    const += tensor_bytes([consts["desc_i"], consts["desc_f"]])

    leaves = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                leaves[prefix + k] = v

    walk(init_state(meta, 1, device="meta"))
    movers = 0
    for path, n in _rows_moved(meta, spec):
        leaf = leaves[path]
        row = torch.empty((1, n) + tuple(leaf.shape[2:]), dtype=leaf.dtype, device="meta")
        idx = torch.empty((1, n), dtype=torch.int32, device="meta")
        movers += tensor_bytes([idx]) + 2 * tensor_bytes([row])
    return {
        "step": {"bytes": work["bytes"], "float_ops": work["float_ops"]},
        "fused": {"bytes": per, "bytes_const": const, "float_ops": fused_float_ops(meta, 1, True, False)},
        "movers": {"bytes": movers},
    }


if __name__ == "__main__":
    print(json.dumps(per_stream_counts(port_spec(config(sys.argv[1])["spec"])), indent=1))
