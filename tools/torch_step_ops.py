#!/usr/bin/env python3
"""Count the aten ops of one encode byte step and one sampling byte step of
the PyTorch port on the CPU, at ref-noppm, ref-ppm and ref-full, and the
state leaves that each step (and, with the LSTM, its backward pass) copies
back into their storage at its end (core/step.py `_keep_storage`), with
their bytes at chip_smoke.py's 16 streams.

    python3 tools/torch_step_ops.py

The specs are the bench's profiles ref-noppm, ref-ppm and ref (chip_smoke.py's
ref-noppm, ref-ppm and ref-full), at scale_tables(spec, 12, history_bits=16)
and 2 streams: a step's op count depends on the wiring, not on table sizes.
The 8 sub-steps are replayed from a cache (on a GPU they are one kernel
launch, on the CPU thousands of plain ops), so the counts are those of the
eager code around the kernels. Both steps run at byte 64 of a predictor
warmed over 64 bytes a stream, where no LSTM backward pass falls. Prints one
line per spec; the counts are what predicts a GPU step's aten ops, whose
row movers are one launch each where the CPU's plain versions are a few ops.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import gmix_tpu_torch as gt  # noqa: E402
from gmix_tpu_torch import bench  # noqa: E402
from gmix_tpu_torch.config import scale_tables  # noqa: E402
from gmix_tpu_torch.core import step as st  # noqa: E402

S, WARM = 2, 64


def count_ops(pred, data, **kw) -> int:
    """aten ops of the byte step at WARM on a copy of `pred`, the sub-steps'
    outputs taken from an earlier run of the same step."""
    real, cache = st.fused_substeps, {}

    def record(*a):
        cache["fo"] = real(*a)
        return {k: v.clone() for k, v in cache["fo"].items()}

    def replay(*a):
        return {k: v.clone() for k, v in cache["fo"].items()}

    code = torch.zeros((S, 8), dtype=torch.uint8)
    try:
        st.fused_substeps = record
        p = pred.copy()
        st._byte_step(p.state, torch.tensor(data), code, WARM, False, p.plan, **kw)
        st.fused_substeps = replay
        p = pred.copy()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            st._byte_step(p.state, torch.tensor(data), code, WARM, False, p.plan, **kw)
    finally:
        st.fused_substeps = real
    return sum(ka.count for ka in prof.key_averages() if ka.key.startswith("aten::"))


def moved_leaves(pred, run) -> list:
    """(name, bytes at cs.STREAMS streams) of each leaf that `run(p)` on a
    copy `p` of `pred` copies back into its storage."""
    real, seen = st._keep_storage, []

    def spy(refs):
        seen.extend((k, d[k]) for d, k, old in refs if d[k] is not old)
        real(refs)

    try:
        st._keep_storage = spy
        run(pred.copy())
    finally:
        st._keep_storage = real
    return [(k, (t.numel() // S) * cs.STREAMS * t.element_size() if t.dim() else t.element_size()) for k, t in seen]


def report(name: str, moved: list) -> str:
    return f"{name} {len(moved)} leaves, {sum(b for _, b in moved)} bytes ({', '.join(k for k, _ in moved)})"


def main() -> None:
    torch.set_num_threads(1)
    data = np.frombuffer(cs.corpus(S * (WARM + 16)), np.uint8).reshape(S, WARM + 16).copy()
    u = torch.rand((8, S), generator=torch.Generator().manual_seed(cs.SEED))
    inv_temp = torch.tensor([np.float32(1.0 / cs.GEN_TEMP)])
    for name, spec in (("ref-noppm", bench.ref_noppm_spec()), ("ref-ppm", bench.ref_ppm_spec()),
                       ("ref-full", bench.spec_for(None))):
        spec = scale_tables(spec, 12, history_bits=16)
        pred = cs.Predictor(spec, S, device="cpu")
        gt.compress_bytes(cs.corpus(S * WARM), spec, S, WARM, pred=pred)
        enc = count_ops(pred, data)
        smp = count_ops(pred, data, learn=False, sample_u=u, inv_temp=inv_temp)
        print(f"{name}: aten ops a byte step, encode {enc}, sampling {smp} ({enc - smp} fewer, {smp / enc:.3f})",
              flush=True)
        code = torch.zeros((S, 8), dtype=torch.uint8)
        rows = [report("encode step:", moved_leaves(pred, lambda p: st._byte_step(
                    p.state, torch.tensor(data), code, WARM, False, p.plan))),
                report("sampling step:", moved_leaves(pred, lambda p: st._byte_step(
                    p.state, torch.tensor(data), code, WARM, False, p.plan, learn=False, sample_u=u,
                    inv_temp=inv_temp)))]
        if spec.lstm is not None:
            rows.append(report("backward pass:", moved_leaves(pred, lambda p: st.lstm_bptt(p.state, p.plan))))
        print(f"{name}: copied back into their storage at {cs.STREAMS} streams: " + "; ".join(rows), flush=True)


if __name__ == "__main__":
    main()
