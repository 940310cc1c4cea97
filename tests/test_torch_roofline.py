"""The byte step's roofline (`gmix_tpu_torch/roofline.py`), the counterpart
of tools/tpu_profile.py's cost analysis, on the CPU: `step_work` against a
tally written out here from the Meta's fields, part by part (without the
module's helpers), its bytes at gmix_tpu's dtypes (the leaves of gmix_tpu's
`init_state`), its linearity in the streams and its range; `roofline`'s
shares; the bench's CPU rows, which carry the count and the bound and no
share. Its float operations against XLA's count: test_torch_roofline_xla.py.
"""
import json
import math

import numpy as np
import pytest
import torch

import gmix_tpu.config as j_cfg
from gmix_tpu.core.meta import build_meta as j_build_meta
from gmix_tpu.state import init_state as j_init_state
import gmix_tpu_torch as gt
from gmix_tpu_torch import bench as tb
from gmix_tpu_torch import roofline as rl
from gmix_tpu_torch import variants
from gmix_tpu_torch.core.meta import APM_BINS, PPM_ROW_W, build_meta

torch.set_num_threads(1)

U32 = F32 = I32 = 4  # gmix_tpu's 4-byte dtypes (the port carries a u32 as int64)
U16, U8 = 2, 1
T = 60  # float operations of a transcendental
SPECS = {"tiny": lambda: gt.tiny_spec(False), "tiny_lstm": lambda: gt.tiny_spec(True), "ref": lambda: tb.spec_for(None),
         "ref:ablate-indonly": lambda: tb.parse_profile("ref:ablate-indonly")[1]}
J_SPECS = {"tiny": lambda: j_cfg.tiny_spec(False), "tiny_lstm": lambda: j_cfg.tiny_spec(True)}


def whole_leaves(meta) -> dict:
    """One stream's bytes of every leaf the count reads or writes whole, in
    gmix_tpu's layout, from the Meta's fields."""
    spec = meta.spec
    NM, NR, NIH = len(spec.matches), len(spec.roll_ctxs), len(spec.ihash_ctxs)
    out = {"stm/acc": U32, "stm/last_byte": U32, "stm/recent": U32 * meta.recent_size,
           "stm/ctx": U32 * meta.n_ctx, "stm/bits_seen": U32, "stm/new_bit": U32, "stm/hist_n": U32,
           "coder/x1": U32, "coder/x2": U32, "coder/x": U32, "coder/wpos": U32, "coder/rpos": U32,
           "metrics/ent": F32, "ltm/mix_max_steps": U32 * (meta.mix_n0 + meta.mix_n1 + 1),
           "stm/ppm_probs": F32 * 256}
    if NR:
        out["stm/roll_h"] = U32 * NR
    if NIH:
        out["stm/ih_outer_ctx"] = out["stm/ih_outer_hash"] = U32 * NIH
    if NM:
        out.update({"stm/match_ptr": U32 * NM, "stm/match_byte": U32 * NM, "stm/match_len": I32 * NM})
    if spec.ppm is not None:
        out.update({"stm/ppm_see": F32 * len(spec.ppm.orders) * spec.ppm.see_buckets,
                    "stm/ppm_top": I32, "stm/ppm_bot": I32, "stm/ppm_mid": I32})
    if spec.lstm is not None:
        ls = spec.lstm
        C, Hz, OUT = ls.num_cells, ls.horizon, ls.output_size
        LI = ls.input_size + C + 1
        for k in ("w_sym", "sym_m", "sym_v"):
            out["ltm/lstm/" + k] = F32 * 3 * C * OUT
        for k in ("w_in", "in_m", "in_v"):
            out["ltm/lstm/" + k] = F32 * 3 * C * LI
        for k in ("gamma", "beta", "gamma_m", "gamma_v", "beta_m", "beta_v"):
            out["ltm/lstm/" + k] = F32 * 3 * C
        out["ltm/lstm/out_w"] = F32 * Hz * (C + 1) * OUT
        out.update({"stm/lstm/cell": F32 * C, "stm/lstm/hidden": F32 * (C + 1), "stm/lstm/top": I32,
                    "stm/lstm/bot": I32, "stm/lstm/mid": I32, "stm/lstm/probs": F32 * 256,
                    "stm/lstm/layer_input": F32 * Hz * LI, "stm/lstm/norm": F32 * 3 * Hz * C,
                    "stm/lstm/ivar": F32 * 3 * Hz, "stm/lstm/gate_state": F32 * 3 * Hz * C,
                    "stm/lstm/tanh_state": F32 * Hz * C, "stm/lstm/in_gate": F32 * Hz * C,
                    "stm/lstm/last_state": F32 * Hz * C, "stm/lstm/outputs": F32 * Hz * OUT,
                    "stm/lstm/in_hist": I32 * Hz, "stm/lstm/old_input": I32,
                    "stm/lstm/stored_err": F32 * C, "stm/lstm/state_err": F32 * C})
    return out


def tally(meta) -> dict:
    """One stream's (read + written bytes, float ops, int ops) by part."""
    spec = meta.spec
    W = whole_leaves(meta)
    M, NM, NA = len(spec.indirects), len(spec.matches), len(spec.apm)
    NI, NR, NIH = len(spec.interval_ctxs), len(spec.roll_ctxs), len(spec.ihash_ctxs)
    WP, K, n0, n1 = meta.mix_width_pad, meta.mix_n0 + meta.mix_n1 + 1, meta.mix_n0, meta.mix_n1
    Kst, Kp, Kcd, Kpd = len(meta.mix_st_ix), len(meta.mix_pos_ix), len(meta.mix_cd_ix), len(meta.mix_pd_ix)
    parts = {}

    # boundary: registers read and written, two IH words read and one written a context
    regs = W["stm/acc"] + W["stm/last_byte"] + W["stm/recent"] + W["stm/ctx"]
    regs += W.get("stm/roll_h", 0) + W.get("stm/ih_outer_ctx", 0) + W.get("stm/ih_outer_hash", 0)
    skips = sum(2 * len(c.offsets) - 1 + 31 for c in spec.skip_ctxs)  # key bytes, murmur3 of 8 bytes
    parts["boundary"] = (2 * regs + 3 * NIH * U32, 0,
                         NI * 5 + skips + NR * (4 + 20) + NIH * (3 + 3 + 31 + 20 + 2 + 2))

    regs = W.get("stm/match_ptr", 0) + W.get("stm/match_byte", 0) + W.get("stm/match_len", 0)
    parts["match"] = (2 * regs + NM * (U32 + U8), 0, NM * 4)

    if spec.ppm is not None:
        NO, NB = len(spec.ppm.orders), spec.ppm.see_buckets
        regs = W["stm/ppm_see"] + 3 * I32
        cascade = NO * (255 + 3 + 2 * NB - 1 + 2 * T + 1)
        flops = 2 * cascade + NO * (2 + 2 * NB) + NO * (4 + 3 * 256) + 255 + 1 + 256 + 512
        parts["ppm"] = (3 * NO * PPM_ROW_W * U16 + 2 * regs + W["stm/ppm_probs"], flops, NO * 8)
    else:
        parts["ppm"] = (0, 0, 0)

    if spec.lstm is not None:
        ls = spec.lstm
        C, Hz, OUT = ls.num_cells, ls.horizon, ls.output_size
        LI = ls.input_size + C + 1
        slot = F32 * (LI + 3 * C + 3 + 3 * C + 3 * C + OUT)  # one epoch of the recorded window
        regs = F32 * (C + C + 1) + 3 * I32
        layer = F32 * (C + 1) * OUT
        read = F32 * 3 * C + W["ltm/lstm/w_in"] + 2 * F32 * 3 * C + layer + regs
        read += W["stm/ppm_probs"] if spec.ppm is None else 0
        written = slot + regs + F32 * 256
        flops = 6 * C * LI + 6 * C + 186 + 9 * C + 180 * C + 65 * C + 2 * (C + 1) * OUT + 64 * OUT - 1
        written += I32 + layer  # the SGD: the symbol, the next epoch's output layer
        flops += OUT + C + 1 + 2 * (C + 1) * OUT
        parts["lstm_forward"] = (read + written, flops, 0)
        params = F32 * 3 * (3 * C * OUT + 3 * C * LI + 6 * C)
        carried = I32 + 2 * F32 * C
        window = Hz * slot + Hz * I32
        nbytes = window + F32 * Hz * C * OUT + 2 * (carried + params)
        n_params = 3 * C * OUT + 3 * C * LI + 6 * C
        flops = (Hz * OUT + 2 * Hz * C * OUT + (Hz - 1) * C + Hz * (51 * C + 6 * C * LI)
                 + (Hz - 1) * (2 * C + 6 * C * C) + n_params * 73)
        parts["lstm_backward"] = (nbytes / Hz, flops / Hz, 0)
    else:
        parts["lstm_forward"] = parts["lstm_backward"] = (0, 0, 0)

    dense = Kcd + 8 * Kpd + int(sum(meta.mix_lm_sizes))
    rows = M * 256 * U16 + Kst * WP * F32 + Kp * 8 * WP * F32 + NA * 8 * APM_BINS * F32 + dense * WP * F32
    parts["gather"] = (rows, 0, 2 * (M + Kst + Kp + NA + Kcd) + 3 * M)

    # the sub-steps: the fused kernel's float count, written out again
    regs = 5 * U32 + 2 * U32 + F32
    picked = 8 * (2 * M + NM) * F32
    learned = 8 * NM * I32 + W["ltm/mix_max_steps"]
    per_sub = 2 * K * WP + T * (NM + 2 * NA + 1) + 512 * ((spec.ppm is not None) + (spec.lstm is not None))
    for n in (n0, n1):
        if n > 1:
            sq = max(math.ceil(math.log2(n)) - 1, 0)
            per_sub += sq * 2 * n**3 + (sq + 1) * 2 * n * n
    per_sub += 3 * K * WP + T * (2 * M + K) + 16 * (2 * M + NM) + 99 * NA  # learning
    flops = 8 * per_sub + 16 * (2 * M + NM) * 256
    parts["sub_steps"] = (2 * regs + 2 * picked + 2 * learned, flops, 8 * (8 + 2 * M))

    written = rows + U8 + NM * U32 + 2 * U32
    parts["byte_end"] = (2 + written, 0, 2)
    return parts


@pytest.mark.parametrize("name", sorted(SPECS))
def test_step_work_is_the_hand_tally(name):
    meta = build_meta(SPECS[name]())
    S = 3
    got = rl.step_work(meta, S)
    want = tally(meta)
    assert list(got["parts"]) == list(rl.PARTS) and sorted(want) == sorted(rl.PARTS)
    for part, (nbytes, flops, iops) in want.items():
        row = got["parts"][part]
        assert row["bytes"] == pytest.approx(S * nbytes, rel=1e-12, abs=0), part
        assert (row["float_ops"], row["int_ops"]) == pytest.approx((S * flops, S * iops), rel=1e-12, abs=0), part
    for k in ("bytes", "float_ops", "int_ops"):
        assert got[k] == pytest.approx(sum(r[k] for r in got["parts"].values()), rel=1e-12)
        assert got["per_bit"][k] == got[k] / 8
    if meta.spec.lstm is None:
        assert got["parts"]["lstm_forward"]["bytes"] == got["parts"]["lstm_backward"]["bytes"] == 0


def test_step_work_of_ablate_indonly():
    """The ablation's smallest ensemble (variants.ablate "indonly" on ref):
    no match model, no indirect-hash context (no `ih_tbl` read, no IH hash),
    no PPM or LSTM head, one mixer a layer: those parts count nothing, and
    the boundary only its registers and the skip and interval hashes."""
    meta = build_meta(SPECS["ref:ablate-indonly"]())
    spec = meta.spec
    assert (len(spec.matches), len(spec.ihash_ctxs), spec.ppm, spec.lstm) == (0, 0, None, None)
    assert (meta.mix_n0, meta.mix_n1) == (1, 1)
    got = rl.step_work(meta, 1)["parts"]
    for part in ("match", "ppm", "lstm_forward", "lstm_backward"):
        assert got[part] == {"bytes": 0, "float_ops": 0, "int_ops": 0}, part
    W = whole_leaves(meta)
    regs = W["stm/acc"] + W["stm/last_byte"] + W["stm/recent"] + W["stm/ctx"] + W.get("stm/roll_h", 0)
    assert got["boundary"]["bytes"] == 2 * regs
    assert got["boundary"]["int_ops"] == (len(spec.interval_ctxs) * 5 + len(spec.roll_ctxs) * 24
                                          + sum(2 * len(c.offsets) - 1 + 31 for c in spec.skip_ctxs))
    # one mixer a layer: K = 3 rows of WP lanes in the sub-steps' dots
    assert got["sub_steps"]["float_ops"] == rl.fused_float_ops(meta, 1, True, False)
    assert got["sub_steps"]["float_ops"] < rl.step_work(build_meta(tb.spec_for(None)), 1)["parts"]["sub_steps"][
        "float_ops"] / 2


@pytest.mark.parametrize("v", [v for v in variants.ABLATE if v != "full"])
def test_an_ablation_does_no_more_than_full(v):
    """Each ablate variant's bytes, float and integer operations are at or
    below full's (ref) in every part. One byte moves between two parts:
    without PPM the LSTM reads the stored `ppm_probs` (its aux input) that
    full's PPM part writes anew, so those two parts are held together."""
    full = rl.step_work(build_meta(tb.parse_profile("ref:ablate-full")[1]), 4)
    got = rl.step_work(build_meta(tb.parse_profile(f"ref:ablate-{v}")[1]), 4)
    groups = [(p,) for p in rl.PARTS if p not in ("ppm", "lstm_forward")] + [("ppm", "lstm_forward")]
    for group in groups:
        for k in ("bytes", "float_ops", "int_ops"):
            assert sum(got["parts"][p][k] for p in group) <= sum(full["parts"][p][k] for p in group), (group, k)
    assert got["bytes"] <= full["bytes"] and got["float_ops"] <= full["float_ops"]


@pytest.mark.parametrize("name", sorted(J_SPECS))
def test_whole_leaves_are_gmix_tpus_bytes(name):
    """Every leaf the count reads or writes whole has, a stream, the bytes
    of gmix_tpu's leaf (its size times its dtype's itemsize): a u32 the port
    carries as int64 counts 4."""
    S = 2
    j_state = j_init_state(j_build_meta(J_SPECS[name]()), S)
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(j_state, "")
    want = whole_leaves(build_meta(SPECS[name]()))
    assert set(want) <= set(flat)
    for path, nbytes in want.items():
        assert flat[path].size * flat[path].dtype.itemsize == S * nbytes, path


@pytest.mark.parametrize("name", sorted(SPECS))
def test_step_work_is_linear_in_the_streams(name):
    meta = build_meta(SPECS[name]())
    one = rl.step_work(meta, 1)
    for S in (2, 5, 52):
        got = rl.step_work(meta, S)
        for k in ("bytes", "float_ops", "int_ops"):
            assert got[k] == pytest.approx(S * one[k], rel=1e-12)
            for part in rl.PARTS:
                assert got["parts"][part][k] == pytest.approx(S * one["parts"][part][k], rel=1e-12)


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("name", ["tiny", "tiny_lstm", "ref-noppm:scaled-8", "best:scaled-8", "ref"])
def test_bytes_lie_between_the_gathered_rows_and_twice_the_state(name, S):
    spec = SPECS[name]() if name in SPECS else tb.parse_profile(name)[1]
    meta = build_meta(spec)
    got = rl.step_work(meta, S)
    M, NA = len(spec.indirects), len(spec.apm)
    WP = meta.mix_width_pad
    gathered = S * (M * 256 * U16 + len(meta.mix_st_ix) * WP * F32 + len(meta.mix_pos_ix) * 8 * WP * F32
                    + NA * 8 * APM_BINS * F32)
    assert got["parts"]["gather"]["bytes"] >= gathered > 0
    assert gathered <= got["bytes"] <= 2 * tb.state_bytes_estimate(spec, S)


def test_step_work_allocates_nothing(monkeypatch):
    """From the Meta alone: no tensor is made on a real device."""
    made = []

    def on_meta(real):
        def make(*a, **k):
            if torch.device(k.get("device", "cpu")).type != "meta":
                made.append(a)
            return real(*a, **k)
        return make

    for name in ("zeros", "full", "empty", "tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, on_meta(getattr(torch, name)))
    rl.step_work(build_meta(tb.spec_for(None)), 52)
    assert made == []


@pytest.mark.parametrize("step_ms", [1.744, 0.001, 1e-6])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_roofline_share_is_the_larger_share(name, step_ms):
    work = rl.step_work(build_meta(SPECS[name]()), 52)
    got = rl.roofline(work, step_ms)
    assert abs(got["roofline_share"] - max(got["mfu"], got["hbm_share"])) <= 1e-12 * got["roofline_share"]
    assert got["bound_ms"] == pytest.approx(got["roofline_share"] * step_ms, rel=1e-12)
    assert got["bound_by"] == ("bytes" if got["hbm_share"] >= got["mfu"] else "operations")
    assert got["mfu"] == pytest.approx(work["float_ops"] / (step_ms / 1e3) / rl.PEAK_F32_OPS_PER_S, rel=1e-12)
    assert got["achieved_gbps"] == pytest.approx(work["bytes"] / (step_ms / 1e3) / 1e9, rel=1e-12)
    assert got["achieved_gflops"] == pytest.approx(work["float_ops"] / (step_ms / 1e3) / 1e9, rel=1e-12)


def test_the_reference_step_is_bound_by_bytes():
    """At ref S=52 a step moves ~0.5 MB a stream, and its float operations
    take a sixth of the bytes' time at the card's peaks."""
    work = rl.step_work(build_meta(tb.spec_for(None)), 52)
    got = rl.roofline(work, 1.744)
    assert got["bound_by"] == "bytes" and got["mfu"] < got["hbm_share"] / 4
    assert 0.3e6 < work["bytes"] / 52 < 0.8e6


def test_the_bench_rows_carry_the_roofline_on_the_cpu(monkeypatch, tmp_path):
    """A CPU run of the bench prints the count and the bound; every share
    and rate reads "not measured"."""
    monkeypatch.setattr(tb, "spec_for", lambda bits: gt.tiny_spec(True))
    out = tmp_path / "rows.json"
    argv = ["--device", "cpu", "--profile", "scaled-8x2", "--chunk", "20", "--warm", "0", "--bytes", "40",
            "--offset", "1000", "--passes", "1", "--trace", "10", "--out", str(out)]
    assert tb.main(argv) == 0
    rows = json.loads(out.read_text())
    trace, result = rows[-2], rows[-1]
    assert (trace["bench"], result["bench"]) == ("trace", "result")
    work = rl.step_work(build_meta(gt.tiny_spec(True)), 2)
    assert result["work_per_step"] == work
    assert result["bound_ms"] == rl.bound(work["bytes"], work["float_ops"])["bound_ms"] > 0
    assert result["bound_by"] in ("bytes", "operations")
    for k in rl.SHARES + rl.RATES:
        assert result[k] == "not measured: the CPU", k
    for k in rl.SHARES:
        assert trace[k] == "not measured: the CPU", k


def test_the_kernel_bound_counts_the_outputs_of_the_layout():
    """`fused_bound` counts the outputs from `fused.io_layout`; they are
    the bytes the sub-steps return."""
    from gmix_tpu_torch.core import fused, step
    from gmix_tpu_torch.utils.serialization import copy_state

    spec = gt.tiny_spec(True)
    pred = gt.Predictor(spec, 2, device="cpu")
    data, code = torch.zeros((2, 1), dtype=torch.uint8), torch.zeros((2, 64), dtype=torch.uint8)
    fin, _, _ = step._byte_inputs(copy_state(pred.state), data, code, 0, False, pred.plan, True)
    got = rl.fused_bound(pred.meta, pred.plan.fused, fin, 2)
    outs = fused.fused_substeps(pred.meta, pred.plan.fused, fin, True, True)
    ins, _ = fused.io_layout(pred.meta, True, True)
    moved = sum(t.numel() * t.element_size() for t in outs.values())
    moved += sum((fin if kind == "s" else pred.plan.fused)[n].numel() * (fin if kind == "s" else pred.plan.fused)[n]
                 .element_size() for n, _, _, kind in ins)
    moved += sum(pred.plan.fused[n].numel() * pred.plan.fused[n].element_size() for n in ("desc_i", "desc_f"))
    assert got["bytes_moved"] == moved
    assert got["bound_by"] == "bytes" and got["bound_ms"] == pytest.approx(1e3 * moved / rl.PEAK_BYTES_PER_S)
