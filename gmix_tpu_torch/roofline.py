"""The byte step's roofline on the H100: the work of one encode byte step,
counted from the spec, the least time the card could take for it, and the
shares of its peaks that a measured step reaches.

The counterpart of the cost-analysis half of tools/tpu_profile.py, which
read XLA's count of the compiled chunk (flops, bytes accessed) and printed
flops and bytes a bit, the achieved rates and their shares of the chip's
peaks. Torch has no cost analysis of a CUDA graph, and a count of the port's
~1 100 eager ops a step would change with every op folded into a kernel. So
`step_work` counts the work the model needs, from its Meta alone (the
leaves' shapes come from `init_state` on the "meta" device, which allocates
no tensor), the same whatever implements it. `roofline` sets a step time
against it. The kernel table of `chip_smoke.py` bounds each kernel with
`tensor_bytes`, `fused_float_ops` and `fused_bound`, over the same peaks.

Counting rules of `step_work`, per stream (every count is proportional to
the streams):

- Each state byte the step needs is read once and each one it changes is
  written once, at gmix_tpu's dtypes (`state.numpy_layout`: a u32 that the
  port carries as int64 counts 4 bytes). A register leaf (a per-stream
  vector) is read and written whole, once, in the part that owns it; the two
  byte distributions the step computes anew (`ppm_probs`, the LSTM's
  `probs`) are only written.
- Rows picked by an index count as the picked rows: `ind/st` blocks, mixer
  rows and position groups, APM and PPM rows (PPM's twice: the count update's
  rows and the prediction's), match and IH words, history bytes. The
  state-to-probability tables of the indirect and match models count one
  entry a sub-step for each of their rows.
- A one-hot selection counts the selected row, not the T rows it is formed
  from: the ctx-dense mixer rows (`_onehot_rows`) and the LSTM's symbol
  column of `w_sym`. The position-dense blocks (8 rows) and the
  longest-match tables (at most 32 rows) are read and written whole.
- The LSTM's forward pass reads the gate weights and the current epoch's
  output layer whole and writes the epoch's slot of the recorded window; its
  per-byte SGD writes the next epoch's output layer. The backward pass reads
  the recorded window, the output layers' C cell rows of every epoch, the
  weights and their Adam moments, and writes the weights and moments, once
  every `horizon` bytes: its counts are divided by the horizon.
- Intermediates count nothing: the packed inputs of the sub-steps, the
  working sets between the gather and the scatter, the copy-back. Neither do
  the spec's constants, nor the two 0-d leaves shared by all streams (the
  LSTM's epoch and step count, 8 bytes).
- The coder: the input byte read and one code byte written (an archive the
  size of its input; the bench's archives are about a quarter of it).
- `float_ops`: every float add, subtract, multiply, divide, min or max is 1;
  a dot product counts 2 per multiply-add; a sum of n terms n - 1; a
  transcendental (exp, tanh, logistic, logit, log2, square root, power)
  `TRANSCENDENTAL`; compares and selects nothing. The sub-steps count
  `fused_float_ops`, the kernel table's count.
- `int_ops`: the hashes (a murmur3 of a 4-byte key `MURMUR_U32`, of an
  8-byte key `MURMUR_U64`, a 32-bit multiply one op) with their key packing,
  every table index (`INDEX`: mask and offset), and the lane and bit-context
  arithmetic of each sub-step. They are printed and left out of the bound:
  the card's integer rate is not one of its published peaks.

Parts, the stages of `core/step.py`: `boundary` (`_boundary` without the
PPM update), `match` (the byte-boundary pointer logic), `ppm` (core/ppm.py:
count update and prediction), `lstm_forward` (the forward pass and the
output layer's SGD), `lstm_backward` (`lstm_bptt`, over the horizon),
`gather` (the working sets' rows), `sub_steps` (the 8 bits), `byte_end`
(`_byte_finish`: the scatters and dense write-back, history append,
match-table write, coder bytes). Their sum is the total.
"""
from __future__ import annotations

import math

from .core import fused
from .core.meta import Meta
from .state import init_state, numpy_layout

# NVIDIA H100 SXM, published peaks (dense, at the 700 W power limit): HBM3
# bytes a second, and float32 operations a second outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

PARTS = ("boundary", "match", "ppm", "lstm_forward", "lstm_backward", "gather", "sub_steps", "byte_end")
TRANSCENDENTAL = 60  # float operations of one exp, tanh, logistic, logit, log2, sqrt or pow
MURMUR_U32, MURMUR_U64 = 20, 31  # ops/murmur.py with 32-bit lanes: 11 a block, 1 for the length, 8 to finish
INDEX = 2  # a table index: mask, offset


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes: float, float_ops: float) -> dict:
    """The least time the card could take for `nbytes` moved and
    `float_ops` done: the larger of the two over their peaks, and which."""
    bytes_ms, ops_ms = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * float_ops / PEAK_F32_OPS_PER_S
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def fused_float_ops(meta: Meta, S: int, learn: bool, analysis: bool, sample: bool = False) -> int:
    """Float operations of one launch of the sub-steps, counted from the
    shapes: per sub-step the three layers' dots (2 per lane), the triangular
    solves (squarings of 2 n^3 and matrix-vector products of 2 n^2), ~60 per
    logistic/logit/log2 of a prediction column, the heads' interval sums, the
    SGD pass (3 per lane), a sampled bit's logit and logistic, and per byte
    the dense deferred passes (2 per lane and level)."""
    d = fused._dims(meta)
    M2, NM, K, WP = 2 * d["M"], d["NM"], d["K"], d["WP"]
    T = TRANSCENDENTAL
    per_sub = 2 * K * WP + T * (NM + 2 * d["NA"] + 1) + 2 * 256 * (d["ppm"] + d["lstm"])
    for n in (d["n0"], d["n1"]):
        if n > 1:
            squarings = max(int(math.ceil(math.log2(n))) - 1, 0)
            per_sub += squarings * 2 * n**3 + (squarings + 1) * 2 * n * n
    if analysis:
        per_sub += T * d["nc"]
    if sample:
        per_sub += 2 * T + 1
    if learn:
        per_sub += 3 * K * WP + T * (M2 + K) + 16 * (M2 + NM) + 3 * 33 * d["NA"]
    per_byte = 8 * per_sub + (16 * (M2 + NM) * 256 if learn else 0)
    return S * per_byte


def fused_bound(meta: Meta, consts, fin, S: int, learn: bool = True, sample: bool = False) -> dict:
    """The least time the card could take for one launch of the sub-steps at
    the main path's flags (analysis; learn, or the sampling mode): every
    input (`fin`, `consts` as `fused.io_layout` lists them, and the kernel's
    descriptors) read once and every output written once, at the tensors'
    own dtypes, over the memory rate, or the float operations over the
    float32 rate, whichever is larger."""
    ins, outs = fused.io_layout(meta, learn, True, sample)
    moved = tensor_bytes([(fin if kind == "s" or n in fused.CALL_INPUTS else consts)[n] for n, _, _, kind in ins])
    moved += tensor_bytes([consts["desc_i"], consts["desc_f"]])
    moved += sum(S * math.prod(tail) * dtype.itemsize for _, tail, dtype, _ in outs)
    ops = fused_float_ops(meta, S, learn, True, sample)
    return {"bytes_moved": moved, "float_ops": ops, **bound(moved, ops)}


def step_work(meta: Meta, S: int) -> dict:
    """The work of one encode byte step of `S` streams (the module's rules):
    `bytes`, `float_ops` and `int_ops` in all, the same a bit (one sub-step
    of every stream, `per_bit`), and by part (`parts`, in `PARTS` order).
    The step is the bench's: learning on, analysis off (no EMA)."""
    spec = meta.spec
    layout = numpy_layout(init_state(meta, 1, device="meta"))
    size = {p: math.prod(shape) * dtype.itemsize for p, (shape, dtype) in layout.items()}  # one stream's bytes

    def whole(*paths) -> float:
        return sum(size[p] for p in paths)

    def rows(n, path) -> float:  # n rows (words, bytes) of an arena (S, rows, ...); none of a missing one
        return n * size[path] / layout[path][0][1] if n else 0.0

    def entries(n, path) -> float:  # n entries of a (S, rows, 256) table
        return rows(n, path) / layout[path][0][2] if n else 0.0

    T = TRANSCENDENTAL
    M, NM, NA = len(spec.indirects), len(spec.matches), len(spec.apm)
    NI, NR, NIH = len(spec.interval_ctxs), len(spec.roll_ctxs), len(spec.ihash_ctxs)
    Kst, Kp, Kcd, Kpd = len(meta.mix_st_ix), len(meta.mix_pos_ix), len(meta.mix_cd_ix), len(meta.mix_pd_ix)
    one = dict.fromkeys(PARTS, (0.0, 0.0, 0.0))  # part -> (bytes read + written, float ops, int ops) a stream

    # boundary: the byte-context registers, the rolling and indirect hashes,
    # two IH words read and one written a context
    regs = ["stm/acc", "stm/last_byte", "stm/recent", "stm/ctx"]
    regs += ["stm/roll_h"] * (NR > 0) + ["stm/ih_outer_ctx", "stm/ih_outer_hash"] * (NIH > 0)
    key_bytes = (meta.skip_lo_on.sum(axis=1) + meta.skip_hi_on.sum(axis=1))[: len(spec.skip_ctxs)]
    one["boundary"] = (2 * whole(*regs) + rows(3 * NIH, "stm/ih_tbl"), 0,
                       NI * (3 + INDEX) + sum(int(2 * n - 1) + MURMUR_U64 for n in key_bytes)
                       + NR * (4 + MURMUR_U32) + NIH * (2 * 3 + MURMUR_U64 + MURMUR_U32 + 2 * INDEX))

    # match: pointer registers, a table word and a history byte a model
    if NM:
        regs = ("stm/match_ptr", "stm/match_byte", "stm/match_len")
        one["match"] = (2 * whole(*regs) + rows(NM, "ltm/match_tbl") + rows(NM, "ltm/hist"), 0, NM * 2 * INDEX)

    # PPM: the count update's rows (read, written) and the prediction's
    # (read), the SEE offsets, the head's interval registers
    if spec.ppm is not None:
        NO, NB = len(spec.ppm.orders), spec.ppm.see_buckets
        regs = ("stm/ppm_see", "stm/ppm_top", "stm/ppm_bot", "stm/ppm_mid")
        # a cascade a call: totals, PPM-C escapes, the SEE offsets, logit and logistic
        cascade = NO * ((256 - 1) + 3 + (2 * NB - 1) + 2 * T + 1)
        update = NO * (2 + 2 * NB)  # the SEE learn
        predict = NO * (4 + 3 * 256) + (256 - 1) + 1 + 256 + 2 * 256  # escape chain, terms, sum, order -1
        one["ppm"] = (rows(3 * NO, "stm/ppm_tbl") + 2 * whole(*regs) + whole("stm/ppm_probs"),
                      2 * cascade + update + predict, NO * 2 * (INDEX + 2))

    if spec.lstm is not None:
        ls = spec.lstm
        C, Hz, OUT = ls.num_cells, ls.horizon, ls.output_size
        LI = ls.input_size + C + 1
        L = "ltm/lstm/"
        R = "stm/lstm/"
        window = [R + k for k in ("layer_input", "norm", "ivar", "gate_state", "tanh_state", "in_gate",
                                  "last_state", "outputs")]
        regs = [R + k for k in ("cell", "hidden", "top", "bot", "mid")]
        nbytes = whole(L + "w_sym") / OUT + whole(L + "w_in", L + "gamma", L + "beta") + whole(L + "out_w") / Hz
        nbytes += (whole("stm/ppm_probs") if spec.ppm is None else 0) + 2 * whole(*regs)
        nbytes += whole(*window) / Hz + whole(R + "probs")  # the epoch's slot of the window; the distribution
        nbytes += whole(R + "in_hist", L + "out_w") / Hz  # the output layer's SGD into the next epoch's slot
        flops = (3 * C * 2 * LI  # the gate products with the symbol column
                 + 3 * (2 * C + 2 + T)  # the layer norm's inverse deviation: squares, sum, mean, eps, 1 / sqrt
                 + 3 * C * 3 + 3 * C * T  # norm, gain, bias; two logistic gates and the tanh node
                 + C * (1 + 3 + T + 1)  # input gate, cell, tanh, hidden
                 + 2 * (C + 1) * OUT  # logits
                 + OUT + OUT * (1 + T) + (OUT - 1) + OUT  # softmax
                 + OUT + (C + 1) + 2 * (C + 1) * OUT)  # the SGD
        one["lstm_forward"] = (nbytes, flops, 0)
        params = [L + k for k in ("w_sym", "sym_m", "sym_v", "w_in", "in_m", "in_v", "gamma", "beta",
                                  "gamma_m", "gamma_v", "beta_m", "beta_v")]
        carried = (R + "old_input", R + "stored_err", R + "state_err")
        nbytes = whole(*window, R + "in_hist") + whole(L + "out_w") * C / (C + 1) + 2 * whole(*carried, *params)
        n_params = 3 * C * OUT + 3 * C * LI + 6 * C
        flops = (Hz * OUT + 2 * Hz * C * OUT + (Hz - 1) * C  # output errors through every layer
                 + Hz * (51 * C + 6 * C * LI)  # gate errors, norm projection, gradient sums
                 + (Hz - 1) * (2 * C + 6 * C * C)  # the hidden gradient
                 + n_params * (13 + T))  # Adam
        one["lstm_backward"] = (nbytes / Hz, flops / Hz, 0)

    # the gather: every arena's rows and the dense arena's byte rows
    dense_rows = Kcd + 8 * Kpd + int(sum(meta.mix_lm_sizes))
    rows_moved = (rows(M, "ltm/ind/st") + rows(Kst, "ltm/mix_w") + rows(Kp, "ltm/mix_pos") + rows(NA, "ltm/apm")
                  + rows(dense_rows, "ltm/mix_dense"))
    one["gather"] = (rows_moved, 0, INDEX * (M + Kst + Kp + NA + Kcd) + 3 * M)

    # the sub-steps: coder and bit registers, one entry a bit of each
    # indirect and match table row (read, and written after learning), the
    # match counts and the mixers' step maxima
    regs = ["coder/x1", "coder/x2", "coder/x", "coder/wpos", "coder/rpos", "stm/bits_seen", "stm/new_bit",
            "metrics/ent"]
    picked = entries(8 * 2 * M, "ltm/ind/p") + entries(8 * NM, "ltm/match_pred")
    learned = entries(8 * NM, "ltm/match_cnt") + whole("ltm/mix_max_steps")
    one["sub_steps"] = (2 * whole(*regs) + 2 * picked + 2 * learned, fused_float_ops(meta, 1, True, False),
                        8 * (8 + 2 * M))

    # the byte end: the working sets back, the history append, the match
    # table's words, the input byte in and a code byte out
    nbytes = 2 + rows_moved + rows(1, "ltm/hist") + rows(NM, "ltm/match_tbl") + 2 * whole("stm/hist_n")
    one["byte_end"] = (nbytes, 0, 2)

    parts = {p: {"bytes": S * b, "float_ops": S * f, "int_ops": S * i} for p, (b, f, i) in one.items()}
    totals = {k: sum(w[k] for w in parts.values()) for k in ("bytes", "float_ops", "int_ops")}
    return {**totals, "per_bit": {k: v / 8 for k, v in totals.items()}, "parts": parts}


def roofline(work: dict, step_ms: float) -> dict:
    """`work` (`step_work`) done in `step_ms` a byte step: the least time
    the card could take (`bound`), the float32 rate's share (`mfu`), the
    memory rate's (`hbm_share`), the bound's share of the step
    (`roofline_share`, the larger of the two) and the achieved rates."""
    step_s = step_ms / 1e3
    least = bound(work["bytes"], work["float_ops"])
    return {**least,
            "mfu": work["float_ops"] / (step_s * PEAK_F32_OPS_PER_S),
            "hbm_share": work["bytes"] / (step_s * PEAK_BYTES_PER_S),
            "roofline_share": least["bound_ms"] / step_ms,
            "achieved_gbps": work["bytes"] / step_s / 1e9,
            "achieved_gflops": work["float_ops"] / step_s / 1e9}


SHARES = ("mfu", "hbm_share", "roofline_share")
RATES = ("achieved_gbps", "achieved_gflops")
