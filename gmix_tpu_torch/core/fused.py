"""The 8 bit sub-steps of one byte as one function: a hand-written CUDA
kernel on a CUDA device, the eager torch loop on the CPU.

Counterpart of `gmix_tpu.core.fused`. `fused_substeps` takes the byte's
packed working sets (the layout of `io_layout`), runs for every stream the
indirect and match predict/learn, the PPM and LSTM interval bit predictions,
the 3-layer mixer forward with the triangular solve, the SSE/APM chain, the
arithmetic coder, the entropy metrics, the mixer SGD, and applies the
deferred per-bit write stacks at byte end. Gathers and scatters of arena
rows and all byte-boundary work stay outside, in `core/step.py`.

The kernel (csrc/fused_kernel.cuh, `fused_substeps_kernel`; its C interface
in csrc/fused.cu) replaces `gmix_tpu/core/fused.py:_kernel_body`. What
bounds it on an H100: at the reference widths without PPM and LSTM, 16
streams, one launch moves 5.1 MB (1.5 us at 3.35 TB/s) and does about 26
MFLOP (0.4 us at 67 TFLOP/s), so neither bytes nor operations are the floor:
the dependent chain of 8 sub-steps is, each a chain of block-wide stages
(predict, three mixer layers with a triangular solve, APM, coder, learn) on
one thread block per stream. The kernel's source note says what the design
does about it (lane-count instantiations, tables and rows in shared memory
by bulk asynchronous copy, the squarings of the solves on warps beside the
chain, the one-thread tail beside the learn stage) and PERF.md holds the
measured stage table. The launcher picks the instantiation from the sizes
(`fused_instantiation` reports it); this wrapper keeps what does not change
between bytes (sizes, checked constants, the io struct) on `consts`, so that
a call checks and sets only the per-stream pointers.
`fused_substeps_clocks` runs the same kernel with `clock64()` stored at
every stage boundary, for measurement.

`fused_substeps_plain` is the same function in eager torch, every float op
its own torch op in the order of gmix_tpu's `sub_step`; it is what runs on
CPU tensors, and what the kernel is held against, bitwise on every output
that can reach an archive (all but `ent` and `ema`, which go through log2).

Dtypes of the packed tensors: u32 lanes (`sc`, `coder`, `win_r`, `win_w`,
`bitregs`, `ind_rot`, `max_steps`, `match_byte`) are int64 holding
[0, 2^32), as everywhere in the port (state.py); `ind_blk` is the int16 bit
pattern of the u16 pairs `ns | rm << 8`, as the row mover gathers it; the
rest is float32 or int32 as in gmix_tpu. The kernel and the plain version
take the same tensors.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..ops import coder as coder_ops
from ..ops import kernels
from ..ops.murmur import MASK32
from ..ops.sigmoid import clamp_prob, logistic, logit, pow_det, rdiv
from ..ops.tables import nonstationary_table, run_map_table
from .meta import APM_BINS, APM_SPAN, Meta, analysis_names

F32 = torch.float32
I16 = torch.int16
I32 = torch.int32
I64 = torch.int64

# match-model bit masks by sub-step: the check mask tests the PREVIOUS bit
# (match.cpp:29 runs before bit_pos_ /= 2), the pred mask the current one
_CHECK_MASKS = (1, 128, 64, 32, 16, 8, 4, 2)
_PRED_MASKS = (128, 64, 32, 16, 8, 4, 2, 1)
# coder window: per byte the coder consumes/emits at most 32 renorm bytes
# (4 per bit) + a 4-byte decoder lookahead; the packed arrays are padded
CODER_WIN = 40
WIN_PAD = 64
# the mixer weight-decay factor, rounded to f32 as gmix_tpu computes it
_WD = float(np.float32(1.0) - np.float32(3e-6))
_FLT_MIN = float(np.finfo(np.float32).tiny)

# sc lane indices (packed per-stream scalars); SC_SAMPLE marks a sampling
# step, whose bits are drawn (`sample_u`, `inv_temp`) instead of read from
# the data byte
SC_DATA, SC_LB, SC_R1, SC_DECODE, SC_NOTFIRST, SC_SAMPLE = 0, 1, 2, 3, 4, 5
# coder-regs lane indices
CR_X1, CR_X2, CR_X, CR_WPOS, CR_RPOS, CR_ACC, CR_BITS, CR_NEWBIT = range(8)

# the widest mixer row the kernel takes (csrc/fused_kernel.cuh: kMaxQ)
_MAX_WP = 512


def _dims(meta: Meta) -> Dict[str, int]:
    """The static sizes the sub-steps depend on."""
    spec = meta.spec
    Klm = len(meta.mix_lm_ix)
    return dict(
        M=len(spec.indirects), NM=len(spec.matches), n0=meta.mix_n0, n1=meta.mix_n1,
        K=meta.mix_n0 + meta.mix_n1 + 1, WP=meta.mix_width_pad, SL=meta.mix_step_lane,
        n_pred=meta.n_pred, pl0=meta.prefix_lane0, pl12=meta.prefix_lane12,
        nskip=len(spec.skip_connection_cols),
        Kst=len(meta.mix_st_ix), Kp=len(meta.mix_pos_ix), Kcd=len(meta.mix_cd_ix),
        Kpd=len(meta.mix_pd_ix), Klm=Klm, Tlm=int(sum(meta.mix_lm_sizes)) if Klm else 0,
        NA=len(spec.apm), ppm=int(spec.ppm is not None), lstm=int(spec.lstm is not None),
        nc=len(analysis_names(spec)),
    )


def _check_mode(learn: bool, sample: bool) -> None:
    if sample and learn:
        raise ValueError("fused_substeps: sampling runs with learn off (gmix_tpu's generation chunk)")


def io_layout(meta: Meta, learn: bool, analysis: bool, sample: bool = False) -> Tuple[List, List]:
    """(inputs, outputs): lists of (name, shape_tail, dtype, kind); kind "s"
    = one row per stream (full shape (S,) + shape_tail), "c" = constant of
    the spec (full shape = shape_tail). The names, order and shape tails are
    those of gmix_tpu's `_io_layout`; the dtypes are the port's (module
    docstring): int64 where gmix_tpu has uint32, int16 for `ind_blk`.

    `sample` (learn off only) adds what gmix_tpu's fused kernel does not
    have, because it never samples: the 8 uniforms of each stream's byte and
    the inverse temperature, a constant-kind input that comes with each call
    (`CALL_INPUTS`). The sampled byte leaves as the coder's `acc` lane."""
    _check_mode(learn, sample)
    d = _dims(meta)
    M, NM, K, WP = d["M"], d["NM"], d["K"], d["WP"]
    ins: List = [
        ("sc", (8,), I64, "s"),
        ("coder", (8,), I64, "s"),
        ("win_r", (WIN_PAD,), I64, "s"),
        ("ent", (1,), F32, "s"),
        ("mix_lrs", (1, K), F32, "c"),
    ]
    outs: List = [
        ("coder", (8,), I64, "s"),
        ("win_w", (WIN_PAD,), I64, "s"),
        ("bitregs", (8,), I64, "s"),
        ("ent", (1,), F32, "s"),
    ]
    if M:
        ins += [
            ("ind_blk", (M, 256), I16, "s"),
            ("ind_rot", (M,), I64, "s"),
            ("p_tbl", (2 * M, 256), F32, "s"),
            ("ind_lrs", (1, 2 * M), F32, "c"),
        ]
        if learn:
            ins += [("ns_next", (2, 256), I32, "c"), ("rm_next", (2, 256), I32, "c")]
            outs += [("ind_blk", (M, 256), I16, "s"), ("p_tbl", (2 * M, 256), F32, "s")]
    for name, rows in (("rows_st", d["Kst"]), ("rows_pos", d["Kp"] * 8), ("rows_cd", d["Kcd"]),
                       ("blocks_pd", d["Kpd"] * 8), ("lm_tbl", d["Tlm"] if d["Klm"] else 0)):
        if rows:
            ins.append((name, (rows, WP), F32, "s"))
            if learn:
                outs.append((name, (rows, WP), F32, "s"))
    ins.append(("max_steps", (K,), I64, "s"))
    if learn:
        outs.append(("max_steps", (K,), I64, "s"))
    if d["NA"]:
        ins.append(("apm_rows", (d["NA"], 8 * APM_BINS), F32, "s"))
        if learn:
            outs.append(("apm_rows", (d["NA"], 8 * APM_BINS), F32, "s"))
    if d["ppm"]:
        ins += [("ppm_probs", (256,), F32, "s"), ("ppm_regs", (4,), I32, "s")]
        outs.append(("ppm_regs", (4,), I32, "s"))
    if d["lstm"]:
        ins += [("lstm_probs", (256,), F32, "s"), ("lstm_regs", (4,), I32, "s")]
        outs.append(("lstm_regs", (4,), I32, "s"))
    if NM:
        ins += [
            ("match_len", (NM,), I32, "s"),
            ("match_byte", (NM,), I64, "s"),
            ("mt_pred", (NM, 256), F32, "s"),
            ("mt_cnt", (NM, 256), I32, "s"),
            ("match_limits", (1, NM), I32, "c"),
        ]
        outs.append(("match_len", (NM,), I32, "s"))
        if learn:
            outs += [("mt_pred", (NM, 256), F32, "s"), ("mt_cnt", (NM, 256), I32, "s")]
    if analysis:
        ins.append(("ema", (d["nc"],), F32, "s"))
        outs.append(("ema", (d["nc"],), F32, "s"))
    if sample:
        ins += [("sample_u", (8,), F32, "s"), ("inv_temp", (1, 1), F32, "c")]
    return ins, outs


# constant-kind inputs that are not constants of the spec: they come with each
# call in `fin`, not from `const_inputs`
CALL_INPUTS = ("inv_temp",)


class FusedConsts(dict):
    """The constants of a spec by name, and what the kernel's wrapper keeps
    with them between launches (`launch_plans`)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.launch_plans: Dict = {}


def const_inputs(meta: Meta, learn: bool, device="cpu") -> FusedConsts:
    """The constants of a spec, built once and kept on `device`.

    `mix_lrs`, `ind_lrs`, `ns_next`, `rm_next` and `match_limits` are
    gmix_tpu's broadcast-constant kernel inputs. The rest is the static
    structure that gmix_tpu's kernel body reads from `meta` while it is
    traced: the five class index lists and `mix_perm` as index tensors (the
    plain version indexes with them), and the same structure flattened into
    `desc_i` / `desc_f`, which the CUDA kernel reads, so that one compiled
    kernel serves every spec."""
    dev = torch.device(device)
    d = _dims(meta)
    spec = meta.spec

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    out = FusedConsts(mix_lrs=t(meta.mix_lrs, F32)[None, :])
    if spec.indirects:
        out["ind_lrs"] = t(meta.ind_lrs, F32)[None, :]
        if learn:
            ns = np.asarray(nonstationary_table(), np.int32)
            rm = np.asarray(run_map_table(), np.int32)
            out["ns_next"] = t(np.stack([ns[0::2], ns[1::2]]), I32)
            out["rm_next"] = t(np.stack([rm[0::2], rm[1::2]]), I32)
    if spec.matches:
        out["match_limits"] = t(meta.match_limits, I32)[None, :]
    for name in ("mix_perm", "mix_st_ix", "mix_pos_ix", "mix_cd_ix", "mix_pd_ix"):
        out[name] = t(getattr(meta, name), I64)

    # k-order -> (class, index within the class); classes in concat order
    # [stable, pos, ctx-dense, pos-dense, longest-match]
    classes = (meta.mix_st_ix, meta.mix_pos_ix, meta.mix_cd_ix, meta.mix_pd_ix, meta.mix_lm_ix)
    k_class = np.zeros((d["K"],), np.int32)
    k_index = np.zeros((d["K"],), np.int32)
    concat = []
    for c, ix in enumerate(classes):
        for i, k in enumerate(np.asarray(ix, np.int64)):
            k_class[k], k_index[k] = c, i
            concat.append(int(k))
    if sorted(concat) != list(range(d["K"])) or [concat[int(p)] for p in meta.mix_perm] != list(range(d["K"])):
        raise ValueError("meta.mix_perm is not the inverse of the class concat order")
    lm_sizes = np.asarray(meta.mix_lm_sizes, np.int32).reshape(-1)
    lm_offs = np.concatenate([[0], np.cumsum(lm_sizes)])[: len(lm_sizes)].astype(np.int32)
    out["desc_i"] = t(np.concatenate([
        k_class, k_index, lm_sizes, lm_offs, np.asarray(spec.skip_connection_cols, np.int32).reshape(-1),
    ]), I32)
    wg = np.asarray(meta.apm_weights, np.float32).reshape(-1)
    # [weights | 1 - weights (rounded in f32) | learning rates]
    out["desc_f"] = t(np.concatenate([wg, np.float32(1.0) - wg, np.asarray(meta.apm_lrs, np.float32).reshape(-1)]), F32)
    return out


def pack_inputs(meta: Meta, stm: Dict, metrics: Dict, work: Dict, packed: Dict, analysis: bool,
                inv_temp: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The kernel inputs of one byte by name, in `io_layout`'s shapes
    (gmix_tpu step.py, the fused branch of `_byte_step`), as views: `packed`
    holds what core/inputs.py computes (`sc`, `coder`, `win_r`, the dense
    rows, ...), `work` the gathered working sets and the other leaves under
    their layout names, `rows_pos` and `blocks_pd` as (S, K, 8, WP). A
    sampling step passes `inv_temp` (a one-element float32 tensor on the
    device) and `packed["sample_u"]`, which go in as `io_layout(...,
    sample=True)` names them."""
    S = packed["sc"].shape[0]
    fin = {}
    for name, tail, _, kind in io_layout(meta, False, analysis, inv_temp is not None)[0]:
        if kind != "s":
            if name in CALL_INPUTS:
                fin[name] = inv_temp.reshape(1, 1)
        elif name == "ent":
            fin[name] = metrics["ent"][:, None].contiguous()
        elif name == "ema":
            fin[name] = metrics["ema"]
        elif name in ("match_len", "match_byte"):
            fin[name] = stm[name]
        else:  # rows_pos and blocks_pd fold their (K, 8) axes, kp-major
            fin[name] = (packed[name] if name in packed else work[name]).reshape((S,) + tail)
    return fin


def unpack_outputs(meta: Meta, fo: Dict[str, torch.Tensor], stm: Dict, coder: Dict, metrics: Dict, work: Dict):
    """Put the kernel outputs of one byte back: registers into `stm`, `coder`
    and `metrics` in place, the head registers and (after a learning step)
    the learned working sets into `work`, in the shapes `pack_inputs` took
    them. Returns
    (win_w (S, CODER_WIN), bitregs (S, 4))."""
    co = fo["coder"]
    coder.update(x1=co[:, CR_X1], x2=co[:, CR_X2], x=co[:, CR_X], wpos=co[:, CR_WPOS], rpos=co[:, CR_RPOS])
    stm.update(acc=co[:, CR_ACC], bits_seen=co[:, CR_BITS], new_bit=co[:, CR_NEWBIT])
    metrics["ent"] = fo["ent"][:, 0]
    for name, v in fo.items():
        if name in ("coder", "ent", "win_w", "bitregs"):
            continue
        if name == "ema":
            metrics["ema"] = v
        elif name == "match_len":
            stm["match_len"] = v
        elif name == "lm_tbl":
            work[name] = list(torch.split(v, [int(T) for T in meta.mix_lm_sizes], dim=1))
        elif name in ("rows_pos", "blocks_pd"):
            work[name] = v.reshape(v.shape[0], -1, 8, v.shape[2])
        else:
            work[name] = v
    return fo["win_w"][:, :CODER_WIN], fo["bitregs"][:, :4]


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _onehot_rows(oh: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """The row of each (S, T, WP) table that the (S, T) one-hot selects.

    gmix_tpu reads these rows with a one-hot float sum, and XLA (on the CPU
    and on the TPU) treats denormal inputs of that sum as zero. The bitcast
    steps counter in lane mix_step_lane is a denormal below 2^23, so in
    gmix_tpu a dense row's counter reads back as 0 at every byte start. A
    table of one row takes no sum there and keeps every bit, a -0.0
    included. The port reproduces both, so that its archives stay
    gmix_tpu's."""
    if tbl.shape[1] == 1:
        return torch.where(oh[:, 0, None], tbl[:, 0], 0.0)
    rows = torch.where(oh[:, :, None], tbl, 0.0).sum(dim=1)
    return torch.where(rows.abs() < _FLT_MIN, 0.0, rows)


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the LAST axis with a fixed binary tree of elementwise adds
    (zero padding to a power of two is exact), as gmix_tpu's _tree_sum."""
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _matmul_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (S, n, n) @ (S, n, n) as a forward loop over j of f32 fused
    multiply-adds from +0: acc = fma(a[:, :, j], b[:, j, :], acc), each with
    the single rounding of a hardware FMA (the CUDA kernel's `__fmaf_rn`).

    The product of two f32 values is exact in f64. Its f64 sum with the f32
    accumulator is rounded to odd (the TwoSum error term says whether the sum
    was inexact and on which side the exact value lies) before the cast to
    f32: rounding 53 bits to odd and then 24 bits to nearest equals rounding
    the exact value once. A plain f64 add rounds twice and differs from the
    FMA about once in 1e9 steps."""
    prod = a.to(torch.float64)[:, :, :, None] * b.to(torch.float64)[:, None, :, :]  # (S, i, j, k)
    acc = torch.zeros_like(a)
    inf = torch.full_like(prod[:, :, 0], float("inf"))
    for j in range(a.shape[-1]):
        p = prod[:, :, j]
        a64 = acc.to(torch.float64)
        s = a64 + p
        bb = s - a64
        err = (a64 - (s - bb)) + (p - bb)  # exact: a64 + p == s + err
        even = (s.view(I64) & 1) == 0
        s = torch.where((err != 0) & even, torch.nextafter(s, torch.copysign(inf, err)), s)
        acc = s.to(F32)
    return acc


def _tri_solve(lmat: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Solve y = d + L_strict @ y, i.e. (I - tril(L, -1)) y = d, batched.

    A = tril(L, -1) is nilpotent, so (I-A)^-1 = (I+A)(I+A^2)(I+A^4)...
    (gmix_tpu.core.step._tri_solve)."""
    n = lmat.shape[-1]
    if n <= 1:
        return d
    a = torch.tril(lmat, -1)
    y = d + _tree_sum(a * d[:, None, :])
    cover = 2  # y now includes A^0..A^(cover-1) d
    while cover < n:
        a = _matmul_fma(a, a)
        y = y + _tree_sum(a * y[:, None, :])
        cover *= 2
    return y


def _interval_pred(probs, top, bot, mid, nb, first: bool, ar256):
    """One bit of a byte distribution's binary search (PPM and LSTM heads):
    narrow [bot, top] by the last bit, then the logit of the upper half's
    share of the interval's mass."""
    if not first:
        one = nb == 1
        bot = torch.where(one, mid + 1, bot)
        top = torch.where(one, top, mid)
    mid = bot + torch.div(top - bot, 2, rounding_mode="floor")
    num = _tree_sum(torch.where((ar256 >= mid[:, None] + 1) & (ar256 <= top[:, None]), probs, 0.0))
    den = num + _tree_sum(torch.where((ar256 >= bot[:, None]) & (ar256 <= mid[:, None]), probs, 0.0))
    nz = den != 0
    p = torch.where(nz, num / torch.where(nz, den, 1.0), 0.5)
    return torch.where(nz, logit(p), 0.0), top, bot, mid


def fused_substeps_plain(meta: Meta, consts: Dict[str, torch.Tensor], fin: Dict[str, torch.Tensor],
                         learn: bool, analysis: bool, sample: bool = False) -> Dict[str, torch.Tensor]:
    """The 8 sub-steps and the deferred writes in eager torch, on the packed
    inputs; returns the outputs of `io_layout`. Every float op is its own
    torch op (see core/step.py's docstring).

    With `sample` a stream whose `sc[:, SC_SAMPLE]` is set codes, in encode
    mode, the bit it draws: 1 when its uniform `sample_u[:, j]` is below the
    tempered probability `logistic(logit(p) * inv_temp)` of the APM chain's
    output p (gmix_tpu step.py:1111-1119, where the unfused sub-step samples)."""
    _check_mode(learn, sample)
    d = _dims(meta)
    spec = meta.spec
    M, NM, n0, n1, K, WP, SL = d["M"], d["NM"], d["n0"], d["n1"], d["K"], d["WP"], d["SL"]
    n_pred, nskip, NA = d["n_pred"], d["nskip"], d["NA"]
    Kst, Kp, Kcd, Kpd, Klm = d["Kst"], d["Kp"], d["Kcd"], d["Kpd"], d["Klm"]

    sc = fin["sc"]
    S, dev = sc.shape[0], sc.device
    data_byte, last_byte, recent1 = sc[:, SC_DATA], sc[:, SC_LB], sc[:, SC_R1]
    dec = sc[:, SC_DECODE] != 0
    not_first = sc[:, SC_NOTFIRST] != 0
    if sample:
        smp = sc[:, SC_SAMPLE] != 0
        sample_u, inv_temp = fin["sample_u"], fin["inv_temp"][0]
    cr = fin["coder"]
    x1, x2, x = cr[:, CR_X1], cr[:, CR_X2], cr[:, CR_X]
    wpos, rpos = cr[:, CR_WPOS], cr[:, CR_RPOS]
    acc, bits_seen, new_bit = cr[:, CR_ACC], cr[:, CR_BITS], cr[:, CR_NEWBIT]
    wpos0, rpos0 = wpos, rpos
    win_r = fin["win_r"]
    win_w = torch.zeros((S, WIN_PAD), dtype=I64, device=dev)
    ent = fin["ent"][:, 0]
    ema = fin["ema"] if analysis else None
    mix_lrs = consts["mix_lrs"]

    lane256 = torch.arange(256, device=dev)
    win_lanes = torch.arange(WIN_PAD, device=dev)
    k4 = torch.arange(4, device=dev)[None, :]
    arange8 = torch.arange(8, device=dev)
    sl_is = (torch.arange(WP, device=dev) == SL)[None, None, :]
    tril0 = torch.tril(torch.ones((n0, n0), dtype=F32, device=dev), -1)[None]
    tril1 = torch.tril(torch.ones((n1, n1), dtype=F32, device=dev), -1)[None]
    apm_bins = torch.arange(APM_BINS, device=dev, dtype=I32)[None, :]

    def zeros(n):
        return torch.zeros((S, n), dtype=F32, device=dev)

    if M:
        ind_blk0 = fin["ind_blk"].to(I32) & 0xFFFF  # (S, M, 256) ns | rm<<8
        ind_rot = fin["ind_rot"]
        p_tbl0 = fin["p_tbl"]
        ind_lrs = consts["ind_lrs"]
    if NM:
        mt_pred0, mt_cnt0 = fin["mt_pred"], fin["mt_cnt"]
        match_len, match_byte = fin["match_len"], fin["match_byte"]
        match_limits = consts["match_limits"]
    rows_stable = fin["rows_st"] if Kst else torch.zeros((S, 0, WP), dtype=F32, device=dev)
    if Kp:
        rows_pos = fin["rows_pos"].reshape(S, Kp, 8, WP)
        rows_pos = rows_pos.clone() if learn else rows_pos
    rows_cd = fin["rows_cd"] if Kcd else torch.zeros((S, 0, WP), dtype=F32, device=dev)
    if Kpd:
        blocks_pd = fin["blocks_pd"].reshape(S, Kpd, 8, WP)
        blocks_pd = blocks_pd.clone() if learn else blocks_pd
    lm_sizes = [int(T) for T in meta.mix_lm_sizes] if Klm else []
    lm_tbls = list(torch.split(fin["lm_tbl"], lm_sizes, dim=1)) if Klm else []
    lm_aranges = [torch.arange(T, device=dev)[None, :] for T in lm_sizes]
    max_steps = fin["max_steps"]
    if NA:
        apm_rows = fin["apm_rows"].clone() if learn else fin["apm_rows"]
    if d["ppm"]:
        ppm_probs = fin["ppm_probs"]
        ppm_top, ppm_bot, ppm_mid = fin["ppm_regs"][:, 0], fin["ppm_regs"][:, 1], fin["ppm_regs"][:, 2]
    if d["lstm"]:
        lstm_probs = fin["lstm_probs"]
        l_top, l_bot, l_mid = fin["lstm_regs"][:, 0], fin["lstm_regs"][:, 1], fin["lstm_regs"][:, 2]

    longest = torch.zeros((S,), dtype=I64, device=dev)
    bit_ctx = lb_ctx = slb_ctx = longest

    # deferred per-bit table writes (gmix_tpu step.py:817-828): each bit
    # records (slot, delta) into an (S, 8, *) stack; reads are corrected
    # against earlier same-slot deltas; the stacks apply once at byte end
    if learn and M:
        ib_lane = torch.full((S, 8, M), -1, dtype=I32, device=dev)
        ib_del = torch.zeros((S, 8, M), dtype=I32, device=dev)
        pt_slot = torch.full((S, 8, 2 * M), -1, dtype=I32, device=dev)
        pt_del = torch.zeros((S, 8, 2 * M), dtype=F32, device=dev)
    if learn and NM:
        mp_slot = torch.full((S, 8, NM), -1, dtype=I32, device=dev)
        mp_del = torch.zeros((S, 8, NM), dtype=F32, device=dev)
        mc_del = torch.zeros((S, 8, NM), dtype=I32, device=dev)

    for j in range(8):
        prev8 = (arange8 < j)[None, :, None]  # sub-steps before this one
        # bits_seen counts every bit except the very first
        # (basic-contexts.cpp:23-28); it doubles as the mixer steps counter
        inc = (not_first | (j > 0)).to(I64)
        bits_seen = (bits_seen + inc) & MASK32
        bit_ctx = ((1 << j) + acc) - 1  # recent_bits - 1
        lb_ctx = ((last_byte << 8) + bit_ctx) & MASK32
        slb_ctx = ((recent1 << 8) + bit_ctx) & MASK32

        # ---- indirect models (indirect.cpp:28-45): reads from the
        # byte-start block snapshot; the 8 bit_ctx lanes of a byte are
        # disjoint, so no sub-step reads a lane an earlier one wrote ----
        if M:
            lane_sel = (bit_ctx[:, None] + ind_rot) & 255  # (S, M)
            pair = torch.gather(ind_blk0, 2, lane_sel[:, :, None]).squeeze(2)  # ns | rm<<8
            ns_raw, rm_raw = pair & 255, pair >> 8
            active_ind = torch.cat([ns_raw != 255, rm_raw != 0], dim=1)
            # ns state 255 (unseen) predicts/learns/advances from slot 0
            st_eff = torch.cat([torch.where(ns_raw == 255, 0, ns_raw), rm_raw], dim=1)  # (S, 2M)
            p_cur = torch.gather(p_tbl0, 2, st_eff.to(I64)[:, :, None]).squeeze(2)
            if learn:
                same_pt = pt_slot == st_eff[:, None, :]  # (S, 8, 2M)
                p_cur = p_cur + _tree_sum((pt_del * (same_pt & prev8)).movedim(1, -1))
            ind_preds = torch.where(active_ind, p_cur, 0.0)  # (S, 2M) [ns | rm]
            # interleave to the prediction-column order [ns0, rm0, ns1, rm1, ...]
            ind_pair = torch.stack([ind_preds[:, :M], ind_preds[:, M:]], dim=2).reshape(S, 2 * M)
        else:
            ind_pair = zeros(0)

        # ---- match models (match.cpp:25-74); j == 0's length update ran
        # in the byte-boundary pointer logic ----
        if NM:
            if j > 0:
                hit = new_bit[:, None] == ((match_byte & _CHECK_MASKS[j]) != 0).to(I64)
                match_len = torch.where(hit, torch.clamp(match_len + 1, max=255), 0)
            pred_mask = _PRED_MASKS[j]
            mlen = match_len
            mlen64 = mlen.to(I64)[:, :, None]
            active = mlen > 2
            mp = torch.gather(mt_pred0, 2, mlen64).squeeze(2)
            if learn:
                same_mp = mp_slot == mlen[:, None, :]  # (S, 8, NM)
                mp = mp + _tree_sum((mp_del * (same_mp & prev8)).movedim(1, -1))
            p_prob = torch.where((match_byte & pred_mask) != 0, mp, 1.0 - mp)
            match_preds = torch.where(active, logit(p_prob), 0.0)
            longest = torch.amax(torch.div(mlen, 32, rounding_mode="floor"), dim=1).to(I64)
        else:
            match_preds = zeros(0)

        # ---- PPM / LSTM interval bit predictions; the byte distributions
        # are inputs (their byte-boundary work is outside the sub-steps) ----
        head = []
        if d["ppm"]:
            lg, ppm_top, ppm_bot, ppm_mid = _interval_pred(ppm_probs, ppm_top, ppm_bot, ppm_mid, new_bit, j == 0, lane256)
            head.append(lg[:, None])
        if d["lstm"]:
            lg, l_top, l_bot, l_mid = _interval_pred(lstm_probs, l_top, l_bot, l_mid, new_bit, j == 0, lane256)
            head.append(lg[:, None])

        # prediction vector, column order [heads..., ind pairs..., matches...]
        preds = torch.cat(head + [ind_pair, match_preds], dim=1)
        skip_preds = preds[:, list(spec.skip_connection_cols)] if nskip else zeros(0)

        # ---- mixers (mixer.cpp:51-106) ----
        parts = [rows_stable]
        if Kp:
            parts.append(rows_pos[:, :, j])
        parts.append(rows_cd)
        if Kpd:
            parts.append(blocks_pd[:, :, j])
        lm_ohs = []
        if Klm:
            lm_rows = []
            for i in range(Klm):
                oh = lm_aranges[i] == longest[:, None]  # (S, T)
                lm_ohs.append(oh)
                lm_rows.append(_onehot_rows(oh, lm_tbls[i]))
            parts.append(torch.stack(lm_rows, dim=1))
        rows = torch.cat(parts, dim=1)[:, consts["mix_perm"]]  # (S, K, WP)
        stepv = rows[:, :, SL].view(I32).to(I64) & MASK32  # bitcast steps counters
        # forward view with the steps lane zeroed (a select, so a NaN bit
        # pattern in that lane cannot leak into the dot products)
        rows_f = torch.where(sl_is, 0.0, rows)

        # bit-prefix input features: +-1 for the byte's bits seen so far
        if meta.prefix_lane0 >= 0:
            sh = torch.clamp(j - 1 - arange8, 0, 31)[None, :]
            bits8 = (acc[:, None] >> sh) & 1
            pfx = torch.where((arange8 < j)[None, :], 2.0 * bits8.to(F32) - 1.0, 0.0)  # (S, 8)
        else:
            pfx = zeros(0)
        npf = pfx.shape[1]

        base0 = torch.cat([preds, zeros(n0), pfx, zeros(WP - n_pred - n0 - npf)], dim=1)
        d0 = _tree_sum(rows_f[:, :n0] * base0[:, None, :])
        y0 = _tri_solve(rows_f[:, :n0, n_pred : n_pred + n0], d0) if n0 > 1 else d0

        tail = zeros(WP - n0 - n1 - nskip - npf)
        base1 = torch.cat([y0, zeros(n1), skip_preds, pfx, tail], dim=1)
        d1 = _tree_sum(rows_f[:, n0 : n0 + n1] * base1[:, None, :])
        y1 = _tri_solve(rows_f[:, n0 : n0 + n1, n0 : n0 + n1], d1) if n1 > 1 else d1

        base2 = torch.cat([y0, y1, skip_preds, pfx, tail], dim=1)
        final_logit = _tree_sum(rows_f[:, K - 1] * base2)
        prob = clamp_prob(logistic(final_logit))

        # ---- SSE/APM refinement chain (config.ApmStage) ----
        if NA:
            apm_slices, apm_wvs, apm_pvs = [], [], []
            apm_l, apm_p = final_logit, prob
            for a in range(NA):
                row = apm_rows[:, a, j * APM_BINS : (j + 1) * APM_BINS]
                pos = (torch.clamp(apm_l, -APM_SPAN, APM_SPAN) + APM_SPAN) * ((APM_BINS - 1) / (2 * APM_SPAN))
                i0 = torch.clamp(pos.to(I32), max=APM_BINS - 2)
                w = pos - i0.to(F32)
                wv = torch.where(apm_bins == i0[:, None], 1.0 - w[:, None], 0.0) + torch.where(
                    apm_bins == i0[:, None] + 1, w[:, None], 0.0
                )
                pv = (row * wv).sum(dim=1)  # two nonzero terms: exact in any order
                wgt = float(meta.apm_weights[a])
                apm_p = clamp_prob(wgt * pv + float(np.float32(1.0) - np.float32(wgt)) * apm_p)
                apm_l = logit(apm_p)
                apm_slices.append(row)
                apm_wvs.append(wv)
                apm_pvs.append(pv)
            prob = apm_p

        # ---- arithmetic coder (encoder.cpp:10-25 / decoder.cpp:19-39), the
        # direction a per-stream lane ----
        enc_bit = (data_byte >> (7 - j)) & 1
        if sample:
            # temperature sampling (runner-utils.cpp:202-206)
            p_temp = logistic(logit(prob) * inv_temp)
            enc_bit = torch.where(smp, (sample_u[:, j] < p_temp).to(I64), enc_bit)
        off_r = (rpos - rpos0)[:, None] + k4  # (S, 4) window lanes
        in_bytes = torch.where(off_r < WIN_PAD, torch.gather(win_r, 1, torch.clamp(off_r, max=WIN_PAD - 1)), 0)
        bit, (x1, x2, x), emits, nren = coder_ops.coder_bit(
            coder_ops.CoderState(x1, x2, x), coder_ops.discretize(prob), enc_bit, in_bytes, dec
        )
        nren = nren.to(I64)
        # each window lane is written at most once per byte, so the
        # add-accumulate is exact
        valid = (k4 < nren[:, None]) & ~dec[:, None]
        off_w = (wpos - wpos0)[:, None] + k4
        sel_w = (off_w[:, :, None] == win_lanes[None, None, :]) & valid[:, :, None]
        win_w = win_w + torch.where(sel_w, emits[:, :, None], 0).sum(dim=1)
        wpos = (wpos + torch.where(dec, 0, nren)) & MASK32
        rpos = (rpos + torch.where(dec, nren, 0)) & MASK32

        # cumulative cross-entropy (bits) and the per-column analysis EMA
        # (UpdateEntropy alpha=1e-5, metric probability clamped at 0.01)
        p_bit = torch.where(bit == 1, prob, 1.0 - prob)
        ent = ent - torch.log2(p_bit)
        if analysis:
            col_logits = torch.cat([preds, y0, y1, final_logit[:, None]], dim=1)
            p_cols = torch.clamp(logistic(col_logits), 0.01, 0.99)
            pb_cols = torch.where((bit == 1)[:, None], p_cols, 1.0 - p_cols)
            ema = ema + 1e-5 * (-torch.log2(pb_cols) - ema)

        bitf = bit.to(F32)

        if learn and NA:
            # APM learn: move the two interpolation bins toward the bit
            for a in range(NA):
                new_row = apm_slices[a] + float(meta.apm_lrs[a]) * (bitf - apm_pvs[a])[:, None] * apm_wvs[a]
                apm_rows[:, a, j * APM_BINS : (j + 1) * APM_BINS] = new_row

        if learn and M:
            # indirect Learn (indirect.cpp:47-70): the state->logit delta and
            # the advanced state pair go into the byte stacks
            delta = (bitf[:, None] - logistic(p_cur)) * ind_lrs
            b1 = (bit == 1)[:, None]
            ns_nx = torch.where(b1, consts["ns_next"][1][None, :], consts["ns_next"][0][None, :])  # (S, 256)
            rm_nx = torch.where(b1, consts["rm_next"][1][None, :], consts["rm_next"][0][None, :])
            st64 = st_eff.to(I64)
            new_ns = torch.gather(ns_nx, 1, st64[:, :M])
            new_rm = torch.gather(rm_nx, 1, st64[:, M:])
            new_pair = new_ns | (new_rm << 8)
            ib_lane[:, j] = lane_sel.to(I32)
            ib_del[:, j] = new_pair - pair
            pt_slot[:, j] = st_eff
            pt_del[:, j] = delta

        if learn and NM:
            # match per-bit Learn (match.cpp:79-90)
            hit2 = (bit[:, None] == ((match_byte & pred_mask) != 0).to(I64)).to(F32)
            cnt = torch.gather(mt_cnt0, 2, mlen64).squeeze(2)
            cnt = cnt + (mc_del * (same_mp & prev8)).sum(dim=1, dtype=I32)
            grow = cnt < match_limits
            cnt_new = torch.where(grow, cnt + 1, cnt)
            lr = rdiv(1.0, torch.where(grow, cnt_new, match_limits).to(F32))
            mp_new = mp + (hit2 - mp) * lr
            upd_on = mlen > 2  # only matched rows learn (match.cpp:79)
            mp_slot[:, j] = mlen
            mp_del[:, j] = torch.where(upd_on, mp_new - mp, 0.0)
            mc_del[:, j] = (upd_on & grow).to(I32)

        if learn:
            # mixer Learn (mixer.cpp:108-176) on the working rows
            steps_f = bits_seen.to(F32)
            decay_global = rdiv(0.9, pow_det(1e-7 * steps_f + 0.8, 0.8))
            y_all = torch.cat([y0, y1, final_logit[:, None]], dim=1)  # (S, K)
            novelty = 1.5 - stepv.to(F32) / max_steps.to(F32)
            upd = decay_global[:, None] * novelty * mix_lrs * (logistic(y_all) - bitf[:, None])
            # input matrix: per-layer base + strictly-lower in-layer part
            in0 = base0[:, None, :].expand(S, n0, WP).clone()
            in0[:, :, n_pred : n_pred + n0] = y0[:, None, :] * tril0
            in1 = base1[:, None, :].expand(S, n1, WP).clone()
            in1[:, :, n0 : n0 + n1] = y1[:, None, :] * tril1
            inputs = torch.cat([in0, in1, base2[:, None, :]], dim=1)  # (S, K, WP)
            # inputs are 0 in the steps lane, which is rewritten below with
            # the incremented bitcast counter
            w_new = rows - upd[:, :, None] * inputs
            steps_new = (stepv + 1) & MASK32
            wd = (steps_new & 1023) == 0  # weight decay every 1024 context-steps
            w_new = w_new * torch.where(wd, _WD, 1.0)[:, :, None]
            w_new = torch.where(sl_is, steps_new.to(I32).view(F32)[:, :, None], w_new)
            # route the updated rows back to their class working sets
            if Kst:
                rows_stable = w_new[:, consts["mix_st_ix"]]
            if Kp:
                rows_pos[:, :, j] = w_new[:, consts["mix_pos_ix"]]
            if Kcd:
                rows_cd = w_new[:, consts["mix_cd_ix"]]
            if Kpd:
                blocks_pd[:, :, j] = w_new[:, consts["mix_pd_ix"]]
            if Klm:
                lm_tbls = [
                    torch.where(lm_ohs[i][:, :, None], w_new[:, int(meta.mix_lm_ix[i])][:, None, :], lm_tbls[i])
                    for i in range(Klm)
                ]
            max_steps = torch.maximum(max_steps, steps_new)

        # advance the bit registers
        new_bit = bit
        acc = ((acc << 1) | bit) & MASK32

    zero = torch.zeros((S,), dtype=I64, device=dev)
    fo: Dict[str, torch.Tensor] = {
        "coder": torch.stack([x1, x2, x, wpos, rpos, acc, bits_seen, new_bit], dim=1),
        "win_w": win_w,
        "bitregs": torch.stack([bit_ctx, lb_ctx, slb_ctx, longest, zero, zero, zero, zero], dim=1),
        "ent": ent[:, None],
    }
    # ---- apply the deferred per-bit table writes, in sub-step order: dense
    # passes, in which a lane no slot hits still takes its eight additions
    # of del * 0 ----
    if learn and M:
        lane = lane256[None, None, :]
        ib, pt = ind_blk0, p_tbl0
        for jj in range(8):
            ib = ib + ib_del[:, jj, :, None] * (lane == ib_lane[:, jj, :, None])
            pt = pt + pt_del[:, jj, :, None] * (lane == pt_slot[:, jj, :, None])
        fo["ind_blk"], fo["p_tbl"] = ib.to(I16), pt
    if learn and NM:
        lane = lane256[None, None, :]
        mtp, mtc = mt_pred0, mt_cnt0
        for jj in range(8):
            eq = lane == mp_slot[:, jj, :, None]
            mtp = mtp + mp_del[:, jj, :, None] * eq
            mtc = mtc + mc_del[:, jj, :, None] * eq
        fo["mt_pred"], fo["mt_cnt"] = mtp, mtc
    if analysis:
        fo["ema"] = ema
    if learn:
        if Kst:
            fo["rows_st"] = rows_stable
        if Kp:
            fo["rows_pos"] = rows_pos.reshape(S, Kp * 8, WP)
        if Kcd:
            fo["rows_cd"] = rows_cd
        if Kpd:
            fo["blocks_pd"] = blocks_pd.reshape(S, Kpd * 8, WP)
        if Klm:
            fo["lm_tbl"] = torch.cat(lm_tbls, dim=1)
        fo["max_steps"] = max_steps
        if NA:
            fo["apm_rows"] = apm_rows
    z32 = torch.zeros((S,), dtype=I32, device=dev)
    if d["ppm"]:
        fo["ppm_regs"] = torch.stack([ppm_top, ppm_bot, ppm_mid, z32], dim=1)
    if d["lstm"]:
        fo["lstm_regs"] = torch.stack([l_top, l_bot, l_mid, z32], dim=1)
    if NM:
        fo["match_len"] = match_len
    return fo


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

# pointer slots of the C struct FusedIO (csrc/fused_kernel.cuh), in its order
_IN_SLOTS = (
    "sc", "coder", "win_r", "ent", "mix_lrs", "ind_blk", "ind_rot", "p_tbl", "ind_lrs", "ns_next", "rm_next",
    "rows_st", "rows_pos", "rows_cd", "blocks_pd", "lm_tbl", "max_steps", "apm_rows", "ppm_probs", "ppm_regs",
    "lstm_probs", "lstm_regs", "match_len", "match_byte", "mt_pred", "mt_cnt", "match_limits", "ema",
    "desc_i", "desc_f", "sample_u", "inv_temp",
)
_OUT_SLOTS = (
    "coder", "win_w", "bitregs", "ent", "ind_blk", "p_tbl", "rows_st", "rows_pos", "rows_cd", "blocks_pd",
    "lm_tbl", "max_steps", "apm_rows", "ppm_regs", "lstm_regs", "match_len", "mt_pred", "mt_cnt", "ema",
    "clocks",
)
# int64 fields of the C struct FusedDims, in its order
_DIM_SLOTS = (
    "S", "M", "NM", "n0", "n1", "WP", "SL", "n_pred", "pl0", "pl12", "nskip", "Kst", "Kp", "Kcd", "Kpd",
    "Klm", "Tlm", "NA", "ppm", "lstm", "nc", "learn", "analysis", "sample",
)
_IN_AT = {n: i for i, n in enumerate(_IN_SLOTS)}
_OUT_AT = {n: len(_IN_SLOTS) + i for i, n in enumerate(_OUT_SLOTS)}

# FusedIO is all pointers, so an array of them has its layout and takes a
# pointer by index
_FusedIO = ctypes.c_void_p * (len(_IN_SLOTS) + len(_OUT_SLOTS))


class _FusedDims(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int64) for n in _DIM_SLOTS]


# the stage clocks of the kernel's clocks instantiation (csrc/fused_kernel.cuh,
# ClockCol): columns of its (S, 8, len(CLOCK_COLS)) int64 output, in SM
# cycles. Thread 0 reads the clock where it leaves each stage of each
# sub-step (CLOCK_SUBSTEP, in order) and at the launch's own boundaries
# (CLOCK_LAUNCH, row 0 only). CLOCK_SIDE are read by the warps that work
# beside thread 0: the first thread of those that prepare the triangular
# solves (row offsets ready, squarings done) and of those that learn while
# thread 0 runs the tail (per-model steps done, rows updated).
CLOCK_SUBSTEP = (
    "predict", "rows_wait", "layer0_dots", "squarings_wait", "layer0_solve", "layer1_dots", "layer1_solve",
    "final_dot", "tail_apm_learn", "learn_wait",
)
CLOCK_LAUNCH = ("start", "loaded", "deferred", "writeback", "end")
CLOCK_SIDE = ("prep_rows", "prep_done", "learn_models_done", "learn_rows_done")
CLOCK_COLS = CLOCK_SUBSTEP + CLOCK_LAUNCH + CLOCK_SIDE


class _LaunchPlan:
    """What a launch needs that does not change from byte to byte, for one
    (consts, learn, analysis, sample, S, device): the sizes, the io struct
    with the checked constants' pointers in it, and the slots of the inputs
    that come with each call (per stream, and `CALL_INPUTS`), which each
    call checks and fills."""

    def __init__(self, meta: Meta, consts: Dict[str, torch.Tensor], learn: bool, analysis: bool, sample: bool,
                 S: int, dev):
        d = _dims(meta)
        if d["WP"] > _MAX_WP or d["WP"] % 32:
            raise ValueError(f"fused_substeps: the kernel takes mixer rows of up to {_MAX_WP} lanes, a multiple of 32; got {d['WP']}")
        ins, outs = io_layout(meta, learn, analysis, sample)
        self.io = _FusedIO()
        self.stream_ins = []  # (slot, name, shape, dtype)
        fixed = {}  # the constants: (tensor, shape, dtype) by name
        for name, tail, dtype, kind in ins:
            if kind == "s" or name in CALL_INPUTS:
                full = (S,) + tail if kind == "s" else tail
                self.stream_ins.append((_IN_AT[name], name, torch.Size(full), dtype))
            else:
                fixed[name] = (consts[name], tail, dtype)
        for name, dtype in (("desc_i", I32), ("desc_f", F32)):
            fixed[name] = (consts[name], consts[name].shape, dtype)
        kernels.check("fused_substeps", fixed, aligned=tuple(fixed), dev=dev)
        for name, (t, _, _) in fixed.items():
            self.io[_IN_AT[name]] = t.data_ptr()
        self.outs = [(_OUT_AT[name], name, (S,) + tail, dtype) for name, tail, dtype, _ in outs]
        self.dims = _FusedDims(S=S, learn=int(learn), analysis=int(analysis), sample=int(sample),
                               **{n: d[n] for n in _DIM_SLOTS if n in d})
        self.dims_ref, self.io_ref = ctypes.byref(self.dims), ctypes.byref(self.io)
        # which of the kernel's instantiations these sizes take
        groups, shared_tables, shared_bytes = kernels.fused_plan(self.dims_ref)
        self.instantiation = {"lane_groups": groups, "tables_in_shared_memory": bool(shared_tables),
                              "shared_bytes": shared_bytes}
        # the shared-memory opt-in on this device now, not at the first
        # launch: a CUDA graph capture records the launch and runs nothing
        kernels.fused_prepare(dev, self.dims_ref)


def _launch_plan(meta, consts, learn: bool, analysis: bool, sample: bool, S: int, dev) -> _LaunchPlan:
    plans = consts.launch_plans  # `consts` is const_inputs()'s FusedConsts
    key = (learn, analysis, sample, S, dev)
    if key not in plans:
        plans[key] = _LaunchPlan(meta, consts, learn, analysis, sample, S, dev)
    return plans[key]


def _launch(meta, consts, fin, learn: bool, analysis: bool, sample: bool, clocks: bool):
    """The launch's plan and io filled with this call's inputs (checked) and
    fresh outputs; the kernel (or with `clocks` its clocks instantiation)
    launched. Returns (outputs, clocks or None)."""
    dev = kernels.cuda_device("fused_substeps", "sc", fin["sc"])
    plan = _launch_plan(meta, consts, learn, analysis, sample, fin["sc"].shape[0], dev)
    io = plan.io
    ins = {name: (fin[name], shape, dtype) for _, name, shape, dtype in plan.stream_ins}
    kernels.check("fused_substeps", ins, aligned=tuple(ins), dev=dev)
    for slot, name, _, _ in plan.stream_ins:
        io[slot] = fin[name].data_ptr()
    fo: Dict[str, torch.Tensor] = {}
    for slot, name, shape, dtype in plan.outs:
        fo[name] = t = torch.empty(shape, dtype=dtype, device=dev)
        io[slot] = t.data_ptr()
    if not clocks:
        kernels.call("fused_substeps", dev, plan.dims_ref, plan.io_ref)
        return fo, None
    clk = torch.zeros((fin["sc"].shape[0], 8, len(CLOCK_COLS)), dtype=I64, device=dev)
    io[_OUT_AT["clocks"]] = clk.data_ptr()
    try:
        kernels.fused_clocks(dev, plan.dims_ref, plan.io_ref)
    finally:
        io[_OUT_AT["clocks"]] = None
    return fo, clk


@obs.in_part("fused")
def fused_substeps(meta: Meta, consts: Dict[str, torch.Tensor], fin: Dict[str, torch.Tensor],
                   learn: bool, analysis: bool, sample: bool = False) -> Dict[str, torch.Tensor]:
    """The 8 bit sub-steps of one byte for every stream: the CUDA kernel on
    CUDA tensors, the plain version on CPU tensors. `consts` is
    `const_inputs(meta, learn, device)`, `fin` the inputs of `io_layout`
    that are not constants of the spec; returns its outputs. `sample` (with
    learn off) is the sampling mode of `fused_substeps_plain`; the kernel
    reads which streams sample from `sc` as it reads the direction. What a
    launch needs beyond the per-call pointers is made at the first call and
    kept on `consts`."""
    if fin["sc"].device.type == "cpu":
        return fused_substeps_plain(meta, consts, fin, learn, analysis, sample)
    return _launch(meta, consts, fin, learn, analysis, sample, clocks=False)[0]


def fused_substeps_clocks(meta: Meta, consts: Dict[str, torch.Tensor], fin: Dict[str, torch.Tensor],
                          learn: bool, analysis: bool):
    """(outputs, clocks): the kernel's clocks instantiation on CUDA tensors,
    for measurement. It computes what `fused_substeps` computes while thread
    0 of every block stores `clock64()` at every stage boundary; `clocks` is
    (S, 8, len(CLOCK_COLS)) int64 SM cycles. The codec never calls it, and
    it does not count as a launch of the main path's kernel."""
    return _launch(meta, consts, fin, learn, analysis, False, clocks=True)


def prepare(meta: Meta, consts: Dict[str, torch.Tensor], learn: bool, analysis: bool, sample: bool, S: int,
            device) -> None:
    """Make the launch of this kind on a CUDA `device` ready before a CUDA
    graph capture records it: the launch plan, and with it the kernel's
    shared-memory opt-in on that device."""
    _launch_plan(meta, consts, learn, analysis, sample, S, _cuda_device(device))


def _cuda_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def fused_instantiation(meta: Meta, consts: Dict[str, torch.Tensor], learn: bool, analysis: bool, S: int, device) -> Dict:
    """Which instantiation of the kernel a launch at these sizes takes: the
    32-lane groups of a mixer row it is unrolled for, whether the byte's
    look-up tables have room in shared memory beside the working rows (else
    they stay in global memory), and the block's shared memory in bytes."""
    return dict(_launch_plan(meta, consts, learn, analysis, False, S, _cuda_device(device)).instantiation)

