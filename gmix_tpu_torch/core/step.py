"""The codec's byte step in eager PyTorch: boundary contexts, one gather of
the per-byte working sets, 8 bit sub-steps, the deferred per-bit writes, and
the byte-end scatters.

Port of `gmix_tpu.core.step._byte_step` for specs without PPM and without an
LSTM. The JAX function is the reference; this module keeps its expression
order op for op, because the decoder must replay the encoder's float updates
bit for bit, and because the port is held bitwise against it:

- Every float op is its own torch op. In particular nothing here uses
  `add/sub(alpha=)`, `addcmul`, `addcdiv`, `lerp`, `addmm` or `baddbmm`,
  which may contract `a*b+c` into one rounding on CUDA. XLA:CPU does
  contract inside jitted programs, so the port follows gmix_tpu run eagerly
  (`jax.disable_jit()`), where every op rounds on its own.
- Inexact float reductions are fixed binary trees (`_tree_sum`). Where
  gmix_tpu sums a one-hot selection, the port gathers (integers) or sums
  the same selection (floats): a sum with one nonzero term is exact in any
  order.
- `_tri_solve`'s A@A product is a forward loop over j with a fused
  multiply-add emulated in float64 and rounded to float32 per step: XLA:CPU's
  batched einsum equals that loop at the tiny spec's widths, and the loop
  gives the same bits on the CPU and on a GPU.

The step updates the state dict in place: the arenas are scattered into
where they lie instead of being copied every byte. u32 values are int64
tensors in [0, 2^32) (see state.py).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..ops import coder as coder_ops
from ..ops.murmur import MASK32, murmur3_u32, murmur3_u64
from ..ops.rowmove import gather_rows, scatter_rows
from ..ops.sigmoid import clamp_prob, logistic, logit, pow_det, rdiv
from ..ops.tables import nonstationary_table, run_map_table
from .meta import APM_BINS, APM_SPAN, Meta

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64

_NS_NEXT = nonstationary_table()
_RM_NEXT = run_map_table()
# match-model bit masks by sub-step: the check mask tests the PREVIOUS bit
# (match.cpp:29 runs before bit_pos_ /= 2), the pred mask the current one
_CHECK_MASKS = (1, 128, 64, 32, 16, 8, 4, 2)
_PRED_MASKS = (128, 64, 32, 16, 8, 4, 2, 1)
# coder window: per byte the coder consumes/emits at most 32 renorm bytes
# (4 per bit) + a 4-byte decoder lookahead
CODER_WIN = 40
# the mixer weight-decay factor, rounded to f32 as gmix_tpu computes it
_WD = float(np.float32(1.0) - np.float32(3e-6))
_FLT_MIN = float(np.finfo(np.float32).tiny)


class StepPlan:
    """The byte step's constants for one (meta, stream count, device): index
    vectors and small tables, moved to the device once."""

    def __init__(self, meta: Meta, num_streams: int, device):
        spec = meta.spec
        if spec.ppm is not None or spec.lstm is not None:
            raise NotImplementedError("the torch port runs specs without PPM and LSTM only")
        self.meta = meta
        self.S = num_streams
        self.device = torch.device(device)

        def t(a, dtype=I64):
            return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

        self.s_ix = torch.arange(num_streams, device=self.device)[:, None]
        self.lane256 = torch.arange(256, device=self.device)
        self.win_lanes = torch.arange(CODER_WIN, device=self.device)
        self.k4 = torch.arange(4, device=self.device)[None, :]
        self.byte_ctx_cols = t(meta.byte_ctx_cols)
        self.bitreg_ctx_cols = t(meta.bitreg_ctx_cols)
        # boundary contexts
        self.interval_maps = t(meta.interval_maps)
        self.interval_slots = t(meta.interval_slots)
        self.interval_shifts = t(meta.interval_shifts)[None, :]
        self.interval_masks = t(meta.interval_masks)[None, :]
        self.skip_gather = t(meta.skip_gather)
        self.skip_lo_sh, self.skip_hi_sh = t(meta.skip_lo_sh), t(meta.skip_hi_sh)
        self.skip_lo_on = t(meta.skip_lo_on, torch.bool)
        self.skip_hi_on = t(meta.skip_hi_on, torch.bool)
        self.skip_slots = t(meta.skip_slots)
        self.ih_offsets = t(meta.ih_offsets)[None, :]
        self.ih_masks = t(meta.ih_masks)[None, :]
        self.ih_imask = t(meta.ih_inner_mods.astype(np.int64) - 1)[None, :]
        self.ih_omask = t(meta.ih_outer_mods.astype(np.int64) - 1)[None, :]
        self.ih_out_slots = t(meta.ih_out_slots)
        # indirect models
        self.ind_ctx_slots = t(meta.ind_ctx_slots)
        self.ind_blk_masks = t(meta.ind_blk_masks)[None, :]
        self.ind_blk_offsets = t(meta.ind_blk_offsets)[None, :]
        self.ind_rotate = t(meta.ind_rotate)[None, :]
        self.ind_lrs = t(meta.ind_lrs, F32)[None, :]
        self.ns_next = [t(_NS_NEXT[b::2], I32)[None, :] for b in (0, 1)]
        self.rm_next = [t(_RM_NEXT[b::2], I32)[None, :] for b in (0, 1)]
        # match models
        self.match_ctx_slots = t(meta.match_ctx_slots)
        self.match_masks = t(meta.match_masks)[None, :]
        self.match_offsets = t(meta.match_offsets)[None, :]
        self.match_limits = t(meta.match_limits, I32)[None, :]
        # mixers
        self.mix_st_slots = t(meta.mix_st_slots)
        self.mix_st_masks = t(meta.mix_st_masks)[None, :]
        self.mix_st_offsets = t(meta.mix_st_offsets)[None, :]
        self.mix_pos_slots = t(meta.mix_pos_slots)
        self.mix_pos_masks = t(meta.mix_pos_masks)[None, :]
        self.mix_pos_offsets = t(meta.mix_pos_offsets)[None, :]
        self.mix_st_ix, self.mix_pos_ix = t(meta.mix_st_ix), t(meta.mix_pos_ix)
        self.mix_cd_ix, self.mix_pd_ix = t(meta.mix_cd_ix), t(meta.mix_pd_ix)
        self.mix_perm = t(meta.mix_perm)
        self.mix_lrs = t(meta.mix_lrs, F32)[None, :]
        self.cd_aranges = [torch.arange(int(T), device=self.device)[None, :] for T in meta.mix_cd_sizes]
        self.lm_aranges = [torch.arange(int(T), device=self.device)[None, :] for T in meta.mix_lm_sizes]
        WP, SL = meta.mix_width_pad, meta.mix_step_lane
        self.sl_is = (torch.arange(WP, device=self.device) == SL)[None, None, :]
        n0, n1 = meta.mix_n0, meta.mix_n1
        self.tril0 = torch.tril(torch.ones((n0, n0), dtype=F32, device=self.device), -1)[None]
        self.tril1 = torch.tril(torch.ones((n1, n1), dtype=F32, device=self.device), -1)[None]
        i8 = np.arange(8)
        # prefix-input lanes per sub-step j: the shift of each seen bit
        # position, and which of the 8 positions are seen
        self.pfx_shift = [t(np.clip(j - 1 - i8, 0, 31))[None, :] for j in range(8)]
        self.pfx_seen = [t(i8 < j, torch.bool)[None, :] for j in range(8)]
        self.arange8 = torch.arange(8, device=self.device)
        # APM
        self.apm_ctx_slots = t(meta.apm_ctx_slots)
        self.apm_masks = t(meta.apm_masks)[None, :]
        self.apm_offsets = t(meta.apm_offsets)[None, :]
        self.apm_bins = torch.arange(APM_BINS, device=self.device, dtype=I32)[None, :]


def _onehot_rows(oh: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """The row of each (S, T, WP) table that the (S, T) one-hot selects.

    gmix_tpu reads these rows with a one-hot float sum, and XLA (on the CPU
    and on the TPU) treats denormal inputs of that sum as zero. The bitcast
    steps counter in lane mix_step_lane is a denormal below 2^23, so in
    gmix_tpu a dense row's counter reads back as 0 at every byte start. A
    table of one row takes no sum there and keeps its counter. The port
    reproduces both, so that its archives stay gmix_tpu's."""
    rows = torch.where(oh[:, :, None], tbl, 0.0).sum(dim=1)
    if tbl.shape[1] == 1:
        return rows
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
    multiply-adds from +0: acc = fma(a[:, :, j], b[:, j, :], acc). The
    product of two f32 values is exact in f64; each step adds it to the f32
    accumulator in f64 and rounds once to f32 (an in-place f32 += f64
    computes in f64)."""
    prod = a.to(torch.float64)[:, :, :, None] * b.to(torch.float64)[:, None, :, :]  # (S, i, j, k)
    acc = torch.zeros_like(a)
    for j in range(a.shape[-1]):
        acc.add_(prod[:, :, j])
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


def _boundary(stm: Dict, t: int, plan: StepPlan) -> None:
    """Byte-boundary contexts (gmix_tpu.core.step._boundary without the PPM
    and LSTM branches); updates stm in place."""
    meta = plan.meta
    spec = meta.spec
    s_ix = plan.s_ix
    completed = stm["acc"]
    if t > 0:
        last_byte = completed
        recent = torch.cat([completed[:, None], stm["recent"][:, :-1]], dim=1)
    else:
        last_byte, recent = stm["last_byte"], stm["recent"]
    ctx = stm["ctx"].clone()
    ctx[:, plan.byte_ctx_cols] = torch.cat([last_byte[:, None], recent[:, 1:10]], dim=1)

    # interval contexts (interval-context.cpp:17-23)
    if spec.interval_ctxs:
        vals = plan.interval_maps[:, last_byte].T  # (S, NI)
        old = ctx[:, plan.interval_slots]
        ctx[:, plan.interval_slots] = plan.interval_masks & ((old << plan.interval_shifts) + vals)

    # skip hashes (skip-context.cpp:9-19): bytes packed big-endian into a u64
    if spec.skip_ctxs:
        bg = recent[:, plan.skip_gather]  # (S, NSK, MAX_SKIP)
        lo = torch.where(plan.skip_lo_on, bg << plan.skip_lo_sh, 0).sum(dim=2) & MASK32
        hi = torch.where(plan.skip_hi_on, bg << plan.skip_hi_sh, 0).sum(dim=2) & MASK32
        ctx[:, plan.skip_slots] = murmur3_u64(lo, hi)

    # indirect-hash contexts (indirect-hash.cpp:16-31), one flat arena of
    # u32 values stored as int32 bits
    if spec.ihash_ctxs:
        f = stm["ih_tbl"]
        old_idx = (stm["ih_outer_hash"] & plan.ih_masks) + plan.ih_offsets
        inner = f[s_ix, old_idx].to(I64) & MASK32
        inner_new = ((inner & plan.ih_imask) << 8) + last_byte[:, None]
        f[s_ix, old_idx] = inner_new.to(I32)
        outer_new = ((stm["ih_outer_ctx"] & plan.ih_omask) << 8) + last_byte[:, None]
        new_hash = murmur3_u64(outer_new, torch.zeros_like(outer_new))
        new_idx = (new_hash & plan.ih_masks) + plan.ih_offsets
        ctx[:, plan.ih_out_slots] = murmur3_u32(f[s_ix, new_idx].to(I64) & MASK32)
        stm["ih_outer_ctx"], stm["ih_outer_hash"] = outer_new, new_hash

    stm.update(last_byte=last_byte, recent=recent, acc=torch.zeros_like(completed), ctx=ctx)


def _byte_step(state: Dict, data_buf: torch.Tensor, code_buf: torch.Tensor, t: int,
               decode: bool, plan: StepPlan, learn: bool = True, analysis: bool = True):
    """One byte for all S streams: boundary work, 8 bit sub-steps, byte-end
    learn. Updates `state` and `data_buf[:, t]` in place and returns the
    encoder's renorm bytes of this input byte: (win (S, 40) u8, nw (S,) u8).
    Decode reads the code stream from `code_buf` (S, cap) u8."""
    meta = plan.meta
    spec = meta.spec
    stm, ltm, coder, metrics = state["stm"], state["ltm"], state["coder"], state["metrics"]
    S, s_ix = plan.S, plan.s_ix
    M = len(spec.indirects)
    n0, n1 = meta.mix_n0, meta.mix_n1
    K = n0 + n1 + 1
    WP = meta.mix_width_pad
    SL = meta.mix_step_lane
    NM = len(spec.matches)
    NA = len(spec.apm)
    n_pred = meta.n_pred
    dev = plan.device

    # ---- byte boundary: contexts ----
    _boundary(stm, t, plan)
    data_byte = data_buf[:, t].to(I64)

    # ---- match byte-boundary pointer logic (match.cpp:38-58) ----
    if NM:
        hit = stm["new_bit"][:, None] == ((stm["match_byte"] & _CHECK_MASKS[0]) != 0).to(I64)
        mlen = torch.where(hit, torch.clamp(stm["match_len"] + 1, max=255), 0)
        mlen = torch.where(stm["match_ptr"] == ((stm["hist_n"] - 1) & MASK32)[:, None], 0, mlen)
        mcv = stm["ctx"][:, plan.match_ctx_slots]
        match_ix = (mcv & plan.match_masks) + plan.match_offsets
        tbl_ptr = ltm["match_tbl"][s_ix, match_ix].to(I64) & MASK32
        mptr = torch.where(mlen < 8, tbl_ptr, (stm["match_ptr"] + 1) & MASK32)
        hb = ltm["hist"][s_ix, mptr & (meta.history_size - 1)]
        mbyte = torch.where((stm["hist_n"] > 0)[:, None], hb.to(I64), stm["match_byte"])
        stm.update(match_ptr=mptr, match_byte=mbyte, match_len=mlen)

    # ---- gather the per-byte working sets (byte-stable gating contexts) ----
    ctx_byte = stm["ctx"]
    ind_ctx_vals = ctx_byte[:, plan.ind_ctx_slots]  # (S, M)
    blk_ix = ((ind_ctx_vals & plan.ind_blk_masks) + plan.ind_blk_offsets).to(I32)
    # hash-derived lane rotation (gmix_tpu step.py:709-716)
    ind_rot = ((ind_ctx_vals >> 16) & 255) * plan.ind_rotate  # (S, M)
    ind_blk = gather_rows(ltm["ind"]["st"], blk_ix)  # (S, M, 256) int16 bits
    ind_blk0 = ind_blk.to(I32) & 0xFFFF
    p_tbl0 = ltm["ind"]["p"]  # (S, 2M, 256)
    Kst, Kp = len(meta.mix_st_ix), len(meta.mix_pos_ix)
    Kcd, Kpd, Klm = len(meta.mix_cd_ix), len(meta.mix_pd_ix), len(meta.mix_lm_ix)
    if Kst:
        rowix_st = ((ctx_byte[:, plan.mix_st_slots] & plan.mix_st_masks) + plan.mix_st_offsets).to(I32)
        rows_stable = gather_rows(ltm["mix_w"], rowix_st)  # (S, Kst, WP)
    else:
        rows_stable = torch.zeros((S, 0, WP), dtype=F32, device=dev)
    if Kp:
        posix = ((ctx_byte[:, plan.mix_pos_slots] & plan.mix_pos_masks) + plan.mix_pos_offsets).to(I32)
        rows_pos = gather_rows(ltm["mix_pos"], posix).view(S, Kp, 8, WP)
    dense0 = ltm.get("mix_dense")
    cd_oh: List[torch.Tensor] = []
    rows_cd_l = []
    for i in range(Kcd):
        off, T = int(meta.mix_cd_offsets[i]), int(meta.mix_cd_sizes[i])
        val = ctx_byte[:, int(meta.mix_cd_slots[i])] & (T - 1)
        oh = plan.cd_aranges[i] == val[:, None]  # (S, T)
        cd_oh.append(oh)
        rows_cd_l.append(_onehot_rows(oh, dense0[:, off : off + T]))
    rows_cd = torch.stack(rows_cd_l, dim=1) if Kcd else torch.zeros((S, 0, WP), dtype=F32, device=dev)
    if Kpd:
        blocks_pd = torch.stack([dense0[:, int(o) : int(o) + 8] for o in meta.mix_pd_offsets], dim=1)
    lm_tbls = [
        dense0[:, int(meta.mix_lm_offsets[i]) : int(meta.mix_lm_offsets[i]) + int(meta.mix_lm_sizes[i])]
        for i in range(Klm)
    ]
    max_steps = ltm["mix_max_steps"]
    if NA:
        apm_ix = ((ctx_byte[:, plan.apm_ctx_slots] & plan.apm_masks) + plan.apm_offsets).to(I32)
        apm_rows = gather_rows(ltm["apm"], apm_ix)  # (S, NA, 8*APM_BINS)
    if NM:
        mt_pred0, mt_cnt0 = ltm["match_pred"], ltm["match_cnt"]

    # ---- coder byte window: the decoder's input bytes, read once per byte ----
    cap_total = code_buf.shape[1]
    rpos0, wpos0 = coder["rpos"], coder["wpos"]
    if decode:
        look = rpos0[:, None] + plan.win_lanes[None, :]
        win_r = torch.where(
            look < cap_total, code_buf[s_ix, torch.clamp(look, max=cap_total - 1)].to(I64), 0
        )

    # ---- deferred per-bit table writes (gmix_tpu step.py:817-828): each
    # bit records (slot, delta) into an (S, 8, *) stack; reads are corrected
    # against earlier same-slot deltas; the stacks apply once at byte end ----
    win_w = torch.zeros((S, CODER_WIN), dtype=I64, device=dev)
    if learn:
        ib_lane = torch.full((S, 8, M), -1, dtype=I32, device=dev)
        ib_del = torch.zeros((S, 8, M), dtype=I32, device=dev)
        pt_slot = torch.full((S, 8, 2 * M), -1, dtype=I32, device=dev)
        pt_del = torch.zeros((S, 8, 2 * M), dtype=F32, device=dev)
        if NM:
            mp_slot = torch.full((S, 8, NM), -1, dtype=I32, device=dev)
            mp_del = torch.zeros((S, 8, NM), dtype=F32, device=dev)
            mc_del = torch.zeros((S, 8, NM), dtype=I32, device=dev)

    for j in range(8):
        prev8 = (plan.arange8 < j)[None, :, None]  # sub-steps before this one
        acc = stm["acc"]
        # bits_seen counts every bit except the very first
        # (basic-contexts.cpp:23-28); it doubles as the mixer steps counter
        inc = 0 if (t == 0 and j == 0) else 1
        bits_seen = (stm["bits_seen"] + inc) & MASK32
        bit_ctx = ((1 << j) + acc) - 1  # recent_bits - 1
        lb_ctx = ((stm["last_byte"] << 8) + bit_ctx) & MASK32
        slb_ctx = ((stm["recent"][:, 1] << 8) + bit_ctx) & MASK32

        # ---- indirect models (indirect.cpp:28-45): reads from the
        # byte-start block snapshot; the 8 bit_ctx lanes of a byte are
        # disjoint, so no sub-step reads a lane an earlier one wrote ----
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

        # ---- match models (match.cpp:25-74); j == 0's length update ran
        # in the byte-boundary pointer logic ----
        if NM:
            if j > 0:
                hit = stm["new_bit"][:, None] == ((stm["match_byte"] & _CHECK_MASKS[j]) != 0).to(I64)
                stm["match_len"] = torch.where(hit, torch.clamp(stm["match_len"] + 1, max=255), 0)
            pred_mask = _PRED_MASKS[j]
            mlen, mbyte = stm["match_len"], stm["match_byte"]
            mlen64 = mlen.to(I64)[:, :, None]
            active = mlen > 2
            mp = torch.gather(mt_pred0, 2, mlen64).squeeze(2)
            if learn:
                same_mp = mp_slot == mlen[:, None, :]  # (S, 8, NM)
                mp = mp + _tree_sum((mp_del * (same_mp & prev8)).movedim(1, -1))
            p_prob = torch.where((mbyte & pred_mask) != 0, mp, 1.0 - mp)
            match_preds = torch.where(active, logit(p_prob), 0.0)
            longest = torch.amax(torch.div(mlen, 32, rounding_mode="floor"), dim=1).to(I64)
        else:
            match_preds = torch.zeros((S, 0), dtype=F32, device=dev)
            longest = torch.zeros((S,), dtype=I64, device=dev)

        # prediction vector, column order [ind pairs..., matches...]
        preds = torch.cat([ind_pair, match_preds], dim=1)

        # ---- mixers (mixer.cpp:51-106) ----
        stm["bits_seen"] = bits_seen
        bitregs = torch.stack([bit_ctx, lb_ctx, slb_ctx, longest], dim=1)  # (S, 4)
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
                oh = plan.lm_aranges[i] == longest[:, None]  # (S, T)
                lm_ohs.append(oh)
                lm_rows.append(_onehot_rows(oh, lm_tbls[i]))
            parts.append(torch.stack(lm_rows, dim=1))
        rows = torch.cat(parts, dim=1)[:, plan.mix_perm]  # (S, K, WP)
        stepv = rows[:, :, SL].view(I32).to(I64) & MASK32  # bitcast steps counters
        # forward view with the steps lane zeroed (a select, so a NaN bit
        # pattern in that lane cannot leak into the dot products)
        rows_f = torch.where(plan.sl_is, 0.0, rows)

        # bit-prefix input features: +-1 for the byte's bits seen so far
        if meta.prefix_lane0 >= 0:
            bits8 = (acc[:, None] >> plan.pfx_shift[j]) & 1
            pfx = torch.where(plan.pfx_seen[j], 2.0 * bits8.to(F32) - 1.0, 0.0)  # (S, 8)
        else:
            pfx = torch.zeros((S, 0), dtype=F32, device=dev)
        npf = pfx.shape[1]

        def zeros(n):
            return torch.zeros((S, n), dtype=F32, device=dev)

        base0 = torch.cat([preds, zeros(n0), pfx, zeros(WP - n_pred - n0 - npf)], dim=1)
        d0 = _tree_sum(rows_f[:, :n0] * base0[:, None, :])
        y0 = _tri_solve(rows_f[:, :n0, n_pred : n_pred + n0], d0) if n0 > 1 else d0

        base1 = torch.cat([y0, zeros(n1), pfx, zeros(WP - n0 - n1 - npf)], dim=1)
        d1 = _tree_sum(rows_f[:, n0 : n0 + n1] * base1[:, None, :])
        y1 = _tri_solve(rows_f[:, n0 : n0 + n1, n0 : n0 + n1], d1) if n1 > 1 else d1

        base2 = torch.cat([y0, y1, pfx, zeros(WP - n0 - n1 - npf)], dim=1)
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
                wv = torch.where(plan.apm_bins == i0[:, None], 1.0 - w[:, None], 0.0) + torch.where(
                    plan.apm_bins == i0[:, None] + 1, w[:, None], 0.0
                )
                pv = (row * wv).sum(dim=1)  # two nonzero terms: exact in any order
                wgt = float(meta.apm_weights[a])
                apm_p = clamp_prob(wgt * pv + float(np.float32(1.0) - np.float32(wgt)) * apm_p)
                apm_l = logit(apm_p)
                apm_slices.append(row)
                apm_wvs.append(wv)
                apm_pvs.append(pv)
            prob = apm_p

        # ---- arithmetic coder (encoder.cpp:10-25 / decoder.cpp:19-39) ----
        enc_bit = (data_byte >> (7 - j)) & 1
        rpos, wpos = coder["rpos"], coder["wpos"]
        if decode:
            off_r = (rpos - rpos0)[:, None] + plan.k4  # (S, 4) window lanes
            in_bytes = torch.where(
                off_r < CODER_WIN, torch.gather(win_r, 1, torch.clamp(off_r, max=CODER_WIN - 1)), 0
            )
        else:
            in_bytes = None
        cst = coder_ops.CoderState(coder["x1"], coder["x2"], coder["x"])
        bit, cst, emits, nrenorm = coder_ops.coder_bit(
            cst, coder_ops.discretize(prob), enc_bit, in_bytes, decode
        )
        nren = nrenorm.to(I64)
        if not decode:
            # each window lane is written at most once per byte, so the
            # add-accumulate is exact
            valid = plan.k4 < nren[:, None]
            off_w = (wpos - wpos0)[:, None] + plan.k4
            sel_w = (off_w[:, :, None] == plan.win_lanes[None, None, :]) & valid[:, :, None]
            win_w = win_w + torch.where(sel_w, emits[:, :, None], 0).sum(dim=1)
            wpos = wpos + nren
        else:
            rpos = rpos + nren
        coder.update(x1=cst.x1, x2=cst.x2, x=cst.x, wpos=wpos, rpos=rpos)

        # cumulative cross-entropy (bits) and the per-column analysis EMA
        # (UpdateEntropy alpha=1e-5, metric probability clamped at 0.01)
        p_bit = torch.where(bit == 1, prob, 1.0 - prob)
        metrics["ent"] = metrics["ent"] - torch.log2(p_bit)
        if analysis:
            col_logits = torch.cat([preds, y0, y1, final_logit[:, None]], dim=1)
            p_cols = torch.clamp(logistic(col_logits), 0.01, 0.99)
            pb_cols = torch.where((bit == 1)[:, None], p_cols, 1.0 - p_cols)
            metrics["ema"] = metrics["ema"] + 1e-5 * (-torch.log2(pb_cols) - metrics["ema"])

        bitf = bit.to(F32)

        if learn and NA:
            # APM learn: move the two interpolation bins toward the bit
            for a in range(NA):
                new_row = apm_slices[a] + float(meta.apm_lrs[a]) * (bitf - apm_pvs[a])[:, None] * apm_wvs[a]
                apm_rows[:, a, j * APM_BINS : (j + 1) * APM_BINS] = new_row

        if learn:
            # indirect Learn (indirect.cpp:47-70): the state->logit delta and
            # the advanced state pair go into the byte stacks
            delta = (bitf[:, None] - logistic(p_cur)) * plan.ind_lrs
            b1 = (bit == 1)[:, None]
            ns_nx = torch.where(b1, plan.ns_next[1], plan.ns_next[0])  # (S, 256)
            rm_nx = torch.where(b1, plan.rm_next[1], plan.rm_next[0])
            st64 = st_eff.to(I64)
            new_ns = torch.gather(ns_nx, 1, st64[:, :M])
            new_rm = torch.gather(rm_nx, 1, st64[:, M:])
            new_pair = new_ns | (new_rm << 8)
            ib_lane[:, j] = lane_sel.to(I32)
            ib_del[:, j] = new_pair - pair
            pt_slot[:, j] = st_eff
            pt_del[:, j] = delta

            # match per-bit Learn (match.cpp:79-90)
            if NM:
                hit2 = (bit[:, None] == ((mbyte & pred_mask) != 0).to(I64)).to(F32)
                cnt = torch.gather(mt_cnt0, 2, mlen64).squeeze(2)
                cnt = cnt + (mc_del * (same_mp & prev8)).sum(dim=1, dtype=I32)
                grow = cnt < plan.match_limits
                cnt_new = torch.where(grow, cnt + 1, cnt)
                lr = rdiv(1.0, torch.where(grow, cnt_new, plan.match_limits).to(F32))
                mp_new = mp + (hit2 - mp) * lr
                upd_on = mlen > 2  # only matched rows learn (match.cpp:79)
                mp_slot[:, j] = mlen
                mp_del[:, j] = torch.where(upd_on, mp_new - mp, 0.0)
                mc_del[:, j] = (upd_on & grow).to(I32)

            # mixer Learn (mixer.cpp:108-176) on the working rows
            steps_f = bits_seen.to(F32)
            decay_global = rdiv(0.9, pow_det(1e-7 * steps_f + 0.8, 0.8))
            y_all = torch.cat([y0, y1, final_logit[:, None]], dim=1)  # (S, K)
            novelty = 1.5 - stepv.to(F32) / max_steps.to(F32)
            upd = decay_global[:, None] * novelty * plan.mix_lrs * (logistic(y_all) - bitf[:, None])
            # input matrix: per-layer base + strictly-lower in-layer part
            in0 = base0[:, None, :].expand(S, n0, WP).clone()
            in0[:, :, n_pred : n_pred + n0] = y0[:, None, :] * plan.tril0
            in1 = base1[:, None, :].expand(S, n1, WP).clone()
            in1[:, :, n0 : n0 + n1] = y1[:, None, :] * plan.tril1
            inputs = torch.cat([in0, in1, base2[:, None, :]], dim=1)  # (S, K, WP)
            # inputs are 0 in the steps lane, which is rewritten below with
            # the incremented bitcast counter
            w_new = rows - upd[:, :, None] * inputs
            steps_new = (stepv + 1) & MASK32
            wd = (steps_new & 1023) == 0  # weight decay every 1024 context-steps
            w_new = w_new * torch.where(wd, _WD, 1.0)[:, :, None]
            w_new = torch.where(plan.sl_is, steps_new.to(I32).view(F32)[:, :, None], w_new)
            # route the updated rows back to their class working sets
            rows_stable = w_new[:, plan.mix_st_ix]
            if Kp:
                rows_pos[:, :, j] = w_new[:, plan.mix_pos_ix]
            if Kcd:
                rows_cd = w_new[:, plan.mix_cd_ix]
            if Kpd:
                blocks_pd[:, :, j] = w_new[:, plan.mix_pd_ix]
            if Klm:
                lm_tbls = [
                    torch.where(lm_ohs[i][:, :, None], w_new[:, int(meta.mix_lm_ix[i])][:, None, :], lm_tbls[i])
                    for i in range(Klm)
                ]
            max_steps = torch.maximum(max_steps, steps_new)

        # advance the bit registers
        stm["new_bit"] = bit
        stm["acc"] = (acc << 1) | bit

    cur_byte = stm["acc"]  # all 8 bits accumulated = the completed byte
    longest = bitregs[:, 3]

    # ---- apply the deferred per-bit table writes, in sub-step order ----
    if learn:
        lane = plan.lane256[None, None, :]
        ib = ind_blk0
        pt = p_tbl0
        for jj in range(8):
            ib = ib + ib_del[:, jj, :, None] * (lane == ib_lane[:, jj, :, None])
            pt = pt + pt_del[:, jj, :, None] * (lane == pt_slot[:, jj, :, None])
        ind_blk = ib.to(torch.int16)
        if NM:
            mtp, mtc = mt_pred0, mt_cnt0
            for jj in range(8):
                eq = lane == mp_slot[:, jj, :, None]
                mtp = mtp + mp_del[:, jj, :, None] * eq
                mtc = mtc + mc_del[:, jj, :, None] * eq

    # ---- the renorm bytes of this input byte (host assembles the stream) ----
    win_out = win_w.to(torch.uint8)
    nw_out = (coder["wpos"] - wpos0).to(torch.uint8)

    # ---- final per-bit context values -> ctx (checkpoint consistency) ----
    stm["ctx"][:, plan.bitreg_ctx_cols] = bitregs

    # ---- byte end: scatter the working sets back, history append, match
    # pointer write ----
    if learn:
        scatter_rows(ltm["ind"]["st"], blk_ix, ind_blk)
        ltm["ind"]["p"] = pt
        ltm["mix_max_steps"] = max_steps
        if Kst:
            scatter_rows(ltm["mix_w"], rowix_st, rows_stable.contiguous())
        if Kp:
            scatter_rows(ltm["mix_pos"], posix, rows_pos.view(S, Kp, 8 * WP))
        if meta.mix_dense_total:
            # dense arena write-back: static slices + one-hot selects
            for i in range(Kcd):
                off, T = int(meta.mix_cd_offsets[i]), int(meta.mix_cd_sizes[i])
                cur = dense0[:, off : off + T]
                dense0[:, off : off + T] = torch.where(cd_oh[i][:, :, None], rows_cd[:, i][:, None, :], cur)
            for i in range(Kpd):
                off = int(meta.mix_pd_offsets[i])
                dense0[:, off : off + 8] = blocks_pd[:, i]
            for i in range(Klm):
                off, T = int(meta.mix_lm_offsets[i]), int(meta.mix_lm_sizes[i])
                dense0[:, off : off + T] = lm_tbls[i]
        if NM:
            ltm["match_pred"], ltm["match_cnt"] = mtp, mtc
        if NA:
            scatter_rows(ltm["apm"], apm_ix, apm_rows)
        # dedup history: append unless inside a long match (the write is
        # masked instead of dropped out of range as gmix_tpu does)
        hist_n = stm["hist_n"]
        append = longest < 2
        hpos = hist_n & (meta.history_size - 1)
        old = ltm["hist"][plan.s_ix[:, 0], hpos]
        ltm["hist"][plan.s_ix[:, 0], hpos] = torch.where(append, cur_byte.to(torch.uint8), old)
        hist_n = (hist_n + append.to(I64)) & MASK32
        stm["hist_n"] = hist_n
        if NM:
            # match.cpp:92-108: tables skip updates on long matches
            newp = ((hist_n - 1) & MASK32).to(I32)  # position of the appended byte
            old = ltm["match_tbl"][s_ix, match_ix]
            ltm["match_tbl"][s_ix, match_ix] = torch.where(append[:, None], newp[:, None], old)

    # the reconstructed byte (decode reconstructs; encode rewrites it)
    data_buf[:, t] = cur_byte.to(data_buf.dtype)
    return win_out, nw_out
