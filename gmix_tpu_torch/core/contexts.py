"""The byte step's boundary contexts and match pointers: the completed byte
into the recent-byte ring, the contexts the byte boundary recomputes, and
the match models' pointer logic.

Port of `gmix_tpu.core.step._boundary` after the PPM count update and before
the PPM prediction (`boundary_plain`), and of the match block of
`gmix_tpu.core.step._byte_step` (`match_plain`). On a CUDA device each is one
launch of csrc/contexts.cu's kernels (`contexts_boundary_kernel`,
`match_pointer_kernel`), which write the state's leaves in place; on the CPU
the plain versions below, in eager torch, which the kernels equal bit for
bit. It is integer work alone: u32 values are int64 tensors in [0, 2^32)
(state.py), `ih_tbl` and `match_tbl` hold u32 values as int32 bits.

The byte index `t` is a 0-d int64 tensor on the state's device: the stream's
first byte selects with it, as gmix_tpu's `not_first = t > 0` does, so one
program serves every byte and no host reads the device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops import kernels
from ..ops.murmur import MASK32, mul32, murmur3_u32, murmur3_u64
from .meta import MAX_SKIP, ROLL_BASE, Meta

I32 = torch.int32
I64 = torch.int64


def boundary_plain(stm: Dict, t: torch.Tensor, plan) -> None:
    """The boundary contexts with the completed byte `stm["acc"]`, op by op
    (gmix_tpu.core.step._boundary between the PPM count update and the PPM
    prediction); rebinds the leaves of `stm` it recomputes."""
    meta = plan.meta
    spec = meta.spec
    s_ix = plan.s_ix
    not_first = t > 0
    completed = stm["acc"]
    last_byte = torch.where(not_first, completed, stm["last_byte"])
    recent = torch.where(not_first, torch.cat([completed[:, None], stm["recent"][:, :-1]], dim=1), stm["recent"])
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

    # rolling-hash contexts (deep PPM orders): h' = (h - leaving * B^(n-1)) * B
    # + completed over the pre-shift recent ring, published murmur-finalised.
    # The difference is masked to 32 bits before the multiply: it can be
    # negative, and an unmasked product overflows int64.
    if spec.roll_ctxs:
        h_old = stm["roll_h"]
        old_b = stm["recent"][:, plan.roll_old_ix]
        h_rolled = (mul32((h_old - old_b * plan.roll_pows) & MASK32, ROLL_BASE) + completed[:, None]) & MASK32
        h_new = torch.where(not_first, h_rolled, h_old)
        ctx[:, plan.roll_slots] = murmur3_u32(h_new)
        stm["roll_h"] = h_new

    # indirect-hash contexts (indirect-hash.cpp:16-31), one flat arena of
    # u32 values stored as int32 bits; the write comes before the read of the
    # new index, which may be the same word
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


def match_plain(stm: Dict, ltm: Dict, plan) -> torch.Tensor:
    """The match models' byte-boundary pointer logic (match.cpp:38-58), op by
    op: the length rule, the `match_tbl` read of each model's row, the
    pointer rule and the `hist` read. Rebinds `match_ptr`, `match_byte` and
    `match_len` in `stm`; returns the rows `match_ix` (S, NM) int64 that the
    byte end writes."""
    s_ix = plan.s_ix
    hit = stm["new_bit"][:, None] == ((stm["match_byte"] & 1) != 0).to(I64)
    mlen = torch.where(hit, torch.clamp(stm["match_len"] + 1, max=255), 0)
    mlen = torch.where(stm["match_ptr"] == ((stm["hist_n"] - 1) & MASK32)[:, None], 0, mlen)
    mcv = stm["ctx"][:, plan.match_ctx_slots]
    match_ix = (mcv & plan.match_masks) + plan.match_offsets
    tbl_ptr = ltm["match_tbl"][s_ix, match_ix].to(I64) & MASK32
    mptr = torch.where(mlen < 8, tbl_ptr, (stm["match_ptr"] + 1) & MASK32)
    hb = ltm["hist"][s_ix, mptr & (plan.meta.history_size - 1)]
    mbyte = torch.where((stm["hist_n"] > 0)[:, None], hb.to(I64), stm["match_byte"])
    stm.update(match_ptr=mptr, match_byte=mbyte, match_len=mlen)
    return match_ix


# ---------------------------------------------------------------------------
# the two kernels (csrc/contexts.cu): the same functions on CUDA tensors
# ---------------------------------------------------------------------------

# csrc/contexts.cu: kByteCols, kMaxRecent, kSkip (a skip context's entries
# in the boundary table)
BYTE_COLS, MAX_RECENT, PER_SKIP = 10, 256, 1 + 3 * MAX_SKIP


def boundary_table(meta: Meta) -> np.ndarray:
    """The boundary kernel's constants as one int64 vector, in
    csrc/contexts.cu's order: the 10 byte columns of `ctx`; per interval
    context (slot, shift, mask), then each one's 256-entry map; per skip
    context its slot and, for each of MAX_SKIP bytes, (index into the ring,
    shift into the low half, into the high half; -1 where the byte is not in
    that half); per rolling-hash context (slot, index of the leaving byte,
    B^(n-1)); per indirect-hash context (arena offset, mask, inner mask,
    outer mask, slot). Refuses a spec whose boundary writes a slot twice
    (the kernel's tasks would race) or whose outer contexts reach 2^32."""
    spec = meta.spec
    NI, NIH = len(spec.interval_ctxs), len(spec.ihash_ctxs)
    written = [meta.byte_ctx_cols, meta.interval_slots[:NI], meta.skip_slots, meta.roll_slots, meta.ih_out_slots]
    slots = np.concatenate([np.asarray(w, np.int64).reshape(-1) for w in written])
    if len(np.unique(slots)) != len(slots) or len(meta.byte_ctx_cols) != BYTE_COLS:
        raise ValueError("the boundary writes a context slot twice")
    omask = meta.ih_outer_mods.astype(np.int64) - 1
    if NIH and int(omask.max()) >= 1 << 24:
        raise ValueError("an indirect-hash context's outer order passes 4 bytes")
    skip = np.zeros((len(spec.skip_ctxs), PER_SKIP), np.int64)
    for i in range(len(skip)):
        skip[i, 0] = meta.skip_slots[i]
        body = np.stack([meta.skip_gather[i], np.where(meta.skip_lo_on[i], meta.skip_lo_sh[i], -1),
                         np.where(meta.skip_hi_on[i], meta.skip_hi_sh[i], -1)], axis=1)
        skip[i, 1:] = body.astype(np.int64).reshape(-1)
    parts = [
        np.asarray(meta.byte_ctx_cols, np.int64),
        np.stack([meta.interval_slots[:NI], meta.interval_shifts[:NI], meta.interval_masks[:NI]], axis=1),
        np.asarray(meta.interval_maps[:NI], np.int64),
        skip,
        np.stack([meta.roll_slots, meta.roll_old_ix, meta.roll_pows], axis=1),
        np.stack([meta.ih_offsets, meta.ih_masks, meta.ih_inner_mods.astype(np.int64) - 1, omask, meta.ih_out_slots],
                 axis=1),
    ]
    return np.concatenate([np.asarray(p).astype(np.int64).reshape(-1) for p in parts])


def match_table(meta: Meta) -> np.ndarray:
    """The match kernel's constants: per match model (ctx slot, mask, arena
    offset), as one int64 vector."""
    return np.stack([meta.match_ctx_slots, meta.match_masks, meta.match_offsets], axis=1).astype(np.int64).reshape(-1)


def boundary_kernel(stm: Dict, t: torch.Tensor, plan) -> None:
    """`boundary_plain` as one launch of csrc/contexts.cu's boundary kernel,
    on CUDA tensors: the leaves are written in place."""
    meta = plan.meta
    spec = meta.spec
    S, R = stm["recent"].shape
    NI, NSK, NR, NIH = len(spec.interval_ctxs), len(spec.skip_ctxs), len(spec.roll_ctxs), len(spec.ihash_ctxs)
    if not BYTE_COLS <= R <= MAX_RECENT:
        raise ValueError(f"contexts_boundary: a ring of {R} bytes, the kernel takes {BYTE_COLS} to {MAX_RECENT}")
    tensors = {"ctx": (stm["ctx"], (S, meta.n_ctx), I64), "t": (t, (), I64), "acc": (stm["acc"], (S,), I64),
               "last_byte": (stm["last_byte"], (S,), I64), "recent": (stm["recent"], (S, R), I64),
               "consts": (plan.boundary_consts, tuple(plan.boundary_consts.shape), I64)}
    if NR:
        tensors["roll_h"] = (stm["roll_h"], (S, NR), I64)
    if NIH:
        tensors.update(ih_tbl=(stm["ih_tbl"], (S, meta.ih_total), I32), ih_outer_ctx=(stm["ih_outer_ctx"], (S, NIH), I64),
                       ih_outer_hash=(stm["ih_outer_hash"], (S, NIH), I64))
    kernels.launch("contexts_boundary", dict(S=S, R=R, n_ctx=meta.n_ctx, NI=NI, NSK=NSK, NR=NR, NIH=NIH,
                                             ih_total=meta.ih_total), tensors)


def match_kernel(stm: Dict, ltm: Dict, plan) -> torch.Tensor:
    """`match_plain` as one launch of csrc/contexts.cu's match kernel, on
    CUDA tensors: `match_ptr`, `match_byte` and `match_len` are written in
    place; returns `match_ix`."""
    meta = plan.meta
    S, NM = stm["match_ptr"].shape
    H = meta.history_size
    match_ix = torch.empty((S, NM), dtype=I64, device=stm["match_ptr"].device)
    tensors = {"match_ptr": (stm["match_ptr"], (S, NM), I64), "new_bit": (stm["new_bit"], (S,), I64),
               "hist_n": (stm["hist_n"], (S,), I64), "ctx": (stm["ctx"], (S, meta.n_ctx), I64),
               "match_byte": (stm["match_byte"], (S, NM), I64), "match_len": (stm["match_len"], (S, NM), I32),
               "match_tbl": (ltm["match_tbl"], (S, meta.match_total), I32), "hist": (ltm["hist"], (S, H), torch.uint8),
               "match_ix": (match_ix, (S, NM), I64), "consts": (plan.match_consts, (3 * NM,), I64)}
    kernels.launch("match_pointer", dict(S=S, NM=NM, n_ctx=meta.n_ctx, match_total=meta.match_total, history_size=H),
                   tensors)
    return match_ix


def boundary_contexts(stm: Dict, t: torch.Tensor, plan) -> None:
    """The boundary contexts after the PPM count update: the kernel on CUDA
    tensors (writing the leaves in place), the plain version on CPU
    tensors."""
    if stm["ctx"].device.type == "cpu":
        boundary_plain(stm, t, plan)
        return
    boundary_kernel(stm, t, plan)


def match_pointers(stm: Dict, ltm: Dict, plan) -> torch.Tensor:
    """The match pointer logic: the kernel on CUDA tensors, the plain
    version on CPU tensors; returns `match_ix`."""
    if stm["ctx"].device.type == "cpu":
        return match_plain(stm, ltm, plan)
    return match_kernel(stm, ltm, plan)
