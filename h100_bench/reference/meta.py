# Frozen copy of gmix_tpu_torch/core/meta.py at commit 334906b, plain torch on the CPU only;
# imports nothing of gmix_tpu_torch, gmix_tpu or jax (h100_bench/reference/__init__.py).
"""Static kernel-layout metadata derived from an EnsembleSpec.

Carried over from `gmix_tpu.core.meta` field for field (the port cannot
import that package, which imports JAX): the arenas, their offsets and the
128-lane row padding must agree exactly, so that a state or checkpoint moves
between the two packages leaf for leaf.

Heterogeneous model instances are packed into *flat arenas*: every table of a
model family lives in ONE (S, total) array, and a per-instance offset vector
turns each family's lookups into a single batched gather and each update into
a single batched scatter, instead of the reference's per-instance virtual
dispatch (src/predictor.cpp:360-387).

Everything here is host-side numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .config import EnsembleSpec

LANE = 128  # pad mixer weight rows to 128 lanes (gmix_tpu's layout)
MAX_SKIP = 8  # skip contexts hash at most 8 recent bytes (skip-context.h)
ROLL_BASE = 0x01000193  # rolling-hash base: FNV-32 prime (odd -> bijective mult)
APM_BINS = 33  # SSE/APM probability-quantization bins per bit position
APM_SPAN = 16.0  # bins cover logit(p) in [-APM_SPAN, APM_SPAN]
# PPM rows carry 256 symbol counts + the owner tag in lane PPM_TAG_LANE,
# padded to PPM_ROW_W u16 lanes (physical layout pads the minor dim to the
# 128-lane tile anyway, so the extra lanes are free)
PPM_TAG_LANE = 256
PPM_ROW_W = 272
DENSE_MAX = 16  # mixer tables up to this many rows stay dense-resident


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class Meta:
    spec: EnsembleSpec
    slots: Dict[str, int]
    n_ctx: int
    n_pred: int

    # indirect models, spec order (src/models/indirect.cpp)
    # The state arena is (S, ind_nblocks, 256) uint16 with ns in the low byte
    # and rm in the high byte; model m owns blocks [ind_blk_offsets[m],
    # ind_blk_offsets[m] + ind_blk_masks[m] + 1). The reference's index
    # (ctx*256 + bit_ctx) % table_size becomes block = ctx & (2^tb - 1),
    # lane = bit_ctx: every indirect context is byte-stable, so the 8 bit
    # sub-steps of one byte all land in ONE 256-lane block. The step gathers
    # each model's block once per byte (a contiguous-row gather), does the
    # per-bit reads/updates on the gathered block, and scatters the block
    # back once per byte instead of scattering elements per bit.
    # NOTE: the reference sizes these tables (1<<tb)*256 + 1 to break modular
    # collision alignment (indirect.cpp:15-19). Power-of-two tables keep the
    # block decomposition exact; contexts are murmur-hashed, which supplies
    # the decorrelation the +1 was for.
    ind_blk_offsets: np.ndarray  # (M,) int32 block offsets
    ind_blk_masks: np.ndarray  # (M,) uint32: (1 << tb) - 1
    ind_ctx_slots: np.ndarray  # (M,) int32
    ind_lrs: np.ndarray  # (2M,) float32 [ns lrs | rm lrs]
    ind_rotate: np.ndarray  # (M,) uint32 1/0: lane rotation enabled
    ind_nblocks: int

    # mixers, k-order = L0 spec order, then L1, then final (mixer.cpp).
    # Every mixer's working rows move between HBM and registers ONCE per
    # byte; the per-bit work is pure register/vector math. Placement classes:
    #
    #   stable  byte-stable ctx, > DENSE_MAX rows: one arena row gathered per
    #           byte, updated in registers across the 8 sub-steps, scattered
    #           back at byte end.
    #   pos     MixerModel.pos with tb > 0: an (8, WP) position block per
    #           byte-stable ctx value, gathered/scattered as ONE wide row
    #           (replaces the reference's bit-prefix-gated tables, whose 8
    #           per-bit scatters were the largest cost block of the step).
    #   cd      ctx-dense: byte-stable ctx, <= DENSE_MAX total rows: the
    #           whole table is resident in the dense arena; the byte's row is
    #           selected by one-hot, carried, and written back with a static
    #           slice - no scatter at all.
    #   pd      pos-dense: pos with tb == 0 (the bit_ctx mixers): a static
    #           8-row block, static-sliced per byte.
    #   lm      longest_match-gated: gate varies per bit, but the table is
    #           tiny (<= 32 rows); the whole table is carried in registers
    #           across the sub-steps and written back with a static slice.
    #
    # The per-row steps_ counter (mixer.cpp:8) lives bitcast into spare f32
    # lane `mix_step_lane` of each padded weight row in every class.
    mix_lrs: np.ndarray  # (K,) float32, k-order
    mix_n0: int
    mix_n1: int
    mix_width_pad: int
    mix_step_lane: int

    mix_st_ix: np.ndarray  # (Kst,) k-indices of stable mixers
    mix_st_offsets: np.ndarray  # (Kst,) row offsets into the stable arena
    mix_st_masks: np.ndarray  # (Kst,) uint32
    mix_st_slots: np.ndarray  # (Kst,) ctx slots
    mix_total_rows: int  # stable arena rows

    mix_pos_ix: np.ndarray  # (Kp,) k-indices of pos mixers (tb > 0)
    mix_pos_offsets: np.ndarray  # (Kp,) GROUP offsets into the pos arena
    mix_pos_masks: np.ndarray  # (Kp,) uint32
    mix_pos_slots: np.ndarray  # (Kp,) ctx slots
    mix_pos_groups: int  # pos arena groups (each 8 x WP)

    mix_cd_ix: np.ndarray  # (Kcd,) k-indices of ctx-dense mixers
    mix_cd_offsets: np.ndarray  # (Kcd,) row offsets into the dense arena
    mix_cd_sizes: np.ndarray  # (Kcd,) table rows (1 << tb)
    mix_cd_slots: np.ndarray  # (Kcd,) ctx slots

    mix_pd_ix: np.ndarray  # (Kpd,) k-indices of pos-dense mixers
    mix_pd_offsets: np.ndarray  # (Kpd,) row offsets (8 rows each)

    mix_lm_ix: np.ndarray  # (Klm,) k-indices of longest_match mixers
    mix_lm_offsets: np.ndarray  # (Klm,)
    mix_lm_sizes: np.ndarray  # (Klm,)
    mix_dense_total: int  # dense arena rows

    # concat([stable, pos, cd, pd, lm])[mix_perm] = k-order
    mix_perm: np.ndarray  # (K,) int32

    # prefix-input lanes (spec.prefix_inputs): lane of the first of the 8
    # prefix features in the L0 base vector and in the L1/final base vector
    # (-1 when disabled)
    prefix_lane0: int
    prefix_lane12: int

    # match models, spec order (src/models/match.cpp)
    match_offsets: np.ndarray  # (NM,) int32
    match_masks: np.ndarray  # (NM,) uint32
    match_ctx_slots: np.ndarray  # (NM,) int32
    match_limits: np.ndarray  # (NM,) int32
    match_total: int

    # indirect-hash contexts, spec order (src/contexts/indirect-hash.cpp)
    ih_offsets: np.ndarray  # (NIH,) int32
    ih_masks: np.ndarray  # (NIH,) uint32
    ih_out_slots: np.ndarray
    ih_outer_mods: np.ndarray  # (NIH,) uint32: 1 << 8*(outer_order-1)
    ih_inner_mods: np.ndarray  # (NIH,) uint32
    ih_total: int

    # skip contexts, vectorised packing (src/contexts/skip-context.cpp:9-19):
    # key u64 = sum_k recent[offsets[k]] << 8*(n-1-k), hashed per instance
    skip_slots: np.ndarray  # (NSK,) int32
    skip_gather: np.ndarray  # (NSK, MAX_SKIP) int32 indices into recent
    skip_lo_sh: np.ndarray  # (NSK, MAX_SKIP) uint32 shift into the low u32
    skip_lo_on: np.ndarray  # (NSK, MAX_SKIP) bool
    skip_hi_sh: np.ndarray
    skip_hi_on: np.ndarray

    # interval contexts (src/contexts/interval-context.cpp)
    interval_maps: np.ndarray  # (NI, 256) int32 quantisation maps
    interval_shifts: np.ndarray
    interval_masks: np.ndarray
    interval_slots: np.ndarray

    # PPM orders, lowest first (device-native ModPPMD equivalent)
    ppm_slots: np.ndarray  # (NO,) ctx slots
    ppm_masks: np.ndarray  # (NO,) uint32
    ppm_row_offsets: np.ndarray  # (NO,) int32 into the row arena
    ppm_total_rows: int

    # SSE/APM stages (config.ApmStage): rows of 8*APM_BINS f32 lanes
    # (bit-position-major), one arena across stages
    apm_offsets: np.ndarray  # (NA,) int32 row offsets
    apm_masks: np.ndarray  # (NA,) uint32
    apm_ctx_slots: np.ndarray  # (NA,) int32
    apm_lrs: np.ndarray  # (NA,) float32
    apm_weights: np.ndarray  # (NA,) float32
    apm_total: int

    # rolling-hash contexts (deep PPM orders): h' = (h - leave*B^(n-1))*B + c
    roll_slots: np.ndarray  # (NR,) int32 ctx slots
    roll_old_ix: np.ndarray  # (NR,) int32 index into recent of the leaving byte
    roll_pows: np.ndarray  # (NR,) uint32 B^(order-1) mod 2^32
    recent_size: int  # recent-byte ring length (>= max roll order)

    # byte-boundary context columns written in one scatter:
    # [last_byte, recent_1..recent_9]
    byte_ctx_cols: np.ndarray
    # per-bit context columns written in one scatter:
    # [bit_ctx, lb_recent, slb_recent]
    bit_ctx_cols: np.ndarray
    # the full bit-register column set [bit_ctx, lb_recent, slb_recent,
    # longest_match], written to ctx once per BYTE (the per-bit values live in
    # registers; see _byte_step)
    bitreg_ctx_cols: np.ndarray

    history_size: int


def analysis_names(spec: EnsembleSpec) -> List[str]:
    """Column names of the per-bit analysis EMA (reference: EnableAnalysis /
    UpdateEntropy, predictor.cpp:422-469): one per prediction column, one per
    mixer output (L0/L1), and the final output."""
    names: List[str] = []
    if spec.use_ppm:
        names.append("ppm")
    if spec.lstm is not None:
        names.append("lstm")
    for m in spec.indirects:
        names += [f"{m.name}.ns", f"{m.name}.rm"]
    names += [m.name for m in spec.matches]
    names += [m.name for m in spec.mixers_in_layer(0)]
    names += [m.name for m in spec.mixers_in_layer(1)]
    names.append("final")
    return names


def _arena(bit_sizes: List[int]) -> Tuple[np.ndarray, np.ndarray, int]:
    """(offsets, masks, total) for tables of 2^bits entries packed end-to-end."""
    sizes = [1 << b for b in bit_sizes]
    if not sizes:
        return np.zeros((0,), np.int32), np.zeros((0,), np.uint32), 0
    offsets = np.cumsum([0] + sizes[:-1]).astype(np.int32)
    masks = (np.array(sizes, np.int64) - 1).astype(np.uint32)
    return offsets, masks, int(sum(sizes))


def build_meta(spec: EnsembleSpec) -> Meta:
    spec.validate()
    names = spec.ctx_names()
    slots = {n: i for i, n in enumerate(names)}

    # --- indirect block arena (model m owns 2^tb blocks of 256 lanes) ---
    ind_blk_offsets, ind_blk_masks, ind_nblocks = _arena(
        [m.table_bits for m in spec.indirects]
    )
    assert ind_nblocks * 256 < 2**31, "indirect arena exceeds int32 indexing"
    ind_lrs = np.array([m.lr for m in spec.indirects] * 2, np.float32)

    # --- mixer placement classes + arenas, k-order L0 | L1 | final (see the
    # Meta field docs for the class definitions) ---
    mixers = (
        list(spec.mixers_in_layer(0)) + list(spec.mixers_in_layer(1)) + list(spec.mixers_in_layer(2))
    )
    # +1 lane reserved for the bitcast steps counter
    width_pad = _round_up(max(spec.mixer_width(l) for l in range(3)) + 1, LANE)
    st_ks, pos_ks, cd_ks, pd_ks, lm_ks = [], [], [], [], []
    for k, m in enumerate(mixers):
        if m.ctx == "longest_match":
            lm_ks.append(k)
        elif m.pos and m.table_bits == 0:
            pd_ks.append(k)
        elif m.pos:
            pos_ks.append(k)
        elif (1 << m.table_bits) <= DENSE_MAX:
            cd_ks.append(k)
        else:
            st_ks.append(k)
    mix_st_offsets, mix_st_masks, mix_total_rows = _arena(
        [mixers[k].table_bits for k in st_ks]
    )
    mix_pos_offsets, mix_pos_masks, mix_pos_groups = _arena(
        [mixers[k].table_bits for k in pos_ks]
    )
    # dense arena layout: [cd tables | pd 8-row blocks | lm tables]
    cd_sizes = [1 << mixers[k].table_bits for k in cd_ks]
    pd_sizes = [8 for _ in pd_ks]
    lm_sizes = [1 << mixers[k].table_bits for k in lm_ks]
    dense_sizes = cd_sizes + pd_sizes + lm_sizes
    dense_offs = np.cumsum([0] + dense_sizes[:-1]).astype(np.int32) if dense_sizes else np.zeros((0,), np.int32)
    mix_dense_total = int(sum(dense_sizes))
    ncd, npd = len(cd_ks), len(pd_ks)
    mix_cd_offsets = dense_offs[:ncd]
    mix_pd_offsets = dense_offs[ncd : ncd + npd]
    mix_lm_offsets = dense_offs[ncd + npd :]
    concat_order = np.array(st_ks + pos_ks + cd_ks + pd_ks + lm_ks, np.int32)
    mix_perm = np.argsort(concat_order).astype(np.int32)  # concat[perm] = k-order
    pf = spec.prefix_inputs
    n0 = len(spec.mixers_in_layer(0))
    n1 = len(spec.mixers_in_layer(1))
    nskip = len(spec.skip_connection_cols)

    # --- match arena ---
    match_offsets, match_masks, match_total = _arena([m.table_bits for m in spec.matches])

    # --- indirect-hash arena ---
    ih_offsets, ih_masks, ih_total = _arena([c.table_bits for c in spec.ihash_ctxs])

    # --- skip packing ---
    nsk = max(len(spec.skip_ctxs), 1)
    skip_gather = np.zeros((nsk, MAX_SKIP), np.int32)
    skip_lo_sh = np.zeros((nsk, MAX_SKIP), np.uint32)
    skip_lo_on = np.zeros((nsk, MAX_SKIP), bool)
    skip_hi_sh = np.zeros((nsk, MAX_SKIP), np.uint32)
    skip_hi_on = np.zeros((nsk, MAX_SKIP), bool)
    for i, c in enumerate(spec.skip_ctxs):
        n = len(c.offsets)
        assert n <= MAX_SKIP
        for k, o in enumerate(c.offsets):
            p = 8 * (n - 1 - k)
            skip_gather[i, k] = o
            if p < 32:
                skip_lo_sh[i, k] = p
                skip_lo_on[i, k] = True
            else:
                skip_hi_sh[i, k] = p - 32
                skip_hi_on[i, k] = True

    # --- interval contexts ---
    n_int = len(spec.interval_ctxs)
    interval_maps = np.zeros((max(n_int, 1), 256), np.int32)
    interval_shifts = np.zeros((max(n_int, 1),), np.int32)
    interval_masks = np.zeros((max(n_int, 1),), np.uint32)
    for i, c in enumerate(spec.interval_ctxs):
        interval_maps[i] = np.arange(256) // c.divisor
        max_value = 255 // c.divisor
        shift = 1
        while (1 << shift) <= max_value:
            shift += 1  # interval-context.cpp:12-13
        interval_shifts[i] = shift
        interval_masks[i] = (1 << c.num_bits) - 1

    # --- PPM row arena ---
    orders = spec.ppm.orders if spec.ppm else ()
    ppm_row_offsets, ppm_masks, ppm_total_rows = _arena([o.table_bits for o in orders])

    # --- APM row arena ---
    apm_offsets, apm_masks, apm_total = _arena([a.table_bits for a in spec.apm])

    # --- rolling-hash contexts ---
    roll_pows = np.array(
        [pow(ROLL_BASE, c.order - 1, 1 << 32) for c in spec.roll_ctxs], np.uint32
    )
    recent_size = max([16] + [c.order for c in spec.roll_ctxs])

    return Meta(
        spec=spec,
        slots=slots,
        n_ctx=len(names),
        n_pred=spec.num_predictions,
        ind_blk_offsets=ind_blk_offsets,
        ind_blk_masks=ind_blk_masks,
        ind_ctx_slots=np.array([slots[m.ctx] for m in spec.indirects], np.int32),
        ind_lrs=ind_lrs,
        ind_rotate=np.array(
            [1 if getattr(m, "rotate", True) else 0 for m in spec.indirects], np.uint32
        ),
        ind_nblocks=ind_nblocks,
        mix_lrs=np.array([m.lr for m in mixers], np.float32),
        mix_n0=n0,
        mix_n1=n1,
        mix_width_pad=width_pad,
        mix_step_lane=width_pad - 1,
        mix_st_ix=np.array(st_ks, np.int32),
        mix_st_offsets=mix_st_offsets,
        mix_st_masks=mix_st_masks,
        mix_st_slots=np.array([slots[mixers[k].ctx] for k in st_ks], np.int32),
        mix_total_rows=mix_total_rows,
        mix_pos_ix=np.array(pos_ks, np.int32),
        mix_pos_offsets=mix_pos_offsets,
        mix_pos_masks=mix_pos_masks,
        mix_pos_slots=np.array([slots[mixers[k].ctx] for k in pos_ks], np.int32),
        mix_pos_groups=mix_pos_groups,
        mix_cd_ix=np.array(cd_ks, np.int32),
        mix_cd_offsets=np.asarray(mix_cd_offsets, np.int32),
        mix_cd_sizes=np.array(cd_sizes, np.int32),
        mix_cd_slots=np.array([slots[mixers[k].ctx] for k in cd_ks], np.int32),
        mix_pd_ix=np.array(pd_ks, np.int32),
        mix_pd_offsets=np.asarray(mix_pd_offsets, np.int32),
        mix_lm_ix=np.array(lm_ks, np.int32),
        mix_lm_offsets=np.asarray(mix_lm_offsets, np.int32),
        mix_lm_sizes=np.array(lm_sizes, np.int32),
        mix_dense_total=mix_dense_total,
        mix_perm=mix_perm,
        prefix_lane0=(spec.num_predictions + n0) if pf else -1,
        prefix_lane12=(n0 + n1 + nskip) if pf else -1,
        match_offsets=match_offsets,
        match_masks=match_masks,
        match_ctx_slots=np.array([slots[m.ctx] for m in spec.matches], np.int32),
        match_limits=np.array([m.limit for m in spec.matches], np.int32),
        match_total=match_total,
        ih_offsets=ih_offsets,
        ih_masks=ih_masks,
        ih_out_slots=np.array([slots[c.name] for c in spec.ihash_ctxs], np.int32),
        ih_outer_mods=np.array(
            [1 << (8 * (c.outer_order - 1)) for c in spec.ihash_ctxs], np.uint32
        ),
        ih_inner_mods=np.array(
            [1 << (8 * (c.inner_order - 1)) for c in spec.ihash_ctxs], np.uint32
        ),
        ih_total=ih_total,
        skip_slots=np.array([slots[c.name] for c in spec.skip_ctxs], np.int32),
        skip_gather=skip_gather,
        skip_lo_sh=skip_lo_sh,
        skip_lo_on=skip_lo_on,
        skip_hi_sh=skip_hi_sh,
        skip_hi_on=skip_hi_on,
        interval_maps=interval_maps,
        interval_shifts=interval_shifts,
        interval_masks=interval_masks,
        interval_slots=np.array([slots[c.name] for c in spec.interval_ctxs], np.int32),
        ppm_slots=np.array([slots[o.ctx] for o in orders], np.int32),
        ppm_masks=ppm_masks,
        ppm_row_offsets=ppm_row_offsets,
        ppm_total_rows=ppm_total_rows,
        apm_offsets=apm_offsets,
        apm_masks=apm_masks,
        apm_ctx_slots=np.array([slots[a.ctx] for a in spec.apm], np.int32),
        apm_lrs=np.array([a.lr for a in spec.apm], np.float32),
        apm_weights=np.array([a.weight for a in spec.apm], np.float32),
        apm_total=apm_total,
        roll_slots=np.array([slots[c.name] for c in spec.roll_ctxs], np.int32),
        roll_old_ix=np.array([c.order - 1 for c in spec.roll_ctxs], np.int32),
        roll_pows=roll_pows,
        recent_size=recent_size,
        byte_ctx_cols=np.array(
            [slots["last_byte"]] + [slots[f"recent_{i}"] for i in range(1, 10)], np.int32
        ),
        bit_ctx_cols=np.array(
            [slots["bit_ctx"], slots["lb_recent"], slots["slb_recent"]], np.int32
        ),
        bitreg_ctx_cols=np.array(
            [slots["bit_ctx"], slots["lb_recent"], slots["slb_recent"],
             slots["longest_match"]], np.int32
        ),
        history_size=1 << spec.history_bits,
    )
