"""The PPM byte model at the byte boundary: tag-verified count rows, the
exclusion cascade with learned escapes, the per-byte count update and the
next-byte distribution.

Port of `gmix_tpu.core.step._ppm_rows`, `_ppm_cascade`, `_ppm_update` and
`_ppm_predict`. The arena rows move through the kernels of `ops/rowmove.py`;
between the movers, the count update and the prediction are one launch each
of csrc/ppm.cu's kernels on a CUDA device (`ppm_update_kernel`,
`ppm_predict_kernel`), and on the CPU the plain versions below, in eager
torch as gmix_tpu computes them outside any kernel (`ppm_update_plain`,
`ppm_predict_plain`), which the kernels equal bit for bit. The bit head that
reads `ppm_probs` is inside `core/fused.py:fused_substeps`.

Held bitwise against gmix_tpu run eagerly, so every float op is its own
torch op in the reference's order (core/step.py's docstring). What the port
does differently changes no bit:

- The orders are one axis of batched tensors where gmix_tpu loops over them:
  each order's arithmetic is elementwise in that axis. The exclusion mask of
  an order (any higher order saw the symbol) and `higher_found` are
  exclusive running ORs from the top, taken as reversed integer cumulative
  sums. The two sequential chains stay loops: the escape weight `w` and the
  accumulation of `p`, highest order first.
- `ppm_tbl` holds u16 counts as int16 bits. A count can pass 32767
  (`rescale_total` is 48000), so rows are widened with `& 0xFFFF` before any
  arithmetic or compare and narrowed back by bit pattern.
- Where gmix_tpu selects one count with a one-hot float sum (`found`), the
  port gathers it: counts are integers, exact either way.
- XLA's CPU programs read denormal floats as zero and flush denormal
  results. `ppm_see` is the one PPM leaf that can hold such a value and keep
  it, so its update flushes both ways (`_flush`). In the cascade a denormal
  offset changes no bit: it is added to a logit that is 0 or far above it,
  and the logistic of a denormal is the logistic of 0.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import obs
from ..ops import kernels
from ..ops.rowmove import gather_rows, scatter_rows
from ..ops.sigmoid import logistic, logit
from .fused import _FLT_MIN, _tree_sum
from .meta import PPM_ROW_W, PPM_TAG_LANE

F32 = torch.float32
I16 = torch.int16
I32 = torch.int32
I64 = torch.int64


def _flush(x: torch.Tensor) -> torch.Tensor:
    """x with denormals as (signed) zero: what an XLA CPU program makes of a
    float input or result."""
    return torch.where(x.abs() < _FLT_MIN, x * 0.0, x)


def _or_above(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """For a bool (S, NO, ...) tensor: (any of x at an order above i, for each
    order i; any of x at any order)."""
    xi = x.to(I32)
    at_or_above = torch.cumsum(xi.flip(1), dim=1).flip(1)
    return (at_or_above - xi) > 0, at_or_above[:, 0] > 0


@obs.in_part("ppm")
def _ppm_index(ctx: torch.Tensor, plan) -> Tuple[torch.Tensor, torch.Tensor]:
    """(context values (S, NO) of the PPM orders, their arena rows as int32)."""
    cv = ctx[:, plan.ppm_slots]
    return cv, ((cv & plan.ppm_masks) + plan.ppm_row_offsets).to(I32)


def _ppm_rows(raw_rows: torch.Tensor, cv: torch.Tensor):
    """Counts, context tags, stored tags and the tag-match mask of the
    gathered arena rows `raw_rows` (S, NO, PPM_ROW_W) for the context values
    `cv`. Lane PPM_TAG_LANE of a row stores the high hash byte of the context
    that owns it; on a mismatch (a hash collision) the row reads as empty and
    is reclaimed on update. Returns (rows (S, NO, 256) int32 in [0, 65535],
    my_tag, old_tag (S, NO) int32, tag_ok)."""
    wide = raw_rows.to(I32) & 0xFFFF
    my_tag = ((cv >> 24) & 255).to(I32)
    old_tag = wide[:, :, PPM_TAG_LANE]
    tag_ok = my_tag == old_tag
    rows = torch.where(tag_ok[:, :, None], wide[:, :, :256], 0)
    return rows, my_tag, old_tag, tag_ok


def _ppm_cascade(rows_f: torch.Tensor, see: torch.Tensor, sp, plan):
    """The top-down exclusion cascade over the PPM orders (lowest order at
    index 0): symbols seen at a higher order are excluded from every lower
    order's counts and escape statistics; the escape probability is the
    PPM-C prior distinct / (total + distinct) bent by a learned logit offset
    per (order, distinct bucket). Returns (masked rows (S, NO, 256), totals,
    has-flags, escape probabilities (S, NO), bucket one-hots (S, NO, NB),
    final exclusion mask (S, 256))."""
    S, NO, _ = rows_f.shape
    NB = sp.see_buckets
    if sp.exclusion:
        excl_above, excl = _or_above(rows_f > 0)
        mrow = torch.where(excl_above, 0.0, rows_f)
    else:
        mrow = rows_f
        excl = torch.zeros((S, 256), dtype=torch.bool, device=rows_f.device)
    total = _tree_sum(mrow)
    distinct = (mrow > 0).sum(dim=2).to(F32)
    has = total > 0
    ppmc = distinct / torch.clamp(total + distinct, min=1.0)
    bucket = torch.clamp(distinct.to(I32), max=NB - 1)
    oh = (plan.ppm_buckets == bucket[:, :, None]).to(F32)
    adj = (see * oh).sum(dim=2)
    esc = logistic(logit(ppmc) + adj)
    return mrow, total, has, esc, oh, excl


def ppm_update_plain(raw_rows: torch.Tensor, cv: torch.Tensor, completed: torch.Tensor, see: torch.Tensor,
                     plan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The count update between the gather and the scatter, op by op: escape
    correction, update exclusion, count increment and rescale of the
    gathered rows `raw_rows` (S, NO, PPM_ROW_W) of the contexts `cv` with the
    completed bytes `completed` (S,). Returns (the rows to scatter, the new
    `ppm_see`)."""
    sp = plan.meta.spec.ppm
    S, NO = cv.shape
    rows, my_tag, old_tag, _ = _ppm_rows(raw_rows, cv)
    mrow, _, has, esc, bucket_oh, _ = _ppm_cascade(rows.to(F32), see, sp, plan)

    # found: the byte was codable at the order under exclusion; the cascade
    # stops at the highest found order, so orders below it were never
    # exercised and orders above it all escaped
    sym = completed[:, None, None].expand(S, NO, 1)
    found = has & (mrow.gather(2, sym)[:, :, 0] > 0)
    higher_found, _ = _or_above(found)

    # SEE learn: at exercised orders the escape moves toward the observed
    # event (1 above the coded order, 0 at it)
    exercised = has & ~higher_found
    target = (~found).to(F32)
    delta = torch.where(exercised, plan.ppm_see_lr * (target - esc), 0.0)
    new_see = _flush(_flush(see) + bucket_oh * delta[:, :, None])

    # count update: orders at and above the coded order only
    if sp.update_exclusion:
        inc_on = ~higher_found
    else:
        inc_on = torch.ones((S, NO), dtype=torch.bool, device=cv.device)
    c_oh = (plan.lane256 == completed[:, None]).to(I32)
    rows_i = rows + torch.where(inc_on[:, :, None], c_oh[:, None, :] * sp.inc, 0)
    tot_i = rows_i.sum(dim=2)
    rows_i = torch.where((tot_i > sp.rescale_total)[:, :, None], (rows_i + 1) >> 1, rows_i)
    # updated rows are (re)claimed for this context's tag; untouched rows
    # keep their owner's counts and tag. Counts and tag ride one row write.
    counts_w = torch.where(inc_on[:, :, None], rows_i.to(I16), raw_rows[:, :, :256])
    tag_w = torch.where(inc_on, my_tag, old_tag).to(I16)
    pad = torch.zeros((S, NO, PPM_ROW_W - 257), dtype=I16, device=cv.device)
    return torch.cat([counts_w, tag_w[:, :, None], pad], dim=2), new_see


def ppm_predict_plain(raw_rows: torch.Tensor, cv: torch.Tensor, see: torch.Tensor,
                      plan) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The next-byte distribution from the gathered rows of the contexts
    `cv`, op by op: highest order first with symbol exclusion and adaptive
    escapes; the leftover mass goes uniformly to the symbols no order saw.
    Returns (ppm_probs (S, 256), ppm_top, ppm_bot)."""
    sp = plan.meta.spec.ppm
    S, NO = cv.shape
    rows = _ppm_rows(raw_rows, cv)[0]
    mrow, total, has, esc, _, excl = _ppm_cascade(rows.to(F32), see, sp, plan)

    keep = 1.0 - esc
    w = torch.ones((S,), dtype=F32, device=cv.device)
    contrib = []
    for i in range(NO - 1, -1, -1):
        contrib.append(torch.where(has[:, i], w * keep[:, i], 0.0))
        w = torch.where(has[:, i], w * esc[:, i], w)
    contrib = torch.stack(contrib[::-1], dim=1)
    terms = contrib[:, :, None] * mrow / torch.clamp(total, min=1.0)[:, :, None]
    p = torch.zeros((S, 256), dtype=F32, device=cv.device)
    for i in range(NO - 1, -1, -1):
        p = p + terms[:, i]
    # order -1: uniform over the symbols not excluded; all excluded -> all
    free = (~excl).to(F32)
    nex = free.sum(dim=1)
    uni = torch.where((nex > 0)[:, None], free / torch.clamp(nex, min=1.0)[:, None], plan.ppm_uniform)
    p = p + w[:, None] * uni
    return (p, torch.full((S,), 255, dtype=I32, device=cv.device),
            torch.zeros((S,), dtype=I32, device=cv.device))


# ---------------------------------------------------------------------------
# the two kernels (csrc/ppm.cu): the same functions on CUDA tensors
# ---------------------------------------------------------------------------

# the most orders and escape buckets the kernels take (csrc/ppm.cu:
# kMaxOrders, kMaxBuckets)
MAX_ORDERS, MAX_BUCKETS = 16, 64


def _args(what: str, plan) -> Dict:
    """The kernels' scalar arguments, the spec's orders and escape buckets
    checked against their limits."""
    sp = plan.meta.spec.ppm
    if not (1 <= len(sp.orders) <= MAX_ORDERS and 1 <= sp.see_buckets <= MAX_BUCKETS):
        raise ValueError(f"{what}: the kernel takes 1 to {MAX_ORDERS} orders and 1 to {MAX_BUCKETS} escape buckets, "
                         f"got {len(sp.orders)} and {sp.see_buckets}")
    return dict(NO=len(sp.orders), NB=sp.see_buckets, inc=sp.inc, rescale_total=sp.rescale_total,
                exclusion=int(sp.exclusion), update_exclusion=int(sp.update_exclusion),
                see_lr=float(np.float32(sp.see_lr)))


def ppm_update_kernel(raw_rows: torch.Tensor, cv: torch.Tensor, completed: torch.Tensor, see: torch.Tensor,
                      plan) -> Tuple[torch.Tensor, torch.Tensor]:
    """`ppm_update_plain` as one launch of csrc/ppm.cu's update kernel, on
    CUDA tensors."""
    S, NO = cv.shape
    rows_out, see_out = torch.empty_like(raw_rows), torch.empty_like(see)
    kernels.launch("ppm_update", dict(S=S, **_args("ppm_update", plan)), {
        "raw": (raw_rows, (S, NO, PPM_ROW_W), I16), "cv": (cv, (S, NO), I64), "completed": (completed, (S,), I64),
        "see": (see, (S, NO, plan.meta.spec.ppm.see_buckets), F32), "rows_out": (rows_out, (S, NO, PPM_ROW_W), I16),
        "see_out": (see_out, tuple(see.shape), F32)})
    return rows_out, see_out


def ppm_predict_kernel(raw_rows: torch.Tensor, cv: torch.Tensor, see: torch.Tensor,
                       plan) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`ppm_predict_plain` as one launch of csrc/ppm.cu's prediction kernel,
    on CUDA tensors."""
    S, NO = cv.shape
    dev = raw_rows.device
    p = torch.empty((S, 256), dtype=F32, device=dev)
    top, bot = torch.empty((S,), dtype=I32, device=dev), torch.empty((S,), dtype=I32, device=dev)
    kernels.launch("ppm_predict", dict(S=S, **_args("ppm_predict", plan)), {
        "raw": (raw_rows, (S, NO, PPM_ROW_W), I16), "cv": (cv, (S, NO), I64),
        "see": (see, (S, NO, plan.meta.spec.ppm.see_buckets), F32), "probs": (p, (S, 256), F32),
        "top": (top, (S,), I32), "bot": (bot, (S,), I32)})
    return p, top, bot


def ppm_update_rows(raw_rows: torch.Tensor, cv: torch.Tensor, completed: torch.Tensor, see: torch.Tensor,
                    plan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The count update between the gather and the scatter: (the rows to
    scatter, the new `ppm_see`). The kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if raw_rows.device.type == "cpu":
        return ppm_update_plain(raw_rows, cv, completed, see, plan)
    return ppm_update_kernel(raw_rows, cv, completed, see, plan)


def ppm_predict_probs(raw_rows: torch.Tensor, cv: torch.Tensor, see: torch.Tensor,
                      plan) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The next-byte distribution from the gathered rows: (ppm_probs,
    ppm_top, ppm_bot). The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if raw_rows.device.type == "cpu":
        return ppm_predict_plain(raw_rows, cv, see, plan)
    return ppm_predict_kernel(raw_rows, cv, see, plan)


@obs.in_part("ppm")
def _ppm_update(stm: Dict, completed: torch.Tensor, plan) -> None:
    """Per-byte PPM learn against the contexts in `stm["ctx"]`: one gather of
    `ppm_tbl` rows, the count update (`ppm_update_rows`) and one scatter;
    updates `stm` in place."""
    cv, h = _ppm_index(stm["ctx"], plan)
    rows_w, stm["ppm_see"] = ppm_update_rows(gather_rows(stm["ppm_tbl"], h), cv, completed, stm["ppm_see"], plan)
    scatter_rows(stm["ppm_tbl"], h, rows_w)


@obs.in_part("ppm")
def _ppm_predict(stm: Dict, raw_rows: torch.Tensor, cv: torch.Tensor, plan) -> None:
    """Next-byte distribution from the gathered rows of the current
    contexts (`ppm_predict_probs`). Sets `ppm_probs`, `ppm_top` and
    `ppm_bot` in `stm`."""
    p, top, bot = ppm_predict_probs(raw_rows, cv, stm["ppm_see"], plan)
    stm.update(ppm_probs=p, ppm_top=top, ppm_bot=bot)
