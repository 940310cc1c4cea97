"""Seeded inputs for the PPM byte model's count update and prediction
(`core.ppm`): gathered `ppm_tbl` rows, their contexts, the completed bytes
and the escape offsets `ppm_see`.

The tests and `chip_smoke.py` hold the two kernels (csrc/ppm.cu) against the
plain versions, and the plain versions against gmix_tpu's, on the same
inputs, made with numpy only so that every side gets the same bits.
`random_inputs` draws rows as the codec leaves them (sparse counts, a few
large ones, most tags this context's, rows on both sides of the rescale);
`edge_inputs` builds one stream per corner the kernels must get right.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.meta import PPM_ROW_W, PPM_TAG_LANE

DENORMAL = np.float32(1e-41)
U16_MAX = 65535
# the streams of `edge_inputs`, in order
EDGE_STREAMS = ("total-at-rescale", "total-past-rescale", "lane-at-u16-max", "tags-reclaimed", "all-excluded",
                "see-denormal-and-zero", "all-empty", "all-at-u16-max")


def _tags(cv: np.ndarray) -> np.ndarray:
    return ((cv >> 24) & 255).astype(np.uint16)


def random_inputs(NO: int, NB: int, S: int, seed: int) -> Dict[str, np.ndarray]:
    """`raw` (S, NO, PPM_ROW_W) uint16, `cv` (S, NO) int64 u32 values,
    `completed` (S,) int64 bytes, `see` (S, NO, NB) float32."""
    rng = np.random.default_rng(seed)
    cv = rng.integers(0, 2**32, (S, NO), dtype=np.int64)
    raw = np.zeros((S, NO, PPM_ROW_W), np.uint16)
    density = rng.choice([0.0, 0.01, 0.05, 0.2, 0.6, 1.0], (S, NO))
    scale = rng.choice([4, 60, 400, 4000, U16_MAX + 1], (S, NO), p=[0.3, 0.3, 0.2, 0.15, 0.05])
    counts = rng.integers(1, scale[:, :, None], (S, NO, 256)) * (rng.random((S, NO, 256)) < density[:, :, None])
    raw[:, :, :256] = counts
    tags = _tags(cv)
    other = (tags + rng.integers(1, 256, (S, NO))) & 255
    raw[:, :, PPM_TAG_LANE] = np.where(rng.random((S, NO)) < 0.85, tags, other)
    # the padding lanes hold whatever was there; the update writes zeros
    raw[:, :, PPM_TAG_LANE + 1:] = rng.integers(0, 2**16, (S, NO, PPM_ROW_W - PPM_TAG_LANE - 1))
    # half the streams complete a byte some order has seen, at a random order
    completed = rng.integers(0, 256, S).astype(np.int64)
    for s in range(0, S, 2):
        i = int(rng.integers(0, NO))
        seen = np.flatnonzero(raw[s, i, :256])
        if len(seen):
            completed[s] = rng.choice(seen)
    see = (rng.standard_normal((S, NO, NB)) * 0.5).astype(np.float32)
    pick = rng.random((S, NO, NB))
    see[pick < 0.04] = DENORMAL
    see[(pick >= 0.04) & (pick < 0.08)] = -DENORMAL
    see[(pick >= 0.08) & (pick < 0.12)] = np.float32(-0.0)
    see[(pick >= 0.12) & (pick < 0.14)] = np.float32(0.0)
    return {"raw": raw, "cv": cv, "completed": completed, "see": see}


def edge_inputs(cv: np.ndarray, NB: int, inc: int, rescale_total: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Rows for the contexts `cv` (len(EDGE_STREAMS), NO), NO >= 2, one stream
    per corner (`EDGE_STREAMS`), the orders' tags matching unless said:

    - total-at-rescale / total-past-rescale: the top order saw the completed
      byte, so it alone is updated (under update exclusion), and its total
      after the increment is `rescale_total` (kept) or one more (halved);
    - lane-at-u16-max: the completed byte's count is 65535 at the top order
      and another lane's too: the increment passes u16 and the row halves;
    - tags-reclaimed: the two top orders' rows belong to other contexts (read
      as empty, updated under this context's tag);
    - all-excluded: the top order saw every symbol, so every lower order is
      excluded whole and order -1 has no symbol left (the 1/256 fallback);
    - see-denormal-and-zero: `ppm_see` holds denormals of both signs and
      both zeros in every bucket; the byte is coded at a middle order, so
      orders above it learn an escape, the middle one a hit and orders below
      it nothing;
    - all-empty: every row empty: no order has counts, all mass is order -1's;
    - all-at-u16-max: every count of every order is 65535, a row total of
      256 x 65535 = 16 776 960 (the largest; below 2^24).
    """
    S, NO = cv.shape
    if S != len(EDGE_STREAMS) or NO < 2:
        raise ValueError(f"edge_inputs takes {len(EDGE_STREAMS)} streams of at least 2 orders, got {cv.shape}")
    rng = np.random.default_rng(seed)
    tags = _tags(cv)
    raw = np.zeros((S, NO, PPM_ROW_W), np.uint16)
    raw[:, :, PPM_TAG_LANE] = tags
    # a sparse background at the lower orders
    raw[:, :NO - 1, :256] = rng.integers(1, 30, (S, NO - 1, 256)) * (rng.random((S, NO - 1, 256)) < 0.1)
    completed = rng.integers(0, 256, S).astype(np.int64)
    see = (rng.standard_normal((S, NO, NB)) * 0.5).astype(np.float32)
    top = NO - 1
    at = {name: s for s, name in enumerate(EDGE_STREAMS)}
    for name, total in (("total-at-rescale", rescale_total), ("total-past-rescale", rescale_total + 1)):
        s = at[name]
        row = raw[s, top, :256]
        row[:] = 0
        rest = total - inc
        lanes = np.arange(5, 256, 9)
        row[lanes] = rest // len(lanes)
        row[lanes[0]] += rest - int(row[lanes].sum())
        completed[s] = lanes[3]
    s = at["lane-at-u16-max"]
    raw[s, top, :256] = 0
    raw[s, top, [40, 41, 200]] = (U16_MAX, U16_MAX, 3)
    completed[s] = 40
    s = at["tags-reclaimed"]
    raw[s, top - 1:, :256] = rng.integers(1, 500, (2, 256))
    raw[s, top - 1:, PPM_TAG_LANE] = (tags[s, top - 1:] + 1) & 255
    s = at["all-excluded"]
    raw[s, top, :256] = rng.integers(1, 9, 256)
    s = at["see-denormal-and-zero"]
    mid = NO // 2
    raw[s, :, :256] = 0
    raw[s, :mid + 1, 77] = 5
    raw[s, mid + 1:, 90] = 7
    completed[s] = 77
    # each order's selected bucket (1: one distinct symbol) takes each value
    odd = np.array([DENORMAL, -DENORMAL, np.float32(-0.0), np.float32(0.0)], np.float32)
    see[s] = odd[(np.arange(NB)[None, :] + np.arange(NO)[:, None]) % 4]
    s = at["all-empty"]
    raw[s, :, :256] = 0
    s = at["all-at-u16-max"]
    raw[s, :, :256] = U16_MAX
    return {"raw": raw, "cv": cv.astype(np.int64), "completed": completed, "see": see}
