"""Seeded states for the byte step's boundary contexts and match pointers
(`core.contexts`): the short-term leaves they read and write, and the
entries of the three large tables they touch.

The tests and `chip_smoke.py` hold the two kernels (csrc/contexts.cu)
against the plain versions, and the plain versions against gmix_tpu's, on
the same states, made with numpy so that every side gets the same bits. A
state of the published sizes holds `ih_tbl`, `match_tbl` and `hist` of
hundreds of MB a stream, so a sample keeps only the table entries the step
reads (the rest are zero) and `to_state` builds the tables where they are
used, for all streams or a few. `random_state` draws states as the codec
leaves them (bytes in the byte leaves, u32 hashes, short and long matches,
an empty history now and then); `edge_state` builds one stream per corner
the kernels must get right (`EDGE_STREAMS`).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.meta import Meta
from ..ops.murmur import murmur3_u64
from ..state import state_from_numpy

U32 = 2**32
# the streams of `edge_state`, in order
EDGE_STREAMS = ("ih-new-is-old", "match-len-255", "ptr-at-hist-end", "hist-empty", "ptr-wraps", "roll-negative",
                "byte-0", "byte-255")
# table: (its dict, the numpy dtype it is drawn in)
TABLES = {"ih_tbl": ("stm", np.uint32), "match_tbl": ("ltm", np.uint32), "hist": ("ltm", np.uint8)}


def _u32(rng, shape) -> np.ndarray:
    return rng.integers(0, U32, shape, dtype=np.uint64).astype(np.uint32)


def _outer_hash(outer_ctx: np.ndarray, last_byte: np.ndarray, omask: np.ndarray) -> np.ndarray:
    """The indirect-hash contexts' new outer hash for the byte `last_byte`
    (S,), as the boundary computes it (ops/murmur.py on the CPU)."""
    outer_new = ((outer_ctx.astype(np.int64) & omask[None, :]) << 8) + last_byte.astype(np.int64)[:, None]
    t = torch.as_tensor(outer_new)
    return murmur3_u64(t, torch.zeros_like(t)).numpy().astype(np.uint32)


def _draw(meta: Meta, S: int, rng) -> Dict[str, np.ndarray]:
    """The short-term leaves, in gmix_tpu's dtypes."""
    spec = meta.spec
    NM, NR, NIH = len(spec.matches), len(spec.roll_ctxs), len(spec.ihash_ctxs)
    stm = {
        "acc": rng.integers(0, 256, S).astype(np.uint32),
        "last_byte": rng.integers(0, 256, S).astype(np.uint32),
        "recent": rng.integers(0, 256, (S, meta.recent_size)).astype(np.uint32),
        "ctx": _u32(rng, (S, meta.n_ctx)),
        "new_bit": rng.integers(0, 2, S).astype(np.uint32),
        "hist_n": np.where(rng.random(S) < 0.15, 0, _u32(rng, S)).astype(np.uint32),
    }
    if NR:
        stm["roll_h"] = _u32(rng, (S, NR))
    if NIH:
        stm["ih_outer_ctx"] = _u32(rng, (S, NIH))
        stm["ih_outer_hash"] = _u32(rng, (S, NIH))
    if NM:
        stm["match_byte"] = rng.integers(0, 256, (S, NM)).astype(np.uint32)
        short, long_ = rng.integers(0, 8, (S, NM)), rng.integers(8, 256, (S, NM))
        stm["match_len"] = np.where(rng.random((S, NM)) < 0.5, short, long_).astype(np.int32)
        ptr = _u32(rng, (S, NM))
        at_end = rng.random((S, NM)) < 0.1
        stm["match_ptr"] = np.where(at_end, (stm["hist_n"].astype(np.int64)[:, None] - 1) % U32, ptr).astype(np.uint32)
    return stm


def _edges(meta: Meta, stm: Dict[str, np.ndarray]) -> None:
    """Make stream i of `stm` the corner EDGE_STREAMS[i], in place."""
    spec = meta.spec
    at = {name: s for s, name in enumerate(EDGE_STREAMS)}
    s = at["ih-new-is-old"]
    stm["last_byte"][s] = stm["acc"][s]  # the same byte at t == 0 and after
    if spec.ihash_ctxs:
        omask = meta.ih_outer_mods.astype(np.int64) - 1
        stm["ih_outer_hash"][s] = _outer_hash(stm["ih_outer_ctx"][s : s + 1], stm["acc"][s : s + 1], omask)[0]
    if spec.matches:
        # a hit on every model: new_bit equals the match byte's low bit
        for name in ("match-len-255", "ptr-at-hist-end", "ptr-wraps"):
            s = at[name]
            stm["match_byte"][s] = (stm["match_byte"][s] & 0xFE) | stm["new_bit"][s]
        s = at["match-len-255"]
        stm["hist_n"][s] = 1000
        stm["match_len"][s] = 255
        stm["match_ptr"][s] = 5
        s = at["ptr-at-hist-end"]
        stm["hist_n"][s] = max(int(stm["hist_n"][s]), 1)
        stm["match_len"][s] = 20
        stm["match_ptr"][s] = (int(stm["hist_n"][s]) - 1) % U32
        s = at["hist-empty"]
        stm["hist_n"][s] = 0
        stm["match_ptr"][s, ::2] = U32 - 1  # the pointer at (0 - 1) & MASK32
        s = at["ptr-wraps"]
        stm["hist_n"][s] = 7
        stm["match_len"][s] = 100
        stm["match_ptr"][s] = U32 - 1  # a long match steps to 0
    if spec.roll_ctxs:
        s = at["roll-negative"]
        stm["roll_h"][s] = 0
        stm["recent"][s, meta.roll_old_ix] = 255  # h - 255 * B^(n-1) < 0
    for name, b in (("byte-0", 0), ("byte-255", 255)):
        s = at[name]
        stm["acc"][s] = stm["last_byte"][s] = b
        stm["recent"][s] = b


def _entries(meta: Meta, stm: Dict[str, np.ndarray], rng) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The table entries the boundary and the match pointers read, drawn:
    `ih_tbl` at each indirect-hash context's old index and at its new one
    for both bytes it may take (t == 0 and after), `match_tbl` at each match
    model's row, `hist` where either pointer rule points. (rows, columns,
    values) by table, one value a place."""
    spec = meta.spec
    S = len(stm["acc"])
    out = {}

    def put(name, rows, cols, vals):
        rows, cols = np.broadcast_arrays(np.asarray(rows, np.int64), np.asarray(cols, np.int64))
        r0, c0, v0 = out.get(name, (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, TABLES[name][1])))
        out[name] = (np.concatenate([r0, rows.ravel()]), np.concatenate([c0, cols.ravel()]),
                     np.concatenate([v0, np.asarray(vals, TABLES[name][1]).ravel()]))

    rows = np.arange(S)[:, None]
    if spec.ihash_ctxs:
        masks, offs = meta.ih_masks.astype(np.int64)[None, :], meta.ih_offsets.astype(np.int64)[None, :]
        omask = meta.ih_outer_mods.astype(np.int64) - 1
        idx = [(stm["ih_outer_hash"].astype(np.int64) & masks) + offs]
        for b in (stm["acc"], stm["last_byte"]):
            idx.append((_outer_hash(stm["ih_outer_ctx"], b, omask).astype(np.int64) & masks) + offs)
        for ix in idx:
            put("ih_tbl", rows, ix, _u32(rng, ix.shape))
    if spec.matches:
        mix = (stm["ctx"][:, meta.match_ctx_slots].astype(np.int64) & meta.match_masks.astype(np.int64)[None, :]) \
            + meta.match_offsets.astype(np.int64)[None, :]
        # table pointers near the history's end, or anywhere
        near = (stm["hist_n"].astype(np.int64)[:, None] - rng.integers(1, 64, mix.shape)) % U32
        tbl_ptr = np.where(rng.random(mix.shape) < 0.5, near, _u32(rng, mix.shape)).astype(np.uint32)
        put("match_tbl", rows, mix, tbl_ptr)
        H = meta.history_size
        for p in (tbl_ptr.astype(np.int64), stm["match_ptr"].astype(np.int64) + 1):
            put("hist", rows, p & (H - 1), rng.integers(0, 256, p.shape))
    for name, (r, c, v) in out.items():
        # one value a place: the last drawn
        key = r * (1 << 40) + c
        _, last = np.unique(key[::-1], return_index=True)
        keep = len(key) - 1 - last
        out[name] = (r[keep], c[keep], v[keep])
    return out


def random_state(meta: Meta, S: int, seed: int) -> Dict:
    """A sample of S streams: {"stm": the short-term leaves (numpy, gmix_tpu's
    dtypes), "entries": the drawn table entries (`_entries`)}."""
    rng = np.random.default_rng(seed)
    stm = _draw(meta, S, rng)
    return {"stm": stm, "entries": _entries(meta, stm, rng)}


def edge_state(meta: Meta, seed: int = 0) -> Dict:
    """A sample of len(EDGE_STREAMS) streams, stream i the corner
    EDGE_STREAMS[i] (each applied where the spec has its part):

    - ih-new-is-old: every indirect-hash context's new index equals its old
      one, so the read of the new index sees this byte's write (the same
      byte completes at t == 0 and after);
    - match-len-255: a hit on every match model at length 255: the length
      stays 255;
    - ptr-at-hist-end: the pointer is the last history byte: the length
      restarts at 0 whatever the hit;
    - hist-empty: hist_n == 0: the match bytes keep their values, and half
      the pointers equal (0 - 1) & MASK32;
    - ptr-wraps: a long match at pointer 2^32 - 1 steps to 0;
    - roll-negative: the rolling hashes are 0 and the leaving bytes 255, so
      h - leaving * B^(n-1) is negative before the mask;
    - byte-0 / byte-255: the completed byte, `last_byte` and the ring at 0 /
      255 (the interval maps' ends).
    """
    rng = np.random.default_rng(seed)
    stm = _draw(meta, len(EDGE_STREAMS), rng)
    _edges(meta, stm)
    return {"stm": stm, "entries": _entries(meta, stm, rng)}


def to_state(meta: Meta, sample: Dict, device, streams: Optional[Sequence[int]] = None) -> Tuple[Dict, Dict]:
    """(stm, ltm) on `device`: the sample's leaves, and its tables zero but
    for the drawn entries; only the streams `streams` (all by default)."""
    S = len(sample["stm"]["acc"])
    keep = np.arange(S) if streams is None else np.asarray(streams, np.int64)
    stm = state_from_numpy({k: v[keep] for k, v in sample["stm"].items()}, device)
    ltm: Dict = {}
    widths = {"ih_tbl": meta.ih_total, "match_tbl": meta.match_total, "hist": meta.history_size}
    new_row = np.full(S, -1, np.int64)
    new_row[keep] = np.arange(len(keep))
    for name, (rows, cols, vals) in sample["entries"].items():
        where, _ = TABLES[name]
        on = new_row[rows] >= 0
        vals = vals[on].view(np.int32) if name != "hist" else vals[on]
        tbl = torch.zeros((len(keep), widths[name]), dtype=torch.int32 if name != "hist" else torch.uint8,
                          device=device)
        tbl[torch.as_tensor(new_row[rows[on]], device=device), torch.as_tensor(cols[on], device=device)] = \
            torch.as_tensor(vals, device=device)
        (stm if where == "stm" else ltm)[name] = tbl
    return stm, ltm
