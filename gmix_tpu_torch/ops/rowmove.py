"""Batched arena-row movers: gather/scatter rows of (S, N, W) tables.

Port of `gmix_tpu.ops.rowmove`. The byte step moves a few dozen rows per
stream per byte between the arenas and its working sets (indirect blocks,
mixer rows, position blocks, APM rows; see core/step.py). On a CUDA tensor
each mover launches its hand-written kernel (csrc/rowmove.cu, called
through ops/kernels.py) or raises; on a CPU tensor it runs the plain torch version
beside it. The kernels only move bytes, so both give the same bits.

A launch costs more than the bytes it moves (csrc/rowmove.cu), so each mover
takes a list of arenas in one launch: `gather_rows_many` and
`scatter_rows_many`. `gather_rows` and `scatter_rows` are lists of one
through the same two kernels.

Row indices must be unique within a stream (each model family owns a
disjoint offset range of its arena; core/meta.py builds them that way), so
no two scattered rows race.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import kernels

# the most arenas one grouped launch takes (csrc/rowmove.cu: kMaxArenas)
MAX_ARENAS = 8
# GmixRowArena of csrc/rowmove.cu: tbl, idx, rows, S, N, M, row_bytes, each 8
# bytes wide
_ARENA_FIELDS = 7


def gather_rows_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(S, N, W)[s, idx[s, m]] -> (S, M, W)."""
    s_ix = torch.arange(tbl.shape[0], device=tbl.device)[:, None]
    return tbl[s_ix, idx]


def gather_rows_many_plain(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> List[torch.Tensor]:
    """[(tbl_a (S, N_a, W_a), idx_a (S, M_a))] -> [tbl_a[s, idx_a[s, m]]]."""
    return [gather_rows_plain(tbl, idx) for tbl, idx in pairs]


def scatter_rows_plain(tbl: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """tbl[s, idx[s, m]] = upd[s, m] in place; returns tbl."""
    s_ix = torch.arange(tbl.shape[0], device=tbl.device)[:, None]
    tbl[s_ix, idx] = upd
    return tbl


def scatter_rows_many_plain(triples: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]) -> List[torch.Tensor]:
    """[(tbl_a, idx_a, upd_a)]: tbl_a[s, idx_a[s, m]] = upd_a[s, m] in place;
    returns the tables."""
    return [scatter_rows_plain(tbl, idx, upd) for tbl, idx, upd in triples]


def _launch(wrapper: str, arenas) -> None:
    """One launch of a grouped mover on CUDA tensors: `arenas` is a list of
    (table, indices, packed rows), each checked (ops/kernels.py `check`)."""
    if not 1 <= len(arenas) <= MAX_ARENAS:
        raise ValueError(f"{wrapper}: one launch takes 1 to {MAX_ARENAS} arenas, got {len(arenas)}")
    dev = arenas[0][0].device
    for tbl, _, _ in arenas:
        if tbl.device != dev:
            raise ValueError(f"{wrapper}: every arena must lie on one device, got {tbl.device} and {dev}")
    desc = (ctypes.c_int64 * (_ARENA_FIELDS * len(arenas)))()
    for a, (tbl, idx, rows) in enumerate(arenas):
        if tbl.dim() != 3 or idx.dim() != 2 or idx.shape[0] != tbl.shape[0]:
            raise ValueError(f"{wrapper}: expected tbl (S, N, W) and idx (S, M), got {tuple(tbl.shape)} / "
                             f"{tuple(idx.shape)}")
        S, N, W = tbl.shape
        M = idx.shape[1]
        kernels.check(wrapper, {"table": (tbl, (S, N, W), tbl.dtype), "indices": (idx, (S, M), torch.int32),
                                "rows": (rows, (S, M, W), tbl.dtype)}, aligned=("table", "indices", "rows"))
        if (W * tbl.element_size()) % 16:
            raise ValueError(f"{wrapper}: row width {W * tbl.element_size()} B is not a multiple of 16")
        desc[a * _ARENA_FIELDS : (a + 1) * _ARENA_FIELDS] = (
            tbl.data_ptr(), idx.data_ptr(), rows.data_ptr(), S, N, M, W * tbl.element_size())
    kernels.call(wrapper, dev, desc, len(arenas))


def _gather_launch(what: str, pairs) -> List[torch.Tensor]:
    """Allocate each arena's output rows and gather into them in one launch."""
    arenas = []
    for tbl, idx in pairs:
        if tbl.dim() != 3 or idx.dim() != 2:
            raise ValueError(f"{what}: expected tbl (S, N, W) and idx (S, M), got {tuple(tbl.shape)} / {tuple(idx.shape)}")
        out = torch.empty((tbl.shape[0], idx.shape[1], tbl.shape[2]), dtype=tbl.dtype, device=pairs[0][0].device)
        arenas.append((tbl, idx, out))
    _launch(what, arenas)
    return [out for _, _, out in arenas]


def gather_rows_many(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> List[torch.Tensor]:
    """[(tbl_a (S, N_a, W_a), idx_a (S, M_a))] -> [tbl_a[s, idx_a[s, m]]], up
    to 8 arenas of any row widths and dtypes: ONE launch of the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if not pairs:
        return []
    if all(tbl.device.type == "cpu" for tbl, _ in pairs):
        return gather_rows_many_plain(pairs)
    return _gather_launch("gather_rows_many", pairs)


def gather_rows(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(S, N, W)[s, idx[s, m]] -> (S, M, W): the kernel on CUDA (a group of
    one arena), plain on CPU."""
    if tbl.device.type == "cpu":
        return gather_rows_plain(tbl, idx)
    return _gather_launch("gather_rows", [(tbl, idx)])[0]


def scatter_rows_many(triples: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]) -> List[torch.Tensor]:
    """[(tbl_a (S, N_a, W_a), idx_a (S, M_a), upd_a (S, M_a, W_a))]:
    tbl_a[s, idx_a[s, m]] = upd_a[s, m] in place, for up to 8 DISTINCT
    tables of any row widths and dtypes, idx_a unique within each stream;
    returns the tables. ONE launch of the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    triples = list(triples)
    if not triples:
        return []
    if all(tbl.device.type == "cpu" for tbl, _, _ in triples):
        return scatter_rows_many_plain(triples)
    _launch("scatter_rows_many", triples)
    return [tbl for tbl, _, _ in triples]


def scatter_rows(tbl: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """tbl[s, idx[s, m]] = upd[s, m] in place, idx unique per stream; returns
    tbl. The kernel on CUDA (a group of one arena), plain on CPU."""
    if tbl.device.type == "cpu":
        return scatter_rows_plain(tbl, idx, upd)
    _launch("scatter_rows", [(tbl, idx, upd)])
    return tbl
