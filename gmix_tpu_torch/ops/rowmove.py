"""Batched arena-row movers: gather/scatter rows of (S, N, W) tables.

Port of `gmix_tpu.ops.rowmove`. The byte step moves a few dozen rows per
stream per byte between the arenas and its working sets (indirect blocks,
mixer rows, position blocks, APM rows; see core/step.py). On a CUDA tensor
each mover launches its hand-written kernel (csrc/rowmove.cu, built by
utils/build.py) or raises; on a CPU tensor it runs the plain torch version
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

from ..utils.build import check_launch, load_kernels

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


def _check_cuda(what: str, tbl: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """Validate what the kernel takes; raise on anything else."""
    if tbl.device.type != "cuda":
        raise ValueError(f"{what}: table on {tbl.device}, expected a CUDA or CPU tensor")
    if idx.device != tbl.device or rows.device != tbl.device:
        raise ValueError(f"{what}: table, indices and rows must share one device")
    if idx.dtype != torch.int32:
        raise ValueError(f"{what}: indices must be int32, got {idx.dtype}")
    if rows.dtype != tbl.dtype:
        raise ValueError(f"{what}: rows are {rows.dtype}, table is {tbl.dtype}")
    if tbl.dim() != 3 or idx.dim() != 2 or idx.shape[0] != tbl.shape[0]:
        raise ValueError(f"{what}: expected tbl (S, N, W) and idx (S, M), got {tuple(tbl.shape)} / {tuple(idx.shape)}")
    S, M, W = tbl.shape[0], idx.shape[1], tbl.shape[2]
    if tuple(rows.shape) != (S, M, W):
        raise ValueError(f"{what}: rows {tuple(rows.shape)} != {(S, M, W)}")
    for name, t in (("table", tbl), ("indices", idx), ("rows", rows)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    if (W * tbl.element_size()) % 16:
        raise ValueError(f"{what}: row width {W * tbl.element_size()} B is not a multiple of 16")


def _launch(what: str, entry: str, arenas) -> None:
    """One launch of a grouped mover (`entry`: the C function) on CUDA
    tensors: `arenas` is a list of (table, indices, packed rows)."""
    if not 1 <= len(arenas) <= MAX_ARENAS:
        raise ValueError(f"{what}: one launch takes 1 to {MAX_ARENAS} arenas, got {len(arenas)}")
    dev = arenas[0][0].device
    for tbl, _, _ in arenas:
        if tbl.device != dev:
            raise ValueError(f"{what}: every arena must lie on one device, got {tbl.device} and {dev}")
    desc = (ctypes.c_int64 * (_ARENA_FIELDS * len(arenas)))()
    for a, (tbl, idx, rows) in enumerate(arenas):
        _check_cuda(what, tbl, idx, rows)
        S, N, W = tbl.shape
        desc[a * _ARENA_FIELDS : (a + 1) * _ARENA_FIELDS] = (
            tbl.data_ptr(), idx.data_ptr(), rows.data_ptr(), S, N, idx.shape[1], W * tbl.element_size())
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(desc, len(arenas), torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, rc, what)


def _gather_launch(what: str, pairs) -> List[torch.Tensor]:
    """Allocate each arena's output rows and gather into them in one launch."""
    arenas = []
    for tbl, idx in pairs:
        if tbl.dim() != 3 or idx.dim() != 2:
            raise ValueError(f"{what}: expected tbl (S, N, W) and idx (S, M), got {tuple(tbl.shape)} / {tuple(idx.shape)}")
        out = torch.empty((tbl.shape[0], idx.shape[1], tbl.shape[2]), dtype=tbl.dtype, device=pairs[0][0].device)
        arenas.append((tbl, idx, out))
    _launch(what, "gmix_gather_rows_many", arenas)
    return [out for _, _, out in arenas]


def gather_rows_many(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> List[torch.Tensor]:
    """[(tbl_a (S, N_a, W_a), idx_a (S, M_a))] -> [tbl_a[s, idx_a[s, m]]], up
    to 8 arenas of any row widths and dtypes: ONE launch of the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if not pairs:
        return []
    if all(tbl.device.type == "cpu" for tbl, _ in pairs):
        return gather_rows_many_plain(pairs)
    outs = _gather_launch("gather_rows_many", pairs)
    gather_rows_many.launches += 1
    return outs


def gather_rows(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(S, N, W)[s, idx[s, m]] -> (S, M, W): the kernel on CUDA (a group of
    one arena), plain on CPU."""
    if tbl.device.type == "cpu":
        return gather_rows_plain(tbl, idx)
    out = _gather_launch("gather_rows", [(tbl, idx)])[0]
    gather_rows.launches += 1
    return out


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
    _launch("scatter_rows_many", "gmix_scatter_rows_many", triples)
    scatter_rows_many.launches += 1
    return [tbl for tbl, _, _ in triples]


def scatter_rows(tbl: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """tbl[s, idx[s, m]] = upd[s, m] in place, idx unique per stream; returns
    tbl. The kernel on CUDA (a group of one arena), plain on CPU."""
    if tbl.device.type == "cpu":
        return scatter_rows_plain(tbl, idx, upd)
    _launch("scatter_rows", "gmix_scatter_rows_many", [(tbl, idx, upd)])
    scatter_rows.launches += 1
    return tbl


def prepare(device) -> None:
    """Load the movers' kernels on `device` (a CUDA device), as their first
    launch would, before a CUDA graph capture records a launch."""
    lib = load_kernels()
    with torch.cuda.device(torch.device(device)):
        check_launch(lib, lib.gmix_rowmove_prepare(), "rowmove prepare")


def empty_launch(device) -> None:
    """Launch the library's empty kernel on `device`'s current stream: the
    device-side cost of a launch, for measurement beside the movers' times."""
    dev = torch.device(device)
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.gmix_empty_launch(torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, rc, "empty_launch")


# kernel launch counters: one per launch of the CUDA kernel, none for the
# plain CPU path
gather_rows.launches = 0
gather_rows_many.launches = 0
scatter_rows.launches = 0
scatter_rows_many.launches = 0
