# Frozen copy of gmix_tpu_torch/ops/rowmove.py (its plain versions) at commit 334906b, plain torch on the CPU only;
# imports nothing of gmix_tpu_torch, gmix_tpu or jax (h100_bench/reference/__init__.py).
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

from typing import List, Sequence, Tuple

import torch



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


