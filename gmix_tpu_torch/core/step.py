"""The codec's byte step: boundary contexts, one gather of the per-byte
working sets, the 8 bit sub-steps with their deferred writes, and the
byte-end scatter.

Port of `gmix_tpu.core.step._byte_step`. The 8 sub-steps and the deferred
per-bit writes are one function, `core/fused.py:fused_substeps`: one
hand-written CUDA kernel on a CUDA device, the eager torch loop on the CPU.
The PPM byte model's boundary work is `core/ppm.py`, the LSTM byte model is
`core/lstm.py`, the boundary contexts and match pointers `core/contexts.py`,
and the row indices, dense rows and packed registers before the gather
`core/inputs.py`. This module keeps what surrounds them, in eager torch,
with the arena rows moved by the kernels of `ops/rowmove.py`. On a GPU a
byte step is therefore 6 hand-written launches (the boundary contexts and
the match pointers, the inputs kernel, one gather of every arena, the
sub-steps, one scatter of every arena), and 10 with PPM, whose count update
gathers and scatters its own rows first, with its update kernel between
them, and whose prediction is a kernel too; plus the eager byte-end ops.
With PPM and an LSTM it is 13: the LSTM's forward pass (one kernel) reads
the PPM prediction and sets the `lstm_ctx` context, which an indirect model
may be keyed on, so the rows of `ppm_tbl` are gathered on their own before
the prediction, and the other arenas after the forward pass; the byte end's
SGD of its output layer is one kernel more. A sampling step (generation:
learn off) makes no byte-end scatter and no SGD: 5, 9 and 11 launches.

The JAX function is the reference; the port keeps its expression order op
for op, because the decoder must replay the encoder's float updates bit for
bit, and because the port is held bitwise against it:

- Every float op is its own torch op. In particular nothing here uses
  `add/sub(alpha=)`, `addcmul`, `addcdiv`, `lerp`, `addmm` or `baddbmm`,
  which may contract `a*b+c` into one rounding on CUDA. XLA:CPU does
  contract inside jitted programs, so the port follows gmix_tpu run eagerly
  (`jax.disable_jit()`), where every op rounds on its own.
- Inexact float reductions are fixed binary trees (`fused._tree_sum`). Where
  gmix_tpu sums a one-hot selection, the port gathers (integers) or sums
  the same selection (floats): a sum with one nonzero term is exact in any
  order.

The step updates the state dict in place: the arenas are scattered into
where they lie instead of being copied every byte, and every other leaf
that a step computes anew is copied back into its own storage at the step's
end, so that no leaf moves. u32 values are int64 tensors in [0, 2^32) (see
state.py).

The compiled chunk (gmix_tpu's `make_chunk_fn` / `get_chunk_fn` and their
sampling counterparts, at the end of this module) runs the same step: on a
CUDA device as CUDA graphs that the host replays once a byte, on the CPU op
by op. The step is written for the graphs: the byte index is a 0-d device
tensor (the stream's first byte selects with it), the LSTM's epoch is read
from its device leaf, and no op reads a value back to the host. What the
host still decides (the direction, learn, analysis, sampling, the byte that
wraps the LSTM's window, the deferred backward pass) picks the graph.
"""
from __future__ import annotations

import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..ops import kernels
from ..ops.murmur import MASK32
from ..ops.rowmove import gather_rows, gather_rows_many, scatter_rows_many
from . import fused as _fused
from .fused import (  # noqa: F401  (_tri_solve: held against gmix_tpu's by the step tests)
    CODER_WIN,
    _tri_solve,
    const_inputs,
    fused_substeps,
    pack_inputs,
    unpack_outputs,
)
from .lstm import LstmPlan, _lstm_bptt, _lstm_forward, _lstm_perceive
from .contexts import boundary_contexts, boundary_table, match_pointers, match_table
from .inputs import byte_inputs, inputs_table, ppm_grouped, ppm_regs
from .meta import Meta
from .ppm import _ppm_index, _ppm_predict, _ppm_update

I32 = torch.int32
I64 = torch.int64


class StepPlan:
    """The byte step's constants for one (meta, stream count, device): index
    vectors and small tables, moved to the device once. The constants of the
    sub-steps are `fused` (core/fused.py:const_inputs)."""

    def __init__(self, meta: Meta, num_streams: int, device):
        spec = meta.spec
        self.meta = meta
        self.S = num_streams
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.fused = const_inputs(meta, True, self.device)

        def t(a, dtype=I64):
            return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

        self.s_ix = torch.arange(num_streams, device=self.device)[:, None]
        self.win_lanes = torch.arange(CODER_WIN, device=self.device)
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
        self.roll_slots = t(meta.roll_slots)
        self.roll_old_ix = t(meta.roll_old_ix)
        self.roll_pows = t(meta.roll_pows)[None, :]
        # indirect models
        self.ind_ctx_slots = t(meta.ind_ctx_slots)
        self.ind_blk_masks = t(meta.ind_blk_masks)[None, :]
        self.ind_blk_offsets = t(meta.ind_blk_offsets)[None, :]
        self.ind_rotate = t(meta.ind_rotate)[None, :]
        # match models
        self.match_ctx_slots = t(meta.match_ctx_slots)
        self.match_masks = t(meta.match_masks)[None, :]
        self.match_offsets = t(meta.match_offsets)[None, :]
        # the contexts kernels' constant tables (core/contexts.py)
        self.boundary_consts = t(boundary_table(meta))
        self.match_consts = t(match_table(meta))
        # the inputs kernel's constant table (core/inputs.py)
        self.inputs_consts = t(inputs_table(meta))
        # mixers
        self.mix_st_slots = t(meta.mix_st_slots)
        self.mix_st_masks = t(meta.mix_st_masks)[None, :]
        self.mix_st_offsets = t(meta.mix_st_offsets)[None, :]
        self.mix_pos_slots = t(meta.mix_pos_slots)
        self.mix_pos_masks = t(meta.mix_pos_masks)[None, :]
        self.mix_pos_offsets = t(meta.mix_pos_offsets)[None, :]
        self.cd_aranges = [torch.arange(int(T), device=self.device)[None, :] for T in meta.mix_cd_sizes]
        # APM
        self.apm_ctx_slots = t(meta.apm_ctx_slots)
        self.apm_masks = t(meta.apm_masks)[None, :]
        self.apm_offsets = t(meta.apm_offsets)[None, :]
        # PPM
        if spec.ppm is not None:
            self.ppm_slots = t(meta.ppm_slots)
            self.ppm_masks = t(meta.ppm_masks)[None, :]
            self.ppm_row_offsets = t(meta.ppm_row_offsets)[None, :]
            self.lane256 = torch.arange(256, device=self.device)[None, :]
            self.ppm_buckets = torch.arange(spec.ppm.see_buckets, device=self.device)[None, None, :]
            self.ppm_see_lr = t(np.float32(spec.ppm.see_lr), torch.float32)
            self.ppm_uniform = t(np.float32(1.0 / 256), torch.float32)
        # LSTM
        if spec.lstm is not None:
            self.lstm = LstmPlan(spec.lstm, num_streams, self.device)
            self.lstm_ctx_slot = int(meta.slots["lstm_ctx"])
        # the host's copy of the LSTM's epoch and the leaf it was read from
        self._epoch: Optional[int] = None
        self._epoch_leaf: Optional[torch.Tensor] = None
        # the compiled chunks of this plan's state (`get_chunk_fn`), their
        # CUDA graphs' one memory pool and the stream they are captured on
        self.fn_cache: Dict = {}
        self._pool = None
        self._capture_stream = None

    def host_epoch(self, lst: Dict) -> int:
        """The LSTM's epoch as a host integer, kept beside the state's 0-d
        `epoch` leaf: read from the device once for a leaf this plan has not
        seen (a state from outside, or after `forget_epoch`), then advanced
        by `advance_epoch` without reading the device. The byte step reads
        the leaf itself; the host's copy only chooses which graph runs (the
        byte that wraps the window, the deferred backward pass)."""
        if lst["epoch"] is not self._epoch_leaf:
            self._epoch, self._epoch_leaf = int(lst["epoch"]), lst["epoch"]
        return self._epoch

    def advance_epoch(self, lst: Dict) -> None:
        """After a byte's forward pass (`lst` the state's LSTM leaves)."""
        self._epoch = (self.host_epoch(lst) + 1) % self.meta.spec.lstm.horizon

    def forget_epoch(self) -> None:
        """The state's leaves were refilled from outside: read the epoch again."""
        self._epoch_leaf = None

    def wraps(self, state: Dict) -> bool:
        """Whether the next byte's forward pass wraps the LSTM's window (its
        byte end then runs the backward pass, or leaves it to the caller)."""
        lst = state["stm"].get("lstm")
        return lst is not None and self.host_epoch(lst) == self.meta.spec.lstm.horizon - 1

    def take_epoch(self, src: "StepPlan", src_lst: Dict, lst: Dict) -> None:
        """For `lst`, a copy of the LSTM state `src_lst` that the plan `src`
        runs: take over src's host epoch, so that neither plan reads the
        device when the two run side by side. A leaf that src has not read
        stays, to be read once."""
        if src._epoch_leaf is not None and src_lst["epoch"] is src._epoch_leaf:
            self._epoch, self._epoch_leaf = src._epoch, lst["epoch"]

    def graph_pool(self):
        """The memory pool that every CUDA graph of this plan is captured
        into, and the stream they are captured on (made on first use)."""
        if self._pool is None:
            with torch.cuda.device(self.device):
                self._pool = torch.cuda.graph_pool_handle()
                self._capture_stream = torch.cuda.Stream(self.device)
        return self._pool, self._capture_stream

    def release_graphs(self) -> None:
        """Drop every compiled chunk of this plan, and with their CUDA graphs
        the memory pool they were captured into (its memory goes back to the
        device at the next `torch.cuda.empty_cache()`). The next capture
        takes a new pool."""
        self.fn_cache.clear()
        self._pool = None


def _as_index(t, device) -> torch.Tensor:
    """A byte index as a 0-d int64 tensor on `device`: a tensor as it is, a
    host integer filled into a new one (a fill, no copy from host memory)."""
    if torch.is_tensor(t):
        return t
    return torch.full((), int(t), dtype=I64, device=device)


@obs.in_part("contexts")
def _boundary(stm: Dict, t, plan: StepPlan) -> None:
    """Byte-boundary contexts (gmix_tpu.core.step._boundary up to the PPM
    prediction and the LSTM's forward pass, which follow in `_byte_inputs`);
    updates stm in place. `t`, the byte index, is a 0-d device tensor (or a
    host integer): the stream's first byte selects with it
    (core/contexts.py)."""
    # PPM count update with the completed byte, against the PRE-update
    # contexts, at every byte (the stream's first included)
    if plan.meta.spec.ppm is not None:
        _ppm_update(stm, stm["acc"], plan)
    boundary_contexts(stm, _as_index(t, plan.device), plan)


def _byte_inputs(state: Dict, data_buf: torch.Tensor, code_buf: torch.Tensor, t,
                 decode: bool, plan: StepPlan, analysis: bool = True,
                 sample_u: Optional[torch.Tensor] = None, inv_temp: Optional[torch.Tensor] = None,
                 col: Optional[torch.Tensor] = None):
    """The byte step up to the sub-steps: boundary contexts, the match
    pointer logic, the gathers of the per-byte working sets and the coder
    window. Updates `state["stm"]` in place and returns (fin, work, ix): the
    packed inputs of `fused_substeps`, the working sets they were packed
    from, and the row indices the byte end scatters back to. `sample_u` and
    `inv_temp` make it a sampling step (`_byte_step`). `t` is the byte index
    (a 0-d device tensor or a host integer), `col` the byte's column of
    `data_buf` when that is not `t` (a compiled chunk's window of the
    input). With an LSTM the forward pass advances the state's epoch leaf;
    the plan's host copy of it is the caller's to advance."""
    meta = plan.meta
    spec = meta.spec
    stm, ltm = state["stm"], state["ltm"]
    NM = len(spec.matches)

    # ---- byte boundary: contexts ----
    t = _as_index(t, plan.device)
    col = t if col is None else col
    _boundary(stm, t, plan)
    work: Dict = {"max_steps": ltm["mix_max_steps"]}

    # ---- with an LSTM: the PPM prediction from rows gathered on their own,
    # then the forward pass, which reads it and sets the lstm_ctx context ----
    if spec.lstm is not None:
        with obs.part("lstm"):
            if spec.ppm is not None:
                with obs.part("ppm"):
                    ppm_cv, ppm_ix = _ppm_index(stm["ctx"], plan)
                    _ppm_predict(stm, gather_rows(stm["ppm_tbl"], ppm_ix), ppm_cv, plan)
            work["lstm_regs"] = _lstm_forward(stm, ltm, plan.lstm, plan.lstm_ctx_slot)
            work["lstm_probs"] = stm["lstm"]["probs"]

    # ---- match byte-boundary pointer logic (match.cpp:38-58) ----
    if NM:
        with obs.part("contexts"):
            match_ix = match_pointers(stm, ltm, plan)

    fin, ix = _gathered_inputs(state, work, data_buf, code_buf, t, col, decode, plan, analysis, sample_u, inv_temp)
    if NM:
        ix["match_ix"] = match_ix
    return fin, work, ix


# the grouped gather's arenas in its order: (working set, index name, table)
_ARENAS = (("ind_blk", "blk_ix", lambda stm, ltm: ltm["ind"]["st"]),  # (S, M, 256) int16 bits
           ("rows_st", "rowix_st", lambda stm, ltm: ltm["mix_w"]),  # (S, Kst, WP)
           ("rows_pos", "posix", lambda stm, ltm: ltm["mix_pos"]),  # (S, Kp, 8 * WP)
           ("apm_rows", "apm_ix", lambda stm, ltm: ltm["apm"]),  # (S, NA, 8 * APM_BINS)
           ("ppm_rows", "ppm_ix", lambda stm, ltm: stm["ppm_tbl"]))  # (S, NO, PPM_ROW_W) int16 bits


@obs.in_part("inputs")
def _gathered_inputs(state: Dict, work: Dict, data_buf: torch.Tensor, code_buf: torch.Tensor, t: torch.Tensor,
                     col: torch.Tensor, decode: bool, plan: StepPlan, analysis: bool,
                     sample_u: Optional[torch.Tensor], inv_temp: Optional[torch.Tensor]):
    """The row indices, dense rows and packed registers of the byte
    (core/inputs.py: one kernel launch on a CUDA device), then the gathers
    of the per-byte working sets into `work`, every arena's rows in one
    launch: (fin, ix) of `_byte_inputs`."""
    meta = plan.meta
    spec = meta.spec
    stm, ltm, metrics = state["stm"], state["ltm"], state["metrics"]
    S, WP = plan.S, meta.mix_width_pad
    packed = byte_inputs(state, data_buf, code_buf, t, col, decode, plan, sample_u)

    # ---- gather the per-byte working sets (byte-stable gating contexts) ----
    arenas = [(name, table(stm, ltm), packed[ix]) for name, ix, table in _ARENAS if ix in packed]
    for (name, _, _), rows in zip(arenas, gather_rows_many([(tbl, idx) for _, tbl, idx in arenas])):
        work[name] = rows
    if spec.indirects:
        work["p_tbl"] = ltm["ind"]["p"]  # (S, 2M, 256)
    if "rows_pos" in work:
        work["rows_pos"] = work["rows_pos"].view(S, len(meta.mix_pos_ix), 8, WP)
    if spec.ppm is not None:
        if ppm_grouped(spec):
            # next-byte distribution from the new contexts' rows
            _ppm_predict(stm, work.pop("ppm_rows"), packed["ppm_cv"], plan)
            packed["ppm_regs"] = ppm_regs(stm)
        # the head's interval registers go through the sub-steps
        work["ppm_probs"], work["ppm_regs"] = stm["ppm_probs"], packed["ppm_regs"]
    for name in ("ind_rot", "rows_cd", "lm_tbl"):
        if name in packed:
            work[name] = packed[name]
    if "blocks_pd" in packed:
        work["blocks_pd"] = packed["blocks_pd"].view(S, len(meta.mix_pd_ix), 8, WP)
    if spec.matches:
        work["mt_pred"], work["mt_cnt"] = ltm["match_pred"], ltm["match_cnt"]

    fin = pack_inputs(meta, stm, metrics, work, packed, analysis, inv_temp)
    cd_oh = list(torch.split(packed["cd_oh"], [int(T) for T in meta.mix_cd_sizes], dim=1)) if "cd_oh" in packed else []
    ix = dict(wpos0=state["coder"]["wpos"], cd_oh=cd_oh)
    ix.update({name: packed[name] for _, name, _ in _ARENAS[:4] if name in packed})
    return fin, ix


@obs.in_part("byte_end")
def _byte_finish(state: Dict, data_buf: torch.Tensor, col: torch.Tensor, plan: StepPlan, fo: Dict, work: Dict,
                 ix: Dict, learn: bool, bptt: bool = True, wrap: bool = False):
    """The byte step after the sub-steps: registers back into the state, the
    byte-end scatters, the history append, the match-table write and the
    LSTM's byte end (`bptt`, `wrap`: see `_step`). Writes the byte to
    `data_buf` at column `col` (a 0-d device tensor) and returns the
    encoder's renorm bytes of this input byte (win, nw)."""
    meta = plan.meta
    spec = meta.spec
    stm, ltm, coder, metrics = state["stm"], state["ltm"], state["coder"], state["metrics"]
    S, s_ix = plan.S, plan.s_ix
    M, NM, NA = len(spec.indirects), len(spec.matches), len(spec.apm)
    WP = meta.mix_width_pad
    Kst, Kp = len(meta.mix_st_ix), len(meta.mix_pos_ix)
    Kcd, Kpd, Klm = len(meta.mix_cd_ix), len(meta.mix_pd_ix), len(meta.mix_lm_ix)
    dense0 = ltm.get("mix_dense")

    win_w, bitregs = unpack_outputs(meta, fo, stm, coder, metrics, work)
    cur_byte = stm["acc"]  # all 8 bits accumulated = the completed byte
    longest = bitregs[:, 3]

    # ---- the renorm bytes of this input byte (host assembles the stream) ----
    win_out = win_w.to(torch.uint8)
    nw_out = (coder["wpos"] - ix["wpos0"]).to(torch.uint8)

    # ---- final per-bit context values -> ctx (checkpoint consistency) ----
    stm["ctx"][:, plan.bitreg_ctx_cols] = bitregs

    if spec.ppm is not None:
        pr = work["ppm_regs"]
        stm.update(ppm_top=pr[:, 0], ppm_bot=pr[:, 1], ppm_mid=pr[:, 2])
    if spec.lstm is not None:
        lr_ = work["lstm_regs"]
        stm["lstm"].update(top=lr_[:, 0], bot=lr_[:, 1], mid=lr_[:, 2])

    # ---- byte end: scatter the working sets back (every arena in one
    # launch; the arenas are distinct tensors), history append, match pointer
    # write ----
    if learn:
        back = []  # (table, row indices, rows)
        if M:
            back.append((ltm["ind"]["st"], ix["blk_ix"], work["ind_blk"]))
            ltm["ind"]["p"] = work["p_tbl"]
        ltm["mix_max_steps"] = work["max_steps"]
        if Kst:
            back.append((ltm["mix_w"], ix["rowix_st"], work["rows_st"]))
        if Kp:
            back.append((ltm["mix_pos"], ix["posix"], work["rows_pos"].view(S, Kp, 8 * WP)))
        if NA:
            back.append((ltm["apm"], ix["apm_ix"], work["apm_rows"]))
        scatter_rows_many(back)
        if meta.mix_dense_total:
            # dense arena write-back: static slices + one-hot selects
            for i in range(Kcd):
                off, T = int(meta.mix_cd_offsets[i]), int(meta.mix_cd_sizes[i])
                cur = dense0[:, off : off + T]
                dense0[:, off : off + T] = torch.where(ix["cd_oh"][i][:, :, None], work["rows_cd"][:, i][:, None, :], cur)
            for i in range(Kpd):
                off = int(meta.mix_pd_offsets[i])
                dense0[:, off : off + 8] = work["blocks_pd"][:, i]
            for i in range(Klm):
                off, T = int(meta.mix_lm_offsets[i]), int(meta.mix_lm_sizes[i])
                dense0[:, off : off + T] = work["lm_tbl"][i]
        if NM:
            ltm["match_pred"], ltm["match_cnt"] = work["mt_pred"], work["mt_cnt"]
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
            old = ltm["match_tbl"][s_ix, ix["match_ix"]]
            ltm["match_tbl"][s_ix, ix["match_ix"]] = torch.where(append[:, None], newp[:, None], old)
        if spec.lstm is not None:
            _lstm_perceive(stm, ltm, cur_byte, plan.lstm, wrap, bptt)

    # the reconstructed byte (decode reconstructs; encode rewrites it)
    data_buf.index_copy_(1, col.reshape(1), cur_byte.to(data_buf.dtype)[:, None])
    return win_out, nw_out


def _leaf_refs(state: Dict, refs: Optional[List] = None) -> List[Tuple[Dict, str, torch.Tensor]]:
    """(dict, key, tensor) of every leaf of a state, in order."""
    refs = [] if refs is None else refs
    for k, v in state.items():
        if isinstance(v, dict):
            _leaf_refs(v, refs)
        else:
            refs.append((state, k, v))
    return refs


def _keep_storage(refs: List[Tuple[Dict, str, torch.Tensor]]) -> None:
    """Put every leaf that a step has rebound back into the tensor that held
    it before: the new value is copied into the old storage and the dict
    holds the old tensor again. A captured graph reads and writes the state
    at fixed addresses, so a step leaves each leaf where it found it (the
    arenas are written in place by the row movers and need no copy). A new
    value that shares storage with some leaf is copied aside first, so that
    no copy reads what another one has overwritten."""
    moved = [(d, k, old, d[k]) for d, k, old in refs if d[k] is not old]
    if not moved:
        return
    held = {old.untyped_storage().data_ptr() for _, _, old in refs}
    staged = []
    for d, k, old, new in moved:
        if new.shape != old.shape or new.dtype != old.dtype or new.device != old.device:
            raise RuntimeError(f"byte step: leaf {k!r} came back as {tuple(new.shape)} {new.dtype} on {new.device}, "
                               f"was {tuple(old.shape)} {old.dtype} on {old.device}")
        staged.append((d, k, old, new.clone() if new.untyped_storage().data_ptr() in held else new))
    for d, k, old, new in staged:
        old.copy_(new)
        d[k] = old


def _step(state: Dict, data_buf: torch.Tensor, code_buf: torch.Tensor, t: torch.Tensor, col: torch.Tensor,
          decode: bool, plan: StepPlan, learn: bool, analysis: bool, bptt: bool, wrap: bool,
          sample_u: Optional[torch.Tensor] = None, inv_temp: Optional[torch.Tensor] = None):
    """One byte step with every host choice made, on device tensors alone:
    what a graph of the compiled chunk captures, and what `_byte_step` runs
    op by op. `t` is the byte index and `col` its column of `data_buf`, both
    0-d int64 tensors on the state's device; `wrap` says that this byte's
    forward pass wraps the LSTM's window (its byte end then runs the backward
    pass when `bptt` is on). Every state leaf keeps its storage
    (`_keep_storage`)."""
    refs = _leaf_refs(state)
    fin, work, ix = _byte_inputs(state, data_buf, code_buf, t, decode, plan, analysis, sample_u, inv_temp, col)
    fo = fused_substeps(plan.meta, plan.fused, fin, learn, analysis, sample_u is not None)
    out = _byte_finish(state, data_buf, col, plan, fo, work, ix, learn, bptt, wrap)
    with obs.part("byte_end"):
        _keep_storage(refs)
    return out


def _byte_step(state: Dict, data_buf: torch.Tensor, code_buf: torch.Tensor, t,
               decode: bool, plan: StepPlan, learn: bool = True, analysis: bool = True, bptt: bool = True,
               sample_u: Optional[torch.Tensor] = None, inv_temp: Optional[torch.Tensor] = None):
    """One byte for all S streams, op by op: boundary work, 8 bit sub-steps,
    byte-end learn. Updates `state` and `data_buf[:, t]` in place, every
    leaf in its own storage, and returns the encoder's renorm bytes of this
    input byte: (win (S, 40) u8, nw (S,) u8). Decode reads the code stream
    from `code_buf` (S, cap) u8. `t` is a host integer or a 0-d int64 tensor
    on the state's device.

    With an LSTM and `bptt` (gmix_tpu's mode "cond") the byte that wraps the
    horizon window runs the backward pass at its end, before the output
    layer's SGD; without `bptt` (mode "defer") the caller runs `lstm_bptt`
    after that byte, which then reads the slot the SGD has just written.
    Which byte wraps, the plan knows on the host (`StepPlan.host_epoch`).

    A sampling step (learn off, encode) takes `sample_u` (8, S) float32
    uniforms and `inv_temp`, a one-element float32 tensor, both on the
    state's device: the byte's bits are drawn in the sub-steps and coded, and
    the drawn byte is written to `data_buf[:, t]`."""
    wrap = plan.wraps(state)
    t = _as_index(t, plan.device)
    out = _step(state, data_buf, code_buf, t, t, decode, plan, learn, analysis, bptt, wrap, sample_u, inv_temp)
    if plan.meta.spec.lstm is not None:
        plan.advance_epoch(state["stm"]["lstm"])
    return out


def lstm_bptt(state: Dict, plan: StepPlan) -> None:
    """The LSTM's backward pass and Adam step on the recorded window, for a
    caller that defers it to the end of a horizon-aligned segment; every leaf
    keeps its storage. All of it is the LSTM's part of the step."""
    with obs.part("lstm"):
        refs = _leaf_refs(state)
        _lstm_bptt(state["stm"]["lstm"], state["ltm"]["lstm"], plan.lstm)
        _keep_storage(refs)


# ---------------------------------------------------------------------------
# the compiled chunk: the byte step captured as CUDA graphs
# ---------------------------------------------------------------------------


class CapturedStep:
    """One CUDA graph of byte-step work of variant `variant` (`encode/byte`,
    `bptt`, ...), captured on its plan's device and stream into the plan's
    memory pool. Capturing records the work and runs none of it; `record`
    (obs.GraphRecord) holds the graph's layout, its hand-written launches,
    the capture's seconds and the replays so far."""

    def __init__(self, plan: StepPlan, body: Callable[[], None], variant: str):
        kernels.prepare(plan.device)
        pool, stream = plan.graph_pool()
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.device(plan.device), torch.cuda.graph(self.graph, pool=pool, stream=stream):
            with obs.capturing(variant, obs.CudaNodes(stream.cuda_stream)) as self.record:
                body()
        obs.captured(self.record, time.perf_counter() - t0)

    def replay(self) -> None:
        self.graph.replay()
        self.record.replays += 1


class _Compiled:
    """What the two compiled chunks share: the static tensors their graphs
    read and write, the graphs by variant, and the plan and state leaves the
    graphs were captured for (the first CUDA call's)."""

    def __init__(self, meta: Meta, chunk: int):
        if chunk <= 0:
            raise ValueError(f"a chunk of {chunk} bytes")
        self.meta = meta
        self.chunk = chunk
        self.horizon = meta.spec.lstm.horizon if meta.spec.lstm is not None else 0
        self.graphs: Dict = {}
        # the plan (weakly: the plan keeps this chunk in its cache) and the
        # state leaves that the graphs were captured for
        self._plan: Optional[weakref.ref] = None
        self._leaves: List[Tuple[Tuple[str, ...], torch.Tensor]] = []
        self.buf: Dict[str, torch.Tensor] = {}

    def _bind(self, state: Dict, plan: StepPlan, data_buf: torch.Tensor, t0: int) -> None:
        """Check the call and make the static tensors on its first CUDA call:
        the byte index `t`, the column `col` of the chunk's input window
        `data`, the encoder's `win` / `nw` per byte. At every call a state
        leaf that was replaced since the capture (a tensor the graphs do not
        know) is copied into the one they know, which takes its place."""
        S = plan.S
        if data_buf.dim() != 2 or data_buf.shape[0] != S or data_buf.device != plan.device:
            raise ValueError(f"data buffer {tuple(data_buf.shape)} on {data_buf.device}, expected ({S}, n) on {plan.device}")
        if t0 < 0 or t0 + self.chunk > data_buf.shape[1]:
            raise ValueError(f"bytes [{t0}, {t0 + self.chunk}) of a {data_buf.shape[1]}-byte buffer")
        if self._plan is None:
            self._plan = weakref.ref(plan)
            self._leaves = [(path, leaf) for path, leaf in _leaf_paths(state)]
            dev, c = plan.device, self.chunk
            self.buf = {
                "t": torch.zeros((), dtype=I64, device=dev),
                "col": torch.zeros((), dtype=I64, device=dev),
                "data": torch.zeros((S, c), dtype=data_buf.dtype, device=dev),
                "win": torch.zeros((c, S, CODER_WIN), dtype=torch.uint8, device=dev),
                "nw": torch.zeros((c, S), dtype=torch.uint8, device=dev),
                "sink": torch.zeros((S, 1), dtype=torch.uint8, device=dev),
            }
        elif plan is not self._plan():
            raise ValueError("a compiled chunk runs the plan (and the state) it was first called with")
        refilled = False
        for path, leaf in self._leaves:
            d = state
            for k in path[:-1]:
                d = d[k]
            cur = d[path[-1]]
            if cur is not leaf:
                if cur.shape != leaf.shape or cur.dtype != leaf.dtype:
                    raise ValueError(f"state leaf {'/'.join(path)}: {tuple(cur.shape)} {cur.dtype}, the graphs hold "
                                     f"{tuple(leaf.shape)} {leaf.dtype}")
                leaf.copy_(cur)
                d[path[-1]] = leaf
                refilled = True
                obs.refilled(leaf.numel() * leaf.element_size())
        if refilled:
            plan.forget_epoch()
        if data_buf.dtype != self.buf["data"].dtype:
            raise ValueError(f"data buffer of {data_buf.dtype}, the graphs hold {self.buf['data'].dtype}")

    def _graph(self, key, plan: StepPlan, body: Callable[[], Callable[[], None]]) -> CapturedStep:
        """The graph of variant `key`, captured from `body()` when first
        needed."""
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = CapturedStep(plan, body(), "/".join(key))
        return g

    def _replay(self, rec: Optional[obs.Replays], key, plan: StepPlan, body: Callable[[], Callable[[], None]]) -> None:
        """Replay the graph of variant `key` (`_graph`), in its span while
        something records (`rec`, obs.replays)."""
        g = self._graph(key, plan, body)
        if rec is None:
            g.replay()
        else:
            rec.run(g.record.variant, g.replay)

    def _window_in(self, data_buf: torch.Tensor, t0: int) -> None:
        b = self.buf
        b["data"].copy_(data_buf[:, t0 : t0 + self.chunk])
        b["t"].fill_(t0)
        b["col"].zero_()

    def _advance(self) -> None:
        """The graph's last ops: on to the next byte."""
        self.buf["t"].add_(1)
        self.buf["col"].add_(1)


def _leaf_paths(state: Dict, prefix: Tuple[str, ...] = ()):
    for k, v in state.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class ChunkFn(_Compiled):
    """`chunk` byte steps over [t0, t0 + chunk) of one predictor's state
    (gmix_tpu's `make_chunk_fn_raw`):

        win, nw = fn(state, plan, data_buf, code_buf, t0, decode)

    updates the state and `data_buf[:, t0:t0 + chunk]` in place and returns
    the encoder's renorm bytes of each byte, win (chunk, S, 40) u8 and nw
    (chunk, S) u8. `code_buf` (S, cap) u8 is the decoder's code stream
    (encode does not read it). With an LSTM whose horizon divides `chunk`,
    when learning, the backward pass is deferred to after every horizon-th
    byte of the chunk (t0 must then be horizon-aligned); otherwise it runs
    inside the byte that wraps the window.

    On CPU tensors the steps run op by op (`_eager`, which is the plain
    version of the graphs). On a CUDA device the call replays CUDA graphs of
    `_step`, one per variant the host picks: the direction, the byte that
    wraps the LSTM's window, and the deferred backward pass alone. A graph is
    captured when its variant is first needed, for the plan and the state
    leaves of the first call (nothing runs while it is captured: the first
    byte too is a replay). The byte index is a device tensor that each
    replay advances; the chunk's input bytes, the code stream and the
    encoder's (win, nw) go through static buffers, copied in and out once a
    call. A capture or a replay that fails raises."""

    def __init__(self, meta: Meta, chunk: int, learn: bool = True, analysis: bool = True):
        super().__init__(meta, chunk)
        self.learn = learn
        self.analysis = analysis
        self.defer = learn and self.horizon > 0 and chunk % self.horizon == 0

    def _eager(self, state: Dict, plan: StepPlan, data_buf: torch.Tensor, code_buf: torch.Tensor, t0: int,
               decode: bool = False):
        wins, nws = [], []
        for t in range(t0, t0 + self.chunk):
            win, nw = _byte_step(state, data_buf, code_buf, t, decode, plan, learn=self.learn,
                                 analysis=self.analysis, bptt=not self.defer)
            if self.defer and (t + 1 - t0) % self.horizon == 0:
                lstm_bptt(state, plan)
            wins.append(win)
            nws.append(nw)
        return torch.stack(wins), torch.stack(nws)

    def __call__(self, state: Dict, plan: StepPlan, data_buf: torch.Tensor, code_buf: torch.Tensor, t0: int,
                 decode: bool = False):
        if data_buf.device.type == "cpu":
            return self._eager(state, plan, data_buf, code_buf, t0, decode)
        return self._replayed(state, plan, data_buf, code_buf, t0, decode)

    def _replayed(self, state: Dict, plan: StepPlan, data_buf: torch.Tensor, code_buf: torch.Tensor, t0: int,
                  decode: bool = False):
        """The graphs' loop: bind, buffers in, one replay a byte (and the
        deferred backward pass), buffers out."""
        if self.defer and t0 % self.horizon:
            raise ValueError("t0 must be a multiple of the LSTM horizon when the horizon divides the chunk")
        rec = obs.replays()
        with obs.span("gmix.chunk.in"):
            self._bind(state, plan, data_buf, t0)
            if decode:
                self._code_in(code_buf)
            _fused.prepare(self.meta, plan.fused, self.learn, self.analysis, False, plan.S, plan.device)
            self._window_in(data_buf, t0)
        lst = state["stm"].get("lstm")
        for i in range(self.chunk):
            wrap = self.learn and plan.wraps(state)
            self._replay(rec, ("decode" if decode else "encode", "wrap" if wrap else "byte"), plan,
                         lambda: self._byte_body(state, plan, decode, wrap))
            if lst is not None:
                plan.advance_epoch(lst)
            if self.defer and (i + 1) % self.horizon == 0:
                self._replay(rec, ("bptt",), plan, lambda: lambda: lstm_bptt(state, plan))
        with obs.span("gmix.chunk.out"):
            data_buf[:, t0 : t0 + self.chunk].copy_(self.buf["data"])
            out = self.buf["win"].clone(), self.buf["nw"].clone()
        if rec is not None:
            rec.close()
        return out

    def _code_in(self, code_buf: torch.Tensor) -> None:
        """The decoder's code stream into the static code buffer: zeros past
        the call's bytes read as the reads past its end do (0). The buffer
        grows (to a power of two) for a longer stream, and the decode graphs,
        which hold its address, are captured again."""
        S, n = code_buf.shape
        code = self.buf.get("code")
        if code is None or code.shape[1] < n:
            cap = 1 << max(n - 1, 63).bit_length()
            self.buf["code"] = code = torch.zeros((S, cap), dtype=torch.uint8, device=code_buf.device)
            kept = {k: g for k, g in self.graphs.items() if k[0] != "decode"}
            if len(kept) < len(self.graphs):
                obs.recaptured()
            self.graphs = kept
        code[:, :n].copy_(code_buf)
        code[:, n:].zero_()

    def _byte_body(self, state: Dict, plan: StepPlan, decode: bool, wrap: bool) -> Callable[[], None]:
        b = self.buf

        def body() -> None:
            win, nw = _step(state, b["data"], b["code"] if decode else b["sink"], b["t"], b["col"], decode, plan,
                            self.learn, self.analysis, not self.defer, wrap)
            with obs.part("byte_end"):
                at = b["col"].reshape(1)
                b["win"].index_copy_(0, at, win[None])
                b["nw"].index_copy_(0, at, nw[None])
                self._advance()

        return body


class GenChunkFn(_Compiled):
    """`chunk` sampled bytes from byte offset t0 (gmix_tpu's
    `make_gen_chunk_fn_raw`):

        fn(state, plan, data_buf, t0, u, inv_temp)

    learn off, encode, analysis on as in gmix_tpu's generation chunk,
    whatever the predictor's flag; the code bytes go to a sink and are
    dropped. `u` is the chunk's (chunk * 8, S) float32 uniforms on the
    device: byte i draws its 8 bits from rows 8 i .. 8 i + 7; `inv_temp` a
    one-element float32 tensor. The sampled bytes land in
    `data_buf[:, t0:t0 + chunk]`. Nothing is read back from the device.

    On CPU tensors the steps run op by op (`_eager`); on a CUDA device one
    CUDA graph of the sampling step is replayed per byte (learn off, so no
    byte runs the backward pass), with the uniforms and the temperature
    copied into static buffers once a call."""

    def _eager(self, state: Dict, plan: StepPlan, data_buf: torch.Tensor, t0: int, u: torch.Tensor,
               inv_temp: torch.Tensor) -> None:
        S = data_buf.shape[0]
        u = u.view(self.chunk, 8, S)
        code_buf = torch.zeros((S, 8), dtype=torch.uint8, device=data_buf.device)  # sink
        for i in range(self.chunk):
            _byte_step(state, data_buf, code_buf, t0 + i, False, plan, learn=False, analysis=True, bptt=True,
                       sample_u=u[i], inv_temp=inv_temp)

    def __call__(self, state: Dict, plan: StepPlan, data_buf: torch.Tensor, t0: int, u: torch.Tensor,
                 inv_temp: torch.Tensor) -> None:
        if data_buf.device.type == "cpu":
            return self._eager(state, plan, data_buf, t0, u, inv_temp)
        self._replayed(state, plan, data_buf, t0, u, inv_temp)

    def _replayed(self, state: Dict, plan: StepPlan, data_buf: torch.Tensor, t0: int, u: torch.Tensor,
                  inv_temp: torch.Tensor) -> None:
        """The graph's loop: bind, buffers in, one replay a byte, bytes out."""
        rec = obs.replays()
        with obs.span("gmix.chunk.in"):
            self._bind(state, plan, data_buf, t0)
            b = self.buf
            if "u" not in b:
                b["u"] = torch.zeros((self.chunk, 8, plan.S), dtype=torch.float32, device=plan.device)
                b["inv_temp"] = torch.zeros((1,), dtype=torch.float32, device=plan.device)
            _fused.prepare(self.meta, plan.fused, False, True, True, plan.S, plan.device)
            b["u"].copy_(u.view(self.chunk, 8, plan.S))
            b["inv_temp"].copy_(inv_temp.reshape(1))
            self._window_in(data_buf, t0)
        lst = state["stm"].get("lstm")
        for _ in range(self.chunk):
            self._replay(rec, ("sample",), plan, lambda: self._sample_body(state, plan))
            if lst is not None:
                plan.advance_epoch(lst)
        with obs.span("gmix.chunk.out"):
            data_buf[:, t0 : t0 + self.chunk].copy_(b["data"])
        if rec is not None:
            rec.close()

    def _sample_body(self, state: Dict, plan: StepPlan) -> Callable[[], None]:
        b = self.buf

        def body() -> None:
            with obs.part("inputs"):
                u = b["u"].index_select(0, b["col"].reshape(1))[0]
            _step(state, b["data"], b["sink"], b["t"], b["col"], False, plan, False, True, True, False,
                  sample_u=u, inv_temp=b["inv_temp"])
            with obs.part("byte_end"):
                self._advance()

        return body


def make_chunk_fn(meta: Meta, chunk: int, learn: bool = True, analysis: bool = True) -> ChunkFn:
    """A compiled chunk of `chunk` byte steps (`ChunkFn`), not yet captured."""
    return ChunkFn(meta, chunk, learn, analysis)


def make_gen_chunk_fn(meta: Meta, chunk: int) -> GenChunkFn:
    """A compiled sampling chunk of `chunk` bytes (`GenChunkFn`), not yet
    captured."""
    return GenChunkFn(meta, chunk)


def get_chunk_fn(plan: StepPlan, chunk: int, learn: bool = True, analysis: bool = True) -> ChunkFn:
    """The plan's compiled chunk of this kind, made once (gmix_tpu caches one
    jitted program per spec and chunk; a graph is bound to the storage of
    one state, so the port caches per plan, i.e. per predictor or shard)."""
    key = ("chunk", chunk, learn, analysis)
    if key not in plan.fn_cache:
        plan.fn_cache[key] = make_chunk_fn(plan.meta, chunk, learn, analysis)
    return plan.fn_cache[key]


def get_gen_chunk_fn(plan: StepPlan, chunk: int) -> GenChunkFn:
    """The plan's compiled sampling chunk of `chunk` bytes, made once."""
    key = ("gen", chunk)
    if key not in plan.fn_cache:
        plan.fn_cache[key] = make_gen_chunk_fn(plan.meta, chunk)
    return plan.fn_cache[key]
