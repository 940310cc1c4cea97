"""The byte step's inputs up to the grouped gather: the arenas' row indices,
the indirect models' lane rotation, the dense mixer rows, and the packed
per-stream inputs of the sub-steps.

Port of the part of `gmix_tpu.core.step._byte_step` between the match
pointers and the fused kernel that is not a gather of arena rows. On a CUDA
device it is one launch of csrc/inputs.cu's `inputs_pack_kernel`, which
writes every output into tensors the wrapper allocates; on the CPU the plain
version below, in eager torch, which the kernel equals bit for bit. The
grouped gather (ops/rowmove.py) then reads the indices, and core/step.py
hands the rest to the sub-steps (core/fused.py `pack_inputs`).

The outputs by name (`out_layout`), each present where the spec has its
part:

- `blk_ix`, `rowix_st`, `posix`, `apm_ix`: int32 rows of `ind.st`, `mix_w`,
  `mix_pos` and `apm`, `(ctx[:, slot] & mask) + offset`, which the byte end
  scatters back to; `ppm_ix` and the PPM orders' context values `ppm_cv`
  where the PPM prediction's rows join the grouped gather (PPM without an
  LSTM: `ppm_grouped`);
- `ind_rot`: `((ctx >> 16) & 255) * ind_rotate`;
- `rows_cd` (S, Kcd, WP) and the one-hot masks `cd_oh` (S, sum of T) of the
  ctx-dense tables (`core/fused.py` `_onehot_rows`: XLA's flush of a
  denormal in a one-hot sum), `blocks_pd` (S, 8 Kpd, WP) and `lm_tbl`
  (S, sum of T, WP), copies out of `mix_dense`;
- `sc`, `coder`, `win_r` (the decoder's code window; zeros in encode),
  `ppm_regs` where the PPM prediction came before (with an LSTM), and in a
  sampling step `sample_u` (S, 8): the fused kernel's packed inputs in
  `io_layout`'s shapes.

The byte index `t` and the byte's column `col` of `data_buf` are 0-d int64
tensors on the state's device, so that no host reads the device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import kernels
from .fused import CODER_WIN, WIN_PAD, _onehot_rows
from .meta import Meta
from .ppm import _ppm_index

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64
U8 = torch.uint8

# csrc/inputs.cu: kIndex, kDense (a table's entries per index and per
# ctx-dense table)
PER_INDEX, PER_DENSE = 3, 4


def ppm_grouped(spec) -> bool:
    """Whether the PPM prediction's rows of `ppm_tbl` join the grouped
    gather (PPM without an LSTM); with an LSTM they are gathered on their
    own before its forward pass (core/step.py)."""
    return spec.ppm is not None and spec.lstm is None


def _sizes(meta: Meta) -> Dict[str, int]:
    """The class sizes the kernel's table and outputs depend on."""
    spec = meta.spec
    grouped = ppm_grouped(spec)
    return dict(M=len(spec.indirects), Kst=len(meta.mix_st_ix), Kp=len(meta.mix_pos_ix), NA=len(spec.apm),
                NO=len(meta.ppm_slots) if grouped else 0, Kcd=len(meta.mix_cd_ix),
                Tcd=int(np.sum(meta.mix_cd_sizes)), NPD=8 * len(meta.mix_pd_ix),
                NLM=int(np.sum(meta.mix_lm_sizes)), regs=int(spec.ppm is not None and not grouped))


def out_layout(meta: Meta, sample: bool = False) -> List[Tuple[str, tuple, torch.dtype]]:
    """(name, shape tail after S, dtype) of each output of a byte step of
    `meta`, or with `sample` of a sampling step."""
    d, WP = _sizes(meta), meta.mix_width_pad
    out = []
    for name, n, dtype in (("blk_ix", d["M"], I32), ("ind_rot", d["M"], I64), ("rowix_st", d["Kst"], I32),
                           ("posix", d["Kp"], I32), ("apm_ix", d["NA"], I32), ("ppm_ix", d["NO"], I32),
                           ("ppm_cv", d["NO"], I64)):
        if n:
            out.append((name, (n,), dtype))
    if d["Kcd"]:
        out += [("rows_cd", (d["Kcd"], WP), F32), ("cd_oh", (d["Tcd"],), torch.bool)]
    for name, n in (("blocks_pd", d["NPD"]), ("lm_tbl", d["NLM"])):
        if n:
            out.append((name, (n, WP), F32))
    out += [("sc", (8,), I64), ("coder", (8,), I64), ("win_r", (WIN_PAD,), I64)]
    if d["regs"]:
        out.append(("ppm_regs", (4,), I32))
    if sample:
        out.append(("sample_u", (8,), F32))
    return out


def inputs_table(meta: Meta) -> np.ndarray:
    """The kernel's constants as one int64 vector, in csrc/inputs.cu's
    order: (ctx slot, mask, row offset) of every index, class by class
    (indirect blocks, stable mixer rows, position mixer rows, APM rows, and
    the PPM orders where `ppm_grouped`); each indirect model's rotation flag;
    per ctx-dense table (ctx slot, rows T, first row in `mix_dense`, first
    lane of its mask in `cd_oh`); then the `mix_dense` row of each row of
    `blocks_pd` and of `lm_tbl`, in order. Refuses a ctx-dense table whose
    rows are not a power of two (the select masks the context with T - 1)."""
    spec = meta.spec
    classes = [(meta.ind_ctx_slots, meta.ind_blk_masks, meta.ind_blk_offsets),
               (meta.mix_st_slots, meta.mix_st_masks, meta.mix_st_offsets),
               (meta.mix_pos_slots, meta.mix_pos_masks, meta.mix_pos_offsets),
               (meta.apm_ctx_slots, meta.apm_masks, meta.apm_offsets)]
    if ppm_grouped(spec):
        classes.append((meta.ppm_slots, meta.ppm_masks, meta.ppm_row_offsets))
    sizes = np.asarray(meta.mix_cd_sizes, np.int64).reshape(-1)
    if np.any(sizes < 1) or np.any(sizes & (sizes - 1)):
        raise ValueError(f"a ctx-dense table of {sizes.tolist()} rows: the kernel takes powers of two")
    dense = np.stack([np.asarray(meta.mix_cd_slots, np.int64).reshape(-1), sizes,
                      np.asarray(meta.mix_cd_offsets, np.int64).reshape(-1), np.cumsum(sizes) - sizes], axis=1)
    copies = [int(o) + np.arange(8) for o in np.asarray(meta.mix_pd_offsets).reshape(-1)]
    copies += [int(o) + np.arange(int(T)) for o, T in zip(np.asarray(meta.mix_lm_offsets).reshape(-1),
                                                          np.asarray(meta.mix_lm_sizes).reshape(-1))]
    parts = [np.stack([np.asarray(a, np.int64).reshape(-1) for a in c], axis=1) for c in classes]
    parts += [np.asarray(meta.ind_rotate, np.int64).reshape(-1), dense, *copies]
    return np.concatenate([np.asarray(p, np.int64).reshape(-1) for p in parts])


def ppm_regs(stm: Dict) -> torch.Tensor:
    """The PPM head's interval registers as the sub-steps take them:
    (top, bot, mid, 0) (S, 4) int32."""
    return torch.stack([stm["ppm_top"], stm["ppm_bot"], stm["ppm_mid"], torch.zeros_like(stm["ppm_top"])], dim=1)


def inputs_plain(state: Dict, data_buf: torch.Tensor, code_buf: torch.Tensor, t: torch.Tensor, col: torch.Tensor,
                 decode: bool, plan, sample_u: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The outputs (`out_layout`) op by op, from the state after the match
    pointers, the byte's column `col` of `data_buf` (S, n) u8 and, in
    decode, the code stream `code_buf` (S, cap) u8. `sample_u` (8, S) makes
    it a sampling step's."""
    meta = plan.meta
    spec = meta.spec
    stm, ltm, coder = state["stm"], state["ltm"], state["coder"]
    S = plan.S
    ctx = stm["ctx"]
    out: Dict[str, torch.Tensor] = {}
    if spec.indirects:
        ind_ctx_vals = ctx[:, plan.ind_ctx_slots]  # (S, M)
        out["blk_ix"] = ((ind_ctx_vals & plan.ind_blk_masks) + plan.ind_blk_offsets).to(I32)
        # hash-derived lane rotation (gmix_tpu step.py:709-716)
        out["ind_rot"] = ((ind_ctx_vals >> 16) & 255) * plan.ind_rotate
    if len(meta.mix_st_ix):
        out["rowix_st"] = ((ctx[:, plan.mix_st_slots] & plan.mix_st_masks) + plan.mix_st_offsets).to(I32)
    if len(meta.mix_pos_ix):
        out["posix"] = ((ctx[:, plan.mix_pos_slots] & plan.mix_pos_masks) + plan.mix_pos_offsets).to(I32)
    if spec.apm:
        out["apm_ix"] = ((ctx[:, plan.apm_ctx_slots] & plan.apm_masks) + plan.apm_offsets).to(I32)
    if ppm_grouped(spec):
        out["ppm_cv"], out["ppm_ix"] = _ppm_index(ctx, plan)
    dense0 = ltm.get("mix_dense")
    if len(meta.mix_cd_ix):
        rows_cd, cd_oh = [], []
        for i in range(len(meta.mix_cd_ix)):
            off, T = int(meta.mix_cd_offsets[i]), int(meta.mix_cd_sizes[i])
            val = ctx[:, int(meta.mix_cd_slots[i])] & (T - 1)
            oh = plan.cd_aranges[i] == val[:, None]  # (S, T)
            cd_oh.append(oh)
            rows_cd.append(_onehot_rows(oh, dense0[:, off : off + T]))
        out["rows_cd"] = torch.stack(rows_cd, dim=1)
        out["cd_oh"] = torch.cat(cd_oh, dim=1)
    if len(meta.mix_pd_ix):
        out["blocks_pd"] = torch.cat([dense0[:, int(o) : int(o) + 8] for o in meta.mix_pd_offsets], dim=1)
    if len(meta.mix_lm_ix):
        out["lm_tbl"] = torch.cat([dense0[:, int(o) : int(o) + int(T)]
                                   for o, T in zip(meta.mix_lm_offsets, meta.mix_lm_sizes)], dim=1)

    # ---- coder byte window: the decoder's input bytes, read once per byte ----
    if decode:
        cap_total = code_buf.shape[1]
        look = coder["rpos"][:, None] + plan.win_lanes[None, :]
        win_r = torch.where(
            look < cap_total, code_buf[plan.s_ix, torch.clamp(look, max=cap_total - 1)].to(I64), 0
        )
    else:
        win_r = torch.zeros((S, CODER_WIN), dtype=I64, device=plan.device)

    data_byte = data_buf.index_select(1, col.reshape(1))[:, 0].to(I64)
    zero = torch.zeros((S,), dtype=I64, device=data_byte.device)
    sample = sample_u is not None
    out["sc"] = torch.stack([data_byte, stm["last_byte"], stm["recent"][:, 1], zero + int(decode), zero + (t > 0),
                             zero + int(sample), zero, zero], dim=1)
    out["coder"] = torch.stack([coder["x1"], coder["x2"], coder["x"], coder["wpos"], coder["rpos"],
                                stm["acc"], stm["bits_seen"], stm["new_bit"]], dim=1)
    out["win_r"] = torch.nn.functional.pad(win_r, (0, WIN_PAD - CODER_WIN))
    if spec.ppm is not None and not ppm_grouped(spec):
        out["ppm_regs"] = ppm_regs(stm)
    if sample:
        out["sample_u"] = sample_u.t().contiguous()
    return out


def inputs_kernel(state: Dict, data_buf: torch.Tensor, code_buf: torch.Tensor, t: torch.Tensor, col: torch.Tensor,
                  decode: bool, plan, sample_u: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """`inputs_plain` as one launch of csrc/inputs.cu's kernel, on CUDA
    tensors: the outputs in tensors allocated here."""
    meta = plan.meta
    stm, ltm, coder = state["stm"], state["ltm"], state["coder"]
    S, WP = plan.S, meta.mix_width_pad
    d = _sizes(meta)
    dev = kernels.cuda_device("inputs_pack", "ctx", stm["ctx"])
    out = {name: torch.empty((S,) + tail, dtype=dtype, device=dev)
           for name, tail, dtype in out_layout(meta, sample_u is not None)}
    R = stm["recent"].shape[1]
    tensors = {"t": (t, (), I64), "col": (col, (), I64), "ctx": (stm["ctx"], (S, meta.n_ctx), I64),
               "data": (data_buf, (S, data_buf.shape[1]), U8), "recent": (stm["recent"], (S, R), I64),
               "consts": (plan.inputs_consts, tuple(plan.inputs_consts.shape), I64)}
    for name in ("last_byte", "acc", "bits_seen", "new_bit"):
        tensors[name] = (stm[name], (S,), I64)
    for name in ("x1", "x2", "x", "wpos", "rpos"):
        tensors[name] = (coder[name], (S,), I64)
    if d["regs"]:
        for name in ("ppm_top", "ppm_bot", "ppm_mid"):
            tensors[name] = (stm[name], (S,), I32)
    if d["Kcd"] or d["NPD"] or d["NLM"]:
        tensors["dense"] = (ltm["mix_dense"], (S, meta.mix_dense_total, WP), F32)
    if decode:
        tensors["code"] = (code_buf, (S, code_buf.shape[1]), U8)
    if sample_u is not None:
        tensors["sample_u"] = (sample_u, (8, S), F32)
    for name, v in out.items():
        tensors["sample_out" if name == "sample_u" else name] = (v, tuple(v.shape), v.dtype)
    kernels.launch("inputs_pack", dict(S=S, n_ctx=meta.n_ctx, D=meta.mix_dense_total, WP=WP, R=R,
                                       n_data=data_buf.shape[1], cap=code_buf.shape[1], decode=int(decode),
                                       sample=int(sample_u is not None), **d),
                   tensors, aligned=("dense", "rows_cd", "blocks_pd", "lm_tbl"))
    return out


def byte_inputs(state: Dict, data_buf: torch.Tensor, code_buf: torch.Tensor, t: torch.Tensor, col: torch.Tensor,
                decode: bool, plan, sample_u: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The outputs (`out_layout`): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if state["stm"]["ctx"].device.type == "cpu":
        return inputs_plain(state, data_buf, code_buf, t, col, decode, plan, sample_u)
    return inputs_kernel(state, data_buf, code_buf, t, col, decode, plan, sample_u)
