"""The LSTM byte model: the per-byte forward pass, the per-byte SGD of its
output layer, and the horizon-window backward pass with Adam.

Port of `gmix_tpu.core.step._lstm_forward`, `_lstm_perceive` and
`_lstm_bptt`, which are plain array code in gmix_tpu (no kernel), in eager
torch. One CIFG layer of C cells reads [aux input | hidden | 1]; its output
layer has one weight set per epoch of the horizon window, trained at every
byte; the gate weights are trained once a window from the recorded history.
The bit head that reads `probs` is inside `core/fused.py:fused_substeps`.

What the port fixes so that an archive is the same bits on the CPU and on a
CUDA device (the standing rules of core/step.py hold: one torch op per float
op, no division by a host scalar):

- gmix_tpu leaves seven inexact reductions to its backend (the gate
  products over the input row, the mean square over the cells, the logits'
  sum over the hidden lanes, the softmax's sum, and in the backward pass the
  output error's product, the layer norm's projection and the hidden
  gradient). Here each is a fixed binary tree of elementwise adds over the
  axis zero-padded to a power of two (`_tree_sum_dim`), the same on every
  device. So these values agree with gmix_tpu's only within a tolerance
  (tests/test_torch_lstm.py states it); everything without a reduction (the
  output SGD, Adam given the gradients) agrees bit for bit.
- gmix_tpu's `rsqrt` is a backend approximation; here it is 1 / sqrt(x),
  both correctly rounded (`ops/sigmoid.py:sqrt_det`: torch's float32 square
  root is not the same on the CPU and on a CUDA device).
- The outer products of the gradient accumulation have no reduction. The
  one-hot product of the symbol gradient is a column add (adding the zero
  products of the other columns changes no bit).

The state is updated in place. The epoch is read from the state's 0-d
`epoch` leaf on the device: every per-epoch slot is read with `index_select`
and written with `index_copy_` at it, so that one captured CUDA graph serves
every byte of the window (core/step.py). The caller says on the host only
whether a byte wraps the window (`wrap`), which it tracks without reading
the device. `update_steps` stays on the device.

The per-byte work has two forms that give the same bits. On the CPU the
plain versions run op by op (`lstm_forward_plain`, `lstm_perceive_plain`).
On a CUDA device each is one launch of csrc/lstm.cu's kernels
(`lstm_forward_kernel`, `lstm_perceive_kernel`), which write the state's
leaves in place and follow the trees above (the forward kernel advances
the epoch leaf itself); at the window's wrap the symbol's record (and the
backward pass) stays op by op before the SGD kernel. The backward pass has
no kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..ops import kernels
from ..ops.sigmoid import exp_det, logistic, powc_det, rdiv, sqrt_det, tanh_det

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64


def _tree_sum_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over axis `dim` with the fixed binary tree of `fused._tree_sum`
    (halves added elementwise, the axis zero-padded to a power of two)."""
    n = x.shape[dim]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        shape = list(x.shape)
        shape[dim] = p - n
        x = torch.cat([x, torch.zeros(shape, dtype=x.dtype, device=x.device)], dim=dim)
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    return x.select(dim, 0)


class LstmPlan:
    """The LSTM's constants for one (spec, stream count, device)."""

    def __init__(self, ls, num_streams: int, device):
        def f(v):
            return torch.tensor(float(np.float32(v)), dtype=F32, device=device)

        self.ls = ls
        self.S = num_streams
        self.ones_col = torch.ones((num_streams, 1), dtype=F32, device=device)
        self.lane_out = torch.arange(ls.output_size, device=device)[None, :]
        # the forward kernel's count of finished clusters (csrc/lstm.cu)
        self.done = torch.zeros((), dtype=I32, device=device)
        self.n_cells = f(ls.num_cells)
        self.one = f(1.0)
        # scalars rounded to float32 as gmix_tpu rounds them
        self.lr = float(np.float32(ls.lr))
        self.alpha0 = float(np.float32(ls.lr * 0.1))
        b1, b2 = np.float32(ls.adam_beta1), np.float32(ls.adam_beta2)
        self.b1, self.b2 = float(b1), float(b2)
        self.one_m_b1, self.one_m_b2 = float(np.float32(1.0) - b1), float(np.float32(1.0) - b2)
        self.eps = float(np.float32(ls.adam_eps))


def _epoch_index(lst: Dict) -> torch.Tensor:
    """The state's epoch as a one-element int64 index on its device."""
    return lst["epoch"].to(torch.int64).reshape(1)


def lstm_forward_plain(stm: Dict, ltm: Dict, lp: LstmPlan, lstm_ctx_slot: int) -> torch.Tensor:
    """One byte of the forward pass at the state's epoch (lstm.cpp:91-122,
    lstm-layer.cpp:198-241), op by op: records the epoch's activations, sets
    `probs`, the head's interval registers and the `lstm_ctx` context (the
    most probable next byte), and advances the epoch leaf. Returns the
    head's registers (S, 4) int32: top, bottom, mid, 0."""
    ls = lp.ls
    lw, lst = ltm["lstm"], stm["lstm"]
    C, Hz = ls.num_cells, ls.horizon
    S = lp.S
    e = _epoch_index(lst)

    aux = stm["ppm_probs"]  # (S, 256): PPM byte distribution (uniform when PPM is off)
    li = torch.cat([aux, lst["hidden"][:, :C], lp.ones_col], dim=1)  # (S, LI)
    sym = stm["last_byte"]

    # symbol embedding column + dense input transform (lstm-layer.cpp:222-241)
    w_sym = lw["w_sym"].gather(3, sym[:, None, None, None].expand(S, 3, C, 1))[..., 0]  # (S, 3, C)
    f = w_sym + _tree_sum_dim(lw["w_in"] * li[:, None, None, :], 3)
    ivar = lp.one / sqrt_det(_tree_sum_dim(f * f, 2) / lp.n_cells + 1e-5)  # (S, 3)
    norm = f * ivar[:, :, None]
    pre = norm * lw["gamma"] + lw["beta"]
    gates = logistic(pre[:, 0::2])
    forget, outg = gates[:, 0], gates[:, 1]
    innode = tanh_det(pre[:, 1])
    in_gate = 1.0 - forget  # CIFG (lstm-layer.cpp:212)
    last_state = lst["cell"]
    cell = last_state * forget + innode * in_gate
    tanh_c = tanh_det(cell)
    hidden = torch.cat([outg * tanh_c, lp.ones_col], dim=1)

    # the epoch's output layer (lstm.cpp:91-122); out_w is (S, Hz, C+1, OUT)
    logits = _tree_sum_dim(lw["out_w"].index_select(1, e)[:, 0] * hidden[:, :, None], 1)
    maxv = torch.clamp(logits.amax(dim=1, keepdim=True), min=0.0)  # lstm.cpp:105-113
    probs = exp_det(logits - maxv)
    probs = probs / _tree_sum_dim(probs, 1)[:, None]

    lst["layer_input"].index_copy_(1, e, li[:, None])
    lst["norm"].index_copy_(2, e, norm[:, :, None])
    lst["ivar"].index_copy_(2, e, ivar[:, :, None])
    lst["gate_state"].index_copy_(2, e, torch.stack([forget, innode, outg], dim=1)[:, :, None])
    lst["tanh_state"].index_copy_(1, e, tanh_c[:, None])
    lst["in_gate"].index_copy_(1, e, in_gate[:, None])
    lst["last_state"].index_copy_(1, e, last_state[:, None])
    lst["outputs"].index_copy_(1, e, probs[:, None])
    lst.update(
        cell=cell,
        hidden=hidden,
        probs=probs,
        top=torch.full((S,), 255, dtype=I32, device=probs.device),
        bot=torch.zeros((S,), dtype=I32, device=probs.device),
        epoch=(lst["epoch"] + 1) % Hz,
    )
    stm["ctx"][:, lstm_ctx_slot] = torch.argmax(probs, dim=1)
    return torch.stack([lst["top"], lst["bot"], lst["mid"], torch.zeros_like(lst["top"])], dim=1)


def _adam(g, m, v, w, alpha, c1, c2, lp: LstmPlan):
    """One Adam step (lstm-layer.cpp:12-34) given the gradient; `c1`, `c2`
    are the bias corrections 1 - beta^t. Returns (m, v, w)."""
    m = m * lp.b1 + g * lp.one_m_b1
    v = v * lp.b2 + g * lp.one_m_b2 * g
    mh = m / c1
    vh = v / c2
    return m, v, w - alpha * mh / sqrt_det(vh + lp.eps)


def _adam_all(lst: Dict, lw: Dict, grads: Dict[str, torch.Tensor], lp: LstmPlan) -> None:
    """Adam on the four gate parameter sets from the window's gradients
    (keys: sym, in, gamma, beta); advances `update_steps`."""
    ls = lp.ls
    t_new = torch.clamp(lst["update_steps"] + 1, max=ls.update_limit)
    tf = t_new.to(F32)
    alpha = rdiv(lp.alpha0, sqrt_det(tf * 5e-5 + 1.0))
    c1 = 1.0 - powc_det(ls.adam_beta1, tf)
    c2 = 1.0 - powc_det(ls.adam_beta2, tf)
    for g_key, w_key, m_key, v_key in (
        ("sym", "w_sym", "sym_m", "sym_v"),
        ("in", "w_in", "in_m", "in_v"),
        ("gamma", "gamma", "gamma_m", "gamma_v"),
        ("beta", "beta", "beta_m", "beta_v"),
    ):
        lw[m_key], lw[v_key], lw[w_key] = _adam(grads[g_key], lw[m_key], lw[v_key], lw[w_key], alpha, c1, c2, lp)
    lst["update_steps"] = t_new


def _lstm_grads(lst: Dict, lw: Dict, lp: LstmPlan) -> Dict[str, torch.Tensor]:
    """The backward pass over the recorded window, epochs Hz-1 down to 0
    (LstmLayer::BackwardPass, lstm-layer.cpp:252-354). Returns the gradients
    of w_sym, w_in, gamma and beta; leaves the carried errors in `lst`."""
    ls = lp.ls
    C, Hz, OUT = ls.num_cells, ls.horizon, ls.output_size
    LI = ls.input_size + C + 1
    S = lp.S
    dev = lst["cell"].device
    clip = float(ls.grad_clip)
    in_hist = lst["in_hist"].to(torch.int64)
    gamma = lw["gamma"]
    # hidden block of the weight rows (transpose_[i][j] = weights[j][OUT+IN+i],
    # lstm-layer.cpp:311,330-338)
    w_hid = lw["w_in"][:, :, :, ls.input_size : ls.input_size + C]  # (S, 3, C, C)

    # every epoch's error through its output layer: (S, Hz, C)
    out_err = lst["outputs"] - (lp.lane_out[None] == in_hist[:, :, None]).to(F32)
    he_all = _tree_sum_dim(out_err[:, :, None, :] * lw["out_w"][:, :, :C, :], 3)

    stored, state_err = lst["stored_err"], lst["state_err"]
    upd_sym = torch.zeros((S, 3, C, OUT), dtype=F32, device=dev)
    upd_in = torch.zeros((S, 3, C, LI), dtype=F32, device=dev)
    upd_g = torch.zeros((S, 3, C), dtype=F32, device=dev)
    upd_b = torch.zeros((S, 3, C), dtype=F32, device=dev)
    for epoch in range(Hz - 1, -1, -1):
        he = he_all[:, epoch]
        if epoch == Hz - 1:
            stored = he
            state_err = torch.zeros_like(state_err)
        else:
            stored = stored + he

        fg = lst["gate_state"][:, 0, epoch]
        inn = lst["gate_state"][:, 1, epoch]
        og = lst["gate_state"][:, 2, epoch]
        ts = lst["tanh_state"][:, epoch]
        ig = lst["in_gate"][:, epoch]
        out_err_g = ts * stored * og * (1.0 - og)
        state_err = state_err + stored * og * (1.0 - ts * ts)
        in_err = state_err * ig * (1.0 - inn * inn)
        fg_err = (lst["last_state"][:, epoch] - inn) * state_err * fg * ig

        errs = torch.stack([fg_err, in_err, out_err_g], dim=1)  # (S, 3, C)
        norm = lst["norm"][:, :, epoch]  # (S, 3, C)
        ivar = lst["ivar"][:, :, epoch]  # (S, 3)
        upd_g = upd_g + errs * norm
        upd_b = upd_b + errs
        err2 = errs * gamma * ivar[:, :, None]
        err2 = err2 - (_tree_sum_dim(err2 * norm, 2)[:, :, None] / lp.n_cells) * norm

        if epoch > 0:
            state_err = state_err * fg
            hid_grad = _tree_sum_dim((err2[:, :, :, None] * w_hid).reshape(S, 3 * C, C), 1)
            stored = torch.zeros_like(stored) + hid_grad
            in_sym = in_hist[:, epoch - 1]
        else:
            in_sym = lst["old_input"].to(torch.int64)

        # gradient accumulation: d w[i, sym] += err_i ; d w[i, OUT+j] += err_i * input_j
        upd_in = upd_in + err2[:, :, :, None] * lst["layer_input"][:, epoch][:, None, None, :]
        upd_sym.scatter_add_(3, in_sym[:, None, None, None].expand(S, 3, C, 1), err2[:, :, :, None])

        state_err = torch.clamp(state_err, -clip, clip)
        stored = torch.clamp(stored, -clip, clip)

    lst.update(stored_err=stored, state_err=state_err)
    return {"sym": upd_sym, "in": upd_in, "gamma": upd_g, "beta": upd_b}


@obs.in_part("lstm")
def _lstm_bptt(lst: Dict, lw: Dict, lp: LstmPlan) -> None:
    """Horizon-window backward pass + Adam: reads the recorded forward
    history and the Hz output layers, updates the gate weights."""
    _adam_all(lst, lw, _lstm_grads(lst, lw, lp), lp)


def _last_epoch(lst: Dict, lp: LstmPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the epoch leaf's index, the epoch before it) after a forward pass."""
    e_cur = _epoch_index(lst)
    return e_cur, (e_cur + (lp.ls.horizon - 1)) % lp.ls.horizon


def _record_symbol(lst: Dict, inp: torch.Tensor, last_e: torch.Tensor, wrap: bool) -> None:
    """The observed symbol into `in_hist` at the last epoch `last_e`; at the
    window's wrap first the symbol that preceded epoch 0 of the next window
    into `old_input` (read by the backward pass)."""
    if wrap:
        lst["old_input"] = lst["in_hist"].index_select(1, last_e)[:, 0]
    lst["in_hist"].index_copy_(1, last_e, inp.to(I32)[:, None])


def lstm_perceive_plain(stm: Dict, ltm: Dict, inp: torch.Tensor, lp: LstmPlan, wrap: bool, bptt: bool) -> None:
    """Lstm::Perceive (lstm.cpp:52-89) at the byte end, after this byte's
    forward pass has advanced the epoch leaf, op by op: record the observed
    symbol, run the backward pass when the window has wrapped (`wrap`: the
    epoch leaf is now 0; with `bptt` off the caller runs it itself after the
    byte), then the per-byte SGD of the output layer, which copies the last
    epoch's weights into the current slot and applies the step."""
    lst, lw = stm["lstm"], ltm["lstm"]
    e_cur, last_e = _last_epoch(lst, lp)
    _record_symbol(lst, inp, last_e, wrap)

    if bptt and wrap:
        _lstm_bptt(lst, lw, lp)

    err = lst["outputs"].index_select(1, last_e)[:, 0] - (lp.lane_out == inp[:, None]).to(F32)
    out_w = lw["out_w"]
    new_w = out_w.index_select(1, last_e)[:, 0] - lst["hidden"][:, :, None] * lp.lr * err[:, None, :]
    out_w.index_copy_(1, e_cur, new_w[:, None])


# ---------------------------------------------------------------------------
# the two kernels (csrc/lstm.cu): the same functions on CUDA tensors
# ---------------------------------------------------------------------------

# csrc/lstm.cu: kMaxInput (the layer input), kMaxHidden (C + 1), kMaxOut,
# kMaxDynamicSmem (a forward block's rows of w_in and columns of out_w),
# kMaxCluster
MAX_INPUT, MAX_HIDDEN, MAX_OUT, MAX_DYNAMIC_SMEM, MAX_CLUSTER = 512, 64, 256, 204800, 8


def forward_cluster(S: int, ls, sm_count: int) -> int:
    """The blocks a stream of the forward kernel: the most (a power of two,
    at most MAX_CLUSTER) whose S clusters still fit the card's `sm_count`
    SMs at once, and at least as many as its share of w_in and out_w needs
    to fit shared memory."""
    k = 1
    while k < MAX_CLUSTER and (S * 2 * k <= sm_count or forward_smem(ls, k) > MAX_DYNAMIC_SMEM):
        k *= 2
    return k


def forward_smem(ls, cluster: int) -> int:
    """csrc/lstm.cu `forward_smem`: a forward block's dynamic shared memory
    in bytes, its rows of w_in and its columns of the epoch's out_w."""
    C, LI, OUT = ls.num_cells, ls.input_size + ls.num_cells + 1, ls.output_size
    rows = (-(-3 * C // cluster) * LI + 8 + 3) // 4 * 4
    return 4 * (rows + (C + 1) * 4 * -(-(OUT // 4) // cluster))


def _check_shapes(what: str, ls) -> None:
    C, LI, OUT = ls.num_cells, ls.input_size + ls.num_cells + 1, ls.output_size
    if C + 1 > MAX_HIDDEN or LI > MAX_INPUT or OUT > MAX_OUT or OUT % 4:
        raise ValueError(f"{what}: the kernel takes up to {MAX_HIDDEN - 1} cells, a layer input of up to {MAX_INPUT} "
                         f"and up to {MAX_OUT} outputs, a multiple of 4; got {C}, {LI} and {OUT}")


def lstm_forward_kernel(stm: Dict, ltm: Dict, lp: LstmPlan, lstm_ctx_slot: int,
                        cluster: Optional[int] = None) -> torch.Tensor:
    """`lstm_forward_plain` as one launch of csrc/lstm.cu's forward kernel,
    on CUDA tensors: the leaves are written in place, the epoch leaf
    advanced by the launch itself. `cluster`: the blocks a stream
    (`forward_cluster` by default). Returns the head's registers."""
    ls = lp.ls
    _check_shapes("lstm_forward", ls)
    C, Hz, IN, OUT = ls.num_cells, ls.horizon, ls.input_size, ls.output_size
    LI, S = IN + C + 1, lp.S
    lst, lw = stm["lstm"], ltm["lstm"]
    dev = kernels.cuda_device("lstm_forward", "cell", lst["cell"])
    n_ctx = stm["ctx"].shape[1]
    regs = torch.empty((S, 4), dtype=I32, device=dev)
    tensors = {
        "epoch": (lst["epoch"], (), I32), "aux": (stm["ppm_probs"], (S, IN), F32), "sym": (stm["last_byte"], (S,), I64),
        "w_sym": (lw["w_sym"], (S, 3, C, OUT), F32), "w_in": (lw["w_in"], (S, 3, C, LI), F32),
        "gamma": (lw["gamma"], (S, 3, C), F32), "beta": (lw["beta"], (S, 3, C), F32),
        "out_w": (lw["out_w"], (S, Hz, C + 1, OUT), F32), "mid": (lst["mid"], (S,), I32),
        "cell": (lst["cell"], (S, C), F32), "hidden": (lst["hidden"], (S, C + 1), F32),
        "probs": (lst["probs"], (S, OUT), F32), "top": (lst["top"], (S,), I32), "bot": (lst["bot"], (S,), I32),
        "regs": (regs, (S, 4), I32), "layer_input": (lst["layer_input"], (S, Hz, LI), F32),
        "norm": (lst["norm"], (S, 3, Hz, C), F32), "ivar": (lst["ivar"], (S, 3, Hz), F32),
        "gate_state": (lst["gate_state"], (S, 3, Hz, C), F32), "tanh_state": (lst["tanh_state"], (S, Hz, C), F32),
        "in_gate": (lst["in_gate"], (S, Hz, C), F32), "last_state": (lst["last_state"], (S, Hz, C), F32),
        "outputs": (lst["outputs"], (S, Hz, OUT), F32), "ctx": (stm["ctx"], (S, n_ctx), I64),
        "done": (lp.done, (), I32)}
    if cluster is None:
        cluster = forward_cluster(S, ls, torch.cuda.get_device_properties(dev).multi_processor_count)
    kernels.launch("lstm_forward", dict(S=S, C=C, Hz=Hz, IN=IN, OUT=OUT, n_ctx=n_ctx, ctx_slot=lstm_ctx_slot,
                                        cluster=cluster), tensors, aligned=("w_in", "out_w"))
    return regs


def lstm_perceive_kernel(stm: Dict, ltm: Dict, inp: torch.Tensor, lp: LstmPlan, record: bool) -> None:
    """The output layer's SGD of `lstm_perceive_plain` (and with `record`
    the symbol's record in `in_hist`) as one launch of csrc/lstm.cu's
    perceive kernel, on CUDA tensors, in place."""
    ls = lp.ls
    _check_shapes("lstm_perceive", ls)
    C, Hz, OUT, S = ls.num_cells, ls.horizon, ls.output_size, lp.S
    lst, lw = stm["lstm"], ltm["lstm"]
    tensors = {"epoch": (lst["epoch"], (), I32), "outputs": (lst["outputs"], (S, Hz, OUT), F32),
               "hidden": (lst["hidden"], (S, C + 1), F32), "out_w": (lw["out_w"], (S, Hz, C + 1, OUT), F32),
               "in_hist": (lst["in_hist"], (S, Hz), I32),
               # the byte end's completed byte: a column of the sub-steps' outputs
               "inp": (inp, (S,), I64)}
    kernels.launch("lstm_perceive", dict(S=S, C=C, Hz=Hz, OUT=OUT, record=int(record), inp_stride=inp.stride(0),
                                         lr=lp.lr), tensors, aligned=("out_w",), strided=("inp",))


@obs.in_part("lstm")
def _lstm_forward(stm: Dict, ltm: Dict, lp: LstmPlan, lstm_ctx_slot: int) -> torch.Tensor:
    """One byte of the forward pass (`lstm_forward_plain`): the kernel on
    CUDA tensors, the plain version on CPU tensors. Returns the head's
    registers (S, 4) int32."""
    if stm["ctx"].device.type == "cpu":
        return lstm_forward_plain(stm, ltm, lp, lstm_ctx_slot)
    return lstm_forward_kernel(stm, ltm, lp, lstm_ctx_slot)


@obs.in_part("lstm")
def _lstm_perceive(stm: Dict, ltm: Dict, inp: torch.Tensor, lp: LstmPlan, wrap: bool, bptt: bool) -> None:
    """The byte end of the LSTM (`lstm_perceive_plain`): on CUDA tensors the
    kernel; at the window's wrap the symbol's record (and with `bptt` the
    backward pass) runs op by op before it, as the plain version orders
    them. The plain version on CPU tensors."""
    if inp.device.type == "cpu":
        lstm_perceive_plain(stm, ltm, inp, lp, wrap, bptt)
        return
    if wrap:
        _record_symbol(stm["lstm"], inp, _last_epoch(stm["lstm"], lp)[1], wrap)
        if bptt:
            _lstm_bptt(stm["lstm"], ltm["lstm"], lp)
    lstm_perceive_kernel(stm, ltm, inp, lp, record=not wrap)
