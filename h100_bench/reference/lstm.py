# Frozen copy of gmix_tpu_torch/core/lstm.py at commit 334906b, plain torch on the CPU only;
# imports nothing of gmix_tpu_torch, gmix_tpu or jax (h100_bench/reference/__init__.py).
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
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .sigmoid import exp_det, logistic, powc_det, rdiv, sqrt_det, tanh_det

F32 = torch.float32
I32 = torch.int32


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


def _lstm_forward(stm: Dict, ltm: Dict, lp: LstmPlan, lstm_ctx_slot: int) -> None:
    """One byte of the forward pass at the state's epoch (lstm.cpp:91-122,
    lstm-layer.cpp:198-241): records the epoch's activations, sets `probs`,
    the head's interval registers and the `lstm_ctx` context (the most
    probable next byte), and advances the epoch leaf."""
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


def _lstm_bptt(lst: Dict, lw: Dict, lp: LstmPlan) -> None:
    """Horizon-window backward pass + Adam: reads the recorded forward
    history and the Hz output layers, updates the gate weights."""
    _adam_all(lst, lw, _lstm_grads(lst, lw, lp), lp)


def _lstm_perceive(stm: Dict, ltm: Dict, inp: torch.Tensor, lp: LstmPlan, wrap: bool, bptt: bool) -> None:
    """Lstm::Perceive (lstm.cpp:52-89) at the byte end, after this byte's
    forward pass has advanced the epoch leaf: record the observed symbol, run
    the backward pass when the window has wrapped (`wrap`: the epoch leaf is
    now 0; with `bptt` off the caller runs it itself after the byte), then
    the per-byte SGD of the output layer, which copies the last epoch's
    weights into the current slot and applies the step."""
    ls = lp.ls
    lst, lw = stm["lstm"], ltm["lstm"]
    e_cur = _epoch_index(lst)
    last_e = (e_cur + (ls.horizon - 1)) % ls.horizon
    if wrap:
        # the symbol that preceded epoch 0 of the next window (read by the
        # backward pass)
        lst["old_input"] = lst["in_hist"].index_select(1, last_e)[:, 0]
    lst["in_hist"].index_copy_(1, last_e, inp.to(I32)[:, None])

    if bptt and wrap:
        _lstm_bptt(lst, lw, lp)

    err = lst["outputs"].index_select(1, last_e)[:, 0] - (lp.lane_out == inp[:, None]).to(F32)
    out_w = lw["out_w"]
    new_w = out_w.index_select(1, last_e)[:, 0] - lst["hidden"][:, :, None] * lp.lr * err[:, None, :]
    out_w.index_copy_(1, e_cur, new_w[:, None])
