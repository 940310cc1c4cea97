"""Seeded states for the LSTM byte model's per-byte work (`core.lstm`): the
forward pass and the output layer's SGD at the byte end.

The tests and `chip_smoke.py` hold the two kernels (csrc/lstm.cu) against
the plain versions, and the plain versions against gmix_tpu's, on the same
states, made with numpy so that every side gets the same bits. A sample is
gmix_tpu's state tree cut to what the LSTM reads and writes, in gmix_tpu's
dtypes: `stm` holds `ppm_probs`, `last_byte`, `acc` (the byte the byte end
records), `ctx` and the `lstm` leaves, `ltm` the `lstm` weights.
`random_state` draws leaves of the size a running model holds;
`edge_state` builds one stream per corner the kernels must get right
(`EDGE_STREAMS`). Either is drawn at a given epoch: 0 and horizon - 1 (the
forward pass wraps the window) are the ones to try.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.meta import Meta
from ..state import state_from_numpy

# the streams of `edge_state`, in order
EDGE_STREAMS = ("argmax-tie", "logits-negative", "pre-past-87", "negative-zero-products", "byte-0", "byte-255")
# the two outputs whose logits `edge_state` makes equal and largest
TIE = (77, 200)
F32 = np.float32


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return (e / e.sum(axis=-1, keepdims=True)).astype(F32)


def random_state(meta: Meta, S: int, seed: int, epoch: int) -> Dict:
    """Every LSTM leaf, the aux input, the bytes and the contexts of `S`
    streams, drawn around what a running model holds: weights near their
    Xavier draw, softmax outputs and aux inputs, gates in their ranges."""
    ls = meta.spec.lstm
    C, Hz, IN, OUT = ls.num_cells, ls.horizon, ls.input_size, ls.output_size
    LI = IN + C + 1
    rng = np.random.default_rng(seed)

    def normal(shape, scale, shift=0.0):
        return (shift + scale * rng.standard_normal(shape)).astype(F32)

    def unit(shape, lo, hi):
        return rng.uniform(lo, hi, shape).astype(F32)

    val = float(np.sqrt(6.0 / (IN + OUT)))
    lw = {"w_sym": unit((S, 3, C, OUT), -val, val), "w_in": unit((S, 3, C, LI), -val, val)}
    lw["w_in"][:, 0, :, LI - 1] = normal((S, C), 0.05, 1.0)  # the forget gate's bias column
    for k, shape in (("sym", (S, 3, C, OUT)), ("in", (S, 3, C, LI)), ("gamma", (S, 3, C)), ("beta", (S, 3, C))):
        lw[f"{k}_m"], lw[f"{k}_v"] = normal(shape, 1e-2), np.abs(normal(shape, 1e-4))
    lw["gamma"], lw["beta"] = normal((S, 3, C), 0.1, 1.0), normal((S, 3, C), 0.1)
    lw["out_w"] = normal((S, Hz, C + 1, OUT), 0.05)

    hidden = np.ones((S, C + 1), F32)
    hidden[:, :C] = unit((S, C), -1, 1)
    gate_state = unit((S, 3, Hz, C), 0, 1)
    gate_state[:, 1] = unit((S, Hz, C), -1, 1)
    layer_input = np.ones((S, Hz, LI), F32)
    layer_input[:, :, :IN] = _softmax(3 * rng.standard_normal((S, Hz, IN)))
    layer_input[:, :, IN : IN + C] = unit((S, Hz, C), -1, 1)
    outputs = _softmax(3 * rng.standard_normal((S, Hz, OUT)))
    lst = {
        "probs": outputs[:, 0].copy(),
        "top": rng.integers(0, 256, S).astype(np.int32),
        "bot": rng.integers(0, 256, S).astype(np.int32),
        "mid": rng.integers(0, 256, S).astype(np.int32),
        "cell": normal((S, C), 0.5),
        "hidden": hidden,
        "state_err": normal((S, C), 0.1),
        "stored_err": normal((S, C), 0.1),
        "old_input": rng.integers(0, 256, S).astype(np.int32),
        "norm": normal((S, 3, Hz, C), 1.0),
        "ivar": unit((S, 3, Hz), 0.5, 2.0),
        "gate_state": gate_state,
        "tanh_state": unit((S, Hz, C), -1, 1),
        "in_gate": F32(1.0) - gate_state[:, 0],
        "last_state": normal((S, Hz, C), 0.5),
        "layer_input": layer_input,
        "in_hist": rng.integers(0, 256, (S, Hz)).astype(np.int32),
        "outputs": outputs,
        "epoch": np.array(epoch, np.int32),
        "update_steps": np.array(7, np.int32),
    }
    stm = {
        "ppm_probs": _softmax(3 * rng.standard_normal((S, IN))),
        "last_byte": rng.integers(0, 256, S).astype(np.uint32),
        "acc": rng.integers(0, 256, S).astype(np.uint32),
        "ctx": rng.integers(0, 2**32, (S, meta.n_ctx), dtype=np.uint64).astype(np.uint32),
        "lstm": lst,
    }
    return {"stm": stm, "ltm": {"lstm": lw}}


def edge_state(meta: Meta, seed: int, epoch: int) -> Dict:
    """One stream per corner (`EDGE_STREAMS`), on a `random_state`:

    - argmax-tie: the outputs TIE have the largest logits, equal (their
      out_w columns are zero but for the bias row, 5.0), so their
      probabilities tie and the argmax takes the first;
    - logits-negative: every logit near -100 (the bias row), so the max is
      clamped to 0 and every exp at -87: all probabilities equal;
    - pre-past-87: gains of 400 and offsets of +-100, so the gates' pre-
      activations pass +-87 (exp_det clamps in logistic and tanh), and a
      bias row of +-95 does the same to the logits;
    - negative-zero-products: a zero aux input and hidden vector against
      negative weights and a -0.0 bias column and symbol column: every
      product of a gate row is -0.0, and the padded tree's +0.0 makes the
      sum +0.0;
    - byte-0, byte-255: the symbol read and the byte recorded at the ends of
      their range.
    """
    ls = meta.spec.lstm
    C, IN, OUT = ls.num_cells, ls.input_size, ls.output_size
    LI = IN + C + 1
    e = epoch
    sample = random_state(meta, len(EDGE_STREAMS), seed, epoch)
    stm, lst, lw = sample["stm"], sample["stm"]["lstm"], sample["ltm"]["lstm"]
    at = {name: s for s, name in enumerate(EDGE_STREAMS)}
    s = at["argmax-tie"]
    lw["out_w"][s, e, :, list(TIE)] = 0.0
    lw["out_w"][s, e, C, list(TIE)] = 5.0
    s = at["logits-negative"]
    lw["out_w"][s, e, C, :] = -100.0
    s = at["pre-past-87"]
    lw["gamma"][s] = 400.0
    lw["beta"][s] = np.where(np.arange(3 * C).reshape(3, C) % 2 == 0, 100.0, -100.0).astype(F32)
    lw["out_w"][s, e, C, :] = np.where(np.arange(OUT) % 3 == 0, 95.0, -95.0).astype(F32)
    s = at["negative-zero-products"]
    stm["ppm_probs"][s] = 0.0
    lst["hidden"][s, :C] = 0.0
    lw["w_in"][s] = -np.abs(lw["w_in"][s])
    lw["w_in"][s, :, :, LI - 1] = -0.0
    lw["w_sym"][s, :, :, int(stm["last_byte"][s])] = -0.0
    for name, byte in (("byte-0", 0), ("byte-255", 255)):
        stm["last_byte"][at[name]] = byte
        stm["acc"][at[name]] = byte
    return sample


def to_state(sample: Dict, device, streams: Optional[Sequence[int]] = None) -> Tuple[Dict, Dict]:
    """(stm, ltm) of the port on `device` from a sample: its leaves, only the
    streams `streams` (all by default); the 0-d leaves as they are."""
    S = len(sample["stm"]["acc"])
    keep = np.arange(S) if streams is None else np.asarray(streams, np.int64)

    def cut(tree):
        return {k: cut(v) if isinstance(v, dict) else (v if v.ndim == 0 else v[keep]) for k, v in tree.items()}

    return state_from_numpy(cut(sample["stm"]), device), state_from_numpy(cut(sample["ltm"]), device)
