"""The seven inexact reductions of the port's LSTM (core/lstm.py), each a
fixed tree (`_tree_sum_dim`), against the expression eager gmix_tpu
evaluates in its place (gmix_tpu/core/step.py `_lstm_forward`,
`_lstm_bptt`), on the same seeded numpy inputs at the shapes of
`tiny_spec(True)`'s LSTM (16 cells, horizon 10) and of `reference_spec()`'s
(50 cells, horizon 100).

gmix_tpu leaves the order of these sums to XLA:CPU, and none of the seven
trees equals that order on every case here (each differs on some seed at
both shapes). So each is held within the LSTM's tolerance (ROADMAP.md
contract 3: 1e-5 relative with a floor of 1e-6), and the largest
differences in ulp are recorded in ROADMAP.md section C. Run this file as a
script to print them:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_lstm_trees.py
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gmix_tpu_torch.config as t_cfg
from gmix_tpu_torch.core.lstm import _tree_sum_dim

torch.set_num_threads(1)

S = 3
SEEDS = (0, 1, 2)
RTOL, ATOL = 1e-5, 1e-6
# (cells, aux input, output lanes) of the two specs' LSTMs
SHAPES = {
    "tiny": (t_cfg.tiny_spec(True).lstm.num_cells, t_cfg.tiny_spec(True).lstm.input_size,
             t_cfg.tiny_spec(True).lstm.output_size),
    "reference": (t_cfg.reference_spec().lstm.num_cells, t_cfg.reference_spec().lstm.input_size,
                  t_cfg.reference_spec().lstm.output_size),
}


def _inputs(name: str, seed: int) -> dict:
    """Seeded float32 inputs of a running model's sizes: weights and errors
    near 0, a softmax output, gates in (0, 1), the layer input
    [PPM distribution | hidden | 1]."""
    C, IN, OUT = SHAPES[name]
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    aux = rng.random((S, IN)).astype(np.float32)
    aux = (aux / aux.sum(axis=1, keepdims=True)).astype(np.float32)
    hidden = np.tanh(normal((S, C), 1.0)).astype(np.float32)
    logits = normal((S, OUT), 2.0)
    probs = np.exp(logits - logits.max(axis=1, keepdims=True)).astype(np.float32)
    outputs = (probs / probs.sum(axis=1, keepdims=True)).astype(np.float32)
    return {
        "w_in": normal((S, 3, C, IN + C + 1), 0.1),
        "li": np.concatenate([aux, hidden, np.ones((S, 1), np.float32)], axis=1),
        "f": normal((S, 3, C), 1.0),
        "w_e": normal((S, C + 1, OUT), 0.1),
        "hidden": np.concatenate([hidden, np.ones((S, 1), np.float32)], axis=1),
        "probs": probs,
        "out_err": (outputs - np.eye(OUT, dtype=np.float32)[rng.integers(0, OUT, S)]).astype(np.float32),
        "err2": normal((S, 3, C), 0.01),
        "norm": normal((S, 3, C), 1.0),
        "w_hid": normal((S, 3, C, C), 0.1),
    }


def _port(which: str, x: dict) -> torch.Tensor:
    """The port's expression at core/lstm.py:<line>."""
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    C = t["f"].shape[2]
    if which == "gate_inputs":  # :110
        return _tree_sum_dim(t["w_in"] * t["li"][:, None, None, :], 3)
    if which == "mean_square":  # :111
        return _tree_sum_dim(t["f"] * t["f"], 2) / torch.tensor(float(C), dtype=torch.float32)
    if which == "logits":  # :124
        return _tree_sum_dim(t["w_e"] * t["hidden"][:, :, None], 1)
    if which == "softmax_sum":  # :127
        return _tree_sum_dim(t["probs"], 1)
    if which == "output_error":  # :195, one epoch of the horizon's
        return _tree_sum_dim(t["out_err"][:, None, :] * t["w_e"][:, :C, :], 2)
    if which == "layer_norm_projection":  # :226
        return _tree_sum_dim(t["err2"] * t["norm"], 2)
    if which == "hidden_gradient":  # :230
        return _tree_sum_dim((t["err2"][:, :, :, None] * t["w_hid"]).reshape(S, 3 * C, C), 1)
    raise KeyError(which)


def _gmix_tpu(which: str, x: dict) -> np.ndarray:
    """gmix_tpu's expression in its place (gmix_tpu/core/step.py), eagerly."""
    j = {k: jnp.asarray(v) for k, v in x.items()}
    f32 = jnp.float32
    with jax.disable_jit():
        if which == "gate_inputs":  # _lstm_forward
            out = jnp.einsum("sgcr,sr->sgc", j["w_in"], j["li"], preferred_element_type=f32)
        elif which == "mean_square":
            out = jnp.mean(j["f"] * j["f"], axis=2)
        elif which == "logits":
            out = jnp.sum(j["w_e"] * j["hidden"][:, :, None], axis=1)
        elif which == "softmax_sum":
            out = jnp.sum(j["probs"], axis=1, keepdims=True)[:, 0]
        elif which == "output_error":  # _lstm_bptt's epoch_step
            C = x["f"].shape[2]
            out = jnp.sum(j["out_err"][:, None, :] * j["w_e"][:, :C, :], axis=2)
        elif which == "layer_norm_projection":
            out = jnp.sum(j["err2"] * j["norm"], axis=2, keepdims=True)[:, :, 0]
        elif which == "hidden_gradient":
            out = jnp.einsum("sgc,sgch->sh", j["err2"], j["w_hid"], preferred_element_type=f32)
        else:
            raise KeyError(which)
        return np.asarray(jax.device_get(out))


REDUCTIONS = ("gate_inputs", "mean_square", "logits", "softmax_sum", "output_error", "layer_norm_projection",
              "hidden_gradient")


def _ulp(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in float32 steps between a and b."""
    def ordered(x):
        i = x.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int(np.abs(ordered(a) - ordered(b)).max())


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("which", REDUCTIONS)
def test_tree_against_gmix_tpu(which, shape):
    for seed in SEEDS:
        x = _inputs(shape, seed)
        got, want = _port(which, x).numpy(), _gmix_tpu(which, x)
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32
        assert (np.abs(got - want) <= ATOL + RTOL * np.abs(want)).all(), f"seed {seed}: {_ulp(got, want)} ulp"


if __name__ == "__main__":
    for which in REDUCTIONS:
        for shape in sorted(SHAPES):
            ulps, shares = [], []
            for seed in SEEDS:
                x = _inputs(shape, seed)
                got, want = _port(which, x).numpy(), _gmix_tpu(which, x)
                ulps.append(_ulp(got, want))
                shares.append(float((np.abs(got - want) / (ATOL + RTOL * np.abs(want))).max()))
            print(f"{which:24s} {shape:10s} largest ulp by seed {ulps}, of the tolerance {max(shares):.4f}")
