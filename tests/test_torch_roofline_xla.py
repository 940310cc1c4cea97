"""The byte step's float operations as `gmix_tpu_torch/roofline.py`'s
`step_work` counts them from the spec, against XLA's HLO cost analysis of
gmix_tpu's own functions (the reading tools/tpu_profile.py printed), part by
part at the tiny LSTM spec, on the CPU. `pytest -s` prints each pair and its
ratio.
"""
import functools

import jax
import jax.numpy as jnp
import pytest

import gmix_tpu.config as j_cfg
from gmix_tpu.core import step as j_step
from gmix_tpu.core.meta import build_meta as j_build_meta
from gmix_tpu.state import init_state as j_init_state
import gmix_tpu_torch as gt
from gmix_tpu_torch import roofline as rl
from gmix_tpu_torch.core.meta import build_meta

S = 2


def _xla_float_ops(fn, *args) -> float:
    """XLA's HLO cost analysis of `fn` jitted and lowered, the reading
    tools/tpu_profile.py printed: its flops, with each transcendental
    counted as the module counts one (`rl.TRANSCENDENTAL`)."""
    cost = jax.jit(fn).lower(*args).cost_analysis()
    return cost["flops"] + rl.TRANSCENDENTAL * (cost.get("transcendentals") or 0)


@functools.lru_cache(maxsize=None)
def _xla_byte_step() -> tuple:
    """XLA's float operations of gmix_tpu's encode byte step as the bench
    runs it (learning, analysis off, the backward pass deferred): with the
    8 sub-steps unrolled, and with them scanned, whose body the cost
    analysis counts once; the difference is 7 sub-steps."""
    meta = j_build_meta(j_cfg.tiny_spec(True))
    st = j_init_state(meta, S)
    data, code = jnp.zeros((S, 64), jnp.uint8), jnp.zeros((S, 4096), jnp.uint8)

    def ops(bit_scan):
        def step(stm, ltm, coder, metrics, data, code):
            return j_step._byte_step(stm, ltm, coder, metrics, data, code, j_step._code_words(code), jnp.int32(3),
                                     jnp.asarray(False), meta, True, "defer", bit_scan=bit_scan, analysis=False)
        return _xla_float_ops(step, st["stm"], st["ltm"], st["coder"], st["metrics"], data, code)

    return ops(False), ops(True)


# (part, least and most of step_work's float operations over XLA's). The
# LSTM's passes agree within 1.5x either way. XLA's reading of the
# sub-steps and of the whole step is larger: it also counts the compares,
# the selects and the one-hot selections over all T rows (the 256 lanes of
# a sub-step's registers, the dense mixer rows), which the module's rules
# leave out; at this spec that is up to 3.2x.
XLA_FACTORS = [("lstm_forward", 2 / 3, 3 / 2), ("lstm_backward", 2 / 3, 3 / 2), ("sub_steps", 1 / 4, 1),
               ("step", 1 / 4, 1)]


@pytest.mark.parametrize("part,least,most", XLA_FACTORS)
def test_float_ops_agree_with_xlas_cost_analysis(monkeypatch, part, least, most):
    """`step_work`'s float operations, counted from the spec, against XLA's
    count of gmix_tpu's own functions at `tiny_spec(True)`, within the
    factors of `XLA_FACTORS`: a term left out of the count (an LSTM
    product, Adam, a mixer's dot) or counted tenfold falls outside them."""
    work = rl.step_work(build_meta(gt.tiny_spec(True)), S)
    ours = {p: w["float_ops"] for p, w in work["parts"].items()}
    if part in ("sub_steps", "step"):
        unrolled, scanned = _xla_byte_step()
        if part == "sub_steps":
            got, xla = ours["sub_steps"], 8 * (unrolled - scanned) / 7
        else:  # the byte step without the backward pass, which the chunk runs after it
            got, xla = work["float_ops"] - ours["lstm_backward"], unrolled
    else:
        meta = j_build_meta(j_cfg.tiny_spec(True))
        st = j_init_state(meta, S)
        if part == "lstm_forward":  # the forward pass and the output layer's SGD
            got = ours["lstm_forward"]
            xla = _xla_float_ops(lambda stm, ltm: j_step._lstm_forward(stm, ltm, meta), st["stm"], st["ltm"])
            xla += _xla_float_ops(lambda stm, ltm, inp: j_step._lstm_perceive(stm, ltm, inp, meta, "defer"),
                                  st["stm"], st["ltm"], jnp.zeros((S,), jnp.int32))
        else:  # one pass over the horizon, its epochs unrolled (the analysis counts a loop's body once)
            got = ours["lstm_backward"] * meta.spec.lstm.horizon
            monkeypatch.setattr(jax.lax, "scan", functools.partial(jax.lax.scan, unroll=True))
            xla = _xla_float_ops(lambda lst, lw: j_step._lstm_bptt(lst, lw, meta), st["stm"]["lstm"], st["ltm"]["lstm"])
    print(f"{part}, S={S}: step_work {got:.0f}, XLA {xla:.0f}, ratio {got / xla:.4f}")
    assert least <= got / xla <= most, (part, got, xla)
