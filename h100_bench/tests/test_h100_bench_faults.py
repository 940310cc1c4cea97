"""The rest of a run, without the look for a card: the harness drives the
program on the CPU at a tiny spec with its timed path broken underneath,
and `correct` must come out false for each fault a cell can have (a step
that returns its state unchanged; half of the streams left out; a code
byte or a decoded byte altered where it is produced). The exchange between
chips does not exist in a one-chip cell. The LSTM's Adam step leaving its
moments or its step count unwritten shows only from the second backward
pass on (the first starts from zero moments and step 0 alike): the mix
checks 35 bytes of a horizon of 10, three backward passes, as the cells'
mixes check 300 bytes of a horizon of 100. A sound run reads correct. The
same at the shape of gmix-ref-noppm (no LSTM, no PPM), for the faults it
can have."""
import dataclasses
import json
import time

import pytest

import gmix_tpu_torch.core.codec as codec
import gmix_tpu_torch.core.lstm as lstm
import gmix_tpu_torch.core.step as step
from gmix_tpu_torch.config import tiny_spec
from gmix_tpu_torch.state import copy_into
from gmix_tpu_torch.utils.serialization import copy_state
from h100_bench.check import correct
from h100_bench.harness import run_cell

MIX = {"corpus": "corpus_1m.bin", "streams": 2, "bytes_per_stream": 40, "chunk": 20, "check_streams": 2,
       "check_bytes": 35, "trace_steps": 20}
SEED = 3_000_000_019


def tiny_config(spec=None):
    spec = tiny_spec(True) if spec is None else spec
    return {"spec": json.loads(json.dumps(dataclasses.asdict(spec))), "stream_bytes": 40,
            "counts_per_stream": None, "kernels": {"fused": ["fused_substeps_kernel"], "movers": []}}


def tiny_noppm_config():
    return tiny_config(dataclasses.replace(tiny_spec(True), lstm=None, ppm=None, roll_ctxs=()))


def verdict(config=None):
    out = run_cell(tiny_config() if config is None else config, MIX, SEED, 0.0, False, "cpu", time.perf_counter(), settle_s=0.0)
    return correct(out["verdict"]["numbers"], out["failed"]), out


def test_a_sound_run_is_correct():
    ok, out = verdict()
    assert ok, out["verdict"]


def _unchanged_state(monkeypatch):
    real = step._byte_step

    def byte_step(state, *a, **k):
        before = copy_state(state)
        got = real(state, *a, **k)
        copy_into(state, before)
        return got

    monkeypatch.setattr(step, "_byte_step", byte_step)


def _lstm_moments_unwritten(monkeypatch):
    real = lstm._adam_all

    def adam_all(lst, lw, grads, lp):
        kept = {k: lw[k] for k in ("sym_m", "sym_v", "in_m", "in_v", "gamma_m", "gamma_v", "beta_m", "beta_v")}
        real(lst, lw, grads, lp)
        lw.update(kept)

    monkeypatch.setattr(lstm, "_adam_all", adam_all)


def _lstm_step_count_unwritten(monkeypatch):
    real = lstm._adam_all

    def adam_all(lst, lw, grads, lp):
        kept = lst["update_steps"]
        real(lst, lw, grads, lp)
        lst["update_steps"] = kept

    monkeypatch.setattr(lstm, "_adam_all", adam_all)


def _half_the_streams(monkeypatch):
    real = codec._run

    def run(pred, data_bufs, code_bufs, n_bytes, decode, *a, **k):
        if not decode:
            for d in data_bufs:
                d[d.shape[0] // 2 :] = 0  # the second half's bytes never reach the model
        return real(pred, data_bufs, code_bufs, n_bytes, decode, *a, **k)

    monkeypatch.setattr(codec, "_run", run)


def _code_byte_altered(monkeypatch):
    real = codec._compact_emits

    def compact(win, nw, S):
        out = real(win, nw, S)
        return [p[:-1] + bytes([p[-1] ^ 0x40]) if p else p for p in out]

    monkeypatch.setattr(codec, "_compact_emits", compact)


def _decoded_byte_altered(monkeypatch):
    real = codec.decompress_bytes

    def decompress(*a, **k):
        out = real(*a, **k)
        return out[:3] + bytes([out[3] ^ 1]) + out[4:]

    monkeypatch.setattr(codec, "decompress_bytes", decompress)


@pytest.mark.parametrize("fault", [_unchanged_state, _lstm_moments_unwritten, _lstm_step_count_unwritten,
                                   _half_the_streams, _code_byte_altered, _decoded_byte_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    ok, out = verdict()
    assert not ok, out["verdict"]


def test_a_sound_run_without_lstm_and_ppm_is_correct():
    ok, out = verdict(tiny_noppm_config())
    assert ok, out["verdict"]


@pytest.mark.parametrize("fault", [_unchanged_state, _half_the_streams, _code_byte_altered, _decoded_byte_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_path_without_lstm_and_ppm_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    ok, out = verdict(tiny_noppm_config())
    assert not ok, out["verdict"]
