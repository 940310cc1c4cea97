# Frozen copy of gmix_tpu_torch/state.py (the fresh state) at commit 334906b, plain torch on the CPU only;
# imports nothing of gmix_tpu_torch, gmix_tpu or jax (h100_bench/reference/__init__.py).
"""Codec state as a nested dict of batched tensors.

Port of `gmix_tpu.state`: the same leaf names, shapes and initial values,
with a leading stream axis S. Dtypes follow what torch can compute with:

- u32 registers and small u32 arrays are int64 tensors holding [0, 2^32)
  (torch's uint32 has no add or shift on the CPU);
- the two large u32 arenas (`ltm.match_tbl`, `stm.ih_tbl`) are int32
  tensors with the same bits, so that they take no more memory than in
  gmix_tpu;
- the u16 arenas (`ltm.ind.st`, `stm.ppm_tbl`) are int16 with the same bits;
- u8, int32 and float32 leaves keep their dtype.

`state_to_numpy` restores gmix_tpu's dtypes and `state_from_numpy` takes them
back, so a state moves between the two packages leaf for leaf. The port
updates the arenas in place rather than copying them every byte, and keeps
every leaf in its storage for the life of a predictor (`copy_into`).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from . import threefry
from .meta import APM_BINS, APM_SPAN, PPM_ROW_W, Meta

DEFAULT_SEED = 0xDEADBEEF

# u32 leaves stored as int32 bit patterns (the large arenas)
U32_AS_I32 = frozenset({"match_tbl", "ih_tbl"})


def init_state(meta: Meta, num_streams: int, seed: int = DEFAULT_SEED, device="cpu") -> Dict:
    """Fresh state for `num_streams` streams on `device`. `seed` seeds the
    LSTM's initial weights, the same for every stream and equal to gmix_tpu's
    (utils/threefry.py)."""
    spec = meta.spec
    S = num_streams
    f32, i32, i64 = torch.float32, torch.int32, torch.int64

    def zeros(shape, dtype=i64):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    stm: Dict = {
        "bits_seen": zeros((S,)),
        "new_bit": zeros((S,)),
        "acc": zeros((S,)),  # bits of the in-flight byte (MSB-first value)
        "last_byte": zeros((S,)),
        # recent[:, i] = byte i-ago (i=0: last)
        "recent": zeros((S, meta.recent_size)),
        "ctx": zeros((S, meta.n_ctx)),
        "hist_n": zeros((S,)),
        "ppm_probs": full((S, 256), 1.0 / 256, f32),
    }
    if spec.roll_ctxs:
        stm["roll_h"] = zeros((S, len(spec.roll_ctxs)))
    if spec.matches:
        nm = len(spec.matches)
        stm["match_ptr"] = zeros((S, nm))
        stm["match_byte"] = zeros((S, nm))
        stm["match_len"] = zeros((S, nm), i32)
    if spec.ihash_ctxs:
        nih = len(spec.ihash_ctxs)
        stm["ih_outer_ctx"] = zeros((S, nih))
        stm["ih_outer_hash"] = zeros((S, nih))

    ltm: Dict = {}
    # indirect models: ONE block arena of (ns | rm<<8) u16 pairs, ns init 255
    # (never seen), rm init 0 -> word 0x00FF (long-term-memory.h:11-16), and
    # the shared state->logit tables (rows [ns models | rm models])
    M = len(spec.indirects)
    ltm["ind"] = {
        "st": full((S, meta.ind_nblocks, 256), 255, torch.int16),
        "p": zeros((S, 2 * M, 256), f32),
    }
    # mixers: three arenas by placement class (core/meta.py); the per-row
    # steps counters live bitcast in lane meta.mix_step_lane
    K = meta.mix_n0 + meta.mix_n1 + 1
    WP = meta.mix_width_pad
    if meta.mix_total_rows:
        ltm["mix_w"] = zeros((S, meta.mix_total_rows, WP), f32)
    if meta.mix_pos_groups:
        ltm["mix_pos"] = zeros((S, meta.mix_pos_groups, 8 * WP), f32)
    if meta.mix_dense_total:
        ltm["mix_dense"] = zeros((S, meta.mix_dense_total, WP), f32)
    ltm["mix_max_steps"] = full((S, K), 1, i64)  # mixer.cpp:8

    if spec.matches:
        nm = len(spec.matches)
        ltm["match_tbl"] = zeros((S, meta.match_total), i32)
        # predictions[i] = 0.5 + (i+0.5)/512, counts = 1 (match.cpp:19-23)
        pred0 = 0.5 + (np.arange(256, dtype=np.float32) + 0.5) / 512.0
        ltm["match_pred"] = torch.as_tensor(pred0, device=device).expand(S, nm, 256).clone()
        ltm["match_cnt"] = full((S, nm, 256), 1, i32)

    if spec.ihash_ctxs:
        stm["ih_tbl"] = zeros((S, meta.ih_total), i32)

    ltm["hist"] = zeros((S, meta.history_size), torch.uint8)

    # SSE/APM rows initialised to the identity map p(bin k) = logistic(bin
    # centre), computed on the host exactly as gmix_tpu does
    if spec.apm:
        centers = -APM_SPAN + np.arange(APM_BINS) * (2 * APM_SPAN / (APM_BINS - 1))
        ident = 1.0 / (1.0 + np.exp(-centers))
        row = np.tile(ident.astype(np.float32), 8)
        ltm["apm"] = torch.as_tensor(row, device=device).expand(S, meta.apm_total, 8 * APM_BINS).clone()

    # PPM byte model, in short-term memory as in gmix_tpu: widened rows of
    # 256 u16 counts + the owner tag at lane 256 (core/ppm.py), the interval
    # registers of its bit head, and the learned escape-logit offsets per
    # (order, distinct bucket), 0 = the pure PPM-C prior
    if spec.ppm is not None:
        stm["ppm_tbl"] = zeros((S, meta.ppm_total_rows, PPM_ROW_W), torch.int16)
        stm["ppm_top"] = full((S,), 255, i32)
        stm["ppm_bot"] = zeros((S,), i32)
        stm["ppm_mid"] = full((S,), 127, i32)
        stm["ppm_see"] = zeros((S, len(spec.ppm.orders), spec.ppm.see_buckets), f32)

    # LSTM byte model: gate weights with their Adam moments and the per-epoch
    # output layers in long-term memory; the forward history of one horizon
    # window in short-term memory. `epoch` and `update_steps` are 0-d, shared
    # by all streams.
    if spec.lstm is not None:
        ls = spec.lstm
        C, Hz, OUT = ls.num_cells, ls.horizon, ls.output_size
        LI = ls.input_size + C + 1  # [aux, hidden, bias]
        # Xavier-uniform (lstm-layer.cpp:179-195); the weight row [one-hot
        # symbol | input vector] is stored split (w_sym | w_in)
        val = math.sqrt(6.0 / float(ls.input_size + ls.output_size))
        k1, k2 = threefry.split(threefry.key(seed))
        w_sym = threefry.uniform(k1, (3, C, OUT), -val, val)
        w_in = threefry.uniform(k2, (3, C, LI), -val, val)
        w_in[0, :, LI - 1] = 1.0  # forget-gate bias column = 1

        def per_stream(a):
            return torch.as_tensor(a, device=device).expand((S,) + a.shape).clone()

        ltm["lstm"] = {
            "w_sym": per_stream(w_sym),
            "sym_m": zeros((S, 3, C, OUT), f32),
            "sym_v": zeros((S, 3, C, OUT), f32),
            "w_in": per_stream(w_in),
            "in_m": zeros((S, 3, C, LI), f32),
            "in_v": zeros((S, 3, C, LI), f32),
            "gamma": full((S, 3, C), 1.0, f32),
            "beta": zeros((S, 3, C), f32),
            "gamma_m": zeros((S, 3, C), f32),
            "gamma_v": zeros((S, 3, C), f32),
            "beta_m": zeros((S, 3, C), f32),
            "beta_v": zeros((S, 3, C), f32),
            "out_w": zeros((S, Hz, C + 1, OUT), f32),
        }
        hidden = zeros((S, C + 1), f32)
        hidden[:, C] = 1.0  # bias lane (lstm.cpp:31)
        layer_input = zeros((S, Hz, LI), f32)
        layer_input[:, :, LI - 1] = 1.0
        stm["lstm"] = {
            "probs": full((S, 256), 1.0 / 256, f32),  # byte-level output
            "top": full((S,), 255, i32),
            "bot": zeros((S,), i32),
            "mid": full((S,), 127, i32),
            "cell": zeros((S, C), f32),
            "hidden": hidden,
            "state_err": zeros((S, C), f32),
            "stored_err": zeros((S, C), f32),
            "old_input": zeros((S,), i32),
            "norm": zeros((S, 3, Hz, C), f32),
            "ivar": zeros((S, 3, Hz), f32),
            "gate_state": zeros((S, 3, Hz, C), f32),
            "tanh_state": zeros((S, Hz, C), f32),
            "in_gate": zeros((S, Hz, C), f32),
            "last_state": zeros((S, Hz, C), f32),
            "layer_input": layer_input,
            "in_hist": zeros((S, Hz), i32),
            "outputs": full((S, Hz, OUT), 1.0 / OUT, f32),
            "epoch": zeros((), i32),
            "update_steps": zeros((), i32),
        }

    return {"stm": stm, "ltm": ltm, "coder": coder_state(S, device), "metrics": metrics_state(meta, S, device)}


def coder_state(num_streams: int, device="cpu") -> Dict:
    """The arithmetic coder's registers of a fresh stream, `num_streams`
    times: `init_state`'s `coder`."""
    S, i64 = num_streams, torch.int64
    return {
        "x1": torch.zeros((S,), dtype=i64, device=device),
        "x2": torch.full((S,), 0xFFFFFFFF, dtype=i64, device=device),
        "x": torch.zeros((S,), dtype=i64, device=device),
        "wpos": torch.zeros((S,), dtype=i64, device=device),
        "rpos": torch.zeros((S,), dtype=i64, device=device),
    }


def metrics_state(meta: Meta, num_streams: int, device="cpu") -> Dict:
    """The cumulative cross-entropy (bits) and the per-column analysis EMA of
    a fresh stream, `num_streams` times: `init_state`'s `metrics`."""
    n_cols = meta.n_pred + meta.mix_n0 + meta.mix_n1 + 1
    return {
        "ent": torch.zeros((num_streams,), dtype=torch.float32, device=device),
        "ema": torch.full((num_streams, n_cols), 1.0, dtype=torch.float32, device=device),
    }
