"""Seeded, valid packed inputs for `core.fused.fused_substeps`.

The tests and `chip_smoke.py` hold the sub-step kernel, its plain version and
gmix_tpu's kernel body against each other on the same inputs. Those inputs
must be states the codec can reach, not noise: indirect blocks of
`ns | rm << 8` pairs, match lengths in 0..255, `x1 < x2` with differing top
bytes, probabilities in (0, 1), byte distributions that sum to 1, bitcast
steps counters on both sides of 2^23 (below it they are float denormals) and
next to a weight-decay step, and a few -0.0 in the float tables. Made with
numpy only, so that every side gets the same bits; values are finite.
`with_sampling` turns such inputs (or a live byte step's) into a sampling
step's.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.fused import CODER_WIN, SC_DECODE, SC_SAMPLE, WIN_PAD, _dims, io_layout
from ..core.meta import APM_BINS, Meta


def random_inputs(meta: Meta, S: int, seed: int, decode: bool = False, not_first: bool = True) -> Dict[str, np.ndarray]:
    """The per-stream inputs of `io_layout(meta, True, True)` as numpy arrays
    in the port's dtypes (a run without learn or analysis ignores the
    extra entries)."""
    rng = np.random.default_rng(seed)
    d = _dims(meta)
    M, NM, K, WP, SL = d["M"], d["NM"], d["K"], d["WP"], d["SL"]

    def u(lo, hi, shape):
        return rng.integers(lo, hi, shape, dtype=np.int64)

    def f(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def rows(n):
        """Mixer rows with their bitcast steps counter in lane SL: fresh,
        one short of a weight-decay step, mid-range, or past 2^23."""
        w = f((S, n, WP), 0.1)
        kind = rng.integers(0, 4, (S, n))
        steps = np.select(
            [kind == 0, kind == 1, kind == 2],
            [u(0, 50, (S, n)), 1024 * u(1, 9, (S, n)) - 1, u(50, 1 << 20, (S, n))],
            (1 << 23) + u(0, 1 << 20, (S, n)),
        ).astype(np.uint32)
        w[:, :, SL] = steps.view(np.float32)
        return w

    out: Dict[str, np.ndarray] = {}
    sc = np.zeros((S, 8), np.int64)
    sc[:, 0], sc[:, 1], sc[:, 2] = u(0, 256, S), u(0, 256, S), u(0, 256, S)
    sc[:, 3], sc[:, 4] = int(decode), int(not_first)
    out["sc"] = sc
    x1 = u(0, 1 << 31, S)
    x2 = x1 + u(1 << 24, 1 << 31, S)  # x1 < x2 < 2^32 and the top bytes differ
    x = x1 + (rng.random(S) * (x2 - x1)).astype(np.int64)
    pos = u(4, 1000, S)
    out["coder"] = np.stack(
        [x1, x2, x, pos, pos + 4, np.zeros(S, np.int64), u(0, 5_000_000, S), u(0, 2, S)], axis=1
    )
    win_r = np.zeros((S, WIN_PAD), np.int64)
    win_r[:, :CODER_WIN] = u(0, 256, (S, CODER_WIN))
    out["win_r"] = win_r
    out["ent"] = (rng.random((S, 1)) * 1000).astype(np.float32)
    if M:
        ns = np.where(rng.random((S, M, 256)) < 0.2, 255, u(0, 256, (S, M, 256)))  # 255: never seen
        rm = np.where(rng.random((S, M, 256)) < 0.2, 0, u(0, 256, (S, M, 256)))
        out["ind_blk"] = (ns | (rm << 8)).astype(np.uint16).view(np.int16)
        out["ind_rot"] = u(0, 256, (S, M)) * np.asarray(meta.ind_rotate, np.int64)[None, :]
        p = f((S, 2 * M, 256), 2.0)
        p[rng.random(p.shape) < 0.01] = -0.0
        out["p_tbl"] = p
    for name, n in (("rows_st", d["Kst"]), ("rows_pos", d["Kp"] * 8), ("rows_cd", d["Kcd"]),
                    ("blocks_pd", d["Kpd"] * 8), ("lm_tbl", d["Tlm"])):
        if n:
            out[name] = rows(n)
    out["max_steps"] = u(1, 1 << 24, (S, K))
    if d["NA"]:
        out["apm_rows"] = (0.01 + 0.98 * rng.random((S, d["NA"], 8 * APM_BINS))).astype(np.float32)
    for head in ("ppm", "lstm"):
        if d[head]:
            probs = rng.random((S, 256)).astype(np.float32) ** 4
            probs[rng.random((S, 256)) < 0.3] = 0.0  # symbols the model excludes
            probs[:, 0] += np.float32(1e-3)
            out[f"{head}_probs"] = probs / probs.sum(axis=1, keepdims=True, dtype=np.float32)
            regs = np.zeros((S, 4), np.int32)
            regs[:, 0], regs[:, 2] = 255, u(0, 256, S)
            out[f"{head}_regs"] = regs
    if NM:
        kind = rng.integers(0, 3, (S, NM))
        out["match_len"] = np.select([kind == 0, kind == 1], [u(0, 3, (S, NM)), u(3, 40, (S, NM))],
                                     u(40, 256, (S, NM))).astype(np.int32)
        out["match_byte"] = u(0, 256, (S, NM))
        mp = (0.01 + 0.98 * rng.random((S, NM, 256))).astype(np.float32)
        mp[rng.random(mp.shape) < 0.01] = -0.0
        out["mt_pred"] = mp
        out["mt_cnt"] = u(1, 500, (S, NM, 256)).astype(np.int32)
    out["ema"] = (rng.random((S, d["nc"])) * 8).astype(np.float32)
    # every input of the layout is there, in its shape
    for name, tail, _, kind in io_layout(meta, True, True)[0]:
        if kind == "s" and out[name].shape != (S,) + tuple(tail):
            raise AssertionError(f"{name}: {out[name].shape} != {(S,) + tuple(tail)}")
    return out


def with_sampling(fin: Dict, seed: int, inv_temp: float, encode_streams: int = 0) -> Dict:
    """A copy of the torch inputs `fin` (of `io_layout(meta, False, ...)`) as
    a sampling step takes them (`io_layout(meta, False, ..., sample=True)`):
    every stream in encode mode, all but the last `encode_streams` of them
    sampling, with seeded uniforms in [0, 1) and `inv_temp` as a one-element
    tensor on the inputs' device."""
    out = {k: v.clone() for k, v in fin.items()}
    sc = out["sc"]
    S, dev = sc.shape[0], sc.device
    sc[:, SC_DECODE] = 0
    sc[:, SC_SAMPLE] = 1
    if encode_streams:
        sc[S - encode_streams:, SC_SAMPLE] = 0
    u = np.random.default_rng(seed).random((S, 8)).astype(np.float32)
    out["sample_u"] = torch.as_tensor(u, device=dev)
    out["inv_temp"] = torch.tensor([[inv_temp]], dtype=torch.float32, device=dev)
    return out
