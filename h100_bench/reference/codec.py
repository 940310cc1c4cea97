"""One stream of a file through the plain byte step, as the program's
`compress_bytes` codes it: the container header, and the code bytes the
coder emits over a prefix of the stream (the whole stream: the flushed
payload).

Frozen copy, at commit 334906b, of what gmix_tpu_torch/core/codec.py does
around the step (`_header`, `_pad_streams`, the chunk loop of
`ChunkFn._eager` and the flush of `_encode_streams`)."""
from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np
import torch

from . import coder as coder_ops
from .config import EnsembleSpec
from .meta import build_meta
from .state import init_state
from .step import StepPlan, _byte_step, lstm_bptt

MAGIC = b"GXTC"
VERSION = 4


def header(spec: EnsembleSpec, S: int, orig: int, per: int) -> bytes:
    """The 40-byte GXTC v4 header of an archive of `orig` bytes in `S`
    streams of `per` byte steps."""
    return MAGIC + struct.pack("<BBHQQQQ", VERSION, 0, S, orig, per, spec.stable_hash(), 0)


def split_streams(data: bytes, S: int, chunk: int) -> np.ndarray:
    """`data` as the program splits it: (S, per) u8, stream s holding bytes
    [s * per, (s + 1) * per), zero-padded, per a multiple of `chunk`."""
    per = -(-max(len(data), 1) // S)
    per = -(-per // chunk) * chunk
    arr = np.zeros((S, per), np.uint8)
    flat = np.frombuffer(data, np.uint8)
    for s in range(S):
        seg = flat[s * per : (s + 1) * per]
        arr[s, : len(seg)] = seg
    return arr


def _float_leaves(tree: Dict, out: List[torch.Tensor]) -> List[torch.Tensor]:
    for v in tree.values():
        if isinstance(v, dict):
            _float_leaves(v, out)
        elif v.dtype == torch.float32:
            out.append(v)
    return out


def _to_bfloat16(state: Dict) -> None:
    """Every float32 leaf of the state rounded to bfloat16 in place: the
    state held in the next precision below the spec's float32 (the
    control's fault)."""
    for leaf in _float_leaves(state, []):
        leaf.copy_(leaf.to(torch.bfloat16).to(torch.float32))


def encode_prefix(spec: EnsembleSpec, row: np.ndarray, n: int, chunk: int, seed: int,
                  bfloat16_state: bool = False) -> bytes:
    """The code bytes that one fresh stream (the LSTM's weights drawn from
    `seed`) emits while it codes the first `n` bytes of `row`, its (per,) u8
    input, in chunks of `chunk`: with an LSTM whose horizon divides `chunk`
    the backward pass runs after every horizon-th byte, otherwise inside the
    byte that wraps the window. With `n == per` the coder's flush follows:
    the stream's whole payload. `bfloat16_state` rounds the state's float
    leaves to bfloat16 after every byte (the control)."""
    per = row.shape[0]
    if not 0 < n <= per:
        raise ValueError(f"{n} bytes of a {per}-byte stream")
    meta = build_meta(spec)
    state = init_state(meta, 1, seed, "cpu")
    plan = StepPlan(meta, 1, "cpu")
    hz = spec.lstm.horizon if spec.lstm is not None else 0
    defer = hz > 0 and chunk % hz == 0
    data = torch.as_tensor(row[None, :].copy())
    code = torch.zeros((1, 1), dtype=torch.uint8)  # encode never reads it
    out = bytearray()
    for t in range(n):
        win, nw = _byte_step(state, data, code, t, False, plan, learn=True, analysis=False, bptt=not defer)
        if defer and (t + 1) % hz == 0:
            lstm_bptt(state, plan)
        if bfloat16_state:
            _to_bfloat16(state)
        out += win[0, : int(nw[0])].numpy().tobytes()
    if len(out) != int(state["coder"]["wpos"][0]):
        raise RuntimeError("the reference's emitted bytes disagree with its coder's write cursor")
    if n == per:
        out += coder_ops.flush_bytes(state["coder"]["x1"].numpy(), state["coder"]["x2"].numpy())[0]
    return bytes(out)
