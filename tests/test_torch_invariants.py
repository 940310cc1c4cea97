"""The analysis invariant of tests/test_invariants.py against the port
(predictor.cpp:422-503): the per-column entropy EMA has one column per
prediction, L0/L1 mixer and the final output, stays finite, and the final
column improves while learning on compressible data; memory_report gives
each leaf at gmix_tpu's bytes, less than the device's (memory_bytes(): the
u32 lanes the port carries as int64). The same 2048 bytes, one stream, chunk
256, on the CPU.
"""
import numpy as np
import torch

import gmix_tpu_torch as gt
from gmix_tpu_torch.core.codec import analysis_columns, analysis_snapshot, memory_report
from gmix_tpu_torch.state import state_bytes, state_to_numpy

torch.set_num_threads(1)

DATA = (
    b"Compression is the art of prediction; prediction, the art of memory. " * 30
)[:2048]
CHUNK = 256


def _arrays(tree):
    for v in tree.values():
        yield from _arrays(v) if isinstance(v, dict) else (v,)


def test_analysis_ema_tracks_models():
    spec = gt.tiny_spec(with_lstm=True)
    pred = gt.Predictor(spec, 1, device="cpu")
    cols = analysis_columns(spec)
    gt.compress_bytes(DATA, spec, 1, CHUNK, pred=pred)
    snap = analysis_snapshot(pred)
    assert snap.shape == (1, len(cols))
    assert np.all(np.isfinite(snap))
    assert "final" in cols and cols.index("final") == len(cols) - 1
    # the mixed output must beat a fair coin on this highly repetitive input
    assert snap[0, -1] < 0.9
    rows = memory_report(pred)
    gmix = sum(a.size * a.dtype.itemsize for a in _arrays(state_to_numpy(pred.state)))
    assert sum(b for _, b in rows) == gmix < pred.memory_bytes() == state_bytes(pred.state)
