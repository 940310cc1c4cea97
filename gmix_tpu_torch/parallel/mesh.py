"""Streams across devices: for now the one piece that needs no second device.

Counterpart of `gmix_tpu.parallel.mesh`. Every state tensor carries the
streams on axis 0 and no step mixes streams, so a state of one stream is
tiled to S streams by repeating it along that axis. Sharding the streams
over devices and processes comes later.
"""
from __future__ import annotations

from typing import Dict


def broadcast_pretrained(single_stream_state: Dict, num_streams: int) -> Dict:
    """Tile a 1-stream state (a trained checkpoint) to `num_streams` streams,
    every stream a copy of the one (gmix_tpu's `broadcast_pretrained`, without
    the mesh). Scalar leaves (the LSTM's epoch and step count, shared by all
    streams) pass through. The result shares no tensor with the input."""

    def tile(x):
        if isinstance(x, dict):
            return {k: tile(v) for k, v in x.items()}
        if x.dim() >= 1 and x.shape[0] == 1:
            return x.expand((num_streams,) + tuple(x.shape[1:])).clone()
        return x.clone()

    return tile(single_stream_state)

