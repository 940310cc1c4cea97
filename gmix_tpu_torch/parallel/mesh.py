"""Streams across devices: a mesh of devices, the placement of a state on it,
and the tiling of a trained one-stream state.

Counterpart of `gmix_tpu.parallel.mesh`. Every state tensor carries the
streams on axis 0 and no byte step mixes streams, so the codec is data
parallel over the streams: a mesh of n devices holds n contiguous blocks of
S / n streams, and every other leaf (the LSTM's 0-d `epoch` and
`update_steps`, shared by all streams) is replicated, as gmix_tpu's
`_state_specs` places them.

gmix_tpu's `make_sharded_chunk_fn` and `make_sharded_gen_fn` are a
sharded `core.codec.Predictor`'s `chunk_fn` and `gen_fn`: every shard's own
unsharded predictor (its state, its `StepPlan`, its device) runs its own
compiled chunk, CUDA graphs captured on its device, in turn. JAX needed
`shard_map` because a jitted chunk program fed stream-sharded arrays kept
global stream indices against local shards in its row scatters, and
dropped the writes; the port has no such trap, since each shard runs the
unsharded step on its own local tensors and never sees a global index.

A mesh may name one device more than once: `["cpu"] * 4` gives four shards
on the CPU (as gmix_tpu's tests use 8 virtual CPU devices), and
`["cuda:0", "cuda:0"]` two shards on one card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """An ordered list of devices along one axis, the streams'."""

    devices: Tuple[torch.device, ...]
    axis: str = "streams"

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclass(frozen=True)
class StreamSharding:
    """Axis 0 (the streams) of every state leaf split over `mesh`; 0-d
    leaves replicated (gmix_tpu: `NamedSharding(mesh, P(axis))`)."""

    mesh: Mesh


def make_mesh(n_devices: Optional[int] = None, axis: str = "streams", devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of `devices`, or of the first `n_devices` CUDA devices (all of
    them by default). Raises when there are fewer CUDA devices; the CPU is
    never a substitute (name it in `devices` to ask for it)."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = count if n_devices is None else n_devices
        if count == 0 or n > count:
            raise RuntimeError(
                f"make_mesh: {n or 'any'} CUDA devices asked for, {count} present; "
                'pass devices=["cpu"] * n for a mesh on the CPU'
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [torch.device(d) for d in devices]
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"make_mesh: n_devices={n_devices} but {len(devices)} devices given")
    if not devices:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return Mesh(tuple(devices), axis)


def stream_sharding(mesh: Mesh) -> StreamSharding:
    """Shard axis 0 (streams) of every tensor; 0-d leaves replicate."""
    return StreamSharding(mesh)


def shard_rows(num_streams: int, mesh: Mesh) -> List[Tuple[int, int]]:
    """The stream rows [a, b) of each mesh entry, in order. Raises unless
    the mesh's size divides `num_streams`."""
    n = mesh.size
    if num_streams % n:
        raise ValueError(f"{num_streams} streams do not split over a mesh of {n} devices")
    per = num_streams // n
    return [(i * per, (i + 1) * per) for i in range(n)]


def _splits(x: torch.Tensor, num_streams: int) -> bool:
    """gmix_tpu's `_state_specs` rule: a leaf with the streams on axis 0 is
    split, every other leaf replicated."""
    return x.dim() >= 1 and x.shape[0] == num_streams


def state_specs(state: Dict, num_streams: int, axis: str = "streams") -> Dict:
    """Per-leaf placement of a state of `num_streams` streams: `axis` for a
    leaf split over the mesh, None for a replicated one (gmix_tpu's
    `_state_specs`: `P(axis)` and `P()`)."""
    return {k: state_specs(v, num_streams, axis) if isinstance(v, dict) else (axis if _splits(v, num_streams) else None)
            for k, v in state.items()}


def _map(tree: Dict, fn) -> Dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _leaf_list(tree: Dict) -> List[torch.Tensor]:
    out = []
    for v in tree.values():
        out.extend(_leaf_list(v) if isinstance(v, dict) else [v])
    return out


def shard_state(state: Dict, mesh: Mesh) -> List[Dict]:
    """One state per mesh entry, in stream order, each on its device: the
    entry's block of streams of every split leaf and a copy of every
    replicated one. No shard shares a tensor with `state` or another shard."""
    S = next(v for v in _leaf_list(state) if v.dim() >= 1).shape[0]
    return [_map(state, lambda x, a=a, b=b, d=d: (x[a:b] if _splits(x, S) else x).to(d, copy=True))
            for (a, b), d in zip(shard_rows(S, mesh), mesh.devices)]


def gather_state(shards: Sequence[Dict], device="cpu") -> Dict:
    """The inverse of `shard_state`: one state on `device`, the shards'
    streams concatenated in order. A replicated leaf must be equal in every
    shard (the step updates it alike in each); the result takes shard 0's."""
    local = next(v for v in _leaf_list(shards[0]) if v.dim() >= 1).shape[0]

    def gather(path, leaves):
        if _splits(leaves[0], local):
            return torch.cat([x.to(device) for x in leaves])
        for i, x in enumerate(leaves[1:], 1):
            if not torch.equal(x.cpu(), leaves[0].cpu()):
                raise RuntimeError(f"gather_state: replicated leaf {'/'.join(path)} differs between shards 0 and {i}")
        return leaves[0].to(device, copy=True)

    def walk(trees, path):
        return {k: walk([t[k] for t in trees], path + (k,)) if isinstance(trees[0][k], dict)
                else gather(path + (k,), [t[k] for t in trees]) for k in trees[0]}

    return walk(list(shards), ())


def _tile(state: Dict, num_streams: int, device=None) -> Dict:
    def tile(x):
        if device is not None:
            x = x.to(device)
        if x.dim() >= 1 and x.shape[0] == 1:
            return x.expand((num_streams,) + tuple(x.shape[1:])).clone()
        return x.clone()

    return _map(state, tile)


def broadcast_pretrained(single_stream_state: Dict, num_streams: int, mesh: Optional[Mesh] = None):
    """Tile a 1-stream state (a trained checkpoint) to `num_streams` streams,
    every stream a copy of the one (gmix_tpu's `broadcast_pretrained`).
    Scalar leaves (the LSTM's epoch and step count, shared by all streams)
    pass through. The result shares no tensor with the input. With a mesh,
    the tiled state comes placed as `shard_state` places it: one state of
    `num_streams / mesh.size` streams per mesh entry, each tiled on its own
    device (the whole tiled state is never made on one device)."""
    if mesh is None:
        return _tile(single_stream_state, num_streams)
    rows = shard_rows(num_streams, mesh)
    return [_tile(single_stream_state, b - a, d) for (a, b), d in zip(rows, mesh.devices)]
