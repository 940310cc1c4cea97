"""Streams across processes: `torch.distributed` and one archive from all ranks.

Counterpart of `gmix_tpu.parallel.distributed`. The model is the one of
`parallel.mesh`: the streams are the data-parallel axis, each rank owns a
contiguous block of S / world of them, and a byte step has no operation
across streams. So a rank needs no other rank until its streams are coded;
then the per-stream payloads are all-gathered in stream order into ONE
container, byte for byte the one-process archive (gmix_tpu generalises the
reference's 5-byte length framing, runner-utils.cpp:22-36, the same way).

Each rank runs on `cuda:(rank % device_count)`, so several ranks may share a
card, or on the CPU where the caller says so (`device="cpu"`). Collectives
go over `nccl` (the default: tensors on the rank's card) or `gloo` (CPU
tensors: the CPU tests, or several ranks on one card). Nothing falls back
to the CPU on its own. The world's address, size and rank are the caller's:
nothing on a machine announces a cluster.

There is no multi-process decompress, as in gmix_tpu: the container decodes
through the ordinary `decompress_bytes`.
"""
from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import EnsembleSpec
from ..core.codec import Predictor, _encode_streams, _header, _pad_streams
from ..state import DEFAULT_SEED, init_state
from .mesh import Mesh, shard_rows


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the process group (`torch.distributed.init_process_group`; e.g.
    `init_method="tcp://localhost:29500"` with the world size and this
    rank, or the `env://` variables). The backend is `nccl` unless the
    caller asks for `gloo`. Where there is a CUDA device the rank's card,
    `cuda:(rank % device_count)`, becomes the current device, so that the
    codec's default device is it."""
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("initialize: the nccl backend needs a CUDA device; ask for backend='gloo' on the CPU")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    if torch.cuda.is_available():
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def rank_device(rank: int, device=None) -> torch.device:
    """Rank `rank`'s device: `device` where the caller names one (the CPU),
    else `cuda:(rank % device_count)`. Raises without a CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device for the rank; pass device="cpu" to run the ranks on the CPU')
    return torch.device("cuda", rank % torch.cuda.device_count())


def global_mesh(axis: str = "streams", device=None) -> Mesh:
    """Every rank's device (`rank_device`), in rank order."""
    return Mesh(tuple(rank_device(r, device) for r in range(dist.get_world_size())), axis)


def make_global_state(meta, S: int, mesh: Mesh, seed: Optional[int] = None) -> Dict:
    """This rank's part of a state of S streams over `mesh`: `init_state` of
    its S / world streams on its device. Init is the same for every stream
    (the LSTM's threefry weights included), so a rank's rows are the first
    S / world rows of a whole state's and no rank makes another's."""
    rank = dist.get_rank()
    a, b = shard_rows(S, mesh)[rank]
    return init_state(meta, b - a, DEFAULT_SEED if seed is None else seed, mesh.devices[rank])


def _all_gather(t: torch.Tensor, world: int):
    out = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(out, t)
    return out


def compress_bytes_multihost(data: bytes, spec: EnsembleSpec, num_streams: int, chunk: int = 4096,
                             device=None) -> bytes:
    """Full-file compression over every rank of the process group. All ranks
    call it with the same arguments; each codes its block of streams on its
    device (`rank_device`: its card, or `device="cpu"`) and every rank
    returns the complete container, byte for byte `compress_bytes(data,
    spec, num_streams, chunk)` of one process: where a stream runs does not
    change its bytes. The payload sizes and bytes are all-gathered as
    tensors on the backend's device (the rank's card for nccl, the CPU for
    gloo)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = global_mesh(device=device)
    dev = mesh.devices[rank]
    backend = dist.get_backend()
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"compress_bytes_multihost: the nccl backend gathers CUDA tensors, the rank runs on {dev}")
    orig = len(data)
    if orig == 0:
        return _header(spec, num_streams, 0, 0)
    a, b = shard_rows(num_streams, mesh)[rank]
    arr, per = _pad_streams(data, num_streams, chunk)
    pred = Predictor(spec, b - a, device=dev)
    payloads = _encode_streams(pred, arr[a:b], chunk)

    # ordered gather: every rank's payload sizes, then its bytes padded to
    # the longest rank's
    comm = dev if backend == "nccl" else torch.device("cpu")
    sizes = torch.cat(_all_gather(torch.tensor([len(p) for p in payloads], dtype=torch.int64, device=comm), world))
    sizes = sizes.cpu().tolist()
    n_local = len(payloads)
    longest = max(sum(sizes[r * n_local : (r + 1) * n_local]) for r in range(world))
    mine = np.zeros(longest, np.uint8)
    body = b"".join(payloads)
    mine[: len(body)] = np.frombuffer(body, np.uint8)
    gathered = _all_gather(torch.as_tensor(mine, device=comm), world)
    blobs = [g.cpu().numpy()[: sum(sizes[r * n_local : (r + 1) * n_local])].tobytes() for r, g in enumerate(gathered)]
    return _header(spec, num_streams, orig, per) + struct.pack(f"<{num_streams}Q", *sizes) + b"".join(blobs)
