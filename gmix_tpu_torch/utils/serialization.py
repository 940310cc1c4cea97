"""Checkpoints: the codec state as one flat zip archive of `.npy` members.

Carried over from `gmix_tpu.utils.serialization` (numpy and zipfile only), so
that a checkpoint is the same file in both packages: a state written by one
loads in the other leaf for leaf, and the port writes, byte for byte, the
file gmix_tpu writes from the same state. The port's tensors go to disk with
gmix_tpu's dtypes (`state.state_to_numpy`: u32 and u16 leaves restored) and
come back as numpy for `state.state_from_numpy`.

Layout: members are named by the '/'-joined path of their leaf and sorted,
stored uncompressed with a fixed date; a 0-d leaf is a `.npy0` member (numpy
reads a 0-d array back as shape (1,)). A leaf of at least SPARSE_MIN_BYTES
whose dominant value (found by sampling, then counted exactly) covers at
least SPARSE_THRESHOLD of it is stored as `.sp.idx` (flat indices of the
other elements), `.sp.val`, `.sp.fill` and `.sp.shape`; a state whose arenas
are still mostly at their initial value shrinks by more than 10x.

The zip comment carries the format version; a foreign or older file raises
CheckpointVersionError. save -> load -> save is byte-identical.
"""
from __future__ import annotations

import io
import zipfile
from typing import Any, Dict

import numpy as np

from ..state import state_to_numpy

CKPT_VERSION = 3
_COMMENT_PREFIX = b"gmix-tpu-ckpt v"
SPARSE_THRESHOLD = 0.75  # dominant-value fraction above which a leaf goes sparse
SPARSE_MIN_BYTES = 1 << 20  # no sparse encoding below 1 MiB


class CheckpointVersionError(RuntimeError):
    pass


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return root


def _dominant_value(arr: np.ndarray):
    """Candidate fill value by sampling, or None for an empty array."""
    flat = arr.reshape(-1)
    if flat.size == 0:
        return None
    sample = flat[:: max(1, flat.size // 4096)]
    vals, counts = np.unique(sample, return_counts=True)
    return vals[np.argmax(counts)]


def _write_npy(zf: zipfile.ZipFile, name: str, arr: np.ndarray) -> None:
    buf = io.BytesIO()
    np.lib.format.write_array(buf, np.ascontiguousarray(arr))
    zi = zipfile.ZipInfo(name, date_time=(1980, 1, 1, 0, 0, 0))
    zf.writestr(zi, buf.getvalue())


def save_state(path: str, state: Any) -> None:
    """Write the port's `state` to `path`, with gmix_tpu's dtypes."""
    flat = _flatten(state_to_numpy(state))
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.comment = _COMMENT_PREFIX + str(CKPT_VERSION).encode()
        for key in sorted(flat):
            arr = flat[key]
            if arr.ndim == 0:
                _write_npy(zf, key + ".npy0", arr)
                continue
            if arr.nbytes >= SPARSE_MIN_BYTES:
                fill = _dominant_value(arr)
                flatv = arr.reshape(-1)
                if fill is not None:
                    # NaN never equals itself; such leaves stay dense
                    exc = np.flatnonzero(flatv != fill)
                    if flatv.size - exc.size >= SPARSE_THRESHOLD * flatv.size:
                        idx = exc.astype(np.uint32 if flatv.size <= 0xFFFFFFFF else np.uint64)
                        _write_npy(zf, key + ".sp.idx", idx)
                        _write_npy(zf, key + ".sp.val", flatv[exc])
                        _write_npy(zf, key + ".sp.fill", fill.reshape(1))
                        _write_npy(zf, key + ".sp.shape", np.asarray(arr.shape, np.int64))
                        continue
            _write_npy(zf, key + ".npy", arr)


def load_state(path: str) -> Any:
    """The state in `path` as a nested dict of numpy arrays with gmix_tpu's
    dtypes (`state.state_from_numpy` makes the port's tensors of it)."""
    flat: Dict[str, np.ndarray] = {}
    sparse: Dict[str, Dict[str, np.ndarray]] = {}
    with zipfile.ZipFile(path, "r") as zf:
        comment = zf.comment
        if not comment.startswith(_COMMENT_PREFIX):
            raise CheckpointVersionError(
                f"{path}: not a gmix-tpu v{CKPT_VERSION} checkpoint (it predates "
                "the versioned format or is a foreign file); re-create it with "
                "this build"
            )
        ver = int(comment[len(_COMMENT_PREFIX):])
        if ver != CKPT_VERSION:
            raise CheckpointVersionError(
                f"{path}: incompatible checkpoint version {ver} (this build "
                f"reads v{CKPT_VERSION}); re-create the checkpoint"
            )
        for name in zf.namelist():
            with zf.open(name) as f:
                arr = np.lib.format.read_array(f)
            if name.endswith(".npy0"):
                flat[name[: -len(".npy0")]] = arr.reshape(())
            elif name.endswith(".npy"):
                flat[name[: -len(".npy")]] = arr
            else:
                base, _, part = name.rpartition(".sp.")
                sparse.setdefault(base, {})[part] = arr
    for base, parts in sparse.items():
        shape = tuple(int(x) for x in parts["shape"])
        fill = parts["fill"][0]
        out = np.full(int(np.prod(shape)) if shape else 1, fill, dtype=fill.dtype)
        out[parts["idx"].astype(np.int64)] = parts["val"]
        flat[base] = out.reshape(shape)
    return _unflatten(flat)


def copy_state(state: Any) -> Any:
    """A copy of the port's state that shares no tensor with it (the byte
    step writes the state in place)."""
    return {k: copy_state(v) if isinstance(v, dict) else v.clone() for k, v in state.items()}
