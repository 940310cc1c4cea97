"""Build the port's CUDA kernels and load them through ctypes.

`gmix_tpu_torch/csrc/*.cu` compile with `nvcc` for `sm_90a` into one shared
library with a plain C interface, `build/libgmix_kernels.so` at the root of
the checkout. Nothing includes PyTorch's headers, so a build takes seconds.
The library is rebuilt when the sources or flags change (a digest sits beside
it) and is built on first use, never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
LIB_PATH = BUILD_DIR / "libgmix_kernels.so"
_DIGEST_PATH = BUILD_DIR / "libgmix_kernels.sha256"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # the kernels move bytes only; no float op may ever be contracted
    "--fmad=false",
    "-Xptxas", "-v",
)


@dataclass
class BuildResult:
    path: Path
    seconds: float
    rebuilt: bool
    log: str  # nvcc's output, including ptxas resource usage


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); cannot build the kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> BuildResult:
    """Compile csrc/*.cu unless the library on disk matches the sources."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = _digest(sources)
    if LIB_PATH.exists() and _DIGEST_PATH.exists() and _DIGEST_PATH.read_text() == digest:
        return BuildResult(LIB_PATH, 0.0, False, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, LIB_PATH)
    _DIGEST_PATH.write_text(digest)
    return BuildResult(LIB_PATH, seconds, True, log)


_lib: Optional[ctypes.CDLL] = None


def load_kernels() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        for name in ("gmix_gather_rows", "gmix_scatter_rows"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64, ptr]
            fn.restype = ctypes.c_int
        lib.gmix_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gmix_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.gmix_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
