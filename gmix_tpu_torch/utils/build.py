"""Build the port's CUDA kernels (ops/kernels.py loads them through ctypes);
build the preprocessors' host libraries (`build_host_library`).

`gmix_tpu_torch/csrc/*.cu` compile with `nvcc` for `sm_90a`, one process per
object and all at once, and link into one shared library with a plain C
interface, `build/libgmix_kernels.so` at the root of the checkout. A source
listed in `VARIANTS` is compiled once per set of `-D` flags: the fused
kernel's instantiations build side by side. Nothing
includes PyTorch's headers, so a build takes seconds. The library is rebuilt
when any file under csrc/ or the flags change (a digest sits beside it) and
is built on first use, never at import.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
LIB_PATH = BUILD_DIR / "libgmix_kernels.so"
_DIGEST_PATH = BUILD_DIR / "libgmix_kernels.sha256"

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *_ARCH,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # no float op may ever be contracted: the codec's archives depend on
    # every rounding (the kernels also pin each op with an intrinsic)
    "--fmad=false",
    "-Xptxas", "-v",
)


# source -> {object tag: extra flags}; any other source gives one object
VARIANTS = {
    "fused_inst.cu": {f"q{q}t{t}": (f"-DGMIX_Q={q}", f"-DGMIX_TABLES={t}") for q in (1, 2, 4, 8, 16) for t in (0, 1)},
}


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


def _digest() -> str:
    """Over the flags and every file under csrc/ (sources and headers)."""
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(VARIANTS)).encode())
    for src in sorted(p for p in CSRC_DIR.rglob("*") if p.is_file()):
        h.update(str(src.relative_to(CSRC_DIR)).encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> BuildResult:
    """Compile csrc/*.cu unless the library on disk matches csrc/."""
    digest = _digest()
    if LIB_PATH.exists() and _DIGEST_PATH.exists() and _DIGEST_PATH.read_text() == digest:
        return BuildResult(LIB_PATH, 0.0, False, "")
    sources = sorted(CSRC_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}.tmp"
    units = []  # (source, object, extra flags)
    for src in sources:
        for name, flags in VARIANTS.get(src.name, {"": ()}).items():
            units.append((src, BUILD_DIR / f"{src.stem}{name and '_' + name}.{tag}.o", flags))
    objs = [obj for _, obj, _ in units]
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{tag}")
    t0 = time.perf_counter()
    try:
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj, flags in units
        ]
        log = ""
        failed = []
        for (src, _, flags), proc in zip(units, procs):
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                failed.append(" ".join((src.name, *flags)))
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n{log}")
        os.replace(tmp, LIB_PATH)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    _DIGEST_PATH.write_text(digest)
    return BuildResult(LIB_PATH, time.perf_counter() - t0, True, log)


def build_host_library(src: Path, name: str) -> Path:
    """`build/<name>` from the C++ source `src` (g++, no CUDA), compiled when
    it is missing or older than `src`. The library is written under a name of
    this process's own and renamed into place, so processes that build it at
    the same time never load a half-written file."""
    lib = BUILD_DIR / name
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-std=c++17", "-O2", "-fPIC", "-shared", str(src), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib
