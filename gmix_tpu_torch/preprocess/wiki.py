"""enwik9-style Wikipedia-dump preprocessing (STARLIT-pipeline equivalent).

Python driver for the native transform in native/wikiprep.cc — the functional
equivalent of the reference's `enwik9-prep c/d` tool
(reference: src/runner/enwik9-prep.cpp:50-75): structural intro/articles/coda
split, similarity-order article reordering with redirect-aware id remapping,
WIT-style header/lang side streams with <id> delta + timestamp re-encoding,
and HTML-entity compaction. The native encoder self-verifies
decode(encode(x)) == x and falls back to a stored container, so the inverse is
byte-exact on arbitrary inputs, not only on enwik9.

The similarity order file is the reference's data asset
(article_order/enwik9_article_order, copied to gmix_tpu_torch/assets/);
`encode_file` uses it unless `order_path` names another.

A copy of `gmix_tpu.preprocess.wiki`: native/wikiprep.cc beside this module
is compiled on first use with g++ into build/libgmixwiki.so, and the
transform gives the same bytes as gmix_tpu's.
"""
from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional

from ..utils.build import build_host_library

_SRC = Path(__file__).resolve().parent / "native" / "wikiprep.cc"
_lib: Optional[ctypes.CDLL] = None

DEFAULT_ORDER = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "assets", "enwik9_article_order"
)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_host_library(_SRC, "libgmixwiki.so")))
    lib.wp_encode.restype = ctypes.c_longlong
    lib.wp_encode.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_int,
    ]
    lib.wp_decode.restype = ctypes.c_longlong
    lib.wp_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_char_p,
        ctypes.c_size_t,
    ]
    _lib = lib
    return lib


def encode(data: bytes, order: bytes = b"", verify: bool = True) -> bytes:
    """Forward transform. `order` is the similarity-order file's contents
    (one non-redirect article index per line); empty keeps original order."""
    lib = _load()
    cap = len(data) * 2 + (1 << 16)
    out = ctypes.create_string_buffer(cap)
    r = lib.wp_encode(data, len(data), order, len(order), out, cap, 1 if verify else 0)
    if r < 0:
        raise RuntimeError(f"wp_encode failed ({r})")
    return out.raw[:r]


def decode(blob: bytes, orig_hint: Optional[int] = None) -> bytes:
    lib = _load()
    cap = (orig_hint or len(blob) * 4) + (1 << 16)
    while True:
        out = ctypes.create_string_buffer(cap)
        r = lib.wp_decode(blob, len(blob), out, cap)
        if r == -1:  # output overflow: grow and retry
            cap *= 2
            continue
        if r < 0:
            raise RuntimeError(f"wp_decode failed ({r})")
        return out.raw[:r]


def encode_file(in_path: str, out_path: str, order_path: Optional[str] = None,
                verify: bool = True) -> int:
    data = open(in_path, "rb").read()
    order = b""
    path = order_path or (DEFAULT_ORDER if os.path.exists(DEFAULT_ORDER) else None)
    if path:
        order = open(path, "rb").read()
    blob = encode(data, order, verify=verify)
    open(out_path, "wb").write(blob)
    return len(blob)


def decode_file(in_path: str, out_path: str) -> int:
    blob = open(in_path, "rb").read()
    out = decode(blob)
    open(out_path, "wb").write(out)
    return len(out)
