"""cmix-style word-replacing dictionary transform.

Behavioural re-implementation of the reference preprocessor
(src/preprocess/dictionary.cpp): a ~44k-word English dictionary is mapped to
1-3 byte codes >= 0x80 in frequency bands of 80/3840/40960 words;
capitalisation is factored out with kCapitalized/kUppercase/kEndUpper control
bytes, "&quot;" gets a dedicated token, control/high bytes are escaped, and
unknown words >= 8 chars fall back to longest dictionary suffix/prefix
matches (dictionary.cpp:163-192).

Two interchangeable engines, giving the same bytes:
- a pure-Python engine (always available, used for tests/small files);
- a native C++ engine (native/dictionary.cc beside this module) compiled on
  first use with g++ into build/libgmixdict.so and loaded via ctypes, for
  production-size inputs.

A copy of `gmix_tpu.preprocess.dictionary`: the transform is host code and
gives the same bytes as gmix_tpu's.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

from ..utils.build import build_host_library

K_CAPITALIZED = 0x40
K_UPPERCASE = 0x07
K_END_UPPER = 0x06
K_ESCAPE = 0x0C
K_QUOTE = 0x08
QUOTE_STR = b"&quot;"

_B1, _B2, _B3, _B4 = 80, 80 + 3840, 80 + 3840 + 40960, 80 + 3840 + 40960 + 81920


def _word_code(i: int) -> bytes:
    """Band encoding of dictionary line i (dictionary.cpp:56-69)."""
    if i < _B1:
        return bytes([0x80 + i])
    if i < _B2:
        j = i - _B1
        return bytes([0xD0 + j // 80, 0x80 + j % 80])
    if i < _B3:
        j = i - _B2
        return bytes([0xF0 + (j // 80) // 32, 0xD0 + (j // 80) % 32, 0x80 + j % 80])
    if i < _B4:
        j = i - _B2
        return bytes([0xD0 + (j // 80) // 32, 0xD0 + (j // 80) % 32, 0x80 + j % 80])
    raise ValueError("dictionary too large")


class Dictionary:
    def __init__(self, dict_bytes: bytes):
        self.byte_map: Dict[bytes, bytes] = {}
        self.reverse_map: Dict[bytes, bytes] = {}
        self.longest = 0
        word = bytearray()
        count = 0
        for c in dict_bytes + b"\n":
            if ord("a") <= c <= ord("z"):
                word.append(c)
            elif word:
                w = bytes(word)
                self.longest = max(self.longest, len(w))
                code = _word_code(count)
                self.byte_map[w] = code
                self.reverse_map[code] = w
                count += 1
                word.clear()

    # --- encode: tokenize (case-folded words / literals / &quot;) then emit --
    def _tokenize(self, data: bytes):
        """Yield (kind, payload) tokens: ('b', byte), ('q', None), or
        ('w', (lowercased word, caps, end_upper)) with caps in
        {0: none, 1: Capitalized, 2: ALL-CAPS}.

        A word is a maximal letter run that is all-lowercase, Capitalized, or
        ALL-CAPS, and also closes when it outgrows the longest dictionary
        entry. The "&quot;" cursor runs concurrently with word building: its
        first five bytes still feed the word machine and the terminating ';'
        retroactively replaces their accumulation with one quote token (the
        '&' was already flushed as a literal)."""
        lo_a, lo_z, up_a, up_z = ord("a"), ord("z"), ord("A"), ord("Z")
        word = bytearray()
        uppers = lowers = quote_pos = 0
        tokens = []

        def close(followed_by_lower: bool):
            nonlocal uppers, lowers
            if word:
                caps = 2 if uppers > 1 else 1 if uppers == 1 else 0
                tokens.append(
                    ("w", (bytes(word), caps, caps == 2 and followed_by_lower))
                )
                word.clear()
            uppers = lowers = 0

        for c in data:
            if c == QUOTE_STR[quote_pos]:
                quote_pos += 1
                if quote_pos == len(QUOTE_STR):
                    word.clear()
                    uppers = lowers = quote_pos = 0
                    tokens.append(("q", None))
                    continue
            else:
                quote_pos = 0  # no restart-on-mismatch: matches the format
            lo = lo_a <= c <= lo_z
            up = up_a <= c <= up_z
            if len(word) <= self.longest and ((lo and uppers <= 1) or (up and lowers == 0)):
                word.append(c if lo else c - up_a + lo_a)
                if lo:
                    lowers += 1
                else:
                    uppers += 1
                continue
            close(followed_by_lower=lo)
            if lo:
                word.append(c)
                lowers = 1
            elif up:
                word.append(c - up_a + lo_a)
                uppers = 1
            else:
                tokens.append(("b", c))
        close(followed_by_lower=False)
        return tokens

    def _emit_literal(self, c: int, out: bytearray) -> None:
        if c in (K_END_UPPER, K_ESCAPE, K_UPPERCASE, K_CAPITALIZED, K_QUOTE) or c >= 0x80:
            out.append(K_ESCAPE)
        out.append(c)

    def _emit_partial(self, word: bytes, out: bytearray) -> bool:
        """Longest dictionary suffix, then longest prefix, both >= 7 chars and
        strictly shorter than the word; unmatched chars pass raw."""
        if len(word) <= 7:
            return False
        window = min(len(word) - 1, self.longest)
        for ln in range(window, 6, -1):
            code = self.byte_map.get(word[len(word) - ln :])
            if code is not None:
                out += word[: len(word) - ln]
                out += code
                return True
        for ln in range(window, 6, -1):
            code = self.byte_map.get(word[:ln])
            if code is not None:
                out += code
                out += word[ln:]
                return True
        return False

    def encode(self, data: bytes) -> bytes:
        out = bytearray()
        for kind, payload in self._tokenize(data):
            if kind == "q":
                out.append(K_QUOTE)
            elif kind == "b":
                self._emit_literal(payload, out)
            else:
                word, caps, end_upper = payload
                if caps == 2:
                    out.append(K_UPPERCASE)
                elif caps == 1:
                    out.append(K_CAPITALIZED)
                code = self.byte_map.get(word)
                if code is not None:
                    out += code
                elif not self._emit_partial(word, out):
                    out += word
                if end_upper:
                    out.append(K_END_UPPER)
        return bytes(out)

    # --- decode -----------------------------------------------------------
    def decode(self, data: bytes) -> bytes:
        out = bytearray()
        upper = capital = False
        i = 0
        n = len(data)
        while i < n:
            c = data[i]
            i += 1
            if c == K_ESCAPE:
                upper = False
                if i < n:
                    out.append(data[i])
                    i += 1
            elif c == K_QUOTE:
                out += QUOTE_STR[1:]
            elif c == K_UPPERCASE:
                upper = True
            elif c == K_CAPITALIZED:
                capital = True
            elif c == K_END_UPPER:
                upper = False
            elif c >= 0x80:
                code = bytes([c])
                if c > 0xCF and i < n:
                    c2 = data[i]
                    i += 1
                    code += bytes([c2])
                    if c2 > 0xCF and i < n:
                        code += bytes([data[i]])
                        i += 1
                word = bytearray(self.reverse_map.get(code, b""))
                for k in range(len(word)):
                    if k == 0 and capital:
                        word[k] = word[k] - ord("a") + ord("A")
                        capital = False
                    if upper:
                        word[k] = word[k] - ord("a") + ord("A")
                out += word
            else:
                if not (ord("a") <= c <= ord("z") or ord("A") <= c <= ord("Z")):
                    upper = False
                if capital or upper:
                    c = c - ord("a") + ord("A")
                if capital:
                    capital = False
                out.append(c)
        return bytes(out)


# --- native engine ---------------------------------------------------------

_SRC = Path(__file__).resolve().parent / "native" / "dictionary.cc"
_lib: Optional[ctypes.CDLL] = None


def _load_native() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build_host_library(_SRC, "libgmixdict.so")))
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.gd_new.restype = ctypes.c_void_p
    lib.gd_new.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.gd_free.argtypes = [ctypes.c_void_p]
    for fn in (lib.gd_encode, lib.gd_decode):
        fn.restype = ctypes.c_longlong
        fn.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_char_p,
            ctypes.c_size_t,
        ]
    _lib = lib
    return lib


class NativeDictionary:
    """ctypes wrapper over the C++ engine; falls back to None if unbuildable."""

    def __init__(self, dict_bytes: bytes):
        lib = _load_native()
        if lib is None:
            raise RuntimeError("native dictionary engine unavailable")
        self._lib = lib
        self._h = lib.gd_new(dict_bytes, len(dict_bytes))

    def __del__(self):
        try:
            self._lib.gd_free(self._h)
        except Exception:
            pass

    def _run(self, fn, data: bytes, factor: int) -> bytes:
        cap = len(data) * factor + 1024
        out = ctypes.create_string_buffer(cap)
        got = fn(self._h, data, len(data), out, cap)
        if got < 0:
            raise RuntimeError("native dictionary buffer overflow")
        return out.raw[:got]

    def encode(self, data: bytes) -> bytes:
        return self._run(self._lib.gd_encode, data, 3)

    def decode(self, data: bytes) -> bytes:
        return self._run(self._lib.gd_decode, data, 40)


def load(path: Optional[str] = None, native: bool = True):
    """Load the english dictionary transform (vendored asset by default)."""
    if path is None:
        path = os.path.join(
            os.path.dirname(os.path.dirname(__file__)), "assets", "english.dic"
        )
    data = open(path, "rb").read()
    if native:
        try:
            return NativeDictionary(data)
        except RuntimeError:
            pass
    return Dictionary(data)
