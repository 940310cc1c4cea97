"""The one generator of the benchmark's traffic: whole files, coded back to
back in a closed loop (one job: reset, compress, reset, decompress, check).

A mix (traffic/<name>.json) gives:

- `corpus`: a file under h100_bench/data/ that the segments are cut from;
- `streams` S and `bytes_per_stream` L: a job's file is S segments of L
  bytes, coded in S streams, one segment a stream (`compress_bytes` splits
  a file into S equal blocks);
- `chunk`: the compiled chunk the codec runs (a multiple of the LSTM's
  horizon defers its backward pass to every horizon-th byte);
- `check_streams`, `check_bytes`: how many streams, drawn from the seed one
  from each of as many equal blocks, the reference codes, and over how many
  leading bytes of each (check.py);
- `trace_steps`: the encode byte steps a `--trace 1` run traces.

The segments sit at fixed places: the centres of S equal parts of the
corpus. The seed only permutes which stream codes which segment, so every
seed codes the same set of bytes in another order and the work, and the
archive's total size up to the LSTM's seeded weights, do not change with
the seed."""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .registry import HERE

FIELDS = ("corpus", "streams", "bytes_per_stream", "chunk", "check_streams", "check_bytes", "trace_steps")


def validate(mix: dict) -> None:
    missing = [k for k in FIELDS if k not in mix]
    if missing:
        raise ValueError(f"traffic mix lacks {missing}")
    S, L, chunk = mix["streams"], mix["bytes_per_stream"], mix["chunk"]
    if S < 1 or L < 1 or chunk < 1 or L % chunk:
        raise ValueError(f"traffic mix: {S} streams of {L} bytes in chunks of {chunk} (L must be a chunk multiple)")
    if not 1 <= mix["check_bytes"] <= L or mix["check_streams"] < 1:
        raise ValueError("traffic mix: check_bytes must lie in [1, bytes_per_stream], check_streams >= 1")
    if not 0 < mix["trace_steps"] <= L:
        raise ValueError("traffic mix: trace_steps must lie in (0, bytes_per_stream]")


def segments(mix: dict, base: Path = HERE) -> list:
    """The S segments of L bytes, in corpus order: segment i centred on the
    centre of the i-th of S equal parts (a read past the end wraps)."""
    corpus = (Path(base) / "data" / mix["corpus"]).read_bytes()
    S, L, N = mix["streams"], mix["bytes_per_stream"], len(corpus)
    if L > N:
        raise ValueError(f"segments of {L} bytes from a {N}-byte corpus")
    ring = corpus + corpus[:L]
    return [ring[start : start + L] for start in (((2 * i + 1) * N // (2 * S) - L // 2) % N for i in range(S))]


def seed_rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([seed & (2**64 - 1), *salt])


def make_file(mix: dict, seed: int, base: Path = HERE) -> bytes:
    """The job's file for `seed`: stream s codes segment perm[s] of a
    permutation drawn from the seed."""
    validate(mix)
    segs = segments(mix, base)
    perm = seed_rng(seed, 0).permutation(len(segs))
    return b"".join(segs[int(i)] for i in perm)


def check_streams(mix: dict, seed: int) -> list:
    """The streams the reference codes: one drawn from the seed in each of
    min(S, check_streams) equal blocks of the streams."""
    S = mix["streams"]
    m = min(S, mix["check_streams"])
    rng = seed_rng(seed, 1)
    return [int(rng.choice(block)) for block in np.array_split(np.arange(S), m)]
