"""How `correct` is decided: the program's archive against the plain
reference (h100_bench/reference), its decodes against the file, and every
job's archive against the first.

The reference codes the first `check_bytes` bytes of a few streams, one
drawn from the seed in each of as many equal blocks of the streams
(`traffic.check_streams`), each in a process of its own on the CPU, once the
program's state is freed. Its code bytes must equal the start of each of
those streams' payloads byte for byte, and the header must be the one the
file and the spec give. The streams are independent replicas of one model,
so a stream's bytes depend on its own input alone.

Every number compared has the limit 0: the codec is exact, and the
reference is bit for bit the program's arithmetic in plain torch."""
from __future__ import annotations

import multiprocessing
import struct
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

HEADER = 40  # MAGIC, version, flags, streams, orig, per, spec hash, reserved

LIMITS = {"archive_mismatch_bytes": 0, "job_archive_diffs": 0, "decode_mismatch_bytes": 0}


def payloads(blob: bytes, S: int) -> List[bytes]:
    """The S streams' payloads of a GXTC archive (its size table read)."""
    sizes = struct.unpack(f"<{S}Q", blob[HEADER : HEADER + 8 * S])
    out, off = [], HEADER + 8 * S
    for n in sizes:
        out.append(blob[off : off + n])
        off += n
    return out


def payload_bytes(blob: bytes, S: int) -> int:
    """The streams' code bytes, without the header and the size table."""
    return len(blob) - HEADER - 8 * S


def byte_diffs(got: bytes, want: bytes) -> int:
    """Positions where `got` differs from `want`, a missing or extra byte
    counting as one."""
    n = min(len(got), len(want))
    a, b = np.frombuffer(got, np.uint8, count=n), np.frombuffer(want, np.uint8, count=n)
    return int((a != b).sum()) + abs(len(got) - len(want))


def _worker(args):
    spec_dict, row, n, chunk, seed, bfloat16_state = args
    import torch

    torch.set_num_threads(1)
    from .reference.codec import encode_prefix
    from .reference.config import spec_from_dict

    t0 = time.perf_counter()
    out = encode_prefix(spec_from_dict(spec_dict), np.frombuffer(row, np.uint8), n, chunk, seed, bfloat16_state)
    return out, time.perf_counter() - t0


def reference_prefixes(spec_dict: dict, data: bytes, S: int, chunk: int, streams: Sequence[int], n: int, seed: int,
                       bfloat16_state: bool = False, coded_s: Optional[list] = None) -> Dict[int, bytes]:
    """The reference's code bytes over the first `n` bytes of each of
    `streams`, one process each (spawned, torch on the CPU with one
    thread); every process has ended when this returns. Each process's
    seconds of coding (its state made and its bytes coded) are appended to
    `coded_s`."""
    coded_s = [] if coded_s is None else coded_s
    from .reference.codec import split_streams

    arr = split_streams(data, S, chunk)
    jobs = [(spec_dict, arr[s].tobytes(), n, chunk, seed, bfloat16_state) for s in streams]
    pool = multiprocessing.get_context("spawn").Pool(len(jobs))
    try:
        got = pool.map(_worker, jobs)
        pool.close()
        coded_s.extend(t for _, t in got)
    except BaseException:
        pool.terminate()
        raise
    finally:
        pool.join()
    return dict(zip(streams, (b for b, _ in got)))


def expected_header(spec_dict: dict, data: bytes, S: int, chunk: int) -> bytes:
    from .reference.codec import header, split_streams
    from .reference.config import spec_from_dict

    return header(spec_from_dict(spec_dict), S, len(data), split_streams(data, S, chunk).shape[1])


def archive(want_header: bytes, S: int, streams: Dict[int, bytes]) -> bytes:
    """A GXTC archive of S streams that holds `streams`' code bytes (stream
    -> bytes) and nothing in every other stream: how the control's bytes
    stand in the program's place."""
    pays = [streams.get(s, b"") for s in range(S)]
    return want_header + struct.pack(f"<{S}Q", *map(len, pays)) + b"".join(pays)


def archive_mismatch(blob: bytes, want_header: bytes, S: int, prefixes: Dict[int, bytes]) -> int:
    """Header bytes unlike the reference's, plus each checked stream's code
    bytes unlike the reference's prefix (a payload shorter than the prefix
    misses the rest)."""
    bad = byte_diffs(blob[:HEADER], want_header)
    try:
        pays = payloads(blob, S)
    except struct.error:
        return bad + sum(len(p) for p in prefixes.values())
    return bad + sum(byte_diffs(pays[s][: len(p)], p) for s, p in prefixes.items())


def correct(numbers: dict, failed: int) -> bool:
    """Every number within its limit, and no job of the window failed."""
    return failed == 0 and all(v <= LIMITS[k] for k, v in numbers.items())


def judge(spec_dict: dict, data: bytes, mix: dict, seed: int, first_blob: bytes, blobs: Sequence[bytes],
          decoded: Sequence[bytes], streams: Sequence[int]) -> dict:
    """The numbers compared, each with its limit: `first_blob` (the set-up
    job's archive) against the reference over `streams`, every job's
    archive (`blobs`) against it, every decode against the file."""
    S, chunk = mix["streams"], mix["chunk"]
    t0 = time.perf_counter()
    coded_s: List[float] = []
    prefixes = reference_prefixes(spec_dict, data, S, chunk, streams, mix["check_bytes"], seed, coded_s=coded_s)
    numbers = {
        "archive_mismatch_bytes": archive_mismatch(first_blob, expected_header(spec_dict, data, S, chunk), S, prefixes),
        "job_archive_diffs": sum(b != first_blob for b in blobs),
        "decode_mismatch_bytes": sum(byte_diffs(d, data) for d in decoded),
    }
    return {"numbers": numbers, "reference_s": time.perf_counter() - t0, "reference_coding_s": max(coded_s),
            "reference_bytes": sum(len(p) for p in prefixes.values())}
