"""The JAX repository's five sweep tools, on one CUDA device:

    python -m gmix_tpu_torch.sweeps scaling [S ...] [--profile scaled-12] [--chunk 512]
    python -m gmix_tpu_torch.sweeps sequential [ref|best] [--bytes N] [--chunk 4000]
        [--capture-only | --encode-only]
    python -m gmix_tpu_torch.sweeps warm [--sizes 32768,131072,524288,1048576]
        [--profile 11x128] [--chunk 4000] [--bench-bytes N]
    python -m gmix_tpu_torch.sweeps ring [BITS ...] [--profile 11x16] [--chunk 4000]
        [--corpus-bytes N]
    python -m gmix_tpu_torch.sweeps wiki [SIZE] [--profile scaled-11x128] [--chunk 4000]
    every one: [--device cuda:0|cpu] [--out FILE]

Each sub-command runs its tool's spec, bytes and defaults (the tools'
environment variables are read as the defaults of the flags):

- `scaling` (tools/tpu_scaling.py): at each stream count S, `scaling_spec`
  (`reference_spec()` with its tables clamped to 2^bits, history
  2^min(24, bits + 4); not `bench.spec_for`, which adds two APM stages)
  encodes seeded random bytes through `Predictor.chunk_fn`: one chunk
  untimed (the CUDA graphs' capture, where the tool compiled), then two
  timed. A row per S: chunk ms, us a bit, encode MB/s, the state's GB.
  GMIX_SCALE_PROFILE, GMIX_SCALE_CHUNK.
- `sequential` (tools/tpu_sequential.py): ONE stream from a fresh state
  (the reference's own operating mode) encodes the corpus' first bytes on a
  predictor and decodes the archive on another; `ref` is `reference_spec()`
  as it is (no APM stage), `best` is `best_spec()`. `--capture-only` builds
  the one-stream predictor and captures its graphs (one chunk of zeros each
  way), the pin the tool's `--compile-only` was. `--encode-only` runs no
  decode. GMIX_SEQ_BYTES, GMIX_SEQ_CHUNK.
- `warm` (tools/tpu_warm_sweep.py): one stream of `bench.spec_for(bits)` is
  continued over the corpus segment by segment, each segment floored to
  whole chunks and coded from byte index 0 (the tool's `run_chunks` calls),
  and snapshotted at each size as a gmix_tpu checkpoint under build/warm/
  with a sidecar (`bench.save_warm_checkpoint`; the sidecar names the
  segments, so the bench never reads a snapshot as its own warm start).
  Then one S-stream predictor is put at each snapshot in turn
  (`bench.reset_to_warm`) and encodes the tool's bench bytes:
  data/corpus_1m.bin repeated from byte 0, so that they contain the warm
  bytes (`repeats_corpus`, `overlaps_warm`), as the tool measured.
  GMIX_WARM_PROFILE, GMIX_WARM_CHUNK, GMIX_WARM_BENCH_BYTES.
- `ring` (tools/tpu_ring_sweep.py): the synthetic MediaWiki dump
  (`preprocess/wiki_corpus.py`) wiki- and dictionary-transformed (cached
  under build/sweeps/ by size), encoded at S streams of
  `bench.spec_for(bits)` with each `history_bits`. A history size that
  fails gives an `error` row, the others run, and the exit code is 1.
  GMIX_RING_PROFILE, GMIX_RING_CHUNK.
- `wiki` (tools/wiki_e2e.py): the dump of SIZE bytes through wiki-encode,
  dict-encode, compress, decompress, dict-decode and wiki-decode, which
  must give the dump back. GMIX_E2E_PROFILE, GMIX_E2E_CHUNK.

Printed on stdout, one JSON object a line (`bench.emit`): a config row
with the card's name and power limit (`bench.device_info`), then the
sub-command's rows. Every row that codes bytes has `byte_steps`, the byte
steps run since the row before it, and `tpu_record`, the row of data/parity.json the tool wrote
on the TPU (a record to stand beside, not a target; `scaling` printed
only). `--out FILE` also writes the rows to FILE. Nothing is written under
data/: data/parity.json is read, never written. A roundtrip that is not
exact, a cross-entropy that is not finite or a failed entry ends the run
with a non-zero exit. `--device cpu` runs the plain torch path.

Left behind: the tools' writes to data/parity.json and their rounding,
tools/tpu_sequential.py's `--idle-lane` (the workaround of an S=1 TPU
miscompile) and the idle second lane of tools/tpu_warm_sweep.py's
pretraining (the same miscompile).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time
import traceback
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from . import bench
from .config import EnsembleSpec, best_spec, reference_spec, scale_tables
from .core.codec import Predictor, compress_bytes, decompress_bytes, default_device, entropy_bits, run_chunks
from .preprocess import dictionary, wiki
from .preprocess.wiki_corpus import make_corpus

PARITY = os.path.join(bench.ROOT, "data", "parity.json")  # the TPU's records: read, never written
WARM_DIR = os.path.join(bench.ROOT, "build", "warm")
RING_CACHE = os.path.join(bench.ROOT, "build", "sweeps")
# the ring sweep's corpus: 16 MiB of dump, 7 438 259 bytes after the two
# transforms (data/parity.json ring_sweep, wiki_e2e)
RING_RAW_BYTES, RING_CORPUS_BYTES = 16 << 20, 7438259
WARM_SIZES = (32768, 131072, 524288, 1048576)


def scaling_spec(bits: int) -> EnsembleSpec:
    """tools/tpu_scaling.py's and tools/wiki_e2e.py's spec: `reference_spec()`
    with its tables clamped to 2^bits entries and a history of
    2^min(24, bits + 4) bytes."""
    return scale_tables(reference_spec(), bits, history_bits=min(24, bits + 4))


def sequential_spec(profile: str) -> EnsembleSpec:
    """tools/tpu_sequential.py's `_spec`: `best_spec()` or `reference_spec()`."""
    if profile not in ("ref", "best"):
        raise ValueError(f"sequential profile {profile!r}: ref or best")
    return best_spec() if profile == "best" else reference_spec()


def ring_spec(bits: int, history_bits: int) -> EnsembleSpec:
    """tools/tpu_ring_sweep.py's spec: `bench.spec_for(bits)` with another
    history ring, validated."""
    spec = dataclasses.replace(bench.spec_for(bits), history_bits=history_bits)
    spec.validate()
    return spec


def parse_bits_streams(text: str) -> Tuple[int, int]:
    """(bits, S) of a tool's profile, `11x128` or `scaled-11x128`."""
    bits, _, S = text.removeprefix("scaled-").partition("x")
    if not (bits.isdigit() and S.isdigit()):
        raise ValueError(f"profile {text!r}: <bits>x<streams> or scaled-<bits>x<streams>")
    return int(bits), int(S)


def repeated_corpus(n: int) -> bytes:
    """The tools' `_corpus(n)`: data/corpus_1m.bin repeated from byte 0 to
    n bytes (`bench.corpus` never repeats it)."""
    data = bench.corpus()
    while len(data) < n:
        data += data
    return data[:n]


def tpu_record(key: str):
    """data/parity.json's entry `key` (None without the file or the key)."""
    if not os.path.exists(PARITY):
        return None
    with open(PARITY) as f:
        return json.load(f).get(key)


def _timed(dev: torch.device, fn: Callable):
    """(fn(), wall seconds), the device drained before and after."""
    bench.sync(dev)
    t0 = time.perf_counter()
    out = fn()
    bench.sync(dev)
    return out, time.perf_counter() - t0


def _graphs(pred: Predictor) -> Tuple[int, float]:
    """(CUDA graphs the predictor captured, their capture seconds)."""
    graphs = [g for fn in pred.plan.fn_cache.values() for g in fn.graphs.values()]
    return len(graphs), sum(g.record.capture_s for g in graphs)


def _archive(blob: bytes) -> dict:
    return {"archive_bytes": len(blob), "archive_sha256": hashlib.sha256(blob).hexdigest()}


# ---------------------------------------------------------------------------
# scaling
# ---------------------------------------------------------------------------


def scaling(spec: EnsembleSpec, streams: Sequence[int], chunk: int, dev, lines: list) -> int:
    """One row per S: a chunk of seeded random bytes encoded untimed (the
    graphs' capture), then two chunks timed through `Predictor.chunk_fn`."""
    for S in streams:
        pred = Predictor(spec, S, device=dev, analysis=False)
        data = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (S, 4 * chunk), np.uint8), device=dev)
        code = torch.zeros((S, 1), dtype=torch.uint8, device=dev)  # encode never reads it
        fn = pred.chunk_fn(chunk)
        _, capture_s = _timed(dev, lambda: fn(data, code, 0))
        reps = 2
        _, wall = _timed(dev, lambda: [fn(data, code, chunk * r) for r in range(1, 1 + reps)])
        if not bool(torch.isfinite(pred.state["metrics"]["ent"]).all()):
            raise RuntimeError(f"scaling S={S}: the cross-entropy is not finite")
        dt = wall / reps
        n_graphs, graphs_s = _graphs(pred)
        bench.emit(lines, "scaling", S=S, chunk=chunk, mem_gb=pred.memory_bytes() / 1e9, capture_s=capture_s,
                   graphs=n_graphs, graphs_capture_s=graphs_s, chunk_ms=1e3 * dt, bit_us=1e6 * dt / (chunk * 8),
                   enc_mbps=S * chunk / dt / 1e6, byte_steps=(1 + reps) * chunk,
                   tpu_record="none: tools/tpu_scaling.py printed its rows and recorded none")
        pred.plan.release_graphs()
        del pred
        bench.release_device(dev)
    return 0


# ---------------------------------------------------------------------------
# sequential
# ---------------------------------------------------------------------------


def sequential_capture(profile: str, spec: EnsembleSpec, chunk: int, dev, lines: list) -> int:
    """The one-stream predictor built and its graphs captured (`bench.capture`:
    one chunk of zeros encoded and one decoded), the seconds printed."""
    pred = Predictor(spec, 1, device=dev, analysis=False)
    _, wall = _timed(dev, lambda: bench.capture(pred, chunk, chunk))
    n_graphs, graphs_s = _graphs(pred)
    bench.emit(lines, "sequential-capture", profile=profile, streams=1, chunk=chunk,
               state_gib=pred.memory_bytes() / 2**30, graphs=n_graphs,
               capture_s=graphs_s if dev.type == "cuda" else "not measured: the CPU runs the step op by op",
               wall_s=wall, byte_steps=2 * chunk)
    pred.plan.release_graphs()
    del pred
    bench.release_device(dev)
    return 0


def sequential(profile: str, spec: EnsembleSpec, data: bytes, chunk: int, dev, lines: list,
               encode_only: bool = False) -> int:
    """`data` encoded by one stream from a fresh state, then the archive
    decoded on a fresh predictor: an `encoded` row, then the `done` row
    (exit code 1 if the decode is not `data`)."""
    n = len(data)
    seq = tpu_record("sequential_s1") or {}
    rec = {"profile": profile, "status": "running", "corpus_bytes": n, "chunk": chunk, "streams": 1,
           "ref_bpb_sequential": bench.baseline().get("ref_1m", {}).get("bpb")}
    pred = Predictor(spec, 1, device=dev, analysis=False)
    rec["state_gib"] = pred.memory_bytes() / 2**30
    blob, t_enc = _timed(dev, lambda: compress_bytes(data, spec, 1, chunk, pred=pred,
                                                     progress=bench.finite_guard(pred, "sequential encode", chunk)))
    per = bench.padded_per(n, 1, chunk)
    rec.update(status="encoded", bpb=8 * len(blob) / n, model_bpb=entropy_bits(pred) / n, enc_s=t_enc,
               enc_mbps=n / t_enc / 1e6, ms_per_step=1e3 * t_enc / per, **_archive(blob), byte_steps=per,
               tpu_record={k: {f: v for f, v in seq[k].items() if f != "note"}
                           for k in (profile, f"{profile}_idle2") if isinstance(seq.get(k), dict)})
    pred.plan.release_graphs()
    del pred
    bench.release_device(dev)
    if encode_only:
        bench.emit(lines, "sequential", **rec, roundtrip_exact="not run: --encode-only")
        return 0
    bench.emit(lines, "sequential", **rec)
    pred = Predictor(spec, 1, device=dev, analysis=False)
    out, t_dec = _timed(dev, lambda: decompress_bytes(blob, spec, chunk, pred=pred,
                                                      progress=bench.finite_guard(pred, "sequential decode", chunk)))
    pred.plan.release_graphs()
    del pred
    bench.release_device(dev)
    exact = out == data
    rec.update(status="done" if exact else "decoded other bytes", dec_s=t_dec, roundtrip_exact=exact,
               encdec_mbps=2 * n / (t_enc + t_dec) / 1e6, byte_steps=per)
    bench.emit(lines, "sequential", **rec)
    return 0 if exact else 1


# ---------------------------------------------------------------------------
# warm
# ---------------------------------------------------------------------------


def warm_targets(sizes: Sequence[int], chunk: int) -> List[Tuple[int, int, int]]:
    """tools/tpu_warm_sweep.py's segments: (target, start, trained) for each
    size in order, the segment [start, target) floored to whole chunks, so
    that the snapshot at `target` holds `start + trained` bytes (its
    `warm_bytes_actual`) and the next segment starts there."""
    out, done = [], 0
    for target in sorted(sizes):
        trained = max(0, target - done) // chunk * chunk
        out.append((target, done, trained))
        done += trained
    return out


def warm_snapshots(spec: EnsembleSpec, profile: str, data: bytes, sizes: Sequence[int], chunk: int, dev,
                   lines: list, directory: str = WARM_DIR) -> List[dict]:
    """Phase 1: one stream of `spec` continued over `data` segment by segment
    (`warm_targets`; each segment coded from byte index 0, as the tool's
    `run_chunks` calls coded it) and written at each size (`bench.
    save_warm_checkpoint`, gmix_tpu's format, under `directory`). Returns
    one dict a snapshot: size, bytes trained, path, sidecar."""
    pred = Predictor(spec, 1, device=dev, analysis=False)
    code = torch.zeros((1, 1), dtype=torch.uint8, device=dev)  # encode never reads it
    snaps, segments = [], []
    for target, start, trained in warm_targets(sizes, chunk):
        t0 = time.perf_counter()
        if trained:
            seg = torch.as_tensor(np.frombuffer(data, np.uint8, count=trained, offset=start)[None].copy(), device=dev)
            run_chunks(pred, seg, code, trained, decode=False, chunk=chunk,
                       progress=bench.finite_guard(pred, f"warm segment to {target}", chunk))
            segments.append([start, start + trained])
        actual = start + trained
        bench.sync(dev)
        train_s = time.perf_counter() - t0
        path = os.path.join(directory, f"sweep-{profile}-{target}.gxt")
        sidecar = {**bench.warm_sidecar(spec, data[:actual], chunk), "warm_chunk": chunk,
                   "segments": [list(s) for s in segments]}
        t0 = time.perf_counter()
        bench.save_warm_checkpoint(path, pred.state, sidecar)
        snaps.append({"warm_bytes": target, "warm_bytes_actual": actual, "path": path, "sidecar": sidecar})
        bench.emit(lines, "warm-snapshot", profile=profile, warm_bytes=target, warm_bytes_actual=actual,
                   segment=[start, start + trained], train_s=train_s, write_s=time.perf_counter() - t0,
                   path=os.path.relpath(path, bench.ROOT), byte_steps=trained)
    pred.plan.release_graphs()
    del pred
    bench.release_device(dev)
    return snaps


def warm(spec: EnsembleSpec, bits: int, S: int, sizes: Sequence[int], chunk: int, bench_bytes: int, dev,
         lines: list, directory: str = WARM_DIR) -> int:
    """Phase 1 (`warm_snapshots`), then phase 2: one predictor of S streams
    put at each snapshot in turn encodes `repeated_corpus(bench_bytes)`."""
    profile = f"scaled-{bits}x{S}"
    snaps = warm_snapshots(spec, f"scaled-{bits}", repeated_corpus(max(sizes)), sizes, chunk, dev, lines, directory)
    bdata = repeated_corpus(bench_bytes)
    records = {(r.get("profile"), r.get("warm_bytes")): r for r in (tpu_record("warm_sweep") or [])}
    pred = None
    for snap in snaps:
        bench.check_warm_checkpoint(snap["path"], snap["sidecar"])
        state = bench.load_warm_checkpoint(snap["path"])
        if pred is None:
            pred = bench.warm_predictor(spec, S, state, dev)
        else:
            bench.reset_to_warm(pred, state)
        blob, t_enc = _timed(dev, lambda: compress_bytes(bdata, spec, S, chunk, pred=pred,
                                                         progress=bench.finite_guard(pred, "warm encode", chunk)))
        per = bench.padded_per(bench_bytes, S, chunk)
        bench.emit(lines, "warm", profile=profile, warm_bytes=snap["warm_bytes"],
                   warm_bytes_actual=snap["warm_bytes_actual"], bench_bytes=bench_bytes, chunk=chunk,
                   bpb=8 * len(blob) / bench_bytes, model_bpb=entropy_bits(pred) / bench_bytes, enc_s=t_enc,
                   ms_per_step=1e3 * t_enc / per, repeats_corpus=bench_bytes > os.path.getsize(bench.CORPUS),
                   overlaps_warm=True, **_archive(blob), byte_steps=per,
                   tpu_record=records.get((profile, snap["warm_bytes"])))
    pred.plan.release_graphs()
    del pred
    bench.release_device(dev)
    return 0


# ---------------------------------------------------------------------------
# ring
# ---------------------------------------------------------------------------


def ring_corpus(raw_bytes: int) -> bytes:
    """`make_corpus(raw_bytes)` wiki-encoded then dictionary-encoded (the
    compression input of tools/wiki_e2e.py), cached under build/sweeps/ by
    size."""
    path = os.path.join(RING_CACHE, f"ring-{raw_bytes}.bin")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    blob = dictionary.load(None).encode(wiki.encode(make_corpus(raw_bytes)))
    os.makedirs(RING_CACHE, exist_ok=True)

    def write(tmp: str) -> None:
        with open(tmp, "wb") as f:
            f.write(blob)

    bench.replace_file(path, write)
    return blob


def ring_row(data: bytes, spec: EnsembleSpec, S: int, chunk: int, dev) -> Tuple[dict, bytes]:
    """(row, archive) of `data` encoded at S streams of `spec`."""
    n = len(data)
    pred = Predictor(spec, S, device=dev, analysis=False)
    try:
        blob, t_enc = _timed(dev, lambda: compress_bytes(data, spec, S, chunk, pred=pred,
                                                         progress=bench.finite_guard(pred, "ring encode", chunk)))
        per = bench.padded_per(n, S, chunk)
        per_stream = -(-n // S)
        row = {"history_bits": spec.history_bits, "ring_bytes": 1 << spec.history_bits, "per_stream_bytes": per_stream,
               "wraps": (1 << spec.history_bits) < per_stream, "corpus": f"wiki+dict transformed, {n} bytes",
               "bpb": 8 * len(blob) / n, "model_bpb": entropy_bits(pred) / n, "enc_s": t_enc,
               "ms_per_step": 1e3 * t_enc / per, **_archive(blob), "byte_steps": per}
    finally:
        pred.plan.release_graphs()
        del pred
        bench.release_device(dev)
    return row, blob


def ring(data: bytes, spec_of: Callable[[int], EnsembleSpec], profile: str, bits_list: Sequence[int], S: int,
         chunk: int, dev, lines: list) -> int:
    """A row for each history size (`spec_of(history_bits)`); one that fails
    gives an `error` row and the others still run. Returns 1 if any failed."""
    records = {(r.get("profile"), r.get("history_bits")): r for r in (tpu_record("ring_sweep") or [])}
    failed = False
    for hb in bits_list:
        try:
            row, _ = ring_row(data, spec_of(hb), S, chunk, dev)
        except Exception as e:  # the tool's error row, the traceback on stderr; the exit code says it
            failed = True
            traceback.print_exc()
            bench.release_device(dev)
            bench.emit(lines, "ring", profile=profile, history_bits=hb, error=f"{type(e).__name__}: {e}"[:300],
                       byte_steps=0)
            continue
        bench.emit(lines, "ring", profile=profile, **row, tpu_record=records.get((profile, hb)))
    return 1 if failed else 0


# ---------------------------------------------------------------------------
# wiki
# ---------------------------------------------------------------------------


def wiki_chain(size: int, spec: EnsembleSpec, profile: str, S: int, chunk: int, dev, lines: list) -> int:
    """The dump of `size` bytes through the chain and back; exit code 1 if
    what comes back is not the dump."""
    data, gen_s = _timed(torch.device("cpu"), lambda: make_corpus(size))
    wblob, t_wiki = _timed(torch.device("cpu"), lambda: wiki.encode(data))
    dblob, t_dict = _timed(torch.device("cpu"), lambda: dictionary.load(None).encode(wblob))
    pred = Predictor(spec, S, device=dev, analysis=False)
    blob, t_enc = _timed(dev, lambda: compress_bytes(dblob, spec, S, chunk, pred=pred,
                                                     progress=bench.finite_guard(pred, "wiki encode", chunk)))
    pred.plan.release_graphs()
    del pred
    bench.release_device(dev)
    pred = Predictor(spec, S, device=dev, analysis=False)
    out, t_dec = _timed(dev, lambda: decompress_bytes(blob, spec, chunk, pred=pred,
                                                      progress=bench.finite_guard(pred, "wiki decode", chunk)))
    pred.plan.release_graphs()
    del pred
    bench.release_device(dev)
    t0 = time.perf_counter()
    wback = dictionary.load(None).decode(out)
    back = wiki.decode(wback)
    post_s = time.perf_counter() - t0
    exact = out == dblob and back == data
    bench.emit(lines, "wiki", corpus=f"synthetic mediawiki dump, {len(data)} bytes", profile=profile, chunk=chunk,
               wiki_bytes=len(wblob), dict_bytes=len(dblob), compressed_bytes=len(blob),
               bpb_vs_original=8 * len(blob) / len(data), bpb_vs_dict=8 * len(blob) / len(dblob), gen_s=gen_s,
               prep_s=t_wiki + t_dict, enc_s=t_enc, dec_s=t_dec, post_s=post_s,
               encdec_mbps_vs_original=2 * len(data) / (t_enc + t_dec) / 1e6, codec_exact=out == dblob,
               chain_byte_identical=exact, archive_sha256=hashlib.sha256(blob).hexdigest(),
               byte_steps=2 * bench.padded_per(len(dblob), S, chunk), tpu_record=tpu_record("wiki_e2e"))
    return 0 if exact else 1


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _run(args, dev, lines: list) -> int:
    if args.cmd == "scaling":
        bits = int(args.profile.removeprefix("scaled-"))
        return scaling(scaling_spec(bits), args.streams or [16, 64, 256], args.chunk, dev, lines)
    if args.cmd == "sequential":
        spec = sequential_spec(args.profile)
        if args.capture_only:
            return sequential_capture(args.profile, spec, args.chunk, dev, lines)
        return sequential(args.profile, spec, repeated_corpus(args.bytes), args.chunk, dev, lines, args.encode_only)
    if args.cmd == "warm":
        bits, S = parse_bits_streams(args.profile)
        sizes = [int(x) for x in args.sizes.split(",")]
        return warm(bench.spec_for(bits), bits, S, sizes, args.chunk, args.bench_bytes, dev, lines)
    if args.cmd == "ring":
        bits, S = parse_bits_streams(args.profile)
        data = ring_corpus(args.corpus_bytes)
        if args.corpus_bytes == RING_RAW_BYTES and len(data) != RING_CORPUS_BYTES:
            raise SystemExit(f"sweeps ring: the corpus is {len(data)} bytes, the record's is {RING_CORPUS_BYTES}")
        return ring(data, lambda hb: ring_spec(bits, hb), f"scaled-{bits}x{S}", args.bits or [16, 17, 18, 19, 20], S,
                    args.chunk, dev, lines)
    bits, S = parse_bits_streams(args.profile)
    return wiki_chain(args.size, scaling_spec(bits), f"scaled-{bits}x{S}", S, args.chunk, dev, lines)


def main(argv=None) -> int:
    env = os.environ
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=None,
                        help="a torch device (default: the current CUDA device; cpu runs the plain torch path)")
    common.add_argument("--out", default=None, help="also write the printed rows to this JSON file")
    p = argparse.ArgumentParser(prog="python -m gmix_tpu_torch.sweeps",
                                description="the JAX repository's sweep tools on the port")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("scaling", parents=[common], help="chunk time against the stream count")
    s.add_argument("streams", type=int, nargs="*", help="stream counts (default 16 64 256)")
    s.add_argument("--profile", default=env.get("GMIX_SCALE_PROFILE", "scaled-12"))
    s.add_argument("--chunk", type=int, default=_env_int("GMIX_SCALE_CHUNK", 512))
    s = sub.add_parser("sequential", parents=[common], help="one stream over the corpus, both ways")
    s.add_argument("profile", nargs="?", default="ref", choices=("ref", "best"))
    s.add_argument("--bytes", type=int, default=_env_int("GMIX_SEQ_BYTES", 1 << 20))
    s.add_argument("--chunk", type=int, default=_env_int("GMIX_SEQ_CHUNK", 4000))
    mode = s.add_mutually_exclusive_group()
    mode.add_argument("--capture-only", action="store_true", help="capture the one-stream graphs and exit")
    mode.add_argument("--encode-only", action="store_true", help="no decode")
    s = sub.add_parser("warm", parents=[common], help="bpb at the bench point against the warm-start size")
    s.add_argument("--sizes", default=",".join(map(str, WARM_SIZES)))
    s.add_argument("--profile", default=env.get("GMIX_WARM_PROFILE", "11x128"))
    s.add_argument("--chunk", type=int, default=_env_int("GMIX_WARM_CHUNK", 4000))
    s.add_argument("--bench-bytes", type=int, default=_env_int("GMIX_WARM_BENCH_BYTES", 1 << 22))
    s = sub.add_parser("ring", parents=[common], help="bpb against the match-history ring size")
    s.add_argument("bits", type=int, nargs="*", help="history_bits values (default 16 17 18 19 20)")
    s.add_argument("--profile", default=env.get("GMIX_RING_PROFILE", "11x16"))
    s.add_argument("--chunk", type=int, default=_env_int("GMIX_RING_CHUNK", 4000))
    s.add_argument("--corpus-bytes", type=int, default=RING_RAW_BYTES, help="bytes of dump before the transforms")
    s = sub.add_parser("wiki", parents=[common], help="the enwik-style chain, and back")
    s.add_argument("size", type=int, nargs="?", default=16 << 20, help="bytes of dump (default 16 MiB)")
    s.add_argument("--profile", default=env.get("GMIX_E2E_PROFILE", "scaled-11x128"))
    s.add_argument("--chunk", type=int, default=_env_int("GMIX_E2E_CHUNK", 4000))
    args = p.parse_args(argv)

    if args.device is not None:
        dev = torch.device(args.device)
    else:
        try:
            dev = default_device()
        except RuntimeError as e:
            raise SystemExit(f"sweeps: {e}; here: --device cpu")
    lines: list = []
    config = {k: v for k, v in vars(args).items() if k not in ("device", "out")}
    bench.emit(lines, "config", sweep=args.cmd, **{k: v for k, v in config.items() if k != "cmd"},
               **bench.device_info(dev))
    try:
        rc = _run(args, dev, lines)
    finally:
        if args.out:
            with open(args.out, "w") as f:
                json.dump(lines, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
