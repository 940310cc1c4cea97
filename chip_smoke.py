#!/usr/bin/env python3
"""Drive the PyTorch port (gmix_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit:

0. require a CUDA device (there is no CPU fallback) and print the card's
   name and power limit as nvidia-smi reports them;
1. build the CUDA kernels from gmix_tpu_torch/csrc/ (nvcc, sm_90a);
2. hold each kernel against its plain torch version, bitwise, on the live
   arenas of a Predictor at full width (ref-noppm, 16 streams; arenas filled
   with seeded random bits), and time both with CUDA events;
3. the main path at full width: compress_bytes then decompress_bytes of the
   first 16 KB of data/corpus_1m.bin on the GPU (ref-noppm, 16 streams,
   1 KB per stream); the output must equal the input, and the row-mover
   kernels must have launched exactly 4 + 4 times per byte step;
4. GPU against CPU: at scale_tables(ref-noppm, 12, history_bits=16), 2
   streams, 1 KB, the GPU archive must equal the CPU archive byte for byte,
   and each device must decode the other's archive.

ref-noppm is gmix_tpu's reference wiring at its published table sizes with
the two SSE/APM stages of bench.py and without PPM, LSTM and the rolling
contexts that only PPM reads.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import gmix_tpu_torch as gt
from gmix_tpu_torch.config import ApmStage, reference_spec, scale_tables
from gmix_tpu_torch.core.codec import Predictor, compress_bytes, decompress_bytes, entropy_bits
from gmix_tpu_torch.ops import rowmove
from gmix_tpu_torch.state import state_bytes
from gmix_tpu_torch.utils.build import build

ROOT = os.path.dirname(os.path.abspath(__file__))
STREAMS = 16
MAIN_BYTES = 16 * 1024
CHUNK = 1024
SEED = 1234
KERNEL_SOURCE = "gmix_tpu_torch/csrc/rowmove.cu"
REPLACES = {
    "gather_rows": "gmix_tpu/ops/rowmove.py:85",
    "scatter_rows": "gmix_tpu/ops/rowmove.py:116",
}
# the four arenas the byte step moves rows of, and how many rows per stream
# per byte it moves in each (indirect models, stable mixers, position-gated
# mixers, APM stages)
ARENAS = (("ind.st", ("ind", "st")), ("mix_w", ("mix_w",)), ("mix_pos", ("mix_pos",)), ("apm", ("apm",)))


def ref_noppm_spec():
    spec = reference_spec()
    return dataclasses.replace(
        spec,
        apm=(
            ApmStage("apm_lb", "last_byte", 8, lr=0.010, weight=0.50),
            ApmStage("apm_h2", "h2", 16, lr=0.010, weight=0.25),
        ),
        ppm=None,
        lstm=None,
        roll_ctxs=(),
    )


def rows_per_byte(meta):
    return {
        "ind.st": len(meta.spec.indirects),
        "mix_w": len(meta.mix_st_ix),
        "mix_pos": len(meta.mix_pos_ix),
        "apm": len(meta.spec.apm),
    }


def log(msg: str) -> None:
    print(msg, flush=True)


def corpus(n: int) -> bytes:
    with open(os.path.join(ROOT, "data", "corpus_1m.bin"), "rb") as f:
        data = f.read(n)
    if len(data) != n:
        raise RuntimeError(f"corpus_1m.bin holds {len(data)} bytes, need {n}")
    return data


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median of `reps` single-launch times, CUDA events around each;
    `fn(i)` takes the repetition index so each launch can move other rows."""
    for i in range(warmup):
        fn(i)
    times = []
    for i in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(i)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def unique_rows(rng, S: int, N: int, M: int, device) -> torch.Tensor:
    idx = np.stack([rng.choice(N, size=M, replace=False) for _ in range(S)]).astype(np.int32)
    return torch.as_tensor(idx, device=device)


def fill_random_(t: torch.Tensor, gen: torch.Generator) -> None:
    """Seeded random contents, in place: normal floats or random integers."""
    if t.is_floating_point():
        t.normal_(generator=gen)
    else:
        t.random_(generator=gen)


def phase_kernels(spec, dev):
    """Each kernel against its plain version on the arenas of a live
    Predictor, at the shapes the byte step gives it."""
    pred = Predictor(spec, STREAMS, device=dev)
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    per_arena = []
    for name, path in ARENAS:
        tbl = pred.state["ltm"]
        for k in path:
            tbl = tbl[k]
        fill_random_(tbl, gen)
        S, N, W = tbl.shape
        M = rows_per_byte(pred.meta)[name]
        idx = unique_rows(rng, S, N, M, dev)
        # gather: bitwise against torch advanced indexing
        got = rowmove.gather_rows(tbl, idx)
        want = rowmove.gather_rows_plain(tbl, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"gather_rows differs from its plain version on {name}")
        g_err = (got.double() - want.double()).abs().max().item()
        # scatter: the whole arena after a kernel scatter against a copy
        # after the plain scatter
        upd = torch.empty_like(want)
        fill_random_(upd, gen)
        ref = tbl.clone()
        rowmove.scatter_rows(tbl, idx, upd)
        rowmove.scatter_rows_plain(ref, idx, upd)
        torch.cuda.synchronize()
        if not torch.equal(tbl, ref):
            raise RuntimeError(f"scatter_rows differs from its plain version on {name}")
        s_err = (rowmove.gather_rows_plain(tbl, idx).double() - upd.double()).abs().max().item()
        del ref
        # timing: a fresh set of random rows per launch, as each byte step
        # moves other rows out of an arena far larger than the L2 cache
        idxs = [unique_rows(rng, S, N, M, dev) for _ in range(40)]
        t = {
            "gather_ms": time_ms(lambda i: rowmove.gather_rows(tbl, idxs[i])),
            "gather_plain_ms": time_ms(lambda i: rowmove.gather_rows_plain(tbl, idxs[i])),
            "scatter_ms": time_ms(lambda i: rowmove.scatter_rows(tbl, idxs[i], upd)),
            "scatter_plain_ms": time_ms(lambda i: rowmove.scatter_rows_plain(tbl, idxs[i], upd)),
        }
        row = {"arena": name, "shape": [S, N, W], "dtype": str(tbl.dtype).replace("torch.", ""),
               "rows": M, "row_bytes": W * tbl.element_size(), "gather_err": g_err, "scatter_err": s_err, **t}
        log(f"phase 2: {json.dumps(row)}")
        per_arena.append(row)
    del pred
    torch.cuda.empty_cache()
    return per_arena


def phase_main(spec, dev):
    """compress + decompress at full width on the GPU; counts kernel launches."""
    data = corpus(MAIN_BYTES)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    pred = Predictor(spec, STREAMS, device=dev)
    out["state_gb"] = state_bytes(pred.state) / 1e9
    per = MAIN_BYTES // STREAMS
    rowmove.gather_rows.launches = 0
    rowmove.scatter_rows.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = compress_bytes(data, spec, STREAMS, CHUNK, pred=pred)
    torch.cuda.synchronize()
    out["encode_s"] = time.perf_counter() - t0
    enc_launches = (rowmove.gather_rows.launches, rowmove.scatter_rows.launches)
    ent = entropy_bits(pred)
    del pred
    torch.cuda.empty_cache()
    pred = Predictor(spec, STREAMS, device=dev)
    rowmove.gather_rows.launches = 0
    rowmove.scatter_rows.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = decompress_bytes(blob, spec, CHUNK, pred=pred)
    torch.cuda.synchronize()
    out["decode_s"] = time.perf_counter() - t0
    dec_launches = (rowmove.gather_rows.launches, rowmove.scatter_rows.launches)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del pred
    torch.cuda.empty_cache()
    if back != data:
        raise RuntimeError("phase 3: decompress_bytes did not reproduce the input")
    if not np.isfinite(ent) or ent <= 0:
        raise RuntimeError(f"phase 3: cross-entropy {ent} is not a positive finite number")
    expect = (4 * per, 4 * per)
    if enc_launches != expect or dec_launches != expect:
        raise RuntimeError(
            f"phase 3: launches (gather, scatter) encode {enc_launches}, decode "
            f"{dec_launches}, expected {expect} each (4 + 4 per byte step)"
        )
    out.update(
        bytes=len(data), archive_bytes=len(blob), bpb=8 * len(blob) / len(data),
        model_bpb=ent / len(data), encode_bytes_per_s=len(data) / out["encode_s"],
        decode_bytes_per_s=len(data) / out["decode_s"], byte_steps=per,
        launches_encode=list(enc_launches), launches_decode=list(dec_launches),
    )
    log(f"phase 3: {json.dumps(out)}")
    return out


def phase_cross(spec, dev):
    """The same archive from the GPU and from the CPU, and cross-decodes."""
    spec12 = scale_tables(spec, 12, history_bits=16)
    data = corpus(1024)
    S, chunk = 2, 512
    t0 = time.perf_counter()
    blob_gpu = compress_bytes(data, spec12, S, chunk, device=dev)
    t1 = time.perf_counter()
    blob_cpu = compress_bytes(data, spec12, S, chunk, device="cpu")
    t2 = time.perf_counter()
    if blob_gpu != blob_cpu:
        diff = next(i for i, (a, b) in enumerate(zip(blob_gpu, blob_cpu)) if a != b) if len(blob_gpu) == len(blob_cpu) else -1
        raise RuntimeError(f"phase 4: GPU and CPU archives differ ({len(blob_gpu)} vs {len(blob_cpu)} bytes, first at {diff})")
    if decompress_bytes(blob_cpu, spec12, chunk, device=dev) != data:
        raise RuntimeError("phase 4: the GPU does not decode the CPU archive")
    if decompress_bytes(blob_gpu, spec12, chunk, device="cpu") != data:
        raise RuntimeError("phase 4: the CPU does not decode the GPU archive")
    out = {"bytes": len(data), "archive_bytes": len(blob_gpu), "gpu_encode_s": t1 - t0,
           "cpu_encode_s": t2 - t1, "identical": True}
    log(f"phase 4: {json.dumps(out)}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's GPU path cannot run here", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"gmix_tpu_torch {gt.__version__}")

    res = build()
    log(f"phase 1: built {os.path.relpath(res.path, ROOT)} in {res.seconds:.1f} s (rebuilt={res.rebuilt})")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    spec = ref_noppm_spec()
    per_arena = phase_kernels(spec, dev)
    main_out = phase_main(spec, dev)
    phase_cross(spec, dev)

    kernels = []
    for i, (kname, op) in enumerate((("gather_rows", "gather"), ("scatter_rows", "scatter"))):
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES[kname],
            "launches": main_out["launches_encode"][i] + main_out["launches_decode"][i],
            "max_abs_err": max(r[f"{op}_err"] for r in per_arena),
            # one byte step's launches: the four arena shapes, summed
            "ms": sum(r[f"{op}_ms"] for r in per_arena),
            "plain_ms": sum(r[f"{op}_plain_ms"] for r in per_arena),
            "per_arena": [{"arena": r["arena"], "ms": r[f"{op}_ms"], "plain_ms": r[f"{op}_plain_ms"]}
                          for r in per_arena],
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
