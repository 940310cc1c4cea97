#!/usr/bin/env python3
"""Drive the PyTorch port (gmix_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --fused-only   # phases 0-1 and the fused kernel's
                                         # part of phase 2 (under a minute),
                                         # with each kernel's code size
    python3 chip_smoke.py --bench-only   # phases 0-1 and 7
    python3 chip_smoke.py --variants-only   # phases 0-1 and 8
    python3 chip_smoke.py --sweeps-only   # phases 0-1 and 9
    python3 chip_smoke.py --ppm-only   # phases 0-1 and the PPM kernels' part
                                       # of phase 2 (about a minute)
    python3 chip_smoke.py --contexts-only   # phases 0-1 and the contexts
                                            # kernels' part of phase 2

Phases; any failure ends the run with a non-zero exit:

0. require a CUDA device (there is no CPU fallback) and print the card's
   name and power limit as nvidia-smi reports them;
1. build the CUDA kernels from gmix_tpu_torch/csrc/ (nvcc, sm_90a) and print
   what ptxas says of each (registers, spills, shared memory);
2. hold each kernel against its plain torch version on the card, at full
   width (16 streams), and time both with CUDA events (`ms`: the device time
   of one launch, launches run back to back; `call_ms`: one call on an idle
   device, the wrapper's host work included):
   - the fused 8-sub-step kernel on the packed inputs of a live Predictor
     warmed over some tens of corpus bytes, at ref-noppm, at ref-ppm and at
     ref-full (live `lstm_probs` and interval registers of a running LSTM),
     encode and decode, learn on and off, and once at reference_spec()'s
     full layout with the PPM and LSTM heads on seeded valid inputs: every
     output that can reach an archive bitwise (`ent` within 16 ulp over the
     byte, `ema` within 1e-6 relative: they go through log2f / torch.log2).
     Its sampling mode (generation: learn off, the bits drawn against
     logistic(logit(p) * inv_temp) and coded in encode mode, analysis on) the
     same way, at 1 / temperature = 1, 1.25 and 1000 (the floor), on the live
     ref-full inputs and at the reference layout, timed on the former.
     Which instantiation ran (lane groups, tables in shared memory or not,
     shared bytes) is printed, and the kernel's clocks instantiation gives
     each stage's share of the launch beside the SM clock;
   - the row movers, bitwise, on the five live arenas of ref-ppm (`ppm_tbl`,
     u16 rows of 272 lanes, among them) filled with seeded random bits: each
     arena alone, then the gathers and the scatters as the grouped launches
     the byte step makes (the four arenas of ref-noppm, the five of
     ref-ppm), each timed beside the single launches of the same rows, the
     torch indexing calls that compute the same, and an empty kernel
     launched the same way (`launch_floor_ms`);
   - the PPM count update and prediction kernels (csrc/ppm.cu) bitwise
     against their plain versions on the card and on the CPU, on seeded rows
     at reference_spec() x 54 and best_spec() x 30 (the benchmark's cells)
     and on hand-made edge streams (utils/ppm_inputs.py), each timed beside
     its plain version, called and replayed as a CUDA graph, and its bound;
   - the boundary contexts and match pointer kernels (csrc/contexts.cu)
     bitwise against their plain versions on the card (every stream, the
     tables at full size) and on the CPU (three streams' rows), on seeded
     states at reference_spec() x 54, best_spec() x 30 and ref-noppm x 63
     (the benchmark's cells) and on hand-made edge streams
     (utils/contexts_inputs.py), at a stream's first byte and after it; each
     timed beside its plain version, called and replayed as a CUDA graph,
     and its bound;
3. the main path at full width, at ref-noppm, ref-ppm and ref-full:
   compress_bytes then decompress_bytes of the first 16 KB of
   data/corpus_1m.bin on the GPU (16 streams, 1 KB per stream), which replay
   CUDA graphs of the byte step (the compiled chunk, core/step.py); the
   output must equal the input, and per byte step and direction the fused
   kernel, the boundary contexts' and the match pointers' must have launched
   exactly once and each mover once (ref-noppm: 5 launches a byte step) or
   twice (ref-ppm: 9; the PPM count update moves its own rows first, and its
   update and prediction are a kernel each); at ref-full the gather launches
   three times (10: the prediction's `ppm_tbl`
   rows come before the LSTM's forward pass, the other arenas after it) and
   the LSTM must have made its 10 backward passes per
   direction (chunk 1024: inside the byte that wraps the horizon window).
   A graph's launches are its replays times the launches its capture
   recorded (obs.launches). Each graph's
   capture seconds, launches a replay and the graph pool's bytes are
   printed. Then the same bytes through the eager loop (the byte steps
   dispatched op by op) and through graph replay on a copy of the
   predictor: two windows of STEP_WINDOW bytes for the wall ms a step (the
   first with the capture), then TRACE_STEPS bytes under torch.profiler for
   CUDA kernels, device busy ms and idle share a step, for each; the two states must be equal leaf for leaf after, and
   each window must launch the counts above. At ref-full also one backward
   pass op by op against its graph (wall, capture, LSTM leaves equal).
   Then generate_bytes on the warm predictor: a 256-byte prompt (replayed
   with learning), 256 sampled bytes a stream at temperature 0.8 in one
   chunk of 256; a sampling byte step must launch the kernels of an encode
   step less the byte-end scatter (ref-noppm 4, ref-ppm 8, ref-full 9).
   Then 256 bytes more without a prompt, timed, after which every
   long-term-memory leaf must be as it was; the sampling step eager against
   graphs as above;
4. GPU against CPU, at the three specs: at scale_tables(spec, 12,
   history_bits=16), 2 streams, the GPU archive (kernels) must equal the CPU
   archive (plain versions) byte for byte, and each device must decode the
   other's (the CPU's decodes run in processes of their own, beside the
   rest of the run): 512 bytes at ref-noppm and ref-ppm, 1000 bytes in
   chunks of 500 at ref-full (the horizon of 100 divides the chunk: the
   backward pass is deferred to the segment ends, the other of gmix_tpu's
   two orders). At
   ref-full the two trained predictors' checkpoints must be the same file,
   each must load on the other device, and the four predictors (GPU, CPU,
   and each loaded on the other device) must generate the same bytes from a
   16-byte prompt (32 bytes in chunks of 16) and end in the same checkpoint.
5. the command line (`gmix_tpu_torch.cli.main`, called in this process so
   that the launch counters see its kernels; every count set to 0 just
   before a command and read just after):
   (a) `--profile best --streams 8 --chunk 512`: compress with `--analysis`
       4 KB of data/corpus_1m.bin that no other phase codes, then
       decompress; the round trip exact, 10 launches a byte step each way,
       entropy.tsv's header `analysis_columns` and a finite row, memory.tsv's
       TOTAL equal to the state's size in gmix_tpu's layout (a u32 leaf at
       4 bytes an element) and to its rows' sum; bpb, model bpb, state and peak GB,
       bytes/s and the fused kernel's instantiation are printed (the bpb
       beside ref-full's of phase 3, a reading: other bytes, other streams);
   (b) `--profile scaled-12 --streams 2` on the GPU and on the CPU (the CPU's
       commands are `python -m gmix_tpu_torch.cli --device cpu` processes
       started before phase 4, which they run beside): compress 512 bytes
       with `--analysis`, decompress, `train` on them with a 256-byte test
       file, `generate -k` 32 bytes at 0.8 from each device's checkpoint.
       The archives, memory.tsv, training.tsv, the checkpoints and the
       generated bytes must be the same files; entropy.tsv the same bits
       and its values within 1e-6 relative or one unit of the fifth decimal
       it prints; each device decodes the other's archive; a sampling step
       launches 9 kernels;
   (c) wiki-encode -> dict-encode -> compress (scaled-12, 8 streams) of a
       small generated MediaWiki dump, and back: the same bytes.
6. stream sharding (gmix_tpu_torch.parallel), after the rest:
   (a) ref-full at 16 streams split over a mesh of two entries, both this
       card, in this process, beside the unsharded predictor: 2 KB of the
       corpus that no other phase codes, chunk 128. The archives must be the
       same bytes, each predictor must decode the other's, their checkpoints
       must be the same file, and each shard must launch 10 kernels a byte
       step; the wall times of both, a reading;
   (b) two processes over gloo on this card, 8 streams each, code phase 3's
       16 KB at ref-full with compress_bytes_multihost: each must return
       phase 3's archive byte for byte and launch 10 kernels a byte step;
       each prints its launches, encode bytes/s and peak memory, and the
       aggregate bytes/s is printed beside phase 3's one process (a reading);
   (c) a world of one rank over nccl: phase 4's ref-noppm run through
       compress_bytes_multihost must give phase 4's GPU archive.
7. the bench (`gmix_tpu_torch.bench.main`, in this process, the counts set
   to 0 just before each run and read just after), at the published sizes.
   First one stream of ref-full trained at S=1 (the bench's warm start)
   must equal lane 0 of two streams coding the same bytes, every leaf
   bitwise.
   (a) ref-full, 16 streams from a 2000-byte warm start, 32 KB that no
       other phase codes, chunk 1000, two passes each way; run twice
       through one `--warm-checkpoint` under build/: the first run trains
       the warm start and writes it, the second reads it; the file must
       hold the S=1 warm start above, every leaf bitwise, and the two
       archives must be the same bytes;
   (b) ref-full, `--streams auto`: as many streams as fit the card, 8000
       bytes in chunks of 200 after a 1000-byte warm start, then
       `--trace 100` (one horizon of encode byte steps under
       torch.profiler, after the passes); its stream count, estimate, peak
       memory and trace row are printed;
   (c) best, ref-ppm and ref-noppm, 4 streams each, 8000 bytes in chunks of
       200 after a 1000-byte warm start.
   Each run must be exact in every pass with the same archive (the bench
   raises otherwise), its cross-entropy finite at every chunk, every byte
   step (warm start, graph capture, passes and traced window) must launch
   the profile's kernels (gather, scatter, fused, PPM update, PPM prediction,
   contexts boundary, match pointers: 3 + 2 + 1 + 1 + 1 + 1 + 1 at ref-full
   and best, 2 + 2 + 1 + 1 + 1 + 1 + 1 at ref-ppm, 1 + 1 + 1 + 0 + 0 + 1 + 1
   at ref-noppm), and the state must
   be the bytes the bench estimated. The step's roofline of each run is
   logged (the bench's count of a byte step from the spec, its bound, and
   the shares of the card's peaks: `mfu`, `hbm_share`, `roofline_share`),
   and each share must lie in (0, SHARE_MAX] in the result row (against
   the best encode pass's step) and in the trace row (against the device's
   busy time): a share above 1 counts work the step does not do.
8. the ensemble variants (`gmix_tpu_torch/variants.py`, bench profiles) at
   the shapes they bring to the kernels: ref:ablate-indonly (no match
   model, no PPM or LSTM head, one mixer a layer, no indirect-hash arena),
   ref:ablate-nomix12 (one mixer in layers 0 and 1), ref:ablate-nomatch,
   ref:ablate-noih (no `ih_tbl`, the mixers re-gated), ref:ablate-mixtb0
   (every gating table one row: no `mix_w` or `mix_pos` arena),
   ref:ladder-lean (16 indirect models, no LSTM) and quality:ref-x4-oldppm
   (PPM without exclusion or SEE learning, no APM stage). For each:
   (a) the fused kernel against its plain version on live inputs of 4
       streams at the published sizes, as in phase 2 (encode and decode,
       learn on and off; bitwise but `ent` and `ema`), its instantiation,
       bound and time;
   (b) compress_bytes then decompress_bytes of 1 KB a stream, 4 streams, at
       the published sizes: the input back, and each byte step and each
       graph replay launching what the code says (`launches_per_step`:
       1 + 1 + 1 without PPM, 2 + 2 + 1 + 1 + 1 with PPM, 3 + 2 + 1 + 1 + 1
       with PPM and the LSTM, then the boundary contexts' 1 and the match
       pointers' 1, 0 without a match model);
   (c) at scale_tables(spec, 12, history_bits=16), 2 streams of 512 bytes:
       the GPU's archive equal to the CPU's byte for byte (the CPU's encode
       and decode run in a process a variant, started before phase 7), the
       GPU decoding the CPU's archive and the CPU its own, which is the
       GPU's, to the input.
   Then the bench with two variant profiles in one call
   (ref:ladder-lean,ref:ablate-indonly, 4 streams), exact, each byte step
   launching its profile's kernels, and the device's allocated bytes at the
   start of the second run those at the start of the first.
9. the sweeps (`gmix_tpu_torch/sweeps.py`, the JAX repository's sequential,
   warm-start, ring, scaling and wiki tools), first the three kernels on
   the live inputs of a byte step at the shapes the sweeps bring: one
   stream of reference_spec() and of best_spec() at the published sizes and
   256 streams of scaling's spec (reference_spec() at 12 bits, 26 GB): the
   fused kernel against its plain version as in phase 2, the grouped
   gather of the step's arenas (three at reference_spec(), which has no
   APM stage, four at best_spec()) on the step's own rows and the grouped
   scatter of the rows the kernel learned, bitwise against their plain
   versions (every arena whole), and each timed with its plain version
   (the movers on fresh random rows, as in phase 2). Then each sweep at a
   cut size through `sweeps.main` in this process (SWEEP_RUNS): sequential
   ref and best, 8000 bytes each way from a fresh stream, exact; ref's
   graphs captured alone; the warm sweep's two snapshots and 128 streams
   coding 512 000 bytes from each; the ring sweep on 256 KB of dump at a
   ring that wraps and one that does not; scaling at 1, 16 and 256
   streams; the wiki chain on 1 MB of dump, byte-identical. Every run must
   exit 0, and every byte step it ran launch 3 + 2 + 1 + 1 + 1 + 1 + 1 kernels.

ref-full is gmix_tpu's reference wiring (`reference_spec()`: PPM, the LSTM
byte model of 50 cells with a horizon of 100) at its published table sizes
with the two SSE/APM stages of bench.py; ref-ppm is ref-full without the
LSTM; ref-noppm is ref-ppm without PPM and the rolling contexts that only
PPM reads.

Each kernel's `bound_ms` is the least time the card could take for the same
work: the larger of its bytes (each input read once, each output written
once) over 3.35 TB/s and its float operations over 67 TFLOP/s (float32
outside the tensor cores), the published peaks of an H100 SXM.

The line before the last is a JSON object describing each kernel (a mover's
numbers are those of the ref-ppm byte step's one grouped launch of five
arenas, with the four-arena group of ref-noppm and the single launches per
arena beside them; `launches` sums the main paths: the three specs' encode,
decode and generation, the command line's commands on the card, the sharded
predictor's encode and decode (`mesh`), the ranks' encodes (`distributed`),
the bench's six runs (`bench`), phase 8's roundtrips and two bench runs
(`variants`) and phase 9's sweeps (`sweeps`), all replays of CUDA graphs;
each entry's `sweeps` holds the kernel's numbers on phase 9's live inputs;
`launches_per_replay` gives each of phase 3's graphs' launches of the
kernel); the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import os
import re
import shlex
import signal
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import gmix_tpu_torch as gt
from gmix_tpu_torch import bench, cli, obs, sweeps
from gmix_tpu_torch.bench import padded_per, ref_noppm_spec, ref_ppm_spec, spec_for, trace_window
from gmix_tpu_torch.config import best_spec, reference_spec, scale_tables
from gmix_tpu_torch.core import contexts, fused, ppm
from gmix_tpu_torch.core import step as step_mod
from gmix_tpu_torch.core.codec import (Predictor, analysis_columns, compress_bytes, decompress_bytes, entropy_bits,
                                       generate_bytes, run_chunks)
from gmix_tpu_torch.core.meta import build_meta
from gmix_tpu_torch.ops import rowmove
from gmix_tpu_torch.parallel import distributed
from gmix_tpu_torch.parallel.mesh import make_mesh, stream_sharding
from gmix_tpu_torch.roofline import PEAK_BYTES_PER_S, SHARES, TRANSCENDENTAL, bound, fused_bound, tensor_bytes
from gmix_tpu_torch.state import init_state, numpy_layout, state_bytes
from gmix_tpu_torch.utils.build import build
from gmix_tpu_torch.utils import contexts_inputs, ppm_inputs
from gmix_tpu_torch.utils.fused_inputs import random_inputs, with_sampling
from gmix_tpu_torch.utils.serialization import copy_state

ROOT = os.path.dirname(os.path.abspath(__file__))
STREAMS = 16
MAIN_BYTES = 16 * 1024
CHUNK = 1024
SEED = 1234
WARM_BYTES = 48  # byte steps before the fused kernel's inputs are taken
# bytes a window of phase 3's eager-against-graphs comparison (two windows:
# the first with the graphs' capture, then one timed). Near the reference
# horizon (100) but no multiple of it, so that the backward pass runs inside
# the wrapping byte, and at ref-full each window from byte 1024 holds one
# such byte (1099, 1199); then TRACE_STEPS bytes twice (capture, trace)
# under torch.profiler, which hold none
STEP_WINDOW, TRACE_STEPS = 96, 16
# generation on the warm predictor of phase 3: prompt and sampled bytes a
# stream, temperature, chunk; phase 4's at scaled-12 (the CPU is slow)
GEN_PROMPT, GEN_BYTES, GEN_TEMP, GEN_CHUNK = 256, 256, 0.8, 256
CROSS_PROMPT, CROSS_GEN, CROSS_CHUNK = 16, 32, 16
# the sampling mode's 1 / temperature: the default, 0.8, and the floor
INV_TEMPS = (1.0, 1.25, 1000.0)
SOURCES = {
    "gather_rows": "gmix_tpu_torch/csrc/rowmove.cu",
    "scatter_rows": "gmix_tpu_torch/csrc/rowmove.cu",
    "fused_substeps": "gmix_tpu_torch/csrc/fused_kernel.cuh",
    "ppm": "gmix_tpu_torch/csrc/ppm.cu",
    "contexts": "gmix_tpu_torch/csrc/contexts.cu",
}
REPLACES = {
    "gather_rows": "gmix_tpu/ops/rowmove.py:85",
    "scatter_rows": "gmix_tpu/ops/rowmove.py:116",
    "fused_substeps": "gmix_tpu/core/fused.py:249",
}
# the arenas the byte step moves rows of (indirect models, stable mixers,
# position-gated mixers, APM stages, PPM orders) by their place in the state;
# ref-noppm has the first four
ARENAS = (("ind.st", ("ltm", "ind", "st")), ("mix_w", ("ltm", "mix_w")), ("mix_pos", ("ltm", "mix_pos")),
          ("apm", ("ltm", "apm")), ("ppm_tbl", ("stm", "ppm_tbl")))
# launches by kernel (obs.launches, by wrapper): each mover kernel has two
# wrappers (one arena, a group of arenas)
WRAPPERS = (("gather_rows", "gather_rows_many"), ("scatter_rows", "scatter_rows_many"), ("fused_substeps",),
            ("ppm_update",), ("ppm_predict",), ("contexts_boundary",), ("match_pointer",))
# what a tuple of launch counts holds, in WRAPPERS' order
LAUNCHES = "(gather, scatter, fused, PPM update, PPM prediction, contexts boundary, match pointers)"
NO_LAUNCHES = (0,) * len(WRAPPERS)
_LAUNCHES_AT_RESET = {}
# archive sizes that must not change: the codec is deterministic, and these
# specs' archives have been these bytes since the port first produced them
# (phase 4 of ref-noppm and ref-ppm coded 1 KB into 794 and 710 bytes until
# the LSTM's phases took their time; the code that did codes 512 bytes into
# 523 and 452)
KNOWN_ARCHIVE_BYTES = {("ref-noppm", "main"): 9978, ("ref-noppm", "cross"): 523,
                       ("ref-ppm", "main"): 9184, ("ref-ppm", "cross"): 452,
                       ("ref-full", "main"): 9081, ("ref-full", "cross"): 683}
# phase 4's input bytes and chunk by spec (2 streams)
CROSS_RUNS = {"ref-noppm": (512, 256), "ref-ppm": (512, 256), "ref-full": (1000, 500)}
# phase 5, the command line. (a) best_spec() at full width: 4 KB at an
# offset of the corpus that no other phase codes, 8 streams, chunk 512 (one
# analysis row; the backward pass inside the wrapping byte)
CLI_BEST = ("--profile", "best", "--streams", "8", "--chunk", "512")
CLI_BEST_OFFSET, CLI_BEST_BYTES, CLI_BEST_PER = 32 * 1024, 4096, 512
# (b) GPU against CPU at scaled-12, 2 streams: 512 bytes coded and trained on
# in chunks of 128 (two analysis rows), a 256-byte test file, 32 bytes
# generated at GEN_TEMP from a 16-byte prompt in chunks of 16
CLI_CROSS = ("--profile", "scaled-12", "--streams", "2")
CLI_CROSS_OFFSET, CLI_CROSS_BYTES, CLI_TEST_BYTES, CLI_CHUNK = 40 * 1024, 512, 256, 128
CLI_PROMPT, CLI_GEN, CLI_GEN_CHUNK = 16, 32, 16
# (c) the preprocessing chain: a dump of this many pages, 8 streams
CLI_WIKI_PAGES, CLI_WIKI_ARGS = 8, ("--profile", "scaled-12", "--streams", "8", "--chunk", "128")
# phase 6, stream sharding. (a) ref-full at full width, 16 streams split
# over a mesh of SHARDS entries all on the one card: 2 KB at an offset of the
# corpus that no other phase codes, chunk 128 (128 byte steps; the backward
# pass inside the wrapping byte)
SHARDS, SHARD_OFFSET, SHARD_BYTES, SHARD_CHUNK = 2, 48 * 1024, 2048, 128
# (b) RANKS processes over gloo on the one card, phase 3's ref-full run
# (16 streams in all, 16 KB, chunk 1024); (c) one rank over nccl, phase 4's
# run of NCCL_SPEC
RANKS, NCCL_SPEC = 2, "ref-noppm"
# phase 7, the bench (gmix_tpu_torch.bench.main in this process) at the
# published sizes. (a) 16 streams: one stream trained on the corpus' first
# 2000 bytes (two chunks of 1000), broadcast to all, then 32 KB at an offset
# that no other phase codes, chunk 1000, two passes each way, twice through
# one warm checkpoint; (b) as many streams as fit the card, 8000 bytes at
# another such offset in chunks of 200 (one chunk a stream from 40 streams
# up) after a 1000-byte warm start, then one horizon traced; (c) each other
# profile at 4 streams, 8000 bytes at a third offset (2000 byte steps a
# stream, 10 chunks)
BENCH_A = ("--profile", "ref", "--streams", "16", "--warm", "2000", "--offset", str(64 * 1024), "--bytes", "32768",
           "--chunk", "1000", "--passes", "2")
BENCH_B = ("--profile", "ref", "--streams", "auto", "--warm", "1000", "--offset", str(100 * 1024), "--bytes", "8000",
           "--chunk", "200", "--passes", "2", "--trace", "100")
BENCH_C = ("--streams", "4", "--warm", "1000", "--offset", str(112 * 1024), "--bytes", "8000", "--chunk", "200",
           "--passes", "2")
BENCH_C_PROFILES = ("best", "ref-ppm", "ref-noppm")
# the most a share of the card's peaks may read in the bench's rows (a step
# cannot beat its bound; 5% for a host-timed step)
SHARE_MAX = 1.05

# phase 8, the ensemble variants (gmix_tpu_torch/variants.py) by bench
# profile: the shapes they bring to the kernels (no match models, one mixer
# a layer, no indirect-hash arena, 1-row gating tables, 16 indirect models,
# PPM without exclusion and no APM stage). (a) and (b) at VARIANT_STREAMS
# streams of the published sizes, VARIANT_PER bytes a stream; (c) at
# scaled-12, VARIANT_CROSS_STREAMS streams of VARIANT_CROSS_PER bytes in
# chunks of VARIANT_CROSS_CHUNK (the LSTM's backward pass inside the
# wrapping byte); then the bench, two profiles in one call
VARIANTS = ("ref:ablate-indonly", "ref:ablate-nomix12", "ref:ablate-nomatch", "ref:ablate-noih", "ref:ablate-mixtb0",
            "ref:ladder-lean", "quality:ref-x4-oldppm")
VARIANT_STREAMS, VARIANT_PER = 4, 1024
VARIANT_CROSS_STREAMS, VARIANT_CROSS_PER, VARIANT_CROSS_CHUNK = 2, 512, 512
VARIANT_BENCH = ("--profile", "ref:ladder-lean,ref:ablate-indonly", "--streams", "4", "--warm", "4096", "--offset",
                 str(120 * 1024), "--bytes", "16384", "--chunk", "1024", "--passes", "1")

# phase 9, the sweeps (gmix_tpu_torch/sweeps.py, through sweeps.main in
# this process) at cut sizes: sequential ref and best 8000 bytes each way
# and ref's graphs captured alone (one chunk of 1000 each way); the warm
# sweep's two snapshots (8000 and 32000 bytes trained) and 4000 byte steps
# of 128 streams from each; the ring sweep on 256 KB of dump (about 7 KB a
# stream after the transforms) with a ring of 4 KB (it wraps) and of 16 KB;
# scaling at 1, 16 and 256 streams; the wiki chain on 1 MB of dump.
# Before them the kernels on live inputs of one stream of ref and of best
# and of SWEEP_WIDE streams of scaling's spec
SWEEP_RUNS = (
    ("sequential ref", ("sequential", "ref", "--bytes", "8000", "--chunk", "4000")),
    ("sequential best", ("sequential", "best", "--bytes", "8000", "--chunk", "4000")),
    ("sequential ref, graphs captured alone", ("sequential", "ref", "--capture-only", "--chunk", "1000")),
    ("warm", ("warm", "--sizes", "8192,32768", "--profile", "11x128", "--chunk", "4000", "--bench-bytes", "512000")),
    ("ring", ("ring", "12", "14", "--profile", "11x16", "--chunk", "4000", "--corpus-bytes", str(256 * 1024))),
    ("scaling", ("scaling", "1", "16", "256", "--profile", "scaled-12", "--chunk", "512")),
    ("wiki", ("wiki", str(1 << 20), "--profile", "scaled-11x128", "--chunk", "4000")),
)
SWEEP_WIDE = 256

# the bench's profiles ref-noppm, ref-ppm and ref (ref-full here)
SPECS = {"ref-noppm": ref_noppm_spec, "ref-ppm": ref_ppm_spec, "ref-full": functools.partial(spec_for, None)}


def rows_per_byte(meta):
    """Rows per stream that a byte step moves in each arena."""
    return {
        "ind.st": len(meta.spec.indirects),
        "mix_w": len(meta.mix_st_ix),
        "mix_pos": len(meta.mix_pos_ix),
        "apm": len(meta.spec.apm),
        "ppm_tbl": len(meta.spec.ppm.orders) if meta.spec.ppm else 0,
    }


def launches_per_step(spec):
    """`LAUNCHES` of an encode or decode byte step, from the code
    (core/step.py, core/ppm.py, core/contexts.py): one grouped gather and
    one grouped scatter of the movers' arenas and one fused launch; with PPM
    its count update's own gather and scatter of `ppm_tbl` rows and one
    launch each of the count update's and the prediction's kernels; with
    PPM and the LSTM also the prediction's `ppm_tbl` rows gathered alone
    before the forward pass; one launch of the boundary contexts' kernel,
    and one of the match pointers' with match models."""
    ppm, lstm = spec.ppm is not None, spec.lstm is not None
    return (1 + int(ppm) + int(ppm and lstm), 1 + int(ppm), 1, int(ppm), int(ppm), 1, int(bool(spec.matches)))


def profile_launches(profile: str):
    """`launches_per_step` of a bench profile's spec."""
    return launches_per_step(bench.parse_profile(profile)[1])


def log(msg: str) -> None:
    print(msg, flush=True)


def corpus(n: int) -> bytes:
    with open(os.path.join(ROOT, "data", "corpus_1m.bin"), "rb") as f:
        data = f.read(n)
    if len(data) != n:
        raise RuntimeError(f"corpus_1m.bin holds {len(data)} bytes, need {n}")
    return data


def call_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median time of one call as its caller sees it on an idle device: CUDA
    events around each single call, so the host's work inside the call (the
    wrapper, or the dispatch of a plain version's many small kernels) counts.
    `fn(i)` takes the repetition index so each call can move other rows."""
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


def device_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Device time of one call: `reps` calls run back to back between two
    CUDA events. The device first spins (torch.cuda._sleep) for twice as long
    as the host needs to enqueue them all, so no host gap is counted. The
    warm-up and the enqueue rehearsal call fn with indices from `reps` up
    (below 2 * reps + warmup), the timed pass with 0 .. reps - 1, so a caller
    can keep the timed calls on rows no earlier call has touched."""
    for i in range(warmup):
        fn(2 * reps + i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(reps + i)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2e9) + 4_000_000)  # cycles, at under 2 GHz
    a.record()
    for i in range(reps):
        fn(i)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def unique_rows(rng, S: int, N: int, M: int, device) -> torch.Tensor:
    idx = np.stack([rng.choice(N, size=M, replace=False) for _ in range(S)]).astype(np.int32)
    return torch.as_tensor(idx, device=device)


def fill_random_(t: torch.Tensor, gen: torch.Generator) -> None:
    """Seeded random contents, in place: normal floats or random integers."""
    if t.is_floating_point():
        t.normal_(generator=gen)
    else:
        t.random_(generator=gen)


def reset_launches() -> None:
    """Count launches from here (`read_launches`)."""
    _LAUNCHES_AT_RESET.clear()
    _LAUNCHES_AT_RESET.update(obs.launches())


def read_launches():
    """`LAUNCHES` since the last reset."""
    now = obs.launches()
    return tuple(sum(now.get(w, 0) - _LAUNCHES_AT_RESET.get(w, 0) for w in group) for group in WRAPPERS)


# ---------------------------------------------------------------------------
# phase 2a: the fused sub-step kernel
# ---------------------------------------------------------------------------


def compare_fused(what: str, meta, consts, fin, learn: bool, analysis: bool, sample: bool = False) -> float:
    """Kernel against plain version on the same inputs, on the card. Raises
    on a difference; returns the largest absolute difference of any float
    output (0.0 but for `ent` and `ema`)."""
    got = fused.fused_substeps(meta, consts, fin, learn, analysis, sample)
    torch.cuda.synchronize()
    want = fused.fused_substeps_plain(meta, consts, fin, learn, analysis, sample)
    torch.cuda.synchronize()
    if sorted(got) != sorted(want):
        raise RuntimeError(f"{what}: outputs {sorted(got)} != {sorted(want)}")
    err = 0.0
    for name, a in want.items():
        b = got[name]
        if a.shape != b.shape or a.dtype != b.dtype:
            raise RuntimeError(f"{what}: {name} is {tuple(b.shape)} {b.dtype}, plain {tuple(a.shape)} {a.dtype}")
        if not (torch.isfinite(b).all() if b.is_floating_point() else True):
            raise RuntimeError(f"{what}: {name} is not finite")
        if b.is_floating_point():
            err = max(err, (a.double() - b.double()).abs().max().item())
        if name == "ent":
            np.testing.assert_array_max_ulp(b.cpu().numpy(), a.cpu().numpy(), maxulp=16)
        elif name == "ema":
            torch.testing.assert_close(b, a, rtol=1e-6, atol=0)
        elif not torch.equal(a.contiguous().view(torch.uint8), b.view(torch.uint8)):
            bad = (a != b).sum().item()
            raise RuntimeError(f"{what}: {name} differs from the plain version in {bad} of {a.numel()} elements")
    return err


def stage_shares(clk: np.ndarray) -> dict:
    """Each stage's cycles and share of the launch from the clocks
    instantiation's (S, 8, cols) timestamps: a stage lasts from the boundary
    before it to its own; per block a stage's 8 sub-steps are summed and
    divided by the block's launch; the median over blocks is reported, with
    the median cycles of one occurrence (over blocks and sub-steps).
    `side` holds the marks of the warps that work beside thread 0, in
    cycles from the sub-step's start (prep_*: the warps that square the
    triangular tiles) or from the final dot (learn_*: the warps that learn
    while thread 0 runs the tail)."""
    at = {n: i for i, n in enumerate(fused.CLOCK_COLS)}
    launch = {n: clk[:, 0, at[n]] for n in fused.CLOCK_LAUNCH}
    total = (launch["end"] - launch["start"]).astype(np.float64)
    spans = {"load": (launch["loaded"] - launch["start"])[:, None]}
    side = {n: [] for n in fused.CLOCK_SIDE}
    learned = (clk[:, :, at["learn_rows_done"]] > 0).all()
    prev = launch["loaded"]
    for j in range(8):
        marks = {n: clk[:, j, at[n]] for n in fused.CLOCK_COLS}
        # where the warps meet, a mark is not earlier than the last arrival
        # (the compiler may read thread 0's clock before the barrier)
        marks["squarings_wait"] = np.maximum(marks["squarings_wait"], marks["prep_done"])
        if learned:
            marks["learn_wait"] = np.maximum(marks["learn_wait"], marks["learn_rows_done"])
        for n in fused.CLOCK_SIDE:
            side[n].append(marks[n] - (prev if n.startswith("prep") else marks["final_dot"]))
        for name in fused.CLOCK_SUBSTEP:
            cur = marks[name]
            spans[name] = np.concatenate([spans.get(name, np.zeros((len(cur), 0), np.int64)), (cur - prev)[:, None]], axis=1)
            prev = cur
    spans["deferred_passes"] = (launch["deferred"] - prev)[:, None]
    spans["write_back"] = (launch["writeback"] - launch["deferred"])[:, None]
    spans["registers_out"] = (launch["end"] - launch["writeback"])[:, None]
    return {
        "launch_cycles": float(np.median(total)),
        "side": {n: float(np.median(np.stack(v))) for n, v in side.items() if (np.stack(v) > 0).all()},
        "stages": {name: {"cycles": float(np.median(dur)), "share": round(float(np.median(dur.sum(axis=1) / total)), 4)}
                   for name, dur in spans.items()},
    }


def phase_stage_clocks(meta, consts, fin, dev) -> dict:
    """Run the clocks instantiation on the live inputs, check that it computes
    what the main path's kernel computes, and print each stage's share."""
    want = fused.fused_substeps(meta, consts, fin, True, True)
    for _ in range(3):
        got, clk = fused.fused_substeps_clocks(meta, consts, fin, True, True)
    torch.cuda.synchronize()
    for name, a in want.items():
        if not torch.equal(a.view(torch.uint8), got[name].view(torch.uint8)):
            raise RuntimeError(f"phase 2: the clocks instantiation differs from the kernel in {name}")
    sm_mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    row = {"clocks_sm": sm_mhz, **stage_shares(clk.cpu().numpy())}
    log(f"phase 2: fused_substeps stage clocks {json.dumps(row)}")
    return row


def decode_variant(fin, seed: int):
    """The same byte as a decode step: direction flag set, a seeded window of
    code bytes, and the decoder's code value inside [x1, x2]."""
    out = {k: v.clone() for k, v in fin.items()}
    out["sc"][:, fused.SC_DECODE] = 1
    gen = torch.Generator(device=fin["sc"].device).manual_seed(seed)
    out["win_r"][:, : fused.CODER_WIN] = torch.randint(
        0, 256, (fin["sc"].shape[0], fused.CODER_WIN), generator=gen, device=fin["sc"].device)
    x1, x2 = out["coder"][:, fused.CR_X1], out["coder"][:, fused.CR_X2]
    out["coder"][:, fused.CR_X] = x1 + (x2 - x1) // 3
    return out


def live_inputs(pred, dev):
    """Warm `pred` over WARM_BYTES corpus bytes and take the next byte step
    up to the sub-steps: (fin, work, ix) of `step_mod._byte_inputs`, the
    fused kernel's packed inputs and the movers' row indices."""
    S = pred.num_streams
    data = np.frombuffer(corpus(S * 2 * WARM_BYTES), np.uint8).reshape(S, 2 * WARM_BYTES)
    data_buf = torch.as_tensor(data.copy(), device=dev)
    code_buf = torch.zeros((S, 1), dtype=torch.uint8, device=dev)
    run_chunks(pred, data_buf, code_buf, WARM_BYTES, decode=False, chunk=WARM_BYTES)
    return step_mod._byte_inputs(pred.state, data_buf, code_buf, WARM_BYTES, False, pred.plan, True)


def compare_fused_live(name: str, pred, dev, fin=None):
    """Take the packed inputs of a live byte step (`live_inputs`, unless
    `fin` holds them) and hold the kernel against its plain version on
    them: encode and decode, learn on and off. Returns (the encode and
    decode inputs, the largest float difference)."""
    meta, plan = pred.meta, pred.plan
    fin = live_inputs(pred, dev)[0] if fin is None else fin
    cases = {"encode": fin, "decode": decode_variant(fin, SEED)}
    err = 0.0
    for direction, f_in in cases.items():
        for learn in (True, False):
            err = max(err, compare_fused(f"phase 2 fused {name} {direction} learn={learn}", meta, plan.fused, f_in, learn, True))
    return cases, err


def compare_fused_sampling(what: str, meta, consts, fin) -> dict:
    """The sampling mode against its plain version on `fin` made a sampling
    step (learn off, encode, analysis on), at each of INV_TEMPS with its own
    seeded uniforms."""
    err, cases = 0.0, {}
    for k, inv_temp in enumerate(INV_TEMPS):
        cases[inv_temp] = f_in = with_sampling(fin, SEED + k, inv_temp)
        err = max(err, compare_fused(f"phase 2 fused {what} sampling inv_temp={inv_temp}", meta, consts, f_in, False,
                                     True, sample=True))
    return {"compared": len(INV_TEMPS), "max_abs_err": err, "cases": cases}


def phase_fused_heads(name, pred, dev) -> dict:
    """The fused kernel against its plain version on live inputs at a layout
    with byte-model heads: ref-ppm (the PPM head alone: the prediction columns
    shifted by one) or ref-full (the PPM and the LSTM head, fed by a running
    LSTM)."""
    meta, plan, S = pred.meta, pred.plan, pred.num_streams
    cases, err = compare_fused_live(name, pred, dev)
    for probs in ("ppm_probs", "lstm_probs")[: 1 + int(meta.spec.lstm is not None)]:
        p = cases["encode"][probs]
        if not torch.isfinite(p).all() or not torch.allclose(p.sum(dim=1), torch.ones_like(p[:, 0]), atol=1e-4):
            raise RuntimeError(f"phase 2: {probs} of the warmed {name} state is not a distribution")
    row = {"spec": name, "streams": S, "warm_bytes": WARM_BYTES, "max_abs_err": err,
           **fused_bound(meta, plan.fused, cases["encode"], S),
           "instantiation": fused.fused_instantiation(meta, plan.fused, True, True, S, dev),
           "ms": device_ms(lambda i: fused.fused_substeps(meta, plan.fused, cases["encode"], True, True), reps=50),
           "decode_ms": device_ms(lambda i: fused.fused_substeps(meta, plan.fused, cases["decode"], True, True), reps=50)}
    if meta.spec.lstm is not None:
        # the sampling mode on the same live inputs, timed beside the encode
        # with learn off (what a sampling launch leaves out)
        smp = compare_fused_sampling(name, meta, plan.fused, cases["encode"])
        f_s = smp["cases"][1.25]
        row["sample"] = {
            "compared": smp["compared"], "max_abs_err": smp["max_abs_err"],
            **fused_bound(meta, plan.fused, f_s, S, learn=False, sample=True),
            "ms": device_ms(lambda i: fused.fused_substeps(meta, plan.fused, f_s, False, True, True), reps=50),
            "call_ms": call_ms(lambda i: fused.fused_substeps(meta, plan.fused, f_s, False, True, True), reps=50),
            "plain_ms": call_ms(lambda i: fused.fused_substeps_plain(meta, plan.fused, f_s, False, True, True), reps=3,
                                warmup=1),
            "encode_nolearn_ms": device_ms(lambda i: fused.fused_substeps(meta, plan.fused, cases["encode"], False, True),
                                           reps=50),
            "encode_call_ms": call_ms(lambda i: fused.fused_substeps(meta, plan.fused, cases["encode"], True, True), reps=50),
        }
        row["max_abs_err"] = max(err, smp["max_abs_err"])
    log(f"phase 2: fused_substeps {json.dumps(row)}")
    return row


def phase_fused(pred, dev):
    """The fused kernel against its plain version at ref-noppm on live
    inputs, and at the reference layout with both heads on seeded inputs."""
    meta, plan, S = pred.meta, pred.plan, pred.num_streams
    cases, err = compare_fused_live("ref-noppm", pred, dev)
    fin = cases["encode"]
    n_cmp = obs.launches().get("fused_substeps", 0)
    inst = fused.fused_instantiation(meta, plan.fused, True, True, S, dev)
    log(f"phase 2: fused_substeps instantiation at ref-noppm {json.dumps(inst)}")
    clocks = phase_stage_clocks(meta, plan.fused, fin, dev)
    # timing, at the main path's flags (encode, learn, analysis)
    t = {
        "ms": device_ms(lambda i: fused.fused_substeps(meta, plan.fused, fin, True, True), reps=50),
        "call_ms": call_ms(lambda i: fused.fused_substeps(meta, plan.fused, fin, True, True), reps=50),
        # the plain version is thousands of small kernels, bound by the
        # host's dispatch: its time is what a caller waits for
        "plain_ms": call_ms(lambda i: fused.fused_substeps_plain(meta, plan.fused, fin, True, True), reps=5, warmup=1),
        "decode_ms": device_ms(lambda i: fused.fused_substeps(meta, plan.fused, cases["decode"], True, True), reps=50),
        "nolearn_ms": device_ms(lambda i: fused.fused_substeps(meta, plan.fused, fin, False, True), reps=50),
    }
    row = {"spec": "ref-noppm", "streams": S, "warm_bytes": WARM_BYTES, "compared": n_cmp, "max_abs_err": err,
           **fused_bound(meta, plan.fused, fin, S), "instantiation": inst,
           "launch_cycles": clocks["launch_cycles"], "clocks_sm": clocks["clocks_sm"], **t}
    log(f"phase 2: fused_substeps {json.dumps(row)}")

    # the full reference layout: PPM and LSTM heads, the skip column, no APM
    meta_h = build_meta(reference_spec())
    consts_h = fused.const_inputs(meta_h, True, dev)
    head_err = 0.0
    for decode in (False, True):
        inp = random_inputs(meta_h, S, SEED + int(decode), decode=decode, not_first=True)
        fin_h = {n: torch.as_tensor(inp[n], device=dev) for n, _, _, kind in fused.io_layout(meta_h, True, True)[0] if kind == "s"}
        head_err = max(head_err, compare_fused(f"phase 2 fused reference+heads decode={decode}", meta_h, consts_h, fin_h, True, True))
    heads_ms = device_ms(lambda i: fused.fused_substeps(meta_h, consts_h, fin_h, True, True), reps=50)
    inst_h = fused.fused_instantiation(meta_h, consts_h, True, True, S, dev)
    # the sampling mode at this layout, on the encode case's inputs
    inp = random_inputs(meta_h, S, SEED, not_first=True)
    enc_h = {n: torch.as_tensor(inp[n], device=dev) for n, _, _, kind in fused.io_layout(meta_h, False, True)[0] if kind == "s"}
    smp = compare_fused_sampling("reference+heads", meta_h, consts_h, enc_h)
    log(f"phase 2: fused_substeps {json.dumps({'spec': 'reference (PPM and LSTM heads)', 'streams': S, 'max_abs_err': head_err, 'ms': heads_ms, 'instantiation': inst_h, 'sample_compared': smp['compared'], 'sample_max_abs_err': smp['max_abs_err']})}")
    row["max_abs_err"] = max(err, head_err, smp["max_abs_err"])
    row["sample_compared"] = smp["compared"]
    return row


# ---------------------------------------------------------------------------
# phase 2b: the row movers
# ---------------------------------------------------------------------------


def phase_rowmovers(pred, dev):
    """Each mover against its plain version on the arenas of a live
    Predictor, at the shapes the byte step gives it: every arena alone, then
    the groups the byte step launches."""
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    floor_ms = device_ms(lambda i: rowmove.empty_launch(dev))
    log(f"phase 2: an empty kernel launched as the movers are: {json.dumps({'launch_floor_ms': floor_ms})}")
    per_arena = []
    tables = []
    for name, path in ARENAS:
        tbl = pred.state
        for k in path:
            tbl = tbl[k]
        fill_random_(tbl, gen)
        tables.append(tbl)
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
        # timing: fresh random rows for every launch of every measurement, as
        # each byte step moves other rows out of an arena far larger than
        # the L2 cache. The library call is the one torch indexing op of the
        # plain version.
        s_ix = torch.arange(S, device=dev)[:, None]

        def timed(timer, op):
            ix = [unique_rows(rng, S, N, M, dev) for _ in range(64)]
            return timer(lambda i: op(ix[i]))

        def lib_scatter(ix):
            tbl[s_ix, ix] = upd

        t = {
            "gather_ms": timed(device_ms, lambda ix: rowmove.gather_rows(tbl, ix)),
            "gather_call_ms": timed(call_ms, lambda ix: rowmove.gather_rows(tbl, ix)),
            "gather_plain_ms": timed(device_ms, lambda ix: rowmove.gather_rows_plain(tbl, ix)),
            "gather_library_ms": timed(device_ms, lambda ix: tbl[s_ix, ix]),
            "scatter_ms": timed(device_ms, lambda ix: rowmove.scatter_rows(tbl, ix, upd)),
            "scatter_call_ms": timed(call_ms, lambda ix: rowmove.scatter_rows(tbl, ix, upd)),
            "scatter_plain_ms": timed(device_ms, lambda ix: rowmove.scatter_rows_plain(tbl, ix, upd)),
            "scatter_library_ms": timed(device_ms, lib_scatter),
        }
        # indices and rows read once, rows written once; no arithmetic
        moved = tensor_bytes([idx]) + 2 * tensor_bytes([upd])
        row = {"arena": name, "shape": [S, N, W], "dtype": str(tbl.dtype).replace("torch.", ""),
               "rows": M, "row_bytes": W * tbl.element_size(), "gather_err": g_err, "scatter_err": s_err,
               "bytes_moved": moved, "bound_ms": 1e3 * moved / PEAK_BYTES_PER_S, **t}
        log(f"phase 2: {json.dumps(row)}")
        per_arena.append(row)
    counts = [rows_per_byte(pred.meta)[name] for name, _ in ARENAS]
    names = [name for name, _ in ARENAS]
    grouped = {}
    for direction in ("gather", "scatter"):
        for n in (4, 5):  # the byte step's group at ref-noppm and at ref-ppm
            row = phase_grouped(direction, names[:n], tables[:n], counts[:n], rng, gen, dev)
            row["launch_floor_ms"] = floor_ms
            log(f"phase 2: {direction}_rows_many {json.dumps(row)}")
            grouped[direction, n] = row
    return per_arena, grouped


def phase_grouped(direction, names, tables, counts, rng, gen, dev):
    """The arenas' gathers (or scatters) as ONE launch, as the byte step makes
    them: bitwise against the plain version (a scatter: every whole table
    against a copy after the plain scatter), and timed beside the single
    launches of the same rows and the torch indexing calls that compute the
    same."""
    S = tables[0].shape[0]
    gather = direction == "gather"
    many, single = (rowmove.gather_rows_many, rowmove.gather_rows) if gather else (rowmove.scatter_rows_many, rowmove.scatter_rows)
    many_plain = rowmove.gather_rows_many_plain if gather else rowmove.scatter_rows_many_plain

    def fresh():
        return [unique_rows(rng, S, t.shape[1], m, dev) for t, m in zip(tables, counts)]

    upd = [torch.empty((S, m, t.shape[2]), dtype=t.dtype, device=dev) for t, m in zip(tables, counts)]
    for u in upd:
        fill_random_(u, gen)

    def args(ix, tbls=tables):
        return list(zip(tbls, ix)) if gather else list(zip(tbls, ix, upd))

    idx = fresh()
    refs = tables if gather else [t.clone() for t in tables]
    n0 = obs.launches().get(many.__name__, 0)
    got = many(args(idx))
    want = many_plain(args(idx, refs))
    torch.cuda.synchronize()
    if obs.launches().get(many.__name__, 0) != n0 + 1:
        raise RuntimeError(f"{direction}_rows_many did not make exactly one launch")
    err = 0.0
    for name, a, b in zip(names, want, got):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise RuntimeError(f"{direction}_rows_many differs from its plain version on {name}")
        if gather:
            err = max(err, (a.double() - b.double()).abs().max().item())
    if not gather:
        for u, back in zip(upd, rowmove.gather_rows_many_plain(list(zip(tables, idx)))):
            err = max(err, (u.double() - back.double()).abs().max().item())
    del refs, want, got
    torch.cuda.empty_cache()
    s_ix = torch.arange(S, device=dev)[:, None]

    def timed(timer, op):
        ix = [fresh() for _ in range(64)]
        return timer(lambda i: op(ix[i]))

    def library(ix):
        for tbl, i, u in zip(tables, ix, upd):
            if gather:
                tbl[s_ix, i]
            else:
                tbl[s_ix, i] = u

    def singles(ix):
        for a in args(ix):
            single(*a)

    t = {
        "ms": timed(device_ms, lambda ix: many(args(ix))),
        "call_ms": timed(call_ms, lambda ix: many(args(ix))),
        "plain_ms": timed(device_ms, lambda ix: many_plain(args(ix))),
        "library_ms": timed(device_ms, library),
        "single_launches_ms": timed(device_ms, singles),
        "single_launches_call_ms": timed(call_ms, singles),
    }
    moved = tensor_bytes(idx) + 2 * tensor_bytes(upd)
    return {"arenas": names, "rows": counts, "max_abs_err": err, "bytes_moved": moved,
            "bound_ms": 1e3 * moved / PEAK_BYTES_PER_S, **t}


# ---------------------------------------------------------------------------
# phase 2c: the PPM kernels
# ---------------------------------------------------------------------------

# the streams of the benchmark's cells at each spec (h100_bench: ref-s54,
# best-s30), at which the PPM kernels are timed
PPM_STREAMS = {"ref": 54, "best": 30}
PPM_SEEDS = 4


def ppm_float_ops(spec, S: int, which: str) -> int:
    """Float operations of one launch of the PPM kernel `which` ("update" or
    "predict"), counted as roofline.step_work counts the ppm part: the
    cascade (totals, the PPM-C prior, the SEE offset, logit and logistic),
    then the SEE learn, or the escape chain, the terms, their sum and order
    -1."""
    NO, NB = len(spec.ppm.orders), spec.ppm.see_buckets
    cascade = NO * ((256 - 1) + 3 + (2 * NB - 1) + 2 * TRANSCENDENTAL + 1)
    tail = NO * (2 + 2 * NB) if which == "update" else NO * (4 + 3 * 256) + (256 - 1) + 1 + 256 + 2 * 256
    return S * (cascade + tail)


def graphed(fn):
    """`fn` (a function of the repetition index) captured once as a CUDA
    graph, as the byte step's graphs hold it: a function that replays it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)  # allocations made before the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn(0)
    return lambda i: g.replay()


def compare_ppm(what: str, spec, inputs: dict, dev) -> None:
    """Both kernels on `inputs` against the plain versions on the card and
    on the CPU, bit for bit (rows, `ppm_see`, `ppm_probs`, top, bottom)."""
    S = inputs["cv"].shape[0]
    meta = build_meta(spec)
    got = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        plan = step_mod.StepPlan(meta, S, d)
        t = {k: torch.as_tensor(v.view(np.int16) if v.dtype == np.uint16 else v, device=d) for k, v in inputs.items()}
        out = {**dict(zip(("rows", "see"), ppm.ppm_update_rows(t["raw"], t["cv"], t["completed"], t["see"], plan))),
               **dict(zip(("probs", "top", "bot"), ppm.ppm_predict_probs(t["raw"], t["cv"], t["see"], plan)))}
        if where == "card":
            got["kernels"] = out
            got["card"] = {**dict(zip(("rows", "see"), ppm.ppm_update_plain(t["raw"], t["cv"], t["completed"],
                                                                            t["see"], plan))),
                           **dict(zip(("probs", "top", "bot"), ppm.ppm_predict_plain(t["raw"], t["cv"], t["see"], plan)))}
        else:
            got["cpu"] = out
    torch.cuda.synchronize()
    for where in ("card", "cpu"):
        for k, want in got[where].items():
            a, b = got["kernels"][k].cpu().contiguous(), want.cpu().contiguous()
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                raise RuntimeError(f"phase 2 {what}: the PPM kernels' {k} differs from the plain version on the {where}")


def phase_ppm(dev) -> dict:
    """The PPM count update and prediction kernels (csrc/ppm.cu) against
    their plain versions, bitwise, on seeded rows (`ppm_inputs.random_inputs`,
    PPM_SEEDS draws) at ref and best with the benchmark's stream counts and
    on the edge streams (`edge_inputs`); then each kernel timed beside its
    plain version, called (`plain_ms`) and replayed as a CUDA graph
    (`plain_graph_ms`: what the byte step's graph spent there before the
    kernels), and its bound."""
    rows = {}
    for name, spec in (("ref", reference_spec()), ("best", best_spec())):
        S, sp = PPM_STREAMS[name], spec.ppm
        NO, NB = len(sp.orders), sp.see_buckets
        for k in range(PPM_SEEDS):
            compare_ppm(f"{name} S={S} seed {k}", spec, ppm_inputs.random_inputs(NO, NB, S, SEED + k), dev)
        cv = np.random.default_rng(SEED).integers(0, 2**32, (len(ppm_inputs.EDGE_STREAMS), NO), dtype=np.int64)
        compare_ppm(f"{name} edges", spec, ppm_inputs.edge_inputs(cv, NB, sp.inc, sp.rescale_total), dev)
        plan = step_mod.StepPlan(build_meta(spec), S, dev)
        t = {k: torch.as_tensor(v.view(np.int16) if v.dtype == np.uint16 else v, device=dev)
             for k, v in ppm_inputs.random_inputs(NO, NB, S, SEED).items()}
        calls = {
            "update": (lambda i: ppm.ppm_update_rows(t["raw"], t["cv"], t["completed"], t["see"], plan),
                       lambda i: ppm.ppm_update_plain(t["raw"], t["cv"], t["completed"], t["see"], plan),
                       [t["raw"], t["cv"], t["completed"], t["see"], t["raw"], t["see"]]),
            "predict": (lambda i: ppm.ppm_predict_probs(t["raw"], t["cv"], t["see"], plan),
                        lambda i: ppm.ppm_predict_plain(t["raw"], t["cv"], t["see"], plan),
                        [t["raw"], t["cv"], t["see"], torch.empty((S, 256)), torch.empty((2 * S,), dtype=torch.int32)]),
        }
        row = {"spec": name, "streams": S, "orders": NO, "buckets": NB, "compared": PPM_SEEDS + 1}
        for which, (kernel, plain, moved) in calls.items():
            nbytes, ops = tensor_bytes(moved), ppm_float_ops(spec, S, which)
            row[which] = {"ms": device_ms(kernel, reps=50), "call_ms": call_ms(kernel, reps=50),
                          "plain_ms": call_ms(plain, reps=10), "plain_graph_ms": device_ms(graphed(plain), reps=50),
                          "bytes_moved": nbytes, "float_ops": ops, **bound(nbytes, ops)}
        rows[name] = row
        log(f"phase 2: ppm kernels {json.dumps(row)}")
        del plan, t, calls
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 2d: the boundary contexts and match pointer kernels
# ---------------------------------------------------------------------------

# the benchmark's stream counts by spec, and the seeded states drawn at each
CONTEXT_STREAMS = {"ref": 54, "best": 30, "ref-noppm": 63}
CONTEXT_SEEDS = 2


def contexts_bytes(meta, S: int, which: str) -> int:
    """Bytes one launch of the contexts kernel `which` ("boundary" or
    "match") reads and writes, each once: per stream, the boundary's byte
    leaves and ring both ways, the context slots it writes (an interval
    slot read too), the rolling hashes and the indirect-hash registers both
    ways and three `ih_tbl` words; the match kernel's bit, history length,
    and per model a context, pointer, byte and length both ways, a
    `match_tbl` word, a history byte and `match_ix`; and the table entries
    each reads."""
    spec = meta.spec
    if which == "match":
        NM = len(spec.matches)
        return S * (2 * 8 + NM * (8 + 2 * 8 + 2 * 8 + 2 * 4 + 4 + 1 + 8)) + 8 * 3 * NM
    NI, NSK, NR, NIH = len(spec.interval_ctxs), len(spec.skip_ctxs), len(spec.roll_ctxs), len(spec.ihash_ctxs)
    slots = contexts.BYTE_COLS + 2 * NI + NSK + NR + NIH
    per = 8 * (2 * 2 + 2 * meta.recent_size + slots + 2 * NR + 4 * NIH) + 4 * 3 * NIH
    return S * per + 8 * (contexts.BYTE_COLS + 4 * NI + contexts.PER_SKIP * NSK + 3 * NR + 5 * NIH)


def contexts_parts(meta):
    """(name, kernel, plain) of each contexts kernel the spec launches:
    `kernel(stm, ltm, plan, t)` and `plain(...)` update the state and return
    its other outputs by name."""
    parts = [("boundary", lambda st, lt, pl, at: contexts.boundary_contexts(st, at, pl) or {},
              lambda st, lt, pl, at: contexts.boundary_plain(st, at, pl) or {})]
    if meta.spec.matches:
        parts.append(("match", lambda st, lt, pl, at: {"match_ix": contexts.match_pointers(st, lt, pl)},
                      lambda st, lt, pl, at: {"match_ix": contexts.match_plain(st, lt, pl)}))
    return parts


def compare_contexts(what: str, meta, sample: dict, dev, t: int) -> None:
    """Each contexts kernel on a state of `sample` (`contexts_inputs`, the
    tables at full size) against its plain version on the card, every
    stream, and on the CPU, three streams' rows, bit for bit. Each kernel
    runs on a fresh state."""
    S = len(sample["stm"]["acc"])
    streams = sorted({0, S // 2, S - 1})
    plan, cpu_plan = step_mod.StepPlan(meta, S, dev), step_mod.StepPlan(meta, len(streams), "cpu")
    t_dev = torch.full((), t, dtype=torch.int64, device=dev)
    for part, kernel, plain in contexts_parts(meta):
        stm, ltm = contexts_inputs.to_state(meta, sample, dev)
        got = {**kernel(stm, ltm, plan, t_dev), **stm, **ltm}
        for where in ("card", "cpu"):
            if where == "card":
                st, lt = contexts_inputs.to_state(meta, sample, dev)
                want = {**plain(st, lt, plan, t_dev), **st, **lt}
            else:
                st, lt = contexts_inputs.to_state(meta, sample, "cpu", streams)
                want = {**plain(st, lt, cpu_plan, t_dev.cpu()), **st, **lt}
            for k, w in want.items():
                g = got[k] if where == "card" else got[k][streams]
                if not torch.equal(g.cpu(), w.cpu()):
                    raise RuntimeError(f"phase 2 {what}: the {part} kernel's {k} differs from the plain version on "
                                       f"the {where}")
            del st, lt, want
        del stm, ltm, got
    torch.cuda.empty_cache()


def phase_contexts(dev) -> dict:
    """The boundary contexts and match pointer kernels (csrc/contexts.cu)
    against their plain versions, bitwise, on seeded states
    (`contexts_inputs.random_state`, CONTEXT_SEEDS draws) at ref, best and
    ref-noppm with the benchmark's stream counts and on the edge streams
    (`edge_state`), at a stream's first byte and after it; then each kernel
    timed beside its plain version, called (`plain_ms`) and replayed as a
    CUDA graph (`plain_graph_ms`: what the byte step's graph spent there
    before the kernels), and its bound (integer work: bytes alone)."""
    rows = {}
    for name, spec in (("ref", reference_spec()), ("best", best_spec()), ("ref-noppm", ref_noppm_spec())):
        meta, S = build_meta(spec), CONTEXT_STREAMS[name]
        for t in (0, 5):
            for k in range(CONTEXT_SEEDS):
                compare_contexts(f"{name} S={S} t={t} seed {k}", meta,
                                 contexts_inputs.random_state(meta, S, SEED + k), dev, t)
            compare_contexts(f"{name} edges t={t}", meta, contexts_inputs.edge_state(meta, SEED), dev, t)
        plan = step_mod.StepPlan(meta, S, dev)
        t_dev = torch.full((), 5, dtype=torch.int64, device=dev)
        sample = contexts_inputs.random_state(meta, S, SEED)
        row = {"spec": name, "streams": S, "compared": 2 * (CONTEXT_SEEDS + 1)}
        for part, kernel, plain in contexts_parts(meta):
            stm, ltm = contexts_inputs.to_state(meta, sample, dev)
            nbytes = contexts_bytes(meta, S, part)
            row[part] = {"ms": device_ms(lambda i: kernel(stm, ltm, plan, t_dev), reps=50),
                         "call_ms": call_ms(lambda i: kernel(stm, ltm, plan, t_dev), reps=50),
                         "plain_ms": call_ms(lambda i: plain(stm, ltm, plan, t_dev), reps=10),
                         "plain_graph_ms": device_ms(graphed(lambda i: plain(stm, ltm, plan, t_dev)), reps=50),
                         "bytes_moved": nbytes, "float_ops": 0, **bound(nbytes, 0)}
            del stm, ltm
        rows[name] = row
        log(f"phase 2: contexts kernels {json.dumps(row)}")
        del plan
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def pool_bytes(plan):
    """Bytes that a plan's CUDA graph memory pool holds on the card: the
    caching allocator's segments of that pool (None where this torch's
    snapshot does not name a segment's pool)."""
    if plan._pool is None:
        return 0
    try:
        ident = tuple(plan._pool)
        segs = torch.cuda.memory_snapshot()
    except (TypeError, RuntimeError):
        return None
    if segs and "segment_pool_id" not in segs[0]:
        return None
    return sum(seg["total_size"] for seg in segs if tuple(seg.get("segment_pool_id", ())) == ident)


def graph_summary(fn) -> dict:
    """Each graph of a compiled chunk by variant: its capture seconds and the
    launches (`LAUNCHES`) its capture recorded, which each replay adds."""
    out = {}
    for key, g in fn.graphs.items():
        per = g.record.launches
        out["/".join(map(str, key))] = {"capture_s": g.record.capture_s,
                                        "launches_per_replay": [sum(per.get(w, 0) for w in group) for group in WRAPPERS]}
    return out


def eager_against_graphs(name, pred, dev, expect, sample: bool = False):
    """The same bytes through the compiled chunk's eager loop (`_eager`: the
    byte steps dispatched op by op) on `pred` and through its CUDA graphs on
    a copy of it: a first window of STEP_WINDOW bytes (the graphs' capture
    included), a second one timed, then TRACE_STEPS bytes under
    torch.profiler (a chunk of that length, whose graph is captured before
    the trace). Every state leaf must be equal after, and every byte step
    must launch `expect` (`LAUNCHES`) both ways. Encode steps, or
    with `sample` sampling steps (seeded uniforms, temperature GEN_TEMP).
    With an LSTM also one backward pass op by op against its graph, three
    times each, the LSTM's leaves equal after. Returns the readings."""
    S, n, m = pred.num_streams, STEP_WINDOW, TRACE_STEPS
    twin = pred.copy()
    t0 = MAIN_BYTES // S
    total = 2 * n + 2 * m  # the traced chunk runs twice: capture, then trace
    data = np.frombuffer(corpus(MAIN_BYTES + S * total)[MAIN_BYTES:], np.uint8).reshape(S, total)
    bufs = {}
    for k in ("eager", "graphs"):
        bufs[k] = torch.zeros((S, t0 + total), dtype=torch.uint8, device=dev)
        bufs[k][:, t0:] = torch.as_tensor(data, device=dev)
    code = torch.zeros((S, 1), dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    u = torch.rand((total * 8, S), generator=gen, device=dev)
    inv_temp = torch.tensor([np.float32(1.0 / GEN_TEMP)], device=dev)
    owners = {"eager": pred, "graphs": twin}

    def fn(k, length):
        """The compiled chunk of `length` bytes: the predictor's own for the
        graphs, a fresh one for the eager loop."""
        if sample:
            return step_mod.make_gen_chunk_fn(pred.meta, length) if k == "eager" else \
                step_mod.get_gen_chunk_fn(twin.plan, length)
        return step_mod.make_chunk_fn(pred.meta, length) if k == "eager" else step_mod.get_chunk_fn(twin.plan, length)

    def run(k, f, at, length):
        p = owners[k]
        call = f._eager if k == "eager" else f
        if sample:
            call(p.state, p.plan, bufs[k], t0 + at, u[8 * at : 8 * (at + length)], inv_temp)
        else:
            call(p.state, p.plan, bufs[k], code, t0 + at)
        torch.cuda.synchronize()

    out = {}
    for k in ("eager", "graphs"):
        row = {}
        long_fn, short_fn = fn(k, n), fn(k, m)
        reset_launches()
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        run(k, long_fn, 0, n)
        row["first_window_s"] = time.perf_counter() - t_start
        t_start = time.perf_counter()
        run(k, long_fn, n, n)
        row["wall_ms_per_step"] = 1e3 * (time.perf_counter() - t_start) / n
        run(k, short_fn, 2 * n, m)
        row.update(trace_window(lambda: run(k, short_fn, 2 * n + m, m), m, dev))
        # the traced window's device time against the untraced wall (the
        # profiler's own host work stretches the traced wall)
        row["idle_share_of_untraced_wall"] = 1.0 - row["device_busy_ms_per_step"] / row["wall_ms_per_step"]
        got = read_launches()
        if got != tuple(e * total for e in expect):
            raise RuntimeError(f"phase 3 {name}: the {k} windows launched {got} in {total} steps, expected {expect} a step")
        if k == "graphs":
            row["graphs"] = {**graph_summary(long_fn), **{f"{v} ({m} bytes)": g for v, g in graph_summary(short_fn).items()}}
            row["pool_bytes"] = pool_bytes(twin.plan)
        out[k] = row
    for (path, a), (_, b) in zip(_leaves(pred.state), _leaves(twin.state)):
        if not torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)):
            raise RuntimeError(f"phase 3 {name}: eager and graph windows differ at {'.'.join(path)}")
    if not torch.equal(bufs["eager"], bufs["graphs"]):
        raise RuntimeError(f"phase 3 {name}: eager and graph windows coded other bytes")
    out["wall_eager_over_graphs"] = out["eager"]["wall_ms_per_step"] / out["graphs"]["wall_ms_per_step"]
    if pred.spec.lstm is not None and not sample:
        out["backward_pass"] = bptt_against_graph(name, pred, twin)
    del twin, owners
    torch.cuda.empty_cache()
    return out


def bptt_against_graph(name, pred, twin, reps: int = 3) -> dict:
    """One LSTM backward pass with its Adam step op by op on `pred` and as a
    CUDA graph (captured once) on `twin`, `reps` times each, the device
    drained around each: wall times, the eager pass's aten ops and the
    capture time; the two LSTM states equal after."""
    from torch.profiler import ProfilerActivity, profile

    def timed_reps(run):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return 1e3 * float(np.median(times))

    eager_ms = timed_reps(lambda: step_mod.lstm_bptt(pred.state, pred.plan))
    graph = step_mod.CapturedStep(twin.plan, lambda: step_mod.lstm_bptt(twin.state, twin.plan), "bptt")
    graph_ms = timed_reps(graph.replay)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step_mod.lstm_bptt(pred.state, pred.plan)
        torch.cuda.synchronize()
    graph.replay()
    torch.cuda.synchronize()
    aten = sum(ka.count for ka in prof.key_averages() if ka.key.startswith("aten::"))
    for part in ("stm", "ltm"):
        for (path, a), (_, b) in zip(_leaves(pred.state[part]["lstm"]), _leaves(twin.state[part]["lstm"])):
            if not torch.equal(a, b):
                raise RuntimeError(f"phase 3 {name}: the backward pass's graph differs from its eager run at {path}")
    Hz = pred.spec.lstm.horizon
    return {"eager_wall_ms": eager_ms, "graph_wall_ms": graph_ms, "capture_s": graph.record.capture_s, "aten_ops": aten,
            "horizon": Hz, "eager_wall_ms_per_byte_amortised": eager_ms / Hz,
            "graph_wall_ms_per_byte_amortised": graph_ms / Hz}


def phase_main(name, spec, dev):
    """compress + decompress at full width on the GPU; counts kernel launches
    (every count set to 0 just before a direction, read just after it)."""
    data = corpus(MAIN_BYTES)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    pred = Predictor(spec, STREAMS, device=dev)
    out["state_gb"] = state_bytes(pred.state) / 1e9
    per = MAIN_BYTES // STREAMS
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = compress_bytes(data, spec, STREAMS, CHUNK, pred=pred)
    torch.cuda.synchronize()
    out["encode_s"] = time.perf_counter() - t0
    enc_launches = read_launches()
    ent = entropy_bits(pred)
    bptt_enc = int(pred.state["stm"]["lstm"]["update_steps"]) if spec.lstm is not None else 0
    # the encoder's graphs: capture seconds, launches a replay, pool bytes
    out["encode_graphs"] = graph_summary(step_mod.get_chunk_fn(pred.plan, CHUNK))
    out["encode_pool_bytes"] = pool_bytes(pred.plan)
    del pred
    torch.cuda.empty_cache()
    pred = Predictor(spec, STREAMS, device=dev)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = decompress_bytes(blob, spec, CHUNK, pred=pred)
    torch.cuda.synchronize()
    out["decode_s"] = time.perf_counter() - t0
    dec_launches = read_launches()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["decode_graphs"] = graph_summary(step_mod.get_chunk_fn(pred.plan, CHUNK))
    out["decode_pool_bytes"] = pool_bytes(pred.plan)
    if back != data:
        raise RuntimeError("phase 3: decompress_bytes did not reproduce the input")
    if not np.isfinite(ent) or ent <= 0:
        raise RuntimeError(f"phase 3: cross-entropy {ent} is not a positive finite number")
    per_step = launches_per_step(spec)
    expect = tuple(e * per for e in per_step)
    if enc_launches != expect or dec_launches != expect:
        raise RuntimeError(
            f"phase 3 {name}: launches {LAUNCHES} encode {enc_launches}, decode "
            f"{dec_launches}, expected {expect} each ({' + '.join(map(str, per_step))} per byte step)"
        )
    if spec.lstm is not None:
        # chunk 1024 is no multiple of the horizon: the backward pass runs
        # inside every byte that wraps the window
        passes = (bptt_enc, int(pred.state["stm"]["lstm"]["update_steps"]))
        if passes != (per // spec.lstm.horizon,) * 2:
            raise RuntimeError(f"phase 3 {name}: {passes} backward passes (encode, decode) in {per} byte steps")
        out["lstm_backward_passes"] = passes[0]
    known = KNOWN_ARCHIVE_BYTES.get((name, "main"))
    if known is not None and len(blob) != known:
        raise RuntimeError(f"phase 3 {name}: the archive is {len(blob)} bytes, it has always been {known}")
    out.update(
        spec=name, launches_per_byte_step=sum(per_step),
        bytes=len(data), archive_bytes=len(blob), bpb=8 * len(blob) / len(data),
        model_bpb=ent / len(data), encode_bytes_per_s=len(data) / out["encode_s"],
        decode_bytes_per_s=len(data) / out["decode_s"], byte_steps=per,
        launches_encode=list(enc_launches), launches_decode=list(dec_launches),
    )
    log(f"phase 3: {json.dumps(out)}")
    out["archive"] = blob  # phase 6 (b) must reproduce it
    out["steps"] = eager_against_graphs(name, pred, dev, per_step)
    log(f"phase 3: {name} per encode byte step after {per} bytes per stream, eager against graphs: "
        f"{json.dumps(out['steps'])}")
    out["generate"] = phase_generate(name, pred, dev, per_step)
    del pred
    torch.cuda.empty_cache()
    return out


def phase_generate(name, pred, dev, per_encode_step):
    """generate_bytes on the warm predictor, as a user calls it: the prompt
    replayed with learning (encode steps), then GEN_BYTES sampled bytes a
    stream; each byte step must launch what the code says (a sampling step
    an encode step's kernels less the byte-end scatter). Then sampling alone
    from where that left off (no prompt), timed, after which every
    long-term-memory leaf must be as it was (the prompt's replay learns by
    design); then a profiler window of sampling steps."""
    S = pred.num_streams
    prompt = corpus(MAIN_BYTES + GEN_PROMPT)[MAIN_BYTES:]  # bytes the model has not seen
    expect = (per_encode_step[0], per_encode_step[1] - 1, *per_encode_step[2:])
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = generate_bytes(pred, prompt, GEN_BYTES, temperature=GEN_TEMP, chunk=GEN_CHUNK, seed=SEED, return_all=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = tuple(GEN_PROMPT * e + GEN_BYTES * g for e, g in zip(per_encode_step, expect))
    if launches != want:
        raise RuntimeError(f"phase 3 {name} generate: launches {LAUNCHES} {launches}, expected {want}: "
                           f"{per_encode_step} an encode step of the prompt, {expect} a sampling step")
    if len(outs) != S or any(len(o) != GEN_BYTES for o in outs):
        raise RuntimeError(f"phase 3 {name} generate: {[len(o) for o in outs]} bytes, expected {GEN_BYTES} a stream")
    ltm0 = copy_state(pred.state["ltm"])
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    more = generate_bytes(pred, b"", GEN_BYTES, temperature=GEN_TEMP, chunk=GEN_CHUNK, seed=SEED + 1, return_all=True)
    torch.cuda.synchronize()
    wall_sampling = time.perf_counter() - t0
    sampling = read_launches()
    if sampling != tuple(GEN_BYTES * g for g in expect):
        raise RuntimeError(f"phase 3 {name} generate: sampling alone launched {sampling} in {GEN_BYTES} steps, "
                           f"expected {expect} a step")
    if any(len(o) != GEN_BYTES for o in more):
        raise RuntimeError(f"phase 3 {name} generate: {[len(o) for o in more]} bytes without a prompt")
    for path, a in _leaves(ltm0):
        b = pred.state["ltm"]
        for k in path:
            b = b[k]
        if not torch.equal(a, b):
            raise RuntimeError(f"phase 3 {name} generate: long-term memory leaf {'.'.join(path)} changed")
    del ltm0
    torch.cuda.empty_cache()
    window = eager_against_graphs(name, pred, dev, expect, sample=True)
    row = {"spec": name, "streams": S, "prompt_bytes": GEN_PROMPT, "sampled_bytes": GEN_BYTES, "temperature": GEN_TEMP,
           "chunk": GEN_CHUNK, "wall_s": wall, "launches": list(launches), "sampling_step_launches": sum(expect),
           "sampling_alone_launches": list(sampling), "sampling_alone_wall_s": wall_sampling,
           "sampling_wall_ms_per_step": 1e3 * wall_sampling / GEN_BYTES,
           "sampled_bytes_per_s": S * GEN_BYTES / wall_sampling, "ltm_unchanged": True,
           "distinct_bytes_stream0": len(set(outs[0] + more[0]))}
    log(f"phase 3: {name} generate {json.dumps(row)}")
    log(f"phase 3: {name} per sampling byte step, eager against graphs: {json.dumps(window)}")
    row["sample_graphs"] = window["graphs"]["graphs"]
    row["window"] = window
    return row


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def cpu_env() -> dict:
    """The environment of a process that runs the port on the CPU beside
    this one: one torch thread, the checkout importable."""
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))


def start_cpu_decode(d: str, name: str, blob: bytes, chunk: int):
    """The CPU's decode of phase 4's archive of `name` in a process of its
    own, so that it runs beside the rest of the run; the bytes land in
    d/<name>.gxtc.out (finish_cpu_decodes)."""
    path = os.path.join(d, f"{name}.gxtc")
    write_bytes(path, blob)
    code = (f"import chip_smoke as cs; spec = cs.scale_tables(cs.SPECS[{name!r}](), 12, history_bits=16); "
            f"cs.write_bytes({path + '.out'!r}, cs.decompress_bytes(cs.read_bytes({path!r}), spec, {chunk}, device='cpu'))")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=cpu_env(), start_new_session=True)


def finish_cpu_decodes(decodes: dict) -> None:
    """Wait for phase 4's CPU decodes: each must give the input back."""
    for name, (proc, path, data) in decodes.items():
        try:
            rc = proc.wait(timeout=900)
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"phase 4 {name}: the CPU's decode did not end within 900 s")
        if rc != 0 or read_bytes(path + ".out") != data:
            raise RuntimeError(f"phase 4 {name}: the CPU does not decode the GPU archive (exit code {rc})")


def phase_cross(name, spec, dev, d: str):
    """The same archive from the GPU and from the CPU, and cross-decodes:
    the GPU's here, the CPU's started in the background. Returns the CPU
    decode's (process, archive path, expected bytes)."""
    spec12 = scale_tables(spec, 12, history_bits=16)
    n_bytes, chunk = CROSS_RUNS[name]
    data = corpus(n_bytes)
    S = 2
    per = n_bytes // S
    n0 = obs.launches().get("fused_substeps", 0)
    pred_gpu, pred_cpu = Predictor(spec12, S, device=dev), Predictor(spec12, S, device="cpu")
    t0 = time.perf_counter()
    blob_gpu = compress_bytes(data, spec12, S, chunk, pred=pred_gpu)
    t1 = time.perf_counter()
    if obs.launches().get("fused_substeps", 0) != n0 + per:
        raise RuntimeError(f"phase 4 {name}: the GPU encode did not go through the fused kernel once per byte step")
    blob_cpu = compress_bytes(data, spec12, S, chunk, pred=pred_cpu)
    t2 = time.perf_counter()
    if obs.launches().get("fused_substeps", 0) != n0 + per:
        raise RuntimeError(f"phase 4 {name}: the CPU encode launched a kernel")
    if blob_gpu != blob_cpu:
        diff = next(i for i, (a, b) in enumerate(zip(blob_gpu, blob_cpu)) if a != b) if len(blob_gpu) == len(blob_cpu) else -1
        raise RuntimeError(f"phase 4 {name}: GPU and CPU archives differ ({len(blob_gpu)} vs {len(blob_cpu)} bytes, first at {diff})")
    if decompress_bytes(blob_cpu, spec12, chunk, device=dev) != data:
        raise RuntimeError(f"phase 4 {name}: the GPU does not decode the CPU archive")
    decode = (start_cpu_decode(d, name, blob_gpu, chunk), os.path.join(d, f"{name}.gxtc"), data)
    known = KNOWN_ARCHIVE_BYTES.get((name, "cross"))
    if known is not None and len(blob_gpu) != known:
        raise RuntimeError(f"phase 4 {name}: the archive is {len(blob_gpu)} bytes, it has always been {known}")
    out = {"spec": f"{name} scaled-12", "bytes": len(data), "chunk": chunk, "archive_bytes": len(blob_gpu), "gpu_encode_s": t1 - t0,
           "cpu_encode_s": t2 - t1, "identical": True}
    log(f"phase 4: {json.dumps(out)}")
    if spec.lstm is not None:
        phase_cross_checkpoints(name, spec12, pred_gpu, pred_cpu, data_end=n_bytes)
    return decode


def same_file(path_a: str, path_b: str, what: str) -> None:
    with open(path_a, "rb") as fa, open(path_b, "rb") as fb:
        if fa.read() != fb.read():
            raise RuntimeError(f"phase 4: {what}: the checkpoints differ")


def phase_cross_checkpoints(name, spec12, pred_gpu, pred_cpu, data_end: int) -> dict:
    """After phase 4's encodes at ref-full scaled-12: the trained GPU and
    CPU predictors' checkpoints are the same file, and each loads on the
    other device; the four predictors generate (a CROSS_PROMPT-byte prompt,
    CROSS_GEN sampled bytes in chunks of CROSS_CHUNK) the same bytes and end
    in the same checkpoint."""
    import tempfile

    S = pred_gpu.num_streams
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        ck = {k: os.path.join(tmp, f"{k}.gxt") for k in ("gpu", "cpu")}
        pred_gpu.save(ck["gpu"])
        pred_cpu.save(ck["cpu"])
        same_file(ck["gpu"], ck["cpu"], f"{name} after the encodes")
        gpu_from_cpu = Predictor(spec12, S, device=pred_gpu.device)
        gpu_from_cpu.load(ck["cpu"])
        cpu_from_gpu = Predictor(spec12, S, device="cpu")
        cpu_from_gpu.load(ck["gpu"])
        preds = {"gpu": pred_gpu, "cpu": pred_cpu, "gpu loaded from cpu": gpu_from_cpu, "cpu loaded from gpu": cpu_from_gpu}
        prompt = corpus(data_end + CROSS_PROMPT)[data_end:]
        times, outs = {}, {}
        for k, p in preds.items():
            t0 = time.perf_counter()
            outs[k] = generate_bytes(p, prompt, CROSS_GEN, temperature=GEN_TEMP, chunk=CROSS_CHUNK, seed=SEED,
                                     return_all=True)
            times[k] = time.perf_counter() - t0
        for k, o in outs.items():
            if o != outs["gpu"]:
                raise RuntimeError(f"phase 4 {name}: the {k} predictor generated other bytes than the gpu one")
        for i, (k, p) in enumerate(preds.items()):
            p.save(os.path.join(tmp, f"after-{i}.gxt"))
            same_file(os.path.join(tmp, "after-0.gxt"), os.path.join(tmp, f"after-{i}.gxt"),
                      f"{name} generation, {k} against gpu")
    row = {"spec": f"{name} scaled-12", "streams": S, "same_checkpoints": True, "prompt_bytes": CROSS_PROMPT,
           "generated_bytes": CROSS_GEN, "chunk": CROSS_CHUNK, "same_bytes": True, "generate_s": times}
    log(f"phase 4: checkpoints and generation {json.dumps(row)}")
    return row


# ---------------------------------------------------------------------------
# phase 5: the command line
# ---------------------------------------------------------------------------


def flag(argv, name: str) -> int:
    """The integer after `name` in a command line."""
    return int(argv[list(argv).index(name) + 1])


def step_launches(steps: int, sampling: int = 0):
    """`LAUNCHES` of `steps` encode or decode steps and `sampling` sampling
    steps with PPM, the LSTM and match models: 3 + 2 + 1 + 1 + 1 + 1 + 1 and
    3 + 1 + 1 + 1 + 1 + 1 + 1 a step."""
    n = steps + sampling
    return (3 * n, 2 * steps + sampling, n, n, n, n, n)


def cli_run(argv, what: str, launches=None):
    """`cli.main(argv)` in this process, so that the launch counters see its
    kernels (set to 0 just before, read just after; with `launches` they
    must equal it). Its printed lines are logged. Returns (printed, wall
    seconds, launches)."""
    out = io.StringIO()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches()
    for line in out.getvalue().splitlines():
        log(f"phase 5: {what}: {line}")
    if rc != 0:
        raise RuntimeError(f"phase 5 {what}: exit code {rc}")
    if launches is not None and got != tuple(launches):
        raise RuntimeError(f"phase 5 {what}: launches {LAUNCHES} {got}, expected {tuple(launches)}")
    return out.getvalue(), wall, got


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def write_bytes(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def tsv(path: str):
    with open(path) as f:
        return [line.split("\t") for line in f.read().splitlines()]


def cli_cross_inputs(d: str) -> None:
    """Phase 5 (b)'s input, test file and prompt, from the corpus, in d."""
    data = corpus(CLI_CROSS_OFFSET + CLI_CROSS_BYTES + CLI_TEST_BYTES + CLI_PROMPT)[CLI_CROSS_OFFSET:]
    write_bytes(os.path.join(d, "in.txt"), data[:CLI_CROSS_BYTES])
    write_bytes(os.path.join(d, "test.txt"), data[CLI_CROSS_BYTES:CLI_CROSS_BYTES + CLI_TEST_BYTES])
    write_bytes(os.path.join(d, "prompt.txt"), data[CLI_CROSS_BYTES + CLI_TEST_BYTES:])


def cli_cross_commands(device: str):
    """Phase 5 (b)'s commands, run in a directory that holds the inputs:
    compress with analysis, decompress, train (analysis/training.tsv and
    ck.gxt), generate from that checkpoint."""
    base = ["--device", device, *CLI_CROSS]
    return {
        "compress": base + ["--chunk", str(CLI_CHUNK), "compress", "--analysis", "an", "in.txt", "out.gxtc"],
        "decompress": base + ["--chunk", str(CLI_CHUNK), "decompress", "out.gxtc", "back.txt"],
        "train": base + ["--chunk", str(CLI_CHUNK), "train", "in.txt", "test.txt", "--out-checkpoint", "ck.gxt"],
        "generate": base + ["--chunk", str(CLI_GEN_CHUNK), "generate", "-k", "ck.gxt", "prompt.txt", "gen.txt",
                            str(CLI_GEN), str(GEN_TEMP)],
    }


def start_cli_cpu(root: str):
    """Phase 5 (b)'s CPU commands, as `python -m gmix_tpu_torch.cli` processes
    one after another in the background (one torch thread), so that they run
    beside phase 4 and not after it. Returns (process, directory)."""
    d = os.path.join(root, "cpu")
    os.makedirs(d)
    cli_cross_inputs(d)
    script = " && ".join(shlex.join([sys.executable, "-m", "gmix_tpu_torch.cli", *argv])
                         for argv in cli_cross_commands("cpu").values())
    with open(os.path.join(d, "log.txt"), "w") as f:
        proc = subprocess.Popen(["bash", "-c", script], cwd=d, env=cpu_env(), stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
    return proc, d


def stop(proc) -> None:
    """Kill a process started in the background and whatever it runs."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def wiki_dump(n_pages: int) -> bytes:
    """A small MediaWiki export of the shape the wiki transform and the
    dictionary are made for: the site header, pages with title, id,
    revision, timestamp and contributor, a redirect every fifth page,
    entities, links and a language link, and a page cut off at the end.
    The text is common English words (the corpus's first part), drawn
    Zipf-distributed from a seed."""
    words = corpus(8192).split(b"\n")[:1000]
    rng = np.random.default_rng(SEED)
    out = [b'<mediawiki xmlns="http://www.mediawiki.org/xml/export-0.3/">\n'
           b"  <siteinfo>\n    <sitename>Wikipedia</sitename>\n  </siteinfo>\n"]
    for i in range(n_pages):
        title = words[100 + i].capitalize()
        body = b" ".join(words[j % len(words)] for j in rng.zipf(1.3, 48))
        text = (b"#REDIRECT [[" + words[101 + i].capitalize() + b"]]" if i % 5 == 4 else
                b"'''" + title + b"''' is " + body + b" &quot;" + words[i] + b"&quot; &amp; [[" + words[i + 1]
                + b"]].\n\n[[de:" + title + b"]]")
        out.append(b"  <page>\n    <title>%s</title>\n    <id>%d</id>\n    <revision>\n      <id>%d</id>\n"
                   b"      <timestamp>2004-06-%02dT09:33:17Z</timestamp>\n      <contributor>\n"
                   b"        <username>Editor%d</username>\n        <id>%d</id>\n      </contributor>\n"
                   b'      <text xml:space="preserve">%s</text>\n    </revision>\n  </page>\n'
                   % (title, 10 + 3 * i, 135 + 13 * i, 1 + i % 28, i % 3, 700 + i % 3, text))
    out.append(b"  <page>\n    <title>Truncated article that was cut mid-")
    return b"".join(out)


def phase_cli_best(d: str, dev, ref_full_bpb: float, ref_full_inst: dict) -> dict:
    """(a) best_spec() at full width through the command line: compress
    with analysis, decompress; the round trip exact, 10 launches a byte step
    each way, the analysis files whole."""
    spec = best_spec()
    data = corpus(CLI_BEST_OFFSET + CLI_BEST_BYTES)[CLI_BEST_OFFSET:]
    inp, arc, back, an = (os.path.join(d, n) for n in ("best.txt", "best.gxtc", "best.back", "best_analysis"))
    write_bytes(inp, data)
    S = flag(CLI_BEST, "--streams")
    expect = step_launches(CLI_BEST_PER)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    printed, enc_s, enc_l = cli_run([*CLI_BEST, "compress", "--analysis", an, inp, arc], "best compress", expect)
    _, dec_s, dec_l = cli_run([*CLI_BEST, "decompress", arc, back], "best decompress", expect)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if read_bytes(back) != data:
        raise RuntimeError("phase 5 best: decompress did not reproduce the input")
    ent = tsv(os.path.join(an, "entropy.tsv"))
    if ent[0] != ["bits", *analysis_columns(spec)] or len(ent) != 2:
        raise RuntimeError(f"phase 5 best: entropy.tsv has {len(ent)} lines and header {ent[0][:4]}...")
    row = np.array([float(v) for v in ent[1]])
    # bits_seen counts the bits after a stream's first
    if not np.isfinite(row).all() or row[0] != CLI_BEST_PER * 8 - 1:
        raise RuntimeError(f"phase 5 best: entropy.tsv row {ent[1][:4]}... is not finite or not at bit {CLI_BEST_PER * 8 - 1}")
    mem = tsv(os.path.join(an, "memory.tsv"))
    meta = build_meta(spec)
    layout = numpy_layout(init_state(meta, S, device="meta"))  # sizes only, nothing allocated
    want = sum(math.prod(shape) * dtype.itemsize for shape, dtype in layout.values())
    total = int(mem[-1][1])
    if mem[-1][0] != "TOTAL" or total != want or total != sum(int(b) for _, b in mem[1:-1]):
        raise RuntimeError(f"phase 5 best: memory.tsv TOTAL {mem[-1]} against gmix_tpu's bytes of the state {want}")
    inst = fused.fused_instantiation(meta, fused.const_inputs(meta, True, dev), True, True, S, dev)
    model_bpb = float(re.search(r"model entropy ([0-9.]+) bits/byte", printed).group(1))
    out = {"spec": "best", "streams": S, "chunk": CLI_BEST_PER, "bytes": len(data), "archive_bytes": len(read_bytes(arc)),
           "bpb": 8 * len(read_bytes(arc)) / len(data), "model_bpb": model_bpb,
           "ref_full_main_bpb": ref_full_bpb, "state_gb": state_bytes(init_state(meta, S, device="meta")) / 1e9,
           "memory_tsv_gb": total / 1e9, "peak_gb": peak_gb,
           "encode_s": enc_s, "decode_s": dec_s, "encode_bytes_per_s": len(data) / enc_s,
           "decode_bytes_per_s": len(data) / dec_s, "launches_per_byte_step": sum(expect) // CLI_BEST_PER,
           "launches_encode": list(enc_l), "launches_decode": list(dec_l), "instantiation": inst,
           "same_instantiation_as_ref_full": inst == ref_full_inst}
    log(f"phase 5: {json.dumps(out)}")
    return out


def phase_cli_cross(root: str, cpu_proc, cpu_dir: str) -> dict:
    """(b) the same commands on the GPU (here) and on the CPU (the background
    processes): the same archive, each device decodes the other's (the CPU
    its own, the same bytes), the same memory.tsv, entropy.tsv's bits column
    equal and its values within 1e-6 relative or one unit of the printed
    fifth decimal, the same training.tsv and checkpoint, the same generated
    bytes."""
    d = os.path.join(root, "gpu")
    os.makedirs(d)
    cli_cross_inputs(d)
    per = padded_per(CLI_CROSS_BYTES, 2, CLI_CHUNK)
    train_steps = per + padded_per(CLI_TEST_BYTES, 2, CLI_CHUNK)
    expect = {"compress": step_launches(per), "train": step_launches(train_steps),
              "generate": step_launches(padded_per(CLI_PROMPT, 1, CLI_GEN_CHUNK), padded_per(CLI_GEN, 1, CLI_GEN_CHUNK))}
    cmds = cli_cross_commands("cuda")
    walls, launches = {}, {}
    with contextlib.chdir(d):
        for k in ("compress", "train", "generate"):
            _, walls[k], launches[k] = cli_run(cmds[k], f"scaled-12 gpu {k}", expect[k])
    t0 = time.perf_counter()
    try:
        rc = cpu_proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        stop(cpu_proc)
        raise RuntimeError("phase 5 scaled-12: the CPU commands did not end within 900 s")
    cpu_wait_s = time.perf_counter() - t0
    cpu_log = read_bytes(os.path.join(cpu_dir, "log.txt")).decode(errors="replace")
    for line in cpu_log.replace("\r", "\n").splitlines():
        if line and "%" not in line:  # the progress lines
            log(f"phase 5: scaled-12 cpu: {line}")
    if rc != 0:
        raise RuntimeError(f"phase 5 scaled-12: the CPU commands failed ({rc})")
    gpu_file, cpu_file = (lambda n: os.path.join(d, n)), (lambda n: os.path.join(cpu_dir, n))
    data = read_bytes(gpu_file("in.txt"))
    for name in ("out.gxtc", "an/memory.tsv", "analysis/training.tsv", "ck.gxt", "gen.txt"):
        if read_bytes(gpu_file(name)) != read_bytes(cpu_file(name)):
            raise RuntimeError(f"phase 5 scaled-12: {name} differs between the GPU and the CPU")
    ent_g, ent_c = tsv(gpu_file("an/entropy.tsv")), tsv(cpu_file("an/entropy.tsv"))
    if ent_g[0] != ent_c[0] or [r[0] for r in ent_g] != [r[0] for r in ent_c] or len(ent_g) != 1 + per // CLI_CHUNK:
        raise RuntimeError("phase 5 scaled-12: entropy.tsv's header or bits column differs between the GPU and the CPU")
    g, c = (np.array([[float(v) for v in r[1:]] for r in e[1:]]) for e in (ent_g, ent_c))
    np.testing.assert_allclose(g, c, rtol=1e-6, atol=1e-5)
    if read_bytes(cpu_file("back.txt")) != data:
        raise RuntimeError("phase 5 scaled-12: the CPU does not decode the archive")
    with contextlib.chdir(d):
        _, walls["decompress"], launches["decompress"] = cli_run(
            [*cmds["decompress"][:-2], cpu_file("out.gxtc"), "back.txt"], "scaled-12 gpu decompress of the cpu archive",
            expect["compress"])
    if read_bytes(gpu_file("back.txt")) != data:
        raise RuntimeError("phase 5 scaled-12: the GPU does not decode the CPU's archive")
    out = {"spec": "scaled-12", "streams": 2, "bytes": len(data), "chunk": CLI_CHUNK,
           "archive_bytes": len(read_bytes(gpu_file("out.gxtc"))), "same_archive": True, "same_memory_tsv": True,
           "same_training_tsv": True, "same_checkpoint": True, "same_generated_bytes": True,
           "generated_bytes": len(read_bytes(gpu_file("gen.txt"))), "gpu_wall_s": walls,
           "cpu_wait_s": cpu_wait_s, "launches": {k: list(v) for k, v in launches.items()},
           "sampling_launches": padded_per(CLI_GEN, 1, CLI_GEN_CHUNK)}
    log(f"phase 5: {json.dumps(out)}")
    return out


def phase_cli_wiki(d: str) -> dict:
    """(c) wiki-encode -> dict-encode -> compress on the card, and back:
    byte-identical."""
    f = lambda n: os.path.join(d, n)  # noqa: E731
    dump = wiki_dump(CLI_WIKI_PAGES)
    write_bytes(f("dump.xml"), dump)
    walls, launches = {}, {}
    cli_run(["wiki-encode", f("dump.xml"), f("dump.gwp")], "wiki-encode", NO_LAUNCHES)
    cli_run(["dict-encode", f("dump.gwp"), f("dump.dict")], "dict-encode", NO_LAUNCHES)
    expect = step_launches(padded_per(os.path.getsize(f("dump.dict")), flag(CLI_WIKI_ARGS, "--streams"),
                                      flag(CLI_WIKI_ARGS, "--chunk")))
    _, walls["compress"], launches["compress"] = cli_run([*CLI_WIKI_ARGS, "compress", f("dump.dict"), f("dump.gxtc")],
                                                         "wiki chain compress", expect)
    _, walls["decompress"], launches["decompress"] = cli_run(
        [*CLI_WIKI_ARGS, "decompress", f("dump.gxtc"), f("back.dict")], "wiki chain decompress", expect)
    cli_run(["dict-decode", f("back.dict"), f("back.gwp")], "dict-decode", NO_LAUNCHES)
    cli_run(["wiki-decode", f("back.gwp"), f("back.xml")], "wiki-decode", NO_LAUNCHES)
    if read_bytes(f("back.xml")) != dump:
        raise RuntimeError("phase 5 wiki chain: the output is not the input")
    out = {"dump_bytes": len(dump), "wiki_bytes": os.path.getsize(f("dump.gwp")),
           "dict_bytes": os.path.getsize(f("dump.dict")), "archive_bytes": os.path.getsize(f("dump.gxtc")),
           "identical": True, "wall_s": walls, "launches": {k: list(v) for k, v in launches.items()}}
    log(f"phase 5: wiki chain {json.dumps(out)}")
    return out


def phase_cli(root: str, cpu_proc, cpu_dir: str, dev, ref_full_bpb: float, ref_full_inst: dict) -> dict:
    """Phase 5: (a), (c), then (b) (its CPU half has run beside phase 4)."""
    t0 = time.perf_counter()
    out = {"best": phase_cli_best(root, dev, ref_full_bpb, ref_full_inst), "wiki": phase_cli_wiki(root),
           "cross": phase_cli_cross(root, cpu_proc, cpu_dir)}
    runs = [out["best"]["launches_encode"], out["best"]["launches_decode"], *out["wiki"]["launches"].values(),
            *out["cross"]["launches"].values()]
    out["launches"] = [sum(r[i] for r in runs) for i in range(len(WRAPPERS))]
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 5: the command line in {out['wall_s']:.1f} s, launches {LAUNCHES} {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 6: stream sharding
# ---------------------------------------------------------------------------


def timed(fn):
    """(fn(), wall seconds, launches): every count set to 0 just before, the
    device drained before and after."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_launches()


def phase_shards(spec, dev, d: str) -> dict:
    """(a) SHARDS shards of ref-full on the one card, in this process, beside
    the unsharded predictor: the same archive, each decodes the other's, the
    same checkpoint file, and every shard launches an unsharded step's 8
    kernels at every byte step."""
    data = corpus(SHARD_OFFSET + SHARD_BYTES)[SHARD_OFFSET:]
    per = padded_per(SHARD_BYTES, STREAMS, SHARD_CHUNK)
    sharding = stream_sharding(make_mesh(devices=[dev] * SHARDS))
    make = {"unsharded": lambda: Predictor(spec, STREAMS, device=dev),
            "sharded": lambda: Predictor(spec, STREAMS, sharding=sharding)}
    blobs, walls, launches, peak_gb, save_s = {}, {}, {}, {}, {}
    for kind in make:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pred = make[kind]()
        blobs[kind], walls[f"{kind} encode"], launches[f"{kind} encode"] = timed(
            lambda: compress_bytes(data, spec, STREAMS, SHARD_CHUNK, pred=pred))
        peak_gb[kind] = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()
        pred.save(os.path.join(d, f"{kind}.gxt"))
        save_s[kind] = time.perf_counter() - t0
        del pred
    for kind, other in (("unsharded", "sharded"), ("sharded", "unsharded")):
        torch.cuda.empty_cache()
        pred = make[kind]()
        back, walls[f"{kind} decode"], launches[f"{kind} decode"] = timed(
            lambda: decompress_bytes(blobs[other], spec, SHARD_CHUNK, pred=pred))
        del pred
        if back != data:
            raise RuntimeError(f"phase 6 shards: the {kind} predictor does not decode the {other} archive")
    if blobs["sharded"] != blobs["unsharded"]:
        raise RuntimeError(f"phase 6 shards: the sharded archive ({len(blobs['sharded'])} bytes) is not the unsharded "
                           f"one ({len(blobs['unsharded'])} bytes)")
    if read_bytes(os.path.join(d, "sharded.gxt")) != read_bytes(os.path.join(d, "unsharded.gxt")):
        raise RuntimeError("phase 6 shards: the sharded checkpoint is not the unsharded file")
    for run, got in launches.items():
        n = SHARDS if run.startswith("sharded") else 1
        if got != step_launches(n * per):
            raise RuntimeError(f"phase 6 shards: {run} launched {LAUNCHES} {got} in {per} byte steps of "
                               f"{n} shard(s), expected {step_launches(n * per)}: 3 + 2 + 1 + 1 + 1 + 1 + 1 a shard and step")
    out = {"spec": "ref-full", "streams": STREAMS, "shards": SHARDS, "mesh": [str(x) for x in sharding.mesh.devices],
           "bytes": len(data), "chunk": SHARD_CHUNK, "byte_steps": per, "archive_bytes": len(blobs["sharded"]),
           "same_archive": True, "cross_decodes": True, "same_checkpoint": True,
           "checkpoint_bytes": os.path.getsize(os.path.join(d, "sharded.gxt")), "save_s": save_s, "wall_s": walls,
           "ms_per_byte_step": {k: 1e3 * v / per for k, v in walls.items()},
           "sharded_over_unsharded_encode_wall": walls["sharded encode"] / walls["unsharded encode"],
           "peak_gb": peak_gb, "launches": {k: list(v) for k, v in launches.items()},
           "launches_per_shard_and_step": sum(step_launches(1))}
    log(f"phase 6: two shards on one card {json.dumps(out)}")
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_main(rank: int, world: int, port: int, d: str) -> None:
    """Phase 6 (b)'s rank: join the gloo group, code phase 3's ref-full 16 KB
    with compress_bytes_multihost (this rank's STREAMS / world streams on
    its card), write the container to d/rank<r>.gxtc and print one JSON line
    of its launches, wall time and memory."""
    torch.set_num_threads(1)
    distributed.initialize(f"tcp://localhost:{port}", world, rank, backend="gloo")
    spec, data = SPECS["ref-full"](), corpus(MAIN_BYTES)
    distributed.dist.barrier()
    blob, wall, launches = timed(lambda: distributed.compress_bytes_multihost(data, spec, STREAMS, CHUNK))
    distributed.dist.destroy_process_group()
    write_bytes(os.path.join(d, f"rank{rank}.gxtc"), blob)
    print(json.dumps({"rank": rank, "device": str(torch.device("cuda", torch.cuda.current_device())),
                      "streams": STREAMS // world, "launches": list(launches), "encode_s": wall,
                      "encode_bytes_per_s": len(data) / world / wall,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)


def phase_ranks(d: str, main_full: dict) -> dict:
    """(b) RANKS processes over gloo on the one card: each returns phase 3's
    ref-full archive byte for byte and launches 10 kernels a byte step; the
    aggregate encode bytes/s beside phase 3's one process (a reading)."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-c", f"import chip_smoke as cs; cs.rank_main({r}, {RANKS}, {port}, {d!r})"],
                              cwd=ROOT, env=cpu_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              start_new_session=True) for r in range(RANKS)]
    t0 = time.perf_counter()
    try:
        outs = [p.communicate(timeout=600)[0].decode(errors="replace") for p in procs]
    except subprocess.TimeoutExpired:
        raise RuntimeError("phase 6 ranks: the ranks did not end within 600 s")
    finally:
        for p in procs:
            stop(p)
    wall = time.perf_counter() - t0
    rows = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        lines = text.splitlines()
        for line in lines[-5:]:
            log(f"phase 6: rank {r}: {line}")
        if p.returncode != 0:
            raise RuntimeError(f"phase 6 ranks: rank {r} failed (exit code {p.returncode})")
        rows.append(json.loads(next(line for line in reversed(lines) if line.startswith('{"rank"'))))
        if read_bytes(os.path.join(d, f"rank{r}.gxtc")) != main_full["archive"]:
            raise RuntimeError(f"phase 6 ranks: rank {r}'s container is not phase 3's ref-full archive")
        per = MAIN_BYTES // STREAMS
        if tuple(rows[-1]["launches"]) != step_launches(per):
            raise RuntimeError(f"phase 6 ranks: rank {r} launched {rows[-1]['launches']}, expected {step_launches(per)}")
    out = {"spec": "ref-full", "ranks": RANKS, "backend": "gloo", "streams": STREAMS, "bytes": MAIN_BYTES,
           "chunk": CHUNK, "archive_bytes": len(main_full["archive"]), "same_archive_as_phase_3": True,
           "aggregate_encode_bytes_per_s": MAIN_BYTES / max(r["encode_s"] for r in rows),
           "one_process_encode_bytes_per_s": main_full["encode_bytes_per_s"], "processes_wall_s": wall,
           "launches": [sum(r["launches"][i] for r in rows) for i in range(len(WRAPPERS))], "per_rank": rows}
    log(f"phase 6: {RANKS} ranks on one card {json.dumps(out)}")
    return out


def phase_nccl(d: str) -> dict:
    """(c) a world of one rank over nccl on the card, in this process: phase
    4's GPU archive of NCCL_SPEC at scaled-12, 2 streams, byte for byte."""
    spec12 = scale_tables(SPECS[NCCL_SPEC](), 12, history_bits=16)
    n_bytes, chunk = CROSS_RUNS[NCCL_SPEC]
    distributed.initialize(f"tcp://localhost:{free_port()}", 1, 0)
    try:
        blob, wall, launches = timed(lambda: distributed.compress_bytes_multihost(corpus(n_bytes), spec12, 2, chunk))
        backend = str(distributed.dist.get_backend())
    finally:
        distributed.dist.destroy_process_group()
    if blob != read_bytes(os.path.join(d, f"{NCCL_SPEC}.gxtc")):
        raise RuntimeError(f"phase 6 nccl: the container is not phase 4's {NCCL_SPEC} GPU archive")
    per, per_step = n_bytes // 2, launches_per_step(spec12)
    if launches != tuple(e * per for e in per_step):
        raise RuntimeError(f"phase 6 nccl: launched {launches} in {per} byte steps, expected {per_step} a step")
    out = {"spec": f"{NCCL_SPEC} scaled-12", "ranks": 1, "backend": backend, "streams": 2, "bytes": n_bytes,
           "chunk": chunk, "archive_bytes": len(blob), "same_archive_as_phase_4": True, "wall_s": wall,
           "launches": list(launches)}
    log(f"phase 6: one rank over nccl {json.dumps(out)}")
    return out


def bench_steps(config: dict, result: dict) -> int:
    """Byte steps of one bench run: the warm start's unless it was read from
    a checkpoint, one chunk each coded direction to capture the graphs, the
    passes', the traced window's twice (capture and trace)."""
    wchunk = min(config["chunk"], bench.WARM_CHUNK)
    warm_steps = 0 if result["warm_source"] == "checkpoint" else config["warm_bytes"] // wchunk * wchunk
    directions = 2 if result["decoded"] else 1
    return (warm_steps + directions * config["chunk"] + directions * config["passes"] * result["byte_steps"]
            + 2 * result["trace_steps"])


def bench_run(argv, what: str, per_step, phase: int = 7) -> dict:
    """`bench.main(argv)` in this process, so that the launch counters see
    its kernels (set to 0 just before, read just after), its printed rows
    logged; the byte steps each profile's run made (`bench_steps`) must have
    launched `per_step` (`LAUNCHES`) kernels each, a tuple a
    profile of `--profile` (one tuple: every profile). Returns the first
    run's config, result and trace rows, passes and roofline, with every
    run's in `runs`, the launches and the device bytes held before."""
    out = io.StringIO()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    reset_launches()
    with contextlib.redirect_stdout(out):
        rc = bench.main(list(argv))
    got = read_launches()
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    for row in rows:
        log(f"phase {phase}: {what}: {json.dumps(row)}")
    if rc != 0:
        raise RuntimeError(f"phase {phase} {what}: exit code {rc}")
    starts = [i for i, r in enumerate(rows) if r["bench"] == "config"] + [len(rows)]
    per_step = [per_step] * (len(starts) - 1) if isinstance(per_step[0], int) else list(per_step)
    if len(per_step) != len(starts) - 1:
        raise RuntimeError(f"phase {phase} {what}: {len(starts) - 1} runs for {len(per_step)} launch counts")
    runs, want = [], NO_LAUNCHES
    for k, (a, b) in enumerate(zip(starts, starts[1:])):
        run = rows[a:b]
        config, result = run[0], run[-1]
        passes = [r for r in run if r["bench"] == "pass"]
        traces = [r for r in run if r["bench"] == "trace"]
        steps = bench_steps(config, result)
        want = tuple(w + c * steps for w, c in zip(want, per_step[k]))
        directions = 2 if result["decoded"] else 1
        if not (result["bench"] == "result" and result["exact"] and np.isfinite(result["model_bpb"])
                and len(passes) == directions * config["passes"] and result["decoded"] == (not config["encode_only"])):
            raise RuntimeError(f"phase {phase} {what}: {result}")
        if len(traces) != (1 if config["trace"] else 0):
            raise RuntimeError(f"phase {phase} {what}: {len(traces)} trace rows for --trace {config['trace']}")
        if round(result["state_gb"] * 1e9) != config["state_estimate_bytes"]:
            raise RuntimeError(f"phase {phase} {what}: the state holds {result['state_gb']} GB, the estimate was "
                               f"{config['state_estimate_bytes']} bytes")
        work = result["work_per_step"]
        roof = {"spec": config["spec"], "streams": result["streams"], "bytes": work["bytes"],
                "float_ops": work["float_ops"], "int_ops": work["int_ops"],
                "parts_bytes": {k: v["bytes"] for k, v in work["parts"].items()},
                **{k: result[k] for k in ("bound_ms", "bound_by", *SHARES, "achieved_gbps", "achieved_gflops")},
                "step_ms": 1e3 * min(result["encode_s"]) / result["byte_steps"]}
        if traces:
            roof["trace"] = {k: traces[0][k] for k in ("device_busy_ms_per_step", *SHARES)}
        log(f"phase {phase}: {what}: roofline {json.dumps(roof)}")
        for row in ([] if config["analysis"] else [result, *traces]):
            bad = {k: row[k] for k in SHARES if not (isinstance(row[k], float) and 0 < row[k] <= SHARE_MAX)}
            if bad:
                raise RuntimeError(f"phase {phase} {what}: the {row['bench']} row's shares {bad} are outside "
                                   f"(0, {SHARE_MAX}]")
        runs.append({"config": config, "result": result, "trace": traces[0] if traces else None, "passes": passes,
                     "byte_steps": steps, "roofline": roof})
    if got != want:
        raise RuntimeError(f"phase {phase} {what}: launches {LAUNCHES} {got} in "
                           f"{sum(r['byte_steps'] for r in runs)} byte steps, expected {want}: {per_step} a step")
    return {**runs[0], "runs": runs, "launches": list(got), "byte_steps": sum(r["byte_steps"] for r in runs),
            "held_before_gb": held_gb}


def phase_bench_warm_lane(spec, dev):
    """One stream at S=1 (the bench's warm start of run (a)) against lane 0
    of two streams coding the same bytes beside other ones, on the card: the
    streams never interact, so every leaf must be the same bits. Returns the
    reading and the S=1 warm state."""
    n, chunk = flag(BENCH_A, "--warm"), flag(BENCH_A, "--chunk")
    data = corpus(n)
    one = bench.pretrain_state(spec, data, chunk, dev)
    pred = Predictor(spec, 2, device=dev, analysis=False)
    arr = np.stack([np.frombuffer(data, np.uint8), np.frombuffer(corpus(2 * n)[n:], np.uint8)])
    run_chunks(pred, torch.as_tensor(arr, device=dev), torch.zeros((2, 1), dtype=torch.uint8, device=dev), n,
               decode=False, chunk=chunk)
    lanes = {path: leaf[0:1] if leaf.dim() else leaf for path, leaf in _leaves(pred.state)}
    same_leaves(lanes, one, "phase 7: the S=1 warm start against lane 0 of S=2")
    del pred
    out = {"spec": "ref-full", "bytes": n, "chunk": chunk, "same_as_lane_0": True}
    log(f"phase 7: S=1 against lane 0 of S=2 {json.dumps(out)}")
    return out, one


def same_leaves(got: dict, want_tree, what: str) -> None:
    """Every leaf of the state `want_tree` equals `got[path]` in shape,
    dtype and bits (and `got` has no other leaf), or RuntimeError."""
    want = dict(_leaves(want_tree))
    if sorted(got) != sorted(want):
        raise RuntimeError(f"{what}: leaves {sorted(set(got) ^ set(want))} are in one state only")
    for path, a in want.items():
        b = got[path].cpu()
        if (a.shape, a.dtype) != (b.shape, b.dtype) or not torch.equal(a.reshape(-1).view(torch.uint8),
                                                                      b.reshape(-1).view(torch.uint8)):
            raise RuntimeError(f"{what}: differs at {'.'.join(path)}")


def phase_bench(dev) -> dict:
    """(a) to (c): every pass exact and the same archive (bench.main raises
    otherwise), the profile's launches a byte step, the state equal to its
    estimate; (a)'s second run reads the checkpoint its first wrote, which
    holds the S=1 warm start bitwise, and writes the same archive; (b)'s
    stream count, estimate, peak and trace printed."""
    lane, one = phase_bench_warm_lane(SPECS["ref-full"](), dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        ckpt = ("--warm-checkpoint", os.path.join(tmp, "ref-2000.gxt"))
        a = bench_run(BENCH_A + ckpt, "16 streams, warm start trained", profile_launches("ref"))
        a2 = bench_run(BENCH_A + ckpt, "16 streams, warm start read", profile_launches("ref"))
        same_leaves(dict(_leaves(bench.load_warm_checkpoint(ckpt[1]))), one,
                    "phase 7: the warm checkpoint against the S=1 warm start")
    ra, ra2 = a["result"], a2["result"]
    if (ra["warm_source"], ra2["warm_source"]) != ("trained", "checkpoint"):
        raise RuntimeError(f"phase 7: the warm starts came from {ra['warm_source']}, {ra2['warm_source']}")
    if (ra["archive_bytes"], ra["archive_sha256"]) != (ra2["archive_bytes"], ra2["archive_sha256"]):
        raise RuntimeError("phase 7: the archive from the read warm start differs from the trained one's")
    checkpoint = {"warm_s_trained": ra["warm_s"], "warm_write_s": ra["warm_write_s"], "warm_s_read": ra2["warm_s"],
                  "same_as_s1_warm_start": True, "same_archive": True}
    log(f"phase 7: warm checkpoint {json.dumps(checkpoint)}")
    b = bench_run(BENCH_B, "auto streams, traced", profile_launches("ref"))
    profiles = {p: bench_run(("--profile", p) + BENCH_C, f"{p}, 4 streams", profile_launches(p))
                for p in BENCH_C_PROFILES}
    runs = [a, a2, b, *profiles.values()]
    cfg, res = b["config"], b["result"]
    out = {"warm_lane": lane, "a": a, "a_read": a2, "checkpoint": checkpoint, "b": b, "profiles": profiles,
           "launches": [sum(r["launches"][i] for r in runs) for i in range(len(WRAPPERS))],
           "auto": {"streams": cfg["streams"], "state_estimate_gb": cfg["state_estimate_bytes"] / 1e9,
                    "headroom_gb": cfg["headroom_bytes"] / 1e9, "budget_gb": cfg["budget_bytes"] / 1e9,
                    "peak_gb": res["peak_gb"], "peak_reserved_gb": res["peak_reserved_gb"],
                    "held_before_gb": b["held_before_gb"]}}
    log(f"phase 7: auto streams {json.dumps(out['auto'])}")
    return out


# ---------------------------------------------------------------------------
# phase 8: the ensemble variants
# ---------------------------------------------------------------------------


def variant_spec(name: str, scaled: bool = False):
    """A phase-8 profile's spec (`bench.parse_profile`), with `scaled` at
    scale_tables(spec, 12, history_bits=16), as phase 4 scales."""
    spec = bench.parse_profile(name)[1]
    return scale_tables(spec, 12, history_bits=16) if scaled else spec


def variant_cross_data() -> bytes:
    return corpus(VARIANT_CROSS_STREAMS * VARIANT_CROSS_PER)


def variant_file(d: str, name: str, what: str) -> str:
    return os.path.join(d, f"{name.replace(':', '_')}.{what}")


def variant_cpu_main(name: str, d: str) -> None:
    """Phase 8 (c)'s CPU side, in a process of its own: the variant at
    scaled-12 encodes VARIANT_CROSS_PER bytes a stream on the CPU (the plain
    versions) and decodes its archive; both land in `d`."""
    torch.set_num_threads(1)
    spec, data = variant_spec(name, scaled=True), variant_cross_data()
    blob = compress_bytes(data, spec, VARIANT_CROSS_STREAMS, VARIANT_CROSS_CHUNK, device="cpu")
    write_bytes(variant_file(d, name, "cpu.gxtc"), blob)
    write_bytes(variant_file(d, name, "cpu.out"), decompress_bytes(blob, spec, VARIANT_CROSS_CHUNK, device="cpu"))


def start_variant_cpu(d: str) -> dict:
    """Phase 8 (c)'s CPU runs, one process a variant, started to run beside
    the card's work."""
    return {name: subprocess.Popen([sys.executable, "-c", f"import chip_smoke as cs; cs.variant_cpu_main({name!r}, {d!r})"],
                                   cwd=ROOT, env=cpu_env(), start_new_session=True)
            for name in VARIANTS}


def variant_fused(name: str, spec, dev) -> dict:
    """(a) The fused kernel against its plain version on live inputs of the
    variant at VARIANT_STREAMS streams (`compare_fused_live`: encode and
    decode, learn on and off): every output bitwise but `ent` (16 ulp) and
    `ema` (1e-6 relative); each byte-model head's distribution a
    distribution. Its instantiation, bound and device time a launch."""
    pred = Predictor(spec, VARIANT_STREAMS, device=dev)
    meta, plan = pred.meta, pred.plan
    cases, err = compare_fused_live(name, pred, dev)
    heads = [h for h, on in (("ppm_probs", spec.ppm), ("lstm_probs", spec.lstm)) if on is not None]
    for probs in heads:
        p = cases["encode"][probs]
        if not torch.isfinite(p).all() or not torch.allclose(p.sum(dim=1), torch.ones_like(p[:, 0]), atol=1e-4):
            raise RuntimeError(f"phase 8 {name}: {probs} of the warmed state is not a distribution")
    row = {"spec": name, "streams": VARIANT_STREAMS, "dims": fused._dims(meta), "heads": heads, "max_abs_err": err,
           **fused_bound(meta, plan.fused, cases["encode"], VARIANT_STREAMS),
           "instantiation": fused.fused_instantiation(meta, plan.fused, True, True, VARIANT_STREAMS, dev),
           "ms": device_ms(lambda i: fused.fused_substeps(meta, plan.fused, cases["encode"], True, True), reps=20)}
    del pred, plan, cases
    torch.cuda.empty_cache()
    return row


def variant_roundtrip(name: str, spec, dev) -> dict:
    """(b) compress_bytes then decompress_bytes of VARIANT_PER bytes a
    stream at VARIANT_STREAMS streams, each on a fresh predictor: the input
    back, every byte step `launches_per_step(spec)` launches, and every
    captured graph's replay as many."""
    expect = launches_per_step(spec)
    data = corpus(MAIN_BYTES + VARIANT_STREAMS * VARIANT_PER)[MAIN_BYTES:]
    out = {"spec": name, "streams": VARIANT_STREAMS, "bytes": len(data), "chunk": CHUNK,
           "launches_per_step": list(expect)}
    blob = None
    for direction in ("encode", "decode"):
        pred = Predictor(spec, VARIANT_STREAMS, device=dev)
        got, wall, launches = timed(lambda: compress_bytes(data, spec, VARIANT_STREAMS, CHUNK, pred=pred)
                                    if direction == "encode" else decompress_bytes(blob, spec, CHUNK, pred=pred))
        if direction == "encode":
            blob = got
            out["model_bpb"] = entropy_bits(pred) / len(data)
        elif got != data:
            raise RuntimeError(f"phase 8 {name}: decompress_bytes did not give the input back")
        graphs = graph_summary(step_mod.get_chunk_fn(pred.plan, CHUNK))
        bad = {k: g["launches_per_replay"] for k, g in graphs.items() if tuple(g["launches_per_replay"]) != expect}
        if bad or launches != tuple(e * VARIANT_PER for e in expect):
            raise RuntimeError(f"phase 8 {name} {direction}: launches {launches} in {VARIANT_PER} byte steps, graphs "
                               f"{bad or graphs}; expected {expect} a step and a replay")
        out[direction] = {"wall_s": wall, "ms_per_step": 1e3 * wall / VARIANT_PER, "launches": list(launches),
                          "graphs": graphs}
        del pred
        torch.cuda.empty_cache()
    out.update(archive_bytes=len(blob), bpb=8 * len(blob) / len(data))
    return out


def variant_cross(name: str, dev, d: str, proc) -> dict:
    """(c) The GPU's archive of the variant at scaled-12 against the CPU's
    (`variant_cpu_main`, running in `proc`): the same bytes; the GPU decodes
    the CPU's archive and the CPU decoded its own, which is the GPU's, to
    the input."""
    spec, data = variant_spec(name, scaled=True), variant_cross_data()
    per = len(data) // VARIANT_CROSS_STREAMS
    blob, enc_s, enc = timed(lambda: compress_bytes(data, spec, VARIANT_CROSS_STREAMS, VARIANT_CROSS_CHUNK, device=dev))
    try:
        rc = proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"phase 8 {name}: the CPU's run did not end within 900 s")
    if rc != 0:
        raise RuntimeError(f"phase 8 {name}: the CPU's run failed (exit code {rc})")
    blob_cpu = read_bytes(variant_file(d, name, "cpu.gxtc"))
    if blob != blob_cpu:
        diff = next((i for i, (a, b) in enumerate(zip(blob, blob_cpu)) if a != b), min(len(blob), len(blob_cpu)))
        raise RuntimeError(f"phase 8 {name}: GPU and CPU archives differ ({len(blob)} vs {len(blob_cpu)} bytes, "
                           f"first at {diff})")
    back, dec_s, dec = timed(lambda: decompress_bytes(blob_cpu, spec, VARIANT_CROSS_CHUNK, device=dev))
    if back != data:
        raise RuntimeError(f"phase 8 {name}: the GPU does not decode the CPU archive")
    if read_bytes(variant_file(d, name, "cpu.out")) != data:
        raise RuntimeError(f"phase 8 {name}: the CPU does not decode the GPU archive")
    expect = launches_per_step(spec)
    if enc != dec or enc != tuple(e * per for e in expect):
        raise RuntimeError(f"phase 8 {name}: GPU launches encode {enc}, decode {dec}, expected {expect} a step")
    return {"spec": f"{name} scaled-12", "streams": VARIANT_CROSS_STREAMS, "bytes": len(data),
            "chunk": VARIANT_CROSS_CHUNK, "archive_bytes": len(blob), "identical": True, "cross_decodes": True,
            "gpu_encode_s": enc_s, "gpu_decode_s": dec_s, "launches": [a + b for a, b in zip(enc, dec)]}


def phase_variants(dev, d: str, procs: dict) -> dict:
    """Phase 8: for each of VARIANTS (a) the fused kernel against its plain
    version, (b) a roundtrip on the card with its launches asserted, (c)
    GPU against CPU at scaled-12 (the CPU's processes `procs`, started
    before); then the bench with two variant profiles in one call, the
    first predictor's device memory given back before the second is built."""
    out, launches = {}, list(NO_LAUNCHES)
    for name in VARIANTS:
        spec = variant_spec(name)
        row = {"fused": variant_fused(name, spec, dev), "roundtrip": variant_roundtrip(name, spec, dev),
               "cross": variant_cross(name, dev, d, procs[name])}
        for got in (row["roundtrip"]["encode"]["launches"], row["roundtrip"]["decode"]["launches"],
                    row["cross"]["launches"]):
            launches = [a + b for a, b in zip(launches, got)]
        log(f"phase 8: {name} {json.dumps(row)}")
        out[name] = row
    per_step = [profile_launches(p) for p in VARIANT_BENCH[1].split(",")]
    run = bench_run(VARIANT_BENCH, "two variant profiles", per_step, phase=8)
    held = [r["config"]["allocated_bytes"] for r in run["runs"]]
    if len(set(held)) != 1:
        raise RuntimeError(f"phase 8: the device held {held} bytes at the start of each profile's run: the first "
                           f"predictor's memory was not given back")
    out["bench"] = {"profiles": VARIANT_BENCH[1], "allocated_bytes_at_start": held,
                    "results": [{k: r["result"][k] for k in ("spec", "streams", "bpb", "model_bpb", "archive_bytes",
                                                             "encode_bytes_per_s", "decode_bytes_per_s", "state_gb",
                                                             "peak_gb")} for r in run["runs"]]}
    out["launches"] = [a + b for a, b in zip(launches, run["launches"])]
    log(f"phase 8: bench {json.dumps(out['bench'])}")
    return out


# ---------------------------------------------------------------------------
# phase 9: the sweeps
# ---------------------------------------------------------------------------


def sweep_kernels(name: str, spec, S: int, dev) -> dict:
    """The three kernels on the live inputs of a byte step of S streams of
    `spec` (`live_inputs`): the fused kernel against its plain version as in
    phase 2 (`compare_fused_live`); the grouped gather of the byte step's
    arenas on the step's own rows bitwise against its plain version,
    and the grouped scatter of the rows the kernel learned (a learning
    encode step) into the live arenas against the plain scatter into
    copies, every arena whole. Then each kernel timed: the fused kernel and
    its plain version on the live inputs, the movers' group on fresh random
    rows of the same arenas (`phase_grouped`, which checks them again)."""
    pred = Predictor(spec, S, device=dev)
    meta, plan = pred.meta, pred.plan
    fin, _, ix = live_inputs(pred, dev)
    cases, err = compare_fused_live(f"phase 9 {name}", pred, dev, fin)
    fo = fused.fused_substeps_plain(meta, plan.fused, fin, True, True)
    # (arena, table, the step's rows, the learned rows it scatters back) of
    # the grouped launches: three arenas without APM stages, four with
    group = []
    for a, path, i, o in (("ind.st", ("ind", "st"), "blk_ix", "ind_blk"), ("mix_w", ("mix_w",), "rowix_st", "rows_st"),
                          ("mix_pos", ("mix_pos",), "posix", "rows_pos"), ("apm", ("apm",), "apm_ix", "apm_rows")):
        if i in ix:
            tbl = functools.reduce(dict.__getitem__, path, pred.state["ltm"])
            group.append((a, tbl, ix[i], fo[o].reshape(ix[i].shape[0], ix[i].shape[1], -1)))
    pairs = [(t, i) for _, t, i, _ in group]
    for a, w in zip(group, rowmove.gather_rows_many_plain(pairs)):
        if w.shape != a[3].shape or w.dtype != a[3].dtype:
            raise RuntimeError(f"phase 9 {name}: {a[0]}'s learned rows are {tuple(a[3].shape)} {a[3].dtype}, its "
                               f"gathered rows {tuple(w.shape)} {w.dtype}")
    got, want = rowmove.gather_rows_many(pairs), rowmove.gather_rows_many_plain(pairs)
    torch.cuda.synchronize()
    for (a, *_), g, w in zip(group, got, want):
        if not torch.equal(g.view(torch.uint8), w.view(torch.uint8)):
            raise RuntimeError(f"phase 9 {name}: gather_rows_many differs from its plain version on {a}")
    refs = [t.clone() for _, t, _, _ in group]
    rowmove.scatter_rows_many([(t, i, u) for _, t, i, u in group])
    rowmove.scatter_rows_many_plain([(r, i, u) for r, (_, _, i, u) in zip(refs, group)])
    torch.cuda.synchronize()
    for (a, t, _, _), r in zip(group, refs):
        if not torch.equal(t.view(torch.uint8), r.view(torch.uint8)):
            raise RuntimeError(f"phase 9 {name}: scatter_rows_many differs from its plain version on {a}")
    del refs, got, want
    rng, gen = np.random.default_rng(SEED), torch.Generator(device=dev).manual_seed(SEED)
    names, tables = [a for a, *_ in group], [t for _, t, _, _ in group]
    counts = [i.shape[1] for _, _, i, _ in group]
    movers = {d: phase_grouped(d, names, tables, counts, rng, gen, dev) for d in ("gather", "scatter")}
    row = {"spec": name, "streams": S, "fused": {
        "max_abs_err": err, "instantiation": fused.fused_instantiation(meta, plan.fused, True, True, S, dev),
        **fused_bound(meta, plan.fused, cases["encode"], S),
        "ms": device_ms(lambda i: fused.fused_substeps(meta, plan.fused, fin, True, True), reps=20),
        "plain_ms": device_ms(lambda i: fused.fused_substeps_plain(meta, plan.fused, fin, True, True), reps=3,
                              warmup=1)},
        **{d: {k: m[k] for k in ("arenas", "rows", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms")}
           for d, m in movers.items()}}
    row["live_rows_bitwise"] = True
    del pred, plan, cases, fin, fo, group, pairs, tables
    torch.cuda.empty_cache()
    log(f"phase 9: kernels on live inputs {json.dumps(row)}")
    return row


def sweep_run(argv, what: str) -> dict:
    """`sweeps.main(argv)` in this process, so that the launch counters see
    its kernels (set to 0 just before, read just after), its rows logged:
    exit code 0, and the byte steps its rows ran (`byte_steps`) each
    launching the spec's kernels (every sweep's spec has PPM and the LSTM:
    3 + 2 + 1 + 1 + 1 + 1 + 1)."""
    out = io.StringIO()
    torch.cuda.empty_cache()
    reset_launches()
    with contextlib.redirect_stdout(out):
        rc = sweeps.main(list(argv))
    got = read_launches()
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    for row in rows:
        log(f"phase 9: {what}: {json.dumps(row)}")
    if rc != 0:
        raise RuntimeError(f"phase 9 {what}: exit code {rc}")
    body = rows[1:]
    steps = sum(r["byte_steps"] for r in body)
    want = tuple(c * steps for c in launches_per_step(reference_spec()))
    if not steps or got != want:
        raise RuntimeError(f"phase 9 {what}: launches {LAUNCHES} {got} in {steps} byte steps, "
                           f"expected {want}")
    return {"rows": body, "launches": list(got), "byte_steps": steps}


def check_sweep(what: str, rows: list) -> dict:
    """What each sweep's rows must say: every roundtrip exact, every
    reading finite, the warm rows from their snapshots, one ring that wraps
    and one that does not."""
    def finite(*vals):
        return all(isinstance(v, float) and math.isfinite(v) and v > 0 for v in vals)

    last = rows[-1]
    kind = what.split()[0]
    if kind == "sequential" and "capture" in what:
        ok = last["graphs"] > 0 and finite(last["capture_s"])
    elif kind == "sequential":
        ok = last["status"] == "done" and last["roundtrip_exact"] is True and finite(last["bpb"], last["model_bpb"])
    elif kind == "warm":
        warm = [r for r in rows if r["bench"] == "warm"]
        ok = ([r["warm_bytes_actual"] for r in warm] == [8000, 32000] and all(r["overlaps_warm"] for r in warm)
              and all(finite(r["bpb"], r["model_bpb"]) for r in warm))
    elif kind == "ring":
        ok = (sorted(r["wraps"] for r in rows) == [False, True] and all(finite(r["bpb"], r["model_bpb"]) for r in rows))
    elif kind == "scaling":
        ok = [r["S"] for r in rows] == [1, 16, SWEEP_WIDE] and all(finite(r["chunk_ms"], r["mem_gb"]) for r in rows)
    else:
        ok = last["chain_byte_identical"] is True and finite(last["bpb_vs_original"])
    if not ok:
        raise RuntimeError(f"phase 9 {what}: {rows}")
    return last


def phase_sweeps(dev) -> dict:
    """Phase 9: the kernels on live inputs at one stream (ref, best) and at
    SWEEP_WIDE streams (scaling's spec at 12 bits), then every sweep of
    SWEEP_RUNS with its launches asserted and its rows checked."""
    kernels = {f"{name} S={S}": sweep_kernels(name, spec, S, dev)
               for name, spec, S in (("ref", reference_spec(), 1), ("best", best_spec(), 1),
                                     ("scaled-12", sweeps.scaling_spec(12), SWEEP_WIDE))}
    runs, launches = {}, list(NO_LAUNCHES)
    for what, argv in SWEEP_RUNS:
        t0 = time.perf_counter()
        run = sweep_run(argv, what)
        runs[what] = {"last": check_sweep(what, run["rows"]), "launches": run["launches"],
                      "byte_steps": run["byte_steps"], "wall_s": time.perf_counter() - t0}
        launches = [a + b for a, b in zip(launches, run["launches"])]
        log(f"phase 9: {what} done in {runs[what]['wall_s']:.1f} s")
    return {"kernels": kernels, "runs": runs, "launches": launches}


def code_sizes(lib_path) -> dict:
    """Instructions of each kernel in the built library, counted from
    `cuobjdump -sass` (16 bytes each); empty where the toolkit has no
    cuobjdump."""
    import re
    import shutil

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return {}
    out = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(r"/\*[0-9a-f]{4,6}\*/", line):
            counts[name] += 1
    return counts


def main() -> int:
    fused_only = sys.argv[1:] == ["--fused-only"]
    bench_only = sys.argv[1:] == ["--bench-only"]
    variants_only = sys.argv[1:] == ["--variants-only"]
    sweeps_only = sys.argv[1:] == ["--sweeps-only"]
    ppm_only = sys.argv[1:] == ["--ppm-only"]
    contexts_only = sys.argv[1:] == ["--contexts-only"]
    if sys.argv[1:] and not (fused_only or bench_only or variants_only or sweeps_only or ppm_only or contexts_only):
        print("usage: chip_smoke.py [--fused-only | --bench-only | --variants-only | --sweeps-only | --ppm-only | "
              "--contexts-only]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's GPU path cannot run here", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    # the CPU's work (phase 4, the CPU half of phase 5) is eager torch on
    # tensors of a few KB: one thread a process runs it fastest
    torch.set_num_threads(1)
    t_start = time.perf_counter()

    def elapsed(done: str) -> None:
        log(f"{done} at {time.perf_counter() - t_start:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"gmix_tpu_torch {gt.__version__}")
    log(f"phase 0: {smi}")

    res = build()
    log(f"phase 1: built {os.path.relpath(res.path, ROOT)} in {res.seconds:.1f} s (rebuilt={res.rebuilt})")
    for line in res.log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    if ppm_only:
        ppm_out = phase_ppm(dev)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "partial": "the PPM kernels only", "ppm": ppm_out}), flush=True)
        return 0
    if contexts_only:
        contexts_out = phase_contexts(dev)
        elapsed("phase 2d done")
        print(smi, flush=True)
        print(json.dumps({"ok": True, "partial": "the contexts kernels only", "contexts": contexts_out}), flush=True)
        return 0
    if bench_only:
        bench_out = phase_bench(dev)
        elapsed("phase 7 done")
        print(smi, flush=True)
        print(json.dumps({"ok": True, "partial": "the bench only", "launches": bench_out["launches"]}), flush=True)
        return 0
    if sweeps_only:
        sweeps_out = phase_sweeps(dev)
        elapsed("phase 9 done")
        print(smi, flush=True)
        print(json.dumps({"ok": True, "partial": "the sweeps only", "launches": sweeps_out["launches"]}), flush=True)
        return 0
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    if variants_only:
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as vdir:
            procs = start_variant_cpu(vdir)
            try:
                variants_out = phase_variants(dev, vdir, procs)
            finally:
                for proc in procs.values():
                    stop(proc)
        elapsed("phase 8 done")
        print(smi, flush=True)
        print(json.dumps({"ok": True, "partial": "the variants only", "launches": variants_out["launches"]}),
              flush=True)
        return 0
    specs = {name: make() for name, make in SPECS.items()}
    pred = Predictor(specs["ref-noppm"], STREAMS, device=dev)
    fused_row = phase_fused(pred, dev)
    if fused_only:
        log(f"phase 1: instructions per kernel {json.dumps(code_sizes(res.path))}")
        print(smi, flush=True)
        print(json.dumps({"ok": True, "partial": "the fused kernel only", "fused_substeps": fused_row}), flush=True)
        return 0
    del pred
    torch.cuda.empty_cache()
    pred = Predictor(specs["ref-ppm"], STREAMS, device=dev)
    fused_ppm_row = phase_fused_heads("ref-ppm", pred, dev)
    per_arena, grouped = phase_rowmovers(pred, dev)
    del pred
    torch.cuda.empty_cache()
    pred = Predictor(specs["ref-full"], STREAMS, device=dev)
    fused_full_row = phase_fused_heads("ref-full", pred, dev)
    del pred
    torch.cuda.empty_cache()
    ppm_out = phase_ppm(dev)
    contexts_out = phase_contexts(dev)
    elapsed("phase 2 done")
    main_out = {name: phase_main(name, spec, dev) for name, spec in specs.items()}
    elapsed("phase 3 done")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        cpu_proc, cpu_dir = start_cli_cpu(tmp)
        decodes = {}
        try:
            for name, spec in specs.items():
                decodes[name] = phase_cross(name, spec, dev, tmp)
            elapsed("phase 4 done but for the CPU's decodes")
            cli_out = phase_cli(tmp, cpu_proc, cpu_dir, dev, main_out["ref-full"]["bpb"],
                                fused_full_row["instantiation"])
            elapsed("phase 5 done")
            finish_cpu_decodes(decodes)
            elapsed("phase 4's CPU decodes done")
            shards_out = phase_shards(specs["ref-full"], dev, tmp)
            elapsed("phase 6 (a) done")
            ranks_out = phase_ranks(tmp, main_out["ref-full"])
            elapsed("phase 6 (b) done")
            nccl_out = phase_nccl(tmp)
            elapsed("phase 6 done")
        finally:
            for proc in [cpu_proc] + [proc for proc, _, _ in decodes.values()]:
                stop(proc)
    # phase 8's CPU runs go beside phase 7, which keeps the card busy
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as vdir:
        procs = start_variant_cpu(vdir)
        try:
            bench_out = phase_bench(dev)
            elapsed("phase 7 done")
            variants_out = phase_variants(dev, vdir, procs)
            elapsed("phase 8 done")
        finally:
            for proc in procs.values():
                stop(proc)
    sweeps_out = phase_sweeps(dev)
    elapsed("phase 9 done")

    def launches(i):
        """Kernel i's launches on each main path: encode + decode, the two
        generate_bytes calls (prompt and sampling, sampling alone), the
        command line's commands on the card (phase 5), and phase 6's sharded
        and multi-process runs."""
        by_path = {}
        for name, out in main_out.items():
            by_path[name] = out["launches_encode"][i] + out["launches_decode"][i]
            by_path[f"{name} generate"] = out["generate"]["launches"][i] + out["generate"]["sampling_alone_launches"][i]
        by_path["cli"] = cli_out["launches"][i]
        # phase 6: the sharded predictor's encode and decode; the ranks' and
        # the nccl rank's encodes
        by_path["mesh"] = sum(v[i] for k, v in shards_out["launches"].items() if k.startswith("sharded"))
        by_path["distributed"] = ranks_out["launches"][i] + nccl_out["launches"][i]
        # phase 7: the bench's runs, warm starts and graph captures included
        by_path["bench"] = bench_out["launches"][i]
        # phase 8: the variants' roundtrips on the card (published sizes and
        # scaled-12) and the bench's two variant profiles
        by_path["variants"] = variants_out["launches"][i]
        # phase 9: the sweeps' runs at their cut sizes
        by_path["sweeps"] = sweeps_out["launches"][i]
        return by_path

    def mover(direction, replaces_key):
        """A mover's entry: the ref-ppm byte step's grouped launch of five
        arenas, the four-arena group of ref-noppm and the single launches."""
        five, four = grouped[direction, 5], grouped[direction, 4]
        by_path = launches(0 if direction == "gather" else 1)
        keys = ("ms", "call_ms", "plain_ms", "bound_ms", "library_ms", "single_launches_ms", "single_launches_call_ms")
        return {
            "name": f"{direction}_rows",
            "route": "cuda",
            "source": SOURCES[replaces_key],
            "replaces": REPLACES[replaces_key],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_per_replay": per_replay(0 if direction == "gather" else 1),
            "max_abs_err": max(five["max_abs_err"], four["max_abs_err"], max(r[f"{direction}_err"] for r in per_arena)),
            **{k: five[k] for k in keys},
            "bound_by": "bytes",
            "launch_floor_ms": five["launch_floor_ms"],
            "four_arenas": {k: four[k] for k in keys},
            # the four-arena group's rows as four single launches
            "four_launches_ms": four["single_launches_ms"],
            "four_launches_call_ms": four["single_launches_call_ms"],
            "per_arena": [{"arena": r["arena"], "ms": r[f"{direction}_ms"], "plain_ms": r[f"{direction}_plain_ms"],
                           "bound_ms": r["bound_ms"], "library_ms": r[f"{direction}_library_ms"]} for r in per_arena],
            # the byte step's group at the arenas of phase 9's live
            # predictors (one stream of ref and best, 256 at scaled-12)
            "sweeps": {k: v[direction] for k, v in sweeps_out["kernels"].items()},
        }

    def per_replay(i):
        """Kernel i's launches in one replay of each graph of phase 3: the
        encoder's (a byte, the byte that wraps the LSTM's window) and the
        sampling step's, by spec."""
        rows = {}
        for name, out in main_out.items():
            for variant, g in {**out["encode_graphs"], **out["generate"]["sample_graphs"]}.items():
                rows[f"{name} {variant}"] = g["launches_per_replay"][i]
        return rows

    fused_by_path = launches(2)
    kernels = [mover("gather", "gather_rows"), mover("scatter", "scatter_rows"), {
        "name": "fused_substeps",
        "route": "cuda",
        "source": SOURCES["fused_substeps"],
        "replaces": REPLACES["fused_substeps"],
        "launches": sum(fused_by_path.values()),
        "launches_by_path": fused_by_path,
        "launches_per_replay": per_replay(2),
        "max_abs_err": max(fused_row["max_abs_err"], fused_ppm_row["max_abs_err"], fused_full_row["max_abs_err"],
                           *(v["fused"]["max_abs_err"] for k, v in variants_out.items() if k in VARIANTS),
                           *(v["fused"]["max_abs_err"] for v in sweeps_out["kernels"].values())),
        "ms": fused_row["ms"],
        "call_ms": fused_row["call_ms"],
        "plain_ms": fused_row["plain_ms"],
        "bound_ms": fused_row["bound_ms"],
        "bound_by": fused_row["bound_by"],
        # no single PyTorch call computes the 8 sub-steps
        "library_ms": None,
        "instantiation": fused_row["instantiation"],
        "ref_ppm_ms": fused_ppm_row["ms"],
        # on the live inputs of a running ref-full model (PPM and LSTM heads)
        "ref_full": {k: fused_full_row[k] for k in ("ms", "decode_ms", "bound_ms", "bound_by", "bytes_moved")},
        # the sampling mode (generation) on the same live ref-full inputs, and
        # its launches in the sampling steps of the three generate paths
        "sampling": {
            **{k: fused_full_row["sample"][k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                                                        "bytes_moved", "max_abs_err", "encode_nolearn_ms",
                                                        "encode_call_ms")},
            # the prompt's replay makes one encode launch a byte (asserted)
            "launches": sum(out["generate"]["launches"][2] - GEN_PROMPT + out["generate"]["sampling_alone_launches"][2]
                            for out in main_out.values()) + cli_out["cross"]["sampling_launches"],
            "inv_temps": list(INV_TEMPS),
        },
        # on the live inputs of each phase-8 variant at VARIANT_STREAMS streams
        "variants": {k: {f: v["fused"][f] for f in ("ms", "bound_ms", "bound_by", "bytes_moved", "max_abs_err",
                                                    "instantiation")}
                     for k, v in variants_out.items() if k in VARIANTS},
        # on the live inputs of phase 9 (one stream of ref and best, 256
        # streams at scaled-12)
        "sweeps": {k: {f: v["fused"][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by", "bytes_moved",
                                                 "max_abs_err", "instantiation")}
                   for k, v in sweeps_out["kernels"].items()},
    }]
    for i, which in ((3, "update"), (4, "predict")):
        by_path = launches(i)
        ref = ppm_out["ref"][which]
        kernels.append({
            "name": f"ppm_{which}",
            "route": "cuda",
            "source": SOURCES["ppm"],
            # gmix_tpu computes the PPM cascade in plain jnp, outside any kernel
            "replaces": None,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_per_replay": per_replay(i),
            "max_abs_err": 0.0,
            **{k: ref[k] for k in ("ms", "call_ms", "plain_ms", "plain_graph_ms", "bound_ms", "bound_by",
                                   "bytes_moved", "float_ops")},
            "streams": ppm_out["ref"]["streams"],
            "best": {k: ppm_out["best"][which][k] for k in ("ms", "plain_graph_ms", "bound_ms")},
        })
    for i, which in ((5, "boundary"), (6, "match")):
        by_path = launches(i)
        ref = contexts_out["ref"][which]
        kernels.append({
            "name": "contexts_boundary" if which == "boundary" else "match_pointer",
            "route": "cuda",
            "source": SOURCES["contexts"],
            # gmix_tpu computes the contexts and the match pointers in plain
            # jnp, outside any kernel
            "replaces": None,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_per_replay": per_replay(i),
            "max_abs_err": 0.0,
            **{k: ref[k] for k in ("ms", "call_ms", "plain_ms", "plain_graph_ms", "bound_ms", "bound_by",
                                   "bytes_moved")},
            "streams": contexts_out["ref"]["streams"],
            **{other: {k: contexts_out[other][which][k] for k in ("ms", "plain_graph_ms", "bound_ms")}
               for other in ("best", "ref-noppm")},
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
