"""Command-line runner with reference-parity modes (src/runner/runner.cpp):

  gmix_tpu_torch compress   [-k ckpt] IN OUT      (reference: gmix -c)
  gmix_tpu_torch decompress [-k ckpt] IN OUT      (reference: gmix -d)
  gmix_tpu_torch train      [-k ckpt] TRAIN TEST  (reference: gmix -t)
  gmix_tpu_torch generate   -k ckpt PROMPT OUT SIZE TEMP   (reference: gmix -g)

plus the dictionary and Wikipedia-dump transforms, and the knobs of
`gmix_tpu.cli`: --streams (block-parallel lanes), --chunk (padding, and the
order of an LSTM's backward pass), --profile (ensemble preset), --seed.
The port of `gmix_tpu.cli`, with the same sub-commands, flags, defaults,
printed lines and files; its one new flag, --device, says where the model
runs: the current CUDA device unless it names another (`cpu` runs the plain
torch path). Run it as `python -m gmix_tpu_torch.cli`.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import struct
import sys
import time

import numpy as np

CHUNK_HELP = (
    "bytes per stream between progress calls and analysis rows; inputs are "
    "padded to a multiple of it. Every profile has an LSTM, and CHUNK also "
    "picks the order of its backward pass: after each horizon-long segment "
    "when the horizon (tiny: 10, the others: 100) divides CHUNK, otherwise "
    "inside the byte that wraps the window. The two orders learn different "
    "weights and the archive does not record which was used: decompress "
    "with a CHUNK that is a multiple of the horizon exactly when the "
    "compress's was, or the output is other bytes, with no error"
)


def _spec(args):
    from .config import best_spec, reference_spec, scale_tables, tiny_spec

    if args.profile == "ref":
        s = reference_spec()
    elif args.profile == "best":
        s = best_spec()
    elif args.profile == "tiny":
        s = tiny_spec(with_lstm=True)
    else:
        # scaled-N: reference wiring with tables clamped to 2^N entries
        import re

        m = re.fullmatch(r"scaled-(\d+)", args.profile)
        if not m:
            raise SystemExit(
                f"unknown profile {args.profile!r}: use 'ref', 'best', 'tiny', "
                "or 'scaled-<bits>'"
            )
        bits = int(m.group(1))
        s = scale_tables(reference_spec(), bits, history_bits=min(24, bits + 4))
    return s


def _device(args):
    """torch.device of --device; without it the current CUDA device, and
    with none the command exits with `default_device()`'s error."""
    import torch

    from .core.codec import default_device

    if args.device is not None:
        return torch.device(args.device)
    try:
        return default_device()
    except RuntimeError as e:
        raise SystemExit(f"{e}; on the command line: --device cpu")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _write(path, data):
    with open(path, "wb") as f:
        f.write(data)


def _progress(total, label):
    t0 = time.time()

    def cb(done):
        frac = 100.0 * done / max(total, 1)
        rate = done / max(time.time() - t0, 1e-9) / 1e6
        sys.stderr.write(f"\r{label}: {frac:6.2f}%  ({rate:.3f} MB/s)")
        sys.stderr.flush()

    return cb


def main(argv=None):
    p = argparse.ArgumentParser(prog="gmix_tpu_torch")
    p.add_argument("--profile", default="scaled-12",
                   help="ref | best (highest measured quality) | tiny | "
                        "scaled-N (tables capped at 2^N)")
    p.add_argument("--streams", type=int, default=8)
    p.add_argument("--chunk", type=int, default=4096, help=CHUNK_HELP)
    p.add_argument("--seed", type=int, default=0xDEADBEEF)
    p.add_argument("--device", default=None,
                   help="where the model runs: a torch device such as cuda:1 "
                        "or cpu (default: the current CUDA device; without "
                        "one the command fails)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("compress")
    pc.add_argument("-k", "--checkpoint", default=None)
    pc.add_argument("--analysis", default=None, metavar="DIR",
                    help="write per-model entropy.tsv + memory.tsv to DIR "
                         "(reference: Predictor::EnableAnalysis)")
    pc.add_argument("input")
    pc.add_argument("output")

    pd = sub.add_parser("decompress")
    pd.add_argument("-k", "--checkpoint", default=None)
    pd.add_argument("input")
    pd.add_argument("output")

    pt = sub.add_parser("train")
    pt.add_argument("-k", "--checkpoint", default=None)
    pt.add_argument("--out-checkpoint", default="data/trained_checkpoint.gxt")
    pt.add_argument("--eval-every", type=int, default=0,
                    help="evaluate test entropy every N bytes (0: only at end)")
    pt.add_argument("train")
    pt.add_argument("test")

    pg = sub.add_parser("generate")
    pg.add_argument("-k", "--checkpoint", required=True)
    pg.add_argument("prompt")
    pg.add_argument("output")
    pg.add_argument("size", type=int)
    pg.add_argument("temperature", type=float)

    # dictionary transform (reference: dictionary-prep -e/-d)
    for name in ("dict-encode", "dict-decode"):
        pde = sub.add_parser(name)
        pde.add_argument("--dictionary", default=None)  # None -> vendored asset
        pde.add_argument("input")
        pde.add_argument("output")

    # enwik9 STARLIT-pipeline equivalent (reference: enwik9-prep c/d)
    pw = sub.add_parser("wiki-encode")
    pw.add_argument("--order", default=None,
                    help="similarity-order file (default: the reference asset)")
    pw.add_argument("--no-verify", action="store_true",
                    help="skip the decode(encode(x))==x self-check")
    pw.add_argument("input")
    pw.add_argument("output")
    pwd = sub.add_parser("wiki-decode")
    pwd.add_argument("input")
    pwd.add_argument("output")

    args = p.parse_args(argv)

    if args.cmd == "wiki-encode":
        from .preprocess import wiki

        n = wiki.encode_file(args.input, args.output, order_path=args.order,
                             verify=not args.no_verify)
        print(f"{os.path.getsize(args.input)} -> {n} bytes")
        return 0
    if args.cmd == "wiki-decode":
        from .preprocess import wiki

        n = wiki.decode_file(args.input, args.output)
        print(f"{os.path.getsize(args.input)} -> {n} bytes")
        return 0

    if args.cmd in ("dict-encode", "dict-decode"):
        from .preprocess import dictionary as D

        d = D.load(args.dictionary)
        data = _read(args.input)
        out = d.encode(data) if args.cmd == "dict-encode" else d.decode(data)
        _write(args.output, out)
        print(f"{len(data)} -> {len(out)} bytes")
        return 0

    spec = _spec(args)
    dev = _device(args)

    from .core.codec import (
        Predictor,
        compress_bytes,
        decompress_bytes,
        entropy_bits,
        generate_bytes,
    )

    t0 = time.time()
    if args.cmd == "compress":
        data = _read(args.input)
        pred = Predictor(spec, args.streams, args.seed, device=dev)
        if args.checkpoint:
            pred.load(args.checkpoint)
        progress = _progress(len(data) // max(args.streams, 1), "compress")
        with contextlib.ExitStack() as files:
            if args.analysis:
                from .core.codec import analysis_columns, analysis_snapshot, memory_report

                os.makedirs(args.analysis, exist_ok=True)
                with open(os.path.join(args.analysis, "memory.tsv"), "w") as f:
                    f.write("component\tbytes\n")
                    rows = memory_report(pred)  # gmix_tpu's bytes, as its memory.tsv has them
                    for name, nbytes in rows:
                        f.write(f"{name}\t{nbytes}\n")
                    f.write(f"TOTAL\t{sum(n for _, n in rows)}\n")
                # The per-column entropy EMA itself updates EVERY BIT in-model
                # (alpha=1e-5, as predictor.cpp:439-469); only the snapshot
                # cadence differs from the reference: rows are sampled once
                # per chunk, as in gmix_tpu (mirrored), and labelled with the
                # exact per-stream bit counter from the model state (one
                # read-back of it and of the EMA a chunk).
                ent_f = files.enter_context(open(os.path.join(args.analysis, "entropy.tsv"), "w"))
                ent_f.write("bits\t" + "\t".join(analysis_columns(spec)) + "\n")
                base_progress = progress

                def progress(done, _pred=pred, _f=ent_f):
                    base_progress(done)
                    bits = int(np.mean(_pred.state["stm"]["bits_seen"].cpu().numpy()))
                    row = analysis_snapshot(_pred).mean(axis=0)
                    _f.write(f"{bits}\t" + "\t".join(f"{v:.5f}" for v in row) + "\n")
                    _f.flush()

            blob = compress_bytes(data, spec, args.streams, args.chunk, pred=pred,
                                  progress=progress)
        _write(args.output, blob)
        ent = entropy_bits(pred) / max(len(data), 1)
        sys.stderr.write("\n")
        print(f"{len(data)} -> {len(blob)} bytes ({8*len(blob)/max(len(data),1):.4f} bits/byte, "
              f"model entropy {ent:.4f} bits/byte) in {time.time()-t0:.1f}s")
    elif args.cmd == "decompress":
        blob = _read(args.input)
        pred = None
        if args.checkpoint:
            S = struct.unpack("<H", blob[6:8])[0]
            pred = Predictor(spec, S, args.seed, device=dev)
            pred.load(args.checkpoint)
        out = decompress_bytes(blob, spec, args.chunk, pred=pred, device=dev)
        _write(args.output, out)
        print(f"{len(blob)} -> {len(out)} bytes in {time.time()-t0:.1f}s")
    elif args.cmd == "train":
        _train(args, spec, dev)
    elif args.cmd == "generate":
        prompt = _read(args.prompt)
        pred = Predictor(spec, args.streams, args.seed, device=dev)
        pred.load(args.checkpoint)
        out = generate_bytes(pred, prompt, args.size,
                             args.temperature, chunk=min(args.chunk, 256))
        _write(args.output, out)
        print(f"generated {len(out)} bytes in {time.time()-t0:.1f}s")
    return 0


def _train(args, spec, dev):
    """Training mode (runner-utils.cpp:223-322): compress the train file while
    learning; periodically deep-copy the predictor and measure test-set
    cross-entropy without touching the live model; save a checkpoint.

    The evaluations fall on chunk multiples, so every `run_chunks` call
    starts at a multiple of the LSTM's horizon whenever the horizon divides
    the chunk, as the deferred backward pass requires. The copy doubles the
    state on the device while the test file runs through it."""
    import torch

    from .core import codec as C

    train = _read(args.train)
    test = _read(args.test)
    S, chunk = args.streams, args.chunk
    pred = C.Predictor(spec, S, args.seed, device=dev)
    if args.checkpoint:
        pred.load(args.checkpoint)

    arr, per = C._pad_streams(train, S, chunk)
    data_buf = torch.as_tensor(arr, device=dev)
    # the port's encoder hands its code bytes back per chunk and never
    # writes the code buffer
    code_buf = torch.zeros((S, 1), dtype=torch.uint8, device=dev)
    tarr, tper = C._pad_streams(test, S, chunk)

    eval_every = args.eval_every or per  # bytes per stream between evals
    eval_every = max(chunk, (eval_every // chunk) * chunk)
    done = 0
    os.makedirs("analysis", exist_ok=True)
    with open("analysis/training.tsv", "w") as tsv:
        tsv.write("bytes\ttrain_entropy\ttest_entropy\n")
        while done < per:
            n = min(eval_every, per - done)
            C.run_chunks(pred, data_buf, code_buf, n, decode=False, t0=done, chunk=chunk)
            done += n
            train_ent = C.entropy_bits(pred) / max(done * S, 1)
            # deep copy + test evaluation (Predictor::Copy, predictor.cpp:42-48)
            p2 = pred.copy()
            ent0 = C.entropy_bits(p2)
            tdata = torch.as_tensor(tarr, device=dev)
            C.run_chunks(p2, tdata, code_buf, tper, decode=False, chunk=chunk)
            test_ent = (C.entropy_bits(p2) - ent0) / max(len(test), 1)
            del p2  # before the next copy: at most two states on the device
            tsv.write(f"{done * S}\t{train_ent:.5f}\t{test_ent:.5f}\n")
            tsv.flush()
            print(f"trained {done*S} bytes: train {train_ent:.4f} test {test_ent:.4f} bits/byte")

    os.makedirs(os.path.dirname(args.out_checkpoint) or ".", exist_ok=True)
    pred.save(args.out_checkpoint)
    print(f"checkpoint saved to {args.out_checkpoint}")


if __name__ == "__main__":
    sys.exit(main())
