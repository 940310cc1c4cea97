"""The parts of the program's captured byte step in a traced window: each
graph replay's device operations mapped onto the layout that the program
recorded when it captured the graph (`gmix_tpu_torch.obs.layouts()`: by
graph variant, the ordered runs `[part, nodes]` of the nodes each part of
the step made, each node's type, and whether the nodes form a chain in
their order).

The replays' order is that of the program's `gmix.replay.<variant>` host
spans in the window. A replay of a graph that holds the fused kernel is
anchored on its one launch of it (the configuration's `kernels.fused`), at
the layout's index for it; a graph without it (the LSTM's backward pass)
lies between two byte replays, right after the one before it. Between two
replays the host may launch the same number of operations outside any
graph (torch's per-replay fills, where it makes them). A copy or fill node
may show as a kernel (CUDA runs some copies as `memcpy32_post`).

Each replay aligns on its own: placed where the replay before it ends (the
count of operations between replays being the one most pairs of anchored
neighbours show), every operation of its node's type, all of its nodes
inside the window. A replay out of step with the one before it (a record
lost or added between two anchors) fails with every replay back to the last
anchored one. The window gives nothing (None, with a reason) where a graph
in it has no layout or is not a chain, where the fused launches do not
match the replays that hold one, or where fewer than `MIN_SHARE` of its
replays align. The profiler can lose the end of a window: on the H100 with
torch 2.11 one traced window of `ref-s1` in six lost 263 of the 5 641
records of its last replay (the backward pass) and put 578 more past the
window's end, while every other replay's records were whole. A program that
records no layouts (one older than them) gives nothing to read.

`align` is the all-or-nothing form: None unless every replay aligns. The
port's own bench aligns its trace rows by that rule (`gmix_tpu_torch/obs.py`
`replay_parts`, a copy: the port does not import the benchmark);
tests/test_torch_obs.py holds the two to the same answers."""
from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

from .trace import union

REPLAY = "gmix.replay."
NODE_TYPE = {"kernel": "K", "gpu_memcpy": "C", "gpu_memset": "S"}  # activity type -> the layout's node type
TRACED = "KCS"
# The least share of a window's replays that must align for the parts to
# read. A replay of one graph does the same work as every other (the same
# nodes on the same shapes): on the H100 a byte replay's parts vary by
# 0.2-1% (PPM 1-3%) from replay to replay, and leaving out any run of a
# tenth of a window's 202 replays moves a part by 0.19% at most (PPM; the
# others 0.08%), under its spread from run to run. So the replays that align
# stand for those that do not, down to nine in ten; the profiler's losses
# seen so far cost one replay in 202.
MIN_SHARE = 0.9

_last: list = [None, None]  # the trace aligned last, and what it gave


def layouts() -> Optional[dict]:
    """The program's graph layouts by variant, or None where it keeps none."""
    try:
        from gmix_tpu_torch import obs
    except ImportError:
        return None
    read = getattr(obs, "layouts", None)
    return read() if read is not None else None


def replays(trace, lays: dict, fused) -> Tuple[Optional[list], str]:
    """The window's replays of `trace` (trace.Trace) in order, each aligned
    on its own (module docstring): ([(variant, {part: device ns} or None
    where it does not align, why not, [(start, end) of its operations]),
    ...], "") or, where the window gives nothing to align, (None, why).
    `fused`: the fused kernel's trace names."""
    lo, hi = trace.window
    ops = sorted((o for o in trace.ops if lo <= o[2] < hi), key=lambda o: o[2])
    seq = [n[len(REPLAY):] for n, s, _ in sorted(trace.host, key=lambda h: h[1])
           if n.startswith(REPLAY) and lo <= s < hi]
    if not seq:
        return None, "no replay in the window"
    graphs = {}
    for v in sorted(set(seq)):
        lay = lays.get(v)
        if lay is None or lay.get("chain") is not True:
            return None, f"the graph {v} has no layout, or not a chain"
        owners = [p for p, n in lay["runs"] for _ in range(n)]
        if len(owners) != lay["nodes"] or len(lay["types"]) != lay["nodes"]:
            return None, f"the layout of {v} does not cover its nodes"
        nodes = [(p, t) for p, t in zip(owners, lay["types"]) if t in TRACED]
        at = [i for i, (p, _) in enumerate(nodes) if p == "fused"]
        graphs[v] = (nodes, at[0] if len(at) == 1 else None)
    anchors = [i for i, (k, n, _, _) in enumerate(ops) if k == "kernel" and any(f in n for f in fused)]
    held = sum(graphs[v][1] is not None for v in seq)
    if graphs[seq[0]][1] is None or held != len(anchors):
        return None, f"{len(anchors)} fused launches for {held} replays that hold one, the first replay {seq[0]}"
    start, it = [], iter(anchors)
    for v in seq:
        start.append(None if graphs[v][1] is None else next(it) - graphs[v][1])
    gaps = Counter(start[r + 1] - start[r] - len(graphs[seq[r]][0]) for r in range(len(seq) - 1)
                   if start[r] is not None and start[r + 1] is not None)
    x = gaps.most_common(1)[0][0] if gaps else 0
    if x < 0:
        return None, f"replays overlap by {-x} operations"
    why, last = [""] * len(seq), 0
    for r in range(1, len(seq)):
        after = start[r - 1] + len(graphs[seq[r - 1]][0]) + x
        if start[r] is None:
            start[r] = after
        elif start[r] != after:
            for q in range(last, r + 1):
                why[q] = why[q] or "out of step with the replay before it"
        if graphs[seq[r]][1] is not None:
            last = r
    rows = []
    for v, s0, w in zip(seq, start, why):
        nodes = graphs[v][0]
        mine = [] if w else ops[s0 : s0 + len(nodes)]
        if not w and (s0 < 0 or len(mine) < len(nodes)):
            w, mine = "its nodes run past the window's operations", []
        elif any(NODE_TYPE.get(kind) != t and not (kind == "kernel" and t != "K")
                 for (_, t), (kind, _, _, _) in zip(nodes, mine)):
            w, mine = "an operation unlike its node's type", []
        parts = None
        if not w:
            parts = Counter()
            for (p, _), (_, _, s, e) in zip(nodes, mine):
                parts[p] += e - s
        rows.append((v, parts, w, [(s, e) for _, _, s, e in mine]))
    return rows, ""


def align(trace, lays: dict, fused) -> Optional[dict]:
    """{"parts": {part: device ns}, "replays": n, "busy_ns": the replays'
    device busy time} over the window of `trace`, or None unless every
    replay aligns (`replays`)."""
    rows, _ = replays(trace, lays, fused)
    if rows is None or any(p is None for _, p, _, _ in rows):
        return None
    parts = Counter()
    for _, p, _, _ in rows:
        parts.update(p)
    return {"parts": dict(parts), "replays": len(rows),
            "busy_ns": sum(e - s for s, e in union([iv for *_, ivs in rows for iv in ivs]))}


def window_parts(rows: list) -> Tuple[Optional[dict], str]:
    """({part: device ns} over all the window's replays, a note) from the
    replays that align (`replays`' rows): each graph variant's aligned
    replays stand for all of its replays, their mean times its count; where
    every replay of a variant aligns, its exact sum. (None, why) where
    fewer than `MIN_SHARE` of the replays align, or none of some variant."""
    ok = [r for r in rows if r[1] is not None]
    note = f"{len(ok)} of {len(rows)} replays align"
    if len(ok) < MIN_SHARE * len(rows):
        return None, f"{note}, under {MIN_SHARE:.0%}"
    out: Counter = Counter()
    for v in sorted({r[0] for r in rows}):
        n = sum(r[0] == v for r in rows)
        mine = [r[1] for r in ok if r[0] == v]
        if not mine:
            return None, f"{note}, none of {v}"
        total: Counter = Counter()
        for m in mine:
            total.update(m)
        for p, ns in total.items():
            out[p] += ns if len(mine) == n else ns / len(mine) * n
    bad = [(i, r[0], r[2]) for i, r in enumerate(rows) if r[1] is None]
    return dict(out), note + (f"; not: {bad[:4]}" if bad else "")


def aligned(run) -> Tuple[Optional[dict], str]:
    """`window_parts` of the run's trace against the program's layouts, and
    its note, once a trace (the part readers read one run in turn); the note
    goes to the run's notes."""
    t = run.trace
    if t is None or "kernels" not in run.config:
        return None, "no trace"
    if _last[0] is not t:
        lays = layouts()
        rows, why = (None, "the program records no layouts") if not lays else replays(
            t, lays, run.config["kernels"]["fused"])
        got = (None, why) if rows is None else window_parts(rows)
        _last[:] = [t, got]
        run.notes.append(f"parts: {got[1]}")
    return _last[1]


def part_us(run, part: str) -> Optional[float]:
    """Device us a traced encode step of the nodes of `part`, over the
    window's replays (a graph's nodes spread over the steps it serves)."""
    got, _ = aligned(run)
    if got is None or part not in got:
        return None
    return got[part] / 1e3 / run.trace.steps
