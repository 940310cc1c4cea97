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
Every reader here is silent (None) unless every replay of the window
aligns: each layout a chain, every operation of its node's type, the
anchors and the gaps consistent. A program that records no layouts (one
older than them) gives nothing to read.

The port's own bench aligns its trace rows by the same rules
(`gmix_tpu_torch/obs.py` `replay_parts`, a copy: the port does not import
the benchmark); tests/test_torch_obs.py holds the two to the same answers."""
from __future__ import annotations

from collections import Counter
from typing import Optional

from .trace import union

REPLAY = "gmix.replay."
NODE_TYPE = {"kernel": "K", "gpu_memcpy": "C", "gpu_memset": "S"}  # activity type -> the layout's node type
TRACED = "KCS"

_last: list = [None, None]  # the trace aligned last, and what it gave


def layouts() -> Optional[dict]:
    """The program's graph layouts by variant, or None where it keeps none."""
    try:
        from gmix_tpu_torch import obs
    except ImportError:
        return None
    read = getattr(obs, "layouts", None)
    return read() if read is not None else None


def align(trace, lays: dict, fused) -> Optional[dict]:
    """{"parts": {part: device ns}, "replays": n, "busy_ns": the replays'
    device busy time} over the window of `trace` (trace.Trace), or None
    unless every replay aligns (module docstring). `fused`: the fused
    kernel's trace names."""
    lo, hi = trace.window
    ops = sorted((o for o in trace.ops if lo <= o[2] < hi), key=lambda o: o[2])
    seq = [n[len(REPLAY):] for n, s, _ in sorted(trace.host, key=lambda h: h[1])
           if n.startswith(REPLAY) and lo <= s < hi]
    graphs = {}
    for v in set(seq):
        lay = lays.get(v)
        if lay is None or lay.get("chain") is not True:
            return None
        owners = [p for p, n in lay["runs"] for _ in range(n)]
        if len(owners) != lay["nodes"] or len(lay["types"]) != lay["nodes"]:
            return None
        nodes = [(p, t) for p, t in zip(owners, lay["types"]) if t in TRACED]
        at = [i for i, (p, _) in enumerate(nodes) if p == "fused"]
        graphs[v] = (nodes, at[0] if len(at) == 1 else None)
    anchors = [i for i, (k, n, _, _) in enumerate(ops) if k == "kernel" and any(f in n for f in fused)]
    if not seq or graphs[seq[0]][1] is None or sum(graphs[v][1] is not None for v in seq) != len(anchors):
        return None
    start, it = [], iter(anchors)
    for v in seq:
        start.append(None if graphs[v][1] is None else next(it) - graphs[v][1])
    gap = {start[r + 1] - start[r] - len(graphs[seq[r]][0]) for r in range(len(seq) - 1)
           if start[r] is not None and start[r + 1] is not None}
    if len(gap) != 1 or min(gap) < 0:
        return None
    x = gap.pop()
    for r in range(1, len(seq)):
        after = start[r - 1] + len(graphs[seq[r - 1]][0]) + x
        if start[r] is None:
            start[r] = after
        elif start[r] != after:
            return None
    parts, busy = Counter(), []
    for v, s0 in zip(seq, start):
        nodes = graphs[v][0]
        if s0 < 0 or s0 + len(nodes) > len(ops):
            return None
        for (p, t), (kind, _, s, e) in zip(nodes, ops[s0 : s0 + len(nodes)]):
            if NODE_TYPE.get(kind) != t and not (kind == "kernel" and t != "K"):
                return None
            parts[p] += e - s
            busy.append((s, e))
    return {"parts": dict(parts), "replays": len(seq), "busy_ns": sum(e - s for s, e in union(busy))}


def aligned(run) -> Optional[dict]:
    """`align` of the run's trace against the program's layouts, once a
    trace (the part readers read one run in turn)."""
    t = run.trace
    if t is None or "kernels" not in run.config:
        return None
    if _last[0] is not t:
        lays = layouts()
        _last[:] = [t, None if not lays else align(t, lays, run.config["kernels"]["fused"])]
    return _last[1]


def part_us(run, part: str) -> Optional[float]:
    """Device us a traced encode step of the nodes of `part`, over the
    window's replays (a graph's nodes spread over the steps it serves)."""
    got = aligned(run)
    if got is None or part not in got["parts"]:
        return None
    return got["parts"][part] / 1e3 / run.trace.steps
