"""The part readers align a traced window replay by replay (parts.py), on
synthetic operation lists: a whole window reads what the all-or-nothing
`align` reads, to the last digit; a window whose profiler lost records
reads from the replays that align, each graph's aligned replays standing
for all of its replays, and says which did not and why; a window with too
few aligned replays, or none of some graph, reads nothing and says why."""
import pytest

from h100_bench import parts
from h100_bench.harness import Run
from h100_bench.trace import Trace

FUSED = ["fused_substeps_kernel"]
LAYOUTS = {
    "encode/byte": {"runs": [["contexts", 2], ["inputs", 1], ["fused", 1], ["byte_end", 2]], "nodes": 6,
                    "types": "KCKKKS", "chain": True},
    "encode/wrap": {"runs": [["contexts", 2], ["inputs", 1], ["fused", 1], ["lstm", 1], ["byte_end", 2]],
                    "nodes": 7, "types": "KCKKKKS", "chain": True},
    "bptt": {"runs": [["lstm", 3]], "nodes": 3, "types": "KKK", "chain": True},
}
KIND = {"K": "kernel", "C": "gpu_memcpy", "S": "gpu_memset"}
SEQ = (["encode/byte"] * 19 + ["encode/wrap", "bptt"]) * 2  # 42 replays, 40 byte steps


def window(seq=SEQ, fills=1):
    """Eager operations, then for each replay `fills` fills outside any
    graph and the graph's operations (the k-th of replay r lasting
    10 + k + r % 3 ns), then eager operations; each replay's host span."""
    ops, host, t = [], [], 1000

    def op(kind, name, dur):
        nonlocal t
        ops.append((kind, name, t, t + dur))
        t += dur + 1

    op("gpu_memcpy", "Memcpy DtoD", 5)
    for r, v in enumerate(seq):
        host.append((f"gmix.replay.{v}", 100 * r, 100 * r + 40))
        for _ in range(fills):
            op("kernel", "fill", 2)
        lay = LAYOUTS[v]
        owners = [p for p, n in lay["runs"] for _ in range(n)]
        for k, (owner, ty) in enumerate(zip(owners, lay["types"])):
            op(KIND[ty], "void gmix::fused_substeps_kernel<4>" if owner == "fused" else f"{owner}_op", 10 + k + r % 3)
    op("kernel", "copy_back", 5)
    return Trace(steps=sum(v != "bptt" for v in seq), window=(0, t + 10), ops=ops, host=host)


def replay_ops(r):
    """Indices in `window()`'s operations of replay r's graph operations."""
    at = 1 + r + sum(LAYOUTS[v]["nodes"] for v in SEQ[:r]) + 1  # the eager copy, r replays with their fill, r's fill
    return list(range(at, at + LAYOUTS[SEQ[r]]["nodes"]))


def run_of(trace, monkeypatch):
    monkeypatch.setattr(parts, "layouts", lambda: LAYOUTS)
    return Run({"kernels": {"fused": FUSED}}, {}, 1, 2, 2, [], trace=trace)


def per_replay(trace):
    rows, why = parts.replays(trace, LAYOUTS, FUSED)
    assert why == ""
    return rows


def test_a_whole_window_reads_what_align_reads(monkeypatch):
    trace = window()
    rows = per_replay(trace)
    assert all(p is not None and w == "" for _, p, w, _ in rows)
    whole = parts.align(trace, LAYOUTS, FUSED)
    run = run_of(trace, monkeypatch)
    for p in ("contexts", "inputs", "fused", "lstm", "byte_end"):
        assert parts.part_us(run, p) == whole["parts"][p] / 1e3 / trace.steps  # to the last digit
    assert parts.part_us(run, "ppm") is None
    assert run.notes == ["parts: 42 of 42 replays align"]


def _expected(rows, part):
    """Each variant's aligned replays' mean, times its replays."""
    out = 0.0
    for v in LAYOUTS:
        mine = [p.get(part, 0) for x, p, _, _ in rows if x == v and p is not None]
        out += sum(mine) / len(mine) * sum(x == v for x, *_ in rows)
    return out


def test_the_end_of_the_window_lost(monkeypatch):
    """The last replay (a backward pass) lost its last record and put one
    past the window's end: it alone does not align."""
    trace = window()
    last = replay_ops(len(SEQ) - 1)
    del trace.ops[last[-1]]
    k, n, s, e = trace.ops[last[-2]]
    trace.ops[last[-2]] = (k, n, trace.window[1] + 5, trace.window[1] + 5 + e - s)
    assert parts.align(trace, LAYOUTS, FUSED) is None
    rows = per_replay(trace)
    assert [(i, w) for i, (_, p, w, _) in enumerate(rows) if p is None] == [
        (41, "its nodes run past the window's operations")]
    run = run_of(trace, monkeypatch)
    for p in ("contexts", "lstm", "byte_end"):
        assert parts.part_us(run, p) == pytest.approx(_expected(rows, p) / 1e3 / trace.steps, rel=1e-12)
    whole = parts.align(window(), LAYOUTS, FUSED)["parts"]
    assert parts.part_us(run, "contexts") == whole["contexts"] / 1e3 / trace.steps  # every byte replay aligns
    assert run.notes[0].startswith("parts: 41 of 42 replays align; not: [(41, 'bptt'")


@pytest.mark.parametrize("r,node,failed", [(3, 5, [3, 4]), (4, 1, [3, 4]), (20, 1, [19, 20, 21])],
                         ids=["after-the-anchor", "before-the-anchor", "in-a-backward-pass"])
def test_a_record_lost_mid_window(monkeypatch, r, node, failed):
    """A record lost inside a replay puts the anchors out of step: the
    replays back to the last anchored one do not align; the rest read."""
    trace = window()
    del trace.ops[replay_ops(r)[node]]
    rows = per_replay(trace)
    assert [i for i, (_, p, _, _) in enumerate(rows) if p is None] == failed
    assert {w for _, p, w, _ in rows if p is None} == {"out of step with the replay before it"}
    run = run_of(trace, monkeypatch)
    assert parts.part_us(run, "lstm") == pytest.approx(_expected(rows, "lstm") / 1e3 / trace.steps, rel=1e-12)


def test_an_operation_of_another_type():
    trace = window()
    i = replay_ops(7)[1]  # the inputs' copy node
    k, n, s, e = trace.ops[i]
    trace.ops[i] = ("kernel", n, s, e)  # a copy may show as a kernel: still aligned
    assert all(p is not None for _, p, _, _ in per_replay(trace))
    j = replay_ops(7)[0]
    k, n, s, e = trace.ops[j]
    trace.ops[j] = ("gpu_memset", n, s, e)  # a fill where the layout has a kernel
    rows = per_replay(trace)
    assert [(i, w) for i, (_, p, w, _) in enumerate(rows) if p is None] == [(7, "an operation unlike its node's type")]


def test_too_few_aligned_replays_read_nothing(monkeypatch):
    trace = window()
    for r in (30, 20, 10):  # from the back, so that the indices hold; 2, 3 and 2 replays fail
        del trace.ops[replay_ops(r)[1]]
    run = run_of(trace, monkeypatch)
    assert parts.part_us(run, "contexts") is None
    got, why = parts.aligned(run)
    assert got is None and why.startswith("35 of 42 replays align, under 90%")
    assert run.notes == ["parts: " + why]


def test_no_aligned_replay_of_a_graph_reads_nothing(monkeypatch):
    seq = ["encode/byte"] * 20 + ["encode/wrap", "bptt"]
    trace = window(seq)
    del trace.ops[-2:]  # the window's end lost: the last replay (the one bptt) runs past its operations
    run = run_of(trace, monkeypatch)
    assert parts.part_us(run, "lstm") is None
    assert parts.aligned(run)[1] == "21 of 22 replays align, none of bptt"


@pytest.mark.parametrize("fault,why", [
    ("no-layout", "the graph encode/wrap has no layout, or not a chain"),
    ("no-replay", "no replay in the window"),
    ("lost-anchor", "39 fused launches for 40 replays that hold one, the first replay encode/byte"),
])
def test_a_window_with_nothing_to_align_says_why(fault, why):
    trace, lays = window(), dict(LAYOUTS)
    if fault == "no-layout":
        del lays["encode/wrap"]
    elif fault == "no-replay":
        trace.host = []
    else:
        del trace.ops[replay_ops(5)[3]]
    assert parts.replays(trace, lays, FUSED) == (None, why)
