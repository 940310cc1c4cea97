"""The port's own tracing: the named parts of the byte step and the layout of
every captured CUDA graph, host spans on the profiler's clock, sampled device
times of the replays, and the counters of the codec's chunk loop.

Parts. The byte step's sections run inside `part(name)` (`PARTS`), nested
where the code nests. On a CUDA device the step is a CUDA graph, and at a
replay no Python of the step runs, so only the capture knows which node came
from which part: while a stream is captured, `part` reads the capturing
graph's node count from libcuda on entry and on exit, and every node
goes to the innermost open part. The capture's result is its layout
(`layouts()`): the ordered runs `[part, nodes]`, the node count, each node's
type (`types`: K kernel, C copy, S fill, O any other) and whether the nodes
form a chain in their order (each node depends on the one before it alone),
so that a trace's device operations of one replay map onto the nodes one for
one. Nothing of this runs at a replay. On the eager path `part` is a
profiler range `gmix.part.<name>` while a torch.profiler records, and
nothing otherwise.

Spans. While a torch.profiler records, the codec's loop emits host ranges
(`span`; an operator's range, which the profiler does not draw again on the
device's timeline; a torch without it gets no range, not one the device
trace would count as an operation): `gmix.replay.<variant>` around each graph
replay, `gmix.chunk.in` / `gmix.chunk.out` around what a chunk call copies
in and out, `gmix.readback`, `gmix.compact`, `gmix.encode` / `gmix.decode`
and `gmix.reset`. A chunk call asks once whether anything records
(`replays`), never once a replay. `enable()` also keeps the spans in memory,
stamped with `time.time_ns()` (Unix ns, the clock of the profiler's events),
and times every `SAMPLE_EVERY`-th replay with CUDA events: the previous
replay's end, this replay's start and its end give `device_step_us` and
`device_gap_us` (the device's idle time before the replay), without the
profiler. Of the replays' spans it keeps only those of the timed replays, so
what it holds grows with the chunk calls and the samples, not with every
byte. `dump(path)` writes both as one Chrome-trace JSON.

Counters (`counters()`, always on): replays by graph variant, captures by
variant with their seconds, refills of state leaves in a chunk call's bind
with the bytes they copy, decode recaptures when the code buffer grows, and
the hand-written kernels' launches (`launches()`). A launch made while a
graph is captured is recorded with that graph; a replay adds one to its
graph's replay count and nothing else, so a kernel's launches are the eager
ones plus, over every graph, its replays times its launches.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import os
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

# A host range of the profiler's trace: an operator's range, which the
# profiler does not draw again on the device's timeline. A `record_function`
# range is drawn there, as an operation of its own that a device trace counts
# as a kernel, so a torch without the operator's range gets no range at all.
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None)

PARTS = ("contexts", "ppm", "lstm", "inputs", "fused", "byte_end")
SAMPLE_EVERY = 64
# CUgraphNodeType -> one letter of a layout's `types`
NODE_TYPES = {0: "K", 1: "C", 2: "S"}
TRACED = "KCS"  # the node types that a device trace shows, one operation each
# the least share of a traced window's replays that must align for its parts
# to read (`replay_parts`; h100_bench/parts.py MIN_SHARE)
MIN_SHARE = 0.9

_NULL = contextlib.nullcontext()


@dataclass
class GraphRecord:
    """One captured graph: its variant, the hand-written launches it holds,
    its layout, the capture's seconds and its replays so far."""

    variant: str
    launches: Counter = field(default_factory=Counter)
    layout: Optional[dict] = None
    capture_s: float = 0.0
    replays: int = 0


class _State:
    """What the process has recorded."""

    def __init__(self):
        self.enabled = False
        self.capture: Optional[_Capture] = None
        self.records: List[GraphRecord] = []
        self.last: Dict[str, dict] = {}  # variant -> the layout of its last capture
        self.eager = Counter()  # hand-written launches outside any capture
        self.refills = [0, 0]  # leaves copied in at a bind, their bytes
        self.recaptures = 0
        self.spans: List[Tuple[str, int, int]] = []
        self.samples: List[Tuple[int, str, float, float]] = []  # (ns, variant, step us, gap us)
        self.pending: List[tuple] = []  # timed replays whose events have not been read
        self.seen = 0  # replays since enable(), for the sampling
        self.due = SAMPLE_EVERY  # the replay count at which the next one is to be timed


_st = _State()


# ---------------------------------------------------------------------------
# parts and graph layouts
# ---------------------------------------------------------------------------


class _GraphApi:
    """libcuda's graph queries through ctypes (the library torch has
    loaded): a capturing stream's graph, its nodes, their types and
    edges."""

    def __init__(self):
        lib = ctypes.CDLL("libcuda.so.1")
        vp, sz = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
        self.fns = {}
        for name, args in (
            ("cuStreamGetCaptureInfo_v2", (vp, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint64),
                                           ctypes.POINTER(vp), ctypes.POINTER(vp), sz)),
            ("cuGraphGetNodes", (vp, ctypes.POINTER(vp), sz)),
            ("cuGraphGetEdges", (vp, ctypes.POINTER(vp), ctypes.POINTER(vp), sz)),
            ("cuGraphNodeGetType", (vp, ctypes.POINTER(ctypes.c_int))),
        ):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
            self.fns[name] = fn

    def call(self, name: str, *args) -> None:
        rc = self.fns[name](*args)
        if rc:
            raise RuntimeError(f"{name} returned CUresult {rc}")

    def graph(self, stream: int) -> ctypes.c_void_p:
        status, graph = ctypes.c_int(0), ctypes.c_void_p()
        self.call("cuStreamGetCaptureInfo_v2", ctypes.c_void_p(stream), ctypes.byref(status), None,
                  ctypes.byref(graph), None, None)
        if status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
            raise RuntimeError(f"stream {stream:#x} is not capturing (status {status.value})")
        return graph

    def nodes(self, graph) -> list:
        n = ctypes.c_size_t(0)
        self.call("cuGraphGetNodes", graph, None, ctypes.byref(n))
        arr = (ctypes.c_void_p * n.value)()
        self.call("cuGraphGetNodes", graph, arr, ctypes.byref(n))
        return list(arr[: n.value])


_api: Optional[_GraphApi] = None


def _get_api() -> _GraphApi:
    global _api
    if _api is None:
        _api = _GraphApi()
    return _api


class CudaNodes:
    """The nodes of the graph that the CUDA stream `stream` (a handle) is
    capturing into: `count()` while it captures, and `close()`, at the
    capture's end, each node's type and whether the nodes form a chain in
    their order."""

    def __init__(self, stream: int):
        self.stream = stream
        self.api = _get_api()

    def count(self) -> int:
        n = ctypes.c_size_t(0)
        self.api.call("cuGraphGetNodes", self.api.graph(self.stream), None, ctypes.byref(n))
        return n.value

    def close(self) -> dict:
        api = self.api
        graph = api.graph(self.stream)
        nodes = api.nodes(graph)
        kind = ctypes.c_int(0)
        types = []
        for node in nodes:
            api.call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
            types.append(NODE_TYPES.get(kind.value, "O"))
        m = ctypes.c_size_t(0)
        api.call("cuGraphGetEdges", graph, None, None, ctypes.byref(m))
        src, dst = (ctypes.c_void_p * m.value)(), (ctypes.c_void_p * m.value)()
        api.call("cuGraphGetEdges", graph, src, dst, ctypes.byref(m))
        at = {node: i for i, node in enumerate(nodes)}
        chain = m.value == max(len(nodes) - 1, 0) and all(at[b] == at[a] + 1 for a, b in zip(src, dst))
        return {"types": "".join(types), "chain": chain}


class _Capture:
    """The layout of one graph while it is captured: `nodes` counts the
    graph's nodes (`CudaNodes`, or a stand-in); each mark gives the nodes
    made since the last one to the innermost open part."""

    def __init__(self, variant: str, nodes):
        self.record = GraphRecord(variant)
        self.nodes = nodes
        self.stack: List[str] = []
        self.runs: List[list] = []
        self.at = nodes.count()

    def mark(self) -> None:
        n = self.nodes.count()
        if n > self.at:
            owner = self.stack[-1] if self.stack else None
            if self.runs and self.runs[-1][0] == owner:
                self.runs[-1][1] += n - self.at
            else:
                self.runs.append([owner, n - self.at])
        self.at = n

    @contextlib.contextmanager
    def part(self, name: str):
        self.mark()
        self.stack.append(name)
        try:
            yield
        finally:
            self.mark()
            self.stack.pop()

    def close(self) -> dict:
        self.mark()
        return {"runs": self.runs, "nodes": self.at, **self.nodes.close()}


def part(name: str):
    """The context of one part of the byte step (`PARTS`)."""
    cap = _st.capture
    if cap is not None:
        return cap.part(name)
    if _profiling():
        return _Range("gmix.part." + name)
    return _NULL


def in_part(name: str):
    """A decorator: the function runs in part `name` (`part`)."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with part(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


@contextlib.contextmanager
def capturing(variant: str, nodes):
    """Record the layout and the launches of the graph that the body of this
    context captures (`nodes`: its node counter, `CudaNodes`).
    Yields the graph's record, which `captured` registers once the capture
    has ended well; a capture that raises registers nothing."""
    if _st.capture is not None:
        raise RuntimeError("a graph capture inside another one")
    cap = _st.capture = _Capture(variant, nodes)
    try:
        yield cap.record
        cap.record.layout = cap.close()
    finally:
        _st.capture = None


def captured(record: GraphRecord, seconds: float) -> None:
    """Register a graph whose capture has ended."""
    record.capture_s = seconds
    _st.records.append(record)
    _st.last[record.variant] = record.layout


def launched(kernel: str) -> None:
    """One launch of a hand-written kernel (its wrapper's name): kept with
    the graph being captured, or counted as an eager launch."""
    if _st.capture is not None:
        _st.capture.record.launches[kernel] += 1
    else:
        _st.eager[kernel] += 1


def layouts() -> Dict[str, dict]:
    """The layouts of the graphs captured last, by variant
    (`encode/byte`, `encode/wrap`, `bptt`, ...), as plain data."""
    return json.loads(json.dumps(_st.last))


# ---------------------------------------------------------------------------
# spans and sampled replays
# ---------------------------------------------------------------------------


def _profiling() -> bool:
    """Whether a torch.profiler records and the port can put a range in its
    trace."""
    return _Range is not None and torch.autograd._profiler_enabled()


class _Span:
    """A profiler range while `prof`, a span kept in memory while `keep`."""

    __slots__ = ("name", "rf", "keep", "t0")

    def __init__(self, name: str, prof: bool, keep: bool):
        self.name = name
        self.rf = _Range(name) if prof else None
        self.keep = keep
        self.t0 = None

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        if self.keep:
            self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.t0 is not None:
            _st.spans.append((self.name, self.t0, time.time_ns()))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A span of the port's host work: a profiler range while a
    torch.profiler records, kept in memory while `enable()`d, nothing
    otherwise."""
    prof = _profiling()
    if not (prof or _st.enabled):
        return _NULL
    return _Span(name, prof, _st.enabled)


class Replays:
    """A chunk call's replays while something records: each in its
    `gmix.replay.<variant>` profiler range while a profiler records; while
    `enable()`d, every `SAMPLE_EVERY`-th timed with CUDA events and its span
    kept (the others keep none). A call's first replay has no previous end
    in the call: where it is due, the one after it is timed."""

    def __init__(self, prof: bool):
        self.prof = prof
        self.prev_end = None  # the event after this call's last replay, when the next one is timed

    def run(self, variant: str, replay: Callable[[], None]) -> None:
        timed = self.prev_end is not None
        with _Span("gmix.replay." + variant, self.prof, timed):
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            replay()
            if timed:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                _st.pending.append((time.time_ns(), variant, self.prev_end, start, end))
        self.prev_end = None
        if _st.enabled:
            _st.seen += 1
            if timed:
                _st.due = _st.seen + SAMPLE_EVERY - 1
            if _st.seen >= _st.due:
                self.prev_end = torch.cuda.Event(enable_timing=True)
                self.prev_end.record()

    def close(self) -> None:
        """At the call's end: read the timed replays that have finished."""
        _resolve(block=False)


def replays() -> Optional[Replays]:
    """What a chunk call does around its replays: None unless a
    torch.profiler records or `enable()` is on (asked once a call)."""
    prof = _profiling()
    return Replays(prof) if prof or _st.enabled else None


def _resolve(block: bool) -> None:
    left = []
    for ns, variant, prev_end, start, end in _st.pending:
        if block:
            end.synchronize()
        elif not end.query():
            left.append((ns, variant, prev_end, start, end))
            continue
        _st.samples.append((ns, variant, 1e3 * start.elapsed_time(end), 1e3 * prev_end.elapsed_time(start)))
    _st.pending = left


def enable() -> None:
    """Keep spans in memory and sample the replays' device times, from now
    on (what an earlier `enable()` kept is dropped)."""
    _st.enabled = True
    _st.spans, _st.samples, _st.pending, _st.seen, _st.due = [], [], [], 0, SAMPLE_EVERY


def disable() -> None:
    _resolve(block=True)
    _st.enabled = False


def spans() -> List[Tuple[str, int, int]]:
    """The spans kept since `enable()`: (name, start ns, end ns), Unix ns."""
    return list(_st.spans)


def samples() -> List[dict]:
    """The timed replays since `enable()`: when (Unix ns), the variant,
    `device_step_us` and `device_gap_us`."""
    _resolve(block=True)
    return [{"t_ns": ns, "variant": v, "device_step_us": s, "device_gap_us": g} for ns, v, s, g in _st.samples]


# ---------------------------------------------------------------------------
# a profiler's trace against the layouts
# ---------------------------------------------------------------------------

# The alignment below is `h100_bench/parts.py`'s `replays` and
# `window_parts`, rule for rule (the port does not import the benchmark,
# which is frozen with its metrics): a change to one rule is made in both,
# and tests/test_torch_obs.py holds the two to the same answers.
REPLAY = "gmix.replay."
DEVICE_OPS = {"kernel": "K", "gpu_memcpy": "C", "gpu_memset": "S"}  # activity type -> node type

Op = Tuple[str, str, int, int]  # (activity type, name, start ns, end ns)
Event = Tuple[str, int, int]  # (name, start ns, end ns)


def profile_events(prof) -> Tuple[List[Op], List[Event]]:
    """The device's operations (kernels, copies, fills) sorted by start, and
    the host's events, of a finished `torch.profiler.profile`, read from its
    raw results (the profiler's own post-processing of ~10^5 kernels takes
    minutes)."""
    from torch.autograd import DeviceType

    ops, host = [], []
    for ev in prof.profiler.kineto_results.events():
        name, s = ev.name(), ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            kind = _device_kind(ev, name)
            if kind in DEVICE_OPS:
                ops.append((kind, name, s, e))
        else:
            host.append((name, s, e))
    ops.sort(key=lambda o: o[2])
    return ops, host


def _device_kind(ev, name: str) -> str:
    """A device event's activity type. The torch of the CUDA build (2.11)
    has no `activity_type` on its events: there the name tells the port's
    ranges, copies and fills from kernels (`h100_bench/trace.py` `_kind`
    does the same)."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    if name.startswith("gmix."):
        return "gpu_user_annotation"
    return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"


def union_ns(intervals) -> int:
    """The length of the union of [start, end) intervals."""
    total, at = 0, None
    for s, e in sorted(intervals):
        if at is None or s > at:
            total += e - s
            at = e
        elif e > at:
            total += e - at
            at = e
    return total


def _replay_rows(ops: List[Op], host: List[Event], lays: Dict[str, dict],
                 fused: Tuple[str, ...]) -> Optional[List[tuple]]:
    """The window's replays in order, each aligned on its own: [(variant,
    {part: device ns} or None where it does not align, [(start, end) of its
    operations]), ...], or None where the window gives nothing to align
    (`replay_parts`)."""
    seq = [n[len(REPLAY):] for n, s, _ in sorted(host, key=lambda h: h[1]) if n.startswith(REPLAY)]
    if not seq:
        return None
    graphs = {}
    for v in sorted(set(seq)):
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
    if graphs[seq[0]][1] is None or sum(graphs[v][1] is not None for v in seq) != len(anchors):
        return None
    start, it = [], iter(anchors)
    for v in seq:
        start.append(None if graphs[v][1] is None else next(it) - graphs[v][1])
    gaps = Counter(start[r + 1] - start[r] - len(graphs[seq[r]][0]) for r in range(len(seq) - 1)
                   if start[r] is not None and start[r + 1] is not None)
    x = gaps.most_common(1)[0][0] if gaps else 0
    if x < 0:
        return None
    bad, last = [False] * len(seq), 0
    for r in range(1, len(seq)):
        after = start[r - 1] + len(graphs[seq[r - 1]][0]) + x
        if start[r] is None:
            start[r] = after
        elif start[r] != after:
            # out of step with the replay before it: every replay back to
            # the last anchored one
            for q in range(last, r + 1):
                bad[q] = True
        if graphs[seq[r]][1] is not None:
            last = r
    rows = []
    for v, s0, b in zip(seq, start, bad):
        nodes = graphs[v][0]
        mine = [] if b else ops[s0 : s0 + len(nodes)]
        if not b and (s0 < 0 or len(mine) < len(nodes)):
            b, mine = True, []
        elif any(DEVICE_OPS.get(kind) != t and not (kind == "kernel" and t != "K")
                 for (_, t), (kind, _, _, _) in zip(nodes, mine)):
            b, mine = True, []
        parts = None
        if not b:
            parts = Counter()
            for (p, _), (_, _, s, e) in zip(nodes, mine):
                parts[p] += e - s
        rows.append((v, parts, [(s, e) for _, _, s, e in mine]))
    return rows


def replay_parts(ops: List[Op], host: List[Event], lays: Dict[str, dict], fused: Tuple[str, ...]) -> Optional[dict]:
    """Each part's device ns over the graph replays of a traced window:
    `ops` the device's operations by start, `host` the host's events (the
    replays' order from their `gmix.replay.<variant>` spans), `lays` the
    graphs' layouts, `fused` the fused kernel's trace names. A replay of a
    graph with the fused kernel is anchored on its launch of it, at the
    layout's index for it; a graph without it (the backward pass) follows
    the replay before it. Between two replays the host may launch the same
    number of operations outside any graph (the profiler shows torch's
    per-replay fills, where it makes them): the count most pairs of
    anchored neighbours show. Each replay aligns on its own: placed where
    the replay before it ends, every operation of its node's type (a copy
    or fill node may show as a kernel: CUDA runs some copies as
    `memcpy32_post`), all of its nodes inside the window; a replay out of
    step with the one before it (a record the profiler lost or added) fails
    with every replay back to the last anchored one. Each graph's aligned
    replays stand for all of its replays (their mean times its count; the
    exact sum where all align). None where a graph in the window has no
    layout or is not a chain, where the fused launches do not match the
    replays that hold one, where fewer than MIN_SHARE of the replays align,
    or none of some graph.
    Returns {"parts": {part: ns}, "replays": n, "aligned": the replays that
    align, "busy_ns": the replays' device busy time}."""
    rows = _replay_rows(ops, host, lays, fused)
    if rows is None:
        return None
    ok = [r for r in rows if r[1] is not None]
    if len(ok) < MIN_SHARE * len(rows):
        return None
    parts: Counter = Counter()
    busy = 0
    for v in sorted({r[0] for r in rows}):
        n = sum(r[0] == v for r in rows)
        mine = [r for r in ok if r[0] == v]
        if not mine:
            return None
        total: Counter = Counter()
        for m in mine:
            total.update(m[1])
        for p, ns in total.items():
            parts[p] += ns if len(mine) == n else ns / len(mine) * n
        b = sum(union_ns(r[2]) for r in mine)
        busy += b if len(mine) == n else b / len(mine) * n
    return {"parts": dict(parts), "replays": len(rows), "aligned": len(ok), "busy_ns": busy}


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------


def refilled(nbytes: int) -> None:
    """A state leaf copied into the one the graphs hold, at a bind."""
    _st.refills[0] += 1
    _st.refills[1] += nbytes


def recaptured() -> None:
    """The decode graphs dropped to be captured again (a wider code
    buffer)."""
    _st.recaptures += 1


def launches() -> Dict[str, int]:
    """Each hand-written kernel's launches in this process: the eager ones
    plus, over every graph captured, its replays times its launches."""
    out = Counter(_st.eager)
    for r in _st.records:
        for kernel, n in r.launches.items():
            out[kernel] += n * r.replays
    return {k: n for k, n in out.items() if n}


def counters() -> dict:
    """Every counter, as plain data."""
    replayed, captures = Counter(), {}
    for r in _st.records:
        replayed[r.variant] += r.replays
        c = captures.setdefault(r.variant, {"count": 0, "seconds": 0.0})
        c["count"] += 1
        c["seconds"] += r.capture_s
    return {"replays": dict(replayed), "captures": captures, "launches": launches(),
            "refills": {"count": _st.refills[0], "bytes": _st.refills[1]}, "recaptures": _st.recaptures}


def dump(path: str) -> None:
    """The spans and timed replays kept since `enable()` and every counter
    and layout, as one Chrome-trace JSON file (times in us on the Unix
    clock)."""
    pid = os.getpid()
    events = [{"name": n, "ph": "X", "ts": s / 1e3, "dur": (e - s) / 1e3, "pid": pid, "tid": 0}
              for n, s, e in _st.spans]
    events += [{"name": "device_us", "ph": "C", "ts": r["t_ns"] / 1e3, "pid": pid,
                "args": {"device_step_us": r["device_step_us"], "device_gap_us": r["device_gap_us"]}}
               for r in samples()]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"counters": counters(), "layouts": layouts()}}, f)
