"""The port's own tracing (gmix_tpu_torch/obs.py) and the benchmark's part
readers (h100_bench/parts.py): nothing recorded while nothing asks, the
parts nested as the code nests under torch.profiler, spans on the
profiler's clock, layouts from a stand-in node counter, and the alignment of
a traced window onto the layouts on synthetic operation lists. The CUDA test
holds the layouts and the launches derived from the replays on the card.

Imports torch, gmix_tpu_torch and h100_bench only (no JAX)."""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import gmix_tpu_torch as gt
from gmix_tpu_torch import cli, obs
from gmix_tpu_torch.core import codec
from gmix_tpu_torch.core import step as t_step
from h100_bench import parts
from h100_bench.harness import Run
from h100_bench.trace import Trace

FUSED = ["fused_substeps_kernel"]


def _corpus(n):
    with open("data/corpus_100k.bin", "rb") as f:
        return f.read(n)


def _compress_cpu(n=16, S=2, chunk=8):
    spec = gt.tiny_spec(True)
    pred = codec.Predictor(spec, S, device="cpu")
    return gt.compress_bytes(_corpus(n), spec, S, chunk, pred=pred)


@pytest.fixture
def obs_off():
    obs.disable()
    yield
    obs.disable()


def test_nothing_is_recorded_while_nothing_asks(monkeypatch, obs_off):
    def refuse(*a, **k):
        raise AssertionError("record_function while no profiler records")

    monkeypatch.setattr(obs, "_Range", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = obs.counters()
    _compress_cpu()
    assert obs.spans() == [] and obs.samples() == []
    assert obs.counters() == before  # the CPU runs no graph and launches no kernel


def _intervals(prof, prefix):
    _, host = obs.profile_events(prof)
    return sorted(((n[len(prefix):], s, e) for n, s, e in host if n.startswith(prefix)), key=lambda r: (r[1], -r[2]))


class _KinetoStub:
    """A raw profiler event of a torch without `activity_type` (the CUDA
    build's)."""

    def __init__(self, name, start, dur, on_device):
        self._v = name, start, dur, on_device

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._v[3] else DeviceType.CPU


def test_device_events_without_an_activity_type_are_told_by_name():
    evs = [_KinetoStub("gmix.replay.encode/byte", 5, 50, True), _KinetoStub("Memset (Device)", 30, 2, True),
           _KinetoStub("memcpy32_post", 20, 3, True), _KinetoStub("Memcpy DtoD (Device -> Device)", 10, 4, True),
           _KinetoStub("gmix.replay.encode/byte", 0, 60, False), _KinetoStub("cudaGraphLaunch", 1, 2, False)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return evs

    ops, host = obs.profile_events(Prof)
    assert ops == [("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 10, 14), ("kernel", "memcpy32_post", 20, 23),
                   ("gpu_memset", "Memset (Device)", 30, 32)]
    assert host == [("gmix.replay.encode/byte", 0, 60), ("cudaGraphLaunch", 1, 3)]


def _parent(ev, evs):
    """The innermost event of `evs` that holds `ev` (None at the top)."""
    name, s, e = ev
    around = [(pe - ps, pn) for pn, ps, pe in evs if (ps, pe, pn) != (s, e, name) and ps <= s and e <= pe]
    return min(around)[1] if around else None


def test_every_part_appears_nested_under_the_profiler(obs_off):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _compress_cpu()
    evs = _intervals(prof, "gmix.part.")
    assert {n for n, _, _ in evs} == set(obs.PARTS)
    allowed = {"contexts": {None}, "fused": {None}, "byte_end": {None}, "inputs": {None, "inputs"},
               "lstm": {None, "lstm", "byte_end"}, "ppm": {"contexts", "lstm", "ppm", "inputs"}}
    pairs = {(n, _parent((n, s, e), evs)) for n, s, e in evs}
    assert all(p in allowed[n] for n, p in pairs), pairs
    # the PPM update inside the boundary contexts, the LSTM's perceive inside the byte end
    assert ("ppm", "contexts") in pairs and ("lstm", "byte_end") in pairs
    spans = _intervals(prof, "gmix.")
    assert {"encode", "readback", "compact"} <= {n for n, _, _ in spans}


def test_a_kept_span_lies_inside_its_profiler_event(obs_off):
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            with obs.span("gmix.test"):
                torch.ones(64).sum()
    kept = [sp for sp in obs.spans() if sp[0] == "gmix.test"]
    _, host = obs.profile_events(prof)
    assert len(kept) == 1
    for name in ("outer", "gmix.test"):
        (_, s, e), = [h for h in host if h[0] == name]
        assert s <= kept[0][1] <= kept[0][2] <= e, (name, s, e, kept)


def test_a_torch_without_the_operator_range_gets_no_range(monkeypatch, obs_off):
    """No `record_function` in its place: the device trace would count
    that range as an operation of its own."""
    monkeypatch.setattr(obs, "_Range", None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.part("contexts"), obs.span("gmix.test"):
            torch.ones(8).sum()
        rec = obs.replays()
    _, host = obs.profile_events(prof)
    assert rec is None and not [n for n, _, _ in host if n.startswith("gmix.")]


class FakeEvent:
    """Stands in for torch.cuda.Event: each record is 1 us after the one
    before it."""

    clock_ms = 0.0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        FakeEvent.clock_ms += 0.001
        self.t = FakeEvent.clock_ms

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


@pytest.mark.parametrize("chunk", [64, 640])
def test_kept_replay_spans_grow_with_the_samples_not_the_bytes(monkeypatch, obs_off, chunk):
    """`enable()` keeps a chunk call's spans and the span of every timed
    replay alone: ten times the bytes a call keep no more than the samples
    they add, where a span a replay would keep ten times as many."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    obs.enable()
    calls = 3
    for _ in range(calls):
        rec = obs.replays()
        with obs.span("gmix.chunk.in"):
            pass
        for _ in range(chunk):
            rec.run("encode/byte", lambda: None)
        rec.close()
    kept = obs.spans()
    replays = [sp for sp in kept if sp[0] == "gmix.replay.encode/byte"]
    assert len([sp for sp in kept if sp[0] == "gmix.chunk.in"]) == calls
    # one in SAMPLE_EVERY, less one a call whose first replay falls due (it has no previous end)
    assert calls * chunk // obs.SAMPLE_EVERY - calls <= len(replays) == len(obs.samples())
    assert 0 < len(replays) <= calls * chunk // obs.SAMPLE_EVERY
    for r in obs.samples():  # the previous end, the start and the end recorded in a row
        assert r["device_step_us"] == pytest.approx(1) and r["device_gap_us"] == pytest.approx(1)


class StubNodes:
    """Stands in for obs.CudaNodes: the test adds the nodes."""

    def __init__(self):
        self.n = 0

    def count(self):
        return self.n

    def close(self):
        return {"types": "K" * self.n, "chain": True}


def test_layout_runs_cover_the_nodes_and_go_to_the_innermost_part():
    nodes = StubNodes()
    with obs.capturing("test/layout", nodes) as record:
        nodes.n += 2
        with obs.part("contexts"):
            nodes.n += 3
            obs.launched("gather_rows_many")
            with obs.part("ppm"):
                nodes.n += 1
                obs.launched("gather_rows")
            with obs.part("ppm"):
                nodes.n += 2
            nodes.n += 2
        with obs.part("fused"):
            pass
        nodes.n += 1
    lay = record.layout
    assert lay["runs"] == [[None, 2], ["contexts", 3], ["ppm", 3], ["contexts", 2], [None, 1]]
    assert sum(n for _, n in lay["runs"]) == lay["nodes"] == 11 == len(lay["types"])
    eager = obs.launches()
    obs.captured(record, 0.5)
    assert obs.layouts()["test/layout"] == lay
    assert obs.launches() == eager  # a capture launches nothing
    record.replays += 3
    after = obs.launches()
    assert after.get("gather_rows_many", 0) == eager.get("gather_rows_many", 0) + 3
    assert after.get("gather_rows", 0) == eager.get("gather_rows", 0) + 3
    assert obs.counters()["captures"]["test/layout"]["seconds"] >= 0.5


def test_a_capture_that_raises_registers_nothing():
    nodes = StubNodes()
    before = obs.counters()
    with pytest.raises(ValueError):
        with obs.capturing("test/raises", nodes):
            obs.launched("fused_substeps")
            raise ValueError("fails")
    assert obs.counters() == before and "test/raises" not in obs.layouts()
    with obs.capturing("test/after", StubNodes()):  # the next capture starts clean
        pass


# ---------------------------------------------------------------------------
# a traced window against the layouts, on synthetic operation lists
# ---------------------------------------------------------------------------

BYTE = {"runs": [["contexts", 2], ["inputs", 1], ["fused", 1], ["byte_end", 2]], "nodes": 6, "types": "KCKKKS",
        "chain": True}
WRAP = {"runs": [["contexts", 2], ["inputs", 1], ["fused", 1], ["lstm", 1], ["byte_end", 2]], "nodes": 7,
        "types": "KCKKKKS", "chain": True}
BPTT = {"runs": [["lstm", 3]], "nodes": 3, "types": "KKK", "chain": True}
LAYOUTS = {"encode/byte": BYTE, "encode/wrap": WRAP, "bptt": BPTT}
KIND = {"K": "kernel", "C": "gpu_memcpy", "S": "gpu_memset"}


def _window(seq, fills=2, before=3, after=2):
    """A traced window: eager operations, then for each replay `fills`
    fills outside any graph and the graph's operations (the k-th of a
    replay lasting 10 + k ns), then eager operations; the replays' host
    spans each hold one cudaGraphLaunch."""
    ops, host, t = [], [], 1000

    def op(kind, name, dur):
        nonlocal t
        ops.append((kind, name, t, t + dur))
        t += dur + 1

    for _ in range(before):
        op("gpu_memcpy", "Memcpy DtoD", 5)
    for r, v in enumerate(seq):
        host.append((f"gmix.replay.{v}", 100 * r, 100 * r + 40))
        host.append(("cudaGraphLaunch", 100 * r + 10, 100 * r + 30))
        for _ in range(fills):
            op("kernel", "fill", 2)
        lay = LAYOUTS[v]
        owners = [p for p, n in lay["runs"] for _ in range(n)]
        for k, (owner, ty) in enumerate(zip(owners, lay["types"])):
            op(KIND[ty], "void gmix::fused_substeps_kernel<4>" if owner == "fused" else f"{owner}_op", 10 + k)
    for _ in range(after):
        op("kernel", "copy_back", 5)
    return Trace(steps=sum(v != "bptt" for v in seq), window=(0, t + 10), ops=ops, host=host)


SEQ = ["encode/byte", "encode/byte", "encode/wrap", "bptt", "encode/byte", "encode/wrap", "bptt"]


def _want(seq):
    out = {}
    for v in seq:
        lay = LAYOUTS[v]
        owners = [p for p, n in lay["runs"] for _ in range(n)]
        for k, owner in enumerate(owners):
            out[owner] = out.get(owner, 0) + 10 + k
    return out


def _align(which, trace, lays):
    if which == "bench":
        return parts.align(trace, lays, FUSED)
    lo, hi = trace.window
    return obs.replay_parts([o for o in trace.ops if lo <= o[2] < hi], trace.host, lays, tuple(FUSED))


@pytest.mark.parametrize("which", ["bench", "port"])
@pytest.mark.parametrize("fills,copies", [(0, "gpu_memcpy"), (2, "gpu_memcpy"), (1, "kernel")])
def test_replays_align_onto_their_layouts(which, fills, copies):
    """`copies`: how a copy node shows in the trace (CUDA runs some as
    a kernel, `memcpy32_post`)."""
    trace = _window(SEQ, fills=fills)
    trace.ops = [(copies, "memcpy32_post", s, e) if k == "gpu_memcpy" else (k, n, s, e) for k, n, s, e in trace.ops]
    got = _align(which, trace, LAYOUTS)
    assert got is not None and got["parts"] == _want(SEQ) and got["replays"] == len(SEQ)
    assert got["busy_ns"] == sum(_want(SEQ).values())


@pytest.mark.parametrize("which", ["bench", "port"])
@pytest.mark.parametrize("fault", ["dropped", "extra", "not-a-chain", "wrong-type", "no-layout", "fills-differ"])
def test_a_window_that_does_not_align_reads_nothing(which, fault):
    trace, lays = _window(SEQ), dict(LAYOUTS)
    if fault == "dropped":
        i = next(i for i, o in enumerate(trace.ops) if o[1] == "byte_end_op")
        del trace.ops[i]
    elif fault == "extra":
        i = next(i for i, o in enumerate(trace.ops) if o[1] == "lstm_op")
        s = trace.ops[i][2]
        trace.ops.insert(i, ("kernel", "stray", s - 1, s))
    elif fault == "not-a-chain":
        lays["bptt"] = {**BPTT, "chain": False}
    elif fault == "wrong-type":  # a copy where the layout has a kernel node
        lays["encode/byte"] = {**BYTE, "types": "KKKKKS"}
    elif fault == "no-layout":
        del lays["encode/wrap"]
    elif fault == "fills-differ":
        fills = [i for i, o in enumerate(trace.ops) if o[1] == "fill"]
        del trace.ops[fills[2]]  # one of the two before the second replay
    assert _align(which, trace, lays) is None


@pytest.mark.parametrize("dropped", ["byte_end_op", "lstm_op", "fill"])
def test_a_dropped_record_reads_as_the_benchmark_reads_it(dropped):
    """One record lost from the middle of a window of 42 replays: the
    replays out of step fail, the others align, and each graph's aligned
    replays stand for all of its replays; the port's reader gives the
    benchmark's answer (h100_bench/parts.py `replays`, `window_parts`)."""
    seq = SEQ * 6
    trace = _window(seq)
    at = [i for i, o in enumerate(trace.ops) if o[1] == dropped]
    del trace.ops[at[len(at) // 2]]
    rows, why = parts.replays(trace, LAYOUTS, FUSED)
    want, note = parts.window_parts(rows)
    assert want is not None, (why, note)
    lo, hi = trace.window
    got = obs.replay_parts([o for o in trace.ops if lo <= o[2] < hi], trace.host, LAYOUTS, tuple(FUSED))
    assert got is not None and got["parts"] == want
    aligned = sum(r[1] is not None for r in rows)
    assert got["replays"] == len(seq) and got["aligned"] == aligned and aligned < len(seq)
    # every part within the replays' spread of its exact value
    exact = _want(seq)
    assert sorted(got["parts"]) == sorted(exact)
    for p, ns in exact.items():
        assert got["parts"][p] == pytest.approx(ns, rel=0.02)


def test_the_part_readers_read_the_run(monkeypatch):
    trace = _window(SEQ)
    monkeypatch.setattr(parts, "layouts", lambda: LAYOUTS)
    run = Run({"kernels": {"fused": FUSED}}, {}, 1, 2, 2, [], trace=trace)
    want = _want(SEQ)
    for p in ("contexts", "lstm", "inputs", "byte_end"):
        assert parts.part_us(run, p) == pytest.approx(want[p] / 1e3 / trace.steps)
    assert parts.part_us(run, "ppm") is None  # no node of the part in these layouts


def test_the_part_readers_are_silent_without_layouts(monkeypatch):
    monkeypatch.setattr(parts, "layouts", lambda: None)
    run = Run({"kernels": {"fused": FUSED}}, {}, 1, 2, 2, [], trace=_window(SEQ))
    assert parts.part_us(run, "lstm") is None


def test_the_command_line_writes_its_trace(tmp_path, obs_off):
    src, out, trace = tmp_path / "in.txt", tmp_path / "out.gxtc", tmp_path / "obs.json"
    src.write_bytes(_corpus(40))
    assert cli.main(["--device", "cpu", "--profile", "tiny", "--streams", "2", "--chunk", "20", "--obs", str(trace),
                     "compress", str(src), str(out)]) == 0
    got = json.loads(trace.read_text())
    names = {e["name"] for e in got["traceEvents"] if e["ph"] == "X"}
    assert {"gmix.encode", "gmix.readback", "gmix.compact"} <= names
    assert set(got["otherData"]["counters"]) == {"replays", "captures", "launches", "refills", "recaptures"}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_layouts_and_derived_launches_on_the_card(cuda):
    """Every graph's layout is a chain whose runs cover its nodes with the
    step's parts alone (one fused kernel node in a byte graph); the launches
    derived from the replays equal the eager wrappers' count of the same
    bytes (3 gathers, 2 scatters and 1 fused kernel a byte step at the
    reference wiring)."""
    spec = gt.scale_tables(gt.reference_spec(), 12, history_bits=16)
    data = _corpus(400)
    counts = {}
    for how in ("graphs", "eager"):
        mp = pytest.MonkeyPatch()
        if how == "eager":
            mp.setattr(t_step.ChunkFn, "__call__", t_step.ChunkFn._eager)
        try:
            pred = codec.Predictor(spec, 2, device=cuda)
            before = obs.launches()
            gt.compress_bytes(data, spec, 2, 100, pred=pred)
            now = obs.launches()
            counts[how] = {k: now.get(k, 0) - before.get(k, 0) for k in set(now) | set(before)}
        finally:
            mp.undo()
    per, n = 200, counts["graphs"]
    assert n == counts["eager"]
    assert (n.get("gather_rows", 0) + n.get("gather_rows_many", 0), n.get("scatter_rows", 0)
            + n.get("scatter_rows_many", 0), n.get("fused_substeps", 0)) == (3 * per, 2 * per, per)
    lays = obs.layouts()
    assert {"encode/byte", "encode/wrap", "bptt"} <= set(lays)
    for v in ("encode/byte", "encode/wrap", "bptt"):
        lay = lays[v]
        assert lay["chain"] is True and sum(n for _, n in lay["runs"]) == lay["nodes"] == len(lay["types"])
        assert {p for p, _ in lay["runs"]} <= set(obs.PARTS), lay["runs"]
        owners = [p for p, n in lay["runs"] for _ in range(n)]
        fused = [t for p, t in zip(owners, lay["types"]) if p == "fused"]
        assert fused == (["K"] if v != "bptt" else [])
