"""From a torch.profiler trace to what the per-layer readers read: the
traced window, the device's operations as intervals, their union, and the
idle gaps with what the host was doing under them.

The raw events are read from the profiler's results as they came
(`kineto_results.events()`), without the profiler's own post-processing,
which for the ~10^5 kernels of a traced window takes minutes. The device's
busy time is the union of its operations' intervals: kernels that overlap
count once (summing their times can exceed the wall)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

WINDOW = "h100_bench.window"
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME_CHARS = 120

Interval = Tuple[int, int]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of [start, end) intervals as disjoint sorted intervals."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if min(e, hi) > max(s, lo)]


def gaps(busy: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The parts of [lo, hi) that `busy` (disjoint, sorted) leaves free."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


@dataclass
class Trace:
    """A traced window of `steps` byte steps: times in ns on the profiler's
    clock."""

    steps: int
    window: Interval
    ops: List[Tuple[str, str, int, int]]  # (activity type, name, start, end) of the device's operations
    host: List[Tuple[str, int, int]] = field(default_factory=list)  # (name, start, end) of host events

    @property
    def window_ns(self) -> int:
        return self.window[1] - self.window[0]

    def busy(self) -> List[Interval]:
        return union(clip([(s, e) for _, _, s, e in self.ops], *self.window))

    def busy_ns(self) -> int:
        return sum(e - s for s, e in self.busy())

    def kernels(self, parts: Sequence[str] = ()) -> List[Tuple[str, int, int]]:
        """The kernels in the window whose names hold one of `parts` (all
        kernels without `parts`)."""
        lo, hi = self.window
        return [(n, s, e) for kind, n, s, e in self.ops
                if kind == "kernel" and lo <= s < hi and (not parts or any(p in n for p in parts))]

    def top_ops(self) -> List[list]:
        """The device operations with the most time in the window, by name:
        [name, seconds]."""
        by: dict = {}
        for _, n, s, e in self.ops:
            for cs, ce in clip([(s, e)], *self.window):
                by[n] = by.get(n, 0) + ce - cs
        return [[n[:NAME_CHARS], ns / 1e9] for n, ns in sorted(by.items(), key=lambda r: -r[1])[:TOP]]

    def idle_gaps(self) -> List[list]:
        """The longest idle gaps of the device in the window, each named by
        the shortest host event that spans the gap's middle: [name,
        seconds]."""
        longest = sorted(gaps(self.busy(), *self.window), key=lambda g: g[0] - g[1])[:TOP]
        out = []
        for s, e in longest:
            mid = (s + e) // 2
            under = [(he - hs, n) for n, hs, he in self.host if hs <= mid < he and n != WINDOW]
            out.append([min(under)[1][:NAME_CHARS] if under else "(no host event)", (e - s) / 1e9])
        return out


def _kind(ev, on_device: bool) -> str:
    """The event's activity type; a torch without `activity_type` tells
    the device's copies and fills by name."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    if not on_device:
        return "user_annotation" if ev.name() == WINDOW else "cpu_op"
    name = ev.name()
    if name == WINDOW:
        return "gpu_user_annotation"
    return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"


def from_profiler(prof, steps: int) -> Trace:
    """The Trace of a `torch.profiler.profile` whose window ran inside
    `record_function(WINDOW)`."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    window = None
    ops, host = [], []
    for ev in events:
        on_device = ev.device_type() == DeviceType.CUDA
        kind = _kind(ev, on_device)
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if on_device:
            if kind in DEVICE_OPS:
                ops.append((kind, ev.name(), s, e))
        else:
            if ev.name() == WINDOW and kind == "user_annotation":
                window = (s, e)
            host.append((ev.name(), s, e))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    return Trace(steps, window, ops, host)
