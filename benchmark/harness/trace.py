"""A profiler trace of a short stretch of the window, and what is read from it.

``traced(run)`` runs ``run()`` under ``torch.profiler`` (host and CUDA
activity) inside a marked range and reads the profiler's own events, the
device's and the host's, without writing a trace file. The traced window is
the marked range, its own start to its own end: idle time at its edges
counts.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

WINDOW_MARK = "benchmark.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of closed intervals as a sorted list of disjoint ones."""
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def clip(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def covered(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in union(intervals))


def gaps(busy: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no interval of ``busy`` (disjoint,
    sorted) covers."""
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out


class Trace:
    """Device and host events of a trace, in microseconds on one clock."""

    def __init__(self, events: Sequence[dict]):
        marks = [e for e in events if e.get("name") == WINDOW_MARK and e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]
        if not marks:
            raise RuntimeError(f"the trace holds no {WINDOW_MARK} range")
        mark = marks[0]
        self.start, self.end = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
        self.device: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            start = float(e["ts"])
            end = start + float(e["dur"])
            if e.get("cat") in DEVICE_CATS:
                self.device.append((e["name"], start, end))
            elif e.get("cat") in HOST_CATS and e["name"] != WINDOW_MARK:
                self.host.append((e["name"], start, end))

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_intervals(self) -> List[Interval]:
        return union(clip(((a, b) for _, a, b in self.device), self.start, self.end))

    @property
    def busy_s(self) -> float:
        return covered(self.busy_intervals()) * 1e-6

    def kernel_seconds(self, names: Sequence[str]) -> Tuple[float, int]:
        """Device time (union, inside the window) and launch count of the
        kernels whose name contains one of ``names``."""
        hits = [(a, b) for n, a, b in self.device if any(k in n for k in names)]
        inside = clip(hits, self.start, self.end)
        return covered(inside) * 1e-6, len(inside)

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took most time, summed by name."""
        total: dict = {}
        for name, a, b in self.device:
            lo, hi = max(a, self.start), min(b, self.end)
            if hi > lo:
                total[name] = total.get(name, 0.0) + (hi - lo) * 1e-6
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[_short(n), s] for n, s in ranked]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle device time summed by what the host was doing: each gap is
        named after the innermost host event over its middle."""
        total: dict = {}
        for a, b in gaps(self.busy_intervals(), self.start, self.end):
            mid = 0.5 * (a + b)
            over = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            name = min(over)[1] if over else "no host event"
            total[name] = total.get(name, 0.0) + (b - a) * 1e-6
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[_short(n), s] for n, s in ranked]


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[: limit - 3] + "..."


class Recording:
    """A profiled stretch, read into a ``Trace`` only when asked: reading
    takes the interpreter for a while, so the drivers read it after the
    window has closed. ``stop_s``, ``read_s``: how long the profiler took to
    stop and the reading took."""

    def __init__(self, prof, stop_s: float):
        self._prof, self.stop_s = prof, stop_s
        self.read_s = None

    def read(self) -> Trace:
        t = time.perf_counter()
        raw = [_event(e) for e in self._prof.profiler.kineto_results.events()]
        # the device's copy of a host range (a ``gpu_user_annotation``) is no
        # device work: where the events carry no category, drop it by name
        ranges = {name for cat, name, _, _ in raw if cat == "user_annotation"}
        keep = set(HOST_CATS) | set(DEVICE_CATS)
        base = min((start for _, _, start, _ in raw), default=0)
        events = [{"ph": "X", "cat": cat, "name": name, "ts": (start - base) * 1e-3,
                   "dur": dur * 1e-3}
                  for cat, name, start, dur in raw
                  if cat in keep and not (cat == _DEVICE and name in ranges)]
        trace = Trace(events)
        self.read_s = time.perf_counter() - t
        return trace


_DEVICE = "kernel"


def _event(e) -> tuple:
    """(category, name, start, duration) of one profiler event, in whole ns
    on the profiler's clock: the Chrome trace's ``cat``, ``name``, ``ts``,
    ``dur``. Older profilers give no category: a device's event is then ``kernel``
    (copies and sets alike), a host range ``user_annotation``, and any other
    host event ``cpu_op``."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        cat = kind()
    elif e.device_type() != _cpu():
        cat = _DEVICE
    else:
        annotation = getattr(e, "is_user_annotation", None)
        ranged = annotation() if annotation is not None else e.name() == WINDOW_MARK
        cat = "user_annotation" if ranged else "cpu_op"
    if hasattr(e, "start_ns"):
        return cat, e.name(), int(e.start_ns()), int(e.duration_ns())
    return cat, e.name(), int(e.start_us()) * 1000, int(e.duration_us()) * 1000


def _cpu():
    from torch.autograd import DeviceType

    return DeviceType.CPU


def traced(run: Callable[[], None], sync: Optional[Callable[[], None]] = None) -> Recording:
    """Profile ``run()`` inside the marked range; ``sync`` (the device's
    synchronise) is called before the range and at its end, inside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    sync = sync or (lambda: None)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync()
    prof = profile(activities=activities)
    prof.start()
    try:
        with record_function(WINDOW_MARK):
            run()
            sync()
    finally:
        t = time.perf_counter()
        prof.stop()
    return Recording(prof, time.perf_counter() - t)
