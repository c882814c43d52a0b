"""Spans of the program's layers, and traces.

Port of ``gm3d_tpu/utils/profiling.py`` over ``torch.profiler``, with the
port's own span recorder.

``span(name, **attrs)`` marks one stretch of a layer's work. While no
profiler runs in the process and no ``recording()`` context is open it
returns one shared no-op context: the cost is one read of a process-wide
flag. While either is on, a span stamps its start and end with
``time.time_ns()`` (the clock of the profiler's own events), enters
``torch.profiler.record_function`` while a profiler runs (so it shows in
the trace of its thread, or of every thread where the profiler takes all) and keeps
one record: name, id, the id of the span open around it on its thread,
the thread's name, start and end in ns, and ``attrs``. A cause on another
thread goes in ``attrs`` (a batcher call lists the request spans it
served). ``spans()`` and ``clear()`` read and empty the records.

``step_span(device)`` is the train step's span ``step``; its ``mark(name)``
ends the stage open inside it, if any, and opens the span ``step.<name>``;
the step's end closes the last. While recording, a timing event (a
``torch.cuda.Event`` on CUDA) is taken at each mark and at the step's end,
and ``stage_ms()`` resolves them into the stream's time from one boundary to
the next, by stage.

``trace`` records the host (every thread, where the installed torch can)
and the CUDA device for the enclosed steps inside a window range and writes
a Chrome trace (``trace.json``, viewable in Perfetto or ``chrome://tracing``)
into ``log_dir``; ``device_busy_share`` and ``device_idle_gaps`` read such a
trace over that window, its own start to its own end.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

TRACE_FILE = "trace.json"
# the range ``start_trace`` opens and ``stop_trace`` closes: the trace's window
TRACE_WINDOW = "gm3d.trace_window"
# the trace categories of work on the card: kernels, copies and sets
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# records kept at most; past it a span is counted, not kept
MAX_RECORDS = 1_000_000

_records: List[dict] = []
_steps: List[list] = []  # each recorded step's [(boundary, event), ...]
_dropped = 0
_forced = 0  # open ``recording()`` contexts
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(kept: list, item) -> None:
    global _dropped
    if len(kept) < MAX_RECORDS:
        kept.append(item)
    else:
        with _lock:
            _dropped += 1


class _Off:
    """The span of a process that records nothing: one shared instance."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def mark(self, name: str) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        # a profiler's range; none while only ``recording()`` is on
        self._rf = (torch.profiler.record_function(self.name)
                    if _autograd_profiler._is_profiler_enabled else None)
        self.start = time.time_ns()
        if self._rf is not None:
            self._rf.__enter__()
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        end = time.time_ns()
        _stack().pop()
        _keep(_records, {"name": self.name, "id": self.id, "parent": self.parent,
                         "thread": threading.current_thread().name,
                         "start_ns": self.start, "end_ns": end, "attrs": self.attrs})
        return None


class _HostEvent:
    """A timing event of a step on the CPU, where the work is done when the
    host has enqueued it: ``torch.cuda.Event``'s three methods by the host's
    clock."""

    __slots__ = ("ns",)

    def record(self) -> None:
        self.ns = time.perf_counter_ns()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "_HostEvent") -> float:
        return (end.ns - self.ns) * 1e-6


class _Step(_Span):
    __slots__ = ("_cuda", "_events", "_stage")

    def __init__(self, device):
        super().__init__("step", {})
        self._cuda = torch.device(device).type == "cuda"
        self._events, self._stage = [], None

    def mark(self, name: str) -> None:
        """End the open stage here and open the span ``step.<name>``; the
        point is a boundary of ``stage_ms``."""
        self._end_stage(None, None, None)
        self._events.append((name, _timing_event(self._cuda)))
        self._stage = _Span(f"step.{name}", {}).__enter__()

    def _end_stage(self, *exc) -> None:
        if self._stage is not None:
            self._stage.__exit__(*exc)
            self._stage = None

    def __exit__(self, *exc):
        self._end_stage(*exc)
        if self._events:
            self._events.append(("end", _timing_event(self._cuda)))
            _keep(_steps, self._events)
        return super().__exit__(*exc)


def _timing_event(cuda: bool):
    """A timing event recorded now: on the current CUDA stream, or the host's."""
    ev = torch.cuda.Event(enable_timing=True) if cuda else _HostEvent()
    ev.record()
    return ev


def span(name: str, **attrs):
    """A context that records the enclosed work as the span ``name`` while
    recording is on (a profiler runs, or ``recording()`` is open); the shared
    no-op otherwise."""
    if not (_autograd_profiler._is_profiler_enabled or _forced):
        return _OFF
    return _Span(name, attrs)


def step_span(device):
    """The span ``step`` of one train step on ``device``; ``mark(name)``
    starts its next stage."""
    if not (_autograd_profiler._is_profiler_enabled or _forced):
        return _OFF
    return _Step(device)


def recording_on() -> bool:
    """Whether spans are recorded now (for attributes worth building only then)."""
    return bool(_autograd_profiler._is_profiler_enabled or _forced)


def current_span() -> Optional[int]:
    """The id of the innermost span open on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def recording():
    """Record spans inside this context with no profiler running (the
    in-process scripts' stage times)."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def spans() -> List[dict]:
    """The records kept since the last ``clear()``, in the order they ended."""
    return list(_records)


def dropped() -> int:
    """Spans past ``MAX_RECORDS`` since the last ``clear()``: counted, not kept."""
    return _dropped


def stage_ms() -> List[Dict[str, float]]:
    """Each recorded step's stages, in order: stage -> the stream's ms from
    its mark to the next boundary (the next mark, or the step's end). Waits
    for each step's last event."""
    out = []
    for events in list(_steps):
        events[-1][1].synchronize()
        out.append({stage: ev.elapsed_time(nxt)
                    for (stage, ev), (_, nxt) in zip(events, events[1:])})
    return out


def clear() -> None:
    """Forget every record, step and count."""
    global _dropped
    with _lock:
        _records.clear()
        _steps.clear()
        _dropped = 0


class _Trace:
    """A running trace: the profiler and its open window range."""

    def __init__(self, prof: torch.profiler.profile, window):
        self.prof, self.window = prof, window


def _all_threads_config():
    """The profiler's option to record every thread's host events, where the
    installed torch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def start_trace(log_dir: str) -> _Trace:
    """Start a profiler over the CPU (every thread) and, where there is one,
    the CUDA device, and open the trace's window range."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities,
                                  experimental_config=_all_threads_config())
    prof.start()
    window = torch.profiler.record_function(TRACE_WINDOW)
    window.__enter__()
    return _Trace(prof, window)


def stop_trace(tr: _Trace, log_dir: str) -> str:
    """Wait for the device, close the window, stop the profiler and write its
    Chrome trace into ``log_dir``; returns the trace's path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    tr.window.__exit__(None, None, None)
    tr.prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    tr.prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Trace the enclosed steps into ``log_dir``; a no-op when it is None."""
    if log_dir is None:
        yield
        return
    tr = start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace(tr, log_dir)


def _window_and_busy(trace_path: str):
    """The window range of a Chrome trace as (start, end) and the union of
    its CUDA kernel, copy and set intervals inside it, as sorted disjoint
    (start, end) pairs, in microseconds. Raises when the trace holds no window
    range (one not taken by ``start_trace``)."""
    with open(trace_path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    windows = [e for e in events if e.get("ph") == "X" and e.get("name") == TRACE_WINDOW
               and e.get("cat") == "user_annotation"]
    if not windows:
        raise ValueError(f"{trace_path} holds no {TRACE_WINDOW} range")
    lo = float(windows[0]["ts"])
    hi = lo + float(windows[0].get("dur", 0.0))
    spans = sorted((max(float(e["ts"]), lo), min(float(e["ts"]) + float(e.get("dur", 0.0)), hi))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
    merged: list = []
    for start, end in spans:
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return (lo, hi), [tuple(m) for m in merged]


def device_busy_share(trace_path: str) -> float:
    """The share of the trace's window, its own start to its own end, in
    which at least one CUDA kernel, copy or set ran."""
    (lo, hi), busy = _window_and_busy(trace_path)
    return sum(end - start for start, end in busy) / (hi - lo) if hi > lo else 0.0


def device_idle_gaps(trace_path: str, top: int = 5) -> list:
    """The ``top`` longest stretches of the window with nothing on the device,
    its edges included, as (start from the window's start, length), in ms."""
    (lo, hi), busy = _window_and_busy(trace_path)
    gaps, at = [], lo
    for start, end in busy + [(hi, hi)]:
        if start > at:
            gaps.append((at - lo, start - at))
        at = max(at, end)
    return [(start / 1e3, length / 1e3) for start, length in
            sorted(gaps, key=lambda g: -g[1])[:top]]
