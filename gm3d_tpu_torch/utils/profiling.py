"""Tracing and step timing.

Port of ``gm3d_tpu/utils/profiling.py`` over ``torch.profiler``: ``trace``
records the host and the CUDA device for the enclosed steps and writes a
Chrome trace (``trace.json``, viewable in Perfetto or ``chrome://tracing``)
into ``log_dir``; ``device_busy_share`` reads such a trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch

TRACE_FILE = "trace.json"
# the trace categories of work on the card: kernels and copies
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy")


def start_trace(log_dir: str) -> torch.profiler.profile:
    """Start a profiler over the CPU and, where there is one, the CUDA device."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, log_dir: str) -> str:
    """Wait for the device, stop ``prof`` and write its Chrome trace into
    ``log_dir``; returns the trace's path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Trace the enclosed steps into ``log_dir``; a no-op when it is None."""
    if log_dir is None:
        yield
        return
    prof = start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace(prof, log_dir)


def _device_spans(trace_path: str) -> list:
    """The union of the CUDA kernel and memory-copy intervals of a Chrome
    trace, as sorted disjoint (start, end) pairs in microseconds. Raises when
    there is none (a trace taken without the device)."""
    with open(trace_path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
    if not spans:
        raise ValueError(f"{trace_path} holds no CUDA kernel or memory copy")
    merged = [list(spans[0])]
    for start, end in spans[1:]:
        if start > merged[-1][1]:
            merged.append([start, end])
        else:
            merged[-1][1] = max(merged[-1][1], end)
    return [tuple(m) for m in merged]


def device_busy_share(trace_path: str) -> float:
    """The share of the window from the first to the last CUDA kernel or
    memory copy of a Chrome trace in which at least one of them ran."""
    spans = _device_spans(trace_path)
    window = spans[-1][1] - spans[0][0]
    return sum(end - start for start, end in spans) / window if window > 0 else 1.0


def device_idle_gaps(trace_path: str, top: int = 5) -> list:
    """The ``top`` longest stretches of that window with nothing on the
    device, as (start from the window's start, length), in ms."""
    spans = _device_spans(trace_path)
    gaps = [(a_end - spans[0][0], b_start - a_end)
            for (_, a_end), (b_start, _) in zip(spans, spans[1:])]
    return [(start / 1e3, length / 1e3) for start, length in
            sorted(gaps, key=lambda g: -g[1])[:top]]


class StepTimer:
    """Wall time of each step and of each wait for data, the step's end
    taken after the device has finished (``torch.cuda.synchronize``)."""

    def __init__(self):
        self.iter_times = []
        self.data_times = []
        self._t0 = time.perf_counter()

    def data_ready(self):
        self.data_times.append(time.perf_counter() - self._t0)

    def step_done(self, result=None):
        if result is not None and torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.iter_times.append(now - self._t0)
        self._t0 = now

    def summary(self) -> dict:
        def mean(xs):
            return sum(xs) / len(xs) if xs else 0.0

        return {"iter_time_avg": mean(self.iter_times),
                "data_time_avg": mean(self.data_times),
                "steps": len(self.iter_times)}
