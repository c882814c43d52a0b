"""One-step-deep metrics pipeline: keep the device queue full.

Own copy of ``gm3d_tpu/utils/pipeline.py``. In eager PyTorch the host
enqueues a step's kernels and returns before the device has run them;
reading a metric to the host (``float(t)``, ``t.tolist()``) waits until the
device has finished everything enqueued so far. A training loop that reads
step i's metrics before it enqueues step i+1 leaves the device idle while the
host prepares the next step. :class:`DeferredMetrics` holds the previous
step's device-resident metrics and drains them only AFTER the next step is
enqueued, so the device always has queued work.

Semantics, relative to the synchronous loop:
  - meter coverage is unchanged: every step's metrics are drained, in order;
  - the NaN hard exit (``utils.debug.check_finite_loss``) lags by exactly one
    step: it still hard-exits, after at most one extra step of compute;
  - a caller that saves a checkpoint ``flush()``-es the pipeline first, so
    that the deferred NaN checks run before a state is persisted.

``depth=0`` degrades to the synchronous behavior (the ``--sync_metrics``
escape hatch, for debugging and A/B measurement).
"""

from __future__ import annotations

from typing import Callable

from gm3d_tpu_torch.utils.profiling import span


class DeferredMetrics:
    """Queue device-metric payloads; drain FIFO once more than ``depth`` are
    pending. ``drain`` receives the pushed item(s) verbatim and is where the
    host read happens."""

    def __init__(self, drain: Callable, depth: int = 1):
        self._drain = drain
        self._depth = max(0, int(depth))
        self._q: list = []

    def push(self, *item) -> None:
        self._q.append(item)
        while len(self._q) > self._depth:
            self._drain_one()

    def flush(self) -> None:
        """Drain everything (epoch end — meters must be complete before the
        epoch stats are computed)."""
        while self._q:
            self._drain_one()

    def _drain_one(self) -> None:
        # the span names the host's wait for the device in a trace
        with span("pipeline.drain"):
            self._drain(*self._q.pop(0))
