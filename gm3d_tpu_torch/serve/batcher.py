"""Dynamic request batching over a
:class:`~gm3d_tpu_torch.serve.runner.ServingModel`.

Own copy of ``gm3d_tpu/serve/batcher.py`` (plain Python). The artifact has a
STATIC batch and the HTTP server is threaded: without coalescing, K
concurrent single-cloud requests each zero-pad to a full batch and dispatch
K full-batch device calls where ``ceil(K / batch)`` would do. Request threads
enqueue clouds; one consumer thread collects up to ``batch`` clouds, waiting
at most ``max_wait_ms`` after the first, runs one padded device call per
collected batch, and distributes the output slices.

The single consumer thread also serializes device dispatch, so concurrent
requests never interleave their device calls.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from gm3d_tpu_torch.serve.runner import ServingModel, check_points


class _Item:
    __slots__ = ("cloud", "event", "result", "error")

    def __init__(self, cloud: np.ndarray):
        self.cloud = cloud
        self.event = threading.Event()
        self.result = None
        self.error: Exception | None = None


class DynamicBatcher:
    """Coalesces concurrent :meth:`predict` calls into shared device calls.

    Same contract as :meth:`ServingModel.predict`: numpy in / numpy out,
    ``(N, 3)`` or ``(B, N, 3)``; shape errors raise ``ValueError`` in the
    calling thread before anything is enqueued. Device failures inside a
    coalesced batch propagate to every request in it.

    ``max_wait_ms`` bounds the latency a lone request pays waiting for
    company; under saturation the wait never triggers (the queue refills
    faster than the device drains it).
    """

    def __init__(self, model: ServingModel, max_wait_ms: float = 3.0):
        self.model = model
        self.max_wait = max(0.0, float(max_wait_ms)) / 1000.0
        self._cap = model.batch
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._closed = False
        # serializes the closed-check+enqueue against close(): without it a
        # request that passed the check could enqueue AFTER the shutdown
        # sentinel, and its caller would block on event.wait() forever
        self._lock = threading.Lock()
        # ops counters (exposed on /info): device dispatches vs clouds served
        self.device_calls = 0
        self.clouds_served = 0
        self._thread = threading.Thread(
            target=self._loop, name="gm3d-batcher", daemon=True)
        self._thread.start()

    # -- request side ------------------------------------------------------

    def predict(self, points: np.ndarray) -> np.ndarray:
        points, single = check_points(points, self.model.npoints)
        items = [_Item(c) for c in points]
        with self._lock:
            if self._closed:
                raise RuntimeError("DynamicBatcher is closed")
            for it in items:
                self._q.put(it)
        for it in items:
            it.event.wait()
        for it in items:
            if it.error is not None:
                raise it.error
        out = np.stack([it.result for it in items])
        return out[0] if single else out

    def close(self):
        """Stop the consumer thread (pending requests are still served)."""
        with self._lock:
            if self._closed:
                return
            # under the lock: the sentinel is guaranteed LAST in the queue
            self._closed = True
            self._q.put(None)
        self._thread.join()

    # -- consumer side -----------------------------------------------------

    def _collect(self) -> list | None:
        """Block for the first cloud, then gather more until the collect cap
        (the artifact batch) is full or ``max_wait`` has passed. None =
        shutdown."""
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self._cap:
            remaining = deadline - time.monotonic()
            try:
                nxt = self._q.get(timeout=max(0.0, remaining))
            except queue.Empty:
                break
            if nxt is None:  # shutdown sentinel: serve what we have first
                self._q.put(None)
                break
            batch.append(nxt)
            if remaining <= 0:
                # past the deadline we only drain what is ALREADY queued
                try:
                    while len(batch) < self._cap:
                        nxt = self._q.get_nowait()
                        if nxt is None:
                            self._q.put(None)
                            break
                        batch.append(nxt)
                except queue.Empty:
                    pass
                break
        return batch

    def _loop(self):
        while True:
            batch = self._collect()
            if batch is None:
                return
            clouds = np.stack([it.cloud for it in batch])
            try:
                out = self.model.predict(clouds)
            except Exception as e:  # propagate to every caller in the batch
                for it in batch:
                    it.error = e
                    it.event.set()
                continue
            self.device_calls += -(-len(batch) // self.model.batch)
            self.clouds_served += len(batch)
            for it, o in zip(batch, out):
                it.result = o
                it.event.set()
