"""Host->device prefetching: overlap the next batch's copy with the current
step's compute.

Port of ``gm3d_tpu/data/prefetch.py``. In place of ``jax.device_put`` a
batch goes into pinned host memory and is copied with ``non_blocking=True``
on a side ``torch.cuda.Stream``; the consumer's stream waits on that stream
before it gets the batch, and each yielded tensor is marked with
``record_stream`` on the consumer's stream, so that the caching allocator
does not hand its memory out again while the step still reads it.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from gm3d_tpu_torch.utils.device import resolve_device
from gm3d_tpu_torch.utils.profiling import span


class device_prefetch:
    """Yield device-resident batches while the next copies are in flight.

    A batch is an array or a tuple of arrays (numpy or anything
    ``np.asarray`` takes); it comes out as a ``torch.Tensor`` or a tuple of
    them on ``device``. On ``device="cpu"`` the tensors are
    ``torch.from_numpy`` views and no stream is used.

    Checkpointing: pre-pulling ``size`` batches advances the wrapped
    DataLoader's own ``state()`` ahead of what the consumer has actually
    trained on; saving THAT token mid-epoch would silently skip up to
    ``size`` batches on resume. :meth:`state` returns the resume token as of
    the last batch this prefetcher yielded (captured at pull time).
    """

    def __init__(self, loader: Iterable, size: int = 2, device="cuda"):
        self.loader = loader
        self.size = size
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        self._yielded_state = self._loader_state()

    def _loader_state(self) -> Optional[dict]:
        get = getattr(self.loader, "state", None)
        return get() if callable(get) else None

    def state(self) -> Optional[dict]:
        """Resume token for the NEXT batch after the last one yielded."""
        return self._yielded_state

    def _put_one(self, x) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
        if self._stream is None:
            return host
        with torch.cuda.stream(self._stream):
            return host.pin_memory().to(self.device, non_blocking=True)

    def _put(self, batch):
        if isinstance(batch, tuple):
            return tuple(self._put_one(x) for x in batch)
        return self._put_one(batch)

    def _hand_over(self, batch):
        """Make the consumer's stream wait for the copies, and tie the
        tensors' memory to that stream."""
        if self._stream is None:
            return batch
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_stream(self._stream)
        for t in batch if isinstance(batch, tuple) else (batch,):
            t.record_stream(consumer)
        return batch

    def _pull(self, it, queue: list) -> bool:
        """Take the loader's next batch and start its copy; False at the end."""
        with span("data.loader"):
            batch = next(it, None)
        if batch is None:
            return False
        with span("data.to_device"):
            queue.append((self._put(batch), self._loader_state()))
        return True

    def __iter__(self) -> Iterator:
        it = iter(self.loader)
        queue = None
        while True:
            # the consumer's wait for each batch (the spans record only while
            # a profiler runs)
            with span("data.next"):
                if queue is None:
                    queue = []
                    while self._pull(it, queue) and len(queue) < self.size:
                        pass
                if not queue:
                    return
                out, state_after = queue.pop(0)
                out = self._hand_over(out)
                self._pull(it, queue)
                self._yielded_state = state_after
            yield out
