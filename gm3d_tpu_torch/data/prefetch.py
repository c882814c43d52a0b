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

    def __iter__(self) -> Iterator:
        queue = []
        it = iter(self.loader)
        for batch in it:
            queue.append((self._put(batch), self._loader_state()))
            if len(queue) >= self.size:
                break
        while queue:
            out, state_after = queue.pop(0)
            out = self._hand_over(out)
            nxt = next(it, None)
            if nxt is not None:
                queue.append((self._put(nxt), self._loader_state()))
            self._yielded_state = state_after
            yield out
