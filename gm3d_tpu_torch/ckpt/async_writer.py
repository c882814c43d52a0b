"""Asynchronous checkpoint writer: overlap saves with training.

Port of ``gm3d_tpu/ckpt/async_writer.py``. A synchronous ``save_checkpoint``
holds the training loop for the device-to-host copy of the whole state and
the disk write. This writer instead copies the state ON THE DEVICE, on the
current stream, in one pass (``torch._foreach_copy_`` into buffers it keeps
from one save to the next), records an event after the copy, and hands the
copy to a background thread. The thread makes its side stream wait on that
event, copies the snapshot to the host there, and runs the ordinary save.

Unlike the JAX state, the port's state is updated IN PLACE by the next step:
a "snapshot" that shared storage with the live modules would be silently
overwritten while it is written to disk. The copy owns its memory, and the
event orders it before every later step on the stream.

Semantics (as in the JAX writer):
  - one save in flight at a time (``submit`` waits for the previous one; the
    extra device memory is one copy of the state);
  - a failed background save raises at the next ``submit`` or ``wait``;
  - exit paths call ``wait()`` before a synchronous save of their own;
  - the thread is a daemon: a NaN hard exit does not hang on a half-written
    save of the state it rejects (a save commits by ``os.replace``);
  - ``enabled=False`` (``--sync_save``) saves inline from the live state.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

import torch

from gm3d_tpu_torch.ckpt.checkpoint import capture
from gm3d_tpu_torch.parallel.multihost import is_main_process


def tensors_of(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict / list / tuple, in traversal order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return []


def _replace(tree: Any, it) -> Any:
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _replace(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replace(v, it) for v in tree)
    return tree


def _same_layout(a: List[torch.Tensor], b: List[torch.Tensor]) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and x.device == y.device for x, y in zip(a, b))


def device_snapshot(state: Any, buffers: Optional[List[torch.Tensor]] = None) -> dict:
    """A copy of every tensor of ``state`` (a ``TrainState`` or a checkpoint
    dict) on its own device, as a checkpoint dict. ``buffers``, the tensors
    of an earlier snapshot of the same layout, are written over instead of
    allocating new ones. The copies are enqueued on the current stream;
    non-tensor leaves (the step, the optimizer's settings) pass through."""
    tree = capture(state)
    live = [t.detach() for t in tensors_of(tree)]
    if buffers is None or not _same_layout(buffers, live):
        buffers = [torch.empty_like(t) for t in live]
    by_device = {}
    for dst, src in zip(buffers, live):
        by_device.setdefault(src.device, ([], []))
        by_device[src.device][0].append(dst)
        by_device[src.device][1].append(src)
    for dsts, srcs in by_device.values():
        torch._foreach_copy_(dsts, srcs)
    return _replace(tree, iter(buffers))


class AsyncCheckpointWriter:
    """Serialised background executor for checkpoint saves.

    ``submit(state, save_fn)`` snapshots ``state`` on the device and runs
    ``save_fn(snapshot)`` (the checkpoint save, then any sidecar, in that
    order) on a background thread, with the snapshot's tensors on the host.
    """

    def __init__(self, enabled: bool = True):
        self._enabled = bool(enabled)
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self._buffers: Optional[List[torch.Tensor]] = None

    def submit(self, state: Any, save_fn: Callable[[Any], None]) -> None:
        if not is_main_process():
            return  # only rank 0 writes checkpoints: no snapshot elsewhere
        if not self._enabled:
            save_fn(state)
            return
        self.wait()  # one save at a time; a failure of the last one raises here
        snap = device_snapshot(state, self._buffers)
        buffers = self._buffers = tensors_of(snap)
        cuda = [t for t in buffers if t.is_cuda]
        ready = None
        if cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(cuda[0].device))
            device = cuda[0].device

        def run() -> None:
            try:
                host = snap
                if ready is not None:
                    # the copy was enqueued on the training stream: a side
                    # stream waits for it, then reads the snapshot to the host
                    side = torch.cuda.Stream(device=device)
                    side.wait_event(ready)
                    with torch.cuda.stream(side):
                        host = _replace(snap, iter([t.to("cpu") for t in buffers]))
                save_fn(host)
            except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                self._err = e

        self._thread = threading.Thread(target=run, name="gm3d-ckpt-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the save in flight (if any) is written; re-raise its
        failure. Call before process exit and before any synchronous save."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("asynchronous checkpoint save failed") from err
