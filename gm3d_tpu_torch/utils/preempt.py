"""Preemption-safe training: SIGTERM -> checkpoint at the next step boundary
-> clean exit.

Port of ``gm3d_tpu/utils/preempt.py``. Schedulers that reclaim a machine
(spot instances, node drains) send SIGTERM and wait a short grace period
before they kill the process. The signal handler only sets a flag; the
training loop polls it at step boundaries, where the state and the loader
position agree, writes the rolling checkpoint and the loader sidecar (the
machinery of ``--save_steps``) and exits 0. ``--resume`` then continues from
the exact next batch. Exit code 0 tells a graceful stop apart from the
NaN-loss exit (1) for an orchestrator that restarts on any exit.

Under data parallelism the ranks agree on the flag at each poll (a signal on
any rank stops every rank at the same step boundary), so that no rank waits
in a collective for one that has left; rank 0 writes the checkpoint.
"""

from __future__ import annotations

import signal


class PreemptionGuard:
    """Install with :meth:`install`; poll with :meth:`exit_if_triggered` at
    points where the state and the loader position agree."""

    def __init__(self, logger=None, signums=(signal.SIGTERM,)):
        self._logger = logger
        self._signums = signums
        self._prev = {}
        self.triggered = False

    def install(self) -> "PreemptionGuard":
        for s in self._signums:
            try:
                self._prev[s] = signal.signal(s, self._on_signal)
            except ValueError:
                # signal.signal works only in the main thread: a caller that
                # drives main() from another thread trains without the guard
                pass
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        self._prev = {}

    def _on_signal(self, signum, frame):
        # CPython runs handlers between bytecodes of the main thread, so
        # logging here is safe (logging's lock is reentrant for its owner)
        self.triggered = True
        if self._logger is not None:
            self._logger.warning(
                f"received signal {signum}: will checkpoint at the next step "
                "boundary and exit (rerun with --resume to continue)")

    def _agreed(self) -> bool:
        """This rank's flag, or any rank's under data parallelism (a
        maximum over the context's control group: host tensors, no device
        work)."""
        from gm3d_tpu_torch.parallel.context import get_context

        ctx = get_context()
        if ctx is None:
            return self.triggered
        import torch
        import torch.distributed as dist

        flag = torch.tensor([int(self.triggered)])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=ctx.control_group)
        self.triggered = bool(flag.item())
        return self.triggered

    def exit_if_triggered(self, save_fn) -> None:
        """If a signal arrived, run ``save_fn()`` (checkpoint and loader
        sidecar), restore the handlers and exit 0."""
        if not self._agreed():
            return
        save_fn()
        if self._logger is not None:
            self._logger.warning(
                "preempted: checkpoint + loader position saved; "
                "rerun with --resume to continue from the next batch")
        self.uninstall()
        raise SystemExit(0)
