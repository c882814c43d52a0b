"""Process-wide data-parallel context.

Port of ``gm3d_tpu/parallel/context.py``. The JAX package registers its data
mesh here so that its Pallas routes can wrap their kernels in ``shard_map``.
The port registers the process group instead: one process per GPU
(``torchrun``), each holding a contiguous block of rows of the global batch.
Everything that must behave as if the whole batch were in one process reads
it:

  - ``models/blocks.py::TorchBatchNorm`` takes train-mode statistics over
    the global batch;
  - every random draw with a batch axis goes through ``draw_rows``: it
    draws for the GLOBAL batch from the generator, which every rank seeds
    alike, and keeps this rank's rows, so that each rank sees its rows of
    the single-process draw and every generator stays in the
    single-process state (the JAX step draws from one key for the global
    batch);
  - the steps average their gradients and metrics over ranks
    (``parallel/mesh.py``).

No context (one process) or a context of world size 1 gives the
single-process results. Inside ``replica_scope()`` the calling thread runs
as one process even under a context: few-shot folds are dealt to ranks
whole, and a ragged evaluation batch is computed whole on every rank.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import torch


@dataclass(frozen=True)
class DataParallel:
    """The process group of the step's collectives (NCCL, or gloo on the CPU
    and for ranks that share a card); two gloo groups of their own, for the
    host-side gathers (``multihost.gather_features``, the few-shot
    accuracies; the pretrain CLI's probe thread runs them) and for the main
    thread's host-side agreement (the preemption flag, ``utils/preempt.py``),
    so that no two threads interleave collectives on one group; this
    process's rank, the world size and its device."""
    group: Any
    host_group: Any
    control_group: Any
    rank: int
    world: int
    device: torch.device


_CONTEXT: Optional[DataParallel] = None
# True in a thread (or task) that runs inside ``replica_scope``
_REPLICA: contextvars.ContextVar = contextvars.ContextVar("gm3d_replica", default=False)


def set_context(ctx: Optional[DataParallel]) -> None:
    """Register the data-parallel context of this process (None clears)."""
    global _CONTEXT
    _CONTEXT = ctx


def get_context() -> Optional[DataParallel]:
    """The registered context, whatever the scope (ranks, groups)."""
    return _CONTEXT


def active() -> Optional[DataParallel]:
    """The context the calling code computes under: the registered one,
    except inside ``replica_scope``, where there is none."""
    return None if _REPLICA.get() else _CONTEXT


@contextlib.contextmanager
def replica_scope():
    """Run the calling thread as one process under a context: whole draws,
    local BatchNorm statistics, no gradient or metric averaging."""
    token = _REPLICA.set(True)
    try:
        yield
    finally:
        _REPLICA.reset(token)


def world_size() -> int:
    ctx = active()
    return 1 if ctx is None else ctx.world


def draw_rows(draw: Callable[[Sequence[int]], torch.Tensor], shape: Sequence[int],
              dim: int = 0) -> torch.Tensor:
    """``draw(shape)``, where ``shape[dim]`` is this rank's share of the
    global batch: under a context, ``draw`` is called for the global batch
    (``shape[dim] * world``) and this rank's block of rows is kept. The one
    route of every per-sample draw of the port's steps."""
    ctx = active()
    if ctx is None:
        return draw(tuple(shape))
    shape = list(shape)
    rows = shape[dim]
    shape[dim] = rows * ctx.world
    return draw(tuple(shape)).narrow(dim, ctx.rank * rows, rows)
