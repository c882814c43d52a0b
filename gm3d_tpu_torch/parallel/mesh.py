"""The data mesh: batch shards and the collectives of the steps.

Port of ``gm3d_tpu/parallel/mesh.py``. The JAX package places the global
batch sharded over a 1-D device mesh and lets XLA insert the gradient psum.
Here each rank is a process that holds the FULL global batch (every rank
runs the same loader from the same seed, the JAX loader contract) and keeps
its block of rows (``shard_batch``); the steps call the collectives below
themselves:

  - ``average_gradients``: one flattened all-reduce of the gradients after
    the backward, before clipping and the optimizer (a gradient
    accumulation reduces its window's mean once, at the update);
  - ``mean_over_ranks``: the step's metrics, so every rank logs the global
    values;
  - ``global_count``: a denominator counted over the whole batch (the
    relative learning loss's valid pairs, M2AE's masked groups).

Each is a no-op without a context (``parallel/context.py``) and inside
``replica_scope``. No ``DistributedDataParallel``: parameters that get no
gradient in some modes (the trimmed EMA pass, frozen towers, remat's
recompute) would need ``find_unused_parameters``, accumulation ``no_sync``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from gm3d_tpu_torch.parallel import multihost
from gm3d_tpu_torch.parallel.context import (
    DataParallel,
    active,
    get_context,
    replica_scope,
    world_size,
)


def make_mesh(num_devices: Optional[int] = None, device="cuda") -> Optional[DataParallel]:
    """The data mesh of this process: ``init_distributed`` from the
    ``torchrun`` environment (None for one process). ``num_devices``, where
    given, must equal the world size."""
    ctx = multihost.init_distributed(device=device)
    world = 1 if ctx is None else ctx.world
    if num_devices is not None and num_devices != world:
        raise ValueError(
            f"--num_devices {num_devices} but {world} process(es): the port runs one "
            f"process per GPU; launch with torchrun --nproc_per_node {num_devices} "
            "(or leave --num_devices out)")
    return ctx


def _map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return fn(batch)


def _rows(x, ctx: DataParallel):
    n = x.shape[0] // ctx.world
    return x[ctx.rank * n:(ctx.rank + 1) * n]


def check_global_batch(batch: int) -> None:
    """The global batch must divide by the world size (``setup_mesh`` of
    the JAX package's CLIs)."""
    world = world_size()
    if batch % world:
        raise ValueError(f"global batch {batch} not divisible by {world} processes; "
                         "adjust --batch_size or the process count")


def shard_batch(batch):
    """This rank's block of rows of every array of the global ``batch``
    (numpy arrays or tensors, nested in tuples, lists or dicts). The global
    batch must divide by the world size."""
    ctx = active()
    if ctx is None or ctx.world == 1:
        return batch

    def take(x):
        check_global_batch(x.shape[0])
        return _rows(x, ctx)

    return _map(take, batch)


def shard_eval_batch(batch) -> Tuple[Any, bool]:
    """``(rows, sharded)``: this rank's rows where the batch divides by the
    world size, else the whole batch (an evaluation loader keeps its ragged
    last batch), which every rank then computes whole, inside
    ``replica_scope`` (``run_eval_batch``)."""
    ctx = active()
    if ctx is None or ctx.world == 1:
        return batch, False
    sizes = set()
    _map(lambda x: sizes.add(x.shape[0] % ctx.world), batch)
    if sizes != {0}:
        return batch, False
    return _map(lambda x: _rows(x, ctx), batch), True


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's equal block of rows, concatenated in rank order, on every
    rank: an all-reduce of a zero-padded buffer on the step's group (gloo has
    no ``all_gather`` for CUDA tensors)."""
    ctx = active()
    if ctx is None:
        return x
    n = x.shape[0]
    buf = x.new_zeros((n * ctx.world,) + tuple(x.shape[1:]))
    buf[ctx.rank * n:(ctx.rank + 1) * n] = x
    dist.all_reduce(buf, group=ctx.group)
    return buf


def run_eval_batch(fn, *batch, gather: bool = True):
    """``fn(*batch)`` for a batch of a global loader that keeps its ragged
    last batch: ``fn`` on this rank's rows, or on the whole batch on every
    rank, inside ``replica_scope``, where it does not divide by the world
    size. With ``gather`` the output, one tensor of rows as the eval and vote
    steps return, is the whole batch's on every rank (its rows gathered);
    without it, ``fn``'s output is returned as it is (the pretrain CLI's
    probe step, a training step of its own)."""
    rows, sharded = shard_eval_batch(batch)
    if not sharded:
        with replica_scope():
            return fn(*batch)
    out = fn(*rows)
    return gather_rows(out) if gather else out


def replicate_tree(module: nn.Module) -> nn.Module:
    """Rank 0's parameters and buffers in every rank, in place."""
    ctx = active()
    if ctx is None:
        return module
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src=0, group=ctx.group)
    return module


class _AllReduceSum(torch.autograd.Function):
    """A sum over ranks whose backward is the sum over ranks of the
    gradient: each rank's input reaches every rank's output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce (sum) over ``group``."""
    return _AllReduceSum.apply(x, group)


def average_gradients(params: Iterable[torch.Tensor]) -> None:
    """Average the gradients of ``params`` over ranks: one all-reduce of
    their concatenation (a parameter without a gradient has none on every
    rank, since all ranks run the same program)."""
    ctx = active()
    if ctx is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=ctx.group)
    flat.div_(ctx.world)
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])


def reduce_gradients(optimizer, params: Iterable[torch.Tensor]) -> None:
    """The steps' call after the backward: ``average_gradients``, unless
    ``optimizer`` accumulates (``train/optim.py::MultiSteps``), which
    averages its window's mean once, at the update."""
    if getattr(optimizer, "accum_steps", 1) == 1:
        average_gradients(params)


def mean_over_ranks(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each 0-d metric averaged over ranks (one all-reduce)."""
    ctx = active()
    if ctx is None:
        return metrics
    names = list(metrics)
    stacked = torch.stack([metrics[n].to(device=ctx.device, dtype=torch.float32)
                           for n in names])
    dist.all_reduce(stacked, group=ctx.group)
    stacked = stacked / ctx.world
    return dict(zip(names, stacked.unbind()))


def global_count(count: torch.Tensor, minimum: float = 1.0) -> torch.Tensor:
    """A count over the whole batch, at least ``minimum``, divided by the
    world size: the denominator that makes the mean over ranks of this
    rank's ``sum / global_count`` the single-process ``sum /
    count.clamp_min(minimum)``."""
    ctx = active()
    if ctx is None:
        return count.clamp_min(minimum)
    total = count.detach().to(torch.float32).clone()
    dist.all_reduce(total, group=ctx.group)
    return total.clamp_min(minimum) / ctx.world


def barrier() -> None:
    """Wait for every rank (on the host group: no device work)."""
    ctx = get_context()
    if ctx is not None:
        dist.barrier(group=ctx.host_group)
