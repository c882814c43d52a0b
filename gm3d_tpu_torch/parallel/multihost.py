"""Process-group set-up and the host-side gather.

Port of ``gm3d_tpu/parallel/multihost.py``. JAX initialises one controller
a host; here every GPU has a process of its own (``torchrun --nproc_per_node
N``), and ``init_distributed`` joins them into one process group:

  - NCCL when each rank has a card of its own (``--device cuda``: rank
    ``LOCAL_RANK`` takes ``cuda:LOCAL_RANK``);
  - gloo on the CPU (``--device cpu``) and where the ranks share one card
    (``--device cuda:K``: NCCL refuses two ranks on one GPU; gloo reduces
    CUDA tensors).

``gather_features`` is the one explicit collective of the evaluation, as in
the JAX package: the SVM probe's features, gathered so that every rank fits
the same SVC.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from gm3d_tpu_torch.parallel.context import DataParallel, active, get_context, set_context
from gm3d_tpu_torch.utils.device import resolve_device

# a rank that waits this long for the others fails instead of hanging
TIMEOUT = timedelta(minutes=10)


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def rank_device(device: Union[str, torch.device], local_rank: int) -> torch.device:
    """``cuda`` without an index is this rank's own card (``cuda:LOCAL_RANK``);
    ``cuda:K`` puts every rank on card K; ``cpu`` stays."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return resolve_device(dev)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: Union[str, torch.device] = "cuda") -> Optional[DataParallel]:
    """Join this process to the data-parallel group and register the
    context (``parallel/context.py``). Arguments that are absent come from
    the ``torchrun`` environment (``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``). A no-op returning None for one process.
    ``coordinator_address`` is ``host:port`` of rank 0."""
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE", 1)
    if world <= 1:
        return None
    ctx = get_context()
    if ctx is not None:
        return ctx
    rank = process_id if process_id is not None else _env_int("RANK", 0)
    local_rank = _env_int("LOCAL_RANK", rank)
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    requested = torch.device(device)
    dev = rank_device(requested, local_rank)
    shared_card = dev.type == "cuda" and requested.index is not None
    backend = "nccl" if dev.type == "cuda" and not shared_card else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=world, rank=rank, timeout=TIMEOUT)
    return register_process_group(dev)


def register_process_group(device: Union[str, torch.device]) -> DataParallel:
    """Register the context of the default process group, which the caller
    has initialised (any world size: one rank over NCCL runs every
    collective of the data-parallel path), with two gloo groups of its own
    for the host side (``DataParallel``)."""
    host_group = dist.new_group(backend="gloo", timeout=TIMEOUT)
    control_group = dist.new_group(backend="gloo", timeout=TIMEOUT)
    ctx = DataParallel(group=dist.group.WORLD, host_group=host_group,
                       control_group=control_group,
                       rank=dist.get_rank(), world=dist.get_world_size(),
                       device=torch.device(device))
    set_context(ctx)
    return ctx


def shutdown() -> None:
    """Clear the context and destroy the process group, where there is one."""
    set_context(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def is_main_process() -> bool:
    ctx = get_context()
    return ctx is None or ctx.rank == 0


def _gather_host(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (rows may differ in number), concatenated in rank
    order, on the CPU: the row counts first, then the rows padded to the
    largest count (gloo's ``all_gather`` takes equal shapes)."""
    world = dist.get_world_size(group)
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(counts, torch.tensor([x.shape[0]], dtype=torch.int64), group=group)
    counts = [int(c) for c in counts]
    padded = x.new_zeros((max(counts),) + tuple(x.shape[1:]))
    padded[:x.shape[0]] = x
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded, group=group)
    return torch.cat([p[:n] for p, n in zip(parts, counts)])


def gather_features(features, labels) -> Tuple:
    """Every rank's features and labels, concatenated in rank order, on
    every rank (``dist_utils.gather_tensor``); the identity for one
    process. Takes numpy arrays or tensors and returns the same kind, on the
    device they came from. Runs on the context's host group, on host copies,
    so the step's collectives never interleave with it."""
    ctx = active()
    if ctx is None:
        return features, labels
    out = []
    for x in (features, labels):
        t = torch.as_tensor(x)
        g = _gather_host(t.detach().cpu().contiguous(), ctx.host_group)
        out.append(g.numpy() if isinstance(x, np.ndarray) else g.to(t.device))
    return tuple(out)
