"""Train state: student, EMA copy, optimizer and step counter.

Port of ``gm3d_tpu/train/state.py``. The JAX state is an immutable pytree
that every step replaces; here the modules and the optimizer are updated in
place and the state object only holds them together.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn


@dataclass
class TrainState:
    student: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Optional[nn.Module] = None
    step: int = 0


def create_train_state(student: nn.Module, optimizer: torch.optim.Optimizer,
                       with_ema: bool = False) -> TrainState:
    """``with_ema``: a deep copy of the student, in eval mode and without
    gradients, that ``ema_update`` moves towards the student."""
    ema = None
    if with_ema:
        ema = copy.deepcopy(student).eval()
        for p in ema.parameters():
            p.requires_grad_(False)
    return TrainState(student=student, optimizer=optimizer, ema=ema, step=0)


@torch.no_grad()
def ema_update(ema: Optional[nn.Module], new: nn.Module, decay: float) -> None:
    """timm ModelEma rule, in place: ema = decay * ema + (1 - decay) * new,
    over the parameters AND the BatchNorm running statistics
    (``num_batches_tracked``, which the JAX state does not have, is copied)."""
    if ema is None:
        return
    # the JAX step holds the decay as an fp32 scalar: round it the same way
    decay = torch.tensor(decay, dtype=torch.float32).item()
    new_state = new.state_dict()
    floats_e, floats_n = [], []
    for name, e in ema.state_dict().items():
        n = new_state[name]
        if e.dtype.is_floating_point:
            floats_e.append(e)
            floats_n.append(n.detach().to(e.dtype))
        else:
            e.copy_(n)
    torch._foreach_mul_(floats_e, decay)
    torch._foreach_add_(floats_e, floats_n, alpha=1.0 - decay)
