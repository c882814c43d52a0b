"""Optimizer constructors: AdamW with timm-style weight-decay masking.

Port of ``gm3d_tpu/train/optim.py::build_adamw`` and
``::build_gm3d_shared_optimizer`` over ``torch.optim.AdamW`` with two
parameter groups (decay on parameters with ``ndim > 1``, none on biases and
norms). The separated, legacy and layer-decay constructors of that file are not
ported yet.

Two places where optax and torch differ, and what is done about them:

  - optax applies decoupled weight decay to a parameter whose gradient is
    zero; ``torch.optim.AdamW`` skips a parameter whose gradient is ``None``.
    In feature mode the student's coordinate head receives no gradient, and
    the JAX function freezes it (``frozen_modules=("coord_head",)``). Here the
    frozen modules are left out of the optimizer altogether, so they are
    neither stepped nor decayed, whatever their gradient.
  - ``optax.clip_by_global_norm`` scales by ``max_norm / norm`` only when
    ``norm > max_norm``; ``torch.nn.utils.clip_grad_norm_`` scales by
    ``max_norm / (norm + 1e-6)``. ``clip_by_global_norm_`` is optax's rule.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

# the port's name of the JAX student's ``coord_head``
GM3D_COORD_HEAD = "increase_dim_just_network_without_feature"


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (``optax.global_norm``)."""
    sq = [t.detach().to(torch.float32).pow(2).sum() for t in tensors]
    if not sq:
        return torch.zeros(())
    return torch.stack(sq).sum().sqrt()


def clip_by_global_norm_(params: Iterable[nn.Parameter], max_norm: float) -> torch.Tensor:
    """Scale the gradients in place so that their global norm is at most
    ``max_norm`` (no epsilon; untouched when already inside). Returns the
    norm BEFORE clipping. No host synchronisation."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = global_norm(grads)
    if grads:
        scale = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
        torch._foreach_mul_(grads, scale.to(grads[0].device))
    return norm


class ClippedAdamW(torch.optim.AdamW):
    """AdamW whose ``step`` first clips the global gradient norm (optax's
    ``chain(clip_by_global_norm, adamw)``); ``grad_clip=None`` does not clip.
    ``last_grad_norm`` holds the unclipped norm of the latest step."""

    def __init__(self, param_groups, grad_clip: Optional[float] = None, **kwargs):
        super().__init__(param_groups, **kwargs)
        self.grad_clip = grad_clip
        self.last_grad_norm: Optional[torch.Tensor] = None

    def step(self, closure=None):
        params = [p for group in self.param_groups for p in group["params"]]
        if self.grad_clip is not None:
            self.last_grad_norm = clip_by_global_norm_(params, self.grad_clip)
        else:
            self.last_grad_norm = global_norm(p.grad for p in params if p.grad is not None)
        return super().step(closure)


def _decay_groups(named_params: Sequence[Tuple[str, nn.Parameter]], weight_decay: float):
    """timm ``add_weight_decay``: no decay for 1-d params (biases, norms)."""
    decay = [p for _, p in named_params if p.ndim > 1]
    no_decay = [p for _, p in named_params if p.ndim <= 1]
    return [{"params": decay, "weight_decay": weight_decay},
            {"params": no_decay, "weight_decay": 0.0}]


def build_adamw(named_params, learning_rate: float, weight_decay: float = 0.05,
                betas=(0.9, 0.95), grad_clip: Optional[float] = None,
                accum_steps: int = 1) -> ClippedAdamW:
    """AdamW(betas=(0.9, 0.95), eps 1e-8, wd on >=2-d params only), with an
    optional global-norm clip. ``named_params``: ``module.named_parameters()``
    or any iterable of (name, parameter). Set a scheduled learning rate on
    ``optimizer.param_groups[i]["lr"]`` before each step."""
    if accum_steps > 1:
        raise NotImplementedError(
            "accum_steps > 1 (gradient accumulation) is not ported yet")
    named = [(n, p) for n, p in named_params if p.requires_grad]
    return ClippedAdamW(_decay_groups(named, weight_decay), grad_clip=grad_clip,
                        lr=learning_rate, betas=tuple(betas), eps=1e-8)


def build_gm3d_shared_optimizer(student: nn.Module, learning_rate: float,
                                weight_decay: float = 0.05, betas=(0.9, 0.95),
                                grad_clip: Optional[float] = 5.0, accum_steps: int = 1,
                                frozen_modules: tuple = (GM3D_COORD_HEAD,)) -> ClippedAdamW:
    """Shared-optimizer GM3D pretrain: AdamW + global-norm clip 5.

    ``frozen_modules``: top-level sub-modules left out of the optimizer (see
    the module docstring); pass ``()`` for usual mode, where the coordinate
    head IS the reconstruction path."""
    named = [(n, p) for n, p in student.named_parameters()
             if n.split(".")[0] not in frozen_modules]
    return build_adamw(named, learning_rate, weight_decay, betas, grad_clip, accum_steps)
