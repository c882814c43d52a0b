"""Optimizer constructors: AdamW with timm-style weight-decay masking.

Port of ``gm3d_tpu/train/optim.py::build_adamw`` and
``::build_gm3d_shared_optimizer`` over ``torch.optim.AdamW`` with two
parameter groups (decay on parameters with ``ndim > 1``, none on biases and
norms), ``::build_legacy_adamw``, the teacher pretrain's, and
``::build_gm3d_separated_optimizer`` (``--no-shared_opt``, ``SeparatedAdamW``)
and the finetune optimizer, ``::layerwise_lr_decay_scales`` with
``::build_finetune_optimizer``: one parameter group a layer-decay scale, each
carrying its ``lr_scale`` (``set_scheduled_lr`` multiplies the schedule's rate
by it). Gradient accumulation (``accum_steps > 1``) wraps any of them in
``MultiSteps``, the counterpart of ``optax.MultiSteps``.

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

``build_legacy_adamw(..., fold_axis=True)`` is the same optimizer over
parameters stacked along a leading fold axis (the few-shot folds trained
together, ``train/finetune.py::FoldedModel``), as ``jax.vmap`` of the optax
chain is: decay decided by each fold's shape, each fold clipped by its own
norm (``FoldClippedAdamW``), the elementwise AdamW torch's own.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from gm3d_tpu_torch.parallel.mesh import average_gradients

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


def fold_global_norms(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``global_norm`` of each fold of tensors stacked along a leading fold
    axis: (F,)."""
    sq = [t.detach().to(torch.float32).pow(2).reshape(t.shape[0], -1).sum(1) for t in tensors]
    return torch.stack(sq).sum(0).sqrt()


class FoldClippedAdamW(torch.optim.AdamW):
    """AdamW over parameters stacked along a leading fold axis, each fold's
    slice of every gradient first clipped to ``grad_clip`` by that fold's own
    global norm (optax's rule, as ``clip_by_global_norm_``; ``None`` does not
    clip). AdamW is elementwise, so every fold's slice steps as its own
    optimizer would. ``last_grad_norm`` holds the (F,) unclipped norms of the
    latest step."""

    def __init__(self, param_groups, grad_clip: Optional[float] = None, **kwargs):
        super().__init__(param_groups, **kwargs)
        self.grad_clip = grad_clip
        self.last_grad_norm: Optional[torch.Tensor] = None

    def step(self, closure=None):
        grads = [p.grad for group in self.param_groups for p in group["params"]
                 if p.grad is not None]
        norm = fold_global_norms(grads)
        if self.grad_clip is not None:
            scale = torch.where(norm > self.grad_clip, self.grad_clip / norm,
                                torch.ones_like(norm))
            for g in grads:
                g.mul_(scale.view(-1, *(1,) * (g.ndim - 1)).to(g))
        self.last_grad_norm = norm
        return super().step(closure)


def _decay_groups(named_params: Sequence[Tuple[str, nn.Parameter]], weight_decay: float):
    """timm ``add_weight_decay``: no decay for 1-d params (biases, norms)."""
    decay = [p for _, p in named_params if p.ndim > 1]
    no_decay = [p for _, p in named_params if p.ndim <= 1]
    return [{"params": decay, "weight_decay": weight_decay},
            {"params": no_decay, "weight_decay": 0.0}]


class MultiSteps:
    """Gradient accumulation over ``accum_steps`` micro-batches, the
    counterpart of ``optax.MultiSteps`` around ``inner`` (a torch optimizer,
    or ``SeparatedAdamW``).

    It keeps a running mean of the gradients of ``inner``'s parameters (a
    missing gradient counts as zero, as optax's tree of zeros does) by
    optax's own rule, ``acc += (g - acc) / (n + 1)``, and the count of
    micro-steps. A micro-step that does not end the window leaves the
    parameters and ``inner``'s state alone; the ``accum_steps``-th hands
    ``scale`` times the mean to ``inner`` as the gradient (its clip applies to
    that) and steps it. ``scale`` is 1 for the mean (``build_adamw``, the GM3D
    optimizers) and ``accum_steps`` for the legacy runners' sum.

    The learning rate is ``inner``'s: the caller sets it from the count of
    updates, ``step // accum_steps``, which is where optax reads a schedule
    under ``MultiSteps``. ``state_dict`` holds the accumulation and the count,
    so that a checkpoint saved inside a window resumes exactly. Under data
    parallelism each rank accumulates its rows' gradients and the window's
    mean is averaged over ranks once, before ``inner`` steps."""

    def __init__(self, inner, accum_steps: int, scale: float = 1.0):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be at least 1, got {accum_steps}")
        self.inner, self.accum_steps, self.scale = inner, int(accum_steps), float(scale)
        self._params = [p for group in inner.param_groups for p in group["params"]]
        self.acc: List[torch.Tensor] = [torch.zeros_like(p) for p in self._params]
        self.mini_step = 0
        self.gradient_step = 0

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def scheduled_param_groups(self):
        return scheduled_param_groups(self.inner)

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def step(self) -> bool:
        """Fold the current gradients into the mean; on the last micro-step of
        the window, update through ``inner``. Returns whether it updated."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self._params]
        diff = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(diff, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, diff)
        update = self.mini_step == self.accum_steps - 1
        if update:
            if self.scale != 1.0:
                torch._foreach_mul_(self.acc, self.scale)
            for p, a in zip(self._params, self.acc):
                p.grad = a
            # data parallelism reduces the window's mean once, here
            average_gradients(self._params)
            self.inner.step()
            # the window's gradient is spent: no later backward may add into it
            for p in self._params:
                p.grad = None
            torch._foreach_zero_(self.acc)
            self.gradient_step += 1
        self.mini_step = (self.mini_step + 1) % self.accum_steps
        return update

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "acc": list(self.acc),
                "mini_step": self.mini_step, "gradient_step": self.gradient_step}

    def load_state_dict(self, state: dict) -> None:
        if len(state["acc"]) != len(self.acc):
            raise ValueError(f"the accumulation holds {len(state['acc'])} tensors, "
                             f"this optimizer {len(self.acc)}")
        self.inner.load_state_dict(state["inner"])
        with torch.no_grad():
            for a, saved in zip(self.acc, state["acc"]):
                a.copy_(saved)
        self.mini_step, self.gradient_step = int(state["mini_step"]), int(state["gradient_step"])


def accumulate(optimizer, accum_steps: int, scale: float = 1.0):
    """``optimizer`` itself for one micro-batch an update, else wrapped in
    ``MultiSteps``."""
    return optimizer if accum_steps <= 1 else MultiSteps(optimizer, accum_steps, scale)


def scheduled_param_groups(optimizer) -> list:
    """The parameter groups whose ``lr`` the learning-rate schedule sets: the
    optimizer's ``scheduled_param_groups`` where it has them
    (``SeparatedAdamW`` keeps its loss-prediction half at a constant rate),
    else all its groups."""
    return getattr(optimizer, "scheduled_param_groups", optimizer.param_groups)


def set_scheduled_lr(optimizer, lr: float) -> None:
    """Set the schedule's rate ``lr`` on the scheduled groups, each times its
    ``lr_scale`` (the finetune optimizer's layer decay; 1 where a group has
    none). One rate for every group would undo the layer decay."""
    for group in scheduled_param_groups(optimizer):
        group["lr"] = lr * group.get("lr_scale", 1.0)


def build_adamw(named_params, learning_rate: float, weight_decay: float = 0.05,
                betas=(0.9, 0.95), grad_clip: Optional[float] = None,
                accum_steps: int = 1):
    """AdamW(betas=(0.9, 0.95), eps 1e-8, wd on >=2-d params only), with an
    optional global-norm clip, over the mean of ``accum_steps`` micro-batches.
    ``named_params``: ``module.named_parameters()`` or any iterable of (name,
    parameter). Set a scheduled learning rate on ``optimizer.param_groups[i]["lr"]``
    before each step."""
    named = [(n, p) for n, p in named_params if p.requires_grad]
    return accumulate(ClippedAdamW(_decay_groups(named, weight_decay), grad_clip=grad_clip,
                                   lr=learning_rate, betas=tuple(betas), eps=1e-8),
                      accum_steps)


def build_legacy_adamw(named_params, learning_rate: float, weight_decay: float = 0.05,
                       accum_steps: int = 1, grad_clip: Optional[float] = None,
                       fold_axis: bool = False):
    """The legacy runners' AdamW, which made the published teacher: torch's
    default betas (0.9, 0.999), and no weight decay on a 1-d parameter, a
    ``.bias`` or ANY parameter whose name contains ``token`` (``mask_token``,
    ``cls_token``). The names are torch's; the JAX mask reads the same words
    in the flax paths. No gradient clip unless ``grad_clip`` (the legacy
    finetune runner's). Accumulation SUMS the micro-batches' gradients (plain
    ``loss.backward()`` a micro-batch), and the clip is taken on that sum.

    ``fold_axis``: the parameters are F folds' stacked along axis 0; a
    parameter's dimensions are counted without that axis, and the optimizer
    is a ``FoldClippedAdamW`` (each fold clipped by its own norm; its
    ``last_grad_norm`` is (F,))."""
    named = [(n, p) for n, p in named_params if p.requires_grad]
    skip = 1 if fold_axis else 0

    def decayed(name: str, p: torch.Tensor) -> bool:
        return p.ndim - skip > 1 and "token" not in name

    groups = [{"params": [p for n, p in named if decayed(n, p)], "weight_decay": weight_decay},
              {"params": [p for n, p in named if not decayed(n, p)], "weight_decay": 0.0}]
    kwargs = dict(lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    if fold_axis:
        inner = FoldClippedAdamW(groups, grad_clip=grad_clip, **kwargs)
    elif grad_clip is None:
        inner = torch.optim.AdamW(groups, **kwargs)
    else:
        inner = ClippedAdamW(groups, grad_clip=grad_clip, **kwargs)
    return accumulate(inner, accum_steps, scale=float(accum_steps))


def build_gm3d_shared_optimizer(student: nn.Module, learning_rate: float,
                                weight_decay: float = 0.05, betas=(0.9, 0.95),
                                grad_clip: Optional[float] = 5.0, accum_steps: int = 1,
                                frozen_modules: tuple = (GM3D_COORD_HEAD,)):
    """Shared-optimizer GM3D pretrain: AdamW + global-norm clip 5.

    ``frozen_modules``: top-level sub-modules (or top-level parameters, such
    as the legacy variant's ``mask_token_loss_pred``) left out of the
    optimizer (see the module docstring); pass ``()`` for usual mode, where
    the coordinate head IS the reconstruction path."""
    named = [(n, p) for n, p in student.named_parameters()
             if n.split(".")[0] not in frozen_modules]
    return build_adamw(named, learning_rate, weight_decay, betas, grad_clip, accum_steps)


# --no-shared_opt: the recon optimizer owns the encoder, the reconstruction
# decoder and the coordinate head; the loss-prediction optimizer the
# loss-prediction decoder and the feature head (the JAX names head_fc1, head_bn,
# head_fc2 are ``increase_dim_2`` here). ``decoder_pos_embed`` and both mask
# tokens sit in neither, as in the reference: no update, no decay.
GM3D_RECON_MODULES = ("MAE_encoder", "MAE_decoder", GM3D_COORD_HEAD)
GM3D_LOSS_PRED_MODULES = ("MAE_decoder_loss_pred", "increase_dim_2")


def gm3d_separated_labels(student: nn.Module) -> dict:
    """``"recon"``, ``"loss_pred"`` or ``"frozen"`` for each parameter name,
    by its top-level module (``gm3d_tpu/train/optim.py::gm3d_separated_labels``)."""
    def label(name: str) -> str:
        top = name.split(".")[0]
        if top in GM3D_RECON_MODULES:
            return "recon"
        if top in GM3D_LOSS_PRED_MODULES:
            return "loss_pred"
        return "frozen"

    return {n: label(n) for n, _ in student.named_parameters()}


class SeparatedAdamW:
    """Two clipped AdamW over disjoint parameter sets, stepped together
    (``--no-shared_opt``; optax's ``multi_transform`` of two ``build_adamw``).
    Each clips its own set's gradients to its global norm. A parameter of
    either set with no gradient is stepped on a zero one, as optax steps it
    (decay included); the frozen parameters belong to neither."""

    def __init__(self, recon: ClippedAdamW, loss_pred: ClippedAdamW):
        self.recon, self.loss_pred = recon, loss_pred

    @property
    def param_groups(self):
        return self.recon.param_groups + self.loss_pred.param_groups

    @property
    def scheduled_param_groups(self):
        # the loss-prediction half keeps its constant rate
        return self.recon.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.recon.zero_grad(set_to_none=set_to_none)
        self.loss_pred.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.recon.step()
        self.loss_pred.step()

    def state_dict(self) -> dict:
        return {"recon": self.recon.state_dict(), "loss_pred": self.loss_pred.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.recon.load_state_dict(state["recon"])
        self.loss_pred.load_state_dict(state["loss_pred"])


def build_gm3d_separated_optimizer(student: nn.Module, learning_rate: float,
                                   weight_decay: float = 0.05, betas=(0.9, 0.95),
                                   accum_steps: int = 1, grad_clip: Optional[float] = 5.0,
                                   loss_pred_learning_rate: Optional[float] = None):
    """``--no-shared_opt``: ``SeparatedAdamW`` over ``gm3d_separated_labels``,
    each half ``build_adamw``'s (decay on >=2-d parameters, clip
    ``grad_clip``). The caller schedules the recon half's learning rate
    (``scheduled_param_groups``); the loss-prediction half trains at the
    constant ``loss_pred_learning_rate`` (the separated engine never schedules
    it), ``learning_rate`` if not given."""
    labels = gm3d_separated_labels(student)
    params = dict(student.named_parameters())

    def half(label: str, lr: float) -> ClippedAdamW:
        named = [(n, params[n]) for n, lab in labels.items()
                 if lab == label and params[n].requires_grad]
        return build_adamw(named, lr, weight_decay, betas, grad_clip)

    lp_lr = learning_rate if loss_pred_learning_rate is None else loss_pred_learning_rate
    return accumulate(SeparatedAdamW(half("recon", learning_rate), half("loss_pred", lp_lr)),
                      accum_steps)


def layerwise_lr_decay_scales(names: Iterable[str], decay: float = 0.75,
                              num_layers: int = 12) -> Dict[str, float]:
    """The learning-rate scale of each parameter name
    (``gm3d_tpu/train/optim.py::layerwise_lr_decay_scales``, reference
    ``util/lr_decay.py:14-61``).

    The flat ``PointTransformer``, by the reference's EFFECTIVE layer ids:
    ``cls_token`` is layer 0 (``decay ** num_layers``), ``blocks.blocks.{i}.*``
    layer ``min(i + 1, num_layers)``, and everything else (patch embed,
    ``pos_embed``, ``cls_pos``, ``norm_p``, the head) layer ``num_layers``,
    scale 1. ``num_layers`` is 12 whatever the model's depth, as the
    reference hard-codes it.

    A hierarchical Point-M2AE model (names ``...stage{s}.blocks.{i}...``),
    which the reference never saw: the blocks take cumulative layer ids
    across the stages (stage 0 first, ``offset(s) + i + 1``), the stem
    (everything else under ``encoder.``: patch embed, merges, positional
    embeddings, placeholders) layer 0, and the rest (the norms, the head)
    layer ``blocks + 1``, scale 1."""
    names = list(names)
    block = re.compile(r"stage(\d+)\.blocks\.(\d+)\.")
    stage_blocks: Dict[int, int] = {}
    for n in names:
        m = block.search(n)
        if m:
            s, i = int(m.group(1)), int(m.group(2))
            stage_blocks[s] = max(stage_blocks.get(s, 0), i + 1)

    if stage_blocks:
        offsets, total = {}, 0
        for s in sorted(stage_blocks):
            offsets[s] = total
            total += stage_blocks[s]
        top = total + 1
        stem = ("encoder.", "cls_token", "cls_pos", "pos_embed", "patch_embed", "merge")

        def layer_id(name: str) -> int:
            m = block.search(name)
            if m:
                return offsets[int(m.group(1))] + int(m.group(2)) + 1
            return 0 if any(s in name for s in stem) else top
    else:
        top = num_layers

        def layer_id(name: str) -> int:
            if name == "cls_token":
                return 0
            m = re.match(r"blocks\.blocks\.(\d+)\.", name)
            if m:
                return min(int(m.group(1)) + 1, num_layers)
            return num_layers

    return {n: decay ** (top - layer_id(n)) for n in names}


def build_finetune_optimizer(named_params, learning_rate: float, weight_decay: float = 0.05,
                             layer_decay: Optional[float] = 0.75,
                             grad_clip: Optional[float] = None, betas=(0.9, 0.999),
                             accum_steps: int = 1):
    """The HPM finetune optimizer (``gm3d_tpu/train/optim.py::
    build_finetune_optimizer``, reference ``main_finetune.py:359-366``):
    AdamW with torch's default betas, eps 1e-8, decay on >=2-d parameters
    only, clip ``grad_clip`` (none by default), over the layer-decay scales of
    ``layerwise_lr_decay_scales`` (``layer_decay`` None or 1: one scale, 1).

    One parameter group a distinct scale and decay class, each carrying its
    ``lr_scale``; the caller sets ``lr`` to the schedule's rate times it
    (``set_scheduled_lr``). torch's per-group ``lr`` scales both the Adam
    step and the decoupled decay, as the JAX chain scales the combined
    update, so the decay is not scaled again. ``accum_steps > 1`` accumulates
    the MEAN in ``MultiSteps``, outermost, as ``optax.MultiSteps`` is."""
    named = [(n, p) for n, p in named_params if p.requires_grad]
    if layer_decay is not None and layer_decay != 1.0:
        scales = layerwise_lr_decay_scales([n for n, _ in named], layer_decay)
    else:
        scales = {n: 1.0 for n, _ in named}
    groups = []
    for scale in sorted(set(scales.values())):
        for group in _decay_groups([(n, p) for n, p in named if scales[n] == scale],
                                   weight_decay):
            if group["params"]:
                groups.append({**group, "lr": learning_rate * scale, "lr_scale": scale})
    return accumulate(ClippedAdamW(groups, grad_clip=grad_clip, lr=learning_rate,
                                   betas=tuple(betas), eps=1e-8), accum_steps)
