"""Classification finetune, evaluation and voting steps.

Port of ``gm3d_tpu/train/finetune.py`` (reference ``engine_finetune.py:79-218``):
FPS to ``point_all`` -> random subsample to ``npoints`` -> scale-and-translate
-> the ``PointTransformer`` forward in train mode -> cross-entropy -> the
optimizer. As in the JAX package, these steps enter no
``fused_attention_scope`` and run the patch embed as the module (train mode
in the train step): the JAX step routes its attention unfused by measurement,
and calls the fused patch embed only from the pretrain step. A train step
launches the FPS kernel twice (to ``point_all``, then the grouping's) and the
KNN kernel once; so do an evaluation and a voting batch.

The JAX step is one compiled graph; here it runs eagerly and updates the
model and the optimizer in place. Random draws come from a
``torch.Generator`` or are handed in (``draws``), so that a test can feed the
JAX step's own draws.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from gm3d_tpu_torch.data.transforms import scale_and_translate
from gm3d_tpu_torch.ops.fps import fps
from gm3d_tpu_torch.train import losses
from gm3d_tpu_torch.train.optim import global_norm
from gm3d_tpu_torch.train.state import TrainState
from gm3d_tpu_torch.utils.device import resolve_device

METRIC_KEYS = ("loss", "acc", "grad_norm")


def floor_reps(batch: int, batch_floor: int) -> int:
    """Always 1: the JAX package tiles small batches up to a floor to work
    around a TPU compiler fault, which this card does not have."""
    return 1


def point_all_for(npoints: int) -> int:
    """Oversampling table (``engine_finetune.py:117-134``)."""
    table = {1024: 1200, 2048: 2400, 4096: 4800, 8192: 8192}
    if npoints not in table:
        raise ValueError(f"unsupported npoints {npoints}")
    return table[npoints]


def _uniform(generator: Optional[torch.Generator], shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def subsample(generator: Optional[torch.Generator], pts: torch.Tensor, npoints: int,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A random subset of ``npoints`` points of each cloud: the first of the
    points ordered by uniform noise (``np.random.choice`` without
    replacement, ``engine_finetune.py:129-134``). ``noise`` (..., N), if
    given, replaces the draw; leading axes other than the cloud's are
    allowed."""
    if noise is None:
        noise = _uniform(generator, pts.shape[:-1], pts.device)
    order = torch.argsort(noise.to(pts.device), dim=-1, stable=True)[..., :npoints]
    return torch.gather(pts, -2, order.unsqueeze(-1).expand(*order.shape, pts.shape[-1]))


def finetune_draws(generator: Optional[torch.Generator], model: nn.Module, batch: int,
                   num_points: int, npoints: int) -> Dict[str, object]:
    """One train step's random draws, on the generator's device: the
    subsample's noise (batch, points after FPS) where the step subsamples,
    the augmentation's scale and shift (batch, 1, 3), and the two keep masks
    (batch, 256) of the head's dropouts, each unit kept with probability
    ``1 - p``. Stochastic depth draws from the generator inside the forward."""
    dev = generator.device if generator is not None else None
    point_all = point_all_for(npoints)
    total = min(num_points, point_all)
    out: Dict[str, object] = {}
    if total > npoints or total == point_all:
        out["noise"] = _uniform(generator, (batch, total), dev)
    out["scale"] = _uniform(generator, (batch, 1, 3), dev) * (3.0 / 2.0 - 2.0 / 3.0) + 2.0 / 3.0
    out["shift"] = _uniform(generator, (batch, 1, 3), dev) * 0.4 - 0.2
    p = next(layer.p for layer in model.cls_head_finetune if isinstance(layer, nn.Dropout))
    out["dropout"] = tuple(_uniform(generator, (batch, 256), dev) >= p for _ in range(2))
    return out


def make_finetune_train_step(model: nn.Module, optimizer, npoints: int = 1024,
                             smoothing: float = 0.0, augment: bool = True,
                             device="cuda") -> Callable:
    """Build ``step(state, pts, labels, generator, draws=None)``.

    1. FPS to ``point_all_for(npoints)`` where the cloud is larger;
    2. the subsample to ``npoints`` where the cloud is still larger, or is
       exactly ``point_all`` points (the JAX condition);
    3. ``scale_and_translate`` when ``augment``;
    4. the train-mode forward (BatchNorm batch statistics, the head's
       dropout, stochastic depth drawn from ``generator``);
    5. cross-entropy with ``smoothing``, accuracy in percent;
    6. the optimizer (its clip, layer decay and accumulation are its own).

    ``draws`` (``finetune_draws``'s: ``noise`` (B, N') where the step
    subsamples, ``scale``, ``shift`` (B, 1, 3), ``dropout``, the head's two
    keep masks) replaces the draws, which are otherwise made by
    ``finetune_draws`` from ``generator``. Returns ``(state, {"loss", "acc", "grad_norm"})``, 0-d
    tensors on the device; ``grad_norm`` is the micro-batch's, before any
    clip."""
    dev = resolve_device(device)
    point_all = point_all_for(npoints)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(state: TrainState, pts: torch.Tensor, labels: torch.Tensor,
             generator: Optional[torch.Generator],
             draws: Optional[Mapping[str, object]] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.student is not model or state.optimizer is not optimizer:
            raise ValueError("the step was built for another model or optimizer")
        pts, labels = pts.to(dev), labels.to(dev)
        if draws is None:
            draws = finetune_draws(generator, model, pts.shape[0], pts.shape[1], npoints)
        with torch.no_grad():
            x = pts
            if x.shape[1] > point_all:
                x = fps(x, point_all)
            if x.shape[1] > npoints or x.shape[1] == point_all:
                x = subsample(None, x, npoints, noise=draws["noise"])
            if augment:
                x = scale_and_translate(None, x, scale=draws["scale"], shift=draws["shift"])
        model.train()
        logits = model(x, [m.to(dev) for m in draws["dropout"]], generator=generator)
        loss, acc = losses.classification_loss(logits, labels, smoothing)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = global_norm(p.grad for p in params if p.grad is not None)
        optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "acc": acc, "grad_norm": grad_norm}

    return step


def make_finetune_multi_step(step_fn: Callable) -> Callable:
    """``multi(state, pts_stack, labels_stack, generator)``: K calls of
    ``step_fn`` over the K batches of ``pts_stack`` (K, B, N, 3), in order (a
    ``lax.scan`` in the JAX package; the port's step runs eagerly, so this is
    a loop and saves no dispatch). Returns the final state and each metric
    stacked over the K steps, as the scan returns them."""

    def multi(state: TrainState, pts_stack: torch.Tensor, labels_stack: torch.Tensor,
              generator: Optional[torch.Generator]):
        history = []
        for k in range(pts_stack.shape[0]):
            state, metrics = step_fn(state, pts_stack[k], labels_stack[k], generator)
            history.append(metrics)
        return state, {n: torch.stack([m[n] for m in history]) for n in history[0]}

    return multi


@contextlib.contextmanager
def _eval_mode(model: nn.Module):
    """The model in eval mode and without gradient, its mode put back after."""
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(training)


def make_eval_step(model: nn.Module, npoints: int = 1024, device="cuda") -> Callable:
    """Build ``step(pts) -> logits``: the validation forward
    (``engine_finetune.py:186-218``): FPS straight to ``npoints`` where the
    cloud is larger, no augmentation, eval mode (running BatchNorm
    statistics, no dropout)."""
    dev = resolve_device(device)

    def step(pts: torch.Tensor) -> torch.Tensor:
        pts = pts.to(dev)
        with _eval_mode(model):
            x = fps(pts, npoints) if pts.shape[1] > npoints else pts
            return model(x)

    return step


def vote_draws(generator: Optional[torch.Generator], times: int, batch: int,
               num_points: int) -> Dict[str, torch.Tensor]:
    """One voting batch's draws: the subsample's noise (times, batch,
    points) and the augmentation's scale and shift (times, batch, 1, 3)."""
    dev = generator.device if generator is not None else None
    return {"noise": _uniform(generator, (times, batch, num_points), dev),
            "scale": _uniform(generator, (times, batch, 1, 3), dev)
            * (3.0 / 2.0 - 2.0 / 3.0) + 2.0 / 3.0,
            "shift": _uniform(generator, (times, batch, 1, 3), dev) * 0.4 - 0.2}


def make_vote_eval_step(model: nn.Module, npoints: int = 1024, times: int = 10,
                        device="cuda") -> Callable:
    """Build ``step(pts, generator, draws=None) -> logits``: the voting
    evaluation (``tools/runner_finetune.py:271-333``): FPS once to
    ``point_all``, then ``times`` random subsamples to ``npoints``, each
    scaled and translated, and the mean of their logits.

    The JAX step maps the votes with ``jax.vmap``, as one batch; here the
    ``times`` subsampled batches are stacked into ONE eval-mode forward of
    ``times * B`` clouds (eval mode makes every cloud's logits independent
    of the others in its batch). ``draws`` may hold ``noise`` (times, B, N'),
    ``scale`` and ``shift`` (times, B, 1, 3) (``vote_draws``)."""
    dev = resolve_device(device)
    point_all = point_all_for(npoints)

    def step(pts: torch.Tensor, generator: Optional[torch.Generator],
             draws: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        pts = pts.to(dev)
        with _eval_mode(model):
            x_all = fps(pts, point_all) if pts.shape[1] > point_all else pts
            batch, total = x_all.shape[:2]
            d = dict(draws) if draws else vote_draws(generator, times, batch, total)
            x = subsample(None, x_all.unsqueeze(0).expand(times, -1, -1, -1), npoints,
                          noise=d["noise"])
            x = x * d["scale"].to(x) + d["shift"].to(x)
            logits = model(x.reshape(times * batch, npoints, 3))
            return logits.reshape(times, batch, -1).mean(dim=0)

    return step
