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

Few-shot folds train together (``cli/fewshot.py``, the JAX CLI's
``jax.vmap`` of these steps over its folds): ``FoldedModel`` holds F copies of
one classifier as parameters and buffers stacked along a leading fold axis
(``torch.func.stack_module_state``), and ``make_fold_batched_train_step`` /
``make_fold_batched_eval_step`` run the steps above under
``torch.func.vmap(functional_call(...))``: each fold's draws from its own
generator, stacked; one backward of the summed losses; the legacy AdamW over
the stacked parameters with each fold clipped by its own norm
(``train/optim.py::FoldClippedAdamW``). FPS and KNN take the fold axis through
their ops' vmap rules, one launch for every fold. Each fold computes what its
own step computes.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.func import functional_call, stack_module_state, vmap
from torch.utils._pytree import tree_map

from gm3d_tpu_torch.data.transforms import scale_and_translate
from gm3d_tpu_torch.models.blocks import draw_depth_masks
from gm3d_tpu_torch.ops.fps import fps
from gm3d_tpu_torch.parallel.context import active, draw_rows
from gm3d_tpu_torch.parallel.mesh import mean_over_ranks, reduce_gradients
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


def _uniform(generator: Optional[torch.Generator], shape, device, dim: int = 0) -> torch.Tensor:
    """Uniform draws whose axis ``dim`` is the batch's (``draw_rows``)."""
    return draw_rows(lambda s: torch.rand(s, generator=generator, device=device), shape, dim)


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
    the augmentation's scale and shift (batch, 1, 3), the two keep masks
    (batch, 256) of the head's dropouts, each unit kept with probability
    ``1 - p``, and last the stochastic-depth keep masks of every block
    (``depth``, ``blocks.draw_depth_masks``), in the order and shape in which
    the forward would draw them from the generator itself. ``model`` is read
    for its structure only (its rates)."""
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
    out["depth"] = draw_depth_masks(generator, model.drop_path_encoders(), batch, dev)
    return out


def _train_inputs(pts: torch.Tensor, draws: Mapping[str, object], npoints: int,
                  augment: bool) -> torch.Tensor:
    """The train step's clouds before the forward: FPS to ``point_all`` where
    larger, the subsample to ``npoints``, the augmentation (steps 1 - 3 of
    ``make_finetune_train_step``)."""
    point_all = point_all_for(npoints)
    with torch.no_grad():
        x = pts
        if x.shape[1] > point_all:
            x = fps(x, point_all)
        if x.shape[1] > npoints or x.shape[1] == point_all:
            x = subsample(None, x, npoints, noise=draws["noise"])
        if augment:
            x = scale_and_translate(None, x, scale=draws["scale"], shift=draws["shift"])
    return x


def make_finetune_train_step(model: nn.Module, optimizer, npoints: int = 1024,
                             smoothing: float = 0.0, augment: bool = True,
                             device="cuda") -> Callable:
    """Build ``step(state, pts, labels, generator, draws=None)``.

    1. FPS to ``point_all_for(npoints)`` where the cloud is larger;
    2. the subsample to ``npoints`` where the cloud is still larger, or is
       exactly ``point_all`` points (the JAX condition);
    3. ``scale_and_translate`` when ``augment``;
    4. the train-mode forward (BatchNorm batch statistics, the head's
       dropout, stochastic depth from the drawn masks);
    5. cross-entropy with ``smoothing``, accuracy in percent;
    6. the optimizer (its clip, layer decay and accumulation are its own).

    ``draws`` (``finetune_draws``'s: ``noise`` (B, N') where the step
    subsamples, ``scale``, ``shift`` (B, 1, 3), ``dropout``, the head's two
    keep masks, and ``depth``, the stochastic-depth masks; without ``depth``
    the forward draws them from ``generator``) replaces the draws, which are
    otherwise made by ``finetune_draws`` from ``generator``. Returns
    ``(state, {"loss", "acc", "grad_norm"})``, 0-d tensors on the device;
    ``grad_norm`` is the micro-batch's, before any clip."""
    dev = resolve_device(device)
    point_all_for(npoints)  # an unsupported npoints raises here, not at the first step
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
        x = _train_inputs(pts, draws, npoints, augment)
        model.train()
        logits = model(x, [m.to(dev) for m in draws["dropout"]], generator=generator,
                       depth_masks=draws.get("depth"))
        loss, acc = losses.classification_loss(logits, labels, smoothing)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        reduce_gradients(optimizer, params)
        grad_norm = global_norm(p.grad for p in params if p.grad is not None)
        optimizer.step()
        state.step += 1
        return state, mean_over_ranks({"loss": loss.detach(), "acc": acc,
                                       "grad_norm": grad_norm})

    return step


def make_finetune_multi_step(step_fn: Callable) -> Callable:
    """``multi(state, *stacks, generator)``: K calls of ``step_fn`` over the
    K batches of the stacks, each (K, B, ...), in order (a ``lax.scan`` in
    the JAX package; the port's step runs eagerly, so this is a loop and
    saves no dispatch). The classification step takes the stacks of points
    and labels, the segmentation step (``train/segmentation.py``) those of
    points, categories and part labels. Returns the final state and each
    metric stacked over the K steps, as the scan returns them."""

    def multi(state: TrainState, *args):
        *stacks, generator = args
        history = []
        for k in range(stacks[0].shape[0]):
            state, metrics = step_fn(state, *(s[k] for s in stacks), generator)
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


class FoldedModel:
    """F copies of one classifier, one a few-shot fold, as ONE model with a
    leading fold axis: ``params`` and ``buffers`` map the module's names to
    the F modules' tensors stacked along axis 0 (``stack_module_state``; the
    parameters leaves that require gradients), on ``device``. ``base`` is a
    copy of the first module on the meta device, which ``functional_call``
    runs with a fold's slice of them; its train / eval flag is the forward's
    mode. The F modules must share one structure; they are not kept."""

    def __init__(self, models: Sequence[nn.Module], device):
        params, buffers = stack_module_state(list(models))
        self.folds = len(models)
        self.params = {n: p.detach().to(device).requires_grad_(p.requires_grad)
                       for n, p in params.items()}
        self.buffers = {n: b.to(device) for n, b in buffers.items()}
        self.base = copy.deepcopy(models[0]).to("meta")

    def __call__(self, params, buffers, *args, **kwargs):
        """One fold's forward: ``base`` on that fold's parameters and buffers."""
        return functional_call(self.base, (params, buffers), args, kwargs)


def _stack(trees: Sequence) -> object:
    """Per-fold trees of tensors (draws) -> one tree of (F, ...) tensors."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def make_fold_batched_train_step(folded: FoldedModel, optimizer, npoints: int = 1024,
                                 smoothing: float = 0.0, augment: bool = True,
                                 device="cuda") -> Callable:
    """Build ``step(state, pts, labels, generators)``: one
    ``make_finetune_train_step`` step for each of the F folds of ``folded``,
    all at once. ``pts`` (F, B, N, 3), ``labels`` (F, B); ``generators``, one
    a fold, each drawing its fold's ``finetune_draws``, in fold order. Steps
    1 - 5 run under
    ``torch.func.vmap`` (random draws there raise: every draw is made before),
    the F losses are summed for one backward, and ``optimizer`` (the legacy
    AdamW with ``fold_axis``: a clip a fold) steps the stacked parameters;
    each fold's BatchNorm running statistics move in place. Returns
    ``(state, {"loss", "acc", "grad_norm"})``, each (F,) on the device.

    A fold is one process's own run: the step runs no data parallelism (the
    few-shot CLI deals whole folds to ranks)."""
    dev = resolve_device(device)
    point_all_for(npoints)  # an unsupported npoints raises here, not at the first step
    base = folded.base

    def fold_loss(params, buffers, pts, labels, draws):
        x = _train_inputs(pts, draws, npoints, augment)
        logits = folded(params, buffers, x, draws["dropout"], depth_masks=draws.get("depth"))
        return losses.classification_loss(logits, labels, smoothing)

    batched = vmap(fold_loss, randomness="error")

    def step(state: TrainState, pts: torch.Tensor, labels: torch.Tensor,
             generators: Sequence[torch.Generator]) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.student is not folded or state.optimizer is not optimizer:
            raise ValueError("the step was built for another model or optimizer")
        if active() is not None:
            raise ValueError("the fold-batched step runs one process's folds: call it "
                             "inside parallel.context.replica_scope()")
        pts, labels = pts.to(dev), labels.to(dev)
        if pts.shape[0] != folded.folds:
            raise ValueError(f"expected the clouds of {folded.folds} folds, got {pts.shape[0]}")
        draws = _stack([finetune_draws(g, base, pts.shape[1], pts.shape[2], npoints)
                        for g in generators])
        base.train()
        loss, acc = batched(folded.params, folded.buffers, pts, labels, draws)
        optimizer.zero_grad(set_to_none=True)
        loss.sum().backward()
        optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "acc": acc, "grad_norm": optimizer.last_grad_norm}

    return step


def make_fold_batched_eval_step(folded: FoldedModel, npoints: int = 1024,
                                device="cuda") -> Callable:
    """Build ``step(pts) -> logits``: ``make_eval_step``'s forward for each
    fold of ``folded`` at once, under ``torch.func.vmap``; ``pts`` (F, B, N,
    3) -> (F, B, classes)."""
    dev = resolve_device(device)

    def fold_logits(params, buffers, pts):
        x = fps(pts, npoints) if pts.shape[1] > npoints else pts
        return folded(params, buffers, x)

    batched = vmap(fold_logits)

    def step(pts: torch.Tensor) -> torch.Tensor:
        with _eval_mode(folded.base):
            return batched(folded.params, folded.buffers, pts.to(dev))

    return step


def vote_draws(generator: Optional[torch.Generator], times: int, batch: int,
               num_points: int) -> Dict[str, torch.Tensor]:
    """One voting batch's draws: the subsample's noise (times, batch,
    points) and the augmentation's scale and shift (times, batch, 1, 3)."""
    dev = generator.device if generator is not None else None
    return {"noise": _uniform(generator, (times, batch, num_points), dev, dim=1),
            "scale": _uniform(generator, (times, batch, 1, 3), dev, dim=1)
            * (3.0 / 2.0 - 2.0 / 3.0) + 2.0 / 3.0,
            "shift": _uniform(generator, (times, batch, 1, 3), dev, dim=1) * 0.4 - 0.2}


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
