"""Part-segmentation train and eval steps.

Port of ``gm3d_tpu/train/segmentation.py``: per-point cross-entropy over the
50 part labels after ``scale_and_translate`` (the one augmentation of the
reference's seg engine); evaluation restricts the arg-max to the parts of
the ground-truth category (the published ShapeNetPart protocol) and reports
Point-MAE's part mIoU.

As in the JAX package, these steps enter no ``fused_attention_scope`` (the
JAX seg step is not fused-attention routed, ``gm3d_tpu/train/segmentation.py:
71-73``) and run the patch embed as the module. A train step and an eval
batch launch the FPS kernel once (the grouping's, 2,048 -> 128 centers: the
input is the model's point count, so there is no FPS to ``point_all``) and the
KNN kernel twice: the grouping's (k 32) and the feature propagation's (k 3,
every point on the 128 centers, with distances).

The JAX step is one compiled graph; here it runs eagerly and updates the
model and the optimizer in place. Its draws (the augmentation's scale and
shift, the head's dropout keep mask) come from a ``torch.Generator`` or are
handed in (``draws``), so that a test can feed the JAX step's own draws.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from gm3d_tpu_torch.data.transforms import scale_and_translate
from gm3d_tpu_torch.eval.metrics import part_miou
from gm3d_tpu_torch.models.segmentation import HEAD_WIDTH
from gm3d_tpu_torch.parallel.context import draw_rows
from gm3d_tpu_torch.parallel.mesh import mean_over_ranks, reduce_gradients, run_eval_batch
from gm3d_tpu_torch.train import losses
from gm3d_tpu_torch.train.finetune import _eval_mode, make_finetune_multi_step
from gm3d_tpu_torch.train.state import TrainState
from gm3d_tpu_torch.utils.device import resolve_device
from gm3d_tpu_torch.utils.pipeline import DeferredMetrics

METRIC_KEYS = ("loss", "acc")


def seg_draws(generator: Optional[torch.Generator], model: nn.Module, batch: int,
              num_points: int) -> Dict[str, torch.Tensor]:
    """One train step's random draws, on the generator's device: the
    augmentation's scale and shift (batch, 1, 3) and the keep mask (batch,
    points, 512) of the head's dropout, each unit kept with probability
    ``1 - p``. Stochastic depth draws from the generator inside the forward."""
    dev = generator.device if generator is not None else None

    def uniform(shape):
        return draw_rows(lambda s: torch.rand(s, generator=generator, device=dev), shape)

    return {"scale": uniform((batch, 1, 3)) * (3.0 / 2.0 - 2.0 / 3.0) + 2.0 / 3.0,
            "shift": uniform((batch, 1, 3)) * 0.4 - 0.2,
            "dropout": uniform((batch, num_points, HEAD_WIDTH)) >= model.dropout.p}


def make_seg_train_step(model: nn.Module, optimizer, augment: bool = True,
                        batch_floor: int = 0, device="cuda") -> Callable:
    """Build ``step(state, pts, cls_label, seg_label, generator, draws=None)``:
    ``scale_and_translate`` when ``augment``, the train-mode forward
    (BatchNorm batch statistics, the head's dropout, stochastic depth drawn
    from ``generator``), per-point cross-entropy, the optimizer (its clip is
    its own). ``draws`` (``seg_draws``'s) replaces the draws. Returns
    ``(state, {"loss", "acc"})``, 0-d tensors on the device, ``acc`` in
    percent. ``batch_floor`` is accepted and ignored: the JAX package tiles
    small batches up to it to work around a TPU compiler fault."""
    dev = resolve_device(device)

    def step(state: TrainState, pts: torch.Tensor, cls_label: torch.Tensor,
             seg_label: torch.Tensor, generator: Optional[torch.Generator],
             draws: Optional[Mapping[str, torch.Tensor]] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.student is not model or state.optimizer is not optimizer:
            raise ValueError("the step was built for another model or optimizer")
        pts, cls_label, seg_label = pts.to(dev), cls_label.to(dev), seg_label.to(dev)
        if draws is None:
            draws = seg_draws(generator, model, pts.shape[0], pts.shape[1])
        x = pts
        if augment:
            with torch.no_grad():
                x = scale_and_translate(None, pts, scale=draws["scale"], shift=draws["shift"])
        model.train()
        logits = model(x, cls_label, draws["dropout"].to(dev), generator=generator)
        loss, acc = losses.classification_loss(logits, seg_label)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        reduce_gradients(optimizer, [p for p in model.parameters() if p.requires_grad])
        optimizer.step()
        state.step += 1
        return state, mean_over_ranks({"loss": loss.detach(), "acc": acc})

    return step


# ``multi(state, pts_stack, cls_stack, seg_stack, generator)``: the
# finetune step's loop, over three stacks here
make_seg_multi_step = make_finetune_multi_step


def make_seg_eval_step(model: nn.Module, batch_floor: int = 0, device="cuda") -> Callable:
    """Build ``step(pts, cls_label) -> logits`` (B, N, num_parts): eval mode
    (running BatchNorm statistics, no dropout), no augmentation, no
    gradient. ``batch_floor`` is ignored (see ``make_seg_train_step``)."""
    dev = resolve_device(device)

    def step(pts: torch.Tensor, cls_label: torch.Tensor) -> torch.Tensor:
        with _eval_mode(model):
            return model(pts.to(dev), cls_label.to(dev))

    return step


def category_restricted_argmax(logits: np.ndarray, cls_labels: np.ndarray,
                               seg_classes: Mapping[str, Sequence[int]],
                               cls_names: Sequence[str]) -> np.ndarray:
    """Argmax over only the parts valid for each shape's category; (B, N)
    int64 part labels."""
    pred = np.zeros(logits.shape[:2], np.int64)
    for i in range(logits.shape[0]):
        parts = seg_classes[cls_names[int(cls_labels[i])]]
        sub = logits[i][:, parts]
        pred[i] = np.asarray(parts)[sub.argmax(-1)]
    return pred


def run_seg_val(eval_step: Callable, loader, seg_classes, cls_names,
                depth: int = 4) -> Dict[str, float]:
    """One full pass of the seg eval protocol: the category-restricted arg-max
    of each batch's logits, Point-MAE part mIoU over the set
    (``part_miou``'s dict). The logits of up to ``depth`` batches stay on
    the device while later batches are enqueued (0: each is read at once)."""
    preds, targets, clss = [], [], []

    def drain(logits, cls_np, seg_np):
        preds.append(category_restricted_argmax(
            logits.float().cpu().numpy(), cls_np, seg_classes, cls_names))
        targets.append(seg_np)
        clss.append(cls_np)

    flight = DeferredMetrics(drain, depth=depth)
    for pts, cls_label, seg in loader:
        # under data parallelism each rank computes its rows (gathered)
        logits = run_eval_batch(eval_step, torch.as_tensor(pts), torch.as_tensor(cls_label))
        flight.push(logits, np.asarray(cls_label), np.asarray(seg))
    flight.flush()
    return part_miou(np.concatenate(preds), np.concatenate(targets),
                     np.concatenate(clss), seg_classes, cls_names)
