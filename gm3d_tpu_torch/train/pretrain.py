"""The GM3D pretrain step.

Port of ``gm3d_tpu/train/pretrain.py::gm3d_forward_distill`` and
``::make_gm3d_train_step`` in the default set-up (shared optimizer). One
step:

  1. augment            (``scale_and_translate``)
  2. ONE grouping       (FPS + KNN kernels), shared by the three passes
  3. fused patch embed  for the two grad-free passes (EMA, teacher)
  4. EMA forward, unmasked, eval mode -> per-group predicted loss
  5. geometric mask     (top ``keep_ratio`` by predicted loss + random fill)
  6. student forward    (visible tokens only) and backward
  7. frozen teacher     features + decoder replay, no gradient
  8. feature MSE + Chamfer matrix, relative learning loss
  9. AdamW (clipped), then the EMA update of parameters and BN buffers

The JAX step is one compiled graph over an immutable state; here the step
runs eagerly and updates the student, the EMA copy and the optimizer in
place. The epoch-dependent knobs (``ema_decay``, ``keep_ratio``, ``w_mse``,
``w_cd``) stay call-time arguments (``scalars``). Random draws come from a
``torch.Generator`` or are handed in (``draws``), so that a test can feed the
JAX step's own draws.

Not ported yet (each raises ``NotImplementedError``): ``shared_opt=False``,
``distill_mode='clip'``, ``quantize_ema``, ``remat_student``,
``accum_steps > 1``, the multi-step scan and the other train steps of the
JAX module.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from gm3d_tpu_torch.data.transforms import scale_and_translate
from gm3d_tpu_torch.masking import geometric_mask, gm3d_num_mask
from gm3d_tpu_torch.models.blocks import fused_attention_scope
from gm3d_tpu_torch.models.gm3d import GM3DStudent
from gm3d_tpu_torch.models.pointmae import PointMAE, take_groups
from gm3d_tpu_torch.ops.group import Grouped, group_points
from gm3d_tpu_torch.ops.patch_embed import fused_patch_embed, params_from_module
from gm3d_tpu_torch.train import losses
from gm3d_tpu_torch.train.optim import global_norm
from gm3d_tpu_torch.train.state import TrainState, ema_update
from gm3d_tpu_torch.utils.device import resolve_device

METRIC_KEYS = ("loss", "loss_recon", "loss_mse", "loss_chfr", "loss_learn", "grad_norm")


def gm3d_forward_distill(student: GM3DStudent, teacher: PointMAE, samples: torch.Tensor,
                         mask: torch.Tensor, num_mask: int, shared_learnable_tokens: bool,
                         grouped: Optional[Grouped] = None, detach_loss_pred: bool = False,
                         teacher_tokens: Optional[torch.Tensor] = None,
                         fused_teacher_attention: bool = False,
                         generator: Optional[torch.Generator] = None,
                         mark: Callable[[str], None] = lambda stage: None):
    """Student forward + frozen-teacher complete-to-partial replay.

    The teacher encodes the FULL cloud; its decoder replays (a) its own
    features at all centers -> point_target and (b) the student's predicted
    masked features at the masked centers -> point_reconstructed. The whole
    teacher block runs without gradient. The student runs in whatever mode
    (train / eval) it is in; the caller's ``fused_attention_scope`` applies
    to it, ``fused_teacher_attention`` to the teacher. ``mark(stage)`` is
    called when a stage has been enqueued (``scripts/profile_pretrain.py``)."""
    outs = student(samples, mask, num_mask, shared_learnable_tokens, grouped=grouped,
                   detach_loss_pred_branch=detach_loss_pred, generator=generator)
    mark("student_forward")
    same_grouping = (teacher.num_group == student.num_group
                     and teacher.group_size == student.group_size)
    teacher_grouped = grouped if same_grouping else None
    pred_masked = outs["pix_pred"][:, -num_mask:] if num_mask else outs["pix_pred"]
    with torch.no_grad(), fused_attention_scope(fused_teacher_attention):
        teacher_feats = teacher.encode_features(
            samples, grouped=teacher_grouped,
            tokens=teacher_tokens if teacher_grouped is not None else None)  # (B, G, D)
        centers = outs["center"]
        point_target = teacher.decode_replay(teacher_feats, centers)  # (B, G, S, 3)
        centers_masked = take_groups(centers, outs["mask_idx"])
        point_reco = teacher.decode_replay(pred_masked.detach(), centers_masked)  # (B, M, S, 3)
    mark("teacher")
    return outs, teacher_feats, point_target, point_reco, pred_masked


def make_gm3d_train_step(student: GM3DStudent, teacher: Optional[PointMAE],
                         optimizer: torch.optim.Optimizer, mask_ratio: float = 0.6,
                         shared_learnable_tokens: bool = False, relative: bool = True,
                         augment: bool = True, distill_mode: str = "dino",
                         shared_opt: bool = True, use_fused_embed: bool = True,
                         accum_steps: int = 1, trim_ema: bool = True,
                         remat_student: bool = False, quantize_ema: bool = False,
                         use_fused_attention: bool = True,
                         device="cuda") -> Callable:
    """Build ``step(state, pts, generator, scalars, draws=None, mark=None)``.

    ``student`` and ``optimizer`` must be the ones in the ``TrainState`` the
    step is called with; ``teacher`` is frozen (eval mode, no gradient).
    ``device``: where the step runs; the default needs a GPU and raises
    without one, ``"cpu"`` must be asked for. The models are expected there.

    ``distill_mode``: 'dino' = frozen Point-MAE teacher; 'ema' = feature
    targets from the EMA's unmasked features, no teacher replay; 'none' =
    usual-mode Chamfer only.

    ``step`` returns ``(state, metrics)``: the six scalars of the JAX step as
    0-d tensors on the device (no host synchronisation inside the step).
    ``draws`` may hold ``scale``, ``shift`` (B, 1, 3) and ``noise`` (B, G).
    ``mark(stage)``, if given, is called each time a stage of the step has
    been enqueued (``scripts/profile_pretrain.py`` records CUDA events there).
    """
    if not shared_opt:
        raise NotImplementedError(
            "shared_opt=False (two optimizers, gm3d_separated_loss) is not ported yet")
    if distill_mode == "clip":
        raise NotImplementedError("distill_mode='clip' waits for the port of models/clip.py")
    if quantize_ema:
        raise NotImplementedError("quantize_ema waits for the port of serve/quantize.py")
    if remat_student:
        raise NotImplementedError("remat_student (activation checkpointing) is not ported yet")
    if accum_steps > 1:
        raise NotImplementedError("accum_steps > 1 (gradient accumulation) is not ported yet")
    if distill_mode not in ("dino", "ema", "none"):
        raise ValueError(f"distill_mode must be 'dino', 'ema', 'none' or 'clip', "
                         f"got {distill_mode!r}")
    dev = resolve_device(device)
    num_mask = gm3d_num_mask(student.num_group, mask_ratio)
    use_distill = teacher is not None and distill_mode == "dino"
    use_ema_feats = distill_mode == "ema"
    if teacher is not None:
        teacher.eval()
        for p in teacher.parameters():
            p.requires_grad_(False)
    trainable = [p for p in student.parameters() if p.requires_grad]

    def step(state: TrainState, pts: torch.Tensor, generator: Optional[torch.Generator],
             scalars: Mapping[str, float],
             draws: Optional[Mapping[str, torch.Tensor]] = None,
             mark: Optional[Callable[[str], None]] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.student is not student or state.optimizer is not optimizer:
            raise ValueError("the step was built for another student or optimizer")
        draws = draws or {}
        mark = mark or (lambda stage: None)
        pts = pts.to(dev)
        ema: nn.Module = state.ema
        with torch.no_grad():
            samples = (scale_and_translate(generator, pts, scale=draws.get("scale"),
                                           shift=draws.get("shift")) if augment else pts)
            batch = samples.shape[0]
            # ONE deterministic grouping, shared by EMA / student / teacher
            grouped = group_points(samples, student.num_group, student.group_size)
            mark("augment_group")

            ema_tokens = teacher_tokens = None
            if use_fused_embed:
                ema_tokens = fused_patch_embed(
                    grouped.neighborhood, params_from_module(ema.MAE_encoder.encoder))
                if use_distill:
                    teacher_tokens = fused_patch_embed(
                        grouped.neighborhood, params_from_module(teacher.MAE_encoder.encoder))

            mark("patch_embed")

            # EMA forward on the unmasked cloud (eval mode). loss_pred_only:
            # this pass exists to feed the mask (and, in 'ema' mode, the
            # feature targets); its reconstruction decoder is dead compute
            zeros_mask = torch.zeros((batch, student.num_group), dtype=torch.bool, device=dev)
            with fused_attention_scope(use_fused_attention):
                outs_ema = ema(samples, zeros_mask, 0, shared_learnable_tokens,
                               grouped=grouped, tokens=ema_tokens, loss_pred_only=trim_ema)
            mask = geometric_mask(generator, outs_ema["loss_pred"], num_mask,
                                  scalars["keep_ratio"], noise=draws.get("noise"))
            mark("ema_forward_mask")

        student.train()
        with fused_attention_scope(use_fused_attention):
            if use_distill:
                outs, teacher_feats, point_target, point_reco, pred_masked = (
                    gm3d_forward_distill(
                        student, teacher, samples, mask, num_mask, shared_learnable_tokens,
                        grouped=grouped, teacher_tokens=teacher_tokens,
                        fused_teacher_attention=use_fused_attention, generator=generator,
                        mark=mark))
                loss_outs = losses.gm3d_feature_loss(
                    pred_masked, teacher_feats, outs["mask_idx"], point_target, point_reco)
            else:
                outs = student(samples, mask, num_mask, shared_learnable_tokens,
                               grouped=grouped, generator=generator)
                mark("student_forward")
                if use_ema_feats:
                    # feature targets from the EMA's unmasked pass: normalised
                    # feature MSE at masked slots, no point-space replay
                    target = take_groups(outs_ema["features"].detach(), outs["mask_idx"])
                    mse = losses._normalized_feature_mse(outs["pix_pred"][:, -num_mask:], target)
                    loss_outs = {"MSE_mean": mse.mean(),
                                 "Chamfer_mean": torch.zeros((), device=dev), "matrix": mse}
                else:
                    loss_outs = losses.gm3d_usual_loss(
                        outs["rebuild_points"][:, -num_mask:], outs["neighborhood"],
                        outs["mask_idx"])

            loss = (scalars["w_mse"] * loss_outs["MSE_mean"]
                    + scalars["w_cd"] * loss_outs["Chamfer_mean"])
            loss_pred_masked = outs["loss_pred"][:, -num_mask:]
            matrix = loss_outs["matrix"].detach()
            if relative:
                loss_learn = losses.relative_learning_loss(loss_pred_masked, matrix)
            else:
                loss_learn = losses.mse_learning_loss(loss_pred_masked, matrix)
            total = loss + loss_learn
            mark("losses")
            optimizer.zero_grad(set_to_none=True)
            total.backward()
            mark("backward")

        # the norm over every trainable parameter, a missing gradient as zero
        grad_norm = global_norm(p.grad for p in trainable if p.grad is not None)
        optimizer.step()
        ema_update(ema, student, scalars["ema_decay"])
        state.step += 1
        mark("optimizer_ema")
        metrics = {
            "loss": total.detach(),
            "loss_recon": loss.detach(),
            "loss_mse": loss_outs["MSE_mean"].detach(),
            "loss_chfr": loss_outs["Chamfer_mean"].detach(),
            "loss_learn": loss_learn.detach(),
            "grad_norm": grad_norm,
        }
        step.last_mask = mask
        return state, metrics

    step.num_mask = num_mask
    step.last_mask = None
    return step


def make_multi_step(*args, **kwargs):
    raise NotImplementedError(
        "make_multi_step (several steps in one dispatch) is not ported yet: "
        "the torch step runs eagerly and has no dispatch to amortise")


def _not_ported(name: str):
    def raiser(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet")

    raiser.__name__ = name
    return raiser


make_pointmae_train_step = _not_ported("make_pointmae_train_step")
make_m2ae_train_step = _not_ported("make_m2ae_train_step")
make_m2ae_gm3d_train_step = _not_ported("make_m2ae_gm3d_train_step")
make_probe_step = _not_ported("make_probe_step")
