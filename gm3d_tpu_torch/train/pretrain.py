"""The pretrain steps: GM3D, the Point-MAE teacher's, and the supervised probe's.

Port of ``gm3d_tpu/train/pretrain.py::make_gm3d_train_step`` (shared or
separated optimizers, gradient accumulation, ``remat_student``, fp32 or bf16
compute; the JAX ``gm3d_forward_distill`` is its steps 6 - 7 here),
``::make_pointmae_train_step``, ``::make_multi_step`` and
``::make_probe_step``. One GM3D step:

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

The Point-M2AE steps, ``::make_m2ae_train_step`` (random coarse mask) and
``::make_m2ae_gm3d_train_step`` (the geometric mask from an EMA loss
predictor and the learning loss), share ONE hierarchy a step (``build_hierarchy``:
three FPS and three KNN launches) between their passes.

``quantize_ema`` runs the EMA pass's dense products as dynamic int8
(``serve/quantize.py::quantized_dense``); the fused patch embed and attention
of that pass stay fp32 on the card, as the JAX step's fused routes do.
``distill_mode='clip'`` replaces step 7 by a frozen CLIP vision tower over
depth renders of the full cloud (``models/clip.py``): one target token a
group, so the fused patch embed runs once a step (the EMA pass's).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gm3d_tpu_torch.data.transforms import scale_and_translate
from gm3d_tpu_torch.masking import block_mask, geometric_mask, gm3d_num_mask, random_mask
from gm3d_tpu_torch.models.blocks import fused_attention_scope
from gm3d_tpu_torch.models.clip import CLIPVisionTower, clip_group_targets
from gm3d_tpu_torch.models.gm3d import GM3DStudent
from gm3d_tpu_torch.models.m2ae import PointM2AE, build_hierarchy
from gm3d_tpu_torch.models.pointmae import PointMAE, take_groups
from gm3d_tpu_torch.ops.chamfer import chamfer_group
from gm3d_tpu_torch.ops.group import Grouped, group_points
from gm3d_tpu_torch.ops.patch_embed import fused_patch_embed, params_from_module
from gm3d_tpu_torch.parallel.context import draw_rows
from gm3d_tpu_torch.parallel.mesh import global_count, mean_over_ranks, reduce_gradients
from gm3d_tpu_torch.serve.quantize import quantized_dense
from gm3d_tpu_torch.train import losses
from gm3d_tpu_torch.train.optim import global_norm
from gm3d_tpu_torch.train.state import TrainState, ema_update
from gm3d_tpu_torch.utils.device import resolve_device
from gm3d_tpu_torch.utils.profiling import step_span

METRIC_KEYS = ("loss", "loss_recon", "loss_mse", "loss_chfr", "loss_learn", "grad_norm")
POINTMAE_METRIC_KEYS = ("loss", "grad_norm")
M2AE_METRIC_KEYS = ("loss", "grad_norm")
M2AE_GM3D_METRIC_KEYS = ("loss", "loss_chfr", "loss_learn", "grad_norm")


def make_pointmae_train_step(model: PointMAE, optimizer: torch.optim.Optimizer,
                             mask_ratio: float = 0.6, mask_type: str = "rand",
                             loss_type: str = "cdl2", augment: bool = True,
                             device="cuda") -> Callable:
    """Build ``step(state, pts, generator, draws=None)``: the legacy
    Point-MAE pretrain step, which trains the distillation teacher.

    Augment (``scale_and_translate``), mask ``int(G * mask_ratio)`` groups
    (Point-MAE's own count, not ``gm3d_num_mask``) at random or as a block
    around a random center, the masked-reconstruction forward in train mode
    (dropout, stochastic depth, BN batch statistics), the Chamfer loss,
    backward and the optimizer. As in the JAX step, no fused attention is
    entered and the patch embed runs in train mode: the step launches the
    FPS and KNN kernels (one grouping; a block mask groups once more) and
    no other.

    ``draws`` may hold ``scale``, ``shift`` (B, 1, 3) and ``noise`` (B, G)
    (the random mask's scores) or ``seed`` (B,) (the block mask's centers).
    Returns ``(state, {"loss", "grad_norm"})``, 0-d tensors on the device.
    """
    if mask_type not in ("rand", "block"):
        raise ValueError(f"mask_type must be 'rand' or 'block', got {mask_type!r}")
    dev = resolve_device(device)
    num_mask = int(model.num_group * mask_ratio)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(state: TrainState, pts: torch.Tensor, generator: Optional[torch.Generator],
             draws: Optional[Mapping[str, torch.Tensor]] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.student is not model or state.optimizer is not optimizer:
            raise ValueError("the step was built for another model or optimizer")
        draws = draws or {}
        pts = pts.to(dev)
        with torch.no_grad():
            samples = (scale_and_translate(generator, pts, scale=draws.get("scale"),
                                           shift=draws.get("shift")) if augment else pts)
            batch = samples.shape[0]
            if mask_type == "rand":
                mask = random_mask(generator, batch, model.num_group, num_mask,
                                   noise=draws.get("noise"), device=dev)
            else:
                centers = group_points(samples, model.num_group, model.group_size).center
                mask = block_mask(generator, centers, num_mask, seed=draws.get("seed"))
        model.train()
        outs = model(samples, mask, num_mask, generator=generator)
        loss = losses.pointmae_reconstruction_loss(outs["rebuild"], outs["gt"], loss_type)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        reduce_gradients(optimizer, params)
        grad_norm = global_norm(p.grad for p in params if p.grad is not None)
        optimizer.step()
        state.step += 1
        return state, mean_over_ranks({"loss": loss.detach(), "grad_norm": grad_norm})

    step.num_mask = num_mask
    return step


def teacher_replay(teacher: PointMAE, samples: torch.Tensor, outs: dict, num_mask: int,
                   grouped: Optional[Grouped] = None,
                   teacher_tokens: Optional[torch.Tensor] = None,
                   fused_teacher_attention: bool = False):
    """The frozen teacher's half of the JAX ``gm3d_forward_distill``, as
    ``make_gm3d_train_step`` runs it on the student's outputs ``outs``: it
    encodes the FULL cloud; its decoder replays (a) its own features at all
    centers -> point_target and (b) the student's predicted masked features
    at the masked centers -> point_reconstructed.
    All without gradient. ``grouped`` (and ``teacher_tokens``, its patch
    embed) only where the teacher groups as the student does. Returns
    ``(teacher_feats, point_target, point_reco, pred_masked)``."""
    pred_masked = outs["pix_pred"][:, -num_mask:] if num_mask else outs["pix_pred"]
    with torch.no_grad(), fused_attention_scope(fused_teacher_attention):
        teacher_feats = teacher.encode_features(
            samples, grouped=grouped,
            tokens=teacher_tokens if grouped is not None else None)  # (B, G, D)
        centers = outs["center"]
        point_target = teacher.decode_replay(teacher_feats, centers)  # (B, G, S, 3)
        centers_masked = take_groups(centers, outs["mask_idx"])
        point_reco = teacher.decode_replay(pred_masked.detach(), centers_masked)  # (B, M, S, 3)
    return teacher_feats, point_target, point_reco, pred_masked


class _Remat:
    """``remat_student``: the student's forward under ``torch.utils.checkpoint``
    (non-reentrant), so its activations are dropped after the forward and
    recomputed in the backward (``jax.checkpoint(loss_fn)`` in the JAX step).

    The recompute must be the same computation, and three things would make
    it another:

      - drop path draws its masks from the step's explicit generator, which
        checkpoint's ``preserve_rng_state`` does not restore (it restores
        only the default generators): every run of the forward starts from
        the generator's state before the first one;
      - the recompute runs on autograd's thread, where the context variable
        of ``fused_attention_scope`` has its default: the forward enters the
        step's attention route itself;
      - the train-mode BatchNorms would move their running statistics a
        second time.

    ``restore()``, called after the backward, puts back the generator's and
    the BatchNorms' state as the first forward left them (a recompute may
    stop early, part-way through the draws)."""

    def __init__(self, module: nn.Module, generator: Optional[torch.Generator],
                 fused_attention: bool):
        self.module, self.generator, self.fused_attention = module, generator, fused_attention
        self.after = None

    def __call__(self, fn: Callable[[], dict]) -> dict:
        gen = self.generator
        before = gen.get_state() if gen is not None else None

        def run():
            if before is not None:
                gen.set_state(before)
            with fused_attention_scope(self.fused_attention):
                return fn()

        outs = checkpoint(run, use_reentrant=False)
        self.after = (gen.get_state() if gen is not None else None,
                      [b.detach().clone() for b in self.module.buffers()])
        return outs

    def restore(self) -> None:
        gen_state, buffers = self.after
        if gen_state is not None:
            self.generator.set_state(gen_state)
        with torch.no_grad():
            for b, saved in zip(self.module.buffers(), buffers):
                b.copy_(saved)
        self.after = None


def make_gm3d_train_step(student: GM3DStudent, teacher: Optional[PointMAE],
                         optimizer, mask_ratio: float = 0.6,
                         shared_learnable_tokens: bool = False, relative: bool = True,
                         augment: bool = True, distill_mode: str = "dino",
                         shared_opt: bool = True, use_fused_embed: bool = True,
                         accum_steps: int = 1, trim_ema: bool = True,
                         remat_student: bool = False, quantize_ema: bool = False,
                         use_fused_attention: bool = True,
                         device="cuda") -> Callable:
    """Build ``step(state, pts, generator, scalars, draws=None)``.

    ``student`` and ``optimizer`` must be the ones in the ``TrainState`` the
    step is called with; ``teacher`` is frozen (eval mode, no gradient).
    ``device``: where the step runs; the default needs a GPU and raises
    without one, ``"cpu"`` must be asked for. The models are expected there,
    in their compute dtype (``--bf16``: bf16 compute, fp32 parameters).

    ``distill_mode``: 'dino' = frozen Point-MAE teacher; 'ema' = feature
    targets from the EMA's unmasked features, no teacher replay; 'clip' =
    feature targets from a frozen ``CLIPVisionTower`` (the ``teacher``, its
    ``output_dim`` the student's ``trans_dim``) over depth renders of the
    full cloud, one patch token a group center (``clip_group_targets``);
    'none' = usual-mode Chamfer only. Under 'ema' and 'clip' the loss is the
    normalised feature MSE at the masked slots and ``loss_chfr`` is 0.

    ``shared_opt=False`` (pair it with ``build_gm3d_separated_optimizer``):
    the loss-prediction branch is detached at the encoder, so one backward
    gives each optimizer its own loss; under 'dino' the separated engine's
    loss (``gm3d_separated_loss``: feature MSE against the teacher's encoder
    plus the student's own Chamfer, no teacher replay), which needs
    ``mode='feature'``.

    ``accum_steps`` (pair it with an optimizer built with the same count):
    the optimizer updates on every ``accum_steps``-th call, and the EMA moves
    on those calls only; the student's BatchNorm statistics move on every
    call. ``remat_student``: the student's activations are recomputed in the
    backward (``_Remat``). ``quantize_ema``: the EMA pass's dense products
    are dynamic int8 (w8a8); only the mask's ranking sees the noise, so it is
    refused with ``distill_mode='ema'``, where the EMA features are targets.
    Gradients, the student and the teacher stay float.

    ``step`` returns ``(state, metrics)``: the six scalars of the JAX step as
    0-d tensors on the device (no host synchronisation inside the step);
    ``grad_norm`` is this call's gradient norm, not the accumulation's.
    ``draws`` may hold ``scale``, ``shift`` (B, 1, 3) and ``noise`` (B, G).
    The step is the span ``step``, its stages the spans ``step.augment_group``,
    ``.patch_embed``, ``.ema_forward_mask``, ``.clip_targets`` (clip),
    ``.student_forward``, ``.teacher`` (dino), ``.losses``, ``.backward`` and
    ``.optimizer_ema``, each from its ``mark`` to the next (``utils/profiling.py``:
    recorded only while a profiler or ``recording()`` is on, the stream's time
    of each stage in ``stage_ms()``).
    """
    if distill_mode not in ("dino", "ema", "none", "clip"):
        raise ValueError(f"distill_mode must be 'dino', 'ema', 'none' or 'clip', "
                         f"got {distill_mode!r}")
    if quantize_ema and distill_mode == "ema":
        raise ValueError(
            "quantize_ema is not allowed with distill_mode='ema': the EMA "
            "features are the distillation targets there, so quantization "
            "noise would enter the loss, not just the mask ranking")
    ema_ctx = quantized_dense if quantize_ema else contextlib.nullcontext
    if getattr(optimizer, "accum_steps", 1) != accum_steps:
        raise ValueError(f"the step accumulates {accum_steps} micro-batches, the optimizer "
                         f"{getattr(optimizer, 'accum_steps', 1)}")
    dev = resolve_device(device)
    num_mask = gm3d_num_mask(student.num_group, mask_ratio)
    use_distill = teacher is not None and distill_mode == "dino"
    # the separated engine's loss: feature MSE against the teacher's encoder and
    # the student's own Chamfer, inside the gradient; no teacher replay
    use_sep_distill = use_distill and not shared_opt
    if use_sep_distill and student.mode != "feature":
        raise ValueError(
            "--no-shared_opt with distill_mode='dino' requires mode='feature' "
            "(the separated loss consumes decoder features; use "
            "distill_mode='none' for usual mode)")
    use_ema_feats = distill_mode == "ema"
    use_clip = distill_mode == "clip"
    if use_clip:
        if not isinstance(teacher, CLIPVisionTower):
            raise ValueError("distill_mode='clip' needs a CLIPVisionTower teacher")
        if teacher.output_dim != student.trans_dim:
            raise ValueError(f"CLIP output_dim {teacher.output_dim} must match student "
                             f"trans_dim {student.trans_dim} for the feature MSE")
    # two optimizers: the learning loss must not reach the encoder
    detach_lp = not shared_opt
    same_grouping = use_distill and (teacher.num_group == student.num_group
                                     and teacher.group_size == student.group_size)
    if teacher is not None:
        teacher.eval()
        for p in teacher.parameters():
            p.requires_grad_(False)
    trainable = [p for p in student.parameters() if p.requires_grad]

    def step(state: TrainState, pts: torch.Tensor, generator: Optional[torch.Generator],
             scalars: Mapping[str, float],
             draws: Optional[Mapping[str, torch.Tensor]] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with step_span(dev) as st:
            state, metrics = _step(st.mark, state, pts, generator, scalars, draws or {})
        return state, mean_over_ranks(metrics)

    def _step(mark, state, pts, generator, scalars, draws):
        if state.student is not student or state.optimizer is not optimizer:
            raise ValueError("the step was built for another student or optimizer")
        mark("augment_group")
        pts = pts.to(dev)
        ema: nn.Module = state.ema
        with torch.no_grad():
            samples = (scale_and_translate(generator, pts, scale=draws.get("scale"),
                                           shift=draws.get("shift")) if augment else pts)
            batch = samples.shape[0]
            # ONE deterministic grouping, shared by EMA / student / teacher
            grouped = group_points(samples, student.num_group, student.group_size)
            mark("patch_embed")

            ema_tokens = teacher_tokens = None
            if use_fused_embed:
                ema_tokens = fused_patch_embed(
                    grouped.neighborhood, params_from_module(ema.MAE_encoder.encoder))
                if use_distill:
                    teacher_tokens = fused_patch_embed(
                        grouped.neighborhood, params_from_module(teacher.MAE_encoder.encoder))

            mark("ema_forward_mask")

            # EMA forward on the unmasked cloud (eval mode). loss_pred_only:
            # this pass exists to feed the mask (and, in 'ema' mode, the
            # feature targets); its reconstruction decoder is dead compute
            zeros_mask = torch.zeros((batch, student.num_group), dtype=torch.bool, device=dev)
            with ema_ctx(), fused_attention_scope(use_fused_attention):
                outs_ema = ema(samples, zeros_mask, 0, shared_learnable_tokens,
                               grouped=grouped, tokens=ema_tokens, loss_pred_only=trim_ema)
            mask = geometric_mask(generator, outs_ema["loss_pred"], num_mask,
                                  scalars["keep_ratio"], noise=draws.get("noise"))
            mark("clip_targets" if use_clip else "student_forward")
            if use_clip:
                # the frozen tower over renders of the full cloud: (B, G, D)
                clip_targets = clip_group_targets(teacher, samples, grouped.center)
                mark("student_forward")

        student.train()
        remat = _Remat(student, generator, use_fused_attention) if remat_student else None

        def student_forward() -> dict:
            return student(samples, mask, num_mask, shared_learnable_tokens, grouped=grouped,
                           detach_loss_pred_branch=detach_lp, generator=generator)

        with fused_attention_scope(use_fused_attention):
            outs = remat(student_forward) if remat is not None else student_forward()
            mark("teacher" if use_distill else "losses")
            if use_sep_distill:
                with torch.no_grad():
                    teacher_feats = teacher.encode_features(
                        samples, grouped=grouped if same_grouping else None,
                        tokens=teacher_tokens if same_grouping else None)
                mark("losses")
                loss_outs = losses.gm3d_separated_loss(
                    outs["pix_pred"][:, -num_mask:], teacher_feats, outs["mask_idx"],
                    outs["rebuild_points"][:, -num_mask:], outs["neighborhood"])
            elif use_distill:
                teacher_feats, point_target, point_reco, pred_masked = teacher_replay(
                    teacher, samples, outs, num_mask, grouped if same_grouping else None,
                    teacher_tokens, use_fused_attention)
                mark("losses")
                loss_outs = losses.gm3d_feature_loss(
                    pred_masked, teacher_feats, outs["mask_idx"], point_target, point_reco)
            elif use_ema_feats or use_clip:
                # feature targets from the EMA's unmasked pass or the CLIP
                # tower: normalised feature MSE at masked slots (in fp32), no
                # point-space replay
                target = take_groups(clip_targets if use_clip else outs_ema["features"].detach(),
                                     outs["mask_idx"])
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
            mark("backward")
            # every parameter's, also those no optimizer owns (grad_norm reads them)
            student.zero_grad(set_to_none=True)
            total.backward()
            if remat is not None:
                remat.restore()
            reduce_gradients(optimizer, trainable)
            mark("optimizer_ema")

        # the norm over every trainable parameter, a missing gradient as zero
        grad_norm = global_norm(p.grad for p in trainable if p.grad is not None)
        optimizer.step()
        # under accumulation the EMA moves on the update's call only (its
        # decay is 1 on the others in the JAX step)
        if (state.step + 1) % accum_steps == 0:
            ema_update(ema, student, scalars["ema_decay"])
        state.step += 1
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


def make_multi_step(step_fn: Callable, has_scalars: bool = True) -> Callable:
    """``multi(state, pts_stack, generator, scalars=None, draws=None)``: K
    calls of ``step_fn`` over the K batches of ``pts_stack`` (K, B, N, 3), in
    order (``gm3d_tpu/train/pretrain.py::make_multi_step``, a ``lax.scan``
    there; the port's step runs eagerly, so this is a loop and saves no
    dispatch). ``has_scalars``: the GM3D step takes ``scalars``, the
    teacher's does not. ``draws``, if given, holds each draw stacked on a
    leading K axis. Returns the final state and each metric stacked over the
    K steps, as the scan returns them."""

    def multi(state: TrainState, pts_stack: torch.Tensor,
              generator: Optional[torch.Generator], scalars=None,
              draws: Optional[Mapping[str, torch.Tensor]] = None):
        history = []
        for k in range(pts_stack.shape[0]):
            step_draws = None if draws is None else {n: v[k] for n, v in draws.items()}
            extra = (scalars,) if has_scalars else ()
            state, metrics = step_fn(state, pts_stack[k], generator, *extra, draws=step_draws)
            history.append(metrics)
        return state, {n: torch.stack([m[n] for m in history]) for n in history[0]}

    return multi


def m2ae_losses(model: PointM2AE, outs: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Chamfer loss over the masked finest groups, and the loss matrix
    (B, G_last): each coarsest group's mean over the masked finest groups
    whose nearest coarsest center it is (``_m2ae_losses`` of the JAX module)."""
    per_fine = chamfer_group(outs["rebuild"].to(torch.float32),
                             outs["gt"].to(torch.float32))  # (B, G_0)
    w = (~outs["fine_vis"]).to(torch.float32)
    # the masked groups of the whole batch, under data parallelism too
    loss = (per_fine * w).sum() / global_count(w.sum())
    coarse = torch.zeros((w.shape[0], model.num_groups[-1]), dtype=torch.float32,
                         device=w.device)
    index = outs["fine_to_coarse"].long()
    num = coarse.scatter_add(1, index, per_fine * w)
    den = coarse.scatter_add(1, index, w).clamp_min(1.0)
    return loss, num / den


def _step_all(optimizer, params) -> None:
    """optax steps every parameter, a missing gradient as zero (its decay
    included): so does the port's step (``SeparatedAdamW.step`` does the same)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    optimizer.step()


def make_m2ae_train_step(model: PointM2AE, optimizer, mask_ratio: float = 0.8,
                         augment: bool = True, device="cuda") -> Callable:
    """Build ``step(state, pts, generator, draws=None)``: the Point-M2AE
    pretrain step. Augment, a random mask of ``int(G_last * mask_ratio)``
    coarsest groups, ONE hierarchy, the masked reconstruction in train mode,
    the Chamfer loss over the masked finest groups, backward, the optimizer.

    ``draws`` may hold ``scale``, ``shift`` (B, 1, 3) and ``noise`` (B,
    G_last). Launches FPS 3 and KNN 6 a step (the hierarchy's 3, the
    forward's k = 1 maps 3) and no attention kernel. Returns ``(state,
    {"loss", "grad_norm"})``, 0-d tensors on the device."""
    dev = resolve_device(device)
    coarse_groups = model.num_groups[-1]
    num_mask = int(coarse_groups * mask_ratio)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(state: TrainState, pts: torch.Tensor, generator: Optional[torch.Generator],
             draws: Optional[Mapping[str, torch.Tensor]] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.student is not model or state.optimizer is not optimizer:
            raise ValueError("the step was built for another model or optimizer")
        draws = draws or {}
        pts = pts.to(dev)
        with torch.no_grad():
            samples = (scale_and_translate(generator, pts, scale=draws.get("scale"),
                                           shift=draws.get("shift")) if augment else pts)
            coarse_vis = ~random_mask(generator, samples.shape[0], coarse_groups, num_mask,
                                      noise=draws.get("noise"), device=dev)
            hierarchy = build_hierarchy(samples, model.num_groups, model.group_sizes)
        model.train()
        outs = model(samples, coarse_vis, hierarchy, generator)
        loss, _ = m2ae_losses(model, outs)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        reduce_gradients(optimizer, params)
        grad_norm = global_norm(p.grad for p in params if p.grad is not None)
        _step_all(optimizer, params)
        state.step += 1
        return state, mean_over_ranks({"loss": loss.detach(), "grad_norm": grad_norm})

    step.num_mask = num_mask
    return step


def make_m2ae_gm3d_train_step(model: PointM2AE, optimizer, mask_ratio: float = 0.8,
                              relative: bool = True, augment: bool = True,
                              use_fused_attention: bool = False,
                              device="cuda") -> Callable:
    """Build ``step(state, pts, generator, scalars, draws=None)``:
    Point-M2AE with GM3D's geometric masking. ``state`` must hold an EMA copy.

      1. augment, ONE hierarchy shared by the two passes;
      2. the EMA forward, all visible, eval mode -> per-coarsest-group
         predicted loss (it stops at that head);
      3. ``geometric_mask`` of ``gm3d_num_mask(G_last, mask_ratio)`` groups
         (the top ``keep_ratio`` share by predicted loss, the rest at random);
      4. the student's masked reconstruction in train mode, the Chamfer loss
         and the loss matrix (``m2ae_losses``, no gradient through it);
      5. the learning loss (relative, or MSE) on the masked coarsest slots in
         index order (a stable arg-sort);
      6. AdamW (its clip is the optimizer's: 5 in the CLI), then the EMA of
         the parameters and BatchNorm statistics at ``scalars["ema_decay"]``.

    ``use_fused_attention`` (the JAX default, off): the unmasked attention
    sites the kernels hold take them, i.e. the decoder's coarsest stage
    (``dec_stage0``, 64 tokens at full width); the encoder's stages carry a
    mask and the finer decoder sites are longer. Launches a step: FPS 3, KNN
    8 (the hierarchy 3, the EMA's k = 1 maps 2, the student's 3); with the
    fused attention, ``attention_fwd`` 2 and ``attention_bwd`` 1 a block of
    ``dec_stage0``. ``draws`` may hold ``scale``, ``shift`` (B, 1, 3) and
    ``noise`` (B, G_last). The step is the span ``step``, its stages the spans
    ``step.augment_hierarchy``, ``.ema_forward_mask``, ``.student_forward``,
    ``.losses``, ``.backward`` and ``.optimizer_ema`` (``utils/profiling.py``).
    Returns ``(state, {"loss", "loss_chfr", "loss_learn",
    "grad_norm"})``, 0-d tensors on the device."""
    dev = resolve_device(device)
    coarse_groups = model.num_groups[-1]
    num_mask = gm3d_num_mask(coarse_groups, mask_ratio)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(state: TrainState, pts: torch.Tensor, generator: Optional[torch.Generator],
             scalars: Mapping[str, float],
             draws: Optional[Mapping[str, torch.Tensor]] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with step_span(dev) as st:
            state, metrics = _step(st.mark, state, pts, generator, scalars, draws or {})
        return state, mean_over_ranks(metrics)

    def _step(mark, state, pts, generator, scalars, draws):
        if state.student is not model or state.optimizer is not optimizer:
            raise ValueError("the step was built for another model or optimizer")
        if state.ema is None:
            raise ValueError("the M2AE + GM3D step needs a state with an EMA copy")
        mark("augment_hierarchy")
        pts = pts.to(dev)
        with torch.no_grad():
            samples = (scale_and_translate(generator, pts, scale=draws.get("scale"),
                                           shift=draws.get("shift")) if augment else pts)
            batch = samples.shape[0]
            hierarchy = build_hierarchy(samples, model.num_groups, model.group_sizes)
            mark("ema_forward_mask")
            all_vis = torch.ones((batch, coarse_groups), dtype=torch.bool, device=dev)
            with fused_attention_scope(use_fused_attention):
                outs_ema = state.ema(samples, all_vis, hierarchy, loss_pred_only=True)
            coarse_vis = ~geometric_mask(generator, outs_ema["loss_pred"], num_mask,
                                         scalars["keep_ratio"], noise=draws.get("noise"))
            mark("student_forward")

        model.train()
        with fused_attention_scope(use_fused_attention):
            outs = model(samples, coarse_vis, hierarchy, generator)
            mark("losses")
            loss, matrix = m2ae_losses(model, outs)
            # the masked coarsest slots in index order (masked = False sorts first)
            mask_idx = torch.argsort(coarse_vis.to(torch.int32), dim=-1,
                                     stable=True)[:, :num_mask]
            lp = torch.gather(outs["loss_pred"], 1, mask_idx)
            mt = torch.gather(matrix.detach(), 1, mask_idx)
            loss_learn = (losses.relative_learning_loss(lp, mt) if relative
                          else losses.mse_learning_loss(lp, mt))
            total = loss + loss_learn
            mark("backward")
            optimizer.zero_grad(set_to_none=True)
            total.backward()
            reduce_gradients(optimizer, params)
            mark("optimizer_ema")
        grad_norm = global_norm(p.grad for p in params if p.grad is not None)
        _step_all(optimizer, params)
        ema_update(state.ema, model, scalars["ema_decay"])
        state.step += 1
        return state, {"loss": total.detach(), "loss_chfr": loss.detach(),
                       "loss_learn": loss_learn.detach(), "grad_norm": grad_norm}

    step.num_mask = num_mask
    return step


def probe_draws(generator: Optional[torch.Generator],
                batch: int) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """One probe step's random draws: the keep masks (batch, 256) of the
    classifier head's two dropouts (``ClsHead``: 256 wide, rate 0.5), each
    unit kept with probability 0.5."""
    dev = generator.device if generator is not None else None
    return {"dropout": tuple(draw_rows(lambda s: torch.rand(s, generator=generator, device=dev),
                                       (batch, 256)) < 0.5 for _ in range(2))}


def make_probe_step(feat_model: nn.Module, classifier: nn.Module,
                    optimizer: torch.optim.Optimizer, device="cuda") -> Callable:
    """Build ``step(probe_state, pts, labels, generator, draws=None)``: the
    optional supervised probe trained during pretraining (``--classification``,
    ``engine_pretrain_Classifier_SVM.py:120-137``).

    The encoder's features (``feat_model.encode_features``, eval mode) are
    computed without gradient, so the probe never moves the student; the
    ``Classifier`` trains in train mode (BN batch statistics, its running
    buffers updated, dropout on) under its own optimizer. ``draws`` may hold
    ``dropout``, the head's two keep masks (``probe_draws``); otherwise they
    are drawn from ``generator``. ``probe_state`` is a ``TrainState`` of the
    classifier and ``optimizer``. Returns ``(probe_state, {"loss_cls",
    "acc_cls"})``, 0-d tensors on the device, the accuracy in percent."""
    dev = resolve_device(device)
    params = [p for p in classifier.parameters() if p.requires_grad]

    def step(probe_state: TrainState, pts: torch.Tensor, labels: torch.Tensor,
             generator: Optional[torch.Generator],
             draws: Optional[Mapping[str, Tuple[torch.Tensor, torch.Tensor]]] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if probe_state.student is not classifier or probe_state.optimizer is not optimizer:
            raise ValueError("the probe step was built for another classifier or optimizer")
        pts, labels = pts.to(dev), labels.to(dev)
        training = feat_model.training
        feat_model.eval()
        try:
            with torch.no_grad():
                feats = feat_model.encode_features(pts)
        finally:
            feat_model.train(training)
        masks = (draws or probe_draws(generator, pts.shape[0]))["dropout"]
        classifier.train()
        logits = classifier(feats, [m.to(dev) for m in masks])
        loss, acc = losses.classification_loss(logits, labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        reduce_gradients(optimizer, params)
        optimizer.step()
        probe_state.step += 1
        return probe_state, mean_over_ranks({"loss_cls": loss.detach(), "acc_cls": acc})

    return step
