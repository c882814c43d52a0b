"""GM3D pretraining: epochs of the GM3D pretrain step from the command line.

Port of ``gm3d_tpu/cli/pretrain.py`` for ``--model_family gm3d`` with the
shared optimizer and ``--learn_feature_loss`` ``dino``, ``ema`` or ``none``,
on synthetic clouds or on-disk ShapeNet-55. Same flags, same log files
(``pretrain.log``, the JSON-lines ``log.txt``, ``tfboard/``) and the same
keys in them, less ``val_svm_acc``::

  python -m gm3d_tpu_torch.cli.pretrain --config configs/pointmae/config.yaml \\
      --synthetic --epochs 2 --batch_size 32 --output_dir /tmp/run

Runs on the GPU unless ``--device cpu`` is given. Every flag of the JAX CLI
is accepted; those whose path is not ported yet raise ``NotImplementedError``
naming their ``ROADMAP.md`` item (``NOT_PORTED``). Not done yet, and said once
at start-up: checkpoints (item 1b) and the SVM probe (item 1c).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import torch

from gm3d_tpu_torch.ckpt.torch_import import load_torch_file
from gm3d_tpu_torch.cli.common import (
    base_parser,
    compute_dtype,
    load_config,
    make_train_loader,
    setup_mesh,
)
from gm3d_tpu_torch.config import build_model_from_cfg, cfg_from_yaml_file
from gm3d_tpu_torch.data.prefetch import device_prefetch
from gm3d_tpu_torch.masking import keep_ratio_schedule
from gm3d_tpu_torch.models import GM3DStudent
from gm3d_tpu_torch.train.optim import GM3D_COORD_HEAD, build_gm3d_shared_optimizer
from gm3d_tpu_torch.train.pretrain import METRIC_KEYS, make_gm3d_train_step
from gm3d_tpu_torch.train.schedules import (
    cosine_warmup_schedule,
    effective_lr,
    ema_decay_schedule,
    loss_weights,
)
from gm3d_tpu_torch.train.state import create_train_state
from gm3d_tpu_torch.utils import JsonlLogger, MetricLogger, ScalarWriter, get_logger
from gm3d_tpu_torch.utils.debug import check_finite_loss
from gm3d_tpu_torch.utils.pipeline import DeferredMetrics


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = base_parser("GM3D pretraining")
    p.add_argument("--model_family", choices=["gm3d", "pointmae", "m2ae", "m2ae_gm3d"],
                   default="gm3d")
    p.add_argument("--mode", choices=["feature", "usual"], default="feature")
    p.add_argument("--mask_ratio", type=float, default=0.6)
    p.add_argument("--dino_path", default=None,
                   help="teacher .pth (reference pretrain_PMAE.pth); random teacher if absent")
    p.add_argument("--teacher_ckpt", default=None,
                   help="orbax checkpoint of a teacher pretrain; not readable yet "
                        "(ROADMAP.md Queue 1 item 1b's converter): raises")
    p.add_argument("--teacher_config", default=None,
                   help="teacher YAML (defaults to config_m.yaml beside --config)")
    p.add_argument("--learn_feature_loss", choices=["dino", "ema", "clip", "none"],
                   default="dino",
                   help="dino = frozen Point-MAE teacher distillation (default); "
                        "ema = EMA feature targets; clip = CLIP teacher (not ported "
                        "yet, item 7); none = Chamfer-only (usual mode)")
    p.add_argument("--clip_path", default=None)
    p.add_argument("--no_learning_loss", action="store_true")
    p.add_argument("--relative", action="store_true", default=True)
    p.add_argument("--shared_learnable_tokens", action="store_true")
    p.add_argument("--student_variant", choices=["svm", "legacy"], default="svm")
    p.add_argument("--after_200_epoch", action="store_true")
    p.add_argument("--after_epoch", type=int, default=15)
    p.add_argument("--loss_multiply_by", type=float, nargs=2, default=[13.889, 1000.0])
    p.add_argument("--blr", type=float, default=1e-3)
    p.add_argument("--warmup_epochs", type=int, default=40)
    p.add_argument("--min_lr", type=float, default=0.0)
    p.add_argument("--accum_iter", type=int, default=1)
    p.add_argument("--steps_per_dispatch", type=int, default=8,
                   help="accepted; the steps run one by one (eager PyTorch has no "
                        "dispatch to amortise; the draws are those of one step each)")
    p.add_argument("--classification", action="store_true")
    p.add_argument("--sync_probe", action="store_true")
    p.add_argument("--sync_bn", default=True, action=argparse.BooleanOptionalAction,
                   help="a no-op on one device")
    p.add_argument("--save_interval", type=int, default=100,
                   help="accepted; no checkpoint is written until item 1b")
    p.add_argument("--profile_dir", default=None)
    p.add_argument("--profile_steps", type=int, default=5)
    p.add_argument("--shared_opt", default=True, action=argparse.BooleanOptionalAction)
    p.add_argument("--quantize_ema", action="store_true")
    return p.parse_args(argv)


# (test, what, ROADMAP.md Queue 1 item) for each JAX flag whose path is not ported yet;
# --num_devices above 1 (item 8) raises in setup_mesh, --native_loader (item 10) in
# make_train_loader
NOT_PORTED = (
    (lambda a: a.model_family == "pointmae", "--model_family pointmae", "2"),
    (lambda a: a.model_family in ("m2ae", "m2ae_gm3d"), "--model_family m2ae / m2ae_gm3d",
     "3"),
    (lambda a: a.learn_feature_loss == "clip", "--learn_feature_loss clip", "7"),
    (lambda a: a.classification, "--classification", "1c"),
    (lambda a: a.sync_probe, "--sync_probe", "1c"),
    (lambda a: a.student_variant == "legacy", "--student_variant legacy", "1c"),
    (lambda a: a.accum_iter > 1, "--accum_iter above 1", "1c"),
    (lambda a: not a.shared_opt, "--no-shared_opt", "1c"),
    (lambda a: a.bf16, "--bf16", "1c"),
    (lambda a: a.quantize_ema, "--quantize_ema", "9"),
    (lambda a: a.resume, "--resume", "1b"),
    (lambda a: a.save_steps > 0, "--save_steps", "1b"),
    (lambda a: a.profile_dir is not None, "--profile_dir", "1b"),
    (lambda a: a.teacher_ckpt is not None, "--teacher_ckpt (an orbax checkpoint)", "1b"),
)


def refuse_not_ported(args) -> None:
    for test, what, item in NOT_PORTED:
        if test(args):
            raise NotImplementedError(
                f"{what} is not ported to gm3d_tpu_torch yet (ROADMAP.md Queue 1 item {item})")


def student_mode(args) -> str:
    """``feature`` under dino, ``usual`` under none, otherwise ``--mode``."""
    if args.learn_feature_loss == "none":
        return "usual"
    return args.mode


def build_student(args, mode: str, dtype: torch.dtype) -> GM3DStudent:
    """The student from the class defaults (full width, drop path 0.1), as
    the JAX CLI builds it; the config's ``model`` section is the teacher's.
    Weights are drawn from a generator seeded 1 (the JAX CLI's init key)."""
    student = GM3DStudent(mode=mode, dtype=dtype)
    student.reset_parameters(torch.Generator().manual_seed(1))
    return student


def build_teacher(args, cfg, dtype: torch.dtype):
    """The Point-MAE teacher of ``--teacher_config``, else of
    ``config_m.yaml`` beside ``--config`` where that exists, else of
    ``--config``; random weights drawn from a generator seeded 2."""
    tc_path = args.teacher_config or os.path.join(os.path.dirname(args.config), "config_m.yaml")
    tcfg = cfg_from_yaml_file(tc_path) if os.path.exists(tc_path) else cfg
    teacher = build_model_from_cfg(tcfg["model"], dtype=dtype)
    teacher.reset_parameters(torch.Generator().manual_seed(2))
    return teacher


def load_teacher_weights(teacher: torch.nn.Module, path: str, logger) -> None:
    """A reference ``.pth`` into the teacher: keys that match no teacher
    tensor are logged and skipped; a teacher tensor the file lacks raises."""
    sd = load_torch_file(path)
    own = teacher.state_dict()
    unmatched = sorted(k for k in sd if k not in own)
    logger.info(f"teacher import: {len(unmatched)} unmatched keys")
    for key in unmatched:
        logger.warning(f"  unmatched torch key: {key}")
    missing = sorted(k for k in own if k not in sd and not k.endswith("num_batches_tracked"))
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} teacher tensors, e.g. {missing[:3]}")
    teacher.load_state_dict({k: sd[k] for k in own if k in sd}, strict=False)


def step_draws(generator: torch.Generator, batch: int, num_group: int) -> Dict[str, torch.Tensor]:
    """One step's random draws, on the generator's device: the augmentation's
    scale and shift (batch, 1, 3) and the mask's noise (batch, num_group)."""
    dev = generator.device

    def uniform(shape, low, high):
        return torch.rand(shape, generator=generator, device=dev) * (high - low) + low

    return {"scale": uniform((batch, 1, 3), 2.0 / 3.0, 3.0 / 2.0),
            "shift": uniform((batch, 1, 3), -0.2, 0.2),
            "noise": uniform((batch, num_group), 0.0, 1.0)}


def epoch_scalars(args, epoch: int, epochs: int) -> Dict[str, float]:
    """The step's epoch-dependent knobs (``gm3d_tpu/cli/pretrain.py:532-552``)."""
    capped_ramp = args.after_200_epoch or args.learn_feature_loss == "none"
    if args.learn_feature_loss == "none":
        # usual-mode engine: the fixed mix 13.889 * MSE + 1 * CD from epoch 0
        w_mse, w_cd = 13.889, 1.0
    else:
        w_mse, w_cd = loss_weights(epoch, args.after_epoch, args.loss_multiply_by)
    return {"keep_ratio": keep_ratio_schedule(epoch, epochs, capped_ramp),
            "ema_decay": ema_decay_schedule(epoch), "w_mse": w_mse, "w_cd": w_cd}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Train; returns the epoch records written to ``log.txt``."""
    args = parse_args(argv)
    refuse_not_ported(args)
    dev = setup_mesh(args)
    # fp32 products in fp32, as chip_smoke.py checks them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(args)
    logger = get_logger("gm3d", os.path.join(args.output_dir, "pretrain.log"))
    jsonl = JsonlLogger(os.path.join(args.output_dir, "log.txt"))
    tb = ScalarWriter(os.path.join(args.output_dir, "tfboard"))
    logger.warning(
        "not done by this CLI yet: checkpoints (ROADMAP.md Queue 1 item 1b; --save_interval "
        "and --sync_save do nothing), the SVM probe (item 1c; --val_freq does nothing); "
        "--sync_bn is a no-op on one device; --steps_per_dispatch runs its steps one by one")
    dtype = compute_dtype(args)
    epochs = cfg["max_epoch"]
    batch = cfg["total_bs"]
    # the SVM loaders (make_loaders) come with the probe, item 1c
    train_loader = make_train_loader(cfg, args)
    steps_per_epoch = max(len(train_loader), 1)

    lr = effective_lr(args.blr, batch, args.accum_iter)
    updates_per_epoch = max(steps_per_epoch // args.accum_iter, 1)
    sched = cosine_warmup_schedule(lr, args.min_lr, args.warmup_epochs, epochs,
                                   updates_per_epoch)
    wd = cfg["optimizer"]["kwargs"]["weight_decay"]

    mode = student_mode(args)
    student = build_student(args, mode, dtype).to(dev)
    teacher = None
    if args.learn_feature_loss == "dino":
        teacher = build_teacher(args, cfg, dtype)
        if args.dino_path:
            load_teacher_weights(teacher, args.dino_path, logger)
        else:
            logger.warning("no teacher weights given: teacher is randomly initialised")
        teacher = teacher.to(dev)
    # the coordinate head gets no gradient in feature mode: frozen, not decayed
    frozen = (GM3D_COORD_HEAD,) if mode == "feature" else ()
    optimizer = build_gm3d_shared_optimizer(student, sched(0), wd, frozen_modules=frozen)
    state = create_train_state(student, optimizer, with_ema=True)
    step_fn = make_gm3d_train_step(student, teacher, optimizer, args.mask_ratio,
                                   args.shared_learnable_tokens, args.relative,
                                   distill_mode=args.learn_feature_loss, device=dev)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    train_loader.load_state({"epoch": 0, "batch": 0})

    def emit_epoch(stats):
        """The epoch's log line, JSONL record and TensorBoard scalars
        (reference tags, engine_pretrain...:306-315)."""
        ep = stats["epoch"]
        logger.info(f"epoch {ep}: " + " ".join(
            f"{k}={v:.5g}" for k, v in stats.items() if isinstance(v, (int, float))))
        jsonl.write(stats)
        tb.add_scalar("train_loss", stats.get("loss", 0.0), ep)
        tb.add_scalar("train_loss_MSE", stats.get("loss_mse", 0.0), ep)
        tb.add_scalar("train_loss_Chfr", stats.get("loss_chfr", 0.0), ep)
        tb.add_scalar("train_loss_learn", stats.get("loss_learn", 0.0), ep)
        tb.add_scalar("lr", stats.get("lr", 0.0), ep)
        tb.add_scalar("grad_norm", stats.get("grad_norm", 0.0), ep)
        tb.flush()

    records = []
    try:
        for epoch in range(epochs):
            meter = MetricLogger()
            t0 = time.time()
            scalars = epoch_scalars(args, epoch, epochs)

            def drain(metrics):
                # the host read: waits for that step; one copy for the six values
                values = torch.stack([metrics[k] for k in METRIC_KEYS]).tolist()
                host = dict(zip(METRIC_KEYS, values))
                meter.update(**host)
                # the reference's NaN-loss hard exit, one step late under the pipeline
                check_finite_loss(host["loss"], logger)

            dm = DeferredMetrics(drain, depth=0 if args.sync_metrics else 1)
            for pts in device_prefetch(train_loader, device=dev):
                # optax evaluates the schedule at the optimizer's count BEFORE the update
                for group in optimizer.param_groups:
                    group["lr"] = sched(state.step)
                draws = step_draws(generator, pts.shape[0], student.num_group)
                state, metrics = step_fn(state, pts, generator, scalars, draws=draws)
                dm.push(metrics)
            dm.flush()
            stats = meter.global_avgs()
            epoch_time = time.time() - t0
            n_steps = meter.meters["loss"].count if "loss" in meter.meters else 0
            stats.update(epoch=epoch, time=round(epoch_time, 2),
                         lr=float(sched(state.step)), steps=n_steps,
                         clouds_per_sec=round(n_steps * batch / max(epoch_time, 1e-9), 1))
            emit_epoch(stats)
            records.append(stats)
    finally:
        tb.close()
    logger.info(f"done: {state.step} steps")
    return records


if __name__ == "__main__":
    main()
