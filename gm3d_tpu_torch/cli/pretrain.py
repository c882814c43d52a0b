"""GM3D and Point-MAE pretraining from the command line.

Port of ``gm3d_tpu/cli/pretrain.py`` for ``--model_family gm3d`` (shared
optimizer or ``--no-shared_opt``, ``--learn_feature_loss`` ``dino``, ``ema``
or ``none``, ``--student_variant svm`` or ``legacy``, fp32 or ``--bf16``) and
``--model_family pointmae`` (the teacher's pretrain, the legacy runner's
recipe), with ``--accum_iter`` micro-batches an update, on synthetic clouds
or on-disk ShapeNet-55. Same flags, same log
files (``pretrain.log``, the JSON-lines ``log.txt``, ``tfboard/``) and the
same keys in them; the same checkpoints in ``<output_dir>/ckpt``
(``ckpt/checkpoint.py``): a rolling save each epoch, ``--save_steps`` within
one, ``--save_interval`` snapshots under ``ckpt/epochs``, written from a
background thread unless ``--sync_save``; ``--resume``; a SIGTERM saves and
exits 0.

Every ``--val_freq`` epochs and after the last one, the linear-SVM probe
(``eval/svm.py``) scores the student's pooled features; its accuracy is the
epoch's ``val_svm_acc``, and a new best is saved as ``ckpt/best`` with
``best_metrics.json``. By default the probe runs in a background thread on a
device copy of the state taken at the epoch's end, while the next epoch
trains (the epoch's record is written when its probe ends);
``--sync_probe`` runs it inline. ``--classification`` trains a supervised
probe (``Classifier``) beside the student, one step for each train step, and
logs ``loss_cls`` and ``acc_cls``. The teacher, then GM3D::

  python -m gm3d_tpu_torch.cli.pretrain --config configs/pointmae/config_m.yaml \\
      --model_family pointmae --synthetic --epochs 2 --output_dir /tmp/teacher
  python -m gm3d_tpu_torch.cli.pretrain --config configs/pointmae/config.yaml \\
      --synthetic --epochs 2 --teacher_ckpt /tmp/teacher/ckpt --output_dir /tmp/run

Runs on the GPU unless ``--device cpu`` is given. Every flag of the JAX CLI
is accepted; those whose path is not ported yet raise ``NotImplementedError``
naming their ``ROADMAP.md`` item (``NOT_PORTED``).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import os
import threading
import time
from typing import Dict, List, Optional

import torch

from gm3d_tpu_torch.ckpt.async_writer import AsyncCheckpointWriter, device_snapshot, tensors_of
from gm3d_tpu_torch.ckpt.checkpoint import (
    latest_step,
    load_best_metrics,
    load_loader_state,
    restore_checkpoint,
    restore_raw,
    save_best_metrics,
    save_checkpoint,
    save_loader_state,
)
from gm3d_tpu_torch.ckpt.torch_import import load_torch_file
from gm3d_tpu_torch.cli.common import (
    base_parser,
    compute_dtype,
    load_config,
    make_loaders,
    resolve_batch_floor,
    setup_mesh,
)
from gm3d_tpu_torch.config import build_model_from_cfg, cfg_from_yaml_file
from gm3d_tpu_torch.data.prefetch import device_prefetch
from gm3d_tpu_torch.eval import linear_svc
from gm3d_tpu_torch.eval.svm import svm_probe
from gm3d_tpu_torch.masking import keep_ratio_schedule
from gm3d_tpu_torch.models import GM3DStudent
from gm3d_tpu_torch.models.point_transformer import Classifier
from gm3d_tpu_torch.train.optim import (
    GM3D_COORD_HEAD,
    build_adamw,
    build_gm3d_separated_optimizer,
    build_gm3d_shared_optimizer,
    build_legacy_adamw,
    set_scheduled_lr,
)
from gm3d_tpu_torch.train.pretrain import (
    METRIC_KEYS,
    POINTMAE_METRIC_KEYS,
    make_gm3d_train_step,
    make_pointmae_train_step,
    make_probe_step,
    probe_draws,
)
from gm3d_tpu_torch.train.schedules import (
    cosine_warmup_schedule,
    effective_lr,
    ema_decay_schedule,
    legacy_cosine_epoch_schedule,
    loss_weights,
)
from gm3d_tpu_torch.train.state import create_train_state
from gm3d_tpu_torch.utils import JsonlLogger, MetricLogger, ScalarWriter, get_logger
from gm3d_tpu_torch.utils.debug import check_finite_loss
from gm3d_tpu_torch.utils.pipeline import DeferredMetrics
from gm3d_tpu_torch.utils.preempt import PreemptionGuard
from gm3d_tpu_torch.utils.profiling import start_trace, stop_trace


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = base_parser("GM3D pretraining")
    p.add_argument("--model_family", choices=["gm3d", "pointmae", "m2ae", "m2ae_gm3d"],
                   default="gm3d")
    p.add_argument("--mode", choices=["feature", "usual"], default="feature")
    p.add_argument("--mask_ratio", type=float, default=0.6)
    p.add_argument("--dino_path", default=None,
                   help="teacher .pth (reference pretrain_PMAE.pth); random teacher if absent")
    p.add_argument("--teacher_ckpt", default=None,
                   help="checkpoint directory of a teacher pretrain (a --model_family "
                        "pointmae run's <output_dir>/ckpt, or a JAX one converted by "
                        "tools/orbax_to_torch.py)")
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
    p.add_argument("--classification", action="store_true",
                   help="train a supervised Classifier probe alongside (reference "
                        "--classification): one step on a svm_train batch for each train "
                        "step; forces --sync_probe")
    p.add_argument("--sync_probe", action="store_true",
                   help="run the SVM probe inline at the epoch's end. The default runs it "
                        "in a background thread on a device copy of the state while the "
                        "next epoch trains; the epoch's record is written when it ends")
    p.add_argument("--sync_bn", default=True, action=argparse.BooleanOptionalAction,
                   help="a no-op on one device")
    p.add_argument("--save_interval", type=int, default=100,
                   help="epoch snapshots under <ckpt>/epochs every N epochs; 0 disables")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace (host and CUDA device) of "
                        "the first --profile_steps steps into this directory")
    p.add_argument("--profile_steps", type=int, default=5)
    p.add_argument("--shared_opt", default=True, action=argparse.BooleanOptionalAction)
    p.add_argument("--quantize_ema", action="store_true")
    return p.parse_args(argv)


# (test, what, ROADMAP.md Queue 1 item) for each JAX flag whose path is not ported yet;
# --num_devices above 1 (item 8) raises in setup_mesh, --native_loader (item 10) in
# make_train_loader
NOT_PORTED = (
    (lambda a: a.model_family in ("m2ae", "m2ae_gm3d"), "--model_family m2ae / m2ae_gm3d",
     "3"),
    (lambda a: a.learn_feature_loss == "clip", "--learn_feature_loss clip", "7"),
    (lambda a: a.quantize_ema, "--quantize_ema", "9"),
)


def refuse_not_ported(args) -> None:
    for test, what, item in NOT_PORTED:
        if test(args):
            raise NotImplementedError(
                f"{what} is not ported to gm3d_tpu_torch yet (ROADMAP.md Queue 1 item {item})")


def resolve_student_variant(args) -> bool:
    """``--student_variant legacy``: the older student (one positional
    embedding for encoder and decoders, one mask token for both decoders),
    the multi-GPU main's Chamfer-only engine and its uncapped keep-ratio ramp.
    Defined for ``--model_family gm3d`` only; another family exits with the
    JAX CLI's message. Sets the flags the variant forces on ``args``
    (``--learn_feature_loss none``, ``--shared_learnable_tokens``), so that
    everything after reads one resolved set of flags. Returns whether the
    variant is the legacy one."""
    legacy = args.student_variant == "legacy"
    if legacy and args.model_family != "gm3d":
        raise SystemExit(f"--student_variant legacy is only defined for --model_family "
                         f"gm3d (got {args.model_family!r})")
    if legacy:
        args.learn_feature_loss = "none"
        args.shared_learnable_tokens = True
    return legacy


def student_mode(args) -> str:
    """``feature`` under dino, ``usual`` under none, otherwise ``--mode``."""
    if args.learn_feature_loss == "none":
        return "usual"
    return args.mode


def build_student(args, mode: str, dtype: torch.dtype) -> GM3DStudent:
    """The student from the class defaults (full width, drop path 0.1), as
    the JAX CLI builds it, the legacy variant's with the encoder's positional
    embedding shared; the config's ``model`` section is the teacher's.
    Weights are drawn from a generator seeded 1 (the JAX CLI's init key)."""
    student = GM3DStudent(mode=mode, shared_pos_embed=args.student_variant == "legacy",
                          dtype=dtype)
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


def build_pointmae(args, cfg, dtype: torch.dtype):
    """The Point-MAE of the config's ``model`` section, for the teacher's
    pretrain; weights drawn from a generator seeded 1 (the JAX CLI's init key)."""
    model = build_model_from_cfg(cfg["model"], dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(1))
    return model


def build_classifier(args, dim: int, dtype: torch.dtype) -> Classifier:
    """The ``--classification`` probe over ``dim``-wide encoder features, 40
    classes; weights drawn from a generator seeded 5 (the JAX CLI's init key)."""
    classifier = Classifier(dim=dim, cls_dim=40, dtype=dtype)
    classifier.reset_parameters(torch.Generator().manual_seed(5))
    return classifier


def load_teacher_checkpoint(teacher: torch.nn.Module, ckpt_dir: str, logger) -> None:
    """The latest step of a teacher pretrain's checkpoint directory into the
    teacher, strictly (every tensor, BN buffers included)."""
    raw = restore_raw(ckpt_dir)
    if raw is None:
        raise FileNotFoundError(f"no teacher ckpt at {ckpt_dir}")
    teacher.load_state_dict(raw["model"], strict=True)
    logger.info(f"teacher loaded from step {int(raw['step'])}")


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
    """The step's epoch-dependent knobs (``gm3d_tpu/cli/pretrain.py:532-552``):
    the usual-mode student ramps its keep ratio with a cap, the legacy variant
    without one."""
    legacy = args.student_variant == "legacy"
    capped_ramp = args.after_200_epoch or (args.learn_feature_loss == "none" and not legacy)
    if args.learn_feature_loss == "none":
        # usual-mode engine: the fixed mix 13.889 * MSE + 1 * CD from epoch 0
        w_mse, w_cd = 13.889, 1.0
    else:
        w_mse, w_cd = loss_weights(epoch, args.after_epoch, args.loss_multiply_by)
    return {"keep_ratio": keep_ratio_schedule(epoch, epochs, capped_ramp, legacy=legacy),
            "ema_decay": ema_decay_schedule(epoch), "w_mse": w_mse, "w_cd": w_cd}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Train; returns the epoch records written to ``log.txt``."""
    args = parse_args(argv)
    legacy = resolve_student_variant(args)
    refuse_not_ported(args)
    dev = setup_mesh(args)
    # fp32 products in fp32, as chip_smoke.py checks them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(args)
    logger = get_logger("gm3d", os.path.join(args.output_dir, "pretrain.log"))
    jsonl = JsonlLogger(os.path.join(args.output_dir, "log.txt"))
    tb = ScalarWriter(os.path.join(args.output_dir, "tfboard"))
    logger.warning("--sync_bn is a no-op on one device; --steps_per_dispatch runs its "
                   "steps one by one")
    dtype = compute_dtype(args)
    epochs = cfg["max_epoch"]
    batch = cfg["total_bs"]
    train_loader, svm_train, svm_test = make_loaders(cfg, args)
    steps_per_epoch = max(len(train_loader), 1)

    lr = effective_lr(args.blr, batch, args.accum_iter)
    updates_per_epoch = max(steps_per_epoch // args.accum_iter, 1)
    sched = cosine_warmup_schedule(lr, args.min_lr, args.warmup_epochs, epochs,
                                   updates_per_epoch)
    wd = cfg["optimizer"]["kwargs"]["weight_decay"]

    if args.model_family == "gm3d":
        if legacy:
            # the multi-GPU main's defaults: the Chamfer-only engine, one
            # shared mask token for both decoders
            logger.info("--student_variant legacy forces --learn_feature_loss none and "
                        "--shared_learnable_tokens")
        mode = student_mode(args)
        student = build_student(args, mode, dtype).to(dev)
        teacher = None
        if args.learn_feature_loss == "dino":
            teacher = build_teacher(args, cfg, dtype)
            if args.dino_path:
                load_teacher_weights(teacher, args.dino_path, logger)
            elif args.teacher_ckpt:
                load_teacher_checkpoint(teacher, args.teacher_ckpt, logger)
            else:
                logger.warning("no teacher weights given: teacher is randomly initialised")
            teacher = teacher.to(dev)
        if not args.shared_opt:
            # the reference never schedules the loss-prediction optimizer: constant lr
            optimizer = build_gm3d_separated_optimizer(student, sched(0), wd,
                                                       accum_steps=args.accum_iter,
                                                       loss_pred_learning_rate=lr)
            logger.info("separated recon / loss-pred optimizers (--no-shared_opt)")
        else:
            # the coordinate head gets no gradient in feature mode, and the legacy
            # student has no mask_token_loss_pred: frozen, not decayed
            frozen = ((GM3D_COORD_HEAD,) if mode == "feature" else
                      ("mask_token_loss_pred",) if legacy else ())
            optimizer = build_gm3d_shared_optimizer(student, sched(0), wd,
                                                    accum_steps=args.accum_iter,
                                                    frozen_modules=frozen)
        state = create_train_state(student, optimizer, with_ema=True)
        gm3d_step = make_gm3d_train_step(student, teacher, optimizer, args.mask_ratio,
                                         args.shared_learnable_tokens, args.relative,
                                         distill_mode=args.learn_feature_loss,
                                         shared_opt=args.shared_opt,
                                         accum_steps=args.accum_iter, device=dev)
        keys = METRIC_KEYS
        feat_model = student

        def run_step(state, pts, generator, scalars):
            draws = step_draws(generator, pts.shape[0], student.num_group)
            return gm3d_step(state, pts, generator, scalars, draws=draws)
    else:  # pointmae: the legacy runner's recipe, which made the published teacher
        scheduler = cfg.get("scheduler", {}).get("kwargs", {})
        sched = legacy_cosine_epoch_schedule(
            cfg["optimizer"]["kwargs"].get("lr", lr), scheduler.get("epochs", epochs),
            scheduler.get("initial_epochs", 10), updates_per_epoch)
        model = build_pointmae(args, cfg, dtype).to(dev)
        optimizer = build_legacy_adamw(model.named_parameters(), sched(0), wd,
                                       accum_steps=args.accum_iter)
        state = create_train_state(model, optimizer)
        tc = cfg["model"]["transformer_config"]
        # config_m.yaml's mask ratio is 0 (the teacher's replay); it trains at 0.6
        pointmae_step = make_pointmae_train_step(
            model, optimizer, tc["mask_ratio"] or 0.6, tc.get("mask_type", "rand"),
            cfg["model"].get("loss", "cdl2"), device=dev)
        keys = POINTMAE_METRIC_KEYS
        feat_model = model

        def run_step(state, pts, generator, scalars):
            draws = step_draws(generator, pts.shape[0], model.num_group)
            return pointmae_step(state, pts, generator, draws=draws)

    # the optional supervised probe (reference --classification), its own optimizer
    probe_state = probe_step = None
    if args.classification:
        classifier = build_classifier(args, feat_model.trans_dim, dtype).to(dev)
        probe_optimizer = build_adamw(classifier.named_parameters(), 1e-3)
        probe_state = create_train_state(classifier, probe_optimizer)
        probe_step = make_probe_step(feat_model, classifier, probe_optimizer, device=dev)
        logger.info("--classification forces --steps_per_dispatch 1 and --sync_probe")

    ckpt_dir = os.path.join(args.output_dir, "ckpt")
    # the random sequence starts again from --seed on --resume, as the JAX CLI's key does
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    writer = AsyncCheckpointWriter(enabled=not args.sync_save)
    records = []

    def emit_epoch(stats):
        """The epoch's log line, JSONL record and TensorBoard scalars
        (reference tags, engine_pretrain...:306-315), once an epoch, one
        epoch late where its SVM probe ran in the background."""
        ep = stats["epoch"]
        logger.info(f"epoch {ep}: " + " ".join(
            f"{k}={v:.5g}" for k, v in stats.items() if isinstance(v, (int, float))))
        jsonl.write(stats)
        records.append(stats)
        tb.add_scalar("train_loss", stats.get("loss", 0.0), ep)
        tb.add_scalar("train_loss_MSE", stats.get("loss_mse", 0.0), ep)
        tb.add_scalar("train_loss_Chfr", stats.get("loss_chfr", 0.0), ep)
        tb.add_scalar("train_loss_learn", stats.get("loss_learn", 0.0), ep)
        tb.add_scalar("lr", stats.get("lr", 0.0), ep)
        tb.add_scalar("grad_norm", stats.get("grad_norm", 0.0), ep)
        if "val_svm_acc" in stats:
            tb.add_scalar("Metric/ACC", stats["val_svm_acc"], ep)
        tb.flush()

    def submit_save(step, token):
        """The rolling checkpoint of ``step``, then its loader position."""
        writer.submit(state, lambda s: (save_checkpoint(ckpt_dir, s, step),
                                        save_loader_state(ckpt_dir, token)))

    def save_now(token):
        """A synchronous rolling save (the process exits right after)."""
        writer.wait()
        save_checkpoint(ckpt_dir, state, state.step)
        save_loader_state(ckpt_dir, token)

    best_acc = 0.0
    npoints = cfg.get("npoints", 1024)

    def record_probe(stats, acc, step, statelike, probe_stats):
        """Fold a finished probe into its epoch's record; a new best goes to
        ``ckpt/best`` with ``best_metrics.json`` (``*_temp_best.pth``,
        ``main_pretrain.py:591-611``)."""
        nonlocal best_acc
        stats["val_svm_acc"] = acc
        logger.info(f"svm probe of epoch {stats['epoch']}: acc {acc:.4f}; " + ", ".join(
            f"{k} {v:.6g}" for k, v in probe_stats.items()))
        if "gap" in probe_stats:
            # sklearn's SVC warns at its cap and goes on: so does the run
            stats["val_svm_gap"] = probe_stats["gap"]
            logger.warning(f"svm probe of epoch {stats['epoch']}: the linear SVC stopped at "
                           f"its cap of {linear_svc.MAX_ITER} iterations with a KKT gap of "
                           f"{probe_stats['gap']:.3g} (tolerance {linear_svc.TOL:g})")
        if acc > best_acc:
            best_acc = acc
            writer.submit(statelike, lambda s, step=step, a=acc: (
                save_checkpoint(os.path.join(ckpt_dir, "best"), s, step,
                                metrics={"svm_acc": a}, max_to_keep=1),
                save_best_metrics(ckpt_dir, {"best": a})))

    # The probe runs in a background thread on a device copy of the state taken
    # at the epoch's end, so the next epoch trains meanwhile. --classification
    # makes it synchronous: its steps and the probe would both read svm_train.
    probe_async = not args.sync_probe and probe_step is None
    # what the background probe loads each snapshot into, and the stream it runs on
    probe_model = copy.deepcopy(feat_model).requires_grad_(False) if probe_async else None
    probe_stream = torch.cuda.Stream(dev) if probe_async and dev.type == "cuda" else None
    snapshot_buffers = None
    pending_probe = None  # {"thread", "holder", "stats", "step", "snap"}

    def start_probe(stats, step):
        nonlocal pending_probe, snapshot_buffers
        # the reference validates the STUDENT, not the EMA (main_pretrain.py:497-498)
        snap = device_snapshot(state, snapshot_buffers)
        snapshot_buffers = tensors_of(snap)
        ready = None
        if probe_stream is not None:
            ready = torch.cuda.Event()
            ready.record()
        holder = {"stats": {}}

        def run():
            try:
                ctx = contextlib.nullcontext()
                if probe_stream is not None:
                    probe_stream.wait_event(ready)
                    ctx = torch.cuda.stream(probe_stream)
                with ctx:
                    probe_model.load_state_dict(snap["model"])
                    holder["acc"] = svm_probe(probe_model, svm_train, svm_test, npoints,
                                              resolve_batch_floor(args), stats=holder["stats"])
            except BaseException as e:  # noqa: BLE001 - re-raised when the probe is joined
                holder["err"] = e

        thread = threading.Thread(target=run, name="gm3d-svm-probe", daemon=True)
        thread.start()
        pending_probe = {"thread": thread, "holder": holder, "stats": stats, "step": step,
                         "snap": snap}

    def finish_pending_probe():
        """Join the background probe, record it and write its epoch's record."""
        nonlocal pending_probe
        if pending_probe is None:
            return
        p, pending_probe = pending_probe, None
        p["thread"].join()
        if "err" in p["holder"]:
            raise RuntimeError("SVM probe failed") from p["holder"]["err"]
        record_probe(p["stats"], p["holder"]["acc"], p["step"], p["snap"], p["holder"]["stats"])
        emit_epoch(p["stats"])

    def finish_probe_before_exit():
        # a mid-epoch resume never probes the previous epoch again: write its
        # record before the preemption save, but never let it block that save
        try:
            finish_pending_probe()
        except RuntimeError:
            logger.warning("pending probe failed during preemption; its epoch row is dropped",
                           exc_info=True)

    def read_probe_metrics(meter, pmetrics):
        values = torch.stack([pmetrics["loss_cls"], pmetrics["acc_cls"]]).tolist()
        meter.update(loss_cls=values[0], acc_cls=values[1])

    prof_remaining = args.profile_steps if args.profile_dir else 0
    prof = start_trace(args.profile_dir) if prof_remaining else None
    # SIGTERM: checkpoint at the next step boundary and exit 0 (utils/preempt.py)
    guard = PreemptionGuard(logger).install()
    try:
        start_epoch = 0
        loader_token = {}
        if args.resume:
            if restore_checkpoint(ckpt_dir, state) is not None:
                # best-so-far comes back too, so that a worse epoch after the
                # resume cannot overwrite ckpt/best
                best_acc = float(load_best_metrics(ckpt_dir).get("best", 0.0))
                logger.info(f"resumed from step {state.step} (best svm {best_acc:.4f})")
            start_epoch = state.step // steps_per_epoch
            # a mid-epoch save names the exact next batch
            loader_token = load_loader_state(ckpt_dir)
            if loader_token:
                start_epoch = int(loader_token.get("epoch", start_epoch))
        train_loader.load_state(loader_token or {"epoch": start_epoch, "batch": 0})
        last_saved_step = state.step
        for epoch in range(start_epoch, epochs):
            meter = MetricLogger()
            t0 = time.time()
            scalars = epoch_scalars(args, epoch, epochs) if args.model_family == "gm3d" else None
            probe_iter = iter(svm_train) if probe_step is not None else None
            pending_pmetrics = None

            def drain(metrics):
                # the host read: waits for that step; one copy for all values
                values = torch.stack([metrics[k] for k in keys]).tolist()
                host = dict(zip(keys, values))
                meter.update(**host)
                # the reference's NaN-loss hard exit, one step late under the pipeline
                check_finite_loss(host["loss"], logger)

            dm = DeferredMetrics(drain, depth=0 if args.sync_metrics else 1)
            prefetcher = device_prefetch(train_loader, device=dev)

            def position():
                # the token as of the last batch yielded: resume replays nothing
                return prefetcher.state() or {"epoch": epoch, "batch": 0}

            for pts in prefetcher:
                # optax evaluates the schedule at the optimizer's count of UPDATES
                # before the update (under accumulation, once a window)
                set_scheduled_lr(optimizer, sched(state.step // args.accum_iter))
                state, metrics = run_step(state, pts, generator, scalars)
                dm.push(metrics)
                if args.save_steps and state.step - last_saved_step >= args.save_steps:
                    # the deferred NaN checks first: a state whose loss was never
                    # checked must not replace the last good checkpoint
                    dm.flush()
                    submit_save(state.step, position())
                    last_saved_step = state.step
                guard.exit_if_triggered(
                    lambda: (finish_probe_before_exit(), dm.flush(), save_now(position())))
                if prof_remaining:
                    prof_remaining -= 1
                    if prof_remaining == 0:
                        dm.flush()
                        logger.info("profiler trace written to "
                                    f"{stop_trace(prof, args.profile_dir)}")
                if probe_step is not None:
                    try:
                        cls_pts, cls_labels = next(probe_iter)
                    except StopIteration:
                        probe_iter = iter(svm_train)
                        cls_pts, cls_labels = next(probe_iter)
                    draws = probe_draws(generator, len(cls_labels))
                    probe_state, pmetrics = probe_step(
                        probe_state, torch.as_tensor(cls_pts), torch.as_tensor(cls_labels),
                        generator, draws=draws)
                    # read one step behind, like the train metrics
                    if pending_pmetrics is not None:
                        read_probe_metrics(meter, pending_pmetrics)
                    pending_pmetrics = pmetrics
            dm.flush()
            if pending_pmetrics is not None:
                read_probe_metrics(meter, pending_pmetrics)
            # every step of this epoch is trained: a signal here resumes at epoch + 1
            guard.exit_if_triggered(lambda: (finish_probe_before_exit(),
                                             save_now({"epoch": epoch + 1, "batch": 0})))
            stats = meter.global_avgs()
            epoch_time = time.time() - t0
            n_steps = meter.meters["loss"].count if "loss" in meter.meters else 0
            stats.update(epoch=epoch, time=round(epoch_time, 2),
                         lr=float(sched(state.step // args.accum_iter)), steps=n_steps,
                         clouds_per_sec=round(n_steps * batch / max(epoch_time, 1e-9), 1))
            # the previous epoch's probe ends first: its record precedes this
            # epoch's, and the best accuracy is current before this epoch's probe
            finish_pending_probe()
            if (epoch + 1) % args.val_freq == 0 or epoch == epochs - 1:
                if probe_async:
                    start_probe(stats, state.step)
                else:
                    probe_stats = {}
                    acc = svm_probe(feat_model, svm_train, svm_test, npoints,
                                    resolve_batch_floor(args), stats=probe_stats)
                    record_probe(stats, acc, state.step, state, probe_stats)
            # the rolling save of the epoch, its sidecar at the next epoch's start
            submit_save(state.step, {"epoch": epoch + 1, "batch": 0})
            last_saved_step = state.step
            if args.save_interval and (epoch + 1) % args.save_interval == 0:
                step = state.step
                writer.submit(state, lambda s, step=step: save_checkpoint(
                    os.path.join(ckpt_dir, "epochs"), s, step, max_to_keep=1000))
            if pending_probe is None:
                emit_epoch(stats)
        finish_pending_probe()  # the last epoch's probe and record
    finally:
        # on ANY exit: the saves in flight are of NaN-checked states, commit them
        writer.wait()
        # on an error or a preemption a background probe's result is dropped
        # (resume probes again); a daemon thread left running would race the exit
        if pending_probe is not None:
            pending_probe["thread"].join()
        guard.uninstall()
        tb.close()
    if prof_remaining:  # the run ended before --profile_steps steps
        stop_trace(prof, args.profile_dir)
    if latest_step(ckpt_dir) != state.step:  # a run with no epoch left to train
        save_checkpoint(ckpt_dir, state, state.step)
    logger.info(f"done: {state.step} steps; best svm acc {best_acc:.4f}")
    return records


if __name__ == "__main__":
    main()
