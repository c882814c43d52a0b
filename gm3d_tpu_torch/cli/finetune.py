"""Classification finetune from the command line.

Port of ``gm3d_tpu/cli/finetune.py`` (reference ``main_finetune.py``): loads a
pretrain checkpoint (the port's pretrain CLI's ``<output_dir>/ckpt``, GM3D or
Point-MAE, or a reference ``.pth`` with ``--torch_ckpt``) into
``PointTransformer``, trains with one of the two published recipes, validates
every ``--val_freq`` epochs and, with ``--vote``, runs the 10-vote evaluation
at the end::

  python -m gm3d_tpu_torch.cli.finetune --config configs/pointmae/finetune_modelnet.yaml \\
      --pretrained /tmp/run/ckpt --vote --synthetic --epochs 2 --output_dir /tmp/ft

Same flags, same log files (``finetune.log``, the JSON-lines ``log.txt``,
``tfboard/``) with the same keys, and the same checkpoints in
``<output_dir>/ckpt`` (``ckpt/checkpoint.py``): a rolling save each epoch,
``--save_steps`` within one, ``ckpt/best`` on a new best ``val_acc`` and,
under ``--vote``, ``ckpt/best_vote`` once the vote gate opens, with
``best_metrics.json``; written from a background thread unless
``--sync_save``; ``--resume``; a SIGTERM saves and exits 0. ``ckpt/best`` is
what ``cli/export_model.py --ckpt`` exports for serving.

Runs on the GPU unless ``--device cpu`` is given. ``--steps_per_dispatch``
groups the steps as the JAX CLI does but runs them one by one (eager
PyTorch has no dispatch to amortise); ``--batch_floor`` is a no-op (a TPU
compiler workaround); ``--num_devices`` above 1 raises (``ROADMAP.md``
Queue 1 item 8), and so does a Point-M2AE config (item 3).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np
import torch

from gm3d_tpu_torch.ckpt.async_writer import AsyncCheckpointWriter
from gm3d_tpu_torch.ckpt.checkpoint import (
    latest_step,
    load_best_metrics,
    load_loader_state,
    restore_checkpoint,
    save_best_metrics,
    save_checkpoint,
    save_loader_state,
)
from gm3d_tpu_torch.ckpt.transfer import load_pretrained_into
from gm3d_tpu_torch.cli.common import (
    base_parser,
    compute_dtype,
    load_config,
    make_cls_loaders,
    setup_mesh,
)
from gm3d_tpu_torch.config import build_model_from_cfg
from gm3d_tpu_torch.data.prefetch import device_prefetch
from gm3d_tpu_torch.eval.metrics import accuracy
from gm3d_tpu_torch.train.finetune import (
    METRIC_KEYS,
    make_eval_step,
    make_finetune_multi_step,
    make_finetune_train_step,
    make_vote_eval_step,
)
from gm3d_tpu_torch.train.optim import (
    build_finetune_optimizer,
    build_legacy_adamw,
    set_scheduled_lr,
)
from gm3d_tpu_torch.train.schedules import (
    cosine_warmup_schedule,
    effective_lr,
    legacy_cosine_epoch_schedule,
)
from gm3d_tpu_torch.train.state import create_train_state
from gm3d_tpu_torch.utils import JsonlLogger, MetricLogger, ScalarWriter, get_logger
from gm3d_tpu_torch.utils.debug import check_finite_loss
from gm3d_tpu_torch.utils.pipeline import DeferredMetrics
from gm3d_tpu_torch.utils.preempt import PreemptionGuard


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = base_parser("classification fine-tune")
    p.add_argument("--pretrained", default=None,
                   help="a pretrain checkpoint root (the pretrain CLI's <output_dir>/ckpt) "
                        "or, with --torch_ckpt, a reference .pth")
    p.add_argument("--torch_ckpt", action="store_true", help="--pretrained is a torch .pth")
    p.add_argument("--vote", action="store_true", help="run 10x voting eval at the end")
    p.add_argument("--recipe", choices=["auto", "hpm", "legacy"], default="auto",
                   help="optimizer stack: 'legacy' = runner_finetune recipe (config lr "
                        "verbatim, per-epoch CosLR, clip to grad_norm_clip, no layer "
                        "decay); 'hpm' = main_finetune recipe (blr*bs/256 lr, "
                        "per-iteration cosine warmup 5, layer decay 0.75, no clip); "
                        "'auto' picks by model family and dataset")
    p.add_argument("--blr", type=float, default=5e-4,
                   help="hpm recipe base lr: lr = blr * eff_bs / 256")
    p.add_argument("--eff_bs", type=int, default=None,
                   help="hpm recipe: effective batch size for the lr scaling. Default: "
                        "the published run's value for ScanObjectNN splits, else "
                        "total_bs*accum_iter")
    p.add_argument("--accum_iter", type=int, default=1,
                   help="gradient accumulation (hpm recipe: the MEAN, legacy: the SUM)")
    p.add_argument("--abs_lr", type=float, default=None,
                   help="hpm recipe: absolute lr override (bypasses the blr scaling)")
    p.add_argument("--warmup_epochs", type=float, default=None,
                   help="warmup epochs; default 5 for hpm, config initial_epochs for legacy")
    p.add_argument("--clip_grad", type=float, default=None,
                   help="hpm recipe grad clip (default: no clipping)")
    p.add_argument("--layer_decay", type=float, default=0.75,
                   help="hpm recipe layer-wise lr decay (reference-effective layer ids, "
                        "train/optim.py)")
    p.add_argument("--steps_per_dispatch", type=int, default=8,
                   help="groups of K steps, as the JAX CLI dispatches them; here the steps "
                        "of a group run one by one. A trailing partial group runs as single "
                        "steps")
    p.add_argument("--smoothing", type=float, default=None,
                   help="label smoothing override. Default: plain CE for the hpm recipe, "
                        "the config's model.smooth for the legacy recipe")
    return p.parse_args(argv)


def resolve_recipe(args, cfg) -> str:
    """The finetune stack whose effective recipe produced the published
    number for this config (``gm3d_tpu/cli/finetune.py::resolve_recipe``):
    Point-MAE's ModelNet40 and few-shot ran the legacy runner, its three
    ScanObjectNN rows the HPM main; every Point-M2AE finetune ran the HPM
    main except few-shot."""
    if args.recipe != "auto":
        return args.recipe
    name = cfg["dataset"]["train"].get("_base_", {}).get("NAME", "")
    if cfg["model"]["NAME"].startswith("Point_M2AE"):
        # exact "ModelNet": ModelNetFewShot must stay legacy
        if name.startswith("ScanObjectNN") or name == "ModelNet":
            return "hpm"
        return "legacy"
    return "hpm" if name.startswith("ScanObjectNN") else "legacy"


def published_eff_bs(cfg) -> Optional[int]:
    """Effective batch size of the published hpm-recipe runs, pinned by the
    logs' warm-up peak ``train_lr`` (= blr * eff_bs / 256 at blr 5e-4), per
    model family (``gm3d_tpu/cli/finetune.py::published_eff_bs``). None when
    no published hpm-recipe row pins this config."""
    train = cfg["dataset"]["train"].get("_base_", {})
    name, root = train.get("NAME", ""), str(train.get("ROOT", ""))
    if cfg["model"]["NAME"].startswith("Point_M2AE"):
        if name == "ScanObjectNN_hardest":
            return 40
        if name == "ScanObjectNN":
            return 80 if "nobg" in root else 40
        if name == "ModelNet":
            return 80
        return None
    if name == "ScanObjectNN_hardest":
        return 80
    if name == "ScanObjectNN":
        return 64 if "nobg" in root else 40
    return None


def resolve_smoothing(override, recipe: str, cfg) -> float:
    """Effective label smoothing: plain CE for hpm (the reference's
    LabelSmoothing branch is dead code), the config's ``model.smooth`` for
    legacy."""
    if override is not None:
        return override
    if recipe == "hpm":
        return 0.0
    return cfg["model"].get("smooth", 0.0)


def vote_gate(acc: float, better: bool) -> bool:
    """In-training vote trigger (``tools/runner_finetune.py:211-212``): vote
    only once plain accuracy clears the reference's hard-coded ModelNet40
    thresholds: above 92.1 always, or a new best above 91."""
    return acc > 92.1 or (better and acc > 91)


def evaluate(loader, eval_step) -> float:
    """Accuracy in percent of ``eval_step``'s logits over the loader. The
    logits stay on the device until the last batch is enqueued."""
    logits_all, labels_all = [], []
    for pts, labels in loader:
        logits_all.append(eval_step(torch.as_tensor(pts)))
        labels_all.append(np.asarray(labels))
    return accuracy(torch.cat(logits_all).float().cpu().numpy(),
                    np.concatenate(labels_all)) * 100.0


def evaluate_vote(loader, vote_step, generator: torch.Generator) -> float:
    """One 10-vote pass over the loader (``tools/runner_finetune.py``
    validate_vote / test_vote), each batch's votes drawn from ``generator``."""
    return evaluate(loader, lambda pts: vote_step(pts, generator))


def build_model(args, cfg, dtype: torch.dtype):
    """The config's ``PointTransformer``, weights drawn from a generator
    seeded ``--seed`` (the JAX CLI's init key)."""
    if cfg["model"]["NAME"].startswith("Point_M2AE"):
        raise NotImplementedError(
            f"finetuning {cfg['model']['NAME']} is not ported to gm3d_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 3)")
    model = build_model_from_cfg(cfg["model"], dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    return model


def build_optimizer(args, cfg, model, recipe: str, epochs: int, steps_per_epoch: int, logger):
    """(optimizer, schedule over updates) of the recipe."""
    wd = cfg["optimizer"]["kwargs"]["weight_decay"]
    # under accumulation the schedule ticks once an UPDATE, not a micro-batch
    updates_per_epoch = max(steps_per_epoch // args.accum_iter, 1)
    if recipe == "hpm":
        # main_finetune.py: lr = blr * eff_bs / 256, per-iteration cosine with a
        # 5-epoch warm-up, layer decay 0.75, no clip, torch-default betas
        eff_bs = args.eff_bs if args.eff_bs is not None else published_eff_bs(cfg)
        if eff_bs is None:
            eff_bs = cfg["total_bs"] * args.accum_iter
        elif eff_bs != cfg["total_bs"] * args.accum_iter:
            logger.info(f"hpm lr uses the PUBLISHED run's effective bs {eff_bs} "
                        f"(log-pinned, see published_eff_bs) while the actual batch "
                        f"stays total_bs={cfg['total_bs']}; pass --eff_bs to override")
        lr = args.abs_lr if args.abs_lr is not None else effective_lr(args.blr, eff_bs, 1)
        warmup = args.warmup_epochs if args.warmup_epochs is not None else 5
        sched = cosine_warmup_schedule(lr, 1e-6, warmup, epochs, updates_per_epoch)
        optimizer = build_finetune_optimizer(
            model.named_parameters(), sched(0), wd, layer_decay=args.layer_decay,
            grad_clip=args.clip_grad, accum_steps=args.accum_iter)
        logger.info(f"recipe hpm: lr {lr:.3g} (blr {args.blr}, eff_bs {eff_bs}), "
                    f"warmup {warmup}, layer_decay {args.layer_decay}, "
                    f"clip {args.clip_grad}, accum {args.accum_iter}")
    else:
        # tools/runner_finetune.py: config lr verbatim, per-epoch CosLR with its
        # lag, token-free decay mask, clip to grad_norm_clip, no layer decay; the
        # cosine's horizon is the scheduler's epochs, not --epochs
        lr = cfg["optimizer"]["kwargs"]["lr"]
        warmup = (args.warmup_epochs if args.warmup_epochs is not None
                  else cfg["scheduler"]["kwargs"]["initial_epochs"])
        horizon = cfg["scheduler"]["kwargs"].get("epochs", epochs)
        sched = legacy_cosine_epoch_schedule(lr, horizon, warmup, updates_per_epoch)
        optimizer = build_legacy_adamw(model.named_parameters(), sched(0), wd,
                                       accum_steps=args.accum_iter,
                                       grad_clip=cfg.get("grad_norm_clip"))
        logger.info(f"recipe legacy: lr {lr:.3g}, warmup {warmup}, horizon "
                    f"{horizon}, clip {cfg.get('grad_norm_clip')}, accum {args.accum_iter}")
    return optimizer, sched


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Train; returns the records written to ``log.txt``."""
    args = parse_args(argv)
    dev = setup_mesh(args)
    # fp32 products in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(args)
    logger = get_logger("gm3d.finetune", os.path.join(args.output_dir, "finetune.log"))
    jsonl = JsonlLogger(os.path.join(args.output_dir, "log.txt"))
    # the reference's TensorBoard tags: 'loss' / 'lr' of the engine, the
    # validation writer's 'Metric/ACC'
    tb = ScalarWriter(os.path.join(args.output_dir, "tfboard"))
    dtype = compute_dtype(args)
    model = build_model(args, cfg, dtype)
    npoints = cfg.get("npoints", 1024)
    epochs = cfg["max_epoch"]
    batch = cfg["total_bs"]
    train_loader, val_loader = make_cls_loaders(cfg, args)
    steps_per_epoch = max(len(train_loader), 1)

    if args.pretrained:
        load_pretrained_into(model, args.pretrained, torch_ckpt=args.torch_ckpt, logger=logger)
    model = model.to(dev)

    recipe = resolve_recipe(args, cfg)
    if recipe == "hpm" and args.epochs is None:
        # the HPM main never reads the config's max_epoch: its --epochs default
        # is 500, and every published hpm log ran that cosine
        epochs = 500
        logger.info("recipe hpm: --epochs not given, using the reference main's default "
                    "500 (config max_epoch is never read by the HPM stack)")
    optimizer, sched = build_optimizer(args, cfg, model, recipe, epochs, steps_per_epoch,
                                       logger)
    state = create_train_state(model, optimizer)
    smoothing = resolve_smoothing(args.smoothing, recipe, cfg)
    if smoothing:
        logger.info(f"label smoothing {smoothing}")
    if args.batch_floor:
        logger.info("--batch_floor is a no-op on the GPU")
    train_step = make_finetune_train_step(model, optimizer, npoints, smoothing, device=dev)

    def step_fn(state, pts, labels, generator, draws=None):
        # the schedule at the optimizer's count of UPDATES before this one
        set_scheduled_lr(optimizer, sched(state.step // args.accum_iter))
        return train_step(state, pts, labels, generator, draws)

    k_dispatch = args.steps_per_dispatch
    multi_fn = make_finetune_multi_step(step_fn) if k_dispatch > 1 else None
    eval_step = make_eval_step(model, npoints, device=dev)
    vote_step = make_vote_eval_step(model, npoints, device=dev) if args.vote else None

    # the random sequence starts again from --seed on --resume, as the JAX CLI's key does
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    best, best_vote = 0.0, 0.0
    ckpt_dir = os.path.join(args.output_dir, "ckpt")
    writer = AsyncCheckpointWriter(enabled=not args.sync_save)
    records: List[dict] = []

    def write_record(stats: dict) -> None:
        jsonl.write(stats)
        records.append(stats)

    def save_rolling(step: int, token: dict) -> None:
        writer.submit(state, lambda s: (save_checkpoint(ckpt_dir, s, step),
                                        save_loader_state(ckpt_dir, token)))

    def save_now(token: dict) -> None:
        """A synchronous rolling save (the process exits right after)."""
        writer.wait()
        save_checkpoint(ckpt_dir, state, state.step)
        save_loader_state(ckpt_dir, token)

    guard = PreemptionGuard(logger).install()
    try:
        start_epoch = 0
        loader_token = {}
        if args.resume and restore_checkpoint(ckpt_dir, state) is not None:
            start_epoch = state.step // steps_per_epoch
            # best-so-far comes back too, so that a worse epoch after the resume
            # cannot overwrite ckpt/best, as the reference's legacy runner restores it
            bm = load_best_metrics(ckpt_dir)
            best = float(bm.get("best", 0.0))
            best_vote = float(bm.get("best_vote", 0.0))
            logger.info(f"resumed from step {state.step} (epoch {start_epoch}, best "
                        f"{best:.2f}, best_vote {best_vote:.2f})")
            # a mid-epoch save names the exact next batch
            loader_token = load_loader_state(ckpt_dir)
            if loader_token:
                start_epoch = int(loader_token.get("epoch", start_epoch))
        train_loader.load_state(loader_token or {"epoch": start_epoch, "batch": 0})
        last_saved_step = state.step
        for epoch in range(start_epoch, epochs):
            meter = MetricLogger()
            t0 = time.time()

            def drain(metrics, k):
                # the host read: waits for that dispatch; one copy for all values
                values = torch.stack([metrics[n].reshape(-1) for n in METRIC_KEYS]).tolist()
                for j in range(k):
                    meter.update(**{n: v[j] for n, v in zip(METRIC_KEYS, values)})
                # the reference's NaN-loss hard exit, one dispatch late; a sum is
                # non-finite where any of its steps' losses is
                check_finite_loss(float(sum(values[0])), logger)

            dm = DeferredMetrics(drain, depth=0 if args.sync_metrics else 1)
            prefetcher = device_prefetch(train_loader, device=dev)
            pending = []

            def position():
                # the token as of the last batch yielded: resume replays nothing
                return prefetcher.state() or {"epoch": epoch, "batch": 0}

            def run(pts, labels):
                _, metrics = step_fn(state, pts, labels, generator)
                dm.push(metrics, 1)

            for pts, labels in prefetcher:
                if multi_fn is None:
                    run(pts, labels)
                else:
                    pending.append((pts, labels))
                    if len(pending) < k_dispatch:
                        continue
                    _, metrics = multi_fn(state, torch.stack([p for p, _ in pending]),
                                          torch.stack([lab for _, lab in pending]), generator)
                    dm.push(metrics, len(pending))
                    pending = []
                if args.save_steps and state.step - last_saved_step >= args.save_steps:
                    # the deferred NaN checks first: a state whose loss was never
                    # checked must not replace the last good checkpoint
                    dm.flush()
                    save_rolling(state.step, position())
                    last_saved_step = state.step
                guard.exit_if_triggered(lambda: (dm.flush(), save_now(position())))
            for pts, labels in pending:  # a partial group, as single steps
                run(pts, labels)
            dm.flush()
            # every step of this epoch is trained: a signal here resumes at epoch + 1
            guard.exit_if_triggered(lambda: save_now({"epoch": epoch + 1, "batch": 0}))
            stats = meter.global_avgs()
            stats.update(epoch=epoch, time=round(time.time() - t0, 2))
            if (epoch + 1) % args.val_freq == 0 or epoch == epochs - 1:
                acc = evaluate(val_loader, eval_step)
                stats["val_acc"] = acc
                better = acc > best
                if better:
                    best = acc
                    writer.submit(state, lambda s, step=state.step, a=acc,
                                  mb={"best": best, "best_vote": best_vote}: (
                        save_checkpoint(os.path.join(ckpt_dir, "best"), s, step,
                                        metrics={"acc": a}, max_to_keep=1),
                        save_best_metrics(ckpt_dir, mb)))
                # the in-training gated vote (tools/runner_finetune.py:211-218),
                # with a ckpt/best_vote of its own
                if args.vote and vote_gate(acc, better):
                    vacc = evaluate_vote(val_loader, vote_step, generator)
                    stats["val_vote_acc"] = vacc
                    logger.info(f"[Validation_vote] EPOCH: {epoch}  acc_vote = {vacc:.4f}")
                    if vacc > best_vote:
                        best_vote = vacc
                        writer.submit(state, lambda s, step=state.step, va=vacc,
                                      mb={"best": best, "best_vote": best_vote}: (
                            save_checkpoint(os.path.join(ckpt_dir, "best_vote"), s, step,
                                            metrics={"acc_vote": va}, max_to_keep=1),
                            save_best_metrics(ckpt_dir, mb)))
            # the rolling save of the epoch, its sidecar at the next epoch's start
            save_rolling(state.step, {"epoch": epoch + 1, "batch": 0})
            last_saved_step = state.step
            logger.info(f"epoch {epoch}: " + " ".join(
                f"{k}={v:.5g}" for k, v in stats.items() if isinstance(v, (int, float))))
            write_record(stats)
            tb.add_scalar("loss", stats.get("loss", 0.0), epoch)
            # the epoch's rate: the schedule at its last update
            tb.add_scalar("lr", float(sched(max(state.step // args.accum_iter - 1, 0))), epoch)
            if "val_acc" in stats:
                tb.add_scalar("Metric/ACC", stats["val_acc"], epoch)
            if "val_vote_acc" in stats:
                tb.add_scalar("Metric/ACC_vote", stats["val_vote_acc"], epoch)
            tb.flush()
    finally:
        # on ANY exit: the saves in flight are of NaN-checked states, commit them
        writer.wait()
        guard.uninstall()
        tb.close()

    if args.vote:
        vote_acc = evaluate_vote(val_loader, vote_step, generator)
        logger.info(f"[TEST_VOTE] acc = {vote_acc:.4f}")
        write_record({"vote_acc": vote_acc})
        if best_vote:
            logger.info(f"best in-training vote acc {best_vote:.2f} (ckpt/best_vote)")
    if latest_step(ckpt_dir) != state.step:  # a run with no epoch left to train
        save_checkpoint(ckpt_dir, state, state.step)
    logger.info(f"best val acc {best:.2f}")
    return records


if __name__ == "__main__":
    main()
