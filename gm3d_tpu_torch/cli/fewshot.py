"""Few-shot classification from the command line.

Port of ``gm3d_tpu/cli/fewshot.py`` (reference ``cfgs/fewshot.yaml``
protocol): for each of ``--folds`` {way}-way {shot}-shot episodes, a fresh
``PointTransformer`` with ``way`` classes, the pretrain checkpoint overlaid
(``--pretrained``), trained with the legacy runner's recipe and evaluated on
the fold's test clouds; the best accuracy of each fold, their mean and
standard deviation go into ``fewshot.log`` and, as one record
``{"way", "shot", "mean", "std", "accs"}``, into ``log.txt``::

  python -m gm3d_tpu_torch.cli.fewshot --config configs/pointmae/fewshot.yaml \\
      --way 5 --shot 10 --folds 10 --pretrained /tmp/run/ckpt --synthetic --output_dir /tmp/fs

The recipe is the legacy one of ``cli/finetune.py``: the config's rate
verbatim, the per-epoch cosine over the scheduler's epochs with its warm-up,
no decay on 1-d parameters, biases and tokens, the clip ``grad_norm_clip``,
no layer decay, the label smoothing of the config's ``model.smooth``.

Fold ``f`` draws its initial weights and its steps' random numbers from
generators seeded ``f``, and shuffles its episode by ``f``, as the JAX CLI's
keys do. By default (``--parallel_folds``) the folds train together, as the
JAX CLI's one ``vmap`` over them does: F per-fold models stacked into one
fold-batched model (``train/finetune.py::FoldedModel``), one batched step a
batch of every fold under ``torch.func.vmap`` (FPS and KNN one launch each for
all folds), one batched evaluation a test batch, each fold still drawing from
its own generator; each fold computes what it computes alone.
``--no-parallel_folds`` runs them one after another. Both give the same
record.

Runs on the GPU unless ``--device cpu`` is given; ``--batch_floor`` is a
no-op. Under ``torchrun --nproc_per_node N`` the folds are dealt to ranks,
fold f to rank f mod N, each rank's folds run as in one process
(``replica_scope``; together, or in turn) with their own generators, and
the accuracies are summed over ranks: the same numbers as one process
computes, as the JAX CLI's folds over devices are. A Point-M2AE config
(``configs/m2ae/fewshot-Point-M2AE.yaml``: label smoothing 0.3) trains the
hierarchical classifier.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gm3d_tpu_torch.ckpt.transfer import load_pretrained_into
from gm3d_tpu_torch.cli.common import base_parser, compute_dtype, load_config, setup_mesh
from gm3d_tpu_torch.config import build_model_from_cfg
from gm3d_tpu_torch.data.datasets import DataLoader, SyntheticClouds, build_dataset_from_cfg
from gm3d_tpu_torch.eval.metrics import accuracy
from gm3d_tpu_torch.parallel.context import get_context, replica_scope
from gm3d_tpu_torch.parallel.mesh import barrier
from gm3d_tpu_torch.train.finetune import (FoldedModel, make_eval_step,
                                           make_finetune_train_step,
                                           make_fold_batched_eval_step,
                                           make_fold_batched_train_step)
from gm3d_tpu_torch.train.optim import build_legacy_adamw, set_scheduled_lr
from gm3d_tpu_torch.train.schedules import legacy_cosine_epoch_schedule
from gm3d_tpu_torch.train.state import create_train_state
from gm3d_tpu_torch.utils import JsonlLogger, get_logger


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = base_parser("few-shot classification")
    p.add_argument("--way", type=int, default=5)
    p.add_argument("--shot", type=int, default=10)
    p.add_argument("--folds", type=int, default=10)
    p.add_argument("--pretrained", default=None,
                   help="a pretrain checkpoint root (the pretrain CLI's <output_dir>/ckpt) "
                        "or, with --torch_ckpt, a reference .pth; each fold is fine-tuned "
                        "from it, the reference few-shot protocol")
    p.add_argument("--torch_ckpt", action="store_true", help="--pretrained is a torch .pth")
    p.add_argument("--parallel_folds", default=True, action=argparse.BooleanOptionalAction,
                   help="train a process's folds together, as one fold-batched model "
                        "(torch.func.vmap over the stacked folds: episode batches are "
                        "small, so the folds are the batch); each fold computes what it "
                        "computes alone. --no-parallel_folds runs them one after another")
    return p.parse_args(argv)


def make_fold_data(args, cfg, fold: int, npoints: int):
    """(train_loader, test_loader) of one fold, each yielding (points,
    labels): on ``--synthetic``, ``way * shot`` training and ``way * 20``
    test clouds in ``way`` classes (seeds ``fold`` and ``fold + 100``); else
    the config's ``ModelNetFewShot`` fold. The batch is the config's or the
    whole episode where that is smaller; the train loader shuffles by
    ``(fold, epoch)``."""
    way = args.way
    if args.synthetic:
        train_ds = SyntheticClouds(way * args.shot, npoints, num_classes=way,
                                   seed=fold, labelled=True)
        test_ds = SyntheticClouds(way * 20, npoints, num_classes=way,
                                  seed=fold + 100, labelled=True)
    else:
        for key in ("train", "val"):
            cfg["dataset"][key]["others"].update(way=way, shot=args.shot, fold=fold)
        train_ds = build_dataset_from_cfg(cfg["dataset"]["train"])
        test_ds = build_dataset_from_cfg(cfg["dataset"]["val"])
    bs = min(cfg["total_bs"], len(train_ds))
    return (DataLoader(train_ds, bs, seed=fold),
            DataLoader(test_ds, bs, shuffle=False, drop_last=False))


def build_model(args, cfg, fold: int, dtype: torch.dtype):
    """The config's classifier (``PointTransformer``, or ``PointM2AEClassifier``
    of ``fewshot-Point-M2AE.yaml``) with ``way`` classes, weights drawn from a
    generator seeded ``fold`` (the JAX CLI's init key)."""
    model = build_model_from_cfg({**cfg["model"], "cls_dim": args.way}, dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(fold))
    return model


def init_fold_model(args, cfg, fold: int, dtype: torch.dtype, logger):
    """Per-fold initialisation and pretrain overlay (few-shot is the
    finetune protocol); the transfer report is logged for fold 0 only."""
    model = build_model(args, cfg, fold, dtype)
    if args.pretrained:
        load_pretrained_into(model, args.pretrained, torch_ckpt=args.torch_ckpt,
                             logger=logger if fold == 0 else None)
    return model


def _schedule(cfg, steps_per_epoch: int):
    """The legacy runner's per-epoch cosine (cfgs/fewshot.yaml is
    legacy-format); its horizon is the scheduler's epochs, not --epochs."""
    return legacy_cosine_epoch_schedule(
        cfg["optimizer"]["kwargs"]["lr"],
        cfg["scheduler"]["kwargs"].get("epochs", cfg["max_epoch"]),
        cfg["scheduler"]["kwargs"]["initial_epochs"], max(steps_per_epoch, 1))


def _evaluates(args, epoch: int, epochs: int) -> bool:
    return (epoch + 1) % args.val_freq == 0 or epoch == epochs - 1


def run_fold(args, cfg, fold: int, logger, dev: torch.device) -> float:
    """Train and evaluate one fold; its best test accuracy in percent."""
    dtype = compute_dtype(args)
    npoints = cfg.get("npoints", 1024)
    train_loader, test_loader = make_fold_data(args, cfg, fold, npoints)
    model = init_fold_model(args, cfg, fold, dtype, logger).to(dev)
    epochs = cfg["max_epoch"]
    sched = _schedule(cfg, len(train_loader))
    optimizer = build_legacy_adamw(model.named_parameters(), sched(0),
                                   cfg["optimizer"]["kwargs"]["weight_decay"],
                                   grad_clip=cfg.get("grad_norm_clip"))
    state = create_train_state(model, optimizer)
    smoothing = cfg["model"].get("smooth", 0.0)
    if fold == 0 and smoothing:
        logger.info(f"label smoothing {smoothing} (config model.smooth)")
    step = make_finetune_train_step(model, optimizer, npoints, smoothing, device=dev)
    eval_step = make_eval_step(model, npoints, device=dev)

    generator = torch.Generator(device=dev).manual_seed(fold)
    best = 0.0
    for epoch in range(epochs):
        for pts, labels in train_loader:
            set_scheduled_lr(optimizer, sched(state.step))
            step(state, torch.as_tensor(pts), torch.as_tensor(labels), generator)
        if _evaluates(args, epoch, epochs):
            logits, labels_all = [], []
            for pts, labels in test_loader:
                logits.append(eval_step(torch.as_tensor(pts)))
                labels_all.append(np.asarray(labels))
            acc = accuracy(torch.cat(logits).float().cpu().numpy(),
                           np.concatenate(labels_all)) * 100.0
            best = max(best, acc)
    logger.info(f"fold {fold}: best acc {best:.2f}")
    return best


def _stacked(batches) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch of every fold -> (F, B, ...) points and labels."""
    return (torch.from_numpy(np.stack([np.asarray(b[0]) for b in batches])),
            torch.from_numpy(np.stack([np.asarray(b[1]) for b in batches])))


def run_folds_together(args, cfg, folds: List[int], logger, dev: torch.device) -> List[float]:
    """Train and evaluate ``folds`` together (the JAX CLI's
    ``run_folds_parallel``): each fold's model from ``init_fold_model``,
    stacked into one ``FoldedModel``, its draws from the generator seeded by
    its index; one fold-batched step a batch of every fold, one fold-batched
    evaluation a test batch. The folds' episodes must be of one size, as the
    protocol's are. Returns each fold's best test accuracy in percent, in the
    order of ``folds``."""
    dtype = compute_dtype(args)
    npoints = cfg.get("npoints", 1024)
    loaders = [make_fold_data(args, cfg, fold, npoints) for fold in folds]
    train_loaders, test_loaders = [t for t, _ in loaders], [t for _, t in loaders]
    for kind, group in (("train", train_loaders), ("test", test_loaders)):
        if len({(len(t), len(t.dataset)) for t in group}) > 1:
            raise ValueError(f"the folds' {kind} episodes differ in size and cannot be "
                             "trained together: pass --no-parallel_folds")
    folded = FoldedModel([init_fold_model(args, cfg, fold, dtype, logger) for fold in folds],
                         dev)
    epochs = cfg["max_epoch"]
    sched = _schedule(cfg, len(train_loaders[0]))
    optimizer = build_legacy_adamw(folded.params.items(), sched(0),
                                   cfg["optimizer"]["kwargs"]["weight_decay"],
                                   grad_clip=cfg.get("grad_norm_clip"), fold_axis=True)
    state = create_train_state(folded, optimizer)
    smoothing = cfg["model"].get("smooth", 0.0)
    if smoothing:
        logger.info(f"label smoothing {smoothing} (config model.smooth)")
    step = make_fold_batched_train_step(folded, optimizer, npoints, smoothing, device=dev)
    eval_step = make_fold_batched_eval_step(folded, npoints, device=dev)

    generators = [torch.Generator(device=dev).manual_seed(fold) for fold in folds]
    best = np.zeros(len(folds))
    for epoch in range(epochs):
        # every fold's epoch drained to its end before zipping: a loader left
        # mid-epoch never increments its epoch, and would replay its shuffle
        for batches in zip(*[list(t) for t in train_loaders]):
            set_scheduled_lr(optimizer, sched(state.step))
            step(state, *_stacked(batches), generators)
        if _evaluates(args, epoch, epochs):
            logits, labels_all = [], []
            for batches in zip(*[list(t) for t in test_loaders]):
                pts, labels = _stacked(batches)
                logits.append(eval_step(pts))
                labels_all.append(labels.numpy())
            logits_np = torch.cat(logits, dim=1).float().cpu().numpy()
            labels_np = np.concatenate(labels_all, axis=1)
            accs = [accuracy(logits_np[i], labels_np[i]) * 100.0 for i in range(len(folds))]
            best = np.maximum(best, accs)
    for fold, acc in zip(folds, best):
        logger.info(f"fold {fold}: best acc {acc:.2f}")
    return [float(a) for a in best]


def run_folds(args, cfg, logger, dev: torch.device) -> List[float]:
    """Every fold's best accuracy, in fold order: fold f runs on rank f mod
    the world size, as one process (a rank's folds together with
    ``--parallel_folds``, else in turn), and the accuracies are summed over
    ranks on the host group."""
    ctx = get_context()
    world, rank = (1, 0) if ctx is None else (ctx.world, ctx.rank)
    accs = torch.zeros(args.folds, dtype=torch.float64)
    mine = list(range(rank, args.folds, world))
    with replica_scope():
        if args.parallel_folds and mine:
            accs[mine] = torch.tensor(run_folds_together(args, cfg, mine, logger, dev),
                                      dtype=torch.float64)
        else:
            for fold in mine:
                accs[fold] = run_fold(args, cfg, fold, logger, dev)
    if ctx is not None:
        dist.all_reduce(accs, group=ctx.host_group)
    return accs.tolist()


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Run every fold; returns the record written to ``log.txt``, in a list."""
    args = parse_args(argv)
    dev = setup_mesh(args)
    # fp32 products in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(args)
    logger = get_logger("gm3d.fewshot", os.path.join(args.output_dir, "fewshot.log"))
    jsonl = JsonlLogger(os.path.join(args.output_dir, "log.txt"))
    if args.batch_floor:
        logger.info("--batch_floor is a no-op on the GPU")
    accs = run_folds(args, cfg, logger, dev)
    mean, std = float(np.mean(accs)), float(np.std(accs))
    logger.info(f"{args.way}-way {args.shot}-shot over {args.folds} folds: "
                f"{mean:.1f} +/- {std:.1f}")
    record = {"way": args.way, "shot": args.shot, "mean": mean, "std": std, "accs": accs}
    jsonl.write(record)
    barrier()
    return [record]


if __name__ == "__main__":
    main()
