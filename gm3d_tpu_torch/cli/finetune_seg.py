"""ShapeNetPart part-segmentation finetune from the command line.

Port of ``gm3d_tpu/cli/finetune_seg.py`` (reference
``main_finetune_segmentation.py``): loads a pretrain checkpoint (the port's
pretrain CLI's ``<output_dir>/ckpt``, GM3D or Point-MAE, or a reference
``.pth`` with ``--torch_ckpt``) into ``PointMAESeg``, trains with per-point
50-part cross-entropy and evaluates with the category-restricted arg-max and
instance / class mIoU::

  python -m gm3d_tpu_torch.cli.finetune_seg --config configs/pointmae/seg_shapenetpart.yaml \\
      --pretrained /tmp/run/ckpt --synthetic --epochs 2 --output_dir /tmp/seg

The recipe is the external Point-MAE segmentation script's: plain AdamW at
the config's rate, no layer decay, the per-iteration cosine with a 10-epoch
warm-up, the config's ``grad_norm_clip``. Same log files (``seg.log``, the
JSON-lines ``log.txt``, ``tfboard/`` with ``loss``, ``lr``, ``Metric/mIoU_I``
and ``Metric/mIoU_C``) and the same checkpoints in ``<output_dir>/ckpt`` as
the JAX CLI: a rolling save each epoch, ``--save_steps`` within one with the
loader position, ``ckpt/best`` on a new best instance mIoU with
``best_metrics.json``; written from a background thread unless
``--sync_save``; ``--resume``; a SIGTERM saves and exits 0. ``ckpt/best`` is
what ``cli/export_model.py --mode segmentation --ckpt`` exports for serving.

Runs on the GPU unless ``--device cpu`` is given. ``--steps_per_dispatch``
groups the steps as the JAX CLI does but runs them one by one;
``--batch_floor`` is a no-op. ``--native_loader`` reads the ShapeNetPart
``.npy`` caches with the C++ loader (``native/``), as the JAX CLI does.
Data-parallel over N GPUs with ``torchrun --nproc_per_node N``
(``parallel/``): each rank trains on its rows of the global batch, the
validation batches are split over ranks, rank 0 writes. A Point-M2AE config
(``configs/m2ae/seg_shapenetpart_PointM2AE.yaml``) trains ``PointM2AESeg``.
"""

from __future__ import annotations

import argparse
import logging
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
    rank_rows,
    setup_mesh,
)
from gm3d_tpu_torch.config import build_model_from_cfg
from gm3d_tpu_torch.data.datasets import SEG_CLASSES, DataLoader, build_dataset_from_cfg
from gm3d_tpu_torch.data.prefetch import device_prefetch
from gm3d_tpu_torch.parallel.mesh import barrier, check_global_batch, replicate_tree
from gm3d_tpu_torch.train.optim import build_finetune_optimizer, set_scheduled_lr
from gm3d_tpu_torch.train.schedules import cosine_warmup_schedule
from gm3d_tpu_torch.train.segmentation import (
    METRIC_KEYS,
    make_seg_eval_step,
    make_seg_multi_step,
    make_seg_train_step,
    run_seg_val,
)
from gm3d_tpu_torch.train.state import create_train_state
from gm3d_tpu_torch.utils import JsonlLogger, MetricLogger, ScalarWriter, get_logger
from gm3d_tpu_torch.utils.debug import check_finite_loss
from gm3d_tpu_torch.utils.pipeline import DeferredMetrics
from gm3d_tpu_torch.utils.preempt import PreemptionGuard

CLS_NAMES = sorted(SEG_CLASSES)


class SyntheticParts:
    """Synthetic part-seg data: the quadrant of a point in x and y picks its
    part within the category's part list (the JAX CLI's, array for array)."""

    def __init__(self, num_samples=64, npoints=256, seed=0):
        self.num_samples = num_samples
        self.npoints = npoints
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        cls = idx % len(CLS_NAMES)
        parts = SEG_CLASSES[CLS_NAMES[cls]]
        pts = rng.standard_normal((self.npoints, 3)).astype(np.float32)
        pts /= np.linalg.norm(pts, axis=1, keepdims=True).max()
        region = (pts[:, 0] > 0).astype(np.int64) + 2 * (pts[:, 1] > 0).astype(np.int64)
        seg = np.asarray(parts)[region % len(parts)]
        return CLS_NAMES[cls], "synthetic", (pts, cls, seg)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = base_parser("part segmentation fine-tune")
    p.add_argument("--pretrained", default=None,
                   help="a pretrain checkpoint root (the pretrain CLI's <output_dir>/ckpt) "
                        "or, with --torch_ckpt, a reference .pth")
    p.add_argument("--torch_ckpt", action="store_true", help="--pretrained is a torch .pth")
    p.add_argument("--steps_per_dispatch", type=int, default=8,
                   help="groups of K steps, as the JAX CLI dispatches them; here the steps "
                        "of a group run one by one. A trailing partial group runs as single "
                        "steps")
    return p.parse_args(argv)


def build_model(args, cfg, dtype: torch.dtype):
    """The config's seg model (``PointMAESeg`` or ``PointM2AESeg``), weights
    drawn from a generator seeded ``--seed`` (the JAX CLI's init key)."""
    model = build_model_from_cfg(cfg["model"], dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    return model


def make_seg_loaders(cfg, args):
    """(train_loader, val_loader), each yielding (points, category, part
    labels): on ``--synthetic``, ``SyntheticParts`` (train seed 1,
    validation seed 2, a quarter as many and at least 32); else the config's
    ``dataset.train`` and ``dataset.val``. The train loader shuffles by
    ``(--seed, epoch)``; validation keeps its order and its last partial
    batch. With ``--native_loader`` on the on-disk set (without normals),
    the train loader is the C++ one over the items' ``.npy`` caches, written
    first where missing; where they cannot be written (a read-only dataset
    directory), the Python loader reads the set, with a warning, as in the
    JAX CLI. Under data parallelism each rank keeps its rows of every train
    batch."""
    npoints = cfg.get("npoints", 2048)
    if args.synthetic:
        train_ds = SyntheticParts(args.synthetic_samples, npoints, seed=1)
        val_ds = SyntheticParts(max(args.synthetic_samples // 4, 32), npoints, seed=2)
    else:
        train_ds = build_dataset_from_cfg(cfg["dataset"]["train"])
        val_ds = build_dataset_from_cfg(cfg["dataset"]["val"])
    bs = cfg["total_bs"]
    check_global_batch(bs)
    val_loader = DataLoader(val_ds, bs, shuffle=False, drop_last=False,
                            num_workers=args.num_workers)
    if (args.native_loader and not args.synthetic and hasattr(train_ds, "_load_raw")
            and not getattr(train_ds, "use_normals", False)):
        native = native_seg_loader(train_ds, npoints, bs, args)
        if native is not None:
            return rank_rows(native), val_loader
    return (rank_rows(DataLoader(train_ds, bs, seed=args.seed, num_workers=args.num_workers)),
            val_loader)


def native_seg_loader(train_ds, npoints: int, batch: int, args):
    """The C++ loader over the ShapeNetPart items' (N, 7) ``.npy`` caches
    (``x y z nx ny nz part``), yielding (points, category, part labels); the
    caches are written once where missing. None, with a warning, where they
    cannot be written."""
    from gm3d_tpu_torch.native import NativeLabelledCloudLoader

    logger = logging.getLogger("gm3d.seg")
    paths, labels = [], []
    for name, path in train_ds.files:
        if not os.path.exists(path + ".npy"):
            train_ds._load_raw(path)  # writes the cache atomically
        paths.append(path + ".npy")
        labels.append(train_ds.cls_ids[name])
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        logger.warning(f"native loader disabled: {len(missing)} .npy caches could not be "
                       "written (read-only dataset dir?)")
        return None
    logger.info(f"native C++ loader over {len(paths)} cached items")
    return NativeLabelledCloudLoader(paths, labels, npoints, batch,
                                     num_workers=max(args.num_workers, 1), seed=args.seed,
                                     with_seg=True)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Train; returns the records written to ``log.txt``."""
    args = parse_args(argv)
    dev = setup_mesh(args)
    # fp32 products in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(args)
    logger = get_logger("gm3d.seg", os.path.join(args.output_dir, "seg.log"))
    jsonl = JsonlLogger(os.path.join(args.output_dir, "log.txt"))
    # the reference's TensorBoard tags: 'loss' / 'lr' of the engine; the seg
    # metric is mIoU, tagged as the JAX CLI tags it
    tb = ScalarWriter(os.path.join(args.output_dir, "tfboard"))
    dtype = compute_dtype(args)
    model = build_model(args, cfg, dtype)
    epochs = cfg["max_epoch"]
    train_loader, val_loader = make_seg_loaders(cfg, args)
    steps_per_epoch = max(len(train_loader), 1)
    if args.pretrained:
        load_pretrained_into(model, args.pretrained, torch_ckpt=args.torch_ckpt, logger=logger)
    model = model.to(dev)

    # plain AdamW at the config's rate, cosine with a 10-epoch warm-up, no
    # layer decay, the config's clip (the external seg script's recipe)
    lr = cfg["optimizer"]["kwargs"]["lr"]
    sched = cosine_warmup_schedule(lr, 1e-6, 10, epochs, steps_per_epoch)
    optimizer = build_finetune_optimizer(
        model.named_parameters(), sched(0), cfg["optimizer"]["kwargs"].get("weight_decay", 0.05),
        layer_decay=None, grad_clip=cfg.get("grad_norm_clip"))
    state = create_train_state(model, optimizer)
    if args.batch_floor:
        logger.info("--batch_floor is a no-op on the GPU")
    train_step = make_seg_train_step(model, optimizer, device=dev)

    def step_fn(state, pts, cls_label, seg, generator):
        set_scheduled_lr(optimizer, sched(state.step))
        return train_step(state, pts, cls_label, seg, generator)

    k_dispatch = args.steps_per_dispatch
    multi_fn = make_seg_multi_step(step_fn) if k_dispatch > 1 else None
    eval_step = make_seg_eval_step(model, device=dev)

    # the random sequence starts again from --seed on --resume, as the JAX CLI's key does
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    best = {"instance_miou": 0.0, "class_miou": 0.0}
    ckpt_dir = os.path.join(args.output_dir, "ckpt")
    writer = AsyncCheckpointWriter(enabled=not args.sync_save)
    records: List[dict] = []

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
            # cannot overwrite ckpt/best
            bm = load_best_metrics(ckpt_dir)
            best = {"instance_miou": float(bm.get("instance_miou", 0.0)),
                    "class_miou": float(bm.get("class_miou", 0.0))}
            logger.info(f"resumed from step {state.step} (epoch {start_epoch}, best inst "
                        f"mIoU {best['instance_miou'] * 100:.2f})")
            # a mid-epoch save names the exact next batch
            loader_token = load_loader_state(ckpt_dir)
            if loader_token:
                start_epoch = int(loader_token.get("epoch", start_epoch))
        train_loader.load_state(loader_token or {"epoch": start_epoch, "batch": 0})
        replicate_tree(model)  # every rank starts from rank 0's weights
        last_saved_step = state.step
        for epoch in range(start_epoch, epochs):
            meter = MetricLogger()
            t0 = time.time()

            def drain(metrics, k):
                # the host read: waits for that dispatch; one copy for all values
                values = torch.stack([metrics[n].reshape(-1) for n in METRIC_KEYS]).tolist()
                for j in range(k):
                    meter.update(**{n: v[j] for n, v in zip(METRIC_KEYS, values)})
                # the reference's NaN-loss hard exit, one dispatch late
                check_finite_loss(float(sum(values[0])), logger)

            dm = DeferredMetrics(drain, depth=0 if args.sync_metrics else 1)
            prefetcher = device_prefetch(train_loader, device=dev)
            pending = []

            def position():
                # the token as of the last batch yielded: resume replays nothing
                return prefetcher.state() or {"epoch": epoch, "batch": 0}

            def run(pts, cls_label, seg):
                _, metrics = step_fn(state, pts, cls_label, seg, generator)
                dm.push(metrics, 1)

            for batch in prefetcher:
                if multi_fn is None:
                    run(*batch)
                else:
                    pending.append(batch)
                    if len(pending) < k_dispatch:
                        continue
                    stacks = [torch.stack(col) for col in zip(*pending)]
                    _, metrics = multi_fn(state, *stacks, generator)
                    dm.push(metrics, len(pending))
                    pending = []
                if args.save_steps and state.step - last_saved_step >= args.save_steps:
                    # the deferred NaN checks first: a state whose loss was never
                    # checked must not replace the last good checkpoint
                    dm.flush()
                    save_rolling(state.step, position())
                    last_saved_step = state.step
                guard.exit_if_triggered(lambda: (dm.flush(), save_now(position())))
            for batch in pending:  # a partial group, as single steps
                run(*batch)
            dm.flush()
            # every step of this epoch is trained: a signal here skips the mIoU
            # pass and resumes at epoch + 1
            guard.exit_if_triggered(lambda: save_now({"epoch": epoch + 1, "batch": 0}))
            stats = meter.global_avgs()
            stats.update(epoch=epoch, time=round(time.time() - t0, 2))
            if (epoch + 1) % args.val_freq == 0 or epoch == epochs - 1:
                miou = run_seg_val(eval_step, val_loader, SEG_CLASSES, CLS_NAMES,
                                   depth=0 if args.sync_metrics else 4)
                stats["instance_miou"] = miou["instance_miou"] * 100
                stats["class_miou"] = miou["class_miou"] * 100
                if miou["instance_miou"] > best["instance_miou"]:
                    best = {k: miou[k] for k in ("instance_miou", "class_miou")}
                    writer.submit(state, lambda s, step=state.step, im=miou["instance_miou"],
                                  mb=dict(best): (
                        save_checkpoint(os.path.join(ckpt_dir, "best"), s, step,
                                        metrics={"instance_miou": im}, max_to_keep=1),
                        save_best_metrics(ckpt_dir, mb)))
            # the rolling save of the epoch, its sidecar at the next epoch's start
            save_rolling(state.step, {"epoch": epoch + 1, "batch": 0})
            last_saved_step = state.step
            logger.info(f"epoch {epoch}: " + " ".join(
                f"{k}={v:.5g}" for k, v in stats.items() if isinstance(v, (int, float))))
            jsonl.write(stats)
            records.append(stats)
            tb.add_scalar("loss", stats.get("loss", 0.0), epoch)
            # the epoch's rate: the schedule at its last step
            tb.add_scalar("lr", float(sched(max(state.step - 1, 0))), epoch)
            if "instance_miou" in stats:
                tb.add_scalar("Metric/mIoU_I", stats["instance_miou"], epoch)
                tb.add_scalar("Metric/mIoU_C", stats["class_miou"], epoch)
            tb.flush()
    finally:
        # on ANY exit: the saves in flight are of NaN-checked states, commit them
        writer.wait()
        guard.uninstall()
        tb.close()

    if latest_step(ckpt_dir) != state.step:  # a run with no epoch left to train
        save_checkpoint(ckpt_dir, state, state.step)
    barrier()  # the other ranks wait for rank 0's last writes
    logger.info(f"best inst mIoU {best['instance_miou'] * 100:.2f} / "
                f"class mIoU {best['class_miou'] * 100:.2f}")
    return records


if __name__ == "__main__":
    main()
