"""Shared CLI plumbing of the port.

Port of ``gm3d_tpu/cli/common.py``: the same flags, config overrides and
loaders. What differs: ``--device`` (the port takes an explicit device, and
runs on the GPU unless asked for the CPU); ``setup_mesh`` joins the
``torchrun`` process group, one process per GPU (``parallel/``), where the
JAX package builds a device mesh; ``resolve_batch_floor`` is always 0 (the
floor works around a TPU compiler bug).

Under data parallelism every rank runs the same loaders from the same seed
(the JAX loader contract: every host holds the full global batch) and keeps
its rows: the train loaders through ``shard_batch``, the SVM probe's over a
contiguous block of the set, whose features ``gather_features`` joins.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from gm3d_tpu_torch.config import cfg_from_yaml_file
from gm3d_tpu_torch.data.datasets import DataLoader, SyntheticClouds, build_dataset_from_cfg
from gm3d_tpu_torch.parallel.context import active
from gm3d_tpu_torch.parallel.mesh import check_global_batch, make_mesh, shard_batch
from gm3d_tpu_torch.utils.device import resolve_device


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="device to run on (default: cuda, which fails when "
                        "there is no GPU; pass cpu to run on the CPU on purpose)")


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", required=True, help="YAML config (configs/...)")
    p.add_argument("--output_dir", default="./experiments/run")
    p.add_argument("--epochs", type=int, default=None, help="override max_epoch")
    p.add_argument("--batch_size", type=int, default=None, help="override total_bs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--val_freq", type=int, default=1)
    p.add_argument("--resume", action="store_true",
                   help="continue from <output_dir>/ckpt: the latest step, and the "
                        "loader position where a mid-epoch save left one")
    p.add_argument("--save_steps", type=int, default=0,
                   help="checkpoint every N optimizer steps within an epoch, with "
                        "the loader position (0: at epoch ends only)")
    p.add_argument("--synthetic", action="store_true",
                   help="use synthetic clouds instead of on-disk datasets")
    p.add_argument("--synthetic_samples", type=int, default=512)
    p.add_argument("--bf16", action="store_true", help="bf16 compute dtype")
    p.add_argument("--native_loader", action="store_true",
                   help="read ShapeNet-style .npy datasets with the C++ threaded "
                        "cloud loader (gm3d_tpu_torch/native, built with g++ at "
                        "first use; a failed build raises)")
    p.add_argument("--num_workers", type=int, default=4,
                   help="threads that materialise the loader's batches")
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel processes, one a GPU, launched by torchrun "
                        "--nproc_per_node N; where given, it must equal torchrun's "
                        "WORLD_SIZE (default: the world size, 1 without torchrun)")
    p.add_argument("--sync_save", action="store_true",
                   help="write checkpoints synchronously (the default copies the "
                        "state on the device and writes it from a background thread)")
    p.add_argument("--sync_metrics", action="store_true",
                   help="read each step's metrics synchronously instead of one "
                        "step behind (the default keeps the GPU's queue full; "
                        "utils/pipeline.py)")
    p.add_argument("--batch_floor", type=int, default=None,
                   help="compile-shape floor of the JAX package; a no-op here")
    add_device_arg(p)
    return p


def resolve_batch_floor(args, logger=None) -> int:
    """Always 0: the JAX package's floor works around a TPU compiler bug at
    small batches, which this card does not have."""
    return 0


def setup_mesh(args) -> torch.device:
    """The training CLIs' data mesh (``parallel/mesh.py::make_mesh``):
    under ``torchrun`` this process joins the group (NCCL with a card a rank
    for ``--device cuda``, gloo for ``--device cpu`` or ``--device cuda:K``,
    where every rank shares card K); ``--num_devices``, where given, must be
    the world size. Returns this rank's device (raises when it is CUDA and
    there is none)."""
    ctx = make_mesh(args.num_devices, args.device)
    return ctx.device if ctx is not None else resolve_device(args.device)


def load_config(args):
    cfg = cfg_from_yaml_file(args.config)
    if args.epochs is not None:
        cfg["max_epoch"] = args.epochs
    if args.batch_size is not None:
        cfg["total_bs"] = args.batch_size
    os.makedirs(args.output_dir, exist_ok=True)
    return cfg


def compute_dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.bf16 else torch.float32


def make_train_loader(cfg, args):
    """The train loader: bare points (ShapeNet contract), shuffled by
    ``(--seed, epoch)``, ``--num_workers`` threads; with ``--native_loader``
    on an on-disk ShapeNet-style set, the C++ loader (``native/``) over its
    ``.npy`` files, ``--num_workers`` threads (at least one). On
    ``--synthetic`` or a set that is not a list of ``.npy`` files the flag is
    ignored with a warning, as the JAX CLI ignores it. Under data
    parallelism each rank keeps its rows of every global batch."""
    bs = cfg["total_bs"]
    check_global_batch(bs)
    npoints = cfg.get("npoints", 1024)
    if args.synthetic:
        train_ds = SyntheticClouds(args.synthetic_samples, npoints, seed=1)
    else:
        train_ds = build_dataset_from_cfg(cfg["dataset"]["train"])
    if args.native_loader:
        if hasattr(train_ds, "file_list"):
            from gm3d_tpu_torch.native import NativeCloudLoader

            paths = [os.path.join(train_ds.pc_path, f) for _, _, f in train_ds.file_list]
            return rank_rows(NativeCloudLoader(paths, npoints, bs,
                                               num_workers=args.num_workers, seed=args.seed))
        logging.getLogger("gm3d").warning(
            "--native_loader reads on-disk ShapeNet-style .npy sets; this set is read by "
            "the Python loader")
    return rank_rows(_points_only(DataLoader(train_ds, bs, seed=args.seed,
                                             num_workers=args.num_workers)))


def make_loaders(cfg, args):
    """(train_loader, svm_train_loader, svm_test_loader): the SVM loaders
    yield (points, label), the train loader yields bare points."""
    bs = cfg["total_bs"]
    npoints = cfg.get("npoints", 1024)
    train_loader = make_train_loader(cfg, args)
    if args.synthetic:
        svm_tr = SyntheticClouds(max(args.synthetic_samples // 2, 64), npoints,
                                 num_classes=10, seed=2, labelled=True)
        svm_te = SyntheticClouds(max(args.synthetic_samples // 4, 64), npoints,
                                 num_classes=10, seed=3, labelled=True)
    else:
        svm_tr = build_dataset_from_cfg(cfg["dataset"]["extra_train_svm"])
        svm_te = build_dataset_from_cfg(cfg["dataset"]["extra_test_svm"])
    # the reference doubles the SVM loader batch (main_pretrain.py:262-263)
    svm_train = _labelled(DataLoader(svm_tr, bs * 2, shuffle=False, drop_last=False))
    svm_test = _labelled(DataLoader(svm_te, bs * 2, shuffle=False, drop_last=False))
    return train_loader, svm_train, svm_test


def rank_block_loader(loader):
    """An evaluation loader (``make_loaders``' SVM loaders) over this rank's
    contiguous block of its set (``rank_block``), same batch size and order;
    the loader itself for one process."""
    if active() is None:
        return loader
    inner = loader.loader
    return _labelled(DataLoader(rank_block(inner.dataset), inner.batch_size, shuffle=False,
                                drop_last=False, num_workers=inner.num_workers))


class rank_block:
    """This rank's contiguous block of a dataset's items (the whole set for
    one process): ranks take ``numpy.array_split``'s blocks in rank order, so
    features extracted block by block and gathered in rank order
    (``gather_features``) are the single-process matrix row for row."""

    def __init__(self, dataset):
        ctx = active()
        n = len(dataset)
        world, rank = (1, 0) if ctx is None else (ctx.world, ctx.rank)
        self.dataset = dataset
        self.start = rank * (n // world) + min(rank, n % world)
        self.stop = self.start + n // world + (rank < n % world)

    def __len__(self):
        return self.stop - self.start

    def __getitem__(self, idx):
        return self.dataset[self.start + idx]

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)


def make_cls_loaders(cfg, args):
    """(train_loader, val_loader) of the finetune CLI, each yielding (points,
    labels): on ``--synthetic``, labelled clouds in the config's ``cls_dim``
    classes (train seed 1, validation seed 2, a quarter as many and at least
    64); else the config's ``dataset.train`` and ``dataset.val``. The train
    loader shuffles by ``(--seed, epoch)``; validation keeps its order and
    its last partial batch."""
    bs = cfg["total_bs"]
    npoints = cfg.get("npoints", 1024)
    if args.synthetic:
        ncls = cfg["model"].get("cls_dim", 40)
        train_ds = SyntheticClouds(args.synthetic_samples, npoints,
                                   num_classes=ncls, seed=1, labelled=True)
        val_ds = SyntheticClouds(max(args.synthetic_samples // 4, 64), npoints,
                                 num_classes=ncls, seed=2, labelled=True)
    else:
        train_ds = build_dataset_from_cfg(cfg["dataset"]["train"])
        val_ds = build_dataset_from_cfg(cfg["dataset"]["val"])
    workers = getattr(args, "num_workers", 0)
    check_global_batch(bs)
    return (
        rank_rows(DataLoader(train_ds, bs, seed=args.seed, num_workers=workers)),
        _labelled(DataLoader(val_ds, bs, shuffle=False, drop_last=False,
                             num_workers=workers)),
    )


class _points_only:
    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            yield batch[0] if isinstance(batch, tuple) else batch

    def __getattr__(self, name):  # state()/load_state()/epoch passthrough
        return getattr(self.loader, name)


class rank_rows:
    """A global-batch loader whose batches keep this rank's rows
    (``shard_batch``); the identity for one process. ``state`` and the rest
    pass through."""

    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            yield shard_batch(batch)

    def __getattr__(self, name):
        return getattr(self.loader, name)


class _labelled:
    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            yield batch  # (points, labels)

    def __getattr__(self, name):
        return getattr(self.loader, name)
