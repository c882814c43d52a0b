"""Shared CLI plumbing of the port.

Port of ``gm3d_tpu/cli/common.py``: the same flags, config overrides and
loaders. What differs: ``--device`` (the port takes an explicit device, and
runs on the GPU unless asked for the CPU); ``setup_mesh`` is a device check,
one device only; ``resolve_batch_floor`` is always 0 (the floor works around
a TPU compiler bug).
"""

from __future__ import annotations

import argparse
import os

import torch

from gm3d_tpu_torch.config import cfg_from_yaml_file
from gm3d_tpu_torch.data.datasets import DataLoader, SyntheticClouds, build_dataset_from_cfg
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
                   help="the C++ threaded cloud loader; not ported yet "
                        "(item 10): raises")
    p.add_argument("--num_workers", type=int, default=4,
                   help="threads that materialise the loader's batches")
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel devices; the port runs on one, more "
                        "raise (item 8)")
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
    """The training CLIs' device check, in place of the JAX package's
    data-parallel mesh: the device of ``--device`` (raises when it is CUDA
    and there is none). More than one device raises until the multi-GPU
    item of ``ROADMAP.md`` (Queue 1 item 8)."""
    if args.num_devices is not None and args.num_devices > 1:
        raise NotImplementedError(
            f"--num_devices {args.num_devices}: data parallelism over several GPUs is not "
            "ported yet (ROADMAP.md Queue 1 item 8); the port trains on one device")
    return resolve_device(args.device)


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
    ``(--seed, epoch)``, ``--num_workers`` threads."""
    if args.native_loader:
        raise NotImplementedError(
            "--native_loader (the C++ threaded cloud loader) is not ported yet "
            "(ROADMAP.md Queue 1 item 10)")
    if args.synthetic:
        train_ds = SyntheticClouds(args.synthetic_samples, cfg.get("npoints", 1024), seed=1)
    else:
        train_ds = build_dataset_from_cfg(cfg["dataset"]["train"])
    return _points_only(DataLoader(train_ds, cfg["total_bs"], seed=args.seed,
                                   num_workers=args.num_workers))


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
    return (
        _labelled(DataLoader(train_ds, bs, seed=args.seed, num_workers=workers)),
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
