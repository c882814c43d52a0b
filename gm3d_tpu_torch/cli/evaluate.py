"""Test-only evaluation of a saved checkpoint.

Port of ``gm3d_tpu/cli/evaluate.py`` (reference ``tools/runner_finetune.py``
test_net / test_vote, ``main_pretrain.py:633-717``, ``main_knn.py``,
``main_linprob.py``). ``--probe``:

  acc      a finetune config and checkpoint: the validation accuracy, and with
           ``--vote`` the 10-vote accuracy, the best of ``--vote_repeats``
           passes (the published protocol repeats it and keeps the best,
           ``tools/runner_finetune.py:391-397``), each pass's draws from one
           generator seeded ``--seed``;
  svm, knn, linprob
           a pretrain config and checkpoint of ``--model_family gm3d`` /
           ``pointmae`` / ``m2ae``: the pooled encoder features of the SVM
           loaders, then the linear SVC (``eval/svm.py``), the weighted kNN
           (``eval/knn.py``) or the linear probe (``eval/linear_probe.py``);
           ``--svm_scales`` picks the Point-M2AE pooling (``both``: extract
           once under ``all``, fit ``all`` and the trailing ``last`` columns,
           report each and the better);
  seg      a seg config and checkpoint: instance and class mIoU of the
           validation set, the seg CLI's evaluation protocol.

::

  python -m gm3d_tpu_torch.cli.evaluate --config configs/pointmae/finetune_modelnet.yaml \\
      --ckpt experiments/ft/ckpt/best --vote --vote_repeats 10
  python -m gm3d_tpu_torch.cli.evaluate --config configs/m2ae/config_Point_M2AE.yaml \\
      --model_family m2ae --probe svm --svm_scales both --ckpt experiments/m2ae/ckpt

``--ckpt`` is a checkpoint root of the port's CLIs (``.../ckpt``, its latest
step, or ``.../ckpt/best``); a path without one raises ``FileNotFoundError``.
Without ``--ckpt`` the CLI warns and scores weights drawn from a seed (smoke
runs). Runs on the GPU unless ``--device cpu``; ``--batch_floor`` is a no-op.
The features and the probes' fits stay on the device. Under ``torchrun
--nproc_per_node N`` the evaluation batches are split over ranks
(``run_eval_batch``), and the feature probes extract each rank's block of the
sets and gather it (``gather_features``); every rank reports the same number.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from gm3d_tpu_torch.ckpt.checkpoint import restore_raw
from gm3d_tpu_torch.cli.common import (
    base_parser,
    compute_dtype,
    load_config,
    make_cls_loaders,
    make_loaders,
    rank_block_loader,
    setup_mesh,
)
from gm3d_tpu_torch.config import build_model_from_cfg
from gm3d_tpu_torch.models import GM3DStudent
from gm3d_tpu_torch.utils import get_logger


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = base_parser("test-only evaluation")
    p.add_argument("--ckpt", default=None, help="a checkpoint root of the port's CLIs")
    p.add_argument("--vote", action="store_true")
    p.add_argument("--vote_times", type=int, default=10)
    p.add_argument("--vote_repeats", type=int, default=1,
                   help="repeat the whole vote evaluation this many times with fresh "
                        "draws and report the MAX (the reference's published vote "
                        "protocol, tools/runner_finetune.py:391-397)")
    p.add_argument("--probe", choices=["acc", "svm", "knn", "linprob", "seg"], default="acc",
                   help="acc = finetuned-classifier accuracy (a finetune config); svm / knn / "
                        "linprob = frozen-feature probes on a PRETRAIN config and "
                        "checkpoint; seg = part-seg mIoU from a seg config and checkpoint")
    p.add_argument("--model_family", choices=["gm3d", "pointmae", "m2ae"], default="gm3d",
                   help="pretrain model family for --probe svm/knn/linprob")
    p.add_argument("--svm_scales", choices=["config", "all", "last", "both"],
                   default="config",
                   help="the M2AE probe's pooling: 'config' keeps the model's; 'both' "
                        "extracts once under 'all' and fits both protocols (--probe svm)")
    p.add_argument("--knn_k", type=int, default=20, help="neighbours for --probe knn")
    p.add_argument("--linprob_epochs", type=int, default=90,
                   help="epochs for --probe linprob (MAE linprob schedule)")
    return p.parse_args(argv)


def _restore_model(path: str) -> dict:
    """The saved ``model`` state dict of a checkpoint root; a path without a
    checkpoint raises (never a silent fall back to random weights)."""
    raw = restore_raw(path)
    if raw is None:
        raise FileNotFoundError(f"no checkpoint at {path}")
    return raw


def _encoder(model: torch.nn.Module) -> torch.nn.Module:
    """The part of a pretrain model the pooled features read."""
    return model.encoder if hasattr(model, "svm_scales") else model.MAE_encoder


def build_feature_model(args, cfg, dtype: torch.dtype, logger) -> torch.nn.Module:
    """The pretrain model of ``--model_family`` (the GM3D student from its class
    defaults, else the config's model), its weights from ``--ckpt`` (its
    encoder, the part the features read, loaded strictly) or, without one,
    drawn from seed 0 (the JAX CLI's init key)."""
    if args.model_family == "gm3d":
        model = GM3DStudent(dtype=dtype)
    else:
        model = build_model_from_cfg(cfg["model"], dtype=dtype)
    if args.ckpt:
        raw = _restore_model(args.ckpt)
        enc = _encoder(model)
        prefix = next(name for name, m in model.named_children() if m is enc) + "."
        enc.load_state_dict({k[len(prefix):]: v for k, v in raw["model"].items()
                             if k.startswith(prefix)}, strict=True)
        logger.info(f"restored pretrain ckpt step {int(raw['step'])}")
    else:
        logger.warning("no --ckpt: probing RANDOM features")
        model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def run_feature_probe(args, cfg, logger, dev: torch.device) -> float:
    """Frozen-feature probes over the pretrain encoder: the (mean + max)-pooled
    features the SVM gate uses, then the selected classifier. Returns the
    accuracy as a fraction."""
    from gm3d_tpu_torch.eval.knn import knn_classifier
    from gm3d_tpu_torch.eval.linear_probe import linear_probe
    from gm3d_tpu_torch.eval.svm import evaluate_svm, extract_features, make_feature_fn
    from gm3d_tpu_torch.parallel.multihost import gather_features

    npoints = cfg.get("npoints", 1024)
    _, svm_train, svm_test = make_loaders(cfg, args)
    svm_train, svm_test = rank_block_loader(svm_train), rank_block_loader(svm_test)
    model = build_feature_model(args, cfg, compute_dtype(args), logger)
    multi_scale = hasattr(model, "svm_scales")
    dual_protocol = args.svm_scales == "both"
    if dual_protocol:
        if args.probe != "svm" or not multi_scale:
            raise ValueError("--svm_scales both requires --probe svm and a "
                             "multi-scale model (m2ae)")
        model.svm_scales = "all"  # extract once; 'last' is the trailing slice
    elif args.svm_scales != "config" and multi_scale:
        model.svm_scales = args.svm_scales
        logger.info(f"svm feature scales overridden: {args.svm_scales}")
    model = model.to(dev)

    feature_fn = make_feature_fn(model, npoints)
    tr_f, tr_l = gather_features(*extract_features(feature_fn, svm_train, dev))
    te_f, te_l = gather_features(*extract_features(feature_fn, svm_test, dev))
    if dual_protocol:
        last_dim = int(model.encoder_dims[-1])
        acc_all = evaluate_svm(tr_f, tr_l, te_f, te_l)
        acc_last = evaluate_svm(tr_f[:, -last_dim:], tr_l, te_f[:, -last_dim:], te_l)
        logger.info(f"[PROBE svm] acc = {acc_all * 100:.4f} (svm_scales=all)")
        logger.info(f"[PROBE svm] acc = {acc_last * 100:.4f} (svm_scales=last)")
        best = "all" if acc_all >= acc_last else "last"
        acc = max(acc_all, acc_last)
        logger.info(f"[PROBE svm] best = {acc * 100:.4f} (svm_scales={best})")
        return acc
    if args.probe == "svm":
        acc = evaluate_svm(tr_f, tr_l, te_f, te_l)
    elif args.probe == "knn":
        acc = knn_classifier(tr_f, tr_l, te_f, te_l, k=min(args.knn_k, len(tr_l)))
    else:
        acc = linear_probe(tr_f, tr_l, te_f, te_l, epochs=args.linprob_epochs)
    logger.info(f"[PROBE {args.probe}] acc = {acc * 100:.4f}")
    return acc


def build_seg_model(args, cfg, dtype: torch.dtype, logger) -> torch.nn.Module:
    """The config's seg model, from ``--ckpt`` or, without one, drawn from
    ``--seed`` (the JAX CLI's init key)."""
    model = build_model_from_cfg(cfg["model"], dtype=dtype)
    if args.ckpt:
        raw = _restore_model(args.ckpt)
        model.load_state_dict(raw["model"], strict=True)
        logger.info(f"restored seg ckpt step {int(raw['step'])}")
    else:
        logger.warning("no --ckpt: evaluating RANDOM weights (smoke run)")
        model.reset_parameters(torch.Generator().manual_seed(args.seed))
    return model


def run_seg_eval(args, cfg, logger, dev: torch.device) -> dict:
    """Test-only part-segmentation mIoU: the seg CLI's per-epoch protocol
    (category-restricted arg-max, Point-MAE mIoU) without training. On
    ``--synthetic`` the validation set is ``max(--synthetic_samples, 32)``
    synthetic clouds of seed 2, as the JAX CLI draws it."""
    from gm3d_tpu_torch.cli.finetune_seg import CLS_NAMES, SyntheticParts
    from gm3d_tpu_torch.data.datasets import SEG_CLASSES, DataLoader, build_dataset_from_cfg
    from gm3d_tpu_torch.train.segmentation import make_seg_eval_step, run_seg_val

    model = build_seg_model(args, cfg, compute_dtype(args), logger).to(dev)
    npoints = cfg.get("npoints", 2048)
    if args.synthetic:
        val_ds = SyntheticParts(max(args.synthetic_samples, 32), npoints, seed=2)
    else:
        val_ds = build_dataset_from_cfg(cfg["dataset"]["val"])
    val_loader = DataLoader(val_ds, cfg["total_bs"], shuffle=False, drop_last=False,
                            num_workers=args.num_workers)
    miou = run_seg_val(make_seg_eval_step(model, device=dev), val_loader, SEG_CLASSES,
                       CLS_NAMES)
    logger.info(f"[TEST] instance mIoU = {miou['instance_miou'] * 100:.4f}  "
                f"class mIoU = {miou['class_miou'] * 100:.4f}")
    return miou


def build_classifier(args, cfg, dtype: torch.dtype, logger) -> torch.nn.Module:
    """The finetune config's classifier, from ``--ckpt`` or, without one,
    drawn from seed 0 (the JAX CLI's init key)."""
    model = build_model_from_cfg(cfg["model"], dtype=dtype)
    if args.ckpt:
        raw = _restore_model(args.ckpt)
        model.load_state_dict(raw["model"], strict=True)
        logger.info(f"restored ckpt step {int(raw['step'])}")
    else:
        logger.warning("no --ckpt: evaluating RANDOM weights (smoke run)")
        model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def run_accuracy(args, cfg, logger, dev: torch.device):
    """``(acc, vote_acc or None)``, both in percent."""
    from gm3d_tpu_torch.cli.finetune import evaluate, evaluate_vote
    from gm3d_tpu_torch.train.finetune import make_eval_step, make_vote_eval_step

    model = build_classifier(args, cfg, compute_dtype(args), logger).to(dev)
    npoints = cfg.get("npoints", 1024)
    _, val_loader = make_cls_loaders(cfg, args)
    acc = evaluate(val_loader, make_eval_step(model, npoints, device=dev))
    logger.info(f"[TEST] acc = {acc:.4f}")
    if not args.vote:
        return acc, None
    vote_step = make_vote_eval_step(model, npoints, args.vote_times, device=dev)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    vacc = 0.0
    for rep in range(args.vote_repeats):
        this = evaluate_vote(val_loader, vote_step, generator)
        vacc = max(vacc, this)
        if args.vote_repeats > 1:
            logger.info(f"[TEST_VOTE_time {rep + 1}] acc = {this:.4f}, best acc = {vacc:.4f}")
    logger.info(f"[TEST_VOTE] acc = {vacc:.4f}")
    return acc, vacc


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    dev = setup_mesh(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(args)
    logger = get_logger("gm3d.eval")
    if args.batch_floor:
        logger.info("--batch_floor is a no-op on the GPU")
    if args.probe == "seg":
        return run_seg_eval(args, cfg, logger, dev)
    if args.probe != "acc":
        return run_feature_probe(args, cfg, logger, dev)
    return run_accuracy(args, cfg, logger, dev)


if __name__ == "__main__":
    main()
