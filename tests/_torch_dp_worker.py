"""The data-parallel scenarios of ``tests/test_torch_port_parallel.py``.

``run_all()`` runs each scenario with small models on the CPU: in the test's
own process without a context (one process, the global batch), and in each
of two gloo ranks started as ``python _torch_dp_worker.py RANK WORLD PORT
OUT``, each on its rows of the same global batches. Every scenario returns
numpy arrays and floats; per-row results (masks, features) are gathered so
that both layouts return whole-batch values.
"""

import argparse
import json
import logging
import os
import sys
from datetime import timedelta

import numpy as np
import torch
import yaml

from gm3d_tpu_torch.cli import fewshot as fewshot_cli
from gm3d_tpu_torch.cli import pretrain as pretrain_cli_module
from gm3d_tpu_torch.cli.common import rank_block
from gm3d_tpu_torch.cli.pretrain import step_draws
from gm3d_tpu_torch.config import cfg_from_yaml_file
from gm3d_tpu_torch.data.datasets import DataLoader, SyntheticClouds
from gm3d_tpu_torch.eval.svm import extract_features, make_feature_fn
from gm3d_tpu_torch.models import GM3DStudent, PointMAE
from gm3d_tpu_torch.models.blocks import TorchBatchNorm
from gm3d_tpu_torch.models.m2ae import PointM2AE
from gm3d_tpu_torch.models.point_transformer import Classifier, PointTransformer
from gm3d_tpu_torch.models.segmentation import PointMAESeg
from gm3d_tpu_torch.parallel.context import get_context
from gm3d_tpu_torch.parallel.mesh import average_gradients, gather_rows, shard_batch
from gm3d_tpu_torch.parallel.multihost import gather_features
from gm3d_tpu_torch.train import pretrain as tp
from gm3d_tpu_torch.train.finetune import make_finetune_train_step
from gm3d_tpu_torch.train.optim import (
    build_adamw,
    build_finetune_optimizer,
    build_gm3d_shared_optimizer,
    build_legacy_adamw,
)
from gm3d_tpu_torch.train.segmentation import make_seg_train_step
from gm3d_tpu_torch.train.state import create_train_state

# stochastic depth on, so that its draws go through the lockstep route
SMALL = dict(trans_dim=32, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=32,
             drop_path_rate=0.1)
B, N, STEPS = 4, 128, 3
SCALARS = {"keep_ratio": 0.5, "ema_decay": 0.99, "w_mse": 1.0, "w_cd": 1.0}


def _clouds(seed, b=B, n=N):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((b, n, 3))
                            .astype(np.float32))


def _init(model, seed):
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def _bn_stats(module):
    return {name: b.detach().numpy().copy() for name, b in module.named_buffers()
            if name.endswith(("running_mean", "running_var"))}


def gm3d_dino():
    """The GM3D step in ``dino`` with a small teacher, 3 steps."""
    student = _init(GM3DStudent(decoder_depth=1, decoder_num_heads=2, **SMALL), 1)
    teacher = _init(PointMAE(decoder_depth=1, decoder_num_heads=2, **SMALL), 2)
    opt = build_gm3d_shared_optimizer(student, 1e-3)
    state = create_train_state(student, opt, with_ema=True)
    step = tp.make_gm3d_train_step(student, teacher, opt, device="cpu")
    gen = torch.Generator().manual_seed(0)
    out = {"metrics": [], "masks": []}
    for i in range(STEPS):
        pts = shard_batch(_clouds(10 + i))
        draws = step_draws(gen, pts.shape[0], student.num_group)
        state, m = step(state, pts, gen, SCALARS, draws=draws)
        out["metrics"].append(_floats(m))
        out["masks"].append(gather_rows(step.last_mask).numpy())
    out["bn"] = _bn_stats(student)
    return out


def pointmae_teacher():
    """The Point-MAE teacher's step (random mask), 3 steps."""
    model = _init(PointMAE(decoder_depth=1, decoder_num_heads=2, **SMALL), 3)
    opt = build_legacy_adamw(model.named_parameters(), 1e-3)
    state = create_train_state(model, opt)
    step = tp.make_pointmae_train_step(model, opt, device="cpu")
    gen = torch.Generator().manual_seed(1)
    out = {"metrics": []}
    for i in range(STEPS):
        pts = shard_batch(_clouds(20 + i))
        state, m = step(state, pts, gen, draws=step_draws(gen, pts.shape[0], model.num_group))
        out["metrics"].append(_floats(m))
    out["bn"] = _bn_stats(model)
    return out


def m2ae_gm3d():
    """The Point-M2AE + GM3D step (its masked-group count is a global one),
    3 steps."""
    model = _init(PointM2AE(num_groups=(32, 16, 8), group_sizes=(8, 4, 4),
                            encoder_depths=(1, 1, 1), encoder_dims=(24, 48, 96),
                            local_radius=(0.32, 0.64, 1.28), decoder_dims=(96, 48),
                            decoder_depths=(1, 1), num_heads=2), 7)
    opt = build_adamw(model.named_parameters(), 1e-3, grad_clip=5.0)
    state = create_train_state(model, opt, with_ema=True)
    step = tp.make_m2ae_gm3d_train_step(model, opt, 0.8, device="cpu")
    gen = torch.Generator().manual_seed(4)
    out = {"metrics": []}
    for i in range(STEPS):
        pts = shard_batch(_clouds(60 + i))
        draws = step_draws(gen, pts.shape[0], model.num_groups[-1])
        state, m = step(state, pts, gen, SCALARS, draws=draws)
        out["metrics"].append(_floats(m))
    out["bn"] = _bn_stats(model)
    return out


def probe_step():
    """The ``--classification`` probe's step (the classifier's BatchNorms and
    dropout draws), 3 steps."""
    feat_model = _init(PointMAE(decoder_depth=1, decoder_num_heads=2, **SMALL), 8)
    classifier = _init(Classifier(dim=32, cls_dim=5), 9)
    opt = build_adamw(classifier.named_parameters(), 2e-5)
    state = create_train_state(classifier, opt)
    step = tp.make_probe_step(feat_model, classifier, opt, device="cpu")
    gen = torch.Generator().manual_seed(5)
    out = {"metrics": []}
    for i in range(STEPS):
        pts, labels = shard_batch((_clouds(70 + i), torch.arange(B) % 5))
        state, m = step(state, pts, labels, gen, draws=tp.probe_draws(gen, pts.shape[0]))
        out["metrics"].append(_floats(m))
    out["bn"] = _bn_stats(classifier)
    return out


def finetune():
    """The classification finetune step (BatchNorm in the patch embed and the
    head, the head's dropout), 3 steps of 1,024-point clouds."""
    model = _init(PointTransformer(cls_dim=5, **SMALL), 4)
    # small models are chaotic (ROADMAP.md Queue 3): the finetune tests' rate
    opt = build_finetune_optimizer(model.named_parameters(), 2e-5, grad_clip=10.0)
    state = create_train_state(model, opt)
    step = make_finetune_train_step(model, opt, 1024, smoothing=0.2, device="cpu")
    gen = torch.Generator().manual_seed(2)
    out = {"metrics": []}
    for i in range(STEPS):
        pts = _clouds(30 + i, n=1024)
        labels = torch.arange(B) % 5
        pts, labels = shard_batch((pts, labels))
        state, m = step(state, pts, labels, gen)
        out["metrics"].append(_floats(m))
    out["bn"] = _bn_stats(model)
    return out


def segmentation():
    """The part-segmentation step, 3 steps."""
    model = _init(PointMAESeg(feature_blocks=(0, 1), num_classes=4, num_parts=6, **SMALL), 5)
    opt = build_adamw(model.named_parameters(), 2e-5, grad_clip=10.0)
    state = create_train_state(model, opt)
    step = make_seg_train_step(model, opt, device="cpu")
    gen = torch.Generator().manual_seed(3)
    out = {"metrics": []}
    for i in range(STEPS):
        pts = _clouds(40 + i)
        cls = torch.arange(B) % 4
        seg = torch.from_numpy(np.random.default_rng(50 + i).integers(0, 6, (B, N)))
        rows = shard_batch((pts, cls, seg))
        state, m = step(state, *rows, gen)
        out["metrics"].append(_floats(m))
    out["bn"] = _bn_stats(model)
    return out


def batch_norm():
    """``TorchBatchNorm`` in train mode on this process's rows of an (8, 5, 6)
    batch: outputs, running statistics, and the gradients of the mean over
    the global batch of a weighted sum of the outputs (the input's scaled to
    the global objective, the parameters' averaged over ranks, as the steps
    average them)."""
    bn = TorchBatchNorm(6).train()
    rng = np.random.default_rng(8)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(6).astype(np.float32)))
    x = torch.from_numpy((rng.standard_normal((8, 5, 6)) * 3 + 1).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 5, 6)).astype(np.float32))
    x, w = shard_batch((x, w))
    x = x.clone().requires_grad_()
    y = bn(x)
    ((y * w).sum(dim=(1, 2)).mean()).backward()
    average_gradients([bn.weight, bn.bias])
    ctx = get_context()
    world = 1 if ctx is None else ctx.world
    return {"y": y.detach().numpy(), "x_grad": (x.grad / world).numpy(),
            "running_mean": bn.running_mean.numpy().copy(),
            "running_var": bn.running_var.numpy().copy(),
            "weight_grad": bn.weight.grad.numpy().copy(), "bias_grad": bn.bias.grad.numpy().copy()}


def probe_features():
    """The SVM probe's features of a set of 10 clouds (rows do not divide by
    two ranks in every batch): each rank's block, then ``gather_features``."""
    model = _init(PointMAE(decoder_depth=1, decoder_num_heads=2, **SMALL), 6)
    ds = SyntheticClouds(10, N, num_classes=3, seed=7, labelled=True)
    loader = DataLoader(rank_block(ds), 4, shuffle=False, drop_last=False)
    feats, labels = gather_features(*extract_features(make_feature_fn(model, N), loader, "cpu"))
    return {"features": feats.numpy(), "labels": labels.numpy()}


def fewshot_folds():
    """Two few-shot folds through the CLI's ``run_folds``, each rank's folds
    trained together (the default ``--parallel_folds``)."""
    cfg = cfg_from_yaml_file("configs/pointmae/fewshot.yaml")
    cfg["model"].update(SMALL)
    cfg["max_epoch"] = 1
    cfg["total_bs"] = 4
    args = argparse.Namespace(way=2, shot=2, folds=2, synthetic=True, val_freq=1,
                              pretrained=None, torch_ckpt=False, bf16=False,
                              parallel_folds=True)
    return {"accs": fewshot_cli.run_folds(args, cfg, logging.getLogger("dp-test"),
                                          torch.device("cpu"))}


class _NoScalars:
    def __init__(self, log_dir):
        pass

    def add_scalar(self, tag, value, step):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def pretrain_cli(out: str):
    """The pretrain CLI (``--model_family pointmae``, a small config) for two
    epochs of two steps, with its SVM probe in the background thread (the
    features gathered over ranks) after the last: the records every rank
    returns, and what the run wrote (rank 0 alone)."""
    cfg = yaml.safe_load(open("configs/pointmae/config_m.yaml"))
    cfg["model"].update(group_size=8, num_group=16)
    cfg["model"]["transformer_config"].update(
        trans_dim=32, encoder_dims=32, depth=1, num_heads=2, decoder_depth=1,
        decoder_num_heads=2, drop_path_rate=0.1, mask_ratio=0.6)
    cfg["npoints"] = N
    ctx = get_context()
    config = os.path.join(out, f"tiny_pointmae_{0 if ctx is None else ctx.rank}.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    run = os.path.join(out, "cli")
    # no TensorBoard writer: importing it pulls in TensorFlow where that is
    # installed (seconds), and the scalars are not what this scenario checks
    writer, pretrain_cli_module.ScalarWriter = pretrain_cli_module.ScalarWriter, _NoScalars
    try:
        records = pretrain_cli_module.main([
            "--config", config, "--model_family", "pointmae", "--synthetic", "--synthetic_samples",
            "8", "--batch_size", "4", "--epochs", "2", "--val_freq", "2", "--num_workers", "0",
            "--device", "cpu", "--output_dir", run])
    finally:
        pretrain_cli_module.ScalarWriter = writer
    with open(os.path.join(run, "log.txt")) as f:
        logged = [json.loads(line) for line in f]
    return {"records": records, "logged": logged,
            "ckpt": sorted(os.listdir(os.path.join(run, "ckpt")))}


SCENARIOS = {"gm3d_dino": gm3d_dino, "pointmae_teacher": pointmae_teacher,
             "m2ae_gm3d": m2ae_gm3d, "probe_step": probe_step,
             "finetune": finetune, "segmentation": segmentation, "batch_norm": batch_norm,
             "probe_features": probe_features, "fewshot_folds": fewshot_folds}


def run_all(out: str):
    """Every scenario; ``out`` is a directory the CLI scenario writes into
    (the same one for every rank, as ``torchrun``'s ranks share theirs)."""
    torch.manual_seed(0)
    results = {name: fn() for name, fn in SCENARIOS.items()}
    results["pretrain_cli"] = pretrain_cli(out)
    return results


def main(rank: int, world: int, port: int, out: str) -> None:
    import torch.distributed as dist

    from gm3d_tpu_torch.parallel.multihost import register_process_group, shutdown

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=120))
    register_process_group("cpu")
    try:
        results = run_all(out)
    finally:
        shutdown()
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
