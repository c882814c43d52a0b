"""The port's pretrain CLI on ``--model_family m2ae_gm3d`` against the JAX
package's (CPU).

Both CLIs run one epoch of two steps on the same synthetic clouds with a small
Point-M2AE written into a config by the test (``tests/test_m2ae_gm3d.py``'s
widths, 128-point clouds). The port starts from the JAX CLI's own
initialisation (``init`` with key 1), carried across with
``load_flax_variables``, and is handed the draws of the JAX CLI's key
sequence. The JAX CLI's ``init`` runs compiled as one graph (the same values).
At a learning rate of 1e-3 (``--blr 0.064`` at batch 4, no warm-up)
the runs are not chaotic: the epoch means agree to ``rtol=2e-4``, the step
tests' tolerance, and the SVM probe (pooled over every scale) to within one
of its 64 test clouds. Then the port's run goes on: ``--resume`` for a second
epoch, ``--model_family m2ae`` in bf16 with ``--classification``, and the downstream
path: the finetune CLI on a small ``Point_M2AE_ModelNet40`` from the GM3D run's
checkpoint (the transfer count), its ``ckpt/best`` exported and served (the
eval step's logits), the pretrain checkpoint exported as a featurizer, and
the seg and few-shot CLIs on small Point-M2AE configs from that checkpoint.
"""

import importlib
import json
import math
import sys

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch
import yaml
from _torch_threads import torch_at_one_thread  # noqa: F401
from cli_harness import _reset_gm3d_loggers

import gm3d_tpu.cli.pretrain as jcli
from gm3d_tpu.models import PointM2AE as JPointM2AE
from gm3d_tpu_torch.ckpt.checkpoint import all_steps, load_best_metrics, restore_raw
from gm3d_tpu_torch.ckpt.torch_import import M2AE_MAP, load_flax_variables
from gm3d_tpu_torch.cli import export_model
from gm3d_tpu_torch.cli import fewshot as fs_cli
from gm3d_tpu_torch.cli import finetune as ft_cli
from gm3d_tpu_torch.cli import finetune_seg as seg_cli
from gm3d_tpu_torch.cli import pretrain as cli
from gm3d_tpu_torch.models import PointM2AE, PointM2AEClassifier
from gm3d_tpu_torch.serve import ServingModel
from gm3d_tpu_torch.train.finetune import make_eval_step

MODEL = dict(NAME="Point_M2AE", mask_ratio=0.8, decoder_depths=[1, 1], decoder_dims=[96, 48],
             decoder_up_blocks=[1, 1], group_sizes=[8, 4, 4], num_groups=[32, 16, 8],
             encoder_depths=[1, 1, 1], encoder_dims=[24, 48, 96],
             local_radius=[0.32, 0.64, 1.28], drop_path_rate=0.0, num_heads=2)
BATCH, SAMPLES, NPOINTS = 4, 8, 128
FLAGS = ["--model_family", "m2ae_gm3d", "--synthetic", "--batch_size", str(BATCH),
         "--synthetic_samples", str(SAMPLES), "--steps_per_dispatch", "1",
         "--warmup_epochs", "0", "--blr", "0.064", "--val_freq", "1", "--num_devices", "1"]
KEYS = ("loss", "loss_chfr", "loss_learn", "grad_norm")
SVM_TEST_CLOUDS = 64


@pytest.fixture(autouse=True)
def _fresh_loggers():
    yield
    _reset_gm3d_loggers()


def _config(tmp_path):
    cfg = yaml.safe_load(open("configs/m2ae/config_Point_M2AE.yaml"))
    cfg["model"] = MODEL
    cfg["npoints"] = NPOINTS
    cfg["max_epoch"] = 2
    path = tmp_path / "m2ae_small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _compiled_init(captured):
    """``init`` compiled as one graph (op by op it compiles each primitive
    alone, about 30 s here), to the same values; the JAX CLI's call (key 1,
    its first batch) is kept in ``captured``."""

    def init(self, rngs, *args, **kwargs):
        out = jax.jit(lambda r, *a: nn.Module.init(self, r, *a, **kwargs))(rngs, *args)
        captured.setdefault("variables", jax.tree.map(np.asarray, out))
        return out

    return init


def _jax_draws(seed):
    """The port's ``step_draws``, replaced by what the JAX CLI's step draws."""
    state = {"rng": jax.random.key(seed)}

    def draws(generator, batch, num_group):
        state["rng"], key = jax.random.split(state["rng"])
        r_aug, r_mask, _, _ = jax.random.split(key, 4)
        r_scale, r_shift = jax.random.split(r_aug)
        out = {"scale": jax.random.uniform(r_scale, (batch, 1, 3), minval=2.0 / 3.0,
                                           maxval=3.0 / 2.0),
               "shift": jax.random.uniform(r_shift, (batch, 1, 3), minval=-0.2, maxval=0.2),
               "noise": jax.random.uniform(r_mask, (batch, num_group))}
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}

    return draws


def _log(out_dir):
    with open(out_dir / "log.txt") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("m2ae_cli")
    config = _config(tmp_path)
    importlib.reload(jcli)
    mp = pytest.MonkeyPatch()
    try:
        captured = {}
        mp.setattr(JPointM2AE, "init", _compiled_init(captured))
        mp.setattr(sys, "argv", ["pretrain", "--config", config, *FLAGS, "--epochs", "1",
                                 "--output_dir", str(tmp_path / "jax")])
        _reset_gm3d_loggers()
        jcli.main()
        variables = captured["variables"]

        def build(args, cfg, dtype):
            return load_flax_variables(PointM2AE(**{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in MODEL.items() if k != "NAME"}), variables, M2AE_MAP)

        mp.setattr(cli, "build_m2ae", build)
        mp.setattr(cli, "step_draws", _jax_draws(seed=0))
        _reset_gm3d_loggers()
        records = cli.main(["--config", config, *FLAGS, "--epochs", "1", "--device", "cpu",
                            "--output_dir", str(tmp_path / "port")])
    finally:
        mp.undo()
    return tmp_path, config, _log(tmp_path / "jax"), records


def test_the_epoch_means_equal_the_jax_cli(runs):
    tmp_path, _, want, got = runs
    assert got == _log(tmp_path / "port")
    assert len(got) == len(want) == 1
    g, w = got[0], want[0]
    assert sorted(g) == sorted(w)
    assert g["steps"] == w["steps"] == SAMPLES // BATCH
    np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
    for key in KEYS:
        assert math.isfinite(g[key]), key
        np.testing.assert_allclose(g[key], w[key], rtol=2e-4, err_msg=key)
    assert abs(g["val_svm_acc"] - w["val_svm_acc"]) <= 1.0 / SVM_TEST_CLOUDS + 1e-12


def test_the_checkpoint_holds_the_ema_and_best(runs):
    tmp_path = runs[0]
    ckpt = tmp_path / "port" / "ckpt"
    raw = restore_raw(str(ckpt))
    assert raw["step"] == SAMPLES // BATCH
    assert sorted(raw["model"]) == sorted(raw["ema"])
    assert any("lp_bn.running_mean" == k for k in raw["ema"])
    assert all_steps(str(ckpt / "best")) == [SAMPLES // BATCH]
    assert load_best_metrics(str(ckpt)) == {"best": runs[3][0]["val_svm_acc"]}


def test_resume_trains_the_second_epoch(runs):
    tmp_path, config = runs[0], runs[1]
    _reset_gm3d_loggers()
    records = cli.main(["--config", config, *FLAGS, "--epochs", "2", "--resume",
                        "--device", "cpu", "--output_dir", str(tmp_path / "port")])
    assert [r["epoch"] for r in records] == [1]
    assert restore_raw(str(tmp_path / "port" / "ckpt"))["step"] == 2 * SAMPLES // BATCH


def test_the_plain_family_in_bf16_with_the_classification_probe(runs):
    tmp_path, config = runs[0], runs[1]
    _reset_gm3d_loggers()
    flags = [f if f != "m2ae_gm3d" else "m2ae" for f in FLAGS]
    records = cli.main(["--config", config, *flags, "--epochs", "1", "--classification",
                        "--bf16", "--device", "cpu", "--output_dir", str(tmp_path / "plain")])
    rec = records[0]
    assert {"loss", "grad_norm", "loss_cls", "acc_cls", "val_svm_acc"} <= set(rec)
    assert "loss_learn" not in rec and math.isfinite(rec["loss"])
    assert restore_raw(str(tmp_path / "plain" / "ckpt"))["ema"] is None


def _finetune_config(tmp_path):
    cfg = yaml.safe_load(open("configs/m2ae/finetune_modelnet_PointM2AE.yaml"))
    cfg["model"] = {**{k: v for k, v in MODEL.items() if not k.startswith(("decoder", "mask"))},
                    "NAME": "Point_M2AE_ModelNet40", "cls_dim": 5, "smooth": 0.3}
    path = tmp_path / "m2ae_ft_small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_finetune_export_and_serve_a_point_m2ae_classifier(runs, caplog):
    """hpm is the recipe of every Point-M2AE ModelNet row; the encoder's 42
    tensors of this size come over from the pretrain checkpoint."""
    tmp_path = runs[0]
    config = _finetune_config(tmp_path)
    _reset_gm3d_loggers()
    records = ft_cli.main(["--config", config, "--synthetic", "--synthetic_samples", "8",
                           "--batch_size", "4", "--epochs", "1", "--num_workers", "0",
                           "--pretrained", str(tmp_path / "port" / "ckpt"),
                           "--device", "cpu", "--output_dir", str(tmp_path / "ft")])
    assert [r["epoch"] for r in records] == [0] and math.isfinite(records[0]["loss"])
    log = (tmp_path / "ft" / "finetune.log").read_text()
    assert "recipe hpm: " in log
    n = int(log.split("pretrain->finetune transfer: ")[1].split(" leaves")[0])
    model = PointM2AEClassifier(cls_dim=5, **{k: tuple(v) if isinstance(v, list) else v
                                              for k, v in MODEL.items()
                                              if not k.startswith(("decoder", "mask", "NAME"))})
    encoder_keys = [k for k in model.state_dict()
                    if k.startswith("encoder.") and not k.endswith("num_batches_tracked")]
    assert n == len(encoder_keys)
    best = tmp_path / "ft" / "ckpt" / "best"
    art = export_model.main(["--config", config, "--ckpt", str(best), "--device", "cpu",
                             "--export_batch", "4", "--out", str(tmp_path / "ft.gm3dx")])
    clouds = np.random.default_rng(0).standard_normal((6, 1024, 3)).astype(np.float32)
    served = ServingModel(art, device="cpu").predict(clouds)
    model.load_state_dict(restore_raw(str(best))["model"], strict=True)
    want = make_eval_step(model, 1024, device="cpu")(torch.from_numpy(clouds))
    np.testing.assert_allclose(served, want.numpy(), rtol=0, atol=1e-5)

    feats = export_model.main(["--config", runs[1], "--ckpt", str(tmp_path / "port" / "ckpt"),
                               "--mode", "features", "--model_family", "m2ae",
                               "--device", "cpu", "--export_batch", "2",
                               "--out", str(tmp_path / "feats.gm3dx")])
    out = ServingModel(feats, device="cpu").predict(clouds[:3, :NPOINTS])
    assert out.shape == (3, MODEL["encoder_dims"][-1]) and np.isfinite(out).all()


ENCODER = {k: v for k, v in MODEL.items() if not k.startswith(("decoder", "mask", "NAME"))}


def test_seg_and_fewshot_clis_train_point_m2ae_models(runs):
    """``seg_shapenetpart_PointM2AE.yaml`` and ``fewshot-Point-M2AE.yaml`` at
    the small encoder: one epoch each from the GM3D run's checkpoint, the
    encoder's tensors transferred."""
    tmp_path = runs[0]
    pretrained = str(tmp_path / "port" / "ckpt")
    n_encoder = len([k for k in PointM2AEClassifier(cls_dim=5, **{
        k: tuple(v) if isinstance(v, list) else v for k, v in ENCODER.items()}).state_dict()
        if k.startswith("encoder.") and not k.endswith("num_batches_tracked")])
    seg = yaml.safe_load(open("configs/m2ae/seg_shapenetpart_PointM2AE.yaml"))
    seg["model"] = {**ENCODER, "NAME": "Point_M2AE_SEG", "cls_dim": 50, "num_classes": 16}
    seg["npoints"] = NPOINTS
    (tmp_path / "seg.yaml").write_text(yaml.safe_dump(seg))
    _reset_gm3d_loggers()
    records = seg_cli.main(["--config", str(tmp_path / "seg.yaml"), "--synthetic",
                            "--synthetic_samples", "8", "--batch_size", "4", "--epochs", "1",
                            "--pretrained", pretrained, "--device", "cpu",
                            "--output_dir", str(tmp_path / "seg")])
    assert [r["epoch"] for r in records] == [0] and math.isfinite(records[0]["loss"])
    assert 0.0 <= records[0]["instance_miou"] <= 100.0
    log = (tmp_path / "seg" / "seg.log").read_text()
    assert f"pretrain->finetune transfer: {n_encoder} leaves" in log

    fs = yaml.safe_load(open("configs/m2ae/fewshot-Point-M2AE.yaml"))
    fs["model"] = {**ENCODER, "NAME": "Point_M2AE_ModelNet40", "cls_dim": 40, "smooth": 0.3}
    (tmp_path / "fs.yaml").write_text(yaml.safe_dump(fs))
    _reset_gm3d_loggers()
    records = fs_cli.main(["--config", str(tmp_path / "fs.yaml"), "--synthetic", "--way", "2",
                           "--shot", "2", "--folds", "1", "--epochs", "1",
                           "--pretrained", pretrained, "--device", "cpu",
                           "--output_dir", str(tmp_path / "fs")])
    assert len(records[0]["accs"]) == 1
    log = (tmp_path / "fs" / "fewshot.log").read_text()
    assert "label smoothing 0.3" in log
    assert f"pretrain->finetune transfer: {n_encoder} leaves" in log
