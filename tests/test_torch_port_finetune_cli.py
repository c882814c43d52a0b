"""The port's finetune CLI, its weight transfer and export, against the JAX
package's (CPU).

*Transfer.* A GM3D and a Point-MAE pretrain state (the JAX package's
variables, carried into the port's models with ``state_dict_from_flax``) go
into ``PointTransformer``: through a port checkpoint root with
``ckpt/transfer.py::load_pretrained_into``, and through the JAX package's
``overlay_pretrained``. The finetune weights must be equal, and so must the
matched / missing / unexpected sets once the port's torch names are mapped to
flax paths through ``ckpt/torch_import.py``'s name maps.
``num_batches_tracked`` has no flax counterpart: the port neither transfers
nor counts it, so the counts are the JAX report's.

*The two CLIs agree.* ``gm3d_tpu_torch.cli.finetune`` and
``gm3d_tpu.cli.finetune`` run the same flags for two epochs on the same
synthetic clouds with ``--vote``, once with ``--recipe legacy`` and once with
``--recipe hpm`` (``--steps_per_dispatch 2``: the JAX CLI's scanned steps),
from the JAX CLI's own initialisation. The draws that cannot be matched
across the packages are switched off on both sides, as
``tests/test_finetune_trajectory.py`` does: the head's dropout and
stochastic depth are 0, and the 1,024-point synthetic clouds are never
subsampled (``npoints`` 1024). The draws that remain, the augmentation's
scale and shift and the votes' subsample noise, scale and shift, are the JAX
CLI's key sequence, handed to the port. Then the epoch means must agree to
``rtol=2e-4``, ``val_acc`` and ``vote_acc`` to one of the 64 test clouds, and
the learning rates the TensorBoard scalars record to ``rtol=1e-6``.

Each CLI is called in this process, through its module's ``main()``.
"""

import glob
import importlib
import json
import math
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from _torch_threads import torch_at_one_thread  # noqa: F401
from cli_harness import _reset_gm3d_loggers

import gm3d_tpu.cli.finetune as jcli
import gm3d_tpu.utils.logging as jlogging
from gm3d_tpu.ckpt.transfer import TransferReport as JTransferReport
from gm3d_tpu.ckpt.transfer import overlay_pretrained as joverlay
from gm3d_tpu.config import cfg_from_yaml_file as jcfg_from_yaml_file
from gm3d_tpu.data.datasets import DataLoader as JDataLoader
from gm3d_tpu.data.datasets import SyntheticClouds as JSyntheticClouds
from gm3d_tpu.models import GM3DStudent as JGM3DStudent
from gm3d_tpu.models import PointMAE as JPointMAE
from gm3d_tpu.models.point_transformer import PointTransformer as JPointTransformer
from gm3d_tpu_torch.ckpt import transfer
from gm3d_tpu_torch.ckpt.checkpoint import all_steps, load_best_metrics, save_checkpoint
from gm3d_tpu_torch.ckpt.torch_import import (
    GM3D_STUDENT_MAP,
    POINT_MAE_MAP,
    POINT_TRANSFORMER_MAP,
    load_flax_variables,
)
from gm3d_tpu_torch.cli import export_model
from gm3d_tpu_torch.cli import finetune as cli
from gm3d_tpu_torch.config import cfg_from_yaml_file
from gm3d_tpu_torch.models import GM3DStudent, PointMAE, PointTransformer
from gm3d_tpu_torch.serve import ServingModel, load_artifact
from gm3d_tpu_torch.train import finetune as ft

# the pretrain models of the step tests, the finetune model of the same width
PRE = dict(trans_dim=32, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=32,
           decoder_depth=1, decoder_num_heads=2, drop_path_rate=0.0)
FT = dict(trans_dim=32, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=32,
          drop_path_rate=0.0, cls_dim=40)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the other
    test workers'; the count comes back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_loggers():
    yield
    _reset_gm3d_loggers()


# ---------------------------------------------------------------------------
# transfer


def _noise_variables(jmodel, seed, *example):
    """Numpy variables in the tree ``jmodel.init`` gives, all of them noise."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda key: jmodel.init(key, *example), jax.random.key(0))
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _pretrain_variables(family, seed):
    pts = jnp.zeros((2, 64, 3))
    mask = jnp.zeros((2, 16), bool).at[:, :10].set(True)
    if family == "gm3d":
        return (_noise_variables(JGM3DStudent(mode="feature", **PRE), seed, pts, mask, 10),
                GM3DStudent(mode="feature", **PRE), GM3D_STUDENT_MAP)
    return _noise_variables(JPointMAE(**PRE), seed, pts, mask, 10), PointMAE(**PRE), POINT_MAE_MAP


def _finetune_model(variables):
    return load_flax_variables(PointTransformer(**FT), variables, POINT_TRANSFORMER_MAP)


def _flax_path(key, tables):
    """The JAX package's report path of a torch key, through the first name map
    of ``tables`` that knows it (a stripped pretrain key is looked up under
    ``MAE_encoder.`` too)."""
    if "." not in key:
        return f"params/{key}"
    module, leaf = key.rsplit(".", 1)
    for table in tables:
        for candidate in (module, f"MAE_encoder.{module}"):
            for pattern, (flax_module, kind) in table.items():
                m = re.fullmatch(re.escape(pattern).replace(r"\{i\}", r"(\d+)"), candidate)
                if not m:
                    continue
                path = flax_module.replace("{i}", m.group(1)) if m.groups() else flax_module
                if candidate != module:  # the JAX overlay re-roots MAE_encoder
                    path = path[len("MAE_encoder/"):]
                if leaf in ("running_mean", "running_var"):
                    return f"batch_stats/{path}/{leaf[len('running_'):]}"
                name = {"weight": "kernel" if kind in ("linear", "conv") else "scale",
                        "bias": "bias"}[leaf]
                return f"params/{path}/{name}"
    raise KeyError(key)


@pytest.mark.parametrize("family", ["gm3d", "pointmae"])
def test_transfer_equals_the_jax_overlay(family, tmp_path):
    src_vars, src_model, src_map = _pretrain_variables(family, 0)
    load_flax_variables(src_model, src_vars, src_map)
    save_checkpoint(str(tmp_path / "ckpt"), {"step": 7, "model": src_model.state_dict(),
                                             "ema": None, "optimizer": None}, 7)
    dst_vars = _noise_variables(JPointTransformer(**FT), 1, jnp.zeros((2, 64, 3)))
    model = _finetune_model(dst_vars)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n, report = transfer.load_pretrained_into(model, str(tmp_path / "ckpt"))

    jreport = JTransferReport()
    params, batch_stats, jn = joverlay(dst_vars["params"], dst_vars["batch_stats"],
                                       src_vars["params"], src_vars["batch_stats"],
                                       report=jreport)
    want = _finetune_model({"params": jax.tree.map(np.asarray, params),
                            "batch_stats": jax.tree.map(np.asarray, batch_stats)})
    got = model.state_dict()
    for key, value in want.state_dict().items():
        if key.endswith("num_batches_tracked"):
            assert torch.equal(got[key], before[key]), key  # never transferred
        else:
            assert torch.equal(got[key], value), key
    assert n == jn == len(report.matched) == len(jreport.matched) > 20
    dst_tables, src_tables = [POINT_TRANSFORMER_MAP], [src_map]
    assert sorted(_flax_path(k, dst_tables) for k in report.matched) == sorted(jreport.matched)
    assert sorted(_flax_path(k, dst_tables) for k in report.missing) == sorted(jreport.missing)
    assert sorted(_flax_path(k, src_tables) for k in report.unexpected) == sorted(
        jreport.unexpected)
    # the final LayerNorm arrives under either family's name; the decoders,
    # the loss-prediction branch and the mask tokens never match
    assert {"norm_p.weight", "norm_p.bias"} <= set(report.matched)
    assert not [k for k in report.unexpected if k.startswith(("encoder.", "blocks.", "norm"))]
    assert any(k.startswith("MAE_decoder.") for k in report.unexpected)
    assert "mask_token" in report.unexpected
    if family == "gm3d":
        assert any(k.startswith("MAE_decoder_loss_pred.") for k in report.unexpected)
    assert not report.shape_mismatch and not jreport.shape_mismatch


def test_transfer_from_a_pth_and_its_failures(tmp_path):
    src_vars, src_model, src_map = _pretrain_variables("pointmae", 2)
    load_flax_variables(src_model, src_vars, src_map)
    torch.save({"base_model": {f"module.{k}": v for k, v in src_model.state_dict().items()}},
               tmp_path / "pretrain.pth")
    save_checkpoint(str(tmp_path / "ckpt"), {"step": 1, "model": src_model.state_dict(),
                                             "ema": None, "optimizer": None}, 1)
    dst_vars = _noise_variables(JPointTransformer(**FT), 3, jnp.zeros((2, 64, 3)))
    from_ckpt, from_pth = _finetune_model(dst_vars), _finetune_model(dst_vars)
    n_ckpt, _ = transfer.load_pretrained_into(from_ckpt, str(tmp_path / "ckpt"))
    n_pth, report = transfer.load_pretrained_into(from_pth, str(tmp_path / "pretrain.pth"),
                                                  torch_ckpt=True)
    assert n_pth == n_ckpt
    for (k, a), b in zip(from_ckpt.state_dict().items(), from_pth.state_dict().values()):
        assert torch.equal(a, b), k
    # the name map does not know the decoder's keys: reported, not overlaid; it
    # knows the mask token, which the finetune model lacks, as the JAX import does
    assert report.torch_unmatched and report.unexpected == ["mask_token"]
    assert all(k.startswith(("MAE_decoder.", "decoder_pos_embed.", "increase_dim."))
               for k in report.torch_unmatched)
    lines = report.lines()
    assert lines[0].startswith(f"transfer: {n_pth} leaves overlaid")
    # nothing that lines up: the run must not go on from random weights
    save_checkpoint(str(tmp_path / "other"), {"step": 1, "model": {"head.weight": torch.ones(2)},
                                              "ema": None, "optimizer": None}, 1)
    with pytest.raises(ValueError, match="transferred 0 parameters"):
        transfer.load_pretrained_into(_finetune_model(dst_vars), str(tmp_path / "other"))
    for path, torch_ckpt in ((tmp_path / "missing", False), (tmp_path / "missing.pth", True)):
        with pytest.raises(FileNotFoundError):
            transfer.load_pretrained_into(_finetune_model(dst_vars), str(path),
                                          torch_ckpt=torch_ckpt)
    # the inputs of an overlay are left as they were
    dst = {k: v.clone() for k, v in from_pth.state_dict().items()}
    src = {f"MAE_encoder.{k}": torch.zeros_like(v) for k, v in dst.items()}
    out, n = transfer.overlay_pretrained(dst, src)
    assert n > 0 and all(torch.equal(dst[k], v) for k, v in from_pth.state_dict().items())
    assert not any(torch.equal(out[k], dst[k]) for k in ("cls_token", "norm_p.weight"))


# ---------------------------------------------------------------------------
# the two CLIs

BATCH, SAMPLES, EPOCHS, NPOINTS, TIMES = 16, 32, 2, 1024, 10
VAL_CLOUDS = 64  # make_cls_loaders: max(--synthetic_samples // 4, 64)
VAL_BATCHES = VAL_CLOUDS // BATCH
FLAGS = ["--synthetic", "--batch_size", str(BATCH), "--synthetic_samples", str(SAMPLES),
         "--epochs", str(EPOCHS), "--vote", "--num_devices", "1", "--num_workers", "0"]
# Both recipes train at 2e-5. At the ModelNet config's 5e-4 these small models
# are chaotic: a 1e-7 relative change of the port's own initial weights moves
# its epoch means by more than the tolerance (the first AdamW updates are
# lr * sign(g), and the sign of a gradient that is rounding noise is
# arbitrary); at 2e-5 by far less, while the loss still falls an epoch
# (test_the_rate_of_the_cli_comparison_is_where_the_runs_are_not_chaotic). The
# legacy recipe takes the config's rate (written into a copy of the config)
# and, without warm-up, trains at it in both epochs; the hpm recipe's is blr
# 3.2e-4 x 16 / 256, with one warm-up epoch, so both branches of its
# per-iteration schedule run.
LR_RUN = 2e-5
RECIPES = {"legacy": ["--recipe", "legacy", "--warmup_epochs", "0"],
           "hpm": ["--recipe", "hpm", "--blr", "3.2e-4", "--warmup_epochs", "1",
                   "--steps_per_dispatch", "2"]}
SMALL_FT = dict(FT, dropout=0.0)
FINETUNE_DRAWS = ft.finetune_draws


def _first_val_batch():
    loader = JDataLoader(JSyntheticClouds(VAL_CLOUDS, NPOINTS, num_classes=40, seed=2,
                                          labelled=True), BATCH, shuffle=False, drop_last=False)
    return jnp.asarray(next(iter(loader))[0])


class _Scalars:
    """A ``ScalarWriter`` that keeps what it is given."""

    seen: dict = {}

    def __init__(self, log_dir):
        self.log_dir = log_dir
        _Scalars.seen[log_dir] = self.values = []

    def add_scalar(self, tag, value, step):
        self.values.append((tag, step, float(value)))

    def flush(self):
        pass

    def close(self):
        pass


class _JaxDraws:
    """The draws the JAX CLI's key sequence gives, in the port's form: a train
    step's ``rng, key = split(rng)`` then the step's own split; a vote pass's
    ``rng, key = split(rng)``, a batch's ``key, k2 = split(key)``, the ten
    votes' ``split(k2, 10)``."""

    def __init__(self, seed):
        self.rng = jax.random.key(seed)
        self.vote_key, self.vote_batches = None, 0

    def step(self, generator, model, batch, num_points, npoints):
        assert num_points == npoints  # 1024-point clouds: no subsample
        self.rng, key = jax.random.split(self.rng)
        _, r_aug, _, _ = jax.random.split(key, 4)
        r_scale, r_shift = jax.random.split(r_aug)
        out = {"scale": jax.random.uniform(r_scale, (batch, 1, 3), minval=2.0 / 3.0,
                                           maxval=3.0 / 2.0),
               "shift": jax.random.uniform(r_shift, (batch, 1, 3), minval=-0.2, maxval=0.2)}
        out = {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
        out["dropout"] = tuple(torch.ones((batch, 256), dtype=torch.bool) for _ in range(2))
        return out

    def vote(self, generator, times, batch, num_points):
        if self.vote_batches % VAL_BATCHES == 0:
            self.rng, self.vote_key = jax.random.split(self.rng)
        self.vote_batches += 1
        self.vote_key, k2 = jax.random.split(self.vote_key)
        noise, scale, shift = [], [], []
        for r in jax.random.split(k2, times):
            r_sub, r_aug = jax.random.split(r)
            r_scale, r_shift = jax.random.split(r_aug)
            noise.append(jax.random.uniform(r_sub, (batch, num_points)))
            scale.append(jax.random.uniform(r_scale, (batch, 1, 3), minval=2.0 / 3.0,
                                            maxval=3.0 / 2.0))
            shift.append(jax.random.uniform(r_shift, (batch, 1, 3), minval=-0.2, maxval=0.2))
        return {k: torch.from_numpy(np.stack(v)) for k, v in
                (("noise", noise), ("scale", scale), ("shift", shift))}


def _log(out_dir):
    with open(out_dir / "log.txt") as f:
        return [json.loads(line) for line in f]


def _config_at(tmp_path, lr):
    """``finetune_modelnet.yaml`` with its optimizer's rate set to ``lr``."""
    cfg = yaml.safe_load(open("configs/pointmae/finetune_modelnet.yaml"))
    cfg["optimizer"]["kwargs"]["lr"] = lr
    path = tmp_path / "finetune_modelnet.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return ["--config", str(path)]


def _run_jax(monkeypatch, out_dir, flags):
    importlib.reload(jcli)
    monkeypatch.setattr(jcli, "build_model_from_cfg",
                        lambda cfg, dtype: JPointTransformer(**SMALL_FT, dtype=dtype))
    monkeypatch.setattr(jlogging, "ScalarWriter", _Scalars)
    monkeypatch.setattr(sys, "argv", ["finetune", *FLAGS, *flags, "--output_dir", str(out_dir)])
    _reset_gm3d_loggers()
    jcli.main()
    return _log(out_dir)


def _run_port(monkeypatch, out_dir, flags):
    variables = _initial_variables()
    monkeypatch.setattr(cli, "build_model", lambda args, cfg, dtype: load_flax_variables(
        PointTransformer(**SMALL_FT), variables, POINT_TRANSFORMER_MAP))
    monkeypatch.setattr(cli, "ScalarWriter", _Scalars)
    draws = _JaxDraws(seed=0)
    monkeypatch.setattr(ft, "finetune_draws", draws.step)
    monkeypatch.setattr(ft, "vote_draws", draws.vote)
    _reset_gm3d_loggers()
    records = cli.main([*FLAGS, *flags, "--device", "cpu", "--output_dir", str(out_dir)])
    assert records == _log(out_dir)
    return records


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_the_two_clis_agree(recipe, monkeypatch, tmp_path):
    flags = [*_config_at(tmp_path, LR_RUN), *RECIPES[recipe]]
    want = _run_jax(monkeypatch, tmp_path / "jax", flags)
    got = _run_port(monkeypatch, tmp_path / "port", flags)
    assert len(got) == len(want) == EPOCHS + 1
    for g, w in zip(got[:EPOCHS], want[:EPOCHS]):
        assert sorted(g) == sorted(w) and g["epoch"] == w["epoch"]
        for key in ft.METRIC_KEYS:
            assert math.isfinite(g[key]), key
            np.testing.assert_allclose(g[key], w[key], rtol=2e-4,
                                       err_msg=f"{recipe} epoch {g['epoch']} {key}")
        assert abs(g["val_acc"] - w["val_acc"]) <= 100.0 / VAL_CLOUDS + 1e-9
    assert set(got[-1]) == set(want[-1]) == {"vote_acc"}
    assert abs(got[-1]["vote_acc"] - want[-1]["vote_acc"]) <= 100.0 / VAL_CLOUDS + 1e-9
    # the TensorBoard scalars: the learning rate of each epoch's last update,
    # the loss, the validation accuracy
    jtb = _Scalars.seen[str(tmp_path / "jax" / "tfboard")]
    ptb = _Scalars.seen[str(tmp_path / "port" / "tfboard")]
    assert [t[:2] for t in ptb] == [t[:2] for t in jtb]
    lrs = [(v, w[2]) for v, w in zip(ptb, jtb) if v[0] == "lr"]
    np.testing.assert_allclose([a[2] for a, _ in lrs], [b for _, b in lrs], rtol=1e-6)
    line = f"recipe {recipe}: lr {LR_RUN:.3g}"
    for side in ("jax", "port"):
        assert line in (tmp_path / side / "finetune.log").read_text(), side
    if recipe == "hpm":  # the warm-up's middle after epoch 0: per-iteration schedule
        np.testing.assert_allclose(lrs[0][0][2], LR_RUN / 2, rtol=1e-6)
    else:
        np.testing.assert_allclose([a[2] for a, _ in lrs], [LR_RUN] * EPOCHS, rtol=1e-6)
    # the epochs trained: the loss fell by far more than the tolerance
    assert got[1]["loss"] < got[0]["loss"] * 0.995
    accs = [r["val_acc"] for r in got[:EPOCHS]]
    best_step = (accs.index(max(accs)) + 1) * (SAMPLES // BATCH)
    assert all_steps(str(tmp_path / "port" / "ckpt" / "best")) == [best_step]
    assert load_best_metrics(str(tmp_path / "port" / "ckpt"))["best"] == max(accs)


def _initial_variables():
    """What the JAX CLI's ``init`` gives the small model (key ``--seed`` 0, its
    first validation batch)."""
    init = jax.jit(JPointTransformer(**SMALL_FT).init)
    return jax.tree.map(np.asarray, init(jax.random.key(0), _first_val_batch()[:2, :NPOINTS]))


def _port_run(monkeypatch, tmp_path, variables, lr, scale):
    """The port's CLI alone for one epoch, legacy recipe at ``lr``, from
    ``variables`` each multiplied by ``1 + scale * noise``; its epoch means."""

    def build(args, cfg, dtype):
        model = load_flax_variables(PointTransformer(**SMALL_FT), variables,
                                    POINT_TRANSFORMER_MAP)
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.0 + scale * torch.randn(p.shape, generator=gen))
        return model

    monkeypatch.setattr(cli, "build_model", build)
    monkeypatch.setattr(ft, "finetune_draws", _JaxDraws(seed=0).step)
    out = tmp_path / f"lr{lr}_scale{scale}"
    _reset_gm3d_loggers()
    records = cli.main([*_config_at(tmp_path, lr), *FLAGS[:5], "--epochs", "1",
                        "--recipe", "legacy", "--warmup_epochs", "0", "--device", "cpu",
                        "--output_dir", str(out)])
    return np.array([[r[k] for k in ft.METRIC_KEYS] for r in records])


def test_the_rate_of_the_cli_comparison_is_where_the_runs_are_not_chaotic(monkeypatch,
                                                                          tmp_path):
    """Why ``test_the_two_clis_agree`` trains at ``LR_RUN``: a 1e-7 relative
    change of the initial weights moves the port's own epoch means by more
    than that test's 2e-4 at the config's 5e-4, and by far less at 2e-5."""
    variables = _initial_variables()
    for lr, low, high in ((5e-4, 2e-4, None), (LR_RUN, None, 2e-5)):
        base = _port_run(monkeypatch, tmp_path, variables, lr, 0.0)
        moved = (np.abs(_port_run(monkeypatch, tmp_path, variables, lr, 1e-7) - base)
                 / np.maximum(np.abs(base), 1e-12)).max()
        print(f"lr {lr}: a 1e-7 change of the weights moves the epoch's means by {moved:.3g}")
        assert (low is None or moved > low) and (high is None or moved < high), (lr, moved)


def _finetune_configs():
    """Every finetune and few-shot config in ``configs/`` (segmentation's
    apart)."""
    return [p for p in sorted(glob.glob("configs/*/*.yaml"))
            if ("finetune" in p or "fewshot" in p) and "seg" not in p]


@pytest.mark.parametrize("path", _finetune_configs())
def test_recipe_batch_and_smoothing_resolve_as_the_jax_cli(path):
    cfg, jcfg = cfg_from_yaml_file(path), jcfg_from_yaml_file(path)
    for recipe in ("auto", "hpm", "legacy"):
        args = cli.parse_args(["--config", path, "--recipe", recipe])
        assert cli.resolve_recipe(args, cfg) == jcli.resolve_recipe(args, jcfg)
    assert cli.published_eff_bs(cfg) == jcli.published_eff_bs(jcfg)
    for recipe in ("hpm", "legacy"):
        for override in (None, 0.2):
            assert cli.resolve_smoothing(override, recipe, cfg) == jcli.resolve_smoothing(
                override, recipe, jcfg)
    for acc, better in ((92.2, False), (91.5, True), (91.5, False), (90.0, True)):
        assert cli.vote_gate(acc, better) == jcli.vote_gate(acc, better)


def test_finetune_configs_are_found():
    assert len(_finetune_configs()) == 10


# ---------------------------------------------------------------------------
# the port alone: resume, export


def _tiny_config(tmp_path):
    cfg = yaml.safe_load(open("configs/pointmae/finetune_modelnet.yaml"))
    cfg["model"].update({k: v for k, v in FT.items() if k != "cls_dim"}, cls_dim=5)
    path = tmp_path / "tiny_finetune.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _step_keyed_draws(monkeypatch, start):
    """Draws that depend on the global step only (a resumed run restarts its
    generator from --seed, as the JAX CLI restarts its key)."""
    counter = {"step": start}

    def draws(generator, model, batch, num_points, npoints):
        gen = torch.Generator().manual_seed(1000 + counter["step"])
        counter["step"] += 1
        if counter.get("crash_at") == counter["step"]:
            raise RuntimeError("injected crash")
        return FINETUNE_DRAWS(gen, model, batch, num_points, npoints)

    monkeypatch.setattr(ft, "finetune_draws", draws)
    return counter


def test_resume_after_save_steps_ends_with_the_unbroken_runs_weights(monkeypatch, tmp_path):
    config = _tiny_config(tmp_path)
    flags = ["--config", config, "--synthetic", "--synthetic_samples", "16", "--batch_size",
             "4", "--epochs", "2", "--steps_per_dispatch", "1", "--num_workers", "0",
             "--device", "cpu", "--sync_save"]
    _step_keyed_draws(monkeypatch, 0)
    whole = cli.main([*flags, "--output_dir", str(tmp_path / "whole")])
    counter = _step_keyed_draws(monkeypatch, 0)
    counter["crash_at"] = 7  # the draws of step 7 (epoch 1) fail
    _reset_gm3d_loggers()
    with pytest.raises(RuntimeError, match="injected crash"):
        cli.main([*flags, "--save_steps", "1", "--output_dir", str(tmp_path / "broken")])
    assert all_steps(str(tmp_path / "broken" / "ckpt")) == [4, 5, 6]
    _step_keyed_draws(monkeypatch, 6)
    _reset_gm3d_loggers()
    resumed = cli.main([*flags, "--resume", "--output_dir", str(tmp_path / "broken")])
    assert "resumed from step 6" in (tmp_path / "broken" / "finetune.log").read_text()
    assert [r["epoch"] for r in resumed] == [1]
    assert resumed[0]["val_acc"] == whole[1]["val_acc"]
    from gm3d_tpu_torch.ckpt.checkpoint import restore_raw

    a = restore_raw(str(tmp_path / "whole" / "ckpt"))
    b = restore_raw(str(tmp_path / "broken" / "ckpt"))
    assert a["step"] == b["step"] == 8
    for key, value in a["model"].items():
        assert torch.equal(value, b["model"][key]), key


def test_export_of_ckpt_best_serves_the_eval_steps_logits(tmp_path):
    config = _tiny_config(tmp_path)
    _reset_gm3d_loggers()
    records = cli.main(["--config", config, "--synthetic", "--synthetic_samples", "8",
                        "--batch_size", "4", "--epochs", "1", "--num_workers", "0",
                        "--device", "cpu", "--output_dir", str(tmp_path / "ft")])
    assert [r["epoch"] for r in records] == [0]
    best = tmp_path / "ft" / "ckpt" / "best"
    art = export_model.main(["--config", config, "--ckpt", str(best), "--device", "cpu",
                             "--input_points", "2048", "--export_batch", "4",
                             "--out", str(tmp_path / "ft.gm3dx")])
    assert load_artifact(art, device="cpu")[1]["ckpt_step"] == 2
    clouds = np.random.default_rng(0).standard_normal((6, 2048, 3)).astype(np.float32)
    served = ServingModel(art, device="cpu").predict(clouds)
    from gm3d_tpu_torch.ckpt.checkpoint import restore_raw

    model = PointTransformer(**{**FT, "cls_dim": 5})
    model.load_state_dict(restore_raw(str(best))["model"], strict=True)
    want = ft.make_eval_step(model, NPOINTS, device="cpu")(torch.from_numpy(clouds))
    np.testing.assert_allclose(served, want.numpy(), rtol=0, atol=1e-5)
    with pytest.raises(FileNotFoundError):
        export_model.main(["--config", config, "--ckpt", str(tmp_path / "none"),
                           "--device", "cpu", "--out", str(tmp_path / "x.gm3dx")])
