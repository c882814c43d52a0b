"""The teacher's pretrain in the port against the JAX package's (CPU).

``legacy_cosine_epoch_schedule`` against the JAX one at every step (1e-7);
``build_legacy_adamw``'s decayed parameters against the JAX mask on the
full-width Point-MAE, and three of its steps on the same gradients against
optax (1e-6); ``make_pointmae_train_step`` against the JAX step for three
steps from the same weights, clouds and draws with stochastic depth 0 (loss
and ``grad_norm`` to the step test's ``rtol=2e-4``, parameters and BN
buffers after step 1 as there); the two CLIs' ``--model_family pointmae``
runs (epoch means to 2e-4); and the whole chain: a JAX teacher run, its orbax
checkpoint, ``tools/orbax_to_torch.py``, then the port's GM3D CLI with
``--teacher_ckpt`` against the JAX GM3D CLI with ``--teacher_ckpt`` on the
orbax directory (epoch means to 2e-4). Models are small (two blocks, 48
wide) and the CLIs read small copies of the two configs.
"""

import functools
import importlib
import importlib.util
import json
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from cli_harness import _reset_gm3d_loggers

import gm3d_tpu.cli.pretrain as jcli
from gm3d_tpu.models import GM3DStudent as JGM3DStudent
from gm3d_tpu.models import PointMAE as JPointMAE
from gm3d_tpu.train import schedules as jschedules
from gm3d_tpu.train.optim import _legacy_decay_mask
from gm3d_tpu.train.optim import build_legacy_adamw as jbuild_legacy_adamw
from gm3d_tpu.train.pretrain import make_pointmae_train_step as jmake_step
from gm3d_tpu.train.state import create_train_state as jcreate_state
from gm3d_tpu_torch.ckpt.torch_import import (
    GM3D_STUDENT_MAP,
    POINT_MAE_MAP,
    load_flax_variables,
    state_dict_from_flax,
)
from gm3d_tpu_torch.cli import pretrain as cli
from gm3d_tpu_torch.config import build_model_from_cfg
from gm3d_tpu_torch.models import GM3DStudent, PointMAE
from gm3d_tpu_torch.train.optim import build_legacy_adamw
from gm3d_tpu_torch.train.pretrain import make_pointmae_train_step
from gm3d_tpu_torch.train.schedules import legacy_cosine_epoch_schedule
from gm3d_tpu_torch.train.state import create_train_state

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(trans_dim=48, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=48,
             decoder_depth=1, decoder_num_heads=2, drop_path_rate=0.0)
B, N, LR = 4, 128, 1e-3
NUM_MASK = int(16 * 0.6)  # Point-MAE's own count: 9, not gm3d_num_mask's 10
BATCH, SAMPLES, EPOCHS = 4, 8, 2
METRICS = ("loss", "grad_norm")
# biases whose shift reaches a train-mode BatchNorm through linear maps only
# (first_conv.3's, through the max-pool and the concat, shifts every point of
# every group alike), so that the BatchNorm's mean removes it
BN_FED_BIASES = ("first_conv.0.bias", "first_conv.3.bias", "second_conv.0.bias")
GM3D_METRICS = ("loss", "loss_recon", "loss_mse", "loss_chfr", "loss_learn", "grad_norm")


@pytest.fixture(autouse=True)
def _fresh_loggers():
    yield
    _reset_gm3d_loggers()


# ---------------------------------------------------------------------------
# schedule and optimizer


@pytest.mark.parametrize("base_lr, total, warmup, per_epoch",
                         [(1e-3, 300, 10, 4), (5e-4, 6, 2, 3), (1e-3, 4, 0, 2)])
def test_legacy_schedule_equals_the_jax_one_at_every_step(base_lr, total, warmup, per_epoch):
    mine = legacy_cosine_epoch_schedule(base_lr, total, warmup, per_epoch)
    theirs = jschedules.legacy_cosine_epoch_schedule(base_lr, total, warmup, per_epoch)
    steps = range(0, (min(total, 12) + 2) * per_epoch)
    got = np.array([mine(s) for s in steps])
    want = np.array([float(theirs(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    # the one-epoch lag: epochs 0 and 1 train at the warm-up's start
    if warmup:
        assert got[0] == got[2 * per_epoch - 1] == 1e-6
    assert len(set(got[:per_epoch])) == 1  # constant within an epoch


def _flax_shapes(model, num_mask, batch=2):
    pts = jnp.zeros((batch, 1024, 3), jnp.float32)
    mask = jnp.zeros((batch, model.num_group), bool).at[:, :num_mask].set(True)
    return jax.eval_shape(lambda key: model.init(key, pts, mask, num_mask), jax.random.key(0))


def test_legacy_adamw_decays_the_parameters_the_jax_mask_decays():
    """Full width: the JAX mask works on flax paths, the port's rule on torch
    names (``mask_token``); carried to torch names, the two sets are equal."""
    shapes = _flax_shapes(JPointMAE(), 38)["params"]
    mask = _legacy_decay_mask(shapes)
    # one element a leaf carries its flag; the names do not depend on the sizes
    flags = state_dict_from_flax(
        {"params": jax.tree.map(lambda s, m: np.full((1,) * len(s.shape), float(m), np.float32),
                                shapes, mask)}, POINT_MAE_MAP)
    want = sorted(k for k, v in flags.items() if bool(v.flatten()[0]))
    with torch.device("meta"):  # names and shapes, no weights
        model = PointMAE()
    optimizer = build_legacy_adamw(model.named_parameters(), 1e-3, 0.05)
    names = {id(p): n for n, p in model.named_parameters()}
    decay, no_decay = optimizer.param_groups
    assert decay["weight_decay"] == 0.05 and no_decay["weight_decay"] == 0.0
    assert optimizer.defaults["betas"] == (0.9, 0.999) and optimizer.defaults["eps"] == 1e-8
    got = sorted(names[id(p)] for p in decay["params"])
    assert got == want and len(got) > 50
    assert "mask_token" in [names[id(p)] for p in no_decay["params"]]
    assert len(decay["params"]) + len(no_decay["params"]) == len(names) == len(flags)
    # accumulation wraps the same two groups and sums (the mean, scaled by 2)
    summed = build_legacy_adamw(model.named_parameters(), 1e-3, 0.05, accum_steps=2)
    assert summed.accum_steps == 2 and summed.scale == 2.0
    assert [len(g["params"]) for g in summed.param_groups] == [len(decay["params"]),
                                                                len(no_decay["params"])]


def test_legacy_adamw_accumulation_sums_and_clips_as_optax():
    """``build_legacy_adamw(accum_steps=2, grad_clip=1.0)`` against the JAX
    one (``optax.MultiSteps`` of ``scale(2)`` and the clipped AdamW) on the
    same gradients, four micro-steps: the first and third move nothing, the
    second and fourth update on the SUM of their window, clipped to norm 1
    (the sums' norms are far above it). Parameters to 1e-6."""
    rng = np.random.default_rng(6)
    shapes = _flax_shapes(JPointMAE(**SMALL), NUM_MASK)["params"]
    params = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32) * 0.1,
                          shapes)
    model = PointMAE(**SMALL)
    model.load_state_dict(state_dict_from_flax({"params": params}, POINT_MAE_MAP), strict=False)
    optimizer = build_legacy_adamw(model.named_parameters(), LR, 0.05, accum_steps=2,
                                   grad_clip=1.0)
    tx = jbuild_legacy_adamw(LR, 0.05, accum_steps=2, grad_clip=1.0)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i in range(4):
        grads = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
        updates, opt_state = update(jax.tree.map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = state_dict_from_flax({"params": grads}, POINT_MAE_MAP)
        for name, p in model.named_parameters():
            p.grad = tgrads[name].clone()
        assert optimizer.step() == (i % 2 == 1)
        want = state_dict_from_flax({"params": jax.tree.map(np.asarray, jparams)},
                                    POINT_MAE_MAP)
        for name, p in model.named_parameters():
            if i % 2 == 0:
                assert torch.equal(p.detach(), before[name]), (i, name)
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6,
                                       rtol=0, err_msg=f"micro-step {i} {name}")
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert optimizer.gradient_step == 2 and optimizer.mini_step == 0


def test_three_legacy_adamw_steps_equal_optax():
    rng = np.random.default_rng(4)
    jmodel = JPointMAE(**SMALL)
    shapes = _flax_shapes(jmodel, NUM_MASK)["params"]
    params = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32) * 0.1,
                          shapes)
    model = PointMAE(**SMALL)
    model.load_state_dict(state_dict_from_flax({"params": params}, POINT_MAE_MAP), strict=False)
    optimizer = build_legacy_adamw(model.named_parameters(), LR, 0.05)
    tx = jbuild_legacy_adamw(LR, 0.05)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    for _ in range(3):
        grads = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
        updates, opt_state = update(jax.tree.map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = state_dict_from_flax({"params": grads}, POINT_MAE_MAP)
        for name, p in model.named_parameters():
            p.grad = tgrads[name].clone()
        optimizer.step()
        want = state_dict_from_flax({"params": jax.tree.map(np.asarray, jparams)},
                                    POINT_MAE_MAP)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6,
                                       rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# the step


def _draws(key, batch=B, groups=16):
    """What the JAX Point-MAE step draws from its key, as torch tensors."""
    r_aug, r_mask, _, _ = jax.random.split(key, 4)
    r_scale, r_shift = jax.random.split(r_aug)
    out = {"scale": jax.random.uniform(r_scale, (batch, 1, 3), minval=2.0 / 3.0,
                                       maxval=3.0 / 2.0),
           "shift": jax.random.uniform(r_shift, (batch, 1, 3), minval=-0.2, maxval=0.2),
           "noise": jax.random.uniform(r_mask, (batch, groups))}
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def three_steps():
    jmodel = JPointMAE(**SMALL)
    pts0 = jnp.zeros((2, N, 3), jnp.float32)
    mask0 = jnp.zeros((2, 16), bool).at[:, :NUM_MASK].set(True)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda key: jmodel.init(key, pts0, mask0, NUM_MASK))(jax.random.key(1)))
    tx = jbuild_legacy_adamw(LR, 0.05)
    jstate = jcreate_state(jax.tree.map(jnp.asarray, variables), tx)
    jstep = jmake_step(jmodel, tx, 0.6, "rand", "cdl2")
    model = load_flax_variables(PointMAE(**SMALL), variables, POINT_MAE_MAP)
    optimizer = build_legacy_adamw(model.named_parameters(), LR, 0.05)
    state = create_train_state(model, optimizer)
    step = make_pointmae_train_step(model, optimizer, 0.6, "rand", "cdl2", device="cpu")
    history, after_one = [], None
    for i in range(3):
        pts = np.random.default_rng(10 + i).standard_normal((B, N, 3)).astype(np.float32) * 0.5
        key = jax.random.key(i)
        jstate, jm = jstep(jstate, jnp.asarray(pts), key)
        state, m = step(state, torch.from_numpy(pts), None, draws=_draws(key))
        history.append(({k: float(jm[k]) for k in METRICS}, {k: float(m[k]) for k in METRICS}))
        if i == 0:
            after_one = (jax.tree.map(np.asarray, jstate.variables()),
                         {k: v.clone() for k, v in model.state_dict().items()})
    return history, after_one, variables, step, state


@pytest.mark.parametrize("index", [0, 1, 2])
def test_step_metrics_equal_the_jax_step(three_steps, index):
    want, got = three_steps[0][index]
    for key in METRICS:
        assert math.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4, err_msg=f"{index} {key}")


def test_parameters_and_bn_buffers_after_one_step(three_steps):
    """As ``test_torch_port_pretrain_step.py::_check_parameters_and_bn_buffers``:
    an entry that moved by at least 0.9 learning rates agrees to 5e-5, one
    whose gradient is rounding noise (``BN_FED_BIASES``, and any that moved
    less) only in size; BN statistics to 1e-5."""
    (jvars, got_sd), start = three_steps[1], state_dict_from_flax(three_steps[2], POINT_MAE_MAP)
    want = state_dict_from_flax(jvars, POINT_MAE_MAP)
    assert sorted(want) == sorted(k for k in got_sd if not k.endswith("num_batches_tracked"))
    unsure = total = 0
    for name in want:
        w, g, s = want[name].numpy(), got_sd[name].numpy(), start[name].numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=name)
            assert np.abs(g - s).max() > 1e-4, name
            continue
        sure = np.abs(w - s) >= 0.9 * LR
        if name.endswith(BN_FED_BIASES):
            # a bias that feeds a train-mode BatchNorm has a zero gradient in
            # exact arithmetic; rounding noise of 1e-7 still moves it by a
            # whole learning rate, with either sign
            sure[:] = False
        np.testing.assert_allclose(g[sure], w[sure], atol=5e-5, rtol=0, err_msg=name)
        assert np.abs(g - w).max() <= 2 * LR, name
        unsure += int((~sure).sum())
        total += sure.size
    assert unsure < 0.02 * total, (unsure, total)


def test_step_masks_point_maes_count_and_trains_in_train_mode(three_steps):
    step, state = three_steps[3], three_steps[4]
    assert step.num_mask == NUM_MASK and state.step == 3 and state.ema is None
    assert state.student.training


# ---------------------------------------------------------------------------
# the CLIs


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    """Small copies of ``config.yaml`` and ``config_m.yaml``, side by side (the
    GM3D CLI takes its teacher from ``config_m.yaml`` beside ``--config``).
    The teacher trains at the config's rate from epoch 0 (no warm-up), so
    that two epochs move the weights."""
    d = tmp_path_factory.mktemp("configs")
    for name in ("config.yaml", "config_m.yaml"):
        cfg = yaml.safe_load((REPO / "configs" / "pointmae" / name).read_text())
        cfg["model"].update(group_size=8, num_group=16)
        cfg["model"]["transformer_config"].update(
            trans_dim=48, encoder_dims=48, depth=2, num_heads=2, decoder_depth=1,
            decoder_num_heads=2, drop_path_rate=0.0)
        cfg["scheduler"]["kwargs"]["initial_epochs"] = 0
        (d / name).write_text(yaml.safe_dump(cfg))
    return d


def _teacher_flags(configs):
    return ["--config", str(configs / "config_m.yaml"), "--model_family", "pointmae",
            "--synthetic", "--batch_size", str(BATCH), "--synthetic_samples", str(SAMPLES),
            "--epochs", str(EPOCHS), "--steps_per_dispatch", "1", "--val_freq", "100",
            "--num_devices", "1"]


def _log(out_dir):
    with open(out_dir / "log.txt") as f:
        return [json.loads(line) for line in f]


def _reload_jax_cli():
    """``cli_harness.run_cli`` reloads ``gm3d_tpu.cli.pretrain`` while a test
    has patched what it imports (``tests/test_async_ckpt.py`` patches
    ``svm_probe`` and ``ema_decay_schedule``), which leaves those stubs bound in
    the module after that test. Reload it from the real modules."""
    importlib.reload(jcli)


def _no_probe(*args, **kwargs):
    """The SVM probe of both CLIs, skipped alike: ``val_svm_acc`` is 0.0 on
    both sides here, and the two probes are held against each other in
    ``tests/test_torch_port_probe.py``."""
    return 0.0


@pytest.fixture(scope="module")
def jax_teacher(configs, tmp_path_factory):
    """One JAX teacher run: its log and its orbax checkpoint."""
    out = tmp_path_factory.mktemp("jax_teacher")
    _reload_jax_cli()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "svm_probe", _no_probe)
        mp.setattr(sys, "argv", ["pretrain", *_teacher_flags(configs), "--output_dir", str(out)])
        _reset_gm3d_loggers()
        jcli.main()
    _reset_gm3d_loggers()
    return out


def _jax_draws(seed):
    """The port's ``step_draws``, replaced by the JAX CLI's key sequence
    (``rng, key = split(rng)`` a step, then the step's own split)."""
    state = {"rng": jax.random.key(seed)}

    def draws(generator, batch, num_group):
        state["rng"], key = jax.random.split(state["rng"])
        return _draws(key, batch, num_group)

    return draws


def _jax_init(model, num_mask):
    """The JAX CLI's ``init`` with key 1, as numpy."""
    pts = jnp.zeros((2, 1024, 3), jnp.float32)
    mask = jnp.zeros((2, model.num_group), bool).at[:, :num_mask].set(True)
    return jax.tree.map(np.asarray, jax.jit(
        lambda key: model.init(key, pts, mask, num_mask))(jax.random.key(1)))


def _assert_same_records(got, want, keys):
    assert len(got) == len(want) == EPOCHS
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g.get("val_svm_acc") == w.get("val_svm_acc")
        assert g["epoch"] == w["epoch"] and g["steps"] == w["steps"] == SAMPLES // BATCH
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        for key in keys:
            assert math.isfinite(g[key]), key
            np.testing.assert_allclose(g[key], w[key], rtol=2e-4,
                                       err_msg=f"epoch {g['epoch']} {key}")


def test_the_two_clis_train_the_teacher_alike(configs, jax_teacher, monkeypatch, tmp_path):
    jvars = _jax_init(JPointMAE(**SMALL), NUM_MASK)

    def build(args, cfg, dtype):
        return load_flax_variables(build_model_from_cfg(cfg["model"]), jvars, POINT_MAE_MAP)

    monkeypatch.setattr(cli, "build_pointmae", build)
    monkeypatch.setattr(cli, "step_draws", _jax_draws(0))
    monkeypatch.setattr(cli, "svm_probe", _no_probe)
    _reset_gm3d_loggers()
    got = cli.main([*_teacher_flags(configs), "--device", "cpu", "--output_dir", str(tmp_path)])
    assert got == _log(tmp_path)
    want = _log(jax_teacher)
    _assert_same_records(got, want, METRICS)
    assert sorted(got[0]) == sorted(
        ["loss", "grad_norm", "epoch", "time", "lr", "steps", "clouds_per_sec"])
    np.testing.assert_allclose([g["lr"] for g in got], [1e-3, 1e-3], rtol=1e-3)
    # the rolling saves of both epochs, the loader at the next epoch's start
    from gm3d_tpu_torch.ckpt.checkpoint import all_steps, load_loader_state, restore_raw

    assert all_steps(str(tmp_path / "ckpt")) == [2, 4]
    assert load_loader_state(str(tmp_path / "ckpt")) == {"epoch": 2, "batch": 0}
    raw = restore_raw(str(tmp_path / "ckpt"))
    assert raw["ema"] is None and raw["optimizer"]["param_groups"][0]["betas"] == (0.9, 0.999)


def test_the_whole_chain_teacher_converter_and_gm3d(configs, jax_teacher, monkeypatch, tmp_path):
    spec = importlib.util.spec_from_file_location("orbax_to_torch",
                                                  REPO / "tools" / "orbax_to_torch.py")
    converter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(converter)
    assert converter.main([str(jax_teacher / "ckpt"), str(tmp_path / "teacher")]) == 4
    flags = ["--config", str(configs / "config.yaml"), "--synthetic", "--batch_size",
             str(BATCH), "--synthetic_samples", str(SAMPLES), "--epochs", str(EPOCHS),
             "--steps_per_dispatch", "1", "--warmup_epochs", "1", "--blr", "0.064",
             "--val_freq", "100", "--num_devices", "1"]

    _reload_jax_cli()
    monkeypatch.setattr(jcli, "GM3DStudent", functools.partial(JGM3DStudent, **SMALL))
    monkeypatch.setattr(jcli, "svm_probe", _no_probe)
    monkeypatch.setattr(sys, "argv", ["pretrain", *flags, "--teacher_ckpt",
                                      str(jax_teacher / "ckpt"),
                                      "--output_dir", str(tmp_path / "jax")])
    _reset_gm3d_loggers()
    jcli.main()
    want = _log(tmp_path / "jax")

    svars = _jax_init(JGM3DStudent(mode="feature", **SMALL), 10)
    monkeypatch.setattr(cli, "build_student", lambda args, mode, dtype: load_flax_variables(
        GM3DStudent(mode=mode, **SMALL), svars, GM3D_STUDENT_MAP))
    monkeypatch.setattr(cli, "step_draws", _jax_draws(0))
    monkeypatch.setattr(cli, "svm_probe", _no_probe)
    _reset_gm3d_loggers()
    got = cli.main([*flags, "--teacher_ckpt", str(tmp_path / "teacher"), "--device", "cpu",
                    "--output_dir", str(tmp_path / "port")])
    _assert_same_records(got, want, GM3D_METRICS)
    assert "teacher loaded from step 4" in (tmp_path / "port" / "pretrain.log").read_text()
