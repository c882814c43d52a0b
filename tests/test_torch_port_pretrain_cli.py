"""The port's pretrain CLI against the JAX package's (CPU).

``gm3d_tpu_torch.cli.pretrain`` and ``gm3d_tpu.cli.pretrain`` run the same
flags for two epochs on the same synthetic clouds, with small models (the
step test's widths, stochastic depth 0) patched into both CLIs. Both start
from the JAX CLI's own initialisation (``init`` with keys 1 and 2), carried
across with ``load_flax_variables``, and the port is handed the draws of the
JAX CLI's key sequence (``rng, key = split(rng)`` a step, then the step's own
split). Then the two ``log.txt`` files must have the same keys, equal
``epoch`` and ``steps``, ``lr`` to ``rtol=1e-6``, the six epoch means to
``rtol=2e-4``, the step test's tolerance, and each epoch's SVM probe
accuracy ``val_svm_acc`` (``--val_freq 1``) to within one of its 64 test
clouds (the JAX probe fits sklearn's SVC, the port its own;
``tests/test_torch_port_probe.py``), with ``ckpt/best`` and
``best_metrics.json`` where that accuracy puts them.

Each CLI is called in this process, through its module's ``main()`` after
the patch (``cli_harness.run_cli`` reloads the module and would drop it).
"""

import functools
import importlib
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from cli_harness import _reset_gm3d_loggers

import gm3d_tpu.cli.pretrain as jcli
from gm3d_tpu.data.datasets import DataLoader as JDataLoader
from gm3d_tpu.data.datasets import SyntheticClouds as JSyntheticClouds
from gm3d_tpu.masking import gm3d_num_mask as jgm3d_num_mask
from gm3d_tpu.masking import keep_ratio_schedule as jkeep_ratio_schedule
from gm3d_tpu.models import GM3DStudent as JGM3DStudent
from gm3d_tpu.models import PointMAE as JPointMAE
from gm3d_tpu.train import schedules as jschedules
from gm3d_tpu.utils import MetricLogger as JMetricLogger
from gm3d_tpu.utils.meters import AverageMeter as JAverageMeter
from gm3d_tpu_torch.ckpt.torch_import import (
    GM3D_STUDENT_MAP,
    POINT_MAE_MAP,
    load_flax_variables,
)
from gm3d_tpu_torch.cli import pretrain as cli
from gm3d_tpu_torch.models import GM3DStudent, PointMAE
from gm3d_tpu_torch.utils import AverageMeter, MetricLogger
from gm3d_tpu_torch.utils.debug import check_finite_loss
from gm3d_tpu_torch.utils.pipeline import DeferredMetrics

SMALL = dict(trans_dim=48, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=48,
             decoder_depth=1, decoder_num_heads=2, drop_path_rate=0.0)
BATCH, SAMPLES, EPOCHS, NPOINTS = 4, 8, 2, 1024
# blr 0.064 at batch 4 is a learning rate of 1e-3 (the step test's); one
# warm-up epoch puts both branches of the schedule into the run; one device
# (the tests' JAX sees eight CPU devices)
FLAGS = ["--config", "configs/pointmae/config.yaml", "--synthetic",
         "--batch_size", str(BATCH), "--synthetic_samples", str(SAMPLES),
         "--epochs", str(EPOCHS), "--steps_per_dispatch", "1", "--warmup_epochs", "1",
         "--blr", "0.064", "--val_freq", "1", "--num_devices", "1"]
METRICS = ("loss", "loss_recon", "loss_mse", "loss_chfr", "loss_learn", "grad_norm")
SVM_TEST_CLOUDS = 64  # make_loaders: max(--synthetic_samples // 4, 64)


@pytest.fixture(autouse=True)
def _fresh_loggers():
    """Each CLI configures the "gm3d" logger once per process: leave it
    unconfigured for whatever runs next in this process."""
    yield
    _reset_gm3d_loggers()


@pytest.fixture(autouse=True)
def _jax_cli_as_imported():
    """``cli_harness.run_cli`` reloads ``gm3d_tpu.cli.pretrain`` while a test
    has patched what it imports (``tests/test_async_ckpt.py`` patches
    ``svm_probe`` and ``ema_decay_schedule``), which leaves those stubs bound in
    the module after that test. Reload it from the real modules first."""
    importlib.reload(jcli)


def _example():
    """The JAX CLI's example batch: the first of its train loader."""
    loader = JDataLoader(JSyntheticClouds(SAMPLES, NPOINTS, seed=1), BATCH, seed=0)
    return jnp.asarray(next(iter(loader)))


def _init_variables(mode, legacy=False):
    """What the JAX CLI's ``init`` gives its student (key 1) and teacher (key 2);
    ``legacy``: the older student, which has no decoder positional embedding."""
    example = _example()
    student = JGM3DStudent(mode=mode, shared_pos_embed=legacy, **SMALL)
    num_mask = jgm3d_num_mask(student.num_group, 0.6)
    mask0 = jnp.zeros((2, student.num_group), bool).at[:, :num_mask].set(True)
    svars = student.init(jax.random.key(1), example[:2], mask0, num_mask)
    tvars = JPointMAE(**SMALL).init(jax.random.key(2), example[:2], mask0, num_mask)
    return (jax.tree.map(np.asarray, svars), jax.tree.map(np.asarray, tvars))


def _jax_draws(seed):
    """The port's ``step_draws``, replaced: what the JAX CLI's step draws, in
    its key order (``gm3d_tpu/cli/pretrain.py:629`` then the step's split)."""
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


def _run_jax(monkeypatch, out_dir, mode_flags):
    monkeypatch.setattr(jcli, "GM3DStudent", functools.partial(JGM3DStudent, **SMALL))
    monkeypatch.setattr(jcli, "build_teacher",
                        lambda args, cfg, dtype: JPointMAE(**SMALL, dtype=dtype))
    monkeypatch.setattr(sys, "argv", ["pretrain", *FLAGS, *mode_flags,
                                      "--output_dir", str(out_dir)])
    _reset_gm3d_loggers()
    jcli.main()
    return _log(out_dir)


def _run_port(monkeypatch, out_dir, mode_flags, svars, tvars):
    def student(args, mode, dtype):
        model = GM3DStudent(mode=mode, shared_pos_embed=args.student_variant == "legacy",
                            **SMALL)
        return load_flax_variables(model, svars, GM3D_STUDENT_MAP)

    def teacher(args, cfg, dtype):
        return load_flax_variables(PointMAE(**SMALL), tvars, POINT_MAE_MAP)

    monkeypatch.setattr(cli, "build_student", student)
    monkeypatch.setattr(cli, "build_teacher", teacher)
    monkeypatch.setattr(cli, "step_draws", _jax_draws(seed=0))
    _reset_gm3d_loggers()
    records = cli.main([*FLAGS, *mode_flags, "--device", "cpu", "--output_dir", str(out_dir)])
    assert records == _log(out_dir)
    return records


# (--learn_feature_loss, the student's mode, more flags, the learning rate at the
# warm-up's peak): the defaults in two modes; the legacy student variant (which
# forces none); two micro-batches an update with the separated optimizers, whose
# effective learning rate doubles (blr x batch x accum_iter / 256)
CLI_CASES = {
    "dino": ("dino", "feature", [], 1e-3),
    "none": ("none", "usual", [], 1e-3),
    "legacy": ("dino", "usual", ["--student_variant", "legacy"], 1e-3),
    "dino-accum2-separated": ("dino", "feature", ["--accum_iter", "2", "--no-shared_opt"],
                              2e-3),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_the_two_clis_agree(case, monkeypatch, tmp_path):
    loss, mode, extra, peak_lr = CLI_CASES[case]
    flags = ["--learn_feature_loss", loss, *extra]
    want = _run_jax(monkeypatch, tmp_path / "jax", flags)
    svars, tvars = _init_variables(mode, legacy="legacy" in extra)
    got = _run_port(monkeypatch, tmp_path / "port", flags, svars, tvars)
    assert len(got) == len(want) == EPOCHS
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["epoch"] == w["epoch"] and g["steps"] == w["steps"] == SAMPLES // BATCH
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        for key in METRICS:
            assert math.isfinite(g[key]), key
            np.testing.assert_allclose(g[key], w[key], rtol=2e-4,
                                       err_msg=f"{case} epoch {g['epoch']} {key}")
    # --val_freq 1: a probe after each epoch, within one test cloud of the JAX CLI's
    for g, w in zip(got, want):
        assert abs(g["val_svm_acc"] - w["val_svm_acc"]) <= 1.0 / SVM_TEST_CLOUDS + 1e-12
    _assert_best(tmp_path / "port" / "ckpt", got)
    from gm3d_tpu.ckpt.checkpoint import latest_step as jlatest_step

    accs = [w["val_svm_acc"] for w in want]
    assert json.loads((tmp_path / "jax" / "ckpt" / "best_metrics.json").read_text()) == {
        "best": max(accs)}
    assert jlatest_step(str(tmp_path / "jax" / "ckpt" / "best")) == (
        accs.index(max(accs)) + 1) * (SAMPLES // BATCH)
    # the warm-up's peak after epoch 0, the cosine's end after epoch 1
    np.testing.assert_allclose([g["lr"] for g in got], [peak_lr, 0.0], rtol=1e-6, atol=0)
    assert (tmp_path / "port" / "pretrain.log").read_text().count("epoch 1: loss=") == 1
    assert any((tmp_path / "port" / "tfboard").iterdir())


def _assert_best(ckpt, records):
    """``best_metrics.json`` holds the best ``val_svm_acc``; ``ckpt/best`` one
    step, the end of the first epoch that reached it, with that accuracy."""
    from gm3d_tpu_torch.ckpt.checkpoint import all_steps, load_best_metrics

    accs = [r["val_svm_acc"] for r in records]
    step = (accs.index(max(accs)) + 1) * (SAMPLES // BATCH)
    assert load_best_metrics(str(ckpt)) == {"best": max(accs)}
    assert all_steps(str(ckpt / "best")) == [step]
    assert json.loads((ckpt / "best" / str(step) / "metrics.json").read_text()) == {
        "svm_acc": max(accs)}


def _small_models(monkeypatch):
    gen = torch.Generator().manual_seed(0)

    def student(args, mode, dtype):
        model = GM3DStudent(mode=mode, **SMALL)
        model.reset_parameters(gen)
        return model

    def teacher(args, cfg, dtype):
        model = PointMAE(**SMALL)
        model.reset_parameters(gen)
        return model

    monkeypatch.setattr(cli, "build_student", student)
    monkeypatch.setattr(cli, "build_teacher", teacher)


def test_nan_loss_exits_nonzero(monkeypatch, tmp_path):
    """--blr inf makes the first update non-finite; the next step's loss is
    NaN and the CLI exits with code 1, as the JAX CLI does
    (``tests/test_cli_guards.py``)."""
    _small_models(monkeypatch)
    _reset_gm3d_loggers()
    with pytest.raises(SystemExit) as e:
        cli.main(["--config", "configs/pointmae/config.yaml", "--synthetic",
                  "--learn_feature_loss", "ema", "--epochs", "2", "--batch_size", "4",
                  "--synthetic_samples", "12", "--warmup_epochs", "0", "--blr", "inf",
                  "--device", "cpu", "--output_dir", str(tmp_path)])
    assert e.value.code == 1


NOT_PORTED = [["--num_devices", "2"], ["--native_loader"]]


@pytest.mark.parametrize("loss", ["ema", "dino"])
def test_quantize_ema_is_refused_under_ema_and_trains_under_dino(loss, monkeypatch, tmp_path):
    """``--quantize_ema`` (ported): with ``--learn_feature_loss ema`` the step
    refuses it with the JAX step's ``ValueError`` before any epoch; under
    ``dino`` one epoch of the small models trains with finite metrics."""
    _small_models(monkeypatch)
    _reset_gm3d_loggers()
    flags = ["--config", "configs/pointmae/config.yaml", "--synthetic", "--quantize_ema",
             "--learn_feature_loss", loss, "--epochs", "1", "--batch_size", "4",
             "--synthetic_samples", "8", "--num_workers", "0", "--device", "cpu",
             "--output_dir", str(tmp_path)]
    if loss == "ema":
        with pytest.raises(ValueError, match="quantize_ema is not allowed"):
            cli.main(flags)
        assert not (tmp_path / "log.txt").exists()
        return
    records = cli.main(flags)
    assert len(records) == 1 and records[0]["steps"] == 2
    assert all(np.isfinite(records[0][k]) for k in ("loss", "loss_mse", "loss_chfr", "loss_learn"))


def test_the_legacy_variant_is_refused_for_other_families(tmp_path):
    """``gm3d_tpu/cli/pretrain.py:203-210``: the legacy semantics exist for
    the GM3D student only; both CLIs exit with the same message."""
    want = "--student_variant legacy is only defined for --model_family gm3d (got 'pointmae')"
    _reset_gm3d_loggers()
    with pytest.raises(SystemExit) as e:
        cli.main(["--config", "configs/pointmae/config_m.yaml", "--model_family", "pointmae",
                  "--student_variant", "legacy", "--synthetic", "--device", "cpu",
                  "--output_dir", str(tmp_path)])
    assert str(e.value.code) == want
    assert not (tmp_path / "log.txt").exists()


def test_epoch_scalars_of_the_legacy_variant_are_the_jax_clis():
    """The legacy variant's uncapped slope-0.5 ramp (``keep_ratio_schedule``
    with ``legacy=True``), not usual mode's capped one."""
    args = cli.parse_args(FLAGS + ["--student_variant", "legacy", "--learn_feature_loss",
                                   "none"])
    for epoch in range(8):
        assert cli.epoch_scalars(args, epoch, 8)["keep_ratio"] == jkeep_ratio_schedule(
            epoch, 8, False, legacy=True)


@pytest.fixture
def one_torch_thread():
    """The small models' tensors are tiny: torch's intra-op threads only
    contend with the other test workers'; the count comes back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_torch_thread")
def test_accumulation_separated_and_bf16_together(monkeypatch, tmp_path):
    """``--accum_iter 2 --no-shared_opt --bf16`` (the card's CLI run, small
    here): one epoch of four micro-steps, two updates; finite records; the
    checkpoint holds the window's accumulation (closed: count 0, two
    updates) and both halves of the optimizer, and ``--resume`` reads it."""
    from gm3d_tpu_torch.ckpt.checkpoint import latest_step, restore_raw

    _small_models(monkeypatch)
    flags = [*SMALL_RUN, "--learn_feature_loss", "dino", "--epochs", "1", "--accum_iter", "2",
             "--no-shared_opt", "--bf16", "--output_dir", str(tmp_path)]
    _reset_gm3d_loggers()
    records = cli.main(flags)
    assert [(r["epoch"], r["steps"]) for r in records] == [(0, 4)]
    assert all(math.isfinite(records[0][k]) for k in METRICS)
    raw = restore_raw(str(tmp_path / "ckpt"))
    assert raw["step"] == 4 and latest_step(str(tmp_path / "ckpt")) == 4
    assert (raw["optimizer"]["mini_step"], raw["optimizer"]["gradient_step"]) == (0, 2)
    assert set(raw["optimizer"]["inner"]) == {"recon", "loss_pred"}
    _reset_gm3d_loggers()
    again = cli.main([*flags[:-2], "--epochs", "2", "--output_dir", str(tmp_path), "--resume"])
    assert [(r["epoch"], r["steps"]) for r in again] == [(1, 4)]
    assert "resumed from step 4" in (tmp_path / "pretrain.log").read_text()


@pytest.mark.usefixtures("one_torch_thread")
def test_a_probe_at_its_iteration_cap_warns_and_the_run_goes_on(monkeypatch, tmp_path):
    """The SVC stops at ``MAX_ITER`` (2 here) far from converged: the epoch
    ends, its record holds ``val_svm_acc`` and ``val_svm_gap`` (the largest
    pair's KKT gap, above the tolerance), and ``pretrain.log`` says so."""
    from gm3d_tpu_torch.eval import linear_svc

    _small_models(monkeypatch)
    monkeypatch.setattr(linear_svc, "MAX_ITER", 2)
    _reset_gm3d_loggers()
    with pytest.warns(linear_svc.ConvergenceWarning):
        records = cli.main([*SMALL_RUN, "--epochs", "1", "--synthetic_samples", "8",
                            "--sync_probe", "--output_dir", str(tmp_path)])
    assert len(records) == 1 and 0.0 <= records[0]["val_svm_acc"] <= 1.0
    assert records[0]["val_svm_gap"] > linear_svc.TOL
    text = (tmp_path / "pretrain.log").read_text()
    assert "the linear SVC stopped at its cap of 2 iterations" in text


@pytest.mark.parametrize("flags", NOT_PORTED, ids=lambda f: " ".join(f))
def test_flags_not_ported_yet_raise_and_name_their_item(flags, monkeypatch, tmp_path):
    """The two flags that raised before their items were ported now refuse
    only what they cannot do, before anything is trained or written:
    ``--num_devices`` other than the world size names ``torchrun`` (data
    parallelism: ``tests/test_torch_port_parallel.py``); ``--native_loader``
    over an on-disk set whose C++ loader does not build raises with the
    compiler's output and does not fall back to the Python loader (the loader:
    ``tests/test_torch_port_native_loader.py``)."""
    _reset_gm3d_loggers()
    config = "configs/pointmae/config.yaml"
    if flags == ["--native_loader"]:
        from gm3d_tpu_torch.native import native_loader
        from gm3d_tpu_torch.scripts import make_disk_datasets as disk

        shapenet = disk.write_shapenet55(str(tmp_path / "shapenet"), 4, 1, 64, seed=0)
        config = disk.pretrain_config(str(tmp_path / "disk.yaml"), config, shapenet,
                                      str(tmp_path / "no-modelnet"))
        monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(native_loader, "_lib", None)
        monkeypatch.setenv("CXX", "false")
        raised = pytest.raises(RuntimeError, match="building the native loader")
    else:
        raised = pytest.raises(ValueError, match="torchrun")
    data = [] if flags == ["--native_loader"] else ["--synthetic"]
    with raised:
        cli.main(["--config", config, *data, "--device", "cpu", "--output_dir", str(tmp_path),
                  *flags])
    assert not (tmp_path / "log.txt").exists()


# ---------------------------------------------------------------------------
# checkpoints, resume, preemption, tracing (what replaced the NOT_PORTED cases
# of --resume, --save_steps, --profile_dir and --teacher_ckpt; --model_family
# pointmae is held against the JAX CLI in tests/test_torch_port_teacher.py)


def _crash_at_third_check(monkeypatch, module):
    """Raise in the third NaN check: ``--save_steps 1`` has saved steps 1 and
    2, and step 3's save is never submitted (``tests/test_cli_resume.py``)."""
    orig, calls = module.check_finite_loss, {"n": 0}

    def crashing(loss_value, logger=None, exit_on_nan=True):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected crash")
        return orig(loss_value, logger, exit_on_nan)

    monkeypatch.setattr(module, "check_finite_loss", crashing)
    return orig


def test_resume_after_a_crash_equals_the_jax_clis(monkeypatch, tmp_path):
    """Both CLIs: ``--save_steps 1``, a crash after step 3, then ``--resume``.
    The same latest step, sidecars and per-epoch ``steps`` (no batch
    replayed), and the resumed run's epoch means to 2e-4. Both restart their
    random sequence from ``--seed`` on resume (``gm3d_tpu/cli/pretrain.py:181``).

    Usual mode (``none``): in ``dino`` and ``ema`` eight steps of these small
    models are chaotic, since the mask and the relative learning loss rank
    near-equal predicted losses. Weights perturbed by 1e-7 (relative) move the
    port's own epoch-1 means by 1e-3 there, by 1.5e-5 in usual mode."""
    from gm3d_tpu.ckpt import load_loader_state as jload_loader_state
    from gm3d_tpu.ckpt.checkpoint import latest_step as jlatest_step
    from gm3d_tpu_torch.ckpt.checkpoint import latest_step, load_loader_state

    flags = ["--learn_feature_loss", "none", "--synthetic_samples", "16", "--save_steps", "1"]
    orig = _crash_at_third_check(monkeypatch, jcli)
    # the probe is stubbed on both sides alike: its accuracy is compared elsewhere
    monkeypatch.setattr(jcli, "svm_probe", lambda *a, **k: 0.0)
    monkeypatch.setattr(cli, "svm_probe", lambda *a, **k: 0.0)
    with pytest.raises(RuntimeError, match="injected crash"):
        _run_jax(monkeypatch, tmp_path / "jax", flags)
    monkeypatch.setattr(jcli, "check_finite_loss", orig)
    svars, tvars = _init_variables("usual")
    orig = _crash_at_third_check(monkeypatch, cli)
    with pytest.raises(RuntimeError, match="injected crash"):
        _run_port(monkeypatch, tmp_path / "port", flags, svars, tvars)
    monkeypatch.setattr(cli, "check_finite_loss", orig)
    jck, ck = str(tmp_path / "jax" / "ckpt"), str(tmp_path / "port" / "ckpt")
    assert jlatest_step(jck) == latest_step(ck) == 2
    assert jload_loader_state(jck) == load_loader_state(ck) == {"epoch": 0, "batch": 2}
    assert not (tmp_path / "port" / "log.txt").exists()

    want = _run_jax(monkeypatch, tmp_path / "jax", flags + ["--resume"])
    got = _run_port(monkeypatch, tmp_path / "port", flags + ["--resume"], svars, tvars)
    assert jlatest_step(jck) == latest_step(ck) == 8
    assert jload_loader_state(jck) == load_loader_state(ck) == {"epoch": 2, "batch": 0}
    assert [r["steps"] for r in got] == [r["steps"] for r in want] == [2, 4]
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    for g, w in zip(got, want):
        assert g.get("val_svm_acc") == w.get("val_svm_acc")
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        for key in METRICS:
            np.testing.assert_allclose(g[key], w[key], rtol=2e-4,
                                       err_msg=f"resumed epoch {g['epoch']} {key}")
    assert [r["val_svm_acc"] for r in got] == [0.0, 0.0]  # the stubs' accuracy
    assert "resumed from step 2" in (tmp_path / "port" / "pretrain.log").read_text()


SMALL_RUN = ["--config", "configs/pointmae/config.yaml", "--synthetic", "--learn_feature_loss",
             "ema", "--epochs", "2", "--batch_size", "4", "--synthetic_samples", "16",
             "--device", "cpu"]


def test_sigterm_saves_exits_0_and_resume_completes(monkeypatch, tmp_path):
    """A real SIGTERM, raised in this process while step 2 draws: the step
    ends, the checkpoint and the loader position are saved (``--sync_save``),
    the CLI exits 0; ``--resume`` trains the rest, 8 steps in all, and
    ``--save_interval 1`` leaves a snapshot of each epoch it ends."""
    import signal

    from gm3d_tpu_torch.ckpt.checkpoint import all_steps, latest_step, load_loader_state
    from gm3d_tpu_torch.utils.preempt import PreemptionGuard

    _small_models(monkeypatch)
    draws, calls = cli.step_draws, {"n": 0}

    def signalling(generator, batch, num_group):
        calls["n"] += 1
        if calls["n"] == 2:
            handler = signal.getsignal(signal.SIGTERM)
            # the guard's handler, or the signal would end the test process
            assert getattr(handler, "__self__", None).__class__ is PreemptionGuard
            signal.raise_signal(signal.SIGTERM)
        return draws(generator, batch, num_group)

    monkeypatch.setattr(cli, "step_draws", signalling)
    out = tmp_path / "run"
    before = signal.getsignal(signal.SIGTERM)
    _reset_gm3d_loggers()
    with pytest.raises(SystemExit) as e:
        cli.main([*SMALL_RUN, "--sync_save", "--output_dir", str(out)])
    assert e.value.code == 0 and calls["n"] == 2
    assert signal.getsignal(signal.SIGTERM) == before
    ck = str(out / "ckpt")
    assert latest_step(ck) == 2 and load_loader_state(ck) == {"epoch": 0, "batch": 2}
    assert not (out / "log.txt").exists()
    assert "preempted: checkpoint + loader position saved" in (out / "pretrain.log").read_text()

    monkeypatch.setattr(cli, "step_draws", draws)
    _reset_gm3d_loggers()
    records = cli.main([*SMALL_RUN, "--resume", "--save_interval", "1", "--output_dir", str(out)])
    assert [(r["epoch"], r["steps"]) for r in records] == [(0, 2), (1, 4)]
    assert latest_step(ck) == 8 and load_loader_state(ck) == {"epoch": 2, "batch": 0}
    assert all_steps(str(out / "ckpt" / "epochs")) == [4, 8]
    assert all(math.isfinite(r[k]) for r in records for k in METRICS)


def test_profile_dir_writes_a_trace_of_the_first_steps(monkeypatch, tmp_path):
    _small_models(monkeypatch)
    _reset_gm3d_loggers()
    cli.main([*SMALL_RUN, "--epochs", "1", "--synthetic_samples", "8", "--profile_dir",
              str(tmp_path / "prof"), "--profile_steps", "1", "--output_dir", str(tmp_path)])
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert "profiler trace written to" in (tmp_path / "pretrain.log").read_text()


def test_a_missing_teacher_ckpt_raises(monkeypatch, tmp_path):
    _small_models(monkeypatch)
    _reset_gm3d_loggers()
    with pytest.raises(FileNotFoundError, match="no teacher ckpt"):
        cli.main(["--config", "configs/pointmae/config.yaml", "--synthetic", "--device", "cpu",
                  "--teacher_ckpt", str(tmp_path / "none"), "--output_dir", str(tmp_path)])


def test_the_cli_defaults_to_cuda_and_says_so(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--config", "configs/pointmae/config.yaml", "--synthetic",
                  "--output_dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()


def test_loaders_equal_the_jax_clis(tmp_path):
    """``make_loaders`` on synthetic clouds: the same three loaders, the same
    batches, as ``gm3d_tpu/cli/common.py::make_loaders``."""
    from gm3d_tpu.cli.common import make_loaders as jmake_loaders
    from gm3d_tpu_torch.cli.common import load_config, make_loaders

    args = cli.parse_args(FLAGS + ["--num_workers", "2", "--seed", "3",
                                   "--output_dir", str(tmp_path)])
    cfg = load_config(args)
    assert cfg["max_epoch"] == EPOCHS and cfg["total_bs"] == BATCH
    mine, theirs = make_loaders(cfg, args), jmake_loaders(cfg, args)
    # the SVM sets: at least 64 clouds, in batches of twice the train batch
    assert [len(m) for m in mine] == [len(t) for t in theirs] == [2, 8, 8]
    for m, t in zip(mine, theirs):
        for got, want in zip(list(m), list(t)):
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                np.testing.assert_array_equal(g, w)
    assert mine[0].state() == theirs[0].state() == {"epoch": 1, "batch": 0}


def _modelnet2_files(root):
    """A tiny ModelNet of two categories: four training clouds, two test ones."""
    cats = ["chair", "desk"]
    root.mkdir()
    (root / "modelnet2_shape_names.txt").write_text("\n".join(cats) + "\n")
    ids = {"train": ["chair_0001", "desk_0001", "chair_0002", "desk_0002"],
           "test": ["chair_0003", "desk_0003"]}
    for split, shapes in ids.items():
        (root / f"modelnet2_{split}.txt").write_text("\n".join(shapes) + "\n")
        for i, shape in enumerate(shapes):
            cat = shape.rsplit("_", 1)[0]
            (root / cat).mkdir(exist_ok=True)
            # fewer rows than the 8192 the reader samples: FPS repeats points then
            rows = np.random.default_rng(i).standard_normal((120, 6)) + 3.0 * (cat == "desk")
            np.savetxt(root / cat / f"{shape}.txt", rows, delimiter=",", fmt="%.6f")


def test_the_cli_trains_on_shapenet_files(monkeypatch, tmp_path):
    """Without ``--synthetic`` the train set is the config's ShapeNet-55
    (here three tiny files the test writes) and the SVM probe's sets are its
    ModelNet ones (a tiny two-class ModelNet the test writes too)."""
    import yaml

    pc = tmp_path / "pc"
    pc.mkdir()
    names = [f"0269{i}-m{i}.npy" for i in range(4)]
    for i, name in enumerate(names):
        np.save(pc / name, np.random.default_rng(i).standard_normal((300, 3)).astype(np.float32))
    (tmp_path / "train.txt").write_text("\n".join(names) + "\n")
    with open("configs/pointmae/config.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["dataset"]["train"]["_base_"].update(DATA_PATH=str(tmp_path), PC_PATH=str(pc))
    cfg["npoints"] = 256
    cfg["dataset"]["train"]["others"]["npoints"] = 256
    _modelnet2_files(tmp_path / "modelnet")
    for split in ("extra_train_svm", "extra_test_svm"):
        cfg["dataset"][split]["_base_"].update(DATA_PATH=str(tmp_path / "modelnet"),
                                               NUM_CATEGORY=2)
        cfg["dataset"][split]["others"]["npoints"] = 256
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    _small_models(monkeypatch)
    records = cli.main(["--config", str(tmp_path / "cfg.yaml"), "--learn_feature_loss", "ema",
                        "--epochs", "1", "--batch_size", "2", "--device", "cpu",
                        "--output_dir", str(tmp_path / "out")])
    assert len(records) == 1 and records[0]["steps"] == 2
    assert all(math.isfinite(records[0][k]) for k in METRICS)
    # two test clouds: the accuracy is 0, 0.5 or 1
    assert records[0]["val_svm_acc"] in (0.0, 0.5, 1.0)


def test_step_draws_come_from_the_generator():
    one = cli.step_draws(torch.Generator().manual_seed(3), 5, 16)
    two = cli.step_draws(torch.Generator().manual_seed(3), 5, 16)
    assert {k: tuple(v.shape) for k, v in one.items()} == {
        "scale": (5, 1, 3), "shift": (5, 1, 3), "noise": (5, 16)}
    for key in one:
        assert torch.equal(one[key], two[key])
    assert 2.0 / 3.0 <= float(one["scale"].min()) and float(one["scale"].max()) < 1.5
    assert -0.2 <= float(one["shift"].min()) and float(one["shift"].max()) < 0.2
    assert 0.0 <= float(one["noise"].min()) and float(one["noise"].max()) < 1.0


@pytest.mark.parametrize("loss, after_200", [("dino", False), ("dino", True), ("ema", False),
                                             ("none", False)])
def test_epoch_scalars_are_the_jax_clis(loss, after_200):
    """``gm3d_tpu/cli/pretrain.py:532-552``, epoch by epoch."""
    args = cli.parse_args(FLAGS + ["--learn_feature_loss", loss, "--after_epoch", "3"]
                          + (["--after_200_epoch"] if after_200 else []))
    epochs = 8
    for epoch in range(epochs):
        got = cli.epoch_scalars(args, epoch, epochs)
        capped = after_200 or loss == "none"
        w_mse, w_cd = ((13.889, 1.0) if loss == "none" else
                       jschedules.loss_weights(epoch, 3, args.loss_multiply_by))
        assert got == {"keep_ratio": jkeep_ratio_schedule(epoch, epochs, capped),
                       "ema_decay": jschedules.ema_decay_schedule(epoch),
                       "w_mse": w_mse, "w_cd": w_cd}
    assert cli.student_mode(args) == ("usual" if loss == "none" else "feature")


# ---------------------------------------------------------------------------
# meters, the metrics pipeline and the NaN exit (copies of the JAX package's)


def test_meters_equal_the_jax_meters():
    mine, theirs = MetricLogger(), JMetricLogger()
    values = np.random.default_rng(0).standard_normal((30, 2))
    for a, b in values:
        mine.update(loss=a, grad_norm=b)
        theirs.update(loss=a, grad_norm=b)
    assert mine.global_avgs() == theirs.global_avgs()
    assert str(mine) == str(theirs)
    assert mine.meters["loss"].count == 30
    avg, javg = AverageMeter(["a", "b"]), JAverageMeter(["a", "b"])
    for a, b in values:
        avg.update([a, b])
        javg.update([a, b])
    assert avg.avg() == javg.avg() and avg.avg(1) == javg.avg(1)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_deferred_metrics_drain_in_order_depth_behind(depth):
    drained = []
    dm = DeferredMetrics(lambda x: drained.append(x), depth=depth)
    for i in range(5):
        dm.push(i)
        assert drained == list(range(max(0, i + 1 - depth)))
    dm.flush()
    assert drained == list(range(5))


def test_check_finite_loss_exits_with_code_1():
    assert check_finite_loss(1.5)
    assert not check_finite_loss(float("nan"), exit_on_nan=False)
    with pytest.raises(SystemExit) as e:
        check_finite_loss(float("inf"))
    assert e.value.code == 1
