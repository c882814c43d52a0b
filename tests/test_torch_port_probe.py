"""The port's SVM probe, its linear SVC and the ``--classification`` probe,
against the JAX package and sklearn (CPU).

* ``eval/linear_svc.py`` against ``sklearn.svm.SVC(C=0.01, kernel='linear',
  decision_function_shape='ovo')`` (libsvm): equal predictions and decision
  values within ``DEC_TOL`` = 5e-3, five times libsvm's stopping tolerance
  (libsvm stops at a KKT gap of 1e-3, the port at 1e-5). Against the same
  SVC solved to ``tol=1e-8`` the port agrees within ``TIGHT_TOL`` = 1e-4: it
  sits nearer the optimum than sklearn's default does.
* ``eval/svm.py``: the same pooled features as ``gm3d_tpu/eval/svm.py`` from
  the same weights (to 1e-5), and the same accuracy.
* ``train/pretrain.py::make_probe_step`` against the JAX step with the same
  weights and the dropout masks the JAX step drew: loss, accuracy, the
  classifier's parameters and BN buffers after two steps, to 2e-4. The JAX
  step runs eagerly (``jax.disable_jit``): jitted on XLA:CPU its gradient of
  the classifier's LayerNorm scale is off by up to 0.012 on these inputs,
  where its eager gradient and the port's agree, and central differences
  side with them.
  Three biases have a gradient that is zero in exact arithmetic (the
  LayerNorm's shift, and the two dense layers' biases that a train-mode
  BatchNorm follows, which cancel in it): AdamW's first step moves such a
  parameter by up to its learning rate in the direction of the rounding
  noise, on either side. Those three are held to that bound, and the BN
  running means they enter after the second step to 1e-3.
* The CLI: ``--classification`` against the JAX CLI; ``ckpt/best`` kept
  across a resume; a background probe joined at SIGTERM; the background
  probe sees the weights of its epoch's end.
"""

import functools
import importlib
import json
import math
import sys
import threading
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from cli_harness import _reset_gm3d_loggers
from sklearn.svm import SVC

import gm3d_tpu.cli.pretrain as jcli
from gm3d_tpu.data.datasets import DataLoader as JDataLoader
from gm3d_tpu.data.datasets import SyntheticClouds as JSyntheticClouds
from gm3d_tpu.eval import svm as jsvm
from gm3d_tpu.masking import gm3d_num_mask as jgm3d_num_mask
from gm3d_tpu.models import Classifier as JClassifier
from gm3d_tpu.models import GM3DStudent as JGM3DStudent
from gm3d_tpu.train.optim import build_adamw as jbuild_adamw
from gm3d_tpu.train.pretrain import make_probe_step as jmake_probe_step
from gm3d_tpu.train.state import create_train_state as jcreate_train_state
from gm3d_tpu_torch.ckpt.torch_import import (
    CLASSIFIER_MAP,
    GM3D_STUDENT_MAP,
    load_flax_variables,
    state_dict_from_flax,
)
from gm3d_tpu_torch.cli import pretrain as cli
from gm3d_tpu_torch.eval import linear_svc, svm
from gm3d_tpu_torch.models import GM3DStudent
from gm3d_tpu_torch.models.point_transformer import Classifier
from gm3d_tpu_torch.ops import _build
from gm3d_tpu_torch.train.optim import build_adamw
from gm3d_tpu_torch.train.pretrain import make_probe_step, probe_draws
from gm3d_tpu_torch.train.state import create_train_state

C = 0.01
DEC_TOL = 5e-3
TIGHT_TOL = 1e-4
SMALL = dict(trans_dim=48, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=48,
             decoder_depth=1, decoder_num_heads=2, drop_path_rate=0.0)


@pytest.fixture(autouse=True)
def _fresh_loggers():
    yield
    _reset_gm3d_loggers()


@pytest.fixture(autouse=True)
def _jax_cli_as_imported():
    """``cli_harness.run_cli`` reloads ``gm3d_tpu.cli.pretrain`` while a test
    has patched what it imports (``tests/test_async_ckpt.py`` patches
    ``svm_probe`` and ``ema_decay_schedule``), which leaves those stubs bound in
    the module after that test. Reload it from the real modules first."""
    importlib.reload(jcli)


# ---------------------------------------------------------------------------
# the linear SVC against sklearn


def _blobs(classes, per_class, dim, sep, seed, scale=1.0, test_per_class=10):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((classes, dim)) * sep
    y = np.repeat(np.arange(classes), per_class)
    rng.shuffle(y)
    x = (means[y] + rng.standard_normal((len(y), dim))) * scale
    yt = np.repeat(np.arange(classes), test_per_class)
    xt = (means[yt] + rng.standard_normal((len(yt), dim))) * scale
    return x.astype(np.float32), y, xt.astype(np.float32)


def _two_classes():
    return _blobs(2, 40, 8, 0.5, 0)


def _three_classes():
    return _blobs(3, [25, 40, 12], 8, 0.5, 1)


def _ten_classes():
    return _blobs(10, 30, 32, 0.4, 2)


def _tied_vote():
    """Three classes in the plane, of different spreads, so that the three
    pairwise boundaries leave a triangle between them; test points on a grid
    across it. Inside it each class wins one vote: the first class wins."""
    rng = np.random.default_rng(3)
    means = np.array([[0.0, 3.0], [3.0, -1.5], [-3.0, -1.5]])
    spread = np.array([0.5, 1.5, 3.0])
    y = np.repeat(np.arange(3), 30)
    x = means[y] + rng.standard_normal((len(y), 2)) * spread[y][:, None]
    grid = np.linspace(-2.0, 2.0, 41)
    xt = np.stack(np.meshgrid(grid, grid), -1).reshape(-1, 2)
    return x.astype(np.float32), y, xt.astype(np.float32)


def _no_free_alpha():
    """Balanced classes at a tiny scale: every multiplier ends at C, and the
    bias comes from the bounds alone."""
    return _blobs(3, 20, 6, 0.5, 4, scale=0.01)


def _jax_student_features():
    """Pooled features of the JAX probe's ``make_feature_fn`` on a small
    randomly initialised GM3D student, 10 synthetic classes."""
    model, variables = _jax_student()
    feature_fn = jsvm.make_feature_fn(model, npoints=128)
    train, test = _clouds(60, 0), _clouds(30, 1)
    x, y = jsvm.extract_features(feature_fn, variables, [train])
    xt, _ = jsvm.extract_features(feature_fn, variables, [test])
    return x, y, xt


def _clouds(count, seed, points=160, classes=10):
    """Labelled clouds: a blob per class, jittered."""
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(99).standard_normal((classes, 4, 3))
    labels = np.arange(count) % classes
    which = rng.integers(0, 4, (count, points))
    pts = centers[labels[:, None], which] + 0.2 * rng.standard_normal((count, points, 3))
    return pts.astype(np.float32), labels


@functools.lru_cache(maxsize=1)
def _jax_student():
    model = JGM3DStudent(mode="feature", **SMALL)
    pts = jnp.zeros((2, 128, 3), jnp.float32)
    mask = jnp.zeros((2, model.num_group), bool).at[:, :10].set(True)
    variables = jax.jit(lambda key: model.init(key, pts, mask, 10))(jax.random.key(1))
    return model, jax.tree.map(np.asarray, variables)


@functools.lru_cache(maxsize=2)
def _jax_encoder(model):
    return jax.jit(lambda v, pts: model.apply(v, pts, method=model.encode_features))


CASES = {"two classes": _two_classes, "three classes, unequal": _three_classes,
         "ten classes": _ten_classes, "tied vote": _tied_vote,
         "no free alpha": _no_free_alpha, "JAX probe features": _jax_student_features}


@pytest.mark.parametrize("case", list(CASES))
def test_the_linear_svc_equals_sklearns(case):
    x, y, xt = CASES[case]()
    ref = SVC(C=C, kernel="linear", decision_function_shape="ovo").fit(x, y)
    model = linear_svc.fit_linear_svc(torch.from_numpy(x), torch.from_numpy(y), c=C)
    got_pred = linear_svc.predict(model, torch.from_numpy(xt)).numpy()
    np.testing.assert_array_equal(got_pred, ref.predict(xt))
    got = linear_svc.decision_function(model, torch.from_numpy(xt)).numpy()
    want = ref.decision_function(xt)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=DEC_TOL)
    tight = SVC(C=C, kernel="linear", decision_function_shape="ovo", tol=1e-8).fit(x, y)
    np.testing.assert_allclose(got, tight.decision_function(xt), rtol=0, atol=TIGHT_TOL)
    assert int(model.iterations.min()) > 0 and float(model.gap.max()) < linear_svc.TOL
    if case == "tied vote":
        dec = linear_svc.ovo_decision_values(model, torch.from_numpy(xt)).numpy()
        votes = np.zeros((len(xt), 3), int)
        for p, (i, j) in enumerate(model.pairs):
            winner = np.where(dec[:, p] > 0, i, j)
            votes[np.arange(len(xt)), winner] += 1
        tied = votes.max(axis=1) == 1
        assert tied.sum() >= 5, "the grid must cross the three-way tie"
        assert (got_pred[tied] == 0).all()
    if case == "no free alpha":
        # sklearn's multipliers are all at the bound: no free one in any pair
        np.testing.assert_allclose(np.abs(ref.dual_coef_), C, rtol=1e-9)


def test_the_linear_svc_raises_when_it_does_not_converge():
    """At its iteration cap the fit raises a ``ConvergenceWarning`` (sklearn's
    SVC warns there too) and returns the model as it stands: the pairs still
    running report a gap above ``TOL`` after ``max_iter`` iterations, and the
    model predicts."""
    x, y, xt = _ten_classes()
    with pytest.warns(linear_svc.ConvergenceWarning, match="did not reach a KKT gap"):
        model = linear_svc.fit_linear_svc(torch.from_numpy(x), torch.from_numpy(y), max_iter=5)
    assert float(model.gap.max()) > linear_svc.TOL
    assert int(model.iterations.max()) == 5
    assert linear_svc.predict(model, torch.from_numpy(xt)).shape == (len(xt),)


def test_the_linear_svc_keeps_labels_and_refuses_one_class():
    x, y, xt = _three_classes()
    labels = np.array([7, 3, 11])[y]  # any integer labels, sorted as sklearn sorts them
    model = linear_svc.fit_linear_svc(torch.from_numpy(x), torch.from_numpy(labels))
    ref = SVC(C=C, kernel="linear").fit(x, labels)
    np.testing.assert_array_equal(linear_svc.predict(model, torch.from_numpy(xt)).numpy(),
                                  ref.predict(xt))
    with pytest.raises(ValueError, match="two classes"):
        linear_svc.fit_linear_svc(torch.from_numpy(x), torch.zeros(len(x), dtype=torch.int64))


# ---------------------------------------------------------------------------
# the probe of both packages from the same weights


def _port_student():
    _, variables = _jax_student()
    return load_flax_variables(GM3DStudent(mode="feature", **SMALL), variables,
                               GM3D_STUDENT_MAP)


def test_the_svm_probe_equals_the_jax_probe():
    model, variables = _jax_student()
    student = _port_student().train()
    train, test = _clouds(60, 0), _clouds(30, 1)
    want_fn = jsvm.make_feature_fn(model, npoints=128)
    got_fn = svm.make_feature_fn(student, npoints=128)
    np.testing.assert_allclose(got_fn(torch.from_numpy(train[0])).numpy(),
                               np.asarray(want_fn(variables, jnp.asarray(train[0]))),
                               rtol=1e-5, atol=1e-5)
    assert student.training  # the probe puts the student's mode back
    stats = {}
    got = svm.svm_probe(student, [train], [test], npoints=128, stats=stats)
    want = jsvm.svm_probe(model, variables, [train], [test], npoints=128)
    assert got == want and 0.0 < got <= 1.0
    assert set(stats) == {"extract_ms", "fit_ms", "iterations"} and stats["iterations"] > 0


# ---------------------------------------------------------------------------
# the --classification probe step against the JAX step


@functools.lru_cache(maxsize=4)
def _jax_mask_fn(classifier, batch, num_group, dim):
    """``(cvars, rng) -> keep masks``: what the JAX classifier's two dropouts
    draw from ``rng`` (the key its step passes as ``rngs={"dropout": rng}``).
    Each dropout is handed ones, and the units it keeps come out non-zero."""

    def masks(cvars, rng):
        kept = []

        def interceptor(next_fun, args, kwargs, context):
            if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
                x = args[0]
                keep = next_fun(jnp.ones_like(x), *args[1:], **kwargs) != 0
                kept.append(keep)
                return jnp.where(keep, x / (1.0 - context.module.rate), 0.0)
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(interceptor):
            classifier.apply(cvars, jnp.ones((batch, num_group, dim)), deterministic=False,
                             rngs={"dropout": rng}, mutable=["batch_stats"])
        return tuple(kept)

    return jax.jit(masks)


def _jax_dropout_masks(classifier, cvars, batch, num_group, dim, rng):
    masks = _jax_mask_fn(classifier, batch, num_group, dim)(cvars, rng)
    assert len(masks) == 2
    return tuple(torch.from_numpy(np.array(m)) for m in masks)


def _jax_classifier_init(dim, num_group):
    """The JAX CLI's classifier init (keys 5 and 6), as numpy."""
    classifier = JClassifier(cls_dim=40)
    cvars = jax.jit(lambda keys: classifier.init(keys, jnp.zeros((2, num_group, dim)),
                                                 deterministic=False))(
        {"params": jax.random.key(5), "dropout": jax.random.key(6)})
    return classifier, jax.tree.map(np.asarray, cvars)


# a dense bias that a train-mode BatchNorm follows, and the LayerNorm's shift
# that the BatchNorm removes too: exactly zero gradients, rounding noise in both
ZERO_GRADIENT = ("norm.bias", "head.0.bias", "head.4.bias")


class _Features(fnn.Module):
    """Stands in for the student inside the JAX probe step: what it is handed
    as points are the features, computed outside by the jitted encoder."""

    def encode_features(self, x):
        return x


def _eager_probe_step(feat_model, classifier, tx):
    """``gm3d_tpu/train/pretrain.py::make_probe_step`` with its classifier
    part run eagerly; the student's features from its jitted encoder."""
    step = jmake_probe_step(_Features(), classifier, tx)
    encode = _jax_encoder(feat_model)

    def run(probe_state, feat_vars, pts, labels, rng):
        feats = encode(feat_vars, pts)
        with jax.disable_jit():
            return step(probe_state, {}, feats, labels, rng)

    return run


def test_the_probe_step_equals_the_jax_step():
    model, variables = _jax_student()
    classifier, cvars = _jax_classifier_init(48, 16)
    jtx = jbuild_adamw(1e-3)
    jstate = jcreate_train_state(cvars, jtx)
    jstep = _eager_probe_step(model, classifier, jtx)

    student = _port_student().train()
    port_classifier = load_flax_variables(Classifier(dim=48, cls_dim=40), cvars, CLASSIFIER_MAP)
    optimizer = build_adamw(port_classifier.named_parameters(), 1e-3)
    state = create_train_state(port_classifier, optimizer)
    step = make_probe_step(student, port_classifier, optimizer, device="cpu")
    before = {k: v.clone() for k, v in student.state_dict().items()}

    rng = jax.random.key(7)
    for i in range(2):
        pts, labels = _clouds(8, 10 + i, points=128, classes=40)
        labels = (labels * 3 + i) % 40
        rng, key = jax.random.split(rng)
        masks = _jax_dropout_masks(classifier, cvars, 8, 16, 48, key)
        jstate, jm = jstep(jstate, variables, jnp.asarray(pts), jnp.asarray(labels), key)
        state, m = step(state, torch.from_numpy(pts), torch.from_numpy(labels), None,
                        draws={"dropout": masks})
        np.testing.assert_allclose(float(m["loss_cls"]), float(jm["loss_cls"]), rtol=2e-4)
        np.testing.assert_allclose(float(m["acc_cls"]), float(jm["acc_cls"]), rtol=2e-4)
        if i == 0:  # the zero-gradient biases are 0 still: their noise enters later
            _same_classifier(port_classifier, jstate, running_mean_atol=2e-6)
    assert state.step == 2 and port_classifier.training
    _same_classifier(port_classifier, jstate, running_mean_atol=1e-3)
    # the student is only read: no tensor of it moved, and it stays in train mode
    assert student.training
    for key, value in student.state_dict().items():
        assert torch.equal(value, before[key]), key


def _same_classifier(port_classifier, jstate, running_mean_atol):
    want = state_dict_from_flax(jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats}), CLASSIFIER_MAP)
    got = port_classifier.state_dict()
    assert set(want) <= set(got)
    steps = int(jstate.step)
    for key, value in want.items():
        if key in ZERO_GRADIENT:
            # AdamW moves each element by at most about its learning rate a step
            bound = steps * 1e-3 * (1 + 1e-3)
            assert float(value.abs().max()) <= bound and float(got[key].abs().max()) <= bound
            continue
        atol = running_mean_atol if key.endswith("running_mean") else 2e-6
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=2e-4, atol=atol,
                                   err_msg=key)


def test_probe_draws_and_the_default_device():
    gen = torch.Generator().manual_seed(0)
    draws = probe_draws(gen, 512)["dropout"]
    assert len(draws) == 2 and all(d.shape == (512, 256) and d.dtype == torch.bool
                                   for d in draws)
    assert 0.45 < float(draws[0].float().mean()) < 0.55
    assert not torch.equal(draws[0], draws[1])
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    classifier = Classifier(dim=48)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_probe_step(_port_student(), classifier,
                        build_adamw(classifier.named_parameters(), 1e-3))


# ---------------------------------------------------------------------------
# the CLI


BATCH, SAMPLES, EPOCHS = 4, 8, 2
FLAGS = ["--config", "configs/pointmae/config.yaml", "--synthetic", "--batch_size", str(BATCH),
         "--synthetic_samples", str(SAMPLES), "--epochs", str(EPOCHS), "--steps_per_dispatch",
         "1", "--warmup_epochs", "1", "--blr", "0.064", "--val_freq", "1", "--num_devices", "1"]
SVM_TEST_CLOUDS = 64  # make_loaders: max(--synthetic_samples // 4, 64)


def _log(out_dir):
    with open(out_dir / "log.txt") as f:
        return [json.loads(line) for line in f]


class _JaxKeys:
    """The JAX CLI's key sequence for the port's draws: ``rng, key =
    split(rng)`` for each train step (then the step's own split) and once more
    for each probe step (``gm3d_tpu/cli/pretrain.py:668``), whose key gives
    the classifier's dropout masks."""

    def __init__(self, seed, classifier, cvars):
        self.rng = jax.random.key(seed)
        self.classifier, self.cvars = classifier, cvars

    def _next(self):
        self.rng, key = jax.random.split(self.rng)
        return key

    def step_draws(self, generator, batch, num_group):
        r_aug, r_mask, _, _ = jax.random.split(self._next(), 4)
        r_scale, r_shift = jax.random.split(r_aug)
        out = {"scale": jax.random.uniform(r_scale, (batch, 1, 3), minval=2.0 / 3.0,
                                           maxval=3.0 / 2.0),
               "shift": jax.random.uniform(r_shift, (batch, 1, 3), minval=-0.2, maxval=0.2),
               "noise": jax.random.uniform(r_mask, (batch, num_group))}
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}

    def probe_draws(self, generator, batch):
        return {"dropout": _jax_dropout_masks(self.classifier, self.cvars, batch,
                                              SMALL["num_group"], SMALL["trans_dim"],
                                              self._next())}


def test_classification_and_the_svm_probe_equal_the_jax_clis(monkeypatch, tmp_path):
    """``--classification`` under ``none``: the two CLIs' ``loss_cls`` and
    ``acc_cls`` to 2e-4, ``val_svm_acc`` within one test cloud, the train
    metrics to 2e-4, and each CLI's ``ckpt/best`` and ``best_metrics.json``.
    The JAX CLI's probe step runs eagerly, as in the step test above, and the
    student does not train (``--blr 0``): AdamW moves a parameter whose
    gradient is zero in exact arithmetic (the patch embed's convolution
    biases, which a train-mode BatchNorm follows) by up to its learning rate in
    the direction of the rounding noise, which differs between the two
    packages. Train-mode outputs cancel those biases, so the train metrics
    agree (``tests/test_torch_port_pretrain_cli.py``); the probe's eval-mode
    features do not (0.04 of 2.9 after one step of these small models)."""
    import gm3d_tpu.train.pretrain as jpretrain
    from gm3d_tpu.ckpt.checkpoint import latest_step as jlatest_step
    from gm3d_tpu_torch.ckpt.checkpoint import latest_step, load_best_metrics

    monkeypatch.setattr(jpretrain, "make_probe_step", _eager_probe_step)

    flags = ["--learn_feature_loss", "none", "--classification", "--blr", "0"]
    monkeypatch.setattr(jcli, "GM3DStudent", functools.partial(JGM3DStudent, **SMALL))
    monkeypatch.setattr(sys, "argv", ["pretrain", *FLAGS, *flags,
                                      "--output_dir", str(tmp_path / "jax")])
    _reset_gm3d_loggers()
    jcli.main()
    want = _log(tmp_path / "jax")

    # the JAX CLI's init: the student with key 1 on its first batch, the classifier 5 and 6
    example = jnp.asarray(next(iter(JDataLoader(JSyntheticClouds(SAMPLES, 1024, seed=1),
                                                BATCH, seed=0))))
    student = JGM3DStudent(mode="usual", **SMALL)
    mask0 = jnp.zeros((2, student.num_group), bool).at[:, :10].set(True)
    assert jgm3d_num_mask(student.num_group, 0.6) == 10
    svars = jax.tree.map(np.asarray, jax.jit(lambda key: student.init(
        key, example[:2], mask0, 10))(jax.random.key(1)))
    classifier, cvars = _jax_classifier_init(SMALL["trans_dim"], SMALL["num_group"])
    keys = _JaxKeys(0, classifier, cvars)
    monkeypatch.setattr(cli, "build_student", lambda args, mode, dtype: load_flax_variables(
        GM3DStudent(mode=mode, **SMALL), svars, GM3D_STUDENT_MAP))
    monkeypatch.setattr(cli, "build_classifier", lambda args, dim, dtype: load_flax_variables(
        Classifier(dim=dim, cls_dim=40), cvars, CLASSIFIER_MAP))
    monkeypatch.setattr(cli, "step_draws", keys.step_draws)
    monkeypatch.setattr(cli, "probe_draws", keys.probe_draws)
    _reset_gm3d_loggers()
    got = cli.main([*FLAGS, *flags, "--device", "cpu", "--output_dir", str(tmp_path / "port")])
    assert got == _log(tmp_path / "port")
    assert len(got) == len(want) == EPOCHS
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in ("loss", "loss_recon", "loss_chfr", "grad_norm", "loss_cls", "acc_cls"):
            assert math.isfinite(g[key]), key
            np.testing.assert_allclose(g[key], w[key], rtol=2e-4, atol=1e-6,
                                       err_msg=f"epoch {g['epoch']} {key}")
        assert abs(g["val_svm_acc"] - w["val_svm_acc"]) <= 1.0 / SVM_TEST_CLOUDS + 1e-12
    for records, best, best_dir, last in (
            (got, load_best_metrics(str(tmp_path / "port" / "ckpt")),
             latest_step(str(tmp_path / "port" / "ckpt" / "best")), latest_step),
            (want, json.loads((tmp_path / "jax" / "ckpt" / "best_metrics.json").read_text()),
             jlatest_step(str(tmp_path / "jax" / "ckpt" / "best")), jlatest_step)):
        accs = [r["val_svm_acc"] for r in records]
        assert best == {"best": max(accs)}
        # ckpt/best holds one step: that of the first epoch with the best accuracy
        assert best_dir == (accs.index(max(accs)) + 1) * (SAMPLES // BATCH)
    assert "--classification forces" in (tmp_path / "port" / "pretrain.log").read_text()


def _small_models(monkeypatch):
    gen = torch.Generator().manual_seed(0)

    def student(args, mode, dtype):
        model = GM3DStudent(mode=mode, **SMALL)
        model.reset_parameters(gen)
        return model

    monkeypatch.setattr(cli, "build_student", student)


SMALL_RUN = ["--config", "configs/pointmae/config.yaml", "--synthetic", "--learn_feature_loss",
             "ema", "--batch_size", "4", "--synthetic_samples", "8", "--device", "cpu"]


def test_a_resume_never_overwrites_a_better_best(monkeypatch, tmp_path):
    """``tests/test_cli_resume.py``'s protocol for the port's pretrain CLI:
    after a resume the best accuracy comes back from ``best_metrics.json``;
    poisoned with 1.01, no later epoch beats it and ``ckpt/best`` stays."""
    from gm3d_tpu_torch.ckpt.checkpoint import (latest_step, load_best_metrics,
                                                save_best_metrics)

    _small_models(monkeypatch)
    out = tmp_path / "run"
    records = cli.main([*SMALL_RUN, "--epochs", "2", "--output_dir", str(out)])
    ck = str(out / "ckpt")
    accs = [r["val_svm_acc"] for r in records]
    assert load_best_metrics(ck) == {"best": max(accs)} and max(accs) > 0.0
    best_step = latest_step(str(out / "ckpt" / "best"))
    assert best_step == (accs.index(max(accs)) + 1) * 2

    save_best_metrics(ck, {"best": 1.01})
    _reset_gm3d_loggers()
    again = cli.main([*SMALL_RUN, "--epochs", "4", "--resume", "--output_dir", str(out)])
    assert [r["epoch"] for r in again] == [2, 3] and all("val_svm_acc" in r for r in again)
    assert "(best svm 1.0100)" in (out / "pretrain.log").read_text()
    assert load_best_metrics(ck) == {"best": 1.01}
    assert latest_step(str(out / "ckpt" / "best")) == best_step


def test_sigterm_joins_a_running_background_probe_and_writes_its_record(monkeypatch, tmp_path):
    """``tests/test_cli_preempt.py``'s protocol: the guard fires in epoch 1
    while epoch 0's probe (slowed) still runs in the background; the save at
    the signal joins it first, and epoch 0's record is written with its
    accuracy."""
    from gm3d_tpu_torch.utils.preempt import PreemptionGuard

    def slow_probe(*args, **kwargs):
        time.sleep(2.0)
        return 0.5

    calls = {"n": 0}
    orig = PreemptionGuard.exit_if_triggered

    def fire_in_epoch_1(self, save_fn):
        calls["n"] += 1
        if calls["n"] == 4:  # 3 polls in epoch 0: two steps and its end
            self.triggered = True
        return orig(self, save_fn)

    _small_models(monkeypatch)
    monkeypatch.setattr(cli, "svm_probe", slow_probe)
    monkeypatch.setattr(PreemptionGuard, "exit_if_triggered", fire_in_epoch_1)
    out = tmp_path / "run"
    with pytest.raises(SystemExit) as e:
        cli.main([*SMALL_RUN, "--epochs", "3", "--output_dir", str(out)])
    assert e.value.code == 0
    rows = _log(out)
    assert [(r["epoch"], r["val_svm_acc"]) for r in rows] == [(0, 0.5)]
    assert not [t for t in threading.enumerate() if t.name == "gm3d-svm-probe"]


def test_the_background_probe_sees_its_epochs_weights(monkeypatch, tmp_path):
    """The probe thread reads a copy of the state made at its epoch's end:
    while it waits, the next epoch trains the live student, and what it then
    reads still equals the epoch's rolling checkpoint."""
    from gm3d_tpu_torch.ckpt.checkpoint import restore_raw

    seen = {}

    def recording_probe(model, *args, **kwargs):
        time.sleep(1.5)  # the next epoch trains meanwhile
        seen.setdefault("state", {k: v.clone() for k, v in model.state_dict().items()})
        return 0.25

    _small_models(monkeypatch)
    monkeypatch.setattr(cli, "svm_probe", recording_probe)
    out = tmp_path / "run"
    records = cli.main([*SMALL_RUN, "--epochs", "2", "--output_dir", str(out)])
    assert [r["val_svm_acc"] for r in records] == [0.25, 0.25]
    saved = restore_raw(str(out / "ckpt"), 2)["model"]
    assert sorted(seen["state"]) == sorted(saved)
    for key, value in saved.items():
        assert torch.equal(seen["state"][key], value), key
    final = restore_raw(str(out / "ckpt"), 4)["model"]
    assert any(not torch.equal(final[k], saved[k]) for k in saved)


def test_launch_counts_are_exact_under_threads():
    """The probe thread and the training loop count kernel launches at once:
    no increment may be lost."""
    def counted():
        pass

    counted.launches = 0
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(counted)
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert counted.launches == 16 * 2000
