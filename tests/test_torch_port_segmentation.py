"""The port's part segmentation against the JAX package's (CPU).

Each piece of ``gm3d_tpu_torch``'s segmentation path against its JAX
counterpart on the same numpy inputs, with the same weights carried across
by ``state_dict_from_flax`` and ``ckpt/torch_import.py::POINT_MAE_SEG_MAP``:

  - ``propagate_features``, with the gap at the points that are themselves
    centers reported apart from the rest (see
    ``test_propagate_features_equals_the_jax_function``);
  - ``PointMAESeg`` in eval mode (logits to 2e-5) and in train mode (the JAX
    forward's dropout keep mask recorded and handed over; logits and the
    updated BatchNorm statistics to 2e-5);
  - ``part_miou`` and ``category_restricted_argmax``, equal;
  - the seg train step over 3 steps (metrics to ``rtol=2e-4``, parameters
    and BatchNorm statistics to 5e-5, plain SGD on both sides as in
    ``tests/test_torch_port_finetune.py``, with the same reason);
  - the pretrain -> seg transfer from a GM3D and a Point-MAE checkpoint:
    weights equal, matched / missing / unexpected sets equal to the JAX
    overlay's with ``flatten=("blocks",)``;
  - the two seg CLIs for two epochs (epoch means to ``rtol=2e-4``,
    ``instance_miou`` and ``class_miou`` to 0.05 percentage points);
  - ``ShapeNetPart`` item for item on tiny files the test writes;
  - a seg export of the CLI's ``ckpt/best`` served equal to the eval step,
    and the refusals of the export and the server.

Small models only (width 32, depth 4 with taps after blocks 1 and 3,
256-point clouds).
"""

import importlib
import json
import math
import re
import sys
import threading
import urllib.error
import urllib.request
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from _torch_threads import torch_at_one_thread  # noqa: F401
from cli_harness import _reset_gm3d_loggers

import gm3d_tpu.cli.finetune_seg as jcli
import gm3d_tpu.utils.logging as jlogging
from gm3d_tpu.ckpt.transfer import TransferReport as JTransferReport
from gm3d_tpu.ckpt.transfer import overlay_pretrained as joverlay
from gm3d_tpu.data import datasets as jdatasets
from gm3d_tpu.eval.metrics import part_miou as jpart_miou
from gm3d_tpu.models import GM3DStudent as JGM3DStudent
from gm3d_tpu.models import PointMAE as JPointMAE
from gm3d_tpu.models.segmentation import PointMAESeg as JPointMAESeg
from gm3d_tpu.models.segmentation import propagate_features as jpropagate
from gm3d_tpu.train import segmentation as jseg
from gm3d_tpu.train.state import create_train_state as jcreate_state
from gm3d_tpu_torch.ckpt import transfer
from gm3d_tpu_torch.ckpt.checkpoint import all_steps, load_best_metrics, restore_raw, save_checkpoint
from gm3d_tpu_torch.ckpt.torch_import import (
    GM3D_STUDENT_MAP,
    POINT_MAE_MAP,
    POINT_MAE_SEG_MAP,
    load_flax_variables,
    state_dict_from_flax,
)
from gm3d_tpu_torch.cli import export_model
from gm3d_tpu_torch.cli import finetune_seg as cli
from gm3d_tpu_torch.config import build_model_from_cfg
from gm3d_tpu_torch.data import datasets
from gm3d_tpu_torch.eval.metrics import part_miou
from gm3d_tpu_torch.models import GM3DStudent, PointMAE, PointMAESeg
from gm3d_tpu_torch.models.segmentation import propagate_features
from gm3d_tpu_torch.ops.knn import knn_indices
from gm3d_tpu_torch.serve import (ServingModel, build_seg_fn, export_forward, load_artifact,
                                  save_artifact)
from gm3d_tpu_torch.serve.server import make_server
from gm3d_tpu_torch.train import segmentation as seg
from gm3d_tpu_torch.train.state import create_train_state

SMALL = dict(trans_dim=32, depth=4, num_heads=2, group_size=8, num_group=16, encoder_dims=32,
             drop_path_rate=0.0, feature_blocks=(1, 3))
JSMALL = dict(SMALL)
B, N = 4, 256
CLS_NAMES = sorted(datasets.SEG_CLASSES)


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


def _variables(seed, **kw):
    """Numpy variables in the tree ``PointMAESeg.init`` gives: weights noise
    of the init's scale, biases, norm scales and running statistics
    non-trivial."""
    rng = np.random.default_rng(seed)
    jmodel = JPointMAESeg(**{**JSMALL, **kw})
    shapes = jax.eval_shape(lambda key: jmodel.init(key, jnp.zeros((2, N, 3)),
                                                    jnp.zeros((2,), jnp.int32)),
                            jax.random.key(0))

    def leaf(path, s):
        noise = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "var":
            return 1.0 + 0.5 * np.abs(noise)
        if name == "kernel":
            return noise / np.sqrt(s.shape[0])
        return (1.0 if name == "scale" else 0.0) + 0.1 * noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _port_model(variables, **kw):
    return load_flax_variables(PointMAESeg(**{**SMALL, **kw}), variables, POINT_MAE_SEG_MAP)


def _clouds(seed, b=B, n=N):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(np.float32) * 0.5


def _labels(seed, b=B, n=N):
    """Categories (b,) and, for each cloud, part labels of its category."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 16, b)
    parts = [np.asarray(datasets.SEG_CLASSES[CLS_NAMES[c]]) for c in cls]
    return cls, np.stack([p[rng.integers(0, len(p), n)] for p in parts])


# ---------------------------------------------------------------------------
# the model


def test_propagate_features_equals_the_jax_function():
    """Every center is a point of the cloud (as FPS centers are), so 32 of
    the 256 queries of each cloud sit on a reference. There the squared
    distance ``q2 - 2 q.r + r2`` is exactly 0 in the port (its plain version
    and the kernel sum the cross term x, y, z in the order of the squares,
    so it equals q2 bit for bit), and a rounding residue of up to about
    2.4e-7 in the JAX function (an ``einsum``), 0 or negative for most of
    those points and so floored at 1e-10: weights ``1 / max(d, 1e-10)`` that
    differ by orders, while the normalised weight of the point's own center
    stays 1 - O(residue / d2), d2 the squared distance to the next center.
    Elsewhere the same absolute rounding of d (about 1e-7) moves a weight by
    about 1e-7 / d1, largest for a point next to a center. With
    standard-normal features (spread about 3) and d down to 1e-3 on these
    clouds, both gaps are of order 1e-5: the test allows 5e-5 at the
    coincident points and 2e-5 elsewhere (measured: 2.4e-5 and 9.1e-6), and
    reports the two apart. The distance formula is the JAX package's and is
    kept."""
    rng = np.random.default_rng(0)
    pts = _clouds(1)
    center_idx = np.stack([rng.choice(N, 32, replace=False) for _ in range(B)])
    centers = np.take_along_axis(pts, center_idx[..., None], axis=1)
    feats = rng.standard_normal((B, 32, 24)).astype(np.float32)
    want = np.asarray(jpropagate(jnp.asarray(pts), jnp.asarray(centers), jnp.asarray(feats)))
    got = propagate_features(torch.from_numpy(pts), torch.from_numpy(centers),
                             torch.from_numpy(feats)).numpy()
    on_center = np.zeros((B, N), bool)
    np.put_along_axis(on_center, center_idx, True, axis=1)
    gap = np.abs(got - want).max(-1)
    gap_on, gap_off = float(gap[on_center].max()), float(gap[~on_center].max())
    print(f"propagated gap: {gap_on:.3g} at the {int(on_center.sum())} coincident points, "
          f"{gap_off:.3g} at the other {int((~on_center).sum())}")
    assert gap_on <= 5e-5 and gap_off <= 2e-5
    # the port's distance of a center to itself is exactly 0, so the point's
    # own center's features come through
    dist, _ = knn_indices(torch.from_numpy(centers), torch.from_numpy(pts), 3, return_dist=True)
    assert torch.all(dist[..., 0][torch.from_numpy(on_center)] == 0)
    for b in range(B):
        for j, i in enumerate(center_idx[b]):
            np.testing.assert_allclose(got[b, i], feats[b, j], rtol=0, atol=5e-5)


def test_eval_forward_equals_the_jax_forward():
    variables = _variables(1)
    pts, (cls, _) = _clouds(2), _labels(3)
    want = JPointMAESeg(**JSMALL).apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(pts),
                                        jnp.asarray(cls))
    model = _port_model(variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(pts), torch.from_numpy(cls))
    assert got.shape == (B, N, 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    # the JAX module's declared-but-unused final LayerNorm has no parameters:
    # neither has the port's, and the map covers every key both ways
    assert not [k for k in model.state_dict() if k.startswith("norm")]
    assert "norm" not in variables["params"]


def _recording_bernoulli(recorded: dict):
    """``jax.random.bernoulli`` that also hands each mask it draws to the host,
    as ``recorded[i]`` for the i-th call made while tracing."""
    bernoulli = jax.random.bernoulli
    calls = [0]

    def draw(*args, **kwargs):
        mask, i = bernoulli(*args, **kwargs), calls[0]
        calls[0] += 1
        jax.debug.callback(lambda m, i=i: recorded.__setitem__(i, np.asarray(m)), mask)
        return mask

    return draw


def test_train_forward_equals_the_jax_forward(monkeypatch):
    """Train mode: batch statistics, the head's dropout (its keep mask
    recorded from the JAX forward), stochastic depth 0 on both sides."""
    variables = _variables(4)
    pts, (cls, _) = _clouds(5), _labels(6)
    recorded = {}
    monkeypatch.setattr(jax.random, "bernoulli", _recording_bernoulli(recorded))
    want, updates = JPointMAESeg(**JSMALL).apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(pts), jnp.asarray(cls),
        deterministic=False, rngs={"dropout": jax.random.key(7), "droppath": jax.random.key(8)},
        mutable=["batch_stats"])
    jax.effects_barrier()
    assert sorted(recorded) == [0] and recorded[0].shape == (B, N, 512)
    model = _port_model(variables).train()
    got = model(torch.from_numpy(pts), torch.from_numpy(cls),
                torch.from_numpy(recorded[0].copy()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=2e-5)
    want_sd = state_dict_from_flax({"batch_stats": jax.tree.map(np.asarray, updates["batch_stats"])},
                                   POINT_MAE_SEG_MAP)
    got_sd = model.state_dict()
    for name, w in want_sd.items():
        np.testing.assert_allclose(got_sd[name].numpy(), w.numpy(), rtol=0, atol=2e-5,
                                   err_msg=name)
    # without a mask the module draws its own: about half the units dropped
    torch.manual_seed(0)
    other = model(torch.from_numpy(pts), torch.from_numpy(cls))
    assert not torch.allclose(other, got)


def test_part_miou_and_the_restricted_argmax_equal_the_jax_functions():
    rng = np.random.default_rng(9)
    cls, target = _labels(10, b=24, n=64)
    logits = rng.standard_normal((24, 64, 50)).astype(np.float32)
    pred = seg.category_restricted_argmax(logits, cls, datasets.SEG_CLASSES, CLS_NAMES)
    jpred = jseg.category_restricted_argmax(logits, cls, jdatasets.SEG_CLASSES, CLS_NAMES)
    assert pred.dtype == np.int64 and np.array_equal(pred, jpred)
    for c, row in zip(cls, pred):  # only the category's own parts
        assert set(row) <= set(datasets.SEG_CLASSES[CLS_NAMES[c]])
    pred[:6] = target[:6]  # some shapes exactly right
    got = part_miou(pred, target, cls, datasets.SEG_CLASSES, CLS_NAMES)
    want = jpart_miou(pred, target, cls, jdatasets.SEG_CLASSES, CLS_NAMES)
    assert got == want and 0.0 < got["instance_miou"] < 1.0
    assert datasets.SEG_CLASSES == jdatasets.SEG_CLASSES


def test_the_registry_builds_the_seg_model_and_refuses_m2ae():
    cfg = yaml.safe_load(open("configs/pointmae/seg_shapenetpart.yaml"))["model"]
    model = build_model_from_cfg(cfg)
    assert isinstance(model, PointMAESeg) and model.feature_blocks == (3, 7, 11)
    assert model.num_parts == 50 and model.head_fc1.in_features == 512 + 6 * 384 + 64 + 3
    # 12 blocks of 11 tensors, named as PointTransformer names them
    assert len([k for k in model.state_dict() if k.startswith("blocks.blocks.")]) == 12 * 11
    # the Point-M2AE seg model is built now (held against JAX in
    # tests/test_torch_port_m2ae.py); the head is PointMAESeg's over 3 scales
    m2ae = build_model_from_cfg(
        yaml.safe_load(open("configs/m2ae/seg_shapenetpart_PointM2AE.yaml"))["model"])
    assert type(m2ae).__name__ == "PointM2AESeg" and m2ae.num_parts == 50
    assert m2ae.head_fc1.in_features == 512 + 2 * (96 + 192 + 384) + 64 + 3


# ---------------------------------------------------------------------------
# the steps


def _load_jax_state(model, jstate):
    load_flax_variables(model, jax.tree.map(np.asarray, jstate.variables()), POINT_MAE_SEG_MAP)


def test_train_step_equals_the_jax_step_over_three_steps(monkeypatch):
    """Three steps, each from the JAX state the step before left: metrics to
    ``rtol=2e-4``, then parameters and BatchNorm statistics to 5e-5. The
    head's dropout is 0.5: its keep mask is recorded from the JAX step and
    handed to the port with the scale and shift of the step's key."""
    variables = _variables(11)
    tx = optax.sgd(1e-2)
    jstate = jcreate_state(jax.tree.map(jnp.asarray, variables), tx)
    recorded = {}
    monkeypatch.setattr(jax.random, "bernoulli", _recording_bernoulli(recorded))
    jstep = jseg.make_seg_train_step(JPointMAESeg(**JSMALL), tx)
    model = _port_model(variables)
    optimizer = torch.optim.SGD(model.parameters(), lr=1e-2)
    state = create_train_state(model, optimizer)
    step = seg.make_seg_train_step(model, optimizer, device="cpu")
    for i in range(3):
        pts, (cls, target) = _clouds(20 + i), _labels(30 + i)
        key = jax.random.key(i)
        _load_jax_state(model, jstate)
        recorded.clear()
        jstate, jm = jstep(jstate, jnp.asarray(pts), jnp.asarray(cls), jnp.asarray(target), key)
        jax.effects_barrier()
        assert sorted(recorded) == [0] and recorded[0].shape == (B, N, 512)
        r_aug, _, _ = jax.random.split(key, 3)
        r_scale, r_shift = jax.random.split(r_aug)
        draws = {"scale": torch.from_numpy(np.array(jax.random.uniform(
                     r_scale, (B, 1, 3), minval=2.0 / 3.0, maxval=3.0 / 2.0))),
                 "shift": torch.from_numpy(np.array(jax.random.uniform(
                     r_shift, (B, 1, 3), minval=-0.2, maxval=0.2))),
                 "dropout": torch.from_numpy(recorded[0].copy())}
        state, m = step(state, torch.from_numpy(pts), torch.from_numpy(cls),
                        torch.from_numpy(target), None, draws=draws)
        assert sorted(m) == sorted(jm) == sorted(seg.METRIC_KEYS)
        for k in seg.METRIC_KEYS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-4,
                                       err_msg=f"step {i} {k}")
        want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.variables()),
                                    POINT_MAE_SEG_MAP)
        got = model.state_dict()
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=5e-5,
                                       err_msg=f"step {i} {name}")
    assert state.step == 3


def test_eval_step_multi_step_and_draws():
    """The eval step equals the JAX eval step and puts the model's mode back;
    the multi-step loop is its steps in order; a step without draws takes
    them from its generator (``seg_draws``)."""
    variables = _variables(12)
    pts, (cls, target) = _clouds(13), _labels(14)
    want = jseg.make_seg_eval_step(JPointMAESeg(**JSMALL))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(pts), jnp.asarray(cls))
    model = _port_model(variables).train()
    got = seg.make_seg_eval_step(model, device="cpu")(torch.from_numpy(pts),
                                                      torch.from_numpy(cls))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    assert model.training
    runs = []
    for mode in ("single", "multi", "explicit draws"):
        model = _port_model(variables)
        optimizer = torch.optim.SGD(model.parameters(), lr=1e-2)
        state = create_train_state(model, optimizer)
        step = seg.make_seg_train_step(model, optimizer, device="cpu")
        gen = torch.Generator().manual_seed(3)
        p2 = torch.from_numpy(np.stack([pts, _clouds(15)]))
        c2 = torch.from_numpy(np.stack([cls, cls]))
        s2 = torch.from_numpy(np.stack([target, target]))
        if mode == "multi":
            _, m = seg.make_seg_multi_step(step)(state, p2, c2, s2, gen)
        else:
            ms = []
            for k in range(2):
                draws = (seg.seg_draws(gen, model, B, N) if mode == "explicit draws"
                         else None)
                ms.append(step(state, p2[k], c2[k], s2[k], gen, draws=draws)[1])
            m = {n: torch.stack([x[n] for x in ms]) for n in ms[0]}
        runs.append(m)
        assert state.step == 2
    for n in seg.METRIC_KEYS:
        assert runs[0][n].shape == (2,)
        assert torch.equal(runs[0][n], runs[1][n]) and torch.equal(runs[0][n], runs[2][n])


# ---------------------------------------------------------------------------
# transfer

PRE = dict(trans_dim=32, depth=4, num_heads=2, group_size=8, num_group=16, encoder_dims=32,
           decoder_depth=1, decoder_num_heads=2, drop_path_rate=0.0)


def _noise_variables(jmodel, seed, *example):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda key: jmodel.init(key, *example), jax.random.key(0))
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _flax_path(key, tables):
    """The JAX package's report path of a torch key, through the first name map
    of ``tables`` that knows it (a stripped pretrain key is looked up under
    ``MAE_encoder.`` too); a pretrain block lands at the root, as the JAX
    overlay's ``flatten=("blocks",)`` puts it."""
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
                if candidate != module:
                    path = path[len("MAE_encoder/"):]
                path = re.sub(r"^blocks/", "", path)
                if leaf in ("running_mean", "running_var"):
                    return f"batch_stats/{path}/{leaf[len('running_'):]}"
                name = {"weight": "kernel" if kind in ("linear", "conv") else "scale",
                        "bias": "bias"}[leaf]
                return f"params/{path}/{name}"
    raise KeyError(key)


@pytest.mark.parametrize("family", ["gm3d", "pointmae"])
def test_transfer_equals_the_jax_overlay_with_flattened_blocks(family, tmp_path):
    pts, mask = jnp.zeros((2, 64, 3)), jnp.zeros((2, 16), bool).at[:, :10].set(True)
    if family == "gm3d":
        jsrc, src_model, src_map = JGM3DStudent(mode="feature", **PRE), \
            GM3DStudent(mode="feature", **PRE), GM3D_STUDENT_MAP
    else:
        jsrc, src_model, src_map = JPointMAE(**PRE), PointMAE(**PRE), POINT_MAE_MAP
    src_vars = _noise_variables(jsrc, 0, pts, mask, 10)
    load_flax_variables(src_model, src_vars, src_map)
    save_checkpoint(str(tmp_path / "ckpt"), {"step": 3, "model": src_model.state_dict(),
                                             "ema": None, "optimizer": None}, 3)
    dst_vars = _variables(1)
    model = _port_model(dst_vars)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n, report = transfer.load_pretrained_into(model, str(tmp_path / "ckpt"))

    jreport = JTransferReport()
    params, batch_stats, jn = joverlay(dst_vars["params"], dst_vars["batch_stats"],
                                       src_vars["params"], src_vars["batch_stats"],
                                       flatten=("blocks",), report=jreport)
    want = _port_model({"params": jax.tree.map(np.asarray, params),
                        "batch_stats": jax.tree.map(np.asarray, batch_stats)})
    got = model.state_dict()
    for key, value in want.state_dict().items():
        if key.endswith("num_batches_tracked"):
            assert torch.equal(got[key], before[key]), key
        else:
            assert torch.equal(got[key], value), key
    # the patch embed's 12 parameters and 4 BatchNorm statistics, the
    # positional embedding's 4, and 4 blocks of 11
    assert n == jn == len(report.matched) == len(jreport.matched) == 16 + 4 + 4 * 11
    assert sorted(_flax_path(k, [POINT_MAE_SEG_MAP]) for k in report.matched) == sorted(
        jreport.matched)
    assert sorted(_flax_path(k, [POINT_MAE_SEG_MAP]) for k in report.missing) == sorted(
        jreport.missing)
    # One difference of naming, none of weights: the GM3D student's feature
    # head is ``head_fc1`` / ``head_fc2`` in its flax tree, the names of the seg
    # head's layers, so the JAX overlay lists those four leaves as shape
    # mismatches (1024 against 512 wide; never transferred); under the torch
    # names (``increase_dim_2.*``) nothing collides and the port lists them as
    # unexpected.
    collided = [p for p, _, _ in jreport.shape_mismatch]
    assert sorted(collided) == ([] if family == "pointmae" else sorted(
        f"params/{m}/{leaf}" for m in ("head_fc1", "head_fc2") for leaf in ("bias", "kernel")))
    assert sorted(_flax_path(k, [src_map]) for k in report.unexpected) == sorted(
        jreport.unexpected + collided)
    assert not report.shape_mismatch
    # the head is left at its init; the checkpoint's final LayerNorm has no
    # place in the seg model
    assert all(k.startswith(("label_embed", "prop_proj", "head_")) for k in report.missing)
    norm = "norm_p" if family == "gm3d" else "norm"
    assert {f"{norm}.weight", f"{norm}.bias"} <= set(report.unexpected)


# ---------------------------------------------------------------------------
# the two CLIs

BATCH, SAMPLES, EPOCHS = 4, 16, 2
VAL_CLOUDS = 32  # SyntheticParts: max(--synthetic_samples // 4, 32)
SMALL_SEG = dict(JSMALL, dropout_rate=0.0)
# AdamW at 2e-5, as the finetune CLI comparison: at the config's 2e-4 the
# first updates of these small models are lr * sign(g) of rounding-noise
# gradients, and the two packages part (tests/test_torch_port_finetune_cli.py)
LR_RUN = 2e-5


def _seg_config(tmp_path, lr=LR_RUN):
    cfg = yaml.safe_load(open("configs/pointmae/seg_shapenetpart.yaml"))
    cfg["optimizer"]["kwargs"]["lr"] = lr
    cfg["model"].update({k: list(v) if isinstance(v, tuple) else v for k, v in SMALL.items()})
    cfg["npoints"] = N
    path = tmp_path / "tiny_seg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


FLAGS = ["--synthetic", "--batch_size", str(BATCH), "--synthetic_samples", str(SAMPLES),
         "--epochs", str(EPOCHS), "--num_workers", "0", "--steps_per_dispatch", "2",
         "--num_devices", "1"]


class _Scalars:
    """A ``ScalarWriter`` that keeps what it is given."""

    seen: dict = {}

    def __init__(self, log_dir):
        _Scalars.seen[log_dir] = self.values = []

    def add_scalar(self, tag, value, step):
        self.values.append((tag, step, float(value)))

    def flush(self):
        pass

    def close(self):
        pass


def _initial_variables():
    """What the JAX CLI's ``init`` gives the small model (key ``--seed`` 0,
    its first validation batch)."""
    loader = jdatasets.DataLoader(jcli.SyntheticParts(VAL_CLOUDS, N, seed=2), BATCH,
                                  shuffle=False, drop_last=False)
    pts, cls, _ = next(iter(loader))
    init = jax.jit(JPointMAESeg(**SMALL_SEG).init)
    return jax.tree.map(np.asarray, init(jax.random.key(0), jnp.asarray(pts[:2]),
                                         jnp.asarray(cls[:2])))


def _jax_draws(seed):
    """The port's ``seg_draws`` from the JAX CLI's key sequence: a step's
    ``rng, key = split(rng)``, then the step's ``split(key, 3)``."""
    box = {"rng": jax.random.key(seed)}

    def draws(generator, model, batch, num_points):
        box["rng"], key = jax.random.split(box["rng"])
        r_aug, _, _ = jax.random.split(key, 3)
        r_scale, r_shift = jax.random.split(r_aug)
        return {"scale": torch.from_numpy(np.array(jax.random.uniform(
                    r_scale, (batch, 1, 3), minval=2.0 / 3.0, maxval=3.0 / 2.0))),
                "shift": torch.from_numpy(np.array(jax.random.uniform(
                    r_shift, (batch, 1, 3), minval=-0.2, maxval=0.2))),
                "dropout": torch.ones((batch, num_points, 512), dtype=torch.bool)}

    return draws


def _log(out_dir):
    with open(out_dir / "log.txt") as f:
        return [json.loads(line) for line in f]


def test_the_two_seg_clis_agree(monkeypatch, tmp_path):
    config = _seg_config(tmp_path)
    # the JAX CLI
    importlib.reload(jcli)
    monkeypatch.setattr(jcli, "build_model_from_cfg",
                        lambda cfg, dtype: JPointMAESeg(**SMALL_SEG, dtype=dtype))
    monkeypatch.setattr(jlogging, "ScalarWriter", _Scalars)
    monkeypatch.setattr(sys, "argv", ["finetune_seg", "--config", config, *FLAGS,
                                      "--output_dir", str(tmp_path / "jax")])
    _reset_gm3d_loggers()
    jbest = jcli.main()
    want = _log(tmp_path / "jax")
    # the port's, from the JAX CLI's initialisation and key sequence
    variables = _initial_variables()
    monkeypatch.setattr(cli, "build_model", lambda args, cfg, dtype: load_flax_variables(
        PointMAESeg(**SMALL, dropout=0.0), variables, POINT_MAE_SEG_MAP))
    monkeypatch.setattr(cli, "ScalarWriter", _Scalars)
    monkeypatch.setattr(seg, "seg_draws", _jax_draws(0))
    _reset_gm3d_loggers()
    got = cli.main(["--config", config, *FLAGS, "--device", "cpu",
                    "--output_dir", str(tmp_path / "port")])
    assert got == _log(tmp_path / "port") and len(got) == len(want) == EPOCHS
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and g["epoch"] == w["epoch"]
        for key in seg.METRIC_KEYS:
            assert math.isfinite(g[key])
            np.testing.assert_allclose(g[key], w[key], rtol=2e-4, err_msg=f"{g['epoch']} {key}")
        # mIoU counts arg-maxes: a point whose two largest allowed logits lie
        # closer than the runs' logit gap may flip, which moves one shape's
        # IoU by about 1 / 256 of a part's; 0.05 percentage points is a few
        # such points among the 8,192 of the 32 validation clouds
        for key in ("instance_miou", "class_miou"):
            print(f"epoch {g['epoch']} {key}: port {g[key]:.6f}, jax {w[key]:.6f}")
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=0.05,
                                       err_msg=f"{g['epoch']} {key}")
    # the TensorBoard scalars: tags and epochs equal, the rates to 1e-6
    jtb = _Scalars.seen[str(tmp_path / "jax" / "tfboard")]
    ptb = _Scalars.seen[str(tmp_path / "port" / "tfboard")]
    assert [t[:2] for t in ptb] == [t[:2] for t in jtb]
    assert {t[0] for t in ptb} == {"loss", "lr", "Metric/mIoU_I", "Metric/mIoU_C"}
    np.testing.assert_allclose([t[2] for t in ptb if t[0] == "lr"],
                               [t[2] for t in jtb if t[0] == "lr"], rtol=1e-6)
    # ckpt/best at the best epoch, best_metrics.json as the JAX CLI writes it
    mious = [r["instance_miou"] for r in got]
    best_step = (mious.index(max(mious)) + 1) * (SAMPLES // BATCH)
    assert all_steps(str(tmp_path / "port" / "ckpt" / "best")) == [best_step]
    bm = load_best_metrics(str(tmp_path / "port" / "ckpt"))
    assert bm["instance_miou"] == pytest.approx(max(mious) / 100, abs=1e-12)
    assert bm["instance_miou"] == pytest.approx(jbest["instance_miou"], abs=5e-4)
    assert "best inst mIoU" in (tmp_path / "port" / "seg.log").read_text()


def test_the_seg_cli_resumes_and_refuses_what_is_not_ported(monkeypatch, tmp_path):
    """Two epochs in one run, or one and then ``--resume`` for the second,
    end with the same weights (the draws depend on the step only);
    ``--native_loader`` on ``--synthetic`` clouds trains through the Python
    loader, as the JAX CLI does (the C++ loader reads on-disk ``.npy`` caches:
    ``tests/test_torch_port_native_loader.py``); ``--num_devices`` other than
    the world size raises, naming ``torchrun``."""
    config = _seg_config(tmp_path, lr=1e-3)
    flags = ["--config", config, "--synthetic", "--synthetic_samples", "8", "--batch_size",
             "4", "--steps_per_dispatch", "1", "--num_workers", "0", "--device", "cpu",
             "--sync_save"]
    draws = seg.seg_draws

    def step_keyed(start):
        counter = {"step": start}

        def fn(generator, model, batch, num_points):
            counter["step"] += 1
            return draws(torch.Generator().manual_seed(counter["step"]), model, batch,
                         num_points)

        monkeypatch.setattr(seg, "seg_draws", fn)

    step_keyed(0)
    whole = cli.main([*flags, "--epochs", "2", "--output_dir", str(tmp_path / "whole")])
    step_keyed(0)
    _reset_gm3d_loggers()
    first = cli.main([*flags, "--epochs", "1", "--output_dir", str(tmp_path / "split")])
    step_keyed(2)
    _reset_gm3d_loggers()
    resumed = cli.main([*flags, "--epochs", "2", "--resume",
                        "--output_dir", str(tmp_path / "split")])
    assert "resumed from step 2" in (tmp_path / "split" / "seg.log").read_text()
    assert [r["epoch"] for r in resumed] == [1]
    assert resumed[0]["instance_miou"] == whole[1]["instance_miou"]
    a, b = restore_raw(str(tmp_path / "whole" / "ckpt")), restore_raw(str(tmp_path / "split" / "ckpt"))
    assert a["step"] == b["step"] == 4
    for key, value in a["model"].items():
        assert torch.equal(value, b["model"][key]), key
    step_keyed(0)
    _reset_gm3d_loggers()
    native = cli.main([*flags, "--native_loader", "--epochs", "1",
                       "--output_dir", str(tmp_path / "native")])
    for key in ("loss", "acc", "instance_miou", "class_miou"):
        assert native[0][key] == first[0][key], key
    with pytest.raises(ValueError, match="torchrun"):
        cli.main([*flags, "--num_devices", "2", "--output_dir", str(tmp_path / "refused")])


# ---------------------------------------------------------------------------
# the ShapeNetPart reader


def _shapenetpart_dir(root):
    rng = np.random.default_rng(16)
    cats = {"Airplane": "02691156", "Chair": "03001627", "Mug": "03797390"}
    (root / "train_test_split").mkdir(parents=True)
    (root / "synsetoffset2category.txt").write_text(
        "".join(f"{name}\t{syn}\n" for name, syn in cats.items()))
    lists = {"train": [], "test": []}
    for i, (name, syn) in enumerate(sorted(cats.items()) * 2):
        (root / syn).mkdir(exist_ok=True)
        rows = 40 + 7 * i
        parts = np.asarray(datasets.SEG_CLASSES[name])
        data = np.concatenate([rng.standard_normal((rows, 6)) * 2.0 + i,
                               parts[rng.integers(0, len(parts), rows)][:, None]], axis=1)
        np.savetxt(root / syn / f"shape{i}.txt", data)
        lists["train" if i < 4 else "test"].append(f"shape_data/{syn}/shape{i}")
    for split, items in lists.items():
        (root / "train_test_split" / f"shuffled_{split}_file_list.json").write_text(
            json.dumps(items))
    return root


@pytest.mark.parametrize("normals", [False, True])
def test_shapenetpart_reader_equals_the_jax_reader(normals, tmp_path):
    root = _shapenetpart_dir(tmp_path / "shapenetpart")
    for subset, n in (("train", 4), ("test", 2)):
        cfg = {"_base_": {"NAME": "ShapeNetPart", "DATA_PATH": str(root),
                          "USE_NORMALS": normals},
               "others": {"subset": subset, "npoints": 64}}
        got, want = datasets.build_dataset_from_cfg(cfg), jdatasets.build_dataset_from_cfg(cfg)
        assert type(got).__name__ == "ShapeNetPart" and len(got) == len(want) == n
        assert got.cls_names == want.cls_names and got.files == want.files
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            for i in range(n):
                g, w = got[i], want[i]
                assert g[:2] == w[:2] and g[2][1] == w[2][1]
                assert g[2][0].shape == (64, 6 if normals else 3)
                assert np.array_equal(g[2][0], w[2][0]) and np.array_equal(g[2][2], w[2][2])
        got.set_epoch(0)
        first = got[0][2][0]
        got.set_epoch(1)  # each epoch draws its points anew
        assert not np.array_equal(first, got[0][2][0])
    # the first read wrote the caches; an empty item names its file
    assert len(list(root.rglob("*.txt.npy"))) == 6
    bad = root / "03001627" / "shape1.txt"
    bad.write_text("")
    (root / "03001627" / "shape1.txt.npy").unlink()
    cfg = {"_base_": {"NAME": "ShapeNetPart", "DATA_PATH": str(root)},
           "others": {"subset": "train", "npoints": 64}}
    reader = datasets.build_dataset_from_cfg(cfg)
    idx = [p for _, p in reader.files].index(str(bad))
    with pytest.raises(ValueError, match="shape1.txt"):
        reader[idx]
    assert not (root / "03001627" / "shape1.txt.npy").exists()


# ---------------------------------------------------------------------------
# serving


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_a_seg_export_serves_the_eval_steps_logits_and_labels(tmp_path):
    config = _seg_config(tmp_path, lr=1e-3)
    _reset_gm3d_loggers()
    cli.main(["--config", config, "--synthetic", "--synthetic_samples", "8", "--batch_size",
              "4", "--epochs", "1", "--num_workers", "0", "--device", "cpu",
              "--output_dir", str(tmp_path / "seg")])
    best = tmp_path / "seg" / "ckpt" / "best"
    art = export_model.main(["--config", config, "--ckpt", str(best), "--mode", "segmentation",
                             "--export_batch", "4", "--device", "cpu",
                             "--out", str(tmp_path / "seg.gm3dx")])
    served = ServingModel(art, device="cpu")
    manifest = served.manifest
    assert manifest["mode"] == "segmentation" and manifest["ckpt_step"] == 2
    assert manifest["output_shape"] == [4, N, 50]
    assert manifest["extra_inputs"] == [{"shape": [4], "dtype": "int32"}]
    assert manifest["cls_names"] == CLS_NAMES and manifest["seg_classes"] == {
        k: list(v) for k, v in datasets.SEG_CLASSES.items()}
    clouds, (cls, _) = _clouds(17, b=6), _labels(18, b=6)
    model = build_model_from_cfg(yaml.safe_load(open(config))["model"])
    model.load_state_dict(restore_raw(str(best))["model"], strict=True)
    want = seg.make_seg_eval_step(model, device="cpu")(torch.from_numpy(clouds),
                                                       torch.from_numpy(cls)).numpy()
    # six clouds on a batch of four: one full chunk and one padded
    np.testing.assert_allclose(served.predict(clouds, cls), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(served.predict(clouds[0], cls[0]), want[0], rtol=0, atol=1e-5)
    want_labels = seg.category_restricted_argmax(want, cls, datasets.SEG_CLASSES, CLS_NAMES)
    for bad, match in ((None, "requires cls_label"), (np.full(6, 16), r"\[0, 16\)"),
                       (cls[:2], "shape")):
        with pytest.raises(ValueError, match=match):
            served.predict(clouds, bad)

    server = make_server(art, port=0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/predict"
    try:
        body = {"points": clouds.tolist(), "cls_label": cls.tolist()}
        res = _post(url, body)
        assert sorted(res) == ["label"]
        assert np.array_equal(np.asarray(res["label"]), want_labels)
        res = _post(url, {**body, "return_logits": True})
        np.testing.assert_allclose(np.asarray(res["outputs"]), want, rtol=0, atol=1e-5)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url, {"points": clouds.tolist()})
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
    # the outputs are per point: an input of another size is refused
    with pytest.raises(ValueError, match="input_points == npoints"):
        export_model.main(["--config", config, "--ckpt", str(best), "--mode", "segmentation",
                           "--input_points", str(2 * N), "--device", "cpu",
                           "--out", str(tmp_path / "x.gm3dx")])
    with pytest.raises(ValueError, match="PointTransformerSeg"):
        export_model.main(["--config", "configs/pointmae/finetune_modelnet.yaml",
                           "--mode", "segmentation", "--device", "cpu",
                           "--out", str(tmp_path / "y.gm3dx")])


def test_a_seg_artifact_without_its_parts_table_is_refused(tmp_path):
    """The served part labels are the category-restricted arg-max by the
    manifest's category -> parts table: a segmentation manifest without it
    is refused when it is saved and when it is loaded."""
    config = _seg_config(tmp_path)
    art = export_model.main(["--config", config, "--mode", "segmentation", "--export_batch",
                             "2", "--device", "cpu", "--out", str(tmp_path / "seg.gm3dx")])
    with zipfile.ZipFile(art) as zf:
        manifest = json.loads(zf.read("manifest.json"))
        program = zf.read("program.pt2")
    model = build_model_from_cfg(manifest["model_cfg"])
    exported = export_forward(build_seg_fn(model), (torch.zeros(2, N, 3),
                                                    torch.zeros(2, dtype=torch.int32)))
    for key in ("seg_classes", "cls_names"):
        bare = {k: v for k, v in manifest.items() if k != key}
        with pytest.raises(ValueError, match="category -> parts table"):
            save_artifact(str(tmp_path / "bare.gm3dx"), exported, bare)
        with zipfile.ZipFile(tmp_path / "edited.gm3dx", "w") as zf:
            zf.writestr("manifest.json", json.dumps(bare))
            zf.writestr("program.pt2", program)
        with pytest.raises(ValueError, match="category -> parts table"):
            load_artifact(str(tmp_path / "edited.gm3dx"), device="cpu")
    load_artifact(art, device="cpu")
