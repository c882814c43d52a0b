"""``GM3DStudent.forward`` and ``PointMAE.forward`` / ``decode_replay`` of the
port against the flax modules, key by key, on the CPU.

Variables are made with numpy from a seed (no leaf trivial), carried across
with ``load_flax_variables`` (``strict=True``); both sides see the same numpy
cloud and mask. Stochastic depth is 0 on both sides. Tolerance: fp32
``atol=2e-5`` on activations of order one (same formulas, other summation
order); integer and boolean keys must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_at_one_thread  # noqa: F401
from gm3d_tpu.models import GM3DStudent as JGM3DStudent
from gm3d_tpu.models import PointMAE as JPointMAE
from gm3d_tpu.ops.group import group_points as jgroup_points
from gm3d_tpu_torch.ckpt.torch_import import GM3D_STUDENT_MAP, POINT_MAE_MAP, load_flax_variables
from gm3d_tpu_torch.models import GM3DStudent, PointMAE
from gm3d_tpu_torch.ops.group import Grouped

SMALL = dict(trans_dim=48, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=48,
             decoder_depth=2, decoder_num_heads=2, drop_path_rate=0.0)
B, N, G, NUM_MASK = 4, 128, 16, 10
ATOL = 2e-5


def _variables(jmodel, seed, num_mask=NUM_MASK):
    rng = np.random.default_rng(seed)
    pts = jnp.zeros((B, N, 3), jnp.float32)
    mask = jnp.zeros((B, G), bool).at[:, :num_mask].set(True)
    shapes = jax.eval_shape(lambda key: jmodel.init(key, pts, mask, num_mask),
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


def _inputs(seed, num_mask):
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((B, N, 3)) * 0.5).astype(np.float32)
    mask = np.zeros((B, G), bool)
    for row in mask:
        row[rng.permutation(G)[:num_mask]] = True
    return pts, mask


def _compare(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if w is None or isinstance(w, int):
            assert g == w, key
            continue
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, key
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=key)
        else:
            np.testing.assert_allclose(g.detach().numpy(), w, atol=ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("mode", ["feature", "usual"])
@pytest.mark.parametrize("num_mask", [NUM_MASK, 0])
@pytest.mark.parametrize("train", [False, True])
def test_student_forward_equals_flax(mode, num_mask, train):
    jmodel = JGM3DStudent(mode=mode, **SMALL)
    variables = _variables(jmodel, 0)
    model = load_flax_variables(GM3DStudent(mode=mode, **SMALL), variables, GM3D_STUDENT_MAP)
    model.train(train)
    pts, mask = _inputs(1, num_mask)
    if train:
        want, updates = jmodel.apply(variables, jnp.asarray(pts), jnp.asarray(mask), num_mask,
                                     deterministic=False, mutable=["batch_stats"],
                                     rngs={"dropout": jax.random.key(0),
                                           "droppath": jax.random.key(1)})
    else:
        want = jmodel.apply(variables, jnp.asarray(pts), jnp.asarray(mask), num_mask)
    got = model(torch.from_numpy(pts), torch.from_numpy(mask), num_mask)
    _compare(got, want)
    assert got["loss_pred"].shape == (B, G) and got["loss_pred"].dtype == torch.float32
    if train:  # train-mode BatchNorm moved the running statistics alike
        stats = updates["batch_stats"]["head_bn"]
        np.testing.assert_allclose(model.increase_dim_2[1].running_mean.numpy(),
                                   np.asarray(stats["mean"]), atol=ATOL)
        np.testing.assert_allclose(model.increase_dim_2[1].running_var.numpy(),
                                   np.asarray(stats["var"]), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("flags", [
    {"shared_learnable_tokens": True}, {"detach_loss_pred_branch": True},
    {"loss_pred_only": True}, {"grouped": True}, {"tokens": True}])
def test_student_forward_flags(flags):
    jmodel = JGM3DStudent(**SMALL)
    variables = _variables(jmodel, 2)
    model = load_flax_variables(GM3DStudent(**SMALL), variables, GM3D_STUDENT_MAP).eval()
    num_mask = 0 if "tokens" in flags else NUM_MASK
    pts, mask = _inputs(3, num_mask)
    jflags, tflags = dict(flags), dict(flags)
    if flags.get("grouped"):
        # a grouping of ANOTHER cloud: both sides must use it, not regroup
        other, _ = _inputs(4, num_mask)
        jg = jgroup_points(jnp.asarray(other), G, 8)
        jflags["grouped"] = jg
        tflags["grouped"] = Grouped(*(torch.from_numpy(np.array(t)) for t in jg))
    if flags.get("tokens"):
        tokens = np.random.default_rng(5).standard_normal((B, G, 48)).astype(np.float32)
        jflags["tokens"], tflags["tokens"] = jnp.asarray(tokens), torch.from_numpy(tokens)
    want = jmodel.apply(variables, jnp.asarray(pts), jnp.asarray(mask), num_mask, **jflags)
    got = model(torch.from_numpy(pts), torch.from_numpy(mask), num_mask, **tflags)
    _compare(got, want)
    if flags.get("loss_pred_only"):
        assert got["pix_pred"] is None and got["rebuild_points"] is None


def test_detach_stops_the_loss_prediction_gradient_at_the_encoder():
    model = GM3DStudent(**SMALL).train()
    pts, mask = _inputs(6, NUM_MASK)
    for detach in (False, True):
        model.zero_grad()
        out = model(torch.from_numpy(pts), torch.from_numpy(mask), NUM_MASK,
                    detach_loss_pred_branch=detach)
        out["loss_pred"].sum().backward()
        enc = model.MAE_encoder.blocks.blocks[0].mlp.fc1.weight.grad
        dec = model.MAE_decoder_loss_pred.blocks[0].mlp.fc1.weight.grad
        assert dec is not None and float(dec.abs().max()) > 0
        assert (enc is None or float(enc.abs().max()) == 0) == detach


def test_student_shared_pos_embed_equals_flax():
    jmodel = JGM3DStudent(mode="usual", shared_pos_embed=True, **SMALL)
    variables = _variables(jmodel, 7)
    assert "decoder_pos_embed" not in variables["params"]
    model = load_flax_variables(GM3DStudent(mode="usual", shared_pos_embed=True, **SMALL),
                                variables, GM3D_STUDENT_MAP).eval()
    pts, mask = _inputs(8, NUM_MASK)
    want = jmodel.apply(variables, jnp.asarray(pts), jnp.asarray(mask), NUM_MASK, True)
    got = model(torch.from_numpy(pts), torch.from_numpy(mask), NUM_MASK, True)
    _compare(got, want)


@pytest.mark.parametrize("num_mask", [9, 0])
def test_pointmae_forward_equals_flax(num_mask):
    jmodel = JPointMAE(**SMALL)
    variables = _variables(jmodel, 9, 9)
    model = load_flax_variables(PointMAE(**SMALL), variables, POINT_MAE_MAP).eval()
    pts, mask = _inputs(10, num_mask)
    want = jmodel.apply(variables, jnp.asarray(pts), jnp.asarray(mask), num_mask)
    got = model(torch.from_numpy(pts), torch.from_numpy(mask), num_mask)
    _compare(got, want)
    shape = (B, num_mask or G, 8, 3)
    assert tuple(got["rebuild"].shape) == shape and tuple(got["gt"].shape) == shape


@pytest.mark.parametrize("length", [G, NUM_MASK])
def test_pointmae_decode_replay_and_encode_features_equal_flax(length):
    jmodel = JPointMAE(**SMALL)
    variables = _variables(jmodel, 11, 9)
    model = load_flax_variables(PointMAE(**SMALL), variables, POINT_MAE_MAP).eval()
    rng = np.random.default_rng(12)
    tokens = rng.standard_normal((B, length, 48)).astype(np.float32)
    centers = rng.standard_normal((B, length, 3)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(tokens), jnp.asarray(centers),
                        method=jmodel.decode_replay)
    got = model.decode_replay(torch.from_numpy(tokens), torch.from_numpy(centers))
    assert tuple(got.shape) == (B, length, 8, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    pts, _ = _inputs(13, 0)
    feats = model.encode_features(torch.from_numpy(pts))
    jfeats = jmodel.apply(variables, jnp.asarray(pts), method=jmodel.encode_features)
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(jfeats), atol=ATOL, rtol=0)
