"""The port's CLIP distillation (``gm3d_tpu_torch/models/clip.py``, the step's
``distill_mode='clip'``, ``--learn_feature_loss clip``) against the JAX
package's, on the CPU.

A small tower (resolution 16, patch 4, 64 wide, 2 layers, 1 head: the
reference's ``heads = width // 64``) with weights drawn from a numpy seed and
carried across with ``state_dict_from_flax`` (``CLIP_VISUAL_MAP``); clouds
from a numpy seed. Tolerances: depth renders EQUAL element for element (max
is order-free); the tower's ``forward`` and ``features`` within 1e-5 of
their largest entry (fp32, other summation orders); the group targets'
patch indices EQUAL and the targets within 1e-5; the imported tower within
1e-5 of a torch oracle of ``forward_features_clip``
(``tests/test_clip.py``'s); one clip step: the mask EQUAL, the six metrics to
``rtol=2e-4`` and the weights and EMA after it as
``tests/test_torch_port_pretrain_step.py`` holds the other modes'. The CLI
runs the port only: a small student, the default tower.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import torch_at_one_thread  # noqa: F401
from cli_harness import _reset_gm3d_loggers
from test_torch_port_pretrain_step import (
    SMALL,
    _check_ema,
    _check_parameters_and_bn_buffers,
    _clouds,
    _draws,
    _variables,
)

from gm3d_tpu.ckpt.torch_import import import_clip_visual as jimport_clip_visual
from gm3d_tpu.data.transforms import scale_and_translate as jscale_and_translate
from gm3d_tpu.masking import geometric_mask as jgeometric_mask
from gm3d_tpu.models import GM3DStudent as JGM3DStudent
from gm3d_tpu.models import clip as jclip
from gm3d_tpu.ops.group import group_points as jgroup_points
from gm3d_tpu.train.optim import build_gm3d_shared_optimizer as jbuild_optimizer
from gm3d_tpu.train.pretrain import make_gm3d_train_step as jmake_step
from gm3d_tpu.train.state import create_train_state as jcreate_state
from gm3d_tpu_torch.ckpt.checkpoint import restore_raw
from gm3d_tpu_torch.ckpt.torch_import import (
    CLIP_VISUAL_MAP,
    import_clip_visual,
    load_pretrain_models,
    state_dict_from_flax,
)
from gm3d_tpu_torch.cli import pretrain as cli
from gm3d_tpu_torch.models import GM3DStudent, PointMAE
from gm3d_tpu_torch.models import clip
from gm3d_tpu_torch.train import pretrain as tp
from gm3d_tpu_torch.train.optim import build_gm3d_shared_optimizer
from gm3d_tpu_torch.train.state import create_train_state

TOWER = dict(input_resolution=16, patch_size=4, width=64, layers=2, heads=1, output_dim=48)
B, LR = 4, 1e-3
NUM_MASK = 10
SCALARS = {"keep_ratio": 0.5, "ema_decay": 0.999, "w_mse": 1.0, "w_cd": 1.0}
KEYS = ("loss", "loss_recon", "loss_mse", "loss_chfr", "loss_learn", "grad_norm")


def _tower_variables(seed, **overrides):
    """Numpy variables of the JAX tower: noise of the init's scale, LayerNorms
    away from the identity."""
    cfg = {**TOWER, **overrides}
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda key: jclip.CLIPVisionTower(**cfg).init(key, jnp.zeros((1, 16, 16, 3))),
        jax.random.key(0))

    def leaf(path, s):
        noise = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return noise / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * noise
        if name == "bias":
            return 0.1 * noise
        return noise * cfg["width"] ** -0.5

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _towers(seed=3, **overrides):
    cfg = {**TOWER, **overrides}
    variables = _tower_variables(seed, **overrides)
    tower = clip.CLIPVisionTower(**cfg)
    tower.load_state_dict(state_dict_from_flax(variables, CLIP_VISUAL_MAP), strict=True)
    return jclip.CLIPVisionTower(**cfg), jax.tree.map(jnp.asarray, variables), tower


def _render_case(case):
    rng = np.random.default_rng(7)
    if case == "uniform":  # beyond [-1, 1] too: the clamp
        return rng.uniform(-1.2, 1.2, (3, 300, 3)).astype(np.float32)
    if case == "duplicates":  # the same pixel at many depths, the same point twice
        xy = np.repeat(rng.uniform(-1, 1, (2, 20, 2)), 10, axis=1)
        z = rng.uniform(-1, 1, (2, 200, 1))
        return np.concatenate([xy, z], axis=-1).astype(np.float32)
    if case == "pixel_edges":  # exactly on pixel boundaries: the truncation
        k = rng.integers(0, 16, (2, 200, 3))
        return (k / 15.0 * 2.0 - 1.0).astype(np.float32)
    return np.asarray([[[1.0, 1.0, -1.0]]], np.float32)  # one point, a known pixel


@pytest.mark.parametrize("case", ["uniform", "duplicates", "pixel_edges", "single"])
def test_render_depth_views_equal_jax_element_for_element(case):
    pts = _render_case(case)
    want = np.asarray(jax.jit(jclip.render_depth_views, static_argnums=1)(jnp.asarray(pts), 16))
    got = clip.render_depth_views(torch.from_numpy(pts), 16)
    assert got.shape == (pts.shape[0], 3, 16, 16)  # channel-first
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    if case == "single":
        assert float(got[0, 0, 15, 15]) == 1.0


@pytest.mark.parametrize("method", ["forward", "features"])
def test_tower_equals_jax_with_weights_carried_across(method):
    jtower, jvars, tower = _towers()
    imgs = np.random.default_rng(4).uniform(size=(3, 16, 16, 3)).astype(np.float32)
    fn = jtower.features if method == "features" else None
    want = np.asarray(jax.jit(lambda v, x: jtower.apply(v, x, method=fn))(jvars, jnp.asarray(imgs)))
    with torch.no_grad():
        got = getattr(tower, method)(torch.from_numpy(imgs).permute(0, 3, 1, 2)).numpy()
    assert got.shape == ((3, 16, 48) if method == "features" else (3, 48))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("centers", ["of_the_cloud", "on_patch_edges"])
def test_group_targets_equal_jax(centers):
    """The patch indices are read back from the JAX targets: each target is
    the one token it equals among the tower's (distinct) tokens."""
    jtower, jvars, tower = _towers()
    pts = np.random.default_rng(5).uniform(-1, 1, (2, 256, 3)).astype(np.float32)
    if centers == "of_the_cloud":
        cen = pts[:, :12]
    else:  # patch edges, the two ends, beyond them: the clamp below 1
        edges = np.asarray([-1.5, -1.0, -0.5, 0.0, 0.5, 1.0 - 1e-7, 1.0, 1.5], np.float32)
        cen = np.stack(np.meshgrid(edges, edges[::-1], [0.0], indexing="ij"), -1)
        cen = np.broadcast_to(cen.reshape(1, -1, 3), (2, 64, 3)).astype(np.float32)
    want, tokens = (np.asarray(t) for t in jax.jit(lambda v, p, c: (
        jclip.clip_group_targets(jtower, v, p, c),
        jtower.apply(v, jclip.render_depth_views(p, 16), method=jtower.features)))(
            jvars, jnp.asarray(pts), jnp.asarray(cen)))
    want_patch = np.abs(want[:, :, None, :] - tokens[:, None, :, :]).sum(-1).argmin(-1)
    got = clip.clip_group_targets(tower, torch.from_numpy(pts), torch.from_numpy(cen))
    np.testing.assert_array_equal(clip.center_patches(torch.from_numpy(cen), tower.grid).numpy(),
                                  want_patch)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


def _fabricate_clip_sd(width=64, patch=4, grid=4, layers=2, out=48, full=True, seed=0):
    """A CLIP state dict laid out as the reference's (``tests/test_clip.py``),
    random weights; ``full``: with the text tower's keys beside ``visual.*``."""
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen) * 0.2

    sd = {"conv1.weight": randn(width, 3, patch, patch), "class_embedding": randn(width),
          "positional_embedding": randn(grid * grid + 1, width), "proj": randn(width, out),
          "ln_pre.weight": 1 + randn(width), "ln_pre.bias": randn(width),
          "ln_post.weight": 1 + randn(width), "ln_post.bias": randn(width)}
    for i in range(layers):
        p = f"transformer.resblocks.{i}."
        sd.update({p + "ln_1.weight": 1 + randn(width), p + "ln_1.bias": randn(width),
                   p + "ln_2.weight": 1 + randn(width), p + "ln_2.bias": randn(width),
                   p + "attn.in_proj_weight": randn(3 * width, width),
                   p + "attn.in_proj_bias": randn(3 * width),
                   p + "attn.out_proj.weight": randn(width, width),
                   p + "attn.out_proj.bias": randn(width),
                   p + "mlp.c_fc.weight": randn(4 * width, width),
                   p + "mlp.c_fc.bias": randn(4 * width),
                   p + "mlp.c_proj.weight": randn(width, 4 * width),
                   p + "mlp.c_proj.bias": randn(width)})
    if not full:
        return sd
    text = {"positional_embedding": randn(77, 32), "token_embedding.weight": randn(100, 32),
            "transformer.resblocks.0.ln_1.weight": randn(32), "ln_final.weight": randn(32),
            "text_projection": randn(32, out), "logit_scale": randn(())}
    return {**{f"visual.{k}": v for k, v in sd.items()}, **text}


def _oracle_features(sd, imgs, width, heads, layers, patch):
    """``forward_features_clip`` written out in torch (``tests/test_clip.py``)."""
    F = torch.nn.functional
    x = F.conv2d(imgs, sd["conv1.weight"], stride=patch)
    batch = x.shape[0]
    x = x.reshape(batch, width, -1).permute(0, 2, 1)
    x = torch.cat([sd["class_embedding"].expand(batch, 1, width), x], dim=1)
    x = F.layer_norm(x + sd["positional_embedding"], (width,), sd["ln_pre.weight"],
                     sd["ln_pre.bias"])
    for i in range(layers):
        p = f"transformer.resblocks.{i}."
        h = F.layer_norm(x, (width,), sd[p + "ln_1.weight"], sd[p + "ln_1.bias"])
        q, k, v = (h @ sd[p + "attn.in_proj_weight"].T + sd[p + "attn.in_proj_bias"]).chunk(3, -1)
        length, head_dim = x.shape[1], width // heads
        q, k, v = (t.reshape(batch, length, heads, head_dim).permute(0, 2, 1, 3)
                   for t in (q, k, v))
        a = torch.softmax(q @ k.transpose(-1, -2) * head_dim ** -0.5, dim=-1)
        h = (a @ v).permute(0, 2, 1, 3).reshape(batch, length, width)
        x = x + h @ sd[p + "attn.out_proj.weight"].T + sd[p + "attn.out_proj.bias"]
        h = F.layer_norm(x, (width,), sd[p + "ln_2.weight"], sd[p + "ln_2.bias"])
        h = h @ sd[p + "mlp.c_fc.weight"].T + sd[p + "mlp.c_fc.bias"]
        h = h * torch.sigmoid(1.702 * h)
        x = x + h @ sd[p + "mlp.c_proj.weight"].T + sd[p + "mlp.c_proj.bias"]
    x = F.layer_norm(x, (width,), sd["ln_post.weight"], sd["ln_post.bias"])
    return (x @ sd["proj"])[:, 1:, :]


@pytest.mark.parametrize("full", [True, False], ids=["full_clip", "bare_tower"])
def test_import_clip_visual_equals_the_jax_config_and_a_torch_oracle(full):
    sd = _fabricate_clip_sd(full=full)
    cfg, tower_sd = import_clip_visual(sd)
    assert cfg == dict(input_resolution=16, patch_size=4, width=64, layers=2, heads=1,
                       output_dim=48)
    # the JAX importer reads a bare tower's transformer.resblocks.* as the text
    # tower's and drops them (0 layers); a full CLIP state dict it reads alike
    jcfg, _ = jimport_clip_visual(sd)
    assert cfg == {**jcfg, "layers": 2 if not full else jcfg["layers"]}
    tower = clip.CLIPVisionTower(**cfg)
    tower.load_state_dict(tower_sd, strict=True)
    imgs = torch.from_numpy(np.random.default_rng(6).uniform(size=(2, 3, 16, 16))
                            .astype(np.float32))
    bare = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")} or sd
    with torch.no_grad():
        want = _oracle_features(bare, imgs, 64, 1, 2, 4).numpy()
        got = tower.features(imgs).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


# ---------------------------------------------------------------------------
# the step


def _jax_mask(jstudent, svars, pts, key):
    """The JAX step's mask, recomputed as its first half draws it: augment
    with ``r_aug``, the EMA forward (the initial weights) over ONE grouping,
    ``geometric_mask`` with ``r_mask``."""
    @jax.jit
    def mask(variables, pts, key):
        r_aug, r_mask, _, _ = jax.random.split(key, 4)
        samples = jscale_and_translate(r_aug, pts)
        grouped = jgroup_points(samples, jstudent.num_group, jstudent.group_size)
        outs = jstudent.apply(variables, samples,
                              jnp.zeros((pts.shape[0], jstudent.num_group), bool), 0, False,
                              deterministic=True, grouped=grouped, loss_pred_only=True)
        return jgeometric_mask(r_mask, outs["loss_pred"], NUM_MASK,
                               jnp.asarray(SCALARS["keep_ratio"], jnp.float32))

    return np.asarray(mask(jax.tree.map(jnp.asarray, svars), jnp.asarray(pts), key))


@pytest.fixture(scope="module")
def clip_step():
    """One clip step on both sides from the same weights, cloud and draws."""
    jstudent = JGM3DStudent(**SMALL)
    svars = _variables(jstudent, 0)
    jtower, jtvars, tower = _towers()
    tx = jbuild_optimizer(svars["params"], LR)
    jstate = jcreate_state(jax.tree.map(jnp.asarray, svars), tx, with_ema=True)
    jstep = jmake_step(jstudent, jtower, tx, mask_ratio=0.6, distill_mode="clip")
    student = GM3DStudent(**SMALL)
    optimizer = build_gm3d_shared_optimizer(student, LR)
    state = create_train_state(student, optimizer, with_ema=True)
    load_pretrain_models(student, state.ema, None, svars, svars)
    step = tp.make_gm3d_train_step(student, tower, optimizer, mask_ratio=0.6,
                                   distill_mode="clip", device="cpu")
    pts, key = _clouds(10), jax.random.key(0)
    jstate, jm = jstep(jstate, jtvars, jnp.asarray(pts), key,
                       {k: jnp.asarray(v, jnp.float32) for k, v in SCALARS.items()})
    state, m = step(state, torch.from_numpy(pts), None, SCALARS, draws=_draws(key))
    history = [({k: float(jm[k]) for k in KEYS}, {k: float(m[k]) for k in KEYS})]
    return {"one_step": (jstate, state, step, history, svars), "tower": tower,
            "mask": _jax_mask(jstudent, svars, pts, key)}


def test_clip_step_draws_the_jax_steps_mask(clip_step):
    step, want = clip_step["one_step"][2], clip_step["mask"]
    assert step.num_mask == NUM_MASK and want.sum(1).tolist() == [NUM_MASK] * B
    np.testing.assert_array_equal(step.last_mask.numpy(), want)


def test_clip_step_metrics_equal_the_jax_step(clip_step):
    want, got = clip_step["one_step"][3][0]
    assert sorted(got) == sorted(KEYS)
    for key in KEYS:
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4, atol=1e-7, err_msg=key)
    assert got["loss_chfr"] == 0.0 == want["loss_chfr"] and got["loss_mse"] > 0.0


def test_clip_step_parameters_bn_buffers_and_ema(clip_step):
    _check_parameters_and_bn_buffers(clip_step["one_step"])
    _check_ema(clip_step["one_step"])


def test_clip_step_leaves_the_tower_frozen(clip_step):
    tower, fresh = clip_step["tower"], _towers()[2]
    assert not tower.training
    assert all(not p.requires_grad and p.grad is None for p in tower.parameters())
    for name, value in fresh.state_dict().items():
        assert torch.equal(tower.state_dict()[name], value), name


@pytest.mark.parametrize("teacher", ["narrow_tower", "point_mae"])
def test_clip_step_refuses_a_teacher_it_cannot_distil_from(teacher):
    student = GM3DStudent(**SMALL)
    optimizer = build_gm3d_shared_optimizer(student, LR)
    if teacher == "narrow_tower":
        with pytest.raises(ValueError, match="output_dim 64 must match student trans_dim 48"):
            tp.make_gm3d_train_step(student, clip.CLIPVisionTower(**{**TOWER, "output_dim": 64}),
                                    optimizer, distill_mode="clip", device="cpu")
    else:
        with pytest.raises(ValueError, match="needs a CLIPVisionTower"):
            tp.make_gm3d_train_step(student, PointMAE(**SMALL), optimizer,
                                    distill_mode="clip", device="cpu")


# ---------------------------------------------------------------------------
# the CLI


CLI_FLAGS = ["--config", "configs/pointmae/config.yaml", "--synthetic", "--learn_feature_loss",
             "clip", "--batch_size", "4", "--synthetic_samples", "8", "--num_workers", "0",
             "--device", "cpu"]


@pytest.fixture
def small_cli(monkeypatch):
    """The small student in the CLI; every tower it builds is kept."""
    towers = []
    build = cli.build_clip_teacher

    def student(args, mode, dtype):
        model = GM3DStudent(mode=mode, **SMALL)
        model.reset_parameters(torch.Generator().manual_seed(0))
        return model

    def keep(*args, **kwargs):
        towers.append(build(*args, **kwargs))
        return towers[-1]

    monkeypatch.setattr(cli, "build_student", student)
    monkeypatch.setattr(cli, "build_clip_teacher", keep)
    _reset_gm3d_loggers()
    yield towers
    _reset_gm3d_loggers()


def test_cli_clip_epoch_then_resume_rebuilds_the_same_tower(small_cli, tmp_path):
    """One epoch with the default tower (resolution 32, patch 4, 256 wide, 6
    layers, 8 heads, ``output_dim`` the student's 48, random weights from a
    fixed seed), then ``--resume`` for a second: the same tower, the
    checkpoint without it, two records with the six metrics' keys and
    ``loss_chfr`` 0."""
    out = str(tmp_path / "run")
    first = cli.main(CLI_FLAGS + ["--epochs", "1", "--output_dir", out])
    ckpt = restore_raw(str(tmp_path / "run" / "ckpt"))
    second = cli.main(CLI_FLAGS + ["--epochs", "2", "--output_dir", out, "--resume"])
    assert [r["epoch"] for r in first + second] == [0, 1]
    for record in first + second:
        assert set(KEYS) <= set(record) and record["loss_chfr"] == 0.0
        assert all(np.isfinite(record[k]) for k in KEYS)
    a, b = small_cli
    assert a.config == b.config == dict(input_resolution=32, patch_size=4, width=256, layers=6,
                                        heads=8, output_dim=48)
    assert sorted(a.state_dict()) == sorted(b.state_dict())
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    saved = set(ckpt["model"])
    assert not any(k.startswith(("conv1", "transformer.resblocks", "class_embedding"))
                   for k in saved)


@pytest.mark.parametrize("out_dim", [48, 32])
def test_cli_clip_path_loads_the_tower_or_refuses_its_width(small_cli, tmp_path, out_dim):
    path = tmp_path / "clip.pt"
    sd = _fabricate_clip_sd(out=out_dim, full=True)
    torch.save(sd, path)
    flags = CLI_FLAGS + ["--epochs", "1", "--clip_path", str(path),
                         "--output_dir", str(tmp_path / "run")]
    if out_dim != 48:
        with pytest.raises(ValueError, match="CLIP output_dim 32 != student trans_dim 48"):
            cli.main(flags)
        assert not (tmp_path / "run" / "log.txt").exists()
        return
    records = cli.main(flags)
    assert len(records) == 1 and np.isfinite(records[0]["loss"])
    tower = small_cli[0]
    assert tower.config == dict(input_resolution=16, patch_size=4, width=64, layers=2,
                                heads=1, output_dim=48)
    for key, value in tower.state_dict().items():
        assert torch.equal(value, sd[f"visual.{key}"]), key
    assert "CLIP teacher loaded" in (tmp_path / "run" / "pretrain.log").read_text()
