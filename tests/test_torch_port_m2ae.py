"""The port's Point-M2AE family against the JAX package's, on the CPU.

A small model (``tests/test_m2ae_gm3d.py``'s: groups 32 / 16 / 8 of 8 / 4 / 4,
widths 24 / 48 / 96, depth 1, two heads, B 4 x 128 points) with numpy-seeded
weights, carried across with ``state_dict_from_flax`` and the M2AE name
tables, sees the same clouds on both sides. The JAX side runs jitted.

  - the hierarchy, the k = 1 maps and the back-projected masks are equal
    (indices for indices; a differing k = 1 map reports the two candidates'
    distance gap);
  - ``PointM2AE``'s outputs, ``pooled_features`` and the classifier's logits
    within 1e-5;
  - both train steps over three steps, fed the JAX steps' own draws, metrics
    within ``rtol=2e-4`` (stochastic depth is 0 at depth 1);
  - the attention route: masked sites never reach the fused op, and a
    sequence longer than the kernels hold stays plain;
  - the hierarchical layer-decay scales name by name, and the pretrain ->
    classifier and -> seg model transfer counts against the JAX overlay's;
  - ``PointM2AESeg``'s per-point logits within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_at_one_thread  # noqa: F401
from gm3d_tpu.ckpt.transfer import overlay_pretrained as joverlay
from gm3d_tpu.models import PointM2AE as JPointM2AE
from gm3d_tpu.models import PointM2AEClassifier as JClassifier
from gm3d_tpu.models import PointM2AESeg as JSeg
from gm3d_tpu.models.m2ae import build_hierarchy as jbuild_hierarchy
from gm3d_tpu.models.m2ae import nearest_coarse_maps as jnearest_coarse_maps
from gm3d_tpu.models.m2ae import propagate_masks as jpropagate_masks
from gm3d_tpu.train.optim import build_adamw as jbuild_adamw
from gm3d_tpu.train.optim import layerwise_lr_decay_scales as jlayer_scales
from gm3d_tpu.train.pretrain import make_m2ae_gm3d_train_step as jmake_gm3d_step
from gm3d_tpu.train.pretrain import make_m2ae_train_step as jmake_step
from gm3d_tpu.train.state import create_train_state as jcreate_state
from gm3d_tpu_torch.ckpt.torch_import import (
    M2AE_CLASSIFIER_MAP,
    M2AE_MAP,
    M2AE_SEG_MAP,
    load_flax_variables,
    state_dict_from_flax,
)
from gm3d_tpu_torch.ckpt.transfer import overlay_pretrained
from gm3d_tpu_torch.masking import geometric_mask
from gm3d_tpu_torch.models import PointM2AE, PointM2AEClassifier, PointM2AESeg
from gm3d_tpu_torch.models import blocks as tb
from gm3d_tpu_torch.models.m2ae import build_hierarchy, nearest_coarse_maps, propagate_masks
from gm3d_tpu_torch.train import pretrain as tp
from gm3d_tpu_torch.train.optim import build_adamw, layerwise_lr_decay_scales
from gm3d_tpu_torch.train.state import create_train_state

KW = dict(num_groups=(32, 16, 8), group_sizes=(8, 4, 4), encoder_depths=(1, 1, 1),
          encoder_dims=(24, 48, 96), local_radius=(0.32, 0.64, 1.28), decoder_dims=(96, 48),
          decoder_depths=(1, 1), num_heads=2)
CLS_KW = {k: v for k, v in KW.items() if not k.startswith("decoder")}
B, N, COARSE, LR = 4, 128, 8, 1e-3
SCALARS = {"keep_ratio": 0.5, "ema_decay": 0.999}


def _clouds(seed):
    return (np.random.default_rng(seed).standard_normal((B, N, 3)) * 0.5).astype(np.float32)


def _coarse_vis(seed=5):
    vis = np.random.default_rng(seed).random((B, COARSE)) > 0.6
    vis[:, 0] = True
    return vis


def _noisy(shapes, seed):
    """Numpy variables in the tree of ``shapes``: weights of the init's scale,
    biases, norm scales, placeholders and running statistics non-trivial."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        noise = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "var":
            return 1.0 + 0.5 * np.abs(noise)
        if name == "kernel":
            return noise / np.sqrt(s.shape[0])
        return (1.0 if name == "scale" else 0.0) + 0.1 * noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _m2ae_variables(seed=0):
    pts = jnp.zeros((B, N, 3), jnp.float32)
    vis = jnp.ones((B, COARSE), bool)
    return _noisy(jax.eval_shape(lambda k: JPointM2AE(**KW).init(k, pts, vis),
                                 jax.random.key(0)), seed)


def _classifier_variables(seed=1):
    pts = jnp.zeros((B, N, 3), jnp.float32)
    return _noisy(jax.eval_shape(lambda k: JClassifier(cls_dim=10, **CLS_KW).init(k, pts),
                                 jax.random.key(0)), seed)


def _seg_variables(seed=2):
    pts = jnp.zeros((B, N, 3), jnp.float32)
    cls = jnp.zeros((B,), jnp.int32)
    return _noisy(jax.eval_shape(lambda k: JSeg(**CLS_KW).init(k, pts, cls),
                                 jax.random.key(0)), seed)


def _port_m2ae(variables, **kwargs):
    model = PointM2AE(**KW, **kwargs)
    return load_flax_variables(model, variables, M2AE_MAP)


@pytest.fixture(scope="module")
def m2ae_vars():
    return _m2ae_variables()


# ---------------------------------------------------------------- geometry


@pytest.fixture(scope="module")
def geometry():
    pts = _clouds(3)
    jcenters, jmembers = jax.jit(lambda p: jbuild_hierarchy(p, KW["num_groups"],
                                                            KW["group_sizes"]))(pts)
    centers, members = build_hierarchy(torch.from_numpy(pts), KW["num_groups"],
                                       KW["group_sizes"])
    return jcenters, jmembers, centers, members


@pytest.mark.parametrize("scale", [0, 1, 2])
def test_hierarchy_equals_jax(geometry, scale):
    jcenters, jmembers, centers, members = geometry
    np.testing.assert_array_equal(centers[scale].numpy(), np.asarray(jcenters[scale]))
    np.testing.assert_array_equal(members[scale].numpy(), np.asarray(jmembers[scale]))
    assert members[scale].dtype == torch.int32


def _gap(coarse, fine, a, b):
    """Per differing entry, the difference of the squared distances of the
    two candidates (the JAX pick and the port's) from the fine center."""
    d = ((fine[:, :, None, :] - coarse[:, None, :, :]) ** 2).sum(-1)
    rows = np.argwhere(a != b)
    return [float(abs(d[i, j, a[i, j]] - d[i, j, b[i, j]])) for i, j in rows]


def test_nearest_coarse_maps_and_propagated_masks_equal_jax(geometry):
    jcenters, _, centers, _ = geometry
    jmaps = jnearest_coarse_maps(jcenters)
    maps = nearest_coarse_maps(centers)
    assert len(maps) == 2
    for s, (want, got) in enumerate(zip(jmaps, maps)):
        want, got = np.asarray(want), got.numpy()
        gaps = _gap(np.asarray(jcenters[-1]), np.asarray(jcenters[s]), want, got)
        assert not gaps, f"scale {s}: k = 1 maps differ; distance gaps {gaps}"
    vis = _coarse_vis()
    jmasks = jpropagate_masks(jnp.asarray(vis), jcenters)
    masks = propagate_masks(torch.from_numpy(vis), centers)
    for want, got in zip(jmasks, masks):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the coarsest mask is the input; the finer ones are gathered through the maps
    assert masks[-1] is not None and bool((masks[-1] == torch.from_numpy(vis)).all())


# ---------------------------------------------------------------- forward


@pytest.fixture(scope="module")
def forward(m2ae_vars):
    pts, vis = _clouds(3), _coarse_vis()
    jmodel = JPointM2AE(**KW)
    jv = jax.tree.map(jnp.asarray, m2ae_vars)
    want = jax.jit(lambda v, p, c: jmodel.apply(v, p, c))(jv, pts, vis)
    model = _port_m2ae(m2ae_vars).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(pts), torch.from_numpy(vis))
    return want, got


@pytest.mark.parametrize("key", ["rebuild", "gt", "loss_pred", "fine_to_coarse", "fine_vis"])
def test_forward_equals_jax(forward, key):
    want, got = forward
    w, g = np.asarray(want[key]), got[key].numpy()
    assert w.shape == g.shape, key
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=key)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=key)


def test_loss_pred_only_is_the_full_forwards_head(m2ae_vars):
    model = _port_m2ae(m2ae_vars).eval()
    pts, vis = torch.from_numpy(_clouds(4)), torch.from_numpy(_coarse_vis(6))
    with torch.no_grad():
        full = model(pts, vis)
        trimmed = model(pts, vis, loss_pred_only=True)
    assert sorted(trimmed) == ["loss_pred"]
    torch.testing.assert_close(trimmed["loss_pred"], full["loss_pred"], rtol=0, atol=0)


@pytest.mark.parametrize("svm_scales", ["all", "last"])
def test_pooled_features_equal_jax(m2ae_vars, svm_scales):
    pts = _clouds(7)
    jmodel = JPointM2AE(**KW, svm_scales=svm_scales)
    jv = jax.tree.map(jnp.asarray, m2ae_vars)
    want = jax.jit(lambda v, p: jmodel.apply(v, p, method=jmodel.pooled_features))(jv, pts)
    model = _port_m2ae(m2ae_vars, svm_scales=svm_scales).eval()
    with torch.no_grad():
        got = model.pooled_features(torch.from_numpy(pts))
    assert got.shape == (B, sum(KW["encoder_dims"]) if svm_scales == "all" else 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        tokens = model.encode_features(torch.from_numpy(pts))
    assert tokens.shape == (B, COARSE, model.trans_dim)


def test_classifier_logits_equal_jax():
    variables = _classifier_variables()
    pts = _clouds(8)
    jmodel = JClassifier(cls_dim=10, **CLS_KW)
    want = jax.jit(lambda v, p: jmodel.apply(v, p))(jax.tree.map(jnp.asarray, variables), pts)
    model = load_flax_variables(PointM2AEClassifier(cls_dim=10, **CLS_KW), variables,
                                M2AE_CLASSIFIER_MAP).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_the_name_tables_cover_every_tensor(m2ae_vars):
    """``strict=True`` loads, and no parameter or BatchNorm buffer keeps its
    init value."""
    for model, variables, table in (
            (PointM2AE(**KW), m2ae_vars, M2AE_MAP),
            (PointM2AEClassifier(cls_dim=10, **CLS_KW), _classifier_variables(),
             M2AE_CLASSIFIER_MAP)):
        fresh = {k: v.clone() for k, v in model.state_dict().items()}
        load_flax_variables(model, variables, table)
        for key, value in model.state_dict().items():
            if key.endswith("num_batches_tracked"):
                continue
            assert not torch.equal(value, fresh[key]), key


# ---------------------------------------------------------------- steps


def _draws(key):
    """What the JAX M2AE steps draw from ``key``, as torch tensors."""
    r_aug, r_mask, _, _ = jax.random.split(key, 4)
    r_scale, r_shift = jax.random.split(r_aug)
    out = {"scale": jax.random.uniform(r_scale, (B, 1, 3), minval=2.0 / 3.0, maxval=3.0 / 2.0),
           "shift": jax.random.uniform(r_shift, (B, 1, 3), minval=-0.2, maxval=0.2),
           "noise": jax.random.uniform(r_mask, (B, COARSE))}
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _run_steps(variables, gm3d, steps=3):
    jmodel = JPointM2AE(**KW)
    tx = jbuild_adamw(LR, grad_clip=5.0 if gm3d else None)
    jstate = jcreate_state(jax.tree.map(jnp.asarray, variables), tx, with_ema=gm3d)
    model = _port_m2ae(variables)
    optimizer = build_adamw(model.named_parameters(), LR, grad_clip=5.0 if gm3d else None)
    state = create_train_state(model, optimizer, with_ema=gm3d)
    if gm3d:
        jstep = jmake_gm3d_step(jmodel, tx, mask_ratio=0.8)
        step = tp.make_m2ae_gm3d_train_step(model, optimizer, mask_ratio=0.8, device="cpu")
        jscalars = {k: jnp.asarray(v, jnp.float32) for k, v in SCALARS.items()}
        keys = tp.M2AE_GM3D_METRIC_KEYS
    else:
        jstep = jmake_step(jmodel, tx, mask_ratio=0.8)
        step = tp.make_m2ae_train_step(model, optimizer, mask_ratio=0.8, device="cpu")
        keys = tp.M2AE_METRIC_KEYS
    history, masks = [], []
    for i in range(steps):
        pts, key = _clouds(10 + i), jax.random.key(i)
        if gm3d:
            jstate, jm = jstep(jstate, jnp.asarray(pts), key, jscalars)
            draws = _draws(key)
            state, m = step(state, torch.from_numpy(pts), None, SCALARS, draws=draws)
            # the geometric mask at the step's shapes, on its draws
            pred = torch.rand((B, COARSE), generator=torch.Generator().manual_seed(i))
            mask = geometric_mask(None, pred, step.num_mask, SCALARS["keep_ratio"],
                                  noise=draws["noise"])
            masks.append(mask.sum(dim=1).tolist())
        else:
            jstate, jm = jstep(jstate, jnp.asarray(pts), key)
            state, m = step(state, torch.from_numpy(pts), None, draws=_draws(key))
        assert sorted(m) == sorted(keys)
        history.append(({k: float(jm[k]) for k in keys}, {k: float(m[k]) for k in keys}))
    return jstate, state, step, history, masks


@pytest.fixture(scope="module")
def gm3d_steps(m2ae_vars):
    return _run_steps(m2ae_vars, gm3d=True)


@pytest.fixture(scope="module")
def plain_steps(m2ae_vars):
    return _run_steps(m2ae_vars, gm3d=False)


@pytest.mark.parametrize("index", [0, 1, 2])
def test_m2ae_gm3d_step_metrics_equal_jax(gm3d_steps, index):
    want, got = gm3d_steps[3][index]
    for key in tp.M2AE_GM3D_METRIC_KEYS:
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4, err_msg=f"step {index} {key}")


@pytest.mark.parametrize("index", [0, 1, 2])
def test_m2ae_step_metrics_equal_jax(plain_steps, index):
    want, got = plain_steps[3][index]
    for key in tp.M2AE_METRIC_KEYS:
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4, err_msg=f"step {index} {key}")


def test_mask_counts_of_the_two_steps(gm3d_steps, plain_steps):
    # GM3D's count L - int(L (1 - r)) = 8 - 1 = 7; Point-M2AE's int(L r) = 6
    assert gm3d_steps[2].num_mask == 7 and plain_steps[2].num_mask == 6
    assert gm3d_steps[4] == [[7] * B] * 3


def test_ema_moves_parameters_and_batch_norm_statistics(gm3d_steps, m2ae_vars):
    """The EMA after three steps against the JAX state's (parameters and
    BatchNorm statistics both)."""
    jstate, state = gm3d_steps[0], gm3d_steps[1]
    want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.ema_variables()), M2AE_MAP)
    start = state_dict_from_flax(m2ae_vars, M2AE_MAP)
    got = state.ema.state_dict()
    moved = 0
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        moved += int(not torch.equal(got[name], start[name]))
    assert moved > 0.9 * len(want)
    for name in ("lp_bn.running_mean", "encoder.patch_embed.first_conv.1.running_var"):
        assert not torch.equal(got[name], start[name]), name
    assert not state.ema.training and state.step == 3


def test_multi_step_covers_both_arities(m2ae_vars):
    """``make_multi_step`` over the M2AE + GM3D step (with scalars) and the
    M2AE step (without) equals the same steps called one by one."""
    pts = torch.from_numpy(np.stack([_clouds(20), _clouds(21)]))
    draws = [_draws(jax.random.key(30 + i)) for i in range(2)]
    stacked = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
    for gm3d in (True, False):
        results = []
        for multi in (True, False):
            model = _port_m2ae(m2ae_vars)
            optimizer = build_adamw(model.named_parameters(), LR)
            state = create_train_state(model, optimizer, with_ema=gm3d)
            make = tp.make_m2ae_gm3d_train_step if gm3d else tp.make_m2ae_train_step
            step = make(model, optimizer, device="cpu")
            extra = (SCALARS,) if gm3d else ()
            if multi:
                run = tp.make_multi_step(step, has_scalars=gm3d)
                state, metrics = run(state, pts, None, *extra, draws=stacked)
                results.append(metrics["loss"])
            else:
                losses = []
                for k in range(2):
                    state, m = step(state, pts[k], None, *extra, draws=draws[k])
                    losses.append(m["loss"])
                results.append(torch.stack(losses))
        assert results[0].shape == (2,)
        torch.testing.assert_close(results[0], results[1], rtol=0, atol=0)


# ---------------------------------------------------------------- attention route


def test_masked_attention_never_reaches_the_fused_op(monkeypatch, m2ae_vars):
    """Inside ``fused_attention_scope`` the encoder's stages (masked) stay
    plain; only the unmasked decoder blocks (four at this size, each at most
    64 tokens) take the fused op."""
    calls = []
    real = tb.fused_attention_trainable
    monkeypatch.setattr(tb, "fused_attention_trainable",
                        lambda x, *a: calls.append(tuple(x.shape)) or real(x, *a))
    model = _port_m2ae(m2ae_vars).eval()
    pts, vis = torch.from_numpy(_clouds(3)), torch.from_numpy(_coarse_vis())
    with torch.no_grad():
        plain = model(pts, vis)
        with tb.fused_attention_scope(True):
            fused = model(pts, vis)
            model.encode_features(pts)
    assert sorted(calls) == sorted([(B, 8, 96), (B, 16, 48), (B, 16, 48), (B, 32, 48)])
    torch.testing.assert_close(fused["rebuild"], plain["rebuild"], rtol=1e-5, atol=1e-5)


def test_a_sequence_longer_than_the_kernels_hold_stays_plain(monkeypatch):
    """At full width the decoder's finer sites are 256 and 512 tokens: the
    route declines them by their length (the JAX ``_fused_block_batch``)."""
    calls = []
    monkeypatch.setattr(tb, "fused_attention_trainable", lambda *a: calls.append(1))
    attn = tb.Attention(48, 2).eval()
    with torch.no_grad(), tb.fused_attention_scope(True):
        out = attn(torch.randn(1, 65, 48))
        assert not calls and out.shape == (1, 65, 48)
        attn(torch.randn(1, 64, 48))
    assert len(calls) == 1


# ---------------------------------------------------------------- finetune pieces


def _torch_names(variables, table):
    """flax parameter path -> the torch name ``state_dict_from_flax`` gives it."""
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    paths = ["/".join(k.key for k in kp) for kp, _ in flat]
    tagged = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(variables["params"]),
        [np.full(leaf.shape, float(i), np.float32) for i, (_, leaf) in enumerate(flat)])
    sd = state_dict_from_flax({"params": tagged}, table)
    by_tag = {int(v.reshape(-1)[0]): k for k, v in sd.items()}
    return {p: by_tag[i] for i, p in enumerate(paths)}


@pytest.mark.parametrize("decay", [0.65, 0.9])
def test_hierarchical_layer_decay_scales_equal_jax(decay):
    variables = _classifier_variables()
    want = jlayer_scales(jax.tree.map(jnp.asarray, variables["params"]), decay)
    names = _torch_names(variables, M2AE_CLASSIFIER_MAP)
    model = PointM2AEClassifier(cls_dim=10, **CLS_KW)
    got = layerwise_lr_decay_scales([n for n, _ in model.named_parameters()], decay)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(got)
    for kp, scale in flat:
        path = "/".join(k.key for k in kp)
        assert got[names[path]] == pytest.approx(float(scale), rel=1e-12), path
    # the stem at layer 0, the last block of the last stage one below the head
    n_layers = 4
    assert got["encoder.patch_embed.first_conv.0.weight"] == pytest.approx(decay ** n_layers)
    assert got["encoder.stage2.blocks.0.attn.qkv.weight"] == pytest.approx(decay)
    assert got["cls_head_finetune.8.weight"] == 1.0 and got["norm2.weight"] == 1.0


def test_transfer_count_equals_the_jax_overlay(m2ae_vars):
    cls_vars = _classifier_variables()
    _, _, want = joverlay(jax.tree.map(jnp.asarray, cls_vars["params"]),
                          jax.tree.map(jnp.asarray, cls_vars["batch_stats"]),
                          m2ae_vars["params"], m2ae_vars["batch_stats"])
    classifier = PointM2AEClassifier(cls_dim=10, **CLS_KW)
    pretrain = _port_m2ae(m2ae_vars)
    new, got = overlay_pretrained(classifier.state_dict(), pretrain.state_dict())
    assert got == want > 0
    classifier.load_state_dict(new, strict=True)
    torch.testing.assert_close(classifier.encoder.stage1.blocks[0].attn.qkv.weight,
                               pretrain.encoder.stage1.blocks[0].attn.qkv.weight)


def test_seg_logits_equal_jax():
    variables = _seg_variables()
    pts = _clouds(9)
    cls = np.arange(B, dtype=np.int32) * 3
    jmodel = JSeg(**CLS_KW)
    want = jax.jit(lambda v, p, c: jmodel.apply(v, p, c))(
        jax.tree.map(jnp.asarray, variables), pts, cls)
    model = load_flax_variables(PointM2AESeg(**CLS_KW), variables, M2AE_SEG_MAP).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(pts), torch.from_numpy(cls))
    assert got.shape == (B, N, 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_seg_transfer_count_equals_the_jax_overlay(m2ae_vars):
    seg_vars = _seg_variables()
    _, _, want = joverlay(jax.tree.map(jnp.asarray, seg_vars["params"]),
                          jax.tree.map(jnp.asarray, seg_vars["batch_stats"]),
                          m2ae_vars["params"], m2ae_vars["batch_stats"])
    _, got = overlay_pretrained(PointM2AESeg(**CLS_KW).state_dict(),
                                _port_m2ae(m2ae_vars).state_dict())
    assert got == want > 0
