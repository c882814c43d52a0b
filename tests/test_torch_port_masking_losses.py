"""Masks, losses, Chamfer forms, the augmentation and the schedules of the
port against the JAX package, on the CPU.

Random functions get the SAME draw on both sides: the draw is made with
``jax.random`` from the key the JAX function is given and injected into the
port's function. Masks must be equal index for index (ties included); float
results agree to ``rtol=1e-5`` / ``atol=1e-6`` (same formulas in fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gm3d_tpu.data import transforms as jtr
from gm3d_tpu.masking import masks as jm
from gm3d_tpu.ops import chamfer as jch
from gm3d_tpu.train import losses as jl
from gm3d_tpu.train import schedules as js
from gm3d_tpu_torch.data import transforms as ttr
from gm3d_tpu_torch.masking import masks as tm
from gm3d_tpu_torch.ops import chamfer as tch
from gm3d_tpu_torch.train import losses as tl
from gm3d_tpu_torch.train import optim as topt
from gm3d_tpu_torch.train import schedules as ts
from gm3d_tpu_torch.train.state import create_train_state, ema_update

B, G = 6, 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_gm3d_num_mask_is_39_of_64():
    assert tm.gm3d_num_mask(64, 0.6) == 39 == jm.gm3d_num_mask(64, 0.6)
    for groups, ratio in ((16, 0.6), (64, 0.75), (128, 0.8), (64, 0.0), (10, 0.33)):
        assert tm.gm3d_num_mask(groups, ratio) == jm.gm3d_num_mask(groups, ratio)


@pytest.mark.parametrize("keep_ratio", [0.0, 0.5, 0.8, 1.0])
@pytest.mark.parametrize("ties", [False, True])
def test_geometric_mask_equals_jax_index_for_index(keep_ratio, ties):
    rng = np.random.default_rng(0)
    loss_pred = rng.standard_normal((B, G)).astype(np.float32)
    if ties:  # a few distinct values only: the ranks are decided by index order
        loss_pred = np.round(loss_pred)
    key = jax.random.key(3)
    want = np.asarray(jm.geometric_mask(key, jnp.asarray(loss_pred), 39,
                                        jnp.asarray(keep_ratio, jnp.float32)))
    noise = jax.random.uniform(key, (B, G))
    got = tm.geometric_mask(None, _t(loss_pred), 39, keep_ratio, noise=_t(noise))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum(dim=1).tolist() == [39] * B
    # the top-loss groups are in the mask whatever the noise
    top = np.argsort(-loss_pred, axis=-1, kind="stable")[:, : int(np.floor(39 * keep_ratio))]
    if not ties:
        assert all(got[b, top[b]].all() for b in range(B))


def test_geometric_mask_draws_from_the_generator():
    loss_pred = torch.randn(B, G)
    a = tm.geometric_mask(torch.Generator().manual_seed(1), loss_pred, 39, 0.25)
    b = tm.geometric_mask(torch.Generator().manual_seed(1), loss_pred, 39, 0.25)
    c = tm.geometric_mask(torch.Generator().manual_seed(2), loss_pred, 39, 0.25)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.sum(dim=1).tolist() == [39] * B


def test_random_and_block_masks_equal_jax():
    key = jax.random.key(5)
    want = np.asarray(jm.random_mask(key, B, G, 38))
    got = tm.random_mask(None, B, G, 38, noise=_t(jax.random.uniform(key, (B, G))))
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = tm.random_mask(torch.Generator().manual_seed(0), B, G, 38)
    assert drawn.sum(dim=1).tolist() == [38] * B
    # block mask; centers on a grid so that equal distances occur
    centers = np.random.default_rng(1).integers(-2, 3, size=(B, G, 3)).astype(np.float32)
    want = np.asarray(jm.block_mask(key, jnp.asarray(centers), 20))
    seed = jax.random.randint(key, (B,), 0, G)
    got = tm.block_mask(None, _t(centers), 20, seed=_t(seed))
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = tm.block_mask(torch.Generator().manual_seed(0), _t(centers), 20)
    assert drawn.sum(dim=1).tolist() == [20] * B


@pytest.mark.parametrize("kwargs", [{}, {"after_200_epoch": True}, {"legacy": True}])
def test_keep_ratio_schedule_equals_jax(kwargs):
    for epoch in (0, 7, 149, 299):
        assert tm.keep_ratio_schedule(epoch, 300, **kwargs) == \
            jm.keep_ratio_schedule(epoch, 300, **kwargs)


def test_scale_and_translate_equals_jax():
    pts = np.random.default_rng(2).standard_normal((B, 50, 3)).astype(np.float32)
    key = jax.random.key(9)
    want = jtr.scale_and_translate(key, jnp.asarray(pts))
    r_scale, r_shift = jax.random.split(key)
    scale = jax.random.uniform(r_scale, (B, 1, 3), minval=2.0 / 3.0, maxval=3.0 / 2.0)
    shift = jax.random.uniform(r_shift, (B, 1, 3), minval=-0.2, maxval=0.2)
    got = ttr.scale_and_translate(None, _t(pts), scale=_t(scale), shift=_t(shift))
    _close(got, want, atol=1e-7)
    drawn = ttr.scale_and_translate(torch.Generator().manual_seed(0), _t(pts))
    ratio = (drawn[:, 1] - drawn[:, 0]) / (_t(pts)[:, 1] - _t(pts)[:, 0])  # the scale alone
    assert float(ratio.min()) >= 2.0 / 3.0 - 1e-4 and float(ratio.max()) <= 1.5 + 1e-4


@pytest.mark.parametrize("form", ["per_point", "l2", "l1", "group", "group_sqrt"])
def test_chamfer_forms_equal_jax(form):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((B, 5, 8, 3)).astype(np.float32)
    b = rng.standard_normal((B, 5, 11, 3)).astype(np.float32)
    ja, jb_, ta, tb_ = jnp.asarray(a), jnp.asarray(b), _t(a), _t(b)
    if form == "per_point":
        for got, want in zip(tch.chamfer_per_point(ta, tb_), jch.chamfer_per_point(ja, jb_)):
            _close(got, want)
    elif form == "l2":
        _close(tch.chamfer_l2(ta, tb_), jch.chamfer_l2(ja, jb_))
    elif form == "l1":
        _close(tch.chamfer_l1(ta, tb_), jch.chamfer_l1(ja, jb_))
    elif form == "group":
        _close(tch.chamfer_group(ta, tb_), jch.chamfer_group(ja, jb_))
    else:
        _close(tch.chamfer_group(ta, tb_, squared=False),
               jch.chamfer_group(ja, jb_, squared=False))


def _loss_inputs():
    rng = np.random.default_rng(4)
    m, d, s = 10, 48, 8
    mask_idx = np.stack([np.sort(rng.permutation(16)[:m]) for _ in range(B)]).astype(np.int32)
    return dict(
        pred_masked=rng.standard_normal((B, m, d)).astype(np.float32),
        teacher_feats=rng.standard_normal((B, 16, d)).astype(np.float32),
        mask_idx=mask_idx,
        point_target=rng.standard_normal((B, 16, s, 3)).astype(np.float32),
        point_reco=rng.standard_normal((B, m, s, 3)).astype(np.float32),
        rebuild_masked=rng.standard_normal((B, m, 3 * s)).astype(np.float32),
        neighborhood=rng.standard_normal((B, 16, s, 3)).astype(np.float32),
        loss_pred=rng.standard_normal((B, m)).astype(np.float32),
        loss_target=np.round(rng.standard_normal((B, m)), 1).astype(np.float32),  # some ties
    )


_LOSS_ARGS = {
    "gm3d_feature_loss": ("pred_masked", "teacher_feats", "mask_idx", "point_target",
                          "point_reco"),
    "gm3d_usual_loss": ("rebuild_masked", "neighborhood", "mask_idx"),
    "gm3d_separated_loss": ("pred_masked", "teacher_feats", "mask_idx", "rebuild_masked",
                            "neighborhood"),
    "relative_learning_loss": ("loss_pred", "loss_target"),
    "mse_learning_loss": ("loss_pred", "loss_target"),
}


@pytest.mark.parametrize("name", sorted(_LOSS_ARGS))
def test_gm3d_losses_equal_jax(name):
    data = _loss_inputs()
    args = [data[k] for k in _LOSS_ARGS[name]]
    want = getattr(jl, name)(*map(jnp.asarray, args))
    got = getattr(tl, name)(*(_t(a).long() if a.dtype == np.int32 else _t(a) for a in args))
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _close(got[key], want[key])
    else:
        _close(got, want)


@pytest.mark.parametrize("loss_type", ["cdl1", "cdl2"])
def test_pointmae_reconstruction_loss_equals_jax(loss_type):
    data = _loss_inputs()
    a, b = data["point_reco"], data["point_target"][:, :10]
    _close(tl.pointmae_reconstruction_loss(_t(a), _t(b), loss_type),
           jl.pointmae_reconstruction_loss(jnp.asarray(a), jnp.asarray(b), loss_type))
    with pytest.raises(NotImplementedError):
        tl.pointmae_reconstruction_loss(_t(a), _t(b), "emd")


@pytest.mark.parametrize("smoothing", [0.0, 0.2])
def test_classification_loss_equals_jax(smoothing):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((12, 7)).astype(np.float32)
    labels = rng.integers(0, 7, size=12).astype(np.int32)
    want = jl.classification_loss(jnp.asarray(logits), jnp.asarray(labels), smoothing)
    got = tl.classification_loss(_t(logits), _t(labels).long(), smoothing)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_schedules_equal_jax():
    for epoch in (0, 3.5, 99, 100, 250):
        assert ts.ema_decay_schedule(epoch) == js.ema_decay_schedule(epoch)
        assert ts.loss_weights(epoch, 15) == js.loss_weights(epoch, 15)
    assert ts.effective_lr(1e-3, 128, 2, 4) == js.effective_lr(1e-3, 128, 2, 4)
    got = ts.cosine_warmup_schedule(1e-3, 1e-6, 10, 300, 50)
    want = js.cosine_warmup_schedule(1e-3, 1e-6, 10, 300, 50)
    for step in (0, 1, 499, 500, 501, 7000, 14999):
        assert isinstance(got(step), float)
        _close(got(step), want(step), rtol=1e-12, atol=0)


def test_clip_by_global_norm_is_optax_rule():
    import optax

    rng = np.random.default_rng(6)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,), (2, 2, 2))]
    for max_norm in (0.5, 100.0):  # one that clips, one that leaves the gradients alone
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = _t(g)
        norm = topt.clip_by_global_norm_(params, max_norm)
        want, _ = optax.clip_by_global_norm(max_norm).update(list(map(jnp.asarray, grads)),
                                                             optax.EmptyState())
        _close(norm, optax.global_norm(list(map(jnp.asarray, grads))))
        for p, w in zip(params, want):
            _close(p.grad, w, rtol=1e-6, atol=0)


def test_adamw_groups_decay_only_matrices_and_skip_frozen_modules():
    from gm3d_tpu_torch.models import GM3DStudent

    student = GM3DStudent(trans_dim=48, depth=1, num_heads=2, group_size=8, num_group=16,
                          encoder_dims=48, decoder_depth=1, decoder_num_heads=2)
    opt = topt.build_gm3d_shared_optimizer(student, 1e-3)
    decay, no_decay = opt.param_groups
    assert decay["weight_decay"] == 0.05 and no_decay["weight_decay"] == 0.0
    assert decay["betas"] == (0.9, 0.95) and opt.grad_clip == 5.0
    assert all(p.ndim > 1 for p in decay["params"])
    assert all(p.ndim <= 1 for p in no_decay["params"])
    owned = {id(p) for g in opt.param_groups for p in g["params"]}
    head = getattr(student, topt.GM3D_COORD_HEAD)
    assert all(id(p) not in owned for p in head.parameters())
    rest = [p for n, p in student.named_parameters() if not n.startswith(topt.GM3D_COORD_HEAD)]
    assert all(id(p) in owned for p in rest)
    usual = topt.build_gm3d_shared_optimizer(student, 1e-3, frozen_modules=())
    assert sum(len(g["params"]) for g in usual.param_groups) == len(rest) + 2
    # accumulation wraps the same groups (held against optax.MultiSteps in
    # tests/test_torch_port_accumulation.py)
    accum = topt.build_gm3d_shared_optimizer(student, 1e-3, accum_steps=2)
    assert accum.accum_steps == 2 and accum.inner.grad_clip == 5.0
    assert {id(p) for g in accum.param_groups for p in g["params"]} == owned


def test_ema_update_averages_parameters_and_bn_buffers():
    from gm3d_tpu.train.state import ema_update as jema_update
    from gm3d_tpu_torch.models.blocks import PatchEncoder

    torch.manual_seed(0)
    model = PatchEncoder(16)
    state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=0.1),
                               with_ema=True)
    assert not state.ema.training and all(not p.requires_grad for p in state.ema.parameters())
    before = {k: v.clone() for k, v in state.ema.state_dict().items()}
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.dtype.is_floating_point:
                t.add_(torch.randn_like(t))
            else:
                t.add_(3)
    ema_update(state.ema, model, 0.99)
    new = model.state_dict()
    for key, value in state.ema.state_dict().items():
        if key.endswith("num_batches_tracked"):
            assert int(value) == int(new[key])
            continue
        want = jema_update(jnp.asarray(before[key].numpy()), jnp.asarray(new[key].numpy()),
                           jnp.asarray(0.99, jnp.float32))
        _close(value, want, rtol=1e-6, atol=1e-7)
    ema_update(None, model, 0.99)  # no EMA copy: nothing to do
