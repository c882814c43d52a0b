"""The port's GM3D pretrain step against the JAX step, on the CPU.

Both sides start from the same numpy-seeded weights (carried across with
``load_pretrain_models``), see the same clouds and the same random draws: the
draws are made with ``jax.random`` from the step's own key split
(``gm3d_tpu/train/pretrain.py``: ``r_aug, r_mask, ... = split(rng, 4)``) and
handed to the port as numpy. Stochastic depth is 0 on both sides (its two
random streams cannot be matched per block). The JAX step runs with
``use_fused_embed=True``, i.e. its Pallas patch embed in interpret mode.

Tolerances: metrics ``rtol=2e-4`` (fp32, other summation orders, three steps
of Adam in between); parameters after one step ``atol=5e-5`` against a
learning rate of 1e-3 wherever the gradient is not rounding noise (the test
says how that is told).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_at_one_thread  # noqa: F401
from gm3d_tpu.models import GM3DStudent as JGM3DStudent
from gm3d_tpu.models import PointMAE as JPointMAE
from gm3d_tpu.train.optim import build_gm3d_shared_optimizer as jbuild_optimizer
from gm3d_tpu.train.pretrain import make_gm3d_train_step as jmake_step
from gm3d_tpu.train.state import create_train_state as jcreate_state
from gm3d_tpu_torch.ckpt.torch_import import (
    GM3D_STUDENT_MAP,
    load_pretrain_models,
    state_dict_from_flax,
)
from gm3d_tpu_torch.models import GM3DStudent, PointMAE
from gm3d_tpu_torch.train import pretrain as tp
from gm3d_tpu_torch.train.optim import GM3D_COORD_HEAD, build_gm3d_shared_optimizer
from gm3d_tpu_torch.train.state import create_train_state

SMALL = dict(trans_dim=48, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=48,
             decoder_depth=1, decoder_num_heads=2, drop_path_rate=0.0)
B, N, LR = 4, 128, 1e-3
NUM_MASK = 16 - int(16 * (1.0 - 0.6))  # 10
SCALARS = {"keep_ratio": 0.5, "ema_decay": 0.999, "w_mse": 1.0, "w_cd": 1.0}
KEYS = ("loss", "loss_recon", "loss_mse", "loss_chfr", "loss_learn", "grad_norm")


def _variables(jmodel, seed):
    """Numpy variables in the tree ``jmodel.init`` gives. Weights are noise of
    the init's scale, biases, norm scales and running statistics non-trivial.
    conv2's bias of the patch embed stays zero (as flax initialises it): the
    JAX package's Pallas patch embed never adds that bias, so the two steps
    can only agree where it is zero."""
    rng = np.random.default_rng(seed)
    pts = jnp.zeros((B, N, 3), jnp.float32)
    mask = jnp.zeros((B, 16), bool).at[:, :NUM_MASK].set(True)
    shapes = jax.eval_shape(lambda key: jmodel.init(key, pts, mask, NUM_MASK), jax.random.key(0))

    def leaf(path, s):
        noise = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "var":
            return 1.0 + 0.5 * np.abs(noise)
        if name == "kernel":
            return noise / np.sqrt(s.shape[0])
        if name == "bias" and path[-2].key == "conv2":
            return np.zeros(s.shape, np.float32)
        return (1.0 if name == "scale" else 0.0) + 0.1 * noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _draws(key):
    """What the JAX step draws from ``key``, as torch tensors."""
    r_aug, r_mask, _, _ = jax.random.split(key, 4)
    r_scale, r_shift = jax.random.split(r_aug)
    scale = jax.random.uniform(r_scale, (B, 1, 3), minval=2.0 / 3.0, maxval=3.0 / 2.0)
    shift = jax.random.uniform(r_shift, (B, 1, 3), minval=-0.2, maxval=0.2)
    noise = jax.random.uniform(r_mask, (B, 16))
    return {k: torch.from_numpy(np.array(v)) for k, v in
            (("scale", scale), ("shift", shift), ("noise", noise))}


def _clouds(seed):
    return np.random.default_rng(seed).standard_normal((B, N, 3)).astype(np.float32) * 0.5


def _both(distill_mode="dino", steps=1, mode="feature", frozen=True):
    """``frozen``: the coordinate head is left out of the optimizer (both
    sides' default, feature mode); ``False`` is the CLI's usual-mode choice,
    ``frozen_modules=()``."""
    jstudent, jteacher = JGM3DStudent(mode=mode, **SMALL), JPointMAE(**SMALL)
    svars, tvars = _variables(jstudent, 0), _variables(jteacher, 1)
    tx = (jbuild_optimizer(svars["params"], LR) if frozen
          else jbuild_optimizer(svars["params"], LR, frozen_modules=()))
    jstate = jcreate_state(jax.tree.map(jnp.asarray, svars), tx, with_ema=True)
    jstep = jmake_step(jstudent, jteacher, tx, mask_ratio=0.6, distill_mode=distill_mode,
                       use_fused_embed=True)
    student, teacher = GM3DStudent(mode=mode, **SMALL), PointMAE(**SMALL)
    optimizer = (build_gm3d_shared_optimizer(student, LR) if frozen
                 else build_gm3d_shared_optimizer(student, LR, frozen_modules=()))
    state = create_train_state(student, optimizer, with_ema=True)
    load_pretrain_models(student, state.ema, teacher, svars, svars, tvars)
    step = tp.make_gm3d_train_step(student, teacher, optimizer, mask_ratio=0.6,
                                   distill_mode=distill_mode, device="cpu")
    jtvars = jax.tree.map(jnp.asarray, tvars)
    jscalars = {k: jnp.asarray(v, jnp.float32) for k, v in SCALARS.items()}
    history = []
    for i in range(steps):
        pts, key = _clouds(10 + i), jax.random.key(i)
        jstate, jm = jstep(jstate, jtvars, jnp.asarray(pts), key, jscalars)
        state, m = step(state, torch.from_numpy(pts), None, SCALARS, draws=_draws(key))
        history.append(({k: float(jm[k]) for k in KEYS}, {k: float(m[k]) for k in KEYS}))
    return jstate, state, step, history, svars


@pytest.fixture(scope="module")
def dino():
    return _both("dino", steps=3)


@pytest.mark.parametrize("index", [0, 1, 2])
def test_metrics_of_the_first_three_steps_equal_the_jax_step(dino, index):
    want, got = dino[3][index]
    assert sorted(got) == sorted(KEYS)
    for key in KEYS:
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4, err_msg=f"step {index} {key}")


def test_mask_has_the_gm3d_count(dino):
    step = dino[2]
    assert step.num_mask == NUM_MASK
    assert step.last_mask.dtype == torch.bool
    assert step.last_mask.sum(dim=1).tolist() == [NUM_MASK] * B


@pytest.fixture(scope="module")
def one_step():
    return _both("dino", steps=1)


def _leaves(jvariables, module):
    """(name, jax value, torch value) over a module's whole state dict."""
    want = state_dict_from_flax(jax.tree.map(np.asarray, jvariables), GM3D_STUDENT_MAP)
    got = {k: v for k, v in module.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert sorted(want) == sorted(got)
    return [(k, want[k].numpy(), got[k].numpy()) for k in sorted(want)]


def _check_parameters_and_bn_buffers(one_step, frozen_head=True):
    """Adam's first update is ``lr * g / (|g| + 1e-8)``: an entry whose
    gradient is far above 1e-8 moves by one learning rate, and there the two
    sides must agree to ``atol=5e-5``. An entry that moved by less than 0.9
    learning rates has a gradient of rounding-noise size (in exact arithmetic
    it is zero: a bias that feeds a train-mode BatchNorm, for one), its update
    is that noise amplified, and only its size is checked. Such entries must
    be few. BatchNorm running statistics are not Adam's: ``atol=1e-5``.
    ``frozen_head``: the coordinate head is frozen and checked elsewhere."""
    jstate, state, _, _, svars = one_step
    start = state_dict_from_flax(svars, GM3D_STUDENT_MAP)
    moved = unsure = total = 0
    for name, want, got in _leaves(jstate.variables(), state.student):
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5, err_msg=name)
            assert np.abs(got - start[name].numpy()).max() > 1e-4, name
            continue
        if frozen_head and name.startswith(GM3D_COORD_HEAD):
            continue  # frozen: held to equality in its own test
        sure = np.abs(want - start[name].numpy()) >= 0.9 * LR
        np.testing.assert_allclose(got[sure], want[sure], atol=5e-5, rtol=0, err_msg=name)
        assert np.abs(got - want).max() <= 2 * LR, name
        moved += int(sure.any())
        unsure += int((~sure).sum())
        total += sure.size
    assert unsure < 0.02 * total, (unsure, total)
    # nearly every leaf took a step of the learning rate
    assert moved >= 0.9 * len(start) - 6, moved
    assert state.step == 1 and int(jstate.step) == 1


def test_parameters_and_bn_buffers_after_one_step(one_step):
    _check_parameters_and_bn_buffers(one_step)


def _check_ema(one_step):
    jstate, state, _, _, svars = one_step
    start = state_dict_from_flax(svars, GM3D_STUDENT_MAP)
    for name, want, got in _leaves(jstate.ema_variables(), state.ema):
        # the EMA moves by (1 - 0.999) of the student's step (at most two
        # learning rates apart where the gradient is noise, see above)
        np.testing.assert_allclose(got, want, atol=2.5e-6, rtol=1e-6, err_msg=name)
    drift = max(float(np.abs(got - start[name].numpy()).max())
                for name, _, got in _leaves(jstate.ema_variables(), state.ema))
    assert 0 < drift < 1e-3
    assert not state.ema.training and state.student.training


def test_ema_after_one_step(one_step):
    _check_ema(one_step)


@pytest.mark.parametrize("distill_mode, mode, frozen", [
    ("ema", "feature", True), ("none", "feature", True), ("none", "usual", False)])
def test_parameters_bn_buffers_and_ema_after_one_step_in_the_other_modes(
        distill_mode, mode, frozen):
    """The comparisons above for ``ema`` and ``none``, and for the pretrain
    CLI's usual-mode student, whose coordinate head is trained
    (``frozen_modules=()``): there it must move, and agree like the rest."""
    both = _both(distill_mode, steps=1, mode=mode, frozen=frozen)
    _check_parameters_and_bn_buffers(both, frozen_head=frozen)
    _check_ema(both)
    start = state_dict_from_flax(both[4], GM3D_STUDENT_MAP)
    head = f"{GM3D_COORD_HEAD}.0.weight"
    moved = np.abs(both[1].student.state_dict()[head].numpy() - start[head].numpy()).max()
    assert (moved == 0.0) if frozen else (moved > 0.5 * LR), moved


def test_clipped_adamw_step_equals_the_optax_adamw_step():
    """``ClippedAdamW`` against optax's ``clip_by_global_norm`` + ``adamw``
    (``gm3d_tpu/train/optim.py::build_adamw``) on the same gradients, decay
    0.05 and clip 5: a first step whose norm is clipped, a second inside the
    clip, a third with an all-zero gradient. A weight whose gradient is zero
    throughout is still decayed on both sides (its gradient is a zero tensor
    here, not None). Equal to 1e-6."""
    import optax

    from gm3d_tpu.train.optim import build_adamw as jbuild_adamw
    from gm3d_tpu_torch.train.optim import build_adamw

    rng = np.random.default_rng(5)
    shapes = {"w": (6, 4), "b": (4,), "still_w": (3, 5), "still_b": (5,)}
    start = {k: rng.standard_normal(v).astype(np.float32) for k, v in shapes.items()}
    grads = []
    for scale in (3.0, 0.2, 0.0):  # global norms about 15, 1 and 0
        g = {k: (rng.standard_normal(v) * scale).astype(np.float32) for k, v in shapes.items()}
        g["still_w"][:] = 0.0
        g["still_b"][:] = 0.0
        grads.append(g)
    assert optax.global_norm(grads[0]) > 5.0 > optax.global_norm(grads[1])
    tx = jbuild_adamw(LR, 0.05, grad_clip=5.0)
    jparams = {k: jnp.asarray(v) for k, v in start.items()}
    jopt = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in start.items()}
    optimizer = build_adamw(list(params.items()), LR, 0.05, grad_clip=5.0)
    for i, g in enumerate(grads):
        updates, jopt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        optimizer.step()
        np.testing.assert_allclose(float(optimizer.last_grad_norm),
                                   float(optax.global_norm(g)), rtol=1e-6)
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), atol=1e-6,
                                       rtol=0, err_msg=f"step {i} {k}")
    # decay moved the still weight by lr * wd * p a step; the 1-d one is not decayed
    want = start["still_w"] * (1.0 - LR * 0.05) ** 3
    np.testing.assert_allclose(params["still_w"].detach().numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(params["still_b"].detach().numpy(), start["still_b"])


def test_coordinate_head_is_left_untouched_on_both_sides(one_step):
    jstate, state, _, _, svars = one_step
    start = state_dict_from_flax(svars, GM3D_STUDENT_MAP)
    for leaf in ("weight", "bias"):
        name = f"{GM3D_COORD_HEAD}.0.{leaf}"
        np.testing.assert_array_equal(state.student.state_dict()[name].numpy(),
                                      start[name].numpy())
        jleaf = jstate.params["coord_head"]["kernel" if leaf == "weight" else "bias"]
        np.testing.assert_array_equal(
            np.asarray(jleaf).T[..., None] if leaf == "weight" else np.asarray(jleaf),
            start[name].numpy())
    owned = {id(p) for group in state.optimizer.param_groups for p in group["params"]}
    head = getattr(state.student, GM3D_COORD_HEAD)
    assert all(id(p) not in owned for p in head.parameters())


@pytest.mark.parametrize("mode", ["ema", "none"])
def test_other_distill_modes_one_step(mode):
    _, _, _, history, _ = _both(mode, steps=1)
    want, got = history[0]
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4, atol=1e-7,
                                   err_msg=f"{mode} {key}")
    assert (got["loss_chfr"] == 0.0) if mode == "ema" else (got["loss_mse"] == 0.0)


@pytest.mark.parametrize("distill_mode", ["ema", "dino"])
def test_quantize_ema_is_refused_under_ema_and_runs_under_dino(distill_mode):
    """``quantize_ema`` (ported; held against the JAX step in
    ``tests/test_torch_port_quantize.py``): refused with the JAX step's
    ``ValueError`` where the EMA features are targets, a finite step under
    ``dino``."""
    student, teacher = GM3DStudent(**SMALL), PointMAE(**SMALL)
    optimizer = build_gm3d_shared_optimizer(student, LR)
    if distill_mode == "ema":
        with pytest.raises(ValueError, match="quantize_ema is not allowed"):
            tp.make_gm3d_train_step(student, teacher, optimizer, distill_mode="ema",
                                    quantize_ema=True, device="cpu")
        return
    state = create_train_state(student, optimizer, with_ema=True)
    step = tp.make_gm3d_train_step(student, teacher, optimizer, quantize_ema=True, device="cpu")
    _, metrics = step(state, torch.from_numpy(_clouds(3)), torch.Generator().manual_seed(0),
                      SCALARS)
    assert sorted(metrics) == sorted(KEYS) and all(np.isfinite(float(v)) for v in metrics.values())


def test_step_rejects_a_foreign_state_and_unknown_modes():
    student, other = GM3DStudent(**SMALL), GM3DStudent(**SMALL)
    optimizer = build_gm3d_shared_optimizer(student, LR)
    step = tp.make_gm3d_train_step(student, None, optimizer, distill_mode="none", device="cpu")
    foreign = create_train_state(other, build_gm3d_shared_optimizer(other, LR), with_ema=True)
    with pytest.raises(ValueError, match="another student"):
        step(foreign, torch.zeros(B, N, 3), None, SCALARS)
    with pytest.raises(ValueError, match="distill_mode"):
        tp.make_gm3d_train_step(student, None, optimizer, distill_mode="dinov2", device="cpu")
