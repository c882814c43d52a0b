"""Gradient accumulation in the port against the JAX package (CPU).

``train/optim.py::MultiSteps`` against ``optax.MultiSteps`` on the same
gradients (the GM3D shared optimizer, the mean; the separated optimizer, the
mean with each half clipped to its own norm; the legacy sum is in
``tests/test_torch_port_teacher.py``), to 1e-6. The GM3D step with
``accum_steps=2`` against the JAX step for four steps from the same weights,
clouds and draws, in usual mode (``none``; ``dino`` and ``ema`` runs of these
small models are chaotic, ROADMAP Queue 3): metrics to the step test's
``rtol=2e-4``; after the first micro-step nothing but the student's BatchNorm
statistics has moved, on either side; after the second, one update, held as
the step test holds its first. The teacher's step with the legacy sum. Then
the port alone: a checkpoint saved inside a window resumes to the unbroken
run's state bit for bit, the separated optimizer's checkpoint round trip, and
``make_multi_step`` against single steps.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_pretrain_step import SMALL, _clouds, _draws, _variables

from gm3d_tpu.models import GM3DStudent as JGM3DStudent
from gm3d_tpu.models import PointMAE as JPointMAE
from gm3d_tpu.train.optim import build_gm3d_separated_optimizer as jbuild_separated
from gm3d_tpu.train.optim import build_gm3d_shared_optimizer as jbuild_shared
from gm3d_tpu.train.optim import build_legacy_adamw as jbuild_legacy_adamw
from gm3d_tpu.train.pretrain import make_gm3d_train_step as jmake_step
from gm3d_tpu.train.pretrain import make_pointmae_train_step as jmake_pointmae_step
from gm3d_tpu.train.state import create_train_state as jcreate_state
from gm3d_tpu_torch.ckpt.checkpoint import restore_checkpoint, save_checkpoint
from gm3d_tpu_torch.ckpt.torch_import import (
    GM3D_STUDENT_MAP,
    POINT_MAE_MAP,
    load_flax_variables,
    load_pretrain_models,
    state_dict_from_flax,
)
from gm3d_tpu_torch.models import GM3DStudent, PointMAE
from gm3d_tpu_torch.train import optim
from gm3d_tpu_torch.train import pretrain as tp
from gm3d_tpu_torch.train.state import create_train_state

B, N, LR = 4, 128, 1e-3
SCALARS = {"keep_ratio": 0.5, "ema_decay": 0.999, "w_mse": 1.0, "w_cd": 1.0}
KEYS = tp.METRIC_KEYS
ACCUM, STEPS = 2, 4



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the other
    test workers' (several times slower under ``pytest -n``); the previous
    count comes back when the module's tests end."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the optimizers


def _gm3d_params():
    """Numpy parameters of the small feature-mode student, in the flax tree."""
    return _variables(JGM3DStudent(mode="feature", **SMALL), 3)["params"]


@pytest.mark.parametrize("kind", ["shared", "separated"])
def test_accumulating_gm3d_optimizers_equal_optax_multisteps(kind):
    """Four micro-steps of ``accum_steps=2`` on the same gradients: the first
    and third move no parameter, the second and fourth update on the mean of
    their window. The gradients are large (norm about 50 a half), so each
    clip acts; ``separated`` clips each half to its own norm, runs the
    loss-prediction half at its own constant rate, and never moves
    ``decoder_pos_embed`` or the two mask tokens (nor decays them)."""
    rng = np.random.default_rng(7)
    params = _gm3d_params()
    student = GM3DStudent(mode="feature", **SMALL)
    student.load_state_dict(state_dict_from_flax({"params": params}, GM3D_STUDENT_MAP),
                            strict=False)
    if kind == "shared":
        tx = jbuild_shared(params, LR, accum_steps=ACCUM)
        optimizer = optim.build_gm3d_shared_optimizer(student, LR, accum_steps=ACCUM)
    else:
        tx = jbuild_separated(params, LR, accum_steps=ACCUM, loss_pred_learning_rate=LR / 4)
        optimizer = optim.build_gm3d_separated_optimizer(student, LR, accum_steps=ACCUM,
                                                         loss_pred_learning_rate=LR / 4)
        assert isinstance(optimizer.inner, optim.SeparatedAdamW)
        assert all(g["lr"] == LR for g in optim.scheduled_param_groups(optimizer))
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    start = {n: p.detach().clone() for n, p in student.named_parameters()}
    before = dict(start)
    for i in range(STEPS):
        grads = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32) * 0.3,
                             params)
        updates, opt_state = update(jax.tree.map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = state_dict_from_flax({"params": grads}, GM3D_STUDENT_MAP)
        for name, p in student.named_parameters():
            p.grad = tgrads[name].clone()
        assert optimizer.step() == (i % ACCUM == ACCUM - 1)
        want = state_dict_from_flax({"params": jax.tree.map(np.asarray, jparams)},
                                    GM3D_STUDENT_MAP)
        for name, p in student.named_parameters():
            got = p.detach()
            if i % ACCUM == 0:
                assert torch.equal(got, before[name]), (i, name)
            np.testing.assert_allclose(got.numpy(), want[name].numpy(), atol=1e-6, rtol=0,
                                       err_msg=f"micro-step {i} {name}")
        before = {n: p.detach().clone() for n, p in student.named_parameters()}
    never = (["decoder_pos_embed.0.weight", "mask_token", "mask_token_loss_pred"]
             if kind == "separated" else [f"{optim.GM3D_COORD_HEAD}.0.weight"])
    for name in never:
        assert torch.equal(before[name], start[name]), name
    assert optimizer.gradient_step == 2


# ---------------------------------------------------------------------------
# the GM3D step


@pytest.fixture(scope="module")
def accumulating():
    """Both steps with ``accum_steps=2``, usual mode, four steps; each side's
    student and EMA after every step."""
    jstudent = JGM3DStudent(mode="usual", **SMALL)
    svars = _variables(jstudent, 0)
    tx = jbuild_shared(svars["params"], LR, accum_steps=ACCUM, frozen_modules=())
    jstate = jcreate_state(jax.tree.map(jnp.asarray, svars), tx, with_ema=True)
    jstep = jmake_step(jstudent, None, tx, mask_ratio=0.6, distill_mode="none",
                       accum_steps=ACCUM, use_fused_embed=True)
    student = GM3DStudent(mode="usual", **SMALL)
    optimizer = optim.build_gm3d_shared_optimizer(student, LR, accum_steps=ACCUM,
                                                  frozen_modules=())
    state = create_train_state(student, optimizer, with_ema=True)
    load_pretrain_models(student, state.ema, None, svars)
    step = tp.make_gm3d_train_step(student, None, optimizer, mask_ratio=0.6,
                                   distill_mode="none", accum_steps=ACCUM, device="cpu")
    jscalars = {k: jnp.asarray(v, jnp.float32) for k, v in SCALARS.items()}
    history, snaps = [], []
    for i in range(STEPS):
        pts, key = _clouds(10 + i), jax.random.key(i)
        jstate, jm = jstep(jstate, None, jnp.asarray(pts), key, jscalars)
        state, m = step(state, torch.from_numpy(pts), None, SCALARS, draws=_draws(key))
        history.append(({k: float(jm[k]) for k in KEYS}, {k: float(m[k]) for k in KEYS}))
        snaps.append((jax.tree.map(np.asarray, jstate.variables()),
                      jax.tree.map(np.asarray, jstate.ema_variables()),
                      copy.deepcopy(student.state_dict()), copy.deepcopy(state.ema.state_dict())))
    return history, snaps, svars


@pytest.mark.parametrize("index", range(STEPS))
def test_accumulating_step_metrics_equal_the_jax_step(accumulating, index):
    want, got = accumulating[0][index]
    for key in KEYS:
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4, atol=1e-7,
                                   err_msg=f"micro-step {index} {key}")


def _named(variables):
    return state_dict_from_flax(variables, GM3D_STUDENT_MAP)


def test_the_first_micro_step_moves_only_batchnorm_statistics(accumulating):
    """Parameters and the whole EMA stay bit-equal to the start on both
    sides; the student's BatchNorm statistics move, and agree to 1e-5."""
    _, snaps, svars = accumulating
    jvars, jema, sd, ema_sd = snaps[0]
    start = _named(svars)
    for name, want in _named(jvars).items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
            assert not torch.equal(sd[name], start[name]), name
        else:
            assert torch.equal(sd[name], start[name]) and torch.equal(want, start[name]), name
    for name, want in _named(jema).items():
        assert torch.equal(ema_sd[name], start[name]) and torch.equal(want, start[name]), name


def test_the_second_micro_step_updates_as_the_jax_step(accumulating):
    """One Adam update of the window's mean gradient (the step test's rule:
    an entry that moved at least 0.9 learning rates agrees to 5e-5, the few
    whose gradient is rounding noise only in size), BatchNorm statistics to
    1e-5, the EMA to 2.5e-6."""
    _, snaps, svars = accumulating
    jvars, jema, sd, ema_sd = snaps[1]
    start = _named(svars)
    unsure = total = 0
    for name, want in _named(jvars).items():
        got, want, first = sd[name].numpy(), want.numpy(), start[name].numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5, err_msg=name)
            continue
        sure = np.abs(want - first) >= 0.9 * LR
        np.testing.assert_allclose(got[sure], want[sure], atol=5e-5, rtol=0, err_msg=name)
        assert np.abs(got - want).max() <= 2 * LR, name
        unsure += int((~sure).sum())
        total += sure.size
    assert unsure < 0.02 * total, (unsure, total)
    for name, want in _named(jema).items():
        np.testing.assert_allclose(ema_sd[name].numpy(), want.numpy(), atol=2.5e-6, rtol=1e-6,
                                   err_msg=name)
        if not name.endswith(("running_mean", "running_var")):
            assert not torch.equal(ema_sd[name], start[name]) or torch.equal(
                sd[name], start[name]), name


def test_the_step_refuses_an_optimizer_of_another_window():
    student = GM3DStudent(**SMALL)
    optimizer = optim.build_gm3d_shared_optimizer(student, LR, accum_steps=ACCUM)
    with pytest.raises(ValueError, match="accumulates 1 micro-batches, the optimizer 2"):
        tp.make_gm3d_train_step(student, None, optimizer, distill_mode="none", device="cpu")


# ---------------------------------------------------------------------------
# the teacher's step


@pytest.fixture(scope="module")
def teacher_accumulating():
    """``make_pointmae_train_step`` with the legacy AdamW summing two
    micro-batches, both sides, four steps."""
    from test_torch_port_teacher import NUM_MASK as PM_NUM_MASK
    from test_torch_port_teacher import _draws as pointmae_draws

    jmodel = JPointMAE(**SMALL)
    pts0 = jnp.zeros((2, N, 3), jnp.float32)
    mask0 = jnp.zeros((2, 16), bool).at[:, :PM_NUM_MASK].set(True)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda key: jmodel.init(key, pts0, mask0, PM_NUM_MASK))(jax.random.key(1)))
    tx = jbuild_legacy_adamw(LR, 0.05, accum_steps=ACCUM)
    jstate = jcreate_state(jax.tree.map(jnp.asarray, variables), tx)
    jstep = jmake_pointmae_step(jmodel, tx, 0.6, "rand", "cdl2")
    model = load_flax_variables(PointMAE(**SMALL), variables, POINT_MAE_MAP)
    optimizer = optim.build_legacy_adamw(model.named_parameters(), LR, 0.05, accum_steps=ACCUM)
    state = create_train_state(model, optimizer)
    step = tp.make_pointmae_train_step(model, optimizer, 0.6, "rand", "cdl2", device="cpu")
    history, after = [], []
    for i in range(STEPS):
        pts = _clouds(20 + i)
        key = jax.random.key(i)
        jstate, jm = jstep(jstate, jnp.asarray(pts), key)
        state, m = step(state, torch.from_numpy(pts), None, draws=pointmae_draws(key))
        history.append(({k: float(jm[k]) for k in tp.POINTMAE_METRIC_KEYS},
                        {k: float(m[k]) for k in tp.POINTMAE_METRIC_KEYS}))
        after.append({n: p.detach().clone() for n, p in model.named_parameters()})
    return history, after, variables


@pytest.mark.parametrize("index", range(STEPS))
def test_accumulating_teacher_step_equals_the_jax_step(teacher_accumulating, index):
    """Loss and this micro-batch's ``grad_norm`` to ``rtol=2e-4``; the
    parameters move on the second and fourth micro-steps only."""
    history, after, variables = teacher_accumulating
    want, got = history[index]
    for key in tp.POINTMAE_METRIC_KEYS:
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4, err_msg=f"{index} {key}")
    before = (state_dict_from_flax(variables, POINT_MAE_MAP) if index == 0
              else after[index - 1])
    moved = any(not torch.equal(after[index][n], before[n]) for n in after[index])
    assert moved == (index % ACCUM == ACCUM - 1)


# ---------------------------------------------------------------------------
# checkpoints inside a window, and the multi-step


def _port_setup(seed=0, accum=ACCUM, separated=False, drop_path=0.0):
    """A small student and EMA with weights from ``seed``, the teacher (always
    the same weights), the optimizer and the step (usual mode for the shared
    optimizer, dino for the separated one)."""
    kwargs = dict(SMALL, drop_path_rate=drop_path)
    mode = "feature" if separated else "usual"
    student, teacher = GM3DStudent(mode=mode, **kwargs), PointMAE(**kwargs)
    student.reset_parameters(torch.Generator().manual_seed(seed))
    teacher.reset_parameters(torch.Generator().manual_seed(100))
    if separated:
        optimizer = optim.build_gm3d_separated_optimizer(student, LR, accum_steps=accum,
                                                         loss_pred_learning_rate=LR / 2)
    else:
        optimizer = optim.build_gm3d_shared_optimizer(student, LR, accum_steps=accum,
                                                      frozen_modules=())
    state = create_train_state(student, optimizer, with_ema=True)
    step = tp.make_gm3d_train_step(student, teacher if separated else None, optimizer,
                                   distill_mode="dino" if separated else "none",
                                   shared_opt=not separated, accum_steps=accum, device="cpu")
    return state, step


def _run(state, step, first, last, gen):
    for i in range(first, last):
        state, _ = step(state, torch.from_numpy(_clouds(30 + i)), gen, SCALARS)
    return state


def _assert_same_state(a, b):
    for x, y in ((a.student.state_dict(), b.student.state_dict()),
                 (a.ema.state_dict(), b.ema.state_dict())):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    flat_a, flat_b = _flat(oa), _flat(ob)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        if isinstance(flat_a[k], torch.Tensor):
            assert torch.equal(flat_a[k], flat_b[k]), k
        else:
            assert flat_a[k] == flat_b[k], k
    assert a.step == b.step


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("separated", [False, True], ids=["shared", "separated"])
def test_a_checkpoint_inside_a_window_resumes_exactly(separated, tmp_path):
    """Three steps of ``accum_steps=2`` with a save after the first (inside a
    window, its running mean not yet applied), restored into freshly built
    models and optimizer: steps 2 and 3 from there give the unbroken run's
    student, EMA, optimizer state (moments, the accumulation, the counts)
    and step, bit for bit. With the separated optimizer (dino, both halves
    in the checkpoint) too. The same generator state is handed over, as the
    CLI's ``--seed`` hands it over on both sides."""
    unbroken, step = _port_setup(separated=separated)
    gen = torch.Generator().manual_seed(5)
    unbroken = _run(unbroken, step, 0, 1, gen)
    assert unbroken.optimizer.mini_step == 1
    assert any(bool(a.abs().sum()) for a in unbroken.optimizer.acc)
    save_checkpoint(str(tmp_path), unbroken, unbroken.step)
    gen_state = gen.get_state()
    unbroken = _run(unbroken, step, 1, 3, gen)

    resumed, step2 = _port_setup(seed=9, separated=separated)
    assert restore_checkpoint(str(tmp_path), resumed) == 1
    assert resumed.optimizer.mini_step == 1
    gen2 = torch.Generator()
    gen2.set_state(gen_state)
    resumed = _run(resumed, step2, 1, 3, gen2)
    assert unbroken.optimizer.gradient_step == resumed.optimizer.gradient_step == 1
    _assert_same_state(unbroken, resumed)


def test_the_separated_optimizer_round_trips_through_a_checkpoint(tmp_path):
    """Without accumulation: both halves' moments and steps, and the two
    learning rates (the recon half scheduled, the loss-prediction half
    constant), restore strictly."""
    state, step = _port_setup(accum=1, separated=True)
    state = _run(state, step, 0, 2, torch.Generator().manual_seed(1))
    for group in optim.scheduled_param_groups(state.optimizer):
        group["lr"] = 0.25 * LR
    save_checkpoint(str(tmp_path), state, state.step)
    other, _ = _port_setup(seed=4, accum=1, separated=True)
    assert restore_checkpoint(str(tmp_path), other) == 2
    _assert_same_state(state, other)
    assert [g["lr"] for g in other.optimizer.param_groups] == [0.25 * LR] * 2 + [LR / 2] * 2
    assert len(other.optimizer.recon.state) > 0 and len(other.optimizer.loss_pred.state) > 0


@pytest.mark.parametrize("family", ["gm3d", "pointmae"])
def test_multi_step_equals_single_steps(family):
    """``make_multi_step`` over three stacked batches and their stacked
    draws: the final state and each step's metrics equal three calls of the
    step, bit for bit."""
    def build():
        if family == "gm3d":
            return _port_setup(accum=1)
        model = PointMAE(**SMALL)
        model.reset_parameters(torch.Generator().manual_seed(0))
        optimizer = optim.build_legacy_adamw(model.named_parameters(), LR)
        step = tp.make_pointmae_train_step(model, optimizer, device="cpu")
        return create_train_state(model, optimizer), step

    pts = torch.from_numpy(np.stack([_clouds(40 + k) for k in range(3)]))
    draws = [_draws(jax.random.key(k)) for k in range(3)]
    stacked = {n: torch.stack([d[n] for d in draws]) for n in draws[0]}
    extra = (SCALARS,) if family == "gm3d" else ()
    single, step = build()
    want = []
    for k in range(3):
        single, m = step(single, pts[k], None, *extra, draws=draws[k])
        want.append(m)
    multi_state, multi_step = build()
    multi = tp.make_multi_step(multi_step, has_scalars=family == "gm3d")
    multi_state, got = multi(multi_state, pts, None, *extra, draws=stacked)
    assert sorted(got) == sorted(want[0])
    for name, values in got.items():
        assert values.shape == (3,)
        assert torch.equal(values, torch.stack([m[name] for m in want])), name
    a, b = single.student.state_dict(), multi_state.student.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert multi_state.step == single.step == 3
