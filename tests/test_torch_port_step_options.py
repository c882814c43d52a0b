"""The GM3D step's options in the port: ``shared_opt=False``,
``remat_student`` and bf16 compute (CPU).

``shared_opt=False`` in ``dino`` (the separated engine: the loss-prediction
branch detached at the encoder, ``gm3d_separated_loss`` against the
teacher's encoder, two optimizers) against the JAX step for three steps from
the same weights, clouds and draws: metrics to the step test's ``rtol=2e-4``,
parameters after one step as the step test holds them, ``decoder_pos_embed``
and both mask tokens untouched on both sides. ``remat_student`` against the
port's own plain step with drop path on (0.1) and the same generator: equal
bit for bit (the same operations in the same order on the CPU), which only
holds if the recompute draws the same drop-path masks from the step's
generator. bf16 against the JAX bf16 step (its unfused attention: the JAX
package routes attention through its kernel on the TPU only): the first
step's metrics within ``rtol=5e-3``, beside the JAX package's own
fp32-vs-bf16 gap on the same step (2e-4 to 4e-3 for these weights), and
apart from the port's own fp32 step by as much as that gap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_pretrain_step import SMALL, _clouds, _draws, _variables

from gm3d_tpu.models import GM3DStudent as JGM3DStudent
from gm3d_tpu.models import PointMAE as JPointMAE
from gm3d_tpu.train.optim import build_gm3d_separated_optimizer as jbuild_separated
from gm3d_tpu.train.optim import build_gm3d_shared_optimizer as jbuild_shared
from gm3d_tpu.train.pretrain import make_gm3d_train_step as jmake_step
from gm3d_tpu.train.state import create_train_state as jcreate_state
from gm3d_tpu_torch.ckpt.torch_import import (
    GM3D_STUDENT_MAP,
    load_pretrain_models,
    state_dict_from_flax,
)
from gm3d_tpu_torch.models import GM3DStudent, PointMAE
from gm3d_tpu_torch.train import optim
from gm3d_tpu_torch.train import pretrain as tp
from gm3d_tpu_torch.train.state import create_train_state

LR = 1e-3
SCALARS = {"keep_ratio": 0.5, "ema_decay": 0.999, "w_mse": 1.0, "w_cd": 1.0}
KEYS = tp.METRIC_KEYS
FROZEN_WHEN_SEPARATED = ("decoder_pos_embed", "mask_token", "mask_token_loss_pred")


def _jax_run(steps, shared_opt=True, dtype=jnp.float32):
    """The JAX step in dino from the step test's weights: per-step metrics,
    the student's and the EMA's variables after the first step, the start
    variables."""
    jstudent = JGM3DStudent(mode="feature", dtype=dtype, **SMALL)
    jteacher = JPointMAE(dtype=dtype, **SMALL)
    svars = _variables(JGM3DStudent(mode="feature", **SMALL), 0)
    tvars = _variables(JPointMAE(**SMALL), 1)
    tx = (jbuild_shared(svars["params"], LR) if shared_opt
          else jbuild_separated(svars["params"], LR, loss_pred_learning_rate=LR))
    jstate = jcreate_state(jax.tree.map(jnp.asarray, svars), tx, with_ema=True)
    jstep = jmake_step(jstudent, jteacher, tx, mask_ratio=0.6, distill_mode="dino",
                       shared_opt=shared_opt, use_fused_embed=True)
    jscalars = {k: jnp.asarray(v, jnp.float32) for k, v in SCALARS.items()}
    history = []
    for i in range(steps):
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, tvars), jnp.asarray(_clouds(10 + i)),
                          jax.random.key(i), jscalars)
        history.append({k: float(m[k]) for k in KEYS})
        if i == 0:
            first = tuple(state_dict_from_flax(jax.tree.map(np.asarray, v), GM3D_STUDENT_MAP)
                          for v in (jstate.variables(), jstate.ema_variables()))
    return history, first, svars, tvars


def _port_run(svars, tvars, steps, shared_opt=True, dtype=torch.float32, fused=True):
    student = GM3DStudent(mode="feature", dtype=dtype, **SMALL)
    teacher = PointMAE(dtype=dtype, **SMALL)
    optimizer = (optim.build_gm3d_shared_optimizer(student, LR) if shared_opt
                 else optim.build_gm3d_separated_optimizer(student, LR,
                                                           loss_pred_learning_rate=LR))
    state = create_train_state(student, optimizer, with_ema=True)
    load_pretrain_models(student, state.ema, teacher, svars, svars, tvars)
    step = tp.make_gm3d_train_step(student, teacher, optimizer, mask_ratio=0.6,
                                   distill_mode="dino", shared_opt=shared_opt,
                                   use_fused_attention=fused, device="cpu")
    history = []
    for i in range(steps):
        state, m = step(state, torch.from_numpy(_clouds(10 + i)), None, SCALARS,
                        draws=_draws(jax.random.key(i)))
        history.append({k: float(m[k]) for k in KEYS})
        if i == 0:
            first = tuple({k: v.clone() for k, v in model.state_dict().items()}
                          for model in (student, state.ema))
    return history, state, first



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
# --no-shared_opt


@pytest.fixture(scope="module")
def separated():
    jhist, jfirst, svars, tvars = _jax_run(3, shared_opt=False)
    hist, state, first = _port_run(svars, tvars, 3, shared_opt=False)
    return jhist, hist, jfirst, first, svars, state


@pytest.mark.parametrize("index", [0, 1, 2])
def test_separated_step_metrics_equal_the_jax_step(separated, index):
    want, got = separated[0][index], separated[1][index]
    for key in KEYS:
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4, err_msg=f"{index} {key}")


def test_separated_step_parameters_after_one_step(separated):
    """An entry that moved at least 0.9 learning rates on the JAX side
    agrees to 5e-5 (the step test's rule; entries whose gradient is rounding
    noise, few, only in size); BatchNorm statistics to 1e-5. Both halves
    moved; ``decoder_pos_embed`` and both mask tokens are untouched on both
    sides; the EMA agrees to 2.5e-6."""
    _, _, (want, jema), (got, ema), svars, state = separated
    start = state_dict_from_flax(svars, GM3D_STUDENT_MAP)
    unsure = total = 0
    moved = {"recon": False, "loss_pred": False}
    labels = optim.gm3d_separated_labels(state.student)
    for name, w in want.items():
        g, w, s = got[name].numpy(), w.numpy(), start[name].numpy()
        if name.startswith(FROZEN_WHEN_SEPARATED):
            np.testing.assert_array_equal(g, s, err_msg=name)
            np.testing.assert_array_equal(w, s, err_msg=name)
            continue
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=name)
            continue
        sure = np.abs(w - s) >= 0.9 * LR
        np.testing.assert_allclose(g[sure], w[sure], atol=5e-5, rtol=0, err_msg=name)
        assert np.abs(g - w).max() <= 2 * LR, name
        unsure += int((~sure).sum())
        total += sure.size
        if sure.any():
            moved[labels[name]] = True
    assert unsure < 0.02 * total, (unsure, total)
    assert moved == {"recon": True, "loss_pred": True}
    for name, w in jema.items():
        np.testing.assert_allclose(ema[name].numpy(), w.numpy(), atol=2.5e-6, rtol=1e-6,
                                   err_msg=name)


def test_separated_dino_needs_the_feature_student():
    """``gm3d_tpu/train/pretrain.py:214-224``: the separated loss reads
    decoder features, which a usual-mode student does not give."""
    student = GM3DStudent(mode="usual", **SMALL)
    optimizer = optim.build_gm3d_separated_optimizer(student, LR)
    with pytest.raises(ValueError, match="requires mode='feature'"):
        tp.make_gm3d_train_step(student, PointMAE(**SMALL), optimizer, distill_mode="dino",
                                shared_opt=False, device="cpu")


# ---------------------------------------------------------------------------
# remat_student


@pytest.mark.parametrize("shared_opt, accum", [(True, 1), (False, 2)],
                         ids=["shared", "separated-accumulating"])
def test_remat_step_equals_the_plain_step(shared_opt, accum):
    """Three dino steps with drop path 0.1 and the step's own generator
    (seed 3), remat against plain from the same weights: metrics, the
    student's parameters and BatchNorm statistics, the EMA and the
    generator's state after the run, all equal."""
    kwargs = dict(SMALL, drop_path_rate=0.1)

    def run(remat):
        student, teacher = GM3DStudent(mode="feature", **kwargs), PointMAE(**kwargs)
        student.reset_parameters(torch.Generator().manual_seed(0))
        teacher.reset_parameters(torch.Generator().manual_seed(1))
        optimizer = (optim.build_gm3d_shared_optimizer(student, LR, accum_steps=accum)
                     if shared_opt else
                     optim.build_gm3d_separated_optimizer(student, LR, accum_steps=accum))
        state = create_train_state(student, optimizer, with_ema=True)
        step = tp.make_gm3d_train_step(student, teacher, optimizer, shared_opt=shared_opt,
                                       accum_steps=accum, remat_student=remat, device="cpu")
        gen = torch.Generator().manual_seed(3)
        history = []
        for i in range(3):
            state, m = step(state, torch.from_numpy(_clouds(50 + i)), gen, SCALARS)
            history.append(m)
        return history, state, gen.get_state()

    plain, remat = run(False), run(True)
    for want, got in zip(plain[0], remat[0]):
        for key in KEYS:
            assert torch.equal(got[key], want[key]), key
    for a, b in ((plain[1].student, remat[1].student), (plain[1].ema, remat[1].ema)):
        sa, sb = a.state_dict(), b.state_dict()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(plain[2], remat[2])


# ---------------------------------------------------------------------------
# bf16


@pytest.fixture(scope="module")
def bf16_runs():
    j32, _, svars, tvars = _jax_run(1)
    j16, _, _, _ = _jax_run(3, dtype=jnp.bfloat16)
    p32, _, _ = _port_run(svars, tvars, 1)
    fused, state, _ = _port_run(svars, tvars, 3, dtype=torch.bfloat16)
    unfused, _, _ = _port_run(svars, tvars, 1, dtype=torch.bfloat16, fused=False)
    return (j32, j16), (p32, {"fused": fused, "unfused": unfused}), state


def _departure(a: dict, b: dict) -> dict:
    return {k: abs(a[k] - b[k]) / abs(b[k]) for k in KEYS}


@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_bf16_step_equals_the_jax_bf16_step(bf16_runs, route):
    """The first step's metrics within ``rtol=5e-3`` of the JAX bf16 step,
    through the fused attention route (the plain version here: fp32 sums of
    bf16 operands, as the card's kernel takes them) and through the unfused
    modules. The scale: the JAX package's own fp32 and bf16 steps part by
    2e-4 to 4e-3 on these metrics.

    That bound alone would pass a port that computed in fp32, so the port's
    bf16 step must also part from its own fp32 step (same weights, same
    draws; a step that ignored the dtype gives those metrics bit for bit) as
    the JAX package's pair parts: by a median of at least 1e-4 over the six
    metrics. Nearer the JAX bf16 step than the JAX fp32 one, metric by
    metric, is not asked: two bf16 computations that round in another order
    part by as much as bf16 and fp32 do (the teacher's features alone: 0.04
    between the packages' bf16 routes, 0.036 from fp32). Later steps: finite."""
    (j32, j16), (p32, port), _ = bf16_runs
    got = port[route]
    gap = _departure(j32[0], j16[0])
    assert np.median(list(gap.values())) >= 1e-4, gap
    departure = _departure(got[0], p32[0])
    assert np.median(list(departure.values())) >= 1e-4, departure
    for key in KEYS:
        np.testing.assert_allclose(got[0][key], j16[0][key], rtol=5e-3,
                                   err_msg=f"{route} {key}; fp32-vs-bf16 gap {gap}")
    assert all(np.isfinite(m[k]) for m in got for k in KEYS)


def test_bf16_keeps_parameters_ema_and_optimizer_state_in_fp32(bf16_runs):
    state = bf16_runs[2]
    assert state.student.compute_dtype == torch.bfloat16
    tensors = [*state.student.state_dict().values(), *state.ema.state_dict().values()]
    for slot in state.optimizer.state.values():
        tensors += [t for t in slot.values() if t.ndim]
    assert all(t.dtype in (torch.float32, torch.int64) for t in tensors)
    assert len(state.optimizer.state) > 0
