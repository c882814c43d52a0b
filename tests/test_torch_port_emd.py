"""The port's EMD (``gm3d_tpu_torch/ops/emd.py``) and the ``emd`` loss of the
Point-MAE step against the JAX package's, on the CPU.

Sets of 8 - 32 points drawn from a numpy seed. Tolerances: the Sinkhorn loss
``rtol=1e-5``; its gradient 1e-4 of its largest entry (the exponents of the
transport plan reach ``1 / epsilon`` = 200, where one fp32 rounding is 2.4e-5
relative, and 50 rounds of logsumexp sum in other orders); the auction's owners are
held EQUAL index for index, ties included (duplicated points); the Point-MAE
step's loss and ``grad_norm`` to ``rtol=2e-4`` and its parameters after one
step as ``tests/test_torch_port_teacher.py`` holds the ``cdl2`` step's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gm3d_tpu.models import PointMAE as JPointMAE
from gm3d_tpu.ops import emd as jemd
from gm3d_tpu.train.optim import build_legacy_adamw as jbuild_legacy_adamw
from gm3d_tpu.train.pretrain import make_pointmae_train_step as jmake_step
from gm3d_tpu.train.state import create_train_state as jcreate_state
from gm3d_tpu_torch.ckpt.torch_import import POINT_MAE_MAP, load_flax_variables, state_dict_from_flax
from gm3d_tpu_torch.models import PointMAE
from gm3d_tpu_torch.ops import emd
from gm3d_tpu_torch.train.optim import build_legacy_adamw
from gm3d_tpu_torch.train.pretrain import make_pointmae_train_step
from gm3d_tpu_torch.train.state import create_train_state

SMALL = dict(trans_dim=48, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=48,
             decoder_depth=1, decoder_num_heads=2, drop_path_rate=0.0)
B, N, LR = 4, 128, 1e-3
NUM_MASK = int(16 * 0.6)
# biases whose shift a train-mode BatchNorm removes: zero gradient in exact
# arithmetic (``tests/test_torch_port_teacher.py``)
BN_FED_BIASES = ("first_conv.0.bias", "first_conv.3.bias", "second_conv.0.bias")


def _sets(seed, batch, n, dup=1):
    """Two (batch, n, 3) sets; with ``dup`` > 1 each point is repeated
    ``dup`` times, so that costs tie."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((batch, n // dup, 3)).astype(np.float32)
    b = rng.standard_normal((batch, n // dup, 3)).astype(np.float32)
    return np.repeat(a, dup, axis=1), np.repeat(b, dup, axis=1)


@pytest.mark.parametrize("n", [8, 32])
def test_emd_loss_and_its_gradient_equal_jax(n):
    a, b = _sets(n, 6, n)
    want = jax.jit(jemd.emd_loss)(jnp.asarray(a), jnp.asarray(b))
    jgrad = np.asarray(jax.jit(jax.grad(lambda x, y: jnp.sum(jemd.emd_loss(x, y))))(
        jnp.asarray(a), jnp.asarray(b)))
    ta = torch.from_numpy(a).requires_grad_(True)
    got = emd.emd_loss(ta, torch.from_numpy(b))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    got.sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), jgrad, atol=1e-4 * np.abs(jgrad).max(), rtol=0)


@pytest.mark.parametrize("case", ["random_8", "random_16", "random_32", "pairs_16",
                                  "quads_32", "iters_run_out"])
def test_auction_owners_equal_jax_index_for_index(case):
    """Random sets, sets whose points come in pairs or fours (every cost ties
    with another: the lower index must win, as ``lax.top_k`` and ``argmax``
    order them), and 5 rounds, fewer than a full assignment needs (the
    cheapest-row fallback, and a stop that is not a multiple of the port's
    termination test)."""
    kind, n = case.rsplit("_", 1) if case != "iters_run_out" else ("random", "32")
    dup = {"random": 1, "pairs": 2, "quads": 4}[kind]
    iters = 5 if case == "iters_run_out" else 4096
    a, b = _sets(int(n) + dup, 5, int(n), dup)
    jowner, jcost = jemd.emd_auction_assignment(jnp.asarray(a), jnp.asarray(b), iters=iters)
    owner, cost = emd.emd_auction_assignment(torch.from_numpy(a), torch.from_numpy(b),
                                             iters=iters)
    np.testing.assert_array_equal(owner.numpy(), np.asarray(jowner))
    np.testing.assert_allclose(cost.numpy(), np.asarray(jcost), rtol=1e-6, atol=1e-6)
    if case != "iters_run_out":  # a full assignment is a permutation
        assert (np.sort(owner.numpy(), axis=-1) == np.arange(int(n))).all()
    want = np.asarray(jemd.emd_auction(jnp.asarray(a), jnp.asarray(b), iters=iters))
    got = emd.emd_auction(torch.from_numpy(a), torch.from_numpy(b), iters=iters).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_auction_of_one_point_sets():
    a, b = _sets(1, 3, 1)
    owner, cost = emd.emd_auction_assignment(torch.from_numpy(a), torch.from_numpy(b))
    jowner, _ = jemd.emd_auction_assignment(jnp.asarray(a), jnp.asarray(b))
    assert owner.shape == (3, 1) and owner.dtype == torch.int64
    np.testing.assert_array_equal(owner.numpy(), np.asarray(jowner))
    np.testing.assert_allclose(emd.emd_auction(torch.from_numpy(a), torch.from_numpy(b)),
                               cost[:, 0, 0], rtol=0)


def _draws(key):
    """What the JAX Point-MAE step draws from its key, as torch tensors."""
    r_aug, r_mask, _, _ = jax.random.split(key, 4)
    r_scale, r_shift = jax.random.split(r_aug)
    out = {"scale": jax.random.uniform(r_scale, (B, 1, 3), minval=2.0 / 3.0, maxval=3.0 / 2.0),
           "shift": jax.random.uniform(r_shift, (B, 1, 3), minval=-0.2, maxval=0.2),
           "noise": jax.random.uniform(r_mask, (B, 16))}
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def emd_step():
    """One ``loss_type='emd'`` Point-MAE step on both sides from the same
    weights, cloud and draws."""
    jmodel = JPointMAE(**SMALL)
    pts0 = jnp.zeros((2, N, 3), jnp.float32)
    mask0 = jnp.zeros((2, 16), bool).at[:, :NUM_MASK].set(True)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda key: jmodel.init(key, pts0, mask0, NUM_MASK))(jax.random.key(1)))
    tx = jbuild_legacy_adamw(LR, 0.05)
    jstate = jcreate_state(jax.tree.map(jnp.asarray, variables), tx)
    jstep = jmake_step(jmodel, tx, 0.6, "rand", "emd")
    model = load_flax_variables(PointMAE(**SMALL), variables, POINT_MAE_MAP)
    optimizer = build_legacy_adamw(model.named_parameters(), LR, 0.05)
    state = create_train_state(model, optimizer)
    step = make_pointmae_train_step(model, optimizer, 0.6, "rand", "emd", device="cpu")
    pts = np.random.default_rng(10).standard_normal((B, N, 3)).astype(np.float32) * 0.5
    key = jax.random.key(0)
    jstate, jm = jstep(jstate, jnp.asarray(pts), key)
    state, m = step(state, torch.from_numpy(pts), None, draws=_draws(key))
    return jm, m, jax.tree.map(np.asarray, jstate.variables()), variables, model


@pytest.mark.parametrize("key", ["loss", "grad_norm"])
def test_emd_step_metrics_equal_the_jax_step(emd_step, key):
    jm, m = emd_step[0], emd_step[1]
    assert math.isfinite(float(m[key])) and float(m[key]) > 0.0
    np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-4)


def test_emd_step_parameters_after_one_step(emd_step):
    """As ``test_torch_port_teacher.py::test_parameters_and_bn_buffers_after_one_step``:
    Adam's first update is ``lr * g / (|g| + 1e-8)``. An entry that moved by
    at least 0.99 learning rates (a gradient above 1e-6) agrees to 5e-5; the
    others only in size: their gradients are near the 1e-8 of Adam's
    denominator, where the EMD gradient's 1e-4 relative difference (see
    above) already moves the update by several percent, or of rounding-noise
    size (``BN_FED_BIASES``). BN statistics to 1e-5."""
    _, _, jvars, start_vars, model = emd_step
    want = state_dict_from_flax(jvars, POINT_MAE_MAP)
    start = state_dict_from_flax(start_vars, POINT_MAE_MAP)
    got_sd = model.state_dict()
    unsure = total = 0
    for name in want:
        w, g, s = want[name].numpy(), got_sd[name].numpy(), start[name].numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=name)
            continue
        sure = np.abs(w - s) >= 0.99 * LR
        if name.endswith(BN_FED_BIASES):
            sure[:] = False
        np.testing.assert_allclose(g[sure], w[sure], atol=5e-5, rtol=0, err_msg=name)
        assert np.abs(g - w).max() <= 2 * LR, name
        unsure += int((~sure).sum())
        total += sure.size
    assert unsure < 0.02 * total, (unsure, total)
