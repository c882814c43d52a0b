"""The port's classification finetune against the JAX package's (CPU).

``gm3d_tpu_torch.train.finetune``, the finetune optimizer of
``train/optim.py``, ``eval/metrics.py`` and the ScanObjectNN readers, each
against its JAX counterpart on the same numpy inputs, with the same weights
carried across by ``state_dict_from_flax``:

  - layer-decay scales equal name by name, at depth 2 and depth 12;
  - the finetune optimizer equal to optax over 3 updates (to 1e-6), with and
    without its clip, and under ``accum_steps=2``;
  - the train step equal to ``make_finetune_train_step`` over 3 steps (to
    ``rtol=2e-4``, ROADMAP's bound) on clouds larger than ``point_all``
    (2048 points, ``npoints`` 1024), so that FPS and the subsample run. The
    JAX step runs eagerly (``jax.disable_jit``), which lets the test record
    the head's two dropout keep masks it draws; they, its subsample noise,
    scale and shift are handed to the port. Stochastic depth is 0 on both
    sides, as ``tests/test_finetune_trajectory.py`` has it for the reference;
  - the eval and vote steps' logits to 1e-5, the vote's draws injected;
  - ``accuracy``, ``point_all_for``, ``floor_reps``, the multi-step loop;
  - ``ScanObjectNN`` and ``ScanObjectNN_hardest`` item for item on tiny
    ``.h5`` files, train-split shuffles included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gm3d_tpu.data import datasets as jdatasets
from gm3d_tpu.eval.metrics import accuracy as jaccuracy
from gm3d_tpu.models.point_transformer import PointTransformer as JPointTransformer
from gm3d_tpu.train import finetune as jft
from gm3d_tpu.train.optim import build_finetune_optimizer as jbuild_finetune_optimizer
from gm3d_tpu.train.optim import layerwise_lr_decay_scales as jscales
from gm3d_tpu.train.state import create_train_state as jcreate_state
from gm3d_tpu_torch.ckpt.torch_import import POINT_TRANSFORMER_MAP, state_dict_from_flax
from gm3d_tpu_torch.data import datasets
from gm3d_tpu_torch.eval.metrics import accuracy
from gm3d_tpu_torch.models import PointTransformer
from gm3d_tpu_torch.train import finetune as ft
from gm3d_tpu_torch.train.optim import build_finetune_optimizer, layerwise_lr_decay_scales
from gm3d_tpu_torch.train.optim import set_scheduled_lr
from gm3d_tpu_torch.train.state import create_train_state

SMALL = dict(trans_dim=32, depth=2, num_heads=2, cls_dim=5, group_size=8, num_group=16,
             encoder_dims=32, drop_path_rate=0.0)
B, NPOINTS, LR, WD = 4, 1024, 1e-3, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with the other
    test workers' (several times slower under ``pytest -n``); the previous
    count comes back when the module's tests end."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variables(seed, **kw):
    """Numpy variables in the tree ``PointTransformer.init`` gives: weights
    noise of the init's scale, biases, norm scales and running statistics
    non-trivial."""
    rng = np.random.default_rng(seed)
    jmodel = JPointTransformer(**{**SMALL, **kw})
    shapes = jax.eval_shape(lambda key: jmodel.init(key, jnp.zeros((2, 64, 3))),
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
    model = PointTransformer(**{**SMALL, **kw})
    sd = state_dict_from_flax(variables, POINT_TRANSFORMER_MAP)
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = value
    model.load_state_dict(sd, strict=True)
    return model


def _torch_named(tree) -> dict:
    """A flax ``params`` tree of numbers or arrays under the reference's torch
    names, in torch's layout (``state_dict_from_flax``)."""
    return state_dict_from_flax({"params": jax.tree.map(np.asarray, tree)},
                                POINT_TRANSFORMER_MAP)


def _clouds(seed, n=2048):
    return np.random.default_rng(seed).standard_normal((B, n, 3)).astype(np.float32) * 0.5


# ---------------------------------------------------------------------------
# the finetune optimizer


@pytest.mark.parametrize("depth", [2, 12])
def test_layer_decay_scales_equal_the_jax_scales_name_by_name(depth):
    params = _variables(0, depth=depth)["params"]
    want = _torch_named(jax.tree.map(lambda s, x: np.full(np.shape(x), s, np.float64),
                                     jscales(params, 0.75), params))
    names = [n for n, _ in PointTransformer(**{**SMALL, "depth": depth}).named_parameters()]
    got = layerwise_lr_decay_scales(names, 0.75)
    assert sorted(got) == sorted(want)
    for name in names:
        assert float(want[name].unique()) == pytest.approx(got[name], rel=1e-6), name
    # the reference's effective ids: cls_token near-frozen, the stem at full rate
    assert got["cls_token"] == pytest.approx(0.75 ** 12)
    assert got["blocks.blocks.0.attn.qkv.weight"] == pytest.approx(0.75 ** 11)
    assert got[f"blocks.blocks.{depth - 1}.mlp.fc2.bias"] == pytest.approx(
        0.75 ** (12 - depth))
    for stem in ("encoder.first_conv.0.weight", "pos_embed.0.weight", "cls_pos", "norm_p.weight",
                 "cls_head_finetune.8.weight"):
        assert got[stem] == 1.0
    # a hierarchical (Point-M2AE) name set takes the cumulative block ids
    # (held against the JAX scales in tests/test_torch_port_m2ae.py)
    assert layerwise_lr_decay_scales(
        ["encoder.stage0.blocks.1.attn.qkv.weight", "encoder.pos0.0.weight", "norm0.weight"],
        0.75) == {"encoder.stage0.blocks.1.attn.qkv.weight": 0.75,
                  "encoder.pos0.0.weight": 0.75 ** 3, "norm0.weight": 1.0}


OPTIMIZER_CASES = {"layer decay": dict(), "layer decay and clip": dict(grad_clip=0.05),
                   "accumulation 2": dict(accum_steps=2)}


@pytest.mark.parametrize("case", list(OPTIMIZER_CASES))
def test_the_finetune_optimizer_equals_optax(case):
    kw = OPTIMIZER_CASES[case]
    accum = kw.get("accum_steps", 1)
    params = jax.tree.map(jnp.asarray, _variables(1)["params"])

    def sched(count):
        return LR * (count + 1) / 3.0

    tx = jbuild_finetune_optimizer(params, sched, WD, layer_decay=0.75, **kw)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    model = _port_model(_variables(1))
    named = dict(model.named_parameters())
    optimizer = build_finetune_optimizer(model.named_parameters(), sched(0), WD,
                                         layer_decay=0.75, **kw)
    assert {g["lr_scale"] for g in optimizer.param_groups} == {
        0.75 ** k for k in (12, 11, 10, 0)}
    rng = np.random.default_rng(2)
    for micro in range(3 * accum):
        grads = jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(np.shape(x)).astype(np.float32) * 0.1), params)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, g in _torch_named(grads).items():
            named[name].grad = g.clone()
        set_scheduled_lr(optimizer, sched(micro // accum))
        optimizer.step()
        want = _torch_named(params)
        for name, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"{case} micro-step {micro} {name}")


def test_one_rate_for_all_groups_would_undo_the_layer_decay():
    model = PointTransformer(**SMALL)
    optimizer = build_finetune_optimizer(model.named_parameters(), 1.0, layer_decay=0.75)
    set_scheduled_lr(optimizer, 2e-3)
    rates = [g["lr"] / g["lr_scale"] for g in optimizer.param_groups]
    assert rates == pytest.approx([2e-3] * len(rates))
    assert min(g["lr"] for g in optimizer.param_groups) == pytest.approx(2e-3 * 0.75 ** 12)
    # decay on >=2-d parameters only, never scaled again
    assert {g["weight_decay"] for g in optimizer.param_groups} == {0.0, 0.05}
    flat = build_finetune_optimizer(model.named_parameters(), 1.0, layer_decay=None)
    assert {g["lr_scale"] for g in flat.param_groups} == {1.0}


# ---------------------------------------------------------------------------
# the steps


def _jax_step_draws(key, total, model):
    """What the JAX train step draws from ``key`` besides dropout (its
    ``r_sub, r_aug, r_drop, r_dp = split(key, 4)``)."""
    r_sub, r_aug, _, _ = jax.random.split(key, 4)
    r_scale, r_shift = jax.random.split(r_aug)
    out = {"noise": jax.random.uniform(r_sub, (B, total)),
           "scale": jax.random.uniform(r_scale, (B, 1, 3), minval=2.0 / 3.0, maxval=3.0 / 2.0),
           "shift": jax.random.uniform(r_shift, (B, 1, 3), minval=-0.2, maxval=0.2)}
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _recording_bernoulli(recorded: dict):
    """``jax.random.bernoulli`` that also hands each mask it draws to the host,
    as ``recorded[i]`` for the i-th call made while tracing (the head's two
    dropouts, in order)."""
    bernoulli = jax.random.bernoulli
    calls = [0]

    def draw(*args, **kwargs):
        mask, i = bernoulli(*args, **kwargs), calls[0]
        calls[0] += 1
        jax.debug.callback(lambda m, i=i: recorded.__setitem__(i, np.asarray(m)), mask)
        return mask

    return draw


def _load_jax_state(model, jstate):
    """The JAX state's parameters and BatchNorm statistics into ``model``."""
    sd = state_dict_from_flax(jax.tree.map(np.asarray, jstate.variables()),
                              POINT_TRANSFORMER_MAP)
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = value
    model.load_state_dict(sd, strict=True)


def test_train_step_equals_the_jax_step_over_three_steps(monkeypatch):
    """Three steps, each from the JAX state the step before left: metrics to
    ``rtol=2e-4``, then parameters and BatchNorm statistics after the step to
    5e-5. Plain SGD on both sides (lr 1e-2): with AdamW a step's update is
    about lr * sign(g), and the many entries whose gradient is rounding noise
    (train-mode BatchNorm makes several sets exactly zero) move by +-lr in
    each package differently; the max-pools then pick other points, and three
    such steps part by more than the tolerance (``tests/
    test_torch_port_finetune_cli.py`` measures it on the port alone). The
    finetune optimizer is held to optax above, on given gradients."""
    variables = _variables(3)
    jmodel = JPointTransformer(**SMALL)
    tx = optax.sgd(1e-2)
    jstate = jcreate_state(jax.tree.map(jnp.asarray, variables), tx)
    recorded = {}
    monkeypatch.setattr(jax.random, "bernoulli", _recording_bernoulli(recorded))
    jstep = jft.make_finetune_train_step(jmodel, tx, NPOINTS, smoothing=0.1)
    model = _port_model(variables)
    optimizer = torch.optim.SGD(model.parameters(), lr=1e-2)
    state = create_train_state(model, optimizer)
    step = ft.make_finetune_train_step(model, optimizer, NPOINTS, smoothing=0.1, device="cpu")
    rng = np.random.default_rng(4)
    for i in range(3):
        pts = _clouds(20 + i)
        labels = rng.integers(0, SMALL["cls_dim"], B)
        key = jax.random.key(i)
        _load_jax_state(model, jstate)
        recorded.clear()
        jstate, jm = jstep(jstate, jnp.asarray(pts), jnp.asarray(labels), key)
        jax.effects_barrier()
        assert sorted(recorded) == [0, 1] and recorded[0].shape == (B, 256)
        draws = _jax_step_draws(key, 1200, model)
        draws["dropout"] = tuple(torch.from_numpy(recorded[j].copy()) for j in (0, 1))
        state, m = step(state, torch.from_numpy(pts), torch.from_numpy(labels), None,
                        draws=draws)
        for k in ft.METRIC_KEYS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-4,
                                       err_msg=f"step {i} {k}")
        want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.variables()),
                                    POINT_TRANSFORMER_MAP)
        got = model.state_dict()
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=5e-5,
                                       err_msg=f"step {i} {name}")
    assert state.step == 3


def test_a_step_without_draws_takes_them_all_from_its_generator():
    """``finetune_draws`` draws what the step would: the same generator state
    gives the same step, whether the draws are made first or inside."""
    results = []
    for explicit in (False, True):
        model = _port_model(_variables(5, dropout=0.5))
        optimizer = build_finetune_optimizer(model.named_parameters(), LR, WD)
        state = create_train_state(model, optimizer)
        step = ft.make_finetune_train_step(model, optimizer, NPOINTS, device="cpu")
        gen = torch.Generator().manual_seed(7)
        pts, labels = torch.from_numpy(_clouds(30)), torch.arange(B) % SMALL["cls_dim"]
        draws = ft.finetune_draws(gen, model, B, 2048, NPOINTS) if explicit else None
        _, m = step(state, pts, labels, gen, draws=draws)
        results.append((float(m["loss"]), [p.detach().clone() for p in model.parameters()]))
    assert results[0][0] == results[1][0]
    assert all(torch.equal(a, b) for a, b in zip(results[0][1], results[1][1]))


def test_eval_step_logits_equal_the_jax_eval_step():
    variables = _variables(6)
    want = jft.make_eval_step(JPointTransformer(**SMALL), NPOINTS)(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(_clouds(40)))
    model = _port_model(variables).train()
    got = ft.make_eval_step(model, NPOINTS, device="cpu")(torch.from_numpy(_clouds(40)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert model.training  # its mode comes back


def test_vote_step_logits_equal_the_jax_vote_step():
    variables = _variables(8)
    times, total = 10, 1200
    key = jax.random.key(9)
    want = jft.make_vote_eval_step(JPointTransformer(**SMALL), NPOINTS, times)(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(_clouds(50)), key)
    noise, scale, shift = [], [], []
    for r in jax.random.split(key, times):
        r_sub, r_aug = jax.random.split(r)
        r_scale, r_shift = jax.random.split(r_aug)
        noise.append(jax.random.uniform(r_sub, (B, total)))
        scale.append(jax.random.uniform(r_scale, (B, 1, 3), minval=2.0 / 3.0, maxval=1.5))
        shift.append(jax.random.uniform(r_shift, (B, 1, 3), minval=-0.2, maxval=0.2))
    draws = {k: torch.from_numpy(np.stack(v)) for k, v in
             (("noise", noise), ("scale", scale), ("shift", shift))}
    model = _port_model(variables)
    vote = ft.make_vote_eval_step(model, NPOINTS, times, device="cpu")
    got = vote(torch.from_numpy(_clouds(50)), None, draws=draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # drawn from a generator, the ten votes differ from one another
    gen = torch.Generator().manual_seed(0)
    assert not torch.equal(vote(torch.from_numpy(_clouds(50)), gen), got)


def test_the_multi_step_loop_is_its_steps_in_order():
    runs = []
    for multi in (False, True):
        model = _port_model(_variables(10))
        optimizer = build_finetune_optimizer(model.named_parameters(), LR, WD)
        state = create_train_state(model, optimizer)
        step = ft.make_finetune_train_step(model, optimizer, NPOINTS, device="cpu")
        gen = torch.Generator().manual_seed(3)
        pts = torch.from_numpy(np.stack([_clouds(60, 1024), _clouds(61, 1024)]))
        labels = torch.arange(2 * B).reshape(2, B) % SMALL["cls_dim"]
        if multi:
            _, m = ft.make_finetune_multi_step(step)(state, pts, labels, gen)
        else:
            ms = [step(state, pts[k], labels[k], gen)[1] for k in range(2)]
            m = {n: torch.stack([x[n] for x in ms]) for n in ms[0]}
        runs.append(m)
    assert state.step == 2
    for n in ft.METRIC_KEYS:
        assert runs[0][n].shape == (2,) and torch.equal(runs[0][n], runs[1][n])


def test_accuracy_point_all_and_floor_reps_equal_the_jax_functions():
    rng = np.random.default_rng(11)
    logits, labels = rng.standard_normal((37, 40)), rng.integers(0, 40, 37)
    labels[:9] = logits[:9].argmax(-1)
    assert accuracy(logits, labels) == jaccuracy(logits, labels)
    for n in (1024, 2048, 4096, 8192):
        assert ft.point_all_for(n) == jft.point_all_for(n)
    for fn in (ft.point_all_for, jft.point_all_for):
        with pytest.raises(ValueError, match="npoints"):
            fn(1000)
    # the JAX floor tiles small batches for a TPU compiler; the port never does
    assert jft.floor_reps(32, 64) == 2 and ft.floor_reps(32, 64) == 1


# ---------------------------------------------------------------------------
# the ScanObjectNN readers


@pytest.mark.parametrize("name", ["ScanObjectNN", "ScanObjectNN_hardest"])
def test_scanobjectnn_readers_equal_the_jax_readers(name, tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(12)
    stem = "objectdataset" if name == "ScanObjectNN" else "objectdataset_augmentedrot_scale75"
    for split, n in (("training", 6), ("test", 3)):
        with h5py.File(tmp_path / f"{split}_{stem}.h5", "w") as f:
            f["data"] = rng.standard_normal((n, 64, 3)).astype(np.float64)
            f["label"] = rng.integers(0, 15, n).astype(np.uint8)
    for subset, n in (("train", 6), ("test", 3)):
        cfg = {"_base_": {"NAME": name, "ROOT": str(tmp_path)}, "others": {"subset": subset}}
        got, want = datasets.build_dataset_from_cfg(cfg), jdatasets.build_dataset_from_cfg(cfg)
        assert type(got).__name__ == type(want).__name__ and len(got) == len(want) == n
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            for i in range(n):
                g, w = got[i], want[i]
                assert g[:2] == w[:2] and g[2][1] == w[2][1]
                assert g[2][0].dtype == np.float32 and np.array_equal(g[2][0], w[2][0])
        if subset == "train":  # each epoch shuffles each cloud's points anew
            got.set_epoch(0)
            first = got[0][2][0]
            got.set_epoch(1)
            assert not np.array_equal(first, got[0][2][0])
