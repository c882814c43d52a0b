"""Few-shot folds trained together (``--parallel_folds``) against each fold's
own run (CPU).

  - (a) ``train/finetune.py::make_fold_batched_train_step`` over three folds
    of a small ``PointTransformer`` and a small ``PointM2AEClassifier``, with
    stochastic depth, head dropout, label smoothing and a ``grad_norm_clip``
    that bites in some folds and not in another: after three steps, each
    fold's metrics, AdamW moments, parameters, BatchNorm running statistics
    and evaluation logits against its own ``make_finetune_train_step`` run
    from the same generator. The forward is bit-equal at one torch thread.
    The gradients differ by rounding (vmap's batched backward sums in another
    order), and two things amplify it, which the tolerances state: AdamW's
    step is scale-free, so an element whose gradient is rounding (a bias
    that feeds a train-mode BatchNorm, whose batch mean removes it: its exact
    gradient is 0) moves by up to ``lr`` a step with the rounding's sign; and
    a later step's gradient can differ past rounding where a ReLU or a max
    falls the other way. So the metrics are held to ``TOL_METRIC``, each
    moment to ``TOL_MOMENT`` of its norm plus ``ROUNDING`` of the norm of all
    of the fold's moments (a moment of rounding-driven gradients is itself
    rounding), every parameter element to ``3 * lr`` a step and all but
    ``MAX_ROUNDING_DRIVEN`` of them to a hundredth of ``lr``, the running statistics to ``3 * lr`` a step, and the
    evaluation logits to ``TOL_LOGIT`` (eval mode subtracts the running mean,
    which follows a rounding-driven bias by its momentum only). At several
    torch threads the per-fold forward of the M2AE classifier already differs
    from the batched one: the CPU's product at its coarsest scale, 128 x 384
    by 384 x 384, splits the sum over threads, the batched product does not;
    the head's BatchNorm over a few clouds then amplifies it. At one thread
    both products are equal.
  - (b) the vmap rules of ``gm3d::fps`` and ``gm3d::knn``: index for index
    (and distance for distance) each slice's own call, on any mapped axis,
    with an unmapped query, nested, raising what the op raises.
  - (c) the stacked optimizer's decay groups are the per-fold optimizer's,
    and the clip is each fold's own.
  - (d) drawn stochastic-depth masks give the generator route's output bit
    for bit, and take the same numbers from the generator.
  - (e) no op of the batched steps reaches vmap's per-slice fallback: they
    run with its "performance drop" warnings on, and none may be written.
  - the CLI's batched path raises on folds of unequal size.

Small models only (width 32, depth 2, three folds, three steps).
"""

import numpy as np
import pytest
import torch
from _torch_threads import torch_at_one_thread  # noqa: F401

from gm3d_tpu_torch.cli import fewshot as cli
from gm3d_tpu_torch.models import PointTransformer
from gm3d_tpu_torch.models.blocks import draw_depth_masks
from gm3d_tpu_torch.models.m2ae import PointM2AEClassifier
from gm3d_tpu_torch.ops.fps import fps_indices
from gm3d_tpu_torch.ops.knn import knn_indices
from gm3d_tpu_torch.train import finetune as ft
from gm3d_tpu_torch.train.optim import (ClippedAdamW, FoldClippedAdamW, build_legacy_adamw,
                                        fold_global_norms, global_norm)
from gm3d_tpu_torch.train.state import create_train_state

FOLDS, STEPS, BATCH, NPOINTS, CLASSES = 3, 3, 8, 1024, 3
LR, SMOOTHING = 2e-5, 0.3
TOL_METRIC = 5e-4          # relative: loss and grad_norm; seen up to 9e-5
TOL_MOMENT = 1e-2          # of each moment's norm; seen up to 5e-3
ROUNDING = 1e-5            # of the norm of all of a fold's moments; seen up to 1.1e-6
MAX_ROUNDING_DRIVEN = 0.02  # share of elements off by more than lr / 100; seen under 0.01
TOL_LOGIT = 5e-3           # evaluation logits, absolute (of logits about 1); seen up to 1e-3

# (model, the clip: between the folds' first-step norms at these inputs)
FAMILIES = {
    "PointTransformer": (lambda: PointTransformer(
        trans_dim=32, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=32,
        drop_path_rate=0.3, dropout=0.5, cls_dim=CLASSES), 32.0),
    "PointM2AEClassifier": (lambda: PointM2AEClassifier(
        cls_dim=CLASSES, num_groups=(64, 32, 16), group_sizes=(8, 4, 4),
        encoder_depths=(2, 2, 2), encoder_dims=(16, 32, 32),
        local_radius=(0.32, 0.64, 1.28), num_heads=2, drop_path_rate=0.3), 125.0),
}


def _model(family, fold):
    model = FAMILIES[family][0]()
    model.reset_parameters(torch.Generator().manual_seed(fold))
    return model


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((STEPS, FOLDS, BATCH, NPOINTS, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, (STEPS, FOLDS, BATCH))
    return torch.from_numpy(pts), torch.from_numpy(labels)


FALLBACK = "There is a performance drop because we have not yet implemented the batching rule"


@pytest.fixture
def vmap_fallbacks(capfd):
    """The text of vmap's per-slice fallback warnings written while the test
    runs (they are off by default, and torch writes them to the process's
    stderr, not through ``warnings``), read by calling the fixture."""
    enabled = torch._C._debug_only_are_vmap_fallback_warnings_enabled()
    torch._C._debug_only_display_vmap_fallback_warnings(True)
    capfd.readouterr()
    try:
        yield lambda: [line for line in capfd.readouterr().err.splitlines() if FALLBACK in line]
    finally:
        torch._C._debug_only_display_vmap_fallback_warnings(enabled)


def _moment_gap(got, want, whole):
    """The gap of one moment tensor beyond ``ROUNDING`` of ``whole``, the
    norm of all of the fold's moments of its kind, relative to its own norm."""
    return max(0.0, float((got - want).norm()) - ROUNDING * whole) / float(want.norm())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_fold_batched_step_trains_each_fold_as_its_own_run(family, vmap_fallbacks):
    clip = FAMILIES[family][1]
    pts, labels = _inputs()
    # each fold alone, from its generator
    alone = []
    for fold in range(FOLDS):
        model = _model(family, fold)
        opt = build_legacy_adamw(model.named_parameters(), LR, 0.05, grad_clip=clip)
        state = create_train_state(model, opt)
        step = ft.make_finetune_train_step(model, opt, NPOINTS, SMOOTHING, device="cpu")
        gen = torch.Generator().manual_seed(fold)
        metrics = [step(state, pts[k, fold], labels[k, fold], gen)[1] for k in range(STEPS)]
        alone.append((model, opt, metrics))
    first = [float(m[2][0]["grad_norm"]) for m in alone]
    assert min(first) < clip < max(first), first  # the clip bites in some folds only
    # the folds together
    folded = ft.FoldedModel([_model(family, fold) for fold in range(FOLDS)], "cpu")
    opt = build_legacy_adamw(folded.params.items(), LR, 0.05, grad_clip=clip, fold_axis=True)
    state = create_train_state(folded, opt)
    step = ft.make_fold_batched_train_step(folded, opt, NPOINTS, SMOOTHING, device="cpu")
    gens = [torch.Generator().manual_seed(fold) for fold in range(FOLDS)]
    together = [step(state, pts[k], labels[k], gens)[1] for k in range(STEPS)]
    assert state.step == STEPS
    logits = ft.make_fold_batched_eval_step(folded, NPOINTS, device="cpu")(pts[0])
    assert vmap_fallbacks() == []

    gaps = {"metric": 0.0, "moment": 0.0, "param": 0.0, "buffer": 0.0, "logit": 0.0}
    with torch.no_grad():
        for fold, (model, fold_opt, metrics) in enumerate(alone):
            for k in range(STEPS):
                got = {n: float(v[fold]) for n, v in together[k].items()}
                for name in ("loss", "grad_norm"):
                    rel = abs(got[name] - float(metrics[k][name])) / abs(float(metrics[k][name]))
                    gaps["metric"] = max(gaps["metric"], rel)
                    assert rel <= TOL_METRIC, (fold, k, name, got, metrics[k])
                assert abs(got["acc"] - float(metrics[k]["acc"])) <= 100.0 / BATCH + 1e-9
            off, total = 0, 0
            whole = {key: float(torch.stack([s[key].norm() for s in fold_opt.state.values()])
                                .norm()) for key in ("exp_avg", "exp_avg_sq")}
            for name, p in model.named_parameters():
                q = folded.params[name][fold]
                gap = (p - q).abs()
                gaps["param"] = max(gaps["param"], float(gap.max()))
                assert float(gap.max()) <= 3 * LR * STEPS, name
                off += int((gap > LR / 100).sum())
                total += p.numel()
                if p in fold_opt.state:
                    for key in ("exp_avg", "exp_avg_sq"):
                        rel = _moment_gap(opt.state[folded.params[name]][key][fold],
                                          fold_opt.state[p][key], whole[key])
                        gaps["moment"] = max(gaps["moment"], rel)
                        assert rel <= TOL_MOMENT, (name, key, rel)
                else:  # never had a gradient, as in the batched run
                    assert folded.params[name].grad is None, name
            assert off <= MAX_ROUNDING_DRIVEN * total, (off, total)
            for name, b in model.named_buffers():
                gap = float((b.float() - folded.buffers[name][fold].float()).abs().max())
                gaps["buffer"] = max(gaps["buffer"], gap)
                assert gap <= 3 * LR * STEPS + 1e-5 * float(b.float().abs().max()), name
            want = ft.make_eval_step(model, NPOINTS, device="cpu")(pts[0, fold])
            gaps["logit"] = max(gaps["logit"], float((logits[fold] - want).abs().max()))
            assert torch.allclose(logits[fold], want, rtol=0, atol=TOL_LOGIT)
    print(f"{family}: largest gaps {gaps}")


@pytest.mark.parametrize("in_dim", [0, 1])
def test_the_fps_and_knn_vmap_rules_give_each_slices_answer(in_dim, vmap_fallbacks):
    rng = np.random.default_rng(1)
    clouds = torch.from_numpy(rng.standard_normal((3, 4, 200, 3)).astype(np.float32))
    # grid points: many equal distances, where the first index must win
    clouds[1] = torch.from_numpy(rng.integers(-2, 3, (4, 200, 3)).astype(np.float32))
    queries = torch.from_numpy(rng.standard_normal((3, 4, 24, 3)).astype(np.float32))
    clouds, queries = clouds.movedim(0, in_dim), queries.movedim(0, in_dim)

    def take(t, i):
        return t.select(in_dim, i)

    idx = torch.func.vmap(lambda x: fps_indices(x, 32), in_dims=in_dim)(clouds)
    dist, nn_idx = torch.func.vmap(lambda r, q: knn_indices(r, q, 8, return_dist=True),
                                   in_dims=in_dim)(clouds, queries)
    shared = torch.func.vmap(lambda r: knn_indices(r, take(queries, 0), 8),
                             in_dims=in_dim)(clouds)
    nested = torch.func.vmap(torch.func.vmap(lambda x: fps_indices(x[None], 32)[0]),
                             in_dims=in_dim)(clouds)
    assert vmap_fallbacks() == []
    for i in range(3):
        assert torch.equal(idx[i], fps_indices(take(clouds, i), 32))
        want_dist, want_idx = knn_indices(take(clouds, i), take(queries, i), 8, return_dist=True)
        assert torch.equal(nn_idx[i], want_idx) and torch.equal(dist[i], want_dist)
        assert torch.equal(shared[i], knn_indices(take(clouds, i), take(queries, 0), 8))
    assert torch.equal(nested, idx)
    # KNN's autograd registration holds under the rule: no gradient out
    grad_dist, _ = torch.func.vmap(lambda r, q: knn_indices(r, q, 8, return_dist=True),
                                   in_dims=in_dim)(clouds.clone().requires_grad_(), queries)
    assert not grad_dist.requires_grad
    with pytest.raises(ValueError, match="exceeds the 200 reference points"):
        torch.func.vmap(lambda r, q: knn_indices(r, q, 201), in_dims=in_dim)(clouds, queries)


def test_the_fixture_sees_the_per_slice_fallback(vmap_fallbacks):
    """The fixture of the batched tests sees vmap's fallback: an op without a
    vmap rule reaches it (as FPS or KNN would in (a) without theirs)."""
    lib = torch.library.Library("gm3d_fold_test", "FRAGMENT")
    lib.define("no_rule(Tensor x) -> Tensor")
    lib.impl("no_rule", lambda x: x * 2, "CPU")
    torch.func.vmap(torch.ops.gm3d_fold_test.no_rule)(torch.ones(2, 3))
    assert any("gm3d_fold_test::no_rule" in line for line in vmap_fallbacks())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_stacked_optimizer_decays_and_clips_as_each_folds_own(family):
    models = [_model(family, fold) for fold in range(2)]
    folded = ft.FoldedModel(models, "cpu")
    alone = build_legacy_adamw(models[0].named_parameters(), LR, 0.05)
    stacked = build_legacy_adamw(folded.params.items(), LR, 0.05, fold_axis=True)
    by_id = {id(p): n for n, p in models[0].named_parameters()}
    by_id.update({id(p): n for n, p in folded.params.items()})
    groups = [[({by_id[id(p)] for p in g["params"]}, g["weight_decay"]) for g in o.param_groups]
              for o in (alone, stacked)]
    assert groups[0] == groups[1] and groups[0][0][0] and groups[0][1][0]
    assert any(n.endswith(".bias") for n in groups[1][1][0])
    # without the fold axis, a stacked (F, C) bias would count as 2-d and decay
    flat = build_legacy_adamw(folded.params.items(), LR, 0.05)
    assert any(by_id[id(p)].endswith(".bias") for p in flat.param_groups[0]["params"])
    # the clip: each fold by its own norm, optax's rule
    assert isinstance(stacked, FoldClippedAdamW)
    rng = np.random.default_rng(2)
    for p in folded.params.values():
        p.grad = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
        p.grad[1] *= 1e-4  # fold 1 under the clip, fold 0 over it
    norms = fold_global_norms(p.grad for p in folded.params.values())
    clip = float(norms.mean())
    want = []
    for fold in range(2):
        grads = [p.grad[fold].clone() for p in folded.params.values()]
        assert float(global_norm(grads)) == pytest.approx(float(norms[fold]), rel=1e-6)
        one = ClippedAdamW([{"params": [torch.zeros_like(g, requires_grad=True)
                                        for g in grads]}], grad_clip=clip, lr=LR)
        for q, g in zip(one.param_groups[0]["params"], grads):
            q.grad = g
        one.step()
        want.append([q.grad for q in one.param_groups[0]["params"]])
    clipped = FoldClippedAdamW([{"params": list(folded.params.values())}], grad_clip=clip, lr=LR)
    clipped.step()
    assert torch.equal(clipped.last_grad_norm, norms)
    for fold in range(2):
        for p, w in zip(folded.params.values(), want[fold]):
            assert torch.allclose(p.grad[fold], w, rtol=1e-6, atol=0)
    assert all(torch.equal(p.grad[1], w) for p, w in zip(folded.params.values(), want[1]))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_drawn_depth_masks_give_the_generator_routes_output(family):
    model = _model(family, 0).train()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, NPOINTS, 3))
                         .astype(np.float32))
    head = [torch.ones(4, 256, dtype=torch.bool)] * 2
    g_masks, g_forward = (torch.Generator().manual_seed(5) for _ in range(2))
    masks = draw_depth_masks(g_masks, model.drop_path_encoders(), 4)
    assert sum(len(block) for enc in masks for block in enc) > 0
    with torch.no_grad():
        drawn = model(x, head, depth_masks=masks)
        inside = model(x, head, generator=g_forward)
    assert torch.equal(drawn, inside)
    assert torch.equal(g_masks.get_state(), g_forward.get_state())
    with pytest.raises(ValueError, match="keep masks or a generator"):
        model(x, head)
    # the finetune step's draws end with them: its generator's stream is unchanged
    draws = ft.finetune_draws(torch.Generator().manual_seed(6), model, 4, NPOINTS, NPOINTS)
    gen = torch.Generator().manual_seed(6)
    for key in ("scale", "shift"):
        assert torch.equal(draws[key], ft._uniform(gen, (4, 1, 3), None)
                           * ((3 / 2 - 2 / 3) if key == "scale" else 0.4)
                           + (2 / 3 if key == "scale" else -0.2))
    for mask in draws["dropout"]:
        assert torch.equal(mask, ft._uniform(gen, (4, 256), None) >= 0.5)
    again = draw_depth_masks(gen, model.drop_path_encoders(), 4)
    assert all(torch.equal(a, b) for a, b in zip(torch.utils._pytree.tree_leaves(again),
                                                 torch.utils._pytree.tree_leaves(draws["depth"])))


def test_the_batched_cli_path_refuses_folds_of_unequal_size(monkeypatch, tmp_path):
    real = cli.make_fold_data

    def uneven(args, cfg, fold, npoints):
        train, test = real(args, cfg, fold, npoints)
        if fold == 1:
            train.dataset.num_samples -= 1
        return train, test

    monkeypatch.setattr(cli, "make_fold_data", uneven)
    flags = ["--config", "configs/pointmae/fewshot.yaml", "--synthetic", "--way", "2",
             "--shot", "2", "--folds", "2", "--epochs", "1", "--device", "cpu",
             "--output_dir", str(tmp_path)]
    with pytest.raises(ValueError, match="--no-parallel_folds"):
        cli.main(flags)
