"""The port's offline evaluation and visualisation against the JAX package's (CPU).

Each module of the slice against its counterpart in ``gm3d_tpu``, from the
same numpy inputs (seeded) and the same weights (the JAX init's, carried
across with ``load_flax_variables``): ``utils/ply.py`` (the same files byte
for byte), ``utils/plot_logs.py``, ``eval/knn.py`` (equal accuracy),
``eval/linear_probe.py`` (``LARS`` within 1e-6 of the JAX ``lars`` over 5
steps; the probe from one head: equal best accuracy, the head within 1e-5
after 3 epochs), ``eval/visualize.py`` (the same vertices and colours within
1e-5), then ``cli/evaluate.py`` and ``cli/visualize.py`` against the JAX CLIs
(four JAX CLI runs in all) with small models.

Ties: the kNN features are continuous noise, so no two training features tie
at the k-th place (``np.argsort`` and ``torch.topk`` may order ties
differently).
"""

import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from cli_harness import _reset_gm3d_loggers

import gm3d_tpu.cli.evaluate as jeval
import gm3d_tpu.cli.visualize as jvis
import gm3d_tpu.eval.svm as jsvm
import gm3d_tpu.models as jmodels
from gm3d_tpu.eval import knn as jknn
from gm3d_tpu.eval import linear_probe as jlp
from gm3d_tpu.eval import visualize as jvisual
from gm3d_tpu.masking import random_mask as jrandom_mask
from gm3d_tpu.models import GM3DStudent as JGM3DStudent
from gm3d_tpu.models import PointMAE as JPointMAE
from gm3d_tpu.models.m2ae import PointM2AE as JPointM2AE
from gm3d_tpu.models.point_transformer import PointTransformer as JPointTransformer
from gm3d_tpu.utils import plot_logs as jplot
from gm3d_tpu.utils import ply as jply
from gm3d_tpu_torch.ckpt.checkpoint import save_checkpoint
from gm3d_tpu_torch.ckpt.torch_import import (
    GM3D_STUDENT_MAP,
    M2AE_MAP,
    POINT_MAE_MAP,
    POINT_TRANSFORMER_MAP,
    load_flax_variables,
)
from gm3d_tpu_torch.cli import evaluate, visualize
from gm3d_tpu_torch.eval import knn, linear_probe, svm
from gm3d_tpu_torch.eval import visualize as visual
from gm3d_tpu_torch.models import GM3DStudent, PointM2AE, PointMAE, PointTransformer
from gm3d_tpu_torch.train import finetune as ft
from gm3d_tpu_torch.utils import plot_logs, ply

SMALL = dict(trans_dim=32, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=32,
             drop_path_rate=0.0)
DEC = dict(decoder_depth=1, decoder_num_heads=2)
M2AE_KW = dict(num_groups=(32, 16, 8), group_sizes=(8, 4, 4), encoder_depths=(1, 1, 1),
               encoder_dims=(24, 48, 96), local_radius=(0.32, 0.64, 1.28),
               decoder_dims=(96, 48), decoder_depths=(1, 1), num_heads=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    _reset_gm3d_loggers()


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# utils/ply.py, utils/plot_logs.py


@pytest.mark.parametrize("kind", ["write_ply", "loss_heatmap_ply", "reconstruction_ply"])
def test_ply_files_are_the_jax_packages_byte_for_byte(kind, tmp_path):
    rng = _rng(1)
    pts = (rng.standard_normal((6, 5, 3)) * np.array([1e-3, 1.0, 300.0])).astype(np.float32)
    write = {"write_ply": lambda m, p: m.write_ply(
                 p, pts.reshape(-1, 3), rng.integers(0, 256, (30, 3)).astype(np.uint8)),
             "loss_heatmap_ply": lambda m, p: m.loss_heatmap_ply(
                 p, pts, np.linspace(-1.0, 2.0, 6).astype(np.float32)),
             "reconstruction_ply": lambda m, p: m.reconstruction_ply(p, pts[:2], pts[2:])}[kind]
    state = rng.bit_generator.state
    write(jply, str(tmp_path / "jax.ply"))
    rng.bit_generator.state = state
    write(ply, str(tmp_path / "port.ply"))
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    assert b"element vertex 30\n" in (tmp_path / "port.ply").read_bytes()


def test_plot_logs_reads_both_log_kinds_and_plots(tmp_path):
    jsonl = tmp_path / "log.txt"
    jsonl.write_text("\n".join(json.dumps(r) for r in [
        {"epoch": 0, "val_svm_acc": 0.5}, {"epoch": 1, "loss": 2.0},
        {"epoch": 2, "val_svm_acc": 0.75}]) + "\n\n")
    text = tmp_path / "run.log"
    text.write_text("epoch 0 val_svm_acc: 0.61\nnothing here\nval_svm_acc=0.70 after\n")
    for path in (jsonl, text):
        assert plot_logs.extract_series(str(path)) == jplot.extract_series(str(path))
    assert plot_logs.extract_series(str(jsonl)) == ([0, 2], [0.5, 0.75])
    assert plot_logs.extract_series(str(text))[1] == [0.61, 0.70]
    out = tmp_path / "cmp.png"
    plot_logs.plot_comparison({"a": str(jsonl), "b": str(text)}, str(out))
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# ---------------------------------------------------------------------------
# eval/knn.py, eval/linear_probe.py


def _features(seed, n_train=120, n_test=50, dim=24, classes=5):
    rng = _rng(seed)
    centers = rng.standard_normal((classes, dim)) * 1.5
    ytr, yte = np.arange(n_train) % classes, rng.integers(0, classes, n_test)
    xtr = (centers[ytr] + rng.standard_normal((n_train, dim))).astype(np.float32)
    xte = (centers[yte] + rng.standard_normal((n_test, dim))).astype(np.float32)
    return xtr, ytr, xte, yte


@pytest.mark.parametrize("k, n_train", [
    pytest.param(1, 120, id="1"), pytest.param(5, 120, id="5"), pytest.param(20, 120, id="20"),
    pytest.param(20, 5, id="20_above_5_training_features")])
def test_knn_accuracy_equals_the_jax_packages(k, n_train):
    """k neighbours, all the training features where k is above their number."""
    xtr, ytr, xte, yte = _features(k, n_train=n_train)
    want = jknn.knn_classifier(xtr, ytr, xte, yte, k=k)
    got = knn.knn_classifier(torch.from_numpy(xtr), torch.from_numpy(ytr), xte, yte, k=k)
    assert got == want and 0.3 < got <= 1.0


def test_lars_equals_the_jax_transform_for_5_steps():
    """1-D and 2-D parameters (the trust ratio on the 2-D ones only), weight
    decay, a learning rate scheduled on the update count; one all-zero
    parameter (its ratio is 1). Within 1e-6."""
    rng = _rng(2)
    shapes = {"w": (6, 4), "b": (4,), "zero": (3, 5)}
    start = {k: rng.standard_normal(v).astype(np.float32) for k, v in shapes.items()}
    start["zero"][:] = 0.0
    grads = [{k: rng.standard_normal(v).astype(np.float32) for k, v in shapes.items()}
             for _ in range(5)]
    sched = lambda count: 0.1 / (1.0 + count)  # noqa: E731
    tx = jlp.lars(sched, weight_decay=0.05)
    jparams = {k: jnp.asarray(v) for k, v in start.items()}
    jstate = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in start.items()}
    opt = linear_probe.LARS(params.values(), lr=sched, weight_decay=0.05)
    for g in grads:
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), atol=1e-6,
                                   rtol=0, err_msg=k)
        assert np.abs(p.detach().numpy() - start[k]).max() > 1e-5, k


def test_linear_probe_from_one_head_equals_the_jax_probe(monkeypatch):
    """The JAX probe's initial head (its own ``jax.random`` draws, replayed
    here) handed to the port's ``init``; 3 epochs of 3 steps (batch 40, the
    epoch order of both from ``default_rng(seed)``), warm-up 1 epoch. The
    JAX head after the last epoch is read where its ``predict`` is called."""
    xtr, ytr, xte, yte = _features(9)
    dim, classes, seed = xtr.shape[1], 5, 3
    key_w, key_b = jax.random.split(jax.random.key(seed))
    w0 = 0.01 * jax.random.truncated_normal(key_w, -2.0, 2.0, (dim, classes), jnp.float32)
    b0 = jax.random.uniform(key_b, (classes,), jnp.float32, -1.0 / np.sqrt(dim),
                            1.0 / np.sqrt(dim))
    seen, real_jit = [], jax.jit

    def spy_jit(fn):
        jitted = real_jit(fn)
        if fn.__name__ != "predict":
            return jitted
        return lambda params, run, x: seen.append((params, run)) or jitted(params, run, x)

    monkeypatch.setattr(jax, "jit", spy_jit)
    kw = dict(epochs=3, batch_size=40, warmup_epochs=1, seed=seed)
    want = jlp.linear_probe(xtr, ytr, xte, yte, **kw)
    monkeypatch.setattr(jax, "jit", real_jit)
    head = {}
    got = linear_probe.linear_probe(torch.from_numpy(xtr), ytr, xte, yte,
                                    init=(np.asarray(w0), np.asarray(b0)), head=head, **kw)
    assert got == want and got > 0.5
    jparams, jrun = seen[-1]
    for name, value in (("w", jparams["w"]), ("b", jparams["b"]),
                        ("running_mean", jrun["mean"]), ("running_var", jrun["var"])):
        np.testing.assert_allclose(head[name].numpy(), np.asarray(value), atol=1e-5, rtol=0,
                                   err_msg=name)
    assert np.abs(head["w"].numpy() - np.asarray(w0)).max() > 1e-3
    # the port's own head is drawn from the seed; the probe still learns
    assert linear_probe.linear_probe(xtr, ytr, xte, yte, **kw) > 0.5


# ---------------------------------------------------------------------------
# eval/visualize.py


def _read_ply(path):
    """(vertices (N, 3) float, colours (N, 3) int) of an ASCII PLY."""
    lines = open(path).read().splitlines()
    body = np.array([ln.split() for ln in lines[lines.index("end_header") + 1:]], np.float64)
    return body[:, :3], body[:, 3:].astype(np.int64)


def _assert_same_plys(a_dir, b_dir, names):
    for name in names:
        va, ca = _read_ply(a_dir / name)
        vb, cb = _read_ply(b_dir / name)
        np.testing.assert_allclose(vb, va, atol=1e-5, rtol=0, err_msg=name)
        # a colour is a truncated float: a 1e-7 step may cross an integer
        assert np.abs(cb - ca).max() <= 1, name


def _noise(jmodel, *example, seed=0):
    """Seeded numpy variables in the tree of ``jmodel.init(key, *example)``:
    weights of the init's scale, norms and running statistics non-trivial."""
    shapes = jax.eval_shape(lambda key: jmodel.init(key, *example), jax.random.key(0))
    rng = _rng(seed)

    def leaf(path, s):
        noise = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "var":
            return 1.0 + 0.5 * np.abs(noise)
        if name == "kernel":
            return noise / np.sqrt(s.shape[0])
        return (1.0 if name == "scale" else 0.0) + 0.1 * noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _init(kind, npoints=128):
    """Noise variables of a small Point-MAE or GM3D student."""
    jmodel = (JPointMAE if kind == "pointmae" else JGM3DStudent)(**SMALL, **DEC)
    mask = jnp.zeros((2, 16), bool).at[:, :9].set(True)
    return _noise(jmodel, jnp.zeros((2, npoints, 3), jnp.float32), mask, 9, seed=len(kind))


def _port(kind, variables):
    if kind == "pointmae":
        return load_flax_variables(PointMAE(**SMALL, **DEC), variables, POINT_MAE_MAP)
    return load_flax_variables(GM3DStudent(**SMALL, **DEC), variables, GM3D_STUDENT_MAP)


def test_dumps_write_the_jax_packages_vertices_and_colours(tmp_path):
    """``dump_reconstruction`` (masked Point-MAE, 9 of 16 groups masked) and
    ``dump_loss_heatmap`` (GM3D student, unmasked) from the same weights,
    clouds and mask."""
    pts = (_rng(4).standard_normal((2, 128, 3)) * 0.5).astype(np.float32)
    mask = np.array(jrandom_mask(jax.random.key(1), 2, 16, 9))
    mae, student = _init("pointmae"), _init("gm3d")
    jvisual.dump_reconstruction(JPointMAE(**SMALL, **DEC), mae, pts, mask, 9,
                                str(tmp_path / "jax"))
    jvisual.dump_loss_heatmap(JGM3DStudent(**SMALL, **DEC), student, pts, str(tmp_path / "jax"))
    visual.dump_reconstruction(_port("pointmae", mae), torch.from_numpy(pts),
                               torch.from_numpy(mask), 9, str(tmp_path / "port"))
    visual.dump_loss_heatmap(_port("gm3d", student), torch.from_numpy(pts),
                             str(tmp_path / "port"))
    names = [f"{p}_{b}.ply" for p in ("vis", "heat") for b in range(2)]
    assert sorted(f.name for f in (tmp_path / "port").iterdir()) == sorted(names)
    _assert_same_plys(tmp_path / "jax", tmp_path / "port", names)
    vertices, colours = _read_ply(tmp_path / "port" / "vis_0.ply")
    assert len(vertices) == 16 * 8 and (colours[:7 * 8] == 160).all()


# ---------------------------------------------------------------------------
# cli/evaluate.py, cli/visualize.py against the JAX CLIs


def _run_jax(module, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["jax-cli", *argv])
    _reset_gm3d_loggers()
    return module.main()


def _checkpoints(monkeypatch, tmp_path, variables, port_model, table):
    """One set of weights for both CLIs' ``--ckpt``: the JAX CLI's
    ``restore_raw`` hands it ``variables`` (no orbax checkpoint is written),
    the port's reads a checkpoint of ``port_model`` holding them, written as
    its CLIs write one. Returns the flag."""
    import gm3d_tpu.ckpt as jckpt

    def restore_raw(path):
        return {"params": variables["params"], "batch_stats": variables.get("batch_stats"),
                "step": 7} if path == str(tmp_path / "ckpt") else None

    monkeypatch.setattr(jckpt, "restore_raw", restore_raw)
    load_flax_variables(port_model, variables, table)
    save_checkpoint(str(tmp_path / "ckpt"), {"model": port_model.state_dict(), "ema": None,
                                             "optimizer": None}, 7)
    return ["--ckpt", str(tmp_path / "ckpt")]


class _Recorder:
    """Wraps a function that makes a step: every output of the step it makes, as numpy."""

    def __init__(self, make):
        self.make, self.outputs = make, []

    def __call__(self, *args, **kwargs):
        step = self.make(*args, **kwargs)

        def recorded(*a, **k):
            out = step(*a, **k)
            self.outputs.append(np.asarray(out.detach() if torch.is_tensor(out) else out))
            return out

        return recorded


FT_CLS = dict(SMALL, cls_dim=40, dropout=0.0)
EVAL_FLAGS = ["--config", "configs/pointmae/finetune_modelnet.yaml", "--synthetic",
              "--batch_size", "16", "--synthetic_samples", "32", "--num_workers", "0",
              "--num_devices", "1"]


def test_evaluate_acc_with_votes_equals_the_jax_cli(monkeypatch, tmp_path):
    """``--probe acc --vote --vote_repeats 2`` from one checkpoint
    (``_checkpoints``), the votes' draws from the JAX CLI's key sequence
    (``tests/test_torch_port_finetune_cli.py::_JaxDraws``).
    Every eval and vote batch's logits within 1e-4; both accuracies equal to
    one of the 64 test clouds."""
    from test_torch_port_finetune_cli import _JaxDraws


    variables = _noise(JPointTransformer(**FT_CLS), jnp.zeros((2, 1024, 3)), seed=8)
    flags = EVAL_FLAGS + ["--vote", "--vote_repeats", "2", "--output_dir", str(tmp_path),
                          *_checkpoints(monkeypatch, tmp_path, variables,
                                        PointTransformer(**FT_CLS), POINT_TRANSFORMER_MAP)]
    monkeypatch.setattr(jeval, "build_model_from_cfg",
                        lambda cfg, dtype: JPointTransformer(**FT_CLS, dtype=dtype))
    jrec, jvote = _Recorder(jeval.make_eval_step), _Recorder(jeval.make_vote_eval_step)
    monkeypatch.setattr(jeval, "make_eval_step", jrec)
    monkeypatch.setattr(jeval, "make_vote_eval_step", jvote)
    want = _run_jax(jeval, monkeypatch, flags)

    monkeypatch.setattr(evaluate, "build_model_from_cfg",
                        lambda cfg, dtype: PointTransformer(**FT_CLS, dtype=dtype))
    rec, vote = _Recorder(ft.make_eval_step), _Recorder(ft.make_vote_eval_step)
    monkeypatch.setattr(ft, "make_eval_step", rec)
    monkeypatch.setattr(ft, "make_vote_eval_step", vote)
    monkeypatch.setattr(ft, "vote_draws", _JaxDraws(seed=0).vote)
    got = evaluate.main(flags + ["--device", "cpu"])
    assert len(rec.outputs) == len(jrec.outputs) == 4
    assert len(vote.outputs) == len(jvote.outputs) == 8
    for a, b in zip(rec.outputs + vote.outputs, jrec.outputs + jvote.outputs):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    assert abs(got[0] - want[0]) <= 100.0 / 64 + 1e-9
    assert abs(got[1] - want[1]) <= 100.0 / 64 + 1e-9
    # the two vote passes drew differently
    assert not np.allclose(vote.outputs[0], vote.outputs[4])


def _feature_probe_runs(monkeypatch, tmp_path, family, jmodel, port_model, table, example,
                        flags):
    """One feature probe through both CLIs from one checkpoint
    (``_checkpoints``, noise weights); the SVC accuracies each fitted."""
    jfits, fits = [], []
    jfit, fit = jsvm.evaluate_svm, svm.evaluate_svm
    monkeypatch.setattr(jsvm, "evaluate_svm", lambda *a: jfits.append(jfit(*a)) or jfits[-1])
    monkeypatch.setattr(svm, "evaluate_svm", lambda *a, **k: fits.append(fit(*a, **k)) or fits[-1])
    if family == "gm3d":
        monkeypatch.setattr(jmodels, "GM3DStudent", lambda dtype: jmodel)
        monkeypatch.setattr(evaluate, "GM3DStudent", lambda dtype: port_model)
    else:
        monkeypatch.setattr(jeval, "build_model_from_cfg", lambda cfg, dtype: jmodel)
        monkeypatch.setattr(evaluate, "build_model_from_cfg", lambda cfg, dtype: port_model)
    variables = _noise(jmodel, *example, seed=9)
    argv = ["--model_family", family, "--synthetic", "--batch_size", "32",
            "--synthetic_samples", "64", "--num_workers", "0", *flags,
            "--output_dir", str(tmp_path),
            *_checkpoints(monkeypatch, tmp_path, variables, port_model, table)]
    want = _run_jax(jeval, monkeypatch, argv)
    got = evaluate.main(argv + ["--device", "cpu"])
    return want, got, jfits, fits


def test_evaluate_knn_probe_equals_the_jax_cli(monkeypatch, tmp_path):
    """``--probe knn`` on a small GM3D student's pooled features: the same
    accuracy."""
    mask = jnp.zeros((2, 16), bool).at[:, :9].set(True)
    want, got, _, _ = _feature_probe_runs(
        monkeypatch, tmp_path, "gm3d", JGM3DStudent(**SMALL, **DEC),
        GM3DStudent(**SMALL, **DEC), GM3D_STUDENT_MAP, (jnp.zeros((2, 128, 3)), mask, 9),
        ["--config", "configs/pointmae/config.yaml", "--probe", "knn", "--knn_k", "5"])
    assert got == want and 0.0 < got <= 1.0


def test_evaluate_svm_both_scales_equals_the_jax_cli(monkeypatch, tmp_path):
    """``--probe svm --svm_scales both`` on a small Point-M2AE: features
    extracted once under ``all``; both
    protocols' accuracies (``all``, then the trailing ``last`` columns) equal
    to the JAX CLI's, and the better one returned."""
    cfg = yaml.safe_load(open("configs/m2ae/config_Point_M2AE.yaml"))
    cfg["npoints"] = 256
    path = tmp_path / "m2ae.yaml"
    path.write_text(yaml.safe_dump(cfg))
    port_model = PointM2AE(**M2AE_KW)
    want, got, jfits, fits = _feature_probe_runs(
        monkeypatch, tmp_path, "m2ae", JPointM2AE(**M2AE_KW), port_model, M2AE_MAP,
        (jnp.zeros((2, 256, 3)), jnp.ones((2, 8), bool)), ["--config", str(path), "--probe", "svm", "--svm_scales", "both"])
    assert len(fits) == len(jfits) == 2
    np.testing.assert_allclose(fits, jfits, atol=1.0 / 64 + 1e-9, rtol=0)
    assert got == max(fits) and port_model.svm_scales == "all"
    with pytest.raises(ValueError, match="--svm_scales both"):
        evaluate.main(["--config", str(path), "--model_family", "m2ae", "--probe", "knn",
                       "--svm_scales", "both", "--synthetic", "--device", "cpu",
                       "--output_dir", str(tmp_path)])


def _tiny_configs(tmp_path):
    """Finetune, pretrain and seg configs of small models at 128 points."""
    out = {}
    for name, src, model in (
            ("cls", "configs/pointmae/finetune_modelnet.yaml",
             dict(NAME="PointTransformer", cls_dim=10, **SMALL)),
            ("mae", "configs/pointmae/config_m.yaml",
             {"NAME": "Point_MAE", "group_size": 8, "num_group": 16,
              "transformer_config": dict(trans_dim=32, encoder_dims=32, depth=2, num_heads=2,
                                         drop_path_rate=0.0, **DEC)}),
            ("seg", "configs/pointmae/seg_shapenetpart.yaml",
             dict(NAME="PointTransformerSeg", cls_dim=50, feature_blocks=[0, 1], **SMALL))):
        cfg = yaml.safe_load(open(src))
        cfg.update(model=model, npoints=128, total_bs=8)
        out[name] = tmp_path / f"{name}.yaml"
        out[name].write_text(yaml.safe_dump(cfg))
    return {k: str(v) for k, v in out.items()}


def test_evaluate_reads_port_checkpoints_and_never_falls_back(tmp_path):
    """Every probe from a checkpoint the port's CLIs write: ``acc`` equals the
    eval step's accuracy on the checkpoint's model, ``svm`` the probe on its
    encoder, ``linprob`` and ``seg`` run to finite scores (``seg`` equal to
    ``run_seg_val`` on the same model). A path without a checkpoint raises
    ``FileNotFoundError`` for each probe and for the visualize CLI."""
    from gm3d_tpu_torch.cli.finetune import evaluate as eval_pass
    from gm3d_tpu_torch.cli.finetune_seg import CLS_NAMES, SyntheticParts
    from gm3d_tpu_torch.config import build_model_from_cfg
    from gm3d_tpu_torch.data.datasets import SEG_CLASSES, DataLoader, SyntheticClouds
    from gm3d_tpu_torch.train.segmentation import make_seg_eval_step, run_seg_val

    cfgs = _tiny_configs(tmp_path)
    common = ["--synthetic", "--synthetic_samples", "32", "--num_workers", "0", "--device",
              "cpu", "--output_dir", str(tmp_path / "out")]
    saved = {}
    for name in cfgs:
        model = build_model_from_cfg(yaml.safe_load(open(cfgs[name]))["model"])
        model.reset_parameters(torch.Generator().manual_seed(5))
        save_checkpoint(str(tmp_path / name / "ckpt"), {"model": model.state_dict(), "ema": None,
                                                         "optimizer": None}, 3)
        saved[name] = model.eval()
    acc, vote = evaluate.main(["--config", cfgs["cls"], "--ckpt", str(tmp_path / "cls" / "ckpt"),
                               *common])
    val = DataLoader(SyntheticClouds(64, 128, num_classes=10, seed=2, labelled=True), 8,
                     shuffle=False, drop_last=False)
    assert vote is None and acc == eval_pass(val, ft.make_eval_step(saved["cls"], 128,
                                                                    device="cpu"))
    mae_flags = ["--config", cfgs["mae"], "--model_family", "pointmae", "--ckpt",
                 str(tmp_path / "mae" / "ckpt"), *common]
    got = evaluate.main(mae_flags + ["--probe", "svm"])
    loaders = [DataLoader(SyntheticClouds(64, 128, num_classes=10, seed=s, labelled=True), 16,
                          shuffle=False, drop_last=False) for s in (2, 3)]
    assert got == svm.svm_probe(saved["mae"], *loaders, npoints=128)
    assert 0.0 <= evaluate.main(mae_flags + ["--probe", "linprob", "--linprob_epochs", "2"]) <= 1
    miou = evaluate.main(["--config", cfgs["seg"], "--probe", "seg", "--ckpt",
                          str(tmp_path / "seg" / "ckpt"), *common])
    want = run_seg_val(make_seg_eval_step(saved["seg"], device="cpu"),
                       DataLoader(SyntheticParts(32, 128, seed=2), 8, shuffle=False,
                                  drop_last=False), SEG_CLASSES, CLS_NAMES)
    assert miou["instance_miou"] == want["instance_miou"] and 0 < miou["class_miou"] <= 1
    missing = str(tmp_path / "missing")
    for flags in (["--config", cfgs["cls"]], ["--config", cfgs["seg"], "--probe", "seg"],
                  ["--config", cfgs["mae"], "--model_family", "pointmae", "--probe", "knn"]):
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            evaluate.main(flags + ["--ckpt", missing, *common])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        visualize.main(["--config", cfgs["mae"], "--ckpt", missing, *common,
                        "--out_dir", str(tmp_path / "vis")])


def test_visualize_cli_writes_the_jax_clis_files(monkeypatch, tmp_path):
    """``cli/visualize.py --heatmap`` on 2 synthetic clouds against the JAX
    CLI: its Point-MAE and its (fresh) GM3D student from the JAX CLI's init
    key 0, the JAX CLI's mask handed to the port. The same vertices and
    colours within 1e-5; each reconstruction holds the visible groups and the
    rebuilt ones (16 x 8 points), each heatmap every group's points."""
    cfg = yaml.safe_load(open("configs/pointmae/config.yaml"))
    cfg["npoints"] = 128
    path = tmp_path / "vis.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setattr(jvis, "build_model_from_cfg",
                        lambda cfg, dtype: JPointMAE(**SMALL, **DEC, dtype=dtype))
    monkeypatch.setattr(jvis, "GM3DStudent",
                        lambda dtype: JGM3DStudent(**SMALL, **DEC, dtype=dtype))
    argv = ["--config", str(path), "--synthetic", "--num_samples", "2", "--heatmap",
            "--seed", "3", "--output_dir", str(tmp_path / "o")]
    seen = {}
    for name in ("dump_reconstruction", "dump_loss_heatmap"):
        real = getattr(jvis, name)
        monkeypatch.setattr(jvis, name, lambda m, v, *a, _real=real, _name=name, **k: (
            seen.__setitem__(_name, jax.tree.map(np.asarray, v)), _real(m, v, *a, **k)))
    _run_jax(jvis, monkeypatch, argv + ["--out_dir", str(tmp_path / "jax")])
    mask = torch.from_numpy(np.asarray(jrandom_mask(jax.random.key(3), 2, 16, 9)))
    monkeypatch.setattr(visualize, "random_mask", lambda gen, b, g, n: mask)
    monkeypatch.setattr(visualize, "build_model", lambda args, cfg, dtype, logger: _port(
        "pointmae", seen["dump_reconstruction"]))
    monkeypatch.setattr(visualize, "build_student", lambda dtype: _port(
        "gm3d", seen["dump_loss_heatmap"]))
    visualize.main(argv + ["--device", "cpu", "--out_dir", str(tmp_path / "port")])
    names = [f"{p}_{b}.ply" for p in ("vis", "heat") for b in range(2)]
    assert sorted(f.name for f in (tmp_path / "port").iterdir()) == sorted(names)
    _assert_same_plys(tmp_path / "jax", tmp_path / "port", names)
    for name in names:
        assert len(_read_ply(tmp_path / "port" / name)[0]) == 16 * 8
