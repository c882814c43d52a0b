"""The port's few-shot harness against the JAX package's (CPU).

  - ``data/fewshot_gen.py::generate_few_shot_folds`` writes the same
    episodes as the JAX generator from one seed (the pickles load equal);
  - ``ModelNetFewShot`` reads them item for item as the JAX reader does,
    the train split's per-epoch point shuffles included;
  - ``gm3d_tpu_torch.cli.fewshot`` and ``gm3d_tpu.cli.fewshot`` (its default
    ``--parallel_folds``, one ``vmap`` over the folds) run two folds for two
    epochs, on synthetic episodes and on folds read from disk; each fold
    starts from the same weights on both sides (drawn from numpy seeded by
    the fold), and the port's draws are the JAX CLI's per-fold key
    sequence. As in ``tests/test_torch_port_finetune_cli.py``, the head's
    dropout and stochastic depth are 0 on both sides, and the rate is 2e-5
    without warm-up (at the config's 5e-4 the first AdamW updates of these
    small models are chaotic). Each fold's best accuracy must agree to one of its
    test clouds, and the mean and standard deviation follow.

Small models only (width 32, depth 2).
"""

import importlib
import json
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from cli_harness import _reset_gm3d_loggers

import gm3d_tpu.cli.fewshot as jcli
from gm3d_tpu.data import datasets as jdatasets
from gm3d_tpu.data.fewshot_gen import generate_few_shot_folds as jgenerate
from gm3d_tpu.models.point_transformer import PointTransformer as JPointTransformer
from gm3d_tpu_torch.ckpt.torch_import import POINT_TRANSFORMER_MAP, load_flax_variables
from gm3d_tpu_torch.cli import fewshot as cli
from gm3d_tpu_torch.data import datasets
from gm3d_tpu_torch.data.fewshot_gen import generate_few_shot_folds
from gm3d_tpu_torch.models import PointTransformer
from gm3d_tpu_torch.train import finetune as ft

SMALL = dict(trans_dim=32, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=32,
             drop_path_rate=0.0, dropout=0.0)
WAY, SHOT, FOLDS, EPOCHS, NPOINTS = 3, 4, 2, 2, 1024


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_loggers():
    yield
    _reset_gm3d_loggers()


def _labelled_set(seed, n, classes, points=NPOINTS):
    rng = np.random.default_rng(seed)
    labels = np.arange(n) % classes
    blobs = np.random.default_rng(99).standard_normal((classes, 6, 3)).astype(np.float32)
    pts = blobs[labels[:, None], rng.integers(0, 6, (n, points))]
    pts = pts + 0.2 * rng.standard_normal((n, points, 3)).astype(np.float32)
    return pts.astype(np.float32), labels


def _write_folds(root, generate, ways=(WAY,), shots=(SHOT,), folds=FOLDS):
    """Folds out of a labelled set of 8 classes (10 train, 25 test clouds
    each: more test clouds than the protocol's 20 a class)."""
    pts, labels = _labelled_set(1, 80, 8)
    test_pts, test_labels = _labelled_set(2, 200, 8)
    generate(pts, labels, test_pts, test_labels, str(root), ways=ways, shots=shots,
             folds=folds, seed=3)
    return root


def test_the_generator_writes_the_jax_generators_episodes(tmp_path):
    got = _write_folds(tmp_path / "port", generate_few_shot_folds, ways=(3, 5), shots=(2, 4),
                       folds=3)
    want = _write_folds(tmp_path / "jax", jgenerate, ways=(3, 5), shots=(2, 4), folds=3)
    files = sorted(p.relative_to(got) for p in got.rglob("*.pkl"))
    assert files == sorted(p.relative_to(want) for p in want.rglob("*.pkl"))
    assert len(files) == 12
    for rel in files:
        g, w = (pickle.loads((root / rel).read_bytes()) for root in (got, want))
        for split in ("train", "test"):
            assert len(g[split]) == len(w[split])
            for (gp, gl, gc), (wp, wl, wc) in zip(g[split], w[split]):
                assert np.array_equal(gp, wp) and gl == wl and gc == wc
        way = int(str(rel).split("way")[0])
        shot = int(str(rel).split("_")[1].split("shot")[0])
        assert len(g["train"]) == way * shot and len(g["test"]) == way * 20
        assert sorted({lab for _, lab, _ in g["train"]}) == list(range(way))


def test_modelnet_fewshot_reader_equals_the_jax_reader(tmp_path):
    root = _write_folds(tmp_path, generate_few_shot_folds)
    for subset, n in (("train", WAY * SHOT), ("test", WAY * 20)):
        cfg = {"_base_": {"NAME": "ModelNetFewShot", "DATA_PATH": str(root)},
               "others": {"subset": subset, "way": WAY, "shot": SHOT, "fold": 1}}
        got, want = datasets.build_dataset_from_cfg(cfg), jdatasets.build_dataset_from_cfg(cfg)
        assert type(got).__name__ == "ModelNetFewShot" and len(got) == len(want) == n
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            for i in range(n):
                g, w = got[i], want[i]
                assert g[:2] == w[:2] and g[2][1] == w[2][1]
                assert g[2][0].dtype == np.float32 and np.array_equal(g[2][0], w[2][0])
        got.set_epoch(0)
        first = got[0][2][0]
        got.set_epoch(1)
        # the train split shuffles each cloud's points anew each epoch
        assert np.array_equal(first, got[0][2][0]) == (subset == "test")


# ---------------------------------------------------------------------------
# the two CLIs


def _config(tmp_path, data=None):
    """``fewshot.yaml`` at 2e-5 without warm-up, the small model, and the
    folds' directory."""
    cfg = yaml.safe_load(open("configs/pointmae/fewshot.yaml"))
    cfg["optimizer"]["kwargs"]["lr"] = 2e-5
    cfg["scheduler"]["kwargs"]["initial_epochs"] = 0
    cfg["model"].update({k: v for k, v in SMALL.items() if k != "dropout"})
    if data is not None:
        for split in ("train", "val", "test"):
            cfg["dataset"][split]["_base_"]["DATA_PATH"] = str(data)
    path = tmp_path / "fewshot_small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


class _JaxFoldDraws:
    """The draws of the JAX CLI's key sequence for each fold: ``rng =
    key(fold)``, a step's ``rng, key = split(rng)``, then the step's own
    ``split(key, 4)``. The port seeds fold f's generator with f."""

    def __init__(self):
        self.rngs = {}

    def __call__(self, generator, model, batch, num_points, npoints):
        assert num_points == npoints  # 1024-point clouds: no FPS, no subsample
        fold = generator.initial_seed()
        rng = self.rngs.get(fold, jax.random.key(fold))
        self.rngs[fold], key = jax.random.split(rng)
        _, r_aug, _, _ = jax.random.split(key, 4)
        r_scale, r_shift = jax.random.split(r_aug)
        out = {"scale": jax.random.uniform(r_scale, (batch, 1, 3), minval=2.0 / 3.0,
                                           maxval=3.0 / 2.0),
               "shift": jax.random.uniform(r_shift, (batch, 1, 3), minval=-0.2, maxval=0.2)}
        out = {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
        out["dropout"] = tuple(torch.ones((batch, 256), dtype=torch.bool) for _ in range(2))
        return out


def _fold_variables(fold):
    """Fold ``fold``'s initial weights, drawn from numpy seeded ``fold`` in the
    tree ``PointTransformer.init`` gives: weights noise of unit gain, biases,
    norm scales and running statistics non-trivial. (The JAX init's 0.02
    weights give nearly constant logits, so every fold would score the
    chance rate on either side and the accuracies would compare nothing.)"""
    rng = np.random.default_rng(fold)
    jmodel = JPointTransformer(**SMALL, cls_dim=WAY)
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


@pytest.mark.parametrize("source", ["synthetic", "folds on disk"])
def test_the_two_fewshot_clis_agree(source, monkeypatch, tmp_path):
    data = None if source == "synthetic" else _write_folds(tmp_path / "folds",
                                                           generate_few_shot_folds)
    flags = ["--config", _config(tmp_path, data), "--way", str(WAY), "--shot", str(SHOT),
             "--folds", str(FOLDS), "--epochs", str(EPOCHS), "--num_devices", "1"]
    if source == "synthetic":
        flags.append("--synthetic")
    # the JAX CLI, its default vmapped folds, from each fold's weights
    importlib.reload(jcli)
    monkeypatch.setattr(jcli, "build_model_from_cfg",
                        lambda cfg, dtype: JPointTransformer(**SMALL, cls_dim=cfg["cls_dim"],
                                                             dtype=dtype))
    monkeypatch.setattr(jcli, "init_fold_variables", lambda args, cfg, model, fold, pts0, logger:
                        jax.tree.map(jnp.asarray, _fold_variables(fold)))
    monkeypatch.setattr(sys, "argv", ["fewshot", *flags, "--output_dir", str(tmp_path / "jax")])
    _reset_gm3d_loggers()
    jcli.main()
    want = json.loads((tmp_path / "jax" / "log.txt").read_text().splitlines()[-1])
    # the port, from the same weights for each fold, with the JAX draws

    def build(args, cfg, fold, dtype):
        assert cfg["model"]["NAME"] == "PointTransformer"
        return load_flax_variables(PointTransformer(**SMALL, cls_dim=args.way),
                                   _fold_variables(fold), POINT_TRANSFORMER_MAP)

    monkeypatch.setattr(cli, "build_model", build)
    monkeypatch.setattr(ft, "finetune_draws", _JaxFoldDraws())
    _reset_gm3d_loggers()
    records = cli.main([*flags, "--device", "cpu", "--output_dir", str(tmp_path / "port")])
    got = json.loads((tmp_path / "port" / "log.txt").read_text())
    assert records == [got]
    assert sorted(got) == sorted(want) == ["accs", "mean", "shot", "std", "way"]
    assert (got["way"], got["shot"]) == (want["way"], want["shot"]) == (WAY, SHOT)
    print(f"{source}: per-fold accuracies port {got['accs']}, jax {want['accs']}")
    one_cloud = 100.0 / (WAY * 20)
    assert len(got["accs"]) == len(want["accs"]) == FOLDS
    for g, w in zip(got["accs"], want["accs"]):
        assert abs(g - w) <= one_cloud + 1e-9
    assert abs(got["mean"] - want["mean"]) <= one_cloud + 1e-9
    assert got["mean"] == pytest.approx(np.mean(got["accs"]))
    assert got["std"] == pytest.approx(np.std(got["accs"]))
    log = (tmp_path / "port" / "fewshot.log").read_text()
    assert f"{WAY}-way {SHOT}-shot over {FOLDS} folds" in log and "fold 1: best acc" in log


def test_the_fewshot_cli_takes_both_fold_flags_and_refuses_what_is_not_ported(tmp_path):
    """``--no-parallel_folds`` gives the same folds (they run in turn either
    way); ``--num_devices`` other than the world size raises, naming ``torchrun``. (A Point-M2AE config
    trains the hierarchical classifier: ``tests/test_torch_port_m2ae_cli.py``.)"""
    config = _config(tmp_path)
    flags = ["--config", config, "--synthetic", "--way", "2", "--shot", "2", "--folds", "2",
             "--epochs", "1", "--device", "cpu"]
    runs = [cli.main([*flags, *extra, "--output_dir", str(tmp_path / name)])[0]
            for name, extra in (("par", []), ("seq", ["--no-parallel_folds"]))]
    assert runs[0] == runs[1] and len(runs[0]["accs"]) == 2
    with pytest.raises(ValueError, match="torchrun"):
        cli.main([*flags, "--num_devices", "2", "--output_dir", str(tmp_path / "x")])
