"""The port's C++ cloud loader (``gm3d_tpu_torch/native``) against the JAX
package's (``gm3d_tpu.native``), on the same ``.npy`` files and seed.

Both build ``loader.cpp`` with ``g++`` (the port its own copy into its own
build directory): with one worker every batch is equal element for element,
over two epochs and after ``load_state``. The port's loader hands its samples
out in the epoch's order, so with four workers its batches are still the
one-worker batches, where the JAX loader's four workers give the same clouds
in the order they finish; two data-parallel ranks then split every epoch's
clouds between them with no repeats or gaps. Then the
labelled loader with ``with_seg``, the error count, a failed build (which
raises: nothing falls back to the Python loader), and one pretrain epoch and
one seg epoch of the port's CLIs with ``--native_loader`` beside the
Python-loader run's on the same files (other clouds per batch, since the two
loaders shuffle and subsample with other generators: the same steps and keys,
finite means of the same size).
"""

import os

import numpy as np
import pytest
import torch
import yaml
from _torch_threads import torch_at_one_thread  # noqa: F401
from cli_harness import _reset_gm3d_loggers

from gm3d_tpu.native import NativeCloudLoader as JNativeCloudLoader
from gm3d_tpu.native import NativeLabelledCloudLoader as JNativeLabelledCloudLoader
from gm3d_tpu.native import native_available
from gm3d_tpu_torch.native import native_loader
from gm3d_tpu_torch.native import NativeCloudLoader, NativeLabelledCloudLoader
from gm3d_tpu_torch.scripts import make_disk_datasets as disk

NPOINTS, BATCH = 64, 4


@pytest.fixture(scope="module")
def clouds(tmp_path_factory):
    d = tmp_path_factory.mktemp("clouds")
    rng = np.random.default_rng(0)
    paths, labels = [], []
    # 16 clouds, 4 batches: no ragged tail is dropped, so that with the JAX
    # loader's several workers (whose completion order decides its batches)
    # each epoch still holds every cloud
    for i in range(16):
        n = 100 + 7 * i
        # x y z nx ny nz part: the ShapeNetPart cache layout; the plain
        # loader reads the first three columns
        data = np.concatenate([rng.standard_normal((n, 6)) * (i + 1),
                               rng.integers(0, 5, (n, 1))], axis=1).astype(np.float32)
        path = str(d / f"cloud_{i}.npy")
        np.save(path, data)
        paths.append(path)
        labels.append(i % 3)
    return paths, labels


def _jax_loader_or_skip(cls, *args, **kwargs):
    if not native_available():
        pytest.skip("the JAX package's loader did not build")
    return cls(*args, **kwargs)


def _epochs(loader, n):
    return [list(loader) for _ in range(n)]


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
        else:
            np.testing.assert_array_equal(x, y)


def test_one_worker_batches_equal_the_jax_loaders(clouds):
    paths, _ = clouds
    port = NativeCloudLoader(paths, NPOINTS, BATCH, num_workers=1, seed=5)
    jax_side = _jax_loader_or_skip(JNativeCloudLoader, paths, NPOINTS, BATCH,
                                   num_workers=1, seed=5)
    assert len(port) == len(jax_side) == len(paths) // BATCH
    first = _epochs(port, 2)
    for mine, theirs in zip(first, _epochs(jax_side, 2)):
        _assert_batches_equal(mine, theirs)
    assert port.state() == jax_side.state() == {"epoch": 2, "batch": 0}
    # back to epoch 1: its batches again, on both
    port.load_state({"epoch": 1, "batch": 0})
    jax_side.load_state({"epoch": 1, "batch": 0})
    again = list(port)
    _assert_batches_equal(again, first[1])
    _assert_batches_equal(again, list(jax_side))
    assert not np.array_equal(first[0][0], first[1][0])  # epochs reshuffle
    for b in first[0]:
        assert b.shape == (BATCH, NPOINTS, 3) and b.dtype == np.float32
        np.testing.assert_allclose(np.linalg.norm(b, axis=-1).max(-1), 1.0, rtol=1e-4)
    port.close()
    jax_side.close()


def _epoch_set(batches):
    return sorted(c.tobytes() for batch in batches for c in batch)


def test_four_workers_hold_the_same_clouds_each_epoch(clouds):
    """The port's four workers give the one-worker batches element for
    element; the JAX loader's four the same clouds in another order."""
    paths, _ = clouds
    one = NativeCloudLoader(paths, NPOINTS, BATCH, num_workers=1, seed=5)
    four = NativeCloudLoader(paths, NPOINTS, BATCH, num_workers=4, seed=5)
    jax_four = _jax_loader_or_skip(JNativeCloudLoader, paths, NPOINTS, BATCH,
                                   num_workers=4, seed=5)
    for _ in range(2):
        expected = list(one)
        _assert_batches_equal(list(four), expected)
        assert _epoch_set(jax_four) == _epoch_set(expected)
    # a small window (max_queue is 4 batches) over more files than it holds
    many = paths * 3
    _assert_batches_equal(list(NativeCloudLoader(many, NPOINTS, 2, num_workers=4, seed=1)),
                          list(NativeCloudLoader(many, NPOINTS, 2, num_workers=1, seed=1)))


@pytest.fixture
def as_rank():
    from gm3d_tpu_torch.parallel import context

    def enter(rank):
        context.set_context(context.DataParallel(group=None, host_group=None,
                                                 control_group=None, rank=rank, world=2,
                                                 device=torch.device("cpu")))
    yield enter
    context.set_context(None)


def test_two_ranks_split_each_epoch_between_them(clouds, as_rank):
    """Each rank runs its own four-worker loader from the same seed and keeps
    its rows (``rank_rows``), as the pretrain CLI does under ``torchrun``:
    over two epochs, the two ranks' clouds are the epoch's, each once."""
    from gm3d_tpu_torch.cli.common import rank_rows

    paths, _ = clouds
    per_rank = []
    for rank in range(2):
        as_rank(rank)
        loader = rank_rows(NativeCloudLoader(paths, NPOINTS, BATCH, num_workers=4, seed=3))
        per_rank.append([list(loader) for _ in range(2)])
        assert all(b.shape == (BATCH // 2, NPOINTS, 3) for e in per_rank[-1] for b in e)
    whole = NativeCloudLoader(paths, NPOINTS, BATCH, num_workers=1, seed=3)
    for epoch in range(2):
        expected = list(whole)
        got = per_rank[0][epoch] + per_rank[1][epoch]
        assert len(set(_epoch_set(got))) == len(paths)
        assert _epoch_set(got) == _epoch_set(expected)
        for step, batch in enumerate(expected):
            np.testing.assert_array_equal(per_rank[0][epoch][step], batch[:BATCH // 2])
            np.testing.assert_array_equal(per_rank[1][epoch][step], batch[BATCH // 2:])


def test_labelled_loader_with_seg_equals_the_jax_loaders(clouds):
    paths, labels = clouds
    for with_seg in (False, True):
        port = NativeLabelledCloudLoader(paths, labels, NPOINTS, BATCH, num_workers=1,
                                         seed=2, with_seg=with_seg)
        jax_side = _jax_loader_or_skip(JNativeLabelledCloudLoader, paths, labels, NPOINTS,
                                       BATCH, num_workers=1, seed=2, with_seg=with_seg)
        mine = list(port)
        _assert_batches_equal(mine, list(jax_side))
        for batch in mine:
            assert len(batch) == (3 if with_seg else 2)
            assert batch[1].dtype == np.int32 and set(batch[1]) <= {0, 1, 2}
            if with_seg:
                assert batch[2].shape == (BATCH, NPOINTS) and set(batch[2].ravel()) <= set(range(5))
    with pytest.raises(ValueError, match="labels"):
        NativeLabelledCloudLoader(paths, labels[:-1], NPOINTS, BATCH)


def test_unreadable_files_raise_after_the_epoch(clouds, tmp_path):
    paths, _ = clouds
    bad = tmp_path / "bad.npy"
    bad.write_bytes(b"not a numpy file")
    loader = NativeCloudLoader([*paths[:7], str(bad)], NPOINTS, BATCH, num_workers=2)
    with pytest.raises(RuntimeError, match="1 file"):
        list(loader)


def test_a_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path, clouds):
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_lib", None)
    broken = tmp_path / "loader.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="failed") as err:
        NativeCloudLoader(clouds[0], NPOINTS, BATCH)
    assert "loader.cpp" in str(err.value)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="did not run"):
        native_loader.build_library(native_loader.Path(__file__))
    assert not list((tmp_path / "build").glob("*.so"))
    # the package's own library is keyed by its source and lives in the ignored directory
    monkeypatch.undo()
    path = native_loader.library_path()
    assert path.parent.name == "build" and path.parent.parent.name == "gm3d_tpu_torch"


# ---------------------------------------------------------------------------
# the CLIs with --native_loader

TINY_MAE = {"trans_dim": 32, "encoder_dims": 32, "depth": 1, "num_heads": 2,
            "decoder_depth": 1, "decoder_num_heads": 2, "drop_path_rate": 0.0,
            "mask_ratio": 0.6, "mask_type": "rand"}


@pytest.fixture(scope="module")
def disk_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("disk")
    shapenet = disk.write_shapenet55(str(root / "shapenet"), 16, 4, 300, seed=0)
    modelnet = disk.write_modelnet(str(root / "modelnet"), 16, 16, 128, seed=0)
    part = disk.write_shapenetpart(str(root / "part"), 8, 4, 200, seed=0)
    pre = disk.pretrain_config(str(root / "pretrain.yaml"), "configs/pointmae/config_m.yaml",
                               shapenet, modelnet)
    cfg = yaml.safe_load(open(pre))
    cfg["model"].update(group_size=8, num_group=16)
    cfg["model"]["transformer_config"].update(TINY_MAE)
    cfg["npoints"] = 128
    for split in cfg["dataset"].values():
        split["others"]["npoints"] = 128
    yaml.safe_dump(cfg, open(pre, "w"))
    seg = disk.seg_config(str(root / "seg.yaml"), "configs/pointmae/seg_shapenetpart.yaml", part)
    cfg = yaml.safe_load(open(seg))
    cfg["model"].update(trans_dim=32, depth=2, num_heads=2, group_size=8, num_group=16,
                        encoder_dims=32, drop_path_rate=0.0, feature_blocks=[0, 1])
    cfg["npoints"] = 128
    for split in cfg["dataset"].values():
        split["others"]["npoints"] = 128
    yaml.safe_dump(cfg, open(seg, "w"))
    return pre, seg, root


def _spy(monkeypatch, module, name):
    made = []
    cls = getattr(module, name)

    def make(*args, **kwargs):
        made.append(cls(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(module, name, make)
    return made


class _NoScalars:
    """In place of the CLIs' TensorBoard writer, whose import pulls in
    TensorFlow where that is installed (seconds); the scalars are not what
    these tests check."""

    def __init__(self, log_dir):
        pass

    def add_scalar(self, tag, value, step):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def _close(native, python, keys):
    assert native.keys() == python.keys()
    assert native["epoch"] == python["epoch"] == 0
    for key in keys:
        assert np.isfinite(native[key]) and np.isfinite(python[key])
        assert native[key] == pytest.approx(python[key], rel=0.25), key


def test_pretrain_epoch_through_the_native_loader(disk_sets, monkeypatch, tmp_path):
    from gm3d_tpu_torch import native
    from gm3d_tpu_torch.cli import pretrain

    config, _, _ = disk_sets
    flags = ["--config", config, "--model_family", "pointmae", "--epochs", "1",
             "--batch_size", str(BATCH), "--num_workers", "1", "--sync_probe", "--device", "cpu"]
    made = _spy(monkeypatch, native, "NativeCloudLoader")
    monkeypatch.setattr(pretrain, "ScalarWriter", _NoScalars)
    _reset_gm3d_loggers()
    python = pretrain.main([*flags, "--output_dir", str(tmp_path / "python")])
    assert not made
    _reset_gm3d_loggers()
    records = pretrain.main([*flags, "--native_loader", "--output_dir", str(tmp_path / "native")])
    assert len(made) == 1 and made[0].npoints == 128 and made[0].batch_size == BATCH
    assert len(records) == len(python) == 1
    assert records[0]["steps"] == python[0]["steps"] == 16 // BATCH
    _close(records[0], python[0], ("loss", "grad_norm"))
    assert 0.0 <= records[0]["val_svm_acc"] <= 1.0


def test_seg_epoch_through_the_native_loader(disk_sets, monkeypatch, tmp_path):
    from gm3d_tpu_torch import native
    from gm3d_tpu_torch.cli import finetune_seg

    _, config, _ = disk_sets
    flags = ["--config", config, "--epochs", "1", "--batch_size", str(BATCH),
             "--num_workers", "1", "--steps_per_dispatch", "1", "--device", "cpu"]
    made = _spy(monkeypatch, native, "NativeLabelledCloudLoader")
    monkeypatch.setattr(finetune_seg, "ScalarWriter", _NoScalars)
    _reset_gm3d_loggers()
    python = finetune_seg.main([*flags, "--output_dir", str(tmp_path / "python")])
    assert not made
    _reset_gm3d_loggers()
    records = finetune_seg.main([*flags, "--native_loader",
                                 "--output_dir", str(tmp_path / "native")])
    assert len(made) == 1 and made[0].with_seg
    assert all(p.endswith(".txt.npy") and os.path.exists(p) for p in made[0].paths)
    _close(records[0], python[0], ("loss", "instance_miou"))
