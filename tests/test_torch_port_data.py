"""The port's data pipeline against the JAX package's (CPU, seconds).

The readers, synthetic clouds and batcher are numpy code copied into
``gm3d_tpu_torch``: for the same arguments they must give BIT-IDENTICAL
arrays. The on-device augmentations must agree with their JAX functions on
the same draws (made with ``jax.random`` from the JAX function's own key
splits and handed to the port), to ``atol=1e-6``. The file readers read tiny
files that the test writes itself.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gm3d_tpu.data import datasets as jds
from gm3d_tpu.data import transforms as jtf
from gm3d_tpu.data.prefetch import device_prefetch as jdevice_prefetch
from gm3d_tpu_torch.config import DATASETS
from gm3d_tpu_torch.data import datasets as ds
from gm3d_tpu_torch.data import io
from gm3d_tpu_torch.data import transforms as tf
from gm3d_tpu_torch.data.prefetch import device_prefetch

B, N = 3, 64


def _cloud(seed, b=B, n=N):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(np.float32)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# numpy helpers and synthetic clouds: bit-equal


@pytest.mark.parametrize("labelled", [False, True])
def test_synthetic_clouds_are_bit_equal(labelled):
    kw = dict(num_samples=12, npoints=128, num_classes=5, seed=7, labelled=labelled)
    mine, theirs = ds.SyntheticClouds(**kw), jds.SyntheticClouds(**kw)
    assert len(mine) == len(theirs) == 12
    for idx in (0, 5, 11):
        got, want = mine[idx], theirs[idx]
        assert got[:2] == want[:2]
        if labelled:
            _same(got[2][0], want[2][0])
            assert got[2][1] == want[2][1]
        else:
            _same(got[2], want[2])


def test_pc_normalize_is_bit_equal_degenerate_included():
    for pts in (_cloud(1)[0], _cloud(2, 1, 1000)[0] * 7.0 + 3.0, np.full((5, 3), 0.25, np.float32)):
        _same(ds.pc_normalize(pts), jds.pc_normalize(pts))
    assert np.isfinite(ds.pc_normalize(np.full((5, 3), 0.25, np.float32))).all()


@pytest.mark.parametrize("seeded", [False, True])
def test_numpy_fps_is_bit_equal(seeded):
    pts = _cloud(3, 1, 300)[0]

    def rng():
        return np.random.RandomState(4) if seeded else None

    _same(ds.numpy_fps(pts, 40, rng=rng()), jds.numpy_fps(pts, 40, rng=rng()))


def test_item_rng_is_a_function_of_tag_epoch_and_index():
    mine, theirs = ds._ItemRng(0x5A55), jds._ItemRng(0x5A55)
    for epoch in (0, 3):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        _same(mine.for_item(9).permutation(50), theirs.for_item(9).permutation(50))


# ---------------------------------------------------------------------------
# DataLoader


def _batches(loader):
    return [b.copy() for b in loader]


def _loaders(**kw):
    data = dict(num_samples=22, npoints=32, seed=1)
    return (ds.DataLoader(ds.SyntheticClouds(**data), 4, **kw),
            jds.DataLoader(jds.SyntheticClouds(**data), 4, **kw))


@pytest.mark.parametrize("shuffle, drop_last", [(True, True), (False, False)])
def test_loader_order_equals_the_jax_loader(shuffle, drop_last):
    mine, theirs = _loaders(seed=5, shuffle=shuffle, drop_last=drop_last)
    assert len(mine) == len(theirs) == (5 if drop_last else 6)
    for _ in range(2):  # epochs 0 and 1
        got, want = _batches(mine), _batches(theirs)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    assert mine.epoch == 2


def test_loader_workers_give_the_same_batches():
    zero, _ = _loaders(seed=2, num_workers=0)
    four, _ = _loaders(seed=2, num_workers=4, prefetch=2)
    for _ in range(2):
        for g, w in zip(_batches(four), _batches(zero)):
            _same(g, w)


def test_loader_same_seed_and_epoch_same_order_other_seed_other_order():
    a, _ = _loaders(seed=3)
    b, _ = _loaders(seed=3)
    c, _ = _loaders(seed=4)
    a.load_state({"epoch": 6, "batch": 0})
    b.load_state({"epoch": 6, "batch": 0})
    c.load_state({"epoch": 6, "batch": 0})
    first_a, first_b, first_c = next(iter(a)), next(iter(b)), next(iter(c))
    _same(first_a, first_b)
    assert not np.array_equal(first_a, first_c)


@pytest.mark.parametrize("workers", [0, 3])
def test_load_state_resumes_at_the_exact_next_batch(workers):
    full, _ = _loaders(seed=8, num_workers=workers)
    full.load_state({"epoch": 1, "batch": 0})
    want = _batches(full)
    part, _ = _loaders(seed=8, num_workers=workers)
    part.load_state({"epoch": 1, "batch": 0})
    it = iter(part)
    next(it), next(it)
    token = part.state()
    assert token == {"epoch": 1, "batch": 2}
    resumed, _ = _loaders(seed=8, num_workers=workers)
    resumed.load_state(token)
    got = _batches(resumed)
    assert len(got) == len(want) - 2
    for g, w in zip(got, want[2:]):
        _same(g, w)
    assert resumed.state() == {"epoch": 2, "batch": 0}


def test_a_peek_does_not_shift_the_next_epoch():
    peeked, _ = _loaders(seed=9)
    clean, _ = _loaders(seed=9)
    peeked.load_state({"epoch": 0, "batch": 3})
    next(iter(peeked))  # a peek at an example batch, then abandoned
    peeked.load_state({"epoch": 0, "batch": 0})
    for g, w in zip(_batches(peeked), _batches(clean)):
        _same(g, w)
    # without a load_state the next iteration is a full epoch too
    fresh, _ = _loaders(seed=9)
    next(iter(fresh))
    assert len(_batches(fresh)) == len(fresh)


# ---------------------------------------------------------------------------
# readers on tiny files


def _shapenet_files(root):
    pc = root / "pc"
    pc.mkdir()
    names = ["02691156-a1.npy", "03001627-b2.npy", "04379243-c3.npy"]
    for i, name in enumerate(names):
        np.save(pc / name, _cloud(20 + i, 1, 50 + i)[0] * (i + 1))
    (root / "train.txt").write_text("\n".join(names[:2]) + "\n")
    (root / "test.txt").write_text(names[2] + "\n")
    return {"_base_": {"NAME": "ShapeNet", "DATA_PATH": str(root), "PC_PATH": str(pc)},
            "others": {"subset": "train", "npoints": 32, "whole": True}}


def test_shapenet55_reads_the_same_items(tmp_path):
    cfg = _shapenet_files(tmp_path)
    mine, theirs = ds.build_dataset_from_cfg(cfg), jds.build_dataset_from_cfg(cfg)
    assert isinstance(mine, ds.ShapeNet55) and DATASETS.get("ShapeNet") is ds.ShapeNet55
    assert len(mine) == len(theirs) == 3  # whole: train + test
    assert mine.file_list == theirs.file_list
    for epoch in (0, 1):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for idx in range(3):
            got, want = mine[idx], theirs[idx]
            assert got[:2] == want[:2]
            _same(got[2], want[2])
            assert got[2].shape == (32, 3)
    assert not np.array_equal(ds.ShapeNet55(cfg)[0][2], mine[0][2])  # another epoch


def _modelnet_files(root):
    cats = ["chair", "desk"]
    (root / "modelnet2_shape_names.txt").write_text("\n".join(cats) + "\n")
    ids = {"train": ["chair_0001", "desk_0001", "chair_0002"], "test": ["desk_0002"]}
    for split, shapes in ids.items():
        (root / f"modelnet2_{split}.txt").write_text("\n".join(shapes) + "\n")
        for i, shape in enumerate(shapes):
            cat = shape.rsplit("_", 1)[0]
            (root / cat).mkdir(exist_ok=True)
            # fewer rows than the 8192 the reader samples: FPS repeats points
            # then, and the test stays fast
            rows = np.random.default_rng(len(shape) + i).standard_normal((120, 6))
            np.savetxt(root / cat / f"{shape}.txt", rows, delimiter=",", fmt="%.6f")
    return {"_base_": {"NAME": "ModelNet", "DATA_PATH": str(root), "NUM_CATEGORY": 2,
                       "USE_NORMALS": False},
            "others": {"subset": "train", "npoints": 64}}


def test_modelnet_reads_the_same_items_and_its_cache(tmp_path):
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    jax_root.mkdir()
    port_root.mkdir()
    jcfg, cfg = _modelnet_files(jax_root), _modelnet_files(port_root)
    theirs, mine = jds.build_dataset_from_cfg(jcfg), ds.build_dataset_from_cfg(cfg)
    assert isinstance(mine, ds.ModelNet) and len(mine) == len(theirs) == 3
    cache = port_root / "modelnet2_train_8192pts_fps.dat"
    assert cache.exists()
    _same(mine.points, theirs.points)
    _same(mine.labels, theirs.labels)
    for idx in range(3):
        got, want = mine[idx], theirs[idx]
        _same(got[2][0], want[2][0])
        assert got[2][1] == want[2][1] and got[2][0].shape == (64, 3)
    # the second construction reads the pickle: the text files are not needed
    for txt in port_root.glob("*/*.txt"):
        txt.unlink()
    again = ds.ModelNet(cfg)
    _same(again.points, mine.points)
    with open(cache, "rb") as f:
        points, labels = pickle.load(f)
    _same(points, theirs.points)
    # a truncated cache is preprocessed again, not trusted
    jcache = jax_root / "modelnet2_train_8192pts_fps.dat"
    jcache.write_bytes(jcache.read_bytes()[:100])
    (port_root / "modelnet2_train_8192pts_fps.dat").write_bytes(b"\x80\x04trunc")
    _modelnet_files(port_root)
    _same(ds.ModelNet(cfg).points, theirs.points)


def test_io_reads_npy_and_txt_and_refuses_others(tmp_path):
    pts = _cloud(30, 1, 5)[0]
    np.save(tmp_path / "a.npy", pts)
    np.savetxt(tmp_path / "a.txt", pts, delimiter=",")
    _same(io.get(str(tmp_path / "a.npy")), pts)
    np.testing.assert_allclose(io.get(str(tmp_path / "a.txt")), pts, atol=1e-6)
    with pytest.raises(ValueError, match="unsupported"):
        io.get(str(tmp_path / "a.ply"))


def test_unknown_dataset_name_raises():
    # a reader not ported yet (the few-shot folds, ROADMAP.md Queue 1 item 4b)
    with pytest.raises(KeyError, match="not registered"):
        ds.build_dataset_from_cfg({"_base_": {"NAME": "ModelNetFewShot"}})


# ---------------------------------------------------------------------------
# augmentations against the JAX functions, on the JAX draws


def _t(x):
    return torch.from_numpy(np.array(x))


def _draws_of(name, key, pts):
    """The draws the JAX function makes from ``key``, in the port's names."""
    b, n = pts.shape[:2]
    uni = jax.random.uniform
    if name == "scale":
        return {"factor": uni(key, (b, 1, 3), minval=2.0 / 3.0, maxval=1.5)}
    if name == "translate":
        return {"shift": uni(key, (b, 1, 3), minval=-0.2, maxval=0.2)}
    if name == "random_horizontal_flip":
        r_apply, r_flip = jax.random.split(key)
        return {"u_apply": uni(r_apply, (b, 1, 1)), "u_flip": uni(r_flip, (b, 1, 3))}
    if name == "rotate_z":
        return {"theta": uni(key, (b,), maxval=2.0 * jnp.pi)}
    if name == "jitter":
        return {"normal": jax.random.normal(key, pts.shape)}
    if name == "random_dropout":
        r_ratio, r_mask = jax.random.split(key)
        return {"u_ratio": uni(r_ratio, (b, 1)), "u_drop": uni(r_mask, (b, n))}
    if name == "scale_and_translate":
        r_scale, r_shift = jax.random.split(key)
        return {"scale": uni(r_scale, (b, 1, 3), minval=2.0 / 3.0, maxval=1.5),
                "shift": uni(r_shift, (b, 1, 3), minval=-0.2, maxval=0.2)}
    raise KeyError(name)


TRANSFORMS = ["scale", "translate", "random_horizontal_flip", "rotate_z", "jitter",
              "random_dropout", "scale_and_translate"]


@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_agrees_with_jax_on_its_draws(name):
    pts = _cloud(40, 6, 50)
    pts[:, :, 2] *= 2.0  # flip: a non-trivial upright axis
    key = jax.random.key(TRANSFORMS.index(name))
    want = np.asarray(getattr(jtf, name)(key, jnp.asarray(pts)))
    draws = {k: _t(v) for k, v in _draws_of(name, key, pts).items()}
    got = getattr(tf, name)(None, torch.from_numpy(pts), **draws)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # the function moved the points: the draws were used
    assert not np.allclose(got.numpy(), pts)


def test_separate_point_cloud_agrees_with_jax():
    pts = _cloud(41, 4, 80)
    key = jax.random.key(9)
    want_keep, want_crop = jtf.separate_point_cloud(key, jnp.asarray(pts), 20)
    direction = _t(jax.random.normal(key, (4, 1, 3)))
    keep, crop = tf.separate_point_cloud(None, torch.from_numpy(pts), 20, direction=direction)
    assert tuple(keep.shape) == (4, 60, 3) and tuple(crop.shape) == (4, 20, 3)
    np.testing.assert_allclose(keep.numpy(), np.asarray(want_keep), atol=1e-6, rtol=0)
    np.testing.assert_allclose(crop.numpy(), np.asarray(want_crop), atol=1e-6, rtol=0)


def test_unit_sphere_normalize_agrees_with_jax_degenerate_included():
    pts = _cloud(42, 3, 40) * 5.0 + 2.0
    pts[1] = 0.5  # all-identical: centred, not divided by 0
    want = np.asarray(jtf.unit_sphere_normalize(jnp.asarray(pts)))
    got = tf.unit_sphere_normalize(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("name", TRANSFORMS + ["separate_point_cloud"])
def test_transform_draws_from_a_generator(name):
    """Without draws a transform draws from the generator: the same seed gives
    the same result, another seed another."""
    pts = torch.from_numpy(_cloud(43))
    args = (20,) if name == "separate_point_cloud" else ()

    def run(seed):
        out = getattr(tf, name)(torch.Generator().manual_seed(seed), pts, *args)
        return out[0] if isinstance(out, tuple) else out

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))


# ---------------------------------------------------------------------------
# device_prefetch


def test_device_prefetch_state_is_the_token_of_the_last_batch_yielded():
    mine, theirs = _loaders(seed=11)
    pre, jpre = device_prefetch(mine, size=2, device="cpu"), jdevice_prefetch(theirs, size=2)
    assert pre.state() == jpre.state() == {"epoch": 0, "batch": 0}
    seen = []
    for i, (got, want) in enumerate(zip(pre, jpre)):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        _same(got.numpy(), np.asarray(want))
        # the loader has run ahead by the prefetch depth; the token has not
        assert pre.state() == jpre.state() == {"epoch": 0, "batch": i + 1}
        seen.append(pre.state())
        if i == 0:
            assert mine.state()["batch"] == min(3, len(mine))
    assert len(seen) == len(mine) == 5
    # as in the JAX package: the token of the last batch, taken when it was pulled
    assert pre.state() == jpre.state() == {"epoch": 0, "batch": 5}


def test_device_prefetch_carries_tuples_and_resumes_mid_epoch():
    data = ds.SyntheticClouds(num_samples=10, npoints=16, seed=2, labelled=True)
    loader = ds.DataLoader(data, 2, seed=3)
    loader.load_state({"epoch": 0, "batch": 3})
    pre = device_prefetch(loader, device="cpu")
    batches = list(pre)
    assert len(batches) == 2
    pts, labels = batches[0]
    assert tuple(pts.shape) == (2, 16, 3) and labels.dtype == torch.int64
    assert pre.state() == {"epoch": 0, "batch": 5}
    assert loader.state() == {"epoch": 1, "batch": 0}


def test_device_prefetch_defaults_to_cuda_and_says_so():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        device_prefetch(iter([]))


def test_jsonl_and_scalar_writer(tmp_path):
    from gm3d_tpu_torch.utils import JsonlLogger, ScalarWriter, print_log

    log = JsonlLogger(str(tmp_path / "sub" / "log.txt"))
    log.write({"epoch": 0, "loss": 1.5})
    log.write({"epoch": 1, "loss": 1.25})
    lines = (tmp_path / "sub" / "log.txt").read_text().splitlines()
    assert [json.loads(line) for line in lines] == [{"epoch": 0, "loss": 1.5},
                                                    {"epoch": 1, "loss": 1.25}]
    writer = ScalarWriter(None)  # no directory: a no-op
    writer.add_scalar("x", 1.0, 0)
    writer.flush()
    print_log("hello")
    assert not os.path.exists(tmp_path / "none")
