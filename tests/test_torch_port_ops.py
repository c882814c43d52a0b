"""gm3d_tpu_torch geometry ops against their gm3d_tpu counterparts (CPU).

The plain PyTorch versions of FPS and KNN (what the CUDA kernels are held
against on the card) must pick the same indices as the JAX package's XLA
formulations AND its Pallas kernels in interpret mode, ties included. Inputs
come from numpy seeds and go to both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gm3d_tpu.ops.fps import fps_indices_jax, fps_indices_pallas_batched
from gm3d_tpu.ops.group import group_points as group_points_jax
from gm3d_tpu.ops.knn import knn_indices_pallas, knn_indices_xla
from gm3d_tpu_torch.ops import (
    fps,
    fps_gather,
    fps_indices,
    fps_indices_torch,
    group_points,
    knn_indices,
    knn_indices_torch,
)


def _cloud(seed, b, n):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(np.float32)


def _unit_cloud(seed, b, n):
    """A cloud normalised into the unit ball, as the data pipeline hands clouds
    to the model: the expansion q2 - 2 q.r + r2 cancels, so its absolute
    error scales with |q|^2 + |r|^2 and the distance tolerance assumes <= 2."""
    pts = _cloud(seed, b, n)
    return pts / np.linalg.norm(pts, axis=-1).max(axis=-1)[:, None, None]


def _grid_cloud(seed, b, n, dup):
    """Multiples of 1/64 (every product and sum is exact in fp32, so no FMA
    contraction can flip a comparison) with ``dup`` duplicated points."""
    pts = np.random.default_rng(seed).integers(-64, 65, size=(b, n, 3)).astype(np.float32) / 64.0
    pts[:, n - dup:] = pts[:, :dup]
    return pts


FPS_CASES = {
    "random_n200": lambda: (_cloud(11, 10, 200), 24),     # N > 128, batch % tile != 0
    "random_n256": lambda: (_cloud(12, 3, 256), 100),
    "ties_grid": lambda: (_grid_cloud(13, 5, 192, 64), 48),
}


@pytest.mark.parametrize("case", sorted(FPS_CASES))
def test_fps_matches_jax_loop(case):
    pts, n = FPS_CASES[case]()
    got = fps_indices_torch(torch.from_numpy(pts), n)
    want = np.asarray(fps_indices_jax(jnp.asarray(pts), n))
    assert got.dtype == torch.int32 and got.shape == (pts.shape[0], n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(FPS_CASES))
def test_fps_matches_pallas_interpret(case):
    pts, n = FPS_CASES[case]()
    got = fps_indices_torch(torch.from_numpy(pts), n)
    want = np.asarray(
        fps_indices_pallas_batched(jnp.asarray(pts), n, batch_tile=4, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fps_first_pick_is_zero_and_ties_take_lowest_index():
    # four corners of a square, each present twice: after pick 0 the three
    # other corners tie pairwise with their duplicates; the lowest index wins
    sq = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    pts = np.concatenate([sq, sq])[None]
    got = fps_indices_torch(torch.from_numpy(pts), 4).numpy()[0]
    assert got[0] == 0
    assert got[1] == 3  # the far corner (distance 2), not its duplicate 7
    assert set(got[2:]) == {1, 2}


def test_fps_wrapper_on_cpu_takes_plain_version_and_does_not_count():
    pts = torch.from_numpy(_cloud(1, 2, 64))
    before = fps_indices.launches
    np.testing.assert_array_equal(fps_indices(pts, 8).numpy(),
                                  fps_indices_torch(pts, 8).numpy())
    assert fps_indices.launches == before
    idx = fps_indices(pts, 8)
    np.testing.assert_array_equal(fps(pts, 8).numpy(), fps_gather(pts, idx).numpy())
    np.testing.assert_array_equal(
        fps_gather(pts, idx).numpy(),
        np.take_along_axis(pts.numpy(), idx.numpy()[..., None].astype(np.int64), axis=1))
    with pytest.raises(ValueError):
        fps_indices(pts[0], 8)


KNN_SHAPES = [(2, 256, 16, 8), (2, 300, 100, 7), (3, 128, 16, 32), (2, 64, 40, 1)]


@pytest.mark.parametrize("shape", KNN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_knn_matches_pallas_interpret_and_xla(shape):
    b, n, g, k = shape
    ref, q = _unit_cloud(sum(shape), b, n), _unit_cloud(sum(shape) + 1, b, g)
    gd, gi = knn_indices_torch(torch.from_numpy(ref), torch.from_numpy(q), k, return_dist=True)
    pi, pd = knn_indices_pallas(jnp.asarray(ref), jnp.asarray(q), k, interpret=True)
    xd, xi = knn_indices_xla(jnp.asarray(ref), jnp.asarray(q), k, return_dist=True)
    assert gi.dtype == torch.int32 and gi.shape == (b, g, k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(xi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(pd), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gd.numpy(), np.asarray(xd), rtol=1e-5, atol=1e-6)
    assert (np.diff(gd.numpy(), axis=-1) >= 0).all(), "not ascending"


def test_knn_ties_keep_first_index_like_pallas():
    ref = _grid_cloud(21, 3, 160, 64)   # points 96..159 duplicate 0..63
    q = ref[:, :24].copy()
    gd, gi = knn_indices_torch(torch.from_numpy(ref), torch.from_numpy(q), 12, return_dist=True)
    pi, pd = knn_indices_pallas(jnp.asarray(ref), jnp.asarray(q), 12, interpret=True)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(pd))
    # query j sits on reference j and on its duplicate 96+j: distance 0 twice,
    # the lower index first
    np.testing.assert_array_equal(gi.numpy()[:, :, 0], np.tile(np.arange(24), (3, 1)))
    np.testing.assert_array_equal(gi.numpy()[:, :, 1], np.tile(96 + np.arange(24), (3, 1)))
    # among equal distances the indices rise
    d, i = gd.numpy(), gi.numpy()
    same = d[..., 1:] == d[..., :-1]
    assert (i[..., 1:][same] > i[..., :-1][same]).all()


def test_knn_rejects_k_above_n_and_bad_shapes():
    ref, q = torch.from_numpy(_cloud(3, 2, 8)), torch.from_numpy(_cloud(4, 2, 4))
    for fn in (knn_indices, knn_indices_torch):
        with pytest.raises(ValueError, match="exceeds"):
            fn(ref, q, 9)
        with pytest.raises(ValueError):
            fn(ref, q, 0)
        with pytest.raises(ValueError):
            fn(ref, q[:1], 2)
    assert knn_indices(ref, q, 8).shape == (2, 4, 8)


def test_knn_wrapper_on_cpu_takes_plain_version_and_does_not_count():
    ref, q = torch.from_numpy(_cloud(5, 2, 96)), torch.from_numpy(_cloud(6, 2, 10))
    before = knn_indices.launches
    idx = knn_indices(ref, q, 5)
    dist, idx2 = knn_indices(ref, q, 5, return_dist=True)
    assert knn_indices.launches == before
    np.testing.assert_array_equal(idx.numpy(), idx2.numpy())
    np.testing.assert_array_equal(idx.numpy(), knn_indices_torch(ref, q, 5).numpy())
    brute = ((q.numpy()[:, :, None] - ref.numpy()[:, None]) ** 2).sum(-1)
    np.testing.assert_allclose(dist.numpy(), np.sort(brute, -1)[..., :5], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 256, 16, 8), (2, 128, 8, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_group_points_matches_jax(shape):
    b, n, g, s = shape
    pts = _cloud(31 + n, b, n)
    got = group_points(torch.from_numpy(pts), g, s)
    want = group_points_jax(jnp.asarray(pts), g, s)
    for name in ("neighborhood", "center", "neighborhood_org"):
        a, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a, w, atol=1e-6, err_msg=name)
