"""The selection inside the port's KNN and FPS kernels, emulated on the CPU.

``csrc/knn.cu`` reaches its answer by a threshold and a candidate sort, and
``csrc/fps.cu`` by a two-step ``redux`` arg-max over threads that own points
i = t (mod T). Neither kernel runs here, so their plain emulations
(``knn_select_emulated``, ``fps_indices_emulated``) are held against the plain
versions and against the JAX package (its XLA route and its Pallas kernel in
interpret mode) on clouds made from numpy seeds: standard-normal and
unit-ball clouds, grids with duplicated points (ties at the threshold), all
points identical, N not a multiple of 32 and under 32, k from 1 to N.
Indices must be equal; distances equal to the plain version's bit for bit and
within 1e-5 of the JAX package's (its cross term is a matmul).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gm3d_tpu.ops.fps import fps_indices_jax
from gm3d_tpu.ops.knn import knn_indices_pallas, knn_indices_xla

# the modules (the package exports functions of the same names)
fps_ops = importlib.import_module("gm3d_tpu_torch.ops.fps")
knn_ops = importlib.import_module("gm3d_tpu_torch.ops.knn")


def _normal(seed, b, n):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(np.float32)


def _unit_ball(seed, b, n):
    pts = _normal(seed, b, n)
    return pts / np.linalg.norm(pts, axis=-1).max(axis=-1)[:, None, None]


def _grid(seed, b, n, dup):
    """Multiples of 1/8 on a small grid (many equal distances) with the first
    ``dup`` points repeated at the end."""
    pts = np.random.default_rng(seed).integers(-4, 5, size=(b, n, 3)).astype(np.float32) / 8.0
    pts[:, n - dup:] = pts[:, :dup]
    return pts


def _identical(b, n):
    return np.full((b, n, 3), 0.375, np.float32)


# name -> (ref, query, k, standard-normal); queries are cloud points where the
# serving and training paths make them so (FPS centers are cloud points)
KNN_CASES = {
    "normal N512 G64 k32": lambda: (_normal(1, 2, 512), None, 64, 32, True),
    "normal N1024 G64 k32": lambda: (_normal(2, 2, 1024), None, 64, 32, True),
    "normal N2048 G128 k16": lambda: (_normal(3, 1, 2048), None, 128, 16, True),
    "unit ball N512 G64 k32": lambda: (_unit_ball(4, 2, 512), None, 64, 32, False),
    "grid with duplicates N256 k24": lambda: (_grid(5, 2, 256, 96), None, 48, 24, False),
    "all identical N256 k32": lambda: (_identical(2, 256), None, 16, 32, False),
    "N300 not a multiple of 32 k7": lambda: (_normal(6, 2, 300), _normal(7, 2, 100), None, 7,
                                             True),
    "N20 under 32 k5": lambda: (_normal(8, 3, 20), _normal(9, 3, 8), None, 5, True),
    "k1": lambda: (_normal(10, 2, 512), None, 64, 1, True),
    "k=N=40": lambda: (_normal(11, 2, 40), None, 16, 40, False),
    "k=N=100": lambda: (_normal(12, 2, 100), None, 16, 100, False),
    "k=N=200 above the buffer": lambda: (_normal(16, 1, 200), None, 8, 200, False),
    "k48": lambda: (_normal(13, 2, 1024), None, 32, 48, False),
    "segmentation k3 256 queries 128 refs": lambda: (_normal(14, 2, 128), _normal(15, 2, 256),
                                                     None, 3, True),
}


def _knn_case(name):
    ref, query, g, k, normal = KNN_CASES[name]()
    if query is None:
        query = ref[:, :g].copy()
    return ref, query, k, normal


@pytest.mark.parametrize("name", sorted(KNN_CASES))
def test_knn_selection_matches_plain_and_jax(name):
    ref, query, k, normal = _knn_case(name)
    tr, tq = torch.from_numpy(ref), torch.from_numpy(query)
    ed, ei, stats = knn_ops.knn_select_emulated(tr, tq, k)
    wd, wi = knn_ops.knn_indices_torch(tr, tq, k, return_dist=True)
    assert ei.dtype == torch.int32 and ei.shape == (ref.shape[0], query.shape[1], k)
    np.testing.assert_array_equal(ei.numpy(), wi.numpy())
    np.testing.assert_array_equal(ed.numpy(), wd.numpy())
    pi, pd = knn_indices_pallas(jnp.asarray(ref), jnp.asarray(query), k, interpret=True)
    np.testing.assert_array_equal(ei.numpy(), np.asarray(pi))
    np.testing.assert_allclose(ed.numpy(), np.asarray(pd), rtol=1e-5, atol=1e-5)
    xd, xi = knn_indices_xla(jnp.asarray(ref), jnp.asarray(query), k, return_dist=True)
    np.testing.assert_allclose(ed.numpy(), np.asarray(xd), rtol=1e-5, atol=1e-5)
    if normal:
        # no ties: the XLA route's order is the same
        np.testing.assert_array_equal(ei.numpy(), np.asarray(xi))
    if normal and k <= 32:
        # the fast path is the one under test: every query fits the buffer
        assert stats["overflow"] == 0
        assert int(stats["candidates"].max()) <= knn_ops.CAP
        assert int(stats["candidates"].min()) >= k


def test_knn_identical_points_take_the_k_round_selection():
    ref, query, k, _ = _knn_case("all identical N256 k32")
    ed, ei, stats = knn_ops.knn_select_emulated(torch.from_numpy(ref), torch.from_numpy(query), k)
    # every point ties at tau: C = N, and the first k indices in order
    assert stats["overflow"] == query.shape[0] * query.shape[1]
    assert bool((stats["candidates"] == ref.shape[1]).all())
    np.testing.assert_array_equal(ei.numpy(), np.broadcast_to(np.arange(k), ei.shape))
    assert bool((ed == 0).all())


@pytest.mark.parametrize("runs", [1, 2, 4, 8])
def test_knn_selection_any_runs_a_lane(runs):
    """R only moves tau: fewer runs, more candidates, more overflow; the answer
    stays the plain version's (k 64 with R 2 overflows on some queries)."""
    ref = _normal(20, 2, 1024)
    for k in (1, 16, 32, 48, 64):
        if 32 * runs < k:
            continue
        tr, tq = torch.from_numpy(ref), torch.from_numpy(ref[:, :32].copy())
        ed, ei, stats = knn_ops.knn_select_emulated(tr, tq, k, runs=runs)
        wd, wi = knn_ops.knn_indices_torch(tr, tq, k, return_dist=True)
        np.testing.assert_array_equal(ei.numpy(), wi.numpy())
        np.testing.assert_array_equal(ed.numpy(), wd.numpy())
        assert int(stats["candidates"].min()) >= k


def test_knn_runs_and_limits_of_the_wrapper():
    for k in range(1, knn_ops.CAP + 1):
        runs = knn_ops.runs_for(k)
        assert runs in (1, 2, 4, 8) and 32 * runs >= k
    assert [knn_ops.runs_for(k) for k in (1, 8, 16, 32, 48, 64, 100)] == [1, 1, 2, 2, 4, 4, 8]
    assert knn_ops.MAX_REF >= 57856
    for n in (1, 20, 300, 1024, 2048, 4096, 8192, 16384, knn_ops.MAX_REF):
        warps, per_block, runs, staged = knn_ops._launch_geometry(128, n, 64, 32)
        assert knn_ops._geometry_fits(n, warps, bool(staged)) and 1 <= per_block <= 64
    assert not knn_ops._geometry_fits(knn_ops.MAX_REF + 1, 1, False)


@pytest.mark.parametrize("num_ref, staged, warps", [
    (1024, 1, 16), (2048, 1, 16), (4096, 1, 9), (7136, 1, 4),
    (7137, 0, 7), (8192, 0, 6), (16384, 0, 3), (57856, 0, 1)])
def test_knn_stages_the_cloud_only_where_four_warps_fit(num_ref, staged, warps):
    """The cloud goes to shared memory while four warps' rows fit beside it;
    above that the kernel reads it from L2 and fits as many warps as the rows
    allow, so large clouds keep the occupancy of the design before."""
    got = knn_ops._launch_geometry(32, num_ref, 64, 32)
    assert (got[3], got[0]) == (staged, warps)
    assert knn_ops._geometry_fits(num_ref, warps, bool(staged))
    assert not knn_ops._geometry_fits(num_ref, warps + 1, bool(staged)) or warps == 16
    if staged:
        assert knn_ops._max_warps(num_ref, True) >= knn_ops.STAGE_MIN_WARPS
    else:
        assert knn_ops._max_warps(num_ref, True) < knn_ops.STAGE_MIN_WARPS


@pytest.mark.parametrize("batch, num_ref, num_query, per_block", [
    (128, 1024, 64, 32), (256, 1024, 64, 64), (32, 2048, 512, 64), (32, 4096, 64, 18),
    (32, 8192, 64, 6), (4, 128, 2048, 16), (3, 20, 8, 8)])
def test_knn_queries_a_block_fill_the_card(batch, num_ref, num_query, per_block):
    """On 132 SMs: the queries a block that the profile found fastest (or
    within 4% of it) at the shapes the package meets."""
    assert knn_ops._launch_geometry(batch, num_ref, num_query, 32)[1] == per_block


def test_ordered_key_keeps_order_and_equality():
    rng = np.random.default_rng(30)
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1e-30, -1e-30,
                        np.finfo(np.float32).max, -np.finfo(np.float32).max], np.float32)
    vals = np.concatenate([special, rng.standard_normal(500).astype(np.float32),
                           (rng.standard_normal(200) * 1e-6).astype(np.float32),
                           -np.abs(rng.standard_normal(100)).astype(np.float32)])
    vals = np.concatenate([vals, vals[:50]])  # repeats
    t = torch.from_numpy(vals)
    key = knn_ops.ordered_key(t)
    assert bool(((key >= 0) & (key < 2 ** 32)).all())
    less = t[:, None] < t[None, :]
    same = t[:, None] == t[None, :]        # -0.0 == +0.0
    assert torch.equal(key[:, None] < key[None, :], less)
    assert torch.equal(key[:, None] == key[None, :], same)
    assert bool((key < knn_ops.NONE).all())
    back = knn_ops.key_value(key)
    assert torch.equal(back, t + 0.0)      # the value, -0.0 as +0.0
    assert not bool(torch.signbit(knn_ops.key_value(knn_ops.ordered_key(
        torch.tensor([-0.0])))).any())


FPS_CASES = {
    "grid ties N192": lambda: (_grid(40, 3, 192, 64), 48),
    "grid ties N300": lambda: (_grid(41, 2, 300, 100), 64),
    "grid ties N20 n30": lambda: (_grid(42, 2, 20, 8), 30),
    "all identical": lambda: (_identical(2, 70), 12),
    "normal N256": lambda: (_normal(43, 2, 256), 40),
}


@pytest.mark.parametrize("threads", [32, 64, 128, 256])
@pytest.mark.parametrize("name", sorted(FPS_CASES))
def test_fps_redux_argmax_matches_plain_and_jax(name, threads):
    pts, n = FPS_CASES[name]()
    got = fps_ops.fps_indices_emulated(torch.from_numpy(pts), n, threads)
    want = fps_ops.fps_indices_torch(torch.from_numpy(pts), n)
    assert got.dtype == torch.int32 and got.shape == (pts.shape[0], n)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(fps_indices_jax(jnp.asarray(pts), n)))


def test_fps_geometry_of_the_wrapper():
    assert fps_ops.MAX_POINTS == 14496
    for n in (1, 20, 200, 1024, 2048, 4096, 5000, 8192, 8193, 10000, fps_ops.MAX_POINTS):
        threads = fps_ops._block_threads(n)
        assert fps_ops._geometry_fits(n, threads)
        assert 1 <= fps_ops.points_per_thread(n, threads) <= 32
        # registers up to 8192 points, shared memory above
        assert fps_ops.in_registers(n, threads) == (n <= 8192)
    assert [fps_ops._block_threads(n) for n in (1024, 2048, 8192, 10000)] == [256, 512, 256, 1024]
    assert fps_ops.points_per_thread(8193, 256) == 0
    assert not fps_ops.in_registers(8192, 512 + 32)      # P 16 holds 512 threads
    assert fps_ops._geometry_fits(8192, 512 + 32)         # x, y, z in shared memory
    assert not fps_ops._geometry_fits(8192, 128 + 32)     # P 32 allows 256 threads
    assert fps_ops.in_registers(8192, 1024)               # P 8
    assert not fps_ops._geometry_fits(fps_ops.MAX_POINTS + 1, 1024)


@pytest.mark.parametrize("threads", [608, 1024])
def test_fps_shared_memory_geometry_selects_as_plain(threads):
    """Above 8192 points the kernel reads x, y, z from shared memory but owns
    points as before (i = t mod T), so its selection is the same."""
    pts = _normal(44, 1, 9000)
    assert not fps_ops.in_registers(9000, threads) and fps_ops._geometry_fits(9000, threads)
    got = fps_ops.fps_indices_emulated(torch.from_numpy(pts), 24, threads)
    np.testing.assert_array_equal(
        got.numpy(), fps_ops.fps_indices_torch(torch.from_numpy(pts), 24).numpy())


@pytest.mark.parametrize("n_input, device, refused", [
    (8192, "cuda", False), (10000, "cuda", False), (14496, "cuda", False),
    (14497, "cuda", True), (20000, "cpu", False), (1024, "cuda", False)])
def test_export_refuses_inputs_the_fps_kernel_cannot_take(n_input, device, refused):
    from gm3d_tpu_torch.cli.export_model import check_input_points
    if refused:
        with pytest.raises(ValueError, match="at most 14496 points"):
            check_input_points(n_input, 1024, torch.device(device))
    else:
        check_input_points(n_input, 1024, torch.device(device))
