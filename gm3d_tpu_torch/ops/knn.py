"""Exact k-nearest-neighbour search.

Port of ``gm3d_tpu/ops/knn.py``. For every query point the ``k`` reference
points with the smallest squared distance ``q2 - 2 q.r + r2``, in ascending
order, the first index among equal distances.

Two implementations of the same function:

  - ``knn_indices_torch``: the plain PyTorch version (the full distance
    matrix, then a stable sort). The CPU tests use it and the kernel is held
    against it on the card.
  - the CUDA kernel ``csrc/knn.cu`` (one warp per query; the distance matrix
    stays in shared memory), which ``knn_indices`` launches for every CUDA
    tensor, whatever its shape.

``knn_indices`` takes the plain version only for tensors that lie on the
CPU. For CUDA tensors it launches the kernel or raises. ``k > N`` raises
``ValueError`` on both routes.
"""

from __future__ import annotations

import torch

from gm3d_tpu_torch.ops import _build

# `warps` queries of a block each keep a row of N distances in shared memory
_SMEM_LIMIT = 227 * 1024
MAX_REF = _SMEM_LIMIT // 4


def _sq_distances(ref: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """(B, G, N) squared distances, ``q2 - 2*cross + r2`` with every dot
    product summed x, y, z in that order. The three products are written out
    (no ``matmul``/``cdist``) so that the summation order is this code's and
    not a library's: the kernel repeats it operation for operation."""
    qx, qy, qz = (query[..., c, None] for c in range(3))      # (B, G, 1)
    rx, ry, rz = (ref[:, None, :, c] for c in range(3))       # (B, 1, N)
    cross = qx * rx + qy * ry + qz * rz
    q2 = qx * qx + qy * qy + qz * qz
    r2 = rx * rx + ry * ry + rz * rz
    return q2 - 2.0 * cross + r2


def _check(ref: torch.Tensor, query: torch.Tensor, k: int) -> None:
    if ref.ndim != 3 or ref.shape[-1] != 3:
        raise ValueError(f"expected (B, N, 3) ref, got {tuple(ref.shape)}")
    if query.ndim != 3 or query.shape[-1] != 3 or query.shape[0] != ref.shape[0]:
        raise ValueError(
            f"expected (B, G, 3) query with B={ref.shape[0]}, got {tuple(query.shape)}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if k > ref.shape[1]:
        raise ValueError(
            f"k={k} exceeds the {ref.shape[1]} reference points: there are "
            "not k distinct neighbours")
    if ref.device != query.device:
        raise ValueError(f"ref on {ref.device} but query on {query.device}")


def knn_indices_torch(ref: torch.Tensor, query: torch.Tensor, k: int,
                      return_dist: bool = False):
    """Plain version. ref (B, N, 3), query (B, G, 3) -> idx (B, G, k) int32,
    and dist (B, G, k) fp32 first if ``return_dist``."""
    _check(ref, query, k)
    dist = _sq_distances(ref.to(torch.float32), query.to(torch.float32))
    # a stable ascending sort keeps the first index among equal distances
    kdist, idx = torch.sort(dist, dim=-1, stable=True)
    kdist, idx = kdist[..., :k].contiguous(), idx[..., :k].to(torch.int32)
    if return_dist:
        return kdist, idx
    return idx


def _block_warps(num_ref: int, num_query: int) -> int:
    """Queries (warps) sharing a block: four, fewer when the cloud has fewer
    queries or when their rows would take more than 64 KB of shared memory
    (then several blocks still fit on an SM; ``scripts/tune_kernels.py``)."""
    warps = max(1, min(4, num_query))
    while warps > 1 and warps * num_ref * 4 > 64 * 1024:
        warps //= 2
    return warps


def knn_indices(ref: torch.Tensor, query: torch.Tensor, k: int,
                return_dist: bool = False):
    """k nearest neighbours of each query point among the reference points.

    ref:   (B, N, 3) reference cloud
    query: (B, G, 3) query points
    Returns idx (B, G, k) int32, and squared distances (B, G, k) fp32 first,
    as ``(dist, idx)``, if ``return_dist``; ascending distance.
    """
    _check(ref, query, k)
    if not ref.is_cuda:
        return knn_indices_torch(ref, query, k, return_dist)
    batch, num_ref, _ = ref.shape
    num_query = query.shape[1]
    if num_ref > MAX_REF:
        raise ValueError(
            f"the KNN kernel holds a query's distances in shared memory: at "
            f"most {MAX_REF} reference points, got {num_ref}")
    if batch > 65535:
        raise ValueError(f"the KNN kernel takes at most 65535 clouds, got {batch}")
    ref = ref.to(torch.float32).contiguous()
    query = query.to(torch.float32).contiguous()
    idx = torch.empty((batch, num_query, k), dtype=torch.int32, device=ref.device)
    dist = torch.empty((batch, num_query, k), dtype=torch.float32, device=ref.device)
    if batch and num_query:
        lib = _build.load_library()
        with torch.cuda.device(ref.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gm3d_knn(ref.data_ptr(), query.data_ptr(), idx.data_ptr(),
                              dist.data_ptr(), batch, num_ref, num_query, k,
                              _block_warps(num_ref, num_query), stream)
        _build.check_launch(rc, "knn")
        knn_indices.launches += 1
    if return_dist:
        return dist, idx
    return idx


# launches of the CUDA kernel by this process (the plain version never counts)
knn_indices.launches = 0
