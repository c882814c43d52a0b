"""Furthest-point sampling (FPS).

Port of ``gm3d_tpu/ops/fps.py``. Semantics: the first selected point is
index 0; each later selection is the point with the maximum distance to the
already-selected set (squared Euclidean metric, ties broken by lowest index).

Two implementations of the same function:

  - ``fps_indices_torch``: the plain PyTorch version (a Python loop of
    tensor ops). The CPU tests use it and the kernel is held against it on
    the card.
  - the CUDA kernel ``csrc/fps.cu`` (one thread block per cloud), which
    ``fps_indices`` launches for every CUDA tensor.

``fps_indices`` takes the plain version only for a tensor that lies on the
CPU. For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from gm3d_tpu_torch.ops import _build

# a block keeps x, y, z and the running minimum of its cloud in shared memory
_SMEM_LIMIT = 227 * 1024
MAX_POINTS = _SMEM_LIMIT // 16


def fps_indices_torch(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Plain version. xyz: (B, N, 3) -> (B, n_samples) int32.

    The distance is ``(x-cx)^2 + (y-cy)^2 + (z-cz)^2`` summed in that order,
    the formula and order the kernel uses, so both pick the same indices."""
    batch, num_points, _ = xyz.shape
    xyz = xyz.to(torch.float32)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]  # (B, N)
    idxs = torch.zeros((batch, n_samples), dtype=torch.int64, device=xyz.device)
    min_dist = torch.full((batch, num_points), float("inf"),
                          dtype=torch.float32, device=xyz.device)
    last = torch.zeros((batch, 1), dtype=torch.int64, device=xyz.device)
    lanes = torch.arange(num_points, device=xyz.device)
    for i in range(1, n_samples):
        cx, cy, cz = x.gather(1, last), y.gather(1, last), z.gather(1, last)
        dist = (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2
        min_dist = torch.minimum(min_dist, dist)
        # lowest index among the maxima (argmax alone does not promise it)
        best = min_dist.max(dim=1, keepdim=True).values
        last = torch.where(min_dist == best, lanes, num_points).min(
            dim=1, keepdim=True).values
        idxs[:, i] = last[:, 0]
    return idxs.to(torch.int32)


def _block_threads(num_points: int) -> int:
    """Threads of the cloud's block: about four points a thread, at most 512.
    More warps make the block-wide arg-max of every round longer than the
    shorter update repays (measured by ``scripts/tune_kernels.py``)."""
    want = -(-num_points // 4)
    return min(512, max(32, -(-want // 32) * 32))


def fps_indices(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Furthest-point-sample indices. xyz: (B, N, 3) -> (B, n_samples) int32."""
    if xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"expected (B, N, 3) points, got {tuple(xyz.shape)}")
    batch, num_points, _ = xyz.shape
    if n_samples < 1:
        raise ValueError(f"n_samples must be >= 1, got {n_samples}")
    if not xyz.is_cuda:
        return fps_indices_torch(xyz, n_samples)
    if num_points > MAX_POINTS:
        raise ValueError(
            f"the FPS kernel holds a cloud in shared memory: at most "
            f"{MAX_POINTS} points, got {num_points}")
    xyz = xyz.to(torch.float32).contiguous()
    out = torch.empty((batch, n_samples), dtype=torch.int32, device=xyz.device)
    if batch == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gm3d_fps(xyz.data_ptr(), out.data_ptr(), batch, num_points,
                          n_samples, _block_threads(num_points), stream)
    _build.check_launch(rc, "fps")
    fps_indices.launches += 1
    return out


# launches of the CUDA kernel by this process (the plain version never counts)
fps_indices.launches = 0


def fps_gather(xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather points by index: (B, N, C), (B, G) -> (B, G, C)."""
    index = idx.to(torch.int64).unsqueeze(-1).expand(-1, -1, xyz.shape[-1])
    return torch.gather(xyz, 1, index)


def fps(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """FPS + gather: (B, N, 3) -> (B, n_samples, 3)."""
    return fps_gather(xyz, fps_indices(xyz, n_samples))
