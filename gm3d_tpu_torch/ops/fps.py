"""Furthest-point sampling (FPS).

Port of ``gm3d_tpu/ops/fps.py``. Semantics: the first selected point is
index 0; each later selection is the point with the maximum distance to the
already-selected set (squared Euclidean metric, ties broken by lowest index).

Three implementations of the same function:

  - ``fps_indices_torch``: the plain PyTorch version (a Python loop of
    tensor ops). The CPU tests use it and the kernel is held against it on
    the card.
  - ``fps_indices_emulated``: the kernel's round in plain PyTorch (threads
    owning points i = t (mod T), each thread's best, then the warps' and the
    cloud's two-step ``redux`` arg-max), which the CPU tests hold against the
    plain version and the JAX package on clouds full of ties.
  - the CUDA kernel ``csrc/fps.cu`` (a cloud's points in its threads'
    registers up to 8192 points and in shared memory above, the arg-max by
    ``redux.sync``), which ``fps_indices`` launches for every CUDA tensor.

``fps_indices`` calls the torch custom op ``gm3d::fps`` (``torch.ops.gm3d.fps``),
registered when this module is imported (no ``nvcc`` needed for that). Its CPU
implementation is the plain version; its CUDA implementation launches the
kernel or raises; its fake implementation gives the output's shape, so that
``torch.export`` records the op as one node of a program, which then runs the
kernel on the card and the plain version on the CPU. Its vmap rule folds the
mapped axis into the batch, (F, B, N, 3) -> (F·B, N, 3), and calls the op once:
the few-shot folds trained together (``train/finetune.py``) take one launch for
every fold, never vmap's loop over slices. The kernel library is built at the
first launch.
"""

from __future__ import annotations

import torch

from gm3d_tpu_torch.ops import _build

# A thread owns P <= 32 points; a block may have 1024 threads up to P 16 and
# 256 at P 32 (65,536 registers an SM). The points stay in registers up to 512
# threads at P 16, which holds 8192 points; above, x, y, z are read from the
# cloud's copy in shared memory (16 bytes a point, beside two 8-byte slots a
# warp) and only the running minima stay: at 1024 threads at most 14,496.
_SMEM_LIMIT = 232448
MAX_POINTS = (_SMEM_LIMIT - 2 * 32 * 8) // 16


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


def fps_indices_emulated(xyz: torch.Tensor, n_samples: int, threads: int) -> torch.Tensor:
    """The kernel's selection in plain PyTorch, ``threads`` (T) threads a
    cloud. Thread t owns points t, t+T, ...; its best is its largest running
    minimum at its lowest index (-1.0 where it owns no point); a warp keeps
    the largest value, compared as the float's bits, and the lowest index
    holding it; the cloud does the same over its warps. (B, N, 3) ->
    (B, n_samples) int32, equal to ``fps_indices_torch``."""
    batch, num_points, _ = xyz.shape
    per_thread = -(-num_points // threads)
    pad = per_thread * threads
    xyz = torch.nn.functional.pad(xyz.to(torch.float32), (0, 0, 0, pad - num_points))
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    real = torch.arange(pad, device=xyz.device) < num_points
    m = torch.where(real, float("inf"), float("-inf")).expand(batch, pad)
    p_ids = torch.arange(per_thread, device=xyz.device)[:, None]
    t_ids = torch.arange(threads, device=xyz.device)
    never = torch.iinfo(torch.int64).max
    idxs = torch.zeros((batch, n_samples), dtype=torch.int64, device=xyz.device)
    last = torch.zeros((batch, 1), dtype=torch.int64, device=xyz.device)
    for r in range(1, n_samples):
        cx, cy, cz = x.gather(1, last), y.gather(1, last), z.gather(1, last)
        m = torch.minimum(m, (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2)
        grid = m.view(batch, per_thread, threads)                # point t + T p
        best = grid.amax(dim=1).clamp_min(-1.0)                 # (B, T)
        # the lowest p holding it (0 for a thread that owns no point)
        first = torch.where(grid == best[:, None], p_ids, per_thread).amin(dim=1) % per_thread
        index = (t_ids + threads * first).view(batch, threads // 32, 32)
        bits = best.view(torch.int32).to(torch.int64).view(batch, threads // 32, 32)
        warp_max = bits.amax(dim=-1)
        warp_idx = torch.where(bits == warp_max[..., None], index, never).amin(dim=-1)
        last = torch.where(warp_max == warp_max.amax(dim=-1, keepdim=True), warp_idx,
                           never).amin(dim=-1, keepdim=True)
        idxs[:, r] = last[:, 0]
    return idxs.to(torch.int32)


def points_per_thread(num_points: int, threads: int) -> int:
    """P of the kernel: ceil(N / T) rounded up to 1, 2, 4, 8, 16 or 32 (0
    where that is over 32)."""
    need = -(-num_points // threads)
    return next((p for p in (1, 2, 4, 8, 16, 32) if p >= need), 0)


def in_registers(num_points: int, threads: int) -> bool:
    """Whether the kernel keeps a thread's points in registers (else their
    x, y, z in shared memory): 1024 threads a block up to P 8, 512 at P 16."""
    per_thread = points_per_thread(num_points, threads)
    return threads <= (512 if per_thread >= 16 else 1024)


def _geometry_fits(num_points: int, threads: int) -> bool:
    """Whether the C entry point takes this block size (the same tests)."""
    per_thread = points_per_thread(num_points, threads)
    smem = num_points * 16 + 2 * (threads // 32) * 8
    return (32 <= threads <= (256 if per_thread >= 32 else 1024) and threads % 32 == 0
            and per_thread > 0 and smem <= _SMEM_LIMIT)


def _block_threads(num_points: int) -> int:
    """Threads of a cloud's block, from ``scripts/tune_kernels.py`` (NVIDIA
    H100 80GB HBM3, 700.00 W): four points a thread up to 4096 points, where
    the round's chain decides (N 1024: 256 threads 0.0173 ms at B 128, one
    warp 0.0262; N 2048: 512 threads), 32 points a thread up to 8192, where
    the update's instructions decide and fewer warps wait at the barrier (N
    8192: 256 threads 0.708 ms, 1024 threads 0.832), and 1024 threads above,
    with the points in shared memory. Several clouds a block never won at
    B <= 256, so a block holds one."""
    if num_points > 8192:
        return 1024
    per_thread = 4 if num_points <= 4096 else 32
    threads = -(-num_points // per_thread)
    return min(1024, max(32, -(-threads // 32) * 32))


@torch.library.custom_op("gm3d::fps", mutates_args=(), device_types="cpu")
def _fps_op(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """``gm3d::fps`` on the CPU: the plain version."""
    return fps_indices_torch(xyz, n_samples)


@_fps_op.register_kernel("cuda")
def _fps_cuda(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """``gm3d::fps`` on the card: the kernel, or raise."""
    batch, num_points, _ = xyz.shape
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
    _build.count_launch(fps_indices)
    return out


@_fps_op.register_fake
def _fps_fake(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    return xyz.new_empty((xyz.shape[0], n_samples), dtype=torch.int32)


@_fps_op.register_vmap
def _fps_vmap(info, in_dims, xyz: torch.Tensor, n_samples: int):
    """``gm3d::fps`` under ``torch.func.vmap``: the mapped clouds are more
    clouds of one call (one launch on the card)."""
    xyz = xyz.movedim(in_dims[0], 0)
    out = torch.ops.gm3d.fps(xyz.flatten(0, 1), n_samples)
    return out.unflatten(0, xyz.shape[:2]), 0


def fps_indices(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Furthest-point-sample indices. xyz: (B, N, 3) -> (B, n_samples) int32,
    through ``torch.ops.gm3d.fps``."""
    if xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"expected (B, N, 3) points, got {tuple(xyz.shape)}")
    if n_samples < 1:
        raise ValueError(f"n_samples must be >= 1, got {n_samples}")
    return torch.ops.gm3d.fps(xyz, n_samples)


# launches of the CUDA kernel by this process (the plain version never counts)
fps_indices.launches = 0


def fps_gather(xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather points by index: (B, N, C), (B, G) -> (B, G, C)."""
    index = idx.to(torch.int64).unsqueeze(-1).expand(-1, -1, xyz.shape[-1])
    return torch.gather(xyz, 1, index)


def fps(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """FPS + gather: (B, N, 3) -> (B, n_samples, 3)."""
    return fps_gather(xyz, fps_indices(xyz, n_samples))
