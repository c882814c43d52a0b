"""Exact k-nearest-neighbour search.

Port of ``gm3d_tpu/ops/knn.py``. For every query point the ``k`` reference
points with the smallest squared distance ``q2 - 2 q.r + r2``, in ascending
order, the first index among equal distances.

Three implementations of the same function:

  - ``knn_indices_torch``: the plain PyTorch version (the full distance
    matrix, then a stable sort). The CPU tests use it and the kernel is held
    against it on the card.
  - ``knn_select_emulated``: the kernel's way to the answer, step by step in
    plain PyTorch (lane ownership, R runs a lane, the threshold tau, the
    candidates at or below it, the 128-entry buffer, and the k-round
    selection where that overflows), as ``ops/tile_mma.py`` mirrors the tile product.
    The CPU tests hold it against the plain version and the JAX package, so
    the kernel's algorithm is tested where no card is; on the card it gives
    the candidate counts the profile reports.
  - the CUDA kernel ``csrc/knn.cu`` (a block per cloud and tile of queries,
    a warp per query: a threshold and a candidate sort), which
    ``knn_indices`` launches for every CUDA tensor, whatever its shape.

``knn_indices`` calls the torch custom op ``gm3d::knn``
(``torch.ops.gm3d.knn``, always ``(dist, idx)``; the wrapper picks), registered
when this module is imported. Its CPU implementation is the plain version, its
CUDA implementation launches the kernel or raises, and its fake implementation
gives the outputs' shapes for ``torch.export``. Its vmap rule folds the mapped
axis into the batch and calls the op once (one launch for every few-shot fold
trained together), as ``gm3d::fps``'s does. The outputs carry no gradient on
either device. ``k > N`` raises ``ValueError`` on both routes.
"""

from __future__ import annotations

import torch

from gm3d_tpu_torch.ops import _build

# Each of a block's warps keeps a row of N keys (4 bytes a point) and a buffer
# of CAP (key, index) candidates in shared memory; a staged block keeps its
# cloud there too (16 bytes a point), where that leaves room for
# STAGE_MIN_WARPS warps.
_SMEM_LIMIT = 232448  # a block's shared memory
_SM_SMEM = 233472     # an SM's, 1 KB of it held for each block
CAP = 128
MAX_WARPS = 16
STAGE_MIN_WARPS = 4
MAX_REF = (_SMEM_LIMIT - CAP * 8) // 4
NONE = 0xFFFFFFFF  # the key above every distance


def _smem_bytes(num_ref: int, warps: int, staged: bool) -> int:
    return (num_ref * 16 if staged else 0) + warps * CAP * 8 + warps * num_ref * 4


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


def ordered_key(d: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving 32-bit key of fp32 values, as int64:
    ``bits ^ ((int)bits >> 31 | 0x80000000)`` after ``d + 0.0`` maps -0.0 to
    +0.0. Equal values get equal keys and smaller values smaller ones."""
    bits = (d.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, (bits & 0xFFFFFFFF) ^ 0xFFFFFFFF, bits ^ 0x80000000)


def key_value(key: torch.Tensor) -> torch.Tensor:
    """The fp32 value of a key (the inverse of ``ordered_key``)."""
    bits = torch.where(key >= 0x80000000, key ^ 0x80000000, key ^ 0xFFFFFFFF)
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(torch.float32)


def runs_for(k: int) -> int:
    """R, the runs a lane: the fewest of 1, 2, 4, 8 with 32 R >= 4 k up to k
    8, then 32 R >= 2 k. At k 32, R 2 leaves 43 candidates on average and at
    most 66 on standard-normal clouds (R 4: 36 and 48) and sorts 64 keys for
    tau instead of 128: 7% faster in all at B 128 (``scripts/tune_kernels.py``).
    The buffer's 128 entries hold them; k above 128 never fits the buffer."""
    return 1 if k <= 8 else next((r for r in (2, 4) if 16 * r >= k), 8)


def knn_select_emulated(ref: torch.Tensor, query: torch.Tensor, k: int,
                        runs: int | None = None):
    """The kernel's selection in plain PyTorch. Returns ``(dist, idx,
    stats)`` as ``knn_indices_torch(..., return_dist=True)`` would, with
    ``stats = {"candidates": C (B, G) or None where k > 128, "overflow":
    queries that took the k-round selection}``."""
    _check(ref, query, k)
    runs = runs or runs_for(k)
    key = ordered_key(_sq_distances(ref.to(torch.float32), query.to(torch.float32)))
    batch, num_query, num_ref = key.shape
    dev = key.device
    # lane l owns points l, l+32, ...: point i sits in slot i // 32 of lane
    # i % 32, and slot j belongs to the lane's run j % R
    slots = -(-(-(-num_ref // 32)) // runs) * runs
    row = torch.full((batch, num_query, slots * 32), NONE, dtype=torch.int64, device=dev)
    row[..., :num_ref] = key
    index = torch.arange(slots * 32, device=dev)
    if k <= CAP:
        run_min = row.view(batch, num_query, slots // runs, runs, 32).amin(dim=2)
        tau = run_min.reshape(batch, num_query, runs * 32).sort(dim=-1).values[..., k - 1:k]
        take = row <= tau
        count = take.sum(dim=-1)
        fast = count <= CAP
        # the buffer's (key, index) pairs in one integer, sorted; the first k
        pairs = torch.where(take, row * 2 ** 31 + index, torch.iinfo(torch.int64).max)
        first = pairs.sort(dim=-1).values[..., :k]
        out_key, out_idx = first // 2 ** 31, first % 2 ** 31
    else:
        count = None
        fast = torch.zeros((batch, num_query), dtype=torch.bool, device=dev)
        out_key = torch.zeros((batch, num_query, k), dtype=torch.int64, device=dev)
        out_idx = torch.zeros_like(out_key)
    if not bool(fast.all()):
        # k rounds: each lane's best (key, first index), the warp's least key,
        # the least index holding it; the winner is masked in the row
        lanes = torch.arange(32, device=dev)
        slot = torch.arange(slots, device=dev)[:, None]
        grid = row.clone().view(batch, num_query, slots, 32)
        slow_key, slow_idx = [], []
        for _ in range(k):
            best = grid.amin(dim=2)
            first_slot = torch.where(grid == best[:, :, None, :], slot, slots).amin(dim=2)
            m = best.amin(dim=-1, keepdim=True)
            w = torch.where(best == m, lanes + 32 * first_slot, slots * 32).amin(dim=-1,
                                                                                keepdim=True)
            slow_key.append(m)
            slow_idx.append(w)
            grid.view(batch, num_query, slots * 32).scatter_(-1, w, NONE)
        out_key = torch.where(fast[..., None], out_key, torch.cat(slow_key, dim=-1))
        out_idx = torch.where(fast[..., None], out_idx, torch.cat(slow_idx, dim=-1))
    stats = {"candidates": count, "overflow": int((~fast).sum())}
    return key_value(out_key), out_idx.to(torch.int32), stats


def _geometry_fits(num_ref: int, warps: int, staged: bool) -> bool:
    return 1 <= warps <= MAX_WARPS and _smem_bytes(num_ref, warps, staged) <= _SMEM_LIMIT


def _max_warps(num_ref: int, staged: bool) -> int:
    """The most warps (at most 16) whose rows fit beside the staged cloud or
    without it; 0 where not one does."""
    room = _SMEM_LIMIT - (num_ref * 16 if staged else 0)
    return max(0, min(MAX_WARPS, room // (CAP * 8 + num_ref * 4)))


def _queries_per_block(batch: int, num_query: int, warps: int, smem: int, sms: int) -> int:
    """Queries a block: four, two or one a warp, whichever leaves the least
    work to the slowest SM (the waves of blocks times a warp's queries; a tie
    to more queries a warp, which stages the cloud fewer times).
    ``scripts/tune_kernels.py`` (NVIDIA H100 80GB HBM3, 700.00 W): at B 32 x
    4096 x 64 four, two, one a warp take 0.0877, 0.0466, 0.0503 ms (64, 128,
    256 blocks of one an SM); at B 32 x 8192 0.329, 0.320, 0.242 (96, 192,
    352 blocks); at B 128 x 1024 0.0305, 0.0239, 0.0248."""
    per_sm = max(1, min(_SM_SMEM // (smem + 1024), 64 // warps))
    best = None
    for per_warp in (4, 2, 1):
        per_block = min(per_warp * warps, num_query)
        blocks = batch * -(-num_query // per_block)
        cost = -(-blocks // (sms * per_sm)) * -(-per_block // warps)
        if best is None or cost < best[0]:
            best = (cost, per_block)
    return best[1]


def _launch_geometry(batch: int, num_ref: int, num_query: int, k: int,
                     sms: int = 132) -> tuple[int, int, int, int]:
    """(warps a block, queries a block, runs a lane, staged) of a launch on a
    card of ``sms`` SMs (the H100's 132 by default): the cloud staged where
    four warps' rows fit beside it (N up to 7,136), as many warps as fit, up
    to sixteen, and the queries a block of ``_queries_per_block``."""
    staged = _max_warps(num_ref, True) >= STAGE_MIN_WARPS
    warps = _max_warps(num_ref, staged)
    smem = _smem_bytes(num_ref, warps, staged)
    return (warps, _queries_per_block(batch, max(num_query, 1), warps, smem, sms),
            runs_for(k), int(staged))


_sms: dict = {}


def _sm_count(device: torch.device) -> int:
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[device]


_overflow: dict = {}


def _overflow_counter(device: torch.device) -> torch.Tensor:
    if device not in _overflow:
        _overflow[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return _overflow[device]


def knn_overflow_count(device="cuda") -> int:
    """Queries that took the kernel's k-round selection on ``device`` in this
    process so far (more than 128 candidates at or below tau, or k > 128).
    Reading it waits for the device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return int(_overflow_counter(device).item())


@torch.library.custom_op("gm3d::knn", mutates_args=(), device_types="cpu")
def _knn_op(ref: torch.Tensor, query: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``gm3d::knn`` on the CPU: the plain version, ``(dist, idx)``."""
    return knn_indices_torch(ref, query, k, return_dist=True)


@_knn_op.register_kernel("cuda")
def _knn_cuda(ref: torch.Tensor, query: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``gm3d::knn`` on the card: the kernel, or raise. The count of queries
    that overflowed the candidate buffer goes to the device's counter
    (``knn_overflow_count``), outside the op's arguments."""
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
                              dist.data_ptr(), _overflow_counter(ref.device).data_ptr(),
                              batch, num_ref, num_query, k,
                              *_launch_geometry(batch, num_ref, num_query, k,
                                                _sm_count(ref.device)), stream)
        _build.check_launch(rc, "knn")
        _build.count_launch(knn_indices)
    return dist, idx


@_knn_op.register_fake
def _knn_fake(ref: torch.Tensor, query: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    shape = (query.shape[0], query.shape[1], k)
    return (query.new_empty(shape, dtype=torch.float32),
            query.new_empty(shape, dtype=torch.int32))


@_knn_op.register_vmap
def _knn_vmap(info, in_dims, ref: torch.Tensor, query: torch.Tensor, k: int):
    """``gm3d::knn`` under ``torch.func.vmap``: the mapped clouds are more
    clouds of one call (one launch on the card); an unmapped cloud is shared
    by every slice."""
    ref, query = (t.movedim(d, 0) if d is not None else t.expand(info.batch_size, *t.shape)
                  for t, d in zip((ref, query), in_dims[:2]))
    lead = query.shape[:2]
    dist, idx = torch.ops.gm3d.knn(ref.flatten(0, 1), query.flatten(0, 1), k)
    return (dist.unflatten(0, lead), idx.unflatten(0, lead)), (0, 0)


def _no_gradient(ctx, inputs, output) -> None:
    ctx.mark_non_differentiable(*output)


_knn_op.register_autograd(lambda ctx, grad_dist, grad_idx: (None, None, None),
                          setup_context=_no_gradient)


def knn_indices(ref: torch.Tensor, query: torch.Tensor, k: int,
                return_dist: bool = False):
    """k nearest neighbours of each query point among the reference points,
    through ``torch.ops.gm3d.knn``.

    ref:   (B, N, 3) reference cloud
    query: (B, G, 3) query points
    Returns idx (B, G, k) int32, and squared distances (B, G, k) fp32 first,
    as ``(dist, idx)``, if ``return_dist``; ascending distance.
    """
    _check(ref, query, k)
    dist, idx = torch.ops.gm3d.knn(ref, query, k)
    if return_dist:
        return dist, idx
    return idx


# launches of the CUDA kernel by this process (the plain version never counts)
knn_indices.launches = 0
