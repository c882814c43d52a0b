"""Launch geometry of the FPS and KNN kernels: time against block size.

    python3 -m gm3d_tpu_torch.scripts.tune_kernels

Calls the C entry points of ``csrc/fps.cu`` and ``csrc/knn.cu`` directly with
every block size the kernels take, at the shapes the package meets, and
prints one JSON line per shape (median ms by CUDA events). The wrappers'
heuristics (``ops/fps.py::_block_threads``, ``ops/knn.py::_block_warps``) are
marked in the output. It needs a CUDA device; it measures, asserts nothing.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from gm3d_tpu_torch.ops import _build
from gm3d_tpu_torch.ops.fps import _block_threads
from gm3d_tpu_torch.ops.knn import _block_warps


def _ms(fn, runs=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tune_kernels needs a CUDA device")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)

    for b, n, g in ((128, 1024, 64), (256, 1024, 64), (32, 8192, 1024), (32, 2048, 512)):
        xyz = torch.randn(b, n, 3, device="cuda", generator=gen)
        out = torch.empty(b, g, dtype=torch.int32, device="cuda")
        row = {"kernel": "fps", "gpu": gpu, "shape": [b, n, g],
               "default_threads": _block_threads(n), "ms_by_threads": {}}
        for threads in (64, 128, 256, 512, 1024):
            def launch():
                rc = lib.gm3d_fps(xyz.data_ptr(), out.data_ptr(), b, n, g, threads, stream)
                _build.check_launch(rc, "fps")
            row["ms_by_threads"][threads] = _ms(launch)
        print(json.dumps(row), flush=True)

    for b, n, g, k in ((128, 1024, 64, 32), (256, 1024, 64, 32), (32, 2048, 512, 16),
                       (32, 8192, 64, 32)):
        ref = torch.randn(b, n, 3, device="cuda", generator=gen)
        query = ref[:, :g].contiguous()
        idx = torch.empty(b, g, k, dtype=torch.int32, device="cuda")
        dist = torch.empty(b, g, k, dtype=torch.float32, device="cuda")
        row = {"kernel": "knn", "gpu": gpu, "shape": [b, n, g, k],
               "default_warps": _block_warps(n, g), "ms_by_warps": {}}
        for warps in (1, 2, 4, 8, 16):
            if warps * n * 4 > 227 * 1024:
                continue
            def launch():
                rc = lib.gm3d_knn(ref.data_ptr(), query.data_ptr(), idx.data_ptr(),
                                  dist.data_ptr(), b, n, g, k, warps, stream)
                _build.check_launch(rc, "knn")
            row["ms_by_warps"][warps] = _ms(launch)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
