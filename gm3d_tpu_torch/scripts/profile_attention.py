"""Where the time of the two attention kernels goes on the GPU.

    python3 -m gm3d_tpu_torch.scripts.profile_attention

Three measurements of ``csrc/fused_attention.cu`` through its C entry points
(fp32, D 384, 6 heads; median ms by CUDA events), one JSON line each:

  mma         ``cuobjdump -sass`` of the built library: tensor-core (HMMA)
              instructions in each kernel (the attention and patch-embed
              kernels and the tile product's unit test have them, FPS and KNN
              none)
  batch       forward and backward at L 64, 39, 25 and B 16, 132, 256. One
              block works on one cloud, so B 16 is the time of a block that
              has its SM to itself, B 132 of one block on every SM, and B 256
              (the train step's batch) of two blocks an SM side by side in the
              forward and one after the other in the backward
  ablation    the same at L 64, B 16 and 256, with one part of the kernels
              taken out at a time: copies of the sources are patched, built on
              their own and timed. The results of those runs are wrong by
              design; only their times mean something

It needs a CUDA device and ``nvcc``; it measures, asserts nothing but that the
patches still find their places in the sources.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from gm3d_tpu_torch.ops import _build
from gm3d_tpu_torch.scripts.profile_pretrain import gpu_name_and_limit

DIM, HEADS = 384, 6

# name -> (file, the line a patch goes in front of, what goes there)
ABLATIONS = {
    "no staged copies": ("tile_mma.cuh",
                         "    const long s_unit = LAY == TK ? s_k : s_t,", "    return;\n"),
    "no mma loop": ("tile_mma.cuh", "        if (!live) continue;\n",
                    "        if (K > 0) continue;\n"),
    "no split (hi = lo = v)": ("tile_mma.cuh", "    const float p = __fmul_rn(v, 8193.0f);",
                               "    hi = lo = __float_as_uint(v);\n    return;\n"),
    "no weight-gradient atomics": ("fused_attention.cu", "    if (s_j == 1 && s_i % 2 == 0 &&",
                                   "    if (acc[0][0] == 123.456f) dst[0] = 1.0f;\n    return;\n"),
}


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


def _bind(lib):
    p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.gm3d_attn_fwd.argtypes = [p, p, l, l, p, p, l, l, p, p, p, i, i, i, i, i, p]
    lib.gm3d_attn_bwd.argtypes = [p, p, p, l, l, p, p, l, l, p, p, p, l, l, p, p, l, l, p,
                                  i, i, i, i, i, p]
    lib.gm3d_attn_fwd.restype = lib.gm3d_attn_bwd.restype = i
    return lib


def time_kernels(lib, batch: int, length: int) -> dict:
    """ms of one forward and one backward launch (nn.Linear weight views, no
    qkv bias, as the train step calls them)."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def t(*shape, scale=1.0):
        return torch.randn(shape, device="cuda", generator=gen) * scale

    x, dy = t(batch, length, DIM), t(batch, length, DIM)
    wqkv, wproj = t(3 * DIM, DIM, scale=0.05).t(), t(DIM, DIM, scale=0.05).t()
    bproj, y, dx = t(DIM), torch.empty_like(x), torch.empty_like(x)
    dwqkv, dwproj = torch.zeros_like(wqkv), torch.zeros_like(wproj)
    dbproj = torch.zeros(DIM, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def fwd():
        _build.check_launch(lib.gm3d_attn_fwd(
            x.data_ptr(), wqkv.data_ptr(), *wqkv.stride(), None, wproj.data_ptr(),
            *wproj.stride(), bproj.data_ptr(), y.data_ptr(), y.data_ptr(), batch, length, DIM,
            HEADS, 0, stream), "attention forward")

    def bwd():
        _build.check_launch(lib.gm3d_attn_bwd(
            x.data_ptr(), dy.data_ptr(), wqkv.data_ptr(), *wqkv.stride(), None,
            wproj.data_ptr(), *wproj.stride(), dx.data_ptr(), dx.data_ptr(), dwqkv.data_ptr(),
            *dwqkv.stride(), None, dwproj.data_ptr(), *dwproj.stride(), dbproj.data_ptr(),
            batch, length, DIM, HEADS, 0, stream), "attention backward")

    return {"fwd_ms": _ms(fwd), "bwd_ms": _ms(bwd)}


def count_mma(library: Path) -> dict:
    """HMMA instructions per kernel of the library (``cuobjdump -sass``)."""
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    counts = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0]
        kernel = next((k for k in ("attn_fwd_kernel", "attn_bwd_kernel", "tile_mma_test_kernel",
                                   "patch_embed_kernel", "fps_kernel", "knn_kernel")
                       if k in name), name)
        kernel += "<bf16>" if "bfloat16" in name and kernel.startswith("attn") else ""
        counts[kernel] = counts.get(kernel, 0) + len(re.findall(r"\bHMMA\.\d+\.F32\.TF32\b", part))
    return counts


def build_patched(name: str, tmp: Path) -> ctypes.CDLL:
    """``fused_attention.cu`` alone, from a copy of the sources with one patch."""
    file, before, insert = ABLATIONS[name]
    src = tmp / re.sub(r"\W+", "_", name)
    shutil.copytree(_build.CSRC_DIR, src)
    text = (src / file).read_text()
    if text.count(before) != 1:
        raise RuntimeError(f"ablation {name!r}: {before!r} is not in {file} exactly once")
    (src / file).write_text(text.replace(before, insert + before))
    so = src / "attention.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
                    str(src / "fused_attention.cu")], check=True, capture_output=True)
    return _bind(ctypes.CDLL(str(so)))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_attention needs a CUDA device")
    gpu = gpu_name_and_limit()
    lib = _build.load_library()
    print(json.dumps({"mma": count_mma(_build.library_path()), "gpu": gpu}), flush=True)
    for length in (64, 39, 25):
        row = {"batch": {b: time_kernels(lib, b, length) for b in (16, 132, 256)},
               "length": length, "gpu": gpu}
        print(json.dumps(row), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name in ABLATIONS:
            patched = build_patched(name, Path(tmp))
            row = {"ablation": name, "length": 64, "gpu": gpu,
                   "batch": {b: time_kernels(patched, b, 64) for b in (16, 256)}}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
