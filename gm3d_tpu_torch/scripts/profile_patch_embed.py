"""Where the time of the fused patch-embed kernel goes on the GPU.

    python3 -m gm3d_tpu_torch.scripts.profile_patch_embed [--csrc DIR]

Measurements of ``csrc/patch_embed.cu`` through its C entry point (fp32,
groups of 32 points, 384 output channels, two groups a block; median ms by
CUDA events), one JSON line each:

  build       the source compiled on its own: what ``ptxas -v`` says of the
              kernel (registers, spills) and, by ``cuobjdump -sass``, its
              tensor-core instructions (``HMMA.1688.F32.TF32``)
  blocks      one launch of 132 blocks (every SM has one block: the time of a
              block alone), 264, 4096 (B 128, one served batch) and 8192 (B
              256, the train step's batch), with the rate at which the blocks
              pull the weights out of L2 (every block streams all of them)
  ablation    the same at 132 and 8192 blocks with one part of the kernel
              taken out at a time: copies of the sources are patched, built on
              their own and timed. The results of those runs are wrong by
              design; only their times mean something
  phases      the SM's clock read between the kernel's phases by block 0 of a
              launch of 132 (a patched copy again): cycles of conv1, conv2,
              the group maxima and the per-group term, conv3, conv4

``--csrc DIR`` profiles another copy of the sources (say the parent commit's,
unpacked with ``git archive``) in the same call, so that two versions meet on
one card. A copy whose ``patch_embed.cu`` still multiplies through
``tile_gemm`` (fp32 FFMA, before the tensor-core redesign) gets the ablations
of that product; the current one gets those of ``tile_mma.cuh``.

It needs a CUDA device and ``nvcc``; it measures, asserts nothing but that the
patches still find their places in the sources.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from gm3d_tpu_torch.models.blocks import PatchEncoder
from gm3d_tpu_torch.ops import _build
from gm3d_tpu_torch.ops import patch_embed as pe
from gm3d_tpu_torch.scripts.profile_attention import ABLATIONS as MMA_ABLATIONS
from gm3d_tpu_torch.scripts.profile_attention import _ms, count_mma
from gm3d_tpu_torch.scripts.profile_pretrain import gpu_name_and_limit

GROUP_SIZE, GROUPS_PER_BLOCK, OUT_DIM = 32, 2, 384
BLOCKS = (132, 264, 4096, 8192)

# name -> [(file, the line a patch goes in front of, what goes there), ...]
NO_CONV4 = [("patch_embed.cu", "    for (int c0 = 0; c0 < C; c0 += TILE) {", "    if (ng < 0)\n")]
# the source as it was before the redesign (tile_gemm.cuh, fp32 FFMA)
FFMA_SOURCE = {
    "no FFMA loop": [("tile_gemm.cuh", "            const float4 a4 =",
                      "            if (K > 0) continue;\n")],
    "no staging": [("tile_gemm.cuh", "        reg[r] = (t < T &&",
                    "        reg[r] = 0.0f;\n        continue;\n"),
                   ("tile_gemm.cuh", "        panel[kk * S_LD + t] = reg[r];",
                    "        if (reg[r] == 0.0f) continue;\n")],
    "no per-group term": [("patch_embed.cu", "    for (int c = tid; c < C3; c += THREADS) {",
                           "    if (ng < 0)\n")],
    "no conv4": NO_CONV4,
}
# the product on the tensor cores (profile_attention's patches of tile_mma.cuh)
MMA_SOURCE = {
    **{name: [patch] for name, patch in MMA_ABLATIONS.items() if patch[0] == "tile_mma.cuh"},
    "copies not waited for": [("tile_mma.cuh", "            cp_async_wait();\n",
                               "            if (K < 0)\n")],
    "no barrier in the k loop": [("tile_mma.cuh", "            __syncthreads();\n",
                                  "            if (K < 0)\n")],
    "no per-group term": [("patch_embed.cu", "        for (int k = k0; k < k0 + C2 / 2; ++k) {",
                           "        if (ng < 0)\n")],
    "no conv4": NO_CONV4,
}

# clock64() between the phases, written over block 0's own output (both sources)
PHASES = ("conv1", "conv2", "group max + per-group term", "conv3", "conv4")
CLOCKS = [
    ("patch_embed.cu", "    // conv1 + BN1 + ReLU\n", "    const long long t0 = clock64();\n"),
    ("patch_embed.cu", "    // conv2\n", "    __syncthreads();\n    const long long t1 = clock64();\n"),
    ("patch_embed.cu", "    // per-group max of h2\n", "    const long long t2 = clock64();\n"),
    ("patch_embed.cu", "    // conv3 (second half", "    const long long t3 = clock64();\n"),
    ("patch_embed.cu", "    // conv4 + per-group max", "    __syncthreads();\n    const long long t4 = clock64();\n"),
    ("patch_embed.cu", "}\n\n}  // namespace\n",
     "    __syncthreads();\n    if (tid == 0 && blockIdx.x == 0) {\n"
     "        const long long t[6] = {t0, t1, t2, t3, t4, clock64()};\n"
     "        for (int n = 0; n < 5; ++n) out[n] = (float)(t[n + 1] - t[n]);\n    }\n"),
]


def ablations(csrc: Path) -> dict:
    ffma = "tile_gemm(" in (csrc / "patch_embed.cu").read_text()
    return FFMA_SOURCE if ffma else MMA_SOURCE


def build(csrc: Path, out: Path, patches=()) -> tuple[ctypes.CDLL, str]:
    """``patch_embed.cu`` alone from a copy of ``csrc`` with ``patches``
    applied; returns the library and the compiler's output (``ptxas -v``)."""
    shutil.copytree(csrc, out)
    for file, before, insert in patches:
        text = (out / file).read_text()
        if text.count(before) != 1:
            raise RuntimeError(f"{before!r} is not in {csrc / file} exactly once")
        (out / file).write_text(text.replace(before, insert + before))
    so = out / "patch_embed.so"
    res = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                          "-o", str(so), str(out / "patch_embed.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out}:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gm3d_patch_embed.argtypes = [p] * 14 + [i, i, i, i, p]
    lib.gm3d_patch_embed.restype = i
    return lib, res.stdout + res.stderr


def ptxas_report(log: str) -> list[str]:
    """The lines ``ptxas -v`` prints for ``patch_embed_kernel``."""
    lines = log.splitlines()
    for n, line in enumerate(lines):
        if "Compiling entry function" in line and "patch_embed_kernel" in line:
            return [ln.replace("ptxas info    : ", "").strip() for ln in lines[n + 1:n + 4]
                    if "Compiling entry" not in ln]
    return []


def time_blocks(lib, blocks: int) -> tuple[dict, torch.Tensor]:
    """ms of one launch of ``blocks`` blocks, weights from a seed; and the
    output of the last launch."""
    gen = torch.Generator().manual_seed(0)
    enc = PatchEncoder(OUT_DIM)
    with torch.no_grad():
        for prm in enc.parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen) * 0.05)
    params = [t.cuda().contiguous() for t in pe.params_from_module(enc.eval())]
    groups = blocks * GROUPS_PER_BLOCK
    x = torch.randn((groups, GROUP_SIZE, 3), generator=gen).cuda() * 0.3
    out = torch.empty((groups, OUT_DIM), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        _build.check_launch(lib.gm3d_patch_embed(
            x.data_ptr(), *(t.data_ptr() for t in params), out.data_ptr(), groups, GROUP_SIZE,
            GROUPS_PER_BLOCK, OUT_DIM, stream), "patch_embed")

    ms = _ms(launch)
    weight_bytes = sum(t.numel() for t in params) * 4
    return {"ms": ms, "weights_from_l2_gb_per_s": blocks * weight_bytes / ms / 1e6}, out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC_DIR,
                    help="the directory of CUDA sources to profile (default: the package's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_patch_embed needs a CUDA device")
    gpu = gpu_name_and_limit()
    csrc = args.csrc.resolve()
    with tempfile.TemporaryDirectory() as tmp:
        lib, log = build(csrc, Path(tmp) / "whole")
        hmma = count_mma(Path(tmp) / "whole" / "patch_embed.so").get("patch_embed_kernel", 0)
        print(json.dumps({"build": str(args.csrc), "ptxas": ptxas_report(log),
                          "hmma_1688_f32_tf32": hmma, "gpu": gpu}), flush=True)
        print(json.dumps({"blocks": {b: time_blocks(lib, b)[0] for b in BLOCKS}, "gpu": gpu}),
              flush=True)
        for name, patches in ablations(csrc).items():
            patched, _ = build(csrc, Path(tmp) / re.sub(r"\W+", "_", name), patches)
            print(json.dumps({"ablation": name, "gpu": gpu,
                              "blocks": {b: time_blocks(patched, b)[0] for b in (132, 8192)}}),
                  flush=True)
        clocked, _ = build(csrc, Path(tmp) / "clocks", CLOCKS)
        run, out = time_blocks(clocked, 132)
        cycles = out.flatten()[:len(PHASES)].tolist()
        print(json.dumps({"phases": dict(zip(PHASES, cycles)), "unit": "cycles", "ms": run["ms"],
                          "gpu": gpu}), flush=True)


if __name__ == "__main__":
    main()
