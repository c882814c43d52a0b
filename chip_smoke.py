#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py

needs one NVIDIA Hopper card, the CUDA toolkit (``nvcc``) and nothing else:
no arguments, no network, no dataset. It imports ``gm3d_tpu_torch`` only.
Phases, each printing one JSON line when it ends:

  env         card name and power limit, torch / CUDA / nvcc versions
  build       compiles ``gm3d_tpu_torch/csrc/*.cu`` and loads the library
  kernels     every kernel against its plain PyTorch version on the card
              (indices must be EQUAL), the tensor-core tile product of the
              attention and patch-embed kernels against float64, then times at
              the main paths' shapes
  serve       exports the full-width PointTransformer classifier (random
              weights from a seed) through the export CLI, serves it over
              HTTP with dynamic batching, checks the answers against the
              same artifact on the CPU, and counts kernel launches
  throughput  clouds per second of ``ServingModel.predict``, fp32 and bf16
  train       builds the GM3D student, its EMA copy and the frozen Point-MAE
              teacher at full width (random weights from a seed), takes six
              pretrain steps of 256 clouds, checks metrics, mask, launch
              counts, parameter / EMA movement and the frozen coordinate head,
              compares step 1 with the same step through the unfused modules,
              and prints clouds per second of the step

Any failure raises, so the exit code is non-zero and no result line is
printed. The last line is ``{"ok": true, "device": {...}}``.

``--phases env,build,train`` (development only) runs some of the list and
prints no result line.
"""

from __future__ import annotations

import argparse
import io
import itertools
import json
import os
import statistics
import subprocess
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device: "
                     "torch.cuda.is_available() is False")

from gm3d_tpu_torch.cli import export_model  # noqa: E402
from gm3d_tpu_torch.ops import _build  # noqa: E402
from gm3d_tpu_torch.models.blocks import PatchEncoder  # noqa: E402
from gm3d_tpu_torch.ops import fused_attention as fa  # noqa: E402
from gm3d_tpu_torch.ops import patch_embed as pe  # noqa: E402
from gm3d_tpu_torch.ops import tile_mma as tm  # noqa: E402
from gm3d_tpu_torch.ops.fps import fps_gather, fps_indices, fps_indices_torch  # noqa: E402
from gm3d_tpu_torch.ops.knn import knn_indices, knn_indices_torch  # noqa: E402
from gm3d_tpu_torch.scripts import profile_pretrain as pp  # noqa: E402
from gm3d_tpu_torch.serve.runner import ServingModel  # noqa: E402
from gm3d_tpu_torch.serve.server import make_server  # noqa: E402
from gm3d_tpu_torch.train.optim import GM3D_COORD_HEAD  # noqa: E402
from gm3d_tpu_torch.train.pretrain import METRIC_KEYS, make_gm3d_train_step  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "pointmae", "finetune_modelnet.yaml")
DEV = torch.device("cuda", 0)

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate, the
# fp32 rate outside the tensor cores (`bound_ms` of every kernel: FPS and KNN
# are fp32 vector code, and the patch-embed and attention kernels keep that
# yardstick) and the dense TF32 rate inside them (`tensor_bound_ms` of the
# patch-embed and attention kernels, whose products are three TF32 passes).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
TF32_PASSES = 3

# the serving shapes: one exported batch of the classifier
SERVE_BATCH, NPOINTS, NUM_GROUP, GROUP_SIZE = 128, 1024, 64, 32


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what) -> None:
    """Raise (also under ``python -O``) when a phase's condition fails."""
    if not ok:
        raise AssertionError(str(what))


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median time of ``fn()`` on the card in ms (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """Least time the card could take, in ms, and which limit sets it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensor_bound(bytes_moved: float, flops: float) -> float:
    """The same for products issued as three TF32 passes on the tensor cores."""
    return max(bytes_moved / HBM_BYTES_PER_S, TF32_PASSES * flops / TF32_FLOPS) * 1e3


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_env() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout
    release = next((ln.strip() for ln in nvcc.splitlines() if "release" in ln), "")
    env = {"phase": "env", "gpu": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "nvcc": release}
    emit(env)
    return env


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_library(verbose=True)
    emit({"phase": "build", "library": os.path.relpath(_build.library_path(), ROOT),
          "seconds": round(time.perf_counter() - t0, 2)})


def _grid_cloud(rng, batch, n, dup):
    """Coordinates on a coarse grid (multiples of 1/64: every product and sum
    is exact in fp32) with the first ``dup`` points repeated at the end, so
    that equal distances occur and the tie rules decide."""
    pts = rng.integers(-64, 65, size=(batch, n, 3)).astype(np.float32) / 64.0
    pts[:, n - dup:] = pts[:, :dup]
    return pts


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """Largest absolute difference, and the same over the largest |want|."""
    got, want = got.to(torch.float32), want.to(torch.float32)
    check(got.shape == want.shape, (got.shape, want.shape))
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    return err, err / max(float(want.abs().max()) if want.numel() else 0.0, 1e-30)


def _random_patch_encoder(seed: int, out_dim: int = 384) -> PatchEncoder:
    """A ``PatchEncoder`` on the card whose activations are of order one and
    whose BatchNorm statistics are not the initial (0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    enc = PatchEncoder(out_dim)
    with torch.no_grad():
        for m in enc.modules():
            if hasattr(m, "running_mean"):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.3)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.2)
            elif hasattr(m, "weight"):
                fan_in = m.weight.shape[1]
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) / fan_in ** 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.2)
    return enc.to(DEV).eval()


# Tolerances of the three matrix-product kernels, as the largest absolute
# difference over the largest |plain value|. fp32: both sides sum 64 to 512
# (weight gradients: B*L, up to 16384) fp32 products in different orders, the
# kernel with fused multiply-adds and, for weight gradients, atomics. bf16:
# both sides round an fp32 result to bf16 (8 bits of mantissa), so they may
# differ by one rounding step.
TOL_FP32, TOL_FP32_WGRAD, TOL_BF16 = 2e-5, 2e-4, 1.6e-2
# One tile product on the tensor cores against the float64 product of the same
# operands. As for the kernels, the largest absolute difference over the
# largest |float64 value|: the split drops terms of order 2^-22 and the sum is
# fp32 (the CPU emulation reads 4e-7 at K 384; one TF32 pass reads about 3e-4).
# A single output (M = N = 1) may be a sum that cancels, so every case is also
# held to a few fp32 roundoffs (2^-24 each) of its sum |a| |b|; one TF32 pass
# misses that by two orders too.
TOL_TILE_MMA = 2e-6
TOL_TILE_MMA_SUM = 2.0 ** -21


def _tile_mma_checks(rng) -> list[dict]:
    """The kernels' tile product, one block at a time, in every operand form
    they use. Attention: ragged M, N, K, each operand plain and transposed,
    fp32 and bf16, each from device memory (through a staged panel) and from
    a shared-memory buffer (read in place). Patch embed: A read in place from
    a shared-memory buffer of row stride 136, 264 or 520 (K 128, 256, 512),
    B columns of an (in, out) weight in device memory, alone in the stage."""
    def t(rows, cols, scale, dtype, transposed):
        shape = (cols, rows) if transposed else (rows, cols)
        v = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)
                             ).to(DEV).to(dtype)
        return v.t() if transposed else v

    checks = []
    before = tm.tile_product.launches
    either = (False, True)
    for dtype, shared_a, shared_b, a_t, b_t in itertools.product(
            (torch.float32, torch.bfloat16), either, either, either, either):
        worst, worst_of_sum, cases = 0.0, 0.0, 0
        for k, m, n in itertools.product((384, 64, 39, 25), (64, 39, 25, 1), (64, 39, 25, 1)):
            if (shared_a or shared_b) and k > tm.TILE:
                continue
            a, b = t(m, k, 1.0, dtype, a_t), t(k, n, 0.05, dtype, b_t)
            got = tm.tile_product(a, b, shared_a, shared_b)
            want = a.double() @ b.double()
            err, rel = _rel_err(got, want)
            size = float((a.double().abs() @ b.double().abs()).max())
            check(err <= TOL_TILE_MMA_SUM * size and (rel <= TOL_TILE_MMA or m * n == 1),
                  f"tile_mma off at M{m} N{n} K{k} {dtype} shared=({shared_a}, {shared_b}) "
                  f"A^T={a_t} B^T={b_t}: {rel} > {TOL_TILE_MMA} or "
                  f"{err / size} > {TOL_TILE_MMA_SUM}")
            worst = max(worst, rel if m * n > 1 else 0.0)
            worst_of_sum, cases = max(worst_of_sum, err / size), cases + 1
        checks.append({"kernel": "tile_mma", "dtype": str(dtype)[6:],
                       "a": ("shared" if shared_a else "device") + (", transposed" * a_t),
                       "b": ("shared" if shared_b else "device") + (", transposed" * b_t),
                       "cases": cases, "rel_err": worst, "tol": TOL_TILE_MMA,
                       "err_over_sum_abs": worst_of_sum, "tol_over_sum_abs": TOL_TILE_MMA_SUM,
                       "equal": True})
    # the patch embed's form; the weight's columns start at an offset, which with
    # its row length decides between the 16-byte copies and the element-wise ones
    for what, width, c0 in (("16-byte copies", 384, 64), ("row length 30", 30, 0),
                            ("offset 2", 384, 2)):
        worst, worst_of_sum, cases = 0.0, 0.0, 0
        for k, m, n in itertools.product((128, 256, 512), (64, 39, 32, 7), (64, 25)):
            n = min(n, width - c0)
            a, b = t(m, k, 1.0, torch.float32, False), t(k, width, 0.05, torch.float32, False)
            b = b[:, c0:c0 + n]
            got = tm.tile_product(a, b, wide_a=True)
            want = a.double() @ b.double()
            err, rel = _rel_err(got, want)
            size = float((a.double().abs() @ b.double().abs()).max())
            check(err <= TOL_TILE_MMA_SUM * size and rel <= TOL_TILE_MMA,
                  f"tile_mma off at M{m} N{n} K{k}, A wide in shared memory, B device "
                  f"({what}): {rel} > {TOL_TILE_MMA} or {err / size} > {TOL_TILE_MMA_SUM}")
            worst, worst_of_sum, cases = max(worst, rel), max(worst_of_sum, err / size), cases + 1
        checks.append({"kernel": "tile_mma", "dtype": "float32",
                       "a": "shared, row stride K + 8, K 128 / 256 / 512",
                       "b": f"device, columns {c0}.. of {width}, alone in the stage ({what})",
                       "cases": cases, "rel_err": worst, "tol": TOL_TILE_MMA,
                       "err_over_sum_abs": worst_of_sum, "tol_over_sum_abs": TOL_TILE_MMA_SUM,
                       "equal": True})
    torch.cuda.synchronize()
    check(tm.tile_product.launches - before == sum(c["cases"] for c in checks), "launch count")
    # not asserted, for the record: the same product summed through one chain of
    # mma accumulators (the kernels sum each 32-deep tile from zero), one TF32
    # pass, and PyTorch's fp32 product
    a, b = t(64, 384, 1.0, torch.float32, False), t(384, 64, 0.05, torch.float32, True)
    want = a.double() @ b.double()
    checks.append({"kernel": "tile_mma", "case": "K 384, other ways to sum (not asserted)",
                   "rel_err": _rel_err(tm.tile_product(a, b), want)[1],
                   "rel_err_one_chain": _rel_err(tm.tile_product(a, b, chain=True), want)[1],
                   "rel_err_one_tf32_pass": _rel_err(tm.matmul_tf32_plain(a, b), want)[1],
                   "rel_err_torch_fp32": _rel_err(a @ b, want)[1], "equal": True})
    return checks


def _patch_embed_checks(rng) -> tuple[list[dict], dict]:
    checks, worst = [], 0.0
    # S 7 and S 16: four groups a block; B3 G5 S32: the last block has one group
    for name, shape, seed, out_dim in (
            ("train step", (256, NUM_GROUP, GROUP_SIZE, 3), 0, 384),
            ("odd B3 G5 S7", (3, 5, 7, 3), 1, 384),
            ("ragged last block B3 G5 S32", (3, 5, GROUP_SIZE, 3), 2, 384),
            ("four groups a block B5 G6 S16", (5, 6, 16, 3), 3, 384),
            ("one group a block B2 G3 S64", (2, 3, 64, 3), 4, 384),
            ("C 30, not a multiple of 4", (2, 3, GROUP_SIZE, 3), 5, 30)):
        enc = _random_patch_encoder(seed, out_dim)
        params = pe.params_from_module(enc)
        x = torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(np.float32)).to(DEV)
        got = pe.fused_patch_embed(x, params)
        torch.cuda.synchronize()
        want = pe.fused_patch_embed_plain(x, params)
        with torch.no_grad():
            module = enc(x)
        err, rel = _rel_err(got, want)
        _, rel_module = _rel_err(got, module)
        check(rel <= TOL_FP32 and rel_module <= TOL_FP32,
              f"patch_embed kernel off at {name}: {rel} vs plain, {rel_module} vs PatchEncoder "
              f"(tolerance {TOL_FP32})")
        worst = max(worst, err)
        checks.append({"kernel": "patch_embed", "case": name, "shape": list(shape),
                       "rel_err": rel, "rel_err_vs_module": rel_module, "tol": TOL_FP32,
                       "equal": True})
    b, g, s, c = 256, NUM_GROUP, GROUP_SIZE, 384
    enc = _random_patch_encoder(0)
    params = pe.params_from_module(enc)
    x = torch.from_numpy((rng.standard_normal((b, g, s, 3)) * 0.3).astype(np.float32)).to(DEV)
    ms = cuda_ms(lambda: pe.fused_patch_embed(x, params), runs=20, warmup=2)
    plain = cuda_ms(lambda: pe.fused_patch_embed_plain(x, params), runs=20, warmup=2)
    weight_bytes = sum(t.numel() for t in params) * 4
    # per point: the four layers, the concat's first half once per group
    flops = b * g * (s * 2.0 * (3 * 128 + 128 * 256 + 256 * 512 + 512 * c) + 2.0 * 256 * 512)
    moved = b * g * s * 12 + weight_bytes + b * g * c * 4
    bound_ms, by = bound(moved, flops)
    # one served batch (B 128), for the record: serving does not enter this kernel
    half = x[:SERVE_BATCH]
    ms_128 = cuda_ms(lambda: pe.fused_patch_embed(half, params), runs=20, warmup=2)
    with torch.no_grad():
        module_128 = cuda_ms(lambda: enc(half), runs=20, warmup=2)
    timed = {"name": "patch_embed", "route": "cuda",
             "source": "gm3d_tpu_torch/csrc/patch_embed.cu",
             "replaces": "gm3d_tpu/ops/patch_embed.py:69", "shape": [b, g, s, 3],
             "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
             "bound_by": by, "tensor_bound_ms": tensor_bound(moved, flops), "library_ms": None,
             "ms_at_batch_128": ms_128, "patch_encoder_eval_ms_at_batch_128": module_128}
    return checks, timed


def _attention_operands(rng, batch, length, dtype, bias, dim=384):
    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)
                                ).to(DEV).to(dtype)

    # nn.Linear stores (out, in): the kernels get the transposed views
    wqkv = t(3 * dim, dim, scale=0.05).t()
    wproj = t(dim, dim, scale=0.05).t()
    return (t(batch, length, dim), wqkv, t(3 * dim, scale=0.1) if bias else None, wproj,
            t(dim, scale=0.1))


def _library_attention(x, wqkv, bqkv, wproj, bproj, heads=6):
    """The same function in PyTorch's library calls (a yardstick only)."""
    batch, length, dim = x.shape
    qkv = torch.nn.functional.linear(x, wqkv.t(), bqkv)
    q, k, v = qkv.reshape(batch, length, 3, heads, dim // heads).permute(2, 0, 3, 1, 4)
    o = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    return torch.nn.functional.linear(o.transpose(1, 2).reshape(batch, length, dim),
                                      wproj.t(), bproj)


def _attention_flops(batch, length, dim, backward):
    ld2, l2d = length * dim * dim, length * length * dim
    # forward: qkv 6 LD^2, scores and attend 2 L^2 D each, projection 2 LD^2;
    # backward from x: qkv, scores, attend again, then dWproj, do (2 LD^2
    # each), da, dq, dk, dv (2 L^2 D each), dWqkv and dx (6 LD^2 each)
    return batch * (22.0 * ld2 + 12.0 * l2d if backward else 8.0 * ld2 + 4.0 * l2d)


def _attention_checks(rng) -> tuple[list[dict], dict, dict, list[dict]]:
    checks, worst_f, worst_b = [], 0.0, 0.0
    dim, heads = 384, 6
    for length in (64, 39, 25, 1):
        for batch in (256, 3):
            for dtype in (torch.float32, torch.bfloat16):
                for bias in (False, True):
                    ops = _attention_operands(rng, batch, length, dtype, bias)
                    got = fa.fused_attention(*ops, heads)
                    torch.cuda.synchronize()
                    want = fa.reference_attention(*ops, heads)
                    tol = TOL_FP32 if dtype == torch.float32 else TOL_BF16
                    err, rel = _rel_err(got, want)
                    check(got.dtype == dtype and rel <= tol,
                          f"attention forward off at L{length} B{batch} {dtype} bias={bias}: "
                          f"{rel} > {tol}")
                    if dtype == torch.float32:
                        worst_f = max(worst_f, err)
                    checks.append({"kernel": "attention_fwd", "shape": [batch, length, dim],
                                   "dtype": str(dtype)[6:], "qkv_bias": bias, "rel_err": rel,
                                   "tol": tol, "equal": True})
    for length in (64, 25):
        for batch, dtype, bias in ((256, torch.float32, False), (256, torch.float32, True),
                                   (3, torch.float32, True), (256, torch.bfloat16, False)):
            x, wqkv, bqkv, wproj, _ = _attention_operands(rng, batch, length, dtype, bias)
            dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)
                                  ).to(DEV).to(dtype)
            got = fa.fused_attention_backward(x, dy, wqkv, bqkv, wproj, heads)
            torch.cuda.synchronize()
            want = fa.attention_backward_plain(x, dy, wqkv, bqkv, wproj, heads)
            rels = {}
            for name, g, w in zip(("dx", "dwqkv", "dbqkv", "dwproj", "dbproj"), got, want):
                check((g is None) == (w is None), f"{name}: one side is None")
                if g is None:
                    continue
                check(g.dtype == dtype, f"{name} is {g.dtype}")
                err, rels[name] = _rel_err(g, w)
                tol = (TOL_BF16 if dtype == torch.bfloat16
                       else TOL_FP32 if name == "dx" else TOL_FP32_WGRAD)
                check(rels[name] <= tol, f"attention backward {name} off at L{length} "
                      f"B{batch} {dtype} bias={bias}: {rels[name]} > {tol}")
                if dtype == torch.float32 and name == "dx":
                    worst_b = max(worst_b, err)
            checks.append({"kernel": "attention_bwd", "shape": [batch, length, dim],
                           "dtype": str(dtype)[6:], "qkv_bias": bias, "rel_err": rels,
                           "tol": {"dx": TOL_FP32, "weights": TOL_FP32_WGRAD,
                                   "bf16": TOL_BF16}, "equal": True})

    def times(length, dtype=torch.float32):
        batch = 256
        x, wqkv, bqkv, wproj, bproj = _attention_operands(rng, batch, length, dtype, False)
        dy = torch.randn_like(x)
        elt = x.element_size()
        wbytes = (wqkv.numel() + wproj.numel() + bproj.numel()) * elt
        fwd_work = (2 * x.numel() * elt + wbytes, _attention_flops(batch, length, dim, False))
        bwd_work = (3 * x.numel() * elt + 2 * wbytes,
                    _attention_flops(batch, length, dim, True))
        fwd_bound, fwd_by = bound(*fwd_work)
        bwd_bound, bwd_by = bound(*bwd_work)
        lib_in = [t.detach().clone().requires_grad_(True) for t in (x, wqkv, wproj, bproj)]
        lib_y = _library_attention(lib_in[0], lib_in[1], None, lib_in[2], lib_in[3], heads)
        with torch.no_grad():
            fwd = {"ms": cuda_ms(lambda: fa.fused_attention(x, wqkv, bqkv, wproj, bproj, heads)),
                   "plain_ms": cuda_ms(lambda: fa.reference_attention(
                       x, wqkv, bqkv, wproj, bproj, heads)),
                   "library_ms": cuda_ms(lambda: _library_attention(
                       x, wqkv, bqkv, wproj, bproj, heads)),
                   "bound_ms": fwd_bound, "bound_by": fwd_by,
                   "tensor_bound_ms": tensor_bound(*fwd_work)}
        bwd = {"ms": cuda_ms(lambda: fa.fused_attention_backward(
                   x, dy, wqkv, bqkv, wproj, heads)),
               "plain_ms": cuda_ms(lambda: fa.attention_backward_plain(
                   x, dy, wqkv, bqkv, wproj, heads)),
               "library_ms": cuda_ms(lambda: torch.autograd.grad(
                   lib_y, lib_in, dy, retain_graph=True)),
               "bound_ms": bwd_bound, "bound_by": bwd_by,
               "tensor_bound_ms": tensor_bound(*bwd_work)}
        return fwd, bwd

    fwd64, bwd64 = times(64)
    timed_f = {"name": "attention_fwd", "route": "cuda",
               "source": "gm3d_tpu_torch/csrc/fused_attention.cu",
               "replaces": "gm3d_tpu/ops/fused_attention.py:38", "shape": [256, 64, dim],
               "max_abs_err": worst_f, **fwd64}
    timed_b = {"name": "attention_bwd", "route": "cuda",
               "source": "gm3d_tpu_torch/csrc/fused_attention.cu",
               "replaces": "gm3d_tpu/ops/fused_attention.py:109", "shape": [256, 64, dim],
               "max_abs_err": worst_b, **bwd64}
    others = []
    for length, dtype in ((39, torch.float32), (25, torch.float32), (64, torch.bfloat16)):
        fwd, bwd = times(length, dtype)
        others.append({"name": "attention_fwd", "shape": [256, length, dim],
                       "dtype": str(dtype)[6:], **fwd})
        others.append({"name": "attention_bwd", "shape": [256, length, dim],
                       "dtype": str(dtype)[6:], **bwd})
    return checks, timed_f, timed_b, others


def phase_kernels() -> list[dict]:
    rng = np.random.default_rng(0)

    def cloud(b, n):
        return torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32)).to(DEV)

    checks = []
    # ---- FPS -------------------------------------------------------------
    fps_cases = [("serving", cloud(SERVE_BATCH, NPOINTS), NUM_GROUP),
                 ("serving x2", cloud(256, 1024), 64),
                 ("in-graph 8192->1024", cloud(32, 8192), 1024),
                 ("ragged N=200", cloud(3, 200), 24),
                 ("duplicated points", torch.from_numpy(_grid_cloud(rng, 4, 512, 128)).to(DEV), 96)]
    fps_err = 0
    for name, pts, n in fps_cases:
        got = fps_indices(pts, n)
        torch.cuda.synchronize()
        want = fps_indices_torch(pts, n)
        torch.cuda.synchronize()
        diff = int((got.long() - want.long()).abs().max())
        if diff != 0 or got.dtype != torch.int32:
            raise AssertionError(f"fps kernel disagrees with its plain version at {name}: "
                                 f"{int((got != want).sum())} of {got.numel()} indices")
        fps_err = max(fps_err, diff)
        checks.append({"kernel": "fps", "case": name, "shape": [*pts.shape[:2], n], "equal": True})
    # ---- KNN -------------------------------------------------------------
    def knn_case(ref, g):
        return ref, ref[:, :g].contiguous()

    tie = torch.from_numpy(_grid_cloud(rng, 4, 512, 128)).to(DEV)
    serve_ref = cloud(SERVE_BATCH, NPOINTS)
    serve_centers = fps_gather(serve_ref, fps_indices(serve_ref, NUM_GROUP))
    knn_cases = [("serving (queries = FPS centers)", serve_ref, serve_centers, GROUP_SIZE),
                 ("serving x2", *knn_case(cloud(256, 1024), 64), 32),
                 ("M2AE scale 0", *knn_case(cloud(8, 2048), 512), 16),
                 ("ragged N=300", cloud(2, 300), cloud(2, 100), 7),
                 ("N=8192", *knn_case(cloud(4, 8192), 64), 32),
                 ("ties", *knn_case(tie, 96), 24)]
    knn_err = 0.0
    for name, ref, query, k in knn_cases:
        gd, gi = knn_indices(ref, query, k, return_dist=True)
        torch.cuda.synchronize()
        wd, wi = knn_indices_torch(ref, query, k, return_dist=True)
        torch.cuda.synchronize()
        if not torch.equal(gi, wi):
            raise AssertionError(f"knn kernel disagrees with its plain version at {name}: "
                                 f"{int((gi != wi).sum())} of {gi.numel()} indices")
        torch.testing.assert_close(gd, wd, rtol=1e-6, atol=0.0)
        knn_err = max(knn_err, float((gd - wd).abs().max()))
        checks.append({"kernel": "knn", "case": name,
                       "shape": [ref.shape[0], ref.shape[1], query.shape[1], k], "equal": True})
    try:
        knn_indices(cloud(1, 8), cloud(1, 4), 9)
    except ValueError:
        pass
    else:
        raise AssertionError("knn_indices accepted k > N")

    # ---- times at the serving shapes ------------------------------------
    pts = cloud(SERVE_BATCH, NPOINTS)
    b, n, g, k = SERVE_BATCH, NPOINTS, NUM_GROUP, GROUP_SIZE
    fps_ms = cuda_ms(lambda: fps_indices(pts, g))
    fps_plain = cuda_ms(lambda: fps_indices_torch(pts, g), runs=20, warmup=1)
    # per round and point: 3 subtractions, 3 products, 2 sums, 1 min, 1 compare
    fps_bound, fps_by = bound(b * n * 12 + b * g * 4, 10.0 * b * (g - 1) * n)
    centers = pts[:, :g].contiguous()
    knn_ms = cuda_ms(lambda: knn_indices(pts, centers, k))
    knn_plain = cuda_ms(lambda: knn_indices_torch(pts, centers, k), runs=20, warmup=1)
    knn_lib = cuda_ms(lambda: torch.topk(torch.cdist(centers, pts), k, dim=-1,
                                         largest=False, sorted=True))
    # per (query, point) pair: 8 flops for q2 - 2*cross + r2 with r2 and q2
    # given, and at least one comparison to select; r2 once per point (5)
    knn_bound, knn_by = bound(b * n * 12 + b * g * 12 + b * g * k * 8,
                              9.0 * b * g * n + 5.0 * b * n)
    timed = [
        {"name": "fps", "route": "cuda", "source": "gm3d_tpu_torch/csrc/fps.cu",
         "replaces": "gm3d_tpu/ops/fps.py:170", "shape": [b, n, g],
         "max_abs_err": fps_err, "ms": fps_ms, "plain_ms": fps_plain,
         "bound_ms": fps_bound, "bound_by": fps_by, "library_ms": None},
        {"name": "knn", "route": "cuda", "source": "gm3d_tpu_torch/csrc/knn.cu",
         "replaces": "gm3d_tpu/ops/knn.py:76", "shape": [b, n, g, k],
         "max_abs_err": knn_err, "ms": knn_ms, "plain_ms": knn_plain,
         "bound_ms": knn_bound, "bound_by": knn_by, "library_ms": knn_lib},
    ]
    # other shapes the package meets (not on the main path; times only)
    big = cloud(32, 8192)
    m2ae, m2ae_q = cloud(32, 2048), cloud(32, 512)
    others = [
        {"name": "fps", "shape": [32, 8192, 1024],
         "ms": cuda_ms(lambda: fps_indices(big, 1024), runs=10, warmup=1),
         "bound_ms": bound(32 * 8192 * 12 + 32 * 1024 * 4, 10.0 * 32 * 1023 * 8192)[0]},
        {"name": "knn", "shape": [32, 2048, 512, 16],
         "ms": cuda_ms(lambda: knn_indices(m2ae, m2ae_q, 16), runs=10, warmup=1),
         "bound_ms": bound(32 * 2048 * 12 + 32 * 512 * 12 + 32 * 512 * 16 * 8,
                           9.0 * 32 * 512 * 2048 + 5.0 * 32 * 2048)[0]},
    ]
    mma_checks = _tile_mma_checks(np.random.default_rng(3))
    pe_checks, pe_timed = _patch_embed_checks(rng)
    at_checks, at_fwd, at_bwd, at_others = _attention_checks(rng)
    checks += mma_checks + pe_checks + at_checks
    timed += [pe_timed, at_fwd, at_bwd]
    others += at_others
    emit({"phase": "kernels", "checks": checks, "kernels": timed, "other_shapes": others,
          "tolerances": {"fp32": TOL_FP32, "fp32_weight_grads": TOL_FP32_WGRAD,
                         "bf16": TOL_BF16, "tile_mma_vs_float64": TOL_TILE_MMA,
                         "fps_knn": "indices equal"}})
    return timed


def _http(url: str, data: bytes | None = None, ctype: str = "application/json"):
    req = urllib.request.Request(url, data=data)
    if data is not None:
        req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def _export(out: str, *extra: str) -> str:
    return export_model.main(["--config", CONFIG, "--out", out, "--seed", "0",
                              "--device", "cuda", *extra])


def _agree(got: np.ndarray, want: np.ndarray, atol: float) -> float:
    """Logits within ``atol``; argmax equal wherever the reference's top-two
    margin exceeds ``atol``. Returns the largest absolute difference."""
    err = float(np.abs(got - want).max())
    if not (np.isfinite(got).all() and err <= atol):
        raise AssertionError(f"served logits differ from the CPU artifact by {err} > {atol}")
    top2 = np.sort(want, axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > atol
    if not np.array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure]):
        raise AssertionError("served argmax differs from the CPU artifact")
    return err


def phase_serve(tmp: str) -> dict:
    rng = np.random.default_rng(1)
    clouds = rng.standard_normal((300, NPOINTS, 3)).astype(np.float32)
    singles = rng.standard_normal((64, NPOINTS, 3)).astype(np.float32)
    art = _export(os.path.join(tmp, "cls_fp32.gm3dx"),
                  "--export_batch", str(SERVE_BATCH), "--input_points", str(NPOINTS))

    server = make_server(art, port=0, batch_wait_ms=5.0, dynamic_batching=True,
                         device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        # the main path: every launch count starts from 0 here
        fps_indices.launches = 0
        knn_indices.launches = 0
        status, health = _http(base + "/health")
        check(status == 200 and health == {"status": "ok"}, health)
        status, info = _http(base + "/info")
        check(status == 200 and info["input_shape"] == [SERVE_BATCH, NPOINTS, 3], info)
        check(info["model"] == "PointTransformer" and info["platforms"] == ["cuda"], info)
        status, one = _http(base + "/predict",
                            json.dumps({"points": clouds[0].tolist()}).encode())
        check(status == 200 and np.asarray(one["outputs"]).shape == (40,), status)
        buf = io.BytesIO()
        np.save(buf, clouds)
        status, many = _http(base + "/predict", buf.getvalue(), "application/octet-stream")
        check(status == 200, status)
        calls_before = server.batcher.device_calls
        answers: list = [None] * len(singles)

        def worker(w):
            for i in range(w, len(singles), 16):
                st, res = _http(base + "/predict",
                                json.dumps({"points": singles[i].tolist()}).encode())
                check(st == 200, st)
                answers[i] = res["outputs"]

        threads = [threading.Thread(target=worker, args=(w,)) for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        coalesced_calls = server.batcher.device_calls - calls_before
        try:
            _http(base + "/predict", b'{"points": [[1, 2]]}')
        except urllib.error.HTTPError as e:
            check(e.code == 400, e.code)
        else:
            raise AssertionError("a malformed cloud was not refused with 400")
        launches = {"fps": fps_indices.launches, "knn": knn_indices.launches}
    finally:
        server.shutdown()
        server.server_close()
        thread.join()

    if any(a is None for a in answers):
        raise AssertionError("a concurrent request got no answer")
    if not (launches["fps"] > 0 and launches["knn"] > 0):
        raise AssertionError(f"the serving path did not launch the kernels: {launches}")
    if not coalesced_calls < len(singles):
        raise AssertionError(f"{coalesced_calls} device calls for {len(singles)} requests")

    cpu = ServingModel(art, device="cpu")
    want = cpu.predict(np.concatenate([clouds, singles]))
    got = np.concatenate([np.asarray(many["outputs"], np.float32),
                          np.asarray(answers, np.float32)])
    check(got.shape == (364, 40), got.shape)
    err = _agree(got, want, atol=2e-3)
    _agree(np.asarray(one["outputs"], np.float32)[None], want[:1], atol=2e-3)

    # second, shorter pass: bf16 with the 8192 -> 1024 FPS inside the forward
    big = rng.standard_normal((40, 8192, 3)).astype(np.float32)
    art16 = _export(os.path.join(tmp, "cls_bf16.gm3dx"), "--bf16",
                    "--export_batch", "32", "--input_points", "8192")
    art32 = _export(os.path.join(tmp, "cls_fp32_8192.gm3dx"),
                    "--export_batch", "32", "--input_points", "8192")
    out16 = ServingModel(art16, device="cuda").predict(big)
    out32 = ServingModel(art32, device="cuda").predict(big)
    check(out16.shape == out32.shape == (40, 40), (out16.shape, out32.shape))
    check(np.isfinite(out16).all() and np.isfinite(out32).all(), "non-finite logits")
    same = float((out16.argmax(-1) == out32.argmax(-1)).mean())
    if same < 0.9:
        raise AssertionError(f"bf16 and fp32 artifacts agree on only {same:.0%} of clouds")

    res = {"phase": "serve", "requests": 2 + 1 + 1 + len(singles) + 1,
           "clouds": 1 + 300 + len(singles), "launches": launches,
           "device_calls_for_64_concurrent": coalesced_calls,
           "max_abs_err_vs_cpu": err, "bf16_argmax_agreement": same}
    emit(res)
    return {"launches": launches, "artifact": art}


def phase_throughput(tmp: str, art32: str) -> None:
    rng = np.random.default_rng(2)
    batch = rng.standard_normal((SERVE_BATCH, NPOINTS, 3)).astype(np.float32)
    art16 = _export(os.path.join(tmp, "cls_bf16_1024.gm3dx"), "--bf16",
                    "--export_batch", str(SERVE_BATCH), "--input_points", str(NPOINTS))
    out = {"phase": "throughput", "batch": SERVE_BATCH}
    for name, art in (("fp32", art32), ("bf16", art16)):
        model = ServingModel(art, device="cuda")
        x = torch.from_numpy(batch).to(DEV)
        for _ in range(3):
            model.predict(batch)
        windows = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(4):
                model.predict(batch)
            windows.append(4 * SERVE_BATCH / (time.perf_counter() - t0))
        with torch.inference_mode():
            dev_ms = cuda_ms(lambda: model.device_call(x), runs=10, warmup=2)
        out[name] = {"clouds_per_s_end_to_end": statistics.median(windows),
                     "clouds_per_s_device": SERVE_BATCH / dev_ms * 1e3,
                     "device_ms_per_batch": dev_ms}
    emit(out)


# the train step's shapes: the JAX CLI's default batch at full width, fp32
TRAIN_BATCH, TRAIN_STEPS, NUM_MASK = 256, 6, 39
# launches of each kernel in ONE step: one grouping; two grad-free patch
# embeds; attention forward 24 (EMA) + 28 (student) + 20 (teacher); attention
# backward 28 (student)
LAUNCHES_PER_STEP = {"fps": 1, "knn": 1, "patch_embed": 2, "attention_fwd": 72,
                     "attention_bwd": 28}
# step-1 metrics, kernels against the unfused modules on the card: fp32 sums in
# other orders through 28 blocks, and a mask that may differ in a group or two
# where two predicted losses tie to the last bits
TOL_STEP = 2e-3


def _train_clouds(gen: torch.Generator) -> torch.Tensor:
    return torch.randn((TRAIN_BATCH, NPOINTS, 3), generator=gen, device=DEV) * 0.5


def phase_train(env: dict) -> dict:
    """A trainer that takes a few full-width steps through the kernels."""
    state, teacher = pp.build_pretrain_setup(seed=0, device="cuda")
    step = make_gm3d_train_step(state.student, teacher, state.optimizer)
    check(step.num_mask == NUM_MASK, step.num_mask)
    start = {k: v.detach().clone() for k, v in state.student.state_dict().items()}
    gen = torch.Generator(device=DEV).manual_seed(1)
    history, masks, event_ms, wall_ms = [], [], [], []
    pp.reset_launches()  # the main path: every launch count starts from 0 here
    for _ in range(TRAIN_STEPS):
        pts = _train_clouds(gen)
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        begin.record()
        state, metrics = step(state, pts, gen, pp.SCALARS)
        end.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(begin.elapsed_time(end))
        history.append({k: float(metrics[k]) for k in METRIC_KEYS})
        masks.append(step.last_mask.clone())
    launches = pp.read_launches()

    check(state.step == TRAIN_STEPS, state.step)
    for i, metrics in enumerate(history):
        check(sorted(metrics) == sorted(METRIC_KEYS) and all(np.isfinite(v) for v in
                                                              metrics.values()), (i, metrics))
    for mask in masks:
        check(mask.shape == (TRAIN_BATCH, NUM_GROUP) and mask.dtype == torch.bool, mask.shape)
        check(bool((mask.sum(dim=1) == NUM_MASK).all()), "a row is not masked in 39 groups")
    want_launches = {k: v * TRAIN_STEPS for k, v in LAUNCHES_PER_STEP.items()}
    check(launches == want_launches, f"launches {launches}, expected {want_launches}")

    now = state.student.state_dict()
    ema = state.ema.state_dict()
    moved = {k: float((now[k] - start[k]).abs().max()) for k in start
             if start[k].dtype.is_floating_point}
    ema_moved = {k: float((ema[k] - start[k]).abs().max()) for k in moved}
    head = [k for k in moved if k.startswith(GM3D_COORD_HEAD)]
    check(len(head) == 2 and all(moved[k] == 0.0 and ema_moved[k] == 0.0 for k in head),
          "the coordinate head moved")
    rest = [k for k in moved if k not in head]
    check(all(moved[k] > 0.0 for k in rest), [k for k in rest if moved[k] == 0.0])
    check(all(ema_moved[k] > 0.0 for k in rest), [k for k in rest if ema_moved[k] == 0.0])
    check(all(bool(torch.isfinite(v).all()) for v in now.values()), "non-finite parameter")

    # the same first step through the unfused modules (PatchEncoder.eval(),
    # plain Attention), same weights, same clouds, same draws
    plain_state, plain_teacher = pp.build_pretrain_setup(seed=0, device="cuda")
    plain_step = make_gm3d_train_step(plain_state.student, plain_teacher,
                                      plain_state.optimizer, use_fused_embed=False,
                                      use_fused_attention=False)
    gen = torch.Generator(device=DEV).manual_seed(1)
    plain_state, plain_metrics = plain_step(plain_state, _train_clouds(gen), gen, pp.SCALARS)
    plain_metrics = {k: float(plain_metrics[k]) for k in METRIC_KEYS}
    rel = {k: abs(history[0][k] - plain_metrics[k]) / max(abs(plain_metrics[k]), 1e-12)
           for k in METRIC_KEYS}
    check(all(v <= TOL_STEP for v in rel.values()),
          f"step 1 through the kernels {history[0]} differs from the unfused modules "
          f"{plain_metrics} by more than {TOL_STEP}: {rel}")
    mask_agreement = float((masks[0] == plain_step.last_mask).float().mean())
    check(mask_agreement >= 0.995, f"masks agree on {mask_agreement}")

    # steady state: the first step also builds nothing new, but warms caches
    step_ms = statistics.median(event_ms[1:])
    step_wall = statistics.median(wall_ms[1:])
    res = {"phase": "train", "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "npoints": NPOINTS,
           "launches": launches, "launches_per_step": LAUNCHES_PER_STEP,
           "masked_groups_per_row": NUM_MASK, "metrics_step_1": history[0],
           "metrics_step_1_unfused": plain_metrics, "rel_diff_step_1": rel, "tol": TOL_STEP,
           "mask_agreement_step_1": mask_agreement, "metrics_last_step": history[-1],
           "largest_parameter_move": max(moved.values()),
           "largest_ema_move": max(ema_moved.values())}
    emit(res)
    emit({"train_step": {"clouds_per_s": TRAIN_BATCH / step_wall * 1e3,
                         "ms_per_step_cuda_events": step_ms, "ms_per_step_wall": step_wall,
                         "batch": TRAIN_BATCH, "dtype": "float32", "gpu": env["gpu"]}})
    return {"launches": launches}


PHASES = ("env", "build", "kernels", "serve", "throughput", "train")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list out of: " + ",".join(PHASES))
    phases = ap.parse_args().phases.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    env = phase_env()
    timed, served = [], None
    with tempfile.TemporaryDirectory() as tmp:
        if "build" in phases:
            phase_build()
        if "kernels" in phases:
            timed = phase_kernels()
        if "serve" in phases:
            served = phase_serve(tmp)
        if "throughput" in phases:
            phase_throughput(tmp, served["artifact"])
    trained = phase_train(env) if "train" in phases else None
    if tuple(phases) != PHASES:
        raise SystemExit(f"partial run ({phases}): no result line")
    for kern in timed:
        # FPS and KNN are on both paths: `launches` is the serving run's count
        if kern["name"] in served["launches"]:
            kern["launches"] = served["launches"][kern["name"]]
            kern["launches_train"] = trained["launches"][kern["name"]]
        else:
            kern["launches"] = trained["launches"][kern["name"]]
        check(kern["launches"] > 0, f"{kern['name']} was never launched on its path")
    emit({"kernels": timed})
    print(env["gpu"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
