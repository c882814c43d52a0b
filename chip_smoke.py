#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py

needs one NVIDIA Hopper card, the CUDA toolkit (``nvcc``) and nothing else:
no arguments, no network, no dataset. It imports ``gm3d_tpu_torch`` only.
Phases, each printing one JSON line when it ends:

  env         card name and power limit, torch / CUDA / nvcc versions
  build       compiles ``gm3d_tpu_torch/csrc/*.cu`` and loads the library
  kernels     every kernel against its plain PyTorch version on the card
              (indices must be EQUAL; KNN with the count of queries that
              overflowed its candidate buffer, 0 wherever the data are
              standard-normal and k <= 32), the tensor-core tile product of
              the attention and patch-embed kernels against float64, then
              times at the main paths' shapes (FPS and KNN: ``ms`` one call
              through the wrapper, as for every kernel, and ``graph_ms`` from
              CUDA graphs, since their launches are shorter than the
              wrapper's host time)
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
  pretrain_cli  runs the pretrain CLI (``gm3d_tpu_torch.cli.pretrain.main``,
              in this process) for two epochs of four full-width steps on
              synthetic clouds with a random teacher, checks its ``log.txt``
              (keys, finite values, the schedule's learning rate) and the
              kernel launches of its eight steps, and prints its clouds per
              second beside the bare step's
  teacher     the CLI's ``--model_family pointmae`` (``config_m.yaml``, full
              width) for two epochs of four steps: ``log.txt``, the legacy
              schedule, launches (FPS and KNN only), its checkpoint; then the
              GM3D CLI for one epoch with ``--teacher_ckpt`` on it, traced by
              ``--profile_dir``: the teacher inside the run equals the saved
              tensors bit for bit, the launches are the step's, and the trace
              gives the device's busy share
  resume      the GM3D CLI in a process of its own with ``--save_steps 1``
              gets a real SIGTERM after its first save, exits 0, and
              ``--resume`` trains the rest; a full-width state saved by the
              asynchronous writer while the live tensors move on restores bit
              for bit; the state's size, the snapshot's device time and
              memory, a synchronous save's wall time, and the CLI's clouds per
              second with saves every two steps, inline and in the background
  probe       the CLI's SVM probe at full width: two epochs with the probe in
              the background (the default), with ``--sync_probe``, and with
              ``--sync_probe --classification``; each epoch's ``val_svm_acc``,
              ``ckpt/best`` and ``best_metrics.json``, ``loss_cls`` and
              ``acc_cls``, the probe's FPS and KNN launches, its extraction and
              fit times and solver iterations, clouds per second and wall time
              of each run; then the linear SVC alone at ModelNet40's size
              (9,843 x 384 training features, 2,468 test ones, 40 classes, from
              ``--seed``) on the card and on the CPU: equal predictions,
              decision values within ``SVC_DEC_TOL``, wall time, peak memory
  step_options  the GM3D step's options at full width: four micro-steps of
              ``accum_steps=2`` (parameters and EMA bit-equal after the first
              micro-step of a window, moved after the second; launches
              1/1/2/72/28 a micro-step; the fold of one micro-step's
              gradients into the running mean timed alone beside its HBM
              bound), two steps of the separated optimizers (the frozen
              parameters never move, both halves do; launches 1/1/2/64/28),
              two remat steps against two plain ones from one state and one
              generator (metrics within ``TOL_REMAT``; ms and peak memory of
              each), six bf16 steps through the kernels (finite, launches
              1/1/2/72/28) and six through the unfused attention from the same
              state and generator (the first step's metrics within
              ``TOL_BF16``; clouds per second, peak memory; the attention
              kernels' time inside a traced bf16 step), and the CLI with ``--accum_iter 2 --no-shared_opt
              --bf16`` for one epoch (its record, launches, checkpoint)
  finetune    pretrain -> finetune -> export -> serve inside the port: a
              ModelNet-layout directory of synthetic 8,192-point clouds in 40
              classes (from ``--seed``) read by the ModelNet reader; one epoch
              of the GM3D pretrain CLI; the finetune CLI
              (``configs/pointmae/finetune_modelnet.yaml``, full width, B 32)
              from that checkpoint for two epochs with ``--vote``, once a
              recipe (``legacy``, ``hpm``): its records, more than 100 keys
              transferred, ``ckpt/best``, clouds per second of each epoch,
              launches (FPS 2 and KNN 1 a train step, an eval batch and a vote
              batch, no patch-embed or attention kernel, as the JAX steps
              route it); FPS 8192 -> 1200 index-equal to its plain version and
              its CUDA-graph time; the bare step's ms and clouds per second,
              fp32 and bf16, the eval and vote ms a batch; ``ckpt/best``
              exported with 8,192-point inputs, served by
              ``gm3d_tpu_torch.cli.serve`` in a process of its own, its logits
              within ``TOL_SERVE`` of the eval step's

The pretrain CLI probes after each epoch (``--val_freq`` 1) in the phases
``pretrain_cli``, ``teacher`` and ``resume`` too; their launch counts include
the probe's.

Any failure raises, so the exit code is non-zero and no result line is
printed. The last line is ``{"ok": true, "device": {...}}``.

``--phases env,build,train`` (development only) runs some of the list and
prints no result line. ``--seed`` (default 0) draws the phase ``probe``'s
features and the phase ``finetune``'s clouds.
"""

from __future__ import annotations

import argparse
import copy
import io
import itertools
import json
import logging
import os
import pickle
import re
import shutil
import signal
import statistics
import subprocess
import sys
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

from gm3d_tpu_torch.ckpt.async_writer import (AsyncCheckpointWriter, device_snapshot,  # noqa: E402
                                              tensors_of)
from gm3d_tpu_torch.ckpt.checkpoint import (all_steps, capture, latest_step,  # noqa: E402
                                            load_best_metrics, load_loader_state,
                                            restore_checkpoint, restore_raw, save_checkpoint)
from gm3d_tpu_torch.cli import export_model  # noqa: E402
from gm3d_tpu_torch.cli import pretrain as pretrain_cli  # noqa: E402
from gm3d_tpu_torch.eval import linear_svc  # noqa: E402
from gm3d_tpu_torch.ops import _build  # noqa: E402
from gm3d_tpu_torch.models.blocks import PatchEncoder  # noqa: E402
from gm3d_tpu_torch.ops import fused_attention as fa  # noqa: E402
from gm3d_tpu_torch.ops import patch_embed as pe  # noqa: E402
from gm3d_tpu_torch.ops import tile_mma as tm  # noqa: E402
from gm3d_tpu_torch.ops.fps import MAX_POINTS as FPS_MAX_POINTS  # noqa: E402
from gm3d_tpu_torch.ops.fps import fps_gather, fps_indices, fps_indices_torch  # noqa: E402
from gm3d_tpu_torch.ops.knn import (knn_indices, knn_indices_torch, knn_overflow_count,  # noqa: E402
                                    knn_select_emulated)
from gm3d_tpu_torch.scripts import profile_pretrain as pp  # noqa: E402
from gm3d_tpu_torch.serve.runner import ServingModel  # noqa: E402
from gm3d_tpu_torch.serve.server import make_server  # noqa: E402
from gm3d_tpu_torch.train.optim import (GM3D_COORD_HEAD, MultiSteps,  # noqa: E402
                                         build_gm3d_separated_optimizer,
                                         build_gm3d_shared_optimizer, gm3d_separated_labels)
from gm3d_tpu_torch.train.pretrain import (METRIC_KEYS, POINTMAE_METRIC_KEYS,  # noqa: E402
                                           make_gm3d_train_step)
from gm3d_tpu_torch.train.schedules import (cosine_warmup_schedule, effective_lr,  # noqa: E402
                                            legacy_cosine_epoch_schedule)
from gm3d_tpu_torch.utils.profiling import (device_busy_share, device_idle_gaps,  # noqa: E402
                                            start_trace, stop_trace)

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


def graph_ms(fn, launches: int = 10) -> float:
    """Device time of one ``fn()`` in ms: ``launches`` calls captured in a CUDA
    graph and replayed, so that the host's own time for each call (the
    wrapper's checks, allocations and the launch through ``ctypes``, tens of
    microseconds) does not leave the card idle between them."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay) / launches


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
                 ("duplicated points", torch.from_numpy(_grid_cloud(rng, 4, 512, 128)).to(DEV), 96),
                 ("M2AE 2048->512", cloud(32, 2048), 512),
                 ("finetune 8192->1200", cloud(32, 8192), 1200),
                 ("N=20 < 32, n=30 > N", cloud(3, 20), 30),
                 ("all-identical points", torch.full((2, 100, 3), 0.5, device=DEV), 16),
                 ("ModelNet40 raw 10000->1024 (points in shared memory)", cloud(8, 10000), 1024),
                 (f"largest cloud {FPS_MAX_POINTS}->64", cloud(2, FPS_MAX_POINTS), 64)]
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
    same = torch.full((2, 256, 3), -0.25, device=DEV)
    # the same kind of cloud in the orders real inputs can come in: FPS order
    # (as FPS-cached datasets store them) and a scan order (z, then y in
    # slabs of a quarter, then x); the candidate counts depend on the order
    base = cloud(8, NPOINTS)
    fps_ordered = fps_gather(base, fps_indices(base, NPOINTS))
    scan = base.double()
    scan = (scan[..., 2] * 4).floor() * 1e4 + (scan[..., 1] * 4).floor() * 1e2 + scan[..., 0]
    scan_ordered = fps_gather(base, scan.argsort(dim=1))
    ordered = {}
    for name, ref in (("FPS-ordered cloud", fps_ordered), ("scan-ordered cloud", scan_ordered)):
        ordered[name] = (ref, fps_gather(ref, fps_indices(ref, NUM_GROUP)))
    # (name, ref, query, k, standard-normal): on standard-normal clouds in
    # random order with k <= 32 the kernel's threshold leaves fewer candidates
    # than its 128-entry buffer holds, so none of those may take the k-round
    # selection; identical points always do
    knn_cases = [("serving (queries = FPS centers)", serve_ref, serve_centers, GROUP_SIZE, True),
                 ("serving x2", *knn_case(cloud(256, 1024), 64), 32, True),
                 ("M2AE scale 0", *knn_case(cloud(8, 2048), 512), 16, True),
                 ("ragged N=300", cloud(2, 300), cloud(2, 100), 7, True),
                 ("N=4096 (cloud staged, 9 warps)", *knn_case(cloud(4, 4096), 64), 32, True),
                 ("N=8192 (cloud read from L2)", *knn_case(cloud(4, 8192), 64), 32, True),
                 ("N=16384 (cloud read from L2)", *knn_case(cloud(2, 16384), 64), 32, True),
                 ("ties", *knn_case(tie, 96), 24, False),
                 ("all-identical points", same, same[:, :16].contiguous(), 32, False),
                 ("N=20 < 32", cloud(3, 20), cloud(3, 8), 5, True),
                 ("k=1", *knn_case(cloud(SERVE_BATCH, NPOINTS), 64), 1, True),
                 ("k=N=40", *knn_case(cloud(2, 40), 16), 40, True),
                 ("k=N=100", *knn_case(cloud(2, 100), 16), 100, True),
                 ("k=N=200 > 128, the buffer", *knn_case(cloud(2, 200), 16), 200, True),
                 ("k=48", *knn_case(cloud(8, 1024), 64), 48, True),
                 ("segmentation: k 3, 2048 queries, 128 references", cloud(4, 128),
                  cloud(4, 2048), 3, True),
                 *((name, ref, query, GROUP_SIZE, False) for name, (ref, query) in ordered.items())]
    knn_err = 0.0
    for name, ref, query, k, normal in knn_cases:
        before = knn_overflow_count(DEV)
        gd, gi = knn_indices(ref, query, k, return_dist=True)
        overflow = knn_overflow_count(DEV) - before
        wd, wi = knn_indices_torch(ref, query, k, return_dist=True)
        torch.cuda.synchronize()
        if not torch.equal(gi, wi):
            raise AssertionError(f"knn kernel disagrees with its plain version at {name}: "
                                 f"{int((gi != wi).sum())} of {gi.numel()} indices")
        torch.testing.assert_close(gd, wd, rtol=1e-6, atol=0.0)
        if normal and k <= 32:
            check(overflow == 0, f"knn at {name}: {overflow} queries overflowed the candidates")
        if ref is same:
            check(overflow == query.shape[0] * query.shape[1],
                  f"knn at {name}: {overflow} overflowing queries, expected all")
        knn_err = max(knn_err, float((gd - wd).abs().max()))
        checks.append({"kernel": "knn", "case": name,
                       "shape": [ref.shape[0], ref.shape[1], query.shape[1], k],
                       "overflow": overflow, "equal": True})
        if name in ordered:
            c = knn_select_emulated(ref, query, k)[2]["candidates"].double()
            checks[-1]["candidates_mean_max"] = [float(c.mean()), int(c.max())]
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
    fps_graph_ms = graph_ms(lambda: fps_indices(pts, g))
    fps_plain = cuda_ms(lambda: fps_indices_torch(pts, g), runs=20, warmup=1)
    # per round and point: 3 subtractions, 3 products, 2 sums, 1 min, 1 compare
    fps_bound, fps_by = bound(b * n * 12 + b * g * 4, 10.0 * b * (g - 1) * n)
    centers = pts[:, :g].contiguous()
    knn_ms = cuda_ms(lambda: knn_indices(pts, centers, k))
    knn_graph_ms = graph_ms(lambda: knn_indices(pts, centers, k))
    knn_plain = cuda_ms(lambda: knn_indices_torch(pts, centers, k), runs=20, warmup=1)

    def knn_library():
        return torch.topk(torch.cdist(centers, pts), k, dim=-1, largest=False, sorted=True)
    knn_lib, knn_lib_graph = cuda_ms(knn_library), graph_ms(knn_library)
    # per (query, point) pair: 8 flops for q2 - 2*cross + r2 with r2 and q2
    # given, and at least one comparison to select; r2 once per point (5)
    knn_bound, knn_by = bound(b * n * 12 + b * g * 12 + b * g * k * 8,
                              9.0 * b * g * n + 5.0 * b * n)
    timed = [
        {"name": "fps", "route": "cuda", "source": "gm3d_tpu_torch/csrc/fps.cu",
         "replaces": "gm3d_tpu/ops/fps.py:170", "shape": [b, n, g],
         "max_abs_err": fps_err, "ms": fps_ms, "plain_ms": fps_plain,
         "bound_ms": fps_bound, "bound_by": fps_by, "library_ms": None,
         "graph_ms": fps_graph_ms},
        {"name": "knn", "route": "cuda", "source": "gm3d_tpu_torch/csrc/knn.cu",
         "replaces": "gm3d_tpu/ops/knn.py:76", "shape": [b, n, g, k],
         "max_abs_err": knn_err, "ms": knn_ms, "plain_ms": knn_plain,
         "bound_ms": knn_bound, "bound_by": knn_by, "library_ms": knn_lib,
         "graph_ms": knn_graph_ms, "library_graph_ms": knn_lib_graph},
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
    clouds_per_s = TRAIN_BATCH / step_wall * 1e3
    emit({"train_step": {"clouds_per_s": clouds_per_s,
                         "ms_per_step_cuda_events": step_ms, "ms_per_step_wall": step_wall,
                         "batch": TRAIN_BATCH, "dtype": "float32", "gpu": env["gpu"]}})
    return {"launches": launches, "clouds_per_s": clouds_per_s}


# the CLI's run: 1024 synthetic clouds in batches of 256, two epochs of 4 steps
CLI_SAMPLES, CLI_EPOCHS = 1024, 2
CLI_STEPS_PER_EPOCH = CLI_SAMPLES // TRAIN_BATCH
CLI_RECORD_KEYS = set(METRIC_KEYS) | {"epoch", "time", "lr", "steps", "clouds_per_sec",
                                      "val_svm_acc"}
# the SVM probe after each epoch (--val_freq 1, the default): the student's encoder
# over the synthetic SVM sets (512 and 256 labelled clouds, make_loaders) in
# batches of twice the train batch, one FPS and one KNN launch a batch
PROBE_BATCHES = -(-(CLI_SAMPLES // 2) // (2 * TRAIN_BATCH)) + -(-(CLI_SAMPLES // 4)
                                                                // (2 * TRAIN_BATCH))
PROBE_LAUNCHES = {"fps": PROBE_BATCHES, "knn": PROBE_BATCHES, "patch_embed": 0,
                  "attention_fwd": 0, "attention_bwd": 0}


def with_probes(per_step: dict, steps: int, probes: int) -> dict:
    """A CLI run's launch counts: its train steps' and its SVM probes'."""
    return {k: v * steps + PROBE_LAUNCHES[k] * probes for k, v in per_step.items()}


def phase_pretrain_cli(env: dict, trained: dict | None) -> dict:
    """The pretrain CLI, as a user runs it, for a few full-width steps."""
    with tempfile.TemporaryDirectory() as out:
        pp.reset_launches()  # the CLI's path: every launch count starts from 0 here
        records = pretrain_cli.main([
            "--config", os.path.join(ROOT, "configs", "pointmae", "config.yaml"),
            "--synthetic", "--synthetic_samples", str(CLI_SAMPLES),
            "--batch_size", str(TRAIN_BATCH), "--epochs", str(CLI_EPOCHS),
            "--learn_feature_loss", "dino", "--output_dir", out])
        launches = pp.read_launches()
        with open(os.path.join(out, "log.txt")) as f:
            log = [json.loads(line) for line in f]
        with open(os.path.join(out, "pretrain.log")) as f:
            text_log = f.read()
    check(log == records, "log.txt differs from the records main() returned")
    check([r["epoch"] for r in log] == list(range(CLI_EPOCHS)), log)
    # the JAX CLI's schedule at its defaults: blr 1e-3, 40 warm-up epochs
    sched = cosine_warmup_schedule(effective_lr(1e-3, TRAIN_BATCH), 0.0, 40, CLI_EPOCHS,
                                   CLI_STEPS_PER_EPOCH)
    for r in log:
        check(set(r) == CLI_RECORD_KEYS, f"log.txt keys {sorted(r)}")
        check(r["steps"] == CLI_STEPS_PER_EPOCH, r)
        check(all(np.isfinite(r[k]) for k in CLI_RECORD_KEYS), r)
        want_lr = sched(CLI_STEPS_PER_EPOCH * (r["epoch"] + 1))
        check(abs(r["lr"] - want_lr) <= 1e-12 * want_lr, (r["lr"], want_lr))
        check(f"epoch {r['epoch']}: loss=" in text_log, "pretrain.log lacks an epoch line")
    steps = CLI_EPOCHS * CLI_STEPS_PER_EPOCH
    want_launches = with_probes(LAUNCHES_PER_STEP, steps, CLI_EPOCHS)
    check(launches == want_launches, f"launches {launches}, expected {want_launches}")
    cli_rate = log[-1]["clouds_per_sec"]
    res = {"phase": "pretrain_cli", "epochs": CLI_EPOCHS, "steps": steps,
           "batch": TRAIN_BATCH, "launches": launches, "records": log,
           "cli_clouds_per_sec_last_epoch": cli_rate}
    if trained is not None:
        res["train_step_clouds_per_s"] = trained["clouds_per_s"]
        res["cli_over_step"] = cli_rate / trained["clouds_per_s"]
    res["gpu"] = env["gpu"]
    emit(res)
    return {"launches": launches}


# the teacher's pretrain (config_m.yaml at full width): the JAX step enters no
# fused attention and runs its patch embed in train mode, so one grouping a step
TEACHER_CONFIG = os.path.join(ROOT, "configs", "pointmae", "config_m.yaml")
GM3D_CONFIG = os.path.join(ROOT, "configs", "pointmae", "config.yaml")
TEACHER_LAUNCHES_PER_STEP = {"fps": 1, "knn": 1, "patch_embed": 0, "attention_fwd": 0,
                             "attention_bwd": 0}
TEACHER_RECORD_KEYS = set(POINTMAE_METRIC_KEYS) | {"epoch", "time", "lr", "steps",
                                                   "clouds_per_sec", "val_svm_acc"}


def _cli_flags(out: str, epochs: int = CLI_EPOCHS) -> list:
    return ["--synthetic", "--synthetic_samples", str(CLI_SAMPLES), "--batch_size",
            str(TRAIN_BATCH), "--epochs", str(epochs), "--output_dir", out]


def _read_log(out: str) -> list:
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def phase_teacher(env: dict, tmp: str) -> dict:
    """The teacher's pretrain through the CLI (``--model_family pointmae``),
    then the GM3D CLI reading its checkpoint with ``--teacher_ckpt``."""
    teacher_out = os.path.join(tmp, "teacher")
    pp.reset_launches()  # the teacher's path: every launch count starts from 0 here
    records = pretrain_cli.main(["--config", TEACHER_CONFIG, "--model_family", "pointmae",
                                 *_cli_flags(teacher_out)])
    launches = pp.read_launches()
    log = _read_log(teacher_out)
    check(log == records, "log.txt differs from the records main() returned")
    check([r["epoch"] for r in log] == list(range(CLI_EPOCHS)), log)
    # the legacy schedule of config_m.yaml (lr 1e-3, 10 warm-up epochs of 300)
    # trails the epoch by one: both epochs train at the warm-up's start, 1e-6
    sched = legacy_cosine_epoch_schedule(1e-3, 300, 10, CLI_STEPS_PER_EPOCH)
    ckpt = os.path.join(teacher_out, "ckpt")
    for r in log:
        check(set(r) == TEACHER_RECORD_KEYS, f"log.txt keys {sorted(r)}")
        check(r["steps"] == CLI_STEPS_PER_EPOCH and all(np.isfinite(r[k]) for k in r), r)
        end = CLI_STEPS_PER_EPOCH * (r["epoch"] + 1)
        check(r["lr"] == sched(end), (r["lr"], sched(end)))
        # the rate the epoch's last step trained at, as its checkpoint holds it
        trained = restore_raw(ckpt, end)["optimizer"]["param_groups"][0]["lr"]
        check(trained == sched(end - 1) == 1e-6, (r["epoch"], trained))
    steps = CLI_EPOCHS * CLI_STEPS_PER_EPOCH
    want = with_probes(TEACHER_LAUNCHES_PER_STEP, steps, CLI_EPOCHS)
    check(launches == want, f"teacher launches {launches}, expected {want}")
    check(latest_step(ckpt) == steps, f"latest teacher step {latest_step(ckpt)}")

    # the GM3D CLI with that teacher: one epoch, traced by --profile_dir
    seen = {}
    load = pretrain_cli.load_teacher_checkpoint

    def load_and_keep(teacher, ckpt_dir, logger):
        load(teacher, ckpt_dir, logger)
        seen["teacher"] = teacher

    gm3d_out = os.path.join(tmp, "gm3d_with_teacher")
    prof_dir = os.path.join(tmp, "profile")
    pretrain_cli.load_teacher_checkpoint = load_and_keep
    try:
        pp.reset_launches()  # the GM3D path: every launch count starts from 0 here
        gm3d = pretrain_cli.main(["--config", GM3D_CONFIG, "--teacher_ckpt", ckpt,
                                  "--profile_dir", prof_dir,
                                  "--profile_steps", str(CLI_STEPS_PER_EPOCH),
                                  *_cli_flags(gm3d_out, epochs=1)])
        gm3d_launches = pp.read_launches()
    finally:
        pretrain_cli.load_teacher_checkpoint = load
    want = with_probes(LAUNCHES_PER_STEP, CLI_STEPS_PER_EPOCH, 1)
    check(gm3d_launches == want, f"GM3D launches {gm3d_launches}, expected {want}")
    check(len(gm3d) == 1 and all(np.isfinite(gm3d[0][k]) for k in CLI_RECORD_KEYS), gm3d)
    saved = restore_raw(ckpt, map_location=DEV)["model"]
    inside = seen["teacher"].state_dict()
    check(sorted(saved) == sorted(inside), "the teacher's tensors differ from the saved ones")
    for key, value in saved.items():
        check(inside[key].device == value.device == DEV and torch.equal(inside[key], value),
              f"the teacher inside the run differs from its checkpoint at {key}")
    busy = device_busy_share(os.path.join(prof_dir, "trace.json"))
    gaps = device_idle_gaps(os.path.join(prof_dir, "trace.json"))
    res = {"phase": "teacher", "epochs": CLI_EPOCHS, "steps": steps, "batch": TRAIN_BATCH,
           "launches": launches, "launches_per_step": TEACHER_LAUNCHES_PER_STEP, "records": log,
           "teacher_clouds_per_sec_last_epoch": log[-1]["clouds_per_sec"],
           "latest_step": latest_step(ckpt), "gm3d_with_teacher_ckpt": {
               "launches": gm3d_launches, "teacher_tensors_equal": len(saved),
               "clouds_per_sec": gm3d[0]["clouds_per_sec"],
               "device_busy_share_4_steps": busy,
               "longest_device_idle_gaps_ms_at_ms": gaps},
           "gpu": env["gpu"]}
    emit(res)
    return {"launches": launches}


def _run_cli_process(args: list, log_path: str, until=None, timeout: float = 600.0):
    """``python -m gm3d_tpu_torch.cli.pretrain`` in a process of its own; with
    ``until`` (a path), SIGTERM once that file exists. Returns the exit code."""
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "gm3d_tpu_torch.cli.pretrain", *args],
                                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + timeout
        if until is not None:
            while not os.path.exists(until) and proc.poll() is None:
                check(time.monotonic() < deadline, f"{until} did not appear")
                time.sleep(0.02)
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        return proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def phase_resume(env: dict, tmp: str) -> None:
    """A real SIGTERM to the GM3D CLI in its own process, then ``--resume``;
    the asynchronous writer's snapshot at full width; save times."""
    out = os.path.join(tmp, "resume")
    ckpt = os.path.join(out, "ckpt")
    args = ["--config", GM3D_CONFIG, "--save_steps", "1", *_cli_flags(out)]
    rc = _run_cli_process(args, os.path.join(tmp, "preempted.log"),
                          until=os.path.join(ckpt, "loader_state.json"))
    with open(os.path.join(tmp, "preempted.log")) as f:
        text = f.read()
    check(rc == 0, f"the preempted CLI exited {rc}: {text[-2000:]}")
    check("preempted: checkpoint + loader position saved" in text, text[-2000:])
    stopped, token = latest_step(ckpt), load_loader_state(ckpt)
    total = CLI_EPOCHS * CLI_STEPS_PER_EPOCH
    check(0 < stopped < total, f"stopped at step {stopped}")
    check(stopped == token["epoch"] * CLI_STEPS_PER_EPOCH + token["batch"],
          f"checkpoint step {stopped} and loader position {token} disagree")
    rc = _run_cli_process(args + ["--resume"], os.path.join(tmp, "resumed.log"))
    with open(os.path.join(tmp, "resumed.log")) as f:
        text = f.read()
    check(rc == 0, f"the resumed CLI exited {rc}: {text[-2000:]}")
    check(f"resumed from step {stopped}" in text, text[-2000:])
    log = _read_log(out)
    check(sorted(r["epoch"] for r in log) == list(range(CLI_EPOCHS)), log)
    # the preempted run logged no epoch; the resumed one trains each batch left once
    check(sum(r["steps"] for r in log) == total - stopped, f"steps {[r['steps'] for r in log]}")
    check(latest_step(ckpt) == total, latest_step(ckpt))
    check(load_loader_state(ckpt) == {"epoch": CLI_EPOCHS, "batch": 0}, load_loader_state(ckpt))

    # the writer at full width: one step's state, saved from a snapshot while the
    # live tensors move on in place, restored into fresh modules on the card
    state, teacher = pp.build_pretrain_setup(seed=0, device="cuda")
    step = make_gm3d_train_step(state.student, teacher, state.optimizer)
    gen = torch.Generator(device=DEV).manual_seed(1)
    state, _ = step(state, _train_clouds(gen), gen, pp.SCALARS)
    torch.cuda.synchronize()
    state_bytes = sum(t.numel() * t.element_size() for t in tensors_of(capture(state)))
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    snap = device_snapshot(state)  # the first one allocates its buffers
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    snapshot_bytes = torch.cuda.memory_allocated() - base
    # a later one writes over them. The card is kept busy (_sleep) while the host
    # enqueues the copies, so that the events time the copies alone
    buffers = tensors_of(snap)
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    begin.record()
    t0 = time.perf_counter()
    device_snapshot(state, buffers)
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    snapshot_ms = begin.elapsed_time(end)
    del snap, buffers

    def timed_steps(n):
        # the training stream's own end, as a metrics read waits for it: a
        # device-wide synchronize would also wait for the writer's copies
        out, stream = [], torch.cuda.current_stream(DEV)
        for _ in range(n):
            pts = _train_clouds(gen)
            stream.synchronize()
            t0 = time.perf_counter()
            step(state, pts, gen, pp.SCALARS)
            stream.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    alone = timed_steps(3)
    writer = AsyncCheckpointWriter()
    async_dir = os.path.join(tmp, "async_ckpt")
    want = [t.clone() for t in tensors_of(capture(state))]
    saved_step = state.step
    writer.submit(state, lambda s: save_checkpoint(async_dir, s, saved_step))
    # the live tensors move on in place at once, while the save is in flight
    beside_save = timed_steps(3)
    writer.wait()
    moved = sum(not torch.equal(a, b) for a, b in zip(want, tensors_of(capture(state))))
    check(moved > len(want) // 2, f"only {moved} of {len(want)} live tensors moved")
    fresh, _ = pp.build_pretrain_setup(seed=5, device="cuda")
    check(restore_checkpoint(async_dir, fresh) == saved_step,
          "the async checkpoint did not restore")
    got = tensors_of(capture(fresh))
    check(len(got) == len(want), (len(got), len(want)))
    for i, (g, w) in enumerate(zip(got, want)):
        check(torch.equal(g.to(w.device), w), f"restored tensor {i} differs from the submitted")
    t0 = time.perf_counter()
    save_checkpoint(os.path.join(tmp, "sync_ckpt"), state, state.step)
    sync_save_s = time.perf_counter() - t0
    del state, teacher, fresh, want, got
    torch.cuda.empty_cache()

    # what the writer hides of an epoch: saves every 2 steps, inline or not
    rates = {}
    for name, extra in (("sync_save", ["--sync_save"]), ("async", [])):
        run = os.path.join(tmp, f"save_every_2_{name}")
        records = pretrain_cli.main(["--config", GM3D_CONFIG, "--save_steps", "2", *extra,
                                     *_cli_flags(run)])
        check(latest_step(os.path.join(run, "ckpt")) == total, name)
        rates[name] = [r["clouds_per_sec"] for r in records]
    emit({"phase": "resume", "preempted_at_step": stopped, "loader_position": token,
          "resumed_records": log, "latest_step": total, "state_bytes": state_bytes,
          "snapshot_ms_device": snapshot_ms, "snapshot_ms_host": host_ms,
          "first_snapshot_ms_wall": first_ms, "snapshot_extra_device_bytes": snapshot_bytes,
          "step_ms_wall_alone": alone, "step_ms_wall_beside_async_save": beside_save,
          "sync_save_s_wall": sync_save_s,
          "clouds_per_sec_save_every_2_steps": rates,
          "tmp_free_bytes": shutil.disk_usage(tmp).free, "gpu": env["gpu"]})


# the SVC alone at ModelNet40's size: clouds per class of its official split
# (modelnet40_train.txt / modelnet40_test.txt), features 384 wide (the encoder's
# width), class means N(0, SVC_SEPARATION^2) apart, unit noise: about the
# accuracy a pretrained encoder's features reach there
MODELNET40_TRAIN = (626, 106, 515, 173, 572, 335, 64, 197, 889, 167, 79, 138, 200, 109, 200,
                    149, 171, 155, 145, 124, 149, 284, 465, 200, 88, 231, 240, 104, 115, 128,
                    680, 124, 90, 392, 163, 344, 267, 475, 87, 103)
MODELNET40_TEST = (100, 50, 100, 20, 100, 100, 20, 100, 100, 20, 20, 20, 86, 20, 86, 20, 100,
                   100, 20, 20, 20, 100, 100, 86, 20, 100, 100, 20, 100, 20, 100, 20, 20, 100,
                   20, 100, 100, 100, 20, 20)
SVC_DIM, SVC_SEPARATION = 384, 0.22
# card and CPU run the same solver to a KKT gap of 1e-5 each; their Gram matrices
# differ in the last bits, so their paths may part at a near-tie
SVC_DEC_TOL = 1e-4
PROBE_LINE = re.compile(r"svm probe of epoch (\d+): acc ([0-9.]+); (.*)")


def _fresh_cli_logger(name: str = "gm3d") -> None:
    """A CLI configures its logger (``name``) once a process (its first run's
    ``pretrain.log`` or ``finetune.log``): drop that, so that the next run
    writes its own."""
    logger = logging.getLogger(name)
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    logger.__dict__.pop("_gm3d_configured", None)


def _probe_run(tmp: str, name: str, extra: list) -> dict:
    """The GM3D CLI at full width for two epochs, probing after each."""
    out = os.path.join(tmp, name)
    classification = "--classification" in extra
    _fresh_cli_logger()
    pp.reset_launches()  # this run's path: every launch count starts from 0 here
    t0 = time.perf_counter()
    records = pretrain_cli.main(["--config", GM3D_CONFIG, "--val_freq", "1", *extra,
                                 *_cli_flags(out)])
    wall_s = time.perf_counter() - t0
    launches = pp.read_launches()
    log = _read_log(out)
    check(log == records, f"{name}: log.txt differs from the records main() returned")
    check([r["epoch"] for r in log] == list(range(CLI_EPOCHS)), log)
    keys = CLI_RECORD_KEYS | ({"loss_cls", "acc_cls"} if classification else set())
    for r in log:
        check(set(r) == keys, f"{name}: log.txt keys {sorted(r)}")
        check(all(np.isfinite(r[k]) for k in keys), r)
        check(0.0 <= r["val_svm_acc"] <= 1.0, r)
    accs = [r["val_svm_acc"] for r in log]
    ckpt = os.path.join(out, "ckpt")
    best_step = (accs.index(max(accs)) + 1) * CLI_STEPS_PER_EPOCH
    check(load_best_metrics(ckpt) == {"best": max(accs)}, load_best_metrics(ckpt))
    check(all_steps(os.path.join(ckpt, "best")) == [best_step],
          f"{name}: ckpt/best {all_steps(os.path.join(ckpt, 'best'))}, expected [{best_step}]")
    with open(os.path.join(ckpt, "best", str(best_step), "metrics.json")) as f:
        check(json.load(f) == {"svm_acc": max(accs)}, f"{name}: ckpt/best metrics")
    steps = CLI_EPOCHS * CLI_STEPS_PER_EPOCH
    # the classification probe's encoder groups each of its batches: one FPS, one KNN
    per_step = dict(LAUNCHES_PER_STEP)
    if classification:
        per_step.update(fps=per_step["fps"] + 1, knn=per_step["knn"] + 1)
    want = with_probes(per_step, steps, CLI_EPOCHS)
    check(launches == want, f"{name}: launches {launches}, expected {want}")
    with open(os.path.join(out, "pretrain.log")) as f:
        probes = [m for m in map(PROBE_LINE.search, f) if m]
    check([int(m.group(1)) for m in probes] == list(range(CLI_EPOCHS)), "probe log lines")
    stats = [{"epoch": int(m.group(1)), "acc": float(m.group(2)),
              **{k: float(v) for k, v in (kv.split(" ") for kv in m.group(3).split(", "))}}
             for m in probes]
    return {"records": log, "launches": launches,
            "probe_launches_fps_knn": [launches[k] - per_step[k] * steps
                                       for k in ("fps", "knn")],
            "probes": stats, "clouds_per_sec": [r["clouds_per_sec"] for r in log],
            "wall_s": wall_s}


def _modelnet40_sized_features(seed: int):
    """Separable class means plus unit noise, drawn on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    means = torch.randn((len(MODELNET40_TRAIN), SVC_DIM), generator=gen,
                        dtype=torch.float64) * SVC_SEPARATION

    def draw(counts):
        labels = torch.repeat_interleave(torch.arange(len(counts)), torch.tensor(counts))
        noise = torch.randn((len(labels), SVC_DIM), generator=gen, dtype=torch.float64)
        return (means[labels] + noise).to(torch.float32), labels

    return draw(MODELNET40_TRAIN) + draw(MODELNET40_TEST)


def _fit(x, y, xt):
    """Fit, predict and score on the device of ``x``; wall time to the answer."""
    if x.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = linear_svc.fit_linear_svc(x, y)
    dec = linear_svc.ovo_decision_values(model, xt)
    pred = linear_svc.predict(model, xt)
    if x.is_cuda:
        torch.cuda.synchronize()
    return model, dec.cpu(), pred.cpu(), time.perf_counter() - t0


def phase_probe(env: dict, tmp: str, seed: int) -> dict:
    """The CLI's SVM probe at full width, then its SVC at ModelNet40's size."""
    runs = {"background": _probe_run(tmp, "background", []),
            "sync": _probe_run(tmp, "sync", ["--sync_probe"]),
            "sync_classification": _probe_run(tmp, "sync_classification",
                                              ["--sync_probe", "--classification"])}
    check(all(min(r["probe_launches_fps_knn"]) > 0 for r in runs.values()),
          "the probe launched no FPS or KNN kernel")

    x, y, xt, yt = _modelnet40_sized_features(seed)
    check(x.shape == (9843, SVC_DIM) and xt.shape == (2468, SVC_DIM), (x.shape, xt.shape))
    xg, yg, xtg = x.to(DEV), y.to(DEV), xt.to(DEV)
    _fit(xg[::16], yg[::16], xtg[:8])  # every class, a sixteenth: the solver's launches warm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(DEV)
    base = torch.cuda.memory_allocated(DEV)
    card, dec_card, pred_card, card_s = _fit(xg, yg, xtg)
    peak = torch.cuda.max_memory_allocated(DEV) - base
    cpu, dec_cpu, pred_cpu, cpu_s = _fit(x, y, xt)
    dec_err = float((dec_card - dec_cpu).abs().max())
    check(torch.equal(pred_card, pred_cpu),
          f"card and CPU predict {int((pred_card != pred_cpu).sum())} test clouds apart")
    check(dec_err <= SVC_DEC_TOL, f"decision values {dec_err} apart, tolerance {SVC_DEC_TOL}")
    for model in (card, cpu):
        check(float(model.gap.max()) < linear_svc.TOL, float(model.gap.max()))
    res = {"phase": "probe", "cli_runs": runs,
           "svc_modelnet40_size": {
               "train": list(x.shape), "test": list(xt.shape), "classes": len(MODELNET40_TRAIN),
               "pairs": int(card.coef.shape[0]), "seed": seed, "separation": SVC_SEPARATION,
               "card_wall_s": card_s, "cpu_wall_s": cpu_s, "cpu_threads": torch.get_num_threads(),
               "card_peak_extra_bytes": peak,
               "iterations_max_card": int(card.iterations.max()),
               "iterations_mean_card": float(card.iterations.float().mean()),
               "iterations_max_cpu": int(cpu.iterations.max()),
               "accuracy": float((pred_card == yt).float().mean()),
               "predictions_equal": True, "max_abs_decision_diff": dec_err,
               "tol": SVC_DEC_TOL},
           "gpu": env["gpu"]}
    emit(res)
    return {name: run["launches"] for name, run in runs.items()}


# the step's options at full width (phase step_options): four micro-steps of two
# an update, two steps of each other option, six bf16 steps each way
ACCUM, ACCUM_MICRO_STEPS, OPTION_STEPS, BF16_STEPS = 2, 4, 2, 6
# --no-shared_opt: the teacher encodes the cloud (12 blocks) inside the loss and
# replays nothing, so 24 (EMA) + 28 (student) + 12 attention forwards a step
SEPARATED_LAUNCHES_PER_STEP = {"fps": 1, "knn": 1, "patch_embed": 2, "attention_fwd": 64,
                               "attention_bwd": 28}
# remat against the plain step, both through the kernels from one state and one
# generator: the attention backward sums dW by fp32 atomicAdd (ROADMAP Queue 3),
# so the two steps' weight gradients part in their last bits; metrics to
# TOL_REMAT, and a parameter may move by up to two learning rates apart where
# its gradient is rounding noise (Adam's first steps move by about lr * sign(g)),
# in at most TOL_REMAT_SHARE of the entries
TOL_REMAT, TOL_REMAT_SHARE = 2e-3, 1e-3
# the bf16 step through the kernels against the unfused bf16 step, first step's
# metrics: five of bf16's roundings (2^-8 each)
TOL_BF16 = 2e-2
OPTION_LR = 1e-3


def _float_state(module: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()
            if v.dtype.is_floating_point}


def _moved(before: dict, module: torch.nn.Module) -> dict:
    now = module.state_dict()
    return {k: not torch.equal(now[k], v) for k, v in before.items()}


def _steps(step, state, gen, n: int):
    """``n`` steps of fresh clouds: state, metrics, wall ms a step, and the peak
    device memory above what was allocated before them (activations and the
    step's temporaries)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    base = torch.cuda.memory_allocated(DEV)
    history, wall = [], []
    for _ in range(n):
        pts = _train_clouds(gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, pts, gen, pp.SCALARS)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(metrics[k]) for k in METRIC_KEYS})
    check(all(np.isfinite(v) for m in history for v in m.values()), history)
    return state, history, wall, torch.cuda.max_memory_allocated(DEV) - base


def _fresh_optimizer(state, **kwargs):
    state.optimizer = build_gm3d_shared_optimizer(state.student, OPTION_LR, **kwargs)
    state.step = 0
    return state


def _attention_kernel_ms(trace_path: str) -> dict:
    """Launches and summed device ms of the attention kernels in a trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for name, kernel in (("attention_fwd", "attn_fwd_kernel"), ("attention_bwd", "attn_bwd_kernel")):
        durs = [float(e["dur"]) for e in events
                if e.get("cat") == "kernel" and kernel in e.get("name", "")]
        out[name] = {"launches": len(durs), "ms_total": sum(durs) / 1e3,
                     "ms_mean": sum(durs) / 1e3 / max(len(durs), 1)}
    return out


def phase_step_options(env: dict, trained: dict | None, tmp: str) -> dict:
    """The GM3D step's options at full width through the kernels: gradient
    accumulation, the separated optimizers, remat, bf16, and the CLI with
    ``--accum_iter 2 --no-shared_opt --bf16``."""
    pp.reset_launches()  # this phase's paths: every launch count starts from 0 here
    res = {"phase": "step_options", "batch": TRAIN_BATCH}

    # ---- accumulation: two micro-steps an update
    state, teacher = pp.build_pretrain_setup(seed=0, device="cuda")
    _fresh_optimizer(state, accum_steps=ACCUM)
    step = make_gm3d_train_step(state.student, teacher, state.optimizer, accum_steps=ACCUM)
    params = _float_state(state.student)
    ema = _float_state(state.ema)
    stats = [k for k in params if k.endswith(("running_mean", "running_var"))]
    weights = [k for k in params if k not in stats and not k.startswith(GM3D_COORD_HEAD)]
    gen = torch.Generator(device=DEV).manual_seed(2)
    per_micro, wall, updated = [], [], []
    for i in range(ACCUM_MICRO_STEPS):
        before = pp.read_launches()
        state, _, ms, _ = _steps(step, state, gen, 1)
        after = pp.read_launches()
        per_micro.append({k: after[k] - before[k] for k in after})
        wall.append(ms[0])
        moved, ema_moved = _moved(params, state.student), _moved(ema, state.ema)
        if i % ACCUM == 0:
            check(not any(moved[k] for k in weights), f"micro-step {i + 1} moved a parameter")
            check(not any(ema_moved.values()), f"micro-step {i + 1} moved the EMA")
            check(all(moved[k] for k in stats), "the BatchNorm statistics did not move")
        else:
            check(all(moved[k] for k in weights),
                  f"micro-step {i + 1} left {[k for k in weights if not moved[k]][:3]}")
            check(all(ema_moved[k] for k in weights), f"micro-step {i + 1}: EMA did not move")
        updated.append(i % ACCUM == ACCUM - 1)
        params, ema = _float_state(state.student), _float_state(state.ema)
    check(all(m == LAUNCHES_PER_STEP for m in per_micro), f"launches a micro-step {per_micro}")
    check(state.optimizer.gradient_step == ACCUM_MICRO_STEPS // ACCUM, "updates")
    # the fold of one micro-step's gradients into the running mean, alone: a window
    # that never closes, over a gradient for every parameter it owns
    fold = MultiSteps(state.optimizer.inner, accum_steps=1 << 30)
    for p in fold._params:
        p.grad = torch.full_like(p, 1e-3)
    owned_bytes = sum(p.numel() * p.element_size() for p in fold._params)
    fold_ms = cuda_ms(fold.step, runs=10, warmup=2)
    state.student.zero_grad(set_to_none=True)
    del fold
    res["accumulation"] = {
        "accum_steps": ACCUM, "micro_steps": ACCUM_MICRO_STEPS, "updated": updated,
        "launches_per_micro_step": per_micro, "ms_per_micro_step_wall": wall,
        "fold_ms": fold_ms, "owned_parameters": owned_bytes // 4,
        # read the gradients, read and write the running mean
        "fold_bound_ms": bound(3 * owned_bytes, 0.0)[0]}

    # ---- --no-shared_opt: the separated optimizers on the same student
    state.optimizer = build_gm3d_separated_optimizer(state.student, OPTION_LR,
                                                     loss_pred_learning_rate=OPTION_LR)
    state.step = 0
    step = make_gm3d_train_step(state.student, teacher, state.optimizer, shared_opt=False)
    labels = gm3d_separated_labels(state.student)
    params = _float_state(state.student)
    before = pp.read_launches()
    state, history, wall, _ = _steps(step, state, gen, OPTION_STEPS)
    after = pp.read_launches()
    launches = {k: after[k] - before[k] for k in after}
    want = {k: v * OPTION_STEPS for k, v in SEPARATED_LAUNCHES_PER_STEP.items()}
    check(launches == want, f"separated launches {launches}, expected {want}")
    moved = _moved(params, state.student)
    frozen = [k for k, lab in labels.items() if lab == "frozen"]
    check(sorted(frozen) == ["decoder_pos_embed.0.bias", "decoder_pos_embed.0.weight",
                             "decoder_pos_embed.2.bias", "decoder_pos_embed.2.weight",
                             "mask_token", "mask_token_loss_pred"], frozen)
    check(not any(moved[k] for k in frozen), "a frozen parameter moved")
    moved_sets = {lab: sum(moved[k] for k, lb in labels.items() if lb == lab)
                  for lab in ("recon", "loss_pred")}
    check(all(moved_sets.values()), f"moved parameters per set {moved_sets}")
    res["separated"] = {"steps": OPTION_STEPS, "launches": launches, "metrics": history,
                        "ms_per_step_wall": wall, "moved_per_set": moved_sets,
                        "frozen_unmoved": frozen}

    # ---- remat_student against the plain step, from one state and one generator
    runs = {}
    ref = (copy.deepcopy(state.student), copy.deepcopy(state.ema))
    for name in ("plain", "remat"):
        state.student.load_state_dict(ref[0].state_dict())
        state.ema.load_state_dict(ref[1].state_dict())
        _fresh_optimizer(state)
        step = make_gm3d_train_step(state.student, teacher, state.optimizer,
                                    remat_student=name == "remat")
        gen = torch.Generator(device=DEV).manual_seed(3)
        before = pp.read_launches()
        state, history, wall, peak = _steps(step, state, gen, OPTION_STEPS)
        after = pp.read_launches()
        runs[name] = {"metrics": history, "ms_per_step_wall": wall, "peak_extra_bytes": peak,
                      "launches": {k: after[k] - before[k] for k in after},
                      "params": _float_state(state.student)}
    del ref
    rel = [{k: abs(r[k] - p[k]) / max(abs(p[k]), 1e-12) for k in METRIC_KEYS}
           for p, r in zip(runs["plain"]["metrics"], runs["remat"]["metrics"])]
    check(all(v <= TOL_REMAT for d in rel for v in d.values()), f"remat metrics apart {rel}")
    plain_p, remat_p = runs["plain"].pop("params"), runs["remat"].pop("params")
    diffs = torch.cat([(plain_p[k] - remat_p[k]).abs().flatten() for k in plain_p])
    max_diff, share = float(diffs.max()), float((diffs > 1e-5).float().mean())
    check(max_diff <= 2 * OPTION_STEPS * OPTION_LR and share <= TOL_REMAT_SHARE,
          f"remat parameters apart: max {max_diff}, share above 1e-5 {share}")
    del plain_p, remat_p, diffs
    res["remat"] = {**runs, "rel_diff_metrics": rel, "tol": TOL_REMAT,
                    "max_abs_param_diff": max_diff, "share_params_apart_1e-5": share,
                    "tol_share": TOL_REMAT_SHARE}
    del state, teacher, step
    torch.cuda.empty_cache()

    # ---- bf16 compute through the kernels, then the same steps unfused, both from
    # one state and one generator
    state, teacher = pp.build_pretrain_setup(seed=0, device="cuda", dtype=torch.bfloat16)
    bf16 = {}
    ref = (copy.deepcopy(state.student), copy.deepcopy(state.ema))
    for name, fused in (("kernels", True), ("unfused_attention", False)):
        state.student.load_state_dict(ref[0].state_dict())
        state.ema.load_state_dict(ref[1].state_dict())
        _fresh_optimizer(state)
        step = make_gm3d_train_step(state.student, teacher, state.optimizer,
                                    use_fused_attention=fused)
        gen = torch.Generator(device=DEV).manual_seed(4)
        before = pp.read_launches()
        state, history, wall, peak = _steps(step, state, gen, BF16_STEPS)
        after = pp.read_launches()
        launches = {k: after[k] - before[k] for k in after}
        if fused:
            want = {k: v * BF16_STEPS for k, v in LAUNCHES_PER_STEP.items()}
            check(launches == want, f"bf16 launches {launches}, expected {want}")
        bf16[name] = {"launches": launches, "metrics_first_last": [history[0], history[-1]],
                      "ms_per_step_wall": wall,
                      "clouds_per_s": TRAIN_BATCH / statistics.median(wall[1:]) * 1e3,
                      "peak_extra_bytes": peak}
    del ref
    # the first step, where both routes start alike: the unfused modules round
    # qkv, the probabilities and the heads' outputs to bf16 where the kernels
    # sum in fp32, and the masks follow the EMA's bf16 predictions
    first = [bf16[name]["metrics_first_last"][0] for name in ("kernels", "unfused_attention")]
    rel = {k: abs(first[0][k] - first[1][k]) / max(abs(first[1][k]), 1e-12)
           for k in METRIC_KEYS}
    print(f"step_options: bf16 first step, kernels {first[0]}, unfused {first[1]}, "
          f"relative {rel} (tol {TOL_BF16})", flush=True)
    check(all(v <= TOL_BF16 for v in rel.values()), f"bf16 kernels against unfused {rel}")
    bf16["first_step_rel_diff"], bf16["tol"] = rel, TOL_BF16
    # the attention kernels' own time inside one more bf16 step, from a trace
    step = make_gm3d_train_step(state.student, teacher, state.optimizer)
    prof_dir = os.path.join(tmp, "bf16_trace")
    prof = start_trace(prof_dir)
    state, _ = step(state, _train_clouds(gen), gen, pp.SCALARS)
    traced = _attention_kernel_ms(stop_trace(prof, prof_dir))
    check([traced[k]["launches"] for k in ("attention_fwd", "attention_bwd")]
          == [LAUNCHES_PER_STEP["attention_fwd"], LAUNCHES_PER_STEP["attention_bwd"]],
          f"the trace of a bf16 step holds {traced}")
    bf16["kernels"]["attention_in_one_traced_step"] = traced
    check(all(p.dtype == torch.float32 for p in state.student.parameters()), "bf16 parameters")
    if trained is not None:
        bf16["fp32_train_step_clouds_per_s"] = trained["clouds_per_s"]
    res["bf16"] = bf16
    del state, teacher, step
    torch.cuda.empty_cache()

    # ---- the CLI with the three options together
    out = os.path.join(tmp, "options_cli")
    _fresh_cli_logger()
    before = pp.read_launches()
    records = pretrain_cli.main(["--config", GM3D_CONFIG, "--accum_iter", str(ACCUM),
                                 "--no-shared_opt", "--bf16", *_cli_flags(out, epochs=1)])
    after = pp.read_launches()
    launches = {k: after[k] - before[k] for k in after}
    log = _read_log(out)
    check(log == records and len(log) == 1, log)
    check(set(log[0]) == CLI_RECORD_KEYS and all(np.isfinite(log[0][k]) for k in log[0]), log)
    check(log[0]["steps"] == CLI_STEPS_PER_EPOCH, log)
    # the warm-up schedule over UPDATES, at the doubled effective learning rate
    sched = cosine_warmup_schedule(effective_lr(1e-3, TRAIN_BATCH, ACCUM), 0.0, 40, 1,
                                   CLI_STEPS_PER_EPOCH // ACCUM)
    want_lr = sched(CLI_STEPS_PER_EPOCH // ACCUM)
    check(abs(log[0]["lr"] - want_lr) <= 1e-12 * want_lr, (log[0]["lr"], want_lr))
    want = with_probes(SEPARATED_LAUNCHES_PER_STEP, CLI_STEPS_PER_EPOCH, 1)
    check(launches == want, f"CLI launches {launches}, expected {want}")
    ckpt = os.path.join(out, "ckpt")
    raw = restore_raw(ckpt)
    check(latest_step(ckpt) == CLI_STEPS_PER_EPOCH, latest_step(ckpt))
    check((raw["optimizer"]["mini_step"], raw["optimizer"]["gradient_step"])
          == (0, CLI_STEPS_PER_EPOCH // ACCUM), "the checkpoint's accumulation counts")
    check(set(raw["optimizer"]["inner"]) == {"recon", "loss_pred"}, "separated halves")
    res["cli"] = {"flags": ["--accum_iter", str(ACCUM), "--no-shared_opt", "--bf16"],
                  "records": log, "launches": launches, "checkpoint_step": latest_step(ckpt)}
    res["launches"] = pp.read_launches()
    res["gpu"] = env["gpu"]
    emit(res)
    return {"launches": res["launches"]}

# the finetune path: configs/pointmae/finetune_modelnet.yaml at full width, B 32,
# on a ModelNet-layout directory of synthetic 8,192-point clouds in 40 classes
FT_CONFIG = CONFIG
FT_BATCH, FT_TRAIN, FT_TEST, FT_POINTS, FT_EPOCHS = 32, 512, 128, 8192, 2
FT_NPOINTS, FT_POINT_ALL = 1024, 1200
# launches the JAX finetune code implies: the train step FPS to point_all (the
# cloud is larger, gm3d_tpu/train/finetune.py:75-76), then one grouping (FPS,
# KNN) in the model; the eval step FPS to npoints (:154), then the grouping;
# the vote step FPS to point_all once (:177), then one grouping of the ten
# votes stacked into one forward. No fused attention, no fused patch embed on
# any of them (:103-107, :158-159)
FT_LAUNCHES_PER_STEP = {"fps": 2, "knn": 1, "patch_embed": 0, "attention_fwd": 0,
                        "attention_bwd": 0}
FT_RECORD_KEYS = {"loss", "acc", "grad_norm", "epoch", "time", "val_acc"}
TOL_SERVE = 2e-3


def _modelnet_dir(root: str, seed: int) -> str:
    """A ModelNet40 directory as the reader finds it: the shape names, the two
    split lists and the FPS caches it reads first (``modelnet40_*_8192pts_fps.dat``),
    holding synthetic clouds of FT_POINTS points, a few gaussian blobs a class."""
    rng = np.random.default_rng(seed)
    names = [f"shape{c:02d}" for c in range(40)]
    blobs = rng.standard_normal((40, 8, 3)).astype(np.float32)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "modelnet40_shape_names.txt"), "w") as f:
        f.write("\n".join(names))
    for split, n in (("train", FT_TRAIN), ("test", FT_TEST)):
        labels = np.arange(n) % 40
        which = rng.integers(0, 8, (n, FT_POINTS))
        pts = blobs[labels[:, None], which] + 0.15 * rng.standard_normal(
            (n, FT_POINTS, 3), dtype=np.float32)
        ids = [f"{names[c]}_{i:04d}" for i, c in enumerate(labels)]
        with open(os.path.join(root, f"modelnet40_{split}.txt"), "w") as f:
            f.write("\n".join(ids))
        with open(os.path.join(root, f"modelnet40_{split}_8192pts_fps.dat"), "wb") as f:
            pickle.dump((pts.astype(np.float32), labels.astype(np.int64)), f)
    return root


def _finetune_config(tmp: str, data: str) -> str:
    import yaml

    with open(FT_CONFIG) as f:
        cfg = yaml.safe_load(f)
    for split in ("train", "val", "test"):
        cfg["dataset"][split]["_base_"]["DATA_PATH"] = data
    path = os.path.join(tmp, "finetune_modelnet_local.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _serve_cli(art: str, clouds: np.ndarray, log_path: str) -> np.ndarray:
    """``python -m gm3d_tpu_torch.cli.serve`` in a process of its own: wait for
    /health, POST the clouds (one JSON request of one cloud, then the rest as
    one .npy request), stop it with SIGTERM. Returns the served logits."""
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "gm3d_tpu_torch.cli.serve",
                                 "--artifact", art, "--port", str(port)],
                                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 180
        while True:
            check(proc.poll() is None, f"the server exited early ({log_path})")
            check(time.monotonic() < deadline, "the server did not come up")
            try:
                if _http(base + "/health")[0] == 200:
                    break
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.2)
        status, one = _http(base + "/predict",
                            json.dumps({"points": clouds[0].tolist()}).encode())
        check(status == 200, status)
        buf = io.BytesIO()
        np.save(buf, clouds[1:])
        status, rest = _http(base + "/predict", buf.getvalue(), "application/octet-stream")
        check(status == 200, status)
        proc.send_signal(signal.SIGTERM)
        check(proc.wait(timeout=60) == 0, "the server did not stop cleanly on SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return np.concatenate([np.asarray(one["outputs"], np.float32)[None],
                           np.asarray(rest["outputs"], np.float32)])


def _finetune_model(dtype=torch.float32, state=None):
    from gm3d_tpu_torch.config import build_model_from_cfg, cfg_from_yaml_file

    model = build_model_from_cfg(cfg_from_yaml_file(FT_CONFIG)["model"], dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(0))
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model.to(DEV)


def phase_finetune(env: dict, tmp: str, seed: int) -> dict:
    """Pretrain -> finetune -> export -> serve inside the port on the card."""
    from gm3d_tpu_torch.cli import finetune as finetune_cli
    from gm3d_tpu_torch.train import finetune as ft
    from gm3d_tpu_torch.train.optim import build_finetune_optimizer
    from gm3d_tpu_torch.train.state import create_train_state

    res = {"phase": "finetune", "batch": FT_BATCH, "points": FT_POINTS}
    config = _finetune_config(tmp, _modelnet_dir(os.path.join(tmp, "modelnet40"), seed))

    # ---- the pretrained weights: one short epoch of the port's GM3D pretrain CLI
    pre_out = os.path.join(tmp, "pretrain")
    _fresh_cli_logger()
    pretrain_cli.main(["--config", GM3D_CONFIG, "--synthetic", "--synthetic_samples", "128",
                       "--batch_size", "64", "--epochs", "1", "--output_dir", pre_out])
    pretrained = os.path.join(pre_out, "ckpt")

    # ---- the finetune CLI, both recipes, from that checkpoint
    runs, launches_all = {}, {k: 0 for k in FT_LAUNCHES_PER_STEP}
    steps = FT_EPOCHS * (FT_TRAIN // FT_BATCH)
    val_batches = -(-FT_TEST // FT_BATCH)
    for recipe in ("legacy", "hpm"):
        out = os.path.join(tmp, f"finetune_{recipe}")
        _fresh_cli_logger("gm3d.finetune")
        pp.reset_launches()  # the finetune CLI's path: every launch count starts from 0 here
        records = finetune_cli.main(["--config", config, "--epochs", str(FT_EPOCHS),
                                     "--recipe", recipe, "--vote", "--pretrained", pretrained,
                                     "--output_dir", out])
        launches = pp.read_launches()
        log = _read_log(out)
        check(log == records, "log.txt differs from the records main() returned")
        with open(os.path.join(out, "finetune.log")) as f:
            text = f.read()
        moved = re.search(r"pretrain->finetune transfer: (\d+) leaves overlaid", text)
        check(moved is not None and int(moved.group(1)) > 100,
              f"{recipe}: the transfer log line reports {moved and moved.group(1)} keys")
        epochs = log[:-1]
        check([r["epoch"] for r in epochs] == list(range(FT_EPOCHS)), log)
        for r in epochs:
            check(FT_RECORD_KEYS <= set(r) <= FT_RECORD_KEYS | {"val_vote_acc"}, sorted(r))
            check(all(np.isfinite(r[k]) for k in r), r)
        check(set(log[-1]) == {"vote_acc"} and np.isfinite(log[-1]["vote_acc"]), log[-1])
        check(latest_step(os.path.join(out, "ckpt", "best")) is not None, "no ckpt/best")
        votes = 1 + sum("val_vote_acc" in r for r in epochs)
        evals = FT_EPOCHS * val_batches + votes * val_batches
        want = {k: v * (steps + evals) for k, v in FT_LAUNCHES_PER_STEP.items()}
        check(launches == want, f"{recipe} launches {launches}, expected {want}")
        for k in launches_all:
            launches_all[k] += launches[k]
        runs[recipe] = {
            "records": log, "launches": launches, "keys_transferred": int(moved.group(1)),
            "clouds_per_sec_each_epoch": [(FT_TRAIN // FT_BATCH) * FT_BATCH / max(r["time"], 1e-9)
                                          for r in epochs]}
    res["cli_runs"] = runs
    res["launches"] = launches_all

    # ---- the launches of one train step, one eval batch and one vote batch
    with open(os.path.join(tmp, "modelnet40", "modelnet40_test_8192pts_fps.dat"), "rb") as f:
        data = pickle.load(f)[0][:FT_BATCH]
    pts = torch.from_numpy(data).to(DEV)
    labels = (torch.arange(FT_BATCH, device=DEV) % 40)
    per = {}
    model = _finetune_model()
    optimizer = build_finetune_optimizer(model.named_parameters(), 1e-4)
    state = create_train_state(model, optimizer)
    step = ft.make_finetune_train_step(model, optimizer, FT_NPOINTS)
    eval_step = ft.make_eval_step(model, FT_NPOINTS)
    vote_step = ft.make_vote_eval_step(model, FT_NPOINTS)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    for name, fn in (("train_step", lambda: step(state, pts, labels, gen)),
                     ("eval_batch", lambda: eval_step(pts)),
                     ("vote_batch", lambda: vote_step(pts, gen))):
        pp.reset_launches()
        fn()
        torch.cuda.synchronize()
        per[name] = pp.read_launches()
        check(per[name] == FT_LAUNCHES_PER_STEP,
              f"{name} launches {per[name]}, expected {FT_LAUNCHES_PER_STEP}")
    res["launches_per"] = per

    # ---- FPS at the step's shape, index-equal to its plain version
    got = fps_indices(pts, FT_POINT_ALL)
    want_idx = fps_indices_torch(pts, FT_POINT_ALL)
    torch.cuda.synchronize()
    check(torch.equal(got.long(), want_idx.long()),
          f"fps 8192->1200 differs from its plain version at {int((got != want_idx).sum())}")
    fps_1200 = graph_ms(lambda: fps_indices(pts, FT_POINT_ALL))
    fps_1024 = graph_ms(lambda: fps_indices(pts, FT_NPOINTS))

    # ---- the bare step (median of 5 after 2 warm-up), fp32 and bf16; eval, vote
    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = _finetune_model(dtype)
        optimizer = build_finetune_optimizer(model.named_parameters(), 1e-4)
        state = create_train_state(model, optimizer)
        step = ft.make_finetune_train_step(model, optimizer, FT_NPOINTS)
        gen = torch.Generator(device=DEV).manual_seed(seed)
        event_ms, wall_ms, losses = [], [], []
        for _ in range(7):
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            begin.record()
            _, m = step(state, pts, labels, gen)
            end.record()
            torch.cuda.synchronize()
            wall_ms.append((time.perf_counter() - t0) * 1e3)
            event_ms.append(begin.elapsed_time(end))
            losses.append(float(m["loss"]))
        check(all(np.isfinite(losses)), losses)
        name = "fp32" if dtype == torch.float32 else "bf16"
        ms = statistics.median(event_ms[2:])
        timing[name] = {"step_ms_cuda_events": ms,
                        "step_ms_wall": statistics.median(wall_ms[2:]),
                        "clouds_per_s": FT_BATCH / statistics.median(wall_ms[2:]) * 1e3,
                        "losses": losses}
        if dtype == torch.float32:
            eval_step = ft.make_eval_step(model, FT_NPOINTS)
            vote_step = ft.make_vote_eval_step(model, FT_NPOINTS)
            timing["eval_ms_per_batch"] = cuda_ms(lambda: eval_step(pts), runs=10, warmup=2)
            timing["vote_ms_per_batch"] = cuda_ms(lambda: vote_step(pts, gen), runs=5, warmup=1)
            timing["fps_8192_to_1200_graph_ms"] = fps_1200
            timing["fps_8192_to_1024_graph_ms"] = fps_1024
            timing["fps_share_of_step"] = fps_1200 / ms
    # the CLI's train loader alone (4 worker threads, the default): ms a batch
    from gm3d_tpu_torch.cli.common import make_cls_loaders
    from gm3d_tpu_torch.config import cfg_from_yaml_file

    loader = make_cls_loaders(cfg_from_yaml_file(config), finetune_cli.parse_args(
        ["--config", config, "--output_dir", tmp]))[0]
    t0 = time.perf_counter()
    batches = sum(1 for _ in loader)
    timing["loader_ms_per_batch"] = (time.perf_counter() - t0) / batches * 1e3
    for run in runs.values():
        run["cli_over_step"] = [r / timing["fp32"]["clouds_per_s"]
                                for r in run["clouds_per_sec_each_epoch"]]
    res["timing"] = timing

    # ---- export ckpt/best with 8192-point inputs, serve it, POST requests
    best = os.path.join(tmp, "finetune_hpm", "ckpt", "best")
    art = export_model.main(["--config", config, "--ckpt", best, "--input_points",
                             str(FT_POINTS), "--export_batch", str(FT_BATCH),
                             "--out", os.path.join(tmp, "finetuned.gm3dx"), "--device", "cuda"])
    served = _serve_cli(art, data[:6], os.path.join(tmp, "serve.log"))
    model = _finetune_model(state=restore_raw(best)["model"])
    want_logits = ft.make_eval_step(model, FT_NPOINTS)(torch.from_numpy(data[:6])).cpu().numpy()
    res["served_vs_eval_step_max_abs_err"] = _agree(served, want_logits, atol=TOL_SERVE)
    res["served_ckpt_step"] = latest_step(best)
    res["tol_serve"] = TOL_SERVE
    res["gpu"] = env["gpu"]
    emit(res)
    return {"launches": launches_all}


PHASES = ("env", "build", "kernels", "serve", "throughput", "train", "pretrain_cli", "teacher",
          "resume", "probe", "step_options", "finetune")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list out of: " + ",".join(PHASES))
    ap.add_argument("--seed", type=int, default=0,
                    help="draws the features of the phase probe's SVC fit and the "
                         "clouds of the phase finetune")
    cli_args = ap.parse_args()
    phases = cli_args.phases.split(",")
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
    cli = phase_pretrain_cli(env, trained) if "pretrain_cli" in phases else None
    with tempfile.TemporaryDirectory() as tmp:
        taught = phase_teacher(env, tmp) if "teacher" in phases else None
    with tempfile.TemporaryDirectory() as tmp:
        if "resume" in phases:
            phase_resume(env, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        probed = phase_probe(env, tmp, cli_args.seed) if "probe" in phases else None
    with tempfile.TemporaryDirectory() as tmp:
        options = (phase_step_options(env, trained, tmp) if "step_options" in phases
                   else None)
    with tempfile.TemporaryDirectory() as tmp:
        tuned = phase_finetune(env, tmp, cli_args.seed) if "finetune" in phases else None
    if tuple(phases) != PHASES:
        raise SystemExit(f"partial run ({phases}): no result line")
    for kern in timed:
        # FPS and KNN are on both paths: `launches` is the serving run's count
        if kern["name"] in served["launches"]:
            kern["launches"] = served["launches"][kern["name"]]
            kern["launches_train"] = trained["launches"][kern["name"]]
        else:
            kern["launches"] = trained["launches"][kern["name"]]
        kern["launches_pretrain_cli"] = cli["launches"][kern["name"]]
        # the teacher's step launches FPS and KNN only, as the JAX step routes it
        kern["launches_teacher"] = taught["launches"][kern["name"]]
        # with the SVM probe in the background, the CLI's default
        kern["launches_probe_background"] = probed["background"][kern["name"]]
        # accumulation, the separated optimizers, remat, bf16 and their CLI run
        kern["launches_step_options"] = options["launches"][kern["name"]]
        # both finetune recipes' CLI runs: FPS and KNN only, as the JAX steps route it
        kern["launches_finetune"] = tuned["launches"][kern["name"]]
        check(kern["launches"] > 0 and kern["launches_pretrain_cli"] > 0,
              f"{kern['name']} was never launched on its path")
    emit({"kernels": timed})
    print(env["gpu"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
