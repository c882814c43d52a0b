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
              wrapper's host time; ``host``, the host time of a wrapper call
              through the custom op's dispatcher and of its CUDA
              implementation called directly)
  serve       exports the full-width PointTransformer classifier (random
              weights from a seed) through the export CLI as one
              ``torch.export`` artifact for ``cpu,cuda``, serves it over HTTP
              with dynamic batching, checks the answers against the same
              artifact on the CPU, and counts kernel launches; a cuda-only
              artifact is refused on the CPU; the kernels' launches inside one
              call of the loaded program; the program against the eager module
              it was traced from at B 128 in fp32, bf16 and int8 (equal
              outputs, CUDA-event ms, host ms of a call)
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
              of the GM3D pretrain CLI (its checkpoint serves the phases
              ``segmentation`` and ``fewshot`` too); the finetune CLI
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
  segmentation  part segmentation at ``seg_shapenetpart.yaml``'s full width
              (B 16 x 2,048 points, 128 groups): FPS 2,048 -> 128 and the
              grouping's KNN (k 32) on the step's inputs index-equal to their
              plain versions (KNN distances within rtol 1e-6); the KNN kernel
              at the feature propagation's shape (2,048 queries on the 128 FPS centers, k 3,
              with distances) index-equal to its plain version, distances
              within rtol 1e-6, the propagated features' gap at the points
              that are centers and elsewhere, its CUDA-graph time beside
              ``cdist`` + ``topk``; the bare seg step (launches FPS 1, KNN 2;
              ms and clouds per second, fp32 and bf16; an eval batch's ms);
              the seg CLI for two epochs from the GM3D pretrain checkpoint
              (records with ``instance_miou`` and ``class_miou``, more than
              100 keys transferred, ``ckpt/best``, launches); ``ckpt/best``
              exported with ``--mode segmentation`` and served by
              ``gm3d_tpu_torch.cli.serve`` in a process of its own: part labels
              equal to the eval step's category-restricted arg-max, logits
              within ``TOL_SERVE``; another ``--input_points`` refused
  fewshot     the few-shot CLI at ``fewshot.yaml``'s full width, 5-way 10-shot,
              the published ten folds of two epochs on synthetic episodes from
              the same pretrain checkpoint, its folds trained together (the
              default) and then one after another: per-fold accuracies, mean
              and std in ``log.txt``, each fold's accuracy within one test cloud
              across the two, wall seconds, launches (FPS 1, KNN 1 a batched
              step or evaluation batch for all ten folds, ten times that one
              after another); the same for ``fewshot-Point-M2AE.yaml`` (B 40,
              one epoch, weights from each fold's seed; FPS 3, KNN 3); then for
              each, the fold-batched step against each fold's own step from the
              same weights and generators (losses of ``FS_STEPS`` steps within
              ``TOL_FS_LOSS``), the batched step's and eval batch's ms beside
              ten times the per-fold ones, the host ms of the folds' draws, the
              batched step's peak memory, the device's busy share in a traced
              batched step and in a traced per-fold step
  m2ae        the Point-M2AE family at ``config_Point_M2AE.yaml``'s full width (B 128 x
              2,048 points, 512 / 256 / 64 groups): FPS and KNN at every shape of the
              hierarchy and its k = 1 maps on the step's inputs, index-equal to their
              plain versions (KNN distances within rtol 1e-6), each with its CUDA-graph
              time, ``cdist`` + ``topk`` and its bound; the bare ``m2ae_gm3d`` and
              ``m2ae`` steps (launches FPS 3 / KNN 8 and 3 / 6; ms, clouds per second
              and peak memory, fp32, and ``m2ae_gm3d`` in bf16; one step with the fused
              attention, 2 forwards and 1 backward); one ``m2ae_gm3d`` step at B 4 on
              the card and on the CPU from the same weights and draws (stochastic
              depth 0), metrics within ``TOL_M2AE_STEP``; the pretrain CLI
              ``--model_family m2ae_gm3d`` for one epoch of 4 steps with its SVM
              probe (records, launches, ``ckpt/best``);
              then the classifier (``finetune_modelnet_PointM2AE.yaml``) finetuned
              from that checkpoint for one epoch on phase ``finetune``'s ModelNet
              directory (hpm, more than 100 keys transferred, launches FPS 4 / KNN 3 a
              step or an eval batch), ``ckpt/best`` exported and served in a process of
              its own, its logits within ``TOL_SERVE`` of the eval step's, and the
              classifier's bare step at B 40 (FPS 8,192 -> 1,200 and the hierarchy of
              its subsampled 1,024-point clouds, 1,024 -> 512 ..., on the step's own
              inputs and draws, held against the plain versions as above); the seg
              model (``seg_shapenetpart_PointM2AE.yaml``, B 16): its hierarchy and the
              k = 3 propagation of all 2,048 points onto 512, 256 and 64 centers held
              against the plain versions, then a train step and an eval batch,
              launches FPS 3 / KNN 6, ms

  evaluate    offline evaluation, visualisation and int8 on the checkpoints of the
              phases ``finetune``, ``segmentation`` and ``m2ae`` and the GM3D pretrain
              one (each made by one short CLI epoch where its phase did not run):
              ``cli/evaluate.py --probe acc --vote --vote_repeats 2`` (accuracy equal
              to the finetune CLI's record of ``ckpt/best``, the vote finite and at
              least each repeat, FPS 2 / KNN 1 a batch); ``--probe svm``, ``knn``,
              ``linprob`` on the GM3D checkpoint (kNN equal on the card and the CPU
              over the same features, the linear probe within one test cloud; wall
              times); ``--svm_scales both`` on the M2AE checkpoint; ``--probe seg``
              (mIoU equal to the seg CLI's record); ``cli/visualize.py --heatmap`` on
              4 clouds (files, vertex counts, launches) and both dumps on the card
              against the CPU within ``TOL_VIS``; ``ckpt/best`` exported with
              ``--quantize int8`` (and fp32, bf16) and served: the int8 product's
              int32 accumulations equal to the CPU's at every (K, N) of the
              classifier, padded or not, logits within ``QUANT_LOGIT_TOL`` of the
              fp32 artifact's range, FPS and KNN once a batch; top-1 agreement,
              sizes, clouds/s of the three; four GM3D steps with ``quantize_ema``
              (launches 1/1/2/72/28 a step, finite, ``'ema'`` refused), its ms a step
              beside the default step's, the int8 EMA pass's predicted-loss gap
  clip        the GM3D step with ``distill_mode='clip'`` at full width (B 256,
              1,024 points, 64 x 32 groups, 384 wide) and the CLI's default CLIP
              tower (random weights from seed 2): a few steps, each kernel's
              launches in one step (the same every step; the patch embed once,
              the EMA pass's), ms a step and peak memory beside the default
              ``dino`` step's from the same run, the CLIP target pass's share of
              the step (CUDA events at the step's marks); at B 8 the card's step
              against the port's on the CPU from the same weights and draws
              (metrics within ``TOL_STEP``, masks agreeing); the depth renders and
              the centers' patches EQUAL to the CPU's; then the pretrain CLI
              for one epoch of four steps with ``--learn_feature_loss clip
              --clip_path`` on a fabricated CLIP state dict (records, launches)
  emd         ``emd_auction_assignment``'s owners on the card EQUAL to the CPU's on
              grid clouds (exact costs) with duplicated points (ties), ``emd_loss``
              and its gradient within ``EMD_LOSS_TOL`` / ``EMD_GRAD_TOL``; the
              Point-MAE step with ``loss: emd`` at full width (``config.yaml``'s
              model, B 256, mask 0.6) beside the ``cdl2`` step: ms, peak memory,
              launches (FPS and KNN only)
  ddp         data parallelism (``parallel/``): the full-width GM3D step (B 256
              x 1,024, 384 wide, 12-layer encoder, fp32) through the
              data-parallel path at world size 1 over NCCL in this process, then
              two ranks on this one card over gloo (``torchrun
              --nproc_per_node 2 -m gm3d_tpu_torch.scripts.ddp_step --device
              cuda:0``, B 128 each), each against the plain step of B 256 on the
              same weights, clouds and draws: losses within ``DDP_TOL``, the
              ranks' metrics equal, each rank's kernel launches a step the plain
              step's; wall ms a step of each set-up beside the plain step's (the
              two ranks share one card: no scaling figure)
  native_loader  the GM3D pretrain CLI for one epoch of four steps over a
              ShapeNet-55-layout directory of ``.npy`` clouds from ``--seed``
              (``scripts/make_disk_datasets.py``), with the Python loader and
              with ``--native_loader`` (the C++ loader built by ``g++`` here):
              records, the five kernels' launches, the epoch's clouds/s of each
              and each loader's alone over the same files
  tracing     the span recorder (``utils/profiling.py``): 12 full-width GM3D
              steps under ``torch.profiler``, each port span's start and end
              against the profiler's own range of the same name (median and
              worst offset, ns), the host us of a span off and under the
              profiler and of a stage's CUDA event, the stage times, and a
              ``start_trace`` trace holding its window and a second thread's span

The pretrain CLI probes after each epoch (``--val_freq`` 1) in the phases
``pretrain_cli``, ``teacher`` and ``resume`` too; their launch counts include
the probe's.

Any failure raises, so the exit code is non-zero and no result line is
printed. The last line is ``{"ok": true, "device": {...}}``.

``--phases env,build,train`` (development only) runs some of the list and
prints no result line. ``--seed`` (default 0) draws the phase ``probe``'s
features, the phase ``finetune``'s clouds, the phases ``segmentation``'s,
``fewshot``'s and ``m2ae``'s clouds and weights.
"""

from __future__ import annotations

import argparse
import contextlib
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
from gm3d_tpu_torch.ops.fps import _fps_cuda, fps_gather, fps_indices, fps_indices_torch  # noqa: E402
from gm3d_tpu_torch.ops.knn import (_knn_cuda, knn_indices, knn_indices_torch,  # noqa: E402
                                    knn_overflow_count, knn_select_emulated)
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
from gm3d_tpu_torch.utils.profiling import (TRACE_WINDOW, clear,  # noqa: E402
                                            device_busy_share, device_idle_gaps, recording,
                                            span, spans, stage_ms, start_trace, stop_trace)

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


def per_call_us(fn, calls: int = 200) -> float:
    """Wall time of one ``fn()`` in microseconds over ``calls`` back-to-back
    calls and one synchronisation: the host's time where it is the longer."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


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
    # the host time of a wrapper call through the custom op's dispatcher
    # against the op's CUDA implementation called directly (a call's wall time
    # over 200 back-to-back calls: longer than the kernels, so the host's)
    dispatch = {
        "fps": {"wrapper_us": per_call_us(lambda: fps_indices(pts, g)),
                "cuda_impl_us": per_call_us(lambda: _fps_cuda(pts, g))},
        "knn": {"wrapper_us": per_call_us(lambda: knn_indices(pts, centers, k)),
                "cuda_impl_us": per_call_us(lambda: _knn_cuda(pts, centers, k))}}
    for d in dispatch.values():
        d["dispatch_us"] = d["wrapper_us"] - d["cuda_impl_us"]
    timed = [
        {"name": "fps", "route": "cuda", "source": "gm3d_tpu_torch/csrc/fps.cu",
         "replaces": "gm3d_tpu/ops/fps.py:170", "also_replaces": "gm3d_tpu/ops/fps.py:97",
         "op": "gm3d::fps", "shape": [b, n, g],
         "max_abs_err": fps_err, "ms": fps_ms, "plain_ms": fps_plain,
         "bound_ms": fps_bound, "bound_by": fps_by, "library_ms": None,
         "graph_ms": fps_graph_ms, "host": dispatch["fps"]},
        {"name": "knn", "route": "cuda", "source": "gm3d_tpu_torch/csrc/knn.cu",
         "replaces": "gm3d_tpu/ops/knn.py:76", "op": "gm3d::knn", "shape": [b, n, g, k],
         "max_abs_err": knn_err, "ms": knn_ms, "plain_ms": knn_plain,
         "bound_ms": knn_bound, "bound_by": knn_by, "library_ms": knn_lib,
         "graph_ms": knn_graph_ms, "library_graph_ms": knn_lib_graph,
         "host": dispatch["knn"]},
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
    # one artifact for both devices: the card serves it through the kernels,
    # the CPU through the plain versions, and the two must agree
    art = _export(os.path.join(tmp, "cls_fp32.gm3dx"), "--platforms", "cpu,cuda",
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
        check(info["model"] == "PointTransformer" and info["platforms"] == ["cpu", "cuda"], info)
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
    arts = {}  # the B 128 artifacts of _program_checks, by dtype
    # exported for the card only: the CPU is refused
    try:
        ServingModel(art32, device="cpu")
    except ValueError as e:
        check("re-export with --platforms cpu" in str(e), e)
    else:
        raise AssertionError("a cuda-only artifact was served on the CPU")

    res = {"phase": "serve", "requests": 2 + 1 + 1 + len(singles) + 1,
           "clouds": 1 + 300 + len(singles), "launches": launches,
           "device_calls_for_64_concurrent": coalesced_calls,
           "max_abs_err_vs_cpu": err, "artifact_platforms": info["platforms"],
           "cuda_only_refused_on_cpu": True, "bf16_argmax_agreement": same,
           **_program_checks(tmp, art, art32, arts)}
    emit(res)
    return {"launches": launches, "artifact": art, "artifact_bf16": arts["bf16"]}


def host_ms(fn, runs: int = 20) -> float:
    """Median host time of one ``fn()`` in ms, the card idle at its start:
    the time until the call returns, its work enqueued and not waited for."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _eager_classifier(manifest: dict):
    """The eager forward the artifact was traced from, rebuilt from its
    manifest (the export CLI's seed-0 weights, the int8 layout for an int8
    artifact), in this script only."""
    from gm3d_tpu_torch.config import build_model_from_cfg
    from gm3d_tpu_torch.serve.export import build_classifier_fn
    from gm3d_tpu_torch.serve.quantize import quantize_module, quantized_dense
    from gm3d_tpu_torch.utils.device import dtype_from_name

    model = build_model_from_cfg(manifest["model_cfg"],
                                 dtype=dtype_from_name(manifest["compute_dtype"]))
    model.reset_parameters(torch.Generator().manual_seed(0))
    int8 = manifest["quantization"] == "int8"
    if int8:
        quantize_module(model)
    fn = build_classifier_fn(model.to(DEV).eval(), manifest["npoints"])

    def call(x):
        with torch.inference_mode(), (quantized_dense() if int8 else contextlib.nullcontext()):
            return fn(x)

    return call


def _program_checks(tmp: str, art: str, art_8192: str, arts: dict) -> dict:
    """The FPS and KNN kernels run inside the loaded program (the counts rise
    across one call by a served batch's launches); the program's forward
    against the eager module it was traced from at B 128 in fp32, bf16 and
    int8 (equal outputs; CUDA-event ms, median of 20, in the order eager,
    program, program, eager, the program as ``ServingModel.device_call`` calls
    it; host ms of a call through ``program.module()``, of the program's graph
    called directly (``device_call``) and of the eager forward). ``arts``
    gets the B 128 artifact of each dtype."""
    rng = np.random.default_rng(3)
    out = {"program_launches_one_call": {}}
    for name, path, batch, n, want in (("1024_points", art, SERVE_BATCH, NPOINTS, (1, 1)),
                                       ("8192_points", art_8192, 32, 8192, (2, 1))):
        served = ServingModel(path, device="cuda")
        x = torch.from_numpy(rng.standard_normal((batch, n, 3)).astype(np.float32)).to(DEV)
        served.device_call(x)
        torch.cuda.synchronize()
        fps_indices.launches = knn_indices.launches = 0
        served.device_call(x)
        torch.cuda.synchronize()
        got = (fps_indices.launches, knn_indices.launches)
        check(got == want, f"{name}: launches {got} in one call of the program, expected {want}")
        out["program_launches_one_call"][name] = {"fps": got[0], "knn": got[1]}
    x = torch.from_numpy(rng.standard_normal((SERVE_BATCH, NPOINTS, 3)).astype(np.float32)).to(DEV)
    timing = {}
    for dtype, extra in (("fp32", None), ("bf16", "--bf16"), ("int8", "--quantize int8")):
        path = arts[dtype] = art if extra is None else _export(
            os.path.join(tmp, f"cls_{dtype}_b128.gm3dx"), *extra.split(),
            "--export_batch", str(SERVE_BATCH), "--input_points", str(NPOINTS))
        served = ServingModel(path, device="cuda")
        # device_call: the program's graph called directly; module(): with its guards
        program, module = served.device_call, served.program.module()
        eager = _eager_classifier(served.manifest)
        with torch.inference_mode():
            a, b, c = program(x), module(x), eager(x)
            gap = float((a - c).abs().max())
            gap_direct = float((a - b).abs().max())
            check(gap_direct <= 1e-5, f"{dtype}: the lifted graph differs from the module "
                  f"by {gap_direct}")
            check(gap <= 2e-3, f"{dtype}: the program differs from its eager module by {gap}")
            eager_1, program_1 = cuda_ms(lambda: eager(x)), cuda_ms(lambda: program(x))
            program_2, eager_2 = cuda_ms(lambda: program(x)), cuda_ms(lambda: eager(x))
            hosts = {"program_module": host_ms(lambda: module(x)),
                     "program_direct": host_ms(lambda: program(x)),
                     "eager": host_ms(lambda: eager(x))}
        timing[dtype] = {"program_ms": [program_1, program_2], "eager_ms": [eager_1, eager_2],
                         "host_ms": hosts, "program_vs_eager_max_abs": gap,
                         "direct_vs_module_max_abs": gap_direct,
                         "graph_nodes": len(served.program.graph.nodes)}
    return {**out, "program_vs_eager_b128": timing}


def phase_throughput(art32: str, art16: str) -> None:
    rng = np.random.default_rng(2)
    batch = rng.standard_normal((SERVE_BATCH, NPOINTS, 3)).astype(np.float32)
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


def _serve_process(art: str, log_path: str, requests):
    """``python -m gm3d_tpu_torch.cli.serve`` in a process of its own: wait for
    /health, call ``requests(base_url)``, stop the server with SIGTERM (it must
    exit 0). Returns what ``requests`` returns."""
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
        answer = requests(base)
        proc.send_signal(signal.SIGTERM)
        check(proc.wait(timeout=60) == 0, "the server did not stop cleanly on SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return answer


def _serve_cli(art: str, clouds: np.ndarray, log_path: str) -> np.ndarray:
    """POST the clouds to the served classifier (one JSON request of one
    cloud, then the rest as one .npy request). Returns the served logits."""

    def requests(base):
        status, one = _http(base + "/predict",
                            json.dumps({"points": clouds[0].tolist()}).encode())
        check(status == 200, status)
        buf = io.BytesIO()
        np.save(buf, clouds[1:])
        status, rest = _http(base + "/predict", buf.getvalue(), "application/octet-stream")
        check(status == 200, status)
        return np.concatenate([np.asarray(one["outputs"], np.float32)[None],
                               np.asarray(rest["outputs"], np.float32)])

    return _serve_process(art, log_path, requests)


def _finetune_model(dtype=torch.float32):
    from gm3d_tpu_torch.config import build_model_from_cfg, cfg_from_yaml_file

    model = build_model_from_cfg(cfg_from_yaml_file(FT_CONFIG)["model"], dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to(DEV)


def _step_ms(step, runs: int = 5, warmup: int = 2) -> tuple[float, float, list]:
    """(median CUDA-event ms, median wall ms, the losses) of ``runs`` calls of
    ``step()`` (which returns the step's metrics) after ``warmup``; every
    loss must be finite."""
    event_ms, wall_ms, losses = [], [], []
    for _ in range(runs + warmup):
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        begin.record()
        m = step()
        end.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(begin.elapsed_time(end))
        losses.append(float(m["loss"]))
    check(all(np.isfinite(losses)), losses)
    return statistics.median(event_ms[warmup:]), statistics.median(wall_ms[warmup:]), losses


def _gm3d_pretrain_ckpt(tmp: str, samples: int, batch: int) -> str:
    """One short epoch of the port's GM3D pretrain CLI; its checkpoint root."""
    pre_out = os.path.join(tmp, "pretrain")
    _fresh_cli_logger()
    pretrain_cli.main(["--config", GM3D_CONFIG, "--synthetic", "--synthetic_samples",
                       str(samples), "--batch_size", str(batch), "--epochs", "1",
                       "--output_dir", pre_out])
    return os.path.join(pre_out, "ckpt")


def _transferred_keys(log_path: str) -> int:
    """The count on a CLI log's pretrain->finetune transfer line, which must
    be more than 100 tensors."""
    with open(log_path) as f:
        moved = re.search(r"pretrain->finetune transfer: (\d+) leaves overlaid", f.read())
    check(moved is not None and int(moved.group(1)) > 100,
          f"{log_path}: the transfer log line reports {moved and moved.group(1)} keys")
    return int(moved.group(1))


def _finetune_cli(config: str, pretrained: str, out: str, *flags: str) -> tuple[list, dict, int]:
    """The finetune CLI from the checkpoint root ``pretrained`` into ``out``,
    every launch count from 0: (its records, its launches, the tensors it
    transferred)."""
    from gm3d_tpu_torch.cli import finetune as finetune_cli

    _fresh_cli_logger("gm3d.finetune")
    pp.reset_launches()  # the finetune CLI's path: every launch count starts from 0 here
    records = finetune_cli.main(["--config", config, *flags, "--pretrained", pretrained,
                                 "--output_dir", out])
    launches = pp.read_launches()
    log = _read_log(out)
    check(log == records, "log.txt differs from the records main() returned")
    return log, launches, _transferred_keys(os.path.join(out, "finetune.log"))


def _served_vs_eval_step(config: str, best: str, model, clouds: np.ndarray, tmp: str,
                         name: str, export_batch: int) -> float:
    """``best`` exported with FT_POINTS-point inputs and served in a process of
    its own; the largest gap between the served logits of ``clouds`` and the
    eval step's of ``model`` holding the same checkpoint (at most TOL_SERVE)."""
    from gm3d_tpu_torch.train import finetune as ft

    art = export_model.main(["--config", config, "--ckpt", best, "--input_points",
                             str(FT_POINTS), "--export_batch", str(export_batch),
                             "--out", os.path.join(tmp, f"{name}.gm3dx"), "--device", "cuda"])
    served = _serve_cli(art, clouds, os.path.join(tmp, f"{name}_serve.log"))
    model.load_state_dict(restore_raw(best)["model"], strict=True)
    want = ft.make_eval_step(model.to(DEV), FT_NPOINTS)(torch.from_numpy(clouds))
    return _agree(served, want.cpu().numpy(), atol=TOL_SERVE)


def phase_finetune(env: dict, tmp: str, pretrained: str, seed: int) -> dict:
    """Pretrain -> finetune -> export -> serve inside the port on the card;
    ``pretrained`` is a GM3D pretrain checkpoint root (``_gm3d_pretrain_ckpt``)."""
    from gm3d_tpu_torch.cli import finetune as finetune_cli
    from gm3d_tpu_torch.train import finetune as ft
    from gm3d_tpu_torch.train.optim import build_finetune_optimizer
    from gm3d_tpu_torch.train.state import create_train_state

    res = {"phase": "finetune", "batch": FT_BATCH, "points": FT_POINTS}
    config = _finetune_config(tmp, _modelnet_dir(os.path.join(tmp, "modelnet40"), seed))

    # ---- the finetune CLI, both recipes, from that checkpoint
    runs, launches_all = {}, {k: 0 for k in FT_LAUNCHES_PER_STEP}
    steps = FT_EPOCHS * (FT_TRAIN // FT_BATCH)
    val_batches = -(-FT_TEST // FT_BATCH)
    for recipe in ("legacy", "hpm"):
        out = os.path.join(tmp, f"finetune_{recipe}")
        log, launches, keys = _finetune_cli(config, pretrained, out, "--epochs", str(FT_EPOCHS),
                                            "--recipe", recipe, "--vote")
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
            "records": log, "launches": launches, "keys_transferred": keys,
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
        name = "fp32" if dtype == torch.float32 else "bf16"
        ms, wall, losses = _step_ms(lambda: step(state, pts, labels, gen)[1])
        timing[name] = {"step_ms_cuda_events": ms, "step_ms_wall": wall,
                        "clouds_per_s": FT_BATCH / wall * 1e3, "losses": losses}
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
    res["served_vs_eval_step_max_abs_err"] = _served_vs_eval_step(
        config, best, _finetune_model(), data[:6], tmp, "finetuned", FT_BATCH)
    res["served_ckpt_step"] = latest_step(best)
    res["tol_serve"] = TOL_SERVE
    res["gpu"] = env["gpu"]
    emit(res)
    return {"launches": launches_all}


# the segmentation path: configs/pointmae/seg_shapenetpart.yaml at full width (384
# wide, 12 blocks, taps after blocks 3, 7 and 11, 128 groups of 32), B 16 clouds
# of 2,048 points, 50 parts of 16 categories
SEG_CONFIG = os.path.join(ROOT, "configs", "pointmae", "seg_shapenetpart.yaml")
SEG_BATCH, SEG_POINTS, SEG_GROUPS, SEG_EPOCHS, SEG_SAMPLES = 16, 2048, 128, 2, 64
# launches the JAX seg code implies: one grouping (FPS 2048 -> 128, KNN k 32)
# and the feature propagation's KNN (k 3, every point on the 128 centers) a
# train step or an eval batch; no FPS to point_all (the input is the model's
# point count), no fused attention or patch embed
# (gm3d_tpu/train/segmentation.py:71-73)
SEG_LAUNCHES_PER_STEP = {"fps": 1, "knn": 2, "patch_embed": 0, "attention_fwd": 0,
                         "attention_bwd": 0}
SEG_RECORD_KEYS = {"loss", "acc", "epoch", "time", "instance_miou", "class_miou"}
# the few-shot path: configs/pointmae/fewshot.yaml at full width (PointTransformer,
# 384 wide, 12 blocks, 64 groups of 32, 1,024 points, B 32), 5-way 10-shot, the published
# ten folds, trained together (the default --parallel_folds) and one after another; and
# configs/m2ae/fewshot-Point-M2AE.yaml (PointM2AEClassifier, B 40) the same way
FS_CONFIG = os.path.join(ROOT, "configs", "pointmae", "fewshot.yaml")
FS_M2AE_CONFIG = os.path.join(ROOT, "configs", "m2ae", "fewshot-Point-M2AE.yaml")
FS_WAY, FS_SHOT, FS_FOLDS, FS_EPOCHS, FS_BATCH, FS_M2AE_BATCH = 5, 10, 10, 2, 32, 40
# the 1,024-point clouds are never larger than point_all: one grouping a step
# or an eval batch (gm3d_tpu/train/finetune.py:75-76, :154); trained together, one
# launch a batched step or eval batch for every fold (the ops' vmap rules)
FS_LAUNCHES_PER_STEP = {"fps": 1, "knn": 1, "patch_embed": 0, "attention_fwd": 0,
                        "attention_bwd": 0}
# the steps compared, fold for fold, between the batched and the per-fold runs: the CLI's
# first four (one step an epoch at 50 clouds, the warm-up's rates 1e-6, 1e-6, 5.09e-5,
# 1.008e-4); rounding grows chaotically with the rate: a fifth step at 1.507e-4 left the
# M2AE folds up to 1.23e-3 apart (NVIDIA H100 80GB HBM3, 700.00 W)
FS_STEPS, TOL_FS_LOSS = 4, 2e-3

def _seg_serve_cli(art: str, clouds: np.ndarray, cls: np.ndarray, log_path: str) -> dict:
    """POST to the served segmentation artifact: one JSON request with the
    clouds, their categories and ``return_logits``, one without a category
    (refused with 400). Returns the first answer."""

    def requests(base):
        body = {"points": clouds.tolist(), "cls_label": cls.tolist(), "return_logits": True}
        status, answer = _http(base + "/predict", json.dumps(body).encode())
        check(status == 200, status)
        try:
            _http(base + "/predict", json.dumps({"points": clouds.tolist()}).encode())
        except urllib.error.HTTPError as e:
            check(e.code == 400, f"a request without cls_label answered {e.code}")
        else:
            raise AssertionError("a request without cls_label was served")
        return answer

    return _serve_process(art, log_path, requests)


def phase_segmentation(env: dict, tmp: str, pretrained: str, seed: int) -> dict:
    """Pretrain -> part segmentation -> export -> serve inside the port."""
    from gm3d_tpu_torch.cli import finetune_seg as seg_cli
    from gm3d_tpu_torch.config import build_model_from_cfg, cfg_from_yaml_file
    from gm3d_tpu_torch.data.datasets import SEG_CLASSES
    from gm3d_tpu_torch.models.segmentation import propagate_features
    from gm3d_tpu_torch.train import segmentation as seg
    from gm3d_tpu_torch.train.optim import build_finetune_optimizer
    from gm3d_tpu_torch.train.state import create_train_state

    res = {"phase": "segmentation", "batch": SEG_BATCH, "points": SEG_POINTS}
    cls_names = sorted(SEG_CLASSES)
    data = seg_cli.SyntheticParts(SEG_BATCH, SEG_POINTS, seed=seed + 7)
    items = [data[i][2] for i in range(SEG_BATCH)]
    pts = torch.from_numpy(np.stack([p for p, _, _ in items])).to(DEV)
    cls = torch.tensor([c for _, c, _ in items], device=DEV)
    target = torch.from_numpy(np.stack([t for _, _, t in items])).to(DEV)

    # ---- (a) the step's kernels at its shapes against their plain versions:
    # FPS 2,048 -> 128 centers, the grouping's KNN (k 32 of 2,048 points
    # around each center) and the propagation's
    center_idx = fps_indices(pts, SEG_GROUPS)
    want_idx = fps_indices_torch(pts, SEG_GROUPS)
    torch.cuda.synchronize()
    check(torch.equal(center_idx.long(), want_idx.long()) and center_idx.dtype == torch.int32,
          f"fps at the seg shape differs from its plain version at "
          f"{int((center_idx.long() != want_idx.long()).sum())} of {center_idx.numel()} indices")
    centers = fps_gather(pts, center_idx)
    model_cfg = cfg_from_yaml_file(SEG_CONFIG)["model"]
    group_size = model_cfg["group_size"]
    grouped = knn_indices(pts, centers, group_size)
    gd, gi = knn_indices(pts, centers, group_size, return_dist=True)
    wd, wi = knn_indices_torch(pts, centers, group_size, return_dist=True)
    torch.cuda.synchronize()
    check(torch.equal(grouped.long(), wi.long()) and torch.equal(gi, wi),
          f"knn at the grouping's shape differs from its plain version at "
          f"{int((grouped.long() != wi.long()).sum())} of {wi.numel()} indices")
    torch.testing.assert_close(gd, wd, rtol=1e-6, atol=0.0)
    res["fps_grouping"] = {"shape": [SEG_BATCH, SEG_POINTS, SEG_GROUPS], "indices_equal": True,
                           "ms": cuda_ms(lambda: fps_indices(pts, SEG_GROUPS))}
    res["knn_grouping"] = {"shape": [SEG_BATCH, SEG_POINTS, SEG_GROUPS, group_size],
                           "indices_equal": True,
                           "dist_max_abs_err": float((gd - wd).abs().max()),
                           "dist_tol": {"rtol": 1e-6, "atol": 0.0},
                           "ms": cuda_ms(lambda: knn_indices(pts, centers, group_size))}
    # the propagation: every point on the 128 centers, k 3, with distances
    # (centers are points of the cloud)
    gd, gi = knn_indices(centers, pts, 3, return_dist=True)
    wd, wi = knn_indices_torch(centers, pts, 3, return_dist=True)
    torch.cuda.synchronize()
    check(torch.equal(gi, wi), f"knn at the propagation's shape differs from its plain "
                               f"version at {int((gi != wi).sum())} of {gi.numel()} indices")
    torch.testing.assert_close(gd, wd, rtol=1e-6, atol=0.0)
    on_center = torch.zeros(SEG_BATCH, SEG_POINTS, dtype=torch.bool, device=DEV)
    on_center.scatter_(1, center_idx.long(), True)
    feats = torch.randn(SEG_BATCH, SEG_GROUPS, 3 * 384, device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(seed))
    prop = propagate_features(pts, centers, feats)  # through the kernel
    prop_plain = propagate_features(pts.cpu(), centers.cpu(), feats.cpu()).to(DEV)
    gap = (prop - prop_plain).abs().amax(dim=-1)
    knn_launch = {"shape": [SEG_BATCH, SEG_GROUPS, SEG_POINTS, 3],
                  "indices_equal": True,
                  "dist_max_abs_err": float((gd - wd).abs().max()),
                  "dist_tol": {"rtol": 1e-6, "atol": 0.0},
                  "self_distance_max_abs": float(gd[..., 0][on_center].abs().max()),
                  "propagated_gap_at_centers": float(gap[on_center].max()),
                  "propagated_gap_elsewhere": float(gap[~on_center].max()),
                  "graph_ms": graph_ms(lambda: knn_indices(centers, pts, 3, return_dist=True)),
                  "ms": cuda_ms(lambda: knn_indices(centers, pts, 3, return_dist=True)),
                  "plain_ms": cuda_ms(lambda: knn_indices_torch(centers, pts, 3,
                                                                return_dist=True),
                                      runs=10, warmup=1)}
    check(knn_launch["propagated_gap_at_centers"] <= 1e-5
          and knn_launch["propagated_gap_elsewhere"] <= 1e-5, knn_launch)

    def knn_library():
        return torch.topk(torch.cdist(pts, centers), 3, dim=-1, largest=False, sorted=True)

    knn_launch["library_ms"] = cuda_ms(knn_library)
    knn_launch["library_graph_ms"] = graph_ms(knn_library)
    b, n, g, k = SEG_BATCH, SEG_GROUPS, SEG_POINTS, 3
    knn_launch["bound_ms"], knn_launch["bound_by"] = bound(
        b * n * 12 + b * g * 12 + b * g * k * 8, 9.0 * b * g * n + 5.0 * b * n)
    res["knn_propagation"] = knn_launch

    # ---- (b) the bare step and an eval batch: launches, ms, clouds per second
    def seg_model(dtype=torch.float32, state=None):
        model = build_model_from_cfg(model_cfg, dtype=dtype)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        if state is not None:
            model.load_state_dict(state, strict=True)
        return model.to(DEV)

    per, timing = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "fp32" if dtype == torch.float32 else "bf16"
        model = seg_model(dtype)
        optimizer = build_finetune_optimizer(model.named_parameters(), 1e-4, layer_decay=None,
                                             grad_clip=10.0)
        state = create_train_state(model, optimizer)
        step = seg.make_seg_train_step(model, optimizer)
        eval_step = seg.make_seg_eval_step(model)
        gen = torch.Generator(device=DEV).manual_seed(seed)
        if dtype == torch.float32:
            for what, fn in (("train_step", lambda: step(state, pts, cls, target, gen)),
                             ("eval_batch", lambda: eval_step(pts, cls))):
                pp.reset_launches()
                fn()
                torch.cuda.synchronize()
                per[what] = pp.read_launches()
                check(per[what] == SEG_LAUNCHES_PER_STEP,
                      f"{what} launches {per[what]}, expected {SEG_LAUNCHES_PER_STEP}")
        ms, wall, losses = _step_ms(lambda: step(state, pts, cls, target, gen)[1])
        timing[name] = {"step_ms_cuda_events": ms, "step_ms_wall": wall,
                        "clouds_per_s": SEG_BATCH / wall * 1e3, "losses": losses}
        timing[name]["eval_ms_per_batch"] = cuda_ms(lambda: eval_step(pts, cls), runs=10,
                                                    warmup=2)
    res["launches_per"] = per
    res["timing"] = timing
    del model, optimizer, state

    # ---- (c) the seg CLI from the pretrain checkpoint, 2 epochs
    out = os.path.join(tmp, "seg")
    _fresh_cli_logger("gm3d.seg")
    pp.reset_launches()  # the seg CLI's path: every launch count starts from 0 here
    t0 = time.perf_counter()
    records = seg_cli.main(["--config", SEG_CONFIG, "--synthetic", "--synthetic_samples",
                            str(SEG_SAMPLES), "--epochs", str(SEG_EPOCHS),
                            "--pretrained", pretrained, "--output_dir", out])
    cli_wall = time.perf_counter() - t0
    launches = pp.read_launches()
    log = _read_log(out)
    check(log == records, "log.txt differs from the records main() returned")
    keys = _transferred_keys(os.path.join(out, "seg.log"))
    check([r["epoch"] for r in log] == list(range(SEG_EPOCHS)), log)
    for r in log:
        check(set(r) == SEG_RECORD_KEYS and all(np.isfinite(r[k]) for k in r), r)
    best = os.path.join(out, "ckpt", "best")
    check(latest_step(best) is not None, "no ckpt/best")
    check(load_best_metrics(os.path.join(out, "ckpt"))["instance_miou"] * 100
          == max(r["instance_miou"] for r in log), "best_metrics.json")
    steps = SEG_EPOCHS * (SEG_SAMPLES // SEG_BATCH)
    val_batches = -(-max(SEG_SAMPLES // 4, 32) // SEG_BATCH)
    want = {k: v * (steps + SEG_EPOCHS * val_batches) for k, v in SEG_LAUNCHES_PER_STEP.items()}
    check(launches == want, f"seg CLI launches {launches}, expected {want}")
    res["cli"] = {"records": log, "launches": launches, "keys_transferred": keys,
                  "wall_s": cli_wall,
                  "clouds_per_sec_each_epoch": [(SEG_SAMPLES // SEG_BATCH) * SEG_BATCH
                                                / max(r["time"], 1e-9) for r in log]}

    # ---- (d) ckpt/best exported for segmentation and served in its own process
    art = export_model.main(["--config", SEG_CONFIG, "--ckpt", best, "--mode", "segmentation",
                             "--export_batch", "4", "--out", os.path.join(tmp, "seg.gm3dx"),
                             "--device", "cuda"])
    model = seg_model(state=restore_raw(best)["model"])
    want_logits = seg.make_seg_eval_step(model)(pts[:4], cls[:4]).cpu().numpy()
    want_labels = seg.category_restricted_argmax(want_logits, cls[:4].cpu().numpy(),
                                                 SEG_CLASSES, cls_names)
    answer = _seg_serve_cli(art, pts[:4].cpu().numpy(), cls[:4].cpu().numpy(),
                            os.path.join(tmp, "serve_seg.log"))
    served = np.asarray(answer["outputs"], np.float32)
    err = float(np.abs(served - want_logits).max())
    check(np.isfinite(served).all() and err <= TOL_SERVE,
          f"served seg logits differ from the eval step's by {err} > {TOL_SERVE}")
    check(np.array_equal(np.asarray(answer["label"]), want_labels),
          "served part labels differ from the eval step's category-restricted argmax")
    res["served_vs_eval_step_max_abs_err"] = err
    res["served_labels_equal"] = True
    res["tol_serve"] = TOL_SERVE

    # ---- (e) an artifact of another point count is refused
    try:
        export_model.main(["--config", SEG_CONFIG, "--ckpt", best, "--mode", "segmentation",
                           "--input_points", str(2 * SEG_POINTS), "--device", "cuda",
                           "--out", os.path.join(tmp, "refused.gm3dx")])
    except ValueError as e:
        res["input_points_refused"] = str(e)
    else:
        raise AssertionError("--mode segmentation accepted --input_points != npoints")
    res["gpu"] = env["gpu"]
    emit(res)
    return {"launches": launches, "knn_propagation": knn_launch}


def _fewshot_cli_runs(config: str, tmp: str, name: str, batch: int, epochs: int,
                      per_step: dict, pretrained: str | None) -> dict:
    """The few-shot CLI on ``config`` at FS_FOLDS folds of synthetic episodes,
    its folds trained together (the default) and then one after another,
    every launch count from 0 before each run: the records, launches, wall
    seconds, and each fold's accuracy within one test cloud across the two."""
    from gm3d_tpu_torch.cli import fewshot as fewshot_cli

    test_batches = -(-FS_WAY * 20 // batch)
    # an epoch: one step (50 clouds, the last partial batch dropped) and the
    # test batches of its 100 clouds; trained together, once for all folds
    per_fold = epochs * (FS_WAY * FS_SHOT // batch + test_batches)
    runs = {}
    for mode, extra, folds_launched in (("batched", [], 1),
                                        ("sequential", ["--no-parallel_folds"], FS_FOLDS)):
        out = os.path.join(tmp, f"{name}_{mode}")
        flags = ["--config", config, "--synthetic", "--way", str(FS_WAY), "--shot", str(FS_SHOT),
                 "--folds", str(FS_FOLDS), "--epochs", str(epochs), "--output_dir", out, *extra]
        if pretrained:
            flags += ["--pretrained", pretrained]
        _fresh_cli_logger("gm3d.fewshot")
        pp.reset_launches()  # the few-shot CLI's path: every launch count starts from 0 here
        t0 = time.perf_counter()
        records = fewshot_cli.main(flags)
        wall = time.perf_counter() - t0
        launches = pp.read_launches()
        log = _read_log(out)
        check(log == records and len(log) == 1, log)
        rec = log[0]
        check(len(rec["accs"]) == FS_FOLDS and all(0.0 <= a <= 100.0 for a in rec["accs"]), rec)
        check(rec["mean"] == float(np.mean(rec["accs"]))
              and rec["std"] == float(np.std(rec["accs"])), rec)
        want = {k: v * per_fold * folds_launched for k, v in per_step.items()}
        check(launches == want, f"few-shot {name} {mode} launches {launches}, expected {want}")
        runs[mode] = {"record": rec, "launches": launches, "wall_s": wall,
                      "seconds_per_fold": wall / FS_FOLDS}
        if pretrained:
            runs[mode]["keys_transferred"] = _transferred_keys(os.path.join(out, "fewshot.log"))
    one_cloud = 100.0 / (FS_WAY * 20)
    gaps = [abs(a - b) for a, b in zip(runs["batched"]["record"]["accs"],
                                       runs["sequential"]["record"]["accs"])]
    check(max(gaps) <= one_cloud + 1e-9, f"few-shot {name} accuracies apart: {gaps}")
    runs["acc_gap_max"], runs["one_test_cloud"] = max(gaps), one_cloud
    runs["batched_over_sequential_wall"] = runs["batched"]["wall_s"] / runs["sequential"]["wall_s"]
    return runs


def _busy_share(fn, tmp: str, name: str, calls: int = 2) -> float:
    """The device's busy share over ``calls`` calls of ``fn``, from a trace."""
    prof_dir = os.path.join(tmp, name)
    prof = start_trace(prof_dir)
    for _ in range(calls):
        fn()
    return device_busy_share(stop_trace(prof, prof_dir))


def _fewshot_steps(config: str, batch: int, seed: int, per_step: dict, tmp: str) -> dict:
    """The fold-batched train step at FS_FOLDS folds of ``batch`` clouds
    against each fold's own step, full width, from the same weights and
    generators, at the CLI's scheduled rates: per-fold losses over FS_STEPS
    steps within TOL_FS_LOSS;
    launches of one batched step and eval batch; ms of the batched step,
    its eval batch, its draws on the host, and its peak memory, beside
    FS_FOLDS times the per-fold step's and eval's; the device's busy share
    in two batched steps and in two per-fold steps, from traces."""
    from gm3d_tpu_torch.config import build_model_from_cfg, cfg_from_yaml_file
    from gm3d_tpu_torch.data.datasets import SyntheticClouds
    from gm3d_tpu_torch.train import finetune as ft
    from gm3d_tpu_torch.train.optim import build_legacy_adamw, set_scheduled_lr
    from gm3d_tpu_torch.train.state import create_train_state

    cfg = cfg_from_yaml_file(config)
    smoothing, clip = cfg["model"].get("smooth", 0.0), cfg.get("grad_norm_clip")
    lr, wd = cfg["optimizer"]["kwargs"]["lr"], cfg["optimizer"]["kwargs"]["weight_decay"]
    sched = legacy_cosine_epoch_schedule(lr, cfg["scheduler"]["kwargs"]["epochs"],
                                         cfg["scheduler"]["kwargs"]["initial_epochs"], 1)

    def fold_model(fold):
        model = build_model_from_cfg({**cfg["model"], "cls_dim": FS_WAY})
        model.reset_parameters(torch.Generator().manual_seed(seed + fold))
        return model

    clouds, classes = [], []
    for fold in range(FS_FOLDS):
        data = SyntheticClouds(batch, 1024, num_classes=FS_WAY, seed=seed + fold, labelled=True)
        items = [data[i][2] for i in range(batch)]
        clouds.append(np.stack([p for p, _ in items]))
        classes.append([lab for _, lab in items])
    pts = torch.from_numpy(np.stack(clouds)).to(DEV)
    labels = torch.tensor(classes, device=DEV)

    models = [fold_model(f) for f in range(FS_FOLDS)]
    folded = ft.FoldedModel(models, DEV)  # copies: each model goes on to its own run
    optimizer = build_legacy_adamw(folded.params.items(), lr, wd, grad_clip=clip, fold_axis=True)
    state = create_train_state(folded, optimizer)
    step = ft.make_fold_batched_train_step(folded, optimizer, 1024, smoothing, device=DEV)
    eval_step = ft.make_fold_batched_eval_step(folded, 1024, device=DEV)
    gens = [torch.Generator(device=DEV).manual_seed(seed + f) for f in range(FS_FOLDS)]
    batched_losses = []
    for k in range(FS_STEPS):
        pp.reset_launches()
        set_scheduled_lr(optimizer, sched(k))
        batched_losses.append(step(state, pts, labels, gens)[1]["loss"].tolist())
        if k == 0:
            torch.cuda.synchronize()
            launches_step = pp.read_launches()
    pp.reset_launches()
    eval_step(pts)
    torch.cuda.synchronize()
    launches_eval = pp.read_launches()
    check(launches_step == per_step and launches_eval == per_step,
          f"a batched step {launches_step}, eval batch {launches_eval}, expected {per_step}")

    losses_alone, gaps = [], []
    for fold in range(FS_FOLDS):
        model = models[fold].to(DEV)
        opt = build_legacy_adamw(model.named_parameters(), lr, wd, grad_clip=clip)
        alone = create_train_state(model, opt)
        one = ft.make_finetune_train_step(model, opt, 1024, smoothing, device=DEV)
        gen = torch.Generator(device=DEV).manual_seed(seed + fold)
        mine = []
        for k in range(FS_STEPS):
            set_scheduled_lr(opt, sched(k))
            mine.append(float(one(alone, pts[fold], labels[fold], gen)[1]["loss"]))
        losses_alone.append(mine)
        gaps += [abs(batched_losses[k][fold] - mine[k]) / abs(mine[k]) for k in range(FS_STEPS)]
        if fold == 0:
            fold_step_ms, fold_step_wall, _ = _step_ms(
                lambda: one(alone, pts[0], labels[0], gen)[1])
            fold_busy = _busy_share(lambda: one(alone, pts[0], labels[0], gen), tmp,
                                    f"fold_trace_{batch}")
            evaluate = ft.make_eval_step(model, 1024, device=DEV)
            fold_eval_ms, fold_eval_wall, _ = _step_ms(lambda: {"loss": evaluate(pts[0]).sum()})
        models[fold] = None
        del model, opt, alone, one
    check(max(gaps) <= TOL_FS_LOSS, f"batched losses {gaps} apart from each fold's own")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, wall, _ = _step_ms(lambda: {"loss": step(state, pts, labels, gens)[1]["loss"].sum()})
    peak = torch.cuda.max_memory_allocated()
    eval_ms, eval_wall, _ = _step_ms(lambda: {"loss": eval_step(pts).sum()})
    batched_busy = _busy_share(lambda: step(state, pts, labels, gens), tmp,
                               f"batched_trace_{batch}")
    draw_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ft._stack([ft.finetune_draws(g, folded.base, batch, 1024, 1024) for g in gens])
        torch.cuda.synchronize()
        draw_ms.append((time.perf_counter() - t0) * 1e3)
    return {"folds": FS_FOLDS, "batch": batch, "losses_batched": batched_losses,
            "losses_each_fold_alone": losses_alone, "loss_rel_gap_max": max(gaps),
            "lr_per_step": [sched(k) for k in range(FS_STEPS)],
            "tol": TOL_FS_LOSS, "launches_per_batched_step": launches_step,
            "launches_per_batched_eval": launches_eval,
            "batched_step_ms_cuda_events": ms, "batched_step_ms_wall": wall,
            "fold_step_ms_cuda_events": fold_step_ms, "fold_step_ms_wall": fold_step_wall,
            "folds_times_fold_step_ms_wall": FS_FOLDS * fold_step_wall,
            "batched_over_folds_times_fold_step": wall / (FS_FOLDS * fold_step_wall),
            "batched_clouds_per_s": FS_FOLDS * batch / wall * 1e3,
            "batched_eval_ms_cuda_events": eval_ms, "batched_eval_ms_wall": eval_wall,
            "fold_eval_ms_wall": fold_eval_wall,
            "folds_times_fold_eval_ms_wall": FS_FOLDS * fold_eval_wall,
            "draws_ms_host_median": statistics.median(draw_ms),
            "device_busy_share_batched_step": batched_busy,
            "device_busy_share_fold_step": fold_busy,
            "peak_bytes_batched_step": peak}


def phase_fewshot(env: dict, tmp: str, pretrained: str, seed: int) -> dict:
    """The few-shot CLI at full width on both families, its folds trained
    together and one after another, and the fold-batched step against each
    fold's own."""
    res = {"phase": "fewshot", "way": FS_WAY, "shot": FS_SHOT, "folds": FS_FOLDS}
    res["pointmae"] = _fewshot_cli_runs(FS_CONFIG, tmp, "fewshot", FS_BATCH, FS_EPOCHS,
                                        FS_LAUNCHES_PER_STEP, pretrained)
    # no Point-M2AE checkpoint in this phase: each fold's weights from its seed
    res["m2ae"] = _fewshot_cli_runs(FS_M2AE_CONFIG, tmp, "fewshot_m2ae", FS_M2AE_BATCH, 1,
                                    M2AE_ENCODER_LAUNCHES, None)
    res["pointmae"]["steps"] = _fewshot_steps(FS_CONFIG, FS_BATCH, seed, FS_LAUNCHES_PER_STEP,
                                              tmp)
    res["m2ae"]["steps"] = _fewshot_steps(FS_M2AE_CONFIG, FS_M2AE_BATCH, seed,
                                          M2AE_ENCODER_LAUNCHES, tmp)
    res["gpu"] = env["gpu"]
    emit(res)
    return {"launches": res["pointmae"]["batched"]["launches"],
            "launches_m2ae": res["m2ae"]["batched"]["launches"]}


# the Point-M2AE family: configs/m2ae/config_Point_M2AE.yaml at full width (3 scales of
# 512 / 256 / 64 groups of 16 / 8 / 8, depths 5 / 5 / 5, widths 96 / 192 / 384, decoder 384 /
# 192), B 128 clouds of 2,048 points, mask ratio 0.8, drop path 0.1
M2AE_CONFIG = os.path.join(ROOT, "configs", "m2ae", "config_Point_M2AE.yaml")
M2AE_FT_CONFIG = os.path.join(ROOT, "configs", "m2ae", "finetune_modelnet_PointM2AE.yaml")
M2AE_BATCH, M2AE_POINTS, M2AE_CPU_BATCH = 128, 2048, 4
# launches the JAX code implies (gm3d_tpu/train/pretrain.py:506-560, 643-748,
# gm3d_tpu/models/m2ae.py): one hierarchy a step (FPS 3, KNN 3) shared by the passes; a
# PointM2AE forward's k = 1 maps to the coarsest scale (KNN 2) and the decoder's last
# upsample (KNN 1); the EMA pass stops at the loss-prediction head, whose outputs are all
# the JAX step keeps of it (KNN 2); no fused patch embed; the fused attention only where
# the step enters it (off by default), at the unmasked coarsest decoder stage (one block,
# L 64: a forward in each pass, a backward in the student's)
M2AE_GM3D_LAUNCHES_PER_STEP = {"fps": 3, "knn": 8, "patch_embed": 0, "attention_fwd": 0,
                               "attention_bwd": 0}
M2AE_LAUNCHES_PER_STEP = {"fps": 3, "knn": 6, "patch_embed": 0, "attention_fwd": 0,
                          "attention_bwd": 0}
M2AE_FUSED_LAUNCHES_PER_STEP = {"fps": 3, "knn": 8, "patch_embed": 0, "attention_fwd": 2,
                                "attention_bwd": 1}
# the unmasked encoder (the SVM probe's pooled features, a classifier forward): the
# hierarchy only; the classifier's train step and eval batch FPS once more (8,192 points
# to point_all 1,200 or npoints 1,024) before it
M2AE_ENCODER_LAUNCHES = {"fps": 3, "knn": 3, "patch_embed": 0, "attention_fwd": 0,
                         "attention_bwd": 0}
M2AE_CLS_LAUNCHES_PER_STEP = {**M2AE_ENCODER_LAUNCHES, "fps": 4}
# the CLI: 4 steps of 128 synthetic clouds, then the SVM probe over 256 + 128 labelled
# clouds of 2,048 points (npoints: no FPS before the encoder) in batches of 256
M2AE_CLI_SAMPLES = 4 * M2AE_BATCH
M2AE_PROBE_BATCHES = sum(-(-max(M2AE_CLI_SAMPLES // d, 64) // (2 * M2AE_BATCH)) for d in (2, 4))
M2AE_RECORD_KEYS = {"loss", "loss_chfr", "loss_learn", "grad_norm", "epoch", "time", "lr",
                    "steps", "clouds_per_sec", "val_svm_acc"}
M2AE_FT_BATCH = 40
M2AE_SEG_CONFIG = os.path.join(ROOT, "configs", "m2ae", "seg_shapenetpart_PointM2AE.yaml")
M2AE_SEG_BATCH = 16
# the seg model: the hierarchy, then a k 3 propagation onto every point a scale
M2AE_SEG_LAUNCHES = {**M2AE_ENCODER_LAUNCHES, "knn": 6}
TOL_M2AE_STEP = 2e-3


def _m2ae_model(config: str, seed: int, dtype=torch.float32, **overrides):
    """The config's model (``overrides`` replacing entries of its ``model``
    section), weights and BatchNorm statistics drawn from ``seed``."""
    from gm3d_tpu_torch.config import build_model_from_cfg, cfg_from_yaml_file

    model = build_model_from_cfg({**cfg_from_yaml_file(config)["model"], **overrides},
                                 dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    pp.randomize_batchnorm_(model, gen)
    return model


def _m2ae_step(model, gm3d: bool, device=DEV, fused: bool = False):
    from gm3d_tpu_torch.train.optim import build_adamw
    from gm3d_tpu_torch.train.pretrain import make_m2ae_gm3d_train_step, make_m2ae_train_step
    from gm3d_tpu_torch.train.state import create_train_state

    optimizer = build_adamw(model.named_parameters(), 1e-4, 0.05,
                            grad_clip=5.0 if gm3d else None)
    state = create_train_state(model, optimizer, with_ema=gm3d)
    if gm3d:
        step = make_m2ae_gm3d_train_step(model, optimizer, 0.8, use_fused_attention=fused,
                                         device=device)
    else:
        step = make_m2ae_train_step(model, optimizer, 0.8, device=device)
    return state, step


def _m2ae_kernel_checks(pts: torch.Tensor, num_groups, group_sizes, label: str = "",
                        maps: bool = True, propagate: bool = False,
                        into: dict | None = None) -> dict:
    """FPS and KNN at every shape of the hierarchy of ``pts``, on a path's own
    inputs, against their plain versions; times at each shape. ``maps``: the
    pretrain model's k = 1 maps too; ``propagate``: the seg model's k = 3
    propagation of every point onto each scale's centers. Rows are appended
    to ``into`` where given, their cases prefixed with ``label``."""
    res = into if into is not None else {"fps": [], "knn": [], "knn_dist_max_abs_err": 0.0}
    fps_rows, knn_rows = res["fps"], res["knn"]

    def knn_row(name, ref, query, k):
        name = label + name
        gd, gi = knn_indices(ref, query, k, return_dist=True)
        wd, wi = knn_indices_torch(ref, query, k, return_dist=True)
        torch.cuda.synchronize()
        check(torch.equal(gi, wi), f"knn {name}: {int((gi != wi).sum())} of {gi.numel()} "
                                   "indices differ from the plain version")
        torch.testing.assert_close(gd, wd, rtol=1e-6, atol=0.0)
        res["knn_dist_max_abs_err"] = max(res["knn_dist_max_abs_err"],
                                          float((gd - wd).abs().max()))
        b, n, g = ref.shape[0], ref.shape[1], query.shape[1]

        def library():
            return torch.topk(torch.cdist(query, ref), k, dim=-1, largest=False, sorted=True)

        ms_bound, by = bound(b * n * 12 + b * g * 12 + b * g * k * 8, 9.0 * b * g * n + 5.0 * b * n)
        knn_rows.append({"case": name, "shape": [b, n, g, k], "equal": True,
                         "graph_ms": graph_ms(lambda: knn_indices(ref, query, k)),
                         "plain_ms": cuda_ms(lambda: knn_indices_torch(ref, query, k), runs=5,
                                             warmup=1),
                         "library_graph_ms": graph_ms(library), "bound_ms": ms_bound,
                         "bound_by": by})
        return gi

    prev, centers = pts, []
    for s, (g, k) in enumerate(zip(num_groups, group_sizes)):
        got = fps_indices(prev, g)
        want = fps_indices_torch(prev, g)
        torch.cuda.synchronize()
        check(torch.equal(got.long(), want.long()), f"fps {label}scale {s}: "
              f"{int((got != want).sum())} indices differ from the plain version")
        b, n = prev.shape[0], prev.shape[1]
        ms_bound, by = bound(b * n * 12 + b * g * 4, 10.0 * b * (g - 1) * n)
        src = prev
        fps_rows.append({"case": f"{label}scale {s}", "shape": [b, n, g], "equal": True,
                         "graph_ms": graph_ms(lambda: fps_indices(src, g)),
                         "plain_ms": cuda_ms(lambda: fps_indices_torch(src, g), runs=3, warmup=1),
                         "bound_ms": ms_bound, "bound_by": by})
        c = fps_gather(prev, got)
        knn_row(f"scale {s} members", prev, c, k)
        centers.append(c)
        prev = c
    if maps:
        for s in range(len(centers) - 1):
            knn_row(f"scale {s} -> coarsest (k 1)", centers[-1], centers[s], 1)
        knn_row("decoder scale 1 -> 0 (k 1)", centers[1], centers[0], 1)
    if propagate:
        for s, c in enumerate(centers):
            knn_row(f"every point -> scale {s} (k 3)", c, pts, 3)
    return res


def _m2ae_finetune_config(tmp: str, data: str) -> str:
    import yaml

    with open(M2AE_FT_CONFIG) as f:
        cfg = yaml.safe_load(f)
    for split in ("train", "val", "test"):
        cfg["dataset"][split]["_base_"]["DATA_PATH"] = data
    path = os.path.join(tmp, "finetune_modelnet_PointM2AE_local.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def phase_m2ae(env: dict, tmp: str, seed: int) -> dict:
    """The Point-M2AE family at full width: kernels at its shapes, the bare
    steps, the step on the card against the CPU, the pretrain CLI, then the
    classifier's finetune, export and serving."""
    from gm3d_tpu_torch.config import cfg_from_yaml_file
    from gm3d_tpu_torch.data.transforms import scale_and_translate
    from gm3d_tpu_torch.masking import geometric_mask
    from gm3d_tpu_torch.models import PointM2AEClassifier
    from gm3d_tpu_torch.train import finetune as ft
    from gm3d_tpu_torch.train.optim import build_finetune_optimizer
    from gm3d_tpu_torch.train.pretrain import M2AE_GM3D_METRIC_KEYS
    from gm3d_tpu_torch.train.state import create_train_state

    res = {"phase": "m2ae", "batch": M2AE_BATCH, "points": M2AE_POINTS}
    mcfg = cfg_from_yaml_file(M2AE_CONFIG)["model"]
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.standard_normal((M2AE_BATCH, M2AE_POINTS, 3))
                           .astype(np.float32) * 0.5).to(DEV)
    t0 = time.perf_counter()
    res["kernels"] = _m2ae_kernel_checks(pts, mcfg["num_groups"], mcfg["group_sizes"])
    res["kernels_s"] = time.perf_counter() - t0

    # ---- the bare steps: launches of one step, then 2 warm-up and the median of 5
    scalars = {"keep_ratio": 0.4, "ema_decay": 0.996}
    steps = {}
    for name, gm3d, dtype, fused in (("m2ae_gm3d", True, torch.float32, False),
                                     ("m2ae", False, torch.float32, False),
                                     ("m2ae_gm3d_bf16", True, torch.bfloat16, False),
                                     ("m2ae_gm3d_fused_attention", True, torch.float32, True)):
        state, step = _m2ae_step(_m2ae_model(M2AE_CONFIG, seed, dtype).to(DEV), gm3d, fused=fused)
        gen = torch.Generator(device=DEV).manual_seed(seed)
        extra = (scalars,) if gm3d else ()
        run = (lambda: step(state, pts, gen, *extra)[1])
        pp.reset_launches()
        metrics = run()
        torch.cuda.synchronize()
        launches = pp.read_launches()
        want = (M2AE_FUSED_LAUNCHES_PER_STEP if fused else
                M2AE_GM3D_LAUNCHES_PER_STEP if gm3d else M2AE_LAUNCHES_PER_STEP)
        check(launches == want, f"{name} launches {launches}, expected {want}")
        check(all(np.isfinite(float(v)) for v in metrics.values()), metrics)
        row = {"launches_per_step": launches}
        if gm3d:
            # the geometric mask at the step's shapes, on the EMA's predicted loss
            with torch.no_grad():
                pred = state.ema(pts, torch.ones((M2AE_BATCH, mcfg["num_groups"][-1]),
                                                 dtype=torch.bool, device=DEV),
                                 loss_pred_only=True)["loss_pred"]
            mask = geometric_mask(gen, pred, step.num_mask, scalars["keep_ratio"])
            check(mask.sum(dim=1).tolist() == [step.num_mask] * M2AE_BATCH,
                  "the geometric mask's count")
            row["masked_coarse_groups_per_row"] = step.num_mask
        if not fused:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms, wall, losses = _step_ms(run)
            row.update(step_ms_cuda_events=ms, step_ms_wall=wall,
                       clouds_per_s=M2AE_BATCH / wall * 1e3, losses=losses,
                       peak_bytes=torch.cuda.max_memory_allocated(),
                       peak_extra_bytes=torch.cuda.max_memory_allocated() - base)
        steps[name] = row
        del state, step, run
        torch.cuda.empty_cache()
    res["steps"] = steps

    # ---- one M2AE + GM3D step at B 4 on the card and on the CPU: same weights, same draws
    # (stochastic depth off: the two devices' generators draw different masks)
    cpu_model = _m2ae_model(M2AE_CONFIG, seed + 1, drop_path_rate=0.0)
    card_model = copy.deepcopy(cpu_model).to(DEV)
    small = rng.standard_normal((M2AE_CPU_BATCH, M2AE_POINTS, 3)).astype(np.float32) * 0.5
    draws = {"scale": rng.uniform(2 / 3, 3 / 2, (M2AE_CPU_BATCH, 1, 3)).astype(np.float32),
             "shift": rng.uniform(-0.2, 0.2, (M2AE_CPU_BATCH, 1, 3)).astype(np.float32),
             "noise": rng.uniform(0, 1, (M2AE_CPU_BATCH, mcfg["num_groups"][-1]))
             .astype(np.float32)}
    both = {}
    for where, model in (("cuda", card_model), ("cpu", cpu_model)):
        dev = DEV if where == "cuda" else torch.device("cpu")
        state, step = _m2ae_step(model, True, device=dev)
        _, m = step(state, torch.from_numpy(small), None, scalars,
                    draws={k: torch.from_numpy(v).to(dev) for k, v in draws.items()})
        both[where] = {k: float(v) for k, v in m.items()}
    rel = {k: abs(both["cuda"][k] - both["cpu"][k]) / max(abs(both["cpu"][k]), 1e-12)
           for k in M2AE_GM3D_METRIC_KEYS}
    check(max(rel.values()) <= TOL_M2AE_STEP, f"card against CPU: {rel}")
    res["card_vs_cpu"] = {"batch": M2AE_CPU_BATCH, "metrics": both, "rel_diff": rel,
                          "tol": TOL_M2AE_STEP}

    # ---- the pretrain CLI: one epoch of 4 steps and the SVM probe (the phase's main path)
    pre_out = os.path.join(tmp, "m2ae_pretrain")
    _fresh_cli_logger()
    pp.reset_launches()  # the M2AE CLI's path: every launch count starts from 0 here
    t0 = time.perf_counter()
    records = pretrain_cli.main(["--config", M2AE_CONFIG, "--model_family", "m2ae_gm3d",
                                 "--synthetic", "--synthetic_samples", str(M2AE_CLI_SAMPLES),
                                 "--batch_size", str(M2AE_BATCH), "--epochs", "1",
                                 "--output_dir", pre_out])
    cli_wall = time.perf_counter() - t0
    launches = pp.read_launches()
    log = _read_log(pre_out)
    check(log == records and len(log) == 1, log)
    check(set(log[0]) == M2AE_RECORD_KEYS, f"log.txt keys {sorted(log[0])}")
    check(all(np.isfinite(log[0][k]) for k in M2AE_RECORD_KEYS), log[0])
    check(log[0]["steps"] == M2AE_CLI_SAMPLES // M2AE_BATCH, log[0])
    check(latest_step(os.path.join(pre_out, "ckpt", "best")) is not None, "no ckpt/best")
    want = {k: v * (M2AE_CLI_SAMPLES // M2AE_BATCH) + M2AE_ENCODER_LAUNCHES[k] * M2AE_PROBE_BATCHES
            for k, v in M2AE_GM3D_LAUNCHES_PER_STEP.items()}
    check(launches == want, f"M2AE CLI launches {launches}, expected {want}")
    res["cli"] = {"records": log, "launches": launches, "wall_s": cli_wall,
                  "cli_over_step": log[0]["clouds_per_sec"] / steps["m2ae_gm3d"]["clouds_per_s"]}

    # ---- Part B: finetune the classifier from that checkpoint, export, serve
    data = os.path.join(tmp, "modelnet40")
    if not os.path.isdir(data):
        _modelnet_dir(data, seed)
    config = _m2ae_finetune_config(tmp, data)
    out = os.path.join(tmp, "m2ae_finetune")
    log, ft_launches, keys = _finetune_cli(config, os.path.join(pre_out, "ckpt"), out,
                                           "--epochs", "1")
    check([r["epoch"] for r in log] == [0], log)
    check(FT_RECORD_KEYS <= set(log[0]) and all(np.isfinite(log[0][k]) for k in log[0]), log[0])
    with open(os.path.join(out, "finetune.log")) as f:
        check("recipe hpm: " in f.read(), "Point-M2AE finetunes with the hpm recipe")
    ft_steps = FT_TRAIN // M2AE_FT_BATCH
    ft_evals = -(-FT_TEST // M2AE_FT_BATCH)
    want = {k: v * (ft_steps + ft_evals) for k, v in M2AE_CLS_LAUNCHES_PER_STEP.items()}
    check(ft_launches == want, f"M2AE finetune launches {ft_launches}, expected {want}")
    with open(os.path.join(data, "modelnet40_test_8192pts_fps.dat"), "rb") as f:
        clouds = pickle.load(f)[0][:8]
    classifier = _m2ae_model(config, seed)
    check(isinstance(classifier, PointM2AEClassifier), type(classifier))
    res["finetune"] = {
        "records": log, "launches": ft_launches, "keys_transferred": keys,
        "served_vs_eval_step_max_abs_err": _served_vs_eval_step(
            config, os.path.join(out, "ckpt", "best"), classifier, clouds[:6], tmp, "m2ae_cls", 8),
        "tol_serve": TOL_SERVE}

    # the classifier's bare train step at the finetune batch (8,192-point clouds): FPS to
    # point_all and the hierarchy of the subsampled clouds, on the step's own inputs and
    # draws, against their plain versions; then its launches and ms
    optimizer = build_finetune_optimizer(classifier.named_parameters(), 1e-4)
    cstate = create_train_state(classifier, optimizer)
    cstep = ft.make_finetune_train_step(classifier, optimizer, FT_NPOINTS)
    cpts = torch.from_numpy(clouds).repeat(M2AE_FT_BATCH // 8, 1, 1).to(DEV)
    labels = torch.arange(M2AE_FT_BATCH, device=DEV) % 40
    gen = torch.Generator(device=DEV).manual_seed(seed)
    draws = ft.finetune_draws(gen, classifier, M2AE_FT_BATCH, FT_POINTS, FT_NPOINTS)
    got = fps_indices(cpts, FT_POINT_ALL)
    want_idx = fps_indices_torch(cpts, FT_POINT_ALL)
    torch.cuda.synchronize()
    check(torch.equal(got.long(), want_idx.long()), f"fps 8192->1200 at B {M2AE_FT_BATCH} "
          f"differs from its plain version at {int((got != want_idx).sum())}")
    sub = ft.subsample(None, fps_gather(cpts, got), FT_NPOINTS, noise=draws["noise"])
    sub = scale_and_translate(None, sub, scale=draws["scale"], shift=draws["shift"])
    _m2ae_kernel_checks(sub, classifier.num_groups, classifier.encoder.group_sizes,
                        label="classifier ", maps=False, into=res["kernels"])
    pp.reset_launches()
    cstep(cstate, cpts, labels, gen, draws=draws)
    torch.cuda.synchronize()
    check(pp.read_launches() == M2AE_CLS_LAUNCHES_PER_STEP, pp.read_launches())
    ms, wall, losses = _step_ms(lambda: cstep(cstate, cpts, labels, gen)[1])
    res["finetune"]["step"] = {"batch": M2AE_FT_BATCH, "step_ms_cuda_events": ms,
                               "step_ms_wall": wall, "clouds_per_s": M2AE_FT_BATCH / wall * 1e3}

    # ---- the seg model (seg_shapenetpart_PointM2AE.yaml, B 16 x 2,048): its hierarchy and
    # the k 3 propagation of every point onto each scale's centers against their plain
    # versions on the eval batch's inputs; a train step and an eval batch, launches and ms
    from gm3d_tpu_torch.train import segmentation as seg

    seg_model = _m2ae_model(M2AE_SEG_CONFIG, seed).to(DEV)
    seg_opt = build_finetune_optimizer(seg_model.named_parameters(), 1e-4)
    seg_state = create_train_state(seg_model, seg_opt)
    seg_step = seg.make_seg_train_step(seg_model, seg_opt)
    seg_eval = seg.make_seg_eval_step(seg_model)
    spts = pts[:M2AE_SEG_BATCH]
    _m2ae_kernel_checks(spts, seg_model.num_groups, seg_model.encoder.group_sizes,
                        label="seg ", maps=False, propagate=True, into=res["kernels"])
    cls = torch.arange(M2AE_SEG_BATCH, device=DEV) % 16
    parts = torch.randint(0, 50, (M2AE_SEG_BATCH, M2AE_POINTS), device=DEV,
                          generator=torch.Generator(device=DEV).manual_seed(seed))
    seg_res = {}
    for name, fn in (("train_step", lambda: seg_step(seg_state, spts, cls, parts, gen)[1]),
                     ("eval_batch", lambda: {"loss": seg_eval(spts, cls).float().mean()})):
        pp.reset_launches()
        fn()
        torch.cuda.synchronize()
        got = pp.read_launches()
        check(got == M2AE_SEG_LAUNCHES, f"seg {name} launches {got}, expected {M2AE_SEG_LAUNCHES}")
        ms, wall, _ = _step_ms(fn)
        seg_res[name] = {"launches": got, "ms_cuda_events": ms, "ms_wall": wall}
    res["segmentation"] = {"batch": M2AE_SEG_BATCH, **seg_res}
    res["gpu"] = env["gpu"]
    emit(res)
    return {"launches": launches, "launches_finetune": ft_launches, "kernels": res["kernels"]}


# the offline evaluation, visualisation and int8 path (phase evaluate): feature probes over
# 128 + 64 synthetic labelled clouds (make_loaders at --synthetic_samples 256, batches of 128)
EVAL_SAMPLES, EVAL_BATCH, EVAL_LINPROB_EPOCHS, EVAL_VOTE_REPEATS = 256, 64, 5, 2
EVAL_PROBE_BATCHES = 2
# an evaluation batch of the classifier: FPS 8,192 -> 1,024 and the grouping's FPS and KNN;
# a vote batch the same with point_all 1,200; nothing else (phase finetune's counts)
EVAL_GM3D_ENCODER = {"fps": 1, "knn": 1, "patch_embed": 0, "attention_fwd": 0,
                     "attention_bwd": 0}
# visualize --heatmap: the masked Point-MAE forward's grouping, the reconstruction's own
# grouping (gm3d_tpu/eval/visualize.py:25), the student's unmasked forward's grouping
VIS_LAUNCHES = {"fps": 3, "knn": 3, "patch_embed": 0, "attention_fwd": 0, "attention_bwd": 0}
VIS_SAMPLES = 4
# int8 serving: one grouping a 128-cloud batch of 1,024 points (no FPS to npoints)
QUANT_LAUNCHES_PER_BATCH = {"fps": 1, "knn": 1, "patch_embed": 0, "attention_fwd": 0,
                            "attention_bwd": 0}
QUANT_LOGIT_TOL = 0.15  # of the fp32 artifact's logit range (tests/test_quantize.py:39)
QUANT_EMA_STEPS = 4
TOL_VIS = 1e-4


class _Lines(logging.Handler):
    """Keeps the messages a logger emits."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _evaluate_cli(*flags: str, lines: list | None = None):
    """``cli/evaluate.py`` in this process: (its result, wall s); ``lines``,
    where given, gets its log messages."""
    from gm3d_tpu_torch.cli import evaluate as evaluate_cli

    _fresh_cli_logger("gm3d.eval")
    handler = _Lines()
    logging.getLogger("gm3d.eval").addHandler(handler)
    t0 = time.perf_counter()
    try:
        out = evaluate_cli.main(list(flags))
        torch.cuda.synchronize()
    finally:
        logging.getLogger("gm3d.eval").removeHandler(handler)
    if lines is not None:
        lines.extend(handler.lines)
    return out, time.perf_counter() - t0


def _ensure_checkpoints(tmp: str, pretrained: str, seed: int) -> dict:
    """The checkpoints phase ``evaluate`` scores, from the phases ``finetune``,
    ``segmentation`` and ``m2ae`` where they ran, else from one short epoch of
    each CLI here (a partial run): {name: (ckpt, config, log records)}."""
    from gm3d_tpu_torch.cli import finetune_seg as seg_cli

    out = {}
    ft_out = os.path.join(tmp, "finetune_hpm")
    if not os.path.isdir(ft_out):
        data = os.path.join(tmp, "modelnet40")
        if not os.path.isdir(data):
            _modelnet_dir(data, seed)
        ft_out = os.path.join(tmp, "finetune_eval")
        _finetune_cli(_finetune_config(tmp, data), pretrained, ft_out, "--epochs", "1")
    out["finetune"] = (os.path.join(ft_out, "ckpt", "best"),
                       os.path.join(tmp, "finetune_modelnet_local.yaml"), _read_log(ft_out))
    seg_out = os.path.join(tmp, "seg")
    if not os.path.isdir(seg_out):
        _fresh_cli_logger("gm3d.seg")
        seg_cli.main(["--config", SEG_CONFIG, "--synthetic", "--synthetic_samples",
                      str(SEG_SAMPLES), "--epochs", "1", "--pretrained", pretrained,
                      "--output_dir", seg_out])
    out["segmentation"] = (os.path.join(seg_out, "ckpt", "best"), SEG_CONFIG, _read_log(seg_out))
    m2ae_out = os.path.join(tmp, "m2ae_pretrain")
    if not os.path.isdir(m2ae_out):
        _fresh_cli_logger()
        pretrain_cli.main(["--config", M2AE_CONFIG, "--model_family", "m2ae_gm3d", "--synthetic",
                           "--synthetic_samples", str(M2AE_BATCH), "--batch_size",
                           str(M2AE_BATCH), "--epochs", "1", "--output_dir", m2ae_out])
    out["m2ae"] = (os.path.join(m2ae_out, "ckpt"), M2AE_CONFIG, _read_log(m2ae_out))
    return out


def _ply_vertices(path: str) -> tuple[np.ndarray, np.ndarray]:
    with open(path) as f:
        lines = f.read().splitlines()
    body = np.array([ln.split() for ln in lines[lines.index("end_header") + 1:]], np.float64)
    return body[:, :3], body[:, 3:]


def _probe_checks(tmp: str, pretrained: str, res: dict) -> dict:
    """The three feature probes through the CLI on the GM3D checkpoint, then kNN
    and the linear probe on the card and on the CPU over the same features."""
    from gm3d_tpu_torch.cli.common import make_loaders
    from gm3d_tpu_torch.cli.evaluate import build_feature_model, parse_args
    from gm3d_tpu_torch.config import cfg_from_yaml_file
    from gm3d_tpu_torch.eval.knn import knn_classifier
    from gm3d_tpu_torch.eval.linear_probe import linear_probe
    from gm3d_tpu_torch.eval.svm import extract_features, make_feature_fn

    flags = ["--config", GM3D_CONFIG, "--synthetic", "--synthetic_samples", str(EVAL_SAMPLES),
             "--batch_size", str(EVAL_BATCH), "--ckpt", pretrained, "--output_dir",
             os.path.join(tmp, "eval_probe")]
    probes = {}
    for probe, extra in (("svm", []), ("knn", []),
                         ("linprob", ["--linprob_epochs", str(EVAL_LINPROB_EPOCHS)])):
        pp.reset_launches()
        acc, wall = _evaluate_cli(*flags, "--probe", probe, *extra)
        launches = pp.read_launches()
        want = {k: v * EVAL_PROBE_BATCHES for k, v in EVAL_GM3D_ENCODER.items()}
        check(launches == want, f"--probe {probe} launches {launches}, expected {want}")
        check(0.0 <= acc <= 1.0, acc)
        probes[probe] = {"acc": acc, "wall_s": wall, "launches": launches}
    # the same features on the card and on the CPU: kNN exactly, the probe to one cloud
    args = parse_args(flags)
    cfg = cfg_from_yaml_file(GM3D_CONFIG)
    cfg["total_bs"] = EVAL_BATCH
    _, svm_train, svm_test = make_loaders(cfg, args)
    model = build_feature_model(args, cfg, torch.float32, logging.getLogger("gm3d.eval")).to(DEV)
    feature_fn = make_feature_fn(model, cfg["npoints"])
    feats = [*extract_features(feature_fn, svm_train, DEV), *extract_features(feature_fn,
                                                                              svm_test, DEV)]
    cpu = [f.cpu() for f in feats]
    knn_card, knn_cpu = knn_classifier(*feats), knn_classifier(*cpu)
    lin_card = linear_probe(*feats, epochs=EVAL_LINPROB_EPOCHS)
    lin_cpu = linear_probe(*cpu, epochs=EVAL_LINPROB_EPOCHS)
    test_clouds = int(feats[3].shape[0])
    check(knn_card == knn_cpu == probes["knn"]["acc"],
          f"kNN card {knn_card}, CPU {knn_cpu}, CLI {probes['knn']['acc']}")
    check(abs(lin_card - lin_cpu) <= 1.0 / test_clouds + 1e-12,
          f"linear probe card {lin_card} against CPU {lin_cpu}")
    check(abs(lin_card - probes["linprob"]["acc"]) <= 1.0 / test_clouds + 1e-12,
          (lin_card, probes["linprob"]["acc"]))
    res["probes"] = probes
    res["card_vs_cpu"] = {"knn": [knn_card, knn_cpu], "linprob": [lin_card, lin_cpu],
                          "train_features": list(feats[0].shape), "test_clouds": test_clouds}
    return {k: sum(p["launches"][k] for p in probes.values()) for k in EVAL_GM3D_ENCODER}


def _visualize_checks(tmp: str, seed: int, res: dict) -> dict:
    """The visualize CLI with ``--heatmap`` on VIS_SAMPLES clouds, then both
    dumps on the card against the CPU from the same weights and mask."""
    import gm3d_tpu_torch.eval.visualize as vis
    from gm3d_tpu_torch.cli import visualize as visualize_cli
    from gm3d_tpu_torch.config import build_model_from_cfg, cfg_from_yaml_file
    from gm3d_tpu_torch.masking import random_mask
    from gm3d_tpu_torch.models import GM3DStudent

    out = os.path.join(tmp, "vis")
    _fresh_cli_logger("gm3d.vis")
    pp.reset_launches()
    t0 = time.perf_counter()
    visualize_cli.main(["--config", GM3D_CONFIG, "--synthetic", "--num_samples",
                        str(VIS_SAMPLES), "--heatmap", "--seed", str(seed), "--out_dir", out,
                        "--output_dir", os.path.join(tmp, "vis_run")])
    wall = time.perf_counter() - t0
    launches = pp.read_launches()
    check(launches == VIS_LAUNCHES, f"visualize launches {launches}, expected {VIS_LAUNCHES}")
    names = sorted(os.listdir(out))
    want = sorted(f"{p}_{b}.ply" for p in ("vis", "heat") for b in range(VIS_SAMPLES))
    check(names == want, names)
    counts = {n: len(_ply_vertices(os.path.join(out, n))[0]) for n in names}
    check(set(counts.values()) == {NUM_GROUP * GROUP_SIZE}, counts)
    # card against CPU: the same weights (from seed), clouds and mask
    mae = build_model_from_cfg(cfg_from_yaml_file(GM3D_CONFIG)["model"])
    mae.reset_parameters(torch.Generator().manual_seed(seed))
    student = GM3DStudent()
    student.reset_parameters(torch.Generator().manual_seed(seed))
    pts = torch.from_numpy(visualize_cli.load_clouds(
        visualize_cli.parse_args(["--config", GM3D_CONFIG, "--synthetic", "--num_samples",
                                  str(VIS_SAMPLES)]), {}, NPOINTS))
    num_mask = int(NUM_GROUP * 0.6)
    mask = random_mask(torch.Generator().manual_seed(seed), VIS_SAMPLES, NUM_GROUP, num_mask)
    gaps = {}
    for where, dev in (("cuda", DEV), ("cpu", torch.device("cpu"))):
        d = os.path.join(tmp, f"vis_{where}")
        vis.dump_reconstruction(copy.deepcopy(mae).to(dev), pts.to(dev), mask, num_mask, d)
        vis.dump_loss_heatmap(copy.deepcopy(student).to(dev), pts.to(dev), d)
    for name in want:
        va, ca = _ply_vertices(os.path.join(tmp, "vis_cuda", name))
        vb, cb = _ply_vertices(os.path.join(tmp, "vis_cpu", name))
        gaps[name] = [float(np.abs(va - vb).max()), float(np.abs(ca - cb).max())]
    check(max(g[0] for g in gaps.values()) <= TOL_VIS, gaps)
    check(max(g[1] for g in gaps.values() if g) <= 1, gaps)
    res["visualize"] = {"files": names, "vertices": counts, "launches": launches,
                        "wall_s": wall, "card_vs_cpu_vertex_gap": max(g[0] for g in gaps.values()),
                        "card_vs_cpu_colour_gap": max(g[1] for g in gaps.values()),
                        "tol": TOL_VIS}
    return launches


def _int8_checks(tmp: str, ckpt: str, config: str, res: dict) -> dict:
    """The finetuned classifier exported fp32, bf16 and int8, served; the int8
    product's accumulations on the card against the CPU at every (K, N) of
    the classifier; logits, agreement, sizes, clouds/s."""
    from gm3d_tpu_torch.serve import load_artifact
    from gm3d_tpu_torch.serve import quantize as q

    arts = {}
    for name, extra in (("int8", ["--quantize", "int8"]), ("fp32", []), ("bf16", ["--bf16"])):
        arts[name] = export_model.main(["--config", config, "--ckpt", ckpt, "--export_batch",
                                        str(SERVE_BATCH), "--out",
                                        os.path.join(tmp, f"cls_{name}.gm3dx"), *extra])
    sizes = {k: os.path.getsize(v) for k, v in arts.items()}
    fn, manifest = load_artifact(arts["int8"], device="cuda")
    check(manifest["quantization"] == "int8", manifest["quantization"])
    # every (K, N) of the program's int8 weights, rows that pad (37) and rows that do not (4096)
    shapes = sorted({(int(w.shape[1]), int(w.shape[0]))
                     for w in fn.program.state_dict.values() if w.dtype == torch.int8})
    gen = torch.Generator().manual_seed(5)
    accum = []
    for k, n in shapes:
        for rows in (37, 4096):
            qx = torch.randint(-127, 128, (rows, k), generator=gen, dtype=torch.int8)
            qw = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
            card = q.int8_matmul(qx.to(DEV), qw.to(DEV))
            check(card.dtype == torch.int32, card.dtype)
            check(torch.equal(card.cpu(), q.int8_matmul(qx, qw)),
                  f"int8 accumulations differ at rows {rows}, K {k}, N {n}")
            accum.append([rows, k, n])
    with open(os.path.join(tmp, "modelnet40", "modelnet40_test_8192pts_fps.dat"), "rb") as f:
        clouds = np.ascontiguousarray(pickle.load(f)[0][:SERVE_BATCH, :NPOINTS])
    served = {name: ServingModel(art, device="cuda") for name, art in arts.items()}
    pp.reset_launches()  # the int8 serving path: every launch count starts from 0 here
    logits = served["int8"].predict(clouds)
    torch.cuda.synchronize()
    launches = pp.read_launches()
    check(launches == QUANT_LAUNCHES_PER_BATCH, f"int8 serving launches {launches}")
    ref = served["fp32"].predict(clouds)
    gap = float(np.abs(logits - ref).max() / np.abs(ref).max())
    check(np.isfinite(logits).all() and gap <= QUANT_LOGIT_TOL, f"int8 logits: gap {gap}")
    x = torch.from_numpy(clouds).to(DEV)
    rates = {}
    for name, model in served.items():
        with torch.inference_mode():
            dev_ms = cuda_ms(lambda: model.device_call(x), runs=10, warmup=2)
        windows = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(4):
                model.predict(clouds)
            windows.append(4 * SERVE_BATCH / (time.perf_counter() - t0))
        rates[name] = {"device_ms_per_batch": dev_ms,
                       "clouds_per_s_device": SERVE_BATCH / dev_ms * 1e3,
                       "clouds_per_s_end_to_end": statistics.median(windows)}
    res["int8_serving"] = {
        "launches_one_batch": launches, "accumulation_shapes_equal": accum,
        "logit_gap_of_range": gap, "tol": QUANT_LOGIT_TOL,
        "top1_agreement_with_fp32": float((logits.argmax(-1) == ref.argmax(-1)).mean()),
        "artifact_bytes": sizes, "int8_over_fp32_bytes": sizes["int8"] / sizes["fp32"],
        "throughput": rates}
    return launches


def _quantize_ema_checks(res: dict) -> dict:
    """QUANT_EMA_STEPS GM3D steps with ``quantize_ema`` at the train phase's
    shapes (dino): launches, finite metrics; 'ema' refused; ms a step beside
    the default step's; the gap of the int8 EMA pass's predicted loss."""
    from gm3d_tpu_torch.serve.quantize import quantized_dense

    state, teacher = pp.build_pretrain_setup(seed=0, device="cuda")
    try:
        make_gm3d_train_step(state.student, teacher, state.optimizer, distill_mode="ema",
                             quantize_ema=True)
        check(False, "quantize_ema with distill_mode='ema' was not refused")
    except ValueError:
        pass
    steps = {"int8": make_gm3d_train_step(state.student, teacher, state.optimizer,
                                          quantize_ema=True),
             "fp32": make_gm3d_train_step(state.student, teacher, state.optimizer)}
    gen = torch.Generator(device=DEV).manual_seed(3)
    pp.reset_launches()  # the quantize_ema path: every launch count starts from 0 here
    history = []
    for _ in range(QUANT_EMA_STEPS):
        state, m = steps["int8"](state, _train_clouds(gen), gen, pp.SCALARS)
        history.append({k: float(m[k]) for k in METRIC_KEYS})
    torch.cuda.synchronize()
    launches = pp.read_launches()
    want = {k: v * QUANT_EMA_STEPS for k, v in LAUNCHES_PER_STEP.items()}
    check(launches == want, f"quantize_ema launches {launches}, expected {want}")
    check(all(np.isfinite(v) for h in history for v in h.values()), history)
    pts = _train_clouds(gen)
    timing = {}
    for _ in range(2):  # int8, fp32, int8, fp32: each the median of 5 after 2 warm-up
        for name, step in steps.items():
            ms, wall, _ = _step_ms(lambda: step(state, pts, gen, pp.SCALARS)[1])
            timing.setdefault(name, []).append({"ms_cuda_events": ms, "ms_wall": wall})
    with torch.no_grad():
        zeros = torch.zeros((TRAIN_BATCH, NUM_GROUP), dtype=torch.bool, device=DEV)
        fp = state.ema(pts, zeros, 0, loss_pred_only=True)["loss_pred"]
        with quantized_dense():
            int8 = state.ema(pts, zeros, 0, loss_pred_only=True)["loss_pred"]
    res["quantize_ema"] = {
        "steps": QUANT_EMA_STEPS, "batch": TRAIN_BATCH, "launches": launches,
        "metrics": history, "timing": timing,
        "ema_loss_pred_max_gap": float((int8 - fp).abs().max()),
        "ema_loss_pred_range": float(fp.abs().max()),
        "ema_distill_refused": True}
    return launches


def phase_evaluate(env: dict, tmp: str, pretrained: str, seed: int) -> dict:
    """Offline evaluation, visualisation and int8 quantization on the card:
    ``cli/evaluate.py`` every probe on the earlier phases' checkpoints,
    ``cli/visualize.py``, int8 serving, the ``quantize_ema`` step."""
    from gm3d_tpu_torch.ckpt.checkpoint import load_best_metrics

    res = {"phase": "evaluate"}
    t_phase = time.perf_counter()
    ckpts = _ensure_checkpoints(tmp, pretrained, seed)
    launches = {k: 0 for k in LAUNCHES_PER_STEP}

    def add(more):
        for k in launches:
            launches[k] += more[k]

    # ---- --probe acc --vote on the finetune CLI's ckpt/best (the main path: counts from 0)
    best, config, log = ckpts["finetune"]
    pp.reset_launches()
    lines = []
    (acc, vote), wall = _evaluate_cli("--config", config, "--ckpt", best, "--vote",
                                      "--vote_repeats", str(EVAL_VOTE_REPEATS), "--output_dir",
                                      os.path.join(tmp, "eval_acc"), lines=lines)
    got = pp.read_launches()
    recorded = load_best_metrics(os.path.dirname(best))["best"]
    check(acc == recorded, f"evaluate acc {acc} against the finetune CLI's {recorded}")
    repeats = [float(m.group(1)) for m in (re.search(r"TEST_VOTE_time \d+\] acc = ([0-9.]+)", ln)
                                           for ln in lines) if m]
    check(len(repeats) == EVAL_VOTE_REPEATS and np.isfinite(vote)
          and all(vote >= r - 5e-5 for r in repeats), (vote, repeats))
    batches = -(-FT_TEST // FT_BATCH)
    want = {k: v * batches * (1 + EVAL_VOTE_REPEATS) for k, v in FT_LAUNCHES_PER_STEP.items()}
    check(got == want, f"--probe acc launches {got}, expected {want}")
    add(got)
    res["acc"] = {"acc": acc, "finetune_cli_recorded": recorded, "vote_acc": vote,
                  "vote_each_repeat": repeats, "wall_s": wall, "launches": got}

    # ---- svm, knn, linprob on the GM3D pretrain checkpoint; card against CPU
    add(_probe_checks(tmp, pretrained, res))

    # ---- --svm_scales both on the M2AE CLI's checkpoint
    m2ae_ckpt, m2ae_config, _ = ckpts["m2ae"]
    pp.reset_launches()
    both, wall = _evaluate_cli("--config", m2ae_config, "--model_family", "m2ae", "--probe",
                               "svm", "--svm_scales", "both", "--ckpt", m2ae_ckpt, "--synthetic",
                               "--synthetic_samples", str(EVAL_SAMPLES), "--batch_size",
                               str(EVAL_BATCH), "--output_dir", os.path.join(tmp, "eval_m2ae"))
    got = pp.read_launches()
    want = {k: v * EVAL_PROBE_BATCHES for k, v in M2AE_ENCODER_LAUNCHES.items()}
    check(got == want and 0.0 <= both <= 1.0, f"--svm_scales both {both}, launches {got}")
    add(got)
    res["svm_scales_both"] = {"acc": both, "wall_s": wall, "launches": got}

    # ---- --probe seg on the seg CLI's ckpt/best
    seg_best, seg_config, seg_log = ckpts["segmentation"]
    pp.reset_launches()
    miou, wall = _evaluate_cli("--config", seg_config, "--probe", "seg", "--ckpt", seg_best,
                               "--synthetic", "--synthetic_samples",
                               str(max(SEG_SAMPLES // 4, 32)), "--output_dir",
                               os.path.join(tmp, "eval_seg"))
    got = pp.read_launches()
    record = max(seg_log, key=lambda r: r["instance_miou"])
    check(abs(miou["instance_miou"] * 100 - record["instance_miou"]) < 1e-9
          and abs(miou["class_miou"] * 100 - record["class_miou"]) < 1e-9,
          f"evaluate mIoU {miou} against the seg CLI's {record}")
    want = {k: v * -(-max(SEG_SAMPLES // 4, 32) // SEG_BATCH)
            for k, v in SEG_LAUNCHES_PER_STEP.items()}
    check(got == want, f"--probe seg launches {got}, expected {want}")
    add(got)
    res["seg"] = {"instance_miou": miou["instance_miou"], "class_miou": miou["class_miou"],
                  "seg_cli_recorded": [record["instance_miou"], record["class_miou"]],
                  "wall_s": wall, "launches": got}

    # ---- cli/visualize.py --heatmap; the dumps on the card against the CPU
    add(_visualize_checks(tmp, seed, res))
    res["launches"] = dict(launches)
    quantized = _int8_checks(tmp, best, config, res)
    ema = _quantize_ema_checks(res)
    res["phase_s"] = time.perf_counter() - t_phase
    res["gpu"] = env["gpu"]
    emit(res)
    return {"launches": launches, "launches_quantized": quantized, "launches_quantize_ema": ema}


# the clip step at full width: B 256 (TRAIN_BATCH), the CLI's default tower (CLIP_SEED);
# the card against the CPU at CLIP_CPU_BATCH clouds with stochastic depth 0
CLIP_STEPS, CLIP_CPU_BATCH, CLIP_SEED = 4, 8, 2


def _fabricated_clip_sd(width=256, patch=4, grid=8, layers=6, out=384, seed=0) -> dict:
    """A full CLIP state dict laid out as the reference's (``visual.*`` beside
    text-tower keys), random weights from ``seed``: no CLIP weights ship with
    the repository."""
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=0.02):
        return torch.randn(*shape, generator=gen) * scale

    sd = {"conv1.weight": randn(width, 3, patch, patch), "class_embedding": randn(width),
          "positional_embedding": randn(grid * grid + 1, width), "proj": randn(width, out),
          "ln_pre.weight": 1 + randn(width), "ln_pre.bias": randn(width),
          "ln_post.weight": 1 + randn(width), "ln_post.bias": randn(width)}
    for i in range(layers):
        p = f"transformer.resblocks.{i}."
        sd.update({p + "ln_1.weight": 1 + randn(width), p + "ln_1.bias": randn(width),
                   p + "ln_2.weight": 1 + randn(width), p + "ln_2.bias": randn(width),
                   p + "attn.in_proj_weight": randn(3 * width, width),
                   p + "attn.in_proj_bias": randn(3 * width),
                   p + "attn.out_proj.weight": randn(width, width),
                   p + "attn.out_proj.bias": randn(width),
                   p + "mlp.c_fc.weight": randn(4 * width, width),
                   p + "mlp.c_fc.bias": randn(4 * width),
                   p + "mlp.c_proj.weight": randn(width, 4 * width),
                   p + "mlp.c_proj.bias": randn(width)})
    text = {"positional_embedding": randn(77, 512), "token_embedding.weight": randn(1000, 512),
            "ln_final.weight": randn(512), "text_projection": randn(512, out),
            "logit_scale": randn(())}
    return {**{f"visual.{k}": v for k, v in sd.items()}, **text}


def _default_clip_tower(device) -> "CLIPVisionTower":
    """The pretrain CLI's tower without ``--clip_path``: output_dim 384."""
    from gm3d_tpu_torch.models.clip import CLIPVisionTower

    tower = CLIPVisionTower(output_dim=384)
    tower.reset_parameters(torch.Generator().manual_seed(CLIP_SEED))
    return tower.to(device)


def _launches_per_step(step, state, gen, steps: int) -> tuple[dict, list]:
    """Each kernel's launches in each of ``steps`` steps; the steps' metrics."""
    per_step, history = [], []
    for _ in range(steps):
        pts = _train_clouds(gen)
        pp.reset_launches()
        state, metrics = step(state, pts, gen, pp.SCALARS)
        per_step.append(pp.read_launches())
        history.append({k: float(metrics[k]) for k in METRIC_KEYS})
    check(all(c == per_step[0] for c in per_step), f"launches differ between steps {per_step}")
    check(all(np.isfinite(v) for m in history for v in m.values()), history)
    return per_step[0], history


def _stage_ms(step, state, gen, runs: int = 3) -> dict:
    """Median stream ms of each stage of ``runs`` steps, and of the step (the
    step's stage spans, ``utils/profiling.py::stage_ms``)."""
    clear()
    with recording():
        for _ in range(runs):
            pts = _train_clouds(gen)
            torch.cuda.synchronize()
            step(state, pts, gen, pp.SCALARS)
            torch.cuda.synchronize()
    per_step = stage_ms()
    clear()
    return {"step": statistics.median(sum(s.values()) for s in per_step),
            **{k: statistics.median(s[k] for s in per_step) for k in per_step[0]}}


def _clip_card_vs_cpu() -> dict:
    """One clip step at ``CLIP_CPU_BATCH`` clouds on the card and in the port
    on the CPU: the same weights (seed 0, the tower's seed 2), clouds and draws,
    stochastic depth 0 (its draws come from each device's generator)."""
    from gm3d_tpu_torch.cli.pretrain import step_draws

    gen = torch.Generator().manual_seed(3)
    pts = torch.randn((CLIP_CPU_BATCH, NPOINTS, 3), generator=gen) * 0.5
    draws = step_draws(gen, CLIP_CPU_BATCH, NUM_GROUP)
    out = {}
    for device in ("cpu", DEV):
        state, _ = pp.build_pretrain_setup(seed=0, device=device, drop_path_rate=0.0)
        step = make_gm3d_train_step(state.student, _default_clip_tower(device), state.optimizer,
                                    distill_mode="clip", device=device)
        _, metrics = step(state, pts.to(device), None, pp.SCALARS,
                          draws={k: v.to(device) for k, v in draws.items()})
        out[str(device)] = ({k: float(metrics[k]) for k in METRIC_KEYS}, step.last_mask.cpu())
    (cpu, cpu_mask), (card, card_mask) = out["cpu"], out[str(DEV)]
    rel = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in METRIC_KEYS}
    check(all(v <= TOL_STEP for v in rel.values()),
          f"clip step on the card {card} against the CPU {cpu}: {rel} above {TOL_STEP}")
    agree = float((card_mask == cpu_mask).float().mean())
    check(agree >= 0.995, f"clip masks agree on {agree}")
    return {"batch": CLIP_CPU_BATCH, "card": card, "cpu": cpu, "rel_diff": rel,
            "tol": TOL_STEP, "mask_agreement": agree}


def _clip_render_checks() -> dict:
    """The depth renders (a scatter-max from zeros: order-free) and the
    centers' patches (int32 truncations, the fp32 clamp below 1) on the card
    EQUAL to the CPU's, on B 256 clouds of 1,024 points and on grid clouds
    (multiples of 1/64: many on patch edges, a quarter of the points repeated)."""
    from gm3d_tpu_torch.models.clip import center_patches, render_depth_views

    gen = torch.Generator().manual_seed(5)
    clouds = {"normal": torch.randn((TRAIN_BATCH, NPOINTS, 3), generator=gen) * 0.5,
              "grid": torch.from_numpy(_grid_cloud(np.random.default_rng(5), TRAIN_BATCH,
                                                   NPOINTS, NPOINTS // 4))}
    out = {}
    for name, pts in clouds.items():
        card = pts.to(DEV)
        img_equal = bool(torch.equal(render_depth_views(card, 32).cpu(),
                                     render_depth_views(pts, 32)))
        patch_equal = bool(torch.equal(center_patches(card, 8).cpu(), center_patches(pts, 8)))
        check(img_equal and patch_equal, f"{name} clouds: renders equal {img_equal}, "
                                         f"patches equal {patch_equal}")
        out[name] = {"renders_equal": img_equal, "patches_equal": patch_equal,
                     "render_ms": cuda_ms(lambda: render_depth_views(card, 32))}
    return out


def phase_clip(env: dict, tmp: str) -> dict:
    """CLIP distillation at full width: the step, its launches and times beside
    the default step's, the card against the CPU, the CLI with ``--clip_path``."""
    t_phase = time.perf_counter()
    state, teacher = pp.build_pretrain_setup(seed=0, device=DEV)
    tower = _default_clip_tower(DEV)
    step = make_gm3d_train_step(state.student, tower, state.optimizer, distill_mode="clip",
                                device=DEV)
    check(step.num_mask == NUM_MASK, step.num_mask)
    gen = torch.Generator(device=DEV).manual_seed(1)
    per_step, history = _launches_per_step(step, state, gen, CLIP_STEPS)
    check(all(m["loss_chfr"] == 0.0 and m["loss_mse"] > 0.0 for m in history), history)
    check(per_step["fps"] == 1 and per_step["knn"] == 1 and per_step["patch_embed"] == 1
          and per_step["attention_bwd"] == LAUNCHES_PER_STEP["attention_bwd"]
          and 0 < per_step["attention_fwd"] < LAUNCHES_PER_STEP["attention_fwd"],
          f"clip step launches {per_step}")

    # the default (dino) step beside it, from its own state: ms, peak memory, in turns
    dino_state, _ = pp.build_pretrain_setup(seed=0, device=DEV)
    dino = make_gm3d_train_step(dino_state.student, teacher, dino_state.optimizer, device=DEV)
    timing = {"clip": [], "dino": []}
    for _ in range(2):
        for name, (fn, st) in (("clip", (step, state)), ("dino", (dino, dino_state))):
            _, _, wall, peak = _steps(fn, st, gen, 3)
            timing[name].append({"ms_wall_median": statistics.median(wall),
                                 "peak_extra_bytes": peak})
    stages = _stage_ms(step, state, gen)
    share = stages["clip_targets"] / stages["step"]
    res = {"phase": "clip", "batch": TRAIN_BATCH, "npoints": NPOINTS,
           "tower": tower.config, "launches_per_step": per_step,
           "launches_per_step_dino": LAUNCHES_PER_STEP, "metrics_first": history[0],
           "metrics_last": history[-1], "timing_in_turns": timing,
           "stage_ms": stages, "clip_target_share_of_step": share}
    res["card_vs_cpu"] = _clip_card_vs_cpu()
    res["renders"] = _clip_render_checks()

    # the CLI, one epoch of four steps through --clip_path
    path = os.path.join(tmp, "clip.pt")
    torch.save(_fabricated_clip_sd(), path)
    out = os.path.join(tmp, "clip_cli")
    _fresh_cli_logger()
    pp.reset_launches()
    records = pretrain_cli.main(["--config", GM3D_CONFIG, "--learn_feature_loss", "clip",
                                 "--clip_path", path, *_cli_flags(out, 1)])
    launches = pp.read_launches()
    check(len(records) == 1 and set(records[0]) == CLI_RECORD_KEYS
          and records[0]["steps"] == CLI_STEPS_PER_EPOCH and records[0]["loss_chfr"] == 0.0
          and all(np.isfinite(records[0][k]) for k in CLI_RECORD_KEYS), records)
    with open(os.path.join(out, "pretrain.log")) as f:
        check("CLIP teacher loaded" in f.read(), "the CLI did not load --clip_path")
    want = with_probes(per_step, CLI_STEPS_PER_EPOCH, 1)
    check(launches == want, f"clip CLI launches {launches}, expected {want}")
    res["cli"] = {"record": records[0], "launches": launches,
                  "clip_path_tower": {"width": 256, "layers": 6, "heads": 4,
                                      "output_dim": 384}}
    res["phase_s"] = time.perf_counter() - t_phase
    res["gpu"] = env["gpu"]
    emit(res)
    return {"launches": {k: v * CLIP_STEPS for k, v in per_step.items()}}


# the EMD phase: auction owners and the Sinkhorn loss on the card against the CPU
# (the auction's rounds grow with the sets held at once: 64 keeps the CPU's side
# to about a second)
EMD_SEED, EMD_AUCTION_SETS, EMD_SETS, EMD_LOSS_TOL, EMD_GRAD_TOL = 0, 64, 256, 1e-5, 1e-4
EMD_STEPS = 3


def _emd_step(loss: str, tmp: str):
    """The Point-MAE of ``config.yaml``'s model section with ``loss`` (a copy in
    ``tmp``: the repository's configs stay as they are), its legacy AdamW and
    its pretrain step, on the card, weights from seed 0."""
    import yaml

    from gm3d_tpu_torch.config import build_model_from_cfg, cfg_from_yaml_file
    from gm3d_tpu_torch.train.optim import build_legacy_adamw
    from gm3d_tpu_torch.train.pretrain import make_pointmae_train_step
    from gm3d_tpu_torch.train.state import create_train_state

    with open(GM3D_CONFIG) as f:
        raw = yaml.safe_load(f)
    path = os.path.join(tmp, f"pointmae_{loss}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({**raw, "model": {**raw["model"], "loss": loss}}, f)
    cfg = cfg_from_yaml_file(path)["model"]
    model = build_model_from_cfg(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(DEV)
    optimizer = build_legacy_adamw(model.named_parameters(), 1e-3, 0.05)
    tc = cfg["transformer_config"]
    step = make_pointmae_train_step(model, optimizer, tc["mask_ratio"], tc["mask_type"],
                                    cfg["loss"], device=DEV)
    return step, create_train_state(model, optimizer)


def phase_emd(env: dict, tmp: str) -> dict:
    """The EMD on the card against the CPU, then the ``loss: emd`` teacher step."""
    from gm3d_tpu_torch.ops import emd

    t_phase = time.perf_counter()
    rng = np.random.default_rng(EMD_SEED)
    res = {"phase": "emd", "auction": []}
    for n, dup in ((32, 0), (32, 16), (64, 32)):
        a, b = (torch.from_numpy(_grid_cloud(rng, EMD_AUCTION_SETS, n, dup)) for _ in range(2))
        da, db = a.to(DEV), b.to(DEV)
        cpu_owner, _ = emd.emd_auction_assignment(a, b)
        owner, _ = emd.emd_auction_assignment(da, db)
        equal = bool(torch.equal(owner.cpu(), cpu_owner))
        check(equal, f"auction owners differ between the card and the CPU (n {n}, dup {dup})")
        res["auction"].append({
            "sets": EMD_AUCTION_SETS, "n": n, "duplicated": dup, "owners_equal": equal,
            "cost_equal": bool(torch.equal(emd.emd_auction(da, db).cpu(), emd.emd_auction(a, b))),
            "ms": cuda_ms(lambda: emd.emd_auction_assignment(da, db), 3, 1)})

    a = torch.from_numpy(rng.standard_normal((EMD_SETS, 32, 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((EMD_SETS, 32, 3)).astype(np.float32))
    got = {}
    for device in ("cpu", DEV):
        x = a.to(device).detach().requires_grad_(True)
        value = emd.emd_loss(x, b.to(device))
        value.sum().backward()
        got[str(device)] = (value.detach().cpu(), x.grad.cpu())
    value_err = _rel_err(got[str(DEV)][0], got["cpu"][0])[1]
    grad_err = _rel_err(got[str(DEV)][1], got["cpu"][1])[1]
    check(value_err <= EMD_LOSS_TOL and grad_err <= EMD_GRAD_TOL, (value_err, grad_err))
    res["sinkhorn"] = {"sets": EMD_SETS, "n": 32, "rel_err_value": value_err,
                       "tol_value": EMD_LOSS_TOL, "rel_err_grad": grad_err,
                       "tol_grad": EMD_GRAD_TOL}

    steps = {loss: _emd_step(loss, tmp) for loss in ("cdl2", "emd")}
    gen = torch.Generator(device=DEV).manual_seed(4)
    timing, launches = {"cdl2": [], "emd": []}, None
    for order in (("cdl2", "emd"), ("emd", "cdl2")):
        for loss in order:
            step, state = steps[loss]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(DEV)
            base = torch.cuda.memory_allocated(DEV)
            if loss == "emd" and launches is None:
                pp.reset_launches()
            ms, wall, losses = _step_ms(
                lambda: step(state, _train_clouds(gen), gen)[1], runs=EMD_STEPS, warmup=1)
            if loss == "emd" and launches is None:
                launches = pp.read_launches()
            timing[loss].append({"ms_cuda_events": ms, "ms_wall": wall, "losses": losses,
                                 "peak_extra_bytes": torch.cuda.max_memory_allocated(DEV) - base})
    want = {k: v * (EMD_STEPS + 1) for k, v in TEACHER_LAUNCHES_PER_STEP.items()}
    check(launches == want, f"emd step launches {launches}, expected {want}")
    res.update({"step": {"batch": TRAIN_BATCH, "masked_groups": steps["emd"][0].num_mask,
                         "timing_in_turns": timing, "launches": launches},
                "phase_s": time.perf_counter() - t_phase, "gpu": env["gpu"]})
    emit(res)
    return {"launches": launches}


# the ddp phase: the data-parallel step against the plain one on the same draws
# (fp32 sums in other orders: per-rank GEMM shapes, the two-pass global batch
# norm, the attention backward's atomic weight gradients)
DDP_STEPS, DDP_TOL, DDP_RANKS, DDP_TIMEOUT_S = 3, 1e-5, 2, 420


def _run_ranks(args: list, log_path: str, timeout: float) -> None:
    """``torchrun`` in a session of its own: killed with every rank it started
    when it outlives ``timeout``."""
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", *args],
                                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
    if rc != 0:
        with open(log_path) as f:
            raise AssertionError(f"torchrun exited {rc}:\n{f.read()[-4000:]}")


def _ddp_compare(name: str, run: dict, plain: dict) -> dict:
    rel = [max(abs(m[k] - p[k]) / max(abs(p[k]), 1e-12) for k in ("loss", "loss_recon"))
           for m, p in zip(run["metrics"], plain["metrics"])]
    check(len(rel) == DDP_STEPS and max(rel) <= DDP_TOL,
          f"{name}: losses {run['metrics']} against the plain step's {plain['metrics']}")
    check(run["launches"] == plain["launches"],
          f"{name}: launches {run['launches']}, the plain step's {plain['launches']}")
    return {"rel_diff_loss_per_step": rel, "tol": DDP_TOL,
            "launches_per_step": run["launches"][0], "ms_wall_per_step": run["ms_wall"],
            "gradient_bytes": run["gradient_bytes"],
            "allreduce_ms_wall": run["allreduce_ms_wall"]}


def phase_ddp(env: dict, tmp: str, seed: int) -> dict:
    """The data-parallel GM3D step at full width: world size 1 over NCCL and
    two ranks on this card over gloo, against the plain step."""
    import torch.distributed as dist

    from gm3d_tpu_torch.parallel.context import get_context
    from gm3d_tpu_torch.parallel.multihost import register_process_group, shutdown
    from gm3d_tpu_torch.scripts import ddp_step

    t_phase = time.perf_counter()
    part_s = {}
    check(get_context() is None, "a data-parallel context before the phase")
    # no group yet: one process on the whole global batch
    plain = ddp_step.run_steps(DEV, TRAIN_BATCH, DDP_STEPS, seed)
    part_s["plain"] = time.perf_counter() - t_phase
    check(all(c == LAUNCHES_PER_STEP for c in plain["launches"]), plain["launches"])
    # world size 1 over NCCL in this process: every collective of the path runs
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        register_process_group(DEV)
        check(dist.get_backend() == "nccl", dist.get_backend())
        nccl = ddp_step.run_steps(DEV, TRAIN_BATCH, DDP_STEPS, seed)
    finally:
        shutdown()
    part_s["world1_nccl"] = time.perf_counter() - t_phase - sum(part_s.values())
    res = {"phase": "ddp", "batch": TRAIN_BATCH, "npoints": NPOINTS, "steps": DDP_STEPS,
           "plain": {"metrics": plain["metrics"], "ms_wall_per_step": plain["ms_wall"]},
           "world1_nccl": _ddp_compare("world size 1 over NCCL", nccl, plain)}
    # two ranks on this one card over gloo (NCCL refuses two ranks on one GPU)
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "ddp")
    _run_ranks(["--nproc_per_node", str(DDP_RANKS), "--master_addr", "127.0.0.1",
                "--master_port", str(_free_port()), "-m", "gm3d_tpu_torch.scripts.ddp_step",
                "--device", "cuda:0", "--batch", str(TRAIN_BATCH), "--steps", str(DDP_STEPS),
                "--seed", str(seed), "--out", out], os.path.join(tmp, "ddp.log"), DDP_TIMEOUT_S)
    ranks = []
    for r in range(DDP_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    check(all(r["backend"] == "gloo" and r["world"] == DDP_RANKS
              and r["batch_per_rank"] == TRAIN_BATCH // DDP_RANKS for r in ranks), ranks)
    check(ranks[0]["metrics"] == ranks[1]["metrics"], "the ranks' metrics differ")
    res["two_ranks_one_card_gloo"] = {
        "batch_per_rank": TRAIN_BATCH // DDP_RANKS,
        "ranks": [_ddp_compare(f"rank {r['rank']} of 2", r, plain) for r in ranks],
        "note": "two processes share one card: the times are no scaling figure"}
    part_s["two_ranks"] = time.perf_counter() - t_phase - sum(part_s.values())
    # the plain step again, for the times in turns
    again = ddp_step.run_steps(DEV, TRAIN_BATCH, DDP_STEPS, seed)
    res["plain_again_ms_wall_per_step"] = again["ms_wall"]
    part_s["plain_again"] = time.perf_counter() - t_phase - sum(part_s.values())
    res.update(part_s=part_s, phase_s=time.perf_counter() - t_phase, gpu=env["gpu"])
    emit(res)
    return {"launches": {k: sum(c[k] for c in nccl["launches"]) for k in LAUNCHES_PER_STEP}}


# the native_loader phase: ShapeNet-55-layout clouds on disk and the SVM sets
NL_CLOUDS, NL_POINTS, NL_SVM = 1024, 2048, (256, 128)


def _loader_clouds_per_s(loader) -> float:
    t0 = time.perf_counter()
    n = sum(len(batch) for batch in loader)
    return n / (time.perf_counter() - t0)


def phase_native_loader(env: dict, tmp: str, seed: int) -> dict:
    """One epoch of the GM3D pretrain CLI through the Python loader and
    through ``--native_loader`` over the same ``.npy`` files."""
    from gm3d_tpu_torch.cli.common import load_config, make_train_loader
    from gm3d_tpu_torch.scripts import make_disk_datasets as disk

    t_phase = time.perf_counter()
    shapenet = disk.write_shapenet55(os.path.join(tmp, "shapenet"), NL_CLOUDS, 16, NL_POINTS,
                                     seed)
    modelnet = disk.write_modelnet(os.path.join(tmp, "modelnet"), *NL_SVM, NPOINTS, seed)
    config = disk.pretrain_config(os.path.join(tmp, "disk.yaml"), GM3D_CONFIG, shapenet,
                                  modelnet)
    probe_batches = sum(-(-n // (2 * TRAIN_BATCH)) for n in NL_SVM)
    want = {k: v * (NL_CLOUDS // TRAIN_BATCH) + (probe_batches if k in ("fps", "knn") else 0)
            for k, v in LAUNCHES_PER_STEP.items()}
    res = {"phase": "native_loader", "clouds": NL_CLOUDS, "points_a_file": NL_POINTS,
           "batch": TRAIN_BATCH, "runs": []}
    # in turns: the first CLI run of a process pays the allocator's growth
    for turn, name in enumerate(("python", "native", "native", "python")):
        extra = ["--native_loader"] if name == "native" else []
        out = os.path.join(tmp, f"nl_{turn}_{name}")
        flags = ["--config", config, "--epochs", "1", "--batch_size", str(TRAIN_BATCH),
                 "--num_workers", "4", "--sync_probe", "--output_dir", out, *extra]
        _fresh_cli_logger()
        pp.reset_launches()
        records = pretrain_cli.main(flags)
        launches = pp.read_launches()
        check(len(records) == 1 and set(records[0]) == CLI_RECORD_KEYS
              and records[0]["steps"] == NL_CLOUDS // TRAIN_BATCH
              and all(np.isfinite(records[0][k]) for k in CLI_RECORD_KEYS), records)
        check(launches == want, f"{name} loader run: launches {launches}, expected {want}")
        args = pretrain_cli.parse_args(flags)
        loader = make_train_loader(load_config(args), args)
        check(type(loader.loader).__name__ == ("NativeCloudLoader" if extra else "_points_only"),
              type(loader.loader))
        res["runs"].append({"loader": name, "record": records[0], "launches": launches,
                            "cli_clouds_per_sec": records[0]["clouds_per_sec"],
                            "loader_alone_clouds_per_s": _loader_clouds_per_s(loader)})
    res.update(phase_s=time.perf_counter() - t_phase, gpu=env["gpu"])
    emit(res)
    return {"launches": res["runs"][1]["launches"]}


TRACE_STEPS = 12  # 9 spans a GM3D step: 108 spans held against the profiler's events


def _offsets_ns(records, events) -> list:
    """Each port span's start and end against the profiler's own range of the
    same name (the k-th of a name against the k-th), in ns."""
    theirs: dict = {}
    for name, start, dur in sorted(events, key=lambda e: e[1]):
        theirs.setdefault(name, []).append((start, start + dur))
    ours: dict = {}
    for r in sorted(records, key=lambda r: r["start_ns"]):
        ours.setdefault(r["name"], []).append(r)
    check({k: len(v) for k, v in ours.items()} == {k: len(v) for k, v in theirs.items()},
          "the profiler's ranges and the port's spans differ in number")
    return [x for name, rs in ours.items() for r, (start, end) in zip(rs, theirs[name])
            for x in (start - r["start_ns"], r["end_ns"] - end)]


def _span_us(runs: int, name: str) -> float:
    """Host us of one span entered and left, ``runs`` times in a loop."""
    t0 = time.perf_counter()
    for _ in range(runs):
        with span(name):
            pass
    return (time.perf_counter() - t0) / runs * 1e6


def phase_tracing(env: dict, tmp: str) -> dict:
    """The span recorder on the card: the port's spans against the
    profiler's own events of the same names (the clock), what a span and a
    stage's event cost on this host, the stage times of a traced step, and
    ``start_trace``'s window and second-thread spans."""
    import torch.autograd.profiler as autograd_profiler

    check(hasattr(autograd_profiler, "_is_profiler_enabled"),
          "this torch has no process-wide profiler flag: spans would never record")
    state, teacher = pp.build_pretrain_setup(seed=0, device="cuda")
    step = make_gm3d_train_step(state.student, teacher, state.optimizer)
    gen = torch.Generator(device=DEV).manual_seed(1)
    for _ in range(2):
        state, _ = step(state, _train_clouds(gen), gen, pp.SCALARS)
    torch.cuda.synchronize()
    clear()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    for _ in range(TRACE_STEPS):
        state, _ = step(state, _train_clouds(gen), gen, pp.SCALARS)
    torch.cuda.synchronize()
    prof.stop()
    records = spans()
    per_step = stage_ms()
    clear()
    names = {r["name"] for r in records}
    events = [(e.name(), int(e.start_ns()), int(e.duration_ns()))
              for e in prof.profiler.kineto_results.events()
              if e.name() in names and e.device_type() == torch.autograd.DeviceType.CPU]
    offsets = _offsets_ns(records, events)
    absolute = sorted(abs(o) for o in offsets)
    check(len(records) >= 100, f"{len(records)} spans in {TRACE_STEPS} steps")
    # the cost of a span and of a stage's timing event on this host
    off_us = _span_us(100_000, "off")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        on_us = _span_us(10_000, "on")
    clear()
    t0 = time.perf_counter()
    for _ in range(10_000):
        torch.cuda.Event(enable_timing=True).record()
    event_us = (time.perf_counter() - t0) / 10_000 * 1e6
    torch.cuda.synchronize()
    # start_trace: its window range and a second thread's span in the written trace
    def side():
        with span("side"):
            torch.ones(4, device=DEV).sum()

    tr = start_trace(tmp)
    state, _ = step(state, _train_clouds(gen), gen, pp.SCALARS)
    thread = threading.Thread(target=side, name="side")
    thread.start()
    thread.join(timeout=60)
    path = stop_trace(tr, tmp)
    clear()
    with open(path) as f:
        written = {e.get("name") for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "user_annotation"}
    check({"side", "step", "step.backward", TRACE_WINDOW} <= written,
          f"the written trace lacks spans: {sorted(written)[:20]}")
    res = {"phase": "tracing", "spans": len(records), "steps": TRACE_STEPS,
           "clock_offset_ns": {"median_abs": statistics.median(absolute),
                               "max_abs": absolute[-1],
                               "median_signed": statistics.median(offsets)},
           "span_us": {"off": off_us, "on_under_profiler": on_us},
           "stage_event_us": event_us,
           "stage_ms_median": {k: statistics.median(s[k] for s in per_step)
                               for k in per_step[0]},
           "step_ms_median": statistics.median(sum(s.values()) for s in per_step),
           "written_trace": {"busy_share": device_busy_share(path),
                             "longest_idle_ms_at_ms": device_idle_gaps(path, top=3)},
           "gpu": env["gpu"]}
    emit(res)
    return res


PHASES = ("env", "build", "kernels", "serve", "throughput", "train", "pretrain_cli", "teacher",
          "resume", "probe", "step_options", "finetune", "segmentation", "fewshot", "m2ae",
          "evaluate", "clip", "emd", "ddp", "native_loader", "tracing")


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
            phase_throughput(served["artifact"], served["artifact_bf16"])
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
    tuned = segmented = few = m2ae = evaluated = None
    with tempfile.TemporaryDirectory() as tmp:
        # one short epoch of the port's GM3D pretrain CLI: the weights of all three
        if {"finetune", "segmentation", "fewshot", "evaluate"} & set(phases):
            pretrained = _gm3d_pretrain_ckpt(tmp, 128, 64)
        if "finetune" in phases:
            tuned = phase_finetune(env, tmp, pretrained, cli_args.seed)
        if "segmentation" in phases:
            segmented = phase_segmentation(env, tmp, pretrained, cli_args.seed)
        if "fewshot" in phases:
            few = phase_fewshot(env, tmp, pretrained, cli_args.seed)
        if "m2ae" in phases:
            # on phase finetune's ModelNet directory where it ran
            m2ae = phase_m2ae(env, tmp, cli_args.seed)
        if "evaluate" in phases:
            # on the checkpoints of the phases above where they ran
            evaluated = phase_evaluate(env, tmp, pretrained, cli_args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        clipped = phase_clip(env, tmp) if "clip" in phases else None
        emded = phase_emd(env, tmp) if "emd" in phases else None
    with tempfile.TemporaryDirectory() as tmp:
        parallel = phase_ddp(env, tmp, cli_args.seed) if "ddp" in phases else None
        native = phase_native_loader(env, tmp, cli_args.seed) if "native_loader" in phases else None
    with tempfile.TemporaryDirectory() as tmp:
        if "tracing" in phases:
            phase_tracing(env, tmp)
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
        # the seg CLI's and the few-shot CLI's runs (its ten folds trained together): FPS
        # and KNN only
        kern["launches_segmentation"] = segmented["launches"][kern["name"]]
        kern["launches_fewshot"] = few["launches"][kern["name"]]
        # the Point-M2AE few-shot CLI's ten folds trained together (FPS and KNN only)
        kern["launches_fewshot_m2ae"] = few["launches_m2ae"][kern["name"]]
        # the Point-M2AE pretrain CLI's run and its classifier's finetune: FPS and KNN only
        kern["launches_m2ae"] = m2ae["launches"][kern["name"]]
        kern["launches_m2ae_finetune"] = m2ae["launches_finetune"][kern["name"]]
        # every evaluate probe and visualize (FPS and KNN only); int8 serving (one batch);
        # the quantize_ema step (the GM3D step's kernels, its EMA pass's in fp32)
        kern["launches_evaluate"] = evaluated["launches"][kern["name"]]
        kern["launches_quantized"] = evaluated["launches_quantized"][kern["name"]]
        kern["launches_quantize_ema"] = evaluated["launches_quantize_ema"][kern["name"]]
        # the clip step's four steps (the patch embed once a step); the emd teacher
        # step's four (FPS and KNN only, as the JAX step routes it)
        kern["launches_clip"] = clipped["launches"][kern["name"]]
        kern["launches_emd"] = emded["launches"][kern["name"]]
        # the data-parallel step at world size 1 over NCCL (each rank of the
        # two-rank run launches the plain step's: the phase line); one pretrain
        # CLI epoch through the native loader, with its SVM probe
        kern["launches_ddp"] = parallel["launches"][kern["name"]]
        kern["launches_native_loader"] = native["launches"][kern["name"]]
        if kern["name"] == "knn":
            # the feature propagation's shape: 2,048 queries on 128 references, k 3
            kern["seg_propagation"] = segmented["knn_propagation"]
        if kern["name"] in ("fps", "knn"):
            # each shape of the Point-M2AE hierarchy and its k = 1 maps, B 128
            kern["m2ae_shapes"] = m2ae["kernels"][kern["name"]]
        check(kern["launches"] > 0 and kern["launches_pretrain_cli"] > 0,
              f"{kern['name']} was never launched on its path")
    emit({"kernels": timed})
    print(env["gpu"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
