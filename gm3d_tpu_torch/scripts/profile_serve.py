"""Where one served batch spends its time on the GPU.

    python3 -m gm3d_tpu_torch.scripts.profile_serve [--bf16] [--batch 128]
        [--input_points N] [--csrc DIR]

Exports the full-width PointTransformer classifier with weights drawn from a
seed, loads it with :class:`ServingModel` on the GPU and prints JSON lines:

  stages    CUDA-event time of the served program's forward, and of each
            stage of the same forward in eager modules rebuilt from the
            artifact's manifest with the export's seed (the program has no
            modules to time; with ``--input_points`` above the model's 1024,
            the FPS down to 1024 that begins the forward; grouping with its
            two kernels, patch embed, positional embed, encoder blocks,
            head), median over the batches
  profiler  ``torch.profiler`` over a steady window of the served program:
            the device's busy share (sum of kernel time over the window's
            wall time) and the kernels that take most of it, by name
  compare   with ``--csrc DIR``: the eager forward and its FPS and grouping
            stages with the FPS and KNN kernels of DIR (another copy of the
            sources, the parent commit's, say) and with the package's, in
            turns (DIR, package, package, DIR). DIR's kernels are built on
            their own and put in the package's place for this process only
            (the program calls the package's ops, so the eager forward is
            the one compared)

It needs a CUDA device and fails without one; it measures, asserts nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gm3d_tpu_torch.cli import export_model
from gm3d_tpu_torch.config import build_model_from_cfg
from gm3d_tpu_torch.ops.fps import fps
from gm3d_tpu_torch.ops.group import group_points
from gm3d_tpu_torch.serve.export import build_classifier_fn
from gm3d_tpu_torch.serve.runner import ServingModel
from gm3d_tpu_torch.utils.device import dtype_from_name

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                      "configs", "pointmae", "finetune_modelnet.yaml")


class _StageTimer:
    """CUDA events around named sub-modules, by forward hooks."""

    def __init__(self, modules: dict):
        self.spans: dict[str, list] = {name: [] for name in modules}
        self._open: dict[str, torch.cuda.Event] = {}
        self._handles = []
        for name, mod in modules.items():
            self._handles.append(mod.register_forward_pre_hook(self._pre(name)))
            self._handles.append(mod.register_forward_hook(self._post(name)))

    def _pre(self, name):
        def hook(mod, args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._open[name] = ev
        return hook

    def _post(self, name):
        def hook(mod, args, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.spans[name].append((self._open.pop(name), ev))
        return hook

    def close(self) -> dict:
        torch.cuda.synchronize()
        for h in self._handles:
            h.remove()
        return {name: statistics.median(a.elapsed_time(b) for a, b in spans)
                for name, spans in self.spans.items() if spans}


def _event_ms(fn, runs: int) -> float:
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class _OtherKernels:
    """The FPS and KNN kernels built from another copy of the sources, put in
    the package's place (the names the forward calls them by) inside a
    ``with`` block."""

    def __init__(self, csrc: Path, tmp: str):
        from gm3d_tpu_torch.scripts.tune_kernels import Kernels

        self.kern = Kernels(csrc, Path(tmp) / "other_csrc").wait()
        self.fps_mod = importlib.import_module("gm3d_tpu_torch.ops.fps")
        self.group_mod = importlib.import_module("gm3d_tpu_torch.ops.group")

    def fps_indices(self, xyz, n):
        launch, out = self.kern.fps(xyz.contiguous(), n, self.kern.fps_default(*xyz.shape[:2]))
        launch()
        return out

    def knn_indices(self, ref, query, k):
        query = query.contiguous()
        launch, (_, idx, _) = self.kern.knn(ref.contiguous(), query, k, self.kern.knn_default(
            ref.shape[0], ref.shape[1], query.shape[1], k))
        launch()
        return idx

    def __enter__(self):
        self.saved = (self.fps_mod.fps_indices, self.group_mod.fps_indices,
                      self.group_mod.knn_indices)
        self.fps_mod.fps_indices = self.group_mod.fps_indices = self.fps_indices
        self.group_mod.knn_indices = self.knn_indices

    def __exit__(self, *exc):
        self.fps_mod.fps_indices, self.group_mod.fps_indices, self.group_mod.knn_indices = \
            self.saved


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--input_points", type=int, default=None,
                    help="points a cloud has at the artifact's input (default: the model's)")
    ap.add_argument("--csrc", type=Path, default=None,
                    help="another copy of the CUDA sources whose FPS and KNN kernels are "
                         "timed in turns with the package's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dtype = "bfloat16" if args.bf16 else "float32"

    with tempfile.TemporaryDirectory() as tmp:
        art = export_model.main(
            ["--config", CONFIG, "--out", os.path.join(tmp, "m.gm3dx"), "--seed", "0",
             "--export_batch", str(args.batch), "--device", "cuda"]
            + (["--bf16"] if args.bf16 else [])
            + (["--input_points", str(args.input_points)] if args.input_points else []))
        serving = ServingModel(art, device="cuda")
    clouds = np.random.default_rng(0).standard_normal(
        (args.batch, serving.npoints, 3)).astype(np.float32)
    x = torch.from_numpy(clouds).cuda()
    for _ in range(3):
        serving.device_call(x)
    torch.cuda.synchronize()

    manifest = serving.manifest
    cfg, npoints = manifest["model_cfg"], manifest["npoints"]
    x_model = fps(x, npoints) if serving.npoints > npoints else x
    # the forward in eager modules, for the stages' hooks: the export's weights
    model = build_model_from_cfg(cfg, dtype=dtype_from_name(manifest["compute_dtype"]))
    model.reset_parameters(torch.Generator().manual_seed(0))
    eager = build_classifier_fn(model.cuda().eval(), npoints)

    def eager_call():
        with torch.inference_mode():
            return eager(x)

    def front_stages() -> dict:
        with torch.inference_mode():
            out = {"group (fps + knn + gather)": _event_ms(
                lambda: group_points(x_model, cfg["num_group"], cfg["group_size"]), args.runs)}
            if serving.npoints > npoints:
                out[f"fps {serving.npoints} -> {npoints} + gather"] = _event_ms(
                    lambda: fps(x, npoints), args.runs)
        return out

    total = _event_ms(lambda: serving.device_call(x), args.runs)
    for _ in range(3):
        eager_call()
    timer = _StageTimer({"patch_embed": model.encoder, "pos_embed": model.pos_embed,
                         "blocks": model.blocks, "head": model.cls_head_finetune})
    eager_total = _event_ms(eager_call, args.runs)
    stages = timer.close()
    stages.update(front_stages())
    stages["other"] = eager_total - sum(stages.values())
    print(json.dumps({"what": "stages", "gpu": gpu, "dtype": dtype, "batch": args.batch,
                      "input_points": serving.npoints, "forward_ms": total,
                      "eager_forward_ms": eager_total, "stage_ms": stages}), flush=True)

    if args.csrc is not None:
        name = str(args.csrc)
        runs = {"package": [], name: []}
        with tempfile.TemporaryDirectory() as tmp:
            other = _OtherKernels(args.csrc.resolve(), tmp)
            for which in (name, "package", "package", name):
                with other if which == name else contextlib.nullcontext():
                    for _ in range(3):
                        eager_call()
                    runs[which].append({"eager_forward_ms": _event_ms(eager_call, args.runs),
                                        **front_stages()})
        print(json.dumps({"what": "compare", "gpu": gpu, "dtype": dtype, "batch": args.batch,
                          "input_points": serving.npoints, "runs": runs}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.runs):
            serving.device_call(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    print(json.dumps({
        "what": "profiler", "gpu": gpu, "dtype": dtype, "batch": args.batch,
        "window_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "kernels_launched_per_batch": sum(r[2] for r in rows) / args.runs,
        "top_kernels": [{"name": k[:90], "ms_per_batch": ms / args.runs,
                         "calls_per_batch": n / args.runs} for k, ms, n in rows[:14]],
    }), flush=True)


if __name__ == "__main__":
    main()
