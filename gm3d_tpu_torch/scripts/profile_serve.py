"""Where one served batch spends its time on the GPU.

    python3 -m gm3d_tpu_torch.scripts.profile_serve [--bf16] [--batch 128]

Exports the full-width PointTransformer classifier with weights drawn from a
seed, loads it with :class:`ServingModel` on the GPU and prints JSON lines:

  stages    CUDA-event time of each stage of the forward (grouping with its
            two kernels, patch embed, positional embed, encoder blocks, head),
            median over the batches
  profiler  ``torch.profiler`` over a steady window: the device's busy share
            (sum of kernel time over the window's wall time) and the kernels
            that take most of it, by name

It needs a CUDA device and fails without one; it measures, asserts nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from gm3d_tpu_torch.cli import export_model
from gm3d_tpu_torch.ops.group import group_points
from gm3d_tpu_torch.serve.runner import ServingModel

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--runs", type=int, default=10)
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
            + (["--bf16"] if args.bf16 else []))
        serving = ServingModel(art, device="cuda")
    clouds = np.random.default_rng(0).standard_normal(
        (args.batch, serving.npoints, 3)).astype(np.float32)
    x = torch.from_numpy(clouds).cuda()
    for _ in range(3):
        serving.device_call(x)
    torch.cuda.synchronize()

    model = serving.module
    timer = _StageTimer({"patch_embed": model.encoder, "pos_embed": model.pos_embed,
                         "blocks": model.blocks, "head": model.cls_head_finetune})
    total = _event_ms(lambda: serving.device_call(x), args.runs)
    stages = timer.close()
    with torch.inference_mode():
        stages["group (fps + knn + gather)"] = _event_ms(
            lambda: group_points(x, model.num_group, model.group_size), args.runs)
    stages["other"] = total - sum(stages.values())
    print(json.dumps({"what": "stages", "gpu": gpu, "dtype": dtype, "batch": args.batch,
                      "forward_ms": total, "stage_ms": stages}), flush=True)

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
