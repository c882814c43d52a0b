"""Where an epoch of the pretrain CLI spends its time beside the bare step, on the GPU.

    python3 -m gm3d_tpu_torch.scripts.profile_pretrain_cli [--batch 256] [--samples 1024]
        [--workers 0,1,2,4] [--steps 4]

Prints one JSON line with the card's name and power limit:

  data     the host's side alone: one ``SyntheticClouds`` batch made in one
           thread, then a ``DataLoader`` epoch at each ``--workers``: the
           time to its first batch and to its last (wall clock)
  copy     one batch into pinned memory and onto the card
           (``device_prefetch``'s copy), wall clock around a synchronise
  step     the bare pretrain step (``profile_pretrain.profile``): clouds per
           second over ``--steps`` steps after one warm-up
  cli      ``cli.pretrain.main`` in this process, two epochs of
           ``samples / batch`` steps at each ``--workers``: epoch 1's
           ``clouds_per_sec`` and, for each of its steps, how long the loop
           waited for its batch (the prefetcher's ``next``, wall clock)
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from gm3d_tpu_torch.cli import pretrain as pretrain_cli
from gm3d_tpu_torch.data.datasets import DataLoader, SyntheticClouds
from gm3d_tpu_torch.data.prefetch import device_prefetch
from gm3d_tpu_torch.scripts import profile_pretrain as pp
from gm3d_tpu_torch.utils.device import resolve_device

CONFIG = os.path.join(os.path.dirname(__file__), "..", "..", "configs", "pointmae", "config.yaml")


class _TimedPrefetch(device_prefetch):
    """``device_prefetch`` that records how long each ``next`` took."""

    waits: list = []

    def __iter__(self):
        it = super().__iter__()
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            _TimedPrefetch.waits.append((time.perf_counter() - t0) * 1e3)
            yield batch


def data_side(batch: int, samples: int, workers) -> dict:
    ds = SyntheticClouds(samples, 1024, seed=1)
    t0 = time.perf_counter()
    np.stack([ds[i][2] for i in range(batch)])
    out = {"one_batch_one_thread_ms": (time.perf_counter() - t0) * 1e3, "epochs": {}}
    for w in workers:
        loader = DataLoader(ds, batch, seed=0, num_workers=w)
        t0 = time.perf_counter()
        it = iter(loader)
        next(it)
        first = time.perf_counter() - t0
        for _ in it:
            pass
        out["epochs"][w] = {"first_batch_ms": first * 1e3,
                            "epoch_ms": (time.perf_counter() - t0) * 1e3,
                            "batches": len(loader)}
    return out


def copy_side(batch: int, dev: torch.device) -> dict:
    pts = np.random.default_rng(0).standard_normal((batch, 1024, 3)).astype(np.float32)
    times = []
    for _ in range(6):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = next(iter(device_prefetch([pts], size=1, device=dev)))
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    if out.device.type != dev.type:
        raise RuntimeError(f"the batch landed on {out.device}, not {dev}")
    return {"pin_and_copy_ms": statistics.median(times[1:]), "bytes": pts.nbytes}


def cli_side(batch: int, samples: int, workers, dev: torch.device) -> dict:
    out = {}
    pretrain_cli.device_prefetch = _TimedPrefetch
    try:
        for w in workers:
            _TimedPrefetch.waits = []
            with tempfile.TemporaryDirectory() as tmp:
                records = pretrain_cli.main([
                    "--config", CONFIG, "--synthetic", "--synthetic_samples", str(samples),
                    "--batch_size", str(batch), "--epochs", "2", "--num_workers", str(w),
                    "--output_dir", tmp, "--device", str(dev)])
            per_epoch = len(_TimedPrefetch.waits) // 2
            out[w] = {"clouds_per_sec": [r["clouds_per_sec"] for r in records],
                      "epoch_s": [r["time"] for r in records],
                      "epoch_1_waits_ms": _TimedPrefetch.waits[per_epoch:]}
    finally:
        pretrain_cli.device_prefetch = device_prefetch
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--samples", type=int, default=1024)
    ap.add_argument("--workers", default="0,1,2,4")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("profile_pretrain_cli times the GPU: it has nothing to say about a CPU")
    workers = [int(w) for w in args.workers.split(",")]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"batch": args.batch, "samples": args.samples,
           "data": data_side(args.batch, args.samples, workers),
           "copy": copy_side(args.batch, dev)}
    state, teacher = pp.build_pretrain_setup(0, dev)
    step = pp.profile(state, teacher, args.batch, 1024, args.steps, 1, plain=False)
    res["step"] = {"clouds_per_s": step["clouds_per_s"], "step_ms_wall": step["step_ms_wall"]}
    del state, teacher
    res["cli"] = cli_side(args.batch, args.samples, workers, dev)
    res["gpu"] = pp.gpu_name_and_limit()
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
