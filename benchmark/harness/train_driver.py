"""The training cells: the pretrain loop over the port's loader, a timed
window, and the first three steps held against the plain reference.

Set-up builds one training object (``configs/<config>.py``'s
``TrainProgram``) and drives it from the seed through its first steps with
the window's own feed and call; the first three are checked. The window then
takes steps for ``seconds`` on the same object, the metrics read one step
behind (``utils/pipeline.py``), and ends when every step has finished on the
device. After it, with the peak memory read and the program's state freed,
the reference follows the three checked steps.
"""

from __future__ import annotations

import gc
import math
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.traffic.clouds import make_clouds

CHECKED_STEPS = 3


class CloudSet:
    """The seeded clouds as a dataset of the port's ``DataLoader``: items are
    (taxonomy, model, points), as ShapeNet-55's."""

    def __init__(self, clouds: np.ndarray):
        self.clouds = clouds

    def __len__(self) -> int:
        return len(self.clouds)

    def __getitem__(self, idx: int):
        return "synthetic", str(idx), self.clouds[idx]


class Feed:
    """The port's ``device_prefetch`` over its ``DataLoader``, an epoch at a
    time as the CLI iterates them; records the host's wait for each batch."""

    def __init__(self, loader, device):
        from gm3d_tpu_torch.data.prefetch import device_prefetch

        self.loader, self.device, self._prefetch = loader, device, device_prefetch
        self._it = iter(device_prefetch(loader, device=device))
        self.waits: List[float] = []

    def next(self) -> torch.Tensor:
        t = time.perf_counter()
        try:
            pts = next(self._it)
        except StopIteration:
            self._it = iter(self._prefetch(self.loader, device=self.device))
            pts = next(self._it)
        self.waits.append(time.perf_counter() - t)
        return pts


def step_generator(seed: int, device) -> torch.Generator:
    """The generator of the steps' draws (augmentation, mask noise,
    stochastic depth), from the seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 31 + 7) % 2 ** 63)


def prepare(run, marks: Optional[dict] = None) -> SimpleNamespace:
    """What the checked steps start from, made from the seed: the port's
    ``DataLoader`` over the seeded clouds at the cell's epoch, the weights and
    the steps' generator. The controls (``harness/controls.py``) start from
    the same."""
    from gm3d_tpu_torch.data.datasets import DataLoader

    cfg, traffic, dev = run.cfg, run.traffic, run.device
    marks = {} if marks is None else marks
    batch = cfg["recipe"]["batch"]
    clouds = make_clouds(run.seed, traffic["dataset_clouds"], cfg["npoints"], dev).cpu().numpy()
    loader = DataLoader(CloudSet(clouds), batch, seed=run.seed,
                        num_workers=traffic["num_workers"])
    steps_per_epoch, epoch = len(loader), traffic["epoch"]
    loader.load_state({"epoch": epoch, "batch": 0})
    marks["clouds"] = time.perf_counter() - run.t_start
    states = run.cfgmod.train_states(cfg, run.seed, dev)
    marks["weights"] = time.perf_counter() - run.t_start
    return SimpleNamespace(batch=batch, loader=loader, states=states, epoch=epoch,
                           steps_per_epoch=steps_per_epoch, start_step=epoch * steps_per_epoch,
                           gen=step_generator(run.seed, dev))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(run) -> Dict:
    """One run of a training cell. ``run``: the cell's settings
    (``harness/cell.py``). Returns the outcome the harness reports."""
    from gm3d_tpu_torch.utils.pipeline import DeferredMetrics

    cfg, traffic, mod, dev = run.cfg, run.traffic, run.cfgmod, run.device
    marks = {"driver": time.perf_counter() - run.t_start}
    torch.backends.cuda.matmul.allow_tf32 = False  # as the pretrain CLI sets it
    torch.backends.cudnn.allow_tf32 = False
    inputs = prepare(run, marks)
    batch, states = inputs.batch, inputs.states
    start_step, steps_per_epoch, epoch = inputs.start_step, inputs.steps_per_epoch, inputs.epoch
    prog = mod.TrainProgram(cfg, states, dev, inputs.gen, start_step, steps_per_epoch, epoch)
    feed = Feed(inputs.loader, dev)
    marks["built"] = time.perf_counter() - run.t_start
    failed = [0]

    def drain(metrics):
        values = torch.stack([metrics[k] for k in prog.metric_keys]).tolist()
        failed[0] += not all(math.isfinite(v) for v in values)

    dm = DeferredMetrics(drain, depth=1)

    def one_step() -> dict:
        metrics = prog.step(feed.next())
        dm.push(metrics)
        return metrics

    # the checked steps: the window's own feed and call
    before = {n: p.clone() for n, p in prog.params().items()}
    batches, losses, masks = [], [], []
    first_norms = None
    gen_state = prog.gen.get_state()
    for i in range(CHECKED_STEPS):
        pts = feed.next()
        batches.append(pts.detach().cpu())
        metrics = prog.step(pts)
        dm.push(metrics)
        losses.append(metrics["loss"])
        last_mask = getattr(prog, "last_mask", None)
        masks.append(last_mask().detach().cpu() if last_mask is not None else None)
        if i == 0:
            first_norms = {n: g.norm() for n, g in prog.first_gradients().items()}
    change_norms = {n: (p - before[n]).norm() for n, p in prog.params().items()}
    ema_change_norms = {n: float(torch.linalg.vector_norm(d)) for n, d in prog.ema_change()}
    del before
    marks["checked_steps"] = time.perf_counter() - run.t_start
    for _ in range(traffic["warmup_steps"]):
        one_step()
    dm.flush()
    _sync(dev)
    failed[0] = 0
    feed.waits.clear()

    trace, traced_steps = None, 0
    t0 = time.perf_counter()
    setup_s = t0 - run.t_start
    steps = 0
    while time.perf_counter() - t0 < run.seconds:
        if run.trace and steps == traffic["trace_after_steps"]:
            from benchmark.harness.trace import traced

            def stretch():
                for _ in range(traffic["trace_steps"]):
                    one_step()

            trace = traced(stretch, sync=lambda: _sync(dev))
            traced_steps = traffic["trace_steps"]
            steps += traced_steps
            continue
        one_step()
        steps += 1
    dm.flush()
    _sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace_s = None
    if trace is not None:
        recording, trace = trace, trace.read()
        trace_s = {"stop": recording.stop_s, "read": recording.read_s}

    readings = {"losses": [float(x) for x in losses],
                "first_grad_norms": {n: float(v) for n, v in first_norms.items()},
                "change_norms": {n: float(v) for n, v in change_norms.items()},
                "ema_change_norms": ema_change_norms}
    layer = {"batch": batch, "steps": steps, "window_s": window_s, "setup_marks_s": marks,
             "data_wait_s": list(feed.waits), "trace_steps": traced_steps,
             "trace_s": trace_s}
    # the program's state goes before the reference runs
    del prog, feed, dm, inputs, losses, first_norms, change_norms, one_step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reference = mod.reference_train(cfg, states, batches, gen_state, start_step,
                                    steps_per_epoch, epoch, dev,
                                    program_masks=None if None in masks else masks)
    numbers = compare.training(readings, reference)
    layer["mask_ties_taken"] = reference["ties"]
    layer["numbers"] = numbers
    return {"e2e": {"train_clouds_per_s": steps * batch / window_s, "setup_s": setup_s},
            "layer": layer, "numbers": numbers, "attempted": steps, "failed": failed[0],
            "memory_peak_bytes": peak, "trace": trace}
