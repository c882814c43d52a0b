"""The readings that set each limit's upper end: the control and the faults.

    python3 -m benchmark.harness.controls --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed with the numbers that decide ``correct``, read
from the same inputs a run of the cell would use, at the cell's own size:

  - ``control``: the plain reference put in the program's place and computed
    in TF32 (the configurations state fp32 with TF32 off), held against the
    fp32 reference;
  - training cells, ``fault_half_batch``: the reference in the program's
    place stepping on the first half of each batch (the mean taken over it);
    ``fault_ema_decay``: the reference in the program's place with the EMA
    decay 0.999 for the epoch's 0.9999; a step that leaves the state
    unchanged reads 1 in ``change_gap`` and ``ema_change_gap`` by their
    definition and needs no run;
  - serving cells: the served answers are the reference's logits over the
    window's sampled requests.

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark.harness import compare, env
from benchmark.harness.train_driver import CHECKED_STEPS, Feed, prepare
from benchmark.traffic import http_load
from benchmark.traffic.clouds import make_clouds


def _as_readings(out: dict) -> dict:
    return {"losses": [float(x) for x in out["losses"]],
            "first_grad_norms": {n: float(torch.linalg.vector_norm(g))
                                 for n, g in out["first_grads"].items()},
            "change_norms": compare.norms(out["change"]),
            "ema_change_norms": compare.norms(out["ema_change"])}


def training(run) -> dict:
    """The three checked steps' inputs as the train driver makes them
    (``train_driver.prepare``): the feed's first batches at the cell's epoch,
    the weights and the steps' generator."""
    cfg, mod, dev = run.cfg, run.cfgmod, run.device
    inputs = prepare(run)
    batch, states = inputs.batch, inputs.states
    feed = Feed(inputs.loader, dev)
    batches = [feed.next().cpu() for _ in range(CHECKED_STEPS)]
    del feed
    gen = inputs.gen.get_state()
    args = (inputs.start_step, inputs.steps_per_epoch, inputs.epoch, dev)
    control = mod.reference_train(cfg, states, batches, gen, *args, tf32=True)
    # the fp32 reference judges the control's masks as it judges the program's
    sound = mod.reference_train(cfg, states, batches, gen, *args,
                                program_masks=control["masks"])
    plain = mod.reference_train(cfg, states, batches, gen, *args)
    half = mod.reference_train(cfg, states, [b[: batch // 2] for b in batches], gen, *args)
    decay = mod.reference_train(cfg, states, batches, gen, *args, ema_decay=0.999)
    return {"control": compare.training(_as_readings(control), sound),
            "control_masks_taken": sound["ties"],
            "fault_half_batch": compare.training(_as_readings(half), plain),
            "fault_ema_decay": compare.training(_as_readings(decay), plain)}


def serving(run) -> dict:
    cfg, traffic, mod, dev = run.cfg, run.traffic, run.cfgmod, run.device
    state = mod.serve_state(cfg, run.seed, dev)
    bank = make_clouds(run.seed + 1, traffic["bank_clouds"], cfg["npoints"], dev).cpu().numpy()
    plan = http_load.schedule(run.seed, traffic, run.seconds)
    idx = [j for i in plan["sample"] for j in plan["clouds"][i]]
    pts = torch.from_numpy(bank[idx]).to(dev)
    sound = mod.reference_logits(cfg, state, pts).cpu()
    control = mod.reference_logits(cfg, state, pts, tf32=True).cpu()
    return {"control": {"logit_gap": compare.serving(control, sound)}, "sample_clouds": len(idx)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None,
                   help="the window a serving run's sample is drawn from (default: run_seconds)")
    args = p.parse_args(argv)
    env.set_cache_dirs()
    from benchmark.harness.cell import benchmark_file, settings

    bench = benchmark_file()
    if not torch.cuda.is_available():
        print("the controls run on the card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        run = settings(bench, args.workload, seed, args.seconds or bench["run_seconds"], False,
                       torch.device("cuda", 0), 0.0)
        out = training(run) if run.traffic["kind"] == "train" else serving(run)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
