"""The command line of the benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Without a CUDA device, or with fewer than the cell asks for, it exits with
code 3 and prints no result. Earlier lines of standard output carry the
card's clocks and power around the window and what the drivers saw; the last
lines of standard error are the numbers that decide ``correct``, each beside
its limit; the last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark.harness import env
from benchmark.harness.peaks import PEAK_NOTE


def parse_args(argv):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _summary(layer: dict) -> dict:
    from benchmark.harness.stats import percentile

    out = {"setup_marks_s": layer.get("setup_marks_s"), "numbers": layer.get("numbers"),
           "trace_s": layer.get("trace_s")}
    if "late_ms" in layer:
        late = layer["late_ms"]
        out["generator_late_ms"] = {"p50": percentile(late, 50), "p99": percentile(late, 99),
                                    "max": max(late), "requests": len(late)}
        out["sample_clouds"] = layer["sample_clouds"]
    if "data_wait_s" in layer:
        waits = layer["data_wait_s"]
        out["steps"] = layer["steps"]
        out["mask_ties_taken"] = layer.get("mask_ties_taken")
        out["data_wait_ms_mean"] = 1e3 * sum(waits) / max(len(waits), 1)
    return out


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    env.set_cache_dirs()
    import time

    import torch

    marks = {"torch_imported": time.perf_counter() - t_start}

    from benchmark.harness.cell import benchmark_file, find_cell, gpu_state, run_cell, settings

    bench = benchmark_file()
    chips = find_cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    marks["cuda_found"] = time.perf_counter() - t_start
    run = settings(bench, args.workload, args.seed, args.seconds, args.trace,
                   torch.device("cuda", 0), t_start)
    before = gpu_state()
    marks["gpu_read"] = time.perf_counter() - t_start
    result = run_cell(run, bench)
    after = gpu_state()
    layer = result.pop("_layer")
    print(json.dumps({"gpu_before_window": before, "gpu_after_window": after, "marks_s": marks,
                      "memory_peak_bytes": result["device"]["memory_peak_bytes"],
                      **_summary(layer)}))
    power = float(after["power.limit"]) if after else None
    for m in result["metrics"].values():
        if m["unit"] == "%":
            m["peak"] = PEAK_NOTE
            m["power_limit_w"] = power
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                        "count": chips, "power_limit_w": power, **result["device"]}
    checks = result.pop("checks")
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = checks
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
