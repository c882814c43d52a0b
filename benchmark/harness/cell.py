"""One run of one cell: find its files by name, run its driver, read its
metrics and decide ``correct``.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix. Everything else is found by name:

  - ``configs/<config>.json``: the sizes as run; ``configs/<config>.py``: the
    program built for them, their work counted from shapes, the reference;
  - ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names the
    driver (``harness/<kind>_driver.py``);
  - ``workloads/<cell>.json``: what belongs to the cell alone (a rate, the
    limits of the numbers that decide ``correct``), laid over the mix's;
  - ``metrics/<metric>.py``: ``read(ctx)`` of each per-layer metric, which
    returns ``None`` where it finds nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
import tempfile
from types import SimpleNamespace
from typing import Dict, Optional

from benchmark.harness.env import BENCH, ROOT, forbidden_loaded


def load_module(path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_file() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def settings(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, tmpdir: Optional[str] = None, overrides: Optional[dict] = None):
    """The run's settings: the cell, its configuration, mix and module."""
    cell = find_cell(bench, name)
    cfg = _json(BENCH / "configs" / f"{cell['config']}.json")
    traffic = _json(BENCH / "traffic" / f"{cell['traffic']}.json")
    own = _json(BENCH / "workloads" / f"{name}.json")
    limits = own.pop("limits")
    traffic.update(own)
    for key, value in (overrides or {}).items():
        section, _, field = key.partition(".")
        target = {"cfg": cfg, "traffic": traffic}[section]
        *path, last = field.split(".")
        for part in path:
            target = target[part]
        target[last] = value
    cfgmod = load_module(BENCH / "configs" / f"{cell['config']}.py",
                         f"benchmark_config_{cell['config'].replace('.', '_').replace('-', '_')}")
    return SimpleNamespace(cell=cell, name=name, cfg=cfg, traffic=traffic, limits=limits,
                           cfgmod=cfgmod, seed=int(seed), seconds=float(seconds),
                           trace=bool(trace), device=device, t_start=t_start,
                           tmpdir=tmpdir or tempfile.gettempdir())


def gpu_state() -> Optional[dict]:
    """The card's name, clocks, power and temperature by ``nvidia-smi``."""
    fields = "name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    values = [v.strip() for v in out.strip().splitlines()[0].split(",")]
    return dict(zip(fields.split(","), values))


def run_cell(run, bench: dict) -> dict:
    """Run the cell's driver and assemble the result line (without printing)."""
    driver = importlib.import_module(f"benchmark.harness.{run.traffic['kind']}_driver")
    outcome = driver.run(run)
    loaded = forbidden_loaded(sys.modules)
    if loaded:
        raise SystemExit(f"forbidden modules loaded: {loaded}")
    checks = {name: {"value": outcome["numbers"][name], "limit": limit}
              for name, limit in run.limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    metrics: Dict[str, dict] = {}
    ctx = SimpleNamespace(run=run, cfg=run.cfg, traffic=run.traffic, cfgmod=run.cfgmod,
                          layer=outcome["layer"], trace=outcome["trace"], e2e=outcome["e2e"])
    if run.trace:
        for m in bench["per_layer"]:
            if not applies(m, run.name):
                continue
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                                 "benchmark_metric_" + m["name"].replace(".", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, run.name) and m["name"] in outcome["e2e"]:
                metrics[m["name"]] = {"value": outcome["e2e"][m["name"]], "unit": m["unit"]}
    result = {"correct": correct, "attempted": outcome["attempted"],
              "failed": outcome["failed"], "metrics": metrics,
              "device": {"memory_peak_bytes": outcome["memory_peak_bytes"]}}
    trace = outcome["trace"]
    if trace is not None:
        result["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    result["checks"] = checks
    result["_layer"] = outcome["layer"]
    return result
