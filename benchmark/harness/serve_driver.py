"""The serving cells: the port's HTTP server over an exported classifier,
open-loop load from a child process, and sampled answers held against the
plain reference.

Set-up makes the weights from the seed, exports the classifier with
``serve/export.py`` into the run's temporary directory, starts
``serve/server.py::make_server`` (``DynamicBatcher`` in front of
``ServingModel``) in this process, and starts the load generator
(``traffic/http_load.py``), which warms the path up closed-loop. The window
opens when the generator is told to go; the generator times every request
from its due time. After the window, the generator waits for every answer,
the server stops, and the reference recomputes the sampled requests' logits
from the same clouds.
"""

from __future__ import annotations

import gc
import json
import os
import queue
import subprocess
import sys
import threading
import time
from typing import Dict

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.harness.env import ROOT
from benchmark.traffic import http_load
from benchmark.traffic.clouds import make_clouds

READ_TIMEOUT_S = 600.0


class _Lines:
    """Lines of a child's standard output, read by a thread, with a timeout."""

    def __init__(self, stream):
        self._q: queue.Queue = queue.Queue()
        self._t = threading.Thread(target=self._pump, args=(stream,), daemon=True)
        self._t.start()

    def _pump(self, stream):
        for line in iter(stream.readline, b""):
            self._q.put(line.decode())
        self._q.put(None)

    def get(self, timeout: float) -> str:
        line = self._q.get(timeout=timeout)
        if line is None:
            raise RuntimeError("the load generator ended early")
        return line


def run(run) -> Dict:
    from gm3d_tpu_torch.serve.server import make_server

    cfg, traffic, mod, dev = run.cfg, run.traffic, run.cfgmod, run.device
    npoints = cfg["npoints"]
    marks = {"driver": time.perf_counter() - run.t_start}
    state = mod.serve_state(cfg, run.seed, dev)
    path = os.path.join(run.tmpdir, f"benchmark_{os.getpid()}.gm3dx")
    mod.export_classifier(cfg, state, dev, path)
    marks["exported"] = time.perf_counter() - run.t_start
    server = make_server(path, port=0, batch_wait_ms=cfg["serve"]["batch_wait_ms"],
                         device=str(dev))
    serving = threading.Thread(target=server.serve_forever, name="benchmark-server", daemon=True)
    serving.start()
    marks["server"] = time.perf_counter() - run.t_start
    bank = make_clouds(run.seed + 1, traffic["bank_clouds"], npoints, dev).cpu().numpy()
    child = subprocess.Popen([sys.executable, "-m", "benchmark.traffic.http_load"], cwd=ROOT,
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    try:
        lines = _Lines(child.stdout)
        header = {"port": server.server_address[1], "seed": run.seed, "seconds": run.seconds,
                  "params": traffic, "npoints": npoints, "bank": len(bank)}
        child.stdin.write(json.dumps(header).encode() + b"\n" + bank.tobytes())
        child.stdin.flush()
        if lines.get(READ_TIMEOUT_S).strip() != "warm":
            raise RuntimeError("the load generator did not warm up")
        marks["warm"] = time.perf_counter() - run.t_start
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        batcher = server.batcher
        calls0, clouds0 = batcher.device_calls, batcher.clouds_served
        t_go = time.perf_counter()
        setup_s = t_go - run.t_start
        child.stdin.write(b"go\n")
        child.stdin.flush()
        trace, counts = None, {}

        def until_close():
            time.sleep(max(0.0, t_go + run.seconds - time.perf_counter()))
            counts.update(calls=batcher.device_calls - calls0,
                          clouds=batcher.clouds_served - clouds0)

        if run.trace:
            from benchmark.harness.trace import traced

            # the window's last seconds: the profiler's own work when it stops
            # falls after the window has closed
            time.sleep(max(0.0, t_go + run.seconds - traffic["trace_s"] - time.perf_counter()))
            trace = traced(until_close)
        else:
            until_close()
        calls, clouds = counts["calls"], counts["clouds"]
        result = json.loads(lines.get(run.seconds + http_load.ANSWER_WAIT_S + 60.0))
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        server.shutdown()
        server.server_close()
        serving.join(timeout=60)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace_s = None
    if trace is not None:
        recording, trace = trace, trace.read()
        trace_s = {"stop": recording.stop_s, "read": recording.read_s}
    del server, batcher
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    os.remove(path)

    plan = http_load.schedule(run.seed, traffic, run.seconds)
    missing = [i for i in plan["sample"] if str(i) not in result["outputs"]]
    idx = [j for i in plan["sample"] if str(i) in result["outputs"] for j in plan["clouds"][i]]
    served = torch.tensor([row for i in plan["sample"] if str(i) in result["outputs"]
                           for row in result["outputs"][str(i)]], dtype=torch.float32)
    pts = torch.from_numpy(bank[idx]).to(dev)
    ref = mod.reference_logits(cfg, state, pts).cpu()
    latency = result["latency_ms"]
    failed = sum(not good for good in result["ok"])
    numbers = {"logit_gap": compare.serving(served, ref) if len(idx) else float("inf"),
               "sample_missing": float(len(missing)), "requests_failed": float(failed)}
    from benchmark.harness.stats import percentile

    layer = {"latency_ms": latency, "setup_marks_s": marks, "device_calls": calls,
             "clouds_served": clouds, "late_ms": result["late_ms"], "sample_clouds": len(idx),
             "numbers": numbers, "trace_s": trace_s}
    return {"e2e": {"serve_p95_ms": percentile(latency, 95), "setup_s": setup_s},
            "layer": layer, "numbers": numbers, "attempted": len(latency), "failed": failed,
            "memory_peak_bytes": peak, "trace": trace}
