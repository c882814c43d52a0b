"""The highest rate a serving cell's program sustains, by one sweep.

    python3 -m benchmark.harness.sweep --workload <cell> --seconds 10 --rates 1000 2000 ...

One process sets the server up once and drives it at each rate in turn, a
fresh schedule a rate. A rate is sustained when every request is answered
and the backlog does not grow: the mean latency of the requests due in the
window's second half is within 1.25 times (and 5 ms) of the first half's.
Prints one JSON line a rate; the cells' rates (4/5 and 5/4 of the highest
sustained one) were set from it, once, and written into their files.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from benchmark.harness import env
from benchmark.harness.env import ROOT
from benchmark.harness.serve_driver import READ_TIMEOUT_S, _Lines
from benchmark.traffic import http_load
from benchmark.traffic.clouds import make_clouds


def sustained(plan: dict, result: dict, seconds: float) -> dict:
    due = np.asarray(plan["due"])
    lat = np.asarray(result["latency_ms"])
    first, second = lat[due < seconds / 2], lat[due >= seconds / 2]
    ok = bool(all(result["ok"]) and second.mean() <= 1.25 * first.mean() + 5.0)
    return {"sustained": ok, "mean_ms_first_half": float(first.mean()),
            "mean_ms_second_half": float(second.mean()), "p95_ms": float(np.percentile(lat, 95)),
            "clouds_per_s": result["clouds_answered_in_window"] / seconds}


def main(argv=None, device=None, overrides=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--trials", type=int, default=1, help="runs at each rate, each a new seed")
    p.add_argument("--connections", type=int, nargs="+", default=None,
                   help="client connection counts to sweep (default: the mix's)")
    p.add_argument("--dump", default=None,
                   help="a JSON-lines file for each run's due times and latencies")
    args = p.parse_args(argv)
    env.set_cache_dirs()
    from gm3d_tpu_torch.serve.server import make_server

    from benchmark.harness.cell import benchmark_file, settings

    run = settings(benchmark_file(), args.workload, args.seed, args.seconds, False,
                   device or torch.device("cuda", 0), time.perf_counter(), overrides=overrides)
    cfg, mod, dev = run.cfg, run.cfgmod, run.device
    path = f"{run.tmpdir}/benchmark_sweep.gm3dx"
    mod.export_classifier(cfg, mod.serve_state(cfg, args.seed, dev), dev, path)
    server = make_server(path, port=0, batch_wait_ms=cfg["serve"]["batch_wait_ms"],
                         device=str(dev))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    bank = make_clouds(args.seed + 1, run.traffic["bank_clouds"], cfg["npoints"], dev)
    bank = bank.cpu().numpy()
    try:
        grid = [(conns, rate, args.seed + trial) for conns in
                (args.connections or [run.traffic["connections"]])
                for rate in args.rates for trial in range(args.trials)]
        for conns, rate, seed in grid:
            params = dict(run.traffic, rate_clouds_per_s=rate, connections=conns)
            child = subprocess.Popen([sys.executable, "-m", "benchmark.traffic.http_load"],
                                     cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            lines = _Lines(child.stdout)
            header = {"port": server.server_address[1], "seed": seed,
                      "seconds": args.seconds, "params": params,
                      "npoints": cfg["npoints"], "bank": len(bank)}
            child.stdin.write(json.dumps(header).encode() + b"\n" + bank.tobytes())
            child.stdin.flush()
            lines.get(READ_TIMEOUT_S)
            calls0, clouds0 = server.batcher.device_calls, server.batcher.clouds_served
            child.stdin.write(b"go\n")
            child.stdin.flush()
            result = json.loads(lines.get(args.seconds + http_load.ANSWER_WAIT_S + 60.0))
            child.wait(timeout=60)
            plan = http_load.schedule(seed, params, args.seconds)
            calls = server.batcher.device_calls - calls0
            if args.dump:
                with open(args.dump, "a") as f:
                    f.write(json.dumps({"rate": rate, "connections": conns, "seed": seed,
                                        "due": plan["due"], "k": plan["k"],
                                        "latency_ms": result["latency_ms"],
                                        "late_ms": result["late_ms"]}) + "\n")
            out = {"rate_clouds_per_s": rate, "connections": conns, "seed": seed,
                   **sustained(plan, result, args.seconds),
                   "clouds_per_call": (server.batcher.clouds_served - clouds0) / max(calls, 1),
                   "late_ms_p99": float(np.percentile(result["late_ms"], 99))}
            print(json.dumps(out))
            sys.stdout.flush()
    finally:
        server.shutdown()
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
