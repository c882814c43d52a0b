"""The traffic: seeded clouds, the serving schedule, and the open-loop
generator's latency from each request's due time."""

import io
import json
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from benchmark.harness.env import ROOT
from benchmark.traffic import http_load
from benchmark.traffic.clouds import make_clouds

PARAMS = {"k_max": 32, "k_alpha": 1.5, "bank_clouds": 16, "connections": 8,
          "warmup_requests": 4, "warmup_connections": 2, "sample_requests": 5, "sample_largest": 2,
          "rate_clouds_per_s": 400.0}


def test_clouds_are_seeded_normalised_and_distinct():
    a, b = make_clouds(7, 3, 256), make_clouds(7, 3, 256)
    assert torch.equal(a, b) and not torch.equal(a, make_clouds(8, 3, 256))
    assert a.shape == (3, 256, 3) and a.dtype == torch.float32
    assert torch.allclose(a.norm(dim=-1).amax(dim=1), torch.ones(3))
    assert torch.allclose(a.mean(dim=1), torch.zeros(3, 3), atol=1e-6)
    for cloud in a:
        assert torch.unique(cloud, dim=0).shape[0] == 256


def test_schedule_same_work_every_seed():
    a = http_load.schedule(1, PARAMS, 10.0)
    b = http_load.schedule(2 ** 31 + 11, PARAMS, 10.0)
    assert sorted(a["k"]) == sorted(b["k"]) and a["k"] != b["k"]
    assert sorted(np.diff(a["due"] + [10.0]).round(9)) == sorted(np.diff(b["due"] + [10.0]).round(9))
    assert a["due"][0] == 0.0 and a["due"][-1] < 10.0
    assert 1 <= min(a["k"]) and max(a["k"]) <= 32
    # the rate in clouds a second, and P(k) ~ k^-1.5 (mean about 4.4 on 1 .. 32)
    assert sum(a["k"]) == pytest.approx(4000, rel=0.02)
    assert a["mean_k"] == pytest.approx(4.36, abs=0.05)
    largest = sorted(range(len(a["k"])), key=lambda i: -a["k"][i])[:2]
    assert set(largest) <= set(a["sample"])
    assert all(len(c) == k for c, k in zip(a["clouds"], a["k"]))


class _Slow(BaseHTTPRequestHandler):
    delay = 0.02

    def log_message(self, *args):
        pass

    def do_POST(self):
        blob = self.rfile.read(int(self.headers["Content-Length"]))
        k = np.load(io.BytesIO(blob)).shape[0]
        time.sleep(self.delay)
        out = [[float(j == 1) for j in range(3)]] * k
        body = json.dumps({"outputs": out, "label": [1] * k}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_generator_times_from_due_time():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Slow)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    seconds, npoints = 1.0, 8
    bank = np.random.default_rng(0).standard_normal((16, npoints, 3)).astype(np.float32)
    child = subprocess.Popen([sys.executable, "-m", "benchmark.traffic.http_load"], cwd=ROOT,
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    try:
        header = {"port": server.server_address[1], "seed": 3, "seconds": seconds,
                  "params": PARAMS, "npoints": npoints, "bank": 16}
        child.stdin.write(json.dumps(header).encode() + b"\n" + bank.tobytes())
        child.stdin.flush()
        assert child.stdout.readline().strip() == b"warm"
        child.stdin.write(b"go\n")
        child.stdin.flush()
        result = json.loads(child.stdout.readline())
        assert child.wait(timeout=60) == 0
    finally:
        if child.poll() is None:
            child.kill()
        server.shutdown()
        server.server_close()
    plan = http_load.schedule(3, PARAMS, seconds)
    assert all(result["ok"]) and len(result["latency_ms"]) == len(plan["k"])
    # each request's latency counts from its due time: at least the server's delay
    assert min(result["latency_ms"]) >= 1e3 * _Slow.delay
    assert sorted(int(i) for i in result["outputs"]) == plan["sample"]
    assert result["clouds_answered_in_window"] <= sum(plan["k"])
    late = np.array(result["late_ms"])
    assert np.median(late) < 50.0
    # a late send is charged: latency >= lateness + the server's delay
    lat = np.array(result["latency_ms"])
    assert np.all(lat >= late + 1e3 * _Slow.delay - 1.0)
