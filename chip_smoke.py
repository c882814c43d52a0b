#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py

needs one NVIDIA Hopper card, the CUDA toolkit (``nvcc``) and nothing else:
no arguments, no network, no dataset. It imports ``gm3d_tpu_torch`` only.
Phases, each printing one JSON line when it ends:

  env         card name and power limit, torch / CUDA / nvcc versions
  build       compiles ``gm3d_tpu_torch/csrc/*.cu`` and loads the library
  kernels     every kernel against its plain PyTorch version on the card
              (indices must be EQUAL), then times at the serving shapes
  serve       exports the full-width PointTransformer classifier (random
              weights from a seed) through the export CLI, serves it over
              HTTP with dynamic batching, checks the answers against the
              same artifact on the CPU, and counts kernel launches
  throughput  clouds per second of ``ServingModel.predict``, fp32 and bf16

Any failure raises, so the exit code is non-zero and no result line is
printed. The last line is ``{"ok": true, "device": {...}}``.

``--phases env,build,kernels`` (development only) runs a prefix of the list.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device: "
                     "torch.cuda.is_available() is False")

from gm3d_tpu_torch.cli import export_model  # noqa: E402
from gm3d_tpu_torch.ops import _build  # noqa: E402
from gm3d_tpu_torch.ops.fps import fps_gather, fps_indices, fps_indices_torch  # noqa: E402
from gm3d_tpu_torch.ops.knn import knn_indices, knn_indices_torch  # noqa: E402
from gm3d_tpu_torch.serve.runner import ServingModel  # noqa: E402
from gm3d_tpu_torch.serve.server import make_server  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "pointmae", "finetune_modelnet.yaml")
DEV = torch.device("cuda", 0)

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# the fp32 rate outside the tensor cores (both kernels are fp32 vector code).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# the serving shapes: one exported batch of the classifier
SERVE_BATCH, NPOINTS, NUM_GROUP, GROUP_SIZE = 128, 1024, 64, 32


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what) -> None:
    """Raise (also under ``python -O``) when a phase's condition fails."""
    if not ok:
        raise AssertionError(str(what))


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median time of ``fn()`` on the card in ms (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """Least time the card could take, in ms, and which limit sets it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_env() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout
    release = next((ln.strip() for ln in nvcc.splitlines() if "release" in ln), "")
    env = {"phase": "env", "gpu": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "nvcc": release}
    emit(env)
    return env


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_library(verbose=True)
    emit({"phase": "build", "library": os.path.relpath(_build.library_path(), ROOT),
          "seconds": round(time.perf_counter() - t0, 2)})


def _grid_cloud(rng, batch, n, dup):
    """Coordinates on a coarse grid (multiples of 1/64: every product and sum
    is exact in fp32) with the first ``dup`` points repeated at the end, so
    that equal distances occur and the tie rules decide."""
    pts = rng.integers(-64, 65, size=(batch, n, 3)).astype(np.float32) / 64.0
    pts[:, n - dup:] = pts[:, :dup]
    return pts


def phase_kernels() -> list[dict]:
    rng = np.random.default_rng(0)

    def cloud(b, n):
        return torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32)).to(DEV)

    checks = []
    # ---- FPS -------------------------------------------------------------
    fps_cases = [("serving", cloud(SERVE_BATCH, NPOINTS), NUM_GROUP),
                 ("serving x2", cloud(256, 1024), 64),
                 ("in-graph 8192->1024", cloud(32, 8192), 1024),
                 ("ragged N=200", cloud(3, 200), 24),
                 ("duplicated points", torch.from_numpy(_grid_cloud(rng, 4, 512, 128)).to(DEV), 96)]
    fps_err = 0
    for name, pts, n in fps_cases:
        got = fps_indices(pts, n)
        torch.cuda.synchronize()
        want = fps_indices_torch(pts, n)
        torch.cuda.synchronize()
        diff = int((got.long() - want.long()).abs().max())
        if diff != 0 or got.dtype != torch.int32:
            raise AssertionError(f"fps kernel disagrees with its plain version at {name}: "
                                 f"{int((got != want).sum())} of {got.numel()} indices")
        fps_err = max(fps_err, diff)
        checks.append({"kernel": "fps", "case": name, "shape": [*pts.shape[:2], n], "equal": True})
    # ---- KNN -------------------------------------------------------------
    def knn_case(ref, g):
        return ref, ref[:, :g].contiguous()

    tie = torch.from_numpy(_grid_cloud(rng, 4, 512, 128)).to(DEV)
    serve_ref = cloud(SERVE_BATCH, NPOINTS)
    serve_centers = fps_gather(serve_ref, fps_indices(serve_ref, NUM_GROUP))
    knn_cases = [("serving (queries = FPS centers)", serve_ref, serve_centers, GROUP_SIZE),
                 ("serving x2", *knn_case(cloud(256, 1024), 64), 32),
                 ("M2AE scale 0", *knn_case(cloud(8, 2048), 512), 16),
                 ("ragged N=300", cloud(2, 300), cloud(2, 100), 7),
                 ("N=8192", *knn_case(cloud(4, 8192), 64), 32),
                 ("ties", *knn_case(tie, 96), 24)]
    knn_err = 0.0
    for name, ref, query, k in knn_cases:
        gd, gi = knn_indices(ref, query, k, return_dist=True)
        torch.cuda.synchronize()
        wd, wi = knn_indices_torch(ref, query, k, return_dist=True)
        torch.cuda.synchronize()
        if not torch.equal(gi, wi):
            raise AssertionError(f"knn kernel disagrees with its plain version at {name}: "
                                 f"{int((gi != wi).sum())} of {gi.numel()} indices")
        torch.testing.assert_close(gd, wd, rtol=1e-6, atol=0.0)
        knn_err = max(knn_err, float((gd - wd).abs().max()))
        checks.append({"kernel": "knn", "case": name,
                       "shape": [ref.shape[0], ref.shape[1], query.shape[1], k], "equal": True})
    try:
        knn_indices(cloud(1, 8), cloud(1, 4), 9)
    except ValueError:
        pass
    else:
        raise AssertionError("knn_indices accepted k > N")

    # ---- times at the serving shapes ------------------------------------
    pts = cloud(SERVE_BATCH, NPOINTS)
    b, n, g, k = SERVE_BATCH, NPOINTS, NUM_GROUP, GROUP_SIZE
    fps_ms = cuda_ms(lambda: fps_indices(pts, g))
    fps_plain = cuda_ms(lambda: fps_indices_torch(pts, g), runs=20, warmup=1)
    # per round and point: 3 subtractions, 3 products, 2 sums, 1 min, 1 compare
    fps_bound, fps_by = bound(b * n * 12 + b * g * 4, 10.0 * b * (g - 1) * n)
    centers = pts[:, :g].contiguous()
    knn_ms = cuda_ms(lambda: knn_indices(pts, centers, k))
    knn_plain = cuda_ms(lambda: knn_indices_torch(pts, centers, k), runs=20, warmup=1)
    knn_lib = cuda_ms(lambda: torch.topk(torch.cdist(centers, pts), k, dim=-1,
                                         largest=False, sorted=True))
    # per (query, point) pair: 8 flops for q2 - 2*cross + r2 with r2 and q2
    # given, and at least one comparison to select; r2 once per point (5)
    knn_bound, knn_by = bound(b * n * 12 + b * g * 12 + b * g * k * 8,
                              9.0 * b * g * n + 5.0 * b * n)
    timed = [
        {"name": "fps", "route": "cuda", "source": "gm3d_tpu_torch/csrc/fps.cu",
         "replaces": "gm3d_tpu/ops/fps.py:170", "shape": [b, n, g],
         "max_abs_err": fps_err, "ms": fps_ms, "plain_ms": fps_plain,
         "bound_ms": fps_bound, "bound_by": fps_by, "library_ms": None},
        {"name": "knn", "route": "cuda", "source": "gm3d_tpu_torch/csrc/knn.cu",
         "replaces": "gm3d_tpu/ops/knn.py:76", "shape": [b, n, g, k],
         "max_abs_err": knn_err, "ms": knn_ms, "plain_ms": knn_plain,
         "bound_ms": knn_bound, "bound_by": knn_by, "library_ms": knn_lib},
    ]
    # other shapes the package meets (not on the main path; times only)
    big = cloud(32, 8192)
    m2ae, m2ae_q = cloud(32, 2048), cloud(32, 512)
    others = [
        {"name": "fps", "shape": [32, 8192, 1024],
         "ms": cuda_ms(lambda: fps_indices(big, 1024), runs=10, warmup=1),
         "bound_ms": bound(32 * 8192 * 12 + 32 * 1024 * 4, 10.0 * 32 * 1023 * 8192)[0]},
        {"name": "knn", "shape": [32, 2048, 512, 16],
         "ms": cuda_ms(lambda: knn_indices(m2ae, m2ae_q, 16), runs=10, warmup=1),
         "bound_ms": bound(32 * 2048 * 12 + 32 * 512 * 12 + 32 * 512 * 16 * 8,
                           9.0 * 32 * 512 * 2048 + 5.0 * 32 * 2048)[0]},
    ]
    emit({"phase": "kernels", "checks": checks, "kernels": timed, "other_shapes": others})
    return timed


def _http(url: str, data: bytes | None = None, ctype: str = "application/json"):
    req = urllib.request.Request(url, data=data)
    if data is not None:
        req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def _export(out: str, *extra: str) -> str:
    return export_model.main(["--config", CONFIG, "--out", out, "--seed", "0",
                              "--device", "cuda", *extra])


def _agree(got: np.ndarray, want: np.ndarray, atol: float) -> float:
    """Logits within ``atol``; argmax equal wherever the reference's top-two
    margin exceeds ``atol``. Returns the largest absolute difference."""
    err = float(np.abs(got - want).max())
    if not (np.isfinite(got).all() and err <= atol):
        raise AssertionError(f"served logits differ from the CPU artifact by {err} > {atol}")
    top2 = np.sort(want, axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > atol
    if not np.array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure]):
        raise AssertionError("served argmax differs from the CPU artifact")
    return err


def phase_serve(tmp: str) -> dict:
    rng = np.random.default_rng(1)
    clouds = rng.standard_normal((300, NPOINTS, 3)).astype(np.float32)
    singles = rng.standard_normal((64, NPOINTS, 3)).astype(np.float32)
    art = _export(os.path.join(tmp, "cls_fp32.gm3dx"),
                  "--export_batch", str(SERVE_BATCH), "--input_points", str(NPOINTS))

    server = make_server(art, port=0, batch_wait_ms=5.0, dynamic_batching=True,
                         device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        # the main path: every launch count starts from 0 here
        fps_indices.launches = 0
        knn_indices.launches = 0
        status, health = _http(base + "/health")
        check(status == 200 and health == {"status": "ok"}, health)
        status, info = _http(base + "/info")
        check(status == 200 and info["input_shape"] == [SERVE_BATCH, NPOINTS, 3], info)
        check(info["model"] == "PointTransformer" and info["platforms"] == ["cuda"], info)
        status, one = _http(base + "/predict",
                            json.dumps({"points": clouds[0].tolist()}).encode())
        check(status == 200 and np.asarray(one["outputs"]).shape == (40,), status)
        buf = io.BytesIO()
        np.save(buf, clouds)
        status, many = _http(base + "/predict", buf.getvalue(), "application/octet-stream")
        check(status == 200, status)
        calls_before = server.batcher.device_calls
        answers: list = [None] * len(singles)

        def worker(w):
            for i in range(w, len(singles), 16):
                st, res = _http(base + "/predict",
                                json.dumps({"points": singles[i].tolist()}).encode())
                check(st == 200, st)
                answers[i] = res["outputs"]

        threads = [threading.Thread(target=worker, args=(w,)) for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        coalesced_calls = server.batcher.device_calls - calls_before
        try:
            _http(base + "/predict", b'{"points": [[1, 2]]}')
        except urllib.error.HTTPError as e:
            check(e.code == 400, e.code)
        else:
            raise AssertionError("a malformed cloud was not refused with 400")
        launches = {"fps": fps_indices.launches, "knn": knn_indices.launches}
    finally:
        server.shutdown()
        server.server_close()
        thread.join()

    if any(a is None for a in answers):
        raise AssertionError("a concurrent request got no answer")
    if not (launches["fps"] > 0 and launches["knn"] > 0):
        raise AssertionError(f"the serving path did not launch the kernels: {launches}")
    if not coalesced_calls < len(singles):
        raise AssertionError(f"{coalesced_calls} device calls for {len(singles)} requests")

    cpu = ServingModel(art, device="cpu")
    want = cpu.predict(np.concatenate([clouds, singles]))
    got = np.concatenate([np.asarray(many["outputs"], np.float32),
                          np.asarray(answers, np.float32)])
    check(got.shape == (364, 40), got.shape)
    err = _agree(got, want, atol=2e-3)
    _agree(np.asarray(one["outputs"], np.float32)[None], want[:1], atol=2e-3)

    # second, shorter pass: bf16 with the 8192 -> 1024 FPS inside the forward
    big = rng.standard_normal((40, 8192, 3)).astype(np.float32)
    art16 = _export(os.path.join(tmp, "cls_bf16.gm3dx"), "--bf16",
                    "--export_batch", "32", "--input_points", "8192")
    art32 = _export(os.path.join(tmp, "cls_fp32_8192.gm3dx"),
                    "--export_batch", "32", "--input_points", "8192")
    out16 = ServingModel(art16, device="cuda").predict(big)
    out32 = ServingModel(art32, device="cuda").predict(big)
    check(out16.shape == out32.shape == (40, 40), (out16.shape, out32.shape))
    check(np.isfinite(out16).all() and np.isfinite(out32).all(), "non-finite logits")
    same = float((out16.argmax(-1) == out32.argmax(-1)).mean())
    if same < 0.9:
        raise AssertionError(f"bf16 and fp32 artifacts agree on only {same:.0%} of clouds")

    res = {"phase": "serve", "requests": 2 + 1 + 1 + len(singles) + 1,
           "clouds": 1 + 300 + len(singles), "launches": launches,
           "device_calls_for_64_concurrent": coalesced_calls,
           "max_abs_err_vs_cpu": err, "bf16_argmax_agreement": same}
    emit(res)
    return {"launches": launches, "artifact": art}


def phase_throughput(tmp: str, art32: str) -> None:
    rng = np.random.default_rng(2)
    batch = rng.standard_normal((SERVE_BATCH, NPOINTS, 3)).astype(np.float32)
    art16 = _export(os.path.join(tmp, "cls_bf16_1024.gm3dx"), "--bf16",
                    "--export_batch", str(SERVE_BATCH), "--input_points", str(NPOINTS))
    out = {"phase": "throughput", "batch": SERVE_BATCH}
    for name, art in (("fp32", art32), ("bf16", art16)):
        model = ServingModel(art, device="cuda")
        x = torch.from_numpy(batch).to(DEV)
        for _ in range(3):
            model.predict(batch)
        windows = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(4):
                model.predict(batch)
            windows.append(4 * SERVE_BATCH / (time.perf_counter() - t0))
        with torch.inference_mode():
            dev_ms = cuda_ms(lambda: model.device_call(x), runs=10, warmup=2)
        out[name] = {"clouds_per_s_end_to_end": statistics.median(windows),
                     "clouds_per_s_device": SERVE_BATCH / dev_ms * 1e3,
                     "device_ms_per_batch": dev_ms}
    emit(out)


PHASES = ("env", "build", "kernels", "serve", "throughput")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list, a prefix of: " + ",".join(PHASES))
    phases = ap.parse_args().phases.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    env = phase_env()
    timed, served = [], None
    with tempfile.TemporaryDirectory() as tmp:
        if "build" in phases:
            phase_build()
        if "kernels" in phases:
            timed = phase_kernels()
        if "serve" in phases:
            served = phase_serve(tmp)
        if "throughput" in phases:
            phase_throughput(tmp, served["artifact"])
    if tuple(phases) != PHASES:
        raise SystemExit(f"partial run ({phases}): no result line")
    for kern in timed:
        kern["launches"] = served["launches"][kern["name"]]
    emit({"kernels": timed})
    print(env["gpu"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
