"""Stdlib HTTP micro-server over a :class:`ServingModel`.

Port of ``gm3d_tpu/serve/server.py``. Zero extra dependencies
(``http.server``), threaded, one process; one device, or the local GPUs
with ``num_devices`` (the chunks of a request round-robin over them).

Endpoints:
  GET  /health    -> {"status": "ok"}
  GET  /info      -> the artifact manifest (its ``platforms`` among it)
  POST /predict   -> body is either JSON {"points": [[[x,y,z],...],...]}
                     or a raw ``.npy`` array (Content-Type:
                     application/octet-stream); response is JSON
                     {"outputs": ..., "label": ...} (``label`` = argmax over
                     the last axis, for classifier artifacts)

A segmentation artifact takes JSON only, {"points": ..., "cls_label": ...}
with each cloud's object category, and answers {"label": ...}: per-point
part labels by the category-restricted arg-max of the manifest's
category -> parts table (``train/segmentation.py::
category_restricted_argmax``); the per-point logits come back under
``outputs`` only when the body asks with ``"return_logits": true``.

Contract violations (malformed body, wrong shape, missing or out-of-range
labels) answer 400; a failure on the device answers 500.
"""

from __future__ import annotations

import io
import json
import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from gm3d_tpu_torch.serve.batcher import DynamicBatcher
from gm3d_tpu_torch.serve.runner import ServingModel
from gm3d_tpu_torch.train.segmentation import category_restricted_argmax
from gm3d_tpu_torch.utils.device import resolve_device
from gm3d_tpu_torch.utils.profiling import span


def _seg_labels(logits: np.ndarray, cls_label, manifest: dict) -> np.ndarray:
    """Per-point part ids from seg logits: the category-restricted arg-max
    by the manifest's category -> parts table (``serve/export.py`` refuses
    a segmentation manifest without it; the runner refuses a request
    without ``cls_label``)."""
    single = logits.ndim == 2
    if single:
        logits = logits[None]
    labels = np.atleast_1d(np.asarray(cls_label))
    pred = category_restricted_argmax(logits, labels, manifest["seg_classes"],
                                      manifest["cls_names"])
    return pred[0] if single else pred


def _make_handler(model: ServingModel, backend):
    class Handler(BaseHTTPRequestHandler):
        # quiet the per-request stderr lines; the CLI logs startup/shutdown
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/health":
                self._send(200, {"status": "ok"})
            elif self.path == "/info":
                info = model.info
                if isinstance(backend, DynamicBatcher):
                    info["dynamic_batching"] = {
                        "max_wait_ms": backend.max_wait * 1000.0,
                        "device_calls": backend.device_calls,
                        "clouds_served": backend.clouds_served,
                        "queue_wait_s": backend.queue_wait_s,
                    }
                self._send(200, info)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/predict":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            with span("serve.request"):
                self._predict()

        def _predict(self):
            cls_label = None
            return_logits = True
            try:
                with span("serve.parse"):
                    length = int(self.headers.get("Content-Length", 0))
                    blob = self.rfile.read(length)
                    ctype = self.headers.get("Content-Type", "application/json")
                    if ctype.startswith("application/octet-stream"):
                        points = np.load(io.BytesIO(blob), allow_pickle=False)
                    else:
                        body = json.loads(blob)
                        if not isinstance(body, dict) or "points" not in body:
                            raise ValueError(
                                'body must be a JSON object {"points": [...]}')
                        points = np.asarray(body["points"], np.float32)
                        if "cls_label" in body:
                            cls_label = np.asarray(body["cls_label"])
                        if model.manifest.get("mode") == "segmentation":
                            # per-point logits are large; opt-in only
                            return_logits = bool(body.get("return_logits", False))
            except (ValueError, KeyError, TypeError, EOFError) as e:
                # json.JSONDecodeError is a ValueError; TypeError covers
                # ragged nested lists np.asarray rejects
                self._send(400, {"error": str(e)})
                return
            try:
                with span("serve.wait"):
                    out = backend.predict(points, cls_label)
            except ValueError as e:  # shape contract violations -> client error
                self._send(400, {"error": str(e)})
                return
            except Exception as e:  # device/runtime failure -> server error
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            with span("serve.encode"):
                payload = {"outputs": out.tolist()} if return_logits else {}
                mode = model.manifest.get("mode")
                if mode == "classifier":
                    payload["label"] = np.argmax(out, axis=-1).tolist()
                elif mode == "segmentation":
                    payload["label"] = _seg_labels(out, cls_label, model.manifest).tolist()
                self._send(200, payload)

    return Handler


class _Server(ThreadingHTTPServer):
    """ThreadingHTTPServer that owns an optional DynamicBatcher; closing the
    server stops the batcher thread (pending requests are served first)."""

    batcher: DynamicBatcher | None = None

    def server_close(self):
        if self.batcher is not None:
            self.batcher.close()
        super().server_close()


def serving_devices(num_devices: int, device="cuda") -> Optional[List[torch.device]]:
    """The fan-out list of ``make_server``: None for one device, else
    ``cuda:0 .. cuda:n-1`` (``-1``: every visible GPU) or ``n`` times the CPU."""
    if num_devices < -1 or num_devices == 0:
        raise ValueError(f"num_devices must be -1 (all local devices) or >= 1, "
                         f"got {num_devices}")
    if num_devices == 1:
        return None
    dev = resolve_device(device)
    if dev.type == "cpu":
        if num_devices == -1:
            raise ValueError("num_devices -1 (all local GPUs) needs a CUDA device")
        return [dev] * num_devices
    local = torch.cuda.device_count()
    if num_devices > local:
        logging.getLogger("gm3d.serve").warning(
            "requested %d serving devices but only %d are local; using %d",
            num_devices, local, local)
    n = local if num_devices == -1 else min(num_devices, local)
    return [torch.device("cuda", i) for i in range(n)]


def make_server(artifact_path: str, host: str = "127.0.0.1", port: int = 0,
                batch_wait_ms: float = 3.0,
                dynamic_batching: bool = True,
                num_devices: int = 1,
                device="cuda") -> ThreadingHTTPServer:
    """Build (but don't start) the server; ``port=0`` picks a free port
    (``server.server_address[1]`` reports it).

    ``dynamic_batching`` coalesces concurrent requests into shared device
    calls (see ``serve/batcher.py``); off = each request dispatches its own
    padded batch.

    ``device``: where the model runs; ``"cuda"`` raises without a GPU.
    ``num_devices``: fan request chunks out over this many local GPUs
    (``-1``: all of them; more than there are: all, with a warning), one
    loaded program each (``ServingModel(devices=...)``); on the CPU, this
    many replicas. 1 keeps the single-device path."""
    model = ServingModel(artifact_path, device=device,
                         devices=serving_devices(num_devices, device))
    backend = DynamicBatcher(model, batch_wait_ms) if dynamic_batching else model
    server = _Server((host, port), _make_handler(model, backend))
    server.batcher = backend if isinstance(backend, DynamicBatcher) else None
    server.serving_model = model
    return server
