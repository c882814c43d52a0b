"""Stdlib HTTP micro-server over a :class:`ServingModel`.

Port of ``gm3d_tpu/serve/server.py``. Zero extra dependencies
(``http.server``), threaded, one process and one device.

Endpoints:
  GET  /health    -> {"status": "ok"}
  GET  /info      -> the artifact manifest
  POST /predict   -> body is either JSON {"points": [[[x,y,z],...],...]}
                     or a raw ``.npy`` array (Content-Type:
                     application/octet-stream); response is JSON
                     {"outputs": ..., "label": ...} (``label`` = argmax over
                     the last axis, only for classifier artifacts)

Contract violations (malformed body, wrong shape) answer 400; a failure on
the device answers 500. Segmentation artifacts are refused when the artifact
is loaded.
"""

from __future__ import annotations

import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from gm3d_tpu_torch.serve.batcher import DynamicBatcher
from gm3d_tpu_torch.serve.runner import ServingModel


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
                    }
                self._send(200, info)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/predict":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
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
            except (ValueError, KeyError, TypeError, EOFError) as e:
                # json.JSONDecodeError is a ValueError; TypeError covers
                # ragged nested lists np.asarray rejects
                self._send(400, {"error": str(e)})
                return
            try:
                out = backend.predict(points)
            except ValueError as e:  # shape contract violations -> client error
                self._send(400, {"error": str(e)})
                return
            except Exception as e:  # device/runtime failure -> server error
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            payload = {"outputs": out.tolist()}
            if model.manifest.get("mode") == "classifier":
                payload["label"] = np.argmax(out, axis=-1).tolist()
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
    ``num_devices``: only 1 for now; fan-out over several GPUs is not ported
    yet and raises ``ValueError``."""
    if num_devices != 1:
        raise ValueError(
            f"num_devices must be 1 (multi-device fan-out is not ported "
            f"yet), got {num_devices}")
    model = ServingModel(artifact_path, device=device)
    backend = DynamicBatcher(model, batch_wait_ms) if dynamic_batching else model
    server = _Server((host, port), _make_handler(model, backend))
    server.batcher = backend if isinstance(backend, DynamicBatcher) else None
    server.serving_model = model
    return server
