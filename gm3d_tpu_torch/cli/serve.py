"""Serve an exported ``.gm3dx`` artifact over HTTP.

  python -m gm3d_tpu_torch.cli.serve --artifact model.gm3dx --port 8765

One process; ``--num_devices N`` (``-1``: every local GPU) fans request
chunks out over N GPUs, one loaded program each. See
``gm3d_tpu_torch/serve/server.py`` for the endpoint contract.
"""

from __future__ import annotations

import argparse
import signal
from typing import Optional, Sequence

from gm3d_tpu_torch.cli.common import add_device_arg
from gm3d_tpu_torch.utils import get_logger


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="serve a .gm3dx artifact")
    p.add_argument("--artifact", required=True, help=".gm3dx path")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--batch_wait_ms", type=float, default=3.0,
                   help="dynamic batching: max time a lone request waits for "
                        "company before dispatching (latency bound)")
    p.add_argument("--no-dynamic_batching", dest="dynamic_batching",
                   action="store_false", default=True,
                   help="dispatch each request as its own padded batch "
                        "instead of coalescing concurrent requests")
    p.add_argument("--num_devices", type=int, default=1,
                   help="fan request chunks out over this many local GPUs "
                        "(-1: all; 1: the single-device path)")
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    logger = get_logger("gm3d.serve")
    from gm3d_tpu_torch.serve.server import make_server

    server = make_server(args.artifact, args.host, args.port,
                         batch_wait_ms=args.batch_wait_ms,
                         dynamic_batching=args.dynamic_batching,
                         num_devices=args.num_devices, device=args.device)
    host, port = server.server_address[:2]
    mode = (f"dynamic batching, wait<={args.batch_wait_ms}ms"
            if args.dynamic_batching else "per-request dispatch")
    if len(server.serving_model.devices) > 1:
        mode += f"; fan-out over {len(server.serving_model.devices)} devices"
    logger.info(f"serving {args.artifact} on http://{host}:{port} "
                f"({mode}; device {args.device}; GET /health /info, POST /predict)")

    # orchestrators stop containers with SIGTERM; route it through the same
    # graceful path as ctrl-C (serve_forever unwinds, batcher drains + joins)
    def _sigterm(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
