"""The open-loop HTTP load generator of the serving cells.

``schedule(seed, params, seconds)`` is the traffic: a pure function of the
seed, which the benchmark and this generator both call. Every seed gets the
same requests and the same gaps between them, in another order, so the work
of a window does not change with the seed:

  - request sizes: ``n`` clouds a request at the quantiles of P(k) ~ k^-alpha
    on 1 .. ``k_max``;
  - gaps: the quantiles of an exponential distribution (Poisson arrivals),
    scaled so that the ``n`` requests span the window;
  - ``n`` = rate (clouds/s) x seconds / mean k; each request's clouds are
    drawn from a bank of clouds, uniformly.

Run as ``python3 -m benchmark.traffic.http_load`` (a child process of the
benchmark; numpy only, it never touches the device). Protocol on its
standard streams:

  1. in: one JSON line (``port``, ``seed``, ``seconds``, ``params``,
     ``npoints``, ``bank``) and then the bank, ``bank`` x
     ``npoints`` x 3 float32, raw;
  2. it sends ``warmup_requests`` requests closed-loop over
     ``warmup_connections`` connections, then writes ``warm``;
  3. in: ``go``. It sends request i when it is due (``t0`` + due), each over
     one of ``connections`` connections (kept alive where the server keeps
     them), and times it from its due time to the end of its answer;
  4. out: one JSON line with every request's latency, status and lateness
     (send time - due time), the outputs of the ``sample`` requests, and the
     clouds answered inside the window.
"""

from __future__ import annotations

import asyncio
import io
import json
import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np

ANSWER_WAIT_S = 60.0


def k_distribution(k_max: int, alpha: float) -> np.ndarray:
    """P(k) for k = 1 .. k_max."""
    p = np.arange(1, k_max + 1, dtype=np.float64) ** -alpha
    return p / p.sum()


def schedule(seed: int, params: dict, seconds: float) -> dict:
    """``due`` (s after the window opens), ``k`` and ``clouds`` (bank
    indices) of every request, and ``sample``: the requests whose answers
    are compared with the reference, drawn from the seed, with the largest
    requests among them."""
    p = k_distribution(params["k_max"], params["k_alpha"])
    mean_k = float((np.arange(1, len(p) + 1) * p).sum())
    n = max(2, int(round(params["rate_clouds_per_s"] * seconds / mean_k)))
    q = (np.arange(n) + 0.5) / n
    ks = np.searchsorted(np.cumsum(p), q) + 1
    gaps = -np.log1p(-q)
    gaps *= seconds / gaps.sum()
    rng = np.random.default_rng(int(seed))
    ks = rng.permutation(ks)
    gaps = rng.permutation(gaps)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    clouds = [rng.integers(0, params["bank_clouds"], size=int(k)).tolist() for k in ks]
    rand = rng.choice(n, size=min(n, params["sample_requests"]), replace=False)
    largest = np.argsort(-ks, kind="stable")[: params["sample_largest"]]
    sample = sorted(set(rand.tolist()) | set(largest.tolist()))
    return {"due": due.tolist(), "k": ks.tolist(), "clouds": clouds, "sample": sample,
            "mean_k": mean_k}


def _body(bank: np.ndarray, idx: List[int]) -> bytes:
    buf = io.BytesIO()
    np.save(buf, bank[idx], allow_pickle=False)
    return buf.getvalue()


class _Conn:
    """One client connection; reopened whenever the server closed it."""

    def __init__(self, port: int):
        self.port = port
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None

    async def request(self, body: bytes) -> tuple:
        if self.writer is None:
            self.reader, self.writer = await asyncio.open_connection("127.0.0.1", self.port)
        head = (f"POST /predict HTTP/1.1\r\nHost: 127.0.0.1\r\nConnection: keep-alive\r\n"
                f"Content-Type: application/octet-stream\r\nContent-Length: {len(body)}\r\n\r\n")
        try:
            self.writer.write(head.encode() + body)
            await self.writer.drain()
            raw = await self.reader.readuntil(b"\r\n\r\n")
            lines = raw.decode("latin-1").split("\r\n")
            version, status = lines[0].split(" ")[:2]
            headers = {ln.split(":", 1)[0].strip().lower(): ln.split(":", 1)[1].strip()
                       for ln in lines[1:] if ":" in ln}
            payload = await self.reader.readexactly(int(headers.get("content-length", 0)))
        except (OSError, asyncio.IncompleteReadError, ValueError, IndexError):
            self.close()
            raise
        keep = (headers.get("connection", "").lower() == "keep-alive"
                or (version == "HTTP/1.1" and headers.get("connection", "").lower() != "close"))
        if not keep:
            self.close()
        return int(status), payload

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
        self.reader = self.writer = None


def _check_answer(status: int, payload: bytes, k: int, keep: bool):
    """(ok, outputs or None): a 200 whose JSON holds k rows of outputs and k
    labels, each label the arg-max of its row."""
    if status != 200:
        return False, None
    try:
        body = json.loads(payload)
        outputs, labels = body["outputs"], body["label"]
        ok = (len(outputs) == k and len(labels) == k
              and all(int(np.argmax(o)) == lab for o, lab in zip(outputs, labels)))
    except (ValueError, KeyError, TypeError):
        return False, None
    return ok, (outputs if keep and ok else None)


async def _run(port: int, bank: np.ndarray, plan: dict, params: dict, seconds: float,
               wait_go) -> dict:
    n = len(plan["due"])
    conns = [_Conn(port) for _ in range(params["connections"])]
    sample = set(plan["sample"])
    # warm-up: closed loop over the mix's first requests, not timed
    warm_q: asyncio.Queue = asyncio.Queue()
    for i in range(params["warmup_requests"]):
        warm_q.put_nowait(i % n)

    async def warm_worker(conn):
        while not warm_q.empty():
            i = warm_q.get_nowait()
            await conn.request(_body(bank, plan["clouds"][i]))

    await asyncio.gather(*(warm_worker(c) for c in conns[: params["warmup_connections"]]))
    await wait_go()

    queue: asyncio.Queue = asyncio.Queue()
    latency = [math.inf] * n
    late = [0.0] * n
    done_at = [math.inf] * n
    ok = [False] * n
    outputs: Dict[int, list] = {}
    t0 = time.perf_counter()

    async def worker(conn):
        while True:
            i = await queue.get()
            if i is None:
                return
            due = t0 + plan["due"][i]
            late[i] = time.perf_counter() - due
            try:
                status, payload = await conn.request(_body(bank, plan["clouds"][i]))
            except (OSError, asyncio.IncompleteReadError, ValueError, IndexError):
                continue
            now = time.perf_counter()
            ok[i], out = _check_answer(status, payload, plan["k"][i], i in sample)
            if ok[i]:
                latency[i] = (now - due) * 1e3
                done_at[i] = now - t0
            if out is not None:
                outputs[i] = out

    workers = [asyncio.ensure_future(worker(c)) for c in conns]
    for i in range(n):
        delay = t0 + plan["due"][i] - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        queue.put_nowait(i)
    for _ in workers:
        queue.put_nowait(None)
    try:
        await asyncio.wait_for(asyncio.gather(*workers), timeout=seconds + ANSWER_WAIT_S)
    except asyncio.TimeoutError:
        for w in workers:
            w.cancel()
    for c in conns:
        c.close()
    in_window = sum(k for k, t, good in zip(plan["k"], done_at, ok) if good and t <= seconds)
    return {"latency_ms": latency, "ok": ok, "late_ms": [x * 1e3 for x in late],
            "done_s": done_at, "k": plan["k"], "outputs": {str(i): o for i, o in outputs.items()},
            "clouds_answered_in_window": in_window}


def main() -> int:
    header = json.loads(sys.stdin.buffer.readline())
    count, npoints = header["bank"], header["npoints"]
    raw = sys.stdin.buffer.read(count * npoints * 3 * 4)
    bank = np.frombuffer(raw, dtype=np.float32).reshape(count, npoints, 3)
    params, seconds = header["params"], header["seconds"]
    plan = schedule(header["seed"], params, seconds)

    async def wait_go():
        sys.stdout.write("warm\n")
        sys.stdout.flush()
        loop = asyncio.get_running_loop()
        line = await loop.run_in_executor(None, sys.stdin.readline)
        if line.strip() != "go":
            raise SystemExit("expected go")

    result = asyncio.run(_run(header["port"], bank, plan, params, seconds, wait_go))
    sys.stdout.write(json.dumps(result, allow_nan=True) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
