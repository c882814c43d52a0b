"""What the per-layer metrics read of the port's own spans
(``gm3d_tpu_torch/utils/profiling.py``): the records and the train steps'
stage times that its recorder kept while the traced stretch's profiler ran,
which is the only time it records in a run of the benchmark.

Each reader takes the records (or the steps' stage times) and returns None
where the spans it needs are absent, as in a program without the recorder.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def _recorder():
    try:
        from gm3d_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") and hasattr(profiling, "stage_ms") else None


def recorded() -> Optional[List[dict]]:
    """The recorder's span records, or None without a recorder."""
    rec = _recorder()
    return rec.spans() if rec is not None else None


def stage_steps() -> Optional[List[Dict[str, float]]]:
    """Each recorded train step's stage -> stream ms, or None without a recorder."""
    rec = _recorder()
    return rec.stage_ms() if rec is not None else None


def _ms(r: dict) -> float:
    return (r["end_ns"] - r["start_ns"]) * 1e-6


def stage_mean_ms(steps, stage: str) -> Optional[float]:
    """The mean over the recorded steps of one stage's ms."""
    values = [s[stage] for s in steps or () if stage in s]
    return sum(values) / len(values) if values else None


def loader_wait_ms(records) -> Optional[float]:
    """The host's ms in the pull from the ``DataLoader`` (``data.loader``)
    per batch handed to the step (``data.next``)."""
    records = records or ()
    waits = sum(1 for r in records if r["name"] == "data.next")
    pulls = [_ms(r) for r in records if r["name"] == "data.loader"]
    return sum(pulls) / waits if waits and pulls else None


def handler_ms(records) -> Optional[float]:
    """The mean self time of a request in the HTTP handler: its body's read
    and decode (``serve.parse``) and its answer's encode and send
    (``serve.encode``), over the requests (``serve.request``)."""
    records = records or ()
    requests = {r["id"] for r in records if r["name"] == "serve.request"}
    own = sum(_ms(r) for r in records
              if r["name"] in ("serve.parse", "serve.encode") and r["parent"] in requests)
    return own / len(requests) if requests else None


def queue_ms(records) -> Optional[float]:
    """The mean wait of a cloud in the batcher's queue, from its enqueue to
    the start of its device call (``batcher.call``'s ``queue_wait_s`` over its
    ``clouds``)."""
    calls = [r["attrs"] for r in records or ()
             if r["name"] == "batcher.call" and "clouds" in r["attrs"]]
    clouds = sum(c["clouds"] for c in calls)
    return 1e3 * sum(c["queue_wait_s"] for c in calls) / clouds if clouds else None


def handoff_ms(records) -> Optional[float]:
    """The mean time from the end of the last device call that served a
    request to the end of the request's wait (``serve.wait``): the batcher
    handing the answer to the handler's thread, and that thread waking. A
    ``batcher.call`` lists the waits it served in ``waits``."""
    records = records or ()
    served: Dict[int, int] = {}
    for r in records:
        if r["name"] == "batcher.call":
            for w in r["attrs"].get("waits", ()):
                served[w] = max(served.get(w, 0), r["end_ns"])
    gaps = [(r["end_ns"] - served[r["id"]]) * 1e-6 for r in records
            if r["name"] == "serve.wait" and r["id"] in served]
    return sum(gaps) / len(gaps) if gaps else None


def runner_host_ms(records) -> Optional[float]:
    """The host's ms a device call in the runner: padding, the copy in and
    the launch (``runner.pad``, ``runner.copy_in``, ``runner.launch``)."""
    records = records or ()
    calls = sum(1 for r in records if r["name"] == "runner.launch")
    host = sum(_ms(r) for r in records
               if r["name"] in ("runner.pad", "runner.copy_in", "runner.launch"))
    return host / calls if calls else None


def read_back_ms(records) -> Optional[float]:
    """The host's ms a device call in the runner's read back
    (``runner.read_back``: the wait for the device and the copy out), over
    the launches."""
    records = records or ()
    calls = sum(1 for r in records if r["name"] == "runner.launch")
    back = sum(_ms(r) for r in records if r["name"] == "runner.read_back")
    return back / calls if calls else None
