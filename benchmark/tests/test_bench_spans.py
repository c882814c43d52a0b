"""The metrics that read the port's own spans, on hand-made span records:
each file's ``read(ctx)`` against a count by hand, and None where its spans
are absent (a program without the recorder gives none)."""

import pytest

from benchmark.harness import spans
from benchmark.harness.cell import load_module
from benchmark.harness.env import BENCH

MS = 1_000_000  # ns


def _read(name, monkeypatch, records=None, steps=None):
    monkeypatch.setattr(spans, "recorded", lambda: records)
    monkeypatch.setattr(spans, "stage_steps", lambda: steps)
    module = load_module(BENCH / "metrics" / f"{name}.py", "metric_" + name.replace(".", "_"))
    return module.read(None)


def _span(name, sid, start_ms, end_ms, parent=None, **attrs):
    return {"name": name, "id": sid, "parent": parent, "thread": "t",
            "start_ns": int(start_ms * MS), "end_ns": int(end_ms * MS), "attrs": attrs}


STEPS = [{"augment_group": 1.0, "patch_embed": 8.0, "ema_forward_mask": 40.0,
          "student_forward": 55.0, "teacher": 33.0, "losses": 4.0, "backward": 145.0,
          "optimizer_ema": 30.0},
         {"augment_group": 1.0, "patch_embed": 8.0, "ema_forward_mask": 44.0,
          "student_forward": 57.0, "teacher": 31.0, "losses": 4.0, "backward": 147.0,
          "optimizer_ema": 24.0}]


@pytest.mark.parametrize("name,want", [
    ("step.ema_pass_ms.train", 42.0), ("step.student_ms.train", 56.0),
    ("step.teacher_ms.train", 32.0), ("step.backward_ms.train", 146.0),
    ("step.optimizer_ms.train", 27.0)])
def test_stage_metrics_are_the_mean_over_steps(name, want, monkeypatch):
    assert _read(name, monkeypatch, steps=STEPS) == pytest.approx(want)
    # a step without the stage (M2AE has no teacher), none recorded, no recorder
    m2ae = [{k: v for k, v in s.items() if k != "teacher"} for s in STEPS]
    assert _read("step.teacher_ms.train", monkeypatch, steps=m2ae) is None
    assert _read(name, monkeypatch, steps=[]) is None
    assert _read(name, monkeypatch, steps=None) is None


def test_loader_wait_per_batch(monkeypatch):
    records = [_span("data.loader", 2, 0.0, 1.5, parent=1), _span("data.to_device", 3, 1.5, 2.0, 1),
               _span("data.next", 1, 0.0, 2.5),
               _span("data.loader", 5, 10.0, 10.5, parent=4), _span("data.next", 4, 10.0, 11.0),
               _span("step", 6, 11.0, 300.0)]
    # 1.5 + 0.5 ms of pulls over 2 batches
    assert _read("data.loader_wait_ms.train", monkeypatch, records) == pytest.approx(1.0)
    assert _read("data.loader_wait_ms.train", monkeypatch, records[-1:]) is None
    assert _read("data.loader_wait_ms.train", monkeypatch, None) is None


def test_handler_self_time(monkeypatch):
    records = [_span("serve.parse", 2, 0.0, 3.0, parent=1),
               _span("serve.wait", 3, 3.0, 40.0, parent=1),
               _span("serve.encode", 4, 40.0, 42.0, parent=1),
               _span("serve.request", 1, 0.0, 42.0),
               _span("serve.parse", 6, 50.0, 50.5, parent=5),
               _span("serve.wait", 7, 50.5, 59.0, parent=5),
               _span("serve.encode", 8, 59.0, 60.0, parent=5),
               _span("serve.request", 5, 50.0, 60.0),
               # the parse and encode of a request that began before the profiler
               _span("serve.parse", 9, 0.0, 30.0), _span("serve.encode", 10, 70.0, 80.0)]
    # (3 + 2) and (0.5 + 1)
    assert _read("serve.handler_ms.steady", monkeypatch, records) == pytest.approx(3.25)
    assert _read("serve.handler_ms.steady", monkeypatch, records[-2:]) is None


def test_queue_wait_per_cloud(monkeypatch):
    records = [_span("batcher.call", 1, 0.0, 20.0, clouds=3, queue_wait_s=0.012, waits=[7]),
               _span("batcher.call", 2, 20.0, 40.0, clouds=5, queue_wait_s=0.004, waits=[8, 9]),
               # a call whose attributes were not built: recording began inside it
               _span("batcher.call", 3, 40.0, 43.0)]
    # 16 ms over 8 clouds
    assert _read("batcher.queue_ms.steady", monkeypatch, records) == pytest.approx(2.0)
    assert _read("batcher.queue_ms.steady", monkeypatch, records[2:]) is None


def test_handoff_from_the_last_call_to_the_waits_end(monkeypatch):
    records = [_span("batcher.call", 1, 0.0, 20.0, clouds=3, queue_wait_s=0.0, waits=[7, 8]),
               _span("batcher.call", 2, 20.0, 40.0, clouds=5, queue_wait_s=0.0, waits=[8]),
               _span("batcher.call", 3, 40.0, 43.0),
               _span("serve.wait", 7, 0.0, 21.0, parent=5),
               _span("serve.wait", 8, 0.0, 43.0, parent=6),
               # a wait no recorded call lists
               _span("serve.wait", 9, 0.0, 90.0, parent=10)]
    # 21 - 20 and 43 - 40 (its last call)
    assert _read("batcher.handoff_ms.steady", monkeypatch, records) == pytest.approx(2.0)
    assert _read("batcher.handoff_ms.steady", monkeypatch, records[2:]) is None
    assert _read("batcher.handoff_ms.steady", monkeypatch, None) is None


def test_runner_host_per_call(monkeypatch):
    records = []
    for k, t in enumerate((0.0, 100.0)):
        records += [_span("runner.pad", 10 * k + 1, t, t + 0.5, parent=99),
                    _span("runner.copy_in", 10 * k + 2, t + 0.5, t + 2.0, parent=99),
                    _span("runner.launch", 10 * k + 3, t + 2.0, t + 9.0, parent=99),
                    _span("runner.read_back", 10 * k + 4, t + 9.0, t + 30.0, parent=99)]
    # (0.5 + 1.5 + 7) a call; the read back is not the host's own work
    assert _read("runner.host_ms.steady", monkeypatch, records) == pytest.approx(9.0)
    assert _read("runner.host_ms.steady", monkeypatch, []) is None
    # and 21 ms of read back a call
    assert _read("runner.read_back_ms.steady", monkeypatch, records) == pytest.approx(21.0)
    assert _read("runner.read_back_ms.steady", monkeypatch, records[3::4]) is None


def test_no_recorder_reads_none(monkeypatch):
    import gm3d_tpu_torch.utils.profiling as profiling

    assert spans.recorded() == profiling.spans()
    monkeypatch.delattr(profiling, "stage_ms")
    assert spans.recorded() is None and spans.stage_steps() is None
