"""The port's span recorder (``gm3d_tpu_torch/utils/profiling.py``) on the CPU.

Off (no profiler, no ``recording()``) a span is one shared no-op and nothing
is kept; on, a span on any thread is kept with its parent and thread, on the
profiler's own clock; the two GM3D train steps give their stage spans in
order under ``step``; the data feed and the metrics pipeline give theirs.
"""

import threading
import time

import numpy as np
import pytest
import torch

from _torch_threads import torch_at_one_thread  # noqa: F401
from gm3d_tpu_torch.data.prefetch import device_prefetch
from gm3d_tpu_torch.models import GM3DStudent, PointM2AE, PointMAE
from gm3d_tpu_torch.train.optim import build_adamw, build_gm3d_shared_optimizer
from gm3d_tpu_torch.train.pretrain import make_gm3d_train_step, make_m2ae_gm3d_train_step
from gm3d_tpu_torch.train.state import create_train_state
from gm3d_tpu_torch.utils import profiling
from gm3d_tpu_torch.utils.pipeline import DeferredMetrics

SMALL = dict(trans_dim=48, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=48,
             decoder_depth=1, decoder_num_heads=2, drop_path_rate=0.0)
M2AE = dict(num_groups=(32, 16, 8), group_sizes=(8, 4, 4), encoder_depths=(1, 1, 1),
            encoder_dims=(24, 48, 96), local_radius=(0.32, 0.64, 1.28), decoder_dims=(96, 48),
            decoder_depths=(1, 1), num_heads=2)
SCALARS = {"keep_ratio": 0.5, "ema_decay": 0.99, "w_mse": 1.0, "w_cd": 1.0}
GM3D_STAGES = ["augment_group", "patch_embed", "ema_forward_mask", "student_forward", "teacher",
               "losses", "backward", "optimizer_ema"]
M2AE_STAGES = ["augment_hierarchy", "ema_forward_mask", "student_forward", "losses", "backward",
               "optimizer_ema"]


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_off_nothing_is_recorded_and_one_no_op_comes_back():
    a, b = profiling.span("a", k=1), profiling.span("b")
    step = profiling.step_span("cpu")
    assert a is b is step and not profiling.recording_on()
    with a, step:
        step.mark("x")
        assert profiling.current_span() is None
    assert profiling.spans() == [] and profiling.stage_ms() == [] and profiling.dropped() == 0


def test_a_span_on_a_second_thread_is_recorded_with_its_parent_and_thread():
    def work():
        with profiling.span("outer", side=True):
            with profiling.span("inner", n=2):
                seen.append(profiling.current_span())

    seen = []
    with _profiler():
        with profiling.span("main"):
            t = threading.Thread(target=work, name="second")
            t.start()
            t.join(timeout=60)
    assert not t.is_alive()
    by = {r["name"]: r for r in profiling.spans()}
    assert set(by) == {"main", "outer", "inner"}
    assert by["inner"]["parent"] == by["outer"]["id"] and seen == [by["inner"]["id"]]
    assert by["outer"]["parent"] is None and by["main"]["parent"] is None
    assert by["inner"]["thread"] == by["outer"]["thread"] == "second"
    assert by["main"]["thread"] == threading.main_thread().name
    assert by["outer"]["attrs"] == {"side": True} and by["inner"]["attrs"] == {"n": 2}
    for r in by.values():
        assert r["start_ns"] <= r["end_ns"]
    assert by["outer"]["start_ns"] <= by["inner"]["start_ns"] <= by["inner"]["end_ns"] \
        <= by["outer"]["end_ns"]
    # after the profiler: off again
    with profiling.span("late"):
        pass
    assert len(profiling.spans()) == 3


def test_a_span_open_when_the_profiler_stops_is_kept():
    prof = _profiler()
    prof.start()
    s = profiling.span("open")
    s.__enter__()
    prof.stop()
    s.__exit__(None, None, None)
    assert [r["name"] for r in profiling.spans()] == ["open"]


def test_spans_lie_on_the_profilers_clock():
    with _profiler() as prof:
        for i in range(20):
            with profiling.span(f"clock.{i}"):
                time.sleep(0.001)
    ours = {r["name"]: r for r in profiling.spans()}
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name() in ours}
    assert set(events) == set(ours)
    for name, r in ours.items():
        e = events[name]
        start = e.start_ns()
        end = start + e.duration_ns()
        assert abs(start - r["start_ns"]) < 2e6 and abs(r["end_ns"] - end) < 2e6


def test_past_the_cap_spans_are_counted(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 2)
    with profiling.recording():
        for _ in range(5):
            with profiling.span("s"):
                pass
    assert len(profiling.spans()) == 2 and profiling.dropped() == 3
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_a_step_that_raises_closes_its_open_stage():
    with profiling.recording():
        with pytest.raises(RuntimeError):
            with profiling.step_span("cpu") as st:
                st.mark("first")
                st.mark("second")
                raise RuntimeError("inside the second stage")
        assert profiling.current_span() is None
    by = {r["name"]: r for r in profiling.spans()}
    assert set(by) == {"step", "step.first", "step.second"}
    assert by["step.first"]["end_ns"] <= by["step.second"]["start_ns"] <= \
        by["step.second"]["end_ns"] <= by["step"]["end_ns"]
    assert [list(s) for s in profiling.stage_ms()] == [["first", "second"]]


def _stage_names(records, step_id):
    return [r["name"] for r in sorted(records, key=lambda r: r["start_ns"])
            if r["parent"] == step_id]


def _check_steps(stages, steps):
    records = profiling.spans()
    step_ids = [r["id"] for r in sorted(records, key=lambda r: r["start_ns"])
                if r["name"] == "step"]
    assert len(step_ids) == steps
    for sid in step_ids:
        assert _stage_names(records, sid) == [f"step.{s}" for s in stages]
    per_step = profiling.stage_ms()
    assert [list(s) for s in per_step] == [stages] * steps
    assert all(ms >= 0 for s in per_step for ms in s.values())


def test_gm3d_step_stages_in_order_under_step():
    gen = torch.Generator().manual_seed(0)
    student, teacher = GM3DStudent(**SMALL), PointMAE(**SMALL)
    student.reset_parameters(gen)
    teacher.reset_parameters(gen)
    optimizer = build_gm3d_shared_optimizer(student, 1e-3)
    state = create_train_state(student, optimizer, with_ema=True)
    step = make_gm3d_train_step(student, teacher, optimizer, device="cpu")
    pts = torch.randn((2, 64, 3), generator=gen) * 0.5
    state, _ = step(state, pts, gen, SCALARS)  # outside any profiler
    assert profiling.spans() == [] and profiling.stage_ms() == []
    with _profiler():
        for _ in range(2):
            state, metrics = step(state, pts, gen, SCALARS)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    _check_steps(GM3D_STAGES, 2)


def test_m2ae_step_stages_in_order_under_step():
    gen = torch.Generator().manual_seed(1)
    model = PointM2AE(**M2AE)
    model.reset_parameters(gen)
    optimizer = build_adamw(model.named_parameters(), 1e-3, grad_clip=5.0)
    state = create_train_state(model, optimizer, with_ema=True)
    step = make_m2ae_gm3d_train_step(model, optimizer, device="cpu")
    pts = torch.randn((2, 128, 3), generator=gen) * 0.5
    state, _ = step(state, pts, gen, SCALARS)
    assert profiling.spans() == []
    with profiling.recording():
        state, metrics = step(state, pts, gen, SCALARS)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    _check_steps(M2AE_STAGES, 1)


def test_the_feed_and_the_pipeline_give_their_spans():
    batches = [np.full((2, 4, 3), i, np.float32) for i in range(3)]
    drained = []
    dm = DeferredMetrics(drained.append, depth=1)
    with profiling.recording():
        for pts in device_prefetch(batches, device="cpu"):
            dm.push(int(pts[0, 0, 0]))
        dm.flush()
    assert drained == [0, 1, 2]
    records = profiling.spans()
    names = [r["name"] for r in records]
    # a wait a batch and one for the end; a pull a batch, then one after each of the
    # last two batches (two ahead) that finds the end
    assert names.count("data.next") == 4 and names.count("data.loader") == 5
    assert names.count("data.to_device") == 3 and names.count("pipeline.drain") == 3
    nexts = {r["id"] for r in records if r["name"] == "data.next"}
    assert all(r["parent"] in nexts for r in records
               if r["name"] in ("data.loader", "data.to_device"))
