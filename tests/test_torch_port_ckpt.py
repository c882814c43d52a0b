"""The port's checkpoints, asynchronous writer, preemption guard, trace
reader and the orbax converter (CPU).

``gm3d_tpu_torch.ckpt.checkpoint`` against ``gm3d_tpu.ckpt.checkpoint``: a
round trip restores modules, BN buffers, EMA and optimizer bit for bit (and
the next step from the restored state equals the next step from the live
one, exactly: the CPU is deterministic); retention and skipping follow
orbax's; the JSON sidecars are byte-equal to the JAX functions' files. The
writer is held to ``tests/test_async_ckpt.py``'s semantics, with the port's
own hazard added: the live state is updated IN PLACE after ``submit``. The
converter (``tools/orbax_to_torch.py``) carries a JAX Point-MAE across, and
the two encode the same clouds to ``atol=1e-5`` (fp32, other summation
orders through two blocks).
"""

import importlib.util
import json
import pathlib
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gm3d_tpu import ckpt as jckpt
from gm3d_tpu.models import PointMAE as JPointMAE
from gm3d_tpu_torch.ckpt import async_writer as aw
from gm3d_tpu_torch.ckpt import checkpoint as ck
from gm3d_tpu_torch.cli import pretrain as cli
from gm3d_tpu_torch.models import GM3DStudent, PointMAE
from gm3d_tpu_torch.train.optim import build_gm3d_shared_optimizer
from gm3d_tpu_torch.train.pretrain import make_gm3d_train_step
from gm3d_tpu_torch.train.state import create_train_state
from gm3d_tpu_torch.utils.preempt import PreemptionGuard
from gm3d_tpu_torch.utils.profiling import (
    TRACE_WINDOW,
    device_busy_share,
    device_idle_gaps,
    span,
    trace,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(trans_dim=48, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=48,
             decoder_depth=1, decoder_num_heads=2, drop_path_rate=0.0)
SCALARS = {"keep_ratio": 0.5, "ema_decay": 0.99, "w_mse": 1.0, "w_cd": 1.0}


def _state(seed):
    student = GM3DStudent(**SMALL)
    student.reset_parameters(torch.Generator().manual_seed(seed))
    optimizer = build_gm3d_shared_optimizer(student, 1e-3)
    state = create_train_state(student, optimizer, with_ema=True)
    step = make_gm3d_train_step(student, None, optimizer, distill_mode="ema", device="cpu")
    return state, step


def _train(state, step, steps, seed):
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        pts = torch.randn((2, 64, 3), generator=gen)
        state, metrics = step(state, pts, gen, SCALARS)
    return metrics


def _assert_same_state(a, b):
    for mod_a, mod_b in ((a.student, b.student), (a.ema, b.ema)):
        sa, sb = mod_a.state_dict(), mod_b.state_dict()
        assert sorted(sa) == sorted(sb)
        for key in sa:
            assert torch.equal(sa[key], sb[key]), key
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert sorted(oa["state"]) == sorted(ob["state"])
    for idx, slot in oa["state"].items():
        assert sorted(slot) == sorted(ob["state"][idx]) == ["exp_avg", "exp_avg_sq", "step"]
        for key, value in slot.items():
            assert torch.equal(value, ob["state"][idx][key]), (idx, key)
    assert a.step == b.step


def test_round_trip_is_bit_exact_and_the_next_step_equals_the_live_ones(tmp_path):
    live, live_step = _state(0)
    _train(live, live_step, 2, seed=1)
    # the BN running statistics have left their init: restoring them counts
    assert all(float(v.abs().max()) > 0 for k, v in live.student.state_dict().items()
               if k.endswith("running_mean"))
    assert ck.save_checkpoint(str(tmp_path), live, live.step)
    fresh, fresh_step = _state(7)  # other weights, no optimizer state yet
    assert ck.restore_checkpoint(str(tmp_path), fresh) == 2
    _assert_same_state(live, fresh)
    # the restored run goes on exactly as the live one
    m_live = _train(live, live_step, 1, seed=3)
    m_fresh = _train(fresh, fresh_step, 1, seed=3)
    for key in m_live:
        assert torch.equal(m_live[key], m_fresh[key]), key
    _assert_same_state(live, fresh)
    assert ck.restore_checkpoint(str(tmp_path / "none"), fresh) is None


def test_retention_latest_step_and_restore_raw(tmp_path):
    state, _ = _state(0)
    d = str(tmp_path / "ckpt")
    assert ck.latest_step(d) is None and ck.restore_raw(d) is None
    for step in range(1, 6):
        assert ck.save_checkpoint(d, state, step, metrics={"svm_acc": step / 10})
    assert ck.all_steps(d) == [3, 4, 5] and ck.latest_step(d) == 5
    # as orbax does: a step not above the latest is skipped
    assert not ck.save_checkpoint(d, state, 4) and not ck.save_checkpoint(d, state, 5)
    assert json.loads((tmp_path / "ckpt" / "4" / "metrics.json").read_text()) == {"svm_acc": 0.4}
    raw = ck.restore_raw(d, step=4)
    assert raw["step"] == 4 and sorted(raw) == ["ema", "model", "optimizer", "step"]
    want = state.student.state_dict()
    assert sorted(raw["model"]) == sorted(want)
    assert all(torch.equal(raw["model"][k], want[k]) for k in want)
    assert ck.restore_raw(d)["step"] == 5
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["3", "4", "5"]
    # a weights-only checkpoint restores into modules that have no optimizer state
    ck.save_checkpoint(str(tmp_path / "w"), {"step": 9, "model": want, "ema": None,
                                             "optimizer": None}, 9)
    assert ck.restore_raw(str(tmp_path / "w"))["optimizer"] is None


def test_sidecars_are_byte_equal_to_the_jax_functions_files(tmp_path):
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    loader, best = {"epoch": 3, "batch": 17}, {"best": 0.875, "best_vote": 0.5}
    ck.save_loader_state(str(mine), loader)
    jckpt.save_loader_state(str(theirs), loader)
    ck.save_best_metrics(str(mine), best)
    jckpt.save_best_metrics(str(theirs), best)
    for name in ("loader_state.json", "best_metrics.json"):
        assert (mine / name).read_bytes() == (theirs / name).read_bytes(), name
    assert ck.load_loader_state(str(theirs)) == jckpt.load_loader_state(str(mine)) == loader
    assert ck.load_best_metrics(str(theirs)) == best
    assert ck.load_loader_state(str(tmp_path / "none")) == {} == ck.load_best_metrics(
        str(tmp_path / "none"))


# ---------------------------------------------------------------------------
# the asynchronous writer (tests/test_async_ckpt.py:22-84, 112-128)


def test_snapshot_survives_an_in_place_update():
    """The port's hazard: the next step writes the live tensors in place."""
    state = {"step": 3, "model": {"w": torch.arange(8.0)}, "ema": None,
             "optimizer": {"state": {0: {"step": torch.tensor(3.0)}}, "param_groups": []}}
    snap = aw.device_snapshot(state)
    state["model"]["w"].mul_(0).sub_(1)
    state["optimizer"]["state"][0]["step"].add_(1)
    assert torch.equal(snap["model"]["w"], torch.arange(8.0))
    assert float(snap["optimizer"]["state"][0]["step"]) == 3.0
    assert snap["step"] == 3 and isinstance(snap["step"], int) and snap["ema"] is None
    # buffers of an earlier snapshot are written over, not reallocated
    again = aw.device_snapshot(state, [snap["model"]["w"],
                                       snap["optimizer"]["state"][0]["step"]])
    assert again["model"]["w"] is snap["model"]["w"]
    assert torch.equal(again["model"]["w"], -torch.ones(8))


def test_async_save_restores_the_submit_time_state(tmp_path):
    state, step = _state(0)
    _train(state, step, 1, seed=1)
    want = {k: v.clone() for k, v in state.student.state_dict().items()}
    moments = [s["exp_avg"].clone() for s in state.optimizer.state.values()]
    writer = aw.AsyncCheckpointWriter()
    writer.submit(state, lambda s: ck.save_checkpoint(str(tmp_path), s, 1))
    # the live state moves on at once, in place
    _train(state, step, 1, seed=2)
    for p in state.student.parameters():
        p.data.add_(100.0)
    writer.wait()
    raw = ck.restore_raw(str(tmp_path))
    assert raw["step"] == 1
    for key, value in want.items():
        assert torch.equal(raw["model"][key], value), key
    got = [s["exp_avg"] for s in raw["optimizer"]["state"].values()]
    assert len(got) == len(moments) and all(torch.equal(g, w) for g, w in zip(got, moments))


def test_writer_runs_in_the_background_and_serialises():
    order = []
    release = threading.Event()

    def slow_save(snap):
        release.wait(timeout=10)
        order.append(("saved", int(snap["model"]["x"])))

    writer = aw.AsyncCheckpointWriter()
    writer.submit({"step": 1, "model": {"x": torch.tensor(1)}}, slow_save)
    order.append(("submitted", 1))  # submit returned while the save blocks
    threads = [t for t in threading.enumerate() if t.name == "gm3d-ckpt-writer"]
    assert len(threads) == 1 and threads[0].daemon
    release.set()
    writer.submit({"step": 2, "model": {"x": torch.tensor(2)}},
                  lambda s: order.append(("saved", int(s["model"]["x"]))))
    writer.wait()
    assert order == [("submitted", 1), ("saved", 1), ("saved", 2)]
    assert not any(t.name == "gm3d-ckpt-writer" and t.is_alive() for t in threading.enumerate())


def test_writer_failure_surfaces_at_the_next_wait_and_submit():
    writer = aw.AsyncCheckpointWriter()

    def bad_save(_snap):
        raise OSError("disk full")

    writer.submit({"model": {"x": torch.zeros(1)}}, bad_save)
    with pytest.raises(RuntimeError, match="asynchronous checkpoint save"):
        writer.wait()
    done = []
    writer.submit({"model": {"x": torch.ones(1)}}, lambda s: done.append(1))
    writer.wait()
    assert done == [1]
    writer.submit({"model": {"x": torch.zeros(1)}}, bad_save)
    with pytest.raises(RuntimeError, match="asynchronous checkpoint save") as e:
        writer.submit({"model": {"x": torch.zeros(1)}}, lambda s: done.append(2))
    assert isinstance(e.value.__cause__, OSError) and done == [1]


def test_sync_mode_passes_the_live_state_through():
    writer = aw.AsyncCheckpointWriter(enabled=False)
    seen = []
    state = {"model": {"x": torch.tensor(5)}}
    writer.submit(state, lambda s: seen.append(s))
    assert seen and seen[0] is state  # no snapshot, no thread
    writer.wait()


# ---------------------------------------------------------------------------
# preemption, tracing


def test_preemption_guard_saves_and_exits_0_on_sigterm():
    assert threading.current_thread() is threading.main_thread()
    before = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard().install()
    try:
        saved = []
        guard.exit_if_triggered(lambda: saved.append("early"))
        assert saved == [] and not guard.triggered
        signal.raise_signal(signal.SIGTERM)  # the handler only sets the flag
        assert guard.triggered
        with pytest.raises(SystemExit) as e:
            guard.exit_if_triggered(lambda: saved.append("saved"))
        assert e.value.code == 0 and saved == ["saved"]
        assert signal.getsignal(signal.SIGTERM) == before
    finally:
        guard.uninstall()
    # off the main thread installing degrades to a no-op
    box = {}
    t = threading.Thread(target=lambda: box.update(g=PreemptionGuard().install()))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and box["g"]._prev == {} and not box["g"].triggered
    assert signal.getsignal(signal.SIGTERM) == before


def test_device_busy_share_of_a_hand_written_trace(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": TRACE_WINDOW, "ts": 90.0, "dur": 70.0},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 100.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 105.0, "dur": 10.0},  # overlaps a
        {"ph": "X", "cat": "gpu_memcpy", "name": "HtoD", "ts": 120.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "c", "ts": 122.0, "dur": 2.0},  # inside the copy
        {"ph": "X", "cat": "gpu_memset", "name": "set", "ts": 140.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "e", "ts": 155.0, "dur": 20.0},  # past the window
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 1000.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 500.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    # busy 15 + 10 + 10 + 5 over the window 90 .. 160, its idle edges included
    assert device_busy_share(str(path)) == pytest.approx(40.0 / 70.0, abs=1e-12)
    # idle 90 .. 100, 115 .. 120, 130 .. 140, 150 .. 155, in ms from the window's start
    assert device_idle_gaps(str(path)) == [(0.0, 0.01), (0.04, 0.01), (0.025, 0.005),
                                           (0.06, 0.005)]
    path.write_text(json.dumps(events[:1]))
    assert device_busy_share(str(path)) == 0.0
    path.write_text(json.dumps({"traceEvents": events[1:]}))
    with pytest.raises(ValueError, match="no gm3d.trace_window"):
        device_busy_share(str(path))


def _side_span():
    with span("side"):
        torch.ones(4).sum()


def test_trace_writes_a_chrome_trace_and_the_step_timer_counts(tmp_path):
    with trace(None):
        pass
    assert not list(tmp_path.iterdir())
    with trace(str(tmp_path / "prof")):
        for _ in range(2):
            with span("step"):
                torch.randn(32, 32) @ torch.randn(32, 32)
        side = threading.Thread(target=_side_span, name="side")
        side.start()
        side.join(timeout=60)
    assert not side.is_alive()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    window = [e for e in ranges if e["name"] == TRACE_WINDOW]
    steps = [e for e in ranges if e["name"] == "step"]
    assert len(window) == 1 and len(steps) == 2
    lo, hi = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in steps)
    # every thread's spans: the profiler records them all
    assert any(e["name"] == "side" for e in ranges)
    assert any(e.get("cat") == "cpu_op" and e["name"] == "aten::mm" for e in events)


# ---------------------------------------------------------------------------
# the converter


def _converter():
    spec = importlib.util.spec_from_file_location("orbax_to_torch",
                                                  REPO / "tools" / "orbax_to_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_converter_carries_a_jax_teacher_into_the_port(tmp_path):
    import logging

    rng = np.random.default_rng(0)
    pts = rng.standard_normal((2, 128, 3)).astype(np.float32)
    jmodel = JPointMAE(**SMALL)
    variables = jax.jit(lambda key, x: jmodel.init(key, x, jnp.zeros((2, 16), bool), 0))(
        jax.random.key(3), jnp.asarray(pts))
    # running statistics away from their init, so that the BN buffers count
    variables = jax.tree_util.tree_map_with_path(
        lambda path, v: (v + 0.3 * jnp.abs(jnp.asarray(rng.standard_normal(v.shape),
                                                       jnp.float32))
                         if path[0].key == "batch_stats" else v), variables)
    jckpt.save_checkpoint(str(tmp_path / "orbax"),
                          {"params": variables["params"],
                           "batch_stats": variables["batch_stats"], "step": jnp.asarray(7)}, 7)
    assert _converter().main([str(tmp_path / "orbax"), str(tmp_path / "port")]) == 7
    teacher = PointMAE(**SMALL)
    teacher.reset_parameters(torch.Generator().manual_seed(5))
    logger = logging.getLogger("test_converter")
    cli.load_teacher_checkpoint(teacher, str(tmp_path / "port"), logger)
    teacher.eval()
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, method=jmodel.encode_features))(
        variables, jnp.asarray(pts)))
    with torch.no_grad():
        got = teacher.encode_features(torch.from_numpy(pts)).numpy()
    assert got.shape == want.shape == (2, 16, 48)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with pytest.raises(FileNotFoundError, match="no teacher ckpt"):
        cli.load_teacher_checkpoint(teacher, str(tmp_path / "none"), logger)
    with pytest.raises(FileNotFoundError, match="no orbax checkpoint"):
        _converter().main([str(tmp_path / "none"), str(tmp_path / "x")])
