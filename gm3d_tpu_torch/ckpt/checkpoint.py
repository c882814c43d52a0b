"""Checkpoint save / restore of a train state, one directory a step.

Port of ``gm3d_tpu/ckpt/checkpoint.py`` with ``torch.save`` in place of
orbax. A checkpoint of ``step`` is the directory ``<ckpt_dir>/<step>/``:

  ``state.pth``     ``{"step", "model", "ema", "optimizer"}``: the student's
                    ``state_dict`` under the reference's names (BN buffers and
                    ``num_batches_tracked`` included), the EMA copy's (or
                    ``None``), the optimizer's ``state_dict`` (or ``None``: a
                    weights-only checkpoint; under gradient accumulation it
                    holds the window's running mean and count) and the step
  ``metrics.json``  the ``metrics`` of the save, where given

A step is written under a temporary name and moved into place with
``os.replace``, so an interrupted save leaves the earlier steps whole, as
orbax's commit does. As in orbax, a save at a step not above the latest one
is skipped, and only the newest ``max_to_keep`` steps are kept.

The two JSON sidecars (best metrics, loader position) are written exactly as
the JAX functions write them. Under data parallelism only rank 0 writes
(each save is a no-op on the other ranks, whose state is the same); every
rank reads. A checkpoint holds the single-process keys, so a run resumes in
either layout.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Mapping, Optional, Union

import torch

from gm3d_tpu_torch.parallel.multihost import is_main_process
from gm3d_tpu_torch.train.state import TrainState

STATE_FILE = "state.pth"
METRICS_FILE = "metrics.json"


def save_best_metrics(ckpt_dir: str, metrics: dict) -> None:
    """Persist best-so-far metrics next to the rolling checkpoint, so that a
    resumed run cannot let a worse epoch overwrite ``ckpt/best``."""
    _write_json(ckpt_dir, "best_metrics.json", metrics)


def load_best_metrics(ckpt_dir: str) -> dict:
    return _read_json(ckpt_dir, "best_metrics.json")


def save_loader_state(ckpt_dir: str, state: dict) -> None:
    """Persist the loader's resume token ``{"epoch", "batch"}`` next to the
    rolling checkpoint: without it a mid-epoch resume would replay batches
    that were already trained on."""
    _write_json(ckpt_dir, "loader_state.json", state)


def load_loader_state(ckpt_dir: str) -> dict:
    return _read_json(ckpt_dir, "loader_state.json")


def _write_json(ckpt_dir: str, name: str, obj: dict) -> None:
    if not is_main_process():
        return
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, name)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _read_json(ckpt_dir: str, name: str) -> dict:
    path = os.path.join(ckpt_dir, name)
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def capture(state: Union[TrainState, Mapping[str, Any]]) -> dict:
    """The checkpoint's dict of a live ``TrainState``; a dict already of that
    form passes through. The tensors are the live ones, not copies
    (``ckpt/async_writer.py::device_snapshot`` copies them)."""
    if isinstance(state, Mapping):
        return dict(state)
    return {"step": int(state.step),
            "model": state.student.state_dict(),
            "ema": state.ema.state_dict() if state.ema is not None else None,
            "optimizer": state.optimizer.state_dict() if state.optimizer is not None else None}


def all_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(name) for name in os.listdir(ckpt_dir)
                  if name.isdigit() and os.path.isfile(os.path.join(ckpt_dir, name, STATE_FILE)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def save_checkpoint(ckpt_dir: str, state: Union[TrainState, Mapping[str, Any]], step: int,
                    metrics: Optional[dict] = None, max_to_keep: int = 3) -> bool:
    """Save ``state`` (a ``TrainState`` or the dict ``capture`` makes of one)
    as step ``step``; keep the newest ``max_to_keep`` steps. Tensors are
    written from the host, so a checkpoint restores on any device. Returns
    False, and writes nothing, when ``step`` is not above the latest step,
    and on a rank other than 0."""
    if not is_main_process():
        return False
    last = latest_step(ckpt_dir)
    if last is not None and last >= step:
        return False
    tree = capture(state)
    tree["step"] = int(step)
    tree = _to_host(tree)
    tmp = os.path.join(ckpt_dir, f".{step}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)  # left by an interrupted save
    os.makedirs(tmp)
    try:
        torch.save(tree, os.path.join(tmp, STATE_FILE))
        if metrics is not None:
            with open(os.path.join(tmp, METRICS_FILE), "w") as f:
                json.dump(metrics, f)
        os.replace(tmp, os.path.join(ckpt_dir, str(step)))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for old in all_steps(ckpt_dir)[:-max_to_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)), ignore_errors=True)
    return True


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, Mapping):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def restore_raw(ckpt_dir: str, step: Optional[int] = None,
                map_location: Union[str, torch.device] = "cpu") -> Optional[dict]:
    """The saved dict of ``step`` (default: the latest), its tensors on
    ``map_location``; builds no module. ``None`` when there is no checkpoint."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return None
    return torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE),
                      map_location=map_location, weights_only=True)


def _steps_to_host(optimizer_state: Mapping[str, Any]) -> None:
    """A non-capturable AdamW keeps each parameter's step on the host (one on
    the card would cost a synchronisation a parameter and step);
    ``load_state_dict`` moves it back to the card where the optimizer wants
    it. The state of a torch optimizer, or of a wrapper that nests them
    (``train/optim.py``: ``MultiSteps``, ``SeparatedAdamW``)."""
    if "param_groups" in optimizer_state:
        for slot in optimizer_state["state"].values():
            if "step" in slot:
                slot["step"] = slot["step"].cpu()
        return
    for value in optimizer_state.values():
        if isinstance(value, Mapping):
            _steps_to_host(value)


def restore_checkpoint(ckpt_dir: str, state: TrainState,
                       step: Optional[int] = None) -> Optional[int]:
    """Load step ``step`` (default: the latest) into the live modules and
    optimizer of ``state``, strictly (every parameter and buffer, the
    optimizer's moments and per-parameter steps), on the device the modules
    are on, and set ``state.step``. Returns the step, or ``None`` when there
    is no checkpoint."""
    device = next(state.student.parameters()).device
    raw = restore_raw(ckpt_dir, step, map_location=device)
    if raw is None:
        return None
    state.student.load_state_dict(raw["model"], strict=True)
    if state.ema is not None:
        if raw["ema"] is None:
            raise KeyError(f"{ckpt_dir} step {raw['step']} holds no EMA state")
        state.ema.load_state_dict(raw["ema"], strict=True)
    if state.optimizer is not None:
        if raw["optimizer"] is None:
            raise KeyError(f"{ckpt_dir} step {raw['step']} holds no optimizer state")
        _steps_to_host(raw["optimizer"])
        state.optimizer.load_state_dict(raw["optimizer"])
    state.step = int(raw["step"])
    return state.step
