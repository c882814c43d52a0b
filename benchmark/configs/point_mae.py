"""The ``point_mae`` configuration: the program built for it, the work of its
step and forward counted from its shapes, and its plain reference.

Training builds the GM3D step as ``gm3d_tpu_torch/cli/pretrain.py`` does
(shared AdamW clipped at 5, the coordinate head frozen, ``dino``
distillation from a frozen Point-MAE, the CLI's draws and epoch knobs);
serving exports the ``PointTransformer`` classifier with ``serve/export.py``
as ``cli/export_model.py`` does. The weights are the benchmark's, made from
the seed (``harness/weights.py``).
"""

from __future__ import annotations

import torch

from benchmark.harness import work as W
from benchmark.harness.env import ROOT
from benchmark.harness.weights import make_state, spec_of
from benchmark.reference import plain as P
from benchmark.reference import point_mae as ref

CLI_CONFIG = ROOT / "configs" / "pointmae" / "config.yaml"
# the kernels that implement the fused layers, by the names a trace gives them
ATTENTION_KERNELS = ("attn_fwd_kernel", "attn_bwd_kernel")
PATCH_EMBED_KERNELS = ("patch_embed_kernel",)


# ------------------------------------------------------------------ work


def _head(rows, d):
    return W.dense(rows, d, 1024) + W.dense(rows, 1024, d)


def train_flops_per_cloud(cfg: dict) -> float:
    """One cloud's share of a GM3D step: the EMA pass, the student's forward
    and backward (twice its forward, the frozen coordinate head left out) and
    the teacher's encoder and two decoder replays."""
    c = cfg["student"]
    d, g, s, depth, dec = (c["trans_dim"], c["num_group"], c["group_size"], c["depth"],
                           c["decoder_depth"])
    nm = P.gm3d_num_mask(g, cfg["recipe"]["mask_ratio"])
    vis = g - nm
    pe = W.patch_embed(g, s, c["encoder_dims"])
    ema = pe + 2 * W.pos_embed(g, d) + 2 * depth * W.block(g, d) + _head(g, d)
    student = (pe + W.pos_embed(vis, d) + depth * W.block(vis, d) + W.pos_embed(g, d)
               + dec * W.block(g, d) + depth * W.block(g, d) + _head(g, d))
    coord = W.dense(g, d, 3 * s)
    t = cfg["teacher"]
    teacher = (pe + W.pos_embed(g, d) + t["depth"] * W.block(g, d)
               + W.pos_embed(g, d) + t["decoder_depth"] * W.block(g, d) + W.dense(g, d, 3 * s)
               + W.pos_embed(nm, d) + t["decoder_depth"] * W.block(nm, d)
               + W.dense(nm, d, 3 * s))
    return ema + 3 * student + coord + teacher


def serve_flops_per_cloud(cfg: dict) -> float:
    """The classifier's forward for one cloud."""
    c = cfg["classifier"]
    d, g = c["trans_dim"], c["num_group"]
    return (W.patch_embed(g, c["group_size"], c["encoder_dims"]) + W.pos_embed(g, d)
            + c["depth"] * W.block(g + 1, d)
            + W.dense(1, 2 * d, 256) + W.dense(1, 256, 256) + W.dense(1, 256, c["cls_dim"]))


def attention_calls(cfg: dict) -> list:
    """Every attention sublayer the fused kernels hold in one step, as
    (length, forwards, backwards): the EMA pass (encoder and loss-prediction
    decoder), the student (encoder over the visible groups, both decoders,
    with their backward) and the teacher (encoder, two decoder replays)."""
    c, t = cfg["student"], cfg["teacher"]
    g = c["num_group"]
    nm = P.gm3d_num_mask(g, cfg["recipe"]["mask_ratio"])
    full = 2 * c["depth"] + c["decoder_depth"] + c["depth"] + t["depth"] + t["decoder_depth"]
    student_full = c["decoder_depth"] + c["depth"]
    return [(g, full, student_full), (g - nm, c["depth"], c["depth"]),
            (nm, t["decoder_depth"], 0)]


def patch_embed_calls(cfg: dict) -> list:
    """The fused patch embeds of one step, as (groups a cloud, group size,
    width): the EMA pass's and the teacher's."""
    c = cfg["student"]
    return [(c["num_group"], c["group_size"], c["encoder_dims"])] * 2


# ------------------------------------------------------------------ weights


def train_states(cfg: dict, seed: int, device) -> dict:
    m = ref.models(cfg)
    return {"student": make_state(spec_of(m["student"]), seed, device, salt=1),
            "teacher": make_state(spec_of(m["teacher"]), seed, device, salt=2)}


def serve_state(cfg: dict, seed: int, device) -> dict:
    return make_state(spec_of(ref.models(cfg)["classifier"]), seed, device, salt=3)


# ------------------------------------------------------------------ program


def _load(module: torch.nn.Module, state: dict, device) -> torch.nn.Module:
    module = module.to_empty(device=device)
    module.load_state_dict(state, strict=True)
    return module


class TrainProgram:
    """The GM3D step of the pretrain CLI over the benchmark's weights.
    ``step(pts)`` sets the scheduled rate, draws as the CLI draws and takes
    one step; it returns the step's metrics, on the device."""

    metric_keys = ("loss", "loss_recon", "loss_mse", "loss_chfr", "loss_learn", "grad_norm")

    def __init__(self, cfg: dict, states: dict, device, gen: torch.Generator, start_step: int,
                 steps_per_epoch: int, epoch: int):
        from gm3d_tpu_torch.cli.pretrain import epoch_scalars, parse_args, step_draws
        from gm3d_tpu_torch.models import GM3DStudent, PointMAE
        from gm3d_tpu_torch.train.optim import (GM3D_COORD_HEAD, build_gm3d_shared_optimizer,
                                                set_scheduled_lr)
        from gm3d_tpu_torch.train.pretrain import make_gm3d_train_step
        from gm3d_tpu_torch.train.schedules import cosine_warmup_schedule, effective_lr
        from gm3d_tpu_torch.train.state import create_train_state

        r = cfg["recipe"]
        with torch.device("meta"):
            student = GM3DStudent(mode="feature", **cfg["student"])
            teacher = PointMAE(**cfg["teacher"])
        student = _load(student, states["student"], device)
        teacher = _load(teacher, states["teacher"], device)
        self.sched = cosine_warmup_schedule(effective_lr(r["blr"], r["batch"]), r["min_lr"],
                                            r["warmup_epochs"], r["epochs"], steps_per_epoch)
        self.optimizer = build_gm3d_shared_optimizer(
            student, self.sched(start_step), r["weight_decay"], tuple(r["betas"]),
            r["grad_clip"], frozen_modules=(GM3D_COORD_HEAD,))
        self.state = create_train_state(student, self.optimizer, with_ema=True)
        self.state.step = start_step
        self.step_fn = make_gm3d_train_step(student, teacher, self.optimizer, r["mask_ratio"],
                                            distill_mode=r["distill"], device=device)
        args = parse_args(["--config", str(CLI_CONFIG)])
        self.scalars = epoch_scalars(args, epoch, r["epochs"])
        self.trainable = [(n, p) for n, p in student.named_parameters()
                          if n.split(".")[0] != GM3D_COORD_HEAD]
        self.beta1 = r["betas"][0]
        self._draws, self._set_lr = step_draws, set_scheduled_lr
        self.num_group = student.num_group
        self.gen = gen
        self.start = states["student"]

    def step(self, pts: torch.Tensor) -> dict:
        self._set_lr(self.optimizer, self.sched(self.state.step))
        draws = self._draws(self.gen, pts.shape[0], self.num_group)
        self.state, metrics = self.step_fn(self.state, pts, self.gen, self.scalars, draws=draws)
        return metrics

    def first_gradients(self) -> dict:
        """The gradient the optimizer took in its first step, by name, from
        its first moment: exp_avg / (1 - beta1)."""
        st = self.optimizer.state
        return {n: st[p]["exp_avg"] / (1.0 - self.beta1) for n, p in self.trainable if p in st}

    def params(self) -> dict:
        return {n: p.detach() for n, p in self.trainable}

    def ema_change(self):
        """(name, change) of each trainable parameter's EMA copy from the
        weights it started from, in float64, one leaf at a time."""
        ema = dict(self.state.ema.named_parameters())
        for n, _ in self.trainable:
            yield n, ema[n].detach().double() - self.start[n].double()

    def last_mask(self):
        """The geometric mask of the latest step: an output of the step."""
        return self.step_fn.last_mask


def reference_train(cfg: dict, states: dict, batches, gen_state, start_step: int,
                    steps_per_epoch: int, epoch: int, device, tf32: bool = False,
                    program_masks=None, ema_decay=None) -> dict:
    """The reference's three steps from the same weights, clouds and
    generator: each step's loss, the first step's (clipped) gradient, the
    change of each parameter and of its EMA copy over the steps, by name,
    and ``ties``: the clouds where the program's mask was taken
    (``plain.judge_masks``). ``ema_decay`` replaces the epoch's decay (a
    fault for the controls)."""
    P.set_precision(tf32)
    r = cfg["recipe"]
    try:
        model = ref.TrainReference(cfg, states, device)
        scalars = P.gm3d_scalars(epoch, r["epochs"], r["after_epoch"], r["loss_multiply_by"])
        if ema_decay is not None:
            scalars["ema_decay"] = ema_decay
        gen = torch.Generator(device=device)
        gen.set_state(gen_state)
        losses = []
        base_lr = r["blr"] * r["batch"] / 256.0
        for i, pts in enumerate(batches):
            lr = P.cosine_lr(start_step + i, base_lr, r["warmup_epochs"], r["epochs"],
                             steps_per_epoch, r["min_lr"])
            mask = None if program_masks is None else program_masks[i]
            losses.append(model.step(pts.to(device), gen, lr, scalars, mask))
        start = states["student"]
        change = {n: p.detach() - start[n] for n, p in model.named}
        ema = dict(model.ema.named_parameters())
        ema_change = {n: ema[n].double() - start[n].double() for n, _ in model.named}
        return {"losses": losses, "first_grads": model.first_grads, "change": change,
                "ema_change": ema_change, "ties": model.ties, "masks": model.masks}
    finally:
        P.set_precision(False)


# ------------------------------------------------------------------ serving


def export_classifier(cfg: dict, state: dict, device, path: str) -> str:
    """The classifier exported as ``cli/export_model.py`` exports it, at
    the configuration's export batch, for ``device``'s platform."""
    from gm3d_tpu_torch.models import PointTransformer
    from gm3d_tpu_torch.serve.export import build_classifier_fn, export_forward, save_artifact

    with torch.device("meta"):
        model = PointTransformer(**cfg["classifier"])
    model = _load(model, state, device).eval()
    npoints = cfg["npoints"]
    example = torch.zeros((cfg["serve"]["export_batch"], npoints, 3), device=device)
    exported = export_forward(build_classifier_fn(model, npoints), example, (device.type,))
    manifest = {"mode": "classifier", "model": "PointTransformer",
                "model_cfg": {"NAME": "PointTransformer", **cfg["classifier"]},
                "npoints": npoints, "ckpt_step": -1, "compute_dtype": "float32",
                "quantization": "none"}
    return save_artifact(path, exported, manifest)


def reference_logits(cfg: dict, state: dict, pts: torch.Tensor, tf32: bool = False):
    P.set_precision(tf32)
    try:
        return ref.classify(cfg, state, pts)
    finally:
        P.set_precision(False)
