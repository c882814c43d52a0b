"""The ``point_m2ae`` configuration: the Point-M2AE + GM3D step as
``gm3d_tpu_torch/cli/pretrain.py --model_family m2ae_gm3d`` builds it (AdamW
over every parameter, clipped at 5, an EMA copy, the CLI's draws and epoch
knobs), its work counted from its shapes, and its plain reference. The
attention runs unfused, as the CLI runs it: its encoder's attention carries
a mask everywhere.
"""

from __future__ import annotations

import torch

from benchmark.harness import work as W
from benchmark.harness.env import ROOT
from benchmark.harness.weights import make_state, spec_of
from benchmark.reference import plain as P
from benchmark.reference import point_m2ae as ref

CLI_CONFIG = ROOT / "configs" / "m2ae" / "config_Point_M2AE.yaml"


def train_flops_per_cloud(cfg: dict) -> float:
    """One cloud's share of a step: the EMA pass (encoder, the coarsest
    decoder stage and the loss-prediction head), and the student's forward
    and backward (twice its forward)."""
    m = cfg["model"]
    groups, sizes, dims = m["num_groups"], m["group_sizes"], m["encoder_dims"]
    ddims = m["decoder_dims"]
    encoder = W.patch_embed(groups[0], sizes[0], dims[0])
    for s, (g, d) in enumerate(zip(groups, dims)):
        if s:
            encoder += W.dense(g, 2 * dims[s - 1], d)
        encoder += W.pos_embed(g, d) + m["encoder_depths"][s] * W.block(g, d)
    coarse = (W.dense(groups[-1], dims[-1], ddims[0]) + W.pos_embed(groups[-1], ddims[0])
              + m["decoder_depths"][0] * W.block(groups[-1], ddims[0])
              + W.dense(groups[-1], ddims[0], 1024) + W.dense(groups[-1], 1024, ddims[0]))
    rest = 0.0
    scale = len(groups) - 1
    for i in range(1, len(ddims)):
        scale -= 1
        g = groups[scale]
        rest += (W.dense(g, ddims[i - 1] + dims[scale], ddims[i]) + W.pos_embed(g, ddims[i])
                 + (m["decoder_up_blocks"][i - 1] + m["decoder_depths"][i]) * W.block(g, ddims[i]))
    rest += (W.pos_embed(groups[0], ddims[-1])
             + m["decoder_up_blocks"][-1] * W.block(groups[0], ddims[-1])
             + W.dense(groups[0], ddims[-1], 3 * sizes[0]))
    return (encoder + coarse) + 3 * (encoder + coarse + rest)


def train_states(cfg: dict, seed: int, device) -> dict:
    return {"model": make_state(spec_of(ref.models(cfg)["model"]), seed, device, salt=4)}


class TrainProgram:
    """The ``m2ae_gm3d`` step of the pretrain CLI over the benchmark's weights."""

    metric_keys = ("loss", "loss_chfr", "loss_learn", "grad_norm")

    def __init__(self, cfg: dict, states: dict, device, gen: torch.Generator, start_step: int,
                 steps_per_epoch: int, epoch: int):
        from gm3d_tpu_torch.cli.pretrain import epoch_scalars, parse_args, step_draws
        from gm3d_tpu_torch.models import PointM2AE
        from gm3d_tpu_torch.train.optim import build_adamw, set_scheduled_lr
        from gm3d_tpu_torch.train.pretrain import make_m2ae_gm3d_train_step
        from gm3d_tpu_torch.train.schedules import cosine_warmup_schedule, effective_lr
        from gm3d_tpu_torch.train.state import create_train_state

        r = cfg["recipe"]
        with torch.device("meta"):
            model = PointM2AE(**cfg["model"])
        model = model.to_empty(device=device)
        model.load_state_dict(states["model"], strict=True)
        self.sched = cosine_warmup_schedule(effective_lr(r["blr"], r["batch"]), r["min_lr"],
                                            r["warmup_epochs"], r["epochs"], steps_per_epoch)
        self.optimizer = build_adamw(model.named_parameters(), self.sched(start_step),
                                     r["weight_decay"], tuple(r["betas"]), grad_clip=r["grad_clip"])
        self.state = create_train_state(model, self.optimizer, with_ema=True)
        self.state.step = start_step
        self.step_fn = make_m2ae_gm3d_train_step(model, self.optimizer, r["mask_ratio"],
                                                 device=device)
        args = parse_args(["--config", str(CLI_CONFIG), "--model_family", "m2ae_gm3d"])
        self.scalars = epoch_scalars(args, epoch, r["epochs"])
        self.trainable = list(model.named_parameters())
        self.beta1 = r["betas"][0]
        self._draws, self._set_lr = step_draws, set_scheduled_lr
        self.coarse = model.num_groups[-1]
        self.gen = gen
        self.start = states["model"]

    def step(self, pts: torch.Tensor) -> dict:
        self._set_lr(self.optimizer, self.sched(self.state.step))
        draws = self._draws(self.gen, pts.shape[0], self.coarse)
        self.state, metrics = self.step_fn(self.state, pts, self.gen, self.scalars, draws=draws)
        return metrics

    def first_gradients(self) -> dict:
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


def reference_train(cfg: dict, states: dict, batches, gen_state, start_step: int,
                    steps_per_epoch: int, epoch: int, device, tf32: bool = False,
                    program_masks=None, ema_decay=None) -> dict:
    P.set_precision(tf32)
    r = cfg["recipe"]
    try:
        model = ref.TrainReference(cfg, states, device)
        scalars = P.gm3d_scalars(epoch, r["epochs"])
        if ema_decay is not None:
            scalars["ema_decay"] = ema_decay
        gen = torch.Generator(device=device)
        gen.set_state(gen_state)
        losses = []
        base_lr = r["blr"] * r["batch"] / 256.0
        for i, pts in enumerate(batches):
            lr = P.cosine_lr(start_step + i, base_lr, r["warmup_epochs"], r["epochs"],
                             steps_per_epoch, r["min_lr"])
            losses.append(model.step(pts.to(device), gen, lr, scalars))
        start = states["model"]
        change = {n: p.detach() - start[n] for n, p in model.named}
        ema = dict(model.ema.named_parameters())
        ema_change = {n: ema[n].double() - start[n].double() for n, _ in model.named}
        return {"losses": losses, "first_grads": model.first_grads, "change": change,
                "ema_change": ema_change, "ties": 0, "masks": None}
    finally:
        P.set_precision(False)
