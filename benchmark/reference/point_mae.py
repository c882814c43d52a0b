"""Plain reference of the ``point_mae`` configuration: the GM3D pretrain step
(student, EMA copy, frozen Point-MAE teacher, AdamW) and the ``PointTransformer``
classifier's forward.

Departures from the published description (GeoMask3D on Point-MAE,
``cfgs/config.yaml``, ``config_m.yaml``, ``finetune_modelnet.yaml``), each
also the program's: the EMA pass stops at the loss-prediction head (its
reconstruction decoder feeds nothing); the teacher shares the student's
grouping; the coordinate head gets no gradient in feature mode and is left
out of the optimizer; one loss-prediction mask token apart from the
reconstruction one. Stochastic depth draws from one generator in the order
the student's forward meets its blocks: encoder, reconstruction decoder,
loss-prediction decoder.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference import plain as P

# Two groups' predicted losses closer than this tie to rounding (``plain.judge_masks``).
# On an H100 at this configuration's size the program's predicted losses lay at
# most 3.8e-08 - 5.4e-08 from the reference's in each step (12 seeds x 3 steps
# x 256 clouds, PERF.md), while the clouds' largest predicted losses ranged over
# 1.05e-03 - 2.01e-02: the error is that of a mean over 384 channels and does
# not shrink with the mean. About ten times the largest.
MASK_TIE = 5e-7


class MaskTransformer(nn.Module):
    """Patch embed, positional MLP and encoder over the visible groups."""

    def __init__(self, c: dict, norm_name: str):
        super().__init__()
        self.norm_name = norm_name
        self.encoder = P.PatchEncoder(c["encoder_dims"])
        self.pos_embed = P.pos_mlp(c["trans_dim"])
        self.blocks = P.Encoder(c["trans_dim"], c["depth"], c["num_heads"], c["drop_path_rate"])
        setattr(self, norm_name, P.LayerNorm(c["trans_dim"]))

    def forward(self, neighborhood, center, vis_idx=None, gen=None):
        tokens = self.encoder(neighborhood)
        if vis_idx is not None:
            tokens, center = P.take(tokens, vis_idx), P.take(center, vis_idx)
        x = self.blocks(tokens, self.pos_embed(center), None, gen)
        return getattr(self, self.norm_name)(x)


class Student(nn.Module):
    """GM3D's student in feature mode: encoder over the visible groups, a
    reconstruction decoder and a loss-prediction decoder over [visible,
    mask tokens], the feature head meaned into one predicted loss a group."""

    def __init__(self, c: dict):
        super().__init__()
        d, heads, rate = c["trans_dim"], c["num_heads"], c["drop_path_rate"]
        self.MAE_encoder = MaskTransformer(c, "norm_p")
        dh = c["decoder_num_heads"]
        self.MAE_decoder = P.Decoder(d, c["decoder_depth"], dh, rate)
        self.MAE_decoder_loss_pred = P.Decoder(d, c["depth"], dh, rate)
        self.decoder_pos_embed = P.pos_mlp(d)
        self.mask_token = nn.Parameter(torch.empty(1, 1, d))
        self.mask_token_loss_pred = nn.Parameter(torch.empty(1, 1, d))
        self.increase_dim_2 = nn.Sequential(P.PointConv(d, 1024), P.BatchNorm(1024),
                                            nn.LeakyReLU(0.2), P.PointConv(1024, d))
        self.increase_dim_just_network_without_feature = nn.Sequential(
            P.PointConv(d, 3 * c["group_size"]))

    def loss_pred(self, x, pos, gen=None):
        return self.increase_dim_2(self.MAE_decoder_loss_pred(x, pos, None, gen)).mean(-1)

    def ema_pass(self, neighborhood, center):
        """The unmasked pass (eval): the predicted loss of every group."""
        x = self.MAE_encoder(neighborhood, center)
        return self.loss_pred(x, self.decoder_pos_embed(center))

    def forward(self, neighborhood, center, mask, num_mask, gen):
        vis_idx, mask_idx = P.split_indices(mask, num_mask)
        x_vis = self.MAE_encoder(neighborhood, center, vis_idx, gen)
        pos = torch.cat([self.decoder_pos_embed(P.take(center, vis_idx)),
                         self.decoder_pos_embed(P.take(center, mask_idx))], dim=1)
        b = x_vis.shape[0]
        x_rec = self.MAE_decoder(torch.cat([x_vis, self.mask_token.expand(b, num_mask, -1)], 1),
                                 pos, None, gen)
        lp = self.loss_pred(torch.cat([x_vis, self.mask_token_loss_pred.expand(b, num_mask, -1)],
                                      1), pos, gen)
        return x_rec, lp, mask_idx


class Teacher(nn.Module):
    """The frozen Point-MAE: encoder over all groups, decoder and head replay."""

    def __init__(self, c: dict):
        super().__init__()
        d = c["trans_dim"]
        self.group_size = c["group_size"]
        self.MAE_encoder = MaskTransformer(c, "norm")
        self.decoder_pos_embed = P.pos_mlp(d)
        self.mask_token = nn.Parameter(torch.empty(1, 1, d))
        self.MAE_decoder = P.Decoder(d, c["decoder_depth"], c["decoder_num_heads"],
                                     c["drop_path_rate"])
        self.increase_dim = nn.Sequential(P.PointConv(d, 3 * c["group_size"]))

    def replay(self, tokens, centers):
        x = self.MAE_decoder(tokens, self.decoder_pos_embed(centers))
        b, t = x.shape[:2]
        return self.increase_dim(x).reshape(b, t, self.group_size, 3)


class Classifier(nn.Module):
    """``PointTransformer``: groups, patch embed, a class token, the encoder,
    then [class token, max over groups] into a two-layer head."""

    def __init__(self, c: dict):
        super().__init__()
        d = c["trans_dim"]
        self.num_group, self.group_size = c["num_group"], c["group_size"]
        self.encoder = P.PatchEncoder(c["encoder_dims"])
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.cls_pos = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = P.pos_mlp(d)
        self.blocks = P.Encoder(d, c["depth"], c["num_heads"], c["drop_path_rate"])
        self.norm_p = P.LayerNorm(d)
        self.cls_head_finetune = nn.Sequential(
            P.Dense(2 * d, 256), P.BatchNorm(256), nn.ReLU(), nn.Dropout(0.5),
            P.Dense(256, 256), P.BatchNorm(256), nn.ReLU(), nn.Dropout(0.5),
            P.Dense(256, c["cls_dim"]))

    def forward(self, pts):
        neighborhood, center = P.group_points(pts, self.num_group, self.group_size)
        tokens = self.encoder(neighborhood)
        b = tokens.shape[0]
        x = torch.cat([self.cls_token.expand(b, -1, -1), tokens], 1)
        pos = torch.cat([self.cls_pos.expand(b, -1, -1), self.pos_embed(center)], 1)
        x = self.norm_p(self.blocks(x, pos))
        return self.cls_head_finetune(torch.cat([x[:, 0], x[:, 1:].max(1).values], -1))


def models(cfg: dict, device="meta") -> dict:
    """The configuration's modules on ``device`` (weights uninitialised)."""
    with torch.device(device):
        return {"student": Student(cfg["student"]), "teacher": Teacher(cfg["teacher"]),
                "classifier": Classifier(cfg["classifier"])}


class TrainReference:
    """The GM3D step, followed step by step: ``step(pts, gen, lr, scalars)``
    returns the total loss; ``first_grads`` are the (clipped) gradients of
    the first step by parameter name."""

    def __init__(self, cfg: dict, states: dict, device):
        with torch.device(device):
            self.student, self.teacher = Student(cfg["student"]), Teacher(cfg["teacher"])
            self.ema = Student(cfg["student"])
        self.student.load_state_dict(states["student"])
        self.teacher.load_state_dict(states["teacher"])
        self.ema.load_state_dict(states["student"])
        self.ema.eval()
        self.teacher.eval()
        for p in list(self.ema.parameters()) + list(self.teacher.parameters()):
            p.requires_grad_(False)
        c = cfg["student"]
        self.group, self.size = c["num_group"], c["group_size"]
        self.num_mask = P.gm3d_num_mask(self.group, cfg["recipe"]["mask_ratio"])
        frozen = "increase_dim_just_network_without_feature"
        self.named = [(n, p) for n, p in self.student.named_parameters()
                      if n.split(".")[0] != frozen]
        self.opt = P.AdamW([p for _, p in self.named], cfg["recipe"]["weight_decay"],
                           cfg["recipe"]["grad_clip"])
        self.device = device
        self.first_grads = None
        self.ties = 0
        self.masks = []

    def step(self, pts: torch.Tensor, gen: torch.Generator, lr: float, s: dict,
             program_mask=None) -> torch.Tensor:
        """``program_mask``: the program's mask of this step, judged by
        ``plain.judge_masks``; the clouds where it was taken add to ``ties``."""
        batch, nm = pts.shape[0], self.num_mask
        draws = P.uniform_draws(gen, batch, self.group, self.device)
        with torch.no_grad():
            samples = pts * draws["scale"] + draws["shift"]
            neighborhood, center = P.group_points(samples, self.group, self.size)
            mask, taken = P.judge_masks(self.ema.ema_pass(neighborhood, center), nm,
                                        s["keep_ratio"], draws["noise"], program_mask, MASK_TIE)
            self.ties += taken
            self.masks.append(mask.cpu())
        self.student.train()
        x_rec, lp, mask_idx = self.student(neighborhood, center, mask, nm, gen)
        pred = x_rec[:, -nm:]
        with torch.no_grad():
            feats = self.teacher.MAE_encoder(neighborhood, center)
            target = self.teacher.replay(feats, center)
            reco = self.teacher.replay(pred.detach(), P.take(center, mask_idx))
        mse = P.feature_mse(pred, P.take(feats, mask_idx))
        chamfer = P.chamfer_group(reco, P.take(target, mask_idx))
        loss = s["w_mse"] * mse.mean() + s["w_cd"] * chamfer.mean()
        total = loss + P.relative_learning_loss(lp[:, -nm:], (mse + chamfer).detach())
        self.student.zero_grad(set_to_none=True)
        total.backward()
        self.opt.step(lr)
        if self.first_grads is None:
            names = {id(p): n for n, p in self.named}
            self.first_grads = {names[id(p)]: g for p, g in self.opt.last_grads}
        P.ema_update(self.ema, self.student, s["ema_decay"])
        return total.detach()


@torch.no_grad()
def classify(cfg: dict, state: dict, pts: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Logits of the classifier over ``pts`` (N, npoints, 3), ``block`` clouds at a time."""
    with torch.device(pts.device):
        model = Classifier(cfg["classifier"])
    model.load_state_dict(state)
    model.eval()
    return torch.cat([model(pts[i:i + block]) for i in range(0, pts.shape[0], block)])
