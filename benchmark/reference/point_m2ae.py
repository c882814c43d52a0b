"""Plain reference of the ``point_m2ae`` configuration: Point-M2AE with GM3D's
geometric mask, its EMA copy and AdamW (clipped at 5, every parameter
stepped).

Point-M2AE (``cfgs/config_Point_M2AE.yaml``): three scales of 512 / 256 / 64
FPS centers with 16 / 8 / 8 nearest members; a mini-PointNet at the finest
scale and, at each coarser one, the max and mean of a center's members
projected to its width; at each scale a positional MLP and 5 blocks whose
attention reaches only centers within the scale's radius (0.32 / 0.64 /
1.28). Masks are drawn at the coarsest scale and carried down: a finer
center is visible where its nearest coarsest center is. Masked tokens take a
learned placeholder and attend to themselves alone; pooling skips them. The
decoder: a stage at the coarsest scale (the mask token at masked slots),
then one that goes up to the middle scale, fusing the encoder's tokens
there, with an up-block; then to the finest scale and its up-block and the
reconstruction head. GM3D adds a loss-prediction head at the coarsest scale
(fed by the EMA's unmasked pass, which stops there), the geometric mask and
the relative learning loss.

Departures from the published description, each also the program's: the
Chamfer loss is taken over the masked finest groups, and the loss matrix is
each coarsest group's mean over the masked finest groups nearest to it; the
hierarchy is built once a step and shared by the two passes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import plain as P


def hierarchy(pts, groups, sizes):
    """FPS centers of each scale from the previous one, and their members."""
    centers, members, prev = [], [], pts
    for g, k in zip(groups, sizes):
        c = P.gather_rows(prev, P.fps_indices(prev, g))
        centers.append(c)
        members.append(P.knn_indices(prev, c, k))
        prev = c
    return centers, members


def nearest(ref_pts, query):
    return P.knn_indices(ref_pts, query, 1)[..., 0]


class Merge(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.proj = P.Dense(2 * d_in, d_out)

    def forward(self, prev, members, valid):
        feats = P.gather_rows(prev, members)
        v = valid[..., None]
        mx = torch.where(v, feats, -1e9).amax(dim=2)
        mx = torch.where(valid.any(dim=-1, keepdim=True), mx, 0.0)
        mean = torch.where(v, feats, 0.0).sum(2) / valid.sum(-1, keepdim=True).clamp_min(1)
        return self.proj(torch.cat([mx, mean], dim=-1))


class M2AE(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.groups, self.sizes = c["num_groups"], c["group_sizes"]
        dims, heads, rate = c["encoder_dims"], c["num_heads"], c["drop_path_rate"]
        self.radius = c["local_radius"]
        self.scales = len(self.groups)
        enc = nn.Module()
        enc.patch_embed = P.PatchEncoder(dims[0])
        for s in range(self.scales):
            if s:
                setattr(enc, f"merge{s}", Merge(dims[s - 1], dims[s]))
            setattr(enc, f"pos{s}", P.pos_mlp(dims[s]))
            setattr(enc, f"stage{s}", P.Encoder(dims[s], c["encoder_depths"][s], heads, rate))
            setattr(enc, f"mask_feat{s}", nn.Parameter(torch.empty(1, 1, dims[s])))
        self.encoder = enc
        ddims = c["decoder_dims"]
        for i, width in enumerate(ddims):
            skip = 0 if i == 0 else dims[self.scales - 1 - i]
            prev = dims[-1] if i == 0 else ddims[i - 1]
            setattr(self, f"dec_pos{i}", P.pos_mlp(width))
            setattr(self, f"dec_stage{i}", P.Encoder(width, c["decoder_depths"][i], heads, rate))
            setattr(self, f"dec_proj{i}", P.Dense(prev + skip, width))
        up = list(ddims[1:]) + [ddims[-1]]
        for i, blocks in enumerate(c["decoder_up_blocks"]):
            setattr(self, f"dec_up{i}", P.Encoder(up[i], blocks, heads, rate))
        self.num_up = len(c["decoder_up_blocks"])
        self.ddims = ddims
        self.mask_token = nn.Parameter(torch.empty(1, 1, ddims[0]))
        self.rec_head = P.Dense(ddims[-1], 3 * self.sizes[0])
        self.lp_fc1 = P.Dense(ddims[0], 1024)
        self.lp_bn = P.BatchNorm(1024)
        self.lp_fc2 = P.Dense(1024, ddims[0])

    def forward(self, pts, coarse_vis, hier, gen=None, loss_pred_only=False):
        centers, members = hier
        e = self.encoder
        near = [nearest(centers[-1], centers[s]) for s in range(self.scales - 1)]
        vis = [torch.gather(coarse_vis, 1, n) for n in near] + [coarse_vis]
        tokens_all, tokens = [], None
        for s in range(self.scales):
            if s == 0:
                tokens = e.patch_embed(P.gather_rows(pts, members[0]) - centers[0][:, :, None])
            else:
                valid = torch.gather(vis[s - 1], 1, members[s].reshape(pts.shape[0], -1)
                                     ).reshape(members[s].shape)
                tokens = getattr(e, f"merge{s}")(tokens, members[s], valid)
            c = centers[s]
            local = ((c[:, :, None] - c[:, None]) ** 2).sum(-1) < self.radius[s] * self.radius[s]
            v = vis[s]
            tokens = torch.where(v[..., None], tokens, getattr(e, f"mask_feat{s}"))
            eye = torch.eye(c.shape[1], dtype=torch.bool, device=c.device)[None]
            mask = (local & v[:, None, :] & v[:, :, None]) | eye
            tokens = getattr(e, f"stage{s}")(tokens, getattr(e, f"pos{s}")(c), mask, gen)
            tokens_all.append(tokens)
        x = self.dec_proj0(tokens_all[-1])
        x = torch.where(vis[-1][..., None], x, self.mask_token)
        x = self.dec_stage0(x, self.dec_pos0(centers[-1]), None, gen)
        lp = F.leaky_relu(self.lp_bn(self.lp_fc1(x)), 0.2)
        loss_pred = self.lp_fc2(lp).mean(-1)
        if loss_pred_only:
            return loss_pred
        scale = self.scales - 1
        for i in range(1, len(self.ddims)):
            scale -= 1
            link = (near[scale] if scale + 1 == self.scales - 1
                    else nearest(centers[scale + 1], centers[scale]))
            skip = torch.where(vis[scale][..., None], tokens_all[scale],
                               getattr(e, f"mask_feat{scale}"))
            x = getattr(self, f"dec_proj{i}")(torch.cat([P.gather_rows(x, link), skip], -1))
            pos = getattr(self, f"dec_pos{i}")(centers[scale])
            x = getattr(self, f"dec_up{i - 1}")(x, pos, None, gen)
            x = getattr(self, f"dec_stage{i}")(x, pos, None, gen)
        while scale > 0:
            scale -= 1
            x = P.gather_rows(x, nearest(centers[scale + 1], centers[scale]))
        fine_pos = getattr(self, f"dec_pos{len(self.ddims) - 1}")(centers[0])
        x = getattr(self, f"dec_up{self.num_up - 1}")(x, fine_pos, None, gen)
        b = pts.shape[0]
        rebuild = self.rec_head(x).reshape(b, self.groups[0], self.sizes[0], 3)
        gt = P.gather_rows(pts, members[0]) - centers[0][:, :, None]
        return rebuild, gt, vis[0], loss_pred, near[0]


def models(cfg: dict, device="meta") -> dict:
    with torch.device(device):
        return {"model": M2AE(cfg["model"])}


class TrainReference:
    """The Point-M2AE + GM3D step, followed step by step."""

    def __init__(self, cfg: dict, states: dict, device):
        with torch.device(device):
            self.model, self.ema = M2AE(cfg["model"]), M2AE(cfg["model"])
        self.model.load_state_dict(states["model"])
        self.ema.load_state_dict(states["model"])
        self.ema.eval()
        for p in self.ema.parameters():
            p.requires_grad_(False)
        r = cfg["recipe"]
        self.coarse = cfg["model"]["num_groups"][-1]
        self.num_mask = P.gm3d_num_mask(self.coarse, r["mask_ratio"])
        self.named = list(self.model.named_parameters())
        self.opt = P.AdamW([p for _, p in self.named], r["weight_decay"], r["grad_clip"],
                           zero_missing=True)
        self.device = device
        self.first_grads = None

    def step(self, pts, gen, lr: float, s: dict) -> torch.Tensor:
        m, nm = self.model, self.num_mask
        draws = P.uniform_draws(gen, pts.shape[0], self.coarse, self.device)
        with torch.no_grad():
            samples = pts * draws["scale"] + draws["shift"]
            hier = hierarchy(samples, m.groups, m.sizes)
            all_vis = torch.ones((pts.shape[0], self.coarse), dtype=torch.bool, device=self.device)
            lp = self.ema(samples, all_vis, hier, loss_pred_only=True)
            coarse_vis = ~P.geometric_mask(lp, nm, s["keep_ratio"], draws["noise"])
        m.train()
        rebuild, gt, fine_vis, loss_pred, fine_to_coarse = m(samples, coarse_vis, hier, gen)
        per_fine = P.chamfer_group(rebuild, gt)
        w = (~fine_vis).float()
        loss = (per_fine * w).sum() / w.sum()
        zeros = torch.zeros((w.shape[0], self.coarse), device=self.device)
        num = zeros.scatter_add(1, fine_to_coarse, per_fine * w)
        matrix = num / zeros.scatter_add(1, fine_to_coarse, w).clamp_min(1.0)
        idx = torch.argsort(coarse_vis.to(torch.int32), dim=-1, stable=True)[:, :nm]
        learn = P.relative_learning_loss(torch.gather(loss_pred, 1, idx),
                                         torch.gather(matrix.detach(), 1, idx))
        total = loss + learn
        m.zero_grad(set_to_none=True)
        total.backward()
        self.opt.step(lr)
        if self.first_grads is None:
            names = {id(p): n for n, p in self.named}
            self.first_grads = {names[id(p)]: g for p, g in self.opt.last_grads}
        P.ema_update(self.ema, m, s["ema_decay"])
        return total.detach()
