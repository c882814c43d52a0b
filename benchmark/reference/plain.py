"""Plain PyTorch pieces the references share: grouping, layers, losses,
masks, AdamW and the EMA, written from the published models' description
(Point-MAE, GM3D), in fp32, with no kernel, cache or fusion.

Tensor names follow the published checkpoints (``blocks.blocks.0.attn.qkv``,
``first_conv.0``), so one state dict loads into a reference and into the
program alike. Random draws (stochastic depth) come from an explicit
``torch.Generator`` in the order a forward meets them.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def set_precision(tf32: bool) -> None:
    """fp32 products in fp32 (``tf32=False``), or in TF32 for a control."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


# ---------------------------------------------------------------- geometry


def fps_indices(xyz: torch.Tensor, n: int) -> torch.Tensor:
    """Farthest point sampling from point 0: (B, N, 3) -> (B, n) int64. The
    squared distance is (x-cx)^2 + (y-cy)^2 + (z-cz)^2 in that order; among
    equal farthest points the lowest index wins."""
    batch, num, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    out = torch.zeros((batch, n), dtype=torch.int64, device=xyz.device)
    dmin = torch.full((batch, num), math.inf, dtype=torch.float32, device=xyz.device)
    last = torch.zeros((batch, 1), dtype=torch.int64, device=xyz.device)
    lanes = torch.arange(num, device=xyz.device)
    for i in range(1, n):
        cx, cy, cz = x.gather(1, last), y.gather(1, last), z.gather(1, last)
        dmin = torch.minimum(dmin, (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2)
        best = dmin.max(dim=1, keepdim=True).values
        last = torch.where(dmin == best, lanes, num).min(dim=1, keepdim=True).values
        out[:, i] = last[:, 0]
    return out


def knn_indices(ref: torch.Tensor, query: torch.Tensor, k: int) -> torch.Tensor:
    """The k nearest reference points of each query, nearest first, the lower
    index first among equal distances: (B, N, 3), (B, G, 3) -> (B, G, k)."""
    qx, qy, qz = (query[..., c, None] for c in range(3))
    rx, ry, rz = (ref[:, None, :, c] for c in range(3))
    d = (qx * qx + qy * qy + qz * qz) - 2.0 * (qx * rx + qy * ry + qz * rz) \
        + (rx * rx + ry * ry + rz * rz)
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) rows by (B, ...) indices -> (B, ..., C)."""
    flat = idx.reshape(x.shape[0], -1, 1).long().expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, flat).reshape(*idx.shape, x.shape[-1])


def group_points(xyz: torch.Tensor, num_group: int, group_size: int):
    """FPS centers and their k nearest points: (neighborhood centred on each
    center (B, G, S, 3), centers (B, G, 3))."""
    center = gather_rows(xyz, fps_indices(xyz, num_group))
    neighborhood = gather_rows(xyz, knn_indices(xyz, center, group_size))
    return neighborhood - center[:, :, None, :], center


# ---------------------------------------------------------------- layers


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class PointConv(nn.Module):
    """A kernel-size-1 convolution over the last axis, weight (out, in, 1)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, 1))
        self.bias = nn.Parameter(torch.empty(d_out))

    def forward(self, x):
        return F.linear(x, self.weight[..., 0], self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias, 1e-5)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis: batch statistics in train mode (the
    biased variance to normalise, the unbiased one into the running
    variance, momentum 0.1), the running statistics in eval mode."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        if self.training:
            flat = x.reshape(-1, x.shape[-1])
            return F.batch_norm(flat, self.running_mean, self.running_var, self.weight,
                                self.bias, True, 0.1, 1e-5).reshape(x.shape)
        return ((x - self.running_mean) * torch.rsqrt(self.running_var + 1e-5)
                * self.weight + self.bias)


def drop_path(x, rate: float, training: bool, gen: Optional[torch.Generator]):
    """Stochastic depth: a sample's branch is kept with probability
    1 - rate, drawn (B, 1, 1) from ``gen``, and scaled by 1 / (1 - rate)."""
    if not training or rate == 0.0:
        return x
    keep = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), device=x.device,
                      generator=gen) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Dense(dim, 3 * dim, bias=False)
        self.proj = Dense(dim, dim)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        batch, length, dim = x.shape
        hd = dim // self.heads
        q, k, v = self.qkv(x).reshape(batch, length, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        scores = (q @ k.transpose(-1, -2)) * hd ** -0.5
        if mask is not None:
            scores = torch.where(mask[:, None], scores, torch.full((), -1e9, device=x.device))
        out = torch.softmax(scores, dim=-1) @ v
        return self.proj(out.transpose(1, 2).reshape(batch, length, dim))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-norm transformer block with stochastic depth on both branches."""

    def __init__(self, dim: int, heads: int, rate: float):
        super().__init__()
        self.rate = rate
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x, mask=None, gen=None):
        x = x + drop_path(self.attn(self.norm1(x), mask), self.rate, self.training, gen)
        return x + drop_path(self.mlp(self.norm2(x)), self.rate, self.training, gen)


def ramp(rate: float, depth: int) -> list:
    """Stochastic-depth rates rising linearly from 0 to ``rate`` over the blocks."""
    return [0.0] if depth == 1 else [rate * i / (depth - 1) for i in range(depth)]


class Encoder(nn.Module):
    """Blocks with the positional embedding added at every block's input."""

    def __init__(self, dim: int, depth: int, heads: int, rate: float):
        super().__init__()
        self.blocks = nn.ModuleList(Block(dim, heads, r) for r in ramp(rate, depth))

    def forward(self, x, pos, mask=None, gen=None):
        for blk in self.blocks:
            x = blk(x + pos, mask, gen)
        return x


class Decoder(Encoder):
    """An encoder stack and a final LayerNorm."""

    def __init__(self, dim: int, depth: int, heads: int, rate: float):
        super().__init__(dim, depth, heads, rate)
        self.norm = LayerNorm(dim)

    def forward(self, x, pos, mask=None, gen=None):
        return self.norm(super().forward(x, pos, mask, gen))


class PatchEncoder(nn.Module):
    """Mini-PointNet over each group: 3->128 BN ReLU 128->256, the group's
    max concatenated to every point, 512->512 BN ReLU 512->out, max."""

    def __init__(self, out_dim: int):
        super().__init__()
        self.first_conv = nn.Sequential(PointConv(3, 128), BatchNorm(128), nn.ReLU(),
                                        PointConv(128, 256))
        self.second_conv = nn.Sequential(PointConv(512, 512), BatchNorm(512), nn.ReLU(),
                                         PointConv(512, out_dim))

    def forward(self, groups):
        x = self.first_conv(groups)
        g = x.max(dim=-2, keepdim=True).values
        x = self.second_conv(torch.cat([g.expand_as(x), x], dim=-1))
        return x.max(dim=-2).values


def pos_mlp(dim: int) -> nn.Sequential:
    return nn.Sequential(Dense(3, 128), nn.GELU(), Dense(128, dim))


# ---------------------------------------------------------------- masks


def rank(x: torch.Tensor) -> torch.Tensor:
    """Ascending rank of each entry in its row, ties in index order."""
    return torch.argsort(torch.argsort(x, dim=-1, stable=True), dim=-1, stable=True)


def gm3d_num_mask(groups: int, ratio: float) -> int:
    return groups - int(groups * (1.0 - ratio))


def geometric_mask(loss_pred: torch.Tensor, num_mask: int, keep_ratio: float,
                   noise: torch.Tensor) -> torch.Tensor:
    """GM3D's mask: the floor(num_mask * keep_ratio) groups of highest
    predicted loss, the rest of the ``num_mask`` by least ``-noise`` rank
    among the others. True = masked."""
    groups = loss_pred.shape[1]
    by_loss_count = int(torch.floor(torch.tensor(keep_ratio, dtype=torch.float32) * num_mask))
    r = rank(loss_pred.float())
    by_loss = r >= groups - by_loss_count
    key = torch.where(by_loss, 2.0 + r.float(), noise.float())
    return rank(-key) < num_mask


def mask_from_set(by_loss: torch.Tensor, num_mask: int, noise: torch.Tensor) -> torch.Tensor:
    """The geometric mask given the groups chosen by predicted loss: those,
    and the rest of the ``num_mask`` slots by least ``-noise`` rank."""
    return rank(-torch.where(by_loss, 2.0, noise.float())) < num_mask


def judge_masks(loss_pred: torch.Tensor, num_mask: int, keep_ratio: float, noise: torch.Tensor,
                program_mask: Optional[torch.Tensor], tie: float):
    """The reference's geometric mask, held against the program's.

    A mask is a discrete choice: where two groups' predicted losses tie to
    rounding, the program (its EMA pass on fused kernels) and the reference
    may rank them the other way round. For each cloud whose masks differ,
    the program's mask is taken if it is the mask of a choice of the
    loss-chosen groups that differs from the reference's only among groups
    whose predicted loss lies within ``tie`` (in the predicted loss's own
    units) of the boundary value; otherwise the reference keeps its own
    mask, and the program's error shows in the gaps. Returns (mask, clouds
    taken)."""
    mask = geometric_mask(loss_pred, num_mask, keep_ratio, noise)
    if program_mask is None or program_mask.shape != mask.shape:
        return mask, 0
    program_mask = program_mask.to(mask.device)
    groups = loss_pred.shape[1]
    count = int(torch.floor(torch.tensor(keep_ratio, dtype=torch.float32) * num_mask))
    taken = 0
    for b in torch.nonzero((mask != program_mask).any(dim=1)).flatten().tolist():
        lp = loss_pred[b].float()
        if count == 0:
            continue
        boundary = torch.sort(lp, stable=True).values[groups - count]
        sure = lp > boundary + tie
        # a group chosen by its loss is masked: pick only among masked ones
        near = torch.nonzero(((lp - boundary).abs() <= tie) & program_mask[b]).flatten().tolist()
        need = count - int(sure.sum())
        if not 0 < need <= len(near) or math.comb(len(near), need) > 256:
            continue
        for pick in itertools.combinations(near, need):
            by_loss = sure.clone()
            by_loss[list(pick)] = True
            candidate = mask_from_set(by_loss[None], num_mask, noise[b][None])[0]
            if torch.equal(candidate, program_mask[b]):
                mask[b] = program_mask[b]
                taken += 1
                break
    return mask, taken


def split_indices(mask: torch.Tensor, num_mask: int):
    """(visible, masked) group indices, each in group order."""
    order = torch.argsort(mask.to(torch.int32), dim=-1, stable=True)
    return order[:, : mask.shape[1] - num_mask], order[:, mask.shape[1] - num_mask:]


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, G, ...) gathered along the groups by (B, K)."""
    index = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(-1, -1, *x.shape[2:])
    return torch.gather(x, 1, index)


# ---------------------------------------------------------------- losses


def chamfer_group(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-group Chamfer-L2: the mean nearest squared distance both ways."""
    cross = a @ b.transpose(-1, -2)
    d = ((a * a).sum(-1)[..., :, None] - 2.0 * cross + (b * b).sum(-1)[..., None, :]).clamp_min(0)
    return d.min(dim=-1).values.mean(-1) + d.min(dim=-2).values.mean(-1)


def feature_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    pn = pred / torch.linalg.norm(pred, dim=-1, keepdim=True).clamp_min(1e-12)
    tn = target / torch.linalg.norm(target, dim=-1, keepdim=True).clamp_min(1e-12)
    return ((pn - tn) ** 2).sum(-1)


def relative_learning_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pairwise ranking BCE of the predicted losses against the real ones."""
    pos = (target[:, :, None] > target[:, None, :]).float()
    neg = (target[:, :, None] < target[:, None, :]).float()
    sig = torch.sigmoid(pred[:, :, None] - pred[:, None, :])
    loss = -pos * torch.log(sig + 1e-6) - neg * torch.log(1.0 - sig + 1e-6)
    return loss.sum() / (pos + neg).sum()


# ---------------------------------------------------------------- schedules


def cosine_lr(step: int, base_lr: float, warmup_epochs: float, epochs: float,
              steps_per_epoch: int, min_lr: float = 0.0) -> float:
    epoch = step / steps_per_epoch
    if epoch < warmup_epochs:
        return base_lr * epoch / warmup_epochs
    return min_lr + (base_lr - min_lr) * 0.5 * (
        1.0 + math.cos(math.pi * (epoch - warmup_epochs) / (epochs - warmup_epochs)))


def gm3d_scalars(epoch: int, epochs: int, after_epoch: int = 15,
                 multipliers=(13.889, 1000.0)) -> dict:
    """GM3D's epoch knobs: the share of masked groups chosen by predicted
    loss, the EMA decay, and the weights of the MSE and Chamfer terms."""
    w = (1.0, 1.0) if epoch < after_epoch else multipliers
    decay = 0.999 + epoch / 100.0 * (0.9999 - 0.999) if epoch < 100 else 0.9999
    return {"keep_ratio": (epoch + 1) / epochs * 0.8, "ema_decay": decay,
            "w_mse": float(w[0]), "w_cd": float(w[1])}


def uniform_draws(gen: torch.Generator, batch: int, groups: int, device) -> dict:
    """A step's draws, in order: the scale (B, 1, 3) in [2/3, 3/2), the shift
    in [-0.2, 0.2) and the mask's noise (B, G) in [0, 1)."""
    def u(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    return {"scale": u((batch, 1, 3), 2.0 / 3.0, 3.0 / 2.0),
            "shift": u((batch, 1, 3), -0.2, 0.2), "noise": u((batch, groups), 0.0, 1.0)}


# ---------------------------------------------------------------- optimizer


class AdamW:
    """AdamW (betas 0.9 / 0.95, eps 1e-8) with decoupled decay on tensors of
    two or more axes only, after clipping the global gradient norm at
    ``clip`` (scaled only when above it). ``zero_missing``: a parameter
    without a gradient steps with a zero one; otherwise it is skipped."""

    def __init__(self, params: Sequence[nn.Parameter], weight_decay: float, clip: float,
                 zero_missing: bool = False, betas=(0.9, 0.95), eps: float = 1e-8):
        self.params = list(params)
        self.wd, self.clip, self.zero_missing = weight_decay, clip, zero_missing
        self.b1, self.b2, self.eps = betas[0], betas[1], eps
        self.state: dict = {}
        self.last_grads: list = []

    @torch.no_grad()
    def step(self, lr: float) -> None:
        live = []
        for p in self.params:
            g = p.grad
            if g is None:
                if not self.zero_missing:
                    continue
                g = torch.zeros_like(p)
            live.append((p, g))
        norm = torch.stack([(g * g).sum() for _, g in live]).sum().sqrt()
        scale = torch.where(norm > self.clip, self.clip / norm, torch.ones_like(norm))
        self.last_grads = []
        for p, g in live:
            g = g * scale
            self.last_grads.append((p, g))
            st = self.state.setdefault(p, {"t": 0, "m": torch.zeros_like(p),
                                           "v": torch.zeros_like(p)})
            st["t"] += 1
            st["m"].mul_(self.b1).add_(g, alpha=1 - self.b1)
            st["v"].mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            if p.ndim > 1:
                p.mul_(1.0 - lr * self.wd)
            bc1, bc2 = 1 - self.b1 ** st["t"], 1 - self.b2 ** st["t"]
            p.sub_(lr / bc1 * st["m"] / (st["v"].sqrt() / math.sqrt(bc2) + self.eps))


@torch.no_grad()
def ema_update(ema: nn.Module, new: nn.Module, decay: float) -> None:
    """ema = decay * ema + (1 - decay) * new over the parameters and the
    floating buffers; the decay rounded to fp32."""
    d = float(torch.tensor(decay, dtype=torch.float32))
    new_state = new.state_dict()
    for name, e in ema.state_dict().items():
        n = new_state[name]
        if e.dtype.is_floating_point:
            e.mul_(d).add_(n, alpha=1.0 - d)
        else:
            e.copy_(n)
