"""Point-M2AE: hierarchical multi-scale masked autoencoder.

Port of ``gm3d_tpu/models/m2ae.py``. The reference ships no code for this
family, only its configs (``configs/m2ae/config_Point_M2AE.yaml``): three
scales of 512 / 256 / 64 groups of 16 / 8 / 8 members, encoder depths 5 / 5 /
5 at widths 96 / 192 / 384 with local attention radii 0.32 / 0.64 / 1.28, a
decoder of two stages (widths 384 / 192) with one up-block each.

Masks are drawn at the COARSEST scale and back-projected: a finer token is
visible iff its nearest coarsest center is visible. Every scale keeps its
full token set; masking acts through the attention mask (a visible token
attends to visible tokens within the local radius, every token to itself)
and a learned placeholder at masked slots, which cross-scale pooling
excludes. Shapes are therefore the same whatever the mask.

The geometry (``build_hierarchy``: FPS then KNN at each scale, and the k = 1
maps of ``nearest_coarse_maps``) goes through ``ops.fps`` and ``ops.knn``,
the kernels for CUDA tensors. The attention sites carry a mask everywhere in
the encoder, so only the decoder's unmasked stages can take the fused
attention op (``models/blocks.py``, inside ``fused_attention_scope``, where
the sequence fits the kernel).

Parameter names are this package's own module names, kept close to the
flax ones (``encoder.stage{s}.blocks.{i}``, ``encoder.merge{s}.proj``,
``encoder.mask_feat{s}``, ``dec_stage{i}``, ``dec_up{i}``, ``lp_bn`` ...);
``ckpt/torch_import.py::M2AE_MAP`` pairs them with the flax paths. Train /
eval mode is the module's own; ``generator`` feeds stochastic depth.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gm3d_tpu_torch.models.blocks import (
    Dense,
    LayerNorm,
    PatchEncoder,
    PosEmbedMLP,
    TorchBatchNorm,
    TransformerEncoder,
    init_weights,
    trunc_normal_,
)
from gm3d_tpu_torch.models.point_transformer import ClsHead
from gm3d_tpu_torch.models.segmentation import HEAD_WIDTH, propagate_features
from gm3d_tpu_torch.ops.fps import fps_gather, fps_indices
from gm3d_tpu_torch.ops.knn import knn_indices

Hierarchy = Tuple[List[torch.Tensor], List[torch.Tensor]]


def lecun_normal_(linear: nn.Linear, generator: Optional[torch.Generator] = None) -> None:
    """flax ``nn.Dense``'s default init, which the JAX module keeps for its
    own dense layers: a normal truncated at two deviations with variance
    1 / fan-in, zero bias."""
    std = (1.0 / linear.in_features) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(linear.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
    nn.init.zeros_(linear.bias)


def local_attn_mask(centers: torch.Tensor, radius: float) -> torch.Tensor:
    """(B, G, 3) -> (B, G, G) bool: True where ||ci - cj|| < radius. The
    squared distance comes from the differences, as in the JAX function: the
    expanded ``q2 - 2qr + r2`` rounds otherwise, and pairs near the radius
    would flip."""
    d2 = ((centers[:, :, None, :] - centers[:, None, :, :]) ** 2).sum(-1)
    return d2 < radius * radius


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, ...) integer indices -> (B, ..., C)."""
    batch = x.shape[0]
    flat = idx.reshape(batch, -1, 1).long().expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, flat).reshape(*idx.shape, x.shape[-1])


def build_hierarchy(pts: torch.Tensor, num_groups: Sequence[int],
                    group_sizes: Sequence[int]) -> Hierarchy:
    """The FPS center pyramid and each scale's KNN members (geometry only,
    deterministic): ``(centers, member_idx)``, ``centers[s]`` (B, G_s, 3),
    ``member_idx[s]`` (B, G_s, k_s) int32 indices into the previous level
    (the raw points for s = 0). One FPS and one KNN launch a scale."""
    centers, member_idx = [], []
    prev = pts
    for g, k in zip(num_groups, group_sizes):
        c = fps_gather(prev, fps_indices(prev, g))
        centers.append(c)
        member_idx.append(knn_indices(prev, c, k))
        prev = c
    return centers, member_idx


def nearest_coarse_maps(centers: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """For every scale but the last, the index of the nearest COARSEST center
    of each of its centers: (B, G_s) int32, one k = 1 KNN launch a scale."""
    coarse = centers[-1]
    return tuple(knn_indices(coarse, centers[s], 1)[..., 0] for s in range(len(centers) - 1))


def propagate_masks(coarse_vis: torch.Tensor, centers: Sequence[torch.Tensor],
                    nearest: Optional[Sequence[torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """Back-project a coarsest-scale visibility (B, G_last) bool (True =
    visible) to every scale: a finer token is visible iff its nearest
    coarsest center is. ``nearest``: ``nearest_coarse_maps(centers)``, if
    already at hand."""
    if nearest is None:
        nearest = nearest_coarse_maps(centers)
    return tuple(torch.gather(coarse_vis, 1, n.long()) for n in nearest) + (coarse_vis,)


def neighborhoods(pts: torch.Tensor, idx: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The finest groups' members relative to their centers (B, G, k, 3)."""
    return gather_rows(pts, idx) - centers[:, :, None, :]


class TokenMerge(nn.Module):
    """Cross-scale pooling: each center of the new scale takes the max and
    the mean of its k previous-scale tokens (masked members excluded; a
    group with none valid pools to zeros) and projects them to its width."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Dense(2 * in_dim, out_dim, dtype=dtype)

    def forward(self, prev_tokens: torch.Tensor, member_idx: torch.Tensor,
                member_valid: torch.Tensor) -> torch.Tensor:
        feats = gather_rows(prev_tokens, member_idx)  # (B, G, k, C)
        valid = member_valid[..., None]
        # amax: a tie shares the gradient, as jnp.max's does
        pooled_max = torch.where(valid, feats, -1e9).amax(dim=2)
        pooled_max = torch.where(member_valid.any(dim=-1, keepdim=True), pooled_max, 0.0)
        denom = member_valid.sum(dim=-1, keepdim=True).clamp_min(1)
        pooled_mean = torch.where(valid, feats, 0.0).sum(2) / denom
        return self.proj(torch.cat([pooled_max, pooled_mean], dim=-1))


class M2AEEncoder(nn.Module):
    """The hierarchical encoder shared by pretraining and the classifier:
    the patch embed at the finest scale, then at each coarser one the merge
    of the previous scale's tokens; a positional embedding and a transformer
    stage a scale, under the local-radius attention mask."""

    def __init__(self, num_groups: Sequence[int] = (512, 256, 64),
                 group_sizes: Sequence[int] = (16, 8, 8),
                 encoder_depths: Sequence[int] = (5, 5, 5),
                 encoder_dims: Sequence[int] = (96, 192, 384),
                 local_radius: Sequence[float] = (0.32, 0.64, 1.28),
                 num_heads: int = 6, drop_path_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_groups, self.group_sizes = tuple(num_groups), tuple(group_sizes)
        self.encoder_dims, self.local_radius = tuple(encoder_dims), tuple(local_radius)
        self.num_heads, self.drop_path_rate = num_heads, drop_path_rate
        self.num_scales = len(self.num_groups)
        self.patch_embed = PatchEncoder(encoder_dims[0], dtype=dtype)
        for s in range(self.num_scales):
            if s:
                setattr(self, f"merge{s}", TokenMerge(encoder_dims[s - 1], encoder_dims[s], dtype))
            setattr(self, f"pos{s}", PosEmbedMLP(encoder_dims[s], dtype=dtype))
            setattr(self, f"stage{s}", TransformerEncoder(
                encoder_dims[s], encoder_depths[s], num_heads, drop_path_rate, dtype=dtype))
            setattr(self, f"mask_feat{s}", nn.Parameter(torch.zeros(1, 1, encoder_dims[s])))

    def mask_feat(self, s: int) -> torch.Tensor:
        return getattr(self, f"mask_feat{s}")

    def reset_merge_projections(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's default init (``lecun_normal_``) for the merge projections,
        which the JAX module keeps; the rest of the encoder takes
        ``init_weights``' from the model that holds it."""
        for s in range(1, self.num_scales):
            lecun_normal_(getattr(self, f"merge{s}").proj, generator)

    def hierarchy(self, pts: torch.Tensor) -> Hierarchy:
        return build_hierarchy(pts, self.num_groups, self.group_sizes)

    def stages(self) -> tuple:
        """The transformer stages, finest first: the order of the forward."""
        return tuple(getattr(self, f"stage{s}") for s in range(self.num_scales))

    def forward(self, pts: torch.Tensor, vis_masks: Optional[Sequence[torch.Tensor]] = None,
                hierarchy: Optional[Hierarchy] = None,
                generator: Optional[torch.Generator] = None,
                depth_masks: Optional[tuple] = None):
        """Encode every scale. ``vis_masks``: one (B, G_s) bool a scale (True =
        visible), or None for the unmasked path. ``hierarchy``: a
        ``build_hierarchy`` result of ``pts``, if already at hand.
        ``depth_masks``: ``blocks.draw_depth_masks`` over ``stages()``, in
        place of stochastic-depth draws from ``generator``. Returns
        ``(tokens_per_scale, centers, member_idx)``."""
        centers, member_idx = hierarchy if hierarchy is not None else self.hierarchy(pts)
        tokens_all = []
        tokens = None
        for s in range(self.num_scales):
            if s == 0:
                tokens = self.patch_embed(neighborhoods(pts, member_idx[0], centers[0]))
            else:
                if vis_masks is not None:
                    member_valid = torch.gather(
                        vis_masks[s - 1], 1, member_idx[s].reshape(pts.shape[0], -1).long()
                    ).reshape(member_idx[s].shape)
                else:
                    member_valid = torch.ones(member_idx[s].shape, dtype=torch.bool,
                                              device=pts.device)
                tokens = getattr(self, f"merge{s}")(tokens, member_idx[s], member_valid)
            pos = getattr(self, f"pos{s}")(centers[s])
            local = local_attn_mask(centers[s], self.local_radius[s])
            if vis_masks is not None:
                vis = vis_masks[s]
                tokens = torch.where(vis[..., None], tokens, self.mask_feat(s).to(tokens.dtype))
                allow = local & vis[:, None, :] & vis[:, :, None]
                eye = torch.eye(tokens.shape[1], dtype=torch.bool, device=tokens.device)[None]
                attn_mask = allow | eye
            else:
                attn_mask = local
            tokens = getattr(self, f"stage{s}")(
                tokens, pos, attn_mask, generator,
                None if depth_masks is None else depth_masks[s])
            tokens_all.append(tokens)
        return tokens_all, centers, member_idx


class PointM2AE(nn.Module):
    """The Point-M2AE pretrain model (registry name ``Point_M2AE``), with the
    GM3D loss-prediction head at the coarsest scale.

    ``svm_scales``: the SVM probe's pooling, ``"all"`` (mean + max of every
    scale, concatenated) or ``"last"`` (the coarsest only). ``encoder``:
    ``M2AEEncoder``'s arguments (scales, depths, widths, radii, heads, drop
    path), which the decoder's stages share."""

    def __init__(self, decoder_depths: Sequence[int] = (1, 1),
                 decoder_dims: Sequence[int] = (384, 192),
                 decoder_up_blocks: Sequence[int] = (1, 1),
                 mask_ratio: float = 0.8, svm_scales: str = "all",
                 dtype: torch.dtype = torch.float32, **encoder):
        super().__init__()
        if svm_scales not in ("all", "last"):
            raise ValueError(f"svm_scales must be 'all' or 'last', got {svm_scales!r}")
        self.encoder = M2AEEncoder(dtype=dtype, **encoder)
        self.num_groups, self.group_sizes = self.encoder.num_groups, self.encoder.group_sizes
        self.encoder_dims, self.decoder_dims = self.encoder.encoder_dims, tuple(decoder_dims)
        self.mask_ratio, self.svm_scales = mask_ratio, svm_scales
        # the width of ``encode_features``' tokens (the --classification probe's input)
        self.trans_dim = self.encoder_dims[-1]
        num_scales, encoder_dims = len(self.num_groups), self.encoder_dims
        num_heads, drop_path_rate = self.encoder.num_heads, self.encoder.drop_path_rate
        # decoder stage 0 runs at the coarsest scale; stage i upsamples to
        # scale num_scales - 1 - i and fuses the encoder's tokens there
        for i, width in enumerate(decoder_dims):
            skip = 0 if i == 0 else encoder_dims[num_scales - 1 - i]
            prev = encoder_dims[-1] if i == 0 else decoder_dims[i - 1]
            setattr(self, f"dec_pos{i}", PosEmbedMLP(width, dtype=dtype))
            setattr(self, f"dec_stage{i}", TransformerEncoder(
                width, decoder_depths[i], num_heads, drop_path_rate, dtype=dtype))
            setattr(self, f"dec_proj{i}", Dense(prev + skip, width, dtype=dtype))
        # up-block i refines the tokens of the scale just entered, before that
        # scale's stage; the last one refines the finest scale before the head
        up_dims = list(decoder_dims[1:]) + [decoder_dims[-1]]
        for i, blocks in enumerate(decoder_up_blocks):
            setattr(self, f"dec_up{i}", TransformerEncoder(
                up_dims[i], blocks, num_heads, drop_path_rate, dtype=dtype))
        self.num_up = len(decoder_up_blocks)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_dims[0]))
        self.rec_head = Dense(decoder_dims[-1], 3 * self.group_sizes[0], dtype=dtype)
        self.lp_fc1 = Dense(decoder_dims[0], 1024, dtype=dtype)
        self.lp_bn = TorchBatchNorm(1024, dtype)
        self.lp_fc2 = Dense(1024, decoder_dims[0], dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX module's inits: trunc-normal(0.02) in the blocks, patch
        embed and positional embeddings; flax's default (``lecun_normal_``)
        for its own dense layers; the mask token trunc-normal(0.02), the
        placeholders zero."""
        init_weights(self, generator)
        self.encoder.reset_merge_projections(generator)
        own = [getattr(self, f"dec_proj{i}") for i in range(len(self.decoder_dims))]
        for layer in own + [self.rec_head, self.lp_fc1, self.lp_fc2]:
            lecun_normal_(layer, generator)
        trunc_normal_(self.mask_token, generator)

    def encode_features(self, pts: torch.Tensor) -> torch.Tensor:
        """The unmasked coarsest tokens (B, G_last, C_last): the supervised
        probe's and the feature export's surface."""
        return self.encoder(pts)[0][-1]

    def pooled_features(self, pts: torch.Tensor) -> torch.Tensor:
        """The SVM probe's features: ``mean + max`` over each scale's tokens,
        concatenated over the scales (``svm_scales="all"``, (B, sum C_s)) or
        the coarsest only (``"last"``, (B, C_last))."""
        tokens_all = self.encoder(pts)[0]
        if self.svm_scales == "last":
            tokens_all = tokens_all[-1:]
        return torch.cat([t.mean(dim=1) + t.amax(dim=1) for t in tokens_all], dim=-1)

    def forward(self, pts: torch.Tensor, coarse_vis: torch.Tensor,
                hierarchy: Optional[Hierarchy] = None,
                generator: Optional[torch.Generator] = None,
                loss_pred_only: bool = False) -> dict:
        """Masked hierarchical reconstruction.

        ``coarse_vis`` (B, G_last) bool, True = visible, drawn outside.
        ``hierarchy``: a ``build_hierarchy`` result of ``pts``, which the
        train step shares between its EMA and student passes.
        ``loss_pred_only``: stop after the loss-prediction head and return
        ``{"loss_pred"}`` (the EMA pass, which feeds only the mask; the JAX
        step's compiler drops the rest as dead code).

        Returns ``rebuild`` and ``gt`` (B, G_0, k_0, 3), ``fine_vis``,
        ``coarse_vis``, ``centers``, ``loss_pred`` (B, G_last) fp32 and
        ``fine_to_coarse`` (B, G_0), each finest group's nearest coarsest one."""
        if hierarchy is None:
            hierarchy = self.encoder.hierarchy(pts)
        nearest_coarse = nearest_coarse_maps(hierarchy[0])
        vis_masks = propagate_masks(coarse_vis, hierarchy[0], nearest_coarse)
        tokens_all, centers, member_idx = self.encoder(pts, vis_masks, hierarchy, generator)

        # decoder stage 0: the coarsest scale, the mask token at masked slots
        x = self.dec_proj0(tokens_all[-1])
        x = torch.where(vis_masks[-1][..., None], x, self.mask_token.to(x.dtype))
        x = self.dec_stage0(x, self.dec_pos0(centers[-1]), None, generator)

        lp = F.leaky_relu(self.lp_bn(self.lp_fc1(x)), negative_slope=0.2)
        loss_pred = self.lp_fc2(lp).to(torch.float32).mean(dim=-1)  # (B, G_last)
        if loss_pred_only:
            return {"loss_pred": loss_pred}

        # upsample stages: the nearest coarser token, fused with the skip
        scale = len(centers) - 1
        for i in range(1, len(self.decoder_dims)):
            scale -= 1
            if scale + 1 == len(centers) - 1:
                nearest = nearest_coarse[scale]
            else:
                nearest = knn_indices(centers[scale + 1], centers[scale], 1)[..., 0]
            up = gather_rows(x, nearest)
            skip = torch.where(vis_masks[scale][..., None], tokens_all[scale],
                               self.encoder.mask_feat(scale).to(x.dtype))
            x = getattr(self, f"dec_proj{i}")(torch.cat([up, skip], dim=-1))
            pos = getattr(self, f"dec_pos{i}")(centers[scale])
            x = getattr(self, f"dec_up{i - 1}")(x, pos, None, generator)
            x = getattr(self, f"dec_stage{i}")(x, pos, None, generator)

        # down to the finest scale, its up-blocks, the reconstruction head
        while scale > 0:
            scale -= 1
            x = gather_rows(x, knn_indices(centers[scale + 1], centers[scale], 1)[..., 0])
        last = len(self.decoder_dims) - 1
        fine_pos = getattr(self, f"dec_pos{last}")(centers[0])
        x = getattr(self, f"dec_up{self.num_up - 1}")(x, fine_pos, None, generator)

        batch = pts.shape[0]
        rebuild = self.rec_head(x).reshape(batch, self.num_groups[0], self.group_sizes[0], 3)
        gt = neighborhoods(pts, member_idx[0], centers[0])
        if nearest_coarse:
            fine_to_coarse = nearest_coarse[0]
        else:
            fine_to_coarse = torch.arange(self.num_groups[0], device=pts.device).expand(batch, -1)
        return {"rebuild": rebuild, "gt": gt, "fine_vis": vis_masks[0],
                "coarse_vis": coarse_vis, "centers": centers, "loss_pred": loss_pred,
                "fine_to_coarse": fine_to_coarse}


class PointM2AEClassifier(nn.Module):
    """The finetune classifier on the hierarchical encoder (registry names
    ``Point_M2AE_ModelNet40`` / ``Point_M2AE_ScanObjectNN``): the unmasked
    encoder, a LayerNorm a scale, mean and max of each scale concatenated,
    then the head Linear-BN-ReLU-Dropout x2 -> logits
    (``cls_head_finetune``, the flax ``head_fc1`` ... ``head_out``).
    ``encoder``: ``M2AEEncoder``'s arguments."""

    def __init__(self, cls_dim: int = 40, dtype: torch.dtype = torch.float32, **encoder):
        super().__init__()
        self.encoder = M2AEEncoder(dtype=dtype, **encoder)
        self.cls_dim, self.num_groups = cls_dim, self.encoder.num_groups
        for s, dim in enumerate(self.encoder.encoder_dims):
            setattr(self, f"norm{s}", LayerNorm(dim, dtype=dtype))
        self.cls_head_finetune = ClsHead(2 * sum(self.encoder.encoder_dims), cls_dim, dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """As ``PointM2AE.reset_parameters``; the head's dense layers flax's default."""
        init_weights(self, generator)
        self.encoder.reset_merge_projections(generator)
        for layer in self.cls_head_finetune:
            if isinstance(layer, nn.Linear):
                lecun_normal_(layer, generator)

    def drop_path_encoders(self) -> tuple:
        """The block stacks whose stochastic depth a train-mode forward draws,
        in its order (``blocks.draw_depth_masks``)."""
        return self.encoder.stages()

    def forward(self, pts: torch.Tensor, dropout_masks=None,
                generator: Optional[torch.Generator] = None,
                depth_masks: Optional[tuple] = None) -> torch.Tensor:
        """Logits. In train mode ``dropout_masks`` (the head's two keep masks,
        ``ClsHead.forward``) replace the head's dropout draws and
        ``generator`` draws stochastic depth, or ``depth_masks`` hold it."""
        tokens_all = self.encoder(pts, generator=generator, depth_masks=depth_masks)[0]
        parts = []
        for s, tokens in enumerate(tokens_all):
            x = getattr(self, f"norm{s}")(tokens)
            parts += [x.mean(dim=1), x.amax(dim=1)]
        return self.cls_head_finetune(torch.cat(parts, dim=-1), dropout_masks)


class PointM2AESeg(nn.Module):
    """Part segmentation on the hierarchical encoder (registry name
    ``Point_M2AE_SEG``; ``gm3d_tpu/models/segmentation.py::PointM2AESeg``):
    the unmasked encoder, a LayerNorm a scale, each scale's tokens propagated
    onto every point (``propagate_features``: a k = 3 KNN launch a scale),
    max and mean of each scale as the global feature, and ``PointMAESeg``'s
    category-conditioned per-point head, under the same names
    (``label_embed``, ``prop_proj``, ``head_fc1`` ...) and the same
    ``(pts, cls_label, dropout_mask, generator)`` contract, so the seg step,
    CLI, export and serving take it unchanged. Its ``encoder`` is the
    pretrain model's, so a Point-M2AE checkpoint overlays as it is.
    ``encoder``: ``M2AEEncoder``'s arguments."""

    def __init__(self, num_classes: int = 16, num_parts: int = 50, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32, **encoder):
        super().__init__()
        self.encoder = M2AEEncoder(dtype=dtype, **encoder)
        self.num_groups = self.encoder.num_groups
        self.num_classes, self.num_parts = num_classes, num_parts
        self.compute_dtype = dtype
        for s, dim in enumerate(self.encoder.encoder_dims):
            setattr(self, f"norm{s}", LayerNorm(dim, dtype=dtype))
        width = sum(self.encoder.encoder_dims)
        self.label_embed = Dense(num_classes, 64, dtype=dtype)
        self.prop_proj = Dense(width, 512, dtype=dtype)
        self.head_fc1 = Dense(512 + 2 * width + 64 + 3, HEAD_WIDTH, dtype=dtype)
        self.head_bn1 = TorchBatchNorm(HEAD_WIDTH, dtype)
        self.head_fc2 = Dense(HEAD_WIDTH, 256, dtype=dtype)
        self.head_bn2 = TorchBatchNorm(256, dtype)
        self.head_out = Dense(256, num_parts, dtype=dtype)
        self.dropout = nn.Dropout(dropout)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """As ``PointM2AE.reset_parameters``; the head's dense layers flax's default."""
        init_weights(self, generator)
        self.encoder.reset_merge_projections(generator)
        for layer in (self.label_embed, self.prop_proj, self.head_fc1, self.head_fc2,
                      self.head_out):
            lecun_normal_(layer, generator)

    def forward(self, pts: torch.Tensor, cls_label: torch.Tensor,
                dropout_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """pts (B, N, 3); cls_label (B,) object category -> per-point part
        logits (B, N, num_parts). ``dropout_mask`` and ``generator`` as in
        ``PointMAESeg.forward``."""
        dt = self.compute_dtype
        tokens_all, centers, _ = self.encoder(pts, generator=generator)
        propagated, pooled = [], []
        for s, tokens in enumerate(tokens_all):
            x = getattr(self, f"norm{s}")(tokens)
            propagated.append(propagate_features(pts, centers[s], x))
            pooled += [x.amax(dim=1), x.mean(dim=1)]
        per_point = self.prop_proj(torch.cat(propagated, dim=-1))
        global_feat = torch.cat(pooled, dim=-1)
        cls_emb = self.label_embed(F.one_hot(cls_label.long(), self.num_classes).to(dt))
        batch, num_points = pts.shape[:2]
        h = torch.cat([per_point, global_feat[:, None].expand(batch, num_points, -1),
                       cls_emb[:, None].expand(batch, num_points, -1), pts.to(dt)], dim=-1)
        h = F.relu(self.head_bn1(self.head_fc1(h)))
        if self.training:
            if dropout_mask is None:
                h = self.dropout(h)
            else:
                h = torch.where(dropout_mask, h / (1.0 - self.dropout.p), 0.0)
        h = F.relu(self.head_bn2(self.head_fc2(h)))
        return self.head_out(h)
