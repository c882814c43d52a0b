"""Loss functions for pretraining (Point-MAE Chamfer, GM3D dual-objective,
learning-loss) and fine-tuning (CE with optional smoothing).

Port of ``gm3d_tpu/train/losses.py``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from gm3d_tpu_torch.models.pointmae import take_groups
from gm3d_tpu_torch.ops.chamfer import chamfer_group, chamfer_l1, chamfer_l2
from gm3d_tpu_torch.ops.emd import emd_loss
from gm3d_tpu_torch.parallel.mesh import global_count


def pointmae_reconstruction_loss(rebuild: torch.Tensor, gt: torch.Tensor,
                                 loss_type: str = "cdl2") -> torch.Tensor:
    """Scalar reconstruction loss over all masked patches (config ``model.loss``:
    cdl1 / cdl2 / emd, the last the mean Sinkhorn EMD of ``ops/emd.py``)."""
    batch, num_mask, group_size, _ = rebuild.shape
    a = rebuild.reshape(batch * num_mask, group_size, 3).to(torch.float32)
    b = gt.reshape(batch * num_mask, group_size, 3).to(torch.float32)
    if loss_type == "cdl1":
        return chamfer_l1(a, b)
    if loss_type == "emd":
        return emd_loss(a, b).mean()
    return chamfer_l2(a, b)


def _normalized_feature_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Squared distance of the L2-normalised features, summed over channels."""
    pn = pred.to(torch.float32)
    pn = pn / torch.linalg.norm(pn, dim=-1, keepdim=True).clamp_min(1e-12)
    tn = target.to(torch.float32)
    tn = tn / torch.linalg.norm(tn, dim=-1, keepdim=True).clamp_min(1e-12)
    return ((pn - tn) ** 2).sum(-1)


def gm3d_feature_loss(pred_masked: torch.Tensor, teacher_feats: torch.Tensor,
                      mask_idx: torch.Tensor, point_target: torch.Tensor,
                      point_reco: torch.Tensor) -> Dict[str, torch.Tensor]:
    """GM3D feature-mode loss.

    pred_masked:   (B, M, D) student decoder features at masked slots
    teacher_feats: (B, G, D) frozen-teacher encoder features (full cloud)
    mask_idx:      (B, M) masked group indices (original order)
    point_target:  (B, G, S, 3) teacher-decoded patches from teacher features
    point_reco:    (B, M, S, 3) teacher-decoded patches from student features
                   (computed without gradient by the caller: the Chamfer term
                   shapes the loss value and the matrix, not the gradient)
    """
    loss_mse = _normalized_feature_mse(pred_masked, take_groups(teacher_feats, mask_idx))
    pt_masked = take_groups(point_target, mask_idx).to(torch.float32)  # (B, M, S, 3)
    loss_chamfer = chamfer_group(point_reco.to(torch.float32), pt_masked)  # (B, M)
    return {"MSE_mean": loss_mse.mean(), "Chamfer_mean": loss_chamfer.mean(),
            "matrix": loss_mse + loss_chamfer}


def _coordinate_chamfer(rebuild_masked, neighborhood, mask_idx) -> torch.Tensor:
    batch, num_mask, _ = rebuild_masked.shape
    group_size = neighborhood.shape[2]
    pred = rebuild_masked.reshape(batch, num_mask, group_size, 3).to(torch.float32)
    gt = take_groups(neighborhood, mask_idx).to(torch.float32)
    return chamfer_group(pred, gt)


def gm3d_usual_loss(rebuild_masked: torch.Tensor, neighborhood: torch.Tensor,
                    mask_idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """GM3D usual-mode loss: per-group Chamfer only, MSE zeroed.

    rebuild_masked: (B, M, 3*S) coordinate predictions at masked slots.
    neighborhood:   (B, G, S, 3) center-normalised ground-truth patches.
    """
    loss_chamfer = _coordinate_chamfer(rebuild_masked, neighborhood, mask_idx)
    return {"MSE_mean": torch.zeros((), device=loss_chamfer.device),
            "Chamfer_mean": loss_chamfer.mean(), "matrix": loss_chamfer}


def gm3d_separated_loss(pred_masked: torch.Tensor, teacher_feats: torch.Tensor,
                        mask_idx: torch.Tensor, rebuild_masked: torch.Tensor,
                        neighborhood: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Separated-engine loss composition: normalised feature MSE against the
    frozen teacher PLUS per-group Chamfer between the student's OWN rebuilt
    coordinates and the ground-truth neighbourhood (inside the grad path)."""
    loss_mse = _normalized_feature_mse(pred_masked, take_groups(teacher_feats, mask_idx))
    loss_chamfer = _coordinate_chamfer(rebuild_masked, neighborhood, mask_idx)
    return {"MSE_mean": loss_mse.mean(), "Chamfer_mean": loss_chamfer.mean(),
            "matrix": loss_mse + loss_chamfer}


def relative_learning_loss(loss_pred: torch.Tensor, loss_target: torch.Tensor) -> torch.Tensor:
    """Pairwise relative loss-ordering BCE. loss_pred, loss_target: (B, M) at
    masked slots."""
    pred = loss_pred.to(torch.float32)
    target = loss_target.to(torch.float32)
    pos = (target[:, :, None] > target[:, None, :]).to(torch.float32)
    neg = (target[:, :, None] < target[:, None, :]).to(torch.float32)
    sig = torch.sigmoid(pred[:, :, None] - pred[:, None, :])
    loss = -pos * torch.log(sig + 1e-6) - neg * torch.log(1.0 - sig + 1e-6)
    # the pairs of the whole batch, under data parallelism too
    valid = global_count((pos + neg).sum())
    return loss.sum() / valid


def mse_learning_loss(loss_pred: torch.Tensor, loss_target: torch.Tensor) -> torch.Tensor:
    """Per-row-normalised MSE variant (unbiased row variance)."""
    target = loss_target.to(torch.float32)
    mean = target.mean(dim=1, keepdim=True)
    var = target.var(dim=1, keepdim=True, unbiased=True)
    target = (target - mean) / torch.sqrt(var + 1e-6)
    return ((loss_pred.to(torch.float32) - target) ** 2).mean()


def classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                        smoothing: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE loss + accuracy in percent."""
    num_classes = logits.shape[-1]
    one_hot = F.one_hot(labels.long(), num_classes).to(torch.float32)
    if smoothing > 0.0:
        one_hot = one_hot * (1.0 - smoothing) + smoothing / num_classes
    log_prob = F.log_softmax(logits.to(torch.float32), dim=-1)
    loss = -(one_hot * log_prob).sum(-1).mean()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean() * 100.0
    return loss, acc
