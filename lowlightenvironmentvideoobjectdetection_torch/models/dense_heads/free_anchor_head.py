"""FreeAnchor, the counterpart of the JAX package's
``models/dense_heads/free_anchor_head.py`` (``_iou_matrix``,
``free_anchor_loss``; mmdet's ``free_anchor_retina_head.py``): RetinaNet's
tower (``retina_head.RetinaNet``) with a learning-to-match loss.

- Positive bags: for each gt the ``pre_anchor_topk`` anchors of highest
  IoU (the families pass 16; ``top_k_stable``: RetinaNet's 9 anchors a
  position tie exactly against symmetric gts, and the ties go to the lower
  index, as ``lax.top_k``); each anchor's probability is its class
  probability times exp(-0.75 SmoothL1(deltas, target), beta 0.11, stds
  0.1 / 0.1 / 0.2 / 0.2); the bag's a mean-max (weights 1 / (1 - p),
  normalised, not detached); the loss alpha (0.5) times -log of it,
  averaged over the valid gts.
- Negatives: p = P(class) (1 - P(matched)), where P(matched) of an anchor
  and a class is the largest over that class's gts of the IoU ramp
  ((IoU - 0.6) / (the gt's best IoU - 0.6), clamped to [0, 1]) of the
  decoded predicted boxes (no gradient); the loss (1 - alpha) p^2 (-log(1 -
  p)), summed, over (valid gts x pre_anchor_topk).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ...core import boxes as box_ops
from .retina_head import top_k_stable

STDS = (0.1, 0.1, 0.2, 0.2)


# [Ga, 4] x [Gb, 4] -> [Ga, Gb]: the JAX ``_iou_matrix`` is
# ``bbox_overlaps``'s formula, op for op
_iou_matrix = box_ops.bbox_overlaps


class FreeAnchorLossOut(NamedTuple):
    positive_bag_loss: torch.Tensor
    negative_bag_loss: torch.Tensor


def free_anchor_loss(level_outs, level_anchors: Sequence[torch.Tensor],
                     gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                     gt_valid: torch.Tensor, num_classes: int,
                     pre_anchor_topk: int = 50, bbox_thr: float = 0.6,
                     gamma: float = 2.0, alpha: float = 0.5,
                     beta: float = 0.11, bbox_loss_weight: float = 0.75
                     ) -> FreeAnchorLossOut:
    """level_outs: per level (cls [h, w, A*C], reg [h, w, A*4]) of one
    image; RetinaNet's anchors."""
    cls_all = torch.cat([c.reshape(-1, num_classes).float()
                         for c, _ in level_outs])
    reg_all = torch.cat([r.reshape(-1, 4).float() for _, r in level_outs])
    anchors = torch.cat(list(level_anchors))
    cls_prob = torch.sigmoid(cls_all)  # [A, C]
    eps = 1e-12
    valid_f = gt_valid.float()
    safe_lab = gt_labels.long().clamp(0, num_classes - 1)
    # negatives: P(an anchor matched) over the decoded predictions
    with torch.no_grad():
        pred_boxes = box_ops.delta2bbox(anchors, reg_all, stds=STDS)
        obj_iou = _iou_matrix(gt_boxes, pred_boxes)  # [G, A]
        t2 = obj_iou.amax(1, keepdim=True).clamp_min(bbox_thr + 1e-12)
        obj_prob = ((obj_iou - bbox_thr) / (t2 - bbox_thr)).clamp(0.0, 1.0)
        obj_prob = obj_prob * valid_f[:, None]
        onehot_g = F.one_hot(safe_lab, num_classes).float() * valid_f[:, None]
        image_box_prob = (obj_prob[:, :, None]
                          * onehot_g[:, None, :]).amax(0)  # [A, C]
    neg_p = (cls_prob * (1 - image_box_prob)).clamp(eps, 1 - eps)
    negative = (1 - alpha) * (neg_p ** gamma * -torch.log(1 - neg_p)).sum()
    # positive bags
    quality = _iou_matrix(gt_boxes, anchors)  # [G, A]
    k = min(pre_anchor_topk, anchors.shape[0])
    _, matched = top_k_stable(quality, k)  # [G, K]
    m_cls_prob = torch.gather(cls_prob[matched], 2,
                              safe_lab[:, None, None].expand(-1, k, 1))[..., 0]
    tgt = box_ops.bbox2delta(anchors[matched].reshape(-1, 4),
                             gt_boxes.repeat_interleave(k, dim=0),
                             stds=STDS).reshape(-1, k, 4)
    diff = (reg_all[matched] - tgt).abs()
    sl1 = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    m_box_prob = torch.exp(-bbox_loss_weight * sl1.sum(-1))  # [G, K]
    m_prob = m_cls_prob * m_box_prob
    weight = 1.0 / (1 - m_prob).clamp_min(1e-12)
    weight = weight / weight.sum(1, keepdim=True)
    bag_prob = (weight * m_prob).sum(1)
    pos_per_gt = alpha * -torch.log(bag_prob.clamp(eps, 1.0))
    num_pos = valid_f.sum().clamp_min(1.0)
    positive = (pos_per_gt * valid_f).sum() / num_pos
    negative = negative / (num_pos * pre_anchor_topk).clamp_min(1.0)
    return FreeAnchorLossOut(positive, negative)
