"""NAS-FCOS and PISA-RetinaNet, the counterpart of the JAX package's
``models/dense_heads/pisa_nasfcos.py`` (``NASFCOS``, ``nasfcos_loss``,
``nasfcos_decode``, ``isr_p_weights``, ``pisa_retina_loss``):

- ``NASFCOS`` is FCOS with the same parameter names: the JAX package's
  NAS-FCOS has neither the searched neck nor the searched head tower of
  mmdet's ``nasfcos_head.py`` (ROADMAP fault F25), so its outputs equal
  FCOS's with the same weights;
- PISA-RetinaNet is RetinaNet's tower (``retina_head.RetinaNet``) with the
  prime-sample-attention loss: RetinaNet's assignment (IoU 0.5 / 0.4, the
  anchors inside the image), ISR-P (each positive's focal-loss weight from
  its IoU rank within its class, ((1 - rank / n) )^2, renormalised to keep
  the positives' total) and CARL (the L1 regression loss scaled again by
  0.2 + 0.8 sigmoid(the gt class's logit), which carries the gradient into
  the classifier).

The within-class rank is one composite-key double argsort (stable, as
``jnp.argsort``) less each class segment's first position (a
``scatter_reduce`` ``amin`` over ``num_classes + 1`` segments, the last the
non-positives).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ...core import assigners, boxes as box_ops, losses
from .fcos_head import FCOS, fcos_decode, fcos_loss


class NASFCOS(FCOS):
    """FCOS's assembly and parameter names (F25)."""


nasfcos_loss = fcos_loss
nasfcos_decode = fcos_decode


class PISALossOut(NamedTuple):
    loss_cls: torch.Tensor
    loss_bbox: torch.Tensor
    loss_carl: torch.Tensor


def isr_p_weights(labels: torch.Tensor, ious: torch.Tensor,
                  pos: torch.Tensor, num_classes: int, bias: float = 0.0,
                  k: float = 2.0) -> torch.Tensor:
    """ISR-P: within each class the positives ranked by IoU with their gt
    (rank 0 the highest), weight (bias + (1 - bias) (1 - rank / n))^k,
    scaled so that the positives' weights sum to their count; 1 elsewhere."""
    lab = torch.where(pos, labels.long().clamp(0, num_classes - 1),
                      num_classes)
    key = lab.float() * 4.0 - ious.clamp(0.0, 1.0)
    grank = torch.argsort(torch.argsort(key, stable=True), stable=True)
    segs = num_classes + 1
    seg_start = torch.full((segs,), grank.numel(), dtype=grank.dtype,
                           device=grank.device).scatter_reduce(
        0, lab, grank, "amin")
    rank = (grank - seg_start[lab]).float()
    cls_n = torch.zeros(segs, dtype=grank.dtype, device=grank.device
                        ).scatter_reduce(0, lab, torch.ones_like(grank), "sum")
    n = cls_n[lab].clamp_min(1).float()
    w = (bias + (1 - bias) * (1.0 - rank / n)) ** k
    tot = torch.where(pos, w, 0.0).sum().clamp_min(1e-6)
    npos = pos.sum().float().clamp_min(1.0)
    return torch.where(pos, w * npos / tot, 1.0)


def pisa_retina_loss(level_outs, level_anchors: Sequence[torch.Tensor],
                     gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                     gt_valid: torch.Tensor, img_shape, num_classes: int,
                     carl_k: float = 1.0, carl_bias: float = 0.2
                     ) -> PISALossOut:
    """level_outs: per level (cls [h, w, A*C], reg [h, w, A*4]) of one
    image; RetinaNet's anchors."""
    cls_all = torch.cat([c.reshape(-1, num_classes).float()
                         for c, _ in level_outs])
    reg_all = torch.cat([r.reshape(-1, 4).float() for _, r in level_outs])
    anchors = torch.cat(list(level_anchors))
    h, w = img_shape[0], img_shape[1]
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] <= w) & (anchors[:, 3] <= h))
    assign = assigners.max_iou_assign(anchors, gt_boxes, gt_labels, gt_valid,
                                      0.5, 0.4, min_pos_iou=0.0,
                                      box_valid=inside)
    pos = assign.assigned_gt_inds > 0
    neg = assign.assigned_gt_inds == 0
    num_pos = pos.sum().float().clamp_min(1.0)
    isr_w = isr_p_weights(assign.labels, assign.max_overlaps, pos,
                          num_classes)
    safe_lab = assign.labels.long().clamp(0, num_classes - 1)
    onehot = F.one_hot(safe_lab, num_classes).float() * pos[:, None]
    weight = ((pos | neg).float() * torch.where(pos, isr_w, 1.0))[:, None]
    loss_cls = losses.sigmoid_focal_loss(cls_all, onehot, weight=weight,
                                         avg_factor=num_pos)
    g = gt_boxes.shape[0]
    matched = gt_boxes[(assign.assigned_gt_inds - 1).clamp(0, g - 1)]
    l1 = (reg_all - box_ops.bbox2delta(anchors, matched)).abs().sum(-1)
    loss_bbox = (l1 * pos).sum() / num_pos
    p_lab = torch.gather(torch.sigmoid(cls_all), 1, safe_lab[:, None])[:, 0]
    carl_w = carl_bias + (1 - carl_bias) * p_lab
    loss_carl = carl_k * (l1 * carl_w * pos).sum() / num_pos
    return PISALossOut(loss_cls, loss_bbox, loss_carl)
