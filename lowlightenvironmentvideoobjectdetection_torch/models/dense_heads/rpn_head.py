"""RPN head, its loss and static-shape proposal generation, the counterpart
of the JAX package's ``models/dense_heads/rpn_head.py`` (``RPNHead``,
``RPNLossOut``, ``rpn_loss``, ``Proposals``, ``rpn_proposals``). The loss
and the proposals take one level (the DC5 detectors have one) or lists of
levels (FPN): the levels are flattened and concatenated, so the loss
assigns over every anchor at once and the proposals decode every anchor of
every level before one NMS over the top ``nms_pre`` of all levels, as the
JAX package does (ROADMAP fault F19: mmdet keeps ``nms_pre`` a level and
runs NMS on each level apart)."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import assigners, boxes as box_ops, losses, nms as nms_ops
from ..backbones.resnet import Conv2d

# the reference RPN train config: 256 anchors sampled at half positives;
# IoU 0.7 positive, 0.3 negative and low-quality floor; SmoothL1 beta 1/9
RPN_NUM_SAMPLES, RPN_POS_FRACTION = 256, 0.5
RPN_POS_IOU, RPN_NEG_IOU, RPN_MIN_POS_IOU = 0.7, 0.3, 0.3
RPN_BETA = 1.0 / 9.0


class RPNHead(nn.Module):
    """3x3 conv + relu, 1x1 cls (one logit per anchor), 1x1 reg (4 per
    anchor)."""

    def __init__(self, in_channels: int = 512, feat_channels: int = 512,
                 num_base_anchors: int = 12, dtype=torch.float32):
        super().__init__()
        self.rpn_conv = Conv2d(in_channels, feat_channels, 3, padding=1,
                               dtype=dtype)
        self.rpn_cls = Conv2d(feat_channels, num_base_anchors, 1, dtype=dtype)
        self.rpn_reg = Conv2d(feat_channels, num_base_anchors * 4, 1,
                              dtype=dtype)

    def forward(self, x: torch.Tensor):
        """x: NHWC [T, H, W, C]. Returns (cls [T, H, W, A],
        reg [T, H, W, 4A]), NHWC like the JAX head, so a flatten gives the
        JAX anchor order (y, x, a)."""
        h = F.relu(self.rpn_conv(x.permute(0, 3, 1, 2)))
        return (self.rpn_cls(h).permute(0, 2, 3, 1),
                self.rpn_reg(h).permute(0, 2, 3, 1))


def _flatten_levels(cls, reg, anchors):
    """cls [..., H, W, A] and reg [..., H, W, 4A] with anchors [H*W*A, 4],
    or lists of them a level -> ([..., N], [..., N, 4], [N, 4]) over all
    levels."""
    if not isinstance(cls, (list, tuple)):
        lead = cls.shape[:-3]
        return (cls.reshape(*lead, -1).float(),
                reg.reshape(*lead, -1, 4).float(), anchors)
    lead = cls[0].shape[:-3]
    return (torch.cat([c.reshape(*lead, -1).float() for c in cls], -1),
            torch.cat([r.reshape(*lead, -1, 4).float() for r in reg], -2),
            torch.cat(list(anchors)))


class RPNLossOut(NamedTuple):
    loss_cls: torch.Tensor
    loss_bbox: torch.Tensor


def rpn_loss(cls, reg, anchors, gt_boxes: torch.Tensor,
             gt_valid: torch.Tensor, uniforms: torch.Tensor, img_shape
             ) -> RPNLossOut:
    """Single-image RPN loss from cls [H, W, A] and reg [H, W, 4A] (or
    lists of them and of the anchors, a level each): anchors fully inside
    ``img_shape`` (h, w) are assigned to the gts, 256 are sampled with
    ``uniforms`` [2, N] over all N anchors (``random_sample_masks``), then
    sigmoid cross entropy over the sample and SmoothL1 on the positives'
    deltas, both averaged over the sample size."""
    cls_all, reg_all, anchors = _flatten_levels(cls, reg, anchors)
    h, w = img_shape[0], img_shape[1]
    valid = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
             & (anchors[:, 2] <= w) & (anchors[:, 3] <= h))
    g = gt_boxes.shape[0]
    assign = assigners.max_iou_assign(
        anchors, gt_boxes, torch.zeros(g, dtype=torch.long,
                                       device=anchors.device),
        gt_valid, RPN_POS_IOU, RPN_NEG_IOU, RPN_MIN_POS_IOU, box_valid=valid)
    masks = assigners.random_sample_masks(assign, uniforms, RPN_NUM_SAMPLES,
                                          RPN_POS_FRACTION)
    pos_w = masks.pos_mask.float()
    cls_w = pos_w + masks.neg_mask.float()
    avg = cls_w.sum()
    loss_cls = losses.binary_cross_entropy(cls_all, pos_w, weight=cls_w,
                                           avg_factor=avg)
    matched = gt_boxes[(assign.assigned_gt_inds - 1).clamp(0, g - 1)]
    targets = box_ops.bbox2delta(anchors, matched)
    loss_bbox = losses.smooth_l1_loss(reg_all, targets, beta=RPN_BETA,
                                      weight=pos_w[:, None], avg_factor=avg)
    return RPNLossOut(loss_cls, loss_bbox)


class Proposals(NamedTuple):
    boxes: torch.Tensor  # [num, 4] (or [S, num, 4])
    scores: torch.Tensor  # [num]
    valid: torch.Tensor  # [num] bool


def rpn_proposals(cls, reg, anchors, img_shape, nms_pre: int = 6000,
                  nms_post: int = 600, iou_threshold: float = 0.7
                  ) -> Proposals:
    """Fixed-count proposals for one image from its RPN outputs
    (cls [H, W, A], reg [H, W, 4A], or lists of them and of the anchors, a
    level each): decode every anchor, clip to ``img_shape`` (h, w), then
    one NMS over the top ``nms_pre`` of all levels. With a leading stream
    axis (cls [S, H, W, A], reg [S, H, W, 4A], img_shape [S, 2]) all S
    images share one NMS call and the fields are [S, num]."""
    logits, deltas, anchors = _flatten_levels(cls, reg, anchors)
    scores = torch.sigmoid(logits)
    boxes = box_ops.delta2bbox(anchors, deltas, max_shape=img_shape)
    res = nms_ops.nms_fixed(boxes, scores, iou_threshold, nms_post,
                            pre_top_k=nms_pre)
    return Proposals(res.boxes, res.scores, res.valid)
