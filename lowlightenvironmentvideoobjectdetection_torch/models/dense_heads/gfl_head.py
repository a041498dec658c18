"""GFL (generalized focal loss, v1), the counterpart of the JAX package's
``models/dense_heads/gfl_head.py`` (``GFLHead``, ``_integral``,
``_dist_to_boxes``, ``gfl_loss``, ``gfl_decode``, ``GFL``; mmdet's
``gfl_head.py``): ATSS's trunk, towers, anchors and assignment; the
regression branch predicts, for each side, a distribution over ``reg_max +
1`` bins (in strides) whose expectation is the distance.

The loss is the quality focal loss (the BCE to the predicted box's IoU with
its gt on the gt's class, modulated by |y - sigmoid|^2), the distribution
focal loss (the CE onto the two bins about the target distance; weight
0.25) and the GIoU loss weighted by that IoU (weight 2.0). The GIoU is this
module's copy of the JAX DETR's pairwise ``_giou`` (DETR is not ported).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from ...core import boxes as box_ops, nms as nms_ops
from .atss_head import ATSS_STRIDES, anchor_centres, atss_anchors, atss_assign
from .fcos_head import (DenseDetector, DenseTowers, clip_to_image, conv3x3,
                        level_sizes, nhwc)
from .retina_head import PRIOR_BIAS, dense_decode


class GFLHead(DenseTowers):
    """flax names ``{cls,reg}_conv{i}``, ``gfl_cls``, ``gfl_reg`` (4 x
    (reg_max + 1) outputs)."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 reg_max: int = 16, dtype=torch.bfloat16):
        super().__init__(in_channels, feat_channels, stacked_convs, dtype)
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.gfl_cls = conv3x3(feat_channels, num_classes, dtype)
        self.gfl_reg = conv3x3(feat_channels, 4 * (reg_max + 1), dtype)

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        self.gfl_cls.bias.fill_(PRIOR_BIAS)

    def forward(self, feats: Sequence[torch.Tensor],
                impl: Optional[str] = None):
        """NCHW maps -> per level (cls [N, h, w, C], distribution logits
        [N, h, w, 4 (reg_max + 1)]) in the compute dtype; ``impl``
        unused."""
        outs = []
        for x in feats:
            c, r = self.towers(x)
            outs.append((nhwc(self.gfl_cls(c)), nhwc(self.gfl_reg(r))))
        return outs


class GFL(DenseDetector):
    def __init__(self, num_classes: int = 80, depth: int = 50,
                 reg_max: int = 16, dtype=torch.bfloat16):
        super().__init__(GFLHead(num_classes, reg_max=reg_max, dtype=dtype),
                         num_classes, depth, dtype)
        self.reg_max = reg_max


def _integral(reg_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """[..., 4 (reg_max + 1)] distribution logits -> [..., 4] expected
    distances in strides."""
    p = torch.softmax(reg_logits.reshape(*reg_logits.shape[:-1], 4,
                                         reg_max + 1), dim=-1)
    bins = torch.arange(reg_max + 1, dtype=torch.float32,
                        device=reg_logits.device)
    return (p * bins).sum(-1)


def _dist_to_boxes(centers: torch.Tensor, dists: torch.Tensor,
                   strides: torch.Tensor) -> torch.Tensor:
    """centres [N, 2] + (l, t, r, b) in strides [N, 4] -> xyxy [N, 4]."""
    d = dists * strides[:, None]
    return torch.stack([centers[:, 0] - d[:, 0], centers[:, 1] - d[:, 1],
                        centers[:, 0] + d[:, 2], centers[:, 1] + d[:, 3]],
                       dim=-1)


def _giou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] x [..., M, 4] -> GIoU [..., N, M] (the JAX DETR's
    formula: the union recovered from the IoU)."""
    iou = box_ops.bbox_overlaps(boxes1, boxes2)
    x1 = torch.minimum(boxes1[..., :, None, 0], boxes2[..., None, :, 0])
    y1 = torch.minimum(boxes1[..., :, None, 1], boxes2[..., None, :, 1])
    x2 = torch.maximum(boxes1[..., :, None, 2], boxes2[..., None, :, 2])
    y2 = torch.maximum(boxes1[..., :, None, 3], boxes2[..., None, :, 3])
    hull = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    a1 = box_ops.bbox_area(boxes1)[..., :, None]
    a2 = box_ops.bbox_area(boxes2)[..., None, :]
    inter = iou * (a1 + a2).clamp_min(1e-6) / (1 + iou)
    union = a1 + a2 - inter
    return iou - (hull - union) / hull.clamp_min(1e-6)


class GFLLossOut(NamedTuple):
    loss_qfl: torch.Tensor
    loss_dfl: torch.Tensor
    loss_giou: torch.Tensor


def gfl_loss(level_outs, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
             gt_valid: torch.Tensor, num_classes: int, reg_max: int = 16,
             beta: float = 2.0) -> GFLLossOut:
    """level_outs: per level (cls [h, w, C], logits [h, w, 4 (reg_max +
    1)]) of one image."""
    shapes = level_sizes(level_outs)
    dev = gt_boxes.device
    level_anchors = atss_anchors(shapes, device=dev)
    anchors = torch.cat(level_anchors)
    strides = torch.cat([torch.full((h * w,), float(s), device=dev)
                         for (h, w), s in zip(shapes, ATSS_STRIDES)])
    centers = torch.stack(anchor_centres(anchors), dim=-1)
    cls_all = torch.cat([c.reshape(-1, num_classes).float()
                         for c, _ in level_outs])
    reg_all = torch.cat([r.reshape(-1, 4 * (reg_max + 1)).float()
                         for _, r in level_outs])
    assigned = atss_assign(level_anchors, gt_boxes, gt_valid)
    pos = assigned >= 0
    num_pos = pos.sum().float().clamp_min(1.0)
    safe_gt = assigned.clamp(0, gt_boxes.shape[0] - 1)
    matched = gt_boxes[safe_gt]
    pred_boxes = _dist_to_boxes(centers, _integral(reg_all, reg_max),
                                strides)
    iou_q = box_ops.bbox_overlaps(pred_boxes[:, None],
                                  matched[:, None])[:, 0, 0]
    iou_q = iou_q.clamp(0.0, 1.0).detach()
    # quality focal loss
    sig = torch.sigmoid(cls_all)
    y = F.one_hot(gt_labels[safe_gt].long().clamp(0, num_classes - 1),
                  num_classes).float() * (iou_q * pos)[:, None]
    bce = (torch.maximum(cls_all, torch.zeros_like(cls_all)) - cls_all * y
           + torch.log1p(torch.exp(-cls_all.abs())))
    loss_qfl = ((y - sig).abs() ** beta * bce).sum() / num_pos
    # distribution focal loss on the positives' distances (strides)
    tgt = torch.stack([(centers[:, 0] - matched[:, 0]) / strides,
                       (centers[:, 1] - matched[:, 1]) / strides,
                       (matched[:, 2] - centers[:, 0]) / strides,
                       (matched[:, 3] - centers[:, 1]) / strides], -1)
    tgt = tgt.clamp(0.0, reg_max - 1e-4)
    tl = torch.floor(tgt)
    wr = tgt - tl
    logp = F.log_softmax(reg_all.reshape(-1, 4, reg_max + 1), dim=-1)
    tli = tl.long()
    lp_l = torch.gather(logp, -1, tli[..., None])[..., 0]
    lp_r = torch.gather(logp, -1, (tli + 1)[..., None])[..., 0]
    dfl = -(lp_l * (1 - wr) + lp_r * wr)
    loss_dfl = (dfl.mean(-1) * pos).sum() / num_pos
    # GIoU on the positives, weighted by the quality target
    giou_d = _giou(pred_boxes[:, None], matched[:, None])[:, 0, 0]
    loss_giou = (((1.0 - giou_d) * pos * iou_q).sum()
                 / (iou_q * pos).sum().clamp_min(1e-6))
    return GFLLossOut(loss_qfl, 0.25 * loss_dfl, 2.0 * loss_giou)


@torch.no_grad()
def gfl_decode(level_outs, img_shape, num_classes: int, reg_max: int = 16,
               nms_pre: int = 1000, score_thr: float = 0.05,
               iou_threshold: float = 0.6, max_per_img: int = 100,
               scale_factor=None) -> nms_ops.DetResult:
    shapes = level_sizes(level_outs)
    dev = level_outs[0][0].device
    levels = []
    for (cls, reg), anc, s in zip(level_outs, atss_anchors(shapes, device=dev),
                                  ATSS_STRIDES):
        scores = torch.sigmoid(cls.reshape(-1, num_classes).float())
        dists = _integral(reg.reshape(-1, 4 * (reg_max + 1)).float(), reg_max)
        boxes = _dist_to_boxes(torch.stack(anchor_centres(anc), dim=-1), dists,
                               torch.full((anc.shape[0],), float(s),
                                          device=dev))
        levels.append((clip_to_image(boxes, img_shape), scores))
    return dense_decode(levels, num_classes, nms_pre, score_thr,
                        iou_threshold, max_per_img, scale_factor)
