"""ATSS, the counterpart of the JAX package's
``models/dense_heads/atss_head.py`` (``ATSSHead``, ``atss_anchors``,
``atss_assign``, ``atss_loss``, ``atss_decode``, ``ATSS``; mmdet's
``atss_head.py`` and ``atss_assigner.py``): FCOS's trunk and towers, one
square anchor a position (side 8 strides, centred at ``x * stride``: the
anchor generator's centre offset 0, not half a cell), C sigmoid logits, 4
deltas (stds 0.1 / 0.1 / 0.2 / 0.2) and a centerness logit on the
regression branch.

The assignment takes, for each gt and level, exactly ``min(9, n)`` anchors
closest to the gt's centre (a top-k of the negated distance: on a grid,
distances tie often, and the ties go to the lower index, as ``lax.top_k``);
the IoU threshold is the candidates' mean plus their unbiased std (over
``k_total - 1``); a positive also needs its centre inside the gt by more
than 0.01 px; an anchor positive for several gts takes the highest IoU.
The loss is the sigmoid focal loss, SmoothL1 on the deltas and the
centerness BCE, each averaged over the positives.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from ...core import boxes as box_ops, losses, nms as nms_ops
from .fcos_head import (DenseDetector, DenseTowers, conv3x3, level_sizes,
                        nhwc)
from .retina_head import PRIOR_BIAS, dense_decode, top_k_stable

ATSS_STRIDES = (8, 16, 32, 64, 128)
STDS = (0.1, 0.1, 0.2, 0.2)


class ATSSHead(DenseTowers):
    """flax names ``{cls,reg}_conv{i}``, ``atss_cls``, ``atss_reg``,
    ``atss_centerness``."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 dtype=torch.bfloat16):
        super().__init__(in_channels, feat_channels, stacked_convs, dtype)
        self.num_classes = num_classes
        self.atss_cls = conv3x3(feat_channels, num_classes, dtype)
        self.atss_reg = conv3x3(feat_channels, 4, dtype)
        self.atss_centerness = conv3x3(feat_channels, 1, dtype)

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        self.atss_cls.bias.fill_(PRIOR_BIAS)

    def forward(self, feats: Sequence[torch.Tensor],
                impl: Optional[str] = None):
        """NCHW maps -> per level (cls [N, h, w, C], deltas [N, h, w, 4],
        centerness [N, h, w, 1]) in the compute dtype; ``impl`` unused."""
        outs = []
        for x in feats:
            c, r = self.towers(x)
            outs.append((nhwc(self.atss_cls(c)), nhwc(self.atss_reg(r)),
                         nhwc(self.atss_centerness(r))))
        return outs


class ATSS(DenseDetector):
    def __init__(self, num_classes: int = 80, depth: int = 50,
                 dtype=torch.bfloat16):
        super().__init__(ATSSHead(num_classes, dtype=dtype), num_classes,
                         depth, dtype)


def atss_anchors(shapes, scale: float = 8.0, device=None
                 ) -> List[torch.Tensor]:
    """One square anchor a position a level [h * w, 4]: side ``scale *
    stride``, centred on ``(x, y) * stride``."""
    out = []
    for (h, w), s in zip(shapes, ATSS_STRIDES):
        cy = torch.arange(h, dtype=torch.float32, device=device)[:, None] * s
        cx = torch.arange(w, dtype=torch.float32, device=device)[None, :] * s
        half = scale * s / 2
        a = torch.stack([(cx - half).expand(h, w), (cy - half).expand(h, w),
                         (cx + half).expand(h, w), (cy + half).expand(h, w)],
                        dim=-1)
        out.append(a.reshape(-1, 4))
    return out


def atss_assign(level_anchors: Sequence[torch.Tensor],
                gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                topk: int = 9) -> torch.Tensor:
    """ATSS assignment -> the assigned gt of every anchor [A] (-1: none),
    the levels concatenated."""
    anchors = torch.cat(list(level_anchors))
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    gcx = (gt_boxes[:, 0] + gt_boxes[:, 2]) / 2
    gcy = (gt_boxes[:, 1] + gt_boxes[:, 3]) / 2
    dist = torch.sqrt((acx[:, None] - gcx[None, :]).square()
                      + (acy[:, None] - gcy[None, :]).square())  # [A, G]
    iou = box_ops.bbox_overlaps(anchors, gt_boxes)
    num_g = gt_boxes.shape[0]
    cand = torch.zeros(dist.shape, dtype=torch.bool, device=dist.device)
    cols = torch.arange(num_g, device=dist.device)[:, None]
    start = k_total = 0
    for la in level_anchors:
        n = la.shape[0]
        k = min(topk, n)
        k_total += k
        _, idx = top_k_stable(-dist[start:start + n].T, k)  # [G, k]
        cand[start + idx, cols] = True
        start += n
    cand_f = cand.float()
    mean = (iou * cand_f).sum(0) / k_total
    var = ((iou - mean[None, :]).square() * cand_f).sum(0) / max(
        k_total - 1, 1)
    thr = mean + torch.sqrt(var)
    inside = torch.minimum(
        torch.minimum(acx[:, None] - gt_boxes[None, :, 0],
                      gt_boxes[None, :, 2] - acx[:, None]),
        torch.minimum(acy[:, None] - gt_boxes[None, :, 1],
                      gt_boxes[None, :, 3] - acy[:, None])) > 0.01
    pos = cand & (iou >= thr[None, :]) & inside & gt_valid[None, :]
    best_gt = torch.where(pos, iou, -1.0).argmax(1)
    return torch.where(pos.any(1), best_gt, -1)


class ATSSLossOut(NamedTuple):
    loss_cls: torch.Tensor
    loss_bbox: torch.Tensor
    loss_centerness: torch.Tensor


def anchor_centres(anchors: torch.Tensor):
    return ((anchors[:, 0] + anchors[:, 2]) / 2,
            (anchors[:, 1] + anchors[:, 3]) / 2)


def atss_loss(level_outs, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
              gt_valid: torch.Tensor, num_classes: int, topk: int = 9
              ) -> ATSSLossOut:
    """level_outs: per level (cls [h, w, C], deltas [h, w, 4], ctr [h, w,
    1]) of one image."""
    level_anchors = atss_anchors(level_sizes(level_outs),
                                 device=gt_boxes.device)
    anchors = torch.cat(level_anchors)
    cls_all = torch.cat([c.reshape(-1, num_classes).float()
                         for c, _, _ in level_outs])
    reg_all = torch.cat([r.reshape(-1, 4).float() for _, r, _ in level_outs])
    ctr_all = torch.cat([t.reshape(-1).float() for _, _, t in level_outs])
    assigned = atss_assign(level_anchors, gt_boxes, gt_valid, topk=topk)
    pos = assigned >= 0
    num_pos = pos.sum().float().clamp_min(1.0)
    safe_gt = assigned.clamp(0, gt_boxes.shape[0] - 1)
    onehot = F.one_hot(gt_labels[safe_gt].long().clamp(0, num_classes - 1),
                       num_classes).float() * pos[:, None]
    loss_cls = losses.sigmoid_focal_loss(cls_all, onehot, avg_factor=num_pos)
    matched = gt_boxes[safe_gt]
    tgt = box_ops.bbox2delta(anchors, matched, stds=STDS)
    loss_bbox = losses.smooth_l1_loss(reg_all, tgt,
                                      weight=pos[:, None].float(),
                                      avg_factor=num_pos)
    acx, acy = anchor_centres(anchors)
    l = (acx - matched[:, 0]).clamp_min(1e-6)
    r = (matched[:, 2] - acx).clamp_min(1e-6)
    t = (acy - matched[:, 1]).clamp_min(1e-6)
    b = (matched[:, 3] - acy).clamp_min(1e-6)
    ctr_tgt = torch.sqrt((torch.minimum(l, r) / torch.maximum(l, r))
                         * (torch.minimum(t, b) / torch.maximum(t, b)))
    loss_ctr = losses.binary_cross_entropy(ctr_all, ctr_tgt,
                                           weight=pos.float(),
                                           avg_factor=num_pos)
    return ATSSLossOut(loss_cls, loss_bbox, loss_ctr)


@torch.no_grad()
def atss_decode(level_outs, img_shape, num_classes: int, nms_pre: int = 1000,
                score_thr: float = 0.05, iou_threshold: float = 0.6,
                max_per_img: int = 100, scale_factor=None
                ) -> nms_ops.DetResult:
    level_anchors = atss_anchors(level_sizes(level_outs),
                                 device=level_outs[0][0].device)
    levels = []
    for (cls, reg, ctr), anc in zip(level_outs, level_anchors):
        scores = (torch.sigmoid(cls.reshape(-1, num_classes).float())
                  * torch.sigmoid(ctr.reshape(-1, 1).float()))
        boxes = box_ops.delta2bbox(anc, reg.reshape(-1, 4).float(),
                                   stds=STDS, max_shape=img_shape)
        levels.append((boxes, scores))
    return dense_decode(levels, num_classes, nms_pre, score_thr,
                        iou_threshold, max_per_img, scale_factor)
