"""FoveaBox, the counterpart of the JAX package's
``models/dense_heads/fovea_head.py`` (``FoveaHead``, ``_level_points``,
``fovea_targets_level``, ``fovea_loss``, ``fovea_decode``, ``FoveaBox``;
mmdet's ``fovea_head.py``): RetinaNet's trunk (FPN extras on C5), 4
stacked 3x3 convs a branch, C sigmoid logits (prior bias -4.595) and 4
log-space distances a cell.

A gt belongs to the levels whose scale range ((8, 32), (16, 64), (32,
128), (64, 256), (128, 512)) holds sqrt(its area); its positive cells on
such a level are its central fovea (sigma 0.4 of its half extent, in
cells); where two gts' foveas overlap the smaller area wins (``argmin``:
the lower index where two tie). Targets are log((px - x1) / base, ...)
clamped to [1/16, 16] before the log, base 16-256 a level. The loss is
the sigmoid focal loss over the positives plus one and SmoothL1 (beta
0.11) on the positives; the decode exponentiates, keeps each level's top
1000 (cell, class) pairs (``dense_decode``), then one class-aware NMS.
Points sit at ``(i + 0.5) * stride``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from ...core import losses, nms as nms_ops
from .fcos_head import (DenseDetector, DenseTowers, clip_to_image, conv3x3,
                        nhwc)
from .retina_head import PRIOR_BIAS, dense_decode

FOVEA_STRIDES = (8, 16, 32, 64, 128)
BASE_EDGES = (16, 32, 64, 128, 256)
SCALE_RANGES = ((8, 32), (16, 64), (32, 128), (64, 256), (128, 512))


class FoveaHead(DenseTowers):
    """flax names ``{cls,reg}_conv{i}``, ``conv_cls``, ``conv_reg``."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 dtype=torch.bfloat16):
        super().__init__(in_channels, feat_channels, stacked_convs, dtype)
        self.num_classes = num_classes
        self.conv_cls = conv3x3(feat_channels, num_classes, dtype)
        self.conv_reg = conv3x3(feat_channels, 4, dtype)

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        self.conv_cls.bias.fill_(PRIOR_BIAS)

    def forward(self, feats: Sequence[torch.Tensor],
                impl: Optional[str] = None):
        """NCHW maps -> per level (cls [N, h, w, C] in the compute dtype,
        reg [N, h, w, 4] float32); ``impl`` unused (no kernel)."""
        outs = []
        for x in feats:
            c, r = self.towers(x)
            outs.append((nhwc(self.conv_cls(c)),
                         nhwc(self.conv_reg(r)).float()))
        return outs


class FoveaBox(DenseDetector):
    def __init__(self, num_classes: int = 80, depth: int = 50,
                 dtype=torch.bfloat16):
        super().__init__(FoveaHead(num_classes, dtype=dtype), num_classes,
                         depth, dtype, add_extra_convs="on_input")


class FoveaLossOut(NamedTuple):
    loss_cls: torch.Tensor
    loss_bbox: torch.Tensor


def _level_points(h: int, w: int, stride: int, device=None):
    """Cell centres (x, y), each [h * w], at ``(i + 0.5) * stride``."""
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * stride
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * stride
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return gx.reshape(-1), gy.reshape(-1)


def fovea_targets_level(h: int, w: int, stride: int, base_len: float,
                        scale_range, gt_boxes: torch.Tensor,
                        gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                        num_classes: int, sigma: float = 0.4):
    """One level's (labels [P] with ``num_classes`` for the background,
    log-space ltrb targets [P, 4], pos [P])."""
    px, py = _level_points(h, w, stride, gt_boxes.device)
    areas = torch.sqrt((gt_boxes[:, 2] - gt_boxes[:, 0]).clamp_min(0)
                       * (gt_boxes[:, 3] - gt_boxes[:, 1]).clamp_min(0))
    in_scale = ((areas >= scale_range[0]) & (areas <= scale_range[1])
                & gt_valid)
    gx1, gy1, gx2, gy2 = (gt_boxes[:, i] / stride for i in range(4))
    half_w = 0.5 * (gx2 - gx1)
    half_h = 0.5 * (gy2 - gy1)
    left = torch.ceil(gx1 + (1 - sigma) * half_w - 0.5).clamp(0, w - 1)
    right = torch.floor(gx1 + (1 + sigma) * half_w - 0.5).clamp(0, w - 1)
    top = torch.ceil(gy1 + (1 - sigma) * half_h - 0.5).clamp(0, h - 1)
    down = torch.floor(gy1 + (1 + sigma) * half_h - 0.5).clamp(0, h - 1)
    cx = px / stride - 0.5  # the cell's integer index
    cy = py / stride - 0.5
    inside = ((cx[:, None] >= left[None]) & (cx[:, None] <= right[None])
              & (cy[:, None] >= top[None]) & (cy[:, None] <= down[None])
              & in_scale[None, :])  # [P, G]
    best = torch.where(inside, areas[None, :], 1e18).argmin(1)
    pos = inside.any(1)
    labels = torch.where(pos, gt_labels[best].long(), num_classes)
    gb = gt_boxes[best]
    t = torch.stack([(px - gb[:, 0]) / base_len, (py - gb[:, 1]) / base_len,
                     (gb[:, 2] - px) / base_len, (gb[:, 3] - py) / base_len],
                    dim=-1)
    return labels, torch.log(t.clamp(1.0 / 16, 16.0)), pos


def fovea_loss(level_outs, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
               gt_valid: torch.Tensor, num_classes: int,
               sigma: float = 0.4) -> FoveaLossOut:
    """level_outs: per level (cls [h, w, C], reg [h, w, 4]) of one
    image."""
    labels, tgts, pos, cls, reg = [], [], [], [], []
    for i, (c, r) in enumerate(level_outs):
        lab, tgt, p = fovea_targets_level(
            c.shape[-3], c.shape[-2], FOVEA_STRIDES[i], BASE_EDGES[i],
            SCALE_RANGES[i], gt_boxes, gt_labels, gt_valid, num_classes,
            sigma)
        labels.append(lab)
        tgts.append(tgt)
        pos.append(p)
        cls.append(c.reshape(-1, num_classes).float())
        reg.append(r.reshape(-1, 4))
    labels, tgts, pos = torch.cat(labels), torch.cat(tgts), torch.cat(pos)
    num_pos = pos.sum().float()
    onehot = F.one_hot(labels.clamp(0, num_classes - 1),
                       num_classes).float() * pos[:, None]
    loss_cls = losses.sigmoid_focal_loss(torch.cat(cls), onehot,
                                         avg_factor=num_pos + 1.0)
    loss_bbox = losses.smooth_l1_loss(
        torch.cat(reg), tgts, beta=0.11, weight=pos[:, None].float(),
        avg_factor=num_pos.clamp_min(1.0) * 4.0) * 4.0
    return FoveaLossOut(loss_cls, loss_bbox)


@torch.no_grad()
def fovea_decode(level_outs, img_shape, num_classes: int, nms_pre: int = 1000,
                 score_thr: float = 0.05, iou_threshold: float = 0.5,
                 max_per_img: int = 100, scale_factor=None
                 ) -> nms_ops.DetResult:
    levels = []
    for i, (cls, reg) in enumerate(level_outs):
        px, py = _level_points(cls.shape[-3], cls.shape[-2],
                               FOVEA_STRIDES[i], cls.device)
        t = torch.exp(reg.reshape(-1, 4))
        bl = BASE_EDGES[i]
        boxes = torch.stack([px - bl * t[:, 0], py - bl * t[:, 1],
                             px + bl * t[:, 2], py + bl * t[:, 3]], dim=-1)
        levels.append((clip_to_image(boxes, img_shape), torch.sigmoid(
            cls.reshape(-1, num_classes).float())))
    return dense_decode(levels, num_classes, nms_pre, score_thr,
                        iou_threshold, max_per_img, scale_factor)
