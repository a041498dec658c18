"""Cascade RPN on the DC5 trunk, the counterpart of the JAX package's
``models/dense_heads/cascade_rpn_head.py`` (``CascadeRPNHead``,
``CascadeRPNModel``, ``cascade_rpn_model_loss``, ``cascade_rpn_propose``;
mmdet's ``cascade_rpn_head.py``, the ``crpn_r50_caffe_fpn_1x_coco.py``
recipe on the one stride-16 map): one square anchor a cell (8 strides,
centred on ``x * stride``);

- stage 1: a 3x3 conv at dilation 3, ReLU, then a 1x1 regression (no
  classification); its targets come from ``region_assign``; the refined
  anchors are its deltas decoded with stds (0.1, 0.1, 0.5, 0.5);
- stage 2: a DCNv1 (``ops/deform_conv.py`` ``deform_conv``: kernel E, and F
  and G for its gradients) whose offsets put tap k of cell (y, x) at the
  refined anchor's point (cy + dy h / 3, cx + dx w / 3), stacked as the 9
  dy and then the 9 dx (tap k = 3 (dy + 1) + (dx + 1)), then a 1x1
  objectness and a 1x1 regression (stds (0.05, 0.05, 0.1, 0.1)).

As in JAX, the offsets are built from the refined anchors with their
gradient: the stage-2 losses reach stage 1 through kernel G (ROADMAP
F30); only stage 2's assignment reads them detached. Losses: linear IoU
(weight 10) on decoded boxes, stage 1 over every anchor, stage 2 over
256 anchors sampled at half positives (MaxIoU 0.7 / 0.7 / 0.3), and
stage 2's sigmoid cross entropy over the sample. The head computes in
float32 whatever the trunk's dtype, as the flax convs without a dtype do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import assigners, boxes as box_ops, nms as nms_ops
from ...ops.deform_conv import deform_conv
from ..backbones.resnet import Conv2d
from ..detectors.faster_rcnn import DetTrainBatch, FasterRCNN
from ..vid.selsa import SelsaConfig, _lecun_normal_

S1_STDS = (0.1, 0.1, 0.5, 0.5)
S2_STDS = (0.05, 0.05, 0.1, 0.1)


class CascadeRPNHead(nn.Module):
    def __init__(self, in_channels: int, feat_channels: int = 256,
                 anchor_scale: float = 8.0, stride: int = 16):
        super().__init__()
        self.anchor_scale, self.stride = anchor_scale, stride
        self.stage1_conv = Conv2d(in_channels, feat_channels, 3, padding=3,
                                  dilation=3)
        self.s1_reg = Conv2d(feat_channels, 4, 1)
        # the raw DCN weight (OIHW; the JAX HWIO ``s2_weight``) and bias
        self.s2_weight = nn.Parameter(
            torch.empty(feat_channels, feat_channels, 3, 3))
        self.s2_bias = nn.Parameter(torch.zeros(feat_channels))
        self.s2_cls = Conv2d(feat_channels, 1, 1)
        self.s2_reg = Conv2d(feat_channels, 4, 1)

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        _lecun_normal_(self.s2_weight, generator)
        self.s2_bias.zero_()

    def base_anchors(self, h: int, w: int, device) -> torch.Tensor:
        """[h * w, 4] squares of ``anchor_scale`` strides centred on
        (x * stride, y * stride), row-major."""
        ys = torch.arange(h, device=device) * self.stride
        xs = torch.arange(w, device=device) * self.stride
        cy, cx = torch.meshgrid(ys, xs, indexing="ij")
        half = self.anchor_scale * self.stride / 2.0
        return torch.stack([cx - half, cy - half, cx + half, cy + half],
                           dim=-1).reshape(-1, 4).float()

    def stage2_offsets(self, refined: torch.Tensor, h: int, w: int
                       ) -> torch.Tensor:
        """[1, 18, h, w]: the 9 dy then the 9 dx taking tap k of each cell
        to its point of the cell's refined anchor [h * w, 4]."""
        a = refined.reshape(h, w, 4)
        s = float(self.stride)
        cx = (a[..., 0] + a[..., 2]) * 0.5 / s
        cy = (a[..., 1] + a[..., 3]) * 0.5 / s
        aw = (a[..., 2] - a[..., 0]) / s
        ah = (a[..., 3] - a[..., 1]) / s
        yy = torch.arange(h, dtype=torch.float32, device=a.device)[:, None]
        xx = torch.arange(w, dtype=torch.float32, device=a.device)[None, :]
        dys, dxs = [], []
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                dys.append(cy + dy * ah / 3.0 - (yy + dy))
                dxs.append(cx + dx * aw / 3.0 - (xx + dx))
        return torch.stack(dys + dxs)[None].float()

    def forward(self, feat: torch.Tensor, impl: Optional[str] = None):
        """feat [1, C, h, w] -> ((stage-2 logits [h w], deltas [h w, 4]),
        stage-1 deltas [h w, 4], base anchors, refined anchors)."""
        _, _, h, w = feat.shape
        anchors = self.base_anchors(h, w, feat.device)
        x1 = F.relu(self.stage1_conv(feat.float()))
        r1 = self.s1_reg(x1).permute(0, 2, 3, 1).reshape(-1, 4)
        refined = box_ops.delta2bbox(anchors, r1, stds=S1_STDS)
        x2 = F.relu(deform_conv(x1, self.stage2_offsets(refined, h, w),
                                self.s2_weight, self.s2_bias, impl=impl))
        c2 = self.s2_cls(x2).reshape(-1)
        r2 = self.s2_reg(x2).permute(0, 2, 3, 1).reshape(-1, 4)
        return (c2, r2), r1, anchors, refined


class CascadeRPNModel(nn.Module):
    """The DC5 trunk of ``base`` (backbone and neck; its RPN and bbox head
    are never called and have no weights, as in flax) and ``crpn``."""

    def __init__(self, cfg: SelsaConfig = SelsaConfig()):
        super().__init__()
        self.cfg = cfg
        self.base = FasterRCNN(cfg)
        del self.base.rpn_head, self.base.bbox_head
        self.crpn = CascadeRPNHead(cfg.neck_channels)

    def forward(self, imgs: torch.Tensor, impl: Optional[str] = None):
        """imgs [1, H, W, 3] -> the head's outputs."""
        feat = self.base.extract_feat(imgs)
        return self.crpn(feat.permute(0, 3, 1, 2), impl=impl)


class CascadeRPNLoss(NamedTuple):
    loss_s1_reg: torch.Tensor
    loss_s2_cls: torch.Tensor
    loss_s2_reg: torch.Tensor


def _linear_iou(dec: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    ix1 = torch.maximum(dec[:, 0], gt[:, 0])
    iy1 = torch.maximum(dec[:, 1], gt[:, 1])
    ix2 = torch.minimum(dec[:, 2], gt[:, 2])
    iy2 = torch.minimum(dec[:, 3], gt[:, 3])
    inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    a1 = ((dec[:, 2] - dec[:, 0]).clamp_min(0)
          * (dec[:, 3] - dec[:, 1]).clamp_min(0))
    a2 = ((gt[:, 2] - gt[:, 0]).clamp_min(0)
          * (gt[:, 3] - gt[:, 1]).clamp_min(0))
    return 1.0 - inter / (a1 + a2 - inter).clamp_min(1e-6)


def cascade_rpn_losses(outs, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                       uniforms: torch.Tensor, featmap_hw, stride: int = 16,
                       anchor_scale: float = 8.0) -> CascadeRPNLoss:
    """The two stages' losses from the head's outputs; ``uniforms`` [2, A]
    for stage 2's RandomSampler."""
    (c2, r2), r1, anchors, refined = outs
    g = gt_boxes.shape[0]
    a1 = assigners.region_assign(gt_boxes, gt_valid, [featmap_hw], [stride],
                                 anchor_scale=anchor_scale)
    pos1 = (a1 > 0).float()
    tgt1 = gt_boxes[(a1 - 1).clamp(0, g - 1)]
    dec1 = box_ops.delta2bbox(anchors, r1, stds=S1_STDS)
    loss_s1 = 10.0 * (_linear_iou(dec1, tgt1) * pos1).sum() / anchors.shape[0]

    refined_sg = refined.detach()
    ar = assigners.max_iou_assign(
        refined_sg, gt_boxes, torch.zeros_like(gt_boxes[:, 0]).long(),
        gt_valid, 0.7, 0.7, 0.3)
    sm = assigners.random_sample_masks(ar, uniforms, 256, 0.5)
    pos2, neg2 = sm.pos_mask.float(), sm.neg_mask.float()
    n_samp = (pos2.sum() + neg2.sum()).clamp_min(1.0)
    tgt2 = gt_boxes[(ar.assigned_gt_inds - 1).clamp(0, g - 1)]
    dec2 = box_ops.delta2bbox(refined_sg, r2, stds=S2_STDS)
    loss_s2_reg = 10.0 * (_linear_iou(dec2, tgt2) * pos2).sum() / n_samp
    bce = c2.clamp_min(0) - c2 * pos2 + torch.log1p(torch.exp(-c2.abs()))
    loss_s2_cls = (bce * (pos2 + neg2)).sum() / n_samp
    return CascadeRPNLoss(loss_s1, loss_s2_cls, loss_s2_reg)


def cascade_rpn_model_loss(model: CascadeRPNModel, batch: DetTrainBatch,
                           uniforms: torch.Tensor,
                           impl: Optional[str] = None):
    """Returns (total, metrics) of one image (``uniforms`` [2, A])."""
    outs = model(batch.img[None], impl=impl)
    hw = (batch.img.shape[0] // 16, batch.img.shape[1] // 16)
    ls = cascade_rpn_losses(outs, batch.gt_boxes, batch.gt_valid, uniforms,
                            hw)
    total = ls.loss_s1_reg + ls.loss_s2_cls + ls.loss_s2_reg
    return total, {"loss": total, "loss_s1_reg": ls.loss_s1_reg,
                   "loss_s2_cls": ls.loss_s2_cls,
                   "loss_s2_reg": ls.loss_s2_reg}


@torch.no_grad()
def cascade_rpn_propose(model: CascadeRPNModel, img: torch.Tensor, img_shape,
                        nms_pre: int = 2000, max_per_img: int = 300,
                        iou_threshold: float = 0.8, scale_factor=None,
                        impl: Optional[str] = None) -> nms_ops.DetResult:
    """The stage-2 boxes clipped to ``img_shape``, the top ``nms_pre`` by
    sigmoid score (lower index first among equals), divided by
    ``scale_factor``, NMS at 0.8 to ``max_per_img`` class-0 detections."""
    (c2, r2), _, _, refined = model(img[None], impl=impl)
    boxes = box_ops.delta2bbox(refined, r2, stds=S2_STDS,
                               max_shape=(img_shape[0], img_shape[1]))
    scores = torch.sigmoid(c2)
    k = min(nms_pre, scores.shape[0])
    top_s, top_i = torch.sort(scores, descending=True, stable=True)
    top_s, top_i = top_s[:k], top_i[:k]
    boxes = boxes[top_i]
    if scale_factor is not None:
        boxes = boxes / torch.as_tensor(scale_factor, dtype=boxes.dtype,
                                        device=boxes.device)
    labels = torch.zeros(k, dtype=torch.int64, device=boxes.device)
    res = nms_ops.batched_nms(boxes, top_s, labels, iou_threshold,
                              max_per_img)
    return nms_ops.DetResult(res.boxes, res.scores,
                             torch.zeros_like(res.inds), res.valid)
