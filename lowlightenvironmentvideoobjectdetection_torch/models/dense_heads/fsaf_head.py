"""FSAF, the counterpart of the JAX package's
``models/dense_heads/fsaf_head.py`` (``FSAFHead``, ``_centers``,
``_tblr_decode``, ``fsaf_loss``, ``fsaf_decode``, ``FSAF``; mmdet's
``fsaf_head.py`` and the FSAF config): RetinaNet's trunk (FPN extras on
C5) and towers with one anchor a cell (a square of one stride, centred at
``x * stride``), C sigmoid logits (prior bias -4.595) and 4 ReLU'd TBLR
distances (the regressor's bias 0.25 at init).

The loss assigns with ``center_region_assign`` (0.2 / 0.2, IoF 0.01)
jointly over the levels; shadow pairs zero their gt's class channel in
the element-wise focal loss; the regression is -log(IoU) of the TBLR
decode (distances clamped at 1e-4, times 4 strides). Online level
selection: for each gt and level the mean of (the focal terms summed over
the classes + the IoU term) over that gt's positives (1e6 where it has
none); each gt keeps its argmin level (the lower level where two tie);
positives on its other levels lose the IoU term and their label's focal
term. Both sums are averaged over the kept positives (the negatives'
count where none is kept). The decode is ``dense_decode`` of the TBLR
boxes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from ...core import assigners, nms as nms_ops
from .fcos_head import (DenseDetector, DenseTowers, clip_to_image, conv3x3,
                        nhwc)
from .retina_head import PRIOR_BIAS, dense_decode

FSAF_STRIDES = (8, 16, 32, 64, 128)
REG_PRIOR_BIAS = 0.25  # no zero-area boxes at init (fsaf init_weights)


class FSAFHead(DenseTowers):
    """flax names ``{cls,reg}_conv{i}``, ``retina_cls``, ``retina_reg``."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 dtype=torch.bfloat16):
        super().__init__(in_channels, feat_channels, stacked_convs, dtype)
        self.num_classes = num_classes
        self.retina_cls = conv3x3(feat_channels, num_classes, dtype)
        self.retina_reg = conv3x3(feat_channels, 4, dtype)

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        self.retina_cls.bias.fill_(PRIOR_BIAS)
        self.retina_reg.bias.fill_(REG_PRIOR_BIAS)

    def forward(self, feats: Sequence[torch.Tensor],
                impl: Optional[str] = None):
        """NCHW maps -> per level (cls [N, h, w, C] in the compute dtype,
        TBLR [N, h, w, 4] float32, ReLU'd); ``impl`` unused."""
        outs = []
        for x in feats:
            c, r = self.towers(x)
            outs.append((nhwc(self.retina_cls(c)),
                         F.relu(nhwc(self.retina_reg(r)).float())))
        return outs


class FSAF(DenseDetector):
    def __init__(self, num_classes: int = 80, depth: int = 50,
                 dtype=torch.bfloat16):
        super().__init__(FSAFHead(num_classes, dtype=dtype), num_classes,
                         depth, dtype, add_extra_convs="on_input")


class FSAFLossOut(NamedTuple):
    loss_cls: torch.Tensor
    loss_bbox: torch.Tensor


def _centers(h: int, w: int, stride: float, device=None):
    """Anchor centres (x, y), each [h * w], at ``x * stride``."""
    ys = torch.arange(h, dtype=torch.float32, device=device) * stride
    xs = torch.arange(w, dtype=torch.float32, device=device) * stride
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return gx.reshape(-1), gy.reshape(-1)


def _tblr_decode(px, py, pred: torch.Tensor, stride: float,
                 normalizer: float = 4.0) -> torch.Tensor:
    """TBLRBBoxCoder's decode: distances (t, b, l, r) = pred * normalizer
    * stride -> boxes [P, 4]."""
    d = pred * (normalizer * stride)
    return torch.stack([px - d[:, 2], py - d[:, 0], px + d[:, 3],
                        py + d[:, 1]], dim=-1)


def fsaf_loss(level_outs, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
              gt_valid: torch.Tensor, num_classes: int,
              pos_scale: float = 0.2, neg_scale: float = 0.2,
              normalizer: float = 4.0) -> FSAFLossOut:
    """level_outs: per level (cls [h, w, C], TBLR [h, w, 4]) of one
    image."""
    g = gt_boxes.shape[0]
    dev = gt_boxes.device
    cls_l, dec_l, anc_l, lvl_l = [], [], [], []
    for li, (cls, reg) in enumerate(level_outs):
        stride = float(FSAF_STRIDES[li])
        px, py = _centers(cls.shape[-3], cls.shape[-2], stride, dev)
        cls_l.append(cls.reshape(-1, num_classes).float())
        dec_l.append(_tblr_decode(px, py, reg.reshape(-1, 4).clamp_min(1e-4),
                                  stride, normalizer))
        anc_l.append(torch.stack([px - stride / 2, py - stride / 2,
                                  px + stride / 2, py + stride / 2], dim=-1))
        lvl_l.append(torch.full((px.shape[0],), li, dtype=torch.long,
                                device=dev))
    clsf = torch.cat(cls_l)  # [A, C]
    dec = torch.cat(dec_l)
    lvl_of = torch.cat(lvl_l)

    ar, shadowed = assigners.center_region_assign(
        torch.cat(anc_l), gt_boxes, gt_labels, gt_valid, pos_scale,
        neg_scale)
    pos = ar.assigned_gt_inds > 0
    best = (ar.assigned_gt_inds - 1).clamp(0, g - 1)
    lab = torch.where(pos, ar.labels, num_classes)
    onehot = F.one_hot(lab.clamp(0, num_classes - 1),
                       num_classes).float() * pos[:, None]
    # element-wise focal loss (alpha 0.25, gamma 2), the stable BCE
    ce = (torch.maximum(clsf, torch.zeros_like(clsf)) - clsf * onehot
          + torch.log1p(torch.exp(-clsf.abs())))
    p = torch.sigmoid(clsf)
    pt = p * onehot + (1 - p) * (1 - onehot)
    alpha_t = 0.25 * onehot + 0.75 * (1 - onehot)
    cls_elem = alpha_t * (1 - pt) ** 2.0 * ce
    # a shadow pair zeroes its gt's class channel
    gt_onehot = F.one_hot(gt_labels.long().clamp(0, num_classes - 1),
                          num_classes).float()
    shadow_ch = (shadowed.float() @ gt_onehot) > 0  # [A, C]
    cls_elem = cls_elem * torch.where(shadow_ch, 0.0, 1.0)

    gb = gt_boxes[best]
    ix1 = torch.maximum(dec[:, 0], gb[:, 0])
    iy1 = torch.maximum(dec[:, 1], gb[:, 1])
    ix2 = torch.minimum(dec[:, 2], gb[:, 2])
    iy2 = torch.minimum(dec[:, 3], gb[:, 3])
    inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    a1 = ((dec[:, 2] - dec[:, 0]).clamp_min(0)
          * (dec[:, 3] - dec[:, 1]).clamp_min(0))
    a2 = ((gb[:, 2] - gb[:, 0]).clamp_min(0)
          * (gb[:, 3] - gb[:, 1]).clamp_min(0))
    iou = inter / (a1 + a2 - inter).clamp_min(1e-6)
    reg_elem = -torch.log(iou.clamp_min(1e-6)) * pos  # [A]

    # online level selection over (level, gt) means of the element losses
    elem = cls_elem.sum(-1) + reg_elem
    member = (pos[:, None] & (best[:, None] == torch.arange(
        g, device=dev)[None, :])).float()  # [A, G]
    lvl_onehot = F.one_hot(lvl_of, len(level_outs)).float()  # [A, L]
    cnt = lvl_onehot.T @ member
    tot = lvl_onehot.T @ (member * elem[:, None])
    level_loss = torch.where(cnt > 0, tot / cnt.clamp_min(1), 1e6)  # [L, G]
    min_level = level_loss.argmin(0)  # [G]
    keep = pos & (min_level[best] == lvl_of)
    demoted = (pos & ~keep).float()
    total_cls = (cls_elem * (1.0 - onehot * demoted[:, None])).sum()
    total_reg = (reg_elem * keep).sum()
    num_pos = keep.sum().float()
    denom = torch.where(num_pos > 0, num_pos,
                        num_pos + (ar.assigned_gt_inds == 0).sum())
    denom = denom.clamp_min(1.0)
    return FSAFLossOut(total_cls / denom, total_reg / denom)


@torch.no_grad()
def fsaf_decode(level_outs, img_shape, num_classes: int, nms_pre: int = 1000,
                score_thr: float = 0.05, iou_threshold: float = 0.5,
                max_per_img: int = 100, scale_factor=None,
                normalizer: float = 4.0) -> nms_ops.DetResult:
    levels = []
    for li, (cls, reg) in enumerate(level_outs):
        px, py = _centers(cls.shape[-3], cls.shape[-2], FSAF_STRIDES[li],
                          cls.device)
        boxes = _tblr_decode(px, py, reg.reshape(-1, 4), FSAF_STRIDES[li],
                             normalizer)
        levels.append((clip_to_image(boxes, img_shape), torch.sigmoid(
            cls.reshape(-1, num_classes).float())))
    return dense_decode(levels, num_classes, nms_pre, score_thr,
                        iou_threshold, max_per_img, scale_factor)
