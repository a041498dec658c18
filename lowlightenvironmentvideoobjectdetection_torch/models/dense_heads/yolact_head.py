"""YOLACT, the counterpart of the JAX package's
``models/dense_heads/yolact_head.py`` (``YOLACTHead``, ``Protonet``,
``SegmHead``, ``YOLACT``, ``yolact_anchors``, ``_crop_mask``,
``yolact_loss``, ``yolact_detect``; mmdet's ``yolact_head.py``): ResNet
C3-C5 -> FPN (256, 5 levels, extra convs from C5) -> on every level one
shared 3x3 conv, then 3 anchors' C + 1 class logits, deltas and 32 mask
coefficients (tanh, f32); the protonet (3 convs, a 2x bilinear upsample,
a conv, a 1x1 conv to 32 prototypes, ReLU) and a 1x1 semantic head on P3.

Anchors: 3 a cell in the order of ratios (0.5, 1, 2), sides 3 x the base
size (8-128), centred at (x + 0.5) x the grid stride 550 / (69, 35, 18, 9,
5): JAX's strides, whatever the padded size (768 x 1280 on the image
route, where mmdet runs 550 x 550: ROADMAP F36).

The loss: IoU assignment (0.5 / 0.4), cross entropy with 3:1 hard
negatives (the rank of each negative's CE by a double stable argsort, as
``jnp.argsort``: equal values keep their index order), smooth L1 on the
positives' deltas (stds 0.1, 0.1, 0.2, 0.2), for each gt the prototype
mask of its best positive anchor against its mask resized to the
prototypes by JAX's nearest rule (ROADMAP F20), cropped to its box and
normalised by its area, and the semantic head's BCE against the class
maxima of the resized masks. The decode: one stable top 1000 (anchor,
class) softmax scores a level, class-aware NMS (0.5; above 0.05; 100),
the kept detections' masks assembled from the prototypes and cropped to
their boxes: (detections, masks [100, ph, pw]).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import boxes as box_ops, losses
from ...core import nms as nms_ops
from ...ops.scale_translate import resize_nearest
from ..backbones.resnet import Conv2d, ResNet
from ..necks.fpn import FPN
from .retina_head import top_k_stable

YOLACT_STRIDES = tuple(550.0 / x for x in (69, 35, 18, 9, 5))
YOLACT_BASE_SIZES = (8, 16, 32, 64, 128)
YOLACT_STDS = (0.1, 0.1, 0.2, 0.2)
NUM_PROTOS = 32
NUM_BASE_ANCHORS = 3


class YOLACTHead(nn.Module):
    """flax ``head_conv``, ``conv_cls``, ``conv_reg``, ``conv_coeff``."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, dtype=torch.bfloat16):
        super().__init__()
        a = NUM_BASE_ANCHORS
        self.head_conv = Conv2d(in_channels, feat_channels, 3, padding=1,
                                dtype=dtype)
        self.conv_cls = Conv2d(feat_channels, a * (num_classes + 1), 3,
                               padding=1, dtype=dtype)
        self.conv_reg = Conv2d(feat_channels, a * 4, 3, padding=1,
                               dtype=dtype)
        self.conv_coeff = Conv2d(feat_channels, a * NUM_PROTOS, 3, padding=1,
                                 dtype=dtype)

    def forward(self, feats: Sequence[torch.Tensor]):
        """NCHW maps -> per level (cls [T, h, w, A*(C+1)], reg [T, h, w,
        A*4], coefficients [T, h, w, A*32] f32), NHWC."""
        outs = []
        for x in feats:
            h = F.relu(self.head_conv(x))
            outs.append(tuple(t.permute(0, 2, 3, 1) for t in (
                self.conv_cls(h), self.conv_reg(h),
                torch.tanh(self.conv_coeff(h).float()))))
        return outs


class Protonet(nn.Module):
    """flax ``conv{0,1,2}``, ``conv3``, ``conv_proto``."""

    def __init__(self, in_channels: int = 256, dtype=torch.bfloat16):
        super().__init__()
        self.compute_dtype = dtype
        for i in range(3):
            self.add_module(f"conv{i}", Conv2d(
                in_channels if i == 0 else 256, 256, 3, padding=1,
                dtype=dtype))
        self.conv3 = Conv2d(256, 256, 3, padding=1, dtype=dtype)
        self.conv_proto = Conv2d(256, NUM_PROTOS, 1, dtype=dtype)

    def forward(self, p3: torch.Tensor) -> torch.Tensor:
        """P3 [T, C, h, w] -> prototypes [T, 2h, 2w, 32] f32, NHWC."""
        x = p3
        for i in range(3):
            x = F.relu(getattr(self, f"conv{i}")(x))
        # half-pixel bilinear, edges clamped: JAX's renormalised upsample
        x = F.interpolate(x.float(), scale_factor=2, mode="bilinear",
                          align_corners=False).to(self.compute_dtype)
        x = F.relu(self.conv3(x))
        return F.relu(self.conv_proto(x)).float().permute(0, 2, 3, 1)


class SegmHead(nn.Module):
    """flax ``segm_conv``."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 dtype=torch.bfloat16):
        super().__init__()
        self.segm_conv = Conv2d(in_channels, num_classes, 1, dtype=dtype)

    def forward(self, p3: torch.Tensor) -> torch.Tensor:
        return self.segm_conv(p3).float().permute(0, 2, 3, 1)


class YOLACT(nn.Module):
    """ResNet + FPN + ``bbox_head``, ``protonet``, ``segm_head``."""

    def __init__(self, num_classes: int = 80, depth: int = 50,
                 dtype=torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.compute_dtype = dtype
        self.backbone = ResNet(depth=depth, out_indices=(1, 2, 3),
                               frozen_stages=1, dtype=dtype)
        self.neck = FPN((512, 1024, 2048), 256, 5, "on_input", dtype=dtype)
        self.bbox_head = YOLACTHead(num_classes, dtype=dtype)
        self.protonet = Protonet(dtype=dtype)
        self.segm_head = SegmHead(num_classes, dtype=dtype)

    def forward(self, imgs: torch.Tensor, impl=None):
        """imgs [T, H, W, 3] -> (per level (cls, reg, coefficients),
        prototypes, semantic logits), NHWC."""
        fpn = self.neck(self.backbone(imgs.permute(0, 3, 1, 2)))
        return (self.bbox_head(fpn), self.protonet(fpn[0]),
                self.segm_head(fpn[0]))


def yolact_anchors(shapes, strides=YOLACT_STRIDES,
                   base_sizes=YOLACT_BASE_SIZES, device=None):
    """Per level [h * w * 3, 4] anchors in (y, x, anchor) order."""
    out = []
    f32 = torch.float32
    for (h, w), s, bs in zip(shapes, strides, base_sizes):
        cy = (torch.arange(h, dtype=f32, device=device) + 0.5) * s
        cx = (torch.arange(w, dtype=f32, device=device) + 0.5) * s
        ratios = torch.tensor([0.5, 1.0, 2.0], dtype=f32, device=device)
        aw = 3.0 * bs * torch.sqrt(1.0 / ratios)
        ah = 3.0 * bs * torch.sqrt(ratios)
        cx, cy = cx[None, :, None], cy[:, None, None]
        a = torch.stack([(cx - aw / 2).expand(h, w, 3),
                         (cy - ah / 2).expand(h, w, 3),
                         (cx + aw / 2).expand(h, w, 3),
                         (cy + ah / 2).expand(h, w, 3)], -1)
        out.append(a.reshape(-1, 4))
    return out


def _crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """masks [N, h, w] zeroed outside their boxes [N, 4] (mask
    coordinates, borders included)."""
    _, h, w = masks.shape
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)
    b = boxes[:, :, None, None]
    inside = ((xs >= b[:, 0]) & (xs <= b[:, 2]) & (ys[:, None] >= b[:, 1])
              & (ys[:, None] <= b[:, 3]))
    return masks * inside


class YOLACTLossOut(NamedTuple):
    loss_cls: torch.Tensor
    loss_bbox: torch.Tensor
    loss_mask: torch.Tensor
    loss_segm: torch.Tensor


def _levels(level_outs, num_classes):
    c1 = num_classes + 1
    return (torch.cat([c.reshape(-1, c1).float() for c, _, _ in level_outs]),
            torch.cat([r.reshape(-1, 4).float() for _, r, _ in level_outs]),
            torch.cat([k.reshape(-1, NUM_PROTOS) for _, _, k in level_outs]))


def _bce(x, t):
    return x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))


def yolact_loss(level_outs, protos, segm, gt_boxes, gt_labels, gt_valid,
                gt_masks, img_shape, num_classes: int,
                neg_pos_ratio: int = 3) -> YOLACTLossOut:
    """One image: ``level_outs`` per level (cls [h, w, A*(C+1)], reg,
    coefficients), ``protos`` [ph, pw, 32], ``segm`` [sh, sw, C],
    ``gt_masks`` [G, H, W]."""
    dev = gt_boxes.device
    shapes = [(c.shape[-3], c.shape[-2]) for c, _, _ in level_outs]
    anchors = torch.cat(yolact_anchors(shapes, device=dev))
    cls_all, reg_all, coef_all = _levels(level_outs, num_classes)

    iou = box_ops.bbox_overlaps(anchors, gt_boxes)
    iou = torch.where(gt_valid[None, :], iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(1)
    best_gt = iou.argmax(1)  # the first of equal maxima, as jnp.argmax
    pos = best_iou >= 0.5
    neg = best_iou < 0.4
    num_pos = pos.sum().float().clamp_min(1.0)

    tgt = torch.where(pos, gt_labels[best_gt] + 1, torch.zeros_like(best_gt))
    logp = torch.log_softmax(cls_all, -1)
    ce = -torch.gather(logp, 1, tgt[:, None])[:, 0]
    with torch.no_grad():
        neg_ce = torch.where(neg & ~pos, ce, torch.full_like(ce, -1.0))
        order = torch.argsort(-neg_ce, stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.shape[0], device=dev)
        hard_neg = (rank < neg_pos_ratio * num_pos) & neg & ~pos
    loss_cls = (ce * (pos | hard_neg)).sum() / num_pos

    tdelta = box_ops.bbox2delta(anchors, gt_boxes[best_gt], stds=YOLACT_STDS)
    loss_bbox = losses.smooth_l1_loss(reg_all, tdelta,
                                      weight=pos[:, None].float(),
                                      avg_factor=num_pos)

    ph, pw = protos.shape[-3], protos.shape[-2]
    proto_flat = protos.reshape(ph * pw, NUM_PROTOS)
    h, w = img_shape[0], img_shape[1]
    sx, sy = pw / w, ph / h
    iou_pos = torch.where(pos[:, None], iou, torch.full_like(iou, -1.0))
    best_anchor = iou_pos.argmax(0)
    has_pos = iou_pos.amax(0) > 0
    mlogits = (proto_flat @ coef_all[best_anchor].T).T.reshape(-1, ph, pw)
    gt_small = resize_nearest(gt_masks.float(), (1, 2), (ph, pw))
    box_small = gt_boxes * torch.stack([sx, sy, sx, sy]).float()
    cropped = _crop_mask(_bce(mlogits, gt_small), box_small)
    areas = ((box_small[:, 2] - box_small[:, 0])
             * (box_small[:, 3] - box_small[:, 1])).clamp_min(1.0)
    wgt = (gt_valid & has_pos).float()
    loss_mask = (cropped.sum((1, 2)) / areas * wgt).sum() / \
        wgt.sum().clamp_min(1.0)

    sh, sw = segm.shape[-3], segm.shape[-2]
    seg_small = resize_nearest(gt_masks.float(), (1, 2), (sh, sw))
    onehot = F.one_hot(gt_labels.clamp(0, num_classes - 1),
                       num_classes).float() * gt_valid[:, None]
    seg_tgt = (seg_small[..., None] * onehot[:, None, None, :]).amax(0)
    slog = segm.reshape(sh, sw, num_classes)
    loss_segm = _bce(slog, seg_tgt).mean()
    return YOLACTLossOut(loss_cls, loss_bbox, loss_mask, loss_segm)


@torch.no_grad()
def yolact_detect(level_outs, protos, img_shape, num_classes: int,
                  nms_pre: int = 1000, score_thr: float = 0.05,
                  iou_threshold: float = 0.5, max_per_img: int = 100,
                  scale_factor=None):
    """One image's (detections [max_per_img], masks [max_per_img, ph,
    pw]) from its level outputs and prototypes [ph, pw, 32]."""
    dev = protos.device
    shapes = [(c.shape[-3], c.shape[-2]) for c, _, _ in level_outs]
    level_anchors = yolact_anchors(shapes, device=dev)
    c1 = num_classes + 1
    all_b, all_s, all_l, all_k = [], [], [], []
    for (cls, reg, coef), anc in zip(level_outs, level_anchors):
        probs = torch.softmax(cls.reshape(-1, c1).float(), -1)[:, 1:]
        flat = probs.reshape(-1)
        top_s, top_i = top_k_stable(flat, min(nms_pre, flat.shape[0]))
        bi = torch.div(top_i, num_classes, rounding_mode="floor")
        all_b.append(box_ops.delta2bbox(
            anc[bi], reg.reshape(-1, 4).float()[bi], stds=YOLACT_STDS,
            max_shape=img_shape))
        all_s.append(top_s)
        all_l.append(top_i % num_classes)
        all_k.append(coef.reshape(-1, NUM_PROTOS)[bi])
    boxes, scores = torch.cat(all_b), torch.cat(all_s)
    labels, coeffs = torch.cat(all_l), torch.cat(all_k)
    res = nms_ops.batched_nms(boxes, scores, labels, iou_threshold,
                              max_per_img, valid=scores > score_thr)
    ph, pw = protos.shape[-3], protos.shape[-2]
    proto_flat = protos.reshape(ph * pw, NUM_PROTOS)
    masks = torch.sigmoid((proto_flat @ coeffs[res.inds].T).T.reshape(
        -1, ph, pw))
    h, w = img_shape[0], img_shape[1]
    scale = torch.stack([pw / w, ph / h, pw / w, ph / h]).float()
    masks = _crop_mask(masks, res.boxes * scale)
    out_boxes = res.boxes
    if scale_factor is not None:
        out_boxes = out_boxes / torch.as_tensor(
            scale_factor, dtype=out_boxes.dtype, device=dev)
    return nms_ops.DetResult(out_boxes, res.scores, labels[res.inds],
                             res.valid), masks


def _one_image(outs):
    level_outs, protos, segm = outs
    return [tuple(t[0] for t in o) for o in level_outs], protos[0], segm[0]


def yolact_model_loss(model: YOLACT, batch, gt_masks):
    """The family's loss of one ``DetTrainBatch`` and its masks [G, H, W]:
    (total, metrics)."""
    levels, protos, segm = _one_image(model(batch.img[None]))
    ls = yolact_loss(levels, protos, segm, batch.gt_boxes, batch.gt_labels,
                     batch.gt_valid, gt_masks, batch.img_shape,
                     model.num_classes)
    total = sum(ls)
    return total, dict(ls._asdict(), loss=total)


@torch.no_grad()
def yolact_model_detect(model: YOLACT, img, img_shape, scale_factor=None,
                        impl=None):
    """(detections, masks) of one image [H, W, 3]."""
    levels, protos, _ = _one_image(model(img[None], impl=impl))
    return yolact_detect(levels, protos, img_shape, model.num_classes,
                         scale_factor=scale_factor)

