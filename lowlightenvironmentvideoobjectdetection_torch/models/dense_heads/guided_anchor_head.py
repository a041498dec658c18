"""Guided anchoring (GA-RetinaNet, and the pieces GA-RPN shares), the
counterpart of the JAX package's ``models/dense_heads/guided_anchor_head.py``
(mmdet's ``guided_anchor_head.py`` and ``ga_retina_head.py``): a location
branch (anchor presence; focal loss on centre-region targets), a shape
branch (a (dw, dh) a position in log space; bounded-IoU loss against the
best-overlapping gt), a deformable 3x3 conv that adapts the features to
the predicted shapes, then the classifier and the regressor on the adapted
features, with the predicted ("guided") square-based anchors.

``AdaptiveDCN`` is a DCNv1 (one deform group, given offsets) through
``ops/deform_conv.deform_conv``: kernel E forward on CUDA tensors, kernels
F and G backward; the plain version on the CPU. Its input and offsets are
float32, as in JAX. GA-RetinaNet's offsets are analytic
(``shape_to_offsets``): for tap (dy, dx) of the 3x3 grid the channel pair
(dy (h / 3 - 1), dx (w / 3 - 1)), stacked as interleaved pairs, which the
DCN reads as 9 dy and then 9 dx (its channel layout) -- the JAX package's
order, kept here; mmdet's ``FeatureAdaption`` learns its offsets with a
1x1 conv and 4 deform groups (ROADMAP fault F22).

The JAX ``fori_loop`` over the gts of ``ga_loc_targets`` (a later gt's
ignore ring zeroes an earlier gt's centre; a later centre sets 1) is one
vectorised step here: at each cell the last gt whose ring or centre covers
it decides. Top-k over the loc-masked scores (many exact zeros) is a
stable sort, the lower index first, as ``lax.top_k``. Maps are NCHW in the
modules and NHWC in their outputs, so flattens give the JAX order.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import assigners, boxes as box_ops, losses, nms as nms_ops
from ...core.anchors import AnchorGenerator
from ...ops.deform_conv import deform_conv
from ..backbones.resnet import Conv2d, ResNet
from ..necks.fpn import FPN
from .retina_head import PRIOR_BIAS, dense_decode

GA_STRIDES = (8, 16, 32, 64, 128)
# ga_retinanet config: approximate anchors at octave base scale 4, 3 scales
# an octave, ratios 0.5 / 1 / 2; squares at scale 4
GA_OCTAVE_BASE_SCALE = 4
GA_SCALES_PER_OCTAVE = 3
GA_RATIOS = (0.5, 1.0, 2.0)
GA_SQUARE_SCALE = 4.0
# train_cfg center_ratio / ignore_ratio; the anchor-presence filter; the
# decode's top-k a level, score floor, NMS IoU and detections an image
GA_CENTER_RATIO, GA_IGNORE_RATIO = 0.2, 0.5
GA_LOC_THR = 0.01
GA_NMS_PRE, GA_SCORE_THR, GA_NMS_IOU, GA_MAX_PER_IMG = 1000, 0.05, 0.5, 100

# host-made anchor sets, by generator, sizes, strides and device
_ANCHOR_CACHE: Dict[tuple, torch.Tensor] = {}


class AdaptiveDCN(nn.Module):
    """3x3 DCNv1 with supplied offsets: flax's ``kernel`` (he-normal) as
    ``weight`` [out, in, 3, 3], and ``bias``; float32."""

    def __init__(self, in_channels: int, out_channels: int = 256):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.init_flax(None)

    @torch.no_grad()
    def init_flax(self, generator: Optional[torch.Generator]) -> None:
        """flax's ``he_normal``: truncated normal at +-2 sigma, variance
        2 / fan_in after truncation; zero bias."""
        std = math.sqrt(2.0 / self.weight[0].numel()) / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor, offset: torch.Tensor,
                impl: Optional[str] = None) -> torch.Tensor:
        """x [N, C, H, W], offset [N, 18, H, W] (the DCN's channel layout)
        -> f32 [N, out, H, W]."""
        return deform_conv(x.float(), offset.float(), self.weight, self.bias,
                           impl=impl)


def shape_to_offsets(dwdh: torch.Tensor) -> torch.Tensor:
    """[..., 2] predicted (dw, dh) -> [..., 18] DCN offsets covering the
    anchor's extent, in the JAX package's channel order (F22)."""
    w = torch.exp(dwdh[..., 0]) * GA_SQUARE_SCALE
    h = torch.exp(dwdh[..., 1]) * GA_SQUARE_SCALE
    chans = []
    for dy in (-1.0, 0.0, 1.0):
        for dx in (-1.0, 0.0, 1.0):
            chans.append(dy * (h / 3.0 - 1.0))
            chans.append(dx * (w / 3.0 - 1.0))
    return torch.stack(chans, dim=-1)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class GARetinaHead(nn.Module):
    """flax names ``{cls,reg}_conv{i}``, ``conv_loc``, ``conv_shape``,
    ``feature_adaption_{cls,reg}``, ``retina_cls``, ``retina_reg``."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 dtype=torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.stacked_convs = stacked_convs
        for branch in ("cls", "reg"):
            for i in range(stacked_convs):
                self.add_module(f"{branch}_conv{i}", Conv2d(
                    in_channels if i == 0 else feat_channels, feat_channels,
                    3, padding=1, dtype=dtype))
        self.conv_loc = Conv2d(feat_channels, 1, 1, dtype=dtype)
        self.conv_shape = Conv2d(feat_channels, 2, 1, dtype=dtype)
        self.feature_adaption_cls = AdaptiveDCN(feat_channels, feat_channels)
        self.feature_adaption_reg = AdaptiveDCN(feat_channels, feat_channels)
        self.retina_cls = Conv2d(feat_channels, num_classes, 3, padding=1,
                                 dtype=dtype)
        self.retina_reg = Conv2d(feat_channels, 4, 3, padding=1, dtype=dtype)

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        """The prior biases of ``conv_loc`` and ``retina_cls``."""
        self.conv_loc.bias.fill_(PRIOR_BIAS)
        self.retina_cls.bias.fill_(PRIOR_BIAS)

    def forward(self, feats: Sequence[torch.Tensor],
                impl: Optional[str] = None):
        """NCHW maps -> per level (cls [N, h, w, C], reg [N, h, w, 4] in
        the compute dtype, shape [N, h, w, 2], loc [N, h, w, 1] float32)."""
        outs = []
        for x in feats:
            c = r = x
            for i in range(self.stacked_convs):
                c = F.relu(getattr(self, f"cls_conv{i}")(c))
                r = F.relu(getattr(self, f"reg_conv{i}")(r))
            loc = self.conv_loc(c).float()
            shape = self.conv_shape(r).float()
            off = shape_to_offsets(_nhwc(shape).detach()).permute(0, 3, 1, 2)
            c_a = F.relu(self.feature_adaption_cls(c, off, impl=impl))
            r_a = F.relu(self.feature_adaption_reg(r, off, impl=impl))
            outs.append((_nhwc(self.retina_cls(c_a)),
                         _nhwc(self.retina_reg(r_a)), _nhwc(shape),
                         _nhwc(loc)))
        return outs


class GARetinaNet(nn.Module):
    """ResNet C3-C5 + FPN (extra convs on the input, P3-P7) + GARetinaHead
    (flax ``bbox_head``); ``dtype`` the compute dtype."""

    def __init__(self, num_classes: int = 80, depth: int = 50,
                 dtype=torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.compute_dtype = dtype
        self.backbone = ResNet(depth=depth, out_indices=(1, 2, 3),
                               frozen_stages=1, dtype=dtype)
        self.neck = FPN((512, 1024, 2048), 256, 5, "on_input", dtype=dtype)
        self.bbox_head = GARetinaHead(num_classes, dtype=dtype)

    def forward(self, imgs: torch.Tensor, impl: Optional[str] = None):
        """imgs [N, H, W, 3] normalized -> the head's per-level outputs."""
        return self.bbox_head(self.neck(self.backbone(
            imgs.permute(0, 3, 1, 2))), impl=impl)


def _grid(stride: float, h: int, w: int, device):
    cy = torch.arange(h, dtype=torch.float32, device=device)[:, None] * stride
    cx = torch.arange(w, dtype=torch.float32, device=device)[None, :] * stride
    return cy.expand(h, w), cx.expand(h, w)


def _centred(cx, cy, aw, ah) -> torch.Tensor:
    return torch.stack([cx - aw / 2, cy - ah / 2, cx + aw / 2, cy + ah / 2],
                       dim=-1).reshape(-1, 4)


def guided_anchors(shape_pred: torch.Tensor, stride: float, h: int,
                   w: int) -> torch.Tensor:
    """The guided anchor of every cell [h * w, 4]: the square of side
    GA_SQUARE_SCALE * stride centred on ``(x, y) * stride``, its sides
    scaled by exp(dw), exp(dh) (target stds 1); shape_pred [h, w, 2]."""
    cy, cx = _grid(stride, h, w, shape_pred.device)
    aw = torch.exp(shape_pred[..., 0]) * GA_SQUARE_SCALE * stride
    ah = torch.exp(shape_pred[..., 1]) * GA_SQUARE_SCALE * stride
    return _centred(cx, cy, aw, ah)


def _calc_region(gb: torch.Tensor, ratio: float, h: int, w: int):
    """mmdet's ``calc_region``: the proportional centre region of boxes
    [G, 4] in cell units, rounded half to even and clamped to [0, size]."""
    x1 = torch.round((1 - ratio) * gb[:, 0] + ratio * gb[:, 2]).clamp(0, w)
    y1 = torch.round((1 - ratio) * gb[:, 1] + ratio * gb[:, 3]).clamp(0, h)
    x2 = torch.round(ratio * gb[:, 0] + (1 - ratio) * gb[:, 2]).clamp(0, w)
    y2 = torch.round(ratio * gb[:, 1] + (1 - ratio) * gb[:, 3]).clamp(0, h)
    return x1, y1, x2, y2


def ga_loc_targets(gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                   featmap_sizes, strides=GA_STRIDES,
                   octave_base_scale: int = GA_OCTAVE_BASE_SCALE):
    """mmdet's ``ga_loc_targets``: per level (target [h, w], weight
    [h, w]): 1 / 1 in each gt's centre region at its scale's level, weight 0
    in the ignore ring about it and in its rings projected onto the
    adjacent levels, weight 0.1 elsewhere; and the loss's average factor,
    the cells of all levels / 200."""
    g = gt_boxes.shape[0]
    dev = gt_boxes.device
    r1 = (1 - GA_CENTER_RATIO) / 2
    r2 = (1 - GA_IGNORE_RATIO) / 2
    scale = torch.sqrt(((gt_boxes[:, 2] - gt_boxes[:, 0])
                        * (gt_boxes[:, 3] - gt_boxes[:, 1])).clamp_min(1e-12))
    min_anchor = float(octave_base_scale * strides[0])
    lvl_of_gt = torch.floor(torch.log2(scale) - np.log2(min_anchor) + 0.5
                            ).clamp(0, len(featmap_sizes) - 1).long()
    gt_ids = torch.arange(1, g + 1, device=dev)[:, None, None]
    out = []
    for li, (h, w) in enumerate(featmap_sizes):
        xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
        ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
        gb = gt_boxes / float(strides[li])

        def region(ratio, live):
            x1, y1, x2, y2 = _calc_region(gb, ratio, h, w)
            m = ((xs >= x1[:, None, None]) & (xs <= x2[:, None, None])
                 & (ys >= y1[:, None, None]) & (ys <= y2[:, None, None]))
            return m & live[:, None, None]

        on = gt_valid & (lvl_of_gt == li)
        m_ign = region(r2, on)  # [G, h, w]
        m_ctr = region(r1, on)
        adj = gt_valid & ((lvl_of_gt == li - 1) | (lvl_of_gt == li + 1))
        ignore_map = region(r2, adj).any(0)
        last = torch.where(m_ign | m_ctr, gt_ids, 0).amax(0)  # [h, w]
        last_ctr = torch.gather(m_ctr, 0, (last - 1).clamp_min(0)[None])[0]
        wgt = torch.where(last > 0, last_ctr.float(), -1.0)
        tgt = m_ctr.any(0).float()
        wgt = torch.where((wgt < 0) & ignore_map, 0.0, wgt)
        wgt = torch.where(wgt < 0, 0.1, wgt)
        out.append((tgt, wgt))
    avg = sum(float(h * w) for h, w in featmap_sizes) / 200.0
    return out, avg


def cached_anchors(featmap_sizes, strides, device, **gen_kw
                   ) -> torch.Tensor:
    """``AnchorGenerator(strides, **gen_kw)``'s anchors of every level,
    concatenated [A, 4], made once a generator, size and device."""
    sizes = tuple(tuple(int(v) for v in s) for s in featmap_sizes)
    key = (tuple(sorted(gen_kw.items())), sizes, tuple(strides), str(device))
    if key not in _ANCHOR_CACHE:
        gen = AnchorGenerator(strides=tuple(strides), **gen_kw)
        _ANCHOR_CACHE[key] = torch.as_tensor(
            np.concatenate(gen.grid_anchors(sizes)), device=device)
    return _ANCHOR_CACHE[key]


def max_over_octaves(gt_boxes: torch.Tensor, approxs: torch.Tensor
                     ) -> torch.Tensor:
    """ApproxMaxIoUAssigner's overlaps: each gt's IoU with a cell's 9
    approximate anchors (3 octave scales x 3 ratios), maxed -> [G,
    cells]."""
    ov = box_ops.bbox_overlaps(gt_boxes, approxs)
    per_cell = len(GA_RATIOS) * GA_SCALES_PER_OCTAVE
    return ov.reshape(gt_boxes.shape[0], -1, per_cell).amax(-1)


def ga_approx_overlaps(gt_boxes: torch.Tensor, featmap_sizes
                       ) -> torch.Tensor:
    """Every gt's IoU with each square's 9 octave anchors, maxed -> [G,
    squares]."""
    return max_over_octaves(gt_boxes, cached_anchors(
        featmap_sizes, GA_STRIDES, gt_boxes.device, ratios=GA_RATIOS,
        octave_base_scale=GA_OCTAVE_BASE_SCALE,
        scales_per_octave=GA_SCALES_PER_OCTAVE))


def ga_squares(featmap_sizes, device=None) -> torch.Tensor:
    """The squares (scale 4, ratio 1), every level concatenated [A, 4]."""
    return cached_anchors(featmap_sizes, GA_STRIDES, device, ratios=(1.0,),
                          scales=(GA_SQUARE_SCALE,))


def ga_shape_assign(gt_boxes, gt_labels, gt_valid, featmap_sizes
                    ) -> assigners.AssignResult:
    """ApproxMaxIoUAssigner: the approximate overlaps, then MaxIoU at
    0.5 / 0.4 / 0.4."""
    overlaps = ga_approx_overlaps(gt_boxes, featmap_sizes)
    return assigners.max_iou_assign(None, gt_boxes, gt_labels, gt_valid,
                                    0.5, 0.4, 0.4, overlaps=overlaps)


def loc_focal_loss(loc_pairs, loc_avg: float, level_outs) -> torch.Tensor:
    """The loc branch's focal loss (alpha 0.25, gamma 2) on each level's
    weighted targets, each divided by ``loc_avg``, summed."""
    total = 0.0
    for (tgt, wgt), (_, _, _, loc) in zip(loc_pairs, level_outs):
        p = torch.sigmoid(loc.reshape(tgt.shape).float())
        pt = torch.where(tgt > 0, p, 1 - p)
        alpha_t = torch.where(tgt > 0, 0.25, 0.75)
        fl = alpha_t * (1 - pt) ** 2 * -torch.log(pt.clamp_min(1e-8))
        total = total + (fl * wgt).sum() / loc_avg
    return total


def shape_loss(squares, shape_all, gt_boxes, sh_assign, dw_std: float = 1.0,
               dh_std: float = 1.0) -> torch.Tensor:
    """Bounded IoU (beta 0.2) between the squares scaled by the predicted
    exp(dw * dw_std), exp(dh * dh_std) and their assigned gts, averaged
    over the positives."""
    pos = sh_assign.assigned_gt_inds > 0
    g = gt_boxes.shape[0]
    matched = gt_boxes[(sh_assign.assigned_gt_inds - 1).clamp(0, g - 1)]
    scx = (squares[:, 0] + squares[:, 2]) * 0.5
    scy = (squares[:, 1] + squares[:, 3]) * 0.5
    pw = (squares[:, 2] - squares[:, 0]) * torch.exp(shape_all[:, 0] * dw_std)
    ph = (squares[:, 3] - squares[:, 1]) * torch.exp(shape_all[:, 1] * dh_std)
    pred = torch.stack([scx - pw / 2, scy - ph / 2, scx + pw / 2,
                        scy + ph / 2], dim=-1)
    return losses.bounded_iou_loss(pred, matched, beta=0.2,
                                   weight=pos.float(),
                                   avg_factor=pos.sum().float().clamp_min(1))


class GALossOut(NamedTuple):
    loss_cls: torch.Tensor
    loss_bbox: torch.Tensor
    loss_shape: torch.Tensor
    loss_loc: torch.Tensor


def _sizes(level_outs):
    return [(c.shape[-3], c.shape[-2]) for c, _, _, _ in level_outs]


def ga_retina_loss(level_outs, gt_boxes: torch.Tensor,
                   gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                   num_classes: int) -> GALossOut:
    """GA-RetinaNet's loss on one image's level outputs: the loc focal loss
    (``ga_loc_targets``), the shape loss under ApproxMaxIoU (0.5 / 0.4 /
    0.4, every positive square), and the sigmoid focal loss and SmoothL1
    (beta 0.04) on the guided anchors assigned at 0.5 / 0.5 / 0 (no
    sampling), both averaged over the positives."""
    sizes = _sizes(level_outs)
    dev = gt_boxes.device
    loc_pairs, loc_avg = ga_loc_targets(gt_boxes, gt_valid, sizes)
    loss_loc = loc_focal_loss(loc_pairs, loc_avg, level_outs)
    shape_all = torch.cat([s.reshape(-1, 2).float()
                           for _, _, s, _ in level_outs])
    loss_shape = shape_loss(ga_squares(sizes, device=dev), shape_all,
                            gt_boxes, ga_shape_assign(gt_boxes, gt_labels,
                                                      gt_valid, sizes))
    cls_all = torch.cat([c.reshape(-1, num_classes).float()
                         for c, _, _, _ in level_outs])
    reg_all = torch.cat([r.reshape(-1, 4).float()
                         for _, r, _, _ in level_outs])
    anchors = torch.cat([
        guided_anchors(s.reshape(h, w, 2), GA_STRIDES[li], h, w).detach()
        for li, ((_, _, s, _), (h, w)) in enumerate(zip(level_outs, sizes))])
    assign = assigners.max_iou_assign(anchors, gt_boxes, gt_labels, gt_valid,
                                      0.5, 0.5, min_pos_iou=0.0)
    pos = assign.assigned_gt_inds > 0
    neg = assign.assigned_gt_inds == 0
    num_pos = pos.sum().float().clamp_min(1.0)
    onehot = F.one_hot(assign.labels.clamp(0, num_classes - 1),
                       num_classes).float() * pos[:, None]
    loss_cls = losses.sigmoid_focal_loss(cls_all, onehot,
                                         weight=(pos | neg).float()[:, None],
                                         avg_factor=num_pos)
    g = gt_boxes.shape[0]
    matched = gt_boxes[(assign.assigned_gt_inds - 1).clamp(0, g - 1)]
    tgt = box_ops.bbox2delta(anchors, matched)
    loss_bbox = losses.smooth_l1_loss(reg_all, tgt, beta=0.04,
                                      weight=pos[:, None].float(),
                                      avg_factor=num_pos)
    return GALossOut(loss_cls, loss_bbox, loss_shape, loss_loc)


@torch.no_grad()
def ga_retina_decode(level_outs, img_shape, num_classes: int,
                     scale_factor=None) -> nms_ops.DetResult:
    """Fixed-shape detections [GA_MAX_PER_IMG]: per level the sigmoid
    scores of the cells whose anchor presence passes GA_LOC_THR (the others
    0), the top GA_NMS_PRE (cell, class) pairs decoded on the guided
    anchors, then one class-aware NMS (IoU GA_NMS_IOU, scores above
    GA_SCORE_THR); boxes divided by ``scale_factor``."""
    levels = []
    for li, (cls, reg, shape, loc) in enumerate(level_outs):
        h, w = cls.shape[-3], cls.shape[-2]
        anc = guided_anchors(shape.reshape(h, w, 2), GA_STRIDES[li], h, w)
        keep = torch.sigmoid(loc.reshape(-1)) >= GA_LOC_THR
        scores = torch.sigmoid(cls.reshape(-1, num_classes).float()) \
            * keep[:, None]
        levels.append((box_ops.delta2bbox(anc, reg.reshape(-1, 4).float(),
                                          max_shape=img_shape), scores))
    return dense_decode(levels, num_classes, GA_NMS_PRE, GA_SCORE_THR,
                        GA_NMS_IOU, GA_MAX_PER_IMG, scale_factor)


def ga_retinanet_loss(model: GARetinaNet, batch,
                      impl: Optional[str] = None):
    """The single-image loss of a ``DetTrainBatch``: (total, metrics)."""
    outs = model(batch.img[None], impl=impl)
    ls = ga_retina_loss(outs, batch.gt_boxes, batch.gt_labels,
                        batch.gt_valid, model.num_classes)
    total = ls.loss_cls + ls.loss_bbox + ls.loss_shape + ls.loss_loc
    metrics = dict(ls._asdict())
    metrics["loss"] = total
    return total, metrics


@torch.no_grad()
def ga_retinanet_detect(model: GARetinaNet, img: torch.Tensor, img_shape,
                        scale_factor=None, impl: Optional[str] = None
                        ) -> nms_ops.DetResult:
    return ga_retina_decode(model(img[None], impl=impl), img_shape,
                            model.num_classes, scale_factor=scale_factor)

