"""VFNet (VarifocalNet), the counterpart of the JAX package's
``models/dense_heads/vfnet_head.py`` (``Scale``, ``StarDCN``,
``star_offsets``, ``VFNetHead``, ``_points``, ``_dist2box``, ``_giou``,
``varifocal_loss``, ``vfnet_loss``, ``vfnet_decode``, ``VFNet``; mmdet's
``vfnet_head.py``): FCOS's trunk, 3 stacked convs a branch, an initial
(l, t, r, b) of exp(scale * conv) * (64, 128, 256, 512, 1024) a level;
the initial box's nine star points (corners, edge midpoints, centre) are
the offsets of two 3x3 deformable convs over the regression and the
classification towers (``star_offsets``, the offsets' gradient scaled by
``gradient_mul`` = 0.1); the refined distances are exp(scale' * conv) times
the initial ones; the classifier reads the adapted classification tower.

``StarDCN`` is GA-RetinaNet's ``AdaptiveDCN``: a DCNv1 (one deform group,
given offsets, flax ``kernel`` and ``bias`` at the module's root) through
``ops/deform_conv.deform_conv``, so kernel E runs forward on CUDA tensors
and kernels F and G backward (the offsets carry a gradient here, so G's
output reaches the initial distances); the plain version on the CPU. Its
input and offsets are float32, as in JAX. ``star_offsets`` stacks (dy, dx)
interleaved for each tap, which the DCN reads as 9 dy and then 9 dx (its
channel layout): the JAX package's order, kept here (ROADMAP fault F24).

Points sit at ``x * stride`` (the ATSS anchors' centres); the assignment
is ATSS's. The loss is the varifocal loss (alpha 0.75, gamma 2; the
positive target the refined box's GIoU clamped to [0, 1]) and GIoU losses
on the initial (weight 1.5) and refined (2.0) boxes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from ...core import nms as nms_ops
from .atss_head import atss_anchors, atss_assign
from .fcos_head import (NUM_LEVELS, DenseDetector, DenseTowers, Scale,
                        clip_to_image, conv3x3, level_sizes, nhwc)
from .guided_anchor_head import AdaptiveDCN
from .retina_head import PRIOR_BIAS, dense_decode

VFNET_STRIDES = (8, 16, 32, 64, 128)
REG_DENOMS = (64, 128, 256, 512, 1024)
GRADIENT_MUL = 0.1

# a 3x3 DCNv1 with supplied offsets: the same layer as GA-RetinaNet's
StarDCN = AdaptiveDCN
# the base 3x3 grid's (y, x) of each tap, row-major
_BASE = ((-1., -1.), (-1., 0.), (-1., 1.), (0., -1.), (0., 0.), (0., 1.),
         (1., -1.), (1., 0.), (1., 1.))


def star_offsets(dist: torch.Tensor, stride: float,
                 gradient_mul: float = GRADIENT_MUL) -> torch.Tensor:
    """dist [..., 4] (l, t, r, b) in image pixels -> DCN offsets [..., 18]:
    for each of the 9 taps (row-major) its (dy, dx) from the base 3x3
    grid, interleaved (F24)."""
    d = ((1 - gradient_mul) * dist.detach() + gradient_mul * dist) / stride
    l, t, r, b = d.unbind(-1)
    z = torch.zeros_like(l)
    taps = ((-t, -l), (-t, z), (-t, r), (z, -l), (z, z), (z, r),
            (b, -l), (b, z), (b, r))
    chans = []
    for (ty, tx), (by, bx) in zip(taps, _BASE):
        chans.append(ty - by)
        chans.append(tx - bx)
    return torch.stack(chans, dim=-1)


class VFNetHead(DenseTowers):
    """flax names ``{cls,reg}_conv{i}``, ``vfnet_reg``,
    ``reg_refine_dconv``, ``vfnet_reg_refine``, ``cls_dconv``,
    ``vfnet_cls``, ``scale{li}``, ``scale_refine{li}``."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 3,
                 dtype=torch.bfloat16):
        super().__init__(in_channels, feat_channels, stacked_convs, dtype)
        self.num_classes = num_classes
        self.vfnet_reg = conv3x3(feat_channels, 4, dtype)
        self.reg_refine_dconv = StarDCN(feat_channels, feat_channels)
        self.vfnet_reg_refine = conv3x3(feat_channels, 4, dtype)
        self.cls_dconv = StarDCN(feat_channels, feat_channels)
        self.vfnet_cls = conv3x3(feat_channels, num_classes, dtype)
        for li in range(NUM_LEVELS):
            self.add_module(f"scale{li}", Scale())
            self.add_module(f"scale_refine{li}", Scale())

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        self.vfnet_cls.bias.fill_(PRIOR_BIAS)

    def forward(self, feats: Sequence[torch.Tensor],
                impl: Optional[str] = None):
        """NCHW maps -> per level (cls [N, h, w, C] in the compute dtype,
        initial and refined distances [N, h, w, 4] float32); ``impl=
        "plain"`` runs the DCN's plain version."""
        dt = self.compute_dtype
        outs = []
        for li, x in enumerate(feats):
            c, r = self.towers(x)
            init_dist = torch.exp(getattr(self, f"scale{li}")(
                nhwc(self.vfnet_reg(r)).float())) * REG_DENOMS[li]
            offset = star_offsets(init_dist, VFNET_STRIDES[li]).permute(
                0, 3, 1, 2)
            r_ref = F.relu(self.reg_refine_dconv(r, offset, impl=impl))
            ref_mul = torch.exp(getattr(self, f"scale_refine{li}")(
                nhwc(self.vfnet_reg_refine(r_ref.to(dt))).float()))
            c_al = F.relu(self.cls_dconv(c, offset, impl=impl))
            outs.append((nhwc(self.vfnet_cls(c_al.to(dt))), init_dist,
                         ref_mul * init_dist))
        return outs


class VFNet(DenseDetector):
    def __init__(self, num_classes: int = 80, depth: int = 50,
                 dtype=torch.bfloat16):
        super().__init__(VFNetHead(num_classes, dtype=dtype), num_classes,
                         depth, dtype)


def _points(shapes, device=None):
    """Per-level [h * w, 2] (x, y) points at ``(i, j) * stride``."""
    pts = []
    for (h, w), s in zip(shapes, VFNET_STRIDES):
        ys = torch.arange(h, dtype=torch.float32, device=device) * s
        xs = torch.arange(w, dtype=torch.float32, device=device) * s
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
    return pts


def _dist2box(p: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return torch.stack([p[:, 0] - d[:, 0], p[:, 1] - d[:, 1],
                        p[:, 0] + d[:, 2], p[:, 1] + d[:, 3]], dim=-1)


def _giou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Aligned GIoU [N] (the enclosing box's area clamped before its
    difference: VFNet's form)."""
    x1 = torch.maximum(a[:, 0], b[:, 0])
    y1 = torch.maximum(a[:, 1], b[:, 1])
    x2 = torch.minimum(a[:, 2], b[:, 2])
    y2 = torch.minimum(a[:, 3], b[:, 3])
    inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    aa = (a[:, 2] - a[:, 0]).clamp_min(0) * (a[:, 3] - a[:, 1]).clamp_min(0)
    ab = (b[:, 2] - b[:, 0]).clamp_min(0) * (b[:, 3] - b[:, 1]).clamp_min(0)
    union = (aa + ab - inter).clamp_min(1e-6)
    iou = inter / union
    ex1 = torch.minimum(a[:, 0], b[:, 0])
    ey1 = torch.minimum(a[:, 1], b[:, 1])
    ex2 = torch.maximum(a[:, 2], b[:, 2])
    ey2 = torch.maximum(a[:, 3], b[:, 3])
    enc = ((ex2 - ex1) * (ey2 - ey1)).clamp_min(1e-6)
    return iou - (enc - union) / enc


def varifocal_loss(logits: torch.Tensor, targets: torch.Tensor,
                   alpha: float = 0.75, gamma: float = 2.0,
                   avg_factor=1.0) -> torch.Tensor:
    """Positives weighted by their IoU target q, negatives by alpha *
    p^gamma; the sum over the average factor (at least 1)."""
    p = torch.sigmoid(logits)
    pos = (targets > 0).float()
    weight = targets * pos + alpha * p ** gamma * (1 - pos)
    bce = (torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
           + torch.log1p(torch.exp(-logits.abs())))
    return (bce * weight).sum() / torch.as_tensor(
        avg_factor, dtype=logits.dtype, device=logits.device).clamp_min(1.0)


class VFNetLossOut(NamedTuple):
    loss_cls: torch.Tensor
    loss_bbox: torch.Tensor
    loss_bbox_refine: torch.Tensor


def vfnet_loss(level_outs, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
               gt_valid: torch.Tensor, num_classes: int) -> VFNetLossOut:
    """level_outs: per level (cls [h, w, C], initial and refined distances
    [h, w, 4]) of one image."""
    shapes = level_sizes(level_outs)
    dev = gt_boxes.device
    pts = torch.cat(_points(shapes, dev))
    cls_all = torch.cat([c.reshape(-1, num_classes).float()
                         for c, _, _ in level_outs])
    init_all = torch.cat([d.reshape(-1, 4) for _, d, _ in level_outs])
    ref_all = torch.cat([d.reshape(-1, 4) for _, _, d in level_outs])
    assigned = atss_assign(atss_anchors(shapes, device=dev), gt_boxes,
                           gt_valid)
    pos = assigned >= 0
    safe_gt = assigned.clamp(0, gt_boxes.shape[0] - 1)
    matched = gt_boxes[safe_gt]
    num_pos = pos.sum().float().clamp_min(1.0)
    giou_i = _giou(_dist2box(pts, init_all), matched)
    giou_r = _giou(_dist2box(pts, ref_all), matched)
    posf = pos.float()
    loss_bbox = 1.5 * ((1 - giou_i) * posf).sum() / num_pos
    loss_refine = 2.0 * ((1 - giou_r) * posf).sum() / num_pos
    iou_q = giou_r.detach().clamp(0.0, 1.0) * posf
    tgt = F.one_hot(gt_labels[safe_gt].long().clamp(0, num_classes - 1),
                    num_classes).float() * iou_q[:, None]
    loss_cls = varifocal_loss(cls_all, tgt, avg_factor=num_pos)
    return VFNetLossOut(loss_cls, loss_bbox, loss_refine)


@torch.no_grad()
def vfnet_decode(level_outs, img_shape, num_classes: int, nms_pre: int = 1000,
                 score_thr: float = 0.05, iou_threshold: float = 0.6,
                 max_per_img: int = 100, scale_factor=None
                 ) -> nms_ops.DetResult:
    pts = _points(level_sizes(level_outs), level_outs[0][0].device)
    levels = []
    for (cls, _, ref), p in zip(level_outs, pts):
        boxes = clip_to_image(_dist2box(p, ref.reshape(-1, 4)), img_shape)
        levels.append((boxes, torch.sigmoid(
            cls.reshape(-1, num_classes).float())))
    return dense_decode(levels, num_classes, nms_pre, score_thr,
                        iou_threshold, max_per_img, scale_factor)
