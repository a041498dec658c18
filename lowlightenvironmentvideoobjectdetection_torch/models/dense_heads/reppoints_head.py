"""RepPoints (the moment form), the counterpart of the JAX package's
``models/dense_heads/reppoints_head.py`` (``PointsDCN``, ``RepPointsHead``,
``MomentTransfer``, ``points_to_boxes``, ``_centers``, ``reppoints_loss``,
``reppoints_decode``, ``RepPointsDetector``; mmdet's ``reppoints_head.py``
and the moment config): RetinaNet's trunk (FPN extras on C5), 3 stacked
convs a branch; a cell's 9 points come from a 3x3 conv and a 1x1 conv on
the regression tower (18 channels, (dy, dx) a point, in strides); two 3x3
deformable convs sample the classification and regression towers at those
points (the offsets' gradient scaled by ``gradient_mul`` = 0.1), a 1x1
conv gives C sigmoid logits (prior bias -4.595), another the refinement
added to the detached initial points.

``PointsDCN`` is GA-RetinaNet's ``AdaptiveDCN``: a DCNv1 (one deform
group, given offsets, flax ``kernel`` and ``bias`` at the module's root)
through ``ops/deform_conv.deform_conv``, so kernel E runs forward on CUDA
tensors and kernels F and G backward (the points carry a gradient, so G's
output reaches the initial points' convs); the plain version on the CPU.
Its input and offsets are float32, as in JAX. The offsets are the points
minus the base 3x3 grid, both interleaved (dy, dx) a tap, which the DCN
reads as 9 dy and then 9 dx (its channel layout): the JAX package's order,
kept here (ROADMAP fault F26, as F22 and F24).

Points to boxes by the moment transfer: the centre is the points' mean,
the half extent their unbiased std (``torch.std`` as in mmdet) times
exp(the learnt transfer, when given). Points sit at ``x * stride``. The
loss assigns the initial stage with ``point_assign`` (scale 4, one point a
gt) and the refined one by MaxIoU (0.5 / 0.4) against the detached
initial boxes, jointly over the levels; SmoothL1 (beta 0.11; weights 0.5
and 1) on boxes over 4 strides, the focal loss on the refined
assignment.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import assigners, losses, nms as nms_ops
from .fcos_head import (DenseDetector, DenseTowers, clip_to_image, level_sizes,
                        nhwc)
from .guided_anchor_head import AdaptiveDCN
from .retina_head import PRIOR_BIAS, dense_decode
from ..backbones.resnet import Conv2d

REP_STRIDES = (8, 16, 32, 64, 128)
NUM_POINTS = 9
GRADIENT_MUL = 0.1

# a 3x3 DCNv1 with supplied offsets: the same layer as GA-RetinaNet's
PointsDCN = AdaptiveDCN
# the base 3x3 grid's (dy, dx) of each tap, row-major, interleaved [18]
BASE_GRID = tuple(v for dy in (-1.0, 0.0, 1.0) for dx in (-1.0, 0.0, 1.0)
                  for v in (dy, dx))


def points_offsets(pts_init: torch.Tensor,
                   gradient_mul: float = GRADIENT_MUL) -> torch.Tensor:
    """Initial points [N, 18, h, w] (interleaved (dy, dx)) -> the DCN's
    offsets [N, 18, h, w]: the points, their gradient scaled by
    ``gradient_mul``, minus the base grid, channel for channel (F26)."""
    grad_off = ((1 - gradient_mul) * pts_init.detach()
                + gradient_mul * pts_init)
    base = torch.tensor(BASE_GRID, dtype=pts_init.dtype,
                        device=pts_init.device)
    return grad_off - base[None, :, None, None]


class RepPointsHead(DenseTowers):
    """flax names ``{cls,reg}_conv{i}``, ``reppoints_pts_init_conv``,
    ``reppoints_pts_init_out``, ``reppoints_cls_conv``,
    ``reppoints_cls_out``, ``reppoints_pts_refine_conv``,
    ``reppoints_pts_refine_out``."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, point_feat_channels: int = 256,
                 stacked_convs: int = 3, gradient_mul: float = GRADIENT_MUL,
                 dtype=torch.bfloat16):
        super().__init__(in_channels, feat_channels, stacked_convs, dtype)
        self.num_classes = num_classes
        self.gradient_mul = gradient_mul
        pc = point_feat_channels
        self.reppoints_pts_init_conv = Conv2d(feat_channels, pc, 3, padding=1,
                                              dtype=dtype)
        self.reppoints_pts_init_out = Conv2d(pc, 2 * NUM_POINTS, 1,
                                             dtype=dtype)
        self.reppoints_cls_conv = PointsDCN(feat_channels, pc)
        self.reppoints_cls_out = Conv2d(pc, num_classes, 1, dtype=dtype)
        self.reppoints_pts_refine_conv = PointsDCN(feat_channels, pc)
        self.reppoints_pts_refine_out = Conv2d(pc, 2 * NUM_POINTS, 1,
                                               dtype=dtype)

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        self.reppoints_cls_out.bias.fill_(PRIOR_BIAS)

    def forward(self, feats: Sequence[torch.Tensor],
                impl: Optional[str] = None):
        """NCHW maps -> per level (cls [N, h, w, C] in the compute dtype,
        initial and refined points [N, h, w, 18] float32); ``impl=
        "plain"`` runs the DCN's plain version."""
        dt = self.compute_dtype
        outs = []
        for x in feats:
            c, r = self.towers(x)
            pts_init = self.reppoints_pts_init_out(F.relu(
                self.reppoints_pts_init_conv(r))).float()
            off = points_offsets(pts_init, self.gradient_mul)
            cls = self.reppoints_cls_out(F.relu(
                self.reppoints_cls_conv(c, off, impl=impl)).to(dt))
            delta = self.reppoints_pts_refine_out(F.relu(
                self.reppoints_pts_refine_conv(r, off, impl=impl)).to(
                    dt)).float()
            outs.append((nhwc(cls), nhwc(pts_init),
                         nhwc(delta + pts_init.detach())))
        return outs


class RepPointsDetector(DenseDetector):
    def __init__(self, num_classes: int = 80, depth: int = 50,
                 dtype=torch.bfloat16):
        super().__init__(RepPointsHead(num_classes, dtype=dtype), num_classes,
                         depth, dtype, add_extra_convs="on_input")


def _transfer(mt: torch.Tensor, moment_mul: float):
    """The learnt moment transfer with its gradient scaled by
    ``moment_mul``."""
    return mt * moment_mul + mt.detach() * (1 - moment_mul)


class MomentTransfer(nn.Module):
    """The learnable moment multipliers (flax ``moment_transfer`` [2], 0
    at init), shared across the levels. The JAX detector builds none (its
    loss and decode take ``moment_params=None``); kept for parity."""

    def __init__(self, moment_mul: float = 0.01):
        super().__init__()
        self.moment_mul = moment_mul
        self.moment_transfer = nn.Parameter(torch.zeros(2))

    @torch.no_grad()
    def init_flax(self, generator: Optional[torch.Generator]) -> None:
        self.moment_transfer.zero_()

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        """pts [..., 9, 2] (dy, dx) in strides about the cell -> boxes
        [..., 4] (x1, y1, x2, y2) in the same units."""
        mt = _transfer(self.moment_transfer, self.moment_mul)
        mean = pts.mean(-2)
        std = pts.std(-2)  # unbiased
        hw = std[..., 1] * torch.exp(mt[0])
        hh = std[..., 0] * torch.exp(mt[1])
        return torch.stack([mean[..., 1] - hw, mean[..., 0] - hh,
                            mean[..., 1] + hw, mean[..., 0] + hh], dim=-1)


def points_to_boxes(pts_flat: torch.Tensor, centers: torch.Tensor,
                    stride: float, moment_params=None,
                    moment_mul: float = 0.01) -> torch.Tensor:
    """Points [P, 18] (interleaved (dy, dx), in strides), centres [P, 2]
    (x, y) in pixels -> boxes [P, 4] in pixels by the moment transfer (the
    unbiased std, as mmdet's ``points2bbox``)."""
    pts = pts_flat.reshape(-1, NUM_POINTS, 2)
    mean = pts.mean(1)
    std = pts.std(1)
    if moment_params is not None:
        mt = _transfer(moment_params, moment_mul)
        sw, sh = torch.exp(mt[0]), torch.exp(mt[1])
    else:
        sw = sh = 1.0
    hw = std[:, 1] * sw * stride
    hh = std[:, 0] * sh * stride
    cx = centers[:, 0] + mean[:, 1] * stride
    cy = centers[:, 1] + mean[:, 0] * stride
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


class RepPointsLossOut(NamedTuple):
    loss_cls: torch.Tensor
    loss_pts_init: torch.Tensor
    loss_pts_refine: torch.Tensor


def _centers(shapes, device=None):
    """Per level [h * w, 2] (x, y) at ``(i, j) * stride`` (mmdet's
    PointGenerator: no half-cell offset)."""
    out = []
    for (h, w), s in zip(shapes, REP_STRIDES):
        ys = torch.arange(h, dtype=torch.float32, device=device) * s
        xs = torch.arange(w, dtype=torch.float32, device=device) * s
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        out.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
    return out


def _smooth_l1(diff: torch.Tensor, beta: float) -> torch.Tensor:
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def reppoints_loss(level_outs, gt_boxes: torch.Tensor,
                   gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                   num_classes: int, moment_params=None
                   ) -> RepPointsLossOut:
    """level_outs: per level (cls [h, w, C], initial and refined points
    [h, w, 18]) of one image."""
    dev = gt_boxes.device
    centers = _centers(level_sizes(level_outs), dev)
    g = gt_boxes.shape[0]
    box_i, box_r, cls_l, lvl_l, norm_l = [], [], [], [], []
    for li, (cls, p_init, p_ref) in enumerate(level_outs):
        stride = REP_STRIDES[li]
        ctr = centers[li]
        box_i.append(points_to_boxes(p_init.reshape(-1, 2 * NUM_POINTS), ctr,
                                     stride, moment_params))
        box_r.append(points_to_boxes(p_ref.reshape(-1, 2 * NUM_POINTS), ctr,
                                     stride, moment_params))
        cls_l.append(cls.reshape(-1, num_classes).float())
        n = ctr.shape[0]
        lvl_l.append(torch.full((n,), li + 3, dtype=torch.long, device=dev))
        norm_l.append(torch.full((n,), 4.0 * stride, device=dev))
    box_init, box_ref = torch.cat(box_i), torch.cat(box_r)
    norm = torch.cat(norm_l)[:, None]

    ar_i = assigners.point_assign(torch.cat(centers), torch.cat(lvl_l),
                                  gt_boxes, gt_labels, gt_valid, scale=4.0,
                                  pos_num=1)
    pos_i = (ar_i.assigned_gt_inds > 0).float()
    tgt_i = gt_boxes[(ar_i.assigned_gt_inds - 1).clamp(0, g - 1)]
    sl1_i = _smooth_l1((box_init - tgt_i).abs() / norm, 0.11)
    loss_init = 0.5 * (sl1_i * pos_i[:, None]).sum() / pos_i.sum().clamp_min(
        1.0)

    ar_r = assigners.max_iou_assign(box_init.detach(), gt_boxes, gt_labels,
                                    gt_valid, 0.5, 0.4, min_pos_iou=0.0)
    pos_r = (ar_r.assigned_gt_inds > 0).float()
    neg_r = (ar_r.assigned_gt_inds == 0).float()
    tgt_r = gt_boxes[(ar_r.assigned_gt_inds - 1).clamp(0, g - 1)]
    sl1_r = _smooth_l1((box_ref - tgt_r).abs() / norm, 0.11)
    denom_r = pos_r.sum().clamp_min(1.0)
    loss_refine = (sl1_r * pos_r[:, None]).sum() / denom_r
    onehot = F.one_hot(ar_r.labels.clamp(0, num_classes - 1),
                       num_classes).float() * pos_r[:, None]
    loss_cls = losses.sigmoid_focal_loss(
        torch.cat(cls_l), onehot, weight=torch.maximum(pos_r, neg_r)[:, None],
        avg_factor=denom_r)
    return RepPointsLossOut(loss_cls, loss_init, loss_refine)


@torch.no_grad()
def reppoints_decode(level_outs, img_shape, num_classes: int,
                     nms_pre: int = 1000, score_thr: float = 0.05,
                     iou_threshold: float = 0.5, max_per_img: int = 100,
                     scale_factor=None, moment_params=None
                     ) -> nms_ops.DetResult:
    centers = _centers(level_sizes(level_outs), level_outs[0][0].device)
    levels = []
    for li, (cls, _, p_ref) in enumerate(level_outs):
        boxes = points_to_boxes(p_ref.reshape(-1, 2 * NUM_POINTS),
                                centers[li], REP_STRIDES[li], moment_params)
        levels.append((clip_to_image(boxes, img_shape), torch.sigmoid(
            cls.reshape(-1, num_classes).float())))
    return dense_decode(levels, num_classes, nms_pre, score_thr,
                        iou_threshold, max_per_img, scale_factor)
