"""FCOS, the counterpart of the JAX package's
``models/dense_heads/fcos_head.py`` (``Scale``, ``FCOSHead``,
``fcos_points``, ``fcos_targets``, ``fcos_loss``, ``fcos_decode``, ``FCOS``;
mmdet's ``fcos_head.py`` and ``fcos.py``): ResNet C3-C5 -> FPN (256
channels, P3-P7, the extra two by stride-2 convs on the last output with a
ReLU before the second) -> on every level 4 stacked 3x3 convs a branch,
then C sigmoid logits (prior bias -4.595), exp(scale * (l, t, r, b)) and a
centerness logit on the classification branch.

Points sit at ``(i + 0.5) * stride``. A point is positive for the gts that
contain it and whose largest distance lies in its level's regress range;
among them the smallest area wins, the lower index where two tie (as
``argmin``). The loss is the sigmoid focal loss, the IoU loss of the
distances weighted by the centerness target, and the centerness BCE. The
decode multiplies the class score by the centerness, keeps each level's top
1000 (point, class) pairs in ``lax.top_k``'s order (``top_k_stable``), then
one class-aware NMS. Like the JAX towers, these have no GroupNorm (ROADMAP
fault F25).

The trunk and the towers are shared with ATSS, GFL, PAA and VFNet
(``DenseDetector``, ``DenseTowers``), the decode's tail with every dense
head (``retina_head.dense_decode``). Maps are NCHW in the modules and NHWC
in their outputs, so flattens give the JAX order.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import losses, nms as nms_ops
from ..backbones.resnet import Conv2d, ResNet
from ..necks.fpn import FPN
from .retina_head import PRIOR_BIAS, dense_decode

FCOS_STRIDES = (8, 16, 32, 64, 128)
REGRESS_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, 1e8))
NUM_LEVELS = len(FCOS_STRIDES)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Scale(nn.Module):
    """A learnable scalar on a level's regression (flax ``scale``, bridged
    as ``weight``), 1 at init."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(()))

    @torch.no_grad()
    def init_flax(self, generator: Optional[torch.Generator]) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight


class DenseTowers(nn.Module):
    """The classification and regression towers of the dense heads:
    ``stacked_convs`` 3x3 convs with ReLU a branch, flax names
    ``{cls,reg}_conv{i}``."""

    def __init__(self, in_channels: int, feat_channels: int,
                 stacked_convs: int, dtype):
        super().__init__()
        self.stacked_convs = stacked_convs
        self.compute_dtype = dtype
        for branch in ("cls", "reg"):
            for i in range(stacked_convs):
                self.add_module(f"{branch}_conv{i}", Conv2d(
                    in_channels if i == 0 else feat_channels, feat_channels,
                    3, padding=1, dtype=dtype))

    def towers(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c = r = x
        for i in range(self.stacked_convs):
            c = F.relu(getattr(self, f"cls_conv{i}")(c))
            r = F.relu(getattr(self, f"reg_conv{i}")(r))
        return c, r


def conv3x3(cin: int, cout: int, dtype) -> Conv2d:
    return Conv2d(cin, cout, 3, padding=1, dtype=dtype)


class FCOSHead(DenseTowers):
    """flax names ``{cls,reg}_conv{i}``, ``fcos_cls``, ``fcos_reg``,
    ``fcos_centerness``, ``scale{li}``."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 dtype=torch.bfloat16):
        super().__init__(in_channels, feat_channels, stacked_convs, dtype)
        self.num_classes = num_classes
        self.fcos_cls = conv3x3(feat_channels, num_classes, dtype)
        self.fcos_reg = conv3x3(feat_channels, 4, dtype)
        self.fcos_centerness = conv3x3(feat_channels, 1, dtype)
        for li in range(NUM_LEVELS):
            self.add_module(f"scale{li}", Scale())

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        self.fcos_cls.bias.fill_(PRIOR_BIAS)

    def forward(self, feats: Sequence[torch.Tensor],
                impl: Optional[str] = None):
        """NCHW maps -> per level (cls [N, h, w, C] in the compute dtype,
        dist [N, h, w, 4] float32, centerness [N, h, w, 1]); ``impl`` is
        unused (no kernel)."""
        outs = []
        for li, x in enumerate(feats):
            c, r = self.towers(x)
            dist = torch.exp(getattr(self, f"scale{li}")(
                self.fcos_reg(r).float()))
            outs.append((nhwc(self.fcos_cls(c)), nhwc(dist),
                         nhwc(self.fcos_centerness(c))))
        return outs


class DenseDetector(nn.Module):
    """ResNet C3-C5 + FPN (P3-P7: the extra convs on the output with a ReLU
    before the second, or with ``add_extra_convs="on_input"`` RetinaNet's,
    the first on C5 and no ReLU) + a dense head (flax ``bbox_head``);
    ``dtype`` the compute dtype."""

    def __init__(self, head: nn.Module, num_classes: int, depth: int,
                 dtype, add_extra_convs: str = "on_output"):
        super().__init__()
        self.num_classes = num_classes
        self.compute_dtype = dtype
        self.backbone = ResNet(depth=depth, out_indices=(1, 2, 3),
                               frozen_stages=1, dtype=dtype)
        self.neck = FPN((512, 1024, 2048), 256, 5, add_extra_convs,
                        relu_before_extra_convs=add_extra_convs == "on_output",
                        dtype=dtype)
        self.bbox_head = head

    def forward(self, imgs: torch.Tensor, impl: Optional[str] = None):
        """imgs [N, H, W, 3] normalized -> the head's per-level outputs;
        ``impl="plain"`` runs a head's kernels' plain versions."""
        return self.bbox_head(self.neck(self.backbone(
            imgs.permute(0, 3, 1, 2))), impl=impl)


class FCOS(DenseDetector):
    def __init__(self, num_classes: int = 80, depth: int = 50,
                 dtype=torch.bfloat16):
        super().__init__(FCOSHead(num_classes, dtype=dtype), num_classes,
                         depth, dtype)


def level_sizes(level_outs) -> List[Tuple[int, int]]:
    return [(o[0].shape[-3], o[0].shape[-2]) for o in level_outs]


def fcos_points(shapes, device=None) -> List[torch.Tensor]:
    """Per-level [h * w, 2] (x, y) centre points in image coordinates."""
    pts = []
    for (h, w), s in zip(shapes, FCOS_STRIDES):
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * s
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * s
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
    return pts


class FCOSLossOut(NamedTuple):
    loss_cls: torch.Tensor
    loss_bbox: torch.Tensor
    loss_centerness: torch.Tensor


def fcos_targets(points: torch.Tensor, ranges: torch.Tensor,
                 gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                 gt_valid: torch.Tensor):
    """Point-in-box assignment with per-level regress ranges, no centre
    sampling. points [P, 2], ranges [P, 2] -> (pos [P] bool, labels [P],
    ltrb [P, 4]), the last two meaningful only where pos."""
    l = points[:, None, 0] - gt_boxes[None, :, 0]
    t = points[:, None, 1] - gt_boxes[None, :, 1]
    r = gt_boxes[None, :, 2] - points[:, None, 0]
    b = gt_boxes[None, :, 3] - points[:, None, 1]
    ltrb = torch.stack([l, t, r, b], dim=-1)  # [P, G, 4]
    inside = ltrb.amin(-1) > 0
    maxd = ltrb.amax(-1)
    in_range = (maxd >= ranges[:, None, 0]) & (maxd <= ranges[:, None, 1])
    areas = ((gt_boxes[:, 2] - gt_boxes[:, 0]).clamp_min(0)
             * (gt_boxes[:, 3] - gt_boxes[:, 1]).clamp_min(0))
    cand = inside & in_range & gt_valid[None, :]
    area_m = torch.where(cand, areas[None, :], 1e18)
    best_gt = area_m.argmin(1)  # ties: the lower index
    pos = cand.any(1)
    tgt_ltrb = ltrb[torch.arange(ltrb.shape[0], device=ltrb.device),
                    best_gt]
    return pos, gt_labels[best_gt], tgt_ltrb


def fcos_loss(level_outs, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
              gt_valid: torch.Tensor, num_classes: int) -> FCOSLossOut:
    """level_outs: per level (cls [h, w, C], dist [h, w, 4], ctr [h, w, 1])
    of one image."""
    shapes = level_sizes(level_outs)
    dev = gt_boxes.device
    cls_all = torch.cat([c.reshape(-1, num_classes).float()
                         for c, _, _ in level_outs])
    dist_all = torch.cat([d.reshape(-1, 4) for _, d, _ in level_outs])
    ctr_all = torch.cat([t.reshape(-1).float() for _, _, t in level_outs])
    points = torch.cat(fcos_points(shapes, dev))
    ranges = torch.cat([
        torch.tensor(REGRESS_RANGES[i], dtype=torch.float32,
                     device=dev).expand(h * w, 2)
        for i, (h, w) in enumerate(shapes)])
    pos, tgt_labels, tgt_ltrb = fcos_targets(points, ranges, gt_boxes,
                                             gt_labels, gt_valid)
    num_pos = pos.sum().float().clamp_min(1.0)
    onehot = F.one_hot(tgt_labels.long().clamp(0, num_classes - 1),
                       num_classes).float() * pos[:, None]
    loss_cls = losses.sigmoid_focal_loss(cls_all, onehot, avg_factor=num_pos)
    pl, pt, pr, pb = dist_all.unbind(-1)
    tl, tt, tr, tb = tgt_ltrb.clamp_min(0.0).unbind(-1)
    inter_w = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    inter_h = torch.minimum(pt, tt) + torch.minimum(pb, tb)
    inter = inter_w.clamp_min(0) * inter_h.clamp_min(0)
    union = (pl + pr) * (pt + pb) + (tl + tr) * (tt + tb) - inter
    iou = inter / union.clamp_min(1e-6)
    ctr_tgt = torch.sqrt(
        (torch.minimum(tl, tr) / torch.maximum(tl, tr).clamp_min(1e-6))
        * (torch.minimum(tt, tb) / torch.maximum(tt, tb).clamp_min(1e-6)))
    posf = pos.float()
    loss_bbox = ((-torch.log(iou.clamp_min(1e-6)) * posf * ctr_tgt).sum()
                 / (ctr_tgt * posf).sum().clamp_min(1e-6))
    loss_ctr = losses.binary_cross_entropy(ctr_all, ctr_tgt, weight=posf,
                                           avg_factor=num_pos)
    return FCOSLossOut(loss_cls, loss_bbox, loss_ctr)


def clip_to_image(boxes: torch.Tensor, img_shape) -> torch.Tensor:
    """``jnp.clip(boxes, 0, [w, h, w, h])``."""
    shp = torch.as_tensor(img_shape, dtype=torch.float32, device=boxes.device)
    h, w = shp[0], shp[1]
    return torch.minimum(boxes.clamp_min(0.0), torch.stack([w, h, w, h]))


@torch.no_grad()
def fcos_decode(level_outs, img_shape, num_classes: int, nms_pre: int = 1000,
                score_thr: float = 0.05, iou_threshold: float = 0.5,
                max_per_img: int = 100, scale_factor=None
                ) -> nms_ops.DetResult:
    pts = fcos_points(level_sizes(level_outs), level_outs[0][0].device)
    levels = []
    for (cls, dist, ctr), p in zip(level_outs, pts):
        scores = (torch.sigmoid(cls.reshape(-1, num_classes).float())
                  * torch.sigmoid(ctr.reshape(-1, 1).float()))
        d = dist.reshape(-1, 4)
        boxes = torch.stack([p[:, 0] - d[:, 0], p[:, 1] - d[:, 1],
                             p[:, 0] + d[:, 2], p[:, 1] + d[:, 3]], dim=-1)
        levels.append((clip_to_image(boxes, img_shape), scores))
    return dense_decode(levels, num_classes, nms_pre, score_thr,
                        iou_threshold, max_per_img, scale_factor)
