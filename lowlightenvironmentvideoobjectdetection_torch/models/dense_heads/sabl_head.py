"""SABL (side-aware boundary localisation, the RetinaNet form), the
counterpart of the JAX package's ``models/dense_heads/sabl_head.py``
(``SABLRetinaHead``, ``square_anchors``, ``_rescale``, ``_bucket_edges``,
``bbox2bucket``, ``bucket2bbox``, ``sabl_loss``, ``sabl_decode``,
``SABLRetinaNet``; mmdet's ``sabl_retina_head.py`` and
``bucketing_bbox_coder.py``): RetinaNet's trunk (FPN extras on C5) and
towers, one square anchor a cell (4 strides, centred at ``x * stride``),
C sigmoid logits (prior bias -4.595), and for each of the 4 sides of the
anchor rescaled 3x, 7 bucket logits and 7 fine offsets.

Targets: per side the nearest bucket (``argmin``, the lower bucket where
two tie) as the softmax class, its neighbours within one bucket ignored;
offsets on the nearest and on the second nearest where that lies within
one bucket. The loss is the focal loss on the IoU assignment (0.5 / 0.4,
no low-quality matches), the buckets' cross entropy and SmoothL1 (beta
1/9, weight 1.5) on the offsets, the last two over 4 x the positives. The
decode takes each side's best bucket and its offset, and multiplies the
class score by the mean over the sides of the best bucket's probability
plus the second's where it is adjacent; both come from ``top_k_stable``
(a stable sort: the lower bucket first among equal probabilities, as
``lax.top_k``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from ...core import boxes as box_ops, losses, nms as nms_ops
from .fcos_head import (DenseDetector, DenseTowers, clip_to_image, conv3x3,
                        level_sizes, nhwc)
from .retina_head import PRIOR_BIAS, dense_decode, top_k_stable

SABL_STRIDES = (8, 16, 32, 64, 128)
NUM_BUCKETS = 14
SIDE_NUM = 7  # ceil(14 / 2)
SCALE_FACTOR = 3.0


class SABLRetinaHead(DenseTowers):
    """flax names ``{cls,reg}_conv{i}``, ``retina_cls``,
    ``retina_bbox_cls``, ``retina_bbox_reg``."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 dtype=torch.bfloat16):
        super().__init__(in_channels, feat_channels, stacked_convs, dtype)
        self.num_classes = num_classes
        self.retina_cls = conv3x3(feat_channels, num_classes, dtype)
        self.retina_bbox_cls = conv3x3(feat_channels, SIDE_NUM * 4, dtype)
        self.retina_bbox_reg = conv3x3(feat_channels, SIDE_NUM * 4, dtype)

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        self.retina_cls.bias.fill_(PRIOR_BIAS)

    def forward(self, feats: Sequence[torch.Tensor],
                impl: Optional[str] = None):
        """NCHW maps -> per level (cls [N, h, w, C] in the compute dtype,
        bucket logits and offsets [N, h, w, 28] float32, side-major);
        ``impl`` unused."""
        outs = []
        for x in feats:
            c, r = self.towers(x)
            outs.append((nhwc(self.retina_cls(c)),
                         nhwc(self.retina_bbox_cls(r)).float(),
                         nhwc(self.retina_bbox_reg(r)).float()))
        return outs


class SABLRetinaNet(DenseDetector):
    def __init__(self, num_classes: int = 80, depth: int = 50,
                 dtype=torch.bfloat16):
        super().__init__(SABLRetinaHead(num_classes, dtype=dtype),
                         num_classes, depth, dtype,
                         add_extra_convs="on_input")


def square_anchors(shapes, scale: float = 4.0, strides=SABL_STRIDES,
                   device=None):
    """Per level [h * w, 4] squares of ``scale`` strides centred at
    ``(x, y) * stride``."""
    out = []
    for (h, w), s in zip(shapes, strides):
        cy = torch.arange(h, dtype=torch.float32, device=device)[:, None] * s
        cx = torch.arange(w, dtype=torch.float32, device=device)[None, :] * s
        half = scale * s / 2
        a = torch.stack([(cx - half).expand(h, w), (cy - half).expand(h, w),
                         (cx + half).expand(h, w), (cy + half).expand(h, w)],
                        dim=-1)
        out.append(a.reshape(-1, 4))
    return out


def _rescale(boxes: torch.Tensor, f: float = SCALE_FACTOR) -> torch.Tensor:
    cx = (boxes[:, 0] + boxes[:, 2]) / 2
    cy = (boxes[:, 1] + boxes[:, 3]) / 2
    hw = (boxes[:, 2] - boxes[:, 0]) / 2 * f
    hh = (boxes[:, 3] - boxes[:, 1]) / 2 * f
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def _bucket_edges(props: torch.Tensor):
    """(bucket width [N], height [N], the bucket centres [N, 4, S] of the
    sides (left, right, top, down))."""
    p = _rescale(props)
    bw = (p[:, 2] - p[:, 0]) / NUM_BUCKETS
    bh = (p[:, 3] - p[:, 1]) / NUM_BUCKETS
    steps = 0.5 + torch.arange(SIDE_NUM, dtype=torch.float32,
                               device=props.device)
    lb = p[:, 0, None] + steps[None] * bw[:, None]
    rb = p[:, 2, None] - steps[None] * bw[:, None]
    tb = p[:, 1, None] + steps[None] * bh[:, None]
    db = p[:, 3, None] - steps[None] * bh[:, None]
    return bw, bh, torch.stack([lb, rb, tb, db], dim=1)


def bbox2bucket(props: torch.Tensor, gt: torch.Tensor):
    """(offsets, offset weights, the nearest bucket one-hot, bucket class
    weights), each [N, 4, S]."""
    bw, bh, buckets = _bucket_edges(props)
    g = torch.stack([gt[:, 0], gt[:, 2], gt[:, 1], gt[:, 3]], dim=1)
    denom = torch.stack([bw, bw, bh, bh], dim=1)
    offsets = (buckets - g[:, :, None]) / denom[:, :, None].clamp_min(1e-6)
    a = offsets.abs()
    onehot = F.one_hot(a.argmin(-1), SIDE_NUM).float()
    second = (a + onehot * 1e9).argmin(-1)
    second_w = (torch.gather(a, -1, second[..., None])[..., 0] < 1.0).float()
    offset_w = onehot + F.one_hot(second, SIDE_NUM).float() * second_w[
        ..., None]
    near = (a < 1.0).float()
    cls_w = 1.0 - (near - onehot).clamp(0.0, 1.0)
    return offsets, offset_w, onehot, cls_w


def bucket2bbox(props: torch.Tensor, bucket_cls: torch.Tensor,
                bucket_off: torch.Tensor, max_shape=None):
    """Bucket logits and offsets [N, 4, S] -> (boxes [N, 4], the
    bucketing confidence [N])."""
    bw, bh, buckets = _bucket_edges(props)
    scores = torch.softmax(bucket_cls, dim=-1)
    top2_s, top2_i = top_k_stable(scores, 2)
    best = top2_i[..., :1]
    side = torch.gather(buckets, -1, best)[..., 0]
    off = torch.gather(bucket_off, -1, best)[..., 0]
    coord = side - off * torch.stack([bw, bw, bh, bh], dim=1)
    boxes = torch.stack([coord[:, 0], coord[:, 2], coord[:, 1], coord[:, 3]],
                        dim=-1)
    if max_shape is not None:
        boxes = clip_to_image(boxes, max_shape)
    conf = top2_s[..., 0] + top2_s[..., 1] * (
        (top2_i[..., 0] - top2_i[..., 1]).abs() == 1)
    return boxes, conf.mean(1)


class SABLLossOut(NamedTuple):
    loss_cls: torch.Tensor
    loss_bbox_cls: torch.Tensor
    loss_bbox_reg: torch.Tensor


def sabl_loss(level_outs, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
              gt_valid: torch.Tensor, num_classes: int,
              pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.4
              ) -> SABLLossOut:
    """level_outs: per level (cls [h, w, C], bucket logits and offsets
    [h, w, 28]) of one image."""
    dev = gt_boxes.device
    anchors = torch.cat(square_anchors(level_sizes(level_outs),
                                       device=dev))
    cls_all = torch.cat([c.reshape(-1, num_classes).float()
                         for c, _, _ in level_outs])
    bcls_all = torch.cat([b.reshape(-1, 4, SIDE_NUM) for _, b, _ in
                          level_outs])
    boff_all = torch.cat([o.reshape(-1, 4, SIDE_NUM) for _, _, o in
                          level_outs])
    iou = box_ops.bbox_overlaps(anchors, gt_boxes)
    iou = torch.where(gt_valid[None, :], iou, -1.0)
    best_iou = iou.amax(1)
    best_gt = iou.argmax(1)  # the first of equal maxima, as jnp.argmax
    pos = best_iou >= pos_iou_thr
    neg = (best_iou < neg_iou_thr) & (best_iou >= 0)
    num_pos = pos.sum().float().clamp_min(1.0)
    onehot = F.one_hot(gt_labels[best_gt].long().clamp(0, num_classes - 1),
                       num_classes).float() * pos[:, None]
    loss_cls = losses.sigmoid_focal_loss(
        cls_all, onehot, weight=(pos | neg).float()[:, None],
        avg_factor=num_pos)
    offs, offw, b_onehot, b_clsw = bbox2bucket(anchors, gt_boxes[best_gt])
    posf = pos.float()[:, None, None]
    logp = F.log_softmax(bcls_all, dim=-1)
    ce = -(logp * b_onehot).sum(-1, keepdim=True)
    keep = (b_onehot * b_clsw).sum(-1, keepdim=True)
    loss_bcls = (ce * keep * posf).sum() / (num_pos * 4.0)
    diff = (boff_all - offs).abs()
    beta = 1.0 / 9.0
    sl1 = torch.where(diff < beta, 0.5 * diff * diff / beta,
                      diff - 0.5 * beta)
    loss_boff = 1.5 * (sl1 * offw * posf).sum() / (num_pos * 4.0)
    return SABLLossOut(loss_cls, loss_bcls, loss_boff)


@torch.no_grad()
def sabl_decode(level_outs, img_shape, num_classes: int, nms_pre: int = 1000,
                score_thr: float = 0.05, iou_threshold: float = 0.5,
                max_per_img: int = 100, scale_factor=None
                ) -> nms_ops.DetResult:
    anchors = square_anchors(level_sizes(level_outs),
                             device=level_outs[0][0].device)
    levels = []
    for (cls, bcls, boff), anc in zip(level_outs, anchors):
        boxes, conf = bucket2bbox(anc, bcls.reshape(-1, 4, SIDE_NUM),
                                  boff.reshape(-1, 4, SIDE_NUM),
                                  max_shape=img_shape)
        scores = torch.sigmoid(cls.reshape(-1, num_classes).float())
        levels.append((boxes, scores * conf[:, None]))
    return dense_decode(levels, num_classes, nms_pre, score_thr,
                        iou_threshold, max_per_img, scale_factor)
