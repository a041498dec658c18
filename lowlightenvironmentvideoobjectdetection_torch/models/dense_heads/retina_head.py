"""RetinaNet, the counterpart of the JAX package's
``models/dense_heads/retina_head.py`` (``RetinaHead``,
``retina_anchor_generator``, ``retina_loss``, ``retina_decode``,
``RetinaNet``; mmdet's ``retina_head.py`` and ``single_stage.py``): ResNet
C3-C5 -> FPN (256 channels, 5 levels, the extra two by stride-2 convs from
C5) -> on every level 4 stacked 3x3 convs a branch, then A x C sigmoid
logits (prior probability 0.01: bias -4.595) and A x 4 deltas, with A = 9
octave anchors a position (base scale 4, 3 scales an octave, ratios 0.5 /
1 / 2, strides 8-128).

The loss assigns every anchor inside the image (IoU 0.5 positive, 0.4
negative, no sampling), the focal loss over positives and negatives and L1
on the positives' deltas, both averaged over the positives. The decode keeps
each level's top 1000 (anchor, class) scores, in ``lax.top_k``'s order
(descending, the lower index first among equal scores: a stable sort, not
``torch.topk``, whose order among ties CUDA leaves open), then one
class-aware NMS (IoU 0.5, score above 0.05, at most 100): ``dense_decode``,
the tail every dense head's decode shares.

``NASFPNRetinaNet`` is RetinaNet with the NAS-FPN neck
(``necks/extra_necks.py`` ``NASFPN``, ``stack_times`` stacks; 7 in its
config) and ``RetinaSepBNHead``: RetinaNet's head whose conv kernels
(without bias) are shared by the levels while each level has its own
norm a stacked conv, a trainable per-channel affine (flax
``{cls,reg}_bn{level}_{i}_scale`` / ``_bias`` at the head's root): mmdet's
BN with frozen unit statistics, as the JAX docstring has it (ROADMAP
fault F29). Its loss and decode are RetinaNet's.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import assigners, boxes as box_ops, losses
from ...core import nms as nms_ops
from ...core.anchors import AnchorGenerator
from ..backbones.resnet import Conv2d, ResNet
from ..necks.extra_necks import NASFPN
from ..necks.fpn import FPN

PRIOR_BIAS = -4.595  # -log((1 - 0.01) / 0.01)


class RetinaHead(nn.Module):
    """Shared across the levels; flax names ``{cls,reg}_conv{i}``,
    ``retina_cls``, ``retina_reg``."""

    def __init__(self, num_classes: int = 80, num_base_anchors: int = 9,
                 in_channels: int = 256, feat_channels: int = 256,
                 stacked_convs: int = 4, dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.stacked_convs = stacked_convs
        for branch in ("cls", "reg"):
            for i in range(stacked_convs):
                self.add_module(f"{branch}_conv{i}", Conv2d(
                    in_channels if i == 0 else feat_channels, feat_channels,
                    3, padding=1, dtype=dtype))
        self.retina_cls = Conv2d(feat_channels, num_base_anchors * num_classes,
                                 3, padding=1, dtype=dtype)
        self.retina_reg = Conv2d(feat_channels, num_base_anchors * 4, 3,
                                 padding=1, dtype=dtype)

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        """The classifier's prior bias (``init_params`` zeroes biases)."""
        self.retina_cls.bias.fill_(PRIOR_BIAS)

    def forward(self, feats: Sequence[torch.Tensor]):
        """NCHW maps -> per level (cls [T, h, w, A*C], reg [T, h, w, A*4]),
        NHWC so that a flatten gives the JAX order (y, x, a, class)."""
        outs = []
        for x in feats:
            c = r = x
            for i in range(self.stacked_convs):
                c = F.relu(getattr(self, f"cls_conv{i}")(c))
                r = F.relu(getattr(self, f"reg_conv{i}")(r))
            outs.append((self.retina_cls(c).permute(0, 2, 3, 1),
                         self.retina_reg(r).permute(0, 2, 3, 1)))
        return outs


def retina_anchor_generator(strides=(8, 16, 32, 64, 128)) -> AnchorGenerator:
    return AnchorGenerator(strides=tuple(strides), ratios=(0.5, 1.0, 2.0),
                           octave_base_scale=4, scales_per_octave=3)


class RetinaSepBNHead(nn.Module):
    """flax names ``{cls,reg}_conv{i}`` (no bias, shared by the levels),
    ``{cls,reg}_bn{level}_{i}_scale`` / ``_bias`` (a level's affine after
    conv i), ``retina_cls``, ``retina_reg``."""

    def __init__(self, num_classes: int = 80, num_ins: int = 5,
                 num_base_anchors: int = 9, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 dtype=torch.float32):
        super().__init__()
        self.num_classes, self.num_ins = num_classes, num_ins
        self.stacked_convs = stacked_convs
        for branch in ("cls", "reg"):
            for i in range(stacked_convs):
                self.add_module(f"{branch}_conv{i}", Conv2d(
                    in_channels if i == 0 else feat_channels, feat_channels,
                    3, padding=1, bias=False, dtype=dtype))
                for lvl in range(num_ins):
                    self.register_parameter(
                        f"{branch}_bn{lvl}_{i}_scale",
                        nn.Parameter(torch.ones(feat_channels)))
                    self.register_parameter(
                        f"{branch}_bn{lvl}_{i}_bias",
                        nn.Parameter(torch.zeros(feat_channels)))
        self.retina_cls = Conv2d(feat_channels, num_base_anchors * num_classes,
                                 3, padding=1, dtype=dtype)
        self.retina_reg = Conv2d(feat_channels, num_base_anchors * 4, 3,
                                 padding=1, dtype=dtype)

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        """Unit affines and the classifier's prior bias."""
        for name, p in self.named_parameters(recurse=False):
            p.fill_(1.0 if name.endswith("_scale") else 0.0)
        self.retina_cls.bias.fill_(PRIOR_BIAS)

    def _sep_bn(self, x, branch, lvl, i):
        scale = getattr(self, f"{branch}_bn{lvl}_{i}_scale")
        bias = getattr(self, f"{branch}_bn{lvl}_{i}_bias")
        return (x * scale.to(x.dtype)[:, None, None]
                + bias.to(x.dtype)[:, None, None])

    def forward(self, feats: Sequence[torch.Tensor]):
        """NCHW maps -> per level (cls [T, h, w, A*C], reg [T, h, w, A*4]),
        NHWC."""
        if len(feats) != self.num_ins:
            raise ValueError(f"{len(feats)} levels, the head has "
                             f"{self.num_ins}")
        outs = []
        for lvl, x in enumerate(feats):
            c = r = x
            for i in range(self.stacked_convs):
                c = F.relu(self._sep_bn(getattr(self, f"cls_conv{i}")(c),
                                        "cls", lvl, i))
                r = F.relu(self._sep_bn(getattr(self, f"reg_conv{i}")(r),
                                        "reg", lvl, i))
            outs.append((self.retina_cls(c).permute(0, 2, 3, 1),
                         self.retina_reg(r).permute(0, 2, 3, 1)))
        return outs


class RetinaNet(nn.Module):
    """ResNet + FPN (extra convs on the input) + RetinaHead (flax
    ``bbox_head``). ``dtype`` is the compute dtype of all three. ``neck``
    and ``head`` replace the FPN and the head (NAS-FPN RetinaNet)."""

    def __init__(self, num_classes: int = 80, depth: int = 50,
                 dtype=torch.bfloat16, *, neck: Optional[nn.Module] = None,
                 head: Optional[nn.Module] = None):
        super().__init__()
        self.num_classes = num_classes
        self.compute_dtype = dtype
        self.backbone = ResNet(depth=depth, out_indices=(1, 2, 3),
                               frozen_stages=1, dtype=dtype)
        self.neck = neck or FPN((512, 1024, 2048), 256, 5, "on_input",
                                dtype=dtype)
        self.bbox_head = head or RetinaHead(num_classes, dtype=dtype)
        self.anchor_gen = retina_anchor_generator()
        self._anchors = {}

    def forward(self, imgs: torch.Tensor):
        """imgs [T, H, W, 3] normalized -> per level (cls, reg), NHWC."""
        return self.bbox_head(self.neck(self.backbone(
            imgs.permute(0, 3, 1, 2))))

    def anchors(self, outs) -> List[torch.Tensor]:
        """Per-level anchors [h*w*9, 4] for the head outputs' map sizes
        (cached by size)."""
        sizes = tuple((c.shape[-3], c.shape[-2]) for c, _ in outs)
        dev = outs[0][0].device
        key = (sizes, str(dev))
        if key not in self._anchors:
            self._anchors[key] = [torch.as_tensor(a, device=dev) for a in
                                  self.anchor_gen.grid_anchors(sizes)]
        return self._anchors[key]


class NASFPNRetinaNet(RetinaNet):
    """ResNet + NASFPN (``stack_times`` stacks) + RetinaSepBNHead; flax
    ``backbone``, ``neck``, ``bbox_head``."""

    def __init__(self, num_classes: int = 80, depth: int = 50,
                 stack_times: int = 7, dtype=torch.bfloat16):
        super().__init__(num_classes, depth, dtype,
                         neck=NASFPN(out_channels=256, num_outs=5,
                                     stack_times=stack_times, dtype=dtype),
                         head=RetinaSepBNHead(num_classes, dtype=dtype))


class RetinaLossOut(NamedTuple):
    loss_cls: torch.Tensor
    loss_bbox: torch.Tensor


def retina_loss(level_outs, level_anchors: Sequence[torch.Tensor],
                gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                gt_valid: torch.Tensor, img_shape, num_classes: int,
                pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.4
                ) -> RetinaLossOut:
    """level_outs: per level (cls [h, w, A*C], reg [h, w, A*4]) of one
    image."""
    cls_all = torch.cat([c.reshape(-1, num_classes).float()
                         for c, _ in level_outs])
    reg_all = torch.cat([r.reshape(-1, 4).float() for _, r in level_outs])
    anchors = torch.cat(list(level_anchors))
    h, w = img_shape[0], img_shape[1]
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] <= w) & (anchors[:, 3] <= h))
    assign = assigners.max_iou_assign(anchors, gt_boxes, gt_labels, gt_valid,
                                      pos_iou_thr, neg_iou_thr,
                                      min_pos_iou=0.0, box_valid=inside)
    pos = assign.assigned_gt_inds > 0
    neg = assign.assigned_gt_inds == 0
    num_pos = pos.sum().float().clamp_min(1.0)
    onehot = F.one_hot(assign.labels.clamp(0, num_classes - 1),
                       num_classes).float() * pos[:, None]
    weight = (pos | neg).float()[:, None]
    loss_cls = losses.sigmoid_focal_loss(cls_all, onehot, weight=weight,
                                         avg_factor=num_pos)
    g = gt_boxes.shape[0]
    matched = gt_boxes[(assign.assigned_gt_inds - 1).clamp(0, g - 1)]
    tgt = box_ops.bbox2delta(anchors, matched)
    loss_bbox = losses.l1_loss(reg_all, tgt, weight=pos[:, None].float(),
                               avg_factor=num_pos)
    return RetinaLossOut(loss_cls, loss_bbox)


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, descending, the
    lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dense_decode(levels, num_classes: int, nms_pre: int, score_thr: float,
                 iou_threshold: float, max_per_img: int, scale_factor=None
                 ) -> nms_ops.DetResult:
    """The dense heads' decode tail: per level (boxes [n, 4], scores [n,
    C]) the top ``nms_pre`` (box, class) scores (``top_k_stable``), boxes
    divided by ``scale_factor`` [4], then one class-aware NMS (scores above
    ``score_thr``) -> fixed-shape detections [max_per_img]."""
    all_b, all_s, all_l = [], [], []
    for boxes, scores in levels:
        flat = scores.reshape(-1)
        top_s, top_i = top_k_stable(flat, min(nms_pre, flat.shape[0]))
        all_b.append(boxes[top_i // num_classes])
        all_s.append(top_s)
        all_l.append(top_i % num_classes)
    boxes = torch.cat(all_b)
    scores = torch.cat(all_s)
    labels = torch.cat(all_l)
    if scale_factor is not None:
        boxes = boxes / torch.as_tensor(scale_factor, dtype=boxes.dtype,
                                        device=boxes.device)
    res = nms_ops.batched_nms(boxes, scores, labels, iou_threshold,
                              max_per_img, valid=scores > score_thr)
    return nms_ops.DetResult(res.boxes, res.scores, labels[res.inds],
                             res.valid)


@torch.no_grad()
def retina_decode(level_outs, level_anchors: Sequence[torch.Tensor],
                  img_shape, num_classes: int, nms_pre: int = 1000,
                  score_thr: float = 0.05, iou_threshold: float = 0.5,
                  max_per_img: int = 100, scale_factor=None
                  ) -> nms_ops.DetResult:
    """Fixed-shape detections [max_per_img] of one image (mmdet's anchor
    head ``get_bboxes``), boxes divided by ``scale_factor`` [4]."""
    levels = [(box_ops.delta2bbox(anc, reg.reshape(-1, 4).float(),
                                  max_shape=img_shape),
               torch.sigmoid(cls.reshape(-1, num_classes).float()))
              for (cls, reg), anc in zip(level_outs, level_anchors)]
    return dense_decode(levels, num_classes, nms_pre, score_thr,
                        iou_threshold, max_per_img, scale_factor)


def retinanet_loss(model: RetinaNet, batch):
    """The single-image loss of a ``DetTrainBatch``: (total, metrics)."""
    outs = model(batch.img[None])
    flat = [(c[0], r[0]) for c, r in outs]
    ls = retina_loss(flat, model.anchors(outs), batch.gt_boxes,
                     batch.gt_labels, batch.gt_valid, batch.img_shape,
                     model.num_classes)
    total = ls.loss_cls + ls.loss_bbox
    return total, {"loss": total, "loss_cls": ls.loss_cls,
                   "loss_bbox": ls.loss_bbox}


@torch.no_grad()
def retinanet_detect(model: RetinaNet, img: torch.Tensor, img_shape,
                     scale_factor=None) -> nms_ops.DetResult:
    outs = model(img[None])
    return retina_decode([(c[0], r[0]) for c, r in outs], model.anchors(outs),
                         img_shape, model.num_classes,
                         scale_factor=scale_factor)
