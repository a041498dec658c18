"""FPN Faster R-CNN (mmdet's ``faster_rcnn_r50_fpn`` trunk), the counterpart
of the JAX package's ``models/detectors/fpn_faster_rcnn.py`` without its
variants: ResNet C2-C5 -> FPN (256 channels, 5 levels, the fifth by max
pool) -> the RPN on every level (3 anchors a position: scale 8, ratios
0.5 / 1 / 2, strides 4-64) -> RoIAlign 7x7 on the level each roi's scale
maps to (``map_roi_levels``, finest scale 56) -> the Shared2FC head.

Anchors come from the feature maps' sizes on every call, as mmdet's
``grid_anchors(featmap_sizes)`` (cached by size), not from a size fixed at
build time: the JAX model builds them for its own ``pad_h`` x ``pad_w``
and fails at any other bucket (ROADMAP fault F18).

RoIAlign runs once a roi, on its own level: the rois are sorted by level on
the device, the four counts read in one transfer, and each non-empty
level's slice goes to ``ops/roi_align.roi_align`` (kernel B on CUDA
tensors, kernel D for its gradient; the plain version on the CPU); the
results return to roi order by the inverse permutation. The JAX package
pools every roi on all four levels and keeps one (its TPU form of a
dynamic dispatch); the values are the same. Maps are pooled in float32, as
in JAX.

The GA-RPN, GRoIE and Libra variants (``rpn_type="ga"``,
``roi_extract="groie"``, ``with_bfp``, the iou-balanced sampler and the
balanced-L1 loss) raise ``NotImplementedError`` (ROADMAP.md Queue 1 item
9). Proposals carry no gradient, as in the original (ROADMAP fault F6).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ...core import assigners, boxes as box_ops, losses
from ...core.anchors import AnchorGenerator
from ...core.nms import DetResult
from ...ops.roi_align import roi_align
from ..backbones.resnet import ResNet
from ..dense_heads import rpn_head as rpn
from ..necks.fpn import FPN
from ..roi_heads import bbox_head as bh
from ..vid.selsa import LossUniforms

FPN_STRIDES = (4, 8, 16, 32, 64)
FPN_RPN_SCALE = 8.0
FPN_FINEST_SCALE = 56.0
NUM_ROI_LEVELS = 4
FPN_BBOX_STDS = (0.1, 0.1, 0.2, 0.2)
RPN_NMS_PRE = 2000
RPN_NMS_IOU = 0.7
ZOO_ITEM = "ROADMAP.md Queue 1 item 9, the mmdet zoo"


def fpn_anchor_gen() -> AnchorGenerator:
    """Per-level single-scale RPN anchors (faster_rcnn_r50_fpn config)."""
    return AnchorGenerator(strides=FPN_STRIDES, ratios=(0.5, 1.0, 2.0),
                           scales=(FPN_RPN_SCALE,))


def map_roi_levels(rois: torch.Tensor, num_levels: int = NUM_ROI_LEVELS,
                   finest_scale: float = FPN_FINEST_SCALE) -> torch.Tensor:
    """mmdet's ``map_roi_levels``: floor(log2(sqrt(area) / finest_scale +
    1e-6)) clamped to [0, num_levels - 1], in float32 -> int64 [N]."""
    scale = torch.sqrt(((rois[:, 2] - rois[:, 0])
                        * (rois[:, 3] - rois[:, 1])).clamp_min(0.0))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def multilevel_roi_align(level_feats: Sequence[torch.Tensor],
                         rois: torch.Tensor, out_size: int = 7,
                         num_levels: int = NUM_ROI_LEVELS,
                         impl: Optional[str] = None,
                         level_counts: Optional[List[int]] = None
                         ) -> torch.Tensor:
    """Each roi [N, 4] pooled from the level its scale maps to: level_feats
    per level [1, h, w, C] (P2 first) -> [N, out_size, out_size, C] float32.
    One ``roi_align`` call a non-empty level on that level's rois; the
    level counts are appended to ``level_counts`` when given."""
    n = rois.shape[0]
    lvl = map_roi_levels(rois, num_levels)
    order = torch.argsort(lvl, stable=True)
    counts = torch.bincount(lvl, minlength=num_levels).tolist()
    if level_counts is not None:
        level_counts.append(counts)
    sorted_rois = rois[order]
    pooled, start = [], 0
    for i, k in enumerate(counts):
        if k:
            part = sorted_rois[start:start + k]
            pooled.append(roi_align(
                level_feats[i].float().contiguous(), part,
                1.0 / FPN_STRIDES[i],
                batch_inds=torch.zeros(k, dtype=torch.int64,
                                       device=rois.device),
                out_size=out_size, sampling_ratio=2, impl=impl))
        start += k
    if not pooled:
        c = level_feats[0].shape[-1]
        return rois.new_zeros((0, out_size, out_size, c))
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(n, device=rois.device)
    return torch.cat(pooled)[inverse]


class FPNFasterRCNN(nn.Module):
    """ResNet + FPN + RPN + level-dispatched RoIAlign + Shared2FC head, with
    the JAX module's fields. ``dtype`` is the trunk's compute dtype; the
    bbox head computes in float32."""

    def __init__(self, num_classes: int = 80, depth: int = 50,
                 rpn_type: str = "rpn", roi_extract: str = "single",
                 with_bfp: bool = False, pad_h: int = 800, pad_w: int = 1344,
                 train_nms_post: int = 600, test_nms_post: int = 300,
                 num_roi_samples: int = 256, dtype=torch.bfloat16):
        super().__init__()
        if rpn_type != "rpn" or roi_extract != "single" or with_bfp:
            raise NotImplementedError(
                f"FPN Faster R-CNN with rpn_type={rpn_type!r}, roi_extract="
                f"{roi_extract!r}, with_bfp={with_bfp}: the GA-RPN, GRoIE "
                f"and Libra variants are not ported ({ZOO_ITEM})")
        self.num_classes = num_classes
        self.pad_h, self.pad_w = pad_h, pad_w
        self.train_nms_post, self.test_nms_post = train_nms_post, test_nms_post
        self.num_roi_samples = num_roi_samples
        self.compute_dtype = dtype
        self.backbone = ResNet(depth=depth, out_indices=(0, 1, 2, 3),
                               frozen_stages=1, dtype=dtype)
        self.neck = FPN((256, 512, 1024, 2048), 256, 5, "maxpool",
                        dtype=dtype)
        self.rpn_head = rpn.RPNHead(256, 256, 3, dtype=dtype)
        self.bbox_head = bh.Shared2FCBBoxHead(
            7 * 7 * 256, num_classes, dtype=torch.float32, with_selsa=False)
        self.anchor_gen = fpn_anchor_gen()
        self._anchors: Dict[tuple, List[torch.Tensor]] = {}

    def extract_feat(self, imgs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """imgs [T, H, W, 3] normalized -> 5 NHWC maps [T, h, w, 256]."""
        feats = self.neck(self.backbone(imgs.permute(0, 3, 1, 2)))
        return tuple(f.permute(0, 2, 3, 1) for f in feats)

    def anchors(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The per-level anchors [h*w*3, 4] of these NHWC maps' sizes."""
        sizes = tuple((f.shape[-3], f.shape[-2]) for f in feats)
        dev = feats[0].device
        key = (sizes, str(dev))
        if key not in self._anchors:
            self._anchors[key] = [torch.as_tensor(a, device=dev) for a in
                                  self.anchor_gen.grid_anchors(sizes)]
        return self._anchors[key]

    def rpn_forward(self, feats: Sequence[torch.Tensor]):
        """Per level (cls [T, h, w, 3], reg [T, h, w, 12])."""
        return [self.rpn_head(f) for f in feats]

    def roi_feats(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                  impl: Optional[str] = None) -> torch.Tensor:
        return multilevel_roi_align(feats[:NUM_ROI_LEVELS], rois, impl=impl)

    def bbox_forward(self, roi_feats: torch.Tensor):
        return self.bbox_head(roi_feats)


def draw_fpn_uniforms(model: FPNFasterRCNN, num_gts: int, num_anchors: int,
                      generator: torch.Generator, device=None
                      ) -> LossUniforms:
    """The samplers' uniforms: the RPN's over every anchor of every level
    [2, N], the RoI head's over the gts and the train proposals [3, G + P]
    (``core/assigners.py``)."""
    gdev = generator.device
    return LossUniforms(
        torch.rand((2, num_anchors), generator=generator,
                   device=gdev).to(device),
        torch.rand((3, num_gts + model.train_nms_post), generator=generator,
                   device=gdev).to(device))


def _proposals(model: FPNFasterRCNN, outs, anchors, img_shape, train: bool):
    return rpn.rpn_proposals(
        [c[0] for c, _ in outs], [r[0] for _, r in outs], anchors, img_shape,
        nms_pre=RPN_NMS_PRE,
        nms_post=model.train_nms_post if train else model.test_nms_post,
        iou_threshold=RPN_NMS_IOU)


def fpn_faster_rcnn_loss(model: FPNFasterRCNN, batch,
                         generator: Optional[torch.Generator] = None,
                         uniforms: Optional[LossUniforms] = None,
                         impl: Optional[str] = None):
    """Single-image training loss (``batch`` a ``DetTrainBatch``): the RPN
    loss over every level, the train proposals (no gradient), the gts and
    proposals assigned at IoU 0.5 and ``num_roi_samples`` sampled at a
    quarter positives, RoIAlign on each roi's level, softmax cross entropy
    and SmoothL1 (beta 1, stds 0.1 / 0.2) over the sample. The samplers use
    ``uniforms``, or else draw them from ``generator``. Returns (total,
    metrics)."""
    feats = model.extract_feat(batch.img[None])
    anchors = model.anchors(feats)
    outs = model.rpn_forward(feats)
    gt_boxes, gt_labels, gt_valid = (batch.gt_boxes, batch.gt_labels,
                                     batch.gt_valid)
    if uniforms is None:
        if generator is None:
            raise ValueError("pass uniforms or a generator")
        uniforms = draw_fpn_uniforms(model, gt_boxes.shape[0],
                                     sum(a.shape[0] for a in anchors),
                                     generator, anchors[0].device)
    ls = rpn.rpn_loss([c[0] for c, _ in outs], [r[0] for _, r in outs],
                      anchors, gt_boxes, gt_valid, uniforms.rpn,
                      batch.img_shape)
    with torch.no_grad():  # F6: no gradient through the proposals
        props = _proposals(model, outs, anchors, batch.img_shape, True)
    cand = torch.cat([gt_boxes, props.boxes])
    cand_valid = torch.cat([gt_valid, props.valid])
    assign = assigners.max_iou_assign(cand, gt_boxes, gt_labels, gt_valid,
                                      0.5, 0.5, 0.5, box_valid=cand_valid)
    sample = assigners.random_sample_gather(assign, uniforms.roi,
                                            model.num_roi_samples, 0.25)
    rois = cand[sample.inds]
    g = gt_boxes.shape[0]
    matched = (assign.assigned_gt_inds[sample.inds] - 1).clamp(0, g - 1)
    pos = sample.is_pos
    labels = torch.where(pos, gt_labels[matched].long(), model.num_classes)
    tgt = box_ops.bbox2delta(rois, gt_boxes[matched], stds=FPN_BBOX_STDS)
    tgt = torch.where(pos[:, None], tgt, 0.0)
    rf = model.roi_feats(feats, rois, impl=impl)
    cls_score, bbox_pred = model.bbox_forward(rf)
    valid = sample.is_valid.float()
    avg = valid.sum().clamp_min(1.0)
    loss_cls = losses.softmax_cross_entropy(cls_score.float(), labels,
                                            weight=valid, avg_factor=avg)
    pred = bbox_pred.reshape(-1, model.num_classes, 4).float()
    idx = labels.clamp(0, model.num_classes - 1)
    pred = torch.gather(pred, 1, idx[:, None, None].expand(-1, 1, 4))[:, 0]
    loss_bbox = losses.smooth_l1_loss(pred, tgt, beta=1.0,
                                      weight=pos[:, None].float(),
                                      avg_factor=avg)
    total = ls.loss_cls + ls.loss_bbox + loss_cls + loss_bbox
    return total, {"loss": total, "loss_cls": loss_cls,
                   "loss_bbox": loss_bbox, "loss_rpn_cls": ls.loss_cls,
                   "loss_rpn_bbox": ls.loss_bbox}


@torch.no_grad()
def fpn_faster_rcnn_detect(model: FPNFasterRCNN, img: torch.Tensor,
                           img_shape, scale_factor=None,
                           impl: Optional[str] = None) -> DetResult:
    """Single-image inference, img [H, W, 3] -> fixed-shape detections
    [100]: the test proposals, RoIAlign on their levels, the head, the
    decode (stds 0.1 / 0.2) divided by ``scale_factor``."""
    feats = model.extract_feat(img[None])
    anchors = model.anchors(feats)
    outs = model.rpn_forward(feats)
    props = _proposals(model, outs, anchors, img_shape, False)
    rf = model.roi_feats(feats, props.boxes, impl=impl)
    cls_score, bbox_pred = model.bbox_forward(rf)
    return bh.bbox_decode(props.boxes, cls_score, bbox_pred, img_shape,
                          roi_valid=props.valid, scale_factor=scale_factor,
                          stds=FPN_BBOX_STDS)
