"""Cascade R-CNN on the DC5 trunk, the counterpart of the JAX package's
``models/detectors/cascade_rcnn.py`` (``CascadeRCNN``, ``cascade_loss``,
``cascade_detect``; mmdet's ``cascade_rcnn.py`` and
``cascade_roi_head.py``): the Faster R-CNN backbone, neck and RPN as
``base`` (its own bbox head is never called, so it has no weights, as in
flax), then three class-agnostic Shared2FC heads ``cascade_head{0,1,2}``
with the stages' IoU thresholds (0.5, 0.6, 0.7), delta stds and loss
weights (1, 0.5, 0.25).

Training: stage 0 samples from the gts and the proposals, stages 1 and 2
from the previous stage's sampled rois refined by its deltas (no gts, no
gradient through the refined boxes), whose ``valid`` is the previous
sample's ``label_weights > 0``. Test: each stage's deltas refine the boxes
for the next, the three stages' softmaxes are averaged and the last
stage's deltas decode the detections. RoIAlign is kernel B (D for its
gradient) on CUDA tensors; proposals carry no gradient (ROADMAP F6).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ...core import boxes as box_ops, nms as nms_ops
from ..dense_heads import rpn_head as rpn
from ..roi_heads import bbox_head as bh
from ..vid.selsa import SelsaConfig, place
from .faster_rcnn import DetTrainBatch, FasterRCNN, _zeros

STAGE_IOUS = (0.5, 0.6, 0.7)
STAGE_STDS = (
    (0.1, 0.1, 0.2, 0.2),
    (0.05, 0.05, 0.1, 0.1),
    (0.033, 0.033, 0.067, 0.067),
)
STAGE_WEIGHTS = (1.0, 0.5, 0.25)
NUM_STAGES = 3


class CascadeRCNN(nn.Module):
    """``base`` (backbone, neck, RPN) and three class-agnostic heads."""

    def __init__(self, cfg: SelsaConfig = SelsaConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.base = FasterRCNN(cfg)
        del self.base.bbox_head
        for i in range(NUM_STAGES):
            self.add_module(f"cascade_head{i}", bh.Shared2FCBBoxHead(
                7 * 7 * c.neck_channels, c.num_classes, dtype=torch.float32,
                with_selsa=False, reg_class_agnostic=True))

    def stage_forward(self, stage: int, roi_feats: torch.Tensor):
        return getattr(self, f"cascade_head{stage}")(roi_feats)


class CascadeUniforms(NamedTuple):
    """The RPN sampler's [2, A] and each stage's RoI sampler's uniforms:
    [3, G + train_nms_post] for stage 0, [3, num_roi_samples] after."""

    rpn: torch.Tensor
    stages: tuple


def draw_cascade_uniforms(cfg: SelsaConfig, num_gts: int, num_anchors: int,
                          generator: torch.Generator, device=None
                          ) -> CascadeUniforms:
    gdev = generator.device

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=gdev).to(device)

    return CascadeUniforms(
        rand(2, num_anchors),
        (rand(3, num_gts + cfg.train_nms_post),
         rand(3, cfg.num_roi_samples), rand(3, cfg.num_roi_samples)))


def cascade_loss(model: CascadeRCNN, batch: DetTrainBatch,
                 anchors: torch.Tensor, uniforms: CascadeUniforms,
                 impl: Optional[str] = None):
    """The RPN loss and the three stages' weighted losses (metrics
    ``s{i}.loss_cls`` / ``s{i}.loss_bbox`` unweighted, as in JAX).
    Returns (total, metrics)."""
    cfg, base = model.cfg, model.base
    feat = base.extract_feat(batch.img[None])
    cls, reg = base.rpn_forward(feat)
    ls = rpn.rpn_loss(cls[0], reg[0], anchors, batch.gt_boxes,
                      batch.gt_valid, uniforms.rpn, batch.img_shape)
    with torch.no_grad():  # F6
        props = rpn.rpn_proposals(
            cls[0], reg[0], anchors, batch.img_shape,
            nms_pre=cfg.train_nms_pre, nms_post=cfg.train_nms_post,
            iou_threshold=cfg.rpn_nms_iou)
    total = ls.loss_cls + ls.loss_bbox
    metrics = {"loss_rpn_cls": ls.loss_cls, "loss_rpn_bbox": ls.loss_bbox}
    boxes, valid = props.boxes, props.valid
    for st in range(NUM_STAGES):
        tgts = bh.bbox_targets(
            boxes, valid, batch.gt_boxes, batch.gt_labels, batch.gt_valid,
            uniforms.stages[st], num_classes=cfg.num_classes,
            num_samples=cfg.num_roi_samples, pos_iou_thr=STAGE_IOUS[st],
            neg_iou_thr=STAGE_IOUS[st], min_pos_iou=STAGE_IOUS[st],
            stds=STAGE_STDS[st], add_gt_as_proposals=st == 0)
        rf = base.roi_feats(feat, tgts.rois, _zeros(tgts.rois), impl=impl)
        cls_score, bbox_pred = model.stage_forward(st, rf)
        sl = bh.bbox_loss(cls_score, bbox_pred, tgts,
                          num_classes=cfg.num_classes,
                          reg_class_agnostic=True)
        total = total + STAGE_WEIGHTS[st] * (sl.loss_cls + sl.loss_bbox)
        metrics[f"s{st}.loss_cls"] = sl.loss_cls
        metrics[f"s{st}.loss_bbox"] = sl.loss_bbox
        with torch.no_grad():  # the next stage's candidates
            boxes = box_ops.delta2bbox(tgts.rois, bbox_pred.float(),
                                       stds=STAGE_STDS[st],
                                       max_shape=batch.img_shape)
        valid = tgts.label_weights > 0
    metrics["loss"] = total
    return total, metrics


@torch.no_grad()
def cascade_detect(model: CascadeRCNN, img: torch.Tensor, img_shape,
                   anchors: torch.Tensor, scale_factor=None,
                   impl: Optional[str] = None) -> nms_ops.DetResult:
    """Proposals, the three stages (each refining the boxes of the next),
    the averaged softmax, the last stage's decode and multiclass NMS."""
    cfg, base = model.cfg, model.base
    feat = base.extract_feat(img[None])
    cls, reg = base.rpn_forward(feat)
    props = rpn.rpn_proposals(cls[0], reg[0], anchors, img_shape,
                              nms_pre=cfg.test_nms_pre,
                              nms_post=cfg.test_nms_post,
                              iou_threshold=cfg.rpn_nms_iou)
    boxes = props.boxes
    scores = 0.0
    for st in range(NUM_STAGES):
        rf = base.roi_feats(feat, boxes, _zeros(boxes), impl=impl)
        cls_score, bbox_pred = model.stage_forward(st, rf)
        scores = scores + torch.softmax(cls_score.float(), dim=-1)
        if st < NUM_STAGES - 1:
            boxes = box_ops.delta2bbox(boxes, bbox_pred.float(),
                                       stds=STAGE_STDS[st],
                                       max_shape=img_shape)
    decoded = box_ops.delta2bbox(boxes, bbox_pred.float(),
                                 stds=STAGE_STDS[-1], max_shape=img_shape)
    if scale_factor is not None:
        decoded = decoded / torch.as_tensor(scale_factor, dtype=decoded.dtype,
                                            device=decoded.device)
    return nms_ops.multiclass_nms(decoded, scores / 3.0, 1e-4, 0.5, 100,
                                  box_valid=props.valid)


def make_cascade_rcnn(cfg: Optional[SelsaConfig] = None,
                      generator: Optional[torch.Generator] = None,
                      device=None):
    cfg = cfg or SelsaConfig()
    return place(CascadeRCNN(cfg), cfg, generator, device)
