"""Fast R-CNN and the standalone RPN, the counterparts of the JAX package's
``models/detectors/more_rcnn.py`` ``FastRCNN`` / ``FastRCNNBatch`` /
``fast_rcnn_loss`` / ``fast_rcnn_detect`` and ``RPN`` / ``rpn_only_loss``
/ ``rpn_propose`` (mmdet's ``fast_rcnn.py`` and ``rpn.py``). Both wrap the
DC5 ``FasterRCNN`` as ``base``, as the flax modules do, so the weights
bridge by name; the part a module never calls is removed, as flax makes no
variables for it. Fast R-CNN takes its proposals from outside (no RPN
runs); the RPN trains on its RPN loss alone and gives scored
class-agnostic proposals.

The other families of the JAX module (Mask Scoring R-CNN, PointRend,
Trident, Grid R-CNN) are not ported (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ...core.nms import DetResult
from ..dense_heads import rpn_head as rpn
from ..roi_heads import bbox_head as bh
from ..vid.selsa import SelsaConfig
from .faster_rcnn import DetTrainBatch, FasterRCNN, _zeros


class FastRCNN(nn.Module):
    """Backbone, neck and bbox head of ``base`` (no RPN head)."""

    def __init__(self, cfg: SelsaConfig = SelsaConfig()):
        super().__init__()
        self.cfg = cfg
        self.base = FasterRCNN(cfg)
        del self.base.rpn_head


class FastRCNNBatch(NamedTuple):
    img: torch.Tensor  # [H, W, 3]
    img_shape: torch.Tensor  # [2]
    proposals: torch.Tensor  # [P, 4] precomputed
    proposals_valid: torch.Tensor  # [P] bool
    gt_boxes: torch.Tensor
    gt_labels: torch.Tensor
    gt_valid: torch.Tensor


def fast_rcnn_loss(model: FastRCNN, batch: FastRCNNBatch,
                   uniforms: torch.Tensor, impl: Optional[str] = None):
    """The RoI head's loss over sampled gts and proposals (``uniforms``
    [3, G + P], ``bh.bbox_targets``). Returns (total, metrics)."""
    cfg, base = model.cfg, model.base
    neck = base.extract_feat(batch.img[None])
    tgts = bh.bbox_targets(batch.proposals, batch.proposals_valid,
                           batch.gt_boxes, batch.gt_labels, batch.gt_valid,
                           uniforms, num_classes=cfg.num_classes,
                           num_samples=cfg.num_roi_samples)
    rf = base.roi_feats(neck, tgts.rois, _zeros(tgts.rois), impl=impl)
    cls_score, bbox_pred = base.bbox_forward(rf)
    roi = bh.bbox_loss(cls_score, bbox_pred, tgts,
                       num_classes=cfg.num_classes)
    total = roi.loss_cls + roi.loss_bbox
    return total, {"loss": total, "loss_cls": roi.loss_cls,
                   "loss_bbox": roi.loss_bbox, "acc": roi.acc}


@torch.no_grad()
def fast_rcnn_detect(model: FastRCNN, img: torch.Tensor, img_shape,
                     proposals: torch.Tensor, proposals_valid: torch.Tensor,
                     scale_factor=None, impl: Optional[str] = None
                     ) -> DetResult:
    base = model.base
    neck = base.extract_feat(img[None])
    rf = base.roi_feats(neck, proposals, _zeros(proposals), impl=impl)
    cls_score, bbox_pred = base.bbox_forward(rf)
    return bh.bbox_decode(proposals, cls_score, bbox_pred, img_shape,
                          roi_valid=proposals_valid,
                          scale_factor=scale_factor)


class RPN(nn.Module):
    """Backbone, neck and RPN head of ``base`` (no bbox head)."""

    def __init__(self, cfg: SelsaConfig = SelsaConfig()):
        super().__init__()
        self.cfg = cfg
        self.base = FasterRCNN(cfg)
        del self.base.bbox_head


def rpn_only_loss(model: RPN, batch: DetTrainBatch, anchors: torch.Tensor,
                  uniforms: torch.Tensor):
    """The RPN loss alone (``uniforms`` [2, anchors])."""
    base = model.base
    cls, reg = base.rpn_forward(base.extract_feat(batch.img[None]))
    ls = rpn.rpn_loss(cls[0], reg[0], anchors, batch.gt_boxes,
                      batch.gt_valid, uniforms, batch.img_shape)
    total = ls.loss_cls + ls.loss_bbox
    return total, {"loss": total, "loss_rpn_cls": ls.loss_cls,
                   "loss_rpn_bbox": ls.loss_bbox}


@torch.no_grad()
def rpn_propose(model: RPN, img: torch.Tensor, img_shape,
                anchors: torch.Tensor) -> rpn.Proposals:
    """The test proposals of one image."""
    cfg, base = model.cfg, model.base
    cls, reg = base.rpn_forward(base.extract_feat(img[None]))
    return rpn.rpn_proposals(cls[0], reg[0], anchors, img_shape,
                             nms_pre=cfg.test_nms_pre,
                             nms_post=cfg.test_nms_post,
                             iou_threshold=cfg.rpn_nms_iou)
