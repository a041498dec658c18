"""Mask R-CNN on the DC5 trunk, the counterpart of the JAX package's
``models/detectors/mask_rcnn.py`` (``MaskRCNN``, ``MaskTrainBatch``,
``mask_rcnn_loss``, ``mask_rcnn_detect``, ``make_mask_rcnn``; mmdet's
``mask_rcnn.py`` and the standard RoI head's mask branch): Faster R-CNN as
``base``, and a 14x14 RoIAlign of the float32 map (kernel B's
``gather14x2`` on CUDA tensors, D's ``scatter14x2`` for its gradient)
feeding ``FCNMaskHead``.

Training runs the box branch as Faster R-CNN does, then the mask branch on
the same sampled rois: their matched gts (``max_iou_assign`` at 0.5, as
JAX recomputes them), the 28x28 targets (B's ``gather28x2``) and the BCE
on the positives' class channel. The rois carry no gradient (ROADMAP F6).
The test path predicts a mask for each of the 100 detections (their
boxes, which ``scale_factor`` has divided, on the map of the padded image,
as JAX does: ROADMAP F34) and pastes its class channel at the bucket's
size.

``mask_rcnn_parts`` is the training forward that Mask Scoring R-CNN and
PointRend extend; ``mask_rcnn_boxes`` the test path up to the mask logits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ...core import assigners
from ...ops.roi_align import roi_align
from ..dense_heads import rpn_head as rpn
from ..roi_heads import bbox_head as bh
from ..roi_heads.mask_head import (ROI_SIZE, FCNMaskHead, class_channel,
                                   mask_loss, mask_targets, paste_masks)
from ..vid.selsa import LossUniforms, SelsaConfig, place
from .faster_rcnn import FasterRCNN, _zeros


class MaskRCNN(nn.Module):
    """``base`` (Faster R-CNN) and ``mask_head``."""

    def __init__(self, cfg: SelsaConfig = SelsaConfig()):
        super().__init__()
        self.cfg = cfg
        self.base = FasterRCNN(cfg)
        self.mask_head = FCNMaskHead(cfg.neck_channels, cfg.num_classes)

    def mask_roi_feats(self, feat: torch.Tensor, rois: torch.Tensor,
                       impl: Optional[str] = None) -> torch.Tensor:
        """14x14 RoIAlign (kernel B's ``gather14x2`` on CUDA) on the f32 map
        [1, h, w, C]."""
        return roi_align(feat.float().contiguous(), rois.float(),
                         1.0 / self.cfg.stride, batch_inds=_zeros(rois),
                         out_size=ROI_SIZE, sampling_ratio=2, impl=impl)

    def mask_forward(self, mask_feats: torch.Tensor) -> torch.Tensor:
        return self.mask_head(mask_feats)


class MaskTrainBatch(NamedTuple):
    img: torch.Tensor  # [H, W, 3]
    img_shape: torch.Tensor  # [2]
    gt_boxes: torch.Tensor  # [G, 4]
    gt_labels: torch.Tensor  # [G] int64
    gt_valid: torch.Tensor  # [G] bool
    gt_masks: torch.Tensor  # [G, H, W] binary


def box_masks(batch, hw) -> torch.Tensor:
    """Box-filled instance masks [G, h, w] of a batch's gts, for data
    without masks (the JAX families' ``_box_masks``)."""
    h, w = hw
    dev = batch.gt_boxes.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    b = batch.gt_boxes.float()[:, :, None, None]
    return ((yy >= b[:, 1]) & (yy < b[:, 3]) & (xx >= b[:, 0])
            & (xx < b[:, 2])).float()


def as_mask_batch(batch) -> MaskTrainBatch:
    """A ``DetTrainBatch`` with box-filled masks (or its own ``gt_masks``)."""
    masks = getattr(batch, "gt_masks", None)
    if masks is None:
        masks = box_masks(batch, batch.img.shape[:2])
    return MaskTrainBatch(batch.img, batch.img_shape, batch.gt_boxes,
                          batch.gt_labels, batch.gt_valid, masks)


def matched_gts(rois: torch.Tensor, batch) -> torch.Tensor:
    """Each sampled roi's matched gt (``max_iou_assign`` at 0.5, clipped to
    a gt index), as the JAX losses recompute it."""
    assign = assigners.max_iou_assign(
        rois, batch.gt_boxes, batch.gt_labels, batch.gt_valid,
        pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5)
    return (assign.assigned_gt_inds - 1).clamp(0, batch.gt_boxes.shape[0] - 1)


class MaskParts(NamedTuple):
    """What the Mask R-CNN training forward leaves for its extensions."""

    total: torch.Tensor
    metrics: dict
    feat: torch.Tensor  # [1, h, w, C]
    tgts: bh.BBoxTargets
    mask_feats: torch.Tensor  # [N, 14, 14, C] f32
    mask_logits: torch.Tensor  # [N, 28, 28, num_classes]
    matched: torch.Tensor  # [N]
    mask_tgts: torch.Tensor  # [N, 28, 28]


def mask_rcnn_parts(model: MaskRCNN, batch: MaskTrainBatch,
                    anchors: torch.Tensor, uniforms: LossUniforms,
                    impl: Optional[str] = None) -> MaskParts:
    """The RPN, box and mask losses of one image and what they computed."""
    cfg, base = model.cfg, model.base
    feat = base.extract_feat(batch.img[None])
    cls, reg = base.rpn_forward(feat)
    rpn_losses = rpn.rpn_loss(cls[0], reg[0], anchors, batch.gt_boxes,
                              batch.gt_valid, uniforms.rpn, batch.img_shape)
    with torch.no_grad():  # F6
        props = rpn.rpn_proposals(
            cls[0], reg[0], anchors, batch.img_shape,
            nms_pre=cfg.train_nms_pre, nms_post=cfg.train_nms_post,
            iou_threshold=cfg.rpn_nms_iou)
    tgts = bh.bbox_targets(props.boxes, props.valid, batch.gt_boxes,
                           batch.gt_labels, batch.gt_valid, uniforms.roi,
                           num_classes=cfg.num_classes,
                           num_samples=cfg.num_roi_samples)
    rf = base.roi_feats(feat, tgts.rois, _zeros(tgts.rois), impl=impl)
    roi_losses = bh.bbox_loss(*base.bbox_forward(rf), tgts,
                              num_classes=cfg.num_classes)
    mf = model.mask_roi_feats(feat, tgts.rois, impl=impl)
    mask_logits = model.mask_forward(mf)
    matched = matched_gts(tgts.rois, batch)
    m_tgt = mask_targets(batch.gt_masks, matched, tgts.rois,
                         mask_size=mask_logits.shape[1], impl=impl)
    loss_mask = mask_loss(mask_logits, m_tgt, tgts.labels, tgts.is_pos)
    total = (rpn_losses.loss_cls + rpn_losses.loss_bbox
             + roi_losses.loss_cls + roi_losses.loss_bbox + loss_mask)
    metrics = {
        "loss": total, "loss_rpn_cls": rpn_losses.loss_cls,
        "loss_rpn_bbox": rpn_losses.loss_bbox,
        "loss_cls": roi_losses.loss_cls, "loss_bbox": roi_losses.loss_bbox,
        "loss_mask": loss_mask, "acc": roi_losses.acc}
    return MaskParts(total, metrics, feat, tgts, mf, mask_logits, matched,
                     m_tgt)


def mask_rcnn_loss(model: MaskRCNN, batch: MaskTrainBatch,
                   anchors: torch.Tensor, uniforms: LossUniforms,
                   impl: Optional[str] = None):
    """Faster R-CNN's losses and the mask BCE: (total, metrics)."""
    parts = mask_rcnn_parts(model, batch, anchors, uniforms, impl)
    return parts.total, parts.metrics


@torch.no_grad()
def mask_rcnn_boxes(model: MaskRCNN, img: torch.Tensor, img_shape,
                    anchors: torch.Tensor, scale_factor=None,
                    impl: Optional[str] = None):
    """The test path up to the masks: (detections [100], the map [1, h, w,
    C], the detections' 14x14 features, their mask logits)."""
    cfg, base = model.cfg, model.base
    feat = base.extract_feat(img[None])
    cls, reg = base.rpn_forward(feat)
    props = rpn.rpn_proposals(cls[0], reg[0], anchors, img_shape,
                              nms_pre=cfg.test_nms_pre,
                              nms_post=cfg.test_nms_post,
                              iou_threshold=cfg.rpn_nms_iou)
    rf = base.roi_feats(feat, props.boxes, _zeros(props.boxes), impl=impl)
    cls_score, bbox_pred = base.bbox_forward(rf)
    sf = None if scale_factor is None else torch.as_tensor(
        scale_factor, dtype=torch.float32, device=img.device)
    dets = bh.bbox_decode(props.boxes, cls_score, bbox_pred, img_shape,
                          roi_valid=props.valid, scale_factor=sf)
    mf = model.mask_roi_feats(feat, dets.boxes, impl=impl)
    return dets, feat, mf, model.mask_forward(mf)


@torch.no_grad()
def mask_rcnn_detect(model: MaskRCNN, img: torch.Tensor, img_shape,
                     anchors: torch.Tensor, scale_factor=None,
                     impl: Optional[str] = None):
    """(detections [100], masks [100, H, W] bool at the bucket's size)."""
    dets, _, _, logits = mask_rcnn_boxes(model, img, img_shape, anchors,
                                         scale_factor, impl)
    probs = torch.sigmoid(class_channel(logits, dets.labels))
    return dets, paste_masks(probs, dets.boxes, model.cfg.pad_h,
                             model.cfg.pad_w)


def make_mask_rcnn(cfg: Optional[SelsaConfig] = None,
                   generator: Optional[torch.Generator] = None, device=None):
    cfg = cfg or SelsaConfig(num_classes=80)
    return place(MaskRCNN(cfg), cfg, generator, device)
