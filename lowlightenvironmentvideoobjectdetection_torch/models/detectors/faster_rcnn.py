"""Faster R-CNN, the DC5 two-stage detector that FGFA and DFF build on, the
counterpart of the JAX package's ``models/detectors/faster_rcnn.py``
(``FasterRCNN``, ``DetTrainBatch``, ``faster_rcnn_loss``,
``faster_rcnn_detect``, ``make_faster_rcnn``): ResNet (DC5 strides and
dilations) -> ChannelMapper -> RPN -> 7x7 RoIAlign on the float32 map
(kernel B on CUDA tensors, kernel D for its gradient) -> the Shared2FC head
without SELSA, in float32.

``rcnn_loss`` and ``rcnn_detect`` run the two stages on a given map, so
FGFA and DFF train and detect on their aggregated or warped maps with the
same code. Proposals carry no gradient, as in the original (ROADMAP fault
F6: the JAX losses differentiate through them).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ...core.nms import DetResult
from ...ops.roi_align import roi_align
from ..backbones.resnet import ResNet
from ..dense_heads import rpn_head as rpn
from ..necks.channel_mapper import ChannelMapper
from ..roi_heads import bbox_head as bh
from ..vid.selsa import LossUniforms, SelsaConfig, loss_uniforms, place


class FasterRCNN(nn.Module):
    """Backbone, neck, RPN and the bbox head without SELSA; ``cfg`` takes
    ``SelsaConfig``'s shape and proposal fields, as in JAX (the head has 2
    shared FCs and computes in float32 whatever the config says)."""

    def __init__(self, cfg: SelsaConfig = SelsaConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.backbone = ResNet(
            depth=c.depth, in_channels=c.backbone_in_channels,
            strides=(1, 2, 2, 1), dilations=(1, 1, 1, 2),
            out_indices=c.out_indices, frozen_stages=c.frozen_stages,
            dtype=c.compute_dtype)
        self.neck = ChannelMapper(256 * 2 ** c.out_indices[-1],
                                  c.neck_channels, 3, dtype=c.compute_dtype)
        self.rpn_head = rpn.RPNHead(c.neck_channels, c.neck_channels,
                                    c.num_base_anchors, dtype=c.compute_dtype)
        self.bbox_head = bh.Shared2FCBBoxHead(
            7 * 7 * c.neck_channels, c.num_classes, dtype=torch.float32,
            with_selsa=False)

    def extract_feat(self, imgs: torch.Tensor) -> torch.Tensor:
        """imgs [T, H, W, 3] normalized -> neck feature [T, h, w, C]."""
        stages = self.backbone(imgs.permute(0, 3, 1, 2))
        return self.neck(stages[-1]).permute(0, 2, 3, 1).contiguous()

    def rpn_forward(self, neck_feat: torch.Tensor):
        """[T, h, w, C] -> (cls [T, h, w, A], reg [T, h, w, 4A])."""
        return self.rpn_head(neck_feat)

    def roi_feats(self, neck_feat: torch.Tensor, rois: torch.Tensor,
                  batch_inds: Optional[torch.Tensor] = None,
                  impl: Optional[str] = None) -> torch.Tensor:
        """7x7 RoIAlign (aligned, sampling ratio 2) at the model stride on
        the float32 map(s) [h, w, C] or [S, h, w, C], made contiguous for
        kernel B (a warped map comes out of ``F.grid_sample`` strided)."""
        return roi_align(neck_feat.float().contiguous(), rois.float(),
                         1.0 / self.cfg.stride, batch_inds=batch_inds,
                         out_size=7, sampling_ratio=2, impl=impl)

    def bbox_forward(self, roi_feats: torch.Tensor):
        """[N, 7, 7, C] -> (cls_score [N, C+1], bbox_pred [N, 4C])."""
        return self.bbox_head(roi_feats)


class DetTrainBatch(NamedTuple):
    """One image training sample."""

    img: torch.Tensor  # [H, W, 3] normalized, padded
    img_shape: torch.Tensor  # [2] (h, w) of the unpadded content
    gt_boxes: torch.Tensor  # [G, 4] (padded)
    gt_labels: torch.Tensor  # [G] int64
    gt_valid: torch.Tensor  # [G] bool


def rcnn_loss(detector: FasterRCNN, feat: torch.Tensor, batch,
              anchors: torch.Tensor, uniforms: LossUniforms,
              impl: Optional[str] = None):
    """The two stages' training losses on one map feat [1, h, w, C]: the
    RPN loss, proposals in the train window (no gradient), sampled RoI
    targets, RoIAlign and the head's loss. ``batch`` gives ``img_shape``
    and the gts. Returns (total, metrics)."""
    cfg = detector.cfg
    cls, reg = detector.rpn_forward(feat)
    rpn_losses = rpn.rpn_loss(cls[0], reg[0], anchors, batch.gt_boxes,
                              batch.gt_valid, uniforms.rpn, batch.img_shape)
    with torch.no_grad():  # F6: no gradient through the proposals
        props = rpn.rpn_proposals(
            cls[0], reg[0], anchors, batch.img_shape,
            nms_pre=cfg.train_nms_pre, nms_post=cfg.train_nms_post,
            iou_threshold=cfg.rpn_nms_iou)
    tgts = bh.bbox_targets(props.boxes, props.valid, batch.gt_boxes,
                           batch.gt_labels, batch.gt_valid, uniforms.roi,
                           num_classes=cfg.num_classes,
                           num_samples=cfg.num_roi_samples)
    rf = detector.roi_feats(feat, tgts.rois, _zeros(tgts.rois), impl=impl)
    cls_score, bbox_pred = detector.bbox_forward(rf)
    roi_losses = bh.bbox_loss(cls_score, bbox_pred, tgts,
                              num_classes=cfg.num_classes)
    total = (rpn_losses.loss_cls + rpn_losses.loss_bbox
             + roi_losses.loss_cls + roi_losses.loss_bbox)
    return total, {
        "loss": total,
        "loss_rpn_cls": rpn_losses.loss_cls,
        "loss_rpn_bbox": rpn_losses.loss_bbox,
        "loss_cls": roi_losses.loss_cls,
        "loss_bbox": roi_losses.loss_bbox,
        "acc": roi_losses.acc,
    }


def _zeros(rois: torch.Tensor) -> torch.Tensor:
    return torch.zeros(rois.shape[0], dtype=torch.int64, device=rois.device)


@torch.no_grad()
def rcnn_detect(detector: FasterRCNN, feat: torch.Tensor, img_shape,
                scale_factor, anchors: torch.Tensor,
                impl: Optional[str] = None) -> DetResult:
    """Fixed-shape detections [100] from one map feat [1, h, w, C]:
    proposals in the test window, RoIAlign, the head, the decode with
    ``scale_factor`` [4] (or None)."""
    cfg = detector.cfg
    cls, reg = detector.rpn_forward(feat)
    props = rpn.rpn_proposals(cls[0], reg[0], anchors, img_shape,
                              nms_pre=cfg.test_nms_pre,
                              nms_post=cfg.test_nms_post,
                              iou_threshold=cfg.rpn_nms_iou)
    rf = detector.roi_feats(feat, props.boxes, _zeros(props.boxes), impl=impl)
    cls_score, bbox_pred = detector.bbox_forward(rf)
    return bh.bbox_decode(props.boxes, cls_score, bbox_pred, img_shape,
                          roi_valid=props.valid, scale_factor=scale_factor)


def faster_rcnn_loss(model: FasterRCNN, batch: DetTrainBatch,
                     anchors: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     uniforms: Optional[LossUniforms] = None,
                     impl: Optional[str] = None):
    """Single-image two-stage training loss (mmdet's two-stage
    forward_train); the samplers use ``uniforms``, or else draw them from
    ``generator``. Returns (total, metrics)."""
    uniforms = loss_uniforms(model.cfg, batch.gt_boxes.shape[0], anchors,
                             generator, uniforms)
    return rcnn_loss(model, model.extract_feat(batch.img[None]), batch,
                     anchors, uniforms, impl=impl)


@torch.no_grad()
def faster_rcnn_detect(model: FasterRCNN, img: torch.Tensor, img_shape,
                       anchors: torch.Tensor, scale_factor=None,
                       impl: Optional[str] = None) -> DetResult:
    """Single-image inference, img [H, W, 3] -> fixed-shape detections."""
    return rcnn_detect(model, model.extract_feat(img[None]), img_shape,
                       scale_factor, anchors, impl=impl)


def make_faster_rcnn(cfg: Optional[SelsaConfig] = None,
                     generator: Optional[torch.Generator] = None,
                     device=None):
    """(model, anchors): ``FasterRCNN`` placed as ``selsa.place`` says."""
    cfg = cfg or SelsaConfig()
    return place(FasterRCNN(cfg), cfg, generator, device)
