"""Hybrid Task Cascade and SCNet on the DC5 trunk, the counterpart of the JAX
package's ``models/detectors/htc.py`` (``SemanticHead``, ``HTC``,
``_semantic_target``, ``htc_loss``, ``htc_detect``, ``SCNet``,
``make_htc``; mmdet's ``htc.py`` / ``htc_roi_head.py`` and ``scnet.py``).

``base`` is Faster R-CNN's backbone, neck and RPN (its bbox head is never
called, so it has no weights, as in flax). Three class-agnostic Shared2FC
heads ``cascade_head{i}`` take Cascade R-CNN's stage IoUs, stds and
weights; three ``FCNMaskHead``s ``mask_head{i}`` run on the same sampled
rois, stage i > 0 adding ReLU(``mask_info_conv{i-1}``) of the previous
stage's mask *input* (JAX's ``mask_forward`` returns its input, not the
head's last conv features as mmdet: ROADMAP F33), detached after each
stage. The semantic branch (``semantic_head``: 2 convs of 256 and 1x1
logits over C + 1 classes on the neck map, f32 as flax promotes it) fuses
into every roi feature: RoIAlign of its features (kernel B at 7x7 for the
box heads, 14x14 for the mask heads) through ``semantic_roi_conv``. Its
loss (weight 0.2) is the cross entropy against the instance masks' label
map (later instances over earlier ones) resized to the map by JAX's
nearest rule. SCNet is HTC with a global context: ``gc_fc`` of the map's
mean added to every roi feature (JAX has none of mmdet's SCNet heads:
ROADMAP F37).

Test: the cascade as Cascade R-CNN's (the three softmaxes averaged, the
last stage's deltas decoding), then on the 100 detections (divided by
``scale_factor``, on the padded image's map: F34) one 14x14 pass and the
three mask heads with the information flow, their sigmoids averaged:
(detections, probabilities [100, 28, 28, C]), not pasted, as in JAX.
RoIAlign is kernel B (D for its gradient); the rois carry no gradient
(ROADMAP F6).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import boxes as box_ops, nms as nms_ops
from ...ops.roi_align import roi_align
from ...ops.scale_translate import resize_nearest
from ..aggregators.selsa_aggregator import Linear
from ..backbones.resnet import Conv2d
from ..dense_heads import rpn_head as rpn
from ..roi_heads import bbox_head as bh
from ..roi_heads.mask_head import (ROI_SIZE, FCNMaskHead, mask_loss,
                                   mask_targets)
from ..vid.selsa import SelsaConfig, place
from .cascade_rcnn import (NUM_STAGES, STAGE_IOUS, STAGE_STDS, STAGE_WEIGHTS,
                           CascadeUniforms)
from .faster_rcnn import FasterRCNN, _zeros
from .mask_rcnn import MaskTrainBatch, matched_gts

SEMANTIC_WEIGHT = 0.2


class SemanticHead(nn.Module):
    """flax ``conv0``, ``conv1`` (3x3, 256), ``seg`` (1x1, C + 1)."""

    def __init__(self, in_channels: int, num_classes: int = 80):
        super().__init__()
        self.conv0 = Conv2d(in_channels, 256, 3, padding=1)
        self.conv1 = Conv2d(256, 256, 3, padding=1)
        self.seg = Conv2d(256, num_classes + 1, 1)

    def forward(self, feat: torch.Tensor):
        """The map [1, h, w, C] -> (logits [h, w, C + 1], features [h, w,
        256]), f32."""
        x = feat.float().permute(0, 3, 1, 2)
        x = F.relu(self.conv1(F.relu(self.conv0(x))))
        return (self.seg(x)[0].permute(1, 2, 0),
                x[0].permute(1, 2, 0).contiguous())


class HTC(nn.Module):
    def __init__(self, cfg: SelsaConfig = SelsaConfig(),
                 with_global_context: bool = False):
        super().__init__()
        self.cfg = c = cfg
        self.with_global_context = with_global_context
        self.base = FasterRCNN(cfg)
        del self.base.bbox_head
        for i in range(NUM_STAGES):
            self.add_module(f"cascade_head{i}", bh.Shared2FCBBoxHead(
                7 * 7 * c.neck_channels, c.num_classes, dtype=torch.float32,
                with_selsa=False, reg_class_agnostic=True))
            self.add_module(f"mask_head{i}",
                            FCNMaskHead(c.neck_channels, c.num_classes))
        for i in range(NUM_STAGES - 1):
            self.add_module(f"mask_info_conv{i}", Conv2d(
                c.neck_channels, c.neck_channels, 3, padding=1))
        self.semantic_head = SemanticHead(c.neck_channels, c.num_classes)
        self.semantic_roi_conv = Conv2d(256, c.neck_channels, 1)
        if with_global_context:
            self.gc_fc = Linear(c.neck_channels, c.neck_channels)

    def _fuse(self, rf, feat, sem_feat, rois, impl):
        """Semantic roi features and the global context added to ``rf``
        [N, s, s, C]."""
        sem_rf = roi_align(sem_feat, rois.float(), 1.0 / self.cfg.stride,
                           batch_inds=_zeros(rois), out_size=rf.shape[1],
                           sampling_ratio=2, impl=impl)
        rf = rf + self.semantic_roi_conv(
            sem_rf.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.with_global_context:
            gc = feat[0].float().mean((0, 1))
            rf = rf + self.gc_fc(gc)
        return rf

    def roi_feats(self, feat, sem_feat, rois, impl=None):
        """7x7 box features of the f32 map [1, h, w, C], fused."""
        rf = self.base.roi_feats(feat, rois, _zeros(rois), impl=impl)
        return self._fuse(rf, feat, sem_feat, rois, impl)

    def mask_roi_feats(self, feat, sem_feat, rois, impl=None):
        """14x14 mask features, fused."""
        rf = roi_align(feat.float().contiguous(), rois.float(),
                       1.0 / self.cfg.stride, batch_inds=_zeros(rois),
                       out_size=ROI_SIZE, sampling_ratio=2, impl=impl)
        return self._fuse(rf, feat, sem_feat, rois, impl)

    def stage_forward(self, stage: int, rf):
        return getattr(self, f"cascade_head{stage}")(rf)

    def mask_forward(self, stage: int, mask_rf, prev_feat=None):
        """(stage's mask logits, its input: the next stage's
        ``prev_feat``)."""
        x = mask_rf
        if prev_feat is not None:
            conv = getattr(self, f"mask_info_conv{stage - 1}")
            x = x + F.relu(conv(prev_feat.permute(0, 3, 1, 2))).permute(
                0, 2, 3, 1)
        return getattr(self, f"mask_head{stage}")(x), x


class SCNet(HTC):
    """HTC with the global-context branch (``with_global_context``)."""

    def __init__(self, cfg: SelsaConfig = SelsaConfig()):
        super().__init__(cfg, with_global_context=True)


def semantic_target(gt_masks, gt_labels, gt_valid, hw) -> torch.Tensor:
    """The label map (label + 1, 0 background; a later instance over an
    earlier one) of [G, H, W] masks, resized to ``hw`` by JAX's nearest
    rule -> [h, w] int64."""
    tgt = torch.zeros(gt_masks.shape[1:], dtype=torch.int64,
                      device=gt_masks.device)
    lab = torch.where(gt_valid, gt_labels + 1, torch.zeros_like(gt_labels))
    for i in range(gt_masks.shape[0]):
        tgt = torch.where(gt_valid[i] & (gt_masks[i] > 0.5), lab[i], tgt)
    return resize_nearest(tgt, (0, 1), hw)


def htc_loss(model: HTC, batch: MaskTrainBatch, anchors: torch.Tensor,
             uniforms: CascadeUniforms, impl: Optional[str] = None):
    """The RPN loss, 0.2 x the semantic loss and the three stages' weighted
    box and mask losses (metrics ``s{i}.loss_cls`` / ``s{i}.loss_mask``
    unweighted, as in JAX). ``uniforms`` as Cascade R-CNN's: the RPN's and
    each stage's sampler's (the JAX keys ``split(rng, 5)[0:4]``). Returns
    (total, metrics)."""
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
    sem_logits, sem_feat = model.semantic_head(feat)
    sem_tgt = semantic_target(batch.gt_masks, batch.gt_labels,
                              batch.gt_valid, sem_logits.shape[:2])
    logp = torch.log_softmax(sem_logits, -1)
    loss_sem = -torch.gather(logp, 2, sem_tgt[..., None]).mean()
    total = total + SEMANTIC_WEIGHT * loss_sem
    metrics["loss_semantic"] = loss_sem
    boxes, valid = props.boxes, props.valid
    prev = None
    for st in range(NUM_STAGES):
        tgts = bh.bbox_targets(
            boxes, valid, batch.gt_boxes, batch.gt_labels, batch.gt_valid,
            uniforms.stages[st], num_classes=cfg.num_classes,
            num_samples=cfg.num_roi_samples, pos_iou_thr=STAGE_IOUS[st],
            neg_iou_thr=STAGE_IOUS[st], min_pos_iou=STAGE_IOUS[st],
            stds=STAGE_STDS[st], add_gt_as_proposals=st == 0)
        rf = model.roi_feats(feat, sem_feat, tgts.rois, impl)
        cls_score, bbox_pred = model.stage_forward(st, rf)
        sl = bh.bbox_loss(cls_score, bbox_pred, tgts,
                          num_classes=cfg.num_classes,
                          reg_class_agnostic=True)
        w = STAGE_WEIGHTS[st]
        total = total + w * (sl.loss_cls + sl.loss_bbox)
        metrics[f"s{st}.loss_cls"] = sl.loss_cls
        mrf = model.mask_roi_feats(feat, sem_feat, tgts.rois, impl)
        mlogits, prev = model.mask_forward(st, mrf, prev)
        m_tgt = mask_targets(batch.gt_masks, matched_gts(tgts.rois, batch),
                             tgts.rois, mask_size=mlogits.shape[1],
                             impl=impl)
        lm = mask_loss(mlogits, m_tgt, tgts.labels, tgts.is_pos)
        total = total + w * lm
        metrics[f"s{st}.loss_mask"] = lm
        prev = prev.detach()
        with torch.no_grad():
            boxes = box_ops.delta2bbox(tgts.rois, bbox_pred.float(),
                                       stds=STAGE_STDS[st],
                                       max_shape=batch.img_shape)
        valid = tgts.label_weights > 0
    metrics["loss"] = total
    return total, metrics


@torch.no_grad()
def htc_detect(model: HTC, img: torch.Tensor, img_shape,
               anchors: torch.Tensor, scale_factor=None,
               impl: Optional[str] = None):
    """(detections [100], mask probabilities [100, 28, 28, C])."""
    cfg, base = model.cfg, model.base
    feat = base.extract_feat(img[None])
    cls, reg = base.rpn_forward(feat)
    props = rpn.rpn_proposals(cls[0], reg[0], anchors, img_shape,
                              nms_pre=cfg.test_nms_pre,
                              nms_post=cfg.test_nms_post,
                              iou_threshold=cfg.rpn_nms_iou)
    sem_feat = model.semantic_head(feat)[1]
    boxes = props.boxes
    scores = 0.0
    for st in range(NUM_STAGES):
        rf = model.roi_feats(feat, sem_feat, boxes, impl)
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
    dets = nms_ops.multiclass_nms(decoded, scores / 3.0, 1e-4, 0.5, 100,
                                  box_valid=props.valid)
    mrf = model.mask_roi_feats(feat, sem_feat, dets.boxes, impl)
    prev, probs = None, 0.0
    for st in range(NUM_STAGES):
        mlogits, prev = model.mask_forward(st, mrf, prev)
        probs = probs + torch.sigmoid(mlogits)
    return dets, probs / 3.0


def make_htc(cfg: Optional[SelsaConfig] = None, scnet: bool = False,
             generator: Optional[torch.Generator] = None, device=None):
    cfg = cfg or SelsaConfig()
    return place((SCNet if scnet else HTC)(cfg), cfg, generator, device)
