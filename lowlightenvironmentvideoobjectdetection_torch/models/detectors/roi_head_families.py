"""Double-Head, Dynamic and PISA R-CNN on the DC5 trunk, the counterpart
of the JAX package's ``models/detectors/roi_head_families.py``
(``roi_rescale``, ``BasicResBlock``, ``DoubleConvFCBBoxHead``,
``DoubleHeadRCNN``, ``double_head_loss`` / ``double_head_detect``,
``DynamicSchedule``, ``dynamic_rcnn_loss`` / ``dynamic_rcnn_detect``,
``isr_p_roi_weights``, ``pisa_roi_loss``, ``_aligned_iou``; mmdet's
``double_roi_head.py``, ``dynamic_roi_head.py`` and ``pisa_roi_head.py``):

- Double-Head: a conv branch (``BasicResBlock``, 4 Bottlenecks, global
  average pool) regresses from the rois scaled 1.3x about their centres,
  which may reach past the map (RoIAlign's samples there read 0); an fc
  branch classifies from the plain rois. RoIAlign (kernel B) runs twice an
  image; both roi losses weigh 2.0, the targets' stds (0.1, 0.1, 0.2, 0.2).
- Dynamic R-CNN: Faster R-CNN whose RoI assigner threshold and SmoothL1
  beta are arguments; the loss reports ``batch_iou`` (the 75th largest
  candidate IoU) and ``batch_beta`` (the 10th smallest positive xy
  target) for ``DynamicSchedule``, the host-side state that would update
  them. As in JAX, nothing feeds the schedule: the families table trains
  at its initial 0.4 and 1.0 (ROADMAP F31).
- PISA: the bbox head runs twice, without gradient over every candidate
  (the gts and the proposals, for ScoreHLR's scores and decoded boxes),
  then over the sample; ISR-P re-weights the positives' classification by
  their IoU ranks, CARL weights the regression loss by the target class's
  probability. Its test path is plain Faster R-CNN's.

Proposals carry no gradient (ROADMAP F6).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import assigners, boxes as box_ops, losses
from ...core.nms import DetResult
from ..aggregators.selsa_aggregator import Linear
from ..backbones.resnet import Bottleneck, Conv2d, FrozenBatchNorm
from ..dense_heads import rpn_head as rpn
from ..roi_heads import bbox_head as bh
from ..vid.selsa import LossUniforms, SelsaConfig
from .faster_rcnn import DetTrainBatch, FasterRCNN, _zeros


def roi_rescale(rois: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """Rois [N, 4] scaled by ``scale_factor`` about their centres."""
    cx = (rois[:, 0] + rois[:, 2]) * 0.5
    cy = (rois[:, 1] + rois[:, 3]) * 0.5
    w = (rois[:, 2] - rois[:, 0]) * scale_factor
    h = (rois[:, 3] - rois[:, 1]) * scale_factor
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


# ---------------------------------------------------------------------------
# Double-Head R-CNN
# ---------------------------------------------------------------------------

DH_STDS = (0.1, 0.1, 0.2, 0.2)
DH_LOSS_WEIGHT = 2.0
DH_REG_ROI_SCALE = 1.3


class BasicResBlock(nn.Module):
    """3x3 (FrozenBN, ReLU) -> 1x1 (FrozenBN) beside a 1x1 (with bias,
    FrozenBN) projection, summed, ReLU; NCHW."""

    def __init__(self, in_channels: int, out_channels: int = 1024,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_channels, in_channels, 3, padding=1,
                            bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(in_channels, dtype=dtype)
        self.conv2 = Conv2d(in_channels, out_channels, 1, bias=False,
                            dtype=dtype)
        self.bn2 = FrozenBatchNorm(out_channels, dtype=dtype)
        self.conv_identity = Conv2d(in_channels, out_channels, 1,
                                    dtype=dtype)
        self.bn_identity = FrozenBatchNorm(out_channels, dtype=dtype)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + self.bn_identity(self.conv_identity(x)))


class DoubleConvFCBBoxHead(nn.Module):
    """The conv branch (regression, 4 C deltas) on the rescaled rois' [N,
    7, 7, C] features, the fc branch (classification) on the plain ones'."""

    def __init__(self, in_channels: int, num_classes: int = 80,
                 num_convs: int = 4, num_fcs: int = 2,
                 conv_out_channels: int = 1024, fc_out_channels: int = 1024,
                 dtype=torch.float32):
        super().__init__()
        self.res_block = BasicResBlock(in_channels, conv_out_channels, dtype)
        self.num_convs, self.num_fcs = num_convs, num_fcs
        for i in range(num_convs):
            self.add_module(f"conv_branch{i}", Bottleneck(
                conv_out_channels, conv_out_channels // 4, dtype=dtype))
        self.fc_reg = Linear(conv_out_channels, 4 * num_classes, dtype=dtype)
        for i in range(num_fcs):
            self.add_module(f"fc_branch{i}", Linear(
                in_channels * 49 if i == 0 else fc_out_channels,
                fc_out_channels, dtype=dtype))
        self.fc_cls = Linear(fc_out_channels, num_classes + 1, dtype=dtype)
        self.compute_dtype = dtype

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        """The JAX head's normal(0.001) ``fc_reg`` and normal(0.01)
        ``fc_cls`` kernels."""
        self.fc_reg.weight.normal_(0.0, 0.001, generator=generator)
        self.fc_cls.weight.normal_(0.0, 0.01, generator=generator)

    def forward(self, x_cls: torch.Tensor, x_reg: torch.Tensor):
        """-> (cls_score [N, C + 1], bbox_pred [N, 4 C])."""
        y = self.res_block(x_reg.permute(0, 3, 1, 2).to(self.compute_dtype))
        for i in range(self.num_convs):
            y = getattr(self, f"conv_branch{i}")(y)
        bbox_pred = self.fc_reg(y.mean(dim=(-2, -1)))
        z = x_cls.flatten(1)
        for i in range(self.num_fcs):
            z = F.relu(getattr(self, f"fc_branch{i}")(z))
        return self.fc_cls(z), bbox_pred


class DoubleHeadRCNN(nn.Module):
    """``base`` (backbone, neck, RPN; no bbox head) and ``double_head``."""

    def __init__(self, cfg: SelsaConfig = SelsaConfig()):
        super().__init__()
        self.cfg = cfg
        self.base = FasterRCNN(cfg)
        del self.base.bbox_head
        self.double_head = DoubleConvFCBBoxHead(cfg.neck_channels,
                                                cfg.num_classes)

    def bbox_forward(self, feat, rois, impl: Optional[str] = None):
        """RoIAlign of the rois (classification) and of the same rois
        scaled 1.3x (regression), then the head."""
        binds = _zeros(rois)
        cls_feats = self.base.roi_feats(feat, rois, binds, impl=impl)
        reg_feats = self.base.roi_feats(
            feat, roi_rescale(rois, DH_REG_ROI_SCALE), binds, impl=impl)
        return self.double_head(cls_feats, reg_feats)


def double_head_loss(model: DoubleHeadRCNN, batch: DetTrainBatch,
                     anchors: torch.Tensor, uniforms: LossUniforms,
                     impl: Optional[str] = None):
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
    tgts = bh.bbox_targets(props.boxes, props.valid, batch.gt_boxes,
                           batch.gt_labels, batch.gt_valid, uniforms.roi,
                           num_classes=cfg.num_classes,
                           num_samples=cfg.num_roi_samples, stds=DH_STDS)
    cls_score, bbox_pred = model.bbox_forward(feat, tgts.rois, impl=impl)
    roi = bh.bbox_loss(cls_score, bbox_pred, tgts,
                       num_classes=cfg.num_classes)
    total = (ls.loss_cls + ls.loss_bbox
             + DH_LOSS_WEIGHT * (roi.loss_cls + roi.loss_bbox))
    return total, {"loss": total, "loss_rpn_cls": ls.loss_cls,
                   "loss_rpn_bbox": ls.loss_bbox,
                   "loss_cls": DH_LOSS_WEIGHT * roi.loss_cls,
                   "loss_bbox": DH_LOSS_WEIGHT * roi.loss_bbox,
                   "acc": roi.acc}


@torch.no_grad()
def double_head_detect(model: DoubleHeadRCNN, img: torch.Tensor, img_shape,
                       anchors: torch.Tensor, scale_factor=None,
                       impl: Optional[str] = None) -> DetResult:
    cfg, base = model.cfg, model.base
    feat = base.extract_feat(img[None])
    cls, reg = base.rpn_forward(feat)
    props = rpn.rpn_proposals(cls[0], reg[0], anchors, img_shape,
                              nms_pre=cfg.test_nms_pre,
                              nms_post=cfg.test_nms_post,
                              iou_threshold=cfg.rpn_nms_iou)
    cls_score, bbox_pred = model.bbox_forward(feat, props.boxes, impl=impl)
    return bh.bbox_decode(props.boxes, cls_score, bbox_pred, img_shape,
                          roi_valid=props.valid, scale_factor=scale_factor,
                          stds=DH_STDS)


# ---------------------------------------------------------------------------
# Dynamic R-CNN
# ---------------------------------------------------------------------------

DYN_IOU_TOPK = 75
DYN_BETA_TOPK = 10
DYN_UPDATE_INTERVAL = 100
DYN_INITIAL_IOU = 0.4
DYN_INITIAL_BETA = 1.0
DYN_RPN_NMS_IOU = 0.85
DYN_EPS = 1e-15
DYN_STDS = (0.1, 0.1, 0.2, 0.2)


class DynamicSchedule:
    """DynamicRoIHead's mutable hyperparameters on the host: ``record``
    each step's ``batch_iou`` / ``batch_beta``; every
    ``update_iter_interval`` records the IoU threshold becomes max(initial,
    mean of the IoUs) and beta min(initial, median of the betas), unless
    that median is below 1e-15. Returns the current (iou_thr, beta)."""

    def __init__(self, initial_iou=DYN_INITIAL_IOU,
                 initial_beta=DYN_INITIAL_BETA,
                 update_iter_interval=DYN_UPDATE_INTERVAL):
        self.initial_iou = initial_iou
        self.initial_beta = initial_beta
        self.interval = update_iter_interval
        self.iou_thr = initial_iou
        self.beta = initial_beta
        self.iou_history = []
        self.beta_history = []

    def record(self, batch_iou: float, batch_beta: float):
        self.iou_history.append(float(batch_iou))
        self.beta_history.append(float(batch_beta))
        if len(self.iou_history) % self.interval == 0:
            self.iou_thr = max(self.initial_iou,
                               float(np.mean(self.iou_history)))
            med = float(np.median(self.beta_history))
            if med >= DYN_EPS:
                self.beta = min(self.initial_beta, med)
            self.iou_history = []
            self.beta_history = []
        return self.iou_thr, self.beta


def dynamic_rcnn_loss(model: FasterRCNN, batch: DetTrainBatch,
                      anchors: torch.Tensor, uniforms: LossUniforms,
                      iou_thr: float = DYN_INITIAL_IOU,
                      beta: float = DYN_INITIAL_BETA,
                      impl: Optional[str] = None):
    """The Dynamic R-CNN loss at the current ``iou_thr`` and ``beta``
    (proposals at RPN NMS 0.85); metrics add ``batch_iou`` and
    ``batch_beta``."""
    cfg = model.cfg
    feat = model.extract_feat(batch.img[None])
    cls, reg = model.rpn_forward(feat)
    ls = rpn.rpn_loss(cls[0], reg[0], anchors, batch.gt_boxes,
                      batch.gt_valid, uniforms.rpn, batch.img_shape)
    with torch.no_grad():  # F6
        props = rpn.rpn_proposals(
            cls[0], reg[0], anchors, batch.img_shape,
            nms_pre=cfg.train_nms_pre, nms_post=cfg.train_nms_post,
            iou_threshold=DYN_RPN_NMS_IOU)
    cand = torch.cat([batch.gt_boxes, props.boxes])
    cand_valid = torch.cat([batch.gt_valid, props.valid])
    n, g = cand.shape[0], batch.gt_boxes.shape[0]
    assign = assigners.max_iou_assign(
        cand, batch.gt_boxes, batch.gt_labels, batch.gt_valid,
        iou_thr, iou_thr, iou_thr, box_valid=cand_valid)
    iou_sorted = -torch.sort(-torch.where(cand_valid, assign.max_overlaps,
                                          -1.0), stable=True).values
    kth = (torch.clamp(cand_valid.sum(), max=DYN_IOU_TOPK) - 1).clamp(0, n - 1)
    top_iou = iou_sorted[kth].clamp(0.0, 1.0)

    sample = assigners.random_sample_gather(assign, uniforms.roi,
                                            cfg.num_roi_samples, 0.25)
    rois = cand[sample.inds]
    matched = (assign.assigned_gt_inds[sample.inds] - 1).clamp(0, g - 1)
    pos = sample.is_pos
    labels = torch.where(pos, batch.gt_labels[matched].long(),
                         cfg.num_classes)
    tgt = box_ops.bbox2delta(rois, batch.gt_boxes[matched], stds=DYN_STDS)
    tgt = torch.where(pos[:, None], tgt, 0.0)
    label_w = sample.is_valid.float()

    rf = model.roi_feats(feat, rois, _zeros(rois), impl=impl)
    cls_score, bbox_pred = model.bbox_forward(rf)
    avg = label_w.sum().clamp_min(1.0)
    loss_cls = losses.softmax_cross_entropy(cls_score.float(), labels,
                                            weight=label_w, avg_factor=avg)
    pred = bbox_pred.reshape(-1, cfg.num_classes, 4).float()
    idx = labels.clamp(0, cfg.num_classes - 1)
    pred_c = torch.gather(pred, 1, idx[:, None, None].expand(-1, 1, 4))[:, 0]
    loss_bbox = losses.smooth_l1_loss(pred_c, tgt, beta=beta,
                                      weight=pos[:, None].float(),
                                      avg_factor=avg)
    err = tgt[:, :2].abs().mean(-1)
    err_sorted = torch.sort(torch.where(pos, err, torch.inf),
                            stable=True).values
    kth = (torch.clamp(pos.sum(), max=DYN_BETA_TOPK) - 1).clamp(
        0, err.shape[0] - 1)
    batch_beta = err_sorted[kth]
    batch_beta = torch.where(torch.isfinite(batch_beta), batch_beta, 0.0)

    total = ls.loss_cls + ls.loss_bbox + loss_cls + loss_bbox
    return total, {"loss": total, "loss_rpn_cls": ls.loss_cls,
                   "loss_rpn_bbox": ls.loss_bbox, "loss_cls": loss_cls,
                   "loss_bbox": loss_bbox, "batch_iou": top_iou,
                   "batch_beta": batch_beta}


@torch.no_grad()
def dynamic_rcnn_detect(model: FasterRCNN, img: torch.Tensor, img_shape,
                        anchors: torch.Tensor, scale_factor=None,
                        impl: Optional[str] = None) -> DetResult:
    """Faster R-CNN's test path at RPN NMS 0.85 and stds (0.1, 0.1, 0.2,
    0.2)."""
    cfg = model.cfg
    feat = model.extract_feat(img[None])
    cls, reg = model.rpn_forward(feat)
    props = rpn.rpn_proposals(cls[0], reg[0], anchors, img_shape,
                              nms_pre=cfg.test_nms_pre,
                              nms_post=cfg.test_nms_post,
                              iou_threshold=DYN_RPN_NMS_IOU)
    rf = model.roi_feats(feat, props.boxes, _zeros(props.boxes), impl=impl)
    cls_score, bbox_pred = model.bbox_forward(rf)
    return bh.bbox_decode(props.boxes, cls_score, bbox_pred, img_shape,
                          roi_valid=props.valid, scale_factor=scale_factor,
                          stds=DYN_STDS)


# ---------------------------------------------------------------------------
# PISA (ScoreHLR sampling, ISR-P, CARL)
# ---------------------------------------------------------------------------

_INT32_MAX = 2147483647  # jax.ops.segment_min's fill for an empty segment


def _segment_min_at(values, live, seg, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_min(where(live, values, INT32_MAX), seg,
    num_segments)[seg]`` with JAX's rules: ids past ``num_segments`` are
    dropped from the reduction and clamped when gathered."""
    start = torch.full((num_segments + 1,), _INT32_MAX, dtype=torch.int64,
                       device=values.device)
    dump = torch.where(seg < num_segments, seg, num_segments)
    start = start.scatter_reduce(0, dump, torch.where(live, values,
                                                      _INT32_MAX),
                                 reduce="amin")[:num_segments]
    return start[seg.clamp_max(num_segments - 1)]


def isr_p_roi_weights(labels, gts, ious, pos, label_weights, cls_score,
                      num_classes: int, k: float = 2.0, bias: float = 0.0):
    """ISR-P (pisa_loss.py): rank the positives by IoU within each (class,
    gt) group, add ``max_l_num - rank`` to the IoU, rank those within each
    class; a positive's weight becomes ``(bias + (1 - bias) label_weight
    (max_l_num - rank) / max_l_num) ** k``, scaled so the positives'
    cross entropy keeps its sum. The ranks come from stable double sorts of
    f32 keys, as the JAX package builds them (``seg_id * 4 - iou``, ``lab *
    2 (s + 2) - ious2``), so equal IoUs rank in index order."""
    s = labels.shape[0]
    lab = torch.where(pos, labels.clamp(0, num_classes - 1), num_classes)
    ngt = torch.where(pos, gts, 0).max() + 1
    cls_n = torch.zeros(num_classes + 1, dtype=torch.int64,
                        device=labels.device).scatter_add_(0, lab, pos.long())
    cls_n[num_classes] = 0
    max_l_num = cls_n.max().clamp_min(1).float()

    grp = lab * ngt.clamp_min(1) + torch.where(pos, gts, 0)
    key = grp.float() * 4.0 - ious.clamp(0.0, 1.0)
    grank = assigners._ranks(torch.where(pos, key, torch.inf))
    seg = torch.where(pos, grp, 0)
    r1 = (grank - _segment_min_at(grank, pos, seg, s + 1)).float()
    ious2 = ious.clamp(0.0, 1.0) + (max_l_num - r1)
    key2 = lab.float() * (2.0 * (s + 2)) - ious2
    grank2 = assigners._ranks(torch.where(pos, key2, torch.inf))
    seg2 = torch.where(pos, lab, 0)
    l_rank = (grank2 - _segment_min_at(grank2, pos, seg2, num_classes + 1)
              ).float()

    w = label_weights * (max_l_num - l_rank) / max_l_num
    w = (bias + w * (1.0 - bias)) ** k
    logp = F.log_softmax(cls_score.float(), dim=-1)
    ce = -torch.gather(logp, 1, labels.clamp(0, num_classes)[:, None])[:, 0]
    ori = torch.where(pos, ce * label_weights, 0.0).sum()
    new = torch.where(pos, ce * w, 0.0).sum().clamp_min(1e-12)
    w = w * ori / new
    return torch.where(pos, w, label_weights)


def _aligned_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-aligned IoU of boxes [N, 4]."""
    lt = torch.maximum(a[:, :2], b[:, :2])
    rb = torch.minimum(a[:, 2:], b[:, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[:, 0] * wh[:, 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a + area_b - inter).clamp_min(1e-6)


def pisa_roi_loss(model: FasterRCNN, batch: DetTrainBatch,
                  anchors: torch.Tensor, uniforms: LossUniforms,
                  isr_k: float = 2.0, isr_bias: float = 0.0,
                  carl_k: float = 1.0, carl_bias: float = 0.2,
                  impl: Optional[str] = None):
    """PISA's two-stage loss: the RPN loss; the head without gradient over
    all G + P candidates for ScoreHLR (``uniforms.roi`` [3, G + P]); the
    head over the sample; ISR-P's classification weights; SmoothL1 and
    CARL on the positives."""
    cfg = model.cfg
    nc = cfg.num_classes
    feat = model.extract_feat(batch.img[None])
    cls, reg = model.rpn_forward(feat)
    ls = rpn.rpn_loss(cls[0], reg[0], anchors, batch.gt_boxes,
                      batch.gt_valid, uniforms.rpn, batch.img_shape)
    with torch.no_grad():  # F6
        props = rpn.rpn_proposals(
            cls[0], reg[0], anchors, batch.img_shape,
            nms_pre=cfg.train_nms_pre, nms_post=cfg.train_nms_post,
            iou_threshold=cfg.rpn_nms_iou)
    cand = torch.cat([batch.gt_boxes, props.boxes])
    cand_valid = torch.cat([batch.gt_valid, props.valid])
    g = batch.gt_boxes.shape[0]
    assign = assigners.max_iou_assign(
        cand, batch.gt_boxes, batch.gt_labels, batch.gt_valid, 0.5, 0.5, 0.5,
        box_valid=cand_valid)

    with torch.no_grad():  # ScoreHLR's context forward over every candidate
        rf_all = model.roi_feats(feat, cand, _zeros(cand), impl=impl)
        cs_all, bp_all = (t.float() for t in model.bbox_forward(rf_all))
        probs = torch.softmax(cs_all, dim=-1)
        max_score = probs[:, :-1].amax(dim=-1)
        arg_score = probs[:, :-1].argmax(dim=-1)  # the first of equals
        bp_c = torch.gather(bp_all.reshape(-1, nc, 4), 1,
                            arg_score[:, None, None].expand(-1, 1, 4))[:, 0]
        pred_boxes = box_ops.delta2bbox(cand, bp_c, stds=bh.BBOX_STDS)
        neg_ce = -F.log_softmax(cs_all, dim=-1)[:, nc]
        sample, neg_w = assigners.score_hlr_sample_gather(
            assign, uniforms.roi, cfg.num_roi_samples, 0.25,
            neg_max_score=torch.where(cand_valid, max_score, 0.0),
            pred_boxes=pred_boxes, neg_ce_loss=neg_ce)

    rois = cand[sample.inds]
    matched = (assign.assigned_gt_inds[sample.inds] - 1).clamp(0, g - 1)
    pos = sample.is_pos
    labels = torch.where(pos, batch.gt_labels[matched].long(), nc)
    tgt = box_ops.bbox2delta(rois, batch.gt_boxes[matched], stds=bh.BBOX_STDS)
    tgt = torch.where(pos[:, None], tgt, 0.0)
    label_w = sample.is_valid.float() * neg_w

    rf = model.roi_feats(feat, rois, _zeros(rois), impl=impl)
    cls_score, bbox_pred = model.bbox_forward(rf)
    pred = bbox_pred.reshape(-1, nc, 4).float()
    cls_idx = labels.clamp(0, nc - 1)
    pred_c = torch.gather(pred, 1, cls_idx[:, None, None].expand(-1, 1, 4)
                          )[:, 0]
    with torch.no_grad():
        dec_pred = box_ops.delta2bbox(rois, pred_c, stds=bh.BBOX_STDS)
        dec_tgt = box_ops.delta2bbox(rois, tgt, stds=bh.BBOX_STDS)
        label_w = isr_p_roi_weights(
            labels, matched, _aligned_iou(dec_pred, dec_tgt), pos, label_w,
            cls_score, nc, k=isr_k, bias=isr_bias)

    avg = sample.is_valid.float().sum().clamp_min(1.0)
    logits = cls_score.float()
    loss_cls = losses.softmax_cross_entropy(logits, labels, weight=label_w,
                                            avg_factor=avg)
    loss_bbox = losses.smooth_l1_loss(pred_c, tgt, beta=1.0,
                                      weight=pos[:, None].float(),
                                      avg_factor=avg)
    p_lab = torch.gather(torch.softmax(logits, dim=-1), 1,
                         cls_idx[:, None])[:, 0]
    carl_w = (carl_bias + (1.0 - carl_bias) * p_lab) ** carl_k
    num_pos = pos.float().sum().clamp_min(1.0)
    carl_w = carl_w * num_pos / torch.where(pos, carl_w, 0.0).sum(
    ).clamp_min(1e-6)
    d = pred_c - tgt
    l1 = torch.where(d.abs() < 1.0, 0.5 * d * d, d.abs() - 0.5)
    loss_carl = (l1.sum(-1) * carl_w * pos.float()).sum() / avg

    total = ls.loss_cls + ls.loss_bbox + loss_cls + loss_bbox + loss_carl
    return total, {"loss": total, "loss_rpn_cls": ls.loss_cls,
                   "loss_rpn_bbox": ls.loss_bbox, "loss_cls": loss_cls,
                   "loss_bbox": loss_bbox, "loss_carl": loss_carl}
