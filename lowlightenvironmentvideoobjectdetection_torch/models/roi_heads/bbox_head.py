"""Second-stage Shared2FC bbox head with per-FC SELSA aggregation (or
without it, Faster R-CNN's), its training targets and loss, and its
decode, the counterpart of the JAX package's
``models/roi_heads/bbox_head.py`` (the joint ``__call__`` as ``forward``,
``ref_transform_kv``, ``forward_cached_stream_kv``,
``BBoxTargets``, ``bbox_targets``, ``BBoxLossOut``, ``bbox_loss``,
``bbox_decode``). The streaming forward and the decode also take a leading
stream axis S (the counterpart of ``jax.vmap`` over them)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import assigners, boxes as box_ops, losses, nms as nms_ops
from ..aggregators.selsa_aggregator import Linear, SelsaAggregator

BBOX_STDS = (0.2, 0.2, 0.2, 0.2)


class Shared2FCBBoxHead(nn.Module):
    """Shared FCs, each followed by a SELSA aggregator, then cls/reg linears;
    with ``with_selsa=False`` (Faster R-CNN's head, as FGFA and DFF use it)
    the shared FCs with ReLU alone. ``reg_class_agnostic`` regresses one
    box a roi (Cascade R-CNN's heads) instead of one a class.

    RoI features enter as [N, 7, 7, C]; their row-major flatten is the
    (7, 7, C) row order of the first FC's input, as in the JAX head. Plain
    SELSA has 2 shared FCs, the TemporalRoIAlign configurations 3."""

    fc_out_channels = 1024
    num_attention_blocks = 16

    def __init__(self, in_features: int, num_classes: int = 30,
                 num_shared_fcs: int = 2, dtype=torch.float32,
                 with_selsa: bool = True, reg_class_agnostic: bool = False):
        super().__init__()
        c = self.fc_out_channels
        self.num_shared_fcs = num_shared_fcs
        self.with_selsa = with_selsa
        for i in range(num_shared_fcs):
            self.add_module(f"shared_fc{i}", Linear(
                in_features if i == 0 else c, c, dtype=dtype))
            if with_selsa:
                self.add_module(f"aggregator{i}", SelsaAggregator(
                    c, self.num_attention_blocks, dtype=dtype))
        self.fc_cls = Linear(c, num_classes + 1, dtype=dtype)
        self.fc_reg = Linear(c, 4 if reg_class_agnostic else 4 * num_classes,
                             dtype=dtype)

    def _stage(self, i: int):
        return getattr(self, f"shared_fc{i}"), getattr(self, f"aggregator{i}")

    def forward(self, x: torch.Tensor, ref_x: Optional[torch.Tensor] = None,
                ref_mask: Optional[torch.Tensor] = None):
        """Joint forward (training): key rois x [N, 7, 7, C] attend over the
        reference rois ref_x [M, 7, 7, C] (ref_mask [M]) after each shared
        FC; without SELSA, x alone. Returns (cls_score [N, C+1], bbox_pred
        [N, 4C])."""
        x = x.flatten(-3)
        if not self.with_selsa:
            for i in range(self.num_shared_fcs):
                x = F.relu(getattr(self, f"shared_fc{i}")(x))
            return self.fc_cls(x), self.fc_reg(x)
        ref_x = ref_x.flatten(-3)
        for i in range(self.num_shared_fcs):
            fc, agg = self._stage(i)
            x, ref_x = fc(x), fc(ref_x)
            x = F.relu(x + agg(x, ref_x, ref_mask))
            ref_x = F.relu(ref_x)
        return self.fc_cls(x), self.fc_reg(x)

    def ref_transform_kv(self, ref_x: torch.Tensor):
        """Per-stage head-major (k, v) [nb, M, hd] of the reference rois: the
        aggregator's projections of each FC's pre-relu activation."""
        ref_x = ref_x.flatten(-3)
        kvs = []
        for i in range(self.num_shared_fcs):
            fc, agg = self._stage(i)
            ref_x = fc(ref_x)
            kvs.append(agg.project_kv_hm(ref_x))
            ref_x = F.relu(ref_x)
        return tuple(kvs)

    def forward_cached_stream_kv(self, x, ref_kvs, ref_mask, self_mask,
                                 impl: Optional[str] = None):
        """Streaming forward over the memo K/V plus this frame's own rois.
        x: [N, 7, 7, C]; ref_kvs: per stage (k, v) [nb, M, hd]; masks: [M]
        and [N] bool. Returns ((cls [N, C+1], reg [N, 4C]), cur_kvs
        [nb, N, hd]). With a leading stream axis on every argument
        (x [S, N, 7, 7, C], ...) each FC is one matmul over all S*N rois,
        each stage one attention launch, and cur_kvs are [S, nb, N, hd]."""
        x = x.flatten(-3)
        cur_kvs = []
        r = None
        for i in range(self.num_shared_fcs):
            fc, agg = self._stage(i)
            xf = fc(x)
            cur = xf if i == 0 else fc(r)  # ref-side activation, pre-relu
            r = F.relu(cur)
            ck, cv = agg.project_kv_hm(cur)
            cur_kvs.append((ck, cv))
            q = agg.project_q(xf)
            x = F.relu(xf + agg.attend_cached2(
                q, ref_kvs[i][0], ref_kvs[i][1], ck, cv, ref_mask, self_mask,
                impl=impl))
        return (self.fc_cls(x), self.fc_reg(x)), tuple(cur_kvs)


class BBoxTargets(NamedTuple):
    rois: torch.Tensor  # [num, 4] sampled proposals
    labels: torch.Tensor  # [num] int64, num_classes = background
    label_weights: torch.Tensor  # [num]
    bbox_targets: torch.Tensor  # [num, 4]
    bbox_weights: torch.Tensor  # [num]
    is_pos: torch.Tensor  # [num] bool


# the reference RoI-head train config: 256 rois at a quarter positives, IoU
# 0.5 for positives, negatives and the low-quality floor
ROI_POS_FRACTION, ROI_IOU = 0.25, 0.5


def bbox_targets(proposals, proposal_valid, gt_boxes, gt_labels, gt_valid,
                 uniforms: torch.Tensor, num_classes: int = 30,
                 num_samples: int = 256,
                 pos_fraction: float = ROI_POS_FRACTION,
                 pos_iou_thr: float = ROI_IOU, neg_iou_thr: float = ROI_IOU,
                 min_pos_iou: float = ROI_IOU,
                 add_gt_as_proposals: bool = True,
                 stds=BBOX_STDS) -> BBoxTargets:
    """Assign and sample the RoI head's rois for one image. With
    ``add_gt_as_proposals`` the gts join the candidates ahead of the
    proposals, so ``uniforms`` is [3, G + P] (``random_sample_gather``),
    else [3, P]. Negatives take label ``num_classes``; regression targets
    are deltas with ``stds`` (by default 0.2) on the positives and 0
    elsewhere."""
    if add_gt_as_proposals:
        cand = torch.cat([gt_boxes, proposals])
        cand_valid = torch.cat([gt_valid, proposal_valid])
    else:
        cand, cand_valid = proposals, proposal_valid
    assign = assigners.max_iou_assign(cand, gt_boxes, gt_labels, gt_valid,
                                      pos_iou_thr, neg_iou_thr, min_pos_iou,
                                      box_valid=cand_valid)
    sample = assigners.random_sample_gather(assign, uniforms, num_samples,
                                            pos_fraction)
    rois = cand[sample.inds]
    matched = (assign.assigned_gt_inds[sample.inds] - 1).clamp(
        0, gt_boxes.shape[0] - 1)
    pos = sample.is_pos
    labels = torch.where(pos, gt_labels[matched].long(), num_classes)
    tgt = box_ops.bbox2delta(rois, gt_boxes[matched], stds=stds)
    tgt = torch.where(pos[:, None], tgt, 0.0)
    return BBoxTargets(rois, labels, sample.is_valid.float(), tgt,
                       pos.float(), pos)


class BBoxLossOut(NamedTuple):
    loss_cls: torch.Tensor
    loss_bbox: torch.Tensor
    acc: torch.Tensor


def bbox_loss(cls_score, bbox_pred, targets: BBoxTargets,
              num_classes: int = 30,
              reg_class_agnostic: bool = False) -> BBoxLossOut:
    """Softmax cross entropy over C + 1 classes and SmoothL1 (beta 1) on
    the target class's deltas (the one box of a class-agnostic head), both
    averaged over the sampled rois."""
    avg = targets.label_weights.sum().clamp_min(1.0)
    logits = cls_score.float()
    loss_cls = losses.softmax_cross_entropy(
        logits, targets.labels, weight=targets.label_weights, avg_factor=avg)
    if reg_class_agnostic:
        pred = bbox_pred.float()
    else:
        pred = bbox_pred.reshape(-1, num_classes, 4).float()
        idx = targets.labels.clamp(0, num_classes - 1)
        pred = torch.gather(pred, 1, idx[:, None, None].expand(-1, 1, 4)
                            )[:, 0]
    loss_bbox = losses.smooth_l1_loss(
        pred, targets.bbox_targets, beta=1.0,
        weight=targets.bbox_weights[:, None], avg_factor=avg)
    acc = losses.accuracy(logits, targets.labels, targets.label_weights)
    return BBoxLossOut(loss_cls, loss_bbox, acc)


def bbox_decode(rois, cls_score, bbox_pred, img_shape,
                roi_valid: Optional[torch.Tensor] = None,
                scale_factor: Optional[torch.Tensor] = None,
                nms_pre: Optional[int] = 2048,
                stds=BBOX_STDS) -> nms_ops.DetResult:
    """Softmax scores, per-class delta decode (``stds``, by default 0.2)
    clipped to
    ``img_shape``, division by ``scale_factor`` [4], then fixed-shape
    multiclass NMS (score > 1e-4, IoU 0.5, at most 100; the reference test
    config). Batched: rois [S, N, 4], head outputs [S, N, ...], img_shape
    [S, 2], scale_factor [S, 4], roi_valid [S, N]; one NMS for all S."""
    scores = torch.softmax(cls_score.float(), dim=-1)
    decoded = box_ops.delta2bbox(rois, bbox_pred.float(), stds=stds,
                                 max_shape=img_shape)
    if scale_factor is not None:
        k = decoded.shape[-1] // 4
        sf = torch.as_tensor(scale_factor, dtype=decoded.dtype,
                             device=decoded.device)
        decoded = decoded / sf.repeat((1,) * (sf.ndim - 1) + (k,))[..., None, :]
    return nms_ops.multiclass_nms(decoded, scores, 1e-4, 0.5, 100,
                                  box_valid=roi_valid, pre_top_k=nms_pre)
