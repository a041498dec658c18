"""Fast R-CNN and the standalone RPN, the counterparts of the JAX package's
``models/detectors/more_rcnn.py`` ``FastRCNN`` / ``FastRCNNBatch`` /
``fast_rcnn_loss`` / ``fast_rcnn_detect`` and ``RPN`` / ``rpn_only_loss``
/ ``rpn_propose`` (mmdet's ``fast_rcnn.py`` and ``rpn.py``). Both wrap the
DC5 ``FasterRCNN`` as ``base``, as the flax modules do, so the weights
bridge by name; the part a module never calls is removed, as flax makes no
variables for it. Fast R-CNN takes its proposals from outside (no RPN
runs); the RPN trains on its RPN loss alone and gives scored
class-agnostic proposals.

Trident Faster R-CNN (``TridentFasterRCNN``, ``trident_loss``,
``trident_detect``): the trident backbone (``backbones/detectors_trident.py``)
gives three branches that fold into the batch for the neck and the RPN;
training takes the mean of the three branches' Faster R-CNN losses, each
branch with its own uniforms (the JAX keys ``fold_in(rng_rpn, b)`` and
``fold_in(rng_roi, b)``); the test path runs the middle branch alone, as
mmdet's ``test_branch_idx`` does (the JAX package computes all three and
keeps the middle one: the same detections).

Grid R-CNN (``GridHead``, ``GridRCNN``, ``grid_targets``,
``grid_points_decode``, ``grid_rcnn_loss``, ``grid_rcnn_detect``; mmdet's
``grid_rcnn.py`` and ``grid_head.py``): the Faster R-CNN head classifies
(its regression is not used), and a grid head reads 14x14 RoIAlign
features (kernel B's ``gather14x2`` body, D's ``scatter14x2`` for the
gradient): 8 convs with GroupNorm(36), first- and second-order fusion of
the 9 points' features (5x5 depthwise and 1x1 convs), two grouped 4x4
stride-2 transposed convs (groups 9) to 28x28 heatmaps a point. Training
jitters the positive rois (uniform in +-0.15 of their size, the JAX key
``fold_in(rng, 7)``) and takes sigmoid cross entropy (weight 15) on the
fused and the unfused heatmaps against radius-1 circles; the test path
runs NMS on the unregressed proposals first, then moves each detection's
borders to the score-weighted vote of its 3 boundary points.

Mask Scoring R-CNN (``MaskIoUHead``, ``MaskScoringRCNN``,
``mask_scoring_loss``, ``mask_scoring_detect``; mmdet's
``mask_scoring_rcnn.py`` and ``maskiou_head.py``): Mask R-CNN as
``mask_rcnn`` and a MaskIoU head on the 14x14 mask features beside the
28x28 prediction, resized to 14x14 as ``jax.image.resize(..., "linear")``
does (antialiased) and maxed over all classes (ROADMAP F35); the L2 loss
(weight 0.5) on the positives' IoU with their whole gt; at test each
detection's score times its predicted IoU, clipped to [0, 1].

PointRend (``PointHead``, ``uncertain_point_indices``, ``PointRendRCNN``,
``point_rend_loss``, ``point_rend_detect``; mmdet's ``point_rend.py``):
Mask R-CNN as ``mask_rcnn``, and at the 49 most uncertain cells of each
roi's 28x28 class channel (-|logit|, ``lax.top_k``'s order: the lower
index first among ties) a 3-layer MLP over the map's bilinear sample there
(``ops/point_sample.py``) and the coarse logits refines the logits; BCE at
those points in training.

Both JAX losses run Mask R-CNN's loss and then the trunk, the RPN, the
proposals and the sampler again with the same key, which gives the same
rois and the same mask logits: here the forward runs once
(``mask_rcnn_parts``), with the same total and gradients. Their test paths
likewise run the mask branch once on the detections.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import nms as nms_ops
from ...core.boxes import delta2bbox
from ...core.nms import DetResult
from ...ops.point_sample import point_sample
from ...ops.roi_align import roi_align
from ...ops.scale_translate import weight_matrix
from ..aggregators.selsa_aggregator import Linear
from ..backbones.detectors_trident import TEST_BRANCH, TridentResNet
from ..backbones.resnet import Conv2d
from ..dense_heads import rpn_head as rpn
from ..dense_heads.retina_head import top_k_stable
from ..necks.channel_mapper import ChannelMapper
from ..roi_heads import bbox_head as bh
from ..roi_heads.mask_head import (ROI_SIZE, class_channel, mask_iou_targets,
                                   paste_masks)
from ..vid.selsa import LossUniforms, SelsaConfig
from .faster_rcnn import DetTrainBatch, FasterRCNN, _zeros
from .mask_rcnn import (MaskRCNN, MaskTrainBatch, mask_rcnn_boxes,
                        mask_rcnn_parts)


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


# ---------------------------------------------------------------------------
# Trident Faster R-CNN
# ---------------------------------------------------------------------------


class TridentFasterRCNN(nn.Module):
    """The trident backbone, a one-level ChannelMapper, the RPN and the
    Shared2FC head without SELSA (float32), named as the flax module's."""

    def __init__(self, cfg: SelsaConfig = SelsaConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.backbone = TridentResNet(depth=c.depth, dtype=c.compute_dtype)
        self.neck = ChannelMapper(2048, c.neck_channels, 3,
                                  dtype=c.compute_dtype)
        self.rpn_head = rpn.RPNHead(c.neck_channels, c.neck_channels,
                                    c.num_base_anchors, dtype=c.compute_dtype)
        self.bbox_head = bh.Shared2FCBBoxHead(
            7 * 7 * c.neck_channels, c.num_classes, dtype=torch.float32,
            with_selsa=False)

    def extract_feat(self, imgs: torch.Tensor,
                     branches: Sequence[int] = (0, 1, 2)) -> torch.Tensor:
        """imgs [1, H, W, 3] -> the branches' neck maps [B, h, w, C]."""
        feats = self.backbone(imgs.permute(0, 3, 1, 2), branches)
        feats = feats.reshape((-1,) + feats.shape[2:])
        return self.neck(feats).permute(0, 2, 3, 1).contiguous()

    def roi_feats(self, feat: torch.Tensor, rois: torch.Tensor,
                  impl: Optional[str] = None) -> torch.Tensor:
        """7x7 RoIAlign of rois on one branch's map [1, h, w, C]."""
        return roi_align(feat.float().contiguous(), rois.float(),
                         1.0 / self.cfg.stride, batch_inds=_zeros(rois),
                         out_size=7, sampling_ratio=2, impl=impl)


def draw_trident_uniforms(cfg: SelsaConfig, num_gts: int, num_anchors: int,
                          generator: torch.Generator, device=None
                          ) -> Tuple[LossUniforms, ...]:
    gdev = generator.device
    return tuple(LossUniforms(
        torch.rand((2, num_anchors), generator=generator,
                   device=gdev).to(device),
        torch.rand((3, num_gts + cfg.train_nms_post), generator=generator,
                   device=gdev).to(device)) for _ in range(3))


def trident_loss(model: TridentFasterRCNN, batch: DetTrainBatch,
                 anchors: torch.Tensor, uniforms: Sequence[LossUniforms],
                 impl: Optional[str] = None):
    """The mean of the three branches' Faster R-CNN losses (``uniforms``:
    one ``LossUniforms`` a branch). Returns (total, {"loss": total})."""
    cfg = model.cfg
    feat = model.extract_feat(batch.img[None])
    cls, reg = model.rpn_head(feat)
    n_branch = feat.shape[0]
    total = 0.0
    for b in range(n_branch):
        ls = rpn.rpn_loss(cls[b], reg[b], anchors, batch.gt_boxes,
                          batch.gt_valid, uniforms[b].rpn, batch.img_shape)
        with torch.no_grad():  # F6
            props = rpn.rpn_proposals(
                cls[b], reg[b], anchors, batch.img_shape,
                nms_pre=cfg.train_nms_pre, nms_post=cfg.train_nms_post,
                iou_threshold=cfg.rpn_nms_iou)
        tgts = bh.bbox_targets(props.boxes, props.valid, batch.gt_boxes,
                               batch.gt_labels, batch.gt_valid,
                               uniforms[b].roi, num_classes=cfg.num_classes,
                               num_samples=cfg.num_roi_samples)
        rf = model.roi_feats(feat[b:b + 1], tgts.rois, impl=impl)
        roi = bh.bbox_loss(*model.bbox_head(rf), tgts,
                           num_classes=cfg.num_classes)
        total = total + (ls.loss_cls + ls.loss_bbox + roi.loss_cls
                         + roi.loss_bbox) / n_branch
    return total, {"loss": total}


@torch.no_grad()
def trident_detect(model: TridentFasterRCNN, img: torch.Tensor, img_shape,
                   anchors: torch.Tensor, scale_factor=None,
                   impl: Optional[str] = None) -> DetResult:
    """Faster R-CNN's test path on the middle branch alone."""
    cfg = model.cfg
    feat = model.extract_feat(img[None], branches=(TEST_BRANCH,))
    cls, reg = model.rpn_head(feat)
    props = rpn.rpn_proposals(cls[0], reg[0], anchors, img_shape,
                              nms_pre=cfg.test_nms_pre,
                              nms_post=cfg.test_nms_post,
                              iou_threshold=cfg.rpn_nms_iou)
    rf = model.roi_feats(feat, props.boxes, impl=impl)
    cls_score, bbox_pred = model.bbox_head(rf)
    return bh.bbox_decode(props.boxes, cls_score, bbox_pred, img_shape,
                          roi_valid=props.valid, scale_factor=scale_factor)


# ---------------------------------------------------------------------------
# Grid R-CNN
# ---------------------------------------------------------------------------

GRID_POINTS = 9
GRID_SIZE = 3
GRID_WHOLE = 56  # the whole map: 4 x the 14x14 roi features
GRID_HALF = GRID_WHOLE // 4 * 2  # 28, each point's sub-map
GRID_LOSS_WEIGHT = 15.0
GRID_JITTER = 0.15


def _grid_neighbors():
    """Each point's 4-neighbourhood, points in column-major order
    (i = x_idx * 3 + y_idx)."""
    nbrs = []
    for i in range(GRID_SIZE):
        for j in range(GRID_SIZE):
            n = []
            if i > 0:
                n.append((i - 1) * GRID_SIZE + j)
            if j > 0:
                n.append(i * GRID_SIZE + j - 1)
            if j < GRID_SIZE - 1:
                n.append(i * GRID_SIZE + j + 1)
            if i < GRID_SIZE - 1:
                n.append((i + 1) * GRID_SIZE + j)
            nbrs.append(tuple(n))
    return tuple(nbrs)


def _grid_sub_regions():
    """Each point's (x, y) sub-map offset in the 56x56 whole map."""
    def off(idx):
        if idx == 0:
            return 0
        if idx == GRID_SIZE - 1:
            return GRID_HALF
        return max(int((idx / (GRID_SIZE - 1) - 0.25) * GRID_WHOLE), 0)
    return tuple((off(i // GRID_SIZE), off(i % GRID_SIZE))
                 for i in range(GRID_POINTS))


GRID_NEIGHBORS = _grid_neighbors()
GRID_SUBS = _grid_sub_regions()


class GridHead(nn.Module):
    """8 convs (the first at stride 2) with GroupNorm(36) and ReLU to 9 x
    64 point features, first- and second-order neighbour fusion, then two
    grouped transposed convs (``deconv{1,2}_w``, [in, out / 9, 4, 4],
    stride 2, padding 1, groups 9) to 9 heatmaps of 28x28; in training the
    unfused features go through the same transposed convs too. NCHW
    inside; [N, 14, 14, C] in, [N, 28, 28, 9] logits out."""

    point_channels = 64

    def __init__(self, in_channels: int):
        super().__init__()
        c = self.point_channels
        co = c * GRID_POINTS
        for i in range(8):
            self.add_module(f"conv{i}", Conv2d(
                in_channels if i == 0 else co, co, 3, stride=2 if i == 0
                else 1, padding=1))
            self.add_module(f"gn{i}", nn.GroupNorm(36, co, eps=1e-5))
        for order in ("fo", "so"):
            for i, nbrs in enumerate(GRID_NEIGHBORS):
                for j in range(len(nbrs)):
                    self.add_module(f"{order}{i}_{j}_dw", Conv2d(
                        c, c, 5, padding=2, groups=c))
                    self.add_module(f"{order}{i}_{j}_pw", Conv2d(c, c, 1))
        self.gn_deconv = nn.GroupNorm(GRID_POINTS, co, eps=1e-5)
        self.deconv1_w = nn.Parameter(torch.empty(co, c, 4, 4))
        self.deconv1_b = nn.Parameter(torch.zeros(co))
        self.deconv2_w = nn.Parameter(torch.empty(co, 1, 4, 4))
        self.deconv2_b = nn.Parameter(torch.zeros(GRID_POINTS))

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        """The JAX head's normal(0.001) transposed-conv kernels, a zero
        first bias and -log(99) second (a 0.01 prior)."""
        self.deconv1_w.normal_(0.0, 0.001, generator=generator)
        self.deconv2_w.normal_(0.0, 0.001, generator=generator)
        self.deconv1_b.zero_()
        self.deconv2_b.fill_(-math.log(99.0))

    def _trans(self, t, name):
        return getattr(self, f"{name}_pw")(getattr(self, f"{name}_dw")(t))

    def _deconvs(self, feat):
        y = F.conv_transpose2d(feat, self.deconv1_w, self.deconv1_b,
                               stride=2, padding=1, groups=GRID_POINTS)
        y = F.relu(self.gn_deconv(y))
        return F.conv_transpose2d(y, self.deconv2_w, self.deconv2_b,
                                  stride=2, padding=1, groups=GRID_POINTS)

    def forward(self, roi_feats: torch.Tensor, train: bool = False):
        c = self.point_channels
        x = roi_feats.float().permute(0, 3, 1, 2)
        for i in range(8):
            x = F.relu(getattr(self, f"gn{i}")(getattr(self, f"conv{i}")(x)))
        pts = [x[:, i * c:(i + 1) * c] for i in range(GRID_POINTS)]
        x_fo = [pts[i] + sum(self._trans(pts[p], f"fo{i}_{j}")
                             for j, p in enumerate(nbrs))
                for i, nbrs in enumerate(GRID_NEIGHBORS)]
        x_so = [pts[i] + sum(self._trans(x_fo[p], f"so{i}_{j}")
                             for j, p in enumerate(nbrs))
                for i, nbrs in enumerate(GRID_NEIGHBORS)]
        fused = self._deconvs(torch.cat(x_so, 1)).permute(0, 2, 3, 1)
        if not train:
            return fused
        return fused, self._deconvs(x).permute(0, 2, 3, 1)


class GridRCNN(nn.Module):
    """``base`` (Faster R-CNN; its head classifies) and ``grid_head``."""

    def __init__(self, cfg: SelsaConfig = SelsaConfig()):
        super().__init__()
        self.cfg = cfg
        self.base = FasterRCNN(cfg)
        self.grid_head = GridHead(cfg.neck_channels)

    def roi_feats14(self, feat: torch.Tensor, rois: torch.Tensor,
                    impl: Optional[str] = None) -> torch.Tensor:
        """14x14 RoIAlign (kernel B's ``gather14x2`` on CUDA) on the f32
        map [1, h, w, C]."""
        return roi_align(feat.float().contiguous(), rois.float(),
                         1.0 / self.cfg.stride, batch_inds=_zeros(rois),
                         out_size=14, sampling_ratio=2, impl=impl)


class GridUniforms(NamedTuple):
    rpn: torch.Tensor  # [2, A]
    roi: torch.Tensor  # [3, G + train_nms_post]
    jitter: torch.Tensor  # [num_roi_samples, 4] in [-0.15, 0.15)


def draw_grid_uniforms(cfg: SelsaConfig, num_gts: int, num_anchors: int,
                       generator: torch.Generator, device=None
                       ) -> GridUniforms:
    gdev = generator.device

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=gdev).to(device)

    return GridUniforms(rand(2, num_anchors),
                        rand(3, num_gts + cfg.train_nms_post),
                        rand(cfg.num_roi_samples, 4) * (2 * GRID_JITTER)
                        - GRID_JITTER)


def grid_targets(pos_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                 pos_radius: int = 1) -> torch.Tensor:
    """grid_head.get_targets: the rois [N, 4] expanded 2x, each of the 9
    gt grid points drawn as a radius-``pos_radius`` disc on the 56x56 whole
    map (centres truncated toward zero), each point's 28x28 sub-map cut
    out; rois whose expanded side is at most 3 get none. -> [N, 28, 28,
    9] float."""
    dev = pos_boxes.device
    ex1 = pos_boxes[:, 0] - (pos_boxes[:, 2] - pos_boxes[:, 0]) / 2
    ey1 = pos_boxes[:, 1] - (pos_boxes[:, 3] - pos_boxes[:, 1]) / 2
    ex2 = pos_boxes[:, 2] + (pos_boxes[:, 2] - pos_boxes[:, 0]) / 2
    ey2 = pos_boxes[:, 3] + (pos_boxes[:, 3] - pos_boxes[:, 1]) / 2
    ws, hs = ex2 - ex1, ey2 - ey1
    fx = torch.tensor([1 - (i // GRID_SIZE) / (GRID_SIZE - 1)
                       for i in range(GRID_POINTS)], device=dev)
    fy = torch.tensor([1 - (i % GRID_SIZE) / (GRID_SIZE - 1)
                       for i in range(GRID_POINTS)], device=dev)
    gx = fx[None] * gt_boxes[:, 0:1] + (1 - fx)[None] * gt_boxes[:, 2:3]
    gy = fy[None] * gt_boxes[:, 1:2] + (1 - fy)[None] * gt_boxes[:, 3:4]
    cx = ((gx - ex1[:, None]) / ws.clamp_min(1e-6)[:, None]
          * GRID_WHOLE).to(torch.int32)
    cy = ((gy - ey1[:, None]) / hs.clamp_min(1e-6)[:, None]
          * GRID_WHOLE).to(torch.int32)
    subx = torch.tensor([sx for sx, _ in GRID_SUBS], dtype=torch.int32,
                        device=dev)
    suby = torch.tensor([sy for _, sy in GRID_SUBS], dtype=torch.int32,
                        device=dev)
    ar = torch.arange(GRID_HALF, dtype=torch.int32, device=dev)[None, :]
    xs, ys = ar + subx[:, None], ar + suby[:, None]
    d2 = ((xs[None, :, None, :] - cx[:, :, None, None]) ** 2
          + (ys[None, :, :, None] - cy[:, :, None, None]) ** 2)
    tgt = (d2 <= pos_radius * pos_radius) & ((ws > GRID_SIZE)
                                             & (hs > GRID_SIZE))[:, None,
                                                                 None, None]
    return tgt.permute(0, 2, 3, 1).float()


def grid_rcnn_loss(model: GridRCNN, batch: DetTrainBatch,
                   anchors: torch.Tensor, uniforms: GridUniforms,
                   impl: Optional[str] = None):
    """The RPN loss, the head's classification loss and the grid loss
    (no box regression loss). Returns (total, metrics)."""
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
                           num_samples=cfg.num_roi_samples)
    rf = base.roi_feats(feat, tgts.rois, _zeros(tgts.rois), impl=impl)
    roi = bh.bbox_loss(*base.bbox_forward(rf), tgts,
                       num_classes=cfg.num_classes)

    rois, off = tgts.rois, uniforms.jitter
    cxcy = (rois[:, 2:] + rois[:, :2]) / 2
    wh = (rois[:, 2:] - rois[:, :2]).abs()
    ncxcy = cxcy + wh * off[:, :2]
    nwh = wh * (1 + off[:, 2:])
    jit = torch.cat([ncxcy - nwh / 2, ncxcy + nwh / 2], dim=-1)
    h, w = batch.img_shape[0], batch.img_shape[1]
    lim = torch.stack([w - 1, h - 1, w - 1, h - 1]).float()
    jit = torch.minimum(jit.clamp_min(0.0), lim)
    grid_rois = torch.where(tgts.is_pos[:, None], jit, rois)
    fused, unfused = model.grid_head(
        model.roi_feats14(feat, grid_rois, impl=impl), train=True)
    # the matched gts: the targets decoded on the unjittered rois
    gts = delta2bbox(rois, tgts.bbox_targets, stds=bh.BBOX_STDS)
    targets = grid_targets(grid_rois, gts)
    wt = tgts.is_pos.float()
    denom = wt.sum().clamp_min(1.0) * GRID_POINTS * GRID_HALF * GRID_HALF

    def bce(hm):
        p = hm.float()
        ce = p.clamp_min(0) - p * targets + torch.log1p(torch.exp(-p.abs()))
        return (ce * wt[:, None, None, None]).sum() / denom

    loss_grid = GRID_LOSS_WEIGHT * (bce(fused) + bce(unfused))
    total = ls.loss_cls + ls.loss_bbox + roi.loss_cls + loss_grid
    return total, {"loss": total, "loss_cls": roi.loss_cls,
                   "loss_grid": loss_grid}


def grid_points_decode(heatmaps: torch.Tensor, boxes: torch.Tensor,
                       img_shape) -> torch.Tensor:
    """grid_head.get_bboxes: each point's argmax over its 28x28 sigmoid
    map (the first of equal maxima), lifted into the 56x56 whole map and
    the 2x-expanded box; each border the score-weighted mean of its 3
    points; clipped to ``img_shape``. heatmaps [N, 28, 28, 9], boxes
    [N, 4] -> [N, 4]."""
    n, hh, ww, gp = heatmaps.shape
    dev = heatmaps.device
    flat = torch.sigmoid(heatmaps.float()).permute(0, 3, 1, 2).reshape(
        n, gp, hh * ww)
    idx = flat.argmax(dim=-1)
    scores = flat.amax(dim=-1)
    subx = torch.tensor([sx for sx, _ in GRID_SUBS], dtype=torch.float32,
                        device=dev)
    suby = torch.tensor([sy for _, sy in GRID_SUBS], dtype=torch.float32,
                        device=dev)
    xs = (idx % ww).float() + subx[None]
    ys = torch.div(idx, ww, rounding_mode="floor").float() + suby[None]
    widths = (boxes[:, 2] - boxes[:, 0])[:, None]
    heights = (boxes[:, 3] - boxes[:, 1])[:, None]
    abs_x = (xs + 0.5) / ww * widths + (boxes[:, 0:1] - widths / 2)
    abs_y = (ys + 0.5) / hh * heights + (boxes[:, 1:2] - heights / 2)

    def vote(vals, inds):
        s = scores[:, inds]
        return (vals[:, inds] * s).sum(-1) / s.sum(-1).clamp_min(1e-6)

    out = torch.stack([vote(abs_x, [0, 1, 2]), vote(abs_y, [0, 3, 6]),
                       vote(abs_x, [6, 7, 8]), vote(abs_y, [2, 5, 8])], -1)
    lim = torch.stack([torch.as_tensor(img_shape[1]),
                       torch.as_tensor(img_shape[0])] * 2).float().to(dev)
    return torch.minimum(out.clamp_min(0.0), lim)


@torch.no_grad()
def grid_rcnn_detect(model: GridRCNN, img: torch.Tensor, img_shape,
                     anchors: torch.Tensor, scale_factor=None,
                     impl: Optional[str] = None) -> DetResult:
    """Proposals scored by the head without regression, multiclass NMS,
    then the grid head on the detections' 14x14 features moves their
    borders; ``scale_factor`` divides last."""
    cfg, base = model.cfg, model.base
    feat = base.extract_feat(img[None])
    cls, reg = base.rpn_forward(feat)
    props = rpn.rpn_proposals(cls[0], reg[0], anchors, img_shape,
                              nms_pre=cfg.test_nms_pre,
                              nms_post=cfg.test_nms_post,
                              iou_threshold=cfg.rpn_nms_iou)
    rf = base.roi_feats(feat, props.boxes, _zeros(props.boxes), impl=impl)
    cls_score, _ = base.bbox_forward(rf)
    dets = nms_ops.multiclass_nms(props.boxes,
                                  torch.softmax(cls_score.float(), dim=-1),
                                  1e-4, 0.5, 100, box_valid=props.valid)
    grids = model.grid_head(model.roi_feats14(feat, dets.boxes, impl=impl))
    boxes = grid_points_decode(grids, dets.boxes, img_shape)
    if scale_factor is not None:
        boxes = boxes / torch.as_tensor(scale_factor, dtype=boxes.dtype,
                                        device=boxes.device)
    return dets._replace(boxes=boxes)


# ---------------------------------------------------------------------------
# Mask Scoring R-CNN


class MaskIoUHead(nn.Module):
    """[14x14 mask features ++ the class-max of the 28x28 prediction resized
    to 14x14] -> 2 convs (128; the second stride 2) -> fc0 (256) ->
    ``fc_iou`` (a predicted IoU a class), f32."""

    def __init__(self, in_channels: int, num_classes: int = 80):
        super().__init__()
        self.conv0 = Conv2d(in_channels + 1, 128, 3, padding=1)
        self.conv1 = Conv2d(128, 128, 3, stride=2, padding=1)
        half = (ROI_SIZE + 1) // 2
        self.fc0 = Linear(half * half * 128, 256)
        self.fc_iou = Linear(256, num_classes)

    @staticmethod
    def resize_pred(mask_pred: torch.Tensor) -> torch.Tensor:
        """``jax.image.resize(mask_pred, (N, 14, 14, C), "linear")``: the
        triangle kernel widened by 2 (antialiased)."""
        s = mask_pred.shape[1]
        one = torch.ones((), device=mask_pred.device)
        wy = weight_matrix(s, ROI_SIZE, one * (ROI_SIZE / s), one * 0.0)
        wx = weight_matrix(mask_pred.shape[2], ROI_SIZE,
                           one * (ROI_SIZE / mask_pred.shape[2]), one * 0.0)
        return torch.einsum("ph,nhwc,qw->npqc", wy, mask_pred.float(), wx)

    def forward(self, mask_feats: torch.Tensor,
                mask_pred: torch.Tensor) -> torch.Tensor:
        pred_max = self.resize_pred(mask_pred).amax(-1, keepdim=True)
        x = torch.cat([mask_feats.float(), pred_max], -1).permute(0, 3, 1, 2)
        x = F.relu(self.conv1(F.relu(self.conv0(x))))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.fc_iou(F.relu(self.fc0(x)))


class MaskScoringRCNN(nn.Module):
    """``mask_rcnn`` (Mask R-CNN) and ``maskiou_head``."""

    def __init__(self, cfg: SelsaConfig = SelsaConfig()):
        super().__init__()
        self.cfg = cfg
        self.mask_rcnn = MaskRCNN(cfg)
        self.maskiou_head = MaskIoUHead(cfg.neck_channels, cfg.num_classes)


def mask_scoring_loss(model: MaskScoringRCNN, batch: MaskTrainBatch,
                      anchors: torch.Tensor, uniforms: LossUniforms,
                      impl: Optional[str] = None):
    """Mask R-CNN's losses and 0.5 x the squared error of the positives'
    predicted IoU (their class) against the IoU of their binarised mask
    with the whole gt (``mask_iou_targets``). Returns (total, metrics)."""
    cfg = model.cfg
    p = mask_rcnn_parts(model.mask_rcnn, batch, anchors, uniforms, impl)
    miou_pred = model.maskiou_head(p.mask_feats, p.mask_logits)
    labels = p.tgts.labels
    pred_bin = (torch.sigmoid(class_channel(p.mask_logits, labels))
                > 0.5).float()
    actual = mask_iou_targets(pred_bin, (p.mask_tgts > 0.5).float(),
                              batch.gt_masks, p.matched, p.tgts.rois)
    miou_c = torch.gather(miou_pred, 1, labels.clamp(
        0, cfg.num_classes - 1)[:, None])[:, 0]
    wt = p.tgts.is_pos.float()
    loss_miou = 0.5 * (wt * (miou_c - actual) ** 2).sum() / \
        wt.sum().clamp_min(1.0)
    total = p.total + loss_miou
    metrics = dict(p.metrics, loss=total, loss_mask_iou=loss_miou)
    return total, metrics


@torch.no_grad()
def mask_scoring_boxes(model: MaskScoringRCNN, img: torch.Tensor, img_shape,
                       anchors: torch.Tensor, scale_factor=None,
                       impl: Optional[str] = None):
    """Mask R-CNN's detections, each score times its predicted IoU
    (clipped to [0, 1]), and their mask logits: (DetResult, logits)."""
    cfg = model.cfg
    dets, _, mf, logits = mask_rcnn_boxes(model.mask_rcnn, img, img_shape,
                                          anchors, scale_factor, impl)
    miou = model.maskiou_head(mf, logits)
    iou_c = torch.gather(miou, 1, dets.labels.clamp(
        0, cfg.num_classes - 1)[:, None])[:, 0]
    scores = dets.scores * iou_c.clamp(0.0, 1.0)
    return DetResult(dets.boxes, scores, dets.labels, dets.valid), logits


@torch.no_grad()
def mask_scoring_detect(model: MaskScoringRCNN, img: torch.Tensor, img_shape,
                        anchors: torch.Tensor, scale_factor=None,
                        impl: Optional[str] = None):
    """``mask_scoring_boxes``' detections and their pasted masks:
    (DetResult, masks)."""
    dets, logits = mask_scoring_boxes(model, img, img_shape, anchors,
                                      scale_factor, impl)
    return dets, paste_masks(torch.sigmoid(class_channel(logits, dets.labels)),
                             dets.boxes, model.cfg.pad_h, model.cfg.pad_w)


# ---------------------------------------------------------------------------
# PointRend

POINT_RES = 49


class PointHead(nn.Module):
    """An MLP over [fine point feature ++ coarse logits]: ``fc{0,1,2}``
    (256, the coarse logits appended after each), ``fc_logits``."""

    def __init__(self, in_channels: int, num_classes: int = 80):
        super().__init__()
        self.fc0 = Linear(in_channels + num_classes, 256)
        self.fc1 = Linear(256 + num_classes, 256)
        self.fc2 = Linear(256 + num_classes, 256)
        self.fc_logits = Linear(256 + num_classes, num_classes)

    def forward(self, fine: torch.Tensor,
                coarse: torch.Tensor) -> torch.Tensor:
        x = torch.cat([fine, coarse], -1)
        for i in range(3):
            x = torch.cat([F.relu(getattr(self, f"fc{i}")(x)), coarse], -1)
        return self.fc_logits(x)


def uncertain_point_indices(mask_pred: torch.Tensor,
                            labels: Optional[torch.Tensor],
                            num_points: int):
    """The ``num_points`` most uncertain cells of each roi: -|logit| of its
    class channel (the max channel without ``labels``), ``lax.top_k``'s
    order (descending, the lower index first among equal values).
    mask_pred [N, mh, mw, C] -> (idx [N, P], uncertainty [N, mh * mw])."""
    n, mh, mw, c = mask_pred.shape
    flat = mask_pred.reshape(n, mh * mw, c)
    if labels is None:
        logit = flat.amax(-1)
    else:
        logit = torch.gather(flat, 2, labels.clamp(0, c - 1)[:, None, None]
                             .expand(n, mh * mw, 1))[..., 0]
    unc = -logit.abs()
    return top_k_stable(unc, num_points)[1], unc


class PointRendRCNN(nn.Module):
    """``mask_rcnn`` (Mask R-CNN) and ``point_head``."""

    def __init__(self, cfg: SelsaConfig = SelsaConfig(),
                 num_points: int = POINT_RES):
        super().__init__()
        self.cfg = cfg
        self.num_points = num_points
        self.mask_rcnn = MaskRCNN(cfg)
        self.point_head = PointHead(cfg.neck_channels, cfg.num_classes)

    def refine(self, feat: torch.Tensor, rois: torch.Tensor,
               mask_pred: torch.Tensor, labels=None):
        """The coarse logits [N, mh, mw, C] refined at each roi's most
        uncertain cells: the point head on the map's sample at the cell's
        centre (normalised to the padded image) and the coarse logits
        there. feat [1, h, w, C]. -> (refined logits, idx [N, P])."""
        n, mh, mw, c = mask_pred.shape
        flat = mask_pred.reshape(n, mh * mw, c)
        idx, _ = uncertain_point_indices(mask_pred, labels, self.num_points)
        py = (torch.div(idx, mw, rounding_mode="floor") + 0.5) / mh
        px = (idx % mw + 0.5) / mw
        r = rois.float()
        gx = r[:, 0:1] + px * (r[:, 2:3] - r[:, 0:1])
        gy = r[:, 1:2] + py * (r[:, 3:4] - r[:, 1:2])
        pts = torch.stack([gx / self.cfg.pad_w, gy / self.cfg.pad_h], -1)
        fine = point_sample(feat[0].float(), pts)  # [N, P, C]
        gidx = idx[..., None].expand(n, idx.shape[1], c)
        coarse = torch.gather(flat, 1, gidx)
        refined = self.point_head(fine, coarse)
        return torch.scatter(flat, 1, gidx, refined).reshape(
            n, mh, mw, c), idx


def point_rend_loss(model: PointRendRCNN, batch: MaskTrainBatch,
                    anchors: torch.Tensor, uniforms: LossUniforms,
                    impl: Optional[str] = None):
    """Mask R-CNN's losses and the BCE of the refined logits at the points
    (the rois' class, positives only). Returns (total, metrics)."""
    cfg = model.cfg
    p = mask_rcnn_parts(model.mask_rcnn, batch, anchors, uniforms, impl)
    labels = p.tgts.labels
    refined, idx = model.refine(p.feat, p.tgts.rois, p.mask_logits, labels)
    n = refined.shape[0]
    flat_r = refined.reshape(n, -1, cfg.num_classes)
    cls_idx = labels.clamp(0, cfg.num_classes - 1)
    x = torch.gather(torch.gather(
        flat_r, 1, idx[..., None].expand(n, idx.shape[1], cfg.num_classes)),
        2, cls_idx[:, None, None].expand(n, idx.shape[1], 1))[..., 0]
    t = torch.gather(p.mask_tgts.reshape(n, -1), 1, idx)
    wt = p.tgts.is_pos.float()[:, None]
    bce = x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))
    loss_pt = (bce * wt).sum() / (wt.sum() * idx.shape[1]).clamp_min(1.0)
    total = p.total + loss_pt
    metrics = dict(p.metrics, loss=total, loss_point=loss_pt)
    return total, metrics


@torch.no_grad()
def point_rend_detect(model: PointRendRCNN, img: torch.Tensor, img_shape,
                      anchors: torch.Tensor, scale_factor=None,
                      impl: Optional[str] = None):
    """Mask R-CNN's detections, their masks refined at the uncertain
    points of their class and pasted at the bucket's size."""
    cfg = model.cfg
    dets, feat, _, logits = mask_rcnn_boxes(model.mask_rcnn, img, img_shape,
                                            anchors, scale_factor, impl)
    refined, _ = model.refine(feat, dets.boxes, logits, dets.labels)
    probs = torch.sigmoid(class_channel(refined, dets.labels))
    return dets, paste_masks(probs, dets.boxes, cfg.pad_h, cfg.pad_w)
