"""FPN Faster R-CNN (mmdet's ``faster_rcnn_r50_fpn`` trunk) and its GA-RPN,
GRoIE and Libra R-CNN variants, the counterpart of the JAX package's
``models/detectors/fpn_faster_rcnn.py``: ResNet C2-C5 -> FPN (256 channels,
5 levels, the fifth by max pool) [-> BFP with a non-local refine,
``with_bfp``] -> the RPN on every level (3 anchors a position: scale 8,
ratios 0.5 / 1 / 2, strides 4-64) or GA-RPN (``rpn_type="ga"``) ->
RoIAlign 7x7 on the level each roi's scale maps to (``map_roi_levels``,
finest scale 56) or on every level through GRoIE
(``roi_extract="groie"``) -> the Shared2FC head. Libra R-CNN's RoI recipe
is the loss's ``sampler="iou_balanced"`` and ``reg_loss="balanced_l1"``.

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

GRoIE (``GenericRoIExtractor``) pools every roi on each of P2-P5 (four
kernel B launches), passes each level's result through one shared 5x5
``pre_module`` and a ReLU, sums them and refines the sum with
``GeneralizedAttention`` (attention type '0100', 6 heads, key stride 2:
the query content against separable sinusoidal x / y position terms), all
in float32. GA-RPN (``GARPNHead``) adapts each level's features with a
deformable 3x3 conv (``guided_anchor_head.AdaptiveDCN``: kernel E forward,
F and G backward) whose offsets a 1x1 ``offset_conv`` learns from the
detached shape prediction; its proposals are each level's loc-masked top
1000 decoded on the guided anchors, an NMS a level, then the global top.
BFP runs in float32. Proposals carry no gradient, as in the original
(ROADMAP fault F6).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import assigners, boxes as box_ops, losses, nms as nms_ops
from ...core.anchors import AnchorGenerator
from ...core.nms import DetResult
from ...ops.roi_align import roi_align
from ..aggregators.selsa_aggregator import Linear
from ..backbones.resnet import Conv2d, ResNet
from ..dense_heads import guided_anchor_head as GA
from ..dense_heads import rpn_head as rpn
from ..dense_heads.retina_head import PRIOR_BIAS, top_k_stable
from ..necks.extra_necks import BFP
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
# the ga_rpn config
GA_RPN_OCTAVE = 8
GA_RPN_SQUARE = 8.0
GA_RPN_ANCHOR_STDS = (0.07, 0.07, 0.14, 0.14)
GA_RPN_BBOX_STDS = (0.07, 0.07, 0.11, 0.11)
GA_RPN_NMS_PRE = 1000
# the RoI samplers' uniforms a candidate: (pos, neg, tiebreak) for the
# random sampler; (pos, neg bins, refill, tiebreak) for Libra's
SAMPLER_ROWS = {"random": 3, "iou_balanced": 4}


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


def _pos_embed(rel: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding [R, dim] of relative offsets [R]."""
    d = dim // 2
    freq = torch.exp(torch.arange(d, dtype=torch.float32, device=rel.device)
                     * (-math.log(10000.0) / max(d - 1, 1)))
    ang = rel[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


class GeneralizedAttention(nn.Module):
    """mmcv's GeneralizedAttention as the JAX package forms it for GRoIE's
    post module: attention type '0100' (the query content against the
    relative position: separable x / y sinusoids, one projection each, the
    only type built), 6 heads, key stride 2. The output is the input plus
    a 1x1 projection of the attended values. flax names: ``query_conv``,
    ``appr_geom_fc_{x,y}``, ``value_conv``, ``proj_conv``."""

    num_heads = 6
    kv_stride = 2
    pos_dim = 64

    def __init__(self, in_channels: int = 256, dtype=torch.float32):
        super().__init__()
        self.dk = in_channels // self.num_heads
        qk_c = self.dk * self.num_heads
        self.query_conv = Conv2d(in_channels, qk_c, 1, bias=False,
                                 dtype=dtype)
        self.appr_geom_fc_x = Linear(self.pos_dim, qk_c, bias=False,
                                     dtype=dtype)
        self.appr_geom_fc_y = Linear(self.pos_dim, qk_c, bias=False,
                                     dtype=dtype)
        self.value_conv = Conv2d(in_channels, qk_c, 1, bias=False,
                                 dtype=dtype)
        self.proj_conv = Conv2d(qk_c, in_channels, 1, dtype=dtype)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        """[N, heads * dk, h, w] -> [N, heads, h * w, dk]."""
        n, _, h, w = t.shape
        return t.float().reshape(n, self.num_heads, self.dk,
                                 h * w).transpose(2, 3)

    def _geometry(self, size: int, fc: nn.Module) -> torch.Tensor:
        """The projected embedding of each (query, key) offset along one
        axis of ``size`` -> [size, keys, heads, dk]."""
        dev = fc.weight.device
        s = self.kv_stride
        rel = (torch.arange(size, device=dev)[:, None]
               - torch.arange(0, size, s, device=dev)[None, :])
        e = fc(_pos_embed(rel.reshape(-1).float(), self.pos_dim))
        return e.float().reshape(size, -1, self.num_heads, self.dk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, C, H, W] -> [N, C, H, W] (residual)."""
        n, _, h, w = x.shape
        heads, dk = self.num_heads, self.dk
        xkv = x[:, :, ::self.kv_stride, ::self.kv_stride]
        kh, kw = xkv.shape[-2:]
        qg = self._heads(self.query_conv(x)).reshape(n, heads, h, w, dk)
        lx = torch.einsum("nhywd,wvhd->nhywv", qg,
                          self._geometry(w, self.appr_geom_fc_x))
        ly = torch.einsum("nhywd,yuhd->nhywu", qg,
                          self._geometry(h, self.appr_geom_fc_y))
        logits = (lx[:, :, :, :, None, :] + ly[:, :, :, :, :, None]
                  ).reshape(n, heads, h * w, kh * kw) / math.sqrt(float(dk))
        attn = torch.softmax(logits, dim=-1)
        out = torch.matmul(attn, self._heads(self.value_conv(xkv)))
        out = out.transpose(2, 3).reshape(n, heads * dk, h, w)
        return x + self.proj_conv(out).to(x.dtype)


class GenericRoIExtractor(nn.Module):
    """GRoIE: every roi pooled (7x7, sampling ratio 2) on each of the
    ``num_levels`` finest maps, each through the shared 5x5
    ``pre_module`` and a ReLU, summed, then ``post_module``
    (``GeneralizedAttention``)."""

    def __init__(self, out_channels: int = 256, num_levels: int = 4,
                 out_size: int = 7, dtype=torch.float32):
        super().__init__()
        self.num_levels, self.out_size = num_levels, out_size
        self.pre_module = Conv2d(out_channels, out_channels, 5, padding=2,
                                 dtype=dtype)
        self.post_module = GeneralizedAttention(out_channels, dtype=dtype)

    def forward(self, level_feats: Sequence[torch.Tensor], rois: torch.Tensor,
                impl: Optional[str] = None) -> torch.Tensor:
        """level_feats per level [1, h, w, C] (P2 first), rois [N, 4] ->
        [N, out_size, out_size, C] float32."""
        binds = torch.zeros(rois.shape[0], dtype=torch.int64,
                            device=rois.device)
        acc = None
        for i in range(self.num_levels):
            rf = roi_align(level_feats[i].float().contiguous(), rois,
                           1.0 / FPN_STRIDES[i], batch_inds=binds,
                           out_size=self.out_size, sampling_ratio=2,
                           impl=impl)
            rf = F.relu(self.pre_module(rf.permute(0, 3, 1, 2)))
            acc = rf if acc is None else acc + rf
        return self.post_module(acc.float()).permute(0, 2, 3, 1)


class GARPNHead(nn.Module):
    """GA-RPN's head on every level: a 3x3 ``rpn_conv`` and ReLU, a 1x1
    ``conv_loc`` (anchor presence) and ``conv_shape`` ((dw, dh)), a 1x1
    ``offset_conv`` on the detached shape giving the 18 offsets of the
    deformable ``feature_adaption``, then 1x1 ``conv_cls`` and
    ``conv_reg`` on the adapted features."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 dtype=torch.bfloat16):
        super().__init__()
        self.rpn_conv = Conv2d(in_channels, feat_channels, 3, padding=1,
                               dtype=dtype)
        self.conv_loc = Conv2d(feat_channels, 1, 1, dtype=dtype)
        self.conv_shape = Conv2d(feat_channels, 2, 1, dtype=dtype)
        self.offset_conv = Conv2d(2, 18, 1, bias=False, dtype=dtype)
        self.feature_adaption = GA.AdaptiveDCN(feat_channels, feat_channels)
        self.conv_cls = Conv2d(feat_channels, 1, 1, dtype=dtype)
        self.conv_reg = Conv2d(feat_channels, 4, 1, dtype=dtype)

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        """The prior biases of ``conv_loc`` and ``conv_cls``."""
        self.conv_loc.bias.fill_(PRIOR_BIAS)
        self.conv_cls.bias.fill_(PRIOR_BIAS)

    def forward(self, feats: Sequence[torch.Tensor],
                impl: Optional[str] = None):
        """NHWC maps [N, h, w, C] -> per level (cls [N, h, w, 1], reg
        [N, h, w, 4], shape [N, h, w, 2], loc [N, h, w, 1]), float32."""
        outs = []
        for f in feats:
            x = F.relu(self.rpn_conv(f.permute(0, 3, 1, 2)))
            loc = self.conv_loc(x).float()
            shape = self.conv_shape(x).float()
            off = self.offset_conv(shape.detach()).float()
            xa = F.relu(self.feature_adaption(x, off, impl=impl))
            outs.append(tuple(t.float().permute(0, 2, 3, 1) for t in (
                self.conv_cls(xa), self.conv_reg(xa), shape, loc)))
        return outs


def ga_rpn_squares(featmap_sizes, device=None) -> torch.Tensor:
    """GA-RPN's squares (scale 8, ratio 1), every level [A, 4]."""
    return GA.cached_anchors(featmap_sizes, FPN_STRIDES, device,
                             ratios=(1.0,), scales=(GA_RPN_SQUARE,))


def ga_rpn_approx_overlaps(gt_boxes: torch.Tensor, featmap_sizes
                           ) -> torch.Tensor:
    """Every gt's IoU with each square's 9 octave anchors (base scale 8),
    maxed -> [G, squares]."""
    return GA.max_over_octaves(gt_boxes, GA.cached_anchors(
        featmap_sizes, FPN_STRIDES, gt_boxes.device, ratios=GA.GA_RATIOS,
        octave_base_scale=GA_RPN_OCTAVE,
        scales_per_octave=GA.GA_SCALES_PER_OCTAVE))


def ga_rpn_guided_anchors(shape_pred: torch.Tensor, stride: float, h: int,
                          w: int) -> torch.Tensor:
    """GA-RPN's guided anchors [h * w, 4]: the scale-8 square of each cell
    with sides scaled by exp(dw * 0.14), exp(dh * 0.14)."""
    cy, cx = GA._grid(stride, h, w, shape_pred.device)
    s = GA_RPN_SQUARE * stride
    aw = s * torch.exp(shape_pred[..., 0] * GA_RPN_ANCHOR_STDS[2])
    ah = s * torch.exp(shape_pred[..., 1] * GA_RPN_ANCHOR_STDS[3])
    return GA._centred(cx, cy, aw, ah)


class GARPNLossOut(NamedTuple):
    loss_cls: torch.Tensor
    loss_bbox: torch.Tensor
    loss_shape: torch.Tensor
    loss_loc: torch.Tensor


def ga_rpn_loss(level_outs, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                uniforms: torch.Tensor) -> GARPNLossOut:
    """GA-RPN's loss on one image's level outputs: the loc focal loss
    (``ga_loc_targets`` at octave base scale 8), the shape loss under
    ApproxMaxIoU (0.7 / 0.3 / 0.3), and on the guided anchors the binary
    cross entropy and SmoothL1 (beta 1, stds 0.07 / 0.11) of the RPN
    assigner (0.7 / 0.3 / 0.3) and 256 anchors sampled at half positives
    in the order of ``uniforms`` [2, anchors]."""
    sizes = GA._sizes(level_outs)
    dev = gt_boxes.device
    gt_labels = torch.zeros(gt_boxes.shape[0], dtype=torch.int64, device=dev)
    loc_pairs, loc_avg = GA.ga_loc_targets(gt_boxes, gt_valid, sizes,
                                           FPN_STRIDES, GA_RPN_OCTAVE)
    loss_loc = GA.loc_focal_loss(loc_pairs, loc_avg, level_outs)
    shape_all = torch.cat([s.reshape(-1, 2).float()
                           for _, _, s, _ in level_outs])
    sh_assign = assigners.max_iou_assign(
        None, gt_boxes, gt_labels, gt_valid, 0.7, 0.3, min_pos_iou=0.3,
        overlaps=ga_rpn_approx_overlaps(gt_boxes, sizes))
    loss_shape = GA.shape_loss(ga_rpn_squares(sizes, dev), shape_all,
                               gt_boxes, sh_assign, GA_RPN_ANCHOR_STDS[2],
                               GA_RPN_ANCHOR_STDS[3])
    cls_all = torch.cat([c.reshape(-1).float() for c, _, _, _ in level_outs])
    reg_all = torch.cat([r.reshape(-1, 4).float()
                         for _, r, _, _ in level_outs])
    anchors = torch.cat([
        ga_rpn_guided_anchors(s.reshape(h, w, 2), FPN_STRIDES[li], h,
                              w).detach()
        for li, ((_, _, s, _), (h, w)) in enumerate(zip(level_outs, sizes))])
    assign = assigners.max_iou_assign(anchors, gt_boxes, gt_labels, gt_valid,
                                      0.7, 0.3, min_pos_iou=0.3)
    sample = assigners.random_sample_masks(assign, uniforms, 256, 0.5)
    pos = sample.pos_mask
    sel = (pos | sample.neg_mask).float()
    avg = sel.sum().clamp_min(1.0)
    loss_cls = (losses.binary_cross_entropy(cls_all, pos.float(),
                                            weight=sel, avg_factor=avg))
    g = gt_boxes.shape[0]
    matched = gt_boxes[(assign.assigned_gt_inds - 1).clamp(0, g - 1)]
    tgt = box_ops.bbox2delta(anchors, matched, stds=GA_RPN_BBOX_STDS)
    loss_bbox = losses.smooth_l1_loss(reg_all, tgt, beta=1.0,
                                      weight=pos[:, None].float(),
                                      avg_factor=avg)
    return GARPNLossOut(loss_cls, loss_bbox, loss_shape, loss_loc)


@torch.no_grad()
def ga_rpn_proposals(level_outs, img_shape, nms_post: int = 300
                     ) -> rpn.Proposals:
    """GA-RPN's proposals: per level the sigmoid scores of the cells whose
    anchor presence passes GA_LOC_THR (the others 0), the top
    GA_RPN_NMS_PRE decoded on the guided anchors (stds 0.07 / 0.11) and
    clipped, an NMS at IoU 0.7 a level (``nms_post`` kept at most), then
    the global top ``nms_post``, valid where the score is above 0."""
    all_boxes, all_scores = [], []
    for li, (cls, reg, shape, loc) in enumerate(level_outs):
        h, w = cls.shape[-3], cls.shape[-2]
        anc = ga_rpn_guided_anchors(shape.reshape(h, w, 2), FPN_STRIDES[li],
                                    h, w)
        keep = torch.sigmoid(loc.reshape(-1)) >= GA.GA_LOC_THR
        scores = torch.sigmoid(cls.reshape(-1)) * keep
        deltas = reg.reshape(-1, 4).float()
        k = min(GA_RPN_NMS_PRE, scores.shape[0])
        top_s, top_i = top_k_stable(scores, k)
        decoded = box_ops.delta2bbox(anc[top_i], deltas[top_i],
                                     stds=GA_RPN_BBOX_STDS,
                                     max_shape=img_shape)
        res = nms_ops.nms_fixed(decoded, top_s, RPN_NMS_IOU,
                                min(nms_post, k))
        all_boxes.append(res.boxes)
        all_scores.append(torch.where(res.valid, res.scores, -1.0))
    boxes = torch.cat(all_boxes)
    scores = torch.cat(all_scores)
    top_s, top_i = top_k_stable(scores, min(nms_post, scores.shape[0]))
    return rpn.Proposals(boxes[top_i], top_s, top_s > 0)


class FPNFasterRCNN(nn.Module):
    """ResNet + FPN (+ BFP) + (RPN | GA-RPN) + (level-dispatched RoIAlign |
    GRoIE) + Shared2FC head, with the JAX module's fields. ``dtype`` is the
    trunk's compute dtype; BFP, GRoIE and the bbox head compute in
    float32."""

    def __init__(self, num_classes: int = 80, depth: int = 50,
                 rpn_type: str = "rpn", roi_extract: str = "single",
                 with_bfp: bool = False, pad_h: int = 800, pad_w: int = 1344,
                 train_nms_post: int = 600, test_nms_post: int = 300,
                 num_roi_samples: int = 256, dtype=torch.bfloat16):
        super().__init__()
        if rpn_type not in ("rpn", "ga") or roi_extract not in ("single",
                                                                "groie"):
            raise ValueError(f"rpn_type {rpn_type!r} (rpn, ga), roi_extract "
                             f"{roi_extract!r} (single, groie)")
        self.num_classes = num_classes
        self.rpn_type, self.roi_extract = rpn_type, roi_extract
        self.with_bfp = with_bfp
        self.pad_h, self.pad_w = pad_h, pad_w
        self.train_nms_post, self.test_nms_post = train_nms_post, test_nms_post
        self.num_roi_samples = num_roi_samples
        self.compute_dtype = dtype
        self.backbone = ResNet(depth=depth, out_indices=(0, 1, 2, 3),
                               frozen_stages=1, dtype=dtype)
        self.neck = FPN((256, 512, 1024, 2048), 256, 5, "maxpool",
                        dtype=dtype)
        if with_bfp:
            self.bfp = BFP(256, dtype=torch.float32)
        if rpn_type == "ga":
            self.rpn_head = GARPNHead(256, 256, dtype=dtype)
        else:
            self.rpn_head = rpn.RPNHead(256, 256, 3, dtype=dtype)
        if roi_extract == "groie":
            self.roi_extractor = GenericRoIExtractor(256,
                                                     dtype=torch.float32)
        self.bbox_head = bh.Shared2FCBBoxHead(
            7 * 7 * 256, num_classes, dtype=torch.float32, with_selsa=False)
        self.anchor_gen = fpn_anchor_gen()
        self._anchors: Dict[tuple, List[torch.Tensor]] = {}

    def extract_feat(self, imgs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """imgs [T, H, W, 3] normalized -> 5 NHWC maps [T, h, w, 256]."""
        feats = self.neck(self.backbone(imgs.permute(0, 3, 1, 2)))
        if self.with_bfp:
            feats = self.bfp(feats)
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

    def rpn_forward(self, feats: Sequence[torch.Tensor],
                    impl: Optional[str] = None):
        """Per level (cls [T, h, w, 3], reg [T, h, w, 12]); GA-RPN: (cls,
        reg, shape, loc)."""
        if self.rpn_type == "ga":
            return self.rpn_head(feats, impl=impl)
        return [self.rpn_head(f) for f in feats]

    def roi_feats(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                  impl: Optional[str] = None) -> torch.Tensor:
        if self.roi_extract == "groie":
            return self.roi_extractor(feats[:NUM_ROI_LEVELS], rois,
                                      impl=impl)
        return multilevel_roi_align(feats[:NUM_ROI_LEVELS], rois, impl=impl)

    def bbox_forward(self, roi_feats: torch.Tensor):
        return self.bbox_head(roi_feats)


def num_rpn_anchors(model: FPNFasterRCNN, feats, outs) -> int:
    """The RPN sampler's candidates: every anchor, or for GA-RPN every
    cell, of every level."""
    if model.rpn_type == "ga":
        return sum(c.shape[-3] * c.shape[-2] for c, _, _, _ in outs)
    return sum(a.shape[0] for a in model.anchors(feats))


def draw_fpn_uniforms(model: FPNFasterRCNN, num_gts: int, num_anchors: int,
                      generator: torch.Generator, device=None,
                      sampler: str = "random") -> LossUniforms:
    """The samplers' uniforms: the RPN's over every anchor of every level
    [2, N], the RoI head's over the gts and the train proposals
    [SAMPLER_ROWS[sampler], G + P] (``core/assigners.py``)."""
    gdev = generator.device
    return LossUniforms(
        torch.rand((2, num_anchors), generator=generator,
                   device=gdev).to(device),
        torch.rand((SAMPLER_ROWS[sampler], num_gts + model.train_nms_post),
                   generator=generator, device=gdev).to(device))


def _proposals(model: FPNFasterRCNN, outs, anchors, img_shape, train: bool):
    post = model.train_nms_post if train else model.test_nms_post
    if model.rpn_type == "ga":
        return ga_rpn_proposals([tuple(t[0] for t in o) for o in outs],
                                img_shape, nms_post=post)
    return rpn.rpn_proposals(
        [c[0] for c, _ in outs], [r[0] for _, r in outs], anchors, img_shape,
        nms_pre=RPN_NMS_PRE, nms_post=post, iou_threshold=RPN_NMS_IOU)


def fpn_faster_rcnn_loss(model: FPNFasterRCNN, batch,
                         generator: Optional[torch.Generator] = None,
                         uniforms: Optional[LossUniforms] = None,
                         impl: Optional[str] = None, sampler: str = "random",
                         reg_loss: str = "smooth_l1"):
    """Single-image training loss (``batch`` a ``DetTrainBatch``): the RPN
    (or GA-RPN) loss over every level, the train proposals (no gradient),
    the gts and proposals assigned at IoU 0.5 (GA-RPN: 0.6) and
    ``num_roi_samples`` sampled at a quarter positives (``sampler``
    "random", or Libra's "iou_balanced"), the rois' features, softmax cross
    entropy and SmoothL1 (beta 1; or ``reg_loss="balanced_l1"``) with stds
    0.1 / 0.2 over the sample. The samplers use ``uniforms``, or else draw
    them from ``generator``. Returns (total, metrics)."""
    if sampler not in SAMPLER_ROWS or reg_loss not in ("smooth_l1",
                                                       "balanced_l1"):
        raise ValueError(f"sampler {sampler!r}, reg_loss {reg_loss!r}")
    feats = model.extract_feat(batch.img[None])
    outs = model.rpn_forward(feats, impl=impl)
    ga = model.rpn_type == "ga"
    anchors = None if ga else model.anchors(feats)
    gt_boxes, gt_labels, gt_valid = (batch.gt_boxes, batch.gt_labels,
                                     batch.gt_valid)
    if uniforms is None:
        if generator is None:
            raise ValueError("pass uniforms or a generator")
        uniforms = draw_fpn_uniforms(model, gt_boxes.shape[0],
                                     num_rpn_anchors(model, feats, outs),
                                     generator, gt_boxes.device, sampler)
    if ga:
        ls = ga_rpn_loss([tuple(t[0] for t in o) for o in outs], gt_boxes,
                         gt_valid, uniforms.rpn)
        rpn_metrics = {"loss_rpn_cls": ls.loss_cls,
                       "loss_rpn_bbox": ls.loss_bbox,
                       "loss_anchor_shape": ls.loss_shape,
                       "loss_anchor_loc": ls.loss_loc}
    else:
        ls = rpn.rpn_loss([c[0] for c, _ in outs], [r[0] for _, r in outs],
                          anchors, gt_boxes, gt_valid, uniforms.rpn,
                          batch.img_shape)
        rpn_metrics = {"loss_rpn_cls": ls.loss_cls,
                       "loss_rpn_bbox": ls.loss_bbox}
    rpn_total = sum(rpn_metrics.values())
    with torch.no_grad():  # F6: no gradient through the proposals
        props = _proposals(model, outs, anchors, batch.img_shape, True)
    cand = torch.cat([gt_boxes, props.boxes])
    cand_valid = torch.cat([gt_valid, props.valid])
    pos_thr = 0.6 if ga else 0.5
    assign = assigners.max_iou_assign(cand, gt_boxes, gt_labels, gt_valid,
                                      pos_thr, pos_thr, pos_thr,
                                      box_valid=cand_valid)
    if sampler == "iou_balanced":
        sample = assigners.iou_balanced_sample_gather(
            assign, uniforms.roi, model.num_roi_samples, 0.25)
    else:
        sample = assigners.random_sample_gather(
            assign, uniforms.roi, model.num_roi_samples, 0.25)
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
    if reg_loss == "balanced_l1":
        loss_bbox = losses.balanced_l1_loss(pred, tgt,
                                            weight=pos[:, None].float(),
                                            avg_factor=avg)
    else:
        loss_bbox = losses.smooth_l1_loss(pred, tgt, beta=1.0,
                                          weight=pos[:, None].float(),
                                          avg_factor=avg)
    total = rpn_total + loss_cls + loss_bbox
    metrics = {"loss": total, "loss_cls": loss_cls, "loss_bbox": loss_bbox}
    metrics.update(rpn_metrics)
    return total, metrics


@torch.no_grad()
def fpn_faster_rcnn_detect(model: FPNFasterRCNN, img: torch.Tensor,
                           img_shape, scale_factor=None,
                           impl: Optional[str] = None) -> DetResult:
    """Single-image inference, img [H, W, 3] -> fixed-shape detections
    [100]: the test proposals, their features, the head, the decode (stds
    0.1 / 0.2) divided by ``scale_factor``."""
    feats = model.extract_feat(img[None])
    outs = model.rpn_forward(feats, impl=impl)
    anchors = None if model.rpn_type == "ga" else model.anchors(feats)
    props = _proposals(model, outs, anchors, img_shape, False)
    rf = model.roi_feats(feats, props.boxes, impl=impl)
    cls_score, bbox_pred = model.bbox_forward(rf)
    return bh.bbox_decode(props.boxes, cls_score, bbox_pred, img_shape,
                          roi_valid=props.valid, scale_factor=scale_factor,
                          stds=FPN_BBOX_STDS)
