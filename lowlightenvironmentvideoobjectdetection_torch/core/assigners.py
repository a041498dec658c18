"""Target assignment and random sampling with static shapes, the
counterpart of the JAX package's ``core/assigners.py`` (``max_iou_assign``,
``point_assign``, ``center_region_assign``, ``region_assign``,
``random_sample_masks``, ``random_sample_gather``,
``iou_balanced_sample_gather``, ``score_hlr_sample_gather``): mmdet's
MaxIoUAssigner (and, given the overlaps, ApproxMaxIoUAssigner),
PointAssigner (RepPoints), CenterRegionAssigner (FSAF), RegionAssigner
(Cascade RPN's stage 1), RandomSampler, Libra R-CNN's combined sampler and
PISA's ScoreHLRSampler as fixed-size masks and gathers.

The samplers take their uniforms as an argument ([2, N] for the masks: the
positives' and the negatives' ranks; [3, N] for the gather: those and the
tiebreak; [4, N] for the IoU-balanced gather; [3, N] for ScoreHLR: the
positives', the below-threshold negatives' and the tiebreak), so a test
can feed them the JAX package's ``jax.random`` draws.
Sorts are stable, as ``jnp.argsort``, so ties (the 2.0 and 1e9 fillers)
fall in index order on both sides.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .boxes import bbox_overlaps
from .nms import nms_match

IOU_BINS = 3  # the IoU-balanced sampler's bins of negatives


class AssignResult(NamedTuple):
    """assigned_gt_inds [N]: -1 ignored, 0 negative, k > 0 matched to gt
    k - 1. max_overlaps [N]: best IoU with a valid gt. labels [N]: the
    matched gt's label, -1 where not positive."""

    assigned_gt_inds: torch.Tensor
    max_overlaps: torch.Tensor
    labels: torch.Tensor


def max_iou_assign(boxes: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                   pos_iou_thr: float, neg_iou_thr: float,
                   min_pos_iou: float = 0.0,
                   box_valid: Optional[torch.Tensor] = None,
                   overlaps: Optional[torch.Tensor] = None) -> AssignResult:
    """Assign each of N boxes [N, 4] to one of G padded gts [G, 4]:
    negatives below ``neg_iou_thr``, positives from ``pos_iou_thr``, then
    each valid gt claims every box tying its own best IoU (at least
    ``min_pos_iou`` and above 0), later gts overriding earlier ones (mmdet's
    low-quality matching with ``gt_max_assign_all``). Invalid gts and boxes
    take IoU -1. ``overlaps`` [G, N] replaces ``bbox_overlaps(gt_boxes,
    boxes)`` (``boxes`` may then be None): ApproxMaxIoUAssigner's per-square
    maximum over its approximate anchors."""
    g = gt_boxes.shape[0]
    if overlaps is None:
        overlaps = bbox_overlaps(gt_boxes, boxes)  # [G, N]
    n = overlaps.shape[1]
    overlaps = torch.where(gt_valid[:, None], overlaps, -1.0)
    if box_valid is not None:
        overlaps = torch.where(box_valid[None, :], overlaps, -1.0)
    max_overlaps = overlaps.amax(dim=0)
    argmax = torch.argmax(overlaps, dim=0)  # the first of equal maxima

    assigned = torch.full((n,), -1, dtype=torch.long,
                          device=overlaps.device)
    assigned = torch.where((max_overlaps >= 0) & (max_overlaps < neg_iou_thr),
                           0, assigned)
    assigned = torch.where(max_overlaps >= pos_iou_thr, argmax + 1, assigned)

    gt_max = overlaps.amax(dim=1)  # [G]
    claim_ok = gt_valid & (gt_max >= min_pos_iou)
    claim = ((overlaps == gt_max[:, None]) & claim_ok[:, None]
             & (gt_max[:, None] > 0))
    gt_ids = torch.arange(1, g + 1, device=overlaps.device)
    claimed = torch.where(claim, gt_ids[:, None], 0).amax(dim=0)
    assigned = torch.where(claimed > 0, claimed, assigned)

    labels = torch.where(assigned > 0,
                         gt_labels[(assigned - 1).clamp(0, g - 1)].long(), -1)
    return AssignResult(assigned, max_overlaps, labels)


def point_assign(points_xy: torch.Tensor, points_lvl: torch.Tensor,
                 gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                 gt_valid: torch.Tensor, scale: float = 4.0,
                 pos_num: int = 1) -> AssignResult:
    """PointAssigner (RepPoints' first stage): points [P, 2] (x, y) with
    their level ``points_lvl`` [P] (log2 of the stride); a gt's level is
    trunc((log2(w / scale) + log2(h / scale)) / 2), clamped to the points'
    levels. Each valid gt claims its ``pos_num`` nearest points of its
    level by the distance of its centre over its size (ties to the lower
    point index, as ``lax.top_k``); a point claimed by several gts goes to
    the strictly nearer one, the earlier gt (and candidate) where the
    distances are equal -- the JAX ``fori_loop`` over the gts' candidates,
    which takes a point only where its distance is below the point's
    current one. ``max_overlaps`` is zeros."""
    num_p, num_g = points_xy.shape[0], gt_boxes.shape[0]
    dev = points_xy.device
    gt_xy = (gt_boxes[:, :2] + gt_boxes[:, 2:]) / 2
    gt_wh = (gt_boxes[:, 2:] - gt_boxes[:, :2]).clamp_min(1e-6)
    gt_lvl = torch.trunc((torch.log2(gt_wh[:, 0] / scale)
                          + torch.log2(gt_wh[:, 1] / scale)) / 2).long()
    gt_lvl = torch.minimum(torch.maximum(gt_lvl, points_lvl.min()),
                           points_lvl.max())
    diff = (points_xy[:, None, :] - gt_xy[None, :, :]) / gt_wh[None, :, :]
    dist = torch.sqrt((diff * diff).sum(-1))  # [P, G]
    masked = torch.where((points_lvl[:, None] == gt_lvl[None, :])
                         & gt_valid[None, :], dist, math.inf)
    k = min(pos_num, num_p)
    cand_d, cand_p = torch.sort(masked.T, dim=-1, stable=True)  # [G, P]
    flat_p = cand_p[:, :k].reshape(-1)  # in the loop's order: gt, then k
    flat_d = cand_d[:, :k].reshape(-1)
    flat_g = torch.arange(num_g, device=dev).repeat_interleave(k)
    best_d = torch.full((num_p,), math.inf, device=dev).scatter_reduce(
        0, flat_p, flat_d, reduce="amin")
    order = torch.arange(flat_p.shape[0], device=dev)
    first = (flat_d == best_d[flat_p]) & (flat_d < math.inf)
    big = flat_p.shape[0]
    win = torch.full((num_p,), big, dtype=torch.long, device=dev)
    win = win.scatter_reduce(0, flat_p, torch.where(first, order, big),
                             reduce="amin")
    taken = win < big
    assigned = torch.where(taken, flat_g[win.clamp_max(big - 1)] + 1, 0)
    labels = torch.where(assigned > 0, gt_labels[(assigned - 1).clamp(
        0, num_g - 1)].long(), -1)
    return AssignResult(assigned, torch.zeros(num_p, device=dev), labels)


def center_region_assign(boxes: torch.Tensor, gt_boxes: torch.Tensor,
                         gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                         pos_scale: float, neg_scale: float,
                         min_pos_iof: float = 1e-2):
    """CenterRegionAssigner (FSAF's, 0.2 / 0.2 / 0.01): a box [N, 4] is a
    positive candidate of a valid gt when its centre lies strictly inside
    the gt and its IoF with the gt's ``pos_scale`` core exceeds
    ``min_pos_iof``; the smallest-area gt wins (its priority: the rank in
    a stable descending sort of the areas). Shadow pairs: the IoF with the
    ``neg_scale`` region passes but the pair is not a core candidate, or
    it is one but lost to another gt. A positive shadowed by a gt of its
    own class is demoted to a negative. Returns (AssignResult with 0
    negative, k > 0 gt k - 1; shadowed [N, G] bool)."""
    num_g = gt_boxes.shape[0]
    dev = boxes.device

    def scaled(b, s):
        c = (b[:, :2] + b[:, 2:]) / 2
        half = (b[:, 2:] - b[:, :2]) / 2 * s
        return torch.cat([c - half, c + half], dim=-1)

    ctr = (boxes[:, :2] + boxes[:, 2:]) / 2
    area_box = ((boxes[:, 2] - boxes[:, 0]).clamp_min(0)
                * (boxes[:, 3] - boxes[:, 1]).clamp_min(0))

    def iof(regions):  # [N, G] intersection over the box's area
        ix1 = torch.maximum(boxes[:, None, 0], regions[None, :, 0])
        iy1 = torch.maximum(boxes[:, None, 1], regions[None, :, 1])
        ix2 = torch.minimum(boxes[:, None, 2], regions[None, :, 2])
        iy2 = torch.minimum(boxes[:, None, 3], regions[None, :, 3])
        inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
        return inter / area_box[:, None].clamp_min(1e-6)

    in_gt = ((ctr[:, None, 0] > gt_boxes[None, :, 0])
             & (ctr[:, None, 0] < gt_boxes[None, :, 2])
             & (ctr[:, None, 1] > gt_boxes[None, :, 1])
             & (ctr[:, None, 1] < gt_boxes[None, :, 3]))
    in_core = (in_gt & (iof(scaled(gt_boxes, pos_scale)) > min_pos_iof)
               & gt_valid[None, :])
    in_shadow = ((iof(scaled(gt_boxes, neg_scale)) > min_pos_iof)
                 & ~in_core & gt_valid[None, :])
    areas = ((gt_boxes[:, 2] - gt_boxes[:, 0])
             * (gt_boxes[:, 3] - gt_boxes[:, 1]))
    order = torch.sort(-areas, stable=True).indices  # descending area
    prio = torch.empty_like(order)
    prio[order] = torch.arange(num_g, device=dev)
    best = torch.where(in_core, prio[None, :], -1).argmax(1)  # unique ranks
    matched = in_core.any(1)
    assigned = torch.where(matched, best + 1, 0)
    chosen = ((torch.arange(num_g, device=dev)[None, :] == best[:, None])
              & matched[:, None])
    shadowed = in_shadow | (in_core & ~chosen)
    labels = torch.where(matched, gt_labels[best.clamp(0, num_g - 1)].long(),
                         -1)
    override = (shadowed & (gt_labels[None, :].long() == labels[:, None])
                & matched[:, None]).any(1)
    assigned = torch.where(override, 0, assigned)
    labels = torch.where(override, -1, labels)
    return AssignResult(assigned, torch.zeros_like(area_box), labels), \
        shadowed


def region_assign(gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                  featmap_sizes, strides, anchor_scale: float = 8.0,
                  center_ratio: float = 0.2, ignore_ratio: float = 0.5,
                  adjacent_ignore: bool = True) -> torch.Tensor:
    """RegionAssigner (Cascade RPN's stage 1: one square anchor a cell,
    centred at ``x * stride``). Each valid gt belongs to the level whose
    anchor matches its scale; in gt order (a later gt overriding an
    earlier) its ``ignore_ratio`` ring is written -1, then its
    ``center_ratio`` core gt + 1, both as rounded feature-space regions
    against the integer cell grid; with ``adjacent_ignore`` the rings
    projected onto the two adjacent levels become -1 (the JAX package's
    default, the reference's intent). Returns the per-level [h * w] maps
    concatenated: -1 ignore, 0 negative, k > 0 gt k - 1."""
    num_lvls = len(featmap_sizes)
    dev = gt_boxes.device
    r1 = (1 - center_ratio) / 2
    r2 = (1 - ignore_ratio) / 2
    scale = ((gt_boxes[:, 2] - gt_boxes[:, 0])
             * (gt_boxes[:, 3] - gt_boxes[:, 1])).clamp_min(1e-12).sqrt()
    min_anchor = torch.tensor(float(anchor_scale * strides[0]), device=dev)
    lvl_of = torch.floor(torch.log2(scale) - torch.log2(min_anchor) + 0.5
                         ).clamp(0, num_lvls - 1).long()
    out = []
    for li, (h, w) in enumerate(featmap_sizes):
        gb = gt_boxes / float(strides[li])
        xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
        ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]

        def masks(ratio, live):  # [G, h, w]
            x1 = torch.round((1 - ratio) * gb[:, 0] + ratio * gb[:, 2]
                             ).clamp(0, w)
            y1 = torch.round((1 - ratio) * gb[:, 1] + ratio * gb[:, 3]
                             ).clamp(0, h)
            x2 = torch.round(ratio * gb[:, 0] + (1 - ratio) * gb[:, 2]
                             ).clamp(0, w)
            y2 = torch.round(ratio * gb[:, 1] + (1 - ratio) * gb[:, 3]
                             ).clamp(0, h)
            m = ((xs >= x1[:, None, None]) & (xs <= x2[:, None, None])
                 & (ys >= y1[:, None, None]) & (ys <= y2[:, None, None]))
            return m & live[:, None, None]

        on = gt_valid & (lvl_of == li)
        m_ign, m_ctr = masks(r2, on), masks(r1, on)
        a = torch.zeros((h, w), dtype=torch.long, device=dev)
        for g in range(gt_boxes.shape[0]):
            a = torch.where(m_ign[g], -1, a)
            a = torch.where(m_ctr[g], g + 1, a)
        if adjacent_ignore:
            adj = gt_valid & ((lvl_of == li - 1) | (lvl_of == li + 1))
            a = torch.where(masks(r2, adj).any(0), -1, a)
        out.append(a.reshape(-1))
    return torch.cat(out)


def _ranks(key: torch.Tensor) -> torch.Tensor:
    """``argsort(argsort(key))`` with stable sorts: each element's place in
    the key order, ties to the lower index."""
    order = torch.sort(key, stable=True).indices
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(key.shape[0], device=key.device)
    return ranks


def _rank_by_random(mask: torch.Tensor, uniforms: torch.Tensor
                    ) -> torch.Tensor:
    """The rank (0-based) of each True element among the True elements in
    the order of ``uniforms``; N + 1 for False elements."""
    return torch.where(mask, _ranks(torch.where(mask, uniforms, 2.0)),
                       mask.shape[0] + 1)


class SampleMasks(NamedTuple):
    pos_mask: torch.Tensor  # [N] bool, sampled positives
    neg_mask: torch.Tensor  # [N] bool, sampled negatives


def random_sample_masks(assign: AssignResult, uniforms: torch.Tensor,
                        num: int, pos_fraction: float) -> SampleMasks:
    """RandomSampler as masks: up to ``num * pos_fraction`` positives in
    the order of ``uniforms[0]``, then negatives in the order of
    ``uniforms[1]`` up to ``num`` in all."""
    is_pos = assign.assigned_gt_inds > 0
    is_neg = assign.assigned_gt_inds == 0
    pos_mask = is_pos & (_rank_by_random(is_pos, uniforms[0])
                         < int(num * pos_fraction))
    num_neg = num - pos_mask.sum()
    neg_mask = is_neg & (_rank_by_random(is_neg, uniforms[1]) < num_neg)
    return SampleMasks(pos_mask, neg_mask)


class SampleResult(NamedTuple):
    inds: torch.Tensor  # [num] indices into the candidate boxes
    is_pos: torch.Tensor  # [num] bool
    is_valid: torch.Tensor  # [num] bool: a sampled positive or negative


def random_sample_gather(assign: AssignResult, uniforms: torch.Tensor,
                         num: int, pos_fraction: float) -> SampleResult:
    """RandomSampler as ``num`` gather indices: the sampled boxes of
    ``random_sample_masks(uniforms[:2])`` in the order of ``uniforms[2]``,
    then unsampled boxes in index order, flagged invalid."""
    masks = random_sample_masks(assign, uniforms[:2], num, pos_fraction)
    sel = masks.pos_mask | masks.neg_mask
    priority = torch.where(sel, uniforms[2], 1e9)
    inds = torch.sort(priority, stable=True).indices[:num]
    return SampleResult(inds, masks.pos_mask[inds], sel[inds])


def _segment_start(ranks: torch.Tensor, live: torch.Tensor,
                   segment: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per element, the smallest rank among the live elements of its
    segment (``jax.ops.segment_min`` over ``segment``, gathered back)."""
    big = torch.iinfo(torch.int64).max
    start = torch.full((num_segments,), big, dtype=torch.int64,
                       device=ranks.device)
    start = start.scatter_reduce(0, segment, torch.where(live, ranks, big),
                                 reduce="amin")
    return start[segment]


def iou_balanced_sample_gather(assign: AssignResult, uniforms: torch.Tensor,
                               num: int, pos_fraction: float
                               ) -> SampleResult:
    """Libra R-CNN's combined sampler as ``num`` gather indices (mmdet's
    InstanceBalancedPosSampler and IoUBalancedNegSampler at the Libra
    config's floor_thr -1 and 3 bins), as the JAX package forms it:
    positives round-robin over their gts (each gt's positives in the order
    of ``uniforms[0]``; the k-th of every gt before the (k + 1)-th of any),
    up to ``num * pos_fraction``; negatives evenly from IOU_BINS bins of
    IoU over [0, their largest IoU] (each bin's in the order of
    ``uniforms[1]``, up to its quota), the shortfall refilled from the rest
    (``uniforms[2]``); then the sampled boxes in the order of
    ``uniforms[3]``, unsampled ones after them, flagged invalid. Ties fall
    to the lower index, as JAX's stable sorts."""
    is_pos = assign.assigned_gt_inds > 0
    is_neg = assign.assigned_gt_inds == 0
    n = is_pos.shape[0]
    u_pos, u_neg, u_rest, u_tie = uniforms[:4]
    gts = torch.where(is_pos, assign.assigned_gt_inds, 0)
    grank = _ranks(torch.where(is_pos, gts.float() * 2.0 + u_pos, math.inf))
    within = (grank - _segment_start(grank, is_pos, gts, n + 1)).float()
    pos_rank = _ranks(torch.where(is_pos, within + u_pos * 0.5, math.inf))
    pos_mask = is_pos & (pos_rank < int(num * pos_fraction))
    num_neg = num - pos_mask.sum()

    iou = assign.max_overlaps.clamp(0.0, 1.0)
    max_iou = torch.where(is_neg, iou, 0.0).max().clamp_min(1e-6)
    bin_idx = (iou / (max_iou / IOU_BINS)).long().clamp(0, IOU_BINS - 1)
    grank = _ranks(torch.where(is_neg, bin_idx.float() * 2.0 + u_neg, 1e9))
    seg = torch.where(is_neg, bin_idx, IOU_BINS)
    within = grank - _segment_start(grank, is_neg, seg, IOU_BINS + 1)
    bin_sel = is_neg & (within < num_neg // IOU_BINS)
    rest = is_neg & ~bin_sel
    rest_sel = rest & (_rank_by_random(rest, u_rest)
                       < num_neg - bin_sel.sum())

    sel = pos_mask | bin_sel | rest_sel
    priority = torch.where(sel, u_tie, 1e9)
    inds = torch.sort(priority, stable=True).indices[:num]
    return SampleResult(inds, pos_mask[inds], sel[inds])


def score_hlr_sample_gather(assign: AssignResult, uniforms: torch.Tensor,
                            num: int, pos_fraction: float,
                            neg_max_score: torch.Tensor,
                            pred_boxes: torch.Tensor,
                            neg_ce_loss: torch.Tensor,
                            score_thr: float = 0.05, iou_thr: float = 0.5,
                            k: float = 0.5, bias: float = 0.0):
    """PISA's ScoreHLRSampler (ISR-N) as ``num`` gather indices, as the JAX
    package forms it. Positives as RandomSampler (``uniforms[0]``).
    Negatives whose max foreground score ``neg_max_score`` [N] exceeds
    ``score_thr`` are grouped by ``nms_match`` over their decoded
    ``pred_boxes`` [N, 4]; each one's importance is ``num_valid - (its
    score rank within its group) + score``, and the most important fill
    the negative quota; the shortfall comes from the below-threshold
    negatives in the order of ``uniforms[1]``, at the smallest weight.
    Weights ``(bias + (1 - bias) (up - imp_rank) / up) ** k``, scaled so
    the weighted background cross entropy ``neg_ce_loss`` [N] of the
    sampled negatives keeps its sum. The sampled boxes follow in the order
    of ``uniforms[2]``. Returns (SampleResult, the label weights [num]: 1
    for positives). Stable sorts throughout, as JAX's."""
    is_pos = assign.assigned_gt_inds > 0
    is_neg = assign.assigned_gt_inds == 0
    n = is_pos.shape[0]
    u_pos, u_rand, u_tie = uniforms[:3]
    pos_mask = is_pos & (_rank_by_random(is_pos, u_pos)
                         < int(num * pos_fraction))
    num_expected = num - pos_mask.sum()
    valid = is_neg & (neg_max_score > score_thr)
    invalid = is_neg & ~valid
    num_valid = valid.sum()

    root = nms_match(pred_boxes, neg_max_score, iou_thr, valid=valid)
    seg = torch.where(valid, root, n)
    key = seg.float() * 2.0 - torch.where(valid, neg_max_score.float(), 0.0)
    grank = _ranks(key)
    within = (grank - _segment_start(grank, valid, seg, n + 1)).float()
    imp = torch.where(valid, num_valid.float() - within + neg_max_score,
                      -math.inf)
    imp_rank = _ranks(-imp).float()
    hlr_sel = valid & (imp_rank < num_expected)
    num_hlr = torch.minimum(num_valid, num_expected)
    rand_sel = invalid & (_rank_by_random(invalid, u_rand)
                          < num_expected - num_hlr)
    neg_mask = hlr_sel | rand_sel

    up = torch.maximum(num_expected, num_valid).float()
    imp_w = (up - imp_rank) / up.clamp_min(1.0)
    min_w = torch.where(hlr_sel, imp_w, math.inf).min()
    min_w = torch.where(torch.isfinite(min_w), min_w, 1.0)
    w = torch.where(hlr_sel, imp_w, torch.where(rand_sel, min_w, 1.0))
    w = (bias + (1.0 - bias) * w) ** k
    sel_ce = torch.where(neg_mask, neg_ce_loss, 0.0)
    ratio = sel_ce.sum() / (sel_ce * w).sum().clamp_min(1e-6)
    w = torch.where(neg_mask, w * ratio, 1.0)

    sel = pos_mask | neg_mask
    inds = torch.sort(torch.where(sel, u_tie, 1e9), stable=True).indices[:num]
    sample = SampleResult(inds, pos_mask[inds], sel[inds])
    return sample, torch.where(sample.is_pos, 1.0, w[inds])
