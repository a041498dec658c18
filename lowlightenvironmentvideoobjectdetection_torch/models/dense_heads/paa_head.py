"""PAA (probabilistic anchor assignment), the counterpart of the JAX
package's ``models/dense_heads/paa_head.py`` (``PAA``, ``_giou``,
``_gmm_pos_split``, ``paa_loss``, ``paa_decode``; mmdet's ``paa_head.py``):
ATSS's assembly (the centerness branch predicts the IoU); the assignment
differs.

Candidates are the anchors with IoU at least 0.1 with a gt; each scores the
focal loss of its class probability plus the GIoU loss of its decoded box
(no gradient); per gt the ``topk`` (4) lowest-scoring candidates of each
level (``top_k_stable`` of the negated scores: ties to the lower index)
are split by a two-component 1-D Gaussian mixture. The mixture is the JAX
package's fixed 10-iteration batched EM, op by op in float32, not
sklearn's: means at (min, max), variances 1, weights 0.5; a softmax over
the two components; variances clamped at 1e-4; the lower-mean component is
the foreground, of which separation scheme (c) keeps the candidates
scoring at most the foreground mode's. An anchor kept for several gts
takes the lowest-scoring one. Losses: the sigmoid focal loss, the GIoU loss
weighted by the IoU target and the IoU branch's BCE against the decoded
box's IoU.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ...core import boxes as box_ops, losses
from .atss_head import ATSS, STDS, atss_anchors, atss_decode
from .fcos_head import level_sizes
from .retina_head import top_k_stable


class PAA(ATSS):
    """ATSS's assembly; the assignment (``paa_loss``) is what differs."""


paa_decode = atss_decode


class PAALossOut(NamedTuple):
    loss_cls: torch.Tensor
    loss_bbox: torch.Tensor
    loss_iou: torch.Tensor


def _giou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Aligned GIoU of [..., 4] boxes (broadcasting) -> [...]."""
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    area_a = ((a[..., 2] - a[..., 0]).clamp_min(0)
              * (a[..., 3] - a[..., 1]).clamp_min(0))
    area_b = ((b[..., 2] - b[..., 0]).clamp_min(0)
              * (b[..., 3] - b[..., 1]).clamp_min(0))
    union = (area_a + area_b - inter).clamp_min(1e-6)
    iou = inter / union
    ex1 = torch.minimum(a[..., 0], b[..., 0])
    ey1 = torch.minimum(a[..., 1], b[..., 1])
    ex2 = torch.maximum(a[..., 2], b[..., 2])
    ey2 = torch.maximum(a[..., 3], b[..., 3])
    enc = (ex2 - ex1).clamp_min(0) * (ey2 - ey1).clamp_min(0)
    return iou - (enc - union) / enc.clamp_min(1e-6)


def _component_logp(s, mu, var, pi):
    """[G, K, 2] weighted component log-densities."""
    d2 = (s[:, :, None] - mu[:, None, :]).square()
    return (-0.5 * d2 / var[:, None, :]
            - 0.5 * torch.log(2 * math.pi * var[:, None, :])
            + torch.log(pi[:, None, :].clamp_min(1e-8)))


def _gmm_pos_split(scores: torch.Tensor, valid: torch.Tensor,
                   iters: int = 10) -> torch.Tensor:
    """Batched 2-component 1-D GMM EM over per-gt candidate scores [G, K]
    (lower is better) with ``valid`` [G, K] -> PAA's positives [G, K]
    (bool)."""
    big = 1e8
    s = torch.where(valid, scores, big)
    smin = s.amin(1, keepdim=True)
    smax = torch.where(valid, s, -big).amax(1, keepdim=True)
    smax = torch.maximum(smax, smin + 1e-3)
    mu = torch.cat([smin, smax], dim=1)  # [G, 2]
    var = torch.ones_like(mu)
    pi = torch.full_like(mu, 0.5)
    vf = valid.float()
    for _ in range(iters):
        r = torch.softmax(_component_logp(s, mu, var, pi), -1) * vf[:, :, None]
        nk = r.sum(1) + 1e-6
        mu = (r * s[:, :, None]).sum(1) / nk
        var = (r * (s[:, :, None] - mu[:, None, :]).square()).sum(1) / nk
        var = var.clamp_min(1e-4)
        pi = nk / nk.sum(1, keepdim=True).clamp_min(1e-6)
    lo = mu.argmin(1)
    logp = _component_logp(s, mu, var, pi)
    fg = (logp.argmax(-1) == lo[:, None]) & valid
    loglik = torch.logsumexp(logp, -1)
    ll_fg = torch.where(fg, loglik, -math.inf)
    thr = torch.gather(s, 1, ll_fg.argmax(1)[:, None])
    return fg & (s <= thr) & fg.any(1, keepdim=True)


def paa_loss(level_outs, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
             gt_valid: torch.Tensor, num_classes: int, topk: int = 4,
             first_match_iou: float = 0.1) -> PAALossOut:
    """level_outs: per level (cls [h, w, C], deltas [h, w, 4], IoU logit
    [h, w, 1]) of one image."""
    level_anchors = atss_anchors(level_sizes(level_outs),
                                 device=gt_boxes.device)
    anchors = torch.cat(level_anchors)
    num_a, num_g = anchors.shape[0], gt_boxes.shape[0]
    cls_all = torch.cat([c.reshape(-1, num_classes).float()
                         for c, _, _ in level_outs])
    reg_all = torch.cat([r.reshape(-1, 4).float() for _, r, _ in level_outs])
    iou_all = torch.cat([t.reshape(-1).float() for _, _, t in level_outs])
    iou_mat = box_ops.bbox_overlaps(anchors, gt_boxes)  # [A, G]
    cand = (iou_mat >= first_match_iou) & gt_valid[None, :]
    # each candidate's score: the focal loss + GIoU loss of its decoded box
    with torch.no_grad():
        decoded = box_ops.delta2bbox(anchors, reg_all, stds=STDS)
        p_lab = torch.sigmoid(cls_all)[
            :, gt_labels.long().clamp(0, num_classes - 1)]  # [A, G]
        focal = -0.25 * (1 - p_lab) ** 2.0 * torch.log(p_lab.clamp_min(1e-8))
        giou_cost = 1.0 - _giou(decoded[:, None, :], gt_boxes[None, :, :])
        score = torch.where(cand, focal + giou_cost, 1e8)
        # per gt the topk lowest scores of each level -> [G, L * topk]
        sel_s, sel_i = [], []
        start = 0
        for la in level_anchors:
            n = la.shape[0]
            neg_s, idx = top_k_stable(-score[start:start + n].T, min(topk, n))
            sel_s.append(-neg_s)
            sel_i.append(idx + start)
            start += n
        cand_scores = torch.cat(sel_s, 1)
        cand_inds = torch.cat(sel_i, 1)
        cand_valid = (cand_scores < 1e7) & gt_valid[:, None]
        keep = _gmm_pos_split(cand_scores, cand_valid)  # [G, K]
        # back to anchors: each anchor positive for its lowest-scoring gt
        gidx = torch.arange(num_g, device=anchors.device)[:, None].expand(
            cand_inds.shape)
        pos_pairs = torch.zeros(num_a * num_g, dtype=torch.uint8,
                                device=anchors.device).scatter_reduce(
            0, (cand_inds * num_g + gidx).reshape(-1),
            keep.reshape(-1).to(torch.uint8), "amax").reshape(
                num_a, num_g).bool()
        best_gt = torch.where(pos_pairs, score, 1e8).argmin(1)
        pos = pos_pairs.any(1)
    num_pos = pos.sum().float().clamp_min(1.0)
    onehot = F.one_hot(gt_labels[best_gt].long().clamp(0, num_classes - 1),
                       num_classes).float() * pos[:, None]
    loss_cls = losses.sigmoid_focal_loss(cls_all, onehot, avg_factor=num_pos)
    matched = gt_boxes[best_gt]
    dec_live = box_ops.delta2bbox(anchors, reg_all, stds=STDS)
    best_1h = F.one_hot(best_gt, num_g).float()
    iou_tgt = (torch.where(pos_pairs, iou_mat, 0.0) * best_1h).sum(1)
    giou_l = ((1.0 - _giou(dec_live, matched)) * pos
              * iou_tgt.clamp_min(1e-6))
    loss_bbox = giou_l.sum() / (iou_tgt * pos).sum().clamp_min(1e-6)
    dec_iou = (box_ops.bbox_overlaps(dec_live.detach(), gt_boxes)
               * best_1h).sum(1).clamp(0.0, 1.0)
    loss_iou = losses.binary_cross_entropy(iou_all, dec_iou,
                                           weight=pos.float(),
                                           avg_factor=num_pos)
    return PAALossOut(loss_cls, loss_bbox, loss_iou)
