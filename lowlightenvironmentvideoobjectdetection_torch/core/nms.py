"""Fixed-size greedy NMS, the counterpart of the JAX package's
``core/nms.py`` (``nms_fixed``, ``batched_nms``, ``multiclass_nms``,
``nms_match``).

Same semantics as the JAX reference, step for step: a stable descending sort
(ties go to the lower index), a ``pre_top_k`` candidate window, the
"strictly higher-ranked alive j overlaps i" relation, and the fixpoint
``keep_i <- alive_i & ~any_j(O_ij & keep_j)``, which is the greedy solution.
Outputs have fixed sizes with a validity mask. The fixpoint runs as a host
loop with one device sync per iteration (typically < 10), capped at K.

Each function also takes a leading stream axis S on all its per-box inputs
(the counterpart of ``jax.vmap`` over it). All S streams then share one
fixpoint loop, which runs until every stream has converged: exact, because
a converged keep set is a fixpoint and further iterations leave it as it is.
Plain torch tensor code; a hand kernel is later work.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = -1.0e30
_MATRIX_NMS_MAX_K = 6144


class NMSResult(NamedTuple):
    boxes: torch.Tensor  # [max_out, 4]
    scores: torch.Tensor  # [max_out]
    inds: torch.Tensor  # [max_out] int64 indices into the input
    valid: torch.Tensor  # [max_out] bool


class DetResult(NamedTuple):
    boxes: torch.Tensor  # [max_num, 4]
    scores: torch.Tensor  # [max_num]
    labels: torch.Tensor  # [max_num] int64
    valid: torch.Tensor  # [max_num] bool


def nms_fixed(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
    pre_top_k: Optional[int] = None,
) -> NMSResult:
    """Greedy NMS (mmcv ``nms`` semantics) with exactly ``max_out`` slots.
    boxes [N, 4] or [S, N, 4]; scores and valid [N] or [S, N]."""
    if boxes.ndim == 2:
        res = nms_fixed(boxes[None], scores[None], iou_threshold, max_out,
                        None if valid is None else valid[None], pre_top_k)
        return NMSResult(*(f[0] for f in res))
    b, n = scores.shape
    live = scores.float()
    if valid is not None:
        live = torch.where(valid, live, torch.full_like(live, NEG_INF))
    k = min(n, pre_top_k or _MATRIX_NMS_MAX_K, _MATRIX_NMS_MAX_K)
    neg, order = torch.sort(-live, dim=1, stable=True)
    neg, order = neg[:, :k], order[:, :k]
    top_scores = -neg
    sb = torch.gather(boxes.float(), 1, order[..., None].expand(b, k, 4))
    x1, y1, x2, y2 = sb.unbind(-1)
    alive = top_scores > NEG_INF / 2

    iw = (torch.minimum(x2[:, :, None], x2[:, None, :])
          - torch.maximum(x1[:, :, None], x1[:, None, :])).clamp_min(0.0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None, :])
          - torch.maximum(y1[:, :, None], y1[:, None, :])).clamp_min(0.0)
    inter = iw * ih
    area = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    iou = inter / (area[:, :, None] + area[:, None, :] - inter).clamp_min(1e-6)
    ar = torch.arange(k, device=boxes.device)
    tri = ar[None, :] < ar[:, None]
    overlap = (iou > iou_threshold) & tri & alive[:, None, :]

    keep = alive
    prev = torch.zeros_like(alive)
    it = 0
    while it < k and not torch.equal(keep, prev):
        new = alive & ~(overlap & keep[:, None, :]).any(dim=2)
        prev, keep = keep, new
        it += 1

    # first max_out kept candidates in score order; slot max_out of each
    # stream is a scratch slot for everything past them and is cut off
    kept_rank = torch.cumsum(keep.long(), 1) - 1
    src = torch.where(keep, kept_rank,
                      torch.full_like(kept_rank, max_out)).clamp(0, max_out)
    src = src + torch.arange(b, device=src.device)[:, None] * (max_out + 1)

    def place(col, fill):
        out = torch.full((b * (max_out + 1),) + col.shape[2:], fill,
                         dtype=col.dtype, device=col.device)
        out[src.reshape(-1)] = col.reshape((b * k,) + col.shape[2:])
        return out.reshape((b, max_out + 1) + col.shape[2:])[:, :max_out]

    return NMSResult(place(sb, 0.0), place(top_scores, 0.0), place(order, 0),
                     place(keep, False))


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
    pre_top_k: Optional[int] = None,
) -> NMSResult:
    """Class-aware NMS via the coordinate-offset trick (mmcv ``batched_nms``).
    The offset comes from the max over ALL boxes of a stream, invalid ones
    included, as in the JAX reference; ``idxs`` [N] may be shared by the
    streams."""
    finite = torch.where(torch.isfinite(boxes), boxes, torch.zeros_like(boxes))
    max_coord = finite.amax(dim=(-2, -1)) + 1.0  # [] or [S]
    offsets = idxs.float() * max_coord[..., None]
    shifted = boxes + offsets[..., None]
    res = nms_fixed(shifted, scores, iou_threshold, max_out, valid=valid,
                    pre_top_k=pre_top_k)
    picked = torch.gather(offsets.expand(res.inds.shape[:-1] + (-1,)), -1,
                          res.inds)
    out_boxes = res.boxes - picked[..., None] * res.valid[..., None]
    return NMSResult(out_boxes, res.scores, res.inds, res.valid)


def multiclass_nms(
    multi_bboxes: torch.Tensor,
    multi_scores: torch.Tensor,
    score_thr: float,
    iou_threshold: float,
    max_num: int,
    box_valid: Optional[torch.Tensor] = None,
    pre_top_k: Optional[int] = None,
) -> DetResult:
    """mmdet ``multiclass_nms`` with fixed shapes. multi_bboxes: [N, 4] or
    [N, C*4]; multi_scores: [N, C+1] with background last (dropped); a
    leading stream axis on all three inputs batches it."""
    *lead, n, num_cols = multi_scores.shape
    num_classes = num_cols - 1
    scores = multi_scores[..., :num_classes]
    if multi_bboxes.shape[-1] > 4:
        boxes = multi_bboxes.reshape(*lead, n, num_classes, 4)
    else:
        boxes = multi_bboxes[..., None, :].expand(*lead, n, num_classes, 4)
    flat_boxes = boxes.reshape(*lead, -1, 4)
    flat_scores = scores.reshape(*lead, -1)
    labels = torch.arange(num_classes, device=multi_scores.device).repeat(n)
    cand_valid = flat_scores > score_thr
    if box_valid is not None:
        cand_valid = cand_valid & box_valid.repeat_interleave(num_classes, -1)
    res = batched_nms(flat_boxes, flat_scores, labels, iou_threshold, max_num,
                      valid=cand_valid, pre_top_k=pre_top_k)
    return DetResult(res.boxes, res.scores, labels[res.inds], res.valid)


def nms_match(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NMS suppression groups (mmcv ``nms_match``): [N] int64, for each box
    the index of the kept box that suppresses it (the best-ranked kept box
    overlapping it from ``iou_threshold``), a kept box its own index, an
    invalid box -1. The same fixpoint as ``nms_fixed`` over all N boxes,
    with the ">=" relation and no window (ScoreHLR's grouping)."""
    n = boxes.shape[0]
    live = scores.float()
    if valid is not None:
        live = torch.where(valid, live, torch.full_like(live, NEG_INF))
    alive = live > NEG_INF / 2
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    iw = (torch.minimum(x2[:, None], x2[None, :])
          - torch.maximum(x1[:, None], x1[None, :])).clamp_min(0.0)
    ih = (torch.minimum(y2[:, None], y2[None, :])
          - torch.maximum(y1[:, None], y1[None, :])).clamp_min(0.0)
    inter = iw * ih
    area = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    iou = inter / (area[:, None] + area[None, :] - inter).clamp_min(1e-6)
    order = torch.sort(-live, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=boxes.device)
    overlap = ((iou >= iou_threshold) & (rank[None, :] < rank[:, None])
               & alive[None, :])
    keep, prev, it = alive, torch.zeros_like(alive), 0
    while it < n and not torch.equal(keep, prev):
        prev, keep = keep, alive & ~(overlap & keep[None, :]).any(dim=1)
        it += 1
    cand = keep[None, :] & (iou >= iou_threshold) & alive[:, None]
    root = torch.where(cand, rank[None, :], n + 1).argmin(dim=1)
    root = torch.where(keep, torch.arange(n, device=boxes.device), root)
    return torch.where(alive & (cand.any(dim=1) | keep), root, -1)
