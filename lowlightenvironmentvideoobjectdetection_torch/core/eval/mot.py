"""CLEAR-MOT evaluation on the host (numpy, the port's JV solver; no
motmetrics), the port's copy of the JAX package's ``core/eval/mot.py``.

Parity target: mmtracking/mmtrack/core/evaluation/eval_mot.py:15-220 — MOTA,
IDF1 (+ IDTP-based identity measures), FP/FN/ID-switches, MT/PT/ML, computed
per video with IoU>=0.5 association, then accumulated. Same metric
definitions as the motmetrics package the reference wraps.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ...ops.lap import linear_sum_assignment
from .mean_ap import bbox_overlaps


def _frame_match(gt_boxes, gt_ids, pred_boxes, pred_ids, prev_map, iou_thr=0.5):
    """CLEAR matching for one frame with continuity preference.

    Returns (matches {gt_id: pred_id}, fp, fn, idsw)."""
    matches = {}
    idsw = 0
    used_pred = set()

    # 1) keep persistent matches when still overlapping
    ious = bbox_overlaps(gt_boxes, pred_boxes)
    pid_to_col = {p: i for i, p in enumerate(pred_ids)}
    for gi, g in enumerate(gt_ids):
        p = prev_map.get(g)
        if p is not None and p in pid_to_col:
            c = pid_to_col[p]
            if ious[gi, c] >= iou_thr:
                matches[g] = p
                used_pred.add(p)

    # 2) Hungarian on the rest
    rest_g = [i for i, g in enumerate(gt_ids) if g not in matches]
    rest_p = [i for i, p in enumerate(pred_ids) if p not in used_pred]
    if rest_g and rest_p:
        sub = ious[np.ix_(rest_g, rest_p)]
        cost = 1.0 - sub
        cost[sub < iou_thr] = 1e6
        row, col = linear_sum_assignment(cost)
        for r, c in zip(row, col):
            if cost[r, c] < 1e5:
                g = gt_ids[rest_g[r]]
                p = pred_ids[rest_p[c]]
                matches[g] = p
                used_pred.add(p)

    for g, p in matches.items():
        if g in prev_map and prev_map[g] != p:
            idsw += 1
    fp = len(pred_ids) - len(used_pred)
    fn = len(gt_ids) - len(matches)
    return matches, fp, fn, idsw


def eval_mot(
    gt_per_video: Sequence[List[Dict]],
    pred_per_video: Sequence[List[Dict]],
    iou_thr: float = 0.5,
) -> Dict[str, float]:
    """gt/pred_per_video: per video, per frame dicts with 'bboxes' [N, 4] and
    'ids' [N]. Returns CLEAR-MOT + identity metrics."""
    num_gt = num_fp = num_fn = num_idsw = 0
    gt_traj_frames: Dict = {}
    gt_traj_matched: Dict = {}
    id_pairs: Dict = {}
    total_pred = 0

    for gt_frames, pred_frames in zip(gt_per_video, pred_per_video):
        prev_map: Dict = {}
        for gt_f, pr_f in zip(gt_frames, pred_frames):
            gt_boxes = np.asarray(gt_f["bboxes"], np.float32).reshape(-1, 4)
            gt_ids = list(np.asarray(gt_f["ids"]).astype(int))
            pr_boxes = np.asarray(pr_f["bboxes"], np.float32).reshape(-1, 4)
            pr_ids = list(np.asarray(pr_f["ids"]).astype(int))
            total_pred += len(pr_ids)

            matches, fp, fn, idsw = _frame_match(
                gt_boxes, gt_ids, pr_boxes, pr_ids, prev_map, iou_thr
            )
            num_gt += len(gt_ids)
            num_fp += fp
            num_fn += fn
            num_idsw += idsw
            for g in gt_ids:
                key = (id(gt_frames), g)
                gt_traj_frames[key] = gt_traj_frames.get(key, 0) + 1
                if g in matches:
                    gt_traj_matched[key] = gt_traj_matched.get(key, 0) + 1
                    pair = (key, matches[g])
                    id_pairs[pair] = id_pairs.get(pair, 0) + 1
            prev_map = dict(matches)

    mota = 1.0 - (num_fp + num_fn + num_idsw) / max(num_gt, 1)

    # identity measures (IDF1): optimal global gt-track <-> pred-track map
    gt_keys = sorted({k for k, _ in id_pairs} | set(gt_traj_frames))
    pred_keys = sorted({p for _, p in id_pairs})
    if gt_keys and pred_keys:
        overlap = np.zeros((len(gt_keys), len(pred_keys)))
        for (g, p), c in id_pairs.items():
            overlap[gt_keys.index(g), pred_keys.index(p)] = c
        row, col = linear_sum_assignment(-overlap)
        idtp = overlap[row, col].sum()
    else:
        idtp = 0.0
    idf1 = 2 * idtp / max(num_gt + total_pred, 1)

    # track coverage
    mt = pt = ml = 0
    for key, n_frames in gt_traj_frames.items():
        cov = gt_traj_matched.get(key, 0) / n_frames
        if cov >= 0.8:
            mt += 1
        elif cov <= 0.2:
            ml += 1
        else:
            pt += 1

    return dict(
        MOTA=float(mota), IDF1=float(idf1), FP=int(num_fp), FN=int(num_fn),
        IDSw=int(num_idsw), MT=mt, PT=pt, ML=ml, num_gt=int(num_gt),
    )
