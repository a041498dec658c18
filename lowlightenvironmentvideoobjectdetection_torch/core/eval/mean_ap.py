"""Detection mAP on the host (numpy), the port's own copy of the JAX
package's ``core/eval/mean_ap.py``: the same functions with the same float32
order of operations, so that both give equal results.

- ``tpfp_default`` (mmdet ``mean_ap.py:153-237``): each detection's
  candidate gt is its argmax-IoU gt over all gts, covered or not; if that
  gt is already covered, the detection is a false positive (no re-match).
- ``tpfp_imagenet`` (``mean_ap.py:59-150``): a size-adaptive IoU threshold
  per gt, ``min(wh / ((w + 10)(h + 10)), default_thr)``, the best uncovered
  gt wins, and IoUs are taken against ``gt_bboxes - 1``. Chosen for the
  'det' and 'vid' datasets.
- ``eval_map`` (``mean_ap.py:267-401``): per-class accumulation with
  ``bboxes_ignore`` / ``labels_ignore``, ``scale_ranges`` (area =
  range**2), VOC07 '11points' or 'area' AP by dataset.
- ``eval_coco_ap``: COCO-style AP over IoU thresholds 0.5:0.95, 101-point,
  with COCOeval's greedy best-uncovered-gt matching.

Detections of an image are per class [N, 5] (x1, y1, x2, y2, score), the
reference's result format.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def bbox_overlaps(bboxes1: np.ndarray, bboxes2: np.ndarray,
                  mode: str = "iou", eps: float = 1e-6) -> np.ndarray:
    """Pairwise IoU/IoF, float32 (mmdet core/evaluation/bbox_overlaps.py)."""
    assert mode in ("iou", "iof")
    a = np.asarray(bboxes1, np.float32).reshape(-1, 4)
    b = np.asarray(bboxes2, np.float32).reshape(-1, 4)
    if a.shape[0] * b.shape[0] == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.maximum(rb - lt, 0)
    overlap = wh[..., 0] * wh[..., 1]
    area1 = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area2 = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    if mode == "iou":
        union = area1[:, None] + area2[None, :] - overlap
    else:
        union = np.broadcast_to(area1[:, None], overlap.shape)
    return (overlap / np.maximum(union, eps)).astype(np.float32)


def _empty_gt_tpfp(det_bboxes, num_scales, area_ranges, tp, fp):
    """No gts: all dets within area range are FPs (mean_ap.py:193-201)."""
    if area_ranges == [(None, None)]:
        fp[...] = 1
    else:
        det_areas = (det_bboxes[:, 2] - det_bboxes[:, 0]) * (
            det_bboxes[:, 3] - det_bboxes[:, 1])
        for i, (min_area, max_area) in enumerate(area_ranges):
            fp[i, (det_areas >= min_area) & (det_areas < max_area)] = 1
    return tp, fp


def tpfp_default(det_bboxes: np.ndarray,
                 gt_bboxes: np.ndarray,
                 gt_bboxes_ignore: Optional[np.ndarray] = None,
                 iou_thr: float = 0.5,
                 area_ranges: Optional[List[tuple]] = None):
    """Reference tpfp_default (mean_ap.py:153-237), exactly.

    The candidate gt for a det is its argmax-IoU gt over ALL gts; if that
    gt is already covered by a higher-scored det, this det is a false
    positive — it does NOT get re-matched to another gt.
    Returns (tp, fp), each [num_scales, num_dets] float32 0/1.
    """
    det_bboxes = np.asarray(det_bboxes, np.float32).reshape(-1, 5)
    gt_bboxes = np.asarray(gt_bboxes, np.float32).reshape(-1, 4)
    if gt_bboxes_ignore is None:
        gt_bboxes_ignore = np.empty((0, 4), np.float32)
    gt_bboxes_ignore = np.asarray(gt_bboxes_ignore, np.float32).reshape(-1, 4)

    gt_ignore_inds = np.concatenate(
        (np.zeros(gt_bboxes.shape[0], dtype=bool),
         np.ones(gt_bboxes_ignore.shape[0], dtype=bool)))
    gt_bboxes = np.vstack((gt_bboxes, gt_bboxes_ignore))

    num_dets = det_bboxes.shape[0]
    num_gts = gt_bboxes.shape[0]
    if area_ranges is None:
        area_ranges = [(None, None)]
    num_scales = len(area_ranges)
    tp = np.zeros((num_scales, num_dets), dtype=np.float32)
    fp = np.zeros((num_scales, num_dets), dtype=np.float32)

    if gt_bboxes.shape[0] == 0:
        return _empty_gt_tpfp(det_bboxes, num_scales, area_ranges, tp, fp)

    ious = bbox_overlaps(det_bboxes[:, :4], gt_bboxes)
    # for each det: max IoU over ALL gts and its argmax — matching considers
    # ONLY this single gt (mean_ap.py:204-207)
    ious_max = ious.max(axis=1)
    ious_argmax = ious.argmax(axis=1)
    sort_inds = np.argsort(-det_bboxes[:, -1])
    for k, (min_area, max_area) in enumerate(area_ranges):
        gt_covered = np.zeros(num_gts, dtype=bool)
        if min_area is None:
            gt_area_ignore = np.zeros_like(gt_ignore_inds, dtype=bool)
        else:
            gt_areas = (gt_bboxes[:, 2] - gt_bboxes[:, 0]) * (
                gt_bboxes[:, 3] - gt_bboxes[:, 1])
            gt_area_ignore = (gt_areas < min_area) | (gt_areas >= max_area)
        for i in sort_inds:
            if ious_max[i] >= iou_thr:
                matched_gt = ious_argmax[i]
                if not (gt_ignore_inds[matched_gt]
                        or gt_area_ignore[matched_gt]):
                    if not gt_covered[matched_gt]:
                        gt_covered[matched_gt] = True
                        tp[k, i] = 1
                    else:
                        fp[k, i] = 1
                # matched an ignored gt: tp = fp = 0
            elif min_area is None:
                fp[k, i] = 1
            else:
                bbox = det_bboxes[i, :4]
                area = (bbox[2] - bbox[0]) * (bbox[3] - bbox[1])
                if area >= min_area and area < max_area:
                    fp[k, i] = 1
    return tp, fp


def tpfp_imagenet(det_bboxes: np.ndarray,
                  gt_bboxes: np.ndarray,
                  gt_bboxes_ignore: Optional[np.ndarray] = None,
                  default_iou_thr: float = 0.5,
                  area_ranges: Optional[List[tuple]] = None):
    """Reference tpfp_imagenet (mean_ap.py:59-150), exactly.

    Differences from tpfp_default, all preserved: per-gt size-adaptive IoU
    threshold ``min(wh/((w+10)(h+10)), default_thr)``; a det may match the
    best *uncovered* gt (re-matching allowed); IoUs are computed against
    ``gt_bboxes - 1`` (the reference's pixel-coordinate convention).
    Returns (tp, fp), each [num_scales, num_dets] float32 0/1.
    """
    det_bboxes = np.asarray(det_bboxes, np.float32).reshape(-1, 5)
    gt_bboxes = np.asarray(gt_bboxes, np.float32).reshape(-1, 4)
    if gt_bboxes_ignore is None:
        gt_bboxes_ignore = np.empty((0, 4), np.float32)
    gt_bboxes_ignore = np.asarray(gt_bboxes_ignore, np.float32).reshape(-1, 4)

    gt_ignore_inds = np.concatenate(
        (np.zeros(gt_bboxes.shape[0], dtype=bool),
         np.ones(gt_bboxes_ignore.shape[0], dtype=bool)))
    gt_bboxes = np.vstack((gt_bboxes, gt_bboxes_ignore))

    num_dets = det_bboxes.shape[0]
    num_gts = gt_bboxes.shape[0]
    if area_ranges is None:
        area_ranges = [(None, None)]
    num_scales = len(area_ranges)
    tp = np.zeros((num_scales, num_dets), dtype=np.float32)
    fp = np.zeros((num_scales, num_dets), dtype=np.float32)
    if gt_bboxes.shape[0] == 0:
        return _empty_gt_tpfp(det_bboxes, num_scales, area_ranges, tp, fp)

    ious = bbox_overlaps(det_bboxes[:, :4], gt_bboxes - 1)
    gt_w = gt_bboxes[:, 2] - gt_bboxes[:, 0]
    gt_h = gt_bboxes[:, 3] - gt_bboxes[:, 1]
    iou_thrs = np.minimum((gt_w * gt_h) / ((gt_w + 10.0) * (gt_h + 10.0)),
                          default_iou_thr)
    sort_inds = np.argsort(-det_bboxes[:, -1])
    for k, (min_area, max_area) in enumerate(area_ranges):
        gt_covered = np.zeros(num_gts, dtype=bool)
        if min_area is None:
            gt_area_ignore = np.zeros_like(gt_ignore_inds, dtype=bool)
        else:
            gt_areas = gt_w * gt_h
            gt_area_ignore = (gt_areas < min_area) | (gt_areas >= max_area)
        for i in sort_inds:
            max_iou = -1.0
            matched_gt = -1
            # best overlapped AVAILABLE gt — unlike PASCAL VOC, a det may
            # fall through to another gt if the best one is covered
            for j in range(num_gts):
                if gt_covered[j]:
                    continue
                elif ious[i, j] >= iou_thrs[j] and ious[i, j] > max_iou:
                    max_iou = ious[i, j]
                    matched_gt = j
            if matched_gt >= 0:
                gt_covered[matched_gt] = 1
                if not (gt_ignore_inds[matched_gt]
                        or gt_area_ignore[matched_gt]):
                    tp[k, i] = 1
            elif min_area is None:
                fp[k, i] = 1
            else:
                bbox = det_bboxes[i, :4]
                area = (bbox[2] - bbox[0]) * (bbox[3] - bbox[1])
                if area >= min_area and area < max_area:
                    fp[k, i] = 1
    return tp, fp


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = "area"):
    """Reference average_precision (mean_ap.py:12-56): 'area' (PR-curve
    envelope area) or '11points' (VOC2007)."""
    no_scale = False
    if recalls.ndim == 1:
        no_scale = True
        recalls = recalls[np.newaxis, :]
        precisions = precisions[np.newaxis, :]
    assert recalls.shape == precisions.shape and recalls.ndim == 2
    num_scales = recalls.shape[0]
    ap = np.zeros(num_scales, dtype=np.float32)
    if mode == "area":
        zeros = np.zeros((num_scales, 1), dtype=recalls.dtype)
        ones = np.ones((num_scales, 1), dtype=recalls.dtype)
        mrec = np.hstack((zeros, recalls, ones))
        mpre = np.hstack((zeros, precisions, zeros))
        for i in range(mpre.shape[1] - 1, 0, -1):
            mpre[:, i - 1] = np.maximum(mpre[:, i - 1], mpre[:, i])
        for i in range(num_scales):
            ind = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
            ap[i] = np.sum(
                (mrec[i, ind + 1] - mrec[i, ind]) * mpre[i, ind + 1])
    elif mode == "11points":
        for i in range(num_scales):
            for thr in np.arange(0, 1 + 1e-3, 0.1):
                precs = precisions[i, recalls[i, :] >= thr]
                prec = precs.max() if precs.size > 0 else 0
                ap[i] += prec
            ap /= 11
    else:
        raise ValueError(
            'Unrecognized mode, only "area" and "11points" are supported')
    if no_scale:
        ap = ap[0]
    return ap


def get_cls_results(det_results, annotations, class_id):
    """Reference get_cls_results (mean_ap.py:240-264): per-image dets, gts
    and ignored gts of one class."""
    cls_dets = [np.asarray(img_res[class_id]).reshape(-1, 5)
                for img_res in det_results]
    cls_gts = []
    cls_gts_ignore = []
    for ann in annotations:
        labels = np.asarray(ann["labels"]).reshape(-1)
        gt_inds = labels == class_id
        cls_gts.append(
            np.asarray(ann["bboxes"], np.float32).reshape(-1, 4)[gt_inds, :])
        if ann.get("labels_ignore", None) is not None:
            ignore_inds = np.asarray(ann["labels_ignore"]).reshape(-1) == class_id
            cls_gts_ignore.append(
                np.asarray(ann["bboxes_ignore"],
                           np.float32).reshape(-1, 4)[ignore_inds, :])
        else:
            cls_gts_ignore.append(np.empty((0, 4), dtype=np.float32))
    return cls_dets, cls_gts, cls_gts_ignore


def eval_map(
    det_results: Sequence[Sequence[np.ndarray]],
    annotations: Sequence[Dict],
    scale_ranges: Optional[Sequence[tuple]] = None,
    iou_thr: float = 0.5,
    dataset: Optional[str] = None,
    mode: Optional[str] = None,
    tpfp_fn=None,
) -> Tuple[object, List[Dict]]:
    """VOC-style mAP, semantics of the reference eval_map (mean_ap.py:267).

    det_results: per image, per class [N, 5] arrays.
    annotations: per image dicts with 'bboxes' [G, 4] and 'labels' [G],
        optionally 'bboxes_ignore' [K, 4] and 'labels_ignore' [K].
    scale_ranges: [(min1, max1), ...] — a range (32, 64) means bbox areas
        in [32**2, 64**2). With scale_ranges, mean_ap is a per-scale list.
    dataset: 'det'/'vid' selects tpfp_imagenet (size-adaptive thresholds);
        'voc07' selects 11-point AP; anything else: tpfp_default + 'area'.
    mode: explicit AP-mode override ('area' | '11points'); None derives it
        from ``dataset`` exactly as the reference (mean_ap.py:370).
    Returns (mAP, per-class list of dicts with num_gts/num_dets/recall/
    precision/ap — the reference's eval_results shape).
    """
    assert len(det_results) == len(annotations)
    num_imgs = len(det_results)
    num_scales = len(scale_ranges) if scale_ranges is not None else 1
    num_classes = len(det_results[0])
    area_ranges = ([(rg[0] ** 2, rg[1] ** 2) for rg in scale_ranges]
                   if scale_ranges is not None else None)

    eval_results = []
    for c in range(num_classes):
        cls_dets, cls_gts, cls_gts_ignore = get_cls_results(
            det_results, annotations, c)
        if tpfp_fn is None:
            if dataset in ("det", "vid"):
                tpfp_fn = tpfp_imagenet
            else:
                tpfp_fn = tpfp_default
        if not callable(tpfp_fn):
            raise ValueError(
                f"tpfp_fn has to be a function or None, but got {tpfp_fn}")
        tpfp = [
            tpfp_fn(cls_dets[j], cls_gts[j], cls_gts_ignore[j], iou_thr,
                    area_ranges)
            for j in range(num_imgs)
        ]
        tp, fp = tuple(zip(*tpfp))
        # gt count per scale; ignored gts / out-of-range gts don't count
        num_gts = np.zeros(num_scales, dtype=int)
        for j, bbox in enumerate(cls_gts):
            if area_ranges is None:
                num_gts[0] += bbox.shape[0]
            else:
                gt_areas = (bbox[:, 2] - bbox[:, 0]) * (
                    bbox[:, 3] - bbox[:, 1])
                for k, (min_area, max_area) in enumerate(area_ranges):
                    num_gts[k] += np.sum((gt_areas >= min_area)
                                         & (gt_areas < max_area))
        cls_dets_all = np.vstack(cls_dets)
        num_dets = cls_dets_all.shape[0]
        sort_inds = np.argsort(-cls_dets_all[:, -1])
        tp = np.hstack(tp)[:, sort_inds]
        fp = np.hstack(fp)[:, sort_inds]
        tp = np.cumsum(tp, axis=1)
        fp = np.cumsum(fp, axis=1)
        eps = np.finfo(np.float32).eps
        recalls = tp / np.maximum(num_gts[:, np.newaxis], eps)
        precisions = tp / np.maximum((tp + fp), eps)
        if scale_ranges is None:
            recalls = recalls[0, :]
            precisions = precisions[0, :]
            num_gts_out = num_gts.item()
        else:
            num_gts_out = num_gts
        ap_mode = mode if mode is not None else (
            "11points" if dataset == "voc07" else "area")
        ap = average_precision(recalls, precisions, ap_mode)
        eval_results.append({
            "num_gts": num_gts_out,
            "num_dets": num_dets,
            "recall": recalls,
            "precision": precisions,
            "ap": ap,
        })

    if scale_ranges is not None:
        all_ap = np.vstack([r["ap"] for r in eval_results])
        all_num_gts = np.vstack([r["num_gts"] for r in eval_results])
        mean_ap = []
        for i in range(num_scales):
            if np.any(all_num_gts[:, i] > 0):
                mean_ap.append(all_ap[all_num_gts[:, i] > 0, i].mean())
            else:
                mean_ap.append(0.0)
    else:
        aps = [r["ap"] for r in eval_results if r["num_gts"] > 0]
        mean_ap = np.array(aps).mean().item() if aps else 0.0
    return mean_ap, eval_results


def _tpfp_coco(dets: np.ndarray, gts: np.ndarray, iou_thr: float):
    """COCOeval-style greedy matching for eval_coco_ap: each det (score
    order) takes the max-IoU gt among the still-uncovered gts. Returns
    (tp, fp, scores) aligned with score-desc order."""
    order = np.argsort(-dets[:, 4])
    dets = dets[order]
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    matched = np.zeros(len(gts), bool)
    ious = bbox_overlaps(dets[:, :4], gts)
    for i in range(len(dets)):
        if len(gts) and ious[i].max() >= iou_thr:
            j = int(np.argmax(ious[i] * ~matched))
            if ious[i, j] >= iou_thr and not matched[j]:
                matched[j] = True
                tp[i] = 1
                continue
        fp[i] = 1
    return tp, fp, dets[:, 4]


def eval_coco_ap(
    det_results: Sequence[Sequence[np.ndarray]],
    annotations: Sequence[Dict],
    iou_thrs: Sequence[float] = tuple(np.arange(0.5, 1.0, 0.05)),
) -> Dict[str, float]:
    """COCO-style AP averaged over IoU thresholds (101-point interpolation)."""
    num_classes = len(det_results[0])
    rec_points = np.linspace(0, 1, 101)
    ap_per_thr = {t: [] for t in iou_thrs}
    for c in range(num_classes):
        cls_data = []
        num_gts = 0
        for dets, ann in zip(det_results, annotations):
            d = np.asarray(dets[c]).reshape(-1, 5)
            mask = np.asarray(ann["labels"]) == c
            g = np.asarray(ann["bboxes"]).reshape(-1, 4)[mask]
            num_gts += len(g)
            cls_data.append((d, g))
        if num_gts == 0:
            continue
        for t in iou_thrs:
            tps, fps, scores = [], [], []
            for d, g in cls_data:
                if len(d) == 0:
                    continue
                tp, fp, s = _tpfp_coco(d, g, t)
                tps.append(tp); fps.append(fp); scores.append(s)
            if not scores:
                ap_per_thr[t].append(0.0)
                continue
            scores = np.concatenate(scores)
            order = np.argsort(-scores)
            tp = np.cumsum(np.concatenate(tps)[order])
            fp = np.cumsum(np.concatenate(fps)[order])
            recall = tp / num_gts
            precision = tp / np.maximum(tp + fp, 1e-9)
            # 101-point: precision envelope sampled at fixed recalls
            for i in range(len(precision) - 2, -1, -1):
                precision[i] = max(precision[i], precision[i + 1])
            inds = np.searchsorted(recall, rec_points, side="left")
            q = np.zeros(len(rec_points))
            ok = inds < len(precision)
            q[ok] = precision[inds[ok]]
            ap_per_thr[t].append(float(np.mean(q)))
    out = {}
    if ap_per_thr[iou_thrs[0]]:
        out["AP50"] = float(np.mean(ap_per_thr[iou_thrs[0]]))
        out["mAP"] = float(np.mean([np.mean(v) for v in ap_per_thr.values()]))
    else:
        out["AP50"] = 0.0
        out["mAP"] = 0.0
    return out
