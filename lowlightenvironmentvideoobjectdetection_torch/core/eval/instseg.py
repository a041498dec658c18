"""Instance-mask AP and COCO segmentation decoding on the host, numpy
only: the port's own copy of the JAX package's ``core/eval/instseg.py``
(``polygon_to_mask``, ``rle_to_mask``, ``ann_to_mask``,
``mask_iou_matrix``, ``eval_mask_ap``; mmdet's cityscapes evaluation
computed natively), which the port does not import.

The matcher is ``mean_ap.py``'s greedy score-ordered one with mask IoU for
box IoU, over the pasted full-image masks ([N, H, W] bool) of the mask
families. Polygons fill by the even-odd rule at pixel centres;
uncompressed RLE is column-major, as pycocotools'; compressed RLE raises.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

_REC_POINTS = np.linspace(0, 1, 101)


def polygon_to_mask(polys: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """Even-odd scanline rasterization of COCO polygon lists -> [h, w] bool."""
    mask = np.zeros((h, w), bool)
    for poly in polys:
        xs = np.asarray(poly[0::2], np.float64)
        ys = np.asarray(poly[1::2], np.float64)
        n = len(xs)
        if n < 3:
            continue
        sub = np.zeros((h, w), bool)
        # sample at pixel centers (y + 0.5): a center is inside when a ray
        # to -x crosses an odd number of edges
        for row in range(h):
            yc = row + 0.5
            j = n - 1
            crossings: List[float] = []
            for i in range(n):
                yi, yj = ys[i], ys[j]
                if (yi <= yc) != (yj <= yc):
                    x = xs[i] + (yc - yi) / (yj - yi) * (xs[j] - xs[i])
                    crossings.append(x)
                j = i
            crossings.sort()
            for a, b in zip(crossings[0::2], crossings[1::2]):
                lo = max(int(np.ceil(a - 0.5)), 0)
                hi = min(int(np.ceil(b - 0.5)), w)
                if hi > lo:
                    sub[row, lo:hi] = True
        mask |= sub
    return mask


def rle_to_mask(rle: Dict, h: int, w: int) -> np.ndarray:
    """Uncompressed COCO RLE (column-major runs, starting with 0s)."""
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        raise NotImplementedError(
            "compressed RLE needs pycocotools' LEB128 decoding; convert the "
            "annotations to polygons or uncompressed RLE")
    flat = np.zeros(h * w, bool)
    pos, val = 0, False
    for c in counts:
        flat[pos:pos + c] = val
        pos += c
        val = not val
    return flat.reshape(w, h).T  # column-major


def ann_to_mask(segmentation, h: int, w: int) -> np.ndarray:
    if isinstance(segmentation, dict):
        return rle_to_mask(segmentation, h, w)
    return polygon_to_mask(segmentation, h, w)


def mask_iou_matrix(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """[N, H, W] x [G, H, W] bool -> [N, G] IoU."""
    n, g = len(dets), len(gts)
    if n == 0 or g == 0:
        return np.zeros((n, g), np.float64)
    d = dets.reshape(n, -1).astype(np.float64)
    t = gts.reshape(g, -1).astype(np.float64)
    inter = d @ t.T
    union = d.sum(1)[:, None] + t.sum(1)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def _tpfp_mask(scores: np.ndarray, det_masks: np.ndarray,
               gt_masks: np.ndarray, iou_thr: float):
    order = np.argsort(-scores)
    ious = mask_iou_matrix(det_masks[order], gt_masks)
    tp = np.zeros(len(order))
    fp = np.zeros(len(order))
    taken = np.zeros(len(gt_masks), bool)
    for r in range(len(order)):
        j = int(np.argmax(ious[r])) if len(gt_masks) else -1
        if j >= 0 and ious[r, j] >= iou_thr and not taken[j]:
            taken[j] = True
            tp[r] = 1
        else:
            fp[r] = 1
    return tp, fp, scores[order]


def eval_mask_ap(
    seg_results: Sequence[Sequence[Dict]],
    annotations: Sequence[Dict],
    num_classes: int,
    iou_thrs: Sequence[float] = tuple(np.arange(0.5, 0.96, 0.05)),
) -> Dict[str, float]:
    """Instance-mask AP, cityscapes-style summary keys.

    seg_results: per image, per class, dict(scores [N], masks [N, H, W]).
    annotations: per image dict(masks [G, H, W] bool, labels [G]).
    Returns {"mAP": AP@[.5:.95], "AP@50": AP@0.5} (cityscapes.py:284 names).
    """
    ap_per_thr = {t: [] for t in iou_thrs}
    for c in range(num_classes):
        per_img = []
        num_gts = 0
        for segs, ann in zip(seg_results, annotations):
            labels = np.asarray(ann["labels"])
            gm = np.asarray(ann["masks"])[labels == c]
            num_gts += len(gm)
            per_img.append((segs[c], gm))
        if num_gts == 0:
            continue
        for t in iou_thrs:
            tps, fps, ss = [], [], []
            for seg, gm in per_img:
                s = np.asarray(seg["scores"])
                if len(s) == 0:
                    continue
                tp, fp, so = _tpfp_mask(s, np.asarray(seg["masks"]), gm, t)
                tps.append(tp)
                fps.append(fp)
                ss.append(so)
            if not ss:
                ap_per_thr[t].append(0.0)
                continue
            ss = np.concatenate(ss)
            order = np.argsort(-ss)
            tp = np.cumsum(np.concatenate(tps)[order])
            fp = np.cumsum(np.concatenate(fps)[order])
            recall = tp / num_gts
            precision = tp / np.maximum(tp + fp, 1e-9)
            for i in range(len(precision) - 2, -1, -1):
                precision[i] = max(precision[i], precision[i + 1])
            inds = np.searchsorted(recall, _REC_POINTS, side="left")
            q = np.zeros(len(_REC_POINTS))
            ok = inds < len(precision)
            q[ok] = precision[inds[ok]]
            ap_per_thr[t].append(float(np.mean(q)))
    if not ap_per_thr[iou_thrs[0]]:
        return {"mAP": 0.0, "AP@50": 0.0}
    return {
        "mAP": float(np.mean([np.mean(v) for v in ap_per_thr.values()])),
        "AP@50": float(np.mean(ap_per_thr[iou_thrs[0]])),
    }
