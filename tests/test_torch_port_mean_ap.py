"""The port's ``core/eval/mean_ap.py`` against the JAX package's, on the same
detections and gts drawn from a seed with numpy: ``eval_map`` with
``dataset`` None ('area' AP, ``tpfp_default``), 'vid' (``tpfp_imagenet``)
and 'voc07' ('11points'), with ``scale_ranges``, with ignored gts, with
frames without gts and classes without detections; ``eval_coco_ap``; and
``bbox_overlaps`` in 'iou' and 'iof' mode. Tolerance: equal (the mAP and
each class's ``ap``, ``recall``, ``precision``, ``num_gts`` and
``num_dets`` with ``assert_array_equal``)."""

import numpy as np
import pytest
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.core.eval import (
    mean_ap as tmap,
)
from lowlightenvironmentvideoobjectdetection_tpu.core.eval import (
    mean_ap as jmap,
)

NUM_CLASSES = 4
NUM_IMGS = 6


_pinned_threads = thread_count(1)


def _boxes(rng, n, size=200.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(4, 80, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _world(seed, empty=False, ignore=False):
    """Per image: gts of random classes and, per class, detections that
    jitter some gts (true positives at several IoUs) among random boxes.
    ``empty`` leaves every other image without gts and the last class
    without detections; ``ignore`` adds ignored gts."""
    rng = np.random.RandomState(seed)
    dets, anns = [], []
    for i in range(NUM_IMGS):
        n_gt = 0 if empty and i % 2 else rng.randint(1, 7)
        gts = _boxes(rng, n_gt)
        labels = rng.randint(0, NUM_CLASSES, n_gt).astype(np.int64)
        ann = dict(bboxes=gts, labels=labels)
        if ignore:
            n_ig = rng.randint(1, 4)
            ann["bboxes_ignore"] = _boxes(rng, n_ig)
            ann["labels_ignore"] = rng.randint(0, NUM_CLASSES, n_ig)
        per_cls = []
        for c in range(NUM_CLASSES):
            near = gts[labels == c]
            near = near + rng.normal(0, 6, near.shape).astype(np.float32)
            rand = _boxes(rng, rng.randint(0, 4))
            boxes = np.concatenate([near, rand])
            if ignore and len(ann["bboxes_ignore"]):
                boxes = np.concatenate([boxes, ann["bboxes_ignore"][:1] + 1])
            if empty and c == NUM_CLASSES - 1:
                boxes = boxes[:0]
            # a few repeated scores, so that the order of ties counts
            scores = np.round(rng.uniform(0, 1, len(boxes)), 1)
            per_cls.append(np.concatenate([boxes, scores[:, None]],
                                          1).astype(np.float32))
        dets.append(per_cls)
        anns.append(ann)
    return dets, anns


def _same_eval(got, want):
    (tm, tres), (jm, jres) = got, want
    np.testing.assert_array_equal(np.asarray(tm), np.asarray(jm))
    assert len(tres) == len(jres)
    for t, j in zip(tres, jres):
        assert set(t) == set(j)
        for k in j:
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]),
                                          err_msg=k)


CASES = ["default", "vid", "voc07", "scale_ranges", "scale_ranges_vid",
         "ignore", "ignore_vid", "empty", "empty_vid", "coco", "coco_empty",
         "overlaps_iou", "overlaps_iof"]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("case", CASES)
def test_mean_ap_equals_jax(case, seed):
    if case.startswith("overlaps"):
        rng = np.random.RandomState(seed)
        a, b = _boxes(rng, 7), _boxes(rng, 5)
        mode = case.split("_")[1]
        got = tmap.bbox_overlaps(a, b, mode=mode)
        np.testing.assert_array_equal(got, jmap.bbox_overlaps(a, b,
                                                              mode=mode))
        assert got.dtype == np.float32 and got.shape == (7, 5)
        assert (got > 0).any()
        return
    dets, anns = _world(seed, empty="empty" in case,
                        ignore=case.startswith("ignore"))
    if case.startswith("coco"):
        got = tmap.eval_coco_ap(dets, anns)
        assert got == jmap.eval_coco_ap(dets, anns)
        assert 0 < got["AP50"] <= 1
        return
    kw = dict(dataset="vid" if case.endswith("vid") else
              "voc07" if case == "voc07" else None)
    if case.startswith("scale_ranges"):
        kw["scale_ranges"] = [(0, 32), (32, 64), (64, 1e5)]
    got = tmap.eval_map(dets, anns, **kw)
    _same_eval(got, jmap.eval_map(dets, anns, **kw))
    assert 0 < np.max(got[0]) <= 1
    for thr in (0.3, 0.75):  # other IoU thresholds
        _same_eval(tmap.eval_map(dets, anns, iou_thr=thr, **kw),
                   jmap.eval_map(dets, anns, iou_thr=thr, **kw))
