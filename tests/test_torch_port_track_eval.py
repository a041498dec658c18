"""Tracking evaluation and datasets against the JAX package (host numpy):

- ``core/eval/mot.py`` ``eval_mot`` (CLEAR-MOT, IDF1, MT/PT/ML) and
  ``core/eval/sot.py`` ``eval_sot_ope`` equal JAX's on seeded results with
  jitter, id switches, misses and false positives;
- ``data/mot_sot_datasets.py``: ``MOTChallengeDataset`` on a tree of
  ``write_mot_tree`` (frames, annotations, the public ``detection_file``,
  ``visibility_thr``) and ``LaSOTDataset`` on one of ``write_lasot_tree``
  (``get_video``) read the same as JAX's; their ``evaluate`` gives equal
  metrics and ``format_results`` equal MOT txt files.
"""

import os

import numpy as np
import pytest
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.core.eval import (
    mot as TM,
    sot as TSO,
)
from lowlightenvironmentvideoobjectdetection_torch.data import (
    mot_sot_datasets as TD,
)
from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
    write_lasot_tree,
    write_mot_tree,
)
from lowlightenvironmentvideoobjectdetection_tpu.core.eval import (
    mot as JM,
    sot as JSO,
)
from lowlightenvironmentvideoobjectdetection_tpu.data import (
    mot_sot_datasets as JD,
)


_pinned_threads = thread_count(1)


def _mot_results(seed, n_videos=2, n_frames=12, n_obj=5):
    """Per video, per frame gt and predictions: boxes jittered, two ids
    swapped halfway, some misses and false positives."""
    rng = np.random.default_rng(seed)
    gts, preds = [], []
    for _ in range(n_videos):
        start = rng.uniform(0, 200, (n_obj, 2))
        vel = rng.uniform(-3, 3, (n_obj, 2))
        gv, pv = [], []
        for f in range(n_frames):
            xy = start + vel * f
            boxes = np.concatenate([xy, xy + 40], 1)
            ids = np.arange(n_obj)
            gv.append(dict(bboxes=boxes, ids=ids))
            keep = rng.random(n_obj) > 0.15
            pb = boxes[keep] + rng.normal(0, 3, (keep.sum(), 4))
            pid = ids[keep] + 100
            if f >= n_frames // 2:
                pid = np.where(pid == 100, 101, np.where(pid == 101, 100,
                                                         pid))
            if rng.random() < 0.4:
                pb = np.concatenate([pb, rng.uniform(0, 300, (1, 4)) + [
                    0, 0, 30, 30]])
                pid = np.concatenate([pid, [900 + f]])
            pv.append(dict(bboxes=pb, ids=pid))
        gts.append(gv)
        preds.append(pv)
    return gts, preds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval_mot_matches_jax(seed):
    gts, preds = _mot_results(seed)
    got = TM.eval_mot(gts, preds)
    assert got == JM.eval_mot(gts, preds)
    assert got["IDSw"] > 0 and got["FP"] > 0 and got["FN"] > 0


def test_eval_sot_ope_matches_jax():
    rng = np.random.default_rng(3)
    anns, res = [], []
    for _ in range(3):
        xy = rng.uniform(0, 100, (20, 2))
        wh = rng.uniform(10, 50, (20, 2))
        a = np.concatenate([xy, xy + wh], 1)
        anns.append(list(a))
        res.append(list(a + rng.normal(0, 6, a.shape)))
    assert TSO.eval_sot_ope(res, anns) == JSO.eval_sot_ope(res, anns)


@pytest.fixture(scope="module")
def mot_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("mot_tree")
    ann, dets = write_mot_tree(str(root), videos=2, frames=5, hw=(48, 64),
                               objects=3, seed=1)
    return str(root), ann, dets


def _mot_datasets(tree, **kw):
    root, ann, dets = tree
    return [mod.MOTChallengeDataset(ann_file=ann, img_prefix=root + "/",
                                    test_mode=True, detection_file=dets,
                                    **kw) for mod in (TD, JD)]


@pytest.mark.parametrize("visibility_thr", [-1.0, 0.5])
def test_mot_dataset_reads_as_jax(mot_tree, visibility_thr):
    t, j = _mot_datasets(mot_tree, visibility_thr=visibility_thr)
    assert t.data_infos == j.data_infos and len(t.data_infos) == 10
    assert t.detections == j.detections
    for info in t.data_infos:
        a, b = t.get_ann_info(info), j.get_ann_info(info)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        assert os.path.exists(os.path.join(t.img_prefix, info["filename"]))


def _track_results(ds, seed):
    """Per frame track boxes (id, x1, y1, x2, y2, score): the gts jittered,
    the last id of each frame renumbered from frame 3 on."""
    rng = np.random.default_rng(seed)
    out = []
    for info in ds.data_infos:
        ann = ds.get_ann_info(info)
        n = len(ann["bboxes"])
        ids = ann["instance_ids"].astype(np.float32)
        if info["frame_id"] >= 3:
            ids[-1] += 50
        rows = np.concatenate([ids[:, None], ann["bboxes"]
                               + rng.normal(0, 1, (n, 4)),
                               rng.uniform(0.5, 1, (n, 1))], 1)
        out.append(dict(track_bboxes=rows.astype(np.float32)))
    return out


def test_mot_dataset_evaluate_and_format_match_jax(mot_tree, tmp_path):
    t, j = _mot_datasets(mot_tree)
    results = _track_results(t, 4)
    assert t.evaluate(results) == j.evaluate(results)
    tp = t.format_results(results, str(tmp_path / "port"))
    jp = j.format_results(results, str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in tp] == \
        [os.path.basename(p) for p in jp] and len(tp) == 2
    for a, b in zip(tp, jp):
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()


def test_lasot_dataset_matches_jax(tmp_path):
    ann = write_lasot_tree(str(tmp_path), videos=2, frames=5, hw=(48, 64),
                           seed=2)
    t, j = [mod.LaSOTDataset(ann_file=ann, img_prefix=str(tmp_path) + "/",
                             test_mode=True) for mod in (TD, JD)]
    assert t.num_videos == j.num_videos == 2
    rng = np.random.default_rng(5)
    results = []
    for v in range(2):
        a, b = t.get_video(v), j.get_video(v)
        assert a["frames"] == b["frames"]
        np.testing.assert_array_equal(a["gt_bboxes"], b["gt_bboxes"])
        results.append(a["gt_bboxes"] + rng.normal(0, 2, (5, 4)))
    assert t.evaluate(results) == j.evaluate(results)
