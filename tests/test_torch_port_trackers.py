"""The port's host-side tracking (numpy) against the JAX package's:

- ``core/motion/kalman.py``: ``KalmanFilter``'s single and batched
  predict, project, update and gating, and ``track``, to 1e-12;
- ``models/mot/trackers.py``: ``SortTracker`` and ``TracktorTracker`` over
  scripted 10-frame sequences with births, ReID matches, IoU matches,
  tentative tracks confirmed, tracks lost and expired: equal ids each
  frame and equal track states (box, score, label, frame, embedding,
  Kalman mean and covariance, tentative, hits) after each frame;
- ``core/motion/linear.py``: ``LinearMotion`` and ``PhaseCorrelationCMC``
  (the JAX module's ``CameraMotionCompensation``) equal, at downscale 1
  and 4, and the latter recovers a known shift;
- ``core/track_utils.py``: ``imrenormalize``, ``track2result``,
  ``restore_result``, ``embed_similarity`` equal.
"""

import numpy as np
import pytest
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.core import (
    track_utils as TU,
)
from lowlightenvironmentvideoobjectdetection_torch.core.motion import (
    kalman as TK,
    linear as TL,
)
from lowlightenvironmentvideoobjectdetection_torch.models.mot import (
    trackers as TT,
)
from lowlightenvironmentvideoobjectdetection_tpu.core import (
    track_utils as JU,
)
from lowlightenvironmentvideoobjectdetection_tpu.core.motion import (
    kalman as JK,
    linear as JL,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.mot import (
    trackers as JT,
)

KALMAN_TOL = 1e-12
FRAMES = 10


_pinned_threads = thread_count(1)


def test_kalman_filter_matches_jax():
    rng = np.random.default_rng(0)
    jk, tk = JK.KalmanFilter(), TK.KalmanFilter()
    meas = np.abs(rng.normal(50, 20, (6, 4))) + 1
    for m in meas:
        for a, b in zip(tk.initiate(m), jk.initiate(m)):
            np.testing.assert_allclose(a, b, rtol=0, atol=KALMAN_TOL)
    mean, cov = jk.initiate(meas[0])
    for fn in ("predict", "project"):
        for a, b in zip(getattr(tk, fn)(mean, cov), getattr(jk, fn)(mean, cov)):
            np.testing.assert_allclose(a, b, rtol=0, atol=KALMAN_TOL)
    for a, b in zip(tk.update(mean, cov, meas[1]),
                    jk.update(mean, cov, meas[1])):
        np.testing.assert_allclose(a, b, rtol=0, atol=KALMAN_TOL)
    for only in (False, True):
        np.testing.assert_allclose(
            tk.gating_distance(mean, cov, meas, only),
            jk.gating_distance(mean, cov, meas, only), rtol=KALMAN_TOL)
    states = [jk.predict(*jk.initiate(m)) for m in meas]
    means = np.stack([s[0] for s in states])
    covs = np.stack([s[1] for s in states])
    for fn, args in (("predict_batch", (means, covs)),
                     ("project_batch", (means, covs)),
                     ("update_batch", (means, covs, meas[::-1])),
                     ("gating_distance_batch", (means, covs, meas))):
        got, want = getattr(tk, fn)(*args), getattr(jk, fn)(*args)
        for a, b in zip(got if isinstance(got, tuple) else [got],
                        want if isinstance(want, tuple) else [want]):
            np.testing.assert_allclose(a, b, rtol=KALMAN_TOL,
                                       atol=KALMAN_TOL)
    assert TK.CHI2INV95 == JK.CHI2INV95


def _objects(rng, n):
    """n objects: start boxes [n, 4], velocities [n, 2], embeddings."""
    xy = rng.uniform(0, 400, (n, 2))
    wh = rng.uniform(30, 80, (n, 2))
    return (np.concatenate([xy, xy + wh], 1), rng.uniform(-6, 6, (n, 2)),
            rng.normal(0, 1, (n, 16)))


def _sort_frames(seed):
    """Per frame: (boxes, scores, labels, embeds). Objects 0-3 move
    linearly; object 4 is born at frame 3; object 1 is missed at frames 4
    and 5 (then found again by ReID); object 2 leaves after frame 2 and
    expires; a low-score detection appears at frame 6; detections come
    in a shuffled order."""
    rng = np.random.default_rng(seed)
    start, vel, emb = _objects(rng, 5)
    out = []
    for f in range(FRAMES):
        keep = [i for i in range(5)
                if not (i == 4 and f < 3) and not (i == 1 and f in (4, 5))
                and not (i == 2 and f > 2)]
        boxes = start[keep] + np.tile(vel[keep] * f, 2) \
            + rng.normal(0, 0.5, (len(keep), 4))
        scores = rng.uniform(0.6, 0.99, len(keep))
        embeds = emb[keep] + rng.normal(0, 0.05, (len(keep), 16))
        if f == 6:
            boxes = np.concatenate([boxes, [[10.0, 10, 40, 60]]])
            scores = np.concatenate([scores, [0.1]])
            embeds = np.concatenate([embeds, rng.normal(0, 1, (1, 16))])
        order = rng.permutation(len(boxes))
        out.append((boxes[order].astype(np.float32),
                    scores[order].astype(np.float32),
                    np.zeros(len(boxes), np.int64),
                    embeds[order].astype(np.float32)))
    return out


def _same_tracks(t, j):
    assert list(t.tracks) == list(j.tracks)
    assert t.num_tracks == j.num_tracks
    for tid in t.tracks:
        a, b = t.tracks[tid], j.tracks[tid]
        np.testing.assert_array_equal(a.bbox, b.bbox)
        assert (a.score, a.label, a.frame_id, a.tentative, a.hits) == \
            (b.score, b.label, b.frame_id, b.tentative, b.hits)
        for x, y in ((a.embed, b.embed), (a.mean, b.mean),
                     (a.covariance, b.covariance)):
            if y is None:
                assert x is None
            else:
                np.testing.assert_allclose(x, y, rtol=0, atol=KALMAN_TOL)


@pytest.mark.parametrize("with_embeds", [True, False],
                         ids=["reid", "iou_only"])
def test_sort_tracker_matches_jax(with_embeds):
    kw = dict(obj_score_thr=0.5, reid_sim_thr=2.0, match_iou_thr=0.5,
              num_tentatives=2, num_frames_retain=3,
              momentums=dict(embeds=0.5))
    t, j = TT.SortTracker(**kw), JT.SortTracker(**kw)
    confirmed = expired = 0
    for f, (boxes, scores, labels, embeds) in enumerate(_sort_frames(0)):
        e = embeds if with_embeds else None
        ti, tv = t.track(f, boxes, scores, labels, e)
        ji, jv = j.track(f, boxes, scores, labels, e)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv, jv)
        _same_tracks(t, j)
        confirmed += sum(not x.tentative for x in t.tracks.values())
        expired += len(t.tracks) < t.num_tracks
    assert t.num_tracks >= 5 and confirmed and expired


def test_tracktor_tracker_matches_jax():
    rng = np.random.default_rng(1)
    kw = dict(obj_score_thr=0.5, regression_score_thr=0.5, nms_iou_thr=0.6,
              num_frames_retain=3)
    t, j = TT.TracktorTracker(**kw), JT.TracktorTracker(**kw)
    frames = _sort_frames(1)
    for f, (boxes, scores, labels, _) in enumerate(frames):
        reg_b = reg_s = None
        if t.ids:
            prev = np.stack([t.tracks[i].bbox for i in t.ids])
            reg_b = (prev + rng.normal(0, 1, prev.shape)).astype(np.float32)
            reg_s = rng.uniform(0.2, 1.0, len(prev)).astype(np.float32)
        got = t.track(f, boxes, scores, labels, reg_b, reg_s)
        want = j.track(f, boxes, scores, labels, reg_b, reg_s)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        _same_tracks(t, j)


def test_box_helpers_match_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 50, (7, 4))
    a[:, 2:] += a[:, :2] + 1
    b = a[::-1] + 3
    np.testing.assert_array_equal(TT.xyxy2xyah(a), JT.xyxy2xyah(a))
    np.testing.assert_array_equal(TT.xyah2xyxy(a), JT.xyah2xyxy(a))
    np.testing.assert_array_equal(TT.iou_matrix(a, b), JT.iou_matrix(a, b))
    assert TT.iou_matrix(a[:0], b).shape == (0, 7)


@pytest.mark.parametrize("downscale", [1, 4])
def test_linear_motion_and_phase_correlation_match_jax(downscale):
    rng = np.random.default_rng(3)
    hist = [rng.uniform(0, 100, 4).astype(np.float32) for _ in range(5)]
    for n in (1, 2, 4):
        np.testing.assert_array_equal(TL.LinearMotion(n).step(hist),
                                      JL.LinearMotion(n).step(hist))
    prev = rng.uniform(0, 255, (64, 96, 3))
    cur = np.roll(prev, (4, -8), (0, 1))
    boxes = rng.uniform(0, 60, (3, 4))
    got = TL.PhaseCorrelationCMC(downscale).track(prev, cur, boxes)
    np.testing.assert_array_equal(
        got, JL.CameraMotionCompensation(downscale).track(prev, cur, boxes))
    np.testing.assert_allclose(got - np.asarray(boxes, np.float32),
                               [[-8, 4, -8, 4]] * 3)


def test_track_utils_match_jax():
    rng = np.random.default_rng(4)
    img = rng.normal(0, 1, (5, 6, 3)).astype(np.float32)
    c1 = dict(mean=[1.0, 2, 3], std=[2.0, 3, 4], to_rgb=False)
    c2 = dict(mean=[0.5, 0.4, 0.3], std=[1.0, 1, 2], to_rgb=True)
    np.testing.assert_array_equal(TU.imrenormalize(img, c1, c2),
                                  JU.imrenormalize(img, c1, c2))
    bboxes = rng.uniform(0, 9, (6, 5))
    labels = np.array([0, 1, 1, 2, 0, 1])
    ids = np.arange(6) + 10
    res = TU.track2result(bboxes, labels, ids, 3)
    for a, b in zip(res, JU.track2result(bboxes, labels, ids, 3)):
        np.testing.assert_array_equal(a, b)
    for ri in (True, False):
        r = res if ri else [x[:, 1:] for x in res]
        for a, b in zip(TU.restore_result(r, ri), JU.restore_result(r, ri)):
            np.testing.assert_array_equal(a, b)
    k, r = rng.normal(0, 1, (4, 8)), rng.normal(0, 1, (3, 8))
    for method, temp in (("dot_product", -1), ("cosine", 0.5)):
        np.testing.assert_array_equal(
            TU.embed_similarity(k, r, method, temp),
            JU.embed_similarity(k, r, method, temp))
