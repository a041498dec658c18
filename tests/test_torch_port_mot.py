"""DeepSORT and Tracktor (``models/mot/deep_sort.py``) against the JAX
package's objects on the CPU, f32, with a tiny detector (the CLI's
``--tiny`` bucket, 64x64, one class, a 32-channel neck; its variables drawn
in the JAX model's shapes and bridged) and the R50 ReID net on 64x32 crops
(both sides' crop size patched from 256x128 for speed):

- the private path over 5 frames: detections (in order) within 1e-4,
  equal track ids and boxes each frame, the ReID embeddings in the
  tracks within 1e-4 of the largest; ``track_video`` equals
  ``track_frame`` frame by frame;
- the public path (every box embedded; JAX in padded chunks of 32, the
  port at once): equal ids, embeddings within 1e-4;
- ROADMAP fault F2: on a frame with 60 detections above the tracker's
  threshold (the detector stubbed on both sides), both keep and track the
  first 48, where the original would embed all 60;
- ROADMAP fault F15: ``inference_mot`` on 96x96 frames (scale factor 2/3
  into the bucket): the port's boxes are JAX's divided by the factor, the
  ids equal; public boxes given in the frame are scaled into the bucket;
- Tracktor: ``regress`` within 1e-4; 5 frames with linear motion, equal
  ids and boxes within 1e-4;
- ROADMAP fault F16: Tracktor with camera motion compensation on a
  panning sequence: given the raw frames (as ``inference_mot`` does on
  both sides, and the port's CLI) the port equals JAX; the JAX CLI's call
  (no raw frame) leaves the warp out, and its track boxes differ.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_dark_backbones import draw
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.apis import (
    inference as TI,
)
from lowlightenvironmentvideoobjectdetection_torch.core import nms as TN
from lowlightenvironmentvideoobjectdetection_torch.data.preprocess import (
    prepare_frames as t_prepare,
)
from lowlightenvironmentvideoobjectdetection_torch.models.detectors import (
    faster_rcnn as TR,
)
from lowlightenvironmentvideoobjectdetection_torch.models.mot import (
    deep_sort as TD,
    trackers as TT,
)
from lowlightenvironmentvideoobjectdetection_torch.models.reid.base_reid import (  # noqa: E501
    BaseReID as TReID,
)
from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
    selsa as TS,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)
from lowlightenvironmentvideoobjectdetection_tpu.apis import (
    inference as JI,
)
from lowlightenvironmentvideoobjectdetection_tpu.core import nms as JN
from lowlightenvironmentvideoobjectdetection_tpu.data.preprocess import (
    prepare_frames as j_prepare,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.detectors import (
    faster_rcnn as JR,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.mot import (
    deep_sort as JD,
    trackers as JT,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.reid.base_reid import (  # noqa: E501
    BaseReID as JReID,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.vid import (
    selsa as JS,
)

TINY = dict(pad_h=64, pad_w=64, test_nms_pre=64, test_nms_post=16,
            neck_channels=32, num_classes=1)
CROP = (64, 32)
BOX_TOL = 1e-4
EMBED_REL = 1e-4
FRAMES = 5
SORT_KW = dict(obj_score_thr=0.3, reid_sim_thr=2.0, match_iou_thr=0.5,
               num_tentatives=2, num_frames_retain=3)


_pinned_threads = thread_count(1)


def tamed(var):
    """Drawn detector variables with small box deltas (the RPN's and the
    head's regression layers scaled by 0.1, so boxes stay near their
    anchors and proposals instead of clipping to the border) and spread
    scores (the head's classifier scaled by 4, so no two detections tie
    within f32 rounding)."""
    p = var["params"]
    for mod, leaf, f in (("rpn_head", "rpn_reg", 0.1),
                         ("bbox_head", "fc_reg", 0.1),
                         ("bbox_head", "fc_cls", 4.0)):
        p[mod][leaf] = {k: v * np.float32(f) for k, v in p[mod][leaf].items()}
    return var


@pytest.fixture(scope="module")
def nets():
    torch.set_num_threads(1)
    jdet = JR.FasterRCNN(cfg=JS.SelsaConfig(compute_dtype=jnp.float32,
                                            **TINY))
    shapes = jax.eval_shape(jdet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    dvar = tamed(jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(3))))
    tdet = TR.FasterRCNN(TS.SelsaConfig(compute_dtype=torch.float32, **TINY))
    tdet.load_state_dict(from_jax_variables(dvar), strict=True)
    jreid = JReID(dtype=jnp.float32)
    shapes = jax.eval_shape(jreid.init, jax.random.PRNGKey(1),
                            jnp.zeros((1,) + CROP + (3,)))
    rvar = jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(4)))
    treid = TReID(dtype=torch.float32)
    treid.load_state_dict(from_jax_variables(rvar), strict=True)
    return dict(jdet=jdet, dvar=dvar, janchors=JS.make_anchors(jdet.cfg),
                tdet=tdet.eval(), tanchors=TS.make_anchors(tdet.cfg),
                jreid=jreid, rvar=rvar, treid=treid.eval())


@pytest.fixture
def small_crops(monkeypatch):
    monkeypatch.setattr(JD, "crop_and_resize", functools.partial(
        JD.crop_and_resize, out_hw=CROP))
    monkeypatch.setattr(TD, "crop_and_resize", functools.partial(
        TD.crop_and_resize, out_hw=CROP))


def deepsorts(nets, **tracker_kw):
    kw = dict(SORT_KW, **tracker_kw)
    j = JD.DeepSORT(nets["jdet"], nets["dvar"], nets["janchors"],
                    nets["jreid"], nets["rvar"], tracker=JT.SortTracker(**kw))
    t = TD.DeepSORT(nets["tdet"], nets["tanchors"], nets["treid"],
                    tracker=TT.SortTracker(**kw))
    return j, t


def tracktors(nets, **kw):
    tk = dict(obj_score_thr=0.3, regression_score_thr=0.0, nms_iou_thr=0.6)
    j = JD.Tracktor(nets["jdet"], nets["dvar"], nets["janchors"],
                    tracker=JT.TracktorTracker(**tk), **kw)
    t = TD.Tracktor(nets["tdet"], nets["tanchors"],
                    tracker=TT.TracktorTracker(**tk), **kw)
    return j, t


def frames(seed, n=FRAMES, hw=(64, 64)):
    """Raw BGR frames [H, W, 3] (float32) of a textured scene with three
    bright blobs moving right 3 px a frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 200, hw + (3,)).astype(np.float32)
    raw = []
    for f in range(n):
        img = base.copy()
        for k in range(3):
            y, x = 8 + 18 * k, 4 + 3 * f + 10 * k
            img[y:y + 14, x:x + 10] = 255 - 40 * k
        raw.append(img)
    return raw


def _prepared(raw):
    jimgs, jshape, _ = j_prepare(raw[None], 64, 64)
    timgs, tshape, _ = t_prepare(raw[None], 64, 64, device="cpu")
    return (jimgs[0], jshape), (timgs[0], tshape)


def _same_result(t, j, box_tol=BOX_TOL):
    for key in ("det_bboxes", "track_bboxes"):
        a, b = np.asarray(t[key]), np.asarray(j[key])
        assert a.shape == b.shape, key
        np.testing.assert_allclose(a, b, rtol=0, atol=box_tol, err_msg=key)
    np.testing.assert_array_equal(t["track_bboxes"][:, 0],
                                  np.asarray(j["track_bboxes"])[:, 0])


def _same_embeds(t, j):
    for tid in j.tracker.tracks:
        a, b = t.tracker.tracks[tid].embed, j.tracker.tracks[tid].embed
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=EMBED_REL * np.abs(b).max())


def test_deepsort_private_path_matches_jax(nets, small_crops):
    j, t = deepsorts(nets)
    tracked = 0
    results = []
    for f, raw in enumerate(frames(0)):
        (ji, js), (ti, ts) = _prepared(raw)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-5)
        rj = j.track_frame(f, ji, np.asarray(js))
        rt = t.track_frame(f, ti, ts)
        _same_result(rt, rj)
        _same_embeds(t, j)
        tracked += len(rt["track_bboxes"])
        results.append((ti, ts, rt))
    assert tracked > 0 and t.tracker.num_tracks > 0
    again = t.track_video([r[0] for r in results], results[0][1])
    for a, (_, _, b) in zip(again, results):
        for key in ("det_bboxes", "track_bboxes", "track_labels"):
            np.testing.assert_array_equal(a[key], b[key])


def test_deepsort_public_path_matches_jax(nets, small_crops):
    j, t = deepsorts(nets)
    rng = np.random.default_rng(1)
    start = rng.uniform(0, 30, (4, 2))
    for f, raw in enumerate(frames(1)):
        (ji, js), (ti, ts) = _prepared(raw)
        xy = start + 2.0 * f
        pub = np.concatenate([xy, xy + 20, rng.uniform(0.5, 1, (4, 1))],
                             1).astype(np.float32)
        rj = j.track_frame(f, ji, np.asarray(js), public_bboxes=pub)
        rt = t.track_frame(f, ti, ts, public_bboxes=pub)
        _same_result(rt, rj, box_tol=0.0)
        _same_embeds(t, j)
    assert t.tracker.num_tracks == 4


def _stub_dets(n_valid, seed, lib):
    """A detector output of 100 rows, the first ``n_valid`` valid and
    score-descending above 0.3, as multiclass NMS gives."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 48, (100, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(6, 14, (100, 2))], 1)
    scores = np.sort(rng.uniform(0.35, 0.99, 100))[::-1].copy()
    valid = np.arange(100) < n_valid
    arrs = (boxes.astype(np.float32), scores.astype(np.float32),
            np.zeros(100, np.int32), valid)
    if lib == "jax":
        return JN.DetResult(*(jnp.asarray(a) for a in arrs))
    return TN.DetResult(*(torch.from_numpy(a) for a in arrs[:2]),
                        torch.from_numpy(arrs[2]).long(),
                        torch.from_numpy(arrs[3]))


def test_f2_deepsort_tracks_the_top_48_detections(nets, small_crops,
                                                  monkeypatch):
    """60 valid detections: JAX and the port embed and track the first 48
    (score-descending); the original embeds all 60."""
    calls = []
    monkeypatch.setattr(JD, "faster_rcnn_detect",
                        lambda *a, **k: _stub_dets(60, len(calls), "jax"))

    def port_stub(*a, **k):
        calls.append(1)
        return _stub_dets(60, len(calls) - 1, "torch")

    monkeypatch.setattr(TD, "faster_rcnn_detect", port_stub)
    j, t = deepsorts(nets)
    (ji, js), (ti, ts) = _prepared(frames(2, n=1)[0])
    rj = j.track_frame(0, ji, np.asarray(js))
    rt = t.track_frame(0, ti, ts)
    assert int(_stub_dets(60, 0, "torch").valid.sum()) == 60
    assert len(rj["det_bboxes"]) == len(rt["det_bboxes"]) == 48
    assert len(rt["track_bboxes"]) == 48
    _same_result(rt, rj)


def test_f15_inference_mot_rescales_to_the_frame(nets, small_crops):
    """On 96x96 frames (scale factor 2/3 into the 64x64 bucket) JAX's
    ``inference_mot`` returns boxes of the resized frame; the port's are
    those divided by the factor; the ids are equal."""
    j, t = deepsorts(nets)
    sf = 64 / 96
    tracked = 0
    for f, raw in enumerate(frames(3, hw=(96, 96))):
        rj = JI.inference_mot(j, raw, f)
        rt = TI.inference_mot(t, raw, f)
        want = dict(rj, det_bboxes=np.array(rj["det_bboxes"]),
                    track_bboxes=np.array(rj["track_bboxes"]))
        want["det_bboxes"][:, :4] /= sf
        want["track_bboxes"][:, 1:5] /= sf
        _same_result(rt, want, box_tol=BOX_TOL / sf)
        tracked += len(rt["track_bboxes"])
    assert tracked > 0


def test_f15_inference_mot_scales_public_boxes_into_the_bucket(
        nets, small_crops):
    """Public boxes given in the 96x96 frame: the port's ``inference_mot``
    scales them into the bucket and its results back, so they equal JAX's
    ``track_frame`` on the boxes scaled by hand, divided by the factor."""
    j, t = deepsorts(nets)
    rng = np.random.default_rng(4)
    start = rng.uniform(0, 45, (4, 2))
    for f, raw in enumerate(frames(4, hw=(96, 96))):
        xy = start + 3.0 * f
        pub = np.concatenate([xy, xy + 30, rng.uniform(0.5, 1, (4, 1))],
                             1).astype(np.float32)
        jimgs, jshape, sf = j_prepare(raw[None], 64, 64)
        jpub = pub.copy()
        jpub[:, :4] *= sf
        rj = j.track_frame(f, jimgs[0], np.asarray(jshape),
                           public_bboxes=jpub)
        rt = TI.inference_mot(t, raw, f, public_bboxes=pub)
        want = dict(rj, det_bboxes=np.array(rj["det_bboxes"]),
                    track_bboxes=np.array(rj["track_bboxes"]))
        want["det_bboxes"][:, :4] /= sf
        want["track_bboxes"][:, 1:5] /= sf
        _same_result(rt, want, box_tol=BOX_TOL * 96 / 64)
    assert t.tracker.num_tracks == 4


def test_tracktor_regress_matches_jax(nets):
    j, t = tracktors(nets)
    (ji, js), (ti, ts) = _prepared(frames(4, n=1)[0])
    boxes = np.array([[4.0, 6, 30, 40], [20, 10, 60, 50], [0, 0, 64, 64]],
                     np.float32)
    pad = np.zeros((j.max_tracks - 3, 4), np.float32)
    jb, jsc = j._regress_step(ji, js, jnp.asarray(np.concatenate([boxes,
                                                                  pad])))
    with torch.no_grad():
        feat = nets["tdet"].extract_feat(ti[None])
    tb, tsc = t.regress(feat, boxes)
    np.testing.assert_allclose(tb, np.asarray(jb)[:3], rtol=0, atol=BOX_TOL)
    np.testing.assert_allclose(tsc, np.asarray(jsc)[:3], rtol=0, atol=1e-5)


def test_tracktor_matches_jax(nets):
    j, t = tracktors(nets, with_linear_motion=True)
    tracked = 0
    for f, raw in enumerate(frames(5)):
        (ji, js), (ti, ts) = _prepared(raw)
        rj = j.track_frame(f, ji, np.asarray(js))
        rt = t.track_frame(f, ti, ts)
        _same_result(rt, rj)
        tracked += len(rt["track_bboxes"])
    assert tracked > FRAMES


def test_f16_tracktor_cmc_needs_the_raw_frame(nets):
    """A camera panning 3 px a frame: with the raw frames the port's
    Tracktor equals JAX's (ECC within 0.05 px moves boxes by as much);
    without them, as the JAX CLI calls it, the warp is left out and the
    boxes differ."""
    j, t = tracktors(nets, with_cmc=True)
    j_cli, _ = tracktors(nets, with_cmc=True)
    rng = np.random.default_rng(6)
    scene = rng.integers(0, 256, (64, 120, 3)).astype(np.float32)
    scene = np.asarray(jax.image.resize(scene, (64, 120, 3), "linear"))
    moved = 0.0
    for f in range(4):
        raw = np.ascontiguousarray(scene[:, 3 * f:3 * f + 64]).round()
        (ji, js), (ti, ts) = _prepared(raw)
        rj = j.track_frame(f, ji, np.asarray(js), raw_img=raw)
        rt = t.track_frame(f, ti, ts, raw_img=torch.from_numpy(raw))
        rc = j_cli.track_frame(f, ji, np.asarray(js))
        _same_result(rt, rj, box_tol=0.1)
        if f and len(rc["track_bboxes"]) == len(rj["track_bboxes"]):
            moved = max(moved, np.abs(rc["track_bboxes"][:, 1:5]
                                      - rj["track_bboxes"][:, 1:5]).max())
    assert moved > 1.0
