"""The parts of the DC5 two-stage families in the port against the JAX
package on the CPU, exactly where they select and to float rounding where
they compute:

- ``region_assign`` (Cascade RPN's stage 1) on two levels, with and
  without the adjacent-level ignore; ``nms_match``;
  ``score_hlr_sample_gather`` (PISA's ScoreHLR) on the JAX key's uniforms;
  ``isr_p_roi_weights`` with tied IoUs inside a (class, gt) group (the
  stable double sorts rank them in index order on both sides);
- ``bbox_targets`` with the stage thresholds, stds and without the gts,
  ``bbox_loss`` class-agnostic (Cascade R-CNN's heads);
- Grid R-CNN's ``grid_targets``, ``grid_points_decode`` with saturated
  (tied) maxima, the grouped 4x4 transposed conv as the bridge lays it out
  against the JAX ``_gdeconv``, and the grid head in training (fused and
  unfused heatmaps);
- ``roi_rescale`` at 1.3x past the map, through RoIAlign;
- ``DynamicSchedule`` over 250 records (interval 100) against the JAX
  class, and ROADMAP F31: the JAX family table trains Dynamic R-CNN at the
  schedule's initial values, and no JAX CLI records into a schedule.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_port_dark_backbones import bridged
from test_torch_port_train import sampler_uniforms
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.core import (
    assigners as TA,
    losses as TL,
    nms as TN,
)
from lowlightenvironmentvideoobjectdetection_torch.models.detectors import (
    more_rcnn as TMR,
    roi_head_families as TRH,
)
from lowlightenvironmentvideoobjectdetection_torch.models.roi_heads import (
    bbox_head as TBH,
)
from lowlightenvironmentvideoobjectdetection_torch.ops.roi_align import (
    roi_align,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    _grouped_deconv,
)
from lowlightenvironmentvideoobjectdetection_tpu.core import (
    assigners as JA,
    nms as JN,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.detectors import (
    more_rcnn as JMR,
    roi_head_families as JRH,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.roi_heads import (
    bbox_head as JBH,
)
from lowlightenvironmentvideoobjectdetection_tpu.ops import (
    roi_align as JRA,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_pinned_threads = thread_count(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _boxes(rs, n, span=100.0, size=(4, 60)):
    xy = rs.uniform(-5, span, (n, 2))
    return np.concatenate([xy, xy + rs.uniform(*size, (n, 2))], 1).astype(
        np.float32)


def _assign(rs, n=60, g=5):
    boxes, gts = _boxes(rs, n), _boxes(rs, g)
    gts[1] = boxes[3]  # an exact match
    labels = rs.randint(0, 4, g)
    valid = np.arange(g) < g - 1
    box_valid = rs.rand(n) > 0.1
    args = (boxes, gts, labels, valid, 0.5, 0.5, 0.5)
    ja = JA.max_iou_assign(*(jnp.asarray(a) for a in args[:4]), *args[4:],
                           box_valid=jnp.asarray(box_valid))
    ta = TA.max_iou_assign(*(_t(a) for a in args[:3]), _t(valid), *args[4:],
                           box_valid=_t(box_valid))
    np.testing.assert_array_equal(ta.assigned_gt_inds.numpy(),
                                  np.asarray(ja.assigned_gt_inds))
    return boxes, gts, labels, valid, box_valid, ja, ta


@pytest.mark.parametrize("adjacent", [True, False])
def test_region_assign_matches_jax(adjacent):
    rs = np.random.RandomState(0)
    gts = _boxes(rs, 7, span=100.0, size=(10, 60))
    gts[3] = [10.0, 12.0, 130.0, 115.0]  # level 1
    gts[2] = gts[1] + 4.0  # the later gt overrides the earlier
    valid = np.arange(7) != 5
    sizes, strides = [(16, 20), (8, 10)], [8, 16]
    want = JA.region_assign(jnp.asarray(gts), jnp.asarray(valid), sizes,
                            strides, anchor_scale=8.0,
                            adjacent_ignore=adjacent)
    got = TA.region_assign(_t(gts), _t(valid), sizes, strides, 8.0,
                           adjacent_ignore=adjacent)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got > 0).any() and (got < 0).any() and (got == 0).any()


def test_nms_match_matches_jax():
    rs = np.random.RandomState(1)
    boxes = _boxes(rs, 80, span=60.0, size=(20, 40))
    scores = rs.rand(80).astype(np.float32)
    scores[10:14] = scores[9]  # ties rank in index order
    valid = rs.rand(80) > 0.2
    want = JN.nms_match(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                        valid=jnp.asarray(valid))
    got = TN.nms_match(_t(boxes), _t(scores), 0.5, valid=_t(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == -1).any() and (got != torch.arange(80)).any()


def test_score_hlr_sample_gather_matches_jax():
    rs = np.random.RandomState(2)
    boxes, gts, labels, valid, box_valid, ja, ta = _assign(rs, n=120)
    n = boxes.shape[0]
    score = rs.rand(n).astype(np.float32) * 0.3
    pred = _boxes(rs, n, span=60.0, size=(20, 40))
    ce = rs.rand(n).astype(np.float32) * 3
    key = jax.random.PRNGKey(4)
    js, jw = JA.score_hlr_sample_gather(
        ja, key, 32, 0.25, jnp.asarray(score), jnp.asarray(pred),
        jnp.asarray(ce))
    ts, tw = TA.score_hlr_sample_gather(
        ta, _t(sampler_uniforms(key, n)), 32, 0.25, _t(score), _t(pred),
        _t(ce))
    for g, w in zip(ts, js):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    assert ts.is_valid.all() and (tw != 1).any()


def test_isr_p_weights_with_tied_ious_match_jax():
    rs = np.random.RandomState(3)
    s, nc = 24, 4
    pos = np.arange(s) < 14
    labels = np.where(pos, rs.randint(0, nc, s), nc)
    labels[:6] = 2  # one (class, gt) group of six ...
    gts = rs.randint(0, 3, s)
    gts[:6] = 1
    ious = rs.rand(s).astype(np.float32)
    ious[1:5] = ious[0]  # ... with five equal IoUs
    lw = np.ones(s, np.float32)
    cls = rs.randn(s, nc + 1).astype(np.float32)
    want = JRH.isr_p_roi_weights(*(jnp.asarray(a) for a in (
        labels, gts, ious, pos, lw, cls)), nc)
    got = TRH.isr_p_roi_weights(_t(labels), _t(gts), _t(ious), _t(pos),
                                _t(lw), _t(cls), nc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert len(set(got.numpy()[:5].round(6))) == 5  # the ties ranked apart


def test_bbox_targets_and_class_agnostic_loss_match_jax():
    rs = np.random.RandomState(4)
    props, gts = _boxes(rs, 40), _boxes(rs, 4)
    gts[0] = props[2]
    labels, gvalid = rs.randint(0, 5, 4), np.array([True, True, True, False])
    pvalid = rs.rand(40) > 0.1
    key = jax.random.PRNGKey(5)
    kw = dict(num_classes=5, num_samples=16, pos_iou_thr=0.6,
              neg_iou_thr=0.6, min_pos_iou=0.6, stds=(0.05, 0.05, 0.1, 0.1),
              add_gt_as_proposals=False)
    jt = JBH.bbox_targets(*(jnp.asarray(a) for a in (
        props, pvalid, gts, labels, gvalid)), key, **kw)
    tt = TBH.bbox_targets(_t(props), _t(pvalid), _t(gts), _t(labels).long(),
                          _t(gvalid), _t(sampler_uniforms(key, 40)), **kw)
    for f in ("rois", "labels", "label_weights", "bbox_weights", "is_pos"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    np.testing.assert_allclose(tt.bbox_targets.numpy(),
                               np.asarray(jt.bbox_targets), atol=1e-6)
    assert tt.is_pos.any()
    cls = rs.randn(16, 6).astype(np.float32)
    reg = rs.randn(16, 4).astype(np.float32)
    jl = JBH.bbox_loss(jnp.asarray(cls), jnp.asarray(reg), jt, 5,
                       reg_class_agnostic=True)
    tl = TBH.bbox_loss(_t(cls), _t(reg), tt, 5, reg_class_agnostic=True)
    for g, w in zip(tl, jl):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


def test_grid_targets_match_jax():
    rs = np.random.RandomState(6)
    rois = _boxes(rs, 12, size=(1, 80))
    rois[0, 2:] = rois[0, :2] + 1.0  # too small: no targets
    gts = rois + rs.uniform(-8, 8, rois.shape).astype(np.float32)
    want = JMR.grid_targets(jnp.asarray(rois), jnp.asarray(gts))
    got = TMR.grid_targets(_t(rois), _t(gts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0].sum() == 0 and got[1:].sum() > 0


def test_grid_points_decode_with_tied_maxima_matches_jax():
    rs = np.random.RandomState(7)
    n = 10
    hm = rs.randn(n, 28, 28, 9).astype(np.float32)
    # saturated logits: sigmoid(30) == sigmoid(40) == 1.0 in f32, the
    # first index of the flat 28 x 28 map wins on both sides
    hm[:, 5, 9, :] = 30.0
    hm[:, 3, 20, :] = 40.0
    hm[:, 20, 2, 4] = 35.0
    boxes = _boxes(rs, n)
    shape = np.array([90.0, 110.0], np.float32)
    want = JMR.grid_points_decode(jnp.asarray(hm), jnp.asarray(boxes),
                                  jnp.asarray(shape))
    got = TMR.grid_points_decode(_t(hm), _t(boxes), _t(shape))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    flat = torch.sigmoid(_t(hm)).permute(0, 3, 1, 2).reshape(n, 9, -1)
    assert int(flat.argmax(-1)[0, 0]) == 3 * 28 + 20


@pytest.mark.parametrize("cout", [576, 9])
def test_grouped_deconv_layout_matches_jax(cout):
    rs = np.random.RandomState(8)
    x = rs.randn(3, 7, 7, 576).astype(np.float32)
    w = rs.randn(4, 4, 64, cout).astype(np.float32) * 0.1
    b = rs.randn(cout).astype(np.float32)
    want = JMR.GridHead._gdeconv(jnp.asarray(x), (jnp.asarray(w),
                                                  jnp.asarray(b)))
    got = F.conv_transpose2d(_t(x).permute(0, 3, 1, 2),
                             _t(_grouped_deconv(w).copy()), _t(b), stride=2,
                             padding=1, groups=9).permute(0, 2, 3, 1)
    assert got.shape == (3, 14, 14, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())


def test_grid_head_in_training_matches_jax():
    x = np.random.RandomState(9).randn(3, 14, 14, 16).astype(np.float32)
    jh, th = JMR.GridHead(), TMR.GridHead(16)
    var = bridged(jh, th, x, seed=10)
    want = jax.jit(lambda v: jh.apply(v, jnp.asarray(x), True))(var)
    with torch.no_grad():
        got = th(_t(x), train=True)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def test_roi_rescale_past_the_map_matches_jax():
    rs = np.random.RandomState(11)
    feat = rs.randn(6, 8, 5).astype(np.float32)
    rois = np.array([[0.0, 0.0, 60.0, 40.0], [70.0, 50.0, 128.0, 96.0],
                     [20.0, 30.0, 50.0, 60.0]], np.float32)
    want_r = JRH.roi_rescale(jnp.asarray(rois), 1.3)
    got_r = TRH.roi_rescale(_t(rois), 1.3)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=1e-5)
    assert (got_r[:2, :2] < 0).any() and (got_r[1, 2:] > 96).all()
    want = JRA.roi_align(jnp.asarray(feat), want_r, 1 / 16.0,
                         out_size=7, sampling_ratio=2)
    got = roi_align(_t(feat), got_r, 1 / 16.0, out_size=7, sampling_ratio=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_dynamic_schedule_over_250_records_matches_jax():
    rs = np.random.RandomState(12)
    ious = rs.uniform(0.3, 0.9, 250)
    betas = rs.uniform(0.0, 1.5, 250)
    betas[100:200] = 0.0  # a ~0 median keeps beta
    js, ts = JRH.DynamicSchedule(), TRH.DynamicSchedule()
    seen = set()
    for i, b in zip(ious, betas):
        want, got = js.record(i, b), ts.record(i, b)
        assert got == want
        seen.add(got)
    assert len(seen) == 3 and ts.iou_history == js.iou_history


def test_dynamic_rcnn_trains_at_the_initial_schedule_in_jax():
    """F31: the JAX loss defaults are the schedule's initial values, which
    the family table uses; neither JAX CLI records into a schedule."""
    sig = inspect.signature(JRH.dynamic_rcnn_loss)
    assert sig.parameters["iou_thr"].default == JRH.DYN_INITIAL_IOU == 0.4
    assert sig.parameters["beta"].default == JRH.DYN_INITIAL_BETA == 1.0
    sig = inspect.signature(TRH.dynamic_rcnn_loss)
    assert sig.parameters["iou_thr"].default == 0.4
    assert sig.parameters["beta"].default == 1.0
    for cli in ("tools/train.py", "tools/test.py"):
        with open(os.path.join(ROOT, cli)) as f:
            src = f.read()
        assert "DynamicSchedule" not in src and ".record(" not in src
    assert TL.smooth_l1_loss(torch.tensor([2.0]), torch.tensor([0.0]),
                             beta=1.0) == 1.5
