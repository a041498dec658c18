"""FPN Faster R-CNN in the port against the JAX package on the CPU, f32:

- the FPN neck (max-pool and on-input extra levels) at an even size and at
  one with an odd level, where JAX's half-pixel nearest resize is torch's
  ``nearest-exact`` and not mmdet's ``nearest`` (ROADMAP fault F20), to
  1e-4;
- ``map_roi_levels`` at the level boundaries (sides 112, 224, 448 px and
  1 px either side): the same levels;
- ``multilevel_roi_align`` (each roi on its own level, one call a
  non-empty level) against JAX's pool-on-every-level-and-select, forward
  and the maps' gradients, with an empty level;
- the multi-level proposals: the port's equal JAX's, one NMS across the
  levels (ROADMAP fault F19: a box of one level is suppressed by a
  higher-scoring box of another, which mmdet's per-level NMS keeps);
- ``FPNFasterRCNN`` (R50, 128 x 128, 4 classes, the JAX tiny sizes) with
  bridged variables: the loss terms to 1e-5 relative and every gradient
  to 1e-4 of its leaf's largest value (against the JAX loss composed with
  ``stop_gradient`` on the proposals, ROADMAP fault F6), and the
  detections as sets;
- F18: the JAX model builds its anchors for its own bucket and fails at
  another (``DetectorModel`` at 768 x 1280 for an 800 x 1344 model; the
  same mismatch at a 96 x 160 bucket of a 128 x 128 model), while the
  port takes its anchors from the maps' sizes: it detects at both
  buckets, and its anchors for 800 x 1344 are the JAX model's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_port_dark_backbones import draw
from test_torch_port_selsa import _same_dets
from test_torch_port_train import jax_uniforms
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.apis import (
    families as TF,
)
from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (
    rpn_head as trpn,
)
from lowlightenvironmentvideoobjectdetection_torch.models.detectors import (
    fpn_faster_rcnn as TFF,
)
from lowlightenvironmentvideoobjectdetection_torch.models.detectors.faster_rcnn import (  # noqa: E501
    DetTrainBatch,
)
from lowlightenvironmentvideoobjectdetection_torch.models.necks import (
    fpn as TN,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
    grads_from_jax,
)
from lowlightenvironmentvideoobjectdetection_tpu.apis import (
    inference as JI,
)
from lowlightenvironmentvideoobjectdetection_tpu.core import (
    assigners as jassign,
    boxes as jbox,
    losses as jlosses,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.dense_heads import (
    rpn_head as jrpn,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.detectors import (
    fpn_faster_rcnn as JFF,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.necks import (
    fpn as JN,
)

FEAT_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
SMALL = dict(num_classes=4, pad_h=128, pad_w=128, train_nms_post=32,
             test_nms_post=16, num_roi_samples=16)


_pinned_threads = thread_count(1)


def _nhwc(rs, c, h, w):
    return rs.randn(1, h, w, c).astype(np.float32)


@pytest.mark.parametrize("mode", ["maxpool", "on_input"])
@pytest.mark.parametrize("hw", [(16, 16), (15, 20)], ids=["even", "odd"])
def test_fpn_neck_matches_jax(mode, hw):
    torch.set_num_threads(1)
    rs = np.random.RandomState(0)
    chans = (8, 16, 32, 64)
    h, w = hw
    sizes = [(h, w), ((h + 1) // 2, (w + 1) // 2)]
    for _ in range(2):
        sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
    xs = [_nhwc(rs, c, *s) for c, s in zip(chans, sizes)]
    jm = JN.FPN(out_channels=16, num_outs=5, add_extra_convs=mode,
                dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            [jnp.asarray(x) for x in xs])
    var = jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(1)))
    want = jm.apply(var, [jnp.asarray(x) for x in xs])
    tm = TN.FPN(chans, 16, 5, mode)
    tm.load_state_dict(from_jax_variables(var), strict=True)
    with torch.no_grad():
        got = tm([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs])
    assert len(got) == len(want) == 5
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt)
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == wnt.shape
        np.testing.assert_allclose(g, wnt, rtol=FEAT_TOL,
                                   atol=FEAT_TOL * np.abs(wnt).max())
    # F20: JAX's nearest is nearest-exact; mmdet's nearest differs at an
    # odd size and agrees at twice the next level
    x = torch.arange(3.0)[None, None, None]
    exact = F.interpolate(x, size=(1, 5), mode="nearest-exact")
    plain = F.interpolate(x, size=(1, 5), mode="nearest")
    jres = jax.image.resize(jnp.arange(3.0), (5,), "nearest")
    np.testing.assert_array_equal(exact[0, 0, 0].numpy(), np.asarray(jres))
    assert not torch.equal(exact, plain)


BOUNDARY_SIDES = [s + d for s in (56.0, 112.0, 224.0, 448.0, 896.0)
                  for d in (-1.0, 0.0, 1.0)]


@pytest.mark.parametrize("origin,sides", [
    ((10.0, 20.0), BOUNDARY_SIDES),
    ((0.0, 0.0), [30.0, 120.0, 250.0, 500.0])], ids=["boundaries", "corner"])
def test_map_roi_levels_at_the_boundaries(origin, sides):
    x, y = origin
    rois = np.array([[x, y, x + s, y + s] for s in sides], np.float32)
    want = np.asarray(JFF.map_roi_levels(jnp.asarray(rois), 4))
    got = TFF.map_roi_levels(torch.from_numpy(rois)).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(got.tolist()) == {0, 1, 2, 3}


def _rois(rs, n, span):
    xy = rs.uniform(0, span * 0.6, (n, 2))
    wh = np.exp(rs.uniform(np.log(4), np.log(span), (n, 2)))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("empty_level", [None, 2])
def test_multilevel_roi_align_matches_the_jax_select(empty_level):
    torch.set_num_threads(1)
    rs = np.random.RandomState(3)
    feats = [rs.randn(256 // s, 256 // s, 8).astype(np.float32)
             for s in TFF.FPN_STRIDES[:4]]
    rois = _rois(rs, 80, 600.0)
    lv = np.asarray(JFF.map_roi_levels(jnp.asarray(rois), 4))
    if empty_level is not None:
        rois = rois[lv != empty_level]
    wgt = rs.randn(rois.shape[0], 7, 7, 8).astype(np.float32)

    def jfn(fs):
        return JFF.multilevel_roi_align(list(fs), jnp.asarray(rois))

    want = np.asarray(jfn([jnp.asarray(f) for f in feats]))
    jgrads = jax.grad(lambda fs: jnp.sum(jfn(fs) * wgt))(
        [jnp.asarray(f) for f in feats])
    tf = [torch.from_numpy(f)[None].requires_grad_() for f in feats]
    counts = []
    got = TFF.multilevel_roi_align(tf, torch.from_numpy(rois),
                                   level_counts=counts)
    (got * torch.from_numpy(wgt)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=FEAT_TOL,
                               atol=FEAT_TOL * np.abs(want).max())
    assert sum(counts[0]) == rois.shape[0]
    assert (0 in counts[0]) == (empty_level is not None)
    assert sum(1 for c in counts[0] if c) >= 3
    for t, j in zip(tf, jgrads):
        j = np.asarray(j)
        g = np.zeros_like(j) if t.grad is None else t.grad[0].numpy()
        np.testing.assert_allclose(g, j, rtol=0,
                                   atol=FEAT_TOL * max(np.abs(j).max(), 1))


def _level_outs(rs, sizes):
    return [(rs.randn(h, w, 3).astype(np.float32),
             (0.3 * rs.randn(h, w, 12)).astype(np.float32))
            for h, w in sizes]


def test_multilevel_proposals_cross_levels():
    """F19: one NMS over the top nms_pre of every level, as JAX."""
    rs = np.random.RandomState(4)
    sizes = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    outs = _level_outs(rs, sizes)
    gen = TFF.fpn_anchor_gen()
    anchors = gen.grid_anchors(sizes)
    shape = (64.0, 64.0)
    want = jrpn.rpn_proposals(
        [(jnp.asarray(c), jnp.asarray(r)) for c, r in outs],
        [jnp.asarray(a) for a in anchors], jnp.asarray(shape), nms_pre=200,
        nms_post=40, iou_threshold=0.7)
    got = trpn.rpn_proposals(
        [torch.from_numpy(c) for c, _ in outs],
        [torch.from_numpy(r) for _, r in outs],
        [torch.from_numpy(a) for a in anchors], torch.tensor(shape),
        nms_pre=200, nms_post=40, iou_threshold=0.7)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-6)
    # a level-1 box that overlaps a better level-0 box goes; per-level NMS
    # (mmdet) keeps it
    c0 = torch.full((1, 1, 3), -9.0)
    c0[0, 0, 1] = 5.0
    c1 = torch.full((1, 1, 3), -9.0)
    c1[0, 0, 1] = 4.0
    a0 = torch.tensor([[0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 30.0, 30.0],
                       [0.0, 0.0, 0.0, 0.0]])
    a1 = torch.tensor([[0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 31.0, 31.0],
                       [0.0, 0.0, 0.0, 0.0]])
    z = torch.zeros((1, 1, 12))
    cross = trpn.rpn_proposals([c0, c1], [z, z], [a0, a1],
                               torch.tensor(shape), 6, 4, 0.7)
    alone = [trpn.rpn_proposals(c, z, a, torch.tensor(shape), 3, 4, 0.7)
             for c, a in ((c0, a0), (c1, a1))]
    kept = (cross.valid & (cross.scores > 0.5)).sum()
    per_level = sum(int((p.valid & (p.scores > 0.5)).sum()) for p in alone)
    assert int(kept) == 1 and per_level == 2


@pytest.fixture(scope="module")
def fpn():
    torch.set_num_threads(1)
    jm = JFF.FPNFasterRCNN(dtype=jnp.float32, **SMALL)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3)))
    var = jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(5)))
    tm = TFF.FPNFasterRCNN(dtype=torch.float32, **SMALL)
    tm.load_state_dict(from_jax_variables(var), strict=True)
    rs = np.random.RandomState(6)
    img = rs.randn(128, 128, 3).astype(np.float32)
    gts = np.array([[10.0, 12.0, 90.0, 100.0], [40.0, 30.0, 70.0, 60.0],
                    [5.0, 60.0, 50.0, 120.0], [0.0, 0.0, 0.0, 0.0]],
                   np.float32)
    batch = JFF.FPNDetBatch(jnp.asarray(img), jnp.asarray([120.0, 124.0]),
                            jnp.asarray(gts), jnp.asarray([1, 3, 0, 0]),
                            jnp.asarray([True, True, True, False]))
    return dict(jm=jm, var=var, tm=tm, batch=batch,
                anchors=JFF.make_fpn_anchors(128, 128))


def _jax_fpn_loss_stopped(model, params, batch, rng, anchors):
    """JAX ``fpn_faster_rcnn_loss`` (rpn, single, random, smooth_l1) with
    ``stop_gradient`` on the proposal boxes."""
    rng_rpn, rng_roi = jax.random.split(rng)
    feats = model.apply(params, batch.img[None],
                        method=JFF.FPNFasterRCNN.extract_feat)
    outs = model.apply(params, feats, method=JFF.FPNFasterRCNN.rpn_forward)
    lv = [(c[0], r[0]) for c, r in outs]
    ls = jrpn.rpn_loss(lv, anchors, batch.gt_boxes, batch.gt_valid, rng_rpn,
                       batch.img_shape)
    props = jrpn.rpn_proposals(lv, anchors, batch.img_shape, nms_pre=2000,
                               nms_post=model.train_nms_post,
                               iou_threshold=0.7)
    cand = jnp.concatenate([batch.gt_boxes,
                            jax.lax.stop_gradient(props.boxes)])
    cand_valid = jnp.concatenate([batch.gt_valid, props.valid])
    assign = jassign.max_iou_assign(cand, batch.gt_boxes, batch.gt_labels,
                                    batch.gt_valid, 0.5, 0.5, 0.5,
                                    box_valid=cand_valid)
    sample = jassign.random_sample_gather(assign, rng_roi,
                                          model.num_roi_samples, 0.25)
    rois = cand[sample.inds]
    matched = jnp.clip(assign.assigned_gt_inds[sample.inds] - 1, 0,
                       batch.gt_boxes.shape[0] - 1)
    pos = sample.is_pos
    labels = jnp.where(pos, batch.gt_labels[matched], model.num_classes)
    tgt = jbox.bbox2delta(rois, batch.gt_boxes[matched],
                          stds=(0.1, 0.1, 0.2, 0.2))
    tgt = jnp.where(pos[:, None], tgt, 0.0)
    rf = model.apply(params, [f[0] for f in feats], rois,
                     method=JFF.FPNFasterRCNN.roi_feats)
    cs, bp = model.apply(params, rf, method=JFF.FPNFasterRCNN.bbox_forward)
    avg = jnp.maximum(jnp.sum(sample.is_valid), 1.0)
    loss_cls = jlosses.softmax_cross_entropy(
        cs, labels, weight=sample.is_valid.astype(jnp.float32),
        avg_factor=avg)
    pred = bp.reshape(-1, model.num_classes, 4)
    pred_c = jnp.take_along_axis(
        pred, jnp.clip(labels, 0, model.num_classes - 1)[:, None, None],
        axis=1)[:, 0]
    loss_bbox = jlosses.smooth_l1_loss(
        pred_c, tgt, beta=1.0, weight=pos[:, None].astype(jnp.float32),
        avg_factor=avg)
    total = ls.loss_cls + ls.loss_bbox + loss_cls + loss_bbox
    return total, {"loss": total, "loss_cls": loss_cls,
                   "loss_bbox": loss_bbox, "loss_rpn_cls": ls.loss_cls,
                   "loss_rpn_bbox": ls.loss_bbox}


def _port_batch(b):
    return DetTrainBatch(*(torch.from_numpy(np.array(f)) for f in b[:3]),
                         torch.from_numpy(np.array(b.gt_labels)).long(),
                         torch.from_numpy(np.array(b.gt_valid)))


def test_fpn_faster_rcnn_loss_and_gradients_match_jax(fpn):
    jm, var, batch = fpn["jm"], fpn["var"], fpn["batch"]
    key = jax.random.PRNGKey(9)
    (_, jmet), jg = jax.jit(jax.value_and_grad(functools.partial(
        _jax_fpn_loss_stopped, jm, batch=batch, rng=key,
        anchors=fpn["anchors"]), has_aux=True))(var)
    # the stopped composition is the package's loss in value
    _, full = jax.jit(functools.partial(
        JFF.fpn_faster_rcnn_loss, jm, batch=batch, rng=key,
        anchors=fpn["anchors"]))(var)
    n_anchors = sum(a.shape[0] for a in fpn["anchors"])
    u = jax_uniforms(key, n_anchors, 4 + SMALL["train_nms_post"])
    tm = fpn["tm"]
    tm.zero_grad()
    total, met = TFF.fpn_faster_rcnn_loss(
        tm, _port_batch(batch), uniforms=u)
    total.backward()
    for k in ("loss", "loss_cls", "loss_bbox", "loss_rpn_cls",
              "loss_rpn_bbox"):
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(float(jmet[k]), float(full[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert float(met["loss_bbox"].detach()) > 0
    assert float(met["loss_rpn_bbox"].detach()) > 0
    want = grads_from_jax(jg["params"])
    params = dict(tm.named_parameters())
    top = max(float(np.abs(g.numpy()).max()) for g in want.values())
    for name, w in want.items():
        g = params[name].grad
        scale = float(np.abs(w.numpy()).max())
        if g is None:
            assert scale == 0.0, name
            continue
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=0,
            atol=max(GRAD_REL * scale, 1e-6 * top), err_msg=name)


def test_fpn_faster_rcnn_detect_matches_jax(fpn, monkeypatch):
    jm, var, batch = fpn["jm"], fpn["var"], fpn["batch"]
    sf = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
    want = JFF.fpn_faster_rcnn_detect(jm, var, batch.img, batch.img_shape,
                                      fpn["anchors"], scale_factor=sf)
    counts, real = [], TFF.multilevel_roi_align
    monkeypatch.setattr(TFF, "multilevel_roi_align", lambda *a, **kw: real(
        *a, level_counts=counts, **kw))
    got = TFF.fpn_faster_rcnn_detect(
        fpn["tm"], torch.from_numpy(np.array(batch.img)),
        torch.tensor([120.0, 124.0]), scale_factor=torch.from_numpy(sf))
    _same_dets(got, want)
    assert sum(counts[0]) == SMALL["test_nms_post"]


def test_f18_anchors_follow_the_maps(fpn):
    """The JAX FPN model fails off its own bucket; the port does not."""
    jm, var = fpn["jm"], fpn["var"]
    img = jnp.asarray(np.random.RandomState(7).randn(96, 160, 3)
                      .astype(np.float32))
    with pytest.raises(TypeError, match="incompatible shapes"):
        JFF.fpn_faster_rcnn_detect(jm, var, img, jnp.asarray([96.0, 160.0]),
                                   fpn["anchors"])
    tm = fpn["tm"]
    for hw in ((96, 160), (128, 128)):
        x = torch.from_numpy(np.random.RandomState(7).randn(*hw, 3)
                             .astype(np.float32))
        dets = TFF.fpn_faster_rcnn_detect(tm, x, torch.tensor(
            [float(hw[0]), float(hw[1])]))
        assert dets.boxes.shape == (100, 4)
        assert torch.isfinite(dets.boxes).all()
    # at full size: the port's anchors from the maps equal the JAX model's
    # for its own bucket, and the port pads to that bucket
    full = TFF.FPNFasterRCNN(num_classes=80)
    assert TF.pad_hw(full, TF.FAMILIES["FasterRCNNFPN"], False) == (800,
                                                                    1344)
    sizes = [(-(-800 // s), -(-1344 // s)) for s in TFF.FPN_STRIDES]
    maps = [torch.empty((1, h, w, 0)) for h, w in sizes]
    got = full.anchors(maps)
    want = JFF.make_fpn_anchors(800, 1344)
    assert [a.shape[0] for a in got] == [201600, 50400, 12600, 3150, 819]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_f18_the_jax_detector_model_raises_off_its_bucket():
    """The JAX ``DetectorModel`` pads an FPN model to 768 x 1280 and fails
    against its 800 x 1344 anchors (traced only: the error comes before
    any compile)."""
    jm = JFF.FPNFasterRCNN(num_classes=4, dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3)))
    det = JI.DetectorModel(model_type="FasterRCNNFPN", num_classes=4,
                           dtype=jnp.float32, params=shapes)
    assert (det.pad_h, det.pad_w) == (768, 1280)
    with pytest.raises(TypeError, match="incompatible shapes"):
        det.inference_detector(np.zeros((480, 640, 3), np.float32))
