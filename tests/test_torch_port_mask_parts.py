"""The parts of the mask families in the port against the JAX package on
the CPU, exactly where they select and to float rounding where they
compute:

- ``FCNMaskHead`` (its 2x2 transposed conv flipped by the bridge),
  ``mask_targets`` on box-filled and random masks (the port's RoIAlign of
  the [G, H, W, 1] masks by matched index against JAX's of a gathered
  [N, H, W] copy: a pixel may differ only where JAX's value is within
  1e-5 of the 0.5 threshold, the two RoIAligns' float rounding),
  ``mask_iou_targets`` (summed-area tables against JAX's [N, H, W]
  indicator: equal), ``mask_loss``, ``paste_masks`` (equal pixel sets);
- ``point_sample``, ``uncertain_point_indices`` with tied logits (the
  lower index first, as ``lax.top_k``), ``PointHead``, ``MaskIoUHead``;
- HTC's ``SemanticHead`` and semantic target, JAX's nearest resize;
- YOLACT's anchors, ``_crop_mask``, ``Protonet`` (its 2x bilinear
  upsample);
- ``core/eval/instseg.py``'s polygon and RLE decoding, mask IoU and AP
  against the JAX module's;
- kernel B's mask-target body in the wrapper (``gather28x2``: no D body,
  float32 only);
- ROADMAP F33-F37 on the JAX side, each with the port's behaviour.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_dark_backbones import draw
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.core.eval import (
    instseg as TI,
)
from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (
    yolact_head as TY,
)
from lowlightenvironmentvideoobjectdetection_torch.models.detectors import (
    htc as TH,
    more_rcnn as TMR,
)
from lowlightenvironmentvideoobjectdetection_torch.models.roi_heads import (
    mask_head as TMH,
)
from lowlightenvironmentvideoobjectdetection_torch.ops import (
    roi_align as TRA,
)
from lowlightenvironmentvideoobjectdetection_torch.ops.point_sample import (
    point_sample,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)
from lowlightenvironmentvideoobjectdetection_tpu.core.eval import (
    instseg as JI,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.dense_heads import (
    yolact_head as JY,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.detectors import (
    htc as JH,
    more_rcnn as JMR,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.roi_heads import (
    mask_head as JMH,
)
from lowlightenvironmentvideoobjectdetection_tpu.ops.point_sample import (
    point_sample as jax_point_sample,
)
from lowlightenvironmentvideoobjectdetection_tpu.ops.roi_align import (
    roi_align as jax_roi_align,
)

FEAT_TOL = 1e-5
THR_TOL = 1e-5  # a target may flip only this close to the 0.5 threshold
H, W, G, N, C = 64, 80, 4, 40, 5
GTS = np.array([[2.0, 1.0, 62.0, 63.0], [10.0, 20.0, 40.0, 50.0],
                [30.0, 5.0, 75.0, 30.0], [0.0, 0.0, 0.0, 0.0]], np.float32)

_pinned_threads = thread_count(1)


def close(got, want, tol=FEAT_TOL, what=""):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


def bridge(jmodule, tmodule, *xs, seed=0):
    """Draw the JAX module's variables for inputs ``xs`` and load them into
    the port module (transposed convs flipped); returns the variables."""
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0),
                            *(jnp.asarray(x) for x in xs))
    var = jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(seed)))
    tmodule.load_state_dict(from_jax_variables(var, tmodule), strict=True)
    return var


def box_masks(gts=GTS, hw=(H, W)):
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    return ((yy >= gts[:, 1, None, None]) & (yy < gts[:, 3, None, None])
            & (xx >= gts[:, 0, None, None])
            & (xx < gts[:, 2, None, None])).astype(np.float32)


def rois_about_gts(rng, n=N, gts=GTS):
    """``n`` rois about the gts (corners moved by N(0, 0.1) of the side;
    some past the map), the first three the gts themselves; and their
    matched gt."""
    matched = rng.randint(0, len(gts), n)
    c = gts[matched]
    side = np.concatenate([c[:, 2:] - c[:, :2]] * 2, 1)
    rois = (c + rng.randn(n, 4) * side * 0.1).astype(np.float32)
    rois[:3] = gts[matched[:3]]
    return rois, matched


def test_mask_head_matches_jax():
    x = np.random.RandomState(0).randn(6, 14, 14, 32).astype(np.float32)
    tm = TMH.FCNMaskHead(32, C)
    var = bridge(JMH.FCNMaskHead(num_classes=C), tm, x)
    want = JMH.FCNMaskHead(num_classes=C).apply(var, jnp.asarray(x))
    with torch.no_grad():
        close(tm(torch.from_numpy(x)), want)


@pytest.mark.parametrize("kind", ["box", "random"])
def test_mask_targets_match_jax(kind):
    rng = np.random.RandomState(1 if kind == "box" else 2)
    masks = (box_masks() if kind == "box"
             else (rng.rand(G, H, W) > 0.5).astype(np.float32))
    rois, matched = rois_about_gts(rng)
    want = np.asarray(JMH.mask_targets(jnp.asarray(masks),
                                       jnp.asarray(matched),
                                       jnp.asarray(rois)))
    got = TMH.mask_targets(torch.from_numpy(masks),
                           torch.from_numpy(matched),
                           torch.from_numpy(rois)).numpy()
    assert got.shape == want.shape == (N, 28, 28)
    assert 0 < want.sum() < want.size
    # JAX's values before the threshold, as its mask_targets computes them
    jv = np.asarray(jax_roi_align(
        jnp.asarray(masks)[jnp.asarray(matched)][..., None],
        jnp.asarray(rois), spatial_scale=1.0,
        batch_inds=jnp.arange(N, dtype=jnp.int32), out_size=28,
        sampling_ratio=2))[..., 0]
    flips = got != want
    assert flips.sum() <= 4
    assert np.all(np.abs(jv[flips] - 0.5) < THR_TOL)


def test_mask_iou_targets_match_jax():
    rng = np.random.RandomState(3)
    masks = (rng.rand(G, H, W) > 0.3).astype(np.float32)
    rois, matched = rois_about_gts(rng)
    rois[3] = [-5.0, -7.0, 0.5, 0.2]  # clipped to a 1 px corner
    rois[4] = [70.0, 60.0, 200.0, 90.0]  # past the map
    pred = (rng.rand(N, 28, 28) > 0.5).astype(np.float32)
    tgt = (rng.rand(N, 28, 28) > 0.4).astype(np.float32)
    want = JMH.mask_iou_targets(*(jnp.asarray(a) for a in (
        pred, tgt, masks, matched, rois)))
    got = TMH.mask_iou_targets(*(torch.from_numpy(a) for a in (
        pred, tgt, masks, matched, rois)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mask_loss_matches_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(N, 28, 28, C).astype(np.float32) * 3
    tgt = (rng.rand(N, 28, 28) > 0.5).astype(np.float32)
    labels = rng.randint(0, C + 1, N)  # C: background, clipped
    pos = rng.rand(N) > 0.5
    args = (logits, tgt, labels, pos)
    want = JMH.mask_loss(*(jnp.asarray(a) for a in args))
    got = TMH.mask_loss(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_paste_masks_matches_jax():
    rng = np.random.RandomState(5)
    probs = rng.rand(N, 28, 28).astype(np.float32)
    rois, _ = rois_about_gts(rng)
    rois[5] = [20.0, 20.0, 20.0, 20.0]  # zero area
    want = np.asarray(JMH.paste_masks(jnp.asarray(probs), jnp.asarray(rois),
                                      H, W))
    got = TMH.paste_masks(torch.from_numpy(probs), torch.from_numpy(rois),
                          H, W).numpy()
    assert got.dtype == want.dtype == bool and want.any()
    np.testing.assert_array_equal(got, want)


def test_point_sample_matches_jax():
    rng = np.random.RandomState(6)
    feat = rng.randn(9, 13, 7).astype(np.float32)
    pts = rng.uniform(-0.1, 1.1, (4, 11, 2)).astype(np.float32)
    want = jax.vmap(lambda p: jax_point_sample(jnp.asarray(feat), p))(
        jnp.asarray(pts))
    close(point_sample(torch.from_numpy(feat), torch.from_numpy(pts)), want)


@pytest.mark.parametrize("with_labels", [False, True])
def test_uncertain_points_pin_ties(with_labels):
    """Integer logits: many equal uncertainties, taken in index order."""
    rng = np.random.RandomState(7)
    pred = rng.randint(-3, 4, (6, 28, 28, C)).astype(np.float32)
    labels = rng.randint(0, C + 1, 6) if with_labels else None
    want_idx, want_unc = JMR.uncertain_point_indices(
        jnp.asarray(pred), None if labels is None else jnp.asarray(labels),
        49)
    idx, unc = TMR.uncertain_point_indices(
        torch.from_numpy(pred),
        None if labels is None else torch.from_numpy(labels), 49)
    np.testing.assert_array_equal(unc.numpy(), np.asarray(want_unc))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def test_point_head_and_mask_iou_head_match_jax():
    rng = np.random.RandomState(8)
    fine = rng.randn(5, 49, 32).astype(np.float32)
    coarse = rng.randn(5, 49, C).astype(np.float32)
    tp = TMR.PointHead(32, C)
    var = bridge(JMR.PointHead(num_classes=C), tp, fine, coarse)
    want = JMR.PointHead(num_classes=C).apply(var, jnp.asarray(fine),
                                              jnp.asarray(coarse))
    with torch.no_grad():
        close(tp(torch.from_numpy(fine), torch.from_numpy(coarse)), want)
    feats = rng.randn(5, 14, 14, 32).astype(np.float32)
    pred = rng.randn(5, 28, 28, C).astype(np.float32) * 2
    ti = TMR.MaskIoUHead(32, C)
    var = bridge(JMR.MaskIoUHead(num_classes=C), ti, feats, pred, seed=1)
    want = JMR.MaskIoUHead(num_classes=C).apply(var, jnp.asarray(feats),
                                                jnp.asarray(pred))
    with torch.no_grad():
        close(ti(torch.from_numpy(feats), torch.from_numpy(pred)), want)


def test_semantic_head_and_target_match_jax():
    rng = np.random.RandomState(9)
    feat = rng.randn(1, 8, 10, 32).astype(np.float32)
    th = TH.SemanticHead(32, C)
    var = bridge(JH.SemanticHead(num_classes=C), th, feat[0])
    want = JH.SemanticHead(num_classes=C).apply(var, jnp.asarray(feat[0]))
    with torch.no_grad():
        got = th(torch.from_numpy(feat))
    for g, w, what in zip(got, want, ("logits", "features")):
        close(g, w, what=what)
    masks = box_masks()
    labels = np.array([1, 3, 2, 0])
    valid = np.array([True, True, True, False])
    for hw in ((4, 5), (8, 10), (21, 27)):  # 16x, 8x, an odd ratio
        want = JH._semantic_target(jnp.asarray(masks), jnp.asarray(labels),
                                   jnp.asarray(valid), hw)
        got = TH.semantic_target(torch.from_numpy(masks),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(valid), hw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_yolact_anchors_crop_and_protonet_match_jax():
    shapes = [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)]
    for t, j in zip(TY.yolact_anchors(shapes), JY.yolact_anchors(shapes)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    rng = np.random.RandomState(10)
    masks = rng.rand(6, 12, 17).astype(np.float32)
    boxes = rng.uniform(-2, 18, (6, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(0, 9, (6, 2))
    boxes[0] = [3.0, 4.0, 7.0, 4.0]  # borders included
    want = jax.vmap(JY._crop_mask)(jnp.asarray(masks), jnp.asarray(boxes))
    np.testing.assert_array_equal(
        TY._crop_mask(torch.from_numpy(masks), torch.from_numpy(boxes))
        .numpy(), np.asarray(want))
    p3 = rng.randn(1, 6, 9, 16).astype(np.float32)
    tp = TY.Protonet(16, dtype=torch.float32)
    var = bridge(JY.Protonet(dtype=jnp.float32), tp, p3)
    want = JY.Protonet(dtype=jnp.float32).apply(var, jnp.asarray(p3))
    with torch.no_grad():
        close(tp(torch.from_numpy(p3).permute(0, 3, 1, 2)), want)


def test_instseg_matches_jax():
    h, w = 23, 31
    polys = [[2.0, 3.0, 20.5, 4.0, 15.0, 18.0, 3.5, 14.0],
             [10.0, 10.0, 28.0, 10.0, 28.0, 21.0]]
    np.testing.assert_array_equal(TI.polygon_to_mask(polys, h, w),
                                  JI.polygon_to_mask(polys, h, w))
    rle = {"counts": [5, 40, 3, 100, 0, 7, 200], "size": [h, w]}
    np.testing.assert_array_equal(TI.ann_to_mask(rle, h, w),
                                  JI.ann_to_mask(rle, h, w))
    with pytest.raises(NotImplementedError):
        TI.rle_to_mask({"counts": "abc", "size": [h, w]}, h, w)
    rng = np.random.RandomState(11)
    gts = rng.rand(5, h, w) > 0.6
    dets = rng.rand(9, h, w) > 0.5
    dets[:3] = gts[:3]
    np.testing.assert_array_equal(TI.mask_iou_matrix(dets, gts),
                                  JI.mask_iou_matrix(dets, gts))
    labels = np.array([0, 1, 1, 2, 0])
    segs, anns = [], []
    for i in range(3):
        keep = rng.rand(9) > 0.2
        segs.append([{"scores": rng.rand(int((keep & (lab == c)).sum())),
                      "masks": dets[keep & (lab == c)]}
                     for c, lab in ((c, rng.randint(0, 3, 9))
                                    for c in range(3))])
        anns.append({"masks": gts, "labels": labels})
    got, want = TI.eval_mask_ap(segs, anns, 3), JI.eval_mask_ap(segs, anns, 3)
    assert got == want and 0.0 < want["AP@50"] <= 1.0


def test_mask_target_body_in_the_wrapper():
    assert TRA._roi_align_body(28, 2) == "gather28x2"
    with pytest.raises(ValueError):
        TRA._roi_align_body(28, 2, "scatter")
    assert "gather28x2" in TRA.roi_align.body_launches
    assert "scatter28x2" not in TRA.roi_align_backward.body_launches
    masks = torch.zeros(2, 8, 8, 1, device="meta")
    rois = torch.zeros(3, 4, device="meta")
    binds = torch.zeros(3, dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError):  # the kernel path: no device here
        TRA.roi_align(masks, rois, 1.0, batch_inds=binds, out_size=28)
    with pytest.raises(ValueError):  # no D body for the targets
        TRA.roi_align(masks.requires_grad_(), rois, 1.0, batch_inds=binds,
                      out_size=28)


def test_f33_htc_mask_flow_passes_the_stage_input():
    """ROADMAP F33: JAX's ``HTC.mask_forward`` returns its input (the roi
    features plus the information of the stage before), not the head's
    last conv features as mmdet's ``HTCMaskHead`` does; the port the
    same."""
    c = JH.SelsaConfig(num_classes=C, neck_channels=32, pad_h=64, pad_w=64)
    jm = JH.HTC(cfg=c)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    var = jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(12)))
    rng = np.random.RandomState(13)
    mrf = rng.randn(3, 14, 14, 32).astype(np.float32)
    prev = rng.randn(3, 14, 14, 32).astype(np.float32)
    _, x0 = jm.apply(var, 0, jnp.asarray(mrf), None,
                     method=JH.HTC.mask_forward)
    np.testing.assert_array_equal(np.asarray(x0), mrf)
    jl, x1 = jm.apply(var, 1, jnp.asarray(mrf), jnp.asarray(prev),
                      method=JH.HTC.mask_forward)
    assert np.abs(np.asarray(x1) - mrf).max() > 0
    tm = TH.HTC(TH.SelsaConfig(num_classes=C, neck_channels=32, pad_h=64,
                               pad_w=64))
    tm.load_state_dict(from_jax_variables(var, tm), strict=True)
    with torch.no_grad():
        tl, tx = tm.mask_forward(1, torch.from_numpy(mrf),
                                 torch.from_numpy(prev))
    close(tx, x1, what="next stage's input")
    close(tl, jl, what="logits")


def test_f35_mask_iou_head_reads_an_antialiased_class_max():
    """ROADMAP F35: JAX's ``MaskIoUHead`` resizes the 28x28 prediction with
    ``jax.image.resize(..., "linear")``, whose 2x downscale averages 4
    pixels a side (weights 1, 3, 3, 1 / 8), and takes the max over every
    class (mmdet max-pools the roi's own class channel): the head's output
    does not change when the classes are permuted."""
    ramp = np.arange(28, dtype=np.float32)
    half = np.asarray(jax.image.resize(jnp.asarray(ramp), (14,), "linear"))
    np.testing.assert_allclose(half[1:-1], ramp[1:-3:2] * 0.125
                               + ramp[2:-2:2] * 0.375 + ramp[3:-1:2] * 0.375
                               + ramp[4::2] * 0.125, rtol=1e-6)
    rng = np.random.RandomState(14)
    feats = rng.randn(3, 14, 14, 16).astype(np.float32)
    pred = rng.randn(3, 28, 28, C).astype(np.float32)
    jm = JMR.MaskIoUHead(num_classes=C)
    ti = TMR.MaskIoUHead(16, C)
    var = bridge(jm, ti, feats, pred)
    a = np.asarray(jm.apply(var, jnp.asarray(feats), jnp.asarray(pred)))
    b = np.asarray(jm.apply(var, jnp.asarray(feats),
                            jnp.asarray(pred[..., ::-1])))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    with torch.no_grad():
        close(ti(torch.from_numpy(feats),
                 torch.from_numpy(pred[..., ::-1].copy())), a)


def test_f36_yolact_grid_strides_are_550_over_the_map():
    """ROADMAP F36: JAX's YOLACT anchors sit at (x + 0.5) x 550 / (69, 35,
    18, 9, 5) whatever the padded size: at the image route's 768 x 1280
    P3 has 96 x 160 cells of 8 px, but the anchors' centres step 7.97 px
    and stop short of the image; mmdet runs YOLACT at 550 x 550."""
    assert JY.YOLACT_STRIDES == TY.YOLACT_STRIDES == tuple(
        550.0 / x for x in (69, 35, 18, 9, 5))
    a = np.asarray(JY.yolact_anchors([(96, 160)])[0]).reshape(96, 160, 3, 4)
    cx = (a[..., 0] + a[..., 2]) / 2
    np.testing.assert_allclose(cx[0, :, 1],
                               (np.arange(160) + 0.5) * 550 / 69, rtol=1e-6)
    assert (160 - 0.5) * 8 - cx[0, -1, 1] > 4.0  # 8 px cells: 1276
    np.testing.assert_array_equal(
        TY.yolact_anchors([(96, 160)])[0].numpy(), a.reshape(-1, 4))


def test_f37_scnet_is_htc_with_a_global_context():
    """ROADMAP F37: JAX's SCNet is HTC with one more dense layer (the
    global context added to every roi feature), none of mmdet's SCNet heads
    (``SCNetBBoxHead``, the feature relay, the fused semantic head); the
    port's parameter names the same."""
    c = JH.SelsaConfig(num_classes=C, neck_channels=32, pad_h=64, pad_w=64)
    names = {}
    for cls in (JH.HTC, JH.SCNet):
        shapes = jax.eval_shape(cls(cfg=c).init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 3)))
        names[cls.__name__] = set(shapes["params"])
    assert names["SCNet"] - names["HTC"] == {"gc_fc"}
    tc = TH.SelsaConfig(num_classes=C, neck_channels=32, pad_h=64, pad_w=64)
    tnames = {cls.__name__: {n.split(".")[0] for n, _ in
                             cls(tc).named_parameters()}
              for cls in (TH.HTC, TH.SCNet)}
    assert tnames == names
