"""RetinaNet in the port against the JAX package on the CPU, f32:

- octave anchors (base scale 4, 3 scales an octave: 9 a position) and the
  FPN anchors, equal, with the same base-anchor order;
- ``sigmoid_focal_loss`` with weights and an average factor, and its
  gradient, to 1e-5 relative;
- ``retina_loss`` on random level outputs (every level, 4 gts of which 3
  valid): both terms to 1e-5 relative, the logits' and deltas' gradients
  to 1e-4;
- ``retina_decode``: the same detections as sets, on random logits and on
  logits with many equal scores (the top-k keeps the lower index first,
  as ``lax.top_k``), with a scale factor;
- ``RetinaNet`` (R50, 128 x 128, 4 classes) with bridged variables (the
  flax names ``bbox_head/{cls,reg}_conv{i}``, ``retina_cls``,
  ``retina_reg``, the neck's ``extra_conv{k}`` from C5): every level's
  outputs to 1e-4, the loss to 1e-5, the detections as sets; the seeded
  init gives the classifier the prior bias -4.595.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_dark_backbones import draw
from test_torch_port_selsa import _same_dets
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.core import (
    anchors as tanchors,
    losses as tlosses,
)
from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (
    retina_head as TR,
)
from lowlightenvironmentvideoobjectdetection_torch.models.detectors import (
    fpn_faster_rcnn as TFF,
)
from lowlightenvironmentvideoobjectdetection_torch.models.detectors.faster_rcnn import (  # noqa: E501
    DetTrainBatch,
)
from lowlightenvironmentvideoobjectdetection_torch.models.vid.selsa import (
    init_params,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)
from lowlightenvironmentvideoobjectdetection_tpu.core import (
    losses as jlosses,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.dense_heads import (
    retina_head as JR,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.detectors import (
    fpn_faster_rcnn as JFF,
)

FEAT_TOL = 1e-4
LOSS_RTOL = 1e-5
SIZES = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]


_pinned_threads = thread_count(1)


@pytest.mark.parametrize("which", ["retina", "fpn"])
def test_anchors_match_jax(which):
    if which == "retina":
        j, t = JR.retina_anchor_generator(), TR.retina_anchor_generator()
        assert t.num_base_anchors == j.num_base_anchors == 9
    else:
        j, t = JFF.fpn_anchor_gen(), TFF.fpn_anchor_gen()
        assert t.num_base_anchors == 3
    for lvl in range(5):
        np.testing.assert_array_equal(t.base_anchors(lvl),
                                      j.base_anchors(lvl))
    for a, b in zip(t.grid_anchors(SIZES), j.grid_anchors(SIZES)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tanchors.AnchorGenerator(strides=(8,), ratios=(1.0,), scales=(1.0,),
                                 octave_base_scale=4, scales_per_octave=3)


def test_focal_loss_and_gradient_match_jax():
    rs = np.random.RandomState(0)
    logits = (3 * rs.randn(50, 6)).astype(np.float32)
    labels = np.eye(6, dtype=np.float32)[rs.randint(0, 6, 50)] \
        * (rs.rand(50, 1) > 0.3)
    weight = (rs.rand(50, 1) > 0.2).astype(np.float32)

    def jf(x):
        return jlosses.sigmoid_focal_loss(x, jnp.asarray(labels),
                                          weight=jnp.asarray(weight),
                                          avg_factor=7.0)

    want, jg = jax.value_and_grad(jf)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = tlosses.sigmoid_focal_loss(x, torch.from_numpy(labels),
                                     weight=torch.from_numpy(weight),
                                     avg_factor=7.0)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jg)).max())


def _level_outs(rs, c=4, scale=1.0):
    return [((scale * rs.randn(h, w, 9 * c)).astype(np.float32),
             (0.2 * rs.randn(h, w, 36)).astype(np.float32))
            for h, w in SIZES]


GTS = np.array([[10.0, 12.0, 60.0, 50.0], [30.0, 5.0, 62.0, 40.0],
                [2.0, 30.0, 20.0, 60.0], [0.0, 0.0, 0.0, 0.0]], np.float32)
LABELS = np.array([0, 2, 3, 0])
VALID = np.array([True, True, True, False])


def test_retina_loss_matches_jax():
    rs = np.random.RandomState(1)
    outs = _level_outs(rs)
    anchors = JR.retina_anchor_generator().grid_anchors(SIZES)
    shape = (60.0, 64.0)

    def jf(lv):
        ls = JR.retina_loss(lv, [jnp.asarray(a) for a in anchors],
                            jnp.asarray(GTS), jnp.asarray(LABELS),
                            jnp.asarray(VALID), jnp.asarray(shape), 4)
        return ls.loss_cls + ls.loss_bbox, ls

    (_, want), jg = jax.value_and_grad(jf, has_aux=True)(
        [(jnp.asarray(c), jnp.asarray(r)) for c, r in outs])
    tl = [(torch.from_numpy(c).requires_grad_(),
           torch.from_numpy(r).requires_grad_()) for c, r in outs]
    got = TR.retina_loss(tl, [torch.from_numpy(a) for a in anchors],
                         torch.from_numpy(GTS), torch.from_numpy(LABELS),
                         torch.from_numpy(VALID), torch.tensor(shape), 4)
    (got.loss_cls + got.loss_bbox).backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL)
    assert float(got.loss_bbox) > 0
    for (tc, tr), (jc, jr) in zip(tl, jg):
        for t, j in ((tc, jc), (tr, jr)):
            j = np.asarray(j)
            np.testing.assert_allclose(t.grad.numpy(), j, rtol=0,
                                       atol=1e-4 * max(np.abs(j).max(),
                                                       1e-6))


@pytest.mark.parametrize("ties", [False, True])
def test_retina_decode_matches_jax(ties):
    rs = np.random.RandomState(2)
    outs = _level_outs(rs, scale=2.0)
    if ties:  # many equal scores inside every level's top 1000
        outs = [(np.round(c, 0), r) for c, r in outs]
    anchors = JR.retina_anchor_generator().grid_anchors(SIZES)
    shape = (60.0, 64.0)
    sf = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
    want = JR.retina_decode(
        [(jnp.asarray(c), jnp.asarray(r)) for c, r in outs],
        [jnp.asarray(a) for a in anchors], jnp.asarray(shape), 4,
        nms_pre=300, scale_factor=sf)
    got = TR.retina_decode(
        [(torch.from_numpy(c), torch.from_numpy(r)) for c, r in outs],
        [torch.from_numpy(a) for a in anchors], torch.tensor(shape), 4,
        nms_pre=300, scale_factor=torch.from_numpy(sf))
    _same_dets(got, want)
    # the top-k is lax.top_k's, ties to the lower index
    flat = np.round(rs.randn(500), 1).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(flat), 120)
    tv, ti = TR.top_k_stable(torch.from_numpy(flat), 120)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.fixture(scope="module")
def retina():
    torch.set_num_threads(1)
    jm = JR.RetinaNet(num_classes=4, dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3)))
    var = jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(3)))
    tm = TR.RetinaNet(num_classes=4, dtype=torch.float32)
    tm.load_state_dict(from_jax_variables(var), strict=True)
    img = np.random.RandomState(4).randn(1, 128, 128, 3).astype(np.float32)
    return dict(jm=jm, var=var, tm=tm, img=img,
                jouts=jax.jit(jm.apply)(var, jnp.asarray(img)))


def test_retinanet_outputs_loss_and_detections_match_jax(retina):
    tm, jouts = retina["tm"], retina["jouts"]
    with torch.no_grad():
        outs = tm(torch.from_numpy(retina["img"]))
    for (tc, tr), (jc, jr) in zip(outs, jouts):
        for t, j in ((tc, jc), (tr, jr)):
            j = np.asarray(j)
            np.testing.assert_allclose(t.numpy(), j, rtol=FEAT_TOL,
                                       atol=FEAT_TOL * np.abs(j).max())
    gen = JR.retina_anchor_generator()
    janc = [jnp.asarray(a) for a in gen.grid_anchors(
        [(c.shape[1], c.shape[2]) for c, _ in jouts])]
    flat = [(c[0], r[0]) for c, r in jouts]
    shape = jnp.asarray([120.0, 128.0])
    want = JR.retina_loss(flat, janc, jnp.asarray(GTS), jnp.asarray(LABELS),
                          jnp.asarray(VALID), shape, 4)
    batch = DetTrainBatch(torch.from_numpy(retina["img"][0]),
                          torch.tensor([120.0, 128.0]),
                          torch.from_numpy(GTS), torch.from_numpy(LABELS),
                          torch.from_numpy(VALID))
    with torch.no_grad():
        _, got = TR.retinanet_loss(tm, batch)
        dets = TR.retinanet_detect(tm, batch.img, batch.img_shape)
    np.testing.assert_allclose(float(got["loss_cls"]), float(want.loss_cls),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got["loss_bbox"]),
                               float(want.loss_bbox), rtol=LOSS_RTOL)
    jd = JR.retina_decode(flat, janc, shape, 4)
    _same_dets(dets, jd)


def test_seeded_init_has_the_prior_bias():
    m = TR.RetinaNet(num_classes=3, depth=50, dtype=torch.float32)
    init_params(m, torch.Generator().manual_seed(0))
    assert torch.all(m.bbox_head.retina_cls.bias == TR.PRIOR_BIAS)
    assert torch.all(m.bbox_head.retina_reg.bias == 0)
