"""The pieces of the FPN-trunk variants (GA-RPN, GRoIE, Libra R-CNN) and of
guided-anchoring RetinaNet in the port against the JAX package on the CPU,
f32, with variables drawn in ``jax.eval_shape(init)``'s shapes and bridged
by ``from_jax_variables``:

- ``bounded_iou_loss`` and ``balanced_l1_loss``: values to 1e-6 relative,
  the prediction's gradient to 1e-5 of its largest value;
- ``iou_balanced_sample_gather`` with the JAX draws replayed
  (``libra_uniforms``): the gather indices, positives and valid flags bit
  for bit, with few, many and most candidates positive;
- ``NonLocal2d`` and ``BFP`` (odd level sizes: every pool and resize
  branch) to FEAT_TOL of the largest value;
- ``GeneralizedAttention`` and ``GenericRoIExtractor``: outputs, and the
  maps' gradient through the extractor;
- ``AdaptiveDCN`` (the plain version here): output and the gradients of
  x, offsets, weight and bias;
- the guided-anchoring targets: ``ga_loc_targets`` (overlapping gts, an
  invalid one, gts on adjacent levels) exactly, the approximate overlaps,
  squares, shape assignment and both kinds of guided anchors;
- F22: the JAX ``shape_to_offsets`` stacks interleaved (dy, dx) pairs that
  the DCN reads as 9 dy and then 9 dx; the port keeps that order;
- F23: BFP's stride-ratio max pool and half-pixel nearest resize agree
  with mmdet's ``adaptive_max_pool2d`` and ``nearest`` at P2, P3 and P5 of
  the 800 x 1344 bucket and differ at P6 (13 x 21 against P4's 50 x 84).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_port_dark_backbones import draw
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.core import (
    assigners as tassign,
    losses as tlosses,
)
from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (
    guided_anchor_head as TGA,
)
from lowlightenvironmentvideoobjectdetection_torch.models.detectors import (
    fpn_faster_rcnn as TFF,
)
from lowlightenvironmentvideoobjectdetection_torch.models.necks import (
    extra_necks as TN,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)
from lowlightenvironmentvideoobjectdetection_tpu.core import (
    assigners as jassign,
    losses as jlosses,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.dense_heads import (
    guided_anchor_head as JGA,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.detectors import (
    fpn_faster_rcnn as JFF,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.necks import (
    extra_necks as JN,
)
from lowlightenvironmentvideoobjectdetection_tpu.ops.deform_conv import (
    deform_conv as jdeform_conv,
)

FEAT_TOL = 1e-4
# the 800 x 1344 bucket's FPN levels P2-P6
BUCKET_LEVELS = ((200, 336), (100, 168), (50, 84), (25, 42), (13, 21))


_pinned_threads = thread_count(1)


def _close(got, want, tol=FEAT_TOL, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


def _vars(jmodule, *args, seed=1):
    args = [[jnp.asarray(x) for x in a] if isinstance(a, list)
            else jnp.asarray(a) for a in args]
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(seed)))


def _boxes(rs, n, span):
    xy = rs.uniform(0, span * 0.6, (n, 2))
    wh = rs.uniform(4, span * 0.5, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("loss", ["bounded_iou", "balanced_l1"])
def test_losses_match_jax(loss):
    rs = np.random.RandomState(0)
    pred = _boxes(rs, 40, 100.0)
    target = pred + rs.randn(40, 4).astype(np.float32) * 6
    target[:, 2:] = np.maximum(target[:, 2:], target[:, :2] + 1)
    if loss == "balanced_l1":  # deltas on both sides of beta = 1
        pred, target = pred / 40, target / 40
    weight = (rs.rand(40) > 0.3).astype(np.float32)
    if loss == "bounded_iou":
        def jfn(p):
            return jlosses.bounded_iou_loss(p, jnp.asarray(target),
                                            weight=jnp.asarray(weight),
                                            avg_factor=7.0)
        tfn = tlosses.bounded_iou_loss
        w = torch.from_numpy(weight)
    else:
        def jfn(p):
            return jlosses.balanced_l1_loss(p, jnp.asarray(target),
                                            weight=jnp.asarray(weight)[:, None],
                                            avg_factor=7.0)
        tfn = tlosses.balanced_l1_loss
        w = torch.from_numpy(weight)[:, None]
    want, jg = jax.value_and_grad(jfn)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    t = torch.from_numpy(target).requires_grad_()
    got = tfn(p, t, weight=w, avg_factor=7.0)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    _close(p.grad, jg, 1e-5)
    assert (t.grad is None or not t.grad.abs().sum()) == (
        loss == "bounded_iou")  # the target carries no gradient there


# ---------------------------------------------------------------- sampler


def libra_uniforms(rng, n):
    """The uniforms ``iou_balanced_sample_gather`` draws from ``rng`` for n
    candidates: split into (pos, neg, floor), the refill from
    ``fold_in(neg, 1)``, the tiebreak from ``fold_in(rng, 17)``; the floor's
    draw goes unused without a floor (floor_thr -1, the Libra config)."""
    p, q, _ = jax.random.split(rng, 3)
    keys = (p, q, jax.random.fold_in(q, 1), jax.random.fold_in(rng, 17))
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (n,)))
                                      for k in keys]))


def _assign(rs, n, g, pos_share):
    """An assignment of n candidates to g gts: a share positive (their
    IoUs from 0.5), the rest negative with IoUs spread over [0, 0.5) or
    ignored."""
    kind = rs.rand(n)
    inds = np.where(kind < pos_share, rs.randint(1, g + 1, n),
                    np.where(kind < 0.95, 0, -1))
    iou = np.where(inds > 0, rs.uniform(0.5, 1, n), rs.uniform(0, 0.5, n))
    iou[rs.rand(n) < 0.2] = 0.0  # exact zeros for the floor case
    iou = iou.astype(np.float32)
    lab = np.where(inds > 0, 1, -1)
    return (jassign.AssignResult(jnp.asarray(inds, jnp.int32),
                                 jnp.asarray(iou), jnp.asarray(lab)),
            tassign.AssignResult(torch.from_numpy(inds).long(),
                                 torch.from_numpy(iou),
                                 torch.from_numpy(lab).long()))


@pytest.mark.parametrize("pos_share", [0.05, 0.4, 0.9],
                         ids=["few", "many", "most"])
@pytest.mark.parametrize("seed", [0, 1])
def test_iou_balanced_sampler_matches_jax(pos_share, seed):
    """At the Libra config's sampler (floor_thr -1, 3 bins, instance-
    balanced positives); "most" leaves the negatives short of their
    quota, so the refill runs dry."""
    rs = np.random.RandomState(7 + seed)
    n, num = 300, 64
    jas, tas = _assign(rs, n, 5, pos_share)
    key = jax.random.PRNGKey(11 + seed)
    want = jassign.iou_balanced_sample_gather(jas, key, num, 0.25)
    got = tassign.iou_balanced_sample_gather(tas, libra_uniforms(key, n),
                                             num, 0.25)
    np.testing.assert_array_equal(got.inds.numpy(), np.asarray(want.inds))
    np.testing.assert_array_equal(got.is_pos.numpy(),
                                  np.asarray(want.is_pos))
    np.testing.assert_array_equal(got.is_valid.numpy(),
                                  np.asarray(want.is_valid))
    assert 0 < int(got.is_pos.sum()) <= num // 4
    if pos_share < 0.9:
        assert int(got.is_valid.sum()) == num


# ---------------------------------------------------------------- BFP


def _levels(rs, sizes, c):
    return [rs.randn(1, h, w, c).astype(np.float32) for h, w in sizes]


def test_non_local_matches_jax():
    torch.set_num_threads(1)
    x = np.random.RandomState(2).randn(2, 7, 11, 16).astype(np.float32)
    jm = JN.NonLocal2d(dtype=jnp.float32)
    var = _vars(jm, x)
    tm = TN.NonLocal2d(16)
    tm.load_state_dict(from_jax_variables(var), strict=True)
    want = jm.apply(var, jnp.asarray(x))
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want)
    assert float(np.abs(np.asarray(want) - x).max()) > 1e-2


@pytest.mark.parametrize("sizes", [
    ((32, 32), (16, 16), (8, 8), (4, 4), (2, 2)),
    ((26, 42), (13, 21), (7, 11), (4, 6), (2, 3))], ids=["tiny", "odd"])
def test_bfp_matches_jax(sizes):
    torch.set_num_threads(1)
    xs = _levels(np.random.RandomState(3), sizes, 16)
    jm = JN.BFP(out_channels=16, refine_level=2, refine_type="non_local",
                dtype=jnp.float32)
    var = _vars(jm, xs)
    tm = TN.BFP(16)
    tm.load_state_dict(from_jax_variables(var), strict=True)
    want = jm.apply(var, [jnp.asarray(x) for x in xs])
    got = tm([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs])
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.permute(0, 2, 3, 1), w, what=f"level {i}")


def _jax_down(x, hw):
    """The JAX BFP's pool down (extra_necks.py BFP.down), NHWC."""
    ry, rx = max(x.shape[-3] // hw[0], 1), max(x.shape[-2] // hw[1], 1)
    x = fnn.max_pool(x, (ry, rx), strides=(ry, rx))
    if x.shape[-3:-1] != tuple(hw):
        x = JN._resize_to(x, hw)
    return x


def test_f23_bfp_resizes_against_mmdet_at_the_bucket():
    """At 800 x 1344 (refine level P4, 50 x 84): the JAX pool down and
    nearest resize (the port's) against mmdet's adaptive max pool and
    nearest interpolate."""
    rs = np.random.RandomState(4)
    ref = BUCKET_LEVELS[2]
    maps = [rs.randn(1, h, w, 1).astype(np.float32) for h, w in BUCKET_LEVELS]
    bsf = rs.randn(1, *ref, 1).astype(np.float32)
    same = {}
    for i, m in enumerate(maps):
        tm = torch.from_numpy(m).permute(0, 3, 1, 2)
        if i < 2:  # gather down
            j = _jax_down(jnp.asarray(m), ref)
            port = TN.BFP._down(tm, ref)
            mm = F.adaptive_max_pool2d(tm, ref)
        elif i > 2:  # gather up
            j = JN._resize_to(jnp.asarray(m), ref)
            port = TN._resize_to(tm, ref)
            mm = F.interpolate(tm, size=ref, mode="nearest")
        else:
            continue
        _close(port.permute(0, 2, 3, 1), j, 0.0, f"gather {i}")
        same[f"gather_P{i + 2}"] = torch.equal(port, mm)
    tb = torch.from_numpy(bsf).permute(0, 3, 1, 2)
    for i in (3, 4):  # scatter down
        hw = BUCKET_LEVELS[i]
        j = _jax_down(jnp.asarray(bsf), hw)
        port = TN.BFP._down(tb, hw)
        _close(port.permute(0, 2, 3, 1), j, 0.0, f"scatter {i}")
        same[f"scatter_P{i + 2}"] = torch.equal(
            port, F.adaptive_max_pool2d(tb, hw))
    assert same == {"gather_P2": True, "gather_P3": True, "gather_P5": True,
                    "gather_P6": False, "scatter_P5": True,
                    "scatter_P6": False}


# ---------------------------------------------------------------- GRoIE


def test_generalized_attention_matches_jax():
    torch.set_num_threads(1)
    x = np.random.RandomState(5).randn(6, 7, 7, 48).astype(np.float32)
    jm = JFF.GeneralizedAttention(dtype=jnp.float32)
    var = _vars(jm, x)
    tm = TFF.GeneralizedAttention(48)
    tm.load_state_dict(from_jax_variables(var), strict=True)
    want = jm.apply(var, jnp.asarray(x))
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want)


def test_generic_roi_extractor_matches_jax():
    torch.set_num_threads(1)
    rs = np.random.RandomState(6)
    feats = [rs.randn(128 // s, 128 // s, 48).astype(np.float32)
             for s in TFF.FPN_STRIDES[:4]]
    rois = _boxes(rs, 20, 128.0)
    rois[0] = [0, 0, 127, 127]  # a roi covering every level's whole map
    wgt = rs.randn(20, 7, 7, 48).astype(np.float32)
    jm = JFF.GenericRoIExtractor(out_channels=48)
    var = _vars(jm, feats, rois)

    def jfn(fs):
        return jm.apply(var, list(fs), jnp.asarray(rois))

    want = jfn([jnp.asarray(f) for f in feats])
    jgrads = jax.grad(lambda fs: jnp.sum(jfn(fs) * wgt))(
        [jnp.asarray(f) for f in feats])
    tm = TFF.GenericRoIExtractor(48)
    tm.load_state_dict(from_jax_variables(var), strict=True)
    tf = [torch.from_numpy(f)[None].requires_grad_() for f in feats]
    got = tm(tf, torch.from_numpy(rois))
    (got * torch.from_numpy(wgt)).sum().backward()
    _close(got, want)
    for i, (t, j) in enumerate(zip(tf, jgrads)):
        _close(t.grad[0], j, what=f"level {i}")


# ---------------------------------------------------------------- DCNv1


def _root_leaves(params):
    """The bridge of a module's own leaves (it names a leaf by its
    module's path)."""
    return {k.split(".", 1)[1]: v for k, v in from_jax_variables(
        {"params": {"m": params}}).items()}


def test_adaptive_dcn_matches_jax():
    torch.set_num_threads(1)
    rs = np.random.RandomState(7)
    x = rs.randn(2, 9, 12, 8).astype(np.float32)
    off = (rs.randn(2, 9, 12, 18) * 1.7).astype(np.float32)
    wgt = rs.randn(2, 9, 12, 6).astype(np.float32)
    jm = JGA.AdaptiveDCN(6)
    var = _vars(jm, x, off)

    def jfn(v, a, o):
        return jnp.sum(jm.apply(v, a, o) * wgt)

    want = jm.apply(var, jnp.asarray(x), jnp.asarray(off))
    jg = jax.grad(jfn, argnums=(0, 1, 2))(var, jnp.asarray(x),
                                          jnp.asarray(off))
    tm = TGA.AdaptiveDCN(8, 6)
    tm.load_state_dict(_root_leaves(var["params"]), strict=True)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    to = torch.from_numpy(off).permute(0, 3, 1, 2).requires_grad_()
    got = tm(tx, to).permute(0, 2, 3, 1)
    (got * torch.from_numpy(wgt)).sum().backward()
    _close(got, want)
    _close(tx.grad.permute(0, 2, 3, 1), jg[1], what="x")
    _close(to.grad.permute(0, 2, 3, 1), jg[2], what="offset")
    want_p = _root_leaves(jg[0]["params"])
    _close(tm.weight.grad, want_p["weight"].numpy(), what="weight")
    _close(tm.bias.grad, want_p["bias"].numpy(), what="bias")


def test_f22_offsets_are_interleaved_pairs_read_as_dy_then_dx():
    """JAX: ``shape_to_offsets`` puts (dy, dx) of tap k in channels 2k and
    2k + 1; ``deform_conv`` reads channel k as tap k's dy and 9 + k as its
    dx. So channel 1 (tap 0's dx, from dw) moves tap 1 in y. The port
    keeps both."""
    dwdh = np.array([[[0.7, -0.3]]], np.float32)  # w, h differ
    joff = np.asarray(JGA.shape_to_offsets(jnp.asarray(dwdh), 1))
    toff = TGA.shape_to_offsets(torch.from_numpy(dwdh)).numpy()
    np.testing.assert_array_equal(toff, joff)
    w = np.exp(0.7) * 4.0
    h = np.exp(-0.3) * 4.0
    np.testing.assert_allclose(joff[0, 0, :2], [-(h / 3 - 1), -(w / 3 - 1)],
                               rtol=1e-6)
    # one hot pixel; a kernel that keeps tap 1 (ky = 0, kx = 1) only; an
    # offset of +1 in channel 1
    x = np.zeros((5, 5, 1), np.float32)
    x[2, 3] = 1.0
    k = np.zeros((3, 3, 1, 1), np.float32)
    k[0, 1] = 1.0
    off = np.zeros((5, 5, 18), np.float32)
    off[..., 1] = 1.0
    out = np.asarray(jdeform_conv(jnp.asarray(x), jnp.asarray(off),
                                  jnp.asarray(k)))[..., 0]
    # tap 1 samples (py - 1 + dy, px): with dy = 1 it reads row py
    assert out[2, 3] == 1.0 and out[3, 3] == 0.0
    tout = TGA.deform_conv(torch.from_numpy(x).permute(2, 0, 1)[None],
                           torch.from_numpy(off).permute(2, 0, 1)[None],
                           torch.from_numpy(k).permute(3, 2, 0, 1))[0, 0]
    np.testing.assert_array_equal(tout.numpy(), out)


# ------------------------------------------------------ guided anchoring


GA_GTS = np.array([[10.0, 12.0, 90.0, 100.0], [40.0, 30.0, 70.0, 60.0],
                   [42.0, 28.0, 72.0, 62.0], [5.0, 60.0, 50.0, 120.0],
                   [0.0, 0.0, 127.0, 127.0], [3.0, 3.0, 20.0, 18.0],
                   [0.0, 0.0, 0.0, 0.0]], np.float32)
GA_VALID = np.array([True] * 6 + [False])


@pytest.mark.parametrize("kind", ["retina", "rpn"])
def test_ga_loc_targets_match_jax(kind):
    if kind == "retina":
        sizes = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
        kw = dict(strides=JGA.GA_STRIDES, octave_base_scale=4)
    else:
        sizes = [(32, 32), (16, 16), (8, 8), (4, 4), (2, 2)]
        kw = dict(strides=JFF.FPN_STRIDES, octave_base_scale=8)
    want, wavg = JGA.ga_loc_targets(jnp.asarray(GA_GTS),
                                    jnp.asarray(GA_VALID), sizes, **kw)
    got, gavg = TGA.ga_loc_targets(torch.from_numpy(GA_GTS),
                                   torch.from_numpy(GA_VALID), sizes, **kw)
    assert gavg == wavg
    seen = set()
    for (gt, gw), (wt, ww) in zip(got, want):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
        np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))
        seen |= set(np.unique(np.asarray(ww)).tolist())
    assert seen == {0.0, np.float32(0.1), 1.0}


def test_ga_overlaps_squares_and_shape_assign_match_jax():
    sizes = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    jg, tg = jnp.asarray(GA_GTS), torch.from_numpy(GA_GTS)
    labels = np.array([0, 1, 2, 3, 1, 0, 0])
    _close(TGA.ga_approx_overlaps(tg, sizes),
           JGA.ga_approx_overlaps(jg, sizes), 1e-6)
    np.testing.assert_array_equal(TGA.ga_squares(sizes).numpy(),
                                  JGA.ga_squares(sizes))
    ja = JGA.ga_shape_assign(jg, jnp.asarray(labels), jnp.asarray(GA_VALID),
                             sizes)
    ta = TGA.ga_shape_assign(tg, torch.from_numpy(labels),
                             torch.from_numpy(GA_VALID), sizes)
    np.testing.assert_array_equal(ta.assigned_gt_inds.numpy(),
                                  np.asarray(ja.assigned_gt_inds))
    assert int((ta.assigned_gt_inds > 0).sum()) > 0
    rsizes = [(32, 32), (16, 16), (8, 8), (4, 4), (2, 2)]
    _close(TFF.ga_rpn_approx_overlaps(tg, rsizes),
           JFF.ga_rpn_approx_overlaps(jg, rsizes), 1e-6)
    np.testing.assert_array_equal(TFF.ga_rpn_squares(rsizes).numpy(),
                                  JFF.ga_rpn_squares(rsizes))


def test_guided_anchors_match_jax():
    rs = np.random.RandomState(8)
    shape = (rs.randn(6, 9, 2) * 0.5).astype(np.float32)
    for stride in (8, 64):
        _close(TGA.guided_anchors(torch.from_numpy(shape), stride, 6, 9),
               JGA.guided_anchors(jnp.asarray(shape), stride, 6, 9), 1e-6)
        _close(TFF.ga_rpn_guided_anchors(torch.from_numpy(shape), stride, 6,
                                         9),
               JFF.ga_rpn_guided_anchors(jnp.asarray(shape), stride, 6, 9),
               1e-6)
