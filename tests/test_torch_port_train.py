"""Port parity for the training slice: box geometry, assignment, sampling,
the losses, ``selsa_loss`` with its gradients, the optimizer, the LR
schedule, ``Trainer`` and resume, against the JAX package on the CPU in f32.

Every input comes from a numpy seed; the samplers get the uniforms the JAX
package draws from its keys (``jax_uniforms`` replays its key derivation).
Tolerances: exact where the arithmetic is the same; losses to rtol 1e-5;
gradients to an atol of 1e-4 times the leaf's largest |g| (convolutions sum
in another order); parameters after 3 optimizer steps to 1e-6.

The SELSA model is tiny: R50 (the port has only bottleneck depths), a 64x64
bucket, neck 32, 4 classes, 2 reference frames, train_nms_pre 128,
train_nms_post 32, test_nms_post 16, 32 sampled rois. The JAX side of
``selsa_loss`` is composed from the JAX package's public pieces with
``jax.lax.stop_gradient`` on the proposal boxes: the original (and the port)
do not differentiate through them, the JAX ``selsa_loss`` does (ROADMAP
fault F6, shown by ``test_f6_jax_differentiates_through_proposals``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_tpu.core import (
    assigners as jassign,
    boxes as jboxes,
    losses as jlosses,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.dense_heads import (
    rpn_head as jrpn,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.roi_heads import (
    bbox_head as jbh,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.vid import (
    selsa as JS,
)
from lowlightenvironmentvideoobjectdetection_tpu.parallel import (
    train as jtrain,
)
from lowlightenvironmentvideoobjectdetection_torch.apis.train import (
    train_model,
)
from lowlightenvironmentvideoobjectdetection_torch.core import (
    assigners as tassign,
    boxes as tboxes,
    losses as tlosses,
)
from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (
    rpn_head as trpn,
)
from lowlightenvironmentvideoobjectdetection_torch.models.roi_heads import (
    bbox_head as tbh,
)
from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
    selsa as TS,
)
from lowlightenvironmentvideoobjectdetection_torch.parallel import (
    train as ttrain,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
    grads_from_jax,
)
from torch_port_threads import thread_count


TINY = dict(pad_h=64, pad_w=64, neck_channels=32, num_classes=4,
            num_ref_frames=2, train_nms_pre=128, train_nms_post=32,
            test_nms_post=16, num_roi_samples=32)
LOSS_RTOL = 1e-5
GRAD_REL_ATOL = 1e-4
GRAD_FLOOR = 1e-6  # of the largest |g| of any leaf (see _close_grad)
PARAM_ATOL = 1e-6


_pinned_threads = thread_count(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def sampler_uniforms(rng, n):
    """The uniforms the JAX samplers draw from ``rng`` for n candidates:
    ``random_sample_masks`` splits it into (pos, neg) keys, and
    ``random_sample_gather`` adds ``uniform(fold_in(rng, 17))``."""
    p, q = jax.random.split(rng)
    return np.stack([np.asarray(jax.random.uniform(k, (n,)))
                     for k in (p, q, jax.random.fold_in(rng, 17))])


def jax_uniforms(rng, num_anchors, num_cand):
    """``selsa_loss``'s uniforms for key ``rng``: it splits the key into
    (rpn, roi) for the RPN and the RoI sampler."""
    rng_rpn, rng_roi = jax.random.split(rng)
    return TS.LossUniforms(_t(sampler_uniforms(rng_rpn, num_anchors)[:2]),
                           _t(sampler_uniforms(rng_roi, num_cand)))


def _boxes(rng, n, span=60.0):
    xy = rng.uniform(-5, span, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(0, 40, (n, 2))], 1
                          ).astype(np.float32)


def test_bbox_overlaps_exact_and_bbox2delta():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 30), _boxes(rng, 40)
    a[0] = [10, 10, 10, 30]  # zero area
    b[:3] = a[:3]  # equal boxes: IoU exactly 1
    got = tboxes.bbox_overlaps(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jboxes.bbox_overlaps(a, b)))
    assert got[1, 1] == got[2, 2] == 1.0
    gt = _boxes(rng, 40)
    gt[5] = [3, 3, 3, 9]  # a zero-width gt, clamped
    for stds in ((1.0, 1.0, 1.0, 1.0), (0.2, 0.2, 0.2, 0.2)):
        want = np.asarray(jboxes.bbox2delta(b, gt, stds=stds))
        got = tboxes.bbox2delta(_t(b), _t(gt), stds=stds).numpy()
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
        # the two logs differ in the last bit
        np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=1e-6,
                                   atol=1e-6)


def test_losses_match_jax():
    rng = np.random.RandomState(1)
    pred, target = rng.randn(50, 4) * 2, rng.randn(50, 4)
    w = (rng.rand(50, 1) > 0.3).astype(np.float32)
    pred, target = pred.astype(np.float32), target.astype(np.float32)
    logits = (rng.randn(50, 5) * 3).astype(np.float32)
    logits[0] = 0.0  # ties: argmax takes the first
    labels = rng.randint(-1, 6, 50)  # out of range: clamped
    lw = (rng.rand(50) > 0.2).astype(np.float32)
    bl = rng.randn(50).astype(np.float32) * 4
    bl[3] = 0.0
    y = (rng.rand(50) > 0.5).astype(np.float32)
    cases = [
        (tlosses.smooth_l1_loss(_t(pred), _t(target), beta=1 / 9,
                                weight=_t(w), avg_factor=7.0),
         jlosses.smooth_l1_loss(pred, target, beta=1 / 9, weight=w,
                                avg_factor=7.0)),
        (tlosses.smooth_l1_loss(_t(pred), _t(target)),
         jlosses.smooth_l1_loss(pred, target)),
        (tlosses.softmax_cross_entropy(_t(logits), _t(labels), weight=_t(lw),
                                       avg_factor=_t(lw.sum())),
         jlosses.softmax_cross_entropy(logits, labels, weight=lw,
                                       avg_factor=lw.sum())),
        (tlosses.binary_cross_entropy(_t(bl), _t(y), weight=_t(lw),
                                      avg_factor=0.5),
         jlosses.binary_cross_entropy(bl, y, weight=lw, avg_factor=0.5)),
        (tlosses.accuracy(_t(logits), _t(labels), _t(lw)),
         jlosses.accuracy(logits, labels, lw)),
        (tlosses.accuracy(_t(logits), _t(labels)),
         jlosses.accuracy(logits, labels)),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LOSS_RTOL, atol=0)


def _assign_inputs(seed):
    """Candidates with duplicates (a gt's best IoU tied by several boxes,
    and two gts tied on one box), invalid boxes and invalid gts."""
    rng = np.random.RandomState(seed)
    gts = _boxes(rng, 6)
    gts[3] = gts[4] = [10, 12, 50, 44]  # two equal gts: the later one claims
    boxes = np.concatenate([_boxes(rng, 60), gts[:3], gts[:3] + 0.5,
                            np.repeat(gts[3:4] + [1, 1, 2, 2], 3, 0)]
                           ).astype(np.float32)
    gt_valid = np.array([True, True, True, True, True, False])
    box_valid = rng.rand(boxes.shape[0]) > 0.1
    box_valid[60:] = True
    labels = rng.randint(0, 4, 6)
    return boxes, gts, labels, gt_valid, box_valid


@pytest.mark.parametrize("seed,thr", [(0, (0.7, 0.3, 0.3)),
                                      (1, (0.5, 0.5, 0.5)),
                                      (2, (0.6, 0.4, 0.0))])
def test_max_iou_assign_exact(seed, thr):
    boxes, gts, labels, gv, bv = _assign_inputs(seed)
    want = jassign.max_iou_assign(boxes, gts, labels, gv, *thr, box_valid=bv)
    got = tassign.max_iou_assign(_t(boxes), _t(gts), _t(labels), _t(gv), *thr,
                                 box_valid=_t(bv))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got.assigned_gt_inds.numpy() == 5).sum() >= 3  # gt 4 won the tie


@pytest.mark.parametrize("seed,num,frac", [(0, 16, 0.25), (1, 40, 0.5),
                                           (2, 200, 0.5)])
def test_samplers_with_jax_uniforms(seed, num, frac):
    """Masks and gather indices identical given JAX's own uniforms,
    including a quota larger than the candidates."""
    boxes, gts, labels, gv, bv = _assign_inputs(seed)
    a = jassign.max_iou_assign(boxes, gts, labels, gv, 0.5, 0.3, 0.3,
                               box_valid=bv)
    ta = tassign.AssignResult(*(_t(x).long() if x.dtype == jnp.int32
                                else _t(x) for x in a))
    rng = jax.random.PRNGKey(seed + 10)
    u = sampler_uniforms(rng, boxes.shape[0])
    wm = jassign.random_sample_masks(a, rng, num, frac)
    tm = tassign.random_sample_masks(ta, _t(u[:2]), num, frac)
    np.testing.assert_array_equal(tm.pos_mask.numpy(), np.asarray(wm.pos_mask))
    np.testing.assert_array_equal(tm.neg_mask.numpy(), np.asarray(wm.neg_mask))
    wg = jassign.random_sample_gather(a, rng, num, frac)
    tg = tassign.random_sample_gather(ta, _t(u), num, frac)
    for g, w in zip(tg, wg):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _gts(rng, n_valid, n=8, span=100.0):
    gt = np.zeros((n, 4), np.float32)
    gt[:n_valid] = _boxes(rng, n_valid, span)
    gt[:n_valid, 2:] += 20.0  # not too small for the anchors
    return gt, rng.randint(0, 4, n), np.arange(n) < n_valid


def test_rpn_loss_matches_jax():
    rng = np.random.RandomState(3)
    h, w, a = 6, 8, 12
    anchors = np.asarray(JS.make_anchors(JS.SelsaConfig(pad_h=96, pad_w=128)))
    cls = rng.randn(h, w, a).astype(np.float32)
    reg = (rng.randn(h, w, 4 * a) * 0.5).astype(np.float32)
    gt, _, gv = _gts(rng, 5)
    key = jax.random.PRNGKey(3)
    shape = np.array([90.0, 120.0], np.float32)
    want = jrpn.rpn_loss([(cls, reg)], [anchors], gt, gv, key, shape)
    got = trpn.rpn_loss(_t(cls), _t(reg), _t(anchors), _t(gt), _t(gv),
                        _t(sampler_uniforms(key, h * w * a)[:2]), _t(shape))
    for g, wnt in zip(got, want):
        assert float(wnt) > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt),
                                   rtol=LOSS_RTOL)


def _roi_targets_inputs(seed, n_props=40):
    rng = np.random.RandomState(seed)
    gt, labels, gv = _gts(rng, 5, n=6, span=60.0)
    props = _boxes(rng, n_props, 80.0)
    props[:4] = gt[:4] + rng.uniform(-3, 3, (4, 4))  # positives
    pv = rng.rand(n_props) > 0.15
    return props.astype(np.float32), pv, gt, labels, gv


def test_bbox_targets_and_loss_match_jax():
    props, pv, gt, labels, gv = _roi_targets_inputs(4)
    key = jax.random.PRNGKey(4)
    want = jbh.bbox_targets(props, pv, gt, labels, gv, key, num_classes=4,
                            num_samples=32)
    u = sampler_uniforms(key, gt.shape[0] + props.shape[0])
    got = tbh.bbox_targets(_t(props), _t(pv), _t(gt), _t(labels), _t(gv),
                           _t(u), num_classes=4, num_samples=32)
    for name in ("rois", "labels", "label_weights", "bbox_weights", "is_pos"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), rtol=1e-6,
                               atol=1e-6)
    assert 0 < int(got.is_pos.sum()) <= 8  # a quarter of 32 at most

    rng = np.random.RandomState(5)
    cls = (rng.randn(32, 5) * 2).astype(np.float32)
    reg = rng.randn(32, 16).astype(np.float32)
    jl = jbh.bbox_loss(cls, reg, want, num_classes=4)
    tl = tbh.bbox_loss(_t(cls), _t(reg), got, num_classes=4)
    for g, w in zip(tl, jl):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LOSS_RTOL)


# ---- the SELSA loss at the tiny size


def _tiny_batch(seed=0, n=1):
    """n samples of a key frame and 2 reference frames, 8 padded gts of
    which 5 are valid; the first covers most of the image, so the few
    anchors inside a 64x64 image have a positive."""
    rng = np.random.RandomState(seed)
    imgs = rng.randn(n, 3, 64, 64, 3).astype(np.float32)
    gts, labels, valid = zip(*(_gts(rng, 5, span=40.0) for _ in range(n)))
    gts = np.clip(np.stack(gts), 0, 64)
    gts[:, 0] = [2.0, 1.0, 62.0, 63.0]
    return JS.TrainBatch(imgs, np.full((n, 2), 64.0, np.float32), gts,
                         np.stack(labels).astype(np.int32), np.stack(valid))


def _jax_loss_stopped(model, params, batch, rng, anchors):
    """The JAX ``selsa_loss`` composed from the package's public pieces,
    with ``stop_gradient`` on the proposal boxes (the original's
    semantics; ROADMAP F6)."""
    cfg = model.cfg
    rng_rpn, rng_roi = jax.random.split(rng)
    _, neck = model.apply(params, batch.imgs,
                          method=JS.SelsaDetector.extract_feat)
    cls, reg = model.apply(params, neck, method=JS.SelsaDetector.rpn_forward)
    rpn_l = jrpn.rpn_loss([(cls[0], reg[0])], [anchors], batch.gt_boxes,
                          batch.gt_valid, rng_rpn, batch.img_shape)
    key = jrpn.rpn_proposals([(cls[0], reg[0])], [anchors], batch.img_shape,
                             nms_pre=cfg.train_nms_pre,
                             nms_post=cfg.train_nms_post,
                             iou_threshold=cfg.rpn_nms_iou)
    refs = [jrpn.rpn_proposals([(cls[i], reg[i])], [anchors], batch.img_shape,
                               nms_pre=cfg.test_nms_pre,
                               nms_post=cfg.test_nms_post,
                               iou_threshold=cfg.rpn_nms_iou)
            for i in range(1, batch.imgs.shape[0])]
    tgts = jbh.bbox_targets(jax.lax.stop_gradient(key.boxes), key.valid,
                            batch.gt_boxes, batch.gt_labels, batch.gt_valid,
                            rng_roi, num_classes=cfg.num_classes,
                            num_samples=cfg.num_roi_samples)
    kf = model.apply(params, neck[0], tgts.rois,
                     jnp.zeros((tgts.rois.shape[0],), jnp.int32),
                     method=JS.SelsaDetector.roi_feats)
    ref_boxes = jax.lax.stop_gradient(
        jnp.concatenate([p.boxes for p in refs]))
    binds = jnp.repeat(jnp.arange(len(refs), dtype=jnp.int32),
                       cfg.test_nms_post)
    rf = model.apply(params, neck[1:], ref_boxes, binds,
                     method=JS.SelsaDetector.roi_feats)
    cs, bp = model.apply(params, kf, rf,
                         jnp.concatenate([p.valid for p in refs]),
                         method=JS.SelsaDetector.bbox_forward)
    roi_l = jbh.bbox_loss(cs, bp, tgts, num_classes=cfg.num_classes)
    total = rpn_l.loss_cls + rpn_l.loss_bbox + roi_l.loss_cls + roi_l.loss_bbox
    return total, {"loss": total, "loss_rpn_cls": rpn_l.loss_cls,
                   "loss_rpn_bbox": rpn_l.loss_bbox,
                   "loss_cls": roi_l.loss_cls, "loss_bbox": roi_l.loss_bbox,
                   "acc": roi_l.acc}


def _sample(batch, i):
    return type(batch)(*(jnp.asarray(f[i]) for f in batch))


def _port_sample(batch, i):
    return TS.TrainBatch(*(_t(f[i]) for f in batch[:3]),
                         _t(batch.gt_labels[i]).long(),
                         _t(batch.gt_valid[i]))


@pytest.fixture(scope="module")
def tiny():
    """The JAX model and params, the port model with the same weights, one
    sample, its key, the uniforms it draws, and the JAX losses and
    gradients: the composed loss with stop_gradient on the proposals, and
    the RoI-head loss of the JAX ``selsa_loss`` itself."""
    jcfg = JS.SelsaConfig(compute_dtype=jnp.float32, **TINY)
    jmodel = JS.SelsaDetector(cfg=jcfg)
    params = JS.init_params(jmodel, jax.random.PRNGKey(0), small=True)
    rng = np.random.RandomState(7)
    # non-trivial biases, BN scales and statistics, so every leaf is bridged
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x, np.float32)
        * (rng.uniform(0.8, 1.25, x.shape) if str(p[-1].key) in
           ("var", "scale") else 1.0)
        + (rng.randn(*x.shape) * 0.02 if str(p[-1].key) in ("bias", "mean")
           else 0.0), params)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    params)
    anchors = JS.make_anchors(jcfg)
    batch = _tiny_batch()
    sample = _sample(batch, 0)
    key = jax.random.PRNGKey(11)

    stopped = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss_stopped(jmodel, p, sample, key, anchors),
        has_aux=True))
    (_, metrics), grads = stopped(params)

    def roi_part(p):
        _, m = JS.selsa_loss(jmodel, p, sample, key, anchors)
        return m["loss_cls"] + m["loss_bbox"], m

    (_, f6_metrics), f6_grads = jax.jit(jax.value_and_grad(
        roi_part, has_aux=True))(params)
    tmodel = TS.SelsaDetector(TS.SelsaConfig(compute_dtype=torch.float32,
                                             **TINY))
    tmodel.load_state_dict(from_jax_variables(params), strict=True)
    a = anchors.shape[0]
    uniforms = jax_uniforms(key, a, 8 + TINY["train_nms_post"])
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(jmodel=jmodel, params=params, tmodel=tmodel, batch=batch,
                anchors=np.asarray(anchors), uniforms=uniforms,
                metrics=to_np(metrics),
                grads=grads_from_jax(to_np(grads["params"])),
                f6_metrics=to_np(f6_metrics),
                f6_grads=grads_from_jax(to_np(f6_grads["params"])))


def _port_loss(tiny, roi_only=False):
    """The port's loss on the tiny sample with JAX's uniforms; returns its
    metrics and parameter name -> gradient (zeros where no gradient)."""
    model = tiny["tmodel"]
    model.zero_grad(set_to_none=True)
    loss, metrics = TS.selsa_loss(model, _port_sample(tiny["batch"], 0),
                                  _t(tiny["anchors"]),
                                  uniforms=tiny["uniforms"])
    (metrics["loss_cls"] + metrics["loss_bbox"] if roi_only
     else loss).backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    return {k: v.item() for k, v in metrics.items()}, grads


def _close_grad(name, got, want, floor):
    """atol GRAD_REL_ATOL x the leaf's largest |g|, at least ``floor``: the
    key-embedding biases' gradients are zero in exact arithmetic (softmax
    ignores a constant per query), so only rounding noise is left there."""
    scale = float(np.abs(want.numpy()).max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=max(GRAD_REL_ATOL * scale, floor),
                               err_msg=name)


def _floor(grads):
    """GRAD_FLOOR x the largest |g| over all leaves."""
    return GRAD_FLOOR * max(float(g.abs().max()) for g in grads.values())


def test_selsa_loss_and_every_gradient_match_jax(tiny):
    metrics, grads = _port_loss(tiny)
    for k, v in tiny["metrics"].items():
        np.testing.assert_allclose(metrics[k], v, rtol=LOSS_RTOL, err_msg=k)
    assert metrics["loss_rpn_bbox"] > 0 and metrics["loss_bbox"] > 0
    assert set(grads) == set(tiny["grads"])
    floor = _floor(tiny["grads"])
    for name, want in tiny["grads"].items():
        _close_grad(name, grads[name], want, floor)
    # frozen_stages=1: the stem and stage 1 take no gradient on either side
    frozen = [n for n in grads if n.startswith(("backbone.conv1",
                                                "backbone.bn1",
                                                "backbone.layer1_"))]
    assert frozen and all(not grads[n].any() and not tiny["grads"][n].any()
                          for n in frozen)
    assert tiny["grads"]["backbone.layer2_0.bn1.weight"].abs().max() > 0


def test_f6_jax_differentiates_through_proposals(tiny):
    """The JAX ``selsa_loss`` gives the same losses, and the same bbox-head
    gradients for the RoI loss, but its RoI loss also reaches the RPN
    regression conv through the proposal boxes; the port's does not."""
    metrics, grads = _port_loss(tiny, roi_only=True)
    for k, v in tiny["f6_metrics"].items():
        np.testing.assert_allclose(metrics[k], v, rtol=LOSS_RTOL, err_msg=k)
    floor = _floor(tiny["f6_grads"])
    for name, want in tiny["f6_grads"].items():
        if name.startswith("bbox_head."):
            _close_grad(name, grads[name], want, floor)
    jax_reg = tiny["f6_grads"]["rpn_head.rpn_reg.weight"].abs().sum()
    assert jax_reg > 0
    assert not grads["rpn_head.rpn_reg.weight"].any()
    assert not grads["rpn_head.rpn_cls.weight"].any()


# ---- optimizer, schedule, trainer, resume

_OPT_TREE = {
    "backbone": {"conv1": {"kernel": (3, 3, 3, 4)},
                 "bn1": {"scale": (4,), "bias": (4,)},
                 "layer1_0": {"conv1": {"kernel": (1, 1, 4, 4)}},
                 "layer2_0": {"conv1": {"kernel": (1, 1, 4, 8)},
                              "bn1": {"scale": (8,), "bias": (8,)}}},
    "neck": {"conv0": {"kernel": (3, 3, 8, 6), "bias": (6,)}},
    "bbox_head": {"fc_cls": {"kernel": (6, 5), "bias": (5,)}},
}


def _tree(rng, scale):
    return jax.tree_util.tree_map(
        lambda s: (rng.randn(*s) * scale).astype(np.float32), _OPT_TREE,
        is_leaf=lambda x: isinstance(x, tuple))


def test_optimizer_three_steps_match_optax():
    """Three updates of the port's optimizer against the JAX
    ``make_optimizer`` (optax) on the same parameters and gradients: the
    second step's gradients are over the clip norm, frozen leaves (stem,
    bn1, stage 1) stay bit-identical."""
    rng = np.random.RandomState(8)
    params = _tree(rng, 1.0)
    grads = [_tree(rng, s) for s in (0.5, 5.0, 1.0)]  # norms ~13, 128, 26
    opt = jtrain.make_optimizer(params, lr=jtrain.make_lr_schedule(0.1))
    jstate = opt.init(params)
    tparams = {n: p.clone() for n, p in grads_from_jax(params).items()}
    start = {n: p.clone() for n, p in tparams.items()}
    topt = ttrain.Optimizer(ttrain.frozen_mask(list(tparams)),
                            ttrain.make_lr_schedule(0.1))
    tstate = topt.init(tparams)
    jp, norms = params, []
    for g in grads:
        updates, jstate = opt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for n, tg in grads_from_jax(g).items():
            tparams[n].grad = tg
        tstate, norm = topt.step(tparams, tstate)
        norms.append(norm)
        for n, want in grads_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             jp)).items():
            np.testing.assert_allclose(tparams[n].numpy(), want.numpy(),
                                       rtol=0, atol=PARAM_ATOL, err_msg=n)
    assert norms[0] < 35.0 <= norms[1] and norms[2] < 35.0
    frozen = [n for n in tparams if n.startswith(("backbone.conv1",
                                                  "backbone.bn1",
                                                  "backbone.layer1_"))]
    assert len(frozen) == 4 and len(tstate.trace) == len(tparams) - 4
    for n in tparams:
        assert torch.equal(tparams[n], start[n]) == (n in frozen), n


def test_lr_schedule_matches_jax():
    kw = dict(base_lr=0.02, iters_per_epoch=1000)
    want = jtrain.make_lr_schedule(**kw)
    got = ttrain.make_lr_schedule(**kw)
    for count in (0, 1, 250, 499, 500, 501, 1999, 2000, 2001, 4999, 5000,
                  7000):
        assert got(count) == np.asarray(want(count)), count
    assert got(0) == np.float32(0.02) * np.float32(1 / 3)
    assert got(5000) < got(4999) < got(1999)


def _port_batch(batch):
    return TS.TrainBatch(*(_t(f) for f in batch[:3]),
                         _t(batch.gt_labels).long(), _t(batch.gt_valid))


def _fresh_model(tiny):
    model = TS.SelsaDetector(TS.SelsaConfig(compute_dtype=torch.float32,
                                            **TINY))
    model.load_state_dict(tiny["tmodel"].state_dict(), strict=True)
    return model


def test_trainer_batch_of_two_matches_jax_trainer(tiny):
    """One step of the JAX ``Trainer`` (``jax.vmap`` of the stop-gradient
    loss, its mean, optax) on a one-device mesh against the port's
    ``Trainer`` with the same per-sample uniforms: mean losses to rtol
    1e-5; each leaf's update to 1e-4 of the leaf's largest update, at
    least 1e-6 of the largest of any leaf, plus two float32 roundings of
    the parameter; frozen leaves unchanged."""
    jmodel, params, anchors = tiny["jmodel"], tiny["params"], tiny["anchors"]
    batch = _tiny_batch(seed=1, n=2)
    janchors = jnp.asarray(anchors)
    trainer = jtrain.Trainer(
        loss_fn=lambda v, b, r: _jax_loss_stopped(jmodel, v, b, r, janchors),
        optimizer=jtrain.make_optimizer(params, lr=0.01),
        mesh=jtrain.create_mesh(1))
    rng = jax.random.PRNGKey(21)
    jstate, jmetrics = trainer.make_step()(
        trainer.init_state(params), jax.tree_util.tree_map(jnp.asarray, batch),
        rng)
    new = grads_from_jax(jax.tree_util.tree_map(np.asarray,
                                                jstate.params["params"]))

    model = _fresh_model(tiny)
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    a, cand = anchors.shape[0], 8 + TINY["train_nms_post"]
    rngs = [jax_uniforms(k, a, cand) for k in jax.random.split(rng, 2)]
    ptrainer = ttrain.Trainer(
        lambda m, s, u: TS.selsa_loss(m, s, _t(anchors), uniforms=u),
        ttrain.make_optimizer(model, lr=0.01))
    state, metrics = ptrainer.step(ptrainer.init_state(model),
                                   _port_batch(batch), rngs)
    assert state.step == 1 and state.opt_state.count == 1
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], np.asarray(v), rtol=LOSS_RTOL,
                                   err_msg=k)
    got = {n: p.detach() - old[n] for n, p in model.named_parameters()}
    want = {n: new[n] - old[n] for n in got}
    floor = _floor(want)
    for n in got:
        ulp = 2 * np.finfo(np.float32).eps * float(old[n].abs().max())
        scale = float(want[n].abs().max())
        np.testing.assert_allclose(
            got[n].numpy(), want[n].numpy(), rtol=0,
            atol=max(GRAD_REL_ATOL * scale, floor) + ulp, err_msg=n)
        if n.startswith(("backbone.conv1", "backbone.bn1",
                         "backbone.layer1_")):
            assert not got[n].any() and not want[n].any(), n


def test_resume_is_bit_exact(tiny, tmp_path):
    """train_model: 1 step, a checkpoint, then 2 steps resumed from it in a
    fresh model equal 3 steps in one run, bit for bit (parameters,
    momentum, step); the per-step generators come from (seed, step)."""
    anchors = _t(tiny["anchors"])
    batches = [_port_batch(_tiny_batch(seed=s, n=1)) for s in (2, 3, 4)]

    def loss_fn(model, sample, generator):
        return TS.selsa_loss(model, sample, anchors, generator=generator)

    full = train_model(loss_fn, _fresh_model(tiny), batches, 3, seed=5,
                       log_interval=100)
    train_model(loss_fn, _fresh_model(tiny), batches, 1, seed=5,
                log_interval=100, checkpoint_dir=str(tmp_path),
                checkpoint_interval=1)
    resumed = train_model(loss_fn, _fresh_model(tiny), batches[1:], 2, seed=5,
                          log_interval=100,
                          resume_from=str(tmp_path / "step_1.pt"))
    assert full.step == resumed.step == 3
    assert full.opt_state.count == resumed.opt_state.count == 3
    want, got = full.model.state_dict(), resumed.model.state_dict()
    assert set(want) == set(got)
    assert all(torch.equal(want[k], got[k]) for k in want)
    assert all(torch.equal(full.opt_state.trace[k], resumed.opt_state.trace[k])
               for k in full.opt_state.trace)
    start = tiny["tmodel"].state_dict()
    assert not torch.equal(want["neck.conv0.weight"], start["neck.conv0.weight"])
    assert torch.equal(want["backbone.layer1_0.conv1.weight"],
                       start["backbone.layer1_0.conv1.weight"])
