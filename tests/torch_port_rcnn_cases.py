"""Shared cases of the DC5 two-stage family tests
(``test_torch_port_rcnn_families*.py``): a family built on both sides at
the JAX CLI's ``--tiny`` sizes (64 x 64, f32) with 4 classes and a
32-channel neck, variables drawn in ``jax.eval_shape(init)``'s shapes and
bridged by ``from_jax_variables``; one training image; the samplers'
uniforms replayed from the JAX key as each family splits it; JAX's
proposals stopped (``stopped_proposals``, ROADMAP F6); the comparisons.

Tolerances as ``torch_port_variant_cases.py``: features to FEAT_TOL of
their largest value, losses to LOSS_RTOL (Dynamic R-CNN's ``batch_beta``,
a regression target, to STAT_RTOL), each gradient leaf to GRAD_REL
of its largest value (at least 1e-6 of the largest of any leaf),
detections as sets (boxes to 5e-3 px, scores to 1e-5).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_dark_backbones import draw
from test_torch_port_selsa import _same_dets
from test_torch_port_train import sampler_uniforms

from lowlightenvironmentvideoobjectdetection_torch.apis import (
    families as TF,
)
from lowlightenvironmentvideoobjectdetection_torch.models.builder import (
    TINY_KW,
)
from lowlightenvironmentvideoobjectdetection_torch.models.detectors import (
    cascade_rcnn as TCR,
    more_rcnn as TMR,
)
from lowlightenvironmentvideoobjectdetection_torch.models.detectors.faster_rcnn import (  # noqa: E501
    DetTrainBatch,
)
from lowlightenvironmentvideoobjectdetection_torch.models.vid.selsa import (
    LossUniforms,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
    grads_from_jax,
)
from lowlightenvironmentvideoobjectdetection_tpu.apis import (
    families as JF,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.dense_heads import (
    rpn_head as JRPN,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.detectors import (
    faster_rcnn as JFR,
)

FEAT_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
# Dynamic R-CNN's batch_beta is one positive's regression target (its xy
# deltas over stds of 0.1), not a loss: the proposals' float differences
# between the two frameworks (1e-5 px) reach it divided by 0.1 and the
# roi's width
STAT_RTOL = {"batch_beta": 1e-4}
HW = 64
MCFG = dict(num_classes=4, neck_channels=32)
GTS = np.array([[2.0, 1.0, 62.0, 63.0], [10.0, 20.0, 40.0, 50.0],
                [30.0, 5.0, 60.0, 30.0], [0.0, 0.0, 0.0, 0.0]], np.float32)
LABELS = np.array([1, 2, 3, 0])
VALID = np.array([True, True, True, False])
IMG_SHAPE = np.array([60.0, 62.0], np.float32)
NUM_PROPS = TINY_KW["train_nms_post"]
NUM_SAMPLES = TINY_KW["num_roi_samples"]


def built(name, seed=1):
    """(JAX family, JAX model, its aux, variables, port family, port
    model, its aux) for family ``name``."""
    jfam = JF.get_family(name)
    jm, jaux = jfam.build(dict(MCFG), True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, HW, HW, 3)))
    var = jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(seed)))
    tfam = TF.get_family(name)
    tm, taux = tfam.build(dict(MCFG), True, 0, "cpu")
    tm.load_state_dict(from_jax_variables(var, tm), strict=True)
    if jaux is not None:
        np.testing.assert_array_equal(taux.numpy(), np.asarray(jaux))
    return jfam, jm, jaux, var, tfam, tm, taux


def batches(seed=2):
    img = np.random.RandomState(seed).randn(HW, HW, 3).astype(np.float32)
    fields = (img, IMG_SHAPE, GTS, LABELS, VALID)
    return (JFR.DetTrainBatch(*(jnp.asarray(f) for f in fields)),
            DetTrainBatch(torch.from_numpy(img), torch.from_numpy(IMG_SHAPE),
                          torch.from_numpy(GTS),
                          torch.from_numpy(LABELS).long(),
                          torch.from_numpy(VALID)))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def uniforms(name, key, num_anchors, num_gts=GTS.shape[0]):
    """The port's uniforms for family ``name`` replaying the JAX draws of key
    ``key`` on a batch of ``num_gts`` gts: Cascade R-CNN splits it in 4 (the
    RPN, a RoI sampler a stage: stage 0 over the gts and the proposals, stages
    1 and 2 over the previous sample), HTC and SCNet in 5 (the same, the fifth
    unused); Cascade RPN samples stage 2 with it; the others split it into
    (rpn, roi), Trident folding in the branch, Grid R-CNN's jitter
    ``uniform(fold_in(key, 7))`` in +-0.15."""
    n_cand = num_gts + NUM_PROPS
    if name in ("HTC", "HybridTaskCascade", "SCNet"):
        r = jax.random.split(key, 5)  # the RPN, a RoI sampler a stage
        return TCR.CascadeUniforms(
            _t(sampler_uniforms(r[0], num_anchors)[:2]),
            (_t(sampler_uniforms(r[1], n_cand)),
             _t(sampler_uniforms(r[2], NUM_SAMPLES)),
             _t(sampler_uniforms(r[3], NUM_SAMPLES))))
    if name == "CascadeRPN":
        return _t(sampler_uniforms(key, num_anchors)[:2])
    if name == "CascadeRCNN":
        r = jax.random.split(key, 4)
        return TCR.CascadeUniforms(
            _t(sampler_uniforms(r[0], num_anchors)[:2]),
            (_t(sampler_uniforms(r[1], n_cand)),
             _t(sampler_uniforms(r[2], NUM_SAMPLES)),
             _t(sampler_uniforms(r[3], NUM_SAMPLES))))
    rng_rpn, rng_roi = jax.random.split(key)
    if name == "TridentFasterRCNN":
        return tuple(LossUniforms(
            _t(sampler_uniforms(jax.random.fold_in(rng_rpn, b),
                                num_anchors)[:2]),
            _t(sampler_uniforms(jax.random.fold_in(rng_roi, b), n_cand)))
            for b in range(3))
    rpn = _t(sampler_uniforms(rng_rpn, num_anchors)[:2])
    roi = _t(sampler_uniforms(rng_roi, n_cand))
    if name == "GridRCNN":
        jit = jax.random.uniform(jax.random.fold_in(key, 7),
                                 (NUM_SAMPLES, 4), minval=-0.15, maxval=0.15)
        return TMR.GridUniforms(rpn, roi, _t(jit))
    return LossUniforms(rpn, roi)


@contextlib.contextmanager
def stopped_proposals():
    """The JAX RPN proposals with ``stop_gradient`` on their boxes
    (ROADMAP F6): every DC5 family calls ``rpn_head.rpn_proposals``."""
    real = JRPN.rpn_proposals

    def stopped(*a, **kw):
        p = real(*a, **kw)
        return p._replace(boxes=jax.lax.stop_gradient(p.boxes))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JRPN, "rpn_proposals", stopped)
        yield


def jax_loss_and_grads(jfam, jm, jaux, var, key, jb, model=None):
    """The JAX family loss's metrics and parameter gradients (proposals
    stopped), in the layout of the port ``model`` (its transposed convs'
    kernels flipped)."""
    with stopped_proposals():
        (_, jmet), jg = jax.jit(jax.value_and_grad(
            lambda v: jfam.loss(jm, jaux, v, jb, key), has_aux=True))(var)
    return ({k: float(v) for k, v in jmet.items()},
            grads_from_jax(jax.tree_util.tree_map(np.asarray, jg["params"]),
                           model))


def same_loss_and_grads(want_met, want_grads, tfam, tm, taux, tb, u):
    """The port family's metrics to LOSS_RTOL and every gradient leaf to
    GRAD_REL; returns the port's metrics."""
    tm.zero_grad()
    total, met = tfam.loss(tm, taux, tb, uniforms=u)
    total.backward()
    assert set(met) == set(want_met)
    for k, w in want_met.items():
        np.testing.assert_allclose(float(met[k].detach()), w,
                                   rtol=STAT_RTOL.get(k, LOSS_RTOL),
                                   atol=1e-7, err_msg=k)
    params = dict(tm.named_parameters())
    assert set(params) == set(want_grads)
    top = max(float(np.abs(g.numpy()).max()) for g in want_grads.values())
    for n, w in want_grads.items():
        g = params[n].grad
        scale = float(np.abs(w.numpy()).max())
        if g is None:
            assert scale == 0.0, n
            continue
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=0,
            atol=max(GRAD_REL * scale, 1e-6 * top), err_msg=n)
    return {k: float(v.detach()) for k, v in met.items()}


def jax_detections(jfam, jm, jaux, var, jb):
    sf = jnp.asarray([0.5, 0.5, 0.5, 0.5], jnp.float32)
    return jax.jit(lambda v: jfam.detect(jm, jaux, v, jb.img, jb.img_shape,
                                         sf))(var)


def same_detections(want, tfam, tm, taux, tb):
    got = tfam.detect(tm, taux, tb.img, tb.img_shape,
                      torch.tensor([0.5, 0.5, 0.5, 0.5]))
    _same_dets(got, want)
    return got


def close(got, want, tol=FEAT_TOL, what=""):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-12),
                               err_msg=what)
