"""Shared cases of the FPN-variant and GA-RetinaNet family tests
(``test_torch_port_{ga_rpn,groie,libra,ga_retinanet}.py``): a family built
on both sides at the JAX CLI's ``--tiny`` sizes (128 x 128, f32, 4
classes, ``FPN_TINY_KW``) with variables drawn in ``jax.eval_shape(init)``'s
shapes and bridged by ``from_jax_variables``; one training image; the
samplers' uniforms replayed from the JAX key; the comparisons.

Tolerances as ``test_torch_port_fpn.py``: features to FEAT_TOL of their
largest value, losses to LOSS_RTOL, each gradient leaf to GRAD_REL of its
largest value (at least 1e-6 of the largest of any leaf), detections as
sets (boxes to 5e-3 px, scores to 1e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_port_dark_backbones import draw
from test_torch_port_fpn_variant_parts import libra_uniforms
from test_torch_port_selsa import _same_dets
from test_torch_port_train import sampler_uniforms

from lowlightenvironmentvideoobjectdetection_torch.apis import (
    families as TF,
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
from lowlightenvironmentvideoobjectdetection_tpu.models.detectors import (
    fpn_faster_rcnn as JFF,
)

FEAT_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
HW = 128
MCFG = dict(num_classes=4)
GTS = np.array([[10.0, 12.0, 90.0, 100.0], [40.0, 30.0, 70.0, 60.0],
                [5.0, 60.0, 50.0, 120.0], [0.0, 0.0, 0.0, 0.0]], np.float32)
LABELS = np.array([1, 3, 0, 0])
VALID = np.array([True, True, True, False])


def built(name, seed=5):
    """(JAX family, JAX model, its anchors, variables, port family, port
    model) for family ``name``."""
    torch.set_num_threads(1)
    jfam = JF.get_family(name)
    jm, jaux = jfam.build(dict(MCFG), True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, HW, HW, 3)))
    var = jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(seed)))
    tfam = TF.get_family(name)
    tm, _ = tfam.build(dict(MCFG), True, 0, "cpu")
    tm.load_state_dict(from_jax_variables(var), strict=True)
    return jfam, jm, jaux, var, tfam, tm


def batches(seed=6):
    img = np.random.RandomState(seed).randn(HW, HW, 3).astype(np.float32)
    fields = (img, np.array([120.0, 124.0], np.float32), GTS, LABELS, VALID)
    return (JFF.FPNDetBatch(*(jnp.asarray(f) for f in fields)),
            DetTrainBatch(torch.from_numpy(img),
                          torch.from_numpy(fields[1]), torch.from_numpy(GTS),
                          torch.from_numpy(LABELS).long(),
                          torch.from_numpy(VALID)))


def close(got, want, tol=FEAT_TOL, what=""):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


def fpn_uniforms(key, num_anchors, sampler):
    """The FPN loss's uniforms for key ``key``: (rpn, roi) keys; the RPN's
    (pos, neg) over ``num_anchors``, the RoI sampler's over the gts and the
    train proposals."""
    rng_rpn, rng_roi = jax.random.split(key)
    n = GTS.shape[0] + TF.FPN_TINY_KW["train_nms_post"]
    roi = (libra_uniforms(rng_roi, n) if sampler == "iou_balanced"
           else torch.from_numpy(sampler_uniforms(rng_roi, n)))
    return LossUniforms(torch.from_numpy(
        sampler_uniforms(rng_rpn, num_anchors)[:2]), roi)


def stopped_proposals(monkeypatch):
    """The JAX FPN loss with ``stop_gradient`` on its proposal boxes
    (ROADMAP fault F6), through ``monkeypatch``."""
    real = JFF._fpn_proposals

    def stopped(*a, **kw):
        p = real(*a, **kw)
        return p._replace(boxes=jax.lax.stop_gradient(p.boxes))

    monkeypatch.setattr(JFF, "_fpn_proposals", stopped)


def same_loss_and_grads(jfam, jm, jaux, var, tfam, tm, uniforms, key):
    """The family losses' metrics to LOSS_RTOL and every gradient leaf to
    GRAD_REL; returns the port's metrics."""
    jb, tb = batches()
    (_, jmet), jg = jax.jit(jax.value_and_grad(
        lambda v: jfam.loss(jm, jaux, v, jb, key), has_aux=True))(var)
    tm.zero_grad()
    total, met = tfam.loss(tm, None, tb, uniforms=uniforms)
    total.backward()
    assert set(met) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    want = grads_from_jax(jg["params"])
    params = dict(tm.named_parameters())
    top = max(float(np.abs(g.numpy()).max()) for g in want.values())
    for n, w in want.items():
        g = params[n].grad
        scale = float(np.abs(w.numpy()).max())
        if g is None:
            assert scale == 0.0, n
            continue
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=0,
            atol=max(GRAD_REL * scale, 1e-6 * top), err_msg=n)
    return {k: float(v.detach()) for k, v in met.items()}


def same_detections(jfam, jm, jaux, var, tfam, tm):
    jb, tb = batches()
    sf = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
    want = jax.jit(lambda v: jfam.detect(jm, jaux, v, jb.img, jb.img_shape,
                                         jnp.asarray(sf)))(var)
    got = tfam.detect(tm, None, tb.img, tb.img_shape, torch.from_numpy(sf))
    _same_dets(got, want)
    return got


def jax_method(jm, var, method):
    return jax.jit(functools.partial(jm.apply, var, method=method))
