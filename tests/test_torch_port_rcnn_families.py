"""Cascade R-CNN, Cascade RPN, Double-Head R-CNN and Dynamic R-CNN in the
port against the JAX package on the CPU (``torch_port_rcnn_cases.py``:
the JAX CLI's ``--tiny`` sizes, f32, 4 classes, a 32-channel neck, bridged
variables, the JAX samplers' uniforms, JAX's proposals stopped):

- each model's forward (the flax ``__call__``: RPN outputs and the heads
  on fixed rois; Cascade RPN's two stages and refined anchors; Double-Head
  on rois whose 1.3x rescale reaches past the map) to 1e-4 of the largest
  value;
- each family's loss terms (Dynamic R-CNN's ``batch_iou`` and
  ``batch_beta`` too) to 1e-5 relative and every gradient leaf to 1e-4 of
  its largest value, through every name of the family (Double-Head's
  two); the detections as sets;
- ROADMAP F30: Cascade RPN's stage-2 losses alone give the stage-1
  parameters a non-zero gradient on both sides (the offsets follow the
  refined anchors without ``stop_gradient``), equal to 1e-4; the port's
  offsets put tap k = 3 (dy + 1) + (dx + 1) at its grid point of the
  refined anchor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_rcnn_cases import (
    batches,
    built,
    close,
    jax_detections,
    jax_loss_and_grads,
    same_detections,
    same_loss_and_grads,
    uniforms,
)
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.apis import (
    families as TF,
)
from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (
    cascade_rpn_head as TCRPN,
)
from lowlightenvironmentvideoobjectdetection_torch.models.detectors.faster_rcnn import (  # noqa: E501
    _zeros,
)
from lowlightenvironmentvideoobjectdetection_tpu.apis import (
    families as JF,
)

NAMES = {"CascadeRCNN": ("CascadeRCNN",), "CascadeRPN": ("CascadeRPN",),
         "DoubleHeadRCNN": ("DoubleHeadRCNN", "DoubleHeadRoIHead"),
         "DynamicRCNN": ("DynamicRCNN",)}
ALL = [(fam, n) for fam, names in NAMES.items() for n in names]
KEY = jax.random.PRNGKey(3)
ROIS = np.array([[0.0, 0.0, 32.0, 32.0]] * 8, np.float32)
_CASES = {}
_pinned_threads = thread_count(1)


def case(fam):
    """The family built on both sides and the JAX loss, gradients and
    detections, once a module."""
    if fam not in _CASES:
        jfam, jm, jaux, var, tfam, tm, taux = built(fam)
        jb, tb = batches()
        met, grads = jax_loss_and_grads(jfam, jm, jaux, var, KEY, jb)
        dets = jax_detections(jfam, jm, jaux, var, jb)
        _CASES[fam] = dict(jfam=jfam, jm=jm, jaux=jaux, var=var, tm=tm,
                           taux=taux, jb=jb, tb=tb, met=met, grads=grads,
                           dets=dets)
    return _CASES[fam]


def _anchors(fam, c):
    if fam == "CascadeRPN":
        return (64 // 16) ** 2
    return c["taux"].shape[0]


@pytest.mark.parametrize("fam", sorted(NAMES))
def test_forward_matches_jax(fam):
    c = case(fam)
    tm, img = c["tm"], c["tb"].img[None]
    want = jax.jit(lambda v: c["jm"].apply(v, jnp.asarray(img.numpy())))(
        c["var"])
    with torch.no_grad():
        if fam == "CascadeRPN":
            (c2, r2), r1, anchors, refined = tm(img)
            (jc2, jr2), jr1, janchors, jrefined = want
            np.testing.assert_array_equal(anchors.numpy(),
                                          np.asarray(janchors))
            for g, w, what in ((c2, jc2, "c2"), (r2, jr2, "r2"),
                               (r1, jr1, "r1"), (refined, jrefined, "ref")):
                close(g, w, what=what)
            return
        base = getattr(tm, "base", tm)  # Dynamic R-CNN's is Faster R-CNN
        feat = base.extract_feat(img)
        cls, reg = base.rpn_forward(feat)
        close(cls, want[0], what="rpn cls")
        close(reg, want[1], what="rpn reg")
        if fam == "CascadeRCNN":
            rois = torch.from_numpy(ROIS)
            rf = base.roi_feats(feat, rois, _zeros(rois))
            for st in range(3):
                for g, w in zip(tm.stage_forward(st, rf), want[2][st]):
                    close(g, w, what=f"stage {st}")
        elif fam == "DoubleHeadRCNN":
            rois = torch.from_numpy(ROIS[:4])
            for g, w in zip(tm.bbox_forward(feat, rois), want[2]):
                close(g, w, what="double head")


@pytest.mark.parametrize("fam,name", ALL)
def test_loss_and_grads_match_jax(fam, name):
    c = case(fam)
    assert JF.FAMILIES[name] is JF.FAMILIES[fam]
    tfam = TF.get_family(name)
    met = same_loss_and_grads(c["met"], c["grads"], tfam, c["tm"],
                              c["taux"], c["tb"],
                              uniforms(fam, KEY, _anchors(fam, c)))
    assert all(np.isfinite(v) for v in met.values())
    if fam == "DynamicRCNN":
        assert {"batch_iou", "batch_beta"} <= set(met)


@pytest.mark.parametrize("fam,name", ALL)
def test_detections_match_jax(fam, name):
    c = case(fam)
    got = same_detections(c["dets"], TF.get_family(name), c["tm"],
                          c["taux"], c["tb"])
    if fam == "CascadeRPN":
        assert got.boxes.shape == (300, 4) and not got.labels.any()


def test_cascade_rpn_stage2_gradient_reaches_stage1():
    """F30: the stage-2 losses alone differentiate stage 1 on both sides
    (through the offsets), to the same values."""
    c = case("CascadeRPN")
    jm, var, jb = c["jm"], c["var"], c["jb"]
    from lowlightenvironmentvideoobjectdetection_tpu.models.dense_heads import (  # noqa: E501
        cascade_rpn_head as JCRPN,
    )

    def s2(v):
        _, m = JCRPN.cascade_rpn_model_loss(jm, v, jb, KEY)
        return m["loss_s2_cls"] + m["loss_s2_reg"]

    jg = jax.jit(jax.grad(s2))(var)["params"]["crpn"]
    tm = c["tm"]
    tm.zero_grad()
    _, met = TCRPN.cascade_rpn_model_loss(tm, c["tb"],
                                          uniforms("CascadeRPN", KEY, 16))
    (met["loss_s2_cls"] + met["loss_s2_reg"]).backward()
    for mod in ("stage1_conv", "s1_reg"):
        w = np.asarray(jg[mod]["kernel"]).transpose(3, 2, 0, 1)
        g = getattr(tm.crpn, mod).weight.grad.numpy()
        assert np.abs(w).max() > 0 and np.abs(g).max() > 0, mod
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=mod)


def test_cascade_rpn_taps_sample_their_own_grid_points():
    """Tap k = 3 (dy + 1) + (dx + 1) of cell (y, x) samples (cy + dy h /
    3, cx + dx w / 3) of the cell's refined anchor (in strides): the 9 dy
    channels, then the 9 dx."""
    head = TCRPN.CascadeRPNHead(8)
    h, w = 3, 5
    rs = np.random.RandomState(0)
    xy = rs.uniform(0, 60, (h * w, 2))
    refined = torch.from_numpy(np.concatenate(
        [xy, xy + rs.uniform(8, 90, (h * w, 2))], 1).astype(np.float32))
    off = head.stage2_offsets(refined, h, w)[0].numpy()
    a = refined.numpy().reshape(h, w, 4) / 16.0
    cx, cy = (a[..., 0] + a[..., 2]) / 2, (a[..., 1] + a[..., 3]) / 2
    aw, ah = a[..., 2] - a[..., 0], a[..., 3] - a[..., 1]
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for k in range(9):
        dy, dx = k // 3 - 1, k % 3 - 1
        np.testing.assert_allclose(yy + dy + off[k], cy + dy * ah / 3,
                                   atol=1e-5)
        np.testing.assert_allclose(xx + dx + off[9 + k], cx + dx * aw / 3,
                                   atol=1e-5)
