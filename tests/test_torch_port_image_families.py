"""The image-detector family table (``apis/families.py``) and the
DC5 families in the port against the JAX package on the CPU, f32, at the
JAX CLI's tiny sizes (64 x 64, 4 classes) with a 32-channel neck and
bridged variables (``FastRCNN`` and ``RPN`` wrap Faster R-CNN as
``base``, as the flax modules do):

- the table: the port's families and the names that raise
  ``NotImplementedError`` (naming ROADMAP item 9) are exactly the JAX
  table's names; no name raises ``KeyError``; an unknown type is None;
  the FPN variants' and GA-RetinaNet's 8 names build their variant with
  the JAX model's parameter count;
- ``FasterRCNN``, ``FastRCNN`` (on the fixed proposal grid) and ``RPN``
  through each side's family entry: the loss terms to 1e-5 relative with
  JAX's uniforms, for Fast R-CNN and the RPN every gradient to 1e-4 (the
  JAX Faster R-CNN loss differentiates through its proposals, ROADMAP
  F6), and the detections as sets;
- ``DetectorModel`` (``inference_detector`` on a 48 x 64 frame) against
  the JAX ``DetectorModel``: the same per-class rows; the seeded synthetic
  batches (``make_synth_batch``) equal the JAX CLI's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_dark_backbones import draw
from test_torch_port_selsa import _same_dets
from test_torch_port_train import jax_uniforms, sampler_uniforms
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.apis import (
    families as TF,
)
from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
    DetectorModel,
)
from lowlightenvironmentvideoobjectdetection_torch.models.detectors.faster_rcnn import (  # noqa: E501
    DetTrainBatch,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
    grads_from_jax,
)
from lowlightenvironmentvideoobjectdetection_tpu.apis import (
    families as JF,
    inference as JI,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.detectors import (
    faster_rcnn as JFR,
)

MCFG = dict(num_classes=4, neck_channels=32)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
DC5 = ("FasterRCNN", "FastRCNN", "RPN")
# the FPN variants' and GA-RetinaNet's names (the JAX zoo's aliases in
# pairs) -> what each builds: (rpn_type, roi_extract, with_bfp), or the
# model class's name
VARIANTS = {
    "GAFasterRCNN": ("ga", "single", False),
    "GARPNHead": ("ga", "single", False),
    "GRoIEFasterRCNN": ("rpn", "groie", False),
    "GenericRoIExtractor": ("rpn", "groie", False),
    "LibraFasterRCNN": ("rpn", "single", True),
    "LibraRCNN": ("rpn", "single", True),
    "GARetinaNet": "GARetinaNet",
    "GuidedAnchoring": "GARetinaNet",
}


# the dense one-stage heads (test_torch_port_dense_families*.py)
DENSE = {"FCOS", "NASFCOS", "ATSS", "GFL", "PAA", "VFNet", "FreeAnchor",
         "FreeAnchorRetinaNet", "PISA", "PISARetinaNet"}
# the rest of the one-stage zoo (test_torch_port_zoo_heads_c.py)
ZOO_C = {"FSAF", "FoveaBox", "FOVEA", "SABL", "SABLRetinaNet", "RepPoints",
         "RepPointsDetector", "NASFPNRetinaNet"}
# the two-stage families on the DC5 trunk (test_torch_port_rcnn_*.py)
RCNN = {"CascadeRCNN", "CascadeRPN", "DoubleHeadRCNN", "DoubleHeadRoIHead",
        "DynamicRCNN", "PISAFasterRCNN", "PISARoIHead", "GridRCNN",
        "TridentFasterRCNN"}
# the mask families (test_torch_port_mask_*.py)
MASK = {"MaskRCNN", "MaskScoringRCNN", "PointRend", "HTC",
        "HybridTaskCascade", "SCNet", "YOLACT"}


_pinned_threads = thread_count(1)


def test_the_table_covers_the_jax_names():
    ported = set(TF.FAMILIES)
    assert ported == {"FasterRCNN", "FastRCNN", "RPN", "FasterRCNNFPN",
                      "RetinaNet"} | set(VARIANTS) | DENSE | ZOO_C | RCNN \
        | MASK
    assert ported | set(TF.NOT_PORTED) == set(JF.FAMILIES)
    assert ported | set(TF.NOT_PORTED) == TF.IMAGE_FAMILIES
    assert not ported & set(TF.NOT_PORTED)
    for name in TF.NOT_PORTED:
        with pytest.raises(NotImplementedError, match="item 9"):
            TF.get_family(name)
    assert TF.get_family("SELSA") is None


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_the_variant_names_build(name):
    """Each of the 8 names builds at ``tiny`` with the JAX zoo's variant
    (``zoo.py`` ``_build_fpn_frcnn`` keywords, or GARetinaNet) and the
    JAX model's parameter count."""
    torch.set_num_threads(1)
    model, aux = TF.get_family(name).build(dict(num_classes=4), True, 0,
                                           "cpu")
    want = VARIANTS[name]
    if isinstance(want, str):
        assert type(model).__name__ == want
    else:
        assert (model.rpn_type, model.roi_extract, model.with_bfp) == want
        assert TF.pad_hw(model, TF.get_family(name), True) == (128, 128)
    assert aux is None
    jm, _ = JF.get_family(name).build(dict(num_classes=4), True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3)))
    n_jax = sum(int(np.prod(a.shape)) for a in
                jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def _built(name):
    jfam = JF.get_family(name)
    jm, jaux = jfam.build(dict(MCFG), True)
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    var = jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(1)))
    tfam = TF.get_family(name)
    tm, taux = tfam.build(dict(MCFG), True, 0, "cpu")
    tm.load_state_dict(from_jax_variables(var), strict=True)
    np.testing.assert_array_equal(taux.numpy(), np.asarray(jaux))
    return jfam, jm, jaux, var, tfam, tm, taux


def _batch():
    rs = np.random.RandomState(2)
    img = rs.randn(64, 64, 3).astype(np.float32)
    gts = np.array([[2.0, 1.0, 62.0, 63.0], [10.0, 20.0, 40.0, 50.0],
                    [30.0, 5.0, 60.0, 30.0], [0.0, 0.0, 0.0, 0.0]],
                   np.float32)
    fields = (img, np.array([60.0, 62.0], np.float32), gts,
              np.array([1, 2, 3, 0]), np.array([True, True, True, False]))
    return (JFR.DetTrainBatch(*(jnp.asarray(f) for f in fields)),
            DetTrainBatch(*(torch.from_numpy(f) for f in fields)))


def _uniforms(name, key, n_anchors):
    if name == "FasterRCNN":
        return jax_uniforms(key, n_anchors, 4 + 32)
    if name == "FastRCNN":
        return torch.from_numpy(sampler_uniforms(key, 4 + 64))
    return torch.from_numpy(sampler_uniforms(key, n_anchors)[:2])


@pytest.mark.parametrize("name", DC5)
def test_dc5_family_loss_and_detections_match_jax(name):
    torch.set_num_threads(1)
    jfam, jm, jaux, var, tfam, tm, taux = _built(name)
    jb, tb = _batch()
    key = jax.random.PRNGKey(3)
    if name == "FasterRCNN":  # F6: JAX's grads run through the proposals
        _, jmet = jax.jit(lambda v: jfam.loss(jm, jaux, v, jb, key))(var)
    else:
        (_, jmet), jg = jax.jit(jax.value_and_grad(
            lambda v: jfam.loss(jm, jaux, v, jb, key), has_aux=True))(var)
    tm.zero_grad()
    total, met = tfam.loss(tm, taux, tb,
                           uniforms=_uniforms(name, key, taux.shape[0]))
    total.backward()
    assert set(met) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    if name != "FasterRCNN":
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
    sf = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
    want = jax.jit(lambda v: jfam.detect(jm, jaux, v, jb.img, jb.img_shape,
                                         jnp.asarray(sf)))(var)
    got = tfam.detect(tm, taux, tb.img, tb.img_shape, torch.from_numpy(sf))
    _same_dets(got, want)


def test_detector_model_matches_the_jax_detector_model():
    torch.set_num_threads(1)
    jfam, jm, jaux, var, tfam, tm, taux = _built("FasterRCNN")
    jdet = JI.DetectorModel("FasterRCNN", params=var, tiny=True, **MCFG)
    tdet = DetectorModel("FasterRCNN", state_dict=tm.state_dict(),
                         tiny=True, device="cpu", **MCFG)
    assert (tdet.pad_h, tdet.pad_w) == (jdet.pad_h, jdet.pad_w) == (64, 64)
    frame = np.random.RandomState(4).randint(0, 256, (48, 64, 3)).astype(
        np.float32)
    want = jdet.inference_detector(frame)
    got = tdet.inference_detector(frame)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        order_g = np.lexsort(g.T[::-1])
        order_w = np.lexsort(w.T[::-1])
        np.testing.assert_allclose(g[order_g], w[order_w], rtol=0,
                                   atol=5e-3)


@pytest.mark.parametrize("name", sorted(TF.FAMILIES))
def test_synthetic_batches_match_the_jax_cli(name):
    jfam = JF.get_family(name)
    tfam = TF.get_family(name)
    kw = dict(MCFG) if name in DC5 else dict(num_classes=4)
    model, _ = tfam.build(kw, True, 0, "cpu")

    class Cfg:  # the JAX batch reads only the bucket of the model's cfg
        cfg = getattr(model, "cfg", None)

    want = JF.make_synth_batch(Cfg, jfam, np.random.RandomState(5))
    got = TF.make_synth_batch(model, tfam, np.random.RandomState(5), "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
