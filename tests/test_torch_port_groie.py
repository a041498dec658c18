"""GRoIE Faster R-CNN (``GRoIEFasterRCNN`` / ``GenericRoIExtractor``) in
the port against the JAX package on the CPU at the JAX CLI's ``--tiny``
sizes (``torch_port_variant_cases``): the extractor's features of the
test proposals (every roi pooled on each of P2-P5, the shared 5x5
``pre_module``, the sum, ``GeneralizedAttention``), the loss terms and
every gradient with the JAX draws replayed and JAX's proposals stopped
(ROADMAP fault F6), and the detections as sets. RoIAlign runs once a
level per call: four calls for any set of rois."""

import jax
import numpy as np
import pytest
import torch
import torch_port_variant_cases as C
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.apis import (
    families as TF,
)
from lowlightenvironmentvideoobjectdetection_torch.models.detectors import (
    fpn_faster_rcnn as TFF,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.detectors import (
    fpn_faster_rcnn as JFF,
)


_pinned_threads = thread_count(1)


@pytest.fixture(scope="module")
def groie():
    return C.built("GRoIEFasterRCNN")


def test_both_names_build_groie():
    fam = TF.get_family("GenericRoIExtractor")
    assert fam is TF.get_family("GRoIEFasterRCNN")
    m, _ = fam.build(dict(C.MCFG), True, 0, "cpu")
    assert (m.rpn_type, m.roi_extract, m.with_bfp) == ("rpn", "groie", False)
    assert isinstance(m.roi_extractor, TFF.GenericRoIExtractor)


def test_groie_roi_features_match_jax(groie, monkeypatch):
    jfam, jm, jaux, var, tfam, tm = groie
    jb, tb = C.batches()
    jfeats = C.jax_method(jm, var, JFF.FPNFasterRCNN.extract_feat)(
        jb.img[None])
    jouts = C.jax_method(jm, var, JFF.FPNFasterRCNN.rpn_forward)(jfeats)
    props = JFF._fpn_proposals(jm, jouts, jb.img_shape, jaux, False)
    want = C.jax_method(jm, var, JFF.FPNFasterRCNN.roi_feats)(
        [f[0] for f in jfeats], props.boxes)
    calls, real = [], TFF.roi_align
    monkeypatch.setattr(TFF, "roi_align", lambda f, r, *a, **kw: calls.append(
        r.shape[0]) or real(f, r, *a, **kw))
    with torch.no_grad():
        feats = tm.extract_feat(tb.img[None])
        got = tm.roi_feats(feats, torch.from_numpy(np.array(props.boxes)))
    C.close(got, want)
    assert calls == [TF.FPN_TINY_KW["test_nms_post"]] * 4


def test_groie_loss_and_gradients_match_jax(groie, monkeypatch):
    jfam, jm, jaux, var, tfam, tm = groie
    C.stopped_proposals(monkeypatch)
    key = jax.random.PRNGKey(9)
    n_anchors = sum(int(a.shape[0]) for a in jaux)
    met = C.same_loss_and_grads(jfam, jm, jaux, var, tfam, tm,
                                C.fpn_uniforms(key, n_anchors, "random"),
                                key)
    assert met["loss_bbox"] > 0
    grad = tm.roi_extractor.post_module.appr_geom_fc_x.weight.grad
    assert float(grad.abs().max()) > 0


def test_groie_detections_match_jax(groie):
    C.same_detections(*groie)
