"""Libra R-CNN (``LibraFasterRCNN`` / ``LibraRCNN``: FPN Faster R-CNN with
the BFP neck, the IoU-balanced sampler and the balanced L1 loss) in the
port against the JAX package on the CPU at the JAX CLI's ``--tiny`` sizes
(``torch_port_variant_cases``): the balanced pyramid's five levels, the
loss terms and every gradient with the JAX draws replayed (the RoI
sampler's four rows) and JAX's proposals stopped (ROADMAP fault F6), and
the detections as sets. The weights are drawn from seed 6: at seed 5
one ReLU pre-activation lies within f32 rounding of its kink and sends a
position's gradient another way on each side (most backbone leaves then
differ by ~5e-4 of their largest value). ``bfp.refine.phi.bias``'s
gradient is 0 in exact arithmetic (the softmax ignores a per-query
constant), so only the floor relative to the largest leaf holds it."""

import jax
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
from lowlightenvironmentvideoobjectdetection_torch.models.necks import (
    extra_necks as TN,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.detectors import (
    fpn_faster_rcnn as JFF,
)


_pinned_threads = thread_count(1)


@pytest.fixture(scope="module")
def libra():
    return C.built("LibraFasterRCNN", seed=6)


def test_both_names_build_libra():
    fam = TF.get_family("LibraRCNN")
    assert fam is TF.get_family("LibraFasterRCNN")
    m, _ = fam.build(dict(C.MCFG), True, 0, "cpu")
    assert (m.rpn_type, m.roi_extract, m.with_bfp) == ("rpn", "single", True)
    assert isinstance(m.bfp, TN.BFP)


def test_libra_balanced_pyramid_matches_jax(libra):
    jfam, jm, jaux, var, tfam, tm = libra
    jb, tb = C.batches()
    want = C.jax_method(jm, var, JFF.FPNFasterRCNN.extract_feat)(
        jb.img[None])
    with torch.no_grad():
        got = tm.extract_feat(tb.img[None])
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32
        C.close(g, w, what=f"level {i}")


def test_libra_loss_and_gradients_match_jax(libra, monkeypatch):
    jfam, jm, jaux, var, tfam, tm = libra
    C.stopped_proposals(monkeypatch)
    key = jax.random.PRNGKey(9)
    n_anchors = sum(int(a.shape[0]) for a in jaux)
    u = C.fpn_uniforms(key, n_anchors, "iou_balanced")
    assert u.roi.shape[0] == TFF.SAMPLER_ROWS["iou_balanced"] == 4
    met = C.same_loss_and_grads(jfam, jm, jaux, var, tfam, tm, u, key)
    assert met["loss_bbox"] > 0
    assert float(tm.bfp.refine.theta.weight.grad.abs().max()) > 0


def test_libra_detections_match_jax(libra):
    C.same_detections(*libra)
