"""GA Faster R-CNN (``GAFasterRCNN`` / ``GARPNHead``: FPN Faster R-CNN
with the GA-RPN head) in the port against the JAX package on the CPU at
the JAX CLI's ``--tiny`` sizes (``torch_port_variant_cases``): the head's
per-level outputs (cls, reg, shape, loc; the deformable feature adaption
through the DCN's plain version), the proposals, the loss terms (the
GA-RPN's four and the RoI head's two) and every gradient with the JAX
draws replayed and JAX's proposals stopped (ROADMAP fault F6), and the
detections as sets. Both family names build the same model."""

import jax
import jax.numpy as jnp
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
def ga():
    return C.built("GAFasterRCNN")


def test_both_names_build_ga_rpn():
    assert TF.get_family("GARPNHead") is TF.get_family("GAFasterRCNN")
    m, _ = TF.get_family("GARPNHead").build(dict(C.MCFG), True, 0, "cpu")
    assert (m.rpn_type, m.roi_extract, m.with_bfp) == ("ga", "single", False)
    assert isinstance(m.rpn_head, TFF.GARPNHead)


def test_ga_rpn_outputs_and_proposals_match_jax(ga):
    jfam, jm, jaux, var, tfam, tm = ga
    jb, tb = C.batches()
    jfeats = C.jax_method(jm, var, JFF.FPNFasterRCNN.extract_feat)(
        jb.img[None])
    jouts = C.jax_method(jm, var, JFF.FPNFasterRCNN.rpn_forward)(jfeats)
    with torch.no_grad():
        feats = tm.extract_feat(tb.img[None])
        outs = tm.rpn_forward(feats)
    assert len(outs) == len(jouts) == 5
    for li, (o, jo) in enumerate(zip(outs, jouts)):
        for name, t, j in zip(("cls", "reg", "shape", "loc"), o, jo):
            C.close(t, j, what=f"level {li} {name}")
    for train in (False, True):
        want = JFF._fpn_proposals(jm, jouts, jb.img_shape, jaux, train)
        got = TFF._proposals(tm, outs, None, tb.img_shape, train)
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(got.scores.numpy(),
                                   np.asarray(want.scores), rtol=0, atol=1e-6)
        assert int(got.valid.sum()) > 0


def test_ga_faster_rcnn_loss_and_gradients_match_jax(ga, monkeypatch):
    jfam, jm, jaux, var, tfam, tm = ga
    C.stopped_proposals(monkeypatch)
    key = jax.random.PRNGKey(9)
    n_cells = sum((-(-C.HW // s)) ** 2 for s in TFF.FPN_STRIDES)
    met = C.same_loss_and_grads(jfam, jm, jaux, var, tfam, tm,
                                C.fpn_uniforms(key, n_cells, "random"), key)
    for k in ("loss_anchor_shape", "loss_anchor_loc", "loss_rpn_bbox",
              "loss_bbox"):
        assert met[k] > 0, k
    # the deformable adaption's offset conv learns through the DCN
    assert float(tm.rpn_head.offset_conv.weight.grad.abs().max()) > 0


def test_ga_faster_rcnn_detections_match_jax(ga):
    C.same_detections(*ga)
