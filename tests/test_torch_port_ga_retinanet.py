"""Guided-anchoring RetinaNet (``GARetinaNet`` / ``GuidedAnchoring``) in
the port against the JAX package on the CPU at the JAX CLI's ``--tiny``
sizes (128 x 128, f32, 4 classes; ``torch_port_variant_cases``): the
head's per-level outputs on P3-P7 (cls, reg, shape, loc; the two
deformable adaptions with analytic offsets through the DCN's plain
version), the four loss terms and every gradient, and the detections as
sets. ``DetectorModel`` pads it to 768 x 1280 (128 x 128 with ``tiny``)."""

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
from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
    DetectorModel,
)
from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (
    guided_anchor_head as TGA,
)


_pinned_threads = thread_count(1)


@pytest.fixture(scope="module")
def gar():
    return C.built("GARetinaNet")


def test_both_names_build_ga_retinanet():
    fam = TF.get_family("GuidedAnchoring")
    assert fam is TF.get_family("GARetinaNet")
    m, _ = fam.build(dict(C.MCFG), True, 0, "cpu")
    assert isinstance(m, TGA.GARetinaNet)
    assert TF.pad_hw(m, fam, True) == (128, 128)
    assert TF.pad_hw(m, fam, False) == TF.DENSE_PAD_HW == (768, 1280)


def test_ga_retina_head_outputs_match_jax(gar):
    jfam, jm, jaux, var, tfam, tm = gar
    jb, tb = C.batches()
    jouts = jax.jit(jm.apply)(var, jb.img[None])
    with torch.no_grad():
        outs = tm(tb.img[None])
    assert [tuple(o[0].shape[1:3]) for o in outs] == [
        (16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    for li, (o, jo) in enumerate(zip(outs, jouts)):
        for name, t, j in zip(("cls", "reg", "shape", "loc"), o, jo):
            C.close(t, j, what=f"level {li} {name}")


def test_ga_retinanet_loss_and_gradients_match_jax(gar):
    jfam, jm, jaux, var, tfam, tm = gar
    met = C.same_loss_and_grads(*gar, None, jax.random.PRNGKey(9))
    for k in ("loss_cls", "loss_bbox", "loss_shape", "loss_loc"):
        assert met[k] > 0, k
    for branch in ("cls", "reg"):
        grad = getattr(tm.bbox_head, f"feature_adaption_{branch}").weight.grad
        assert float(grad.abs().max()) > 0


def test_ga_retinanet_detections_match_jax(gar):
    C.same_detections(*gar)


def test_ga_retinanet_detector_model_on_a_frame(gar):
    """``DetectorModel`` with the bridged weights at ``tiny``: finite
    per-class rows on a 96 x 128 frame, in the frame's coordinates."""
    tm = gar[5]
    det = DetectorModel("GARetinaNet", state_dict=tm.state_dict(),
                        tiny=True, device="cpu", num_classes=4)
    frame = np.random.RandomState(4).randint(0, 256, (96, 128, 3)).astype(
        np.float32)
    res = det.inference_detector(frame)
    assert len(res) == 4
    rows = np.concatenate(res)
    assert rows.shape[1] == 5 and np.isfinite(rows).all()
    assert (rows[:, 2] <= 128 + 1e-3).all() and (rows[:, 3] <= 96 + 1e-3).all()
