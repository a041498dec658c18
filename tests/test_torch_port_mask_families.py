"""Mask R-CNN and YOLACT in the port against the JAX package on the CPU
(Mask Scoring R-CNN and PointRend in ``..._b.py``, HTC and SCNet in
``..._c.py``; shared cases ``torch_port_mask_cases.py``) at the JAX CLI's
``--tiny`` sizes (the DC5 families: ``torch_port_rcnn_cases.py``, 64 x
64, f32, 4 classes, a 32-channel neck, JAX's proposals stopped; YOLACT:
``torch_port_variant_cases.py``, 128 x 128), weights drawn in the JAX
shapes and bridged by ``from_jax_variables`` (the mask heads' transposed
convs flipped), box-filled masks as both family tables make them:

- every loss term to 1e-5 relative and every gradient leaf to 1e-4 of its
  largest value;
- the module detect paths: the detections as sets (boxes to 5e-3 px,
  scores to 1e-5) and each matched detection's mask (pasted: equal pixel
  sets; YOLACT's cropped prototype masks to 1e-5); the family's detect
  gives the same detections without the masks;
- ROADMAP F34: the test path's mask rois are the detections divided by
  the scale factor, read on the padded image's map, on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_rcnn_cases as C
import torch_port_variant_cases as V
from torch_port_mask_cases import (
    SF,
    case,
    detections_and_masks_match,
    jax_detect,
    loss_and_grads_match_jax,
    matched_rows,
)
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (
    yolact_head as TY,
)
from lowlightenvironmentvideoobjectdetection_torch.models.roi_heads import (
    mask_head as TMH,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.dense_heads import (
    yolact_head as JY,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.detectors import (
    mask_rcnn as JMK,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.roi_heads import (
    mask_head as JMH,
)

_pinned_threads = thread_count(1)


def test_mask_rcnn_loss_and_grads_match_jax():
    loss_and_grads_match_jax("MaskRCNN", "loss_mask")


def _rebuilt_masks(jm, var, dets):
    """JAX's masks rebuilt from its parts at the divided detections."""
    jb = case("MaskRCNN")["jb"]
    _, neck = jm.apply(var, jb.img[None], method=JMK.MaskRCNN.extract_feat)
    binds = jnp.zeros((dets.boxes.shape[0],), jnp.int32)
    logits = jm.apply(var, jm.apply(var, neck[0], dets.boxes, binds,
                                    method=JMK.MaskRCNN.mask_roi_feats),
                      method=JMK.MaskRCNN.mask_forward)
    probs = jax.nn.sigmoid(jnp.take_along_axis(
        logits, jnp.clip(dets.labels, 0, 3)[:, None, None, None],
        axis=-1)[..., 0])
    return JMH.paste_masks(probs, dets.boxes, C.HW, C.HW)


@pytest.fixture(scope="module")
def mask_rcnn_dets():
    return jax_detect("MaskRCNN", _rebuilt_masks)


def test_mask_rcnn_detections_and_masks_match_jax(mask_rcnn_dets):
    detections_and_masks_match("MaskRCNN", mask_rcnn_dets)


def test_f34_mask_rois_are_the_rescaled_detections(mask_rcnn_dets):
    """ROADMAP F34: JAX's ``mask_rcnn_detect`` reads the mask features at
    the detections after ``scale_factor`` has divided them (the original
    image's coordinates) on the padded image's map, and pastes them there;
    mmdet multiplies them back first. Rebuilt here from JAX's own parts;
    the port's masks equal JAX's (the test above)."""
    dets, masks, rebuilt = mask_rcnn_dets
    np.testing.assert_array_equal(np.asarray(masks), np.asarray(rebuilt))
    valid = np.asarray(dets.valid)
    assert np.asarray(dets.boxes)[valid].max() > C.HW  # past the 64 px map


@pytest.fixture(scope="module")
def yolact():
    return V.built("YOLACT")


def test_yolact_loss_and_grads_match_jax(yolact):
    got = V.same_loss_and_grads(*yolact, None, jax.random.PRNGKey(0))
    assert set(got) == {"loss", "loss_cls", "loss_bbox", "loss_mask",
                        "loss_segm"}
    assert all(v > 0 for v in got.values())


def test_yolact_detections_and_masks_match_jax(yolact):
    jfam, jm, _, var, tfam, tm = yolact
    jb, tb = V.batches()

    def jdetect(v):
        level_outs, protos, _ = jm.apply(v, jb.img[None])
        flat = [(a[0], b[0], k[0]) for a, b, k in level_outs]
        return JY.yolact_detect(flat, protos, jb.img_shape, 4,
                                scale_factor=jnp.asarray(SF))

    jd, jmasks = jax.jit(jdetect)(var)
    td, tmasks = TY.yolact_model_detect(tm, tb.img, tb.img_shape,
                                        scale_factor=torch.from_numpy(SF))
    pairs = matched_rows(td, jd)
    assert tmasks.shape == np.asarray(jmasks).shape == (100, 32, 32)
    for i, j in pairs:
        V.close(tmasks[i], np.asarray(jmasks)[j], tol=1e-5)
    api = tfam.detect(tm, None, tb.img, tb.img_shape, torch.from_numpy(SF))
    for a, b in zip(api, td):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_the_mask_families_build_and_pad_like_jax():
    m, _ = C.TF.get_family("MaskRCNN").build(dict(C.MCFG), True, 0, "cpu")
    assert C.TF.pad_hw(m, C.TF.get_family("MaskRCNN"), True) == (64, 64)
    assert isinstance(m.mask_head, TMH.FCNMaskHead)
    assert isinstance(m.mask_head.upsample, torch.nn.ConvTranspose2d)
    fam = C.TF.get_family("YOLACT")
    m, aux = fam.build(dict(num_classes=4), True, 0, "cpu")
    assert aux is None and m.compute_dtype == torch.float32
    assert C.TF.pad_hw(m, fam, False) == (768, 1280)
    assert C.TF.pad_hw(m, fam, True) == (128, 128)
