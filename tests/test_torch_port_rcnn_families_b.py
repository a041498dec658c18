"""PISA, Grid and Trident Faster R-CNN in the port against the JAX package
on the CPU (``torch_port_rcnn_cases.py``: the JAX CLI's ``--tiny`` sizes,
f32, 4 classes, a 32-channel neck, bridged variables, the JAX samplers'
uniforms, JAX's proposals stopped):

- Grid R-CNN's and TridentNet's forward (the flax ``__call__``: the RPN,
  the head on fixed rois, Grid's heatmaps from 14x14 RoIAlign, Trident's
  three branches) to 1e-4 of the largest value;
- each family's loss terms to 1e-5 relative and every gradient leaf to
  1e-4 of its largest value, through every name of the family (PISA's
  two); the detections as sets (Trident's from the middle branch alone);
- ROADMAP F32: the JAX TridentResNet is a C4 trunk (its stage 4 built but
  unread: zero gradient) and three trident blocks of planes 512 after it,
  whose branches differ only by the 3x3's dilation (1, 2, 3).
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
from lowlightenvironmentvideoobjectdetection_torch.models.detectors.faster_rcnn import (  # noqa: E501
    _zeros,
)
from lowlightenvironmentvideoobjectdetection_tpu.apis import (
    families as JF,
)

NAMES = {"PISAFasterRCNN": ("PISAFasterRCNN", "PISARoIHead"),
         "GridRCNN": ("GridRCNN",),
         "TridentFasterRCNN": ("TridentFasterRCNN",)}
ALL = [(fam, n) for fam, names in NAMES.items() for n in names]
KEY = jax.random.PRNGKey(3)
ROIS = np.array([[0.0, 0.0, 32.0, 32.0]] * 4, np.float32)
_CASES = {}
_pinned_threads = thread_count(1)


def case(fam):
    if fam not in _CASES:
        jfam, jm, jaux, var, tfam, tm, taux = built(fam)
        jb, tb = batches()
        met, grads = jax_loss_and_grads(jfam, jm, jaux, var, KEY, jb)
        dets = jax_detections(jfam, jm, jaux, var, jb)
        _CASES[fam] = dict(jm=jm, var=var, tm=tm, taux=taux, jb=jb, tb=tb,
                           met=met, grads=grads, dets=dets)
    return _CASES[fam]


@pytest.mark.parametrize("fam", ["GridRCNN", "TridentFasterRCNN"])
def test_forward_matches_jax(fam):
    c = case(fam)
    tm, img = c["tm"], c["tb"].img[None]
    want = jax.jit(lambda v: c["jm"].apply(v, jnp.asarray(img.numpy())))(
        c["var"])
    rois = torch.from_numpy(ROIS)
    with torch.no_grad():
        if fam == "GridRCNN":
            base = tm.base
            feat = base.extract_feat(img)
            cls, reg = base.rpn_forward(feat)
            out = base.bbox_forward(base.roi_feats(feat, rois, _zeros(rois)))
            grids = tm.grid_head(tm.roi_feats14(feat, rois))
            close(grids, want[3], what="grid heatmaps")
        else:
            feat = tm.extract_feat(img)
            assert feat.shape[0] == 3
            cls, reg = tm.rpn_head(feat)
            out = tm.bbox_head(tm.roi_feats(feat[:1], rois))
        close(cls, want[0], what="rpn cls")
        close(reg, want[1], what="rpn reg")
        for g, w in zip(out, want[2]):
            close(g, w, what="bbox head")


@pytest.mark.parametrize("fam,name", ALL)
def test_loss_and_grads_match_jax(fam, name):
    c = case(fam)
    assert JF.FAMILIES[name] is JF.FAMILIES[fam]
    met = same_loss_and_grads(c["met"], c["grads"], TF.get_family(name),
                              c["tm"], c["taux"], c["tb"],
                              uniforms(fam, KEY, c["taux"].shape[0]))
    assert all(np.isfinite(v) for v in met.values())


@pytest.mark.parametrize("fam,name", ALL)
def test_detections_match_jax(fam, name):
    c = case(fam)
    same_detections(c["dets"], TF.get_family(name), c["tm"], c["taux"],
                    c["tb"])


def test_trident_backbone_is_a_c4_trunk_and_three_shared_blocks():
    """F32 on the JAX side, and the port's modules in its shapes."""
    c = case("TridentFasterRCNN")
    p = c["var"]["params"]["backbone"]
    assert sorted(k for k in p if k.startswith("trident_")) == [
        "trident_0", "trident_1", "trident_2"]
    assert p["trident_0"]["conv2_kernel"].shape == (3, 3, 512, 512)
    assert p["trident_0"]["ds_kernel"].shape == (1, 1, 1024, 2048)
    assert "ds_kernel" not in p["trident_1"]
    assert "layer4_0" in p["trunk"]  # built, not read
    g = c["grads"]
    assert float(g["backbone.trunk.layer4_0.conv1.weight"].abs().max()) == 0
    assert float(g["backbone.trunk.layer3_0.conv1.weight"].abs().max()) > 0
    tm, img = c["tm"], c["tb"].img[None]
    with torch.no_grad():
        three = tm.backbone(img.permute(0, 3, 1, 2))
        mid = tm.backbone(img.permute(0, 3, 1, 2), branches=(1,))
    assert three.shape[0] == 3
    assert not torch.equal(three[0], three[1])
    torch.testing.assert_close(mid[0], three[1], rtol=0, atol=1e-5)
