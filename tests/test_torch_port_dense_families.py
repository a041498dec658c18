"""The dense one-stage families on the FPN trunk in the port against the JAX
package on the CPU at the JAX CLI's ``--tiny`` sizes (128 x 128, f32, 4
classes; ``torch_port_variant_cases``): FCOS, NAS-FCOS, ATSS and GFL here,
PAA, VFNet, FreeAnchor and PISA-RetinaNet in
``test_torch_port_dense_families_b.py``. For each: both names build where
the family has two, the head's per-level outputs on P3-P7, every loss term
and every gradient leaf, and the detections as sets. NAS-FCOS's outputs
equal FCOS's with the same weights (ROADMAP fault F25)."""

import jax
import numpy as np
import pytest
import torch
import torch_port_variant_cases as C
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.apis import (
    families as TF,
)

FAMILIES = ("FCOS", "NASFCOS", "ATSS", "GFL")
SIZES = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
SECOND_NAME = {"FreeAnchor": "FreeAnchorRetinaNet", "PISA": "PISARetinaNet"}
TERMS = {"FCOS": ("loss_cls", "loss_bbox", "loss_centerness"),
         "NASFCOS": ("loss_cls", "loss_bbox", "loss_centerness"),
         "ATSS": ("loss_cls", "loss_bbox", "loss_centerness"),
         "GFL": ("loss_qfl", "loss_dfl", "loss_giou")}


_pinned_threads = thread_count(1)


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request):
    return request.param, C.built(request.param)


def both_names_build(name):
    f = TF.get_family(name)
    names = (name, SECOND_NAME[name]) if name in SECOND_NAME else (name,)
    for n in names:
        assert TF.get_family(n) is f
    m, _ = f.build(dict(C.MCFG), True, 0, "cpu")
    assert TF.pad_hw(m, f, True) == (128, 128)
    assert TF.pad_hw(m, f, False) == TF.DENSE_PAD_HW == (768, 1280)
    return m


def head_outputs_match(built):
    jfam, jm, jaux, var, tfam, tm = built
    jb, tb = C.batches()
    jouts = jax.jit(jm.apply)(var, jb.img[None])
    with torch.no_grad():
        outs = tm(tb.img[None])
    assert [tuple(o[0].shape[1:3]) for o in outs] == SIZES
    assert len(outs) == len(jouts) == 5
    for li, (o, jo) in enumerate(zip(outs, jouts)):
        assert len(o) == len(jo)
        for i, (t, j) in enumerate(zip(o, jo)):
            C.close(t, j, what=f"level {li} output {i}")
    return outs


def loss_terms_and_gradients_match(built, key=9):
    met = C.same_loss_and_grads(*built, None, jax.random.PRNGKey(key))
    for k, v in met.items():
        assert np.isfinite(v), k
    return met


@pytest.mark.parametrize("name", FAMILIES)
def test_both_names_build(name):
    m = both_names_build(name)
    assert m.num_classes == 4


def test_head_outputs_match_jax(fam):
    head_outputs_match(fam[1])


def test_loss_terms_and_gradients_match_jax(fam):
    name, built = fam
    met = loss_terms_and_gradients_match(built)
    assert set(met) == set(TERMS[name]) | {"loss"}
    for k in TERMS[name]:
        assert met[k] > 0, k


def test_detections_match_jax(fam):
    C.same_detections(*fam[1])


def test_f25_nasfcos_is_fcos_with_the_same_weights():
    """The JAX NAS-FCOS has no searched neck or head: its parameter tree
    is FCOS's, and the same weights give the same outputs."""
    fcos = TF.get_family("FCOS").build(dict(C.MCFG), True, 3, "cpu")[0]
    nas = TF.get_family("NASFCOS").build(dict(C.MCFG), True, 0, "cpu")[0]
    assert list(nas.state_dict()) == list(fcos.state_dict())
    nas.load_state_dict(fcos.state_dict(), strict=True)
    x = torch.randn(1, 128, 128, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for a, b in zip(fcos(x), nas(x)):
            for s, t in zip(a, b):
                assert torch.equal(s, t)


def test_the_two_stage_pisa_still_raises():
    """PISA's two-stage form is a family of its own since ROADMAP Queue 1
    item 9's part 4: ``PISAFasterRCNN`` / ``PISARoIHead`` build the DC5
    Faster R-CNN (trained with PISA R-CNN's loss), not the one-stage
    PISA's RetinaNet."""
    from lowlightenvironmentvideoobjectdetection_torch.models.detectors.faster_rcnn import (  # noqa: E501
        FasterRCNN,
    )
    two = TF.get_family("PISAFasterRCNN")
    assert two is TF.get_family("PISARoIHead")
    assert two is not TF.get_family("PISA")
    model, anchors = two.build(dict(num_classes=4), True, 0, "cpu")
    assert type(model) is FasterRCNN and anchors.shape[-1] == 4
