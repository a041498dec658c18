"""PAA, VFNet, FreeAnchor and PISA-RetinaNet in the port against the JAX
package on the CPU at the JAX CLI's ``--tiny`` sizes (128 x 128, f32, 4
classes), as ``test_torch_port_dense_families.py`` holds FCOS, NAS-FCOS,
ATSS and GFL: both names build where the family has two, the head's
per-level outputs on P3-P7, every loss term and every gradient leaf, and
the detections as sets. VFNet's two star DCNs a level run the DCN's plain
version here; their offsets' gradient reaches the initial distances.

Seeds and gts: the weights come from seed 5 (``C.built``'s default) save
for VFNet and PAA, whose come from seed 6. At seed 5 a ReLU of VFNet's
``cls_dconv`` output sits within rounding of its kink (the DCN's bias
gradient moves by 6e-4 of its largest value; seeds 6, 7 and 8 agree), and
so does one of PAA's (10 leaves). PAA's second gt is 70 x 70 px, not the
shared 30 x 30: a 30 x 30 gt has candidates on P3 alone, 4 of them with
costs within 0.007 of each other, and there the EM of ``_gmm_pos_split``
(variances clamped at 1e-4) splits them by rounding: JAX's own split
flips between the JAX and the port's outputs, which differ by 1e-6
(``test_torch_port_dense_head_parts.py`` holds the split itself to JAX's
on equal inputs, overlapping scores included)."""

import jax
import numpy as np
import pytest
import torch
import torch_port_variant_cases as C
from test_torch_port_dense_families import (
    both_names_build,
    head_outputs_match,
    loss_terms_and_gradients_match,
)
from torch_port_threads import thread_count

FAMILIES = ("PAA", "VFNet", "FreeAnchor", "PISA")
TERMS = {"PAA": ("loss_cls", "loss_bbox", "loss_iou"),
         "VFNet": ("loss_cls", "loss_bbox", "loss_bbox_refine"),
         "FreeAnchor": ("positive_bag_loss", "negative_bag_loss"),
         "PISA": ("loss_cls", "loss_bbox", "loss_carl")}


SEED = {"VFNet": 6, "PAA": 6}
GTS = {"PAA": np.array([[10.0, 12.0, 90.0, 100.0], [40.0, 30.0, 110.0, 100.0],
                        [5.0, 60.0, 50.0, 120.0], [0.0, 0.0, 0.0, 0.0]],
                       np.float32)}


_pinned_threads = thread_count(1)


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request):
    name = request.param
    return name, C.built(name, SEED.get(name, 5))


@pytest.mark.parametrize("name", FAMILIES)
def test_both_names_build(name):
    m = both_names_build(name)
    assert m.num_classes == 4


def test_head_outputs_match_jax(fam):
    head_outputs_match(fam[1])


def test_loss_terms_and_gradients_match_jax(fam, monkeypatch):
    name, built = fam
    if name in GTS:
        monkeypatch.setattr(C, "GTS", GTS[name])
    met = loss_terms_and_gradients_match(built)
    assert set(met) == set(TERMS[name]) | {"loss"}
    for k in TERMS[name]:
        assert met[k] > 0, k
    if name == "VFNet":  # the star offsets carry a gradient into vfnet_reg
        head = built[5].bbox_head
        for mod in ("reg_refine_dconv", "cls_dconv", "vfnet_reg"):
            assert float(getattr(head, mod).weight.grad.abs().max()) > 0, mod


def test_detections_match_jax(fam):
    C.same_detections(*fam[1])
