"""Mask Scoring R-CNN and PointRend in the port against the JAX package on
the CPU, as ``test_torch_port_mask_families.py`` holds Mask R-CNN
(``torch_port_mask_cases.py``: the JAX CLI's ``--tiny`` sizes, f32, 4
classes, a 32-channel neck, bridged weights, box-filled masks): every
loss term to 1e-5 relative and every gradient leaf to 1e-4 of its largest
value (both JAX losses run Mask R-CNN's loss, then the trunk, the RPN and
the sampler again with the same key; the port's forward runs once: the
same numbers), the detections as sets and each matched detection's
pasted mask as an equal pixel set (Mask Scoring R-CNN: the scores times
the clipped predicted IoU; PointRend: the masks refined at the 49 most
uncertain cells)."""

import pytest
from torch_port_mask_cases import (
    detections_and_masks_match,
    jax_detect,
    loss_and_grads_match_jax,
)
from torch_port_threads import thread_count

TERMS = {"MaskScoringRCNN": "loss_mask_iou", "PointRend": "loss_point"}

_pinned_threads = thread_count(1)


@pytest.mark.parametrize("fam", sorted(TERMS))
def test_loss_and_grads_match_jax(fam):
    loss_and_grads_match_jax(fam, TERMS[fam])


@pytest.mark.parametrize("fam", sorted(TERMS))
def test_detections_and_masks_match_jax(fam):
    detections_and_masks_match(fam, jax_detect(fam))
