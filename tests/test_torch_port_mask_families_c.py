"""HTC (both names) and SCNet in the port against the JAX package on the
CPU, as ``test_torch_port_mask_families.py`` holds Mask R-CNN
(``torch_port_mask_cases.py``): every loss term (the semantic loss, each
stage's box and mask losses) to 1e-5 relative and every gradient leaf to
1e-4 of its largest value, on the JAX key's uniforms (``split(key, 5)``:
the RPN's, one RoI sampler's a stage); the detections as sets and each
matched detection's mask probabilities [28, 28, C] (the three stages'
sigmoids averaged, not pasted, as in JAX) to 1e-5 of their largest
value."""

import pytest
from torch_port_mask_cases import (
    case,
    detections_and_masks_match,
    jax_detect,
    loss_and_grads_match_jax,
)
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.apis import (
    families as TF,
)
from lowlightenvironmentvideoobjectdetection_torch.models.detectors import (
    htc as htc_mod,
)
from lowlightenvironmentvideoobjectdetection_tpu.apis import (
    families as JF,
)

_pinned_threads = thread_count(1)


@pytest.mark.parametrize("fam", ["HTC", "SCNet"])
def test_loss_and_grads_match_jax(fam):
    loss_and_grads_match_jax(fam, "loss_semantic")


@pytest.mark.parametrize("fam", ["HTC", "SCNet"])
def test_detections_and_masks_match_jax(fam):
    detections_and_masks_match(fam, jax_detect(fam), exact=False)


def test_both_htc_names_are_one_family():
    assert TF.get_family("HybridTaskCascade") is TF.get_family("HTC")
    assert {"HTC", "HybridTaskCascade", "SCNet"} <= set(JF.FAMILIES)
    m = case("HTC")["tm"]
    assert isinstance(m.semantic_head, htc_mod.SemanticHead)
    assert not m.with_global_context
    assert case("SCNet")["tm"].with_global_context
