"""Port parity for ``darkfarm_loss`` in the configurations around the
canonical one (``tests/test_torch_port_darkfarm.py``, whose tiny model,
weights, samples and tolerances these share): the clean branch, no
cleaner, the L2 and SmoothL1 feature losses and RAW input (4-channel
frames, 8-channel pairs). Each loss to rtol 1e-5 of the JAX loss with
``stop_gradient`` on the proposals; each gradient leaf to an atol of 1e-4
of its largest |g|, at least 1e-6 of the largest of any leaf. A file of
its own so that each of the two runs in about a minute and a half.
"""

import pytest

from test_torch_port_darkfarm import (  # noqa: F401 (a fixture)
    CASES,
    _case,
    _check_loss_and_grads,
    base,
)
from torch_port_threads import thread_count


_pinned_threads = thread_count(1)


@pytest.mark.parametrize("name", ["clean_branch", "no_cleaner", "l2",
                                  "smooth_l1", "raw"])
def test_darkfarm_variants_match_jax(base, name):  # noqa: F811
    case = _case(base, name)
    metrics, _ = _check_loss_and_grads(case, base)
    kw, branch, _ = CASES[name]
    stages = set(metrics) - {"loss", "loss_rpn_cls", "loss_rpn_bbox",
                             "loss_cls", "loss_bbox", "acc"}
    if branch == "clean" or not kw.get("with_cleaner", True):
        assert not stages
    else:
        loss_type = case["jmodel"].cfg.loss_type
        assert stages == {f"loss_{loss_type}_{i}" for i in range(4)}
