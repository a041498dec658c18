"""The test CLI's image route in the port against the root JAX
``tools/test.py`` for the four DC5 mask configs that
``test_torch_port_mask_cli.py`` leaves (``ms_rcnn``, ``point_rend``,
``htc`` and ``scnet`` ``_r50_dc5_1x_coco.py``), on its seeded COCO tree
and weights: the same per-image per-class rows (boxes to 5e-3, scores to
1e-5, as sets), the same mAP50 and image count, every image, 80 lists of
finite rows. A file of its own, so that the two CLI files run on two
workers."""

import pytest
from test_torch_port_mask_cli import (  # noqa: F401  (fixtures)
    CFGS,
    JAX_CLI,
    _drop_checkpoints,
    same_as_the_jax_cli,
    tree,
)
from torch_port_threads import thread_count

_pinned_threads = thread_count(1)


@pytest.mark.parametrize("name", sorted(set(CFGS) - set(JAX_CLI)))
def test_test_cli_matches_the_jax_cli(tree, name, tmp_path):  # noqa: F811
    same_as_the_jax_cli(tree, name, tmp_path)
