"""Point sampling, the counterpart of the JAX package's
``ops/point_sample.py`` ``point_sample`` (mmcv's ``point_sample``, which
PointRend's point head reads its fine features with): bilinear samples of
a map at normalised points, on ``ops/grid_sample.py`` (``F.grid_sample``
with the JAX ``grid_sample``'s conventions: ``align_corners=False``, zero
padding). No kernel: one ``F.grid_sample`` call.
"""

from __future__ import annotations

import torch

from .grid_sample import grid_sample


def point_sample(feat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """feat [H, W, C]; points [..., P, 2] normalised (x, y) in [0, 1] ->
    [..., P, C] float32."""
    return grid_sample(feat, points * 2.0 - 1.0)
