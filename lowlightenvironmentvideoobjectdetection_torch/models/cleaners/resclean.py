"""The frozen clean-branch teacher, the counterpart of the JAX package's
``models/cleaners/resclean.py`` (``ResCleaner``): a plain R50-DC5 on the
clean half of each (noise, clean) pair, whose stage features supervise the
detector's backbone.

The teacher takes no gradient: its forward runs under ``torch.no_grad``
(where JAX stops the gradient of its outputs), so it keeps no activations,
and the optimizer's mask (``parallel/train.py``, prefix ``cleaner``) leaves
its parameters as they are.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ..backbones.resnet import ResNet


class ResCleaner(nn.Module):
    """Plain ResNet on clean frames [T, H, W, Cin] (Cin 3, or 4 for RAW);
    returns the stages of ``out_indices`` (the detector's loss stages),
    NCHW, without gradient."""

    def __init__(self, depth: int = 50, in_channels: int = 3,
                 out_indices: Sequence[int] = (3,), dtype=torch.bfloat16):
        super().__init__()
        # named as the flax submodule, for the weight bridge
        self.resnet = ResNet(depth=depth, in_channels=in_channels,
                             strides=(1, 2, 2, 1), dilations=(1, 1, 1, 2),
                             out_indices=out_indices, frozen_stages=-1,
                             dtype=dtype)

    @torch.no_grad()
    def forward(self, clean_imgs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.resnet(clean_imgs.permute(0, 3, 1, 2))
