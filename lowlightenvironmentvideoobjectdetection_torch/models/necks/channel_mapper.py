"""ChannelMapper neck: a k x k conv to a common width, the counterpart of the
JAX package's ``models/necks/channel_mapper.py`` at one level (the DC5
detectors have one)."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..backbones.resnet import Conv2d


class ChannelMapper(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = 512,
                 kernel_size: int = 3, dtype=torch.float32):
        super().__init__()
        # named as the JAX module's level-0 conv, for the weight bridge
        self.conv0 = Conv2d(in_channels, out_channels, kernel_size,
                            padding=kernel_size // 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW map -> NCHW map."""
        return self.conv0(x)
