"""Feature Pyramid Network neck, the counterpart of the JAX package's
``models/necks/fpn.py`` (mmdet's ``necks/fpn.py``): 1x1 lateral convs, the
top-down path (each coarser lateral upsampled by nearest neighbour and
added), 3x3 output convs, then extra levels: a 1x1 max pool at stride 2
(``add_extra_convs="maxpool"``, Faster R-CNN's), or 3x3 stride-2 convs on
the last input (``"on_input"``, RetinaNet's, from C5) or on the last output
(``"on_output"``), with a ReLU before each but the first when
``relu_before_extra_convs``.

The upsampling is ``nearest-exact`` (half-pixel centres), as
``jax.image.resize(..., "nearest")``; mmdet's ``F.interpolate(mode=
"nearest")`` agrees only where a level is exactly twice the next (ROADMAP
fault F20). Module names are the flax names (``lateral{i}``,
``fpn_conv{i}``, ``extra_conv{k}``), for the weight bridge.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..backbones.resnet import Conv2d

EXTRA_MODES = ("maxpool", "on_input", "on_output")


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, add_extra_convs: str = "on_output",
                 relu_before_extra_convs: bool = False,
                 dtype=torch.float32):
        super().__init__()
        if add_extra_convs not in EXTRA_MODES:
            raise ValueError(f"add_extra_convs {add_extra_convs!r}: one of "
                             f"{EXTRA_MODES}")
        self.num_ins, self.num_outs = len(in_channels), num_outs
        self.add_extra_convs = add_extra_convs
        self.relu_before_extra_convs = relu_before_extra_convs
        self.compute_dtype = dtype
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", Conv2d(c, out_channels, 1,
                                                  dtype=dtype))
            self.add_module(f"fpn_conv{i}", Conv2d(
                out_channels, out_channels, 3, padding=1, dtype=dtype))
        if add_extra_convs != "maxpool":
            for k in range(num_outs - self.num_ins):
                src = (in_channels[-1] if add_extra_convs == "on_input"
                       and k == 0 else out_channels)
                self.add_module(f"extra_conv{k}", Conv2d(
                    src, out_channels, 3, stride=2, padding=1, dtype=dtype))

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        """inputs: NCHW maps, the finest first -> ``num_outs`` NCHW maps in
        the compute dtype."""
        laterals = [getattr(self, f"lateral{i}")(x)
                    for i, x in enumerate(inputs)]
        for i in range(self.num_ins - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=laterals[i - 1].shape[-2:],
                mode="nearest-exact")
        outs = [getattr(self, f"fpn_conv{i}")(x)
                for i, x in enumerate(laterals)]
        extra = self.num_outs - self.num_ins
        if extra > 0 and self.add_extra_convs == "maxpool":
            for _ in range(extra):
                outs.append(outs[-1][..., ::2, ::2])
        elif extra > 0:
            src = (inputs[-1].to(self.compute_dtype)
                   if self.add_extra_convs == "on_input" else outs[-1])
            for k in range(extra):
                if k > 0 and self.relu_before_extra_convs:
                    src = F.relu(src)
                src = getattr(self, f"extra_conv{k}")(src)
                outs.append(src)
        return tuple(outs)
