"""TridentNet's backbone, the counterpart of ``TridentBottleneck`` and
``TridentResNet`` in the JAX package's
``models/backbones/detectors_trident.py`` (its ``SAConv``, ``RFP`` and
``DetectoRSResNet`` are not ported: ROADMAP Queue 1 item 9, part 7).

As the JAX module builds it (ROADMAP F32): an R-50 trunk to C4 (stride
16, stage 1 frozen), then three trident blocks (planes 512) whose weights
are shared by three branches at dilations 1, 2 and 3; the branches are
stacked on a leading axis. mmdet's TridentNet instead makes res4 itself
trident and runs a res5 head in the RoI head. ``forward(x, branches)``
computes only the branches named: the test path asks for the middle one
(``test_branch_idx`` 1), whose numbers do not depend on the others.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import FrozenBatchNorm, ResNet

DILATIONS = (1, 2, 3)
TEST_BRANCH = 1


class TridentBottleneck(nn.Module):
    """A bottleneck whose raw kernels (``conv{1,2,3}_kernel``,
    ``ds_kernel``; OIHW) serve every branch, the 3x3 at the branch's
    dilation; NCHW."""

    def __init__(self, inplanes: int, planes: int, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.conv1_kernel = nn.Parameter(torch.empty(planes, inplanes, 1, 1))
        self.conv2_kernel = nn.Parameter(torch.empty(planes, planes, 3, 3))
        self.conv3_kernel = nn.Parameter(torch.empty(planes * 4, planes,
                                                     1, 1))
        self.bn1 = FrozenBatchNorm(planes, dtype=dtype)
        self.bn2 = FrozenBatchNorm(planes, dtype=dtype)
        self.bn3 = FrozenBatchNorm(planes * 4, dtype=dtype)
        self.needs_ds = inplanes != planes * 4
        if self.needs_ds:
            self.ds_kernel = nn.Parameter(torch.empty(planes * 4, inplanes,
                                                      1, 1))
            self.downsample_bn = FrozenBatchNorm(planes * 4, dtype=dtype)

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        """flax's ``he_normal``: truncated normal, variance 2 / fan_in."""
        for name in ("conv1_kernel", "conv2_kernel", "conv3_kernel",
                     "ds_kernel"):
            w = getattr(self, name, None)
            if w is not None:
                std = (2.0 / w[0].numel()) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)

    def forward(self, xs: Sequence[torch.Tensor],
                dilations: Sequence[int]):
        dt = self.compute_dtype
        w1, w2, w3 = (getattr(self, f"conv{i}_kernel").to(dt)
                      for i in (1, 2, 3))
        outs = []
        for x, dil in zip(xs, dilations):
            x = x.to(dt)
            o = F.relu(self.bn1(F.conv2d(x, w1)))
            o = F.relu(self.bn2(F.conv2d(o, w2, padding=dil, dilation=dil)))
            o = self.bn3(F.conv2d(o, w3))
            idt = (self.downsample_bn(F.conv2d(x, self.ds_kernel.to(dt)))
                   if self.needs_ds else x)
            outs.append(F.relu(o + idt))
        return outs


class TridentResNet(nn.Module):
    """``trunk`` (R-50 to C4) and ``trident_{0,1,2}``; NCHW in, the chosen
    branches' outputs [B, N, 2048, h, w] out (B = 3 by default)."""

    def __init__(self, depth: int = 50, num_trident_blocks: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.trunk = ResNet(depth=depth, out_indices=(2,), frozen_stages=1,
                            dtype=dtype)
        self.num_trident_blocks = num_trident_blocks
        for j in range(num_trident_blocks):
            self.add_module(f"trident_{j}", TridentBottleneck(
                1024 if j == 0 else 2048, 512, dtype=dtype))

    def forward(self, x: torch.Tensor,
                branches: Sequence[int] = (0, 1, 2)) -> torch.Tensor:
        (c4,) = self.trunk(x)
        dils = [DILATIONS[b] for b in branches]
        xs = [c4] * len(dils)
        for j in range(self.num_trident_blocks):
            xs = getattr(self, f"trident_{j}")(xs, dils)
        return torch.stack(xs)
