"""ResNet backbone (bottleneck depths, 'pytorch' style: stride on the 3x3),
the counterpart of the JAX package's ``models/backbones/resnet.py``.

Convolutions run NCHW in the module's compute ``dtype``; weights are cast
per use, as flax does, so a model whose weights were cast ahead of time
(``cast_for_inference``) computes the same numbers. Only the plain 7x7/2
stem: the JAX package's space-to-depth and packed stems are the same math
arranged for the TPU. ``frozen_stages`` detaches the stem's output and each
frozen stage's output, where the JAX package stops the gradient.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

ARCH_SETTINGS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in a fixed dtype (input and weights cast)."""

    def __init__(self, *args, dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), b)


class FrozenBatchNorm(nn.Module):
    """BN with frozen statistics: y = x * scale + shift, where
    scale = gamma / sqrt(var + eps) and shift = beta - mean * scale are
    computed in f32 and then cast to the compute dtype. gamma (``weight``)
    and beta (``bias``) are parameters, as in the JAX package, where the
    unfrozen stages train them; the statistics are buffers."""

    eps = 1e-5

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        g = self.weight.float()
        std = torch.sqrt(self.running_var.float() + self.eps)
        scale = (g / std).to(self.compute_dtype)
        shift = (self.bias.float() - self.running_mean.float() * g / std
                 ).to(self.compute_dtype)
        return x * scale[:, None, None] + shift[:, None, None]


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(planes, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride,
                            padding=dilation, dilation=dilation, bias=False,
                            dtype=dtype)
        self.bn2 = FrozenBatchNorm(planes, dtype=dtype)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False, dtype=dtype)
        self.bn3 = FrozenBatchNorm(planes * 4, dtype=dtype)
        if downsample:
            self.downsample_conv = Conv2d(inplanes, planes * 4, 1,
                                          stride=stride, bias=False,
                                          dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(planes * 4, dtype=dtype)
        else:
            self.downsample_conv = None

    def forward(self, x, clip_len: Optional[int] = None,
                impl: Optional[str] = None):
        """Each frame on its own (``clip_len`` and ``impl``, which blocks
        that mix frames read, are unused)."""
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Multi-stage ResNet. Input [N, C, H, W]; returns the stage outputs
    selected by ``out_indices`` (duplicates allowed), NCHW; stages past
    the last selected one are built but not run. With
    ``frozen_stages`` k >= 0 no gradient reaches the stem or stages 1..k.

    A subclass chooses a stage's blocks (``stage_block``) and may append a
    module to a stage (``stage_plugin``, named ``plugin{i+1}``, before the
    stage's gradient stop), as the dark backbones do
    (``dark_resnet.py``)."""

    def __init__(self, depth: int = 50, in_channels: int = 3,
                 base_channels: int = 64, num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (3,), frozen_stages: int = -1,
                 dtype=torch.float32):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise ValueError(f"ResNet depth {depth}: only bottleneck depths "
                             f"{sorted(ARCH_SETTINGS)}")
        stage_blocks = ARCH_SETTINGS[depth]
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.compute_dtype = dtype
        self.conv1 = Conv2d(in_channels, base_channels, 7, stride=2, padding=3,
                            bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(base_channels, dtype=dtype)
        self.stages = []
        inplanes = base_channels
        for i in range(num_stages):
            planes = base_channels * 2 ** i
            names = []
            for j in range(stage_blocks[i]):
                first = j == 0
                name = f"layer{i + 1}_{j}"
                self.add_module(name, self.stage_block(
                    i, inplanes, planes,
                    stride=strides[i] if first else 1,
                    dilation=dilations[i],
                    downsample=first and (strides[i] != 1
                                          or inplanes != planes * 4),
                    dtype=dtype))
                inplanes = planes * 4
                names.append(name)
            plugin = self.stage_plugin(i, inplanes, planes, dtype)
            if plugin is not None:
                self.add_module(f"plugin{i + 1}", plugin)
                names.append(f"plugin{i + 1}")
            self.stages.append(names)

    def stage_block(self, stage: int, *args, **kw) -> nn.Module:
        """A block of stage ``stage`` (0-based) from ``Bottleneck``'s
        arguments."""
        return Bottleneck(*args, **kw)

    def stage_plugin(self, stage: int, channels: int, planes: int,
                     dtype) -> Optional[nn.Module]:
        """The module after stage ``stage``'s blocks, on its ``channels``
        (None: none)."""
        return None

    def forward(self, x, clip_len: Optional[int] = None,
                impl: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
        """x [N, Cin, H, W]: N frames as clips of ``clip_len`` (None: one
        clip), read only by the blocks and plugins that mix frames;
        ``impl="plain"`` runs their DCN's plain version (for comparisons
        only)."""
        x = F.relu(self.bn1(self.conv1(x.to(self.compute_dtype))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        if self.frozen_stages >= 0:
            x = x.detach()
        outs = []
        last = max(self.out_indices)  # later stages feed no output
        for i, names in enumerate(self.stages[:last + 1]):
            for name in names:
                x = getattr(self, name)(x, clip_len=clip_len, impl=impl)
            if self.frozen_stages >= i + 1:
                x = x.detach()
            outs.append(x)
        return tuple(outs[i] for i in self.out_indices)
