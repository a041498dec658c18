"""The Balanced Feature Pyramid (Libra R-CNN's BFP neck) with its non-local
refine block, the counterpart of the JAX package's
``models/necks/extra_necks.py`` ``_resize_to``, ``NonLocal2d`` and ``BFP``
(mmdet's ``necks/bfp.py`` and mmcv's ``NonLocal2d``). The JAX module's
other necks (PAFPN, HRFPN, NAS-FPN, FPG) are not ported (ROADMAP.md Queue
1 item 9).

BFP gathers every level to the refine level (a max pool by the integer
stride ratio, then a nearest resize where that misses the size; a nearest
resize up), averages them, refines the average with ``NonLocal2d`` and adds
it back to every level (a nearest resize up, or the max pool down). The
nearest resize is ``nearest-exact`` (half-pixel centres), as
``jax.image.resize(..., "nearest")``. mmdet's BFP pools with
``adaptive_max_pool2d`` and resizes with ``F.interpolate(mode="nearest")``;
the two agree where a size is an exact multiple of the other and differ
elsewhere, as for P6 at the 800 x 1344 bucket (13 x 21 against P4's
50 x 84; ROADMAP fault F23). Maps are NCHW.

``NonLocal2d`` is the embedded-Gaussian block of the BFP config (reduction
1, no scale; the only form built): 1x1 ``theta``, ``phi`` and ``g``, a
softmax over all positions of theta . phi, a zero-initialised 1x1
``conv_out``, residual.
At the refine level of the 800 x 1344 bucket (P4, 50 x 84) its affinity is
[4200, 4200] in float32: a ``torch.matmul`` and a softmax (the JAX package
computes it in XLA, outside any Pallas kernel).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..backbones.resnet import Conv2d

REFINE_LEVEL = 2  # P4


def _resize_to(x: torch.Tensor, hw) -> torch.Tensor:
    """``jax.image.resize(x, ..., "nearest")`` of an NCHW map to ``hw``."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="nearest-exact")


class NonLocal2d(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        for name in ("theta", "phi", "g", "conv_out"):
            self.add_module(name, Conv2d(channels, channels, 1, dtype=dtype))

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        """flax's init of ``conv_out``: zero kernel."""
        self.conv_out.weight.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, C, H, W] -> x + conv_out(softmax(theta phi^T) g)."""
        n, c, h, w = x.shape
        theta = self.theta(x).float().reshape(n, c, h * w).transpose(1, 2)
        phi = self.phi(x).float().reshape(n, c, h * w)
        g = self.g(x).float().reshape(n, c, h * w).transpose(1, 2)
        attn = torch.softmax(torch.matmul(theta, phi), dim=-1)  # [N, HW, HW]
        y = torch.matmul(attn, g).transpose(1, 2).reshape(n, c, h, w)
        return x + self.conv_out(y).to(x.dtype)


class BFP(nn.Module):
    """flax name ``refine`` (the ``NonLocal2d``); the refine level is
    REFINE_LEVEL (P4), as in the Libra config."""

    def __init__(self, channels: int = 256, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.refine = NonLocal2d(channels, dtype=dtype)

    @staticmethod
    def _down(x: torch.Tensor, hw) -> torch.Tensor:
        """The max pool by the integer stride ratio, then the nearest
        resize where the pooled size misses ``hw``."""
        ry = max(x.shape[-2] // hw[0], 1)
        rx = max(x.shape[-1] // hw[1], 1)
        return _resize_to(F.max_pool2d(x, (ry, rx), (ry, rx)), hw)

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        """NCHW maps, the finest first -> the same sizes, in the compute
        dtype."""
        xs = [x.to(self.compute_dtype) for x in inputs]
        ref = REFINE_LEVEL
        ref_hw = xs[ref].shape[-2:]
        bsf = None
        for i, x in enumerate(xs):
            if i < ref:
                x = self._down(x, ref_hw)
            elif i > ref:
                x = _resize_to(x, ref_hw)
            bsf = x if bsf is None else bsf + x
        bsf = self.refine(bsf / len(xs))
        return tuple(x + (_resize_to(bsf, x.shape[-2:]) if i <= ref
                          else self._down(bsf, x.shape[-2:]))
                     for i, x in enumerate(xs))
