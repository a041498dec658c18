"""The Balanced Feature Pyramid (Libra R-CNN's BFP neck) with its non-local
refine block, and NAS-FPN, the counterpart of the JAX package's
``models/necks/extra_necks.py`` ``_resize_to``, ``NonLocal2d``, ``BFP``,
``_SumCell``, ``_GPCell`` and ``NASFPN`` (mmdet's ``necks/bfp.py``,
``necks/nas_fpn.py`` and mmcv's ``NonLocal2d``). The JAX module's other
necks (PAFPN, HRFPN, FPG) are not ported (ROADMAP.md Queue 1 item 9).

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

``NASFPN`` adapts C3-C5 with 1x1 convs, takes P6 and P7 by subsampling
(a 1x1 max pool of stride 2), then stacks ``stack_times`` times the
searched seven-cell motif over P3-P7. A cell resizes both inputs to its
output's size with the same ``nearest-exact`` resize, up and down, and
has no BN (mmdet max-pools to go down and normalises its cells' convs;
ROADMAP fault F28); ``_SumCell`` is conv(relu(a + b)), ``_GPCell``
conv(relu(a + b * sigmoid(mean over space of a))), where mmdet's
GlobalPoolingCell computes b + sigmoid(mean of b) * a (F27).
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


class _SumCell(nn.Module):
    """flax name ``conv``: a 3x3 conv (with bias) of relu(a + b)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype)

    def combine(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a + b

    def forward(self, a: torch.Tensor, b: torch.Tensor, out_hw
                ) -> torch.Tensor:
        return self.conv(F.relu(self.combine(_resize_to(a, out_hw),
                                             _resize_to(b, out_hw))))


class _GPCell(_SumCell):
    """The global-pool attention cell: b weighted by sigmoid of a's
    spatial mean (F27)."""

    def combine(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a + b * torch.sigmoid(a.mean(dim=(-2, -1), keepdim=True))


# the motif, in order: (flax name suffix, cell, input a, input b, output
# level); p4_1 and p4_2 are the motif's intermediates
NAS_CELLS = (("gp64_4", _GPCell, "p6", "p4", "p4_1"),
             ("sum44_4", _SumCell, "p4_1", "p4", "p4_2"),
             ("sum43_3", _SumCell, "p4_2", "p3", "p3"),
             ("sum34_4", _SumCell, "p3", "p4_2", "p4"),
             ("gp43_5a", _GPCell, "p4", "p3", "p5_tmp"),
             ("sum55_5", _SumCell, "p5_tmp", "p5", "p5"),
             ("gp54_7a", _GPCell, "p5", "p4_2", "p7_tmp"),
             ("sum77_7", _SumCell, "p7_tmp", "p7", "p7"),
             ("gp75_6", _GPCell, "p7", "p5", "p6"))


class NASFPN(nn.Module):
    """flax names ``adapt{i}`` (1x1 convs) and ``s{s}_{cell}`` (each with
    its ``conv``), as NAS_CELLS lists them."""

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 stack_times: int = 3, dtype=torch.float32):
        super().__init__()
        self.num_outs, self.stack_times = num_outs, stack_times
        self.compute_dtype = dtype
        for i, c in enumerate(in_channels):
            self.add_module(f"adapt{i}", Conv2d(c, out_channels, 1,
                                                dtype=dtype))
        for s in range(stack_times):
            for name, cell, *_ in NAS_CELLS:
                self.add_module(f"s{s}_{name}", cell(out_channels, dtype))

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        """NCHW maps C3-C5 -> P3-P7 in the compute dtype."""
        feats = [getattr(self, f"adapt{i}")(x) for i, x in enumerate(inputs)]
        while len(feats) < self.num_outs:
            feats.append(F.max_pool2d(feats[-1], 1, 2))
        p = dict(zip(("p3", "p4", "p5", "p6", "p7"), feats[:5]))
        for s in range(self.stack_times):
            for name, _, a, b, out in NAS_CELLS:
                hw = p[out[:2]].shape[-2:]
                p[out] = getattr(self, f"s{s}_{name}")(p[a], p[b], hw)
        return tuple(p[k] for k in ("p3", "p4", "p5", "p6", "p7"))
