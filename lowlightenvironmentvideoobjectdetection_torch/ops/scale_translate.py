"""``jax.image.scale_and_translate(..., method="linear")`` in torch: the
resampling that the JAX package's tracking crops use (DeepSORT's
``crop_and_resize`` for the ReID net, SiamRPN's ``crop_around``).

As ``jax/_src/image/scale.py`` ``compute_weight_mat`` does, each spatial
axis gets a weight matrix [out, in] in float32, and the image is resampled
by two products:

- an output pixel i samples the input at ``(i + 0.5) / scale - translation
  / scale - 0.5``, with the triangle kernel;
- **antialiasing** (JAX's default ``antialias=True``): when the axis shrinks
  (scale < 1) the kernel widens by 1 / scale, so a shrinking crop averages
  over its footprint where plain bilinear sampling (``F.interpolate``,
  ``warpAffine``) would alias (ROADMAP fault F14);
- the weights are renormalised over the in-range input samples (a total
  under 1000 float32 eps gives zeros), and an output whose sample lies
  outside [-0.5, size - 0.5] is 0.

The products run in float32 (PyTorch's default matmul precision; TF32 off).

``resize_nearest`` is ``jax.image.resize(..., "nearest")``, which the mask
families' targets use (HTC's semantic map, YOLACT's downscaled masks).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_EPS_FLOOR = 1000.0 * float(np.finfo(np.float32).eps)


def weight_matrix(in_size: int, out_size: int, scale: torch.Tensor,
                  translation: torch.Tensor) -> torch.Tensor:
    """The [..., out_size, in_size] float32 weights of one axis for scales
    and translations of shape [...]."""
    scale = scale.float()
    translation = translation.float()
    dev = scale.device
    inv = 1.0 / scale
    kernel_scale = torch.clamp(inv, min=1.0)
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev)
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)
    sample = ((out_pos + 0.5) * inv[..., None]
              - (translation * inv)[..., None] - 0.5)  # [..., out]
    x = (torch.abs(sample[..., :, None] - in_pos)
         / kernel_scale[..., None, None])
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(-1, keepdim=True)
    w = torch.where(torch.abs(total) > _EPS_FLOOR,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[..., None], w, torch.zeros_like(w))


def scale_and_translate(img: torch.Tensor, out_hw: Sequence[int],
                        scale: torch.Tensor, translation: torch.Tensor
                        ) -> torch.Tensor:
    """img [H, W, C] -> [..., oh, ow, C] float32, one output for each
    (y, x) pair of ``scale`` and ``translation`` [..., 2]: input (y, x)
    lands at output (y * scale[0] + translation[0], x * scale[1] +
    translation[1]), half-pixel centres."""
    h, w, c = img.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    lead = scale.shape[:-1]
    wy = weight_matrix(h, oh, scale[..., 0], translation[..., 0])
    wx = weight_matrix(w, ow, scale[..., 1], translation[..., 1])
    wy = wy.reshape(-1, oh, h)
    wx = wx.reshape(-1, ow, w)
    n = wy.shape[0]
    x = img.float()
    # contract the axis that leaves the smaller intermediate first
    if ow * h <= oh * w:
        t = torch.matmul(wx.reshape(n * ow, w),
                         x.permute(1, 0, 2).reshape(w, h * c))
        t = t.reshape(n, ow, h, c).permute(0, 2, 1, 3).reshape(n, h, ow * c)
        out = torch.bmm(wy, t).reshape(n, oh, ow, c)
    else:
        t = torch.matmul(wy.reshape(n * oh, h), x.reshape(h, w * c))
        t = t.reshape(n, oh, w, c).permute(0, 2, 1, 3).reshape(n, w, oh * c)
        out = torch.bmm(wx, t).reshape(n, ow, oh, c).permute(0, 2, 1, 3)
    return out.reshape(*lead, oh, ow, c)


def resize_nearest(x: torch.Tensor, dims, sizes) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` along ``dims`` to ``sizes``:
    output i reads input floor((i + 0.5) * m / n), computed in float32 in
    that order (half-pixel centres, ROADMAP F20; PyTorch's
    ``nearest-exact`` rounds (i + 0.5) * (m / n) instead)."""
    for d, n in zip(dims, sizes):
        m = x.shape[d]
        if m == n:
            continue
        src = torch.floor((torch.arange(n, dtype=torch.float32,
                                        device=x.device) + 0.5) * m / n)
        x = torch.index_select(x, d, src.long())
    return x
