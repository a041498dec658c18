"""DeltaXYWH box decoding, the counterpart of ``core/boxes.py::delta2bbox``
in the JAX package (mmdet ``delta2bbox`` semantics)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

# log-space clip of dw, dh (mmdet's wh_ratio_clip of 16 / 1000)
MAX_RATIO = abs(math.log(16.0 / 1000.0))


def delta2bbox(
    rois: torch.Tensor,
    deltas: torch.Tensor,
    stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
    max_shape: Optional[Sequence] = None,
) -> torch.Tensor:
    """rois: [..., N, 4]; deltas: [..., N, 4*K] (K classes or 1), with zero
    means. Returns [..., N, 4*K]. ``max_shape`` is (H, W) for border
    clipping; its entries may be Python numbers or 0-d tensors. A tensor
    [S, 2] gives each of the S images of deltas [S, N, 4*K] its own (H, W)."""
    k = deltas.shape[-1] // 4
    d = deltas.reshape(*deltas.shape[:-1], k, 4)
    d = d * torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    dx, dy = d[..., 0], d[..., 1]
    dw = d[..., 2].clamp(-MAX_RATIO, MAX_RATIO)
    dh = d[..., 3].clamp(-MAX_RATIO, MAX_RATIO)
    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0])[..., None]
    ph = (rois[..., 3] - rois[..., 1])[..., None]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    x1, y1 = gx - gw * 0.5, gy - gh * 0.5
    x2, y2 = gx + gw * 0.5, gy + gh * 0.5
    if torch.is_tensor(max_shape) and max_shape.ndim == 2:
        ms = max_shape.to(x1.dtype)[:, :, None, None]  # over [S, N, K]
        max_shape = (ms[:, 0], ms[:, 1])
    if max_shape is not None:
        h = torch.as_tensor(max_shape[0], dtype=x1.dtype, device=x1.device)
        w = torch.as_tensor(max_shape[1], dtype=x1.dtype, device=x1.device)
        zero = torch.zeros((), dtype=x1.dtype, device=x1.device)
        x1 = torch.minimum(torch.maximum(x1, zero), w)
        y1 = torch.minimum(torch.maximum(y1, zero), h)
        x2 = torch.minimum(torch.maximum(x2, zero), w)
        y2 = torch.minimum(torch.maximum(y2, zero), h)
    out = torch.stack([x1, y1, x2, y2], dim=-1)  # [..., N, K, 4]
    return out.reshape(*deltas.shape[:-1], k * 4)
