"""Box geometry, the counterpart of the JAX package's ``core/boxes.py``:
IoU overlaps and the DeltaXYWH coder (mmdet ``bbox2delta`` /
``delta2bbox`` semantics, zero means). The operations run in the JAX
functions' order, so equal inputs give equal IoUs: ``max_iou_assign``
compares them with ``==``."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

# log-space clip of dw, dh (mmdet's wh_ratio_clip of 16 / 1000)
MAX_RATIO = abs(math.log(16.0 / 1000.0))


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of [..., 4] boxes, width and height clamped at 0."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(0.0)
    return w * h


def bbox_overlaps(boxes1: torch.Tensor, boxes2: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """IoU of [..., N, 4] against [..., M, 4] -> [..., N, M]."""
    iw = (torch.minimum(boxes1[..., :, None, 2], boxes2[..., None, :, 2])
          - torch.maximum(boxes1[..., :, None, 0], boxes2[..., None, :, 0])
          ).clamp_min(0.0)
    ih = (torch.minimum(boxes1[..., :, None, 3], boxes2[..., None, :, 3])
          - torch.maximum(boxes1[..., :, None, 1], boxes2[..., None, :, 1])
          ).clamp_min(0.0)
    inter = iw * ih
    union = (bbox_area(boxes1)[..., :, None] + bbox_area(boxes2)[..., None, :]
             - inter)
    return inter / union.clamp_min(eps)


def bbox2delta(proposals: torch.Tensor, gt: torch.Tensor,
               stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Encode gt boxes as (dx, dy, dw, dh) / stds against [..., 4]
    proposals; zero-size proposals and gts are clamped to 1e-6 so padded
    rows stay finite."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = (proposals[..., 2] - proposals[..., 0]).clamp_min(1e-6)
    ph = (proposals[..., 3] - proposals[..., 1]).clamp_min(1e-6)
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                          torch.log(gw.clamp_min(1e-6) / pw),
                          torch.log(gh.clamp_min(1e-6) / ph)], dim=-1)
    return deltas / torch.tensor(stds, dtype=deltas.dtype,
                                 device=deltas.device)


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
