"""The FCN mask head and its targets, the counterpart of the JAX package's
``models/roi_heads/mask_head.py`` (``FCNMaskHead``, ``mask_targets``,
``mask_iou_targets``, ``mask_loss``, ``paste_masks``; mmdet's
``fcn_mask_head.py`` and ``maskiou_head.py``'s targets).

The head: 4 stacked 3x3 convs (256) on [N, 14, 14, C] RoI features, a 2x2
stride-2 transposed conv (``upsample``, an ``nn.ConvTranspose2d``: the
weight bridge flips flax's kernel for it), a 1x1 conv to per-class 28x28
logits; float32 throughout, as the JAX detectors build it.

The targets are a 28x28 RoIAlign (sampling ratio 2, scale 1) of each roi's
matched gt mask, thresholded at 0.5: on CUDA tensors kernel B's
``gather28x2`` body on the [G, H, W, 1] masks with the matched index as
each roi's map index, where JAX gathers an [N, H, W] copy of the masks
first (the same numbers without the copy). ``mask_iou_targets`` counts a
gt's pixels inside each roi's integer box from a summed-area table a gt
(exact in float32 for 0/1 masks under 2^24 pixels), where JAX builds an
[N, H, W] indicator. ``paste_masks`` is plain torch: bilinear in the
28x28 grid at each image pixel, as JAX writes it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.roi_align import roi_align
from ..backbones.resnet import Conv2d

MASK_SIZE = 28
ROI_SIZE = 14


class FCNMaskHead(nn.Module):
    """flax names ``conv{i}``, ``upsample``, ``conv_logits``."""

    def __init__(self, in_channels: int, num_classes: int = 80,
                 conv_channels: int = 256, num_convs: int = 4):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv{i}", Conv2d(
                in_channels if i == 0 else conv_channels, conv_channels, 3,
                padding=1))
        self.upsample = nn.ConvTranspose2d(conv_channels, conv_channels, 2,
                                           stride=2)
        self.conv_logits = Conv2d(conv_channels, num_classes, 1)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """[N, 14, 14, C] -> mask logits [N, 28, 28, num_classes], f32."""
        x = roi_feats.float().permute(0, 3, 1, 2)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        x = F.relu(self.upsample(x))
        return self.conv_logits(x).permute(0, 2, 3, 1)


@torch.no_grad()
def mask_targets(gt_masks: torch.Tensor, matched_gt_idx: torch.Tensor,
                 rois: torch.Tensor, mask_size: int = MASK_SIZE,
                 impl: Optional[str] = None) -> torch.Tensor:
    """Each roi's matched gt mask cropped and resized to ``mask_size``,
    binarised at 0.5. gt_masks [G, H, W] (image coordinates),
    matched_gt_idx [N], rois [N, 4] -> [N, S, S] float32."""
    out = roi_align(gt_masks.float()[..., None].contiguous(), rois.float(),
                    1.0, batch_inds=matched_gt_idx, out_size=mask_size,
                    sampling_ratio=2, impl=impl)
    return (out[..., 0] >= 0.5).float()


@torch.no_grad()
def mask_iou_targets(pred_bin: torch.Tensor, m_tgts: torch.Tensor,
                     gt_masks: torch.Tensor, matched_gt_idx: torch.Tensor,
                     rois: torch.Tensor) -> torch.Tensor:
    """The MaskIoU target: IoU of the binarised prediction [N, S, S] with
    the whole gt instance, whose part outside the roi's box enters through
    the in-box / full area ratio (BitmapMasks.crop: int-cast coordinates
    clipped to the map, at least 1 px a side). -> [N]."""
    _, h, w = gt_masks.shape
    sat = F.pad(gt_masks.float().cumsum(1).cumsum(2), (1, 0, 1, 0))
    g = matched_gt_idx.long()
    full_area = sat[g, h, w]
    x1 = torch.floor(rois[:, 0]).clamp(0, w)
    y1 = torch.floor(rois[:, 1]).clamp(0, h)
    x2 = torch.floor(rois[:, 2]).clamp(0, w)
    y2 = torch.floor(rois[:, 3]).clamp(0, h)
    xe = torch.minimum(x1 + (x2 - x1).clamp_min(1.0),
                       torch.full_like(x1, float(w))).long()
    ye = torch.minimum(y1 + (y2 - y1).clamp_min(1.0),
                       torch.full_like(y1, float(h))).long()
    x1, y1 = x1.long(), y1.long()
    in_area = sat[g, ye, xe] - sat[g, y1, xe] - sat[g, ye, x1] + sat[g, y1, x1]
    ratio = in_area / (full_area + 1e-7)
    gt_full = m_tgts.sum((1, 2)) / (ratio + 1e-7)
    overlap = (pred_bin * m_tgts).sum((1, 2))
    pred_area = pred_bin.sum((1, 2))
    return overlap / (pred_area + gt_full - overlap).clamp_min(1e-7)


def mask_loss(mask_logits: torch.Tensor, targets: torch.Tensor,
              labels: torch.Tensor, is_pos: torch.Tensor) -> torch.Tensor:
    """BCE on each roi's class channel over the positive rois."""
    s = mask_logits.shape[1]
    x = class_channel(mask_logits, labels)
    bce = x.clamp_min(0) - x * targets + torch.log1p(torch.exp(-x.abs()))
    wt = is_pos.float()[:, None, None]
    return (bce * wt).sum() / (wt.sum() * s * s).clamp_min(1.0)


def class_channel(mask_logits: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """[N, S, S, C] -> each roi's channel of ``labels`` (clipped):
    [N, S, S]."""
    n, s, _, c = mask_logits.shape
    idx = labels.clamp(0, c - 1)[:, None, None, None].expand(n, s, s, 1)
    return torch.gather(mask_logits, 3, idx)[..., 0]


def paste_masks(mask_probs: torch.Tensor, boxes: torch.Tensor, img_h: int,
                img_w: int, thr: float = 0.5) -> torch.Tensor:
    """[N, S, S] probabilities and [N, 4] boxes -> binary masks [N, img_h,
    img_w]: the grid sampled bilinearly (clamped) at each pixel, at least
    ``thr`` and inside the box."""
    n, s, _ = mask_probs.shape
    dev = mask_probs.device
    ys = torch.arange(img_h, dtype=torch.float32, device=dev)
    xs = torch.arange(img_w, dtype=torch.float32, device=dev)
    x1, y1, x2, y2 = (boxes[:, i:i + 1].float() for i in range(4))
    bw = (x2 - x1).clamp_min(1e-3)
    bh = (y2 - y1).clamp_min(1e-3)
    gy = ((ys - y1) / bh * s - 0.5).clamp(0, s - 1)  # [N, H]
    gx = ((xs - x1) / bw * s - 0.5).clamp(0, s - 1)  # [N, W]
    y0, x0 = torch.floor(gy), torch.floor(gx)
    ly, lx = gy - y0, gx - x0
    y0, x0 = y0.long(), x0.long()
    y1i, x1i = (y0 + 1).clamp_max(s - 1), (x0 + 1).clamp_max(s - 1)
    ni = torch.arange(n, device=dev)[:, None, None]

    def tap(yi, xi):
        return mask_probs[ni, yi[:, :, None], xi[:, None, :]]

    ly, lx = ly[:, :, None], lx[:, None, :]
    v = (tap(y0, x0) * ((1 - ly) * (1 - lx)) + tap(y0, x1i) * ((1 - ly) * lx)
         + tap(y1i, x0) * (ly * (1 - lx)) + tap(y1i, x1i) * (ly * lx))
    inside = (((ys >= y1) & (ys <= y2))[:, :, None]
              & ((xs >= x1) & (xs <= x2))[:, None, :])
    return (v >= thr) & inside
