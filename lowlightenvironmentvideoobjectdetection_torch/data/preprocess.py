"""Frame preprocessing in torch, the counterpart of the JAX package's
``data/preprocess.py``: keep-ratio bilinear resize (antialiased when it
downsamples, as ``jax.image.resize`` is), ImageNet normalization and
bottom/right zero padding to the static bucket."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def normalize(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] raw-intensity RGB -> ImageNet-normalized float32."""
    m = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img.device)
    s = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img.device)
    return (img.float() - m) / s


def resize_keep_ratio(img: torch.Tensor, scale: Tuple[int, int] = (1000, 600)
                      ) -> Tuple[torch.Tensor, np.ndarray]:
    """Resize [H, W, C] to fit within (max_long, max_short), keeping the
    ratio. Returns (resized [h, w, C] float32, scale_factor [sx, sy, sx, sy])."""
    h, w = img.shape[:2]
    max_long, max_short = max(scale), min(scale)
    f = min(max_long / max(h, w), max_short / min(h, w))
    new_w, new_h = int(w * f + 0.5), int(h * f + 0.5)
    x = img.float().permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(new_h, new_w), mode="bilinear",
                        align_corners=False, antialias=True)
    sf = np.array([new_w / w, new_h / h, new_w / w, new_h / h], np.float32)
    return out[0].permute(1, 2, 0), sf


def pad_to(img: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Zero-pad [..., H, W, C] bottom/right to (pad_h, pad_w)."""
    h, w = img.shape[-3], img.shape[-2]
    return F.pad(img, (0, 0, 0, pad_w - w, 0, pad_h - h))


def prepare_frames(frames, pad_h: int, pad_w: int, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """[T, H, W, 3] uint8/float frames (numpy or torch) -> (imgs
    [T, pad_h, pad_w, 3] normalized on ``device``, img_shape [2] (h, w)
    float32, scale_factor [4]). Frames are resized to fit the pad bucket."""
    frames = torch.as_tensor(np.asarray(frames) if not torch.is_tensor(frames)
                             else frames, device=device)
    if frames.ndim == 3:
        frames = frames[None]
    resized, sf = [], None
    for f in frames:
        r, sf = resize_keep_ratio(f, (pad_w, pad_h))
        resized.append(r)
    imgs = pad_to(normalize(torch.stack(resized)), pad_h, pad_w)
    h, w = resized[0].shape[:2]
    img_shape = torch.tensor([float(h), float(w)], dtype=torch.float32,
                             device=imgs.device)
    return imgs, img_shape, sf
