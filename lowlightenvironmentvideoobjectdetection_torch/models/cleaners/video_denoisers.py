"""Image-space video denoisers, the counterpart of the JAX package's
``models/cleaners/video_denoisers.py`` (``DenBlock``, ``FastDVDnet``,
``Unet``, ``fastdvd_denoise_clip``), with the flax module names so the
weight bridge maps them by path.

- ``FastDVDnet``: two cascaded U-Net blocks over a 5-frame window; the
  first (``temp1``) runs with shared weights on the triplets (0, 1, 2),
  (1, 2, 3) and (2, 3, 4), the second (``temp2``) on its three outputs.
- ``Unet``: a single-frame U-Net baseline.

Both are residual to their centre (or only) frame, with bias-free 3x3
convs + ReLU, biased 2x2 stride-2 transposed convs for the up-sampling
(the skip adds crop them to the skip's size) and a biased 3x3 output conv.
They compute in f32 whatever the detector's dtype, as the JAX package
builds them with the flax default dtype. Frames are NCHW here; the clip
functions take and give NHWC frames, as the detector does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..backbones.resnet import Conv2d


def _conv(cin: int, cout: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


def _up(cin: int, cout: int) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(cin, cout, 2, stride=2)


def _add_up(skip, up):
    """skip + up cropped to skip's size."""
    return skip + up[:, :, :skip.shape[2], :skip.shape[3]]


class DenBlock(nn.Module):
    """U-Net block over ``in_frames`` frames concatenated on the channels
    [N, 3 * in_frames, H, W] -> the denoised centre frame [N, 3, H, W]:
    encoder at 1x / 2x / 4x, decoder with skip additions."""

    def __init__(self, in_frames: int = 3):
        super().__init__()
        self.in_frames = in_frames
        self.inc1 = _conv(3 * in_frames, 32)
        self.inc2 = _conv(32, 32)
        self.down1a = _conv(32, 64, 2)
        self.down1b = _conv(64, 64)
        self.down2a = _conv(64, 128, 2)
        self.down2b = _conv(128, 128)
        self.up2 = _up(128, 64)
        self.dec1 = _conv(64, 64)
        self.up1 = _up(64, 32)
        self.dec0 = _conv(32, 32)
        self.outc = Conv2d(32, 3, 3, padding=1)

    def forward(self, frames):
        frames = frames.float()
        c = 3 * (self.in_frames // 2)
        x0 = F.relu(self.inc2(F.relu(self.inc1(frames))))
        x1 = F.relu(self.down1b(F.relu(self.down1a(x0))))
        x2 = F.relu(self.down2b(F.relu(self.down2a(x1))))
        x1 = F.relu(self.dec1(_add_up(x1, self.up2(x2))))
        x0 = F.relu(self.dec0(_add_up(x0, self.up1(x1))))
        return frames[:, c:c + 3] + self.outc(x0)


class FastDVDnet(nn.Module):
    """A 5-frame window [N, 15, H, W] -> its denoised centre frame
    [N, 3, H, W]."""

    def __init__(self):
        super().__init__()
        self.temp1 = DenBlock(3)
        self.temp2 = DenBlock(3)

    def forward(self, window):
        n = window.shape[0]
        # the three triplets through the shared block as one batch
        triplets = torch.cat([window[:, 3 * i:3 * i + 9] for i in range(3)])
        t = self.temp1(triplets).reshape(3, n, 3, *window.shape[2:])
        return self.temp2(torch.cat(list(t), 1))


class Unet(nn.Module):
    """A frame [N, 3, H, W] -> its denoised frame (residual)."""

    def __init__(self):
        super().__init__()
        self.e0 = _conv(3, 32)
        self.e1 = _conv(32, 64, 2)
        self.e2 = _conv(64, 128, 2)
        self.e3 = _conv(128, 256, 2)
        self.u3 = _up(256, 128)
        self.d2 = _conv(128, 128)
        self.u2 = _up(128, 64)
        self.d1 = _conv(64, 64)
        self.u1 = _up(64, 32)
        self.d0 = _conv(32, 32)
        self.out = Conv2d(32, 3, 3, padding=1)

    def forward(self, img):
        img = img.float()
        x0 = F.relu(self.e0(img))
        x1 = F.relu(self.e1(x0))
        x2 = F.relu(self.e2(x1))
        x3 = F.relu(self.e3(x2))
        x2 = F.relu(self.d2(_add_up(x2, self.u3(x3))))
        x1 = F.relu(self.d1(_add_up(x1, self.u2(x2))))
        x0 = F.relu(self.d0(_add_up(x0, self.u1(x1))))
        return img + self.out(x0)


def fastdvd_windows(frames: torch.Tensor) -> torch.Tensor:
    """frames [T, 3, H, W] -> each frame's edge-replicated 5-frame window
    [T, 15, H, W]: frames clip(i - 2 .. i + 2, 0, T - 1)."""
    t = frames.shape[0]
    idx = (torch.arange(t)[:, None] + torch.arange(-2, 3)).clamp(0, t - 1)
    return frames[idx.to(frames.device)].flatten(1, 2)


def fastdvd_denoise_clip(model: FastDVDnet, frames: torch.Tensor
                         ) -> torch.Tensor:
    """frames [T, H, W, 3] -> denoised [T, H, W, 3] (f32), each frame from
    its edge-replicated 5-frame window."""
    out = model(fastdvd_windows(frames.permute(0, 3, 1, 2).float()))
    return out.permute(0, 2, 3, 1)
