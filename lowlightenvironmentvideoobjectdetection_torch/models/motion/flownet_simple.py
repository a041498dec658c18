"""FlowNetSimple optical flow and FGFA's cosine-similarity frame
aggregator, the counterpart of the JAX package's
``models/motion/flownet_simple.py`` (``FlowNetSimple``,
``EmbedAggregator``), with the flax module names so the weight bridge
maps them by path. Both compute in float32, as the JAX package builds them
with the flax default dtype; frames and maps enter and leave NHWC, the
convs run NCHW.

FlowNetSimple: the detector-normalized frame pair is renormalized to
FlowNet's statistics, downscaled by ``img_scale_factor``, encoded by
stride-2 convs (LeakyReLU 0.1) and decoded coarse to fine: at each level a
flow prediction, its 2x transposed-conv upsampling and a transposed-conv
deconvolution of the features, cropped to the skip's size and
concatenated with it. The last prediction (at a quarter of the downscaled
input) is upscaled by ``4 / img_scale_factor`` and scaled by that factor
times ``flow_scale_factor``.

The input's downscale antialiases, as ``jax.image.resize`` does when it
shrinks; the original (mmtracking's ``F.interpolate``) does not, and the
two differ by up to ~1 on unit-variance input (ROADMAP fault F13). The port
follows JAX, so weights carried across compute the same flow.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...data.preprocess import IMAGENET_MEAN, IMAGENET_STD
from ..backbones.resnet import Conv2d

FLOW_IMG_MEAN = (0.411, 0.432, 0.450)
# (planes, kernel, extra stride-1 convs) of conv1..conv6
ENCODER = ((64, 7, 0), (128, 5, 0), (256, 5, 1), (512, 3, 1), (512, 3, 1),
           (1024, 3, 1))
DECONV_PLANES = (512, 256, 128, 64)


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


def _up(cin: int, cout: int) -> nn.ConvTranspose2d:
    """flax ``ConvTranspose(4x4, stride 2, padding='SAME')``, no bias: the
    same output size 2x, with the kernel flipped (the bridge flips it)."""
    return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1, bias=False)


class FlowNetSimple(nn.Module):
    def __init__(self, img_scale_factor: float = 0.5,
                 flow_scale_factor: float = 5.0):
        super().__init__()
        self.img_scale_factor = img_scale_factor
        self.flow_scale_factor = flow_scale_factor
        cin = 6
        for i, (planes, k, extra) in enumerate(ENCODER):
            self.add_module(f"conv{i + 1}", Conv2d(cin, planes, k, stride=2,
                                                   padding=k // 2))
            for j in range(extra):
                kk = 3 if i == 2 else k
                self.add_module(f"conv{i + 1}_{j + 1}",
                                Conv2d(planes, planes, kk, padding=kk // 2))
            cin = planes
        self.encoder = [[f"conv{i + 1}"] + [f"conv{i + 1}_{j + 1}"
                                            for j in range(extra)]
                        for i, (_, _, extra) in enumerate(ENCODER)]
        skips = [p for p, _, _ in ENCODER[1:]]  # conv2..conv6 outputs
        concat = skips[-1]
        for step, i in enumerate(range(len(skips) - 1, 0, -1)):
            self.add_module(f"predict_flow{i + 2}",
                            Conv2d(concat, 2, 3, padding=1, bias=False))
            self.add_module(f"upsample_flow{i + 1}", _up(2, 2))
            self.add_module(f"deconv{i + 1}", _up(concat, DECONV_PLANES[step]))
            concat = skips[i - 1] + DECONV_PLANES[step] + 2
        self.predict_flow = Conv2d(concat, 2, 3, padding=1, bias=False)

    def forward(self, img_pair: torch.Tensor) -> torch.Tensor:
        """img_pair [N, H, W, 6]: two ImageNet-normalized frames on the
        channels -> flow [N, H', W', 2] in pixels of the full frame (H' = H
        when H is a multiple of 8 / img_scale_factor)."""
        dev = img_pair.device
        mean = torch.tensor(IMAGENET_MEAN * 2, device=dev)
        std = torch.tensor(IMAGENET_STD * 2, device=dev)
        fmean = torch.tensor(FLOW_IMG_MEAN * 2, device=dev)
        x = (img_pair.float() * std + mean) / 255.0 - fmean
        n, h, w, _ = x.shape
        size = (int(h * self.img_scale_factor), int(w * self.img_scale_factor))
        x = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                          align_corners=False, antialias=True)
        outs = []
        for i, names in enumerate(self.encoder):
            for name in names:
                x = _lrelu(getattr(self, name)(x))
            if i >= 1:  # conv2..conv6
                outs.append(x)
        concat = outs[-1]
        for i in range(len(outs) - 1, 0, -1):
            flow = getattr(self, f"predict_flow{i + 2}")(concat)
            upflow = getattr(self, f"upsample_flow{i + 1}")(flow)
            deconv = _lrelu(getattr(self, f"deconv{i + 1}")(concat))
            tgt = outs[i - 1]
            th, tw = tgt.shape[2], tgt.shape[3]
            concat = torch.cat([tgt, deconv[:, :, :th, :tw],
                                upflow[:, :, :th, :tw]], 1)
        flow = self.predict_flow(concat)
        up = 4.0 / self.img_scale_factor
        fh, fw = flow.shape[2], flow.shape[3]
        flow = F.interpolate(flow, size=(int(fh * up), int(fw * up)),
                             mode="bilinear", align_corners=False)
        return (flow * (up * self.flow_scale_factor)).permute(0, 2, 3, 1)


class EmbedAggregator(nn.Module):
    """FGFA's aggregator: embed the key and every candidate map
    (``num_convs`` convs, ReLU between), L2-normalize each pixel's
    embedding (norm floored at 1e-6), softmax the key-candidate cosine
    over the candidates, and sum the candidates (unembedded) with those
    weights, pixel by pixel."""

    def __init__(self, in_channels: int = 512, channels: int = 512,
                 num_convs: int = 1, kernel_size: int = 3):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"embed_conv{i}", Conv2d(
                in_channels if i == 0 else channels, channels, kernel_size,
                padding=kernel_size // 2))

    def embed(self, v: torch.Tensor) -> torch.Tensor:
        """[N, H, W, C] -> [N, H, W, channels] unit vectors."""
        v = v.permute(0, 3, 1, 2).contiguous()
        for i in range(self.num_convs):
            v = getattr(self, f"embed_conv{i}")(v)
            if i != self.num_convs - 1:
                v = F.relu(v)
        v = v.permute(0, 2, 3, 1)
        return v / v.norm(dim=-1, keepdim=True).clamp_min(1e-6)

    def forward(self, x: torch.Tensor, ref_x: torch.Tensor) -> torch.Tensor:
        """x [1, H, W, C] the key, ref_x [N, H, W, C] the candidates (the
        key among them) -> [1, H, W, C] float32. The key and the candidates
        are embedded apart, as in JAX: on the H100, cuDNN's f32 3x3 conv at
        FGFA's 38x64x512 takes 4.07 ms on 15 maps and 40.26 ms (with a 33.6
        GB workspace) on the 16 of one concatenated call (PERF.md, PR 14;
        ``chip_smoke.py`` ``fgfa_stream``)."""
        x_e, ref_e = self.embed(x.float()), self.embed(ref_x.float())
        w = (ref_e * x_e).sum(-1, keepdim=True).softmax(0)
        return (ref_x.float() * w).sum(0, keepdim=True)
