"""The dark (denoising) ResNet family, the counterpart of the JAX package's
``models/backbones/dark_resnet.py`` (``ConvLSTMBottleneck``, ``CBAM``,
``LayerDenoisingPlugin``, ``DarkResNet``, ``DARK_VARIANTS``,
``make_dark_backbone``), with the flax module names so the weight bridge
maps them by path:

- ``ConvLSTMBottleneck``: a bottleneck whose 3x3 conv is a ConvLSTM over
  the frames of a clip (one shared gate conv on [x_t, h], split i, f, o,
  g); ``bidirectional`` first aligns every frame to the clip's middle frame
  with DCNv2 (``dcn_f``), scans forward, aligns the forward hidden states
  to the middle one (``dcn_b``) and scans backward (ResNet_A / ResNet_B).
  The stage stride is a plain 3x3 ``conv2`` before the recurrence, as in
  the JAX package (the original strides inside the recurrent conv, which
  breaks the hidden state's shape after step 0).
- ``LayerDenoisingPlugin``: after a stage's blocks, 1x1 reduce to C/4, per
  reference frame a DCNv2 alignment of the clip's frames to it, an
  embedding conv of the aligned frames times the reference, a softmax over
  the frames and the weighted sum; optional ``CBAM``; 1x1 expand, residual.
- ``DarkResNet``: the plain ResNet with ConvLSTM stages
  (``temporal_stages``) and plugins (``plugin_stages``; ``plugin_type``
  "layer", or "aggregator" for a ``DenoisingAggregator`` as the
  insert-plugins configs build).

Frames are NCHW [N, C, H, W] with N = clips x ``clip_len`` frames, in clip
order: the recurrence, the plugins' softmax over the frames and the
aggregator plugin's fusion run within each clip only (the JAX package
takes one clip, [T, H, W, C], and ``jax.vmap`` over streams). Every DCN
here runs in f32 (the JAX packs are f32) with unbounded offsets, the JAX
``dcn_impl="scan"`` form (ROADMAP fault F1); ``impl="plain"`` runs its
plain version (for comparisons only).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..aggregators.denoising_aggregator import (DenoisingAggregator,
                                                ModulatedDCNPack, clips)
from ...registry import BACKBONES
from .resnet import Conv2d, FrozenBatchNorm, ResNet


def _dcn32(dcn: ModulatedDCNPack, x, extra, impl):
    """A pack on f32 inputs, its output cast back to x's dtype."""
    return dcn(x.float(), extra.float(), impl=impl).to(x.dtype)


class ConvLSTMBottleneck(nn.Module):
    """Bottleneck whose 3x3 conv is a ConvLSTM over each clip's frames."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 bidirectional: bool = False, dtype=torch.float32):
        super().__init__()
        p = planes
        self.bidirectional = bidirectional
        self.conv1 = Conv2d(inplanes, p, 1, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(p, dtype=dtype)
        self.conv2 = Conv2d(p, p, 3, stride=stride, padding=dilation,
                            dilation=dilation, bias=False, dtype=dtype)
        self.gate_f = Conv2d(2 * p, 4 * p, 3, padding=1, bias=False,
                             dtype=dtype)
        if bidirectional:
            self.dcn_f = ModulatedDCNPack(p, p, p, deform_groups=8)
            self.dcn_b = ModulatedDCNPack(p, p, p, deform_groups=8)
            self.gate_b = Conv2d(2 * p, 4 * p, 3, padding=1, bias=False,
                                 dtype=dtype)
        self.bn2 = FrozenBatchNorm(p, dtype=dtype)
        self.conv3 = Conv2d(p, p * 4, 1, bias=False, dtype=dtype)
        self.bn3 = FrozenBatchNorm(p * 4, dtype=dtype)
        if downsample:
            self.downsample_conv = Conv2d(inplanes, p * 4, 1, stride=stride,
                                          bias=False, dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(p * 4, dtype=dtype)
        else:
            self.downsample_conv = None

    @staticmethod
    def _scan(gate: Conv2d, xs: torch.Tensor, reverse: bool = False):
        """The LSTM over the frame axis of xs [n, T, p, h, w] (all clips at
        once); the hidden states in frame order."""
        h = c = torch.zeros_like(xs[:, 0])
        hs = [None] * xs.shape[1]
        steps = range(xs.shape[1])
        for t in (reversed(steps) if reverse else steps):
            i_g, f_g, o_g, g_g = gate(torch.cat([xs[:, t], h], 1)).chunk(4, 1)
            c = torch.sigmoid(f_g) * c + torch.sigmoid(i_g) * torch.tanh(g_g)
            h = torch.sigmoid(o_g) * torch.tanh(c)
            hs[t] = h
        return torch.stack(hs, 1)

    def forward(self, x, clip_len: Optional[int] = None,
                impl: Optional[str] = None):
        out = F.relu(self.bn1(self.conv1(x)))
        out = clips(self.conv2(out), clip_len)  # [n, T, p, h, w]
        if self.bidirectional:
            mid = out.shape[1] // 2
            flat = out.flatten(0, 1)
            ref = out[:, mid:mid + 1].expand_as(out).flatten(0, 1)
            fwd = self._scan(self.gate_f, _dcn32(self.dcn_f, flat, ref, impl)
                             .view_as(out))
            flat = fwd.flatten(0, 1)
            ref = fwd[:, mid:mid + 1].expand_as(fwd).flatten(0, 1)
            out = self._scan(self.gate_b, _dcn32(self.dcn_b, flat, ref, impl)
                             .view_as(fwd), reverse=True)
        else:
            out = self._scan(self.gate_f, out)
        out = F.relu(self.bn2(out.flatten(0, 1)))
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class CBAM(nn.Module):
    """Channel and spatial attention (the original's resnet_D.py), per
    frame."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype=torch.float32):
        super().__init__()
        mid = max(channels // reduction, 1)
        self.fc1 = Conv2d(channels, mid, 1, bias=False, dtype=dtype)
        self.fc2 = Conv2d(mid, channels, 1, bias=False, dtype=dtype)
        self.spatial = Conv2d(2, 1, 7, padding=3, bias=False, dtype=dtype)

    def forward(self, x):
        def mlp(v):
            return self.fc2(F.relu(self.fc1(v)))

        ch = torch.sigmoid(mlp(x.mean((2, 3), keepdim=True))
                           + mlp(x.amax((2, 3), keepdim=True)))
        x = x * ch
        sp = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        return x * torch.sigmoid(self.spatial(sp))


class LayerDenoisingPlugin(nn.Module):
    """Feature-space denoising after a stage (the original's resnet_C.py):
    reduce, DCNv2 temporal fusion once per reference frame of the clip,
    optional CBAM, expand, residual."""

    def __init__(self, channels: int, with_cbam: bool = False,
                 dtype=torch.float32):
        super().__init__()
        p = channels // 4
        self.conv1 = Conv2d(channels, p, 1, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(p, dtype=dtype)
        self.offset_conv = Conv2d(2 * p, p, 3, padding=1, bias=False,
                                  dtype=dtype)
        self.dcn_pack = ModulatedDCNPack(p, p, p, deform_groups=8)
        self.emb_conv = Conv2d(p, p, 3, padding=1, bias=False, dtype=dtype)
        self.bn2 = FrozenBatchNorm(p, dtype=dtype)
        self.cbam = CBAM(p, dtype=dtype) if with_cbam else None
        self.conv3 = Conv2d(p, channels, 1, bias=False, dtype=dtype)
        self.bn3 = FrozenBatchNorm(channels, dtype=dtype)

    def forward(self, x, clip_len: Optional[int] = None,
                impl: Optional[str] = None):
        out = F.relu(self.bn1(self.conv1(x)))
        oc = clips(out, clip_len)  # [n, T, p, h, w]
        fused = []
        for i in range(oc.shape[1]):
            refs = oc[:, i:i + 1].expand_as(oc).flatten(0, 1)
            x_set = self.offset_conv(torch.cat([out, refs], 1))
            x_dcn = _dcn32(self.dcn_pack, out, x_set, impl)
            wgt = torch.softmax(clips(self.emb_conv(x_dcn * refs), clip_len),
                                1)
            fused.append((wgt * oc).sum(1))
        fused = F.relu(self.bn2(torch.stack(fused, 1).flatten(0, 1)))
        if self.cbam is not None:
            fused = self.cbam(fused)
        fused = self.bn3(self.conv3(fused))
        return F.relu(fused + x)


class DarkResNet(ResNet):
    """The parameterised dark backbone: the ``ResNet`` whose
    ``temporal_stages`` (0-based) are ConvLSTM bottlenecks
    (``bidirectional``: DCN-aligned, ResNet_A / B) and whose
    ``plugin_stages`` end with a plugin (``plugin{i+1}``) before the
    stage's output (and before its gradient stop, with ``frozen_stages``).
    Input [N, Cin, H, W], N = clips x ``clip_len`` frames; returns the
    stages of ``out_indices``, NCHW."""

    def __init__(self, *, out_indices: Sequence[int] = (0, 1, 2, 3),
                 temporal_stages: Sequence[int] = (),
                 bidirectional: bool = False,
                 plugin_stages: Sequence[int] = (), with_cbam: bool = False,
                 plugin_type: str = "layer", plugin_rdb_blocks: int = 1,
                 plugin_rdb_layers: int = 3, plugin_emb_nums: int = 3,
                 plugin_with_rdb: bool = True, plugin_with_taf: bool = True,
                 **resnet):
        if plugin_type not in ("layer", "aggregator"):
            raise ValueError(f"unknown plugin_type {plugin_type!r}")
        # read by stage_block and stage_plugin while ResNet builds the stages
        self.temporal_stages = tuple(temporal_stages)
        self.bidirectional = bidirectional
        self.plugin_stages = tuple(plugin_stages)
        self.with_cbam = with_cbam
        self.plugin_type = plugin_type
        self.aggregator_kw = dict(
            rdb_blocks=plugin_rdb_blocks, rdb_layers=plugin_rdb_layers,
            channel_growth=64, emb_nums=plugin_emb_nums,
            with_rdb=plugin_with_rdb, with_taf=plugin_with_taf)
        super().__init__(out_indices=out_indices, **resnet)

    def stage_block(self, stage, *args, **kw):
        if stage in self.temporal_stages:
            return ConvLSTMBottleneck(*args, bidirectional=self.bidirectional,
                                      **kw)
        return super().stage_block(stage, *args, **kw)

    def stage_plugin(self, stage, channels, planes, dtype):
        if stage not in self.plugin_stages:
            return None
        if self.plugin_type == "aggregator":
            return DenoisingAggregator(channels=channels, mid_channels=planes,
                                       dtype=dtype, **self.aggregator_kw)
        return LayerDenoisingPlugin(channels, self.with_cbam, dtype=dtype)


# reference class name -> DarkResNet arguments (0-based stages; the
# original's "layer4" is stage 3)
DARK_VARIANTS = {
    "DarkResNet": dict(temporal_stages=(1,)),
    "DarkRAWResNet": dict(temporal_stages=(1,), in_channels=4),
    "ResNet_A": dict(temporal_stages=(3,), bidirectional=True),
    "RAWResNetA": dict(temporal_stages=(3,), bidirectional=True,
                       in_channels=4),
    "ResNet_B": dict(temporal_stages=(2, 3), bidirectional=True),
    "ResNet_B1": dict(plugin_stages=(2, 3)),
    "ResNetC": dict(plugin_stages=(3,)),
    "ResNetD": dict(plugin_stages=(3,), with_cbam=True),
    "ResNetE": dict(plugin_stages=(2,)),
    "ResNetF": dict(plugin_stages=(1, 2, 3)),
    "ResNetG": dict(plugin_stages=(0, 1, 2, 3)),
    "ResNetH": dict(),  # the plain ResNet
    "InsertResNet": dict(),  # the plain ResNet; pass plugin_stages
}


def make_dark_backbone(variant: str, **overrides) -> DarkResNet:
    """Any dark-backbone variant by its registered name, with ``overrides``
    of its ``DarkResNet`` arguments."""
    if variant not in DARK_VARIANTS:
        raise KeyError(f"unknown dark backbone {variant!r}; "
                       f"known: {sorted(DARK_VARIANTS)}")
    return DarkResNet(**dict(DARK_VARIANTS[variant], **overrides))


for _name in DARK_VARIANTS:  # as the JAX zoo registers them
    BACKBONES.register(_name)(functools.partial(make_dark_backbone, _name))
