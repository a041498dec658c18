"""Feature-space denoising aggregators (RDB + temporal attention fusion with
DCNv2): the counterpart of the JAX package's
``models/aggregators/denoising_aggregator.py`` (``DenseLayer``, ``RDB``,
``ModulatedDCNPack``, ``TemporalAttentionFusion``, ``DenoisingAggregator``,
``Denoising2Aggregator``), with the flax module and parameter names so the
weight bridge maps them by path.

Feature maps are NCHW [T, C, h, w] (T frames of one clip), as the
backbone's stage outputs; the TAF and the single-stage aggregator also take
several clips of ``clip_len`` frames (``clips``; a dark backbone's plugin
streams S clips of one frame) and fuse each clip on its own. Convs compute
in the module's ``dtype`` (weights cast per use, as flax); the DCN's
``weight`` and ``bias`` are raw f32 parameters that are never cast, and
the DCN returns f32, as in JAX. Its offsets are unbounded (the JAX
``dcn_impl="scan"`` semantics; the port has no windowed DCN and no offset
clamp, ROADMAP fault F1). JAX rematerialises the RDBs and the fusion only
to fit a 16 GB chip; the port does not.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.deform_conv import K, modulated_deform_conv
from ..backbones.resnet import Conv2d


def clips(x: torch.Tensor, clip_len: Optional[int]) -> torch.Tensor:
    """Frames [N, ...] -> [N / clip_len, clip_len, ...] (None: one clip)."""
    t = x.shape[0] if clip_len is None else clip_len
    if x.shape[0] % t:
        raise ValueError(f"{x.shape[0]} frames are not clips of {t}")
    return x.reshape(x.shape[0] // t, t, *x.shape[1:])


def _conv3(cin: int, cout: int, dtype, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=1, dtype=dtype)


class DenseLayer(nn.Module):
    """x -> concat(x, relu(conv3x3(x))) along the channels."""

    def __init__(self, in_channels: int, growth: int, dtype=torch.float32):
        super().__init__()
        self.conv = _conv3(in_channels, growth, dtype)

    def forward(self, x):
        return torch.cat([x, F.relu(self.conv(x))], 1)


class RDB(nn.Module):
    """Residual dense block: ``num_layers`` dense layers, a 1x1 local
    fusion (``lff``) back to ``in_channels``, plus the input."""

    def __init__(self, in_channels: int, channel_growth: int = 64,
                 num_layers: int = 3, dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"dense{i}", DenseLayer(
                in_channels + i * channel_growth, channel_growth, dtype))
        self.lff = Conv2d(in_channels + num_layers * channel_growth,
                          in_channels, 1, dtype=dtype)

    def forward(self, x):
        h = x
        for i in range(self.num_layers):
            h = getattr(self, f"dense{i}")(h)
        return x + self.lff(h)


class ModulatedDCNPack(nn.Module):
    """DCNv2 whose offsets and mask come from ``extra_feat`` through
    ``conv_offset`` (G * 27 channels, per group [dy x 9, dx x 9, mask logit
    x 9]; G = gcd(deform_groups, in_channels)). ``conv_offset`` is
    zero-initialised and ``weight`` takes flax's variance_scaling(1,
    fan_in, uniform) (``init_flax``), so a fresh pack is half a plain conv
    (offsets 0, mask sigmoid(0))."""

    def __init__(self, in_channels: int, out_channels: int,
                 extra_channels: int, deform_groups: int = 8,
                 dtype=torch.float32):
        super().__init__()
        self.groups = math.gcd(deform_groups, in_channels)
        self.conv_offset = _conv3(extra_channels, self.groups * 3 * K, dtype)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3,
                                               3))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.init_flax(None)

    @torch.no_grad()
    def init_flax(self, generator: Optional[torch.Generator]):
        """flax's init: ``conv_offset`` zero, ``weight`` uniform within
        sqrt(3 / fan_in) (fan_in = 9 * in_channels), ``bias`` zero."""
        self.conv_offset.weight.zero_()
        self.conv_offset.bias.zero_()
        limit = math.sqrt(3.0 / self.weight[0].numel())
        self.weight.uniform_(-limit, limit, generator=generator)
        self.bias.zero_()

    def forward(self, x, extra_feat, impl: Optional[str] = None):
        """x [T, Cin, h, w], extra_feat [T, C', h, w] -> f32 [T, Cout, h, w].
        ``impl="plain"`` runs the DCN's plain version."""
        t, _, h, w = x.shape
        om = self.conv_offset(extra_feat).reshape(t, self.groups, 3 * K, h, w)
        offset = om[:, :, :2 * K].reshape(t, self.groups * 2 * K, h, w)
        mask = torch.sigmoid(om[:, :, 2 * K:]).reshape(t, self.groups * K,
                                                       h, w)
        return modulated_deform_conv(x, offset, mask, self.weight, self.bias,
                                     impl=impl)


class TemporalAttentionFusion(nn.Module):
    """Per reference frame i of the clip: the offsets from the frames and
    frame i (``offset_conv``), DCN-aligned frames, their correlation with
    frame i through ``emb_nums`` convs, a softmax over the frames and the
    weighted sum; then ``conv2`` back to ``channels``. The Python loop over
    the reference frames keeps one fusion's intermediates live at a time,
    as JAX's."""

    def __init__(self, channels: int, mid_channels: int, emb_nums: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.emb_nums = emb_nums
        self.conv1 = _conv3(channels, mid_channels, dtype)
        self.offset_conv = _conv3(2 * mid_channels, mid_channels, dtype)
        self.dcn_pack = ModulatedDCNPack(mid_channels, mid_channels,
                                         mid_channels, deform_groups=8,
                                         dtype=dtype)
        for i in range(emb_nums):
            self.add_module(f"emb_conv{i}", _conv3(mid_channels, mid_channels,
                                                   dtype))
        self.conv2 = _conv3(mid_channels, channels, dtype)

    def forward(self, x, impl: Optional[str] = None,
                clip_len: Optional[int] = None):
        """x [N, C, h, w] -> [N, C, h, w]: N = clips x ``clip_len`` frames
        (None: one clip), each clip fused on its own."""
        x = F.relu(self.conv1(x))
        xc = clips(x, clip_len)
        fused = []
        for i in range(xc.shape[1]):
            ref = xc[:, i:i + 1].expand_as(xc).flatten(0, 1)
            x_set = self.offset_conv(torch.cat([x, ref], 1))
            h = self.dcn_pack(x, x_set, impl=impl) * ref
            for j in range(self.emb_nums):
                h = getattr(self, f"emb_conv{j}")(h)
            wgt = torch.softmax(h.reshape(xc.shape), 1)
            fused.append((wgt * xc).sum(1))
        return F.relu(self.conv2(torch.stack(fused, 1).flatten(0, 1)))


class DenoisingAggregator(nn.Module):
    """The single-stage aggregator: conv -> RDBs -> TAF -> conv, plus the
    input."""

    def __init__(self, channels: int = 512, mid_channels: int = 128,
                 rdb_blocks: int = 2, rdb_layers: int = 3,
                 channel_growth: int = 64, emb_nums: int = 3,
                 with_rdb: bool = True, with_taf: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.rdb_blocks = rdb_blocks if with_rdb else 0
        self.conv1 = _conv3(channels, channels, dtype)
        for i in range(self.rdb_blocks):
            self.add_module(f"rdb{i}", RDB(channels, channel_growth,
                                           rdb_layers, dtype))
        self.taf = (TemporalAttentionFusion(channels, mid_channels, emb_nums,
                                            dtype) if with_taf else None)
        self.conv2 = _conv3(channels, channels, dtype)

    def forward(self, x, impl: Optional[str] = None,
                clip_len: Optional[int] = None):
        """x [N, C, h, w], N = clips x ``clip_len`` frames (None: one
        clip)."""
        h = F.relu(self.conv1(x))
        for i in range(self.rdb_blocks):
            h = getattr(self, f"rdb{i}")(h)
        if self.taf is not None:
            h = self.taf(h, impl=impl, clip_len=clip_len)
        return x + self.conv2(h)


class Denoising2Aggregator(nn.Module):
    """The multi-stage aggregator (the original's ``Denoising2Aggergator``):
    stage i convolves its noisy stage feature (concatenated, from stage 1
    on, with the previous stage's output), runs the RDBs and the TAF, adds
    the noisy feature back (a denoised stage feature) and convolves that
    (the last stage: without the noisy feature) with stride 2 where
    ``downsample`` says, into ``out_channels[i]``; the last stage's output
    is added to every neck feature."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 mid_channels: Sequence[int] = (64, 128, 256, 512),
                 out_channels: Sequence[int] = (512, 1024, 2048, 512),
                 rdb_blocks: Sequence[int] = (2, 2, 4, 2),
                 channel_growth: Sequence[int] = (64, 64, 64, 64),
                 taf_embs: Sequence[int] = (3, 3, 3, 3),
                 downsample: Sequence[bool] = (True, True, False, False),
                 with_rdb: Sequence[bool] = (True, True, True, True),
                 with_taf: Sequence[bool] = (True, True, True, True),
                 dtype=torch.float32):
        super().__init__()
        self.num_stages = n = len(in_channels)
        self.rdb_blocks = tuple(rdb_blocks[i] if with_rdb[i] else 0
                                for i in range(n))
        self.with_taf = tuple(with_taf)
        for i in range(n):
            cin = in_channels[i] + (out_channels[i - 1] if i else 0)
            self.add_module(f"stage{i}_conv1",
                            _conv3(cin, in_channels[i], dtype))
            for j in range(self.rdb_blocks[i]):
                self.add_module(f"stage{i}_rdb{j}", RDB(
                    in_channels[i], channel_growth[i], dtype=dtype))
            if with_taf[i]:
                self.add_module(f"stage{i}_taf", TemporalAttentionFusion(
                    in_channels[i], mid_channels[i], taf_embs[i], dtype))
            self.add_module(f"stage{i}_conv2", _conv3(
                in_channels[i], out_channels[i], dtype,
                stride=2 if downsample[i] else 1))

    def forward(self, x_noise: Sequence[torch.Tensor],
                all_x: Sequence[torch.Tensor], impl: Optional[str] = None
                ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
        """x_noise: the noisy stage features [T, C_i, h_i, w_i]; all_x: the
        neck features (NCHW). Returns (denoised stage features, neck
        features plus the last stage's output). ``impl="plain"`` runs the
        DCN's plain version."""
        outs, prev = [], None
        for i in range(self.num_stages):
            f = x_noise[i] if i == 0 else torch.cat([x_noise[i], prev], 1)
            x = getattr(self, f"stage{i}_conv1")(f)
            for j in range(self.rdb_blocks[i]):
                x = getattr(self, f"stage{i}_rdb{j}")(x)
            if self.with_taf[i]:
                x = getattr(self, f"stage{i}_taf")(x, impl=impl)
            outs.append(x + x_noise[i])
            last = i == self.num_stages - 1
            prev = getattr(self, f"stage{i}_conv2")(x if last else outs[-1])
        return tuple(outs), tuple(all_x[-1] + prev for _ in all_x)
