"""SiamRPN++ single-object tracking (inference), the counterpart of the JAX
package's ``models/sot/siamrpn.py`` (mmtracking's ``correlation.py``,
``siamese_rpn_head.py`` and ``sot/siamrpn.py``): a dilated ResNet-50
(stages 2-4 at stride 8) and a 1x1 ChannelMapper give three levels; on
each, a ``CorrelationHead`` correlates the template's center 7x7 with the
search crop depthwise; the levels are fused with softmaxed weights; the
track step penalises scale and ratio changes, adds a Hanning window and
moves the box to the best anchor.

All float32, NHWC between modules as in JAX (the convs run NCHW inside).
Traps kept from the flax modules: ``nn.LayerNorm`` normalises each pixel
over its channels with eps 1e-6 and the variance as E[x^2] - E[x]^2; the
head's [H, W, 2A] output flattens to (H*W*A, 2) in HWC order; the
correlation is a cross-correlation; the crops pad with the frame's
per-channel mean by shifting the frame before resampling
(``ops/scale_translate.py``, antialiased as in JAX: ROADMAP fault F14).

Training: ``siamrpn_loss`` is the pair loss of a template and a search
crop (the JAX ``siamrpn_loss``); its two samplers take their uniforms as an
argument, as ``core/assigners.py`` does, so a test feeds both sides the
same draws.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import boxes as box_ops
from ...core.assigners import _rank_by_random
from ...ops.scale_translate import scale_and_translate
from ..backbones.resnet import Conv2d, ResNet

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def depthwise_correlation(search: torch.Tensor, kernel: torch.Tensor
                          ) -> torch.Tensor:
    """search [H, W, C], kernel [h, w, C] -> [H-h+1, W-w+1, C]: per-channel
    valid cross-correlation in float32."""
    c = search.shape[-1]
    out = F.conv2d(search.float().permute(2, 0, 1)[None],
                   kernel.float().permute(2, 0, 1)[:, None], groups=c)
    return out[0].permute(1, 2, 0)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: y = (x - mean) /
    sqrt(E[x^2] - mean^2 + eps) * weight + bias."""

    def __init__(self, channels: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


def _conv_hwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An NCHW conv on one [H, W, C] map."""
    return conv(x.permute(2, 0, 1)[None])[0].permute(1, 2, 0)


class CorrelationHead(nn.Module):
    def __init__(self, in_channels: int = 256, mid_channels: int = 256,
                 out_channels: int = 10):
        super().__init__()
        self.kernel_conv = Conv2d(in_channels, mid_channels, 3, bias=False)
        self.kernel_norm = LayerNorm(mid_channels)
        self.search_conv = Conv2d(in_channels, mid_channels, 3, bias=False)
        self.search_norm = LayerNorm(mid_channels)
        self.head_conv1 = Conv2d(mid_channels, mid_channels, 1)
        self.head_norm = LayerNorm(mid_channels)
        self.head_conv2 = Conv2d(mid_channels, out_channels, 1)

    def forward(self, kernel: torch.Tensor, search: torch.Tensor
                ) -> torch.Tensor:
        """kernel [h, w, C] template feature, search [H, W, C] -> [H', W',
        out_channels]."""
        k = F.relu(self.kernel_norm(_conv_hwc(self.kernel_conv, kernel)))
        s = F.relu(self.search_norm(_conv_hwc(self.search_conv, search)))
        corr = depthwise_correlation(s, k)
        h = F.relu(self.head_norm(_conv_hwc(self.head_conv1, corr)))
        return _conv_hwc(self.head_conv2, h)


@dataclasses.dataclass(frozen=True)
class SiamRPNConfig:
    exemplar_size: int = 127
    search_size: int = 255
    context_amount: float = 0.5
    feat_channels: int = 256
    anchor_scales: Tuple[int, ...] = (8,)
    anchor_ratios: Tuple[float, ...] = (0.33, 0.5, 1.0, 2.0, 3.0)
    anchor_stride: int = 8
    num_levels: int = 3  # backbone stages 2, 3, 4
    penalty_k: float = 0.05
    window_influence: float = 0.42
    lr: float = 0.38

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_scales) * len(self.anchor_ratios)

    @property
    def score_size(self) -> int:
        """The correlation map's side: the search crop at stride 8 (the
        stem's conv and pool, stage 2's stride), less the 3x3 valid convs
        and the 7x7 template crop's."""
        s = self.search_size
        for k, p in ((7, 3), (3, 1), (3, 1)):  # conv1, max pool, layer2
            s = (s + 2 * p - k) // 2 + 1
        return s - 2 - (7 - 2) + 1


class ChannelMapper(nn.Module):
    """One 1x1 conv per level to ``out_channels`` (flax names ``conv{i}``)."""

    def __init__(self, in_channels: Tuple[int, ...], out_channels: int):
        super().__init__()
        self.num_levels = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"conv{i}", Conv2d(c, out_channels, 1))

    def forward(self, feats):
        return tuple(getattr(self, f"conv{i}")(x)
                     for i, x in enumerate(feats))


class SiamRPN(nn.Module):
    def __init__(self, cfg: SiamRPNConfig = SiamRPNConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.backbone = ResNet(depth=50, strides=(1, 2, 1, 1),
                               dilations=(1, 1, 2, 4), out_indices=(1, 2, 3),
                               frozen_stages=1)
        self.neck = ChannelMapper((512, 1024, 2048)[-c.num_levels:],
                                  c.feat_channels)
        for i in range(c.num_levels):
            self.add_module(f"cls_head{i}", CorrelationHead(
                c.feat_channels, c.feat_channels, 2 * c.num_anchors))
            self.add_module(f"reg_head{i}", CorrelationHead(
                c.feat_channels, c.feat_channels, 4 * c.num_anchors))
        self.cls_weights = nn.Parameter(torch.ones(c.num_levels))
        self.reg_weights = nn.Parameter(torch.ones(c.num_levels))

    def extract_feat(self, img: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """img [N, H, W, 3] -> per-level neck features [N, h, w, C]."""
        feats = self.neck(self.backbone(img.permute(0, 3, 1, 2)))
        return tuple(f.permute(0, 2, 3, 1) for f in feats)

    def forward_heads(self, z_feats, x_feats):
        """Per-level template and search features [h, w, C] -> fused (cls
        [H, W, 2A], reg [H, W, 4A]) with the softmaxed level weights."""
        cls_w = torch.softmax(self.cls_weights, 0)
        reg_w = torch.softmax(self.reg_weights, 0)
        cls_out = reg_out = 0.0
        for i in range(self.cfg.num_levels):
            z = z_feats[i]
            ch, cw = z.shape[0] // 2, z.shape[1] // 2
            zc = z[ch - 3:ch + 4, cw - 3:cw + 4]  # center 7x7
            cls_out = cls_out + cls_w[i] * getattr(self, f"cls_head{i}")(
                zc, x_feats[i])
            reg_out = reg_out + reg_w[i] * getattr(self, f"reg_head{i}")(
                zc, x_feats[i])
        return cls_out, reg_out

    def forward(self, z_img, x_img):
        z_feats = tuple(f[0] for f in self.extract_feat(z_img))
        x_feats = tuple(f[0] for f in self.extract_feat(x_img))
        return self.forward_heads(z_feats, x_feats)


def crop_around(img: torch.Tensor, center_xy, crop_size, out_size: int,
                pad_value: torch.Tensor) -> torch.Tensor:
    """The square crop of side ``crop_size`` centred at ``center_xy`` (0-d
    tensors), resampled to ``out_size`` (mmtrack's ``get_cropped_img``):
    outside the frame it takes ``pad_value`` [C]."""
    scale = out_size / crop_size
    half = torch.full((2,), out_size / 2, dtype=torch.float32,
                      device=img.device)
    translation = half - torch.stack([center_xy[1], center_xy[0]]) * scale
    out = scale_and_translate(img - pad_value, (out_size, out_size),
                              torch.stack([scale, scale]), translation)
    return out + pad_value


def exemplar_crop_size(bbox_cxcywh: torch.Tensor, context_amount: float):
    """z_size = sqrt((w + p)(h + p)), p = (w + h) * context."""
    w, h = bbox_cxcywh[2], bbox_cxcywh[3]
    pad = (w + h) * context_amount
    return torch.sqrt((w + pad) * (h + pad))


def sot_grid_anchors(cfg: SiamRPNConfig, score_size: int) -> np.ndarray:
    """[H*W*A, 4] cxcywh anchors centred on the correlation map
    (mmtrack's ``sot_anchor_generator.py``)."""
    a = []
    for r in cfg.anchor_ratios:
        for s in cfg.anchor_scales:
            base = cfg.anchor_stride * s
            a.append([base / np.sqrt(r), base * np.sqrt(r)])
    wh = np.asarray(a, np.float32)  # [A, 2]
    disp = (np.arange(score_size, dtype=np.float32) - (score_size - 1) / 2) \
        * cfg.anchor_stride
    gx, gy = np.meshgrid(disp, disp)
    centers = np.stack([gx.ravel(), gy.ravel()], -1)  # [HW, 2]
    return np.concatenate([np.repeat(centers, len(wh), axis=0),
                           np.tile(wh, (score_size * score_size, 1))], axis=1)


def hanning_window(score_size: int, num_anchors: int) -> np.ndarray:
    w = np.hanning(score_size)
    return np.repeat(np.outer(w, w).ravel(), num_anchors).astype(np.float32)


class SOTState(NamedTuple):
    z_feats: Tuple[torch.Tensor, ...]  # per-level template features
    bbox: torch.Tensor  # [4] cxcywh in image coords


@torch.no_grad()
def sot_init(model: SiamRPN, img: torch.Tensor, bbox_xyxy) -> SOTState:
    """Template from the frame img [H, W, 3] and its box (mmtrack's
    ``init``)."""
    cfg = model.cfg
    b = torch.as_tensor(bbox_xyxy, dtype=torch.float32, device=img.device)
    cxcywh = torch.stack([(b[0] + b[2]) / 2, (b[1] + b[3]) / 2,
                          b[2] - b[0], b[3] - b[1]])
    z_size = exemplar_crop_size(cxcywh, cfg.context_amount)
    mean = img.float().mean(dim=(0, 1))
    z_crop = crop_around(img, cxcywh[:2], z_size, cfg.exemplar_size, mean)
    z_feats = model.extract_feat(z_crop[None])
    return SOTState(tuple(f[0] for f in z_feats), cxcywh)


@torch.no_grad()
def sot_track(model: SiamRPN, state: SOTState, img: torch.Tensor,
              anchors: torch.Tensor, window: torch.Tensor):
    """One tracked frame (mmtrack's ``track``). Returns (new state, best
    score, best index, box xyxy [4]), all on the frame's device."""
    cfg = model.cfg
    prev = state.bbox
    z_size = exemplar_crop_size(prev, cfg.context_amount)
    x_size = z_size * cfg.search_size / cfg.exemplar_size
    scale = cfg.exemplar_size / z_size
    mean = img.float().mean(dim=(0, 1))
    x_crop = crop_around(img, prev[:2], x_size, cfg.search_size, mean)
    x_feats = model.extract_feat(x_crop[None])
    cls, reg = model.forward_heads(state.z_feats,
                                   tuple(f[0] for f in x_feats))
    n = cls.shape[0] * cls.shape[1] * cfg.num_anchors
    scores = torch.softmax(cls.reshape(n, 2), -1)[:, 1]
    deltas = reg.reshape(n, 4)
    anc_xyxy = torch.stack([
        anchors[:, 0] - anchors[:, 2] / 2, anchors[:, 1] - anchors[:, 3] / 2,
        anchors[:, 0] + anchors[:, 2] / 2, anchors[:, 1] + anchors[:, 3] / 2],
        dim=1)
    pred = box_ops.delta2bbox(anc_xyxy, deltas)
    pw = pred[:, 2] - pred[:, 0]
    ph = pred[:, 3] - pred[:, 1]
    pcx = (pred[:, 0] + pred[:, 2]) / 2
    pcy = (pred[:, 1] + pred[:, 3]) / 2

    def change(r):
        return torch.maximum(r, 1.0 / r)

    def ssz(w, h):
        pad = (w + h) * 0.5
        return torch.sqrt((w + pad) * (h + pad))

    s_c = change(ssz(pw, ph) / ssz(prev[2] * scale, prev[3] * scale))
    r_c = change((prev[2] / prev[3]) / (pw / ph))
    penalty = torch.exp(-(r_c * s_c - 1.0) * cfg.penalty_k)
    pscore = penalty * scores
    pscore = pscore * (1 - cfg.window_influence) \
        + window * cfg.window_influence
    best = torch.argmax(pscore)
    best_score = scores[best]
    lr = penalty[best] * best_score * cfg.lr
    # the predicted box is relative to the crop centre at ``scale``
    new_cx = prev[0] + pcx[best] / scale
    new_cy = prev[1] + pcy[best] / scale
    new_w = prev[2] * (1 - lr) + (pw[best] / scale) * lr
    new_h = prev[3] * (1 - lr) + (ph[best] / scale) * lr
    h_img, w_img = img.shape[0], img.shape[1]
    new_cx = torch.clamp(new_cx, 0, w_img)
    new_cy = torch.clamp(new_cy, 0, h_img)
    new_w = torch.clamp(new_w, 10, w_img)
    new_h = torch.clamp(new_h, 10, h_img)
    new_bbox = torch.stack([new_cx, new_cy, new_w, new_h])
    xyxy = torch.stack([new_cx - new_w / 2, new_cy - new_h / 2,
                        new_cx + new_w / 2, new_cy + new_h / 2])
    return SOTState(state.z_feats, new_bbox), best_score, best, xyxy


def cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    """[..., 4] (cx, cy, w, h) -> [..., 4] (x1, y1, x2, y2)."""
    return torch.stack([b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2,
                        b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2],
                       dim=-1)


def siamrpn_loss(model: SiamRPN, z_img: torch.Tensor, x_img: torch.Tensor,
                 gt_cxcywh, anchors: torch.Tensor, is_positive_pair,
                 uniforms: torch.Tensor, pos_iou_thr: float = 0.6,
                 neg_iou_thr: float = 0.3, num_pos: int = 16,
                 num_total: int = 64):
    """The pair training loss (mmtrack's ``siamese_rpn_head`` targets and
    loss): z_img [1, 127, 127, 3] and x_img [1, 255, 255, 3] normalized
    crops, the search crop's gt (cx, cy, w, h) in the anchors' frame,
    anchors [H*W*A, 4] cxcywh. Positive candidates are anchors with IoU
    above ``pos_iou_thr`` on a positive pair; negative ones those below
    ``neg_iou_thr``, and every anchor of a negative pair. Up to
    ``num_pos`` positives are sampled in the order of ``uniforms[0]``, then
    negatives in the order of ``uniforms[1]`` up to ``num_total``
    (``uniforms`` [2, H*W*A] in [0, 1)). Cross entropy over the sampled
    anchors, L1 over the positives' deltas; total = cls + 1.2 bbox.
    Returns (total, metrics)."""
    cls, reg = model(z_img, x_img)
    n = cls.shape[0] * cls.shape[1] * model.cfg.num_anchors
    logits = cls.reshape(n, 2).float()
    deltas = reg.reshape(n, 4).float()
    dev = logits.device
    anc_xyxy = cxcywh_to_xyxy(anchors.float())
    gt_xyxy = cxcywh_to_xyxy(torch.as_tensor(
        gt_cxcywh, dtype=torch.float32, device=dev))[None]
    ious = box_ops.bbox_overlaps(anc_xyxy, gt_xyxy)[:, 0]
    positive = torch.as_tensor(is_positive_pair, dtype=torch.bool,
                               device=dev)
    pos_cand = (ious > pos_iou_thr) & positive
    neg_cand = (ious < neg_iou_thr) | (~positive & (ious >= 0))
    pos_sel = pos_cand & (_rank_by_random(pos_cand, uniforms[0]) < num_pos)
    n_pos = pos_sel.sum()
    neg_sel = neg_cand & (_rank_by_random(neg_cand, uniforms[1])
                          < num_total - n_pos)
    weights = (pos_sel | neg_sel).float()
    logp = F.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, 1, pos_sel.long()[:, None])[:, 0]
    loss_cls = (ce * weights).sum() / weights.sum().clamp_min(1.0)
    targets = box_ops.bbox2delta(anc_xyxy, gt_xyxy.expand_as(anc_xyxy))
    l1 = (deltas - targets).abs().sum(-1)
    loss_bbox = (l1 * pos_sel).sum() / n_pos.float().clamp_min(1.0)
    total = loss_cls + 1.2 * loss_bbox
    return total, {"loss": total, "loss_rpn_cls": loss_cls,
                   "loss_rpn_bbox": loss_bbox}
