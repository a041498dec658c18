"""The paper's low-light training method, the counterpart of the JAX
package's ``models/vid/selsa_darkfarm.py`` (``DarkfarmConfig``,
``SelsaDarkfarmDetector``, ``DarkfarmBatch``, ``darkfarm_loss``,
``make_darkfarm``), with the Denoising2Aggregator of
``SelsaNewDarkfarmDetect`` (``with_aggregator=True``).

Each training sample is a key frame and R reference frames of
channel-concatenated (noise, clean) pairs ([1+R, H, W, 2C]; C = 3 for sRGB,
4 for RAW). The detector's backbone runs on the noisy half with duplicated
``out_indices`` (e.g. (0, 1, 2, 3, 3)): the first entries feed the feature
consistency loss, the last the neck. The frozen ResCleaner runs on the clean
half; an L1, L2 or SmoothL1 loss ties each noisy stage to the clean one,
over all frames, in f32. Then the SELSA RPN and RoI losses on the noisy
features. ``branch="clean"`` trains on the clean half without the feature
loss, ``with_cleaner=False`` without the cleaner.

With the aggregator (``aggregator``, a ``Denoising2Aggregator`` over the
loss stages) the denoised neck feature replaces the neck feature, and each
loss stage's feature loss is taken on the undenoised (``_u``) and the
denoised (``_d``) stage feature, as ``dual_branch`` says.

At test time the clean branch and the aggregator play no part: the
``selsa`` detector streams noisy frames through ``models/vid/selsa.py``
(``apis.inference.init_model`` takes a darkfarm state dict and keeps its
``selsa.`` entries), as the JAX package's streaming does (ROADMAP F7; the
original's test memo also keeps denoised features).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ...core import losses
from ..aggregators.denoising_aggregator import Denoising2Aggregator
from ..cleaners.resclean import ResCleaner
from .selsa import (LossUniforms, SelsaConfig, SelsaDetector, detection_loss,
                    loss_uniforms, place)

FEATURE_LOSSES = {"l1": losses.l1_loss, "l2": losses.mse_loss,
                  "smooth_l1": losses.smooth_l1_loss}


@dataclasses.dataclass(frozen=True)
class DarkfarmConfig:
    """Field names and defaults follow the JAX ``DarkfarmConfig``. The JAX
    default's ``remat=True`` only saved device memory; the port keeps no
    cleaner activations (its forward runs without gradient) and has no
    remat. It has no ``agg_dcn_impl`` and no ``agg_dcn_radius``: those pick
    the TPU's windowed DCN and its offset clamp, and the port's DCN is the
    JAX ``'scan'`` form with unbounded offsets (ROADMAP fault F1)."""

    selsa: SelsaConfig = SelsaConfig(num_classes=8,  # DarkFarm's classes
                                     out_indices=(0, 1, 2, 3, 3))
    loss_type: str = "l1"  # 'l1' | 'l2' | 'smooth_l1'
    with_cleaner: bool = True
    in_channels: int = 3  # 4 for RAW (8-channel pairs)
    # SelsaNewDarkfarmDetect: a Denoising2Aggregator between the backbone
    # and the heads, with the dual feature losses `_u` and `_d`
    with_aggregator: bool = False
    # the aggregator's ablations (llvod_l1234_fusion_add_i1234[_rdb][_taf])
    agg_rdb: bool = True
    agg_taf: bool = True
    # the feature losses with the aggregator: 'both', 'u' (undenoised
    # only, llvod_l1234u_*) or 'd' (denoised only, llvod_l1234d_*)
    dual_branch: str = "both"

    def __post_init__(self):
        if self.loss_type not in FEATURE_LOSSES:
            raise ValueError(f"unknown loss_type {self.loss_type!r}")
        if self.dual_branch not in ("both", "u", "d"):
            raise ValueError(f"unknown dual_branch {self.dual_branch!r}")

    @property
    def loss_stages(self):
        """All but the last (neck-input) entry feed the feature loss."""
        return tuple(self.selsa.out_indices[:-1])

    @property
    def stage_channels(self):
        """The loss stages' widths (bottleneck depths expand 4x)."""
        expansion = 4 if self.selsa.depth >= 50 else 1
        return tuple(64 * expansion * 2 ** i for i in self.loss_stages)


# DC5 strides of the backbone's stages
STAGE_STRIDE = {0: 4, 1: 8, 2: 16, 3: 16}


class SelsaDarkfarmDetector(nn.Module):
    """The SELSA detector (``selsa``), the frozen cleaner (``cleaner``) and
    the Denoising2Aggregator (``aggregator``) in one module, named as the
    flax tree. The detector's backbone takes the pairs' ``in_channels``
    (flax shapes it from the data)."""

    def __init__(self, cfg: DarkfarmConfig = DarkfarmConfig()):
        super().__init__()
        self.cfg = cfg
        self.selsa = SelsaDetector(dataclasses.replace(
            cfg.selsa, backbone_in_channels=cfg.in_channels))
        if cfg.with_cleaner:
            self.cleaner = ResCleaner(cfg.selsa.depth, cfg.in_channels,
                                      cfg.loss_stages,
                                      dtype=cfg.selsa.compute_dtype)
        if cfg.with_aggregator:
            stages, chans = cfg.loss_stages, cfg.stage_channels
            n = len(chans)
            # downsample where the next stage halves the resolution; each
            # stage's output has the next stage's width, the last the neck's
            self.aggregator = Denoising2Aggregator(
                in_channels=chans,
                mid_channels=tuple(max(c // 4, 64) for c in chans),
                out_channels=chans[1:] + (cfg.selsa.neck_channels,),
                rdb_blocks=(2,) * n, channel_growth=(64,) * n,
                taf_embs=(3,) * n,
                downsample=tuple(
                    i + 1 < n
                    and STAGE_STRIDE[stages[i + 1]] > STAGE_STRIDE[stages[i]]
                    for i in range(n)),
                with_rdb=(cfg.agg_rdb,) * n, with_taf=(cfg.agg_taf,) * n,
                dtype=cfg.selsa.compute_dtype)

    def denoise_feats(self, stage_feats, neck_feat,
                      impl: Optional[str] = None):
        """The aggregator on the stage features (NCHW) and the neck feature
        [T, h, w, C]: (denoised stage features, denoised neck feature
        [T, h, w, C]). ``impl="plain"`` runs the DCN's plain version."""
        stages, necks = self.aggregator(
            list(stage_feats), [neck_feat.permute(0, 3, 1, 2)], impl=impl)
        return stages, necks[0].permute(0, 2, 3, 1).contiguous()


class DarkfarmBatch(NamedTuple):
    """A key frame and R reference frames of (noise, clean) pairs."""

    pair_imgs: torch.Tensor  # [1+R, H, W, 2C]; index 0 = key
    img_shape: torch.Tensor  # [2]
    gt_boxes: torch.Tensor  # [G, 4] key-frame gts (padded)
    gt_labels: torch.Tensor  # [G] int64
    gt_valid: torch.Tensor  # [G] bool


def feature_branches(cfg: DarkfarmConfig, stages, denoised=None):
    """The stage features the feature loss supervises, with their metric
    suffixes: the stages (no suffix) without the aggregator; with it the
    undenoised (``_u``) and / or the denoised (``_d``) stages, as
    ``cfg.dual_branch`` says."""
    if denoised is None:
        return [("", stages)]
    return [(f"_{tag}", feats) for tag, feats in (("u", stages),
                                                  ("d", denoised))
            if cfg.dual_branch in ("both", tag)]


def darkfarm_loss(model: SelsaDarkfarmDetector, batch: DarkfarmBatch,
                  anchors: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  uniforms: Optional[LossUniforms] = None,
                  branch: str = "noise", impl: Optional[str] = None):
    """Single-sample training loss: the feature consistency losses
    (``loss_{loss_type}_{i}``, one plain mean per loss stage, f32; with the
    aggregator ``loss_{loss_type}_{i}_u`` on the undenoised and
    ``..._d`` on the denoised stage, as ``dual_branch`` says) plus
    ``selsa_loss``'s RPN and RoI losses on the detector's features (the
    denoised neck feature with the aggregator; TemporalRoIAlign for the key
    rois when the config asks for it). Returns (total, metrics).

    The samplers use ``uniforms``, or else draw them from ``generator``;
    the proposals carry no gradient (ROADMAP fault F6, as ``selsa_loss``).
    ``impl="plain"`` runs the plain versions of RoIAlign and the DCN (for
    comparisons only)."""
    if branch not in ("noise", "clean"):
        raise ValueError(f"unknown branch {branch!r}")
    cfg, detector = model.cfg, model.selsa
    c = cfg.in_channels
    uniforms = loss_uniforms(detector.cfg, batch.gt_boxes.shape[0], anchors,
                             generator, uniforms)
    noise, clean = batch.pair_imgs[..., :c], batch.pair_imgs[..., c:]
    # the key and its references are one clip, key first: a dark
    # backbone's ConvLSTM starts at the key
    stages, neck = detector.extract_feats(
        noise if branch == "noise" else clean, impl=impl)
    denoised = None
    if cfg.with_aggregator:
        denoised, neck = model.denoise_feats(stages, neck, impl=impl)
    metrics, total = {}, 0.0
    if cfg.with_cleaner and branch == "noise":
        feature_loss = FEATURE_LOSSES[cfg.loss_type]
        branches = feature_branches(cfg, stages, denoised)
        for i, target in enumerate(model.cleaner(clean)):
            target = target.float()
            for suffix, feats in branches:
                loss = feature_loss(feats[i].float(), target)
                metrics[f"loss_{cfg.loss_type}_{i}{suffix}"] = loss
                total = total + loss
    total, det = detection_loss(detector, neck, batch, anchors, uniforms,
                                impl=impl, total=total)
    metrics.update(det)
    return total, metrics


def make_darkfarm(cfg: Optional[DarkfarmConfig] = None,
                  generator: Optional[torch.Generator] = None, device=None):
    """(model, anchors): ``SelsaDarkfarmDetector`` with seeded flax-style
    weights from ``generator`` (a CPU generator; None leaves PyTorch's
    init), on ``device`` (None: the card, raising without one; pass
    ``device="cpu"`` for the CPU)."""
    cfg = cfg or DarkfarmConfig()
    return place(SelsaDarkfarmDetector(cfg), cfg.selsa, generator, device)
