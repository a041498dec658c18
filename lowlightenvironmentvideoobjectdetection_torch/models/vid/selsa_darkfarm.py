"""The paper's low-light training method, the counterpart of the JAX
package's ``models/vid/selsa_darkfarm.py`` (``DarkfarmConfig``,
``SelsaDarkfarmDetector``, ``DarkfarmBatch``, ``darkfarm_loss``,
``make_darkfarm``) without the Denoising2Aggregator.

Each training sample is a key frame and R reference frames of
channel-concatenated (noise, clean) pairs ([1+R, H, W, 2C]; C = 3 for sRGB,
4 for RAW). The detector's backbone runs on the noisy half with duplicated
``out_indices`` (e.g. (0, 1, 2, 3, 3)): the first entries feed the feature
consistency loss, the last the neck. The frozen ResCleaner runs on the clean
half; an L1, L2 or SmoothL1 loss ties each noisy stage to the clean one,
over all frames, in f32. Then the SELSA RPN and RoI losses on the noisy
features. ``branch="clean"`` trains on the clean half without the feature
loss, ``with_cleaner=False`` without the cleaner.

At test time the clean branch plays no part: the ``selsa`` detector streams
noisy frames through ``models/vid/selsa.py`` (``apis.inference.init_model``
takes a darkfarm state dict and keeps its ``selsa.`` entries).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ...core import losses
from ...utils.device import resolve_device
from ..cleaners.resclean import ResCleaner
from .selsa import (LossUniforms, SelsaConfig, SelsaDetector, detection_loss,
                    init_params, loss_uniforms, make_anchors)

FEATURE_LOSSES = {"l1": losses.l1_loss, "l2": losses.mse_loss,
                  "smooth_l1": losses.smooth_l1_loss}


@dataclasses.dataclass(frozen=True)
class DarkfarmConfig:
    """Field names and defaults follow the JAX ``DarkfarmConfig`` (the
    subset without the aggregator). The JAX default's ``remat=True`` only
    saved device memory; the port keeps no cleaner activations (its
    forward runs without gradient) and has no remat."""

    selsa: SelsaConfig = SelsaConfig(num_classes=8,  # DarkFarm's classes
                                     out_indices=(0, 1, 2, 3, 3))
    loss_type: str = "l1"  # 'l1' | 'l2' | 'smooth_l1'
    with_cleaner: bool = True
    in_channels: int = 3  # 4 for RAW (8-channel pairs)
    with_aggregator: bool = False

    def __post_init__(self):
        if self.with_aggregator:
            raise NotImplementedError(
                "the Denoising2Aggregator is not ported yet (ROADMAP Queue 1 "
                "item 2.3)")
        if self.loss_type not in FEATURE_LOSSES:
            raise ValueError(f"unknown loss_type {self.loss_type!r}")

    @property
    def loss_stages(self):
        """All but the last (neck-input) entry feed the feature loss."""
        return tuple(self.selsa.out_indices[:-1])


class SelsaDarkfarmDetector(nn.Module):
    """The SELSA detector (``selsa``) and the frozen cleaner (``cleaner``)
    in one module, named as the flax tree. The detector's backbone takes the
    pairs' ``in_channels`` (flax shapes it from the data)."""

    def __init__(self, cfg: DarkfarmConfig = DarkfarmConfig()):
        super().__init__()
        self.cfg = cfg
        self.selsa = SelsaDetector(dataclasses.replace(
            cfg.selsa, backbone_in_channels=cfg.in_channels))
        if cfg.with_cleaner:
            self.cleaner = ResCleaner(cfg.selsa.depth, cfg.in_channels,
                                      cfg.loss_stages,
                                      dtype=cfg.selsa.compute_dtype)


class DarkfarmBatch(NamedTuple):
    """A key frame and R reference frames of (noise, clean) pairs."""

    pair_imgs: torch.Tensor  # [1+R, H, W, 2C]; index 0 = key
    img_shape: torch.Tensor  # [2]
    gt_boxes: torch.Tensor  # [G, 4] key-frame gts (padded)
    gt_labels: torch.Tensor  # [G] int64
    gt_valid: torch.Tensor  # [G] bool


def darkfarm_loss(model: SelsaDarkfarmDetector, batch: DarkfarmBatch,
                  anchors: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  uniforms: Optional[LossUniforms] = None,
                  branch: str = "noise", impl: Optional[str] = None):
    """Single-sample training loss: the feature consistency losses
    (``loss_{loss_type}_{i}``, one plain mean per loss stage, f32) plus
    ``selsa_loss``'s RPN and RoI losses on the detector's features (with
    TemporalRoIAlign for the key rois when the config asks for it).
    Returns (total, metrics).

    The samplers use ``uniforms``, or else draw them from ``generator``;
    the proposals carry no gradient (ROADMAP fault F6, as ``selsa_loss``).
    ``impl="plain"`` runs RoIAlign's plain version (for comparisons
    only)."""
    if branch not in ("noise", "clean"):
        raise ValueError(f"unknown branch {branch!r}")
    cfg, detector = model.cfg, model.selsa
    c = cfg.in_channels
    uniforms = loss_uniforms(detector.cfg, batch.gt_boxes.shape[0], anchors,
                             generator, uniforms)
    noise, clean = batch.pair_imgs[..., :c], batch.pair_imgs[..., c:]
    stages, neck = detector.extract_feats(noise if branch == "noise"
                                          else clean)
    metrics, total = {}, 0.0
    if cfg.with_cleaner and branch == "noise":
        feature_loss = FEATURE_LOSSES[cfg.loss_type]
        for i, target in enumerate(model.cleaner(clean)):
            loss = feature_loss(stages[i].float(), target.float())
            metrics[f"loss_{cfg.loss_type}_{i}"] = loss
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
    device = resolve_device(device)
    model = SelsaDarkfarmDetector(cfg)
    if generator is not None:
        init_params(model, generator)
    return model.to(device), make_anchors(cfg.selsa, device)
