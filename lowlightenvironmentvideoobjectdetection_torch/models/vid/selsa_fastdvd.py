"""The denoise-then-detect baselines (``SelsaFastDVDnetDetect``), the
counterpart of the JAX package's ``models/vid/selsa_fastdvd.py``
(``FastDVDSelsaConfig``, ``FastDVDSelsaDetector``, ``FastDVDBatch``,
``fastdvd_selsa_loss``, ``make_fastdvd_selsa``): an image-space denoiser
(``denoiser``: FastDVDnet over each frame's edge-replicated 5-frame window,
or a per-frame U-Net) in front of a SELSA detector (``selsa``), which
trains on the denoised frames; an optional L2 fidelity loss ties the
denoised frames to the clean ones.

At test time the JAX package streams only the ``selsa`` detector, on the
noisy frames: its test CLI drops the ``denoiser`` key and its
``init_model`` keeps the ``selsa`` subtree of a checkpoint (the original
denoises at test time too; ROADMAP F11). The port follows the JAX package
(``apis.inference.detector_state`` keeps the ``selsa.`` entries).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ...core import losses
from ..cleaners.video_denoisers import FastDVDnet, Unet, fastdvd_denoise_clip
from .selsa import (LossUniforms, SelsaConfig, SelsaDetector, TrainBatch,
                    place, selsa_loss)

DENOISERS = {"fastdvd": FastDVDnet, "unet": Unet}


@dataclasses.dataclass(frozen=True)
class FastDVDSelsaConfig:
    """Field names and defaults follow the JAX ``FastDVDSelsaConfig``."""

    selsa: SelsaConfig = SelsaConfig(num_classes=8)
    # weight of the L2 fidelity loss against the clean frames (0: detection
    # only)
    denoise_loss_weight: float = 1.0
    in_channels: int = 3
    # 'fastdvd' (5-frame video denoiser) or 'unet' (per-frame baseline)
    denoiser: str = "fastdvd"

    def __post_init__(self):
        if self.denoiser not in DENOISERS:
            raise ValueError(f"unknown denoiser {self.denoiser!r}")


class FastDVDSelsaDetector(nn.Module):
    """The denoiser (``denoiser``, f32) and the SELSA detector (``selsa``),
    named as the flax tree."""

    def __init__(self, cfg: FastDVDSelsaConfig = FastDVDSelsaConfig()):
        super().__init__()
        self.cfg = cfg
        self.denoiser = DENOISERS[cfg.denoiser]()
        self.selsa = SelsaDetector(cfg.selsa)

    def denoise_clip(self, frames: torch.Tensor) -> torch.Tensor:
        """frames [T, H, W, 3] -> denoised [T, H, W, 3] (f32)."""
        if self.cfg.denoiser == "unet":
            return self.denoiser(frames.permute(0, 3, 1, 2)).permute(
                0, 2, 3, 1)
        return fastdvd_denoise_clip(self.denoiser, frames)


class FastDVDBatch(NamedTuple):
    """A key frame and R reference frames of (noise, clean) pairs."""

    pair_imgs: torch.Tensor  # [1+R, H, W, 2C]; index 0 = key
    img_shape: torch.Tensor  # [2]
    gt_boxes: torch.Tensor  # [G, 4] key-frame gts (padded)
    gt_labels: torch.Tensor  # [G] int64
    gt_valid: torch.Tensor  # [G] bool


def fastdvd_selsa_loss(model: FastDVDSelsaDetector, batch: FastDVDBatch,
                       anchors: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       uniforms: Optional[LossUniforms] = None,
                       impl: Optional[str] = None):
    """``selsa_loss`` on the denoised noisy frames plus, with a positive
    ``denoise_loss_weight``, ``loss_denoise`` = the weight times the mean
    squared error of the denoised frames against the clean ones; ``loss``
    is then the total. Returns (total, metrics). ``generator``,
    ``uniforms`` and ``impl`` as in ``selsa_loss``."""
    cfg = model.cfg
    c = cfg.in_channels
    noise, clean = batch.pair_imgs[..., :c], batch.pair_imgs[..., c:]
    den = model.denoise_clip(noise)
    total, metrics = selsa_loss(
        model.selsa, TrainBatch(den, batch.img_shape, batch.gt_boxes,
                                batch.gt_labels, batch.gt_valid),
        anchors, generator=generator, uniforms=uniforms, impl=impl)
    if cfg.denoise_loss_weight > 0:
        dn = losses.mse_loss(den, clean.float()) * cfg.denoise_loss_weight
        metrics["loss_denoise"] = dn
        total = total + dn
        metrics["loss"] = total
    return total, metrics


def make_fastdvd_selsa(cfg: Optional[FastDVDSelsaConfig] = None,
                       generator: Optional[torch.Generator] = None,
                       device=None):
    """(model, anchors): ``FastDVDSelsaDetector`` with seeded flax-style
    weights from ``generator`` (a CPU generator; None leaves PyTorch's
    init), on ``device`` (None: the card, raising without one)."""
    cfg = cfg or FastDVDSelsaConfig()
    return place(FastDVDSelsaDetector(cfg), cfg.selsa, generator, device)
