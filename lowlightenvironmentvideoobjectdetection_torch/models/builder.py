"""Config model dict -> port model, the counterpart of the JAX package's
``zoo.py`` (``_selsa_cfg``, ``_darkfarm`` and the darkfarm factories) for
the model types that the JAX ``tools/train.py`` trains with
``darkfarm_loss`` and the port can build.

Each factory takes the config's model dict (without ``type``) and gives a
``DarkfarmConfig``; ``build_model`` builds the model with seeded weights
and its anchors, and says which half of the pairs the loss trains on (the
clean half for the ``SelsaClean*`` oracles). Keys that only choose how the
JAX package runs on a TPU are dropped: ``remat``, ``input_packed``,
``stem_s2d``, ``stem_fused``, ``roi_align_impl``, and the windowed DCN's
``agg_dcn_impl`` / ``agg_dcn_radius`` (the port's DCN is the unbounded
'scan' form, ROADMAP fault F1).
"""

from __future__ import annotations

import dataclasses

import torch

from ..registry import MODELS
from .vid.selsa import SelsaConfig
from .vid.selsa_darkfarm import DarkfarmConfig, darkfarm_loss, make_darkfarm

TPU_ONLY_KEYS = ("remat", "input_packed", "stem_s2d", "stem_fused",
                 "roi_align_impl", "agg_dcn_impl", "agg_dcn_radius")
DTYPES = dict(float32=torch.float32, bfloat16=torch.bfloat16,
              float16=torch.float16)
# the JAX CLI's --tiny (``TINY_KW``), in float32
TINY_KW = dict(pad_h=64, pad_w=64, train_nms_pre=64, train_nms_post=32,
               test_nms_pre=64, test_nms_post=16, num_roi_samples=16,
               compute_dtype=torch.float32)
CLEAN_TYPES = ("SelsaCleanDetect", "SelsaCleanDarkfarmDetect")


def _selsa_cfg(num_classes=30, pad_h=608, pad_w=1024, out_indices=(3,),
               **kw) -> SelsaConfig:
    for k in TPU_ONLY_KEYS:
        kw.pop(k, None)
    variant = kw.pop("backbone_variant", None)
    if variant is not None or kw.pop("backbone_overrides", None):
        raise NotImplementedError(
            f"backbone_variant {variant!r}: the dark backbones (DarkResNet "
            "and its plugins) are not ported yet (ROADMAP.md Queue 1, the "
            "dark backbones item)")
    for k in ("compute_dtype", "head_dtype"):
        if isinstance(kw.get(k), str):
            kw[k] = DTYPES[kw[k]]
    for k in ("anchor_scales", "anchor_ratios"):
        if k in kw:
            kw[k] = tuple(kw[k])
    return SelsaConfig(num_classes=num_classes, pad_h=pad_h, pad_w=pad_w,
                       out_indices=tuple(out_indices), **kw)


def _darkfarm(num_classes, loss_type, with_cleaner, out_indices,
              in_channels=3, with_aggregator=False, agg_rdb=True,
              agg_taf=True, dual_branch="both", **kw) -> DarkfarmConfig:
    return DarkfarmConfig(
        selsa=_selsa_cfg(num_classes=num_classes, out_indices=out_indices,
                         **kw),
        loss_type=loss_type, with_cleaner=with_cleaner,
        in_channels=in_channels, with_aggregator=with_aggregator,
        agg_rdb=agg_rdb, agg_taf=agg_taf, dual_branch=dual_branch)


@MODELS.register("SelsaDarkfarmDetect")
def build_selsa_darkfarm(num_classes=8, loss_type="l1",
                         out_indices=(0, 1, 2, 3, 3), **kw):
    return _darkfarm(num_classes, loss_type, True, out_indices, **kw)


@MODELS.register("SelsaNewDarkfarmDetect")
def build_selsa_new_darkfarm(num_classes=8, loss_type="l1",
                             out_indices=(0, 1, 2, 3, 3), **kw):
    """With the Denoising2Aggregator and the dual ``_u`` / ``_d`` losses."""
    return _darkfarm(num_classes, loss_type, True, out_indices,
                     with_aggregator=True, **kw)


@MODELS.register("SelsaNewDetect")
def build_selsa_new_det(num_classes=30, loss_type="l1",
                        out_indices=(0, 1, 2, 3, 3), **kw):
    return _darkfarm(num_classes, loss_type, True, out_indices,
                     with_aggregator=True, **kw)


@MODELS.register("SelsaNewVIDDetect")
def build_selsa_new_vid(num_classes=30, loss_type="l1",
                        out_indices=(0, 1, 2, 3, 3), **kw):
    return _darkfarm(num_classes, loss_type, True, out_indices,
                     with_aggregator=True, **kw)


@MODELS.register("DarkDetect")
def build_dark_detect(num_classes=30, out_indices=(0, 1, 2, 3, 3), **kw):
    """The early design: the aggregator with L2 feature losses."""
    return _darkfarm(num_classes, "l2", True, out_indices,
                     with_aggregator=True, **kw)


@MODELS.register("SelsaDarkDetect")
def build_selsa_dark_detect(num_classes=30, out_indices=(0, 1, 2, 3, 3),
                            **kw):
    """On the ConvLSTM DarkResNet backbone (or the config's variant)."""
    kw.setdefault("backbone_variant", "DarkResNet")
    loss_type = kw.pop("loss_type", "l2")
    return _darkfarm(num_classes, loss_type, True, out_indices, **kw)


@MODELS.register("SelsaNoiseDetect")
def build_selsa_noise(num_classes=30, loss_type="l1", out_indices=(3, 3),
                      **kw):
    return _darkfarm(num_classes, loss_type, False, out_indices, **kw)


@MODELS.register("SelsaNoiseDarkfarmDetect")
def build_selsa_noise_darkfarm(num_classes=8, loss_type="l1",
                               out_indices=(3, 3), **kw):
    return _darkfarm(num_classes, loss_type, False, out_indices, **kw)


@MODELS.register("SelsaCleanDetect")
def build_selsa_clean(num_classes=30, loss_type="l1", out_indices=(3, 3),
                      **kw):
    """The oracle on the clean half (``branch="clean"``)."""
    return _darkfarm(num_classes, loss_type, False, out_indices, **kw)


@MODELS.register("SelsaCleanDarkfarmDetect")
def build_selsa_clean_darkfarm(num_classes=8, loss_type="l1",
                               out_indices=(3, 3), **kw):
    return _darkfarm(num_classes, loss_type, False, out_indices, **kw)


@MODELS.register("LLVOD")
def build_llvod(num_classes=8, loss_type="l2", out_indices=(0, 1, 2, 3, 3),
                **kw):
    return _darkfarm(num_classes, loss_type, True, out_indices, **kw)


@dataclasses.dataclass
class System:
    """A built model, its anchors and the loss that trains it."""

    model: torch.nn.Module
    anchors: torch.Tensor
    branch: str  # the half of the pairs the detector trains on

    @property
    def cfg(self) -> DarkfarmConfig:
        return self.model.cfg

    def loss_fn(self, model, sample, generator):
        return darkfarm_loss(model, sample, self.anchors,
                             generator=generator, branch=self.branch)


def model_config(model_cfg: dict, tiny: bool = False) -> DarkfarmConfig:
    """The config's ``model`` dict -> its ``DarkfarmConfig``; ``tiny``
    applies TINY_KW."""
    kw = dict(model_cfg)
    mtype = kw.pop("type")
    if mtype not in MODELS:
        raise KeyError(f"model type {mtype!r}: the port builds "
                       f"{sorted(MODELS.keys())}")
    if tiny:
        kw.update(TINY_KW)
    return MODELS.get(mtype)(**kw)


def build_model(model_cfg: dict, tiny: bool = False, seed: int = 0,
                device=None) -> System:
    """Build the config's model with weights seeded by ``seed`` on
    ``device`` (None: the card, raising without one)."""
    cfg = model_config(model_cfg, tiny)
    model, anchors = make_darkfarm(
        cfg, torch.Generator().manual_seed(seed), device=device)
    branch = "clean" if model_cfg["type"] in CLEAN_TYPES else "noise"
    return System(model, anchors, branch)
