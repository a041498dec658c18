"""Config model dict -> port model, the counterpart of the JAX package's
``zoo.py`` (``_selsa_cfg``, the ImageNet-VID factories ``SELSA``, ``FGFA``
and ``DFF``, ``_darkfarm``, the darkfarm factories and
``SelsaFastDVDnetDetect``) for the model types that the JAX
``tools/train.py`` trains (with ``selsa_loss``, ``fgfa_loss``,
``dff_loss``, ``darkfarm_loss`` or ``fastdvd_selsa_loss``) and the port can
build. A config's ``backbone_variant`` builds a dark backbone
(``backbones/dark_resnet.py``) with its ``backbone_overrides``.

``vid_model_kwargs`` maps a config to the streaming ``VIDModel``, as the
JAX ``tools/test.py`` and ``tools/train.py`` do. The tracking configs are
not in ``MODELS`` (nothing trains them in the port yet):
``build_mot_model`` builds DeepSORT or Tracktor from a config's ``model``
and ``tracker`` dicts, as the JAX zoo and CLI do, and ``sot_model_kwargs``
maps a SiamRPN config to ``apis/inference.py``'s ``SOTModel``.

Each factory takes the config's model dict (without ``type``) and gives a
``SelsaConfig`` for the ImageNet-VID families (DFF's
``key_frame_interval`` goes to the model, as in JAX), a ``DarkfarmConfig``
for the darkfarm family and a ``FastDVDSelsaConfig`` for
``SelsaFastDVDnetDetect``; ``build_model`` builds the model with seeded
weights and its anchors, and says which half of the pairs the loss trains
on (the clean half for the ``SelsaClean*`` oracles). Keys that only choose
how the JAX package runs on a TPU are dropped: ``remat``, ``input_packed``,
``stem_s2d``, ``stem_fused``, ``roi_align_impl``, and the windowed DCN's
``agg_dcn_impl`` / ``agg_dcn_radius`` (the port's DCN is the unbounded
'scan' form, ROADMAP fault F1).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Dict, Optional, Union

import torch

from ..registry import MODELS
from .detectors.faster_rcnn import make_faster_rcnn
from .mot.deep_sort import DeepSORT, Tracktor
from .mot.trackers import SortTracker, TracktorTracker
from .reid.base_reid import BaseReID
from .vid.fgfa import DFF, FGFA, dff_loss, fgfa_loss, make_dff, make_fgfa
from .vid.selsa import (SelsaConfig, SelsaDetector, cast_for_inference,
                        init_params, make_selsa, selsa_loss)
from .vid.selsa_darkfarm import DarkfarmConfig, darkfarm_loss, make_darkfarm
from .vid.selsa_fastdvd import (FastDVDSelsaConfig, fastdvd_selsa_loss,
                                make_fastdvd_selsa)

TPU_ONLY_KEYS = ("remat", "input_packed", "stem_s2d", "stem_fused",
                 "roi_align_impl", "agg_dcn_impl", "agg_dcn_radius")
DTYPES = dict(float32=torch.float32, bfloat16=torch.bfloat16,
              float16=torch.float16)
# the JAX CLI's --tiny (``TINY_KW``), in float32
TINY_KW = dict(pad_h=64, pad_w=64, train_nms_pre=64, train_nms_post=32,
               test_nms_pre=64, test_nms_post=16, num_roi_samples=16,
               compute_dtype=torch.float32)
CLEAN_TYPES = ("SelsaCleanDetect", "SelsaCleanDarkfarmDetect")
# what a darkfarm-family config drops to stream its noisy branch through
# SELSA: the training-only knobs
TRAIN_ONLY_KEYS = ("loss_type", "with_aggregator", "agg_rdb", "agg_taf",
                   "dual_branch", "denoiser", "with_cleaner")
# the ImageNet-VID families: plain frames, their own loss and streaming
VID_FAMILIES = ("SELSA", "FGFA", "DFF")
# the JAX image-detector family table's names (its apis/families.py
# FAMILIES): the port's families (apis/families.py) and the others, which
# raise NotImplementedError
PORTED_IMAGE_FAMILIES = ("FasterRCNN", "FastRCNN", "RPN", "FasterRCNNFPN",
                         "RetinaNet", "GAFasterRCNN", "GARPNHead",
                         "GRoIEFasterRCNN", "GenericRoIExtractor",
                         "LibraFasterRCNN", "LibraRCNN", "GARetinaNet",
                         "GuidedAnchoring", "ATSS", "FCOS", "NASFCOS", "GFL",
                         "PAA", "VFNet", "FreeAnchor", "FreeAnchorRetinaNet",
                         "PISA", "PISARetinaNet", "FSAF", "FoveaBox", "FOVEA",
                         "SABL", "SABLRetinaNet", "RepPoints",
                         "RepPointsDetector", "NASFPNRetinaNet",
                         "CascadeRCNN", "CascadeRPN", "DoubleHeadRCNN",
                         "DoubleHeadRoIHead", "DynamicRCNN", "PISAFasterRCNN",
                         "PISARoIHead", "GridRCNN", "TridentFasterRCNN",
                         "MaskRCNN", "HTC", "HybridTaskCascade", "SCNet",
                         "MaskScoringRCNN", "PointRend", "YOLACT")
NOT_PORTED_IMAGE_FAMILIES = (
    "CentripetalNet", "CornerNet", "DETR", "SSD", "SparseRCNN", "YOLOV3")
IMAGE_FAMILIES = frozenset(PORTED_IMAGE_FAMILIES + NOT_PORTED_IMAGE_FAMILIES)
# SelsaDarkDetect's backbone when its config names none
DARK_DETECT_BACKBONE = "DarkResNet"


def _selsa_cfg(num_classes=30, pad_h=608, pad_w=1024, out_indices=(3,),
               **kw) -> SelsaConfig:
    for k in TPU_ONLY_KEYS:
        kw.pop(k, None)
    bo = kw.get("backbone_overrides")
    if isinstance(bo, dict):  # configs write a dict: sorted (key, value)
        kw["backbone_overrides"] = tuple(  # pairs, lists as tuples
            (k, tuple(v) if isinstance(v, list) else v)
            for k, v in sorted(bo.items()))
    for k in ("compute_dtype", "head_dtype"):
        if isinstance(kw.get(k), str):
            kw[k] = DTYPES[kw[k]]
    for k in ("anchor_scales", "anchor_ratios"):
        if k in kw:
            kw[k] = tuple(kw[k])
    return SelsaConfig(num_classes=num_classes, pad_h=pad_h, pad_w=pad_w,
                       out_indices=tuple(out_indices), **kw)


@MODELS.register("SELSA")
def build_selsa(num_classes=30, **kw):
    return _selsa_cfg(num_classes=num_classes, **kw)


@MODELS.register("FGFA")
def build_fgfa(num_classes=30, **kw):
    return _selsa_cfg(num_classes=num_classes, **kw)


@MODELS.register("DFF")
def build_dff(num_classes=30, key_frame_interval=10, **kw):
    """``key_frame_interval`` is the model's (``build_model``), not the
    config's."""
    return _selsa_cfg(num_classes=num_classes, **kw)


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
    kw.setdefault("backbone_variant", DARK_DETECT_BACKBONE)
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


@MODELS.register("SelsaFastDVDnetDetect")
def build_selsa_fastdvd(num_classes=8, denoiser="fastdvd", **kw):
    """The FastDVDnet (or U-Net) denoiser, then SELSA on its frames."""
    return FastDVDSelsaConfig(selsa=_selsa_cfg(num_classes=num_classes, **kw),
                              denoiser=denoiser)


ModelConfig = Union[SelsaConfig, DarkfarmConfig, FastDVDSelsaConfig]
VID_MAKERS = {"SELSA": make_selsa, "FGFA": make_fgfa, "DFF": make_dff}


@dataclasses.dataclass
class System:
    """A built model, its anchors and the loss that trains it."""

    model: torch.nn.Module
    anchors: torch.Tensor
    branch: str  # the half of the pairs the detector trains on

    @property
    def cfg(self) -> ModelConfig:
        return self.model.cfg

    @property
    def detector_cfg(self) -> SelsaConfig:
        """The detector's ``SelsaConfig`` (sizes, classes)."""
        return getattr(self.cfg, "selsa", self.cfg)

    @property
    def pairs(self) -> bool:
        """Whether the model trains on (noise, clean) pairs, the darkfarm
        and FastDVD families; the ImageNet-VID families take plain
        frames (``TrainBatch``)."""
        return not isinstance(self.cfg, SelsaConfig)

    def loss_fn(self, model, sample, generator):
        if isinstance(model, FGFA):
            return fgfa_loss(model, sample, self.anchors, generator=generator)
        if isinstance(model, DFF):
            return dff_loss(model, sample, self.anchors, generator=generator)
        if isinstance(model, SelsaDetector):
            return selsa_loss(model, sample, self.anchors,
                              generator=generator)
        if isinstance(self.cfg, FastDVDSelsaConfig):
            return fastdvd_selsa_loss(model, sample, self.anchors,
                                      generator=generator)
        return darkfarm_loss(model, sample, self.anchors,
                             generator=generator, branch=self.branch)


def model_config(model_cfg: dict, tiny: bool = False) -> ModelConfig:
    """The config's ``model`` dict -> its ``SelsaConfig`` (the ImageNet-VID
    families), ``DarkfarmConfig`` or ``FastDVDSelsaConfig``; ``tiny``
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
    gen = torch.Generator().manual_seed(seed)
    mtype = model_cfg["type"]
    if mtype == "DFF":
        model, anchors = make_dff(
            cfg, model_cfg.get("key_frame_interval", 10), gen, device=device)
    elif mtype in VID_MAKERS:
        model, anchors = VID_MAKERS[mtype](cfg, gen, device=device)
    elif isinstance(cfg, FastDVDSelsaConfig):
        model, anchors = make_fastdvd_selsa(cfg, gen, device=device)
    else:
        model, anchors = make_darkfarm(cfg, gen, device=device)
    branch = "clean" if mtype in CLEAN_TYPES else "noise"
    return System(model, anchors, branch)


def vid_model_kwargs(model_cfg: dict, sampler: Optional[dict] = None,
                     tiny: bool = False) -> dict:
    """The config's ``model`` dict and its test dataset's
    ``ref_img_sampler`` -> ``VIDModel`` keyword arguments, the JAX CLIs'
    mapping (``tools/test.py:289-315``, ``tools/train.py:326-340``): a
    darkfarm-family type streams its noisy branch through SELSA with the
    same architecture (a dark backbone with its variant and overrides;
    ``SelsaDarkDetect`` its DarkResNet when the config names none, where
    the JAX CLIs stream the plain ResNet, ROADMAP F12),
    ``out_indices=(3,)``, ``in_channels`` as ``backbone_in_channels`` and
    the training-only keys dropped (``SelsaFastDVDnetDetect`` its
    ``denoiser``: the JAX package streams it without, ROADMAP F11); ``tiny``
    applies TINY_KW; a ``test_with_fix_stride`` sampler gives
    ``ref_method="fix"`` with its ``stride`` and a memo of its frame range
    (unless the model dict sets them). The ImageNet-VID families stream as
    themselves (``model_type`` SELSA, FGFA or DFF, DFF with its
    ``key_frame_interval``)."""
    kw = dict(model_cfg)
    mtype = kw.pop("type")
    if mtype in IMAGE_FAMILIES:
        raise NotImplementedError(
            f"model type {mtype!r}: streaming the image detectors through "
            "VIDModel is not ported; the test CLI's image route "
            "(apis/inference.py DetectorModel) runs them")
    if mtype not in MODELS:
        raise KeyError(f"model type {mtype!r}: the port streams "
                       f"{sorted(MODELS.keys())}")
    out = dict(model_type=mtype if mtype in VID_FAMILIES else "SELSA")
    if mtype == "DFF":
        out["key_frame_interval"] = kw.pop("key_frame_interval", 10)
    if mtype not in VID_FAMILIES:
        kw["out_indices"] = (3,)
        if mtype == "SelsaDarkDetect":  # streams the backbone it trains (F12)
            kw.setdefault("backbone_variant", DARK_DETECT_BACKBONE)
        in_ch = kw.pop("in_channels", None)
        if in_ch and in_ch != 3:
            kw.setdefault("backbone_in_channels", in_ch)
        for k in TRAIN_ONLY_KEYS:
            kw.pop(k, None)
    if tiny:
        kw.update(TINY_KW)
    for k in ("ref_method", "frame_stride"):
        if k in kw:
            out[k] = kw.pop(k)
    sampler = sampler or {}
    if sampler.get("method",
                   "test_with_adaptive_stride") == "test_with_fix_stride":
        out.setdefault("ref_method", "fix")
        out.setdefault("frame_stride", sampler.get("stride", 1))
        fr = sampler.get("frame_range", [-7, 7])
        kw.setdefault("num_ref_frames",
                      abs(fr[0]) + fr[1] if isinstance(fr, list) else 14)
    scfg = _selsa_cfg(**kw)
    out.update({f.name: getattr(scfg, f.name)
                for f in dataclasses.fields(scfg)})
    return out


# ---------------------------------------------------------------------------
# tracking: the JAX zoo's ``DeepSORT`` / ``Tracktor`` factories and the JAX
# CLI's mapping of a config's ``model`` and ``tracker`` dicts
# (``tools/test.py`` ``run_mot_eval``, ``run_sot_eval``)

MOT_TYPES = ("DeepSORT", "Tracktor")
SOT_TYPES = ("SiamRPN",)
# the JAX CLI's --tiny for MOT (the ReID net stays bfloat16, as there)
TINY_MOT_KW = dict(pad_h=64, pad_w=64, test_nms_pre=64, test_nms_post=16,
                   compute_dtype=torch.float32)
# and for SOT: the smallest crops the template's center 7x7 allows
TINY_SOT_KW = dict(exemplar_size=64, search_size=128)
TRACKER_ALIASES = {"reid_thr": "reid_sim_thr", "iou_thr": "match_iou_thr"}
TRACKERS = {"DeepSORT": SortTracker, "Tracktor": TracktorTracker}


def sot_model_kwargs(model_cfg: dict, tiny: bool = False) -> dict:
    """A SOT config's ``model`` dict (type SiamRPN and ``SiamRPNConfig``
    fields) -> ``SOTModel`` keyword arguments; ``tiny`` gives TINY_SOT_KW
    where the dict sets no crop size, as the JAX CLI does."""
    kw = dict(model_cfg)
    mtype = kw.pop("type")
    if mtype not in SOT_TYPES:
        raise ValueError(f"model type {mtype!r}: SOT types are {SOT_TYPES}")
    if tiny:
        for k, v in TINY_SOT_KW.items():
            kw.setdefault(k, v)
    return kw


def tracker_kwargs(tracker_cls, tracker_cfg: Optional[dict]) -> dict:
    """A config's ``tracker`` dict -> the tracker's keyword arguments:
    ``reid_thr`` is ``reid_sim_thr``, ``iou_thr`` is ``match_iou_thr``, and
    keys the tracker does not take are dropped (``regression_thr``), as the
    JAX CLI maps them."""
    names = set(inspect.signature(tracker_cls).parameters)
    kw = {TRACKER_ALIASES.get(k, k): v for k, v in (tracker_cfg or {}).items()}
    return {k: v for k, v in kw.items() if k in names}


def build_mot_model(model_cfg: dict, tracker_cfg: Optional[dict] = None,
                    tiny: bool = False, seed: int = 0, device=None,
                    state_dict: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Union[DeepSORT, Tracktor]:
    """A MOT config's ``model`` dict (type DeepSORT or Tracktor, with
    ``num_classes``, DeepSORT's ``with_reid``, Tracktor's ``with_cmc``,
    ``with_linear_motion``, ``linear_motion_num_samples`` and the
    detector's ``SelsaConfig`` fields) and ``tracker`` dict -> the model
    on ``device`` (None: the card). Tracktor's ``with_cmc`` and
    ``with_linear_motion`` may come from the tracker dict, where the
    configs put them. The detector is Faster R-CNN on the DC5 ResNet, as
    the JAX zoo builds it; weights seeded from ``seed`` (the ReID net's from
    ``seed + 1``) or from ``state_dict`` (``detector.`` and ``reid.``
    entries). ``tiny`` applies TINY_MOT_KW."""
    kw = dict(model_cfg)
    mtype = kw.pop("type")
    if mtype not in MOT_TYPES:
        raise ValueError(f"model type {mtype!r}: MOT types are {MOT_TYPES}")
    tcfg = dict(tracker_cfg or {})
    if tiny:
        kw.update(TINY_MOT_KW)
    num_classes = kw.pop("num_classes", 1)
    if mtype == "Tracktor":
        opts = dict(
            with_cmc=bool(kw.pop("with_cmc", tcfg.pop("with_cmc", False))),
            with_linear_motion=bool(kw.pop(
                "with_linear_motion", tcfg.pop("with_linear_motion", False))),
            linear_motion_num_samples=kw.pop("linear_motion_num_samples", 2))
    else:
        with_reid = kw.pop("with_reid", True)
    gen = torch.Generator().manual_seed(seed)
    detector, anchors = make_faster_rcnn(
        _selsa_cfg(num_classes=num_classes, **kw), gen, device=device)
    tracker = TRACKERS[mtype](**tracker_kwargs(TRACKERS[mtype], tcfg))
    if mtype == "Tracktor":
        model = Tracktor(detector, anchors, tracker, **opts)
    else:
        reid = None
        if with_reid:
            reid = BaseReID()  # seeded on the CPU, then moved
            init_params(reid, torch.Generator().manual_seed(seed + 1))
            reid = reid.to(anchors.device)
        model = DeepSORT(detector, anchors, reid, tracker)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    cast_for_inference(model.detector.eval())
    if getattr(model, "reid", None) is not None:
        cast_for_inference(model.reid.eval())
    return model
