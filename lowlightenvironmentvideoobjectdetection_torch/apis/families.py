"""The image-detector families: how to build, train and run each image
detector type of a config, the counterpart of the JAX package's
``apis/families.py`` (``Family``, ``get_family``, ``make_synth_batch``,
``init_variables``) for the types the port has:

- ``FasterRCNN``: the DC5 Faster R-CNN (``models/detectors/faster_rcnn.py``);
- ``FastRCNN``: it, driven by a fixed grid of 64 proposals
  (``_grid_proposals``) where the JAX CLI has no proposal file;
- ``RPN``: its RPN alone; detections are the class-agnostic proposals;
- ``FasterRCNNFPN``: ``models/detectors/fpn_faster_rcnn.py``, and its
  variants ``GAFasterRCNN`` / ``GARPNHead`` (GA-RPN), ``GRoIEFasterRCNN`` /
  ``GenericRoIExtractor`` (GRoIE) and ``LibraFasterRCNN`` / ``LibraRCNN``
  (BFP, the IoU-balanced sampler and the balanced L1 loss);
- ``RetinaNet``: ``models/dense_heads/retina_head.py``;
- ``GARetinaNet`` / ``GuidedAnchoring``:
  ``models/dense_heads/guided_anchor_head.py``;
- the dense one-stage heads on the FPN trunk, each with its loss and
  decode: ``FCOS`` (``fcos_head.py``), ``NASFCOS`` (``pisa_nasfcos.py``),
  ``ATSS`` (``atss_head.py``), ``GFL`` (``gfl_head.py``), ``PAA``
  (``paa_head.py``) and ``VFNet`` (``vfnet_head.py``), and RetinaNet's
  tower with FreeAnchor's loss (``FreeAnchor`` / ``FreeAnchorRetinaNet``,
  ``free_anchor_head.py``, 16 anchors a bag) or PISA's
  (``PISA`` / ``PISARetinaNet``, ``pisa_nasfcos.py``), decoded as
  RetinaNet;
- the rest of the one-stage zoo on RetinaNet's FPN (extra convs on C5),
  each with its loss and decode: ``FSAF`` (``fsaf_head.py``), ``FoveaBox``
  / ``FOVEA`` (``fovea_head.py``), ``SABL`` / ``SABLRetinaNet``
  (``sabl_head.py``) and ``RepPoints`` / ``RepPointsDetector``
  (``reppoints_head.py``, two points DCNs a level on kernels E, F, G);
  ``NASFPNRetinaNet`` (``retina_head.py``: the NAS-FPN neck and
  ``RetinaSepBNHead``, 2 stacks with ``tiny``), trained and decoded as
  RetinaNet;
- the two-stage families on the DC5 trunk: ``CascadeRCNN``
  (``detectors/cascade_rcnn.py``), ``CascadeRPN`` (one class; the 300
  stage-2 proposals are the detections; ``dense_heads/cascade_rpn_head.py``,
  a DCN on kernels E, F, G), ``DoubleHeadRCNN`` / ``DoubleHeadRoIHead``,
  ``DynamicRCNN`` (trained at the schedule's initial IoU 0.4 and beta 1.0,
  as the JAX table does: ROADMAP F31) and ``PISAFasterRCNN`` /
  ``PISARoIHead`` (detected as Faster R-CNN;
  ``detectors/roi_head_families.py``), ``GridRCNN`` (14x14 RoIAlign for
  its grid head) and ``TridentFasterRCNN`` (``detectors/more_rcnn.py``);
- the mask families, trained on box-filled masks where the batch has none
  (``as_mask_batch``, the JAX ``_as_mask_batch``): ``MaskRCNN``
  (``detectors/mask_rcnn.py``), ``HTC`` / ``HybridTaskCascade`` and
  ``SCNet`` (``detectors/htc.py``), ``MaskScoringRCNN`` and ``PointRend``
  (``detectors/more_rcnn.py``) on the DC5 trunk, and ``YOLACT``
  (``dense_heads/yolact_head.py``) on RetinaNet's FPN. Their modules
  return (detections, masks); ``detect`` here drops the masks, as the
  JAX table does.

An entry's ``build(mcfg, tiny, seed, device)`` gives (model, aux) with
seeded flax-style weights (``aux``: the DC5 families' anchors, else None:
the FPN families make theirs from the maps), ``loss(model, aux, batch,
generator, uniforms)`` the (total, metrics) of a ``DetTrainBatch`` (the
samplers draw their uniforms from ``generator`` unless given them) and
``detect(model, aux, img, img_shape, scale_factor, impl)`` a fixed-shape
``DetResult``. ``tiny`` applies the JAX CLI's sizes and float32.

``get_family`` of any other family name the JAX package has raises
``NotImplementedError`` naming ROADMAP.md Queue 1 item 9; of a name that is
no image family at all it returns None.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.nms import DetResult
from ..models.builder import (DTYPES, IMAGE_FAMILIES,
                               NOT_PORTED_IMAGE_FAMILIES, TINY_KW,
                               _selsa_cfg)
from ..models.dense_heads import atss_head as AT
from ..models.dense_heads import fcos_head as FC
from ..models.dense_heads import fovea_head as FV
from ..models.dense_heads import free_anchor_head as FA
from ..models.dense_heads import fsaf_head as FS
from ..models.dense_heads import gfl_head as GF
from ..models.dense_heads import guided_anchor_head as GA
from ..models.dense_heads import paa_head as PA
from ..models.dense_heads import pisa_nasfcos as PN
from ..models.dense_heads import reppoints_head as RP
from ..models.dense_heads import retina_head as R
from ..models.dense_heads import sabl_head as SB
from ..models.dense_heads import vfnet_head as VF
from ..models.dense_heads import yolact_head as Y
from ..models.dense_heads import cascade_rpn_head as CRPN
from ..models.detectors import cascade_rcnn as CR
from ..models.detectors import fpn_faster_rcnn as FF
from ..models.detectors import htc as H
from ..models.detectors import mask_rcnn as MK
from ..models.detectors import more_rcnn as MR
from ..models.detectors import roi_head_families as RH
from ..models.detectors.faster_rcnn import (DetTrainBatch, FasterRCNN,
                                            faster_rcnn_detect,
                                            faster_rcnn_loss)
from ..models.vid.selsa import init_params, loss_uniforms, make_anchors
from ..utils.device import resolve_device

ZOO_ITEM = FF.ZOO_ITEM
# the JAX family table's other names (apis/families.py FAMILIES)
NOT_PORTED = NOT_PORTED_IMAGE_FAMILIES
# the JAX families' --tiny sizes
FPN_TINY_KW = dict(pad_h=128, pad_w=128, train_nms_post=32,
                   test_nms_post=16, num_roi_samples=16)
DENSE_TINY_HW = (128, 128)
DENSE_PAD_HW = (768, 1280)  # the JAX DetectorModel's bucket without a cfg


@dataclasses.dataclass(frozen=True)
class Family:
    build: Callable  # (mcfg, tiny, seed, device) -> (model, aux)
    loss: Callable  # (model, aux, batch, generator, uniforms) -> loss
    detect: Callable  # (model, aux, img, img_shape, sf, impl) -> DetResult
    # the synthetic batches' size when the model has no SelsaConfig bucket
    input_hw: Optional[Tuple[int, int]] = None


def _seeded(model: torch.nn.Module, seed: int, device) -> torch.nn.Module:
    """Seeded flax-style weights (on the CPU), then ``device``."""
    init_params(model, torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device))


def _dc5_build(cls, default_classes: int, anchors: bool = True):
    """(model, its anchors; None without ``anchors``: Cascade RPN makes
    its own)."""
    def build(mcfg, tiny, seed=0, device=None):
        kw = dict(mcfg)
        kw.setdefault("num_classes", default_classes)
        if tiny:
            kw.update(TINY_KW)
        cfg = _selsa_cfg(**kw)
        model = _seeded(cls(cfg), seed, device)
        if not anchors:
            return model, None
        return model, make_anchors(cfg, next(model.parameters()).device)
    return build


def _dense_kw(mcfg, tiny, tiny_kw=None) -> dict:
    """The JAX ``_dense_build`` / ``_build_fpn_frcnn`` keyword mapping:
    ``compute_dtype`` is ``dtype``, dtype names become dtypes, the
    single-level windows go; ``tiny`` gives float32 and ``tiny_kw``."""
    kw = dict(mcfg)
    if "compute_dtype" in kw:
        kw.setdefault("dtype", kw.pop("compute_dtype"))
    if tiny:
        kw["dtype"] = torch.float32
        kw.update(tiny_kw or {})
    if isinstance(kw.get("dtype"), str):
        kw["dtype"] = DTYPES[kw["dtype"]]
    for k in ("train_nms_pre", "test_nms_pre"):
        kw.pop(k, None)
    return kw


def _dense_build(cls, tiny_kw=None, **variant):
    """The JAX ``_dense_build`` (``_build_fpn_frcnn`` for FPN Faster R-CNN,
    with the zoo entry's ``variant`` keywords: ``rpn_type``,
    ``roi_extract``, ``with_bfp``)."""
    def build(mcfg, tiny, seed=0, device=None):
        kw = dict(_dense_kw(mcfg, tiny, tiny_kw), **variant)
        return _seeded(cls(**kw), seed, device), None
    return build


def _fpn_family(sampler="random", reg_loss="smooth_l1", **variant):
    return Family(
        _dense_build(FF.FPNFasterRCNN, FPN_TINY_KW, **variant),
        lambda m, a, b, generator=None, uniforms=None:
            FF.fpn_faster_rcnn_loss(m, b, generator=generator,
                                    uniforms=uniforms, sampler=sampler,
                                    reg_loss=reg_loss),
        lambda m, a, img, ishape, sf=None, impl=None:
            FF.fpn_faster_rcnn_detect(m, img, ishape, scale_factor=sf,
                                      impl=impl),
        input_hw=DENSE_TINY_HW)


def _grid_proposals(hw, n: int = 64, device=None):
    """The JAX CLI's fixed proposal grid for Fast R-CNN without a proposal
    file: sqrt(n) x sqrt(n) half-image boxes from the top left quarter
    (``hw`` the padded image's size, host ints)."""
    h, w = float(hw[0]), float(hw[1])
    side = int(np.sqrt(n))
    ys = np.linspace(0, h * 0.5, side)
    xs = np.linspace(0, w * 0.5, side)
    boxes = [[x, y, min(x + w * 0.5, w), min(y + h * 0.5, h)]
             for y in ys for x in xs]
    return (torch.as_tensor(np.asarray(boxes, np.float32), device=device),
            torch.ones(len(boxes), dtype=torch.bool, device=device))


def _uniforms(uniforms, shape, generator, device):
    if uniforms is not None:
        return uniforms
    if generator is None:
        raise ValueError("pass uniforms or a generator")
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


def _fast_loss(m, a, b, generator=None, uniforms=None):
    props, pv = _grid_proposals(b.img.shape[:2], device=b.img.device)
    fb = MR.FastRCNNBatch(b.img, b.img_shape, props, pv, b.gt_boxes,
                          b.gt_labels, b.gt_valid)
    u = _uniforms(uniforms, (3, b.gt_boxes.shape[0] + props.shape[0]),
                  generator, b.img.device)
    return MR.fast_rcnn_loss(m, fb, u)


def _fast_detect(m, a, img, ishape, sf=None, impl=None):
    props, pv = _grid_proposals(img.shape[:2], device=img.device)
    return MR.fast_rcnn_detect(m, img, ishape, props, pv, scale_factor=sf,
                               impl=impl)


def _rpn_loss(m, a, b, generator=None, uniforms=None):
    u = _uniforms(uniforms, (2, a.shape[0]), generator, b.img.device)
    return MR.rpn_only_loss(m, b, a, u)


def _rpn_detect(m, a, img, ishape, sf=None, impl=None):
    props = MR.rpn_propose(m, img, ishape, a)
    boxes = props.boxes
    if sf is not None:
        boxes = boxes / torch.as_tensor(sf, dtype=boxes.dtype,
                                        device=boxes.device)
    return DetResult(boxes, props.scores,
                     torch.zeros(boxes.shape[0], dtype=torch.int64,
                                 device=boxes.device), props.valid)


FAMILIES: Dict[str, Family] = {
    "FasterRCNN": Family(
        _dc5_build(FasterRCNN, 30),
        lambda m, a, b, generator=None, uniforms=None: faster_rcnn_loss(
            m, b, a, generator=generator, uniforms=uniforms),
        lambda m, a, img, ishape, sf=None, impl=None: faster_rcnn_detect(
            m, img, ishape, a, scale_factor=sf, impl=impl)),
    "FastRCNN": Family(_dc5_build(MR.FastRCNN, 80), _fast_loss,
                       _fast_detect),
    "RPN": Family(_dc5_build(MR.RPN, 1), _rpn_loss, _rpn_detect),
    "FasterRCNNFPN": _fpn_family(),
    "RetinaNet": Family(
        _dense_build(R.RetinaNet),
        lambda m, a, b, generator=None, uniforms=None: R.retinanet_loss(m, b),
        lambda m, a, img, ishape, sf=None, impl=None: R.retinanet_detect(
            m, img, ishape, scale_factor=sf),
        input_hw=DENSE_TINY_HW),
}
FAMILIES["GAFasterRCNN"] = FAMILIES["GARPNHead"] = _fpn_family(rpn_type="ga")
FAMILIES["GRoIEFasterRCNN"] = FAMILIES["GenericRoIExtractor"] = _fpn_family(
    roi_extract="groie")
FAMILIES["LibraFasterRCNN"] = FAMILIES["LibraRCNN"] = _fpn_family(
    sampler="iou_balanced", reg_loss="balanced_l1", with_bfp=True)
FAMILIES["NASFPNRetinaNet"] = Family(
    _dense_build(R.NASFPNRetinaNet, dict(stack_times=2)),
    FAMILIES["RetinaNet"].loss, FAMILIES["RetinaNet"].detect,
    input_hw=DENSE_TINY_HW)
FAMILIES["GARetinaNet"] = FAMILIES["GuidedAnchoring"] = Family(
    _dense_build(GA.GARetinaNet),
    lambda m, a, b, generator=None, uniforms=None: GA.ga_retinanet_loss(m, b),
    lambda m, a, img, ishape, sf=None, impl=None: GA.ga_retinanet_detect(
        m, img, ishape, scale_factor=sf, impl=impl),
    input_hw=DENSE_TINY_HW)


def _dc5_two_stage(cls, loss_fn, detect_fn, draw=None):
    """A DC5 two-stage family: ``loss_fn(model, batch, anchors, uniforms)``
    and ``detect_fn(model, img, img_shape, anchors, scale_factor, impl)``;
    ``draw(cfg, num_gts, num_anchors, generator, device)`` makes the
    uniforms (by default ``LossUniforms``)."""
    def loss(m, a, b, generator=None, uniforms=None):
        if uniforms is None and draw is not None:
            if generator is None:
                raise ValueError("pass uniforms or a generator")
            uniforms = draw(m.cfg, b.gt_boxes.shape[0], a.shape[0], generator,
                            b.img.device)
        elif draw is None:
            uniforms = loss_uniforms(m.cfg, b.gt_boxes.shape[0], a,
                                     generator, uniforms)
        return loss_fn(m, b, a, uniforms)

    def detect(m, a, img, ishape, sf=None, impl=None):
        return detect_fn(m, img, ishape, a, scale_factor=sf, impl=impl)

    return Family(_dc5_build(cls, 80), loss, detect)


def _crpn_loss(m, a, b, generator=None, uniforms=None):
    n = (b.img.shape[0] // 16) * (b.img.shape[1] // 16)
    u = _uniforms(uniforms, (2, n), generator, b.img.device)
    return CRPN.cascade_rpn_model_loss(m, b, u)


def _crpn_detect(m, a, img, ishape, sf=None, impl=None):
    return CRPN.cascade_rpn_propose(m, img, ishape, scale_factor=sf,
                                    impl=impl)


FAMILIES["CascadeRCNN"] = _dc5_two_stage(
    CR.CascadeRCNN, CR.cascade_loss, CR.cascade_detect,
    draw=CR.draw_cascade_uniforms)
FAMILIES["CascadeRPN"] = Family(_dc5_build(CRPN.CascadeRPNModel, 1, False),
                                _crpn_loss, _crpn_detect)
FAMILIES["DoubleHeadRCNN"] = FAMILIES["DoubleHeadRoIHead"] = _dc5_two_stage(
    RH.DoubleHeadRCNN, RH.double_head_loss, RH.double_head_detect)
FAMILIES["DynamicRCNN"] = _dc5_two_stage(
    FasterRCNN, RH.dynamic_rcnn_loss, RH.dynamic_rcnn_detect)
FAMILIES["PISAFasterRCNN"] = FAMILIES["PISARoIHead"] = _dc5_two_stage(
    FasterRCNN, RH.pisa_roi_loss, faster_rcnn_detect)
FAMILIES["GridRCNN"] = _dc5_two_stage(
    MR.GridRCNN, MR.grid_rcnn_loss, MR.grid_rcnn_detect,
    draw=MR.draw_grid_uniforms)
FAMILIES["TridentFasterRCNN"] = _dc5_two_stage(
    MR.TridentFasterRCNN, MR.trident_loss, MR.trident_detect,
    draw=MR.draw_trident_uniforms)


def _mask_family(cls, loss_fn, boxes_fn, draw=None):
    """A DC5 mask family: its loss on the batch with masks
    (``as_mask_batch``), its detections without them. ``boxes_fn`` is the
    test path up to the masks (the mask head runs, nothing is pasted:
    the masks are dropped here, as the JAX family drops them)."""
    return _dc5_two_stage(
        cls, lambda m, b, a, u: loss_fn(m, MK.as_mask_batch(b), a, u),
        lambda m, img, ishape, a, scale_factor=None, impl=None: boxes_fn(
            m, img, ishape, a, scale_factor=scale_factor, impl=impl)[0],
        draw=draw)


FAMILIES["MaskRCNN"] = _mask_family(MK.MaskRCNN, MK.mask_rcnn_loss,
                                    MK.mask_rcnn_boxes)
FAMILIES["HTC"] = FAMILIES["HybridTaskCascade"] = _mask_family(
    H.HTC, H.htc_loss, H.htc_detect, draw=CR.draw_cascade_uniforms)
FAMILIES["SCNet"] = _mask_family(H.SCNet, H.htc_loss, H.htc_detect,
                                 draw=CR.draw_cascade_uniforms)
FAMILIES["MaskScoringRCNN"] = _mask_family(
    MR.MaskScoringRCNN, MR.mask_scoring_loss, MR.mask_scoring_boxes)
FAMILIES["PointRend"] = _mask_family(  # its detections are Mask R-CNN's
    MR.PointRendRCNN, MR.point_rend_loss,
    lambda m, *a, **kw: MK.mask_rcnn_boxes(m.mask_rcnn, *a, **kw))
FAMILIES["YOLACT"] = Family(
    _dense_build(Y.YOLACT),
    lambda m, a, b, generator=None, uniforms=None: Y.yolact_model_loss(
        m, b, MK.as_mask_batch(b).gt_masks),
    lambda m, a, img, ishape, sf=None, impl=None: Y.yolact_model_detect(
        m, img, ishape, scale_factor=sf, impl=impl)[0],
    input_hw=DENSE_TINY_HW)


def _totalled(ls) -> Tuple[torch.Tensor, dict]:
    """A loss NamedTuple -> (its sum, its terms and ``loss``), as the JAX
    ``_total``."""
    total = sum(ls)
    metrics = dict(ls._asdict())
    metrics["loss"] = total
    return total, metrics


def _one_image(outs):
    """Per-level outputs of a batch of one -> those of the image."""
    return [tuple(t[0] for t in o) for o in outs]


def _dense_family(cls, loss_fn, decode_fn, extra=lambda m: {}):
    """The JAX ``dense(...)`` helper: ``loss_fn`` and ``decode_fn`` on one
    image's level outputs, with ``extra(model)``'s keywords (GFL's
    ``reg_max``)."""
    def loss(m, a, b, generator=None, uniforms=None):
        outs = _one_image(m(b.img[None]))
        return _totalled(loss_fn(outs, b.gt_boxes, b.gt_labels, b.gt_valid,
                                 m.num_classes, **extra(m)))

    @torch.no_grad()
    def detect(m, a, img, ishape, sf=None, impl=None):
        outs = _one_image(m(img[None], impl=impl))
        return decode_fn(outs, ishape, m.num_classes, scale_factor=sf,
                         **extra(m))

    return Family(_dense_build(cls), loss, detect, input_hw=DENSE_TINY_HW)


def _retina_tower_family(loss_fn):
    """RetinaNet's tower, anchors and decode with ``loss_fn(model, level
    outputs of the image, anchors, batch)``."""
    def loss(m, a, b, generator=None, uniforms=None):
        outs = m(b.img[None])
        return _totalled(loss_fn(m, _one_image(outs), m.anchors(outs), b))

    return Family(
        _dense_build(R.RetinaNet), loss,
        lambda m, a, img, ishape, sf=None, impl=None: R.retinanet_detect(
            m, img, ishape, scale_factor=sf),
        input_hw=DENSE_TINY_HW)


FAMILIES["FCOS"] = _dense_family(FC.FCOS, FC.fcos_loss, FC.fcos_decode)
FAMILIES["NASFCOS"] = _dense_family(PN.NASFCOS, PN.nasfcos_loss,
                                    PN.nasfcos_decode)
FAMILIES["ATSS"] = _dense_family(AT.ATSS, AT.atss_loss, AT.atss_decode)
FAMILIES["PAA"] = _dense_family(PA.PAA, PA.paa_loss, PA.paa_decode)
FAMILIES["VFNet"] = _dense_family(VF.VFNet, VF.vfnet_loss, VF.vfnet_decode)
FAMILIES["GFL"] = _dense_family(GF.GFL, GF.gfl_loss, GF.gfl_decode,
                                extra=lambda m: dict(reg_max=m.reg_max))
FAMILIES["FSAF"] = _dense_family(FS.FSAF, FS.fsaf_loss, FS.fsaf_decode)
FAMILIES["FoveaBox"] = FAMILIES["FOVEA"] = _dense_family(
    FV.FoveaBox, FV.fovea_loss, FV.fovea_decode)
FAMILIES["SABL"] = FAMILIES["SABLRetinaNet"] = _dense_family(
    SB.SABLRetinaNet, SB.sabl_loss, SB.sabl_decode)
FAMILIES["RepPoints"] = FAMILIES["RepPointsDetector"] = _dense_family(
    RP.RepPointsDetector, RP.reppoints_loss, RP.reppoints_decode)
FAMILIES["FreeAnchor"] = FAMILIES["FreeAnchorRetinaNet"] = \
    _retina_tower_family(lambda m, outs, anchors, b: FA.free_anchor_loss(
        outs, anchors, b.gt_boxes, b.gt_labels, b.gt_valid, m.num_classes,
        pre_anchor_topk=16))
FAMILIES["PISA"] = FAMILIES["PISARetinaNet"] = _retina_tower_family(
    lambda m, outs, anchors, b: PN.pisa_retina_loss(
        outs, anchors, b.gt_boxes, b.gt_labels, b.gt_valid, b.img_shape,
        m.num_classes))


def get_family(mtype: str) -> Optional[Family]:
    """The port's family of ``mtype``; NotImplementedError for the JAX
    package's other families; None for a type that is no image family."""
    if mtype in FAMILIES:
        return FAMILIES[mtype]
    if mtype in NOT_PORTED:
        raise NotImplementedError(f"image detector {mtype!r} is not ported "
                                  f"({ZOO_ITEM})")
    return None


def is_image_family(mtype: str) -> bool:
    """Whether the JAX family table has ``mtype`` (ported or not)."""
    return mtype in IMAGE_FAMILIES


def pad_hw(model, fam: Family, tiny: bool) -> Tuple[int, int]:
    """The bucket images are padded to: a DC5 family's config pad, FPN
    Faster R-CNN's own ``pad_h`` x ``pad_w`` (800 x 1344; 128 x 128 with
    ``tiny``; its variants too), the dense families' (RetinaNet,
    GA-RetinaNet, NAS-FPN RetinaNet, FCOS and the rest) 768 x 1280 (128 x
    128 with ``tiny``), as the JAX ``DetectorModel`` pads save for FPN
    (ROADMAP fault F18)."""
    cfg = getattr(model, "cfg", None)
    if cfg is not None:
        return cfg.pad_h, cfg.pad_w
    if isinstance(model, FF.FPNFasterRCNN):
        return model.pad_h, model.pad_w
    return fam.input_hw if tiny else DENSE_PAD_HW


def num_classes(model) -> int:
    cfg = getattr(model, "cfg", None)
    return cfg.num_classes if cfg is not None else model.num_classes


def make_synth_batch(model, fam: Family, rng: np.random.RandomState,
                     device=None) -> DetTrainBatch:
    """The JAX CLI's synthetic ``DetTrainBatch`` for the family: U(-2, 2)
    at ``input_hw`` (else the config's bucket), 2 valid gts of 4."""
    if fam.input_hw is not None:
        h, w = fam.input_hw
    else:
        h, w = model.cfg.pad_h, model.cfg.pad_w
    fields = (rng.uniform(-2, 2, (h, w, 3)).astype(np.float32),
              np.asarray([float(h), float(w)], np.float32),
              np.asarray([[8.0, 8.0, h * 0.45, w * 0.45],
                          [4.0, 4.0, h * 0.3, w * 0.6],
                          [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]],
                         np.float32),
              np.asarray([1, 2, 0, 0], np.int64),
              np.asarray([True, True, False, False]))
    return DetTrainBatch(*(torch.as_tensor(f, device=device)
                           for f in fields))
