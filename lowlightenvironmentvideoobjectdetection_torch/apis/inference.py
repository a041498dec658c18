"""Public streaming inference API, the counterpart of the JAX package's
``apis/inference.py``: the video detectors (SELSA and its low-light
family, FGFA, DFF: ``VIDModel``, ``init_model``, ``inference_vid``,
``result_to_per_class``), the image detectors (``DetectorModel``,
``init_detector``, ``inference_detector``: the families of
``apis/families.py``), multi-object tracking (``inference_mot`` on a
DeepSORT or Tracktor model of ``models/builder.py`` ``build_mot_model``)
and single-object tracking (``SOTModel``, ``init_sot_model``,
``inference_sot``: SiamRPN++)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.preprocess import prepare_frames
from . import families as FAM
from ..models.mot.deep_sort import rescale_result
from ..models.sot import siamrpn as SR
from ..models.vid import fgfa as FG
from ..models.vid import selsa as S
from ..utils.device import full_f32_precision, resolve_device


def result_to_per_class(dets, num_classes: int) -> List[np.ndarray]:
    """Fixed-shape DetResult -> the reference's list of per-class [N, 5]."""
    valid = dets.valid.cpu().numpy()
    boxes = dets.boxes.float().cpu().numpy()[valid]
    scores = dets.scores.float().cpu().numpy()[valid]
    labels = dets.labels.cpu().numpy()[valid]
    return [np.concatenate([boxes[labels == c], scores[labels == c, None]],
                           axis=1).astype(np.float32)
            for c in range(num_classes)]


class VIDModel:
    """A built video detector with its streaming memo.

    ``model_type`` SELSA streams ``models/vid/selsa.py``'s step; FGFA and
    DFF their own (``models/vid/fgfa.py``), as the JAX ``VIDModel``
    dispatches: FGFA's memo of frames and maps rolls every frame, DFF runs
    the backbone every ``key_frame_interval`` frames from frame 0.
    ``ref_method`` (SELSA): 'adaptive' keeps the frame-0 memo for the whole
    video; 'fix' rolls each streamed frame's own K/V into it every
    ``frame_stride`` frames. ``state_dict`` None gives seeded random
    weights (``init_params`` with a CPU generator seeded by ``seed``); for
    SELSA, of a darkfarm or FastDVD state dict (``SelsaDarkfarmDetector``'s,
    ``FastDVDSelsaDetector``'s) it takes the ``selsa.`` entries, the
    detector (``detector_state``); FGFA and DFF load the whole tree. The
    config comes from ``cfg_kwargs`` (``SelsaConfig`` fields, e.g.
    ``roi_extractor="temporal", num_shared_fcs=3``, or a dark backbone's
    ``backbone_variant``). ``device`` None builds on the card and raises
    without one; pass ``device="cpu"`` for the CPU. ``impl = "plain"`` (an
    attribute, for comparisons only) runs the kernels' plain versions."""

    impl = None

    def __init__(self, model_type: str = "SELSA", state_dict=None,
                 seed: int = 0, ref_method: str = "adaptive",
                 frame_stride: int = 1, device=None,
                 key_frame_interval: int = 10, **cfg_kwargs):
        if model_type not in ("SELSA", "FGFA", "DFF"):
            raise ValueError(f"model type {model_type!r}: the port streams "
                             "SELSA, FGFA and DFF")
        if ref_method not in ("adaptive", "fix"):
            raise ValueError(f"unknown ref_method {ref_method!r}")
        self.model_type = model_type
        self.cfg = S.SelsaConfig(**cfg_kwargs)
        self.device = resolve_device(device)
        full_f32_precision()
        if model_type == "FGFA":
            model = FG.FGFA(self.cfg)
        elif model_type == "DFF":
            model = FG.DFF(self.cfg, key_frame_interval)
        else:
            model = S.SelsaDetector(self.cfg)
        if state_dict is None:
            S.init_params(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(detector_state(state_dict)
                                  if model_type == "SELSA" else state_dict,
                                  strict=True)
        self.model = S.cast_for_inference(model.to(self.device).eval())
        self.anchors = S.make_anchors(self.cfg, self.device)
        self.ref_method = ref_method
        self.frame_stride = max(int(frame_stride), 1)
        self.state = None

    def _step(self, img, img_shape, sf, frame_id, refs):
        m, a, impl = self.model, self.anchors, self.impl
        if self.model_type == "FGFA":  # the memo rolls every frame
            if frame_id == 0:
                self.state = FG.fgfa_init_state(m, refs)
            self.state, dets = FG.fgfa_inference_step(
                m, self.state, img, img_shape, sf, a, impl=impl)
            return dets
        if self.model_type == "DFF":  # frame 0 is a key frame
            if frame_id == 0:
                self.state = FG.dff_init_state()
            self.state, dets = FG.dff_inference_step(
                m, self.state, img, img_shape, sf, a, impl=impl)
            return dets
        if frame_id == 0:
            self.state = S.init_video_state(m, refs, img_shape, a, impl=impl)
        do = self.ref_method != "fix" or frame_id % self.frame_stride == 0
        self.state, dets = S.inference_step(
            m, self.state, img, img_shape, sf, a,
            update_memo=self.ref_method == "fix", do_update=do, impl=impl)
        return dets

    def inference_vid(self, frame: np.ndarray, frame_id: int,
                      ref_frames: Optional[np.ndarray] = None) -> Dict:
        """Feed raw frames [H, W, 3] in order; at frame 0 give the sampled
        reference frames (else the first frame is repeated)."""
        cfg = self.cfg
        imgs, img_shape, sf = prepare_frames(frame[None], cfg.pad_h, cfg.pad_w,
                                             device=self.device)
        refs = None
        if frame_id == 0:
            if ref_frames is None:
                refs = imgs.repeat(cfg.num_ref_frames, 1, 1, 1)
            else:
                refs, _, _ = prepare_frames(ref_frames, cfg.pad_h, cfg.pad_w,
                                            device=self.device)
        dets = self._step(imgs[0], img_shape,
                          torch.as_tensor(sf, device=self.device), frame_id,
                          refs)
        return dict(bbox_results=result_to_per_class(dets, cfg.num_classes))

    def _pad_prepared(self, img) -> torch.Tensor:
        """Pad an already resized and normalized image [h, w, C] (numpy, or
        a tensor such as the pipeline's device stage gives) to the bucket
        on the model's device, keeping its first ``backbone_in_channels``
        channels (the noisy half of a pair)."""
        cfg = self.cfg
        img = torch.as_tensor(img).to(self.device, torch.float32)
        keep = min(img.shape[-1], cfg.backbone_in_channels)
        canvas = img.new_zeros((cfg.pad_h, cfg.pad_w, keep))
        h, w = min(img.shape[0], cfg.pad_h), min(img.shape[1], cfg.pad_w)
        canvas[:h, :w] = img[:h, :w, :keep]
        return canvas

    def inference_vid_prepared(self, img, img_shape=None, scale_factor=None,
                               frame_id: int = 0, ref_imgs=None) -> Dict:
        """Streaming over pipeline-prepared images [h, w, C], numpy or
        tensors (a tensor on the model's device is padded where it lies):
        only the pad happens here. ``scale_factor`` maps detections back to
        the original frame; ``ref_imgs`` are the prepared reference frames
        at frame 0 (an [R, h, w, C] array or a sequence of [h, w, C])."""
        cfg = self.cfg
        canvas = self._pad_prepared(img)
        if img_shape is None:
            img_shape = img.shape[:2]
        shape = torch.tensor([float(img_shape[0]), float(img_shape[1])],
                             device=self.device)
        if scale_factor is None:
            scale_factor = np.ones((4,), np.float32)
        sf = torch.as_tensor(scale_factor, dtype=torch.float32).to(
            self.device)
        refs = None
        if frame_id == 0:
            if ref_imgs is None:
                refs = canvas[None].repeat(cfg.num_ref_frames, 1, 1, 1)
            else:
                refs = torch.stack([self._pad_prepared(r) for r in ref_imgs])
        dets = self._step(canvas, shape, sf, frame_id, refs)
        return dict(bbox_results=result_to_per_class(dets, cfg.num_classes))


def detector_state(state_dict: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """A SELSA detector's state dict (FGFA and DFF stream their whole
    tree): as given, or the ``selsa.`` entries of
    a darkfarm one (without the cleaner's and the aggregator's: streaming
    runs neither, as in the JAX package; ROADMAP F7) or of a
    ``SelsaFastDVDnetDetect`` one (without the denoiser's: the JAX package
    streams the noisy frames; ROADMAP F11)."""
    if not any(k.startswith("selsa.") for k in state_dict):
        return state_dict
    return {k[len("selsa."):]: v for k, v in state_dict.items()
            if k.startswith("selsa.")}


def init_model(model_type: str = "SELSA", checkpoint=None, **kwargs
               ) -> VIDModel:
    """Build a VIDModel; ``checkpoint`` is a saved port ``state_dict`` (a
    SELSA, darkfarm, FGFA or DFF model's) or a ``TrainState`` checkpoint of
    ``utils/checkpoint.py``, whose model it takes."""
    if checkpoint is not None:
        sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
        kwargs["state_dict"] = sd.get("model", sd)
    return VIDModel(model_type=model_type, **kwargs)


def inference_vid(model: VIDModel, frame: np.ndarray, frame_id: int,
                  ref_frames: Optional[np.ndarray] = None) -> Dict:
    return model.inference_vid(frame, frame_id, ref_frames)


class DetectorModel:
    """A built image detector (mmdet's ``init_detector`` /
    ``inference_detector``): any family of ``apis/families.py``, weights
    seeded by ``seed`` or from ``state_dict``, on ``device`` (None: the
    card, raising without one). Images are resized into the family's
    bucket (``families.pad_hw``: a DC5 family's config pad, 608 x 1024;
    FPN Faster R-CNN's own 800 x 1344; RetinaNet's 768 x 1280; 64 x 64 or
    128 x 128 with ``tiny``, which also computes in float32), or
    ``pad_hw``. Results are per-class [N, 5] arrays in the original
    image's coordinates. ``impl = "plain"`` (an attribute, for comparisons
    only) runs the kernels' plain versions."""

    impl = None

    def __init__(self, model_type: str = "FasterRCNN", state_dict=None,
                 seed: int = 0, tiny: bool = False, pad_hw=None, device=None,
                 **model_kwargs):
        fam = FAM.get_family(model_type)
        if fam is None:
            raise ValueError(f"model type {model_type!r} is no image "
                             f"detector (the port runs "
                             f"{sorted(FAM.FAMILIES)})")
        self.model_type, self.family = model_type, fam
        self.device = resolve_device(device)
        full_f32_precision()
        model, self.aux = fam.build(dict(model_kwargs), tiny, seed,
                                    self.device)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = S.cast_for_inference(model.eval())
        self.num_classes = FAM.num_classes(model)
        self.pad_h, self.pad_w = (tuple(pad_hw) if pad_hw is not None
                                  else FAM.pad_hw(model, fam, tiny))

    def detect(self, img: torch.Tensor, img_shape, scale_factor):
        """A padded, normalized image [pad_h, pad_w, 3] on the device ->
        the fixed-shape ``DetResult``."""
        return self.family.detect(self.model, self.aux, img, img_shape,
                                  scale_factor, impl=self.impl)

    def inference_detector(self, img) -> List[np.ndarray]:
        """A raw BGR image [H, W, 3] (numpy or tensor) -> per-class
        [N, 5]."""
        imgs, img_shape, sf = prepare_frames(img[None], self.pad_h,
                                             self.pad_w, device=self.device)
        dets = self.detect(imgs[0], img_shape,
                           torch.as_tensor(sf, device=self.device))
        return result_to_per_class(dets, self.num_classes)


def init_detector(model_type: str = "FasterRCNN", checkpoint=None,
                  **kwargs) -> DetectorModel:
    """A DetectorModel; ``checkpoint`` is a saved port ``state_dict`` or a
    ``TrainState`` checkpoint of the training CLI."""
    if checkpoint is not None:
        sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
        kwargs["state_dict"] = sd.get("model", sd)
    return DetectorModel(model_type=model_type, **kwargs)


def inference_detector(model: DetectorModel, img) -> List[np.ndarray]:
    return model.inference_detector(img)


def inference_mot(model, img: np.ndarray, frame_id: int,
                  public_bboxes: Optional[np.ndarray] = None) -> Dict:
    """MOT streaming (mmtrack's ``inference_mot``): feed raw BGR frames
    [H, W, 3] of one video in order to a DeepSORT or Tracktor model. The
    frame is resized into the detector's bucket and tracked there; the
    result's boxes are divided by the scale factor, so they are in the
    original frame (ROADMAP fault F15: the JAX API leaves them resized).
    ``public_bboxes`` [N, 5] (x1, y1, x2, y2, score in the original frame)
    replace the detector and are scaled into the bucket. Tracktor gets the
    raw frame for its camera motion compensation."""
    dev = model.anchors.device
    cfg = model.detector.cfg
    frame = torch.as_tensor(np.asarray(img)).to(dev)
    imgs, img_shape, sf = prepare_frames(frame[None], cfg.pad_h, cfg.pad_w,
                                         device=dev)
    if public_bboxes is not None:
        public_bboxes = np.array(public_bboxes, np.float32).reshape(-1, 5)
        public_bboxes[:, :4] *= sf
    r = model.track_frame(frame_id, imgs[0], img_shape,
                          public_bboxes=public_bboxes, raw_img=frame)
    return rescale_result(r, sf)


class SOTModel:
    """A SiamRPN++ tracker and its state (mmtrack's ``init_model`` +
    ``inference_sot``): ``inference_sot(img, init_bbox, frame_id)`` takes
    the template at frame 0 and tracks afterwards, returning
    ``dict(track_bboxes=[x1, y1, x2, y2, score])``. ``model_kwargs`` are
    ``SiamRPNConfig`` fields; ``state_dict`` None gives seeded weights
    (``seed``); ``device`` None is the card."""

    def __init__(self, state_dict=None, seed: int = 0, device=None,
                 **model_kwargs):
        self.cfg = SR.SiamRPNConfig(**model_kwargs)
        self.device = resolve_device(device)
        full_f32_precision()
        model = SR.SiamRPN(self.cfg)
        if state_dict is None:
            S.init_params(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        n = self.cfg.score_size
        self.anchors = torch.as_tensor(SR.sot_grid_anchors(self.cfg, n),
                                       device=self.device)
        self.window = torch.as_tensor(
            SR.hanning_window(n, self.cfg.num_anchors), device=self.device)
        self.state = None

    def inference_sot(self, img, init_bbox, frame_id: int) -> Dict:
        """img: a frame [H, W, 3] (numpy or tensor, any dtype)."""
        frame = torch.as_tensor(img).to(self.device).float()
        if frame_id == 0:
            self.state = SR.sot_init(self.model, frame, np.asarray(
                init_bbox, np.float32))
            b = np.asarray(init_bbox, np.float32)
            return dict(track_bboxes=np.concatenate([b, [1.0]]))
        self.state, score, _, xyxy = SR.sot_track(
            self.model, self.state, frame, self.anchors, self.window)
        out = torch.cat([xyxy, score[None]]).cpu().numpy()
        return dict(track_bboxes=out.astype(np.float64))


def init_sot_model(checkpoint=None, **kwargs) -> SOTModel:
    """A SOTModel; ``checkpoint`` is a saved ``SiamRPN`` state dict."""
    if checkpoint is not None:
        kwargs["state_dict"] = torch.load(checkpoint, map_location="cpu",
                                          weights_only=True)
    return SOTModel(**kwargs)


def inference_sot(model: SOTModel, img, init_bbox, frame_id: int) -> Dict:
    return model.inference_sot(img, init_bbox, frame_id)
