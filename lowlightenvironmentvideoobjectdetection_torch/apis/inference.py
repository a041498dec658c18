"""Public streaming inference API for SELSA, the counterpart of the JAX
package's ``apis/inference.py`` (``VIDModel``, ``init_model``,
``inference_vid``, ``result_to_per_class``)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.preprocess import prepare_frames
from ..models.vid import selsa as S


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
    """A built SELSA video detector with its streaming memo.

    ``ref_method``: 'adaptive' keeps the frame-0 memo for the whole video;
    'fix' rolls each streamed frame's own K/V into it every
    ``frame_stride`` frames. ``state_dict`` None gives seeded random weights
    (``init_params`` with a CPU generator seeded by ``seed``)."""

    def __init__(self, model_type: str = "SELSA", state_dict=None,
                 seed: int = 0, ref_method: str = "adaptive",
                 frame_stride: int = 1, device=None, **cfg_kwargs):
        if model_type != "SELSA":
            raise ValueError(f"model type {model_type!r}: the port has SELSA "
                             "only")
        if ref_method not in ("adaptive", "fix"):
            raise ValueError(f"unknown ref_method {ref_method!r}")
        self.cfg = S.SelsaConfig(**cfg_kwargs)
        self.device = torch.device(device if device is not None else "cpu")
        model = S.SelsaDetector(self.cfg)
        if state_dict is None:
            S.init_params(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict, strict=True)
        self.model = S.cast_for_inference(model.to(self.device).eval())
        self.anchors = S.make_anchors(self.cfg, self.device)
        self.ref_method = ref_method
        self.frame_stride = max(int(frame_stride), 1)
        self.state: Optional[S.VideoState] = None

    def _step(self, img, img_shape, sf, frame_id, refs):
        if frame_id == 0:
            self.state = S.init_video_state(self.model, refs, img_shape,
                                            self.anchors)
        do = self.ref_method != "fix" or frame_id % self.frame_stride == 0
        self.state, dets = S.inference_step(
            self.model, self.state, img, img_shape, sf, self.anchors,
            update_memo=self.ref_method == "fix", do_update=do)
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

    def _pad_prepared(self, img: np.ndarray) -> torch.Tensor:
        """Pad an already resized and normalized image to the bucket, keeping
        the model's input channels."""
        cfg = self.cfg
        keep = min(img.shape[-1], 3)
        canvas = np.zeros((cfg.pad_h, cfg.pad_w, keep), np.float32)
        h, w = min(img.shape[0], cfg.pad_h), min(img.shape[1], cfg.pad_w)
        canvas[:h, :w] = img[:h, :w, :keep]
        return torch.as_tensor(canvas, device=self.device)

    def inference_vid_prepared(self, img: np.ndarray, img_shape=None,
                               scale_factor=None, frame_id: int = 0,
                               ref_imgs: Optional[np.ndarray] = None) -> Dict:
        """Streaming over pipeline-prepared images: only the pad happens
        here. ``scale_factor`` maps detections back to the original frame."""
        cfg = self.cfg
        canvas = self._pad_prepared(img)
        if img_shape is None:
            img_shape = img.shape[:2]
        shape = torch.tensor([float(img_shape[0]), float(img_shape[1])],
                             device=self.device)
        if scale_factor is None:
            scale_factor = np.ones((4,), np.float32)
        sf = torch.as_tensor(np.asarray(scale_factor, np.float32),
                             device=self.device)
        refs = None
        if frame_id == 0:
            if ref_imgs is None:
                refs = canvas[None].repeat(cfg.num_ref_frames, 1, 1, 1)
            else:
                refs = torch.stack([self._pad_prepared(r) for r in ref_imgs])
        dets = self._step(canvas, shape, sf, frame_id, refs)
        return dict(bbox_results=result_to_per_class(dets, cfg.num_classes))


def init_model(model_type: str = "SELSA", checkpoint=None, **kwargs
               ) -> VIDModel:
    """Build a VIDModel; ``checkpoint`` is a saved port ``state_dict``."""
    if checkpoint is not None:
        kwargs["state_dict"] = torch.load(checkpoint, map_location="cpu",
                                          weights_only=True)
    return VIDModel(model_type=model_type, **kwargs)


def inference_vid(model: VIDModel, frame: np.ndarray, frame_id: int,
                  ref_frames: Optional[np.ndarray] = None) -> Dict:
    return model.inference_vid(frame, frame_id, ref_frames)
