"""DeepSORT and Tracktor, the counterparts of the JAX package's
``models/mot/deep_sort.py`` (mmtracking's ``mot/deep_sort.py`` and
``mot/tracktor.py``): the detector and the ReID net run on the card, the
association on the host (``trackers.py``).

- ``DeepSORT``: Faster R-CNN detections (``detectors/faster_rcnn.py``, its
  RoIAlign kernel B on CUDA tensors) or the given public boxes, ReID
  embeddings of their crops (``crop_and_resize``, then ``BaseReID``), then
  ``SortTracker``. On the private path only the first ``max_reid_dets`` = 48
  rows of the score-descending detections are embedded and tracked, as in
  JAX (ROADMAP fault F2: the original embeds every detection); the public
  path embeds every box.
- ``Tracktor``: the previous frame's track boxes, warped by the camera
  motion (ECC, ``core/motion/cmc.py``) and extrapolated by linear motion
  where configured, are re-regressed by the detector's RoI head on the
  current frame (``regress``: kernel B on at most ``max_tracks`` = 64 rois),
  then ``TracktorTracker`` keeps the ones still scored as objects and
  starts tracks from the detections that overlap none. The frame's neck
  feature is computed once and serves both the regression and the
  detection (JAX runs the backbone twice on the same frame).

Both track in the coordinates of the resized frame they are given, as JAX
does; ``rescale_result`` maps a frame's result back to the original frame
(ROADMAP fault F15: the JAX API and CLI leave it resized).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ...core import boxes as box_ops
from ...core.motion.cmc import CameraMotionCompensation
from ...core.motion.linear import LinearMotion
from ...ops.scale_translate import scale_and_translate
from ..detectors.faster_rcnn import FasterRCNN, faster_rcnn_detect, rcnn_detect
from ..reid.base_reid import BaseReID
from ..roi_heads import bbox_head as bh
from .trackers import SortTracker, TracktorTracker

REID_CROP_HW = (256, 128)
MAX_REID_DETS = 48
MAX_TRACKS = 64
HISTORY = 8  # boxes kept a track for linear motion


def crop_and_resize(img: torch.Tensor, boxes: torch.Tensor,
                    out_hw=REID_CROP_HW) -> torch.Tensor:
    """img [H, W, 3], boxes [N, 4] xyxy -> crops [N, oh, ow, 3] float32:
    each box's region resampled as ``jax.image.scale_and_translate``
    (antialiased when it shrinks, ROADMAP fault F14), boxes under 1 px
    widened to 1."""
    oh, ow = out_hw
    boxes = boxes.float()
    x1, y1 = boxes[:, 0], boxes[:, 1]
    bw = torch.clamp(boxes[:, 2] - x1, min=1.0)
    bh_ = torch.clamp(boxes[:, 3] - y1, min=1.0)
    scale = torch.stack([oh / bh_, ow / bw], -1)
    translation = torch.stack([-y1 * oh / bh_, -x1 * ow / bw], -1)
    return scale_and_translate(img, out_hw, scale, translation)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def rescale_result(result: Dict, scale_factor) -> Dict:
    """A frame's result in the resized frame -> in the original frame:
    ``det_bboxes``' and ``track_bboxes``' boxes divided by ``scale_factor``
    [4] (mmtrack's ``rescale=True``)."""
    sf = np.asarray(scale_factor, np.float32).reshape(4)
    out = dict(result)
    det = np.array(result["det_bboxes"], np.float32)
    det[:, :4] /= sf
    trk = np.array(result["track_bboxes"], np.float32)
    trk[:, 1:5] /= sf
    out.update(det_bboxes=det, track_bboxes=trk)
    return out


class DeepSORT:
    """The detector and the ReID net on their device, ``SortTracker`` on
    the host."""

    def __init__(self, detector: FasterRCNN, anchors: torch.Tensor,
                 reid: Optional[BaseReID] = None,
                 tracker: Optional[SortTracker] = None,
                 max_reid_dets: int = MAX_REID_DETS):
        self.detector = detector
        self.anchors = anchors
        self.reid = reid
        self.tracker = tracker or SortTracker()
        self.max_reid_dets = max_reid_dets

    def reset(self):
        self.tracker.reset()

    def state_dict(self) -> Dict[str, torch.Tensor]:
        sd = {f"detector.{k}": v for k, v in
              self.detector.state_dict().items()}
        if self.reid is not None:
            sd.update({f"reid.{k}": v for k, v in
                       self.reid.state_dict().items()})
        return sd

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        _load(self.detector, sd, "detector.")
        if self.reid is not None:
            _load(self.reid, sd, "reid.")

    @torch.no_grad()
    def embed(self, img: torch.Tensor, boxes: torch.Tensor) -> np.ndarray:
        """ReID embeddings [N, 128] (host float32) of the boxes' crops of
        the normalized frame img [H, W, 3]."""
        if boxes.shape[0] == 0:
            return np.zeros((0, self.reid.head.fc_out.out_features),
                            np.float32)
        return _np(self.reid(crop_and_resize(img, boxes)))

    @torch.no_grad()
    def detect(self, img: torch.Tensor, img_shape):
        """Private detections of img [H, W, 3] -> host (boxes, scores,
        labels, embeds or None): with a ReID net, the valid ones of the
        first ``max_reid_dets`` rows and their embeddings (F2)."""
        dets = faster_rcnn_detect(self.detector, img, img_shape,
                                  self.anchors)
        embeds = None
        if self.reid is not None:
            k = self.max_reid_dets
            valid = dets.valid[:k]
            boxes = dets.boxes[:k][valid]
            scores, labels = dets.scores[:k][valid], dets.labels[:k][valid]
            embeds = self.embed(img, boxes)
        else:
            boxes, scores = dets.boxes[dets.valid], dets.scores[dets.valid]
            labels = dets.labels[dets.valid]
        return _np(boxes), _np(scores), labels.cpu().numpy(), embeds

    def track_frame(self, frame_id: int, img: torch.Tensor, img_shape,
                    public_bboxes: Optional[np.ndarray] = None,
                    raw_img=None) -> Dict:
        """One frame: img [H, W, 3] normalized and padded, ``img_shape``
        (h, w) of its content, ``public_bboxes`` [N, 5] (x1, y1, x2, y2,
        score) in its coordinates or None. Returns dict(det_bboxes [N, 5],
        det_labels, track_bboxes [M, 6] (id, box, score), track_labels).
        ``raw_img`` is unused (Tracktor's signature)."""
        if frame_id == 0:
            self.tracker.reset()
        if public_bboxes is None:
            boxes, scores, labels, embeds = self.detect(img, img_shape)
        else:
            pub = np.asarray(public_bboxes, np.float32).reshape(-1, 5)
            boxes, scores = pub[:, :4], pub[:, 4]
            labels = np.zeros(len(boxes), np.int64)
            embeds = None
            if self.reid is not None:
                embeds = self.embed(img, torch.as_tensor(boxes).to(
                    img.device))
        ids, _ = self.tracker.track(frame_id, boxes, scores, labels, embeds)
        m = ids >= 0
        track_bboxes = np.concatenate(
            [ids[m, None].astype(np.float32), boxes[m], scores[m, None]],
            axis=1)
        det_bboxes = np.concatenate([boxes, scores[:, None]], axis=1)
        return dict(det_bboxes=det_bboxes, det_labels=labels,
                    track_bboxes=track_bboxes, track_labels=labels[m])

    def track_video(self, imgs: Iterable[torch.Tensor], img_shape):
        """Private detections over a sequence of prepared frames: the
        results of ``track_frame`` called frame by frame from frame 0."""
        return [self.track_frame(fid, img, img_shape)
                for fid, img in enumerate(imgs)]


class Tracktor:
    """Tracktor with optional camera motion compensation (ECC on the raw
    frames, euclidean) and linear motion (``linear_motion_num_samples``
    boxes of each track's last ``HISTORY``)."""

    def __init__(self, detector: FasterRCNN, anchors: torch.Tensor,
                 tracker: Optional[TracktorTracker] = None,
                 max_tracks: int = MAX_TRACKS, with_cmc: bool = False,
                 with_linear_motion: bool = False,
                 linear_motion_num_samples: int = 2):
        self.detector = detector
        self.anchors = anchors
        self.tracker = tracker or TracktorTracker()
        self.max_tracks = max_tracks
        self.with_cmc = with_cmc
        self.with_linear_motion = with_linear_motion
        self.cmc = CameraMotionCompensation() if with_cmc else None
        self.linear_motion = (LinearMotion(linear_motion_num_samples)
                              if with_linear_motion else None)
        self.reset()

    def reset(self):
        self.tracker.reset()
        self._last_frame: Optional[torch.Tensor] = None  # prepared for ECC
        self._history: Dict[int, list] = {}

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {f"detector.{k}": v for k, v in
                self.detector.state_dict().items()}

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        _load(self.detector, sd, "detector.")

    @torch.no_grad()
    def regress(self, feat: torch.Tensor, boxes: np.ndarray):
        """Re-regress boxes [N, 4] (host) on the neck feature [1, h, w, C]
        with the RoI head: the best foreground class's score and its
        decoded box (stds ``BBOX_STDS``, no clipping). Returns host
        (boxes [N, 4], scores [N])."""
        det = self.detector
        rois = torch.as_tensor(np.asarray(boxes, np.float32)).to(feat.device)
        rf = det.roi_feats(feat[0], rois,
                           torch.zeros(rois.shape[0], dtype=torch.int64,
                                       device=feat.device))
        cls_score, bbox_pred = det.bbox_forward(rf)
        scores = torch.softmax(cls_score.float(), -1)
        nc = det.cfg.num_classes
        best = torch.argmax(scores[:, :nc], -1)
        fg = torch.gather(scores[:, :nc], 1, best[:, None])[:, 0]
        pred = bbox_pred.float().reshape(-1, nc, 4)
        pred = torch.gather(pred, 1, best[:, None, None].expand(-1, 1, 4))
        new = box_ops.delta2bbox(rois, pred[:, 0], stds=bh.BBOX_STDS)
        return _np(new), _np(fg)

    def _moved_boxes(self, active, raw_frame):
        """The active tracks' last boxes warped by the camera motion from
        the last frame to this one and extrapolated by linear motion, as
        configured."""
        prev = np.stack([self.tracker.tracks[t].bbox for t in active])
        if raw_frame is not None and self._last_frame is not None:
            warp = self.cmc.estimate(raw_frame, self._last_frame)
            prev = self.cmc.warp_bboxes(prev, warp)
        if self.with_linear_motion:
            n = self.linear_motion.num_samples
            for k, t in enumerate(active):
                hist = self._history.get(t)
                if hist and len(hist) >= 2:
                    prev[k] = self.linear_motion.step(hist[-n:] + [prev[k]])
        return prev

    @torch.no_grad()
    def track_frame(self, frame_id: int, img: torch.Tensor, img_shape,
                    public_bboxes: Optional[np.ndarray] = None,
                    raw_img=None) -> Dict:
        """One frame, as ``DeepSORT.track_frame``; ``raw_img`` is the
        original BGR frame [H, W, 3] (numpy or a tensor), which camera
        motion compensation needs (without it the warp is left out, as
        the JAX CLI leaves it out: ROADMAP fault F16)."""
        if frame_id == 0:
            self.reset()
        feat = self.detector.extract_feat(img[None])
        raw_frame = None
        if self.with_cmc and raw_img is not None:
            raw_frame = self.cmc.prepare(raw_img, img.device)
        regressed_boxes = regressed_scores = None
        active = self.tracker.ids
        if active:
            prev = self._moved_boxes(active, raw_frame)[:self.max_tracks]
            regressed_boxes, regressed_scores = self.regress(feat, prev)
        if public_bboxes is None:
            dets = rcnn_detect(self.detector, feat, img_shape, None,
                               self.anchors)
            valid = dets.valid
            boxes, scores = _np(dets.boxes[valid]), _np(dets.scores[valid])
            labels = dets.labels[valid].cpu().numpy()
        else:
            pub = np.asarray(public_bboxes, np.float32).reshape(-1, 5)
            boxes, scores = pub[:, :4], pub[:, 4]
            labels = np.zeros(len(boxes), np.int64)
        ids, tb, ts, tl = self.tracker.track(
            frame_id, boxes, scores, labels, regressed_boxes,
            regressed_scores)
        for i, t in enumerate(ids):
            hist = self._history.setdefault(int(t), [])
            hist.append(tb[i].copy())
            del hist[:-HISTORY]
        if raw_frame is not None:
            self._last_frame = raw_frame
        track_bboxes = np.concatenate(
            [ids[:, None].astype(np.float32), tb, ts[:, None]], axis=1) \
            if len(ids) else np.zeros((0, 6), np.float32)
        return dict(det_bboxes=np.concatenate([boxes, scores[:, None]], 1),
                    det_labels=labels, track_bboxes=track_bboxes,
                    track_labels=tl)


def _load(module: torch.nn.Module, sd: Dict[str, torch.Tensor],
          prefix: str) -> None:
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                            if k.startswith(prefix)}, strict=True)
