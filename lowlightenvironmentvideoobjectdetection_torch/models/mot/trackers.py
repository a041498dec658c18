"""Multi-object trackers on the host (numpy), the port's copy of the JAX
package's ``models/mot/trackers.py``.

Parity targets:
- BaseTracker: mmtracking/mmtrack/models/mot/trackers/base_tracker.py:11-224
  — per-id track store with momentum-updated embeddings and a pooled ``memo``.
- SortTracker: sort_tracker.py:12-217 — SORT/DeepSORT: per-track xyah Kalman,
  ReID Mahalanobis-gated cosine matching then IoU matching via the Hungarian
  algorithm, tentative-track confirmation.
- TracktorTracker: tracktor_tracker.py:11-214 — regression-based tracking
  using the detector's RoI head, CMC/linear motion, ReID re-activation.

The per-frame assignment is small, sequential host numpy with the port's
own JV solver (``ops/lap.py``); the detector and the ReID net run on the
card, and only their boxes and embeddings come back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
from ...core.motion.kalman import KalmanFilter
from ...ops.lap import linear_sum_assignment


def xyxy2xyah(b: np.ndarray) -> np.ndarray:
    cx = (b[..., 0] + b[..., 2]) / 2
    cy = (b[..., 1] + b[..., 3]) / 2
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    return np.stack([cx, cy, w / np.maximum(h, 1e-6), h], axis=-1)


def xyah2xyxy(m: np.ndarray) -> np.ndarray:
    cx, cy, a, h = m[..., 0], m[..., 1], m[..., 2], m[..., 3]
    w = a * h
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1)


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


@dataclasses.dataclass
class Track:
    bbox: np.ndarray  # [4] xyxy
    score: float
    label: int
    frame_id: int
    embed: Optional[np.ndarray] = None
    mean: Optional[np.ndarray] = None  # Kalman state
    covariance: Optional[np.ndarray] = None
    tentative: bool = False
    hits: int = 1


class BaseTracker:
    """Track store with momentum embedding updates (base_tracker.py:51-119)."""

    def __init__(self, momentums: Optional[Dict[str, float]] = None,
                 num_frames_retain: int = 30):
        self.momentums = momentums or {}
        self.num_frames_retain = num_frames_retain
        self.reset()

    def reset(self):
        self.tracks: Dict[int, Track] = {}
        self.num_tracks = 0

    @property
    def empty(self) -> bool:
        return not self.tracks

    @property
    def ids(self) -> List[int]:
        return list(self.tracks.keys())

    def init_track(self, frame_id, bbox, score, label, embed=None, **kw) -> int:
        tid = self.num_tracks
        self.num_tracks += 1
        self.tracks[tid] = Track(
            bbox=bbox, score=float(score), label=int(label),
            frame_id=frame_id, embed=embed, **kw,
        )
        return tid

    def update_track(self, tid, frame_id, bbox, score, label, embed=None):
        t = self.tracks[tid]
        t.bbox = bbox
        t.score = float(score)
        t.label = int(label)
        t.frame_id = frame_id
        if embed is not None:
            m = self.momentums.get("embeds", None)
            if m is not None and t.embed is not None:
                t.embed = (1 - m) * t.embed + m * embed
            else:
                t.embed = embed

    def pop_invalid_tracks(self, frame_id):
        for tid in list(self.tracks):
            if frame_id - self.tracks[tid].frame_id >= self.num_frames_retain:
                del self.tracks[tid]

    def memo(self):
        """Pooled (ids, bboxes, labels, embeds) arrays."""
        ids = np.asarray(self.ids, np.int64)
        bboxes = np.stack([t.bbox for t in self.tracks.values()]) if self.tracks \
            else np.zeros((0, 4))
        labels = np.asarray([t.label for t in self.tracks.values()], np.int64)
        embeds = (
            np.stack([t.embed for t in self.tracks.values()])
            if self.tracks and next(iter(self.tracks.values())).embed is not None
            else None
        )
        return ids, bboxes, labels, embeds


class SortTracker(BaseTracker):
    """SORT / DeepSORT association (sort_tracker.py semantics)."""

    def __init__(
        self,
        obj_score_thr: float = 0.3,
        reid_sim_thr: float = 2.0,
        match_iou_thr: float = 0.7,
        num_tentatives: int = 3,
        momentums: Optional[Dict[str, float]] = None,
        num_frames_retain: int = 30,
    ):
        super().__init__(momentums=momentums, num_frames_retain=num_frames_retain)
        self.obj_score_thr = obj_score_thr
        self.reid_sim_thr = reid_sim_thr
        self.match_iou_thr = match_iou_thr
        self.num_tentatives = num_tentatives
        self.kf = KalmanFilter()

    @property
    def confirmed_ids(self):
        return [tid for tid, t in self.tracks.items() if not t.tentative]

    def track(self, frame_id: int, bboxes: np.ndarray, scores: np.ndarray,
              labels: np.ndarray, embeds: Optional[np.ndarray] = None):
        """One frame. Returns (track_ids [N], keep_mask [N]) aligned with the
        input detections (unassigned dets get fresh ids if above threshold)."""
        n = len(bboxes)
        ids = np.full(n, -1, np.int64)
        valid = scores > self.obj_score_thr

        if frame_id == 0 or self.empty:
            for i in np.flatnonzero(valid):
                tid = self._new_track(frame_id, bboxes[i], scores[i], labels[i],
                                      None if embeds is None else embeds[i])
                ids[i] = tid
            self.pop_invalid_tracks(frame_id)
            return ids, valid

        # Kalman predict for all tracks + Mahalanobis gating costs
        self.tracks, motion_costs = self.kf.track(self.tracks, xyxy2xyah(bboxes))
        track_ids = self.ids

        assigned_det = np.zeros(n, bool)
        assigned_track = set()

        # 1) ReID matching on confirmed tracks, gated by motion distance
        if embeds is not None and self.confirmed_ids:
            pos = {t: k for k, t in enumerate(track_ids)}
            conf_idx = [pos[t] for t in self.confirmed_ids]
            track_embeds = np.stack([self.tracks[t].embed for t in self.confirmed_ids])
            sim = track_embeds @ embeds.T / (
                np.linalg.norm(track_embeds, axis=1, keepdims=True)
                * np.maximum(np.linalg.norm(embeds, axis=1), 1e-9)[None]
            )
            cost = 1.0 - sim
            gate = motion_costs[conf_idx] > self.kf.gating_threshold
            cost[gate] = 1e6
            cost[:, ~valid] = 1e6
            row, col = linear_sum_assignment(cost)
            for r, c in zip(row, col):
                if cost[r, c] < 1e5 and (1.0 - cost[r, c]) > 1.0 / self.reid_sim_thr - 1:
                    tid = self.confirmed_ids[r]
                    ids[c] = tid
                    assigned_det[c] = True
                    assigned_track.add(tid)

        # 2) IoU matching for the rest (incl. tentative tracks)
        rest_tracks = [t for t in track_ids if t not in assigned_track]
        rest_dets = np.flatnonzero(valid & ~assigned_det)
        if rest_tracks and len(rest_dets):
            t_boxes = xyah2xyxy(
                np.stack([self.tracks[t].mean[:4] for t in rest_tracks])
            )
            ious = iou_matrix(t_boxes, bboxes[rest_dets])
            cost = 1.0 - ious
            row, col = linear_sum_assignment(cost)
            for r, c in zip(row, col):
                if ious[r, c] > 1.0 - self.match_iou_thr:
                    tid = rest_tracks[r]
                    di = rest_dets[c]
                    ids[di] = tid
                    assigned_det[di] = True
                    assigned_track.add(tid)

        # update matched (batched Kalman correction across all matches),
        # spawn new tracks for unmatched valid dets
        matched = np.flatnonzero(ids >= 0)
        if len(matched):
            tids = [int(ids[i]) for i in matched]
            means = np.stack([self.tracks[t].mean for t in tids])
            covs = np.stack([self.tracks[t].covariance for t in tids])
            new_means, new_covs = self.kf.update_batch(
                means, covs, xyxy2xyah(bboxes[matched]))
            for k, (i, tid) in enumerate(zip(matched, tids)):
                t = self.tracks[tid]
                t.mean, t.covariance = new_means[k], new_covs[k]
                t.hits += 1
                if t.tentative and t.hits >= self.num_tentatives:
                    t.tentative = False
                self.update_track(tid, frame_id, bboxes[i], scores[i],
                                  labels[i],
                                  None if embeds is None else embeds[i])
        for i in np.flatnonzero(valid & (ids < 0)):
            ids[i] = self._new_track(
                frame_id, bboxes[i], scores[i], labels[i],
                None if embeds is None else embeds[i],
            )
        self.pop_invalid_tracks(frame_id)
        return ids, valid

    def _new_track(self, frame_id, bbox, score, label, embed):
        mean, cov = self.kf.initiate(xyxy2xyah(bbox[None])[0])
        return self.init_track(
            frame_id, bbox, score, label, embed,
            mean=mean, covariance=cov, tentative=True, hits=1,
        )


class TracktorTracker(BaseTracker):
    """Tracktor: propagate boxes by re-regressing them with the detector's RoI
    head; new tracks from leftover detections; optional ReID re-activation."""

    def __init__(
        self,
        obj_score_thr: float = 0.5,
        regression_score_thr: float = 0.5,
        nms_iou_thr: float = 0.6,
        momentums: Optional[Dict[str, float]] = None,
        num_frames_retain: int = 10,
    ):
        super().__init__(momentums=momentums, num_frames_retain=num_frames_retain)
        self.obj_score_thr = obj_score_thr
        self.regression_score_thr = regression_score_thr
        self.nms_iou_thr = nms_iou_thr

    def track(self, frame_id, det_bboxes, det_scores, det_labels,
              regressed_bboxes=None, regressed_scores=None):
        """regressed_*: the previous frame's track boxes re-regressed by the
        detector roi head on the current frame (supplied by the model, which
        owns the compiled regression step)."""
        active = self.ids
        # 1) keep regressed tracks above threshold
        if regressed_bboxes is not None and active:
            for tid, bbox, score in zip(active, regressed_bboxes, regressed_scores):
                if score >= self.regression_score_thr:
                    t = self.tracks[tid]
                    self.update_track(tid, frame_id, bbox, float(score), t.label)
                # else: track goes stale and expires via num_frames_retain

        # 2) suppress detections overlapping active tracks, spawn the rest
        ids = np.full(len(det_bboxes), -1, np.int64)
        valid = det_scores > self.obj_score_thr
        cur = [tid for tid, t in self.tracks.items() if t.frame_id == frame_id]
        if cur:
            t_boxes = np.stack([self.tracks[t].bbox for t in cur])
            ious = iou_matrix(t_boxes, det_bboxes)
            overlapped = (ious > self.nms_iou_thr).any(axis=0)
            valid = valid & ~overlapped
        for i in np.flatnonzero(valid):
            ids[i] = self.init_track(
                frame_id, det_bboxes[i], det_scores[i], det_labels[i]
            )
        self.pop_invalid_tracks(frame_id)

        # output: all tracks alive at this frame
        out_ids, out_boxes, out_scores, out_labels = [], [], [], []
        for tid, t in self.tracks.items():
            if t.frame_id == frame_id:
                out_ids.append(tid)
                out_boxes.append(t.bbox)
                out_scores.append(t.score)
                out_labels.append(t.label)
        return (
            np.asarray(out_ids, np.int64),
            np.stack(out_boxes) if out_boxes else np.zeros((0, 4)),
            np.asarray(out_scores),
            np.asarray(out_labels, np.int64),
        )
