"""Linear motion extrapolation + camera motion compensation on the host
(numpy), the port's copy of the JAX package's ``core/motion/linear.py``.
Tracktor's camera motion compensation is the ECC one of
``core/motion/cmc.py``; no model path runs ``PhaseCorrelationCMC``.

Parity targets:
- LinearMotion: mmtracking/mmtrack/models/motion/linear_motion.py:7-77 —
  velocity averaged over the last N box pairs, extrapolated one step.
- PhaseCorrelationCMC (the JAX package's ``CameraMotionCompensation`` of
  this module): camera_motion_compensation.py:9-75 — the reference
  estimates an ECC warp with OpenCV; this one estimates a translation by
  FFT phase correlation (near-pure translation between frames, as in
  MOT17).
"""

from __future__ import annotations

from typing import List

import numpy as np


class LinearMotion:
    def __init__(self, num_samples: int = 2):
        self.num_samples = num_samples

    def step(self, bboxes: List[np.ndarray]) -> np.ndarray:
        """bboxes: history list of [4] xyxy (oldest first). Returns the
        extrapolated next box."""
        n = min(self.num_samples, len(bboxes))
        if n < 2:
            return np.asarray(bboxes[-1], np.float32)
        vels = [
            np.asarray(bboxes[-i], np.float32) - np.asarray(bboxes[-i - 1], np.float32)
            for i in range(1, n)
        ]
        velocity = np.mean(vels, axis=0)
        return np.asarray(bboxes[-1], np.float32) + velocity


class PhaseCorrelationCMC:
    """Translation-model CMC via phase correlation (cv2-free)."""

    def __init__(self, downscale: int = 4):
        self.downscale = downscale

    def estimate_shift(self, prev_img: np.ndarray, cur_img: np.ndarray):
        """Gray [H, W] images -> (dx, dy) of the camera motion."""
        d = self.downscale
        a = prev_img[::d, ::d].astype(np.float64)
        b = cur_img[::d, ::d].astype(np.float64)
        a = a - a.mean()
        b = b - b.mean()
        fa = np.fft.rfft2(a)
        fb = np.fft.rfft2(b)
        cross = fa * np.conj(fb)
        cross /= np.maximum(np.abs(cross), 1e-9)
        corr = np.fft.irfft2(cross, s=a.shape)
        peak = np.unravel_index(np.argmax(corr), corr.shape)
        dy, dx = peak
        if dy > a.shape[0] // 2:
            dy -= a.shape[0]
        if dx > a.shape[1] // 2:
            dx -= a.shape[1]
        return -dx * d, -dy * d

    def track(self, prev_img, cur_img, bboxes: np.ndarray) -> np.ndarray:
        """Warp [N, 4] previous-frame track boxes into the current frame."""
        if prev_img.ndim == 3:
            prev_img = prev_img.mean(-1)
        if cur_img.ndim == 3:
            cur_img = cur_img.mean(-1)
        dx, dy = self.estimate_shift(prev_img, cur_img)
        out = np.asarray(bboxes, np.float32).copy()
        out[:, [0, 2]] += dx
        out[:, [1, 3]] += dy
        return out
