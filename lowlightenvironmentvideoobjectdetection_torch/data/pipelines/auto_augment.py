"""AutoAugment's detection transforms, the counterpart of the JAX
package's ``data/pipelines/auto_augment.py`` (``_warp_boxes``, ``Shear``,
``Rotate``, ``Translate``, ``ColorTransform``, ``EqualizeTransform``,
``BrightnessTransform``, ``ContrastTransform``, ``AutoAugment``,
``InstaBoost``; mmdet's ``pipelines/auto_augment.py``). They run on the
host, after the loading steps, on the BGR uint8 frame and its boxes:
geometric ones warp the image and the boxes (the corners' warp, axis
aligned again and clipped), colour ones the image alone.

The JAX steps call cv2 and draw from numpy's global generator. These take
an ``np.random.RandomState`` (``np_rng``; by default one seeded from the
pipeline's ``rng``) and draw from it in the same order: seeded as the
JAX package's global, they pick the same policy and signs. ``AutoAugment``
passes its generator on to its policy's steps.

The cv2 calls are reproduced bit for bit, on cv2 5.0 as the JAX package's
tests run it:

- ``warp_affine_u8`` is ``cv2.warpAffine`` on uint8 (``INTER_LINEAR``,
  ``BORDER_CONSTANT``). cv2 inverts the 2x3 matrix in double and rounds it
  to float32, then samples in float32, with no fixed-point position table
  (cv2 5.0's default, accurate algorithm): each row's body in blocks of
  CV2_WARP_BLOCK pixels (its AVX2 code) forms the source x as
  fma(m0, x, y * m1 + m2), the row's tail (the last ``w % 16`` pixels, its
  scalar code) as fma(x, m0, y * m1) + m2, the same for y; the bilinear
  value is fma(fx, p01 - p00, p00) and the like, each of the four taps
  outside the image taking the fill value, then rounded half to even and
  saturated. An fma is emulated in float64, rounded once to float32.
- ``cv2.getRotationMatrix2D`` in double, with a float32 centre;
- ``cv2.cvtColor`` BGR -> gray on uint8, 15-bit fixed point, and gray ->
  BGR, the channel repeated;
- ``cv2.equalizeHist``: the lookup table from the histogram's sums times
  255 / (pixels - the first bin's count), in float32, rounded half to even.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

from ...core.motion.cmc import GRAY_BGR, GRAY_SHIFT
from ...registry import PIPELINES
from .transforms import _np_rng

CV2_WARP_BLOCK = 16  # the pixels of one step of cv2's vector warp body


def _fma(a, b, c) -> np.ndarray:
    """a * b + c rounded once to float32 (through float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _invert_affine(mat) -> np.ndarray:
    """cv2's inverse of a 2x3 matrix, in double -> float32 [6]."""
    m = np.asarray(mat, np.float64).reshape(-1).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[4] = a11, a22
    m[1] *= -d
    m[3] *= -d
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m.astype(np.float32)


def _source_coords(m0, m1, m2, xs, ys, body):
    """The float32 source coordinate m0 x + m1 y + m2 as cv2's body
    (``body`` True) or tail computes it."""
    return np.where(body, _fma(m0, xs, ys * m1 + m2),
                    _fma(xs, m0, ys * m1) + m2)


def warp_affine_u8(img: np.ndarray, mat, fill) -> np.ndarray:
    """``cv2.warpAffine(img, mat, (w, h), borderValue=fill)`` for a uint8
    [H, W] or [H, W, C] image."""
    squeeze = img.ndim == 2
    src = img[..., None] if squeeze else img
    h, w, c = src.shape
    m = _invert_affine(mat)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    body = xs < (w // CV2_WARP_BLOCK) * CV2_WARP_BLOCK
    sx = _source_coords(m[0], m[1], m[2], xs, ys, body)
    sy = _source_coords(m[3], m[4], m[5], xs, ys, body)
    x0, y0 = np.floor(sx), np.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    # two fill pixels around the image: a clamped tap lands on the fill
    scalar = np.zeros(4)  # cv2's Scalar, saturated to uint8
    scalar[:len(fill)] = fill
    pad = np.empty((h + 4, w + 4, c), np.float32)
    pad[...] = np.clip(np.rint(scalar), 0, 255)[:c]
    pad[2:-2, 2:-2] = src
    xi = np.clip(x0.astype(np.int64), -2, w + 1) + 2
    yi = np.clip(y0.astype(np.int64), -2, h + 1) + 2
    xj = np.minimum(xi + 1, w + 3)
    yj = np.minimum(yi + 1, h + 3)
    p00, p01 = pad[yi, xi], pad[yi, xj]
    p10, p11 = pad[yj, xi], pad[yj, xj]
    v0 = _fma(fx, p01 - p00, p00)
    v1 = _fma(fx, p11 - p10, p10)
    out = np.clip(np.rint(_fma(fy, v1 - v0, v0)), 0, 255).astype(np.uint8)
    return out[..., 0] if squeeze else out


def rotation_matrix(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: float64 [2, 3]
    (the centre rounded to float32, as cv2's Point2f)."""
    cx, cy = (float(np.float32(v)) for v in center)
    a = angle * (math.pi / 180)  # cv2: angle *= CV_PI / 180
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def bgr_to_gray_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)`` on uint8."""
    b = img.astype(np.int64)
    g = (b[..., 0] * GRAY_BGR[0] + b[..., 1] * GRAY_BGR[1]
         + b[..., 2] * GRAY_BGR[2] + (1 << (GRAY_SHIFT - 1))) >> GRAY_SHIFT
    return g.astype(np.uint8)


def equalize_hist_u8(ch: np.ndarray) -> np.ndarray:
    """``cv2.equalizeHist`` of one uint8 channel."""
    hist = np.bincount(ch.reshape(-1), minlength=256)
    first = int(np.flatnonzero(hist)[0])
    if hist[first] == ch.size:
        return np.full_like(ch, first)
    scale = np.float32(255.0) / np.float32(ch.size - hist[first])
    sums = np.cumsum(hist) - hist[:first + 1].sum()  # 0 at the first bin
    lut = np.clip(np.rint(sums.astype(np.float32) * scale), 0, 255)
    lut[:first + 1] = 0
    return lut.astype(np.uint8)[ch]


def _warp_boxes(boxes: np.ndarray, mat: np.ndarray, h: int, w: int):
    """Boxes warped by the 2x3 ``mat``: the corners' warp, axis aligned
    again and clipped (the JAX package's numpy, line for line)."""
    if boxes.size == 0:
        return boxes
    corners = np.stack([
        boxes[:, [0, 1]], boxes[:, [2, 1]], boxes[:, [0, 3]], boxes[:, [2, 3]],
    ], axis=1)  # [N, 4, 2]
    ones = np.ones((*corners.shape[:2], 1), np.float32)
    pts = np.concatenate([corners, ones], axis=-1) @ mat.T  # [N, 4, 2]
    out = np.concatenate([pts.min(axis=1), pts.max(axis=1)], axis=-1)
    out[:, 0::2] = out[:, 0::2].clip(0, w)
    out[:, 1::2] = out[:, 1::2].clip(0, h)
    return out.astype(np.float32)


class _HostStep:
    """A host step (it runs in the loader's workers, before the frame
    moves to a device): ``step(results, rng, np_rng=None)`` on one frame's
    dict or on each of a list's (the loader's image samples are lists of
    one), drawing from ``np_rng`` in turn."""

    on_host = True

    def __call__(self, results, rng=None, np_rng=None):
        np_rng = _np_rng(rng, np_rng)
        if isinstance(results, dict):
            return self.transform(results, np_rng)
        return [self.transform(r, np_rng) for r in results]

    def transform(self, results, np_rng):  # pragma: no cover - overridden
        raise NotImplementedError


class _GeometricBase(_HostStep):
    def _apply(self, results, mat):
        h, w = results["img"].shape[:2]
        for key in results.get("img_fields", ["img"]):
            results[key] = warp_affine_u8(results[key], mat,
                                          self.img_fill_val)
        for key in results.get("bbox_fields", ["gt_bboxes"]):
            if key in results:
                results[key] = _warp_boxes(results[key], mat, h, w)
        return results


@PIPELINES.register("Shear")
class Shear(_GeometricBase):
    def __init__(self, level: float = 5.0, img_fill_val=(128, 128, 128),
                 prob: float = 0.5, direction: str = "horizontal",
                 max_shear_magnitude: float = 0.3, random_negative_prob=0.5,
                 **kw):
        self.magnitude = level / 10.0 * max_shear_magnitude
        self.img_fill_val = img_fill_val
        self.prob = prob
        self.direction = direction
        self.random_negative_prob = random_negative_prob

    def transform(self, results, np_rng):
        if np_rng.rand() > self.prob:
            return results
        m = self.magnitude
        if np_rng.rand() < self.random_negative_prob:
            m = -m
        if self.direction == "horizontal":
            mat = np.float32([[1, m, 0], [0, 1, 0]])
        else:
            mat = np.float32([[1, 0, 0], [m, 1, 0]])
        return self._apply(results, mat)


@PIPELINES.register("Rotate")
class Rotate(_GeometricBase):
    def __init__(self, level: float = 5.0, scale: float = 1.0,
                 img_fill_val=(128, 128, 128), prob: float = 0.5,
                 max_rotate_angle: float = 30.0, random_negative_prob=0.5,
                 **kw):
        self.angle = level / 10.0 * max_rotate_angle
        self.scale = scale
        self.img_fill_val = img_fill_val
        self.prob = prob
        self.random_negative_prob = random_negative_prob

    def transform(self, results, np_rng):
        if np_rng.rand() > self.prob:
            return results
        a = self.angle
        if np_rng.rand() < self.random_negative_prob:
            a = -a
        h, w = results["img"].shape[:2]
        mat = rotation_matrix(((w - 1) * 0.5, (h - 1) * 0.5), a,
                              self.scale).astype(np.float32)
        return self._apply(results, mat)


@PIPELINES.register("Translate")
class Translate(_GeometricBase):
    def __init__(self, level: float = 5.0, prob: float = 0.5,
                 img_fill_val=(128, 128, 128), direction: str = "horizontal",
                 max_translate_offset: float = 250.0,
                 random_negative_prob=0.5, **kw):
        self.offset = int(level / 10.0 * max_translate_offset)
        self.prob = prob
        self.img_fill_val = img_fill_val
        self.direction = direction
        self.random_negative_prob = random_negative_prob

    def transform(self, results, np_rng):
        if np_rng.rand() > self.prob:
            return results
        off = self.offset
        if np_rng.rand() < self.random_negative_prob:
            off = -off
        if self.direction == "horizontal":
            mat = np.float32([[1, 0, off], [0, 1, 0]])
        else:
            mat = np.float32([[1, 0, 0], [0, 1, off]])
        return self._apply(results, mat)


@PIPELINES.register("ColorTransform")
class ColorTransform(_HostStep):
    """A blend of the image with its gray (PIL's Color), in float32,
    clipped and truncated to the image's dtype."""

    def __init__(self, level: float = 5.0, prob: float = 0.5, **kw):
        self.factor = 1.0 + level / 10.0 * 1.8 - 0.9  # mmdet's factor
        self.prob = prob

    def _enhance(self, img, degenerate):
        f = self.factor
        out = degenerate.astype(np.float32) * (1 - f) + \
            img.astype(np.float32) * f
        return np.clip(out, 0, 255).astype(img.dtype)

    def transform(self, results, np_rng):
        if np_rng.rand() > self.prob:
            return results
        img = results["img"]
        gray = bgr_to_gray_u8(img.astype(np.uint8))
        results["img"] = self._enhance(img, np.repeat(gray[..., None], 3,
                                                      axis=-1))
        return results


@PIPELINES.register("EqualizeTransform")
class EqualizeTransform(_HostStep):
    def __init__(self, prob: float = 0.5, **kw):
        self.prob = prob

    def transform(self, results, np_rng):
        if np_rng.rand() > self.prob:
            return results
        img = results["img"].astype(np.uint8)
        chans = [equalize_hist_u8(img[..., c]) for c in range(img.shape[-1])]
        results["img"] = np.stack(chans, axis=-1).astype(results["img"].dtype)
        return results


@PIPELINES.register("BrightnessTransform")
class BrightnessTransform(ColorTransform):
    def transform(self, results, np_rng):
        if np_rng.rand() > self.prob:
            return results
        img = results["img"]
        results["img"] = self._enhance(img, np.zeros_like(img))
        return results


@PIPELINES.register("ContrastTransform")
class ContrastTransform(ColorTransform):
    def transform(self, results, np_rng):
        if np_rng.rand() > self.prob:
            return results
        img = results["img"]
        mean = np.full_like(img, int(img.astype(np.float32).mean()))
        results["img"] = self._enhance(img, mean)
        return results


@PIPELINES.register("AutoAugment")
class AutoAugment(_HostStep):
    """One policy (a list of the steps above, as config dicts) drawn for
    each call, its steps run in order on the same generator."""

    def __init__(self, policies: Sequence[Sequence[dict]]):
        self.policies: List[List] = [
            [PIPELINES.get(t["type"])(**{k: v for k, v in t.items()
                                         if k != "type"}) for t in policy]
            for policy in policies]

    def transform(self, results, np_rng):
        policy = self.policies[np_rng.randint(len(self.policies))]
        for t in policy:
            results = t.transform(results, np_rng)
        return results


@PIPELINES.register("InstaBoost")
class InstaBoost(_HostStep):
    """A stub, as in the JAX package and mmdet: the augmentation needs the
    ``instaboostfast`` package, which neither bundles."""

    def __init__(self, **kw):
        raise ImportError(
            "InstaBoost requires the 'instaboostfast' package (not bundled; "
            "the reference imports it from pip at the same point)")
