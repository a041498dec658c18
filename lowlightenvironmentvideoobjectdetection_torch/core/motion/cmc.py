"""Camera motion compensation by ECC (Evangelidis and Psarakis) in torch,
the counterpart of the JAX package's ``core/motion/cmc.py``, which calls
``cv2.findTransformECC`` (mmtrack's
``camera_motion_compensation.py:9-75``). The card's host has no cv2, so
this module runs cv2's algorithm itself, on the frames' device, step by
step as cv2 does:

- gray: cv2's fixed-point BGR to gray (15-bit coefficients);
- the caller's 5x5, sigma 1.5 blur on the uint8 gray, with cv2's
  bit-exact integer kernel (31, 60, 74, 60, 31) / 256, rounded to uint8;
- ECC's own 5x5 Gaussian (``gaussFiltSize`` 5, sigma 0: the binomial
  (1, 4, 6, 4, 1) / 16), in float32; borders reflect (cv2's
  ``BORDER_REFLECT_101``);
- the input's gradients with the [-0.5, 0, 0.5] filter;
- each iteration warps the input and its gradients back onto the
  template's grid (inverse map, bilinear, zero outside) and the mask
  (nearest), takes the masked means and norms, the Jacobian of the warp
  (translation, euclidean or affine), the Hessian, the illumination factor
  lambda and the Gauss-Newton step; the loop stops after ``num_iters``
  iterations or when the correlation coefficient moves by less than
  ``stop_eps``.

Where cv2 raises (a flat frame: no variance, so the correlation is NaN; or
a step that would decrease the correlation), the warp is the identity, as
in the JAX package. A singular Hessian inverts to zeros, as in cv2. The
small linear algebra runs on the host in float64 on float32 values; two
host syncs an iteration (the masked means, then the projections).
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

GRAY_BGR = (3735, 19235, 9798)  # cv2's BGR2GRAY for uint8, 15-bit
GRAY_SHIFT = 15
BLUR_U8 = (31.0, 60.0, 74.0, 60.0, 31.0)  # cv2 5x5 sigma 1.5 on uint8, /256
ECC_BLUR = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)  # gaussFiltSize 5
PARAMS = {"translation": 2, "euclidean": 3, "affine": 6}

Image = Union[np.ndarray, torch.Tensor]


class ECCNoConvergence(RuntimeError):
    """Where cv2.findTransformECC raises: a NaN correlation or a step that
    would decrease it."""


def _sep_filter(x: torch.Tensor, taps) -> torch.Tensor:
    """x [H, W] float32: the separable symmetric filter ``taps`` along rows
    then columns, borders reflected without the edge pixel."""
    r = len(taps) // 2
    h, w = x.shape
    p = F.pad(x[None, None], (r, r, 0, 0), mode="reflect")[0, 0]
    rows = sum(t * p[:, i:i + w] for i, t in enumerate(taps))
    p = F.pad(rows[None, None], (0, 0, r, r), mode="reflect")[0, 0]
    return sum(t * p[i:i + h] for i, t in enumerate(taps))


def _gray_blurred(img: torch.Tensor) -> torch.Tensor:
    """A BGR frame [H, W, 3] -> cv2's uint8 gray blurred by the 5x5 sigma
    1.5 kernel, as float32 [H, W] (exact: every partial sum is an integer
    below 2^24)."""
    bgr = img.to(torch.uint8).to(torch.int32)
    gray = (bgr[..., 0] * GRAY_BGR[0] + bgr[..., 1] * GRAY_BGR[1]
            + bgr[..., 2] * GRAY_BGR[2] + (1 << (GRAY_SHIFT - 1))
            ) >> GRAY_SHIFT
    s = _sep_filter(gray.float(), BLUR_U8)
    return torch.floor((s + 32768.0) / 65536.0)


def _warp_back(stack: torch.Tensor, warp: np.ndarray, xs: torch.Tensor,
               ys: torch.Tensor):
    """Bilinear inverse-map warp of ``stack`` [N, H, W] by the 2x3 float32
    ``warp`` (zero outside), and the nearest-neighbour mask of in-range
    samples [H, W], as cv2.warpAffine with WARP_INVERSE_MAP does."""
    n, h, w = stack.shape
    m = [float(v) for v in warp.reshape(-1)]
    sx = xs * m[0] + ys * m[1] + m[2]
    sy = xs * m[3] + ys * m[4] + m[5]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    # two zero pixels around the frame: a clamped corner lands on zeros
    xi = x0.long().clamp(-2, w) + 2
    yi = y0.long().clamp(-2, h) + 2
    pad = F.pad(stack, (2, 2, 2, 2)).reshape(n, -1)
    stride = w + 4
    idx = (yi * stride + xi).reshape(-1)
    v0, v1 = pad[:, idx], pad[:, idx + 1]
    v2, v3 = pad[:, idx + stride], pad[:, idx + stride + 1]
    fx, fy = fx.reshape(-1), fy.reshape(-1)
    top = v0 + (v1 - v0) * fx
    bot = v2 + (v3 - v2) * fx
    out = (top + (bot - top) * fy).reshape(n, h, w)
    rx, ry = torch.round(sx), torch.round(sy)
    mask = (rx >= 0) & (rx < w) & (ry >= 0) & (ry < h)
    return out, mask


def _inv_or_zero(m: np.ndarray) -> np.ndarray:
    """The float32 inverse of a float32 Hessian, zeros where it is singular
    (cv2's ``Mat::inv`` with DECOMP_LU): the step is then 0 and ECC stops
    at the current warp. A frame whose texture varies along one axis only
    gives such a Hessian."""
    try:
        return np.linalg.inv(m.astype(np.float64)).astype(np.float32)
    except np.linalg.LinAlgError:
        return np.zeros_like(m)


class CameraMotionCompensation:
    def __init__(self, warp_mode: str = "euclidean",
                 num_iters: int = 50, stop_eps: float = 0.001):
        if warp_mode not in PARAMS:
            raise ValueError(f"warp_mode {warp_mode!r}: one of "
                             f"{sorted(PARAMS)}")
        self.warp_mode = warp_mode
        self.num_iters = num_iters
        self.stop_eps = stop_eps

    @staticmethod
    def prepare(img: Image, device=None) -> torch.Tensor:
        """A BGR frame [H, W, 3] (uint8 or float of integer values, numpy or
        tensor) -> the float32 image ECC works on [H, W]: gray, the caller's
        blur, ECC's own blur. A frame prepared once serves as the input of
        one estimate and the template of the next."""
        t = torch.as_tensor(img, device=device)
        return _sep_filter(_gray_blurred(t), ECC_BLUR)

    def get_warp_matrix(self, img: Image, ref_img: Image) -> np.ndarray:
        """ECC warp [2, 3] float32 from ``ref_img`` (the template) to
        ``img`` (both BGR [H, W, 3]), computed on ``img``'s device."""
        dev = img.device if torch.is_tensor(img) else None
        return self.estimate(self.prepare(img, dev),
                             self.prepare(ref_img, dev))

    def estimate(self, image: torch.Tensor, template: torch.Tensor
                 ) -> np.ndarray:
        """The warp from two ``prepare``d frames; the identity where cv2
        raises."""
        try:
            return self._ecc(image, template)
        except ECCNoConvergence:
            return np.eye(2, 3, dtype=np.float32)

    def _ecc(self, image: torch.Tensor, template: torch.Tensor) -> np.ndarray:
        mode = self.warp_mode
        k = PARAMS[mode]
        h, w = template.shape
        dev = template.device
        xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
        ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        xs, ys = xs.expand(h, w), ys.expand(h, w)
        pg = F.pad(image[None, None], (1, 1, 1, 1), mode="reflect")[0, 0]
        grad_x = -0.5 * pg[1:-1, :-2] + 0.5 * pg[1:-1, 2:]
        grad_y = -0.5 * pg[:-2, 1:-1] + 0.5 * pg[2:, 1:-1]
        stack = torch.stack([image, grad_x, grad_y])
        warp = np.eye(2, 3, dtype=np.float32)
        rho, last_rho = -1.0, -self.stop_eps
        i = 1
        while i <= self.num_iters and abs(rho - last_rho) >= self.stop_eps:
            warped, mask = _warp_back(stack, warp, xs, ys)
            img_w, gx, gy = warped[0], warped[1], warped[2]
            jac = self._jacobian(gx, gy, xs, ys, warp)  # [k, H, W] float32
            m64 = mask.double()
            tmpl64, img64 = template.double(), img_w.double()
            stats = torch.stack([
                m64.sum(), (img64 * m64).sum(), (img64 * img64 * m64).sum(),
                (tmpl64 * m64).sum(), (tmpl64 * tmpl64 * m64).sum()])
            cnt, s_i, s_ii, s_t, s_tt = stats.tolist()
            if cnt == 0:
                raise ECCNoConvergence("empty mask")
            img_mean, tmp_mean = s_i / cnt, s_t / cnt
            img_std = math.sqrt(max(s_ii / cnt - img_mean ** 2, 0.0))
            tmp_std = math.sqrt(max(s_tt / cnt - tmp_mean ** 2, 0.0))
            # cv2's masked subtract: the input keeps its value off the mask,
            # the zero-mean template is zero there
            img_zm = torch.where(mask, img_w - np.float32(img_mean), img_w)
            tmpl_zm = torch.where(mask, template - np.float32(tmp_mean),
                                  torch.zeros_like(template))
            jac64 = jac.double().reshape(k, -1)
            sums = torch.cat([
                (jac64 @ jac64.T).reshape(-1),
                jac64 @ img_zm.double().reshape(-1),
                jac64 @ tmpl_zm.double().reshape(-1),
                (tmpl_zm.double() * img_zm.double()).sum()[None]]).tolist()
            hess = np.asarray(sums[:k * k], np.float32).reshape(k, k)
            img_proj = np.asarray(sums[k * k:k * k + k], np.float32)
            tmp_proj = np.asarray(sums[k * k + k:k * k + 2 * k], np.float32)
            correlation = sums[-1]
            tmp_norm = math.sqrt(cnt * tmp_std * tmp_std)
            img_norm = math.sqrt(cnt * img_std * img_std)
            last_rho = rho
            with np.errstate(divide="ignore", invalid="ignore"):
                rho = float(np.float64(correlation) / (img_norm * tmp_norm))
            if math.isnan(rho):
                raise ECCNoConvergence("NaN encountered")
            hess_inv = _inv_or_zero(hess)
            img_proj_h = (hess_inv.astype(np.float64)
                          @ img_proj.astype(np.float64)).astype(np.float32)
            lambda_n = img_norm * img_norm - float(
                img_proj.astype(np.float64) @ img_proj_h.astype(np.float64))
            lambda_d = correlation - float(
                tmp_proj.astype(np.float64) @ img_proj_h.astype(np.float64))
            if lambda_d <= 0.0:
                raise ECCNoConvergence("the correlation would decrease")
            lam = lambda_n / lambda_d
            # J^T (lambda * template_zm - image_zm), by linearity
            err_proj = (lam * tmp_proj.astype(np.float64)
                        - img_proj.astype(np.float64)).astype(np.float32)
            delta = (hess_inv.astype(np.float64)
                     @ err_proj.astype(np.float64)).astype(np.float32)
            warp = self._update(warp, delta)
            i += 1
        return warp

    def _jacobian(self, gx, gy, xs, ys, warp):
        if self.warp_mode == "translation":
            return torch.stack([gx, gy])
        if self.warp_mode == "affine":
            return torch.stack([gx * xs, gy * xs, gx * ys, gy * ys, gx, gy])
        c, s = np.float32(warp[0, 0]), np.float32(warp[1, 0])
        hat_x = -(xs * float(s)) - (ys * float(c))
        hat_y = (xs * float(c)) - (ys * float(s))
        return torch.stack([gx * hat_x + gy * hat_y, gx, gy])

    def _update(self, warp: np.ndarray, d: np.ndarray) -> np.ndarray:
        warp = warp.copy()
        if self.warp_mode == "translation":
            warp[0, 2] += d[0]
            warp[1, 2] += d[1]
        elif self.warp_mode == "affine":
            warp[0, 0] += d[0]
            warp[1, 0] += d[1]
            warp[0, 1] += d[2]
            warp[1, 1] += d[3]
            warp[0, 2] += d[4]
            warp[1, 2] += d[5]
        else:
            theta = float(d[0]) + math.asin(float(warp[1, 0]))
            warp[0, 2] += d[1]
            warp[1, 2] += d[2]
            warp[0, 0] = warp[1, 1] = np.float32(math.cos(theta))
            warp[1, 0] = np.float32(math.sin(theta))
            warp[0, 1] = -warp[1, 0]
        return warp

    def warp_bboxes(self, bboxes: np.ndarray, warp: np.ndarray) -> np.ndarray:
        """Apply the 2x3 warp to xyxy boxes (mmtrack L26-51)."""
        if len(bboxes) == 0:
            return bboxes
        b = np.asarray(bboxes, np.float32)
        p1 = np.concatenate([b[:, :2], np.ones((len(b), 1), np.float32)], 1)
        p2 = np.concatenate([b[:, 2:4], np.ones((len(b), 1), np.float32)], 1)
        w1 = p1 @ warp.T
        w2 = p2 @ warp.T
        return np.concatenate([w1[:, :2], w2[:, :2]], axis=1)
