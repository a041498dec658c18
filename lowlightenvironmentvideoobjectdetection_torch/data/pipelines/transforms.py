"""The device steps of the data pipelines, the counterpart of the JAX
package's ``data/pipelines/transforms.py``: geometric (``Resize``,
``RandomFlip``, ``Pad`` and their ``Seq`` forms), photometric
(``Brighten``, ``NormalizePairs``) and the RAW and noise steps
(``NormalizeRAW``, ``SRGB2RAW``, ``AddNoise``). They take a frame's dict
(or a clip's list) whose images are tensors and work where the tensors
lie: on the card in training, on the CPU in the tests.

Two steps reproduce the host arithmetic of the JAX package bit for bit:

- ``Resize`` is ``cv2.resize(..., INTER_LINEAR)`` on uint8: cv2's 11-bit
  coefficients (computed here on the host as cv2 does: float32 source
  positions, the horizontal ones clamped at the borders, the vertical rows
  clamped but their weights not), a horizontal pass of exact integer sums,
  and cv2's vertical pass as its SIMD code computes it: each row sum
  shifted right by 4, multiplied by its 16-bit weight keeping the high 16
  bits, the two added, then (sum + 2) >> 2 (a shift of 22 in all, with the
  truncations between).
- ``Brighten``'s amplification divides by numpy's float32 sum of the dark
  frame. ``numpy_float32_sum`` adds in numpy's order: blocks of 8192
  elements (its buffer), each summed pairwise down to runs of at most 128
  in 8 interleaved accumulators, the blocks' sums in sequence.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ...ops import noise as N
from ...ops import unprocess as U
from ...registry import PIPELINES
from .loading import _frames, _SeqMixin

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def _f32(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# cv2's INTER_LINEAR on uint8
# ---------------------------------------------------------------------------

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS


def _linear_coefs(src: int, dst: int, clamp_weights: bool):
    """cv2's source indices and 11-bit weights for each output position."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
         ).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:  # x: at the borders one source pixel, weight 1
        edge = (s < 0) | (s >= src - 1)
        f[edge] = 0
        s = np.clip(s, 0, src - 1)
    w1 = np.rint(f * np.float32(COEF_SCALE)).astype(np.int32)
    w0 = np.rint((np.float32(1) - f) * np.float32(COEF_SCALE)
                 ).astype(np.int32)
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1)


def resize_linear_u8(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """uint8 [H, W, C] -> [nh, nw, C], equal to ``cv2.resize(img, (nw,
    nh), interpolation=cv2.INTER_LINEAR)``."""
    if img.dtype != torch.uint8:
        raise TypeError(f"resize_linear_u8 takes uint8, not {img.dtype}")
    h, w, c = img.shape
    if (h, w) == (2 * nh, 2 * nw):  # cv2 takes INTER_AREA here
        x = img.to(torch.int32)
        s = (x[0::2, 0::2] + x[0::2, 1::2]) + (x[1::2, 0::2] + x[1::2, 1::2])
        if c in (1, 3, 4):  # its fast path, rounding half up
            return ((s + 2) >> 2).to(torch.uint8)
        return torch.round(s.float() * 0.25).to(torch.uint8)  # half to even
    dev = img.device
    x0, x1, a0, a1 = (torch.as_tensor(v, device=dev)
                      for v in _linear_coefs(w, nw, True))
    y0, y1, b0, b1 = (torch.as_tensor(v, device=dev)
                      for v in _linear_coefs(h, nh, False))
    src = img.to(torch.int32)

    def horizontal(rows):
        return rows[:, x0] * a0[:, None] + rows[:, x1] * a1[:, None]

    def vertical(row_sum, weight):
        return ((row_sum >> 4) * weight[:, None, None]) >> 16

    out = (vertical(horizontal(src[y0]), b0)
           + vertical(horizontal(src[y1]), b1) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# numpy's float32 sum
# ---------------------------------------------------------------------------

NP_BUFSIZE = 8192  # numpy's reduction buffer, in elements
NP_LEAF = 128  # pairwise summation's largest run


@functools.lru_cache(maxsize=32)
def _pairwise_plan(n: int):
    """numpy's pairwise-summation tree over n (<= NP_BUFSIZE) elements, as
    index arrays: each leaf's 16 x 8 accumulator grid and its up to 7
    trailing elements (-1 reads a zero), then per level of the tree the
    nodes it computes and their two children, in slots after the
    leaves."""
    leaves, nodes = [], []

    def split(start, m):
        if m <= NP_LEAF:
            leaves.append((start, m))
            return ("leaf", len(leaves) - 1)
        half = m // 2
        half -= half % 8
        node = (split(start, half), split(start + half, m - half))
        nodes.append(node)
        return ("node", len(nodes) - 1)

    split(0, n)
    grid = np.full((len(leaves), 16, 8), -1, np.int64)
    tail = np.full((len(leaves), 7), -1, np.int64)
    for i, (start, m) in enumerate(leaves):
        body = m - m % 8 if m >= 8 else 0
        grid[i, :body // 8] = start + np.arange(body).reshape(-1, 8)
        tail[i, :m - body] = np.arange(start + body, start + m)
    slot = {("leaf", i): i for i in range(len(leaves))}
    slot.update({("node", i): len(leaves) + i for i in range(len(nodes))})
    depth = {}
    for i, (a, b) in enumerate(nodes):  # children come first
        depth[i] = 1 + max(depth.get(c[1], 0) if c[0] == "node" else 0
                           for c in (a, b))
    levels = []
    for d in sorted(set(depth.values())):
        ids = [i for i in range(len(nodes)) if depth[i] == d]
        levels.append(tuple(np.array(v) for v in (
            [slot[("node", i)] for i in ids],
            [slot[nodes[i][0]] for i in ids],
            [slot[nodes[i][1]] for i in ids])))
    return grid, tail, levels, len(leaves) + len(nodes)


def _leaf_sums(runs: torch.Tensor) -> torch.Tensor:
    """[..., 16, 8] -> [...]: 8 accumulators down the 16 rows, then
    ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7))."""
    r = runs[..., 0, :]
    for j in range(1, 16):
        r = r + runs[..., j, :]
    return (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
            + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))


def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """numpy's pairwise sum of one buffer, any length up to NP_BUFSIZE."""
    grid, tail, levels, n_slots = _pairwise_plan(x.numel())
    dev = x.device
    padded = torch.cat([x, x.new_zeros(1)])  # index -1 reads 0
    leaf = _leaf_sums(padded[torch.as_tensor(grid, device=dev)])
    rest = padded[torch.as_tensor(tail, device=dev)]
    for j in range(rest.shape[1]):
        leaf = leaf + rest[:, j]
    vals = torch.cat([leaf, x.new_zeros(n_slots - leaf.numel())])
    for out, a, b in levels:
        vals[torch.as_tensor(out, device=dev)] = (
            vals[torch.as_tensor(a, device=dev)]
            + vals[torch.as_tensor(b, device=dev)])
    return vals[-1]


def numpy_float32_sum(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum of ``x``'s elements (C order) in numpy's order, so
    equal to ``x.numpy().sum()`` for a contiguous float32 array; a 0-d
    tensor on ``x``'s device. Adding a zero is exact, so padded runs and
    zero tails give numpy's sums; the elements must not be -0.0."""
    x = x.reshape(-1).float()
    n_full = x.numel() // NP_BUFSIZE
    acc = x.new_zeros(())
    if n_full:
        # a full buffer is a perfect tree: 64 leaves of 128
        v = _leaf_sums(x[:n_full * NP_BUFSIZE].view(n_full, 64, 16, 8))
        while v.shape[1] > 1:
            v = v[:, 0::2] + v[:, 1::2]
        for s in v[:, 0].unbind():
            acc = acc + s
    if x.numel() % NP_BUFSIZE:
        acc = acc + _block_sum(x[n_full * NP_BUFSIZE:])
    return acc


# ---------------------------------------------------------------------------
# Geometric
# ---------------------------------------------------------------------------


@PIPELINES.register("Resize")
class Resize(_SeqMixin):
    """Resize to fit ``img_scale=(w, h)`` keeping the ratio (mmdet): the
    output is int(h s + 0.5) x int(w s + 0.5); boxes scale by
    ``scale_factor`` (w, h, w, h)."""

    def __init__(self, img_scale: Tuple[int, int] = (1000, 600),
                 keep_ratio: bool = True):
        self.img_scale = img_scale
        self.keep_ratio = keep_ratio

    def _scale(self, h, w):
        max_l, min_l = max(self.img_scale), min(self.img_scale)
        if self.keep_ratio:
            s = min(max_l / max(h, w), min_l / min(h, w))
            return s, s
        return self.img_scale[1] / h, self.img_scale[0] / w

    def transform(self, results):
        sh = sw = None
        for key in results.get("img_fields", ["img"]):
            img = results[key]
            h, w = img.shape[:2]
            sy, sx = self._scale(h, w)
            nh, nw = int(h * sy + 0.5), int(w * sx + 0.5)
            results[key] = resize_linear_u8(img, nh, nw)
            sh, sw = nh / h, nw / w
        img = results["img"]
        results["img_shape"] = tuple(img.shape[:2])
        results["scale_factor"] = _f32([sw, sh, sw, sh], img)
        for key in results.get("bbox_fields", []):
            results[key] = results[key] * results["scale_factor"]
        return results


@PIPELINES.register("SeqResize")
class SeqResize(Resize):
    pass


@PIPELINES.register("RandomFlip")
class RandomFlip:
    """Horizontal flip with probability ``flip_ratio``, one draw of the
    sample's ``rng`` a frame."""

    def __init__(self, flip_ratio: float = 0.5):
        self.flip_ratio = flip_ratio

    def apply(self, results, flip: bool):
        results["flip"] = flip
        if not flip:
            return results
        for key in results.get("img_fields", ["img"]):
            results[key] = results[key].flip(1)
        w = results["img_shape"][1]
        for key in results.get("bbox_fields", []):
            b = results[key]
            results[key] = torch.stack(
                [w - b[:, 2], b[:, 1], w - b[:, 0], b[:, 3]], 1)
        return results

    def __call__(self, results, rng):
        if isinstance(results, dict):
            return self.apply(results, rng.random() < self.flip_ratio)
        return [self.apply(r, rng.random() < self.flip_ratio)
                for r in results]


@PIPELINES.register("SeqRandomFlip")
class SeqRandomFlip(RandomFlip):
    """``share_params``: one draw for the whole clip."""

    def __init__(self, share_params: bool = True, flip_ratio: float = 0.5):
        super().__init__(flip_ratio)
        self.share_params = share_params

    def __call__(self, results, rng):
        if isinstance(results, dict) or not self.share_params:
            return super().__call__(results, rng)
        flip = rng.random() < self.flip_ratio
        return [self.apply(r, flip) for r in results]


@PIPELINES.register("Pad")
class Pad(_SeqMixin):
    """Zero-pad each image at the bottom and right to ``size`` (h, w) or to
    multiples of ``size_divisor``."""

    def __init__(self, size_divisor: int = 16,
                 size: Optional[Tuple[int, int]] = None):
        self.size_divisor = size_divisor
        self.size = size

    def transform(self, results):
        for key in results.get("img_fields", ["img"]):
            img = results[key]
            h, w = img.shape[:2]
            if self.size is not None:
                ph, pw = self.size
            else:
                d = self.size_divisor
                ph, pw = (h + d - 1) // d * d, (w + d - 1) // d * d
            out = img.new_zeros((ph, pw) + tuple(img.shape[2:]))
            out[:h, :w] = img
            results[key] = out
        results["pad_shape"] = tuple(results["img"].shape[:2])
        return results


@PIPELINES.register("SeqPad")
class SeqPad(Pad):
    pass


# ---------------------------------------------------------------------------
# Photometric
# ---------------------------------------------------------------------------


def brighten_level(dark: torch.Tensor, m: float) -> torch.Tensor:
    """The JAX package's amplification m x size / max(sum(dark / 255),
    1e-6) in float64 from numpy's float32 sum, as a float32 0-d tensor."""
    dark_n = dark.float() / _f32(255.0, dark)
    total = numpy_float32_sum(dark_n).double().clamp_min(1e-6)
    scaled = torch.tensor(m * dark_n.numel(), dtype=torch.float64,
                          device=dark.device)
    return torch.div(scaled, total).float()


@PIPELINES.register("Brighten")
class Brighten(_SeqMixin):
    """Amplify a dark image so that its mean is about ``m`` of full scale;
    of a 6-channel pair only the noisy half. The amplification is kept in
    ``brighten_level`` for the clip's later frames."""

    def __init__(self, m: float = 0.5):
        self.m = m

    def transform(self, results):
        for key in results.get("img_fields", ["img"]):
            img = results[key]
            pair = img.shape[-1] == 6
            dark = img[..., :3] if pair else img
            amp = results.get("brighten_level")
            if amp is None:
                amp = brighten_level(dark, self.m)
            bright = (dark.float() * amp).clamp(0, 255.0).to(img.dtype)
            results[key] = (torch.cat([bright, img[..., 3:]], -1) if pair
                            else bright)
            results["brighten_level"] = amp
        return results


@PIPELINES.register("SeqBrighten")
class SeqBrighten(Brighten):
    """``share_params``: the key frame's amplification for the clip."""

    def __init__(self, m: float = 0.5, share_params: bool = True):
        super().__init__(m)
        self.share_params = share_params

    def __call__(self, results, rng=None):
        if isinstance(results, dict):
            return self.transform(results)
        outs, level = [], None
        for i, r in enumerate(results):
            if self.share_params and i > 0:
                r["brighten_level"] = level
            r = self.transform(r)
            if self.share_params and i == 0:
                level = r["brighten_level"]
            outs.append(r)
        return outs


@PIPELINES.register("NormalizePairs")
@PIPELINES.register("Normalize")
class NormalizePairs(_SeqMixin):
    """ImageNet normalisation, of each half of a 6-channel pair; BGR -> RGB
    first with ``to_rgb``."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                 to_rgb: bool = True):
        self.mean = tuple(float(v) for v in np.asarray(mean, np.float32))
        self.std = tuple(float(v) for v in np.asarray(std, np.float32))
        self.to_rgb = to_rgb

    def _norm3(self, img):
        img = img.float()
        if self.to_rgb:
            img = img.flip(-1)
        return (img - _f32(self.mean, img)) / _f32(self.std, img)

    def transform(self, results):
        for key in results.get("img_fields", ["img"]):
            img = results[key]
            results[key] = (torch.cat([self._norm3(img[..., :3]),
                                       self._norm3(img[..., 3:])], -1)
                            if img.shape[-1] == 6 else self._norm3(img))
        results["img_norm_cfg"] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results


@PIPELINES.register("SeqNormalize")
class SeqNormalize(NormalizePairs):
    pass


@PIPELINES.register("NormalizeRAW")
class NormalizeRAW(_SeqMixin):
    """Normalise RGGB images of 4k channels, the 4 means and stds repeated
    over each group of 4."""

    def __init__(self, mean, std):
        self.mean = tuple(float(v) for v in np.asarray(mean, np.float32))
        self.std = tuple(float(v) for v in np.asarray(std, np.float32))

    def transform(self, results):
        for key in results.get("img_fields", ["img"]):
            img = results[key].float()
            if img.shape[-1] % 4:
                raise ValueError("RAW images have 4k channels, not "
                                 f"{img.shape[-1]}")
            reps = img.shape[-1] // 4
            results[key] = ((img - _f32(self.mean * reps, img))
                            / _f32(self.std * reps, img))
        results["img_norm_cfg"] = dict(mean=self.mean, std=self.std)
        return results


@PIPELINES.register("SeqNormalizeRAW")
class SeqNormalizeRAW(NormalizeRAW):
    pass


# ---------------------------------------------------------------------------
# RAW and noise
# ---------------------------------------------------------------------------


def _device_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


@PIPELINES.register("sRGB2RAW")
class SRGB2RAW:
    """Unprocess BGR uint8 frames to RGGB RAW in [0, 1] with every step on
    (``ops/unprocess.py``): one camera matrix and gains per call, drawn
    from a device generator seeded by ``seed`` or by the sample's ``rng``
    (as the JAX package seeds its key); a 6-channel pair gives 8 channels,
    both halves with the same draws."""

    FLAGS = dict(tone_mapping=True, gamma_compression=True,
                 color_correction=True, white_balance=True)

    def __init__(self, seed: Optional[int] = None):
        self._seed = seed

    def apply(self, results, ccm_gain: U.CcmGain):
        for k in results.get("img_fields", ["img"]):
            img = results[k].float() / _f32(255.0, results[k])
            halves = [img[..., :3], img[..., 3:]] if img.shape[-1] == 6 \
                else [img]
            results[k] = torch.cat([U.srgb_to_raw(h.flip(-1), ccm_gain,
                                                  **self.FLAGS)
                                    for h in halves], -1)
            results["img_shape"] = tuple(results[k].shape[:2])
        return results

    def draw(self, seed: int, device) -> U.CcmGain:
        return U.random_ccm_gain(_device_generator(seed, device))

    def __call__(self, results, rng):
        seed = self._seed if self._seed is not None else rng.randrange(2**31)
        device = _frames(results)[0]["img"].device
        return self.apply(results, self.draw(seed, device))


@PIPELINES.register("SeqsRGB2RAW")
class SeqSRGB2RAW(SRGB2RAW):
    """``share_params``: one seed, so one camera matrix, for the clip."""

    def __init__(self, share_params: bool = True, seed: Optional[int] = None):
        super().__init__(seed)
        self.share_params = share_params

    def __call__(self, results, rng):
        if isinstance(results, dict):
            return super().__call__(results, rng)
        if self.share_params:
            seed = self._seed if self._seed is not None \
                else rng.randrange(2**31)
            g = self.draw(seed, results[0]["img"].device)
            return [self.apply(r, g) for r in results]
        return [super(SeqSRGB2RAW, self).__call__(r, rng) for r in results]


@PIPELINES.register("AddNoise")
class AddNoise:
    """A (noise, clean) pair from a clean frame: the ``noise_type`` camera
    model of ``ops/noise.py`` at darkening ``am`` on the frame (unclipped),
    concatenated before the frame as float32 (2C channels). Draws from a
    device generator seeded by ``seed`` or by the sample's ``rng``, or
    given to ``apply`` as tensors."""

    def __init__(self, noise_type: str = "a7s3", am: float = 0.8,
                 seed: Optional[int] = None, **noise_kw):
        if noise_type not in N.NOISE_FNS:
            raise KeyError(f"unknown noise_type {noise_type!r}")
        self.noise_type = noise_type
        self.am = am
        self.noise_kw = noise_kw
        self._seed = seed

    def apply(self, results, generator=None, **draws):
        fn = N.NOISE_FNS[self.noise_type]
        for k in results.get("img_fields", ["img"]):
            clean = results[k].float()
            noisy = fn(clean[None], am=self.am, generator=generator,
                       **self.noise_kw, **draws)[0]
            results[k] = torch.cat([noisy, clean], -1)
        return results

    def _seed_of(self, rng):
        return self._seed if self._seed is not None else rng.randrange(2**31)

    def __call__(self, results, rng):
        seed = self._seed_of(rng)
        return self.apply(results, _device_generator(
            seed, results["img"].device))


@PIPELINES.register("SeqAddNoise")
class SeqAddNoise(AddNoise):
    """``share_params``: one seed for the clip, so frames of one size get
    the same draws (as in the JAX package)."""

    def __init__(self, share_params: bool = True, **kw):
        super().__init__(**kw)
        self.share_params = share_params

    def __call__(self, results, rng):
        if isinstance(results, dict):
            return super().__call__(results, rng)
        if self.share_params:
            seed = self._seed_of(rng)
            return [self.apply(r, _device_generator(seed, r["img"].device))
                    for r in results]
        return [super(SeqAddNoise, self).__call__(r, rng) for r in results]
