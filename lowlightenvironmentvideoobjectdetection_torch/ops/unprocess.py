"""sRGB -> RAW unprocessing (Brooks et al.), the counterpart of the JAX
package's ``ops/unprocess.py``: a random camera matrix (a convex
combination of 4 cameras' XYZ->camera matrices, rows normalised) and random
white-balance gains, inverse tone mapping, gamma decompression and the RGGB
mosaic to 4 channels. Elementwise torch on the tensors' device.

``random_ccm_gain`` draws from a ``torch.Generator`` on the device, or takes
its draws as tensors (the JAX package's draws, in a test).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

_XYZ2CAMS = (
    ((1.0234, -0.2969, -0.2266), (-0.5625, 1.6328, -0.0469),
     (-0.0703, 0.2188, 0.6406)),
    ((0.4913, -0.0541, -0.0202), (-0.613, 1.3513, 0.2906),
     (-0.1564, 0.2151, 0.7183)),
    ((0.838, -0.263, -0.0639), (-0.2887, 1.0725, 0.2496),
     (-0.0627, 0.1427, 0.5438)),
    ((0.6596, -0.2079, -0.0562), (-0.4782, 1.3016, 0.1933),
     (-0.097, 0.1581, 0.5181)),
)
_RGB2XYZ = ((0.4124564, 0.3575761, 0.1804375),
            (0.2126729, 0.7151522, 0.0721750),
            (0.0193339, 0.1191920, 0.9503041))


class CcmGain(NamedTuple):
    rgb2cam: torch.Tensor  # [3, 3]
    rgb_gain: torch.Tensor  # []
    red_gain: torch.Tensor  # []
    blue_gain: torch.Tensor  # []


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def random_ccm_gain(generator: Optional[torch.Generator] = None, device=None,
                    weights: Optional[torch.Tensor] = None,
                    rgb_normal: Optional[torch.Tensor] = None,
                    red_gain: Optional[torch.Tensor] = None,
                    blue_gain: Optional[torch.Tensor] = None) -> CcmGain:
    """The camera matrix from ``weights`` [4, 1, 1] ~ U(1e-8, 1e8), the
    brightening gain 1 / (0.8 + 0.1 ``rgb_normal``) with ``rgb_normal`` ~
    N(0, 1), ``red_gain`` ~ U(1.9, 2.4) and ``blue_gain`` ~ U(1.5, 1.9);
    each drawn from ``generator`` (on ``device``) unless given."""
    if device is None:
        device = generator.device if generator is not None else "cpu"

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device)
        return _f32(lo, device) + (_f32(hi, device) - _f32(lo, device)) * u

    if weights is None:
        weights = uniform((4, 1, 1), 1e-8, 1e8)
    if rgb_normal is None:
        rgb_normal = torch.randn((), generator=generator, device=device)
    if red_gain is None:
        red_gain = uniform((), 1.9, 2.4)
    if blue_gain is None:
        blue_gain = uniform((), 1.5, 1.9)
    xyz2cams = _f32(_XYZ2CAMS, device)
    xyz2cam = torch.sum(xyz2cams * weights, 0) / torch.sum(weights)
    rgb2cam = xyz2cam @ _f32(_RGB2XYZ, device)
    rgb2cam = rgb2cam / torch.sum(rgb2cam, -1, keepdim=True)
    rgb_gain = 1.0 / (_f32(0.8, device) + _f32(0.1, device) * rgb_normal)
    return CcmGain(rgb2cam, rgb_gain, _f32(red_gain, device),
                   _f32(blue_gain, device))


def inverse_tone_map(img: torch.Tensor) -> torch.Tensor:
    img = img.clamp(0.0, 1.0)
    return 0.5 - torch.sin(torch.asin(1.0 - 2.0 * img) / 3.0)


def gamma_decompress(img: torch.Tensor) -> torch.Tensor:
    return img.clamp_min(1e-8) ** 2.2


def apply_ccm(img: torch.Tensor, ccm: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...c,dc->...d", img, ccm)


def inverse_white_balance(img: torch.Tensor, g: CcmGain) -> torch.Tensor:
    """1 / gains, protecting saturated pixels (gray above 0.9)."""
    one = torch.ones_like(g.red_gain)
    gains = torch.stack([one / g.red_gain, one, one / g.blue_gain]) \
        / g.rgb_gain
    gray = img.mean(-1, keepdim=True)
    inflection = 0.9
    mask = (torch.clamp_min(gray - inflection, 0.0)
            / (1.0 - inflection)) ** 2.0
    safe_gain = torch.maximum(mask + (1.0 - mask) * gains, gains)
    return img * safe_gain


def mosaic_rggb(img: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB -> [..., 4] (R, G, G, B), the original's
    '_demosaicing'."""
    r, g, b = img.unbind(-1)
    return torch.stack([r, g, g, b], -1)


def srgb_to_raw(img_rgb01: torch.Tensor, ccm_gain: CcmGain,
                tone_mapping: bool = False, gamma_compression: bool = False,
                color_correction: bool = False, white_balance: bool = False,
                demosaicing: bool = True) -> torch.Tensor:
    """img_rgb01: [..., H, W, 3] in [0, 1]; the flags as the transform's."""
    img = img_rgb01
    if tone_mapping:
        img = inverse_tone_map(img)
    if gamma_compression:
        img = gamma_decompress(img)
    if color_correction:
        img = apply_ccm(img, ccm_gain.rgb2cam)
    if white_balance:
        img = inverse_white_balance(img, ccm_gain).clamp(0.0, 1.0)
    if demosaicing:
        img = mosaic_rggb(img)
    return img


def seq_srgb_to_raw(clip_rgb01: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    ccm_gain: Optional[CcmGain] = None, **flags
                    ) -> Tuple[torch.Tensor, CcmGain]:
    """A clip with one camera matrix and one set of gains for all its
    frames (drawn from ``generator`` unless given)."""
    g = ccm_gain if ccm_gain is not None else random_ccm_gain(
        generator, clip_rgb01.device)
    return srgb_to_raw(clip_rgb01, g, **flags), g
