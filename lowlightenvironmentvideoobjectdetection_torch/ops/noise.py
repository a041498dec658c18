"""Low-light noise synthesis, the counterpart of the JAX package's
``ops/noise.py``: Gaussian, Poisson-Gaussian and the Sony A7S3-calibrated
camera model (shot, dark and read noise with a row-correlated streak), the
level sampler, the normalised (noise, clean) pair generator, and the
'calibrate_camera', 'gaussian_poisson' and raw-mock pair generators.

Elementwise torch on the tensors' device, as the JAX functions were a few
``jnp`` ops. Every draw comes from a ``torch.Generator`` on the device, or
is given as a tensor (the JAX package's draws, in a test): Poisson draws
as the counts, Gaussian ones as standard normals.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

RGB_MEAN = (123.675, 116.28, 103.53)
RGB_STD = (58.395, 57.12, 57.375)

# A7S3 calibration (the original's add_noise2.py), RGB order: raw, jpg
A7S3 = dict(k=(0.6015, 0.3724, 0.7122), var_beta=(0.0055, 0.0044, 0.0064),
            var_read=(0.2066, 0.1303, 0.0763), n=(0.4120, 0.6862, 0.3422))
A7S3_JPG = dict(k=(2.036, 1.220, 2.578), var_beta=(0.015, 0.004, 0.009),
                var_read=(0.120, 1.730, 0.145), n=(0.355, 1.513, 0.517))
# 'calibrate_camera' constants, BGR order
CAL_POISSON_BGR = (16.68142166, 9.05125669, 10.4304723)
CAL_GAUSSIAN_BGR = (286.0, 80.0, 92.5)
CAL_STREAK_BGR = (0.25, 0.035, 0.08)
# the raw mock's RGGB constants
RAW_POISSON = (10.4304723, 9.05125669, 16.68142166, 8.92170499)
RAW_GAUSSIAN = (92.5, 80.0, 286.0, 80.0)
RAW_WI = (0.08, 0.035, 0.25, 0.035)

LEVELS = dict(am=(0.7, 0.8, 0.9),
              var=(2500.0, 3600.0, 4900.0, 6400.0, 8100.0, 10000.0),
              p_mean=(25.0, 50.0, 75.0, 100.0, 125.0, 150.0, 175.0, 200.0),
              g_var=(1600.0, 2500.0, 3600.0, 4900.0, 6400.0, 8100.0),
              k_ratio=(25.0, 30.0, 35.0), read_ratio=(200.0, 250.0, 300.0))


def _f32(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _normal(shape, generator, like):
    return torch.randn(shape, generator=generator, device=like.device)


def _poisson(rate, generator):
    return torch.poisson(rate, generator=generator)


def gaussian_noise(clean, am=0.8, var=2500.0, generator=None, normal=None):
    """clean: [..., 3] in [0, 255]; darkened by ``am``, plus N(0, var)."""
    if normal is None:
        normal = _normal(clean.shape, generator, clean)
    return clean * _f32(am, clean) + torch.sqrt(_f32(var, clean)) * normal


def poisson_gaussian_noise(clean, am=0.8, p_mean=10.0, g_var=1600.0,
                           generator=None, poisson=None, normal=None):
    """Shot noise ``p_mean`` x Poisson(am x clean / p_mean) plus
    N(0, g_var)."""
    p_mean = _f32(p_mean, clean)
    dark = clean * _f32(am, clean)
    if poisson is None:
        poisson = _poisson(dark / p_mean, generator)
    if normal is None:
        normal = _normal(clean.shape, generator, clean)
    return p_mean * poisson + torch.sqrt(_f32(g_var, clean)) * normal


def a7s3_draws(clean, am=0.8, k_ratio=200.0, generator=None, calib=A7S3):
    """The A7S3 model's draws for clean [T, H, W, 3]: ``shot`` ~
    Poisson(am x clean / k), ``dark`` ~ Poisson(n), ``read`` [T, H, W, 3]
    and ``dsn`` [T, H, 1, 3] ~ N(0, 1), in that order."""
    t, h, _, _ = clean.shape
    k = _f32(calib["k"], clean) * _f32(k_ratio, clean)
    n_c = _f32(calib["n"], clean)
    return dict(
        shot=_poisson(clean * _f32(am, clean) / k, generator),
        dark=_poisson(n_c.expand(clean.shape).contiguous(), generator),
        read=_normal(clean.shape, generator, clean),
        dsn=_normal((t, h, 1, 3), generator, clean))


def _a7s3(calib, clean, am, k_ratio, read_ratio, generator, shot, dark,
          read, dsn):
    """clean: [T, H, W, 3]; k dsn (shot + dark + read) with the streak
    factor dsn repeated along each row."""
    k = _f32(calib["k"], clean) * _f32(k_ratio, clean)
    if shot is None or dark is None or read is None or dsn is None:
        d = a7s3_draws(clean, am, k_ratio, generator, calib)
        shot = d["shot"] if shot is None else shot
        dark = d["dark"] if dark is None else dark
        read = d["read"] if read is None else read
        dsn = d["dsn"] if dsn is None else dsn
    read = torch.sqrt(_f32(calib["var_read"], clean)
                      * _f32(read_ratio, clean)) * read
    dsn = 1.0 + torch.sqrt(_f32(calib["var_beta"], clean)) * dsn
    return k * dsn * (shot + dark + read)


def real_camera_noise_a7s3(clean, am=0.8, k_ratio=200.0, read_ratio=30.0,
                           generator=None, shot=None, dark=None, read=None,
                           dsn=None):
    """The A7S3 raw calibration; draws ``shot`` (Poisson counts of
    am x clean / k), ``dark`` (Poisson counts of n), ``read`` [T, H, W, 3]
    and ``dsn`` [T, H, 1, 3] (standard normals)."""
    return _a7s3(A7S3, clean, am, k_ratio, read_ratio, generator, shot,
                 dark, read, dsn)


def real_camera_noise_a7s3_jpg(clean, am=0.8, k_ratio=200.0, read_ratio=30.0,
                               generator=None, shot=None, dark=None,
                               read=None, dsn=None):
    """As ``real_camera_noise_a7s3`` with the JPEG calibration."""
    return _a7s3(A7S3_JPG, clean, am, k_ratio, read_ratio, generator, shot,
                 dark, read, dsn)


NOISE_FNS = {"gauss": gaussian_noise, "gaussian": gaussian_noise,
             "mix": poisson_gaussian_noise,
             "possion_gaussian": poisson_gaussian_noise,
             "a7s3": real_camera_noise_a7s3,
             "a7s3_jpg": real_camera_noise_a7s3_jpg}


def sample_noise_level(noise_type: str, generator=None, device="cpu",
                       choices: Optional[Tuple[int, ...]] = None) -> dict:
    """The original's random noise level: ``am`` and the model's levels,
    each one of LEVELS' values, uniformly; ``choices`` gives their indices
    (am first) instead of drawing them."""
    names = {"gauss": ("am", "var"), "mix": ("am", "p_mean", "g_var"),
             "a7s3": ("am", "k_ratio", "read_ratio"),
             "a7s3_jpg": ("am", "k_ratio", "read_ratio")}.get(noise_type)
    if names is None:
        raise NameError(f"not support this type -> {noise_type}")
    out = {}
    for i, name in enumerate(names):
        values = torch.tensor(LEVELS[name], dtype=torch.float32,
                              device=device)
        if choices is None:
            idx = torch.randint(len(values), (), generator=generator,
                                device=device)
        else:
            idx = choices[i]
        out[name] = values[idx]
    return out


def _normalize(x):
    return (x - _f32(RGB_MEAN, x)) / _f32(RGB_STD, x)


def add_noise_clean_pairs(clean_rgb, noise_type: str = "gauss",
                          noise_level: Optional[dict] = None,
                          generator=None, **draws):
    """clean_rgb: [T, H, W, 3] in [0, 255]. Returns (noise, clean), both
    clipped to [0, 255] and ImageNet-normalised; ``noise_level`` is drawn
    unless given, ``draws`` go to the noise model."""
    if noise_type == "no_add":
        noise = clean_rgb
    else:
        if noise_level is None:
            noise_level = sample_noise_level(noise_type, generator,
                                             clean_rgb.device)
        noise = NOISE_FNS[noise_type](clean_rgb, **noise_level,
                                      generator=generator, **draws)
    return (_normalize(noise.clamp(0.0, 255.0)),
            _normalize(clean_rgb.clamp(0.0, 255.0)))


def calibrate_camera_pairs(img_bgr, dark_level: float = 0.5,
                           noise_level: float = 0.5, generator=None,
                           poisson=None, normal=None, streak=None):
    """'calibrate_camera': per-channel BGR Poisson and Gaussian noise with a
    row streak on img_bgr [H, W, 3] in [0, 255]; returns the 6-channel
    (noise clipped to [0, 255], clean) concatenation, unnormalised. Draws:
    ``poisson`` counts [H, W, 3], ``normal`` [H, W, 3], ``streak`` [H, 3]."""
    h, w, c = img_bgr.shape
    img = img_bgr.float()
    poisson_c = _f32(CAL_POISSON_BGR, img) * _f32(noise_level, img)
    gaussian = _f32(CAL_GAUSSIAN_BGR, img) * _f32(noise_level, img)
    streak_c = _f32(CAL_STREAK_BGR, img) * _f32(noise_level ** 3, img)
    dark = img * _f32(dark_level, img)
    if poisson is None:
        poisson = _poisson(dark / poisson_c, generator)
    if normal is None:
        normal = _normal((h, w, c), generator, img)
    if streak is None:
        streak = _normal((h, c), generator, img)
    p_noise = poisson_c * poisson
    g_noise = poisson_c * torch.sqrt(gaussian) * normal
    s_noise = 1.0 + torch.sqrt(streak_c) * streak
    noise = ((p_noise + g_noise) * s_noise[:, None, :]).clamp(0.0, 255.0)
    return torch.cat([noise, img], -1)


def gaussian_poisson_pairs(raw, shot_noise=None, read_noise=None,
                           generator=None, log_shot=None, read_normal=None,
                           normal=None):
    """Unprocessing-style noise on RAW [H, W, 4] in [0, 1]: shot noise
    log-uniform in [1e-4, 0.012] (``log_shot``), read noise on the
    calibrated log-log line plus 0.26 ``read_normal``; returns
    ([noise, clean] 8 channels, (shot, read))."""
    if shot_noise is None:
        if log_shot is None:
            lo, hi = _f32(0.0001, raw).log(), _f32(0.012, raw).log()
            log_shot = lo + (hi - lo) * torch.rand(
                (), generator=generator, device=raw.device)
        if read_normal is None:
            read_normal = _normal((), generator, raw)
        shot_noise = torch.exp(log_shot)
        read_noise = torch.exp(2.18 * log_shot + 1.20 + 0.26 * read_normal)
    if normal is None:
        normal = _normal(raw.shape, generator, raw)
    variance = raw * shot_noise + read_noise
    noise = raw + torch.sqrt(variance) * normal
    return torch.cat([noise, raw], -1), (shot_noise, read_noise)


def general_clean_noise_pairs(bgr_clean, ratio=None, am=None, generator=None,
                              poisson=None, normal=None, row=None):
    """The original's add_noise.py: BGR [T, H, W, 3] in [0, 255] -> a mock
    RGGB raw darkened by ``am`` (~U(0, 1)), per-channel Poisson and
    Gaussian noise scaled by ``ratio`` (~U(0, 1)) and a per-row factor;
    returns the RGB-normalised (noise, clean). Draws: ``poisson`` counts
    and ``normal`` [T, H, W, 4], ``row`` [T, H, 4]."""
    t, h, _, _ = bgr_clean.shape
    x = bgr_clean
    if ratio is None:
        ratio = torch.rand((), generator=generator, device=x.device)
    if am is None:
        am = torch.rand((), generator=generator, device=x.device)
    ratio, am = _f32(ratio, x), _f32(am, x)
    b, g, r = x.unbind(-1)
    raw = torch.stack([r, g, b, g], -1) * am
    poisson_c = _f32(RAW_POISSON, x) * ratio
    gaussian = _f32(RAW_GAUSSIAN, x) * ratio
    wi = _f32(RAW_WI, x) * (ratio * (ratio * ratio))
    if poisson is None:
        poisson = _poisson(raw / poisson_c, generator)
    if normal is None:
        normal = _normal(raw.shape, generator, x)
    if row is None:
        row = _normal((t, h, 4), generator, x)
    p_noisy = poisson_c * poisson
    g_noisy = poisson_c * torch.sqrt(gaussian) * normal
    k_noisy = 1.0 + torch.sqrt(wi) * row
    noisy = (p_noisy + g_noisy) * k_noisy[:, :, None, :]
    rgb_noise = noisy[..., :3].clamp(0.0, 255.0)
    rgb_clean = torch.stack([r, g, b], -1).clamp(0.0, 255.0)
    return _normalize(rgb_noise), _normalize(rgb_clean)
