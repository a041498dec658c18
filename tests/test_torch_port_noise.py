"""The port's noise synthesis and RAW unprocessing (``ops/noise.py``,
``ops/unprocess.py``) and the transforms on them (``AddNoise``,
``SRGB2RAW``, ``NormalizeRAW``) against the JAX package's, on the CPU.

``jax.random`` and ``torch.Generator`` give different streams, so each
test replays the JAX function's key splits to take its draws (Poisson
counts, standard normals, uniforms, choices) and passes them to the port.
Tolerance: rtol 1e-6, with an atol of 1e-6 of the largest |value| (values
that cancel to near 0 have no relative precision); the results of the
transforms' 0-255 arithmetic are compared the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_torch.data.pipelines import (
    transforms as tt,
)
from lowlightenvironmentvideoobjectdetection_torch.ops import (
    noise as tn,
    unprocess as tu,
)
from lowlightenvironmentvideoobjectdetection_tpu.data.pipelines import (
    transforms as jt,
)
from lowlightenvironmentvideoobjectdetection_tpu.ops import (
    noise as jn,
    unprocess as ju,
)

RTOL = 1e-6


def close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def t(x):
    return torch.from_numpy(np.array(x))


def _clean(seed, shape, hi=255.0):
    return np.random.RandomState(seed).uniform(0, hi, shape).astype(
        np.float32)


# ---- unprocess -------------------------------------------------------------


def jax_ccm_draws(key):
    r1, r2, r3, r4 = jax.random.split(key, 4)
    return dict(weights=t(jax.random.uniform(r1, (4, 1, 1), minval=1e-8,
                                             maxval=1e8)),
                rgb_normal=t(jax.random.normal(r2)),
                red_gain=t(jax.random.uniform(r3, minval=1.9, maxval=2.4)),
                blue_gain=t(jax.random.uniform(r4, minval=1.5, maxval=1.9)))


def port_ccm(key):
    return tu.random_ccm_gain(**jax_ccm_draws(key))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_ccm_gain(seed):
    key = jax.random.PRNGKey(seed)
    want, got = ju.random_ccm_gain(key), port_ccm(key)
    for a, b in zip(got, want):
        close(a, b)


def test_unprocess_steps():
    img = _clean(3, (2, 9, 11, 3), 1.0)
    img[0, 0, :4] = np.array([1.0, 0.0, 0.999, 0.95])[:, None]  # clamps, mask
    key = jax.random.PRNGKey(4)
    jg, tg = ju.random_ccm_gain(key), port_ccm(key)
    close(tu.inverse_tone_map(t(img)), ju.inverse_tone_map(jnp.asarray(img)))
    close(tu.gamma_decompress(t(img)), ju.gamma_decompress(jnp.asarray(img)))
    close(tu.apply_ccm(t(img), tg.rgb2cam),
          ju.apply_ccm(jnp.asarray(img), jg.rgb2cam))
    close(tu.inverse_white_balance(t(img), tg),
          ju.inverse_white_balance(jnp.asarray(img), jg))
    close(tu.mosaic_rggb(t(img)), ju.mosaic_rggb(jnp.asarray(img)))


@pytest.mark.parametrize("flags", [
    dict(),
    dict(tone_mapping=True, gamma_compression=True, color_correction=True,
         white_balance=True),
    dict(tone_mapping=True, white_balance=True, demosaicing=False),
])
def test_srgb_to_raw(flags):
    img = _clean(5, (3, 10, 12, 3), 1.0)
    key = jax.random.PRNGKey(6)
    want = ju.srgb_to_raw(jnp.asarray(img), ju.random_ccm_gain(key), **flags)
    close(tu.srgb_to_raw(t(img), port_ccm(key), **flags), want)
    want, _ = ju.seq_srgb_to_raw(key, jnp.asarray(img), **flags)
    got, _ = tu.seq_srgb_to_raw(t(img), ccm_gain=port_ccm(key), **flags)
    close(got, want)


# ---- noise -----------------------------------------------------------------


def jax_a7s3_draws(key, clean, calib, am, k_ratio):
    """``_a7s3_core``'s four draws from its key."""
    r1, r2, r3, r4 = jax.random.split(key, 4)
    k = jnp.asarray(calib["k"]) * k_ratio
    c = jnp.asarray(clean)
    tt_, h = clean.shape[:2]
    return dict(
        shot=t(jax.random.poisson(r1, c * am / k).astype(jnp.float32)),
        dark=t(jax.random.poisson(r2, jnp.broadcast_to(
            jnp.asarray(calib["n"]), c.shape)).astype(jnp.float32)),
        read=t(jax.random.normal(r3, c.shape)),
        dsn=t(jax.random.normal(r4, (tt_, h, 1, 3))))


def jax_noise_draws(noise_type, key, clean, level):
    c = jnp.asarray(clean)
    if noise_type == "gauss":
        return dict(normal=t(jax.random.normal(key, c.shape)))
    if noise_type == "mix":
        r1, r2 = jax.random.split(key)
        return dict(poisson=t(jax.random.poisson(
            r1, c * level["am"] / level["p_mean"]).astype(jnp.float32)),
            normal=t(jax.random.normal(r2, c.shape)))
    calib = tn.A7S3 if noise_type == "a7s3" else tn.A7S3_JPG
    return jax_a7s3_draws(key, clean, calib, level["am"], level["k_ratio"])


LEVELS = dict(gauss=dict(am=0.8, var=3600.0),
              mix=dict(am=0.7, p_mean=50.0, g_var=2500.0),
              a7s3=dict(am=0.9, k_ratio=30.0, read_ratio=250.0),
              a7s3_jpg=dict(am=0.8, k_ratio=25.0, read_ratio=200.0))
JAX_FNS = dict(gauss=jn.gaussian_noise, mix=jn.poisson_gaussian_noise,
               a7s3=jn.real_camera_noise_a7s3,
               a7s3_jpg=jn.real_camera_noise_a7s3_jpg)


@pytest.mark.parametrize("noise_type", sorted(LEVELS))
def test_noise_models(noise_type):
    clean = _clean(7, (2, 12, 10, 3))
    key = jax.random.PRNGKey(8)
    level = LEVELS[noise_type]
    want = JAX_FNS[noise_type](key, jnp.asarray(clean), **level)
    draws = jax_noise_draws(noise_type, key, clean, level)
    close(tn.NOISE_FNS[noise_type](t(clean), **level, **draws), want)


@pytest.mark.parametrize("noise_type", ["gauss", "mix", "a7s3", "a7s3_jpg"])
def test_sample_noise_level(noise_type):
    for seed in range(4):
        want = jn.sample_noise_level(jax.random.PRNGKey(seed), noise_type)
        names = list(want)
        choices = tuple(
            int(np.flatnonzero(np.float32(tn.LEVELS[n]) == want[n])[0])
            for n in names)
        got = tn.sample_noise_level(noise_type, choices=choices)
        assert list(got) == names
        for n in names:
            close(got[n], want[n])
    with pytest.raises(NameError):
        tn.sample_noise_level("speckle")


@pytest.mark.parametrize("noise_type", ["gauss", "mix", "a7s3", "no_add"])
def test_add_noise_clean_pairs(noise_type):
    clean = _clean(9, (3, 8, 9, 3))
    key = jax.random.PRNGKey(10)
    want = jn.add_noise_clean_pairs(key, jnp.asarray(clean), noise_type)
    level, draws = None, {}
    if noise_type != "no_add":
        r_lvl, r_noise = jax.random.split(key)
        jlevel = jn.sample_noise_level(r_lvl, noise_type)
        level = {k: t(v) for k, v in jlevel.items()}
        draws = jax_noise_draws(noise_type, r_noise, clean,
                                {k: float(v) for k, v in jlevel.items()})
    got = tn.add_noise_clean_pairs(t(clean), noise_type, noise_level=level,
                                   **draws)
    for a, b in zip(got, want):
        close(a, b)


def test_calibrate_camera_pairs():
    img = _clean(11, (9, 13, 3))
    key = jax.random.PRNGKey(12)
    want = jn.calibrate_camera_pairs(key, jnp.asarray(img), 0.6, 0.4)
    r1, r2, r3 = jax.random.split(key, 3)
    pc = jnp.asarray(tn.CAL_POISSON_BGR) * 0.4
    got = tn.calibrate_camera_pairs(
        t(img), 0.6, 0.4,
        poisson=t(jax.random.poisson(r1, jnp.asarray(img) * 0.6 / pc)
                  .astype(jnp.float32)),
        normal=t(jax.random.normal(r2, img.shape)),
        streak=t(jax.random.normal(r3, (9, 3))))
    close(got, want)


def test_gaussian_poisson_pairs():
    raw = _clean(13, (7, 11, 4), 1.0)
    key = jax.random.PRNGKey(14)
    r1, r2, r3 = jax.random.split(key, 3)
    log_shot = jax.random.uniform(r1, (), minval=jnp.log(0.0001),
                                  maxval=jnp.log(0.012))
    want, (ws, wr) = jn.gaussian_poisson_pairs(key, jnp.asarray(raw))
    got, (gs, gr) = tn.gaussian_poisson_pairs(
        t(raw), log_shot=t(log_shot), read_normal=t(jax.random.normal(r2)),
        normal=t(jax.random.normal(r3, raw.shape)))
    close(got, want)
    close(gs, ws)
    close(gr, wr)
    want, _ = jn.gaussian_poisson_pairs(key, jnp.asarray(raw), 0.01, 0.002)
    got, _ = tn.gaussian_poisson_pairs(t(raw), 0.01, 0.002,
                                       normal=t(jax.random.normal(
                                           r3, raw.shape)))
    close(got, want)


def test_general_clean_noise_pairs():
    bgr = _clean(15, (2, 8, 10, 3))
    key = jax.random.PRNGKey(16)
    want = jn.general_clean_noise_pairs(key, jnp.asarray(bgr))
    r0, r1, r2, r3 = jax.random.split(key, 4)
    ratio = jax.random.uniform(r0, ())
    am = jax.random.uniform(jax.random.fold_in(r0, 1), ())
    b, g, r = (jnp.asarray(bgr)[..., i] for i in range(3))
    raw = jnp.stack([r, g, b, g], axis=-1) * am
    got = tn.general_clean_noise_pairs(
        t(bgr), ratio=t(ratio), am=t(am),
        poisson=t(jax.random.poisson(
            r1, raw / (jnp.asarray(tn.RAW_POISSON) * ratio))
            .astype(jnp.float32)),
        normal=t(jax.random.normal(r2, raw.shape)),
        row=t(jax.random.normal(r3, (2, 8, 4))))
    for a, b_ in zip(got, want):
        close(a, b_)


def test_generators_draw_on_the_tensors_device():
    """Without given draws the port draws from the generator: finite,
    reproducible from its seed."""
    clean = t(_clean(17, (2, 6, 7, 3)))
    outs = [tn.real_camera_noise_a7s3(
        clean, generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(outs[0], outs[1]) and torch.isfinite(outs[0]).all()
    g = tu.random_ccm_gain(torch.Generator().manual_seed(3))
    assert 1.9 <= float(g.red_gain) <= 2.4 and 1.5 <= float(g.blue_gain) <= 1.9


# ---- transforms ------------------------------------------------------------


def _bgr(seed, hw, channels):
    return np.random.RandomState(seed).randint(0, 256, hw + (channels,)
                                               ).astype(np.uint8)


@pytest.mark.parametrize("noise_type", ["a7s3", "gauss"])
def test_add_noise_transforms(noise_type):
    frames = [_bgr(s, (9, 14), 3) for s in (18, 19, 20)]
    seed = 21
    j = jt.SeqAddNoise(noise_type=noise_type, seed=seed)(
        [dict(img=f, img_fields=["img"]) for f in frames])
    level = dict(am=0.8) if noise_type == "gauss" else dict(
        am=0.8, k_ratio=200.0)
    step = tt.SeqAddNoise(noise_type=noise_type, seed=seed)
    for a, f in zip(j, frames):  # one key, the Poisson rates per frame
        draws = jax_noise_draws(noise_type, jax.random.PRNGKey(seed),
                                f[None].astype(np.float32), level)
        got = step.apply(dict(img=t(f), img_fields=["img"]), **draws)
        assert got["img"].shape == (9, 14, 6)
        close(got["img"], a["img"])


@pytest.mark.parametrize("channels", [3, 6])
def test_srgb2raw_and_normalize_raw_transforms(channels):
    frames = [_bgr(s, (10, 12), channels) for s in (22, 23)]
    seed = 24
    norm = dict(mean=[0.25] * 4, std=[0.12] * 4)
    j = jt.SeqSRGB2RAW(seed=seed)(
        [dict(img=f, img_fields=["img"]) for f in frames])
    j = jt.SeqNormalizeRAW(**norm)(j)
    step = tt.SeqSRGB2RAW(seed=seed)
    ccm = port_ccm(jax.random.PRNGKey(seed))
    got = tt.SeqNormalizeRAW(**norm)(
        [step.apply(dict(img=t(f), img_fields=["img"]), ccm)
         for f in frames])
    for a, b in zip(got, j):
        assert a["img"].shape == (10, 12, 4 * channels // 3)
        assert a["img_shape"] == b["img_shape"]
        close(a["img"], b["img"])
