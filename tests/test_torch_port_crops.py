"""The tracking crops and the ReID net against the JAX package, CPU, f32:

- ``ops/scale_translate.py`` against ``jax.image.scale_and_translate(...,
  "linear")`` to 1e-5: shrinking, enlarging, an identity scale, boxes
  partly and wholly outside the frame, the weight matrices themselves;
- DeepSORT's ``crop_and_resize`` and SiamRPN's ``crop_around`` (the frame's
  mean as the pad, by shifting) against the JAX functions to 1e-5;
- ROADMAP fault F14: a shrinking crop of the JAX functions (and the port's)
  averages over its footprint, so it differs from plain bilinear sampling
  (``F.interpolate``, the original's crop) by far more than the tolerance,
  and equals it when the crop does not shrink;
- ``BaseReID`` (R50) against the JAX module: in float32 on 64x32 crops to
  1e-4 of the embeddings' largest value; in bfloat16, the JAX default, on
  128x64 crops to 2e-2 of it (each side drifts about 0.5% from its float32
  result). Not bfloat16 at 64x32: there layer 4's strided 3x3 conv sees a
  4x2 map, where PyTorch's CPU bfloat16 convolution returns wrong values
  or NaN (a CPU library fault; the card's cuDNN is not affected, and the
  CLI's 256x128 crops give layer 4 a 16x8 map).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_port_dark_backbones import draw
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.models.mot import (
    deep_sort as TD,
)
from lowlightenvironmentvideoobjectdetection_torch.models.reid.base_reid import (  # noqa: E501
    BaseReID as TReID,
)
from lowlightenvironmentvideoobjectdetection_torch.models.sot import (
    siamrpn as TS,
)
from lowlightenvironmentvideoobjectdetection_torch.ops.scale_translate import (  # noqa: E501
    scale_and_translate,
    weight_matrix,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.mot import (
    deep_sort as JD,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.reid.base_reid import (  # noqa: E501
    BaseReID as JReID,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.sot import (
    siamrpn as JS,
)

TOL = 1e-5
REID_REL = {"float32": 1e-4, "bfloat16": 2e-2}
REID_CROPS = {"float32": (64, 32), "bfloat16": (128, 64)}
IMG = np.random.default_rng(0).normal(0, 1, (60, 80, 3)).astype(np.float32)

CASES = {  # (out_hw, scale (y, x), translation (y, x))
    "shrink": ((32, 16), (0.4, 0.2), (-3.0, 5.0)),
    "enlarge": ((64, 64), (2.5, 1.7), (-40.0, -20.0)),
    "identity": ((60, 80), (1.0, 1.0), (0.0, 0.0)),
    "partly_outside": ((20, 30), (1.3, 0.9), (10.0, -50.0)),
    "wholly_outside": ((8, 8), (1.0, 1.0), (100.0, 100.0)),
    "fractional": ((16, 16), (0.31, 0.57), (8.3, -2.7)),
}


_pinned_threads = thread_count(1)


def _jax_st(img, out_hw, scale, translation):
    return np.asarray(jax.image.scale_and_translate(
        jnp.asarray(img), tuple(out_hw) + (img.shape[-1],), (0, 1),
        jnp.asarray(scale, jnp.float32), jnp.asarray(translation,
                                                     jnp.float32), "linear"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_scale_and_translate_matches_jax(case):
    out_hw, scale, translation = CASES[case]
    got = scale_and_translate(torch.from_numpy(IMG), out_hw,
                              torch.tensor(scale), torch.tensor(translation))
    want = _jax_st(IMG, out_hw, scale, translation)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    if case == "wholly_outside":
        assert not got.any()


def test_weight_matrix_matches_jax():
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat
    for (out_hw, scale, translation) in CASES.values():
        for axis, size in ((0, 60), (1, 80)):
            want = compute_weight_mat(
                size, out_hw[axis], jnp.float32(scale[axis]),
                jnp.float32(translation[axis]), _fill_triangle_kernel, True)
            got = weight_matrix(size, out_hw[axis],
                                torch.tensor(scale[axis]),
                                torch.tensor(translation[axis]))
            np.testing.assert_allclose(got.numpy().T, np.asarray(want),
                                       rtol=0, atol=1e-6)


BOXES = np.array([[10.0, 5.0, 50.0, 55.0],    # shrinks 256x128 <- 50x40
                  [-10.0, -8.0, 30.0, 40.0],  # partly outside
                  [70.0, 50.0, 95.0, 75.0],   # mostly outside
                  [20.0, 20.0, 20.4, 20.2]],  # under 1 px: widened to 1
                 np.float32)


def test_crop_and_resize_matches_jax():
    got = TD.crop_and_resize(torch.from_numpy(IMG), torch.from_numpy(BOXES),
                             (32, 16))
    want = np.asarray(JD.crop_and_resize(jnp.asarray(IMG),
                                         jnp.asarray(BOXES), (32, 16)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("out_size,crop", [(16, 40.0), (64, 25.5),
                                           (32, 120.0)])
def test_crop_around_matches_jax(out_size, crop):
    img = IMG * 40 + 100
    mean = img.mean(axis=(0, 1))
    centre = np.array([70.0, 12.5], np.float32)  # near the frame's corner
    got = TS.crop_around(torch.from_numpy(img), torch.from_numpy(centre),
                         torch.tensor(crop), out_size,
                         torch.from_numpy(mean))
    want = np.asarray(JS.crop_around(jnp.asarray(img), jnp.asarray(centre),
                                     jnp.float32(crop), out_size,
                                     jnp.asarray(mean)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # outside the frame: the pad value
    np.testing.assert_allclose(got.numpy()[0, -1], mean, rtol=0, atol=1e-3)


def _bilinear(img, box, out_hw):
    """The original's crop: plain bilinear sampling of the box (no
    antialiasing), ``F.interpolate`` of the box's pixels (clamped at the
    box's edge, where JAX reads the pixels beyond it)."""
    x1, y1, x2, y2 = [int(v) for v in box]
    patch = torch.from_numpy(img[y1:y2, x1:x2]).permute(2, 0, 1)[None]
    return F.interpolate(patch, size=out_hw, mode="bilinear",
                         align_corners=False)[0].permute(1, 2, 0).numpy()


def test_f14_the_jax_crops_antialias():
    """A box of 40x48 px cut to 8x10 (a 5x shrink) differs from plain
    bilinear sampling by far more than TOL; cut to 80x96 (no shrink) the
    two agree away from the box's edge."""
    box = np.array([[16.0, 4.0, 64.0, 44.0]], np.float32)
    img = np.random.default_rng(5).normal(0, 1, (60, 80, 3)).astype(
        np.float32)
    for out_hw, far in (((8, 10), True), ((80, 96), False)):
        jax_crop = np.asarray(JD.crop_and_resize(
            jnp.asarray(img), jnp.asarray(box), out_hw))[0]
        port = TD.crop_and_resize(torch.from_numpy(img),
                                  torch.from_numpy(box), out_hw)[0].numpy()
        np.testing.assert_allclose(port, jax_crop, rtol=0, atol=TOL)
        diff = np.abs(jax_crop - _bilinear(img, box[0], out_hw))
        if not far:
            diff = diff[2:-2, 2:-2]
        assert (diff.max() > 100 * TOL) == far, diff.max()


@pytest.fixture(scope="module")
def reid_pair():
    torch.set_num_threads(1)
    jm = JReID(dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 32, 3)))
    var = jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(1)))
    return jm, var, from_jax_variables(var)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_base_reid_matches_jax(reid_pair, dtype):
    jm, var, sd = reid_pair
    crops = np.random.default_rng(6).normal(
        0, 1, (5,) + REID_CROPS[dtype] + (3,)).astype(np.float32)
    if dtype == "bfloat16":
        jm = JReID()
    want = np.asarray(jax.jit(jm.apply)(var, jnp.asarray(crops)))
    tm = TReID(dtype=getattr(torch, dtype))
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(crops)).numpy()
    assert got.shape == (5, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REID_REL[dtype] * np.abs(want).max())
