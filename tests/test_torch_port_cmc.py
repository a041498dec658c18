"""The port's ECC camera motion compensation (``core/motion/cmc.py``, torch)
against the JAX package's (``core/motion/cmc.py``, ``cv2.findTransformECC``)
on the CPU:

- the preprocessing equals cv2's exactly: the fixed-point BGR to gray and
  the 5x5 sigma 1.5 blur on uint8;
- on textured frames moved by a known shift and a small rotation, the
  euclidean and translation warps agree with cv2's within 0.05 px in the
  translation and 1e-4 in the 2x2 part, and recover the motion; affine on
  a case where cv2 converges (on others its iterates wander by tenths of
  a pixel, and rounding decides where they stop);
- a flat frame gives the identity on both sides (cv2 raises there);
- vertical stripes (a singular Hessian) give cv2's warp, not an error;
- ``warp_bboxes`` equals JAX's.
"""

import cv2
import numpy as np
import pytest
import torch
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.core.motion import (
    cmc as TC,
)
from lowlightenvironmentvideoobjectdetection_tpu.core.motion import (
    cmc as JC,
)

SHIFT_TOL = 0.05  # px
LINEAR_TOL = 1e-4
HW = (120, 160)


_pinned_threads = thread_count(1)


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (HW[0] + 40, HW[1] + 40, 3)).astype(
        np.float32)
    return cv2.GaussianBlur(base, (0, 0), 3)


def moved(base, tx, ty, theta):
    """The scene seen through a camera moved by (tx, ty, theta): a BGR
    frame of integer values."""
    c, s = np.cos(theta), np.sin(theta)
    m = np.array([[c, -s, tx + 20], [s, c, ty + 20]], np.float32)
    return cv2.warpAffine(base, m, (HW[1], HW[0]),
                          flags=cv2.INTER_LINEAR + cv2.WARP_INVERSE_MAP
                          ).round().clip(0, 255)


def test_prepare_equals_cv2():
    img = np.random.default_rng(1).integers(0, 256, (37, 53, 3)).astype(
        np.uint8)
    gray = cv2.GaussianBlur(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY), (5, 5),
                            1.5)
    got = TC._gray_blurred(torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), gray.astype(np.float32))
    want = cv2.GaussianBlur(gray.astype(np.float32), (5, 5), 0)
    np.testing.assert_array_equal(
        TC.CameraMotionCompensation.prepare(img).numpy(), want)


MOTIONS = [(3.3, -2.1, 0.0), (1.7, 0.8, 0.01), (-4.2, 2.5, -0.015)]


@pytest.mark.parametrize("mode", ["euclidean", "translation"])
@pytest.mark.parametrize("motion", MOTIONS, ids=["shift", "rot+", "rot-"])
def test_ecc_matches_cv2(mode, motion):
    base = _scene()
    ref, cur = moved(base, 0, 0, 0), moved(base, *motion)
    want = JC.CameraMotionCompensation(mode).get_warp_matrix(cur, ref)
    got = TC.CameraMotionCompensation(mode).get_warp_matrix(
        torch.from_numpy(cur), torch.from_numpy(ref))
    assert got.dtype == np.float32 and got.shape == (2, 3)
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=SHIFT_TOL)
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0,
                               atol=LINEAR_TOL)
    if mode == "euclidean" or motion[2] == 0:  # the warp maps ref to cur
        np.testing.assert_allclose(got[:, 2], [-motion[0], -motion[1]],
                                   atol=0.3)


def test_ecc_affine_matches_cv2_where_it_converges():
    base = _scene()
    ref, cur = moved(base, 0, 0, 0), moved(base, 1.7, 0.8, 0.01)
    want = JC.CameraMotionCompensation("affine").get_warp_matrix(cur, ref)
    got = TC.CameraMotionCompensation("affine").get_warp_matrix(cur, ref)
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=SHIFT_TOL)
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0,
                               atol=LINEAR_TOL)


def test_flat_frame_gives_the_identity():
    flat = np.full(HW + (3,), 77.0, np.float32)
    want = JC.CameraMotionCompensation().get_warp_matrix(flat, flat)
    got = TC.CameraMotionCompensation().get_warp_matrix(flat, flat)
    np.testing.assert_array_equal(want, np.eye(2, 3, dtype=np.float32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["euclidean", "translation", "affine"])
def test_stripes_give_a_singular_hessian_and_cv2s_warp(mode):
    """Texture along x only: the gradient along y is 0 everywhere, so the
    Hessian is singular; cv2 inverts it to zeros and stops where it is."""
    wave = 128 + 90 * np.sin(np.arange(HW[1] + 20) / 3.0)
    rows = np.broadcast_to(wave[None, :, None], (HW[0], HW[1] + 20, 3))
    ref = rows[:, :HW[1]].round().astype(np.float32)
    cur = rows[:, 2:HW[1] + 2].round().astype(np.float32)
    want = JC.CameraMotionCompensation(mode).get_warp_matrix(cur, ref)
    got = TC.CameraMotionCompensation(mode).get_warp_matrix(cur, ref)
    np.testing.assert_allclose(got, want, rtol=0, atol=LINEAR_TOL)


def test_warp_bboxes_matches_jax():
    warp = np.array([[0.999, -0.02, 3.5], [0.02, 0.999, -1.25]], np.float32)
    boxes = np.random.default_rng(2).uniform(0, 100, (5, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        TC.CameraMotionCompensation().warp_bboxes(boxes, warp),
        JC.CameraMotionCompensation().warp_bboxes(boxes, warp))
    empty = np.zeros((0, 4), np.float32)
    assert TC.CameraMotionCompensation().warp_bboxes(empty, warp).shape \
        == (0, 4)
