"""Port parity: RoIAlign (plain torch version of kernel B) against the JAX
package's ``roi_align_matmul``, batched ``roi_align`` and the Pallas
``roi_align_pallas`` in interpret mode, with out-of-image, edge and
zero-area rois. f32, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_tpu.ops.roi_align import (
    roi_align as jax_roi_align,
    roi_align_matmul as jax_roi_align_matmul,
)
from lowlightenvironmentvideoobjectdetection_tpu.ops.roi_align_pallas import (
    roi_align_pallas as jax_roi_align_pallas,
)
from lowlightenvironmentvideoobjectdetection_torch.ops.roi_align import (
    roi_align,
)

torch.set_num_threads(1)
ATOL = 1e-5
STRIDE = 16


def _rois(rng, n, h, w):
    """Random rois in image coordinates plus deliberate corner cases."""
    x1 = rng.uniform(-40, w * STRIDE, n)
    y1 = rng.uniform(-40, h * STRIDE, n)
    bw = rng.uniform(1, 200, n)
    bh = rng.uniform(1, 200, n)
    rois = np.stack([x1, y1, x1 + bw, y1 + bh], 1)
    special = np.array([
        [-100.0, -100.0, -50.0, -60.0],          # fully outside, top-left
        [w * STRIDE + 30, 5, w * STRIDE + 90, 50],  # fully outside, right
        [-30.0, -20.0, 60.0, 70.0],               # partly outside
        [w * STRIDE - 40, h * STRIDE - 30, w * STRIDE + 50, h * STRIDE + 40],
        [50.0, 40.0, 50.0, 40.0],                 # zero area
        [0.0, 0.0, w * STRIDE, h * STRIDE],       # whole map
        [12.0, 30.0, 12.0, 90.0],                 # zero width
    ])
    return np.concatenate([special, rois]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_single_map_matches_matmul_and_pallas(seed):
    rng = np.random.RandomState(seed)
    h, w, c = 9, 13, 8
    feat = rng.randn(h, w, c).astype(np.float32)
    rois = _rois(rng, 21, h, w)
    got = roi_align(torch.from_numpy(feat), torch.from_numpy(rois),
                    1.0 / STRIDE).numpy()
    want = jax_roi_align_matmul(jnp.asarray(feat), jnp.asarray(rois),
                                1.0 / STRIDE)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    want_p = jax_roi_align_pallas(jnp.asarray(feat), jnp.asarray(rois),
                                  1.0 / STRIDE, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want_p), rtol=0, atol=ATOL)
    assert got.shape == (rois.shape[0], 7, 7, c)


def test_batched_maps_match_jax_gather():
    rng = np.random.RandomState(2)
    b, h, w, c = 3, 8, 11, 6
    feats = rng.randn(b, h, w, c).astype(np.float32)
    rois = _rois(rng, 17, h, w)
    binds = rng.randint(0, b, rois.shape[0]).astype(np.int32)
    got = roi_align(torch.from_numpy(feats), torch.from_numpy(rois),
                    1.0 / STRIDE, batch_inds=torch.from_numpy(binds)).numpy()
    want = jax_roi_align(jnp.asarray(feats), jnp.asarray(rois), 1.0 / STRIDE,
                         batch_inds=jnp.asarray(binds))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_fully_outside_rois_are_zero():
    feat = torch.ones(6, 6, 4)
    rois = torch.tensor([[-200.0, -200.0, -120.0, -150.0],
                         [500.0, 500.0, 600.0, 650.0]])
    assert roi_align(feat, rois, 1.0 / STRIDE).abs().max().item() == 0.0


def test_output_dtype_follows_features():
    feat = torch.randn(5, 7, 4).bfloat16()
    rois = torch.tensor([[0.0, 0.0, 40.0, 50.0]])
    out = roi_align(feat, rois, 1.0 / STRIDE)
    assert out.dtype == torch.bfloat16
    ref = roi_align(feat.float(), rois, 1.0 / STRIDE)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=0,
                               atol=2e-2)


def test_rejects_unknown_impl():
    with pytest.raises(ValueError):
        roi_align(torch.zeros(4, 4, 2), torch.zeros(1, 4), 1.0, impl="xla")
