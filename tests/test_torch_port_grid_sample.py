"""Port parity for the flow warp (``ops/grid_sample.py``) against the JAX
package's ``ops/grid_sample.py`` on the CPU in f32:

- ``grid_sample`` for both ``align_corners`` and both padding modes, on
  grids reaching beyond the map, single and batched (against
  ``jax.vmap``), and with a bf16 map (f32 out, as JAX promotes);
- ``_resize_bilinear_border`` (the flow's width-derived resize) at a
  down- and an up-scale, the output size forced to (h, w);
- ``flow_warp_feats``, the original's mapping and ``centered=True``,
  single and batched, with the gradients with respect to the map and the
  flow against ``jax.grad`` of the same cotangent product.

Inputs from numpy seeds. Tolerances: values to an atol of 1e-5 of their
largest |value| (the same bilinear sums, rounded in another order);
gradients to 1e-4 of each gradient's largest |value| (the map's gradient
scatters its sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_tpu.ops import (
    grid_sample as JG,
)
from lowlightenvironmentvideoobjectdetection_torch.ops import (
    grid_sample as TG,
)

VALUE_REL = 1e-5
GRAD_REL = 1e-4


_pinned_threads = thread_count(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel, name=""):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=name)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_matches_jax(align_corners, padding_mode):
    rs = np.random.RandomState(0)
    feat = rs.randn(9, 13, 5).astype(np.float32)
    grid = rs.uniform(-1.3, 1.3, (6, 7, 2)).astype(np.float32)
    grid[0, 0] = [-1.0, 1.0]  # the corners exactly
    want = JG.grid_sample(jnp.asarray(feat), jnp.asarray(grid),
                          align_corners=align_corners,
                          padding_mode=padding_mode)
    got = TG.grid_sample(_t(feat), _t(grid), align_corners=align_corners,
                         padding_mode=padding_mode)
    _close(got, want, VALUE_REL)
    feats = rs.randn(3, 9, 13, 5).astype(np.float32)
    grids = rs.uniform(-1.3, 1.3, (3, 4, 2)).astype(np.float32)
    want = jax.vmap(lambda f, g: JG.grid_sample(
        f, g, align_corners=align_corners, padding_mode=padding_mode))(
        jnp.asarray(feats), jnp.asarray(grids))
    got = TG.grid_sample(_t(feats), _t(grids), align_corners=align_corners,
                         padding_mode=padding_mode)
    _close(got, want, VALUE_REL)


def test_grid_sample_of_a_bf16_map_is_f32():
    rs = np.random.RandomState(1)
    feat = rs.randn(6, 8, 4).astype(np.float32)
    grid = rs.uniform(-1, 1, (5, 2)).astype(np.float32)
    want = JG.grid_sample(jnp.asarray(feat, jnp.bfloat16), jnp.asarray(grid))
    got = TG.grid_sample(_t(feat).bfloat16(), _t(grid))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, want, VALUE_REL)


@pytest.mark.parametrize("hw,out_hw", [((64, 96), (4, 6)),
                                        ((5, 7), (11, 15))],
                         ids=["down16", "up"])
def test_resize_bilinear_border_matches_jax(hw, out_hw):
    rs = np.random.RandomState(2)
    img = rs.randn(*hw, 2).astype(np.float32)
    scale = out_hw[1] / hw[1]
    want = JG._resize_bilinear_border(jnp.asarray(img), *out_hw, scale)
    got = TG._resize_bilinear_border(_t(img), *out_hw, scale)
    assert tuple(got.shape) == out_hw + (2,)
    _close(got, want, VALUE_REL)


def _warp_inputs(seed, n=None):
    """A map [h, w, C] and a flow 16x its size (FlowNet's full-frame flow
    over a stride-16 map), a few pixels of displacement in map units, some
    reaching beyond the map."""
    rs = np.random.RandomState(seed)
    lead = () if n is None else (n,)
    feat = rs.randn(*lead, 6, 10, 4).astype(np.float32)
    flow = (rs.randn(*lead, 96, 160, 2) * 24).astype(np.float32)
    cot = rs.randn(*lead, 6, 10, 4).astype(np.float32)
    return feat, flow, cot


@pytest.mark.parametrize("centered", [False, True],
                         ids=["original", "centered"])
def test_flow_warp_feats_and_its_gradients_match_jax(centered):
    feat, flow, cot = _warp_inputs(3)

    def jloss(f, fl):
        return jnp.sum(JG.flow_warp_feats(f, fl, centered=centered)
                       * jnp.asarray(cot))

    want = JG.flow_warp_feats(jnp.asarray(feat), jnp.asarray(flow),
                              centered=centered)
    jg_feat, jg_flow = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(feat), jnp.asarray(flow))
    tf, tfl = _t(feat).requires_grad_(), _t(flow).requires_grad_()
    got = TG.flow_warp_feats(tf, tfl, centered=centered)
    (got * _t(cot)).sum().backward()
    _close(got, want, VALUE_REL, "warp")
    _close(tf.grad, jg_feat, GRAD_REL, "d feat")
    _close(tfl.grad, jg_flow, GRAD_REL, "d flow")
    assert np.abs(np.asarray(jg_flow)).max() > 0


@pytest.mark.parametrize("centered", [False, True],
                         ids=["original", "centered"])
def test_flow_warp_feats_batched_matches_vmap(centered):
    feat, flow, _ = _warp_inputs(4, n=3)
    want = jax.vmap(lambda f, fl: JG.flow_warp_feats(
        f, fl, centered=centered))(jnp.asarray(feat), jnp.asarray(flow))
    got = TG.flow_warp_feats(_t(feat), _t(flow), centered=centered)
    _close(got, want, VALUE_REL)


def test_zero_flow():
    """A zero flow: the centered mapping is the identity; the original's
    samples pixel (x, y) at (x (W - 1) / W, y (H - 1) / H) (its
    normalization mismatch), so only the origin stays."""
    feat, _, _ = _warp_inputs(5)
    zero = torch.zeros(96, 160, 2)
    got = TG.flow_warp_feats(_t(feat), zero, centered=True)
    np.testing.assert_allclose(got.numpy(), feat, rtol=0, atol=1e-6)
    got = TG.flow_warp_feats(_t(feat), zero)
    assert not np.allclose(got.numpy(), feat, atol=1e-3)
    np.testing.assert_allclose(got[0, 0].numpy(), feat[0, 0], atol=1e-6)
