"""Port parity for FGFA's and DFF's flow network and FGFA's aggregator
(``models/motion/flownet_simple.py``) against the JAX package's on the CPU
in f32:

- ``FlowNetSimple`` on frame pairs of 64x64 and of 72x88 (odd sizes from
  the second level on, so the decoder's crops of the upsampled flow and of
  the deconvolution run), with the weights bridged from flax by path and
  its ``ConvTranspose`` kernels flipped (``from_jax_variables(variables,
  model)``); the flow to an atol of 1e-5 of its largest |value|;
- ``EmbedAggregator`` (one and two embedding convs) to 1e-5 of the
  largest |value|;
- F13: JAX's input downscale (``jax.image.resize``, bilinear, which
  antialiases when it shrinks) equals ``F.interpolate`` with
  ``antialias=True`` to 1e-6, and differs from the original's
  ``F.interpolate`` without it by more than 0.5 on unit-variance input.

Variables are drawn in ``jax.eval_shape(init)``'s shapes
(``test_torch_port_dark_backbones.draw``: N(0, 1 / fan_in) kernels,
N(0, 0.05^2) biases), inputs from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_port_dark_backbones import draw

from lowlightenvironmentvideoobjectdetection_tpu.models.motion import (
    flownet_simple as JM,
)
from lowlightenvironmentvideoobjectdetection_torch.models.motion import (
    flownet_simple as TM,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)
from torch_port_threads import thread_count

VALUE_REL = 1e-5
F13_TOL = 1e-6  # JAX's downscale against the antialiased interpolate
F13_GAP = 0.5   # ... and at least this far from the plain one


_pinned_threads = thread_count(1)


def _bridged(jmodule, tmodule, *xs, seed=0):
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0),
                            *(jnp.asarray(x) for x in xs))
    var = jax.tree_util.tree_map(np.asarray,
                                 draw(shapes, np.random.RandomState(seed)))
    tmodule.load_state_dict(from_jax_variables(var, tmodule), strict=True)
    return var


def _close(got, want, rel=VALUE_REL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("hw", [(64, 64), (72, 88)], ids=["64x64", "72x88"])
def test_flownet_simple_matches_jax(hw):
    rs = np.random.RandomState(hw[1])
    pairs = rs.randn(2, *hw, 6).astype(np.float32)
    jm, tm = JM.FlowNetSimple(), TM.FlowNetSimple()
    var = _bridged(jm, tm, pairs)
    want = jax.jit(jm.apply)(var, jnp.asarray(pairs))
    got = tm(torch.from_numpy(pairs))
    assert want.shape == (2,) + hw + (2,)
    _close(got, want)


@pytest.mark.parametrize("num_convs", [1, 2])
def test_embed_aggregator_matches_jax(num_convs):
    rs = np.random.RandomState(num_convs)
    x = rs.randn(1, 5, 7, 8).astype(np.float32)
    refs = np.concatenate([x, rs.randn(3, 5, 7, 8).astype(np.float32)])
    jm = JM.EmbedAggregator(channels=8, num_convs=num_convs)
    tm = TM.EmbedAggregator(8, 8, num_convs=num_convs)
    var = _bridged(jm, tm, x, refs)
    want = jm.apply(var, jnp.asarray(x), jnp.asarray(refs))
    got = tm(torch.from_numpy(x), torch.from_numpy(refs))
    _close(got, want)
    # the weights are a softmax over the frames: the sum stays in the hull
    assert np.all(np.asarray(want) <= refs.max(0) + 1e-5)


def test_f13_jax_downscale_antialiases():
    """ROADMAP F13: the JAX FlowNetSimple shrinks its input with an
    antialiased bilinear resize; the original's ``F.interpolate`` does not
    antialias. The port follows JAX."""
    rs = np.random.RandomState(13)
    x = rs.randn(2, 64, 96, 6).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 32, 48, 6),
                                       "bilinear"))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)

    def shrink(antialias):
        return F.interpolate(nchw, size=(32, 48), mode="bilinear",
                             align_corners=False, antialias=antialias
                             ).permute(0, 2, 3, 1).numpy()

    np.testing.assert_allclose(shrink(True), want, rtol=0, atol=F13_TOL)
    assert np.abs(shrink(False) - want).max() > F13_GAP
