"""Port parity for DFF (``models/vid/fgfa.py``) against the JAX package on
the CPU in f32, at ``test_torch_port_fgfa.py``'s tiny size:

- ``dff_loss`` (the reference frame is the key, its map warped to the
  annotated frame) with every gradient leaf, against the JAX loss with
  ``stop_gradient`` on the proposal boxes (ROADMAP F6);
- 4 streamed frames at ``key_frame_interval=2``, so both branches run
  (key, warp, key, warp), against the JAX ``dff_inference_step``:
  detections as sets, the key frame exactly, the key's map, the count,
  and the state carried across by ``dff_state_from_jax``.

Tolerances as ``test_torch_port_fgfa.py``. The loss's sample seed is the
first from 0 on which every leaf is within tolerance: 3. ``relu_kinks.py
dff 0 1 2`` names the pre-activations within f32 rounding of 0 that fail
seeds 0-2, after whose flip every leaf is within tolerance: seed 0 one
ReLU in ``layer4_1`` (5.96e-8); seed 1 a ReLU in ``layer4_1`` (1.12e-7)
and one in ``layer2_2`` (2.98e-8); seed 2 a ReLU in ``layer2_0``
(-2.98e-8) and a leaky ReLU after FlowNetSimple's ``conv1`` (2.24e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_port_fgfa import (
    IMG_SHAPE,
    MAP_ATOL,
    SMALL,
    _t,
    bridged,
    jax_cfg,
    jax_loss_and_grads,
    port_batch,
    port_cfg,
    port_loss_and_grads,
    same_loss_and_grads,
    sample,
)
from test_torch_port_selsa import _same_dets
from test_torch_port_train import jax_uniforms

from lowlightenvironmentvideoobjectdetection_tpu.models.vid import (
    fgfa as JF,
    selsa as JS,
)
from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
    fgfa as TF,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    dff_state_from_jax,
    grads_from_jax,
)
from torch_port_threads import thread_count


KEY_INTERVAL = 2
STREAM_FRAMES = 4
DFF_SEED = 3


_pinned_threads = thread_count(1)


def make_pair():
    jmodel, janchors = JF.make_dff(jax_cfg(), KEY_INTERVAL)
    tmodel, tanchors = TF.make_dff(port_cfg(), KEY_INTERVAL, device="cpu")
    var = bridged(jmodel, tmodel, seed=4)
    return dict(jmodel=jmodel, var=var, tmodel=tmodel, janchors=janchors,
                tanchors=tanchors)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def dff_case(pair, seed):
    """As ``test_torch_port_fgfa.fgfa_case``, for ``dff_loss``."""
    jmodel, var, tmodel = pair["jmodel"], pair["var"], pair["tmodel"]
    batch = sample(seed)
    key = jax.random.PRNGKey(7)
    jb = JS.TrainBatch(*(jnp.asarray(f) for f in batch))
    want, want_grads = jax_loss_and_grads(
        lambda v: JF.dff_loss(jmodel, v, jb, key, pair["janchors"]), var)
    uniforms = jax_uniforms(key, pair["tanchors"].shape[0],
                            8 + SMALL["train_nms_post"])
    return want, grads_from_jax(want_grads, tmodel), lambda: (
        port_loss_and_grads(tmodel, lambda: TF.dff_loss(
            tmodel, port_batch(batch), pair["tanchors"], uniforms=uniforms)))


def loss_and_grads(case, seed):
    """``relu_kinks.py``'s entry for the case ``dff``."""
    pair = make_pair()
    want, grads, port = dff_case(pair, seed)
    return want, grads, pair["tmodel"], port


def test_dff_loss_and_every_gradient_match_jax(pair):
    want, want_grads, port = dff_case(pair, DFF_SEED)
    got = port()
    grads = same_loss_and_grads(got, want, want_grads)
    assert got[0]["loss_bbox"] > 0 and got[0]["loss_rpn_bbox"] > 0
    for part in ("motion.conv1.weight", "motion.upsample_flow2.weight",
                 "detector.backbone.layer4_0.conv1.weight"):
        assert grads[part].abs().max() > 0, part


def _same_dff_state(t, j):
    assert t.frames_since_key == int(j.frames_since_key)
    np.testing.assert_array_equal(t.key_img.numpy(), np.asarray(j.key_img))
    np.testing.assert_allclose(t.key_feat.numpy(), np.asarray(j.key_feat),
                               rtol=0, atol=MAP_ATOL)


def test_dff_stream_matches_jax(pair):
    jmodel, var, tmodel = pair["jmodel"], pair["var"], pair["tmodel"]
    rs = np.random.RandomState(3)
    frames = np.zeros((STREAM_FRAMES, 64, 64, 3), np.float32)
    frames[:, :56, :60] = rs.randn(STREAM_FRAMES, 56, 60, 3)
    sf = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
    jshape = jnp.asarray(IMG_SHAPE)
    step = jax.jit(lambda v, st, f: JF.dff_inference_step(
        jmodel, v, st, f, jshape, jnp.asarray(sf), pair["janchors"]))
    c = jmodel.cfg
    jstate = JF.DFFState(  # the JAX VIDModel's placeholders
        jnp.zeros((c.pad_h, c.pad_w, 3)),
        jnp.zeros((c.pad_h // c.stride, c.pad_w // c.stride,
                   c.neck_channels)), jnp.zeros((), jnp.int32))
    tstate = TF.dff_init_state()
    keys = []
    for t in range(STREAM_FRAMES):
        jstate, jdets = step(var, jstate, jnp.asarray(frames[t]))
        tstate, tdets = TF.dff_inference_step(
            tmodel, tstate, _t(frames[t]), _t(IMG_SHAPE), _t(sf),
            pair["tanchors"])
        _same_dets(tdets, jdets)
        _same_dff_state(tstate, jstate)
        keys.append(bool(np.array_equal(tstate.key_img.numpy(), frames[t])))
    assert keys == [True, False, True, False]
    _same_dff_state(dff_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate)), jstate)
