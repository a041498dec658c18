"""Port parity for FGFA (``models/vid/fgfa.py``) and its detector, Faster
R-CNN (``models/detectors/faster_rcnn.py``), against the JAX package on
the CPU in f32, at a tiny size (R50, a 64x64 bucket, neck 32, 4 classes,
3 memo frames):

- ``fgfa_loss`` with every gradient leaf (the backbone, FlowNetSimple,
  the EmbedAggregator, the RPN and the head) and ``faster_rcnn_loss`` on
  the FGFA's detector, against the JAX losses with ``stop_gradient`` on
  the proposal boxes (ROADMAP F6: the JAX ``bbox_targets`` is wrapped so;
  the original and the port do not differentiate through them), with the
  uniforms the JAX samplers draw from the same key;
- ``faster_rcnn_detect`` and 4 streamed FGFA frames (``fgfa_init_state``
  on 3 reference frames, then ``fgfa_inference_step``, the memo rolling
  every frame) against the JAX steps: detections as sets, the memo's
  frames exactly, its maps, and the state carried across by
  ``fgfa_state_from_jax``;
- the weights are the JAX variables bridged with ``from_jax_variables``
  (FlowNetSimple's transposed convs flipped).

Variables are drawn in ``jax.eval_shape(init)``'s shapes
(``test_torch_port_dark_backbones.draw``). The loss's sample seed is the
first from 0 on which every leaf is within tolerance: 1. At seed 0 one
ReLU pre-activation sits within the two frameworks' f32 rounding of 0
(``relu_kinks.py fgfa 0``: ``detector.backbone.layer3_4``'s first ReLU,
-1.49e-8, 3.5e-9 of the call's largest |x|); flipping its gradient brings
all 81 leaves outside tolerance back within it. Tolerances as
``test_torch_port_train.py``: losses to rtol 1e-5; gradients to 1e-4 of
each leaf's largest |g|, at least 1e-6 of the largest of any leaf;
detections as sets (boxes to 5e-3 px, scores to 1e-5); maps to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_dark_backbones import draw
from test_torch_port_selsa import _same_dets
from test_torch_port_train import (
    GRAD_FLOOR,
    GRAD_REL_ATOL,
    LOSS_RTOL,
    jax_uniforms,
)

from lowlightenvironmentvideoobjectdetection_tpu.models.detectors import (
    faster_rcnn as JR,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.roi_heads import (
    bbox_head as JBH,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.vid import (
    fgfa as JF,
    selsa as JS,
)
from lowlightenvironmentvideoobjectdetection_torch.models.detectors import (
    faster_rcnn as TR,
)
from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
    fgfa as TF,
    selsa as TS,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    fgfa_state_from_jax,
    from_jax_variables,
    grads_from_jax,
)
from torch_port_threads import thread_count


SMALL = dict(pad_h=64, pad_w=64, neck_channels=32, num_classes=4,
             num_ref_frames=3, train_nms_pre=128, train_nms_post=32,
             test_nms_pre=64, test_nms_post=16, num_roi_samples=32)
IMG_SHAPE = (56.0, 60.0)
MAP_ATOL = 1e-4
STREAM_FRAMES = 4
FGFA_SEED = 1


_pinned_threads = thread_count(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_cfg():
    return JS.SelsaConfig(compute_dtype=jnp.float32, **SMALL)


def port_cfg():
    return TS.SelsaConfig(compute_dtype=torch.float32, **SMALL)


def bridged(jmodel, tmodel, seed):
    """Variables drawn in the JAX model's shapes, loaded into the port
    model; returns them."""
    imgs = jnp.zeros((3, SMALL["pad_h"], SMALL["pad_w"], 3))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), imgs)
    var = jax.tree_util.tree_map(np.asarray,
                                 draw(shapes, np.random.RandomState(seed)))
    tmodel.load_state_dict(from_jax_variables(var, tmodel), strict=True)
    return var


def sample(seed):
    """A key frame and 2 references filling the bucket, 8 gts of which 5
    are valid; the first covers most of the image, so the few anchors
    inside a 64x64 image have a positive."""
    rs = np.random.RandomState(seed)
    imgs = rs.randn(3, 64, 64, 3).astype(np.float32)
    xy = rs.uniform(0, 30, (8, 2))
    gts = np.concatenate([xy, xy + rs.uniform(8, 26, (8, 2))], 1)
    gts[0] = [2.0, 1.0, 62.0, 63.0]
    labels = rs.randint(0, SMALL["num_classes"], 8).astype(np.int32)
    valid = np.arange(8) < 5
    return JS.TrainBatch(imgs, np.full(2, 64.0, np.float32),
                         gts.astype(np.float32), labels, valid)


def port_batch(b):
    return TS.TrainBatch(_t(b.imgs), _t(b.img_shape), _t(b.gt_boxes),
                         _t(b.gt_labels).long(), _t(b.gt_valid))


def stopped(fn):
    """``fn`` run with the JAX ``bbox_targets`` taking stop_gradient of its
    proposals (F6), traced inside."""
    def run(*args):
        orig = JBH.bbox_targets
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JBH, "bbox_targets", lambda boxes, *a, **k: orig(
                jax.lax.stop_gradient(boxes), *a, **k))
            return fn(*args)
    return run


def jax_loss_and_grads(loss, var):
    (_, metrics), grads = stopped(jax.jit(jax.value_and_grad(
        loss, has_aux=True)))(var)
    return (jax.tree_util.tree_map(np.asarray, metrics),
            jax.tree_util.tree_map(np.asarray, grads["params"]))


def port_loss_and_grads(model, loss):
    model.zero_grad(set_to_none=True)
    total, metrics = loss()
    total.backward()
    return ({k: v.item() for k, v in metrics.items()},
            {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()})


def same_loss_and_grads(got, want, want_grads):
    metrics, grads = got
    for k, v in want.items():
        np.testing.assert_allclose(metrics[k], v, rtol=LOSS_RTOL, err_msg=k)
    assert set(grads) == set(want_grads)
    floor = GRAD_FLOOR * max(float(g.abs().max())
                             for g in want_grads.values())
    for name, w in want_grads.items():
        scale = float(w.abs().max())
        np.testing.assert_allclose(
            grads[name].numpy(), w.numpy(), rtol=0,
            atol=max(GRAD_REL_ATOL * scale, floor), err_msg=name)
    return grads


def make_pair():
    jmodel, janchors = JF.make_fgfa(jax_cfg())
    tmodel, tanchors = TF.make_fgfa(port_cfg(), device="cpu")
    var = bridged(jmodel, tmodel, seed=3)
    np.testing.assert_array_equal(tanchors.numpy(), np.asarray(janchors))
    return dict(jmodel=jmodel, var=var, tmodel=tmodel, janchors=janchors,
                tanchors=tanchors)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def fgfa_case(pair, seed):
    """The JAX ``fgfa_loss`` (F6-stopped) metrics and gradients (in the
    port's layout) on sample ``seed``, and the port's loss as a callable
    giving (metrics, gradients)."""
    jmodel, var, tmodel = pair["jmodel"], pair["var"], pair["tmodel"]
    batch = sample(seed)
    key = jax.random.PRNGKey(5)
    jb = JS.TrainBatch(*(jnp.asarray(f) for f in batch))
    want, want_grads = jax_loss_and_grads(
        lambda v: JF.fgfa_loss(jmodel, v, jb, key, pair["janchors"]), var)
    uniforms = jax_uniforms(key, pair["tanchors"].shape[0],
                            8 + SMALL["train_nms_post"])
    return want, grads_from_jax(want_grads, tmodel), lambda: (
        port_loss_and_grads(tmodel, lambda: TF.fgfa_loss(
            tmodel, port_batch(batch), pair["tanchors"], uniforms=uniforms)))


def loss_and_grads(case, seed):
    """``relu_kinks.py``'s entry for the case ``fgfa``: the JAX metrics
    and gradients, the port model and its loss."""
    pair = make_pair()
    want, grads, port = fgfa_case(pair, seed)
    return want, grads, pair["tmodel"], port


def test_fgfa_loss_and_every_gradient_match_jax(pair):
    tmodel = pair["tmodel"]
    want, want_grads, port = fgfa_case(pair, FGFA_SEED)
    got = port()
    grads = same_loss_and_grads(got, want, want_grads)
    assert got[0]["loss_bbox"] > 0 and got[0]["loss_rpn_bbox"] > 0
    for part in ("motion.conv1.weight", "motion.deconv5.weight",
                 "aggregator.embed_conv0.weight",
                 "detector.bbox_head.fc_cls.weight"):
        assert grads[part].abs().max() > 0, part
    frozen = [n for n in grads if n.startswith(
        ("detector.backbone.conv1", "detector.backbone.bn1",
         "detector.backbone.layer1_"))]
    assert frozen and not any(grads[n].any() for n in frozen)


def test_faster_rcnn_loss_and_detect_match_jax(pair):
    """FGFA's detector alone, on its own image."""
    jdet = JR.FasterRCNN(cfg=pair["jmodel"].cfg)
    dvar = jax.tree_util.tree_map(lambda x: x, {
        coll: tree["detector"] for coll, tree in pair["var"].items()})
    tdet = pair["tmodel"].detector
    b = sample(1)
    jb = JR.DetTrainBatch(jnp.asarray(b.imgs[0]), *(
        jnp.asarray(f) for f in b[1:]))
    key = jax.random.PRNGKey(6)
    want, want_grads = jax_loss_and_grads(
        lambda v: JR.faster_rcnn_loss(jdet, v, jb, key, pair["janchors"]),
        dvar)
    uniforms = jax_uniforms(key, pair["tanchors"].shape[0],
                            8 + SMALL["train_nms_post"])
    tb = TR.DetTrainBatch(_t(b.imgs[0]), *port_batch(b)[1:])
    got = port_loss_and_grads(tdet, lambda: TR.faster_rcnn_loss(
        tdet, tb, pair["tanchors"], uniforms=uniforms))
    same_loss_and_grads(got, want, grads_from_jax(want_grads, tdet))
    sf = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
    jdets = JR.faster_rcnn_detect(jdet, dvar, jnp.asarray(b.imgs[0]),
                                  jnp.asarray(IMG_SHAPE), pair["janchors"],
                                  jnp.asarray(sf))
    tdets = TR.faster_rcnn_detect(tdet, _t(b.imgs[0]), _t(IMG_SHAPE),
                                  pair["tanchors"], _t(sf))
    _same_dets(tdets, jdets)


def _same_fgfa_state(t, j):
    assert t.next_slot == int(j.next_slot)
    np.testing.assert_array_equal(t.ref_imgs.numpy(), np.asarray(j.ref_imgs))
    np.testing.assert_allclose(t.ref_feats.numpy(), np.asarray(j.ref_feats),
                               rtol=0, atol=MAP_ATOL)


def test_fgfa_stream_matches_jax(pair):
    jmodel, var, tmodel = pair["jmodel"], pair["var"], pair["tmodel"]
    rs = np.random.RandomState(2)
    frames = np.zeros((3 + STREAM_FRAMES, 64, 64, 3), np.float32)
    frames[:, :56, :60] = rs.randn(3 + STREAM_FRAMES, 56, 60, 3)
    sf = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
    jshape, tshape = jnp.asarray(IMG_SHAPE), _t(IMG_SHAPE)
    step = jax.jit(lambda v, st, f: JF.fgfa_inference_step(
        jmodel, v, st, f, jshape, jnp.asarray(sf), pair["janchors"]))
    jstate = JF.fgfa_init_state(jmodel, var, jnp.asarray(frames[:3]))
    tstate = TF.fgfa_init_state(tmodel, _t(frames[:3]))
    _same_fgfa_state(tstate, jstate)
    for t in range(3, 3 + STREAM_FRAMES):
        jstate, jdets = step(var, jstate, jnp.asarray(frames[t]))
        tstate, tdets = TF.fgfa_inference_step(
            tmodel, tstate, _t(frames[t]), tshape, _t(sf), pair["tanchors"])
        _same_dets(tdets, jdets)
        _same_fgfa_state(tstate, jstate)
    assert tstate.next_slot == STREAM_FRAMES % 3
    _same_fgfa_state(fgfa_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate)), jstate)
