"""Port parity for SELSA on the dark backbones, against the JAX package on
the CPU in f32:

- ``darkfarm_loss`` and every gradient leaf for the ConvLSTM config
  (``llvod_lstm_darkfarm.py``: ``SelsaDarkDetect``, DarkResNet, the L2
  feature loss against the frozen teacher) and for the insert-plugins
  config (``llvod_insert_plugins_l34_i1234_vid_a7s3.py``: InsertResNet with
  a ``DenoisingAggregator`` after every stage, no teacher), each built by
  both packages' model builders from the config file at the CLIs' ``--tiny``
  sizes (``TINY_KW``, f32) with a 32-channel neck. The insert-plugins case
  sets ``plugin_rdb_layers=1`` on both sides (the config's 8 only deepens
  the RDBs; 1 keeps the JAX compile of the loss and its gradients short).
  Tolerances as ``test_torch_port_darkfarm.py``: each loss to rtol 1e-5,
  each gradient leaf to an atol of 1e-4 of its largest |g|, at least 1e-6
  of the largest of any leaf. The JAX loss is the package's own pieces
  with ``stop_gradient`` on the proposal boxes (ROADMAP F6); the samplers
  take the uniforms JAX draws from its key.
- Streaming with a dark variant (DarkResNet: the ConvLSTM in ``layer2``,
  which ``SelsaDarkDetect`` streams; the DCN variants' clips are held in
  ``test_torch_port_dark_backbones.py``): ``init_video_state`` over 2
  reference frames (one clip, in order) and ``inference_step`` against the
  JAX functions, and the batched step of S = 2 streams (the port's
  backbone takes them as 2 clips of one frame) against
  ``jax.vmap(inference_step)``. Proposals identical in validity (boxes to
  1e-3 px), detections equal as sets (5e-3 px, 1e-5), the memo to 1e-4, as
  ``test_torch_port_serve.py``.

The variables are drawn in the shapes of ``jax.eval_shape(init)``
(``test_torch_port_dark_backbones.draw``: ``conv_offset`` scaled so that
the offsets are fractional and reach beyond a pixel); the JAX DCN is
pinned to its 'scan' form (``pin_scan``, ROADMAP F1).

Each case's sample seed is the first from 0 on which every leaf is within
tolerance: 0 for both. A ReLU pre-activation within the two frameworks'
f32 rounding of 0 passes its gradient on one side and blocks it on the
other (see ``test_torch_port_darkfarm.py``); ``relu_kinks.py`` finds it by
giving the port's ReLU the other branch's gradient at the pre-activations
nearest 0, one element at a time. Seeds 1 and 3 of the ConvLSTM case fail,
and one element each brings every leaf within tolerance: at seed 1 in the
residual ReLU of ``layer3_2`` (a pre-activation of 2.4e-7, 5.5e-8 of its
call's largest |x|; worst leaf ``layer3_0.downsample_conv.weight`` at 6.7
times its atol), at seed 3 in the first ReLU of ``layer2_1`` (2.0e-7;
``layer2_1.conv1.weight`` at 39 times).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_tpu import zoo  # noqa: F401
from lowlightenvironmentvideoobjectdetection_tpu.models.dense_heads import (
    rpn_head as jrpn,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.roi_heads import (
    bbox_head as jbh,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.vid import (
    selsa as JS,
    selsa_darkfarm as JDF,
)
from lowlightenvironmentvideoobjectdetection_tpu.registry import MODELS
from lowlightenvironmentvideoobjectdetection_torch import config as tconfig
from lowlightenvironmentvideoobjectdetection_torch.models import (
    builder as tb,
)
from lowlightenvironmentvideoobjectdetection_torch.models.backbones import (
    dark_resnet as TDR,
)
from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
    selsa as TS,
    selsa_darkfarm as TDF,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
    grads_from_jax,
    video_state_from_jax,
)
from test_torch_port_dark_backbones import draw, pin_scan
from test_torch_port_darkfarm import (
    GRAD_FLOOR,
    GRAD_REL_ATOL,
    LOSS_RTOL,
    _batch,
    _port_batch,
    _sample,
    jax_uniforms,
)
from test_torch_port_serve import _same_dets, _same_state
from torch_port_threads import thread_count


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLVOD = os.path.join(ROOT, "configs/vid/llvod")
# name: (config file, model dict overrides on both sides, sample seed)
CASES = {
    "lstm": ("llvod_lstm_darkfarm.py", {}, 0),
    "insert_plugins": ("llvod_insert_plugins_l34_i1234_vid_a7s3.py",
                       dict(plugin_rdb_layers=1), 0),
}
FROZEN = ("selsa.backbone.conv1", "selsa.backbone.bn1",
          "selsa.backbone.layer1_", "cleaner.")


_pinned_threads = thread_count(1)


def _model_dict(name):
    path, plugin, _ = CASES[name]
    m = dict(tconfig.load_config(os.path.join(LLVOD, path))["model"],
             neck_channels=32)
    if plugin:
        m["backbone_overrides"] = dict(m["backbone_overrides"], **plugin)
    return m


def _jax_model(model_dict):
    """The JAX zoo's model at the CLI's ``--tiny`` sizes (its TINY_KW), in
    f32, without the TPU's remat."""
    kw = dict(model_dict, **dict(tb.TINY_KW, compute_dtype="float32"),
              remat=False)
    return MODELS.get(kw.pop("type"))(**kw)


def _jax_loss_stopped(model, params, batch, rng, anchors):
    """The JAX ``darkfarm_loss`` (noise branch) from the package's public
    pieces, with ``stop_gradient`` on the proposal boxes (ROADMAP F6)."""
    cfg, scfg = model.cfg, model.cfg.selsa
    c = cfg.in_channels
    rng_rpn, rng_roi = jax.random.split(rng)
    pairs = batch.pair_imgs

    def on_selsa(fn):
        return lambda m, *a: fn(m.selsa, *a)

    stages, neck = model.apply(
        params, pairs[..., :c],
        method=JDF.SelsaDarkfarmDetector.extract_noise_feat)
    metrics, total = {}, 0.0
    if cfg.with_cleaner:
        clean = model.apply(
            params, pairs[..., c:],
            method=JDF.SelsaDarkfarmDetector.extract_clean_feat)
        for i in range(len(cfg.loss_stages)):
            fl = JDF._FEAT_LOSS[cfg.loss_type](
                stages[i].astype(jnp.float32), clean[i].astype(jnp.float32))
            metrics[f"loss_{cfg.loss_type}_{i}"] = fl
            total = total + fl
    cls, reg = model.apply(params, neck,
                           method=on_selsa(JS.SelsaDetector.rpn_forward))
    rpn_l = jrpn.rpn_loss([(cls[0], reg[0])], [anchors], batch.gt_boxes,
                          batch.gt_valid, rng_rpn, batch.img_shape)
    key = jrpn.rpn_proposals([(cls[0], reg[0])], [anchors], batch.img_shape,
                             nms_pre=scfg.train_nms_pre,
                             nms_post=scfg.train_nms_post,
                             iou_threshold=scfg.rpn_nms_iou)
    refs = [jrpn.rpn_proposals([(cls[i], reg[i])], [anchors], batch.img_shape,
                               nms_pre=scfg.test_nms_pre,
                               nms_post=scfg.test_nms_post,
                               iou_threshold=scfg.rpn_nms_iou)
            for i in range(1, pairs.shape[0])]
    tgts = jbh.bbox_targets(jax.lax.stop_gradient(key.boxes), key.valid,
                            batch.gt_boxes, batch.gt_labels, batch.gt_valid,
                            rng_roi, num_classes=scfg.num_classes,
                            num_samples=scfg.num_roi_samples)
    kf = model.apply(params, neck[0], tgts.rois,
                     jnp.zeros((tgts.rois.shape[0],), jnp.int32),
                     method=on_selsa(JS.SelsaDetector.roi_feats))
    ref_boxes = jax.lax.stop_gradient(
        jnp.concatenate([p.boxes for p in refs]))
    binds = jnp.repeat(jnp.arange(len(refs), dtype=jnp.int32),
                       scfg.test_nms_post)
    rf = model.apply(params, neck[1:], ref_boxes, binds,
                     method=on_selsa(JS.SelsaDetector.roi_feats))
    cs, bp = model.apply(params, kf, rf,
                         jnp.concatenate([p.valid for p in refs]),
                         method=on_selsa(JS.SelsaDetector.bbox_forward))
    roi_l = jbh.bbox_loss(cs, bp, tgts, num_classes=scfg.num_classes)
    total = (total + rpn_l.loss_cls + rpn_l.loss_bbox + roi_l.loss_cls
             + roi_l.loss_bbox)
    metrics.update(loss=total, loss_rpn_cls=rpn_l.loss_cls,
                   loss_rpn_bbox=rpn_l.loss_bbox, loss_cls=roi_l.loss_cls,
                   loss_bbox=roi_l.loss_bbox, acc=roi_l.acc)
    return total, metrics


def loss_and_grads(name, seed):
    """Both packages' ``darkfarm_loss`` for case ``name`` on the sample of
    ``seed``: (the JAX metrics, the JAX gradients by port name, the port
    model, and a function that runs the port's loss and backward afresh and
    returns its metrics and gradients by name)."""
    model_dict = _model_dict(name)
    with pytest.MonkeyPatch.context() as mp:
        pin_scan(mp)
        jmodel, janchors = _jax_model(model_dict)
        batch = _batch(seed)
        sample = _sample(batch, 0)
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                sample.pair_imgs)
        params = jax.tree_util.tree_map(
            np.asarray, draw(shapes, np.random.RandomState(0),
                             offset_std=2.0))
        key = jax.random.PRNGKey(11)
        (_, jm), jg = jax.jit(jax.value_and_grad(
            lambda p: _jax_loss_stopped(jmodel, p, sample, key, janchors),
            has_aux=True))(params)
    want = grads_from_jax(jax.tree_util.tree_map(np.asarray, jg["params"]))

    tcfg = tb.model_config(model_dict, tiny=True)
    assert tcfg.selsa.backbone_variant == jmodel.cfg.selsa.backbone_variant
    tmodel = TDF.SelsaDarkfarmDetector(tcfg)
    tmodel.load_state_dict(from_jax_variables(params), strict=True)
    uniforms = jax_uniforms(key, janchors.shape[0],
                            8 + tcfg.selsa.train_nms_post)

    def port():
        tmodel.zero_grad(set_to_none=True)
        loss, metrics = TDF.darkfarm_loss(
            tmodel, _port_batch(batch, 0),
            torch.from_numpy(np.asarray(janchors)), uniforms=uniforms)
        loss.backward()
        return metrics, {n: (p.grad if p.grad is not None
                             else torch.zeros_like(p))
                         for n, p in tmodel.named_parameters()}
    return jm, want, tmodel, port


@pytest.mark.parametrize("name", sorted(CASES))
def test_dark_darkfarm_loss_and_every_gradient_match_jax(name):
    jm, want, tmodel, port = loss_and_grads(name, CASES[name][2])
    metrics, got = port()
    assert set(metrics) == set(jm)
    assert all(np.isfinite(np.asarray(v)) for v in jm.values())
    for k, v in jm.items():
        np.testing.assert_allclose(metrics[k].item(), np.asarray(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert metrics["loss_rpn_bbox"] > 0 and metrics["loss_bbox"] > 0
    assert set(got) == set(want)
    assert all(torch.isfinite(g).all() for g in got.values())
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in want.values())
    for n, w in want.items():
        np.testing.assert_allclose(
            got[n].numpy(), w.numpy(), rtol=0,
            atol=max(GRAD_REL_ATOL * float(w.abs().max()), floor), err_msg=n)
    frozen = [n for n in got if n.startswith(FROZEN)]
    assert frozen and all(not got[n].any() for n in frozen)
    backbone = tmodel.selsa.backbone
    if name == "lstm":
        assert {f"loss_l2_{i}" for i in range(4)} <= set(metrics)
        assert isinstance(backbone.layer2_0, TDR.ConvLSTMBottleneck)
        assert got["selsa.backbone.layer2_3.gate_f.weight"].abs().max() > 0
    else:
        # plugin1 sits before stage 1's gradient stop: trainable, but no
        # gradient reaches it, in JAX as in the port; the later ones learn
        for n in got:
            if n.startswith("selsa.backbone.plugin1."):
                assert not got[n].any() and not want[n].any(), n
        assert got["selsa.backbone.plugin2.conv1.weight"].abs().max() > 0
        assert got["selsa.backbone.plugin4.taf.dcn_pack.conv_offset.weight"
                   ].abs().max() > 0


# ---- streaming on a dark backbone

TINY = dict(pad_h=64, pad_w=64, test_nms_pre=64, test_nms_post=8,
            num_ref_frames=2, num_classes=3, neck_channels=32,
            backbone_variant="DarkResNet")
S = 2
IMG_SHAPES = np.array([[60.0, 60.0], [52.0, 64.0]], np.float32)
SCALE_FACTORS = np.array([[1.0] * 4, [0.5] * 4], np.float32)


@pytest.fixture(scope="module")
def stream():
    """Both packages' tiny SELSA on DarkResNet with the same drawn weights,
    each stream's memo from the JAX ``init_video_state``, and one frame of
    each stream through ``jax.vmap(inference_step)`` with the roll."""
    with pytest.MonkeyPatch.context() as mp:
        pin_scan(mp)
        jcfg = JS.SelsaConfig(compute_dtype=jnp.float32, **TINY)
        jmodel = JS.SelsaDetector(cfg=jcfg)
        rng = np.random.RandomState(0)
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                jnp.zeros((2, 64, 64, 3), jnp.float32))
        params = jax.tree_util.tree_map(np.asarray,
                                        draw(shapes, rng, offset_std=2.0))
        refs = rng.uniform(-2, 2, (S, 2, 64, 64, 3)).astype(np.float32)
        frames = rng.uniform(-2, 2, (S, 64, 64, 3)).astype(np.float32)
        janchors = JS.make_anchors(jcfg)
        init = jax.jit(lambda r, shp: JS.init_video_state(
            jmodel, params, r, shp, janchors))
        jstates = [init(jnp.asarray(refs[s]), jnp.asarray(IMG_SHAPES[s]))
                   for s in range(S)]
        jbatch = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *jstates)
        step = jax.jit(jax.vmap(lambda st, fr, shp, sf: JS.inference_step(
            jmodel, params, st, fr, shp, sf, janchors, update_memo=True)))
        jout = step(jbatch, jnp.asarray(frames), jnp.asarray(IMG_SHAPES),
                    jnp.asarray(SCALE_FACTORS))
    tmodel = TS.SelsaDetector(TS.SelsaConfig(compute_dtype=torch.float32,
                                             **TINY))
    tmodel.load_state_dict(from_jax_variables(params), strict=True)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(tmodel=tmodel.eval(), refs=refs, frames=frames,
                tanchors=TS.make_anchors(tmodel.cfg),
                jstates=[to_np(s) for s in jstates], jbatch=to_np(jbatch),
                jout=to_np(jout))


def test_dark_init_video_state_matches_jax(stream):
    """The memo from 2 reference frames as one clip of the ConvLSTM, in
    their order."""
    for s in range(S):
        st = TS.init_video_state(stream["tmodel"],
                                 torch.from_numpy(stream["refs"][s]),
                                 torch.from_numpy(IMG_SHAPES[s]),
                                 stream["tanchors"])
        _same_state(st, stream["jstates"][s])
        assert st.ref_valid.any()


def test_dark_inference_step_single_and_batched_match_jax(stream):
    """One frame of each stream: the batched step (2 clips of one frame)
    against ``jax.vmap(inference_step)``, the rolled memo included; each
    stream's single step against the same."""
    jstates, jdets = stream["jout"]
    states = video_state_from_jax(stream["jbatch"])
    args = (torch.from_numpy(stream["frames"]), torch.from_numpy(IMG_SHAPES),
            torch.from_numpy(SCALE_FACTORS), stream["tanchors"])
    tstates, tdets = TS.inference_step_batch(stream["tmodel"], states, *args,
                                             update_memo=True)
    one = lambda d, s: type(d)(*(f[s] for f in d))  # noqa: E731
    for s in range(S):
        _same_dets(one(tdets, s), one(jdets, s))
        st, dets = TS.inference_step(
            stream["tmodel"], video_state_from_jax(stream["jstates"][s]),
            *(a[s] for a in args[:3]), stream["tanchors"], update_memo=True)
        _same_dets(dets, one(jdets, s))
        _same_state(st, jax.tree_util.tree_map(lambda a: a[s], jstates))
    _same_state(tstates, jstates)
