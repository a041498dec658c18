"""Port parity for the low-light training method (``darkfarm_loss`` with the
frozen ResCleaner teacher, TemporalRoIAlign and the 3-FC head), against the
JAX package on the CPU in f32.

The model is tiny: R50-DC5 detector and cleaner (the port has only
bottleneck depths), a 64x64 bucket, neck 32, 4 classes, 2 reference frames,
``out_indices=(0, 1, 2, 3, 3)``, ``roi_extractor="temporal"``,
``num_shared_fcs=3``, train_nms_pre 128, train_nms_post 32, test_nms_post
16, 32 sampled rois; weights from the JAX init with every bias, BN scale and
statistic perturbed, bridged by name (``selsa.*``, ``cleaner.resnet.*``).
The samplers get the uniforms the JAX loss draws from its key.

The JAX side is ``darkfarm_loss`` composed from the package's public pieces
with ``jax.lax.stop_gradient`` on the proposal boxes: the original (and the
port) do not differentiate through them, the JAX loss does (ROADMAP fault
F6, shown by ``test_f6_jax_darkfarm_loss_differentiates_through_proposals``).
Tolerances as ``test_torch_port_train.py``: each loss to rtol 1e-5; each
gradient leaf to an atol of 1e-4 of its largest |g|, at least 1e-6 of the
largest of any leaf.

The samples' seeds are chosen so that no ReLU pre-activation lies within
the two frameworks' f32 rounding of 0. Where one does, it passes its
gradient on one side and blocks it on the other: at this size one position
of a stage-4 channel is one of 48, so a leaf's gradient moves by percent,
which no rounding tolerance covers. Seed 0 did so at the first head stage
(a pre-activation of 3.9e-6) and at the backbone's last ReLU; 3 of seeds
0-13 of the clean-branch sample pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_tpu.core import (
    losses as jlosses,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.dense_heads import (
    rpn_head as jrpn,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.roi_heads import (
    bbox_head as jbh,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.vid import (
    selsa as JS,
    selsa_darkfarm as JD,
)
from lowlightenvironmentvideoobjectdetection_tpu.parallel import (
    train as jtrain,
)
from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
    init_model,
)
from lowlightenvironmentvideoobjectdetection_torch.core import (
    losses as tlosses,
)
from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
    selsa as TS,
    selsa_darkfarm as TD,
)
from lowlightenvironmentvideoobjectdetection_torch.parallel import (
    train as ttrain,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.checkpoint import (
    save_checkpoint,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
    grads_from_jax,
)
from torch_port_threads import thread_count


TINY = dict(pad_h=64, pad_w=64, neck_channels=32, num_classes=4,
            num_ref_frames=2, train_nms_pre=128, train_nms_post=32,
            test_nms_post=16, num_roi_samples=32,
            out_indices=(0, 1, 2, 3, 3), roi_extractor="temporal",
            num_shared_fcs=3)
LOSS_RTOL = 1e-5
GRAD_REL_ATOL = 1e-4
GRAD_FLOOR = 1e-6  # of the largest |g| of any leaf
FROZEN = ("selsa.backbone.conv1", "selsa.backbone.bn1",
          "selsa.backbone.layer1_", "cleaner.")
# name: (DarkfarmConfig overrides, branch, the sample's seed)
CASES = {
    "canonical": (dict(), "noise", 2),
    "clean_branch": (dict(), "clean", 6),
    "no_cleaner": (dict(with_cleaner=False), "noise", 2),
    "l2": (dict(loss_type="l2"), "noise", 2),
    "smooth_l1": (dict(loss_type="smooth_l1"), "noise", 2),
    "raw": (dict(in_channels=4), "noise", 2),
}
TRAINER_SEED = 2  # the Trainer step's batch of 2


_pinned_threads = thread_count(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _configs(**kw):
    jcfg = JD.DarkfarmConfig(
        selsa=JS.SelsaConfig(compute_dtype=jnp.float32, **TINY), **kw)
    tcfg = TD.DarkfarmConfig(
        selsa=TS.SelsaConfig(compute_dtype=torch.float32, **TINY), **kw)
    return jcfg, tcfg


def sampler_uniforms(rng, n):
    """The uniforms the JAX samplers draw from ``rng`` for n candidates:
    (pos, neg) keys from a split, the tiebreak from ``fold_in(rng, 17)``."""
    p, q = jax.random.split(rng)
    return np.stack([np.asarray(jax.random.uniform(k, (n,)))
                     for k in (p, q, jax.random.fold_in(rng, 17))])


def jax_uniforms(rng, num_anchors, num_cand):
    """The loss's uniforms for key ``rng``, split into (rpn, roi)."""
    rng_rpn, rng_roi = jax.random.split(rng)
    return TS.LossUniforms(_t(sampler_uniforms(rng_rpn, num_anchors)[:2]),
                           _t(sampler_uniforms(rng_roi, num_cand)))


def _batch(seed=0, n=1, in_channels=3):
    """n samples of a key frame and 2 reference frames of (noise, clean)
    pairs, 8 padded gts of which 5 are valid; the first covers most of the
    image."""
    rng = np.random.RandomState(seed)
    pairs = rng.randn(n, 3, 64, 64, 2 * in_channels).astype(np.float32)
    gts = np.zeros((n, 8, 4), np.float32)
    xy = rng.uniform(-5, 40, (n, 5, 2))
    gts[:, :5] = np.concatenate([xy, xy + rng.uniform(20, 60, (n, 5, 2))], -1)
    gts = np.clip(gts, 0, 64)
    gts[:, 0] = [2.0, 1.0, 62.0, 63.0]
    labels = rng.randint(0, 4, (n, 8)).astype(np.int32)
    valid = np.broadcast_to(np.arange(8) < 5, (n, 8)).copy()
    return JD.DarkfarmBatch(pairs, np.full((n, 2), 64.0, np.float32), gts,
                            labels, valid)


def _sample(batch, i):
    return type(batch)(*(jnp.asarray(f[i]) for f in batch))


def _port_batch(batch, i=None):
    f = (lambda a: a) if i is None else (lambda a: a[i])
    return TD.DarkfarmBatch(*(_t(f(a)) for a in batch[:3]),
                            _t(f(batch.gt_labels)).long(),
                            _t(f(batch.gt_valid)))


def _on_selsa(fn):
    return lambda m, *a: fn(m.selsa, *a)


def _jax_loss_stopped(model, params, batch, rng, anchors, branch="noise"):
    """The JAX ``darkfarm_loss`` composed from the package's public pieces,
    with ``stop_gradient`` on the proposal boxes (ROADMAP F6)."""
    cfg, scfg = model.cfg, model.cfg.selsa
    c = cfg.in_channels
    rng_rpn, rng_roi = jax.random.split(rng)
    pairs = batch.pair_imgs
    stages, neck = model.apply(
        params, pairs[..., :c] if branch == "noise" else pairs[..., c:],
        method=JD.SelsaDarkfarmDetector.extract_noise_feat)
    metrics, total = {}, 0.0
    if cfg.with_cleaner and branch == "noise":
        clean = model.apply(params, pairs[..., c:],
                            method=JD.SelsaDarkfarmDetector.extract_clean_feat)
        for i in range(len(cfg.loss_stages)):
            fl = JD._FEAT_LOSS[cfg.loss_type](stages[i].astype(jnp.float32),
                                              clean[i].astype(jnp.float32))
            metrics[f"loss_{cfg.loss_type}_{i}"] = fl
            total = total + fl
    cls, reg = model.apply(params, neck,
                           method=_on_selsa(JS.SelsaDetector.rpn_forward))
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
                     jnp.zeros((tgts.rois.shape[0],), jnp.int32), neck[1:],
                     method=_on_selsa(JS.SelsaDetector.roi_feats_troi))
    ref_boxes = jax.lax.stop_gradient(
        jnp.concatenate([p.boxes for p in refs]))
    binds = jnp.repeat(jnp.arange(len(refs), dtype=jnp.int32),
                       scfg.test_nms_post)
    rf = model.apply(params, neck[1:], ref_boxes, binds,
                     method=_on_selsa(JS.SelsaDetector.roi_feats))
    cs, bp = model.apply(params, kf, rf,
                         jnp.concatenate([p.valid for p in refs]),
                         method=_on_selsa(JS.SelsaDetector.bbox_forward))
    roi_l = jbh.bbox_loss(cs, bp, tgts, num_classes=scfg.num_classes)
    total = (total + rpn_l.loss_cls + rpn_l.loss_bbox + roi_l.loss_cls
             + roi_l.loss_bbox)
    metrics.update(loss=total, loss_rpn_cls=rpn_l.loss_cls,
                   loss_rpn_bbox=rpn_l.loss_bbox, loss_cls=roi_l.loss_cls,
                   loss_bbox=roi_l.loss_bbox, acc=roi_l.acc)
    return total, metrics


def _variant_params(params, in_channels, with_cleaner, rng):
    """The canonical tree for another config: without the cleaner, or with
    4-channel stems (new random conv1 kernels)."""
    out = {coll: {k: v for k, v in tree.items()
                  if with_cleaner or k != "cleaner"}
           for coll, tree in params.items()}
    if in_channels != 3:
        p = out["params"] = dict(out["params"])
        for name, sub in (("selsa", "backbone"), ("cleaner", "resnet")):
            if name not in p:
                continue
            tree = p[name] = dict(p[name])
            stem = tree[sub] = dict(tree[sub])
            k = stem["conv1"]["kernel"]
            stem["conv1"] = {"kernel": (rng.randn(*k.shape[:2], in_channels,
                                                  k.shape[3]) * 0.1
                                        ).astype(np.float32)}
    return out


@pytest.fixture(scope="module")
def base():
    """The JAX canonical model's perturbed variables, anchors and key."""
    jcfg, _ = _configs()
    jmodel = JD.SelsaDarkfarmDetector(cfg=jcfg)
    params = JD.init_darkfarm_params(jmodel, jax.random.PRNGKey(0))
    rng = np.random.RandomState(7)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x, np.float32)
        * (rng.uniform(0.8, 1.25, x.shape) if str(p[-1].key) in
           ("var", "scale") else 1.0)
        + (rng.randn(*x.shape) * 0.02 if str(p[-1].key) in ("bias", "mean")
           else 0.0), params)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    params)
    return dict(params=params, anchors=np.asarray(JS.make_anchors(jcfg.selsa)),
                key=jax.random.PRNGKey(11))


def _case(base, name):
    """The JAX model, params and loss with every gradient, and the port
    model with the same weights, for one of CASES."""
    kw, branch, seed = CASES[name]
    jcfg, tcfg = _configs(**kw)
    jmodel = JD.SelsaDarkfarmDetector(cfg=jcfg)
    params = _variant_params(base["params"], jcfg.in_channels,
                             jcfg.with_cleaner, np.random.RandomState(3))
    batch = _batch(seed, in_channels=jcfg.in_channels)
    sample = _sample(batch, 0)
    anchors = jnp.asarray(base["anchors"])
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss_stopped(jmodel, p, sample, base["key"], anchors,
                                    branch), has_aux=True))(params)
    tmodel = TD.SelsaDarkfarmDetector(tcfg)
    tmodel.load_state_dict(from_jax_variables(params), strict=True)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(jmodel=jmodel, params=params, tmodel=tmodel, batch=batch,
                branch=branch, metrics=to_np(metrics),
                grads=grads_from_jax(to_np(grads["params"])))


@pytest.fixture(scope="module")
def canonical(base):
    return _case(base, "canonical")


def _uniforms(base):
    return jax_uniforms(base["key"], base["anchors"].shape[0],
                        8 + TINY["train_nms_post"])


def _port_loss(case, uniforms, anchors, roi_only=False):
    """The port's loss on the case's sample; its metrics and parameter name
    -> gradient (zeros where no gradient)."""
    model = case["tmodel"]
    model.zero_grad(set_to_none=True)
    loss, metrics = TD.darkfarm_loss(model, _port_batch(case["batch"], 0),
                                     _t(anchors), uniforms=uniforms,
                                     branch=case["branch"])
    (metrics["loss_cls"] + metrics["loss_bbox"] if roi_only
     else loss).backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    return {k: v.item() for k, v in metrics.items()}, grads


def _floor(grads):
    return GRAD_FLOOR * max(float(g.abs().max()) for g in grads.values())


def _check_loss_and_grads(case, base):
    metrics, grads = _port_loss(case, _uniforms(base), base["anchors"])
    assert set(metrics) == set(case["metrics"])
    for k, v in case["metrics"].items():
        np.testing.assert_allclose(metrics[k], v, rtol=LOSS_RTOL, err_msg=k)
    assert metrics["loss_rpn_bbox"] > 0 and metrics["loss_bbox"] > 0
    assert set(grads) == set(case["grads"])
    floor = _floor(case["grads"])
    for name, want in case["grads"].items():
        scale = float(want.abs().max())
        np.testing.assert_allclose(grads[name].numpy(), want.numpy(), rtol=0,
                                   atol=max(GRAD_REL_ATOL * scale, floor),
                                   err_msg=name)
    frozen = [n for n in grads if n.startswith(FROZEN)]
    assert frozen and all(not grads[n].any() and not case["grads"][n].any()
                          for n in frozen)
    # TemporalRoIAlign's embed conv and the third FC learn
    for name in ("selsa.troi.embed_network.weight",
                 "selsa.bbox_head.shared_fc2.weight"):
        assert case["grads"][name].abs().max() > 0, name
    return metrics, grads


def test_darkfarm_loss_and_every_gradient_match_jax(canonical, base):
    metrics, grads = _check_loss_and_grads(canonical, base)
    assert {f"loss_l1_{i}" for i in range(4)} <= set(metrics)
    # the feature loss reaches the detector's unfrozen stages, not stage 1
    assert grads["selsa.backbone.layer4_2.conv3.weight"].abs().max() > 0


def test_f6_jax_darkfarm_loss_differentiates_through_proposals(canonical,
                                                               base):
    """The JAX ``darkfarm_loss`` itself gives the same losses and the same
    bbox-head gradients of the RoI loss, but its RoI loss also reaches the
    RPN regression conv through the proposal boxes; the port's does not."""
    jmodel, params = canonical["jmodel"], canonical["params"]
    sample = _sample(canonical["batch"], 0)
    anchors = jnp.asarray(base["anchors"])

    def roi_part(p):
        _, m = JD.darkfarm_loss(jmodel, p, sample, base["key"], anchors)
        return m["loss_cls"] + m["loss_bbox"], m

    (_, jm), jg = jax.jit(jax.value_and_grad(roi_part, has_aux=True))(params)
    jg = grads_from_jax(jax.tree_util.tree_map(np.asarray, jg["params"]))
    metrics, grads = _port_loss(canonical, _uniforms(base), base["anchors"],
                                roi_only=True)
    for k, v in jm.items():
        np.testing.assert_allclose(metrics[k], np.asarray(v), rtol=LOSS_RTOL,
                                   err_msg=k)
    floor = _floor(jg)
    for name, want in jg.items():
        if name.startswith("selsa.bbox_head."):
            np.testing.assert_allclose(
                grads[name].numpy(), want.numpy(), rtol=0,
                atol=max(GRAD_REL_ATOL * float(want.abs().max()), floor),
                err_msg=name)
    assert jg["selsa.rpn_head.rpn_reg.weight"].abs().sum() > 0
    assert not grads["selsa.rpn_head.rpn_reg.weight"].any()


def test_trainer_step_matches_jax_trainer(canonical, base):
    """One step of the JAX ``Trainer`` (vmap of the stop-gradient loss over
    a batch of 2, its mean, optax) on a one-device mesh against the port's
    ``Trainer`` with ``darkfarm_loss`` and the same per-sample uniforms:
    mean losses to rtol 1e-5; each leaf's update to 1e-4 of the leaf's
    largest update, at least 1e-6 of the largest of any leaf, plus two
    float32 roundings of the parameter; the cleaner and the frozen stages
    bit-identical on both sides."""
    jmodel, params = canonical["jmodel"], canonical["params"]
    anchors = base["anchors"]
    batch = _batch(seed=TRAINER_SEED, n=2)
    janchors = jnp.asarray(anchors)
    trainer = jtrain.Trainer(
        loss_fn=lambda v, b, r: _jax_loss_stopped(jmodel, v, b, r, janchors),
        optimizer=jtrain.make_optimizer(params, lr=0.01),
        mesh=jtrain.create_mesh(1))
    rng = jax.random.PRNGKey(21)
    jstate, jmetrics = trainer.make_step()(
        trainer.init_state(params), jax.tree_util.tree_map(jnp.asarray, batch),
        rng)
    new = grads_from_jax(jax.tree_util.tree_map(np.asarray,
                                                jstate.params["params"]))

    model = TD.SelsaDarkfarmDetector(canonical["tmodel"].cfg)
    model.load_state_dict(canonical["tmodel"].state_dict(), strict=True)
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    cand = 8 + TINY["train_nms_post"]
    rngs = [jax_uniforms(k, anchors.shape[0], cand)
            for k in jax.random.split(rng, 2)]
    ptrainer = ttrain.Trainer(
        lambda m, s, u: TD.darkfarm_loss(m, s, _t(anchors), uniforms=u),
        ttrain.make_optimizer(model, lr=0.01))
    state, metrics = ptrainer.step(ptrainer.init_state(model),
                                   _port_batch(batch), rngs)
    assert state.step == 1
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], np.asarray(v), rtol=LOSS_RTOL,
                                   err_msg=k)
    got = {n: p.detach() - old[n] for n, p in model.named_parameters()}
    want = {n: new[n] - old[n] for n in got}
    floor = _floor(want)
    for n in got:
        ulp = 2 * np.finfo(np.float32).eps * float(old[n].abs().max())
        np.testing.assert_allclose(
            got[n].numpy(), want[n].numpy(), rtol=0,
            atol=max(GRAD_REL_ATOL * float(want[n].abs().max()), floor) + ulp,
            err_msg=n)
        if n.startswith(FROZEN):
            assert not got[n].any() and not want[n].any(), n
    assert any(n.startswith("cleaner.resnet.") for n in got)


def test_frozen_mask_matches_jax(canonical):
    """The optimizer's mask on the darkfarm tree: the cleaner and the
    detector's stem and stage 1 frozen, at any depth, as in JAX."""
    params = canonical["params"]["params"]
    mask = jtrain.frozen_mask(params)
    want = grads_from_jax(jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32), mask,
        params))
    got = ttrain.make_optimizer(canonical["tmodel"]).trainable
    assert set(got) == set(want)
    for n, trainable in got.items():
        assert trainable == bool(want[n].all()), n
        assert trainable != n.startswith(FROZEN), n


def test_with_aggregator_builds_and_reports_dual_losses():
    """``with_aggregator=True`` builds the Denoising2Aggregator over the
    loss stages and ``darkfarm_loss`` reports each stage's feature loss on
    the undenoised (``_u``) and denoised (``_d``) features; an unknown
    ``dual_branch`` raises. (Parity with JAX:
    ``tests/test_torch_port_aggregator_loss.py``.)"""
    with pytest.raises(ValueError, match="dual_branch"):
        TD.DarkfarmConfig(dual_branch="x")
    tiny = dict(TINY, out_indices=(3, 3))
    cfg = TD.DarkfarmConfig(
        selsa=TS.SelsaConfig(compute_dtype=torch.float32, **tiny),
        with_aggregator=True)
    assert cfg.stage_channels == (2048,)
    model, anchors = TD.make_darkfarm(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    agg = model.aggregator
    assert agg.num_stages == 1 and agg.stage0_conv2.out_channels == 32
    batch = _port_batch(_batch(2), 0)
    with torch.no_grad():
        _, metrics = TD.darkfarm_loss(
            model, batch, anchors, generator=torch.Generator().manual_seed(1))
    assert {k for k in metrics if k.startswith("loss_l1")} == {
        "loss_l1_0_u", "loss_l1_0_d"}
    assert all(np.isfinite(v.item()) for v in metrics.values())


def test_feature_losses_match_jax():
    rng = np.random.RandomState(1)
    pred, target = rng.randn(2, 40, 5, 6).astype(np.float32)
    w = (rng.rand(40, 5, 6) > 0.3).astype(np.float32)
    for tf, jf in ((tlosses.l1_loss, jlosses.l1_loss),
                   (tlosses.mse_loss, jlosses.mse_loss)):
        for kw in (dict(), dict(weight=w, avg_factor=7.0)):
            got = tf(_t(pred), _t(target),
                     **{k: _t(v) if k == "weight" else v
                        for k, v in kw.items()})
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(jf(pred, target, **kw)),
                                       rtol=LOSS_RTOL)


def test_init_model_takes_a_darkfarm_state_dict(canonical, tmp_path):
    """A darkfarm state dict, given, saved or inside a ``TrainState``
    checkpoint of ``train_model``, streams through ``init_model`` as the
    temporal 3-FC detector: its ``selsa.`` weights, none of the cleaner's;
    the 6-channel pairs give their noisy half."""
    model = canonical["tmodel"]
    sd = model.state_dict()
    torch.save(sd, tmp_path / "darkfarm.pt")
    opt = ttrain.make_optimizer(model)
    ckpt = save_checkpoint(str(tmp_path), ttrain.TrainState(
        model, opt.init(dict(model.named_parameters())), 3))
    kw = {k: v for k, v in TINY.items() if k != "out_indices"}
    for m in (init_model(state_dict=sd, device="cpu",
                         compute_dtype=torch.float32, **kw),
              init_model(checkpoint=str(tmp_path / "darkfarm.pt"),
                         device="cpu", compute_dtype=torch.float32, **kw),
              init_model(checkpoint=ckpt, device="cpu",
                         compute_dtype=torch.float32, **kw)):
        own = m.model.state_dict()
        assert set(own) == {k[len("selsa."):] for k in sd
                            if k.startswith("selsa.")}
        assert all(torch.equal(v, sd["selsa." + k]) for k, v in own.items())
        pairs = canonical["batch"].pair_imgs[0]
        outs = [m.inference_vid_prepared(
                    pairs[t], frame_id=t, ref_imgs=None if t else pairs[1:])
                for t in range(2)]
        assert m.state.ref_maps.shape == (2, 4, 4, 32)
        assert all(len(o["bbox_results"]) == 4 for o in outs)
