"""Port parity for the canonical low-light training loss with its
Denoising2Aggregator (``SelsaNewDarkfarmDetect``: ``darkfarm_loss`` with
``with_aggregator=True`` and the dual ``_u`` / ``_d`` feature losses)
against the JAX package's ``darkfarm_loss`` on the CPU in f32.

The config is the JAX package's own test's
(``tests/test_darkfarm_and_noise.py`` ``test_dual_losses_and_grads``): R50-DC5, one loss stage
(``out_indices=(3, 3)``: the aggregator's single stage runs at the full
2048 channels, about 90M parameters), a 64x64 bucket; with the port's
small heads (neck 32, 4 classes, TemporalRoIAlign, 3 shared FCs, 2
reference frames). The JAX side runs ``agg_dcn_impl="scan"`` (unbounded
offsets, as the port; ROADMAP F1), composed from the package's public
pieces with ``stop_gradient`` on the proposal boxes, as
``tests/test_torch_port_darkfarm.py`` does for F6.

The variables are drawn with numpy in the shapes of the JAX tree: kernels
with a variance of 1 / fan_in, ``conv_offset``'s scaled so the offsets are
fractional and a few px wide (the zero init puts every sample on a pixel),
biases and BN statistics perturbed. They are bridged by name. Tolerances
as the darkfarm test: each loss and metric to rtol 1e-5; each gradient leaf
(the aggregator's included) to an atol of 1e-4 of its largest |g|, at least
1e-6 of the largest of any leaf.

The sample's seed is chosen so that no ReLU pre-activation and no DCN
sample position lies within the two frameworks' f32 rounding of its kink:
with sample seed 0 a ReLU of the backbone's last stage does (a leaf there
is 258 tolerances off, the aggregator's within them); seeds 1 and 2 pass,
the worst leaf at 0.21 and 0.27 of its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
    selsa as TS,
    selsa_darkfarm as TD,
)
from lowlightenvironmentvideoobjectdetection_torch.parallel import (
    train as ttrain,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
    grads_from_jax,
)
from test_torch_port_darkfarm import (
    TINY,
    _batch,
    _on_selsa,
    _port_batch,
    _sample,
    _t,
    jax_uniforms,
)
from torch_port_threads import thread_count


AGG = dict(TINY, out_indices=(3, 3))
LOSS_RTOL = 1e-5
GRAD_REL_ATOL = 1e-4
GRAD_FLOOR = 1e-6  # of the largest |g| of any leaf
OFFSET_STD = 1.0  # px, roughly, of the drawn conv_offset's outputs
SEED = 1  # the sample's
FROZEN = ("selsa.backbone.conv1", "selsa.backbone.bn1",
          "selsa.backbone.layer1_", "cleaner.")
# metrics-only variants: (DarkfarmConfig overrides)
VARIANTS = {"u_without_rdb": dict(dual_branch="u", agg_rdb=False),
            "d_without_taf": dict(dual_branch="d", agg_taf=False)}


_pinned_threads = thread_count(1)


def _configs(**kw):
    jcfg = JD.DarkfarmConfig(
        selsa=JS.SelsaConfig(compute_dtype=jnp.float32, **AGG),
        with_aggregator=True, agg_dcn_impl="scan", **kw)
    tcfg = TD.DarkfarmConfig(
        selsa=TS.SelsaConfig(compute_dtype=torch.float32, **AGG),
        with_aggregator=True, **kw)
    return jcfg, tcfg


def _draw(shapes, rs):
    """Variables in the JAX tree's shapes: conv and dense kernels and the
    DCN's weight N(0, 1 / fan_in) (``conv_offset``'s times OFFSET_STD),
    biases and BN shifts and means N(0, 0.02^2), BN scales and variances
    uniform in [0.8, 1.25]."""
    def leaf(path, a):
        names = [str(getattr(p, "key", p)) for p in path]
        if names[-1] in ("scale", "var"):
            return rs.uniform(0.8, 1.25, a.shape).astype(np.float32)
        if names[-1] in ("bias", "mean"):
            return (rs.randn(*a.shape) * 0.02).astype(np.float32)
        scale = 1.0 / np.sqrt(np.prod(a.shape[:-1]))
        if "conv_offset" in names:
            scale *= OFFSET_STD
        return (rs.randn(*a.shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_loss_stopped(model, params, batch, rng, anchors):
    """The JAX ``darkfarm_loss`` with the aggregator (noise branch),
    composed from the package's public pieces, with ``stop_gradient`` on
    the proposal boxes (ROADMAP F6)."""
    cfg, scfg = model.cfg, model.cfg.selsa
    c = cfg.in_channels
    rng_rpn, rng_roi = jax.random.split(rng)
    pairs = batch.pair_imgs
    stages, neck = model.apply(
        params, pairs[..., :c],
        method=JD.SelsaDarkfarmDetector.extract_noise_feat)
    denoised, neck = model.apply(
        params, stages, neck, method=JD.SelsaDarkfarmDetector.denoise_feats)
    clean = model.apply(params, pairs[..., c:],
                        method=JD.SelsaDarkfarmDetector.extract_clean_feat)
    metrics, total = {}, 0.0
    for i in range(len(cfg.loss_stages)):
        for tag, feats in (("u", stages), ("d", denoised)):
            if cfg.dual_branch in ("both", tag):
                fl = JD._FEAT_LOSS[cfg.loss_type](
                    feats[i].astype(jnp.float32),
                    clean[i].astype(jnp.float32))
                metrics[f"loss_{cfg.loss_type}_{i}_{tag}"] = fl
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


def _without(params, *modules):
    """The tree without the aggregator's submodules whose names contain
    one of ``modules``."""
    p = dict(params["params"])
    p["aggregator"] = {k: v for k, v in p["aggregator"].items()
                       if not any(m in k for m in modules)}
    return dict(params, params=p)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def case():
    """The JAX model, its drawn variables, the sample, the loss with every
    gradient (one jitted ``value_and_grad``), and the port model with the
    same weights."""
    jcfg, tcfg = _configs()
    jmodel = JD.SelsaDarkfarmDetector(cfg=jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 6)))
    params = _draw(shapes, np.random.RandomState(5))
    anchors = np.asarray(JS.make_anchors(jcfg.selsa))
    key = jax.random.PRNGKey(11)
    batch = _batch(SEED)
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss_stopped(jmodel, p, _sample(batch, 0), key,
                                    jnp.asarray(anchors)),
        has_aux=True))(params)
    tmodel = TD.SelsaDarkfarmDetector(tcfg)
    tmodel.load_state_dict(from_jax_variables(params), strict=True)
    return dict(jmodel=jmodel, params=params, tmodel=tmodel, batch=batch,
                anchors=anchors, key=key, metrics=_to_np(metrics),
                grads=grads_from_jax(_to_np(grads["params"])),
                uniforms=jax_uniforms(key, anchors.shape[0],
                                      8 + AGG["train_nms_post"]))


def _port_loss(model, case):
    model.zero_grad(set_to_none=True)
    loss, metrics = TD.darkfarm_loss(model, _port_batch(case["batch"], 0),
                                     _t(case["anchors"]),
                                     uniforms=case["uniforms"])
    return loss, {k: v.item() for k, v in metrics.items()}


def test_darkfarm_loss_with_aggregator_matches_jax(case):
    """The loss, every metric (``loss_l1_0_u`` and ``loss_l1_0_d`` among
    them) and every gradient leaf, the aggregator's included."""
    model = case["tmodel"]
    loss, metrics = _port_loss(model, case)
    loss.backward()
    assert set(metrics) == set(case["metrics"])
    assert {"loss_l1_0_u", "loss_l1_0_d"} <= set(metrics)
    for k, v in case["metrics"].items():
        np.testing.assert_allclose(metrics[k], v, rtol=LOSS_RTOL, err_msg=k)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    want = case["grads"]
    assert set(grads) == set(want)
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(
            grads[name].numpy(), w.numpy(), rtol=0,
            atol=max(GRAD_REL_ATOL * float(w.abs().max()), floor),
            err_msg=name)
    agg = [n for n in want if n.startswith("aggregator.")]
    assert len(agg) == 36  # conv1, 2 RDBs (8 each), the TAF (16), conv2
    for name in ("aggregator.stage0_taf.dcn_pack.weight",
                 "aggregator.stage0_taf.dcn_pack.conv_offset.weight",
                 "aggregator.stage0_conv2.weight",
                 "aggregator.stage0_rdb1.lff.weight"):
        assert float(want[name].abs().max()) > 1e3 * floor, name
    frozen = [n for n in grads if n.startswith(FROZEN)]
    assert frozen and all(not grads[n].any() for n in frozen)


def test_the_drawn_offsets_are_fractional_and_reach_outside(case):
    """The drawn ``conv_offset`` gives fractional offsets of up to a few
    px, some samples beyond the 4 x 4 stage-3 map."""
    model = case["tmodel"]
    seen = []
    pack = model.aggregator.stage0_taf.dcn_pack
    handle = pack.conv_offset.register_forward_hook(
        lambda m, i, o: seen.append(o.detach().reshape(
            o.shape[0], pack.groups, 27, *o.shape[2:])[:, :, :18]))
    with torch.no_grad():
        _port_loss(model, case)
    handle.remove()
    off = torch.cat([s.flatten() for s in seen])
    frac = off - off.floor()
    assert ((frac > 0.05) & (frac < 0.95)).float().mean() > 0.8
    assert 0.3 < off.abs().max().item() < 20
    assert (off.abs() > 1.0).any()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variants_metrics_match_jax(case, name):
    """``dual_branch`` 'u' or 'd' with the RDBs or the TAF left out: the
    loss and every metric against JAX (forward only), and the feature
    losses reported are the branch's."""
    kw = VARIANTS[name]
    jcfg, tcfg = _configs(**kw)
    jmodel = JD.SelsaDarkfarmDetector(cfg=jcfg)
    params = _without(case["params"], "_rdb" if not kw.get("agg_rdb", True)
                      else "_taf")
    _, want = jax.jit(lambda p: _jax_loss_stopped(
        jmodel, p, _sample(case["batch"], 0), case["key"],
        jnp.asarray(case["anchors"])))(params)
    tmodel = TD.SelsaDarkfarmDetector(tcfg)
    tmodel.load_state_dict(from_jax_variables(params), strict=True)
    with torch.no_grad():
        _, metrics = _port_loss(tmodel, case)
    assert set(metrics) == set(want)
    assert {k for k in metrics if k.startswith("loss_l1_")} == {
        f"loss_l1_0_{kw['dual_branch']}"}
    for k, v in want.items():
        np.testing.assert_allclose(metrics[k], np.asarray(v), rtol=LOSS_RTOL,
                                   err_msg=k)


def test_frozen_mask_with_the_aggregator_matches_jax(case):
    """The optimizer's mask: the cleaner and the detector's stem and stage
    1 frozen, every aggregator leaf trainable (``stage0_conv1`` is not
    ``backbone/conv1``), as the JAX ``frozen_mask``."""
    params = case["params"]["params"]
    mask = jtrain.frozen_mask(params)
    want = grads_from_jax(jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32), mask,
        params))
    got = ttrain.make_optimizer(case["tmodel"]).trainable
    assert set(got) == set(want)
    for n, trainable in got.items():
        assert trainable == bool(want[n].all()), n
        if n.startswith("aggregator."):
            assert trainable, n


def test_bridge_consumes_every_leaf_once(case):
    """Every leaf of the JAX ``SelsaNewDarkfarmDetect`` tree maps to one
    port entry and every port entry has one, for the test's config and for
    the canonical one (stages (0, 1, 2, 3, 3): the four-stage aggregator,
    shapes only); the DCN's raw ``weight`` becomes OIHW; an unknown leaf,
    or a raw ``weight`` outside a ``dcn_pack``, still raises."""
    params = case["params"]
    sd = from_jax_variables(params)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(sd) == n_leaves
    assert set(sd) == set(case["tmodel"].state_dict())
    canon = dict(AGG, out_indices=(0, 1, 2, 3, 3))
    jmodel = JD.SelsaDarkfarmDetector(cfg=JD.DarkfarmConfig(
        selsa=JS.SelsaConfig(**canon), with_aggregator=True))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 6)))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                   shapes)
    with torch.device("meta"):
        tmodel = TD.SelsaDarkfarmDetector(TD.DarkfarmConfig(
            selsa=TS.SelsaConfig(**canon), with_aggregator=True))
    want = {n: tuple(t.shape) for n, t in tmodel.state_dict().items()}
    got = {n: tuple(t.shape) for n, t in from_jax_variables(zeros).items()}
    assert len(got) == len(jax.tree_util.tree_leaves(zeros))
    assert got == want
    assert sum(n.startswith("aggregator.stage3_") for n in got) > 30
    raw = params["params"]["aggregator"]["stage0_taf"]["dcn_pack"]["weight"]
    np.testing.assert_array_equal(
        sd["aggregator.stage0_taf.dcn_pack.weight"].numpy(),
        np.asarray(raw).transpose(3, 2, 0, 1))
    for bad in ({"dcn_pack": {"offset": np.zeros((3, 3, 4, 4))}},
                {"conv2": {"weight": np.zeros((3, 3, 4, 4))}},
                {"dcn_pack": {"weight": np.zeros((4, 4))}}):
        with pytest.raises(KeyError, match="unconsumed leaf"):
            from_jax_variables({"params": {"aggregator": bad}})


def test_init_model_streams_without_the_aggregator(case):
    """F7: a state dict of the model with the aggregator streams through
    ``init_model`` as the detector alone (its ``selsa.`` entries; the
    aggregator's and the cleaner's are dropped, as the JAX streaming step
    never calls ``denoise_feats``): the same detections as the state dict
    without ``aggregator.`` entries."""
    sd = case["tmodel"].state_dict()
    assert any(k.startswith("aggregator.") for k in sd)
    plain = {k: v for k, v in sd.items() if not k.startswith("aggregator.")}
    kw = {k: v for k, v in AGG.items() if k != "out_indices"}
    pairs = case["batch"].pair_imgs[0]
    runs = []
    for state in (sd, plain):
        m = init_model(state_dict=state, device="cpu",
                       compute_dtype=torch.float32, **kw)
        runs.append([m.inference_vid_prepared(
            pairs[t], frame_id=t, ref_imgs=None if t else pairs[1:])
            ["bbox_results"] for t in range(2)])
    for a, b in zip(*runs):
        assert len(a) == 4
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_fresh_model_starts_from_a_plain_conv():
    """``make_darkfarm`` with a generator: every ``conv_offset`` zero (the
    aggregator starts with its DCNs as half plain convs), the DCN weights
    uniform within flax's variance_scaling bound, its biases zero."""
    model, _ = TD.make_darkfarm(_configs()[1],
                                torch.Generator().manual_seed(0),
                                device="cpu")
    pack = model.aggregator.stage0_taf.dcn_pack
    assert not pack.conv_offset.weight.any()
    assert not pack.conv_offset.bias.any() and not pack.bias.any()
    limit = np.sqrt(3.0 / (9 * 512))
    assert 0.9 * limit < pack.weight.abs().max().item() <= limit
    assert model.aggregator.stage0_conv1.weight.std().item() > 0
