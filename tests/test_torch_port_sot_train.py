"""SiamRPN++ training in the port against the JAX package on the CPU, f32:

- ``siamrpn_loss`` (R50 at the CLI's tiny crops, 64 / 128, N(0, 1)
  pixels, variables drawn in the JAX model's shapes and bridged) on a
  positive and a
  negative pair: the loss terms to 1e-5 relative and every gradient leaf
  to 1e-4 of its largest value, with JAX's two ``jax.random.uniform``
  draws fed to the port;
- the SOT augmentations on uint8 frames, each step seeded alike on both
  sides (Python's ``random`` and numpy's global generator for JAX, a
  ``random.Random`` and an ``np.random.RandomState`` for the port):
  ``SeqCropLikeSiamFC`` (inside the frame and over its edge),
  ``SeqShiftScaleAug``, ``SeqColorAug``, ``SeqBlurAug``: equal images and
  boxes; the box blur against ``cv2.blur``;
- ``SOTTrainDataset.sample_pair`` at three negative-pair ratios: the same
  pairs over 30 draws;
- ``make_sot_lr_schedule`` and ``unfreeze_mask_at_epoch`` (and the
  optimizer mask ``sot_trainable``);
- the ReID head's classifier branch: the logits and the embedding of the
  bridged ``BaseReID`` (``num_classes`` > 0, ``train=True``).
"""

import random

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_dark_backbones import draw
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.data import (
    mot_sot_datasets as TD,
)
from lowlightenvironmentvideoobjectdetection_torch.data.pipelines import (
    transforms as TT,
)
from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
    write_lasot_tree,
)
from lowlightenvironmentvideoobjectdetection_torch.models.reid import (
    base_reid as TR,
)
from lowlightenvironmentvideoobjectdetection_torch.models.sot import (
    siamrpn as TS,
)
from lowlightenvironmentvideoobjectdetection_torch.parallel import (
    train as ttrain,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
    grads_from_jax,
)
from lowlightenvironmentvideoobjectdetection_tpu.data import (
    mot_sot_datasets as JD,
)
from lowlightenvironmentvideoobjectdetection_tpu.data.pipelines import (
    transforms as JT,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.reid import (
    base_reid as JR,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.sot import (
    siamrpn as JS,
)
from lowlightenvironmentvideoobjectdetection_tpu.parallel import (
    train as jtrain,
)

TINY = dict(exemplar_size=64, search_size=128)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
FEAT_TOL = 1e-4


_pinned_threads = thread_count(1)


@pytest.fixture(scope="module")
def siam():
    torch.set_num_threads(1)
    cfg = JS.SiamRPNConfig(**TINY)
    jm = JS.SiamRPN(cfg=cfg)
    z = jnp.zeros((1, 64, 64, 3))
    x = jnp.zeros((1, 128, 128, 3))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), z, x)
    var = jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(7)))
    tm = TS.SiamRPN(TS.SiamRPNConfig(**TINY))
    tm.load_state_dict(from_jax_variables(var), strict=True)
    n = tm.cfg.score_size
    return dict(jm=jm, var=var, tm=tm, cfg=cfg,
                anchors=TS.sot_grid_anchors(tm.cfg, n))


@pytest.mark.parametrize("positive", [True, False], ids=["pos", "neg"])
def test_siamrpn_loss_and_gradients_match_jax(siam, positive):
    rs = np.random.RandomState(3)
    z = rs.randn(1, 64, 64, 3).astype(np.float32)
    x = rs.randn(1, 128, 128, 3).astype(np.float32)
    gt = np.array([3.0, -2.0, 50.0, 70.0], np.float32)
    key = jax.random.PRNGKey(11)
    anchors = jnp.asarray(siam["anchors"])

    def jloss(v):
        return JS.siamrpn_loss(siam["jm"], v, jnp.asarray(z), jnp.asarray(x),
                               jnp.asarray(gt), anchors,
                               jnp.asarray(positive), rng=key)

    # eager: op-by-op rounding stays nearer the port's through R50
    (jtotal, jm), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        siam["var"])
    r1, r2 = jax.random.split(key)
    n = anchors.shape[0]
    u = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (n,)))
                                   for k in (r1, r2)]))
    tm = siam["tm"]
    tm.zero_grad()
    total, metrics = TS.siamrpn_loss(
        tm, torch.from_numpy(z), torch.from_numpy(x), gt,
        torch.from_numpy(siam["anchors"]), positive, u)
    total.backward()
    for k in ("loss", "loss_rpn_cls", "loss_rpn_bbox"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    if positive:
        assert float(metrics["loss_rpn_bbox"].detach()) > 0
    want = grads_from_jax(jgrads["params"])
    params = dict(tm.named_parameters())
    top = max(float(np.abs(g.numpy()).max()) for g in want.values())
    for name, w in want.items():
        g = params[name].grad
        scale = float(np.abs(w.numpy()).max())
        if g is None:  # a frozen stage: no gradient in the port
            assert scale == 0.0, name
            continue
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=0,
            atol=max(GRAD_REL * scale, 1e-6 * top), err_msg=name)


def _frame(seed, hw=(90, 120)):
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, hw + (3,)).astype(np.uint8)
    return img


def _results(boxes):
    return [dict(img=_frame(i), gt_bboxes=np.asarray([b], np.float32),
                 img_shape=(90, 120)) for i, b in enumerate(boxes)]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["img"].dtype == w["img"].dtype
        np.testing.assert_array_equal(g["img"], w["img"])
        np.testing.assert_array_equal(g["gt_bboxes"], w["gt_bboxes"])
        assert tuple(g["img_shape"]) == tuple(w["img_shape"])


def _both(jstep, tstep, frames_fn, seed, np_rng=False):
    random.seed(seed)
    np.random.seed(seed + 1)
    want = jstep(frames_fn())
    kw = {}
    if np_rng:
        kw["np_rng"] = np.random.RandomState(seed + 1)
    got = tstep(frames_fn(), random.Random(seed), **kw)
    _same(got, want)
    return got


@pytest.mark.parametrize("boxes", [
    [(30.0, 20.0, 70.0, 60.0), (40.0, 25.0, 75.0, 70.0)],
    [(-5.5, 60.2, 40.0, 89.0), (100.3, 0.0, 119.0, 30.7)],
], ids=["inside", "over_the_edge"])
def test_crop_like_siamfc_matches_jax(boxes):
    jstep = JT.SeqCropLikeSiamFC(0.5, 64, 257)
    tstep = TT.SeqCropLikeSiamFC(0.5, 64, 257)
    got = _both(lambda r: jstep(r), lambda r, rng: tstep(r, rng),
                lambda: _results(boxes), 0)
    assert got[0]["img"].shape == (257, 257, 3)


@pytest.mark.parametrize("step", ["shift_scale", "color", "blur"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sot_augmentations_match_jax(step, seed):
    def crops():  # as SeqCropLikeSiamFC gives them: uint8 squares
        return TT.SeqCropLikeSiamFC(0.5, 64, 257)(_results(
            [(30.0, 20.0, 70.0, 60.0), (40.0, 25.0, 75.0, 70.0)]))

    if step == "shift_scale":
        j, t = (m.SeqShiftScaleAug((64, 128)) for m in (JT, TT))
        got = _both(j, t, crops, seed)
        assert [g["img"].shape[0] for g in got] == [64, 128]
    elif step == "color":
        j, t = (m.SeqColorAug((1.0, 0.5)) for m in (JT, TT))
        _both(j, t, crops, seed, np_rng=True)
    else:
        def colored():
            r = crops()
            r[1]["img"] = r[1]["img"].astype(np.float32) * 0.7
            return r
        j, t = (m.SeqBlurAug((1.0, 1.0)) for m in (JT, TT))
        _both(j, t, colored, seed)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_box_blur_is_cv2_blur(dtype):
    img = np.random.RandomState(4).uniform(0, 255, (31, 45, 3)).astype(dtype)
    for k in (3, 5, 7):
        np.testing.assert_array_equal(TT.box_blur(img, k),
                                      cv2.blur(img, (k, k)))


@pytest.fixture(scope="module")
def lasot(tmp_path_factory):
    root = tmp_path_factory.mktemp("sot_pairs")
    return write_lasot_tree(str(root), videos=3, frames=8, hw=(48, 64),
                            seed=2)


@pytest.mark.parametrize("ratio", [0.0, 0.2, 1.0])
def test_sample_pair_matches_jax(lasot, ratio):
    kw = dict(ann_file=lasot, max_frame_range=3, neg_pair_ratio=ratio)
    jds, tds = JD.SOTTrainDataset(**kw), TD.SOTTrainDataset(**kw)
    random.seed(5)
    rng = random.Random(5)
    kinds = set()
    for i in range(30):
        idx = i % len(jds.data_infos)
        jt, js, jp = jds.sample_pair(idx)
        tt, ts, tp = tds.sample_pair(idx, rng)
        assert jp == tp
        kinds.add(tp)
        for a, b in ((jt, tt), (js, ts)):
            assert a["img_info"]["id"] == b["img_info"]["id"]
            np.testing.assert_array_equal(a["ann"]["bboxes"],
                                          b["ann"]["bboxes"])
    assert kinds == ({True} if ratio == 0.0 else {True, False})


def test_sot_schedule_matches_jax():
    kw = dict(base_lr=0.005, warmup_epochs=2, total_epochs=6,
              iters_per_epoch=100)
    want = jtrain.make_sot_lr_schedule(**kw)
    got = ttrain.make_sot_lr_schedule(**kw)
    for count in (0, 1, 50, 199, 200, 201, 350, 599, 600, 700):
        np.testing.assert_allclose(got(count), np.asarray(want(count)),
                                   rtol=1e-6, err_msg=str(count))
    assert got(0) == np.float32(0.005) * np.float32(0.2)


@pytest.mark.parametrize("epoch", [0, 9, 10])
def test_unfreeze_mask_matches_jax(siam, epoch):
    params = siam["var"]["params"]
    want = jtrain.unfreeze_mask_at_epoch(params, epoch=epoch,
                                         unfreeze_epoch=10)
    as_leaves = jax.tree_util.tree_map(  # the mask in each leaf's shape
        lambda m, p: np.full(p.shape, float(m), np.float32), want, params)
    want = {k: bool(v.all()) for k, v in grads_from_jax(as_leaves).items()}
    names = [n for n, _ in siam["tm"].named_parameters()]
    got = ttrain.unfreeze_mask_at_epoch(names, epoch, unfreeze_epoch=10)
    assert got == {n: want[n] for n in names}
    assert any(got.values()) and (all(got.values()) == (epoch >= 10))
    both = ttrain.sot_trainable(names, epoch, unfreeze_epoch=10)
    frozen = ttrain.frozen_mask(names)
    assert both == {n: got[n] and frozen[n] for n in names}


def test_reid_classifier_logits_match_jax():
    torch.set_num_threads(1)
    jm = JR.BaseReID(num_classes=12, dtype=jnp.float32)
    crops = np.random.RandomState(6).randn(3, 64, 32, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, train=True),
                            jax.random.PRNGKey(0), jnp.asarray(crops))
    var = jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(8)))
    jembed, jlogits = jm.apply(var, jnp.asarray(crops), train=True)
    tm = TR.BaseReID(num_classes=12, dtype=torch.float32)
    tm.load_state_dict(from_jax_variables(var), strict=True)
    assert "head.classifier.weight" in dict(tm.named_parameters())
    with torch.no_grad():
        embed, logits = tm(torch.from_numpy(crops), train=True)
        alone = tm(torch.from_numpy(crops))
    for g, w in ((embed, jembed), (logits, jlogits), (alone, jembed)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=FEAT_TOL,
                                   atol=FEAT_TOL * np.abs(w).max())
