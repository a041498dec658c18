"""SiamRPN++ (``models/sot/siamrpn.py``, ``apis/inference.py`` ``SOTModel``)
against the JAX package on the CPU, f32, at the CLI's ``--tiny`` crops
(exemplar 64, search 128), variables drawn in the JAX model's shapes and
bridged (the LayerNorms' scale and bias, the bias-free convs, the root
``cls_weights`` / ``reg_weights``):

- ``depthwise_correlation`` and a ``CorrelationHead`` to 1e-5 of the
  output's largest value (flax's LayerNorm: per pixel over the channels,
  eps 1e-6);
- the score map's size (``SiamRPNConfig.score_size``) equals the traced
  JAX head's at 64 / 128 and 127 / 255; the anchors and the window equal;
- ``sot_init``, then 3 ``sot_track`` frames through ``SOTModel``: the same
  best anchor index each frame, boxes within 1e-3 px, scores within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_dark_backbones import draw
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
    SOTModel,
)
from lowlightenvironmentvideoobjectdetection_torch.models.sot import (
    siamrpn as TS,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.sot import (
    siamrpn as JS,
)

HEAD_REL = 1e-5
BOX_TOL = 1e-3
SCORE_TOL = 1e-5
TINY = dict(exemplar_size=64, search_size=128)


_pinned_threads = thread_count(1)


def test_depthwise_correlation_matches_jax():
    rng = np.random.default_rng(0)
    search = rng.normal(0, 1, (13, 11, 6)).astype(np.float32)
    kernel = rng.normal(0, 1, (5, 4, 6)).astype(np.float32)
    want = np.asarray(JS.depthwise_correlation(jnp.asarray(search),
                                               jnp.asarray(kernel)))
    got = TS.depthwise_correlation(torch.from_numpy(search),
                                   torch.from_numpy(kernel)).numpy()
    assert got.shape == want.shape == (9, 8, 6)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=HEAD_REL * np.abs(want).max())


def test_correlation_head_matches_jax():
    rng = np.random.default_rng(1)
    z = rng.normal(0, 1, (7, 7, 16)).astype(np.float32)
    x = rng.normal(0, 1, (20, 20, 16)).astype(np.float32)
    head = JS.CorrelationHead(16, 16, 10)
    shapes = jax.eval_shape(head.init, jax.random.PRNGKey(0),
                            jnp.asarray(z), jnp.asarray(x))
    var = jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(2)))
    want = np.asarray(head.apply(var, jnp.asarray(z), jnp.asarray(x)))
    th = TS.CorrelationHead(16, 16, 10)
    th.load_state_dict(from_jax_variables(var), strict=True)
    with torch.no_grad():
        got = th(torch.from_numpy(z), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (14, 14, 10)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=HEAD_REL * np.abs(want).max())


@pytest.mark.parametrize("sizes", [(64, 128), (127, 255)])
def test_score_size_anchors_and_window_match_jax(sizes):
    kw = dict(exemplar_size=sizes[0], search_size=sizes[1])
    jcfg, tcfg = JS.SiamRPNConfig(**kw), TS.SiamRPNConfig(**kw)
    model = JS.SiamRPN(cfg=jcfg)
    z = jnp.zeros((1, sizes[0], sizes[0], 3))
    x = jnp.zeros((1, sizes[1], sizes[1], 3))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), z, x)
    cls, reg = jax.eval_shape(lambda v: model.apply(v, z, x), shapes)
    n = tcfg.score_size
    assert cls.shape == (n, n, 2 * tcfg.num_anchors)
    assert reg.shape == (n, n, 4 * tcfg.num_anchors)
    np.testing.assert_array_equal(TS.sot_grid_anchors(tcfg, n),
                                  JS.sot_grid_anchors(jcfg, n))
    np.testing.assert_array_equal(TS.hanning_window(n, 5),
                                  JS.hanning_window(n, 5))


def _video(seed, n=4, hw=(96, 128)):
    """A textured scene and a bright square moving 3 px right and 2 px
    down a frame, with its first box."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, hw + (3,)).astype(np.float32)
    out = []
    for f in range(n):
        img = base.copy()
        y, x = 30 + 2 * f, 40 + 3 * f
        img[y:y + 24, x:x + 20] = [250.0, 220.0, 30.0]
        out.append(img)
    return out, np.array([40.0, 30.0, 60.0, 54.0], np.float32)


def test_sot_init_and_track_match_jax():
    torch.set_num_threads(1)
    cfg = JS.SiamRPNConfig(**TINY)
    jm = JS.SiamRPN(cfg=cfg)
    z = jnp.zeros((1, 64, 64, 3))
    x = jnp.zeros((1, 128, 128, 3))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), z, x)
    var = jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(3)))
    model = SOTModel(state_dict=from_jax_variables(var), device="cpu",
                     **TINY)
    n = model.cfg.score_size
    anchors = jnp.asarray(JS.sot_grid_anchors(cfg, n))
    window = jnp.asarray(JS.hanning_window(n, cfg.num_anchors))
    frames, box = _video(4)
    jstate = JS.sot_init(jm, var, jnp.asarray(frames[0]), box)
    out = model.inference_sot(frames[0], box, 0)
    np.testing.assert_array_equal(out["track_bboxes"][:4], box)
    for a, b in zip(model.state.z_feats, jstate.z_feats):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(b)).max())
    track = jax.jit(lambda v, s, im: JS.sot_track(jm, v, s, im, anchors,
                                                  window))
    best = jax.jit(lambda v, s, im: _jax_best(jm, v, s, im, anchors, window,
                                              cfg))
    for f in (1, 2, 3):
        img = jnp.asarray(frames[f])
        # the best index, from the JAX step's own penalised scores
        jstate_next, jscore, jbox = track(var, jstate, img)
        st, tscore, tbest, tbox = TS.sot_track(
            model.model, model.state, torch.from_numpy(frames[f]),
            model.anchors, model.window)
        assert int(tbest) == int(best(var, jstate, img))
        np.testing.assert_allclose(tbox.numpy(), np.asarray(jbox), rtol=0,
                                   atol=BOX_TOL)
        assert abs(float(tscore) - float(jscore)) < SCORE_TOL
        out = model.inference_sot(frames[f], None, f)
        np.testing.assert_allclose(out["track_bboxes"][:4], tbox.numpy(),
                                   rtol=0, atol=0)
        jstate = jstate_next


def _jax_best(jm, var, state, img, anchors, window, cfg):
    """The JAX step's argmax (``sot_track`` returns the box and score, not
    the index): recomputed from its pieces, as the step computes it."""
    from lowlightenvironmentvideoobjectdetection_tpu.core import boxes as B
    prev = state.bbox
    z_size = JS.exemplar_crop_size(prev, cfg.context_amount)
    x_size = z_size * cfg.search_size / cfg.exemplar_size
    scale = cfg.exemplar_size / z_size
    mean = jnp.mean(img, axis=(0, 1))
    x_crop = JS.crop_around(img, prev[:2], x_size, cfg.search_size, mean)
    xf = jm.apply(var, x_crop[None], method=JS.SiamRPN.extract_feat)
    cls, reg = jm.apply(var, state.z_feats, tuple(f[0] for f in xf),
                        method=JS.SiamRPN.forward_heads)
    n = cls.shape[0] * cls.shape[1] * cfg.num_anchors
    scores = jax.nn.softmax(cls.reshape(n, 2), axis=-1)[:, 1]
    a = anchors
    anc = jnp.stack([a[:, 0] - a[:, 2] / 2, a[:, 1] - a[:, 3] / 2,
                     a[:, 0] + a[:, 2] / 2, a[:, 1] + a[:, 3] / 2], 1)
    pred = B.delta2bbox(anc, reg.reshape(n, 4))
    pw, ph = pred[:, 2] - pred[:, 0], pred[:, 3] - pred[:, 1]

    def ssz(w, h):
        pad = (w + h) * 0.5
        return jnp.sqrt((w + pad) * (h + pad))

    s_c = ssz(pw, ph) / ssz(prev[2] * scale, prev[3] * scale)
    r_c = (prev[2] / prev[3]) / (pw / ph)
    s_c, r_c = jnp.maximum(s_c, 1 / s_c), jnp.maximum(r_c, 1 / r_c)
    penalty = jnp.exp(-(r_c * s_c - 1.0) * cfg.penalty_k)
    pscore = penalty * scores * (1 - cfg.window_influence) \
        + window * cfg.window_influence
    return jnp.argmax(pscore)
