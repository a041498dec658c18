"""Port parity for TemporalRoIAlign, the 3-FC SELSA head and the temporal
streaming path, against the JAX package on the CPU in f32.

- ``TemporalRoIAlign`` (most-similar RoI align and temporal attention) with
  4 attention blocks and with none (the mean), forward and the gradients
  with respect to the roi features, the reference maps and the embed conv,
  to 1e-5 (forward rtol and atol; gradients atol 1e-5 of the largest |g| of
  each); with a stream axis against ``jax.vmap``; ``ref_feats=None`` passes
  the features through.
- The Shared2FC head with 3 shared FCs: joint forward, ``ref_transform_kv``
  and ``forward_cached_stream_kv``, 1e-4 (as ``test_torch_port_modules``).
- The temporal streaming path at a tiny SELSA (R50-DC5 at full depth, 64x64
  bucket, neck 32, 2 reference frames, RPN NMS 64/8, 3 classes,
  ``roi_extractor="temporal"``, ``num_shared_fcs=3``): memos with their
  reference maps from the JAX ``init_video_state``, 3 frames that roll the
  memo on every frame, one stream (``inference_clip`` / ``inference_step``)
  and a batch of 2 (``inference_clip_batch``, the vmap of the JAX step;
  ``make_serve_step``), at the tolerances of ``test_torch_port_serve.py``:
  detections equal as sets (boxes 5e-3 px, scores 1e-5), memo K/V and maps
  to 1e-4, validity and slots exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_tpu.models.roi_heads.bbox_head import (  # noqa: E501
    Shared2FCBBoxHead as JaxBBoxHead,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.roi_heads.temporal_roi_align import (  # noqa: E501
    TemporalRoIAlign as JaxTROI,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.vid import (
    selsa as JS,
)
from lowlightenvironmentvideoobjectdetection_torch.core.nms import DetResult
from lowlightenvironmentvideoobjectdetection_torch.models.roi_heads.bbox_head import (  # noqa: E501
    Shared2FCBBoxHead,
)
from lowlightenvironmentvideoobjectdetection_torch.models.roi_heads.temporal_roi_align import (  # noqa: E501
    TemporalRoIAlign,
)
from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
    selsa as TS,
)
from lowlightenvironmentvideoobjectdetection_torch.parallel.serve import (
    make_serve_step,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
    video_state_from_jax,
)
from torch_port_threads import thread_count

TROI_TOL = 1e-5
HEAD_TOL = 1e-4
TINY = dict(pad_h=64, pad_w=64, test_nms_pre=64, test_nms_post=8,
            num_ref_frames=2, num_classes=3, neck_channels=32,
            roi_extractor="temporal", num_shared_fcs=3)
S, T = 2, 3
IMG_SHAPES = np.array([[60.0, 60.0], [52.0, 64.0]], np.float32)
SCALE_FACTORS = np.array([[1.0] * 4, [0.5] * 4], np.float32)


_pinned_threads = thread_count(1)


def _perturbed(variables, seed):
    """numpy copy of a flax variable tree with every leaf jittered; BN
    variances stay positive."""
    rng = np.random.RandomState(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        name = str(path[-1].key)
        if name == "var":
            return (x * rng.uniform(0.5, 2.0, x.shape)).astype(np.float32)
        scale = 0.05 if name in ("bias", "mean") else 0.1 * np.abs(x).mean()
        return (x + rng.randn(*x.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, variables)


def _close_grad(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TROI_TOL * float(np.abs(want).max()),
                               err_msg=err_msg)


# ---- TemporalRoIAlign


def _troi_inputs(seed, lead=()):
    rng = np.random.RandomState(seed)
    roi = rng.randn(*lead, 5, 7, 7, 16).astype(np.float32)
    ref = rng.randn(*lead, 3, 9, 11, 16).astype(np.float32)
    cot = rng.randn(*lead, 5, 7, 7, 16).astype(np.float32)
    return roi, ref, cot


def _troi_pair(nb, seed):
    jm = JaxTROI(out_channels=16, num_most_similar_points=2,
                 num_temporal_attention_blocks=nb)
    roi, ref, _ = _troi_inputs(seed)
    v = _perturbed(jm.init(jax.random.PRNGKey(seed), jnp.asarray(roi),
                           jnp.asarray(ref)), seed)
    tm = TemporalRoIAlign(16, 2, nb)
    tm.load_state_dict(from_jax_variables(v), strict=True)
    return jm, v, tm


@pytest.mark.parametrize("nb", [4, 0])
def test_troi_forward_and_gradients_match_jax(nb):
    jm, v, tm = _troi_pair(nb, nb + 1)
    roi, ref, cot = _troi_inputs(nb + 10)

    def f(variables, r, m):
        return jnp.sum(jm.apply(variables, r, m) * cot)

    want = jax.jit(jm.apply)(v, jnp.asarray(roi), jnp.asarray(ref))
    gv, groi, gref = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        v, jnp.asarray(roi), jnp.asarray(ref))
    troi = torch.from_numpy(roi).requires_grad_()
    tref = torch.from_numpy(ref).requires_grad_()
    got = tm(troi, tref)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TROI_TOL, atol=TROI_TOL)
    # the maps' gradient comes through the gather and the top-k softmax, the
    # rois' through the similarity and the attention
    assert float(np.abs(np.asarray(gref)).max()) > 0
    _close_grad(troi.grad, groi, "rois")
    _close_grad(tref.grad, gref, "maps")
    if nb:
        pgrads = from_jax_variables({"params": jax.tree.map(np.asarray,
                                                            gv["params"])})
        for name, p in tm.named_parameters():
            _close_grad(p.grad, pgrads[name], name)
    else:
        assert not list(tm.parameters())


def test_troi_stream_axis_matches_vmap():
    jm, v, tm = _troi_pair(4, 3)
    roi, ref, _ = _troi_inputs(4, lead=(2,))
    want = jax.vmap(lambda r, m: jm.apply(v, r, m))(jnp.asarray(roi),
                                                    jnp.asarray(ref))
    with torch.no_grad():
        got = tm(torch.from_numpy(roi), torch.from_numpy(ref))
    assert got.shape == roi.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TROI_TOL,
                               atol=TROI_TOL)


def test_troi_without_reference_maps_passes_through():
    roi = torch.randn(3, 7, 7, 16)
    assert TemporalRoIAlign(16)(roi, None) is roi


# ---- the 3-FC head


def test_three_fc_head_matches_jax():
    rng = np.random.RandomState(7)
    n, m, c, ncls = 8, 24, 16, 5
    x = (rng.randn(n, 7, 7, c) * 0.5).astype(np.float32)
    ref = (rng.randn(m, 7, 7, c) * 0.5).astype(np.float32)
    ref_mask = rng.rand(m) > 0.2
    self_mask = rng.rand(n) > 0.2
    jh = JaxBBoxHead(num_classes=ncls, num_shared_fcs=3, with_selsa=True,
                     dtype=jnp.float32)
    v = _perturbed(jax.jit(jh.init)(jax.random.PRNGKey(4), jnp.asarray(x),
                                    jnp.asarray(ref)), 8)
    assert "shared_fc2" in v["params"] and "aggregator2" in v["params"]

    @jax.jit
    def run(v, x, ref, ref_mask, self_mask):
        kvs = jh.apply(v, ref, method=JaxBBoxHead.ref_transform_kv)
        return jh.apply(v, x, ref, ref_mask), kvs, jh.apply(
            v, x, kvs, ref_mask, self_mask,
            method=JaxBBoxHead.forward_cached_stream_kv)

    (wc, wr), kvs, ((sc, sr), skv) = run(
        v, jnp.asarray(x), jnp.asarray(ref), jnp.asarray(ref_mask),
        jnp.asarray(self_mask))

    th = Shared2FCBBoxHead(7 * 7 * c, ncls, num_shared_fcs=3)
    th.load_state_dict(from_jax_variables(v), strict=True)
    with torch.no_grad():
        gc, gr = th(torch.from_numpy(x), torch.from_numpy(ref),
                    torch.from_numpy(ref_mask))
        tkvs = th.ref_transform_kv(torch.from_numpy(ref))
        (tc, tr), tkv = th.forward_cached_stream_kv(
            torch.from_numpy(x), tkvs, torch.from_numpy(ref_mask),
            torch.from_numpy(self_mask))
    assert len(tkvs) == len(tkv) == 3
    pairs = [(gc, wc), (gr, wr), (tc, sc), (tr, sr)]
    pairs += [(a, b) for (ta, tb), (ja, jb) in zip(tkvs + tkv, kvs + skv)
              for a, b in ((ta, ja), (tb, jb))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=HEAD_TOL, atol=HEAD_TOL)


# ---- temporal streaming


@pytest.fixture(scope="module")
def system():
    """Both packages' tiny temporal SELSA with the same weights, per-stream
    memos with their maps from the JAX ``init_video_state``, and the JAX
    results of the 3 frames rolled every frame: ``inference_clip`` for
    stream 0 and ``inference_clip_batch`` for both."""
    jcfg = JS.SelsaConfig(compute_dtype=jnp.float32, **TINY)
    jmodel = JS.SelsaDetector(cfg=jcfg)
    params = _perturbed(JS.init_params(jmodel, jax.random.PRNGKey(0),
                                       small=True), 0)
    tmodel = TS.SelsaDetector(TS.SelsaConfig(compute_dtype=torch.float32,
                                             **TINY))
    tmodel.load_state_dict(from_jax_variables(params), strict=True)
    rng = np.random.RandomState(0)
    refs = rng.uniform(-2, 2, (S, 2, 64, 64, 3)).astype(np.float32)
    frames = rng.uniform(-2, 2, (S, T, 64, 64, 3)).astype(np.float32)
    janchors = JS.make_anchors(jcfg)
    fill = jax.jit(lambda r, shape: JS.init_video_state(jmodel, params, r,
                                                         shape, janchors))
    jstates = [fill(jnp.asarray(refs[s]), jnp.asarray(IMG_SHAPES[s]))
               for s in range(S)]
    jbatch = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *jstates)
    one = jax.jit(lambda st, fr: JS.inference_clip(
        jmodel, params, st, fr, jnp.asarray(IMG_SHAPES[0]),
        jnp.asarray(SCALE_FACTORS[0]), janchors, update_memo=True))
    batch = jax.jit(lambda st, fr: JS.inference_clip_batch(
        jmodel, params, st, fr, jnp.asarray(IMG_SHAPES),
        jnp.asarray(SCALE_FACTORS), janchors, update_memo=True))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(jcfg=jcfg, tmodel=tmodel.eval(), frames=frames,
                tanchors=TS.make_anchors(tmodel.cfg),
                jstates=[to_np(s) for s in jstates], jbatch=to_np(jbatch),
                jone=to_np(one(jstates[0], jnp.asarray(frames[0]))),
                jout=to_np(batch(jbatch, jnp.asarray(frames))))


def _same_dets(t, j, box_tol=5e-3, score_tol=1e-5):
    """Equal detection sets: near-equal scores may sort differently."""
    jv, tv = np.asarray(j.valid), t.valid.numpy()
    assert tv.sum() == jv.sum() > 0
    jrows = list(zip(np.asarray(j.labels)[jv], np.asarray(j.boxes)[jv],
                     np.asarray(j.scores)[jv]))
    trows = list(zip(t.labels.numpy()[tv], t.boxes.numpy()[tv],
                     t.scores.numpy()[tv]))
    for lab, box, score in jrows:
        hits = [i for i, (tl, tb, ts) in enumerate(trows)
                if tl == lab and np.abs(tb - box).max() < box_tol
                and abs(ts - score) < score_tol]
        assert hits, (lab, box, score)
        trows.pop(hits[0])


def _frame(dets, *idx):
    return DetResult(*(np.asarray(f)[idx] if not torch.is_tensor(f)
                       else f[idx] for f in dets))


def _same_state(t, j, atol=1e-4):
    np.testing.assert_array_equal(t.ref_valid.numpy(), np.asarray(j.ref_valid))
    np.testing.assert_array_equal(np.asarray(t.next_slot),
                                  np.asarray(j.next_slot))
    pairs = [(t.ref_maps, j.ref_maps)]
    pairs += [(a, b) for (tk, tv), (jk, jv) in zip(t.ref_kv, j.ref_kv)
              for a, b in ((tk, jk), (tv, jv))]
    assert len(t.ref_kv) == len(j.ref_kv) == 3
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=atol,
                                   atol=atol)


def test_bridged_state_carries_the_maps(system):
    one = video_state_from_jax(system["jstates"][1])
    batch = video_state_from_jax(system["jbatch"])
    assert one.next_slot == 0 and one.ref_maps.shape == (2, 4, 4, 32)
    assert batch.ref_maps.shape == (S, 2, 4, 4, 32)
    assert batch.next_slot.tolist() == [0, 0]
    np.testing.assert_array_equal(batch.ref_maps[1].numpy(),
                                  one.ref_maps.numpy())
    st = TS.stack_video_states([one, one])
    assert torch.equal(st.ref_maps[0], one.ref_maps)
    copy = TS.copy_video_state(st)
    copy.ref_maps.zero_()
    assert st.ref_maps.abs().sum() > 0


def test_init_video_state_keeps_the_maps(system):
    """The port's own memo fill gives the JAX memo, maps included."""
    rng = np.random.RandomState(0)  # the fixture's reference frames
    refs = rng.uniform(-2, 2, (S, 2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        st = TS.init_video_state(system["tmodel"], torch.from_numpy(refs[0]),
                                 torch.from_numpy(IMG_SHAPES[0]),
                                 system["tanchors"])
    _same_state(st, system["jstates"][0])


def test_single_stream_matches_jax(system):
    """3 frames of stream 0, each rolling the memo, through the port's
    ``inference_clip`` and its own ``inference_step`` loop."""
    jstate, jdets = system["jone"]
    frames = torch.from_numpy(system["frames"][0])
    shape, sf = torch.from_numpy(IMG_SHAPES[0]), torch.from_numpy(
        SCALE_FACTORS[0])
    st, dets = TS.inference_clip(system["tmodel"],
                                 video_state_from_jax(system["jstates"][0]),
                                 frames, shape, sf, system["tanchors"],
                                 update_memo=True)
    for t in range(T):
        _same_dets(_frame(dets, t), _frame(jdets, t))
    _same_state(st, jstate)
    one = video_state_from_jax(system["jstates"][0])
    for t in range(T):
        one, d = TS.inference_step(system["tmodel"], one, frames[t], shape,
                                   sf, system["tanchors"], update_memo=True)
        _same_dets(d, _frame(jdets, t))
    _same_state(one, jstate)


def test_batch_of_two_streams_matches_vmap(system):
    jstates, jdets = system["jout"]
    frames = torch.from_numpy(system["frames"])
    states = video_state_from_jax(system["jbatch"])
    st, dets = TS.inference_clip_batch(
        system["tmodel"], states, frames, torch.from_numpy(IMG_SHAPES),
        torch.from_numpy(SCALE_FACTORS), system["tanchors"], update_memo=True)
    for s in range(S):
        for t in range(T):
            _same_dets(_frame(dets, s, t), _frame(jdets, s, t))
    _same_state(st, jstates)
    _same_state(states, system["jbatch"], atol=0)  # the input is intact


def test_serve_step_per_frame_matches_vmap(system):
    """``make_serve_step`` per frame, its states moved by ``shard_args``
    (maps included) from numpy."""
    jstates, jdets = system["jout"]
    step, shard_args = make_serve_step(system["tmodel"], clip=False,
                                       update_memo=True)
    st = jax.tree.map(np.array, system["jbatch"])  # writable copies
    for t in range(T):
        args = shard_args(np.asarray(system["tanchors"]), st,
                          system["frames"][:, t], IMG_SHAPES, SCALE_FACTORS)
        st, dets = step(*args)
        for s in range(S):
            _same_dets(_frame(dets, s), _frame(jdets, s, t))
    _same_state(st, jstates)


def test_empty_video_state_follows_the_config(system):
    """The port's empty memo has one K/V stage per shared FC; JAX's has two
    whatever the config (ROADMAP fault F8), so the JAX 3-FC step cannot
    run on it. Neither holds reference maps."""
    tcfg = system["tmodel"].cfg
    st = TS.empty_video_state(tcfg, device="cpu")
    assert len(st.ref_kv) == 3 and st.ref_maps is None
    jst = JS.empty_video_state(system["jcfg"])
    assert len(jst.ref_kv) == 2 and jst.ref_maps is None
