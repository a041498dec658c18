"""Port parity for multi-stream serving and kernel C's plain version.

- One-slab SELSA attention (``selsa_fused_attention_hm``, the roi-major
  ``selsa_fused_attention``) and the stream-batched two-slab form against
  the JAX Pallas kernels in interpret mode, f32, atol 1e-5, on inputs with a
  live key in every row (the Pallas wrapper's zero padding changes
  all-masked rows; the port keeps the plain softmax there).
- ``SelsaAggregator.attend_cached`` against the JAX method, 1e-4.
- ``inference_clip_batch`` against the JAX ``inference_clip_batch`` at a
  tiny SELSA (R50-DC5 at full depth, 64x64 bucket, neck 32, 2 reference
  frames, RPN NMS 64/8, 3 classes), S = 2 streams of T = 3 frames with their own image
  shapes and scale factors, f32 on both sides, weights bridged from the JAX
  init, the memo bridged from the JAX ``init_video_state``. Tolerances as in
  ``test_torch_port_selsa.py``: proposals identical in order and validity
  (boxes to 1e-3 px), head outputs to 1e-4, detections equal as sets, memo
  to 1e-4.
- The batched path against each stream run alone, ``make_serve_step`` in
  both modes, and ``inference_clip`` leaving its caller's state intact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_tpu.models.aggregators import (
    selsa_aggregator as jagg,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.dense_heads import (
    rpn_head as jrpn,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.vid import (
    selsa as JS,
)
from lowlightenvironmentvideoobjectdetection_tpu.ops import (
    fused_attention as jfa,
)
from lowlightenvironmentvideoobjectdetection_torch.core.nms import DetResult
from lowlightenvironmentvideoobjectdetection_torch.models.aggregators import (
    selsa_aggregator as tagg,
)
from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (
    rpn_head as trpn,
)
from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
    selsa as TS,
)
from lowlightenvironmentvideoobjectdetection_torch.ops import (
    fused_attention as tfa,
)
from lowlightenvironmentvideoobjectdetection_torch.parallel.serve import (
    batched_video_state,
    make_serve_step,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
    video_state_from_jax,
)
from torch_port_threads import thread_count

ATOL = 1e-5
TINY = dict(pad_h=64, pad_w=64, test_nms_pre=64, test_nms_post=8,
            num_ref_frames=2, num_classes=3, neck_channels=32)
S, T = 2, 3
IMG_SHAPES = np.array([[60.0, 60.0], [52.0, 64.0]], np.float32)
SCALE_FACTORS = np.array([[1.0] * 4, [0.5] * 4], np.float32)


# ---- attention


_pinned_threads = thread_count(1)


def _attn(seed, n=12, m=40, nb=4, hd=64, lead=()):
    rng = np.random.RandomState(seed)
    f = lambda *s: (rng.randn(*lead, *s) * 0.5).astype(np.float32)  # noqa
    live = rng.rand(*lead, m) > 0.3
    live[..., 0] = True  # a live key in every row
    return (f(n, nb, hd), f(nb, m, hd), f(nb, m, hd),
            np.where(live, 0.0, -1e30).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("seed,n,m", [(0, 12, 40), (1, 9, 33), (2, 16, 5)])
def test_one_slab_plain_matches_pallas_interpret(seed, n, m):
    args = _attn(seed, n=n, m=m)
    want = jfa.selsa_fused_attention_hm(*map(jnp.asarray, args),
                                        interpret=True)
    got = tfa.selsa_fused_attention_hm(*_t(*args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL,
                               atol=ATOL)


def test_roi_major_wrapper_matches_pallas_interpret():
    q, k, v, b = _attn(3)
    k, v = k.transpose(1, 0, 2).copy(), v.transpose(1, 0, 2).copy()
    want = jfa.selsa_fused_attention(*map(jnp.asarray, (q, k, v, b)),
                                     interpret=True)
    got = tfa.selsa_fused_attention(*_t(q, k, v, b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL,
                               atol=ATOL)


def test_two_slab_stream_batched_matches_vmapped_pallas():
    q, k1, v1, b1 = _attn(4, lead=(3,))
    _, k2, v2, b2 = _attn(5, m=10, lead=(3,))
    args = (q, k1, v1, k2, v2, b1, b2)
    want = jax.vmap(lambda *a: jfa.selsa_fused_attention_2slab_hm(
        *a, interpret=True))(*map(jnp.asarray, args))
    got = tfa.selsa_fused_attention_2slab_hm(*_t(*args))
    assert got.shape == (3, 12, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL,
                               atol=ATOL)
    for s in range(3):  # each stream equals the single-stream call
        one = tfa.selsa_fused_attention_2slab_hm(*_t(*(a[s] for a in args)))
        np.testing.assert_allclose(got[s].numpy(), one.numpy(), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("with_mask", [True, False])
def test_attend_cached_matches_jax(with_mask):
    c, nb = 256, 4
    jmod = jagg.SelsaAggregator(in_channels=c, num_attention_blocks=nb)
    rng = np.random.RandomState(6)
    x = rng.randn(10, c).astype(np.float32)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(rng.randn(20, c).astype(np.float32)))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32)
                          + rng.randn(*a.shape).astype(np.float32) * 0.01,
                          variables)
    tmod = tagg.SelsaAggregator(c, nb)
    tmod.load_state_dict(from_jax_variables(params), strict=True)
    q, k, v, b = _attn(7, n=10, m=30, nb=nb, hd=c // nb)
    mask = b == 0.0 if with_mask else None
    want = jmod.apply(params, *map(jnp.asarray, (q, k, v)),
                      None if mask is None else jnp.asarray(mask),
                      method=jagg.SelsaAggregator.attend_cached)
    got = tmod.attend_cached(*_t(q, k, v),
                             None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


# ---- multi-stream serving


@pytest.fixture(scope="module")
def system():
    """Both packages' tiny SELSA with the same weights, per-stream memos
    from the JAX ``init_video_state``, and the JAX ``inference_clip_batch``
    results with and without the fix-stride roll."""
    jcfg = JS.SelsaConfig(compute_dtype=jnp.float32, **TINY)
    jmodel = JS.SelsaDetector(cfg=jcfg)
    params = JS.init_params(jmodel, jax.random.PRNGKey(0), small=True)
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map_with_path(  # non-trivial biases and BN
        lambda p, x: np.asarray(x) * (rng.uniform(0.8, 1.25, x.shape)
                                      if str(p[-1].key) == "var" else 1.0)
        + (rng.randn(*x.shape) * 0.02 if str(p[-1].key) in ("bias", "mean")
           else 0.0), params)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    params)
    tmodel = TS.SelsaDetector(TS.SelsaConfig(compute_dtype=torch.float32,
                                             **TINY))
    tmodel.load_state_dict(from_jax_variables(params), strict=True)
    refs = rng.uniform(-2, 2, (S, 2, 64, 64, 3)).astype(np.float32)
    frames = rng.uniform(-2, 2, (S, T, 64, 64, 3)).astype(np.float32)
    janchors = JS.make_anchors(jcfg)
    jstates = [JS.init_video_state(jmodel, params, jnp.asarray(refs[s]),
                                   jnp.asarray(IMG_SHAPES[s]), janchors)
               for s in range(S)]
    jbatch = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *jstates)
    clip = jax.jit(lambda st, fr, update_memo: JS.inference_clip_batch(
        jmodel, params, st, fr, jnp.asarray(IMG_SHAPES),
        jnp.asarray(SCALE_FACTORS), janchors, update_memo=update_memo,
        frame_stride=2), static_argnums=2)
    jout = {u: jax.tree.map(np.asarray, clip(jbatch, jnp.asarray(frames), u))
            for u in (False, True)}
    return dict(jmodel=jmodel, params=params, tmodel=tmodel.eval(),
                frames=frames, janchors=janchors,
                tanchors=TS.make_anchors(tmodel.cfg), jstates=jstates,
                jbatch=jax.tree.map(np.asarray, jbatch), jout=jout)


def _states(system):
    """A fresh port copy of the batched JAX memo."""
    return video_state_from_jax(system["jbatch"])


def _inputs(system):
    return (torch.from_numpy(system["frames"]), torch.from_numpy(IMG_SHAPES),
            torch.from_numpy(SCALE_FACTORS))


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


def _frame(dets, s, t):
    return type(dets)(*(np.asarray(f)[s, t] if not torch.is_tensor(f)
                        else f[s, t] for f in dets))


def _same_state(t, j, atol=1e-4):
    np.testing.assert_array_equal(t.ref_valid.numpy(), np.asarray(j.ref_valid))
    np.testing.assert_array_equal(np.asarray(t.next_slot),
                                  np.asarray(j.next_slot))
    for (tk, tv), (jk, jv) in zip(t.ref_kv, j.ref_kv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=atol,
                                   atol=atol)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=atol,
                                   atol=atol)


def test_bridged_memo_and_layout(system):
    st = _states(system)
    assert st.ref_kv[0][0].shape == (S, 16, 2, 8, 64)
    assert st.ref_valid.shape == (S, 2, 8)
    assert st.next_slot.dtype == torch.int64 and st.next_slot.shape == (S,)
    one = video_state_from_jax(jax.tree.map(np.asarray, system["jstates"][1]))
    assert one.next_slot == 0 and one.ref_kv[0][0].shape == (16, 2, 8, 64)
    np.testing.assert_array_equal(one.ref_kv[1][1].numpy(),
                                  st.ref_kv[1][1][1].numpy())


def test_batched_proposals_and_head_match_jax(system):
    """Proposals of every frame of every stream (they do not depend on the
    memo), and the head outputs of frame 0 against each stream's memo."""
    jmodel, params = system["jmodel"], system["params"]
    tmodel, frames = system["tmodel"], system["frames"]
    cfg = jmodel.cfg
    flat = frames.reshape(S * T, 64, 64, 3)
    _, jneck = jmodel.apply(params, jnp.asarray(flat),
                            method=JS.SelsaDetector.extract_feat)
    jcls, jreg = jmodel.apply(params, jneck,
                              method=JS.SelsaDetector.rpn_forward)
    tneck = tmodel.extract_feat(torch.from_numpy(flat))
    tcls, treg = tmodel.rpn_forward(tneck)
    shapes = np.repeat(IMG_SHAPES, T, axis=0)
    tprops = trpn.rpn_proposals(tcls, treg, system["tanchors"],
                                torch.from_numpy(shapes),
                                nms_pre=cfg.test_nms_pre,
                                nms_post=cfg.test_nms_post,
                                iou_threshold=cfg.rpn_nms_iou)
    for i in range(S * T):
        jp = jrpn.rpn_proposals([(jcls[i], jreg[i])], [system["janchors"]],
                                jnp.asarray(shapes[i]),
                                nms_pre=cfg.test_nms_pre,
                                nms_post=cfg.test_nms_post,
                                iou_threshold=cfg.rpn_nms_iou)
        np.testing.assert_array_equal(tprops.valid[i].numpy(),
                                      np.asarray(jp.valid))
        np.testing.assert_allclose(tprops.boxes[i].detach().numpy(),
                                   np.asarray(jp.boxes), rtol=0, atol=1e-3)

    head = TS.stream_head_batch(tmodel, _states(system),
                                torch.from_numpy(frames[:, 0]),
                                torch.from_numpy(IMG_SHAPES),
                                system["tanchors"])
    assert head.cls_score.shape == (S, 8, 4)
    assert head.cur_kvs[0][0].shape == (S, 16, 8, 64)
    for s in range(S):
        jst = system["jstates"][s]
        jf = jnp.asarray(frames[s, 0])
        _, neck = jmodel.apply(params, jf[None],
                               method=JS.SelsaDetector.extract_feat)
        cls, reg = jmodel.apply(params, neck,
                                method=JS.SelsaDetector.rpn_forward)
        props = jrpn.rpn_proposals([(cls[0], reg[0])], [system["janchors"]],
                                   jnp.asarray(IMG_SHAPES[s]),
                                   nms_pre=cfg.test_nms_pre,
                                   nms_post=cfg.test_nms_post,
                                   iou_threshold=cfg.rpn_nms_iou)
        rfeats = jmodel.apply(params, neck[0], props.boxes,
                              jnp.zeros((8,), jnp.int32),
                              method=JS.SelsaDetector.roi_feats)
        ref_kvs = tuple((k.reshape(16, -1, 64), v.reshape(16, -1, 64))
                        for k, v in jst.ref_kv)
        (jcs, jbp), jcur = jmodel.apply(
            params, rfeats, ref_kvs, jst.ref_valid.reshape(-1), props.valid,
            method=JS.SelsaDetector.bbox_forward_cached_stream_kv)
        np.testing.assert_allclose(head.cls_score[s].numpy(), np.asarray(jcs),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(head.bbox_pred[s].numpy(), np.asarray(jbp),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(head.cur_kvs[1][0][s].numpy(),
                                   np.asarray(jcur[1][0]), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("update_memo", [False, True])
def test_clip_batch_matches_jax(system, update_memo):
    jstates, jdets = system["jout"][update_memo]
    states = _states(system)
    tstates, tdets = TS.inference_clip_batch(
        system["tmodel"], states, *_inputs(system), system["tanchors"],
        update_memo=update_memo, frame_stride=2)
    assert tdets.boxes.shape == (S, T, 100, 4)
    assert tdets.labels.shape == (S, T, 100)
    for s in range(S):
        for t in range(T):
            _same_dets(_frame(tdets, s, t), _frame(jdets, s, t))
    _same_state(tstates, jstates)
    if update_memo:  # frames 0 and 2 rolled slots 0 and 1
        assert tstates.next_slot.tolist() == [0, 0]
    _same_state(states, system["jbatch"], atol=0)  # the input is intact


def test_clip_batch_matches_each_stream_alone(system):
    states = _states(system)
    frames, shapes, sfs = _inputs(system)
    bst, bdets = TS.inference_clip_batch(
        system["tmodel"], states, frames, shapes, sfs, system["tanchors"],
        update_memo=True, frame_stride=2)
    for s in range(S):
        one = video_state_from_jax(jax.tree.map(np.asarray,
                                                system["jstates"][s]))
        ost, odets = TS.inference_clip(
            system["tmodel"], one, frames[s], shapes[s], sfs[s],
            system["tanchors"], update_memo=True, frame_stride=2)
        for t in range(T):
            _same_dets(_frame(bdets, s, t), DetResult(*(f[t] for f in odets)))
        assert ost.next_slot == int(bst.next_slot[s])
        np.testing.assert_array_equal(ost.ref_valid.numpy(),
                                      bst.ref_valid[s].numpy())
        for (ok, ov), (bk, bv) in zip(ost.ref_kv, bst.ref_kv):
            np.testing.assert_allclose(ok.numpy(), bk[s].numpy(), rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_allclose(ov.numpy(), bv[s].numpy(), rtol=1e-4,
                                       atol=1e-4)


def test_serve_step_clip_mode_equals_clip_batch(system):
    tmodel, anchors = system["tmodel"], system["tanchors"]
    want_st, want = TS.inference_clip_batch(
        tmodel, _states(system), *_inputs(system), anchors, update_memo=True,
        frame_stride=2)
    step, shard_args = make_serve_step(tmodel, clip=True, update_memo=True,
                                       frame_stride=2)
    st, dets = step(*shard_args(anchors.numpy(), _states(system),
                                system["frames"], IMG_SHAPES, SCALE_FACTORS))
    for g, w in zip(dets, want):
        assert torch.equal(g, w)
    _same_state(st, want_st, atol=0)


def test_serve_step_per_frame_mode_equals_frame_loop(system):
    """Per-frame mode rolls the memo on every call: T calls equal the clip
    with frame_stride 1 and each stream's own ``inference_step`` loop."""
    tmodel, anchors = system["tmodel"], system["tanchors"]
    frames, shapes, sfs = _inputs(system)
    want_st, want = TS.inference_clip_batch(
        tmodel, _states(system), frames, shapes, sfs, anchors,
        update_memo=True, frame_stride=1)
    step, shard_args = make_serve_step(tmodel, clip=False, update_memo=True)
    st = _states(system)
    for t in range(T):
        anchors_d, st, fr, sh, sf = shard_args(anchors, st, frames[:, t],
                                               shapes, sfs)
        st, dets = step(anchors_d, st, fr, sh, sf)
        assert dets.boxes.shape == (S, 100, 4)
        for g, w in zip(dets, want):
            assert torch.equal(g, w[:, t])
    _same_state(st, want_st, atol=0)
    for s in range(S):
        one = video_state_from_jax(jax.tree.map(np.asarray,
                                                system["jstates"][s]))
        for t in range(T):
            one, d = TS.inference_step(tmodel, one, frames[s, t], shapes[s],
                                       sfs[s], anchors, update_memo=True)
            _same_dets(d, _frame(want, s, t))


def test_inference_clip_leaves_the_callers_state_intact(system):
    """The fix-stride roll must not write into the given state: two runs
    from one state agree, and the state (here a view into a batched memo)
    is unchanged after both."""
    tmodel, anchors = system["tmodel"], system["tanchors"]
    frames, shapes, sfs = _inputs(system)
    batch = _states(system)
    before = TS.copy_video_state(batch)
    view = TS.VideoState(tuple((k[0], v[0]) for k, v in batch.ref_kv),
                         batch.ref_valid[0], 0)
    runs = [TS.inference_clip(tmodel, view, frames[0], shapes[0], sfs[0],
                              anchors, update_memo=True, frame_stride=2)
            for _ in range(2)]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
    _same_state(runs[0][0], runs[1][0], atol=0)
    _same_state(batch, before, atol=0)
    assert runs[0][0].next_slot == 0  # rolled slots 0 and 1
    assert not torch.equal(runs[0][0].ref_kv[0][0], view.ref_kv[0][0])


def test_batched_video_state_and_head_dtype():
    cfg = TS.SelsaConfig(compute_dtype=torch.float32,
                         head_dtype=torch.bfloat16, **TINY)
    st = batched_video_state(cfg, 3, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    assert st.ref_kv[0][0].shape == (3, 16, 2, 8, 64)
    assert st.ref_kv[0][0].dtype == torch.bfloat16
    assert st.ref_valid.shape == (3, 2, 8) and bool(st.ref_valid.all())
    assert st.next_slot.tolist() == [0, 0, 0]
    st.ref_kv[0][0][0].zero_()  # every stream owns its memory
    assert st.ref_kv[0][0][1].abs().sum() > 0
    model = TS.SelsaDetector(cfg)
    assert model.bbox_head.fc_cls.compute_dtype == torch.bfloat16
    assert model.backbone.conv1.compute_dtype == torch.float32
    assert TS.empty_video_state(TS.SelsaConfig(**TINY)).ref_kv[0][0].dtype \
        == torch.bfloat16  # None follows compute_dtype
