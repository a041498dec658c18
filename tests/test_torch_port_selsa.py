"""Port parity for the whole slice: SELSA streaming inference at a small
size (R50-DC5 at full depth and width, 128x128 bucket, neck 32, 4 classes,
2 reference frames), f32 on both sides, weights bridged from the JAX init.

``init_video_state`` then 3 ``inference_step`` calls, in adaptive mode and
with the fix-stride memo roll. Per frame: proposals identical in order and
validity (boxes to 1e-3 px), head outputs to 1e-4 relative, memo to 1e-4,
and the final detections equal as sets (count exact; label exact, box to
5e-3 px and score to 1e-5 per row: the f32 head differences of ~1e-5
relative, scaled by the roi size and the 1/scale_factor of 2).
``det_nms_pre`` covers every candidate (16 rois x 4 classes), so no
candidate window cuts either side. The API test drives both packages'
``inference_vid_prepared``, so no resize difference enters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_tpu.models.vid import (
    selsa as JS,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.dense_heads import (
    rpn_head as jrpn,
)
from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
    selsa as TS,
)
from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
    VIDModel,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)
from torch_port_threads import thread_count


SMALL = dict(pad_h=128, pad_w=128, neck_channels=32, num_classes=4,
             num_ref_frames=2, test_nms_pre=200, test_nms_post=16,
             det_nms_pre=64)
IMG_SHAPE = (100.0, 120.0)


_pinned_threads = thread_count(1)


@pytest.fixture(scope="module")
def pair():
    jcfg = JS.SelsaConfig(compute_dtype=jnp.float32, **SMALL)
    jmodel = JS.SelsaDetector(cfg=jcfg)
    params = JS.init_params(jmodel, jax.random.PRNGKey(0), small=True)
    rng = np.random.RandomState(0)
    # non-trivial biases and BN statistics, so the bridge is exercised
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x) * (rng.uniform(0.8, 1.25, x.shape)
                                      if str(p[-1].key) == "var" else 1.0)
        + (rng.randn(*x.shape) * 0.02 if str(p[-1].key) in ("bias", "mean")
           else 0.0), params)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    params)
    tmodel = TS.SelsaDetector(TS.SelsaConfig(compute_dtype=torch.float32,
                                             **SMALL))
    tmodel.load_state_dict(from_jax_variables(params), strict=True)
    frames = np.zeros((5, 128, 128, 3), np.float32)
    frames[:, :100, :120] = rng.randn(5, 100, 120, 3)
    return jmodel, params, tmodel.eval(), frames


def _jax_head(model, params, state, frame, img_shape, anchors):
    """The pre-decode part of the JAX ``inference_step``."""
    cfg = model.cfg
    _, neck = model.apply(params, frame[None],
                          method=JS.SelsaDetector.extract_feat)
    cls, reg = model.apply(params, neck, method=JS.SelsaDetector.rpn_forward)
    props = jrpn.rpn_proposals([(cls[0], reg[0])], [anchors], img_shape,
                               nms_pre=cfg.test_nms_pre,
                               nms_post=cfg.test_nms_post,
                               iou_threshold=cfg.rpn_nms_iou)
    rfeats = model.apply(params, neck[0], props.boxes,
                         jnp.zeros((props.boxes.shape[0],), jnp.int32),
                         method=JS.SelsaDetector.roi_feats)
    ref_kvs = tuple((k.reshape(k.shape[0], -1, k.shape[-1]),
                     v.reshape(v.shape[0], -1, v.shape[-1]))
                    for k, v in state.ref_kv)
    (cls_score, bbox_pred), _ = model.apply(
        params, rfeats, ref_kvs, state.ref_valid.reshape(-1), props.valid,
        method=JS.SelsaDetector.bbox_forward_cached_stream_kv)
    return props, cls_score, bbox_pred


def _close(got, want, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _same_state(t, j):
    np.testing.assert_array_equal(t.ref_valid.numpy(), np.asarray(j.ref_valid))
    assert t.next_slot == int(j.next_slot)
    for (tk, tv), (jk, jv) in zip(t.ref_kv, j.ref_kv):
        _close(tk.numpy(), jk)
        _close(tv.numpy(), jv)


def _same_dets(t, j):
    """Equal detection sets: near-equal scores may sort differently."""
    jv = np.asarray(j.valid)
    tv = t.valid.numpy()
    assert tv.sum() == jv.sum() > 0
    jrows = list(zip(np.asarray(j.labels)[jv], np.asarray(j.boxes)[jv],
                     np.asarray(j.scores)[jv]))
    trows = list(zip(t.labels.numpy()[tv], t.boxes.numpy()[tv],
                     t.scores.numpy()[tv]))
    for lab, box, score in jrows:
        hits = [i for i, (tl, tb, ts) in enumerate(trows)
                if tl == lab and np.abs(tb - box).max() < 5e-3
                and abs(ts - score) < 1e-5]
        assert hits, (lab, box, score)
        trows.pop(hits[0])


@pytest.mark.parametrize("update_memo", [False, True])
def test_stream_matches_jax(pair, update_memo):
    jmodel, params, tmodel, frames = pair
    janchors = JS.make_anchors(jmodel.cfg)
    tanchors = TS.make_anchors(tmodel.cfg)
    np.testing.assert_array_equal(tanchors.numpy(), np.asarray(janchors))
    jshape = jnp.asarray(IMG_SHAPE)
    tshape = torch.tensor(IMG_SHAPE)
    sf = np.array([0.5, 0.5, 0.5, 0.5], np.float32)

    jstate = JS.init_video_state(jmodel, params, jnp.asarray(frames[:2]),
                                 jshape, janchors)
    tstate = TS.init_video_state(tmodel, torch.from_numpy(frames[:2]), tshape,
                                 tanchors)
    _same_state(tstate, jstate)
    for t in range(2, 5):
        jf, tf = jnp.asarray(frames[t]), torch.from_numpy(frames[t])
        jprops, jcls, jreg = _jax_head(jmodel, params, jstate, jf, jshape,
                                       janchors)
        head = TS.stream_head(tmodel, tstate, tf, tshape, tanchors)
        np.testing.assert_array_equal(head.proposals.valid.numpy(),
                                      np.asarray(jprops.valid))
        _close(head.proposals.boxes.numpy(), jprops.boxes, rtol=0, atol=1e-3)
        _close(head.cls_score.numpy(), jcls)
        _close(head.bbox_pred.numpy(), jreg)

        jstate, jdets = JS.inference_step(
            jmodel, params, jstate, jf, jshape, jnp.asarray(sf), janchors,
            update_memo=update_memo)
        tstate, tdets = TS.inference_step(
            tmodel, tstate, tf, tshape, torch.from_numpy(sf), tanchors,
            update_memo=update_memo)
        _same_dets(tdets, jdets)
        _same_state(tstate, jstate)


def _same_per_class(got, want):
    """Per-class [N, 5] results equal as sets (tolerances as above)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        rows = list(g)
        for r in w:
            hits = [i for i, x in enumerate(rows)
                    if np.abs(x[:4] - r[:4]).max() < 5e-3
                    and abs(x[4] - r[4]) < 1e-5]
            assert hits, r
            rows.pop(hits[0])


def test_vid_model_prepared_entry_matches_jax(pair):
    """The prepared-image API on both sides (no resize involved), fix-stride
    memo roll: the same per-class [N, 5] results for every frame."""
    from lowlightenvironmentvideoobjectdetection_tpu.apis.inference import (
        VIDModel as JaxVIDModel,
    )

    jmodel, params, tmodel, frames = pair
    jvm = JaxVIDModel(params=params, ref_method="fix", compute_dtype="float32",
                      **SMALL)
    tvm = VIDModel(state_dict=tmodel.state_dict(), ref_method="fix",
                   compute_dtype=torch.float32, device="cpu", **SMALL)
    sf = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
    for fid in range(3):
        img = frames[fid, :100, :120]
        want = jvm.inference_vid_prepared(img, scale_factor=sf, frame_id=fid)
        got = tvm.inference_vid_prepared(img, scale_factor=sf, frame_id=fid)
        assert sum(len(r) for r in got["bbox_results"]) > 0
        _same_per_class(got["bbox_results"], want["bbox_results"])
    assert tvm.state.next_slot == 1  # frames 0, 1, 2 rolled slots 0, 1, 0


def test_inference_clip_fix_stride_matches_jax(pair):
    """Whole-clip streaming with the memo rolled on every second frame."""
    jmodel, params, tmodel, frames = pair
    jshape, tshape = jnp.asarray(IMG_SHAPE), torch.tensor(IMG_SHAPE)
    sf = np.ones(4, np.float32)
    janchors, tanchors = JS.make_anchors(jmodel.cfg), TS.make_anchors(tmodel.cfg)
    jstate = JS.init_video_state(jmodel, params, jnp.asarray(frames[:2]),
                                 jshape, janchors)
    tstate = TS.init_video_state(tmodel, torch.from_numpy(frames[:2]), tshape,
                                 tanchors)
    jstate, jdets = JS.inference_clip(
        jmodel, params, jstate, jnp.asarray(frames[2:]), jshape,
        jnp.asarray(sf), janchors, update_memo=True, frame_stride=2)
    tstate, tdets = TS.inference_clip(
        tmodel, tstate, torch.from_numpy(frames[2:]), tshape,
        torch.from_numpy(sf), tanchors, update_memo=True, frame_stride=2)
    assert tdets.boxes.shape == (3, 100, 4)
    for t in range(3):
        _same_dets(type(tdets)(*(f[t] for f in tdets)),
                   type(jdets)(*(f[t] for f in jdets)))
    _same_state(tstate, jstate)
    assert tstate.next_slot == 0  # frames 0 and 2 rolled slots 0 and 1


def test_empty_video_state_layout():
    cfg = TS.SelsaConfig(**SMALL)
    st = TS.empty_video_state(cfg, generator=torch.Generator().manual_seed(0))
    assert len(st.ref_kv) == 2  # one (k, v) per shared FC
    for k, v in st.ref_kv:
        assert k.shape == v.shape == (16, 2, 16, 64)
        assert k.dtype == torch.bfloat16
    assert st.ref_valid.shape == (2, 16) and bool(st.ref_valid.all())
    zero = TS.empty_video_state(cfg)
    assert not zero.ref_kv[0][0].any()
