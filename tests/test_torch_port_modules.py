"""Port parity per module, with weights bridged from a JAX init by
``from_jax_variables``: ResNet-50 DC5 (narrow base width), ChannelMapper,
RPNHead, SelsaAggregator and the streaming Shared2FC head. Every leaf is
perturbed (biases and BN statistics non-trivial). f32, tolerances stated
per test (about 1e-4 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lowlightenvironmentvideoobjectdetection_tpu.models.aggregators.selsa_aggregator import (  # noqa: E501
    SelsaAggregator as JaxAggregator,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.backbones.resnet import (
    ResNet as JaxResNet,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.dense_heads.rpn_head import (  # noqa: E501
    RPNHead as JaxRPNHead,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.necks.channel_mapper import (  # noqa: E501
    ChannelMapper as JaxChannelMapper,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.roi_heads.bbox_head import (  # noqa: E501
    Shared2FCBBoxHead as JaxBBoxHead,
)
from lowlightenvironmentvideoobjectdetection_torch.models.aggregators.selsa_aggregator import (  # noqa: E501
    SelsaAggregator,
)
from lowlightenvironmentvideoobjectdetection_torch.models.backbones.resnet import (  # noqa: E501
    ResNet,
)
from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads.rpn_head import (  # noqa: E501
    RPNHead,
)
from lowlightenvironmentvideoobjectdetection_torch.models.necks.channel_mapper import (  # noqa: E501
    ChannelMapper,
)
from lowlightenvironmentvideoobjectdetection_torch.models.roi_heads.bbox_head import (  # noqa: E501
    Shared2FCBBoxHead,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)

torch.set_num_threads(1)


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


def _load(module, variables):
    module.load_state_dict(from_jax_variables(variables), strict=True)
    return module.eval()


def _close(got, want, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_resnet50_dc5_narrow():
    """base_channels 8: R50 structure and DC5 strides/dilations at 1/8
    width. rtol/atol 1e-4 after ~50 convs."""
    kw = dict(depth=50, base_channels=8, strides=(1, 2, 2, 1),
              dilations=(1, 1, 1, 2), out_indices=(0, 3))
    jm = JaxResNet(dtype=jnp.float32, **kw)
    x = np.random.RandomState(0).randn(2, 48, 64, 3).astype(np.float32)
    v = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    want = jm.apply(v, jnp.asarray(x))
    tm = _load(ResNet(**kw), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 2
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), w)
    assert got[1].shape == (2, 256, 3, 4)  # stride 16


def test_channel_mapper_and_rpn_head():
    """NHWC RPN outputs flatten in the JAX (y, x, anchor) order."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 7, 24).astype(np.float32)
    jn = JaxChannelMapper(out_channels=16, dtype=jnp.float32)
    vn = _perturbed(jn.init(jax.random.PRNGKey(1), [jnp.asarray(x)]), 3)
    want = np.array(jn.apply(vn, [jnp.asarray(x)])[0])
    tn = _load(ChannelMapper(24, 16), vn)
    with torch.no_grad():
        got = tn(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).numpy(), want)

    jr = JaxRPNHead(feat_channels=16, num_base_anchors=12, dtype=jnp.float32)
    vr = _perturbed(jr.init(jax.random.PRNGKey(2), [jnp.asarray(want)]), 4)
    (wc, wr), = jr.apply(vr, [jnp.asarray(want)])
    tr = _load(RPNHead(16, 16, 12), vr)
    with torch.no_grad():
        gc, gr = tr(torch.from_numpy(want))
    _close(gc.reshape(-1).numpy(), np.asarray(wc).reshape(-1))
    _close(gr.reshape(-1, 4).numpy(), np.asarray(wr).reshape(-1, 4))


def test_selsa_aggregator_streaming():
    rng = np.random.RandomState(5)
    n, m1, c = 6, 20, 128
    x = rng.randn(n, c).astype(np.float32)
    ref = rng.randn(m1, c).astype(np.float32)
    memo_mask = rng.rand(m1) > 0.3
    cur_mask = np.ones(n, bool)
    cur_mask[-1] = False
    ja = JaxAggregator(in_channels=c, num_attention_blocks=2,
                       dtype=jnp.float32)
    v = _perturbed(ja.init(jax.random.PRNGKey(3), jnp.asarray(x),
                           jnp.asarray(ref)), 6)
    q = ja.apply(v, jnp.asarray(x), method=JaxAggregator.project_q)
    k1, v1 = ja.apply(v, jnp.asarray(ref), method=JaxAggregator.project_kv_hm)
    k2, v2 = ja.apply(v, jnp.asarray(x), method=JaxAggregator.project_kv_hm)
    want = ja.apply(v, q, k1, v1, k2, v2, jnp.asarray(memo_mask),
                    jnp.asarray(cur_mask), method=JaxAggregator.attend_cached2)

    ta = _load(SelsaAggregator(c, 2), v)
    with torch.no_grad():
        tq = ta.project_q(torch.from_numpy(x))
        tk1, tv1 = ta.project_kv_hm(torch.from_numpy(ref))
        tk2, tv2 = ta.project_kv_hm(torch.from_numpy(x))
        got = ta.attend_cached2(tq, tk1, tv1, tk2, tv2,
                                torch.from_numpy(memo_mask),
                                torch.from_numpy(cur_mask))
    _close(tq.numpy(), q)
    _close(tk1.numpy(), k1)
    _close(tv2.numpy(), v2)
    _close(got.numpy(), want)


def test_bbox_head_forward_cached_stream_kv():
    """Full-width head (1024 FCs, 16 heads) on 8 rois of [7, 7, 16]."""
    rng = np.random.RandomState(7)
    n, m, c, ncls = 8, 24, 16, 5
    x = (rng.randn(n, 7, 7, c) * 0.5).astype(np.float32)
    ref = (rng.randn(m, 7, 7, c) * 0.5).astype(np.float32)
    ref_mask = rng.rand(m) > 0.2
    self_mask = rng.rand(n) > 0.2
    jh = JaxBBoxHead(num_classes=ncls, with_selsa=True, dtype=jnp.float32)
    v = _perturbed(jh.init(jax.random.PRNGKey(4), jnp.asarray(x),
                           jnp.asarray(ref.reshape(m, -1))), 8)
    kvs = jh.apply(v, jnp.asarray(ref), method=JaxBBoxHead.ref_transform_kv)
    (wc, wr), wkv = jh.apply(v, jnp.asarray(x), kvs, jnp.asarray(ref_mask),
                             jnp.asarray(self_mask),
                             method=JaxBBoxHead.forward_cached_stream_kv)

    th = _load(Shared2FCBBoxHead(7 * 7 * c, ncls), v)
    with torch.no_grad():
        tkvs = th.ref_transform_kv(torch.from_numpy(ref))
        (gc, gr), gkv = th.forward_cached_stream_kv(
            torch.from_numpy(x), tkvs, torch.from_numpy(ref_mask),
            torch.from_numpy(self_mask))
    for (tk, tv), (jk, jv) in zip(tkvs, kvs):
        _close(tk.numpy(), jk)
        _close(tv.numpy(), jv)
    for (tk, tv), (jk, jv) in zip(gkv, wkv):
        _close(tk.numpy(), jk)
        _close(tv.numpy(), jv)
    _close(gc.numpy(), wc)
    _close(gr.numpy(), wr)
