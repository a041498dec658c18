"""Port parity: anchors, delta2bbox, NMS (exact keep sets, with score ties),
the JAX weight bridge, frame preprocessing, and the port's independence from
JAX."""

import os
import pkgutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_tpu.core import (
    anchors as jax_anchors,
    boxes as jax_boxes,
    nms as jax_nms,
)
from lowlightenvironmentvideoobjectdetection_tpu.data import (
    preprocess as jax_pre,
)
import lowlightenvironmentvideoobjectdetection_torch as port
from lowlightenvironmentvideoobjectdetection_torch.core import (
    anchors as t_anchors,
    boxes as t_boxes,
    nms as t_nms,
)
from lowlightenvironmentvideoobjectdetection_torch.data import (
    preprocess as t_pre,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)
from torch_port_threads import thread_count


_pinned_threads = thread_count(1)


def test_anchors_equal():
    kw = dict(strides=[16], ratios=[0.5, 1.0, 2.0], scales=[4, 8, 16, 32])
    want = jax_anchors.AnchorGenerator(**kw).grid_anchors([(5, 7)])[0]
    got = t_anchors.AnchorGenerator(**kw).grid_anchors([(5, 7)])[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,stds", [(1, (1.0, 1.0, 1.0, 1.0)),
                                    (5, (0.2, 0.2, 0.2, 0.2))])
def test_delta2bbox(k, stds):
    rng = np.random.RandomState(k)
    xy = rng.uniform(-20, 200, (40, 2))
    rois = np.concatenate([xy, xy + rng.uniform(0, 80, (40, 2))], 1
                          ).astype(np.float32)
    deltas = (rng.randn(40, 4 * k) * 2).astype(np.float32)
    deltas[0, 2:4] = 9.0  # beyond the wh_ratio_clip
    shape = (150.0, 180.0)
    want = jax_boxes.delta2bbox(jnp.asarray(rois), jnp.asarray(deltas),
                                stds=stds, max_shape=jnp.asarray(shape))
    got = t_boxes.delta2bbox(torch.from_numpy(rois), torch.from_numpy(deltas),
                             stds=stds, max_shape=torch.tensor(shape))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _nms_inputs(seed, n=120):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 100, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (n, 2))], 1)
    boxes[5:10] = boxes[0]  # identical boxes ...
    scores = np.round(rng.uniform(0, 1, n) * 6) / 6  # ... and score ties
    scores[5:10] = scores[0]
    valid = rng.rand(n) > 0.15
    return boxes.astype(np.float32), scores.astype(np.float32), valid


def _same_nms(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.inds.numpy(), np.asarray(want.inds))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed,pre_top_k,use_valid",
                         [(0, None, False), (1, 64, True), (2, 1000, True)])
def test_nms_fixed_exact(seed, pre_top_k, use_valid):
    b, s, v = _nms_inputs(seed)
    want = jax_nms.nms_fixed(jnp.asarray(b), jnp.asarray(s), 0.5, 40,
                             valid=jnp.asarray(v) if use_valid else None,
                             pre_top_k=pre_top_k)
    got = t_nms.nms_fixed(torch.from_numpy(b), torch.from_numpy(s), 0.5, 40,
                          valid=torch.from_numpy(v) if use_valid else None,
                          pre_top_k=pre_top_k)
    _same_nms(got, want)


def test_batched_nms_exact():
    b, s, v = _nms_inputs(3)
    idxs = np.random.RandomState(3).randint(0, 4, len(s)).astype(np.int32)
    b[-1] = [1e4, 1e4, 1e4 + 5, 1e4 + 5]  # invalid box still sets the offset
    v[-1] = False
    want = jax_nms.batched_nms(jnp.asarray(b), jnp.asarray(s),
                               jnp.asarray(idxs), 0.4, 60,
                               valid=jnp.asarray(v), pre_top_k=100)
    got = t_nms.batched_nms(torch.from_numpy(b), torch.from_numpy(s),
                            torch.from_numpy(idxs), 0.4, 60,
                            valid=torch.from_numpy(v), pre_top_k=100)
    _same_nms(got, want)


@pytest.mark.parametrize("per_class", [True, False])
def test_multiclass_nms_exact(per_class):
    rng = np.random.RandomState(4)
    n, c = 50, 4
    xy = rng.uniform(0, 100, (n, 2))
    box = np.concatenate([xy, xy + rng.uniform(5, 40, (n, 2))], 1)
    boxes = (np.tile(box, (1, c)) + rng.randn(n, 4 * c) * 2 if per_class
             else box).astype(np.float32)
    logits = np.round(rng.randn(n, c + 1) * 4) / 4  # ties after softmax
    scores = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    scores = scores.astype(np.float32)
    valid = rng.rand(n) > 0.1
    want = jax_nms.multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                  0.05, 0.5, 30, box_valid=jnp.asarray(valid),
                                  pre_top_k=n * c)
    got = t_nms.multiclass_nms(torch.from_numpy(boxes),
                               torch.from_numpy(scores), 0.05, 0.5, 30,
                               box_valid=torch.from_numpy(valid),
                               pre_top_k=n * c)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-6)


def test_bridge_maps_layouts_and_rejects_unknown_leaves():
    conv = np.arange(3 * 3 * 2 * 5, dtype=np.float32).reshape(3, 3, 2, 5)
    dense = np.arange(6, dtype=np.float32).reshape(2, 3)
    sd = from_jax_variables({
        "params": {"neck": {"conv0": {"kernel": conv, "bias": np.zeros(5)}},
                   "bbox_head": {"fc_cls": {"kernel": dense}},
                   "backbone": {"bn1": {"scale": np.ones(5)}}},
        "batch_stats": {"backbone": {"bn1": {"mean": np.zeros(5),
                                             "var": np.ones(5)}}},
    })
    np.testing.assert_array_equal(sd["neck.conv0.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["bbox_head.fc_cls.weight"].numpy(),
                                  dense.T)
    assert set(sd) == {"neck.conv0.weight", "neck.conv0.bias",
                       "bbox_head.fc_cls.weight", "backbone.bn1.weight",
                       "backbone.bn1.running_mean", "backbone.bn1.running_var"}
    with pytest.raises(KeyError):
        from_jax_variables({"params": {"neck": {"conv0": {"gamma": conv}}}})
    with pytest.raises(KeyError):
        from_jax_variables({"cache": {"neck": {"conv0": {"kernel": conv}}}})


@pytest.mark.parametrize("hw,pad", [((90, 150), (64, 96)),
                                    ((40, 50), (96, 128))])
def test_prepare_frames_matches_jax(hw, pad):
    """Down- and up-sampling resize, normalize and pad. The two bilinear
    filters agree to 1e-4 in normalized units (f32 rounding of the filter
    weights; under 0.01 of one 8-bit intensity level)."""
    frames = np.random.RandomState(5).randint(0, 256, (2,) + hw + (3,)
                                              ).astype(np.uint8)
    want_imgs, want_shape, want_sf = jax_pre.prepare_frames(frames, *pad)
    imgs, shape, sf = t_pre.prepare_frames(frames, *pad)
    np.testing.assert_array_equal(shape.numpy(), np.asarray(want_shape))
    np.testing.assert_array_equal(sf, want_sf)
    np.testing.assert_allclose(imgs.numpy(), np.asarray(want_imgs), rtol=0,
                               atol=1e-4)


def test_port_imports_no_jax():
    """Every module of the port imports in a fresh interpreter without
    bringing in jax, flax, optax, orbax or the JAX package (the card's
    machine has none of them)."""
    mods = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                  port.__name__ + ".")]
    assert len(mods) > 15, mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
            "'lowlightenvironmentvideoobjectdetection_tpu')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(port.__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
