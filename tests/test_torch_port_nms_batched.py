"""Port parity: NMS with a leading stream axis against ``jax.vmap`` of the
JAX functions, exact (same keep sets, indices, boxes and scores).

The streams are built to converge after different numbers of fixpoint
iterations (a long suppression chain beside a stream with no overlap at
all), so the port's one shared loop keeps running on streams that have
converged; and their coordinates differ by orders of magnitude, so a
class offset taken over the whole batch instead of per stream would move
boxes and break ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_tpu.core import nms as jax_nms
from lowlightenvironmentvideoobjectdetection_torch.core import nms as t_nms


_pinned_threads = thread_count(1)


def _chain(n):
    """Boxes sliding right by 30% of their width with falling scores: each
    overlaps only its neighbours, so greedy keeps every second one and the
    fixpoint needs about n iterations."""
    x = np.arange(n) * 3.0
    boxes = np.stack([x, np.zeros(n), x + 10.0, np.full(n, 10.0)], 1)
    return boxes, np.linspace(0.9, 0.1, n)


def _streams(n=60, seed=0):
    rng = np.random.RandomState(seed)
    chain_b, chain_s = _chain(n)
    apart_b = np.stack([np.arange(n) * 50.0, np.zeros(n),
                        np.arange(n) * 50.0 + 10.0, np.full(n, 10.0)], 1)
    xy = rng.uniform(0, 100, (n, 2))
    rand_b = np.concatenate([xy, xy + rng.uniform(5, 40, (n, 2))], 1) * 40.0
    rand_s = np.round(rng.uniform(0, 1, n) * 6) / 6  # score ties
    boxes = np.stack([chain_b, apart_b, rand_b]).astype(np.float32)
    scores = np.stack([chain_s, rng.uniform(0, 1, n), rand_s]
                      ).astype(np.float32)
    valid = rng.rand(3, n) > 0.1
    valid[0] = True  # keep the chain whole
    return boxes, scores, valid


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("pre_top_k,use_valid", [(None, False), (40, True)])
def test_nms_fixed_batched_equals_vmap(pre_top_k, use_valid):
    b, s, v = _streams()
    jf = jax.vmap(lambda b, s, v: jax_nms.nms_fixed(
        b, s, 0.5, 30, valid=v if use_valid else None, pre_top_k=pre_top_k))
    want = jf(jnp.asarray(b), jnp.asarray(s), jnp.asarray(v))
    got = t_nms.nms_fixed(torch.from_numpy(b), torch.from_numpy(s), 0.5, 30,
                          valid=torch.from_numpy(v) if use_valid else None,
                          pre_top_k=pre_top_k)
    assert got.boxes.shape == (3, 30, 4)
    _same(got, want)
    # the chain keeps every second box; the spread-out stream keeps all
    assert int(got.valid[0].sum()) == (pre_top_k or 60) // 2
    # each stream equals the single-stream call
    for i in range(3):
        one = t_nms.nms_fixed(torch.from_numpy(b[i]), torch.from_numpy(s[i]),
                              0.5, 30, valid=torch.from_numpy(v[i])
                              if use_valid else None, pre_top_k=pre_top_k)
        _same(one, [f[i] for f in got])


def test_batched_nms_per_stream_offsets_equal_vmap():
    b, s, v = _streams(seed=1)
    idxs = np.random.RandomState(1).randint(0, 4, b.shape[1]).astype(np.int32)
    v[2, -1] = False
    b[2, -1] = [1e5, 1e5, 1e5 + 5, 1e5 + 5]  # an invalid box sets the offset
    jf = jax.vmap(lambda b, s, v: jax_nms.batched_nms(
        b, s, jnp.asarray(idxs), 0.4, 40, valid=v, pre_top_k=50))
    want = jf(jnp.asarray(b), jnp.asarray(s), jnp.asarray(v))
    got = t_nms.batched_nms(torch.from_numpy(b), torch.from_numpy(s),
                            torch.from_numpy(idxs), 0.4, 40,
                            valid=torch.from_numpy(v), pre_top_k=50)
    _same(got, want)


@pytest.mark.parametrize("per_class", [True, False])
def test_multiclass_nms_batched_equals_vmap(per_class):
    rng = np.random.RandomState(4)
    s_, n, c = 3, 40, 4
    xy = rng.uniform(0, 100, (s_, n, 2))
    box = np.concatenate([xy, xy + rng.uniform(5, 40, (s_, n, 2))], -1)
    box *= np.array([1.0, 10.0, 0.1])[:, None, None]  # per-stream scale
    boxes = (np.tile(box, (1, 1, c)) + rng.randn(s_, n, 4 * c) * 2
             if per_class else box).astype(np.float32)
    logits = np.round(rng.randn(s_, n, c + 1) * 4) / 4  # ties after softmax
    scores = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
              ).astype(np.float32)
    valid = rng.rand(s_, n) > 0.1
    jf = jax.vmap(lambda b, s, v: jax_nms.multiclass_nms(
        b, s, 0.05, 0.5, 30, box_valid=v, pre_top_k=n * c))
    want = jf(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    got = t_nms.multiclass_nms(torch.from_numpy(boxes),
                               torch.from_numpy(scores), 0.05, 0.5, 30,
                               box_valid=torch.from_numpy(valid),
                               pre_top_k=n * c)
    assert got.labels.shape == (s_, 30)
    _same(got, want)
