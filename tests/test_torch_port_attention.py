"""Port parity: two-slab SELSA attention (plain torch version of kernel A)
against the JAX package's plain reference and its Pallas kernel run in
interpret mode. f32 throughout, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_tpu.ops.fused_attention import (
    selsa_attention_reference_hm as jax_reference_hm,
    selsa_fused_attention_2slab_hm as jax_2slab_hm,
)
from lowlightenvironmentvideoobjectdetection_torch.ops.fused_attention import (
    selsa_attention_reference_hm,
    selsa_fused_attention_2slab_hm,
)

torch.set_num_threads(1)
ATOL = 1e-5


def _inputs(seed, n=12, m1=40, m2=10, nb=4, hd=64, live1=None, live2=None):
    rng = np.random.RandomState(seed)
    f = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)  # noqa: E731
    q, k1, v1, k2, v2 = (f(n, nb, hd), f(nb, m1, hd), f(nb, m1, hd),
                         f(nb, m2, hd), f(nb, m2, hd))
    if live1 is None:
        live1, live2 = rng.rand(m1) > 0.3, rng.rand(m2) > 0.3
        live1[0] = True  # at least one live key
    b1 = np.where(live1, 0.0, -1e30).astype(np.float32)
    b2 = np.where(live2, 0.0, -1e30).astype(np.float32)
    return q, k1, v1, k2, v2, b1, b2


def _port(args):
    return selsa_fused_attention_2slab_hm(
        *(torch.from_numpy(a) for a in args)).numpy()


@pytest.mark.parametrize("seed,m1,m2", [(0, 40, 10), (1, 33, 7), (2, 5, 19)])
def test_plain_matches_jax_reference_on_concat(seed, m1, m2):
    q, k1, v1, k2, v2, b1, b2 = args = _inputs(seed, m1=m1, m2=m2)
    want = jax_reference_hm(jnp.asarray(q), jnp.concatenate([k1, k2], 1),
                            jnp.concatenate([v1, v2], 1),
                            jnp.concatenate([b1, b2]))
    np.testing.assert_allclose(_port(args), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_matches_pallas_interpret(seed):
    args = _inputs(seed)
    want = jax_2slab_hm(*(jnp.asarray(a) for a in args), interpret=True)
    np.testing.assert_allclose(_port(args), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_all_masked_rows_are_uniform_over_real_keys():
    """Every key masked: the plain softmax gives the mean of V over the real
    keys (the Pallas wrapper's zero padding would bias it; not compared)."""
    m1, m2 = 40, 10
    args = _inputs(5, m1=m1, m2=m2, live1=np.zeros(m1, bool),
                   live2=np.zeros(m2, bool))
    q, k1, v1, k2, v2, b1, b2 = args
    got = _port(args)
    want = jax_reference_hm(jnp.asarray(q), jnp.concatenate([k1, k2], 1),
                            jnp.concatenate([v1, v2], 1),
                            jnp.concatenate([b1, b2]))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    mean_v = np.concatenate([v1, v2], 1).mean(1)  # [nb, hd]
    np.testing.assert_allclose(got, np.broadcast_to(mean_v, got.shape),
                               rtol=0, atol=ATOL)


def test_single_slab_reference_matches_jax():
    q, k1, v1, _, _, b1, _ = _inputs(6)
    got = selsa_attention_reference_hm(*(torch.from_numpy(a)
                                         for a in (q, k1, v1, b1))).numpy()
    want = jax_reference_hm(*(jnp.asarray(a) for a in (q, k1, v1, b1)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_bf16_memo_follows_the_f32_math():
    """bf16 K/V go through the same f32 softmax; looser bf16 tolerance."""
    args = _inputs(7)
    t = [torch.from_numpy(a) for a in args]
    t[1:5] = [x.bfloat16() for x in t[1:5]]
    got = selsa_fused_attention_2slab_hm(*t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _port(args), rtol=0, atol=2e-2)
