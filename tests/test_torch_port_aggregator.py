"""Port parity for the denoising aggregators' modules
(``models/aggregators/denoising_aggregator.py``: ``RDB``,
``ModulatedDCNPack``, ``TemporalAttentionFusion``, ``DenoisingAggregator``,
``Denoising2Aggregator``) against the JAX package's, on the CPU in f32.

Each case draws the JAX module's variables (shaped by ``jax.eval_shape`` of
its ``init``) from a seeded normal, biases included: kernels with a
variance of 1 / fan_in, ``conv_offset``'s so that the offsets have a std of
about 1.5 px (the zero init would put every sample on a pixel); bridges
the tree into the port with ``from_jax_variables`` and runs both on the same numpy inputs (JAX NHWC, the port NCHW) with the JAX
DCN's ``dcn_impl="scan"`` (the port's unbounded offsets; ROADMAP F1). One
jitted ``value_and_grad`` of the sum of the outputs times a seeded
cotangent gives JAX's outputs and the gradients of every parameter and
input. Tolerances: each output and each gradient to an atol of 1e-5 of its
largest |value| (the convs and the DCN sum in other orders; the gradients
pass through the softmax over the frames), a parameter's gradient at least
1e-6 of the largest of any leaf: the biases of the DCN and of the
embedding convs add the same value to every frame before the softmax over
the frames, so their gradients are 0 in exact arithmetic and rounding noise
on both sides. A standalone ``ModulatedDCNPack`` is bridged under the name
``dcn_pack``, as in the TAF.

The seeds are chosen so that no ReLU pre-activation and no DCN sample
position lies within the two frameworks' f32 rounding of its kink (0, or a
whole pixel for ``floor``): there one side passes a whole position's
gradient and the other blocks it. Seed 2 of the four-stage case does so
(``stage0_conv1.bias`` off by 4e-4 of its size); seeds 0, 1, 3, 4 and 5
pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from lowlightenvironmentvideoobjectdetection_tpu.models.aggregators import (
    denoising_aggregator as JA,
)
from lowlightenvironmentvideoobjectdetection_torch.models.aggregators import (
    denoising_aggregator as TA,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
    grads_from_jax,
)
from torch_port_threads import thread_count


REL = 1e-5
FLOOR = 1e-6  # of the largest |grad| of any leaf
OFFSET_STD = 1.5  # px, of the perturbed conv_offset's outputs
STAGES2 = dict(in_channels=(8, 16, 32, 32), mid_channels=(8, 12, 4, 4),
               out_channels=(16, 32, 32, 24), rdb_blocks=(1, 1, 1, 1),
               channel_growth=(4, 4, 4, 4), taf_embs=(2, 2, 2, 2),
               downsample=(True, True, False, False))
# name: (JAX module, port module, input shapes [T, h, w, C] (NHWC), seed)
CASES = {
    "rdb": (JA.RDB(in_channels=8, channel_growth=4, num_layers=3),
            TA.RDB(8, 4, 3), [(2, 6, 7, 8)], 0),
    "dcn_pack": (JA.ModulatedDCNPack(out_channels=6, deform_groups=8,
                                     dcn_impl="scan"),
                 TA.ModulatedDCNPack(8, 6, extra_channels=5),
                 [(2, 6, 7, 8), (2, 6, 7, 5)], 0),
    "taf": (JA.TemporalAttentionFusion(channels=12, mid_channels=8,
                                       emb_nums=3, dcn_impl="scan"),
            TA.TemporalAttentionFusion(12, 8, 3), [(3, 5, 6, 12)], 0),
    "denoising": (JA.DenoisingAggregator(channels=8, mid_channels=4,
                                         rdb_blocks=1, channel_growth=4,
                                         emb_nums=2, dcn_impl="scan"),
                  TA.DenoisingAggregator(8, 4, rdb_blocks=1,
                                         channel_growth=4, emb_nums=2),
                  [(2, 5, 6, 8)], 0),
    "denoising2": (JA.Denoising2Aggregator(dcn_impl="scan", **STAGES2),
                   TA.Denoising2Aggregator(**STAGES2),
                   [(2, 16, 12, 8), (2, 8, 6, 16), (2, 4, 3, 32),
                    (2, 4, 3, 32), (2, 4, 3, 24)], 0),
}


_pinned_threads = thread_count(1)


class _Named(nn.Module):
    """A port module under the name the weight bridge needs."""

    def __init__(self, **mods):
        super().__init__()
        for n, m in mods.items():
            self.add_module(n, m)

    def forward(self, *a):
        return next(self.children())(*a)


def _draw(shapes, rs):
    """Variables of the shapes ``shapes``: biases N(0, 0.05^2), kernels
    and the DCN's weight N(0, 1 / fan_in), conv_offset's kernels with a
    std that gives offsets of about OFFSET_STD px."""
    def leaf(path, a):
        names = [str(getattr(p, "key", p)) for p in path]
        if names[-1] == "bias":
            return (rs.randn(*a.shape) * 0.05).astype(np.float32)
        scale = 1.0 / np.sqrt(np.prod(a.shape[:-1]))
        if "conv_offset" in names:
            scale *= OFFSET_STD
        return (rs.randn(*a.shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _apply(module, name, params, xs):
    if name == "denoising2":
        stages, necks = module.apply(params, xs[:4], xs[4:])
        return list(stages) + list(necks)
    return [module.apply(params, *xs)]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(
        0, 3, 1, 2)))


def _port_outputs(module, name, xs):
    if name == "denoising2":
        stages, necks = module(xs[:4], xs[4:])
        return list(stages) + list(necks)
    return [module(*xs)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_module_forward_and_gradients_match_jax(name):
    jmod, tmod, shapes, seed = CASES[name]
    rs = np.random.RandomState(seed)
    xs = [rs.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    init_args = (xs[:4], xs[4:]) if name == "denoising2" else xs
    params = _draw(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                  *init_args), rs)
    cots = [rs.randn(*o.shape).astype(np.float32) for o in jax.eval_shape(
        lambda p, a: _apply(jmod, name, p, a), params, xs)]

    def loss(p, a):
        outs = _apply(jmod, name, p, a)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, outs), (jgp, jgx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, xs)
    outs = [np.asarray(o) for o in outs]

    tree = params["params"]
    if name == "dcn_pack":
        tmod, tree = _Named(dcn_pack=tmod), {"dcn_pack": tree}
    tmod.load_state_dict(from_jax_variables({"params": tree}), strict=True)
    txs = [_nchw(x).requires_grad_() for x in xs]
    touts = _port_outputs(tmod, name, txs)
    assert len(touts) == len(outs)
    for got, want in zip(touts, outs):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(
            got.detach().numpy().transpose(0, 2, 3, 1), want, rtol=0,
            atol=REL * float(np.abs(want).max()))
    tmod.zero_grad(set_to_none=True)
    sum((o * _nchw(c)).sum() for o, c in zip(touts, cots)).backward()
    jgp = jax.tree_util.tree_map(np.asarray, jgp["params"])
    want_p = grads_from_jax({"dcn_pack": jgp} if name == "dcn_pack"
                            else jgp)
    got_p = dict(tmod.named_parameters())
    assert set(got_p) == set(want_p)
    floor = FLOOR * max(float(g.abs().max()) for g in want_p.values())
    for n, want in want_p.items():
        np.testing.assert_allclose(
            got_p[n].grad.numpy(), want.numpy(), rtol=0,
            atol=max(REL * float(want.abs().max()), floor), err_msg=n)
        if "conv_offset" in n:  # the offsets and the masks learn
            assert float(want.abs().max()) > 10 * floor, n
    for i, (tx, want) in enumerate(zip(txs, jgx)):
        want = np.asarray(want)
        np.testing.assert_allclose(tx.grad.numpy().transpose(0, 2, 3, 1),
                                   want, rtol=0,
                                   atol=REL * float(np.abs(want).max()),
                                   err_msg=f"input {i}")


def test_denoising2_groups_and_shapes():
    """The small four-stage aggregator takes 8 deform groups where the
    fusion's width allows (8) and fewer where it does not (12 and 4 -> 4);
    stride 2 where ``downsample`` says; outputs keep the stages' and the
    neck's shapes."""
    tmod = CASES["denoising2"][1]
    assert [getattr(tmod, f"stage{i}_taf").dcn_pack.groups
            for i in range(4)] == [8, 4, 4, 4]
    assert [getattr(tmod, f"stage{i}_conv2").stride for i in range(4)] == [
        (2, 2), (2, 2), (1, 1), (1, 1)]
    xs = [torch.zeros(s[0], s[3], s[1], s[2]) for s in
          CASES["denoising2"][2]]
    stages, necks = tmod(xs[:4], xs[4:])
    assert [tuple(s.shape) for s in stages] == [tuple(x.shape)
                                                for x in xs[:4]]
    assert tuple(necks[0].shape) == tuple(xs[4].shape)


def test_ablations_leave_out_their_modules():
    """``with_rdb`` / ``with_taf`` off: no such submodules (the JAX tree has
    none either), and the stage still runs."""
    kw = dict(STAGES2, with_rdb=(False,) * 4, with_taf=(True, False, True,
                                                        False))
    tmod = TA.Denoising2Aggregator(**kw)
    names = {n.split(".")[0] for n, _ in tmod.named_parameters()}
    assert not any("_rdb" in n for n in names)
    assert {n for n in names if "_taf" in n} == {"stage0_taf", "stage2_taf"}
    shapes = jax.eval_shape(
        JA.Denoising2Aggregator(dcn_impl="scan", **kw).init,
        jax.random.PRNGKey(0),
        [jnp.zeros((2,) + s[1:]) for s in CASES["denoising2"][2][:4]],
        [jnp.zeros((2, 4, 3, 24))])
    jparams = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                     shapes)
    assert set(from_jax_variables(jparams)) == set(tmod.state_dict())
