"""The parts of the dense one-stage heads in the port against the JAX
package on the CPU, on the same numpy inputs:

- ``atss_assign`` on a grid where gt centres fall between anchors, so the
  candidates' distances tie (the top-k sends ties to the lower index, as
  ``lax.top_k``): equal assignments;
- ``fcos_targets`` with two gts of equal area (``argmin`` takes the lower
  index): equal positives, labels and distances;
- ``_gmm_pos_split`` on separated and on overlapping scores: equal masks;
- ``isr_p_weights`` with IoU ties inside a class: equal weights;
- ``free_anchor_loss`` with RetinaNet's anchors against gts symmetric
  about anchor centres (exactly tied IoUs inside the bags): the bags'
  top-k equals ``lax.top_k``, both terms and their gradients;
- GFL's ``_integral`` and ``gfl_loss`` (the DFL among its terms) with
  gradients;
- ``varifocal_loss`` and its gradient;
- ``star_offsets`` and its gradient (``gradient_mul``), and ROADMAP fault
  F24: the offsets are interleaved (dy, dx) a tap, but the DCN reads
  channel k as tap k's dy (9 dy, then 9 dx), in JAX as in the port.

Losses to 1e-5 relative, gradients to 1e-4 of their largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (
    atss_head as TA,
    fcos_head as TFC,
    free_anchor_head as TFA,
    gfl_head as TG,
    paa_head as TP,
    pisa_nasfcos as TPN,
    retina_head as TR,
    vfnet_head as TV,
)
from lowlightenvironmentvideoobjectdetection_torch.ops import (
    deform_conv as tdcn,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.dense_heads import (
    atss_head as JA,
    fcos_head as JFC,
    free_anchor_head as JFA,
    gfl_head as JG,
    paa_head as JP,
    pisa_nasfcos as JPN,
    retina_head as JR,
    vfnet_head as JV,
)
from lowlightenvironmentvideoobjectdetection_tpu.ops import (
    deform_conv as jdcn,
)

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
SIZES = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]


_pinned_threads = thread_count(1)


def t(a):
    return torch.from_numpy(np.asarray(a))


def close_grad(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GRAD_REL * max(np.abs(want).max(), 1e-12))


# gt centres between anchor centres (anchors at x * stride), so several
# anchors of a level lie at exactly the same distance from a centre
TIE_GTS = np.array([[8.0, 8.0, 64.0, 64.0],        # centre (36, 36)
                    [20.0, 12.0, 100.0, 84.0],     # centre (60, 48)
                    [0.0, 40.0, 24.0, 120.0],      # centre (12, 80)
                    [0.0, 0.0, 0.0, 0.0]], np.float32)
TIE_VALID = np.array([True, True, True, False])


@pytest.mark.parametrize("topk", [9, 4])
def test_atss_assign_ties_match_jax(topk):
    janc = JA.atss_anchors(SIZES)
    tanc = TA.atss_anchors(SIZES)
    for a, b in zip(tanc, janc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = JA.atss_assign(janc, jnp.asarray(TIE_GTS), jnp.asarray(TIE_VALID),
                          topk=topk)
    got = TA.atss_assign(tanc, t(TIE_GTS), t(TIE_VALID), topk=topk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).sum() > 0
    # the ties are real: the first gt's centre is equally far from the four
    # P3 anchors about it
    acx, acy = TA.anchor_centres(tanc[0])
    d = torch.sqrt((acx - 36.0) ** 2 + (acy - 36.0) ** 2)
    assert int((d == d.min()).sum()) == 4


def test_fcos_targets_equal_areas_match_jax():
    """Gts 0 and 1 have the same area and overlap, so points inside both
    take gt 0 (the lower index)."""
    gts = np.array([[8.0, 8.0, 72.0, 40.0], [24.0, 16.0, 88.0, 48.0],
                    [0.0, 60.0, 40.0, 127.0], [0.0, 0.0, 0.0, 0.0]],
                   np.float32)
    labels = np.array([2, 1, 3, 0])
    valid = np.array([True, True, True, False])
    pts = np.concatenate([np.asarray(p) for p in JFC.fcos_points(SIZES)])
    ranges = np.concatenate([
        np.tile(np.asarray(JFC.REGRESS_RANGES[i], np.float32), (h * w, 1))
        for i, (h, w) in enumerate(SIZES)])
    want = JFC.fcos_targets(jnp.asarray(pts), jnp.asarray(ranges),
                            jnp.asarray(gts), jnp.asarray(labels),
                            jnp.asarray(valid))
    tpts = torch.cat(TFC.fcos_points(SIZES))
    np.testing.assert_array_equal(tpts.numpy(), pts)
    got = TFC.fcos_targets(tpts, t(ranges), t(gts), t(labels).long(),
                           t(valid))
    pos = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), pos)
    for i in (1, 2):
        np.testing.assert_array_equal(got[i].numpy()[pos],
                                      np.asarray(want[i])[pos])
    both = pos & (got[1].numpy() == 2)
    assert both.sum() > 0 and (got[1].numpy()[pos] == 1).sum() > 0


@pytest.mark.parametrize("case", ["separated", "overlapping"])
def test_gmm_pos_split_matches_jax(case):
    rs = np.random.RandomState(3)
    g, k = 6, 15
    if case == "separated":
        scores = np.where(rs.rand(g, k) < 0.4, 0.3 + 0.05 * rs.randn(g, k),
                          1.2 + 0.1 * rs.randn(g, k))
    else:
        scores = 0.8 + 0.3 * rs.randn(g, k)
        scores[0, :4] = [0.788436, 0.793101, 0.793454, 0.794894]
    scores = scores.astype(np.float32)
    valid = rs.rand(g, k) < 0.8
    valid[0] = np.arange(k) < 4
    valid[1] = False
    want = JP._gmm_pos_split(jnp.asarray(scores), jnp.asarray(valid))
    got = TP._gmm_pos_split(t(scores), t(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got[1].any()


def test_isr_p_weights_ties_match_jax():
    rs = np.random.RandomState(4)
    n = 60
    labels = rs.randint(0, 4, n)
    ious = np.round(rs.rand(n), 1).astype(np.float32)  # many ties a class
    pos = rs.rand(n) < 0.6
    want = JPN.isr_p_weights(jnp.asarray(labels), jnp.asarray(ious),
                             jnp.asarray(pos), 4)
    got = TPN.isr_p_weights(t(labels), t(ious), t(pos), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert len(np.unique(np.asarray(want)[pos])) > 3


def _retina_outs(rs, scale=1.0, c=4):
    return [((scale * rs.randn(h, w, 9 * c)).astype(np.float32),
             (0.2 * rs.randn(h, w, 36)).astype(np.float32)) for h, w in SIZES]


def _both_outs(outs):
    return ([(jnp.asarray(a), jnp.asarray(b)) for a, b in outs],
            [(t(a).requires_grad_(), t(b).requires_grad_()) for a, b in outs])


def _same_grads(touts, jgrads):
    for to, jo in zip(touts, jgrads):
        for x, y in zip(to, jo):
            close_grad(x.grad, y)


# square gts centred on anchor centres (cells at (i + 0.5) * stride... as
# the retina generator places them), so the 3 ratios' anchors of a scale
# tie in IoU by symmetry
SYM_GTS = np.array([[8.0, 8.0, 56.0, 56.0], [36.0, 20.0, 92.0, 76.0],
                    [0.0, 0.0, 0.0, 0.0]], np.float32)
SYM_LABELS = np.array([1, 3, 0])
SYM_VALID = np.array([True, True, False])


def test_free_anchor_bags_and_loss_match_jax():
    rs = np.random.RandomState(5)
    outs = _retina_outs(rs)
    anchors = JR.retina_anchor_generator().grid_anchors(SIZES)
    all_a = np.concatenate(anchors)
    quality = np.asarray(JFA._iou_matrix(jnp.asarray(SYM_GTS),
                                         jnp.asarray(all_a)))
    top16 = np.sort(quality[:2], axis=1)[:, ::-1][:, :17]
    assert (np.diff(top16, axis=1) == 0).any()  # ties inside the bags
    _, jidx = jax.lax.top_k(jnp.asarray(quality), 16)
    _, tidx = TR.top_k_stable(t(quality), 16)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(
        TFA._iou_matrix(t(SYM_GTS), t(all_a)).numpy(), quality, rtol=0,
        atol=0)

    def jf(lv):
        ls = JFA.free_anchor_loss(lv, [jnp.asarray(a) for a in anchors],
                                  jnp.asarray(SYM_GTS),
                                  jnp.asarray(SYM_LABELS),
                                  jnp.asarray(SYM_VALID), 4,
                                  pre_anchor_topk=16)
        return sum(ls), ls

    jouts, touts = _both_outs(outs)
    (_, want), jg = jax.value_and_grad(jf, has_aux=True)(jouts)
    got = TFA.free_anchor_loss(touts, [t(a) for a in anchors], t(SYM_GTS),
                               t(SYM_LABELS).long(), t(SYM_VALID), 4,
                               pre_anchor_topk=16)
    sum(got).backward()
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(float(g_), float(w_), rtol=LOSS_RTOL)
    _same_grads(touts, jg)


def test_pisa_retina_loss_matches_jax():
    rs = np.random.RandomState(6)
    outs = _retina_outs(rs)
    anchors = JR.retina_anchor_generator().grid_anchors(SIZES)
    gts = np.array([[10.0, 12.0, 60.0, 50.0], [30.0, 5.0, 62.0, 40.0],
                    [2.0, 30.0, 20.0, 60.0], [0.0, 0.0, 0.0, 0.0]],
                   np.float32)
    labels, valid = np.array([0, 2, 0, 0]), np.array([True, True, True,
                                                      False])
    shape = (60.0, 64.0)

    def jf(lv):
        ls = JPN.pisa_retina_loss(lv, [jnp.asarray(a) for a in anchors],
                                  jnp.asarray(gts), jnp.asarray(labels),
                                  jnp.asarray(valid), jnp.asarray(shape), 4)
        return sum(ls), ls

    jouts, touts = _both_outs(outs)
    (_, want), jg = jax.value_and_grad(jf, has_aux=True)(jouts)
    got = TPN.pisa_retina_loss(touts, [t(a) for a in anchors], t(gts),
                               t(labels).long(), t(valid), torch.tensor(shape),
                               4)
    sum(got).backward()
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(float(g_), float(w_), rtol=LOSS_RTOL)
    assert float(got.loss_carl) > 0
    _same_grads(touts, jg)


def test_gfl_integral_and_losses_match_jax():
    rs = np.random.RandomState(7)
    reg_max = 16
    logits = (2 * rs.randn(30, 4 * (reg_max + 1))).astype(np.float32)
    np.testing.assert_allclose(
        TG._integral(t(logits), reg_max).numpy(),
        np.asarray(JG._integral(jnp.asarray(logits), reg_max)), rtol=1e-6,
        atol=1e-6)
    outs = [((rs.randn(h, w, 4)).astype(np.float32),
             (rs.randn(h, w, 4 * (reg_max + 1))).astype(np.float32))
            for h, w in SIZES]

    def jf(lv):
        ls = JG.gfl_loss(lv, jnp.asarray(TIE_GTS), jnp.asarray([0, 1, 3, 0]),
                         jnp.asarray(TIE_VALID), 4, reg_max=reg_max)
        return sum(ls), ls

    jouts, touts = _both_outs(outs)
    (_, want), jg = jax.value_and_grad(jf, has_aux=True)(jouts)
    got = TG.gfl_loss(touts, t(TIE_GTS), torch.tensor([0, 1, 3, 0]),
                      t(TIE_VALID), 4, reg_max=reg_max)
    sum(got).backward()
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(float(g_), float(w_), rtol=LOSS_RTOL)
    assert float(got.loss_dfl) > 0
    _same_grads(touts, jg)


def test_varifocal_loss_matches_jax():
    rs = np.random.RandomState(8)
    logits = (2 * rs.randn(40, 5)).astype(np.float32)
    tgt = np.where(rs.rand(40, 5) < 0.2, rs.rand(40, 5), 0.0).astype(
        np.float32)
    want, jg = jax.value_and_grad(
        lambda x: JV.varifocal_loss(x, jnp.asarray(tgt), avg_factor=7.0))(
            jnp.asarray(logits))
    x = t(logits).requires_grad_()
    got = TV.varifocal_loss(x, t(tgt), avg_factor=7.0)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    close_grad(x.grad, jg)


def test_star_offsets_and_gradient_match_jax():
    rs = np.random.RandomState(9)
    dist = (64 * np.exp(0.5 * rs.randn(2, 3, 5, 4))).astype(np.float32)
    w = rs.randn(2, 3, 5, 18).astype(np.float32)
    jg = jax.grad(lambda d: jnp.sum(JV.star_offsets(d, 8) * w))(
        jnp.asarray(dist))
    d = t(dist).requires_grad_()
    off = TV.star_offsets(d, 8)
    np.testing.assert_array_equal(
        off.detach().numpy(), np.asarray(JV.star_offsets(jnp.asarray(dist),
                                                         8)))
    (off * t(w)).sum().backward()
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(jg), rtol=1e-6)
    # gradient_mul: the offsets' gradient is a tenth of the undamped one
    assert np.abs(d.grad.numpy()).max() < 0.1 * np.abs(w).sum(-1).max()


@pytest.mark.parametrize("k", [1, 4, 7])
def test_f24_tap_k_dy_is_read_from_channel_k(k):
    """The DCN reads its 18 channels as 9 dy and then 9 dx (JAX
    ``ops/deform_conv.py:57-59``; the port's the same): a 1 px offset in
    channel k alone shifts tap k by one row, in JAX and in the port, while
    ``star_offsets`` puts tap k's dy in channel 2k (interleaved pairs), so
    VFNet's tap k reads channel k's value as its dy (F24)."""
    h, w = 6, 7
    x = np.random.RandomState(10).randn(h, w, 1).astype(np.float32)
    off = np.zeros((h, w, 18), np.float32)
    off[..., k] = 1.0
    mask = np.ones((h, w, 9), np.float32)
    kern = np.zeros((3, 3, 1, 1), np.float32)
    kern[k // 3, k % 3, 0, 0] = 1.0  # tap k alone
    want = np.asarray(jdcn.modulated_deform_conv(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask),
        jnp.asarray(kern)))[..., 0]
    ky, kx = k // 3 - 1, k % 3 - 1
    shifted = np.zeros((h, w), np.float32)
    for i in range(h):
        for j in range(w):
            y, xx = i + ky + 1, j + kx
            if 0 <= y < h and 0 <= xx < w:
                shifted[i, j] = x[y, xx, 0]
    np.testing.assert_allclose(want, shifted, rtol=0, atol=1e-6)
    got = tdcn.deform_conv(t(x).permute(2, 0, 1)[None],
                           t(off).permute(2, 0, 1)[None],
                           t(kern).permute(3, 2, 0, 1))[0, 0]
    np.testing.assert_allclose(got.numpy(), shifted, rtol=0, atol=1e-6)
    # star_offsets interleaves: channel 2j is tap j's dy, 2j + 1 its dx
    dist = np.full((1, 1, 4), 16.0, np.float32)
    dist[..., 1] = 48.0  # t
    star = TV.star_offsets(t(dist), 8)[0, 0].numpy()
    np.testing.assert_array_equal(
        star, np.asarray(JV.star_offsets(jnp.asarray(dist), 8))[0, 0])
    # tap 0's dy -t / stride - (-1) and dx -l / stride - (-1), which the
    # DCN reads as taps 0's and 1's dy
    np.testing.assert_allclose(star[:2], [-6.0 + 1.0, -2.0 + 1.0], atol=1e-6)
