"""RepPoints and NAS-FPN RetinaNet in the port against the JAX package on
the CPU, as ``test_torch_port_zoo_heads_c.py`` holds FSAF, FoveaBox and
SABL (its families' tests, on the same cases), and their parts on numpy
inputs drawn from a seed:

- RepPoints' two points DCNs a level run the DCN's plain version here;
  their offsets' gradient reaches the initial points' convs;
- ``NASFPN`` and ``RetinaSepBNHead`` alone (odd map sizes for the
  cells' resizes), ``MomentTransfer`` through the bridge;
- RepPoints' DCN offsets and their gradient through the plain DCN;
- the JAX package's departures from mmdet that the port keeps: F26
  (RepPoints' interleaved offsets read as 9 dy then 9 dx), F27 (NAS-FPN's
  global-pool cell), F28 (its cells' nearest resize down, no BN), F29
  (RetinaSepBNHead's norm an affine).

Tolerances as ``torch_port_variant_cases``: features to 1e-4 of their
largest value, losses to 1e-5 relative, gradients to 1e-4 of each leaf's
largest value, detections as sets (boxes to 5e-3 px, scores to 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import torch_port_variant_cases as C
from test_torch_port_dark_backbones import draw
from test_torch_port_zoo_heads_c import (  # noqa: F401 (the family tests)
    both_names_build,
    t,
    test_detections_match_jax,
    test_head_outputs_match_jax,
    test_loss_terms_and_gradients_match_jax,
)

from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (
    reppoints_head as TRP,
    retina_head as TR,
)
from lowlightenvironmentvideoobjectdetection_torch.models.necks import (
    extra_necks as TN,
)
from lowlightenvironmentvideoobjectdetection_torch.ops import (
    deform_conv as tdcn,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.dense_heads import (
    reppoints_head as JRP,
    retina_head as JR,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.necks import (
    extra_necks as JN,
)
from lowlightenvironmentvideoobjectdetection_tpu.ops import (
    deform_conv as jdcn,
)
from torch_port_threads import thread_count

FAMILIES = ("RepPoints", "NASFPNRetinaNet")


_pinned_threads = thread_count(1)


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request):
    return request.param, C.built(request.param)


@pytest.mark.parametrize("name", FAMILIES)
def test_both_names_build(name):
    both_names_build(name)


# ---------------------------------------------------------------------------
# NAS-FPN and RetinaSepBNHead alone
# ---------------------------------------------------------------------------

def _bridged(jmodule, tmodule, xs, seed):
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0),
                            [jnp.asarray(x) for x in xs])
    var = jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(seed)))
    tmodule.load_state_dict(from_jax_variables(var), strict=True)
    return var


def test_nasfpn_matches_jax():
    """Odd map sizes, so the cells' resizes down and up are not exact
    halvings."""
    rs = np.random.RandomState(13)
    xs = [rs.randn(1, 15, 21, 8).astype(np.float32),
          rs.randn(1, 8, 11, 12).astype(np.float32),
          rs.randn(1, 4, 6, 16).astype(np.float32)]
    jm = JN.NASFPN(out_channels=16, stack_times=2, dtype=jnp.float32)
    tm = TN.NASFPN((8, 12, 16), 16, 5, stack_times=2)
    var = _bridged(jm, tm, xs, 14)
    want = jm.apply(var, [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        got = tm([t(x).permute(0, 3, 1, 2) for x in xs])
    assert [tuple(g.shape[-2:]) for g in got] == [(15, 21), (8, 11), (4, 6),
                                                  (2, 3), (1, 2)]
    for g, w in zip(got, want):
        C.close(g.permute(0, 2, 3, 1), w)


def test_retina_sepbn_head_matches_jax():
    rs = np.random.RandomState(15)
    xs = [rs.randn(1, h, w, 16).astype(np.float32)
          for h, w in ((8, 10), (4, 5), (2, 3), (1, 2), (1, 1))]
    jm = JR.RetinaSepBNHead(num_classes=3, feat_channels=16, stacked_convs=2,
                            dtype=jnp.float32)
    tm = TR.RetinaSepBNHead(3, in_channels=16, feat_channels=16,
                            stacked_convs=2)
    var = _bridged(jm, tm, xs, 16)
    want = jm.apply(var, [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        got = tm([t(x).permute(0, 3, 1, 2) for x in xs])
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            C.close(a, b)


def test_moment_transfer_matches_jax():
    """The learnt moment transfer (its gradient scaled by 0.01) and its
    leaf through the bridge, which keeps its name."""
    rs = np.random.RandomState(17)
    pts = rs.randn(2, 5, 9, 2).astype(np.float32)
    cot = rs.randn(2, 5, 4).astype(np.float32)
    params = {"moment_transfer": np.array([0.3, -0.2], np.float32)}
    state = from_jax_variables({"params": {"mt": params}})
    assert list(state) == ["mt.moment_transfer"]
    tm = TRP.MomentTransfer()
    tm.load_state_dict({"moment_transfer": state["mt.moment_transfer"]})
    jm = JRP.MomentTransfer()
    want, jg = jax.value_and_grad(lambda p: jnp.sum(jm.apply(
        {"params": p}, jnp.asarray(pts)) * cot))(params)
    got = (tm(t(pts)) * t(cot)).sum()
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    C.close(tm.moment_transfer.grad, jg["moment_transfer"])


# ---------------------------------------------------------------------------
# RepPoints' points DCN and the departures from mmdet
# ---------------------------------------------------------------------------

def test_reppoints_dcn_offsets_and_gradient_match_jax():
    """The offsets from the initial points (``gradient_mul`` 0.1 on their
    gradient) into the DCN's plain version, forward and the points'
    gradient, against the JAX head's formula and ``deform_conv``."""
    rs = np.random.RandomState(18)
    h, w, c = 6, 7, 5
    x = rs.randn(h, w, c).astype(np.float32)
    pts = (1.5 * rs.randn(h, w, 18)).astype(np.float32)
    kern = (rs.randn(3, 3, c, 4) / 6).astype(np.float32)
    bias = (0.1 * rs.randn(4)).astype(np.float32)
    base = jnp.asarray([(dy, dx) for dy in (-1.0, 0.0, 1.0)
                        for dx in (-1.0, 0.0, 1.0)], jnp.float32).reshape(-1)
    cot = rs.randn(h, w, 4).astype(np.float32)

    def jfwd(p):
        g = 0.9 * jax.lax.stop_gradient(p) + 0.1 * p
        return jnp.sum(jdcn.deform_conv(jnp.asarray(x), g - base,
                                        jnp.asarray(kern),
                                        jnp.asarray(bias)) * cot)

    want, jgrad = jax.value_and_grad(jfwd)(jnp.asarray(pts))
    tp = t(pts).permute(2, 0, 1)[None].requires_grad_()
    off = TRP.points_offsets(tp)
    jp = jnp.asarray(pts)
    np.testing.assert_array_equal(off.detach()[0].permute(1, 2, 0).numpy(),
                                  np.asarray(0.9 * jp + 0.1 * jp - base))
    out = tdcn.deform_conv(t(x).permute(2, 0, 1)[None], off,
                           t(kern).permute(3, 2, 0, 1), t(bias))
    loss = (out[0].permute(1, 2, 0) * t(cot)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    C.close(tp.grad[0].permute(1, 2, 0), jgrad)


def test_f26_points_are_read_as_9_dy_then_9_dx():
    """The initial points are interleaved (dy, dx) a point
    (``points_to_boxes`` reads channel 2k as point k's dy), but the DCN
    reads channel k as tap k's dy: moving point 0 down one row (channel
    0) moves tap 0's sample, while channel 1, point 0's dx, moves tap 1's
    dy, in JAX as in the port (F26)."""
    h, w = 6, 7
    x = np.random.RandomState(19).randn(h, w, 1).astype(np.float32)
    kern = np.zeros((3, 3, 1, 1), np.float32)
    kern[0, 1, 0, 0] = 1.0  # tap 1 alone: (dy, dx) = (-1, 0)
    pts = np.zeros((h, w, 18), np.float32)
    base = np.asarray(TRP.BASE_GRID, np.float32)
    pts[...] = base  # the points on the base grid: zero offsets
    pts[..., 1] += 1.0  # point 0's dx + 1
    off = pts - base
    want = np.asarray(jdcn.deform_conv(jnp.asarray(x), jnp.asarray(off),
                                       jnp.asarray(kern)))[..., 0]
    got = tdcn.deform_conv(t(x).permute(2, 0, 1)[None],
                           t(off).permute(2, 0, 1)[None],
                           t(kern).permute(3, 2, 0, 1))[0, 0].numpy()
    # tap 1 samples one row lower than its base (-1, 0): the pixel itself
    np.testing.assert_allclose(want, x[..., 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    boxes = TRP.points_to_boxes(t(pts).reshape(-1, 18),
                                torch.zeros(h * w, 2), 1.0)
    jboxes = JRP.points_to_boxes(jnp.asarray(pts).reshape(-1, 18),
                                 jnp.zeros((h * w, 2)), 1.0)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=1e-6)


def test_f27_gp_cell_weights_b_by_a():
    """The JAX ``_GPCell`` is a + b * sigmoid(mean(a)); mmdet's
    GlobalPoolingCell b + sigmoid(mean(b)) * a. With the conv the
    identity, the port gives the JAX form (F27)."""
    rs = np.random.RandomState(20)
    a = rs.randn(1, 4, 5, 3).astype(np.float32)
    b = rs.randn(1, 4, 5, 3).astype(np.float32) + 1.0
    cell = TN._GPCell(3)
    with torch.no_grad():
        cell.conv.weight.zero_()
        cell.conv.weight[:, :, 1, 1] = torch.eye(3)
        cell.conv.bias.zero_()
        got = cell(t(a).permute(0, 3, 1, 2), t(b).permute(0, 3, 1, 2),
                   (4, 5)).permute(0, 2, 3, 1).numpy()
    sig = lambda v: 1 / (1 + np.exp(-v))  # noqa: E731
    jax_form = np.maximum(a + b * sig(a.mean((1, 2), keepdims=True)), 0)
    mmdet_form = np.maximum(b + sig(b.mean((1, 2), keepdims=True)) * a, 0)
    np.testing.assert_allclose(got, jax_form, rtol=1e-5, atol=1e-6)
    assert np.abs(got - mmdet_form).max() > 0.1
    jcell = JN._GPCell(3, dtype=jnp.float32)
    var = {"params": {"conv": {
        "kernel": cell.conv.weight.detach().permute(2, 3, 1, 0).numpy(),
        "bias": np.zeros(3, np.float32)}}}
    np.testing.assert_allclose(np.asarray(jcell.apply(
        var, jnp.asarray(a), jnp.asarray(b), (4, 5))), got, rtol=1e-5,
        atol=1e-6)


def test_f28_cells_resize_down_by_nearest():
    """A cell resizes a finer input down by the half-pixel nearest pick
    (``jax.image.resize`` "nearest"), not mmdet's max pool: a lone peak
    between the picked pixels vanishes (F28)."""
    x = np.zeros((1, 8, 8, 1), np.float32)
    x[0, 2, 2, 0] = 5.0  # the nearest-exact pick of 8 -> 4 reads 1, 3, ...
    want = np.asarray(JN._resize_to(jnp.asarray(x), (4, 4)))
    got = TN._resize_to(t(x).permute(0, 3, 1, 2), (4, 4)).permute(
        0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() == 0.0
    assert F.max_pool2d(t(x).permute(0, 3, 1, 2), 2).max() == 5.0
    assert not any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                   for m in TN.NASFPN((4, 4, 4), 8, 5, 1).modules())


def test_f29_sepbn_is_a_per_level_affine_on_shared_kernels():
    """RetinaSepBNHead: one conv kernel a stack for every level, and each
    level's norm the affine x * scale + bias (a BN with frozen unit
    statistics), in JAX as in the port (F29)."""
    head = TR.RetinaSepBNHead(2, in_channels=4, feat_channels=4,
                              stacked_convs=1)
    names = {n for n, _ in head.named_parameters()}
    assert {"cls_conv0.weight", "reg_conv0.weight"} <= names
    assert "cls_conv0.bias" not in names
    assert sum(n.startswith("cls_bn") for n in names) == 2 * 5
    rs = np.random.RandomState(21)
    with torch.no_grad():
        head.cls_bn1_0_scale.copy_(t(rs.rand(4).astype(np.float32) + 0.5))
        head.cls_bn1_0_bias.copy_(t(rs.randn(4).astype(np.float32)))
        x = t(rs.randn(1, 4, 3, 3).astype(np.float32))
        conv = head.cls_conv0(x)
        affine = F.relu(conv * head.cls_bn1_0_scale[:, None, None]
                        + head.cls_bn1_0_bias[:, None, None])
        bn = F.relu(F.batch_norm(conv, torch.zeros(4), torch.ones(4),
                                 head.cls_bn1_0_scale, head.cls_bn1_0_bias,
                                 eps=0.0))
        np.testing.assert_allclose(affine.numpy(), bn.numpy(), rtol=1e-6)
        feats = [x] * 5
        outs = head(feats)
        want = head.retina_cls(affine).permute(0, 2, 3, 1)
        np.testing.assert_allclose(outs[1][0].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert not torch.equal(outs[0][0], outs[1][0])
    jshapes = jax.eval_shape(
        JR.RetinaSepBNHead(num_classes=2, feat_channels=4, stacked_convs=1,
                           dtype=jnp.float32).init, jax.random.PRNGKey(0),
        [jnp.zeros((1, 3, 3, 4))] * 5)
    assert set(from_jax_variables(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), jshapes))) == {
            n for n, _ in head.named_parameters()}
