"""Port parity for DCNv2 (``ops/deform_conv.py``) against the JAX package's
``modulated_deform_conv`` (the exact gather form, ``agg_dcn_impl="scan"``)
on the CPU in f32.

Each case draws x, offsets, masks, weight and bias with numpy; the port
runs NCHW / OIHW, JAX NHWC / HWIO per image (``jax.vmap``). Tolerances: the
output to rtol 1e-5 plus an atol of 1e-5 of its largest |value| (the two
sum the 9 taps and the channels in another order); each gradient (x, the
offsets, the mask, the weight, the bias) to an atol of 1e-5 of its largest
|value| against ``jax.grad`` of the same cotangent. The closed-form
backward (``modulated_deform_conv_backward_plain``, kernels F and G's plain
version) is held against torch autograd through the plain columns.

Offsets: normal with a std of 2.5 px, clipped to +-5 (many samples beyond
the map's edge, many beyond 2 px), whole pixels (every sample on a pixel,
where the offsets' gradient is one-sided, as JAX's autodiff of ``floor``
takes it), normal with a std of 8 px unclipped ("far": the card tests'
offsets beyond kernel F's window) or every sample at one point ("one_spot").
Groups of 3 and of 12 channels are the card tests' channel counts that
kernel F's chunks of 8 do not divide; groups of 5 channels, and of 16 on a
map 5 pixels wide, those that leave kernel G channels past its last whole
chunk and a row narrower than its lanes. Fault F1: the JAX default (``agg_dcn_impl="windowed"``,
``agg_dcn_radius=2``) clamps offsets to +-2 px; the port does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lowlightenvironmentvideoobjectdetection_tpu.ops import (
    deform_conv as jdcn,
)
from lowlightenvironmentvideoobjectdetection_torch.models.aggregators import (
    denoising_aggregator as TA,
)
from lowlightenvironmentvideoobjectdetection_torch.ops import (
    deform_conv as tdcn,
)
from torch_port_threads import thread_count


REL = 1e-5
RTOL = 1e-5
# name: (images, channels, h, w, deform groups, out channels, offsets)
CASES = {
    "g1": (2, 6, 7, 9, 1, 5, "random"),
    "g2": (1, 8, 9, 6, 2, 4, "random"),
    "g8": (2, 16, 6, 11, 8, 8, "random"),
    "g8_integer": (1, 16, 8, 5, 8, 6, "integer"),
    "g2_integer": (2, 4, 5, 7, 2, 3, "integer"),
    "g2_cpg12": (2, 24, 9, 13, 2, 6, "random"),
    "g4_cpg3": (2, 12, 7, 10, 4, 5, "random"),
    "g4_cpg5": (2, 20, 7, 10, 4, 5, "random"),
    "g1_cpg16_narrow": (1, 16, 6, 5, 1, 4, "random"),
    "g8_far": (1, 16, 8, 11, 8, 6, "far"),
    "g2_one_spot": (1, 8, 9, 7, 2, 4, "one_spot"),
}


_pinned_threads = thread_count(1)


def _inputs(name, seed=0):
    n, c, h, w, g, cout, kind = CASES[name]
    rs = np.random.RandomState(seed)
    x = rs.randn(n, h, w, c).astype(np.float32)
    if kind == "integer":
        off = rs.randint(-3, 4, (n, h, w, g * 18)).astype(np.float32)
    elif kind == "far":
        off = (rs.randn(n, h, w, g * 18) * 8.0).astype(np.float32)
    elif kind == "one_spot":  # every tap's sample at (h/2 + 0.3, w/2 + 0.6)
        k = np.arange(9)
        dy = (h // 2 + 0.3) - (np.arange(h)[:, None, None] + k // 3 - 1)
        dx = (w // 2 + 0.6) - (np.arange(w)[None, :, None] + k % 3 - 1)
        dy, dx = np.broadcast_arrays(dy, dx)
        off = np.tile(np.concatenate([dy, dx], -1), (n, 1, 1, g)).reshape(
            n, h, w, g * 18).astype(np.float32)
    else:
        off = np.clip(rs.randn(n, h, w, g * 18) * 2.5, -5, 5).astype(
            np.float32)
    mask = rs.uniform(0, 1, (n, h, w, g * 9)).astype(np.float32)
    wt = (rs.randn(3, 3, c, cout) / np.sqrt(9 * c)).astype(np.float32)
    bias = rs.randn(cout).astype(np.float32)
    cot = rs.randn(n, h, w, cout).astype(np.float32)
    return dict(x=x, off=off, mask=mask, wt=wt, bias=bias, cot=cot, g=g)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _jax_dcn(x, off, mask, wt, bias, g, fn=jdcn.modulated_deform_conv,
             **kw):
    return jax.vmap(lambda a, o, m: fn(a, o, m, wt, bias, deform_groups=g,
                                       **kw))(x, off, mask)


def _jax_case(d):
    def loss(x, off, mask, wt, bias):
        out = _jax_dcn(x, off, mask, wt, bias, d["g"])
        return jnp.sum(out * d["cot"]), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        d["x"], d["off"], d["mask"], d["wt"], d["bias"])
    return np.asarray(out), [np.asarray(a) for a in grads]


def _port_case(d):
    x, off, mask = (_nchw(d[k]).requires_grad_() for k in ("x", "off",
                                                           "mask"))
    wt = torch.from_numpy(d["wt"].transpose(3, 2, 0, 1).copy()
                          ).requires_grad_()
    bias = torch.from_numpy(d["bias"]).requires_grad_()
    out = tdcn.modulated_deform_conv(x, off, mask, wt, bias)
    out.backward(_nchw(d["cot"]))
    to_nhwc = lambda t: t.detach().numpy().transpose(0, 2, 3, 1)  # noqa
    return (to_nhwc(out), [to_nhwc(x.grad), to_nhwc(off.grad),
                           to_nhwc(mask.grad),
                           wt.grad.numpy().transpose(2, 3, 1, 0),
                           bias.grad.numpy()])


def _close(got, want, rtol=0.0, what=""):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=REL * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_dcn_forward_and_gradients_match_jax(name):
    d = _inputs(name)
    jout, jgrads = _jax_case(d)
    tout, tgrads = _port_case(d)
    assert tout.dtype == np.float32
    _close(tout, jout, RTOL, "out")
    for what, got, want in zip(("x", "offset", "mask", "weight", "bias"),
                               tgrads, jgrads):
        assert np.abs(want).max() > 0, what
        _close(got, want, what=what)


def test_dcn_samples_outside_the_map():
    """The random cases put samples beyond every edge and offsets beyond
    2 px; an edge sample fades with its corners."""
    d = _inputs("g8")
    n, h, w = d["x"].shape[:3]
    off = d["off"].reshape(n, h, w, 8, 2, 9)
    ys = np.arange(h)[None, :, None, None, None] + off[..., 0, :]
    xs = np.arange(w)[None, None, :, None, None] + off[..., 1, :]
    outside = (ys < -1) | (ys > h) | (xs < -1) | (xs > w)
    assert 0.05 < outside.mean() < 0.6
    assert (np.abs(d["off"]) > 2).mean() > 0.3
    # one sample at y = -0.5 of a map of ones takes half of row 0
    x = torch.ones(1, 1, 3, 3)
    off = torch.zeros(1, 18, 3, 3)
    off[0, 4, 0, 1] = -0.5  # centre tap's dy at pixel (0, 1)
    wt = torch.zeros(1, 1, 3, 3)
    wt[0, 0, 1, 1] = 1.0
    out = tdcn.modulated_deform_conv(x, off, torch.ones(1, 9, 3, 3), wt)
    assert out[0, 0, 0, 1].item() == 0.5 and out[0, 0, 0, 0].item() == 1.0


@pytest.mark.parametrize("name", ["g1", "g2", "g8", "g8_integer",
                                  "g2_cpg12", "g4_cpg3", "g4_cpg5",
                                  "g1_cpg16_narrow", "g8_far",
                                  "g2_one_spot"])
def test_closed_form_backward_matches_autograd(name):
    """Kernels F and G's plain version against torch autograd through the
    plain columns, for x, the offsets and the mask."""
    d = _inputs(name, seed=1)
    x, off, mask = (_nchw(d[k]).requires_grad_() for k in ("x", "off",
                                                           "mask"))
    cols = tdcn.deform_columns_plain(x, off, mask)
    grad_cols = torch.from_numpy(
        np.random.RandomState(2).randn(*cols.shape).astype(np.float32))
    want = torch.autograd.grad(cols, (x, off, mask), grad_cols)
    got = tdcn.modulated_deform_conv_backward_plain(
        grad_cols, x.detach(), off.detach(), mask.detach())
    # CPU tensors take the plain versions behind the kernels' entries
    again = tdcn.modulated_deform_conv_backward(
        grad_cols, x.detach(), off.detach(), mask.detach())
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert torch.equal(g, a)
        _close(g.numpy(), w.numpy())
    assert torch.equal(tdcn.deform_columns(x, off, mask), cols)


def test_f1_port_is_scan_not_the_windowed_default():
    """F1: with offsets within 2 px the JAX windowed form (radius 2, the
    JAX ``DarkfarmConfig`` default) equals the scan form and the port; with
    offsets beyond 2 px it clamps them and the port (unbounded, as the
    original) follows the scan form."""
    d = _inputs("g8")
    small = dict(d, off=np.clip(d["off"], -1.9, 1.9))
    for case, within in ((small, True), (d, False)):
        a = [case[k] for k in ("x", "off", "mask", "wt", "bias")]
        scan = np.asarray(_jax_dcn(*a, 8))
        windowed = np.asarray(_jax_dcn(
            *a, 8, fn=jdcn.modulated_deform_conv_windowed, radius=2))
        port = tdcn.modulated_deform_conv(
            _nchw(a[0]), _nchw(a[1]), _nchw(a[2]),
            torch.from_numpy(a[3].transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(a[4])).numpy().transpose(0, 2, 3, 1)
        _close(port, scan, RTOL)
        diff = np.abs(windowed - scan).max() / np.abs(scan).max()
        if within:
            assert diff < 1e-4
        else:
            assert diff > 1e-2


def test_dcnv1_is_the_mask_one_case():
    """``deform_conv`` (DCNv1) against the JAX ``deform_conv``."""
    d = _inputs("g2")
    jout = np.asarray(jax.vmap(lambda a, o: jdcn.deform_conv(
        a, o, d["wt"], d["bias"], deform_groups=2))(d["x"], d["off"]))
    got = tdcn.deform_conv(
        _nchw(d["x"]), _nchw(d["off"]),
        torch.from_numpy(d["wt"].transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(d["bias"])).numpy().transpose(0, 2, 3, 1)
    _close(got, jout, RTOL)


def test_fresh_dcn_pack_is_half_a_plain_conv():
    """A fresh port ``ModulatedDCNPack``: ``conv_offset`` zero, so every
    offset is 0 and every mask sigmoid(0) = 1/2: half a plain 3x3 conv plus
    the bias, as the JAX test_dcn_pack_zero_init_is_half_conv; the weight
    takes flax's variance_scaling(1, fan_in, uniform)."""
    torch.manual_seed(0)
    pack = TA.ModulatedDCNPack(8, 6, extra_channels=5, deform_groups=8)
    assert pack.groups == 8
    assert not pack.conv_offset.weight.any()
    assert not pack.conv_offset.bias.any()
    limit = np.sqrt(3.0 / (9 * 8))
    assert 0.8 * limit < pack.weight.abs().max().item() <= limit
    with torch.no_grad():
        pack.bias.normal_()
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.uniform(-1, 1, (2, 8, 7, 9)).astype(np.float32))
    extra = torch.from_numpy(rs.uniform(-1, 1, (2, 5, 7, 9)).astype(
        np.float32))
    got = pack(x, extra)
    want = F.conv2d(x, pack.weight, padding=1) * 0.5 + pack.bias[:, None,
                                                                 None]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert TA.ModulatedDCNPack(12, 4, 4).groups == 4


def test_dcn_entry_rejects():
    """An unknown impl, a device without a kernel, mismatched shapes and
    a weight of the wrong width raise."""
    x = torch.randn(1, 8, 5, 6)
    off, mask = torch.zeros(1, 36, 5, 6), torch.ones(1, 18, 5, 6)
    wt = torch.randn(4, 8, 3, 3)
    with pytest.raises(ValueError):
        tdcn.modulated_deform_conv(x, off, mask, wt, impl="windowed")
    with pytest.raises(RuntimeError):
        tdcn.modulated_deform_conv(x.to("meta"), off.to("meta"),
                                   mask.to("meta"), wt.to("meta"))
    with pytest.raises(ValueError):
        tdcn.modulated_deform_conv(x, off[:, :30], mask, wt)
    with pytest.raises(ValueError):
        tdcn.modulated_deform_conv(x[:, :7], off, mask, wt[:, :7])
    with pytest.raises(ValueError):
        tdcn.modulated_deform_conv(x, off, mask, wt[:, :4])
