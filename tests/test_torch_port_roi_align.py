"""Port parity: RoIAlign (plain torch version of kernel B) against the JAX
package's ``roi_align_matmul``, batched ``roi_align`` and the Pallas
``roi_align_pallas`` in interpret mode, with out-of-image, edge and
zero-area rois; its gradient with respect to the maps (torch autograd
through the plain version, and kernel D's plain version
``roi_align_backward_plain``) against ``jax.grad``. f32, atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_tpu.ops.roi_align import (
    roi_align as jax_roi_align,
    roi_align_matmul as jax_roi_align_matmul,
)
from lowlightenvironmentvideoobjectdetection_tpu.ops.roi_align_pallas import (
    roi_align_pallas as jax_roi_align_pallas,
)
from lowlightenvironmentvideoobjectdetection_torch.ops.roi_align import (
    _roi_align_body,
    roi_align,
    roi_align_backward,
    roi_align_backward_plain,
    roi_align_plain,
)
from torch_port_threads import thread_count

ATOL = 1e-5
STRIDE = 16


_pinned_threads = thread_count(1)


def _rois(rng, n, h, w):
    """Random rois in image coordinates plus deliberate corner cases."""
    x1 = rng.uniform(-40, w * STRIDE, n)
    y1 = rng.uniform(-40, h * STRIDE, n)
    bw = rng.uniform(1, 200, n)
    bh = rng.uniform(1, 200, n)
    rois = np.stack([x1, y1, x1 + bw, y1 + bh], 1)
    special = np.array([
        [-100.0, -100.0, -50.0, -60.0],          # fully outside, top-left
        [w * STRIDE + 30, 5, w * STRIDE + 90, 50],  # fully outside, right
        [-30.0, -20.0, 60.0, 70.0],               # partly outside
        [w * STRIDE - 40, h * STRIDE - 30, w * STRIDE + 50, h * STRIDE + 40],
        [50.0, 40.0, 50.0, 40.0],                 # zero area
        [0.0, 0.0, w * STRIDE, h * STRIDE],       # whole map
        [12.0, 30.0, 12.0, 90.0],                 # zero width
    ])
    return np.concatenate([special, rois]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_single_map_matches_matmul_and_pallas(seed):
    rng = np.random.RandomState(seed)
    h, w, c = 9, 13, 8
    feat = rng.randn(h, w, c).astype(np.float32)
    rois = _rois(rng, 21, h, w)
    got = roi_align(torch.from_numpy(feat), torch.from_numpy(rois),
                    1.0 / STRIDE).numpy()
    want = jax_roi_align_matmul(jnp.asarray(feat), jnp.asarray(rois),
                                1.0 / STRIDE)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    want_p = jax_roi_align_pallas(jnp.asarray(feat), jnp.asarray(rois),
                                  1.0 / STRIDE, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want_p), rtol=0, atol=ATOL)
    assert got.shape == (rois.shape[0], 7, 7, c)


def test_batched_maps_match_jax_gather():
    rng = np.random.RandomState(2)
    b, h, w, c = 3, 8, 11, 6
    feats = rng.randn(b, h, w, c).astype(np.float32)
    rois = _rois(rng, 17, h, w)
    binds = rng.randint(0, b, rois.shape[0]).astype(np.int32)
    got = roi_align(torch.from_numpy(feats), torch.from_numpy(rois),
                    1.0 / STRIDE, batch_inds=torch.from_numpy(binds)).numpy()
    want = jax_roi_align(jnp.asarray(feats), jnp.asarray(rois), 1.0 / STRIDE,
                         batch_inds=jnp.asarray(binds))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_fully_outside_rois_are_zero():
    feat = torch.ones(6, 6, 4)
    rois = torch.tensor([[-200.0, -200.0, -120.0, -150.0],
                         [500.0, 500.0, 600.0, 650.0]])
    assert roi_align(feat, rois, 1.0 / STRIDE).abs().max().item() == 0.0


def test_output_dtype_follows_features():
    feat = torch.randn(5, 7, 4).bfloat16()
    rois = torch.tensor([[0.0, 0.0, 40.0, 50.0]])
    out = roi_align(feat, rois, 1.0 / STRIDE)
    assert out.dtype == torch.bfloat16
    ref = roi_align(feat.float(), rois, 1.0 / STRIDE)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=0,
                               atol=2e-2)


def test_rejects_unknown_impl():
    with pytest.raises(ValueError):
        roi_align(torch.zeros(4, 4, 2), torch.zeros(1, 4), 1.0, impl="xla")


@pytest.mark.parametrize("out_size,sr,body", [(7, 2, "gather7x2"),
                                              (14, 2, "gather14x2")])
def test_kernel_body_by_size(out_size, sr, body):
    assert _roi_align_body(out_size, sr) == body


@pytest.mark.parametrize("out_size,sr", [(5, 3), (7, 1), (14, 3), (7, 0),
                                         (2, 7)])
def test_no_kernel_body_raises(out_size, sr):
    with pytest.raises(ValueError):
        _roi_align_body(out_size, sr)


def test_kernel_path_never_falls_back_to_plain():
    """A tensor on neither the CPU nor a card reaches the kernel path, which
    raises: for a size with no body first, then for the device."""
    feat = torch.zeros(4, 4, 8, device="meta")
    rois = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError):
        roi_align(feat, rois, 1.0, out_size=5, sampling_ratio=3)
    with pytest.raises(RuntimeError):
        roi_align(feat, rois, 1.0)


def test_plain_needs_batch_inds_for_a_batch_of_maps():
    rois = torch.tensor([[0.0, 0.0, 40.0, 50.0]])
    with pytest.raises(ValueError):
        roi_align_plain(torch.zeros(2, 5, 7, 4), rois, 1.0 / STRIDE)
    one = torch.randn(1, 5, 7, 4)  # a batch of one map reads that map
    torch.testing.assert_close(roi_align_plain(one, rois, 1.0 / STRIDE),
                               roi_align_plain(one[0], rois, 1.0 / STRIDE),
                               rtol=0, atol=0)


def test_int32_and_int64_batch_inds_agree():
    rng = np.random.RandomState(4)
    feats = torch.from_numpy(rng.randn(3, 8, 11, 6).astype(np.float32))
    rois = torch.from_numpy(_rois(rng, 9, 8, 11))
    binds = rng.randint(-2, 5, rois.shape[0])  # some out of range: clamped
    got64 = roi_align(feats, rois, 1.0 / STRIDE,
                      batch_inds=torch.from_numpy(binds.astype(np.int64)))
    got32 = roi_align(feats, rois, 1.0 / STRIDE,
                      batch_inds=torch.from_numpy(binds.astype(np.int32)))
    torch.testing.assert_close(got32, got64, rtol=0, atol=0)
    clamped = roi_align(feats, rois, 1.0 / STRIDE,
                        batch_inds=torch.from_numpy(np.clip(binds, 0, 2)))
    torch.testing.assert_close(got64, clamped, rtol=0, atol=0)


def _feature_grad(feats, rois, binds, w):
    """The port's gradient of sum(roi_align(feats) * w) over the maps."""
    f = torch.from_numpy(feats).requires_grad_()
    out = roi_align(f, torch.from_numpy(rois), 1.0 / STRIDE,
                    batch_inds=None if binds is None
                    else torch.from_numpy(binds))
    (out * torch.from_numpy(w)).sum().backward()
    return f.grad.numpy()


@pytest.mark.parametrize("batched", [False, True])
def test_feature_gradient_matches_jax_grad(batched):
    """The plain version's gradient with respect to the maps (torch
    autograd) against ``jax.grad`` of the JAX ``roi_align`` with the rois
    held constant: a single map and a batch of maps. f32, atol 1e-5
    (summation order)."""
    rng = np.random.RandomState(5 + batched)
    h, w, c = 8, 11, 6
    feats = rng.randn(*((3,) if batched else ()), h, w, c).astype(np.float32)
    rois = _rois(rng, 19, h, w)
    binds = (rng.randint(0, 3, rois.shape[0]).astype(np.int32) if batched
             else None)
    wts = rng.randn(rois.shape[0], 7, 7, c).astype(np.float32)

    def f(x):
        out = jax_roi_align(x, jnp.asarray(rois), 1.0 / STRIDE,
                            batch_inds=None if binds is None
                            else jnp.asarray(binds))
        return jnp.sum(out * wts)

    want = np.asarray(jax.grad(f)(jnp.asarray(feats)))
    got = _feature_grad(feats, rois, binds, wts)
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_rois_that_require_grad_raise():
    """No gradient for the rois (mmcv's semantics, not the JAX package's):
    rois that require one raise, on every device; detached rois pass."""
    feat = torch.randn(6, 7, 4, requires_grad=True)
    rois = torch.tensor([[0.0, 0.0, 40.0, 50.0]], requires_grad=True)
    with pytest.raises(ValueError):
        roi_align(feat, rois, 1.0 / STRIDE)
    with pytest.raises(ValueError):
        roi_align(feat.detach().to("meta"), rois.detach().to("meta")
                  .requires_grad_(), 1.0 / STRIDE)
    out = roi_align(feat, rois.detach(), 1.0 / STRIDE)
    assert out.requires_grad
    with torch.no_grad():  # no graph, nothing to differentiate
        roi_align(feat, rois, 1.0 / STRIDE)


def _edge_rois(h, w):
    """Rois whose samples fall exactly on -1, 0, size - 1 and size, or just
    beyond (-1.0625, size + 0.0625), on each axis, in image coordinates."""
    img = lambda v: (v + 0.5) * STRIDE  # noqa: E731  map -> image
    rows = []
    for axis, size in ((0, w), (1, h)):
        for v in (-1.0, 0.0, size - 1.0, float(size), -1.0625, size + 0.0625):
            r = [img(2.0), img(3.0), img(5.5), img(7.25)]
            r[axis] = r[axis + 2] = img(v)
            rows.append(r)
    rows += [[img(-1.0), img(-1.0), img(w), img(h)],
             [img(0.0), img(0.0), img(w - 1.0), img(h - 1.0)]]
    return np.asarray(rows, np.float32)


@pytest.mark.parametrize("out_size", [7, 14])
@pytest.mark.parametrize("case", ["single", "batched", "edges"])
def test_backward_plain_matches_autograd_and_jax_grad(case, out_size):
    """Kernel D's plain version (the separable form, ``index_add_``)
    against torch autograd through ``roi_align_plain`` and against
    ``jax.grad`` of the JAX ``roi_align`` with the rois held constant: a
    single map with out-of-image, edge, zero-area and zero-width rois, a
    batch of maps with out-of-range map indices (clamped), and rois whose
    samples fall exactly on the range's edges. f32, atol 1e-5 (summation
    order); the incoming gradient is scaled to keep max |grad| near 1-10."""
    rng = np.random.RandomState(11 + out_size + len(case))
    h, w, c = 9, 13, 6
    batched = case == "batched"
    feats = rng.randn(*((3,) if batched else ()), h, w, c).astype(np.float32)
    rois = _edge_rois(h, w) if case == "edges" else _rois(rng, 19, h, w)
    binds = (rng.randint(-2, 5, rois.shape[0]).astype(np.int32) if batched
             else None)
    wts = (0.25 * rng.randn(rois.shape[0], out_size, out_size, c)
           ).astype(np.float32)
    tb = None if binds is None else torch.from_numpy(binds)
    got = roi_align_backward_plain(torch.from_numpy(wts),
                                   torch.from_numpy(rois), tb, feats.shape,
                                   1.0 / STRIDE, out_size, 2)
    assert got.dtype == torch.float32 and got.shape == feats.shape

    f = torch.from_numpy(feats).requires_grad_()
    out = roi_align_plain(f, torch.from_numpy(rois), 1.0 / STRIDE, tb,
                          out_size, 2)
    (out * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(got.numpy(), f.grad.numpy(), rtol=0,
                               atol=ATOL)

    def fn(x):
        out = jax_roi_align(x, jnp.asarray(rois), 1.0 / STRIDE,
                            out_size=out_size,
                            batch_inds=None if binds is None
                            else jnp.asarray(np.clip(binds, 0, 2)))
        return jnp.sum(out * wts)

    want = np.asarray(jax.grad(fn)(jnp.asarray(feats)))
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_backward_on_cpu_takes_the_plain_version():
    """``roi_align_backward`` on CPU tensors is its plain version, bf16
    grad_out summed in f32 and cast once; it counts no launch."""
    rng = np.random.RandomState(3)
    rois = torch.from_numpy(_rois(rng, 9, 8, 11))
    grad_out = torch.from_numpy(
        rng.randn(rois.shape[0], 7, 7, 8).astype(np.float32))
    before = roi_align_backward.launches
    for dtype in (torch.float32, torch.bfloat16):
        got = roi_align_backward(grad_out.to(dtype), rois, None, (8, 11, 8),
                                 1.0 / STRIDE)
        want = roi_align_backward_plain(grad_out.to(dtype), rois, None,
                                        (8, 11, 8), 1.0 / STRIDE)
        assert got.dtype == dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert roi_align_backward.launches == before
    with pytest.raises(ValueError):  # a batch of maps needs batch_inds
        roi_align_backward_plain(grad_out, rois, None, (2, 8, 11, 8),
                                 1.0 / STRIDE)


def test_backward_kernel_body_by_size():
    assert _roi_align_body(7, 2, "scatter") == "scatter7x2"
    assert _roi_align_body(14, 2, "scatter") == "scatter14x2"
    with pytest.raises(ValueError):
        _roi_align_body(5, 3, "scatter")


def test_no_rois_stay_in_the_autograd_graph():
    """Zero rois give an empty output that back-propagates a zero gradient
    (the card's kernel path does the same without a launch)."""
    feat = torch.randn(5, 6, 8, requires_grad=True)
    out = roi_align(feat, torch.zeros(0, 4), 1.0 / STRIDE)
    assert out.shape == (0, 7, 7, 8) and out.requires_grad
    out.sum().backward()
    assert feat.grad is not None and not feat.grad.any()
