"""RoIAlign (avg mode) over NHWC maps: the plain torch version and the CUDA
kernels ``csrc/roi_align.cu`` behind one entry.

Counterpart of the JAX package's ``ops/roi_align.py`` (``roi_align_matmul``
and the batched ``roi_align``) and of its TPU kernel
``ops/roi_align_pallas.py::roi_align_pallas``, in the form every caller uses:
``aligned=True`` (half-pixel offset). A CPU tensor takes the plain version
(under torch autograd); a CUDA tensor launches the kernels or raises.

On CUDA tensors the forward is kernel B and the gradient of the maps is
kernel D (``roi_align_backward``), joined by a ``torch.autograd.Function``;
kernel D's plain version is ``roi_align_backward_plain``, which
``roi_align_backward`` takes for CPU tensors.
As mmcv's RoIAlign, the op gives no gradient for the rois, so ``roi_align``
raises where the rois require one: the JAX package differentiates its
sample weights with respect to the rois (ROADMAP fault F6), the original
and the port do not.

Each kernel has one body per (out_size, sampling_ratio) it is compiled for
(``_roi_align_body``): B gathers (``gather7x2`` for the box head's 7x7,
``gather14x2`` for the mask heads' 14x14, ``gather28x2`` for the mask
targets: scalar loads, so 1-channel float32 masks, and no D body, since
the targets take no gradient), D scatters (``scatter7x2``,
``scatter14x2``). ``roi_align.launches`` and
``roi_align_backward.launches`` count the launches, their
``body_launches`` the launches per body.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # channels per 16-byte vector
_BODIES = {(7, 2): "7x2", (14, 2): "14x2", (28, 2): "28x2"}
# bodies that read one float32 channel at a time (any channel count), and
# have no backward
_SCALAR_BODIES = {(28, 2)}
_OFFSET = 0.5  # aligned=True
_CHUNK = 64  # rois per gather step of the plain version (bounds its memory)


def _roi_align_body(out_size: int, sampling_ratio: int,
                    kind: str = "gather") -> str:
    """The body of kernel B (``kind="gather"``) or D (``"scatter"``) for an
    output size and sampling ratio; raises ``ValueError`` for a pair the
    kernel is not compiled for."""
    pairs = set(_BODIES) - (_SCALAR_BODIES if kind == "scatter" else set())
    if (out_size, sampling_ratio) not in pairs:
        raise ValueError(
            f"roi_align kernel: no {kind} body for out_size={out_size}, "
            f"sampling_ratio={sampling_ratio} (compiled for "
            f"{sorted(pairs)})")
    return kind + _BODIES[(out_size, sampling_ratio)]


def _axis_samples(lo, length, size: int, out_size: int, sr: int):
    """Per-roi sample table along one axis: ([n, out*sr] corner indices c0,
    c1 and weights w0, w1), zero weights for out-of-range samples."""
    dev = lo.device
    bins = torch.arange(out_size, dtype=torch.float32, device=dev)
    sub = (torch.arange(sr, dtype=torch.float32, device=dev) + 0.5) / sr
    pos = (bins[:, None] + sub[None, :]).reshape(-1)  # [out*sr]
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, which rounds the bin size differently from a true division
    bin_len = length / torch.full_like(length, float(out_size))
    x = lo[:, None] + pos[None, :] * bin_len[:, None]
    oob = (x < -1.0) | (x > size)
    xc = x.clamp(0.0, size - 1.0)
    f0 = torch.floor(xc)
    f1 = torch.clamp(f0 + 1.0, max=size - 1.0)
    l = xc - f0
    w0 = torch.where(oob, 0.0, 1.0 - l)
    w1 = torch.where(oob, 0.0, l)
    return f0.long(), f1.long(), w0, w1


def roi_align_plain(
    feats: torch.Tensor,
    rois: torch.Tensor,
    spatial_scale: float,
    batch_inds: Optional[torch.Tensor] = None,
    out_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """Plain torch RoIAlign: 4-corner gathers, f32 arithmetic, the feature
    dtype out. feats: [H, W, C] or [B, H, W, C]; rois: [N, 4];
    batch_inds: [N] map index per roi, clamped to [0, B - 1]; required for
    a batch of more than one map. Returns [N, out_size, out_size, C]."""
    maps = feats if feats.ndim == 4 else feats[None]
    b, h, w, c = maps.shape
    if batch_inds is None and b != 1:
        raise ValueError("roi_align: batch_inds required for a batch of maps")
    n = rois.shape[0]
    sr = sampling_ratio
    flat = maps.reshape(b * h * w, c)
    r = rois.float() * spatial_scale - _OFFSET
    x1, y1, x2, y2 = r.unbind(-1)
    rw, rh = x2 - x1, y2 - y1
    y0, y1i, wy0, wy1 = _axis_samples(y1, rh, h, out_size, sr)
    x0, x1i, wx0, wx1 = _axis_samples(x1, rw, w, out_size, sr)
    if batch_inds is None:
        base = torch.zeros((n,), dtype=torch.long, device=feats.device)
    else:
        base = batch_inds.long().clamp(0, b - 1) * (h * w)
    outs = []
    for s in range(0, n, _CHUNK):
        e = min(s + _CHUNK, n)
        acc = 0.0
        for ys, wy in ((y0, wy0), (y1i, wy1)):
            for xs, wx in ((x0, wx0), (x1i, wx1)):
                # [m, out*sr (y), out*sr (x)] flat row index and weight
                idx = (base[s:e, None, None] + ys[s:e, :, None] * w
                       + xs[s:e, None, :])
                wt = wy[s:e, :, None] * wx[s:e, None, :]
                acc = acc + flat[idx].float() * wt[..., None]
        m = e - s
        acc = acc.reshape(m, out_size, sr, out_size, sr, c).mean(dim=(2, 4))
        outs.append(acc.to(feats.dtype))
    if not outs:  # no rois: an empty output still in the autograd graph
        return flat[:0].reshape(0, out_size, out_size, c)
    return torch.cat(outs)


def roi_align(
    feats: torch.Tensor,
    rois: torch.Tensor,
    spatial_scale: float,
    batch_inds: Optional[torch.Tensor] = None,
    out_size: int = 7,
    sampling_ratio: int = 2,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """RoIAlign over one map [H, W, C] or a batch [B, H, W, C] (with
    ``batch_inds``). Returns [N, out_size, out_size, C] in the feature dtype,
    differentiable with respect to ``feats`` only: rois that require a
    gradient raise ``ValueError`` (detach them).

    CPU tensors take ``roi_align_plain``; CUDA tensors launch kernel B's
    body for (out_size, sampling_ratio), (7, 2), (14, 2) or (28, 2) (float32
    only, no gradient), and kernel D's for the gradient, and raise
    ``ValueError`` for any other pair.
    ``impl="plain"`` forces the plain version (for comparisons only)."""
    if impl not in (None, "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    if rois.requires_grad and torch.is_grad_enabled():
        raise ValueError("roi_align: no gradient for the rois; detach them")
    if impl == "plain" or feats.device.type == "cpu":
        return roi_align_plain(feats, rois, spatial_scale, batch_inds,
                               out_size, sampling_ratio)
    grad = torch.is_grad_enabled() and feats.requires_grad
    if grad:  # a gradient needs kernel D's body for the pair
        _roi_align_body(out_size, sampling_ratio, "scatter")
    _, rois_c, binds = _check(feats.device, feats.dtype, feats.shape, rois,
                              batch_inds, out_size, sampling_ratio)
    if grad:
        return _RoIAlign.apply(feats, rois_c, binds, spatial_scale, out_size,
                               sampling_ratio)
    return _roi_align_cuda(feats, rois_c, binds, spatial_scale, out_size,
                           sampling_ratio)


class _RoIAlign(torch.autograd.Function):
    """Kernel B forward, kernel D backward (the maps' gradient only), on
    operands that ``_check`` passed."""

    @staticmethod
    def forward(ctx, feats, rois, binds, spatial_scale, out_size,
                sampling_ratio):
        ctx.save_for_backward(rois, binds)
        ctx.args = (feats.shape, spatial_scale, out_size, sampling_ratio)
        return _roi_align_cuda(feats, rois, binds, spatial_scale, out_size,
                               sampling_ratio)

    @staticmethod
    def backward(ctx, grad_out):
        rois_c, binds = ctx.saved_tensors
        shape, spatial_scale, out_size, sampling_ratio = ctx.args
        grad = roi_align_backward(grad_out.contiguous(), rois_c, binds,
                                  shape, spatial_scale, out_size,
                                  sampling_ratio)
        return grad, None, None, None, None, None


def _roi_align_cuda(feats, rois, binds, spatial_scale, out_size,
                    sampling_ratio):
    """Launch kernel B's body for (out_size, sampling_ratio) on operands
    that ``_check`` passed."""
    scalar = (out_size, sampling_ratio) in _SCALAR_BODIES
    if not feats.is_contiguous() or (feats.data_ptr() % 16 and not scalar):
        raise ValueError("roi_align kernel: the maps must be contiguous on a "
                         "16-byte boundary")
    maps = feats.view((-1,) + tuple(feats.shape[-3:]))
    out = torch.empty((rois.shape[0], out_size, out_size, maps.shape[-1]),
                      dtype=feats.dtype, device=feats.device)
    if out.shape[0] == 0:
        return out
    body = _roi_align_body(out_size, sampling_ratio)
    lib = cuda_build.load_library()
    status = lib.llvod_roi_align(
        maps.data_ptr(), rois.data_ptr(), _ptr(binds), out.data_ptr(),
        *maps.shape, out.shape[0], float(spatial_scale), _OFFSET, out_size,
        sampling_ratio, _DTYPES[feats.dtype], _stream(feats))
    cuda_build.check(status, "llvod_roi_align")
    roi_align.launches += 1
    roi_align.body_launches[body] += 1
    return out


def _check(device, dtype, feat_shape, rois, batch_inds, out_size,
           sampling_ratio):
    """Check what kernels B and D take: maps of ``feat_shape`` ([H, W, C]
    or [B, H, W, C]) in ``dtype`` on ``device``, float32 rois [N, 4] and
    map indices [N]. Returns the map shape as (B, H, W, C), the rois
    contiguous and the map indices as int64 (or None). The kernels read
    int64 map indices in place; int32 ones are widened here (no caller of
    the main path passes them)."""
    _roi_align_body(out_size, sampling_ratio)
    if device.type != "cuda":
        raise RuntimeError(f"roi_align: no kernel for device {device}")
    if dtype not in _DTYPES:
        raise TypeError(f"roi_align: feature dtype {dtype} not supported")
    if len(feat_shape) not in (3, 4) or rois.ndim != 2 or rois.shape[-1] != 4:
        raise ValueError(f"roi_align: bad shapes {tuple(feat_shape)}, "
                         f"{tuple(rois.shape)}")
    shape = (1,) * (4 - len(feat_shape)) + tuple(feat_shape)
    b, h, w, c = shape
    if (out_size, sampling_ratio) in _SCALAR_BODIES:
        if dtype != torch.float32:
            raise TypeError(f"roi_align kernel: the {out_size}x"
                            f"{sampling_ratio} body takes float32 maps, not "
                            f"{dtype}")
    elif c % _VEC[dtype]:
        raise ValueError(f"roi_align kernel: {c} channels of {dtype} must be "
                         "whole 16-byte vectors")
    if h * w * c >= 2 ** 31:
        raise ValueError("roi_align kernel: a map of 2^31 elements or more")
    n = rois.shape[0]
    if rois.device != device or rois.dtype != torch.float32:
        raise TypeError("roi_align kernel: rois must be float32 on the map's "
                        "device")
    binds = None
    if batch_inds is not None:
        if batch_inds.shape != (n,) or batch_inds.device != device:
            raise ValueError("roi_align kernel: batch_inds must be [N] on the "
                             "map's device")
        if batch_inds.dtype not in (torch.int32, torch.int64):
            raise TypeError("roi_align kernel: batch_inds must be int32 or "
                            "int64")
        binds = batch_inds.to(torch.int64).contiguous()
    elif b != 1:
        raise ValueError("roi_align: batch_inds required for a batch of maps")
    return shape, rois.contiguous(), binds


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _axis_weights(lo, length, size: int, out_size: int, sr: int):
    """The separable weights along one axis over a window of each roi's
    pixels: ([n, out_size, extent] per-bin weights, the sr samples' corner
    weights summed at their pixels with the mean's 1 / sr folded in,
    [n] first pixel of each window); ``extent`` spans the widest roi."""
    i0, i1, w0, w1 = _axis_samples(lo, length, size, out_size, sr)
    first = i0.min(1).values  # the high corner is never below the low one
    extent = int((i1.max(1).values - first).max()) + 1
    a = torch.zeros(lo.shape[0], out_size * sr, extent, device=lo.device)
    a.scatter_add_(2, (i0 - first[:, None])[..., None], w0[..., None])
    a.scatter_add_(2, (i1 - first[:, None])[..., None], w1[..., None])
    a = a.view(lo.shape[0], out_size, sr, extent).sum(2) * (1.0 / sr)
    return a, first


def roi_align_backward_plain(grad_out: torch.Tensor, rois: torch.Tensor,
                             batch_inds: Optional[torch.Tensor], feat_shape,
                             spatial_scale: float, out_size: int = 7,
                             sampling_ratio: int = 2) -> torch.Tensor:
    """Plain torch version of kernel D, with ``roi_align_backward``'s
    signature: the maps' gradient in the separable form the kernel uses.
    Per roi, ``_axis_weights`` gives Ay [out, window rows] and Ax [out,
    window columns]; T = Ax-contraction of grad_out over the column bins,
    then dF = Ay^T T over the row bins, both in f32, added to the maps with
    ``index_add_`` (64 rois at a time) and cast once to grad_out's dtype.
    Samples out of range add nothing, map indices clamp to [0, B - 1]."""
    b, h, w, c = (1,) * (4 - len(feat_shape)) + tuple(feat_shape)
    if batch_inds is None and b != 1:
        raise ValueError("roi_align: batch_inds required for a batch of maps")
    dev = grad_out.device
    acc = torch.zeros(b * h * w, c, dtype=torch.float32, device=dev)
    r = rois.float() * spatial_scale - _OFFSET
    x1, y1, x2, y2 = r.unbind(-1)
    base = (torch.zeros(rois.shape[0], dtype=torch.long, device=dev)
            if batch_inds is None
            else batch_inds.long().clamp(0, b - 1) * (h * w))
    for s in range(0, rois.shape[0], _CHUNK):
        e = min(s + _CHUNK, rois.shape[0])
        ay, ylo = _axis_weights(y1[s:e], (y2 - y1)[s:e], h, out_size,
                                sampling_ratio)
        ax, xlo = _axis_weights(x1[s:e], (x2 - x1)[s:e], w, out_size,
                                sampling_ratio)
        t = torch.einsum("nqx,npqc->npxc", ax, grad_out[s:e].float())
        d = torch.einsum("npy,npxc->nyxc", ay, t)
        ys = ylo[:, None] + torch.arange(ay.shape[-1], device=dev)
        xs = xlo[:, None] + torch.arange(ax.shape[-1], device=dev)
        inside = (ys < h)[:, :, None] & (xs < w)[:, None, :]
        idx = base[s:e, None, None] + ys[:, :, None] * w + xs[:, None, :]
        acc.index_add_(0, idx[inside], d[inside])
    return acc.to(grad_out.dtype).reshape(feat_shape)


def roi_align_backward(grad_out: torch.Tensor, rois: torch.Tensor,
                       batch_inds: Optional[torch.Tensor], feat_shape,
                       spatial_scale: float, out_size: int = 7,
                       sampling_ratio: int = 2) -> torch.Tensor:
    """Kernel D: the gradient of RoIAlign with respect to maps of shape
    ``feat_shape`` ([H, W, C] or [B, H, W, C]), from ``grad_out``
    [N, out_size, out_size, C] in the feature dtype, accumulated in a
    zeroed f32 buffer and cast once to the feature dtype. Each roi's
    footprint is reduced on chip in the separable form of
    ``roi_align_backward_plain``, which CPU tensors take; then one 16-byte
    atomic add per pixel and 4 channels. Raises for an (out_size,
    sampling_ratio) pair with no body, as kernel B."""
    if grad_out.device.type == "cpu":
        return roi_align_backward_plain(grad_out, rois, batch_inds,
                                        feat_shape, spatial_scale, out_size,
                                        sampling_ratio)
    shape, rois_c, binds = _check(grad_out.device, grad_out.dtype, feat_shape,
                                  rois, batch_inds, out_size, sampling_ratio)
    n = rois_c.shape[0]
    want = (n, out_size, out_size, shape[-1])
    if (tuple(grad_out.shape) != want or not grad_out.is_contiguous()
            or grad_out.data_ptr() % 16):
        raise ValueError(f"roi_align_backward: grad_out must be contiguous "
                         f"{list(want)} on a 16-byte boundary, got "
                         f"{list(grad_out.shape)}")
    acc = torch.zeros(shape, dtype=torch.float32, device=grad_out.device)
    if n:
        body = _roi_align_body(out_size, sampling_ratio, "scatter")
        lib = cuda_build.load_library()
        status = lib.llvod_roi_align_backward(
            grad_out.data_ptr(), rois_c.data_ptr(), _ptr(binds),
            acc.data_ptr(), *shape, n, float(spatial_scale), _OFFSET,
            out_size, sampling_ratio, _DTYPES[grad_out.dtype],
            _stream(grad_out))
        cuda_build.check(status, "llvod_roi_align_backward")
        roi_align_backward.launches += 1
        roi_align_backward.body_launches[body] += 1
    return acc.to(grad_out.dtype).reshape(feat_shape)


roi_align.launches = 0
roi_align.body_launches = dict.fromkeys(
    ("gather" + b for b in _BODIES.values()), 0)
roi_align_backward.launches = 0
roi_align_backward.body_launches = dict.fromkeys(
    ("scatter" + b for k, b in _BODIES.items() if k not in _SCALAR_BODIES),
    0)
