"""RoIAlign (avg mode) over NHWC maps: the plain torch version and the CUDA
kernel ``csrc/roi_align.cu`` behind one entry.

Counterpart of the JAX package's ``ops/roi_align.py`` (``roi_align_matmul``
and the batched ``roi_align``) and of its TPU kernel
``ops/roi_align_pallas.py::roi_align_pallas``, in the form every caller uses:
``aligned=True`` (half-pixel offset). A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.

The kernel has one gather body per (out_size, sampling_ratio) it is compiled
for (``_roi_align_body``): ``gather7x2`` (the box head's 7x7) and
``gather14x2`` (the mask heads' 14x14). ``roi_align.launches`` counts the
launches, ``roi_align.body_launches`` the launches per body.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BODIES = {(7, 2): "gather7x2", (14, 2): "gather14x2"}
_OFFSET = 0.5  # aligned=True
_CHUNK = 64  # rois per gather step of the plain version (bounds its memory)


def _roi_align_body(out_size: int, sampling_ratio: int) -> str:
    """The kernel body for an output size and sampling ratio; raises
    ``ValueError`` for a pair the kernel is not compiled for."""
    try:
        return _BODIES[(out_size, sampling_ratio)]
    except KeyError:
        raise ValueError(
            f"roi_align kernel: no body for out_size={out_size}, "
            f"sampling_ratio={sampling_ratio} (compiled for "
            f"{sorted(_BODIES)})") from None


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
    if not outs:
        return feats.new_zeros((0, out_size, out_size, c))
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
    ``batch_inds``). Returns [N, out_size, out_size, C] in the feature dtype.

    CPU tensors take ``roi_align_plain``; CUDA tensors launch the kernel's
    body for (out_size, sampling_ratio), (7, 2) or (14, 2), and raise
    ``ValueError`` for any other pair. ``impl="plain"`` forces the plain
    version (for comparisons only)."""
    if impl not in (None, "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "plain" or feats.device.type == "cpu":
        return roi_align_plain(feats, rois, spatial_scale, batch_inds,
                               out_size, sampling_ratio)
    return _roi_align_cuda(feats, rois, spatial_scale, batch_inds, out_size,
                           sampling_ratio)


def _roi_align_cuda(feats, rois, spatial_scale, batch_inds, out_size,
                    sampling_ratio):
    """Check the operands and launch the kernel's body for (out_size,
    sampling_ratio). The kernel reads int64 map indices in place; int32
    ones are widened here (no caller of the main path passes them)."""
    body = _roi_align_body(out_size, sampling_ratio)
    if feats.device.type != "cuda":
        raise RuntimeError(f"roi_align: no kernel for device {feats.device}")
    if feats.dtype not in _DTYPES:
        raise TypeError(f"roi_align: feature dtype {feats.dtype} not supported")
    if feats.ndim not in (3, 4) or rois.ndim != 2 or rois.shape[-1] != 4:
        raise ValueError(f"roi_align: bad shapes {feats.shape}, {rois.shape}")
    maps = feats if feats.ndim == 4 else feats[None]
    if not maps.is_contiguous():
        raise ValueError("roi_align kernel: feature map must be contiguous")
    b, h, w, c = maps.shape
    vec = 16 // maps.element_size()  # channels per 16-byte load
    if c % vec or maps.data_ptr() % 16:
        raise ValueError(f"roi_align kernel: {c} channels of {maps.dtype} "
                         "must be whole 16-byte vectors on a 16-byte "
                         "boundary")
    if h * w * c >= 2 ** 31:
        raise ValueError("roi_align kernel: a map of 2^31 elements or more")
    n = rois.shape[0]
    if rois.device != feats.device or rois.dtype != torch.float32:
        raise TypeError("roi_align kernel: rois must be float32 on the map's "
                        "device")
    rois_c = rois.contiguous()
    binds = None
    if batch_inds is not None:
        if batch_inds.shape != (n,) or batch_inds.device != feats.device:
            raise ValueError("roi_align kernel: batch_inds must be [N] on the "
                             "map's device")
        if batch_inds.dtype not in (torch.int32, torch.int64):
            raise TypeError("roi_align kernel: batch_inds must be int32 or "
                            "int64")
        binds = batch_inds.to(torch.int64).contiguous()
    elif b != 1:
        raise ValueError("roi_align: batch_inds required for a batch of maps")
    out = torch.empty((n, out_size, out_size, c), dtype=feats.dtype,
                      device=feats.device)
    if n == 0:
        return out
    lib = cuda_build.load_library()
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    status = lib.llvod_roi_align(
        maps.data_ptr(), rois_c.data_ptr(),
        binds.data_ptr() if binds is not None else None, out.data_ptr(), b,
        h, w, c, n, float(spatial_scale), _OFFSET, out_size, sampling_ratio,
        _DTYPES[feats.dtype], stream)
    cuda_build.check(status, "llvod_roi_align")
    roi_align.launches += 1
    roi_align.body_launches[body] += 1
    return out


roi_align.launches = 0
roi_align.body_launches = dict.fromkeys(_BODIES.values(), 0)
