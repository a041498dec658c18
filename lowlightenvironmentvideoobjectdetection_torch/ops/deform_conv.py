"""Modulated deformable convolution (DCNv2), 3x3, stride 1, padding 1: the
plain torch version and the CUDA kernels ``csrc/deform_conv.cu`` behind one
entry.

Counterpart of the JAX package's ``ops/deform_conv.py``
(``modulated_deform_conv``, the exact gather form with unbounded offsets, and
``deform_conv``, DCNv1, its case mask = 1), which replaced mmcv's native
``modulated_deform_conv2d``. The JAX package computes it in XLA; here it is
an im2col of bilinear samples and a matrix product:

    cols[n, c * 9 + k, p] = mask[n, g, k, p] * bilinear(x[n, c], s_k(p))
    out[n] = weight.view(Cout, Cin * 9) @ cols[n] + bias

for input channel c of deform group g, tap k = 3 ky + kx and output pixel
p = (py, px), at the sample position s_k(p) = ((py + ky - 1) + dy,
(px + kx - 1) + dx), summed in that order. Each of the four bilinear corners
counts only where it lies inside the map, so a sample fractionally outside
fades to zero (mmcv's ``dmcn_im2col_bilinear``).

Layouts, NCHW as the port's convs: x [N, Cin, H, W] (f32 or bf16); offset
[N, G * 18, H, W] in the JAX package's channel order, per deform group the
9 dy and then the 9 dx (not mmcv's interleaved (dy, dx) pairs); mask
[N, G * 9, H, W], already sigmoided; weight OIHW [Cout, Cin, 3, 3]; bias
[Cout]. As in JAX, the columns, the product and the output are f32 whatever
x's dtype (its DCN parameters are never cast), and the offsets and the mask
are read as f32.

``modulated_deform_conv`` is the one entry: CPU tensors take the plain
version under autograd; CUDA tensors go through a ``torch.autograd.Function``
whose forward is kernel E (``deform_columns``, the im2col) and whose
backward is ``grad_cols = W^T grad_out`` (``torch.matmul``), kernel F
(``deform_col2im``, the input's gradient) and kernel G
(``deform_col2im_coord``, the offsets' and the mask's). The forward keeps
its columns for the weight's gradient. Any other device or dtype raises;
nothing falls back.
``deform_columns.launches``, ``deform_col2im.launches`` and
``deform_col2im_coord.launches`` count the launches of E, F and G.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_build

K = 9  # 3x3 taps
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INVALID = 1  # cudaErrorInvalidValue: the grid too large for E, F or G


def _taps(device):
    """The taps' base displacements (ky - 1, kx - 1), row-major, [9] each."""
    t = torch.arange(K, device=device)
    return ((t // 3 - 1).float(), (t % 3 - 1).float())


def _corners(offset: torch.Tensor, h: int, w: int, g: int):
    """Per deform group, tap and output pixel ([N, G, 9 * H * W] each):
    lists over the corners (y0, x0), (y0, x1), (y1, x0), (y1, x1) of their
    flat pixel index (clamped into the map), their bilinear weight with the
    zero-outside rule applied and their in-map flag; then the fractional
    parts ly and lx of the sample position."""
    n = offset.shape[0]
    hw = h * w
    off = offset.float().reshape(n, g, 2, K, hw)
    by, bx = _taps(offset.device)
    p = torch.arange(hw, device=offset.device)
    gy, gx = (p // w).float(), (p % w).float()
    # (grid + base) + offset, in the JAX package's order
    sy = (gy[None, :] + by[:, None]) + off[:, :, 0]
    sx = (gx[None, :] + bx[:, None]) + off[:, :, 1]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    ly, lx = sy - y0, sx - x0
    hy, hx = 1 - ly, 1 - lx
    idx, wgt, ok = [], [], []
    for yi, xi, wt in ((y0, x0, hy * hx), (y0, x0 + 1, hy * lx),
                       (y0 + 1, x0, ly * hx), (y0 + 1, x0 + 1, ly * lx)):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        flat = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        idx.append(flat.long().reshape(n, g, K * hw))
        wgt.append((wt * inside).reshape(n, g, K * hw))
        ok.append(inside.reshape(n, g, K * hw))
    return idx, wgt, ok, ly.reshape(n, g, K * hw), lx.reshape(n, g, K * hw)


def deform_columns_plain(x: torch.Tensor, offset: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Kernel E's plain version: the f32 columns [N, Cin * 9, H * W] of the
    bilinear samples times the mask, the corners summed in the order
    (y0, x0), (y0, x1), (y1, x0), (y1, x1) as the JAX package sums them.
    Differentiable with respect to x, the offsets and the mask."""
    n, c, h, w = x.shape
    g = mask.shape[1] // K
    idx, wgt, _, _, _ = _corners(offset, h, w, g)
    xg = x.float().reshape(n, g, c // g, h * w)
    acc = 0.0
    for i, wt in zip(idx, wgt):
        v = torch.gather(xg, 3, i[:, :, None].expand(n, g, c // g, K * h * w))
        acc = acc + v * wt[:, :, None]
    acc = acc * mask.float().reshape(n, g, 1, K * h * w)
    return acc.reshape(n, c * K, h * w)


def _product(cols, weight, bias, shape):
    n, _, h, w = shape
    out = torch.matmul(weight.float().reshape(weight.shape[0], -1), cols)
    if bias is not None:
        out = out + bias.float()[:, None]
    return out.reshape(n, weight.shape[0], h, w)


def modulated_deform_conv_plain(x: torch.Tensor, offset: torch.Tensor,
                                mask: torch.Tensor, weight: torch.Tensor,
                                bias: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Plain torch DCNv2 (kernel E's columns and the f32 product), under
    autograd. Returns f32 [N, Cout, H, W]."""
    _check_shapes(x, offset, mask, weight, bias)
    return _product(deform_columns_plain(x, offset, mask), weight, bias,
                    x.shape)


def modulated_deform_conv_backward_plain(grad_cols: torch.Tensor,
                                         x: torch.Tensor,
                                         offset: torch.Tensor,
                                         mask: torch.Tensor):
    """Kernels F and G's plain version: from the columns' gradient
    grad_cols [N, Cin * 9, H * W] (f32), the closed-form gradients of x (in
    x's dtype; f32 sums with ``index_add_``, cast once), of the offsets
    [N, G * 18, H, W] and of the mask [N, G * 9, H, W] (f32).

    For a column value m * S with S = sum over corners of w * v: x's corner
    pixel takes grad_col * m * w; the mask takes sum_c grad_col * S; dy takes
    sum_c grad_col * m * dS/dly and dx sum_c grad_col * m * dS/dlx, with
    dS/dly = (1 - lx) (v10 - v00) + lx (v11 - v01) and dS/dlx = (1 - ly)
    (v01 - v00) + ly (v11 - v10) over the in-map corners' values. floor's
    derivative is 0, so d ly / d dy = 1, as the JAX package's autodiff
    takes it (at an integer position: one-sided, towards the next row or
    column)."""
    n, c, h, w = x.shape
    g = mask.shape[1] // K
    cpg, hw = c // g, h * w
    idx, wgt, ok, ly, lx = _corners(offset, h, w, g)
    gc = grad_cols.float().reshape(n, g, cpg, K * hw)
    m = mask.float().reshape(n, g, 1, K * hw)
    xg = x.float().reshape(n, g, cpg, hw)
    v = [torch.gather(xg, 3, i[:, :, None].expand(n, g, cpg, K * hw))
         * o[:, :, None] for i, o in zip(idx, ok)]
    s = v[0] * wgt[0][:, :, None]
    for vi, wi in zip(v[1:], wgt[1:]):
        s = s + vi * wi[:, :, None]
    ly, lx = ly[:, :, None], lx[:, :, None]
    d_ly = (1 - lx) * (v[2] - v[0]) + lx * (v[3] - v[1])
    d_lx = (1 - ly) * (v[1] - v[0]) + ly * (v[3] - v[2])
    gm = gc * m
    grad_mask = (gc * s).sum(2)
    grad_off = torch.stack([(gm * d_ly).sum(2), (gm * d_lx).sum(2)], 2)
    grad_x = torch.zeros(n, g, cpg, hw, dtype=torch.float32,
                         device=x.device)
    all_idx = torch.cat(idx, 2)  # [N, G, 4 * 9 * HW]
    src = torch.cat([gm * wt[:, :, None] for wt in wgt], 3)
    for b in range(n):
        for gi in range(g):
            grad_x[b, gi].index_add_(1, all_idx[b, gi], src[b, gi])
    return (grad_x.to(x.dtype).reshape(x.shape),
            grad_off.reshape(n, g * 2 * K, h, w),
            grad_mask.reshape(n, g * K, h, w))


def _check_maps(x, offset, mask, what="modulated_deform_conv"):
    """Raise unless x [N, Cin, H, W], offset [N, G * 18, H, W] and mask
    [N, G * 9, H, W] fit, with G dividing Cin; returns G."""
    if x.ndim != 4 or offset.ndim != 4 or mask.ndim != 4:
        raise ValueError(f"{what}: x, offset and mask are NCHW")
    n, c, h, w = x.shape
    g = mask.shape[1] // K
    if (g < 1 or mask.shape != (n, g * K, h, w)
            or offset.shape != (n, g * 2 * K, h, w) or c % g):
        raise ValueError(
            f"{what}: x {tuple(x.shape)}, offset {tuple(offset.shape)}, mask "
            f"{tuple(mask.shape)}: want offset [N, G*18, H, W] and mask "
            "[N, G*9, H, W] with G dividing Cin")
    return g


def _check_shapes(x, offset, mask, weight, bias):
    _check_maps(x, offset, mask)
    c = x.shape[1]
    if weight.shape[1:] != (c, 3, 3):
        raise ValueError(f"modulated_deform_conv: weight {tuple(weight.shape)}"
                         f" for {c} input channels, want [Cout, {c}, 3, 3]")
    if bias is not None and bias.shape != (weight.shape[0],):
        raise ValueError("modulated_deform_conv: bias must be [Cout]")


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor,
                          mask: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          impl: Optional[str] = None) -> torch.Tensor:
    """DCNv2: f32 [N, Cout, H, W], differentiable with respect to every
    operand. CPU tensors take ``modulated_deform_conv_plain``; CUDA tensors
    launch kernel E forward and kernels F and G backward, and raise for any
    other dtype of x than f32 or bf16. ``impl="plain"`` forces the plain
    version (for comparisons only)."""
    if impl not in (None, "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "plain" or x.device.type == "cpu":
        return modulated_deform_conv_plain(x, offset, mask, weight, bias)
    _check_shapes(x, offset, mask, weight, bias)
    if x.device.type != "cuda":
        raise RuntimeError(f"modulated_deform_conv: no kernel for device "
                           f"{x.device}")
    return _ModulatedDeformConv.apply(x, offset.float().contiguous(),
                                      mask.float().contiguous(), weight, bias)


def deform_conv(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                impl: Optional[str] = None) -> torch.Tensor:
    """DCNv1 (mmcv's ``DeformConv2d``): ``modulated_deform_conv`` with every
    mask value 1; offset [N, G * 18, H, W]."""
    n, _, h, w = x.shape
    ones = torch.ones(n, offset.shape[1] // 2, h, w, device=x.device)
    return modulated_deform_conv(x, offset, ones, weight, bias, impl=impl)


class _ModulatedDeformConv(torch.autograd.Function):
    """Kernel E and the f32 product forward; the product's transpose and
    kernels F and G backward."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias):
        cols = deform_columns(x, offset, mask)
        ctx.save_for_backward(x, offset, mask, weight, cols)
        ctx.has_bias = bias is not None
        return _product(cols, weight, bias, x.shape)

    @staticmethod
    def backward(ctx, grad_out):
        x, offset, mask, weight, cols = ctx.saved_tensors
        n, cout = grad_out.shape[:2]
        go = grad_out.float().reshape(n, cout, -1)
        w2 = weight.float().reshape(cout, -1)
        grad_w = grad_b = grad_x = grad_off = grad_mask = None
        if ctx.needs_input_grad[3]:
            grad_w = torch.matmul(go, cols.transpose(1, 2)).sum(0).reshape(
                weight.shape).to(weight.dtype)
        if ctx.has_bias and ctx.needs_input_grad[4]:
            grad_b = go.sum((0, 2))
        if any(ctx.needs_input_grad[:3]):
            grad_cols = torch.matmul(w2.t(), go)
            grad_x, grad_off, grad_mask = modulated_deform_conv_backward(
                grad_cols, x, offset, mask)
        return grad_x, grad_off, grad_mask, grad_w, grad_b


def _check_cuda(x, offset, mask, what):
    """What kernels E, F and G take; returns x, offset and mask contiguous
    and G."""
    g = _check_maps(x, offset, mask, what)
    if x.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: x dtype {x.dtype} not supported")
    for t, name in ((offset, "offset"), (mask, "mask")):
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32 on x's device")
    if x.numel() * K >= 2 ** 31:
        raise ValueError(f"{what}: 2^31 column elements or more")
    return x.contiguous(), offset.contiguous(), mask.contiguous(), g


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_launch(status: int, name: str) -> None:
    """Raise ValueError where a tiled entry (E, F, G) refused the shape:
    more than 65535 images x groups (x F's chunks of 8 channels) or row
    tiles for the grid; else as ``cuda_build.check``."""
    if status == _INVALID:
        raise ValueError(f"{name}: the shape needs a grid beyond 65535 "
                         "blocks in y or z")
    cuda_build.check(status, name)


def deform_columns(x: torch.Tensor, offset: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Kernel E: the f32 columns [N, Cin * 9, H * W] of
    ``deform_columns_plain``, bit for bit; f32 offsets and mask, f32 or bf16
    x. One block per (image, deform group, tile of 4 x 32 output pixels),
    one thread per tap and 4 consecutive pixels: it computes the 4 samples
    once and, for each of the group's channels, gathers their corners and
    writes the 4 columns with one 16-byte streaming store. CPU tensors take
    the plain version."""
    if x.device.type == "cpu":
        return deform_columns_plain(x, offset, mask)
    x, offset, mask, g = _check_cuda(x, offset, mask, "deform_columns")
    n, c, h, w = x.shape
    cols = torch.empty(n, c * K, h * w, dtype=torch.float32, device=x.device)
    if cols.numel():
        status = cuda_build.load_library().llvod_dcn_im2col(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), cols.data_ptr(),
            n, c, h, w, g, _DTYPES[x.dtype], _stream(x))
        _check_launch(status, "llvod_dcn_im2col")
        deform_columns.launches += 1
    return cols


def _check_grad_cols(grad_cols, x):
    n, c, h, w = x.shape
    if (grad_cols.shape != (n, c * K, h * w) or grad_cols.device != x.device
            or grad_cols.dtype != torch.float32):
        raise ValueError("deform_col2im: grad_cols must be float32 "
                         f"[{n}, {c * K}, {h * w}] on x's device")
    return grad_cols.contiguous()


def deform_col2im(grad_cols: torch.Tensor, x: torch.Tensor,
                  offset: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Kernel F: x's gradient, in x's dtype, from the columns' f32 gradient
    [N, Cin * 9, H * W] (x gives the shape and dtype; its values are not
    read). One block per (image, deform group, tile of 8 x 32 output
    pixels, chunk of 8 of the group's channels) sums grad_col * mask *
    corner weight into a shared f32 window of the tile and 3 pixels around
    it, each sample computed once for the chunk's channels, a corner
    outside the window added to global memory directly; then adds the
    window into a zeroed f32 buffer with 16-byte atomic reductions, cast
    once. CUDA tensors only."""
    x, offset, mask, g = _check_cuda(x, offset, mask, "deform_col2im")
    grad_cols = _check_grad_cols(grad_cols, x)
    n, c, h, w = x.shape
    grad_x = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    if grad_cols.numel():
        status = cuda_build.load_library().llvod_dcn_col2im(
            grad_cols.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            grad_x.data_ptr(), n, c, h, w, g, _stream(x))
        _check_launch(status, "llvod_dcn_col2im")
        deform_col2im.launches += 1
    return grad_x.to(x.dtype)


def deform_col2im_coord(grad_cols: torch.Tensor, x: torch.Tensor,
                        offset: torch.Tensor, mask: torch.Tensor):
    """Kernel G: (grad_offset [N, G * 18, H, W], grad_mask [N, G * 9, H, W]),
    f32, from the columns' f32 gradient. One block per (image, deform
    group, tile of 4 x 32 output pixels), one thread per tap and 4
    consecutive pixels: it computes the 4 samples once and sums, over the
    group's channels in a fixed order, grad_col times each corner value,
    then applies the samples' weights and corner differences once;
    16-byte loads of grad_cols, the offsets and the mask, and 16-byte
    stores. No atomics: the result is deterministic. CUDA tensors only."""
    x, offset, mask, g = _check_cuda(x, offset, mask, "deform_col2im_coord")
    grad_cols = _check_grad_cols(grad_cols, x)
    n, c, h, w = x.shape
    grad_off = torch.empty_like(offset)
    grad_mask = torch.empty_like(mask)
    if grad_cols.numel():
        status = cuda_build.load_library().llvod_dcn_col2im_coord(
            grad_cols.data_ptr(), x.data_ptr(), offset.data_ptr(),
            mask.data_ptr(), grad_off.data_ptr(), grad_mask.data_ptr(), n, c,
            h, w, g, _DTYPES[x.dtype], _stream(x))
        _check_launch(status, "llvod_dcn_col2im_coord")
        deform_col2im_coord.launches += 1
    return grad_off, grad_mask


def modulated_deform_conv_backward(grad_cols: torch.Tensor, x: torch.Tensor,
                                   offset: torch.Tensor, mask: torch.Tensor):
    """(grad_x in x's dtype, grad_offset, grad_mask) from the columns' f32
    gradient: kernels F and G on CUDA tensors,
    ``modulated_deform_conv_backward_plain`` on CPU tensors."""
    if x.device.type == "cpu":
        return modulated_deform_conv_backward_plain(grad_cols, x, offset,
                                                    mask)
    return (deform_col2im(grad_cols, x, offset, mask),
            *deform_col2im_coord(grad_cols, x, offset, mask))


deform_columns.launches = 0
deform_col2im.launches = 0
deform_col2im_coord.launches = 0
