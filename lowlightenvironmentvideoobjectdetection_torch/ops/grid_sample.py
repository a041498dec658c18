"""Bilinear grid sampling and the flow warp of FGFA and DFF, the counterpart
of the JAX package's ``ops/grid_sample.py`` (``grid_sample``,
``_resize_bilinear_border``, ``flow_warp_feats``) on ``F.grid_sample``.

Maps are NHWC, as everywhere in the port: [H, W, C], or [N, H, W, C] with
one grid (or flow) per map, the counterpart of ``jax.vmap`` over them. The
sampling runs in float32 whatever the map's dtype (in JAX a bf16 map times
the f32 corner weights gives f32).

``flow_warp_feats`` computes what the JAX function computes, which is the
original's (mmtracking ``core/motion/flow.py``): the flow is resized to the
map's size (h, w) with one width-derived scale ``w / fw`` for both axes,
border-clamped (a computed grid, so the size is (h, w) whatever the
rounding of ``F.interpolate(scale_factor=...)`` would give), and the map is
sampled at ``(x + flow) / W * 2 - 1`` with ``align_corners=True`` and
border padding. ``centered=True`` is the JAX opt-in pixel-centre mapping
with zero padding (a zero flow is the identity).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(feat: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = False,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sample of feat [H, W, C] at grid [..., 2] (normalized x, y
    in [-1, 1], torch's convention) -> [..., C] float32; batched, feat
    [N, H, W, C] and grid [N, ..., 2] -> [N, ..., C]. ``padding_mode``
    'zeros' or 'border', as ``F.grid_sample``."""
    single = feat.ndim == 3
    if single:
        feat, grid = feat[None], grid[None]
    n = feat.shape[0]
    lead = grid.shape[1:-1]
    out = F.grid_sample(feat.float().permute(0, 3, 1, 2),
                        grid.float().reshape(n, -1, 1, 2), mode="bilinear",
                        padding_mode=padding_mode,
                        align_corners=align_corners)  # [N, C, M, 1]
    out = out[..., 0].transpose(1, 2).reshape(n, *lead, feat.shape[-1])
    return out[0] if single else out


def _pixel_grid(h: int, w: int, device) -> tuple:
    """Pixel coordinates (x [h, w], y [h, w]) in float32."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    return xs, ys


def _resize_bilinear_border(img: torch.Tensor, out_h: int, out_w: int,
                            scale: float) -> torch.Tensor:
    """torch ``interpolate(scale_factor=scale, mode='bilinear',
    align_corners=False)`` into an output of (out_h, out_w): the source of
    pixel d is (d + 0.5) / scale - 0.5, the corner taps border-clamped.
    img [H, W, C] or [N, H, W, C] -> [..., out_h, out_w, C] float32."""
    dev = img.device
    sx = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) \
        / scale - 0.5
    sy = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) \
        / scale - 0.5
    gy, gx = torch.meshgrid(sy, sx, indexing="ij")
    fh, fw = img.shape[-3], img.shape[-2]
    # the pixel coordinates in the align_corners=False normalized convention
    grid = torch.stack([(2.0 * gx + 1.0) / fw - 1.0,
                        (2.0 * gy + 1.0) / fh - 1.0], -1)
    if img.ndim == 4:
        grid = grid.expand(img.shape[0], *grid.shape)
    return grid_sample(img, grid, align_corners=False, padding_mode="border")


def flow_warp_feats(feat: torch.Tensor, flow: torch.Tensor,
                    centered: bool = False) -> torch.Tensor:
    """Warp feat [H, W, C] by the pixel-displacement flow [Hf, Wf, 2] (x, y)
    -> [H, W, C] float32; batched, feat [N, H, W, C] and flow
    [N, Hf, Wf, 2]. Differentiable with respect to both. See the module
    docstring for the default (the original's) and the ``centered``
    mapping."""
    h, w = feat.shape[-3], feat.shape[-2]
    fh, fw = flow.shape[-3], flow.shape[-2]
    xs, ys = _pixel_grid(h, w, feat.device)
    if centered:
        nx = (torch.arange(w, dtype=torch.float32, device=feat.device)
              + 0.5) / w * 2 - 1
        ny = (torch.arange(h, dtype=torch.float32, device=feat.device)
              + 0.5) / h * 2 - 1
        gy, gx = torch.meshgrid(ny, nx, indexing="ij")
        grid = torch.stack([gx, gy], -1)
        if flow.ndim == 4:
            grid = grid.expand(flow.shape[0], *grid.shape)
        flow_r = grid_sample(flow, grid) * torch.tensor(
            [w / fw, h / fh], dtype=torch.float32, device=flow.device)
        nxx = (xs + flow_r[..., 0] + 0.5) / w * 2 - 1
        nyy = (ys + flow_r[..., 1] + 0.5) / h * 2 - 1
        return grid_sample(feat, torch.stack([nxx, nyy], -1))
    scale = w / fw  # the original's float(x.shape[-1]) / flow.shape[-1]
    flow_r = _resize_bilinear_border(flow, h, w, scale) * scale
    nxx = (xs + flow_r[..., 0]) / w * 2 - 1
    nyy = (ys + flow_r[..., 1]) / h * 2 - 1
    return grid_sample(feat, torch.stack([nxx, nyy], -1), align_corners=True,
                       padding_mode="border")
