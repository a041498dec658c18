"""Anchor generation (host-side numpy), the counterpart of the JAX package's
``core/anchors.py`` (at its default centre offset 0): scale-major base
anchors, grid anchors row-major with the per-cell base anchors contiguous.
The scales are given, or RetinaNet's octaves: ``octave_base_scale`` times
2^(i / ``scales_per_octave``). Re-implemented rather than imported: the JAX
package imports jax at package import."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class AnchorGenerator:
    strides: Sequence[int]
    ratios: Sequence[float]
    scales: Optional[Sequence[float]] = None
    octave_base_scale: Optional[int] = None
    scales_per_octave: Optional[int] = None

    def __post_init__(self):
        if (self.scales is None) == (self.octave_base_scale is None):
            raise ValueError("give scales or octave_base_scale, not both")
        if self.scales is None and not self.scales_per_octave:
            raise ValueError("octave_base_scale needs scales_per_octave")

    @property
    def _scales(self) -> np.ndarray:
        if self.scales is not None:
            return np.asarray(self.scales, np.float32)
        octave = np.array([2 ** (i / self.scales_per_octave)
                           for i in range(self.scales_per_octave)],
                          np.float32)
        return octave * self.octave_base_scale

    @property
    def num_base_anchors(self) -> int:
        return len(self.ratios) * len(self._scales)

    def base_anchors(self, level: int) -> np.ndarray:
        """[A, 4] base anchors for one level, scale-major ordering, centred
        at 0."""
        w = h = float(self.strides[level])
        ratios = np.asarray(self.ratios, np.float32)
        scales = self._scales
        h_ratios = np.sqrt(ratios)
        w_ratios = 1.0 / h_ratios
        ws = (w * w_ratios[:, None] * scales[None, :]).reshape(-1)
        hs = (h * h_ratios[:, None] * scales[None, :]).reshape(-1)
        return np.stack([-0.5 * ws, -0.5 * hs, 0.5 * ws, 0.5 * hs], axis=-1)

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]]
                     ) -> List[np.ndarray]:
        """Per-level [H*W*A, 4] float32 anchors."""
        out = []
        for lvl, (fh, fw) in enumerate(featmap_sizes):
            stride = self.strides[lvl]
            base = self.base_anchors(lvl)
            shift_x = np.arange(fw, dtype=np.float32) * stride
            shift_y = np.arange(fh, dtype=np.float32) * stride
            sx, sy = np.meshgrid(shift_x, shift_y)
            shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()],
                              axis=-1)
            anchors = base[None, :, :] + shifts[:, None, :]
            out.append(anchors.reshape(-1, 4).astype(np.float32))
        return out
