"""Anchor generation (host-side numpy), the counterpart of the JAX package's
``core/anchors.py`` (at its default centre offset 0): scale-major base
anchors, grid anchors row-major with the per-cell base anchors contiguous.
Re-implemented rather than imported: the JAX package imports jax at package
import."""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class AnchorGenerator:
    strides: Sequence[int]
    ratios: Sequence[float]
    scales: Sequence[float]

    @property
    def num_base_anchors(self) -> int:
        return len(self.ratios) * len(self.scales)

    def base_anchors(self, level: int) -> np.ndarray:
        """[A, 4] base anchors for one level, scale-major ordering, centred
        at 0."""
        w = h = float(self.strides[level])
        ratios = np.asarray(self.ratios, np.float32)
        scales = np.asarray(self.scales, np.float32)
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
