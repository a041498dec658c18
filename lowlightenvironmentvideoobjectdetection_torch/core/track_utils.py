"""Track-result transforms and embedding similarity on the host (numpy),
the port's copy of the JAX package's ``core/track_utils.py``.

Parity targets (mmtracking/mmtrack/core/track/):
- transforms.py:6 ``imrenormalize`` — re-normalize an image from the
  detector's norm stats to the ReID net's stats without going back to raw.
- transforms.py:49 ``track2result`` / :79 ``restore_result`` — pack/unpack
  per-class lists of [N, 6] (id, x1, y1, x2, y2, score) track arrays.
- similarity.py:5 ``embed_similarity`` — dot/cosine matrix for ReID matching.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def imrenormalize(img: np.ndarray, img_norm_cfg: dict,
                  new_img_norm_cfg: dict) -> np.ndarray:
    """img normalized with ``img_norm_cfg`` -> normalized with the new cfg."""
    mean = np.asarray(img_norm_cfg["mean"], np.float32)
    std = np.asarray(img_norm_cfg["std"], np.float32)
    new_mean = np.asarray(new_img_norm_cfg["mean"], np.float32)
    new_std = np.asarray(new_img_norm_cfg["std"], np.float32)
    raw = img * std + mean
    if img_norm_cfg.get("to_rgb", False) != new_img_norm_cfg.get("to_rgb", False):
        raw = raw[..., ::-1]
    return (raw - new_mean) / new_std


def track2result(bboxes: np.ndarray, labels: np.ndarray, ids: np.ndarray,
                 num_classes: int) -> List[np.ndarray]:
    """[N, 5] (x1..y2, score) + labels + ids -> per-class [M, 6]
    (id, x1, y1, x2, y2, score) arrays (transforms.py:49)."""
    bboxes = np.asarray(bboxes, np.float32).reshape(-1, 5)
    labels = np.asarray(labels).reshape(-1)
    ids = np.asarray(ids).reshape(-1)
    out = []
    for c in range(num_classes):
        m = labels == c
        out.append(np.concatenate(
            [ids[m, None].astype(np.float32), bboxes[m]], axis=1))
    return out


def restore_result(result: Sequence[np.ndarray], return_ids: bool = True
                   ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Inverse of track2result (transforms.py:79): per-class list -> flat
    (bboxes [N, 5], labels [N], ids [N] or None)."""
    labels = []
    for c, arr in enumerate(result):
        labels.extend([c] * len(arr))
    labels = np.asarray(labels, np.int64)
    flat = np.concatenate([np.asarray(a).reshape(-1, 6 if return_ids else 5)
                           for a in result], axis=0) \
        if len(result) else np.zeros((0, 6 if return_ids else 5))
    if return_ids:
        return flat[:, 1:], labels, flat[:, 0].astype(np.int64)
    return flat, labels, None


def embed_similarity(key_embeds: np.ndarray, ref_embeds: np.ndarray,
                     method: str = "dot_product",
                     temperature: float = -1) -> np.ndarray:
    """[N, C] x [M, C] -> [N, M] similarity (similarity.py:5)."""
    key = np.asarray(key_embeds, np.float32)
    ref = np.asarray(ref_embeds, np.float32)
    if method == "cosine":
        key = key / np.maximum(np.linalg.norm(key, axis=1, keepdims=True), 1e-12)
        ref = ref / np.maximum(np.linalg.norm(ref, axis=1, keepdims=True), 1e-12)
    elif method != "dot_product":
        raise ValueError(method)
    sim = key @ ref.T
    if temperature > 0:
        sim = sim / temperature
    return sim
