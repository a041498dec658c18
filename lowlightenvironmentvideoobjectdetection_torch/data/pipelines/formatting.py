"""Formatting steps, the counterpart of the JAX package's
``data/pipelines/formatting.py`` (``VideoCollect``,
``ConcatVideoReferences``, ``SeqDefaultFormatBundle``): pick a frame's
keys, stack the reference frames with a frame-index column on their gts,
and flatten the clip into one dict with ``ref_``-prefixed keys. Images
stay tensors where they lie: [H, W, C] for the key, [R, H, W, C] for the
references, float32."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ...registry import PIPELINES

DEFAULT_META_KEYS = (
    "filename", "ori_shape", "img_shape", "pad_shape", "scale_factor",
    "flip", "frame_id", "video_id", "is_video_data", "num_left_ref_imgs",
    "frame_stride", "img_norm_cfg",
)


@PIPELINES.register("VideoCollect")
class VideoCollect:
    """Each frame's ``keys`` and an ``img_metas`` dict of its
    ``meta_keys`` (from the frame's results or its ``img_info``)."""

    def __init__(self, keys: Sequence[str],
                 meta_keys: Sequence[str] = DEFAULT_META_KEYS):
        self.keys = tuple(keys)
        self.meta_keys = tuple(meta_keys)

    def _collect(self, results: dict) -> dict:
        meta = {}
        for k in self.meta_keys:
            if k in results:
                meta[k] = results[k]
            elif k in results.get("img_info", {}):
                meta[k] = results["img_info"][k]
        out = {"img_metas": meta}
        out.update({k: results[k] for k in self.keys if k in results})
        return out

    def __call__(self, results, rng=None):
        if isinstance(results, dict):
            return self._collect(results)
        return [self._collect(r) for r in results]


@PIPELINES.register("ConcatVideoReferences")
class ConcatVideoReferences:
    """[key, ref1, ref2, ...] -> [key, refs]: the references' images
    stacked, their gts concatenated with the reference's index as a
    leading column (1-D gts become a float32 column first)."""

    def __call__(self, results: List[dict], rng=None) -> List[dict]:
        key, refs = results[0], results[1:]
        if not refs:
            return [key]
        cat: Dict[str, object] = {
            "img": torch.stack([r["img"] for r in refs]),
            "img_metas": [r.get("img_metas", {}) for r in refs]}
        for k in ("gt_bboxes", "gt_labels", "gt_instance_ids",
                  "gt_match_indices"):
            if k in refs[0]:
                rows = []
                for i, r in enumerate(refs):
                    v = r[k]
                    if v.ndim == 1:
                        v = v[:, None].float()
                    rows.append(torch.cat([v.new_full((v.shape[0], 1), i),
                                           v], 1))
                cat[k] = torch.cat(rows)
        return [key, cat]


@PIPELINES.register("SeqDefaultFormatBundle")
class SeqDefaultFormatBundle:
    """[key, refs] -> one dict, the references' keys prefixed ``ref_``;
    images as contiguous float32."""

    def __call__(self, results, rng=None):
        if not isinstance(results, (list, tuple)) or len(results) not in (
                1, 2):
            raise ValueError("SeqDefaultFormatBundle takes [key] or "
                             "[key, refs]")
        out = {}
        for prefix, part in zip(("", "ref_"), results):
            for k, v in part.items():
                if k == "img":
                    v = v.float().contiguous()
                out[prefix + k] = v
        return out
