"""Evaluation loops over video datasets, the counterpart of the JAX
package's ``apis/test.py`` (``single_device_test``, ``multi_device_test``,
``evaluate_bbox``; mmtracking's ``single_gpu_test`` / ``multi_gpu_test``):

- frames stream in video order through a ``VIDModel``; at frame 0 the
  dataset's ``test_with_adaptive_stride`` (or fix-stride) reference frames
  are prepared and fed as the memo, and a frame's file is prepared once a
  video (``data/loader.py``: ``stream_plan``, ``TestLoader``, whose
  workers decode the frames while the model streams);
- detections come back per frame and per class as [N, 5] arrays in the
  original frame's coordinates: ``img_shape`` and ``scale_factor`` are
  read through the pipeline's ``img_metas``;
- the gts are the dataset's, not the pipeline's;
- several shards are whole videos (``distributed_video_split``), run one
  after the other in one process and concatenated in dataset order.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.eval.mean_ap import eval_map
from ..data.datasets import distributed_video_split
from ..data.loader import TestLoader


def single_device_test(
    model,
    ds,
    pipe,
    indices: Optional[Sequence[int]] = None,
    with_ann: bool = True,
    progress_fn: Optional[Callable[[int, int], None]] = None,
    workers: int = 0,
    timings: Optional[List[Dict[str, float]]] = None,
) -> Tuple[List[List[np.ndarray]], List[Dict]]:
    """Stream the dataset's frames at ``indices`` (all by default) in order
    through ``model`` (a ``VIDModel``); ``pipe`` is the test pipeline (a
    ``Compose``, run on its own device) and ``workers`` the loader
    processes that decode the frames.

    Returns (det_lists, annotations): per frame the per-class [N, 5]
    arrays in original coordinates, and the dataset's gts of each frame for
    ``eval_map``. The dataset must be a test one (``test_mode=True``) with
    its configured ``ref_img_sampler``, so that frame 0 carries its
    reference frames. ``timings``, when given, gets the loader's dict a
    frame (``TestLoader``) with the step's host ms (``step_ms``, the call
    to the model, which ends by reading the detections back)."""
    det_lists: List[List[np.ndarray]] = []
    annotations: List[Dict] = []
    loader = TestLoader(ds, pipe, indices, workers=workers)
    n = len(loader.steps)
    for k, f in enumerate(loader.frames()):
        s, r = f["sample"], f["prepared"]
        # VideoCollect nests the pipeline's meta under img_metas; read
        # through it so that detections are rescaled when the pipeline
        # resized the frame
        meta = r.get("img_metas") or {}
        t = time.perf_counter()
        out = model.inference_vid_prepared(
            r["img"], img_shape=r.get("img_shape", meta.get("img_shape")),
            scale_factor=r.get("scale_factor", meta.get("scale_factor")),
            frame_id=s["img_info"].get("frame_id", 0),
            ref_imgs=f["ref_imgs"])
        if timings is not None:
            timings.append(dict(loader.timings[-1], step_ms=(
                time.perf_counter() - t) * 1e3))
        det_lists.append(out["bbox_results"])
        if with_ann and "ann" in s:
            annotations.append(dict(bboxes=s["ann"]["bboxes"],
                                    labels=s["ann"]["labels"]))
        if progress_fn:
            progress_fn(k + 1, n)
    return det_lists, annotations


def multi_device_test(
    model, ds, pipe, num_shards: int, shard: Optional[int] = None, **kw
) -> Tuple[List[List[np.ndarray]], List[Dict], List[int]]:
    """Whole-video shards (``distributed_video_split``): ``shard`` alone,
    or with None every shard in turn. Returns the results, the gts and the
    dataset indices, in dataset order."""
    splits = distributed_video_split(ds.data_infos, num_shards)
    shards = [shard] if shard is not None else range(num_shards)
    det_lists: List[List[np.ndarray]] = []
    annotations: List[Dict] = []
    indices: List[int] = []
    for k in shards:
        d, a = single_device_test(model, ds, pipe, indices=splits[k], **kw)
        det_lists.extend(d)
        annotations.extend(a)
        indices.extend(splits[k])
    return det_lists, annotations, indices


def evaluate_bbox(det_lists, annotations,
                  iou_thr: float = 0.5) -> Dict[str, float]:
    """``eval_map`` at ``iou_thr`` with its defaults (``tpfp_default``,
    'area' AP), as ``{"mAP50": ...}`` (or ``mAP{100 x iou_thr}``)."""
    mean_ap, _ = eval_map(det_lists, annotations, iou_thr=iou_thr)
    key = "mAP50" if iou_thr == 0.5 else f"mAP{int(iou_thr * 100)}"
    return {key: float(mean_ap)}
