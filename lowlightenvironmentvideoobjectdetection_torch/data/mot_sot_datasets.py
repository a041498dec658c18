"""MOT and SOT test datasets, the port's copy of the JAX package's
``data/mot_sot_datasets.py`` on the port's ``CocoVideoDataset``:

- MOTChallengeDataset: mmtracking/mmtrack/datasets/mot_challenge_dataset.py:17
  — MOT17 over COCO-VID json (from tools/convert_datasets/mot2coco.py), public
  detections (``detection_file``: a json list of per-frame [N, 5] boxes in
  dataset order), ``visibility_thr``, ``format_results`` to MOT txt (L133),
  CLEAR-MOT evaluation (L212) via ``core.eval.mot.eval_mot``.
- LaSOTDataset: mmtrack/datasets/lasot_dataset.py:9 — single-object test
  videos (``get_video``) with OPE evaluation (``core.eval.sot.eval_sot_ope``).
- SOTTrainDataset: mmtrack/datasets/sot_train_dataset.py — template and
  search pairs for SiamRPN++ training, drawn from a ``random.Random``.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import numpy as np

from .datasets import CocoVideoDataset


class MOTChallengeDataset(CocoVideoDataset):
    CLASSES = ("pedestrian",)

    def __init__(self, *args, detection_file: Optional[str] = None,
                 visibility_thr: float = -1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.visibility_thr = visibility_thr
        self.detections = None
        if detection_file:
            with open(detection_file) as f:
                self.detections = json.load(f)

    def get_ann_info(self, img_info: dict) -> Dict[str, np.ndarray]:
        ann = super().get_ann_info(img_info)
        # visibility filtering (mot_challenge_dataset.py parse_ann)
        if self.visibility_thr > 0:
            anns = self.coco.img_to_anns[img_info["id"]]
            vis = np.asarray(
                [a.get("visibility", 1.0) for a in anns
                 if not a.get("iscrowd", 0)
                 and a["category_id"] in self.cat2label
                 and a["bbox"][2] >= 1 and a["bbox"][3] >= 1],
                np.float32,
            )
            if len(vis) == len(ann["labels"]):
                keep = vis >= self.visibility_thr
                ann = {k: v[keep] for k, v in ann.items()}
        return ann

    def format_results(self, results: List[dict], out_dir: str) -> List[str]:
        """Write per-video MOT txt files (mot_challenge_dataset.py:133):
        ``frame,id,x,y,w,h,conf,-1,-1,-1`` rows. ``results[i]`` holds
        ``track_bboxes`` [N, 6] = (id, x1, y1, x2, y2, score) for frame i in
        dataset order."""
        os.makedirs(out_dir, exist_ok=True)
        by_video: Dict[int, List[str]] = {}
        for info, res in zip(self.data_infos, results):
            vid = info["video_id"]
            frame = info.get("frame_id", 0) + 1
            for row in np.asarray(res.get("track_bboxes",
                                          np.zeros((0, 6)))).reshape(-1, 6):
                tid, x1, y1, x2, y2, score = row
                by_video.setdefault(vid, []).append(
                    f"{frame},{int(tid)},{x1:.2f},{y1:.2f},"
                    f"{x2 - x1:.2f},{y2 - y1:.2f},{score:.4f},-1,-1,-1"
                )
        paths = []
        vid_names = {v["id"]: v["name"] for v in self.coco.dataset.get("videos", [])}
        for vid, lines in by_video.items():
            path = os.path.join(out_dir, f"{vid_names.get(vid, vid)}.txt")
            with open(path, "w") as f:
                f.write("\n".join(lines) + "\n")
            paths.append(path)
        return paths

    def evaluate(self, results: List[dict], metric="track",
                 iou_thr: float = 0.5) -> Dict[str, float]:
        """CLEAR-MOT over the whole dataset (mot_challenge_dataset.py:212)."""
        from ..core.eval.mot import eval_mot

        gts_by_video: Dict[int, List] = {}
        preds_by_video: Dict[int, List] = {}
        for info, res in zip(self.data_infos, results):
            vid = info["video_id"]
            ann = self.get_ann_info(info)
            anns = self.coco.img_to_anns[info["id"]]
            ids = np.asarray([a.get("instance_id", -1) for a in anns
                              if not a.get("iscrowd", 0)
                              and a["category_id"] in self.cat2label
                              and a["bbox"][2] >= 1 and a["bbox"][3] >= 1],
                             np.int64)
            gts_by_video.setdefault(vid, []).append(
                dict(bboxes=ann["bboxes"], ids=ids)
            )
            tb = np.asarray(res.get("track_bboxes", np.zeros((0, 6))))
            preds_by_video.setdefault(vid, []).append(
                dict(bboxes=tb[:, 1:5] if len(tb) else np.zeros((0, 4)),
                     ids=tb[:, 0].astype(np.int64) if len(tb) else
                     np.zeros((0,), np.int64))
            )
        return eval_mot(list(gts_by_video.values()),
                        list(preds_by_video.values()), iou_thr=iou_thr)


class LaSOTDataset(CocoVideoDataset):
    """Single-object tracking test set; first-frame bbox is the template."""

    CLASSES = ("object",)

    def get_video(self, vid_index: int) -> Dict:
        """Returns dict(frames=[img_info...], gt_bboxes=[T, 4] xyxy)."""
        vid_ids = self.coco.get_vid_ids()
        vid = vid_ids[vid_index]
        img_ids = self.coco.get_img_ids_from_vid(vid)
        infos, boxes = [], []
        for i in img_ids:
            info = dict(self.coco.load_imgs([i])[0])
            info["filename"] = info.get("file_name")
            infos.append(info)
            ann = self.get_ann_info(info)
            boxes.append(ann["bboxes"][0] if len(ann["bboxes"])
                         else np.full((4,), np.nan, np.float32))
        return dict(frames=infos, gt_bboxes=np.stack(boxes))

    @property
    def num_videos(self) -> int:
        return len(self.coco.get_vid_ids())

    def evaluate(self, results: List[np.ndarray]) -> Dict[str, float]:
        """OPE success/precision (eval_sot_ope.py): results[v] = [T, 4]
        tracked xyxy boxes per video."""
        from ..core.eval.sot import eval_sot_ope

        gts, preds = [], []
        for v in range(self.num_videos):
            video = self.get_video(v)
            g = video["gt_bboxes"]
            p = np.asarray(results[v])
            keep = ~np.isnan(g).any(axis=1)
            gts.append([g[t] for t in range(len(g)) if keep[t]])
            preds.append([p[t] for t in range(len(p)) if keep[t]])
        return eval_sot_ope(preds, gts)


class SOTTrainDataset(CocoVideoDataset):
    """Template and search pairs (mmtrack's ``sot_train_dataset.py``): a
    positive pair is the frame and another of its video within
    ``max_frame_range``; with probability ``neg_pair_ratio`` the search
    frame is any frame of the dataset instead, a negative pair unless it
    falls in the same video."""

    CLASSES = ("object",)

    def __init__(self, *args, max_frame_range: int = 100,
                 neg_pair_ratio: float = 0.2, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_frame_range = max_frame_range
        self.neg_pair_ratio = neg_pair_ratio

    def sample_pair(self, idx: int, rng: Optional[random.Random] = None):
        """(template sample, search sample, is_positive), every draw from
        ``rng`` (the dataset's own when None) in the JAX package's order:
        the pair kind, then the reference frame or the other index."""
        rng = rng if rng is not None else self.rng
        info = dict(self.data_infos[idx])
        is_positive = rng.random() >= self.neg_pair_ratio
        if is_positive:
            other = self.ref_img_sampling(
                info, frame_range=self.max_frame_range, num_ref_imgs=1,
                filter_key_img=False, method="uniform", rng=rng)[0]
        else:
            other = dict(self.data_infos[rng.randrange(len(self.data_infos))])
            if other.get("video_id") == info.get("video_id"):
                is_positive = True  # the same video: a positive pair
        t = dict(img_info=info, ann=self.get_ann_info(info))
        s = dict(img_info=other, ann=self.get_ann_info(other))
        return t, s, is_positive
