"""COCO image detection dataset, the counterpart of the JAX package's
``data/coco_det.py`` ``CocoDataset`` (mmdet's ``datasets/coco.py``): a
plain COCO json read with the COCO-VID parser (no ``videos`` table, every
image on its own), the images without annotations dropped in training,
``get_ann_info`` (xyxy boxes and labels; crowd, ignored, other-category and
sub-pixel boxes dropped). Registered in ``data/datasets.py``'s ``DATASETS``
as ``CocoDataset``. Samples are ``dict(img_info, ann)``; ``get_sample``
takes the loader's ``random.Random`` and draws nothing from it.

``MultiScaleFlipAug`` (mmdet's ``pipelines/test_time_aug.py``, registered
in ``PIPELINES`` as the JAX package registers it) runs its inner steps once
for each (scale, flip) on a copy of a frame and returns the list of
prepared dicts, the scales major, each with ``scale_factor`` (from its
``Resize``), ``flip`` and ``scale``. As in JAX, each scale has its own
inner steps with the ``Resize``'s (or any step's) ``img_scale`` set to it,
and the flip mirrors the prepared image (after any ``Normalize`` and
``Pad``) along its width. It is a device step: the frame's image is a
tensor when it runs, as ``Compose`` moves a frame to its device after the
loading steps. The JAX package's ``merge_aug_detections`` and
``unflip_boxes`` are not ported (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils.data import Dataset

from ..registry import PIPELINES
from .coco_vid import CocoVID

COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
)


class CocoDataset(Dataset):
    CLASSES: Sequence[str] = COCO_CLASSES
    is_video = False

    def __init__(self, ann_file: str, img_prefix: str = "",
                 test_mode: bool = False, filter_empty_gt: bool = True,
                 classes: Optional[Sequence[str]] = None,
                 ref_img_sampler: Optional[dict] = None):
        if ref_img_sampler:
            raise ValueError("CocoDataset is an image dataset: it samples "
                             "no reference frames")
        self.coco = CocoVID(ann_file)
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        self.rng = random.Random(0)
        if classes is not None:
            self.CLASSES = tuple(classes)
        self.cat_ids = self.coco.get_cat_ids(self.CLASSES or None)
        self.cat2label = {c: i for i, c in enumerate(self.cat_ids)}
        self.data_infos: List[dict] = []
        for img_id in self.coco.get_img_ids():
            info = dict(self.coco.load_imgs([img_id])[0])
            info["filename"] = info.get("file_name")
            self.data_infos.append(info)
        if not test_mode and filter_empty_gt:
            self.data_infos = [d for d in self.data_infos
                               if len(self.coco.img_to_anns[d["id"]]) > 0]

    def __len__(self):
        return len(self.data_infos)

    def get_ann_info(self, img_info: dict) -> Dict[str, np.ndarray]:
        boxes, labels = [], []
        for a in self.coco.img_to_anns[img_info["id"]]:
            if a.get("iscrowd", 0) or a.get("ignore", 0):
                continue
            if a["category_id"] not in self.cat2label:
                continue
            x, y, w, h = a["bbox"]
            if w < 1 or h < 1:
                continue
            boxes.append([x, y, x + w, y + h])
            labels.append(self.cat2label[a["category_id"]])
        return dict(bboxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                    labels=np.asarray(labels, np.int64))

    def get_sample(self, idx: int, rng: Optional[random.Random] = None
                   ) -> dict:
        info = dict(self.data_infos[idx])
        return dict(img_info=info, ann=self.get_ann_info(info))

    def __getitem__(self, idx: int) -> dict:
        return self.get_sample(idx)


def _copied(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, np.ndarray):
        return v.copy()
    return dict(v) if isinstance(v, dict) else v


@PIPELINES.register("MultiScaleFlipAug")
class MultiScaleFlipAug:
    def __init__(self, transforms: List[dict], img_scale, flip: bool = False,
                 flip_direction: str = "horizontal"):
        if flip_direction != "horizontal":
            raise ValueError(f"flip_direction {flip_direction!r}: the JAX "
                             f"package flips horizontally only")
        self.img_scales = (img_scale if isinstance(img_scale, list)
                           else [img_scale])
        self.flip = flip
        self.flip_direction = flip_direction
        self.pipelines = []
        for scale in self.img_scales:
            steps = []
            for t in transforms:
                cfg = dict(t)
                if "img_scale" in cfg or cfg.get("type") == "Resize":
                    cfg["img_scale"] = scale
                step = PIPELINES.get(cfg.pop("type"))(**cfg)
                if getattr(step, "on_host", False):
                    raise ValueError("MultiScaleFlipAug: a loading step "
                                     "belongs before it")
                steps.append(step)
            self.pipelines.append(steps)

    def __call__(self, results: dict, rng=None) -> List[dict]:
        outs = []
        for steps, scale in zip(self.pipelines, self.img_scales):
            for flip in ([False, True] if self.flip else [False]):
                r = {k: _copied(v) for k, v in results.items()}
                for step in steps:
                    r = step(r, rng)
                if flip:
                    img = r["img"]
                    r["img"] = (img.flip(1) if isinstance(img, torch.Tensor)
                                else np.ascontiguousarray(img[:, ::-1]))
                r["flip"] = flip
                r["scale"] = scale
                outs.append(r)
        return outs
