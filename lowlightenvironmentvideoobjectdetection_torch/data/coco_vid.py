"""COCO-VID annotation index, the port's copy of the JAX package's
``data/coco_vid.py`` (``CocoVID``): a COCO json with a ``videos`` table,
per-image ``video_id`` / ``frame_id`` and per-annotation ``instance_id``."""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence


class CocoVID:
    def __init__(self, ann_file: Optional[str] = None,
                 dataset: Optional[Dict] = None):
        if dataset is None:
            with open(ann_file) as f:
                dataset = json.load(f)
        self.dataset = dataset
        d = dataset
        self.videos = {v["id"]: v for v in d.get("videos", [])}
        self.imgs = {i["id"]: i for i in d.get("images", [])}
        self.anns = {a["id"]: a for a in d.get("annotations", [])}
        self.cats = {c["id"]: c for c in d.get("categories", [])}
        self.vid_to_imgs: Dict[int, List[dict]] = defaultdict(list)
        for img in d.get("images", []):
            self.vid_to_imgs[img.get("video_id", -1)].append(img)
        for imgs in self.vid_to_imgs.values():
            imgs.sort(key=lambda x: x.get("frame_id", 0))
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        for ann in d.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)
        self.ins_ids = sorted({a["instance_id"]
                               for a in d.get("annotations", [])
                               if "instance_id" in a})

    def get_vid_ids(self) -> List[int]:
        return sorted(self.videos)

    def get_img_ids_from_vid(self, vid_id: int) -> List[int]:
        """The video's image ids in frame order."""
        return [img["id"] for img in self.vid_to_imgs[vid_id]]

    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs)

    def get_cat_ids(self, cat_names: Optional[Sequence[str]] = None
                    ) -> List[int]:
        if cat_names is None:
            return sorted(self.cats)
        by_name = {c["name"]: c["id"] for c in self.cats.values()}
        return [by_name[n] for n in cat_names if n in by_name]

    def get_ann_ids(self, img_ids: Sequence[int]) -> List[int]:
        return [a["id"] for i in img_ids for a in self.img_to_anns[i]]

    def load_imgs(self, ids: Sequence[int]) -> List[dict]:
        return [self.imgs[i] for i in ids]

    def load_anns(self, ids: Sequence[int]) -> List[dict]:
        return [self.anns[i] for i in ids]

    def get_ins_ids(self) -> List[int]:
        return self.ins_ids
