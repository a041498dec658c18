"""Video detection datasets over COCO-VID with reference-frame sampling, the
port's copy of the JAX package's ``data/datasets.py``
(``CocoVideoDataset``, ``ImagenetVIDDataset``, ``DarkFarmVIDDataset``) as
``torch.utils.data.Dataset``s.

The reference-frame sampler draws from a ``random.Random``: the one given
to ``get_sample``, or for ``dataset[idx]`` the dataset's own. Given a
generator in the state of the JAX package's global ``random``, it draws the
same frames (the same calls in the same order).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence

import numpy as np
from torch.utils.data import Dataset

from .coco_vid import CocoVID

IMAGENET_VID_CLASSES = (
    "airplane", "antelope", "bear", "bicycle", "bird", "bus", "car",
    "cattle", "dog", "domestic_cat", "elephant", "fox", "giant_panda",
    "hamster", "horse", "lion", "lizard", "monkey", "motorcycle", "rabbit",
    "red_panda", "sheep", "snake", "squirrel", "tiger", "train", "turtle",
    "watercraft", "whale", "zebra",
)

DARKFARM_CLASSES = (
    "person", "cow", "sheep", "dog", "rabbit", "cat", "hen", "duck",
)


class CocoVideoDataset(Dataset):
    """Key frames of every video (every ``key_img_interval``-th; in
    training only frames with an annotation and ``is_vid_train_frame``),
    each with its annotations and, with ``ref_img_sampler``, its reference
    frames and theirs. Samples are dicts of host numpy arrays; the
    pipelines take them from there."""

    CLASSES: Sequence[str] = ()

    def __init__(self, ann_file: str, img_prefix: str = "",
                 key_img_interval: int = 1,
                 ref_img_sampler: Optional[Dict] = None,
                 test_mode: bool = False,
                 classes: Optional[Sequence[str]] = None,
                 filter_empty_gt: bool = True,
                 rng: Optional[random.Random] = None):
        self.coco = CocoVID(ann_file)
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        self.ref_img_sampler = ref_img_sampler
        self.rng = rng if rng is not None else random.Random(0)
        if classes is not None:
            self.CLASSES = tuple(classes)
        self.cat_ids = self.coco.get_cat_ids(self.CLASSES or None)
        self.cat2label = {c: i for i, c in enumerate(self.cat_ids)}
        self.data_infos: List[dict] = []
        for vid_id in self.coco.get_vid_ids():
            for img_id in self.coco.get_img_ids_from_vid(
                    vid_id)[::key_img_interval]:
                info = dict(self.coco.load_imgs([img_id])[0])
                info["filename"] = info.get("file_name")
                self.data_infos.append(info)
        if not test_mode and filter_empty_gt:
            self.data_infos = [
                d for d in self.data_infos
                if self.coco.img_to_anns[d["id"]]
                and d.get("is_vid_train_frame", True)]

    def __len__(self):
        return len(self.data_infos)

    def ref_img_sampling(self, img_info: dict, frame_range, stride: int = 1,
                         num_ref_imgs: int = 1, filter_key_img: bool = True,
                         method: str = "uniform",
                         keep_samples_length: bool = True,
                         rng: Optional[random.Random] = None) -> List[dict]:
        """The reference frames' infos sorted by frame_id, the key excluded
        (``filter_key_img``) where the range has another frame. Methods:
        'uniform' and 'bilateral_uniform' (half left, half right of the
        key; short ranges repeat frames drawn with replacement when
        ``keep_samples_length``) for training; 'test_with_adaptive_stride'
        and 'test_with_fix_stride' for streaming tests."""
        rng = rng if rng is not None else self.rng
        if isinstance(frame_range, int):
            frame_range = [-frame_range, frame_range]
        frame_id = img_info.get("frame_id", -1)
        if frame_id < 0 or (frame_range[0] == 0 and frame_range[1] == 0):
            return [dict(img_info) for _ in range(num_ref_imgs)]
        vid_id, img_id = img_info["video_id"], img_info["id"]
        img_ids = self.coco.get_img_ids_from_vid(vid_id)
        left = max(0, frame_id + frame_range[0])
        right = min(frame_id + frame_range[1], len(img_ids) - 1)

        def draw(valid, k):
            if filter_key_img and img_id in valid and len(valid) > 1:
                valid.remove(img_id)
            if keep_samples_length and k > len(valid):
                return sorted(valid + rng.choices(valid, k=k - len(valid)))
            return rng.sample(valid, min(k, len(valid)))

        ref_img_ids: List[int] = []
        if method == "uniform":
            ref_img_ids = draw(list(img_ids[left:right + 1]), num_ref_imgs)
        elif method == "bilateral_uniform":
            if num_ref_imgs % 2:
                raise ValueError("bilateral_uniform takes an even "
                                 "num_ref_imgs")
            half = num_ref_imgs // 2
            ref_img_ids = (draw(list(img_ids[left:frame_id + 1]), half)
                           + draw(list(img_ids[frame_id:right + 1]), half))
        elif method == "test_with_adaptive_stride":
            if frame_id == 0:
                s = float(len(img_ids) - 1) / max(num_ref_imgs - 1, 1)
                ref_img_ids = [img_ids[round(i * s)]
                               for i in range(num_ref_imgs)]
        elif method == "test_with_fix_stride":
            last = len(img_ids) - 1
            if frame_id == 0:
                ref_img_ids = [img_ids[0]] * (1 - frame_range[0]) + [
                    img_ids[min(round(i * stride), last)]
                    for i in range(1, frame_range[1] + 1)]
            elif frame_id % stride == 0:
                ref_img_ids = [img_ids[min(
                    round(frame_id + frame_range[1] * stride), last)]]
            img_info["num_left_ref_imgs"] = abs(frame_range[0])
            img_info["frame_stride"] = stride
        else:
            raise NotImplementedError(method)
        infos = [dict(self.coco.load_imgs([i])[0]) for i in ref_img_ids]
        for inf in infos:
            inf["filename"] = inf.get("file_name")
        return sorted(infos, key=lambda i: i.get("frame_id", 0))

    def get_ann_info(self, img_info: dict) -> Dict[str, np.ndarray]:
        """xyxy boxes, labels and instance ids of one image; crowd and
        ignored boxes, other categories and boxes under 1 px go."""
        boxes, labels, ins_ids = [], [], []
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
            ins_ids.append(a.get("instance_id", -1))
        return dict(bboxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                    labels=np.asarray(labels, np.int64),
                    instance_ids=np.asarray(ins_ids, np.int64))

    def get_sample(self, idx: int, rng: random.Random) -> dict:
        """Sample ``idx`` with its reference frames drawn from ``rng``."""
        info = dict(self.data_infos[idx])
        sample = dict(img_info=info, ann=self.get_ann_info(info))
        if self.ref_img_sampler is not None:
            refs = self.ref_img_sampling(info, **self.ref_img_sampler,
                                         rng=rng)
            sample["ref_img_infos"] = refs
            if not self.test_mode:
                sample["ref_anns"] = [self.get_ann_info(r) for r in refs]
        return sample

    def __getitem__(self, idx: int) -> dict:
        return self.get_sample(idx, self.rng)


class ImagenetVIDDataset(CocoVideoDataset):
    CLASSES = IMAGENET_VID_CLASSES


class DarkFarmVIDDataset(CocoVideoDataset):
    CLASSES = DARKFARM_CLASSES


DATASETS = {"ImagenetVIDDataset": ImagenetVIDDataset,
            "DarkFarmVIDDataset": DarkFarmVIDDataset}
