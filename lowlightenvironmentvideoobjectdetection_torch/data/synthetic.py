"""Synthetic trees of PNG frames and their COCO-VID annotation files, made
from a seed, for smoke runs and tests (the datasets' frames are not in the
repository).

``write_darkfarm_tree``, the DarkFarm layout of frame pairs::

    ROOT/annotations/darkfarm_train.json
    ROOT/video_<v>/low/<frame:06d>.png   dark, noisy frames
    ROOT/video_<v>/GT/<frame:06d>.png    bright, clean frames

Every frame has 1-8 boxes of DarkFarm's 8 classes (category ids 1-8), each
tracked as one instance through its video, and is a training frame.

``write_imagenet_vid_tree``, the ImageNet-VID layout of single frames
(``img_prefix`` ROOT/Data/VID, as the configs' ``data_root``)::

    ROOT/annotations/imagenet_vid_train.json, imagenet_vid_val.json
    ROOT/Data/VID/<split>/ILSVRC2015_<split>_<v:08d>/<frame:06d>.png

Every frame has 1-8 boxes of ImageNet-VID's 30 classes (ids 1-30), every
train frame is a training frame. The PNGs have no row filter and zlib level
1, written by 8 threads.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np

from .datasets import DARKFARM_CLASSES, IMAGENET_VID_CLASSES
from .image_io import imwrite_png


def _frames(rng, hw, boxes):
    """A bright clean BGR frame (a gradient, texture and filled boxes) and
    its dark noisy copy (an eighth of the signal plus noise)."""
    h, w = hw
    clean = np.empty((h, w, 3), np.uint8)
    grad = np.linspace(60, 200, w, dtype=np.float32)
    clean[:] = grad[None, :, None].astype(np.uint8)
    clean[::7] += 20
    for x, y, bw, bh, c in boxes:
        clean[y:y + bh, x:x + bw] = (30 * c) % 256
    noise = rng.integers(0, 6, (h, w, 1), dtype=np.uint8)
    noisy = clean // 8 + noise
    return noisy, clean


def _videos(rng, classes, videos: int, frames: int, hw, video_name,
            frame_name, frame_images):
    """The COCO-VID annotations of ``videos`` videos of ``frames`` frames,
    each with 1-8 boxes moving right by 2 px a frame; ``frame_images(name,
    boxes)`` gives each frame's (path, image) jobs, called in frame order
    (it draws from ``rng`` too). Returns (ann, jobs)."""
    h, w = hw
    ann = dict(videos=[], images=[], annotations=[],
               categories=[dict(id=i + 1, name=n)
                           for i, n in enumerate(classes)])
    jobs = []
    for v in range(videos):
        ann["videos"].append(dict(id=v + 1, name=video_name(v)))
        n_box = int(rng.integers(1, 9))
        bw = rng.integers(max(w // 20, 2), max(w // 4, 3), n_box)
        bh = rng.integers(max(h // 20, 2), max(h // 4, 3), n_box)
        x0 = rng.integers(0, w - bw)
        y0 = rng.integers(0, h - bh)
        cls = rng.integers(1, len(classes) + 1, n_box)
        for f in range(frames):
            img_id = len(ann["images"]) + 1
            name = frame_name(v, f)
            ann["images"].append(dict(
                id=img_id, video_id=v + 1, frame_id=f, width=w, height=h,
                file_name=name, is_vid_train_frame=True))
            x = np.clip(x0 + 2 * f, 0, w - bw)
            boxes = list(zip(x.tolist(), y0.tolist(), bw.tolist(),
                             bh.tolist(), cls.tolist()))
            for i, (bx, by, bww, bhh, c) in enumerate(boxes):
                ann["annotations"].append(dict(
                    id=len(ann["annotations"]) + 1, video_id=v + 1,
                    image_id=img_id, category_id=c, instance_id=i + 1,
                    bbox=[bx, by, bww, bhh], area=bww * bhh, iscrowd=False))
            jobs += frame_images(name, boxes)
    return ann, jobs


def _write(root: str, jobs, ann: dict, ann_name: str) -> str:
    """The PNGs (path, image) of ``jobs`` (8 threads) and the annotation
    file ROOT/annotations/``ann_name``; returns its path."""
    for p, _ in jobs:
        os.makedirs(os.path.dirname(p), exist_ok=True)
    with ThreadPoolExecutor(8) as pool:
        for fut in [pool.submit(imwrite_png, p, img, 0, 1)
                    for p, img in jobs]:
            fut.result()
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    path = os.path.join(root, "annotations", ann_name)
    with open(path, "w") as f:
        json.dump(ann, f)
    return path


def write_darkfarm_tree(root: str, videos: int = 2, frames: int = 10,
                        hw: Tuple[int, int] = (1080, 1920), seed: int = 0
                        ) -> str:
    """Write the DarkFarm tree under ``root``; returns the annotation
    file's path."""
    rng = np.random.default_rng(seed)

    def pair(name, boxes):
        noisy, clean = _frames(rng, hw, boxes)
        return [(os.path.join(root, name), noisy),
                (os.path.join(root, name.replace("/low/", "/GT/")), clean)]

    ann, jobs = _videos(rng, DARKFARM_CLASSES, videos, frames, hw,
                        lambda v: f"video_{v}",
                        lambda v, f: f"video_{v}/low/{f:06d}.png", pair)
    return _write(root, jobs, ann, "darkfarm_train.json")


def write_imagenet_vid_tree(root: str, videos: int = 2, frames: int = 12,
                            hw: Tuple[int, int] = (720, 1280), seed: int = 0
                            ) -> Tuple[str, str]:
    """Write the ImageNet-VID tree under ``root``: ``videos`` training and
    ``videos`` validation videos of ``frames`` frames (the bright frames
    of ``write_darkfarm_tree``'s generator). Returns the train and the val
    annotation files' paths."""
    rng = np.random.default_rng(seed)
    prefix = os.path.join(root, "Data", "VID")
    paths = []
    for split in ("train", "val"):
        video = f"{split}/ILSVRC2015_{split}_{{:08d}}".format
        ann, jobs = _videos(
            rng, IMAGENET_VID_CLASSES, videos, frames, hw, video,
            lambda v, f: f"{video(v)}/{f:06d}.png",
            lambda name, boxes: [(os.path.join(prefix, name),
                                  _frames(rng, hw, boxes)[1])])
        paths.append(_write(root, jobs, ann, f"imagenet_vid_{split}.json"))
    return paths[0], paths[1]
