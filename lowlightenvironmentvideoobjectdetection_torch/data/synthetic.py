"""A synthetic DarkFarm-layout tree of PNG frame pairs and its COCO-VID
annotation file, made from a seed, for smoke runs and tests (the DarkFarm
frames are not in the repository):

    ROOT/annotations/darkfarm_train.json
    ROOT/video_<v>/low/<frame:06d>.png   dark, noisy frames
    ROOT/video_<v>/GT/<frame:06d>.png    bright, clean frames

Every frame has 1-8 boxes of DarkFarm's 8 classes (category ids 1-8), each
tracked as one instance through its video, and is a training frame. The
PNGs have no row filter and zlib level 1, written by 8 threads.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np

from .datasets import DARKFARM_CLASSES
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


def write_darkfarm_tree(root: str, videos: int = 2, frames: int = 10,
                        hw: Tuple[int, int] = (1080, 1920), seed: int = 0
                        ) -> str:
    """Write the tree under ``root``; returns the annotation file's
    path."""
    noisy_dir = "low"
    rng = np.random.default_rng(seed)
    h, w = hw
    ann = dict(videos=[], images=[], annotations=[],
               categories=[dict(id=i + 1, name=n)
                           for i, n in enumerate(DARKFARM_CLASSES)])
    jobs = []
    for v in range(videos):
        name = f"video_{v}"
        ann["videos"].append(dict(id=v + 1, name=name))
        for d in (noisy_dir, "GT"):
            os.makedirs(os.path.join(root, name, d), exist_ok=True)
        n_box = int(rng.integers(1, 9))
        bw = rng.integers(max(w // 20, 2), max(w // 4, 3), n_box)
        bh = rng.integers(max(h // 20, 2), max(h // 4, 3), n_box)
        x0 = rng.integers(0, w - bw)
        y0 = rng.integers(0, h - bh)
        cls = rng.integers(1, len(DARKFARM_CLASSES) + 1, n_box)
        for f in range(frames):
            img_id = len(ann["images"]) + 1
            fname = f"{f:06d}.png"
            ann["images"].append(dict(
                id=img_id, video_id=v + 1, frame_id=f, width=w, height=h,
                file_name=f"{name}/{noisy_dir}/{fname}",
                is_vid_train_frame=True))
            x = np.clip(x0 + 2 * f, 0, w - bw)
            boxes = list(zip(x.tolist(), y0.tolist(), bw.tolist(),
                             bh.tolist(), cls.tolist()))
            for i, (bx, by, bww, bhh, c) in enumerate(boxes):
                ann["annotations"].append(dict(
                    id=len(ann["annotations"]) + 1, video_id=v + 1,
                    image_id=img_id, category_id=c, instance_id=i + 1,
                    bbox=[bx, by, bww, bhh], area=bww * bhh, iscrowd=False))
            noisy, clean = _frames(rng, hw, boxes)
            jobs += [(os.path.join(root, name, noisy_dir, fname), noisy),
                     (os.path.join(root, name, "GT", fname), clean)]
    with ThreadPoolExecutor(8) as pool:
        for fut in [pool.submit(imwrite_png, p, img, 0, 1)
                    for p, img in jobs]:
            fut.result()
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    path = os.path.join(root, "annotations", "darkfarm_train.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    return path
