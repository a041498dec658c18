"""Synthetic trees of PNG frames and their COCO-VID annotation files, made
from a seed, for smoke runs and tests (the datasets' frames are not in the
repository), and a DarkFarm tree of JPEG frames copied from committed
fixtures.

``write_darkfarm_tree``, the DarkFarm layout of frame pairs::

    ROOT/annotations/darkfarm_train.json
    ROOT/video_<v>/low/<frame:06d>.png   dark, noisy frames
    ROOT/video_<v>/GT/<frame:06d>.png    bright, clean frames

Every frame has 1-8 boxes of DarkFarm's 8 classes (category ids 1-8), each
tracked as one instance through its video, and is a training frame.

``write_darkfarm_jpeg_tree``, the same layout with DarkFarm's own names
(``ROOT/video_<v>/low/<frame>.JPG`` and ``ROOT/video_<v>/GT/<frame>.JPG``)
and a train and a val annotation file: the host of the card cannot encode
JPEG, so every frame of a video is a copy of one of the 1080x1920 low / GT
pairs of ``tests/data/jpeg`` (cv2-written), annotated with the boxes drawn
into it (``manifest.json``). The frames repeat, which a smoke run allows.

``write_imagenet_vid_tree``, the ImageNet-VID layout of single frames
(``img_prefix`` ROOT/Data/VID, as the configs' ``data_root``)::

    ROOT/annotations/imagenet_vid_train.json, imagenet_vid_val.json
    ROOT/Data/VID/<split>/ILSVRC2015_<split>_<v:08d>/<frame:06d>.png

Every frame has 1-8 boxes of ImageNet-VID's 30 classes (ids 1-30), every
train frame is a training frame.

``write_mot_tree``, a MOT17-style tree for the tracking route
(``MOTChallengeDataset``)::

    ROOT/annotations/mot_test.json      COCO-VID, one class "pedestrian"
    ROOT/annotations/mot_dets.json      public detections, per frame
    ROOT/<video>/img1/<frame:06d>.png

Each video holds textured objects that move linearly, spaced so that each
stays far outside the others' motion gates; the public detections are
the ground truth jittered, with scores in [0.8, 1). ``write_lasot_tree``,
a LaSOT-style tree (``LaSOTDataset``): one textured object a video moving
linearly, ``ROOT/annotations/lasot_test.json`` and
``ROOT/<video>/img/<frame:08d>.png``.

``write_coco_tree``, a COCO-style image detection tree
(``CocoDataset``): ``ROOT/annotations/coco_{train,val}.json`` and
``ROOT/{train,val}2017/<image:012d>.png``, each image textured with 1-4
filled boxes of COCO's 80 classes (ids 1-80).

``write_voc_tree``, a Pascal VOC tree (``VOCDataset``)::

    ROOT/VOC<year>/ImageSets/Main/test.txt   the image ids
    ROOT/VOC<year>/Annotations/<id>.xml         size and objects
    ROOT/VOC<year>/JPEGImages/<id>.jpg

each image a copy of one of the 1080x1920 JPEG frames of ``tests/data/jpeg``
(the host of the card cannot encode JPEG), its objects the boxes drawn
into it (``manifest.json``) under VOC class names, every third one
``difficult``; ``write_voc_xml`` writes one annotation file.

The PNGs have no row filter and zlib level 1, written by 8 threads.
"""

from __future__ import annotations

import json
import os
import shutil
import xml.etree.ElementTree as ET
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np

from .coco_det import COCO_CLASSES
from .datasets import DARKFARM_CLASSES, IMAGENET_VID_CLASSES
from .image_io import imwrite_png
from .voc import VOC_CLASSES

JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "tests", "data", "jpeg")


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


def write_darkfarm_jpeg_tree(root: str, videos: int = 2,
                             val_videos: int = 2, frames: int = 10,
                             fixtures: str = JPEG_FIXTURES
                             ) -> Tuple[str, str]:
    """Write the DarkFarm JPEG tree under ``root``: ``videos`` training and
    ``val_videos`` validation videos of ``frames`` frames, video v copying
    fixture pair ``v % 2``. Returns the paths of
    ``annotations/darkfarm_train.json`` and ``darkfarm_val.json``."""
    with open(os.path.join(fixtures, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for split, n_videos, first in (("train", videos, 0),
                                   ("val", val_videos, videos)):
        ann = dict(videos=[], images=[], annotations=[],
                   categories=[dict(id=i + 1, name=n)
                               for i, n in enumerate(DARKFARM_CLASSES)])
        for v in range(first, first + n_videos):
            pair = {kind: os.path.join(fixtures,
                                       f"darkfarm_{v % 2}_{kind}.jpg")
                    for kind in ("low", "gt")}
            entry = manifest[os.path.basename(pair["low"])]
            h, w = entry["shape"][:2]
            video = f"video_{v}"
            ann["videos"].append(dict(id=v + 1, name=video))
            for sub in ("low", "GT"):
                os.makedirs(os.path.join(root, video, sub), exist_ok=True)
            for fid in range(frames):
                img_id = len(ann["images"]) + 1
                name = f"{video}/low/{fid}.JPG"
                shutil.copyfile(pair["low"], os.path.join(root, name))
                shutil.copyfile(pair["gt"], os.path.join(
                    root, video, "GT", f"{fid}.JPG"))
                ann["images"].append(dict(
                    id=img_id, video_id=v + 1, frame_id=fid, width=w,
                    height=h, file_name=name, is_vid_train_frame=True))
                for i, (x, y, bw, bh, c) in enumerate(entry["boxes"]):
                    ann["annotations"].append(dict(
                        id=len(ann["annotations"]) + 1, video_id=v + 1,
                        image_id=img_id, category_id=c, instance_id=i + 1,
                        bbox=[x, y, bw, bh], area=bw * bh, iscrowd=False))
        os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
        path = os.path.join(root, "annotations", f"darkfarm_{split}.json")
        with open(path, "w") as f:
            json.dump(ann, f)
        out.append(path)
    return out[0], out[1]


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


def _textured_frames(rng, videos, frames, hw, n_obj, speed, spacing):
    """Per video: a fixed textured background and ``n_obj`` textured
    objects in a row, each moving by its velocity (at most ``speed`` px a
    frame); returns per video (background, objects [(x, y, w, h, vx, vy,
    patch)])."""
    h, w = hw
    out = []
    for _ in range(videos):
        bg = (rng.integers(60, 120, (h, w, 3))).astype(np.uint8)
        ow = max(w // (3 * n_obj), 4)
        oh = max(h // 4, 6)
        objs = []
        for k in range(n_obj):
            x = k * w // n_obj + spacing
            y = int(rng.integers(0, max(h - oh - speed * frames, 1)))
            vx, vy = rng.uniform(-speed, speed), rng.uniform(0, speed)
            patch = np.clip(rng.integers(0, 256, (oh, ow, 3)).astype(
                np.int64) // 2 + 120 + 40 * k, 0, 255).astype(np.uint8)
            objs.append((x, y, ow, oh, vx, vy, patch))
        out.append((bg, objs))
    return out


def _draw(bg, objs, f):
    img = bg.copy()
    boxes = []
    h, w = bg.shape[:2]
    for x, y, ow, oh, vx, vy, patch in objs:
        bx = int(np.clip(round(x + vx * f), 0, w - ow))
        by = int(np.clip(round(y + vy * f), 0, h - oh))
        img[by:by + oh, bx:bx + ow] = patch
        boxes.append([bx, by, ow, oh])
    return img, boxes


def write_mot_tree(root: str, videos: int = 1, frames: int = 4,
                   hw: Tuple[int, int] = (64, 64), objects: int = 2,
                   seed: int = 0, jitter: float = 1.0) -> Tuple[str, str]:
    """Write the MOT tree under ``root``; returns the annotation file's and
    the detection file's paths."""
    rng = np.random.default_rng(seed)
    ann = dict(videos=[], images=[], annotations=[],
               categories=[dict(id=1, name="pedestrian")])
    dets, jobs = [], []
    speed = max(hw[1] / 200.0, 1.0)
    for v, (bg, objs) in enumerate(_textured_frames(
            rng, videos, frames, hw, objects, speed, 2)):
        name = f"MOT17-{v + 2:02d}-SYN"
        ann["videos"].append(dict(id=v + 1, name=name))
        for f in range(frames):
            img, boxes = _draw(bg, objs, f)
            img_id = len(ann["images"]) + 1
            file_name = f"{name}/img1/{f + 1:06d}.png"
            ann["images"].append(dict(id=img_id, video_id=v + 1, frame_id=f,
                                      width=hw[1], height=hw[0],
                                      file_name=file_name))
            frame_dets = []
            for k, (bx, by, bw, bh) in enumerate(boxes):
                ann["annotations"].append(dict(
                    id=len(ann["annotations"]) + 1, video_id=v + 1,
                    image_id=img_id, category_id=1, instance_id=k + 1,
                    bbox=[bx, by, bw, bh], area=bw * bh, iscrowd=False,
                    visibility=1.0))
                d = np.array([bx, by, bx + bw, by + bh], np.float64) \
                    + rng.uniform(-jitter, jitter, 4)
                frame_dets.append(d.tolist() + [float(rng.uniform(0.8, 1))])
            dets.append(frame_dets)
            jobs.append((os.path.join(root, file_name), img))
    path = _write(root, jobs, ann, "mot_test.json")
    det_path = os.path.join(root, "annotations", "mot_dets.json")
    with open(det_path, "w") as f:
        json.dump(dets, f)
    return path, det_path


def write_lasot_tree(root: str, videos: int = 2, frames: int = 4,
                     hw: Tuple[int, int] = (96, 128), seed: int = 0) -> str:
    """Write the LaSOT tree under ``root``; returns the annotation file's
    path."""
    rng = np.random.default_rng(seed)
    ann = dict(videos=[], images=[], annotations=[],
               categories=[dict(id=1, name="object")])
    jobs = []
    speed = max(hw[1] / 100.0, 1.0)
    for v, (bg, objs) in enumerate(_textured_frames(
            rng, videos, frames, hw, 1, speed, hw[1] // 4)):
        name = f"object-{v + 1}"
        ann["videos"].append(dict(id=v + 1, name=name))
        for f in range(frames):
            img, boxes = _draw(bg, objs, f)
            img_id = len(ann["images"]) + 1
            file_name = f"{name}/img/{f + 1:08d}.png"
            ann["images"].append(dict(id=img_id, video_id=v + 1, frame_id=f,
                                      width=hw[1], height=hw[0],
                                      file_name=file_name))
            bx, by, bw, bh = boxes[0]
            ann["annotations"].append(dict(
                id=len(ann["annotations"]) + 1, video_id=v + 1,
                image_id=img_id, category_id=1, instance_id=1,
                bbox=[bx, by, bw, bh], area=bw * bh, iscrowd=False))
            jobs.append((os.path.join(root, file_name), img))
    return _write(root, jobs, ann, "lasot_test.json")


def write_coco_tree(root: str, images: int = 8, val_images: int = 8,
                    hw: Tuple[int, int] = (480, 640), seed: int = 0
                    ) -> Tuple[str, str]:
    """Write the COCO tree under ``root``: ``images`` training and
    ``val_images`` validation images. Returns the train and the val
    annotation files' paths."""
    rng = np.random.default_rng(seed)
    h, w = hw
    paths = []
    for split, n in (("train", images), ("val", val_images)):
        ann = dict(images=[], annotations=[],
                   categories=[dict(id=i + 1, name=c)
                               for i, c in enumerate(COCO_CLASSES)])
        jobs = []
        for i in range(n):
            img = rng.integers(40, 120, (h, w, 3)).astype(np.uint8)
            img_id = len(ann["images"]) + 1
            name = f"{split}2017/{img_id:012d}.png"
            ann["images"].append(dict(id=img_id, width=w, height=h,
                                      file_name=name))
            for _ in range(int(rng.integers(1, 5))):
                bw = int(rng.integers(w // 10, w // 3))
                bh = int(rng.integers(h // 10, h // 3))
                x = int(rng.integers(0, w - bw))
                y = int(rng.integers(0, h - bh))
                c = int(rng.integers(1, len(COCO_CLASSES) + 1))
                img[y:y + bh, x:x + bw] = rng.integers(130, 256, 3)
                ann["annotations"].append(dict(
                    id=len(ann["annotations"]) + 1, image_id=img_id,
                    category_id=c, bbox=[x, y, bw, bh], area=bw * bh,
                    iscrowd=0))
            jobs.append((os.path.join(root, name), img))
        paths.append(_write(root, jobs, ann, f"coco_{split}.json"))
    return paths[0], paths[1]


VOC_FIXTURES = ("darkfarm_0_low.jpg", "darkfarm_1_low.jpg",
                "darkfarm_0_gt.jpg", "darkfarm_1_gt.jpg")


def write_voc_xml(path: str, filename: str, hw: Tuple[int, int],
                  objects: Sequence[tuple]) -> None:
    """A VOC annotation file: ``objects`` of (class name, (xmin, ymin, xmax,
    ymax) in VOC's 1-based pixels, difficult)."""
    root = ET.Element("annotation")
    ET.SubElement(root, "filename").text = filename
    size = ET.SubElement(root, "size")
    for k, v in (("width", hw[1]), ("height", hw[0]), ("depth", 3)):
        ET.SubElement(size, k).text = str(v)
    for name, box, difficult in objects:
        obj = ET.SubElement(root, "object")
        ET.SubElement(obj, "name").text = name
        ET.SubElement(obj, "difficult").text = str(int(difficult))
        bnd = ET.SubElement(obj, "bndbox")
        for k, v in zip(("xmin", "ymin", "xmax", "ymax"), box):
            ET.SubElement(bnd, k).text = str(int(round(v)))
    ET.ElementTree(root).write(path)


def write_voc_tree(root: str, images: int = 8, year: int = 2007,
                   objects: Optional[Sequence[Sequence[tuple]]] = None,
                   fixtures: str = JPEG_FIXTURES) -> Tuple[str, str]:
    """Write the VOC tree under ``root``: ``images`` images, image i a copy
    of fixture ``VOC_FIXTURES[i % 4]``, with ``objects[i]`` (as
    ``write_voc_xml`` takes them) or the fixture's boxes. Returns the
    image-set file (``test.txt``) and the ``img_prefix``
    (``ROOT/VOC<year>/``)."""
    with open(os.path.join(fixtures, "manifest.json")) as f:
        manifest = json.load(f)
    rng = np.random.default_rng(0)
    prefix = os.path.join(root, f"VOC{year}")
    for sub in ("ImageSets/Main", "Annotations", "JPEGImages"):
        os.makedirs(os.path.join(prefix, sub), exist_ok=True)
    ids = []
    for i in range(images):
        fixture = VOC_FIXTURES[i % len(VOC_FIXTURES)]
        entry = manifest[fixture.replace("_gt", "_low")]
        img_id = f"{year}_{i:06d}"
        ids.append(img_id)
        shutil.copyfile(os.path.join(fixtures, fixture),
                        os.path.join(prefix, "JPEGImages", f"{img_id}.jpg"))
        if objects is None:
            objs = [(VOC_CLASSES[int(rng.integers(len(VOC_CLASSES)))],
                     (x + 1, y + 1, x + bw, y + bh), k % 3 == 2)
                    for k, (x, y, bw, bh, _) in enumerate(entry["boxes"])]
        else:
            objs = objects[i]
        write_voc_xml(os.path.join(prefix, "Annotations", f"{img_id}.xml"),
                      f"{img_id}.jpg", entry["shape"][:2], objs)
    ann = os.path.join(prefix, "ImageSets", "Main", "test.txt")
    with open(ann, "w") as f:
        f.write("\n".join(ids) + "\n")
    return ann, prefix + "/"
