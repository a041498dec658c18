"""SiamRPN++ training pairs: ``SOTTrainDataset`` pairs through mmtrack's
SOT training pipeline into ``SOTBatch``es, on the host.

A pair's two frames are read as BGR uint8 (``data/image_io.py``), cropped
around their first box with context to 511 px (``SeqCropLikeSiamFC``),
shifted and scaled to the 127 px template and the 255 px search crop
(``SeqShiftScaleAug``), colour-mixed (``SeqColorAug``) and, the search
crop with probability 0.2, blurred (``SeqBlurAug``), as mmtrack's
``siamese_rpn_r50_1x_lasot`` train pipeline does (on uint8 frames: the
port's resize is cv2's uint8 one). The crops stay raw float32 pixels, as
the tracker feeds them; the search crop's gt becomes (cx, cy, w, h)
relative to the crop's centre, the frame of ``sot_grid_anchors``.

Each sample's draws come from ``random.Random`` and
``np.random.RandomState`` seeded from (seed, step) (``data/loader.py``
``sample_seed``); one permutation of the dataset an epoch.
"""

from __future__ import annotations

import os
import random
from typing import Iterator, NamedTuple

import numpy as np
import torch

from .image_io import imread
from .loader import sample_seed
from .mot_sot_datasets import SOTTrainDataset
from .pipelines.transforms import (SeqBlurAug, SeqColorAug,
                                   SeqCropLikeSiamFC, SeqShiftScaleAug)

EXEMPLAR_SIZE, SEARCH_SIZE, CROP_SIZE = 127, 255, 511


class SOTBatch(NamedTuple):
    z_img: torch.Tensor  # [127, 127, 3] float32 template crop
    x_img: torch.Tensor  # [255, 255, 3] float32 search crop
    gt_cxcywh: torch.Tensor  # [4] the search gt about the crop's centre
    is_positive: torch.Tensor  # [] bool


class SOTPipeline:
    """mmtrack's SiamRPN++ train pipeline after loading, for the template
    and search sizes given (the context crop scales with the template)."""

    def __init__(self, exemplar_size: int = EXEMPLAR_SIZE,
                 search_size: int = SEARCH_SIZE):
        self.search_size = search_size
        crop = int(CROP_SIZE * exemplar_size / EXEMPLAR_SIZE)
        self.steps = (SeqCropLikeSiamFC(0.5, exemplar_size, crop),
                      SeqShiftScaleAug((exemplar_size, search_size), (4, 64),
                                       (0.05, 0.18)),
                      SeqColorAug((1.0, 1.0)), SeqBlurAug((0.0, 0.2)))

    def __call__(self, frames, rng: random.Random,
                 np_rng: np.random.RandomState):
        crop, shift, color, blur = self.steps
        frames = shift(crop(frames), rng)
        return blur(color(frames, rng, np_rng), rng)


def pair_sample(ds: SOTTrainDataset, idx: int, rng: random.Random,
                np_rng: np.random.RandomState,
                pipeline: SOTPipeline) -> tuple:
    """(z [127, 127, 3], x [255, 255, 3], gt [4], is_positive) as numpy
    (at the pipeline's sizes)."""
    t, s, positive = ds.sample_pair(idx, rng)
    frames = []
    for smp in (t, s):
        info = smp["img_info"]
        img = imread(os.path.join(ds.img_prefix, info["file_name"]))
        frames.append(dict(img=img, gt_bboxes=smp["ann"]["bboxes"][:1],
                           img_shape=img.shape[:2]))
    z, x = pipeline(frames, rng, np_rng)
    b = x["gt_bboxes"][0].astype(np.float32)
    c = np.float32(pipeline.search_size // 2)
    gt = np.array([(b[0] + b[2]) / 2 - c, (b[1] + b[3]) / 2 - c,
                   b[2] - b[0], b[3] - b[1]], np.float32)
    return (z["img"].astype(np.float32), x["img"].astype(np.float32), gt,
            bool(positive))


def sot_batches(ds: SOTTrainDataset, seed: int, device, start: int = 0,
                exemplar_size: int = EXEMPLAR_SIZE,
                search_size: int = SEARCH_SIZE) -> Iterator[SOTBatch]:
    """``SOTBatch``es of one pair (a leading batch axis of 1) for global
    steps ``start``, ``start + 1``, ... on ``device``."""
    pipeline = SOTPipeline(exemplar_size, search_size)
    perms = np.random.RandomState(seed)
    n, epoch, order, step = len(ds), -1, None, start
    while True:
        while epoch < step // n:
            order, epoch = perms.permutation(n), epoch + 1
        s = sample_seed(seed, step, 0)
        rng = random.Random(s)
        np_rng = np.random.RandomState(s % 2**32)
        fields = pair_sample(ds, int(order[step % n]), rng, np_rng, pipeline)
        yield SOTBatch(*(torch.as_tensor(np.asarray(f))[None].to(device)
                         for f in fields))
        step += 1
