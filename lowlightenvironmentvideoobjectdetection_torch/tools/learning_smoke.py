"""The learning check: train Faster R-CNN from scratch on synthetic shapes
and show that mAP50 rises, the counterpart of the root
``tools/learning_smoke.py``.

The data are the JAX tool's sample for sample (``make_sample``, a copy of
its function: bright rectangles of two classes, wide and tall, on noisy
96x96 images; ``np.random.RandomState(0)`` for training, ``12345`` for the
evaluation images). So are the configuration (``learning_config``: anchor
scales 1-3, nothing frozen, float32, NMS 256 / 64, 64 RoI samples), the
optimizer (``parallel/train.py::Adam``: optax's clip by global norm 10 and
adam at ``--lr``), the evaluation (detections above score 0.01 against the
gts, ``eval_map`` at IoU 0.5) and the one JSON line it prints. The weights
are the port's seeded flax-style initialisation; the samplers draw from a
``torch.Generator`` seeded from ``--seed``. Unlike the JAX tool, the
FrozenBN statistics are buffers and take no update (ROADMAP fault F17).
Training from scratch at this rate is chaotic: some runs collapse and end
near their starting mAP50, in the JAX tool too (PERF.md, "The learning
floor").

    python -m lowlightenvironmentvideoobjectdetection_torch.tools.learning_smoke \
        [--steps 1000] [--device cpu]

It runs on the card unless ``--device cpu``, with TF32 off.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from ..core.eval.mean_ap import eval_map
from ..models.detectors.faster_rcnn import (DetTrainBatch,
                                            faster_rcnn_detect,
                                            faster_rcnn_loss,
                                            make_faster_rcnn)
from ..models.vid.selsa import SelsaConfig
from ..parallel.train import Adam
from ..utils.device import full_f32_precision, resolve_device

SIZE = 96
TRAIN_SEED, EVAL_SEED = 0, 12345
NUM_CLASSES = 2


def make_sample(rng, size=SIZE, max_gts=4):
    """The JAX tool's sample: (img [size, size, 3] f32, boxes [max_gts, 4],
    labels [max_gts] int32, valid [max_gts])."""
    img = rng.uniform(-0.4, 0.4, (size, size, 3)).astype(np.float32)
    n = rng.randint(1, max_gts)
    boxes = np.zeros((max_gts, 4), np.float32)
    labels = np.zeros((max_gts,), np.int32)
    valid = np.zeros((max_gts,), bool)
    for i in range(n):
        cls = rng.randint(0, 2)
        if cls == 0:  # wide
            w, h = rng.randint(28, 40), rng.randint(12, 18)
        else:  # tall
            w, h = rng.randint(12, 18), rng.randint(28, 40)
        x1 = rng.randint(0, size - w)
        y1 = rng.randint(0, size - h)
        color = rng.uniform(1.5, 2.5, (3,)).astype(np.float32)
        img[y1:y1 + h, x1:x1 + w] += color
        boxes[i] = [x1, y1, x1 + w, y1 + h]
        labels[i] = cls
        valid[i] = True
    return img, boxes, labels, valid


def learning_config() -> SelsaConfig:
    """The JAX tool's ``SelsaConfig``: anchors sized to the 12-40 px boxes,
    from-scratch training (nothing frozen), float32."""
    return SelsaConfig(
        pad_h=SIZE, pad_w=SIZE, num_classes=NUM_CLASSES,
        compute_dtype=torch.float32, train_nms_pre=256, train_nms_post=64,
        test_nms_pre=256, test_nms_post=64, num_roi_samples=64,
        anchor_scales=(1, 2, 3), frozen_stages=-1)


def make_optimizer(model: torch.nn.Module, lr: float) -> Adam:
    """Adam over every parameter (nothing is frozen here)."""
    return Adam({n: True for n, _ in model.named_parameters()},
                lambda count: lr)


def to_batch(sample, device) -> DetTrainBatch:
    img, boxes, labels, valid = sample
    return DetTrainBatch(
        torch.from_numpy(img).to(device),
        torch.tensor([float(SIZE), float(SIZE)], device=device),
        torch.from_numpy(boxes).to(device),
        torch.from_numpy(labels).long().to(device),
        torch.from_numpy(valid).to(device))


def train_step(model, anchors, opt: Adam, state, sample, generator=None,
               uniforms=None):
    """One update on one sample; the samplers take ``uniforms`` or draw
    from ``generator``. Returns (state, the loss as a detached tensor)."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    loss, _ = faster_rcnn_loss(model, to_batch(sample, anchors.device),
                               anchors, generator=generator,
                               uniforms=uniforms)
    loss.backward()
    state, _ = opt.step(params, state)
    return state, loss.detach()


def evaluate(model, anchors, n_images: int) -> float:
    """mAP50 over ``n_images`` images of ``RandomState(EVAL_SEED)``."""
    device = anchors.device
    img_shape = torch.tensor([float(SIZE), float(SIZE)], device=device)
    erng = np.random.RandomState(EVAL_SEED)
    dets, annos = [], []
    for _ in range(n_images):
        img, boxes, labels, valid = make_sample(erng)
        d = faster_rcnn_detect(model, torch.from_numpy(img).to(device),
                               img_shape, anchors)
        d_boxes, d_scores = d.boxes.cpu().numpy(), d.scores.cpu().numpy()
        d_labels = d.labels.cpu().numpy()
        keep = d.valid.cpu().numpy() & (d_scores > 0.01)
        per_class = []
        for c in range(NUM_CLASSES):
            m = keep & (d_labels == c)
            per_class.append(np.concatenate(
                [d_boxes[m], d_scores[m, None]], axis=1))
        dets.append(per_class)
        annos.append(dict(bboxes=boxes[valid], labels=labels[valid]))
    return float(eval_map(dets, annos, iou_thr=0.5)[0])


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--eval-images", type=int, default=16)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the initialisation and the samplers")
    p.add_argument("--device", default=None,
                   help="cpu, or none for the card")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the check on ``argv``; prints and returns the JSON line's dict."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    full_f32_precision()
    model, anchors = make_faster_rcnn(
        learning_config(), torch.Generator().manual_seed(args.seed), device)
    map_before = evaluate(model, anchors, args.eval_images)
    opt = make_optimizer(model, args.lr)
    state = opt.init(dict(model.named_parameters()))
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    rng = np.random.RandomState(TRAIN_SEED)
    for i in range(args.steps):
        state, loss = train_step(model, anchors, opt, state,
                                 make_sample(rng), generator=gen)
        if (i + 1) % 100 == 0:
            print(f"step {i + 1}: loss={float(loss):.4f}", file=sys.stderr)
    out = dict(metric="learning_smoke_mAP50", map_before=round(map_before, 4),
               map_after=round(evaluate(model, anchors, args.eval_images), 4),
               steps=args.steps)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
