"""Evaluate a config of the repository with the port, the counterpart of the
root ``tools/test.py``'s video-detection route:

    python -m lowlightenvironmentvideoobjectdetection_torch.tools.test \\
        configs/vid/llvod/llvod_l1234_fusion_add_i1234_rdb_taf_darkfarm.py \\
        [--checkpoint FILE] [--eval bbox] [--synthetic N] [--tiny] \\
        [--out FILE] [--num-shards K] [--shard k] \\
        [--cfg-options key=value ...] [--device cuda|cpu]

Reads the config (``_base_`` files and ``--cfg-options`` applied), builds
the streaming ``VIDModel`` of its model (``models/builder.py``
``vid_model_kwargs``: SELSA, FGFA and DFF stream as themselves; a
darkfarm-family config streams its noisy branch through SELSA, on its dark
backbone if it has one) with the weights of ``--checkpoint`` (a port
``state_dict`` or a ``TrainState`` checkpoint of the training CLI) or
seeded ones, on the
card (``--device cpu`` for the CPU; without a card and without
``--device`` it raises), and streams the config's ``data.test`` through it
(``apis/test.py``; ``data.workers_per_gpu`` loader processes decode the
frames), in ``--num-shards`` whole-video shards (``--shard`` runs one).
``--eval bbox`` adds the mAP at IoU 0.5 (``mAP50``). ``--synthetic N``
streams N frames of uniform noise instead, with no data. Prints one JSON
line, ``{"frames", "fps", "eval"[, "mAP50"]}``; ``--out`` writes it with
the per-frame results (``summary`` and ``results``, as the JAX CLI).

The tracking routes, as the JAX CLI's ``run_mot_eval`` and
``run_sot_eval``:

- MOT (model type DeepSORT or Tracktor, or a ``MOTChallengeDataset``):
  ``models/builder.py`` ``build_mot_model`` with the config's ``tracker``
  dict, the weights of ``--checkpoint`` (the model's ``state_dict()``:
  ``detector.`` and ``reid.`` entries) or seeded ones; every frame of
  ``data.test`` (PNG or JPEG, read with ``data/image_io.py``) resized
  into the bucket, tracked with
  the ``detection_file``'s public boxes (scaled into the bucket) if the
  config has one, Tracktor with the raw frame for its camera motion
  compensation (ROADMAP fault F16: the JAX CLI gives none), the result
  mapped back to the original frame (F15). Prints ``{"frames", "fps",
  "model", "eval"[, "track"]}``: ``--eval track`` adds CLEAR-MOT;
  ``--out`` writes the MOT txt files into ``mot_results/`` beside it.
- SOT (SiamRPN, or a ``LaSOTDataset``): ``apis/inference.py``
  ``init_sot_model`` (``--checkpoint``: a ``SiamRPN`` state dict), each
  video tracked from its first ground-truth box; prints ``{"frames",
  "fps", "model", "eval", "sot"}`` with OPE success, precision and
  normalized precision.

The image-detector route, as the JAX CLI's ``run_image_detector`` (a
type of ``apis/families.py`` whose test data is no video dataset:
FasterRCNN, FastRCNN, RPN, FasterRCNNFPN and its GA-RPN, GRoIE and Libra
variants, RetinaNet, GARetinaNet, and the dense heads FCOS, NASFCOS, ATSS,
GFL, PAA, VFNet, FreeAnchor and PISA (RetinaNet); the JAX package's other
families raise
``NotImplementedError``): ``apis/inference.py`` ``init_detector``
(``--checkpoint``: the model's state dict or a training checkpoint), then
every image of ``data.test`` (any image dataset of ``DATASETS``:
``CocoDataset``, ``VOCDataset``, ``XMLDataset``; PNG or JPEG, read with
``data/image_io.py``) or ``--synthetic N`` noise images through
``inference_detector``; prints ``{"frames", "fps", "eval", "model"[,
"mAP50"]}`` (``eval_map`` at IoU 0.5 with its area AP, VOC's difficult
boxes ignored, with ``--eval bbox``, as the JAX CLI); ``--out`` writes it
with the per-image results. The COCO configs have no ``data`` section:
pass ``data.test=dict(type='CocoDataset', ann_file=..., img_prefix=...)``
with ``--cfg-options``; ``faster_rcnn_r50_dc5_1x_voc.py`` reads
``data/VOCdevkit/VOC2007`` unless given another ``data.test.ann_file`` /
``img_prefix``.

``--tiny`` gives the JAX CLI's sizes there too: a 64x64 bucket and a
float32 detector for MOT (the ReID net stays bfloat16), 64 / 128 crops
for SOT, the families' tiny sizes and float32 for the image detectors.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..apis.families import get_family
from ..apis.inference import (init_detector, init_model, inference_mot,
                              init_sot_model)
from ..apis.test import evaluate_bbox, multi_device_test
from ..config import Config, apply_cli_options
from ..data.image_io import imread
from ..data.loader import build_dataset, loader_workers
from ..data.mot_sot_datasets import LaSOTDataset, MOTChallengeDataset
from ..data.pipelines import Compose
from ..models.builder import (MOT_TYPES, SOT_TYPES, build_mot_model,
                              sot_model_kwargs, vid_model_kwargs)
from ..utils.device import full_f32_precision, resolve_device

VIDEO_DATASETS = ("ImagenetVIDDataset", "DarkFarmVIDDataset",
                  "CocoVideoDataset", "MOTChallengeDataset", "LaSOTDataset",
                  "SOTTrainDataset")
VID_TYPES = ("SELSA", "FGFA", "DFF")


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Test a video detector")
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--eval", nargs="*", default=["bbox"])
    p.add_argument("--synthetic", type=int, default=0,
                   help="evaluate on N synthetic frames instead of a dataset")
    p.add_argument("--tiny", action="store_true",
                   help="shrink shapes for smoke runs, float32")
    p.add_argument("--out", default=None, help="dump results json")
    p.add_argument("--num-shards", type=int, default=1,
                   help="whole-video shards (DistributedVideoSampler split)")
    p.add_argument("--shard", type=int, default=None,
                   help="run only this shard (default: all, in order)")
    p.add_argument("--cfg-options", nargs="*", default=None)
    p.add_argument("--device", default=None,
                   help="default: the card; 'cpu' runs on the CPU")
    return p.parse_args(argv)


def check_route(cfg) -> str:
    """The JAX CLI's route for a config: "mot", "sot", "image" (a family of
    ``apis/families.py`` on data that is no video dataset; the families
    the port lacks raise ``NotImplementedError``) or "vid"."""
    mtype = cfg["model"]["type"]
    dtype = ((cfg.get("data") or {}).get("test") or {}).get("type")
    if mtype in MOT_TYPES or dtype == "MOTChallengeDataset":
        return "mot"
    if mtype in SOT_TYPES or dtype == "LaSOTDataset":
        return "sot"
    if (mtype not in VID_TYPES and dtype not in VIDEO_DATASETS
            and get_family(mtype) is not None):
        return "image"
    return "vid"


def read_frame(info: dict, img_prefix: str) -> np.ndarray:
    """A dataset frame, PNG or JPEG, as BGR uint8 [H, W, 3]
    (``data/image_io.imread``: cv2's pixels)."""
    return imread(os.path.join(img_prefix or "", info.get("file_name")
                               or info.get("filename", "")))


def run_mot(args, cfg, device) -> dict:
    """Stream ``data.test`` through DeepSORT or Tracktor; CLEAR-MOT with
    ``--eval track``."""
    dcfg = cfg["data"]["test"]
    sd = None
    if args.checkpoint:
        sd = torch.load(args.checkpoint, map_location="cpu",
                        weights_only=True)
    model = build_mot_model(dict(cfg["model"]), cfg.get("tracker"),
                            tiny=args.tiny, device=device, state_dict=sd)
    ds = MOTChallengeDataset(
        ann_file=dcfg["ann_file"], img_prefix=dcfg.get("img_prefix", ""),
        test_mode=True, detection_file=dcfg.get("detection_file"))
    results = []
    t0 = time.perf_counter()
    for i, info in enumerate(ds.data_infos):
        public = None if ds.detections is None else ds.detections[i]
        results.append(inference_mot(model, read_frame(info, ds.img_prefix),
                                     info.get("frame_id", i),
                                     public_bboxes=public))
    dt = time.perf_counter() - t0
    summary = dict(frames=len(results),
                   fps=round(len(results) / dt, 2) if dt > 0 else 0.0,
                   model=cfg["model"]["type"], eval=args.eval)
    metrics = {}
    if "track" in args.eval:
        metrics = ds.evaluate(results)
        summary["track"] = {k: round(float(v), 4) for k, v in metrics.items()}
    if args.out:
        out_dir = os.path.dirname(args.out) or "."
        ds.format_results(results, os.path.join(out_dir, "mot_results"))
    print(json.dumps(summary))
    return dict(summary=summary, results=results, metrics=metrics,
                timings=None)


def run_sot(args, cfg, device) -> dict:
    """Track every video of ``data.test`` from its first box; OPE."""
    model = init_sot_model(checkpoint=args.checkpoint, device=device,
                           **sot_model_kwargs(cfg["model"], args.tiny))
    dcfg = cfg["data"]["test"]
    ds = LaSOTDataset(ann_file=dcfg["ann_file"],
                      img_prefix=dcfg.get("img_prefix", ""), test_mode=True)
    results = []
    nframes = 0
    t0 = time.perf_counter()
    for v in range(ds.num_videos):
        video = ds.get_video(v)
        gt = video["gt_bboxes"]
        boxes = []
        for t, info in enumerate(video["frames"]):
            img = read_frame(info, ds.img_prefix)
            if t == 0:
                init = gt[0] if not np.isnan(gt[0]).any() else \
                    np.asarray([0.0, 0.0, 16.0, 16.0], np.float32)
                r = model.inference_sot(img, init, 0)
            else:
                r = model.inference_sot(img, None, t)
            boxes.append(np.asarray(r["track_bboxes"][:4], np.float32))
            nframes += 1
        results.append(np.stack(boxes))
    dt = time.perf_counter() - t0
    summary = dict(frames=nframes,
                   fps=round(nframes / dt, 2) if dt > 0 else 0.0,
                   model="SiamRPN", eval=args.eval)
    metrics = ds.evaluate(results)
    summary["sot"] = {k: round(float(v), 4) for k, v in metrics.items()}
    print(json.dumps(summary))
    return dict(summary=summary, results=results, metrics=metrics,
                timings=None)


def run_image(args, cfg, device) -> dict:
    """Detect every image of ``data.test`` (or ``--synthetic`` noise) with
    the config's image detector; mAP50 with ``--eval bbox``."""
    mcfg = dict(cfg["model"])
    mtype = mcfg.pop("type")
    det = init_detector(mtype, checkpoint=args.checkpoint, tiny=args.tiny,
                        device=device, **mcfg)
    results, det_lists, anns = [], [], []
    t0 = time.perf_counter()
    if args.synthetic:
        rng = np.random.RandomState(0)
        for i in range(args.synthetic):
            img = rng.randint(0, 255, (det.pad_h, det.pad_w, 3)
                              ).astype(np.float32)
            r = det.inference_detector(img)
            results.append(dict(image=i, num_dets=int(sum(len(x)
                                                          for x in r))))
    else:
        ds = build_dataset(cfg["data"]["test"], test_mode=True)
        for i in range(len(ds)):
            s = ds[i]
            img = read_frame(s["img_info"], ds.img_prefix)
            r = det.inference_detector(img.astype(np.float32))
            det_lists.append(r)
            anns.append(s["ann"])
            results.append(dict(image=i, bbox_results=[b.tolist()
                                                       for b in r]))
    dt = time.perf_counter() - t0
    summary = dict(frames=len(results),
                   fps=round(len(results) / dt, 2) if dt > 0 else 0.0,
                   eval=args.eval, model=mtype)
    metrics = {}
    if "bbox" in args.eval and det_lists:
        metrics = evaluate_bbox(det_lists, anns)
        summary["mAP50"] = round(metrics["mAP50"], 4)
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(summary=summary, results=results), f)
    return dict(summary=summary, results=results, metrics=metrics,
                timings=None, dets=det_lists)


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the CLI on ``argv``. Returns the ``summary``, the per-frame
    ``results``, the evaluation's unrounded ``metrics`` and the loader's
    ``timings`` a frame (None with ``--synthetic``)."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    apply_cli_options(cfg, args.cfg_options)
    route = check_route(cfg)
    device = resolve_device(args.device)
    full_f32_precision()
    if route == "mot":
        return run_mot(args, cfg, device)
    if route == "sot":
        return run_sot(args, cfg, device)
    if route == "image":
        return run_image(args, cfg, device)
    dcfg = (cfg.get("data") or {}).get("test") or {}
    model = init_model(checkpoint=args.checkpoint, device=device,
                       **vid_model_kwargs(cfg["model"],
                                          dcfg.get("ref_img_sampler"),
                                          args.tiny))
    results, timings = [], None
    t0 = time.perf_counter()
    if args.synthetic:
        rng = np.random.RandomState(0)
        h, w = model.cfg.pad_h, model.cfg.pad_w
        for fid in range(args.synthetic):
            frame = rng.randint(0, 255, (h, w, 3)).astype(np.float32)
            r = model.inference_vid(frame, fid)
            results.append(dict(frame_id=fid, num_dets=int(
                sum(len(x) for x in r["bbox_results"]))))
    else:
        ds = build_dataset(dcfg, test_mode=True)
        pipe = Compose(dcfg["pipeline"], device=device)
        timings = []
        det_lists, annotations, indices = multi_device_test(
            model, ds, pipe, num_shards=args.num_shards, shard=args.shard,
            workers=loader_workers(cfg), timings=timings)
        for i, d in zip(indices, det_lists):
            fid = ds.data_infos[i].get("frame_id", i)
            results.append(dict(frame_id=fid,
                                bbox_results=[b.tolist() for b in d]))
    dt = time.perf_counter() - t0
    fps = len(results) / dt if dt > 0 else 0.0
    summary = dict(frames=len(results), fps=round(fps, 2), eval=args.eval)
    metrics = {}
    if "bbox" in args.eval and not args.synthetic and results:
        metrics = evaluate_bbox(det_lists, annotations)
        summary["mAP50"] = round(metrics["mAP50"], 4)
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(summary=summary, results=results), f)
    return dict(summary=summary, results=results, metrics=metrics,
                timings=timings)


if __name__ == "__main__":
    main()
