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
The tracking (MOT, SOT) and image-detector routes of the JAX CLI raise
``NotImplementedError``: their models are not in the port.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np

from ..apis.inference import init_model
from ..apis.test import evaluate_bbox, multi_device_test
from ..config import Config, apply_cli_options
from ..data.loader import build_dataset, loader_workers
from ..data.pipelines import Compose
from ..models.builder import vid_model_kwargs
from ..utils.device import resolve_device

MOT_TYPES = ("DeepSORT", "Tracktor")
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


def check_route(cfg) -> None:
    """Raise for the JAX CLI's routes whose models the port lacks."""
    mtype = cfg["model"]["type"]
    dtype = ((cfg.get("data") or {}).get("test") or {}).get("type")
    if mtype in MOT_TYPES or dtype == "MOTChallengeDataset":
        raise NotImplementedError(
            f"{mtype}: multi-object tracking is not ported (ROADMAP.md "
            "Queue 1 item 7, MOT and SOT)")
    if mtype == "SiamRPN" or dtype == "LaSOTDataset":
        raise NotImplementedError(
            f"{mtype}: single-object tracking is not ported (ROADMAP.md "
            "Queue 1 item 7, MOT and SOT)")
    if mtype in VID_TYPES or dtype in VIDEO_DATASETS:
        return
    raise NotImplementedError(
        f"{mtype} on {dtype}: the image detectors are not ported (ROADMAP.md "
        "Queue 1 item 9, the mmdet zoo)")


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the CLI on ``argv``. Returns the ``summary``, the per-frame
    ``results``, the evaluation's unrounded ``metrics`` and the loader's
    ``timings`` a frame (None with ``--synthetic``)."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    apply_cli_options(cfg, args.cfg_options)
    check_route(cfg)
    device = resolve_device(args.device)
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
