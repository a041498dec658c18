"""Grid-search a MOT tracker's hyperparameters over saved detections, the
port's counterpart of the root ``tools/mot_param_search.py``:

    python -m lowlightenvironmentvideoobjectdetection_torch.tools.mot_param_search \\
        --ann-file ann.json --dets dets.json \\
        --search obj_score_thr=0.3,0.5 match_iou_thr=0.5,0.7 \\
        [--search-metrics MOTA IDF1] [--iou-thr 0.5] [--log FILE]

The detector and ReID half runs once, elsewhere: ``--dets`` is a json list
with one dict a frame of the ``MOTChallengeDataset`` at ``--ann-file``, in
dataset order, with ``det_bboxes`` [N, 4], ``det_scores``, ``det_labels``
and optionally ``embeds`` [N, D]. Each combination of the ``--search``
values (``key=v1,v2``, any ``SortTracker`` argument) gets a fresh
``SortTracker``, reset at each video's first frame, over every frame; the
tracks are scored with CLEAR-MOT (``MOTChallengeDataset.evaluate``). Prints
a line a combination and the best by the first search metric, and writes
the lines to ``--log``. Runs on the host: no card is needed.
"""

from __future__ import annotations

import argparse
import itertools
import json
from typing import Dict, List, Optional

import numpy as np

from ..data.mot_sot_datasets import MOTChallengeDataset
from ..models.mot.trackers import SortTracker


def parse_search(items) -> Dict[str, list]:
    """'key=v1,v2,...' -> {key: [values]}, each an int, else a float, else
    the string."""
    out = {}
    for item in items:
        k, _, vs = item.partition("=")
        vals = []
        for v in vs.split(","):
            try:
                vals.append(int(v))
            except ValueError:
                try:
                    vals.append(float(v))
                except ValueError:
                    vals.append(v)
        out[k] = vals
    return out


def run_tracker(dataset: MOTChallengeDataset, frames: List[dict],
                tracker_kw: dict) -> List[dict]:
    """A fresh ``SortTracker(**tracker_kw)`` over the saved ``frames``,
    reset at each video's frame 0; per frame ``track_bboxes`` [N, 6] =
    (id, x1, y1, x2, y2, score) of the kept tracks."""
    tracker = SortTracker(**tracker_kw)
    results = []
    for info, det in zip(dataset.data_infos, frames):
        frame_id = info.get("frame_id", 0)
        if frame_id == 0:
            tracker.reset()
        bboxes = np.asarray(det.get("det_bboxes", []),
                            np.float32).reshape(-1, 4)
        scores = np.asarray(det.get("det_scores", [0.0] * len(bboxes)),
                            np.float32).reshape(-1)
        labels = np.asarray(det.get("det_labels", [0] * len(bboxes)),
                            np.int64).reshape(-1)
        embeds = det.get("embeds")
        if embeds is not None:
            embeds = np.asarray(embeds, np.float32).reshape(len(bboxes), -1)
        ids, keep = tracker.track(frame_id, bboxes, scores, labels, embeds)
        keep = keep & (ids >= 0)
        tb = np.concatenate(
            [ids[keep, None].astype(np.float64), bboxes[keep],
             scores[keep, None].astype(np.float64)], axis=1)
        results.append(dict(track_bboxes=tb))
    return results


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Search tracker settings")
    p.add_argument("--ann-file", required=True)
    p.add_argument("--dets", required=True,
                   help="json: per-frame det_bboxes/det_scores/det_labels"
                        "(/embeds) from one detector+ReID pass")
    p.add_argument("--search", nargs="+", default=["obj_score_thr=0.3,0.5"],
                   help="key=v1,v2 pairs over SortTracker arguments")
    p.add_argument("--search-metrics", nargs="+", default=["MOTA", "IDF1"])
    p.add_argument("--iou-thr", type=float, default=0.5,
                   help="CLEAR-MOT matching IoU")
    p.add_argument("--log", default=None)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the search on ``argv``. Returns the ``table`` (one (settings,
    metrics) pair a combination, in order), the ``lines`` printed and the
    ``best`` (metric value, settings, metrics)."""
    args = parse_args(argv)
    ds = MOTChallengeDataset(ann_file=args.ann_file, test_mode=True)
    with open(args.dets) as f:
        frames = json.load(f)
    if len(frames) != len(ds.data_infos):
        raise ValueError(f"{len(frames)} saved frames vs "
                         f"{len(ds.data_infos)} dataset frames")
    search = parse_search(args.search)
    combos = list(itertools.product(*search.values()))
    print(f"Totally {len(combos)} cases over {sorted(search)}.")
    table, lines, best = [], [], None
    for combo in combos:
        kw = dict(zip(search.keys(), combo))
        m = ds.evaluate(run_tracker(ds, frames, kw), iou_thr=args.iou_thr)
        rec = " ".join(f"{k}={m[k]:.3f}" if isinstance(m[k], float)
                       else f"{k}={m[k]}" for k in args.search_metrics)
        line = f"{kw}: {rec}"
        print(line)
        table.append((kw, m))
        lines.append(line)
        key = m[args.search_metrics[0]]
        if best is None or key > best[0]:
            best = (key, kw, m)
    print(f"best {args.search_metrics[0]}={best[0]:.4f} @ {best[1]}")
    if args.log:
        with open(args.log, "w") as f:
            f.write("".join(x + "\n" for x in lines))
    return dict(table=table, lines=lines, best=best)


if __name__ == "__main__":
    main()
