"""The port's ``tools/mot_param_search.py`` against the root tool on the
CPU, on the saved detections that ``tests/test_mot_param_search.py``
builds (two tracks and a spurious low-score box a frame, 6 frames): over
several grids (score threshold, IoU threshold, tentative frames, shifted
odd frames, and with per-track ReID embeddings) the same table (every
combination's CLEAR-MOT metrics, equal) and the same best combination;
the port's ``parse_search`` types values as the root's.
"""

import itertools
import json

import numpy as np
import pytest
from test_mot_param_search import _dets, _mot_json, _search_mod
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.tools import (
    mot_param_search as tps,
)
from lowlightenvironmentvideoobjectdetection_tpu.data.mot_sot_datasets import (
    MOTChallengeDataset,
)

GRIDS = {
    "score": ["obj_score_thr=0.3,0.5"],
    "three_keys": ["obj_score_thr=0.3,0.5", "match_iou_thr=0.1,0.7",
                   "num_tentatives=1,3"],
}


_pinned_threads = thread_count(1)


def _frames(variant):
    frames = _dets()
    if variant in ("shifted", "embeds"):
        for fid, fr in enumerate(frames):
            if fid % 2:
                fr["det_bboxes"] = [[x1 + 22, y1, x2 + 22, y2]
                                    for x1, y1, x2, y2 in fr["det_bboxes"]]
    if variant == "embeds":  # one direction per track, noise a frame
        rs = np.random.RandomState(1)
        base = rs.randn(3, 8)
        for fr in frames:
            fr["embeds"] = (base + 0.05 * rs.randn(3, 8)).tolist()
    return frames


def _root_table(ann, frames, items, metrics):
    """The root tool's loop (``main`` without its argument parsing)."""
    m = _search_mod()
    ds = MOTChallengeDataset(ann_file=ann, test_mode=True)
    search = m.parse_search(items)
    table, best = [], None
    for combo in itertools.product(*search.values()):
        kw = dict(zip(search.keys(), combo))
        res = ds.evaluate(m.run_tracker(ds, frames, kw))
        table.append((kw, res))
        if best is None or res[metrics[0]] > best[0]:
            best = (res[metrics[0]], kw, res)
    return table, best


@pytest.mark.parametrize("variant", ["plain", "shifted", "embeds"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_search_table_and_best_match_the_root_tool(tmp_path, grid, variant):
    ann = _mot_json(tmp_path)
    frames = _frames(variant)
    dets = tmp_path / "dets.json"
    dets.write_text(json.dumps(frames))
    log = tmp_path / "search.log"
    metrics = ["MOTA", "IDF1"]
    got = tps.main(["--ann-file", ann, "--dets", str(dets), "--search"]
                   + GRIDS[grid] + ["--search-metrics"] + metrics
                   + ["--log", str(log)])
    want, best = _root_table(ann, frames, GRIDS[grid], metrics)
    assert [kw for kw, _ in got["table"]] == [kw for kw, _ in want]
    for (_, g), (_, w) in zip(got["table"], want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == pytest.approx(w[k], abs=0, rel=0), k
    assert got["best"][1] == best[1] and got["best"][0] == best[0]
    assert log.read_text().splitlines() == got["lines"]


def test_parse_search_types_as_the_root_tool():
    items = ["obj_score_thr=0.3,0.5", "num_tentatives=1,3", "mode=a,b"]
    want = _search_mod().parse_search(items)
    got = tps.parse_search(items)
    assert got == want
    assert [type(v) for vs in got.values() for v in vs] == \
        [type(v) for vs in want.values() for v in vs]
