"""The VOC route in the port against the JAX package on the CPU:

- ``XMLDataset`` and ``VOCDataset`` on a tree the test writes
  (``write_voc_tree``: JPEG copies of the committed fixtures, XML written
  here): the image infos, every image's annotations in training (with
  ``min_size``: small boxes ignored) and in test mode, ``difficult``
  boxes ignored, an unknown class skipped, the year from the prefix
  (2007, 2012, none), and ``evaluate`` (11-point AP for 2007, the area AP
  otherwise) on the same detections: the same mAP and per-class APs;
- ``MultiScaleFlipAug`` (2 scales x flip) after ``LoadImageFromFile``:
  the same prepared dicts, bit for bit (image, shapes, ``scale_factor``,
  ``flip``, ``scale``), in the same order;
- the test CLI's image route on ``faster_rcnn_r50_dc5_1x_voc.py`` with
  ``--tiny`` on the VOC tree: every image, 20 per-class lists, its mAP50
  the JAX ``eval_map``'s on the same detections and annotations (difficult
  boxes ignored); ``data.test`` as ``XMLDataset`` with the VOC classes
  gives the same result; the training CLI refuses a VOC ``data.train``
  (the JAX CLI trains image detectors on a ``CocoDataset`` only).
"""

import os

import numpy as np
import pytest
import torch
from test_torch_port_pipelines import assert_same
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.data import voc as tvoc
from lowlightenvironmentvideoobjectdetection_torch.data.pipelines import (
    Compose as TCompose,
)
from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
    write_voc_tree,
)
from lowlightenvironmentvideoobjectdetection_torch.tools import (
    test as tcli,
    train as trcli,
)
from lowlightenvironmentvideoobjectdetection_tpu.core.eval.mean_ap import (
    eval_map as jeval_map,
)
from lowlightenvironmentvideoobjectdetection_tpu.data import (  # noqa: F401
    coco_det as jcoco,  # registers the JAX MultiScaleFlipAug
    voc as jvoc,
)
from lowlightenvironmentvideoobjectdetection_tpu.data.pipelines import (
    Compose as JCompose,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC_CFG = f"{ROOT}/configs/det/faster_rcnn_r50_dc5_1x_voc.py"
# per image: (class, VOC box, difficult); "kite" is no VOC class; the
# 6-pixel boxes fall under min_size 8
OBJECTS = [
    [("dog", (11, 21, 300, 400), False), ("cat", (500, 40, 900, 700), True),
     ("kite", (30, 30, 90, 90), False), ("person", (5, 5, 11, 40), False)],
    [("car", (100, 100, 1500, 900), False),
     ("car", (1200, 600, 1206, 1000), False)],
    [("bus", (40, 50, 700, 800), True)],
    [("person", (1, 1, 1920, 1080), False), ("dog", (20, 30, 60, 90), False)],
]


_pinned_threads = thread_count(1)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    out = {}
    for year in (2007, 2012, None):
        root = tmp_path_factory.mktemp(f"voc{year}")
        ann, prefix = write_voc_tree(str(root), images=4, year=year or 2007,
                                     objects=OBJECTS)
        if year is None:  # a prefix that names no year
            os.rename(prefix, str(root / "VOCdata"))
            prefix = str(root / "VOCdata") + "/"
            ann = prefix + "ImageSets/Main/test.txt"
        out[year] = (ann, prefix)
    return out


def _both(cls, ann, prefix, **kw):
    return (getattr(jvoc, cls)(ann_file=ann, img_prefix=prefix, **kw),
            getattr(tvoc, cls)(ann_file=ann, img_prefix=prefix, **kw))


@pytest.mark.parametrize("year", [2007, 2012, None])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_voc_dataset_matches_jax(trees, year, mode):
    ann, prefix = trees[year]
    kw = dict(min_size=8, test_mode=mode == "test")
    jd, td = _both("VOCDataset", ann, prefix, **kw)
    assert td.year == jd.year == (year or 0)
    assert len(td) == len(jd) == 4
    assert td.data_infos == jd.data_infos
    assert td.data_infos[0]["width"] == 1920
    n_ignored = 0
    for i, info in enumerate(jd.data_infos):
        want = jd.get_ann_info(info)
        got = td[i]["ann"]
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        n_ignored += len(got["bboxes_ignore"])
    # difficult: 2; under min_size in training: 2 more
    assert n_ignored == (4 if mode == "train" else 2)


def test_xml_dataset_takes_its_classes(trees):
    ann, prefix = trees[2007]
    classes = ("dog", "car")
    jd, td = _both("XMLDataset", ann, prefix, classes=classes)
    for i, info in enumerate(jd.data_infos):
        want, got = jd.get_ann_info(info), td[i]["ann"]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert set(np.concatenate([td[i]["ann"]["labels"]
                               for i in range(4)]).tolist()) == {0, 1}
    with pytest.raises(ValueError, match="CLASSES"):
        tvoc.XMLDataset(ann_file=ann, img_prefix=prefix)


def _dets(ds, seed):
    """Per image, per class [N, 5]: each gt jittered, plus false
    positives, scores from a seed."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(len(ds)):
        a = ds[i]["ann"]
        boxes = np.concatenate([a["bboxes"], a["bboxes_ignore"]])
        labels = np.concatenate([a["labels"], a["labels_ignore"]])
        per = [np.zeros((0, 5), np.float32) for _ in ds.CLASSES]
        for b, c in zip(boxes, labels):
            rows = [np.r_[b + rs.randn(4) * 4, rs.rand()]]
            rows.append(np.r_[b + rs.randn(4) * 200, rs.rand()])
            per[c] = np.concatenate([per[c], np.float32(rows)])
        out.append(per)
    return out


@pytest.mark.parametrize("year", [2007, 2012])
def test_voc_evaluate_matches_jax(trees, year):
    ann, prefix = trees[year]
    jd, td = _both("VOCDataset", ann, prefix, test_mode=True)
    dets = _dets(td, 3)
    want = jd.evaluate(dets)
    got = td.evaluate(dets)
    np.testing.assert_allclose(got["mAP"], want["mAP"], rtol=1e-6)
    for g, w in zip(got["per_class"], want["per_class"]):
        assert g["num_gts"] == w["num_gts"]
        np.testing.assert_allclose(g["ap"], w["ap"], rtol=1e-6)
    assert 0 < got["mAP"] < 1


def test_11_point_and_area_metrics_differ(trees):
    a07, p07 = trees[2007]
    _, td = _both("VOCDataset", a07, p07, test_mode=True)
    dets = _dets(td, 3)
    m07 = td.evaluate(dets)["mAP"]
    td.year = 2012  # the area metric on the same data
    m12 = td.evaluate(dets)["mAP"]
    assert m07 != m12


def test_multi_scale_flip_aug_matches_jax(trees):
    ann, prefix = trees[2007]
    inner = [dict(type="Resize", img_scale=(1000, 600)),
             dict(type="Normalize"), dict(type="Pad", size_divisor=32)]
    pipeline = [dict(type="LoadImageFromFile"),
                dict(type="MultiScaleFlipAug", transforms=inner,
                     img_scale=[(640, 360), (320, 200)], flip=True)]
    jp = JCompose(pipeline)
    tp = TCompose(pipeline, device="cpu")
    jd, _ = _both("VOCDataset", ann, prefix, test_mode=True)
    for info in jd.data_infos[:2]:
        want = jp(dict(img_info=dict(info), img_prefix=prefix))
        got = tp(dict(img_info=dict(info), img_prefix=prefix))
        assert len(got) == len(want) == 4
        assert [(r["scale"], r["flip"]) for r in got] == [
            ((640, 360), False), ((640, 360), True), ((320, 200), False),
            ((320, 200), True)]
        assert_same(want, got)
        np.testing.assert_array_equal(got[1]["img"].numpy(),
                                      got[0]["img"].flip(1).numpy())


@pytest.mark.parametrize("dtype", ["VOCDataset", "XMLDataset"])
def test_test_cli_runs_the_voc_config(trees, dtype, tmp_path):
    torch.set_num_threads(1)
    ann, prefix = trees[2007]
    d = dict(type=dtype, ann_file=ann, img_prefix=prefix)
    if dtype == "XMLDataset":
        d["classes"] = list(tvoc.VOC_CLASSES)
    out = tcli.main([VOC_CFG, "--tiny", "--device", "cpu", "--cfg-options",
                     f"data.test={d!r}", "model.neck_channels=32"])
    assert out["summary"]["frames"] == 4
    assert out["summary"]["model"] == "FasterRCNN"
    assert all(len(r) == 20 for r in out["dets"])
    ds = tvoc.VOCDataset(ann_file=ann, img_prefix=prefix, test_mode=True)
    anns = [ds[i]["ann"] for i in range(4)]
    want, _ = jeval_map(out["dets"], anns, iou_thr=0.5)
    assert out["metrics"]["mAP50"] == pytest.approx(float(want), abs=1e-7)
    assert "mAP50" in out["summary"]


def test_train_cli_refuses_voc_training(trees, tmp_path):
    ann, prefix = trees[2007]
    with pytest.raises(ValueError, match="CocoDataset only"):
        trcli.main([VOC_CFG, "--tiny", "--device", "cpu", "--steps", "1",
                    "--work-dir", str(tmp_path), "--cfg-options",
                    f"data.train.ann_file={ann!r}",
                    f"data.train.img_prefix={prefix!r}",
                    "model.neck_channels=32", "data.workers_per_gpu=0"])
