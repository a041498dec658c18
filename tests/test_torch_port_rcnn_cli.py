"""The CLIs' image route in the port on the CPU for the seven configs of
the two-stage families on the DC5 trunk (``cascade_rcnn``,
``cascade_rpn``, ``dh_faster_rcnn``, ``pisa_faster_rcnn``, ``grid_rcnn``
``_r50_dc5_1x_coco.py``, ``dynamic_rcnn_r50_dc5_1x.py`` and
``tridentnet_r50_1x_coco.py``) with ``--tiny`` and a 32-channel neck, on
a seeded COCO tree of PNG images (``write_coco_tree``: 3 train and 2 val
images of 96 x 128), ``data`` passed with ``--cfg-options``: two training
steps (finite losses, each family's loss terms, Dynamic R-CNN's
``batch_iou`` / ``batch_beta`` logged), then the test CLI on the val split
from the step-2 checkpoint (every image, one list a class: 80, Cascade
RPN's proposals 1; finite rows; mAP50 in [0, 1]). Parity with the JAX
package is held in ``test_torch_port_rcnn_families*.py``."""

import os

import numpy as np
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
    write_coco_tree,
)
from lowlightenvironmentvideoobjectdetection_torch.tools import (
    test as tcli,
    train as trcli,
)
from torch_port_threads import thread_count

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = {
    "cascade_rcnn": ("cascade_rcnn_r50_dc5_1x_coco.py",
                     {"s0.loss_cls", "s2.loss_bbox"}, 80),
    "cascade_rpn": ("cascade_rpn_r50_dc5_1x_coco.py",
                    {"loss_s1_reg", "loss_s2_cls", "loss_s2_reg"}, 1),
    "double_head": ("dh_faster_rcnn_r50_dc5_1x_coco.py",
                    {"loss_cls", "loss_bbox", "acc"}, 80),
    "dynamic_rcnn": ("dynamic_rcnn_r50_dc5_1x.py",
                     {"loss_bbox", "batch_iou", "batch_beta"}, 80),
    "pisa": ("pisa_faster_rcnn_r50_dc5_1x_coco.py",
             {"loss_cls", "loss_carl"}, 80),
    "grid_rcnn": ("grid_rcnn_r50_dc5_1x_coco.py", {"loss_cls", "loss_grid"},
                  80),
    "trident": ("tridentnet_r50_1x_coco.py", {"loss"}, 80),
}
PIPELINE = [dict(type="LoadImageFromFile"),
            dict(type="LoadAnnotations", with_bbox=True),
            dict(type="Resize", img_scale=(128, 96)),
            dict(type="RandomFlip", flip_ratio=0.5),
            dict(type="Normalize"), dict(type="Pad", size_divisor=16)]


_pinned_threads = thread_count(1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_tree")
    train, val = write_coco_tree(str(root), images=3, val_images=2,
                                 hw=(96, 128), seed=4)
    return dict(train=train, val=val, prefix=str(root) + "/",
                work=tmp_path_factory.mktemp("work"), runs={})


def trained(tree, name):
    """The training CLI's 2 tiny steps of config ``name`` (once a
    module): (its output, the step-2 checkpoint)."""
    if name not in tree["runs"]:
        torch.set_num_threads(2)
        d = dict(type="CocoDataset", ann_file=tree["train"],
                 img_prefix=tree["prefix"], pipeline=PIPELINE)
        work = tree["work"] / name
        out = trcli.main([f"{ROOT}/configs/det/{CFGS[name][0]}", "--tiny",
                          "--device", "cpu", "--steps", "2", "--work-dir",
                          str(work), "--cfg-options", f"data.train={d!r}",
                          "data.workers_per_gpu=0",
                          "model.neck_channels=32"])
        tree["runs"][name] = (out, work / "step_2.pt")
    return tree["runs"][name]


@pytest.mark.parametrize("name", sorted(CFGS))
def test_train_cli(tree, name):
    out, ckpt = trained(tree, name)
    assert out["state"].step == 2 and ckpt.exists()
    for m in out["metrics"]:
        assert CFGS[name][1] <= set(m), set(m)
        assert all(np.isfinite(v) for v in m.values())


@pytest.mark.parametrize("name", sorted(CFGS))
def test_test_cli(tree, name):
    _, ckpt = trained(tree, name)
    t = dict(type="CocoDataset", ann_file=tree["val"],
             img_prefix=tree["prefix"])
    try:
        res = tcli.main([f"{ROOT}/configs/det/{CFGS[name][0]}", "--tiny",
                         "--device", "cpu", "--checkpoint", str(ckpt),
                         "--cfg-options", f"data.test={t!r}",
                         "model.neck_channels=32"])
    finally:
        ckpt.unlink()
    assert res["summary"]["frames"] == 2
    assert all(len(r) == CFGS[name][2] for r in res["dets"])
    assert all(np.isfinite(a).all() for r in res["dets"] for a in r)
    assert 0.0 <= res["metrics"]["mAP50"] <= 1.0
