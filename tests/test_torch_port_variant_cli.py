"""The CLIs' image route in the port on the CPU for the configs of the FPN
variants and GA-RetinaNet (``ga_faster_r50_fpn_1x_coco.py``,
``faster_rcnn_r50_fpn_groie_1x_coco.py``,
``libra_faster_rcnn_r50_fpn_1x_coco.py``, ``ga_retinanet_r50_fpn_1x_coco.py``)
with ``--tiny``, on a seeded COCO tree of PNG images (``write_coco_tree``:
3 train and 2 val images of 96 x 128), ``data`` passed with
``--cfg-options``: two training steps (finite losses, each family's loss
terms, the parameters moved) and the test CLI on the val split from the
step-2 checkpoint (every image, 80 per-class lists, mAP50). Parity with
the JAX package is held module by module in
``test_torch_port_{ga_rpn,groie,libra,ga_retinanet}.py``."""

import os
import shutil

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
    "ga_faster": ("configs/det/ga_faster_r50_fpn_1x_coco.py",
                  {"loss_anchor_shape", "loss_anchor_loc", "loss_rpn_cls"}),
    "groie": ("configs/det/faster_rcnn_r50_fpn_groie_1x_coco.py",
              {"loss_rpn_cls", "loss_cls"}),
    "libra": ("configs/det/libra_faster_rcnn_r50_fpn_1x_coco.py",
              {"loss_rpn_cls", "loss_bbox"}),
    "ga_retinanet": ("configs/det/ga_retinanet_r50_fpn_1x_coco.py",
                     {"loss_shape", "loss_loc", "loss_cls"}),
}
PIPELINE = [dict(type="LoadImageFromFile"),
            dict(type="LoadAnnotations", with_bbox=True),
            dict(type="Resize", img_scale=(128, 96)),
            dict(type="RandomFlip", flip_ratio=0.5),
            dict(type="Normalize"), dict(type="Pad", size_divisor=32)]


_pinned_threads = thread_count(1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_tree")
    train, val = write_coco_tree(str(root), images=3, val_images=2,
                                 hw=(96, 128), seed=4)
    return dict(train=train, val=val, prefix=str(root) + "/")


@pytest.mark.parametrize("name", sorted(CFGS))
def test_train_then_test_cli(tree, name, tmp_path):
    torch.set_num_threads(2)
    cfg, terms = CFGS[name]
    d = dict(type="CocoDataset", ann_file=tree["train"],
             img_prefix=tree["prefix"], pipeline=PIPELINE)
    try:
        out = trcli.main([f"{ROOT}/{cfg}", "--tiny", "--device", "cpu",
                          "--steps", "2", "--work-dir", str(tmp_path),
                          "--cfg-options", f"data.train={d!r}",
                          "data.workers_per_gpu=0"])
        assert out["state"].step == 2
        for m in out["metrics"]:
            assert terms <= set(m), set(m)
            assert all(np.isfinite(v) for v in m.values())
        t = dict(type="CocoDataset", ann_file=tree["val"],
                 img_prefix=tree["prefix"])
        res = tcli.main([f"{ROOT}/{cfg}", "--tiny", "--device", "cpu",
                         "--checkpoint", str(tmp_path / "step_2.pt"),
                         "--cfg-options", f"data.test={t!r}"])
        assert res["summary"]["frames"] == 2
        assert all(len(r) == 80 for r in res["dets"])
        assert 0.0 <= res["metrics"]["mAP50"] <= 1.0
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
