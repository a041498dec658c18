"""The CLIs' image route in the port on the CPU for the eight configs of
the dense one-stage heads (``fcos``, ``nas_fcos``, ``atss``, ``gfl``,
``paa``, ``vfnet``, ``retinanet_free_anchor`` and ``pisa_retinanet``
``_r50_fpn_1x_coco.py``) with ``--tiny``, on a seeded COCO tree of PNG
images (``write_coco_tree``: 3 train and 2 val images of 96 x 128),
``data`` passed with ``--cfg-options``: two training steps (finite
losses, each family's loss terms, a checkpoint), then the test CLI on the
val split from the step-2 checkpoint (every image, 80 per-class lists,
mAP50). Parity with the JAX package is held in
``test_torch_port_dense_families*.py``."""

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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = {
    "fcos": ("fcos_r50_fpn_1x_coco.py", {"loss_cls", "loss_centerness"}),
    "nas_fcos": ("nas_fcos_r50_fpn_1x_coco.py", {"loss_bbox",
                                                  "loss_centerness"}),
    "atss": ("atss_r50_fpn_1x_coco.py", {"loss_bbox", "loss_centerness"}),
    "gfl": ("gfl_r50_fpn_1x_coco.py", {"loss_qfl", "loss_dfl", "loss_giou"}),
    "paa": ("paa_r50_fpn_1x_coco.py", {"loss_cls", "loss_iou"}),
    "vfnet": ("vfnet_r50_fpn_1x_coco.py", {"loss_cls", "loss_bbox_refine"}),
    "free_anchor": ("retinanet_free_anchor_r50_fpn_1x_coco.py",
                    {"positive_bag_loss", "negative_bag_loss"}),
    "pisa": ("pisa_retinanet_r50_fpn_1x_coco.py", {"loss_cls", "loss_carl"}),
}
PIPELINE = [dict(type="LoadImageFromFile"),
            dict(type="LoadAnnotations", with_bbox=True),
            dict(type="Resize", img_scale=(128, 96)),
            dict(type="RandomFlip", flip_ratio=0.5),
            dict(type="Normalize"), dict(type="Pad", size_divisor=32)]


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
                          "data.workers_per_gpu=0"])
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
                         "--cfg-options", f"data.test={t!r}"])
    finally:
        ckpt.unlink()
    assert res["summary"]["frames"] == 2
    assert all(len(r) == 80 for r in res["dets"])
    assert all(np.isfinite(a).all() for r in res["dets"] for a in r)
    assert 0.0 <= res["metrics"]["mAP50"] <= 1.0
