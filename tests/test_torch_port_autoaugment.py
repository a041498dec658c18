"""AutoAugment's transforms in the port (``data/pipelines/auto_augment.py``)
against the JAX package's, which call cv2 (5.0 here), bit for bit: images
and boxes equal, on numpy frames drawn from a seed, the JAX side drawing
from ``np.random.seed(s)`` and the port from ``RandomState(s)`` (the
generators left in the same state):

- ``warp_affine_u8`` against ``cv2.warpAffine`` (shears, rotations on odd
  sizes, translations, one channel and three; rows both shorter and longer
  than cv2's 16-pixel vector block), ``rotation_matrix`` against
  ``cv2.getRotationMatrix2D``;
- ``Shear`` (both directions), ``Rotate`` (odd sizes) and ``Translate``
  (boxes pushed off the image) at both signs, the colour transforms at
  several levels, ``EqualizeTransform`` on an image of one value;
- ``AutoAugment`` with the autoaugment config's policies over several
  seeds (every policy drawn), with the frame's boxes;
- ``InstaBoost`` raises, as in JAX;
- the config through the training CLI on the CPU: 2 steps on a seeded
  COCO tree, the config's pipeline with a smaller resize.
"""

import copy
import os

import cv2
import numpy as np
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_torch.config import load_config
from lowlightenvironmentvideoobjectdetection_torch.data.pipelines import (
    auto_augment as TA,
)
from lowlightenvironmentvideoobjectdetection_torch.data.pipelines.loading import (  # noqa: E501
    Compose,
)
from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
    write_coco_tree,
)
from lowlightenvironmentvideoobjectdetection_torch.registry import PIPELINES
from lowlightenvironmentvideoobjectdetection_torch.tools import (
    train as trcli,
)
from lowlightenvironmentvideoobjectdetection_tpu.data.pipelines import (
    auto_augment as JA,
)
from torch_port_threads import thread_count

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = f"{ROOT}/configs/det/retinanet_r50_fpn_autoaugment_1x_coco.py"
NAMES = ("Shear", "Rotate", "Translate", "ColorTransform",
         "EqualizeTransform", "BrightnessTransform", "ContrastTransform",
         "AutoAugment", "InstaBoost")


_pinned_threads = thread_count(1)


def frame(seed, h=61, w=83, const=None):
    rs = np.random.RandomState(seed)
    img = (np.full((h, w, 3), const, np.uint8) if const is not None
           else rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
    x1 = rs.uniform(0, w * 0.6, 4)
    y1 = rs.uniform(0, h * 0.6, 4)
    boxes = np.stack([x1, y1, x1 + rs.uniform(4, w * 0.4, 4),
                      y1 + rs.uniform(4, h * 0.4, 4)], 1).astype(np.float32)
    return dict(img=img, gt_bboxes=boxes, img_fields=["img"],
                bbox_fields=["gt_bboxes"])


def run_both(jstep, tstep, results, seed):
    """The JAX step on numpy's global generator and the port's on a
    RandomState, from the same seed; the generators' next draws equal."""
    np.random.seed(seed)
    want = jstep(copy.deepcopy(results))
    rs = np.random.RandomState(seed)
    got = tstep(copy.deepcopy(results), None, rs)
    assert rs.rand() == np.random.rand()
    return got, want


def same(got, want):
    assert got["img"].dtype == want["img"].dtype
    np.testing.assert_array_equal(got["img"], want["img"])
    np.testing.assert_array_equal(got["gt_bboxes"], want["gt_bboxes"])
    assert got["gt_bboxes"].dtype == want["gt_bboxes"].dtype


def test_the_pipelines_are_registered():
    for name in NAMES:
        assert name in PIPELINES
        assert PIPELINES.get(name).on_host
    with pytest.raises(ImportError, match="instaboostfast"):
        PIPELINES.get("InstaBoost")()
    with pytest.raises(ImportError, match="instaboostfast"):
        JA.InstaBoost()


@pytest.mark.parametrize("h,w,c", [(61, 83, 3), (33, 15, 3), (40, 131, 1),
                                   (17, 16, 3)])
@pytest.mark.parametrize("kind", ["shear_x", "shear_y", "rotate",
                                  "rotate_scaled", "translate"])
def test_warp_affine_matches_cv2(h, w, c, kind):
    rs = np.random.RandomState(h * w + c)
    img = rs.randint(0, 256, (h, w, c)).astype(np.uint8)
    if c == 1:
        img = img[..., 0]
    if kind == "shear_x":
        mat = np.float32([[1, -0.18, 0], [0, 1, 0]])
    elif kind == "shear_y":
        mat = np.float32([[1, 0, 0], [0.12, 1, 0]])
    elif kind == "translate":
        mat = np.float32([[1, 0, -23], [0, 1, 7]])
    else:
        scale = 1.3 if kind == "rotate_scaled" else 1.0
        angle = rs.uniform(-30, 30)
        mat = cv2.getRotationMatrix2D(((w - 1) * 0.5, (h - 1) * 0.5), angle,
                                      scale)
        np.testing.assert_array_equal(TA.rotation_matrix(
            ((w - 1) * 0.5, (h - 1) * 0.5), angle, scale), mat)
        mat = mat.astype(np.float32)
    fill = (128, 64, 200)[:c]
    want = cv2.warpAffine(img, mat, (w, h), borderValue=fill)
    np.testing.assert_array_equal(TA.warp_affine_u8(img, mat, fill), want)


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("name,kw,hw", [
    ("Shear", dict(level=4.0), (61, 83)),
    ("Shear", dict(level=7.0, direction="vertical"), (61, 83)),
    ("Rotate", dict(level=6.0), (61, 83)),
    ("Rotate", dict(level=3.0, scale=0.8), (47, 33)),
    ("Translate", dict(level=4.0), (61, 83)),
    ("Translate", dict(level=2.0, direction="vertical"), (61, 83)),
])
def test_geometric_transforms_match_jax(name, kw, hw, negative):
    kw = dict(kw, prob=1.0, random_negative_prob=1.0 if negative else 0.0)
    results = frame(hash((name, hw)) % 1000, *hw)
    got, want = run_both(getattr(JA, name)(**kw), getattr(TA, name)(**kw),
                         results, 3)
    same(got, want)
    assert not np.array_equal(got["img"], results["img"])


def test_translate_pushes_boxes_off_the_image():
    """100 px left on an 83 px wide frame: every box leaves the image and
    clips to a zero-width box at x = 0."""
    results = frame(4)
    kw = dict(level=4.0, prob=1.0, random_negative_prob=1.0)
    got, want = run_both(JA.Translate(**kw), TA.Translate(**kw), results, 5)
    same(got, want)
    assert (got["gt_bboxes"][:, [0, 2]] == 0).all()
    assert (got["img"] == 128).all()


@pytest.mark.parametrize("name", ["ColorTransform", "BrightnessTransform",
                                  "ContrastTransform", "EqualizeTransform"])
@pytest.mark.parametrize("level", [1.0, 4.0, 9.0])
def test_colour_transforms_match_jax(name, level):
    results = frame(int(level) + 10)
    kw = dict(prob=1.0) if name == "EqualizeTransform" else dict(
        level=level, prob=1.0)
    got, want = run_both(getattr(JA, name)(**kw), getattr(TA, name)(**kw),
                         results, 6)
    same(got, want)


@pytest.mark.parametrize("const", [0, 77, 255])
def test_equalize_one_value_matches_jax(const):
    results = frame(7, const=const)
    got, want = run_both(JA.EqualizeTransform(prob=1.0),
                         TA.EqualizeTransform(prob=1.0), results, 8)
    same(got, want)
    assert (got["img"] == const).all()


def test_unapplied_transforms_draw_as_jax():
    """prob 0.5: some calls apply, some do not, and the draws stay in
    step either way."""
    applied = 0
    for seed in range(8):
        results = frame(seed)
        got, want = run_both(JA.Rotate(level=5.0), TA.Rotate(level=5.0),
                             results, seed)
        same(got, want)
        applied += not np.array_equal(got["img"], results["img"])
    assert 0 < applied < 8


def policies():
    cfg = load_config(CFG)
    aa = [t for t in cfg["data"]["train"]["pipeline"]
          if t["type"] == "AutoAugment"]
    assert len(aa) == 1
    return aa[0]["policies"]


def test_auto_augment_config_policies_match_jax():
    pol = policies()
    jstep, tstep = JA.AutoAugment(pol), TA.AutoAugment(pol)
    drawn = set()
    for seed in range(12):
        results = frame(seed + 20, 61, 83)
        got, want = run_both(jstep, tstep, results, seed)
        same(got, want)
        drawn.add(np.random.RandomState(seed).randint(len(pol)))
    assert drawn == set(range(len(pol)))


def test_auto_augment_in_the_host_pipeline():
    """The config's pipeline splits with AutoAugment among the host steps;
    the host stage draws from the sample's ``random.Random``."""
    import random
    cfg = load_config(CFG)
    pipe = Compose(cfg["data"]["train"]["pipeline"], device="cpu")
    assert [type(t).__name__ for t in pipe.host_steps] == [
        "LoadImageFromFile", "SeqLoadAnnotations", "AutoAugment"]
    step = pipe.host_steps[-1]
    a = step(frame(30), random.Random(4))
    b = step(frame(30), random.Random(4))
    same(a, b)


def test_train_cli_on_the_autoaugment_config(tmp_path):
    torch.set_num_threads(2)
    train, _ = write_coco_tree(str(tmp_path), images=3, val_images=1,
                               hw=(96, 128), seed=5)
    cfg = load_config(CFG)
    pipeline = [dict(t) if t["type"] != "Resize"
                else dict(t, img_scale=(128, 96))
                for t in cfg["data"]["train"]["pipeline"]]
    assert any(t["type"] == "AutoAugment" for t in pipeline)
    d = dict(type="CocoDataset", ann_file=train,
             img_prefix=str(tmp_path) + "/", pipeline=pipeline)
    out = trcli.main([CFG, "--tiny", "--device", "cpu", "--steps", "2",
                      "--work-dir", str(tmp_path / "work"), "--cfg-options",
                      f"data.train={d!r}", "data.workers_per_gpu=0"])
    assert out["state"].step == 2
    for m in out["metrics"]:
        assert {"loss_cls", "loss_bbox"} <= set(m)
        assert all(np.isfinite(v) for v in m.values())
