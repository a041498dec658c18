"""The CLIs' image route in the port on the CPU for the six mask configs
(``mask_rcnn``, ``ms_rcnn``, ``point_rend``, ``htc``, ``scnet``
``_r50_dc5_1x_coco.py`` and ``yolact_r50_1x8_coco.py``), ``--tiny`` (the
DC5 ones with a 32-channel neck), on a seeded COCO tree of PNG images
(``write_coco_tree``: 3 train and 2 val images of 96 x 128), ``data``
passed with ``--cfg-options``:

- the test CLI against the root JAX ``tools/test.py`` on the same weights
  (an orbax checkpoint of drawn JAX variables at 80 classes; their port
  ``state_dict``, the mask heads' transposed convs flipped) for one config
  of each route, ``mask_rcnn`` (the DC5 bucket) and ``yolact`` (the dense
  one): the same per-image per-class rows (boxes to 5e-3, scores to 1e-5,
  as sets), the same mAP50 and image count, every image, 80 lists of
  finite rows; the masks stay behind the API, as in JAX (the other four
  configs: ``test_torch_port_mask_cli_b.py``);
- a step of the training CLI on each config (the tree's gts as box-filled
  masks, as the JAX families make them): finite losses with the family's
  mask terms; on the step's batch of YOLACT (its loss draws nothing) and
  of Mask R-CNN (its samplers' uniforms replayed from the JAX key, as
  ``torch_port_rcnn_cases.uniforms`` does) the port family's loss terms
  equal to JAX ``build_system``'s on the same weights to 1e-5 relative.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_dark_backbones import draw
from test_torch_port_eval import ROOT, same_per_class
from test_torch_port_test_cli import results_of, run_jax_cli
from test_torch_port_train_cli import _jax_cli
from torch_port_rcnn_cases import uniforms
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.apis import (
    families as TF,
)
from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
    write_coco_tree,
)
from lowlightenvironmentvideoobjectdetection_torch.tools import (
    test as tcli,
    train as trcli,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)
from lowlightenvironmentvideoobjectdetection_tpu import config as jconfig
from lowlightenvironmentvideoobjectdetection_tpu.apis import (
    families as JF,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.detectors import (
    faster_rcnn as JFR,
)
from lowlightenvironmentvideoobjectdetection_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)

CFGS = {
    "MaskRCNN": ("mask_rcnn_r50_dc5_1x_coco.py", {"loss_mask"}),
    "MaskScoringRCNN": ("ms_rcnn_r50_dc5_1x_coco.py",
                        {"loss_mask", "loss_mask_iou"}),
    "PointRend": ("point_rend_r50_dc5_1x_coco.py",
                  {"loss_mask", "loss_point"}),
    "HTC": ("htc_r50_dc5_1x_coco.py",
            {"loss_semantic", "s0.loss_mask", "s2.loss_mask"}),
    "SCNet": ("scnet_r50_dc5_1x_coco.py",
              {"loss_semantic", "s0.loss_mask", "s2.loss_mask"}),
    "YOLACT": ("yolact_r50_1x8_coco.py", {"loss_mask", "loss_segm"}),
}
DENSE = ("YOLACT",)
JAX_CLI = ("MaskRCNN", "YOLACT")  # one config of each bucket's route
# the training CLI's step loss held against JAX's: its terms
TRAIN_JAX = {"MaskRCNN": ("loss", "loss_rpn_cls", "loss_rpn_bbox",
                          "loss_cls", "loss_bbox", "loss_mask"),
             "YOLACT": ("loss", "loss_cls", "loss_bbox", "loss_mask",
                        "loss_segm")}
PIPELINE = [dict(type="LoadImageFromFile"),
            dict(type="LoadAnnotations", with_bbox=True),
            dict(type="Resize", img_scale=(128, 96)),
            dict(type="RandomFlip", flip_ratio=0.5),
            dict(type="Normalize"), dict(type="Pad", size_divisor=16)]
LOSS_RTOL = 1e-5
NECK = ["model.neck_channels=32"]

_pinned_threads = thread_count(1)


def cfg_path(name):
    return f"{ROOT}/configs/det/{CFGS[name][0]}"


def model_opts(name):
    return [] if name in DENSE else NECK


def model_cfg(name):
    """The tiny model's options (80 classes; the DC5 families' 32-channel
    neck)."""
    return dict(num_classes=80, **({} if name in DENSE else
                                   dict(neck_channels=32)))


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Each test's R50 checkpoints go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_tree")
    train, val = write_coco_tree(str(root), images=3, val_images=2,
                                 hw=(96, 128), seed=4)
    return dict(train=train, val=val, prefix=str(root) + "/")


def _weights(name, seed):
    """Variables drawn in the JAX family's tiny shapes (``model_cfg``)."""
    jm, _ = JF.get_family(name).build(model_cfg(name), True)
    hw = 128 if name in DENSE else 64
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, hw, hw, 3)))
    return jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(seed)))


def _test_opts(tree, name):
    t = dict(type="CocoDataset", ann_file=tree["val"],
             img_prefix=tree["prefix"])
    return ["--cfg-options", f"data.test={t!r}"] + model_opts(name)


def same_as_the_jax_cli(tree, name, tmp_path):
    var = _weights(name, 4)
    jax_ckpt = jax_save_checkpoint(str(tmp_path / "jax"), var, step=0)
    model, _ = TF.get_family(name).build(model_cfg(name), True, 0, "cpu")
    ckpt = str(tmp_path / "port.pt")
    torch.save(from_jax_variables(var, model), ckpt)
    opts = _test_opts(tree, name)
    argv = [cfg_path(name), "--tiny", "--out"]
    run_jax_cli(argv + [str(tmp_path / "jax.json"), "--checkpoint",
                        jax_ckpt] + opts)
    got = tcli.main(argv + [str(tmp_path / "port.json"), "--checkpoint",
                            ckpt, "--device", "cpu"] + opts)
    with open(tmp_path / "jax.json") as f:
        jout = json.load(f)
    with open(tmp_path / "port.json") as f:
        tout = json.load(f)
    assert jout["summary"]["frames"] == tout["summary"]["frames"] == 2
    assert tout["summary"]["model"] == name
    jd, td = results_of(jout), results_of(tout)
    assert sum(len(r) for d in td for r in d) > 0
    assert all(len(d) == 80 for d in td)
    assert all(np.isfinite(a).all() and a.shape[1:] == (5,)
               for r in got["dets"] for a in r)
    for g, w in zip(td, jd):
        same_per_class(g, w)
    assert tout["summary"]["mAP50"] == jout["summary"]["mAP50"]
    assert 0.0 <= got["metrics"]["mAP50"] <= 1.0
    assert got["summary"] == tout["summary"]


@pytest.mark.parametrize("name", JAX_CLI)
def test_test_cli_matches_the_jax_cli(tree, name, tmp_path):
    same_as_the_jax_cli(tree, name, tmp_path)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_train_cli_step(tree, name, tmp_path):
    d = dict(type="CocoDataset", ann_file=tree["train"],
             img_prefix=tree["prefix"], pipeline=PIPELINE)
    seen = []
    real = trcli.ImageSystem.loss_fn

    def spy(self, m, sample, generator):
        seen.append(sample)
        return real(self, m, sample, generator)

    trcli.ImageSystem.loss_fn = spy
    try:
        out = trcli.main([cfg_path(name), "--tiny", "--device", "cpu",
                          "--steps", "1", "--work-dir", str(tmp_path),
                          "--cfg-options", f"data.train={d!r}",
                          "data.workers_per_gpu=0"] + model_opts(name))
    finally:
        trcli.ImageSystem.loss_fn = real
    assert out["state"].step == 1
    met = out["metrics"][0]
    assert CFGS[name][1] <= set(met), set(met)
    assert all(np.isfinite(v) for v in met.values())
    if name not in TRAIN_JAX:
        return
    # the JAX CLI's loss on the step's batch and the same drawn weights
    sample = seen[0]
    if name in DENSE:
        assert sample.img.shape == (128, 128, 3)
    jcfg = jconfig.load_config(cfg_path(name))
    jconfig.apply_cli_options(jcfg, model_opts(name))
    _, jaux, loss_fn, _, _ = _jax_cli().build_system(jcfg, tiny=True)
    var = _weights(name, 5)
    model, taux = TF.get_family(name).build(model_cfg(name), True, 0, "cpu")
    model.load_state_dict(from_jax_variables(var, model), strict=True)
    if taux is not None:
        np.testing.assert_array_equal(taux.numpy(), np.asarray(jaux))
    key = jax.random.PRNGKey(0)
    jb = JFR.DetTrainBatch(*(jnp.asarray(f.numpy()) for f in sample))
    _, want = jax.jit(lambda v: loss_fn(v, jb, key))(var)
    u = None if name in DENSE else uniforms(
        name, key, taux.shape[0], num_gts=sample.gt_boxes.shape[0])
    _, got = TF.get_family(name).loss(model, taux, sample, uniforms=u)
    for k in TRAIN_JAX[name]:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
