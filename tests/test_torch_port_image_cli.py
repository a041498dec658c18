"""The CLIs' image-detector routes in the port on the CPU, on a seeded
COCO tree of PNG images (``write_coco_tree``: 4 train and 3 val images of
96 x 128 with 1-4 boxes), ``data`` passed with ``--cfg-options`` (the
configs have none):

- the test CLI against the root JAX ``tools/test.py``'s
  ``run_image_detector`` with ``--tiny`` on the same weights (an orbax
  checkpoint of drawn JAX variables; their port ``state_dict``) for
  ``faster_rcnn_r50_fpn_1x_coco.py`` and ``retinanet_r50_fpn_1x_coco.py``:
  the same per-image per-class rows (boxes to 5e-3, scores to 1e-5, as
  sets), the same mAP50 and image count;
- the training CLI's first step on ``retinanet_r50_fpn_1x_coco.py``
  (``--tiny``, the JAX weights loaded with ``--resume-from`` a step-0
  checkpoint): its loss terms equal JAX ``build_system``'s loss on the
  same batch (1e-5 relative; RetinaNet's loss draws nothing);
- a step of the training CLI on each other route: the DC5 configs
  (Faster, Fast R-CNN, RPN) and FPN Faster R-CNN on the tree, SiamRPN++ on
  a LaSOT tree (``SOTTrainDataset`` pairs): finite losses, and the test
  CLI's image route on ``--synthetic 2``.
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
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
    write_coco_tree,
    write_lasot_tree,
)
from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (
    retina_head as TR,
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

CFGS = {"FasterRCNNFPN": f"{ROOT}/configs/det/faster_rcnn_r50_fpn_1x_coco.py",
        "RetinaNet": f"{ROOT}/configs/det/retinanet_r50_fpn_1x_coco.py"}
DC5_CFGS = [f"{ROOT}/configs/det/{c}_r50_dc5_1x_coco.py"
            for c in ("faster_rcnn", "fast_rcnn", "rpn")]
SOT_CFG = f"{ROOT}/configs/sot/siamese_rpn/siamese_rpn_r50_1x_lasot.py"
HW = (96, 128)
PIPELINE = [dict(type="LoadImageFromFile"),
            dict(type="LoadAnnotations", with_bbox=True),
            dict(type="Resize", img_scale=(128, 96)),
            dict(type="RandomFlip", flip_ratio=0.5),
            dict(type="Normalize"), dict(type="Pad", size_divisor=16)]
LOSS_RTOL = 1e-5


_pinned_threads = thread_count(1)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Each test's R50 checkpoints (100-300 MB each) go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("coco_tree")
    train, val = write_coco_tree(str(root), images=4, val_images=3, hw=HW,
                                 seed=3)
    return dict(root=root, train=train, val=val, prefix=str(root) + "/")


def _test_opts(tree):
    d = dict(type="CocoDataset", ann_file=tree["val"],
             img_prefix=tree["prefix"])
    return ["--cfg-options", f"data.test={d!r}"]


def _train_opts(tree):
    d = dict(type="CocoDataset", ann_file=tree["train"],
             img_prefix=tree["prefix"], pipeline=PIPELINE)
    return ["--cfg-options", f"data.train={d!r}", "data.workers_per_gpu=0"]


def _weights(name, seed):
    """Variables drawn in the JAX family's tiny shapes (80 classes)."""
    jm, _ = JF.get_family(name).build(dict(num_classes=80), True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3)))
    return jax.tree_util.tree_map(np.asarray, draw(
        shapes, np.random.RandomState(seed)))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_image_route_matches_the_jax_cli(tree, name, tmp_path):
    var = _weights(name, 4)
    jax_ckpt = jax_save_checkpoint(str(tmp_path / "jax"), var, step=0)
    ckpt = str(tmp_path / "port.pt")
    torch.save(from_jax_variables(var), ckpt)
    argv = [CFGS[name], "--tiny", "--out"]
    run_jax_cli(argv + [str(tmp_path / "jax.json"), "--checkpoint",
                        jax_ckpt] + _test_opts(tree))
    got = tcli.main(argv + [str(tmp_path / "port.json"), "--checkpoint",
                            ckpt, "--device", "cpu"] + _test_opts(tree))
    with open(tmp_path / "jax.json") as f:
        jout = json.load(f)
    with open(tmp_path / "port.json") as f:
        tout = json.load(f)
    assert jout["summary"]["frames"] == tout["summary"]["frames"] == 3
    assert tout["summary"]["model"] == name
    jd, td = results_of(jout), results_of(tout)
    assert sum(len(r) for d in td for r in d) > 0
    for g, w in zip(td, jd):
        same_per_class(g, w)
    assert tout["summary"]["mAP50"] == jout["summary"]["mAP50"]
    assert got["summary"] == tout["summary"]


def test_train_cli_first_step_matches_jax_build_system(tree, tmp_path):
    var = _weights("RetinaNet", 5)
    model = TR.RetinaNet(num_classes=80, dtype=torch.float32)
    model.load_state_dict(from_jax_variables(var), strict=True)
    start = str(tmp_path / "step_0.pt")
    torch.save({"model": model.state_dict(), "count": 0, "trace": {
        n: torch.zeros_like(p) for n, p in model.named_parameters()},
        "step": 0}, start)
    seen = []
    real = trcli.ImageSystem.loss_fn

    def spy(self, m, sample, generator):
        seen.append(sample)
        return real(self, m, sample, generator)

    trcli.ImageSystem.loss_fn = spy
    try:
        out = trcli.main([CFGS["RetinaNet"], "--tiny", "--device", "cpu",
                          "--steps", "1", "--work-dir", str(tmp_path),
                          "--resume-from", start] + _train_opts(tree))
    finally:
        trcli.ImageSystem.loss_fn = real
    sample = seen[0]
    assert sample.img.shape == (128, 128, 3)
    jcfg = jconfig.load_config(CFGS["RetinaNet"])
    jmodel, aux, loss_fn, _, _ = _jax_cli().build_system(jcfg, tiny=True)
    jb = JFR.DetTrainBatch(*(jnp.asarray(f.numpy()) for f in sample))
    _, want = loss_fn(var, jb, jax.random.PRNGKey(0))
    got = out["metrics"][0]
    for k in ("loss", "loss_cls", "loss_bbox"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=LOSS_RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("cfg", DC5_CFGS + [CFGS["FasterRCNNFPN"], SOT_CFG],
                         ids=["faster_dc5", "fast_dc5", "rpn_dc5", "fpn",
                              "siamrpn"])
def test_train_cli_steps_on_every_route(tree, cfg, tmp_path):
    if cfg == SOT_CFG:
        ann = write_lasot_tree(str(tmp_path / "lasot"), videos=2, frames=5,
                               hw=(64, 96), seed=1)
        d = dict(type="SOTTrainDataset", ann_file=ann,
                 img_prefix=str(tmp_path / "lasot") + "/")
        opts = ["--cfg-options", f"data.train={d!r}"]
    else:
        opts = _train_opts(tree) + ["model.neck_channels=32"] * (
            cfg in DC5_CFGS)
    out = trcli.main([cfg, "--tiny", "--device", "cpu", "--steps", "1",
                      "--work-dir", str(tmp_path)] + opts)
    assert out["state"].step == 1
    assert all(np.isfinite(v) for v in out["metrics"][0].values())
    if cfg == SOT_CFG:
        assert out["metrics"][0]["loss_rpn_cls"] > 0
    elif cfg != CFGS["FasterRCNNFPN"]:
        res = tcli.main([cfg, "--tiny", "--device", "cpu", "--synthetic",
                         "2", "--cfg-options", "model.neck_channels=32"])
        assert res["summary"]["frames"] == 2
