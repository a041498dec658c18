"""The port's training CLI (``tools/train.py``) and model builder on the
ImageNet-VID families (SELSA, FGFA, DFF), on the CPU:

- ``--synthetic`` batches equal the JAX CLI's (``build_system``'s
  ``synth``: U(-2, 2) 3-channel frames, 4 gts of which 2 are valid) for
  each family's R50 config;
- the CLI takes a step of each R50 config with ``--tiny --device cpu``
  (a 32-channel neck), on ``--synthetic`` batches and on a tiny
  ImageNet-VID tree of PNG frames (``write_imagenet_vid_tree``: the
  pipeline's key frame and 2 references as a ``TrainBatch``): finite
  losses, the family's own leaves changed (FlowNetSimple's, the
  aggregator's, SELSA's attention), the stem and stage 1 unchanged;
- the eval hook streams FGFA and DFF: the CLI with ``evaluation.interval``
  1 and the tree's val split as ``data.val`` logs the test CLI's mAP50 of
  its checkpoint.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from test_torch_port_eval import ROOT
from test_torch_port_train_cli import _jax_cli
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch import config as tconfig
from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
    write_imagenet_vid_tree,
)
from lowlightenvironmentvideoobjectdetection_torch.models import (
    builder as tb,
)
from lowlightenvironmentvideoobjectdetection_torch.models.vid.selsa import (
    TrainBatch,
)
from lowlightenvironmentvideoobjectdetection_torch.tools import (
    test as test_cli,
    train as tcli,
)
from lowlightenvironmentvideoobjectdetection_tpu import config as jconfig

R50 = {
    "SELSA": "configs/vid/selsa/selsa_faster_rcnn_r50_dc5_1x_imagenetvid.py",
    "FGFA": "configs/vid/fgfa/fgfa_faster_rcnn_r50_dc5_1x_imagenetvid.py",
    "DFF": "configs/vid/dff/dff_faster_rcnn_r50_dc5_1x_imagenetvid.py",
}
# a leaf only the family has, which a step must change
OWN_LEAF = {"SELSA": "bbox_head.aggregator0.fc_embed.weight",
            "FGFA": "aggregator.embed_conv0.weight",
            "DFF": "motion.deconv2.weight"}
FROZEN = ("backbone.conv1.", "backbone.layer1_0.conv1.")
NARROW = ["model.neck_channels=32", "data.workers_per_gpu=0"]


_pinned_threads = thread_count(1)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Each test's checkpoints go when it ends: the whole run keeps every
    test's folder to its end, and the runs' folders fill the disk."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("vid_train_tree")
    train, val = write_imagenet_vid_tree(str(root), videos=1, frames=12,
                                         hw=(72, 96), seed=5)
    return dict(root=root, train=train, val=val,
                prefix=str(root / "Data" / "VID") + "/")


@pytest.mark.parametrize("family", sorted(R50))
def test_synthetic_batches_match_the_jax_cli(family):
    path = os.path.join(ROOT, R50[family])
    jcfg = jconfig.load_config(path)
    jcfg["model"]["neck_channels"] = 32
    *_, synth, _ = _jax_cli().build_system(jcfg, tiny=True)
    rs = np.random.RandomState(0)
    cfg = tconfig.load_config(path)
    system = tb.build_model(cfg["model"], tiny=True, device="cpu")
    got = tcli.synthetic_batches(system, "cpu", 0)
    for _ in range(2):
        want, batch = synth(rs), next(got)
        assert isinstance(batch, TrainBatch)
        for g, w in zip(batch, want):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("family", sorted(R50))
def test_cli_trains_each_family(tree, family, tmp_path):
    path = os.path.join(ROOT, R50[family])
    cfg = tconfig.load_config(path)
    cfg["model"]["neck_channels"] = 32
    before = _params(tb.build_model(cfg["model"], tiny=True,
                                    device="cpu").model)
    data = {"synthetic": ["--synthetic", "--cfg-options"],
            "tree": ["--cfg-options", f"data.train.ann_file={tree['train']}",
                     f"data.train.img_prefix={tree['prefix']}"]}
    for source, opts in data.items():
        out = tcli.main([path, "--tiny", "--device", "cpu", "--steps", "1",
                         "--work-dir", str(tmp_path / source)]
                        + opts + NARROW)
        assert out["state"].step == 1 and len(out["metrics"]) == 1
        m = out["metrics"][0]
        assert {"loss", "loss_rpn_cls", "loss_cls", "grad_norm"} <= set(m)
        assert all(np.isfinite(v) for v in m.values()), source
        after = _params(out["state"].model)
        own = OWN_LEAF[family]
        assert not torch.equal(after[own], before[own]), source
        frozen = [n for n in after if any(f in n for f in FROZEN)]
        assert frozen and all(torch.equal(after[n], before[n])
                              for n in frozen)
        assert os.path.exists(tmp_path / source / "step_1.pt")
        assert (out["timings"] is None) == (source == "synthetic")


@pytest.mark.parametrize("family", ["FGFA", "DFF"])
def test_the_eval_hook_streams_the_family(tree, family, tmp_path):
    val = dict(tconfig.load_config(os.path.join(ROOT, R50[family]))[
        "data"]["test"], ann_file=tree["val"], img_prefix=tree["prefix"])
    out = tcli.main(
        [os.path.join(ROOT, R50[family]), "--tiny", "--device", "cpu",
         "--steps", "1", "--synthetic", "--work-dir", str(tmp_path),
         "--cfg-options", "evaluation.interval=1", f"data.val={val!r}"]
        + NARROW)
    assert len(out["evals"]) == 1
    after = test_cli.main(
        [os.path.join(ROOT, R50[family]), "--tiny", "--device", "cpu",
         "--checkpoint", str(tmp_path / "step_1.pt"), "--cfg-options",
         f"data.test.ann_file={tree['val']}",
         f"data.test.img_prefix={tree['prefix']}"] + NARROW)
    assert out["evals"][0]["mAP50"] == after["metrics"]["mAP50"]
