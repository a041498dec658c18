"""The port's test CLI (``tools/test.py``) on the flow-based ImageNet-VID
configs, on the CPU, against the root JAX ``tools/test.py``:

- ``fgfa_faster_rcnn_r50_dc5_1x_imagenetvid.py`` and
  ``dff_faster_rcnn_r50_dc5_1x_imagenetvid.py`` (``key_frame_interval``
  10 over a 12-frame video, so both of DFF's branches run) with ``--tiny
  --device cpu``, a 32-channel neck and a memo of 4 frames on the val
  split of a tiny ImageNet-VID tree of PNG frames
  (``write_imagenet_vid_tree``): the per-frame per-class results equal
  the JAX CLI's on the same weights (an orbax checkpoint of the JAX
  variables, and their port ``state_dict`` through ``utils/jax_bridge.py`` with FlowNetSimple's transposed convs
  flipped) as sets (boxes to 5e-3, scores to 1e-5), mAP50 within 1e-6.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_dark_backbones import draw
from test_torch_port_eval import ROOT, same_per_class
from test_torch_port_test_cli import results_of, run_jax_cli
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch import config as tconfig
from lowlightenvironmentvideoobjectdetection_torch.core.eval.mean_ap import (
    eval_map,
)
from lowlightenvironmentvideoobjectdetection_torch.data.loader import (
    build_dataset,
)
from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
    write_imagenet_vid_tree,
)
from lowlightenvironmentvideoobjectdetection_torch.models import (
    builder as tb,
)
from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
    fgfa as TF,
)
from lowlightenvironmentvideoobjectdetection_torch.tools import test as tcli
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.vid import (
    fgfa as JF,
    selsa as JS,
)
from lowlightenvironmentvideoobjectdetection_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)

FAMILY_CFGS = {
    "FGFA": os.path.join(
        ROOT, "configs/vid/fgfa/fgfa_faster_rcnn_r50_dc5_1x_imagenetvid.py"),
    "DFF": os.path.join(
        ROOT, "configs/vid/dff/dff_faster_rcnn_r50_dc5_1x_imagenetvid.py"),
}
FRAMES, HW = 12, (72, 96)
MEMO = 4  # FGFA's memo (14 in the configs): 4 adaptive-stride references
TINY_JAX = dict(pad_h=64, pad_w=64, train_nms_pre=64, train_nms_post=32,
                test_nms_pre=64, test_nms_post=16, num_roi_samples=16,
                neck_channels=32, compute_dtype=jnp.float32)


_pinned_threads = thread_count(1)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Each case's checkpoints (the JAX and the port weights with
    FlowNetSimple, ~0.5 GB) go when it ends: the whole run keeps every
    test's folder to its end."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("vid_tree")
    _, val = write_imagenet_vid_tree(str(root), videos=1, frames=FRAMES,
                                     hw=HW, seed=3)
    return dict(root=root, val=val, prefix=str(root / "Data" / "VID") + "/")


def _weights(family, root):
    """Variables drawn in the JAX model's tiny shapes, saved under
    ``root`` as an orbax checkpoint and as the port's state dict; returns
    both paths."""
    make = JF.make_fgfa if family == "FGFA" else JF.make_dff
    jmodel, _ = make(JS.SelsaConfig(**TINY_JAX))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((3, 64, 64, 3)))
    var = jax.tree_util.tree_map(
        np.asarray, draw(shapes, np.random.RandomState(7)))
    jax_ckpt = jax_save_checkpoint(str(root / f"jax_{family}"), var, step=0)
    model = (TF.FGFA if family == "FGFA" else TF.DFF)(
        tb.model_config(dict(type=family), tiny=True))
    ckpt = str(root / f"port_{family}.pt")
    torch.save(from_jax_variables(var, model), ckpt)
    return jax_ckpt, ckpt


@pytest.mark.parametrize("family", ["FGFA", "DFF"])
def test_cli_matches_the_jax_cli(tree, family, tmp_path):
    jax_ckpt, ckpt = _weights(family, tmp_path)
    opts = ["--cfg-options", f"data.test.ann_file={tree['val']}",
            f"data.test.img_prefix={tree['prefix']}",
            "model.neck_channels=32", "data.workers_per_gpu=0",
            f"model.num_ref_frames={MEMO}",
            f"data.test.ref_img_sampler.num_ref_imgs={MEMO}"]
    argv = [FAMILY_CFGS[family], "--tiny", "--out"]
    run_jax_cli(argv + [str(tmp_path / "jax.json"), "--checkpoint",
                        jax_ckpt] + opts)
    got = tcli.main(argv + [str(tmp_path / "port.json"), "--checkpoint",
                            ckpt, "--device", "cpu"] + opts)
    with open(tmp_path / "jax.json") as f:
        jout = json.load(f)
    with open(tmp_path / "port.json") as f:
        tout = json.load(f)
    assert jout["summary"]["frames"] == tout["summary"]["frames"] == FRAMES
    jd, td = results_of(jout), results_of(tout)
    assert sum(len(r) for d in td for r in d) > 0
    for g, w in zip(td, jd):
        same_per_class(g, w)
    cfg = tconfig.Config.fromfile(FAMILY_CFGS[family])
    tconfig.apply_cli_options(cfg, opts[1:])
    ds = build_dataset(cfg["data"]["test"], test_mode=True)
    anns = [ds.get_ann_info(info) for info in ds.data_infos]
    assert abs(eval_map(td, anns)[0] - eval_map(jd, anns)[0]) <= 1e-6
    assert got["summary"]["mAP50"] == tout["summary"]["mAP50"]
