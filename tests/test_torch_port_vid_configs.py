"""Every ImageNet-VID config of the repository in the port, on the CPU:
``models/builder.py``'s ``model_config`` gives the JAX zoo's
``SelsaConfig`` of each config under ``configs/vid/selsa/``,
``configs/vid/fgfa/`` and ``configs/vid/dff/`` (R50 and R101; the TPU-only
keys such as the serving config's ``input_packed`` dropped, as the port
drops them), and ``vid_model_kwargs`` builds a ``VIDModel`` of the
config's own family (DFF with its ``key_frame_interval``) that streams two
frames at ``--tiny`` sizes (a 16-channel neck, a 2-frame memo). An image
detector (``FasterRCNN``) does not stream through ``VIDModel``:
``vid_model_kwargs`` raises ``NotImplementedError`` (the test CLI's image
route runs it).
"""

import glob
import os

import numpy as np
import pytest
from test_torch_port_eval import ROOT
from test_torch_port_train_cli import _jax_cfg, _same_config
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch import config as tconfig
from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
    VIDModel,
)
from lowlightenvironmentvideoobjectdetection_torch.models import (
    builder as tb,
)

VID_CFGS = sorted(glob.glob(os.path.join(ROOT, "configs/vid/selsa/*.py"))
                  + glob.glob(os.path.join(ROOT, "configs/vid/fgfa/*.py"))
                  + glob.glob(os.path.join(ROOT, "configs/vid/dff/*.py")))


_pinned_threads = thread_count(1)


@pytest.mark.parametrize("path", VID_CFGS,
                         ids=[os.path.relpath(p, ROOT) for p in VID_CFGS])
def test_every_imagenet_vid_config_builds_and_streams(path):
    cfg = tconfig.load_config(path)
    model_dict = {k: v for k, v in cfg["model"].items()
                  if k not in tb.TPU_ONLY_KEYS}
    _same_config(tb.model_config(cfg["model"]), _jax_cfg(model_dict))
    kw = tb.vid_model_kwargs(cfg["model"],
                             cfg["data"]["test"].get("ref_img_sampler"),
                             tiny=True)
    mtype = cfg["model"]["type"]
    assert kw["model_type"] == mtype
    assert kw["depth"] == cfg["model"].get("depth", 50)
    kw.update(neck_channels=16, num_ref_frames=2)
    model = VIDModel(device="cpu", **kw)
    want = {"SELSA": "SelsaDetector", "FGFA": "FGFA", "DFF": "DFF"}[mtype]
    assert type(model.model).__name__ == want
    if mtype == "DFF":
        assert model.model.key_frame_interval == 10
    frame = np.random.RandomState(0).randint(0, 255, (48, 64, 3))
    for fid in range(2):
        res = model.inference_vid(frame.astype(np.float32), fid)
        assert len(res["bbox_results"]) == 30


def test_the_image_detector_route_still_raises():
    with pytest.raises(NotImplementedError, match="image detectors"):
        tb.vid_model_kwargs(dict(type="FasterRCNN"))
    with pytest.raises(KeyError, match="FasterRCNN"):
        tb.model_config(dict(type="FasterRCNN"))
