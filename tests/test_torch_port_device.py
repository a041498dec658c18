"""The port's entry points build on the card unless the caller asks for the
CPU, and raise where there is no card; so does a pipeline's device
stage (``Compose``). Each entry point turns TF32 off for float32 matmuls
and cuDNN convolutions (ROADMAP O2), from PyTorch's defaults."""

import pytest
import torch
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
    VIDModel,
    init_model,
)
from lowlightenvironmentvideoobjectdetection_torch.data.pipelines import (
    Compose,
)
from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
    selsa as TS,
)
from lowlightenvironmentvideoobjectdetection_torch.parallel.serve import (
    batched_video_state,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.device import (
    resolve_device,
)

TINY = dict(pad_h=64, pad_w=64, neck_channels=32, num_classes=3,
            num_ref_frames=2, test_nms_pre=64, test_nms_post=8,
            det_nms_pre=32, compute_dtype=torch.float32)


_pinned_threads = thread_count(1)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()


@pytest.mark.parametrize("build", [
    lambda: VIDModel(**TINY),
    lambda: init_model("SELSA", **TINY),
    lambda: batched_video_state(TS.SelsaConfig(**TINY), 2),
], ids=["VIDModel", "init_model", "batched_video_state"])
def test_entry_points_default_to_the_card(build):
    if torch.cuda.is_available():
        built = build()
        leaf = built.anchors if hasattr(built, "anchors") else built.ref_valid
        assert leaf.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_cpu_on_request():
    model = VIDModel(device="cpu", **TINY)
    assert model.device == torch.device("cpu")
    assert next(model.model.parameters()).device.type == "cpu"
    st = batched_video_state(TS.SelsaConfig(**TINY), 2, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    assert st.ref_kv[0][0].device.type == "cpu"
    assert st.ref_kv[0][0].shape == (2, 16, 2, 8, 64)


def test_compose_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    steps = [dict(type="Normalize")]
    assert Compose(steps, device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Compose(steps)


SELSA_CFG = "configs/vid/selsa/selsa_faster_rcnn_r50_dc5_1x_imagenetvid.py"


class Built(Exception):
    """Raised where a CLI builds its model: the flags are set before."""


def _entry(name, monkeypatch):
    from lowlightenvironmentvideoobjectdetection_torch.apis import (
        inference, train)
    from lowlightenvironmentvideoobjectdetection_torch.tools import (
        test as test_cli, train as train_cli)

    def built(*args, **kwargs):
        raise Built

    if name == "VIDModel":
        VIDModel(device="cpu", **TINY)
    elif name == "SOTModel":
        inference.SOTModel(device="cpu")
    elif name == "train_model":
        train.train_model(lambda *a: None, torch.nn.Linear(2, 2), iter(()), 0)
    else:
        cli = test_cli if name == "test_cli" else train_cli
        monkeypatch.setattr(cli, "init_model" if cli is test_cli
                            else "build_model", built)
        with pytest.raises(Built):
            cli.main([SELSA_CFG, "--tiny", "--device", "cpu"])


@pytest.mark.parametrize("name", ["VIDModel", "SOTModel", "train_model",
                                  "test_cli", "train_cli"])
def test_entry_points_turn_tf32_off(name, monkeypatch):
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    _entry(name, monkeypatch)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
