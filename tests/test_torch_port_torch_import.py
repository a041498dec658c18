"""The port's import of the original code's PyTorch checkpoints
(``utils/torch_import.py``) against the JAX package's
(``utils/torch_import.py``) followed by ``jax_bridge.from_jax_variables``:

- an mmtrack SELSA ``state_dict`` made from a seed in the original's key
  names (``detector.backbone.layer1.0.downsample.0.weight``,
  ``detector.neck.convs.0.conv.weight``,
  ``detector.roi_head.bbox_head.shared_fcs.0.weight``, the aggregators,
  ``num_batches_tracked``), with and without the ``detector.`` prefix and
  with and without the aggregators: equal tensors and keys, and the port
  model's own weights back exactly (the first shared FC's CHW columns
  land in the port's HWC order);
- a torchvision-style ResNet-50 ``state_dict`` (with ``fc.``): the same;
- ``torch.save`` of the import loads with ``weights_only=True`` into
  ``init_model``;
- SELSA frames streamed with the imported weights equal the JAX ones
  (``tests/test_torch_port_selsa.py``'s tolerances: detections as sets,
  box 5e-3 px, score 1e-5; the memo to 1e-4).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
    init_model,
)
from lowlightenvironmentvideoobjectdetection_torch.models.backbones.resnet import (  # noqa: E501
    ResNet,
)
from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
    selsa as TS,
)
from lowlightenvironmentvideoobjectdetection_torch.utils import (
    torch_import as TI,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.vid import (
    selsa as JS,
)
from lowlightenvironmentvideoobjectdetection_tpu.utils import (
    torch_import as JI,
)
from test_torch_port_selsa import SMALL, _same_dets, _same_state
from torch_port_threads import thread_count

IMG_SHAPE = (100.0, 120.0)


_pinned_threads = thread_count(1)


def original_name(name: str) -> str:
    """A port parameter's name -> the original's (the inverse of the
    import's renaming)."""
    name = re.sub(r"layer(\d)_(\d+)\.", r"layer\1.\2.", name)
    name = name.replace("downsample_conv.", "downsample.0.")
    name = name.replace("downsample_bn.", "downsample.1.")
    name = name.replace("neck.conv0.", "neck.convs.0.conv.")
    name = re.sub(r"bbox_head\.shared_fc(\d)\.",
                  r"roi_head.bbox_head.shared_fcs.\1.", name)
    name = re.sub(r"bbox_head\.aggregator(\d)\.",
                  r"roi_head.bbox_head.aggregator.\1.", name)
    return re.sub(r"^bbox_head\.(fc_cls|fc_reg)\.",
                  r"roi_head.bbox_head.\1.", name)


def seeded_state(model: torch.nn.Module, seed: int):
    """The model's seeded flax-style weights with non-trivial biases and BN
    statistics, as the port names them."""
    TS.init_params(model, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in model.state_dict().items():
        a = v.numpy().astype(np.float32)
        if k.endswith("running_var"):
            a = a * rng.uniform(0.8, 1.25, a.shape).astype(np.float32)
        elif k.endswith(("bias", "running_mean")):
            a = a + (rng.randn(*a.shape) * 0.02).astype(np.float32)
        out[k] = torch.from_numpy(a)
    return out


def to_original(state, prefix="", chw_fc="bbox_head.shared_fc0.weight"):
    """The port's state dict in the original's names and layout: the first
    shared FC's input columns back in (C, 7, 7) order, and a
    ``num_batches_tracked`` beside each BN."""
    out = {}
    for k, v in state.items():
        if k == chw_fc:
            c = v.shape[1] // 49
            v = v.reshape(v.shape[0], 7, 7, c).permute(0, 3, 1, 2).reshape(
                v.shape[0], -1)
        name = prefix + original_name(k)
        out[name] = v.clone()
        if k.endswith("running_var"):
            out[name.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(7)
    return out


def jax_import_bridged(variables):
    return from_jax_variables(jax.tree_util.tree_map(np.asarray, variables))


def same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)


@pytest.fixture(scope="module")
def selsa_state():
    model = TS.SelsaDetector(TS.SelsaConfig(compute_dtype=torch.float32,
                                            **SMALL))
    return seeded_state(model, 3)


@pytest.mark.parametrize("aggregators", [True, False])
@pytest.mark.parametrize("prefix", ["detector.", ""])
def test_selsa_import_equals_jax_import_and_bridge(selsa_state, prefix,
                                                   aggregators):
    state = {k: v for k, v in selsa_state.items()
             if aggregators or ".aggregator" not in k}
    sd = to_original(state, prefix)
    sd[prefix + "roi_head.bbox_head.fc_cls.extra"] = torch.zeros(1)
    if prefix:
        sd["cleaner.conv.weight"] = torch.zeros(1)  # not the detector's
    got = TI.import_selsa_checkpoint(sd)
    same(got, jax_import_bridged(JI.import_selsa_checkpoint(
        {k: v.numpy() for k, v in sd.items()})))
    same(got, state)


def test_resnet_import_equals_jax_import_and_bridge():
    state = seeded_state(ResNet(depth=50), 5)
    sd = to_original(state)
    sd["fc.weight"], sd["fc.bias"] = torch.ones(1000, 2048), torch.ones(1000)
    got = TI.import_resnet(sd)
    params, stats = JI.import_resnet({k: v.numpy() for k, v in sd.items()})
    same(got, jax_import_bridged({"params": params, "batch_stats": stats}))
    same(got, state)


def test_saved_import_loads_weights_only_into_init_model(selsa_state,
                                                         tmp_path):
    path = tmp_path / "selsa.pt"
    torch.save(TI.import_selsa_checkpoint(to_original(selsa_state,
                                                      "detector.")), path)
    model = init_model(checkpoint=str(path), device="cpu",
                       compute_dtype=torch.float32, **SMALL)
    for k, v in model.model.state_dict().items():
        torch.testing.assert_close(v, selsa_state[k], rtol=0, atol=0, msg=k)


def test_imported_selsa_streams_as_jax(selsa_state):
    sd = to_original(selsa_state, "detector.")
    jvars = JI.import_selsa_checkpoint({k: v.numpy() for k, v in sd.items()})
    jmodel = JS.SelsaDetector(cfg=JS.SelsaConfig(compute_dtype=jnp.float32,
                                                 **SMALL))
    tmodel = TS.SelsaDetector(TS.SelsaConfig(compute_dtype=torch.float32,
                                             **SMALL))
    tmodel.load_state_dict(TI.import_selsa_checkpoint(sd), strict=True)
    tmodel.eval()
    rng = np.random.RandomState(1)
    frames = np.zeros((5, 128, 128, 3), np.float32)
    frames[:, :100, :120] = rng.randn(5, 100, 120, 3)
    janchors, tanchors = JS.make_anchors(jmodel.cfg), TS.make_anchors(
        tmodel.cfg)
    jshape, tshape = jnp.asarray(IMG_SHAPE), torch.tensor(IMG_SHAPE)
    sf = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
    jstate = JS.init_video_state(jmodel, jvars, jnp.asarray(frames[:2]),
                                 jshape, janchors)
    tstate = TS.init_video_state(tmodel, torch.from_numpy(frames[:2]),
                                 tshape, tanchors)
    _same_state(tstate, jstate)
    for t in range(2, 5):
        jstate, jdets = JS.inference_step(
            jmodel, jvars, jstate, jnp.asarray(frames[t]), jshape,
            jnp.asarray(sf), janchors)
        tstate, tdets = TS.inference_step(
            tmodel, tstate, torch.from_numpy(frames[t]), tshape,
            torch.from_numpy(sf), tanchors)
        _same_dets(tdets, jdets)
        _same_state(tstate, jstate)
