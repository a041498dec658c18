"""The port's test CLI (``tools/test.py``) on the CPU:

- on the canonical config with ``--tiny --device cpu`` pointed at a tree
  of PNG pairs, with a checkpoint: its ``--out`` results and ``mAP50``
  equal those of ``apis/test.py`` with the same checkpoint (exactly);
- against the root JAX ``tools/test.py`` on the same weights (an orbax
  checkpoint of the JAX variables, and their port ``state_dict`` through
  ``utils/jax_bridge.py``): the same per-frame per-class results (boxes to
  5e-3, scores to 1e-5, as sets) and mAP50 within 1e-6;
- ``--synthetic 3`` runs; ``--num-shards 2 --shard 1`` runs the second
  video;
- a dark-backbone config (``llvod_lstm_darkfarm.py``: ``SelsaDarkDetect``,
  the ConvLSTM DarkResNet) streams with its backbone, equal to
  ``apis/test.py`` with the same seeded model;
- the route of a config: the image detectors the port has take the
  image route (``test_torch_port_image_cli.py`` runs it), the JAX
  package's other image families raise ``NotImplementedError``, the
  tracking routes (MOT, SOT) are taken (``test_torch_port_track_cli.py``
  runs them);
- without ``--device cpu`` and with no card it raises ``RuntimeError``.

The gts are the port's own top detections (2 a frame).
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from test_torch_port_eval import (
    CANONICAL,
    ROOT,
    jax_kwargs,
    load_cfg,
    same_per_class,
    top_detection_gts,
)
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
    init_model,
)
from lowlightenvironmentvideoobjectdetection_torch.config import (
    Config,
    apply_cli_options,
)
from lowlightenvironmentvideoobjectdetection_torch.apis.test import (
    evaluate_bbox,
    single_device_test,
)
from lowlightenvironmentvideoobjectdetection_torch.core.eval.mean_ap import (
    eval_map,
)
from lowlightenvironmentvideoobjectdetection_torch.data.loader import (
    build_dataset,
)
from lowlightenvironmentvideoobjectdetection_torch.data.pipelines import (
    Compose,
)
from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
    write_darkfarm_tree,
)
from lowlightenvironmentvideoobjectdetection_torch.models.builder import (
    vid_model_kwargs,
)
from lowlightenvironmentvideoobjectdetection_torch.tools import test as tcli
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)
from lowlightenvironmentvideoobjectdetection_tpu.apis.inference import (
    VIDModel as JVIDModel,
)
from lowlightenvironmentvideoobjectdetection_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)

VIDEOS, FRAMES, HW = 2, 4, (80, 112)
NARROW = ["model.neck_channels=32", "data.workers_per_gpu=0"]


_pinned_threads = thread_count(1)


def options(ann, prefix):
    return ["--cfg-options", f"data.test.ann_file={ann}",
            f"data.test.img_prefix={prefix}"] + NARROW


def results_of(out):
    """--out's per-frame results as per-class float32 [N, 5] arrays."""
    return [[np.asarray(b, np.float32).reshape(-1, 5)
             for b in r["bbox_results"]] for r in out["results"]]


def run_jax_cli(argv):
    """The root ``tools/test.py``'s ``main`` in this process."""
    spec = importlib.util.spec_from_file_location(
        "jax_test_cli", os.path.join(ROOT, "tools", "test.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = ["test.py"] + argv
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            mod.main()
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("cli_tree")
    prefix = str(root) + "/"
    src = write_darkfarm_tree(str(root), videos=VIDEOS, frames=FRAMES,
                              hw=HW, seed=2)
    cfg = load_cfg(src, prefix)
    kw = vid_model_kwargs(cfg["model"], cfg["data"]["test"][
        "ref_img_sampler"], tiny=True)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        JVIDModel(model_type="SELSA", **jax_kwargs(cfg)).params)
    jax_ckpt = jax_save_checkpoint(str(root / "jax_ckpt"), params, step=0)
    ckpt = str(root / "port.pt")
    torch.save(from_jax_variables(params), ckpt)
    model = init_model(checkpoint=ckpt, device="cpu", **kw)
    d = cfg["data"]["test"]
    dets, _ = single_device_test(model, build_dataset(d, test_mode=True),
                                 Compose(d["pipeline"], device="cpu"))
    ann = top_detection_gts(src, str(root / "gts.json"), dets)
    return dict(root=root, prefix=prefix, ann=ann, ckpt=ckpt,
                jax_ckpt=jax_ckpt, kw=kw)


def test_cli_equals_the_api(world, capsys):
    out_path = str(world["root"] / "out.json")
    got = tcli.main([CANONICAL, "--tiny", "--device", "cpu", "--checkpoint",
                     world["ckpt"], "--out", out_path]
                    + options(world["ann"], world["prefix"]))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(out_path) as f:
        out = json.load(f)
    assert out["summary"] == printed == got["summary"]
    assert set(printed) == {"frames", "fps", "eval", "mAP50"}
    assert printed["frames"] == VIDEOS * FRAMES
    assert [r["frame_id"] for r in out["results"]] == list(
        range(FRAMES)) * VIDEOS
    cfg = load_cfg(world["ann"], world["prefix"])
    d = cfg["data"]["test"]
    model = init_model(checkpoint=world["ckpt"], device="cpu", **world["kw"])
    dets, anns = single_device_test(model, build_dataset(d, test_mode=True),
                                    Compose(d["pipeline"], device="cpu"))
    for g, w in zip(results_of(out), dets):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    want = evaluate_bbox(dets, anns)
    assert got["metrics"] == want
    assert printed["mAP50"] == round(want["mAP50"], 4)
    assert want["mAP50"] > 0.9
    assert len(got["timings"]) == VIDEOS * FRAMES


def test_cli_matches_the_jax_cli(world, tmp_path):
    argv = [CANONICAL, "--tiny", "--out"]
    opts = options(world["ann"], world["prefix"])
    run_jax_cli(argv + [str(tmp_path / "jax.json"), "--checkpoint",
                        world["jax_ckpt"]] + opts)
    tcli.main(argv + [str(tmp_path / "port.json"), "--checkpoint",
                      world["ckpt"], "--device", "cpu"] + opts)
    outs = {}
    for side in ("jax", "port"):
        with open(tmp_path / f"{side}.json") as f:
            outs[side] = json.load(f)
    assert outs["jax"]["summary"]["frames"] == VIDEOS * FRAMES
    jd, td = results_of(outs["jax"]), results_of(outs["port"])
    for g, w in zip(td, jd):
        same_per_class(g, w)
    cfg = load_cfg(world["ann"], world["prefix"])
    ds = build_dataset(cfg["data"]["test"], test_mode=True)
    anns = [ds.get_ann_info(info) for info in ds.data_infos]
    got, _ = eval_map(td, anns)
    want, _ = eval_map(jd, anns)
    assert abs(got - want) <= 1e-6
    assert abs(outs["port"]["summary"]["mAP50"]
               - outs["jax"]["summary"]["mAP50"]) <= 1e-4


def test_synthetic_and_one_shard(world):
    out = tcli.main([CANONICAL, "--tiny", "--device", "cpu", "--synthetic",
                     "3", "--cfg-options"] + NARROW)
    assert out["summary"]["frames"] == 3 and "mAP50" not in out["summary"]
    assert [r["frame_id"] for r in out["results"]] == [0, 1, 2]
    out = tcli.main([CANONICAL, "--tiny", "--device", "cpu", "--checkpoint",
                     world["ckpt"], "--num-shards", "2", "--shard", "1"]
                    + options(world["ann"], world["prefix"]))
    assert out["summary"]["frames"] == FRAMES
    assert 0.0 <= out["metrics"]["mAP50"] <= 1.0


LSTM = os.path.join(ROOT, "configs/vid/llvod/llvod_lstm_darkfarm.py")


def test_a_dark_variant_config_streams(world, monkeypatch):
    built = []

    def init(**kw):
        built.append(init_model(**kw))
        return built[-1]

    monkeypatch.setattr(tcli, "init_model", init)
    got = tcli.main([LSTM, "--tiny", "--device", "cpu"]
                    + options(world["ann"], world["prefix"]))
    model = built[0]
    assert model.cfg.backbone_variant == "DarkResNet"
    assert type(model.model.backbone.layer2_0).__name__ == (
        "ConvLSTMBottleneck")
    assert got["summary"]["frames"] == VIDEOS * FRAMES
    cfg = Config.fromfile(LSTM)
    apply_cli_options(cfg, options(world["ann"], world["prefix"])[1:])
    d = cfg["data"]["test"]
    again = init_model(device="cpu", **vid_model_kwargs(
        cfg["model"], d["ref_img_sampler"], tiny=True))
    dets, anns = single_device_test(again, build_dataset(d, test_mode=True),
                                    Compose(d["pipeline"], device="cpu"))
    for g, w in zip(results_of(got), dets):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert got["metrics"] == evaluate_bbox(dets, anns)


@pytest.mark.parametrize("opts,want", [
    (["model.type=DeepSORT"], "mot"),
    (["data.test.type=MOTChallengeDataset"], "mot"),
    (["model.type=SiamRPN"], "sot"),
    (["model.type=FasterRCNN", "data.test.type=CocoDataset"], "image"),
    (["model.type=SSD", "data.test.type=CocoDataset"], "item 9"),
], ids=["mot_model", "mot_data", "sot", "image", "zoo"])
def test_routes_the_port_lacks_raise(world, opts, want):
    """Only the image families the port lacks raise (naming ROADMAP
    item 9); the ported image detectors take the image route, the
    tracking configs the MOT or SOT route."""
    argv = opts + options(world["ann"], world["prefix"])[1:]
    if want in ("mot", "sot", "image"):
        cfg = Config.fromfile(CANONICAL)
        apply_cli_options(cfg, argv)
        assert tcli.check_route(cfg) == want
        return
    with pytest.raises(NotImplementedError, match=want):
        tcli.main([CANONICAL, "--tiny", "--device", "cpu", "--cfg-options"]
                  + argv)


def test_cli_needs_a_card_unless_asked_for_the_cpu(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([CANONICAL, "--tiny"]
                  + options(world["ann"], world["prefix"]))
