"""The port's training entry from a config file (``config.py``,
``data/loader.py``, ``models/builder.py``, ``tools/train.py``) against the
JAX package's, on the CPU:

- ``load_config`` of every file under ``configs/vid/llvod/`` gives the JAX
  ``load_config``'s dict, and ``apply_cli_options`` the same overrides;
- the loader's batches equal the JAX ``tools/train.py::dataset_iterator`` +
  ``make_batch`` batches exactly (tolerance 0) for the canonical config
  with ``--tiny`` on a tree of PNG pairs, the JAX side's global numpy and
  Python generators seeded as the port's per-step generators, and with 0
  and 2 worker processes alike;
- the CLI trains the canonical type (``SelsaNewDarkfarmDetect``) with
  ``--tiny --device cpu --steps 2`` (narrowed by ``--cfg-options`` to loss
  stage 2 and a 32-channel neck, to stay small) to finite losses with the
  ``_u`` / ``_d`` feature losses, writes ``step_2.pt`` and
  ``train_log.json``, and ``--resume-from`` continues at step 2 with the
  data of step 2;
- the model builder maps every darkfarm type to the JAX zoo's config,
  and ``SelsaDarkDetect`` raises (its DarkResNet is not ported).
"""

import dataclasses
import glob
import importlib.util
import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_torch import config as tconfig
from lowlightenvironmentvideoobjectdetection_torch.data import loader as tl
from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
    write_darkfarm_tree,
)
from lowlightenvironmentvideoobjectdetection_torch.models import (
    builder as tb,
)
from lowlightenvironmentvideoobjectdetection_torch.tools import (
    train as tcli,
)
from lowlightenvironmentvideoobjectdetection_tpu import config as jconfig
from lowlightenvironmentvideoobjectdetection_tpu import zoo  # noqa: F401
from lowlightenvironmentvideoobjectdetection_tpu.registry import MODELS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANONICAL = os.path.join(
    ROOT, "configs/vid/llvod/llvod_l1234_fusion_add_i1234_rdb_taf_darkfarm.py")
LLVOD = sorted(glob.glob(os.path.join(ROOT, "configs/vid/llvod/**/*.py"),
                         recursive=True))


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_train_cli", os.path.join(ROOT, "tools/train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", LLVOD,
                         ids=[os.path.relpath(p, ROOT) for p in LLVOD])
def test_load_config_matches_jax(path):
    assert tconfig.load_config(path) == jconfig.load_config(path)


def test_cli_options_and_config_class():
    opts = ["model.num_classes=3", "data.train.ann_file=x/y.json",
            "model.out_indices=(0, 3)", "new.key=True", "model.name='a'"]
    j = jconfig.apply_cli_options(jconfig.load_config(CANONICAL), opts)
    t = tconfig.apply_cli_options(tconfig.load_config(CANONICAL), opts)
    assert t == j
    cfg = tconfig.Config.fromfile(CANONICAL)
    assert cfg.model.type == "SelsaNewDarkfarmDetect"
    assert cfg.data.train.pipeline[0].type == "LoadMutiImagePairsFromFile"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("darkfarm"))
    ann = write_darkfarm_tree(root, videos=2, frames=5, hw=(72, 128), seed=1)
    return root + "/", ann


def _options(tree, workers=0):
    prefix, ann = tree
    return [f"data.train.ann_file={ann}", f"data.train.img_prefix={prefix}",
            f"data.workers_per_gpu={workers}"]


def test_loader_batches_match_jax_dataset_iterator(tree):
    seed, steps = 3, 7  # more steps than samples: a second epoch
    jcli = _jax_cli()
    jcfg = jconfig.Config.fromfile(CANONICAL)
    jconfig.apply_cli_options(jcfg, _options(tree))
    jmodel, _, _, _, make_batch = jcli.build_system(jcfg, tiny=True)
    np.random.seed(seed)
    it = jcli.dataset_iterator(jcfg, jmodel)
    want = []
    for step in range(steps):
        random.seed(tl.sample_seed(seed, step, 0))
        want.append(make_batch(next(it)))
    tcfg = tconfig.Config.fromfile(CANONICAL)
    tconfig.apply_cli_options(tcfg, _options(tree))
    for workers in (0, 2):
        loader = tl.TrainLoader(tcfg, 64, 64, 3, seed=seed, device="cpu",
                                workers=workers)
        try:
            got = [next(loader) for _ in range(steps)]
        finally:
            loader.close()
        assert [r["step"] for r in loader.timings] == list(range(steps))
        for g, w in zip(got, want):
            for name, a, b in zip(g._fields, g, w):
                a, b = a[0].numpy(), np.asarray(b)
                assert a.shape == b.shape, name
                np.testing.assert_array_equal(a, b.astype(a.dtype),
                                              err_msg=name)
    assert any(bool(b.gt_valid.any()) for b in got)


def test_loader_resumes_at_its_step(tree):
    cfg = tconfig.Config.fromfile(CANONICAL)
    tconfig.apply_cli_options(cfg, _options(tree))
    full = tl.TrainLoader(cfg, 64, 64, 3, seed=5, device="cpu", workers=0)
    late = tl.TrainLoader(cfg, 64, 64, 3, seed=5, start=4, device="cpu",
                          workers=0)
    want = [next(full) for _ in range(6)][4:]
    got = [next(late) for _ in range(2)]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)


NARROW = ["model.out_indices=(2, 3)", "model.neck_channels=32"]


def test_cli_trains_and_resumes(tree, tmp_path):
    work = str(tmp_path / "work")
    argv = [CANONICAL, "--tiny", "--device", "cpu", "--work-dir", work,
            "--seed", "1", "--cfg-options"] + _options(tree) + NARROW
    out = tcli.main(argv[:1] + ["--steps", "2"] + argv[1:])
    assert out["state"].step == 2 and out["log"]["steps"] == 2
    assert len(out["metrics"]) == 2
    for m in out["metrics"]:
        assert {"loss", "loss_l1_0_u", "loss_l1_0_d", "loss_cls",
                "loss_rpn_cls"} <= set(m)
        assert all(np.isfinite(v) for v in m.values())
    assert os.path.exists(os.path.join(work, "step_2.pt"))
    with open(os.path.join(work, "train_log.json")) as f:
        assert json.loads(f.readline())["steps"] == 2
    out = tcli.main(argv[:1] + ["--steps", "1", "--resume-from",
                                os.path.join(work, "step_2.pt")] + argv[1:])
    assert out["state"].step == 3
    assert out["state"].opt_state.count == 3
    assert [r["step"] for r in out["timings"]][0] == 2
    assert os.path.exists(os.path.join(work, "step_3.pt"))
    with open(os.path.join(work, "train_log.json")) as f:
        assert [json.loads(line)["steps"] for line in f] == [2, 3]


def test_cli_needs_a_card_unless_asked_for_the_cpu(tree, tmp_path,
                                                   monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([CANONICAL, "--tiny", "--steps", "1", "--work-dir",
                   str(tmp_path), "--cfg-options"] + _options(tree))


DARKFARM_TYPES = ["SelsaDarkfarmDetect", "SelsaNewDarkfarmDetect",
                  "SelsaNewDetect", "SelsaNewVIDDetect", "DarkDetect",
                  "SelsaNoiseDetect", "SelsaNoiseDarkfarmDetect",
                  "SelsaCleanDetect", "SelsaCleanDarkfarmDetect", "LLVOD"]


@pytest.mark.parametrize("mtype", DARKFARM_TYPES)
def test_builder_matches_the_jax_zoo(mtype):
    base = dict(tconfig.load_config(CANONICAL)["model"], type=mtype)
    if mtype == "DarkDetect":
        base.pop("loss_type")  # its factory fixes the loss
    kw = dict(base)
    kw.pop("type")
    jmodel, _ = MODELS.get(mtype)(**dict(kw, compute_dtype="float32"))
    jcfg = jmodel.cfg
    tcfg = tb.model_config(dict(base, compute_dtype="float32"))
    for f in ("loss_type", "with_cleaner", "in_channels", "with_aggregator",
              "agg_rdb", "agg_taf", "dual_branch"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    for f in dataclasses.fields(tcfg.selsa):
        want = getattr(jcfg.selsa, f.name)
        got = getattr(tcfg.selsa, f.name)
        if f.name in ("compute_dtype", "head_dtype"):
            assert (got is None) == (want is None) and (
                got is None or str(got)[6:] == jnp.dtype(want).name), f.name
        else:
            assert got == want, f.name
    assert (tb.CLEAN_TYPES.count(mtype) == 1) == mtype.startswith(
        "SelsaClean")


def test_tiny_and_selsa_dark_detect():
    cfg = tb.model_config(tconfig.load_config(CANONICAL)["model"], tiny=True)
    assert (cfg.selsa.pad_h, cfg.selsa.pad_w) == (64, 64)
    assert cfg.selsa.compute_dtype == torch.float32
    with pytest.raises(NotImplementedError, match="dark backbones"):
        tb.model_config(dict(type="SelsaDarkDetect"))
    with pytest.raises(KeyError, match="FGFA"):
        tb.model_config(dict(type="FGFA"))
