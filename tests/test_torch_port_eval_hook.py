"""The periodic evaluation of training (``apis/train.py`` ``TrainLoop``'s
``eval_fn`` / ``eval_interval``, ``tools/train.py`` ``make_eval_fn``) on
the CPU:

- ``TrainLoop`` with ``eval_interval=2`` over 4 steps calls ``eval_fn``
  twice, on the states of steps 2 and 4, and logs ``eval: k=v``;
- the training CLI with ``evaluation.interval=2`` and a ``data.val``
  (the canonical config at ``--tiny``, narrowed to loss stages 2-3 and a
  32-channel neck) logs ``eval: mAP50=`` twice, and its losses and final
  parameters and momentum equal bit for bit those of the same run without
  the hook;
- the last evaluation equals the test CLI's ``mAP50`` on the saved final
  checkpoint, exactly, against gts made of the top detections of the run
  without the hook at its last step.
"""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch
from test_torch_port_eval import CANONICAL, top_detection_gts
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch import config as tconfig
from lowlightenvironmentvideoobjectdetection_torch.apis.train import (
    TrainLoop,
)
from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
    write_darkfarm_tree,
)
from lowlightenvironmentvideoobjectdetection_torch.parallel.train import (
    TrainState,
)
from lowlightenvironmentvideoobjectdetection_torch.tools import test as ttest
from lowlightenvironmentvideoobjectdetection_torch.tools import (
    train as ttrain,
)

STEPS = 4
NARROW = ["model.out_indices=(2, 3)", "model.neck_channels=32",
          "data.workers_per_gpu=0"]


_pinned_threads = thread_count(1)


class CountingTrainer:
    def step(self, state, batch, rngs):
        return TrainState(state.model, state.opt_state, state.step + 1), {
            "loss": 1.0}


def test_train_loop_evaluates_every_interval():
    seen, logs = [], []

    def eval_fn(state):
        seen.append(state.step)
        return {"mAP50": 0.25 * state.step}

    loop = TrainLoop(trainer=CountingTrainer(), log_interval=100,
                     eval_fn=eval_fn, eval_interval=2)
    batches = iter([(torch.zeros(1),)] * STEPS)
    state = loop.run(TrainState(None, None, 0), batches, STEPS, seed=0,
                     log_fn=logs.append)
    assert state.step == STEPS and seen == [2, 4]
    assert logs == ["eval: mAP50=0.5000", "eval: mAP50=1.0000"]


def cli_options(ann, prefix):
    return ["--cfg-options", f"data.test.ann_file={ann}",
            f"data.test.img_prefix={prefix}"] + NARROW


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The training CLI without the hook, then with it, same seed and data.
    The hook's val gts are the top detections (2 a frame) of the run
    without it at its last step."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("hook_tree")
    prefix = str(root) + "/"
    src = write_darkfarm_tree(str(root), videos=2, frames=4, hw=(64, 96),
                              seed=4)
    data = [f"data.train.ann_file={src}", f"data.train.img_prefix={prefix}"]
    out = dict(prefix=prefix)
    for name in ("plain", "hook"):
        extra = []
        if name == "hook":
            val = dict(tconfig.load_config(CANONICAL)["data"]["test"],
                       ann_file=out["ann"], img_prefix=prefix)
            extra = ["evaluation.interval=2", f"data.val={val!r}"]
        work, printed = str(root / name), io.StringIO()
        with contextlib.redirect_stdout(printed):
            out[name] = ttrain.main([CANONICAL, "--tiny", "--device", "cpu",
                                     "--steps", str(STEPS), "--seed", "1",
                                     "--work-dir", work, "--cfg-options"]
                                    + data + NARROW + extra)
        out[name].update(work=work, printed=printed.getvalue())
        if name == "plain":
            with contextlib.redirect_stdout(io.StringIO()):
                res = ttest.main([CANONICAL, "--tiny", "--device", "cpu",
                                  "--checkpoint", os.path.join(
                                      work, f"step_{STEPS}.pt")]
                                 + cli_options(src, prefix))
            dets = [[np.asarray(b, np.float32).reshape(-1, 5)
                     for b in r["bbox_results"]] for r in res["results"]]
            out["ann"] = top_detection_gts(src, str(root / "gts.json"),
                                           dets)
    yield out
    shutil.rmtree(root, ignore_errors=True)  # 1.2 GB of checkpoints


def test_the_hook_leaves_training_bit_identical(runs):
    plain, hook = runs["plain"], runs["hook"]
    assert plain["evals"] == [] and len(hook["evals"]) == 2
    assert plain["metrics"] == hook["metrics"]
    for m in hook["metrics"]:
        assert all(np.isfinite(v) for v in m.values())
    a = plain["state"].model.state_dict()
    b = hook["state"].model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert a[k].dtype == torch.float32 or not a[k].is_floating_point()
    ta, tb = plain["state"].opt_state.trace, hook["state"].opt_state.trace
    assert ta.keys() == tb.keys()
    assert all(torch.equal(ta[k], tb[k]) for k in ta)
    assert hook["state"].model.training == plain["state"].model.training


def test_the_hook_logs_and_equals_the_test_cli(runs):
    hook = runs["hook"]
    assert all(set(r) == {"mAP50"} and 0.0 <= r["mAP50"] <= 1.0
               for r in hook["evals"])
    lines = [x for x in hook["printed"].splitlines() if x.startswith("eval")]
    assert lines == [f"eval: mAP50={r['mAP50']:.4f}" for r in hook["evals"]]
    assert "eval" not in runs["plain"]["printed"]
    ckpt = os.path.join(hook["work"], f"step_{STEPS}.pt")
    out = ttest.main([CANONICAL, "--tiny", "--device", "cpu", "--checkpoint",
                      ckpt] + cli_options(runs["ann"], runs["prefix"]))
    # most of the briefly trained model's boxes are degenerate (no gt can
    # be), but some of its top ones hit the gts made of them
    assert out["metrics"]["mAP50"] == hook["evals"][-1]["mAP50"] > 0



def test_f10_the_hook_maps_a_fix_stride_val_sampler(runs, monkeypatch):
    """ROADMAP F10: the JAX hook (root ``tools/train.py:305-362``) builds
    its ``VIDModel`` without the val sampler, so a fix-stride split streams
    with the adaptive memo; the port's hook maps the sampler as the test
    CLI does."""
    built = {}

    class Recorder:
        def __init__(self, **kw):
            built.update(kw)

    monkeypatch.setattr(ttrain, "VIDModel", Recorder)
    sampler = dict(method="test_with_fix_stride", frame_range=[-3, 3],
                   stride=2)
    cfg = tconfig.Config.fromfile(CANONICAL)
    vcfg = dict(cfg["data"]["test"], ann_file=runs["ann"],
                img_prefix=runs["prefix"], ref_img_sampler=sampler)
    ttrain.make_eval_fn(cfg, vcfg, torch.nn.Linear(1, 1), True, "cpu")
    assert (built["ref_method"], built["frame_stride"],
            built["num_ref_frames"]) == ("fix", 2, 6)
    assert built["compute_dtype"] == torch.float32
