"""The learning check's parts against the JAX package, on the CPU:

- ``parallel/train.py::Adam`` against ``optax.chain(clip_by_global_norm(10),
  adam(2e-3))`` over 5 steps, one of them with a gradient norm above the
  clip, on leaves of mixed shapes with a frozen one and one whose gradient
  stops after step 2 (it counts as 0 and the moments keep moving it):
  parameters within 1e-6 (they agree bit for bit here);
- the port's ``tools/learning_smoke.py`` against the root JAX
  ``tools/learning_smoke.py``: the same samples (``make_sample``, a copy),
  the same configuration, and the first 3 training steps' losses from the
  JAX tool's initial weights (``jax.jit(model.init)(PRNGKey(0), ...)``,
  bridged), the samplers' draws carried across as
  ``tests/test_torch_port_train.py`` carries them. Tolerance: step 1 to
  rtol 1e-5 (one f32 forward; equal here); steps 2 and 3 to rtol 1e-4
  (6.4e-6 and 1.6e-5 here: Adam's first update is about lr times the
  sign of each gradient element, so an element near 0 that the two
  frameworks round to opposite signs moves by 2 * lr, and the loss after
  it is 9703). The JAX step is pinned to the original's semantics:
  stop_gradient on the proposals (ROADMAP fault F6) and no update of the
  FrozenBN statistics (F17: the JAX tool's Adam runs over the whole
  variable tree, ``batch_stats`` included);
- the tool's entry on the CPU: one JSON line with the JAX tool's keys,
  TF32 off after the call.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_torch.parallel.train import (
    Adam,
)
from lowlightenvironmentvideoobjectdetection_torch.tools import (
    learning_smoke as TL,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.detectors import (
    faster_rcnn as JR,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.roi_heads import (
    bbox_head as JBH,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.vid import (
    selsa as JS,
)
from test_torch_port_train import jax_uniforms
from torch_port_threads import thread_count

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
FIRST_LOSS_RTOL = 1e-5
LATER_LOSS_RTOL = 1e-4


_pinned_threads = thread_count(4)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_learning_smoke", os.path.join(ROOT, "tools/learning_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_adam_matches_optax():
    rng = np.random.RandomState(0)
    shapes = {"a": (5, 7), "b": (13,), "c": (3, 3, 4), "frozen": (4,),
              "late": (6,)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * (40.0 if i == 2 else 0.3)).astype(
        np.float32) for k, s in shapes.items() if k != "late" or i < 2}
        for i in range(5)]
    trainable = {k: k != "frozen" for k in shapes}
    mask = {k: "train" if trainable[k] else "freeze" for k in shapes}
    opt = optax.chain(optax.clip_by_global_norm(10.0), optax.multi_transform(
        {"train": optax.adam(2e-3), "freeze": optax.set_to_zero()}, mask))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    adam = Adam(trainable, lambda count: 2e-3)
    tstate = adam.init(tp)
    norms, late = [], []
    for g in grads:
        full = {k: jnp.asarray(g.get(k, np.zeros(shapes[k], np.float32)))
                for k in shapes}
        norm = float(optax.global_norm(full))
        updates, jstate = opt.update(full, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k]) if k in g else None
        tstate, tnorm = adam.step(tp, tstate)
        np.testing.assert_allclose(tnorm, norm, rtol=1e-6)
        norms.append(tnorm)
        late.append(tp["late"].detach().clone().numpy())
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6,
                                       err_msg=k)
    assert max(norms) > 10.0 > min(norms)
    assert tstate.count == 5
    np.testing.assert_array_equal(tp["frozen"].detach().numpy(),
                                  p0["frozen"])
    assert not np.array_equal(late[-1], late[1])


def _jax_train_step(model, anchors, opt):
    """The JAX tool's ``train_step`` with F6 (stop_gradient on the
    proposals) and F17 (no update of ``batch_stats``) pinned."""
    def loss_fn(q, batch, key):
        orig = JBH.bbox_targets
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JBH, "bbox_targets", lambda boxes, *a, **k: orig(
                jax.lax.stop_gradient(boxes), *a, **k))
            return JR.faster_rcnn_loss(model, q, batch, key, anchors)

    @jax.jit
    def step(params, opt_state, batch, key):
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch, key)
        grads = dict(grads, batch_stats=jax.tree_util.tree_map(
            jnp.zeros_like, grads["batch_stats"]))
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return step


def test_first_steps_losses_match_the_jax_tool():
    jtool = _jax_tool()
    rng_a, rng_b = np.random.RandomState(0), np.random.RandomState(0)
    for _ in range(4):
        for a, b in zip(jtool.make_sample(rng_a), TL.make_sample(rng_b)):
            np.testing.assert_array_equal(a, b)
    cfg = TL.learning_config()
    jcfg = JS.SelsaConfig(
        pad_h=96, pad_w=96, num_classes=2, compute_dtype=jnp.float32,
        train_nms_pre=256, train_nms_post=64, test_nms_pre=256,
        test_nms_post=64, num_roi_samples=64, anchor_scales=(1, 2, 3),
        frozen_stages=-1)
    for f in ("pad_h", "pad_w", "num_classes", "train_nms_pre",
              "train_nms_post", "test_nms_pre", "test_nms_post",
              "num_roi_samples", "anchor_scales", "frozen_stages"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    jmodel, janchors = JR.make_faster_rcnn(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 96, 96, 3)))
    opt = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(2e-3))
    opt_state = opt.init(params)
    jstep = _jax_train_step(jmodel, janchors, opt)

    tmodel, tanchors = TL.make_faster_rcnn(cfg, None, "cpu")
    tmodel.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    np.testing.assert_array_equal(tanchors.numpy(), np.asarray(janchors))
    topt = TL.make_optimizer(tmodel, 2e-3)
    tstate = topt.init(dict(tmodel.named_parameters()))

    rng = np.random.RandomState(TL.TRAIN_SEED)
    key = jax.random.PRNGKey(1)
    for i in range(STEPS):
        sample = TL.make_sample(rng)
        img, boxes, labels, valid = sample
        batch = JR.DetTrainBatch(jnp.asarray(img), jnp.asarray([96.0, 96.0]),
                                 jnp.asarray(boxes), jnp.asarray(labels),
                                 jnp.asarray(valid))
        key, sub = jax.random.split(key)
        params, opt_state, jloss = jstep(params, opt_state, batch, sub)
        uniforms = jax_uniforms(sub, tanchors.shape[0],
                                boxes.shape[0] + cfg.train_nms_post)
        tstate, tloss = TL.train_step(tmodel, tanchors, topt, tstate, sample,
                                      uniforms=uniforms)
        rtol = FIRST_LOSS_RTOL if i == 0 else LATER_LOSS_RTOL
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=rtol,
                                   err_msg=f"step {i + 1}")
    assert tstate.count == STEPS


def test_tool_prints_the_jax_tools_line_with_tf32_off(capsys):
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    out = TL.main(["--steps", "2", "--eval-images", "2", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert set(line) == {"metric", "map_before", "map_after", "steps"}
    assert line["metric"] == "learning_smoke_mAP50" and line["steps"] == 2
    assert 0.0 <= line["map_before"] <= 1.0
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
