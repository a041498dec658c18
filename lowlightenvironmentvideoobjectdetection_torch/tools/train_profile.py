"""Where the time of a SELSA training step goes, on one NVIDIA GPU.

    python -m lowlightenvironmentvideoobjectdetection_torch.tools.train_profile \
        [--darkfarm [--aggregator]] [--out results.json]

Full-width SELSA R50-DC5 at the JAX training default (the default
``SelsaConfig``: bf16 compute, f32 parameters, 608x1024, 30 classes, key
proposals 6000 -> 600, reference proposals 2000 -> 300, 256 sampled rois),
seeded random weights, one sample of a key and 2 reference frames of
uniform noise with 8 gts, SGD as ``make_optimizer``. With ``--darkfarm``,
the paper's distillation instead (``darkfarm_loss``): the canonical
low-light config without its aggregator (``DARKFARM``: 8 classes, stages
``(0, 1, 2, 3, 3)``, L1 feature loss, TemporalRoIAlign, 3 shared FCs) on
(noise, clean) pairs of the same frames, with the frozen ResCleaner
teacher. With ``--aggregator`` too, the canonical config itself
(``AGGREGATOR``: ``SelsaNewDarkfarmDetect``, the Denoising2Aggregator with
RDBs and TAF, the dual ``_u`` / ``_d`` feature losses). After 3 warm-up
steps:

- stages: 10 steps of the loss's stages (with ``--darkfarm`` also the
  cleaner's forward, the feature loss and TemporalRoIAlign, with
  ``--aggregator`` the aggregator's forward), its backward and the
  optimizer, with a ``torch.cuda.synchronize()`` after each; host clock,
  the median of each;
- step: 15 steps of ``Trainer.step``, synchronised after each;
- device: ``torch.profiler`` over 3 windows of 4 steps: busy time (the
  union of the device events' intervals), idle share 1 - busy / wall, the
  10 kernels with the most device time, and per step the device ms of
  kernels B (``roi_align_gather``), D (``roi_align_scatter``) and the DCN's
  E (``dcn_im2col_tile``), F (``dcn_col2im_tile``) and G
  (``dcn_col2im_coord_tile``).

Prints the card's name and power limit and one JSON line, and with
``--out`` writes it to that file. Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..models.dense_heads import rpn_head as rpn
from ..models.roi_heads import bbox_head as bh
from ..models.vid import selsa as S
from ..models.vid import selsa_darkfarm as D
from ..parallel.train import Trainer, make_optimizer
from .stage_profile import union_ms

STAGED_STEPS, STEPS, WARMUP = 10, 15, 3
WINDOWS, WINDOW_STEPS = 3, 4
# the canonical low-light config without its aggregator
# (configs/vid/llvod/llvod_l1234_fusion_add_i1234_rdb_taf_darkfarm.py)
DARKFARM = D.DarkfarmConfig(
    selsa=S.SelsaConfig(num_classes=8, out_indices=(0, 1, 2, 3, 3),
                        roi_extractor="temporal", num_shared_fcs=3),
    loss_type="l1")
# the canonical config (SelsaNewDarkfarmDetect): with its aggregator
AGGREGATOR = dataclasses.replace(DARKFARM, with_aggregator=True)
# device ms per step by kernel symbol
KERNEL_SYMBOLS = ("roi_align_gather", "roi_align_scatter", "dcn_im2col_tile",
                  "dcn_col2im_tile", "dcn_col2im_coord_tile")


def train_sample(cfg, device, seed=0) -> S.TrainBatch:
    """A training sample as ``tools/bench_train.py`` makes one: a key and 2
    reference frames of uniform noise in [-1, 1], a 600x1000 image in the
    bucket, 8 gts of 30-200 px in its top-left quarter, labels in
    [0, 5)."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((8, 4), np.float32)
    gt[:, 0] = rng.uniform(0, cfg.pad_w / 2, 8)
    gt[:, 1] = rng.uniform(0, cfg.pad_h / 2, 8)
    gt[:, 2:] = gt[:, :2] + rng.uniform(30, 200, (8, 2))
    t = lambda a, **kw: torch.as_tensor(a, device=device, **kw)  # noqa: E731
    return S.TrainBatch(
        t(rng.uniform(-1, 1, (3, cfg.pad_h, cfg.pad_w, 3)).astype(np.float32)),
        t([600.0, 1000.0]), t(gt), t(rng.randint(0, 5, 8), dtype=torch.int64),
        t(np.ones(8, bool)))


def darkfarm_sample(cfg: D.DarkfarmConfig, device, seed=0) -> D.DarkfarmBatch:
    """``train_sample``'s frames as the clean half of each pair and a dark,
    noisy copy (a third of the signal plus N(0, 0.1^2) noise) as the noisy
    half: [3, H, W, 6], or 8 channels for RAW (``in_channels=4``, the
    frames' first channel repeated)."""
    smp = train_sample(cfg.selsa, device, seed)
    clean = smp.imgs
    if cfg.in_channels == 4:
        clean = torch.cat([clean, clean[..., :1]], -1)
    g = torch.Generator().manual_seed(seed + 1)
    noise = clean / 3 + torch.randn(clean.shape, generator=g).to(device) * 0.1
    return D.DarkfarmBatch(torch.cat([noise, clean], -1), smp.img_shape,
                           smp.gt_boxes, smp.gt_labels, smp.gt_valid)


def staged_step(model, opt, opt_state, sample, anchors, generator):
    """``selsa_loss`` (``darkfarm_loss`` for a ``SelsaDarkfarmDetector``
    and its ``DarkfarmBatch``, noise branch), its backward and one optimizer
    update, synchronised after each stage; returns the optimizer state and
    each stage's host ms."""
    darkfarm = isinstance(model, D.SelsaDarkfarmDetector)
    top, model = model, model.selsa if darkfarm else model
    cfg = model.cfg
    times = {}
    t = time.perf_counter()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        times[name] = (now - t) * 1e3
        t = now

    u = S.draw_loss_uniforms(cfg, sample.gt_boxes.shape[0], generator,
                             anchors.device)
    feature_loss = 0.0
    if darkfarm:
        dcfg = top.cfg
        c = dcfg.in_channels
        stages, neck = model.extract_feats(sample.pair_imgs[..., :c])
        mark("backbone + neck")
        denoised = None
        if dcfg.with_aggregator:
            denoised, neck = top.denoise_feats(stages, neck)
            mark("aggregator forward")
        targets = top.cleaner(sample.pair_imgs[..., c:])
        mark("cleaner forward (teacher)")
        loss_fn = D.FEATURE_LOSSES[dcfg.loss_type]
        for i, tgt in enumerate(targets):
            for _, feats in D.feature_branches(dcfg, stages, denoised):
                feature_loss = feature_loss + loss_fn(feats[i].float(),
                                                      tgt.float())
        mark("feature loss")
    else:
        neck = model.extract_feat(sample.imgs)
        mark("backbone + neck")
    cls, reg = model.rpn_forward(neck)
    mark("RPN head")
    rpn_l = rpn.rpn_loss(cls[0], reg[0], anchors, sample.gt_boxes,
                         sample.gt_valid, u.rpn, sample.img_shape)
    mark("RPN loss")
    with torch.no_grad():
        key = rpn.rpn_proposals(cls[0], reg[0], anchors, sample.img_shape,
                                nms_pre=cfg.train_nms_pre,
                                nms_post=cfg.train_nms_post,
                                iou_threshold=cfg.rpn_nms_iou)
        mark("key proposals (NMS, k = 6000)")
        refs = rpn.rpn_proposals(cls[1:], reg[1:], anchors,
                                 sample.img_shape.expand(2, 2),
                                 nms_pre=cfg.test_nms_pre,
                                 nms_post=cfg.test_nms_post,
                                 iou_threshold=cfg.rpn_nms_iou)
        mark("reference proposals (NMS, k = 2000)")
    tgts = bh.bbox_targets(key.boxes, key.valid, sample.gt_boxes,
                           sample.gt_labels, sample.gt_valid, u.roi,
                           num_classes=cfg.num_classes,
                           num_samples=cfg.num_roi_samples)
    mark("RoI targets")
    kf = model.roi_feats(neck[0], tgts.rois)
    binds = torch.arange(2, device=neck.device).repeat_interleave(
        cfg.test_nms_post)
    rf = model.roi_feats(neck[1:], refs.boxes.reshape(-1, 4), binds)
    mark("RoIAlign (kernel B x 2)")
    if cfg.roi_extractor == "temporal":
        kf = model.troi(kf, neck[1:])
        mark("TemporalRoIAlign (2 maps)")
    cs, bp = model.bbox_head(kf, rf, refs.valid.reshape(-1))
    roi_l = bh.bbox_loss(cs, bp, tgts, num_classes=cfg.num_classes)
    mark("SELSA head + loss")
    (feature_loss + rpn_l.loss_cls + rpn_l.loss_bbox + roi_l.loss_cls
     + roi_l.loss_bbox).backward()
    mark("backward (kernel D x 2)")
    params = dict(top.named_parameters())
    opt_state, _ = opt.step(params, opt_state)
    for p in params.values():
        p.grad = None
    mark("optimizer")
    return opt_state, times


def device_windows(step, state):
    """Busy ms per step, idle share and device ms per step by kernel name
    over WINDOWS profiled windows of WINDOW_STEPS steps."""
    from torch.profiler import ProfilerActivity, profile

    out, by_name = [], defaultdict(float)
    for _ in range(WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(WINDOW_STEPS):
                state = step(state)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if not dev:
            raise RuntimeError("the profiler recorded no device events")
        busy = union_ms([(e.time_range.start, e.time_range.end)
                         for e in dev])
        for e in dev:
            by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
        out.append(dict(busy_ms_per_step=busy / WINDOW_STEPS,
                        wall_ms_per_step=wall / WINDOW_STEPS,
                        idle_share=1.0 - busy / wall))
    steps = WINDOWS * WINDOW_STEPS
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    kernels = {key: sum(v for n, v in by_name.items() if key in n) / steps
               for key in KERNEL_SYMBOLS}
    return state, out, dict(top=[(n, v / steps) for n, v in top],
                            **{f"{k}_ms_per_step": v
                               for k, v in kernels.items()})


def profile_train(seed: int = 0, darkfarm: bool = False,
                  aggregator: bool = False) -> dict:
    dev = torch.device("cuda")
    if darkfarm:
        dcfg = AGGREGATOR if aggregator else DARKFARM
        model, anchors = D.make_darkfarm(
            dcfg, torch.Generator().manual_seed(seed), device=dev)
        sample = darkfarm_sample(dcfg, dev, seed)

        def loss_fn(m, smp, g):
            return D.darkfarm_loss(m, smp, anchors, generator=g)
    else:
        cfg = S.SelsaConfig()
        model = S.SelsaDetector(cfg)
        S.init_params(model, torch.Generator().manual_seed(seed))
        model = model.to(dev)
        anchors = S.make_anchors(cfg, dev)
        sample = train_sample(cfg, dev, seed)

        def loss_fn(m, smp, g):
            return S.selsa_loss(m, smp, anchors, generator=g)
    batch = type(sample)(*(f[None] for f in sample))
    gen = torch.Generator().manual_seed(seed)
    trainer = Trainer(loss_fn, make_optimizer(model))
    state = trainer.init_state(model)

    def step(st):
        return trainer.step(st, batch, [gen])[0]

    for _ in range(WARMUP):
        state = step(state)
    stages = defaultdict(list)
    opt_state = state.opt_state
    torch.cuda.reset_peak_memory_stats()
    for _ in range(STAGED_STEPS):
        opt_state, times = staged_step(model, trainer.optimizer, opt_state,
                                       sample, anchors, gen)
        for k, v in times.items():
            stages[k].append(v)
    state = state._replace(opt_state=opt_state)
    step_ms = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = step(state)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    state, windows, kernels = device_windows(step, state)
    med = statistics.median(step_ms)
    stage_ms = {k: statistics.median(v) for k, v in stages.items()}
    return dict(stage_ms=stage_ms, staged_sum_ms=sum(stage_ms.values()),
                step_ms=step_ms, median_step_ms=med, steps_per_s=1e3 / med,
                peak_mem_gb=peak / 2**30, device=windows,
                device_ms_per_step=kernels)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--darkfarm", action="store_true",
                    help="profile darkfarm_loss at the canonical low-light "
                         "config (DARKFARM) instead of selsa_loss")
    ap.add_argument("--aggregator", action="store_true",
                    help="with --darkfarm: the canonical config with its "
                         "Denoising2Aggregator (AGGREGATOR)")
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args()
    if args.aggregator and not args.darkfarm:
        ap.error("--aggregator needs --darkfarm")
    if not torch.cuda.is_available():
        raise SystemExit("train_profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    result = dict(card=smi, darkfarm=args.darkfarm,
                  aggregator=args.aggregator,
                  **profile_train(darkfarm=args.darkfarm,
                                  aggregator=args.aggregator))
    print(json.dumps(result), flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
