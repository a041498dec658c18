"""Where the time of a batched SELSA step goes, on one NVIDIA GPU.

    python -m lowlightenvironmentvideoobjectdetection_torch.tools.stage_profile \
        [--streams 1 4 8] [--out results.json]

Full-width SELSA R50-DC5 at the default config (bf16, 608x1024 bucket, 14
reference frames x 300 proposals in the memo), seeded random weights,
frames and memo. For each S, S streams go through the batched step
(``inference_step_batch`` with the memo rolled every step), after 3 warm-up
steps:

- stages: 10 steps with a ``torch.cuda.synchronize()`` after each stage,
  host clock; the median of each stage;
- step: 15 unstaged steps, synchronised after each; median and all;
- device: ``torch.profiler`` over 3 windows of 4 steps; busy time is the
  union of the device events' intervals, idle share 1 - busy / wall, and
  device time by kernel name (kernel A is ``selsa_attn``, B ``roi_align``),
  and of the kernel that starts next after each kernel-B launch (the first
  FC of the head, which reads B's output).

Prints the card's name and power limit and one JSON line per S, and with
``--out`` writes them all to that file. Needs a CUDA device; fails without
one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch

from ..apis.inference import init_model
from ..models.roi_heads import bbox_head as bh
from ..models.vid import selsa as S
from ..parallel.serve import batched_video_state

STAGED_STEPS, STEPS, WARMUP = 10, 15, 3
WINDOWS, WINDOW_STEPS = 3, 4


def staged_step(model, states, frames, shapes, sfs, anchors):
    """``inference_step_batch`` with the memo roll, synchronised after each
    stage; returns the states and each stage's host ms."""
    cfg, head = model.cfg, model.bbox_head
    times = {}
    t = time.perf_counter()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        times[name] = (now - t) * 1e3
        t = now

    neck = model.extract_feat(frames)
    mark("backbone + neck")
    cls, reg = model.rpn_forward(neck)
    mark("RPN head")
    props = S._proposals(cfg, cls, reg, anchors, shapes)
    mark("proposals")
    s, p = props.boxes.shape[:2]
    binds = torch.arange(s, device=neck.device).repeat_interleave(p)
    rfeats = model.roi_feats(neck, props.boxes.reshape(-1, 4), binds)
    mark("RoIAlign")
    ref_kvs = tuple((k.flatten(-3, -2), v.flatten(-3, -2))
                    for k, v in states.ref_kv)
    (cls_score, bbox_pred), cur_kvs = head.forward_cached_stream_kv(
        rfeats.reshape(s, p, *rfeats.shape[1:]), ref_kvs,
        states.ref_valid.flatten(-2), props.valid)
    mark("SELSA head")
    bh.bbox_decode(props.boxes, cls_score, bbox_pred, shapes,
                   roi_valid=props.valid, scale_factor=sfs,
                   nms_pre=cfg.det_nms_pre)
    mark("decode")
    states = S.roll_memo(states, cur_kvs, props.valid)
    mark("memo roll")
    return states, times


def union_ms(intervals):
    """Total length of the union of (start, end) intervals, in ms (the
    profiler's times are in us)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy / 1e3


def device_windows(step, states):
    """Busy ms per step, idle share and device ms per step by kernel name
    over WINDOWS profiled windows of WINDOW_STEPS steps."""
    from torch.profiler import ProfilerActivity, profile

    out, by_name, after = [], defaultdict(float), defaultdict(float)
    for _ in range(WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(WINDOW_STEPS):
                states = step(states)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if not dev:
            raise RuntimeError("the profiler recorded no device events")
        busy = union_ms([(e.time_range.start, e.time_range.end)
                         for e in dev])
        dev.sort(key=lambda e: e.time_range.start)
        for i, e in enumerate(dev):
            ms = (e.time_range.end - e.time_range.start) / 1e3
            by_name[e.name] += ms
            if i and "roi_align" in dev[i - 1].name:
                after[e.name] += ms
        out.append(dict(busy_ms_per_step=busy / WINDOW_STEPS,
                        wall_ms_per_step=wall / WINDOW_STEPS,
                        idle_share=1.0 - busy / wall))
    steps = WINDOWS * WINDOW_STEPS
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    kernel = {key: sum(v for n, v in by_name.items() if key in n) / steps
              for key in ("selsa_attn", "roi_align")}
    return states, out, dict(top=[(n, v / steps) for n, v in top],
                             after_roi_align={n: v / steps
                                              for n, v in after.items()},
                             **{f"{k}_ms_per_step": v
                                for k, v in kernel.items()})


@torch.no_grad()
def profile_streams(model, n_streams: int, seed: int = 0) -> dict:
    cfg, anchors, dev = model.cfg, model.anchors, model.device
    g = torch.Generator(device="cpu").manual_seed(seed)
    states = batched_video_state(cfg, n_streams, device=dev, generator=g)
    frames = torch.randn((n_streams, cfg.pad_h, cfg.pad_w, 3),
                         generator=g).to(dev)
    shapes = torch.tensor([[600.0, 1000.0]] * n_streams, device=dev)
    sfs = torch.ones((n_streams, 4), device=dev)

    def step(st):
        return S.inference_step_batch(model.model, st, frames, shapes, sfs,
                                      anchors, update_memo=True)[0]

    for _ in range(WARMUP):
        states = step(states)
    stages = defaultdict(list)
    for _ in range(STAGED_STEPS):
        states, times = staged_step(model.model, states, frames, shapes, sfs,
                                    anchors)
        for k, v in times.items():
            stages[k].append(v)
    step_ms = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        states = step(states)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    states, windows, kernels = device_windows(step, states)
    med = statistics.median(step_ms)
    return dict(streams=n_streams,
                stage_ms={k: statistics.median(v) for k, v in stages.items()},
                step_ms=step_ms, median_step_ms=med,
                frames_per_s=n_streams / (med / 1e3), device=windows,
                device_ms_per_step=kernels)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, nargs="+", default=[1, 4, 8])
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stage_profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    model = init_model("SELSA", seed=0)
    results = []
    for n in args.streams:
        r = profile_streams(model, n)
        print(json.dumps(r), flush=True)
        results.append(r)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(card=smi, results=results), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
