"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line: ``device`` (fails without CUDA), ``build``
(compiles the CUDA kernels from ``csrc/`` with nvcc for sm_90a), ``kernels``
(each kernel against its plain torch version at the main path's shapes, f32
and bf16, with CUDA-event times), ``stream`` (full-width SELSA R50-DC5 at the
default config through ``init_model`` / ``inference_vid``: 14 reference frames
at frame 0, then more frames; launch counters prove both kernels ran) and
``agree`` (f32, TF32 off: the kernel path against the plain path on one
frame). Then one JSON line per kernel summary, and a last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# f32 results are compared below: no TF32 anywhere in this run
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATTN_ATOL = 1e-5        # f32 arithmetic in both versions, any input dtype
ROI_F32_ATOL = 1e-5     # f32: summation order only
ROI_BF16_TOL = 1e-2     # bf16 output: one rounding (rtol and atol)
AGREE_TOL = 1e-3        # f32 head outputs, kernel path vs plain path
STREAM_FRAMES = 10      # streamed after frame 0
PKG = "lowlightenvironmentvideoobjectdetection_torch"


def phase(label, **fields):
    print(f"{label}: " + json.dumps(fields), flush=True)


def timed(fn, iters=20, warmup=3):
    """Mean ms per call over ``iters`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare_times(kernel, plain):
    """plain, kernel, kernel, plain; the two means of each."""
    p1, k1, k2, p2 = timed(plain), timed(kernel), timed(kernel), timed(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def check_close(name, got, want, rtol, atol):
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol,
                               msg=lambda m: f"{name}: {m}")


def attention_inputs(dev, dtype, g, all_masked=False):
    r = lambda *s: (torch.randn(*s, generator=g) * 0.5).to(dev, dtype)  # noqa
    q = r(300, 16, 64)
    k1, v1, k2, v2 = r(16, 4200, 64), r(16, 4200, 64), r(16, 300, 64), \
        r(16, 300, 64)
    if all_masked:
        b1 = torch.full((4200,), -1e30, device=dev)
        b2 = torch.full((300,), -1e30, device=dev)
    else:  # a few masked rois in both slabs, as padded proposals give
        b1 = torch.where(torch.rand(4200, generator=g) < 0.1, -1e30, 0.0)
        b2 = torch.where(torch.rand(300, generator=g) < 0.1, -1e30, 0.0)
    return q, k1, v1, k2, v2, b1.to(dev), b2.to(dev)


def test_rois(dev, n, h, w, g):
    """Random rois in image coordinates plus rois partly and fully outside
    the image and of zero area."""
    x1 = torch.rand(n, generator=g) * (w * 16 + 60) - 60
    y1 = torch.rand(n, generator=g) * (h * 16 + 60) - 60
    r = torch.stack([x1, y1, x1 + torch.rand(n, generator=g) * 400,
                     y1 + torch.rand(n, generator=g) * 400], 1)
    r[:6] = torch.tensor([[-200.0, -200.0, -100.0, -120.0],
                          [w * 16 + 10.0, 20.0, w * 16 + 90.0, 80.0],
                          [-30.0, -20.0, 60.0, 70.0],
                          [w * 16 - 40.0, h * 16 - 30.0, w * 16 + 50.0,
                           h * 16 + 40.0],
                          [50.0, 40.0, 50.0, 40.0],
                          [0.0, 0.0, w * 16.0, h * 16.0]])
    return r.to(dev)


def main() -> int:
    # ---- device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        init_model, inference_vid)
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        selsa as S)
    from lowlightenvironmentvideoobjectdetection_torch.ops import cuda_build
    from lowlightenvironmentvideoobjectdetection_torch.ops.fused_attention import (  # noqa: E501
        selsa_fused_attention_2slab_hm as attention)
    from lowlightenvironmentvideoobjectdetection_torch.ops.roi_align import (
        roi_align)

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    # ---- build
    t0 = time.perf_counter()
    lib_path = cuda_build.build()
    cuda_build.load_library()
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          library=lib_path.name, flags=" ".join(cuda_build.NVCC_FLAGS))

    # ---- kernels at the main path's shapes
    g = torch.Generator().manual_seed(0)
    summary = {}
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for masked in (False, True):
            args = attention_inputs(dev, dtype, g, all_masked=masked)
            got = attention(*args)
            want = attention(*args, impl="plain")
            check_close("attention", got, want, 0.0, ATTN_ATOL)
            errs[f"attention_{str(dtype)[6:]}{'_all_masked' if masked else ''}"] \
                = max_err(got, want)
    args = attention_inputs(dev, torch.bfloat16, g)
    a_ms, a_plain = compare_times(lambda: attention(*args),
                                  lambda: attention(*args, impl="plain"))
    summary["attention"] = dict(
        err=errs["attention_bfloat16"], ms=a_ms, plain_ms=a_plain)

    for dtype in (torch.float32, torch.bfloat16):
        feat = torch.randn(38, 64, 512, generator=g).to(dev, dtype)
        rois = test_rois(dev, 300, 38, 64, g)
        got = roi_align(feat, rois, 1 / 16)
        want = roi_align(feat, rois, 1 / 16, impl="plain")
        tol = ROI_F32_ATOL if dtype == torch.float32 else ROI_BF16_TOL
        check_close("roi_align", got, want, 0.0 if dtype == torch.float32
                    else tol, tol)
        if got[0].abs().max().item() != 0.0:
            raise AssertionError("roi_align: a roi outside the map is not 0")
        errs[f"roi_align_{str(dtype)[6:]}"] = max_err(got, want)
        maps = torch.randn(14, 38, 64, 512, generator=g).to(dev, dtype)
        brois = test_rois(dev, 4200, 38, 64, g)
        binds = torch.arange(14, device=dev).repeat_interleave(300)
        bgot = roi_align(maps, brois, 1 / 16, batch_inds=binds)
        bwant = roi_align(maps, brois, 1 / 16, batch_inds=binds, impl="plain")
        check_close("roi_align batched", bgot, bwant,
                    0.0 if dtype == torch.float32 else tol, tol)
        errs[f"roi_align_batched_{str(dtype)[6:]}"] = max_err(bgot, bwant)
        if dtype == torch.bfloat16:
            r_ms, r_plain = compare_times(
                lambda: roi_align(feat, rois, 1 / 16),
                lambda: roi_align(feat, rois, 1 / 16, impl="plain"))
            rb_ms, rb_plain = compare_times(
                lambda: roi_align(maps, brois, 1 / 16, batch_inds=binds),
                lambda: roi_align(maps, brois, 1 / 16, batch_inds=binds,
                                  impl="plain"), )
            summary["roi_align"] = dict(err=errs["roi_align_bfloat16"],
                                        ms=r_ms, plain_ms=r_plain)
    phase("kernels", max_abs_err=errs,
          attention_bf16_ms=dict(kernel=a_ms, plain=a_plain),
          roi_align_bf16_ms=dict(kernel=r_ms, plain=r_plain),
          roi_align_batched_bf16_ms=dict(kernel=rb_ms, plain=rb_plain),
          tolerances=dict(attention_atol=ATTN_ATOL, roi_f32_atol=ROI_F32_ATOL,
                          roi_bf16_rtol_atol=ROI_BF16_TOL))
    del maps, brois, bgot, bwant

    # ---- stream: full-width SELSA R50-DC5, default config (bf16)
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (STREAM_FRAMES + 1, 600, 1000, 3)
                         ).astype(np.uint8)
    refs = rng.randint(0, 256, (14, 600, 1000, 3)).astype(np.uint8)
    model = init_model("SELSA", seed=0, device=dev)
    cfg = model.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.launches = 0
    roi_align.launches = 0
    lat = []
    results = []
    for fid in range(STREAM_FRAMES + 1):
        t = time.perf_counter()
        out = inference_vid(model, frames[fid], fid,
                            ref_frames=refs if fid == 0 else None)
        lat.append((time.perf_counter() - t) * 1e3)
        results.append(out["bbox_results"])
    n_attn, n_roi = attention.launches, roi_align.launches
    nframes = STREAM_FRAMES + 1
    if n_attn != 2 * nframes or n_roi != nframes + 1:
        raise AssertionError(f"launch counts attention={n_attn} "
                             f"roi_align={n_roi} for {nframes} frames")
    for res in results:
        if len(res) != cfg.num_classes or sum(len(r) for r in res) > 100:
            raise AssertionError("bad per-class result shapes")
        for r in res:
            if r.ndim != 2 or r.shape[1] != 5 or not np.isfinite(r).all():
                raise AssertionError("non-finite or mis-shaped detections")
    st = model.state
    for k, v in st.ref_kv:
        if k.shape != (16, 14, 300, 64) or k.dtype != torch.bfloat16 \
                or not torch.isfinite(k).all() or not torch.isfinite(v).all():
            raise AssertionError("bad memo")
    peak = torch.cuda.max_memory_allocated()
    # fixed DetResult shapes, one more frame straight through the step
    imgs = torch.zeros((cfg.pad_h, cfg.pad_w, 3), device=dev)
    shape = torch.tensor([600.0, 1000.0], device=dev)
    _, dets = S.inference_step(model.model, st, imgs, shape,
                               torch.ones(4, device=dev), model.anchors)
    if (dets.boxes.shape != (100, 4) or dets.scores.shape != (100,)
            or dets.labels.shape != (100,) or dets.valid.shape != (100,)
            or not torch.isfinite(dets.boxes).all()):
        raise AssertionError("bad DetResult")
    steady = lat[1:]
    med = statistics.median(steady)
    phase("stream", card=smi, frames=nframes, frame0_ms=lat[0],
          median_frame_ms=med, frames_per_s=1e3 / med, frame_ms=steady,
          peak_mem_gb=peak / 2**30, launches=dict(attention=n_attn,
                                                  roi_align=n_roi),
          detections_per_frame=[sum(len(r) for r in res) for res in results])
    summary["attention"]["launches"] = n_attn
    summary["roi_align"]["launches"] = n_roi
    del model, st, results

    # ---- agree: f32 full width, kernel path vs plain path
    m32 = init_model("SELSA", seed=0, device=dev, compute_dtype=torch.float32)
    ref_imgs = torch.randn(14, 608, 1024, 3, generator=g).to(dev)
    frame = torch.randn(608, 1024, 3, generator=g).to(dev)
    shape = torch.tensor([608.0, 1024.0], device=dev)
    state = S.init_video_state(m32.model, ref_imgs, shape, m32.anchors)
    got = S.stream_head(m32.model, state, frame, shape, m32.anchors)
    want = S.stream_head(m32.model, state, frame, shape, m32.anchors,
                         impl="plain")
    if not torch.equal(got.proposals.boxes, want.proposals.boxes):
        raise AssertionError("agree: proposals differ")
    check_close("agree cls_score", got.cls_score, want.cls_score, AGREE_TOL,
                AGREE_TOL)
    check_close("agree bbox_pred", got.bbox_pred, want.bbox_pred, AGREE_TOL,
                AGREE_TOL)
    phase("agree", cls_score_max_abs_err=max_err(got.cls_score,
                                                 want.cls_score),
          bbox_pred_max_abs_err=max_err(got.bbox_pred, want.bbox_pred),
          rtol_atol=AGREE_TOL, valid_rois=int(got.proposals.valid.sum()))

    kernels = [
        dict(name="selsa_fused_attention_2slab_hm", route="cuda",
             source=f"{PKG}/csrc/selsa_attention.cu",
             replaces="lowlightenvironmentvideoobjectdetection_tpu/ops/"
                      "fused_attention.py:132",
             launches=summary["attention"]["launches"],
             max_abs_err=summary["attention"]["err"],
             ms=summary["attention"]["ms"],
             plain_ms=summary["attention"]["plain_ms"]),
        dict(name="roi_align", route="cuda", source=f"{PKG}/csrc/roi_align.cu",
             replaces="lowlightenvironmentvideoobjectdetection_tpu/ops/"
                      "roi_align_pallas.py:62",
             launches=summary["roi_align"]["launches"],
             max_abs_err=summary["roi_align"]["err"],
             ms=summary["roi_align"]["ms"],
             plain_ms=summary["roi_align"]["plain_ms"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
