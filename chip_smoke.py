"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line: ``device`` (fails without CUDA), ``build``
(compiles the CUDA kernels from ``csrc/`` with nvcc for sm_90a, one nvcc per
source in parallel), ``kernels`` (each kernel against its plain torch
version at the main paths' shapes, f32 and bf16, with CUDA-event times:
first a known-answer check of the tensor-core body's fragment layouts, then
kernel A single-stream and stream-batched at S = 4, kernel B at the
single-stream, S = 4 serve and memo-fill shapes, kernel C alone and against
kernel A on the same keys; each timed beside its plain version and, for A
and C, one ``F.scaled_dot_product_attention`` call on the same inputs as a
yardstick, with its bound from the shapes), ``stream`` (full-width SELSA
R50-DC5 at the default config through ``init_model`` / ``inference_vid``: 14
reference frames at frame 0, then more frames; launch counters prove both
kernels ran, every kernel-A launch took the tensor-core body and every
kernel-B launch the 7x7 gather body), ``agree`` (f32, TF32
off: the kernel path, through the CUDA-core body, against the plain path on
one frame), ``serve_agree`` (f32: the batched kernel path against the
batched plain path, and each stream of the batch against that stream
alone), ``serve`` (S = 4 streams of T = 8 frames through
``make_serve_step``, clip mode, then per-frame steps; one kernel-A launch
per head stage, all on the tensor-core body, and one kernel-B launch per
memo fill and per batched step, all on the 7x7 gather body) and
``single_slab`` (kernel C on the path: the SELSA stages built from the
head's public methods with ``attend_cached`` over the concatenated memo and
current K/V, against ``forward_cached_stream_kv``), ``train`` (full-width
SELSA R50-DC5 training at the JAX training default, bf16 compute with f32
parameters, one sample of a key and 2 reference frames, through
``train_model`` and ``Trainer``: 2 warm-up and 8 timed steps, each launching
kernel B twice on the 7x7 gather body and kernel D, RoIAlign's backward,
twice; frozen parameters bit-identical, the others changed) and
``train_agree`` (f32, TF32 off: one loss and every gradient at full width
through the kernels and through the plain RoIAlign, with the same
uniforms). The ``kernels`` phase also holds kernel B at the training
shapes, and kernel D against its plain version and torch autograd (f32,
cast) at the training shapes, on the ``train`` phase's own rois (rebuilt
from its sample) and over a footprint sweep (600 square rois of 0 to 512
px, and 128 px stacked on one spot), timed eagerly and from a CUDA graph;
the sweep prints a ``kernel_d_sweep`` line. Then the paper's method:
``darkfarm_train`` (full-width ``darkfarm_loss`` at the canonical
low-light config without its aggregator, TemporalRoIAlign and 3 shared
FCs, through ``train_model``: kernels B and D twice a step, the frozen
teacher and stages bit-identical, the stage times of the teacher, the
feature loss and TemporalRoIAlign), ``darkfarm_agree`` (its f32 loss and
gradients through the kernels against the plain RoIAlign, TemporalRoIAlign's
top-k flips counted and pinned), ``troi_serve`` (``serve`` at the temporal
config, three kernel-A launches a step) and ``troi_stream`` (streaming
with TemporalRoIAlign against 14 reference maps: its time, split and bound,
the roll of the maps, f32 agreement). Then the canonical config with its
Denoising2Aggregator: ``agg_train`` (full-width ``darkfarm_loss`` with
the aggregator and the dual ``_u`` / ``_d`` feature losses through
``train_model``: kernels B and D twice and DCNv2's kernels E, F and G 12
times a step, the teacher and the frozen stages bit-identical, every
aggregator leaf changed, the aggregator's forward among the stage times)
and ``agg_agree`` (its f32 loss and gradients through the kernels against
the plain RoIAlign and DCN, with ``conv_offset`` perturbed so the offsets
are fractional, their range printed; top-k flips pinned). The
``kernels`` phase also holds E (the im2col), F (the input's gradient) and
G (the offsets' and the mask's) at the aggregator's four stage shapes,
f32 and bf16, at three offset scales (0, 1.5 px and 2.5 px with some
beyond the map), against their plain versions and autograd, timed eagerly
and from a CUDA graph. Then the training data path from files, in a
temporary directory under the checkout: ``data_train`` (a DarkFarm-layout
tree of 2 x 10 PNG pairs at 1080x1920 written with the port's PNG writer
and a COCO-VID annotation file; the port's CLI, ``tools/train.py``, on the
canonical config with ``--cfg-options`` pointing ``data.train`` at it, 6
steps with 4 loader workers and 6 without: B and D twice and E, F, G 12
times a step, finite losses, the loader's host ms a batch beside the step
ms, the device's idle share with and without workers; then one sample's
device stages on the card and on the CPU from the same files and draws,
uint8 stages equal, float stages to DATA_FLOAT_TOL) and ``noise_raw``
(``SeqAddNoise`` 'a7s3' and ``SeqsRGB2RAW`` + ``SeqNormalizeRAW`` on those
frames on the card against the CPU with the same draws, the a7s3 noise's
per-channel moments from the card's own generator against the model, and
3 steps of ``llvod_raw_darkfarm.py`` through the CLI on 8-channel RAW
pairs: B and D twice a step). Then one JSON line of kernel summaries
(A-G), and a last line ``{"ok": true, "device": {...}}``. Any failure
exits non-zero.

    python3 chip_smoke.py --roi-grad-times ROOT
    python3 chip_smoke.py --dcn-times ROOT

run kernel D's cases, or DCNv2's (E, F, G at every offset scale), alone
with the package of the checkout at ROOT (for comparing two commits in one
call) and print their JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ATTN_ATOL = 1e-5        # f32 sums of exact products; P to ~16 bits in bf16
LIBRARY_TOL = 2e-2      # SDPA yardstick: bf16 P and bf16 output
ROI_F32_ATOL = 1e-5     # f32: summation order only
ROI_BF16_TOL = 1e-2     # bf16 output: one rounding (rtol and atol)
AGREE_TOL = 1e-3        # f32 head outputs, kernel path vs plain path
STREAM_FRAMES = 10      # streamed after frame 0
SERVE_S, SERVE_T = 4, 8  # streams and frames per clip of the serve phase
# kernel B's shapes on the main paths: (name, maps, rois); 300 proposals a
# map when streaming, 256 sampled key rois and 300 proposals a reference map
# when training
ROI_SHAPES = (("single", 1, 300),
              (f"serve_s{SERVE_S}", SERVE_S, SERVE_S * 300),
              ("memo_fill", 14, 4200),
              ("train_key", 1, 256),
              ("train_refs", 2, 600))
# kernel D's shapes on the training path, the reference maps' first
ROI_GRAD_SHAPES = (("train_refs", 2, 600), ("train_key", 1, 256))
ROI_GRAD_F32_REL = 1e-5    # of max |grad|: the atomic order varies per run
ROI_GRAD_BF16_RTOL = 2.0 ** -7  # one bf16 rounding of the f32 sum
# kernel D's footprint sweep: ROI_GRAD_SWEEP_N square rois of one size (image
# px) on the 2 reference maps, at random positions or all on one spot
ROI_GRAD_SWEEP_N = 600
ROI_GRAD_SWEEP = (("square_0px", 0.0, False), ("square_32px", 32.0, False),
                  ("square_128px", 128.0, False),
                  ("square_512px", 512.0, False),
                  ("stacked_128px", 128.0, True))
TRAIN_WARMUP, TRAIN_STEPS = 2, 8
TRAIN_LOSS_RTOL = 1e-5     # train_agree: the f32 loss, kernels vs plain
TRAIN_GRAD_REL = 1e-4      # train_agree: of each leaf's max |grad| ...
TRAIN_GRAD_FLOOR = 1e-6    # ... and at least this of the largest of any
FROZEN = ("backbone.conv1", "backbone.bn1", "backbone.layer1_")
# the darkfarm model: the detector's frozen stages and the whole teacher
DARKFARM_FROZEN = tuple("selsa." + f for f in FROZEN) + ("cleaner.",)
DARKFARM_STAGED = 5     # darkfarm_train: staged steps for the stage times
# streaming with TemporalRoIAlign and 3 shared FCs (troi_stream)
TROI_CFG = dict(roi_extractor="temporal", num_shared_fcs=3, num_classes=8)
# zero gradient in exact arithmetic (softmax ignores a constant per query,
# and the TAF's softmax over the frames a constant per pixel): these biases
# may stay at their initial 0
ZERO_GRAD = (".ref_fc_embed.bias", "_taf.emb_conv2.bias")
# DCNv2 (kernels E, F, G) at the aggregator's stage shapes, T = 3 frames of
# 608x1024, G = 8: (name, channels, h, w)
DCN_SHAPES = (("stage0", 64, 152, 256), ("stage1", 128, 76, 128),
              ("stage2", 256, 38, 64), ("stage3", 512, 38, 64))
DCN_FRAMES, DCN_GROUPS = 3, 8
DCN_REL = 1e-5             # of max |value|: F's atomic order varies per run
DCN_BF16_RTOL = 2.0 ** -7  # x's bf16 gradient: one rounding of the f32 sum
# agg_agree: conv_offset perturbed so the offsets have this std (feature px)
AGG_OFFSET_STD = 1.5
# the DCN kernels' offsets: (name, std in px, every 50th pushed beyond the
# map): 0 as in a step near the zero init, agg_agree's std, and PR 8's cases
DCN_OFFSETS = (("std0", 0.0, False), ("std1.5", AGG_OFFSET_STD, False),
               ("std2.5", 2.5, True))
NO_LIBRARY_DCN = "none (no torchvision): no PyTorch call computes DCNv2"
SERVE_STEPS = 3         # per-frame batched steps after the clips
AGREE_S, AGREE_T = 2, 3  # serve_agree: streams, frames (roll every 2nd)
SET_BOX_TOL = 5e-3      # px; detections as sets, f32 (as the CPU tests)
SET_SCORE_TOL = 1e-5
RAW_HW = (600, 1000)    # raw frames of the serve phase, before prepare
PKG = "lowlightenvironmentvideoobjectdetection_torch"
REPO = Path(__file__).resolve().parent
KERNEL_NAMES = ("attention", "roi_align", "attention_1slab",
                "roi_align_backward", "dcn_im2col", "dcn_col2im",
                "dcn_col2im_coord")
# data_train / noise_raw: the training data path from files
CANONICAL_CFG = ("configs/vid/llvod/"
                 "llvod_l1234_fusion_add_i1234_rdb_taf_darkfarm.py")
RAW_CFG = "configs/vid/llvod/llvod_raw_darkfarm.py"
DATA_TREE = dict(videos=2, frames=10, hw=(1080, 1920))  # DarkFarm's frames
DATA_STEPS, RAW_STEPS = 6, 3
DATA_PROFILED = 2       # data_train: the last steps, under the profiler
DATA_WORKERS = 4
# launches a step of A-G (KERNEL_NAMES): the canonical step, and the RAW
# config's (no aggregator)
DATA_PER_STEP = (0, 2, 0, 2, 12, 12, 12)
RAW_PER_STEP = (0, 2, 0, 2, 0, 0, 0)
DATA_FLOAT_TOL = 1e-6   # of max |x|: a batch's float stages, card vs CPU
NOISE_RTOL = 1e-6       # of max |x|: AddNoise with the same draws
RAW_RTOL = 1e-5         # of max |x|: sRGB2RAW, the card's sin/asin/pow
MOMENT_CLEAN = 128.0    # the constant frame of the a7s3 moment check
MOMENT_SIGMAS = 5.0     # its tolerance, in standard errors
# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12   # CUDA cores
NO_LIBRARY_ROI_ALIGN = ("no PyTorch call computes RoIAlign in this install "
                        "(torchvision absent)")


def attention_cost(s, n, nb, m1, m2, hd=64, q_bytes=2, kv_bytes=2):
    """(bytes, FLOPs) of kernel A over S streams (kernel C: m2 = 0): q, the
    K/V of both slabs and the f32 biases read once, the f32 output written
    once; 2 FLOPs per multiply-add of Q.K^T and of P.V."""
    m = m1 + m2
    nbytes = s * (n * nb * hd * q_bytes + 2 * nb * m * hd * kv_bytes + 4 * m
                  + 4 * n * nb * hd)
    return nbytes, 4 * s * n * nb * m * hd


def roi_align_cost(n_maps, h, w, c, n_rois, feat_bytes=2, bind_bytes=0,
                   out_size=7, sampling_ratio=2):
    """(bytes, FLOPs) of kernel B: the maps, the f32 rois [N, 4] and, for a
    batch, the per-roi map index (``bind_bytes`` each) read once, the output
    in the feature dtype written once; 2 FLOPs per corner of each of the
    sampling_ratio^2 samples of an output element."""
    out_elems = n_rois * out_size * out_size * c
    nbytes = (n_maps * h * w * c * feat_bytes + 16 * n_rois
              + bind_bytes * n_rois + feat_bytes * out_elems)
    return nbytes, 8 * sampling_ratio ** 2 * out_elems


def roi_align_backward_cost(n_maps, h, w, c, n_rois, feat_bytes=2,
                            bind_bytes=0, out_size=7, sampling_ratio=2):
    """(bytes, FLOPs, atomic adds) of kernel D: grad_out in the feature
    dtype, the f32 rois and the per-roi map index read once, the maps'
    gradient in the feature dtype written once; each corner of each
    sub-sample of an output element is one atomic add of a product (2
    FLOPs)."""
    out_elems = n_rois * out_size * out_size * c
    atomics = 4 * sampling_ratio ** 2 * out_elems
    nbytes = (feat_bytes * out_elems + 16 * n_rois + bind_bytes * n_rois
              + n_maps * h * w * c * feat_bytes)
    return nbytes, 2 * atomics, atomics


def dcn_cost(kernel, n, c, h, w, g, x_bytes=2):
    """(bytes, FLOPs) of DCN kernel E, F or G at [n, c, h, w] with g deform
    groups: E reads x, the f32 offsets and mask once and writes the f32
    columns [n, 9c, hw] once, 8 FLOPs a column entry (4 corner products,
    3 sums, the mask); F reads the columns' gradient, the offsets and the
    mask and writes x's gradient once in x's dtype, 9 FLOPs an entry (the
    mask, 4 products, 4 adds); G reads the columns' gradient, x, the offsets and the
    mask and writes the offsets' and the mask's gradients, 23 FLOPs an entry
    (the bilinear sum, the two corner-difference derivatives and the three
    accumulations)."""
    hw = h * w
    cols = 4 * n * 9 * c * hw
    coords = 4 * n * g * 27 * hw  # f32 offsets and mask (or their grads)
    xb = n * c * hw * x_bytes
    entries = n * 9 * c * hw
    if kernel == "E":
        return xb + coords + cols, 8 * entries
    if kernel == "F":
        return cols + coords + xb, 9 * entries
    return cols + xb + 2 * coords, 23 * entries


def bound(nbytes, flops, flop_per_s):
    """(bound_ms, bound_by): the least time of the card for the work, the
    larger of bytes over the memory rate and FLOPs over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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


def graph_ms(fn, iters=20):
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed twice after a warm-up replay, timed by CUDA events (no
    host time between the calls, which an eager loop of short calls
    measures instead)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (2 * iters)


def compare_times(kernel, plain, library=None):
    """plain, kernel, kernel, plain (plain, library, kernel, kernel,
    library, plain with a library call); the two means of each (None for
    no library call)."""
    p1 = timed(plain)
    l1 = timed(library) if library else None
    k1, k2 = timed(kernel), timed(kernel)
    l2 = timed(library) if library else None
    p2 = timed(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2 if library else None


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


def attention_times(fn, args, err):
    """Kernel A (7 operands) or C (4 operands) at its shapes: the kernel,
    its plain version and one ``F.scaled_dot_product_attention`` call on the
    same inputs (a yardstick; the port never calls it), in the turns plain,
    SDPA, kernel, kernel, SDPA, plain. SDPA gets the K/V slabs concatenated,
    the bias as a mask in q's dtype and q's heads moved forward (a view)
    beforehand, outside the timing. Returns the times, the bound from the
    shapes and the errors (the kernel's, given; SDPA's against the kernel,
    within LIBRARY_TOL)."""
    import torch.nn.functional as F
    q = args[0]
    if len(args) == 7:
        _, k1, v1, k2, v2, b1, b2 = args
        k, v, b = (torch.cat([k1, k2], -2), torch.cat([v1, v2], -2),
                   torch.cat([b1, b2], -1))
        m2 = k2.shape[-2]
    else:
        _, k, v, b = args
        m2 = 0
    if q.ndim == 3:  # one stream: SDPA takes a batch axis
        q, k, v, b = q[None], k[None], v[None], b[None]
    qh = q.transpose(1, 2)  # [S, nb, N, hd]
    mask = b.to(q.dtype)[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)

    lib_err = max_err(library().transpose(1, 2), fn(*args).reshape(q.shape))
    if lib_err > LIBRARY_TOL:
        raise AssertionError(f"SDPA yardstick differs by {lib_err}")
    ms, plain_ms, library_ms = compare_times(
        lambda: fn(*args), lambda: fn(*args, impl="plain"), library)
    s, n, nb, hd = q.shape
    nbytes, flops = attention_cost(s, n, nb, k.shape[-2] - m2, m2, hd,
                                   q.element_size(), k.element_size())
    bound_ms, bound_by = bound(nbytes, flops, BF16_TENSOR_FLOP_PER_S)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, share_of_bound=bound_ms / ms,
                library_ms=library_ms, library_max_abs_err=lib_err,
                bytes=nbytes, flops=flops)


def roi_align_times(roi_align, feats, rois, binds, err):
    """Kernel B at one of its shapes: the kernel and its plain version in
    the turns plain, kernel, kernel, plain, and the bound from the shapes;
    no library call (NO_LIBRARY_ROI_ALIGN)."""
    ms, plain_ms, _ = compare_times(
        lambda: roi_align(feats, rois, 1 / 16, batch_inds=binds),
        lambda: roi_align(feats, rois, 1 / 16, batch_inds=binds,
                          impl="plain"))
    maps = feats if feats.ndim == 4 else feats[None]
    nbytes, flops = roi_align_cost(
        *maps.shape, rois.shape[0], feats.element_size(),
        0 if binds is None else binds.element_size())
    bound_ms, bound_by = bound(nbytes, flops, F32_FLOP_PER_S)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, share_of_bound=bound_ms / ms,
                library_ms=None, library_note=NO_LIBRARY_ROI_ALIGN,
                bytes=nbytes, flops=flops, maps=maps.shape[0],
                rois=rois.shape[0])


def roi_align_kernels(dev, g, roi_align, errs):
    """Kernel B at each of ROI_SHAPES, f32 and bf16: one launch on the 7x7
    gather body against the plain version (the first roi lies outside the
    map and must give 0), errors into ``errs``; then the bf16 times. Returns
    the single-stream shape's times with the others under their names."""
    times = {}
    for name, n_maps, n_rois in ROI_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            maps, rois, binds = roi_inputs(dev, dtype, g, n_maps, n_rois)
            n_body = roi_align.body_launches["gather7x2"]
            got = roi_align(maps, rois, 1 / 16, batch_inds=binds)
            if roi_align.body_launches["gather7x2"] != n_body + 1:
                raise AssertionError(f"roi_align {name}: not the gather7x2 "
                                     "body")
            want = roi_align(maps, rois, 1 / 16, batch_inds=binds,
                             impl="plain")
            tol = ROI_F32_ATOL if dtype == torch.float32 else ROI_BF16_TOL
            check_close(f"roi_align {name}", got, want,
                        0.0 if dtype == torch.float32 else tol, tol)
            if got[0].abs().max().item() != 0.0:
                raise AssertionError(f"roi_align {name}: a roi outside the "
                                     "map is not 0")
            errs[f"roi_align_{name}_{str(dtype)[6:]}"] = max_err(got, want)
        times[name] = roi_align_times(roi_align, maps, rois, binds,
                                      errs[f"roi_align_{name}_bfloat16"])
    entry = times.pop("single")
    entry.update(times)
    return entry


def footprint(ops, rois, h, w):
    """Kernel D's adds per roi and channel on 7x7 bins, sr 2, as means over
    the rois: ``adds``, one for each nonzero corner weight of a y sample
    times one of an x sample (the form that adds every product to global
    memory), and ``pixels``, the distinct rows times distinct columns those
    land on (one add per pixel once a roi's footprint is reduced)."""
    r = rois.float() * (1 / 16) - 0.5
    x1, y1, x2, y2 = r.unbind(-1)
    per_axis = []
    for lo, length, size in ((y1, y2 - y1, h), (x1, x2 - x1, w)):
        i0, i1, w0, w1 = ops._axis_samples(lo, length, size, 7, 2)
        nz = torch.cat([w0, w1], 1) != 0
        hit = torch.zeros(rois.shape[0], size, dtype=torch.int32,
                          device=rois.device)
        hit.scatter_add_(1, torch.cat([i0, i1], 1), nz.int())
        per_axis.append((nz.sum(1), (hit > 0).sum(1)))
    (ey, dy), (ex, dx) = per_axis
    return dict(adds=(ey * ex).float().mean().item(),
                pixels=(dy * dx).float().mean().item())


def roi_grad_case(name, ops, plain_backward, maps_shape, rois, binds, g,
                  errs, dtypes=(torch.float32, torch.bfloat16),
                  time_plain=True):
    """Kernel D on one set of rois over zeroed maps of ``maps_shape``
    ([H, W, C] with ``binds`` None, or [B, H, W, C]): for each dtype one
    launch on the scatter7x2 body against torch autograd through the plain
    RoIAlign in f32, cast (f32 atol ROI_GRAD_F32_REL x max |grad|; bf16
    also rtol ROI_GRAD_BF16_RTOL), and against ``plain_backward`` (the
    explicit plain version) at the same tolerances unless it is None;
    errors into ``errs``. Then the bf16 times: the kernel, and with
    ``time_plain`` the plain version (autograd where ``plain_backward`` is
    None) in the turns plain, kernel, kernel, plain and autograd alone; the
    kernel's device time from a CUDA graph (``graph_ms``); the bound from
    the shapes and the footprint. Returns the times' entry."""
    n, c = rois.shape[0], maps_shape[-1]
    backward = ops.roi_align_backward
    f = torch.zeros(maps_shape, device=rois.device, requires_grad=True)
    out = ops.roi_align(f, rois, 1 / 16, batch_inds=binds, impl="plain")
    for dtype in dtypes:
        grad_out = torch.randn((n, 7, 7, c), generator=g).to(rois.device,
                                                             dtype)

        def autograd():
            return torch.autograd.grad(out, f, grad_out.float(),
                                       retain_graph=True)[0].to(dtype)

        def kernel():
            return backward(grad_out, rois, binds, maps_shape, 1 / 16)

        def plain():
            return plain_backward(grad_out, rois, binds, maps_shape, 1 / 16)

        n_body = backward.body_launches["scatter7x2"]
        got = kernel()
        if backward.body_launches["scatter7x2"] != n_body + 1:
            raise AssertionError(f"roi_align_backward {name}: not the "
                                 "scatter7x2 body")
        want = autograd()
        atol = ROI_GRAD_F32_REL * want.float().abs().max().item()
        rtol = 0.0 if dtype == torch.float32 else ROI_GRAD_BF16_RTOL
        check_close(f"roi_align_backward {name}", got, want, rtol, atol)
        tag = f"roi_align_backward_{name}_{str(dtype)[6:]}"
        errs[tag] = max_err(got, want)
        errs[tag + "_max_abs_grad"] = want.float().abs().max().item()
        if plain_backward is not None:
            p = plain()
            check_close(f"roi_align_backward {name} vs plain", got, p, rtol,
                        atol)
            errs[tag + "_vs_plain"] = max_err(got, p)
    entry = dict(max_abs_err=errs[tag])
    if time_plain:
        entry["ms"], entry["plain_ms"], _ = compare_times(
            kernel, autograd if plain_backward is None else plain)
        entry["autograd_ms"] = timed(autograd)
    else:
        entry["ms"] = timed(kernel)
    entry["graph_ms"] = graph_ms(kernel)
    full = maps_shape if len(maps_shape) == 4 else (1,) + tuple(maps_shape)
    nbytes, flops, atomics = roi_align_backward_cost(
        *full, n, grad_out.element_size(),
        0 if binds is None else binds.element_size())
    bound_ms, bound_by = bound(nbytes, flops, F32_FLOP_PER_S)
    entry.update(bound_ms=bound_ms, bound_by=bound_by,
                 share_of_bound=bound_ms / entry["ms"], library_ms=None,
                 library_note=NO_LIBRARY_ROI_ALIGN, bytes=nbytes, flops=flops,
                 atomic_adds=atomics, maps=full[0], rois=n,
                 per_roi_and_channel=footprint(ops, rois, *full[1:3]))
    return entry


def dcn_inputs(dev, dtype, g, c, h, w, std=2.5, push=True):
    """DCN operands at one stage shape: x [3, c, h, w], offsets of N(0,
    std^2) px (at 2.5 many beyond 2 px, samples beyond the edges), with
    ``push`` every 50th pushed beyond the map, masks in (0, 1)."""
    n, gr = DCN_FRAMES, DCN_GROUPS
    x = torch.randn(n, c, h, w, generator=g).to(dev, dtype)
    off = torch.randn(n, gr * 18, h, w, generator=g) * std
    if push:
        off.view(-1)[::50] += float(h + w)
    mask = torch.rand(n, gr * 9, h, w, generator=g)
    return x, off.to(dev), mask.to(dev)


def dcn_check(ops, tag, x, off, mask, g, errs):
    """One case of kernels E, F and G: E's columns against
    ``deform_columns_plain`` (exact) and the whole forward against
    ``modulated_deform_conv_plain`` (DCN_REL x max |out|); F and G against
    ``modulated_deform_conv_backward_plain`` and torch autograd through the
    plain columns (DCN_REL x max |grad|; x's bf16 gradient also rtol
    DCN_BF16_RTOL); errors into ``errs`` under ``tag``. Returns the
    columns' gradient it used."""
    dev, c = x.device, x.shape[1]
    cols = ops.deform_columns(x, off, mask)
    want = ops.deform_columns_plain(x, off, mask)
    check_close(f"{tag} columns", cols, want, 0.0, 0.0)
    errs[f"{tag}_columns"] = max_err(cols, want)
    wt = (torch.randn(c, c, 3, 3, generator=g) / (3 * c ** 0.5)).to(dev)
    bias = torch.randn(c, generator=g).to(dev)
    got = ops.modulated_deform_conv(x, off, mask, wt, bias)
    ref = ops.modulated_deform_conv_plain(x, off, mask, wt, bias)
    check_close(f"{tag} forward", got, ref, 0.0,
                DCN_REL * ref.abs().max().item())
    errs[f"{tag}_forward"] = max_err(got, ref)
    del got, ref, want
    grad_cols = torch.randn(cols.shape, generator=g).to(dev)
    del cols
    got = ops.modulated_deform_conv_backward(grad_cols, x, off, mask)
    plain = ops.modulated_deform_conv_backward_plain(grad_cols, x, off, mask)
    xf = x.detach().float().requires_grad_()
    o, m = off.clone().requires_grad_(), mask.clone().requires_grad_()
    auto = torch.autograd.grad(ops.deform_columns_plain(xf, o, m),
                               (xf, o, m), grad_cols)
    del xf, o, m
    for part, k, p_, a in zip(("x", "offset", "mask"), got, plain, auto):
        atol = DCN_REL * a.abs().max().item()
        rtol = DCN_BF16_RTOL if k.dtype == torch.bfloat16 else 0.0
        check_close(f"{tag} grad {part}", k, p_, rtol, atol)
        check_close(f"{tag} grad {part} vs autograd", k, a.to(k.dtype), rtol,
                    atol)
        errs[f"{tag}_grad_{part}"] = max_err(k, a.to(k.dtype))
        errs[f"{tag}_grad_{part}_vs_plain"] = max_err(k, p_)
    return grad_cols


def dcn_kernels(dev, g, ops, errs):
    """Kernels E, F and G at each of DCN_SHAPES and each offset scale of
    DCN_OFFSETS, f32 and bf16 x, through ``dcn_check``. Then at bf16 x, as
    the aggregator's training gives it: each at every offset scale eagerly
    and from a CUDA graph; at the scale that pushes offsets beyond the map
    (drawn from ``g``; the other scales from their own generators)
    each beside its plain version in the turns plain, kernel, kernel, plain
    (F's and G's plain version is the one plain backward that gives both);
    each with the bound. Returns {E, F, G:
    stage 0's entry with the other stages under their names, each stage's
    entry with the times at every scale under ``offsets``}."""
    out = {k: {} for k in "EFG"}
    for name, c, h, w in DCN_SHAPES:
        for scale, std, push in DCN_OFFSETS:
            gen = g if push else torch.Generator().manual_seed(int(10 * std))
            for dtype in (torch.float32, torch.bfloat16):
                tag = (f"dcn_{name}" + ("" if push else f"_{scale}")
                       + f"_{str(dtype)[6:]}")
                x, off, mask = dcn_inputs(dev, dtype, gen, c, h, w, std, push)
                grad_cols = dcn_check(ops, tag, x, off, mask, gen, errs)
            runs = dict(
                E=(lambda: ops.deform_columns(x, off, mask),
                   lambda: ops.deform_columns_plain(x, off, mask)),
                F=(lambda: ops.deform_col2im(grad_cols, x, off, mask),
                   lambda: ops.modulated_deform_conv_backward_plain(
                       grad_cols, x, off, mask)),
                G=(lambda: ops.deform_col2im_coord(grad_cols, x, off, mask),
                   lambda: ops.modulated_deform_conv_backward_plain(
                       grad_cols, x, off, mask)))
            errs_of = dict(E=f"{tag}_columns", F=f"{tag}_grad_x",
                           G=f"{tag}_grad_offset")
            for kern, (kernel, plain) in runs.items():
                nbytes, flops = dcn_cost(kern, DCN_FRAMES, c, h, w,
                                         DCN_GROUPS, x.element_size())
                bound_ms, bound_by = bound(nbytes, flops, F32_FLOP_PER_S)
                if push:
                    ms, plain_ms, _ = compare_times(kernel, plain)
                else:
                    ms, plain_ms = timed(kernel), None
                gms = graph_ms(kernel)
                entry = out[kern].setdefault(name, dict(offsets={}))
                entry["offsets"][scale] = dict(
                    ms=ms, graph_ms=gms, share_of_bound=bound_ms / ms,
                    graph_share_of_bound=bound_ms / gms)
                if push:
                    entry.update(
                        max_abs_err=errs[errs_of[kern]], ms=ms, graph_ms=gms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, share_of_bound=bound_ms / ms,
                        graph_share_of_bound=bound_ms / gms, library_ms=None,
                        library_note=NO_LIBRARY_DCN, bytes=nbytes,
                        flops=flops, shape=[DCN_FRAMES, c, h, w],
                        groups=DCN_GROUPS, offset_std=std)
                    if kern != "E":
                        entry["plain_note"] = (
                            "the plain backward computes F's and G's "
                            "outputs together")
            del x, off, mask, grad_cols
    for kern, entries in out.items():
        first = entries.pop("stage0")
        first.update(entries)
        out[kern] = first
    return out


def train_rois(dev, S):
    """The rois of the ``train`` phase's first step, rebuilt as
    ``tools/train_profile.py`` stages it: the seeded full-width model, the
    sample ``train_sample(cfg, dev, seed=2)`` and step 0's generator of
    ``train_model(..., seed=0)``. Returns (key rois [256, 4], reference
    boxes [600, 4], their map indices, the map shape, padded counts)."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.train import (
        step_generators)
    from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (  # noqa: E501
        rpn_head as rpn)
    from lowlightenvironmentvideoobjectdetection_torch.models.roi_heads import (  # noqa: E501
        bbox_head as bh)
    from lowlightenvironmentvideoobjectdetection_torch.tools.train_profile import (  # noqa: E501
        train_sample)
    cfg = S.SelsaConfig()
    model = seeded_model(S, cfg, dev)
    anchors = S.make_anchors(cfg, dev)
    sample = train_sample(cfg, dev, seed=2)
    u = S.draw_loss_uniforms(cfg, sample.gt_boxes.shape[0],
                             step_generators(0, 0, 1)[0], dev)
    with torch.no_grad():
        neck = model.extract_feat(sample.imgs)
        cls, reg = model.rpn_forward(neck)
        key = rpn.rpn_proposals(cls[0], reg[0], anchors, sample.img_shape,
                                nms_pre=cfg.train_nms_pre,
                                nms_post=cfg.train_nms_post,
                                iou_threshold=cfg.rpn_nms_iou)
        refs = rpn.rpn_proposals(cls[1:], reg[1:], anchors,
                                 sample.img_shape.expand(2, 2),
                                 nms_pre=cfg.test_nms_pre,
                                 nms_post=cfg.test_nms_post,
                                 iou_threshold=cfg.rpn_nms_iou)
        tgts = bh.bbox_targets(key.boxes, key.valid, sample.gt_boxes,
                               sample.gt_labels, sample.gt_valid, u.roi,
                               num_classes=cfg.num_classes,
                               num_samples=cfg.num_roi_samples)
    key_rois = tgts.rois.float().contiguous()
    ref_rois = refs.boxes.reshape(-1, 4).float().contiguous()
    binds = torch.arange(2, device=dev).repeat_interleave(cfg.test_nms_post)

    def zero_area(r):
        return int(((r[:, 2] <= r[:, 0]) | (r[:, 3] <= r[:, 1])).sum())

    padded = dict(key_not_sampled=int((tgts.label_weights == 0).sum()),
                  key_zero_area=zero_area(key_rois),
                  refs_invalid=int((~refs.valid).sum()),
                  refs_zero_area=zero_area(ref_rois))
    shape = tuple(neck.shape[1:])
    del model, neck, cls, reg
    return key_rois, ref_rois, binds, shape, padded


def roi_grad_kernels(dev, g, ops, plain_backward, S, errs, smi):
    """Kernel D: at each of ROI_GRAD_SHAPES on ``test_rois``, on the
    training step's own rois (``train_rois``) and over the footprint sweep
    ROI_GRAD_SWEEP (bf16, the kernel's time only), each through
    ``roi_grad_case``; prints the sweep's line. Returns the reference maps'
    entry with the others under their names."""
    times = {}
    for name, n_maps, n_rois in ROI_GRAD_SHAPES:
        rois = test_rois(dev, n_rois, 38, 64, g)
        binds = (None if n_maps == 1 else  # the key map: no indices
                 torch.arange(n_maps, device=dev).repeat_interleave(
                     n_rois // n_maps))
        shape = (38, 64, 512) if n_maps == 1 else (n_maps, 38, 64, 512)
        times[name] = roi_grad_case(name, ops, plain_backward, shape, rois,
                                    binds, g, errs)
    key_rois, ref_rois, binds, (h, w, c), padded = train_rois(dev, S)
    times["train_key_rois"] = roi_grad_case(
        "train_key_rois", ops, plain_backward, (h, w, c), key_rois, None, g,
        errs)
    times["train_refs_rois"] = roi_grad_case(
        "train_refs_rois", ops, plain_backward, (2, h, w, c), ref_rois, binds,
        g, errs)
    sweep = {}
    binds = torch.arange(2, device=dev).repeat_interleave(
        ROI_GRAD_SWEEP_N // 2)
    for name, size, stacked in ROI_GRAD_SWEEP:
        x1 = torch.rand(ROI_GRAD_SWEEP_N, generator=g) * (w * 16 - size)
        y1 = torch.rand(ROI_GRAD_SWEEP_N, generator=g) * (h * 16 - size)
        if stacked:
            x1, y1 = x1[:1].expand_as(x1), y1[:1].expand_as(y1)
        rois = torch.stack([x1, y1, x1 + size, y1 + size], 1).to(dev)
        sweep[name] = roi_grad_case(
            f"sweep_{name}", ops, plain_backward, (2, h, w, c), rois, binds,
            g, errs, dtypes=(torch.bfloat16,), time_plain=False)
    phase("kernel_d_sweep", card=smi, rois=ROI_GRAD_SWEEP_N, maps=2,
          ms={k: v["ms"] for k, v in sweep.items()},
          graph_ms={k: v["graph_ms"] for k, v in sweep.items()},
          per_roi_and_channel={k: v["per_roi_and_channel"]
                               for k, v in sweep.items()},
          train_rois_ms={k: times[k]["ms"] for k in ("train_key_rois",
                                                     "train_refs_rois")},
          train_rois_graph_ms={k: times[k]["graph_ms"]
                               for k in ("train_key_rois",
                                         "train_refs_rois")},
          train_rois_padded=padded)
    entry = times.pop("train_refs")
    entry.update(times, sweep=sweep, train_rois_padded=padded)
    return entry


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


def batched_attention_inputs(dev, dtype, g, n_streams):
    """Kernel A's operands for S streams, each as ``attention_inputs``."""
    parts = [attention_inputs(dev, dtype, g) for _ in range(n_streams)]
    return tuple(torch.stack(x) for x in zip(*parts))


def reset_counts(*kernels):
    for k in kernels:
        k.launches = 0
        for body in getattr(k, "body_launches", {}):
            k.body_launches[body] = 0


def roi_inputs(dev, dtype, g, n_maps, n_rois):
    """Kernel B's operands as the main path gives them: [B, 38, 64, 512]
    maps, ``test_rois`` rois in map order and int64 map indices, 300 a
    map."""
    maps = torch.randn(n_maps, 38, 64, 512, generator=g).to(dev, dtype)
    binds = torch.arange(n_maps, device=dev).repeat_interleave(
        n_rois // n_maps)
    return maps, test_rois(dev, n_rois, 38, 64, g), binds


def add_bodies(entry, launches):
    """Add launches per body (a kernel's ``body_launches``) to
    ``entry["body_launches"]``."""
    total = entry.setdefault("body_launches", {})
    for body, n in launches.items():
        total[body] = total.get(body, 0) + n


def check_bodies(name, kernel, **want):
    """The kernel's launches per body since its last reset are ``want``."""
    if kernel.body_launches != want:
        raise AssertionError(f"{name}: launches per body "
                             f"{kernel.body_launches}, want {want}")


def check_mma_layout(dev, attention):
    """A known answer for the tensor-core body before any timing: one-hot
    q (score 20 on key i % 64 of an identity-like K, 0 elsewhere) picks
    V's rows, so a wrong fragment layout shows as a permuted output. Returns
    the max abs error against those rows."""
    eye = torch.eye(64, device=dev)
    n, m1, m2 = 96, 64, 64
    q = (160 * eye[torch.arange(n, device=dev) % 64])[:, None]
    q = q.expand(n, 2, 64).to(torch.bfloat16).contiguous()
    k = eye.expand(2, 64, 64).to(torch.bfloat16).contiguous()
    v = torch.randn(2, m1 + m2, 64, generator=torch.Generator().manual_seed(7)
                    ).to(dev, torch.bfloat16)
    v1, v2 = v[:, :m1].contiguous(), v[:, m1:].contiguous()
    b = torch.zeros(64, device=dev)
    got = attention(q, k, v1, k, v2, b, b)
    rows = torch.arange(n, device=dev) % 64
    want = ((v1.float() + v2.float()) / 2)[:, rows].transpose(0, 1)
    err = max_err(got, want)
    if err > ATTN_ATOL:
        raise AssertionError(f"mma layout: one-hot attention off by {err}")
    return err


def match_sets(got, want):
    """Detections of one frame (DetResult) as sets: every valid row of
    ``want`` needs a row of ``got`` with its label, box within SET_BOX_TOL
    and score within SET_SCORE_TOL. Returns the counts, the rows of want
    left unmatched, the largest differences among matched rows, and for
    unmatched rows the nearest same-label row in units of the tolerances."""
    def rows(d):
        v = d.valid.cpu().numpy()
        return list(zip(d.labels.cpu().numpy()[v],
                        d.boxes.float().cpu().numpy()[v],
                        d.scores.float().cpu().numpy()[v]))
    grows, wrows = rows(got), rows(want)
    out = dict(n_got=len(grows), n_want=len(wrows), unmatched=0, box=0.0,
               score=0.0, nearest_unmatched=0.0)
    for lab, box, score in wrows:
        dist = [(max(np.abs(b - box).max() / SET_BOX_TOL,
                     abs(sc - score) / SET_SCORE_TOL), i)
                for i, (lb, b, sc) in enumerate(grows) if lb == lab]
        hit = min(dist, default=(np.inf, -1))
        if hit[0] >= 1.0:
            out["unmatched"] += 1
            out["nearest_unmatched"] = max(out["nearest_unmatched"],
                                           float(hit[0]))
            continue
        _, b, sc = grows.pop(hit[1])
        out["box"] = max(out["box"], float(np.abs(b - box).max()))
        out["score"] = max(out["score"], float(abs(sc - score)))
    return out


def serve(dev, smi, init_model, S, kernels, label="serve", **cfg_kwargs):
    """Full-width SELSA R50-DC5 at the default config (bf16; ``cfg_kwargs``
    change it), SERVE_S streams: memos from each stream's own 14 reference
    frames, two clips of SERVE_T frames through ``make_serve_step`` (the
    first warms up), then SERVE_STEPS per-frame steps that roll the memo.
    Each batched step launches kernel A once per shared FC, on the
    tensor-core body. Prints the phase ``label``. Returns the model, the
    streams' memos, the final batched memo, one more prepared frame and
    its image shape."""
    from lowlightenvironmentvideoobjectdetection_torch.data.preprocess import (
        prepare_frames)
    from lowlightenvironmentvideoobjectdetection_torch.parallel.serve import (
        make_serve_step)
    model = init_model("SELSA", seed=0, device=dev, **cfg_kwargs)
    m, cfg, anchors = model.model, model.cfg, model.anchors
    rng = np.random.RandomState(1)
    refs = rng.randint(0, 256, (SERVE_S, cfg.num_ref_frames) + RAW_HW + (3,)
                       ).astype(np.uint8)
    raw = rng.randint(0, 256, (SERVE_S, SERVE_T + SERVE_STEPS + 1) + RAW_HW
                      + (3,)).astype(np.uint8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    t = time.perf_counter()
    memos = []
    for s in range(SERVE_S):
        imgs, shape, _ = prepare_frames(refs[s], cfg.pad_h, cfg.pad_w,
                                        device=dev)
        memos.append(S.init_video_state(m, imgs, shape, anchors))
    states = S.stack_video_states(memos)
    torch.cuda.synchronize()
    fill_ms = (time.perf_counter() - t) * 1e3
    prepared = [prepare_frames(raw[s], cfg.pad_h, cfg.pad_w, device=dev)
                for s in range(SERVE_S)]
    frames = torch.stack([p[0] for p in prepared])  # [S, T', H, W, 3]
    shapes = torch.stack([p[1] for p in prepared])
    sfs = torch.as_tensor(np.stack([p[2] for p in prepared]), device=dev)
    step, _ = make_serve_step(m)
    clip_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        states, dets = step(anchors, states, frames[:, :SERVE_T], shapes, sfs)
        torch.cuda.synchronize()
        clip_ms.append((time.perf_counter() - t) * 1e3)
    fstep, _ = make_serve_step(m, clip=False, update_memo=True)
    step_ms = []
    for i in range(SERVE_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        states, fdets = fstep(anchors, states, frames[:, SERVE_T + i], shapes,
                              sfs)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    counts = [k.launches for k in kernels]
    peak = torch.cuda.max_memory_allocated()
    n_steps = 2 * SERVE_T + SERVE_STEPS
    n_attn = cfg.num_shared_fcs * n_steps
    if counts != [n_attn, SERVE_S + n_steps, 0]:
        raise AssertionError(f"{label}: launch counts (A, B, C) {counts} for "
                             f"{n_steps} batched steps of {SERVE_S} streams")
    check_bodies(f"{label} attention", kernels[0], fma=0, mma=n_attn)
    check_bodies(f"{label} roi_align", kernels[1],
                 gather7x2=SERVE_S + n_steps, gather14x2=0)
    for d, lead in ((dets, (SERVE_S, SERVE_T)), (fdets, (SERVE_S,))):
        if (d.boxes.shape != lead + (100, 4) or d.scores.shape != lead + (100,)
                or d.labels.shape != lead + (100,)
                or d.valid.shape != lead + (100,)
                or not torch.isfinite(d.boxes).all()
                or not torch.isfinite(d.scores).all()):
            raise AssertionError(f"{label}: bad DetResult")
    if states.next_slot.tolist() != [SERVE_STEPS % cfg.num_ref_frames] * SERVE_S:
        raise AssertionError(f"{label}: memo slots "
                             f"{states.next_slot.tolist()}")
    for k, v in states.ref_kv:
        if not (torch.isfinite(k).all() and torch.isfinite(v).all()):
            raise AssertionError(f"{label}: non-finite memo")
    med = statistics.median(step_ms)
    phase(label, card=smi, streams=SERVE_S, frames_per_clip=SERVE_T,
          memo_fill_ms=fill_ms, warmup_clip_ms=clip_ms[0],
          clip_ms=clip_ms[1], clip_frames_per_s=SERVE_S * SERVE_T
          / (clip_ms[1] / 1e3), clip_ms_per_batched_step=clip_ms[1] / SERVE_T,
          step_ms=step_ms, median_step_ms=med,
          step_frames_per_s=SERVE_S / (med / 1e3), peak_mem_gb=peak / 2**30,
          launches=dict(attention=counts[0], roi_align=counts[1],
                        attention_1slab=counts[2]),
          attention_launches_per_body=dict(kernels[0].body_launches),
          batched_steps=n_steps,
          detections_per_frame=dets.valid.sum(-1).tolist())
    return model, memos, states, frames[0, -1], shapes[0]


def serve_agree(m32, dev, g, S, attention):
    """f32, TF32 off, AGREE_S streams of AGREE_T frames with the memo rolled
    on every second frame: the batched kernel path against the batched
    plain path (proposals identical, head outputs and memo within
    AGREE_TOL), and each stream of ``inference_clip_batch`` against that
    stream alone through ``inference_clip`` (detections equal as sets).
    Every kernel-A launch takes the CUDA-core (fma) body."""
    from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (  # noqa: E501
        rpn_head as rpn)
    model, anchors, cfg = m32.model, m32.anchors, m32.cfg
    hw = (cfg.pad_h, cfg.pad_w, 3)
    ref_imgs = torch.randn((AGREE_S, cfg.num_ref_frames) + hw,
                           generator=g).to(dev)
    frames = torch.randn((AGREE_S, AGREE_T) + hw, generator=g).to(dev)
    shapes = torch.tensor([[cfg.pad_h, cfg.pad_w],
                           [cfg.pad_h - 8, cfg.pad_w - 24]],
                          dtype=torch.float32, device=dev)
    sfs = torch.tensor([[1.0] * 4, [0.5] * 4], device=dev)
    memos = [S.init_video_state(model, ref_imgs[s], shapes[s], anchors)
             for s in range(AGREE_S)]
    del ref_imgs
    st_k, st_p = S.stack_video_states(memos), S.stack_video_states(memos)
    reset_counts(attention)
    props_equal, cls_err, reg_err, failures = [], 0.0, 0.0, []
    for t in range(AGREE_T):
        hk = S.stream_head_batch(model, st_k, frames[:, t], shapes, anchors)
        hp = S.stream_head_batch(model, st_p, frames[:, t], shapes, anchors,
                                 impl="plain")
        props_equal.append(
            torch.equal(hk.proposals.boxes, hp.proposals.boxes)
            and torch.equal(hk.proposals.valid, hp.proposals.valid))
        for name, a, b in (("cls_score", hk.cls_score, hp.cls_score),
                           ("bbox_pred", hk.bbox_pred, hp.bbox_pred)):
            try:
                check_close(f"serve_agree {name}", a, b, AGREE_TOL, AGREE_TOL)
            except AssertionError as e:
                failures.append(str(e))
        cls_err = max(cls_err, max_err(hk.cls_score, hp.cls_score))
        reg_err = max(reg_err, max_err(hk.bbox_pred, hp.bbox_pred))
        if t % 2 == 0:
            st_k = S.roll_memo(st_k, hk.cur_kvs, hk.proposals.valid)
            st_p = S.roll_memo(st_p, hp.cur_kvs, hp.proposals.valid)
    memo_err = max(max_err(a, b) for (ka, va), (kb, vb)
                   in zip(st_k.ref_kv, st_p.ref_kv) for a, b in ((ka, kb),
                                                                 (va, vb)))
    del st_k, st_p, hk, hp

    # each stream of the batch against that stream alone
    _, bdets = S.inference_clip_batch(
        model, S.stack_video_states(memos), frames, shapes, sfs, anchors,
        update_memo=True, frame_stride=2)
    sets, props_alone = [], []
    for s in range(AGREE_S):
        _, odets = S.inference_clip(model, memos[s], frames[s], shapes[s],
                                    sfs[s], anchors, update_memo=True,
                                    frame_stride=2)
        for t in range(AGREE_T):
            sets.append(match_sets(type(odets)(*(f[t] for f in odets)),
                                   type(bdets)(*(f[s, t] for f in bdets))))
    for t in range(AGREE_T):  # the proposals of both batch sizes
        neck = model.extract_feat(frames[:, t])
        pb = rpn.rpn_proposals(*model.rpn_forward(neck), anchors, shapes,
                               nms_pre=cfg.test_nms_pre,
                               nms_post=cfg.test_nms_post,
                               iou_threshold=cfg.rpn_nms_iou)
        for s in range(AGREE_S):
            neck = model.extract_feat(frames[s, t][None])
            cls, reg = model.rpn_forward(neck)
            po = rpn.rpn_proposals(cls[0], reg[0], anchors, shapes[s],
                                   nms_pre=cfg.test_nms_pre,
                                   nms_post=cfg.test_nms_post,
                                   iou_threshold=cfg.rpn_nms_iou)
            props_alone.append(dict(
                valid_equal=torch.equal(po.valid, pb.valid[s]),
                box_err=max_err(po.boxes, pb.boxes[s])))
    unmatched = sum(x["unmatched"] for x in sets)
    check_bodies("serve_agree attention", attention, mma=0,
                 fma=attention.launches)
    phase("serve_agree", streams=AGREE_S, frames=AGREE_T,
          attention_launches_per_body=dict(attention.body_launches),
          proposals_equal=props_equal, cls_score_max_abs_err=cls_err,
          bbox_pred_max_abs_err=reg_err, memo_max_abs_err=memo_err,
          rtol_atol=AGREE_TOL, alone_vs_batch_sets=sets,
          alone_vs_batch_proposals=props_alone,
          set_tolerances=dict(box_px=SET_BOX_TOL, score=SET_SCORE_TOL))
    if failures:
        raise AssertionError("\n".join(failures))
    if not all(props_equal):
        raise AssertionError("serve_agree: proposals differ between the "
                             "kernel and the plain path")
    if memo_err > AGREE_TOL:
        raise AssertionError(f"serve_agree: memo differs by {memo_err}")
    if unmatched or any(x["n_got"] != x["n_want"] for x in sets):
        raise AssertionError("serve_agree: a stream of the batch differs "
                             "from the stream alone")


def single_slab(model, memo, frame, shape, kernels):
    """Kernel C on a path: one more frame against one stream's full-width
    memo, the two SELSA stages built from the head's public methods with
    ``attend_cached`` (kernel C) over the concatenated memo and current
    K/V, against ``forward_cached_stream_kv`` (kernel A). Returns the
    launch counts (A, B, C) of that path."""
    import torch.nn.functional as F

    from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (  # noqa: E501
        rpn_head as rpn)
    attention = kernels[0]
    m, cfg, head = model.model, model.cfg, model.model.bbox_head
    reset_counts(*kernels)
    with torch.no_grad():
        neck = m.extract_feat(frame[None])
        cls, reg = m.rpn_forward(neck)
        props = rpn.rpn_proposals(cls[0], reg[0], model.anchors, shape,
                                  nms_pre=cfg.test_nms_pre,
                                  nms_post=cfg.test_nms_post,
                                  iou_threshold=cfg.rpn_nms_iou)
        rfeats = m.roi_feats(neck[0], props.boxes)
        ref_kvs = tuple((k.flatten(1, 2), v.flatten(1, 2))
                        for k, v in memo.ref_kv)  # [nb, R*P, hd]
        ref_mask = memo.ref_valid.reshape(-1)
        (want_cls, want_reg), _ = head.forward_cached_stream_kv(
            rfeats, ref_kvs, ref_mask, props.valid)
        n_a = attention.launches
        mask = torch.cat([ref_mask, props.valid])
        x, r = rfeats.flatten(-3), None
        for i in range(head.num_shared_fcs):
            fc, agg = getattr(head, f"shared_fc{i}"), getattr(head,
                                                              f"aggregator{i}")
            xf = fc(x)
            cur = xf if i == 0 else fc(r)
            r = F.relu(cur)
            ck, cv = agg.project_kv_hm(cur)
            mk, mv = ref_kvs[i]
            k = torch.cat([mk, ck.to(mk.dtype)], 1)
            v = torch.cat([mv, cv.to(mv.dtype)], 1)
            x = F.relu(xf + agg.attend_cached(agg.project_q(xf), k, v, mask))
        got_cls, got_reg = head.fc_cls(x), head.fc_reg(x)
        torch.cuda.synchronize()
    counts = [k.launches for k in kernels]
    phase("single_slab", cls_score_max_abs_err=max_err(got_cls, want_cls),
          bbox_pred_max_abs_err=max_err(got_reg, want_reg),
          rtol_atol=AGREE_TOL, launches=dict(
              attention=counts[0], roi_align=counts[1],
              attention_1slab=counts[2]),
          valid_rois=int(props.valid.sum()), memo_keys=int(k.shape[1]))
    if counts != [2, 1, 2] or n_a != 2:
        raise AssertionError(f"single_slab: launch counts (A, B, C) {counts}")
    check_bodies("single_slab attention", attention, fma=0, mma=2)
    check_bodies("single_slab attention_1slab", kernels[2], fma=0, mma=2)
    check_bodies("single_slab roi_align", kernels[1], gather7x2=1,
                 gather14x2=0)
    check_close("single_slab cls_score", got_cls, want_cls, AGREE_TOL,
                AGREE_TOL)
    check_close("single_slab bbox_pred", got_reg, want_reg, AGREE_TOL,
                AGREE_TOL)
    return counts


def seeded_model(S, cfg, dev):
    model = S.SelsaDetector(cfg)
    S.init_params(model, torch.Generator().manual_seed(0))
    return model.to(dev)


def train_steps(name, model, batch, loss_fn, kernels, frozen,
                per_step=(0, 2, 0, 2)):
    """TRAIN_WARMUP + TRAIN_STEPS steps of ``loss_fn(model, sample,
    generator)`` on ``batch`` (one sample, a batch of 1) through
    ``train_model``. Checks ``per_step`` launches a step of each of
    ``kernels`` (A, B, C, D and, with the aggregator, E, F, G; by default
    two of kernel B, on the 7x7 gather body, and of kernel D, on
    scatter7x2, and none of A and C), the step count and finite metrics,
    that the parameters under the ``frozen`` prefixes stayed bit-identical
    and that the others moved (but ZERO_GRAD biases). Returns the run: the
    launch counts, B's and D's launches per body, the step ms, each step's
    metrics, the peak memory in GiB and the names of the frozen and of the
    unchanged parameters."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.train import (
        train_model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    stamps, metrics = [], []

    def on_step(state, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        metrics.append(m)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    t0 = time.perf_counter()
    state = train_model(loss_fn, model, [batch] * n_steps, n_steps, seed=0,
                        log_interval=n_steps + 1, on_step=on_step)
    run = dict(counts=[k.launches for k in kernels],
               bodies=dict(roi_align=dict(kernels[1].body_launches),
                           roi_align_backward=dict(kernels[3].body_launches)),
               step_ms=[(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)],
               metrics=metrics,
               peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    if run["counts"] != [p * n_steps for p in per_step]:
        raise AssertionError(f"{name}: launch counts {run['counts']} for "
                             f"{n_steps} steps, want {per_step} a step")
    check_bodies(f"{name} roi_align", kernels[1],
                 gather7x2=per_step[1] * n_steps, gather14x2=0)
    check_bodies(f"{name} roi_align_backward", kernels[3],
                 scatter7x2=per_step[3] * n_steps, scatter14x2=0)
    if state.step != n_steps or not all(
            np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"{name}: step {state.step}, metrics {metrics}")
    run["frozen"], run["unchanged"] = [], []
    for n, p in model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        if n.startswith(frozen):
            run["frozen"].append(n)
            if not same:
                raise AssertionError(f"{name}: frozen {n} changed")
        elif same:
            run["unchanged"].append(n)
    if not run["frozen"] or any(not n.endswith(ZERO_GRAD)
                                for n in run["unchanged"]):
        raise AssertionError(f"{name}: {len(run['frozen'])} frozen; "
                             f"unchanged {run['unchanged']}")
    return run


def train(dev, smi, S, kernels):
    """Full-width SELSA R50-DC5 training at the JAX training default (the
    default ``SelsaConfig``: bf16 compute, f32 parameters, 608x1024, 30
    classes, key proposals 6000 -> 600, reference proposals 2000 -> 300,
    256 sampled rois; SGD lr 0.01 with the mmcv warmup, momentum 0.9,
    masked decay 1e-4, clip 35) through ``train_steps``; times the key
    frame's proposal NMS alone. Returns the launch counts (attention A,
    RoIAlign B, attention C, RoIAlign D)."""
    from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (  # noqa: E501
        rpn_head as rpn)
    from lowlightenvironmentvideoobjectdetection_torch.tools.train_profile import (  # noqa: E501
        train_sample)
    cfg = S.SelsaConfig()
    model = seeded_model(S, cfg, dev)
    anchors = S.make_anchors(cfg, dev)
    sample = train_sample(cfg, dev, seed=2)
    batch = type(sample)(*(f[None] for f in sample))

    def loss_fn(m, smp, generator):
        return S.selsa_loss(m, smp, anchors, generator=generator)

    run = train_steps("train", model, batch, loss_fn, kernels, FROZEN)
    # the key frame's proposal NMS (k = 6000) and the references' alone
    with torch.no_grad():
        cls, reg = model.rpn_forward(model.extract_feat(sample.imgs))
        nms_ms = {}
        for name, c, r, shape, pre, post in (
                ("key", cls[0], reg[0], sample.img_shape, cfg.train_nms_pre,
                 cfg.train_nms_post),
                ("refs", cls[1:], reg[1:], sample.img_shape.expand(2, 2),
                 cfg.test_nms_pre, cfg.test_nms_post)):
            runs = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                rpn.rpn_proposals(c, r, anchors, shape, nms_pre=pre,
                                  nms_post=post, iou_threshold=cfg.rpn_nms_iou)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t) * 1e3)
            nms_ms[name] = statistics.median(runs)
    counts = run["counts"]
    med = statistics.median(run["step_ms"][TRAIN_WARMUP:])
    phase("train", card=smi, steps=len(run["step_ms"]),
          warmup_steps=TRAIN_WARMUP,
          loss_per_step=[m["loss"] for m in run["metrics"]],
          step_ms=run["step_ms"], median_step_ms=med,
          steps_per_s=1e3 / med, peak_mem_gb=run["peak_gb"],
          key_nms_ms=nms_ms["key"], refs_nms_ms=nms_ms["refs"],
          key_nms_share=nms_ms["key"] / med, launches=dict(
              attention=counts[0], roi_align=counts[1],
              attention_1slab=counts[2], roi_align_backward=counts[3]),
          frozen_params=len(run["frozen"]),
          unchanged_params=run["unchanged"])
    del model
    return counts


def grad_agreement(gk, gp):
    """(worst error over tolerance, its leaf) of the gradients ``gk``
    against ``gp``, at train_agree's tolerances."""
    if set(gk) != set(gp):
        raise AssertionError("different leaves have gradients")
    floor = TRAIN_GRAD_FLOOR * max(g.abs().max().item() for g in gp.values())
    worst, worst_leaf = 0.0, None
    for n, want in gp.items():
        ratio = max_err(gk[n], want) / max(
            TRAIN_GRAD_REL * want.abs().max().item(), floor)
        if ratio > worst:
            worst, worst_leaf = ratio, n
    return worst, worst_leaf


def train_agree(dev, S, roi_align, roi_align_backward):
    """f32, TF32 off: one loss and every parameter's gradient at full width
    through kernels B and D and through the plain RoIAlign (``impl=
    "plain"``), with the same uniforms. The loss within TRAIN_LOSS_RTOL;
    each leaf within TRAIN_GRAD_REL of its max |grad|, at least
    TRAIN_GRAD_FLOOR of the largest of any leaf."""
    from lowlightenvironmentvideoobjectdetection_torch.tools.train_profile import (  # noqa: E501
        train_sample)
    cfg = S.SelsaConfig(compute_dtype=torch.float32)
    model = seeded_model(S, cfg, dev)
    anchors = S.make_anchors(cfg, dev)
    sample = train_sample(cfg, dev, seed=3)
    uniforms = S.draw_loss_uniforms(cfg, 8, torch.Generator().manual_seed(3),
                                    dev)

    def run(impl):
        model.zero_grad(set_to_none=True)
        loss, _ = S.selsa_loss(model, sample, anchors, uniforms=uniforms,
                               impl=impl)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters() if p.grad is not None}

    reset_counts(roi_align, roi_align_backward)
    lk, gk = run(None)
    if (roi_align.launches, roi_align_backward.launches) != (2, 2):
        raise AssertionError("train_agree: kernel path launches "
                             f"{roi_align.launches}, "
                             f"{roi_align_backward.launches}")
    lp, gp = run("plain")
    worst, worst_leaf = grad_agreement(gk, gp)
    loss_rel = abs(lk - lp) / abs(lp)
    phase("train_agree", loss_kernel=lk, loss_plain=lp, loss_rel_err=loss_rel,
          loss_rtol=TRAIN_LOSS_RTOL, leaves=len(gp),
          worst_grad_err_over_tol=worst, worst_leaf=worst_leaf,
          grad_tolerance=dict(rel_to_leaf_max=TRAIN_GRAD_REL,
                              floor_rel_to_global_max=TRAIN_GRAD_FLOOR))
    if loss_rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"train_agree: loss {lk} against {lp}")
    if worst > 1.0:
        raise AssertionError(f"train_agree: gradient of {worst_leaf} off by "
                             f"{worst} tolerances")


class TopKPin:
    """Stands in for TemporalRoIAlign's ``top_k`` (in the module
    ``temporal_roi_align``) inside a ``with`` block, for the agree phases:
    records each call's indices; given ``pinned`` (another run's recorded
    indices, call by call) it returns the values at those indices instead
    of its own choice and counts the rows where its own choice differs. Such
    a top-k flip is a near-tie that the two paths' roundings order
    differently: it moves a RoI pixel's gathered features by the distance
    between two map pixels, which no rounding tolerance covers."""

    def __init__(self, module, pinned=None):
        self.module, self.orig = module, module.top_k
        self.pinned, self.indices, self.flips = pinned, [], 0

    def __enter__(self):
        self.module.top_k = self
        return self

    def __exit__(self, *exc):
        self.module.top_k = self.orig

    def __call__(self, x, k):
        vals, idx = self.orig(x, k)
        self.indices.append(idx)
        if self.pinned is None:
            return vals, idx
        want = self.pinned[len(self.indices) - 1]
        self.flips += int((idx.sort(1).values != want.sort(1).values)
                          .any(1).sum())
        return x.gather(1, want), want


def darkfarm_train(dev, smi, kernels):
    """The paper's distillation at full width: ``darkfarm_loss`` at the
    canonical low-light config without its aggregator (``DARKFARM`` of
    ``tools/train_profile.py``: 8 classes, stages (0, 1, 2, 3, 3), L1
    feature loss, TemporalRoIAlign, 3 shared FCs; bf16 compute, f32
    parameters, 608x1024) on one sample of a key and 2 reference (noise,
    clean) pairs of 6 channels with 8 gts, through ``train_steps`` as the
    ``train`` phase, the whole cleaner among the frozen parameters; then
    DARKFARM_STAGED staged steps (``staged_step``: the cleaner's forward,
    the feature loss and TemporalRoIAlign among the stages). Returns the
    launch counts (A, B, C, D) of the ``train_steps`` run and B's and D's
    launches per body there."""
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        selsa_darkfarm as D)
    from lowlightenvironmentvideoobjectdetection_torch.parallel.train import (
        make_optimizer)
    from lowlightenvironmentvideoobjectdetection_torch.tools.train_profile import (  # noqa: E501
        DARKFARM, darkfarm_sample, staged_step)
    model, anchors = D.make_darkfarm(
        DARKFARM, torch.Generator().manual_seed(0), device=dev)
    sample = darkfarm_sample(DARKFARM, dev, seed=2)
    batch = type(sample)(*(f[None] for f in sample))

    def loss_fn(m, smp, generator):
        return D.darkfarm_loss(m, smp, anchors, generator=generator)

    run = train_steps("darkfarm_train", model, batch, loss_fn, kernels,
                      DARKFARM_FROZEN)
    n_cleaner = sum(n.startswith("cleaner.") for n in run["frozen"])
    if not n_cleaner:
        raise AssertionError("darkfarm_train: no cleaner parameters")

    # host-clock stages (synchronised after each), the teacher's among them
    opt = make_optimizer(model)
    opt_state = opt.init(dict(model.named_parameters()))
    gen = torch.Generator().manual_seed(5)
    stages = {}
    for _ in range(DARKFARM_STAGED):
        opt_state, times = staged_step(model, opt, opt_state, sample, anchors,
                                       gen)
        for k, v in times.items():
            stages.setdefault(k, []).append(v)
    stage_ms = {k: statistics.median(v) for k, v in stages.items()}
    timed_ms = run["step_ms"][TRAIN_WARMUP:]
    med = statistics.median(timed_ms)
    q = statistics.quantiles(timed_ms, n=4)
    counts = run["counts"]
    phase("darkfarm_train", card=smi, steps=len(run["step_ms"]),
          warmup_steps=TRAIN_WARMUP,
          loss_per_step=[m["loss"] for m in run["metrics"]],
          last_step_metrics=run["metrics"][-1], step_ms=run["step_ms"],
          median_step_ms=med, step_ms_min_max=[min(timed_ms), max(timed_ms)],
          step_ms_quartiles=[q[0], q[2]], steps_per_s=1e3 / med,
          peak_mem_gb=run["peak_gb"], staged_steps=DARKFARM_STAGED,
          stage_ms=stage_ms,
          cleaner_forward_ms=stage_ms["cleaner forward (teacher)"],
          feature_loss_ms=stage_ms["feature loss"],
          troi_ms=stage_ms["TemporalRoIAlign (2 maps)"],
          launches=dict(attention=counts[0], roi_align=counts[1],
                        attention_1slab=counts[2],
                        roi_align_backward=counts[3]),
          frozen_params=len(run["frozen"]), cleaner_params=n_cleaner,
          unchanged_params=run["unchanged"])
    del model
    return counts, run["bodies"]


def darkfarm_agree(dev, roi_align, roi_align_backward):
    """f32, TF32 off: one ``darkfarm_loss`` at the ``darkfarm_train``
    config and every parameter's gradient through kernels B and D and
    through the plain RoIAlign, with the same uniforms, at train_agree's
    tolerances. TemporalRoIAlign's top-k choices of both runs are compared
    (``troi_topk_flips``); where any differ, the plain run is repeated with
    the kernel run's choices pinned (``TopKPin``) and that run is held to
    the tolerances, the unpinned one reported."""
    import dataclasses

    from lowlightenvironmentvideoobjectdetection_torch.models.roi_heads import (  # noqa: E501
        temporal_roi_align as troi)
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        selsa as S, selsa_darkfarm as D)
    from lowlightenvironmentvideoobjectdetection_torch.tools.train_profile import (  # noqa: E501
        DARKFARM, darkfarm_sample)
    cfg = dataclasses.replace(DARKFARM, selsa=dataclasses.replace(
        DARKFARM.selsa, compute_dtype=torch.float32))
    model, anchors = D.make_darkfarm(cfg, torch.Generator().manual_seed(0),
                                     device=dev)
    sample = darkfarm_sample(cfg, dev, seed=3)
    uniforms = S.draw_loss_uniforms(cfg.selsa, 8,
                                    torch.Generator().manual_seed(3), dev)

    def run(impl, pinned=None):
        model.zero_grad(set_to_none=True)
        with TopKPin(troi, pinned) as pin:
            loss, _ = D.darkfarm_loss(model, sample, anchors,
                                      uniforms=uniforms, impl=impl)
            loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters()
                             if p.grad is not None}, pin

    reset_counts(roi_align, roi_align_backward)
    lk, gk, pk = run(None)
    if (roi_align.launches, roi_align_backward.launches) != (2, 2):
        raise AssertionError("darkfarm_agree: kernel path launches "
                             f"{roi_align.launches}, "
                             f"{roi_align_backward.launches}")
    lp, gp, _ = run("plain")
    unpinned = dict(loss_rel_err=abs(lk - lp) / abs(lp))
    unpinned["worst_grad_err_over_tol"], unpinned["worst_leaf"] = \
        grad_agreement(gk, gp)
    lq, gq, probe = run("plain", pinned=pk.indices)
    flips = probe.flips
    if flips:  # hold the run with the kernel path's choices
        lp, gp = lq, gq
    del gq
    worst, worst_leaf = grad_agreement(gk, gp)
    loss_rel = abs(lk - lp) / abs(lp)
    phase("darkfarm_agree", loss_kernel=lk, loss_plain=lp,
          loss_rel_err=loss_rel, loss_rtol=TRAIN_LOSS_RTOL, leaves=len(gp),
          worst_grad_err_over_tol=worst, worst_leaf=worst_leaf,
          troi_topk_flips=flips, troi_topk_rows=sum(
              i.shape[0] for i in pk.indices),
          held_with=("the kernel run's top-k choices" if flips
                     else "each run's own top-k choices"),
          unpinned=unpinned,
          grad_tolerance=dict(rel_to_leaf_max=TRAIN_GRAD_REL,
                              floor_rel_to_global_max=TRAIN_GRAD_FLOOR))
    if loss_rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"darkfarm_agree: loss {lk} against {lp}")
    if worst > 1.0:
        raise AssertionError(f"darkfarm_agree: gradient of {worst_leaf} off "
                             f"by {worst} tolerances")


def agg_train(dev, smi, kernels):
    """The canonical config at full width: ``darkfarm_loss`` at
    ``AGGREGATOR`` of ``tools/train_profile.py`` (``SelsaNewDarkfarmDetect``:
    8 classes, stages (0, 1, 2, 3, 3), L1 feature losses on the undenoised
    and the denoised stages, the Denoising2Aggregator with RDBs and TAF,
    TemporalRoIAlign, 3 shared FCs; bf16 compute, f32 parameters, 608x1024)
    on one sample of a key and 2 reference pairs of 6 channels with 8 gts,
    through ``train_steps``: per step 2 launches of B and D and 12 of E, F
    and G (the TAF's 3 DCN calls at each of 4 stages; the forward keeps
    its columns), the teacher and the frozen stages bit-identical, every
    ``aggregator.`` leaf changed but ZERO_GRAD; then DARKFARM_STAGED staged
    steps, the aggregator's forward among the stages. Returns the launch
    counts (A-G) of the ``train_steps`` run and B's and D's launches per
    body there."""
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        selsa_darkfarm as D)
    from lowlightenvironmentvideoobjectdetection_torch.parallel.train import (
        make_optimizer)
    from lowlightenvironmentvideoobjectdetection_torch.tools.train_profile import (  # noqa: E501
        AGGREGATOR, darkfarm_sample, staged_step)
    model, anchors = D.make_darkfarm(
        AGGREGATOR, torch.Generator().manual_seed(0), device=dev)
    sample = darkfarm_sample(AGGREGATOR, dev, seed=2)
    batch = type(sample)(*(f[None] for f in sample))

    def loss_fn(m, smp, generator):
        return D.darkfarm_loss(m, smp, anchors, generator=generator)

    # one DCN call per frame of the sample (key + 2 references) and TAF stage
    n_dcn = sample.pair_imgs.shape[0] * len(AGGREGATOR.loss_stages)
    run = train_steps("agg_train", model, batch, loss_fn, kernels,
                      DARKFARM_FROZEN, per_step=(0, 2, 0, 2) + (n_dcn,) * 3)
    agg = [n for n, _ in model.named_parameters()
           if n.startswith("aggregator.")]
    stuck = [n for n in run["unchanged"] if n.startswith("aggregator.")]
    if not agg or any(not n.endswith(ZERO_GRAD) for n in stuck):
        raise AssertionError(f"agg_train: {len(agg)} aggregator leaves, "
                             f"unchanged {stuck}")
    keys = set(run["metrics"][-1])
    if not {f"loss_l1_{i}_{t}" for i in range(len(AGGREGATOR.loss_stages))
            for t in "ud"} <= keys:
        raise AssertionError(f"agg_train: metrics {sorted(keys)}")

    opt = make_optimizer(model)
    opt_state = opt.init(dict(model.named_parameters()))
    gen = torch.Generator().manual_seed(5)
    stages = {}
    for _ in range(DARKFARM_STAGED):
        opt_state, times = staged_step(model, opt, opt_state, sample, anchors,
                                       gen)
        for k, v in times.items():
            stages.setdefault(k, []).append(v)
    stage_ms = {k: statistics.median(v) for k, v in stages.items()}
    timed_ms = run["step_ms"][TRAIN_WARMUP:]
    med = statistics.median(timed_ms)
    q = statistics.quantiles(timed_ms, n=4)
    counts = run["counts"]
    phase("agg_train", card=smi, steps=len(run["step_ms"]),
          warmup_steps=TRAIN_WARMUP,
          loss_per_step=[m["loss"] for m in run["metrics"]],
          last_step_metrics=run["metrics"][-1], step_ms=run["step_ms"],
          median_step_ms=med, step_ms_min_max=[min(timed_ms), max(timed_ms)],
          step_ms_quartiles=[q[0], q[2]], steps_per_s=1e3 / med,
          peak_mem_gb=run["peak_gb"], staged_steps=DARKFARM_STAGED,
          stage_ms=stage_ms,
          aggregator_forward_ms=stage_ms["aggregator forward"],
          launches=dict(zip(("attention", "roi_align", "attention_1slab",
                             "roi_align_backward", "dcn_im2col",
                             "dcn_col2im", "dcn_col2im_coord"), counts)),
          frozen_params=len(run["frozen"]), aggregator_params=len(agg),
          aggregator_numel=sum(p.numel() for n, p in model.named_parameters()
                               if n.startswith("aggregator.")),
          unchanged_params=run["unchanged"])
    del model
    return counts, run["bodies"]


class OffsetProbe:
    """Forward hooks on every ``ModulatedDCNPack``'s ``conv_offset`` inside
    a ``with`` block: records the offsets' (the first 18 of each group's 27
    channels) min, max and std per call, and the share of sample positions
    outside the map."""

    def __init__(self, model):
        from lowlightenvironmentvideoobjectdetection_torch.models.aggregators.denoising_aggregator import (  # noqa: E501
            ModulatedDCNPack)
        self.packs = [m for m in model.modules()
                      if isinstance(m, ModulatedDCNPack)]
        self.stats, self.handles = [], []

    def hook(self, i, pack):
        def record(_, __, om):
            t, _, h, w = om.shape
            off = om.detach().float().reshape(t, pack.groups, 27, h, w)[
                :, :, :18]
            ys = torch.arange(h, device=om.device).view(h, 1).float()
            xs = torch.arange(w, device=om.device).view(1, w).float()
            sy = off[:, :, :9] + ys
            sx = off[:, :, 9:] + xs
            outside = ((sy < -1) | (sy > h) | (sx < -1) | (sx > w)).float()
            self.stats.append(dict(pack=i, min=off.min().item(),
                                   max=off.max().item(), std=off.std().item(),
                                   outside=outside.mean().item()))
        return record

    def __enter__(self):
        self.stats = []
        self.handles = [p.conv_offset.register_forward_hook(self.hook(i, p))
                        for i, p in enumerate(self.packs)]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def agg_agree(dev, kernels):
    """f32, TF32 off: one ``darkfarm_loss`` at the ``agg_train`` config and
    every parameter's gradient through the kernels (B, D and the DCN's E, F,
    G) and through the plain versions (``impl="plain"``: RoIAlign and the
    DCN), with the same uniforms, at train_agree's tolerances. Each
    ``conv_offset`` is perturbed first (a seeded normal, rescaled so the
    offsets' std is AGG_OFFSET_STD px; the zero init puts every sample on a
    pixel), so most offsets are fractional within a few px and some
    samples lie beyond the map; their range is printed. TemporalRoIAlign's
    top-k choices are pinned as in ``darkfarm_agree``."""
    import dataclasses

    from lowlightenvironmentvideoobjectdetection_torch.models.roi_heads import (  # noqa: E501
        temporal_roi_align as troi)
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        selsa as S, selsa_darkfarm as D)
    from lowlightenvironmentvideoobjectdetection_torch.tools.train_profile import (  # noqa: E501
        AGGREGATOR, darkfarm_sample)
    cfg = dataclasses.replace(AGGREGATOR, selsa=dataclasses.replace(
        AGGREGATOR.selsa, compute_dtype=torch.float32))
    model, anchors = D.make_darkfarm(cfg, torch.Generator().manual_seed(0),
                                     device=dev)
    sample = darkfarm_sample(cfg, dev, seed=3)
    uniforms = S.draw_loss_uniforms(cfg.selsa, 8,
                                    torch.Generator().manual_seed(3), dev)
    probe = OffsetProbe(model)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in probe.packs:
            w = p.conv_offset.weight
            w.copy_(torch.randn(w.shape, generator=gen).to(dev))
        with probe:  # the offsets' std at this scale, pack by pack
            D.darkfarm_loss(model, sample, anchors, uniforms=uniforms)
        for i, p in enumerate(probe.packs):
            std = statistics.mean(st["std"] for st in probe.stats
                                  if st["pack"] == i)
            p.conv_offset.weight.mul_(AGG_OFFSET_STD / std)

    def run(impl, pinned=None):
        model.zero_grad(set_to_none=True)
        with TopKPin(troi, pinned) as pin, probe:
            loss, _ = D.darkfarm_loss(model, sample, anchors,
                                      uniforms=uniforms, impl=impl)
            loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters()
                             if p.grad is not None}, pin

    reset_counts(*kernels)
    lk, gk, pk = run(None)
    offsets = list(probe.stats)
    counts = [k.launches for k in kernels]
    n_dcn = sample.pair_imgs.shape[0] * len(cfg.loss_stages)
    if counts != [2, 2] + [n_dcn] * 3:
        raise AssertionError(f"agg_agree: kernel path launches (B, D, E, F, "
                             f"G) {counts}")
    lp, gp, _ = run("plain")
    unpinned = dict(loss_rel_err=abs(lk - lp) / abs(lp))
    unpinned["worst_grad_err_over_tol"], unpinned["worst_leaf"] = \
        grad_agreement(gk, gp)
    lq, gq, probe_pin = run("plain", pinned=pk.indices)
    flips = probe_pin.flips
    if flips:  # hold the run with the kernel path's choices
        lp, gp = lq, gq
    del gq
    worst, worst_leaf = grad_agreement(gk, gp)
    loss_rel = abs(lk - lp) / abs(lp)
    agg_worst, agg_leaf = grad_agreement(
        {n: g for n, g in gk.items() if n.startswith("aggregator.")},
        {n: g for n, g in gp.items() if n.startswith("aggregator.")})
    phase("agg_agree", loss_kernel=lk, loss_plain=lp, loss_rel_err=loss_rel,
          loss_rtol=TRAIN_LOSS_RTOL, leaves=len(gp),
          worst_grad_err_over_tol=worst, worst_leaf=worst_leaf,
          aggregator_worst_grad_err_over_tol=agg_worst,
          aggregator_worst_leaf=agg_leaf,
          offsets=dict(min=min(st["min"] for st in offsets),
                       max=max(st["max"] for st in offsets),
                       std_per_call=[st["std"] for st in offsets],
                       outside_share_per_call=[st["outside"]
                                               for st in offsets]),
          troi_topk_flips=flips, troi_topk_rows=sum(
              i.shape[0] for i in pk.indices),
          held_with=("the kernel run's top-k choices" if flips
                     else "each run's own top-k choices"),
          unpinned=unpinned,
          grad_tolerance=dict(rel_to_leaf_max=TRAIN_GRAD_REL,
                              floor_rel_to_global_max=TRAIN_GRAD_FLOOR))
    if loss_rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"agg_agree: loss {lk} against {lp}")
    if worst > 1.0:
        raise AssertionError(f"agg_agree: gradient of {worst_leaf} off by "
                             f"{worst} tolerances")
    del model


# ---- the data path: a config file and PNG frames to the canonical step

def _tensors(results, prefix=""):
    """(path, tensor) of every tensor in a pipeline's results."""
    if isinstance(results, torch.Tensor):
        return [(prefix, results)]
    if isinstance(results, dict):
        items = results.items()
    elif isinstance(results, (list, tuple)):
        items = enumerate(results)
    else:
        return []
    return [pt for k, v in items for pt in _tensors(v, f"{prefix}/{k}")]


def compare_results(name, card, cpu, float_tol):
    """Every tensor of ``card`` against ``cpu``'s: integer and bool ones
    equal, float ones to ``float_tol`` x their largest |value|. Returns the
    largest float error over the largest |value| (0 if none differ)."""
    a, b = _tensors(card), _tensors(cpu)
    if [p for p, _ in a] != [p for p, _ in b]:
        raise AssertionError(f"{name}: results differ in structure")
    worst = 0.0
    for (path, x), (_, y) in zip(a, b):
        x = x.cpu()
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{name}{path}: {x.shape} {x.dtype} against "
                                 f"{y.shape} {y.dtype}")
        if not x.is_floating_point():
            if not torch.equal(x, y):
                raise AssertionError(f"{name}{path}: card and CPU differ")
            continue
        scale = float(y.abs().max()) if y.numel() else 0.0
        err = max_err(x, y) / scale if scale else max_err(x, y)
        if err > float_tol:
            raise AssertionError(f"{name}{path}: card and CPU differ by "
                                 f"{err} of the largest value")
        worst = max(worst, err)
    return worst


class StepWindow:
    """``on_step`` for the CLI: a synchronised host stamp after each step,
    and ``torch.profiler`` over the steps after the first ``skip`` (the
    loader's next batch included), which gives the device's busy ms and
    idle share over that window. The profiler's host overhead slows those
    steps: time steps before them."""

    DEVICE = torch.autograd.DeviceType.CUDA

    def __init__(self, n_steps, skip):
        self.n, self.skip = n_steps, skip
        self.stamps, self.prof, self.t0, self.window = [], None, 0.0, None

    def __call__(self, state, metrics):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        done = len(self.stamps)
        if done == self.skip:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        elif done == self.n and self.prof is not None:
            wall = (time.perf_counter() - self.t0) * 1e3
            self.prof.__exit__(None, None, None)
            from lowlightenvironmentvideoobjectdetection_torch.tools.stage_profile import (  # noqa: E501
                union_ms)
            dev = [e for e in self.prof.events()
                   if e.device_type == self.DEVICE]
            if not dev:
                raise RuntimeError("the profiler recorded no device events")
            busy = union_ms([(e.time_range.start, e.time_range.end)
                             for e in dev])
            steps = self.n - self.skip
            self.window = dict(steps=steps, busy_ms_per_step=busy / steps,
                               wall_ms_per_step=wall / steps,
                               idle_share=1.0 - busy / wall)
            self.prof = None


def cli_run(name, argv, kernels, per_step, n_steps, skip):
    """The port's CLI (``tools/train.py::main``) on ``argv`` + ``--steps
    n_steps``, on the card, with every launch count reset just before:
    checks ``per_step`` launches a step of each of ``kernels`` (A-G), B's
    7x7 gather and D's 7x7 scatter bodies, the step count and finite
    metrics. Returns the run: counts, bodies, step ms, metrics, the
    loader's timings, the profiled window and the peak memory in GiB."""
    from lowlightenvironmentvideoobjectdetection_torch.tools import (
        train as cli)
    window = StepWindow(n_steps, skip)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    t0 = time.perf_counter()
    out = cli.main(list(argv) + ["--steps", str(n_steps)], on_step=window)
    run = dict(counts=[k.launches for k in kernels],
               bodies=dict(roi_align=dict(kernels[1].body_launches),
                           roi_align_backward=dict(kernels[3].body_launches)),
               step_ms=[(b - a) * 1e3 for a, b in
                        zip([t0] + window.stamps, window.stamps)],
               metrics=out["metrics"], timings=out["timings"],
               window=window.window,
               peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    if run["counts"] != [p * n_steps for p in per_step]:
        raise AssertionError(f"{name}: launch counts {run['counts']} for "
                             f"{n_steps} steps, want {per_step} a step")
    check_bodies(f"{name} roi_align", kernels[1],
                 gather7x2=per_step[1] * n_steps, gather14x2=0)
    check_bodies(f"{name} roi_align_backward", kernels[3],
                 scatter7x2=per_step[3] * n_steps, scatter14x2=0)
    if out["state"].step != n_steps or len(run["metrics"]) != n_steps or \
            not all(np.isfinite(v) for m in run["metrics"]
                    for v in m.values()):
        raise AssertionError(f"{name}: step {out['state'].step}, metrics "
                             f"{run['metrics']}")
    del out
    torch.cuda.empty_cache()
    return run


def loader_summary(timings, skip):
    """Medians over the batches after the first ``skip`` (the workers'
    start-up): the worker's host ms, the main process's wait and its
    device stages' launch ms."""
    rows = timings[skip:]
    return {k: statistics.median(r[k] for r in rows)
            for k in ("host_ms", "wait_ms", "device_ms")}


def data_options(root, ann, workers):
    return ["--cfg-options", f"data.train.ann_file={ann}",
            f"data.train.img_prefix={root}/",
            f"data.workers_per_gpu={workers}"]


def batch_twice(dev, cfg_path, root, ann):
    """One sample of ``cfg_path``'s pipeline from the tree: the host stages
    once, then each device stage on the card and on the CPU from the same
    frames and draws, compared after each stage (``compare_results``:
    uint8 and integer results equal, float ones to DATA_FLOAT_TOL), and the
    padded batch. Returns the per-stage card ms (synchronised), the same
    stages' CPU ms, the host stages' ms, each stage's float error and the
    host sample (frames and generator) for the noise phase."""
    import copy
    from lowlightenvironmentvideoobjectdetection_torch.config import (
        Config, apply_cli_options)
    from lowlightenvironmentvideoobjectdetection_torch.data import loader
    from lowlightenvironmentvideoobjectdetection_torch.data.pipelines import (
        to_device)
    from lowlightenvironmentvideoobjectdetection_torch.models.builder import (
        model_config)
    cfg = Config.fromfile(cfg_path)
    apply_cli_options(cfg, data_options(root, ann, 0)[1:])
    dcfg = cfg["data"]["train"]
    mcfg = model_config(cfg["model"])
    card = loader.Compose(dcfg["pipeline"], device=dev)
    host = loader.HostClips(loader.build_dataset(dcfg), card, seed=0)
    item = host[(0, 0)]
    sides = {side: [to_device(copy.deepcopy(item["frames"]), d),
                    copy.deepcopy(item["rng"])]
             for side, d in (("card", dev), ("cpu", torch.device("cpu")))}
    card_ms, cpu_ms, errs = {}, {}, {}
    for i, step in enumerate(card.device_steps):
        name = f"{i}:{type(step).__name__}"
        for side, times in (("card", card_ms), ("cpu", cpu_ms)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            sides[side][0] = step(*sides[side])
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t) * 1e3
        errs[name] = compare_results(f"batch_twice {name}",
                                     sides["card"][0], sides["cpu"][0],
                                     DATA_FLOAT_TOL)
    batches = {side: loader.make_batch(loader.pad_batch(
        s[0], mcfg.selsa.pad_h, mcfg.selsa.pad_w), mcfg.in_channels)
        for side, s in sides.items()}
    errs["batch"] = compare_results("batch_twice batch", batches["card"],
                                    batches["cpu"], DATA_FLOAT_TOL)
    return dict(card_ms=card_ms, cpu_ms=cpu_ms, host_ms=item["host_ms"],
                float_err=errs, item=item,
                batch_shape=list(batches["card"].pair_imgs.shape))


def png_decode_ms(root):
    """Host ms to decode one frame of the tree as written (filter None) and
    re-encoded with the Paeth filter on every row (as libpng's adaptive
    filtering often picks), the median of 3 each."""
    import glob
    from lowlightenvironmentvideoobjectdetection_torch.data import image_io
    path = sorted(glob.glob(f"{root}/*/GT/*.png"))[0]
    paeth = f"{root}/paeth.png"
    image_io.imwrite_png(paeth, image_io.imread(path), filters=4, level=1)
    out = {}
    for name, p in (("none", path), ("paeth", paeth)):
        ts = []
        for _ in range(3):
            t = time.perf_counter()
            image_io.imread(p)
            ts.append((time.perf_counter() - t) * 1e3)
        out[name] = statistics.median(ts)
    return out


def data_train(dev, smi, kernels, root):
    """The canonical config from a config file and PNG frames on disk:
    writes a DarkFarm-layout tree under ``root`` (DATA_TREE: 2 videos of 10
    frame pairs at 1080x1920, DarkFarm's size, with the port's PNG writer;
    dark noisy frames beside bright clean ``GT/`` frames, 1-8 boxes of the
    8 classes, a COCO-VID annotation file), then runs the port's CLI on
    ``llvod_l1234_fusion_add_i1234_rdb_taf_darkfarm.py`` with
    ``--cfg-options`` pointing ``data.train`` at it, ``--steps 6 --seed
    0``, DATA_WORKERS loader processes, on the card: per step 2 launches of
    B and D and 12 of E, F and G, finite losses with ``loss_l1_{0..3}_{u,d}``,
    the step ms after the warm-up and before the last DATA_PROFILED steps,
    the device's idle share over those; then the same with the loader in
    the main process (``data.workers_per_gpu=0``); then ``batch_twice``.
    Returns the launch counts (A-G) of both runs, B's and D's bodies, and
    the host sample."""
    from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
        write_darkfarm_tree)
    t = time.perf_counter()
    ann = write_darkfarm_tree(root, **DATA_TREE)
    tree_s = time.perf_counter() - t
    cfg_path = str(REPO / CANONICAL_CFG)
    per_step = DATA_PER_STEP
    argv = [cfg_path, "--seed", "0", "--work-dir", f"{root}/work"]
    skip = DATA_STEPS - DATA_PROFILED
    run = cli_run("data_train", argv + data_options(root, ann, DATA_WORKERS),
                  kernels, per_step, DATA_STEPS, skip)
    keys = set(run["metrics"][-1])
    if not {f"loss_l1_{i}_{s}" for i in range(4) for s in "ud"} <= keys:
        raise AssertionError(f"data_train: metrics {sorted(keys)}")
    solo = cli_run("data_train without workers",
                   argv + data_options(root, ann, 0), kernels, per_step,
                   DATA_STEPS, skip)
    twice = batch_twice(dev, cfg_path, root, ann)

    def timed(r):
        return r["step_ms"][TRAIN_WARMUP:skip]

    phase("data_train", card=smi, config=CANONICAL_CFG, tree=DATA_TREE,
          tree_write_s=tree_s, steps=DATA_STEPS, warmup_steps=TRAIN_WARMUP,
          workers=DATA_WORKERS, step_ms=run["step_ms"],
          timed_steps=[TRAIN_WARMUP, skip],
          median_step_ms=statistics.median(timed(run)),
          loss_per_step=[m["loss"] for m in run["metrics"]],
          last_step_metrics=run["metrics"][-1],
          loader_ms_per_batch=run["timings"],
          loader_median_ms=loader_summary(run["timings"], TRAIN_WARMUP),
          device_window=run["window"], peak_mem_gb=run["peak_gb"],
          launches_per_step=dict(zip(KERNEL_NAMES, per_step)),
          no_workers=dict(step_ms=solo["step_ms"],
                          median_step_ms=statistics.median(timed(solo)),
                          loader_ms_per_batch=solo["timings"],
                          loader_median_ms=loader_summary(solo["timings"],
                                                          TRAIN_WARMUP),
                          device_window=solo["window"]),
          stages_card_ms=twice["card_ms"], stages_cpu_ms=twice["cpu_ms"],
          host_stages_ms=twice["host_ms"],
          png_decode_ms=png_decode_ms(root),
          card_vs_cpu_float_err=twice["float_err"],
          float_tol_rel_to_max=DATA_FLOAT_TOL,
          batch_shape=twice["batch_shape"])
    counts = [a + b for a, b in zip(run["counts"], solo["counts"])]
    bodies = {k: {b: run["bodies"][k].get(b, 0) + solo["bodies"][k].get(b, 0)
                  for b in run["bodies"][k]} for k in run["bodies"]}
    return counts, bodies, ann, twice["item"]


def a7s3_moments(clean, level):
    """The A7S3 model's mean and variance per channel for a constant clean
    value (``ops/noise.py``: k dsn (shot + dark + read), the streak dsn
    independent of the rest): E = am v + k n; Var = k^2 ((1 + s_b^2) Var S
    + s_b^2 E[S]^2) with S = shot + dark + read, E[S] = am v / k + n and
    Var S = am v / k + n + var_read x read_ratio."""
    from lowlightenvironmentvideoobjectdetection_torch.ops import noise as N
    c = N.A7S3
    out = []
    for ch in range(3):
        k = c["k"][ch] * level["k_ratio"]
        es = level["am"] * clean / k + c["n"][ch]
        var_s = es + c["var_read"][ch] * level["read_ratio"]
        sb2 = c["var_beta"][ch]
        out.append((k * es, k * k * ((1 + sb2) * var_s + sb2 * es * es),
                    k, es, var_s, sb2))
    return out


def noise_raw(dev, smi, kernels, root, ann, item):
    """The RAW and noise steps on full-size frames on the card, against
    the CPU with the same draws: ``SeqAddNoise`` ('a7s3') on the host
    sample's clean frames (the ``GT/`` halves, 1080x1920) with draws from
    a CPU generator passed to both (NOISE_RTOL), and ``SeqsRGB2RAW`` then
    ``SeqNormalizeRAW`` on the pairs with one camera matrix and gains
    passed to both (RAW_RTOL: the card's sin, asin and pow against the
    CPU's); the a7s3 noise drawn by the card's own generator on a constant
    frame, its mean and variance per channel against the model's formula
    (within MOMENT_SIGMAS standard errors); then RAW_STEPS steps of
    ``llvod_raw_darkfarm.py`` (8-channel RAW pairs) through the CLI, the
    loader in the main process: 2 launches of B and D a step, none of E,
    F, G. Returns the launch counts (A-G) and B's and D's bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.data.pipelines import (
        transforms as T)
    from lowlightenvironmentvideoobjectdetection_torch.ops import noise as N
    from lowlightenvironmentvideoobjectdetection_torch.ops import (
        unprocess as U)
    pairs = [torch.as_tensor(f["img"]) for f in item["frames"]]
    clean = [p[..., 3:].contiguous() for p in pairs]
    g = torch.Generator().manual_seed(7)
    add = T.SeqAddNoise(noise_type="a7s3", share_params=True)
    errs = {}
    for i, c in enumerate(clean):
        draws = N.a7s3_draws(c.float()[None], am=add.am, generator=g)
        got = add.apply(dict(img=c.to(dev), img_fields=["img"]),
                        **{k: v.to(dev) for k, v in draws.items()})
        want = add.apply(dict(img=c, img_fields=["img"]), **draws)
        errs[f"add_noise_{i}"] = compare_results(
            "noise_raw add_noise", got, want, NOISE_RTOL)
    ccm = U.random_ccm_gain(torch.Generator().manual_seed(8))
    raw = T.SeqSRGB2RAW(share_params=True)
    norm = T.SeqNormalizeRAW(mean=[0.25] * 4, std=[0.12] * 4)
    card_ccm = U.CcmGain(*(x.to(dev) for x in ccm))
    got = norm([raw.apply(dict(img=p.to(dev), img_fields=["img"]), card_ccm)
                for p in pairs])
    want = norm([raw.apply(dict(img=p, img_fields=["img"]), ccm)
                 for p in pairs])
    errs["srgb2raw_normalize"] = compare_results("noise_raw srgb2raw", got,
                                                 want, RAW_RTOL)
    if got[0]["img"].shape[-1] != 8:
        raise AssertionError("noise_raw: RAW pairs must have 8 channels")
    # moments of the card's own draws
    level = dict(am=0.8, k_ratio=200.0, read_ratio=30.0)
    t_, h, w = 3, 563, 1000
    flat = torch.full((t_, h, w, 3), MOMENT_CLEAN, device=dev)
    noise = N.real_camera_noise_a7s3(
        flat, **level, generator=torch.Generator(device=dev).manual_seed(9))
    n_pix, n_rows = t_ * h * w, t_ * h
    moments = []
    for ch, (mean, var, k, es, var_s, sb2) in enumerate(
            a7s3_moments(MOMENT_CLEAN, level)):
        x = noise[..., ch].double()
        m, v = float(x.mean()), float(x.var())
        # standard errors: pixel noise, and the streak shared along a row
        mean_se = k * np.sqrt(var_s / n_pix + sb2 * es * es / n_rows)
        var_se = var * np.sqrt(2.0 / n_pix + 4.0 * sb2 / n_rows)
        moments.append(dict(channel=ch, mean=m, mean_model=mean,
                            mean_se=mean_se, var=v, var_model=var,
                            var_se=var_se))
        if abs(m - mean) > MOMENT_SIGMAS * mean_se or \
                abs(v - var) > MOMENT_SIGMAS * var_se:
            raise AssertionError(f"noise_raw: a7s3 channel {ch} mean {m} "
                                 f"var {v}, model {mean} {var}")
    del noise, flat
    per_step = RAW_PER_STEP
    # the RAW config redefines train_pipeline but not data, so its
    # data.train.pipeline is the base's sRGB one (ROADMAP fault F9): name
    # its own pipeline on the command line
    from lowlightenvironmentvideoobjectdetection_torch.config import (
        load_config)
    raw_pipeline = load_config(str(REPO / RAW_CFG))["train_pipeline"]
    run = cli_run("noise_raw", [str(REPO / RAW_CFG), "--seed", "0",
                                "--work-dir", f"{root}/work_raw"]
                  + data_options(root, ann, 0)
                  + [f"data.train.pipeline={raw_pipeline!r}"],
                  kernels, per_step, RAW_STEPS, 1)
    phase("noise_raw", card=smi, card_vs_cpu_err_rel_to_max=errs,
          add_noise_rtol=NOISE_RTOL, raw_rtol=RAW_RTOL,
          a7s3_moments=moments, moment_clean=MOMENT_CLEAN,
          moment_sigmas=MOMENT_SIGMAS, raw_config=RAW_CFG,
          raw_steps=RAW_STEPS, raw_step_ms=run["step_ms"],
          raw_loss_per_step=[m["loss"] for m in run["metrics"]],
          raw_last_step_metrics=run["metrics"][-1],
          raw_loader_ms_per_batch=run["timings"],
          raw_peak_mem_gb=run["peak_gb"],
          launches_per_step=dict(zip(KERNEL_NAMES, per_step)))
    return run["counts"], run["bodies"]


def troi_cost(n_maps, h, w, c, n_rois, feat_bytes=2, k=2, out_size=7):
    """(bytes, FLOPs) of TemporalRoIAlign's most-similar RoI align over
    ``n_maps`` reference maps: the roi features and the maps read once, the
    f32 output [maps, N, 7, 7, C] written once; 2 FLOPs per multiply-add of
    the similarity (each RoI pixel against every map pixel) and of the
    weighted gather of k pixels."""
    q = n_rois * out_size * out_size
    nbytes = (feat_bytes * (q * c + n_maps * h * w * c)
              + 4 * n_maps * q * c)
    return nbytes, 2 * n_maps * q * c * (h * w + k)


def troi_stream(dev, smi, init_model, inference_vid, S, kernels, g):
    """Streaming with TemporalRoIAlign and 3 shared FCs (``TROI_CFG``,
    bf16): the memo of 14 reference frames, their neck maps among it, from
    ``inference_vid`` at frame 0, then STREAM_FRAMES more frames; TROI alone
    on one frame's proposals (host clock, synchronised; also its
    most-similar RoI align alone, and the similarity products alone) for
    its share of the step and its bound; SERVE_S streams through ``serve``
    (phase ``troi_serve``), memos from ``init_video_state`` stacked, whose
    per-frame steps roll the maps too. Each step launches kernel A three
    times (once per shared FC), on the tensor-core body, and kernel B once,
    on the 7x7 gather body. Then f32 (TF32 off): one frame through the
    kernel path and the plain path against a memo of 14 frames, top-k flips
    counted and pinned as in ``darkfarm_agree``. Returns the launch counts
    (A, B, C) of the bf16 runs and A's and B's launches per body there."""
    from lowlightenvironmentvideoobjectdetection_torch.data.preprocess import (
        prepare_frames)
    from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (  # noqa: E501
        rpn_head as rpn)
    from lowlightenvironmentvideoobjectdetection_torch.models.roi_heads import (  # noqa: E501
        temporal_roi_align as troi)
    attention, roi_align, attention1 = kernels
    model = init_model("SELSA", seed=0, device=dev, **TROI_CFG)
    m, cfg, anchors = model.model, model.cfg, model.anchors
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (STREAM_FRAMES + 1,) + RAW_HW + (3,)
                         ).astype(np.uint8)
    refs = rng.randint(0, 256, (cfg.num_ref_frames,) + RAW_HW + (3,)
                       ).astype(np.uint8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    lat = []
    for fid in range(STREAM_FRAMES + 1):
        t = time.perf_counter()
        out = inference_vid(model, frames[fid], fid,
                            ref_frames=refs if fid == 0 else None)
        lat.append((time.perf_counter() - t) * 1e3)
        res = out["bbox_results"]
        if len(res) != cfg.num_classes or any(
                r.ndim != 2 or r.shape[1] != 5 or not np.isfinite(r).all()
                for r in res):
            raise AssertionError("troi_stream: bad per-class results")
    peak = torch.cuda.max_memory_allocated()
    nframes = STREAM_FRAMES + 1
    counts = [k.launches for k in kernels]
    if counts != [3 * nframes, nframes + 1, 0]:
        raise AssertionError(f"troi_stream: launch counts (A, B, C) {counts} "
                             f"for {nframes} frames")
    check_bodies("troi_stream attention", attention, fma=0, mma=3 * nframes)
    check_bodies("troi_stream roi_align", roi_align, gather7x2=nframes + 1,
                 gather14x2=0)
    bodies = dict(attention=dict(attention.body_launches),
                  roi_align=dict(roi_align.body_launches))
    st = model.state
    h, w = cfg.feat_hw
    if (len(st.ref_kv) != 3 or st.ref_maps is None
            or st.ref_maps.shape != (cfg.num_ref_frames, h, w,
                                     cfg.neck_channels)
            or st.ref_maps.dtype != torch.bfloat16
            or not torch.isfinite(st.ref_maps).all()):
        raise AssertionError("troi_stream: bad memo")
    med = statistics.median(lat[1:])

    # TemporalRoIAlign alone on one frame's proposals against the memo
    with torch.no_grad():
        imgs, shape, _ = prepare_frames(frames[-1:], cfg.pad_h, cfg.pad_w,
                                        device=dev)
        neck = m.extract_feat(imgs)
        cls, reg = m.rpn_forward(neck)
        props = rpn.rpn_proposals(cls[0], reg[0], anchors, shape,
                                  nms_pre=cfg.test_nms_pre,
                                  nms_post=cfg.test_nms_post,
                                  iou_threshold=cfg.rpn_nms_iou)
        rf = m.roi_feats(neck[0], props.boxes)
        q = troi._l2_normalize(rf.float()).reshape(-1, rf.shape[-1])
        maps = st.ref_maps.float()

        def similarity():
            with troi._no_tf32():
                for ref in maps:
                    q @ troi._l2_normalize(ref.reshape(-1, q.shape[1])).T

        parts = dict(
            troi=lambda: m.troi(rf, st.ref_maps),
            most_similar=lambda: m.troi.most_similar_roi_align(rf.float(),
                                                               maps),
            similarity=similarity)
        part_ms = {}
        for name, fn in parts.items():
            runs = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t) * 1e3)
            part_ms[name] = statistics.median(runs)
    troi_ms = part_ms["troi"]
    nbytes, flops = troi_cost(cfg.num_ref_frames, h, w, cfg.neck_channels,
                              rf.shape[0], rf.element_size())
    troi_bound_ms, troi_bound_by = bound(nbytes, flops, F32_FLOP_PER_S)
    del model, st, neck, rf, q, maps

    # SERVE_S streams through make_serve_step, memos (maps included) from
    # init_video_state, stacked; the roll writes the maps of its slots
    _, memos, states, _, _ = serve(dev, smi, init_model, S, kernels,
                                   label="troi_serve", **TROI_CFG)
    serve_counts = [k.launches for k in kernels]
    rolled = [bool((states.ref_maps[s, :SERVE_STEPS]
                    != memos[s].ref_maps[:SERVE_STEPS]).any())
              for s in range(SERVE_S)]
    if not all(rolled) or not torch.equal(
            states.ref_maps[:, SERVE_STEPS:],
            torch.stack([mm.ref_maps[SERVE_STEPS:] for mm in memos])):
        raise AssertionError("troi_serve: the roll did not write the maps of "
                             "its slots alone")
    del memos, states
    for name, kern in (("attention", attention), ("roi_align", roi_align)):
        bodies[name] = {b: bodies[name][b] + c
                        for b, c in kern.body_launches.items()}
    counts = [a + b for a, b in zip(counts, serve_counts)]

    # f32 agreement, the kernel path against the plain path
    m32 = init_model("SELSA", seed=0, device=dev,
                     compute_dtype=torch.float32, **TROI_CFG)
    hw = (cfg.pad_h, cfg.pad_w, 3)
    ref_imgs = torch.randn((cfg.num_ref_frames,) + hw, generator=g).to(dev)
    frame = torch.randn(hw, generator=g).to(dev)
    shape = torch.tensor([float(cfg.pad_h), float(cfg.pad_w)], device=dev)
    state = S.init_video_state(m32.model, ref_imgs, shape, m32.anchors)
    reset_counts(attention)
    with TopKPin(troi) as pk:
        got = S.stream_head(m32.model, state, frame, shape, m32.anchors)
    check_bodies("troi_stream agree attention", attention, mma=0, fma=3)
    with TopKPin(troi, pk.indices) as probe:
        pinned = S.stream_head(m32.model, state, frame, shape, m32.anchors,
                               impl="plain")
    own = S.stream_head(m32.model, state, frame, shape, m32.anchors,
                        impl="plain")
    flips = probe.flips
    want = pinned if flips else own
    unpinned = dict(cls_score_max_abs_err=max_err(got.cls_score,
                                                  own.cls_score),
                    bbox_pred_max_abs_err=max_err(got.bbox_pred,
                                                  own.bbox_pred))
    if not torch.equal(got.proposals.boxes, want.proposals.boxes):
        raise AssertionError("troi_stream agree: proposals differ")
    errs = dict(cls_score_max_abs_err=max_err(got.cls_score, want.cls_score),
                bbox_pred_max_abs_err=max_err(got.bbox_pred, want.bbox_pred))
    del m32, state, ref_imgs
    phase("troi_stream", card=smi, frames=nframes, frame0_ms=lat[0],
          median_frame_ms=med, frames_per_s=1e3 / med, frame_ms=lat[1:],
          peak_mem_gb=peak / 2**30, troi_ms=troi_ms,
          troi_share_of_frame=troi_ms / med, troi_bound_ms=troi_bound_ms,
          troi_bound_by=troi_bound_by, troi_flops=flops, troi_bytes=nbytes,
          troi_most_similar_ms=part_ms["most_similar"],
          troi_similarity_ms=part_ms["similarity"],
          troi_rois=int(props.boxes.shape[0]),
          launches=dict(attention=counts[0], roi_align=counts[1],
                        attention_1slab=counts[2]),
          launches_per_body=bodies,
          agree=dict(rtol_atol=AGREE_TOL, troi_topk_flips=flips,
                     troi_topk_rows=sum(i.shape[0] for i in pk.indices),
                     held_with=("the kernel run's top-k choices" if flips
                                else "each run's own top-k choices"),
                     valid_rois=int(got.proposals.valid.sum()),
                     unpinned=unpinned, **errs))
    check_close("troi_stream agree cls_score", got.cls_score, want.cls_score,
                AGREE_TOL, AGREE_TOL)
    check_close("troi_stream agree bbox_pred", got.bbox_pred, want.bbox_pred,
                AGREE_TOL, AGREE_TOL)
    return counts, bodies


def build_checkout(root) -> Path:
    """Put the checkout at ROOT first on the import path, check that the
    port's package comes from there, build its kernels and print the
    ``build`` line; returns ROOT resolved."""
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    from lowlightenvironmentvideoobjectdetection_torch.ops import cuda_build
    if not Path(cuda_build.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {cuda_build.__file__}, not from {root}")
    t0 = time.perf_counter()
    cuda_build.build()
    phase("build", seconds=round(time.perf_counter() - t0, 3), root=str(root))
    return root


def roi_grad_times(root, dev, smi) -> int:
    """``--roi-grad-times ROOT``: kernel D's cases of the ``kernels`` phase
    alone (``roi_grad_kernels``), with the package of the checkout at ROOT,
    so that two commits compare in one call: unpack the earlier one with
    ``git archive`` and run both in the turns parent, change, change,
    parent. Prints the sweep's line and one JSON line of kernel D's
    entry."""
    root = build_checkout(root)
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        selsa as S)
    from lowlightenvironmentvideoobjectdetection_torch.ops import (
        roi_align as roi_ops)
    errs = {}
    # a checkout from before the explicit plain version compares with
    # autograd alone
    entry = roi_grad_kernels(dev, torch.Generator().manual_seed(0), roi_ops,
                             getattr(roi_ops, "roi_align_backward_plain",
                                     None), S, errs, smi)
    print(json.dumps(dict(root=str(root), roi_align_backward=entry,
                          max_abs_err=errs)), flush=True)
    return 0


def dcn_times(root, dev, smi) -> int:
    """``--dcn-times ROOT``: DCNv2's cases of the ``kernels`` phase alone
    (``dcn_kernels``), with the package of the checkout at ROOT, so that two
    commits compare in one call (unpack the earlier one with ``git archive``
    and run both in the turns parent, change, change, parent). Prints one
    JSON line of E's, F's and G's entries."""
    root = build_checkout(root)
    from lowlightenvironmentvideoobjectdetection_torch.ops import (
        deform_conv as dcn_ops)
    errs = {}
    out = dcn_kernels(dev, torch.Generator().manual_seed(0), dcn_ops, errs)
    print(json.dumps(dict(root=str(root), card=smi, dcn=out,
                          max_abs_err=errs)), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roi-grad-times", metavar="ROOT",
                    help="only kernel D's cases, with the package at ROOT")
    ap.add_argument("--dcn-times", metavar="ROOT",
                    help="only DCNv2's cases (E, F, G), with the package at "
                         "ROOT")
    args = ap.parse_args()
    # f32 results are compared below: no TF32 anywhere in this run. Set
    # here, not at import: the data loader's spawned workers import this
    # module, and a worker that has touched the CUDA flags aborts at exit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # ---- device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)
    if args.roi_grad_times:
        return roi_grad_times(args.roi_grad_times, dev, smi)
    if args.dcn_times:
        return dcn_times(args.dcn_times, dev, smi)

    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        init_model, inference_vid)
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        selsa as S)
    from lowlightenvironmentvideoobjectdetection_torch.ops import (
        cuda_build, deform_conv as dcn_ops, roi_align as roi_ops)
    from lowlightenvironmentvideoobjectdetection_torch.ops.fused_attention import (  # noqa: E501
        _attention_body as attention_body,
        selsa_fused_attention_2slab_hm as attention,
        selsa_fused_attention_hm as attention1)
    roi_align, roi_align_backward = roi_ops.roi_align, roi_ops.roi_align_backward
    kernels_on_path = (attention, roi_align, attention1)

    # ---- build
    t0 = time.perf_counter()
    lib_path = cuda_build.build()
    cuda_build.load_library()
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          library=lib_path.name, flags=" ".join(cuda_build.NVCC_FLAGS))

    # ---- kernels at the main path's shapes
    g = torch.Generator().manual_seed(0)
    summary = {}
    errs = dict(attention_mma_layout=check_mma_layout(dev, attention))
    for dtype in (torch.float32, torch.bfloat16):
        body = attention_body(dtype, dtype)
        for masked in (False, True):
            args = attention_inputs(dev, dtype, g, all_masked=masked)
            n_body = attention.body_launches[body]
            got = attention(*args)
            if attention.body_launches[body] != n_body + 1:
                raise AssertionError(f"attention {dtype}: not the {body} body")
            want = attention(*args, impl="plain")
            check_close("attention", got, want, 0.0, ATTN_ATOL)
            errs[f"attention_{str(dtype)[6:]}{'_all_masked' if masked else ''}"] \
                = max_err(got, want)
    args = attention_inputs(dev, torch.bfloat16, g)
    summary["attention"] = attention_times(attention, args,
                                           errs["attention_bfloat16"])

    summary["roi_align"] = roi_align_kernels(dev, g, roi_align, errs)
    summary["roi_align_backward"] = roi_grad_kernels(
        dev, g, roi_ops, roi_ops.roi_align_backward_plain, S, errs, smi)

    # kernel C alone, and against kernel A on the same keys split in two
    for dtype in (torch.float32, torch.bfloat16):
        body = attention_body(dtype, dtype)
        for masked in (False, True):
            q, k1, v1, k2, v2, b1, b2 = attention_inputs(dev, dtype, g,
                                                         all_masked=masked)
            c_args = (q, torch.cat([k1, k2], 1), torch.cat([v1, v2], 1),
                      torch.cat([b1, b2]))
            n_body = attention1.body_launches[body]
            got = attention1(*c_args)
            if attention1.body_launches[body] != n_body + 1:
                raise AssertionError(f"attention_1slab {dtype}: not the "
                                     f"{body} body")
            want = attention1(*c_args, impl="plain")
            two = attention(q, k1, v1, k2, v2, b1, b2)
            check_close("attention_1slab", got, want, 0.0, ATTN_ATOL)
            check_close("attention_1slab vs 2slab", got, two, 0.0, 0.0)
            tag = f"{str(dtype)[6:]}{'_all_masked' if masked else ''}"
            errs[f"attention_1slab_{tag}"] = max_err(got, want)
            errs[f"attention_1slab_vs_2slab_{tag}"] = max_err(got, two)
    q, k1, v1, k2, v2, b1, b2 = attention_inputs(dev, torch.bfloat16, g)
    c_args = (q, torch.cat([k1, k2], 1), torch.cat([v1, v2], 1),
              torch.cat([b1, b2]))
    summary["attention_1slab"] = attention_times(
        attention1, c_args, errs["attention_1slab_bfloat16"])
    del q, k1, v1, k2, v2, c_args

    # kernel A with the stream axis of the serve path
    for dtype in (torch.float32, torch.bfloat16):
        args = batched_attention_inputs(dev, dtype, g, SERVE_S)
        got = attention(*args)
        want = attention(*args, impl="plain")
        check_close("attention batched", got, want, 0.0, ATTN_ATOL)
        one = attention(*(a[-1] for a in args))  # the last stream alone
        check_close("attention batched vs alone", got[-1], one, 0.0, 0.0)
        errs[f"attention_s{SERVE_S}_{str(dtype)[6:]}"] = max_err(got, want)
    summary["attention"]["batched"] = dict(
        streams=SERVE_S, **attention_times(
            attention, args, errs[f"attention_s{SERVE_S}_bfloat16"]))
    del args, got, want, one

    # DCNv2's kernels E, F and G at the aggregator's four stage shapes
    dcn = dcn_kernels(dev, g, dcn_ops, errs)
    dcn_names = ("dcn_im2col", "dcn_col2im", "dcn_col2im_coord")
    for name, kern in zip(dcn_names, "EFG"):
        summary[name] = dict(dcn[kern], launches=0)
    phase("kernels", card=smi, max_abs_err=errs, bf16_times=summary,
          tolerances=dict(attention_atol=ATTN_ATOL, library_atol=LIBRARY_TOL,
                          roi_f32_atol=ROI_F32_ATOL,
                          roi_bf16_rtol_atol=ROI_BF16_TOL,
                          roi_grad_f32_atol_rel_to_max=ROI_GRAD_F32_REL,
                          roi_grad_bf16_rtol=ROI_GRAD_BF16_RTOL,
                          dcn_atol_rel_to_max=DCN_REL,
                          dcn_grad_x_bf16_rtol=DCN_BF16_RTOL))

    # ---- stream: full-width SELSA R50-DC5, default config (bf16)
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (STREAM_FRAMES + 1, 600, 1000, 3)
                         ).astype(np.uint8)
    refs = rng.randint(0, 256, (14, 600, 1000, 3)).astype(np.uint8)
    model = init_model("SELSA", seed=0, device=dev)
    cfg = model.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels_on_path)
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
    if (n_attn != 2 * nframes or n_roi != nframes + 1
            or attention1.launches != 0):
        raise AssertionError(f"launch counts attention={n_attn} "
                             f"roi_align={n_roi} for {nframes} frames")
    check_bodies("stream attention", attention, fma=0, mma=n_attn)
    check_bodies("stream roi_align", roi_align, gather7x2=n_roi,
                 gather14x2=0)
    add_bodies(summary["roi_align"], roi_align.body_launches)
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
    summary["attention_1slab"]["launches"] = 0
    del model, st, results

    # ---- agree: f32 full width, kernel path vs plain path
    m32 = init_model("SELSA", seed=0, device=dev, compute_dtype=torch.float32)
    ref_imgs = torch.randn(14, 608, 1024, 3, generator=g).to(dev)
    frame = torch.randn(608, 1024, 3, generator=g).to(dev)
    shape = torch.tensor([608.0, 1024.0], device=dev)
    state = S.init_video_state(m32.model, ref_imgs, shape, m32.anchors)
    reset_counts(attention)
    got = S.stream_head(m32.model, state, frame, shape, m32.anchors)
    check_bodies("agree attention", attention, mma=0, fma=2)
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
    del state, ref_imgs

    serve_agree(m32, dev, g, S, attention)
    del m32

    # launches in the JSON line: the stream, serve and single_slab paths
    names = ("attention", "roi_align", "attention_1slab")
    model, memos, _, frame, shape = serve(dev, smi, init_model, S,
                                          kernels_on_path)
    memo = memos[0]
    del memos
    for name, kern in zip(names, kernels_on_path):
        summary[name]["launches"] += kern.launches
    add_bodies(summary["roi_align"], roi_align.body_launches)
    for name, n in zip(names, single_slab(model, memo, frame, shape,
                                          kernels_on_path)):
        summary[name]["launches"] += n
    add_bodies(summary["roi_align"], roi_align.body_launches)
    del model, memo, frame

    # training: kernel D joins the path
    train_kernels = kernels_on_path + (roi_align_backward,)
    counts = train(dev, smi, S, train_kernels)
    for name, n in zip(names + ("roi_align_backward",), counts):
        summary[name]["launches"] = summary[name].get("launches", 0) + n
    add_bodies(summary["roi_align"], roi_align.body_launches)
    add_bodies(summary["roi_align_backward"],
               roi_align_backward.body_launches)
    train_agree(dev, S, roi_align, roi_align_backward)

    # the paper's distillation, and streaming with TemporalRoIAlign
    counts, bodies = darkfarm_train(dev, smi, train_kernels)
    for name, n in zip(names + ("roi_align_backward",), counts):
        summary[name]["launches"] += n
    for name in ("roi_align", "roi_align_backward"):
        add_bodies(summary[name], bodies[name])
    darkfarm_agree(dev, roi_align, roi_align_backward)
    counts, bodies = troi_stream(dev, smi, init_model, inference_vid, S,
                                 kernels_on_path, g)
    for name, n in zip(names, counts):
        summary[name]["launches"] += n
    add_bodies(summary["roi_align"], bodies["roi_align"])

    # the canonical config: the Denoising2Aggregator, DCNv2 joins the path
    dcn_launchers = (dcn_ops.deform_columns, dcn_ops.deform_col2im,
                    dcn_ops.deform_col2im_coord)
    counts, bodies = agg_train(dev, smi, train_kernels + dcn_launchers)
    for name, n in zip(names + ("roi_align_backward",) + dcn_names, counts):
        summary[name]["launches"] += n
    for name in ("roi_align", "roi_align_backward"):
        add_bodies(summary[name], bodies[name])
    agg_agree(dev, (roi_align, roi_align_backward) + dcn_launchers)

    # the training data path: a config file and PNG frames on disk
    path_kernels = train_kernels + dcn_launchers
    with tempfile.TemporaryDirectory(prefix="_smoke_", dir=REPO) as root:
        counts, bodies, ann, item = data_train(dev, smi, path_kernels, root)
        more, more_bodies = noise_raw(dev, smi, path_kernels, root, ann,
                                      item)
    for name, n, m in zip(KERNEL_NAMES, counts, more):
        summary[name]["launches"] += n + m
    for name in ("roi_align", "roi_align_backward"):
        add_bodies(summary[name], bodies[name])
        add_bodies(summary[name], more_bodies[name])

    for name, entry in summary.items():
        if sum(entry.get("body_launches", {}).values()) not in (
                0, entry["launches"]):
            raise AssertionError(f"{name}: launches per body "
                                 f"{entry['body_launches']} do not add up "
                                 f"to {entry['launches']}")
    tpu_ops = "lowlightenvironmentvideoobjectdetection_tpu/ops/"
    kernels = [
        dict(name="selsa_fused_attention_2slab_hm", route="cuda",
             source=f"{PKG}/csrc/selsa_attention.cu",
             replaces=tpu_ops + "fused_attention.py:132",
             **summary["attention"]),
        dict(name="roi_align", route="cuda", source=f"{PKG}/csrc/roi_align.cu",
             replaces=tpu_ops + "roi_align_pallas.py:62",
             **summary["roi_align"]),
        dict(name="selsa_fused_attention_hm", route="cuda",
             source=f"{PKG}/csrc/selsa_attention.cu",
             replaces=tpu_ops + "fused_attention.py:53",
             **summary["attention_1slab"]),
        dict(name="roi_align_backward", route="cuda",
             source=f"{PKG}/csrc/roi_align.cu",
             replaces="backward of kernel B (JAX: autodiff of "
                      "ops/roi_align.py)",
             **summary["roi_align_backward"]),
    ]
    dcn_replaces = (tpu_ops + "deform_conv.py:28 (XLA; mmcv "
                    "modulated_deform_conv2d)")
    for name, body, what in zip(
            dcn_names, ("dcn_im2col_tile", "dcn_col2im_tile",
                        "dcn_col2im_coord_tile"),
            ("forward: the bilinear im2col", "backward: the input's gradient",
             "backward: the offsets' and the mask's gradients")):
        kernels.append(dict(name=name, body=body, route="cuda",
                            source=f"{PKG}/csrc/deform_conv.cu",
                            replaces=dcn_replaces, computes=what,
                            **summary[name]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
