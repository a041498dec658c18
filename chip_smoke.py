"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line: ``device`` (fails without CUDA), ``build``
(compiles the CUDA kernels from ``csrc/`` with nvcc for sm_90a, one nvcc per
source in parallel), ``kernels`` (each kernel against its plain torch
version at the main paths' shapes, f32 and bf16, with CUDA-event times:
first a known-answer check of the tensor-core body's fragment layouts, then
kernel A single-stream and stream-batched at S = 4, kernel B at the
single-stream (also a MOT detector's), S = 4 serve, memo-fill, training
and Tracktor's ``regress`` (64 rois) shapes, kernel C alone and against
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
canonical config with ``--cfg-options`` pointing ``data.train`` at it,
DATA_STEPS steps with 4 loader workers and as many without: B and D twice and E, F, G 12
times a step, finite losses, the loader's host ms a batch beside the step
ms, the device's idle share with and without workers; then one sample's
device stages on the card and on the CPU from the same files and draws,
uint8 stages equal, float stages to DATA_FLOAT_TOL) and ``noise_raw``
(``SeqAddNoise`` 'a7s3' and ``SeqsRGB2RAW`` + ``SeqNormalizeRAW`` on those
frames on the card against the CPU with the same draws, the a7s3 noise's
per-channel moments from the card's own generator against the model, and
3 steps of ``llvod_raw_darkfarm.py`` through the CLI on 8-channel RAW
pairs: B and D twice a step). Then ``eval``, on the same tree: the
canonical config's test split at full width through ``apis/test.py`` on
the plain path at f32, whose detections become the gts (its own mAP50 1);
the kernel path at f32 through the port's test CLI against them (mAP50 at
least EVAL_F32_MAP, per-frame detection sets against the plain run's);
the config's bf16 through the CLI with 4 loader workers and none (mAP50,
frames/s, frame-0 and steady frame ms, the host split, the device's idle
share, peak memory; A 3 times and B once a frame, B once more a memo
fill); the training CLI's eval hook against the test CLI on its final
checkpoint. Then the dark backbones and the denoise-then-detect
baselines: ``kernels`` also holds E, F and G at the frame counts that
streaming ResNetC gives its plugin after stage 4 (a memo fill's 14
frames, S = 4 and 1; the training shapes of the dark packs are the
aggregator's four); ``dark_variants`` (each of the 13 ``DARK_VARIANTS``
backbones at full width on a 3-frame clip, ``conv_offset`` perturbed: the
f32 kernel path against the plain DCN, the E launches its modules give,
the bf16 forward's ms), ``plugin_train`` (the insert-plugins config through
``train_model``: E 12, F and G 9 launches a step, ``plugin1`` taking no
gradient as in JAX; the stem and stage 1 bit-identical, the later
plugins' leaves changed), ``plugin_agree`` (its f32 loss and gradients,
kernels against plain, ``conv_offset`` perturbed), ``dark_agree`` (the
ConvLSTM config's, B and D against the plain RoIAlign), then on the tree:
``dark_train`` (``llvod_lstm_darkfarm.py`` through the CLI with 4 loader
workers: B and D twice a step, no DCN, the teacher and the frozen stages
bit-identical, the ConvLSTM gates changed, step ms, idle share, peak
memory), ``dark_stream`` (its test split: the plain f32 run's detections
as gts, the kernel path at f32 through the test CLI, mAP50; then S = 4
ResNetC streams batched against each stream alone at f32) and
``fastdvd_train`` (``llvod_fastdvd_darkfarm.py`` 3 steps and
``llvod_unet_darkfarm.py`` 2 through the CLI: B and D twice a step,
``loss_denoise`` finite, every denoiser leaf changed). Then the
flow-based ImageNet-VID families: ``fgfa_stream``
(``fgfa_faster_rcnn_r50_dc5_1x_imagenetvid.py`` through ``VIDModel`` at
full width, bf16 detector, a 14-frame memo of frames and maps, random
600x1000 frames: memo fill and steady frame ms, the device's idle share,
peak memory, the split of a frame into the backbone, FlowNetSimple over
the 14 pairs, the warp, ``F.grid_sample`` alone at those shapes, the
EmbedAggregator (and its conv on 15 maps against 16 in one call) and the
rest; B once a frame; the f32 kernel path against
the plain path, detections as sets), ``dff_stream`` (the DFF config over
DFF_FRAMES frames at ``key_frame_interval`` 10: key against non-key frame
ms, B once a frame, f32 agreement), then on an ImageNet-VID tree of PNG
frames (VID_TREE, written with the port's PNG writer): ``vid_train``
(the SELSA, FGFA and DFF R50 configs through the training CLI with
VID_WORKERS loader processes: step ms, idle share, peak memory; B and D
twice a step for SELSA, once for FGFA and DFF), ``fgfa_agree`` (FGFA's f32
loss and gradients, kernels B and D against the plain RoIAlign) and
``vid_eval`` (FGFA and DFF through the test CLI on the val split: the
plain f32 run's detections as gts, the f32 kernel path's mAP50). Then
tracking: ``mot_stream`` (DeepSORT at the MOT config's defaults through
``inference_mot``: random 1080x1920 frames into the 608x1024 bucket, bf16
detector, the ReID R50 bf16 on up to 48 crops of 256x128; frame ms and
its split into the detector, crops + ReID and the host association, the
idle share, peak memory; B once a frame on ``gather7x2``; the f32 kernel
path against the plain path on one frame, detections as sets and the
embeddings of the same boxes), ``tracktor_stream`` (Tracktor with ECC and
linear motion over a panning 1080x1920 sequence: B once at frame 0 and
twice a frame after, ``regress`` ms on 64 boxes, ECC ms, the pan
recovered against the known one), ``sot_stream`` (SiamRPN++ at 127 / 255,
f32: init and step ms, idle share; one step on the card against the CPU
from the same state) and ``track_eval`` (the test CLI's MOT route with
DeepSORT on a MOT tree of PNG frames with public detections, MOTA at
least MOT_MOTA_FLOOR, and its SOT route on a LaSOT tree, finite OPE;
frames/s of both). Then the image detectors: ``param_search`` and
``sot_train`` on the tracking trees, ``det_stream`` (FPN Faster R-CNN,
RetinaNet and the DC5 Faster R-CNN through ``DetectorModel``),
``det_variants`` (GA Faster R-CNN, GRoIE and Libra R-CNN at 800 x 1344
and GA-RetinaNet at 768 x 1280, bf16: image ms, idle share, B's and E's
launches each image; f32 kernel path against the plain path as sets),
``det_dense`` (the one-stage heads on the FPN trunk at 768 x 1280,
bf16: FCOS, NAS-FCOS, ATSS, GFL, PAA, VFNet, FreeAnchor, PISA-RetinaNet,
FSAF, FoveaBox, SABL, RepPoints and NAS-FPN RetinaNet, their
classifiers' prior bias zeroed so that seeded weights detect; image ms,
idle share, peak memory; E ten times an image for VFNet and RepPoints, no
kernel for the others; their f32 kernel path against the plain path as
sets), then on a COCO tree of PNG images ``det_train``, ``det_eval``,
``det_variants_train`` (the four variant configs through the training
CLI: step ms, finite losses, the launches of B, D, E, F and G),
``det_dense_train`` (the thirteen dense configs through the training
CLI: step ms, idle share, finite losses; E, F and G ten times a step for
VFNet and RepPoints), ``det_autoaugment_train`` (the AutoAugment
RetinaNet config with its own pipeline through the training CLI: finite
losses, no kernel, every policy drawn), ``det_zoo_eval`` (those five
configs and the AutoAugment one through the test CLI on the val split:
every image, finite per-class results, RepPoints' E launches, the seven
two-stage DC5 configs and the six mask configs below), ``det_rcnn`` (the
two-stage families
on the DC5 trunk at 608 x 1024, bf16, 80 classes, Cascade RPN's one:
Cascade R-CNN, Cascade RPN, Double-Head, Dynamic and PISA R-CNN, Grid R-CNN
and TridentNet through ``DetectorModel``; image ms, idle share; B's
launches an image on each body (Grid's 14x14 ``gather14x2`` among them)
and Cascade RPN's E; Grid's and Cascade RPN's f32 kernel path against the
plain path as sets), ``det_rcnn_train`` (those seven configs through the
training CLI: step ms, idle share, finite losses, Dynamic R-CNN's
``batch_iou`` / ``batch_beta``; B and D a step on each body, Grid's
``scatter14x2`` among them, and E, F, G once a step for Cascade RPN),
``det_mask`` (the mask families, Mask R-CNN, Mask Scoring R-CNN,
PointRend, HTC and SCNet at 608 x 1024 and YOLACT at 768 x 1280, bf16, 80
classes, through ``DetectorModel``, which drops the masks: image ms, idle
share, B's launches an image on each body), ``det_mask_agree`` (Mask
R-CNN and HTC at f32 through their modules, masks and all: the kernel
path's detections against the plain path's as sets, each matched mask
pasted at the bucket's size within MASK_AGREE_PIXELS pixels, and the
kernel path's mask AP against the plain path's masks), ``det_mask_train``
(the six mask configs through the training CLI on box-filled masks: step
ms, idle share, the mask loss terms; B's ``gather28x2`` (the 28 x 28
targets), ``gather14x2`` and D's ``scatter14x2`` a step as MASK_TRAIN
says) and ``voc_eval`` (``faster_rcnn_r50_dc5_1x_voc.py`` through the test CLI on a
VOC tree of JPEG copies and XML: the plain f32 run's detections as gts,
the f32 kernel path's mAP50, the bf16 run's). The ``kernels`` phase also
holds E, F and G at GA-RPN's P2-P6 and GA-RetinaNet's P3-P7 shapes (one
deform group, f32) and B and D at GRoIE's every-level pooling (300 rois
on each of P2-P5), and E, F and G at VFNet's P3 and P7 with star
offsets and at RepPoints' P3 and P7 with the points' offsets, B's
``gather14x2`` and D's ``scatter14x2`` at Grid R-CNN's shapes (one 38 x 64
x 512 map, 100 and 256 rois), B at PISA's 604 candidates and at
Double-Head's 1.3x rois, E, F and G at Cascade RPN's stage 2 (1 x 256
x 38 x 64, offsets from refined anchors), B's mask-target body
``gather28x2`` (256 rois on 20 box-filled, and on random, 1-channel f32
608 x 1024 masks) and B's ``gather14x2`` and D's ``scatter14x2`` at the
mask heads' shapes (100 and 256 rois about gts on one 38 x 64 x 512 map),
each beside its plain version and its bound. Then JPEG frames, the learning
check and checkpoint import: ``jpeg_decode`` (the host decoder
``csrc/jpeg_decode.cpp`` built
with g++: every committed fixture of ``tests/data/jpeg`` against its
manifest's sha256 of cv2's pixels; the 1080x1920 4:2:0 frame's decode ms
beside the same pixels as PNG), ``jpeg_train`` (the canonical config
through the training CLI on a DarkFarm tree of .JPG frames, 4 loader
workers: B and D twice and E, F, G 12 times a step, finite losses),
``jpeg_eval`` (its test CLI on the tree's val split, f32: the plain run's
detections as gts, the kernel path's mAP50), ``learning`` (the port's
``tools/learning_smoke.py`` at its 1000 steps for 2 or 3 seeds: mAP50
before below LEARNING_MAP_BEFORE_MAX, the median of 3 after at least
LEARNING_MAP_FLOOR, B and D counted) and ``torch_import`` (a seeded mmtrack
SELSA checkpoint saved, loaded with ``weights_only=True``, imported and
streamed at f32 over IMPORT_FRAMES frames through the kernels and the plain
path: equal detection sets). The entry points run there start from
PyTorch's TF32 defaults and must turn TF32 off. Then one JSON line of
kernel summaries (A-G), and a last line ``{"ok": true, "device": {...}}``.
The phases draw each model's seeded weights once (``InitMemo``: a later
build of the same model from the same seed loads a copy; line
``init_memo``).
Any failure exits non-zero.

    python3 chip_smoke.py --roi-grad-times ROOT
    python3 chip_smoke.py --dcn-times ROOT
    python3 chip_smoke.py --loader-close ROOT

run kernel D's cases, or DCNv2's (E, F, G at every offset scale), or the
training loader's close LOADER_CLOSE_ROUNDS times, alone with the package
of the checkout at ROOT (for comparing two commits in one call) and print
their JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
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
              ("train_refs", 2, 600),
              ("tracktor_regress", 1, 64))  # Tracktor's track boxes
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
ZERO_GRAD = (".ref_fc_embed.bias", "taf.emb_conv2.bias")
# DCNv2 (kernels E, F, G) at the aggregator's stage shapes, T = 3 frames of
# 608x1024, G = 8: (name, frames, channels, h, w); the dark backbones'
# packs in training take the same four (the ConvLSTM's at stages 3 and 4,
# the layer plugins' at C / 4 and the insert plugins' TAF at the stage's
# planes, 3 frames), and streaming ResNetC's plugin after stage 4 takes a
# memo fill's 14 frames as one clip and S = 4 or 1 streams' frames
DCN_SHAPES = (("stage0", 3, 64, 152, 256), ("stage1", 3, 128, 76, 128),
              ("stage2", 3, 256, 38, 64), ("stage3", 3, 512, 38, 64),
              ("plugin4_memo14", 14, 512, 38, 64),
              ("plugin4_s4", 4, 512, 38, 64), ("plugin4_s1", 1, 512, 38, 64))
DCN_GROUPS = 8
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
T_START = time.perf_counter()
KERNEL_NAMES = ("attention", "roi_align", "attention_1slab",
                "roi_align_backward", "dcn_im2col", "dcn_col2im",
                "dcn_col2im_coord")
# data_train / noise_raw: the training data path from files
CANONICAL_CFG = ("configs/vid/llvod/"
                 "llvod_l1234_fusion_add_i1234_rdb_taf_darkfarm.py")
RAW_CFG = "configs/vid/llvod/llvod_raw_darkfarm.py"
DATA_TREE = dict(videos=2, frames=10, hw=(1080, 1920))  # DarkFarm's frames
DATA_STEPS, RAW_STEPS = 5, 3
DATA_PROFILED = 1       # data_train: the last step, under the profiler
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
# eval: the plain f32 run's detections above a score make the gts, at most
# EVAL_GTS_PER_FRAME a frame (the threshold rises until none has more)
EVAL_GTS_PER_FRAME = 8
EVAL_GT_SCORE = 0.05
EVAL_F32_MAP = 0.99     # the kernel path's f32 mAP50 against those gts
EVAL_HOOK_TOL = 1e-3    # the training CLI's eval line against the test CLI
EVAL_WORKERS = (4, 0)   # the bf16 runs' loader processes
EVAL_HOOK_STEPS = 2
# the dark backbones and the denoise-then-detect baselines
LSTM_CFG = "configs/vid/llvod/llvod_lstm_darkfarm.py"
PLUGIN_CFG = "configs/vid/llvod/llvod_insert_plugins_l34_i1234_vid_a7s3.py"
FASTDVD_CFG = "configs/vid/llvod/llvod_fastdvd_darkfarm.py"
UNET_CFG = "configs/vid/llvod/llvod_unet_darkfarm.py"
DARK_CLIP = 3           # a training clip: the key and 2 references
DARK_VARIANT_REL = 1e-5  # of max |stage|: f32 kernel path vs plain DCN
DARK_STEPS, DARK_TIMED = 7, 4  # dark_train: 2 warm-up, 4 timed, 1 profiled
FASTDVD_STEPS, UNET_STEPS = 3, 2
DARK_STREAM_S, DARK_STREAM_T = 4, 3  # dark_stream: ResNetC streams, frames
# the flow-based ImageNet-VID families (FGFA, DFF) and SELSA's training
FGFA_CFG = "configs/vid/fgfa/fgfa_faster_rcnn_r50_dc5_1x_imagenetvid.py"
DFF_CFG = "configs/vid/dff/dff_faster_rcnn_r50_dc5_1x_imagenetvid.py"
SELSA_CFG = "configs/vid/selsa/selsa_faster_rcnn_r50_dc5_1x_imagenetvid.py"
FLOW_STEADY, FLOW_PROFILED = 10, 1  # fgfa_stream: frames after frame 0
DFF_FRAMES = 21         # dff_stream: key frames 0, 10 and 20
FLOW_AGREE_FRAMES = 3   # f32 kernel path against plain (DFF: key, 2 warps)
VID_TREE = dict(videos=2, frames=12, hw=(720, 1280))  # ImageNet-VID frames
VID_STEPS, VID_TIMED = 5, 2  # vid_train: 2 warm-up, 2 timed, 1 profiled
VID_WORKERS = 4
# tracking: DeepSORT, Tracktor and SiamRPN++ at the configs' widths
MOT_CFG = "configs/mot/deepsort/deepsort_faster-rcnn_fpn_4e_mot17-private-half.py"
TRACKTOR_CFG = ("configs/mot/tracktor/"
                "tracktor_faster-rcnn_r50_fpn_4e_mot17-private-half.py")
SOT_CFG = "configs/sot/siamese_rpn/siamese_rpn_r50_1x_lasot.py"
MOT_HW = (1080, 1920)   # MOT17's frames
MOT_FRAMES, MOT_PROFILED = 21, 1  # mot_stream: frame 0, 20 steady, profiled
MOT_EMBED_REL = 1e-3    # f32 embeddings, kernel path vs plain, of max |e|
# seeded weights score detections near 0.5: track every detection, so the
# association works on the frame's 48
MOT_TRACKER = dict(obj_score_thr=0.05)
TRACKTOR_FRAMES = 21    # frame 0 and 20 steady
TRACKTOR_PAN = (6, 2)   # px a frame (dx, dy)
TRACKTOR_PAN_TOL = 0.1  # px: ECC's translation against the known pan
# seeded weights score detections near 0.5: keep every track alive
TRACKTOR_TRACKER = dict(obj_score_thr=0.05, regression_score_thr=0.0)
SOT_FRAMES, SOT_PROFILED = 21, 1  # init, 20 steady steps, profiled
SOT_BOX_TOL = 1e-2      # px: one step on the card against the CPU
MOT_TREE = dict(videos=1, frames=8, hw=(1080, 1920), objects=4, seed=0,
                jitter=2.0)
SOT_TREE = dict(videos=2, frames=6, hw=(720, 1280), seed=0)
MOT_MOTA_FLOOR = 0.9
# JPEG frames, the learning check and checkpoint import
JPEG_FIXTURES = REPO / "tests" / "data" / "jpeg"
JPEG_TIMED = "darkfarm_0_low.jpg"  # 1080x1920 4:2:0, DarkFarm's frame size
JPEG_DECODES = 5        # jpeg_decode: the median of this many decodes
JPEG_TREE = dict(videos=2, val_videos=2, frames=6)
JPEG_STEPS, JPEG_PROFILED = 3, 1
LEARNING_STEPS, LEARNING_EVAL_IMAGES = 1000, 16
LEARNING_JAX_MAP_AFTER = 0.049  # the JAX tool, CPU, 1000 steps (PERF.md)
LEARNING_MAP_FLOOR = 0.5 * LEARNING_JAX_MAP_AFTER
LEARNING_MAP_BEFORE_MAX = 0.1
# a run from scratch sometimes collapses (PERF.md, "The learning floor"):
# the median of three seeds' mAP50 is gated, and the third seed runs only
# where the first two disagree
LEARNING_SEEDS = (0, 1, 2)
IMPORT_FRAMES = 4       # torch_import: frame 0 (the memo fill) and 3 more
IMPORT_CLS_SCALE = 4.0  # the synthetic fc_cls's spread over the init's
# tracking training and the image detectors
SOT_TRAIN_TREE = dict(videos=2, frames=12, hw=(720, 1280), seed=0)
SOT_TRAIN_STEPS, SOT_TRAIN_SKIP = 16, 15  # the last step profiled
DET_FPN_CFG = "configs/det/faster_rcnn_r50_fpn_1x_coco.py"
DET_RETINA_CFG = "configs/det/retinanet_r50_fpn_1x_coco.py"
DET_DC5_CFG = "configs/det/faster_rcnn_r50_dc5_1x_coco.py"
DET_STREAM = (("FasterRCNNFPN", DET_FPN_CFG), ("RetinaNet", DET_RETINA_CFG),
              ("FasterRCNN", DET_DC5_CFG))
DET_HW = (480, 640)
DET_IMAGES, DET_PROFILED = 12, 1
COCO_TREE = dict(images=8, val_images=8, hw=DET_HW, seed=0)
DET_TRAIN_STEPS, DET_TRAIN_SKIP = 4, 3
# the configs' resize: into 1333 x 800, RetinaNet's into its 1280 x 768 bucket
DET_TRAIN_SCALE = {DET_FPN_CFG: (1333, 800), DET_RETINA_CFG: (1280, 768)}
DET_GTS_PER_IMAGE = 8
PARAM_GRID = ["obj_score_thr=0.05,0.3", "match_iou_thr=0.3,0.7"]
# the FPN-trunk variants and GA-RetinaNet (det_variants, det_variants_train)
VARIANT_CFGS = (
    ("GAFasterRCNN", "configs/det/ga_faster_r50_fpn_1x_coco.py"),
    ("GRoIEFasterRCNN", "configs/det/faster_rcnn_r50_fpn_groie_1x_coco.py"),
    ("LibraFasterRCNN", "configs/det/libra_faster_rcnn_r50_fpn_1x_coco.py"),
    ("GARetinaNet", "configs/det/ga_retinanet_r50_fpn_1x_coco.py"))
VARIANT_IMAGES, VARIANT_PROFILED = 8, 1
VARIANT_TRAIN_STEPS, VARIANT_TRAIN_SKIP = 4, 3
# the configs' resize: into 1333 x 800, GA-RetinaNet into its 1280 x 768
VARIANT_TRAIN_SCALE = {"GAFasterRCNN": (1333, 800),
                       "GRoIEFasterRCNN": (1333, 800),
                       "LibraFasterRCNN": (1333, 800),
                       "GARetinaNet": (1280, 768)}
# kernel E's launches an image: GA-RPN's adaption on P2-P6, GA-RetinaNet's
# two on P3-P7
VARIANT_E_PER_IMAGE = {"GAFasterRCNN": 5, "GRoIEFasterRCNN": 0,
                       "LibraFasterRCNN": 0, "GARetinaNet": 10}
# the dense one-stage heads on the FPN trunk (det_dense, det_dense_train)
DENSE_CFGS = (
    ("FCOS", "configs/det/fcos_r50_fpn_1x_coco.py"),
    ("NASFCOS", "configs/det/nas_fcos_r50_fpn_1x_coco.py"),
    ("ATSS", "configs/det/atss_r50_fpn_1x_coco.py"),
    ("GFL", "configs/det/gfl_r50_fpn_1x_coco.py"),
    ("PAA", "configs/det/paa_r50_fpn_1x_coco.py"),
    ("VFNet", "configs/det/vfnet_r50_fpn_1x_coco.py"),
    ("FreeAnchor", "configs/det/retinanet_free_anchor_r50_fpn_1x_coco.py"),
    ("PISA", "configs/det/pisa_retinanet_r50_fpn_1x_coco.py"),
    ("FSAF", "configs/det/fsaf_r50_fpn_1x_coco.py"),
    ("FoveaBox", "configs/det/fovea_r50_fpn_4x4_1x_coco.py"),
    ("SABL", "configs/det/sabl_retinanet_r50_fpn_1x_coco.py"),
    ("RepPoints", "configs/det/reppoints_moment_r50_fpn_1x_coco.py"),
    ("NASFPNRetinaNet",
     "configs/det/retinanet_r50_nasfpn_crop640_50e_coco.py"))
DENSE_IMAGES, DENSE_PROFILED = 8, 1
DENSE_TRAIN_STEPS, DENSE_TRAIN_SKIP = 4, 3
DENSE_TRAIN_SCALE = (1280, 768)  # into the 768 x 1280 bucket
# kernel E's launches an image (F's and G's a training step): VFNet's two
# star DCNs and RepPoints' two points DCNs on each of P3-P7; the other
# eleven launch no kernel
DENSE_E_PER_IMAGE = {"VFNet": 10, "RepPoints": 10}
DENSE_CLS = ("fcos_cls", "atss_cls", "gfl_cls", "vfnet_cls", "retina_cls",
             "conv_cls", "reppoints_cls_out")
DENSE_TERM = {"FCOS": "loss_centerness", "NASFCOS": "loss_centerness",
              "ATSS": "loss_centerness", "GFL": "loss_dfl", "PAA": "loss_iou",
              "VFNet": "loss_bbox_refine", "FreeAnchor": "positive_bag_loss",
              "PISA": "loss_carl", "FSAF": "loss_bbox",
              "FoveaBox": "loss_bbox", "SABL": "loss_bbox_reg",
              "RepPoints": "loss_pts_refine", "NASFPNRetinaNet": "loss_bbox"}
# E, F, G at RepPoints' P3 and P7 of 768 x 1280: (name, level, c, h, w);
# the offsets of points N(0, REP_OFFSET_STD^2) px about the base grid
REP_DCN_SHAPES = (("reppoints_P3", 0, 256, 96, 160),
                  ("reppoints_P7", 4, 256, 6, 10))
REP_OFFSET_STD = 1.5
# det_autoaugment_train: the config's own pipeline (AutoAugment's three
# policies, its resize into the 768 x 1280 bucket) through the training
# CLI on det_train's tree; enough steps that every policy is drawn
AUTOAUG_CFG = "configs/det/retinanet_r50_fpn_autoaugment_1x_coco.py"
AUTOAUG_STEPS, AUTOAUG_SKIP = 8, 3
# E, F, G at VFNet's P3 and P7 of 768 x 1280: (name, level, c, h, w), the
# star offsets of distances REG_DENOMS[level] * exp(N(0, 0.5^2)) px (the
# seeded head's are near REG_DENOMS)
VFNET_DCN_SHAPES = (("vfnet_P3", 0, 256, 96, 160), ("vfnet_P7", 4, 256, 6, 10))
VFNET_DIST_LOG_STD = 0.5
# DCNv1 (E, F, G; one deform group, f32 x) at the level shapes of GA-RPN at
# 800 x 1344 (P2-P6) and of GA-RetinaNet at 768 x 1280 (P3-P7): (name, c, h,
# w); offsets of N(0, 1.5^2) px, every 50th beyond the map
GA_DCN_SHAPES = (("ga_rpn_P2", 256, 200, 336), ("ga_rpn_P3", 256, 100, 168),
                 ("ga_rpn_P4", 256, 50, 84), ("ga_rpn_P5", 256, 25, 42),
                 ("ga_rpn_P6", 256, 13, 21),
                 ("ga_retina_P3", 256, 96, 160), ("ga_retina_P4", 256, 48, 80),
                 ("ga_retina_P5", 256, 24, 40), ("ga_retina_P6", 256, 12, 20),
                 ("ga_retina_P7", 256, 6, 10))
GA_DCN_ITERS = 5        # timed calls a turn at these shapes
# GRoIE: every roi on each of P2-P5 at 800 x 1344 (f32 maps)
GROIE_LEVELS = ((200, 336), (100, 168), (50, 84), (25, 42))
GROIE_ROIS = 300        # the test proposals (training samples 256)
# voc_eval: faster_rcnn_r50_dc5_1x_voc.py on a VOC tree of JPEG copies
VOC_CFG = "configs/det/faster_rcnn_r50_dc5_1x_voc.py"
VOC_IMAGES = 8
VOC_MIN_SIDE = 8.0      # px: a gt's smallest side (its XML rounds to ints)
# the two-stage families on the DC5 trunk (det_rcnn, det_rcnn_train)
RCNN_CFGS = (
    ("CascadeRCNN", "configs/det/cascade_rcnn_r50_dc5_1x_coco.py"),
    ("CascadeRPN", "configs/det/cascade_rpn_r50_dc5_1x_coco.py"),
    ("DoubleHeadRCNN", "configs/det/dh_faster_rcnn_r50_dc5_1x_coco.py"),
    ("DynamicRCNN", "configs/det/dynamic_rcnn_r50_dc5_1x.py"),
    ("PISAFasterRCNN", "configs/det/pisa_faster_rcnn_r50_dc5_1x_coco.py"),
    ("GridRCNN", "configs/det/grid_rcnn_r50_dc5_1x_coco.py"),
    ("TridentFasterRCNN", "configs/det/tridentnet_r50_1x_coco.py"))
RCNN_IMAGES, RCNN_PROFILED = 8, 1
RCNN_TRAIN_STEPS, RCNN_TRAIN_SKIP = 4, 3
RCNN_TRAIN_SCALE = (1024, 608)  # into the 608 x 1024 bucket
# launches an image at test time, as the code calls them: (B gather7x2, B
# gather14x2, E); Cascade R-CNN's three stages, Double-Head's rois and
# their 1.3x, Grid's 7x7 scoring and 14x14 grid head, Trident's middle
# branch, Cascade RPN's stage-2 DCN
RCNN_TEST = {"CascadeRCNN": (3, 0, 0), "CascadeRPN": (0, 0, 1),
             "DoubleHeadRCNN": (2, 0, 0), "DynamicRCNN": (1, 0, 0),
             "PISAFasterRCNN": (1, 0, 0), "GridRCNN": (1, 1, 0),
             "TridentFasterRCNN": (1, 0, 0)}
# a training step: (B 7x2, B 14x2, D 7x2, D 14x2, E = F = G); PISA's
# ScoreHLR pass over every candidate has no gradient (B without D),
# Trident's three branches
RCNN_TRAIN = {"CascadeRCNN": (3, 0, 3, 0, 0), "CascadeRPN": (0, 0, 0, 0, 1),
              "DoubleHeadRCNN": (2, 0, 2, 0, 0),
              "DynamicRCNN": (1, 0, 1, 0, 0),
              "PISAFasterRCNN": (2, 0, 1, 0, 0), "GridRCNN": (1, 1, 1, 1, 0),
              "TridentFasterRCNN": (3, 0, 3, 0, 0)}
RCNN_TERM = {"CascadeRCNN": "s2.loss_bbox", "CascadeRPN": "loss_s2_reg",
             "DoubleHeadRCNN": "loss_bbox", "DynamicRCNN": "batch_beta",
             "PISAFasterRCNN": "loss_carl", "GridRCNN": "loss_grid",
             "TridentFasterRCNN": "loss"}
RCNN_AGREE = ("GridRCNN", "CascadeRPN")  # f32 kernel path vs plain, as sets
# kernels at their shapes: Grid R-CNN's and the mask heads' 14x14 bodies
# on one DC5 map (100 test detections, 256 training rois), PISA's G + 600
# candidates and Double-Head's 300 test proposals scaled 1.3x on the 7x7
# body
RCNN_MAP = (38, 64, 512)
RCNN_GRID_ROIS = (100, 256)
RCNN_PISA_CANDIDATES = 604
RCNN_DH_ROIS = 300
# E, F, G at Cascade RPN's stage 2: offsets from the single anchors
# refined by N(0, 0.5^2) deltas (stds (0.1, 0.1, 0.5, 0.5))
CRPN_DCN_SHAPES = (("cascade_rpn_s2", 256, 38, 64),)
CRPN_DELTA_STD = 0.5
# the mask families (PR 23): the five DC5 configs and YOLACT
MASK_CFGS = (
    ("MaskRCNN", "configs/det/mask_rcnn_r50_dc5_1x_coco.py"),
    ("MaskScoringRCNN", "configs/det/ms_rcnn_r50_dc5_1x_coco.py"),
    ("PointRend", "configs/det/point_rend_r50_dc5_1x_coco.py"),
    ("HTC", "configs/det/htc_r50_dc5_1x_coco.py"),
    ("SCNet", "configs/det/scnet_r50_dc5_1x_coco.py"),
    ("YOLACT", "configs/det/yolact_r50_1x8_coco.py"))
MASK_IMAGES, MASK_PROFILED = 4, 1
# launches an image at test time, as the code calls them: (B gather7x2, B
# gather14x2); HTC / SCNet read the neck and the semantic features at
# every stage (3 x 2 at 7x7) and once for the mask heads (2 at 14x14);
# YOLACT launches none
MASK_TEST = {"MaskRCNN": (1, 1), "MaskScoringRCNN": (1, 1),
             "PointRend": (1, 1), "HTC": (6, 2), "SCNet": (6, 2),
             "YOLACT": (0, 0)}
# a training step: (B 7x2, B 14x2, B 28x2 (the targets), D 7x2, D 14x2)
MASK_TRAIN = {"MaskRCNN": (1, 1, 1, 1, 1), "MaskScoringRCNN": (1, 1, 1, 1, 1),
              "PointRend": (1, 1, 1, 1, 1), "HTC": (6, 6, 3, 6, 6),
              "SCNet": (6, 6, 3, 6, 6), "YOLACT": (0, 0, 0, 0, 0)}
MASK_TERMS = {"MaskRCNN": ("loss_mask",),
              "MaskScoringRCNN": ("loss_mask", "loss_mask_iou"),
              "PointRend": ("loss_mask", "loss_point"),
              "HTC": ("loss_semantic", "s0.loss_mask", "s1.loss_mask",
                      "s2.loss_mask"),
              "SCNet": ("loss_semantic", "s0.loss_mask", "s1.loss_mask",
                        "s2.loss_mask"),
              "YOLACT": ("loss_mask", "loss_segm")}
MASK_AGREE = ("MaskRCNN", "HTC")  # f32 kernel path vs plain
MASK_AGREE_PIXELS = 16  # pasted pixels a matched instance may differ by
# kernel B's mask-target body: G box-filled (and random) 1-channel f32
# masks at the DC5 bucket, rois about the gts (the mask heads' 14x14
# bodies are rcnn_roi_kernels' cases)
MASK_TARGET = dict(gts=20, rois=256, hw=(608, 1024))
# --loader-close: rounds of opening, reading and closing the loader
LOADER_CLOSE_ROUNDS, LOADER_CLOSE_BATCHES = 12, 6
# the plain versions' calls a timing turn (milliseconds a call; the
# kernels' 20)
PLAIN_ITERS = 5
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
                   out_size=7, sampling_ratio=2, map_pixels=None):
    """(bytes, FLOPs) of kernel B: the maps (or only ``map_pixels`` of their
    pixels, where the rois touch fewer), the f32 rois [N, 4] and, for a
    batch, the per-roi map index (``bind_bytes`` each) read once, the output
    in the feature dtype written once; 2 FLOPs per corner of each of the
    sampling_ratio^2 samples of an output element."""
    out_elems = n_rois * out_size * out_size * c
    if map_pixels is None:
        map_pixels = n_maps * h * w
    nbytes = (map_pixels * c * feat_bytes + 16 * n_rois
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
    """One phase's line; ``script_s``: seconds since the script started,
    which dates each phase's end."""
    fields.setdefault("script_s", time.perf_counter() - T_START)
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
    no library call). The plain versions, milliseconds a call, are timed
    over PLAIN_ITERS calls a turn."""
    p1 = timed(plain, PLAIN_ITERS, 1)
    l1 = timed(library) if library else None
    k1, k2 = timed(kernel), timed(kernel)
    l2 = timed(library) if library else None
    p2 = timed(plain, PLAIN_ITERS, 1)
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


def device_generator(g, dev):
    """A generator on ``dev`` seeded by a draw from the CPU generator
    ``g``: large random operands drawn on the card, not by the CPU's
    serial draws (seconds for the DCN cases' tens of millions)."""
    return torch.Generator(device=dev).manual_seed(
        int(torch.randint(2**62, (1,), generator=g)))


def dcn_inputs(dev, dtype, g, n, c, h, w, std=2.5, push=True,
               groups=DCN_GROUPS):
    """DCN operands at one stage shape, drawn on the card
    (``device_generator``): x [n, c, h, w], offsets of N(0, std^2) px (at
    2.5 many beyond 2 px, samples beyond the edges), with ``push`` every
    50th pushed beyond the map, masks in (0, 1); ``groups`` deform
    groups."""
    gr, gd = groups, device_generator(g, dev)
    x = torch.randn(n, c, h, w, generator=gd, device=dev).to(dtype)
    off = torch.randn(n, gr * 18, h, w, generator=gd, device=dev) * std
    if push:
        off.view(-1)[::50] += float(h + w)
    mask = torch.rand(n, gr * 9, h, w, generator=gd, device=dev)
    return x, off, mask


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
    grad_cols = torch.randn(cols.shape, generator=device_generator(g, dev),
                            device=dev)
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
    for name, n, c, h, w in DCN_SHAPES:
        for scale, std, push in DCN_OFFSETS:
            gen = g if push else torch.Generator().manual_seed(int(10 * std))
            for dtype in (torch.float32, torch.bfloat16):
                tag = (f"dcn_{name}" + ("" if push else f"_{scale}")
                       + f"_{str(dtype)[6:]}")
                x, off, mask = dcn_inputs(dev, dtype, gen, n, c, h, w, std,
                                          push)
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
                nbytes, flops = dcn_cost(kern, n, c, h, w, DCN_GROUPS,
                                         x.element_size())
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
                        flops=flops, shape=[n, c, h, w],
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


def mask_head_rois(dev, n, h, w, g):
    """Rois as a mask head meets them: about 20 random gts of the padded
    image (each corner moved by up to 20% of its gt's side), the first
    one outside the image."""
    gts = test_rois("cpu", 20, h, w, g).clamp(0, w * 16)
    c = gts[torch.randint(0, 20, (n,), generator=g)]
    side = (c[:, 2:] - c[:, :2]).repeat(1, 2)
    r = c + (torch.rand(n, 4, generator=g) * 0.4 - 0.2) * side
    r[0] = torch.tensor([-200.0, -200.0, -100.0, -120.0])
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
    """The kernel's launches per body since its last reset are ``want``
    (a body not named: none)."""
    if set(want) - set(kernel.body_launches):
        raise AssertionError(f"{name}: no body {sorted(want)}")
    want = {b: want.get(b, 0) for b in kernel.body_launches}
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
    left unmatched, the largest differences among matched rows, for
    unmatched rows the nearest same-label row in units of the tolerances,
    and the highest score of an unmatched row."""
    def rows(d):
        v = d.valid.cpu().numpy()
        return list(zip(d.labels.cpu().numpy()[v],
                        d.boxes.float().cpu().numpy()[v],
                        d.scores.float().cpu().numpy()[v]))
    return match_rows(rows(got), rows(want))


def per_class_rows(per_cls):
    """A frame's per-class [N, 5] results as (label, box, score) rows."""
    return [(c, np.asarray(r[:4], np.float32), float(r[4]))
            for c, rows in enumerate(per_cls) for r in rows]


def match_rows(grows, wrows):
    """``match_sets`` on (label, box, score) rows."""
    grows = list(grows)
    out = dict(n_got=len(grows), n_want=len(wrows), unmatched=0, box=0.0,
               score=0.0, nearest_unmatched=0.0, top_unmatched_score=0.0)
    for lab, box, score in wrows:
        dist = [(max(np.abs(b - box).max() / SET_BOX_TOL,
                     abs(sc - score) / SET_SCORE_TOL), i)
                for i, (lb, b, sc) in enumerate(grows) if lb == lab]
        hit = min(dist, default=(np.inf, -1))
        if hit[0] >= 1.0:
            out["unmatched"] += 1
            out["nearest_unmatched"] = max(out["nearest_unmatched"],
                                           float(hit[0]))
            out["top_unmatched_score"] = max(out["top_unmatched_score"],
                                             float(score))
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
                per_step=(0, 2, 0, 2), still=()):
    """TRAIN_WARMUP + TRAIN_STEPS steps of ``loss_fn(model, sample,
    generator)`` on ``batch`` (one sample, a batch of 1) through
    ``train_model``. Checks ``per_step`` launches a step of each of
    ``kernels`` (A, B, C, D and, with the aggregator, E, F, G; by default
    two of kernel B, on the 7x7 gather body, and of kernel D, on
    scatter7x2, and none of A and C), the step count and finite metrics,
    that the parameters under the ``frozen`` prefixes stayed bit-identical
    and that the others moved (but ZERO_GRAD biases and, when they stay,
    those under the ``still`` prefixes). Returns the run: the
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
                                and not n.startswith(still)
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


class ReluPin:
    """Stands in for ``F.relu`` in the bbox head's module (``bbox_head``)
    inside a ``with`` block, for the agree phases: records each call's
    decisions (x > 0); given ``pinned`` (another run's, call by call) it
    keeps those (x where the pinned decision passes, else 0) and counts the
    elements where its own decision differs. Such a flip is a shared FC's
    pre-activation within the two paths' roundings of 0: it moves that
    roi's share of the FC's gradient row by a whole term, which no rounding
    tolerance covers (the value moves by less than the rounding)."""

    def __init__(self, module, pinned=None):
        self.module, self.orig = module, module.F
        self.pinned, self.decisions, self.flips = pinned, [], 0

    def __enter__(self):
        self.module.F = self
        return self

    def __exit__(self, *exc):
        self.module.F = self.orig

    def __getattr__(self, name):  # the rest of torch.nn.functional
        return getattr(self.orig, name)

    def relu(self, x):
        own = x > 0
        self.decisions.append(own)
        if self.pinned is None:
            return self.orig.relu(x)
        want = self.pinned[len(self.decisions) - 1]
        self.flips += int((own != want).sum())
        return x * want


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
    perturb_offsets(probe, lambda: D.darkfarm_loss(model, sample, anchors,
                                                   uniforms=uniforms), dev)

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


# ---- the dark backbones and the denoise-then-detect baselines

def add_counts(total, more):
    """{kernel: {body: count}} ``more`` added into ``total``."""
    for k, v in more.items():
        t = total.setdefault(k, {})
        for body, c in v.items():
            t[body] = t.get(body, 0) + c


def dark_dcn_calls(backbone, clip_len, backward=False):
    """E launches of one forward of a dark ``backbone`` on clips of
    ``clip_len`` frames, from its modules: 2 a bidirectional ConvLSTM block
    (``dcn_f`` on the frames, ``dcn_b`` on the forward hidden states) and
    one a reference frame of each layer plugin and each aggregator plugin's
    TAF (each call takes every clip). With ``backward``, the launches of F
    and of G in its backward: none in the stages up to ``frozen_stages``,
    whose output is detached (the stage's plugin too, as in JAX)."""
    from lowlightenvironmentvideoobjectdetection_torch.models.aggregators.denoising_aggregator import (  # noqa: E501
        TemporalAttentionFusion)
    from lowlightenvironmentvideoobjectdetection_torch.models.backbones.dark_resnet import (  # noqa: E501
        ConvLSTMBottleneck, LayerDenoisingPlugin)
    n = 0
    for i, names in enumerate(backbone.stages):
        if backward and backbone.frozen_stages >= i + 1:
            continue
        for m in (m for name in names
                  for m in getattr(backbone, name).modules()):
            if isinstance(m, ConvLSTMBottleneck) and m.bidirectional:
                n += 2
            elif isinstance(m, (LayerDenoisingPlugin,
                                TemporalAttentionFusion)):
                n += clip_len
    return n


def perturb_offsets(probe, forward, dev, seed=4):
    """Each ``conv_offset`` of the packs of ``probe`` (an ``OffsetProbe``)
    redrawn from a seeded normal and rescaled so that its offsets' std in
    ``forward()`` is AGG_OFFSET_STD px (the zero init puts every sample on
    a pixel)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in probe.packs:
            w = p.conv_offset.weight
            w.copy_(torch.randn(w.shape, generator=gen).to(dev))
        with probe:
            forward()
        for i, p in enumerate(probe.packs):
            std = statistics.mean(st["std"] for st in probe.stats
                                  if st["pack"] == i)
            p.conv_offset.weight.mul_(AGG_OFFSET_STD / std)


def offset_range(stats):
    return dict(min=min(st["min"] for st in stats),
                max=max(st["max"] for st in stats),
                std=statistics.mean(st["std"] for st in stats),
                outside_share=max(st["outside"] for st in stats))


def model_dict(cfg_path, **overrides):
    from lowlightenvironmentvideoobjectdetection_torch.config import (
        load_config)
    return dict(load_config(str(REPO / cfg_path))["model"], **overrides)


def dark_variants(dev, smi, dcn_launchers):
    """Each of the 13 ``DARK_VARIANTS`` backbones at full width (R50, the
    detector's DC5 strides and dilations, every stage returned, the stem
    and stage 1 frozen; ``InsertResNet`` with the insert-plugins configs'
    aggregator plugins), seeded, with ``conv_offset`` perturbed
    (``perturb_offsets``), on one clip of DARK_CLIP frames of 608x1024: at
    f32 the kernel path (E) against the plain DCN (``impl="plain"``),
    every stage within DARK_VARIANT_REL of its largest |value|, with
    ``dark_dcn_calls`` launches of E; then the same weights at bf16, the
    forward's ms (CUDA events, the median of 5 after 2 warm-ups).
    Returns {variant: worst error, E launches, bf16 ms}."""
    from lowlightenvironmentvideoobjectdetection_torch.models.backbones import (  # noqa: E501
        dark_resnet as DR)
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        selsa as S)
    t_phase = time.perf_counter()
    insert = dict(model_dict(PLUGIN_CFG)["backbone_overrides"])
    out = {}
    for variant in sorted(DR.DARK_VARIANTS):
        kw = dict(strides=(1, 2, 2, 1), dilations=(1, 1, 1, 2),
                  out_indices=(0, 1, 2, 3), frozen_stages=1,
                  **(insert if variant == "InsertResNet" else {}))
        model = DR.make_dark_backbone(variant, **kw)
        S.init_params(model, torch.Generator().manual_seed(0))
        model = model.to(dev).eval()
        cin = DR.DARK_VARIANTS[variant].get("in_channels", 3)
        g = torch.Generator().manual_seed(1)
        x = torch.randn(DARK_CLIP, cin, 608, 1024, generator=g).to(dev)
        probe = OffsetProbe(model)
        if probe.packs:
            perturb_offsets(probe, lambda: model(x), dev)
        want_e = dark_dcn_calls(model, DARK_CLIP)
        with torch.no_grad(), probe:
            reset_counts(*dcn_launchers)
            got = model(x)
            launches = [k.launches for k in dcn_launchers]
            plain = model(x, impl="plain")
        if launches != [want_e, 0, 0]:
            raise AssertionError(f"dark_variants {variant}: E, F, G "
                                 f"launches {launches}, want {want_e}")
        errs = [max_err(a, b) / b.abs().max().item()
                for a, b in zip(got, plain)]
        del got, plain
        bf16 = DR.make_dark_backbone(variant, dtype=torch.bfloat16, **kw)
        bf16.load_state_dict(model.state_dict())
        bf16 = bf16.to(dev).eval()
        del model
        with torch.no_grad():
            bf16(x)
            bf16(x)
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                bf16(x)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
        del bf16, x
        torch.cuda.empty_cache()
        out[variant] = dict(worst_rel_err=max(errs), e_launches=want_e,
                            bf16_forward_ms=statistics.median(times),
                            offsets=(offset_range(probe.stats)
                                     if probe.stats else None))
        if max(errs) > DARK_VARIANT_REL:
            raise AssertionError(f"dark_variants {variant}: kernel path off "
                                 f"the plain one by {max(errs)} of max")
    phase("dark_variants", card=smi, frames=DARK_CLIP, hw=[608, 1024],
          rel_tol=DARK_VARIANT_REL, variants=out,
          phase_s=time.perf_counter() - t_phase)
    return out


def dark_cli_train(name, cfg_path, root, ann, kernels, per_step, n_steps,
                   skip, workers, frozen=(), moving=()):
    """``cli_run`` on ``cfg_path`` from the data_train tree (``--seed 0``),
    with the trained model's parameters against the model the CLI built
    (``build_model`` with seed 0 again): the ``frozen`` prefixes
    bit-identical, every leaf under ``moving`` changed (but ZERO_GRAD).
    Returns the run, the unchanged and the changed parameter names."""
    from lowlightenvironmentvideoobjectdetection_torch.models.builder import (
        build_model)
    argv = [str(REPO / cfg_path), "--seed", "0", "--work-dir",
            f"{root}/work_{name}"] + data_options(root, ann, workers)
    run = cli_run(name, argv, kernels, per_step, n_steps, skip,
                  keep_model=True)
    built = dict(build_model(model_dict(cfg_path), seed=0,
                             device="cpu").model.named_parameters())
    same, moved = [], []
    for n, p in run.pop("model").named_parameters():
        (same if torch.equal(p.detach().cpu(), built[n]) else
         moved).append(n)
    bad = [n for n in same if n.startswith(moving) and
           not n.endswith(ZERO_GRAD)]
    bad += [n for n in moved if n.startswith(frozen)]
    if bad or (frozen and not any(n.startswith(frozen) for n in same)):
        raise AssertionError(f"{name}: wrong leaves moved or stayed: {bad}")
    torch.cuda.empty_cache()
    return run, same, moved


def dark_train(dev, smi, kernels, root, ann):
    """``llvod_lstm_darkfarm.py`` (``SelsaDarkDetect``: the ConvLSTM
    DarkResNet, stage 2's blocks recurrent over the key and its 2
    references as one clip, the key first; L2 feature losses against the
    frozen teacher; 8 classes, 2 shared FCs) at full width through the
    CLI from the data_train tree with DATA_WORKERS loader processes:
    DARK_STEPS steps, 2 warm-up, DARK_TIMED timed, the rest profiled for
    the idle share; B and D twice a step and no E, F or G (DarkResNet has
    no DCN), finite losses with the 4 feature losses, the teacher and the
    frozen stem and stage 1 bit-identical, every ConvLSTM gate changed.
    Returns the launch counts (A-G) and B's and D's bodies."""
    t = time.perf_counter()
    run, same, moved = dark_cli_train(
        "dark_train", LSTM_CFG, root, ann, kernels, (0, 2, 0, 2, 0, 0, 0),
        DARK_STEPS, TRAIN_WARMUP + DARK_TIMED, DATA_WORKERS,
        frozen=DARKFARM_FROZEN, moving=("selsa.backbone.layer2_",))
    keys = set(run["metrics"][-1])
    gates = [n for n in moved if ".gate_f." in n]
    if not {f"loss_l2_{i}" for i in range(4)} <= keys or len(gates) != 4:
        raise AssertionError(f"dark_train: metrics {sorted(keys)}, gates "
                             f"{gates}")
    timed_ms = run["step_ms"][TRAIN_WARMUP:TRAIN_WARMUP + DARK_TIMED]
    phase("dark_train", card=smi, config=LSTM_CFG, workers=DATA_WORKERS,
          steps=DARK_STEPS, warmup_steps=TRAIN_WARMUP, step_ms=run["step_ms"],
          median_step_ms=statistics.median(timed_ms),
          loss_per_step=[m["loss"] for m in run["metrics"]],
          last_step_metrics=run["metrics"][-1],
          loader_median_ms=loader_summary(run["timings"], TRAIN_WARMUP),
          device_window=run["window"], peak_mem_gb=run["peak_gb"],
          launches=dict(zip(KERNEL_NAMES, run["counts"])),
          frozen_or_unchanged=len(same), changed=len(moved),
          phase_s=time.perf_counter() - t)
    return run["counts"], run["bodies"]


def darkfarm_config_f32(cfg_path):
    """A config's model (``models/builder.py``) at full width in f32."""
    from lowlightenvironmentvideoobjectdetection_torch.models.builder import (
        model_config)
    return model_config(model_dict(cfg_path, compute_dtype="float32"))


def kernel_vs_plain_loss(name, model, sample, anchors, kernels, want_counts,
                         probe=None):
    """One f32 ``darkfarm_loss`` and every parameter's gradient through the
    kernels and through the plain versions (``impl="plain"``) with the same
    uniforms, at train_agree's tolerances (``kernels`` launch
    ``want_counts`` times on the kernel path). Returns the phase's
    fields."""
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        selsa as S, selsa_darkfarm as D)
    uniforms = S.draw_loss_uniforms(model.cfg.selsa, 8,
                                    torch.Generator().manual_seed(3),
                                    anchors.device)

    def run(impl):
        model.zero_grad(set_to_none=True)
        loss, _ = D.darkfarm_loss(model, sample, anchors, uniforms=uniforms,
                                  impl=impl)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters() if p.grad is not None}

    reset_counts(*kernels)
    with probe or contextlib.nullcontext():
        lk, gk = run(None)
    counts = [k.launches for k in kernels]
    if counts != list(want_counts):
        raise AssertionError(f"{name}: kernel path launches {counts}, want "
                             f"{list(want_counts)}")
    lp, gp = run("plain")
    worst, worst_leaf = grad_agreement(gk, gp)
    loss_rel = abs(lk - lp) / abs(lp)
    fields = dict(loss_kernel=lk, loss_plain=lp, loss_rel_err=loss_rel,
                  loss_rtol=TRAIN_LOSS_RTOL, leaves=len(gp),
                  worst_grad_err_over_tol=worst, worst_leaf=worst_leaf,
                  launches=counts,
                  grad_tolerance=dict(rel_to_leaf_max=TRAIN_GRAD_REL,
                                      floor_rel_to_global_max=(
                                          TRAIN_GRAD_FLOOR)))
    if loss_rel > TRAIN_LOSS_RTOL or worst > 1.0:
        phase(name, **fields)
        raise AssertionError(f"{name}: loss {lk} against {lp}; gradient of "
                             f"{worst_leaf} off by {worst} tolerances")
    return fields


def dark_agree(dev, roi_kernels):
    """f32, TF32 off: ``llvod_lstm_darkfarm.py``'s loss and every gradient
    at full width through kernels B and D and through the plain RoIAlign
    (``kernel_vs_plain_loss``)."""
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        selsa_darkfarm as D)
    from lowlightenvironmentvideoobjectdetection_torch.tools.train_profile import (  # noqa: E501
        darkfarm_sample)
    t = time.perf_counter()
    cfg = darkfarm_config_f32(LSTM_CFG)
    model, anchors = D.make_darkfarm(cfg, torch.Generator().manual_seed(0),
                                     device=dev)
    sample = darkfarm_sample(cfg, dev, seed=3)
    fields = kernel_vs_plain_loss("dark_agree", model, sample, anchors,
                                  roi_kernels, (2, 2))
    phase("dark_agree", config=LSTM_CFG, phase_s=time.perf_counter() - t,
          **fields)
    del model


def plugin_train(dev, smi, kernels):
    """``llvod_insert_plugins_l34_i1234_vid_a7s3.py`` (``SelsaNoiseDetect``
    on InsertResNet: a ``DenoisingAggregator`` with 1 RDB of 8 layers and a
    TAF after each of the 4 stages; no teacher; 30 classes, 2 shared FCs;
    bf16 compute, f32 parameters) at full width through ``train_steps`` on
    a seeded (noise, clean) sample of a key and 2 references: per step B
    and D twice and E, F and G ``dark_dcn_calls`` times (derived from the
    built backbone: each TAF's DCN once per frame; F and G not in
    ``plugin1``, which takes no gradient), the stem and stage 1
    bit-identical, every leaf of ``plugin2`` to ``plugin4`` changed (but
    ZERO_GRAD). ``plugin1`` sits before stage 1's gradient stop, as in
    JAX: no gradient reaches it, so its zero-initialised leaves stay 0 and
    the others move by the weight decay alone. Returns the launch counts
    (A-G) and B's and D's bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.models.builder import (
        build_model)
    from lowlightenvironmentvideoobjectdetection_torch.tools.train_profile import (  # noqa: E501
        darkfarm_sample)
    t = time.perf_counter()
    system = build_model(model_dict(PLUGIN_CFG), seed=0, device=dev)
    model = system.model
    sample = darkfarm_sample(system.cfg, dev, seed=2)
    batch = type(sample)(*(f[None] for f in sample))
    backbone, clip = model.selsa.backbone, sample.pair_imgs.shape[0]
    n_dcn = (dark_dcn_calls(backbone, clip),) + (dark_dcn_calls(
        backbone, clip, backward=True),) * 2
    first = "selsa.backbone.plugin1."
    run = train_steps("plugin_train", model, batch, system.loss_fn, kernels,
                      DARKFARM_FROZEN, per_step=(0, 2, 0, 2) + n_dcn,
                      still=(first,))
    plugins = [n for n, _ in model.named_parameters()
               if n.startswith("selsa.backbone.plugin")]
    if {n.split(".")[2] for n in plugins} != {f"plugin{i}" for i in
                                              range(1, 5)}:
        raise AssertionError(f"plugin_train: plugins {plugins}")
    first_still = [n for n in run["unchanged"] if n.startswith(first)]
    timed_ms = run["step_ms"][TRAIN_WARMUP:]
    med = statistics.median(timed_ms)
    phase("plugin_train", card=smi, config=PLUGIN_CFG,
          steps=len(run["step_ms"]), warmup_steps=TRAIN_WARMUP,
          loss_per_step=[m["loss"] for m in run["metrics"]],
          step_ms=run["step_ms"], median_step_ms=med,
          step_ms_min_max=[min(timed_ms), max(timed_ms)],
          peak_mem_gb=run["peak_gb"], dcn_calls_per_step=dict(
              zip(("E", "F", "G"), n_dcn)),
          launches=dict(zip(KERNEL_NAMES, run["counts"])),
          plugin_params=len(plugins), plugin_numel=sum(
              p.numel() for n, p in model.named_parameters()
              if n in plugins),
          frozen_params=len(run["frozen"]),
          unchanged_params=run["unchanged"],
          plugin1_unchanged=len(first_still), plugin1_params=sum(
              n.startswith(first) for n in plugins),
          phase_s=time.perf_counter() - t)
    del model, system
    return run["counts"], run["bodies"]


def plugin_agree(dev, kernels):
    """f32, TF32 off: the ``plugin_train`` config's loss and every gradient
    at full width through B, D, E, F, G and through the plain RoIAlign and
    DCN, with ``conv_offset`` perturbed (``perturb_offsets``; the offsets'
    range printed), at train_agree's tolerances."""
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        selsa_darkfarm as D)
    from lowlightenvironmentvideoobjectdetection_torch.tools.train_profile import (  # noqa: E501
        darkfarm_sample)
    t = time.perf_counter()
    cfg = darkfarm_config_f32(PLUGIN_CFG)
    model, anchors = D.make_darkfarm(cfg, torch.Generator().manual_seed(0),
                                     device=dev)
    sample = darkfarm_sample(cfg, dev, seed=3)
    probe = OffsetProbe(model)
    with torch.no_grad():
        perturb_offsets(probe, lambda: model.selsa.extract_feats(
            sample.pair_imgs[..., :cfg.in_channels]), dev)
    backbone, clip = model.selsa.backbone, sample.pair_imgs.shape[0]
    want = (2, 2, dark_dcn_calls(backbone, clip)) + (dark_dcn_calls(
        backbone, clip, backward=True),) * 2
    fields = kernel_vs_plain_loss("plugin_agree", model, sample, anchors,
                                  kernels, want, probe)
    phase("plugin_agree", config=PLUGIN_CFG, offsets=offset_range(
        probe.stats), phase_s=time.perf_counter() - t, **fields)
    del model


def dark_stream(dev, smi, kernels, root, ann):
    """Streaming on the dark backbones. (1) ``llvod_lstm_darkfarm.py``'s
    test split on the data_train tree (the ConvLSTM over each video's 14
    references as one clip at frame 0, then each frame as a clip of one):
    the plain path at f32 (``eval_reference``) makes the gts
    (``eval_gts``), the kernel path at f32 through the test CLI scores
    mAP50 at least EVAL_F32_MAP against them; A twice and B once a frame,
    B once more a memo fill. (2) ``ResNetC`` (a layer plugin after stage
    4) at f32, full width, ``conv_offset`` perturbed: DARK_STREAM_S memos
    from 14 reference frames each, then DARK_STREAM_T batched steps of the
    S streams (S clips of one frame; the memo rolled every second frame)
    against each stream's clip alone, detections as sets. Returns the
    launch counts (A-G) of the CLI run and of (2), and B's and D's bodies
    there."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        VIDModel)
    from lowlightenvironmentvideoobjectdetection_torch.apis.test import (
        evaluate_bbox)
    from lowlightenvironmentvideoobjectdetection_torch.config import (
        load_config)
    from lowlightenvironmentvideoobjectdetection_torch.data.loader import (
        build_dataset)
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        selsa as S)
    t_phase = time.perf_counter()
    cfg_path = str(REPO / LSTM_CFG)
    frames, videos = DATA_TREE["frames"], DATA_TREE["videos"]
    n = frames * videos
    per_run = (2 * n, n + videos, 0, 0, 0, 0, 0)
    plain, _ = eval_reference(dev, cfg_path, root, ann, kernels)
    gts = f"{root}/dark_gts.json"
    thr, n_gts = eval_gts(ann, plain, gts)
    test_cfg = load_config(cfg_path)["data"]["test"]
    ds = build_dataset(dict(test_cfg, ann_file=gts, img_prefix=f"{root}/"),
                       test_mode=True)
    plain_map = evaluate_bbox(plain, [ds.get_ann_info(i)
                                      for i in ds.data_infos])["mAP50"]
    f32 = eval_cli("dark_stream f32", [cfg_path] + eval_options(root, gts, 0)
                   + ["model.compute_dtype=float32"], kernels, per_run)
    f32_map = f32["out"]["metrics"]["mAP50"]
    cli_counts = f32["counts"]
    bodies = {k: dict(f32["bodies"][k])
              for k in ("roi_align", "roi_align_backward")}
    if plain_map != 1.0 or f32_map < EVAL_F32_MAP:
        raise AssertionError(f"dark_stream: mAP50 plain {plain_map}, "
                             f"kernels {f32_map}")

    # (2) S streams of ResNetC, batched against alone
    vid = VIDModel(device=dev, backbone_variant="ResNetC", num_classes=8,
                   compute_dtype=torch.float32)
    model, anchors, cfg = vid.model, vid.anchors, vid.cfg
    probe = OffsetProbe(model)
    g = torch.Generator().manual_seed(6)
    hw = (cfg.pad_h, cfg.pad_w, 3)
    refs = torch.randn((DARK_STREAM_S, cfg.num_ref_frames) + hw,
                       generator=g)
    frames = torch.randn((DARK_STREAM_S, DARK_STREAM_T) + hw,
                         generator=g).to(dev)
    shapes = torch.tensor([[cfg.pad_h, cfg.pad_w]] * DARK_STREAM_S,
                          dtype=torch.float32, device=dev)
    sfs = torch.ones(DARK_STREAM_S, 4, device=dev)
    perturb_offsets(probe, lambda: model.extract_feat(frames[:1, 0]), dev)
    reset_counts(*kernels)
    with probe:
        memos = [S.init_video_state(model, refs[s].to(dev), shapes[s],
                                    anchors) for s in range(DARK_STREAM_S)]
        fill_e = kernels[4].launches
        _, bdets = S.inference_clip_batch(
            model, S.stack_video_states(memos), frames, shapes, sfs, anchors,
            update_memo=True, frame_stride=2)
        batch_e = kernels[4].launches - fill_e
        sets = []
        for s in range(DARK_STREAM_S):
            _, odets = S.inference_clip(model, memos[s], frames[s], shapes[s],
                                        sfs[s], anchors, update_memo=True,
                                        frame_stride=2)
            sets += [match_sets(type(odets)(*(f[t] for f in odets)),
                                type(bdets)(*(f[s, t] for f in bdets)))
                     for t in range(DARK_STREAM_T)]
    s_counts = [k.launches for k in kernels]
    add_counts(bodies, dict(roi_align=kernels[1].body_launches,
                            roi_align_backward=kernels[3].body_launches))
    calls = DARK_STREAM_T * dark_dcn_calls(model.backbone, 1)
    want_e = (DARK_STREAM_S * dark_dcn_calls(model.backbone,
                                             cfg.num_ref_frames)
              + calls + DARK_STREAM_S * calls)
    if s_counts[4:] != [want_e, 0, 0] or batch_e != calls:
        raise AssertionError(f"dark_stream: E, F, G launches {s_counts[4:]}"
                             f" (batched step {batch_e}), want {want_e}")
    unmatched = sum(x["unmatched"] for x in sets)
    phase("dark_stream", card=smi, config=LSTM_CFG, gts=dict(
              count=n_gts, score_threshold=thr),
          plain_f32_map50=plain_map, kernel_f32_map50=f32_map,
          kernel_f32_gate=EVAL_F32_MAP, cli_launches=dict(
              zip(KERNEL_NAMES, cli_counts)),
          batched=dict(variant="ResNetC", streams=DARK_STREAM_S,
                       frames=DARK_STREAM_T, memo_frames=cfg.num_ref_frames,
                       sets=sets,
                       offsets=offset_range(probe.stats),
                       launches=dict(zip(KERNEL_NAMES, s_counts))),
          phase_s=time.perf_counter() - t_phase)
    if unmatched or any(x["n_got"] != x["n_want"] for x in sets):
        raise AssertionError("dark_stream: a stream of the batch differs "
                             "from the stream alone")
    del vid, model, memos, frames
    torch.cuda.empty_cache()
    return [a + b for a, b in zip(cli_counts, s_counts)], bodies


def fastdvd_train(dev, smi, kernels, root, ann):
    """The denoise-then-detect baselines through the CLI from the
    data_train tree: ``llvod_fastdvd_darkfarm.py`` (FastDVDnet over each
    frame's edge-replicated 5-frame window; FASTDVD_STEPS steps) and
    ``llvod_unet_darkfarm.py`` (a per-frame U-Net; UNET_STEPS steps), then
    SELSA on the denoised frames; the loader in the main process. B and D
    twice a step, no E, F or G, ``loss_denoise`` finite, every
    ``denoiser.`` leaf changed, the stem and stage 1 bit-identical.
    Returns the launch counts (A-G) and B's and D's bodies."""
    t = time.perf_counter()
    out, counts, bodies = {}, [0] * len(kernels), {}
    for name, cfg_path, n_steps in (("fastdvd", FASTDVD_CFG, FASTDVD_STEPS),
                                    ("unet", UNET_CFG, UNET_STEPS)):
        run, same, moved = dark_cli_train(
            f"fastdvd_train {name}", cfg_path, root, ann, kernels,
            (0, 2, 0, 2, 0, 0, 0), n_steps, n_steps - 1, 0,
            frozen=tuple("selsa." + f for f in FROZEN),
            moving=("denoiser.",))
        den = [m["loss_denoise"] for m in run["metrics"]]
        if not all(np.isfinite(den)):
            raise AssertionError(f"fastdvd_train {name}: loss_denoise {den}")
        out[name] = dict(config=cfg_path, steps=n_steps,
                         step_ms=run["step_ms"], loss_denoise=den,
                         loss_per_step=[m["loss"] for m in run["metrics"]],
                         device_window=run["window"],
                         peak_mem_gb=run["peak_gb"],
                         denoiser_leaves_changed=sum(
                             n.startswith("denoiser.") for n in moved))
        counts = [a + b for a, b in zip(counts, run["counts"])]
        add_counts(bodies, run["bodies"])
    phase("fastdvd_train", card=smi, runs=out,
          launches=dict(zip(KERNEL_NAMES, counts)),
          phase_s=time.perf_counter() - t)
    return counts, bodies


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


def cli_run(name, argv, kernels, per_step, n_steps, skip,
            keep_model=False):
    """The port's CLI (``tools/train.py::main``) on ``argv`` + ``--steps
    n_steps``, on the card, with every launch count reset just before:
    checks ``per_step`` launches a step of each of ``kernels`` (A-G), B's
    7x7 gather and D's 7x7 scatter bodies, the step count and finite
    metrics. Returns the run: counts, bodies, step ms, metrics, the
    loader's timings, the profiled window and the peak memory in GiB (with
    ``keep_model`` also the trained model)."""
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
    if keep_model:
        run["model"] = out["state"].model
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
    return {name: decode_ms(lambda: image_io.imread(p), 3)
            for name, p in (("none", path), ("paeth", paeth))}


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
                  kernels, per_step, RAW_STEPS, RAW_STEPS - 1)
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


# ---- evaluation: the tree's frames through the test API and the CLIs

def eval_options(root, ann, workers):
    return ["--cfg-options", f"data.test.ann_file={ann}",
            f"data.test.img_prefix={root}/",
            f"data.workers_per_gpu={workers}"]


def eval_gts(ann, det_lists, path, videos=None):
    """The tree's annotation file with the detections ``det_lists`` (one
    per frame, in dataset order) as its gts, written to ``path``: every
    detection scored above a threshold, which starts at EVAL_GT_SCORE and
    rises above the (EVAL_GTS_PER_FRAME + 1)-th score of every frame and
    above every box narrower or lower than 1 px (no gt can be such a box),
    as COCO xywh in original coordinates (x + w gives back x2 exactly).
    With ``videos`` only those video ids (and their frames) are kept.
    Every other detection then scores below every gt, so the run that
    made them has an mAP50 of 1 against them. Returns the threshold and
    the number of gts."""
    with open(ann) as f:
        data = json.load(f)
    images = sorted(data["images"],
                    key=lambda im: (im["video_id"], im["frame_id"]))
    rows = [per_class_rows(d) for d in det_lists]
    thr = EVAL_GT_SCORE
    for r in rows:
        scores = sorted((s for _, _, s in r), reverse=True)
        if len(scores) > EVAL_GTS_PER_FRAME:
            thr = max(thr, scores[EVAL_GTS_PER_FRAME])
        thr = max([thr] + [s for _, b, s in r
                           if b[2] - b[0] < 1 or b[3] - b[1] < 1])
    anns = []
    for img, r in zip(images, rows):
        if videos is not None and img["video_id"] not in videos:
            continue
        for c, b, s in r:
            if s > thr:
                x1, y1, x2, y2 = (float(v) for v in b)
                anns.append(dict(
                    id=len(anns) + 1, image_id=img["id"],
                    video_id=img["video_id"], category_id=c + 1,
                    bbox=[x1, y1, x2 - x1, y2 - y1],
                    area=(x2 - x1) * (y2 - y1), iscrowd=0,
                    instance_id=len(anns) + 1))
    if videos is not None:
        data["videos"] = [v for v in data["videos"] if v["id"] in videos]
        data["images"] = [im for im in data["images"]
                          if im["video_id"] in videos]
    data["annotations"] = anns
    with open(path, "w") as f:
        json.dump(data, f)
    return thr, len(anns)


def eval_reference(dev, cfg_path, root, ann, kernels):
    """The plain path on the card at f32: ``apis/test.py``'s
    ``single_device_test`` over the config's test split with the
    ``VIDModel`` the test CLI builds (seed 0) at f32, its kernels' plain
    versions (``impl = "plain"``), the loader in the main process. No
    kernel launches. Returns the per-frame results and the seconds."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        VIDModel)
    from lowlightenvironmentvideoobjectdetection_torch.apis.test import (
        single_device_test)
    from lowlightenvironmentvideoobjectdetection_torch.config import (
        Config, apply_cli_options)
    from lowlightenvironmentvideoobjectdetection_torch.data.loader import (
        build_dataset)
    from lowlightenvironmentvideoobjectdetection_torch.data.pipelines import (
        Compose)
    from lowlightenvironmentvideoobjectdetection_torch.models.builder import (
        vid_model_kwargs)
    cfg = Config.fromfile(cfg_path)
    apply_cli_options(cfg, eval_options(root, ann, 0)[1:])
    d = cfg["data"]["test"]
    kw = vid_model_kwargs(cfg["model"], d.get("ref_img_sampler"))
    kw["compute_dtype"] = torch.float32
    model = VIDModel(device=dev, **kw)
    model.impl = "plain"
    reset_counts(*kernels)
    t = time.perf_counter()
    dets, _ = single_device_test(model, build_dataset(d, test_mode=True),
                                 Compose(d["pipeline"], device=dev))
    seconds = time.perf_counter() - t
    if any(k.launches for k in kernels):
        raise AssertionError("eval: the plain run launched a kernel")
    return dets, seconds


def eval_cli(name, argv, kernels, want_counts, window=None, classes=8):
    """The port's test CLI (``tools/test.py::main``) on ``argv``, on the
    card, every launch count reset just before: checks ``want_counts``
    launches of ``kernels`` (A-G) and finite per-class [N, 5] results of
    ``classes`` classes.
    ``window`` (a ``StepWindow``) is called after each frame. Returns the
    CLI's output, its detections, counts and bodies, wall seconds and
    peak memory in GiB."""
    import functools
    from lowlightenvironmentvideoobjectdetection_torch.tools import (
        test as cli)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    real = cli.multi_device_test
    if window is not None:
        cli.multi_device_test = functools.partial(real, progress_fn=window)
    t = time.perf_counter()
    try:
        out = cli.main(argv)
    finally:
        cli.multi_device_test = real
    run = dict(out=out, wall_s=time.perf_counter() - t,
               counts=[k.launches for k in kernels],
               bodies={n: dict(k.body_launches) for n, k in zip(
                   ("attention", "roi_align", "roi_align_backward"),
                   (kernels[0], kernels[1], kernels[3]))},
               peak_gb=torch.cuda.max_memory_allocated() / 2**30,
               dets=[[np.asarray(b, np.float32).reshape(-1, 5)
                      for b in r["bbox_results"]] for r in out["results"]])
    if run["counts"] != list(want_counts):
        raise AssertionError(f"{name}: launch counts {run['counts']}, want "
                             f"{list(want_counts)}")
    for d in run["dets"]:
        if len(d) != classes or not all(np.isfinite(x).all() for x in d):
            raise AssertionError(f"{name}: bad per-class results")
    return run


def eval_times(run, frames):
    """Per-frame host ms of a CLI run (``timings``: the loader's wait and
    device stages, and the step): frames/s over the loop, each video's
    frame 0 (its memo fill; every frame of a 10-frame video is among its
    14 references, so its decoding happens there), the median and highest
    of the second video's other frames (the first video's are under the
    profiler), the decode, device-stage and step ms a frame and the
    peak."""
    t = run["out"]["timings"]
    ms = [r["wait_ms"] + r["device_ms"] + r["step_ms"] for r in t]
    steady = ms[frames + 1:]
    return dict(
        frames_per_s=len(ms) / (sum(ms) / 1e3),
        frames_per_s_after_first=(len(ms) - 1) / (sum(ms[1:]) / 1e3),
        cli_fps=run["out"]["summary"]["fps"], cli_wall_s=run["wall_s"],
        frame0_ms=ms[::frames], frame0_wait_ms=[r["wait_ms"]
                                               for r in t[::frames]],
        median_steady_frame_ms=statistics.median(steady),
        max_steady_frame_ms=max(steady),
        median_steady_step_ms=statistics.median(
            r["step_ms"] for r in t[frames + 1:]),
        # every frame's pair is decoded once: these are a frame's shares
        decode_ms_per_frame=sum(r["host_ms"] for r in t) / len(t),
        device_stage_ms_per_frame=sum(r["device_ms"] for r in t) / len(t),
        step_ms_per_frame=sum(r["step_ms"] for r in t) / len(t),
        frame_ms=ms, peak_mem_gb=run["peak_gb"])


def eval_phase(dev, smi, kernels, root, ann):
    """The canonical config's test split from the ``data_train`` tree (2
    videos x 10 PNG pairs at 1080x1920) through the evaluation path, at
    full width (608x1024, 8 classes, TemporalRoIAlign with 3 shared FCs,
    14 adaptive-stride references, seeded weights): the plain path at f32
    (``eval_reference``), whose detections become the gts (``eval_gts``;
    its own mAP50 must be 1); the kernel path at f32 through the test CLI
    against them (mAP50 at least EVAL_F32_MAP, per-frame detection sets
    against the plain run's); the config's bf16 through the CLI with
    EVAL_WORKERS loader processes, its mAP50 and times, the device's idle
    share over the first video's steady frames; every CLI run launching A
    3 times and B once a frame and B once more a memo fill, A on the body
    of its dtype and B on the 7x7 gather. Then the training CLI for
    EVAL_HOOK_STEPS steps with ``evaluation.interval`` at that count and
    ``data.val`` the first video's gts: its ``eval: mAP50=`` line within
    EVAL_HOOK_TOL of the test CLI's on the final checkpoint. Returns the
    launch counts (A-G) of the bf16 runs and the hook's run, and B's and
    D's bodies there."""
    import io
    from lowlightenvironmentvideoobjectdetection_torch.apis.test import (
        evaluate_bbox)
    from lowlightenvironmentvideoobjectdetection_torch.config import (
        load_config)
    from lowlightenvironmentvideoobjectdetection_torch.data.loader import (
        build_dataset)
    from lowlightenvironmentvideoobjectdetection_torch.tools import (
        test as cli, train as train_cli)
    t_phase = time.perf_counter()
    cfg_path = str(REPO / CANONICAL_CFG)
    frames, videos = DATA_TREE["frames"], DATA_TREE["videos"]
    n = frames * videos
    # A three times a frame (one a shared FC), B once a frame and once a
    # memo fill (one a video)
    per_run = (3 * n, n + videos, 0, 0, 0, 0, 0)

    from lowlightenvironmentvideoobjectdetection_torch.models.roi_heads import (  # noqa: E501
        temporal_roi_align as troi)
    with TopKPin(troi) as plain_pin:  # records TROI's choices frame by frame
        plain, plain_s = eval_reference(dev, cfg_path, root, ann, kernels)
    gts = f"{root}/eval_gts.json"
    thr, n_gts = eval_gts(ann, plain, gts)
    test_cfg = load_config(cfg_path)["data"]["test"]
    ds = build_dataset(dict(test_cfg, ann_file=gts, img_prefix=f"{root}/"),
                       test_mode=True)
    anns = [ds.get_ann_info(info) for info in ds.data_infos]
    plain_map = evaluate_bbox(plain, anns)["mAP50"]
    if plain_map != 1.0:
        raise AssertionError(f"eval: the plain run's own mAP50 {plain_map}")

    f32 = eval_cli("eval f32", [cfg_path] + eval_options(root, gts, 0)
                   + ["model.compute_dtype=float32"], kernels, per_run)
    check_bodies("eval f32 attention", kernels[0], fma=3 * n, mma=0)
    check_bodies("eval f32 roi_align", kernels[1], gather7x2=n + videos,
                 gather14x2=0)
    f32_map = f32["out"]["metrics"]["mAP50"]
    sets = [match_rows(per_class_rows(g), per_class_rows(w))
            for g, w in zip(f32["dets"], plain)]
    if f32_map < EVAL_F32_MAP:
        raise AssertionError(f"eval: f32 kernel path mAP50 {f32_map} < "
                             f"{EVAL_F32_MAP}; sets {sets}")
    # O1: the same run with TROI's top-k pinned to the plain run's, call by
    # call: what is left unmatched is not a top-k choice
    with TopKPin(troi, plain_pin.indices) as pin:
        pinned = eval_cli("eval f32 pinned", [cfg_path]
                          + eval_options(root, gts, 0)
                          + ["model.compute_dtype=float32"], kernels,
                          per_run)
    if len(pin.indices) != len(plain_pin.indices):
        raise AssertionError(f"eval pinned: {len(pin.indices)} top-k calls, "
                             f"the plain run {len(plain_pin.indices)}")
    pinned_sets = [match_rows(per_class_rows(g), per_class_rows(w))
                   for g, w in zip(pinned["dets"], plain)]
    pinned_unmatched = sum(x["unmatched"] for x in pinned_sets)
    first = next((i for i, x in enumerate(pinned_sets) if x["unmatched"]),
                 None)
    o1 = dict(unpinned_unmatched=sum(x["unmatched"] for x in sets),
              unpinned_rows=sum(x["n_want"] for x in sets),
              pinned_unmatched=pinned_unmatched,
              pinned_rows=sum(x["n_want"] for x in pinned_sets),
              topk_calls=len(pin.indices), topk_rows_flipped=pin.flips,
              first_unmatched_frame=first,
              pinned_max_box_px=max(x["box"] for x in pinned_sets),
              pinned_max_score=max(x["score"] for x in pinned_sets),
              pinned_map50=pinned["out"]["metrics"]["mAP50"])
    print("eval_o1: " + json.dumps(o1), flush=True)
    if pinned_unmatched:
        raise AssertionError(f"eval: {pinned_unmatched} f32 rows unmatched "
                             f"with TROI's top-k pinned, from frame {first}: "
                             f"{pinned_sets[first]}")
    del pinned

    runs, counts, bodies = {}, [0] * len(kernels), {}
    for workers in EVAL_WORKERS:
        window = StepWindow(frames, 1)
        run = eval_cli(f"eval bf16 workers={workers}",
                       [cfg_path] + eval_options(root, gts, workers),
                       kernels, per_run, window)
        check_bodies("eval bf16 attention", kernels[0], fma=0, mma=3 * n)
        check_bodies("eval bf16 roi_align", kernels[1], gather7x2=n + videos,
                     gather14x2=0)
        runs[workers] = dict(mAP50=run["out"]["metrics"]["mAP50"],
                             device_window=window.window,
                             loader_ms_per_frame=run["out"]["timings"],
                             **eval_times(run, frames))
        counts = [a + b for a, b in zip(counts, run["counts"])]
        for k, v in run["bodies"].items():
            total = bodies.setdefault(k, {})
            for body, c in v.items():
                total[body] = total.get(body, 0) + c
    if runs[EVAL_WORKERS[0]]["mAP50"] != runs[EVAL_WORKERS[1]]["mAP50"]:
        raise AssertionError("eval: bf16 mAP50 depends on the workers")

    # the training CLI's eval hook on the first video, then the test CLI
    # on its final checkpoint
    one = f"{root}/eval_gts_video1.json"
    eval_gts(ann, plain, one, videos={1})
    val = dict(test_cfg, ann_file=one, img_prefix=f"{root}/")
    work = f"{root}/work_eval"
    printed = io.StringIO()
    torch.cuda.synchronize()
    reset_counts(*kernels)
    with contextlib.redirect_stdout(printed):
        hook = train_cli.main(
            [cfg_path, "--seed", "0", "--work-dir", work, "--steps",
             str(EVAL_HOOK_STEPS)] + data_options(root, ann, 0)
            + [f"evaluation.interval={EVAL_HOOK_STEPS}",
               f"data.val={val!r}"])
    print(printed.getvalue(), end="", flush=True)
    hook_counts = [k.launches for k in kernels]
    want = [p * EVAL_HOOK_STEPS + e for p, e in zip(
        DATA_PER_STEP, (3 * frames, frames + 1, 0, 0, 0, 0, 0))]
    if hook_counts != want:
        raise AssertionError(f"eval hook: launch counts {hook_counts}, want "
                             f"{want}")
    check_bodies("eval hook attention", kernels[0], fma=0, mma=3 * frames)
    counts = [a + b for a, b in zip(counts, hook_counts)]
    for name, k in (("roi_align", kernels[1]),
                    ("roi_align_backward", kernels[3])):
        for body, c in k.body_launches.items():
            bodies[name][body] = bodies[name].get(body, 0) + c
    lines = [x for x in printed.getvalue().splitlines()
             if x.startswith("eval: mAP50=")]
    if len(lines) != 1 or len(hook["evals"]) != 1:
        raise AssertionError(f"eval hook: lines {lines}")
    hook_map = hook["evals"][0]["mAP50"]
    del hook
    torch.cuda.empty_cache()
    reset_counts(*kernels)
    after = cli.main([cfg_path, "--checkpoint",
                      f"{work}/step_{EVAL_HOOK_STEPS}.pt"]
                     + eval_options(root, one, 0))
    cli_map = after["metrics"]["mAP50"]
    if abs(hook_map - cli_map) > EVAL_HOOK_TOL:
        raise AssertionError(f"eval hook: mAP50 {hook_map} against the test "
                             f"CLI's {cli_map}")
    if abs(float(lines[0].split("=")[1]) - cli_map) > EVAL_HOOK_TOL:
        raise AssertionError(f"eval hook: line {lines[0]}, CLI {cli_map}")

    phase("eval", card=smi, config=CANONICAL_CFG, tree=DATA_TREE,
          phase_s=time.perf_counter() - t_phase, plain_f32_s=plain_s,
          gts=dict(count=n_gts, score_threshold=thr,
                   most_a_frame=EVAL_GTS_PER_FRAME),
          plain_f32_map50=plain_map, kernel_f32_map50=f32_map,
          kernel_f32_gate=EVAL_F32_MAP,
          kernel_f32_vs_plain_sets=dict(
              unmatched=sum(x["unmatched"] for x in sets),
              frames_with_unmatched=sum(1 for x in sets if x["unmatched"]),
              max_box_px=max(x["box"] for x in sets),
              max_score=max(x["score"] for x in sets),
              nearest_unmatched_in_tols=max(x["nearest_unmatched"]
                                            for x in sets),
              top_unmatched_score=max(x["top_unmatched_score"]
                                      for x in sets),
              detections=[x["n_got"] for x in sets],
              tolerances=dict(box_px=SET_BOX_TOL, score=SET_SCORE_TOL)),
          topk_pinned=o1,
          bf16_map50=runs[EVAL_WORKERS[0]]["mAP50"],
          bf16_by_workers=runs, launches_per_run=dict(zip(KERNEL_NAMES,
                                                          per_run)),
          hook=dict(steps=EVAL_HOOK_STEPS, line=lines[0], map50=hook_map,
                    test_cli_map50=cli_map, tol=EVAL_HOOK_TOL))
    return counts, bodies


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


# ---- the flow-based ImageNet-VID families: FGFA, DFF (and SELSA training)

def flow_profiled(fn, n):
    """``fn()`` n times under ``torch.profiler``, synchronised before and
    after: the device's busy ms a call (the union of its kernels'
    intervals), the wall ms a call and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    from lowlightenvironmentvideoobjectdetection_torch.tools.stage_profile import (  # noqa: E501
        union_ms)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == StepWindow.DEVICE]
    if not dev:
        raise RuntimeError("the profiler recorded no device events")
    busy = union_ms([(e.time_range.start, e.time_range.end) for e in dev])
    return dict(calls=n, busy_ms_per_call=busy / n, wall_ms_per_call=wall / n,
                idle_share=1.0 - busy / wall)


def flow_vid_model(cfg_path, dev, **overrides):
    """The ``VIDModel`` the test CLI builds for ``cfg_path`` (seed 0)."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        VIDModel)
    from lowlightenvironmentvideoobjectdetection_torch.config import (
        load_config)
    from lowlightenvironmentvideoobjectdetection_torch.models.builder import (
        vid_model_kwargs)
    cfg = load_config(str(REPO / cfg_path))
    kw = vid_model_kwargs(cfg["model"],
                          cfg["data"]["test"].get("ref_img_sampler"))
    kw.update(overrides)
    return VIDModel(device=dev, **kw)


def flow_stream(name, model, frames, refs, kernels):
    """Stream the raw frames through ``inference_vid`` (``refs`` at frame 0)
    with every launch count reset just before: per-frame host ms, the
    launch counts (A-G) and B's bodies, the peak memory in GiB, the
    per-class results (finite, 30 classes)."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        inference_vid)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    lat, results = [], []
    for fid, frame in enumerate(frames):
        t = time.perf_counter()
        out = inference_vid(model, frame, fid,
                            ref_frames=refs if fid == 0 else None)
        lat.append((time.perf_counter() - t) * 1e3)
        results.append(out["bbox_results"])
    run = dict(ms=lat, counts=[k.launches for k in kernels],
               bodies=dict(roi_align=dict(kernels[1].body_launches),
                           roi_align_backward=dict(kernels[3].body_launches)),
               peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    n = len(frames)
    if run["counts"] != [0, n, 0, 0, 0, 0, 0]:
        raise AssertionError(f"{name}: launch counts {run['counts']} for {n} "
                             "frames, want one of B a frame")
    check_bodies(f"{name} roi_align", kernels[1], gather7x2=n, gather14x2=0)
    for res in results:
        if len(res) != 30 or not all(r.ndim == 2 and r.shape[1] == 5
                                     and np.isfinite(r).all() for r in res):
            raise AssertionError(f"{name}: bad per-class results")
    run["detections"] = [sum(len(r) for r in res) for res in results]
    return run


def flow_agree(name, family, dev, kernels):
    """f32, TF32 off: FLOW_AGREE_FRAMES streamed frames of the config's
    model through kernel B and through the plain RoIAlign from one memo:
    detections as sets (``match_sets``). Returns the sets."""
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        fgfa as FG)
    cfg_path = FGFA_CFG if family == "FGFA" else DFF_CFG
    m32 = flow_vid_model(cfg_path, dev, compute_dtype=torch.float32)
    model, cfg = m32.model, m32.cfg
    g = torch.Generator().manual_seed(9)
    hw = (cfg.pad_h, cfg.pad_w, 3)
    frames = torch.randn((FLOW_AGREE_FRAMES,) + hw, generator=g).to(dev)
    shape = torch.tensor([600.0, 1000.0], device=dev)
    sf = torch.ones(4, device=dev)
    if family == "FGFA":
        refs = torch.randn((cfg.num_ref_frames,) + hw, generator=g).to(dev)
        states = [FG.fgfa_init_state(model, refs) for _ in range(2)]
        step = FG.fgfa_inference_step
    else:
        states = [FG.dff_init_state() for _ in range(2)]
        step = FG.dff_inference_step
    sets = []
    for t in range(FLOW_AGREE_FRAMES):
        reset_counts(*kernels)
        states[0], got = step(model, states[0], frames[t], shape, sf,
                              m32.anchors)
        if kernels[1].launches != 1:
            raise AssertionError(f"{name}: the kernel path launched B "
                                 f"{kernels[1].launches} times")
        states[1], want = step(model, states[1], frames[t], shape, sf,
                               m32.anchors, impl="plain")
        sets.append(match_sets(got, want))
    if any(x["unmatched"] or x["n_got"] != x["n_want"] for x in sets):
        raise AssertionError(f"{name}: f32 kernel path against plain: {sets}")
    del m32, model, states
    torch.cuda.empty_cache()
    return sets


def fgfa_stream(dev, smi, kernels):
    """``fgfa_faster_rcnn_r50_dc5_1x_imagenetvid.py`` through ``VIDModel``
    at full width (608x1024, 30 classes, bf16 detector; FlowNetSimple, the
    warp and the EmbedAggregator f32; a memo of 14 frames and maps), seeded
    weights, random 600x1000 frames: frame 0 fills the memo from 14
    reference frames, FLOW_STEADY more frames are timed, FLOW_PROFILED more
    give the device's busy and idle share; kernel B once a frame (FGFA's
    memo fill runs no RoIAlign). Then the split of a steady frame (CUDA
    events, the step without the memo's roll): backbone and neck,
    FlowNetSimple over the 14 (frame, memo) pairs, the warp of the 14 memo
    maps, ``F.grid_sample`` alone at those shapes, the EmbedAggregator,
    the rest (RPN, proposals, RoIAlign, head, decode); then the f32 kernel
    path against the plain path (``flow_agree``). Returns the launch counts
    (A-G) of the stream and B's bodies."""
    import torch.nn.functional as F
    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        inference_vid)
    from lowlightenvironmentvideoobjectdetection_torch.data.preprocess import (
        prepare_frames)
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        fgfa as FG)
    from lowlightenvironmentvideoobjectdetection_torch.ops.grid_sample import (
        flow_warp_feats, grid_sample)
    t_phase = time.perf_counter()
    rng = np.random.RandomState(8)
    n = 1 + FLOW_STEADY + FLOW_PROFILED
    raw = rng.randint(0, 256, (n,) + RAW_HW + (3,)).astype(np.uint8)
    model = flow_vid_model(FGFA_CFG, dev)
    cfg = model.cfg
    refs = rng.randint(0, 256, (cfg.num_ref_frames,) + RAW_HW + (3,)
                       ).astype(np.uint8)
    main = flow_stream("fgfa_stream", model, raw[:1 + FLOW_STEADY], refs,
                       kernels)
    frames = iter(range(1 + FLOW_STEADY, n))
    window = flow_profiled(lambda: inference_vid(model, raw[next(frames)],
                                                 1), FLOW_PROFILED)
    counts = [k.launches for k in kernels]  # the stream's, profiled too
    if counts != [0, n, 0, 0, 0, 0, 0]:
        raise AssertionError(f"fgfa_stream: launch counts {counts}")
    check_bodies("fgfa_stream roi_align", kernels[1], gather7x2=n,
                 gather14x2=0)
    bodies = dict(roi_align=dict(kernels[1].body_launches),
                  roi_align_backward={})
    st = model.state
    memo = cfg.num_ref_frames
    if (st.ref_feats.shape != (memo, *cfg.feat_hw, cfg.neck_channels)
            or st.ref_feats.dtype != cfg.compute_dtype
            or st.next_slot != n % memo):
        raise AssertionError("fgfa_stream: bad memo")

    # the split of a steady frame
    m = model.model
    imgs, img_shape, sf = prepare_frames(raw[:1], cfg.pad_h, cfg.pad_w,
                                         device=dev)
    frame, sf = imgs[0], torch.as_tensor(sf, device=dev)
    with torch.no_grad():
        key = m.extract_feat(frame[None])[0]
        flows = m.compute_flow(frame, st.ref_imgs)
        warped = flow_warp_feats(st.ref_feats, flows)
        stack = torch.cat([key[None].float(), warped])
        grid = torch.rand(st.ref_feats.shape[:3] + (2,), generator=torch
                          .Generator().manual_seed(3)).to(dev) * 2 - 1
        maps32 = st.ref_feats.float().permute(0, 3, 1, 2)
        split = dict(
            step=timed(lambda: FG.fgfa_inference_step(
                m, st, frame, img_shape, sf, model.anchors,
                update_memo=False), iters=5, warmup=2),
            backbone_neck=timed(lambda: m.extract_feat(frame[None]),
                                iters=5, warmup=2),
            flownet_14_pairs=timed(lambda: m.compute_flow(
                frame, st.ref_imgs), iters=5, warmup=2),
            warp_14_maps=timed(lambda: flow_warp_feats(st.ref_feats, flows)),
            aggregator=timed(lambda: m.aggregator(key[None], stack)))
        split["rest"] = split["step"] - sum(
            split[k] for k in ("backbone_neck", "flownet_14_pairs",
                               "warp_14_maps", "aggregator"))
        # the aggregator's f32 conv on the 15 candidate maps, and on 16 (the
        # key and the candidates in one call, which cuDNN runs with another
        # algorithm): why the EmbedAggregator embeds the key apart
        conv = m.aggregator.embed_conv0
        x15 = stack.permute(0, 3, 1, 2).contiguous()
        x16 = torch.cat([key[None].float(), stack]).permute(0, 3, 1, 2
                                                            ).contiguous()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        conv_maps = dict(maps15_ms=timed(lambda: conv(x15), iters=5,
                                         warmup=2),
                         maps16_ms=timed(lambda: conv(x16), iters=5,
                                         warmup=2),
                         peak_extra_gb=(torch.cuda.max_memory_allocated()
                                        - base) / 2**30)
        del x15, x16
        gs = dict(
            wrapper_bf16_maps=timed(lambda: grid_sample(
                st.ref_feats, grid, align_corners=True,
                padding_mode="border")),
            f32_nchw=timed(lambda: F.grid_sample(
                maps32, grid, mode="bilinear", padding_mode="border",
                align_corners=True)),
            # each map read once (bf16), each output written once (f32)
            bound_ms=st.ref_feats.numel() * (st.ref_feats.element_size() + 4)
            / HBM_BYTES_PER_S * 1e3)
    sets = flow_agree("fgfa_stream agree", "FGFA", dev, kernels)
    steady = main["ms"][1:]
    phase("fgfa_stream", card=smi, config=FGFA_CFG, memo_frames=memo,
          frames=n, memo_fill_frame0_ms=main["ms"][0],
          median_frame_ms=statistics.median(steady),
          min_frame_ms=min(steady), max_frame_ms=max(steady),
          frame_ms=steady, device_window=window, peak_mem_gb=main["peak_gb"],
          split_ms=split, aggregator_conv=conv_maps,
          grid_sample_memo_maps_ms=dict(
              maps=list(st.ref_feats.shape), **gs),
          launches=dict(zip(KERNEL_NAMES, counts)),
          detections_per_frame=main["detections"],
          f32_kernel_vs_plain_sets=sets, phase_s=time.perf_counter() - t_phase)
    del model, m, st, stack, warped, flows, maps32
    torch.cuda.empty_cache()
    return counts, bodies


def dff_stream(dev, smi, kernels):
    """``dff_faster_rcnn_r50_dc5_1x_imagenetvid.py`` (``key_frame_interval``
    10) through ``VIDModel`` at full width, bf16, seeded weights, DFF_FRAMES
    random 600x1000 frames: key frames (0, 10, 20: the backbone) against
    the others (FlowNetSimple on one pair and the warp of the key's map);
    kernel B once a frame; then the f32 kernel path against the plain path
    over a key frame and two warped ones. Returns the launch counts (A-G)
    and B's bodies."""
    t_phase = time.perf_counter()
    rng = np.random.RandomState(10)
    raw = rng.randint(0, 256, (DFF_FRAMES,) + RAW_HW + (3,)).astype(np.uint8)
    model = flow_vid_model(DFF_CFG, dev)
    kfi = model.model.key_frame_interval
    run = flow_stream("dff_stream", model, raw, None, kernels)
    key = [ms for i, ms in enumerate(run["ms"]) if i % kfi == 0]
    other = [ms for i, ms in enumerate(run["ms"]) if i % kfi]
    sets = flow_agree("dff_stream agree", "DFF", dev, kernels)
    phase("dff_stream", card=smi, config=DFF_CFG, key_frame_interval=kfi,
          frames=DFF_FRAMES, key_frame_ms=key, median_key_frame_ms=
          statistics.median(key[1:]), non_key_frame_ms=other,
          median_non_key_frame_ms=statistics.median(other),
          max_non_key_frame_ms=max(other), peak_mem_gb=run["peak_gb"],
          launches=dict(zip(KERNEL_NAMES, run["counts"])),
          detections_per_frame=run["detections"],
          f32_kernel_vs_plain_sets=sets, phase_s=time.perf_counter() - t_phase)
    del model
    torch.cuda.empty_cache()
    return run["counts"], run["bodies"]


def vid_train(dev, smi, kernels, prefix, ann):
    """The ImageNet-VID families' R50 configs (SELSA, FGFA, DFF) at full
    width through the port's training CLI from an ImageNet-VID tree of PNG
    frames (VID_TREE) with VID_WORKERS loader processes: VID_STEPS steps
    each (2 warm-up, VID_TIMED timed, the rest profiled for the idle
    share); B and D twice a step for SELSA (key and reference rois), once
    for FGFA and DFF; finite losses. Then ``fgfa_agree``. Returns the
    launch counts (A-G) and B's and D's bodies."""
    t = time.perf_counter()
    out, counts, bodies = {}, [0] * len(kernels), {}
    for name, cfg_path, per_step in (
            ("selsa", SELSA_CFG, (0, 2, 0, 2, 0, 0, 0)),
            ("fgfa", FGFA_CFG, (0, 1, 0, 1, 0, 0, 0)),
            ("dff", DFF_CFG, (0, 1, 0, 1, 0, 0, 0))):
        argv = [str(REPO / cfg_path), "--seed", "0", "--work-dir",
                f"{prefix}/../../work_{name}", "--cfg-options",
                f"data.train.ann_file={ann}",
                f"data.train.img_prefix={prefix}",
                f"data.workers_per_gpu={VID_WORKERS}"]
        run = cli_run(f"vid_train {name}", argv, kernels, per_step,
                      VID_STEPS, TRAIN_WARMUP + VID_TIMED)
        timed_ms = run["step_ms"][TRAIN_WARMUP:TRAIN_WARMUP + VID_TIMED]
        out[name] = dict(config=cfg_path, step_ms=run["step_ms"],
                         median_timed_step_ms=statistics.median(timed_ms),
                         loss_per_step=[m["loss"] for m in run["metrics"]],
                         device_window=run["window"],
                         loader_median_ms=loader_summary(run["timings"],
                                                         TRAIN_WARMUP),
                         peak_mem_gb=run["peak_gb"],
                         launches_per_step=dict(zip(KERNEL_NAMES, per_step)))
        counts = [a + b for a, b in zip(counts, run["counts"])]
        add_counts(bodies, run["bodies"])
    phase("vid_train", card=smi, tree=VID_TREE, workers=VID_WORKERS,
          steps=VID_STEPS, warmup_steps=TRAIN_WARMUP, runs=out,
          launches=dict(zip(KERNEL_NAMES, counts)),
          phase_s=time.perf_counter() - t)
    return counts, bodies


def fgfa_agree(dev, roi_align, roi_align_backward):
    """f32, TF32 off: one ``fgfa_loss`` and every parameter's gradient at
    full width (the FGFA config's model, a key and 2 references of
    ``train_sample``) through kernels B and D and through the plain
    RoIAlign, with the same uniforms; ``train_agree``'s tolerances. The
    plain run keeps the kernel run's ReLU decisions in the bbox head
    (``ReluPin``; the flips are counted: a shared FC's pre-activation
    within rounding of 0 takes the two paths to different sides)."""
    from lowlightenvironmentvideoobjectdetection_torch.models.builder import (
        build_model)
    from lowlightenvironmentvideoobjectdetection_torch.models.roi_heads import (  # noqa: E501
        bbox_head as bh)
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        fgfa as FG, selsa as S)
    from lowlightenvironmentvideoobjectdetection_torch.tools.train_profile import (  # noqa: E501
        train_sample)
    system = build_model(model_dict(FGFA_CFG, compute_dtype="float32"),
                         seed=0, device=dev)
    model, cfg = system.model, system.cfg
    sample = train_sample(cfg, dev, seed=4)
    uniforms = S.draw_loss_uniforms(cfg, 8, torch.Generator().manual_seed(4),
                                    dev)

    def run(impl, pin):
        model.zero_grad(set_to_none=True)
        with pin:
            loss, _ = FG.fgfa_loss(model, sample, system.anchors,
                                   uniforms=uniforms, impl=impl)
            loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters() if p.grad is not None}

    reset_counts(roi_align, roi_align_backward)
    kernel_pin = ReluPin(bh)
    lk, gk = run(None, kernel_pin)
    if (roi_align.launches, roi_align_backward.launches) != (1, 1):
        raise AssertionError("fgfa_agree: kernel path launches "
                             f"{roi_align.launches}, "
                             f"{roi_align_backward.launches}")
    pin = ReluPin(bh, kernel_pin.decisions)
    lp, gp = run("plain", pin)
    worst, worst_leaf = grad_agreement(gk, gp)
    loss_rel = abs(lk - lp) / abs(lp)
    phase("fgfa_agree", loss_kernel=lk, loss_plain=lp, loss_rel_err=loss_rel,
          head_relu_flips_pinned=pin.flips,
          loss_rtol=TRAIN_LOSS_RTOL, leaves=len(gp),
          worst_grad_err_over_tol=worst, worst_leaf=worst_leaf,
          grad_tolerance=dict(rel_to_leaf_max=TRAIN_GRAD_REL,
                              floor_rel_to_global_max=TRAIN_GRAD_FLOOR))
    if loss_rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"fgfa_agree: loss {lk} against {lp}")
    if worst > 1.0:
        raise AssertionError(f"fgfa_agree: gradient of {worst_leaf} off by "
                             f"{worst} tolerances")
    del system, model, gk, gp
    torch.cuda.empty_cache()


def vid_eval(dev, smi, kernels, prefix, ann):
    """FGFA and DFF on the ImageNet-VID tree's val split (VID_TREE's
    videos) at full width: the plain path at f32 (``eval_reference``)
    makes the gts (``eval_gts``; its own mAP50 must be 1), the kernel path
    at f32 through the test CLI scores mAP50 at least EVAL_F32_MAP against
    them, B once a frame. Returns the launch counts (A-G) of the CLI runs
    and B's bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.test import (
        evaluate_bbox)
    from lowlightenvironmentvideoobjectdetection_torch.config import (
        load_config)
    from lowlightenvironmentvideoobjectdetection_torch.data.loader import (
        build_dataset)
    t = time.perf_counter()
    n = VID_TREE["videos"] * VID_TREE["frames"]
    per_run = (0, n, 0, 0, 0, 0, 0)
    out, counts, bodies = {}, [0] * len(kernels), {}
    for name, cfg_path in (("fgfa", FGFA_CFG), ("dff", DFF_CFG)):
        path = str(REPO / cfg_path)
        plain, plain_s = eval_reference(dev, path, prefix, ann, kernels)
        gts = f"{prefix}/../../{name}_gts.json"
        thr, n_gts = eval_gts(ann, plain, gts)
        test_cfg = load_config(path)["data"]["test"]
        ds = build_dataset(dict(test_cfg, ann_file=gts,
                                img_prefix=f"{prefix}/"), test_mode=True)
        plain_map = evaluate_bbox(plain, [ds.get_ann_info(i)
                                          for i in ds.data_infos])["mAP50"]
        run = eval_cli(f"vid_eval {name} f32", [path]
                       + eval_options(prefix, gts, 0)
                       + ["model.compute_dtype=float32"], kernels, per_run,
                       classes=30)
        check_bodies(f"vid_eval {name} roi_align", kernels[1], gather7x2=n,
                     gather14x2=0)
        f32_map = run["out"]["metrics"]["mAP50"]
        sets = [match_rows(per_class_rows(g), per_class_rows(w))
                for g, w in zip(run["dets"], plain)]
        out[name] = dict(config=cfg_path, gts=dict(count=n_gts,
                                                   score_threshold=thr),
                         plain_f32_map50=plain_map, plain_f32_s=plain_s,
                         kernel_f32_map50=f32_map,
                         kernel_f32_cli_fps=run["out"]["summary"]["fps"],
                         unmatched_rows=sum(x["unmatched"] for x in sets),
                         peak_mem_gb=run["peak_gb"])
        if plain_map != 1.0 or f32_map < EVAL_F32_MAP:
            raise AssertionError(f"vid_eval {name}: mAP50 plain {plain_map}, "
                                 f"kernels {f32_map}")
        counts = [a + b for a, b in zip(counts, run["counts"])]
        add_counts(bodies, {k: run["bodies"][k] for k in (
            "roi_align", "roi_align_backward")})
    phase("vid_eval", card=smi, tree=VID_TREE, runs=out,
          kernel_f32_gate=EVAL_F32_MAP,
          launches=dict(zip(KERNEL_NAMES, counts)),
          phase_s=time.perf_counter() - t)
    return counts, bodies


# ---------------------------------------------------------------------------
# tracking: DeepSORT, Tracktor (MOT) and SiamRPN++ (SOT)


def mot_model(cfg_path, dev, tracker=None, **model_overrides):
    """The MOT model the test CLI builds for ``cfg_path`` (seed 0), with
    ``tracker`` entries over the config's tracker dict."""
    from lowlightenvironmentvideoobjectdetection_torch.config import (
        load_config)
    from lowlightenvironmentvideoobjectdetection_torch.models.builder import (
        build_mot_model)
    cfg = load_config(str(REPO / cfg_path))
    return build_mot_model(dict(cfg["model"], **model_overrides),
                           dict(cfg.get("tracker") or {}, **(tracker or {})),
                           device=dev)


def host_ms(fn, n=10):
    """Median host ms of ``fn()`` over n calls, synchronised after each."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def mot_stream(dev, smi, kernels):
    """DeepSORT at the MOT config's defaults (the 608x1024 bucket, bf16
    detector, 1 class; the ReID R50 bf16 on up to 48 crops of 256x128),
    seeded weights, the tracker's score threshold lowered (MOT_TRACKER) so
    every detection is associated, MOT_FRAMES random 1080x1920 frames
    through
    ``inference_mot``: frame ms, the split of a steady frame (detector;
    crops + ReID on its top 48 boxes; host association), the device's
    idle share over MOT_PROFILED more frames, peak memory; kernel B once a
    frame, all on ``gather7x2``. Then the f32 kernel path against the
    plain path on one frame: detections as sets, the embeddings of the
    same boxes within MOT_EMBED_REL. Returns the launch counts (A-G) and
    B's bodies."""
    import copy
    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        inference_mot)
    from lowlightenvironmentvideoobjectdetection_torch.data.preprocess import (
        prepare_frames)
    from lowlightenvironmentvideoobjectdetection_torch.models.detectors import (
        faster_rcnn as FR)
    from lowlightenvironmentvideoobjectdetection_torch.models.mot.deep_sort import (  # noqa: E501
        crop_and_resize)
    from lowlightenvironmentvideoobjectdetection_torch.models.reid.base_reid import (  # noqa: E501
        BaseReID)
    t_phase = time.perf_counter()
    rng = np.random.RandomState(11)
    n = MOT_FRAMES + MOT_PROFILED
    raw = rng.randint(0, 256, (n,) + MOT_HW + (3,)).astype(np.uint8)
    model = mot_model(MOT_CFG, dev, tracker=MOT_TRACKER)
    cfg = model.detector.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    lat, tracks, dets = [], [], []
    for fid in range(MOT_FRAMES):
        t = time.perf_counter()
        out = inference_mot(model, raw[fid], fid)
        lat.append((time.perf_counter() - t) * 1e3)
        tracks.append(len(out["track_bboxes"]))
        dets.append(len(out["det_bboxes"]))
        if not (np.isfinite(out["track_bboxes"]).all()
                and out["det_bboxes"].shape[1] == 5
                and len(out["det_bboxes"]) <= model.max_reid_dets):
            raise AssertionError("mot_stream: bad result")
    frames = iter(range(MOT_FRAMES, n))
    window = flow_profiled(lambda: inference_mot(model, raw[next(frames)],
                                                 MOT_FRAMES),
                           MOT_PROFILED)
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = [k.launches for k in kernels]
    if counts != [0, n, 0, 0, 0, 0, 0]:
        raise AssertionError(f"mot_stream: launch counts {counts} for {n} "
                             "frames, want one of B a frame")
    check_bodies("mot_stream roi_align", kernels[1], gather7x2=n,
                 gather14x2=0)
    bodies = dict(roi_align=dict(kernels[1].body_launches),
                  roi_align_backward={})
    # the split of a steady frame
    imgs, shape, _ = prepare_frames(raw[:1], cfg.pad_h, cfg.pad_w,
                                    device=dev)
    img = imgs[0]
    det = FR.faster_rcnn_detect(model.detector, img, shape, model.anchors)
    top = det.boxes[:model.max_reid_dets][det.valid[:model.max_reid_dets]]
    boxes, scores, labels, embeds = model.detect(img, shape)
    tracker = copy.deepcopy(model.tracker)
    # one copy of the tracker for each timed call, made before the timing
    copies = [copy.deepcopy(tracker) for _ in range(10)]

    def associate():
        model.tracker = copies.pop()
        model.tracker.track(MOT_FRAMES + 1, boxes, scores, labels, embeds)

    split = dict(detector=host_ms(lambda: FR.faster_rcnn_detect(
        model.detector, img, shape, model.anchors)),
        crops_reid=host_ms(lambda: model.embed(img, top)),
        crops_only=host_ms(lambda: crop_and_resize(img, top)),
        association=host_ms(associate, len(copies)),
        reid_crops=int(top.shape[0]), tracks_before=len(tracker.tracks))
    # each part synchronised alone: the parts do not add up to the frame,
    # which overlaps the host's launches with the device's work
    split["frame_median"] = statistics.median(lat[1:])
    model.tracker = tracker
    # f32: the kernel path against the plain path on one frame
    m32 = mot_model(MOT_CFG, dev, compute_dtype="float32")
    m32.reid = BaseReID(dtype=torch.float32).to(dev).eval()
    m32.reid.load_state_dict(model.reid.state_dict())
    imgs, shape, _ = prepare_frames(raw[1:2], cfg.pad_h, cfg.pad_w,
                                    device=dev)
    reset_counts(*kernels)
    got = FR.faster_rcnn_detect(m32.detector, imgs[0], shape, m32.anchors)
    if kernels[1].launches != 1:
        raise AssertionError("mot_stream agree: B not launched")
    want = FR.faster_rcnn_detect(m32.detector, imgs[0], shape, m32.anchors,
                                 impl="plain")
    sets = match_sets(got, want)
    k_boxes = got.boxes[:m32.max_reid_dets][got.valid[:m32.max_reid_dets]]
    p_boxes = want.boxes[:m32.max_reid_dets][want.valid[
        :m32.max_reid_dets]]
    e_k, e_p = m32.embed(imgs[0], k_boxes), m32.embed(imgs[0], p_boxes)
    emb_err = float(np.abs(e_k - e_p).max() / max(np.abs(e_p).max(), 1e-30)) \
        if e_p.shape == e_k.shape and len(e_p) else None
    if sets["unmatched"] or sets["n_got"] != sets["n_want"] \
            or emb_err is None or emb_err > MOT_EMBED_REL:
        raise AssertionError(f"mot_stream agree: sets {sets}, embeddings "
                             f"{emb_err}")
    phase("mot_stream", card=smi, config=MOT_CFG, frame_hw=MOT_HW,
          frames=n, bucket=[cfg.pad_h, cfg.pad_w],
          detector_dtype=str(cfg.compute_dtype), reid_dtype=str(
              model.reid.compute_dtype), frame0_ms=lat[0],
          median_frame_ms=split["frame_median"], frame_ms=lat[1:],
          split_ms=split, device_window=window, peak_mem_gb=peak,
          detections_per_frame=dets, tracks_per_frame=tracks,
          launches=dict(zip(KERNEL_NAMES, counts)),
          f32_kernel_vs_plain=dict(sets=sets, embed_max_rel_err=emb_err,
                                   embed_rel_tol=MOT_EMBED_REL),
          phase_s=time.perf_counter() - t_phase)
    del model, m32
    torch.cuda.empty_cache()
    return counts, bodies


def panning(rng, n, hw, pan):
    """n frames [H, W, 3] uint8 of a smooth textured scene seen by a camera
    moving ``pan`` (dx, dy) px a frame."""
    h, w = hw
    dx, dy = pan
    big = rng.randint(0, 256, (h // 8 + abs(dy) * n // 8 + 2,
                               w // 8 + abs(dx) * n // 8 + 2, 3))
    scene = torch.nn.functional.interpolate(
        torch.from_numpy(big).float().permute(2, 0, 1)[None], scale_factor=8,
        mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    scene = scene.round().clamp(0, 255).to(torch.uint8).numpy()
    return [np.ascontiguousarray(scene[dy * f:dy * f + h, dx * f:dx * f + w])
            for f in range(n)]


def tracktor_stream(dev, smi, kernels):
    """Tracktor (the Tracktor config: bf16 detector, ECC camera motion
    compensation on the raw frames; linear motion on too) through
    ``inference_mot`` over TRACKTOR_FRAMES frames at 1080x1920 of a camera
    panning TRACKTOR_PAN px a frame; the tracker's thresholds lowered
    (TRACKTOR_TRACKER) so seeded weights keep tracks: kernel B once at
    frame 0 and twice a frame after (detection, and ``regress`` on at most
    64 track boxes). Prints the frame ms, ``regress`` ms on 64 boxes, ECC
    ms at 1080x1920 (the frame's preparation and the estimate), the pan
    recovered against the known one. Returns the launch counts (A-G) and
    B's bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        inference_mot)
    from lowlightenvironmentvideoobjectdetection_torch.data.preprocess import (
        prepare_frames)
    t_phase = time.perf_counter()
    rng = np.random.RandomState(12)
    raw = panning(rng, TRACKTOR_FRAMES, MOT_HW, TRACKTOR_PAN)
    model = mot_model(TRACKTOR_CFG, dev, tracker=TRACKTOR_TRACKER,
                      with_linear_motion=True)
    if not (model.with_cmc and model.with_linear_motion):
        raise AssertionError("tracktor_stream: CMC or linear motion off")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    lat, tracks = [], []
    for fid, frame in enumerate(raw):
        t = time.perf_counter()
        out = inference_mot(model, frame, fid)
        lat.append((time.perf_counter() - t) * 1e3)
        tracks.append(len(out["track_bboxes"]))
        if not np.isfinite(out["track_bboxes"]).all():
            raise AssertionError("tracktor_stream: non-finite tracks")
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = [k.launches for k in kernels]
    n = len(raw)
    want = 1 + 2 * (n - 1)
    if counts != [0, want, 0, 0, 0, 0, 0] or min(tracks) == 0:
        raise AssertionError(f"tracktor_stream: launch counts {counts}, "
                             f"want {want} of B; tracks {tracks}")
    check_bodies("tracktor_stream roi_align", kernels[1], gather7x2=want,
                 gather14x2=0)
    bodies = dict(roi_align=dict(kernels[1].body_launches),
                  roi_align_backward={})
    # regress on 64 boxes, ECC on two frames, the recovered pan
    cur = torch.as_tensor(raw[1]).to(dev)
    prev = torch.as_tensor(raw[0]).to(dev)
    imgs, _, _ = prepare_frames(cur[None], model.detector.cfg.pad_h,
                                model.detector.cfg.pad_w, device=dev)
    with torch.no_grad():
        feat = model.detector.extract_feat(imgs[0][None])
    xy = rng.uniform(0, 900, (64, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(40, 200, (64, 2))],
                           1).astype(np.float32)
    reset_counts(*kernels)
    n_regress = 10
    regress_ms = host_ms(lambda: model.regress(feat, boxes), n_regress)
    if kernels[1].launches != n_regress:
        raise AssertionError("tracktor_stream: regress did not launch B")
    cmc = model.cmc
    p_prev, p_cur = cmc.prepare(prev, dev), cmc.prepare(cur, dev)
    warp = cmc.estimate(p_cur, p_prev)
    known = [-float(TRACKTOR_PAN[0]), -float(TRACKTOR_PAN[1])]
    pan_err = float(np.abs(warp[:, 2] - known).max())
    ecc = dict(prepare_ms=host_ms(lambda: cmc.prepare(cur, dev)),
               estimate_ms=host_ms(lambda: cmc.estimate(p_cur, p_prev), 3),
               warp=warp.tolist(), known_translation=known,
               translation_err_px=pan_err)
    if pan_err > TRACKTOR_PAN_TOL or np.abs(warp[:, :2] - np.eye(2)).max() \
            > 1e-3:
        raise AssertionError(f"tracktor_stream: ECC recovered {warp}, "
                             f"known pan {TRACKTOR_PAN}")
    phase("tracktor_stream", card=smi, config=TRACKTOR_CFG, frame_hw=MOT_HW,
          frames=n, pan_px_per_frame=TRACKTOR_PAN, tracker=TRACKTOR_TRACKER,
          frame0_ms=lat[0], median_frame_ms=statistics.median(lat[1:]),
          frame_ms=lat[1:], tracks_per_frame=tracks,
          regress_64_boxes_ms=regress_ms, ecc=ecc, peak_mem_gb=peak,
          launches=dict(zip(KERNEL_NAMES, counts)),
          phase_s=time.perf_counter() - t_phase)
    del model, feat
    torch.cuda.empty_cache()
    return counts, bodies


def sot_stream(dev, smi, kernels):
    """SiamRPN++ at the config's 127 / 255 crops, f32, seeded weights,
    through ``inference_sot`` over SOT_FRAMES random 1080x1920 frames: the
    template's init ms, the steady track-step ms, the device's idle share
    over SOT_PROFILED more steps; no kernel of the table on this path.
    Then one step on the card against the CPU from the same state and
    frame: the same best anchor, the box within SOT_BOX_TOL px. Returns
    the launch counts (all 0) and no bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        SOTModel)
    from lowlightenvironmentvideoobjectdetection_torch.models.sot import (
        siamrpn as SR)
    t_phase = time.perf_counter()
    rng = np.random.RandomState(13)
    n = SOT_FRAMES + SOT_PROFILED
    raw = rng.randint(0, 256, (n,) + MOT_HW + (3,)).astype(np.uint8)
    box = np.array([900.0, 500.0, 1000.0, 640.0], np.float32)
    model = SOTModel(seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    lat = []
    for fid in range(SOT_FRAMES):
        t = time.perf_counter()
        out = model.inference_sot(raw[fid], box if fid == 0 else None, fid)
        lat.append((time.perf_counter() - t) * 1e3)
        if not np.isfinite(out["track_bboxes"]).all():
            raise AssertionError("sot_stream: non-finite box")
    frames = iter(range(SOT_FRAMES, n))
    window = flow_profiled(lambda: model.inference_sot(
        raw[next(frames)], None, 1), SOT_PROFILED)
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = [k.launches for k in kernels]
    if any(counts):
        raise AssertionError(f"sot_stream: launch counts {counts}")
    # the card against the CPU from the same state and frame
    frame = torch.as_tensor(raw[1])
    state = model.state
    _, s_dev, b_dev, x_dev = SR.sot_track(model.model, state,
                                          frame.to(dev).float(),
                                          model.anchors, model.window)
    cpu = SOTModel(state_dict={k: v.cpu() for k, v in
                               model.model.state_dict().items()},
                   device="cpu")
    cpu_state = SR.SOTState(tuple(z.cpu() for z in state.z_feats),
                            state.bbox.cpu())
    _, s_cpu, b_cpu, x_cpu = SR.sot_track(cpu.model, cpu_state,
                                          frame.float(), cpu.anchors,
                                          cpu.window)
    box_err = float((x_dev.cpu() - x_cpu).abs().max())
    if int(b_dev) != int(b_cpu) or box_err > SOT_BOX_TOL:
        raise AssertionError(f"sot_stream: card best {int(b_dev)} box "
                             f"{x_dev.tolist()}, CPU {int(b_cpu)} "
                             f"{x_cpu.tolist()}")
    phase("sot_stream", card=smi, config=SOT_CFG, frame_hw=MOT_HW,
          crops=[model.cfg.exemplar_size, model.cfg.search_size],
          score_map=model.cfg.score_size, frames=n, init_ms=lat[0],
          median_step_ms=statistics.median(lat[1:]), step_ms=lat[1:],
          device_window=window, peak_mem_gb=peak,
          card_vs_cpu=dict(best=int(b_dev), box_max_abs_err_px=box_err,
                           score_err=abs(float(s_dev) - float(s_cpu)),
                           box_tol_px=SOT_BOX_TOL),
          launches=dict(zip(KERNEL_NAMES, counts)),
          phase_s=time.perf_counter() - t_phase)
    del model, cpu
    torch.cuda.empty_cache()
    return counts, dict(roi_align={}, roi_align_backward={})


def track_eval(dev, smi, kernels, root):
    """The test CLI's tracking routes on the card from PNG trees written
    with the port's PNG writer under ``root``: DeepSORT (its config) on a
    MOT tree (MOT_TREE: textured objects moving linearly, far apart, the
    ground truth jittered as the public ``detection_file``), whose MOTA
    must reach MOT_MOTA_FLOOR with seeded weights (one detection inside
    each track's gates, so the association does not need trained
    weights); SiamRPN++ on a LaSOT tree (SOT_TREE), whose OPE numbers must
    be finite. Frames/s of both. Returns the launch counts (A-G) and B's
    bodies (the public path runs no detector: no B)."""
    from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
        write_lasot_tree, write_mot_tree)
    from lowlightenvironmentvideoobjectdetection_torch.tools import (
        test as tcli)
    t_phase = time.perf_counter()
    ann, dets = write_mot_tree(f"{root}/mot", **MOT_TREE)
    reset_counts(*kernels)
    mot = tcli.main([str(REPO / MOT_CFG), "--eval", "track",
                     "--cfg-options", f"data.test.ann_file={ann}",
                     f"data.test.img_prefix={root}/mot/",
                     f"data.test.detection_file={dets}"])
    counts = [k.launches for k in kernels]
    lann = write_lasot_tree(f"{root}/lasot", **SOT_TREE)
    sot = tcli.main([str(REPO / SOT_CFG), "--cfg-options",
                     f"data.test.ann_file={lann}",
                     f"data.test.img_prefix={root}/lasot/"])
    counts = [a + k.launches for a, k in zip(counts, kernels)]
    if any(counts):
        raise AssertionError(f"track_eval: launch counts {counts}")
    if mot["metrics"]["MOTA"] < MOT_MOTA_FLOOR or not all(
            np.isfinite(v) for v in sot["metrics"].values()):
        raise AssertionError(f"track_eval: MOT {mot['metrics']}, SOT "
                             f"{sot['metrics']}")
    phase("track_eval", card=smi, mot_tree=MOT_TREE, sot_tree=SOT_TREE,
          mot=dict(config=MOT_CFG, frames=mot["summary"]["frames"],
                   fps=mot["summary"]["fps"], metrics=mot["metrics"],
                   mota_floor=MOT_MOTA_FLOOR),
          sot=dict(config=SOT_CFG, frames=sot["summary"]["frames"],
                   fps=sot["summary"]["fps"], metrics=sot["metrics"]),
          launches=dict(zip(KERNEL_NAMES, counts)),
          phase_s=time.perf_counter() - t_phase)
    return counts, dict(roi_align={}, roi_align_backward={})


# ---------------------------------------------------------------------------
# Tracking training and the image detectors


def sot_train(dev, smi, kernels, root):
    """SiamRPN++ training through the training CLI's SOT route on a LaSOT
    tree written under ``root`` (SOT_TRAIN_TREE): ``SOTTrainDataset``
    pairs, the SOT augmentations, 127 / 255 crops, ``siamrpn_loss`` at full
    width in f32, SiamRPN++'s schedule with the backbone frozen (epoch 0);
    SOT_TRAIN_STEPS steps, the last ones profiled for the idle share.
    Gates: every loss finite, the backbone unchanged, the heads changed.
    No kernel of the table on this path. Returns the launch counts (all 0)
    and no bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
        write_lasot_tree)
    from lowlightenvironmentvideoobjectdetection_torch.tools import (
        train as cli)
    t_phase = time.perf_counter()
    ann = write_lasot_tree(f"{root}/lasot_train", **SOT_TRAIN_TREE)
    d = dict(type="SOTTrainDataset", ann_file=ann,
             img_prefix=f"{root}/lasot_train/")
    window = StepWindow(SOT_TRAIN_STEPS, SOT_TRAIN_SKIP)
    before = {}

    def on_step(state, metrics):
        if not before:  # the weights after step 1 (the backbone's stay)
            before.update({n: p.detach().clone() for n, p in
                           state.model.named_parameters()})
        window(state, metrics)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    t0 = time.perf_counter()
    out = cli.main([str(REPO / SOT_CFG), "--seed", "0", "--work-dir",
                    f"{root}/work_sot", "--steps", str(SOT_TRAIN_STEPS),
                    "--cfg-options", f"data.train={d!r}"], on_step=on_step)
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + window.stamps,
                                            window.stamps)]
    counts = [k.launches for k in kernels]
    losses = [m["loss"] for m in out["metrics"]]
    if any(counts) or len(losses) != SOT_TRAIN_STEPS or not all(
            np.isfinite(v) for m in out["metrics"] for v in m.values()):
        raise AssertionError(f"sot_train: counts {counts}, metrics "
                             f"{out['metrics']}")
    after = dict(out["state"].model.named_parameters())
    moved = [n for n in before if not torch.equal(before[n], after[n])]
    if any(n.startswith("backbone.") for n in moved) or not any(
            n.startswith("cls_head") for n in moved):
        raise AssertionError(f"sot_train: changed leaves {moved[:5]}...")
    timed_ms = step_ms[1:SOT_TRAIN_SKIP]
    phase("sot_train", card=smi, config=SOT_CFG, tree=SOT_TRAIN_TREE,
          steps=SOT_TRAIN_STEPS, first_step_ms=step_ms[0],
          median_step_ms=statistics.median(timed_ms),
          min_step_ms=min(timed_ms), max_step_ms=max(timed_ms),
          step_ms=step_ms, device_window=window.window,
          first_loss=out["metrics"][0], last_loss=out["metrics"][-1],
          losses=losses, positive_pairs_note="loss_rpn_bbox 0: no anchor "
          "reaches IoU 0.6 in the JAX crops (ROADMAP F21)",
          peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
          changed_leaves=len(moved), launches=dict(zip(KERNEL_NAMES, counts)),
          phase_s=time.perf_counter() - t_phase)
    del out
    torch.cuda.empty_cache()
    return counts, dict(roi_align={}, roi_align_backward={})


def detector_kwargs(cfg_path, **overrides):
    kw = model_dict(cfg_path, **overrides)
    return kw.pop("type"), kw


def sized_rois(dev, n, level, hw, g):
    """n rois whose scale maps to FPN ``level`` (sides in [56, 112) x
    2^level px, the last level from 448 px up) inside an image ``hw``."""
    lo = 56.0 * 2 ** level
    side = lo * (1 + torch.rand(n, 2, generator=g))
    side = torch.minimum(side, torch.tensor([hw[1], hw[0]]) - 1)
    xy = torch.rand(n, 2, generator=g) * (torch.tensor([hw[1], hw[0]])
                                          - side)
    return torch.cat([xy, xy + side], 1).to(dev)


def roi_footprint_pixels(rois, scale, h, w):
    """The pixels of an [h, w] map that RoIAlign 7x7 (sampling ratio 2)
    reads with a nonzero weight for these rois: the nonzero entries of the
    plain version's gradient on a one-channel map."""
    from lowlightenvironmentvideoobjectdetection_torch.ops.roi_align import (
        roi_align_plain)
    m = torch.zeros((1, h, w, 1), device=rois.device, requires_grad=True)
    b = torch.zeros(rois.shape[0], dtype=torch.int64, device=rois.device)
    roi_align_plain(m, rois, scale, batch_inds=b).sum().backward()
    return int((m.grad != 0).sum())


def fpn_level_times(det, raw, roi_align):
    """Kernel B on one frame's P2-P5 slices of FPN Faster R-CNN's test
    proposals (f32 maps, as the model pools them) and, on the same maps,
    on test_nms_post rois sized for each level (``sized_rois``; seeded
    weights put almost every proposal on P2): each launch against the
    plain version (plain, kernel, kernel, plain), its error, and its bound
    from the map pixels the rois read (``roi_footprint_pixels``), not the
    whole map."""
    from lowlightenvironmentvideoobjectdetection_torch.data.preprocess import (
        prepare_frames)
    from lowlightenvironmentvideoobjectdetection_torch.models.detectors import (
        fpn_faster_rcnn as FF)
    m = det.model
    imgs, shape, _ = prepare_frames(raw[None], det.pad_h, det.pad_w,
                                    device=det.device)
    with torch.no_grad():
        feats = m.extract_feat(imgs)
        props = FF._proposals(m, m.rpn_forward(feats), m.anchors(feats),
                              shape, False)
    rois = props.boxes
    lvl = FF.map_roi_levels(rois)
    g = torch.Generator().manual_seed(19)
    out = {}
    for i in range(FF.NUM_ROI_LEVELS):
        f = feats[i].float().contiguous()
        sized = sized_rois(f.device, m.test_nms_post, i,
                           (det.pad_h, det.pad_w), g)
        if not torch.equal(FF.map_roi_levels(sized), torch.full_like(
                FF.map_roi_levels(sized), i)):
            raise AssertionError(f"sized rois off level {i}")
        for case, r in (("frame", rois[lvl == i].contiguous()),
                        ("sized", sized)):
            key = f"P{i + 2}_{case}"
            if not r.shape[0]:
                out[key] = dict(rois=0, map=list(f.shape[1:]))
                continue
            b = torch.zeros(r.shape[0], dtype=torch.int64, device=r.device)
            scale = 1.0 / FF.FPN_STRIDES[i]
            got = roi_align(f, r, scale, batch_inds=b)
            want = roi_align(f, r, scale, batch_inds=b, impl="plain")
            check_close(f"fpn {key}", got, want, 0.0, ROI_F32_ATOL)
            ms, plain_ms, _ = compare_times(
                lambda: roi_align(f, r, scale, batch_inds=b),
                lambda: roi_align(f, r, scale, batch_inds=b, impl="plain"))
            pixels = roi_footprint_pixels(r, scale, f.shape[1], f.shape[2])
            nbytes, flops = roi_align_cost(1, f.shape[1], f.shape[2],
                                           f.shape[3], r.shape[0], 4, 8,
                                           map_pixels=pixels)
            bound_ms, bound_by = bound(nbytes, flops, F32_FLOP_PER_S)
            out[key] = dict(
                rois=int(r.shape[0]), map=list(f.shape[1:]),
                map_pixels_read=pixels,
                map_share_read=pixels / (f.shape[1] * f.shape[2]),
                max_abs_err=max_err(got, want), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms, library_ms=None)
    return out


def det_stream(dev, smi, kernels):
    """The image detectors at full width with seeded weights through
    ``DetectorModel``: FPN Faster R-CNN (800 x 1344, bf16), RetinaNet (768 x
    1280, bf16) and the DC5 Faster R-CNN (608 x 1024, bf16), DET_IMAGES
    random 480 x 640 frames each: frame ms, the device's idle share over
    DET_PROFILED more; B's launches (FPN: once a non-empty level, on the
    7x7 gather; DC5: once a frame; RetinaNet: none) with the rois and
    launches per FPN level; B's times at one frame's P2-P5 slices against
    their bounds. Gate: at f32 the kernel path's detections equal the
    plain path's as sets (SET_BOX_TOL / SET_SCORE_TOL) for each model.
    Returns the launch counts (A-G) and B's bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        DetectorModel)
    from lowlightenvironmentvideoobjectdetection_torch.data.preprocess import (
        prepare_frames)
    from lowlightenvironmentvideoobjectdetection_torch.models.detectors import (
        fpn_faster_rcnn as FF)
    t_phase = time.perf_counter()
    rng = np.random.RandomState(17)
    n = DET_IMAGES + DET_PROFILED
    raw = rng.randint(0, 256, (n,) + DET_HW + (3,)).astype(np.uint8)
    roi_align = kernels[1]
    total, bodies, runs = [0] * len(kernels), {}, {}
    levels = []
    real = FF.multilevel_roi_align

    def counting(*a, **kw):
        kw["level_counts"] = levels
        return real(*a, **kw)

    for name, cfg_path in DET_STREAM:
        mtype, kw = detector_kwargs(cfg_path)
        det = DetectorModel(mtype, device=dev, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*kernels)
        levels.clear()
        lat, ndet = [], []
        FF.multilevel_roi_align = counting
        try:
            for i in range(DET_IMAGES):
                t = time.perf_counter()
                res = det.inference_detector(raw[i])
                lat.append((time.perf_counter() - t) * 1e3)
                ndet.append(sum(len(r) for r in res))
                if len(res) != det.num_classes or not all(
                        np.isfinite(r).all() for r in res):
                    raise AssertionError(f"det_stream {name}: bad result")
            frames = iter(range(DET_IMAGES, n))
            window = flow_profiled(lambda: det.inference_detector(
                raw[next(frames)]), DET_PROFILED)
        finally:
            FF.multilevel_roi_align = real
        counts = [k.launches for k in kernels]
        want_b = {"FasterRCNNFPN": sum(sum(1 for c in lv if c)
                                       for lv in levels),
                  "RetinaNet": 0, "FasterRCNN": n}[name]
        if counts != [0, want_b, 0, 0, 0, 0, 0] or (
                name == "FasterRCNNFPN" and len(levels) != n):
            raise AssertionError(f"det_stream {name}: launch counts {counts},"
                                 f" want B {want_b}")
        check_bodies(f"det_stream {name}", roi_align, gather7x2=want_b,
                     gather14x2=0)
        add_counts(bodies, dict(roi_align=roi_align.body_launches))
        steady = lat[1:]
        run = dict(bucket=[det.pad_h, det.pad_w], frames=n,
                   frame0_ms=lat[0], median_frame_ms=statistics.median(steady),
                   min_frame_ms=min(steady), max_frame_ms=max(steady),
                   frame_ms=steady, device_window=window,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                   detections_per_frame=ndet, launches=dict(
                       zip(KERNEL_NAMES, counts)))
        if name == "FasterRCNNFPN":
            per = np.asarray(levels)
            run["levels"] = dict(
                rois_per_level_frame0=per[0].tolist(),
                rois_per_level_mean=per.mean(0).tolist(),
                launches_per_level=(per > 0).sum(0).tolist())
            run["kernel_b_per_level"] = fpn_level_times(det, raw[0],
                                                        roi_align)
        runs[name] = run
        total = [a + b for a, b in zip(total, counts)]
        del det
        torch.cuda.empty_cache()
    # f32: the kernel path against the plain path, one frame a model
    agree = {}
    for name, cfg_path in DET_STREAM:
        key = "compute_dtype" if name == "FasterRCNN" else "dtype"
        mtype, kw = detector_kwargs(cfg_path, **{key: "float32"})
        det = DetectorModel(mtype, device=dev, **kw)
        imgs, shape, sf = prepare_frames(raw[:1], det.pad_h, det.pad_w,
                                         device=dev)
        sf = torch.as_tensor(sf, device=dev)
        got = det.detect(imgs[0], shape, sf)
        det.impl = "plain"
        want = det.detect(imgs[0], shape, sf)
        sets = match_sets(got, want)
        if sets["unmatched"] or sets["n_got"] != sets["n_want"] or \
                not sets["n_want"]:
            raise AssertionError(f"det_stream {name} f32: sets {sets}")
        agree[name] = sets
        del det
        torch.cuda.empty_cache()
    phase("det_stream", card=smi, frame_hw=DET_HW, models=runs,
          f32_kernel_vs_plain=dict(sets=agree, tolerances=dict(
              box_px=SET_BOX_TOL, score=SET_SCORE_TOL)),
          launches=dict(zip(KERNEL_NAMES, total)),
          phase_s=time.perf_counter() - t_phase)
    return total, dict(roi_align=bodies.get("roi_align", {}),
                       roi_align_backward={})


def det_train(dev, smi, kernels, root):
    """The training CLI's image route at full width from a COCO tree of PNG
    images written under ``root`` (COCO_TREE), ``data.train`` by
    ``--cfg-options``: FPN Faster R-CNN and RetinaNet (their configs, bf16,
    seeded weights), DET_TRAIN_STEPS steps each, the last ones profiled.
    Gates: finite losses; on the FPN path B launches at least once a step
    (once a non-empty level) and D as often as B, on their 7x7 bodies;
    RetinaNet none. Returns the launch counts (A-G), B's and D's bodies
    and the train and val annotation files."""
    from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
        write_coco_tree)
    from lowlightenvironmentvideoobjectdetection_torch.tools import (
        train as cli)
    from lowlightenvironmentvideoobjectdetection_torch.models.detectors import (
        fpn_faster_rcnn as FF)
    t_phase = time.perf_counter()
    train_ann, val_ann = write_coco_tree(f"{root}/coco", **COCO_TREE)
    total, bodies, runs = [0] * len(kernels), {}, {}
    levels = []
    real = FF.multilevel_roi_align

    def counting(*a, **kw):
        kw["level_counts"] = levels
        return real(*a, **kw)

    for cfg_path, scale in DET_TRAIN_SCALE.items():
        pipeline = [dict(type="LoadImageFromFile"),
                    dict(type="LoadAnnotations", with_bbox=True),
                    dict(type="Resize", img_scale=scale),
                    dict(type="RandomFlip", flip_ratio=0.5),
                    dict(type="Normalize"), dict(type="Pad", size_divisor=32)]
        d = dict(type="CocoDataset", ann_file=train_ann,
                 img_prefix=f"{root}/coco/", pipeline=pipeline)
        window = StepWindow(DET_TRAIN_STEPS, DET_TRAIN_SKIP)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*kernels)
        levels.clear()
        FF.multilevel_roi_align = counting
        t0 = time.perf_counter()
        try:
            out = cli.main([str(REPO / cfg_path), "--seed", "0",
                            "--work-dir", f"{root}/work_det", "--steps",
                            str(DET_TRAIN_STEPS), "--cfg-options",
                            f"data.train={d!r}", "data.workers_per_gpu=0"],
                           on_step=window)
        finally:
            FF.multilevel_roi_align = real
        counts = [k.launches for k in kernels]
        fpn = cfg_path == DET_FPN_CFG
        b, dd = counts[1], counts[3]
        ok = (b >= DET_TRAIN_STEPS and dd == b == sum(
            sum(1 for c in lv if c) for lv in levels)) if fpn \
            else b == dd == 0
        if not ok or counts[0] or counts[2] or any(counts[4:]) or not all(
                np.isfinite(v) for m in out["metrics"] for v in m.values()):
            raise AssertionError(f"det_train {cfg_path}: counts {counts}, "
                                 f"metrics {out['metrics']}")
        check_bodies(f"det_train {cfg_path} roi_align", kernels[1],
                     gather7x2=b, gather14x2=0)
        check_bodies(f"det_train {cfg_path} roi_align_backward", kernels[3],
                     scatter7x2=dd, scatter14x2=0)
        add_counts(bodies, dict(roi_align=kernels[1].body_launches,
                                roi_align_backward=kernels[3].body_launches))
        step_ms = [(y - x) * 1e3 for x, y in zip([t0] + window.stamps,
                                                window.stamps)]
        timed_ms = step_ms[1:DET_TRAIN_SKIP]
        runs[cfg_path] = dict(
            steps=DET_TRAIN_STEPS, first_step_ms=step_ms[0],
            median_step_ms=statistics.median(timed_ms), step_ms=step_ms,
            device_window=window.window, losses=out["metrics"],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
            launches=dict(zip(KERNEL_NAMES, counts)),
            rois_per_level_a_step=levels[:] if fpn else None,
            loader_ms=loader_summary(out["timings"], 1))
        total = [a + c for a, c in zip(total, counts)]
        del out
        torch.cuda.empty_cache()
    phase("det_train", card=smi, tree=COCO_TREE, runs=runs,
          launches=dict(zip(KERNEL_NAMES, total)),
          phase_s=time.perf_counter() - t_phase)
    return total, dict(roi_align=bodies.get("roi_align", {}),
                       roi_align_backward=bodies.get("roi_align_backward",
                                                     {})), train_ann, val_ann


def image_gts(ann, det_lists, path):
    """``eval_gts`` for an image split: every detection of ``det_lists``
    (per-class [N, 5] a val image, in dataset order) scored above a
    threshold that starts at EVAL_GT_SCORE and rises above each image's
    (DET_GTS_PER_IMAGE + 1)-th score and above every sub-pixel box, as the
    COCO annotations of ``ann``'s images, written to ``path``. Returns the
    threshold and the number of gts."""
    with open(ann) as f:
        data = json.load(f)
    rows = [per_class_rows(d) for d in det_lists]
    thr = EVAL_GT_SCORE
    for r in rows:
        scores = sorted((s for _, _, s in r), reverse=True)
        if len(scores) > DET_GTS_PER_IMAGE:
            thr = max(thr, scores[DET_GTS_PER_IMAGE])
        thr = max([thr] + [s for _, b, s in r
                           if b[2] - b[0] < 1 or b[3] - b[1] < 1])
    anns = []
    for img, r in zip(data["images"], rows):
        for c, b, s in r:
            if s > thr:
                x1, y1, x2, y2 = (float(v) for v in b)
                anns.append(dict(id=len(anns) + 1, image_id=img["id"],
                                 category_id=c + 1,
                                 bbox=[x1, y1, x2 - x1, y2 - y1],
                                 area=(x2 - x1) * (y2 - y1), iscrowd=0))
    data["annotations"] = anns
    with open(path, "w") as f:
        json.dump(data, f)
    return thr, len(anns)


def det_eval(dev, smi, kernels, root, val_ann):
    """The test CLI's image route on the card over the COCO tree's val
    split, for the two FPN configs: the plain path at f32
    (``DetectorModel`` with ``impl = "plain"``) makes the gts
    (``image_gts``; its own mAP50 must be 1); the CLI at f32 (the kernel
    path) against them, mAP50 at least EVAL_F32_MAP, its detection sets
    against the plain run's; the CLI at the config's bf16: mAP50,
    frames/s and its summary line. Returns the bf16 runs' launch counts
    (A-G) and B's bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        DetectorModel)
    from lowlightenvironmentvideoobjectdetection_torch.apis.test import (
        evaluate_bbox)
    from lowlightenvironmentvideoobjectdetection_torch.data.coco_det import (
        CocoDataset)
    from lowlightenvironmentvideoobjectdetection_torch.tools import (
        test as tcli)
    import io
    t_phase = time.perf_counter()
    total, bodies, runs = [0] * len(kernels), {}, {}
    ds = CocoDataset(val_ann, img_prefix=f"{root}/coco/", test_mode=True)
    frames = [tcli.read_frame(i, ds.img_prefix).astype(np.float32)
              for i in ds.data_infos]
    for cfg_path in (DET_FPN_CFG, DET_RETINA_CFG):
        mtype, kw = detector_kwargs(cfg_path, dtype="float32")
        ref = DetectorModel(mtype, device=dev, **kw)
        ref.impl = "plain"
        reset_counts(*kernels)
        plain = [ref.inference_detector(f) for f in frames]
        if any(k.launches for k in kernels):
            raise AssertionError("det_eval: the plain run launched a kernel")
        del ref
        gts = f"{root}/coco_gts_{mtype}.json"
        thr, n_gts = image_gts(val_ann, plain, gts)
        anns = [CocoDataset(gts, test_mode=True).get_ann_info(i)
                for i in ds.data_infos]
        plain_map = evaluate_bbox(plain, anns)["mAP50"]
        if plain_map != 1.0 or not n_gts:
            raise AssertionError(f"det_eval {mtype}: the plain run's own "
                                 f"mAP50 {plain_map} on {n_gts} gts")
        test = dict(type="CocoDataset", ann_file=gts,
                    img_prefix=f"{root}/coco/")
        argv = [str(REPO / cfg_path), "--cfg-options", f"data.test={test!r}"]
        reset_counts(*kernels)
        f32 = tcli.main(argv + ["model.dtype=float32"])
        f32_map = f32["metrics"]["mAP50"]
        sets = [match_rows(per_class_rows(g), per_class_rows(w))
                for g, w in zip(f32["dets"], plain)]
        if f32_map < EVAL_F32_MAP:
            raise AssertionError(f"det_eval {mtype}: f32 mAP50 {f32_map}; "
                                 f"sets {sets}")
        torch.cuda.synchronize()
        reset_counts(*kernels)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bf16 = tcli.main(argv)
        line = buf.getvalue().strip().splitlines()[-1]
        print(line, flush=True)
        counts = [k.launches for k in kernels]
        fpn = cfg_path == DET_FPN_CFG
        if (counts[1] == 0) == fpn or counts[0] or any(counts[2:]):
            raise AssertionError(f"det_eval {mtype}: counts {counts}")
        add_counts(bodies, dict(roi_align=kernels[1].body_launches))
        total = [a + c for a, c in zip(total, counts)]
        runs[mtype] = dict(
            config=cfg_path, gts=dict(count=n_gts, score_threshold=thr),
            plain_f32_map50=plain_map, kernel_f32_map50=f32_map,
            kernel_f32_gate=EVAL_F32_MAP,
            kernel_f32_vs_plain_sets=dict(
                unmatched=sum(x["unmatched"] for x in sets),
                max_box_px=max(x["box"] for x in sets),
                max_score=max(x["score"] for x in sets)),
            bf16_map50=bf16["metrics"]["mAP50"],
            bf16_frames_per_s=bf16["summary"]["fps"], summary_line=line,
            launches=dict(zip(KERNEL_NAMES, counts)))
    phase("det_eval", card=smi, images=len(frames), runs=runs,
          launches=dict(zip(KERNEL_NAMES, total)),
          phase_s=time.perf_counter() - t_phase)
    return total, dict(roi_align=bodies.get("roi_align", {}),
                       roi_align_backward={})


def dcnv1_level_kernels(dev, g, ops, errs, shapes, inputs, key):
    """Kernels E, F and G (DCNv1: one deform group, f32 x, the mask all
    ones as ``deform_conv`` passes it) at ``shapes`` ((name, c, h, w) or
    (name, level, c, h, w)), operands from ``inputs(shape)`` -> (x,
    offsets, a dict describing them), through ``dcn_check`` (E's columns
    exact, the forward and F's and G's outputs to DCN_REL of their largest
    values against the plain versions and autograd), then each timed beside
    its plain version (plain, kernel, kernel, plain; GA_DCN_ITERS calls a
    turn) and from a CUDA graph, with its bound and the case's peak memory.
    Returns {E, F, G: {key: {name: entry}}}."""
    out = {k: {} for k in "EFG"}
    for shape in shapes:
        name, (c, h, w) = shape[0], shape[-3:]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        x, off, about = inputs(shape)
        mask = torch.ones((1, 9, h, w), device=dev)
        tag = f"dcn_{name}_float32"
        grad_cols = dcn_check(ops, tag, x, off, mask, g, errs)
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
            nbytes, flops = dcn_cost(kern, 1, c, h, w, 1, 4)
            bound_ms, bound_by = bound(nbytes, flops, F32_FLOP_PER_S)
            p1 = timed(plain, GA_DCN_ITERS, 1)
            k1, k2 = (timed(kernel, GA_DCN_ITERS, 1) for _ in range(2))
            p2 = timed(plain, GA_DCN_ITERS, 1)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            gms = graph_ms(kernel, GA_DCN_ITERS)
            out[kern][name] = dict(
                max_abs_err=errs[errs_of[kern]], ms=ms, graph_ms=gms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms,
                graph_share_of_bound=bound_ms / gms, library_ms=None,
                library_note=NO_LIBRARY_DCN, bytes=nbytes, flops=flops,
                shape=[1, c, h, w], groups=1, **about)
        peak = torch.cuda.max_memory_allocated() / 2**30
        for kern in "EFG":  # the check's plain autograd included
            out[kern][name]["case_peak_mem_gb"] = peak
        del x, off, mask, grad_cols
        torch.cuda.empty_cache()
    return {k: {key: v} for k, v in out.items()}


def ga_dcn_kernels(dev, g, ops, errs):
    """E, F and G at GA_DCN_SHAPES: offsets of N(0, 1.5^2) px, every 50th
    beyond the map (``dcnv1_level_kernels``, key ``ga_levels``)."""
    def inputs(shape):
        _, c, h, w = shape
        x, off, _ = dcn_inputs(dev, torch.float32, g, 1, c, h, w, 1.5, True,
                               groups=1)
        return x, off, dict(offset_std=1.5)
    return dcnv1_level_kernels(dev, g, ops, errs, GA_DCN_SHAPES, inputs,
                               "ga_levels")


def vfnet_dcn_kernels(dev, g, ops, errs):
    """E, F and G at VFNET_DCN_SHAPES with VFNet's star offsets
    (``vfnet_head.star_offsets`` of random initial distances;
    ``dcnv1_level_kernels``, key ``vfnet_levels``)."""
    from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (  # noqa: E501
        vfnet_head as VF)

    def inputs(shape):
        _, level, c, h, w = shape
        x = torch.randn(1, c, h, w, generator=g).to(dev)
        dist = VF.REG_DENOMS[level] * torch.exp(
            VFNET_DIST_LOG_STD * torch.randn(1, h, w, 4, generator=g))
        off = VF.star_offsets(dist, VF.VFNET_STRIDES[level])
        return x, off.permute(0, 3, 1, 2).contiguous().to(dev), dict(
            offsets="star", dist_log_std=VFNET_DIST_LOG_STD,
            level=f"P{level + 3}")
    return dcnv1_level_kernels(dev, g, ops, errs, VFNET_DCN_SHAPES, inputs,
                               "vfnet_levels")


def rep_dcn_kernels(dev, g, ops, errs):
    """E, F and G at REP_DCN_SHAPES with RepPoints' offsets
    (``reppoints_head.points_offsets`` of points N(0, REP_OFFSET_STD^2) px
    about the base grid; ``dcnv1_level_kernels``, key
    ``reppoints_levels``)."""
    from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (  # noqa: E501
        reppoints_head as RP)

    def inputs(shape):
        _, level, c, h, w = shape
        x = torch.randn(1, c, h, w, generator=g).to(dev)
        base = torch.tensor(RP.BASE_GRID)[None, :, None, None]
        pts = base + REP_OFFSET_STD * torch.randn(1, 18, h, w, generator=g)
        off = RP.points_offsets(pts)
        return x, off.contiguous().to(dev), dict(
            offsets="points", offset_std=REP_OFFSET_STD,
            level=f"P{level + 3}")
    return dcnv1_level_kernels(dev, g, ops, errs, REP_DCN_SHAPES, inputs,
                               "reppoints_levels")


def groie_roi_kernels(dev, g, ops, errs):
    """Kernels B and D at GRoIE's shapes: GROIE_ROIS rois of every FPN
    scale (``sized_rois``, a quarter a level, P2-sized ones covering all of
    P5) on each of P2-P5 of the 800 x 1344 bucket, f32 maps [1, h, w, 256]
    as the extractor pools them: B against its plain version (ROI_F32_ATOL)
    and D against ``roi_align_backward_plain`` (ROI_GRAD_F32_REL x max
    |grad|), each timed beside its plain version (plain, kernel, kernel,
    plain) with its bound (B's from the map pixels the rois read). Returns
    ({level: B entry}, {level: D entry})."""
    gen = torch.Generator().manual_seed(23)
    hw = (800, 1344)
    rois = torch.cat([sized_rois(dev, GROIE_ROIS // 4, lv, hw, gen)
                      for lv in range(4)])
    binds = torch.zeros(rois.shape[0], dtype=torch.int64, device=dev)
    b_out, d_out = {}, {}
    for i, (h, w) in enumerate(GROIE_LEVELS):
        scale = 1.0 / (4 * 2 ** i)
        f = torch.randn((1, h, w, 256), generator=gen).to(dev)
        got = ops.roi_align(f, rois, scale, batch_inds=binds)
        want = ops.roi_align(f, rois, scale, batch_inds=binds, impl="plain")
        check_close(f"groie B P{i + 2}", got, want, 0.0, ROI_F32_ATOL)
        ms, plain_ms, _ = compare_times(
            lambda: ops.roi_align(f, rois, scale, batch_inds=binds),
            lambda: ops.roi_align(f, rois, scale, batch_inds=binds,
                                  impl="plain"))
        pixels = roi_footprint_pixels(rois, scale, h, w)
        nbytes, flops = roi_align_cost(1, h, w, 256, rois.shape[0], 4, 8,
                                       map_pixels=pixels)
        bound_ms, bound_by = bound(nbytes, flops, F32_FLOP_PER_S)
        key = f"P{i + 2}"
        errs[f"roi_align_groie_{key}"] = max_err(got, want)
        b_out[key] = dict(
            rois=int(rois.shape[0]), map=[h, w, 256], map_pixels_read=pixels,
            map_share_read=pixels / (h * w), max_abs_err=max_err(got, want),
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            share_of_bound=bound_ms / ms, library_ms=None)
        grad_out = torch.randn(got.shape, generator=gen).to(dev)
        shape = (1, h, w, 256)
        dk = ops.roi_align_backward(grad_out, rois, binds, shape, scale)
        dp = ops.roi_align_backward_plain(grad_out, rois, binds, shape, scale)
        check_close(f"groie D {key}", dk, dp, 0.0,
                    ROI_GRAD_F32_REL * dp.abs().max().item())
        ms, plain_ms, _ = compare_times(
            lambda: ops.roi_align_backward(grad_out, rois, binds, shape,
                                           scale),
            lambda: ops.roi_align_backward_plain(grad_out, rois, binds,
                                                 shape, scale))
        nbytes, flops, atomics = roi_align_backward_cost(
            1, h, w, 256, rois.shape[0], 4, 8)
        bound_ms, bound_by = bound(nbytes, flops, F32_FLOP_PER_S)
        errs[f"roi_align_backward_groie_{key}"] = max_err(dk, dp)
        d_out[key] = dict(
            rois=int(rois.shape[0]), map=[h, w, 256],
            max_abs_err=max_err(dk, dp), ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            share_of_bound=bound_ms / ms, atomic_adds=atomics,
            library_ms=None)
    return b_out, d_out


def rcnn_roi_kernels(dev, g, ops, errs):
    """Kernels B and D at the DC5 two-stage families' shapes on one map
    RCNN_MAP: the 14x14 bodies (``gather14x2``, ``scatter14x2``) over
    RCNN_GRID_ROIS rois, once as Grid R-CNN's (``test_rois``) and once as the
    mask heads' (``mask_head_rois``: about random gts), the first roi of each
    outside the map, which must give 0; f32 (the grid and mask heads' maps)
    and bf16; B against its plain version (ROI_F32_ATOL / ROI_BF16_TOL), D
    against ``roi_align_backward_plain`` and torch autograd through the plain
    RoIAlign (ROI_GRAD_F32_REL x max |grad|, bf16 also ROI_GRAD_BF16_RTOL), D
    never all zero; then B's 7x7 body at PISA's RCNN_PISA_CANDIDATES
    candidates and at Double-Head's RCNN_DH_ROIS rois scaled 1.3x (many past
    the map), f32. Each f32 case timed beside its plain version (plain,
    kernel, kernel, plain) and from a CUDA graph, with its bound. Returns
    ({case: B entry}, {case: D entry})."""
    from lowlightenvironmentvideoobjectdetection_torch.models.detectors import (  # noqa: E501
        roi_head_families as RH)
    gen = torch.Generator().manual_seed(29)
    h, w, c = RCNN_MAP
    b_out, d_out = {}, {}

    def b_case(key, rois, out_size, dtypes=(torch.float32, torch.bfloat16)):
        body = f"gather{out_size}x2"
        for dtype in dtypes:
            f = torch.randn((h, w, c), generator=gen).to(dev, dtype)
            n_body = ops.roi_align.body_launches[body]
            got = ops.roi_align(f, rois, 1 / 16, out_size=out_size)
            if ops.roi_align.body_launches[body] != n_body + 1:
                raise AssertionError(f"rcnn B {key}: not the {body} body")
            want = ops.roi_align(f, rois, 1 / 16, out_size=out_size,
                                 impl="plain")
            tol = ROI_F32_ATOL if dtype == torch.float32 else ROI_BF16_TOL
            check_close(f"rcnn B {key}", got, want,
                        0.0 if dtype == torch.float32 else tol, tol)
            errs[f"roi_align_rcnn_{key}_{str(dtype)[6:]}"] = max_err(got,
                                                                     want)
        f = torch.randn((h, w, c), generator=gen).to(dev)
        ms, plain_ms, _ = compare_times(
            lambda: ops.roi_align(f, rois, 1 / 16, out_size=out_size),
            lambda: ops.roi_align(f, rois, 1 / 16, out_size=out_size,
                                  impl="plain"))
        gms = graph_ms(lambda: ops.roi_align(f, rois, 1 / 16,
                                             out_size=out_size))
        nbytes, flops = roi_align_cost(1, h, w, c, rois.shape[0], 4,
                                       out_size=out_size)
        bound_ms, bound_by = bound(nbytes, flops, F32_FLOP_PER_S)
        b_out[key] = dict(
            body=body, rois=int(rois.shape[0]), map=[h, w, c],
            dtype="float32", max_abs_err=errs[
                f"roi_align_rcnn_{key}_float32"], ms=ms, graph_ms=gms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            share_of_bound=bound_ms / ms, graph_share_of_bound=bound_ms / gms,
            library_ms=None, library_note=NO_LIBRARY_ROI_ALIGN,
            bytes=nbytes, flops=flops)

    cases = [(f"{kind}14_{n}", make(dev, n, h, w, gen))
             for kind, make in (("grid", test_rois),
                                ("mask_head", mask_head_rois))
             for n in RCNN_GRID_ROIS]
    for key, rois in cases:
        n = rois.shape[0]
        b_case(key, rois, 14)
        if ops.roi_align(torch.randn((h, w, c), generator=gen).to(dev),
                         rois[:1], 1 / 16, out_size=14).abs().max() != 0:
            raise AssertionError("rcnn B 14x14: a roi outside the map is "
                                 "not 0")
        backward = ops.roi_align_backward
        shape = (h, w, c)
        fz = torch.zeros(shape, device=dev, requires_grad=True)
        out = ops.roi_align(fz, rois, 1 / 16, out_size=14, impl="plain")
        for dtype in (torch.float32, torch.bfloat16):
            grad_out = torch.randn((n, 14, 14, c), generator=gen).to(dev,
                                                                     dtype)
            n_body = backward.body_launches["scatter14x2"]
            dk = backward(grad_out, rois, None, shape, 1 / 16, out_size=14)
            if backward.body_launches["scatter14x2"] != n_body + 1:
                raise AssertionError("rcnn D: not the scatter14x2 body")
            auto = torch.autograd.grad(out, fz, grad_out.float(),
                                       retain_graph=True)[0].to(dtype)
            dp = ops.roi_align_backward_plain(grad_out, rois, None, shape,
                                              1 / 16, out_size=14)
            atol = ROI_GRAD_F32_REL * auto.float().abs().max().item()
            rtol = 0.0 if dtype == torch.float32 else ROI_GRAD_BF16_RTOL
            check_close(f"rcnn D {key} vs autograd", dk, auto, rtol, atol)
            check_close(f"rcnn D {key} vs plain", dk, dp, rtol, atol)
            tag = f"roi_align_backward_rcnn_{key}_{str(dtype)[6:]}"
            errs[tag] = max_err(dk, auto)
            errs[tag + "_vs_plain"] = max_err(dk, dp)
            errs[tag + "_max_abs_grad"] = auto.float().abs().max().item()
            if dk.float().abs().max() == 0:
                raise AssertionError("rcnn D: an all-zero gradient")
        grad_out = torch.randn((n, 14, 14, c), generator=gen).to(dev)
        ms, plain_ms, _ = compare_times(
            lambda: backward(grad_out, rois, None, shape, 1 / 16,
                             out_size=14),
            lambda: ops.roi_align_backward_plain(grad_out, rois, None, shape,
                                                 1 / 16, out_size=14))
        gms = graph_ms(lambda: backward(grad_out, rois, None, shape, 1 / 16,
                                        out_size=14))
        nbytes, flops, atomics = roi_align_backward_cost(
            1, h, w, c, n, 4, out_size=14)
        bound_ms, bound_by = bound(nbytes, flops, F32_FLOP_PER_S)
        d_out[key] = dict(
            body="scatter14x2", rois=n, map=[h, w, c], dtype="float32",
            max_abs_err=errs[f"roi_align_backward_rcnn_{key}_float32"],
            ms=ms, graph_ms=gms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, share_of_bound=bound_ms / ms,
            graph_share_of_bound=bound_ms / gms, atomic_adds=atomics,
            library_ms=None, library_note=NO_LIBRARY_ROI_ALIGN,
            bytes=nbytes, flops=flops)
        del fz, out
    # PISA: the gts and 600 proposals, one pass a step without gradient
    b_case("pisa_candidates", test_rois(dev, RCNN_PISA_CANDIDATES, h, w,
                                        gen), 7, (torch.float32,))
    # Double-Head: the regression branch's rois, 1.3x about their centres
    dh = RH.roi_rescale(test_rois(dev, RCNN_DH_ROIS, h, w, gen),
                        RH.DH_REG_ROI_SCALE)
    b_case("double_head_1.3x", dh, 7, (torch.float32,))
    b_out["double_head_1.3x"]["rois_past_the_map"] = int(
        ((dh[:, :2] < 0).any(1) | (dh[:, 2] > w * 16)
         | (dh[:, 3] > h * 16)).sum())
    return b_out, d_out


def crpn_dcn_kernels(dev, g, ops, errs):
    """E, F and G at CRPN_DCN_SHAPES with Cascade RPN's stage-2 offsets:
    ``CascadeRPNHead.stage2_offsets`` of its single anchors refined by
    N(0, CRPN_DELTA_STD^2) deltas (``dcnv1_level_kernels``, key
    ``cascade_rpn_levels``)."""
    from lowlightenvironmentvideoobjectdetection_torch.core import boxes
    from lowlightenvironmentvideoobjectdetection_torch.models.dense_heads import (  # noqa: E501
        cascade_rpn_head as CRPN)
    head = CRPN.CascadeRPNHead(256)

    def inputs(shape):
        _, c, h, w = shape
        x = torch.randn(1, c, h, w, generator=g).to(dev)
        anchors = head.base_anchors(h, w, "cpu")
        deltas = CRPN_DELTA_STD * torch.randn(h * w, 4, generator=g)
        refined = boxes.delta2bbox(anchors, deltas, stds=CRPN.S1_STDS)
        off = head.stage2_offsets(refined, h, w)
        return x, off.contiguous().to(dev), dict(
            offsets="refined anchors", delta_std=CRPN_DELTA_STD,
            offset_abs_max_px=float(off.abs().max()))
    return dcnv1_level_kernels(dev, g, ops, errs, CRPN_DCN_SHAPES, inputs,
                               "cascade_rpn_levels")


def mask_target_inputs(dev, gen, kind):
    """Kernel B's mask-target operands at MASK_TARGET: box-filled (or
    random 0/1) masks [G, H, W, 1] f32 on the card, rois about the gts
    (each corner moved by up to 20% of its gt's side, the first ones past
    the image or of zero area) and their matched gt."""
    g, n = MASK_TARGET["gts"], MASK_TARGET["rois"]
    h, w = MASK_TARGET["hw"]
    x1 = torch.rand(g, generator=gen) * (w - 64)
    y1 = torch.rand(g, generator=gen) * (h - 64)
    gts = torch.stack([x1, y1, x1 + 16 + torch.rand(g, generator=gen) * 400,
                       y1 + 16 + torch.rand(g, generator=gen) * 300], 1)
    matched = torch.randint(0, g, (n,), generator=gen)
    c = gts[matched]
    side = (c[:, 2:] - c[:, :2]).repeat(1, 2)
    rois = c + (torch.rand(n, 4, generator=gen) * 0.4 - 0.2) * side
    rois[:3] = torch.tensor([[-80.0, -60.0, -10.0, -5.0],
                             [w - 30.0, h - 20.0, w + 90.0, h + 70.0],
                             [100.0, 100.0, 100.0, 100.0]])
    if kind == "box":
        yy = torch.arange(h, dtype=torch.float32)[None, :, None]
        xx = torch.arange(w, dtype=torch.float32)[None, None, :]
        b = gts[:, :, None, None]
        masks = ((yy >= b[:, 1]) & (yy < b[:, 3]) & (xx >= b[:, 0])
                 & (xx < b[:, 2])).float()
    else:
        masks = (torch.rand(g, h, w, generator=gen) > 0.5).float()
    return (masks[..., None].contiguous().to(dev), rois.to(dev),
            matched.to(dev))


def mask_roi_kernels(dev, g, ops, errs):
    """The mask families' RoIAlign bodies. Kernel B's ``gather28x2`` (the
    mask targets: scalar loads of 1-channel f32 masks, each roi's matched
    gt its map index, scale 1) at MASK_TARGET on box-filled and random
    masks against its plain version (ROI_F32_ATOL), the box-filled case
    timed eagerly beside the plain version and from a CUDA graph, its
    bound from the mask pixels the rois read (the plain version's nonzero
    gradient); the binarised targets of both counted where they differ.
    The mask heads' 14x14 bodies are ``rcnn_roi_kernels``' cases
    ``mask_head14_*``. Returns {case: B entry}."""
    gen = torch.Generator().manual_seed(31)
    b_out = {}
    for kind in ("box", "random"):
        masks, rois, matched = mask_target_inputs(dev, gen, kind)
        n_body = ops.roi_align.body_launches["gather28x2"]
        got = ops.roi_align(masks, rois, 1.0, batch_inds=matched,
                            out_size=28)
        if ops.roi_align.body_launches["gather28x2"] != n_body + 1:
            raise AssertionError("mask B: not the gather28x2 body")
        want = ops.roi_align(masks, rois, 1.0, batch_inds=matched,
                             out_size=28, impl="plain")
        check_close(f"mask B 28x2 {kind}", got, want, 0.0, ROI_F32_ATOL)
        if got[0].abs().max() != 0 or got.abs().max() == 0:
            raise AssertionError("mask B 28x2: a roi outside the image is "
                                 "not 0, or every target is")
        errs[f"roi_align_mask_targets_{kind}"] = max_err(got, want)
        flips = int(((got >= 0.5) != (want >= 0.5)).sum())
        if kind != "box":
            b_out["targets_random"] = dict(
                body="gather28x2", rois=int(rois.shape[0]),
                max_abs_err=errs["roi_align_mask_targets_random"],
                binarised_flips=flips)
            continue
        call = lambda: ops.roi_align(masks, rois, 1.0,  # noqa: E731
                                     batch_inds=matched, out_size=28)
        ms, plain_ms, _ = compare_times(
            call, lambda: ops.roi_align(masks, rois, 1.0, batch_inds=matched,
                                        out_size=28, impl="plain"))
        gms = graph_ms(call)
        m = torch.zeros_like(masks, requires_grad=True)
        ops.roi_align_plain(m, rois, 1.0, batch_inds=matched,
                            out_size=28).sum().backward()
        pixels = int((m.grad != 0).sum())
        gts, h, w = masks.shape[0], *MASK_TARGET["hw"]
        nbytes, flops = roi_align_cost(gts, h, w, 1, rois.shape[0], 4,
                                       bind_bytes=8, out_size=28,
                                       map_pixels=pixels)
        bound_ms, bound_by = bound(nbytes, flops, F32_FLOP_PER_S)
        b_out["targets_box"] = dict(
            body="gather28x2", rois=int(rois.shape[0]), masks=[gts, h, w, 1],
            dtype="float32", max_abs_err=errs["roi_align_mask_targets_box"],
            binarised_flips=flips, mask_pixels_read=pixels, ms=ms,
            graph_ms=gms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, share_of_bound=bound_ms / ms,
            graph_share_of_bound=bound_ms / gms, library_ms=None,
            library_note=NO_LIBRARY_ROI_ALIGN, bytes=nbytes, flops=flops)
        del m
    return b_out


def variant_counting(levels):
    """A stand-in for ``multilevel_roi_align`` that appends each call's
    rois a level to ``levels``; (the module, the real function)."""
    from lowlightenvironmentvideoobjectdetection_torch.models.detectors import (
        fpn_faster_rcnn as FF)
    real = FF.multilevel_roi_align

    def counting(*a, **kw):
        kw["level_counts"] = levels
        return real(*a, **kw)

    return FF, real, counting


def open_loc_filter(model):
    """Zero the prior bias of a guided-anchoring head's ``conv_loc``: at
    the seeded init it puts sigmoid(loc) just under the 0.01 filter on
    every cell, so a seeded GA model has no valid proposals (GA-RPN) or
    detections (GA-RetinaNet); with 0 every cell passes."""
    head = getattr(model, "rpn_head", None)
    head = head if hasattr(head, "conv_loc") else getattr(
        model, "bbox_head", None)
    if hasattr(head, "conv_loc"):
        with torch.no_grad():
            head.conv_loc.bias.zero_()


def det_variants(dev, smi, kernels):
    """GA Faster R-CNN, GRoIE and Libra R-CNN (800 x 1344) and GA-RetinaNet
    (768 x 1280) at full width, bf16, 80 classes, seeded weights, through
    ``DetectorModel.inference_detector`` on VARIANT_IMAGES random 480 x 640
    frames and VARIANT_PROFILED more under the profiler: image ms, the
    device's idle share, peak memory, B's and E's launches each image
    (GA-RPN: E on P2-P6 and B once a non-empty level; GRoIE: B on each of
    P2-P5; Libra: B once a non-empty level; GA-RetinaNet: E twice on each
    of P3-P7, no B); the GA models with ``open_loc_filter``. Gate: those
    counts, B on ``gather7x2``, nothing else launched, finite results; at
    f32 the kernel path's detections equal the plain path's as sets
    (SET_BOX_TOL / SET_SCORE_TOL), none unmatched, some. Returns the launch
    counts (A-G) and B's bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        DetectorModel)
    from lowlightenvironmentvideoobjectdetection_torch.data.preprocess import (
        prepare_frames)
    t_phase = time.perf_counter()
    rng = np.random.RandomState(29)
    n = VARIANT_IMAGES + VARIANT_PROFILED
    raw = rng.randint(0, 256, (n,) + DET_HW + (3,)).astype(np.uint8)
    roi_align, dcn_e = kernels[1], kernels[4]
    total, bodies, runs, agree = [0] * len(kernels), {}, {}, {}
    levels = []
    FF, real, counting = variant_counting(levels)
    for name, cfg_path in VARIANT_CFGS:
        mtype, kw = detector_kwargs(cfg_path)
        det = DetectorModel(mtype, device=dev, **kw)
        open_loc_filter(det.model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*kernels)
        levels.clear()
        lat, ndet, b_each, e_each = [], [], [], []
        FF.multilevel_roi_align = counting
        try:
            for i in range(VARIANT_IMAGES):
                b0, e0 = roi_align.launches, dcn_e.launches
                t = time.perf_counter()
                res = det.inference_detector(raw[i])
                lat.append((time.perf_counter() - t) * 1e3)
                b_each.append(roi_align.launches - b0)
                e_each.append(dcn_e.launches - e0)
                ndet.append(sum(len(r) for r in res))
                if len(res) != det.num_classes or not all(
                        np.isfinite(r).all() for r in res):
                    raise AssertionError(f"det_variants {name}: bad result")
            frames = iter(range(VARIANT_IMAGES, n))
            window = flow_profiled(lambda: det.inference_detector(
                raw[next(frames)]), VARIANT_PROFILED)
        finally:
            FF.multilevel_roi_align = real
        counts = [k.launches for k in kernels]
        want_b = {"GRoIEFasterRCNN": 4 * n, "GARetinaNet": 0}.get(
            name, sum(sum(1 for c in lv if c) for lv in levels))
        want = [0, want_b, 0, 0, VARIANT_E_PER_IMAGE[name] * n, 0, 0]
        if counts != want or (name in ("GAFasterRCNN", "LibraFasterRCNN")
                              and len(levels) != n):
            raise AssertionError(f"det_variants {name}: launch counts "
                                 f"{counts}, want {want}")
        check_bodies(f"det_variants {name}", roi_align, gather7x2=want_b,
                     gather14x2=0)
        add_counts(bodies, dict(roi_align=roi_align.body_launches))
        steady = lat[1:]
        runs[name] = dict(
            config=cfg_path, bucket=[det.pad_h, det.pad_w], frames=n,
            frame0_ms=lat[0], median_frame_ms=statistics.median(steady),
            min_frame_ms=min(steady), max_frame_ms=max(steady),
            frame_ms=steady, device_window=window,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
            detections_per_frame=ndet, b_launches_per_image=b_each,
            e_launches_per_image=e_each,
            rois_per_level_frame0=levels[0] if levels else None,
            launches=dict(zip(KERNEL_NAMES, counts)))
        total = [a + b for a, b in zip(total, counts)]
        del det
        torch.cuda.empty_cache()
        # f32: the kernel path against the plain path on one frame
        mtype, kw = detector_kwargs(cfg_path, dtype="float32")
        det = DetectorModel(mtype, device=dev, **kw)
        open_loc_filter(det.model)
        imgs, shape, sf = prepare_frames(raw[:1], det.pad_h, det.pad_w,
                                         device=dev)
        sf = torch.as_tensor(sf, device=dev)
        reset_counts(*kernels)
        got = det.detect(imgs[0], shape, sf)
        if not roi_align.launches and not dcn_e.launches:
            raise AssertionError(f"det_variants {name} f32: no kernel ran")
        det.impl = "plain"
        reset_counts(*kernels)
        want_d = det.detect(imgs[0], shape, sf)
        if any(k.launches for k in kernels):
            raise AssertionError(f"det_variants {name}: the plain path "
                                 f"launched a kernel")
        sets = match_sets(got, want_d)
        if sets["unmatched"] or sets["n_got"] != sets["n_want"] or \
                not sets["n_want"]:
            raise AssertionError(f"det_variants {name} f32: sets {sets}")
        agree[name] = sets
        del det, imgs
        torch.cuda.empty_cache()
    reset_counts(*kernels)
    phase("det_variants", card=smi, frame_hw=DET_HW, models=runs,
          f32_kernel_vs_plain=dict(sets=agree, tolerances=dict(
              box_px=SET_BOX_TOL, score=SET_SCORE_TOL)),
          launches=dict(zip(KERNEL_NAMES, total)),
          phase_s=time.perf_counter() - t_phase)
    return total, dict(roi_align=bodies.get("roi_align", {}),
                       roi_align_backward={})


def det_variants_train(dev, smi, kernels, root, train_ann):
    """The training CLI's image route for the four VARIANT_CFGS on the
    COCO tree ``det_train`` wrote (VARIANT_TRAIN_SCALE: the configs'
    resize), bf16, seeded weights, VARIANT_TRAIN_STEPS steps
    each, the last ones profiled. Gates: finite losses with each family's
    terms; D as often as B (GRoIE: 4 a step; GA-RPN and Libra once a
    non-empty level; GA-RetinaNet none); E, F and G 5 times a step for
    GA-RPN and 10 for GA-RetinaNet, none for the others. Returns the launch
    counts (A-G) and B's and D's bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.tools import (
        train as cli)
    t_phase = time.perf_counter()
    total, bodies, runs = [0] * len(kernels), {}, {}
    levels = []
    FF, real, counting = variant_counting(levels)
    terms = {"GAFasterRCNN": "loss_anchor_shape", "GRoIEFasterRCNN":
             "loss_bbox", "LibraFasterRCNN": "loss_bbox",
             "GARetinaNet": "loss_shape"}
    for name, cfg_path in VARIANT_CFGS:
        scale = VARIANT_TRAIN_SCALE[name]
        pipeline = [dict(type="LoadImageFromFile"),
                    dict(type="LoadAnnotations", with_bbox=True),
                    dict(type="Resize", img_scale=scale),
                    dict(type="RandomFlip", flip_ratio=0.5),
                    dict(type="Normalize"), dict(type="Pad", size_divisor=32)]
        d = dict(type="CocoDataset", ann_file=train_ann,
                 img_prefix=f"{root}/coco/", pipeline=pipeline)
        window = StepWindow(VARIANT_TRAIN_STEPS, VARIANT_TRAIN_SKIP)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*kernels)
        levels.clear()
        FF.multilevel_roi_align = counting
        t0 = time.perf_counter()
        try:
            out = cli.main([str(REPO / cfg_path), "--seed", "0",
                            "--work-dir", f"{root}/work_variants", "--steps",
                            str(VARIANT_TRAIN_STEPS), "--cfg-options",
                            f"data.train={d!r}", "data.workers_per_gpu=0"],
                           on_step=window)
        finally:
            FF.multilevel_roi_align = real
        counts = [k.launches for k in kernels]
        steps = VARIANT_TRAIN_STEPS
        want_b = {"GRoIEFasterRCNN": 4 * steps, "GARetinaNet": 0}.get(
            name, sum(sum(1 for c in lv if c) for lv in levels))
        e = VARIANT_E_PER_IMAGE[name] * steps
        want = [0, want_b, 0, want_b, e, e, e]
        if counts != want or not all(
                np.isfinite(v) for m in out["metrics"] for v in m.values()) \
                or not all(terms[name] in m for m in out["metrics"]):
            raise AssertionError(f"det_variants_train {name}: counts "
                                 f"{counts}, want {want}; metrics "
                                 f"{out['metrics']}")
        check_bodies(f"det_variants_train {name} roi_align", kernels[1],
                     gather7x2=want_b, gather14x2=0)
        check_bodies(f"det_variants_train {name} roi_align_backward",
                     kernels[3], scatter7x2=want_b, scatter14x2=0)
        add_counts(bodies, dict(roi_align=kernels[1].body_launches,
                                roi_align_backward=kernels[3].body_launches))
        step_ms = [(y - x) * 1e3 for x, y in zip([t0] + window.stamps,
                                                window.stamps)]
        runs[name] = dict(
            config=cfg_path, steps=steps, first_step_ms=step_ms[0],
            median_step_ms=statistics.median(step_ms[1:VARIANT_TRAIN_SKIP]),
            step_ms=step_ms, device_window=window.window,
            losses=out["metrics"],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
            launches=dict(zip(KERNEL_NAMES, counts)),
            rois_per_level_a_step=levels[:] or None)
        total = [a + c for a, c in zip(total, counts)]
        del out
        torch.cuda.empty_cache()
    reset_counts(*kernels)
    phase("det_variants_train", card=smi, tree=COCO_TREE, runs=runs,
          launches=dict(zip(KERNEL_NAMES, total)),
          phase_s=time.perf_counter() - t_phase)
    return total, dict(roi_align=bodies.get("roi_align", {}),
                       roi_align_backward=bodies.get("roi_align_backward",
                                                     {}))


def open_cls_prior(model):
    """Zero the prior bias (-4.595) of a dense head's classifier: at the
    seeded init it keeps every sigmoid score at 0.01, under the decodes'
    0.05 floor (FCOS's and ATSS's further halved by the centerness), so a
    seeded dense model detects nothing; with 0 the scores spread about
    0.5."""
    head = model.bbox_head
    for name in DENSE_CLS:
        if hasattr(head, name):
            with torch.no_grad():
                getattr(head, name).bias.zero_()
            return
    raise AssertionError(f"no classifier among {DENSE_CLS}")


def det_dense(dev, smi, kernels):
    """The dense one-stage heads of DENSE_CFGS at full width, bf16, 80
    classes, seeded weights with ``open_cls_prior``, through
    ``DetectorModel.inference_detector`` (the 768 x 1280 bucket) on
    DENSE_IMAGES random 480 x 640 frames and DENSE_PROFILED more under the
    profiler: image ms, the device's idle share, peak memory, E's launches
    each image. Gates: E DENSE_E_PER_IMAGE times an image (VFNet and
    RepPoints 10), nothing else launched (no B), finite results; VFNet and
    RepPoints at f32: the kernel path's detections equal the plain path's
    as sets
    (SET_BOX_TOL / SET_SCORE_TOL), none unmatched, some. Returns the
    launch counts (A-G) and empty bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        DetectorModel)
    from lowlightenvironmentvideoobjectdetection_torch.data.preprocess import (
        prepare_frames)
    t_phase = time.perf_counter()
    rng = np.random.RandomState(31)
    n = DENSE_IMAGES + DENSE_PROFILED
    raw = rng.randint(0, 256, (n,) + DET_HW + (3,)).astype(np.uint8)
    dcn_e = kernels[4]
    total, runs, agree = [0] * len(kernels), {}, {}
    for name, cfg_path in DENSE_CFGS:
        mtype, kw = detector_kwargs(cfg_path)
        det = DetectorModel(mtype, device=dev, **kw)
        open_cls_prior(det.model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*kernels)
        lat, ndet, e_each = [], [], []
        for i in range(DENSE_IMAGES):
            e0 = dcn_e.launches
            t = time.perf_counter()
            res = det.inference_detector(raw[i])
            lat.append((time.perf_counter() - t) * 1e3)
            e_each.append(dcn_e.launches - e0)
            ndet.append(sum(len(r) for r in res))
            if len(res) != det.num_classes or not all(
                    np.isfinite(r).all() for r in res):
                raise AssertionError(f"det_dense {name}: bad result")
        frames = iter(range(DENSE_IMAGES, n))
        window = flow_profiled(lambda: det.inference_detector(
            raw[next(frames)]), DENSE_PROFILED)
        counts = [k.launches for k in kernels]
        want = [0, 0, 0, 0, DENSE_E_PER_IMAGE.get(name, 0) * n, 0, 0]
        if counts != want:
            raise AssertionError(f"det_dense {name}: launch counts {counts}, "
                                 f"want {want}")
        steady = lat[1:]
        runs[name] = dict(
            config=cfg_path, bucket=[det.pad_h, det.pad_w], frames=n,
            frame0_ms=lat[0], median_frame_ms=statistics.median(steady),
            min_frame_ms=min(steady), max_frame_ms=max(steady),
            frame_ms=steady, device_window=window,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
            detections_per_frame=ndet, e_launches_per_image=e_each,
            launches=dict(zip(KERNEL_NAMES, counts)))
        total = [a + b for a, b in zip(total, counts)]
        del det
        torch.cuda.empty_cache()
        if name not in DENSE_E_PER_IMAGE:
            continue
        # f32: the kernel path against the plain path on one frame
        mtype, kw = detector_kwargs(cfg_path, dtype="float32")
        det = DetectorModel(mtype, device=dev, **kw)
        open_cls_prior(det.model)
        imgs, shape, sf = prepare_frames(raw[:1], det.pad_h, det.pad_w,
                                         device=dev)
        sf = torch.as_tensor(sf, device=dev)
        reset_counts(*kernels)
        got = det.detect(imgs[0], shape, sf)
        if dcn_e.launches != DENSE_E_PER_IMAGE[name]:
            raise AssertionError(f"det_dense {name} f32: E launched "
                                 f"{dcn_e.launches} times")
        det.impl = "plain"
        reset_counts(*kernels)
        want_d = det.detect(imgs[0], shape, sf)
        if any(k.launches for k in kernels):
            raise AssertionError(f"det_dense {name}: the plain path "
                                 f"launched a kernel")
        sets = match_sets(got, want_d)
        if sets["unmatched"] or sets["n_got"] != sets["n_want"] or \
                not sets["n_want"]:
            raise AssertionError(f"det_dense {name} f32: sets {sets}")
        agree[name] = sets
        del det, imgs
        torch.cuda.empty_cache()
    reset_counts(*kernels)
    phase("det_dense", card=smi, frame_hw=DET_HW, models=runs,
          f32_kernel_vs_plain=dict(sets=agree, tolerances=dict(
              box_px=SET_BOX_TOL, score=SET_SCORE_TOL)),
          launches=dict(zip(KERNEL_NAMES, total)),
          phase_s=time.perf_counter() - t_phase)
    return total, dict(roi_align={}, roi_align_backward={})


def det_dense_train(dev, smi, kernels, root, train_ann):
    """The training CLI's image route for the thirteen DENSE_CFGS on the
    COCO tree ``det_train`` wrote (resized into the 768 x 1280 bucket), bf16,
    seeded weights, DENSE_TRAIN_STEPS steps each, the last ones profiled:
    step ms, idle share, peak memory. Gates: finite losses with each
    family's terms (DENSE_TERM); E, F and G DENSE_E_PER_IMAGE times a step
    (VFNet and RepPoints 10), no kernel for the others. Returns the launch
    counts (A-G) and empty bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.tools import (
        train as cli)
    t_phase = time.perf_counter()
    total, runs = [0] * len(kernels), {}
    pipeline = [dict(type="LoadImageFromFile"),
                dict(type="LoadAnnotations", with_bbox=True),
                dict(type="Resize", img_scale=DENSE_TRAIN_SCALE),
                dict(type="RandomFlip", flip_ratio=0.5),
                dict(type="Normalize"), dict(type="Pad", size_divisor=32)]
    d = dict(type="CocoDataset", ann_file=train_ann,
             img_prefix=f"{root}/coco/", pipeline=pipeline)
    for name, cfg_path in DENSE_CFGS:
        window = StepWindow(DENSE_TRAIN_STEPS, DENSE_TRAIN_SKIP)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*kernels)
        t0 = time.perf_counter()
        out = cli.main([str(REPO / cfg_path), "--seed", "0",
                        "--work-dir", f"{root}/work_dense", "--steps",
                        str(DENSE_TRAIN_STEPS), "--cfg-options",
                        f"data.train={d!r}", "data.workers_per_gpu=0"],
                       on_step=window)
        counts = [k.launches for k in kernels]
        e = DENSE_E_PER_IMAGE.get(name, 0) * DENSE_TRAIN_STEPS
        want = [0, 0, 0, 0, e, e, e]
        if counts != want or not all(
                np.isfinite(v) for m in out["metrics"] for v in m.values()) \
                or not all(DENSE_TERM[name] in m for m in out["metrics"]):
            raise AssertionError(f"det_dense_train {name}: counts {counts}, "
                                 f"want {want}; metrics {out['metrics']}")
        step_ms = [(y - x) * 1e3 for x, y in zip([t0] + window.stamps,
                                                window.stamps)]
        runs[name] = dict(
            config=cfg_path, steps=DENSE_TRAIN_STEPS,
            first_step_ms=step_ms[0],
            median_step_ms=statistics.median(step_ms[1:DENSE_TRAIN_SKIP]),
            step_ms=step_ms, device_window=window.window,
            losses=out["metrics"],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
            launches=dict(zip(KERNEL_NAMES, counts)))
        total = [a + c for a, c in zip(total, counts)]
        del out
        torch.cuda.empty_cache()
    reset_counts(*kernels)
    phase("det_dense_train", card=smi, tree=COCO_TREE, runs=runs,
          launches=dict(zip(KERNEL_NAMES, total)),
          phase_s=time.perf_counter() - t_phase)
    return total, dict(roi_align={}, roi_align_backward={})


def det_autoaugment_train(dev, smi, kernels, root, train_ann):
    """AUTOAUG_CFG through the training CLI on the COCO tree ``det_train``
    wrote, its own pipeline (AutoAugment on the host, in the main process:
    no loader workers), bf16, seeded weights, AUTOAUG_STEPS steps, the
    last ones profiled: step ms, the loader's host ms, idle share. Gates:
    finite losses with RetinaNet's terms; no kernel launched; every
    policy of the config drawn at least once over the steps' images (each
    draw read ahead of the step's own, from the same generator state; the
    loader's read-ahead sample after the last step is not counted).
    Returns the launch counts (A-G) and empty bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.config import (
        load_config)
    from lowlightenvironmentvideoobjectdetection_torch.data.pipelines import (
        auto_augment as AA)
    from lowlightenvironmentvideoobjectdetection_torch.tools import (
        train as cli)
    t_phase = time.perf_counter()
    policies = [t["policies"] for t in load_config(str(REPO / AUTOAUG_CFG))[
        "data"]["train"]["pipeline"] if t["type"] == "AutoAugment"][0]
    real, drawn, host_ms = AA.AutoAugment.transform, [], []

    def counting(self, results, np_rng):
        state = np_rng.get_state()
        drawn.append(int(np_rng.randint(len(self.policies))))
        np_rng.set_state(state)
        t = time.perf_counter()
        out = real(self, results, np_rng)
        host_ms.append((time.perf_counter() - t) * 1e3)
        return out

    window = StepWindow(AUTOAUG_STEPS, AUTOAUG_SKIP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    AA.AutoAugment.transform = counting
    t0 = time.perf_counter()
    try:
        out = cli.main([str(REPO / AUTOAUG_CFG), "--seed", "0",
                        "--work-dir", f"{root}/work_autoaug", "--steps",
                        str(AUTOAUG_STEPS), "--cfg-options",
                        f"data.train.ann_file={train_ann}",
                        f"data.train.img_prefix={root}/coco/",
                        "data.workers_per_gpu=0"], on_step=window)
    finally:
        AA.AutoAugment.transform = real
    counts = [k.launches for k in kernels]
    every_policy = set(drawn[:AUTOAUG_STEPS]) == set(range(len(policies)))
    if any(counts) or not every_policy or not all(
            np.isfinite(v) for m in out["metrics"] for v in m.values()) \
            or not all({"loss_cls", "loss_bbox"} <= set(m)
                       for m in out["metrics"]):
        raise AssertionError(f"det_autoaugment_train: counts {counts}, "
                             f"policies drawn {drawn}; metrics "
                             f"{out['metrics']}")
    step_ms = [(y - x) * 1e3 for x, y in zip([t0] + window.stamps,
                                            window.stamps)]
    phase("det_autoaugment_train", card=smi, config=AUTOAUG_CFG,
          tree=COCO_TREE, steps=AUTOAUG_STEPS, first_step_ms=step_ms[0],
          median_step_ms=statistics.median(step_ms[1:AUTOAUG_SKIP]),
          step_ms=step_ms, device_window=window.window,
          policies_drawn=drawn, autoaugment_host_ms=host_ms,
          losses=out["metrics"], loader_ms=loader_summary(out["timings"], 1),
          peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
          launches=dict(zip(KERNEL_NAMES, counts)),
          phase_s=time.perf_counter() - t_phase)
    del out
    torch.cuda.empty_cache()
    return counts, dict(roi_align={}, roi_align_backward={})


def rcnn_want(name, n_images):
    """det_rcnn's launch counts (A-G) and B's bodies over ``n_images``."""
    b7, b14, e = RCNN_TEST[name]
    return ([0, (b7 + b14) * n_images, 0, 0, e * n_images, 0, 0],
            dict(gather7x2=b7 * n_images, gather14x2=b14 * n_images))


def det_rcnn(dev, smi, kernels):
    """The two-stage families of RCNN_CFGS at full width, bf16, 80 classes
    (Cascade RPN's one), seeded weights, through
    ``DetectorModel.inference_detector`` (the 608 x 1024 bucket) on
    RCNN_IMAGES random 480 x 640 frames and RCNN_PROFILED more under the
    profiler: image ms, the device's busy ms and idle share, peak memory,
    launches an image by body. Gates: B on each body and E as RCNN_TEST
    says an image, nothing else; finite results; at f32 the kernel path's
    detections equal the plain path's as sets for RCNN_AGREE (Grid R-CNN:
    the first path through ``gather14x2``; Cascade RPN: E), none unmatched,
    some. Returns the launch counts (A-G) and B's bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        DetectorModel)
    from lowlightenvironmentvideoobjectdetection_torch.data.preprocess import (
        prepare_frames)
    t_phase = time.perf_counter()
    rng = np.random.RandomState(37)
    n = RCNN_IMAGES + RCNN_PROFILED
    raw = rng.randint(0, 256, (n,) + DET_HW + (3,)).astype(np.uint8)
    roi_align = kernels[1]
    total, bodies, runs, agree = [0] * len(kernels), {}, {}, {}
    for name, cfg_path in RCNN_CFGS:
        mtype, kw = detector_kwargs(cfg_path)
        det = DetectorModel(mtype, device=dev, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*kernels)
        lat, ndet = [], []
        for i in range(RCNN_IMAGES):
            t = time.perf_counter()
            res = det.inference_detector(raw[i])
            lat.append((time.perf_counter() - t) * 1e3)
            ndet.append(sum(len(r) for r in res))
            if len(res) != det.num_classes or not all(
                    np.isfinite(r).all() for r in res):
                raise AssertionError(f"det_rcnn {name}: bad result")
        frames = iter(range(RCNN_IMAGES, n))
        window = flow_profiled(lambda: det.inference_detector(
            raw[next(frames)]), RCNN_PROFILED)
        counts = [k.launches for k in kernels]
        want, want_bodies = rcnn_want(name, n)
        if counts != want:
            raise AssertionError(f"det_rcnn {name}: launch counts {counts}, "
                                 f"want {want}")
        check_bodies(f"det_rcnn {name}", roi_align, **want_bodies)
        add_counts(bodies, dict(roi_align=roi_align.body_launches))
        steady = lat[1:]
        runs[name] = dict(
            config=cfg_path, bucket=[det.pad_h, det.pad_w],
            classes=det.num_classes, frames=n, frame0_ms=lat[0],
            median_frame_ms=statistics.median(steady),
            min_frame_ms=min(steady), max_frame_ms=max(steady),
            frame_ms=steady, device_window=window,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
            detections_per_frame=ndet,
            launches_per_image=dict(
                zip(("gather7x2", "gather14x2", "dcn_im2col"),
                    RCNN_TEST[name])),
            launches=dict(zip(KERNEL_NAMES, counts)))
        total = [a + b for a, b in zip(total, counts)]
        del det
        torch.cuda.empty_cache()
        if name not in RCNN_AGREE:
            continue
        mtype, kw = detector_kwargs(cfg_path, compute_dtype="float32")
        det = DetectorModel(mtype, device=dev, **kw)
        imgs, shape, sf = prepare_frames(raw[:1], det.pad_h, det.pad_w,
                                         device=dev)
        sf = torch.as_tensor(sf, device=dev)
        reset_counts(*kernels)
        got = det.detect(imgs[0], shape, sf)
        if [k.launches for k in kernels] != rcnn_want(name, 1)[0]:
            raise AssertionError(f"det_rcnn {name} f32: launches "
                                 f"{[k.launches for k in kernels]}")
        det.impl = "plain"
        reset_counts(*kernels)
        want_d = det.detect(imgs[0], shape, sf)
        if any(k.launches for k in kernels):
            raise AssertionError(f"det_rcnn {name}: the plain path "
                                 f"launched a kernel")
        sets = match_sets(got, want_d)
        if sets["unmatched"] or sets["n_got"] != sets["n_want"] or \
                not sets["n_want"]:
            raise AssertionError(f"det_rcnn {name} f32: sets {sets}")
        agree[name] = sets
        del det, imgs
        torch.cuda.empty_cache()
    reset_counts(*kernels)
    phase("det_rcnn", card=smi, frame_hw=DET_HW, models=runs,
          f32_kernel_vs_plain=dict(sets=agree, tolerances=dict(
              box_px=SET_BOX_TOL, score=SET_SCORE_TOL)),
          launches=dict(zip(KERNEL_NAMES, total)), body_launches=bodies,
          phase_s=time.perf_counter() - t_phase)
    return total, dict(roi_align=bodies.get("roi_align", {}),
                       roi_align_backward={})


def det_rcnn_train(dev, smi, kernels, root, train_ann):
    """The training CLI's image route for the seven RCNN_CFGS on the COCO
    tree ``det_train`` wrote (resized into the 608 x 1024 bucket), bf16,
    seeded weights, RCNN_TRAIN_STEPS steps each, the last ones profiled:
    step ms, idle share, peak memory, Dynamic R-CNN's ``batch_iou`` and
    ``batch_beta``. Gates: finite losses with each family's term
    (RCNN_TERM); B and D a step on each body and E, F, G as RCNN_TRAIN
    says (Grid's ``gather14x2`` and ``scatter14x2`` once a step, Cascade
    RPN's E, F, G once), nothing else. Returns the launch counts (A-G) and
    B's and D's bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.tools import (
        train as cli)
    t_phase = time.perf_counter()
    total, bodies, runs = [0] * len(kernels), {}, {}
    pipeline = [dict(type="LoadImageFromFile"),
                dict(type="LoadAnnotations", with_bbox=True),
                dict(type="Resize", img_scale=RCNN_TRAIN_SCALE),
                dict(type="RandomFlip", flip_ratio=0.5),
                dict(type="Normalize"), dict(type="Pad", size_divisor=16)]
    d = dict(type="CocoDataset", ann_file=train_ann,
             img_prefix=f"{root}/coco/", pipeline=pipeline)
    steps = RCNN_TRAIN_STEPS
    for name, cfg_path in RCNN_CFGS:
        window = StepWindow(steps, RCNN_TRAIN_SKIP)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*kernels)
        t0 = time.perf_counter()
        out = cli.main([str(REPO / cfg_path), "--seed", "0",
                        "--work-dir", f"{root}/work_rcnn", "--steps",
                        str(steps), "--cfg-options", f"data.train={d!r}",
                        "data.workers_per_gpu=0"], on_step=window)
        counts = [k.launches for k in kernels]
        b7, b14, d7, d14, e = RCNN_TRAIN[name]
        want = [0, (b7 + b14) * steps, 0, (d7 + d14) * steps, e * steps,
                e * steps, e * steps]
        if counts != want or not all(
                np.isfinite(v) for m in out["metrics"] for v in m.values()) \
                or not all(RCNN_TERM[name] in m for m in out["metrics"]):
            raise AssertionError(f"det_rcnn_train {name}: counts {counts}, "
                                 f"want {want}; metrics {out['metrics']}")
        check_bodies(f"det_rcnn_train {name} roi_align", kernels[1],
                     gather7x2=b7 * steps, gather14x2=b14 * steps)
        check_bodies(f"det_rcnn_train {name} roi_align_backward", kernels[3],
                     scatter7x2=d7 * steps, scatter14x2=d14 * steps)
        add_counts(bodies, dict(roi_align=kernels[1].body_launches,
                                roi_align_backward=kernels[3].body_launches))
        step_ms = [(y - x) * 1e3 for x, y in zip([t0] + window.stamps,
                                                window.stamps)]
        runs[name] = dict(
            config=cfg_path, steps=steps, first_step_ms=step_ms[0],
            median_step_ms=statistics.median(step_ms[1:RCNN_TRAIN_SKIP]),
            step_ms=step_ms, device_window=window.window,
            losses=out["metrics"],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
            launches=dict(zip(KERNEL_NAMES, counts)))
        if name == "DynamicRCNN":
            runs[name]["batch_iou"] = [m["batch_iou"] for m in out["metrics"]]
            runs[name]["batch_beta"] = [m["batch_beta"]
                                        for m in out["metrics"]]
        total = [a + c for a, c in zip(total, counts)]
        del out
        torch.cuda.empty_cache()
    reset_counts(*kernels)
    phase("det_rcnn_train", card=smi, tree=COCO_TREE, runs=runs,
          launches=dict(zip(KERNEL_NAMES, total)), body_launches=bodies,
          phase_s=time.perf_counter() - t_phase)
    return total, dict(roi_align=bodies.get("roi_align", {}),
                       roi_align_backward=bodies.get("roi_align_backward",
                                                     {}))


def det_zoo_eval(dev, smi, kernels, root, val_ann):
    """The test CLI's image route on the card over the COCO tree's val
    split for the zoo's later configs (DENSE_CFGS' last five, AUTOAUG_CFG,
    the seven RCNN_CFGS and the six MASK_CFGS) at their bf16, seeded
    weights as the CLI builds them (no checkpoint): the summary line,
    images/s. Gates: every image, 80 per-class lists (Cascade RPN's 1) of
    finite [N, 5] rows, mAP50 in [0, 1], E DENSE_E_PER_IMAGE times an
    image (RepPoints 10), B and E as RCNN_TEST (MASK_TEST) says an image on
    each body, nothing else launched.
    Returns the launch counts (A-G) and B's bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.tools import (
        test as tcli)
    import io
    t_phase = time.perf_counter()
    total, runs = [0] * len(kernels), {}
    n_images = COCO_TREE["val_images"]
    test = dict(type="CocoDataset", ann_file=val_ann,
                img_prefix=f"{root}/coco/")
    bodies = {}
    for name, cfg_path in (DENSE_CFGS[-5:] + (("RetinaNet", AUTOAUG_CFG),)
                           + RCNN_CFGS + MASK_CFGS):
        reset_counts(*kernels)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = tcli.main([str(REPO / cfg_path), "--cfg-options",
                             f"data.test={test!r}"])
        line = buf.getvalue().strip().splitlines()[-1]
        counts = [k.launches for k in kernels]
        if name in RCNN_TEST or name in MASK_TEST:
            want, want_bodies = (rcnn_want if name in RCNN_TEST
                                 else mask_want)(name, n_images)
            check_bodies(f"det_zoo_eval {name}", kernels[1], **want_bodies)
            add_counts(bodies, dict(roi_align=kernels[1].body_launches))
        else:
            want = [0, 0, 0, 0, DENSE_E_PER_IMAGE.get(name, 0) * n_images,
                    0, 0]
        classes = 1 if name == "CascadeRPN" else 80
        if counts != want or out["summary"]["frames"] != n_images or not \
                all(len(r) == classes and all(
                    a.ndim == 2 and a.shape[1] == 5 and np.isfinite(a).all()
                    for a in r) for r in out["dets"]) \
                or not 0.0 <= out["metrics"]["mAP50"] <= 1.0:
            raise AssertionError(f"det_zoo_eval {cfg_path}: counts {counts}, "
                                 f"want {want}; {line}")
        runs[name if cfg_path != AUTOAUG_CFG else "AutoAugment"] = dict(
            config=cfg_path, summary_line=line,
            map50=out["metrics"]["mAP50"],
            frames_per_s=out["summary"]["fps"],
            detections=sum(len(a) for r in out["dets"] for a in r),
            launches=dict(zip(KERNEL_NAMES, counts)))
        total = [a + c for a, c in zip(total, counts)]
        del out
    reset_counts(*kernels)
    phase("det_zoo_eval", card=smi, images=n_images, runs=runs,
          launches=dict(zip(KERNEL_NAMES, total)), body_launches=bodies,
          phase_s=time.perf_counter() - t_phase)
    return total, dict(roi_align=bodies.get("roi_align", {}),
                       roi_align_backward={})


def mask_want(name, n_images):
    """det_mask's launch counts (A-G) and B's bodies over ``n_images``."""
    b7, b14 = MASK_TEST[name]
    return ([0, (b7 + b14) * n_images, 0, 0, 0, 0, 0],
            dict(gather7x2=b7 * n_images, gather14x2=b14 * n_images))


def det_mask(dev, smi, kernels):
    """The mask families of MASK_CFGS at full width, bf16, 80 classes,
    seeded weights, through ``DetectorModel.inference_detector`` (the 608
    x 1024 bucket; YOLACT's 768 x 1280), which drops the masks as the JAX
    API does, on MASK_IMAGES random 480 x 640 frames and MASK_PROFILED
    more under the profiler: image ms, the device's busy ms and idle
    share, peak memory, launches an image by body. Gates: B on each body
    as MASK_TEST says an image (Mask R-CNN's ``gather14x2`` once), nothing
    else; 80 lists of finite rows. Returns the launch counts (A-G) and
    B's bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        DetectorModel)
    t_phase = time.perf_counter()
    rng = np.random.RandomState(41)
    n = MASK_IMAGES + MASK_PROFILED
    raw = rng.randint(0, 256, (n,) + DET_HW + (3,)).astype(np.uint8)
    total, bodies, runs = [0] * len(kernels), {}, {}
    for name, cfg_path in MASK_CFGS:
        mtype, kw = detector_kwargs(cfg_path)
        det = DetectorModel(mtype, device=dev, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*kernels)
        lat, ndet = [], []
        for i in range(MASK_IMAGES):
            t = time.perf_counter()
            res = det.inference_detector(raw[i])
            lat.append((time.perf_counter() - t) * 1e3)
            ndet.append(sum(len(r) for r in res))
            if len(res) != det.num_classes or not all(
                    np.isfinite(r).all() for r in res):
                raise AssertionError(f"det_mask {name}: bad result")
        frames = iter(range(MASK_IMAGES, n))
        window = flow_profiled(lambda: det.inference_detector(
            raw[next(frames)]), MASK_PROFILED)
        counts = [k.launches for k in kernels]
        want, want_bodies = mask_want(name, n)
        if counts != want:
            raise AssertionError(f"det_mask {name}: launch counts {counts}, "
                                 f"want {want}")
        check_bodies(f"det_mask {name}", kernels[1], **want_bodies)
        add_counts(bodies, dict(roi_align=kernels[1].body_launches))
        runs[name] = dict(
            config=cfg_path, bucket=[det.pad_h, det.pad_w],
            classes=det.num_classes, frames=n, frame0_ms=lat[0],
            median_frame_ms=statistics.median(lat[1:]),
            frame_ms=lat[1:], device_window=window,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
            detections_per_frame=ndet,
            launches_per_image=dict(zip(("gather7x2", "gather14x2"),
                                        MASK_TEST[name])),
            launches=dict(zip(KERNEL_NAMES, counts)))
        total = [a + b for a, b in zip(total, counts)]
        del det
        torch.cuda.empty_cache()
    reset_counts(*kernels)
    phase("det_mask", card=smi, frame_hw=DET_HW, models=runs,
          launches=dict(zip(KERNEL_NAMES, total)), body_launches=bodies,
          phase_s=time.perf_counter() - t_phase)
    return total, dict(roi_align=bodies.get("roi_align", {}),
                       roi_align_backward={})


def mask_pairs(got, want):
    """Index pairs (got row, want row) of equal detections (``match_rows``'
    tolerances), greedily in want's order."""
    gv = torch.nonzero(got.valid).flatten().tolist()
    pairs = []
    for j in torch.nonzero(want.valid).flatten().tolist():
        for i in gv:
            if (int(got.labels[i]) == int(want.labels[j])
                    and (got.boxes[i] - want.boxes[j]).abs().max()
                    < SET_BOX_TOL
                    and abs(float(got.scores[i] - want.scores[j]))
                    < SET_SCORE_TOL):
                pairs.append((i, j))
                gv.remove(i)
                break
    return pairs


def det_mask_agree(dev, kernels):
    """MASK_AGREE at f32 (TF32 off), full width, seeded weights, one
    480 x 640 frame in the bucket: the family module's detect on the
    kernel path (B as MASK_TEST says) and on the plain path (no launch).
    Gates: the detections equal as sets, none unmatched, some; each matched
    instance's mask pasted at the bucket's size (HTC: its averaged class
    probabilities pasted) differs in at most MASK_AGREE_PIXELS pixels.
    Prints ``eval_mask_ap`` of the kernel path's masks against the plain
    path's as ground truth."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        DetectorModel)
    from lowlightenvironmentvideoobjectdetection_torch.core.eval.instseg import (  # noqa: E501
        eval_mask_ap)
    from lowlightenvironmentvideoobjectdetection_torch.data.preprocess import (
        prepare_frames)
    from lowlightenvironmentvideoobjectdetection_torch.models.detectors import (
        htc as H, mask_rcnn as MK)
    from lowlightenvironmentvideoobjectdetection_torch.models.roi_heads import (
        mask_head as MH)
    t_phase = time.perf_counter()
    raw = np.random.RandomState(43).randint(
        0, 256, (1,) + DET_HW + (3,)).astype(np.uint8)
    out = {}
    for name, cfg_path in MASK_CFGS:
        if name not in MASK_AGREE:
            continue
        mtype, kw = detector_kwargs(cfg_path, compute_dtype="float32")
        det = DetectorModel(mtype, device=dev, **kw)
        imgs, shape, sf = prepare_frames(raw, det.pad_h, det.pad_w,
                                         device=dev)
        sf = torch.as_tensor(sf, device=dev)
        h, w = det.pad_h, det.pad_w

        def run(impl):
            if name == "HTC":
                d, probs = H.htc_detect(det.model, imgs[0], shape, det.aux,
                                        scale_factor=sf, impl=impl)
                return d, MH.paste_masks(MH.class_channel(probs, d.labels),
                                         d.boxes, h, w)
            return MK.mask_rcnn_detect(det.model, imgs[0], shape, det.aux,
                                       scale_factor=sf, impl=impl)

        reset_counts(*kernels)
        got, gmasks = run(None)
        if [k.launches for k in kernels] != mask_want(name, 1)[0]:
            raise AssertionError(f"det_mask_agree {name}: launches "
                                 f"{[k.launches for k in kernels]}")
        reset_counts(*kernels)
        want, wmasks = run("plain")
        if any(k.launches for k in kernels):
            raise AssertionError(f"det_mask_agree {name}: the plain path "
                                 "launched a kernel")
        sets = match_sets(got, want)
        if sets["unmatched"] or sets["n_got"] != sets["n_want"] or \
                not sets["n_want"]:
            raise AssertionError(f"det_mask_agree {name}: sets {sets}")
        pairs = mask_pairs(got, want)
        diff = [int((gmasks[i] != wmasks[j]).sum()) for i, j in pairs]
        if len(pairs) != sets["n_want"] or max(diff) > MASK_AGREE_PIXELS:
            raise AssertionError(f"det_mask_agree {name}: mask pixels "
                                 f"differ by {max(diff)}")
        classes = det.num_classes
        gv, wv = got.valid, want.valid
        seg = [[dict(scores=got.scores[gv & (got.labels == k)].cpu().numpy(),
                     masks=gmasks[gv & (got.labels == k)].cpu().numpy())
                for k in range(classes)]]
        ann = [dict(masks=wmasks[wv].cpu().numpy(),
                    labels=want.labels[wv].cpu().numpy())]
        out[name] = dict(sets=sets, instances=len(pairs),
                         max_pixels_differ=max(diff),
                         pixels_differ_total=sum(diff),
                         mask_pixels=int(wmasks[wv].sum()),
                         mask_ap_vs_plain=eval_mask_ap(seg, ann, classes))
        del det, imgs, gmasks, wmasks
        torch.cuda.empty_cache()
    reset_counts(*kernels)
    phase("det_mask_agree", models=out, tolerances=dict(
        box_px=SET_BOX_TOL, score=SET_SCORE_TOL,
        mask_pixels_an_instance=MASK_AGREE_PIXELS),
        phase_s=time.perf_counter() - t_phase)


def det_mask_train(dev, smi, kernels, root, train_ann):
    """The training CLI's image route for the six MASK_CFGS on the COCO tree
    ``det_train`` wrote (into the 608 x 1024 bucket; YOLACT's 768 x 1280),
    bf16, seeded weights, box-filled masks (the tree has none, as JAX),
    RCNN_TRAIN_STEPS steps each, the last ones profiled: step ms, idle
    share, peak memory, the mask loss terms. Gates: finite losses with
    each family's MASK_TERMS; B and D a step on each body as MASK_TRAIN
    says (the targets' ``gather28x2``, the mask heads' ``gather14x2`` and
    ``scatter14x2``), nothing else. Returns the launch counts (A-G) and
    B's and D's bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.tools import (
        train as cli)
    t_phase = time.perf_counter()
    total, bodies, runs = [0] * len(kernels), {}, {}
    steps = RCNN_TRAIN_STEPS
    for name, cfg_path in MASK_CFGS:
        scale = DENSE_TRAIN_SCALE if name == "YOLACT" else RCNN_TRAIN_SCALE
        pipeline = [dict(type="LoadImageFromFile"),
                    dict(type="LoadAnnotations", with_bbox=True),
                    dict(type="Resize", img_scale=scale),
                    dict(type="RandomFlip", flip_ratio=0.5),
                    dict(type="Normalize"),
                    dict(type="Pad", size_divisor=16)]
        d = dict(type="CocoDataset", ann_file=train_ann,
                 img_prefix=f"{root}/coco/", pipeline=pipeline)
        window = StepWindow(steps, RCNN_TRAIN_SKIP)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*kernels)
        t0 = time.perf_counter()
        out = cli.main([str(REPO / cfg_path), "--seed", "0",
                        "--work-dir", f"{root}/work_mask", "--steps",
                        str(steps), "--cfg-options", f"data.train={d!r}",
                        "data.workers_per_gpu=0"], on_step=window)
        counts = [k.launches for k in kernels]
        b7, b14, b28, d7, d14 = MASK_TRAIN[name]
        want = [0, (b7 + b14 + b28) * steps, 0, (d7 + d14) * steps, 0, 0, 0]
        terms = MASK_TERMS[name]
        if counts != want or not all(
                np.isfinite(v) for m in out["metrics"] for v in m.values()) \
                or not all(set(terms) <= set(m) for m in out["metrics"]):
            raise AssertionError(f"det_mask_train {name}: counts {counts}, "
                                 f"want {want}; metrics {out['metrics']}")
        check_bodies(f"det_mask_train {name} roi_align", kernels[1],
                     gather7x2=b7 * steps, gather14x2=b14 * steps,
                     gather28x2=b28 * steps)
        check_bodies(f"det_mask_train {name} roi_align_backward",
                     kernels[3], scatter7x2=d7 * steps,
                     scatter14x2=d14 * steps)
        add_counts(bodies, dict(roi_align=kernels[1].body_launches,
                                roi_align_backward=kernels[3].body_launches))
        step_ms = [(y - x) * 1e3 for x, y in zip([t0] + window.stamps,
                                                window.stamps)]
        runs[name] = dict(
            config=cfg_path, steps=steps, first_step_ms=step_ms[0],
            median_step_ms=statistics.median(step_ms[1:RCNN_TRAIN_SKIP]),
            step_ms=step_ms, device_window=window.window,
            mask_terms={k: [m[k] for m in out["metrics"]] for k in terms},
            losses=[m["loss"] for m in out["metrics"]],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
            launches=dict(zip(KERNEL_NAMES, counts)))
        total = [a + c for a, c in zip(total, counts)]
        del out
        torch.cuda.empty_cache()
    reset_counts(*kernels)
    phase("det_mask_train", card=smi, tree=COCO_TREE, runs=runs,
          launches=dict(zip(KERNEL_NAMES, total)), body_launches=bodies,
          phase_s=time.perf_counter() - t_phase)
    return total, dict(roi_align=bodies.get("roi_align", {}),
                       roi_align_backward=bodies.get("roi_align_backward",
                                                     {}))


class InitMemo:
    """The port's seeded init (``models/vid/selsa.py`` ``init_params``,
    which every entry point calls to draw seeded weights) done once a
    model over the run: the first init of a model class with given
    parameter names, shapes and dtypes from a generator state draws the
    weights on the CPU, as the entry points do, and keeps a copy; a later
    one of the same model from the same generator state loads that copy
    and leaves the generator in the state the draws would have: the same
    numbers without the CPU's truncated-normal draws (several seconds a
    full-width detector, more for the canonical config's aggregator).
    Installed over the phases, which build most models in more than one
    phase: ``with InitMemo(): ...``."""

    def __init__(self):
        from lowlightenvironmentvideoobjectdetection_torch.apis import (
            families)
        from lowlightenvironmentvideoobjectdetection_torch.models import (
            builder)
        from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
            selsa)
        from lowlightenvironmentvideoobjectdetection_torch.tools import (
            train)
        # the modules that call it, by their own name for it
        self.sites = (selsa, families, builder, train)
        self.real = selsa.init_params
        self.store, self.hits = {}, 0

    def __enter__(self):
        for mod in self.sites:
            mod.init_params = self
        return self

    def __exit__(self, *exc):
        for mod in self.sites:
            mod.init_params = self.real
        self.store.clear()

    @torch.no_grad()
    def __call__(self, model, generator):
        key = (type(model).__module__, type(model).__qualname__,
               tuple((n, tuple(v.shape), v.dtype)
                     for n, v in model.state_dict().items()),
               generator.get_state().numpy().tobytes())
        if key in self.store:
            state, after = self.store[key]
            model.load_state_dict(state, strict=True)
            generator.set_state(after)
            self.hits += 1
            return model
        self.real(model, generator)
        self.store[key] = ({n: v.detach().clone() for n, v in
                            model.state_dict().items()},
                           generator.get_state())
        return model


def voc_gt_objects(det_lists):
    """VOC objects (``write_voc_xml``) from per-class detections of each
    image: every row scored above a threshold that starts at EVAL_GT_SCORE
    and rises above each image's (DET_GTS_PER_IMAGE + 1)-th score and
    above every box with a side under VOC_MIN_SIDE px (the XML rounds to
    whole pixels). Returns the objects and the threshold."""
    from lowlightenvironmentvideoobjectdetection_torch.data.voc import (
        VOC_CLASSES)
    rows = [per_class_rows(d) for d in det_lists]
    thr = EVAL_GT_SCORE
    for r in rows:
        scores = sorted((s for _, _, s in r), reverse=True)
        if len(scores) > DET_GTS_PER_IMAGE:
            thr = max(thr, scores[DET_GTS_PER_IMAGE])
        thr = max([thr] + [s for _, b, s in r
                           if min(b[2] - b[0], b[3] - b[1]) < VOC_MIN_SIDE])
    objects = [[(VOC_CLASSES[c], tuple(float(v) + 1 for v in b), False)
                for c, b, s in r if s > thr] for r in rows]
    return objects, thr


def voc_eval(dev, smi, kernels, root):
    """The test CLI's image route on ``faster_rcnn_r50_dc5_1x_voc.py`` (the
    DC5 Faster R-CNN, 20 classes) over a VOC tree under ``root``
    (``write_voc_tree``: VOC_IMAGES copies of the committed 1080 x 1920
    JPEG frames, VOC2007, XML): the plain path at f32 (``DetectorModel``
    with ``impl = "plain"``) makes the gts (``voc_gt_objects``, written
    as the tree's XML; its own mAP50 must be 1); the CLI at f32 (the kernel
    path) against them, mAP50 at least EVAL_F32_MAP, its detection sets
    against the plain run's; the CLI at the config's bf16: mAP50,
    frames/s, B once an image. Returns the bf16 run's launch counts (A-G)
    and B's bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        DetectorModel)
    from lowlightenvironmentvideoobjectdetection_torch.apis.test import (
        evaluate_bbox)
    from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
        write_voc_tree)
    from lowlightenvironmentvideoobjectdetection_torch.data.voc import (
        VOCDataset)
    from lowlightenvironmentvideoobjectdetection_torch.tools import (
        test as tcli)
    import io
    t_phase = time.perf_counter()
    vroot = f"{root}/voc"
    ann, prefix = write_voc_tree(vroot, images=VOC_IMAGES)
    ds = VOCDataset(ann_file=ann, img_prefix=prefix, test_mode=True)
    frames = [tcli.read_frame(i, prefix).astype(np.float32)
              for i in ds.data_infos]
    mtype, kw = detector_kwargs(VOC_CFG, compute_dtype="float32")
    ref = DetectorModel(mtype, device=dev, **kw)
    ref.impl = "plain"
    reset_counts(*kernels)
    plain = [ref.inference_detector(f) for f in frames]
    if any(k.launches for k in kernels):
        raise AssertionError("voc_eval: the plain run launched a kernel")
    del ref
    objects, thr = voc_gt_objects(plain)
    ann, prefix = write_voc_tree(vroot, images=VOC_IMAGES, objects=objects)
    ds = VOCDataset(ann_file=ann, img_prefix=prefix, test_mode=True)
    anns = [ds[i]["ann"] for i in range(len(ds))]
    n_gts = sum(len(a["bboxes"]) for a in anns)
    plain_map = evaluate_bbox(plain, anns)["mAP50"]
    if plain_map != 1.0 or not n_gts:
        raise AssertionError(f"voc_eval: the plain run's own mAP50 "
                             f"{plain_map} on {n_gts} gts")
    argv = [str(REPO / VOC_CFG), "--cfg-options",
            f"data.test.ann_file={ann!r}", f"data.test.img_prefix={prefix!r}"]
    reset_counts(*kernels)
    f32 = tcli.main(argv + ["model.compute_dtype=float32"])
    f32_map = f32["metrics"]["mAP50"]
    sets = [match_rows(per_class_rows(g), per_class_rows(w))
            for g, w in zip(f32["dets"], plain)]
    if f32_map < EVAL_F32_MAP or kernels[1].launches != len(frames):
        raise AssertionError(f"voc_eval: f32 mAP50 {f32_map}, B "
                             f"{kernels[1].launches}; sets {sets}")
    torch.cuda.synchronize()
    reset_counts(*kernels)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bf16 = tcli.main(argv)
    line = buf.getvalue().strip().splitlines()[-1]
    print(line, flush=True)
    counts = [k.launches for k in kernels]
    if counts != [0, len(frames), 0, 0, 0, 0, 0] or len(bf16["dets"]) != \
            len(frames) or not all(len(d) == 20 for d in bf16["dets"]):
        raise AssertionError(f"voc_eval: counts {counts}")
    check_bodies("voc_eval", kernels[1], gather7x2=len(frames),
                 gather14x2=0)
    bodies = dict(roi_align=dict(kernels[1].body_launches))
    phase("voc_eval", card=smi, config=VOC_CFG, images=len(frames),
          image_hw=list(frames[0].shape[:2]), year=ds.year,
          gts=dict(count=n_gts, score_threshold=thr),
          plain_f32_map50=plain_map, kernel_f32_map50=f32_map,
          kernel_f32_gate=EVAL_F32_MAP,
          kernel_f32_vs_plain_sets=dict(
              unmatched=sum(x["unmatched"] for x in sets),
              max_box_px=max(x["box"] for x in sets),
              max_score=max(x["score"] for x in sets)),
          bf16_map50=bf16["metrics"]["mAP50"],
          bf16_frames_per_s=bf16["summary"]["fps"], summary_line=line,
          launches=dict(zip(KERNEL_NAMES, counts)),
          phase_s=time.perf_counter() - t_phase)
    return counts, dict(roi_align=bodies["roi_align"], roi_align_backward={})


def param_search(dev, smi, kernels, root):
    """The port's ``tools/mot_param_search.py`` on a dets json written from
    the MOT config's detector and ReID pass (seeded weights, as
    ``mot_stream``) over a MOT tree under ``root`` (MOT_TREE): per frame the
    boxes in the frame's coordinates, scores, labels and embeddings; then
    the search over PARAM_GRID: MOTA and IDF1 at each point. Gate: the
    tool returns. Returns the detector pass's launch counts (A-G) and B's
    bodies (B once a frame)."""
    from lowlightenvironmentvideoobjectdetection_torch.data.preprocess import (
        prepare_frames)
    from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
        write_mot_tree)
    from lowlightenvironmentvideoobjectdetection_torch.tools import (
        mot_param_search as search, test as tcli)
    from lowlightenvironmentvideoobjectdetection_torch.data.mot_sot_datasets import (  # noqa: E501
        MOTChallengeDataset)
    t_phase = time.perf_counter()
    ann, _ = write_mot_tree(f"{root}/mot_search", **MOT_TREE)
    ds = MOTChallengeDataset(ann_file=ann, img_prefix=f"{root}/mot_search/",
                             test_mode=True)
    model = mot_model(MOT_CFG, dev)
    cfg = model.detector.cfg
    reset_counts(*kernels)
    frames = []
    for info in ds.data_infos:
        raw = tcli.read_frame(info, ds.img_prefix)
        imgs, shape, sf = prepare_frames(raw[None], cfg.pad_h, cfg.pad_w,
                                         device=dev)
        boxes, scores, labels, embeds = model.detect(imgs[0], shape)
        frames.append(dict(det_bboxes=(boxes / sf).tolist(),
                           det_scores=scores.tolist(),
                           det_labels=labels.tolist(),
                           embeds=embeds.tolist()))
    counts = [k.launches for k in kernels]
    if counts != [0, len(frames), 0, 0, 0, 0, 0]:
        raise AssertionError(f"param_search: detector counts {counts}")
    bodies = dict(roi_align=dict(kernels[1].body_launches),
                  roi_align_backward={})
    dets = f"{root}/mot_search_dets.json"
    with open(dets, "w") as f:
        json.dump(frames, f)
    out = search.main(["--ann-file", ann, "--dets", dets, "--search"]
                      + PARAM_GRID + ["--log", f"{root}/mot_search.log"])
    phase("param_search", card=smi, tree=MOT_TREE, grid=PARAM_GRID,
          frames=len(frames),
          detections_per_frame=[len(fr["det_bboxes"]) for fr in frames],
          table=[dict(settings=kw, MOTA=m["MOTA"], IDF1=m["IDF1"])
                 for kw, m in out["table"]],
          best=dict(settings=out["best"][1], MOTA=out["best"][0]),
          launches=dict(zip(KERNEL_NAMES, counts)),
          phase_s=time.perf_counter() - t_phase)
    del model
    torch.cuda.empty_cache()
    return counts, bodies


# ---------------------------------------------------------------------------
# JPEG frames, the learning check and the original code's checkpoints


def decode_ms(fn, n=JPEG_DECODES):
    """Median host ms of ``n`` calls."""
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ts)


def jpeg_decode(smi):
    """The host JPEG decoder (``csrc/jpeg_decode.cpp``, built with g++ at
    its first use): every committed fixture of ``tests/data/jpeg`` decoded
    on this host, its shape and the sha256 of its bytes equal to the
    manifest's (cv2's ``imread``, where the fixtures were written); then
    the 1080x1920 4:2:0 fixture's decode ms (median of JPEG_DECODES)
    beside the same pixels as PNG, written without a row filter and with
    Paeth on every row."""
    import hashlib
    from lowlightenvironmentvideoobjectdetection_torch.data import (
        image_io, jpeg)
    t = time.perf_counter()
    jpeg.load_library()
    build_s = time.perf_counter() - t
    with open(JPEG_FIXTURES / "manifest.json") as f:
        manifest = json.load(f)
    bad = []
    for name, entry in sorted(manifest.items()):
        img = image_io.imread(str(JPEG_FIXTURES / name))
        if list(img.shape) != entry["shape"] or hashlib.sha256(
                img.tobytes()).hexdigest() != entry["sha256"]:
            bad.append(name)
    if bad:
        raise AssertionError(f"jpeg_decode: not the manifest's pixels: {bad}")
    path = str(JPEG_FIXTURES / JPEG_TIMED)
    img = image_io.imread(path)
    png_ms = {}
    with tempfile.TemporaryDirectory(prefix="_smoke_jpeg_", dir=REPO) as d:
        for name, filters in (("none", 0), ("paeth", 4)):
            p = f"{d}/{name}.png"
            image_io.imwrite_png(p, img, filters=filters, level=1)
            png_ms[name] = decode_ms(lambda: image_io.imread(p))
    phase("jpeg_decode", card=smi, fixtures=len(manifest),
          all_match_manifest=True, decoder_build_s=build_s,
          timed=dict(file=JPEG_TIMED, shape=list(img.shape),
                     jpeg_bytes=(JPEG_FIXTURES / JPEG_TIMED).stat().st_size,
                     decodes=JPEG_DECODES),
          jpeg_decode_ms=decode_ms(lambda: image_io.imread(path)),
          png_decode_ms=png_ms)


def tf32_defaults():
    """PyTorch's TF32 defaults, which an entry point must turn off."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def tf32_turned_off(name):
    """The TF32 flags after an entry point ran, which must be off."""
    from lowlightenvironmentvideoobjectdetection_torch.utils.device import (
        precision_flags)
    flags = precision_flags()
    if any(flags.values()):
        raise AssertionError(f"{name}: TF32 left on: {flags}")
    return flags


def jpeg_train(dev, smi, kernels, root):
    """The canonical config through the training CLI on a DarkFarm tree of
    .JPG frames (``write_darkfarm_jpeg_tree``: JPEG_TREE's videos, every
    frame a copy of a committed 1080x1920 low / GT pair), as ``data_train``
    runs it on PNG: JPEG_STEPS steps with DATA_WORKERS loader processes, B
    and D twice and E, F, G 12 times a step, finite losses, the loader's
    ms a batch, the device's idle share over the last JPEG_PROFILED steps.
    The TF32 flags are set to PyTorch's defaults before and must be off
    after (the CLI turns them off). Returns the run's counts, B's and D's
    bodies and the val split's annotation file."""
    from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
        write_darkfarm_jpeg_tree)
    t = time.perf_counter()
    train_ann, val_ann = write_darkfarm_jpeg_tree(root, **JPEG_TREE)
    tree_s = time.perf_counter() - t
    tf32_defaults()
    argv = [str(REPO / CANONICAL_CFG), "--seed", "0", "--work-dir",
            f"{root}/work"] + data_options(root, train_ann, DATA_WORKERS)
    run = cli_run("jpeg_train", argv, kernels, DATA_PER_STEP, JPEG_STEPS,
                  JPEG_STEPS - JPEG_PROFILED)
    phase("jpeg_train", card=smi, config=CANONICAL_CFG, tree=JPEG_TREE,
          frame_hw=[1080, 1920], tree_write_s=tree_s, steps=JPEG_STEPS,
          workers=DATA_WORKERS, step_ms=run["step_ms"],
          loss_per_step=[m["loss"] for m in run["metrics"]],
          loader_ms_per_batch=run["timings"],
          loader_median_ms=loader_summary(run["timings"], 1),
          device_window=run["window"], peak_mem_gb=run["peak_gb"],
          launches_per_step=dict(zip(KERNEL_NAMES, DATA_PER_STEP)),
          tf32_after_cli=tf32_turned_off("jpeg_train"))
    return (run["counts"], run["bodies"]), val_ann


def jpeg_eval(dev, smi, kernels, root, ann):
    """The canonical config's test CLI on the JPEG tree's val split (its
    VID route: frames stream through the loader's DATA_WORKERS processes),
    gated as ``eval`` gates: the plain path at f32 makes the gts
    (``eval_gts``; its own mAP50 must be 1), the kernel path at f32
    through the CLI scores mAP50 at least EVAL_F32_MAP against them; A 3
    times and B once a frame, B once more a memo fill. Reports the
    per-frame times of the CLI run and the detection sets against the
    plain run's. Returns the counts (A-G) and B's and D's bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.test import (
        evaluate_bbox)
    from lowlightenvironmentvideoobjectdetection_torch.config import (
        load_config)
    from lowlightenvironmentvideoobjectdetection_torch.data.loader import (
        build_dataset)
    t = time.perf_counter()
    cfg_path = str(REPO / CANONICAL_CFG)
    frames, videos = JPEG_TREE["frames"], JPEG_TREE["val_videos"]
    n = frames * videos
    per_run = (3 * n, n + videos, 0, 0, 0, 0, 0)
    plain, plain_s = eval_reference(dev, cfg_path, root, ann, kernels)
    gts = f"{root}/jpeg_eval_gts.json"
    thr, n_gts = eval_gts(ann, plain, gts)
    test_cfg = load_config(cfg_path)["data"]["test"]
    ds = build_dataset(dict(test_cfg, ann_file=gts, img_prefix=f"{root}/"),
                       test_mode=True)
    plain_map = evaluate_bbox(plain, [ds.get_ann_info(i)
                                      for i in ds.data_infos])["mAP50"]
    tf32_defaults()
    run = eval_cli("jpeg_eval f32", [cfg_path]
                   + eval_options(root, gts, DATA_WORKERS)
                   + ["model.compute_dtype=float32"], kernels, per_run)
    check_bodies("jpeg_eval attention", kernels[0], fma=3 * n, mma=0)
    check_bodies("jpeg_eval roi_align", kernels[1], gather7x2=n + videos,
                 gather14x2=0)
    f32_map = run["out"]["metrics"]["mAP50"]
    sets = [match_rows(per_class_rows(g), per_class_rows(w))
            for g, w in zip(run["dets"], plain)]
    phase("jpeg_eval", card=smi, config=CANONICAL_CFG, tree=JPEG_TREE,
          gts=dict(count=n_gts, score_threshold=thr), plain_f32_s=plain_s,
          plain_f32_map50=plain_map, kernel_f32_map50=f32_map,
          kernel_f32_gate=EVAL_F32_MAP, workers=DATA_WORKERS,
          unmatched_rows=sum(x["unmatched"] for x in sets),
          frames_with_unmatched=sum(1 for x in sets if x["unmatched"]),
          times=eval_times(run, frames),
          tf32_after_cli=tf32_turned_off("jpeg_eval"),
          launches=dict(zip(KERNEL_NAMES, run["counts"])),
          phase_s=time.perf_counter() - t)
    if plain_map != 1.0 or f32_map < EVAL_F32_MAP:
        raise AssertionError(f"jpeg_eval: mAP50 plain {plain_map}, kernels "
                             f"{f32_map}")
    return run["counts"], {k: run["bodies"][k] for k in (
        "roi_align", "roi_align_backward")}


def learning(dev, smi, kernels):
    """The port's learning check (``tools/learning_smoke.py``) on the card
    at its defaults with the seeds of LEARNING_SEEDS, until the median of
    the three is decided: Faster R-CNN from scratch on the synthetic
    shapes, LEARNING_STEPS steps of Adam, mAP50 on LEARNING_EVAL_IMAGES
    images before and after. Gates: every ``map_before`` below
    LEARNING_MAP_BEFORE_MAX, the median ``map_after`` (two of the three)
    at least LEARNING_MAP_FLOOR (half the JAX tool's on the CPU at the
    same steps), B once a step and once an evaluated image, D once a step;
    TF32 off after each entry. Returns the counts (A-G) and B's and D's
    bodies."""
    import io
    from lowlightenvironmentvideoobjectdetection_torch.tools import (
        learning_smoke)
    reset_counts(*kernels)
    runs = []
    for seed in LEARNING_SEEDS:
        passed = sum(r["map_after"] >= LEARNING_MAP_FLOOR for r in runs)
        if 2 in (passed, len(runs) - passed):
            break  # the median is decided
        tf32_defaults()
        printed = io.StringIO()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            out = learning_smoke.main([
                "--steps", str(LEARNING_STEPS), "--eval-images",
                str(LEARNING_EVAL_IMAGES), "--seed", str(seed)])
        torch.cuda.synchronize()
        if json.loads(printed.getvalue().strip().splitlines()[-1]) != out:
            raise AssertionError("learning: the printed line is not the "
                                 "result")
        runs.append(dict(seed=seed, wall_s=time.perf_counter() - t,
                         tf32_after_entry=tf32_turned_off("learning"), **out))
    counts = [k.launches for k in kernels]
    want = [0] * len(kernels)
    want[1] = len(runs) * (LEARNING_STEPS + 2 * LEARNING_EVAL_IMAGES)
    want[3] = len(runs) * LEARNING_STEPS
    check_bodies("learning roi_align", kernels[1], gather7x2=want[1],
                 gather14x2=0)
    passed = sum(r["map_after"] >= LEARNING_MAP_FLOOR for r in runs)
    phase("learning", card=smi, runs=runs, runs_at_floor=passed,
          floor=LEARNING_MAP_FLOOR, jax_cpu_map_after=LEARNING_JAX_MAP_AFTER,
          map_before_max=LEARNING_MAP_BEFORE_MAX,
          launches=dict(zip(KERNEL_NAMES, counts)))
    if counts != want:
        raise AssertionError(f"learning: launch counts {counts}, want {want}")
    if max(r["map_before"] for r in runs) >= LEARNING_MAP_BEFORE_MAX or \
            passed < 2:
        raise AssertionError(f"learning: mAP50 {runs}, floor "
                             f"{LEARNING_MAP_FLOOR} for the median")
    return counts, dict(roi_align=dict(kernels[1].body_launches),
                        roi_align_backward=dict(kernels[3].body_launches))


def original_name(name):
    """A port SELSA parameter's name -> the mmtrack checkpoint's (the
    inverse of ``utils/torch_import.py``'s renaming)."""
    import re
    name = re.sub(r"layer(\d)_(\d+)\.", r"layer\1.\2.", name)
    name = name.replace("downsample_conv.", "downsample.0.")
    name = name.replace("downsample_bn.", "downsample.1.")
    name = name.replace("neck.conv0.", "neck.convs.0.conv.")
    name = re.sub(r"^bbox_head\.shared_fc(\d)\.",
                  r"roi_head.bbox_head.shared_fcs.\1.", name)
    name = re.sub(r"^bbox_head\.aggregator(\d)\.",
                  r"roi_head.bbox_head.aggregator.\1.", name)
    return "detector." + re.sub(r"^bbox_head\.(fc_cls|fc_reg)\.",
                                r"roi_head.bbox_head.\1.", name)


def mmtrack_state_dict(cfg, seed):
    """A seeded SELSA checkpoint in the original's names and layout: the
    port's flax-style init at ``cfg``, BN statistics and biases perturbed,
    ``fc_cls`` IMPORT_CLS_SCALE times wider (random-init scores of 31
    classes crowd near 1/31, and rows at the top-100 cut would lie within
    SET_SCORE_TOL of each other), the first shared FC's input columns in
    torch's (C, 7, 7) order, a ``num_batches_tracked`` beside each BN.
    Returns it and the port state dict it must import to."""
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        selsa as S)
    model = S.SelsaDetector(cfg)
    S.init_params(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    want, sd = {}, {}
    for k, v in model.state_dict().items():
        v = v.float().clone()
        if k.endswith("running_var"):
            v *= 0.8 + 0.45 * torch.rand(v.shape, generator=g)
        elif k.endswith(("bias", "running_mean")):
            v += 0.02 * torch.randn(v.shape, generator=g)
        elif k == "bbox_head.fc_cls.weight":
            v *= IMPORT_CLS_SCALE
        want[k] = v
        if k == "bbox_head.shared_fc0.weight":
            v = v.reshape(v.shape[0], 7, 7, -1).permute(0, 3, 1, 2).reshape(
                v.shape[0], -1)
        sd[original_name(k)] = v.contiguous()
        if k.endswith("running_var"):
            sd[original_name(k).replace("running_var",
                                        "num_batches_tracked")] = \
                torch.tensor(0)
    return sd, want


def torch_import(dev, smi, kernels):
    """The original code's checkpoint into the port: a seeded SELSA
    R50-DC5 ``state_dict`` at full width in mmtrack's names
    (``mmtrack_state_dict``) saved with ``torch.save``, loaded with
    ``weights_only=True``, imported (``utils/torch_import.py``), saved
    and given to ``init_model``; the import equals the weights it was
    made from. Then IMPORT_FRAMES random 600x1000 frames streamed at f32
    through ``inference_vid`` on the kernels and on the plain path
    (``impl = "plain"``): per frame equal detection sets within
    SET_BOX_TOL / SET_SCORE_TOL; A twice a frame, B once a frame and once
    more the memo fill. Returns the counts (A-G) and B's bodies."""
    from lowlightenvironmentvideoobjectdetection_torch.apis.inference import (
        inference_vid, init_model)
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        selsa as S)
    from lowlightenvironmentvideoobjectdetection_torch.utils.torch_import import (  # noqa: E501
        import_selsa_checkpoint)
    t = time.perf_counter()
    sd, want = mmtrack_state_dict(S.SelsaConfig(), seed=7)
    models = {}
    with tempfile.TemporaryDirectory(prefix="_smoke_import_", dir=REPO) as d:
        torch.save(sd, f"{d}/selsa_mmtrack.pth")
        port = import_selsa_checkpoint(torch.load(
            f"{d}/selsa_mmtrack.pth", map_location="cpu", weights_only=True))
        if port.keys() != want.keys() or not all(
                torch.equal(port[k], want[k]) for k in want):
            raise AssertionError("torch_import: not the weights it was "
                                 "made from")
        torch.save(port, f"{d}/selsa_port.pt")
        for impl in ("kernels", "plain"):
            models[impl] = init_model("SELSA", checkpoint=f"{d}/selsa_port.pt",
                                      device=dev, compute_dtype=torch.float32)
    models["plain"].impl = "plain"
    rng = np.random.RandomState(7)
    frames = rng.randint(0, 256, (IMPORT_FRAMES, 600, 1000, 3)).astype(
        np.uint8)
    refs = rng.randint(0, 256, (14, 600, 1000, 3)).astype(np.uint8)
    results = {}
    for impl, model in models.items():
        reset_counts(*kernels)
        results[impl] = [inference_vid(model, frames[f], f, ref_frames=refs
                                       if f == 0 else None)["bbox_results"]
                         for f in range(IMPORT_FRAMES)]
        if impl == "kernels":
            counts = [k.launches for k in kernels]
            bodies = dict(roi_align=dict(kernels[1].body_launches),
                          roi_align_backward={})
            check_bodies("torch_import attention", kernels[0], mma=0,
                         fma=2 * IMPORT_FRAMES)
        elif any(k.launches for k in kernels):
            raise AssertionError("torch_import: the plain run launched a "
                                 "kernel")
    want_counts = [2 * IMPORT_FRAMES, IMPORT_FRAMES + 1, 0, 0, 0, 0, 0]
    sets = [match_rows(per_class_rows(a), per_class_rows(b))
            for a, b in zip(results["kernels"], results["plain"])]
    phase("torch_import", card=smi, config="SelsaConfig() (R50-DC5, "
          "608x1024, 30 classes), f32", keys=len(sd), imported=len(port),
          frames=IMPORT_FRAMES, kernel_vs_plain_sets=sets,
          tolerances=dict(box_px=SET_BOX_TOL, score=SET_SCORE_TOL),
          launches=dict(zip(KERNEL_NAMES, counts)),
          phase_s=time.perf_counter() - t)
    if counts != want_counts:
        raise AssertionError(f"torch_import: launch counts {counts}, want "
                             f"{want_counts}")
    if any(x["unmatched"] or x["n_got"] != x["n_want"] or not x["n_want"]
           for x in sets):
        raise AssertionError(f"torch_import: the kernel path's detections "
                             f"differ from the plain path's: {sets}")
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


def loader_close(root, smi) -> int:
    """``--loader-close ROOT``: with the package of the checkout at ROOT,
    the canonical config's training loader (DATA_WORKERS workers, the
    card) on a DATA_TREE tree, LOADER_CLOSE_ROUNDS times opened, read for
    LOADER_CLOSE_BATCHES batches and closed; counts the closes that fail (a
    worker aborting at exit). Prints one JSON line."""
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    from lowlightenvironmentvideoobjectdetection_torch.config import (
        Config, apply_cli_options)
    from lowlightenvironmentvideoobjectdetection_torch.data import loader
    from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
        write_darkfarm_tree)
    if not Path(loader.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {loader.__file__}, not from {root}")
    fails = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="_smoke_", dir=REPO) as tree:
        ann = write_darkfarm_tree(tree, **DATA_TREE)
        cfg = Config.fromfile(str(REPO / CANONICAL_CFG))
        apply_cli_options(cfg, data_options(tree, ann, DATA_WORKERS)[1:])
        for r in range(LOADER_CLOSE_ROUNDS):
            ld = loader.TrainLoader(cfg, 608, 1024, 3, seed=r, device="cuda")
            try:
                for _ in range(LOADER_CLOSE_BATCHES):
                    next(ld)
                torch.cuda.synchronize()
                ld.close()
            except RuntimeError as e:  # a worker died: count the round
                fails.append(dict(round=r, error=str(e)))
    print(json.dumps(dict(root=str(root), card=smi,
                          rounds=LOADER_CLOSE_ROUNDS,
                          batches=LOADER_CLOSE_BATCHES,
                          workers=DATA_WORKERS, failed=len(fails),
                          failures=fails,
                          seconds=time.perf_counter() - t0)), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roi-grad-times", metavar="ROOT",
                    help="only kernel D's cases, with the package at ROOT")
    ap.add_argument("--dcn-times", metavar="ROOT",
                    help="only DCNv2's cases (E, F, G), with the package at "
                         "ROOT")
    ap.add_argument("--loader-close", metavar="ROOT",
                    help="only the training loader's close, many times, "
                         "with the package at ROOT")
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
    if args.loader_close:
        return loader_close(args.loader_close, smi)

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
    # the FPN variants' shapes: E, F, G at GA-RPN's and GA-RetinaNet's
    # levels, B and D at GRoIE's every-level pooling
    ga_dcn = ga_dcn_kernels(dev, g, dcn_ops, errs)
    for name, kern in zip(dcn_names, "EFG"):
        summary[name].update(ga_dcn[kern])
    # the dense heads: E, F, G at VFNet's P3 and P7 with star offsets
    vf_dcn = vfnet_dcn_kernels(dev, g, dcn_ops, errs)
    for name, kern in zip(dcn_names, "EFG"):
        summary[name].update(vf_dcn[kern])
    # RepPoints: E, F, G at its P3 and P7 with the points' offsets
    rep_dcn = rep_dcn_kernels(dev, g, dcn_ops, errs)
    for name, kern in zip(dcn_names, "EFG"):
        summary[name].update(rep_dcn[kern])
    summary["roi_align"]["groie_levels"], \
        summary["roi_align_backward"]["groie_levels"] = groie_roi_kernels(
            dev, g, roi_ops, errs)
    # the DC5 two-stage families: B and D on their 14x14 bodies at Grid
    # R-CNN's and the mask heads' shapes, B at PISA's candidates and
    # Double-Head's 1.3x rois, E, F, G at Cascade RPN's stage 2
    summary["roi_align"]["rcnn"], summary["roi_align_backward"]["rcnn"] = \
        rcnn_roi_kernels(dev, g, roi_ops, errs)
    crpn_dcn = crpn_dcn_kernels(dev, g, dcn_ops, errs)
    for name, kern in zip(dcn_names, "EFG"):
        summary[name].update(crpn_dcn[kern])
    # the mask families: B's mask-target body gather28x2
    summary["roi_align"]["mask"] = mask_roi_kernels(dev, g, roi_ops, errs)
    phase("kernels", card=smi, max_abs_err=errs, bf16_times=summary,
          tolerances=dict(attention_atol=ATTN_ATOL, library_atol=LIBRARY_TOL,
                          roi_f32_atol=ROI_F32_ATOL,
                          roi_bf16_rtol_atol=ROI_BF16_TOL,
                          roi_grad_f32_atol_rel_to_max=ROI_GRAD_F32_REL,
                          roi_grad_bf16_rtol=ROI_GRAD_BF16_RTOL,
                          dcn_atol_rel_to_max=DCN_REL,
                          dcn_grad_x_bf16_rtol=DCN_BF16_RTOL))

    # each model's seeded weights drawn once over the phases
    phases = contextlib.ExitStack()
    init_memo = phases.enter_context(InitMemo())

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

    # the dark backbones: the 13 variants, the insert-plugins config
    path_kernels = train_kernels + dcn_launchers
    dark_variants(dev, smi, dcn_launchers)
    runs = [plugin_train(dev, smi, path_kernels)]
    plugin_agree(dev, (roi_align, roi_align_backward) + dcn_launchers)
    dark_agree(dev, (roi_align, roi_align_backward))

    # the training data path: a config file and PNG frames on disk
    with tempfile.TemporaryDirectory(prefix="_smoke_", dir=REPO) as root:
        counts, bodies, ann, item = data_train(dev, smi, path_kernels, root)
        runs.append((counts, bodies))
        more, more_bodies = noise_raw(dev, smi, path_kernels, root, ann,
                                      item)
        runs.append((more, more_bodies))
        # evaluation: the tree's test split through the test API and CLIs
        runs.append(eval_phase(dev, smi, path_kernels, root, ann))
        # the dark backbones and the denoisers from the same tree
        runs.append(dark_train(dev, smi, path_kernels, root, ann))
        runs.append(dark_stream(dev, smi, path_kernels, root, ann))
        runs.append(fastdvd_train(dev, smi, path_kernels, root, ann))
    # the flow-based ImageNet-VID families, and SELSA, FGFA and DFF
    # training and evaluation from an ImageNet-VID tree of PNG frames
    from lowlightenvironmentvideoobjectdetection_torch.data.synthetic import (
        write_imagenet_vid_tree)
    runs.append(fgfa_stream(dev, smi, path_kernels))
    runs.append(dff_stream(dev, smi, path_kernels))
    with tempfile.TemporaryDirectory(prefix="_smoke_vid_", dir=REPO) as root:
        train_ann, val_ann = write_imagenet_vid_tree(root, **VID_TREE)
        prefix = f"{root}/Data/VID"
        runs.append(vid_train(dev, smi, path_kernels, prefix, train_ann))
        fgfa_agree(dev, roi_align, roi_align_backward)
        runs.append(vid_eval(dev, smi, path_kernels, prefix, val_ann))
    # tracking: DeepSORT, Tracktor and SiamRPN++ at full width, then the
    # test CLI's MOT and SOT routes from PNG trees
    runs.append(mot_stream(dev, smi, path_kernels))
    runs.append(tracktor_stream(dev, smi, path_kernels))
    runs.append(sot_stream(dev, smi, path_kernels))
    with tempfile.TemporaryDirectory(prefix="_smoke_track_", dir=REPO) as root:
        runs.append(track_eval(dev, smi, path_kernels, root))
        runs.append(param_search(dev, smi, path_kernels, root))
        runs.append(sot_train(dev, smi, path_kernels, root))
    # the image detectors: FPN Faster R-CNN, RetinaNet and the DC5 Faster
    # R-CNN streamed, trained and evaluated from a COCO tree
    with tempfile.TemporaryDirectory(prefix="_smoke_det_", dir=REPO) as root:
        runs.append(det_stream(dev, smi, path_kernels))
        runs.append(det_variants(dev, smi, path_kernels))
        runs.append(det_dense(dev, smi, path_kernels))
        runs.append(det_rcnn(dev, smi, path_kernels))
        # the mask families through the API, and f32 against plain
        runs.append(det_mask(dev, smi, path_kernels))
        det_mask_agree(dev, path_kernels)
        counts, bodies, train_ann, val_ann = det_train(dev, smi,
                                                       path_kernels, root)
        runs.append((counts, bodies))
        runs.append(det_eval(dev, smi, path_kernels, root, val_ann))
        # the FPN-trunk variants and GA-RetinaNet on the same tree
        runs.append(det_variants_train(dev, smi, path_kernels, root,
                                       train_ann))
        # the dense one-stage heads on the same tree, and AutoAugment
        runs.append(det_dense_train(dev, smi, path_kernels, root,
                                    train_ann))
        runs.append(det_autoaugment_train(dev, smi, path_kernels, root,
                                          train_ann))
        # the two-stage families on the DC5 trunk on the same tree
        runs.append(det_rcnn_train(dev, smi, path_kernels, root, train_ann))
        runs.append(det_mask_train(dev, smi, path_kernels, root, train_ann))
        # their configs through the test CLI on the val split
        runs.append(det_zoo_eval(dev, smi, path_kernels, root, val_ann))
        # the VOC route: the DC5 config on a VOC tree of JPEG images
        runs.append(voc_eval(dev, smi, path_kernels, root))
    # JPEG frames, the learning check and the original code's checkpoints
    jpeg_decode(smi)
    with tempfile.TemporaryDirectory(prefix="_smoke_jpeg_", dir=REPO) as root:
        run, val_ann = jpeg_train(dev, smi, path_kernels, root)
        runs.append(run)
        runs.append(jpeg_eval(dev, smi, path_kernels, root, val_ann))
    runs.append(learning(dev, smi, path_kernels))
    runs.append(torch_import(dev, smi, path_kernels))
    phase("init_memo", distinct_models=len(init_memo.store),
          loaded_copies=init_memo.hits)
    phases.close()
    for counts, bodies in runs:
        for name, n in zip(KERNEL_NAMES, counts):
            summary[name]["launches"] += n
        for name in ("roi_align", "roi_align_backward"):
            add_bodies(summary[name], bodies[name])

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
