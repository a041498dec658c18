"""The kernels' least times in ``chip_smoke.py`` against hand counts.

Counting rule: each input byte read once and each output byte written once;
2 FLOPs per multiply-add. Kernel A at the main path's shapes (300 queries,
16 heads, head dim 64, 4200 memo + 300 current keys, bf16 q and K/V, f32
bias and output), kernel C on the same keys as one slab, kernel B on one
38 x 64 x 512 bf16 map with 300 rois, on 4 maps with 1200 rois (a batched
step of 4 streams) and on 14 maps with 4200 rois (a memo fill), the map
indices int64; where rois touch part of a map (FPN's per-level slices),
only the pixels they read with a nonzero weight. DCNv2's kernels E, F and G at the aggregator's stage 0
(3 frames of 64 x 152 x 256, bf16 x, 8 deform groups, f32 offsets, mask,
columns and gradients).
"""

import pytest
import torch
from torch_port_threads import thread_count

import chip_smoke as cs

A_BYTES = (300 * 16 * 64 * 2          # q
           + 2 * 16 * 4200 * 64 * 2   # memo K/V
           + 2 * 16 * 300 * 64 * 2    # current K/V
           + 4500 * 4                 # biases
           + 300 * 16 * 64 * 4)       # output
B_BYTES = 38 * 64 * 512 * 2 + 300 * 4 * 4 + 300 * 7 * 7 * 512 * 2
B_SERVE_BYTES = (4 * 38 * 64 * 512 * 2     # 4 maps
                 + 1200 * 4 * 4            # rois
                 + 1200 * 8                # int64 map index per roi
                 + 1200 * 7 * 7 * 512 * 2)  # output


_pinned_threads = thread_count(1)


def test_hand_counts():
    assert A_BYTES == 20_293_200
    assert B_BYTES == 17_547_968
    assert B_SERVE_BYTES == 70_201_472


@pytest.mark.parametrize("s,m1,m2", [(1, 4200, 300), (4, 4200, 300),
                                     (1, 4500, 0), (8, 4200, 300)])
def test_attention_cost(s, m1, m2):
    nbytes, flops = cs.attention_cost(s, 300, 16, m1, m2)
    assert nbytes == s * A_BYTES
    assert flops == s * 5.5296e9


@pytest.mark.parametrize("maps,rois,bind_bytes,want", [
    (1, 300, 0, B_BYTES),
    (4, 1200, 8, B_SERVE_BYTES),
    (14, 4200, 8, 14 * 38 * 64 * 512 * 2 + 4200 * 16 + 4200 * 8
     + 4200 * 7 * 7 * 512 * 2),
])
def test_roi_align_cost(maps, rois, bind_bytes, want):
    nbytes, flops = cs.roi_align_cost(maps, 38, 64, 512, rois,
                                      bind_bytes=bind_bytes)
    assert nbytes == want
    assert flops == rois * 7 * 7 * 512 * 4 * 4 * 2  # 4 corners x 2x2 samples


@pytest.mark.parametrize("rois,pixels", [
    ([[0.5, 0.5, 14.5, 14.5]], 15 * 15),  # samples 0.5 .. 13.5 a side
    ([[0.5, 0.5, 14.5, 14.5]] * 3, 15 * 15),  # the union, not the sum
    ([[0.5, 0.5, 14.5, 14.5], [100.0, 100.0, 120.0, 120.0]], 15 * 15),
])
def test_roi_footprint_counts_the_pixels_read(rois, pixels):
    got = cs.roi_footprint_pixels(torch.tensor(rois), 1.0, 32, 32)
    assert got == pixels
    nbytes, _ = cs.roi_align_cost(1, 32, 32, 256, len(rois), 4, 8,
                                  map_pixels=got)
    assert nbytes == (pixels * 256 * 4 + len(rois) * (16 + 8)
                      + len(rois) * 7 * 7 * 256 * 4)


def test_bounds_and_what_bounds_them():
    ms, by = cs.bound(*cs.attention_cost(1, 300, 16, 4200, 300),
                      cs.BF16_TENSOR_FLOP_PER_S)
    assert by == "bytes"  # 6.06 us of bytes against 5.59 us of products
    assert ms == pytest.approx(20_293_200 / 3.35e12 * 1e3)
    ms, by = cs.bound(*cs.roi_align_cost(14, 38, 64, 512, 4200, bind_bytes=8),
                      cs.F32_FLOP_PER_S)
    assert by == "bytes" and ms == pytest.approx(0.0733, abs=1e-4)
    ms, by = cs.bound(*cs.roi_align_cost(4, 38, 64, 512, 1200, bind_bytes=8),
                      cs.F32_FLOP_PER_S)
    # 20.96 us of bytes against 14.4 us of f32 FMAs
    assert by == "bytes" and ms == pytest.approx(70_201_472 / 3.35e9)
    assert cs.roi_align_cost(4, 38, 64, 512, 1200, bind_bytes=8)[1] == \
        963_379_200
    assert cs.bound(0, 989e9, cs.BF16_TENSOR_FLOP_PER_S) == (1.0,
                                                             "operations")


@pytest.mark.parametrize("roi,adds,pixels", [
    # zero area on a pixel centre: every sample on one pixel, the high
    # corners' weights 0
    ((40.0, 40.0, 40.0, 40.0), 14 * 14, 1),
    # zero area between pixel centres: both corners of every sample weigh
    # 1/2, on 2 x 2 pixels
    ((48.0, 48.0, 48.0, 48.0), 28 * 28, 4),
    # outside the map: no adds
    ((-200.0, -200.0, -100.0, -120.0), 0, 0),
])
def test_kernel_d_footprint_hand_counts(roi, adds, pixels):
    """Kernel D's adds per roi and channel, one per nonzero corner weight
    of a y sample times one of an x sample, and the distinct pixels they
    land on (7x7 bins, sr 2, stride 16, a 38 x 64 map)."""
    import torch

    from lowlightenvironmentvideoobjectdetection_torch.ops import (
        roi_align as ops,
    )
    got = cs.footprint(ops, torch.tensor([roi]), 38, 64)
    assert got == dict(adds=adds, pixels=pixels)


DCN_HW = 152 * 256
DCN_COLS = 4 * 3 * 9 * 64 * DCN_HW       # f32 columns [3, 576, hw]
DCN_COORDS = 4 * 3 * 8 * 27 * DCN_HW     # f32 offsets (18) and mask (9)
DCN_X = 2 * 3 * 64 * DCN_HW              # bf16 x


@pytest.mark.parametrize("kernel,nbytes,per_entry", [
    ("E", DCN_X + DCN_COORDS + DCN_COLS, 8),
    ("F", DCN_COLS + DCN_COORDS + DCN_X, 9),  # grad_x in bf16, as x
    ("G", DCN_COLS + DCN_X + 2 * DCN_COORDS, 23),  # reads and gradients
])
def test_dcn_cost(kernel, nbytes, per_entry):
    got_bytes, flops = cs.dcn_cost(kernel, 3, 64, 152, 256, 8)
    assert got_bytes == nbytes
    assert flops == per_entry * 3 * 9 * 64 * DCN_HW
    ms, by = cs.bound(got_bytes, flops, cs.F32_FLOP_PER_S)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e9)


def test_dcn_hand_counts():
    assert DCN_X + DCN_COORDS + DCN_COLS == 384_761_856
    assert DCN_COLS == 268_959_744  # the 269 MB of columns a call
