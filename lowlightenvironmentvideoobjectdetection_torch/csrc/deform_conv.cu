// Modulated deformable convolution (DCNv2), 3x3, stride 1, padding 1, for
// Hopper (sm_90a): kernel E (the im2col of bilinear samples), kernel F (the
// input's gradient) and kernel G (the offsets' and the mask's gradients).
//
// Replaces the XLA form of the JAX package's
// ops/deform_conv.py::modulated_deform_conv (the exact gather form with
// unbounded offsets, which stood in for mmcv's native
// modulated_deform_conv2d), forward and backward; it is not a Pallas kernel.
// Semantics: for image n, input channel c of deform group g = c / (C / G),
// tap k = 3 ky + kx and output pixel p = (py, px), the sample position is
// ((py + ky - 1) + dy, (px + kx - 1) + dx), summed in that order; each of
// its four bilinear corners counts only where it lies inside the map (mmcv's
// dmcn_im2col_bilinear); the column value is mask times the sample:
//
//   cols[n, c * 9 + k, p] = m * sum_corners(w * x[n, c, corner])
//
// with the corners summed in the order (y0, x0), (y0, x1), (y1, x0),
// (y1, x1). Layouts (NCHW, as the port's wrapper ops/deform_conv.py):
// x [N, C, H, W] f32 or bf16; offset [N, G * 18, H, W] f32, per group the
// 9 dy then the 9 dx (the JAX package's order, not mmcv's interleaving);
// mask [N, G * 9, H, W] f32, already sigmoided; cols [N, C * 9, H * W] f32.
// The product with the weight (out = W [Cout, C * 9] @ cols) and its
// transpose in the backward (grad_cols = W^T grad_out) stay torch.matmul in
// f32, as the JAX package leaves its einsum to XLA.
//
// What bounds them on the H100: bytes. E reads x once, the offsets and the
// mask, and writes 9 f32 columns per input element (269 MB a call at the
// aggregator's stage 0, 3 frames of 64 x 152 x 256); F reads the columns'
// gradient and adds into x's gradient; G reads the columns' gradient and x
// and writes the offsets' and the mask's gradients. Their arithmetic is a
// few operations per column element, far below the bytes' time.
//
// A sample (its position, corners and weights) depends on the image, the
// deform group, the tap and the pixel, not on the channel. One thread per
// column entry would recompute it, with three 64-bit divisions, for each of
// the group's C / G channels, and adding each of its 4 corner products to
// global memory with a scalar f32 atomic (up to 2.7e8 a call at stage 0) is
// paced by L2's atomic rate: 2.82 ms against a bound of 0.115 ms. E, F and
// G compute a sample once and reuse it over the group's channels, on 3-D
// grids that need no 64-bit division:
//
// - Kernel E: one block per (image, deform group, tile of 4 x 32 output
//   pixels); 9 warps, warp k takes tap k, each lane 4 consecutive pixels of
//   one row. A thread computes its 4 samples once, then for each of the
//   group's channels gathers their corners (through L1) and writes the 4
//   columns with one 16-byte streaming store (st.global.cs.v4.f32: the
//   columns do not fit L2); scalar stores where the 4 are not 16-byte
//   aligned or run off the map's row. The gathers' latency bounds it, more
//   than the stores: it is built for 3 blocks an SM (72 registers).
//   Staging x's window in shared memory was 2-4x slower than L1 (PERF.md).
// - Kernel F: one block per (image, deform group, tile of 8 x 32 output
//   pixels, chunk of 8 of the group's channels). The block zeroes an f32
//   window of x's gradient in shared memory, the tile plus a margin of R = 3
//   pixels: 8 + 2 (R + 1) rows and 32 + 2 ceil4(R + 1) columns (its left
//   edge on 16 bytes). Each thread takes one pixel and loops over the 9
//   taps: it reads dy, dx and m once, computes the sample once and reads
//   grad_cols for the chunk's channels (a warp reads a row's 128 bytes),
//   and adds each corner in the map but outside the window (an offset
//   beyond R pixels) to global memory itself. The corners inside go through
//   the warp: each thread writes a record (g * m for the 8 channels, 0 for
//   those past a short chunk's end, the 4 corners' weights, the corner's
//   window cell), then the warp adds the 32 records one at a time, lane =
//   (channel, corner), with shared-memory atomics.
//   A shared f32 atomic add is a compare-and-swap loop on sm_90 (ATOMS.CAS)
//   and bank conflicts multiply its cost: with a thread's own adds, lanes
//   on random corners made F twice as slow at offsets of 1.5 px as at 0.
//   Here the window interleaves the 8 channels per cell and its rows are
//   2 (mod 4) cells long, so a record's 32 adds fall in 32 banks, on 32
//   addresses, whatever the offsets. Then the block adds its window into
//   the zeroed f32 buffer with red.global.add.v4.f32, 4 pixels along x an
//   instruction, skipping vectors that stayed zero (scalar atomics where W
//   is not a multiple of 4). Windows of neighbouring tiles overlap, so the
//   flush stays atomic. The global atomic operations per channel and tile
//   fall from up to 9 x 4 x 8 x 32 scalar adds to at most 16 x 40 / 4
//   vector adds. The tile's rows, R and the chunk were chosen by timing
//   (margins 1, 3, 7; chunks 4, 8, 16; 4 or 8 rows); the window and the
//   records take 34,816 bytes a block. Times: PERF.md (chip_smoke.py, H100
//   80GB HBM3 at 700 W).
//
// - Kernel G: E's blocks and lanes (9 warps, warp k tap k, 4 pixels a lane).
//   A thread reads its 4 dy, dx once, computes the 4 samples once and walks
//   the group's channels: grad_cols 16 bytes a channel with ld.global.cs (269
//   MB a call at stage 0, the bulk of G's bytes, do not fit L2) and the 16
//   corner gathers through L1. As the mask's and the offsets' gradients are
//   linear in the corner values, it sums grad_col x corner per pixel and
//   corner (16 FMAs a channel) and applies the sample's weights and corner
//   differences once at the end; three 16-byte stores a thread. The sums run
//   in channel order with no atomics: G is deterministic. What bounds it is
//   its loads' latency, which the warps an SM holds hide. It is built for 4
//   blocks an SM (56 registers, 76 bytes spilled), which beat 2, 3 (72
//   registers, with 1, 2, 4 or 8 channels' loads in flight together), 5 and
//   6: at 4 the 480 blocks of stages 2 and 3 fit in one wave. Its channel
//   loop steps two pointers: indexing them by the channel made nvcc spill
//   more and G 7-9% slower. Splitting the channels over lane slices of
//   smaller tiles lost at offsets of 1.5 px and more. Times: PERF.md
//   (chip_smoke.py --dcn-times, H100 80GB HBM3 at 700 W).
//
// Positions and the forward's products and sums round with __fadd_rn /
// __fsub_rn / __fmul_rn: nvcc would contract a + b * c into an FMA, and an
// ulp at an integer position moves floor, and with it the cell whose
// corners take the offsets' gradient.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTaps = 9;
constexpr int kTileW = 32;              // E, F, G: a tile row is a warp
constexpr int kImRows = 4;              // E, G: 4 rows of 8 lanes x 4 px
constexpr int kImThreads = kTaps * 32;  // E, G: one warp a tap
constexpr int kColRows = 8;             // F: 8 x 32 threads, one a pixel
constexpr int kColMargin = 3;           // F: window margin in pixels
constexpr int kColChunk = 8;            // F: the chunk its warps share out
constexpr int kRec = kColChunk + 5;     // F: a sample's record (odd: no
                                        // bank conflicts when written)
constexpr int kCoordBlocks = 4;         // G: blocks an SM (56 registers)
constexpr int kMaxGrid = 65535;         // gridDim.y and gridDim.z

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The bilinear sample of tap k at output pixel (py, px): each corner's pixel
// offset in the map (0 outside), its weight (0 outside) and in-map flag, in
// the order (y0, x0), (y0, x1), (y1, x0), (y1, x1); the fractional parts;
// and the top-left corner's row and column, clamped to [-2, H] and [-2, W]
// (exact wherever a corner lies in the map).
struct Sample {
  int o[4];
  float w[4];
  bool ok[4];
  float ly, lx;
  int y0, x0;
};

__device__ __forceinline__ Sample sample_at(float dy, float dx, int py,
                                            int px, int k, int H, int W) {
  Sample s;
  // (grid + base) + offset, rounded once, as the plain version adds them
  const float sy = __fadd_rn(static_cast<float>(py + k / 3 - 1), dy);
  const float sx = __fadd_rn(static_cast<float>(px + k % 3 - 1), dx);
  const float y0 = floorf(sy), x0 = floorf(sx);
  s.ly = __fsub_rn(sy, y0);
  s.lx = __fsub_rn(sx, x0);
  const float hy = __fsub_rn(1.0f, s.ly), hx = __fsub_rn(1.0f, s.lx);
  const float wt[4] = {__fmul_rn(hy, hx), __fmul_rn(hy, s.lx),
                       __fmul_rn(s.ly, hx), __fmul_rn(s.ly, s.lx)};
  const float cy[4] = {y0, y0, y0 + 1.0f, y0 + 1.0f};
  const float cx[4] = {x0, x0 + 1.0f, x0, x0 + 1.0f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // compared as floats: an unbounded offset may lie beyond int's range
    s.ok[j] = cy[j] >= 0.0f && cy[j] < static_cast<float>(H) &&
              cx[j] >= 0.0f && cx[j] < static_cast<float>(W);
    s.o[j] = s.ok[j] ? static_cast<int>(cy[j]) * W + static_cast<int>(cx[j])
                     : 0;
    s.w[j] = s.ok[j] ? wt[j] : 0.0f;
  }
  s.y0 = static_cast<int>(fminf(fmaxf(y0, -2.0f), static_cast<float>(H)));
  s.x0 = static_cast<int>(fminf(fmaxf(x0, -2.0f), static_cast<float>(W)));
  return s;
}

constexpr int ceil4(int v) { return (v + 3) & ~3; }

// Kernel F's shared window: 8 rows plus kColMargin + 1 on each side, and 32
// columns plus ceil4(kColMargin + 1) on each side, so that its columns start
// on a multiple of 4 pixels (tiles start on multiples of 32); its rows are
// 2 cells longer than that (kColRS = 2 mod 4; the 2 are never used), each
// cell the chunk's 8 channels. Then a record of kRec floats a thread.
constexpr int kColSide = ceil4(kColMargin + 1);
constexpr int kColWH = kColRows + 2 * (kColMargin + 1);
constexpr int kColWW = kTileW + 2 * kColSide;
constexpr int kColRS = kColWW + 2;
constexpr int kColCells = kColWH * kColRS;
constexpr int kColWin = kColChunk * kColCells;
constexpr int kColThreads = kColRows * kTileW;
static_assert(kColRS % 4 == 2, "a record's 32 adds must fall in 32 banks");
static_assert((kColWin + kColThreads * kRec) * 4 <= 48 * 1024,
              "F's window and records must fit static shared memory");
static_assert((kColWin + kColThreads * kRec) % 4 == 0, "whole float4s");

// Kernel E: block (tile x, tile y, image * G + group), 9 warps; warp k takes
// tap k, lane l the 4 pixels from column 4 (l % 8) of row l / 8. The
// corners come from global memory, through L1 (staging x's window in shared
// memory was slower: PERF.md); 72 registers let 3 blocks share an SM.
template <typename T>
__global__ void __launch_bounds__(kImThreads, 3)
    dcn_im2col_tile(const T* __restrict__ x, const float* __restrict__ offset,
                    const float* __restrict__ mask, float* __restrict__ cols,
                    int C, int H, int W, int G) {
  const int k = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty0 = blockIdx.y * kImRows, tx0 = blockIdx.x * kTileW;
  const int py = ty0 + (lane >> 3), px0 = tx0 + (lane & 7) * 4;
  const int n = blockIdx.z / G, g = blockIdx.z - n * G;
  const int HW = H * W, cpg = C / G;
  const long long ng = blockIdx.z;
  const float* off = offset + ng * 2 * kTaps * HW;
  const float* msk = mask + ng * kTaps * HW;
  Sample s[4];
  float m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int px = px0 + i;
    if (py < H && px < W) {
      const int p = py * W + px;
      s[i] = sample_at(off[k * HW + p], off[(kTaps + k) * HW + p], py, px, k,
                       H, W);
      m[i] = msk[k * HW + p];
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) s[i].ok[q] = false;
      m[i] = 0.0f;
    }
  }
  const long long c0 = static_cast<long long>(n) * C + g * cpg;
  const T* xg = x + c0 * HW;
  float* out = cols + (c0 * kTaps + k) * HW + py * W + px0;
  const bool vec = py < H && px0 + 3 < W && (HW & 3) == 0 &&
                   ((py * W + px0) & 3) == 0;
  for (int j = 0; j < cpg; ++j) {
    const T* xc = xg + j * HW;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float val = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (s[i].ok[q]) {
          val = __fadd_rn(val, __fmul_rn(to_float(xc[s[i].o[q]]), s[i].w[q]));
        }
      }
      v[i] = __fmul_rn(val, m[i]);
    }
    float* o = out + j * kTaps * HW;
    if (vec) {
      __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2],
                                                       v[3]));
    } else if (py < H) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (px0 + i < W) __stcs(o + i, v[i]);
      }
    }
  }
}

// 16 bytes of f32 added to global memory in one reduction (sm_90, PTX 8.1:
// REDG.E.ADD.F32x4); each of the four adds is atomic on its own.
__device__ __forceinline__ void red_add_v4(float* p, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Kernel F: block (tile x, tile y, (image * G + group) * chunks + chunk) of
// 8 x 32 threads, one a pixel; x's gradient summed in a shared window of the
// chunk's channels, interleaved per cell, then flushed into grad_x (see the
// head of this file). Each warp adds its row's samples one at a time, lane =
// (channel lane / 4, corner lane % 4), from records that each thread writes
// for its own sample: the 32 addresses are distinct and, as kColRS = 2
// (mod 4), lie in 32 distinct banks whatever the offsets (a shared f32
// atomic add is a compare-and-swap loop on sm_90, and bank conflicts
// multiply its cost). A chunk of cc < 8 channels leaves lanes cc * 4 and up
// idle. The body is compiled for a full chunk (kFull: cc = 8 known) and for
// a short one; with cc known only at run time F was 6-14% slower.
template <bool kFull>
__device__ __forceinline__ void col2im_block(
    float* win, const float* __restrict__ grad_cols,
    const float* __restrict__ offset, const float* __restrict__ mask,
    float* grad_x, int C, int H, int W, int G, int chunks) {
  const int ty0 = blockIdx.y * kColRows, tx0 = blockIdx.x * kTileW;
  const int wy0 = ty0 - kColMargin - 1, wx0 = tx0 - kColSide;
  const int ng = blockIdx.z / chunks;
  const int j0 = (blockIdx.z - ng * chunks) * kColChunk;
  const int n = ng / G, g = ng - n * G;
  const int HW = H * W, cpg = C / G;
  const int cc = kFull ? kColChunk : min(kColChunk, cpg - j0);
  float* rec = win + kColWin;  // kRec floats a thread
  for (int i = threadIdx.x; i < kColWin; i += kColThreads) win[i] = 0.0f;
  __syncthreads();
  const long long c0 = static_cast<long long>(n) * C + g * cpg + j0;
  const int lane = threadIdx.x % kTileW;
  const int py = ty0 + threadIdx.x / kTileW, px = tx0 + lane;
  const bool in_map = py < H && px < W;
  const int p = in_map ? py * W + px : 0;
  const float* off = offset + static_cast<long long>(ng) * 2 * kTaps * HW;
  const float* msk = mask + static_cast<long long>(ng) * kTaps * HW;
  const float* gc = grad_cols + c0 * kTaps * HW + p;
  float* gx = grad_x + c0 * HW;
  float* mine = rec + threadIdx.x * kRec;
  const float* warp_rec = rec + (threadIdx.x - lane) * kRec;
  const int ch = lane >> 2, q = lane & 3;
  const int d = (q >> 1) * kColRS + (q & 1);
  for (int k = 0; k < kTaps; ++k) {
    Sample s;
    float m = 0.0f;
    int base = 0;  // the top-left corner's window cell
    bool in_win[4] = {false, false, false, false};
    if (in_map) {
      s = sample_at(off[k * HW + p], off[(kTaps + k) * HW + p], py, px, k, H,
                    W);
      m = msk[k * HW + p];
      const int ry = s.y0 - wy0, rx = s.x0 - wx0;
      base = ry * kColRS + rx;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cy = ry + (c >> 1), cx = rx + (c & 1);
        in_win[c] = s.ok[c] && cy >= 0 && cy < kColWH && cx >= 0 &&
                    cx < kColWW;
      }
    }
    float gm[kColChunk];
#pragma unroll
    for (int t = 0; t < kColChunk; ++t) {
      gm[t] = in_map && t < cc ? __fmul_rn(gc[(t * kTaps + k) * HW], m)
                               : 0.0f;
    }
    // corners in the map but outside the window: global adds, by the
    // sample's own thread
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!in_map || !s.ok[c] || in_win[c]) continue;
#pragma unroll
      for (int t = 0; t < kColChunk; ++t) {
        if (t < cc) atomicAdd(gx + t * HW + s.o[c], __fmul_rn(gm[t], s.w[c]));
      }
    }
    __syncwarp();  // the warp has read the previous tap's records
#pragma unroll
    for (int t = 0; t < kColChunk; ++t) mine[t] = gm[t];
#pragma unroll
    for (int c = 0; c < 4; ++c) mine[kColChunk + c] = in_win[c] ? s.w[c] : 0.0f;
    mine[kColChunk + 4] = __int_as_float(base);
    __syncwarp();
    if (ch < cc) {
      for (int i = 0; i < kTileW; ++i) {
        const float* r = warp_rec + i * kRec;
        const float wq = r[kColChunk + q];
        if (wq != 0.0f) {
          const int cell = __float_as_int(r[kColChunk + 4]) + d;
          atomicAdd(win + cell * kColChunk + ch, __fmul_rn(r[ch], wq));
        }
      }
    }
  }
  __syncthreads();
  if ((W & 3) == 0) {  // whole 16-byte vectors: wx0 and W are multiples of 4
    constexpr int WW4 = kColWW / 4;
    for (int i = threadIdx.x; i < kColChunk * kColWH * WW4;
         i += kColThreads) {
      const int r = i / kColChunk, jc = i - r * kColChunk;
      const int wy = r / WW4, v4 = r - wy * WW4;
      const int gy = wy0 + wy, gxc = wx0 + 4 * v4;
      if (jc >= cc || gy < 0 || gy >= H || gxc < 0 || gxc >= W) continue;
      const float* cell = win + (wy * kColRS + 4 * v4) * kColChunk + jc;
      const float4 v = make_float4(cell[0], cell[kColChunk],
                                   cell[2 * kColChunk], cell[3 * kColChunk]);
      if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f) {
        red_add_v4(grad_x + (c0 + jc) * HW + gy * W + gxc, v);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kColWin; i += kColThreads) {
      const int cell = i / kColChunk, jc = i - cell * kColChunk;
      const int wy = cell / kColRS, wx = cell - wy * kColRS;
      const int gy = wy0 + wy, gxc = wx0 + wx;
      const float v = win[i];
      if (jc >= cc || wx >= kColWW || gy < 0 || gy >= H || gxc < 0 ||
          gxc >= W || v == 0.0f) {
        continue;
      }
      atomicAdd(grad_x + (c0 + jc) * HW + gy * W + gxc, v);
    }
  }
}

__global__ void __launch_bounds__(kColThreads)
    dcn_col2im_tile(const float* __restrict__ grad_cols,
                    const float* __restrict__ offset,
                    const float* __restrict__ mask, float* grad_x, int C,
                    int H, int W, int G, int chunks) {
  __shared__ float4 win4[(kColWin + kColThreads * kRec) / 4];
  float* win = reinterpret_cast<float*>(win4);
  if (C / G - (blockIdx.z % chunks) * kColChunk >= kColChunk) {
    col2im_block<true>(win, grad_cols, offset, mask, grad_x, C, H, W, G,
                       chunks);
  } else {
    col2im_block<false>(win, grad_cols, offset, mask, grad_x, C, H, W, G,
                        chunks);
  }
}

// G's view of a sample: the flat index of its top-left corner (exact
// wherever a corner lies in the map) and its fractional parts; which of its
// corners lie in the map is kept apart, as bits.
struct Coord {
  int base;
  float ly, lx;
};

// 4 consecutive floats of a row from p: one 16-byte load where vec, else
// the first n (n < 4 at a row's end, 0 past the map), 0 beyond. kStream
// reads with ld.global.cs (the columns' gradient does not fit L2).
template <bool kStream>
__device__ __forceinline__ void load4(const float* p, bool vec, int n,
                                      float v[4]) {
  if (vec) {
    const float4 t = kStream ? __ldcs(reinterpret_cast<const float4*>(p))
                             : *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = i < n ? (kStream ? __ldcs(p + i) : p[i]) : 0.0f;
    }
  }
}

// The first n of 4 consecutive floats of a row to p, streamed, with one
// 16-byte store where vec.
__device__ __forceinline__ void store4(float* p, bool vec, int n,
                                       const float v[4]) {
  if (vec) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < n) __stcs(p + i, v[i]);
    }
  }
}

// Adds one channel's terms to a thread's sums: gc[i] times each in-map
// corner of pixel i (bit 4 i + q of ok for corner q), into acc[i][q].
template <typename T>
__device__ __forceinline__ void coord_channel(const T* __restrict__ xc,
                                              const Coord* s, unsigned ok,
                                              int W, const float gc[4],
                                              float acc[4][4]) {
  float v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d[4] = {0, 1, W, W + 1};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool in = (ok >> (4 * i + q)) & 1u;
      v[i][q] = in ? to_float(xc[s[i].base + d[q]]) : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(gc[i], v[i][q], acc[i][q]);
  }
}

// Kernel G: block (tile x, tile y, image * G + group) of 9 warps, as E:
// warp k takes tap k, lane l the 4 pixels from column 4 (l % 8) of row
// l / 8. A thread reads its 4 dy and dx once (16-byte loads where it can)
// and computes the 4 samples once. The three sums over the group's
// channels are linear in the corner values, so it sums instead, per pixel
// and corner, A_q = sum_c grad_col * v_q (0 for a corner outside the map)
// and applies the sample's coefficients once at the end:
//
//   grad_mask = sum_q w_q A_q
//   grad_dy   = m ((1 - lx) (A_10 - A_00) + lx (A_11 - A_01))
//   grad_dx   = m ((1 - ly) (A_01 - A_00) + ly (A_11 - A_10))
//
// A channel costs a 16-byte streaming load of grad_cols, 16 corner gathers
// through L1 and 16 FMAs. The sums run in channel order with no atomics, so
// G is deterministic.
template <typename T>
__global__ void __launch_bounds__(kImThreads, kCoordBlocks)
    dcn_col2im_coord_tile(const float* __restrict__ grad_cols,
                          const T* __restrict__ x,
                          const float* __restrict__ offset,
                          const float* __restrict__ mask,
                          float* __restrict__ grad_offset,
                          float* __restrict__ grad_mask, int C, int H, int W,
                          int G, bool aligned) {
  const int k = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int py = blockIdx.y * kImRows + (lane >> 3);
  const int px0 = blockIdx.x * kTileW + (lane & 7) * 4;
  const int n = blockIdx.z / G, g = blockIdx.z - n * G;
  const int HW = H * W, cpg = C / G;
  const int p = py * W + px0;
  // pixels of the 4 in the map, and whether 16-byte accesses fit them
  const int in_map = py < H ? min(4, W - px0) : 0;
  const bool vec = aligned && in_map == 4 && (p & 3) == 0;
  const long long ng = blockIdx.z;
  const float* off = offset + (ng * 2 * kTaps + k) * HW + p;
  float dy[4], dx[4];
  load4<false>(off, vec, in_map, dy);
  load4<false>(off + kTaps * HW, vec, in_map, dx);
  Coord s[4];
  unsigned ok = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[i] = Coord{0, 0.0f, 0.0f};
    if (i < in_map) {
      const Sample a = sample_at(dy[i], dx[i], py, px0 + i, k, H, W);
      s[i] = Coord{a.y0 * W + a.x0, a.ly, a.lx};
#pragma unroll
      for (int q = 0; q < 4; ++q) ok |= unsigned(a.ok[q]) << (4 * i + q);
    }
  }
  const long long c0 = static_cast<long long>(n) * C + g * cpg;
  const T* xg = x + c0 * HW;
  const float* gcp = grad_cols + (c0 * kTaps + k) * HW + p;
  float acc[4][4] = {};
  for (int j = 0; j < cpg; ++j, gcp += kTaps * HW, xg += HW) {
    float gc[4];
    load4<true>(gcp, vec, in_map, gc);
    coord_channel(xg, s, ok, W, gc, acc);
  }
  if (in_map <= 0) return;
  float m[4], gy[4], gx[4], gm[4];
  load4<false>(mask + (ng * kTaps + k) * HW + p, vec, in_map, m);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* a = acc[i];
    const float ly = s[i].ly, lx = s[i].lx;
    const float hy = __fsub_rn(1.0f, ly), hx = __fsub_rn(1.0f, lx);
    gm[i] = __fmul_rn(hy, hx) * a[0] + __fmul_rn(hy, lx) * a[1] +
            __fmul_rn(ly, hx) * a[2] + __fmul_rn(ly, lx) * a[3];
    gy[i] = m[i] * (hx * (a[2] - a[0]) + lx * (a[3] - a[1]));
    gx[i] = m[i] * (hy * (a[1] - a[0]) + ly * (a[3] - a[2]));
  }
  float* go = grad_offset + (ng * 2 * kTaps + k) * HW + p;
  store4(go, vec, in_map, gy);
  store4(go + kTaps * HW, vec, in_map, gx);
  store4(grad_mask + (ng * kTaps + k) * HW + p, vec, in_map, gm);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

bool bad_shape(int N, int C, int H, int W, int G) {
  return N < 0 || C <= 0 || H <= 0 || W <= 0 || G <= 0 || C % G != 0;
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// Kernel E. dtype: 0 = float32, 1 = bfloat16 (x); offset, mask and cols
// float32, contiguous. Returns cudaErrorInvalidValue for a grid beyond its
// limits, else cudaGetLastError() after the launch.
extern "C" int llvod_dcn_im2col(const void* x, const void* offset,
                                const void* mask, void* cols, int N, int C,
                                int H, int W, int G, int dtype,
                                void* stream) {
  if (bad_shape(N, C, H, W, G)) return kInvalid;
  const long long ng = static_cast<long long>(N) * G;
  const int tiles_y = (H + kImRows - 1) / kImRows;
  if (ng > kMaxGrid || tiles_y > kMaxGrid) return kInvalid;
  if (ng == 0) return 0;
  const dim3 grid((W + kTileW - 1) / kTileW, tiles_y,
                  static_cast<unsigned int>(ng));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* o = static_cast<const float*>(offset);
  const float* m = static_cast<const float*>(mask);
  float* out = static_cast<float*>(cols);
  if (dtype == 0) {
    dcn_im2col_tile<float><<<grid, kImThreads, 0, s>>>(
        static_cast<const float*>(x), o, m, out, C, H, W, G);
  } else if (dtype == 1) {
    dcn_im2col_tile<__nv_bfloat16><<<grid, kImThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), o, m, out, C, H, W, G);
  } else {
    return kInvalid;
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel F. grad_cols, offset, mask float32; grad_x a zeroed float32
// [N, C, H, W] buffer that receives x's gradient. Returns
// cudaErrorInvalidValue for a grid beyond its limits, else
// cudaGetLastError() after the launch.
extern "C" int llvod_dcn_col2im(const void* grad_cols, const void* offset,
                                const void* mask, void* grad_x, int N, int C,
                                int H, int W, int G, void* stream) {
  if (bad_shape(N, C, H, W, G)) return kInvalid;
  const int chunks = (C / G + kColChunk - 1) / kColChunk;
  const long long z = static_cast<long long>(N) * G * chunks;
  const int tiles_y = (H + kColRows - 1) / kColRows;
  if (z > kMaxGrid || tiles_y > kMaxGrid) return kInvalid;
  if (z == 0) return 0;
  const dim3 grid((W + kTileW - 1) / kTileW, tiles_y,
                  static_cast<unsigned int>(z));
  dcn_col2im_tile<<<grid, kColThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grad_cols), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<float*>(grad_x), C, H, W,
      G, chunks);
  return static_cast<int>(cudaGetLastError());
}

// Kernel G. dtype as for llvod_dcn_im2col (x); grad_offset [N, G * 18, H, W]
// and grad_mask [N, G * 9, H, W] float32, every element written. Returns
// cudaErrorInvalidValue for a grid beyond its limits, else
// cudaGetLastError() after the launch.
extern "C" int llvod_dcn_col2im_coord(const void* grad_cols, const void* x,
                                      const void* offset, const void* mask,
                                      void* grad_offset, void* grad_mask,
                                      int N, int C, int H, int W, int G,
                                      int dtype, void* stream) {
  if (bad_shape(N, C, H, W, G)) return kInvalid;
  const long long ng = static_cast<long long>(N) * G;
  const int tiles_y = (H + kImRows - 1) / kImRows;
  if (ng > kMaxGrid || tiles_y > kMaxGrid) return kInvalid;
  if (ng == 0) return 0;
  const dim3 grid((W + kTileW - 1) / kTileW, tiles_y,
                  static_cast<unsigned int>(ng));
  // 16-byte accesses need every plane to start on 16 bytes
  const bool aligned = (H * W) % 4 == 0 && aligned16(grad_cols) &&
                       aligned16(offset) && aligned16(mask) &&
                       aligned16(grad_offset) && aligned16(grad_mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gc = static_cast<const float*>(grad_cols);
  const float* o = static_cast<const float*>(offset);
  const float* m = static_cast<const float*>(mask);
  float* go = static_cast<float*>(grad_offset);
  float* gm = static_cast<float*>(grad_mask);
  if (dtype == 0) {
    dcn_col2im_coord_tile<float><<<grid, kImThreads, 0, s>>>(
        gc, static_cast<const float*>(x), o, m, go, gm, C, H, W, G, aligned);
  } else if (dtype == 1) {
    dcn_col2im_coord_tile<__nv_bfloat16><<<grid, kImThreads, 0, s>>>(
        gc, static_cast<const __nv_bfloat16*>(x), o, m, go, gm, C, H, W, G,
        aligned);
  } else {
    return kInvalid;
  }
  return static_cast<int>(cudaGetLastError());
}
