// RoIAlign (avg mode, aligned) over NHWC feature maps and its gradient
// with respect to the maps, for Hopper (sm_90a): kernel B (forward) and
// kernel D (backward), below.
//
// Replaces the TPU kernel ops/roi_align_pallas.py::roi_align_pallas
// (_kernel) of the JAX package, and serves the batched gather form
// ops/roi_align.py::roi_align as well: one entry takes B maps and a per-roi
// int64 map index, read as given and clamped to [0, B - 1].
//
// Semantics (ops/roi_align.py:24-45 of the JAX package): sample positions
// y = y1 + (p + (s + 0.5) / sr) * roi_h / out, samples below -1 or above the
// size contribute zero, the position is clamped to [0, size - 1], the high
// corner is clamped to size - 1, and the bin value is the mean over the
// sr x sr sub-samples. All of it in f32; the output has the feature dtype.
//
// What bounds it on the H100: the gather stream through L1, not HBM and not
// L2. The least time of the function (its bytes over 3.35 TB/s, mostly the
// output) is far below what the gathers cost: 16 corner rows of C channels
// for each of the out x out bins, about 800 KB through L1 per roi at C = 512
// in bf16, with one bf16 -> f32 conversion and one FMA per gathered element.
// The map (2.5 MB a frame at 38 x 64 x 512 bf16) stays in the 50 MB L2, and
// the time does not change with the rois' size (zero-area rois, whose
// gathers all hit L1, take as long as rois of 1600 px), so what sets the
// pace is the number of load and arithmetic instructions and how many loads
// are in flight, not L2 traffic; staging a roi's footprint in shared memory
// would not help.
//
// The design ("gather" body, one instantiation per (out, sr)):
// - (out, sr) are template arguments, so the sub-sample and channel loops
//   unroll completely: each bin's 4 sr^2 corner loads are independent and
//   all in flight together, with no dependent chain across samples. The
//   bins run one after another.
// - Each thread owns 16 bytes of channels (8 bf16 or 4 f32): one 16-byte
//   ld.global.nc per corner, as many f32 accumulators, and one 16-byte
//   streaming store per output bin (the output is not read again here, so
//   it should not push the maps out of L2).
// - One block per roi: threads run over (output row, channel vector), so a
//   warp reads whole 512-byte row segments of the map and the roi's
//   repeated corners are shared through one SM's L1. The roi's per-axis
//   sample table (corner offsets and weights, 16 bytes a sample) is computed
//   once per block into shared memory and read back as warp-uniform
//   broadcasts.
// - Positions round with __fmul_rn / __fadd_rn: FMA contraction moved
//   samples by an ulp against the plain version.
//
// The mask-target body ("gather28x2", the scalar kernel below): Mask
// R-CNN's targets are a RoIAlign at 28 x 28 of each sampled roi's matched
// gt mask, a 1-channel float32 map at the image's size (JAX:
// models/roi_heads/mask_head.py mask_targets). One channel is a quarter of
// a 16-byte vector, so this body reads scalars: one thread per (bin,
// channel), its 4 sr^2 corner loads independent, the sample table in
// shared memory as above. What bounds it: the scattered 4-byte loads, 16 a
// bin (784 bins a roi, 50 KB of corner reads against the 3 KB written); the
// masks (G x 608 x 1024 x 4 B, 50 MB at 20 gts) do not stay in L2, but a
// roi reads only its own footprint, at most 56 x 56 sample rows and
// columns. No backward body: the targets are thresholded and take no
// gradient.
//
// Kernel D ("scatter" body, llvod_roi_align_backward) is the backward of
// kernel B with respect to the maps; no TPU kernel corresponds to it (the
// JAX package takes this gradient by autodiff of ops/roi_align.py). The
// forward is separable, pooled = Ay F Ax^T with per-roi [out, H] and
// [out, W] matrices (the sr mean folded in), so for grad_out G [out, out, C]
// of one roi the maps' gradient is dF = Ay^T G Ax. Out-of-range samples give
// nothing, clamped corners that fall on one pixel both add (as the forward
// sums them), map indices clamp to [0, B - 1], and as in mmcv's RoIAlign
// there is no gradient for the rois.
//
// What bounds it on the H100: the atomic adds that L2 retires, not HBM. The
// least time of the function at the training step's reference rois (2 maps
// of 38 x 64 x 512, 600 rois, bf16) is its 35.1 MB (grad_out 30.1 MB, the
// maps' gradient 5.0 MB written once, the rois) over 3.35 TB/s, 10.5 us.
// Adding every corner product to global memory, as this kernel first did,
// is up to 4 sr^2 out^2 = 784 f32 atomic adds per roi and channel (2.4e8 at
// that shape); they took 0.39 ms whatever the rois' size (square rois of 0
// to 512 image px, 600 of them), so L2's rate of atomic operations, not
// same-address adds inside a roi, set the pace.
//
// The design: reduce each roi's footprint on chip, then add each pixel of it
// once. A roi touches at most 2 out sr distinct rows and as many columns
// (28 at 7x7, sr 2), about ceil(s) + 2 of each for a roi s feature pixels
// wide, so the global adds per roi and channel fall from 784 to (ceil(s) +
// 2)^2, capped at 784 for rois wider than about 26 pixels (416 image px),
// whose samples are a pixel or more apart and seldom share an address. One
// route serves every roi; no window has to fit a tile.
// - One block per (roi, slice of 64 channels, 32 for the 14x2 body): 4,800
//   blocks of 128 threads at 600 rois, C = 512. The block builds the roi's
//   sample tables (the forward's __fmul_rn / __fadd_rn positions), stages
//   its grad_out slice in shared memory as f32 (16-byte loads: 8 bf16 or 4
//   f32), and lists each axis's distinct pixels with the summed weight of
//   every bin on them (Ay, Ax over slots, the 1 / sr of the mean on each).
// - Thread (column slot, 4 channels) holds T[p] = sum_q Ax[q][col] G[p][q]
//   for every row bin p in registers (out x 4 floats), then for each
//   distinct row adds sum_p Ay[p][row] T[p] to the maps' gradient with one
//   16-byte red.global.add.v4.f32 (sm_90, REDG.E.ADD.F32x4): one
//   instruction where four scalar atomic adds were.
// - The sum is f32 in a zeroed buffer that the wrapper allocates and, for
//   bf16 maps, casts once at the end.
// - nvcc -Xptxas -v: 56 registers and 15,024 B of shared memory for the
//   7x2 body, 96 and 33,168 B for the 14x2 body, no spills.
// What bounds it now: still L2's atomic rate, per 32-byte sector. Rois of
// 512 image px (784 distinct pixels) take as long as before, 0.34-0.35 ms
// at 600 rois; on the training step's own rois (about 100 pixels a roi)
// the two launches take about 0.1 ms against 0.53 ms (chip_smoke.py,
// H100 80GB HBM3 at 700 W).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <cstring>

namespace {

// 7 output rows of 64 threads (C = 512 in bf16); two such blocks an SM
// leave each thread 72 registers, which hold a bin's 16 loads without spills
constexpr int kMaxThreads = 448;

// One sample along one axis: the element offsets of its two corners along
// that axis (index times the axis stride) and their bilinear weights, zero
// when the sample is out of range.
struct __align__(16) Sample {
  int o0, o1;
  float w0, w1;
};

__device__ __forceinline__ Sample axis_sample(float lo, float bin, int p,
                                              float sub, int size,
                                              int stride) {
  // _rn: no FMA contraction, so positions round as in the plain version
  const float x = __fadd_rn(lo, __fmul_rn(static_cast<float>(p) + sub, bin));
  const bool oob = (x < -1.0f) || (x > static_cast<float>(size));
  const float xc = fminf(fmaxf(x, 0.0f), static_cast<float>(size) - 1.0f);
  const float f0 = floorf(xc);
  const float f1 = fminf(f0 + 1.0f, static_cast<float>(size) - 1.0f);
  const float l = xc - f0;
  Sample s;
  s.o0 = static_cast<int>(f0) * stride;
  s.o1 = static_cast<int>(f1) * stride;
  s.w0 = oob ? 0.0f : 1.0f - l;
  s.w1 = oob ? 0.0f : l;
  return s;
}

// 16 bytes of channels: load through the read-only path, store streaming.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  // a bf16 is the high half of the f32 with the same value; the element at
  // the lower address is the low half of each 32-bit word
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      memcpy(&w[i], &h, sizeof(unsigned));
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
};

template <typename T, int OUT, int SR>
__global__ void __launch_bounds__(kMaxThreads, 2)
roi_align_gather(const T* __restrict__ feat, const float* __restrict__ rois,
                 const long long* __restrict__ binds, T* __restrict__ out,
                 int B, int H, int W, int C, float spatial_scale,
                 float offset) {
  constexpr int kV = Vec<T>::kN;
  constexpr int kPts = OUT * SR;
  __shared__ Sample ys[kPts], xs[kPts];

  const int n = blockIdx.x;
  const float* r = rois + 4 * n;
  const float x1 = __fsub_rn(__fmul_rn(r[0], spatial_scale), offset);
  const float y1 = __fsub_rn(__fmul_rn(r[1], spatial_scale), offset);
  const float x2 = __fsub_rn(__fmul_rn(r[2], spatial_scale), offset);
  const float y2 = __fsub_rn(__fmul_rn(r[3], spatial_scale), offset);
  const float bin_w = (x2 - x1) / static_cast<float>(OUT);
  const float bin_h = (y2 - y1) / static_cast<float>(OUT);
  for (int i = threadIdx.x; i < 2 * kPts; i += blockDim.x) {
    const int j = i < kPts ? i : i - kPts;
    const float sub = (static_cast<float>(j % SR) + 0.5f) /
                      static_cast<float>(SR);
    if (i < kPts) {
      ys[j] = axis_sample(y1, bin_h, j / SR, sub, H, W * C);
    } else {
      xs[j] = axis_sample(x1, bin_w, j / SR, sub, W, C);
    }
  }

  long long b = binds ? binds[n] : 0;
  b = b < 0 ? 0 : (b >= B ? B - 1 : b);
  const T* f = feat + static_cast<size_t>(b) * H * W * C;
  T* o = out + static_cast<size_t>(n) * OUT * OUT * C;
  __syncthreads();

  const int lanes = C / kV;
  for (int it = threadIdx.x; it < lanes * OUT; it += blockDim.x) {
    const int p = it / lanes;
    const int c = (it % lanes) * kV;
    Sample sy[SR];
#pragma unroll
    for (int k = 0; k < SR; ++k) sy[k] = ys[p * SR + k];
    // one bin at a time: unrolling the bins as well spills at this budget
#pragma unroll 1
    for (int q = 0; q < OUT; ++q) {
      float acc[kV];
#pragma unroll
      for (int k = 0; k < kV; ++k) acc[k] = 0.0f;
#pragma unroll
      for (int ky = 0; ky < SR; ++ky) {
#pragma unroll
        for (int kx = 0; kx < SR; ++kx) {
          const Sample sx = xs[q * SR + kx];
          const T* f0 = f + sy[ky].o0 + c;
          const T* f1 = f + sy[ky].o1 + c;
          float v00[kV], v01[kV], v10[kV], v11[kV];
          Vec<T>::load(f0 + sx.o0, v00);
          Vec<T>::load(f0 + sx.o1, v01);
          Vec<T>::load(f1 + sx.o0, v10);
          Vec<T>::load(f1 + sx.o1, v11);
          const float w00 = sy[ky].w0 * sx.w0, w01 = sy[ky].w0 * sx.w1;
          const float w10 = sy[ky].w1 * sx.w0, w11 = sy[ky].w1 * sx.w1;
#pragma unroll
          for (int k = 0; k < kV; ++k) {
            acc[k] += w00 * v00[k] + w01 * v01[k] + w10 * v10[k] +
                      w11 * v11[k];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        acc[k] *= 1.0f / static_cast<float>(SR * SR);
      }
      Vec<T>::store(o + static_cast<size_t>(p * OUT + q) * C + c, acc);
    }
  }
}

// Kernel B's scalar body: any number of float32 channels, one thread per
// (bin, channel) of a roi's OUT x OUT x C output, in the output's order.
constexpr int kScalarThreads = 256;

template <int OUT, int SR>
__global__ void __launch_bounds__(kScalarThreads)
roi_align_gather_scalar(const float* __restrict__ feat,
                        const float* __restrict__ rois,
                        const long long* __restrict__ binds,
                        float* __restrict__ out, int B, int H, int W, int C,
                        float spatial_scale, float offset) {
  constexpr int kPts = OUT * SR;
  __shared__ Sample ys[kPts], xs[kPts];

  const int n = blockIdx.x;
  const float* r = rois + 4 * n;
  const float x1 = __fsub_rn(__fmul_rn(r[0], spatial_scale), offset);
  const float y1 = __fsub_rn(__fmul_rn(r[1], spatial_scale), offset);
  const float x2 = __fsub_rn(__fmul_rn(r[2], spatial_scale), offset);
  const float y2 = __fsub_rn(__fmul_rn(r[3], spatial_scale), offset);
  const float bin_w = (x2 - x1) / static_cast<float>(OUT);
  const float bin_h = (y2 - y1) / static_cast<float>(OUT);
  for (int i = threadIdx.x; i < 2 * kPts; i += blockDim.x) {
    const int j = i < kPts ? i : i - kPts;
    const float sub = (static_cast<float>(j % SR) + 0.5f) /
                      static_cast<float>(SR);
    if (i < kPts) {
      ys[j] = axis_sample(y1, bin_h, j / SR, sub, H, W * C);
    } else {
      xs[j] = axis_sample(x1, bin_w, j / SR, sub, W, C);
    }
  }

  long long b = binds ? binds[n] : 0;
  b = b < 0 ? 0 : (b >= B ? B - 1 : b);
  const float* f = feat + static_cast<size_t>(b) * H * W * C;
  float* o = out + static_cast<size_t>(n) * OUT * OUT * C;
  __syncthreads();

  for (int it = threadIdx.x; it < OUT * OUT * C; it += blockDim.x) {
    const int c = it % C;
    const int bin = it / C;
    const int p = bin / OUT, q = bin - p * OUT;
    float acc = 0.0f;
#pragma unroll
    for (int ky = 0; ky < SR; ++ky) {
      const Sample sy = ys[p * SR + ky];
#pragma unroll
      for (int kx = 0; kx < SR; ++kx) {
        const Sample sx = xs[q * SR + kx];
        const float v00 = __ldg(f + sy.o0 + sx.o0 + c);
        const float v01 = __ldg(f + sy.o0 + sx.o1 + c);
        const float v10 = __ldg(f + sy.o1 + sx.o0 + c);
        const float v11 = __ldg(f + sy.o1 + sx.o1 + c);
        acc += sy.w0 * sx.w0 * v00 + sy.w0 * sx.w1 * v01 +
               sy.w1 * sx.w0 * v10 + sy.w1 * sx.w1 * v11;
      }
    }
    __stcs(o + it, acc * (1.0f / static_cast<float>(SR * SR)));
  }
}

// Kernel D's blocks: one per (roi, slice of kScatterChannels channels).
// 64 channels for the 7x2 body fill 132 SMs even at 256 rois (2,048 blocks
// at C = 512); the 14x2 body halves the slice, so its grad_out stage (196
// bins) stays at 25 KB of shared memory.
constexpr int kScatterThreads = 128;

template <int OUT>
__host__ __device__ constexpr int scatter_channels() {
  return OUT <= 7 ? 64 : 32;
}

// One (sample, corner) entry of an axis: e = 2 * sample + corner.
__device__ __forceinline__ void entry(const Sample* s, int e, int& o,
                                      float& w) {
  const Sample x = s[e >> 1];
  o = (e & 1) ? x.o1 : x.o0;
  w = (e & 1) ? x.w1 : x.w0;
}

// 16 bytes of f32 added to global memory in one reduction (sm_90, PTX 8.1:
// REDG.E.ADD.F32x4); each of the four adds is atomic on its own.
__device__ __forceinline__ void red_add_v4(float* p, const float (&v)[4]) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

template <typename T, int OUT, int SR>
__global__ void __launch_bounds__(kScatterThreads)
roi_align_scatter(const T* __restrict__ grad_out,
                  const float* __restrict__ rois,
                  const long long* __restrict__ binds,
                  float* __restrict__ grad, int B, int H, int W, int C,
                  float spatial_scale, float offset) {
  constexpr int kPts = OUT * SR;
  constexpr int kEnt = 2 * kPts;  // (sample, corner) entries of an axis
  constexpr int kCS = scatter_channels<OUT>();
  constexpr int kLanes = kCS / 4;  // threads over a pixel's 16-byte vectors
  constexpr int kRows = kScatterThreads / kLanes;
  constexpr int kV = Vec<T>::kN;
  static_assert(kEnt <= 64, "two entries a lane in one warp");
  __shared__ Sample smp[2][kPts];        // y, then x
  __shared__ int slot[2][kEnt];          // entry -> its pixel's slot, or -1
  __shared__ int offs[2][kEnt];          // slot -> element offset
  __shared__ int count[2];               // distinct rows, distinct columns
  __shared__ float wts[2][OUT][kEnt];    // [axis][bin][slot], 1 / SR folded
  __shared__ float4 gs[OUT * OUT * kLanes];  // grad_out's slice in f32

  const int n = blockIdx.x;
  const int c0 = blockIdx.y * kCS;
  const float* r = rois + 4 * n;
  const float x1 = __fsub_rn(__fmul_rn(r[0], spatial_scale), offset);
  const float y1 = __fsub_rn(__fmul_rn(r[1], spatial_scale), offset);
  const float x2 = __fsub_rn(__fmul_rn(r[2], spatial_scale), offset);
  const float y2 = __fsub_rn(__fmul_rn(r[3], spatial_scale), offset);
  const float bin_w = (x2 - x1) / static_cast<float>(OUT);
  const float bin_h = (y2 - y1) / static_cast<float>(OUT);
  for (int i = threadIdx.x; i < 2 * kPts; i += blockDim.x) {
    const int j = i < kPts ? i : i - kPts;
    const float sub = (static_cast<float>(j % SR) + 0.5f) /
                      static_cast<float>(SR);
    if (i < kPts) {
      smp[0][j] = axis_sample(y1, bin_h, j / SR, sub, H, W * C);
    } else {
      smp[1][j] = axis_sample(x1, bin_w, j / SR, sub, W, C);
    }
  }
  // grad_out's [OUT, OUT, kCS] slice in f32, read as 16-byte vectors
  const T* go = grad_out + static_cast<size_t>(n) * OUT * OUT * C + c0;
  const int vecs = min(kCS, C - c0) / kV;
  for (int i = threadIdx.x; i < OUT * OUT * vecs; i += blockDim.x) {
    const int bin = i / vecs, v = i - bin * vecs;
    float x[kV];
    Vec<T>::load(go + static_cast<size_t>(bin) * C + v * kV, x);
#pragma unroll
    for (int k = 0; k < kV / 4; ++k) {
      gs[bin * kLanes + v * (kV / 4) + k] =
          make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
    }
  }
  __syncthreads();

  // Warp a lists axis a's distinct pixels: an entry with a nonzero weight
  // takes the slot of the first such entry on its pixel; slots number the
  // first entries in order.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < 2) {
    const Sample* s = smp[warp];
    int first[2], off[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = lane + 32 * h;
      first[h] = -1;
      off[h] = 0;
      if (e < kEnt) {
        float w;
        entry(s, e, off[h], w);
        if (w != 0.0f) {
          first[h] = e;
          for (int k = 0; k < e; ++k) {
            int ok;
            float wk;
            entry(s, k, ok, wk);
            if (wk != 0.0f && ok == off[h]) {
              first[h] = k;
              break;
            }
          }
        }
      }
    }
    const unsigned m0 = __ballot_sync(~0u, first[0] == lane);
    const unsigned m1 = __ballot_sync(~0u, first[1] == lane + 32);
    const auto rank = [&](int e) {
      return e < 32 ? __popc(m0 & ((1u << e) - 1u))
                    : __popc(m0) + __popc(m1 & ((1u << (e - 32)) - 1u));
    };
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = lane + 32 * h;
      if (e < kEnt) slot[warp][e] = first[h] < 0 ? -1 : rank(first[h]);
      if (first[h] == e) offs[warp][rank(e)] = off[h];
    }
    if (lane == 0) count[warp] = __popc(m0) + __popc(m1);
  }
  __syncthreads();

  // The separable weights: wts[a][p][slot], the corner weights of bin p's
  // SR samples on that pixel, summed in entry order, times 1 / SR (the
  // mean's 1 / SR^2, one factor per axis).
  for (int i = threadIdx.x; i < 2 * OUT * kEnt; i += blockDim.x) {
    const int a = i / (OUT * kEnt), p = (i / kEnt) % OUT, sl = i % kEnt;
    if (sl >= count[a]) continue;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 2 * SR; ++k) {
      const int e = p * 2 * SR + k;
      int o;
      float w;
      entry(smp[a], e, o, w);
      if (slot[a][e] == sl) acc += w;
    }
    wts[a][p][sl] = acc * (1.0f / static_cast<float>(SR));
  }
  __syncthreads();

  // Thread (row, lane) owns 4 channels of the distinct columns row,
  // row + kRows, ...: T[p] = sum_q Ax[q][col] G[p][q] in registers (bins
  // with no weight on the column skipped), then for every distinct row
  // dF = sum_p Ay[p][row] T[p], one 16-byte reduction a pixel.
  const int cl = threadIdx.x % kLanes, row = threadIdx.x / kLanes;
  const int c = c0 + 4 * cl;
  if (c >= C) return;
  long long b = binds ? binds[n] : 0;
  b = b < 0 ? 0 : (b >= B ? B - 1 : b);
  float* g = grad + static_cast<size_t>(b) * H * W * C + c;
  const int ny = count[0], nx = count[1];
  for (int sx = row; sx < nx; sx += kRows) {
    float t[OUT][4];
#pragma unroll
    for (int p = 0; p < OUT; ++p) {
      t[p][0] = t[p][1] = t[p][2] = t[p][3] = 0.0f;
    }
    for (int q = 0; q < OUT; ++q) {
      const float ax = wts[1][q][sx];
      if (ax == 0.0f) continue;
#pragma unroll
      for (int p = 0; p < OUT; ++p) {
        const float4 v = gs[(p * OUT + q) * kLanes + cl];
        t[p][0] = fmaf(ax, v.x, t[p][0]);
        t[p][1] = fmaf(ax, v.y, t[p][1]);
        t[p][2] = fmaf(ax, v.z, t[p][2]);
        t[p][3] = fmaf(ax, v.w, t[p][3]);
      }
    }
    float* gx = g + offs[1][sx];
    for (int sy = 0; sy < ny; ++sy) {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int p = 0; p < OUT; ++p) {
        const float ay = wts[0][p][sy];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = fmaf(ay, t[p][k], v[k]);
      }
      red_add_v4(gx + offs[0][sy], v);
    }
  }
}

template <typename T, int OUT, int SR>
int launch_scatter(const void* grad_out, const float* rois,
                   const long long* binds, float* grad, int B, int H, int W,
                   int C, int N, float spatial_scale, float offset,
                   cudaStream_t s) {
  constexpr int kCS = scatter_channels<OUT>();
  const dim3 grid(N, (C + kCS - 1) / kCS);
  roi_align_scatter<T, OUT, SR><<<grid, kScatterThreads, 0, s>>>(
      static_cast<const T*>(grad_out), rois, binds, grad, B, H, W, C,
      spatial_scale, offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scatter_body(int out_size, int sr, const void* grad_out,
                        const float* rois, const long long* binds,
                        float* grad, int B, int H, int W, int C, int N,
                        float spatial_scale, float offset, cudaStream_t s) {
  if (C % Vec<T>::kN != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (out_size == 7 && sr == 2) {
    return launch_scatter<T, 7, 2>(grad_out, rois, binds, grad, B, H, W, C,
                                   N, spatial_scale, offset, s);
  }
  if (out_size == 14 && sr == 2) {
    return launch_scatter<T, 14, 2>(grad_out, rois, binds, grad, B, H, W, C,
                                    N, spatial_scale, offset, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int OUT, int SR>
int launch(const void* feat, const float* rois, const long long* binds,
           void* out, int B, int H, int W, int C, int N, float spatial_scale,
           float offset, cudaStream_t s) {
  const int lanes = C / Vec<T>::kN;
  const int threads = std::min(kMaxThreads, (lanes * OUT + 31) / 32 * 32);
  roi_align_gather<T, OUT, SR><<<N, threads, 0, s>>>(
      static_cast<const T*>(feat), rois, binds, static_cast<T*>(out), B, H, W,
      C, spatial_scale, offset);
  return static_cast<int>(cudaGetLastError());
}

template <int OUT, int SR>
int launch_scalar(const void* feat, const float* rois, const long long* binds,
                  void* out, int B, int H, int W, int C, int N,
                  float spatial_scale, float offset, cudaStream_t s) {
  roi_align_gather_scalar<OUT, SR><<<N, kScalarThreads, 0, s>>>(
      static_cast<const float*>(feat), rois, binds, static_cast<float*>(out),
      B, H, W, C, spatial_scale, offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_body(int out_size, int sr, const void* feat, const float* rois,
                const long long* binds, void* out, int B, int H, int W, int C,
                int N, float spatial_scale, float offset, cudaStream_t s) {
  if (C % Vec<T>::kN != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (out_size == 7 && sr == 2) {
    return launch<T, 7, 2>(feat, rois, binds, out, B, H, W, C, N,
                           spatial_scale, offset, s);
  }
  if (out_size == 14 && sr == 2) {
    return launch<T, 14, 2>(feat, rois, binds, out, B, H, W, C, N,
                            spatial_scale, offset, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (features and output); C a multiple of
// 16 bytes of channels and feat / out 16-byte aligned. binds: the per-roi
// int64 map index, or null (every roi reads map 0). (out_size, sr) is (7, 2)
// or (14, 2), or (28, 2): the scalar body, float32 only, any C. One thread
// block per roi. Returns cudaGetLastError() after the launch.
extern "C" int llvod_roi_align(const void* feat, const void* rois,
                               const void* binds, void* out, int B, int H,
                               int W, int C, int N, float spatial_scale,
                               float offset, int out_size, int sr, int dtype,
                               void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const long long* b = static_cast<const long long*>(binds);
  if (out_size == 28 && sr == 2) {  // the scalar body, float32 only
    if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_scalar<28, 2>(feat, r, b, out, B, H, W, C, N,
                                spatial_scale, offset, s);
  }
  if (dtype == 0) {
    return launch_body<float>(out_size, sr, feat, r, b, out, B, H, W, C, N,
                              spatial_scale, offset, s);
  }
  if (dtype == 1) {
    return launch_body<__nv_bfloat16>(out_size, sr, feat, r, b, out, B, H, W,
                                      C, N, spatial_scale, offset, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel D. dtype: 0 = float32, 1 = bfloat16 (grad_out); grad: a zeroed
// float32 [B, H, W, C] buffer that receives the maps' gradient; grad_out
// 16-byte aligned. binds, C and (out_size, sr) as for llvod_roi_align. One
// thread block per roi and slice of channels. Returns cudaGetLastError()
// after the launch.
extern "C" int llvod_roi_align_backward(const void* grad_out,
                                        const void* rois, const void* binds,
                                        void* grad, int B, int H, int W,
                                        int C, int N, float spatial_scale,
                                        float offset, int out_size, int sr,
                                        int dtype, void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const long long* b = static_cast<const long long*>(binds);
  float* g = static_cast<float*>(grad);
  if (dtype == 0) {
    return launch_scatter_body<float>(out_size, sr, grad_out, r, b, g, B, H,
                                      W, C, N, spatial_scale, offset, s);
  }
  if (dtype == 1) {
    return launch_scatter_body<__nv_bfloat16>(out_size, sr, grad_out, r, b,
                                              g, B, H, W, C, N,
                                              spatial_scale, offset, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
