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
// Kernel D ("scatter" body, llvod_roi_align_backward) is the backward of
// kernel B with respect to the maps; no TPU kernel corresponds to it (the
// JAX package takes this gradient by autodiff of ops/roi_align.py). For
// grad_out [N, out, out, C] in the feature dtype, each sub-sample's four
// corners receive grad_out[bin] / sr^2 * w_y * w_x (in that order, as torch
// autograd through the plain version multiplies); out-of-range samples give
// nothing, and clamped corners that fall on one pixel both add, as the
// forward sums them. As mmcv's RoIAlign, there is no gradient for the rois.
//
// What bounds it on the H100: the atomic adds through L2, not HBM. At the
// training step's reference rois (2 maps of 38 x 64 x 512, 600 rois) it
// makes N * 49 * 16 * C = 2.4e8 f32 atomic adds (4.8e8 FLOPs, 7.2 us at
// 67 TFLOP/s) and must move 35.1 MB (grad_out 30.1 MB in bf16, the map
// gradient 5.0 MB written once, the rois): 10.5 us at 3.35 TB/s, the least
// time. Each warp's atomic instruction covers 32 consecutive f32 (128 bytes,
// four sectors), so the rate is set by how many sector atomics L2 retires,
// far below either bound.
//
// The design (simple and right first): one block per roi, threads over
// (output row, channel), so consecutive lanes add to consecutive channels;
// the roi's sample table in shared memory as in the forward, with the same
// __fmul_rn / __fadd_rn positions; each thread loads one grad_out element
// per bin and issues the 16 weighted atomic adds (skipping zero weights)
// into a zeroed f32 buffer that the wrapper allocates and, for bf16 maps,
// casts once at the end.

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

constexpr int kScatterThreads = 512;

template <typename T, int OUT, int SR>
__global__ void __launch_bounds__(kScatterThreads)
roi_align_scatter(const T* __restrict__ grad_out,
                  const float* __restrict__ rois,
                  const long long* __restrict__ binds,
                  float* __restrict__ grad, int B, int H, int W, int C,
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
  float* g = grad + static_cast<size_t>(b) * H * W * C;
  const T* go = grad_out + static_cast<size_t>(n) * OUT * OUT * C;
  __syncthreads();

  for (int it = threadIdx.x; it < OUT * C; it += blockDim.x) {
    const int p = it / C;
    const int c = it % C;
    Sample sy[SR];
#pragma unroll
    for (int k = 0; k < SR; ++k) sy[k] = ys[p * SR + k];
#pragma unroll 1
    for (int q = 0; q < OUT; ++q) {
      // the mean's 1 / sr^2 first, then the corner weight: the plain
      // version's product, bit for bit
      const float v = to_float(go[(p * OUT + q) * C + c]) *
                      (1.0f / static_cast<float>(SR * SR));
#pragma unroll
      for (int ky = 0; ky < SR; ++ky) {
#pragma unroll
        for (int kx = 0; kx < SR; ++kx) {
          const Sample sx = xs[q * SR + kx];
          const float w[4] = {sy[ky].w0 * sx.w0, sy[ky].w0 * sx.w1,
                              sy[ky].w1 * sx.w0, sy[ky].w1 * sx.w1};
          const int o[4] = {sy[ky].o0 + sx.o0, sy[ky].o0 + sx.o1,
                            sy[ky].o1 + sx.o0, sy[ky].o1 + sx.o1};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (w[k] != 0.0f) atomicAdd(g + o[k] + c, w[k] * v);
          }
        }
      }
    }
  }
}

template <typename T, int OUT, int SR>
int launch_scatter(const void* grad_out, const float* rois,
                   const long long* binds, float* grad, int B, int H, int W,
                   int C, int N, float spatial_scale, float offset,
                   cudaStream_t s) {
  const int threads = std::min(kScatterThreads, (OUT * C + 31) / 32 * 32);
  roi_align_scatter<T, OUT, SR><<<N, threads, 0, s>>>(
      static_cast<const T*>(grad_out), rois, binds, grad, B, H, W, C,
      spatial_scale, offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scatter_body(int out_size, int sr, const void* grad_out,
                        const float* rois, const long long* binds,
                        float* grad, int B, int H, int W, int C, int N,
                        float spatial_scale, float offset, cudaStream_t s) {
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
// or (14, 2). One thread block per roi. Returns cudaGetLastError() after the
// launch.
extern "C" int llvod_roi_align(const void* feat, const void* rois,
                               const void* binds, void* out, int B, int H,
                               int W, int C, int N, float spatial_scale,
                               float offset, int out_size, int sr, int dtype,
                               void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const long long* b = static_cast<const long long*>(binds);
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
// float32 [B, H, W, C] buffer that receives the maps' gradient. binds and
// (out_size, sr) as for llvod_roi_align. One thread block per roi. Returns
// cudaGetLastError() after the launch.
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
