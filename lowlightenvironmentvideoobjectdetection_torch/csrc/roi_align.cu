// RoIAlign (avg mode, aligned) over NHWC feature maps, for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/roi_align_pallas.py::roi_align_pallas
// (_kernel) of the JAX package, and serves the batched gather form
// ops/roi_align.py::roi_align as well: one entry takes B maps and a per-roi
// map index.
//
// Semantics (ops/roi_align.py:24-45 of the JAX package): sample positions
// y = y1 + (p + (s + 0.5) / sr) * roi_h / out, samples below -1 or above the
// size contribute zero, the position is clamped to [0, size - 1], the high
// corner is clamped to size - 1, and the bin value is the mean over the
// sr x sr sub-samples. All of it in f32; the output has the feature dtype.
//
// What bounds it on the H100: bytes. Each of the 49 x 4 samples reads four
// C-wide rows of the map (about 400 KB of gathers per roi at C = 512 in
// bf16, mostly L2 hits: a 38 x 64 x 512 bf16 map is 2.5 MB and stays in the
// 50 MB L2) and does 4 FMAs per element read. The design: one block per
// (roi, channel chunk), threads along C so every corner read is one
// coalesced row segment, and the per-axis sample table (indices and weights)
// computed once per block into shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxPts = 64;  // out_size * sampling_ratio per axis

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// One axis of the sample table: corner indices and bilinear weights of
// sample i (bin i / sr, sub-sample i % sr), zero weights when out of range.
__device__ __forceinline__ void axis_sample(float lo_coord, float bin, int i,
                                            int sr, int size, int* c0, int* c1,
                                            float* w0, float* w1) {
  const int p = i / sr;
  const int s = i % sr;
  const float sub = (static_cast<float>(s) + 0.5f) / static_cast<float>(sr);
  // _rn: no FMA contraction, so positions round as in the plain version
  const float x = __fadd_rn(lo_coord, __fmul_rn(static_cast<float>(p) + sub, bin));
  const bool oob = (x < -1.0f) || (x > static_cast<float>(size));
  const float xc = fminf(fmaxf(x, 0.0f), static_cast<float>(size) - 1.0f);
  const float f0 = floorf(xc);
  const float f1 = fminf(f0 + 1.0f, static_cast<float>(size) - 1.0f);
  const float l = xc - f0;
  *c0 = static_cast<int>(f0);
  *c1 = static_cast<int>(f1);
  *w0 = oob ? 0.0f : 1.0f - l;
  *w1 = oob ? 0.0f : l;
}

template <typename T>
__global__ void roi_align_kernel(const T* __restrict__ feat,
                                 const float* __restrict__ rois,
                                 const int* __restrict__ binds,
                                 T* __restrict__ out, int B, int H, int W,
                                 int C, float spatial_scale, float offset,
                                 int out_size, int sr) {
  __shared__ int ys0[kMaxPts], ys1[kMaxPts], xs0[kMaxPts], xs1[kMaxPts];
  __shared__ float wy0[kMaxPts], wy1[kMaxPts], wx0[kMaxPts], wx1[kMaxPts];

  const int n = blockIdx.x;
  const int npts = out_size * sr;
  const float* r = rois + 4 * n;
  const float x1 = __fsub_rn(__fmul_rn(r[0], spatial_scale), offset);
  const float y1 = __fsub_rn(__fmul_rn(r[1], spatial_scale), offset);
  const float x2 = __fsub_rn(__fmul_rn(r[2], spatial_scale), offset);
  const float y2 = __fsub_rn(__fmul_rn(r[3], spatial_scale), offset);
  const float bin_w = (x2 - x1) / static_cast<float>(out_size);
  const float bin_h = (y2 - y1) / static_cast<float>(out_size);
  for (int i = threadIdx.x; i < 2 * npts; i += blockDim.x) {
    if (i < npts) {
      axis_sample(y1, bin_h, i, sr, H, &ys0[i], &ys1[i], &wy0[i], &wy1[i]);
    } else {
      const int j = i - npts;
      axis_sample(x1, bin_w, j, sr, W, &xs0[j], &xs1[j], &wx0[j], &wx1[j]);
    }
  }
  __syncthreads();

  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  int b = binds ? binds[n] : 0;
  b = min(max(b, 0), B - 1);
  const T* f = feat + static_cast<size_t>(b) * H * W * C + c;
  const float inv = 1.0f / static_cast<float>(sr * sr);
  T* o = out + static_cast<size_t>(n) * out_size * out_size * C + c;

  for (int p = 0; p < out_size; ++p) {
    for (int q = 0; q < out_size; ++q) {
      float acc = 0.0f;
      for (int sy = 0; sy < sr; ++sy) {
        const int iy = p * sr + sy;
        const size_t r0 = static_cast<size_t>(ys0[iy]) * W;
        const size_t r1 = static_cast<size_t>(ys1[iy]) * W;
        const float hy = wy0[iy], ly = wy1[iy];
        for (int sx = 0; sx < sr; ++sx) {
          const int ix = q * sr + sx;
          const float hx = wx0[ix], lx = wx1[ix];
          const size_t c0 = xs0[ix], c1 = xs1[ix];
          acc += hy * hx * to_f32(f[(r0 + c0) * C]) +
                 hy * lx * to_f32(f[(r0 + c1) * C]) +
                 ly * hx * to_f32(f[(r1 + c0) * C]) +
                 ly * lx * to_f32(f[(r1 + c1) * C]);
        }
      }
      store(o + static_cast<size_t>(p * out_size + q) * C, acc * inv);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (features and output). binds may be null
// (every roi reads map 0). Returns cudaGetLastError() after the launch.
extern "C" int llvod_roi_align(const void* feat, const void* rois,
                               const void* binds, void* out, int B, int H,
                               int W, int C, int N, float spatial_scale,
                               float offset, int out_size, int sr, int dtype,
                               void* stream) {
  if (N == 0) return 0;
  if (out_size * sr > kMaxPts) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = C >= 128 ? 128 : ((C + 31) / 32) * 32;
  const dim3 grid(N, (C + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const int* bi = static_cast<const int*>(binds);
  if (dtype == 0) {
    roi_align_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(feat), r, bi, static_cast<float*>(out), B, H,
        W, C, spatial_scale, offset, out_size, sr);
  } else if (dtype == 1) {
    roi_align_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feat), r, bi,
        static_cast<__nv_bfloat16*>(out), B, H, W, C, spatial_scale, offset,
        out_size, sr);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
