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
// few operations per column element, far below the bytes' time, and the
// gathers of x's corners hit L1 and L2 (neighbouring pixels share corners).
//
// The design is the simple one: one thread per column entry for E and F,
// with the index decomposed so that neighbouring threads take neighbouring
// pixels (coalesced loads of the offsets and the mask, coalesced stores of
// the columns); F adds its four products with f32 atomics into a zeroed f32
// buffer that the wrapper casts once (kernel D's first scheme); G takes one
// thread per (image, group, tap, pixel) and loops over the group's channels,
// so the sums over channels need no atomics. Positions and the forward's
// products and sums round with __fadd_rn / __fsub_rn / __fmul_rn: nvcc would
// contract a + b * c into an FMA, and an ulp at an integer position moves
// floor, and with it the cell whose corners take the offsets' gradient.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTaps = 9;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The bilinear sample of tap k at output pixel (py, px): each corner's pixel
// offset in the map (0 outside), its weight (0 outside) and in-map flag, in
// the order (y0, x0), (y0, x1), (y1, x0), (y1, x1); and the fractional parts.
struct Sample {
  int o[4];
  float w[4];
  bool ok[4];
  float ly, lx;
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
  return s;
}

// One column entry's coordinates: i = ((n * C + c) * 9 + k) * HW + p.
struct Entry {
  long long n;
  int c, k, p;
};

__device__ __forceinline__ Entry entry_of(long long i, int C, int HW) {
  Entry e;
  e.p = static_cast<int>(i % HW);
  long long r = i / HW;
  e.k = static_cast<int>(r % kTaps);
  r /= kTaps;
  e.c = static_cast<int>(r % C);
  e.n = r / C;
  return e;
}

// Kernel E: one thread per column entry.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dcn_im2col_gather(const T* __restrict__ x,
                      const float* __restrict__ offset,
                      const float* __restrict__ mask,
                      float* __restrict__ cols, int C, int H, int W, int G,
                      long long total) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int HW = H * W;
  const Entry e = entry_of(i, C, HW);
  const long long og = e.n * G + e.c / (C / G);
  const float* off = offset + og * 2 * kTaps * HW;
  const float dy = off[e.k * HW + e.p];
  const float dx = off[(kTaps + e.k) * HW + e.p];
  const float m = mask[(og * kTaps + e.k) * HW + e.p];
  const Sample s = sample_at(dy, dx, e.p / W, e.p % W, e.k, H, W);
  const T* xc = x + (e.n * C + e.c) * HW;
  float val = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (s.ok[j]) val = __fadd_rn(val, __fmul_rn(to_float(xc[s.o[j]]), s.w[j]));
  }
  cols[i] = __fmul_rn(val, m);
}

// Kernel F: one thread per column entry adds grad_col * m * w into each
// in-map corner of x's gradient (f32 atomics; the result is unused, so they
// compile to reductions).
__global__ void __launch_bounds__(kThreads)
    dcn_col2im_scatter(const float* __restrict__ grad_cols,
                       const float* __restrict__ offset,
                       const float* __restrict__ mask, float* grad_x, int C,
                       int H, int W, int G, long long total) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int HW = H * W;
  const Entry e = entry_of(i, C, HW);
  const long long og = e.n * G + e.c / (C / G);
  const float* off = offset + og * 2 * kTaps * HW;
  const float dy = off[e.k * HW + e.p];
  const float dx = off[(kTaps + e.k) * HW + e.p];
  const float m = mask[(og * kTaps + e.k) * HW + e.p];
  const Sample s = sample_at(dy, dx, e.p / W, e.p % W, e.k, H, W);
  const float gm = __fmul_rn(grad_cols[i], m);
  float* gx = grad_x + (e.n * C + e.c) * HW;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (s.ok[j]) atomicAdd(gx + s.o[j], __fmul_rn(gm, s.w[j]));
  }
}

// Kernel G: one thread per (image, group, tap, pixel),
// i = ((n * G + g) * 9 + k) * HW + p, summing over the group's channels:
// the mask's gradient sum_c grad_col * S, and m times sum_c grad_col * dS/dly
// (dS/dlx) for dy (dx), S the in-map corners' bilinear sum.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dcn_col2im_coord(const float* __restrict__ grad_cols,
                     const T* __restrict__ x,
                     const float* __restrict__ offset,
                     const float* __restrict__ mask,
                     float* __restrict__ grad_offset,
                     float* __restrict__ grad_mask, int C, int H, int W, int G,
                     long long total) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int HW = H * W;
  const int p = static_cast<int>(i % HW);
  const long long r = i / HW;
  const int k = static_cast<int>(r % kTaps);
  const long long og = r / kTaps;  // n * G + g
  const long long n = og / G;
  const int g = static_cast<int>(og % G);
  const int cpg = C / G;
  const float* off = offset + og * 2 * kTaps * HW;
  const float dy = off[k * HW + p];
  const float dx = off[(kTaps + k) * HW + p];
  const float m = mask[(og * kTaps + k) * HW + p];
  const Sample s = sample_at(dy, dx, p / W, p % W, k, H, W);
  const float hy = 1.0f - s.ly, hx = 1.0f - s.lx;
  const long long c0 = n * C + static_cast<long long>(g) * cpg;
  const T* xg = x + c0 * HW;
  const float* gc = grad_cols + (c0 * kTaps + k) * HW + p;
  float g_mask = 0.0f, g_y = 0.0f, g_x = 0.0f;
  for (int j = 0; j < cpg; ++j) {
    const T* xc = xg + static_cast<long long>(j) * HW;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = s.ok[q] ? to_float(xc[s.o[q]]) : 0.0f;
    const float gcv = gc[static_cast<long long>(j) * kTaps * HW];
    const float val =
        v[0] * s.w[0] + v[1] * s.w[1] + v[2] * s.w[2] + v[3] * s.w[3];
    g_mask += gcv * val;
    g_y += gcv * (hx * (v[2] - v[0]) + s.lx * (v[3] - v[1]));
    g_x += gcv * (hy * (v[1] - v[0]) + s.ly * (v[3] - v[2]));
  }
  float* go = grad_offset + og * 2 * kTaps * HW;
  go[k * HW + p] = g_y * m;
  go[(kTaps + k) * HW + p] = g_x * m;
  grad_mask[(og * kTaps + k) * HW + p] = g_mask;
}

unsigned int blocks_for(long long total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

bool bad_shape(int N, int C, int H, int W, int G) {
  return N < 0 || C <= 0 || H <= 0 || W <= 0 || G <= 0 || C % G != 0;
}

}  // namespace

// Kernel E. dtype: 0 = float32, 1 = bfloat16 (x); offset, mask and cols
// float32, contiguous. Returns cudaGetLastError() after the launch.
extern "C" int llvod_dcn_im2col(const void* x, const void* offset,
                                const void* mask, void* cols, int N, int C,
                                int H, int W, int G, int dtype,
                                void* stream) {
  if (bad_shape(N, C, H, W, G)) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(N) * C * kTaps * H * W;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* o = static_cast<const float*>(offset);
  const float* m = static_cast<const float*>(mask);
  float* out = static_cast<float*>(cols);
  if (dtype == 0) {
    dcn_im2col_gather<float><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const float*>(x), o, m, out, C, H, W, G, total);
  } else if (dtype == 1) {
    dcn_im2col_gather<__nv_bfloat16><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), o, m, out, C, H, W, G, total);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel F. grad_cols, offset, mask float32; grad_x a zeroed float32
// [N, C, H, W] buffer that receives x's gradient. Returns cudaGetLastError()
// after the launch.
extern "C" int llvod_dcn_col2im(const void* grad_cols, const void* offset,
                                const void* mask, void* grad_x, int N, int C,
                                int H, int W, int G, void* stream) {
  if (bad_shape(N, C, H, W, G)) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(N) * C * kTaps * H * W;
  if (total == 0) return 0;
  dcn_col2im_scatter<<<blocks_for(total), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grad_cols), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<float*>(grad_x), C, H, W,
      G, total);
  return static_cast<int>(cudaGetLastError());
}

// Kernel G. dtype as for llvod_dcn_im2col (x); grad_offset [N, G * 18, H, W]
// and grad_mask [N, G * 9, H, W] float32, every element written. Returns
// cudaGetLastError() after the launch.
extern "C" int llvod_dcn_col2im_coord(const void* grad_cols, const void* x,
                                      const void* offset, const void* mask,
                                      void* grad_offset, void* grad_mask,
                                      int N, int C, int H, int W, int G,
                                      int dtype, void* stream) {
  if (bad_shape(N, C, H, W, G)) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(N) * G * kTaps * H * W;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gc = static_cast<const float*>(grad_cols);
  const float* o = static_cast<const float*>(offset);
  const float* m = static_cast<const float*>(mask);
  float* go = static_cast<float*>(grad_offset);
  float* gm = static_cast<float*>(grad_mask);
  if (dtype == 0) {
    dcn_col2im_coord<float><<<blocks_for(total), kThreads, 0, s>>>(
        gc, static_cast<const float*>(x), o, m, go, gm, C, H, W, G, total);
  } else if (dtype == 1) {
    dcn_col2im_coord<__nv_bfloat16><<<blocks_for(total), kThreads, 0, s>>>(
        gc, static_cast<const __nv_bfloat16*>(x), o, m, go, gm, C, H, W, G,
        total);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
