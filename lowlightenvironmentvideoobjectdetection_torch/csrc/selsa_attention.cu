// SELSA attention for Hopper (sm_90a), head dim 64: one kernel, two entries.
//
// Replaces the TPU kernels of the JAX package's ops/fused_attention.py:
// - selsa_fused_attention_2slab_hm (_attn2_kernel), entry
//   llvod_selsa_attention_2slab: per stream s, head h and query n,
//     out[s, n, h] = softmax_j([q.k_memo[j] / 8 + b_memo[j], q.k_cur[j] / 8 + b_cur[j]])
//                    . [v_memo; v_cur]
//   one softmax over both slabs, without building their concatenation;
// - selsa_fused_attention_hm (_attn_kernel), entry llvod_selsa_attention_1slab:
//   the same attention over one slab, run as the M2 = 0 case of the kernel.
// S independent streams share one launch (the stream axis that jax.vmap adds
// to the TPU grid); S = 1 is the single-stream step.
//
// The bias is ADDED to every score and no key is skipped, so a query whose
// keys are all masked (bias -1e30) gets the uniform mean of V over the real
// keys, as the plain softmax does; only the ragged tail past M1 + M2 is left
// out. P stays in f32 (the TPU kernel casts it to V's dtype).
//
// What bounds it on the H100: arithmetic on the CUDA cores. At the main
// path's shapes (300 queries, 16 heads, 4200 + 300 keys) it does
// 2 x 300 x 4500 x 64 FMAs per head and stream and reads K/V once per query
// tile (9.2 MB in bf16 per stream, L2-resident), so bytes are small and the
// FMA rate decides. The design: grid = heads x query tiles of 32 x streams;
// one thread per query keeps q and its f32 accumulator in registers; each of
// the four warps of a block walks its own share of 16-key tiles (staged in
// shared memory as f32, read as warp-wide broadcasts) with an online softmax
// (running max and sum), and the four partial states are merged through
// shared memory at the end. The [N, M] score matrix never reaches device
// memory. Tensor cores (mma.sync / wgmma) are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kHd = 64;
constexpr int kWarps = 4;
constexpr int kQTile = 32;   // queries per block: one per lane
constexpr int kKTile = 16;   // keys per warp tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// q: [S, N, NB, 64]; k1/v1: [S, NB, M1, 64]; k2/v2: [S, NB, M2, 64];
// b1: [S, M1]; b2: [S, M2]; out: [S, N, NB, 64]. Slab 2 is never read when
// M2 = 0 (its pointers may be null).
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kWarps * 32)
selsa_attn_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k1,
                  const TKV* __restrict__ v1, const TKV* __restrict__ k2,
                  const TKV* __restrict__ v2, const float* __restrict__ b1,
                  const float* __restrict__ b2, float* __restrict__ out,
                  int N, int NB, int M1, int M2) {
  // per-warp K/V tiles; reused for the cross-warp merge at the end
  __shared__ __align__(16) float smem[kWarps * 2 * kKTile * kHd];
  __shared__ float sm_max[kWarps][kQTile];
  __shared__ float sm_sum[kWarps][kQTile];

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * kQTile;
  const size_t s = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qi = q0 + lane;
  const bool qvalid = qi < N;
  const int M = M1 + M2;
  const size_t qrow = s * N;  // first query row of this stream

  float qr[kHd];
  float acc[kHd];
  const float scale = 0.125f;  // 1 / sqrt(64)
#pragma unroll
  for (int d = 0; d < kHd; ++d) {
    qr[d] = qvalid ? to_f32(q[((qrow + qi) * NB + h) * kHd + d]) * scale
                   : 0.0f;
    acc[d] = 0.0f;
  }
  float m_run = -INFINITY;
  float l_run = 0.0f;

  float* ks = smem + warp * 2 * kKTile * kHd;
  float* vs = ks + kKTile * kHd;
  const size_t head1 = (s * NB + h) * M1 * kHd;
  const size_t head2 = (s * NB + h) * M2 * kHd;
  const float* bs1 = b1 + s * M1;
  const size_t bs2 = s * M2;  // offset into b2, which may be null
  const int ntiles = (M + kKTile - 1) / kKTile;

  for (int t = warp; t < ntiles; t += kWarps) {
    const int j0 = t * kKTile;
    // stage the tile: kKTile x kHd elements of K and of V, 32 per lane
    for (int e = lane; e < kKTile * kHd; e += 32) {
      const int j = j0 + e / kHd;
      const int d = e % kHd;
      float kv = 0.0f, vv = 0.0f;
      if (j < M1) {
        kv = to_f32(k1[head1 + static_cast<size_t>(j) * kHd + d]);
        vv = to_f32(v1[head1 + static_cast<size_t>(j) * kHd + d]);
      } else if (j < M) {
        kv = to_f32(k2[head2 + static_cast<size_t>(j - M1) * kHd + d]);
        vv = to_f32(v2[head2 + static_cast<size_t>(j - M1) * kHd + d]);
      }
      ks[e] = kv;
      vs[e] = vv;
    }
    __syncwarp();

    float sc[kKTile];
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kKTile; ++jj) {
      const int j = j0 + jj;
      const float4* kr = reinterpret_cast<const float4*>(ks + jj * kHd);
      float dot = 0.0f;
#pragma unroll
      for (int d4 = 0; d4 < kHd / 4; ++d4) {
        const float4 kk = kr[d4];
        dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
      }
      float sj = -INFINITY;  // past the end: not part of the key set
      if (j < M1) {
        sj = dot + bs1[j];
      } else if (j < M) {
        sj = dot + b2[bs2 + (j - M1)];
      }
      sc[jj] = sj;
      tmax = fmaxf(tmax, sj);
    }
    // every staged tile holds at least one real key, so tmax is finite
    const float m_new = fmaxf(m_run, tmax);
    const float corr = expf(m_run - m_new);
    l_run *= corr;
#pragma unroll
    for (int d = 0; d < kHd; ++d) acc[d] *= corr;
#pragma unroll
    for (int jj = 0; jj < kKTile; ++jj) {
      const float p = expf(sc[jj] - m_new);
      l_run += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + jj * kHd);
#pragma unroll
      for (int d4 = 0; d4 < kHd / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    m_run = m_new;
    __syncwarp();
  }

  // merge the kWarps partial states of each query
  sm_max[warp][lane] = m_run;
  sm_sum[warp][lane] = l_run;
  __syncthreads();  // all warps are done with their K/V tiles
  float* part = smem;  // [kWarps][kQTile][kHd]
#pragma unroll
  for (int d = 0; d < kHd; ++d) part[(warp * kQTile + lane) * kHd + d] = acc[d];
  __syncthreads();
  for (int e = threadIdx.x; e < kQTile * kHd; e += kWarps * 32) {
    const int ql = e / kHd;
    const int d = e % kHd;
    if (q0 + ql >= N) continue;
    float m = -INFINITY;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, sm_max[w][ql]);
    float l = 0.0f, o = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_max[w][ql] - m);  // 0 for a warp with no keys
      l += sm_sum[w][ql] * c;
      o += part[(w * kQTile + ql) * kHd + d] * c;
    }
    out[((qrow + q0 + ql) * NB + h) * kHd + d] = o / l;
  }
}

template <typename TQ, typename TKV>
void launch(const void* q, const void* k1, const void* v1, const void* k2,
            const void* v2, const float* b1, const float* b2, float* out,
            int S, int N, int NB, int M1, int M2, cudaStream_t st) {
  const dim3 grid(NB, (N + kQTile - 1) / kQTile, S);
  selsa_attn_kernel<TQ, TKV><<<grid, kWarps * 32, 0, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k1),
      static_cast<const TKV*>(v1), static_cast<const TKV*>(k2),
      static_cast<const TKV*>(v2), b1, b2, out, N, NB, M1, M2);
}

int dispatch(const void* q, const void* k1, const void* v1, const void* k2,
             const void* v2, const void* b1, const void* b2, void* out, int S,
             int N, int NB, int M1, int M2, int q_dtype, int kv_dtype,
             void* stream) {
  if (S == 0 || N == 0) return 0;
  if (S < 0 || S > 65535 || M1 < 0 || M2 < 0 || M1 + M2 <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  float* o = static_cast<float*>(out);
  if (q_dtype == 0 && kv_dtype == 0) {
    launch<float, float>(q, k1, v1, k2, v2, fb1, fb2, o, S, N, NB, M1, M2, st);
  } else if (q_dtype == 1 && kv_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(q, k1, v1, k2, v2, fb1, fb2, o, S, N,
                                         NB, M1, M2, st);
  } else if (q_dtype == 0 && kv_dtype == 1) {
    launch<float, __nv_bfloat16>(q, k1, v1, k2, v2, fb1, fb2, o, S, N, NB, M1,
                                 M2, st);
  } else if (q_dtype == 1 && kv_dtype == 0) {
    launch<__nv_bfloat16, float>(q, k1, v1, k2, v2, fb1, fb2, o, S, N, NB, M1,
                                 M2, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel A. q: [S, N, NB, 64]; k1/v1: [S, NB, M1, 64]; k2/v2: [S, NB, M2, 64];
// b1: [S, M1] and b2: [S, M2] f32; out: [S, N, NB, 64] f32. q_dtype /
// kv_dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch.
extern "C" int llvod_selsa_attention_2slab(
    const void* q, const void* k1, const void* v1, const void* k2,
    const void* v2, const void* b1, const void* b2, void* out, int S, int N,
    int NB, int M1, int M2, int q_dtype, int kv_dtype, void* stream) {
  return dispatch(q, k1, v1, k2, v2, b1, b2, out, S, N, NB, M1, M2, q_dtype,
                  kv_dtype, stream);
}

// Kernel C, the one-slab form. q: [S, N, NB, 64]; k/v: [S, NB, M, 64];
// b: [S, M] f32; out: [S, N, NB, 64] f32. Dtype codes and return as above.
extern "C" int llvod_selsa_attention_1slab(
    const void* q, const void* k, const void* v, const void* b, void* out,
    int S, int N, int NB, int M, int q_dtype, int kv_dtype, void* stream) {
  return dispatch(q, k, v, nullptr, nullptr, b, nullptr, out, S, N, NB, M, 0,
                  q_dtype, kv_dtype, stream);
}
