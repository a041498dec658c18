// SELSA attention for Hopper (sm_90a), head dim 64: two kernel bodies behind
// two entries.
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
// out (scored -inf). P keeps about 16 significant bits (the TPU kernel casts
// it to V's dtype).
//
// Bodies (the caller picks one; an entry never switches body on failure):
// - mma (bf16 q and bf16 K/V, the default config's path): FlashAttention-2
//   in form on the tensor cores. Grid = query tiles of 64 x heads x streams;
//   four warps of 16 query rows each. q / 8 (exact in bf16) is held as
//   mma A-fragments in registers; 64-key K/V tiles (both slabs, addressed
//   per key row, zero-filled past the end) stream through a 2-stage
//   cp.async ring in shared memory shared by all four warps, rows padded to
//   144 bytes so that ldmatrix is free of bank conflicts. S = Q.K^T by
//   mma.sync m16n8k16 (bf16 products are exact in f32), the bias added in
//   f32, an online softmax per row in registers (exp2f of (s - max) * log2e,
//   quad shuffles for the row max), and P.V with P split into
//   bf16(P) + bf16(P - bf16(P)), two mma per k-step against V from
//   ldmatrix.trans, so P keeps about 16 bits and the result stays within
//   1e-5 of the f32 plain version.
// - fma (f32 q or K/V, and mixed dtypes): the CUDA-core body. Grid = heads x
//   query tiles of 32 x streams; one thread per query keeps q and an f32
//   accumulator in registers; each of four warps walks its own share of
//   16-key tiles (staged in shared memory as f32) with an online softmax,
//   and the four partial states are merged through shared memory.
// Both bodies walk keys in the order of the concatenated index, so the
// one-slab entry on the concatenated keys equals the two-slab entry exactly.
//
// What bounds it on the H100: at the main path's shapes (300 queries, 16
// heads, 4200 + 300 keys, bf16) a stream reads 18.4 MB of K/V
// (2 x 16 x 4500 x 64 x 2 B) plus q, bias and the f32 output: 20.3 MB, 6.06
// us at 3.35 TB/s; the function is 5.53 GFLOP (5.6 us at the bf16 tensor
// rate), 8.3 GFLOP with the P split. So the mma body is bound by bytes and
// by the tensor cores alike, and the exponentials (21.6 M per stream) sit
// under both; each K/V tile crosses from L2 once per 64 queries. The fma
// body is bound by the FMA issue rate of the CUDA cores. The [N, M] score
// matrix never reaches device memory in either body.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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
void launch_fma(const void* q, const void* k1, const void* v1, const void* k2,
                const void* v2, const float* b1, const float* b2, float* out,
                int S, int N, int NB, int M1, int M2, cudaStream_t st) {
  const dim3 grid(NB, (N + kQTile - 1) / kQTile, S);
  selsa_attn_kernel<TQ, TKV><<<grid, kWarps * 32, 0, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k1),
      static_cast<const TKV*>(v1), static_cast<const TKV*>(k2),
      static_cast<const TKV*>(v2), b1, b2, out, N, NB, M1, M2);
}

// ---- the mma body (bf16 q and K/V) ---------------------------------------

constexpr int kMmaQRows = 64;      // queries per block: 16 per warp
constexpr int kMmaKeys = 64;       // keys per K/V tile
constexpr int kLd = kHd + 8;       // smem row in bf16: 144 B, 16 B aligned
constexpr int kStages = 2;         // cp.async ring depth
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; src_bytes = 0 zero-fills the
// destination without reading the source
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b for one m16n8k16 tile, bf16 operands, f32 accumulator
// (registers only, so not volatile: the compiler may interleave them)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) -> hi = bf16(x, y) and lo = bf16(x - hi, y - hi): hi + lo keeps
// about 16 significant bits (x - hi is exact in f32)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// two bf16 of q / 8 (exact: a power of two), or zeros past the last query
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* row, bool ok,
                                           int d) {
  if (!ok) return 0u;
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(row + d);
  const float2 f = __bfloat1622float2(x);
  return bf16x2_bits(__floats2bfloat162_rn(f.x * 0.125f, f.y * 0.125f));
}

// Shapes as selsa_attn_kernel. Fragment layouts of mma m16n8k16 (g = lane
// / 4, t = lane % 4): an accumulator holds rows g and g + 8 at columns
// 2t, 2t + 1; the A operand of a k-step holds rows g, g + 8 at columns
// 2t, 2t + 1 (registers 0, 1) and 2t + 8, 2t + 9 (registers 2, 3). So the
// score accumulators of keys 16kk .. 16kk + 15 are the A operand of P.V's
// k-step kk without leaving registers.
__global__ void __launch_bounds__(kWarps * 32)
selsa_attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k1,
                      const __nv_bfloat16* __restrict__ v1,
                      const __nv_bfloat16* __restrict__ k2,
                      const __nv_bfloat16* __restrict__ v2,
                      const float* __restrict__ b1,
                      const float* __restrict__ b2, float* __restrict__ out,
                      int N, int NB, int M1, int M2) {
  __shared__ __align__(128) __nv_bfloat16 ks[kStages][kMmaKeys * kLd];
  __shared__ __align__(128) __nv_bfloat16 vs[kStages][kMmaKeys * kLd];
  __shared__ __align__(16) float bsm[kStages][kMmaKeys];

  const int q0 = blockIdx.x * kMmaQRows;
  const int h = blockIdx.y;
  const size_t s = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int M = M1 + M2;

  // this (stream, head)'s slabs; slab 2 is addressed only when M2 > 0
  const __nv_bfloat16* k1h = k1 + (s * NB + h) * M1 * kHd;
  const __nv_bfloat16* v1h = v1 + (s * NB + h) * M1 * kHd;
  const __nv_bfloat16* k2h = M2 > 0 ? k2 + (s * NB + h) * M2 * kHd : k1h;
  const __nv_bfloat16* v2h = M2 > 0 ? v2 + (s * NB + h) * M2 * kHd : v1h;
  const float* bs1 = b1 + s * M1;
  const float* bs2 = M2 > 0 ? b2 + s * M2 : bs1;
  // a mapped address for zero-filling copies, which read nothing
  const __nv_bfloat16* kdummy = M1 > 0 ? k1h : k2h;
  const float* bdummy = M1 > 0 ? bs1 : bs2;

  // K/V rows j0 .. j0 + 63 of the concatenated index and their biases into
  // stage st; rows past M are zeros (scored -inf below)
  auto load_tile = [&](int j0, int st) {
#pragma unroll
    for (int c = tid; c < kMmaKeys * 8; c += kWarps * 32) {
      const int r = c / 8;
      const int ch = (c % 8) * 8;
      const int j = j0 + r;
      const __nv_bfloat16* kp = kdummy;
      const __nv_bfloat16* vp = kdummy;
      int bytes = 0;
      if (j < M1) {
        kp = k1h + static_cast<size_t>(j) * kHd + ch;
        vp = v1h + static_cast<size_t>(j) * kHd + ch;
        bytes = 16;
      } else if (j < M) {
        kp = k2h + static_cast<size_t>(j - M1) * kHd + ch;
        vp = v2h + static_cast<size_t>(j - M1) * kHd + ch;
        bytes = 16;
      }
      cp_async16(smem_addr(&ks[st][r * kLd + ch]), kp, bytes);
      cp_async16(smem_addr(&vs[st][r * kLd + ch]), vp, bytes);
    }
    if (tid < kMmaKeys) {
      const int j = j0 + tid;
      const float* bp = bdummy;
      int bytes = 0;
      if (j < M1) {
        bp = bs1 + j;
        bytes = 4;
      } else if (j < M) {
        bp = bs2 + (j - M1);
        bytes = 4;
      }
      cp_async4(smem_addr(&bsm[st][tid]), bp, bytes);
    }
  };

  const int ntiles = (M + kMmaKeys - 1) / kMmaKeys;
  load_tile(0, 0);
  cp_async_commit();

  // q / 8 as A fragments of the four 16-dim k-steps: qa[kstep][reg]
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const __nv_bfloat16* qs = q + (s * N * NB + h) * kHd;
  const __nv_bfloat16* qr0 = qs + static_cast<size_t>(row0) * NB * kHd;
  const __nv_bfloat16* qr1 = qs + static_cast<size_t>(row1) * NB * kHd;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = kk * 16 + half * 8 + 2 * t4;
      qa[kk][2 * half] = q_pair(qr0, row0 < N, d);
      qa[kk][2 * half + 1] = q_pair(qr1, row1 < N, d);
    }
  }
  // a warp whose 16 rows are all past N loads and syncs but computes nothing
  const bool live = q0 + warp * 16 < N;

  float o[8][4];  // [dim n-tile][accumulator]: rows g, g+8 x 64 dims
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g, g + 8
  float l_run[2] = {0.0f, 0.0f};            // this thread's share of the sum

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % kStages;
    if (t + 1 < ntiles) load_tile((t + 1) * kMmaKeys, (t + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed (tile t + 1 may be in flight)
    __syncthreads();
    if (live) {
      const __nv_bfloat16* kt = ks[st];
      const __nv_bfloat16* vt = vs[st];
      // scores of 64 keys: sc[key n-tile][accumulator]
      float sc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
        // B operand (K^T): matrix i of each x4 = keys 8n .. 8n + 7, dims
        // 8i .. 8i + 7 (then 32 + 8i ...); lane gives row lane % 8 of
        // matrix lane / 8
        const __nv_bfloat16* krow = kt + (n * 8 + lane % 8) * kLd + (lane / 8) * 8;
        uint32_t blo[4], bhi[4];
        ldmatrix_x4(smem_addr(krow), blo);
        ldmatrix_x4(smem_addr(krow + 32), bhi);
        mma_bf16(sc[n], qa[0], blo[0], blo[1]);
        mma_bf16(sc[n], qa[1], blo[2], blo[3]);
        mma_bf16(sc[n], qa[2], bhi[0], bhi[1]);
        mma_bf16(sc[n], qa[3], bhi[2], bhi[3]);
      }
      // bias (f32, after the product), the ragged tail at -inf, row max
      const int jt = t * kMmaKeys;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t4 + (e % 2);
          const float x = jt + col < M ? sc[n][e] + bsm[st][col] : -INFINITY;
          sc[n][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      }
      // every tile holds a real key, so the new max is finite; after an
      // all-masked tile (-1e30) a live one gives corr = 0
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);
        corr[i] = exp2f((m_run[i] - m_new) * kLog2e);
        m_run[i] = m_new;
        l_run[i] *= corr[i];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[n][e] *= corr[e / 2];
          const float p = exp2f((sc[n][e] - m_run[e / 2]) * kLog2e);
          sc[n][e] = p;
          l_run[e / 2] += p;
        }
      }
      // P.V: k-step kk covers keys 16kk .. 16kk + 15 = score n-tiles 2kk,
      // 2kk + 1; P as hi + lo, two mma each
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ahi[4], alo[4];
        split_bf16(sc[2 * kk][0], sc[2 * kk][1], ahi[0], alo[0]);
        split_bf16(sc[2 * kk][2], sc[2 * kk][3], ahi[1], alo[1]);
        split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ahi[2], alo[2]);
        split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ahi[3], alo[3]);
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          // B operand (V, transposed on load): matrix i = keys
          // 16kk + 8 (i % 2) .., dims 16dp + 8 (i / 2) ..
          const int m = lane / 8;
          const __nv_bfloat16* vrow =
              vt + (kk * 16 + (m % 2) * 8 + lane % 8) * kLd + dp * 16 + (m / 2) * 8;
          uint32_t b[4];
          ldmatrix_x4_trans(smem_addr(vrow), b);
          mma_bf16(o[2 * dp], ahi, b[0], b[1]);
          mma_bf16(o[2 * dp], alo, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], ahi, b[2], b[3]);
          mma_bf16(o[2 * dp + 1], alo, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // stage st is free for the load of tile t + 2
  }
  cp_async_wait<0>();
  if (!live) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  float* o0 = out + ((s * N + row0) * NB + h) * kHd + 2 * t4;
  float* o1 = out + ((s * N + row1) * NB + h) * kHd + 2 * t4;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (row0 < N) {
      *reinterpret_cast<float2*>(o0 + n * 8) =
          make_float2(o[n][0] / l_run[0], o[n][1] / l_run[0]);
    }
    if (row1 < N) {
      *reinterpret_cast<float2*>(o1 + n * 8) =
          make_float2(o[n][2] / l_run[1], o[n][3] / l_run[1]);
    }
  }
}

void launch_mma(const void* q, const void* k1, const void* v1, const void* k2,
                const void* v2, const float* b1, const float* b2, float* out,
                int S, int N, int NB, int M1, int M2, cudaStream_t st) {
  const dim3 grid((N + kMmaQRows - 1) / kMmaQRows, NB, S);
  using bf = __nv_bfloat16;
  selsa_attn_mma_kernel<<<grid, kWarps * 32, 0, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k1),
      static_cast<const bf*>(v1), static_cast<const bf*>(k2),
      static_cast<const bf*>(v2), b1, b2, out, N, NB, M1, M2);
}

// body: 0 = fma (an f32 q or K/V), 1 = mma (bf16 q and K/V)
int dispatch(const void* q, const void* k1, const void* v1, const void* k2,
             const void* v2, const void* b1, const void* b2, void* out, int S,
             int N, int NB, int M1, int M2, int q_dtype, int kv_dtype,
             int body, void* stream) {
  if (S == 0 || N == 0) return 0;
  if (S < 0 || S > 65535 || NB <= 0 || NB > 65535 || M1 < 0 || M2 < 0 ||
      M1 + M2 <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  float* o = static_cast<float*>(out);
  if (body == 1) {
    if (q_dtype != 1 || kv_dtype != 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    launch_mma(q, k1, v1, k2, v2, fb1, fb2, o, S, N, NB, M1, M2, st);
  } else if (body != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (q_dtype == 0 && kv_dtype == 0) {
    launch_fma<float, float>(q, k1, v1, k2, v2, fb1, fb2, o, S, N, NB, M1, M2,
                             st);
  } else if (q_dtype == 0 && kv_dtype == 1) {
    launch_fma<float, __nv_bfloat16>(q, k1, v1, k2, v2, fb1, fb2, o, S, N, NB,
                                     M1, M2, st);
  } else if (q_dtype == 1 && kv_dtype == 0) {
    launch_fma<__nv_bfloat16, float>(q, k1, v1, k2, v2, fb1, fb2, o, S, N, NB,
                                     M1, M2, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel A. q: [S, N, NB, 64]; k1/v1: [S, NB, M1, 64]; k2/v2: [S, NB, M2, 64];
// b1: [S, M1] and b2: [S, M2] f32; out: [S, N, NB, 64] f32. q_dtype /
// kv_dtype: 0 = float32, 1 = bfloat16. body: 0 = fma (an f32 q or K/V),
// 1 = mma (bf16 q and K/V, rows 16-byte aligned). Returns cudaGetLastError()
// after the launch.
extern "C" int llvod_selsa_attention_2slab(
    const void* q, const void* k1, const void* v1, const void* k2,
    const void* v2, const void* b1, const void* b2, void* out, int S, int N,
    int NB, int M1, int M2, int q_dtype, int kv_dtype, int body,
    void* stream) {
  return dispatch(q, k1, v1, k2, v2, b1, b2, out, S, N, NB, M1, M2, q_dtype,
                  kv_dtype, body, stream);
}

// Kernel C, the one-slab form. q: [S, N, NB, 64]; k/v: [S, NB, M, 64];
// b: [S, M] f32; out: [S, N, NB, 64] f32. Dtype and body codes and return
// as above.
extern "C" int llvod_selsa_attention_1slab(
    const void* q, const void* k, const void* v, const void* b, void* out,
    int S, int N, int NB, int M, int q_dtype, int kv_dtype, int body,
    void* stream) {
  return dispatch(q, k, v, nullptr, nullptr, b, nullptr, out, S, N, NB, M, 0,
                  q_dtype, kv_dtype, body, stream);
}
