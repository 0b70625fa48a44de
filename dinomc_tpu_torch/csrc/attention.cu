// Fused multi-head attention, forward (K1) and backward (K2), for sm_90a.
//
// Replaces: dinomc_tpu/ops/pallas/attention.py, `_fused_attention`
// (`_fwd_kernel`) and `_fused_bwd` (`_bwd_kernel`).
//
// What it computes: softmax(Q K^T * scale) V per (batch, head), read in
// place from the (B, N, h, d) views of the ViT's qkv tensor. Key c is live
// for query r iff c < N and, when boundary > 0 (two crops packed into one
// sequence), (c < boundary) == (r < boundary). The backward recomputes P
// from q, k and the per-row log-sum-exp saved by the forward.
//
// What bounds it on this card: the tensor-core work is 4*N^2*d flops per
// (batch, head) forward and ~10*N^2*d backward, against only 4*N*d bf16
// values of traffic, so at N = 785 it is compute- and latency-bound. The
// TPU kernel kept the whole (N, N) f32 score matrix in 16 MB of VMEM; a
// 785x785 f32 tile is 2.4 MB and does not fit in 227 KB of shared memory.
//
// Design: flash-style tiling. A block owns 64 query rows (4 warps x 16)
// and walks 64-key tiles with an online softmax, keeping only per-warp
// 16x64 score tiles in shared memory; products run on the tensor cores
// through WMMA bf16 16x16x16 fragments with f32 accumulators. Key tiles
// that lie wholly in the other packed crop are skipped, not masked. There
// is no padding to 128 and no lane padding: rows past N load as zeros and
// are masked. The backward is deterministic, with no atomics: a prepass
// computes delta = rowsum(dO * O); a dQ kernel owns query tiles and loops
// over key tiles; a dK/dV kernel owns key tiles and loops over query tiles.
// wgmma, TMA and pipelining are later work; this version is the simple one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;         // query rows per tile
constexpr int BN = 64;         // key rows per tile
constexpr int NWARPS = 4;      // each warp owns 16 rows of the block's tile
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = BN + 4;    // f32 score tile pitch (multiple of 4 for WMMA)
constexpr int LDP = BN + 8;    // bf16 probability tile pitch (multiple of 8)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D> struct Pitch {
  static constexpr int T = D + 8;   // bf16 q/k/v/dO tile pitch
  static constexpr int O = D + 4;   // f32 output accumulator pitch
};

__device__ __forceinline__ bool key_live(int r, int c, int N, int boundary) {
  return c < N && (boundary == 0 || ((c < boundary) == (r < boundary)));
}

// Index range [lo, hi) of the other axis that rows [r0, r1) can attend to.
__device__ __forceinline__ void live_range(int r0, int r1, int N, int boundary,
                                           int& lo, int& hi) {
  lo = 0;
  hi = N;
  if (boundary > 0) {
    if (r1 <= boundary) hi = boundary;
    else if (r0 >= boundary) lo = boundary;
  }
}

// Copy rows [row0, row0 + 64) of one (batch, head) slice into shared memory
// with pitch ld; rows at or past N load as zeros. 16-byte vector loads: the
// wrapper checks that pointers and strides are multiples of 8 elements.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long sn, int row0, int N) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < N)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * sn + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// out (16 x 64, f32, pitch LDS) = A (16 x D, fragments) * B^T, where B is a
// 64 x D row-major tile (pitch ldb): the score-like products Q K^T, dO V^T.
template <int D>
__device__ __forceinline__ void mm_abt(float* out, const FragA* a, const bf16* b, int ldb) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kt = 0; kt < D / 16; ++kt) {
      FragBCol bf;
      wmma::load_matrix_sync(bf, b + nt * 16 * ldb + kt * 16, ldb);
      wmma::mma_sync(acc, a[kt], bf, acc);
    }
    wmma::store_matrix_sync(out + nt * 16, acc, LDS, wmma::mem_row_major);
  }
}

// acc[D/16] (16 x D) += A (16 x 64 bf16, pitch LDP) * B (64 x D row-major, pitch ldb).
template <int D>
__device__ __forceinline__ void mm_ab_acc(FragC* acc, const bf16* a, const bf16* b, int ldb) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    FragA af;
    wmma::load_matrix_sync(af, a + kt * 16, LDP);
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      FragBRow bf;
      wmma::load_matrix_sync(bf, b + kt * 16 * ldb + dt * 16, ldb);
      wmma::mma_sync(acc[dt], af, bf, acc[dt]);
    }
  }
}

// ----------------------------------------------------------------------------
// K1: forward
// ----------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NTHREADS)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                float* __restrict__ lse, int N, int H, long long sb,
                long long sn, long long sh, float scale_log2, int boundary) {
  constexpr int LDT = Pitch<D>::T, LDO = Pitch<D>::O;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BM * LDT;
  bf16* Vs = Ks + BN * LDT;
  float* Ss = reinterpret_cast<float*>(Vs + BN * LDT);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BM * LDS);
  float* Os = reinterpret_cast<float*>(Ps + BM * LDP);

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * BM;
  const long long base = (long long)b * sb + (long long)h * sh;

  load_tile<D>(Qs, LDT, q + base, sn, r0, N);
  for (int i = threadIdx.x; i < BM * LDO; i += NTHREADS) Os[i] = 0.f;
  __syncthreads();

  FragA qf[D / 16];
#pragma unroll
  for (int kt = 0; kt < D / 16; ++kt)
    wmma::load_matrix_sync(qf[kt], Qs + warp * 16 * LDT + kt * 16, LDT);

  // Two lanes per query row; lane parity picks the even or odd columns.
  const int row = warp * 16 + lane / 2, half = lane & 1;
  const int grow = r0 + row;
  float m_i = -INFINITY, l_i = 0.f;

  int lo, hi;
  live_range(r0, min(r0 + BM, N), N, boundary, lo, hi);
  for (int c0 = (lo / BN) * BN; c0 < hi; c0 += BN) {
    __syncthreads();
    load_tile<D>(Ks, LDT, k + base, sn, c0, N);
    load_tile<D>(Vs, LDT, v + base, sn, c0, N);
    __syncthreads();

    mm_abt<D>(Ss + warp * 16 * LDS, qf, Ks, LDT);
    __syncwarp();

    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * j + half;
      const float s = key_live(grow, c0 + c, N, boundary)
                          ? Ss[row * LDS + c] * scale_log2 : -INFINITY;
      sv[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
    const float alpha = exp2f(m_i - m_use);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = exp2f(sv[j] - m_use);
      Ps[row * LDP + 2 * j + half] = __float2bfloat16(p);
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_i = l_i * alpha + psum;
    m_i = m_new;
    for (int j = half; j < D; j += 2) Os[row * LDO + j] *= alpha;
    __syncwarp();

    FragC acc[D / 16];
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt)
      wmma::load_matrix_sync(acc[dt], Os + warp * 16 * LDO + dt * 16, LDO,
                             wmma::mem_row_major);
    mm_ab_acc<D>(acc, Ps + warp * 16 * LDP, Vs, LDT);
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt)
      wmma::store_matrix_sync(Os + warp * 16 * LDO + dt * 16, acc[dt], LDO,
                              wmma::mem_row_major);
    __syncwarp();
  }

  if (grow < N) {
    // every live row attends at least to itself, so l_i > 0
    const float inv = 1.f / l_i;
    bf16* og = o + (((long long)b * N + grow) * H + h) * D;
    for (int j = half; j < D; j += 2) og[j] = __float2bfloat16(Os[row * LDO + j] * inv);
    if (half == 0) lse[((long long)b * H + h) * N + grow] = (m_i + log2f(l_i)) * LN2;
  }
}

// ----------------------------------------------------------------------------
// K2: backward
// ----------------------------------------------------------------------------

// delta[b, h, n] = sum_d dO[b, n, h, d] * O[b, n, h, d]; one warp per row.
template <int D>
__global__ void attn_bwd_delta_kernel(const bf16* __restrict__ o,
                                      const bf16* __restrict__ dout,
                                      float* __restrict__ delta, int N, int H,
                                      long long rows) {
  const long long gw = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (gw >= rows) return;
  float s = 0.f;
  for (int j = lane; j < D; j += 32)
    s += __bfloat162float(o[gw * D + j]) * __bfloat162float(dout[gw * D + j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const long long b = gw / ((long long)N * H);
    const int n = (int)((gw / H) % N), h = (int)(gw % H);
    delta[(b * H + h) * N + n] = s;
  }
}

// dQ = dS K with dS = P * (dP - delta) * scale, dP = dO V^T; one block per
// 64-row query tile, looping over key tiles.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int N, int H, long long sb,
                   long long sn, long long sh, float scale, float scale_log2,
                   int boundary) {
  constexpr int LDT = Pitch<D>::T;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BM * LDT;
  bf16* Ks = dOs + BM * LDT;
  bf16* Vs = Ks + BN * LDT;
  float* Ss = reinterpret_cast<float*>(Vs + BN * LDT);
  float* dPs = Ss + BM * LDS;
  bf16* dSs = reinterpret_cast<bf16*>(dPs + BM * LDS);

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * BM;
  const long long base = (long long)b * sb + (long long)h * sh;
  const long long dbase = (long long)b * N * H * D + (long long)h * D;

  load_tile<D>(Qs, LDT, q + base, sn, r0, N);
  load_tile<D>(dOs, LDT, dout + dbase, (long long)H * D, r0, N);
  __syncthreads();

  FragA qf[D / 16], dof[D / 16];
  FragC dqf[D / 16];
#pragma unroll
  for (int kt = 0; kt < D / 16; ++kt) {
    wmma::load_matrix_sync(qf[kt], Qs + warp * 16 * LDT + kt * 16, LDT);
    wmma::load_matrix_sync(dof[kt], dOs + warp * 16 * LDT + kt * 16, LDT);
    wmma::fill_fragment(dqf[kt], 0.f);
  }

  const int row = warp * 16 + lane / 2, half = lane & 1;
  const int grow = r0 + row;
  const long long rix = ((long long)b * H + h) * N + grow;
  const float lse_r = grow < N ? lse[rix] * LOG2E : 0.f;
  const float delta_r = grow < N ? delta[rix] : 0.f;

  int lo, hi;
  live_range(r0, min(r0 + BM, N), N, boundary, lo, hi);
  for (int c0 = (lo / BN) * BN; c0 < hi; c0 += BN) {
    __syncthreads();
    load_tile<D>(Ks, LDT, k + base, sn, c0, N);
    load_tile<D>(Vs, LDT, v + base, sn, c0, N);
    __syncthreads();

    mm_abt<D>(Ss + warp * 16 * LDS, qf, Ks, LDT);
    mm_abt<D>(dPs + warp * 16 * LDS, dof, Vs, LDT);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * j + half;
      const bool live = grow < N && key_live(grow, c0 + c, N, boundary);
      const float p = live ? exp2f(Ss[row * LDS + c] * scale_log2 - lse_r) : 0.f;
      dSs[row * LDP + c] = __float2bfloat16(p * (dPs[row * LDS + c] - delta_r) * scale);
    }
    __syncwarp();
    mm_ab_acc<D>(dqf, dSs + warp * 16 * LDP, Ks, LDT);
  }

  __syncwarp();
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt)
    wmma::store_matrix_sync(Ss + warp * 16 * LDS + dt * 16, dqf[dt], LDS,
                            wmma::mem_row_major);
  __syncwarp();
  if (grow < N) {
    bf16* out = dq + dbase + (long long)grow * H * D;
    for (int j = half; j < D; j += 2) out[j] = __float2bfloat16(Ss[row * LDS + j]);
  }
}

// dV = P^T dO and dK = dS^T Q; one block per 64-key tile, looping over the
// query tiles that can see it. Transposed products keep keys as rows.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
attn_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int H,
                    long long sb, long long sn, long long sh, float scale,
                    float scale_log2, int boundary) {
  constexpr int LDT = Pitch<D>::T;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BN * LDT;
  bf16* Qs = Vs + BN * LDT;
  bf16* dOs = Qs + BM * LDT;
  float* St = reinterpret_cast<float*>(dOs + BM * LDT);
  float* dPt = St + BN * LDS;
  bf16* Pt = reinterpret_cast<bf16*>(dPt + BN * LDS);
  bf16* dSt = Pt + BN * LDP;
  float* lse_s = reinterpret_cast<float*>(dSt + BN * LDP);
  float* delta_s = lse_s + BM;

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * BN;
  const long long base = (long long)b * sb + (long long)h * sh;
  const long long dbase = (long long)b * N * H * D + (long long)h * D;
  const long long rbase = ((long long)b * H + h) * N;

  load_tile<D>(Ks, LDT, k + base, sn, c0, N);
  load_tile<D>(Vs, LDT, v + base, sn, c0, N);
  __syncthreads();

  FragA kf[D / 16], vf[D / 16];
  FragC dkf[D / 16], dvf[D / 16];
#pragma unroll
  for (int kt = 0; kt < D / 16; ++kt) {
    wmma::load_matrix_sync(kf[kt], Ks + warp * 16 * LDT + kt * 16, LDT);
    wmma::load_matrix_sync(vf[kt], Vs + warp * 16 * LDT + kt * 16, LDT);
    wmma::fill_fragment(dkf[kt], 0.f);
    wmma::fill_fragment(dvf[kt], 0.f);
  }

  const int krow = warp * 16 + lane / 2, half = lane & 1;
  const int gk = c0 + krow;

  int lo, hi;
  live_range(c0, min(c0 + BN, N), N, boundary, lo, hi);
  for (int r0 = (lo / BM) * BM; r0 < hi; r0 += BM) {
    __syncthreads();
    load_tile<D>(Qs, LDT, q + base, sn, r0, N);
    load_tile<D>(dOs, LDT, dout + dbase, (long long)H * D, r0, N);
    for (int i = threadIdx.x; i < BM; i += NTHREADS) {
      const bool in = r0 + i < N;
      lse_s[i] = in ? lse[rbase + r0 + i] * LOG2E : 0.f;
      delta_s[i] = in ? delta[rbase + r0 + i] : 0.f;
    }
    __syncthreads();

    mm_abt<D>(St + warp * 16 * LDS, kf, Qs, LDT);
    mm_abt<D>(dPt + warp * 16 * LDS, vf, dOs, LDT);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int qc = 2 * j + half;
      const int gq = r0 + qc;
      const bool live = gq < N && key_live(gq, gk, N, boundary);
      const float p = live ? exp2f(St[krow * LDS + qc] * scale_log2 - lse_s[qc]) : 0.f;
      Pt[krow * LDP + qc] = __float2bfloat16(p);
      dSt[krow * LDP + qc] =
          __float2bfloat16(p * (dPt[krow * LDS + qc] - delta_s[qc]) * scale);
    }
    __syncwarp();
    mm_ab_acc<D>(dvf, Pt + warp * 16 * LDP, dOs, LDT);
    mm_ab_acc<D>(dkf, dSt + warp * 16 * LDP, Qs, LDT);
  }

  __syncwarp();
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) {
    wmma::store_matrix_sync(St + warp * 16 * LDS + dt * 16, dkf[dt], LDS, wmma::mem_row_major);
    wmma::store_matrix_sync(dPt + warp * 16 * LDS + dt * 16, dvf[dt], LDS, wmma::mem_row_major);
  }
  __syncwarp();
  if (gk < N) {
    const long long off = dbase + (long long)gk * H * D;
    for (int j = half; j < D; j += 2) {
      dk[off + j] = __float2bfloat16(St[krow * LDS + j]);
      dv[off + j] = __float2bfloat16(dPt[krow * LDS + j]);
    }
  }
}

template <int D> constexpr size_t fwd_smem() {
  return (size_t)(BM + 2 * BN) * Pitch<D>::T * 2 + (size_t)BM * LDS * 4 +
         (size_t)BM * LDP * 2 + (size_t)BM * Pitch<D>::O * 4;
}
template <int D> constexpr size_t dq_smem() {
  return (size_t)(2 * BM + 2 * BN) * Pitch<D>::T * 2 + (size_t)2 * BM * LDS * 4 +
         (size_t)BM * LDP * 2;
}
template <int D> constexpr size_t dkv_smem() {
  return (size_t)(2 * BM + 2 * BN) * Pitch<D>::T * 2 + (size_t)2 * BN * LDS * 4 +
         (size_t)2 * BN * LDP * 2 + (size_t)2 * BM * 4;
}

template <int D>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                       float* lse, int B, int N, int H, long long sb,
                       long long sn, long long sh, float scale, int boundary,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BM - 1) / BM, H, B);
  attn_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      q, k, v, o, lse, N, H, sb, sn, sh, scale * LOG2E, boundary);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v,
                       const bf16* o, const bf16* dout, const float* lse,
                       float* delta, bf16* dq, bf16* dk, bf16* dv, int B, int N,
                       int H, long long sb, long long sn, long long sh,
                       float scale, int boundary, cudaStream_t stream) {
  const long long rows = (long long)B * N * H;
  const int per_block = 256;
  const long long nblk = (rows * 32 + per_block - 1) / per_block;
  attn_bwd_delta_kernel<D><<<(unsigned)nblk, per_block, 0, stream>>>(o, dout, delta, N, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid((N + BM - 1) / BM, H, B);
  const size_t s1 = dq_smem<D>();
  err = cudaFuncSetAttribute(attn_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<D><<<grid, NTHREADS, s1, stream>>>(
      q, k, v, dout, lse, delta, dq, N, H, sb, sn, sh, scale, scale * LOG2E, boundary);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t s2 = dkv_smem<D>();
  err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_kernel<D><<<grid, NTHREADS, s2, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, N, H, sb, sn, sh, scale, scale * LOG2E, boundary);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, N, H, D) bf16 sharing strides (sb, sn, sh) with unit stride
// in D; o: contiguous (B, N, H, D) bf16; lse: (B, H, N) f32.
extern "C" int dinomc_attn_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int N, int H, int D,
                               long long sb, long long sn, long long sh,
                               float scale, int boundary, void* stream) {
  const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k, *vp = (const bf16*)v;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_fwd<16>(qp, kp, vp, (bf16*)o, (float*)lse, B, N, H, sb, sn, sh, scale, boundary, st);
    case 32: return launch_fwd<32>(qp, kp, vp, (bf16*)o, (float*)lse, B, N, H, sb, sn, sh, scale, boundary, st);
    case 64: return launch_fwd<64>(qp, kp, vp, (bf16*)o, (float*)lse, B, N, H, sb, sn, sh, scale, boundary, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As above, plus o, dout, dq, dk, dv contiguous (B, N, H, D) bf16 and the
// (B, H, N) f32 scratch delta.
extern "C" int dinomc_attn_bwd(const void* q, const void* k, const void* v,
                               const void* o, const void* dout, const void* lse,
                               void* delta, void* dq, void* dk, void* dv, int B,
                               int N, int H, int D, long long sb, long long sn,
                               long long sh, float scale, int boundary,
                               void* stream) {
  const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k, *vp = (const bf16*)v;
  const bf16 *op = (const bf16*)o, *dop = (const bf16*)dout;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_bwd<16>(qp, kp, vp, op, dop, (const float*)lse, (float*)delta, (bf16*)dq, (bf16*)dk, (bf16*)dv, B, N, H, sb, sn, sh, scale, boundary, st);
    case 32: return launch_bwd<32>(qp, kp, vp, op, dop, (const float*)lse, (float*)delta, (bf16*)dq, (bf16*)dk, (bf16*)dv, B, N, H, sb, sn, sh, scale, boundary, st);
    case 64: return launch_bwd<64>(qp, kp, vp, op, dop, (const float*)lse, (float*)delta, (bf16*)dq, (bf16*)dk, (bf16*)dv, B, N, H, sb, sn, sh, scale, boundary, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
