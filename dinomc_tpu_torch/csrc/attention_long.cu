// Long-sequence multi-head attention for sm_90a: forward (K4), dQ (K5) and
// dK/dV (K6).
//
// Replaces: dinomc_tpu/ops/pallas/attention_long.py, `_long_attention`
// (`_fwd_kernel`, K4) and `_long_bwd` (`_dq_kernel`, K5; `_dkv_kernel`, K6).
//
// What it computes: softmax(Q K^T * scale) V per (batch, head) for the long
// sequences of the segmentation path (4097 tokens at 512 px and patch 8),
// read in place from the (B, N, h, d) views of the ViT's qkv tensor. No
// packing: every key c < N is live for every query. The forward saves the
// per-row log-sum-exp; the backward recomputes P from it.
//
// What bounds it on this card: per (batch, head) the forward does 6*N^2*d
// flops (two score passes and one PV product) and the backward 14*N^2*d,
// against about 8*N*d bytes of K/V per sweep. At N = 4097, d = 64 one
// (batch, head)'s K and V are 2 x 524 KB, so they stay in the 50 MB L2
// while its query tiles sweep them: the kernels are compute- and
// latency-bound, not bandwidth-bound. The TPU kernel kept one (N, 128) K/V
// feature block resident in VMEM and a whole 128 x N f32 score chunk beside
// it; a 128 x 4224 f32 chunk is 2.2 MB, ten times the 227 KB of shared
// memory a block may use.
//
// Design: a forward block owns 128 query rows (8 warps x 16) and streams K
// (and V) through shared memory in 64-key tiles. It computes the exact
// softmax of the TPU kernel in two passes instead of an online rescale:
// pass 1 finds each row's max and normalizer over all keys (Q K^T only),
// pass 2 forms the normalized P, rounds it to bf16 as the plain version
// does, and accumulates P V in WMMA accumulator fragments that never leave
// registers. The grid's fastest axis is the query tile, so all query tiles
// of one (batch, head) run next to each other and share its K/V in L2, the
// card's analogue of the TPU kernel's resident K/V block. The backward is
// deterministic, with no atomics: the dQ kernel owns 128 query rows, first
// computes delta = rowsum(dO * O) for them (saved for K6), then loops over
// key tiles; the dK/dV kernel owns 128 keys and sweeps every 64-row query
// tile with f32 accumulators. Rows at or past N load as zeros; keys past N
// are masked out of the softmax and padded query rows out of dK/dV. Every
// product is a WMMA bf16 16x16x16 fragment with f32 accumulation; wgmma,
// TMA and pipelining are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int QT = 128;      // query rows per forward / dQ block
constexpr int KT = 64;       // keys per streamed tile (forward, dQ)
constexpr int DKV_K = 128;   // keys per dK/dV block
constexpr int DKV_Q = 64;    // query rows per streamed tile (dK/dV)
constexpr int NWARPS = 8;    // each warp owns 16 rows of its block's tile
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = 64 + 4;  // f32 score tile pitch (every score tile has 64 columns)
constexpr int LDP = 64 + 8;  // bf16 probability tile pitch
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D> struct Pitch {
  static constexpr int T = D + 8;  // bf16 q/k/v/dO tile pitch
};

// Copy rows [row0, row0 + ROWS) of one (batch, head) slice into shared
// memory with pitch ld; rows at or past N load as zeros. 16-byte vector
// loads: the wrapper checks that pointers and strides are multiples of 8.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          long long sn, int row0, int N) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NTHREADS) {
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

// out (16 x 64 f32, pitch LDS) = A (16 x D, fragments) * B^T, B a 64 x D
// row-major tile with pitch ldb.
template <int D>
__device__ __forceinline__ void scores(float* out, const FragA* a, const bf16* b, int ldb) {
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
__device__ __forceinline__ void accumulate(FragC* acc, const bf16* a, const bf16* b, int ldb) {
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

// Write a warp's 16 x D f32 accumulators as bf16 rows of a contiguous
// (B, N, H, D) tensor, staging them through its f32 score tile.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out_base, const FragC* acc, float* stage,
                                           int row, int half, int grow, int N, int H) {
  __syncwarp();
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt)
    wmma::store_matrix_sync(stage + dt * 16, acc[dt], LDS, wmma::mem_row_major);
  __syncwarp();
  if (grow < N) {
    bf16* dst = out_base + (long long)grow * H * D;
    const float* src = stage + (row % 16) * LDS;
    for (int j = half; j < D; j += 2) dst[j] = __float2bfloat16(src[j]);
  }
}

// ----------------------------------------------------------------------------
// K4: forward
// ----------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NTHREADS)
long_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                float* __restrict__ lse, int N, int H, long long sb,
                long long sn, long long sh, float scale_log2) {
  constexpr int LDT = Pitch<D>::T;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + QT * LDT;
  bf16* Vs = Ks + KT * LDT;
  float* Ss = reinterpret_cast<float*>(Vs + KT * LDT);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + QT * LDS);

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * QT;
  const long long base = (long long)b * sb + (long long)h * sh;
  float* Sw = Ss + warp * 16 * LDS;
  bf16* Pw = Ps + warp * 16 * LDP;

  load_rows<D, QT>(Qs, LDT, q + base, sn, r0, N);
  __syncthreads();
  FragA qf[D / 16];
#pragma unroll
  for (int kt = 0; kt < D / 16; ++kt)
    wmma::load_matrix_sync(qf[kt], Qs + warp * 16 * LDT + kt * 16, LDT);

  // Two lanes per query row; lane parity picks the even or odd columns.
  const int row = warp * 16 + lane / 2, half = lane & 1;
  const int grow = r0 + row;

  // Pass 1: each row's max and normalizer over all N keys (log2 units).
  // Every tile holds key c0 < N, so m is finite after the first tile.
  float m_i = -INFINITY, l_i = 0.f;
  for (int c0 = 0; c0 < N; c0 += KT) {
    __syncthreads();
    load_rows<D, KT>(Ks, LDT, k + base, sn, c0, N);
    __syncthreads();
    scores<D>(Sw, qf, Ks, LDT);
    __syncwarp();
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * j + half;
      sv[j] = (c0 + c < N) ? Sw[(row % 16) * LDS + c] * scale_log2 : -INFINITY;
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) psum += exp2f(sv[j] - m_new);
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_i = l_i * exp2f(m_i - m_new) + psum;
    m_i = m_new;
  }
  const float inv_l = 1.f / l_i;

  // Pass 2: normalized P, rounded to bf16, times V.
  FragC acc[D / 16];
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) wmma::fill_fragment(acc[dt], 0.f);
  for (int c0 = 0; c0 < N; c0 += KT) {
    __syncthreads();
    load_rows<D, KT>(Ks, LDT, k + base, sn, c0, N);
    load_rows<D, KT>(Vs, LDT, v + base, sn, c0, N);
    __syncthreads();
    scores<D>(Sw, qf, Ks, LDT);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * j + half;
      const float p = (c0 + c < N)
          ? exp2f(Sw[(row % 16) * LDS + c] * scale_log2 - m_i) * inv_l : 0.f;
      Pw[(row % 16) * LDP + c] = __float2bfloat16(p);
    }
    __syncwarp();
    accumulate<D>(acc, Pw, Vs, LDT);
  }

  store_rows<D>(o + ((long long)b * N * H + h) * D, acc, Sw, row, half, grow, N, H);
  if (grow < N && half == 0)
    lse[((long long)b * H + h) * N + grow] = (m_i + log2f(l_i)) * LN2;
}

// ----------------------------------------------------------------------------
// K5: dQ (and delta for K6)
// ----------------------------------------------------------------------------

// dQ = dS K with dS = P * (dP - delta) * scale, dP = dO V^T, and
// delta = rowsum(dO * O) computed here for the block's rows.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
long_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ o,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ delta, bf16* __restrict__ dq, int N, int H,
               long long sb, long long sn, long long sh, float scale,
               float scale_log2) {
  constexpr int LDT = Pitch<D>::T;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + QT * LDT;
  bf16* Ks = dOs + QT * LDT;
  bf16* Vs = Ks + KT * LDT;
  float* Ss = reinterpret_cast<float*>(Vs + KT * LDT);
  float* dPs = Ss + QT * LDS;
  bf16* dSs = reinterpret_cast<bf16*>(dPs + QT * LDS);

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * QT;
  const long long base = (long long)b * sb + (long long)h * sh;
  const long long dbase = ((long long)b * N * H + h) * D;  // contiguous (B, N, H, D)
  float* Sw = Ss + warp * 16 * LDS;
  float* dPw = dPs + warp * 16 * LDS;
  bf16* dSw = dSs + warp * 16 * LDP;

  load_rows<D, QT>(Qs, LDT, q + base, sn, r0, N);
  load_rows<D, QT>(dOs, LDT, dout + dbase, (long long)H * D, r0, N);
  __syncthreads();

  const int row = warp * 16 + lane / 2, half = lane & 1;
  const int grow = r0 + row;
  const long long rix = ((long long)b * H + h) * N + grow;
  float d_r = 0.f;
  if (grow < N) {
    const bf16* orow = o + dbase + (long long)grow * H * D;
    for (int j = half; j < D; j += 2)
      d_r += __bfloat162float(orow[j]) * __bfloat162float(dOs[row * LDT + j]);
  }
  d_r += __shfl_xor_sync(0xffffffffu, d_r, 1);
  if (grow < N && half == 0) delta[rix] = d_r;
  const float lse_r = grow < N ? lse[rix] * LOG2E : 0.f;

  FragA qf[D / 16], dof[D / 16];
  FragC dqf[D / 16];
#pragma unroll
  for (int kt = 0; kt < D / 16; ++kt) {
    wmma::load_matrix_sync(qf[kt], Qs + warp * 16 * LDT + kt * 16, LDT);
    wmma::load_matrix_sync(dof[kt], dOs + warp * 16 * LDT + kt * 16, LDT);
    wmma::fill_fragment(dqf[kt], 0.f);
  }

  for (int c0 = 0; c0 < N; c0 += KT) {
    __syncthreads();
    load_rows<D, KT>(Ks, LDT, k + base, sn, c0, N);
    load_rows<D, KT>(Vs, LDT, v + base, sn, c0, N);
    __syncthreads();
    scores<D>(Sw, qf, Ks, LDT);
    scores<D>(dPw, dof, Vs, LDT);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * j + half;
      const int i = (row % 16) * LDS + c;
      const float p = (grow < N && c0 + c < N) ? exp2f(Sw[i] * scale_log2 - lse_r) : 0.f;
      dSw[(row % 16) * LDP + c] = __float2bfloat16(p * (dPw[i] - d_r) * scale);
    }
    __syncwarp();
    accumulate<D>(dqf, dSw, Ks, LDT);
  }

  store_rows<D>(dq + dbase, dqf, Sw, row, half, grow, N, H);
}

// ----------------------------------------------------------------------------
// K6: dK, dV
// ----------------------------------------------------------------------------

// dV = P^T dO and dK = dS^T Q for the block's 128 keys, sweeping every
// 64-row query tile. Transposed products keep keys as rows.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
long_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int H,
                long long sb, long long sn, long long sh, float scale,
                float scale_log2) {
  constexpr int LDT = Pitch<D>::T;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + DKV_K * LDT;
  bf16* Qs = Vs + DKV_K * LDT;
  bf16* dOs = Qs + DKV_Q * LDT;
  float* St = reinterpret_cast<float*>(dOs + DKV_Q * LDT);
  float* dPt = St + DKV_K * LDS;
  bf16* Pt = reinterpret_cast<bf16*>(dPt + DKV_K * LDS);
  bf16* dSt = Pt + DKV_K * LDP;
  float* lse_s = reinterpret_cast<float*>(dSt + DKV_K * LDP);
  float* delta_s = lse_s + DKV_Q;

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * DKV_K;
  const long long base = (long long)b * sb + (long long)h * sh;
  const long long dbase = ((long long)b * N * H + h) * D;
  const long long rbase = ((long long)b * H + h) * N;
  float* Sw = St + warp * 16 * LDS;
  float* dPw = dPt + warp * 16 * LDS;
  bf16* Pw = Pt + warp * 16 * LDP;
  bf16* dSw = dSt + warp * 16 * LDP;

  load_rows<D, DKV_K>(Ks, LDT, k + base, sn, c0, N);
  load_rows<D, DKV_K>(Vs, LDT, v + base, sn, c0, N);
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

  for (int r0 = 0; r0 < N; r0 += DKV_Q) {
    __syncthreads();
    load_rows<D, DKV_Q>(Qs, LDT, q + base, sn, r0, N);
    load_rows<D, DKV_Q>(dOs, LDT, dout + dbase, (long long)H * D, r0, N);
    for (int i = threadIdx.x; i < DKV_Q; i += NTHREADS) {
      const bool in = r0 + i < N;
      lse_s[i] = in ? lse[rbase + r0 + i] * LOG2E : 0.f;
      delta_s[i] = in ? delta[rbase + r0 + i] : 0.f;
    }
    __syncthreads();
    scores<D>(Sw, kf, Qs, LDT);
    scores<D>(dPw, vf, dOs, LDT);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int qc = 2 * j + half;
      const int i = (krow % 16) * LDS + qc;
      // padded query rows carry no probability into dK/dV
      const float p = (r0 + qc < N) ? exp2f(Sw[i] * scale_log2 - lse_s[qc]) : 0.f;
      Pw[(krow % 16) * LDP + qc] = __float2bfloat16(p);
      dSw[(krow % 16) * LDP + qc] = __float2bfloat16(p * (dPw[i] - delta_s[qc]) * scale);
    }
    __syncwarp();
    accumulate<D>(dvf, Pw, dOs, LDT);
    accumulate<D>(dkf, dSw, Qs, LDT);
  }

  store_rows<D>(dk + dbase, dkf, Sw, krow, half, gk, N, H);
  store_rows<D>(dv + dbase, dvf, dPw, krow, half, gk, N, H);
}

template <int D> constexpr size_t fwd_smem() {
  return (size_t)(QT + 2 * KT) * Pitch<D>::T * 2 + (size_t)QT * LDS * 4 + (size_t)QT * LDP * 2;
}
template <int D> constexpr size_t dq_smem() {
  return (size_t)(2 * QT + 2 * KT) * Pitch<D>::T * 2 + (size_t)2 * QT * LDS * 4 +
         (size_t)QT * LDP * 2;
}
template <int D> constexpr size_t dkv_smem() {
  return (size_t)(2 * DKV_K + 2 * DKV_Q) * Pitch<D>::T * 2 + (size_t)2 * DKV_K * LDS * 4 +
         (size_t)2 * DKV_K * LDP * 2 + (size_t)2 * DKV_Q * 4;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                       int B, int N, int H, long long sb, long long sn, long long sh,
                       float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem<D>();
  cudaError_t err = set_smem(long_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  // query tiles fastest: one (batch, head)'s tiles run together and share its K/V in L2
  dim3 grid((N + QT - 1) / QT, H, B);
  long_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(q, k, v, o, lse, N, H, sb, sn, sh,
                                                       scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                      const bf16* dout, const float* lse, float* delta, bf16* dq, int B,
                      int N, int H, long long sb, long long sn, long long sh, float scale,
                      cudaStream_t stream) {
  const size_t smem = dq_smem<D>();
  cudaError_t err = set_smem(long_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + QT - 1) / QT, H, B);
  long_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(q, k, v, o, dout, lse, delta, dq, N, H,
                                                      sb, sn, sh, scale, scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                       const float* lse, const float* delta, bf16* dk, bf16* dv, int B,
                       int N, int H, long long sb, long long sn, long long sh, float scale,
                       cudaStream_t stream) {
  const size_t smem = dkv_smem<D>();
  cudaError_t err = set_smem(long_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + DKV_K - 1) / DKV_K, H, B);
  long_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(q, k, v, dout, lse, delta, dk, dv, N,
                                                       H, sb, sn, sh, scale, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, N, H, D) bf16 sharing strides (sb, sn, sh) with unit stride
// in D; o: contiguous (B, N, H, D) bf16; lse: (B, H, N) f32.
extern "C" int dinomc_long_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int N, int H, int D, long long sb,
                                    long long sn, long long sh, float scale, void* stream) {
  const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k, *vp = (const bf16*)v;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_fwd<16>(qp, kp, vp, (bf16*)o, (float*)lse, B, N, H, sb, sn, sh, scale, st);
    case 32: return launch_fwd<32>(qp, kp, vp, (bf16*)o, (float*)lse, B, N, H, sb, sn, sh, scale, st);
    case 64: return launch_fwd<64>(qp, kp, vp, (bf16*)o, (float*)lse, B, N, H, sb, sn, sh, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As above, plus o, dout, dq contiguous (B, N, H, D) bf16 and delta (B, H, N)
// f32, written here and read by dinomc_long_attn_dkv.
extern "C" int dinomc_long_attn_dq(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   int B, int N, int H, int D, long long sb, long long sn,
                                   long long sh, float scale, void* stream) {
  const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k, *vp = (const bf16*)v;
  const bf16 *op = (const bf16*)o, *dop = (const bf16*)dout;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_dq<16>(qp, kp, vp, op, dop, (const float*)lse, (float*)delta, (bf16*)dq, B, N, H, sb, sn, sh, scale, st);
    case 32: return launch_dq<32>(qp, kp, vp, op, dop, (const float*)lse, (float*)delta, (bf16*)dq, B, N, H, sb, sn, sh, scale, st);
    case 64: return launch_dq<64>(qp, kp, vp, op, dop, (const float*)lse, (float*)delta, (bf16*)dq, B, N, H, sb, sn, sh, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, k, v as above; dout, dk, dv contiguous (B, N, H, D) bf16; lse and
// delta (B, H, N) f32.
extern "C" int dinomc_long_attn_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int N, int H, int D,
                                    long long sb, long long sn, long long sh, float scale,
                                    void* stream) {
  const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k, *vp = (const bf16*)v;
  const bf16* dop = (const bf16*)dout;
  const float *lp = (const float*)lse, *dp = (const float*)delta;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_dkv<16>(qp, kp, vp, dop, lp, dp, (bf16*)dk, (bf16*)dv, B, N, H, sb, sn, sh, scale, st);
    case 32: return launch_dkv<32>(qp, kp, vp, dop, lp, dp, (bf16*)dk, (bf16*)dv, B, N, H, sb, sn, sh, scale, st);
    case 64: return launch_dkv<64>(qp, kp, vp, dop, lp, dp, (bf16*)dk, (bf16*)dv, B, N, H, sb, sn, sh, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
