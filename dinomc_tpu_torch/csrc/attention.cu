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
// (batch, head) forward and 10*N^2*d backward (14*N^2*d as computed here,
// S and dP once in each backward launch), against only 4*N*d bf16 values
// of traffic, so at N = 785 it is compute- and latency-bound. The TPU
// kernel kept the whole (N, N) f32 score matrix in 16 MB of VMEM; a 785x785
// f32 tile is 2.4 MB and does not fit in 227 KB of shared memory.
//
// K1: flash-style tiling. A block owns 64 query rows (4 warps x 16) and
// walks 64-key tiles with an online softmax, keeping per-warp 16x64 score
// tiles in shared memory; WMMA bf16 16x16x16 fragments with f32
// accumulators. Key tiles that lie wholly in the other packed crop are
// skipped, not masked.
//
// K2: deterministic, no atomics, two launches built for Hopper
// (hopper_attn.cuh). A block holds one consumer warpgroup of 64 rows and
// one producer warp that streams the other operand by TMA through a ring of
// mbarrier-tracked stages; two blocks share an SM. The dQ launch owns 64
// query rows (Q, dO resident), computes delta = rowsum(dO * O) for them,
// then per live 64-key tile forms S = Q K^T and dP = dO V^T with wgmma
// from shared memory, dS in registers, and dQ += dS K with dS as the
// register A operand. The dK/dV launch owns 64 keys (K, V resident),
// streams the live 64-row Q/dO tiles with their lse and delta, forms S^T =
// K Q^T and dP^T = V dO^T, and adds P^T dO and dS^T Q. Scores never leave
// registers; key (or query) tiles wholly in the other packed crop are
// skipped, tiles on the boundary or the ragged edge masked per element;
// rows past N load as zeros and stores clip them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "hopper_attn.cuh"

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
// K2: backward (wgmma + TMA), two launches
// ----------------------------------------------------------------------------

// One consumer warpgroup a block, two blocks an SM: measured faster than two
// warpgroups a block at every main-path shape, and a third stage gained
// nothing (scripts/attention_variants.py; PERF.md).
constexpr int BWD_WGS = 1;                        // consumer warpgroups a block, 64 rows each
constexpr int BWD_ROWS = 64 * BWD_WGS;            // rows a block owns: queries (dQ) or keys (dK/dV)
constexpr int BWD_TILE = 64;                      // rows a streamed tile: keys (dQ) or queries (dK/dV)
constexpr int BWD_STAGES = 2;                     // streamed tiles in flight
constexpr int BWD_THREADS = 128 * BWD_WGS + 32;   // + 1 producer warp
constexpr int BWD_PRODUCER = 4 * BWD_WGS;         // the producer's warp index

// Does tile [t0, t0 + BWD_TILE) against the block's rows [r0, r1) need the
// per-element mask: past N, or on both sides of the crop boundary?
__device__ __forceinline__ bool edge_tile(int r0, int r1, int t0, int N, int boundary) {
  if (t0 + BWD_TILE > N) return true;
  if (boundary == 0) return false;
  const bool below = r1 <= boundary && t0 + BWD_TILE <= boundary;
  const bool above = r0 >= boundary && t0 >= boundary;
  return !(below || above);
}

template <int D> struct DqSmem {
  bf16 q[BWD_ROWS * D];  // each warpgroup's half stages its dQ at the end
  bf16 dout[BWD_ROWS * D];
  bf16 k[BWD_STAGES][BWD_TILE * D];
  bf16 v[BWD_STAGES][BWD_TILE * D];
  float delta[BWD_ROWS];
  uint64_t full[BWD_STAGES], empty[BWD_STAGES], rows_full;
};

// dQ = dS K with dS = P * (dP - delta) * scale, P = exp(S - lse), dP = dO
// V^T, for the block's query rows (Q and dO resident) over the live
// key tiles (K, V streamed by TMA). First computes delta = rowsum(dO * O)
// for its rows and writes it for the dK/dV kernel. S and dP are wgmma
// products from shared memory; dS stays in registers as the A operand of
// dS K (K read MN-major).
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 2 / BWD_WGS)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const __grid_constant__ CUtensorMap dq_map, const bf16* __restrict__ o,
                   const float* __restrict__ lse, float* __restrict__ delta, int N, int H,
                   float scale, float scale_log2, int boundary) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  DqSmem<D>& sm = aligned_smem<DqSmem<D>>(smem_raw);
  constexpr uint32_t BOX = BOX_ROWS * D * 2;
  constexpr int ROW = Swizzle<D>::ROW;
  const int r0 = blockIdx.x * BWD_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int r1 = min(r0 + BWD_ROWS, N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int lo, hi;
  live_range(r0, r1, N, boundary, lo, hi);
  const int first = (lo / BWD_TILE) * BWD_TILE;
  const int ntiles = (hi - first + BWD_TILE - 1) / BWD_TILE;

  if (threadIdx.x == 0) {
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4 * BWD_WGS);  // one arrival per consumer warp
    }
    mbar_init(&sm.rows_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == BWD_PRODUCER) {
    if (lane == 0) {
      mbar_expect_tx(&sm.rows_full, 2 * BWD_WGS * BOX);
      for (int g = 0; g < BWD_WGS; ++g) {
        tma_load(sm.q + g * BOX_ROWS * D, &q_map, &sm.rows_full, h, r0 + g * BOX_ROWS, b);
        tma_load(sm.dout + g * BOX_ROWS * D, &do_map, &sm.rows_full, h, r0 + g * BOX_ROWS, b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % BWD_STAGES;
        mbar_wait(&sm.empty[s], ((t / BWD_STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * BOX);
        tma_load(sm.k[s], &k_map, &sm.full[s], h, first + t * BWD_TILE, b);
        tma_load(sm.v[s], &v_map, &sm.full[s], h, first + t * BWD_TILE, b);
      }
    }
    return;
  }

  // consumers
  const int wg = warp / 4, wl = warp % 4;
  const int row0 = r0 + wg * BOX_ROWS;
  bf16* q_tile = sm.q + wg * BOX_ROWS * D;
  const bf16* do_tile = sm.dout + wg * BOX_ROWS * D;
  const long long rbase = ((long long)b * H + h) * N;
  mbar_wait(&sm.rows_full, 0);

  {  // delta for the warpgroup's 64 rows, two threads a row
    const int t = threadIdx.x % 128, row = t / 2, half = t % 2;
    const int grow = row0 + row;
    float acc = 0.f;
    if (grow < N) {
      const bf16* orow = o + (((long long)b * N + grow) * H + h) * D;
#pragma unroll
      for (int c = half * (D / 2); c < (half + 1) * (D / 2); c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(
            reinterpret_cast<const unsigned char*>(do_tile) + swz<D>(row * ROW + c * 2));
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 x = __bfloat1622float2(o2[j]), y = __bfloat1622float2(d2[j]);
          acc += x.x * y.x + x.y * y.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sm.delta[wg * BOX_ROWS + row] = acc;
      if (grow < N) delta[rbase + grow] = acc;
    }
  }
  named_sync(1 + wg, 128);
  float lse2[2], dl[2];  // rows r, r + 8: lse in log2 units, delta
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = acc_row(wl, lane, 2 * rr);
    lse2[rr] = row0 + row < N ? lse[rbase + row0 + row] * LOG2E : 0.f;
    dl[rr] = sm.delta[wg * BOX_ROWS + row];
  }

  const uint64_t q_desc = make_desc<D>(q_tile), do_desc = make_desc<D>(do_tile);
  float dq[D / 2];
  zero(dq);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % BWD_STAGES;
    mbar_wait(&sm.full[s], (t / BWD_STAGES) & 1);
    const uint64_t k_desc = make_desc<D>(sm.k[s]), v_desc = make_desc<D>(sm.v[s]);
    float sc[BWD_TILE / 2], dp[BWD_TILE / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(dp, do_desc + 2 * kk, v_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    const int c0 = first + t * BWD_TILE;
    const bool edge = edge_tile(r0, r1, c0, N, boundary);
#pragma unroll
    for (int i = 0; i < BWD_TILE / 2; ++i) {
      const int rr = (i / 2) % 2;
      float p = exp2f(fmaf(sc[i], scale_log2, -lse2[rr]));
      if (edge && !key_live(row0 + acc_row(wl, lane, i), c0 + acc_col(lane, i), N, boundary))
        p = 0.f;
      sc[i] = p * (dp[i] - dl[rr]) * scale;  // dS
    }
    uint32_t dsa[BWD_TILE / 16][4];  // dS, bf16, as the A operand of each 16-key slice
#pragma unroll
    for (int kk = 0; kk < BWD_TILE / 16; ++kk) to_a_operand(dsa[kk], sc, kk);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BWD_TILE / 16; ++kk)
      wgmma_rs<D>(dq, dsa[kk], k_desc + (uint64_t)((kk * 16 * ROW) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  named_sync(1 + wg, 128);  // the warpgroup is done reading its Q rows
  stage_rows<D>(reinterpret_cast<unsigned char*>(q_tile), dq, wl, lane, 1.f, 1.f);
  fence_async_smem();
  named_sync(1 + wg, 128);
  if (wl == 0 && lane == 0) {
    tma_store(&dq_map, q_tile, h, row0, b);
    tma_store_wait();
  }
}

template <int D> struct DkvSmem {
  bf16 k[BWD_ROWS * D];  // each warpgroup's half stages its dK at the end
  bf16 v[BWD_ROWS * D];  // ... and its dV
  bf16 q[BWD_STAGES][BWD_TILE * D];
  bf16 dout[BWD_STAGES][BWD_TILE * D];
  float lse[BWD_STAGES][BWD_TILE];  // log2 units
  float delta[BWD_STAGES][BWD_TILE];
  uint64_t full[BWD_STAGES], empty[BWD_STAGES], rows_full;
};

// dV = P^T dO and dK = dS^T Q for the block's keys (K and V resident)
// over the live query tiles (Q and dO streamed by TMA; their lse and delta
// copied by the producer warp). S^T = K Q^T and dP^T = V dO^T are wgmma
// products from shared memory with keys as rows; P^T and dS^T stay in
// registers as the A operands of the two accumulations (dO and Q read
// MN-major). Padded query rows and, across the crop boundary, dead pairs
// get P = 0.
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 2 / BWD_WGS)
attn_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap dk_map,
                    const __grid_constant__ CUtensorMap dv_map, const float* __restrict__ lse,
                    const float* __restrict__ delta, int N, int H, float scale, float scale_log2,
                    int boundary) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  DkvSmem<D>& sm = aligned_smem<DkvSmem<D>>(smem_raw);
  constexpr uint32_t BOX = BOX_ROWS * D * 2;
  constexpr int ROW = Swizzle<D>::ROW;
  const int c0 = blockIdx.x * BWD_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int c1 = min(c0 + BWD_ROWS, N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long rbase = ((long long)b * H + h) * N;
  int lo, hi;
  live_range(c0, c1, N, boundary, lo, hi);
  const int first = (lo / BWD_TILE) * BWD_TILE;
  const int ntiles = (hi - first + BWD_TILE - 1) / BWD_TILE;

  if (threadIdx.x == 0) {
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(&sm.full[s], 32);  // every producer lane, one with the TMA bytes
      mbar_init(&sm.empty[s], 4 * BWD_WGS);
    }
    mbar_init(&sm.rows_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == BWD_PRODUCER) {
    if (lane == 0) {
      mbar_expect_tx(&sm.rows_full, 2 * BWD_WGS * BOX);
      for (int g = 0; g < BWD_WGS; ++g) {
        tma_load(sm.k + g * BOX_ROWS * D, &k_map, &sm.rows_full, h, c0 + g * BOX_ROWS, b);
        tma_load(sm.v + g * BOX_ROWS * D, &v_map, &sm.rows_full, h, c0 + g * BOX_ROWS, b);
      }
    }
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % BWD_STAGES, r0 = first + t * BWD_TILE;
      mbar_wait(&sm.empty[s], ((t / BWD_STAGES) & 1) ^ 1);
      for (int i = lane; i < BWD_TILE; i += 32) {
        const bool in = r0 + i < N;
        sm.lse[s][i] = in ? lse[rbase + r0 + i] * LOG2E : 0.f;
        sm.delta[s][i] = in ? delta[rbase + r0 + i] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(&sm.full[s], 2 * BOX);
        tma_load(sm.q[s], &q_map, &sm.full[s], h, r0, b);
        tma_load(sm.dout[s], &do_map, &sm.full[s], h, r0, b);
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // consumers
  const int wg = warp / 4, wl = warp % 4;
  const int key0 = c0 + wg * BOX_ROWS;
  bf16* k_tile = sm.k + wg * BOX_ROWS * D;
  bf16* v_tile = sm.v + wg * BOX_ROWS * D;
  const uint64_t k_desc = make_desc<D>(k_tile), v_desc = make_desc<D>(v_tile);
  float dk[D / 2], dv[D / 2];
  zero(dk);
  zero(dv);
  mbar_wait(&sm.rows_full, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % BWD_STAGES, r0 = first + t * BWD_TILE;
    mbar_wait(&sm.full[s], (t / BWD_STAGES) & 1);
    const uint64_t q_desc = make_desc<D>(sm.q[s]), do_desc = make_desc<D>(sm.dout[s]);
    float st[BWD_TILE / 2], dpt[BWD_TILE / 2];  // keys x queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(st, k_desc + 2 * kk, q_desc + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(dpt, v_desc + 2 * kk, do_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    const bool edge = edge_tile(c0, c1, r0, N, boundary);
#pragma unroll
    for (int i = 0; i < BWD_TILE / 2; ++i) {
      const int col = acc_col(lane, i), gq = r0 + col;
      float p = exp2f(fmaf(st[i], scale_log2, -sm.lse[s][col]));
      if (edge && !(gq < N && key_live(gq, key0 + acc_row(wl, lane, i), N, boundary))) p = 0.f;
      st[i] = p;                                              // P^T
      dpt[i] = p * (dpt[i] - sm.delta[s][col]) * scale;       // dS^T
    }
    uint32_t pa[BWD_TILE / 16][4], dsa[BWD_TILE / 16][4];  // P^T, dS^T as A operands
#pragma unroll
    for (int kk = 0; kk < BWD_TILE / 16; ++kk) {
      to_a_operand(pa[kk], st, kk);
      to_a_operand(dsa[kk], dpt, kk);
    }
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BWD_TILE / 16; ++kk)
      wgmma_rs<D>(dv, pa[kk], do_desc + (uint64_t)((kk * 16 * ROW) >> 4));
#pragma unroll
    for (int kk = 0; kk < BWD_TILE / 16; ++kk)
      wgmma_rs<D>(dk, dsa[kk], q_desc + (uint64_t)((kk * 16 * ROW) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  named_sync(1 + wg, 128);  // the warpgroup is done reading its K and V rows
  stage_rows<D>(reinterpret_cast<unsigned char*>(k_tile), dk, wl, lane, 1.f, 1.f);
  stage_rows<D>(reinterpret_cast<unsigned char*>(v_tile), dv, wl, lane, 1.f, 1.f);
  fence_async_smem();
  named_sync(1 + wg, 128);
  if (wl == 0 && lane == 0) {
    tma_store(&dk_map, k_tile, h, key0, b);
    tma_store(&dv_map, v_tile, h, key0, b);
    tma_store_wait();
  }
}

template <int D> constexpr size_t fwd_smem() {
  return (size_t)(BM + 2 * BN) * Pitch<D>::T * 2 + (size_t)BM * LDS * 4 +
         (size_t)BM * LDP * 2 + (size_t)BM * Pitch<D>::O * 4;
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
int launch_bwd_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                  const bf16* dout, const float* lse, float* delta, bf16* dq, int B,
                  int N, int H, long long sb, long long sn, long long sh, float scale,
                  int boundary, cudaStream_t stream, int device) {
  const cudaError_t bound = cudaSetDevice(device);  // see hopper::make_map
  if (bound != cudaSuccess) return bound;
  CUtensorMap q_map, k_map, v_map, do_map, dq_map;
  CUresult res = CUDA_SUCCESS;
  if (res == CUDA_SUCCESS) res = hopper::make_map<D>(&q_map, q, B, N, H, sb, sn, sh);
  if (res == CUDA_SUCCESS) res = hopper::make_map<D>(&k_map, k, B, N, H, sb, sn, sh);
  if (res == CUDA_SUCCESS) res = hopper::make_map<D>(&v_map, v, B, N, H, sb, sn, sh);
  if (res == CUDA_SUCCESS) res = hopper::make_map<D>(&do_map, dout, B, N, H);
  if (res == CUDA_SUCCESS) res = hopper::make_map<D>(&dq_map, dq, B, N, H);
  if (res != CUDA_SUCCESS) return hopper::MAP_ERROR + (int)res;
  const size_t smem = sizeof(DqSmem<D>) + 1024;
  static bool smem_set = false;
  cudaError_t err = hopper::allow_smem(attn_bwd_dq_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BWD_ROWS - 1) / BWD_ROWS, H, B);
  attn_bwd_dq_kernel<D><<<grid, BWD_THREADS, smem, stream>>>(
      q_map, k_map, v_map, do_map, dq_map, o, lse, delta, N, H, scale, scale * LOG2E, boundary);
  return cudaGetLastError();
}

template <int D>
int launch_bwd_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                   const float* lse, const float* delta, bf16* dk, bf16* dv, int B,
                   int N, int H, long long sb, long long sn, long long sh, float scale,
                   int boundary, cudaStream_t stream, int device) {
  const cudaError_t bound = cudaSetDevice(device);  // see hopper::make_map
  if (bound != cudaSuccess) return bound;
  CUtensorMap q_map, k_map, v_map, do_map, dk_map, dv_map;
  CUresult res = CUDA_SUCCESS;
  if (res == CUDA_SUCCESS) res = hopper::make_map<D>(&q_map, q, B, N, H, sb, sn, sh);
  if (res == CUDA_SUCCESS) res = hopper::make_map<D>(&k_map, k, B, N, H, sb, sn, sh);
  if (res == CUDA_SUCCESS) res = hopper::make_map<D>(&v_map, v, B, N, H, sb, sn, sh);
  if (res == CUDA_SUCCESS) res = hopper::make_map<D>(&do_map, dout, B, N, H);
  if (res == CUDA_SUCCESS) res = hopper::make_map<D>(&dk_map, dk, B, N, H);
  if (res == CUDA_SUCCESS) res = hopper::make_map<D>(&dv_map, dv, B, N, H);
  if (res != CUDA_SUCCESS) return hopper::MAP_ERROR + (int)res;
  const size_t smem = sizeof(DkvSmem<D>) + 1024;
  static bool smem_set = false;
  cudaError_t err = hopper::allow_smem(attn_bwd_dkv_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BWD_ROWS - 1) / BWD_ROWS, H, B);
  attn_bwd_dkv_kernel<D><<<grid, BWD_THREADS, smem, stream>>>(
      q_map, k_map, v_map, do_map, dk_map, dv_map, lse, delta, N, H, scale, scale * LOG2E,
      boundary);
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

// K2, first launch. As above, plus o, dout, dq contiguous (B, N, H, D) bf16
// and delta (B, H, N) f32, written here and read by dinomc_attn_bwd_dkv;
// `device` is the CUDA device of the tensors and the stream.
extern "C" int dinomc_attn_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, void* delta, void* dq,
                                  int B, int N, int H, int D, long long sb, long long sn,
                                  long long sh, float scale, int boundary, void* stream,
                                  int device) {
  const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k, *vp = (const bf16*)v;
  const bf16 *op = (const bf16*)o, *dop = (const bf16*)dout;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_bwd_dq<16>(qp, kp, vp, op, dop, (const float*)lse, (float*)delta, (bf16*)dq, B, N, H, sb, sn, sh, scale, boundary, st, device);
    case 32: return launch_bwd_dq<32>(qp, kp, vp, op, dop, (const float*)lse, (float*)delta, (bf16*)dq, B, N, H, sb, sn, sh, scale, boundary, st, device);
    case 64: return launch_bwd_dq<64>(qp, kp, vp, op, dop, (const float*)lse, (float*)delta, (bf16*)dq, B, N, H, sb, sn, sh, scale, boundary, st, device);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K2, second launch: dout, dk, dv contiguous (B, N, H, D) bf16; lse and
// delta (B, H, N) f32; `device` as above.
extern "C" int dinomc_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int N, int H, int D, long long sb,
                                   long long sn, long long sh, float scale, int boundary,
                                   void* stream, int device) {
  const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k, *vp = (const bf16*)v;
  const bf16* dop = (const bf16*)dout;
  const float *lp = (const float*)lse, *dp = (const float*)delta;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_bwd_dkv<16>(qp, kp, vp, dop, lp, dp, (bf16*)dk, (bf16*)dv, B, N, H, sb, sn, sh, scale, boundary, st, device);
    case 32: return launch_bwd_dkv<32>(qp, kp, vp, dop, lp, dp, (bf16*)dk, (bf16*)dv, B, N, H, sb, sn, sh, scale, boundary, st, device);
    case 64: return launch_bwd_dkv<64>(qp, kp, vp, dop, lp, dp, (bf16*)dk, (bf16*)dv, B, N, H, sb, sn, sh, scale, boundary, st, device);
    default: return (int)cudaErrorInvalidValue;
  }
}
