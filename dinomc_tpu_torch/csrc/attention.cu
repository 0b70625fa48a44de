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
// Both are built for Hopper (hopper_attn.cuh): a block holds one consumer
// warpgroup of 64 rows and one producer warp that streams the other
// operand by TMA through a ring of mbarrier-tracked stages; two blocks
// share an SM. Scores never leave registers; tiles wholly in the other
// packed crop are never loaded, tiles on the boundary or the ragged edge
// are masked per element; rows past N load as zeros and stores clip them.
//
// K1: one pass with an online softmax, K4's design (attention_long.cu)
// with the crop mask. The block owns 64 query rows (Q resident) and walks
// the live key tiles: S = Q K^T by wgmma from shared memory into registers,
// the running max and sum per row, O rescaled in registers, and P, rounded
// to bf16 unnormalized, as the register A operand of O += P V. A row whose
// keys so far are all in the other crop has a max of -inf; it exponentiates
// against 0 instead, so its P is 0 and not NaN. O leaves by a TMA store,
// the log-sum-exp (natural log) by plain stores.
//
// K2: deterministic, no atomics, two launches. The dQ launch
// (hopper::dq_block, shared with K5) owns 64 query rows (Q, dO resident),
// computes delta = rowsum(dO * O) for them, then per live 64-key tile forms
// S = Q K^T and dP = dO V^T with wgmma from shared memory, dS in registers,
// and dQ += dS K with dS as the register A operand. The dK/dV launch
// (hopper::dkv_block, shared with K6) owns 64 keys (K, V resident), streams
// the live 64-row Q/dO tiles with their lse and delta, forms S^T = K Q^T
// and dP^T = V dO^T, and adds P^T dO and dS^T Q.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_attn.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ----------------------------------------------------------------------------
// K1: forward (wgmma + TMA)
// ----------------------------------------------------------------------------

// One consumer warpgroup a block, two blocks an SM. 64-key tiles in three
// stages: measured faster than 128-key tiles or two stages over the DINO
// step's five shapes (scripts/attention_variants.py; PERF.md).
constexpr int ATTN_FWD_KEYS = 64;                 // keys a streamed K/V tile: 64 or 128
constexpr int ATTN_FWD_STAGES = 3;                // K/V tiles in flight
constexpr int ATTN_FWD_THREADS = 128 + 32;        // + 1 producer warp

template <int D> struct FwdSmem {
  bf16 q[64 * D];  // Q; stages O at the end
  bf16 k[ATTN_FWD_STAGES][ATTN_FWD_KEYS * D];
  bf16 v[ATTN_FWD_STAGES][ATTN_FWD_KEYS * D];
  uint64_t full[ATTN_FWD_STAGES], empty[ATTN_FWD_STAGES], q_full;
};

// The producer warp loads the block's Q once, then the live K/V tiles into
// the ring; the consumer warpgroup computes, per tile, S = Q K^T into
// registers, masks dead keys (only on tiles that cross the boundary or N),
// updates its running max and sum, rescales O and adds P V (P in registers
// as the A operand, V read MN-major). O is divided by the sum at the end,
// staged in shared memory and written by a TMA store that clips rows past N.
template <int D>
__global__ void __launch_bounds__(ATTN_FWD_THREADS, 2)
attn_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap o_map, float* __restrict__ lse, int N, int H,
                float scale_log2, int boundary) {
  using namespace hopper;
  constexpr int KEYS = ATTN_FWD_KEYS, STAGES = ATTN_FWD_STAGES;
  constexpr uint32_t BOX = BOX_ROWS * D * 2;  // bytes of one 64-row box
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<D>& sm = aligned_smem<FwdSmem<D>>(smem_raw);
  const int r0 = blockIdx.x * BOX_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int r1 = min(r0 + BOX_ROWS, N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int lo, hi;
  live_range(r0, r1, N, boundary, lo, hi);
  const int first = (lo / KEYS) * KEYS;
  const int ntiles = (hi - first + KEYS - 1) / KEYS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4);  // one arrival per consumer warp
    }
    mbar_init(&sm.q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      mbar_expect_tx(&sm.q_full, BOX);
      tma_load(sm.q, &q_map, &sm.q_full, h, r0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES, c0 = first + t * KEYS;
        mbar_wait(&sm.empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * (KEYS / BOX_ROWS) * BOX);
#pragma unroll
        for (int j = 0; j < KEYS / BOX_ROWS; ++j) {
          tma_load(sm.k[s] + j * BOX_ROWS * D, &k_map, &sm.full[s], h, c0 + j * BOX_ROWS, b);
          tma_load(sm.v[s] + j * BOX_ROWS * D, &v_map, &sm.full[s], h, c0 + j * BOX_ROWS, b);
        }
      }
    }
    return;
  }

  // consumers: one warpgroup, warps 0-3
  const uint64_t q_desc = make_desc<D>(sm.q);
  const int qrow[2] = {r0 + acc_row(warp, lane, 0), r0 + acc_row(warp, lane, 2)};
  float o[D / 2];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows r, r + 8 (log2 units)
  mbar_wait(&sm.q_full, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES, c0 = first + t * KEYS;
    mbar_wait(&sm.full[s], (t / STAGES) & 1);
    const uint64_t k_desc = make_desc<D>(sm.k[s]), v_desc = make_desc<D>(sm.v[s]);

    float sc[KEYS / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<KEYS>(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    if (edge_tile<KEYS>(r0, r1, c0, N, boundary)) {
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i)
        if (!key_live(qrow[(i / 2) % 2], c0 + acc_col(lane, i), N, boundary)) sc[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float alpha[2], m_use[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr] * scale_log2);
      // every key so far dead for this row: exponentiate against 0, not -inf
      m_use[rr] = m_new == -INFINITY ? 0.f : m_new;
      alpha[rr] = exp2f(m[rr] - m_use[rr]);
      m[rr] = m_new;
      l[rr] *= alpha[rr];
    }
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) {
      const int rr = (i / 2) % 2;
      sc[i] = exp2f(fmaf(sc[i], scale_log2, -m_use[rr]));
      l[rr] += sc[i];  // this thread's share of the row sum; summed over the quad at the end
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

    uint32_t pa[KEYS / 16][4];  // P, bf16, as the A operand of each 16-key slice
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) to_a_operand(pa[kk], sc, kk);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], v_desc + (uint64_t)((kk * 16 * Swizzle<D>::ROW) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    inv[rr] = 1.f / l[rr];  // a live row attends at least to itself, so l > 0
  }
  named_sync(1, 128);  // the warpgroup is done reading its Q rows
  stage_rows<D>(reinterpret_cast<unsigned char*>(sm.q), o, warp, lane, inv[0], inv[1]);
  fence_async_smem();
  named_sync(1, 128);
  if (warp == 0 && lane == 0) {
    tma_store(&o_map, sm.q, h, r0, b);
    tma_store_wait();
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      if (qrow[rr] < N) lse[((long long)b * H + h) * N + qrow[rr]] = (m[rr] + log2f(l[rr])) * LN2;
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

// dQ = dS K for the block's query rows, and delta for the dK/dV launch:
// hopper::dq_block.
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 2 / BWD_WGS)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const __grid_constant__ CUtensorMap dq_map, const bf16* __restrict__ o,
                   const float* __restrict__ lse, float* __restrict__ delta, int N, int H,
                   float scale, float scale_log2, int boundary) {
  hopper::dq_block<D, BWD_WGS, BWD_STAGES, BWD_TILE>(&q_map, &k_map, &v_map, &do_map, &dq_map, o,
                                                     lse, delta, N, H, scale, scale_log2,
                                                     boundary);
}

// dV = P^T dO and dK = dS^T Q for the block's keys: hopper::dkv_block.
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
  hopper::dkv_block<D, BWD_WGS, BWD_STAGES>(&q_map, &k_map, &v_map, &do_map, &dk_map, &dv_map,
                                            lse, delta, N, H, scale, scale_log2, boundary);
}

template <int D>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int B, int N,
               int H, long long sb, long long sn, long long sh, float scale, int boundary,
               cudaStream_t stream, int device) {
  const cudaError_t bound = cudaSetDevice(device);  // see hopper::make_map
  if (bound != cudaSuccess) return bound;
  CUtensorMap q_map, k_map, v_map, o_map;
  CUresult res = CUDA_SUCCESS;
  if (res == CUDA_SUCCESS) res = hopper::make_map<D>(&q_map, q, B, N, H, sb, sn, sh);
  if (res == CUDA_SUCCESS) res = hopper::make_map<D>(&k_map, k, B, N, H, sb, sn, sh);
  if (res == CUDA_SUCCESS) res = hopper::make_map<D>(&v_map, v, B, N, H, sb, sn, sh);
  if (res == CUDA_SUCCESS) res = hopper::make_map<D>(&o_map, o, B, N, H);
  if (res != CUDA_SUCCESS) return hopper::MAP_ERROR + (int)res;
  const size_t smem = sizeof(FwdSmem<D>) + 1024;
  static bool smem_set = false;
  cudaError_t err = hopper::allow_smem(attn_fwd_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((N + hopper::BOX_ROWS - 1) / hopper::BOX_ROWS, H, B);
  attn_fwd_kernel<D><<<grid, ATTN_FWD_THREADS, smem, stream>>>(q_map, k_map, v_map, o_map, lse, N,
                                                               H, scale * LOG2E, boundary);
  return cudaGetLastError();
}

template <int D>
int launch_bwd_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                  const bf16* dout, const float* lse, float* delta, bf16* dq, int B,
                  int N, int H, long long sb, long long sn, long long sh, float scale,
                  int boundary, cudaStream_t stream, int device) {
  const cudaError_t bound = cudaSetDevice(device);  // see hopper::make_map
  if (bound != cudaSuccess) return bound;
  hopper::DqMaps maps;
  const CUresult res = hopper::make_dq_maps<D>(maps, q, k, v, dout, dq, B, N, H, sb, sn, sh);
  if (res != CUDA_SUCCESS) return hopper::MAP_ERROR + (int)res;
  const size_t smem = sizeof(hopper::DqSmem<D, BWD_WGS, BWD_STAGES, BWD_TILE>) + 1024;
  static bool smem_set = false;
  cudaError_t err = hopper::allow_smem(attn_bwd_dq_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BWD_ROWS - 1) / BWD_ROWS, H, B);
  attn_bwd_dq_kernel<D><<<grid, BWD_THREADS, smem, stream>>>(
      maps.q, maps.k, maps.v, maps.dout, maps.dq, o, lse, delta, N, H, scale, scale * LOG2E,
      boundary);
  return cudaGetLastError();
}

template <int D>
int launch_bwd_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                   const float* lse, const float* delta, bf16* dk, bf16* dv, int B,
                   int N, int H, long long sb, long long sn, long long sh, float scale,
                   int boundary, cudaStream_t stream, int device) {
  const cudaError_t bound = cudaSetDevice(device);  // see hopper::make_map
  if (bound != cudaSuccess) return bound;
  hopper::DkvMaps maps;
  const CUresult res = hopper::make_dkv_maps<D>(maps, q, k, v, dout, dk, dv, B, N, H, sb, sn, sh);
  if (res != CUDA_SUCCESS) return hopper::MAP_ERROR + (int)res;
  const size_t smem = sizeof(hopper::DkvSmem<D, BWD_WGS, BWD_STAGES>) + 1024;
  static bool smem_set = false;
  cudaError_t err = hopper::allow_smem(attn_bwd_dkv_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BWD_ROWS - 1) / BWD_ROWS, H, B);
  attn_bwd_dkv_kernel<D><<<grid, BWD_THREADS, smem, stream>>>(
      maps.q, maps.k, maps.v, maps.dout, maps.dk, maps.dv, lse, delta, N, H, scale, scale * LOG2E,
      boundary);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, N, H, D) bf16 sharing strides (sb, sn, sh) with unit stride
// in D; o: contiguous (B, N, H, D) bf16; lse: (B, H, N) f32; `device`: the
// CUDA device of the tensors and the stream.
extern "C" int dinomc_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int B, int N, int H, int D, long long sb, long long sn,
                               long long sh, float scale, int boundary, void* stream,
                               int device) {
  const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k, *vp = (const bf16*)v;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_fwd<16>(qp, kp, vp, (bf16*)o, (float*)lse, B, N, H, sb, sn, sh, scale, boundary, st, device);
    case 32: return launch_fwd<32>(qp, kp, vp, (bf16*)o, (float*)lse, B, N, H, sb, sn, sh, scale, boundary, st, device);
    case 64: return launch_fwd<64>(qp, kp, vp, (bf16*)o, (float*)lse, B, N, H, sb, sn, sh, scale, boundary, st, device);
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
