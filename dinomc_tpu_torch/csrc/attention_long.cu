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
// What bounds it on this card: per (batch, head) the forward does 4*N^2*d
// flops and the backward 14*N^2*d, against about 8*N*d bytes of K/V per
// sweep. At N = 4097, d = 64 one (batch, head)'s K and V are 2 x 524 KB, so
// they stay in the 50 MB L2 while its query tiles sweep them: the kernels
// are compute- and latency-bound, not bandwidth-bound. The TPU kernel kept
// one (N, 128) K/V feature block resident in VMEM and a whole 128 x N f32
// score chunk beside it; a 128 x 4224 f32 chunk is 2.2 MB, ten times the
// 227 KB of shared memory a block may use.
//
// K4 is built for Hopper (hopper_attn.cuh): one pass with an online
// softmax. A block owns 64 query rows in one consumer warpgroup (two
// blocks an SM); a producer warp streams 128-key K and V tiles by TMA
// through a ring of stages; S = Q K^T is a wgmma product from shared
// memory whose accumulator the softmax reads in registers, and P, rounded
// to bf16 unnormalized, is the register A operand of O += P V. The grid's fastest axis is the query
// tile, so all query tiles of one (batch, head) run next to each other and
// share its K/V in L2, the card's analogue of the TPU kernel's resident K/V
// block.
//
// K5 and K6 are deterministic, with no atomics, and built for Hopper too,
// each on a block it shares with K2 (attention.cu), with no crop boundary
// and its own tile constants.
//
// K5, the dQ kernel, runs hopper::dq_block, K2's first launch: a block owns
// DQ_WGS * 64 query rows, Q and dO resident, one consumer warpgroup a
// 64-row box; it first computes delta = rowsum(dO * O) for them (saved for
// K6), then a producer warp streams every DQ_KEYS-key K/V tile by TMA
// through DQ_STAGES stages. S = Q K^T and dP = dO V^T are wgmma products
// from shared memory; dS stays in registers as the A operand of dQ += dS K.
// Keys past N load as zeros and get P = 0; the dQ store clips rows past N.
//
// K6, the dK/dV kernel, runs hopper::dkv_block, K2's second launch. A block
// owns DKV_WGS * 64 keys, K and V resident, one consumer warpgroup a 64-key
// box; a producer warp streams every 64-row Q/dO tile by TMA through
// DKV_STAGES stages with its lse and delta, and every warpgroup of the
// block reads each streamed tile. S^T = K Q^T and dP^T = V dO^T are wgmma
// products from shared memory; P^T and dS^T stay in registers as the A
// operands of dV += P^T dO and dK += dS^T Q. TMA fills rows past N with
// zeros, padded query rows get P = 0, and the dK/dV stores clip rows past N.

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
// K4: forward (wgmma + TMA)
// ----------------------------------------------------------------------------

// One consumer warpgroup a block, two blocks an SM, two stages: measured
// faster than two warpgroups or three stages (scripts/attention_variants.py;
// PERF.md).
constexpr int FWD_WGS = 1;                      // consumer warpgroups a block, 64 query rows each
constexpr int FWD_ROWS = 64 * FWD_WGS;          // query rows a block
constexpr int FWD_KEYS = 128;                   // keys a streamed K/V tile
constexpr int FWD_STAGES = 2;                   // K/V tiles in flight
constexpr int FWD_THREADS = 128 * FWD_WGS + 32; // + 1 producer warp

template <int D> struct FwdSmem {
  bf16 q[FWD_ROWS * D];                     // Q; each warpgroup's half stages its O at the end
  bf16 k[FWD_STAGES][FWD_KEYS * D];
  bf16 v[FWD_STAGES][FWD_KEYS * D];
  uint64_t full[FWD_STAGES], empty[FWD_STAGES], q_full;
};

// One pass with an online softmax. The producer warp loads the block's Q
// once and then K/V tiles into a ring of FWD_STAGES stages; each consumer
// warpgroup owns 64 query rows and, per tile, computes S = Q K^T (wgmma,
// both from shared memory) into registers, masks keys past N, updates its
// running max and sum, rescales O, and adds P V (P in registers as the A
// operand, V read MN-major). O is divided by the sum at the end, staged in
// shared memory and written by a TMA store that clips rows past N.
template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 2 / FWD_WGS)
long_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap o_map, float* __restrict__ lse, int N,
                int H, float scale_log2) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<D>& sm = aligned_smem<FwdSmem<D>>(smem_raw);
  constexpr uint32_t BOX = BOX_ROWS * D * 2;  // bytes of one 64-row box
  const int r0 = blockIdx.x * FWD_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ntiles = (N + FWD_KEYS - 1) / FWD_KEYS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4 * FWD_WGS);  // one arrival per consumer warp
    }
    mbar_init(&sm.q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * FWD_WGS) {  // producer
    if (lane == 0) {
      mbar_expect_tx(&sm.q_full, FWD_WGS * BOX);
      for (int g = 0; g < FWD_WGS; ++g)
        tma_load(sm.q + g * BOX_ROWS * D, &q_map, &sm.q_full, h, r0 + g * BOX_ROWS, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % FWD_STAGES;
        mbar_wait(&sm.empty[s], ((t / FWD_STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 4 * BOX);
        const int c0 = t * FWD_KEYS;
        tma_load(sm.k[s], &k_map, &sm.full[s], h, c0, b);
        tma_load(sm.k[s] + BOX_ROWS * D, &k_map, &sm.full[s], h, c0 + BOX_ROWS, b);
        tma_load(sm.v[s], &v_map, &sm.full[s], h, c0, b);
        tma_load(sm.v[s] + BOX_ROWS * D, &v_map, &sm.full[s], h, c0 + BOX_ROWS, b);
      }
    }
    return;
  }

  // consumers
  const int wg = warp / 4, wl = warp % 4;
  bf16* q_tile = sm.q + wg * BOX_ROWS * D;
  const uint64_t q_desc = make_desc<D>(q_tile);
  float o[D / 2];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows r, r + 8 (log2 units)
  mbar_wait(&sm.q_full, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % FWD_STAGES;
    mbar_wait(&sm.full[s], (t / FWD_STAGES) & 1);
    const uint64_t k_desc = make_desc<D>(sm.k[s]), v_desc = make_desc<D>(sm.v[s]);

    float sc[FWD_KEYS / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    const int c0 = t * FWD_KEYS;
    if (c0 + FWD_KEYS > N) {  // the ragged last tile: keys past N drop out
#pragma unroll
      for (int i = 0; i < FWD_KEYS / 2; ++i)
        if (c0 + acc_col(lane, i) >= N) sc[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < FWD_KEYS / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      // every tile holds key c0 < N, so the max is finite
      const float m_new = fmaxf(m[rr], mx[rr] * scale_log2);
      alpha[rr] = exp2f(m[rr] - m_new);
      m[rr] = m_new;
      l[rr] *= alpha[rr];
    }
#pragma unroll
    for (int i = 0; i < FWD_KEYS / 2; ++i) {
      const int rr = (i / 2) % 2;
      sc[i] = exp2f(fmaf(sc[i], scale_log2, -m[rr]));
      l[rr] += sc[i];  // this thread's share of the row sum; summed over the quad at the end
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

    uint32_t pa[FWD_KEYS / 16][4];  // P, bf16, as the A operand of each 16-key slice
#pragma unroll
    for (int kk = 0; kk < FWD_KEYS / 16; ++kk) to_a_operand(pa[kk], sc, kk);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FWD_KEYS / 16; ++kk)
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
    inv[rr] = 1.f / l[rr];  // a live row attends to at least one key, so l > 0
  }
  named_sync(1 + wg, 128);  // the warpgroup is done reading its Q rows
  stage_rows<D>(reinterpret_cast<unsigned char*>(q_tile), o, wl, lane, inv[0], inv[1]);
  fence_async_smem();
  named_sync(1 + wg, 128);
  const int row0 = r0 + wg * BOX_ROWS;
  if (wl == 0 && lane == 0) {
    tma_store(&o_map, q_tile, h, row0, b);
    tma_store_wait();
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + acc_row(wl, lane, 2 * rr);
      if (row < N) lse[((long long)b * H + h) * N + row] = (m[rr] + log2f(l[rr])) * LN2;
    }
  }
}

// ----------------------------------------------------------------------------
// K5: dQ, and delta for K6 (wgmma + TMA)
// ----------------------------------------------------------------------------

// Tile constants, timed against each other by scripts/attention_variants.py
// (PERF.md).
constexpr int DQ_WGS = 1;                      // consumer warpgroups a block, 64 query rows each
constexpr int DQ_KEYS = 64;                    // keys a streamed K/V tile: 64 or 128
constexpr int DQ_STAGES = 2;                   // K/V tiles in flight
constexpr int DQ_THREADS = 128 * DQ_WGS + 32;  // + 1 producer warp

// dQ = dS K for the block's query rows over every key tile, and delta:
// hopper::dq_block with every key live (boundary 0).
template <int D>
__global__ void __launch_bounds__(DQ_THREADS, DQ_KEYS == 64 ? 2 / DQ_WGS : 1)
long_dq_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap do_map,
               const __grid_constant__ CUtensorMap dq_map, const bf16* __restrict__ o,
               const float* __restrict__ lse, float* __restrict__ delta, int N, int H,
               float scale, float scale_log2) {
  hopper::dq_block<D, DQ_WGS, DQ_STAGES, DQ_KEYS>(&q_map, &k_map, &v_map, &do_map, &dq_map, o,
                                                  lse, delta, N, H, scale, scale_log2, 0);
}

// ----------------------------------------------------------------------------
// K6: dK, dV (wgmma + TMA)
// ----------------------------------------------------------------------------

// One consumer warpgroup a block, two blocks an SM, three stages: measured
// faster than two warpgroups a block (which also spill at d = 64) or two
// stages at every long shape (scripts/attention_variants.py; PERF.md).
constexpr int DKV_WGS = 1;                       // consumer warpgroups a block, 64 keys each
constexpr int DKV_STAGES = 3;                    // Q/dO tiles in flight
constexpr int DKV_THREADS = 128 * DKV_WGS + 32;  // + 1 producer warp

// dV = P^T dO and dK = dS^T Q for the block's keys over every query tile:
// hopper::dkv_block with every key live (boundary 0).
template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 2 / DKV_WGS)
long_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap dk_map,
                const __grid_constant__ CUtensorMap dv_map, const float* __restrict__ lse,
                const float* __restrict__ delta, int N, int H, float scale, float scale_log2) {
  hopper::dkv_block<D, DKV_WGS, DKV_STAGES>(&q_map, &k_map, &v_map, &do_map, &dk_map, &dv_map,
                                            lse, delta, N, H, scale, scale_log2, 0);
}

template <int D>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
               int B, int N, int H, long long sb, long long sn, long long sh,
               float scale, cudaStream_t stream, int device) {
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
  cudaError_t err = hopper::allow_smem(long_fwd_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  // query tiles fastest: one (batch, head)'s tiles run together and share its K/V in L2
  dim3 grid((N + FWD_ROWS - 1) / FWD_ROWS, H, B);
  long_fwd_kernel<D><<<grid, FWD_THREADS, smem, stream>>>(q_map, k_map, v_map, o_map, lse, N, H,
                                                          scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
              const float* lse, float* delta, bf16* dq, int B, int N, int H, long long sb,
              long long sn, long long sh, float scale, cudaStream_t stream, int device) {
  const cudaError_t bound = cudaSetDevice(device);  // see hopper::make_map
  if (bound != cudaSuccess) return bound;
  hopper::DqMaps maps;
  const CUresult res = hopper::make_dq_maps<D>(maps, q, k, v, dout, dq, B, N, H, sb, sn, sh);
  if (res != CUDA_SUCCESS) return hopper::MAP_ERROR + (int)res;
  const size_t smem = sizeof(hopper::DqSmem<D, DQ_WGS, DQ_STAGES, DQ_KEYS>) + 1024;
  static bool smem_set = false;
  cudaError_t err = hopper::allow_smem(long_dq_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  // query tiles fastest: one (batch, head)'s tiles run together and share its K/V in L2
  const int rows = DQ_WGS * hopper::BOX_ROWS;
  dim3 grid((N + rows - 1) / rows, H, B);
  long_dq_kernel<D><<<grid, DQ_THREADS, smem, stream>>>(
      maps.q, maps.k, maps.v, maps.dout, maps.dq, o, lse, delta, N, H, scale, scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
int launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
               const float* delta, bf16* dk, bf16* dv, int B, int N, int H, long long sb,
               long long sn, long long sh, float scale, cudaStream_t stream, int device) {
  const cudaError_t bound = cudaSetDevice(device);  // see hopper::make_map
  if (bound != cudaSuccess) return bound;
  hopper::DkvMaps maps;
  const CUresult res = hopper::make_dkv_maps<D>(maps, q, k, v, dout, dk, dv, B, N, H, sb, sn, sh);
  if (res != CUDA_SUCCESS) return hopper::MAP_ERROR + (int)res;
  const size_t smem = sizeof(hopper::DkvSmem<D, DKV_WGS, DKV_STAGES>) + 1024;
  static bool smem_set = false;
  cudaError_t err = hopper::allow_smem(long_dkv_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  // key blocks fastest: one (batch, head)'s blocks run together and share its Q/dO in L2
  const int rows = DKV_WGS * hopper::BOX_ROWS;
  dim3 grid((N + rows - 1) / rows, H, B);
  long_dkv_kernel<D><<<grid, DKV_THREADS, smem, stream>>>(
      maps.q, maps.k, maps.v, maps.dout, maps.dk, maps.dv, lse, delta, N, H, scale, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, N, H, D) bf16 sharing strides (sb, sn, sh) with unit stride
// in D; o: contiguous (B, N, H, D) bf16; lse: (B, H, N) f32; `device`: the
// CUDA device of the tensors and the stream.
extern "C" int dinomc_long_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int N, int H, int D, long long sb,
                                    long long sn, long long sh, float scale, void* stream,
                                    int device) {
  const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k, *vp = (const bf16*)v;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_fwd<16>(qp, kp, vp, (bf16*)o, (float*)lse, B, N, H, sb, sn, sh, scale, st, device);
    case 32: return launch_fwd<32>(qp, kp, vp, (bf16*)o, (float*)lse, B, N, H, sb, sn, sh, scale, st, device);
    case 64: return launch_fwd<64>(qp, kp, vp, (bf16*)o, (float*)lse, B, N, H, sb, sn, sh, scale, st, device);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As above, plus o, dout, dq contiguous (B, N, H, D) bf16 and delta (B, H, N)
// f32, written here and read by dinomc_long_attn_dkv; `device` as above.
extern "C" int dinomc_long_attn_dq(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   int B, int N, int H, int D, long long sb, long long sn,
                                   long long sh, float scale, void* stream, int device) {
  const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k, *vp = (const bf16*)v;
  const bf16 *op = (const bf16*)o, *dop = (const bf16*)dout;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_dq<16>(qp, kp, vp, op, dop, (const float*)lse, (float*)delta, (bf16*)dq, B, N, H, sb, sn, sh, scale, st, device);
    case 32: return launch_dq<32>(qp, kp, vp, op, dop, (const float*)lse, (float*)delta, (bf16*)dq, B, N, H, sb, sn, sh, scale, st, device);
    case 64: return launch_dq<64>(qp, kp, vp, op, dop, (const float*)lse, (float*)delta, (bf16*)dq, B, N, H, sb, sn, sh, scale, st, device);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, k, v as above; dout, dk, dv contiguous (B, N, H, D) bf16; lse and
// delta (B, H, N) f32; `device` as above.
extern "C" int dinomc_long_attn_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int N, int H, int D,
                                    long long sb, long long sn, long long sh, float scale,
                                    void* stream, int device) {
  const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k, *vp = (const bf16*)v;
  const bf16* dop = (const bf16*)dout;
  const float *lp = (const float*)lse, *dp = (const float*)delta;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_dkv<16>(qp, kp, vp, dop, lp, dp, (bf16*)dk, (bf16*)dv, B, N, H, sb, sn, sh, scale, st, device);
    case 32: return launch_dkv<32>(qp, kp, vp, dop, lp, dp, (bf16*)dk, (bf16*)dv, B, N, H, sb, sn, sh, scale, st, device);
    case 64: return launch_dkv<64>(qp, kp, vp, dop, lp, dp, (bf16*)dk, (bf16*)dv, B, N, H, sb, sn, sh, scale, st, device);
    default: return (int)cudaErrorInvalidValue;
  }
}
