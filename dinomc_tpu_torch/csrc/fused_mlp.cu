// Fused transformer MLP, forward (K11), for sm_90a: out = GELU(x W1^T + b1) W2^T + b2.
//
// Replaces: dinomc_tpu/ops/pallas/fused_mlp.py, `_fused_mlp` (`_kernel`).
//
// What it computes: x (M, D) bf16, W1 (F, D) and W2 (D, F) bf16 as the
// port's Linear layers hold them ((out, in), row-major), b1 (F,) and b2 (D,)
// bf16. The hidden activation u = x W1^T is accumulated in f32, gets b1 in
// f32 and GELU in f32 (tanh form or erf, by `approx`), and is rounded to bf16
// only as the second product's operand; that product accumulates in f32,
// gets b2 in f32 and is rounded once to bf16. The backward is plain PyTorch
// (ops/hopper/fused_mlp.py), as the TPU kernel's is plain XLA.
//
// What bounds it on this card: at ViT-S and the DINO global crops (M =
// 12,560, D = 384, F = 1536) the two products are 4 M D F = 29.6 GFLOP,
// 30 us at 989 TFLOP/s bf16, against 2 M D + 2 D F bf16 values of traffic
// (21.7 MB, 6.5 us at 3.35 TB/s): bound by operations. The unfused form also
// writes and reads back the (M, F) hidden activation, 77 MB more.
//
// Design (hopper_attn.cuh's means): the TPU kernel kept both weight
// matrices resident in VMEM (2.4 MB at ViT-S); here they are far past the
// 227 KB of shared memory a block may use, so a block streams them.
// - A block owns a row tile of 64 * RG rows and walks F in chunks of FC. A
//   producer warpgroup (one thread issuing) TMA-loads the row tile once, as
//   D/64 boxes of 64 columns in the 128-byte swizzle (rows past M arrive as
//   zeros), and streams each chunk's FC rows of W1 and FC columns of W2
//   (the Linear layout is K-major for both products: no transposed copy)
//   through a ring of STAGES mbarrier-tracked stages.
// - RG * CS consumer warpgroups: warpgroup (r, c) owns rows [64r, 64r + 64)
//   of the tile and output columns [c D/CS, (c + 1) D/CS), an f32
//   accumulator of 64 x D/CS in registers. For each chunk it forms its FC/CS
//   columns of u = x W1c^T with wgmma from shared memory (f32 registers),
//   adds b1 and applies GELU in registers, and rounds to bf16:
//   - CS = 1: the rounded chunk is packed straight into the register A
//     operand of acc += h W2c^T (to_a_operand, as P V in the attention
//     kernels), W2c read K-major from shared memory; u never leaves the
//     registers.
//   - CS = 2: the two warpgroups of a row group store their halves of h as
//     one swizzled bf16 tile (double-buffered by chunk), meet at a named
//     barrier, and each runs acc += h W2c^T for its half of the columns from
//     that tile; no product is computed twice.
// - The epilogue adds b2 in f32, rounds once, stages the warpgroup's output
//   in its own rows of the row tile (128-byte swizzle) and leaves by TMA
//   stores that clip rows past M.
// Registers: at D = 384 one warpgroup's 64 x 384 strip is 192 f32 a thread,
// plus 16 of u and 8 of the packed chunk at FC = 32. A block of two consumer
// warpgroups and the producer (384 threads, 168 registers a thread at
// entry) moves them with setmaxnreg: the producer down to 24, the consumers
// up to 240. At D = 768 the strip is split over two warpgroups (CS = 2).
// Weight traffic: every row tile streams both weight matrices (2.36 MB at
// ViT-S) from L2; 128-row tiles make that 99 x 2.36 = 234 MB of L2 reads a
// call at M = 12,560, half of what 64-row tiles would read, in one wave of
// 99 blocks on 132 SMs. TMA multicast of the weights over a cluster is not
// used. The tile constants are timed against each other by
// scripts/attention_variants.py --kernels K11 (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_attn.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace hopper;

// The ViT-S width's tile (D = 384): rows a block / 64, column split, hidden
// chunk and stages. Two row groups of 64 with no split hold the 64 x 384
// strip in 240 registers; a chunk of 64 would need 240 for the strip and
// the chunk alone, and a third stage does not fit beside the 96 KB row tile.
constexpr int MLP384_ROW_GROUPS = 2;
constexpr int MLP384_COL_SPLIT = 1;
constexpr int MLP384_CHUNK = 32;
constexpr int MLP384_STAGES = 2;

template <int D> struct Cfg;
template <> struct Cfg<192> { static constexpr int RG = 2, CS = 1, FC = 64, STAGES = 3; };
template <> struct Cfg<384> {
  static constexpr int RG = MLP384_ROW_GROUPS, CS = MLP384_COL_SPLIT, FC = MLP384_CHUNK,
                       STAGES = MLP384_STAGES;
};
template <> struct Cfg<768> { static constexpr int RG = 1, CS = 2, FC = 32, STAGES = 1; };

// The hidden chunk's bf16 tiles a row group shares when its columns are
// split (CS = 2); nothing otherwise.
template <int RG, int FC, bool SHARED> struct HiddenTiles {
  alignas(1024) bf16 h[2][RG][64 * FC];
};
template <int RG, int FC> struct HiddenTiles<RG, FC, false> {};

template <int D, int RG, int CS, int FC, int STAGES> struct MlpSmem {
  alignas(1024) bf16 x[D / 64][64 * RG * 64];   // row tile: D/64 boxes of (64 RG rows, 64 cols)
  alignas(1024) bf16 w1[STAGES][D / 64][FC * 64];  // W1's chunk rows: D/64 boxes of (FC, 64)
  alignas(1024) bf16 w2[STAGES][D * FC];           // W2's chunk columns: (D rows, FC cols)
  HiddenTiles<RG, FC, (CS > 1)> hid;
  uint64_t full[STAGES], empty[STAGES], x_full;
};

template <int D, int RG, int CS, int FC, int STAGES> struct Mlp {
  static constexpr int NWG = RG * CS;              // consumer warpgroups
  static constexpr int THREADS = 128 * (NWG + 1);  // and the producer's
  static constexpr int BM = 64 * RG;               // rows a block
  static constexpr int DW = D / CS;                // output columns a consumer
  static constexpr int FW = FC / CS;               // hidden columns of a chunk a consumer forms
  static constexpr int NP = DW / 192;              // its m64n192 accumulators
  static constexpr int KB = D / 64;                // 64-column boxes of a row
  // Registers a thread: the launch bound's at entry; setmaxnreg then gives
  // the producer 24 and the consumers what that frees, at most 240.
  static constexpr int ENTRY = 65536 / THREADS / 8 * 8;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int SPARE = (ENTRY * THREADS - PRODUCER_REGS * 128) / (128 * NWG) / 8 * 8;
  static constexpr int CONSUMER_REGS = SPARE > 240 ? 240 : SPARE;
  using Smem = MlpSmem<D, RG, CS, FC, STAGES>;
  static constexpr size_t SMEM = sizeof(Smem) + 1024;
  static_assert(D % 64 == 0 && DW % 192 == 0, "D/CS a multiple of 192");
  static_assert(FW == 16 || FW == 32 || FW == 64 || FW == 128, "FC/CS in 16..128");
  static_assert(FC == 16 || FC == 32 || FC == 64, "FC in 16..64 (a swizzled W2 row)");
  static_assert(CS == 1 || CS == 2, "column split 1 or 2");
  static_assert(NWG >= 2, "setmaxnreg moves registers from the producer to consumers");
  static_assert(1 + RG + NWG <= 16, "named barriers");
};

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool APPROX>
__device__ __forceinline__ float gelu(float u) {
  if constexpr (APPROX) {
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * u * (1.f + tanh_approx(k * fmaf(0.044715f * u, u * u, u)));
  } else {
    return 0.5f * u * (1.f + erff(u * 0.7071067811865476f));
  }
}

__device__ __forceinline__ float2 bf16_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <int D, int RG, int CS, int FC, int STAGES, bool APPROX>
__global__ void __launch_bounds__(Mlp<D, RG, CS, FC, STAGES>::THREADS, 1)
fused_mlp_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap w1_map,
                 const __grid_constant__ CUtensorMap w2_map,
                 const __grid_constant__ CUtensorMap out_map, const bf16* __restrict__ b1,
                 const bf16* __restrict__ b2, int F) {
  using C = Mlp<D, RG, CS, FC, STAGES>;
  constexpr int FW = C::FW, DW = C::DW, NP = C::NP;
  extern __shared__ unsigned char smem_raw[];
  typename C::Smem& sm = aligned_smem<typename C::Smem>(smem_raw);
  const int m0 = blockIdx.x * C::BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4, wl = warp % 4;
  const int nchunks = F / FC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4 * C::NWG);  // one arrival per consumer warp
    }
    mbar_init(&sm.x_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == C::NWG) {  // producer
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (wl == 0 && lane == 0) {
      mbar_expect_tx(&sm.x_full, C::BM * D * 2);
      for (int j = 0; j < C::KB; ++j) tma_load_2d(sm.x[j], &x_map, &sm.x_full, m0, 64 * j);
      for (int t = 0; t < nchunks; ++t) {
        const int s = t % STAGES, f0 = t * FC;
        mbar_wait(&sm.empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * FC * D * 2);
        for (int j = 0; j < C::KB; ++j) {
          tma_load_2d(sm.w1[s][j], &w1_map, &sm.full[s], f0, 64 * j);
          tma_load_2d(sm.w2[s] + j * 64 * FC, &w2_map, &sm.full[s], 64 * j, f0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup (r, c)
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int r = wg / CS, c = wg % CS;
  constexpr uint64_t X_BOX = (uint64_t)(C::BM * 64 * 2) >> 4;  // descriptor units a box
  constexpr uint64_t W1_BOX = (uint64_t)(FC * 64 * 2) >> 4;
  constexpr uint64_t W2_PART = (uint64_t)(192 * FC * 2) >> 4;  // 192 rows of W2's chunk
  const uint64_t x_desc = make_desc<64>(sm.x[0] + r * 64 * 64);
  float acc[NP][96];
#pragma unroll
  for (int p = 0; p < NP; ++p) zero(acc[p]);
  mbar_wait(&sm.x_full, 0);

  for (int t = 0; t < nchunks; ++t) {
    const int s = t % STAGES, f0 = t * FC;
    mbar_wait(&sm.full[s], (t / STAGES) & 1);
    const uint64_t w1_desc = make_desc<64>(sm.w1[s][0] + c * FW * 64);
    const uint64_t w2_desc = make_desc<FC>(sm.w2[s] + c * DW * FC);

    // this warpgroup's FW columns of the chunk of u = x W1^T, f32
    float u[FW / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<FW>(u, x_desc + (kk / 4) * X_BOX + 2 * (kk % 4),
                   w1_desc + (kk / 4) * W1_BOX + 2 * (kk % 4), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(u);

    // + b1 and GELU in f32
    const bf16* b1c = b1 + f0 + c * FW;
#pragma unroll
    for (int i = 0; i < FW / 2; i += 2) {
      const float2 bb = bf16_pair(b1c + acc_col(lane, i));
      u[i] = gelu<APPROX>(u[i] + bb.x);
      u[i + 1] = gelu<APPROX>(u[i + 1] + bb.y);
    }

    // acc += h W2c^T, h = the chunk rounded to bf16
    if constexpr (CS == 1) {
      uint32_t ha[FC / 16][4];  // the register A operand of each 16-deep slice
#pragma unroll
      for (int kk = 0; kk < FC / 16; ++kk) to_a_operand(ha[kk], u, kk);
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FC / 16; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p) wgmma_rs_k_n192(acc[p], ha[kk], w2_desc + p * W2_PART + 2 * kk);
    } else {
      bf16* ht = sm.hid.h[t % 2][r];
      unsigned char* hb = reinterpret_cast<unsigned char*>(ht);
#pragma unroll
      for (int i = 0; i < FW / 2; i += 2) {
        const int row = acc_row(wl, lane, i), col = c * FW + acc_col(lane, i);
        *reinterpret_cast<uint32_t*>(hb + swz<FC>(row * FC * 2 + col * 2)) =
            pack_bf16(u[i], u[i + 1]);
      }
      fence_async_smem();
      named_sync(1 + r, 256);  // both halves of the row group's chunk are stored
      const uint64_t h_desc = make_desc<FC>(ht);
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FC / 16; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          wgmma_ss_n192(acc[p], h_desc + 2 * kk, w2_desc + p * W2_PART + 2 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  // Epilogue: + b2 in f32, rounded once, staged in the warpgroup's own rows
  // of the row tile (a split row group first waits until its partner has
  // read them for the last time), then TMA stores that clip rows past M.
  if constexpr (CS > 1) named_sync(1 + r, 256);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int i = 0; i < 96; i += 2) {
      const int row = acc_row(wl, lane, i), col = c * DW + p * 192 + acc_col(lane, i);
      const float2 bb = bf16_pair(b2 + col);
      unsigned char* box = reinterpret_cast<unsigned char*>(sm.x[col / 64] + r * 64 * 64);
      *reinterpret_cast<uint32_t*>(box + swz<64>(row * 128 + (col % 64) * 2)) =
          pack_bf16(acc[p][i] + bb.x, acc[p][i + 1] + bb.y);
    }
  }
  fence_async_smem();
  named_sync(1 + RG + wg, 128);
  if (wl == 0 && lane == 0) {
    for (int b = c * DW / 64; b < (c + 1) * DW / 64; ++b)
      tma_store_2d(&out_map, sm.x[b] + r * 64 * 64, m0 + r * 64, 64 * b);
    tma_store_wait();
  }
}

template <int D, bool APPROX>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int M, int F, cudaStream_t stream) {
  using G = Cfg<D>;
  using C = Mlp<D, G::RG, G::CS, G::FC, G::STAGES>;
  if (F % G::FC != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap x_map, w1_map, w2_map, out_map;
  CUresult res = make_map_2d(&x_map, x, M, D, D, C::BM, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (res == CUDA_SUCCESS)
    res = make_map_2d(&w1_map, w1, F, D, D, G::FC, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (res == CUDA_SUCCESS) res = make_map_2d(&w2_map, w2, D, F, F, 64, G::FC, Swizzle<G::FC>::TMA);
  if (res == CUDA_SUCCESS)
    res = make_map_2d(&out_map, out, M, D, D, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (res != CUDA_SUCCESS) return MAP_ERROR + (int)res;
  auto kernel = fused_mlp_kernel<D, G::RG, G::CS, G::FC, G::STAGES, APPROX>;
  static bool allowed = false;
  cudaError_t err = allow_smem(kernel, C::SMEM, allowed);
  if (err != cudaSuccess) return (int)err;
  // setmaxnreg hands out the registers the block holds at entry: with
  // fewer than ENTRY a thread, the consumers' request would wait forever
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    regs = attr.numRegs;
  }
  if (regs != C::ENTRY) return (int)cudaErrorInvalidConfiguration;
  const int grid = (M + C::BM - 1) / C::BM;
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(x_map, w1_map, w2_map, out_map,
                                                 (const bf16*)b1, (const bf16*)b2, F);
  return (int)cudaGetLastError();
}

template <int D>
int launch_gelu(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                void* out, int M, int F, int approx, cudaStream_t stream) {
  return approx ? launch<D, true>(x, w1, b1, w2, b2, out, M, F, stream)
                : launch<D, false>(x, w1, b1, w2, b2, out, M, F, stream);
}

}  // namespace

// x: (M, D) bf16 contiguous; w1: (F, D), b1: (F,), w2: (D, F), b2: (D,),
// all bf16 contiguous; out: (M, D) bf16 contiguous; every pointer 16-byte
// aligned. D is 192, 384 or 768 and F a multiple of the width's chunk (64,
// MLP384_CHUNK, 32); M > 0 and any. `device`: the CUDA device of the
// tensors and the stream.
extern "C" int dinomc_fused_mlp(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out, int M, int D,
                                int F, int approx, void* stream, int device) {
  const cudaError_t bound = cudaSetDevice(device);  // see hopper::make_map
  if (bound != cudaSuccess) return (int)bound;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 192: return launch_gelu<192>(x, w1, b1, w2, b2, out, M, F, approx, st);
    case 384: return launch_gelu<384>(x, w1, b1, w2, b2, out, M, F, approx, st);
    case 768: return launch_gelu<768>(x, w1, b1, w2, b2, out, M, F, approx, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
