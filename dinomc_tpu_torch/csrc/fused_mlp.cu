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
// Design: the TPU kernel kept both weight matrices resident in VMEM (2.4 MB
// at ViT-S); here they are far past the 227 KB of shared memory a block may
// use. So a block of 8 warps owns a tile of BM rows and keeps its (BM, D) f32
// output accumulator in registers (BM * D = 24,576 values, 96 a thread, at
// every width: BM = 128, 64, 32 for D = 192, 384, 768). It walks F in chunks
// of FC: it stages the chunk's rows of W1 and columns of W2 in shared memory,
// forms the (BM, FC) chunk of u from the x tile (staged once) with WMMA bf16
// 16x16x16, adds b1 and applies GELU in f32, rounds to bf16 in shared memory,
// and adds the chunk's product with W2 into the accumulator. The hidden
// activation never reaches device memory; the weights are read once per row
// tile (from L2 after the first tile). Rows past M are zero in the x tile and
// never written. Loads are synchronous 16-byte loads; cp.async/TMA
// pipelining and wgmma are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

// Row tile BM and hidden chunk FC by width: BM * D = 24,576 f32
// accumulators a block, and the two weight chunks within 61 KB each.
template <int D> struct Tile;
template <> struct Tile<192> { static constexpr int BM = 128, FC = 64; };
template <> struct Tile<384> { static constexpr int BM = 64, FC = 64; };
template <> struct Tile<768> { static constexpr int BM = 32, FC = 32; };

template <int D> struct Layout {
  static constexpr int BM = Tile<D>::BM, FC = Tile<D>::FC;
  static constexpr int LDX = D + 8;   // bf16 pitch of the x and W1-chunk tiles
  static constexpr int LDW2 = FC + 8; // bf16 pitch of the W2-chunk tile (D rows)
  static constexpr int LDU = FC + 4;  // f32 pitch of the u chunk
  static constexpr int LDH = FC + 8;  // bf16 pitch of the GELU chunk
  static constexpr int LDE = 16 + 4;  // f32 pitch of a warp's epilogue tile
  static constexpr size_t X_BYTES = (size_t)BM * LDX * 2;
  static constexpr size_t W1_BYTES = (size_t)FC * LDX * 2;
  static constexpr size_t W2_BYTES = (size_t)D * LDW2 * 2;
  static constexpr size_t U_BYTES = (size_t)BM * LDU * 4;
  static constexpr size_t H_BYTES = (size_t)BM * LDH * 2;
  static constexpr size_t E_BYTES = (size_t)NWARPS * 16 * LDE * 4;
  static constexpr size_t SMEM = X_BYTES + W1_BYTES + W2_BYTES + U_BYTES + H_BYTES + E_BYTES;
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float gelu(float u, int approx) {
  if (approx) {
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * u * (1.f + tanhf(k * (u + 0.044715f * u * u * u)));
  }
  return 0.5f * u * (1.f + erff(u * 0.7071067811865476f));
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
fused_mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                 const bf16* __restrict__ b2, bf16* __restrict__ out, int M, int F,
                 int approx) {
  typedef Layout<D> L;
  constexpr int BM = L::BM, FC = L::FC, LDX = L::LDX, LDW2 = L::LDW2, LDU = L::LDU,
                LDH = L::LDH, LDE = L::LDE;
  constexpr int RS = BM / 16;          // row strips of the tile
  constexpr int WPS = NWARPS / RS;     // warps a row strip
  constexpr int CT = D / 16 / WPS;     // output column tiles a warp
  constexpr int HT = RS * (FC / 16);   // u tiles of a chunk
  static_assert(RS * WPS == NWARPS && CT * WPS * 16 == D, "tile split");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* W1s = reinterpret_cast<bf16*>(smem + L::X_BYTES);
  bf16* W2s = reinterpret_cast<bf16*>(smem + L::X_BYTES + L::W1_BYTES);
  float* Us = reinterpret_cast<float*>(smem + L::X_BYTES + L::W1_BYTES + L::W2_BYTES);
  bf16* Hs = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(Us) + L::U_BYTES);
  float* Es = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Hs) + L::H_BYTES);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM;
  const int rs = warp % RS, c0 = (warp / RS) * CT;  // this warp's row strip, first column tile

  for (int i = threadIdx.x; i < BM * (D / 8); i += NTHREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M) val = *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * D + c);
    *reinterpret_cast<uint4*>(Xs + r * LDX + c) = val;
  }

  FragC acc[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int f0 = 0; f0 < F; f0 += FC) {
    __syncthreads();  // the previous chunk's W1s, W2s and Hs are no longer read
    for (int i = threadIdx.x; i < FC * (D / 8); i += NTHREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(W1s + r * LDX + c) =
          *reinterpret_cast<const uint4*>(w1 + (long long)(f0 + r) * D + c);
    }
    for (int i = threadIdx.x; i < D * (FC / 8); i += NTHREADS) {
      const int r = i / (FC / 8), c = (i % (FC / 8)) * 8;
      *reinterpret_cast<uint4*>(W2s + r * LDW2 + c) =
          *reinterpret_cast<const uint4*>(w2 + (long long)r * F + f0 + c);
    }
    __syncthreads();

    // u chunk = x W1[f0:f0+FC]^T, f32
    for (int t = warp; t < HT; t += NWARPS) {
      const int tr = t / (FC / 16), tc = t % (FC / 16);
      FragC u;
      wmma::fill_fragment(u, 0.f);
#pragma unroll 4
      for (int kt = 0; kt < D / 16; ++kt) {
        FragA a;
        FragBCol b;
        wmma::load_matrix_sync(a, Xs + tr * 16 * LDX + kt * 16, LDX);
        wmma::load_matrix_sync(b, W1s + tc * 16 * LDX + kt * 16, LDX);
        wmma::mma_sync(u, a, b, u);
      }
      wmma::store_matrix_sync(Us + tr * 16 * LDU + tc * 16, u, LDU, wmma::mem_row_major);
    }
    __syncthreads();

    // h = GELU(u + b1) in f32, rounded to bf16
    for (int i = threadIdx.x; i < BM * FC; i += NTHREADS) {
      const int r = i / FC, c = i % FC;
      const float u = Us[r * LDU + c] + __bfloat162float(b1[f0 + c]);
      Hs[r * LDH + c] = __float2bfloat16(gelu(u, approx));
    }
    __syncthreads();

    // acc += h W2[:, f0:f0+FC]^T
#pragma unroll
    for (int kt = 0; kt < FC / 16; ++kt) {
      FragA a;
      wmma::load_matrix_sync(a, Hs + rs * 16 * LDH + kt * 16, LDH);
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        FragBCol b;
        wmma::load_matrix_sync(b, W2s + (c0 + j) * 16 * LDW2 + kt * 16, LDW2);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }

  // Epilogue, per warp: each 16x16 tile through shared memory, + b2 in f32,
  // one 16-byte store of 8 bf16 a lane.
  float* E = Es + warp * 16 * LDE;
  const int er = lane / 2, ec = (lane % 2) * 8;
  const int row = m0 + rs * 16 + er;
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    wmma::store_matrix_sync(E, acc[j], LDE, wmma::mem_row_major);
    __syncwarp();
    const int col = (c0 + j) * 16 + ec;
    if (row < M) {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float a0 = E[er * LDE + ec + 2 * q] + __bfloat162float(b2[col + 2 * q]);
        const float a1 = E[er * LDE + ec + 2 * q + 1] + __bfloat162float(b2[col + 2 * q + 1]);
        __nv_bfloat162 p = __floats2bfloat162_rn(a0, a1);
        w[q] = *reinterpret_cast<uint32_t*>(&p);
      }
      *reinterpret_cast<uint4*>(out + (long long)row * D + col) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncwarp();
  }
}

template <int D>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int M, int F, int approx, cudaStream_t stream) {
  const size_t smem = Layout<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (M + Tile<D>::BM - 1) / Tile<D>::BM;
  fused_mlp_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)w1, (const bf16*)b1, (const bf16*)w2, (const bf16*)b2,
      (bf16*)out, M, F, approx);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, D) bf16 contiguous; w1: (F, D), b1: (F,), w2: (D, F), b2: (D,),
// all bf16 contiguous; out: (M, D) bf16 contiguous. D is 192, 384 or 768 and
// F a multiple of the width's chunk (64, 64, 32); M > 0 and any.
extern "C" int dinomc_fused_mlp(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out, int M, int D,
                                int F, int approx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 192: return launch<192>(x, w1, b1, w2, b2, out, M, F, approx, st);
    case 384: return launch<384>(x, w1, b1, w2, b2, out, M, F, approx, st);
    case 768: return launch<768>(x, w1, b1, w2, b2, out, M, F, approx, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
