// Swin window attention with the heads of a window stacked in one block:
// forward (K9) and backward (K10), for sm_90a.
//
// Replaces: dinomc_tpu/ops/pallas/window_attention.py, `_pwas_fwd`
// (`_fwd_stacked_kernel`) and `_pwas_bwd` (`_bwd_stacked_kernel`), the
// `variant='stacked'` of `packed_window_attention`.
//
// What it computes: the same function as K7/K8 (csrc/window_attention.cu):
// for every window w (49 tokens) and head h (head_dim 32),
// softmax(Q K^T * scale + bias[h] + mask[w mod nW]) V, and in the backward
// dQ, dK, dV and dbias[h] = the sum of dS over all windows, in f32.
//
// What bounds it on this card: as K7/K8, memory traffic and latency, not
// the tensor cores: a (window, head) is about 25 FLOP a byte forward and 35
// backward, against the card's ~295.
//
// K9's design: the TPU variant's idea, not its operands. Its idea is all the
// heads of a window in one unit of work; on the TPU that meant
// block-stacked, zero-masked K' and V' operands (`_stack_heads`) filling a
// 128-wide systolic array with zeros, and none of that is kept. Here a
// block owns a chunk of hc <= 8 heads over a range of consecutive windows,
// one warp a head. Per window it reads the q/k/v rows of its hc heads as
// contiguous runs of hc * 32 channels in 16-byte loads (K7 reads one head's
// 64 bytes a token), and loads the window's mask once for all its heads (K7
// loads it once per head). Each warp pads its head's window from 49 to 64
// rows in shared memory for WMMA bf16 16x16x16 (keys past 49 at -inf, rows
// past 49 never written) and walks the 64 query rows in four 16-row strips,
// so its scores are staged a strip at a time; bias[h] is read from global
// memory (L1/L2), not staged.
//
// K10's design keeps the same idea on the card's means (hopper_window.cuh,
// window_bwd_block): a block owns a chunk of HC heads over a range of
// consecutive windows, one consumer warpgroup a head; a producer warp
// TMA-loads each window's Q, K, V and dO boxes for the chunk's heads and its
// mask, once for all of them, through a ring of WINS_BWD_STAGES stages; the
// five products are wgmma; dQ, dK, dV leave by TMA stores. dbias is
// deterministic, with no atomics: each thread owns fixed elements of its
// head's sum across the block's windows, the block writes one (HC, 49, 49)
// partial, and a second kernel sums the partials in a fixed order, as K8's
// does. The wrapper sizes the grid to one wave of resident blocks, so the
// partials are few.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "hopper_window.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int WW = 49;        // tokens a window
constexpr int WW2 = WW * WW;  // bias / mask elements of one head or window
constexpr int R = 64;         // rows a window is padded to
constexpr int HD = 32;        // head dim
constexpr int LDS = R + 4;    // f32 strip pitch
constexpr int LDP = R + 8;    // bf16 P / dS pitch
constexpr int MAX_FWD_HEADS = 8;

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }
constexpr size_t MASK_BYTES = align128((size_t)WW2 * 4);
constexpr size_t STRIP_BYTES = (size_t)16 * LDS * 4;      // one f32 16-row strip
constexpr size_t PSTRIP_BYTES = (size_t)16 * LDP * 2;     // one bf16 16-row strip
constexpr size_t FWD_WARP_BYTES = STRIP_BYTES + PSTRIP_BYTES;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Pitch of a (64, hc * 32) bf16 window tile.
__host__ __device__ __forceinline__ int tile_pitch(int hc) { return hc * HD + 8; }

// Zero rows [WW, R) of a window tile: they stay zero, window to window.
__device__ __forceinline__ void zero_pad_rows(bf16* t, int ldc) {
  for (int i = threadIdx.x; i < (R - WW) * ldc; i += blockDim.x)
    t[WW * ldc + i] = __float2bfloat16(0.f);
}

// Rows 0..48 of one window for the block's hc heads: hc * 32 contiguous bf16
// a row, in 16-byte loads (the wrapper checks 16-byte alignment).
__device__ __forceinline__ void load_window(bf16* dst, int ldc, const bf16* src,
                                            long long sn, int hc) {
  const int per_row = hc * HD / 8;
  for (int i = threadIdx.x; i < WW * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * 8;
    *reinterpret_cast<uint4*>(dst + r * ldc + c) =
        *reinterpret_cast<const uint4*>(src + (long long)r * sn + c);
  }
}

// out (16 x 64 f32, pitch LDS) = A (16 x 32, pitch lda) * B^T, B a (64 x 32)
// row-major tile (pitch ldb): Q K^T and dO V^T for one strip.
__device__ __forceinline__ void strip_abt(float* out, const bf16* a, int lda, const bf16* b,
                                          int ldb) {
  FragA af[HD / 16];
#pragma unroll
  for (int kt = 0; kt < HD / 16; ++kt) wmma::load_matrix_sync(af[kt], a + kt * 16, lda);
#pragma unroll
  for (int nt = 0; nt < R / 16; ++nt) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kt = 0; kt < HD / 16; ++kt) {
      FragBCol bf;
      wmma::load_matrix_sync(bf, b + nt * 16 * ldb + kt * 16, ldb);
      wmma::mma_sync(acc, af[kt], bf, acc);
    }
    wmma::store_matrix_sync(out + nt * 16, acc, LDS, wmma::mem_row_major);
  }
}

// out (16 x 32 f32, pitch LDS) = A (16 x 64 bf16, pitch LDP) * B (64 x 32
// row-major, pitch ldb): P V for one strip.
__device__ __forceinline__ void strip_ab(float* out, const bf16* a, const bf16* b, int ldb) {
  FragC acc[HD / 16];
#pragma unroll
  for (int dt = 0; dt < HD / 16; ++dt) wmma::fill_fragment(acc[dt], 0.f);
#pragma unroll
  for (int kt = 0; kt < R / 16; ++kt) {
    FragA af;
    wmma::load_matrix_sync(af, a + kt * 16, LDP);
#pragma unroll
    for (int dt = 0; dt < HD / 16; ++dt) {
      FragBRow bf;
      wmma::load_matrix_sync(bf, b + kt * 16 * ldb + dt * 16, ldb);
      wmma::mma_sync(acc[dt], af, bf, acc[dt]);
    }
  }
#pragma unroll
  for (int dt = 0; dt < HD / 16; ++dt)
    wmma::store_matrix_sync(out + dt * 16, acc[dt], LDS, wmma::mem_row_major);
}

// 16 f32 values (times mul) -> 16 bf16 as two 16-byte stores.
__device__ __forceinline__ void store16(bf16* dst, const float* src, float mul) {
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    __nv_bfloat162 p = __floats2bfloat162_rn(src[2 * j] * mul, src[2 * j + 1] * mul);
    w[j] = *reinterpret_cast<uint32_t*>(&p);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(w[0], w[1], w[2], w[3]);
  d[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// The probabilities of window row `row` (lanes 2r' and 2r'+1 of a warp
// share it and take the even and odd columns; column c = 2j + half) from
// its staged scores `srow`: logits with bias and mask, dead entries -inf,
// then an exact f32 softmax (the two lanes combine through one shuffle).
// Rows past 49 give zeros.
__device__ __forceinline__ void row_probs(float* s, const float* srow, const float* bias_h,
                                          const float* Ms, int mask_rows, int row, int half,
                                          float scale) {
  const float* mrow = Ms ? Ms + (mask_rows == 1 ? 0 : row) * WW : nullptr;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = 2 * j + half;
    float v = -INFINITY;
    if (row < WW && c < WW) {
      v = srow[c] * scale + __ldg(bias_h + row * WW + c);
      if (mrow) v += mrow[c];
    }
    s[j] = v;
  }
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < 32; ++j) mx = fmaxf(mx, s[j]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    s[j] = row < WW ? expf(s[j] - mx) : 0.f;
    sum += s[j];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  const float inv = row < WW ? 1.f / sum : 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] *= inv;
}

// ----------------------------------------------------------------------------
// K9: forward
// ----------------------------------------------------------------------------

__global__ void __launch_bounds__(MAX_FWD_HEADS * 32)
wins_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ bias,
                const float* __restrict__ mask, bf16* __restrict__ o, int nB, int hc,
                int nW, int mask_rows, int wpc, long long sw, long long sn, long long osw,
                long long osn, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldc = tile_pitch(hc);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + R * ldc;
  bf16* Vs = Ks + R * ldc;
  unsigned char* rest = reinterpret_cast<unsigned char*>(Vs + R * ldc);
  float* Ms = mask ? reinterpret_cast<float*>(rest) : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* mine = rest + (mask ? MASK_BYTES : 0) + warp * FWD_WARP_BYTES;
  float* Sw = reinterpret_cast<float*>(mine);
  bf16* Pw = reinterpret_cast<bf16*>(mine + STRIP_BYTES);

  const int h0 = blockIdx.y * hc, h = h0 + warp;
  const float* bias_h = bias + (long long)h * WW2;
  const int lrow = lane / 2, half = lane & 1;
  const int w0 = blockIdx.x * wpc, w1 = min(w0 + wpc, nB);

  zero_pad_rows(Qs, ldc);
  zero_pad_rows(Ks, ldc);
  zero_pad_rows(Vs, ldc);

  for (int w = w0; w < w1; ++w) {
    __syncthreads();  // the previous window's tiles are no longer read
    const long long base = (long long)w * sw + (long long)h0 * HD;
    load_window(Qs, ldc, q + base, sn, hc);
    load_window(Ks, ldc, k + base, sn, hc);
    load_window(Vs, ldc, v + base, sn, hc);
    if (Ms)
      for (int i = threadIdx.x; i < mask_rows * WW; i += blockDim.x)
        Ms[i] = mask[(long long)(w % nW) * mask_rows * WW + i];
    __syncthreads();

    for (int st = 0; st < R / 16; ++st) {
      const int row = st * 16 + lrow;
      strip_abt(Sw, Qs + st * 16 * ldc + warp * HD, ldc, Ks + warp * HD, ldc);
      __syncwarp();
      float p[32];
      row_probs(p, Sw + lrow * LDS, bias_h, Ms, mask_rows, row, half, scale);
#pragma unroll
      for (int j = 0; j < 32; ++j) Pw[lrow * LDP + 2 * j + half] = __float2bfloat16(p[j]);
      __syncwarp();
      strip_ab(Sw, Pw, Vs + warp * HD, ldc);
      __syncwarp();
      if (row < WW)
        store16(o + (long long)w * osw + (long long)row * osn + h * HD + half * 16,
                Sw + lrow * LDS + half * 16, 1.f);
      __syncwarp();  // Sw and Pw are rewritten by the next strip
    }
  }
}

// ----------------------------------------------------------------------------
// K10: backward (wgmma + TMA)
// ----------------------------------------------------------------------------

// Windows in flight a block, timed with the heads a block
// (ops/hopper/window_attention.STACKED_HEADS) by
// scripts/attention_variants.py (PERF.md). A block of three heads in two
// stages uses 196 KB of shared memory; three heads in three stages, or four
// in two, need 254 KB and do not fit in the 227 KB a block may use.
constexpr int WINS_BWD_STAGES = 2;
constexpr int MAX_BWD_HEADS = 3;

template <int HC> constexpr int wins_bwd_threads() { return 128 * HC + 32; }  // + 1 producer warp

// The backward of a chunk of HC heads over a range of windows:
// hopper::window_bwd_block. One head a block leaves room for two blocks an
// SM.
template <int HC>
__global__ void __launch_bounds__(128 * HC + 32, HC == 1 ? 2 : 1)
wins_bwd_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap dq_map,
                const __grid_constant__ CUtensorMap dk_map,
                const __grid_constant__ CUtensorMap dv_map, const float* __restrict__ bias,
                const float* __restrict__ mask, float* __restrict__ dbias_part, int nB, int H,
                int nW, int mask_rows, int wpc, float scale) {
  hopper::window_bwd_block<HC, WINS_BWD_STAGES>(&q_map, &k_map, &v_map, &do_map, &dq_map,
                                                &dk_map, &dv_map, bias, mask, dbias_part, nB, H,
                                                nW, mask_rows, wpc, 0, 0, 0, 0, scale);
}

// dbias[i] = sum over x of part[x, i], x in order: deterministic.
__global__ void wins_dbias_reduce_kernel(const float* __restrict__ part,
                                         float* __restrict__ dbias, int nx, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int x = 0; x < nx; ++x) s += part[(long long)x * n + i];
  dbias[i] = s;
}

size_t fwd_smem(int hc, bool masked) {
  return (size_t)3 * R * tile_pitch(hc) * 2 + (masked ? MASK_BYTES : 0) + hc * FWD_WARP_BYTES;
}

template <int HC> constexpr size_t wins_bwd_smem() {
  return sizeof(hopper::WinBwdSmem<HC, WINS_BWD_STAGES>) + 1024;
}

// Raise K10's shared memory limit for HC heads a block, once.
template <int HC> cudaError_t wins_bwd_allow_smem() {
  static bool done = false;
  return hopper::allow_smem(wins_bwd_kernel<HC>, wins_bwd_smem<HC>(), done);
}

template <int HC>
int launch_wins_bwd(const void* q, const void* k, const void* v, const void* dout,
                    const float* bias, const float* mask, void* dq, void* dk, void* dv,
                    float* part, int nB, int H, int nW, int mask_rows, int wpc, long long sw,
                    long long sn, float scale, cudaStream_t stream) {
  hopper::WinBwdMaps maps;
  const CUresult res =
      hopper::make_win_bwd_maps(maps, q, k, v, dout, dq, dk, dv, nB, H, sw, sn);
  if (res != CUDA_SUCCESS) return hopper::MAP_ERROR + (int)res;
  const cudaError_t err = wins_bwd_allow_smem<HC>();
  if (err != cudaSuccess) return err;
  dim3 grid((nB + wpc - 1) / wpc, H / HC);
  wins_bwd_kernel<HC><<<grid, wins_bwd_threads<HC>(), wins_bwd_smem<HC>(), stream>>>(
      maps.q, maps.k, maps.v, maps.dout, maps.dq, maps.dk, maps.dv, bias, mask, part, nB, H, nW,
      mask_rows, wpc, scale);
  return cudaGetLastError();
}

template <int HC> int wins_bwd_per_sm() {
  const cudaError_t err = wins_bwd_allow_smem<HC>();
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, wins_bwd_kernel<HC>, wins_bwd_threads<HC>(), wins_bwd_smem<HC>());
  return occ == cudaSuccess ? n : -(int)occ;
}

bool bad_chunk(int H, int hc, int most) { return hc < 1 || hc > most || H % hc != 0; }

}  // namespace

// q, k, v: (nB, 49, C) bf16 views sharing strides (sw, sn), unit stride in
// the channel; head h is channels [32h, 32h + 32). bias: (H, 49, 49) f32;
// mask: null or (nW, mask_rows, 49) f32 with mask_rows 1 or 49; o: (nB, 49,
// C) bf16 with strides (osw, osn). A block owns hc heads (hc | H, hc <= 8)
// over wpc consecutive windows.
extern "C" int dinomc_wins_attn_fwd(const void* q, const void* k, const void* v,
                                    const void* bias, const void* mask, void* o, int nB,
                                    int H, int hc, int nW, int mask_rows, int wpc,
                                    long long sw, long long sn, long long osw, long long osn,
                                    float scale, void* stream) {
  if (bad_chunk(H, hc, MAX_FWD_HEADS)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(hc, mask != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      wins_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nB + wpc - 1) / wpc, H / hc);
  wins_fwd_kernel<<<grid, hc * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias,
      (const float*)mask, (bf16*)o, nB, hc, nW, mask_rows, wpc, sw, sn, osw, osn, scale);
  return (int)cudaGetLastError();
}

// Blocks of K10 with hc heads (1 <= hc <= 3) that one SM of `device` holds
// at once, or minus a cudaError_t: the wrapper sizes its grid to one wave.
extern "C" int dinomc_wins_attn_bwd_per_sm(int hc, int device) {
  const cudaError_t bound = cudaSetDevice(device);
  if (bound != cudaSuccess) return -(int)bound;
  switch (hc) {
    case 1: return wins_bwd_per_sm<1>();
    case 2: return wins_bwd_per_sm<2>();
    case 3: return wins_bwd_per_sm<3>();
    default: return -(int)cudaErrorInvalidValue;
  }
}

// As above (hc <= 3; q, k, v 16-byte aligned with sw, sn multiples of 8),
// plus dout, dq, dk, dv: contiguous (nB, 49, C) bf16; dbias_part:
// (ceil(nB / wpc), H, 49, 49) f32 scratch; dbias: (H, 49, 49) f32;
// `device`: the CUDA device of the tensors and the stream.
extern "C" int dinomc_wins_attn_bwd(const void* q, const void* k, const void* v,
                                    const void* dout, const void* bias, const void* mask,
                                    void* dq, void* dk, void* dv, void* dbias_part,
                                    void* dbias, int nB, int H, int hc, int nW, int mask_rows,
                                    int wpc, long long sw, long long sn, float scale,
                                    void* stream, int device) {
  if (bad_chunk(H, hc, MAX_BWD_HEADS)) return (int)cudaErrorInvalidValue;
  const cudaError_t bound = cudaSetDevice(device);  // see hopper::make_map
  if (bound != cudaSuccess) return (int)bound;
  cudaStream_t st = (cudaStream_t)stream;
  const float *bp = (const float*)bias, *mp = (const float*)mask;
  float* part = (float*)dbias_part;
  int err;
  switch (hc) {
    case 1: err = launch_wins_bwd<1>(q, k, v, dout, bp, mp, dq, dk, dv, part, nB, H, nW, mask_rows, wpc, sw, sn, scale, st); break;
    case 2: err = launch_wins_bwd<2>(q, k, v, dout, bp, mp, dq, dk, dv, part, nB, H, nW, mask_rows, wpc, sw, sn, scale, st); break;
    default: err = launch_wins_bwd<3>(q, k, v, dout, bp, mp, dq, dk, dv, part, nB, H, nW, mask_rows, wpc, sw, sn, scale, st); break;
  }
  if (err != 0) return err;
  const int nx = (nB + wpc - 1) / wpc, n = H * WW2;
  wins_dbias_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, (float*)dbias, nx, n);
  return (int)cudaGetLastError();
}
