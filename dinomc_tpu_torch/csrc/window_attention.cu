// Swin window attention, forward (K7) and backward (K8), for sm_90a.
//
// Replaces: dinomc_tpu/ops/pallas/window_attention.py, `_pwa_fwd`
// (`_fwd_kernel`) and `_pwa_bwd` (`_bwd_kernel`).
//
// What it computes: for every window w (49 tokens of a 7x7 window) and head
// h (head_dim 32), softmax(Q K^T * scale + bias[h] + mask[w mod nW]) V, with
// Q, K and V read in place from the strided (nB, 49, 3C) qkv views. The
// mask is absent, (nW, 49, 49) (shifted windows, maybe with padding), or
// (nW, 1, 49) (padding only: it hides keys and is the same for every
// query). The backward recomputes P, then forms dV = P^T dO, dP = dO V^T,
// delta = rowsum(P * dP), dS = P * (dP - delta), dQ = dS K * scale,
// dK = dS^T Q * scale, and dbias[h] = the sum of dS over all windows.
//
// What bounds it on this card: a (window, head) is two 49x49x32 products
// forward (about 0.31 MFLOP) against 4 * 49 * 32 bf16 values of traffic
// (12.5 KB), about 25 FLOP a byte, far below the card's ~295: the kernel is
// bound by memory traffic and by latency (tiny products, many barriers).
//
// Design: the TPU kernel packs G windows into one (G*49)^2 score product
// behind a block-diagonal mask and folds bias and mask into the product,
// all to fill a 128x128 systolic array. None of that carries over. Here one
// block of 4 warps owns one head and a contiguous range of windows; each
// window is staged in shared memory padded from 49 to 64 rows, so WMMA bf16
// 16x16x16 fragments apply (warp i owns rows 16i..16i+15); keys past 49 are
// masked, query rows past 49 are never written, no cross-window score is
// ever formed. bias[h] is loaded once per block and the window's mask once
// per window, both f32 in shared memory; the softmax is exact (a row fits)
// and in f32; P is rounded to bf16 before P V, as `_fwd_kernel` does.
//
// dbias is deterministic, with no atomics: each thread of K8 owns 32 of the
// (49, 49) elements of its head and sums dS into registers over the block's
// windows, in f32 (the TPU rounds dS and its partials to bf16); the block
// writes one (49, 49) partial, and a second small kernel sums the partials
// in a fixed order. One partial per block, not per window: at stage 1, one
// per window would be 1024 * 3 * 49^2 * 4 B = 29.5 MB, more than Q, K, V and
// dO themselves. wgmma, TMA and pipelining are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int WW = 49;         // tokens a window
constexpr int WW2 = WW * WW;   // bias / mask elements of one head or window
constexpr int R = 64;          // rows a window is padded to
constexpr int HD = 32;         // head dim
constexpr int NWARPS = 4;      // warp i owns rows 16i..16i+15
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDT = HD + 8;    // bf16 q/k/v/dO tile pitch (multiple of 8)
constexpr int LDS = R + 4;     // f32 score tile pitch (multiple of 4)
constexpr int LDP = R + 8;     // bf16 probability tile pitch (multiple of 8)

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Zero rows [WW, R) of an (R, LDT) tile: they stay zero, window to window.
__device__ __forceinline__ void zero_pad_rows(bf16* t) {
  for (int i = threadIdx.x; i < (R - WW) * LDT; i += NTHREADS)
    t[WW * LDT + i] = __float2bfloat16(0.f);
}

// Rows 0..48 of one (window, head) slice, 32 bf16 each, as four 16-byte
// loads a row (the wrapper checks 16-byte alignment of rows and heads).
__device__ __forceinline__ void load_window(bf16* dst, const bf16* src, long long sn) {
  for (int i = threadIdx.x; i < WW * (HD / 8); i += NTHREADS) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDT + c) =
        *reinterpret_cast<const uint4*>(src + (long long)r * sn + c);
  }
}

__device__ __forceinline__ void load_f32(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += NTHREADS) dst[i] = src[i];
}

// out (16 x 64 f32, pitch LDS) = A (16 x 32 bf16 at a, pitch LDT) * B^T,
// B a (64 x 32) row-major tile (pitch LDT): Q K^T and dO V^T.
__device__ __forceinline__ void mm_abt(float* out, const bf16* a, const bf16* b) {
  FragA af[HD / 16];
#pragma unroll
  for (int kt = 0; kt < HD / 16; ++kt) wmma::load_matrix_sync(af[kt], a + kt * 16, LDT);
#pragma unroll
  for (int nt = 0; nt < R / 16; ++nt) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kt = 0; kt < HD / 16; ++kt) {
      FragBCol bf;
      wmma::load_matrix_sync(bf, b + nt * 16 * LDT + kt * 16, LDT);
      wmma::mma_sync(acc, af[kt], bf, acc);
    }
    wmma::store_matrix_sync(out + nt * 16, acc, LDS, wmma::mem_row_major);
  }
}

// out (16 x 32 f32, pitch LDS) = A (16 x 64 bf16, pitch LDP) * B (64 x 32
// row-major, pitch LDT). With TRANS, A is read transposed: rows of A are
// columns a, a+1, ... of a (64 x 64) tile (dS^T Q, P^T dO).
template <bool TRANS>
__device__ __forceinline__ void mm_ab(float* out, const bf16* a, const bf16* b) {
  FragC acc[HD / 16];
#pragma unroll
  for (int dt = 0; dt < HD / 16; ++dt) wmma::fill_fragment(acc[dt], 0.f);
#pragma unroll
  for (int kt = 0; kt < R / 16; ++kt) {
    typename std::conditional<TRANS, FragACol, FragA>::type af;
    if constexpr (TRANS) wmma::load_matrix_sync(af, a + kt * 16 * LDP, LDP);
    else wmma::load_matrix_sync(af, a + kt * 16, LDP);
#pragma unroll
    for (int dt = 0; dt < HD / 16; ++dt) {
      FragBRow bf;
      wmma::load_matrix_sync(bf, b + kt * 16 * LDT + dt * 16, LDT);
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

// The logits of one row: lanes 2r' and 2r'+1 of a warp share row r and take
// the even and odd columns; column c = 2j + half. Dead entries are -inf.
__device__ __forceinline__ void row_logits(float* s, const float* Ss, const float* Bs,
                                           const float* Ms, int mask_rows, int row,
                                           int half, float scale) {
  const float* mrow = Ms ? Ms + (mask_rows == 1 ? 0 : row) * WW : nullptr;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = 2 * j + half;
    float v = -INFINITY;
    if (row < WW && c < WW) {
      v = Ss[row * LDS + c] * scale + Bs[row * WW + c];
      if (mrow) v += mrow[c];
    }
    s[j] = v;
  }
}

// In place: logits -> probabilities (exact softmax over the row; the two
// lanes of a row combine through one shuffle). Rows past 49 give zeros.
__device__ __forceinline__ void row_softmax(float* s, int row) {
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
// K7: forward
// ----------------------------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS)
win_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ bias,
               const float* __restrict__ mask, bf16* __restrict__ o, int nB,
               int H, int nW, int mask_rows, int wpc, long long sw, long long sn,
               long long osw, long long osn, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + R * LDT;
  bf16* Vs = Ks + R * LDT;
  bf16* Ps = Vs + R * LDT;
  float* Ss = reinterpret_cast<float*>(Ps + R * LDP);
  float* Bs = Ss + R * LDS;
  float* Ms = mask ? Bs + WW2 : nullptr;

  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 2, half = lane & 1;
  const int w0 = blockIdx.x * wpc, w1 = min(w0 + wpc, nB);

  load_f32(Bs, bias + (long long)h * WW2, WW2);
  zero_pad_rows(Qs);
  zero_pad_rows(Ks);
  zero_pad_rows(Vs);

  for (int w = w0; w < w1; ++w) {
    __syncthreads();  // the previous window's tiles are no longer read
    const long long base = (long long)w * sw + (long long)h * HD;
    load_window(Qs, q + base, sn);
    load_window(Ks, k + base, sn);
    load_window(Vs, v + base, sn);
    if (Ms) load_f32(Ms, mask + (long long)(w % nW) * mask_rows * WW, mask_rows * WW);
    __syncthreads();

    mm_abt(Ss + warp * 16 * LDS, Qs + warp * 16 * LDT, Ks);
    __syncwarp();
    float s[32];
    row_logits(s, Ss, Bs, Ms, mask_rows, row, half, scale);
    row_softmax(s, row);
#pragma unroll
    for (int j = 0; j < 32; ++j) Ps[row * LDP + 2 * j + half] = __float2bfloat16(s[j]);
    __syncwarp();
    mm_ab<false>(Ss + warp * 16 * LDS, Ps + warp * 16 * LDP, Vs);
    __syncwarp();
    if (row < WW)
      store16(o + (long long)w * osw + (long long)row * osn + h * HD + half * 16,
              Ss + row * LDS + half * 16, 1.f);
  }
}

// ----------------------------------------------------------------------------
// K8: backward
// ----------------------------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS)
win_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ bias, const float* __restrict__ mask,
               bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
               float* __restrict__ dbias_part, int nB, int H, int nW, int mask_rows,
               int wpc, long long sw, long long sn, long long osw, long long osn,
               float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + R * LDT;
  bf16* Vs = Ks + R * LDT;
  bf16* dOs = Vs + R * LDT;
  bf16* Ps = dOs + R * LDT;
  bf16* dSs = Ps + R * LDP;
  float* Ss = reinterpret_cast<float*>(dSs + R * LDP);
  float* dPs = Ss + R * LDS;
  float* Bs = dPs + R * LDS;
  float* Ms = mask ? Bs + WW2 : nullptr;

  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 2, half = lane & 1;
  const int w0 = blockIdx.x * wpc, w1 = min(w0 + wpc, nB);

  load_f32(Bs, bias + (long long)h * WW2, WW2);
  zero_pad_rows(Qs);
  zero_pad_rows(Ks);
  zero_pad_rows(Vs);
  zero_pad_rows(dOs);

  float db[32];  // this thread's (row, 2j + half) elements of dbias[h]
#pragma unroll
  for (int j = 0; j < 32; ++j) db[j] = 0.f;

  for (int w = w0; w < w1; ++w) {
    __syncthreads();
    const long long base = (long long)w * sw + (long long)h * HD;
    const long long obase = (long long)w * osw + (long long)h * HD;
    load_window(Qs, q + base, sn);
    load_window(Ks, k + base, sn);
    load_window(Vs, v + base, sn);
    load_window(dOs, dout + obase, osn);
    if (Ms) load_f32(Ms, mask + (long long)(w % nW) * mask_rows * WW, mask_rows * WW);
    __syncthreads();

    mm_abt(Ss + warp * 16 * LDS, Qs + warp * 16 * LDT, Ks);
    mm_abt(dPs + warp * 16 * LDS, dOs + warp * 16 * LDT, Vs);
    __syncwarp();
    float p[32];
    row_logits(p, Ss, Bs, Ms, mask_rows, row, half, scale);
    row_softmax(p, row);
    float delta = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) delta += p[j] * dPs[row * LDS + 2 * j + half];
    delta += __shfl_xor_sync(0xffffffffu, delta, 1);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * j + half;
      const float ds = p[j] * (dPs[row * LDS + c] - delta);  // 0 where p is
      Ps[row * LDP + c] = __float2bfloat16(p[j]);
      dSs[row * LDP + c] = __float2bfloat16(ds);
      db[j] += ds;
    }
    __syncthreads();  // dK and dV read every row of P and dS

    // Each warp's rows of Ss and dPs were read only by that warp: reuse
    // them for dQ (Ss columns 0..31), dK (Ss 32..63) and dV (dPs 0..31).
    mm_ab<false>(Ss + warp * 16 * LDS, dSs + warp * 16 * LDP, Ks);
    mm_ab<true>(Ss + warp * 16 * LDS + HD, dSs + warp * 16, Qs);
    mm_ab<true>(dPs + warp * 16 * LDS, Ps + warp * 16, dOs);
    __syncwarp();
    if (row < WW) {
      const long long off = obase + (long long)row * osn + half * 16;
      store16(dq + off, Ss + row * LDS + half * 16, scale);
      store16(dk + off, Ss + row * LDS + HD + half * 16, scale);
      store16(dv + off, dPs + row * LDS + half * 16, 1.f);
    }
  }

  if (row < WW) {
    float* part = dbias_part + ((long long)blockIdx.x * H + h) * WW2 + row * WW;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * j + half;
      if (c < WW) part[c] = db[j];
    }
  }
}

// dbias[i] = sum over x of part[x, i], x in order: deterministic.
__global__ void win_dbias_reduce_kernel(const float* __restrict__ part,
                                        float* __restrict__ dbias, int nx, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int x = 0; x < nx; ++x) s += part[(long long)x * n + i];
  dbias[i] = s;
}

constexpr size_t fwd_smem(bool masked) {
  return (size_t)3 * R * LDT * 2 + (size_t)R * LDP * 2 + (size_t)R * LDS * 4 +
         (size_t)(masked ? 2 : 1) * WW2 * 4;
}
constexpr size_t bwd_smem(bool masked) {
  return (size_t)4 * R * LDT * 2 + (size_t)2 * R * LDP * 2 + (size_t)2 * R * LDS * 4 +
         (size_t)(masked ? 2 : 1) * WW2 * 4;
}

}  // namespace

// q, k, v: (nB, 49, C) bf16 views sharing strides (sw, sn), unit stride in
// the channel; head h is channels [32h, 32h + 32). bias: (H, 49, 49) f32;
// mask: null or (nW, mask_rows, 49) f32 with mask_rows 1 or 49; o: (nB, 49,
// C) bf16 with strides (osw, osn). A block owns wpc consecutive windows.
extern "C" int dinomc_win_attn_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* mask, void* o,
                                   int nB, int H, int nW, int mask_rows, int wpc,
                                   long long sw, long long sn, long long osw,
                                   long long osn, float scale, void* stream) {
  const size_t smem = fwd_smem(mask != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      win_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nB + wpc - 1) / wpc, H);
  win_fwd_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias,
      (const float*)mask, (bf16*)o, nB, H, nW, mask_rows, wpc, sw, sn, osw, osn, scale);
  return (int)cudaGetLastError();
}

// As above, plus dout, dq, dk, dv: (nB, 49, C) bf16 with strides (osw, osn);
// dbias_part: (ceil(nB / wpc), H, 49, 49) f32 scratch; dbias: (H, 49, 49) f32.
extern "C" int dinomc_win_attn_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* bias, const void* mask,
                                   void* dq, void* dk, void* dv, void* dbias_part,
                                   void* dbias, int nB, int H, int nW, int mask_rows,
                                   int wpc, long long sw, long long sn, long long osw,
                                   long long osn, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = bwd_smem(mask != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      win_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nx = (nB + wpc - 1) / wpc;
  dim3 grid(nx, H);
  win_bwd_kernel<<<grid, NTHREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)bias, (const float*)mask, (bf16*)dq, (bf16*)dk, (bf16*)dv,
      (float*)dbias_part, nB, H, nW, mask_rows, wpc, sw, sn, osw, osn, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = H * WW2;
  win_dbias_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)dbias_part, (float*)dbias, nx, n);
  return (int)cudaGetLastError();
}
