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
// (12.5 KB), about 25 FLOP a byte, and five products backward at about 35,
// far below the card's ~295: both kernels are bound by memory traffic and
// by latency (tiny products).
//
// K7's design: the TPU kernel packs G windows into one (G*49)^2 score
// product behind a block-diagonal mask and folds bias and mask into the
// product, all to fill a 128x128 systolic array. None of that carries over.
// Here K7 is hopper_window.cuh's window_fwd_block with one head a block
// (the body K9 runs with a chunk of heads): a producer warp TMA-loads each
// window's 64-row Q, K and V boxes (rows 49-63 arrive as zeros) through a
// ring of WIN_FWD_STAGES mbarrier-tracked stages and copies its mask
// beside them by cp.async; one consumer warpgroup forms S with wgmma, the
// exact f32 softmax in registers (bias[h] once a block in shared memory),
// and O = P V with P rounded to bf16, as `_fwd_kernel` does, as the
// register A operand; no cross-window score is ever formed.
// O is staged in the window's Q box and leaves by a TMA store that clips
// rows past 49 (3-5% ahead of writing it from registers). Like K8 it reads
// Swin's q/k/v column slices through one tensor map over the (nB, 49, 3C)
// qkv tensor, so a call encodes two maps, that one and O's (four when the
// slices are tensors of their own); its grid is one wave of resident
// blocks (dinomc_win_attn_fwd_per_sm), and the shared-memory limit is
// raised once.
//
// K8's design is hopper_window.cuh's window_bwd_block with one head a block,
// the body K10 runs with a chunk of heads: a producer warp TMA-loads each
// window's 64-row Q, K, V and dO boxes (rows 49-63 arrive as zeros) and its
// mask through a ring of WIN_BWD_STAGES mbarrier-tracked stages; one
// consumer warpgroup forms S and dP with wgmma, the exact softmax, delta and
// dS in registers, dQ from dS as the register A operand, dK and dV from P
// and dS stored as swizzled bf16 tiles and read transposed; dQ, dK and dV
// leave by TMA stores. Swin passes q, k and v as column slices of one (nB,
// 49, 3C) qkv tensor: then one tensor map over it, k at head offset H and v
// at 2H, serves all three, and one over the (nB, 49, 3C) gradient buffer
// serves dq, dk and dv, so a call encodes three maps (seven when the slices
// are tensors of their own). The wrapper sizes the grid to one wave of
// resident blocks (dinomc_win_attn_bwd_per_sm).
//
// dbias is deterministic, with no atomics: each thread of K8 owns fixed
// elements of its head's (49, 49) sum in registers across the block's
// windows, in f32 (the TPU rounds dS and its partials to bf16); the block
// writes one (49, 49) partial, and a second small kernel sums the partials
// in a fixed order. One partial per block, not per window: at stage 1, one
// per window would be 1024 * 3 * 49^2 * 4 B = 29.5 MB, more than Q, K, V and
// dO themselves.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_window.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WW = 49;         // tokens a window
constexpr int WW2 = WW * WW;   // bias / mask elements of one head or window
constexpr int HD = 32;         // head dim

// ----------------------------------------------------------------------------
// K7: forward
// ----------------------------------------------------------------------------

// K7's windows in flight a block, timed by scripts/attention_variants.py
// (PERF.md): three stages gain at stage 1 what they lose at stage 2.
constexpr int WIN_FWD_STAGES = 2;
constexpr int WIN_FWD_THREADS = 128 + 32;  // a consumer warpgroup and the producer warp

__global__ void __launch_bounds__(WIN_FWD_THREADS)
win_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap o_map, const float* __restrict__ bias,
               const float* __restrict__ mask, int nB, int nW, int mask_rows, int wpc,
               int k_head, int v_head, float scale) {
  hopper::window_fwd_block<1, WIN_FWD_STAGES>(&q_map, &k_map, &v_map, &o_map, bias, mask, nB, nW,
                                              mask_rows, wpc, k_head, v_head, scale);
}

constexpr size_t FWD_SMEM = sizeof(hopper::WinFwdSmem<1, WIN_FWD_STAGES>) + 1024;

cudaError_t fwd_allow_smem() {
  static bool done = false;
  return hopper::allow_smem(win_fwd_kernel, FWD_SMEM, done);
}

// ----------------------------------------------------------------------------
// K8: backward
// ----------------------------------------------------------------------------

// K8's windows in flight a block, timed by scripts/attention_variants.py
// (PERF.md). One head in two stages takes 78 KB of shared memory, so two
// blocks share an SM; three stages take 102 KB and still leave two.
constexpr int WIN_BWD_STAGES = 2;
constexpr int WIN_BWD_THREADS = 128 + 32;  // a consumer warpgroup and the producer warp

__global__ void __launch_bounds__(WIN_BWD_THREADS, 2)
win_bwd_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap do_map,
               const __grid_constant__ CUtensorMap dq_map,
               const __grid_constant__ CUtensorMap dk_map,
               const __grid_constant__ CUtensorMap dv_map, const float* __restrict__ bias,
               const float* __restrict__ mask, float* __restrict__ dbias_part, int nB, int H,
               int nW, int mask_rows, int wpc, int k_head, int v_head, int dk_head, int dv_head,
               float scale) {
  hopper::window_bwd_block<1, WIN_BWD_STAGES>(&q_map, &k_map, &v_map, &do_map, &dq_map, &dk_map,
                                              &dv_map, bias, mask, dbias_part, nB, H, nW,
                                              mask_rows, wpc, k_head, v_head, dk_head, dv_head,
                                              scale);
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

constexpr size_t BWD_SMEM = sizeof(hopper::WinBwdSmem<1, WIN_BWD_STAGES>) + 1024;

cudaError_t bwd_allow_smem() {
  static bool done = false;
  return hopper::allow_smem(win_bwd_kernel, BWD_SMEM, done);
}

}  // namespace

// Blocks of K7 that one SM of `device` holds at once, or minus a
// cudaError_t: the wrapper sizes its grid to one wave.
extern "C" int dinomc_win_attn_fwd_per_sm(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = fwd_allow_smem();
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, win_fwd_kernel, WIN_FWD_THREADS,
                                                      FWD_SMEM);
  return err == cudaSuccess ? n : -(int)err;
}

// q, k, v: (nB, 49, C) bf16 views sharing strides (sw, sn), 16-byte
// aligned, multiples of 8, unit stride in the channel; head h is channels
// [32h, 32h + 32). bias: (H, 49, 49) f32; mask: null or (nW, mask_rows, 49)
// f32 with mask_rows 1 or 49; o: contiguous (nB, 49, C) bf16; `device`: the
// CUDA device of the tensors and the stream. A block owns one head over wpc
// consecutive windows.
extern "C" int dinomc_win_attn_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* mask, void* o, int nB, int H,
                                   int nW, int mask_rows, int wpc, long long sw, long long sn,
                                   float scale, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);  // see hopper::make_map
  if (err != cudaSuccess) return (int)err;
  CUtensorMap in[3], o_map;
  int k_head, v_head;
  CUresult res = hopper::win_triple_maps(in, k_head, v_head, q, k, v, nB, H, sw, sn);
  if (res == CUDA_SUCCESS) res = hopper::make_map<HD>(&o_map, o, nB, WW, H);
  if (res != CUDA_SUCCESS) return hopper::MAP_ERROR + (int)res;
  err = fwd_allow_smem();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nB + wpc - 1) / wpc, H);
  win_fwd_kernel<<<grid, WIN_FWD_THREADS, FWD_SMEM, (cudaStream_t)stream>>>(
      in[0], in[1], in[2], o_map, (const float*)bias, (const float*)mask, nB, nW, mask_rows, wpc,
      k_head, v_head, scale);
  return (int)cudaGetLastError();
}

// Blocks of K8 that one SM of `device` holds at once, or minus a
// cudaError_t: the wrapper sizes its grid to one wave.
extern "C" int dinomc_win_attn_bwd_per_sm(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = bwd_allow_smem();
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, win_bwd_kernel, WIN_BWD_THREADS,
                                                      BWD_SMEM);
  return err == cudaSuccess ? n : -(int)err;
}

// As above (q, k, v 16-byte aligned with sw, sn multiples of 8), plus
// dout: contiguous (nB, 49, C) bf16; dq, dk, dv: (nB, 49, C) bf16 views
// sharing strides (gsw, gsn), 16-byte aligned, multiples of 8, unit stride
// in the channel; dbias_part: (ceil(nB / wpc), H, 49, 49) f32 scratch;
// dbias: (H, 49, 49) f32; `device`: the CUDA device of the tensors and the
// stream. A block owns one head over wpc consecutive windows.
extern "C" int dinomc_win_attn_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* bias, const void* mask,
                                   void* dq, void* dk, void* dv, void* dbias_part,
                                   void* dbias, int nB, int H, int nW, int mask_rows,
                                   int wpc, long long sw, long long sn, long long gsw,
                                   long long gsn, float scale, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);  // see hopper::make_map
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap in[3], grad[3], dout_map;
  int k_head, v_head, dk_head, dv_head;
  CUresult res = hopper::win_triple_maps(in, k_head, v_head, q, k, v, nB, H, sw, sn);
  if (res == CUDA_SUCCESS)
    res = hopper::win_triple_maps(grad, dk_head, dv_head, dq, dk, dv, nB, H, gsw, gsn);
  if (res == CUDA_SUCCESS) res = hopper::make_map<HD>(&dout_map, dout, nB, WW, H);
  if (res != CUDA_SUCCESS) return hopper::MAP_ERROR + (int)res;
  err = bwd_allow_smem();
  if (err != cudaSuccess) return (int)err;
  const int nx = (nB + wpc - 1) / wpc;
  dim3 grid(nx, H);
  win_bwd_kernel<<<grid, WIN_BWD_THREADS, BWD_SMEM, st>>>(
      in[0], in[1], in[2], dout_map, grad[0], grad[1], grad[2], (const float*)bias,
      (const float*)mask, (float*)dbias_part, nB, H, nW, mask_rows, wpc, k_head, v_head, dk_head,
      dv_head, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = H * WW2;
  win_dbias_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)dbias_part, (float*)dbias, nx, n);
  return (int)cudaGetLastError();
}
