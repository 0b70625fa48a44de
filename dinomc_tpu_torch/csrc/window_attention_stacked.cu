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
// The design: the TPU variant's idea, not its operands. Its idea is all the
// heads of a window in one unit of work; on the TPU that meant
// block-stacked, zero-masked K' and V' operands (`_stack_heads`) filling a
// 128-wide systolic array with zeros, and none of that is kept. Here a
// block owns a chunk of HC heads over a range of consecutive windows, and
// runs the bodies K7 and K8 run with one head (hopper_window.cuh): one
// consumer warpgroup a head, and one producer warp that TMA-loads each
// window's 64-row boxes for the chunk's heads and copies the window's mask
// once for all of them, through a ring of mbarrier-tracked stages. K9 runs
// window_fwd_block<HC, WINS_FWD_STAGES> (S by wgmma, the exact f32 softmax
// in registers, P rounded to bf16 as the register A operand of P V, O
// leaving by TMA stores); K10 runs window_bwd_block<HC, WINS_BWD_STAGES>,
// with dbias deterministic and free of atomics: each thread owns fixed
// elements of its head's sum across the block's windows, the block writes
// one (HC, 49, 49) partial, and a second kernel sums the partials in a
// fixed order. Against one head a block, a chunk shares the producer and
// the mask copy among HC heads and pays in blocks an SM. Both kernels read
// Swin's q/k/v column slices through one tensor map over the (nB, 49, 3C)
// qkv tensor (hopper::win_triple_maps), and K10 writes dq/dk/dv as column
// slices of one (nB, 49, 3C) buffer through one map. The wrapper sizes each
// grid to one wave of resident blocks, and each kernel's shared-memory
// limit is raised once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_window.cuh"

namespace {

constexpr int WW = 49;        // tokens a window
constexpr int WW2 = WW * WW;  // bias elements of one head
constexpr int HD = 32;        // head dim

template <int HC> constexpr int wins_threads() { return 128 * HC + 32; }  // + 1 producer warp

// ----------------------------------------------------------------------------
// K9: forward
// ----------------------------------------------------------------------------

// K9's windows in flight a block, timed with the heads a block
// (ops/hopper/window_attention.STACKED_HEADS) by
// scripts/attention_variants.py (PERF.md). A block of HC heads in two
// stages asks for 34,180 HC + 20,264 bytes of shared memory, in three
// 46,468 HC + 29,884: HC = 6 in two stages (225 KB) and HC = 4 in three
// (216 KB) are the most that fit in the 227 KB a block may use.
constexpr int WINS_FWD_STAGES = 2;

template <int HC>
__global__ void __launch_bounds__(128 * HC + 32)
wins_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap o_map, const float* __restrict__ bias,
                const float* __restrict__ mask, int nB, int nW, int mask_rows, int wpc,
                int k_head, int v_head, float scale) {
  hopper::window_fwd_block<HC, WINS_FWD_STAGES>(&q_map, &k_map, &v_map, &o_map, bias, mask, nB,
                                                nW, mask_rows, wpc, k_head, v_head, scale);
}

template <int HC> constexpr size_t wins_fwd_smem() {
  return sizeof(hopper::WinFwdSmem<HC, WINS_FWD_STAGES>) + 1024;
}

// Raise K9's shared memory limit for HC heads a block, once.
template <int HC> cudaError_t wins_fwd_allow_smem() {
  static bool done = false;
  return hopper::allow_smem(wins_fwd_kernel<HC>, wins_fwd_smem<HC>(), done);
}

template <int HC>
int launch_wins_fwd(const CUtensorMap (&in)[3], const CUtensorMap& o_map, const float* bias,
                    const float* mask, int nB, int H, int nW, int mask_rows, int wpc, int k_head,
                    int v_head, float scale, cudaStream_t stream) {
  const cudaError_t err = wins_fwd_allow_smem<HC>();
  if (err != cudaSuccess) return err;
  dim3 grid((nB + wpc - 1) / wpc, H / HC);
  wins_fwd_kernel<HC><<<grid, wins_threads<HC>(), wins_fwd_smem<HC>(), stream>>>(
      in[0], in[1], in[2], o_map, bias, mask, nB, nW, mask_rows, wpc, k_head, v_head, scale);
  return cudaGetLastError();
}

template <int HC> int wins_fwd_per_sm() {
  const cudaError_t err = wins_fwd_allow_smem<HC>();
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, wins_fwd_kernel<HC>, wins_threads<HC>(), wins_fwd_smem<HC>());
  return occ == cudaSuccess ? n : -(int)occ;
}

// ----------------------------------------------------------------------------
// K10: backward
// ----------------------------------------------------------------------------

// Windows in flight a block, timed with the heads a block
// (ops/hopper/window_attention.STACKED_HEADS) by
// scripts/attention_variants.py (PERF.md). A block of three heads in two
// stages uses 196 KB of shared memory; three heads in three stages, or four
// in two, need 254 KB and do not fit in the 227 KB a block may use.
constexpr int WINS_BWD_STAGES = 2;

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
                int nW, int mask_rows, int wpc, int k_head, int v_head, int dk_head, int dv_head,
                float scale) {
  hopper::window_bwd_block<HC, WINS_BWD_STAGES>(&q_map, &k_map, &v_map, &do_map, &dq_map,
                                                &dk_map, &dv_map, bias, mask, dbias_part, nB, H,
                                                nW, mask_rows, wpc, k_head, v_head, dk_head,
                                                dv_head, scale);
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

template <int HC> constexpr size_t wins_bwd_smem() {
  return sizeof(hopper::WinBwdSmem<HC, WINS_BWD_STAGES>) + 1024;
}

// Raise K10's shared memory limit for HC heads a block, once.
template <int HC> cudaError_t wins_bwd_allow_smem() {
  static bool done = false;
  return hopper::allow_smem(wins_bwd_kernel<HC>, wins_bwd_smem<HC>(), done);
}

template <int HC>
int launch_wins_bwd(const CUtensorMap (&in)[3], const CUtensorMap& do_map,
                    const CUtensorMap (&grad)[3], const float* bias, const float* mask,
                    float* part, int nB, int H, int nW, int mask_rows, int wpc, int k_head,
                    int v_head, int dk_head, int dv_head, float scale, cudaStream_t stream) {
  const cudaError_t err = wins_bwd_allow_smem<HC>();
  if (err != cudaSuccess) return err;
  dim3 grid((nB + wpc - 1) / wpc, H / HC);
  wins_bwd_kernel<HC><<<grid, wins_threads<HC>(), wins_bwd_smem<HC>(), stream>>>(
      in[0], in[1], in[2], do_map, grad[0], grad[1], grad[2], bias, mask, part, nB, H, nW,
      mask_rows, wpc, k_head, v_head, dk_head, dv_head, scale);
  return cudaGetLastError();
}

template <int HC> int wins_bwd_per_sm() {
  const cudaError_t err = wins_bwd_allow_smem<HC>();
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, wins_bwd_kernel<HC>, wins_threads<HC>(), wins_bwd_smem<HC>());
  return occ == cudaSuccess ? n : -(int)occ;
}

}  // namespace

// Blocks of K9 with hc heads (1, 2, 3, 4 or 6) that one SM of `device`
// holds at once, or minus a cudaError_t: the wrapper sizes its grid to one
// wave.
extern "C" int dinomc_wins_attn_fwd_per_sm(int hc, int device) {
  const cudaError_t bound = cudaSetDevice(device);
  if (bound != cudaSuccess) return -(int)bound;
  switch (hc) {
    case 1: return wins_fwd_per_sm<1>();
    case 2: return wins_fwd_per_sm<2>();
    case 3: return wins_fwd_per_sm<3>();
    case 4: return wins_fwd_per_sm<4>();
    case 6: return wins_fwd_per_sm<6>();
    default: return -(int)cudaErrorInvalidValue;
  }
}

// q, k, v: (nB, 49, C) bf16 views sharing strides (sw, sn), 16-byte
// aligned, multiples of 8, unit stride in the channel; head h is channels
// [32h, 32h + 32). bias: (H, 49, 49) f32; mask: null or (nW, mask_rows, 49)
// f32 with mask_rows 1 or 49; o: contiguous (nB, 49, C) bf16; `device`: the
// CUDA device of the tensors and the stream. A block owns hc heads (hc | H;
// 1, 2, 3, 4 or 6) over wpc consecutive windows.
extern "C" int dinomc_wins_attn_fwd(const void* q, const void* k, const void* v,
                                    const void* bias, const void* mask, void* o, int nB, int H,
                                    int hc, int nW, int mask_rows, int wpc, long long sw,
                                    long long sn, float scale, void* stream, int device) {
  if (hc < 1 || H % hc != 0) return (int)cudaErrorInvalidValue;
  const cudaError_t bound = cudaSetDevice(device);  // see hopper::make_map
  if (bound != cudaSuccess) return (int)bound;
  CUtensorMap in[3], o_map;
  int k_head, v_head;
  CUresult res = hopper::win_triple_maps(in, k_head, v_head, q, k, v, nB, H, sw, sn);
  if (res == CUDA_SUCCESS) res = hopper::make_map<HD>(&o_map, o, nB, WW, H);
  if (res != CUDA_SUCCESS) return hopper::MAP_ERROR + (int)res;
  cudaStream_t st = (cudaStream_t)stream;
  const float *bp = (const float*)bias, *mp = (const float*)mask;
  switch (hc) {
    case 1: return launch_wins_fwd<1>(in, o_map, bp, mp, nB, H, nW, mask_rows, wpc, k_head, v_head, scale, st);
    case 2: return launch_wins_fwd<2>(in, o_map, bp, mp, nB, H, nW, mask_rows, wpc, k_head, v_head, scale, st);
    case 3: return launch_wins_fwd<3>(in, o_map, bp, mp, nB, H, nW, mask_rows, wpc, k_head, v_head, scale, st);
    case 4: return launch_wins_fwd<4>(in, o_map, bp, mp, nB, H, nW, mask_rows, wpc, k_head, v_head, scale, st);
    case 6: return launch_wins_fwd<6>(in, o_map, bp, mp, nB, H, nW, mask_rows, wpc, k_head, v_head, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
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

// As the forward (hc <= 3), plus dout: contiguous (nB, 49, C) bf16; dq, dk,
// dv: (nB, 49, C) bf16 views sharing strides (gsw, gsn), 16-byte aligned,
// multiples of 8, unit stride in the channel; dbias_part: (ceil(nB / wpc),
// H, 49, 49) f32 scratch; dbias: (H, 49, 49) f32.
extern "C" int dinomc_wins_attn_bwd(const void* q, const void* k, const void* v,
                                    const void* dout, const void* bias, const void* mask,
                                    void* dq, void* dk, void* dv, void* dbias_part,
                                    void* dbias, int nB, int H, int hc, int nW, int mask_rows,
                                    int wpc, long long sw, long long sn, long long gsw,
                                    long long gsn, float scale, void* stream, int device) {
  if (hc < 1 || H % hc != 0) return (int)cudaErrorInvalidValue;
  const cudaError_t bound = cudaSetDevice(device);  // see hopper::make_map
  if (bound != cudaSuccess) return (int)bound;
  CUtensorMap in[3], grad[3], do_map;
  int k_head, v_head, dk_head, dv_head;
  CUresult res = hopper::win_triple_maps(in, k_head, v_head, q, k, v, nB, H, sw, sn);
  if (res == CUDA_SUCCESS)
    res = hopper::win_triple_maps(grad, dk_head, dv_head, dq, dk, dv, nB, H, gsw, gsn);
  if (res == CUDA_SUCCESS) res = hopper::make_map<HD>(&do_map, dout, nB, WW, H);
  if (res != CUDA_SUCCESS) return hopper::MAP_ERROR + (int)res;
  cudaStream_t st = (cudaStream_t)stream;
  const float *bp = (const float*)bias, *mp = (const float*)mask;
  float* part = (float*)dbias_part;
  int err;
  switch (hc) {
    case 1: err = launch_wins_bwd<1>(in, do_map, grad, bp, mp, part, nB, H, nW, mask_rows, wpc, k_head, v_head, dk_head, dv_head, scale, st); break;
    case 2: err = launch_wins_bwd<2>(in, do_map, grad, bp, mp, part, nB, H, nW, mask_rows, wpc, k_head, v_head, dk_head, dv_head, scale, st); break;
    case 3: err = launch_wins_bwd<3>(in, do_map, grad, bp, mp, part, nB, H, nW, mask_rows, wpc, k_head, v_head, dk_head, dv_head, scale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  const int nx = (nB + wpc - 1) / wpc, n = H * WW2;
  wins_dbias_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, (float*)dbias, nx, n);
  return (int)cudaGetLastError();
}
