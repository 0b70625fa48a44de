// Device code of the Hopper window attention: window_fwd_block, the
// forward that K7 (window_attention.cu) runs with one head a block and K9
// (window_attention_stacked.cu) with a chunk of HC heads a block; and
// window_bwd_block, the backward that K8 (window_attention.cu) runs with one
// head a block and K10 (window_attention_stacked.cu) with a chunk of HC
// heads. win_triple_maps encodes the q/k/v (and dq/dk/dv) maps of all four.
//
// What they compute, for every 49-token window w and head h (head_dim 32):
// P = softmax(Q K^T * scale + bias[h] + mask[w mod nW]) and O = P V forward;
// backward P recomputed exactly (no log-sum-exp is saved by the forward),
// dP = dO V^T, delta = rowsum(P * dP), dS = P * (dP - delta), dQ = dS K *
// scale, dK = dS^T Q * scale, dV = P^T dO, and dbias[h] = the sum of dS over
// all windows, in f32.
//
// What bounds them on this card: bytes. A (window, head) moves 3 * 49 * 64 B
// in and 49 * 64 B out for two 49 x 49 x 32 products forward, about 25 FLOP
// a byte, and 4 * 49 * 64 B in and 3 * 49 * 64 B out for five products
// backward, about 35 (60 as padded to 64 x 64 x 32), against the card's
// ~295.
//
// Design (hopper_attn.cuh's means):
// - A window is one 64-row TMA box a head a tensor: make_map<32> over the
//   (nB, 49, H, 32) view of a q/k/v channel slice or of dO, N = 49, so rows
//   49-63 arrive as zeros. A producer warp loads the block's HC heads of
//   Q, K, V (and dO) for each of its windows through a ring of STAGES
//   mbarrier-tracked stages, and copies the window's mask beside them, once
//   for all HC heads; window w + 1 lands while window w computes. The
//   forward's mask copy is cp.async, reported to the stage's barrier, so the
//   producer never waits on it; the backward's goes through registers.
// - One consumer warpgroup a head. S = Q K^T (and dP = dO V^T) are wgmma
//   products from shared memory (K-major, 64 x 64 f32 in registers). The
//   softmax (window_probs) is exact: bias[h] (copied to shared memory once
//   a block) and the mask are added in registers, dead entries (rows or
//   keys past 49) are -inf, and each row's max and sum (and delta) are
//   reduced over the four threads that hold it.
// - Forward: O = P V takes P, rounded to bf16, as the register A operand (V
//   read MN-major); neither S nor P touches shared memory. O is staged in
//   the window's Q box and leaves by a TMA store that clips rows past 49.
// - Backward: dQ = dS K takes dS as the register A operand (K read
//   MN-major). P and dS, rounded to bf16, are stored as 64 x 64 tiles of
//   128-byte swizzled rows (queries x keys); dK = dS^T Q and dV = P^T dO
//   read them transposed through a descriptor (A MN-major) against Q and dO
//   read MN-major. dQ, dK and dV are staged in the window's own Q, K and V
//   boxes and leave by TMA stores that clip rows past 49; the stage is
//   handed back to the producer once the stores have read it.
// - dbias is deterministic, with no atomics: each thread owns fixed (row,
//   column) elements of its head's 64 x 64 f32 sum, S's accumulator layout
//   in registers, across the block's windows; the block writes one (49, 49)
//   partial a head, and the caller sums the partials in a fixed order.

#pragma once

#include "hopper_attn.cuh"

namespace hopper {

constexpr int WIN_TOKENS = 49;  // a 7 x 7 window
constexpr int WIN_ELEMS = WIN_TOKENS * WIN_TOKENS;
constexpr int WIN_HD = 32;      // head dim

// In place: a warpgroup's 64 x 64 f32 scores S (queries x keys, the
// accumulator layout) -> P = softmax(S * scale + bias + mask) over each
// row's 49 keys, in f32. bias: (49, 49) in shared memory; ms: null or the
// window's (mask_rows, 49) mask in shared memory. Logits are taken in log2
// units; rows or keys past 49 are dead (-inf), and a padded row's P is 0,
// not NaN.
__device__ __forceinline__ void window_probs(float (&sc)[BOX_ROWS / 2], const float* bs,
                                             const float* ms, int mask_rows, int wl, int lane,
                                             float scale) {
  constexpr float log2e = 1.4426950408889634f;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BOX_ROWS / 2; ++i) {
    const int r = acc_row(wl, lane, i), c = acc_col(lane, i);
    float x = -INFINITY;
    if (r < WIN_TOKENS && c < WIN_TOKENS) {
      x = fmaf(sc[i], scale, bs[r * WIN_TOKENS + c]);
      if (ms) x += ms[(mask_rows == 1 ? 0 : r) * WIN_TOKENS + c];
      x *= log2e;
    }
    sc[i] = x;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    if (mx[rr] == -INFINITY) mx[rr] = 0.f;  // a padded row: its P is 0, not NaN
  }
#pragma unroll
  for (int i = 0; i < BOX_ROWS / 2; ++i) {
    sc[i] = exp2f(sc[i] - mx[(i / 2) % 2]);
    sum[(i / 2) % 2] += sc[i];
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 1);
    sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 2);
    sum[rr] = sum[rr] > 0.f ? 1.f / sum[rr] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < BOX_ROWS / 2; ++i) sc[i] *= sum[(i / 2) % 2];
}

template <int HC, int STAGES> struct WinFwdSmem {
  // a stage: each head's 64-row boxes; the Q box then stages O
  __nv_bfloat16 q[STAGES][HC][BOX_ROWS * WIN_HD];
  __nv_bfloat16 k[STAGES][HC][BOX_ROWS * WIN_HD];
  __nv_bfloat16 v[STAGES][HC][BOX_ROWS * WIN_HD];
  float mask[STAGES][WIN_ELEMS];  // the stage's window's mask, (1 or 49) x 49
  float bias[HC][WIN_ELEMS];
  uint64_t full[STAGES], empty[STAGES];
};

// The forward of the block's HC heads [blockIdx.y * HC, + HC) over its
// windows [blockIdx.x * wpc, + wpc) (fewer in the last block). Maps: q, k, v
// as for window_bwd_block (head h of k and v is head h + k_head, h + v_head
// of its map); o_map: make_map<32> of the (nB, 49, H, 32) output. bias: (H,
// 49, 49) f32; mask: null or (nW, mask_rows, 49) f32, window w reads
// mask[w mod nW]. Launch with 128 * HC + 32 threads and sizeof(WinFwdSmem)
// + 1024 bytes of dynamic shared memory.
template <int HC, int STAGES>
__device__ __forceinline__ void window_fwd_block(
    const CUtensorMap* q_map, const CUtensorMap* k_map, const CUtensorMap* v_map,
    const CUtensorMap* o_map, const float* __restrict__ bias, const float* __restrict__ mask,
    int nB, int nW, int mask_rows, int wpc, int k_head, int v_head, float scale) {
  constexpr int D = WIN_HD;
  constexpr uint32_t BOX = BOX_ROWS * D * 2;  // bytes of one box
  constexpr int ROW = Swizzle<D>::ROW;        // bytes of a box row
  using Smem = WinFwdSmem<HC, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = aligned_smem<Smem>(smem_raw);
  const int h0 = blockIdx.y * HC, w0 = blockIdx.x * wpc;
  const int nwin = min(wpc, nB - w0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // lane 0's TMA bytes, then every producer lane once its mask copies land
      mbar_init(&sm.full[s], 1 + 32);
      mbar_init(&sm.empty[s], HC);  // one arrival per consumer warpgroup, after its store
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * HC) {  // producer
    const int mask_elems = mask_rows * WIN_TOKENS;
    for (int t = 0; t < nwin; ++t) {
      const int s = t % STAGES, w = w0 + t;
      mbar_wait(&sm.empty[s], ((t / STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&sm.full[s], 3 * HC * BOX);
#pragma unroll
        for (int g = 0; g < HC; ++g) {
          tma_load(sm.q[s][g], q_map, &sm.full[s], h0 + g, 0, w);
          tma_load(sm.k[s][g], k_map, &sm.full[s], k_head + h0 + g, 0, w);
          tma_load(sm.v[s][g], v_map, &sm.full[s], v_head + h0 + g, 0, w);
        }
      }
      if (mask) {
        const float* mw = mask + (long long)(w % nW) * mask_elems;
        for (int i = lane; i < mask_elems; i += 32) cp_async4(&sm.mask[s][i], mw + i);
      }
      cp_async_arrive(&sm.full[s]);
    }
    cp_async_wait_all();
    return;
  }

  // consumers: warpgroup g owns head h0 + g
  const int g = warp / 4, wl = warp % 4, h = h0 + g;
  for (int i = threadIdx.x % 128; i < WIN_ELEMS; i += 128)
    sm.bias[g][i] = bias[(long long)h * WIN_ELEMS + i];
  named_sync(1 + g, 128);
  const float* bs = sm.bias[g];

  for (int t = 0; t < nwin; ++t) {
    const int s = t % STAGES, w = w0 + t;
    mbar_wait(&sm.full[s], (t / STAGES) & 1);
    __nv_bfloat16* q_tile = sm.q[s][g];
    const uint64_t q_desc = make_desc<D>(q_tile), k_desc = make_desc<D>(sm.k[s][g]);
    const uint64_t v_desc = make_desc<D>(sm.v[s][g]);

    float sc[BOX_ROWS / 2];  // S, then P: queries x keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    window_probs(sc, bs, mask ? sm.mask[s] : nullptr, mask_rows, wl, lane, scale);

    uint32_t pa[BOX_ROWS / 16][4];  // P, bf16, as the A operand of each 16-key slice
#pragma unroll
    for (int kk = 0; kk < BOX_ROWS / 16; ++kk) to_a_operand(pa[kk], sc, kk);
    float acc[D / 2];  // O: queries x head dim
    zero(acc);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BOX_ROWS / 16; ++kk)
      wgmma_rs<D>(acc, pa[kk], v_desc + (uint64_t)((kk * 16 * ROW) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    // the products that read Q have completed: the box takes O
    stage_rows<D>(reinterpret_cast<unsigned char*>(q_tile), acc, wl, lane, 1.f, 1.f);
    fence_async_smem();
    named_sync(1 + g, 128);
    if (wl == 0 && lane == 0) {
      tma_store(o_map, q_tile, h, 0, w);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // the box is read
      mbar_arrive(&sm.empty[s]);
    }
  }
  if (wl == 0 && lane == 0) tma_store_wait();
}

template <int HC, int STAGES> struct WinBwdSmem {
  // a stage: each head's 64-row boxes; the Q, K, V boxes then stage dQ, dK, dV
  __nv_bfloat16 q[STAGES][HC][BOX_ROWS * WIN_HD];
  __nv_bfloat16 k[STAGES][HC][BOX_ROWS * WIN_HD];
  __nv_bfloat16 v[STAGES][HC][BOX_ROWS * WIN_HD];
  __nv_bfloat16 dout[STAGES][HC][BOX_ROWS * WIN_HD];
  __nv_bfloat16 p[HC][BOX_ROWS * BOX_ROWS];   // P, queries x keys, 128-byte rows
  __nv_bfloat16 ds[HC][BOX_ROWS * BOX_ROWS];  // dS, the same
  float mask[STAGES][WIN_ELEMS];              // the stage's window's mask, (1 or 49) x 49
  float bias[HC][WIN_ELEMS];
  uint64_t full[STAGES], empty[STAGES];
};

// The backward of the block's HC heads [blockIdx.y * HC, + HC) over its
// windows [blockIdx.x * wpc, + wpc) (fewer in the last block). Maps: q, k, v
// (the (nB, 49, H, 32) views the forward read), dout, dq, dk, dv, all
// make_map<32> with N = 49; head h of k, v, dk and dv is head h + k_head,
// h + v_head, h + dk_head, h + dv_head of its map, so one map over a (nB,
// 49, 3H, 32) qkv tensor serves q, k and v (offsets H and 2H; 0 for maps of
// their own), and one over a (nB, 49, 3H, 32) buffer dq, dk and dv. bias:
// (H, 49, 49) f32; mask:
// null or (nW, mask_rows, 49) f32, window w reads mask[w mod nW];
// dbias_part: (gridDim.x, H, 49, 49) f32, this block's sums. Launch with
// 128 * HC + 32 threads and sizeof(WinBwdSmem) + 1024 bytes of dynamic
// shared memory.
template <int HC, int STAGES>
__device__ __forceinline__ void window_bwd_block(
    const CUtensorMap* q_map, const CUtensorMap* k_map, const CUtensorMap* v_map,
    const CUtensorMap* do_map, const CUtensorMap* dq_map, const CUtensorMap* dk_map,
    const CUtensorMap* dv_map, const float* __restrict__ bias, const float* __restrict__ mask,
    float* __restrict__ dbias_part, int nB, int H, int nW, int mask_rows, int wpc, int k_head,
    int v_head, int dk_head, int dv_head, float scale) {
  constexpr int D = WIN_HD;
  constexpr uint32_t BOX = BOX_ROWS * D * 2;  // bytes of one box
  constexpr int ROW = Swizzle<D>::ROW;        // bytes of a box row
  constexpr int PROW = Swizzle<64>::ROW;      // bytes of a P / dS row
  using Smem = WinBwdSmem<HC, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = aligned_smem<Smem>(smem_raw);
  const int h0 = blockIdx.y * HC, w0 = blockIdx.x * wpc;
  const int nwin = min(wpc, nB - w0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 32);  // every producer lane, one with the TMA bytes
      mbar_init(&sm.empty[s], HC);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * HC) {  // producer
    const int mask_elems = mask_rows * WIN_TOKENS;
    for (int t = 0; t < nwin; ++t) {
      const int s = t % STAGES, w = w0 + t;
      mbar_wait(&sm.empty[s], ((t / STAGES) & 1) ^ 1);
      if (mask) {
        const float* mw = mask + (long long)(w % nW) * mask_elems;
        for (int i = lane; i < mask_elems; i += 32) sm.mask[s][i] = mw[i];
      }
      if (lane == 0) {
        mbar_expect_tx(&sm.full[s], 4 * HC * BOX);
#pragma unroll
        for (int g = 0; g < HC; ++g) {
          tma_load(sm.q[s][g], q_map, &sm.full[s], h0 + g, 0, w);
          tma_load(sm.k[s][g], k_map, &sm.full[s], k_head + h0 + g, 0, w);
          tma_load(sm.v[s][g], v_map, &sm.full[s], v_head + h0 + g, 0, w);
          tma_load(sm.dout[s][g], do_map, &sm.full[s], h0 + g, 0, w);
        }
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup g owns head h0 + g
  const int g = warp / 4, wl = warp % 4, h = h0 + g;
  for (int i = threadIdx.x % 128; i < WIN_ELEMS; i += 128)
    sm.bias[g][i] = bias[(long long)h * WIN_ELEMS + i];
  named_sync(1 + g, 128);
  const float* bs = sm.bias[g];
  const uint64_t p_desc = make_desc<64>(sm.p[g]), ds_desc = make_desc<64>(sm.ds[g]);
  float dbias[BOX_ROWS / 2];  // this thread's elements of the head's dbias, in S's layout
  zero(dbias);

  for (int t = 0; t < nwin; ++t) {
    const int s = t % STAGES, w = w0 + t;
    mbar_wait(&sm.full[s], (t / STAGES) & 1);
    __nv_bfloat16 *q_tile = sm.q[s][g], *k_tile = sm.k[s][g], *v_tile = sm.v[s][g];
    const uint64_t q_desc = make_desc<D>(q_tile), k_desc = make_desc<D>(k_tile);
    const uint64_t v_desc = make_desc<D>(v_tile), do_desc = make_desc<D>(sm.dout[s][g]);

    float sc[BOX_ROWS / 2], dp[BOX_ROWS / 2];  // S and dP: queries x keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(dp, do_desc + 2 * kk, v_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    window_probs(sc, bs, mask ? sm.mask[s] : nullptr, mask_rows, wl, lane, scale);  // P
    float delta[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BOX_ROWS / 2; ++i) delta[(i / 2) % 2] += sc[i] * dp[i];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      delta[rr] += __shfl_xor_sync(0xffffffffu, delta[rr], 1);
      delta[rr] += __shfl_xor_sync(0xffffffffu, delta[rr], 2);
    }
#pragma unroll
    for (int i = 0; i < BOX_ROWS / 2; ++i) {
      dp[i] = sc[i] * (dp[i] - delta[(i / 2) % 2]);  // dS, 0 where P is
      dbias[i] += dp[i];
    }

    stage_rows<64>(reinterpret_cast<unsigned char*>(sm.p[g]), sc, wl, lane, 1.f, 1.f);
    stage_rows<64>(reinterpret_cast<unsigned char*>(sm.ds[g]), dp, wl, lane, 1.f, 1.f);
    uint32_t dsa[BOX_ROWS / 16][4];  // dS, bf16, as the A operand of each 16-key slice
#pragma unroll
    for (int kk = 0; kk < BOX_ROWS / 16; ++kk) to_a_operand(dsa[kk], dp, kk);
    fence_async_smem();
    named_sync(1 + g, 128);  // every row of P and dS is stored

    float dq[D / 2], dk[D / 2], dv[D / 2];
    zero(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BOX_ROWS / 16; ++kk)
      wgmma_rs<D>(dq, dsa[kk], k_desc + (uint64_t)((kk * 16 * ROW) >> 4));
#pragma unroll
    for (int kk = 0; kk < BOX_ROWS / 16; ++kk)
      wgmma_ss_tt_n32(dk, ds_desc + (uint64_t)((kk * 16 * PROW) >> 4),
                      q_desc + (uint64_t)((kk * 16 * ROW) >> 4), kk);
#pragma unroll
    for (int kk = 0; kk < BOX_ROWS / 16; ++kk)
      wgmma_ss_tt_n32(dv, p_desc + (uint64_t)((kk * 16 * PROW) >> 4),
                      do_desc + (uint64_t)((kk * 16 * ROW) >> 4), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dk);
    fence_regs(dv);

    named_sync(1 + g, 128);  // the warpgroup is done reading the window's boxes, P and dS
    stage_rows<D>(reinterpret_cast<unsigned char*>(q_tile), dq, wl, lane, scale, scale);
    stage_rows<D>(reinterpret_cast<unsigned char*>(k_tile), dk, wl, lane, scale, scale);
    stage_rows<D>(reinterpret_cast<unsigned char*>(v_tile), dv, wl, lane, 1.f, 1.f);
    fence_async_smem();
    named_sync(1 + g, 128);
    if (wl == 0 && lane == 0) {
      tma_store(dq_map, q_tile, h, 0, w);
      tma_store(dk_map, k_tile, dk_head + h, 0, w);
      tma_store(dv_map, v_tile, dv_head + h, 0, w);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // the boxes are read
      mbar_arrive(&sm.empty[s]);
    }
  }
  if (wl == 0 && lane == 0) tma_store_wait();

  float* part = dbias_part + ((long long)blockIdx.x * H + h) * WIN_ELEMS;
#pragma unroll
  for (int i = 0; i < BOX_ROWS / 2; ++i) {
    const int r = acc_row(wl, lane, i), c = acc_col(lane, i);
    if (r < WIN_TOKENS && c < WIN_TOKENS) part[r * WIN_TOKENS + c] = dbias[i];
  }
}

// Host: the maps of one (q, k, v) or (dq, dk, dv) triple of (nB, 49, H *
// 32) bf16 views with strides (sw, sn) and unit stride in the channel. When
// b and c follow a by C and 2C channels (column slices of one (nB, 49, 3C)
// tensor, as Swin passes them), one map over 3H heads serves all three,
// with b and c at head offsets H and 2H; else a map each, offsets 0. The
// caller has bound its device (see make_map).
inline CUresult win_triple_maps(CUtensorMap (&m)[3], int& b_head, int& c_head, const void* a,
                                const void* b, const void* c, int nB, int H, long long sw,
                                long long sn) {
  const long long C = (long long)H * WIN_HD * 2;  // bytes of a token's channels
  const char* base = static_cast<const char*>(a);
  if (static_cast<const char*>(b) == base + C && static_cast<const char*>(c) == base + 2 * C) {
    b_head = H;
    c_head = 2 * H;
    const CUresult res = make_map<WIN_HD>(&m[0], a, nB, WIN_TOKENS, 3 * H, sw, sn, WIN_HD);
    m[1] = m[0];
    m[2] = m[0];
    return res;
  }
  b_head = c_head = 0;
  CUresult res = make_map<WIN_HD>(&m[0], a, nB, WIN_TOKENS, H, sw, sn, WIN_HD);
  if (res == CUDA_SUCCESS) res = make_map<WIN_HD>(&m[1], b, nB, WIN_TOKENS, H, sw, sn, WIN_HD);
  if (res == CUDA_SUCCESS) res = make_map<WIN_HD>(&m[2], c, nB, WIN_TOKENS, H, sw, sn, WIN_HD);
  return res;
}

}  // namespace hopper
