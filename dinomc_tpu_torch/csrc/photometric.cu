// Fused photometric augmentation (K3) for sm_90a.
//
// Replaces: dinomc_tpu/ops/pallas/augment.py, `fused_photometric`
// (`_photometric_kernel`, `_hue_shift`, `_gray`).
//
// What it computes, per image of a planar (B, 3, S, S) f32 batch, with the
// decisions and factors of row b of the (B, 24) parameter table: horizontal
// flip (when the caller asks for it, by the row's P_FLIP) -> brightness ->
// contrast against the image-wide mean gray -> saturation -> branch-free hue
// shift, selected per sample (RandomApply); random grayscale; separable
// 13-tap Gaussian blur with replicate padding, skipped per sample; solarize;
// normalize. The TPU kernel left the flip to its caller (Mosaic has no lane
// reverse); here it is a mirrored source column.
//
// What bounds it on this card: it is a streaming pass, ~30 flops per pixel
// without blur and ~110 with it, against 24 bytes of traffic per pixel
// (read and write 3 f32 planes): memory-bound. The TPU kernel held a whole
// image in VMEM; a 224x224x3 f32 image is 602 KB and does not fit in 227 KB
// of shared memory, and contrast needs the image's mean gray before any
// pixel can be finished.
//
// Design: two launches over the whole grid.
// - gray_partials_kernel: one block per band of PART_ROWS image rows of an
//   image (28 bands at 224 px, 224 blocks at B = 8, not one block per
//   image), each writing the sum of gray(clip(x * fb, 0, 1)) over its band.
//   The flip does not change a sum over every pixel, so this pass ignores it.
// - photometric_kernel: 32x32 output tiles. Warp 0 first sums its image's
//   partials in a fixed order (a strided sum over the lanes, then a fixed
//   shuffle tree), so the mean gray is deterministic with no atomics. A
//   block loads its tile plus a 6-row halo and an 8-column one (whole
//   4-column groups), applies the pointwise jitter and grayscale on load,
//   runs the H and then the W blur pass in shared memory when the sample's
//   blur flag is set, then solarizes, normalizes and writes. Replicate
//   padding is a clamp of the output-space index, since every stage before
//   the blur is pointwise, and a flipped row reads source column S - 1 - x.
//   When blur is off the block takes a separate branch that never touches
//   the taps, so the output is exactly the pointwise result.
// - Where S % 4 == 0 (every DINO crop size: 224, 184, ..., 84), both passes
//   load and store 16 bytes a thread along a row (a flipped group is the
//   mirrored aligned group, reversed in registers); other sizes take a
//   scalar path with the same arithmetic.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KR = 6;                 // kernel radius: 13 taps
constexpr int NTAPS = 2 * KR + 1;
constexpr int TILE = 32;              // output tile side
constexpr int HROWS = TILE + 2 * KR;  // 44 halo rows
constexpr int HCOLS = TILE + 16;      // 48 halo columns: 8 a side, whole 4-column groups
constexpr int HGROUPS = HCOLS / 4;
constexpr int TGROUPS = TILE / 4;
constexpr int PHOTO_THREADS = 512;   // a block's; timed by scripts/attention_variants.py
constexpr int PART_ROWS = 8;          // image rows a mean-gray partial sums
// parameter row layout (dinomc_tpu/ops/pallas/augment.py:43-47)
constexpr int P_FLIP = 0, P_JIT = 1, P_FB = 2, P_FC = 3, P_FS = 4, P_FH = 5, P_GRAY = 6,
              P_BLUR = 7, P_SOL = 8, P_TAPS = 10, P_LEN = 24;

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }

__device__ __forceinline__ float gray(float r, float g, float b) {
  return 0.299f * r + 0.587f * g + 0.114f * b;
}

// RGB -> HSV -> (h + fh) mod 1 -> RGB, the branch-free reconstruction of
// the TPU kernel's `_hue_shift`.
__device__ __forceinline__ void hue_shift(float& r, float& g, float& b, float fh) {
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float v = maxc;
  const float delta = maxc - minc;
  const float s = maxc > 0.f ? delta / fmaxf(maxc, 1e-12f) : 0.f;
  const float safe = fmaxf(delta, 1e-12f);
  const float rc = (maxc - r) / safe;
  const float gc = (maxc - g) / safe;
  const float bc = (maxc - b) / safe;
  const float h0 = maxc == r ? bc - gc : (maxc == g ? 2.f + rc - bc : 4.f + gc - rc);
  float h = h0 * (1.f / 6.f);
  h = h < 0.f ? h + 1.f : h;
  h = delta > 0.f ? h : 0.f;
  h = h + fh;
  h = h < 0.f ? h + 1.f : h;
  h = h >= 1.f ? h - 1.f : h;
  const float h6 = h * 6.f;
  const float vs = v * s;
  float out[3];
  const float ns[3] = {5.f, 3.f, 1.f};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float k = h6 + ns[i];
    k = k - 6.f * floorf(k * (1.f / 6.f));
    out[i] = v - vs * clip01(fminf(k, 4.f - k));
  }
  r = out[0];
  g = out[1];
  b = out[2];
}

// One sample's decisions and factors, read from its parameter row once a
// block.
struct Row {
  bool jit, grayscale, blur, sol, flip;
  float fb, fc, fs, fh;
};

__device__ __forceinline__ Row load_row(const float* __restrict__ p, int flip) {
  Row rw;
  rw.jit = p[P_JIT] > 0.5f;
  rw.grayscale = p[P_GRAY] > 0.5f;
  rw.blur = p[P_BLUR] > 0.5f;
  rw.sol = p[P_SOL] > 0.5f;
  rw.flip = flip && p[P_FLIP] > 0.5f;
  rw.fb = p[P_FB];
  rw.fc = p[P_FC];
  rw.fs = p[P_FS];
  rw.fh = p[P_FH];
  return rw;
}

// Color jitter on one pixel: brightness, contrast against the mean gray,
// saturation, hue.
__device__ __forceinline__ void jitter(float& r, float& g, float& b, const Row& rw,
                                       float mean_gray) {
  float yr = clip01(r * rw.fb), yg = clip01(g * rw.fb), yb = clip01(b * rw.fb);
  yr = clip01(rw.fc * yr + (1.f - rw.fc) * mean_gray);
  yg = clip01(rw.fc * yg + (1.f - rw.fc) * mean_gray);
  yb = clip01(rw.fc * yb + (1.f - rw.fc) * mean_gray);
  const float g3 = gray(yr, yg, yb);
  yr = clip01(rw.fs * yr + (1.f - rw.fs) * g3);
  yg = clip01(rw.fs * yg + (1.f - rw.fs) * g3);
  yb = clip01(rw.fs * yb + (1.f - rw.fs) * g3);
  hue_shift(yr, yg, yb, rw.fh);
  r = clip01(yr);
  g = clip01(yg);
  b = clip01(yb);
}

// Color jitter (RandomApply) then random grayscale on four pixels,
// px[channel][pixel]; the sample's branches are taken once for the four,
// so their chains interleave.
__device__ __forceinline__ void pointwise4(float (&px)[3][4], const Row& rw, float mean_gray) {
  if (rw.jit) {
#pragma unroll
    for (int k = 0; k < 4; ++k) jitter(px[0][k], px[1][k], px[2][k], rw, mean_gray);
  }
  if (rw.grayscale) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float gr = gray(px[0][k], px[1][k], px[2][k]);
      px[0][k] = gr;
      px[1][k] = gr;
      px[2][k] = gr;
    }
  }
}

struct Norm {
  float mean[3];
  float inv_std[3];
};

__device__ __forceinline__ float finish(float x, int c, bool sol, const Norm& nm) {
  if (sol) x = x >= (float)(128.0 / 255.0) ? 1.f - x : x;
  return (x - nm.mean[c]) * nm.inv_std[c];
}

// Output-space columns c4 .. c4 + 3 of row sy of one plane, each clamped to
// [0, S) (replicate padding) and read at S - 1 - column when `flip`. VEC
// (S % 4 == 0, c4 % 4 == 0): a group inside the image is one 16-byte load.
template <bool VEC>
__device__ __forceinline__ void load4(float (&v)[4], const float* __restrict__ plane, int S,
                                      int sy, int c4, bool flip) {
  const float* row = plane + (long long)sy * S;
  if (VEC && c4 >= 0 && c4 + 4 <= S) {
    const float4 x = *reinterpret_cast<const float4*>(row + (flip ? S - 4 - c4 : c4));
    v[0] = flip ? x.w : x.x;
    v[1] = flip ? x.z : x.y;
    v[2] = flip ? x.y : x.z;
    v[3] = flip ? x.x : x.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = min(max(c4 + k, 0), S - 1);
    v[k] = row[flip ? S - 1 - c : c];
  }
}

// Columns c4 .. c4 + 3 of row gy of one plane, those inside the image; the
// caller has checked c4 < S (with VEC, c4 + 4 <= S follows).
template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ plane, int S, int gy, int c4,
                                       const float (&v)[4]) {
  float* row = plane + (long long)gy * S;
  if (VEC) {
    *reinterpret_cast<float4*>(row + c4) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (c4 + k < S) row[c4 + k] = v[k];
}

// parts[b * S + i]: the sum of gray(clip(x * fb, 0, 1)) over image rows
// [i * PART_ROWS, + PART_ROWS) of image b; written only for samples whose
// jitter is applied (the only readers). Grid (ceil(S / PART_ROWS), B).
template <bool VEC>
__global__ void __launch_bounds__(PHOTO_THREADS)
gray_partials_kernel(const float* __restrict__ img, const float* __restrict__ params,
                     float* __restrict__ parts, int S) {
  __shared__ float red[PHOTO_THREADS];
  const int b = blockIdx.y, part = blockIdx.x;
  const float* p = params + (long long)b * P_LEN;
  if (p[P_JIT] <= 0.5f) return;
  const float fb = p[P_FB];
  const long long n = (long long)S * S;
  const int r0 = part * PART_ROWS, rows = min(PART_ROWS, S - r0);
  const float* base = img + (long long)b * 3 * n + (long long)r0 * S;
  const int cnt = rows * S;  // values of the band in one plane
  float acc = 0.f;
  if (VEC) {
    const float4* r4 = reinterpret_cast<const float4*>(base);
    const float4* g4 = reinterpret_cast<const float4*>(base + n);
    const float4* b4 = reinterpret_cast<const float4*>(base + 2 * n);
    for (int i = threadIdx.x; i < cnt / 4; i += PHOTO_THREADS) {
      const float4 r = r4[i], g = g4[i], bl = b4[i];
      acc += gray(clip01(r.x * fb), clip01(g.x * fb), clip01(bl.x * fb));
      acc += gray(clip01(r.y * fb), clip01(g.y * fb), clip01(bl.y * fb));
      acc += gray(clip01(r.z * fb), clip01(g.z * fb), clip01(bl.z * fb));
      acc += gray(clip01(r.w * fb), clip01(g.w * fb), clip01(bl.w * fb));
    }
  } else {
    for (int i = threadIdx.x; i < cnt; i += PHOTO_THREADS)
      acc += gray(clip01(base[i] * fb), clip01(base[n + i] * fb), clip01(base[2 * n + i] * fb));
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int off = PHOTO_THREADS / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) red[threadIdx.x] += red[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) parts[(long long)b * S + part] = red[0];
}

// Grid (ceil(S / TILE), ceil(S / TILE), B); flip: apply each row's P_FLIP.
template <bool VEC>
__global__ void __launch_bounds__(PHOTO_THREADS)
photometric_kernel(const float* __restrict__ img, const float* __restrict__ params,
                   const float* __restrict__ parts, float* __restrict__ out, int S, int flip,
                   Norm nm) {
  __shared__ __align__(16) float reg[3][HROWS][HCOLS];  // tile + halo after the pointwise stages
  __shared__ __align__(16) float tmp[3][TILE][HCOLS];   // after the H pass
  __shared__ float mean_gray;
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TILE, tx0 = blockIdx.x * TILE;
  const float* p = params + (long long)b * P_LEN;
  const Row rw = load_row(p, flip);
  const long long n = (long long)S * S;
  const float* src = img + (long long)b * 3 * n;
  float* dst = out + (long long)b * 3 * n;

  if (rw.jit && threadIdx.x < 32) {  // the image's partials, summed in a fixed order
    const int nparts = (S + PART_ROWS - 1) / PART_ROWS;
    float acc = 0.f;
    for (int i = threadIdx.x; i < nparts; i += 32) acc += parts[(long long)b * S + i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (threadIdx.x == 0) mean_gray = acc / (float)n;
  }
  __syncthreads();
  const float mg = rw.jit ? mean_gray : 0.f;

  if (rw.blur) {
    float taps[NTAPS];
#pragma unroll
    for (int t = 0; t < NTAPS; ++t) taps[t] = p[P_TAPS + t];
    for (int i = threadIdx.x; i < HROWS * HGROUPS; i += PHOTO_THREADS) {
      const int ry = i / HGROUPS, gx = i % HGROUPS;
      const int sy = min(max(ty0 - KR + ry, 0), S - 1);
      float px[3][4];
#pragma unroll
      for (int c = 0; c < 3; ++c) load4<VEC>(px[c], src + c * n, S, sy, tx0 - 8 + 4 * gx, rw.flip);
      pointwise4(px, rw, mg);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        *reinterpret_cast<float4*>(&reg[c][ry][4 * gx]) =
            make_float4(px[c][0], px[c][1], px[c][2], px[c][3]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * TILE * HGROUPS; i += PHOTO_THREADS) {
      const int c = i / (TILE * HGROUPS), y = (i / HGROUPS) % TILE, x = 4 * (i % HGROUPS);
      float4 v = *reinterpret_cast<const float4*>(&reg[c][y][x]);
      float4 acc = make_float4(taps[0] * v.x, taps[0] * v.y, taps[0] * v.z, taps[0] * v.w);
#pragma unroll
      for (int t = 1; t < NTAPS; ++t) {
        v = *reinterpret_cast<const float4*>(&reg[c][y + t][x]);
        acc.x += taps[t] * v.x;
        acc.y += taps[t] * v.y;
        acc.z += taps[t] * v.z;
        acc.w += taps[t] * v.w;
      }
      *reinterpret_cast<float4*>(&tmp[c][y][x]) = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TILE * TGROUPS; i += PHOTO_THREADS) {
      const int y = i / TGROUPS, gx = i % TGROUPS;
      const int gy = ty0 + y, c4 = tx0 + 4 * gx;
      if (gy >= S || c4 >= S) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        // tmp column j is output column tx0 - 8 + j: output x reads j = x + 2 .. x + 14
        float w[20];
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(&tmp[c][y][4 * gx + 4 * j]);
          w[4 * j] = v.x;
          w[4 * j + 1] = v.y;
          w[4 * j + 2] = v.z;
          w[4 * j + 3] = v.w;
        }
        float o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float acc = taps[0] * w[k + 2];
#pragma unroll
          for (int t = 1; t < NTAPS; ++t) acc += taps[t] * w[k + 2 + t];
          o[k] = finish(acc, c, rw.sol, nm);
        }
        store4<VEC>(dst + c * n, S, gy, c4, o);
      }
    }
  } else {
    for (int i = threadIdx.x; i < TILE * TGROUPS; i += PHOTO_THREADS) {
      const int y = i / TGROUPS, gx = i % TGROUPS;
      const int gy = ty0 + y, c4 = tx0 + 4 * gx;
      if (gy >= S || c4 >= S) continue;
      float px[3][4];
#pragma unroll
      for (int c = 0; c < 3; ++c) load4<VEC>(px[c], src + c * n, S, gy, c4, rw.flip);
      pointwise4(px, rw, mg);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = finish(px[c][k], c, rw.sol, nm);
        store4<VEC>(dst + c * n, S, gy, c4, o);
      }
    }
  }
}

template <bool VEC>
cudaError_t launch(const float* images, const float* params, float* parts, float* out, int B,
                   int S, int flip, const Norm& nm, cudaStream_t st) {
  gray_partials_kernel<VEC><<<dim3((S + PART_ROWS - 1) / PART_ROWS, B), PHOTO_THREADS, 0, st>>>(
      images, params, parts, S);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = (S + TILE - 1) / TILE;
  photometric_kernel<VEC><<<dim3(tiles, tiles, B), PHOTO_THREADS, 0, st>>>(images, params, parts, out,
                                                                       S, flip, nm);
  return cudaGetLastError();
}

}  // namespace

// images, out: contiguous (B, 3, S, S) f32; params: contiguous (B, 24) f32;
// partials: (B, S) f32 scratch; flip: nonzero to apply each row's P_FLIP.
extern "C" int dinomc_photometric(const void* images, const void* params, void* partials,
                                  void* out, int B, int S, int flip, float m0, float m1,
                                  float m2, float is0, float is1, float is2, void* stream) {
  const Norm nm = {{m0, m1, m2}, {is0, is1, is2}};
  const float* in = (const float*)images;
  const float* pr = (const float*)params;
  float* parts = (float*)partials;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(S % 4 == 0 ? launch<true>(in, pr, parts, (float*)out, B, S, flip, nm, st)
                          : launch<false>(in, pr, parts, (float*)out, B, S, flip, nm, st));
}
