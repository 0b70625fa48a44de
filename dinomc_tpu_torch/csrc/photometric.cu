// Fused photometric augmentation (K3) for sm_90a.
//
// Replaces: dinomc_tpu/ops/pallas/augment.py, `fused_photometric`
// (`_photometric_kernel`, `_hue_shift`, `_gray`).
//
// What it computes, per image of a planar (B, 3, S, S) f32 batch, with the
// decisions and factors of row b of the (B, 24) parameter table:
// brightness -> contrast against the image-wide mean gray -> saturation ->
// branch-free hue shift, selected per sample (RandomApply); random
// grayscale; separable 13-tap Gaussian blur with replicate padding, skipped
// per sample; solarize; normalize. The flip stays with the caller.
//
// What bounds it on this card: it is a streaming pass, ~30 flops per pixel
// without blur and ~110 with it, against 24 bytes of traffic per pixel
// (read and write 3 f32 planes): memory-bound. The TPU kernel held a whole
// image in VMEM; a 224x224x3 f32 image is 602 KB and does not fit in 227 KB
// of shared memory, and contrast needs the image's mean gray before any
// pixel can be finished.
//
// Design: two launches. The first reduces the mean gray of the
// brightness-clipped image, one block per image, in a fixed order (no
// atomics, so the result does not change from run to run). The second
// tiles each image into 32x32 blocks; a block loads its tile plus a 6-pixel
// halo, applies the pointwise jitter and grayscale on load, runs the H and
// then the W blur pass in shared memory when the sample's blur flag is set,
// then solarizes, normalizes and writes. Replicate padding is a clamp of
// the source index, since every stage before the blur is pointwise. When
// blur is off the block takes a separate branch that never touches the
// taps, so the output is exactly the pointwise result.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KR = 6;                 // kernel radius: 13 taps
constexpr int NTAPS = 2 * KR + 1;
constexpr int TILE = 32;
constexpr int HALO = TILE + 2 * KR;   // 44
constexpr int NTHREADS = 256;
// parameter row layout (dinomc_tpu/ops/pallas/augment.py:43-47)
constexpr int P_JIT = 1, P_FB = 2, P_FC = 3, P_FS = 4, P_FH = 5, P_GRAY = 6,
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

// Color jitter (RandomApply) then random grayscale, on one pixel.
__device__ __forceinline__ void pointwise(float& r, float& g, float& b,
                                          const float* p, float mean_gray) {
  if (p[P_JIT] > 0.5f) {
    const float fb = p[P_FB], fc = p[P_FC], fs = p[P_FS];
    float yr = clip01(r * fb), yg = clip01(g * fb), yb = clip01(b * fb);
    yr = clip01(fc * yr + (1.f - fc) * mean_gray);
    yg = clip01(fc * yg + (1.f - fc) * mean_gray);
    yb = clip01(fc * yb + (1.f - fc) * mean_gray);
    const float g3 = gray(yr, yg, yb);
    yr = clip01(fs * yr + (1.f - fs) * g3);
    yg = clip01(fs * yg + (1.f - fs) * g3);
    yb = clip01(fs * yb + (1.f - fs) * g3);
    hue_shift(yr, yg, yb, p[P_FH]);
    r = clip01(yr);
    g = clip01(yg);
    b = clip01(yb);
  }
  if (p[P_GRAY] > 0.5f) {
    const float gr = gray(r, g, b);
    r = gr;
    g = gr;
    b = gr;
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

// mean_gray[b] = mean over pixels of gray(clip(x * fb, 0, 1)); computed only
// for samples whose jitter is applied (the only readers).
__global__ void __launch_bounds__(NTHREADS)
mean_gray_kernel(const float* __restrict__ img, const float* __restrict__ params,
                 float* __restrict__ mean_gray, int S) {
  __shared__ float part[NTHREADS];
  const int b = blockIdx.x;
  const float* p = params + (long long)b * P_LEN;
  if (p[P_JIT] <= 0.5f) {
    if (threadIdx.x == 0) mean_gray[b] = 0.f;
    return;
  }
  const float fb = p[P_FB];
  const long long n = (long long)S * S;
  const float* base = img + (long long)b * 3 * n;
  float acc = 0.f;
  for (long long i = threadIdx.x; i < n; i += NTHREADS)
    acc += gray(clip01(base[i] * fb), clip01(base[n + i] * fb), clip01(base[2 * n + i] * fb));
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int off = NTHREADS / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) part[threadIdx.x] += part[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) mean_gray[b] = part[0] / (float)n;
}

__global__ void __launch_bounds__(NTHREADS)
photometric_kernel(const float* __restrict__ img, const float* __restrict__ params,
                   const float* __restrict__ mean_gray, float* __restrict__ out,
                   int S, Norm nm) {
  __shared__ float reg[3][HALO][HALO];   // tile + halo after the pointwise stages
  __shared__ float tmp[3][TILE][HALO];   // after the H pass
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TILE, tx0 = blockIdx.x * TILE;
  const float* p = params + (long long)b * P_LEN;
  const float mg = mean_gray[b];
  const bool sol = p[P_SOL] > 0.5f;
  const long long n = (long long)S * S;
  const float* src = img + (long long)b * 3 * n;
  float* dst = out + (long long)b * 3 * n;

  if (p[P_BLUR] > 0.5f) {
    float taps[NTAPS];
#pragma unroll
    for (int t = 0; t < NTAPS; ++t) taps[t] = p[P_TAPS + t];
    for (int i = threadIdx.x; i < HALO * HALO; i += NTHREADS) {
      const int ry = i / HALO, rx = i % HALO;
      const int sy = min(max(ty0 - KR + ry, 0), S - 1);
      const int sx = min(max(tx0 - KR + rx, 0), S - 1);
      const long long off = (long long)sy * S + sx;
      float r = src[off], g = src[n + off], bl = src[2 * n + off];
      pointwise(r, g, bl, p, mg);
      reg[0][ry][rx] = r;
      reg[1][ry][rx] = g;
      reg[2][ry][rx] = bl;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TILE * HALO; i += NTHREADS) {
      const int y = i / HALO, x = i % HALO;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float acc = taps[0] * reg[c][y][x];
#pragma unroll
        for (int t = 1; t < NTAPS; ++t) acc += taps[t] * reg[c][y + t][x];
        tmp[c][y][x] = acc;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TILE * TILE; i += NTHREADS) {
      const int y = i / TILE, x = i % TILE;
      const int gy = ty0 + y, gx = tx0 + x;
      if (gy >= S || gx >= S) continue;
      const long long off = (long long)gy * S + gx;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float acc = taps[0] * tmp[c][y][x];
#pragma unroll
        for (int t = 1; t < NTAPS; ++t) acc += taps[t] * tmp[c][y][x + t];
        dst[c * n + off] = finish(acc, c, sol, nm);
      }
    }
  } else {
    for (int i = threadIdx.x; i < TILE * TILE; i += NTHREADS) {
      const int y = i / TILE, x = i % TILE;
      const int gy = ty0 + y, gx = tx0 + x;
      if (gy >= S || gx >= S) continue;
      const long long off = (long long)gy * S + gx;
      float r = src[off], g = src[n + off], bl = src[2 * n + off];
      pointwise(r, g, bl, p, mg);
      dst[off] = finish(r, 0, sol, nm);
      dst[n + off] = finish(g, 1, sol, nm);
      dst[2 * n + off] = finish(bl, 2, sol, nm);
    }
  }
}

}  // namespace

// images, out: contiguous (B, 3, S, S) f32; params: contiguous (B, 24) f32;
// mean_gray: (B,) f32 scratch.
extern "C" int dinomc_photometric(const void* images, const void* params,
                                  void* mean_gray, void* out, int B, int S,
                                  float m0, float m1, float m2, float is0,
                                  float is1, float is2, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  mean_gray_kernel<<<B, NTHREADS, 0, st>>>((const float*)images, (const float*)params,
                                           (float*)mean_gray, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Norm nm = {{m0, m1, m2}, {is0, is1, is2}};
  const int tiles = (S + TILE - 1) / TILE;
  dim3 grid(tiles, tiles, B);
  photometric_kernel<<<grid, NTHREADS, 0, st>>>((const float*)images, (const float*)params,
                                                (const float*)mean_gray, (float*)out, S, nm);
  return (int)cudaGetLastError();
}
