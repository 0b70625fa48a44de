// Device code shared by the Hopper kernels: the short-sequence attention
// forward K1 and backward K2 (attention.cu), the long-sequence forward K4,
// dQ K5 and dK/dV K6 (attention_long.cu), through hopper_window.cuh the
// window-attention forward K7 and backward K8 (window_attention.cu) and
// their head-stacked K9 and K10 (window_attention_stacked.cu), and the fused
// MLP K11 (fused_mlp.cu).
//
// - TMA: a tensor map per (B, N, h, d) bf16 tensor, or per (rows, cols)
//   matrix (make_map_2d, K11), encoded on the host per call and passed to
//   the kernel as a __grid_constant__ parameter; loads of boxes into shared
//   memory (rows past the tensor arrive as zeros) and stores that clip them.
// - An mbarrier ring: "full" barriers that complete when a stage's bytes
//   have landed, "empty" barriers that the consumer warps arrive on when
//   they are done with a stage.
// - wgmma: shared-memory descriptors, fences, commit/wait, and the m64nNk16
//   bf16 -> f32 instructions with both operands in shared memory (the
//   score-like products and K11's first product, K-major; or both MN-major,
//   reading a stored tile transposed) or A in registers and B MN-major (the
//   products that accumulate over keys or queries) or K-major (K11's second
//   product, against W2's rows).
// - The accumulator layout: thread t of warp w in a warpgroup holds, for
//   each 8-column slice j, rows 16w + t/4 (+8) and columns 8j + 2(t%4)
//   (+1), registers 4j + {0, 1} (row) and 4j + {2, 3} (row + 8). Two
//   adjacent slices, rounded to bf16 and packed, are exactly the register
//   A operand of the next product's 16-deep k-slice, so scores (and K11's
//   hidden activation) never go through shared memory.
//
// - The masks of packed crops (key_live, live_range, edge_tile), the dK/dV
//   block (dkv_block) that K2's second launch and K6 both run, and the dQ
//   block (dq_block) that K2's first launch and K5 both run: K6 and K5 are
//   the case boundary = 0, with their own tile constants.
//
// Every attention tile is d bf16 values a row, so a row is 2d bytes (128,
// 64 or 32) and the swizzle is that width: TMA writes it, the wgmma
// descriptors read it, and the epilogue writes it by hand (swz below);
// tiles start on 1024 bytes so the pattern is the same whatever the tile's
// address.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

template <int D> struct Swizzle {
  static_assert(D == 16 || D == 32 || D == 64, "head dim 16, 32 or 64");
  static constexpr int ROW = 2 * D;  // bytes per tile row
  static constexpr int BITS = D == 64 ? 3 : D == 32 ? 2 : 1;
  static constexpr uint64_t LAYOUT = D == 64 ? 1 : D == 32 ? 2 : 3;  // wgmma: 128B, 64B, 32B
  static constexpr CUtensorMapSwizzle TMA =
      D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                     : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr uint32_t SBO = 8 * ROW;  // bytes between 8-row groups
};

constexpr int BOX_ROWS = 64;  // rows of every TMA box

// ---------------------------------------------------------------------------
// Host: tensor maps. cuTensorMapEncodeTiled is a driver function; it is
// fetched through the runtime so the library links as before (no -lcuda).
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// What a launcher returns when a tensor map cannot be encoded: this plus
// the driver's CUresult (CUDA_ERROR_NOT_FOUND when the driver has no
// cuTensorMapEncodeTiled). Any other nonzero return is a cudaError_t.
constexpr int MAP_ERROR = 10000;

// Map of a (B, N, H, D) bf16 tensor with element strides (sb, sn, sh) and
// unit stride in D, in 64-row boxes of one (batch, head). Dimensions run
// D, H, N, B (innermost first) so the strides grow for both the qkv views
// and contiguous tensors. Out-of-bounds rows load as zeros. Encoding needs
// a current context: a launcher first makes its device's current
// (cudaSetDevice), as a thread that has made no runtime call of this
// library's own yet (autograd's worker, running a backward) may have none.
template <int D>
inline CUresult make_map(CUtensorMap* map, const void* base, int B, int N, int H, long long sb,
                         long long sn, long long sh) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sn * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)BOX_ROWS, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, Swizzle<D>::TMA,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A contiguous (B, N, H, D) tensor.
template <int D>
inline CUresult make_map(CUtensorMap* map, const void* base, int B, int N, int H) {
  return make_map<D>(map, base, B, N, H, (long long)N * H * D, (long long)H * D, D);
}

// Map of a (rows, cols) bf16 matrix with a row stride of `ld` elements
// and unit stride along a row, in boxes of (box_rows, box_cols) with
// `swizzle` (box_cols * 2 bytes must not exceed the swizzle's width). Rows
// past `rows` load as zeros, and stores clip them. The caller has bound its
// device (see make_map).
inline CUresult make_map_2d(CUtensorMap* map, const void* base, int rows, int cols, long long ld,
                            int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Raise a kernel's dynamic shared memory limit, once per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

// ---------------------------------------------------------------------------
// Device: shared memory, TMA and the mbarrier ring.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The dynamic shared memory, moved up to the next 1024-byte boundary (the
// launch asks for 1024 bytes more than the layout needs).
template <typename T>
__device__ __forceinline__ T& aligned_smem(unsigned char* raw) {
  const uint32_t pad = (1024u - (smem_addr(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<T*>(raw + pad);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// After every mbar_init, before any thread uses a barrier.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy 4 bytes from global to shared memory without going through
// registers; cp_async_arrive reports the copy to an mbarrier.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// Arrive on `bar` once every cp.async this thread issued so far has landed.
// The arrival is one of the barrier's expected count (noinc), so a barrier
// that waits for it is initialised to count it.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// Wait until every cp.async this thread issued has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// One 64-row box of (batch b, head h) starting at row `row` into `dst`;
// completes `bytes` on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int h,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(0), "r"(h), "r"(row), "r"(b)
      : "memory");
}

// Store a 64-row box from shared memory; rows past N are clipped. The
// caller fences (fence_async_smem) and syncs the writers first.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int h, int row,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(0), "r"(h), "r"(row), "r"(b)
      : "memory");
}

// One box of a make_map_2d map, its first element at (row, col), into
// `dst`; completes its bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int row, int col) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row)
      : "memory");
}

// Store one box of a make_map_2d map from shared memory; rows past the
// matrix are clipped. The caller fences (fence_async_smem) and syncs the
// writers first.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int row,
                                             int col) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(col), "r"(row)
      : "memory");
}

// Wait until this thread's TMA stores have completed.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Make this thread's shared-memory writes visible to TMA and wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Barrier `id` (1-15) over `threads` threads, e.g. one warpgroup.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Move this warpgroup's registers a thread to N (a multiple of 8, 24 to
// 256), down (a producer that needs few) or up (consumers that take what it
// gave back). Every thread of the warpgroup executes it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// Byte offset of byte `off` of a tile written with D's swizzle.
template <int D>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & ((1u << Swizzle<D>::BITS) - 1u)) << 4);
}

// ---------------------------------------------------------------------------
// Device: wgmma.
// ---------------------------------------------------------------------------

// Descriptor of a tile of 2D-byte rows in shared memory, swizzled as TMA
// wrote it. The same descriptor serves a K-major operand (rows are M or N,
// D contiguous) and an MN-major one (rows are K, with the transpose flag);
// advance it by (byte offset >> 4): 32 bytes a k-slice along D, 16 rows a
// k-slice along rows.
template <int D>
__device__ __forceinline__ uint64_t make_desc(const void* tile) {
  uint64_t desc = (uint64_t)((smem_addr(tile) & 0x3FFFFu) >> 4);
  desc |= (uint64_t)1 << 16;                          // leading offset: unused here
  desc |= (uint64_t)(Swizzle<D>::SBO >> 4) << 32;     // 8-row group stride
  desc |= Swizzle<D>::LAYOUT << 62;
  return desc;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin accumulator registers at this point of the program: the compiler may
// not move their reads or writes across it (wgmma writes them
// asynchronously, between the issue and the wait).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// d (64 x 64, f32) (+)= A (64 x 16, smem) * B (16 x 64, smem); both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 128, f32) (+)= A (64 x 16, smem) * B (16 x 128, smem); both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 16, f32) += A (64 x 16, registers) * B (16 x 16, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64 x 32, f32) += A (64 x 16, registers) * B (16 x 32, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, f32) (+)= A (64 x 16, smem) * B (16 x 32, smem); both
// MN-major (A's tile has K as rows, M contiguous: the transpose of a stored
// tile is read).
__device__ __forceinline__ void wgmma_ss_tt_n32(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 16, f32) (+)= A (64 x 16, smem) * B (16 x 16, smem); both K-major.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 32, f32) (+)= A (64 x 16, smem) * B (16 x 32, smem); both K-major.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 192, f32) (+)= A (64 x 16, smem) * B (16 x 192, smem); both K-major.
__device__ __forceinline__ void wgmma_ss_n192(float (&d)[96], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 192, f32) += A (64 x 16, registers) * B (16 x 192, smem, K-major).
__device__ __forceinline__ void wgmma_rs_k_n192(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x N, f32) (+)= A (64 x 16, smem) * B (16 x N, smem), both K-major.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128 || N == 192, "16 to 192 columns");
  if constexpr (N == 16) wgmma_ss_n16(d, da, db, accumulate);
  else if constexpr (N == 32) wgmma_ss_n32(d, da, db, accumulate);
  else if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else if constexpr (N == 128) wgmma_ss_n128(d, da, db, accumulate);
  else wgmma_ss_n192(d, da, db, accumulate);
}

// d (64 x D) += A (64 x 16, registers) * B (16 x D, smem, MN-major).
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (D == 32) wgmma_rs_n32(d, a, db);
  else wgmma_rs_n64(d, a, db);
}

// Two bf16 values in one register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The register A operand of k-slice kk (columns 16kk..16kk+15) of an
// accumulator, rounded to bf16.
template <int R>
__device__ __forceinline__ void to_a_operand(uint32_t (&a)[4], const float (&c)[R], int kk) {
  a[0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
  a[1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
}

// Row (0..63) of register i of a warpgroup's accumulator, and its column.
__device__ __forceinline__ int acc_row(int warp_in_group, int lane, int i) {
  return 16 * warp_in_group + lane / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int lane, int i) {
  return 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
}

// Write a warpgroup's 64 x D f32 accumulator as bf16 rows of a 64-row tile
// with D's swizzle, this thread's rows r and r + 8 scaled by s0 and s1.
template <int D>
__device__ __forceinline__ void stage_rows(unsigned char* tile, const float (&c)[D / 2],
                                           int warp_in_group, int lane, float s0, float s1) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = acc_row(warp_in_group, lane, i), col = acc_col(lane, i);
    const float s = (i / 2) % 2 ? s1 : s0;
    *reinterpret_cast<uint32_t*>(tile + swz<D>(row * Swizzle<D>::ROW + col * 2)) =
        pack_bf16(c[i] * s, c[i + 1] * s);
  }
}

// ---------------------------------------------------------------------------
// Device: packed crops. Key c is live for query r iff c < N and, when
// boundary > 0 (two crops packed into one sequence), (c < boundary) ==
// (r < boundary).
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool key_live(int r, int c, int N, int boundary) {
  return c < N && (boundary == 0 || ((c < boundary) == (r < boundary)));
}

// Index range [lo, hi) of the other axis that rows [r0, r1) can attend to.
__device__ __forceinline__ void live_range(int r0, int r1, int N, int boundary, int& lo, int& hi) {
  lo = 0;
  hi = N;
  if (boundary > 0) {
    if (r1 <= boundary) hi = boundary;
    else if (r0 >= boundary) lo = boundary;
  }
}

// Does tile [t0, t0 + TILE) against rows [r0, r1) need the per-element
// mask: past N, or on both sides of the crop boundary?
template <int TILE>
__device__ __forceinline__ bool edge_tile(int r0, int r1, int t0, int N, int boundary) {
  if (t0 + TILE > N) return true;
  if (boundary == 0) return false;
  const bool below = r1 <= boundary && t0 + TILE <= boundary;
  const bool above = r0 >= boundary && t0 >= boundary;
  return !(below || above);
}

// ---------------------------------------------------------------------------
// Device: the dK/dV block of K2 (attention.cu) and K6 (attention_long.cu).
// ---------------------------------------------------------------------------

template <int D, int WGS, int STAGES> struct DkvSmem {
  __nv_bfloat16 k[WGS * BOX_ROWS * D];  // each warpgroup's box stages its dK at the end
  __nv_bfloat16 v[WGS * BOX_ROWS * D];  // ... and its dV
  __nv_bfloat16 q[STAGES][BOX_ROWS * D];
  __nv_bfloat16 dout[STAGES][BOX_ROWS * D];
  float lse[STAGES][BOX_ROWS];  // log2 units
  float delta[STAGES][BOX_ROWS];
  uint64_t full[STAGES], empty[STAGES], rows_full;
};

// dV = P^T dO and dK = dS^T Q, dS = P * (dP - delta) * scale, for the
// block's WGS * 64 keys (K and V resident, one 64-key box a consumer
// warpgroup) over the live 64-row query tiles, which one producer warp
// streams by TMA through STAGES mbarrier-tracked stages, copying their lse
// and delta beside them; every warpgroup reads each streamed tile. S^T = K
// Q^T and dP^T = V dO^T are wgmma products from shared memory with keys as
// rows; P^T and dS^T stay in registers as the A operands of the two
// accumulations (dO and Q read MN-major). Padded query rows and, across the
// crop boundary, dead pairs get P = 0; dK and dV leave by TMA stores that
// clip rows past N. No atomics: a block owns its keys' sums. Launch with
// 128 * WGS + 32 threads, grid (ceil(N / (64 WGS)), H, B), and
// sizeof(DkvSmem) + 1024 bytes of dynamic shared memory.
template <int D, int WGS, int STAGES>
__device__ __forceinline__ void dkv_block(const CUtensorMap* q_map, const CUtensorMap* k_map,
                                          const CUtensorMap* v_map, const CUtensorMap* do_map,
                                          const CUtensorMap* dk_map, const CUtensorMap* dv_map,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, int N, int H,
                                          float scale, float scale_log2, int boundary) {
  constexpr float log2e = 1.4426950408889634f;
  constexpr int TILE = BOX_ROWS;                // query rows a streamed tile
  constexpr uint32_t BOX = BOX_ROWS * D * 2;    // bytes of one box
  constexpr int ROW = Swizzle<D>::ROW;
  extern __shared__ unsigned char smem_raw[];
  DkvSmem<D, WGS, STAGES>& sm = aligned_smem<DkvSmem<D, WGS, STAGES>>(smem_raw);
  const int c0 = blockIdx.x * WGS * BOX_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int c1 = min(c0 + WGS * BOX_ROWS, N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long rbase = ((long long)b * H + h) * N;
  int lo, hi;
  live_range(c0, c1, N, boundary, lo, hi);
  const int first = (lo / TILE) * TILE;
  const int ntiles = (hi - first + TILE - 1) / TILE;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 32);  // every producer lane, one with the TMA bytes
      mbar_init(&sm.empty[s], 4 * WGS);  // one arrival per consumer warp
    }
    mbar_init(&sm.rows_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * WGS) {  // producer
    if (lane == 0) {
      mbar_expect_tx(&sm.rows_full, 2 * WGS * BOX);
      for (int g = 0; g < WGS; ++g) {
        tma_load(sm.k + g * BOX_ROWS * D, k_map, &sm.rows_full, h, c0 + g * BOX_ROWS, b);
        tma_load(sm.v + g * BOX_ROWS * D, v_map, &sm.rows_full, h, c0 + g * BOX_ROWS, b);
      }
    }
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % STAGES, r0 = first + t * TILE;
      mbar_wait(&sm.empty[s], ((t / STAGES) & 1) ^ 1);
      for (int i = lane; i < TILE; i += 32) {
        const bool in = r0 + i < N;
        sm.lse[s][i] = in ? lse[rbase + r0 + i] * log2e : 0.f;
        sm.delta[s][i] = in ? delta[rbase + r0 + i] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(&sm.full[s], 2 * BOX);
        tma_load(sm.q[s], q_map, &sm.full[s], h, r0, b);
        tma_load(sm.dout[s], do_map, &sm.full[s], h, r0, b);
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // consumers
  const int wg = warp / 4, wl = warp % 4;
  const int key0 = c0 + wg * BOX_ROWS;
  __nv_bfloat16* k_tile = sm.k + wg * BOX_ROWS * D;
  __nv_bfloat16* v_tile = sm.v + wg * BOX_ROWS * D;
  const uint64_t k_desc = make_desc<D>(k_tile), v_desc = make_desc<D>(v_tile);
  float dk[D / 2], dv[D / 2];
  zero(dk);
  zero(dv);
  mbar_wait(&sm.rows_full, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES, r0 = first + t * TILE;
    mbar_wait(&sm.full[s], (t / STAGES) & 1);
    const uint64_t q_desc = make_desc<D>(sm.q[s]), do_desc = make_desc<D>(sm.dout[s]);
    float st[TILE / 2], dpt[TILE / 2];  // keys x queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(st, k_desc + 2 * kk, q_desc + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(dpt, v_desc + 2 * kk, do_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    const bool edge = edge_tile<TILE>(c0, c1, r0, N, boundary);
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) {
      const int col = acc_col(lane, i), gq = r0 + col;
      float p = exp2f(fmaf(st[i], scale_log2, -sm.lse[s][col]));
      if (edge && !(gq < N && key_live(gq, key0 + acc_row(wl, lane, i), N, boundary))) p = 0.f;
      st[i] = p;                                         // P^T
      dpt[i] = p * (dpt[i] - sm.delta[s][col]) * scale;  // dS^T
    }
    uint32_t pa[TILE / 16][4], dsa[TILE / 16][4];  // P^T, dS^T as A operands
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      to_a_operand(pa[kk], st, kk);
      to_a_operand(dsa[kk], dpt, kk);
    }
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_rs<D>(dv, pa[kk], do_desc + (uint64_t)((kk * 16 * ROW) >> 4));
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_rs<D>(dk, dsa[kk], q_desc + (uint64_t)((kk * 16 * ROW) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  named_sync(1 + wg, 128);  // the warpgroup is done reading its K and V rows
  stage_rows<D>(reinterpret_cast<unsigned char*>(k_tile), dk, wl, lane, 1.f, 1.f);
  stage_rows<D>(reinterpret_cast<unsigned char*>(v_tile), dv, wl, lane, 1.f, 1.f);
  fence_async_smem();
  named_sync(1 + wg, 128);
  if (wl == 0 && lane == 0) {
    tma_store(dk_map, k_tile, h, key0, b);
    tma_store(dv_map, v_tile, h, key0, b);
    tma_store_wait();
  }
}

// Host: the six tensor maps of a dK/dV launch. q, k, v share strides (sb,
// sn, sh); dout, dk, dv are contiguous. The caller has bound its device.
struct DkvMaps {
  CUtensorMap q, k, v, dout, dk, dv;
};

template <int D>
inline CUresult make_dkv_maps(DkvMaps& m, const void* q, const void* k, const void* v,
                              const void* dout, void* dk, void* dv, int B, int N, int H,
                              long long sb, long long sn, long long sh) {
  CUresult res = make_map<D>(&m.q, q, B, N, H, sb, sn, sh);
  if (res == CUDA_SUCCESS) res = make_map<D>(&m.k, k, B, N, H, sb, sn, sh);
  if (res == CUDA_SUCCESS) res = make_map<D>(&m.v, v, B, N, H, sb, sn, sh);
  if (res == CUDA_SUCCESS) res = make_map<D>(&m.dout, dout, B, N, H);
  if (res == CUDA_SUCCESS) res = make_map<D>(&m.dk, dk, B, N, H);
  if (res == CUDA_SUCCESS) res = make_map<D>(&m.dv, dv, B, N, H);
  return res;
}

// ---------------------------------------------------------------------------
// Device: the dQ block of K2 (attention.cu) and K5 (attention_long.cu).
// ---------------------------------------------------------------------------

template <int D, int WGS, int STAGES, int KEYS> struct DqSmem {
  __nv_bfloat16 q[WGS * BOX_ROWS * D];  // each warpgroup's box stages its dQ at the end
  __nv_bfloat16 dout[WGS * BOX_ROWS * D];
  __nv_bfloat16 k[STAGES][KEYS * D];
  __nv_bfloat16 v[STAGES][KEYS * D];
  float delta[WGS * BOX_ROWS];
  uint64_t full[STAGES], empty[STAGES], rows_full;
};

// dQ = dS K with dS = P * (dP - delta) * scale, P = exp(S - lse), dP = dO
// V^T, for the block's WGS * 64 query rows (Q and dO resident, one 64-row
// box a consumer warpgroup) over the live KEYS-key tiles, which one
// producer warp streams by TMA through STAGES mbarrier-tracked stages. First
// computes delta = rowsum(dO * O) for its rows (o contiguous (B, N, H, D))
// and writes it for the dK/dV launch. S and dP are wgmma products from
// shared memory; dS stays in registers as the A operand of dS K (K read
// MN-major). Padded key columns and, across the crop boundary, dead pairs
// get P = 0; dQ leaves by a TMA store that clips rows past N. No atomics: a
// block owns its rows' sums. Launch with 128 * WGS + 32 threads, grid
// (ceil(N / (64 WGS)), H, B), and sizeof(DqSmem) + 1024 bytes of dynamic
// shared memory.
template <int D, int WGS, int STAGES, int KEYS>
__device__ __forceinline__ void dq_block(const CUtensorMap* q_map, const CUtensorMap* k_map,
                                         const CUtensorMap* v_map, const CUtensorMap* do_map,
                                         const CUtensorMap* dq_map,
                                         const __nv_bfloat16* __restrict__ o,
                                         const float* __restrict__ lse,
                                         float* __restrict__ delta, int N, int H, float scale,
                                         float scale_log2, int boundary) {
  static_assert(KEYS == 64 || KEYS == 128, "64 or 128 keys a streamed tile");
  constexpr float log2e = 1.4426950408889634f;
  constexpr uint32_t BOX = BOX_ROWS * D * 2;  // bytes of one box
  constexpr int ROW = Swizzle<D>::ROW;
  constexpr int ROWS = WGS * BOX_ROWS;        // query rows a block owns
  using Smem = DqSmem<D, WGS, STAGES, KEYS>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = aligned_smem<Smem>(smem_raw);
  const int r0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int r1 = min(r0 + ROWS, N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int lo, hi;
  live_range(r0, r1, N, boundary, lo, hi);
  const int first = (lo / KEYS) * KEYS;
  const int ntiles = (hi - first + KEYS - 1) / KEYS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4 * WGS);  // one arrival per consumer warp
    }
    mbar_init(&sm.rows_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * WGS) {  // producer
    if (lane == 0) {
      mbar_expect_tx(&sm.rows_full, 2 * WGS * BOX);
      for (int g = 0; g < WGS; ++g) {
        tma_load(sm.q + g * BOX_ROWS * D, q_map, &sm.rows_full, h, r0 + g * BOX_ROWS, b);
        tma_load(sm.dout + g * BOX_ROWS * D, do_map, &sm.rows_full, h, r0 + g * BOX_ROWS, b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES, c0 = first + t * KEYS;
        mbar_wait(&sm.empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * (KEYS / BOX_ROWS) * BOX);
#pragma unroll
        for (int j = 0; j < KEYS / BOX_ROWS; ++j) {
          tma_load(sm.k[s] + j * BOX_ROWS * D, k_map, &sm.full[s], h, c0 + j * BOX_ROWS, b);
          tma_load(sm.v[s] + j * BOX_ROWS * D, v_map, &sm.full[s], h, c0 + j * BOX_ROWS, b);
        }
      }
    }
    return;
  }

  // consumers
  const int wg = warp / 4, wl = warp % 4;
  const int row0 = r0 + wg * BOX_ROWS;
  __nv_bfloat16* q_tile = sm.q + wg * BOX_ROWS * D;
  const __nv_bfloat16* do_tile = sm.dout + wg * BOX_ROWS * D;
  const long long rbase = ((long long)b * H + h) * N;
  mbar_wait(&sm.rows_full, 0);

  {  // delta for the warpgroup's 64 rows, two threads a row
    const int t = threadIdx.x % 128, row = t / 2, half = t % 2;
    const int grow = row0 + row;
    float acc = 0.f;
    if (grow < N) {
      const __nv_bfloat16* orow = o + (((long long)b * N + grow) * H + h) * D;
#pragma unroll
      for (int c = half * (D / 2); c < (half + 1) * (D / 2); c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(
            reinterpret_cast<const unsigned char*>(do_tile) + swz<D>(row * ROW + c * 2));
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 x = __bfloat1622float2(o2[j]), y = __bfloat1622float2(d2[j]);
          acc += x.x * y.x + x.y * y.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sm.delta[wg * BOX_ROWS + row] = acc;
      if (grow < N) delta[rbase + grow] = acc;
    }
  }
  named_sync(1 + wg, 128);
  float lse2[2], dl[2];  // rows r, r + 8: lse in log2 units, delta
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = acc_row(wl, lane, 2 * rr);
    lse2[rr] = row0 + row < N ? lse[rbase + row0 + row] * log2e : 0.f;
    dl[rr] = sm.delta[wg * BOX_ROWS + row];
  }

  const uint64_t q_desc = make_desc<D>(q_tile), do_desc = make_desc<D>(do_tile);
  float dq[D / 2];
  zero(dq);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&sm.full[s], (t / STAGES) & 1);
    const uint64_t k_desc = make_desc<D>(sm.k[s]), v_desc = make_desc<D>(sm.v[s]);
    float sc[KEYS / 2], dp[KEYS / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<KEYS>(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<KEYS>(dp, do_desc + 2 * kk, v_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    const int c0 = first + t * KEYS;
    const bool edge = edge_tile<KEYS>(r0, r1, c0, N, boundary);
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) {
      const int rr = (i / 2) % 2;
      float p = exp2f(fmaf(sc[i], scale_log2, -lse2[rr]));
      if (edge && !key_live(row0 + acc_row(wl, lane, i), c0 + acc_col(lane, i), N, boundary))
        p = 0.f;
      sc[i] = p * (dp[i] - dl[rr]) * scale;  // dS
    }
    uint32_t dsa[KEYS / 16][4];  // dS, bf16, as the A operand of each 16-key slice
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) to_a_operand(dsa[kk], sc, kk);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk)
      wgmma_rs<D>(dq, dsa[kk], k_desc + (uint64_t)((kk * 16 * ROW) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  named_sync(1 + wg, 128);  // the warpgroup is done reading its Q rows
  stage_rows<D>(reinterpret_cast<unsigned char*>(q_tile), dq, wl, lane, 1.f, 1.f);
  fence_async_smem();
  named_sync(1 + wg, 128);
  if (wl == 0 && lane == 0) {
    tma_store(dq_map, q_tile, h, row0, b);
    tma_store_wait();
  }
}

// Host: the five tensor maps of a dQ launch. q, k, v share strides (sb, sn,
// sh); dout and dq are contiguous. The caller has bound its device.
struct DqMaps {
  CUtensorMap q, k, v, dout, dq;
};

template <int D>
inline CUresult make_dq_maps(DqMaps& m, const void* q, const void* k, const void* v,
                             const void* dout, void* dq, int B, int N, int H, long long sb,
                             long long sn, long long sh) {
  CUresult res = make_map<D>(&m.q, q, B, N, H, sb, sn, sh);
  if (res == CUDA_SUCCESS) res = make_map<D>(&m.k, k, B, N, H, sb, sn, sh);
  if (res == CUDA_SUCCESS) res = make_map<D>(&m.v, v, B, N, H, sb, sn, sh);
  if (res == CUDA_SUCCESS) res = make_map<D>(&m.dout, dout, B, N, H);
  if (res == CUDA_SUCCESS) res = make_map<D>(&m.dq, dq, B, N, H);
  return res;
}

}  // namespace hopper
