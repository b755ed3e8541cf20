// Hopper (sm_90a) building blocks of the flash kernels (B1 in flash_fwd.cu,
// B2 in flash_bwd.cu, B3 in flash_bwd_dkv.cu), as inline PTX:
//   - mbarriers: init, arrive, arrive.expect_tx and try_wait.parity;
//   - TMA: a 3-D tiled load global -> shared that completes on an mbarrier,
//     and the host-side encoding of its tensor map;
//   - wgmma: m64nNk16 bf16 -> fp32 with A and B from shared memory (both
//     K-major) or A from registers and B from shared memory MN-major, the
//     shared-memory matrix descriptor, fence / commit_group / wait_group;
//   - setmaxnreg, to move registers from the producer warpgroup to the
//     consumer warpgroups (ptxas 12.9 still compiles the consumers within
//     the launch bound's cap, 168 registers at 12 warps);
//   - named barriers, a warp-uniform warpgroup index and 2^x on the
//     special-function unit.
//
// Tiles in shared memory. Every bf16 tile is [rows][64] per 64-column
// block (128 bytes a row), written by TMA with the 128-byte swizzle and
// read by wgmma through a descriptor with the same swizzle; a D = 128 tile
// is two such column blocks one after the other. Each block starts on a
// 1024-byte boundary (the swizzle repeats every 8 rows x 128 bytes).
//   K-major operand (the reduction dimension is the row, e.g. Q or K of
//   Q K^T): SBO = 1024 bytes (8 rows), LBO unused; a k16 step inside a
//   column block advances the start address by 32 bytes.
//   MN-major operand (the reduction dimension runs down the rows, e.g. V of
//   P V, [key][d]): SBO = 1024 bytes (8 reduction rows), LBO = the stride
//   between the 64-column blocks; a k16 step advances 16 rows, 2048 bytes.
// The wgmma accumulator of m64nN holds, in thread (warp w, lane = 4g + tq)
// of the warpgroup, d[4j + e] = row 16w + g + 8(e >> 1), column
// 8j + 2tq + (e & 1) — the layout of mma.sync's m16n8 C per 8 columns — and
// an A fragment from registers is mma.sync's m16n8k16 A per warp, so the
// accumulator of one product packs pairwise into the A operand of the
// next (acc_to_a_frags).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"  // pack_bf16

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA) and to
// the other threads; then a __syncthreads
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival, and `bytes` more expected from TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A wait that
// lasts over 2^32 cycles (seconds) traps: a fault in the barrier protocol
// ends the kernel with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  if (done) return;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (clock64() - start > (1ll << 32)) __trap();
  } while (!done);
}

// ------------------------------------------------------------ TMA

// box at coordinates (c0, c1, c2) (innermost first) of the tensor map
// into shared memory at `dst`, completing `bytes` on the mbarrier `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ------------------------------------------------------------ warps

// The warpgroup index, read through a shuffle so that the compiler sees it
// uniform across the warp (the branch on it holds setmaxnreg).
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
}

// Named barriers (0 is __syncthreads'): `n` threads in all, the caller's
// warps among them; sync waits, arrive does not.
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (denormal results flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------ registers

template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ------------------------------------------------------------ wgmma

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major tile: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

// MN-major tile whose 64-column blocks lie `block_bytes` apart
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, uint32_t block_bytes) {
  return desc_sw128(addr, block_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// After a wait: the compiler must not move reads of these registers above
// it (the asm that wrote them is what it sees, not the wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (+)= A B, m64nNk16, A and B K-major in shared memory; scale_d = 0
// ignores D's old value.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D += A B, m64nNk16, A (4 registers, bf16 pairs) from registers, B
// MN-major in shared memory (the transpose flag).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D (+)= A B over one k16 step, N = 32, 64 or 128: A and B K-major in
// shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N in {32, 64, 128}");
  if constexpr (N == 32) wgmma_ss_n32(d, desc_a, desc_b, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64(d, desc_a, desc_b, scale_d);
  else wgmma_ss_n128(d, desc_a, desc_b, scale_d);
}

// An m64nN accumulator as the A operands (bf16) of the next product, one
// per k16 step over its N columns: step c takes its n8 blocks 2c and
// 2c + 1, rows g and g + 8 of each in turn.
template <int N>
__device__ __forceinline__ void acc_to_a_frags(uint32_t (&a)[N / 8][4],
                                               const float (&acc)[N]) {
#pragma unroll
  for (int c = 0; c < N / 8; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[c][j] = pack_bf16(acc[8 * c + 2 * j], acc[8 * c + 2 * j + 1]);
}

// D += A B over one k16 step, N = the head dim: A from registers, B
// MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  if constexpr (N == 64) wgmma_rs_n64_tb(d, a, desc_b, 1);
  else wgmma_rs_n128_tb(d, a, desc_b, 1);
}

// ------------------------------------------------------------ host side

// cuTensorMapEncodeTiled is a driver-API function; it is reached through
// the runtime's entry-point query, so the library links no libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;  // racing first calls store the same value
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                       12000, cudaEnableDefault, &q);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a contiguous bf16 [bh, rows, d] array, boxes of 64
// columns x box_rows rows of one (b, h), 128-byte swizzle. The map is 3-D
// so that a box past the last row of a head is zero-filled instead of
// reading the next head's rows.
inline cudaError_t encode_rows_map(CUtensorMap* map, const void* base, int bh,
                                   int rows, int d, int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                  dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
