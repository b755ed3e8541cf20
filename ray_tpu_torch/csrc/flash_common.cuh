// Pieces shared by the flash-attention kernels: the masked score, bf16
// packing and the dynamic shared-memory limit (all of them), and for B2's
// bf16 kernel (flash_bwd.cu) its tile shape, the tensor-core product
// `mma.sync.m16n8k16` and its fragment loads from shared memory. The
// sm_90a kernels B1 and B3 take their products from sm90_common.cuh.
//
// Fragment layout of m16n8k16 (g = lane / 4, tq = lane % 4):
//   A 16x16 row-major: a[0] = row g, cols 2tq..2tq+1; a[1] = row g+8, same
//     cols; a[2] = row g, cols 8+2tq..; a[3] = row g+8, cols 8+2tq..
//   B 16x8 "col": b0 = rows 2tq..2tq+1 of col g; b1 = rows 8+2tq..8+2tq+1
//   C 16x8: c[0..1] = row g, cols 2tq..2tq+1; c[2..3] = row g+8, same cols.
// A row-major [n, k] matrix in shared memory is therefore B's fragment of
// its transpose (two neighbouring k of one row are one 32-bit load), while a
// row-major [k, n] matrix needs two 16-bit loads of neighbouring rows.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' masked score
constexpr int kMaxDevices = 64;

constexpr int kBM = 64;    // query rows per tile (16 per warp)
constexpr int kBN = 64;    // keys per tile
constexpr int kPad = 8;    // bf16 elements of row padding: conflict-free fragments
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo, low 16 bits
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + 64) of a [rows, D] bf16 matrix into shared memory with
// row stride D + kPad; rows at or past `rows` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int rows) {
  constexpr int kVec = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < kBM * kVec; i += kThreads) {
    int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) = val;
  }
}

// A fragment of rows [r, r + 16) x cols [16c, 16c + 16) of a row-major tile
// in shared memory with row stride LD; `r` is the warp's first row plus g.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* s,
                                       int r, int c, int tq) {
  a[0] = lds32(s + r * LD + 16 * c + 2 * tq);
  a[1] = lds32(s + (r + 8) * LD + 16 * c + 2 * tq);
  a[2] = lds32(s + r * LD + 16 * c + 8 + 2 * tq);
  a[3] = lds32(s + (r + 8) * LD + 16 * c + 8 + 2 * tq);
}

// The accumulators of n-tiles 2c and 2c + 1 (16 columns) as the A fragment
// of the next product, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// B fragment of rows [16c, 16c + 16) x col `col` of a row-major [k, n] tile
// in shared memory with row stride LD (two 16-bit loads per register).
template <int LD>
__device__ __forceinline__ void frag_b_rows(uint32_t& b0, uint32_t& b1,
                                            const __nv_bfloat16* s, int c, int col,
                                            int tq) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(s);
  const int kr = 16 * c + 2 * tq;
  b0 = (uint32_t)u[kr * LD + col] | ((uint32_t)u[(kr + 1) * LD + col] << 16);
  b1 = (uint32_t)u[(kr + 8) * LD + col] | ((uint32_t)u[(kr + 9) * LD + col] << 16);
}

// Dynamic shared memory above 48 KB needs the kernel's attribute raised,
// once per device (setting it twice is harmless, so racing threads need no
// lock).
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int smem, int device,
                       bool (&done)[kMaxDevices]) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    done[device] = true;
  }
  return cudaSuccess;
}

}  // namespace
