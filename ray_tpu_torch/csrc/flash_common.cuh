// Pieces shared by the flash-attention kernels: the masked score, bf16
// packing and the dynamic shared-memory limit. The sm_90a building blocks
// (TMA, mbarriers, wgmma) are in sm90_common.cuh.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' masked score
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo, low 16 bits
  return *reinterpret_cast<uint32_t*>(&h);
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
