// Flash-attention backward for Hopper (sm_90a), kernel B2: dQ, and the
// Delta that B3 (flash_bwd_dkv.cu, dK and dV) reads. Bound to Python with
// ctypes.
//
// Replaces: ray_tpu/ops/flash_attention.py, `_bwd_dq_kernel` (line 87),
// launched by `_bwd` (lines 145-160), and the Delta = rowsum(dO * O) that
// `_bwd` computes outside Pallas (lines 142-143). For q3, o3, dO [BH, T, D],
// k3/v3 [BH, T_k, D], LSE [BH, 1, T] fp32, with the causal mask top-left
// aligned (q_pos >= k_pos, masked scores -1e30):
//   P = exp(scale * Q K^T - LSE), dP = dO V^T, dS = P * (dP - Delta),
//   dQ = scale * dS K                      (and Delta, written for B3).
//
// Design. The Pallas kernel keeps one (b, h)'s whole K/V resident in VMEM;
// at T = 2048 that is over a Hopper block's shared memory, so a block of 4
// warps owns 64 query rows (16 per warp) and loops over 64-key K/V tiles
// up to the causal diagonal, staged through shared memory. S = Q K^T and
// dP = dO V^T are two products with the same operand pattern; the S
// accumulator, turned into dS, is the A fragment of dS K. The block first
// computes Delta for its rows from the dO and O tiles and writes it out.
// bf16: `mma.sync.m16n8k16` (bf16 in, fp32 accumulate); dS is rounded to
// bf16 as the operand of dS K, where the Pallas kernel keeps it in fp32.
// fp32: plain fp32 FMA (no TF32), one warp per query row, lanes split the
// keys for the scores and the head dim for the sums.
//
// Bound on the H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM), at the
// llama3-1b training shape [BH=128, T=2048, D=64] bf16 causal, kept pairs
// BH * T(T+1)/2: three products 6 * D * pairs = 103 GFLOP -> 104 us,
// against Q, K, V, O, dO in and dQ out plus LSE and Delta, 203 MB -> 61 us
// at HBM rate: bound by operations. It recomputes P rather than store it,
// reads K/V from L2 after the first tile of a head, and skips the masked
// half. What it leaves for later: the wgmma/TMA design of B1 and B3.

#include "flash_common.cuh"

namespace {

// ---------------------------------------------------------------- bf16 path

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int t, int t_k,
                         int causal, float scale) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sDO = sQ + kBM * LD;
  __nv_bfloat16* sK = sDO + kBM * LD;
  __nv_bfloat16* sV = sK + kBN * LD;
  float* sLse = reinterpret_cast<float*>(sV + kBN * LD);
  float* sDelta = sLse + kBM;

  const int bh = blockIdx.y, q0 = blockIdx.x * kBM;
  const size_t qoff = (size_t)bh * t * D, koff = (size_t)bh * t_k * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  load_tile<D>(sQ, q + qoff, q0, t);
  load_tile<D>(sDO, dout + qoff, q0, t);
  load_tile<D>(sK, o + qoff, q0, t);  // O, staged in sK for Delta
  __syncthreads();
  {  // Delta = rowsum(dO * O) in fp32, two threads per row
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (D / 2);
    float acc = 0.f;
#pragma unroll 8
    for (int c = c0; c < c0 + D / 2; ++c)
      acc = fmaf(__bfloat162float(sDO[r * LD + c]), __bfloat162float(sK[r * LD + c]), acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((threadIdx.x & 1) == 0) {
      const bool in = q0 + r < t;
      sDelta[r] = acc;
      sLse[r] = in ? lse[(size_t)bh * t + q0 + r] : 0.f;
      if (in) delta[(size_t)bh * t + q0 + r] = acc;
    }
  }
  __syncthreads();
  const int qrow[2] = {q0 + r0, q0 + r0 + 8};
  const float lse_r[2] = {sLse[r0], sLse[r0 + 8]};
  const float delta_r[2] = {sDelta[r0], sDelta[r0 + 8]};

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int k_end = causal ? min(t_k, q0 + kBM) : t_k;
  for (int k0 = 0; k0 < k_end; k0 += kBN) {
    __syncthreads();  // every warp is done with the previous K/V tile (and O)
    load_tile<D>(sK, k + koff, k0, t_k);
    load_tile<D>(sV, v + koff, k0, t_k);
    __syncthreads();

    float s[kBN / 8][4], dp[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      uint32_t qa[4], da[4];
      frag_a<LD>(qa, sQ, r0, c, tq);
      frag_a<LD>(da, sDO, r0, c, tq);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const __nv_bfloat16* kr = sK + (8 * j + g) * LD + 16 * c + 2 * tq;
        const __nv_bfloat16* vr = sV + (8 * j + g) * LD + 16 * c + 2 * tq;
        mma_bf16(s[j], qa, lds32(kr), lds32(kr + 8));
        mma_bf16(dp[j], da, lds32(vr), lds32(vr + 8));
      }
    }
    // dS = P * (dP - Delta), kept in s; masked and out-of-range keys give P = 0
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * tq + (e & 1), h = e >> 1;
        const bool keep = key < t_k && !(causal && key > qrow[h]);
        const float p = keep ? expf(s[j][e] * scale - lse_r[h]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[h]);
      }
    // dQ += dS K: dS's accumulator is the A fragment, K [key, d] the B tile
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c) {
      uint32_t a[4];
      acc_to_a(a, s[2 * c], s[2 * c + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        frag_b_rows<LD>(b0, b1, sK, c, 8 * n + g, tq);
        mma_bf16(acc[n], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qrow[h] >= t) continue;
    __nv_bfloat16* out = dq + qoff + (size_t)qrow[h] * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + 8 * n + 2 * tq) =
          pack_bf16(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

// ---------------------------------------------------------------- fp32 path

constexpr int kRowsF = 8;  // query rows per block, one warp each
constexpr int kTileF = 32; // keys per tile, one per lane

template <int D>
__global__ void __launch_bounds__(kRowsF * 32)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ delta,
                        float* __restrict__ dq, int t, int t_k, int causal,
                        float scale) {
  constexpr int LDT = D + 1;  // odd stride: lanes reading row [lane] hit distinct banks
  __shared__ float sK[kTileF * LDT];
  __shared__ float sV[kTileF * LDT];
  __shared__ float sQ[kRowsF * D];
  __shared__ float sDO[kRowsF * D];

  const int bh = blockIdx.y, q0 = blockIdx.x * kRowsF;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = q0 + warp;
  const float* kb = k + (size_t)bh * t_k * D;
  const float* vb = v + (size_t)bh * t_k * D;
  for (int i = threadIdx.x; i < kRowsF * D; i += blockDim.x) {
    const int r = q0 + i / D;
    const size_t at = ((size_t)bh * t + r) * D + i % D;
    sQ[i] = r < t ? q[at] : 0.f;
    sDO[i] = r < t ? dout[at] : 0.f;
  }
  float dlt = 0.f, lse_r = 0.f;
  if (row < t) {
    for (int c = lane; c < D; c += 32)
      dlt = fmaf(dout[((size_t)bh * t + row) * D + c], o[((size_t)bh * t + row) * D + c], dlt);
    lse_r = lse[(size_t)bh * t + row];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dlt += __shfl_xor_sync(0xffffffffu, dlt, off);
  if (row < t && lane == 0) delta[(size_t)bh * t + row] = dlt;

  float acc[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i] = 0.f;
  const int k_end = causal ? min(t_k, q0 + kRowsF) : t_k;
  for (int k0 = 0; k0 < k_end; k0 += kTileF) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTileF * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < t_k;
      sK[r * LDT + c] = in ? kb[(size_t)(k0 + r) * D + c] : 0.f;
      sV[r * LDT + c] = in ? vb[(size_t)(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
    float s = 0.f, dp = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      s = fmaf(sQ[warp * D + d], sK[lane * LDT + d], s);
      dp = fmaf(sDO[warp * D + d], sV[lane * LDT + d], dp);
    }
    const bool keep = key < t_k && !(causal && key > row);
    const float p = keep ? expf(s * scale - lse_r) : 0.f;
    const float ds = p * (dp - dlt);
    for (int j = 0; j < kTileF; ++j) {
      const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
      for (int i = 0; i < D / 32; ++i) acc[i] = fmaf(dsj, sK[j * LDT + lane + 32 * i], acc[i]);
    }
  }
  if (row < t) {
#pragma unroll
    for (int i = 0; i < D / 32; ++i)
      dq[((size_t)bh * t + row) * D + lane + 32 * i] = acc[i] * scale;
  }
}


template <int D>
constexpr int smem_bf16() {
  return (2 * kBM + 2 * kBN) * (D + kPad) * (int)sizeof(__nv_bfloat16) +
         2 * kBM * (int)sizeof(float);
}

template <int D>
cudaError_t dq_bf16(const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const float* lse, float* delta, void* dq,
                    int bh, int t, int t_k, int causal, float scale, int device,
                    cudaStream_t stream) {
  static bool smem_set[kMaxDevices];
  cudaError_t err = allow_smem(flash_bwd_dq_bf16_kernel<D>, smem_bf16<D>(), device, smem_set);
  if (err != cudaSuccess) return err;
  using T = __nv_bfloat16;
  flash_bwd_dq_bf16_kernel<D><<<dim3((t + kBM - 1) / kBM, bh), kThreads, smem_bf16<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), t, t_k, causal, scale);
  return cudaGetLastError();
}


template <int D>
cudaError_t dq_f32(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq,
                   int bh, int t, int t_k, int causal, float scale,
                   cudaStream_t stream) {
  flash_bwd_dq_f32_kernel<D><<<dim3((t + kRowsF - 1) / kRowsF, bh), kRowsF * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), t,
      t_k, causal, scale);
  return cudaGetLastError();
}


}  // namespace

// B2. q, o, dout, dq: [bh, t, d]; k, v: [bh, t_k, d]; lse, delta: [bh, t]
// fp32 (delta is written); all contiguous. dtype 0 = fp32, 1 = bf16;
// d in {64, 128}. Returns a cudaError_t (0 = ok).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* delta, void* dq, int bh, int t, int t_k, int d,
                            int dtype, int causal, float scale, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);  // the stream belongs to `device`
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 1 && d == 64) return (int)dq_bf16<64>(q, k, v, o, dout, l, dl, dq, bh, t, t_k, causal, scale, device, s);
  if (dtype == 1 && d == 128) return (int)dq_bf16<128>(q, k, v, o, dout, l, dl, dq, bh, t, t_k, causal, scale, device, s);
  if (dtype == 0 && d == 64) return (int)dq_f32<64>(q, k, v, o, dout, l, dl, dq, bh, t, t_k, causal, scale, s);
  if (dtype == 0 && d == 128) return (int)dq_f32<128>(q, k, v, o, dout, l, dl, dq, bh, t, t_k, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
