// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes:
// kernels B2 (dQ) and B3 (dK, dV).
//
// Replaces: ray_tpu/ops/flash_attention.py, `_bwd_dq_kernel` (line 87) and
// `_bwd_dkv_kernel` (line 111), launched by `_bwd` (lines 138-184), and the
// Delta = rowsum(dO * O) that `_bwd` computes outside Pallas (lines 142-143).
// For q3, o3, dO [BH, T, D], k3/v3 [BH, T_k, D], LSE [BH, 1, T] fp32, with
// the causal mask top-left aligned (q_pos >= k_pos, masked scores -1e30):
//   P = exp(scale * Q K^T - LSE), dP = dO V^T, dS = P * (dP - Delta),
//   B2: dQ = scale * dS K                      (and Delta, written for B3)
//   B3: dV = P^T dO, dK = scale * dS^T Q.
// B3 needs Delta, so B2 runs first on the same stream.
//
// Design. The Pallas kernels keep one (b, h)'s whole K/V (B2) or Q/dO (B3)
// resident in VMEM; at T = 2048 that is over a Hopper block's shared memory,
// so both stream 64-row tiles through shared memory, as B1 does.
// B2: a block of 4 warps owns 64 query rows (16 per warp) and loops over the
//   64-key K/V tiles up to the causal diagonal. S = Q K^T and dP = dO V^T
//   are two products with the same operand pattern as B1's Q K^T; the S
//   accumulator, turned into dS, is the A fragment of dS K, as B1 reuses it
//   for P V. The block first computes Delta for its rows from the dO and O
//   tiles and writes it out.
// B3: a block of 4 warps owns 64 keys (16 per warp) and loops over the
//   64-row Q/dO tiles from the first one that reaches its keys. It computes
//   the transposed products S^T = K Q^T and dP^T = V dO^T, so that keys sit
//   on the accumulator rows, LSE and Delta broadcast along its columns, and
//   P^T and dS^T are already the A fragments of P^T dO and dS^T Q: nothing
//   goes through shared memory but the input tiles.
// bf16: `mma.sync.m16n8k16` (bf16 in, fp32 accumulate); P (B3) and dS (both)
// are rounded to bf16 as operands of the second products, where the Pallas
// kernels keep them in fp32. fp32: plain fp32 FMA (no TF32), one warp per
// query row (B2) or key row (B3), lanes split the keys (queries) for the
// scores and the head dim for the sums.
//
// Bound on the H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM), at the
// llama3-1b training shape [BH=128, T=2048, D=64] bf16 causal, kept pairs
// BH * T(T+1)/2: B2's three products 6 * D * pairs = 103 GFLOP -> 104 us,
// B3's four 8 * D * pairs = 137 GFLOP -> 139 us, against six [BH, T, D]
// bf16 arrays each (B2: Q, K, V, O, dO in, dQ out; B3: Q, K, V, dO in, dK,
// dV out) plus LSE and Delta, 203 MB -> 61 us at HBM rate: both are bound
// by operations. They recompute P rather than store it, read K/V (B2) or
// Q/dO (B3) from L2 after the first tile of a head, and skip the masked
// half. What they leave for later: wgmma, TMA, a pipelined tile ring and a
// single fused pass.

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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int t, int t_k,
                          int causal, float scale) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kBN * LD;
  __nv_bfloat16* sQ = sV + kBN * LD;
  __nv_bfloat16* sDO = sQ + kBM * LD;
  float* sLse = reinterpret_cast<float*>(sDO + kBM * LD);
  float* sDelta = sLse + kBM;

  const int bh = blockIdx.y, k0 = blockIdx.x * kBN;
  const size_t qoff = (size_t)bh * t * D, koff = (size_t)bh * t_k * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's key rows: r0 and r0 + 8
  const int key[2] = {k0 + r0, k0 + r0 + 8};

  load_tile<D>(sK, k + koff, k0, t_k);
  load_tile<D>(sV, v + koff, k0, t_k);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // causal: queries below k0 see none of these keys (kBM == kBN, so the
  // first tile that reaches them starts at k0)
  for (int q0 = causal ? k0 : 0; q0 < t; q0 += kBM) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<D>(sQ, q + qoff, q0, t);
    load_tile<D>(sDO, dout + qoff, q0, t);
    if (threadIdx.x < kBM) {
      const int r = q0 + threadIdx.x;
      sLse[threadIdx.x] = r < t ? lse[(size_t)bh * t + r] : 0.f;
      sDelta[threadIdx.x] = r < t ? delta[(size_t)bh * t + r] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: keys on the rows, queries on the columns
    float st[kBM / 8][4], dpt[kBM / 8][4];
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      uint32_t ka[4], va[4];
      frag_a<LD>(ka, sK, r0, c, tq);
      frag_a<LD>(va, sV, r0, c, tq);
#pragma unroll
      for (int j = 0; j < kBM / 8; ++j) {
        const __nv_bfloat16* qr = sQ + (8 * j + g) * LD + 16 * c + 2 * tq;
        const __nv_bfloat16* dr = sDO + (8 * j + g) * LD + 16 * c + 2 * tq;
        mma_bf16(st[j], ka, lds32(qr), lds32(qr + 8));
        mma_bf16(dpt[j], va, lds32(dr), lds32(dr + 8));
      }
    }
    // P^T into st, dS^T = P^T * (dP^T - Delta) into dpt; masked pairs,
    // keys >= T_k and queries >= T give P = 0
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * tq + (e & 1), qpos = q0 + qi, kk = key[e >> 1];
        const bool keep = qpos < t && kk < t_k && !(causal && kk > qpos);
        const float p = keep ? expf(st[j][e] * scale - sLse[qi]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - sDelta[qi]);
      }
    // dV += P^T dO and dK += dS^T Q: dO and Q [query, d] are the B tiles
#pragma unroll
    for (int c = 0; c < kBM / 16; ++c) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, st[2 * c], st[2 * c + 1]);
      acc_to_a(sa, dpt[2 * c], dpt[2 * c + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        frag_b_rows<LD>(b0, b1, sDO, c, 8 * n + g, tq);
        mma_bf16(dv_acc[n], pa, b0, b1);
        frag_b_rows<LD>(b0, b1, sQ, c, 8 * n + g, tq);
        mma_bf16(dk_acc[n], sa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= t_k) continue;
    const size_t row = koff + (size_t)key[h] * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + row + 8 * n + 2 * tq) =
          pack_bf16(dk_acc[n][2 * h] * scale, dk_acc[n][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + row + 8 * n + 2 * tq) =
          pack_bf16(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------- fp32 path

constexpr int kRowsF = 8;  // query (B2) or key (B3) rows per block, one warp each
constexpr int kTileF = 32; // keys (B2) or queries (B3) per tile, one per lane

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
__global__ void __launch_bounds__(kRowsF * 32)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, int t, int t_k, int causal,
                         float scale) {
  constexpr int LDT = D + 1;
  __shared__ float sQ[kTileF * LDT];
  __shared__ float sDO[kTileF * LDT];
  __shared__ float sK[kRowsF * D];
  __shared__ float sV[kRowsF * D];
  __shared__ float sLse[kTileF], sDelta[kTileF];

  const int bh = blockIdx.y, k0 = blockIdx.x * kRowsF;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key = k0 + warp;
  const float* qb = q + (size_t)bh * t * D;
  const float* db = dout + (size_t)bh * t * D;
  for (int i = threadIdx.x; i < kRowsF * D; i += blockDim.x) {
    const int r = k0 + i / D;
    const size_t at = ((size_t)bh * t_k + r) * D + i % D;
    sK[i] = r < t_k ? k[at] : 0.f;
    sV[i] = r < t_k ? v[at] : 0.f;
  }

  float dk_acc[D / 32], dv_acc[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  for (int q0 = causal ? k0 : 0; q0 < t; q0 += kTileF) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTileF * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = q0 + r < t;
      sQ[r * LDT + c] = in ? qb[(size_t)(q0 + r) * D + c] : 0.f;
      sDO[r * LDT + c] = in ? db[(size_t)(q0 + r) * D + c] : 0.f;
    }
    if (threadIdx.x < kTileF) {
      const int r = q0 + threadIdx.x;
      sLse[threadIdx.x] = r < t ? lse[(size_t)bh * t + r] : 0.f;
      sDelta[threadIdx.x] = r < t ? delta[(size_t)bh * t + r] : 0.f;
    }
    __syncthreads();

    const int qpos = q0 + lane;
    float s = 0.f, dp = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      s = fmaf(sK[warp * D + d], sQ[lane * LDT + d], s);
      dp = fmaf(sV[warp * D + d], sDO[lane * LDT + d], dp);
    }
    const bool keep = qpos < t && key < t_k && !(causal && key > qpos);
    const float p = keep ? expf(s * scale - sLse[lane]) : 0.f;
    const float ds = p * (dp - sDelta[lane]);
    for (int j = 0; j < kTileF; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        dv_acc[i] = fmaf(pj, sDO[j * LDT + lane + 32 * i], dv_acc[i]);
        dk_acc[i] = fmaf(dsj, sQ[j * LDT + lane + 32 * i], dk_acc[i]);
      }
    }
  }
  if (key < t_k) {
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      dk[((size_t)bh * t_k + key) * D + lane + 32 * i] = dk_acc[i] * scale;
      dv[((size_t)bh * t_k + key) * D + lane + 32 * i] = dv_acc[i];
    }
  }
}

// (Q, dO, K, V tiles) + LSE and Delta of 64 rows
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
cudaError_t dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dk, void* dv,
                     int bh, int t, int t_k, int causal, float scale, int device,
                     cudaStream_t stream) {
  static bool smem_set[kMaxDevices];
  cudaError_t err = allow_smem(flash_bwd_dkv_bf16_kernel<D>, smem_bf16<D>(), device, smem_set);
  if (err != cudaSuccess) return err;
  using T = __nv_bfloat16;
  flash_bwd_dkv_bf16_kernel<D><<<dim3((t_k + kBN - 1) / kBN, bh), kThreads, smem_bf16<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), t, t_k, causal, scale);
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

template <int D>
cudaError_t dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv,
                    int bh, int t, int t_k, int causal, float scale,
                    cudaStream_t stream) {
  flash_bwd_dkv_f32_kernel<D><<<dim3((t_k + kRowsF - 1) / kRowsF, bh), kRowsF * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), t, t_k, causal, scale);
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

// B3. q, dout: [bh, t, d]; k, v, dk, dv: [bh, t_k, d]; lse, delta: [bh, t]
// fp32, delta as B2 wrote it; all contiguous. Same codes as flash_bwd_dq.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             void* dk, void* dv, int bh, int t, int t_k, int d,
                             int dtype, int causal, float scale, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 1 && d == 64) return (int)dkv_bf16<64>(q, k, v, dout, l, dl, dk, dv, bh, t, t_k, causal, scale, device, s);
  if (dtype == 1 && d == 128) return (int)dkv_bf16<128>(q, k, v, dout, l, dl, dk, dv, bh, t, t_k, causal, scale, device, s);
  if (dtype == 0 && d == 64) return (int)dkv_f32<64>(q, k, v, dout, l, dl, dk, dv, bh, t, t_k, causal, scale, s);
  if (dtype == 0 && d == 128) return (int)dkv_f32<128>(q, k, v, dout, l, dl, dk, dv, bh, t, t_k, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
