// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: ray_tpu/ops/flash_attention.py, `_fwd_kernel` (line 35) and its
// launcher `_fwd` (line 58), the Pallas TPU kernel. It computes what that
// kernel computes, for q3 [BH, T, D] and k3/v3 [BH, T_k, D]:
//   S = scale * Q K^T, causal mask top-left aligned (q_pos >= k_pos, masked
//   scores = -1e30), m = rowmax S, P = exp(S - m), l = sum P,
//   O = P V / l (written in the input dtype), LSE = m + log l (fp32, [BH, 1, T]).
//
// Design. The Pallas kernel keeps one (b, h)'s whole K/V resident in VMEM.
// That does not fit a Hopper block's 227 KB of shared memory at T = 2048, so
// here one block of 4 warps owns a 64-row query tile and loops over 64-key
// K/V tiles staged in shared memory, carrying an online softmax (running
// row max m, row sum l and the O accumulator, all fp32 in registers). The
// result equals the one-pass softmax of the Pallas kernel up to rounding.
// Key tiles entirely above the causal diagonal are skipped; the tile that
// straddles it, and the ragged tails of T and T_k, are masked per element.
//
// bf16 inputs: each warp owns 16 query rows; S = Q K^T and O += P V are
// `mma.sync.m16n8k16` (bf16 in, fp32 accumulate), with P rounded to bf16
// for the second product where the Pallas kernel keeps it in fp32: O moves
// by about one bf16 ulp at most. fp32 inputs: plain fp32 FMA (no TF32
// anywhere), one warp per query row, lanes split the keys for S and the
// head dim for O.
//
// Bound on the H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM), at the
// llama3-1b forward's shape [BH=128, T=2048, D=64] bf16 causal:
// 4 * D * BH * T(T+1)/2 = 68.7 GFLOP -> 69.5 us at the tensor-core peak,
// against 4 * 128*2048*64*2 B + 1 MB of LSE = 135 MB -> 40 us at HBM rate.
// So it is bound by operations: the kernel reads each Q tile once and each
// K/V tile once per query tile (from L2 after the first query tile of a
// head), keeps S and P out of device memory, and skips the masked half.
// What it leaves for later: wgmma, TMA loads and a pipelined K/V ring with
// warp specialisation; mma.sync alone cannot reach the card's peak.

#include "flash_common.cuh"

namespace {

// ---------------------------------------------------------------- bf16 path

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int t, int t_k, int causal, float scale) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBM * LD;
  __nv_bfloat16* sV = sK + kBN * LD;

  const int bh = blockIdx.y, q0 = blockIdx.x * kBM;
  const __nv_bfloat16* qb = q + (size_t)bh * t * D;
  const __nv_bfloat16* kb = k + (size_t)bh * t_k * D;
  const __nv_bfloat16* vb = v + (size_t)bh * t_k * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment row group / column pair
  const int r0 = warp * 16 + g;            // this thread's rows: r0 and r0 + 8

  load_tile<D>(sQ, qb, q0, t);
  __syncthreads();
  uint32_t qf[D / 16][4];  // A fragments of this warp's 16 query rows
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    qf[c][0] = lds32(sQ + r0 * LD + 16 * c + 2 * tq);
    qf[c][1] = lds32(sQ + (r0 + 8) * LD + 16 * c + 2 * tq);
    qf[c][2] = lds32(sQ + r0 * LD + 16 * c + 8 + 2 * tq);
    qf[c][3] = lds32(sQ + (r0 + 8) * LD + 16 * c + 8 + 2 * tq);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const int qrow[2] = {q0 + r0, q0 + r0 + 8};

  const int k_end = causal ? min(t_k, q0 + kBM) : t_k;
  for (int k0 = 0; k0 < k_end; k0 += kBN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, kb, k0, t_k);
    load_tile<D>(sV, vb, k0, t_k);
    __syncthreads();

    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const __nv_bfloat16* kr = sK + (8 * j + g) * LD + 16 * c + 2 * tq;
        mma_bf16(s[j], qf[c], lds32(kr), lds32(kr + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int key = k0 + 8 * j + 2 * tq + (e & 1);
        float x = s[j][e] * scale;
        if (key >= t_k || (causal && key > qrow[e >> 1])) x = kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_run[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l_run[h] = l_run[h] * alpha[h] + rs[h];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V: the S accumulator of key columns [16c, 16c + 16) is the A
    // fragment of P; V's B fragment pairs two key rows of one head column.
    const unsigned short* sVu = reinterpret_cast<const unsigned short*>(sV);
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c) {
      uint32_t pa[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                        pack_bf16(s[2 * c][2], s[2 * c][3]),
                        pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                        pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
      const int kr = 16 * c + 2 * tq;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = 8 * n + g;
        uint32_t b0 = (uint32_t)sVu[kr * LD + col] |
                      ((uint32_t)sVu[(kr + 1) * LD + col] << 16);
        uint32_t b1 = (uint32_t)sVu[(kr + 8) * LD + col] |
                      ((uint32_t)sVu[(kr + 9) * LD + col] << 16);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qrow[h];
    if (row >= t) continue;
    const float inv = 1.f / l_run[h];
    __nv_bfloat16* orow = o + ((size_t)bh * t + row) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * tq) =
          pack_bf16(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    if (tq == 0) lse[(size_t)bh * t + row] = m_run[h] + logf(l_run[h]);
  }
}

// ---------------------------------------------------------------- fp32 path

constexpr int kRowsF = 8;   // query rows per block, one warp each
constexpr int kBNF = 32;    // keys per tile, one per lane for S

template <int D>
__global__ void __launch_bounds__(kRowsF * 32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int t, int t_k, int causal,
                     float scale) {
  constexpr int LDK = D + 1;  // odd stride: lanes reading K[lane][d] hit distinct banks
  __shared__ float sK[kBNF * LDK];
  __shared__ float sV[kBNF * D];
  __shared__ float sQ[kRowsF * D];

  const int bh = blockIdx.y, q0 = blockIdx.x * kRowsF;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = q0 + warp;
  const float* kb = k + (size_t)bh * t_k * D;
  const float* vb = v + (size_t)bh * t_k * D;
  for (int i = threadIdx.x; i < kRowsF * D; i += blockDim.x) {
    int r = q0 + i / D;
    sQ[i] = r < t ? q[((size_t)bh * t + r) * D + i % D] : 0.f;
  }

  float acc[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;
  const int k_end = causal ? min(t_k, q0 + kRowsF) : t_k;
  for (int k0 = 0; k0 < k_end; k0 += kBNF) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBNF * D; i += blockDim.x) {
      int r = i / D, c = i % D;
      bool in = k0 + r < t_k;
      sK[r * LDK + c] = in ? kb[(size_t)(k0 + r) * D + c] : 0.f;
      sV[i] = in ? vb[(size_t)(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
    float sc = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) sc = fmaf(sQ[warp * D + d], sK[lane * LDK + d], sc);
    sc *= scale;
    if (key >= t_k || (causal && key > row)) sc = kNegInf;
    float mx = sc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    m_run = m_new;
    const float p = expf(sc - m_new);
    float ps = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    l_run = l_run * alpha + ps;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) acc[i] *= alpha;
    for (int j = 0; j < kBNF; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < D / 32; ++i) acc[i] = fmaf(pj, sV[j * D + lane + 32 * i], acc[i]);
    }
  }
  if (row < t) {
    const float inv = 1.f / l_run;
#pragma unroll
    for (int i = 0; i < D / 32; ++i)
      o[((size_t)bh * t + row) * D + lane + 32 * i] = acc[i] * inv;
    if (lane == 0) lse[(size_t)bh * t + row] = m_run + logf(l_run);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int bh, int t, int t_k, int causal,
                        float scale, int device, cudaStream_t stream) {
  // D = 128 needs more than the default 48 KB of dynamic shared memory
  const int smem = (kBM + 2 * kBN) * (D + kPad) * (int)sizeof(__nv_bfloat16);
  static bool smem_set[kMaxDevices];
  cudaError_t err = allow_smem(flash_fwd_bf16_kernel<D>, smem, device, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((t + kBM - 1) / kBM, bh);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      t, t_k, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int t, int t_k, int causal,
                       float scale, cudaStream_t stream) {
  dim3 grid((t + kRowsF - 1) / kRowsF, bh);
  flash_fwd_f32_kernel<D><<<grid, kRowsF * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, t, t_k,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o: [bh, t, d]; k, v: [bh, t_k, d]; lse: [bh, t] fp32; all contiguous.
// dtype 0 = fp32, 1 = bf16; d in {64, 128}. Returns a cudaError_t (0 = ok).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int t, int t_k, int d, int dtype,
                         int causal, float scale, int device, void* stream) {
  // the stream belongs to `device`; the calling thread may have another
  // current device (a no-op when it is the same)
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 1 && d == 64) return (int)launch_bf16<64>(q, k, v, o, l, bh, t, t_k, causal, scale, device, s);
  if (dtype == 1 && d == 128) return (int)launch_bf16<128>(q, k, v, o, l, bh, t, t_k, causal, scale, device, s);
  if (dtype == 0 && d == 64) return (int)launch_f32<64>(q, k, v, o, l, bh, t, t_k, causal, scale, s);
  if (dtype == 0 && d == 128) return (int)launch_f32<128>(q, k, v, o, l, bh, t, t_k, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
