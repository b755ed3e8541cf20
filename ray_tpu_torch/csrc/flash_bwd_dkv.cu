// Flash-attention backward for Hopper (sm_90a), kernel B3: dK and dV. Bound
// to Python with ctypes. B2 (dQ and Delta) is in flash_bwd.cu and runs
// first on the same stream: B3 reads its Delta.
//
// Replaces: ray_tpu/ops/flash_attention.py, `_bwd_dkv_kernel` (line 111),
// launched by `_bwd` (lines 162-183). For q3, dO [BH, T, D], k3/v3
// [BH, T_k, D], LSE and Delta [BH, 1, T] fp32, with the causal mask top-left
// aligned (q_pos >= k_pos, masked scores -1e30):
//   P = exp(scale * Q K^T - LSE), dP = dO V^T, dS = P * (dP - Delta),
//   dV = P^T dO, dK = scale * dS^T Q.
//
// Bound on the H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM), at the
// llama3-1b training shape [BH=128, T=2048, D=64] bf16 causal: four
// products (K Q^T, V dO^T, P^T dO, dS^T Q), 8 * D * BH * T(T+1)/2 = 137
// GFLOP -> 139 us, against Q, K, V, dO in and dK, dV out plus LSE and
// Delta, 203 MB -> 61 us at HBM rate: bound by operations.
//
// bf16 design (sm90 building blocks in sm90_common.cuh). The Pallas kernel
// keeps one (b, h)'s whole Q/dO in VMEM; here a block owns 128 keys and
// streams 64-query tiles of Q and dO. Its 384 threads are three warpgroups:
//   - a producer warpgroup (24 registers by setmaxnreg): one thread loads
//     the block's K and V once, then keeps Q/dO tiles in flight by TMA
//     through a ring of stages, each with a "full" and an "empty" mbarrier;
//     the warp's 32 lanes copy each tile's LSE (times log2 e) and Delta
//     rows into the stage and arrive on its "full" barrier;
//   - two consumer warpgroups (240 registers), each owning 64 keys, with
//     dK and dV accumulated in registers (fp32). Per query tile: S^T = K Q^T
//     and dP^T = V dO^T are wgmma with K, V and the Q, dO tiles all K-major
//     in shared memory, so keys sit on the accumulator rows and LSE and
//     Delta broadcast along its columns; P^T and dS^T = P^T * (dP^T - Delta)
//     are formed in registers and rounded to bf16 (where the Pallas kernel
//     keeps them in fp32) as the A fragments of dV += P^T dO and
//     dK += dS^T Q, wgmma with dO and Q MN-major (the transpose flag) from
//     the same tiles.
// Under the causal mask the first query tile is the first that reaches the
// block's keys, a warpgroup skips a tile that reaches none of its own, and
// tiles on the diagonal and the ragged tails of T and T_k are masked per
// element (TMA zero-fills rows past the end of a head).
//
// fp32 inputs: plain fp32 FMA (no TF32), one warp per key row, lanes split
// the queries for the scores and the head dim for the sums.

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

// ---------------------------------------------------------------- bf16 path


// Tiles of the bf16 kernel. Consumer warpgroups 0 .. kConsumers - 1 own
// 64 keys each; the producer warpgroup is the last. ptxas compiles the
// whole kernel within the launch bound's register cap (168 a thread at 12
// warps: 3 warps share each quarter of the register file) and does not
// raise it after setmaxnreg.inc. At D = 128, dK and dV alone take 128
// registers a thread, so a block there has one consumer warpgroup (8
// warps, a cap of 255) and 32-query tiles (S^T and dP^T 16 registers each).
// Shared memory, offsets from a 1024-byte aligned base: K and V (two
// column blocks each at D = 128), then per stage Q and dO, then per stage
// the LSE and Delta rows, then the mbarriers (K/V full, full[stages],
// empty[stages]).
template <int D>
struct DkvLayout {
  static constexpr int kConsumers = D == 64 ? 2 : 1;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kBN = 64 * kConsumers;  // keys per block
  static constexpr int kBM = D == 64 ? 64 : 32;  // queries per Q/dO tile
  static constexpr int kStages = 3;
  static constexpr int kKVBytes = kBN * D * 2;  // K or V
  static constexpr int kTileBytes = kBM * D * 2;  // one Q or dO tile
  static constexpr int kK = 0;
  static constexpr int kV = kKVBytes;
  static constexpr int kQ0 = 2 * kKVBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kRows = kQ0 + kStages * kStageBytes;  // [stages][2][kBM] fp32
  static constexpr int kBars = kRows + kStages * 2 * kBM * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(DkvLayout<D>::kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int t, int t_k,
                          int causal, float scale) {
  using L = DkvLayout<D>;
  constexpr int S = L::kStages, BM = L::kBM, BN = L::kBN, NC = L::kConsumers;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // the same base, generic
  const uint32_t bar_kv = base + L::kBars;
  auto full = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8 * (1 + S + s); };
  auto q_tile = [&](int s) { return base + L::kQ0 + s * L::kStageBytes; };
  auto do_tile = [&](int s) { return q_tile(s) + L::kTileBytes; };
  // LSE * log2 e, then Delta, of the tile's BM query rows
  auto rows = [&](int s) {
    return reinterpret_cast<float*>(gbase + L::kRows) + s * 2 * BM;
  };

  const int bh = blockIdx.y, kc = blockIdx.x * BN;
  // under the causal mask, queries below kc see none of these keys
  const int q_first = causal ? kc : 0;
  const int n_tiles = max(0, (t - q_first + BM - 1) / BM);
  const int wg = warpgroup_index();

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 32);  // every lane of the producer warp
      mbar_init(empty(s), 4 * NC);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == NC) {
    // ------------------------------------------------------------ producer
    if constexpr (NC == 2) regs_dealloc<24>();
    if (threadIdx.x < NC * 128 + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_kv, 2 * L::kKVBytes);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(base + L::kK + c * BN * 128, &tm_k, bar_kv, 64 * c, kc, bh);
          tma_load_3d(base + L::kV + c * BN * 128, &tm_v, bar_kv, 64 * c, kc, bh);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S, q0 = q_first + it * BM;
        mbar_wait(empty(s), ((it / S) & 1) ^ 1);  // the first round passes at once
        float* r = rows(s);
#pragma unroll
        for (int i = lane; i < BM; i += 32) {
          const bool in = q0 + i < t;
          r[i] = in ? lse[(size_t)bh * t + q0 + i] * kLog2e : 0.f;
          r[BM + i] = in ? delta[(size_t)bh * t + q0 + i] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full(s), L::kStageBytes);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_3d(q_tile(s) + c * BM * 128, &tm_q, full(s), 64 * c, q0, bh);
            tma_load_3d(do_tile(s) + c * BM * 128, &tm_do, full(s), 64 * c, q0, bh);
          }
        } else {
          mbar_arrive(full(s));
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    if constexpr (NC == 2) regs_alloc<240>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, tq = lane & 3;
    const int kw = kc + 64 * wg;           // this warpgroup's first key
    const int key0 = kw + 16 * warp + g;   // this thread's keys: key0 and key0 + 8
    const float sl2 = scale * kLog2e;
    // this warpgroup's 64 rows of K and V, in each column block
    const uint32_t k_rows = base + L::kK + wg * 64 * 128;
    const uint32_t v_rows = base + L::kV + wg * 64 * 128;

    float dk_acc[D / 2], dv_acc[D / 2];  // m64nD accumulators
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(bar_kv, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % S, q0 = q_first + it * BM;
      mbar_wait(full(s), (it / S) & 1);
      // under the causal mask, a tile whose last query is before this
      // warpgroup's first key gives P = 0 here
      const bool skip = causal && kw > q0 + BM - 1;
      if (!skip) {
        // S^T = K Q^T and dP^T = V dO^T over D in k16 steps
        float st[BM / 2], dpt[BM / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss<BM>(st, desc_k_major(k_rows + (kk / 4) * BN * 128 + off),
                       desc_k_major(q_tile(s) + (kk / 4) * BM * 128 + off), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss<BM>(dpt, desc_k_major(v_rows + (kk / 4) * BN * 128 + off),
                       desc_k_major(do_tile(s) + (kk / 4) * BM * 128 + off), kk > 0);
        }
        wgmma_commit();

        // P^T = exp(S^T scale - LSE) while dP^T is still running; masked
        // pairs, keys >= T_k and queries >= T give P = 0
        const float* r = rows(s);
        const bool masked = q0 + BM > t || kw + 64 > t_k ||
                            (causal && kw + 63 > q0);
        wgmma_wait<1>();
        fence_regs(st);
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) {
          const int qi = 8 * (i / 4) + 2 * tq + (i & 1);
          float p = fast_exp2(fmaf(st[i], sl2, -r[qi]));
          if (masked) {
            const int qpos = q0 + qi, kk = key0 + 8 * ((i >> 1) & 1);
            if (qpos >= t || kk >= t_k || (causal && kk > qpos)) p = 0.f;
          }
          st[i] = p;
        }
        wgmma_wait<0>();
        fence_regs(dpt);
        // dS^T = P^T * (dP^T - Delta), in place
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) {
          const int qi = 8 * (i / 4) + 2 * tq + (i & 1);
          dpt[i] = st[i] * (dpt[i] - r[BM + qi]);
        }
        // the A operands of queries [16c, 16c + 16)
        uint32_t pa[BM / 16][4], da[BM / 16][4];
        acc_to_a_frags(pa, st);
        acc_to_a_frags(da, dpt);
        // dV += P^T dO and dK += dS^T Q, dO and Q MN-major
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < BM / 16; ++c)
          wgmma_rs_tb<D>(dv_acc, pa[c],
                         desc_mn_major(do_tile(s) + c * 16 * 128, BM * 128));
#pragma unroll
        for (int c = 0; c < BM / 16; ++c)
          wgmma_rs_tb<D>(dk_acc, da[c],
                         desc_mn_major(q_tile(s) + c * 16 * 128, BM * 128));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + 8 * h;
      if (key >= t_k) continue;
      const size_t row = ((size_t)bh * t_k + key) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dk + row + 8 * n + 2 * tq) =
            pack_bf16(dk_acc[4 * n + 2 * h] * scale, dk_acc[4 * n + 2 * h + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + row + 8 * n + 2 * tq) =
            pack_bf16(dv_acc[4 * n + 2 * h], dv_acc[4 * n + 2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- fp32 path

constexpr int kRowsF = 8;  // key rows per block, one warp each
constexpr int kTileF = 32; // queries per tile, one per lane

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
cudaError_t dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dk, void* dv,
                     int bh, int t, int t_k, int causal, float scale, int device,
                     cudaStream_t stream) {
  using L = DkvLayout<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = encode_rows_map(&tm_q, q, bh, t, D, L::kBM);
  if (err == cudaSuccess) err = encode_rows_map(&tm_do, dout, bh, t, D, L::kBM);
  if (err == cudaSuccess) err = encode_rows_map(&tm_k, k, bh, t_k, D, L::kBN);
  if (err == cudaSuccess) err = encode_rows_map(&tm_v, v, bh, t_k, D, L::kBN);
  if (err != cudaSuccess) return err;
  static bool smem_set[kMaxDevices];  // above 48 KB: raise the limit
  err = allow_smem(flash_bwd_dkv_sm90_kernel<D>, L::kBytes, device, smem_set);
  if (err != cudaSuccess) return err;
  using T = __nv_bfloat16;
  flash_bwd_dkv_sm90_kernel<D><<<dim3((t_k + L::kBN - 1) / L::kBN, bh), L::kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      t, t_k, causal, scale);
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
