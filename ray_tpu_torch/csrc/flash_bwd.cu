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
// Bound on the H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM), at the
// llama3-1b training shape [BH=128, T=2048, D=64] bf16 causal, kept pairs
// BH * T(T+1)/2: three products 6 * D * pairs = 103 GFLOP -> 104 us,
// against Q, K, V, O, dO in and dQ out plus LSE and Delta, 203 MB -> 61 us
// at HBM rate: bound by operations, so the design is about keeping the
// tensor cores fed. It recomputes P rather than store it, reads K/V from L2
// after the first block of a head, and skips the masked half.
//
// bf16 design (sm90 building blocks in sm90_common.cuh), the row-oriented
// twin of B1 (flash_fwd.cu). The Pallas kernel keeps one (b, h)'s whole K/V
// in VMEM; here a block owns 128 query rows and streams 64-key K/V tiles.
// Its 384 threads are three warpgroups:
//   - a producer warpgroup (setmaxnreg 24) whose one thread loads the
//     block's Q and dO once and keeps K/V tiles in flight by TMA through a
//     ring of four stages, each with a "full" mbarrier (TMA bytes landed)
//     and an "empty" one (every consumer warp done with it);
//   - two consumer warpgroups (setmaxnreg 240), each owning 64 query rows,
//     with dQ accumulated in registers (fp32). Per K/V tile: S = Q K^T and
//     dP = dO V^T are wgmma with Q, dO, K and V all K-major in shared
//     memory (128-byte swizzle); P = exp2(S scale log2 e - LSE log2 e) and
//     dS = P * (dP - Delta) are formed in registers while dP is still on the
//     tensor cores, and dS, rounded to bf16 (where the Pallas kernel keeps
//     it in fp32), is the A operand of dQ += dS K, a wgmma with K read
//     MN-major from the same tile (the transpose flag).
// Delta is computed in B2, way (a): before their first wait the consumers
// read their rows of O and dO from global memory (16-byte loads, the four
// threads of a row a quarter of it each) while the producer's first TMA
// loads are in flight, reduce in fp32, write each row's Delta once and keep
// it, and the row's LSE, in registers: a block's rows never change, so
// nothing is staged per tile, and no swizzled tile is read by hand.
// Tiles. ptxas (CUDA 12.9) compiles the consumers within the launch
// bound's cap of 168 registers a thread at 12 warps; setmaxnreg does not
// raise it. At D = 64 a consumer issues dQ += dS K of tile i - 1 behind S
// and dP of tile i, so the exp of S_i runs while dP_i and that product
// do: S 32 + dP 32 + dQ 32 + dS fragments 16 registers, which fits, and
// the consumer holds two stages at once (a ring of four timed faster on the
// H100 than three or five, at either D). At D = 128, dQ takes 64 registers
// and the deferred product does not fit beside S and dP, so each tile's dQ
// product is issued and waited for at the end of the tile. 128-key tiles
// would not fit at either D (S and dP 64 registers each).
// The grid runs the heaviest causal query blocks of each head first. Key
// tiles past the causal diagonal are not loaded; a consumer waits for and
// hands back the block's last tile without a product where it reaches none
// of its rows; the tile that straddles the diagonal, and the ragged tails
// of T and T_k, are masked per element (TMA zero-fills rows past the end of
// a head; rows past T are not written).
//
// fp32 inputs: plain fp32 FMA (no TF32), one warp per query row, lanes split
// the keys for the scores and the head dim for the sums.

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

// ---------------------------------------------------------------- bf16 path

constexpr int kDqBM = 128;       // query rows per block, 64 per consumer warpgroup
constexpr int kDqThreads = 384;  // consumer warpgroups 0 and 1, producer 2

// Tiles of the bf16 kernel, and its shared memory as offsets from a
// 1024-byte aligned base: Q, then dO (two column blocks each at D = 128),
// then per stage K and V, then the mbarriers (Q/dO full, full[stages],
// empty[stages]).
template <int D>
struct DqLayout {
  static constexpr int kBN = 64;  // keys per K/V tile
  // dQ += dS K of tile i - 1 issued behind S and dP of tile i (D = 64)
  static constexpr bool kDefer = D == 64;
  static constexpr int kStages = 4;
  static constexpr int kRowsBytes = kDqBM * D * 2;  // Q or dO
  static constexpr int kTileBytes = kBN * D * 2;    // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kDO = kRowsBytes;
  static constexpr int kK0 = 2 * kRowsBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBars = kK0 + kStages * kStageBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

// acc + the dot product of 8 bf16 pairs, in fp32
__device__ __forceinline__ float dot8_bf16(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    acc = fmaf(fx.x, fy.x, acc);
    acc = fmaf(fx.y, fy.y, acc);
  }
  return acc;
}

template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int t, int t_k,
                         int causal, float scale) {
  using L = DqLayout<D>;
  constexpr int S = L::kStages, BN = L::kBN;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar_q = base + L::kBars;
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + S + s); };
  auto k_tile = [&](int s) { return base + L::kK0 + s * L::kStageBytes; };
  auto v_tile = [&](int s) { return k_tile(s) + L::kTileBytes; };

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqBM;  // heaviest causal blocks first
  const int k_end = causal ? min(t_k, q0 + kDqBM) : t_k;
  const int n_tiles = (k_end + BN - 1) / BN;
  const int wg = warpgroup_index();

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    regs_dealloc<24>();
    if (threadIdx.x == 2 * 128) {
      mbar_arrive_expect_tx(bar_q, 2 * L::kRowsBytes);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_3d(base + L::kQ + c * kDqBM * 128, &tm_q, bar_q, 64 * c, q0, bh);
        tma_load_3d(base + L::kDO + c * kDqBM * 128, &tm_do, bar_q, 64 * c, q0, bh);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        mbar_wait(empty(s), ((it / S) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(full(s), L::kStageBytes);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(k_tile(s) + c * BN * 128, &tm_k, full(s), 64 * c, it * BN, bh);
          tma_load_3d(v_tile(s) + c * BN * 128, &tm_v, full(s), 64 * c, it * BN, bh);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    regs_alloc<240>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, tq = lane & 3;
    const int row_lo = q0 + 64 * wg;        // this warpgroup's first query row
    const int r0 = row_lo + 16 * warp + g;  // this thread's rows: r0 and r0 + 8
    const float sl2 = scale * kLog2e;
    // this warpgroup's 64 rows of Q and dO, in each column block
    const uint32_t q_rows = base + L::kQ + wg * 64 * 128;
    const uint32_t do_rows = base + L::kDO + wg * 64 * 128;

    // Delta = rowsum(dO * O) of rows r0 and r0 + 8, and their LSE * log2 e,
    // from global memory while the producer's first loads are in flight:
    // the four threads of a row (tq) each take D / 4 columns.
    float lse2[2], dlt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      float acc = 0.f;
      lse2[h] = 0.f;
      if (row < t) {
        const size_t at = ((size_t)bh * t + row) * D + tq * (D / 4);
        const uint4* po = reinterpret_cast<const uint4*>(o + at);
        const uint4* pd = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
        for (int j = 0; j < D / 32; ++j) acc = dot8_bf16(po[j], pd[j], acc);
        lse2[h] = lse[(size_t)bh * t + row] * kLog2e;
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      dlt[h] = acc;
      if (tq == 0 && row < t) delta[(size_t)bh * t + row] = acc;
    }

    // S = Q K^T and dP = dO V^T over D in k16 steps (32 bytes each inside a
    // column block), one commit group each
    auto issue_s_dp = [&](float (&sc)[BN / 2], float (&dp)[BN / 2], int s) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<BN>(sc, desc_k_major(q_rows + (kk / 4) * kDqBM * 128 + off),
                     desc_k_major(k_tile(s) + (kk / 4) * BN * 128 + off), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<BN>(dp, desc_k_major(do_rows + (kk / 4) * kDqBM * 128 + off),
                     desc_k_major(v_tile(s) + (kk / 4) * BN * 128 + off), kk > 0);
      }
      wgmma_commit();
    };
    // dQ += dS K over the tile's keys in k16 steps (16 rows of K each)
    auto issue_dq = [&](float (&acc)[D / 2], const uint32_t (&da)[BN / 16][4], int s) {
#pragma unroll
      for (int c = 0; c < BN / 16; ++c)
        wgmma_rs_tb<D>(acc, da[c], desc_mn_major(k_tile(s) + c * 16 * 128, BN * 128));
      wgmma_commit();
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with K/V stage s
    };

    float dq_acc[D / 2];  // m64nD accumulator
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    float sc[BN / 2], dp[BN / 2];  // S, then P; dP, then dS
    uint32_t da[BN / 16][4];       // dS of the newest tile, bf16

    // this warpgroup's tiles: none if its rows start at or past T; under
    // the causal mask, none past the key of its last row
    const int my_tiles = row_lo >= t ? 0
                         : causal    ? (min(t_k, row_lo + 64) + BN - 1) / BN
                                     : n_tiles;
    // commit groups in flight behind S: dP, and where deferred the dQ
    // product of the tile before (an empty group at the first tile)
    constexpr int kBehind = L::kDefer ? 2 : 1;
    mbar_wait(bar_q, 0);
    for (int it = 0; it < my_tiles; ++it) {
      const int s = it % S, sp = (it + S - 1) % S, k0 = it * BN;
      mbar_wait(full(s), (it / S) & 1);
      wgmma_fence();
      issue_s_dp(sc, dp, s);
      if constexpr (L::kDefer) {
        if (it > 0) issue_dq(dq_acc, da, sp);
        else wgmma_commit();
      }
      wgmma_wait<kBehind>();
      fence_regs(sc);
      // P = exp(scale S - LSE); masked pairs and keys >= T_k give P = 0
      const bool masked = k0 + BN > t_k || (causal && k0 + BN - 1 > row_lo);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int h = (i >> 1) & 1;
        float p = fast_exp2(fmaf(sc[i], sl2, -lse2[h]));
        if (masked) {
          const int key = k0 + 8 * (i / 4) + 2 * tq + (i & 1);
          if (key >= t_k || (causal && key > r0 + 8 * h)) p = 0.f;
        }
        sc[i] = p;
      }
      wgmma_wait<kBehind - 1>();
      fence_regs(dp);
      // dS = P * (dP - Delta), in place
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) dp[i] = sc[i] * (dp[i] - dlt[(i >> 1) & 1]);
      if constexpr (L::kDefer) {
        wgmma_wait<0>();
        fence_regs(dq_acc);
        if (it > 0) release(sp);
      }
      acc_to_a_frags(da, dp);
      if constexpr (!L::kDefer) {
        wgmma_fence();
        issue_dq(dq_acc, da, s);
        wgmma_wait<0>();
        fence_regs(dq_acc);
        release(s);
      }
    }
    if (L::kDefer && my_tiles > 0) {
      wgmma_fence();
      issue_dq(dq_acc, da, (my_tiles - 1) % S);
      wgmma_wait<0>();
      fence_regs(dq_acc);
      release((my_tiles - 1) % S);
    }
    // the block's later tiles reach none of these rows: hand them back
    for (int it = my_tiles; it < n_tiles; ++it) {
      mbar_wait(full(it % S), (it / S) & 1);
      release(it % S);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= t) continue;
      __nv_bfloat16* out = dq + ((size_t)bh * t + row) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + 8 * n + 2 * tq) =
            pack_bf16(dq_acc[4 * n + 2 * h] * scale, dq_acc[4 * n + 2 * h + 1] * scale);
    }
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
cudaError_t dq_bf16(const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const float* lse, float* delta, void* dq,
                    int bh, int t, int t_k, int causal, float scale, int device,
                    cudaStream_t stream) {
  using L = DqLayout<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = encode_rows_map(&tm_q, q, bh, t, D, kDqBM);
  if (err == cudaSuccess) err = encode_rows_map(&tm_do, dout, bh, t, D, kDqBM);
  if (err == cudaSuccess) err = encode_rows_map(&tm_k, k, bh, t_k, D, L::kBN);
  if (err == cudaSuccess) err = encode_rows_map(&tm_v, v, bh, t_k, D, L::kBN);
  if (err != cudaSuccess) return err;
  static bool smem_set[kMaxDevices];  // above 48 KB: raise the limit
  err = allow_smem(flash_bwd_dq_sm90_kernel<D>, L::kBytes, device, smem_set);
  if (err != cudaSuccess) return err;
  using T = __nv_bfloat16;
  flash_bwd_dq_sm90_kernel<D><<<dim3((t + kDqBM - 1) / kDqBM, bh), kDqThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const T*>(o), static_cast<const T*>(dout),
      lse, delta, static_cast<T*>(dq), t, t_k, causal, scale);
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
