// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes:
// kernel B1.
//
// Replaces: ray_tpu/ops/flash_attention.py, `_fwd_kernel` (line 35) and its
// launcher `_fwd` (line 58), the Pallas TPU kernel. It computes what that
// kernel computes, for q3 [BH, T, D] and k3/v3 [BH, T_k, D]:
//   S = scale * Q K^T, causal mask top-left aligned (q_pos >= k_pos, masked
//   scores = -1e30), m = rowmax S, P = exp(S - m), l = sum P,
//   O = P V / l (written in the input dtype), LSE = m + log l (fp32, [BH, 1, T]).
//
// Bound on the H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM), at the
// llama3-1b forward's shape [BH=128, T=2048, D=64] bf16 causal:
// 4 * D * BH * T(T+1)/2 = 68.7 GFLOP -> 69.5 us at the tensor-core peak,
// against 4 * 128*2048*64*2 B + 1 MB of LSE = 135 MB -> 40 us at HBM rate:
// bound by operations, so the design is about keeping the tensor cores fed.
//
// bf16 design (sm90 building blocks in sm90_common.cuh). The Pallas kernel
// keeps one (b, h)'s whole K/V in VMEM; a Hopper block's 227 KB of shared
// memory does not hold that at T = 2048, so a block owns 128 query rows and
// streams K/V tiles (128 keys at D = 64, 64 at D = 128), carrying an online
// softmax (row max m, row sum l and the O accumulator, fp32 in registers).
// Its 384 threads are three warpgroups:
//   - a producer warpgroup (setmaxnreg 24) whose one thread loads the Q
//     tile once and keeps K/V tiles in flight by TMA through a ring of
//     three stages in shared memory, each with a "full" mbarrier (TMA bytes
//     landed) and an "empty" one (every consumer warp done with it);
//   - two consumer warpgroups (setmaxnreg 240), each owning 64 query rows.
//     S = Q K^T is a wgmma with Q and K both K-major in shared memory; the
//     mask, online softmax and the rescale of O run in registers; O += P V
//     is a wgmma with P from registers (the S accumulator rounded to bf16,
//     where the Pallas kernel keeps P in fp32: O moves by about one bf16 ulp
//     at most) and V [key][d] MN-major in shared memory.
// Each consumer issues S_i = Q K_i and P_{i-1} V_{i-1} together and runs
// the softmax of S_i while P_{i-1} V_{i-1} is still on the tensor cores;
// the two consumers take turns issuing (named barriers, "ping-pong"), so
// one's softmax overlaps the other's products. ptxas (CUDA 12.9) compiles
// the consumers within the launch bound's 168 registers a thread; setmaxnreg
// does not raise that, so at D = 128 the key tile is 64 (S 32 registers
// beside O's 64) to keep the wgmma operands in registers without spills.
// The grid runs the heaviest causal query blocks of each head first. Key
// tiles entirely above the causal diagonal are not loaded; the tile that
// straddles it, and the ragged tails of T and T_k, are masked per element
// (TMA zero-fills rows past the end of a head). The softmax runs in base 2
// (scores scaled by scale * log2 e), the same function up to rounding.
//
// fp32 inputs: plain fp32 FMA (no TF32 anywhere), one warp per query row,
// lanes split the keys for S and the head dim for O.

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

// ---------------------------------------------------------------- bf16 path

constexpr int kFwdBM = 128;       // query rows per block, 64 per consumer warpgroup
constexpr int kFwdThreads = 384;  // consumer warpgroups 0 and 1, producer 2

// Tiles of the bf16 kernel, and its shared memory as offsets from a
// 1024-byte aligned base: Q (two column blocks at D = 128), then per stage
// K and V, then the mbarriers (Q full, full[stages], empty[stages]).
template <int D>
struct FwdLayout {
  // keys per K/V tile: at D = 128 a 128-key S accumulator beside O and P
  // does not fit the 168 registers a thread ptxas compiles the consumers
  // in, so 64
  static constexpr int kBN = D == 64 ? 128 : 64;
  // a consumer holds two stages at once (S_i and P_{i-1} V_{i-1}), so a
  // third keeps one load in flight
  static constexpr int kStages = 3;
  static constexpr int kQBytes = kFwdBM * D * 2;
  static constexpr int kTileBytes = kBN * D * 2;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK0 = kQBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBars = kK0 + kStages * kStageBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

// Masks one S tile (keys past T_k; under the causal mask keys after the
// row), then the online-softmax step: the row max m (in raw scores), the
// rescale factor alpha of the old O and l, and P = exp(scale (S - m)) in
// place of S, computed in base 2. `l` is this thread's share of the row
// sum; the four threads of a row agree on m.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2],
                                             bool masked, int k0, int t_k,
                                             int causal, int r0, int tq, float sl2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (masked) {
      const int key = k0 + 8 * (i / 4) + 2 * tq + (i & 1);
      if (key >= t_k || (causal && key > r0 + 8 * ((i >> 1) & 1))) sc[i] = kNegInf;
    }
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  }
  float neg_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m_run[h], mx[h]);
    alpha[h] = fast_exp2((m_run[h] - m_new) * sl2);
    m_run[h] = m_new;
    l_run[h] *= alpha[h];
    neg_m[h] = -m_new * sl2;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float p = fast_exp2(fmaf(sc[i], sl2, neg_m[(i >> 1) & 1]));
    sc[i] = p;
    l_run[(i >> 1) & 1] += p;
  }
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int t, int t_k, int causal, float scale) {
  using L = FwdLayout<D>;
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
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFwdBM;  // heaviest causal blocks first
  const int k_end = causal ? min(t_k, q0 + kFwdBM) : t_k;
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
      mbar_arrive_expect_tx(bar_q, L::kQBytes);
      for (int c = 0; c < D / 64; ++c)
        tma_load_3d(base + L::kQ + c * kFwdBM * 128, &tm_q, bar_q, 64 * c, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        mbar_wait(empty(s), ((it / S) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(full(s), L::kStageBytes);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(k_tile(s) + c * BN * 128, &tm_k, full(s), 64 * c,
                      it * BN, bh);
          tma_load_3d(v_tile(s) + c * BN * 128, &tm_v, full(s), 64 * c,
                      it * BN, bh);
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
    // this warpgroup's 64 rows of Q, in each column block
    const uint32_t q_rows = base + L::kQ + wg * 64 * 128;
    // S = Q K^T over D in k16 steps (32 bytes each inside a column block)
    auto issue_s = [&](float (&sc)[BN / 2], int s) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<BN>(sc, desc_k_major(q_rows + (kk / 4) * kFwdBM * 128 + off),
                      desc_k_major(k_tile(s) + (kk / 4) * BN * 128 + off), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V over the tile's keys in k16 steps (16 rows of V each)
    auto issue_pv = [&](float (&acc)[D / 2], const uint32_t (&pa)[BN / 16][4], int s) {
#pragma unroll
      for (int c = 0; c < BN / 16; ++c)
        wgmma_rs_tb<D>(acc, pa[c], desc_mn_major(v_tile(s) + c * 16 * 128, BN * 128));
      wgmma_commit();
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with K/V stage s
    };
    auto masked = [&](int k0) {
      return k0 + BN > t_k || (causal && k0 + BN - 1 > row_lo);
    };

    float acc[D / 2];  // O, m64nD accumulator
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // running row max of raw scores
    float l_run[2] = {0.f, 0.f};  // this thread's share of the running row sum
    float alpha[2];
    float sc[BN / 2];            // S, then P, of the newest tile
    uint32_t pa[BN / 16][4];     // P of the previous tile, bf16

    // Ping-pong: a warpgroup issues its products only after the other has
    // issued its own (named barrier 1 + warpgroup), so one's softmax runs
    // while the other's products do. Warpgroup 0 goes first.
    if (wg == 1) named_bar_arrive(1, 256);
    mbar_wait(bar_q, 0);

    // Tile i: issue S_i and P_{i-1} V_{i-1} together; the softmax of S_i
    // runs while P_{i-1} V_{i-1} does; then O is rescaled and P_i becomes
    // the A fragments for the next step.
    mbar_wait(full(0), 0);
    named_bar_sync(1 + wg, 256);
    wgmma_fence();
    issue_s(sc, 0);
    named_bar_arrive(2 - wg, 256);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, m_run, l_run, alpha, masked(0), 0, t_k, causal, r0, tq, sl2);
    acc_to_a_frags(pa, sc);
    for (int it = 1; it < n_tiles; ++it) {
      const int s = it % S, sp = (it - 1) % S;
      mbar_wait(full(s), (it / S) & 1);
      named_bar_sync(1 + wg, 256);
      wgmma_fence();
      issue_s(sc, s);
      issue_pv(acc, pa, sp);
      named_bar_arrive(2 - wg, 256);
      wgmma_wait<1>();
      fence_regs(sc);
      softmax_tile(sc, m_run, l_run, alpha, masked(it * BN), it * BN, t_k,
                   causal, r0, tq, sl2);
      wgmma_wait<0>();
      fence_regs(acc);
      release(sp);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      acc_to_a_frags(pa, sc);
    }
    wgmma_fence();
    issue_pv(acc, pa, (n_tiles - 1) % S);
    wgmma_wait<0>();
    fence_regs(acc);
    release((n_tiles - 1) % S);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
      const int row = r0 + 8 * h;
      if (row >= t) continue;
      const float inv = 1.f / l_run[h];
      __nv_bfloat16* orow = o + ((size_t)bh * t + row) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * tq) =
            pack_bf16(acc[4 * n + 2 * h] * inv, acc[4 * n + 2 * h + 1] * inv);
      if (tq == 0) lse[(size_t)bh * t + row] = m_run[h] * scale + logf(l_run[h]);
    }
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
  using L = FwdLayout<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = encode_rows_map(&tm_q, q, bh, t, D, kFwdBM);
  if (err == cudaSuccess) err = encode_rows_map(&tm_k, k, bh, t_k, D, L::kBN);
  if (err == cudaSuccess) err = encode_rows_map(&tm_v, v, bh, t_k, D, L::kBN);
  if (err != cudaSuccess) return err;
  static bool smem_set[kMaxDevices];  // above 48 KB: raise the limit
  err = allow_smem(flash_fwd_sm90_kernel<D>, L::kBytes, device, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((t + kFwdBM - 1) / kFwdBM, bh);
  flash_fwd_sm90_kernel<D><<<grid, kFwdThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, t, t_k, causal, scale);
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

// q, o: [bh, t, d]; k, v: [bh, t_k, d]; lse: [bh, t] fp32; all contiguous,
// 16-byte aligned. dtype 0 = fp32, 1 = bf16; d in {64, 128}. Returns a
// cudaError_t (0 = ok).
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
