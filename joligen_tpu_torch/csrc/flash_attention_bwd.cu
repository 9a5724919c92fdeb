// Flash-attention backward for Hopper (sm_90a): kernels K2 (dQ) and K3
// (dK, dV) of the port.
//
// Replace the Pallas TPU kernels of joligen_tpu/ops/flash_attention.py:
//   K2 _bwd_dq_kernel  (:114, pallas_call at :186)
//   K3 _bwd_dkv_kernel (:143, pallas_call at :210)
// Same function: the standard flash recomputation from the forward's saved
// per-row logsumexp. With s = sm_scale * q.k, P = exp(s - lse),
// dP = dO.v^T and dS = P * (dP - delta) * sm_scale, where
// delta = rowsum(dO * O) is computed once before both kernels:
//   K2: dQ = sum over keys of dS K
//   K3: dV = sum over queries of P^T dO, dK = sum over queries of dS^T Q
// Keys (K2) and queries (K3) at or past S contribute nothing, which is what
// the TPU kernels' -1e30 mask gives. Outputs are written in the input dtype,
// accumulation is fp32.
//
// The TPU kernels keep a head's whole K/V (K2) or Q/dO (K3) panel resident
// in VMEM and run their grid in order. A Hopper block has at most 227 KB of
// shared memory and blocks run in parallel in no order, so each block owns
// one cell of a 2-D grid -- (batch*head, 64-query tile; 64 or 128 in bf16)
// for K2, (batch*head, 64-key tile) for K3 -- and streams 64-row tiles of
// the other side through shared memory. Writing the backward as two
// kernels, as the TPU does, keeps every output tile owned by one block: no
// atomics. Ragged S is masked in the kernels: no host-side padding, nothing
// read past S. Inputs are (B, S, H, D) with the last two dims contiguous
// and arbitrary batch/sequence strides, so the q/k/v column slices of a
// fused qkv projection are read in place.
//
// K2 and K3 in fp32 run on FMAs on the CUDA cores (they hold 1e-4; TF32
// would not): tiles of the streamed side converted to fp32 in shared
// memory, four threads per row of the block's own tile (its rows in
// registers), P and dS passed between them by warp shuffles.
//
// In bf16 both run on the tensor cores, from tiles kept in shared memory as
// bf16 in the core-matrix layout of hopper_wgmma.cuh, streamed through a
// 2-stage ring by 16-byte cp.async (zero fill past S, the next tile's copy
// in flight during this tile's math), products accumulated in fp32:
//
// K2 (flash_bwd_dq_wgmma_kernel<D, WG>): a block owns WG x 64 queries of
// one batch*head (WG = 1 or 2 warpgroups sharing each K/V tile), their Q and
// dO tiles loaded once; each thread keeps the lse and delta of its two
// accumulator rows in registers. Per 64-key tile and warpgroup: S = Q.K^T
// and dP = dO.V^T (m64n64k16, both operands K-major from shared memory);
// P and dS / sm_scale on the accumulator layout, keys at or past S given
// P = 0 explicitly; then dQ += dS.K (m64nDk16) with dS converted to bf16 in
// registers as the A operand and the same K tile read MN-major. sm_scale
// is applied once, in the epilogue.
//
// K3 (flash_bwd_dkv_wgmma_kernel): one warpgroup owns 64 keys, its K and V
// tiles resident, and 64-query tiles of Q and dO (with their lse and delta,
// fp32) stream by. Per query tile, four products: S^T = K.Q^T and
// dP^T = V.dO^T (both operands K-major), then, from P^T and dS^T converted
// to bf16 in registers as the A operand, dV += P^T.dO and dK += dS^T.Q (dO
// and Q read MN-major). lse and delta vary along the accumulator's columns;
// queries at or past S get P = 0 explicitly.
//
// K3 at D >= 128 (dkv_warpgroups): dK and dV of 64 keys are D fp32
// accumulators a thread in one warpgroup, 128 or 160 beside the 64 of S^T
// and dP^T and the 32 of their bf16 fragments: past the 255 registers a
// thread may hold. So D is split in halves over two warpgroups of the same
// 64 keys: each forms S^T and dP^T at full depth from the shared tiles (the
// same values in both) and owns the dV and dK columns of its half, reading
// that half of dO and Q MN-major (hopper_wgmma.cuh: a column offset is a
// descriptor offset), D / 2 accumulators a thread each: 32 + 32 at D =
// 128, 40 + 40 at 160 (ptxas: 182 and 198 registers). The other design, one warpgroup owning dV and one dK, would need
// only S^T in the first but both products in the second (dS needs P), so
// the halves' load is uneven; and sharing P^T through shared memory costs a
// barrier a tile. Splitting D repeats S^T and dP^T (half of K3's products
// at one warpgroup) for an even split and no exchange.
//
// Head dim 96 (vit_vid's token motion modules): the products of depth D
// are 6 k16 steps, the D-wide ones m64n96k16 (48 fp32 accumulators a
// thread); K3 then holds dK and dV, 96 accumulators a thread, beside the
// 64 of S^T and dP^T, within the 255 registers of its one warpgroup. Every
// bf16 tile is 12 KiB and the fp32 kernels' tiles 49,664 bytes, so both
// routes take the opt-in dynamic shared memory past 48 KiB. Head dims 80,
// 128 and 160 (JiT-H's blocks; JiT-L's and MAT's 4-head motion modules;
// JiT-H's motion module) run the same way, 5, 8 or 10 k16 steps deep and
// m64n80k16, m64n128k16 or m64n160k16 wide; K2 holds D / 2 accumulators a
// thread (80 at D = 160) beside S and dP, and K3 at 128 and 160 splits D
// over two warpgroups (below). A bf16 tile is 20 KiB at D = 160: K2's
// plain tiling at 128 queries takes 160 KiB, K3's 120 KiB.
//
// Head dim 8 and short sequences, as in flash_attention_fwd.cu: at D = 8
// the bf16 kernels zero-pad their tiles to 16 columns in shared memory for
// the products of depth D (Q.K^T, dO.V^T and their transposes) and run the
// products D wide (dS.K, P^T.dO, dS^T.Q) as m64n8k16. Where S <= 32 both
// kernels take the packed tiling: a block owns 64 / SP whole (batch, head)
// sequences, SP = 2^sp_log2 >= S rows each, as queries and as keys, and a
// key counts for a query only in its own sequence and below S. K2 then
// computes dQ of those rows from one K/V tile (flash_bwd_dq_wgmma_packed_
// kernel, flash_bwd_dq_packed_kernel) and K3 dK and dV of the same rows
// from one Q/dO tile (flash_bwd_dkv_wgmma_packed_kernel,
// flash_bwd_dkv_packed_kernel).
//
// Bound. At the training path's shape (B, S, H, D) = (8, 256, 16, 32) bf16,
// K2 moves ~10.7 MB and does 6*B*H*S^2*D = 1.61 GFLOP, K3 ~12.8 MB and
// 2.15 GFLOP: memory-bound on paper (~0.003-0.004 ms at 3.35 TB/s). At
// 256 px, batch 8 (S = 1024) K2 does 25.8 GFLOP and K3 34.4 GFLOP, 0.026
// and 0.035 ms on the tensor cores; each recomputes P, 134 M exponentials,
// about 0.03 ms on the special-function units (16 per clock per SM), so the
// practical floor is near 1-2x the tensor-core bound.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_wgmma.cuh"

namespace {

constexpr int BLOCK_Q = 64;  // K2: queries per block; K3: queries per chunk
constexpr int BLOCK_K = 64;  // K3: keys per block; K2: keys per chunk
constexpr int THREADS_PER_ROW = 4;
constexpr int THREADS = 64 * THREADS_PER_ROW;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// The fp32 kernels' two streamed tiles (64 rows of D + 1 floats each) and,
// for K3, 64 lse and 64 delta values, in dynamic shared memory: at D = 96
// the tiles alone are 49,664 bytes, past the 48 KiB of static shared
// memory, so the launch opts in (set_smem).
template <int D>
constexpr int fma_smem_bytes(bool dkv) {
  return 2 * 64 * (D + 1) * 4 + (dkv ? 2 * 64 * 4 : 0);
}

template <int D>
__device__ __forceinline__ float* fma_tiles(float (*&sa)[D + 1],
                                            float (*&sb_)[D + 1]) {
  extern __shared__ __align__(16) float fsmem[];
  sa = reinterpret_cast<float(*)[D + 1]>(fsmem);
  sb_ = reinterpret_cast<float(*)[D + 1]>(fsmem + 64 * (D + 1));
  return fsmem + 2 * 64 * (D + 1);  // K3's lse, then its delta
}

// Row r (< S) of head h in batch b of a (B, S, H, D) tensor, into registers.
template <int D, typename T>
__device__ __forceinline__ void load_row(float (&dst)[D], const T* base,
                                         long long sb, long long ss, int b,
                                         int r, int h, bool ok) {
  const T* p = base + b * sb + static_cast<long long>(ok ? r : 0) * ss +
               static_cast<long long>(h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) dst[d] = ok ? to_float(p[d]) : 0.f;
}

// A 64-row tile of two (B, S, H, D) tensors into shared memory as fp32;
// rows at or past S are zero.
template <int D, typename T>
__device__ __forceinline__ void load_tiles(float (*sa)[D + 1],
                                           float (*sb_)[D + 1], const T* a,
                                           long long a_ss, const T* c,
                                           long long c_ss, int r0, int S) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int j = idx / D;
    const int d = idx % D;
    const int r = r0 + j;
    float x = 0.f, y = 0.f;
    if (r < S) {
      x = to_float(a[static_cast<long long>(r) * a_ss + d]);
      y = to_float(c[static_cast<long long>(r) * c_ss + d]);
    }
    sa[j][d] = x;
    sb_[j][d] = y;
  }
}

// K2 in fp32: one block per (batch*head, 64-query tile); K and V stream by.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, long long q_sb, long long q_ss,
                    long long k_sb, long long k_ss, long long v_sb,
                    long long v_ss, long long do_sb, long long do_ss,
                    float sm_scale) {
  static_assert(D % THREADS_PER_ROW == 0, "D must split over a row's threads");
  constexpr int KPT = BLOCK_K / THREADS_PER_ROW;  // keys scored per thread
  constexpr int DPT = D / THREADS_PER_ROW;        // dQ columns per thread

  // rows padded by one float: the four threads of a row read four
  // consecutive keys at one column, which then fall in distinct banks
  float(*sK)[D + 1];
  float(*sV)[D + 1];
  fma_tiles<D>(sK, sV);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int row = tid / THREADS_PER_ROW;
  const int part = tid % THREADS_PER_ROW;
  const int row_lane0 = (tid & 31) & ~(THREADS_PER_ROW - 1);
  const int qi = blockIdx.y * BLOCK_Q + row;
  const bool row_ok = qi < S;

  float qr[D], dor[D];
  load_row<D>(qr, q, q_sb, q_ss, b, qi, h, row_ok);
  load_row<D>(dor, dout, do_sb, do_ss, b, qi, h, row_ok);
  const long long stat = static_cast<long long>(bh) * S + (row_ok ? qi : 0);
  const float lse_i = lse[stat];
  const float delta_i = delta[stat];

  const T* kb = k + b * k_sb + static_cast<long long>(h) * D;
  const T* vb = v + b * v_sb + static_cast<long long>(h) * D;

  float acc[DPT];
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) acc[dd] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BLOCK_K) {
    __syncthreads();  // the previous tile is fully consumed
    load_tiles<D>(sK, sV, kb, k_ss, vb, v_ss, k0, S);
    __syncthreads();

    // dS for this thread's keys j = jj * THREADS_PER_ROW + part
    float ds[KPT];
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = jj * THREADS_PER_ROW + part;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], sK[j][d], s);
        dp = fmaf(dor[d], sV[j][d], dp);
      }
      const float p = (k0 + j < S) ? expf(s * sm_scale - lse_i) : 0.f;
      ds[jj] = p * (dp - delta_i) * sm_scale;
    }
#pragma unroll
    for (int j = 0; j < BLOCK_K; ++j) {
      // key j's dS lives in slot j / THREADS_PER_ROW of the row's thread
      // j % THREADS_PER_ROW
      const float dsj = __shfl_sync(FULL_MASK, ds[j / THREADS_PER_ROW],
                                    row_lane0 + j % THREADS_PER_ROW);
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        acc[dd] = fmaf(dsj, sK[j][part * DPT + dd], acc[dd]);
      }
    }
  }

  if (row_ok) {
    T* out = dq + ((static_cast<long long>(b) * S + qi) * H + h) * D +
             part * DPT;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) out[dd] = from_float<T>(acc[dd]);
  }
}

// K3 in fp32: one block per (batch*head, 64-key tile); Q, dO, lse, delta
// stream by.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, long long q_sb,
                     long long q_ss, long long k_sb, long long k_ss,
                     long long v_sb, long long v_ss, long long do_sb,
                     long long do_ss, float sm_scale) {
  static_assert(D % THREADS_PER_ROW == 0, "D must split over a row's threads");
  constexpr int QPT = BLOCK_Q / THREADS_PER_ROW;  // queries scored per thread
  constexpr int DPT = D / THREADS_PER_ROW;        // dK/dV columns per thread

  float(*sQ)[D + 1];
  float(*sdO)[D + 1];
  float* sL = fma_tiles<D>(sQ, sdO);
  float* sDelta = sL + BLOCK_Q;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int row = tid / THREADS_PER_ROW;
  const int part = tid % THREADS_PER_ROW;
  const int row_lane0 = (tid & 31) & ~(THREADS_PER_ROW - 1);
  const int kj = blockIdx.y * BLOCK_K + row;
  const bool row_ok = kj < S;

  float kr[D], vr[D];
  load_row<D>(kr, k, k_sb, k_ss, b, kj, h, row_ok);
  load_row<D>(vr, v, v_sb, v_ss, b, kj, h, row_ok);

  const T* qb = q + b * q_sb + static_cast<long long>(h) * D;
  const T* dob = dout + b * do_sb + static_cast<long long>(h) * D;
  const float* lb = lse + static_cast<long long>(bh) * S;
  const float* db = delta + static_cast<long long>(bh) * S;

  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) dk_acc[dd] = dv_acc[dd] = 0.f;

  for (int q0 = 0; q0 < S; q0 += BLOCK_Q) {
    __syncthreads();  // the previous tile is fully consumed
    load_tiles<D>(sQ, sdO, qb, q_ss, dob, do_ss, q0, S);
    if (tid < BLOCK_Q) {
      const bool ok = q0 + tid < S;
      sL[tid] = ok ? lb[q0 + tid] : 0.f;
      sDelta[tid] = ok ? db[q0 + tid] : 0.f;
    }
    __syncthreads();

    // P and dS for this thread's queries i = ii * THREADS_PER_ROW + part
    float p[QPT], ds[QPT];
#pragma unroll
    for (int ii = 0; ii < QPT; ++ii) {
      const int i = ii * THREADS_PER_ROW + part;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(kr[d], sQ[i][d], s);
        dp = fmaf(vr[d], sdO[i][d], dp);
      }
      const float pi = (q0 + i < S) ? expf(s * sm_scale - sL[i]) : 0.f;
      p[ii] = pi;
      ds[ii] = pi * (dp - sDelta[i]) * sm_scale;
    }
#pragma unroll
    for (int i = 0; i < BLOCK_Q; ++i) {
      const int src = row_lane0 + i % THREADS_PER_ROW;
      const float pi = __shfl_sync(FULL_MASK, p[i / THREADS_PER_ROW], src);
      const float dsi = __shfl_sync(FULL_MASK, ds[i / THREADS_PER_ROW], src);
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        dv_acc[dd] = fmaf(pi, sdO[i][part * DPT + dd], dv_acc[dd]);
        dk_acc[dd] = fmaf(dsi, sQ[i][part * DPT + dd], dk_acc[dd]);
      }
    }
  }

  if (row_ok) {
    const long long off =
        ((static_cast<long long>(b) * S + kj) * H + h) * D + part * DPT;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      dk[off + dd] = from_float<T>(dk_acc[dd]);
      dv[off + dd] = from_float<T>(dv_acc[dd]);
    }
  }
}

// ---- K2, bf16 route: wgmma on the tensor cores -----------------------------

using bf16 = __nv_bfloat16;

// Shared memory of a K2 block: WG Q tiles, WG dO tiles, then 2 K and 2 V
// stages; every tile 64 rows x D in the core-matrix layout.
template <int D, int WG>
struct DqSmem {
  static constexpr int DP = D < 16 ? 16 : D;  // columns: D, or 16 at D = 8
  static constexpr int TILE = 64 * DP * 2;
  static constexpr int DO = WG * TILE;
  static constexpr int K = 2 * WG * TILE;
  static constexpr int V = K + 2 * TILE;
  static constexpr int BYTES = V + 2 * TILE;
};

template <int D, int WG>
__global__ void __launch_bounds__(WG * 128)
flash_bwd_dq_wgmma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int S, int H, long long q_sb,
                          long long q_ss, long long k_sb, long long k_ss,
                          long long v_sb, long long v_ss, long long do_sb,
                          long long do_ss, float sm_scale) {
  using namespace jg_hopper;
  using L = DqSmem<D, WG>;
  constexpr int NT = WG * 128;
  static_assert((D % 16 == 0 || D == 8) && D <= 160,
                "D: 8 or a multiple of 16, at most 160");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * 64 * WG;
  const bf16* kb = k + b * k_sb + static_cast<long long>(h) * D;
  const bf16* vb = v + b * v_sb + static_cast<long long>(h) * D;

  // the Q and dO tiles and the first K/V stage: one cp.async group
#pragma unroll
  for (int w = 0; w < WG; ++w) {
    load_rows<D, NT>(base + w * L::TILE,
                     q + b * q_sb + static_cast<long long>(h) * D, q_ss,
                     q0 + 64 * w, S);
    load_rows<D, NT>(base + L::DO + w * L::TILE,
                     dout + b * do_sb + static_cast<long long>(h) * D, do_ss,
                     q0 + 64 * w, S);
  }
  load_rows<D, NT>(base + L::K, kb, k_ss, 0, S);
  load_rows<D, NT>(base + L::V, vb, v_ss, 0, S);
  cp_async_commit();
  zero_pad_tiles<D, NT>(smem, 2 * WG + 4, L::TILE);

  // this thread's two rows (16 * warp + lane / 4, and 8 further) of the
  // warpgroup's 64: lse in the log2 domain and delta; 0 past S
  const int row0 = q0 + 64 * wg + 16 * warp + (lane >> 2);
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    const bool ok = qi < S;
    const long long stat = static_cast<long long>(bh) * S + (ok ? qi : 0);
    lse2[r] = ok ? lse[stat] * LOG2E : 0.f;
    dlt[r] = ok ? delta[stat] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const float scale_log2 = sm_scale * LOG2E;
  const uint32_t sq = base + wg * L::TILE;
  const uint32_t sdo = base + L::DO + wg * L::TILE;
  const int n_tiles = (S + BLOCK_K - 1) / BLOCK_K;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {  // the next stage's copy overlaps this tile
      load_rows<D, NT>(base + L::K + (st ^ 1) * L::TILE, kb, k_ss,
                       (it + 1) * BLOCK_K, S);
      load_rows<D, NT>(base + L::V + (st ^ 1) * L::TILE, vb, v_ss,
                       (it + 1) * BLOCK_K, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();  // this stage is in shared memory, visible to wgmma
    const uint32_t sk = base + L::K + st * L::TILE;
    const uint32_t sv = base + L::V + st * L::TILE;

    // S = Q.K^T and dP = dO.V^T: rows are queries, columns keys
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < L::DP / 16; ++t) {
      wgmma_ss_n64(s, desc_k_major<64>(sq, t), desc_k_major<64>(sk, t),
                   t > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int t = 0; t < L::DP / 16; ++t) {
      wgmma_ss_n64(dp, desc_k_major<64>(sdo, t), desc_k_major<64>(sv, t),
                   t > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS / sm_scale = P * (dP - delta), into s; register i holds row
    // (i / 2) % 2 and key 8 * (i / 4) + 2 * (lane % 4) + i % 2 of the tile
    const int key0 = it * BLOCK_K + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = key0 + 8 * (i >> 2) + (i & 1) < S
                          ? exp2f(fmaf(s[i], scale_log2, -lse2[r]))
                          : 0.f;
      s[i] = p * (dp[i] - dlt[r]);
    }
    uint32_t dsa[4][4];
    acc_to_a_frags(s, dsa);

    // dQ += dS.K: the K tile read MN-major
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      wgmma_rs<D>(acc, dsa[t], desc_mn_major<64>(sk, t));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warpgroup is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= S) continue;
    bf16* out = dq + ((static_cast<long long>(b) * S + qi) * H + h) * D +
                2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * sm_scale, acc[4 * j + 2 * r + 1] * sm_scale);
    }
  }
}

// ---- K3, bf16 route: wgmma on the tensor cores -----------------------------

// Shared memory of a K3 block: the K and V tiles, then 2 stages of the Q
// and dO tiles (64 rows x D each, the core-matrix layout of hopper_wgmma.cuh)
// and 2 stages of 64 lse and 64 delta values.
// K3's warpgroups: D split in halves over two at D >= 128 (see the top)
template <int D>
__host__ __device__ constexpr int dkv_warpgroups() {
  return D >= 128 ? 2 : 1;
}

template <int D>
struct DkvSmem {
  static constexpr int DP = D < 16 ? 16 : D;  // columns: D, or 16 at D = 8
  static constexpr int TILE = 64 * DP * 2;
  static constexpr int V = TILE;
  static constexpr int Q = 2 * TILE;
  static constexpr int DO = Q + 2 * TILE;
  static constexpr int LSE = DO + 2 * TILE;
  static constexpr int DELTA = LSE + 2 * 64 * 4;
  static constexpr int BYTES = DELTA + 2 * 64 * 4;
};

template <int D>
__global__ void __launch_bounds__(dkv_warpgroups<D>() * 128)
flash_bwd_dkv_wgmma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                           int H, long long q_sb, long long q_ss,
                           long long k_sb, long long k_ss, long long v_sb,
                           long long v_ss, long long do_sb, long long do_ss,
                           float sm_scale) {
  using namespace jg_hopper;
  using L = DkvSmem<D>;
  static_assert((D % 16 == 0 || D == 8) && D <= 160,
                "D: 8 or a multiple of 16, at most 160");
  constexpr int NT = dkv_warpgroups<D>() * 128;
  constexpr int DH = D / dkv_warpgroups<D>();  // this warpgroup's columns
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const float* s_lse = reinterpret_cast<const float*>(smem + L::LSE);
  const float* s_delta = reinterpret_cast<const float*>(smem + L::DELTA);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  // the first column of this warpgroup's half, and its byte offset in a
  // tile (column chunks of 64 rows x 16 bytes)
  const int col0 = wg * DH;
  const uint32_t half = static_cast<uint32_t>(col0 / 8) * 1024;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.y * BLOCK_K;
  const bf16* qb = q + b * q_sb + static_cast<long long>(h) * D;
  const bf16* dob = dout + b * do_sb + static_cast<long long>(h) * D;
  const float* lb = lse + static_cast<long long>(bh) * S;
  const float* db = delta + static_cast<long long>(bh) * S;

  // 64 queries' Q, dO, lse and delta into stage st
  auto load_queries = [&](int q0, int st) {
    load_rows<D, NT>(base + L::Q + st * L::TILE, qb, q_ss, q0, S);
    load_rows<D, NT>(base + L::DO + st * L::TILE, dob, do_ss, q0, S);
    const int i = tid & 63;
    const bool ok = q0 + i < S;
    if (tid < 64) {
      cp_async4(base + L::LSE + (st * 64 + i) * 4, lb + (ok ? q0 + i : 0), ok);
    } else if (tid < 128) {
      cp_async4(base + L::DELTA + (st * 64 + i) * 4, db + (ok ? q0 + i : 0),
                ok);
    }
  };

  // the block's K and V tiles and the first query stage: one cp.async group
  load_rows<D, NT>(base, k + b * k_sb + static_cast<long long>(h) * D, k_ss,
                   k0, S);
  load_rows<D, NT>(base + L::V, v + b * v_sb + static_cast<long long>(h) * D,
                   v_ss, k0, S);
  load_queries(0, 0);
  cp_async_commit();
  zero_pad_tiles<D, NT>(smem, 6, L::TILE);

  float dk_acc[DH / 2], dv_acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const float scale_log2 = sm_scale * LOG2E;
  const int n_tiles = (S + BLOCK_Q - 1) / BLOCK_Q;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {  // the next stage's copy overlaps this tile
      load_queries((it + 1) * BLOCK_Q, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();  // this stage is in shared memory, visible to wgmma
    const uint32_t sq = base + L::Q + st * L::TILE;
    const uint32_t sdo = base + L::DO + st * L::TILE;

    // S^T = K.Q^T and dP^T = V.dO^T: rows are keys, columns queries
    float p[32], ds[32];
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < L::DP / 16; ++t) {
      wgmma_ss_n64(p, desc_k_major<64>(base, t), desc_k_major<64>(sq, t),
                   t > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int t = 0; t < L::DP / 16; ++t) {
      wgmma_ss_n64(ds, desc_k_major<64>(base + L::V, t),
                   desc_k_major<64>(sdo, t), t > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(p);
    fence_regs(ds);

    // P^T and dS^T; register i holds query column 8 * (i / 4) +
    // 2 * (lane % 4) + i % 2 of the tile
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = c0 + 8 * (i >> 2) + (i & 1);
      const float lse_c = s_lse[st * 64 + c];
      const float pi = it * BLOCK_Q + c < S
                           ? exp2f(fmaf(p[i], scale_log2, -lse_c * LOG2E))
                           : 0.f;
      p[i] = pi;
      ds[i] = pi * (ds[i] - s_delta[st * 64 + c]) * sm_scale;
    }
    uint32_t pa[4][4], dsa[4][4];
    acc_to_a_frags(p, pa);
    acc_to_a_frags(ds, dsa);

    // dV += P^T.dO and dK += dS^T.Q over this warpgroup's columns: dO and
    // Q read MN-major
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      wgmma_rs<DH>(dv_acc, pa[t], desc_mn_major<64>(sdo + half, t));
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      wgmma_rs<DH>(dk_acc, dsa[t], desc_mn_major<64>(sq + half, t));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncthreads();  // every warpgroup is done with this stage
  }

  const int row0 = k0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = row0 + 8 * r;
    if (kj >= S) continue;
    const long long off = ((static_cast<long long>(b) * S + kj) * H + h) * D +
                          col0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * r],
                                dk_acc[4 * j + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * r],
                                dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

// ---- the packed tiling (S <= 32) -------------------------------------------

using jg_hopper::locate_packed;
using jg_hopper::packed_pair;

// Two packed 64-row tiles of (B, S, H, D) tensors into shared memory as
// fp32; rows that are not real are zero.
template <int D>
__device__ __forceinline__ void load_tiles_packed(
    float (*sa)[D + 1], float (*sb_)[D + 1], const float* a, long long a_sb,
    long long a_ss, const float* c, long long c_sb, long long c_ss, int n0,
    int sp_log2, int S, int H, int n_seq) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int j = idx / D;
    const int d = idx % D;
    int b, h, pos;
    const bool ok = locate_packed(j, n0, sp_log2, S, H, n_seq, b, h, pos);
    const long long off = static_cast<long long>(h) * D + d;
    sa[j][d] = ok ? a[b * a_sb + pos * a_ss + off] : 0.f;
    sb_[j][d] = ok ? c[b * c_sb + pos * c_ss + off] : 0.f;
  }
}

// K2 in fp32, packed: the block's 64 rows are its queries and its keys.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_packed_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int n_seq, int S, int H,
                           long long q_sb, long long q_ss, long long k_sb,
                           long long k_ss, long long v_sb, long long v_ss,
                           long long do_sb, long long do_ss, float sm_scale,
                           int sp_log2) {
  constexpr int KPT = BLOCK_K / THREADS_PER_ROW;
  constexpr int DPT = D / THREADS_PER_ROW;
  float(*sK)[D + 1];
  float(*sV)[D + 1];
  fma_tiles<D>(sK, sV);

  const int n0 = blockIdx.x << (6 - sp_log2);
  const int tid = threadIdx.x;
  const int row = tid / THREADS_PER_ROW;
  const int part = tid % THREADS_PER_ROW;
  const int row_lane0 = (tid & 31) & ~(THREADS_PER_ROW - 1);

  load_tiles_packed<D>(sK, sV, k, k_sb, k_ss, v, v_sb, v_ss, n0, sp_log2, S,
                       H, n_seq);
  int b, h, pos;
  const bool row_ok = locate_packed(row, n0, sp_log2, S, H, n_seq, b, h, pos);
  float qr[D], dor[D];
  load_row<D>(qr, q, q_sb, q_ss, b, pos, h, row_ok);
  load_row<D>(dor, dout, do_sb, do_ss, b, pos, h, row_ok);
  const long long stat = (static_cast<long long>(b) * H + h) * S + pos;
  const float lse_i = row_ok ? lse[stat] : 0.f;
  const float delta_i = row_ok ? delta[stat] : 0.f;
  __syncthreads();

  float ds[KPT];
#pragma unroll
  for (int jj = 0; jj < KPT; ++jj) {
    const int j = jj * THREADS_PER_ROW + part;
    float sc = 0.f, dp = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      sc = fmaf(qr[d], sK[j][d], sc);
      dp = fmaf(dor[d], sV[j][d], dp);
    }
    const float p = packed_pair(row, j, sp_log2, S)
                        ? expf(sc * sm_scale - lse_i) : 0.f;
    ds[jj] = p * (dp - delta_i) * sm_scale;
  }
  float acc[DPT];
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) acc[dd] = 0.f;
#pragma unroll
  for (int j = 0; j < BLOCK_K; ++j) {
    const float dsj = __shfl_sync(FULL_MASK, ds[j / THREADS_PER_ROW],
                                  row_lane0 + j % THREADS_PER_ROW);
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      acc[dd] = fmaf(dsj, sK[j][part * DPT + dd], acc[dd]);
    }
  }
  if (row_ok) {
    float* out = dq + ((static_cast<long long>(b) * S + pos) * H + h) * D +
                 part * DPT;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) out[dd] = acc[dd];
  }
}

// K3 in fp32, packed: the block's 64 rows are its keys and its queries.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_packed_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int n_seq, int S, int H, long long q_sb,
                            long long q_ss, long long k_sb, long long k_ss,
                            long long v_sb, long long v_ss, long long do_sb,
                            long long do_ss, float sm_scale, int sp_log2) {
  constexpr int QPT = BLOCK_Q / THREADS_PER_ROW;
  constexpr int DPT = D / THREADS_PER_ROW;
  float(*sQ)[D + 1];
  float(*sdO)[D + 1];
  float* sL = fma_tiles<D>(sQ, sdO);
  float* sDelta = sL + BLOCK_Q;

  const int n0 = blockIdx.x << (6 - sp_log2);
  const int tid = threadIdx.x;
  const int row = tid / THREADS_PER_ROW;
  const int part = tid % THREADS_PER_ROW;
  const int row_lane0 = (tid & 31) & ~(THREADS_PER_ROW - 1);

  load_tiles_packed<D>(sQ, sdO, q, q_sb, q_ss, dout, do_sb, do_ss, n0,
                       sp_log2, S, H, n_seq);
  if (tid < BLOCK_Q) {
    int b, h, pos;
    const bool ok = locate_packed(tid, n0, sp_log2, S, H, n_seq, b, h, pos);
    const long long stat = (static_cast<long long>(b) * H + h) * S + pos;
    sL[tid] = ok ? lse[stat] : 0.f;
    sDelta[tid] = ok ? delta[stat] : 0.f;
  }
  int b, h, pos;
  const bool row_ok = locate_packed(row, n0, sp_log2, S, H, n_seq, b, h, pos);
  float kr[D], vr[D];
  load_row<D>(kr, k, k_sb, k_ss, b, pos, h, row_ok);
  load_row<D>(vr, v, v_sb, v_ss, b, pos, h, row_ok);
  __syncthreads();

  float p[QPT], ds[QPT];
#pragma unroll
  for (int ii = 0; ii < QPT; ++ii) {
    const int i = ii * THREADS_PER_ROW + part;
    float sc = 0.f, dp = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      sc = fmaf(kr[d], sQ[i][d], sc);
      dp = fmaf(vr[d], sdO[i][d], dp);
    }
    // query i counts for this key when the key is in i's sequence and the
    // query is a real row
    const float pi = packed_pair(row, i, sp_log2, S)
                         ? expf(sc * sm_scale - sL[i]) : 0.f;
    p[ii] = pi;
    ds[ii] = pi * (dp - sDelta[i]) * sm_scale;
  }
  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) dk_acc[dd] = dv_acc[dd] = 0.f;
#pragma unroll
  for (int i = 0; i < BLOCK_Q; ++i) {
    const int src = row_lane0 + i % THREADS_PER_ROW;
    const float pi = __shfl_sync(FULL_MASK, p[i / THREADS_PER_ROW], src);
    const float dsi = __shfl_sync(FULL_MASK, ds[i / THREADS_PER_ROW], src);
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      dv_acc[dd] = fmaf(pi, sdO[i][part * DPT + dd], dv_acc[dd]);
      dk_acc[dd] = fmaf(dsi, sQ[i][part * DPT + dd], dk_acc[dd]);
    }
  }
  if (row_ok) {
    const long long off =
        ((static_cast<long long>(b) * S + pos) * H + h) * D + part * DPT;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      dk[off + dd] = dk_acc[dd];
      dv[off + dd] = dv_acc[dd];
    }
  }
}

// K2 in bf16, packed: one warpgroup; Q, dO, K and V tiles of the block's 64
// packed rows loaded once; S = Q.K^T and dP = dO.V^T, dS on the
// block-diagonal mask, dQ = dS.K (K read MN-major), sm_scale in the epilogue.
template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_wgmma_packed_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int n_seq, int S, int H, long long q_sb,
    long long q_ss, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, long long do_sb, long long do_ss, float sm_scale,
    int sp_log2) {
  using namespace jg_hopper;
  using L = DqSmem<D, 1>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = smem_u32(smem);
  const uint32_t sdo = sq + L::TILE;
  const uint32_t sk = sq + 2 * L::TILE;
  const uint32_t sv = sq + 3 * L::TILE;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = blockIdx.x << (6 - sp_log2);

  load_rows_packed<D, 128>(sq, q, q_sb, q_ss, n0, n_seq, H, S, sp_log2);
  load_rows_packed<D, 128>(sdo, dout, do_sb, do_ss, n0, n_seq, H, S,
                           sp_log2);
  load_rows_packed<D, 128>(sk, k, k_sb, k_ss, n0, n_seq, H, S, sp_log2);
  load_rows_packed<D, 128>(sv, v, v_sb, v_ss, n0, n_seq, H, S, sp_log2);
  cp_async_commit();
  zero_pad_tiles<D, 128>(smem, 4, L::TILE);

  const int row0 = 16 * warp + (lane >> 2);
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int b, h, pos;
    const bool ok =
        locate_packed(row0 + 8 * r, n0, sp_log2, S, H, n_seq, b, h, pos);
    const long long stat = (static_cast<long long>(b) * H + h) * S + pos;
    lse2[r] = ok ? lse[stat] * LOG2E : 0.f;
    dlt[r] = ok ? delta[stat] : 0.f;
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float s[32], dp[32];
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < L::DP / 16; ++t) {
    wgmma_ss_n64(s, desc_k_major<64>(sq, t), desc_k_major<64>(sk, t), t > 0);
  }
  wgmma_commit();
#pragma unroll
  for (int t = 0; t < L::DP / 16; ++t) {
    wgmma_ss_n64(dp, desc_k_major<64>(sdo, t), desc_k_major<64>(sv, t),
                 t > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);

  const float scale_log2 = sm_scale * LOG2E;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const int key = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    const float p = packed_pair(row0 + 8 * r, key, sp_log2, S)
                        ? exp2f(fmaf(s[i], scale_log2, -lse2[r]))
                        : 0.f;
    s[i] = p * (dp[i] - dlt[r]);
  }
  uint32_t dsa[4][4];
  acc_to_a_frags(s, dsa);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    wgmma_rs<D>(acc, dsa[t], desc_mn_major<64>(sk, t));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int b, h, pos;
    if (!locate_packed(row0 + 8 * r, n0, sp_log2, S, H, n_seq, b, h, pos)) {
      continue;
    }
    bf16* out = dq + ((static_cast<long long>(b) * S + pos) * H + h) * D +
                2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * sm_scale, acc[4 * j + 2 * r + 1] * sm_scale);
    }
  }
}

// K3 in bf16, packed: one warpgroup; K, V, Q and dO tiles of the block's 64
// packed rows and their lse and delta loaded once; S^T = K.Q^T and
// dP^T = V.dO^T, P^T and dS^T on the block-diagonal mask, dV = P^T.dO and
// dK = dS^T.Q (dO and Q read MN-major).
template <int D>
__global__ void __launch_bounds__(dkv_warpgroups<D>() * 128)
flash_bwd_dkv_wgmma_packed_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int n_seq, int S, int H,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long do_sb, long long do_ss,
    float sm_scale, int sp_log2) {
  using namespace jg_hopper;
  using L = DkvSmem<D>;
  constexpr int NT = dkv_warpgroups<D>() * 128;
  constexpr int DH = D / dkv_warpgroups<D>();  // this warpgroup's columns
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sk = smem_u32(smem);
  const uint32_t sv = sk + L::TILE;
  const uint32_t sq = sk + 2 * L::TILE;
  const uint32_t sdo = sk + 3 * L::TILE;
  float* s_lse = reinterpret_cast<float*>(smem + 4 * L::TILE);
  float* s_delta = s_lse + 64;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int n0 = blockIdx.x << (6 - sp_log2);
  const int col0 = wg * DH;
  const uint32_t half = static_cast<uint32_t>(col0 / 8) * 1024;

  load_rows_packed<D, NT>(sk, k, k_sb, k_ss, n0, n_seq, H, S, sp_log2);
  load_rows_packed<D, NT>(sv, v, v_sb, v_ss, n0, n_seq, H, S, sp_log2);
  load_rows_packed<D, NT>(sq, q, q_sb, q_ss, n0, n_seq, H, S, sp_log2);
  load_rows_packed<D, NT>(sdo, dout, do_sb, do_ss, n0, n_seq, H, S,
                          sp_log2);
  cp_async_commit();
  zero_pad_tiles<D, NT>(smem, 4, L::TILE);
  if (tid < 128) {
    // query column c = tid % 64: its lse (threads 0-63) or delta (64-127)
    int b, h, pos;
    const int c = tid & 63;
    const bool ok = locate_packed(c, n0, sp_log2, S, H, n_seq, b, h, pos);
    const long long stat = (static_cast<long long>(b) * H + h) * S + pos;
    if (tid < 64) {
      s_lse[c] = ok ? lse[stat] * LOG2E : 0.f;
    } else {
      s_delta[c] = ok ? delta[stat] : 0.f;
    }
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float p[32], ds[32];
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < L::DP / 16; ++t) {
    wgmma_ss_n64(p, desc_k_major<64>(sk, t), desc_k_major<64>(sq, t), t > 0);
  }
  wgmma_commit();
#pragma unroll
  for (int t = 0; t < L::DP / 16; ++t) {
    wgmma_ss_n64(ds, desc_k_major<64>(sv, t), desc_k_major<64>(sdo, t),
                 t > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(p);
  fence_regs(ds);

  // register i holds key row 16 * warp + lane / 4 + 8 * ((i / 2) % 2) and
  // query column 8 * (i / 4) + 2 * (lane % 4) + i % 2
  const float scale_log2 = sm_scale * LOG2E;
  const int row0 = 16 * warp + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int key = row0 + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    const float pi = packed_pair(key, c, sp_log2, S)
                         ? exp2f(fmaf(p[i], scale_log2, -s_lse[c]))
                         : 0.f;
    p[i] = pi;
    ds[i] = pi * (ds[i] - s_delta[c]) * sm_scale;
  }
  uint32_t pa[4][4], dsa[4][4];
  acc_to_a_frags(p, pa);
  acc_to_a_frags(ds, dsa);
  float dk_acc[DH / 2], dv_acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  fence_regs(dv_acc);
  fence_regs(dk_acc);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    wgmma_rs<DH>(dv_acc, pa[t], desc_mn_major<64>(sdo + half, t));
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    wgmma_rs<DH>(dk_acc, dsa[t], desc_mn_major<64>(sq + half, t));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dv_acc);
  fence_regs(dk_acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int b, h, pos;
    if (!locate_packed(row0 + 8 * r, n0, sp_log2, S, H, n_seq, b, h, pos)) {
      continue;
    }
    const long long off = ((static_cast<long long>(b) * S + pos) * H + h) *
                              D + col0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * r],
                                dk_acc[4 * j + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * r],
                                dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;
  int B, S, H;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss;
  float sm_scale;
  int q_tile;   // K2 in bf16: queries per block, 64 or 128
  int sp_log2;  // -1: the plain tiling; else packed, 2^sp_log2 rows a sequence
  cudaStream_t stream;
};

template <int D>
int launch_dq_fma(const Args& a) {
  const dim3 grid(a.B * a.H, (a.S + BLOCK_Q - 1) / BLOCK_Q);
  auto kernel = flash_bwd_dq_kernel<D, float>;
  jg_hopper::set_smem(kernel, fma_smem_bytes<D>(false));
  kernel<<<grid, THREADS, fma_smem_bytes<D>(false), a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.out0), a.S, a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss,
      a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int WG>
int launch_dq_wgmma(const Args& a) {
  using L = DqSmem<D, WG>;
  auto kernel = flash_bwd_dq_wgmma_kernel<D, WG>;
  jg_hopper::set_smem(kernel, L::BYTES);
  const dim3 grid(a.B * a.H, (a.S + 64 * WG - 1) / (64 * WG));
  kernel<<<grid, WG * 128, L::BYTES, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), a.S, a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss,
      a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_fma(const Args& a) {
  const dim3 grid(a.B * a.H, (a.S + BLOCK_K - 1) / BLOCK_K);
  auto kernel = flash_bwd_dkv_kernel<D, float>;
  jg_hopper::set_smem(kernel, fma_smem_bytes<D>(true));
  kernel<<<grid, THREADS, fma_smem_bytes<D>(true), a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.S, a.H,
      a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss,
      a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_wgmma(const Args& a) {
  using L = DkvSmem<D>;
  auto kernel = flash_bwd_dkv_wgmma_kernel<D>;
  jg_hopper::set_smem(kernel, L::BYTES);
  const dim3 grid(a.B * a.H, (a.S + BLOCK_K - 1) / BLOCK_K);
  kernel<<<grid, dkv_warpgroups<D>() * 128, L::BYTES, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1), a.S, a.H,
      a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss,
      a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// the packed tiling: 64 / 2^sp_log2 sequences a block
template <int D>
int launch_packed(const Args& a, int dtype, bool dkv) {
  const int n_seq = a.B * a.H;
  const int per_block = 64 >> a.sp_log2;
  const dim3 grid((n_seq + per_block - 1) / per_block);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  if (dtype == 0) {
    const float* q = static_cast<const float*>(a.q);
    const float* k = static_cast<const float*>(a.k);
    const float* v = static_cast<const float*>(a.v);
    const float* dout = static_cast<const float*>(a.dout);
    const int bytes = fma_smem_bytes<D>(dkv);
    if (dkv) {
      jg_hopper::set_smem(flash_bwd_dkv_packed_kernel<D>, bytes);
      flash_bwd_dkv_packed_kernel<D><<<grid, THREADS, bytes, a.stream>>>(
          q, k, v, dout, lse, delta, static_cast<float*>(a.out0),
          static_cast<float*>(a.out1), n_seq, a.S, a.H, a.q_sb, a.q_ss,
          a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale,
          a.sp_log2);
    } else {
      jg_hopper::set_smem(flash_bwd_dq_packed_kernel<D>, bytes);
      flash_bwd_dq_packed_kernel<D><<<grid, THREADS, bytes, a.stream>>>(
          q, k, v, dout, lse, delta, static_cast<float*>(a.out0), n_seq, a.S,
          a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb,
          a.do_ss, a.sm_scale, a.sp_log2);
    }
  } else {
    const bf16* q = static_cast<const bf16*>(a.q);
    const bf16* k = static_cast<const bf16*>(a.k);
    const bf16* v = static_cast<const bf16*>(a.v);
    const bf16* dout = static_cast<const bf16*>(a.dout);
    if (dkv) {
      constexpr int BYTES = 4 * DkvSmem<D>::TILE + 2 * 64 * 4;
      jg_hopper::set_smem(flash_bwd_dkv_wgmma_packed_kernel<D>, BYTES);
      flash_bwd_dkv_wgmma_packed_kernel<D>
          <<<grid, dkv_warpgroups<D>() * 128, BYTES, a.stream>>>(
          q, k, v, dout, lse, delta, static_cast<bf16*>(a.out0),
          static_cast<bf16*>(a.out1), n_seq, a.S, a.H, a.q_sb, a.q_ss,
          a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale,
          a.sp_log2);
    } else {
      constexpr int BYTES = 4 * DqSmem<D, 1>::TILE;
      jg_hopper::set_smem(flash_bwd_dq_wgmma_packed_kernel<D>, BYTES);
      flash_bwd_dq_wgmma_packed_kernel<D><<<grid, 128, BYTES, a.stream>>>(
          q, k, v, dout, lse, delta, static_cast<bf16*>(a.out0), n_seq, a.S,
          a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb,
          a.do_ss, a.sm_scale, a.sp_log2);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// fp32 on FMAs, bf16 on wgmma; the packed tiling where sp_log2 >= 0.
template <int D>
int launch_d(const Args& a, int dtype, bool dkv) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (a.sp_log2 >= 0) {
    if (a.sp_log2 > 5 || a.S > (1 << a.sp_log2)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_packed<D>(a, dtype, dkv);
  }
  if (dtype == 0) return dkv ? launch_dkv_fma<D>(a) : launch_dq_fma<D>(a);
  if (dtype == 1 && dkv) return launch_dkv_wgmma<D>(a);
  if (dtype == 1 && a.q_tile == 64) return launch_dq_wgmma<D, 1>(a);
  if (dtype == 1 && a.q_tile == 128) return launch_dq_wgmma<D, 2>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(const Args& a, int D, int dtype, bool dkv) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 ||
      static_cast<long long>(a.B) * a.H > INT_MAX || (a.S + 63) / 64 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (D) {
    case 8:
      return launch_d<8>(a, dtype, dkv);
    case 16:
      return launch_d<16>(a, dtype, dkv);
    case 32:
      return launch_d<32>(a, dtype, dkv);
    case 64:
      return launch_d<64>(a, dtype, dkv);
    case 80:
      return launch_d<80>(a, dtype, dkv);
    case 96:
      return launch_d<96>(a, dtype, dkv);
    case 128:
      return launch_d<128>(a, dtype, dkv);
    case 160:
      return launch_d<160>(a, dtype, dkv);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). q, k, v, dout: (B, S, H, D) with
// element (b, s, h, d) at b * x_sb + s * x_ss + h * D + d; lse, delta:
// contiguous (B, H, S) fp32; dq (K2) and dk, dv (K3): contiguous
// (B, S, H, D) in the input dtype. dtype: 0 = float32 (FMA kernels),
// 1 = bfloat16 (wgmma kernels; K2 with q_tile = 64 or 128 queries per
// block). sp_log2: -1 for the plain tiling, else the packed tiling with
// 2^sp_log2 >= S rows a sequence (at most 32). Each returns the launch's
// cudaError_t.
extern "C" int jg_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int S, int H, int D,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long do_sb, long long do_ss,
    float sm_scale, int dtype, int q_tile, int sp_log2, void* stream) {
  const Args a{q,    k,     v,     dout,     lse,    delta,
               dq,   nullptr, B,   S,        H,      q_sb,
               q_ss, k_sb,  k_ss,  v_sb,     v_ss,   do_sb,
               do_ss, sm_scale, q_tile, sp_log2,
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, D, dtype, false);
}

extern "C" int jg_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S,
    int H, int D, long long q_sb, long long q_ss, long long k_sb,
    long long k_ss, long long v_sb, long long v_ss, long long do_sb,
    long long do_ss, float sm_scale, int dtype, int sp_log2, void* stream) {
  const Args a{q,    k,    v,    dout, lse,  delta, dk,    dv,
               B,    S,    H,    q_sb, q_ss, k_sb,  k_ss,  v_sb,
               v_ss, do_sb, do_ss, sm_scale, 64, sp_log2,
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, D, dtype, true);
}

extern "C" const char* jg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
