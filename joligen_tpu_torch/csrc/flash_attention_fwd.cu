// Flash-attention forward for Hopper (sm_90a): kernel K1 of the port.
//
// Replaces the Pallas TPU kernel joligen_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _fwd, pallas_call at :84). Same function: non-causal softmax
// attention with an online softmax over key tiles -- fp32 running max, running
// sum and accumulator, keys at or past S masked to -1e30 -- writing O in the
// input dtype and the per-row logsumexp m + log(l) in fp32, contiguous
// (B, H, S), which the backward kernels K2 and K3 read.
//
// Two routes, chosen by dtype in jg_flash_attention_fwd:
//
// bf16 -- the tensor cores (flash_fwd_wgmma_kernel). The TPU kernel keeps a
// head's whole K/V panel in VMEM; here each block owns WG x 64 queries of one
// batch*head (WG = 1 or 2 warpgroups of 128 threads, sharing each K/V tile)
// and streams 64-key K/V tiles through a 2-stage ring in shared memory, bf16
// as loaded (16-byte cp.async, zero fill past S, the next tile's copy in
// flight during this tile's math). Per tile and warpgroup: S = Q.K^T as D/16
// wgmma m64n64k16 with Q and K read K-major from shared memory; the online
// softmax in registers on the accumulator layout (a row lives in 4 lanes,
// reduced by two xor shuffles), in the log2 domain, with the rescale of the
// O accumulator; then O += P.V as 4 wgmma m64nDk16 with P converted to bf16
// in registers as the A operand and V read MN-major (transposed) from
// shared memory. l is summed from the fp32 probabilities. Queries past S are
// computed on zero rows and not stored. Tiles and descriptors:
// hopper_wgmma.cuh.
//
// fp32 -- the CUDA cores (flash_fwd_kernel, T = float), kept so that fp32
// callers stay within 1e-4 of the plain version (TF32 would not): a block
// owns (batch*head, 64 queries), converts each K/V tile to fp32 in shared
// memory, four threads share a query row and combine by warp shuffles.
//
// Head dims 8, 16, 32, 64, 80, 96, 128 and 160. At D = 8 the bf16 route
// zero-pads Q and K to 16 columns in shared memory for Q.K^T (wgmma's depth
// is 16) and runs P.V as m64n8k16; sm_scale stays the caller's (1/sqrt(8)
// by default). At D = 96 (the token motion modules of vit_vid, 768 channels
// over 8 heads) Q.K^T is 6 k16 steps and P.V is m64n96k16, 48 fp32
// accumulators a thread; each 64 x 96 tile is 12 KiB, so the plain tiling's
// 4 or 5 tiles take the opt-in dynamic shared memory past 48 KiB, and the
// fp32 route's K/V tiles (49,408 bytes) live in dynamic shared memory too.
// D = 80 (JiT-H's blocks, 1280 channels over 16 heads), 128 (JiT-L's
// motion module, MAT's motion module at 4 heads) and 160 (JiT-H's motion
// module) follow the same scheme: Q.K^T is 5, 8 or 10 k16 steps, P.V is
// m64n80k16, m64n128k16 or m64n160k16. At D = 160 the accumulator is 80
// fp32 registers a thread beside the 32 scores and 16 packed P values, one
// warpgroup's share of the register file; a 64 x 160 tile is 20 KiB, so
// two warpgroups' plain tiling takes 120 KiB and the packed tiling's three
// tiles 60 KiB, both through set_smem.
//
// Short sequences (S <= 32: the motion modules of unet_vid attend over 6 or
// 8 frames) take the packed tiling, in both routes: a block's 64 rows hold
// 64 / SP whole (batch, head) sequences, each padded to SP = 2^sp_log2 >= S
// rows, and a key counts for a query only in the query's own sequence and
// below S, which makes the scores block-diagonal. One tile of Q, K and V,
// so one pass of the softmax and no key loop (flash_fwd_wgmma_packed_kernel,
// flash_fwd_packed_kernel). The plain tiling would give each sequence a
// block of 64 query rows, S of them used. The wrapper picks the tiling from
// S.
//
// Both routes read (B, S, H, D) inputs with the last two dims contiguous and
// arbitrary batch/sequence strides, so the q/k/v column slices of a fused
// qkv projection are read in place (the bf16 route needs 16-byte aligned
// pointers and strides; the wrapper checks).
//
// Bound, bf16 at D = 32. At 256 px, batch 8 ((B*H, S) = (128, 1024)) one call
// is 17.2 GFLOP against 33.5 MB: 0.0174 ms on the tensor cores (989 TFLOP/s)
// against 0.010 ms of memory traffic, so compute-bound on paper. But its
// 134 M exponentials run on the special-function units at 16 per clock per
// SM, about 0.03 ms on 132 SMs: a practical floor about 2x the tensor-core
// bound. At the 128 px request (16, 256) the work is 134 MFLOP and 1 MB, and
// 64 blocks cannot fill 132 SMs: launch- and latency-bound.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_wgmma.cuh"

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int THREADS_PER_ROW = 4;
constexpr int THREADS = BLOCK_Q * THREADS_PER_ROW;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// ---- fp32 route: FMAs on the CUDA cores -----------------------------------

// The fp32 kernels' K and V tiles, in dynamic shared memory: at D = 96 the
// two are 49,408 bytes (at 160, 82,176), past the 48 KiB of static shared
// memory, so the launch opts in (fma_smem_bytes, set_smem).
template <int D>
constexpr int fma_smem_bytes() {
  return BLOCK_K * (2 * D + 1) * 4;
}

template <int D>
__device__ __forceinline__ void fma_tiles(float (*&sK)[D + 1],
                                          float (*&sV)[D]) {
  extern __shared__ __align__(16) float fsmem[];
  sK = reinterpret_cast<float(*)[D + 1]>(fsmem);
  sV = reinterpret_cast<float(*)[D]>(fsmem + BLOCK_K * (D + 1));
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H,
                 long long q_sb, long long q_ss, long long k_sb,
                 long long k_ss, long long v_sb, long long v_ss,
                 float sm_scale) {
  static_assert(D % THREADS_PER_ROW == 0, "D must split over a row's threads");
  static_assert(32 % THREADS_PER_ROW == 0, "a row's threads share a warp");
  constexpr int KPT = BLOCK_K / THREADS_PER_ROW;  // keys scored per thread
  constexpr int DPT = D / THREADS_PER_ROW;        // output columns per thread

  // K rows padded by one float: the four threads of a row read four
  // consecutive keys at the same column, which then fall in distinct banks.
  float(*sK)[D + 1];
  float(*sV)[D];
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

  const T* kb = k + b * k_sb + static_cast<long long>(h) * D;
  const T* vb = v + b * v_sb + static_cast<long long>(h) * D;

  float qr[D];
  {
    const T* qp = q + b * q_sb + static_cast<long long>(row_ok ? qi : 0) * q_ss +
                  static_cast<long long>(h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = row_ok ? to_float(qp[d]) * sm_scale : 0.f;
    }
  }

  float acc[DPT];
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) acc[dd] = 0.f;
  float m_i = NEG_INF;
  float l_i = 0.f;

  for (int k0 = 0; k0 < S; k0 += BLOCK_K) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < BLOCK_K * D; idx += THREADS) {
      const int j = idx / D;
      const int d = idx % D;
      const int kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < S) {
        kv = to_float(kb[static_cast<long long>(kj) * k_ss + d]);
        vv = to_float(vb[static_cast<long long>(kj) * v_ss + d]);
      }
      sK[j][d] = kv;
      sV[j][d] = vv;
    }
    __syncthreads();

    // scores of this thread's keys j = jj * THREADS_PER_ROW + part
    float s[KPT];
    float m_tile = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = jj * THREADS_PER_ROW + part;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], sK[j][d], dot);
      s[jj] = (k0 + j < S) ? dot : NEG_INF;
      m_tile = fmaxf(m_tile, s[jj]);
    }
#pragma unroll
    for (int off = 1; off < THREADS_PER_ROW; off <<= 1) {
      m_tile = fmaxf(m_tile, __shfl_xor_sync(FULL_MASK, m_tile, off));
    }
    const float m_new = fmaxf(m_i, m_tile);
    float l_tile = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      s[jj] = expf(s[jj] - m_new);
      l_tile += s[jj];
    }
#pragma unroll
    for (int off = 1; off < THREADS_PER_ROW; off <<= 1) {
      l_tile += __shfl_xor_sync(FULL_MASK, l_tile, off);
    }
    const float corr = expf(m_i - m_new);
    l_i = l_i * corr + l_tile;
    m_i = m_new;

#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) acc[dd] *= corr;
#pragma unroll
    for (int j = 0; j < BLOCK_K; ++j) {
      // key j's probability lives in slot j / THREADS_PER_ROW of the row's
      // thread j % THREADS_PER_ROW
      const float p = __shfl_sync(FULL_MASK, s[j / THREADS_PER_ROW],
                                  row_lane0 + j % THREADS_PER_ROW);
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        acc[dd] = fmaf(p, sV[j][part * DPT + dd], acc[dd]);
      }
    }
  }

  if (row_ok) {
    const float l_safe = fmaxf(l_i, 1e-30f);
    T* op = o + ((static_cast<long long>(b) * S + qi) * H + h) * D + part * DPT;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) op[dd] = from_float<T>(acc[dd] / l_safe);
    if (part == 0) lse[static_cast<long long>(bh) * S + qi] = m_i + logf(l_safe);
  }
}

// The packed tiling in fp32: a block owns the 64 packed rows of sequences
// n0 .. n0 + 64 / SP - 1 (hopper_wgmma.cuh), as queries and as keys; four
// threads share a query row, as in flash_fwd_kernel, and a key counts only
// in the row's own sequence and below S.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_packed_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int n_seq, int S, int H,
                        long long q_sb, long long q_ss, long long k_sb,
                        long long k_ss, long long v_sb, long long v_ss,
                        float sm_scale, int sp_log2) {
  constexpr int KPT = BLOCK_K / THREADS_PER_ROW;
  constexpr int DPT = D / THREADS_PER_ROW;
  float(*sK)[D + 1];
  float(*sV)[D];
  fma_tiles<D>(sK, sV);

  const int n0 = blockIdx.x << (6 - sp_log2);
  const int tid = threadIdx.x;
  const int row = tid / THREADS_PER_ROW;
  const int part = tid % THREADS_PER_ROW;
  const int row_lane0 = (tid & 31) & ~(THREADS_PER_ROW - 1);
  auto locate = [&](int r, int& b, int& h, int& pos) {
    return jg_hopper::locate_packed(r, n0, sp_log2, S, H, n_seq, b, h, pos);
  };

  for (int idx = tid; idx < BLOCK_K * D; idx += THREADS) {
    const int j = idx / D;
    const int d = idx % D;
    int b, h, pos;
    const bool ok = locate(j, b, h, pos);
    const long long off = static_cast<long long>(h) * D + d;
    sK[j][d] = ok ? k[b * k_sb + pos * k_ss + off] : 0.f;
    sV[j][d] = ok ? v[b * v_sb + pos * v_ss + off] : 0.f;
  }
  int b, h, pos;
  const bool row_ok = locate(row, b, h, pos);
  float qr[D];
  {
    const float* qp = q + b * q_sb + pos * q_ss + static_cast<long long>(h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = row_ok ? qp[d] * sm_scale : 0.f;
  }
  __syncthreads();

  float s[KPT];
  float m = NEG_INF;
#pragma unroll
  for (int jj = 0; jj < KPT; ++jj) {
    const int j = jj * THREADS_PER_ROW + part;
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) dot = fmaf(qr[d], sK[j][d], dot);
    s[jj] = jg_hopper::packed_pair(row, j, sp_log2, S) ? dot : NEG_INF;
    m = fmaxf(m, s[jj]);
  }
#pragma unroll
  for (int off = 1; off < THREADS_PER_ROW; off <<= 1) {
    m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, off));
  }
  float l = 0.f;
#pragma unroll
  for (int jj = 0; jj < KPT; ++jj) {
    s[jj] = expf(s[jj] - m);
    l += s[jj];
  }
#pragma unroll
  for (int off = 1; off < THREADS_PER_ROW; off <<= 1) {
    l += __shfl_xor_sync(FULL_MASK, l, off);
  }
  float acc[DPT];
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) acc[dd] = 0.f;
#pragma unroll
  for (int j = 0; j < BLOCK_K; ++j) {
    const float p = __shfl_sync(FULL_MASK, s[j / THREADS_PER_ROW],
                                row_lane0 + j % THREADS_PER_ROW);
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      acc[dd] = fmaf(p, sV[j][part * DPT + dd], acc[dd]);
    }
  }

  if (row_ok) {
    const float l_safe = fmaxf(l, 1e-30f);
    float* op =
        o + ((static_cast<long long>(b) * S + pos) * H + h) * D + part * DPT;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) op[dd] = acc[dd] / l_safe;
    if (part == 0) {
      lse[(static_cast<long long>(b) * H + h) * S + pos] = m + logf(l_safe);
    }
  }
}

// ---- bf16 route: wgmma on the tensor cores --------------------------------

using bf16 = __nv_bfloat16;

// Shared memory of a block: WG Q tiles, then 2 K and 2 V stages; every tile
// 64 rows x DP (D, or 16 at D = 8) in the core-matrix layout of
// hopper_wgmma.cuh.
template <int D, int WG>
struct FwdSmem {
  static constexpr int DP = D < 16 ? 16 : D;
  static constexpr int TILE = 64 * DP * 2;
  static constexpr int K = WG * TILE;
  static constexpr int V = K + 2 * TILE;
  static constexpr int BYTES = V + 2 * TILE;
};

template <int D, int WG>
__global__ void __launch_bounds__(WG * 128)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int S, int H, long long q_sb,
                       long long q_ss, long long k_sb, long long k_ss,
                       long long v_sb, long long v_ss, float scale_log2) {
  using namespace jg_hopper;
  using L = FwdSmem<D, WG>;
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
  const bf16* qb = q + b * q_sb + static_cast<long long>(h) * D;
  const bf16* kb = k + b * k_sb + static_cast<long long>(h) * D;
  const bf16* vb = v + b * v_sb + static_cast<long long>(h) * D;

  // the Q tiles and the first K/V stage: one cp.async group
#pragma unroll
  for (int w = 0; w < WG; ++w) {
    load_rows<D, NT>(base + w * L::TILE, qb, q_ss, q0 + 64 * w, S);
  }
  load_rows<D, NT>(base + L::K, kb, k_ss, 0, S);
  load_rows<D, NT>(base + L::V, vb, v_ss, 0, S);
  cp_async_commit();
  zero_pad_tiles<D, NT>(smem, WG + 4, L::TILE);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // this thread's two rows (16 * warp + lane / 4, and 8 further) of the
  // warpgroup's 64; m in the log2 domain
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  const uint32_t sq = base + wg * L::TILE;
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

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < L::DP / 16; ++t) {
      wgmma_ss_n64(s, desc_k_major<64>(sq, t), desc_k_major<64>(sk, t),
                   t > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // online softmax; register i holds row (i / 2) % 2 and key
    // 8 * (i / 4) + 2 * (lane % 4) + i % 2 of the tile
    const int key0 = it * BLOCK_K + 2 * (lane & 3);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x =
          key0 + 8 * (i >> 2) + (i & 1) < S ? s[i] * scale_log2 : NEG_INF;
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
      ls[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ls[r] += __shfl_xor_sync(FULL_MASK, ls[r], 1);
      ls[r] += __shfl_xor_sync(FULL_MASK, ls[r], 2);
      l[r] = l[r] * corr[r] + ls[r];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    uint32_t pa[4][4];
    acc_to_a_frags(s, pa);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) wgmma_rs<D>(acc, pa[t], desc_mn_major<64>(sv, t));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warpgroup is done with this stage
  }

  const int row0 = q0 + 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= S) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / l_safe;
    bf16* op = o + ((static_cast<long long>(b) * S + qi) * H + h) * D +
               2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
    if ((lane & 3) == 0) {
      lse[static_cast<long long>(bh) * S + qi] = (m[r] + log2f(l_safe)) * LN2;
    }
  }
}

// The packed tiling in bf16: one warpgroup owns the 64 packed rows of
// sequences n0 .. n0 + 64 / SP - 1, as queries and as keys (Q, K and V
// tiles loaded once); S = Q.K^T, the block-diagonal mask, one softmax pass
// in registers, O = P.V, as flash_fwd_wgmma_kernel does per key tile.
template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_wgmma_packed_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              bf16* __restrict__ o, float* __restrict__ lse,
                              int n_seq, int S, int H, long long q_sb,
                              long long q_ss, long long k_sb, long long k_ss,
                              long long v_sb, long long v_ss,
                              float scale_log2, int sp_log2) {
  using namespace jg_hopper;
  using L = FwdSmem<D, 1>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = smem_u32(smem);
  const uint32_t sk = sq + L::TILE;
  const uint32_t sv = sq + 2 * L::TILE;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = blockIdx.x << (6 - sp_log2);

  load_rows_packed<D, 128>(sq, q, q_sb, q_ss, n0, n_seq, H, S, sp_log2);
  load_rows_packed<D, 128>(sk, k, k_sb, k_ss, n0, n_seq, H, S, sp_log2);
  load_rows_packed<D, 128>(sv, v, v_sb, v_ss, n0, n_seq, H, S, sp_log2);
  cp_async_commit();
  zero_pad_tiles<D, 128>(smem, 3, L::TILE);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float s[32];
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < L::DP / 16; ++t) {
    wgmma_ss_n64(s, desc_k_major<64>(sq, t), desc_k_major<64>(sk, t), t > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  // register i holds row 16 * warp + lane / 4 + 8 * ((i / 2) % 2) and key
  // 8 * (i / 4) + 2 * (lane % 4) + i % 2 of the tile
  const int row0 = 16 * warp + (lane >> 2);
  float m[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const int key = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    s[i] = packed_pair(row0 + 8 * r, key, sp_log2, S) ? s[i] * scale_log2
                                                      : NEG_INF;
    m[r] = fmaxf(m[r], s[i]);
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(FULL_MASK, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(FULL_MASK, m[r], 2));
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL_MASK, l[r], 1);
    l[r] += __shfl_xor_sync(FULL_MASK, l[r], 2);
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t pa[4][4];
  acc_to_a_frags(s, pa);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 4; ++t) wgmma_rs<D>(acc, pa[t], desc_mn_major<64>(sv, t));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int b, h, pos;
    if (!locate_packed(row0 + 8 * r, n0, sp_log2, S, H, n_seq, b, h, pos)) {
      continue;
    }
    const float l_safe = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / l_safe;
    bf16* op = o + ((static_cast<long long>(b) * S + pos) * H + h) * D +
               2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
    if ((lane & 3) == 0) {
      lse[(static_cast<long long>(b) * H + h) * S + pos] =
          (m[r] + log2f(l_safe)) * LN2;
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  int B, S, H;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;
  float sm_scale;
  cudaStream_t stream;
};

template <int D>
int launch_fma(const Args& a) {
  const dim3 grid(a.B * a.H, (a.S + BLOCK_Q - 1) / BLOCK_Q);
  auto kernel = flash_fwd_kernel<D, float>;
  jg_hopper::set_smem(kernel, fma_smem_bytes<D>());
  kernel<<<grid, THREADS, fma_smem_bytes<D>(), a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o),
      static_cast<float*>(a.lse), a.S, a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss,
      a.v_sb, a.v_ss, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int WG>
int launch_wgmma(const Args& a) {
  using L = FwdSmem<D, WG>;
  auto kernel = flash_fwd_wgmma_kernel<D, WG>;
  jg_hopper::set_smem(kernel, L::BYTES);
  const dim3 grid(a.B * a.H, (a.S + 64 * WG - 1) / (64 * WG));
  kernel<<<grid, WG * 128, L::BYTES, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o),
      static_cast<float*>(a.lse), a.S, a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss,
      a.v_sb, a.v_ss, a.sm_scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// the packed tiling: 64 / 2^sp_log2 sequences a block
template <int D>
int launch_packed(const Args& a, int dtype, int sp_log2) {
  const int n_seq = a.B * a.H;
  const int per_block = 64 >> sp_log2;
  const dim3 grid((n_seq + per_block - 1) / per_block);
  if (dtype == 0) {
    jg_hopper::set_smem(flash_fwd_packed_kernel<D>, fma_smem_bytes<D>());
    flash_fwd_packed_kernel<D><<<grid, THREADS, fma_smem_bytes<D>(),
                                 a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.o),
        static_cast<float*>(a.lse), n_seq, a.S, a.H, a.q_sb, a.q_ss, a.k_sb,
        a.k_ss, a.v_sb, a.v_ss, a.sm_scale, sp_log2);
  } else {
    constexpr int BYTES = 3 * FwdSmem<D, 1>::TILE;
    jg_hopper::set_smem(flash_fwd_wgmma_packed_kernel<D>, BYTES);
    flash_fwd_wgmma_packed_kernel<D><<<grid, 128, BYTES, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o),
        static_cast<float*>(a.lse), n_seq, a.S, a.H, a.q_sb, a.q_ss, a.k_sb,
        a.k_ss, a.v_sb, a.v_ss, a.sm_scale * LOG2E, sp_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const Args& a, int dtype, int q_tile, int sp_log2) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (sp_log2 >= 0) {
    if (sp_log2 > 5 || a.S > (1 << sp_log2)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_packed<D>(a, dtype, sp_log2);
  }
  if (dtype == 0) return launch_fma<D>(a);
  if (q_tile == 64) return launch_wgmma<D, 1>(a);
  if (q_tile == 128) return launch_wgmma<D, 2>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, k, v: (B, S, H, D) with
// element (b, s, h, d) at b * x_sb + s * x_ss + h * D + d; o: contiguous
// (B, S, H, D) in the input dtype; lse: contiguous (B, H, S) fp32.
// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma kernel, q_tile = 64
// or 128 queries per block). sp_log2: -1 for the plain tiling, else the
// packed tiling with 2^sp_log2 >= S rows a sequence (at most 32). Returns
// the launch's cudaError_t.
extern "C" int jg_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int S, int H, int D, long long q_sb, long long q_ss, long long k_sb,
    long long k_ss, long long v_sb, long long v_ss, float sm_scale, int dtype,
    int q_tile, int sp_log2, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 ||
      static_cast<long long>(B) * H > INT_MAX ||
      (S + BLOCK_Q - 1) / BLOCK_Q > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,    k,    v,    o,    lse,  B,        S,
               H,    q_sb, q_ss, k_sb, k_ss, v_sb,     v_ss,
               sm_scale, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 8:
      return launch_d<8>(a, dtype, q_tile, sp_log2);
    case 16:
      return launch_d<16>(a, dtype, q_tile, sp_log2);
    case 32:
      return launch_d<32>(a, dtype, q_tile, sp_log2);
    case 64:
      return launch_d<64>(a, dtype, q_tile, sp_log2);
    case 80:
      return launch_d<80>(a, dtype, q_tile, sp_log2);
    case 96:
      return launch_d<96>(a, dtype, q_tile, sp_log2);
    case 128:
      return launch_d<128>(a, dtype, q_tile, sp_log2);
    case 160:
      return launch_d<160>(a, dtype, q_tile, sp_log2);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* jg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
