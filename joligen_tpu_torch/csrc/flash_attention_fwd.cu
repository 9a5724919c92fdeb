// Flash-attention forward for Hopper (sm_90a): kernel K1 of the port.
//
// Replaces the Pallas TPU kernel joligen_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _fwd, pallas_call at :84). Same function: non-causal softmax
// attention with an online softmax over key tiles -- fp32 running max, running
// sum and accumulator, keys at or past S masked to -1e30 -- writing O in the
// input dtype and the per-row logsumexp m + log(l) in fp32 (kept for the
// backward kernels of the training slice).
//
// Design. The TPU kernel keeps the whole per-head K/V panel resident in VMEM.
// A Hopper block has at most 227 KB of shared memory and runs in parallel with
// the others in no order, so here each thread block owns one
// (batch*head, 64-query tile) cell of a 2-D grid and streams 64-key K/V tiles
// through shared memory in a loop, converting them to fp32 once on load.
// Four threads share a query row: each scores 16 keys of the tile against the
// row (q kept in registers, pre-scaled by sm_scale as in the TPU kernel), the
// row max and sum are combined with warp shuffles, and each thread accumulates
// a quarter of the D output columns, taking the probabilities of the other
// three threads by shuffle. Ragged S is masked in the kernel: no host-side
// padding. Inputs are (B, S, H, D) with the last two dims contiguous and
// arbitrary batch/sequence strides, so the q/k/v column slices of a fused qkv
// projection are read in place.
//
// Bound. At the main path's shapes the work is tiny: 128 px, batch 1 is
// B*H = 16, S = 256, D = 32 in bf16, 134 MFLOP and 1.05 MB, about 0.3 us on
// an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) -- memory-bound on paper and
// launch-bound in practice. At 256 px, batch 8 (S = 1024, B*H = 128) it is
// 17.2 GFLOP against 33.5 MB: compute-bound. This first kernel computes with
// fp32 FMAs on the CUDA cores (67 TFLOP/s peak), not on the tensor cores;
// wgmma and TMA are the next step for the compute-bound shapes.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int THREADS_PER_ROW = 4;
constexpr int THREADS = BLOCK_Q * THREADS_PER_ROW;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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
  __shared__ float sK[BLOCK_K][D + 1];
  __shared__ float sV[BLOCK_K][D];

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

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int H, long long q_sb, long long q_ss, long long k_sb,
           long long k_ss, long long v_sb, long long v_ss, float sm_scale,
           cudaStream_t stream) {
  const dim3 grid(B * H, (S + BLOCK_Q - 1) / BLOCK_Q);
  flash_fwd_kernel<D, T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int S, int H, int D, long long q_sb,
               long long q_ss, long long k_sb, long long k_ss, long long v_sb,
               long long v_ss, float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<16, T>(q, k, v, o, lse, B, S, H, q_sb, q_ss, k_sb, k_ss,
                           v_sb, v_ss, sm_scale, stream);
    case 32:
      return launch<32, T>(q, k, v, o, lse, B, S, H, q_sb, q_ss, k_sb, k_ss,
                           v_sb, v_ss, sm_scale, stream);
    case 64:
      return launch<64, T>(q, k, v, o, lse, B, S, H, q_sb, q_ss, k_sb, k_ss,
                           v_sb, v_ss, sm_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, k, v: (B, S, H, D) with
// element (b, s, h, d) at b * x_sb + s * x_ss + h * D + d; o: contiguous
// (B, S, H, D) in the input dtype; lse: contiguous (B, H, S) fp32.
// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int jg_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int S, int H, int D, long long q_sb, long long q_ss, long long k_sb,
    long long k_ss, long long v_sb, long long v_ss, float sm_scale, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 ||
      static_cast<long long>(B) * H > INT_MAX ||
      (S + BLOCK_Q - 1) / BLOCK_Q > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_d<float>(q, k, v, o, lse, B, S, H, D, q_sb, q_ss, k_sb,
                             k_ss, v_sb, v_ss, sm_scale, st);
  }
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, B, S, H, D, q_sb, q_ss,
                                     k_sb, k_ss, v_sb, v_ss, sm_scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* jg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
