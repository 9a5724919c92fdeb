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
// Design. The TPU kernels keep a head's whole K/V (K2) or Q/dO (K3) panel
// resident in VMEM and run their grid in order. A Hopper block has at most
// 227 KB of shared memory and blocks run in parallel in no order, so each
// block owns one cell of a 2-D grid -- (batch*head, 64-query tile) for K2,
// (batch*head, 64-key tile) for K3 -- and streams 64-row tiles of the other
// side through shared memory in a loop, converted to fp32 once on load.
// Writing the backward as two kernels, as the TPU does, keeps every output
// tile owned by one block: no atomics. Four threads share a row of the
// block's own tile (its q and dO rows, or its k and v rows, in registers):
// each scores 16 rows of the streamed tile, and each accumulates a quarter of
// the D output columns, taking the other three threads' P and dS by warp
// shuffle (as K1 does). Ragged S is masked in the kernels: no host-side
// padding, nothing read past S. Inputs are (B, S, H, D) with the last two
// dims contiguous and arbitrary batch/sequence strides, so the q/k/v column
// slices of a fused qkv projection are read in place.
//
// Bound. At the training path's shape (B, S, H, D) = (8, 256, 16, 32) bf16,
// K2 moves ~10.7 MB and does 6*B*H*S^2*D = 1.61 GFLOP, K3 ~12.8 MB and
// 2.15 GFLOP: memory-bound on paper (~0.003-0.004 ms at 3.35 TB/s). At
// 256 px, batch 8 (S = 1024) both are compute-bound. These first kernels
// compute with fp32 FMAs on the CUDA cores (67 TFLOP/s peak), not on the
// tensor cores; mma/wgmma and TMA are the next step.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_Q = 64;  // K2: queries per block; K3: queries per chunk
constexpr int BLOCK_K = 64;  // K3: keys per block; K2: keys per chunk
constexpr int THREADS_PER_ROW = 4;
constexpr int THREADS = 64 * THREADS_PER_ROW;
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

// K2: one block per (batch*head, 64-query tile); K and V stream by.
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
  __shared__ float sK[BLOCK_K][D + 1];
  __shared__ float sV[BLOCK_K][D + 1];

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

// K3: one block per (batch*head, 64-key tile); Q, dO, lse, delta stream by.
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

  __shared__ float sQ[BLOCK_Q][D + 1];
  __shared__ float sdO[BLOCK_Q][D + 1];
  __shared__ float sL[BLOCK_Q];
  __shared__ float sDelta[BLOCK_Q];

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

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;
  int B, S, H;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss;
  float sm_scale;
  cudaStream_t stream;
};

template <int D, typename T>
int launch(const Args& a, bool dkv) {
  const dim3 grid(a.B * a.H, (a.S + 63) / 64);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  if (dkv) {
    flash_bwd_dkv_kernel<D, T><<<grid, THREADS, 0, a.stream>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(a.out0),
        static_cast<T*>(a.out1), a.S, a.H, a.q_sb, a.q_ss, a.k_sb, a.k_ss,
        a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale);
  } else {
    flash_bwd_dq_kernel<D, T><<<grid, THREADS, 0, a.stream>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(a.out0), a.S, a.H, a.q_sb,
        a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.do_sb, a.do_ss, a.sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Args& a, int D, bool dkv) {
  switch (D) {
    case 16:
      return launch<16, T>(a, dkv);
    case 32:
      return launch<32, T>(a, dkv);
    case 64:
      return launch<64, T>(a, dkv);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const Args& a, int D, int dtype, bool dkv) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 ||
      static_cast<long long>(a.B) * a.H > INT_MAX || (a.S + 63) / 64 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return dispatch_d<float>(a, D, dkv);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(a, D, dkv);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points (loaded with ctypes). q, k, v, dout: (B, S, H, D) with
// element (b, s, h, d) at b * x_sb + s * x_ss + h * D + d; lse, delta:
// contiguous (B, H, S) fp32; dq (K2) and dk, dv (K3): contiguous
// (B, S, H, D) in the input dtype. dtype: 0 = float32, 1 = bfloat16.
// Each returns the launch's cudaError_t.
extern "C" int jg_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int S, int H, int D,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long do_sb, long long do_ss,
    float sm_scale, int dtype, void* stream) {
  const Args a{q,    k,    v,    dout, lse,  delta, dq,    nullptr,
               B,    S,    H,    q_sb, q_ss, k_sb,  k_ss,  v_sb,
               v_ss, do_sb, do_ss, sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch(a, D, dtype, false);
}

extern "C" int jg_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S,
    int H, int D, long long q_sb, long long q_ss, long long k_sb,
    long long k_ss, long long v_sb, long long v_ss, long long do_sb,
    long long do_ss, float sm_scale, int dtype, void* stream) {
  const Args a{q,    k,    v,    dout, lse,  delta, dk,    dv,
               B,    S,    H,    q_sb, q_ss, k_sb,  k_ss,  v_sb,
               v_ss, do_sb, do_ss, sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch(a, D, dtype, true);
}

extern "C" const char* jg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
