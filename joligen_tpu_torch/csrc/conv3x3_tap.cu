// 3x3 tap convolution for Hopper (sm_90a): kernels P1 and P2 of the port.
//
// Replaces the Pallas TPU kernels of tools/fused_resblock_probe.py:
//   P1 _conv_kernel    (wrapper conv_pallas,    pallas_call at :98)
//   P2 _conv_kernel_v2 (wrapper conv_pallas_v2, pallas_call at :173)
// Same function for both: y[b,h,w,o] = sum_dy sum_dx sum_c
// xpad[b,h+dy,w+dx,c] * w[dy,dx,c,o] with SAME zero padding, NHWC input,
// fp32 accumulation, one rounding to the input dtype at the end. The two
// differ in the order of the reduction within each chunk of C, as the TPU
// kernels do:
//   P1 takes the taps dy outer and dx inner (the TPU's 9 dots of depth C);
//   P2 takes dx outer and a panel of (dy, c) inner (the TPU's 3 dots of
//      depth 3C against the weight repacked to (dx, 3C, Co) by the wrapper).
//
// Design. The TPU kernel keeps a whole 128x128x128 image in VMEM and walks
// row strips in order. A Hopper block has at most 227 KB of shared memory (a
// full-C halo of an 8x128 strip alone is 333 KB in bf16), and blocks run in
// parallel in no order. So each block owns an output tile of TH rows x TW
// columns x 64 output channels and loops over C in chunks of CK = 8 channels:
// it stages the chunk's input halo, (TH+2) x (TW+2) x CK, and the chunk's
// 9 x CK x 64 tap weights in shared memory as fp32, and every thread keeps an
// 8-pixel x 8-channel fp32 accumulator tile in registers. The halo is filled
// by predicated loads (zero outside the image): no padded copy of x is made
// and no row ever wraps into its neighbour, which the TPU kernel guards with
// a column mask after rolling its product. Ragged H, W and Co are predicated.
// P1's thread owns 8 consecutive columns of one row, so an input row segment
// of 10 values serves the three dx taps; P2's thread owns 8 consecutive rows
// of one column, so a column segment of 10 values serves the three dy taps of
// its (dy, c) panel. P2's TH is the TPU's strip height s2 (8, 16, 32).
//
// Bound. At the probe's shape, (16,128,128,128) bf16, the conv is 77.3 GFLOP
// against 134.5 MB: at the H100 SXM data sheet's rates (989 TFLOP/s bf16 on
// the tensor cores, 3.35 TB/s, at its 700 W limit) the operations bound it at
// 0.078 ms. This first kernel computes with fp32 FMAs on the CUDA cores
// (67 TFLOP/s on the data sheet, 1.15 ms for this work); mma/wgmma on the
// tensor cores and TMA staging are later work.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CK = 8;         // input channels staged per chunk
constexpr int TCO = 64;       // output channels per block
constexpr int PT = 8;         // pixels per thread
constexpr int OT = 8;         // output channels per thread
constexpr int CO_GROUPS = TCO / OT;

// 8 consecutive elements (16-byte aligned) to fp32, and back
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// x: (B, H, W, C) NHWC; wt: (9, C, Co) with tap t at wt[t] (P1: t = 3*dy+dx
// from HWIO; P2: t = 3*dx+dy, the wrapper's (dx, 3C, Co) repack); y: (B, H, W,
// Co). C % CK == 0 and Co % OT == 0 (checked by the wrapper).
template <typename T, int TH, int TW, bool V2>
__global__ void __launch_bounds__(TH * TW / PT * CO_GROUPS, 2)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ wt,
               T* __restrict__ y, int H, int W, int C, int Co, int co_tiles) {
  constexpr int NT = TH * TW / PT * CO_GROUPS;
  constexpr int HR = TH + 2;  // halo rows
  constexpr int HC = TW + 2;  // halo columns
  static_assert(V2 ? TH % PT == 0 : TW % PT == 0, "tile must split in PT");

  __shared__ __align__(16) float sIn[CK][HR][HC];
  __shared__ __align__(16) float sW[9][CK][TCO];

  const int tid = threadIdx.x;
  const int b = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * TCO;
  const int h0 = blockIdx.y * TH;
  const int w0 = blockIdx.x * TW;
  const int cog = tid % CO_GROUPS;
  const int pg = tid / CO_GROUPS;
  // this thread's first output pixel in the tile, and its 8-channel group
  const int pr = V2 ? (pg / TW) * PT : pg / (TW / PT);
  const int pc = V2 ? pg % TW : (pg % (TW / PT)) * PT;
  const bool co_ok = co0 + cog * OT < Co;

  const T* xb = x + static_cast<long long>(b) * H * W * C;

  float acc[PT][OT];
#pragma unroll
  for (int p = 0; p < PT; ++p)
#pragma unroll
    for (int o = 0; o < OT; ++o) acc[p][o] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();  // the previous chunk is consumed
    // input halo, one pixel's CK channels (16-byte aligned) per step
    for (int i = tid; i < HR * HC; i += NT) {
      const int r = i / HC;
      const int col = i % HC;
      const int h = h0 + r - 1;
      const int w = w0 + col - 1;
      float v[CK];
      if (h >= 0 && h < H && w >= 0 && w < W) {
        load8(xb + (static_cast<long long>(h) * W + w) * C + c0, v);
      } else {
#pragma unroll
        for (int k = 0; k < CK; ++k) v[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < CK; ++k) sIn[k][r][col] = v[k];
    }
    // tap weights, 8 output channels per step
    for (int i = tid; i < 9 * CK * CO_GROUPS; i += NT) {
      const int g = i % CO_GROUPS;
      const int tc = i / CO_GROUPS;  // t * CK + cl
      const int t = tc / CK;
      const int cl = tc % CK;
      float v[OT];
      if (co0 + g * OT < Co) {
        load8(wt + (static_cast<long long>(t) * C + c0 + cl) * Co + co0 + g * OT, v);
      } else {
#pragma unroll
        for (int o = 0; o < OT; ++o) v[o] = 0.f;
      }
      store8(&sW[t][cl][g * OT], v);
    }
    __syncthreads();

    // One channel cl of the chunk against the three taps sharing the
    // thread's input segment: P1 a = dy, s = dx (tap 3*dy+dx); P2 a = dx,
    // s = dy (tap 3*dx+dy of the repacked weight).
    auto taps = [&](int cl, int a) {
      float xv[PT + 2];
#pragma unroll
      for (int i = 0; i < PT + 2; ++i) {
        xv[i] = V2 ? sIn[cl][pr + i][pc + a] : sIn[cl][pr + a][pc + i];
      }
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const float4 w_lo = *reinterpret_cast<const float4*>(&sW[3 * a + s][cl][cog * OT]);
        const float4 w_hi = *reinterpret_cast<const float4*>(&sW[3 * a + s][cl][cog * OT + 4]);
        const float wv[OT] = {w_lo.x, w_lo.y, w_lo.z, w_lo.w,
                              w_hi.x, w_hi.y, w_hi.z, w_hi.w};
#pragma unroll
        for (int p = 0; p < PT; ++p)
#pragma unroll
          for (int o = 0; o < OT; ++o) acc[p][o] = fmaf(xv[p + s], wv[o], acc[p][o]);
      }
    };
    if (V2) {  // dx outer, the (dy, c) panel inner
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll 2
        for (int cl = 0; cl < CK; ++cl) taps(cl, a);
    } else {   // per channel, dy outer and dx inner
#pragma unroll 2
      for (int cl = 0; cl < CK; ++cl)
#pragma unroll
        for (int a = 0; a < 3; ++a) taps(cl, a);
    }
  }

  if (!co_ok) return;
#pragma unroll
  for (int p = 0; p < PT; ++p) {
    const int h = h0 + pr + (V2 ? p : 0);
    const int w = w0 + pc + (V2 ? 0 : p);
    if (h < H && w < W) {
      store8(y + ((static_cast<long long>(b) * H + h) * W + w) * Co + co0 + cog * OT, acc[p]);
    }
  }
}

template <typename T, int TH, int TW, bool V2>
int launch(const void* x, const void* wt, void* y, int B, int H, int W, int C,
           int Co, cudaStream_t stream) {
  constexpr int NT = TH * TW / PT * CO_GROUPS;
  const int co_tiles = (Co + TCO - 1) / TCO;
  const long long z = static_cast<long long>(B) * co_tiles;
  const int gy = (H + TH - 1) / TH;
  if (z > 65535 || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + TW - 1) / TW, gy, static_cast<unsigned>(z));
  conv3x3_kernel<T, TH, TW, V2><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), static_cast<T*>(y),
      H, W, C, Co, co_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int variant, const void* x, const void* wt, void* y, int B, int H,
             int W, int C, int Co, cudaStream_t st) {
  switch (variant) {
    case 0:  // P1: strips of 8 rows (the TPU's S), 32 columns
      return launch<T, 8, 32, false>(x, wt, y, B, H, W, C, Co, st);
    case 8:  // P2 at s2 = 8, 16, 32: 256 threads a block at each
      return launch<T, 8, 32, true>(x, wt, y, B, H, W, C, Co, st);
    case 16:
      return launch<T, 16, 16, true>(x, wt, y, B, H, W, C, Co, st);
    case 32:
      return launch<T, 32, 8, true>(x, wt, y, B, H, W, C, Co, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). x: contiguous (B, H, W, C);
// wt: contiguous (9, C, Co) taps; y: contiguous (B, H, W, Co), all in one
// dtype (0 = float32, 1 = bfloat16), 16-byte aligned. variant: 0 = P1, or
// P2's s2 (8, 16, 32). Returns the launch's cudaError_t.
extern "C" int jg_conv3x3_tap(const void* x, const void* wt, void* y, int B,
                              int H, int W, int C, int Co, int variant,
                              int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % CK != 0 ||
      Co % OT != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt) |
       reinterpret_cast<uintptr_t>(y)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(variant, x, wt, y, B, H, W, C, Co, st);
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(variant, x, wt, y, B, H, W, C, Co, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* jg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
