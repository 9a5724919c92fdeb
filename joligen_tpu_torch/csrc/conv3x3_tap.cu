// 3x3 tap convolution for Hopper (sm_90a): kernels P1 and P2 of the port.
//
// Replaces the Pallas TPU kernels of tools/fused_resblock_probe.py:
//   P1 _conv_kernel    (wrapper conv_pallas,    pallas_call at :98)
//   P2 _conv_kernel_v2 (wrapper conv_pallas_v2, pallas_call at :173)
// Same function for both: y[b,h,w,o] = sum_dy sum_dx sum_c
// xpad[b,h+dy,w+dx,c] * w[dy,dx,c,o] with SAME zero padding, NHWC input,
// fp32 accumulation, one rounding to the input dtype at the end. The two
// differ in the order of the reduction, as the TPU kernels do:
//   P1 takes the taps dy outer and dx inner, each of depth C (the TPU's 9
//      dots);
//   P2 takes dx outer and a panel of (dy, c) of depth 3C inner (the TPU's 3
//      dots against the weight repacked to (dx, 3C, Co) by the wrapper).
// Both receive the weight as 9 taps (9, C, Co) in their own order (P1 tap
// 3*dy+dx from HWIO, P2 tap 3*dx+dy of the repack), so each walks its taps
// 0..8 and only the (dy, dx) of a tap differs.
//
// Two routes, chosen by dtype in jg_conv3x3_tap:
//
// bf16 -- one implicit GEMM on the tensor cores (conv3x3_wgmma_kernel):
// M = output pixels along an image row, N = output channels, K = 9C in the
// kernel's tap order, channel chunks inside each tap. A block of two
// warpgroups owns ROWS rows x 64 columns x 128 output channels (ROWS = 8
// for P1, the TPU's strip; P2's s2 = 8, 16 or 32) and walks its rows in
// pairs, warpgroup w taking row 2p + w of pair p as an m64n128 fp32
// accumulator in registers (64 a thread). One K step is one tap and 64
// input channels: the shifted 64-pixel input row segment of each warpgroup
// (A) and the tap's 128 x 64 weight slice (B, the wrapper transposes each
// tap so that channels are contiguous) are staged in shared memory by
// 16-byte cp.async, both K-major in the 128-byte swizzled layout of
// hopper_wgmma.cuh, then 4 wgmma m64n128k16 per warpgroup consume them.
// Rows, columns and channels past
// H, W, C and Co are zero-filled by the copy's predicate (nothing is read
// there); SAME padding is the same predicate, so no padded copy of x is
// made and a NaN beside the input never enters. Stores skip what lies past
// H, W and Co.
//
// Pipeline: a ring of 3 stages. The copies of step k+2 are issued before
// the products of step k, so they land while steps k and k+1 compute; each
// warpgroup waits for its own products (wgmma_wait<0>) before the next
// barrier, so no accumulator register is touched while a product is in
// flight and ptxas injects no wait (keeping one product group in flight
// across the loop made ptxas inject one, C7517). Two blocks share an SM
// (2 x 97 KB of shared memory, at most 128 registers a thread), so one
// block's products run while the other waits at its barrier.
//
// Layout: a 64-channel K step is exactly one 128-byte swizzle row, so both
// tiles take the swizzled layout, which wgmma read 2.4x faster here than
// the no-swizzle core-matrix layout of K1-K3 (PERF.md, section 6); the
// swizzle also spreads a row's 8 chunks over the banks for the copies.
//
// fp32 -- the CUDA cores (conv3x3_fma_kernel), kept so that fp32 callers
// stay within 1e-4 of the plain version: each block owns an output tile of
// TH rows x TW columns x 64 output channels and loops over C in chunks of
// CK = 8 channels, staging the chunk's input halo (TH+2) x (TW+2) x CK and
// its 9 x CK x 64 tap weights in shared memory; every thread keeps an
// 8-pixel x 8-channel accumulator tile in registers. P1's thread owns 8
// consecutive columns of one row (an input row segment of 10 values serves
// the three dx taps); P2's owns 8 consecutive rows of one column (a column
// segment serves the three dy taps of its panel). P2's TH is s2.
//
// Bound. At the probe's shape, (16,128,128,128) bf16, the conv is 77.3 GFLOP
// against 134.5 MB: at the H100 SXM data sheet's rates (989 TFLOP/s bf16 on
// the tensor cores, 3.35 TB/s, at its 700 W limit) the operations bound it at
// 0.078 ms. This design stages each 64-pixel input row segment 9 times (3
// output rows x 3 dx taps) and the whole weight once per row pair, from L2:
// about 1.2 GB of L2-to-SM traffic at that shape (32 KB a K step), which
// with shared memory's bandwidth is what keeps it above the bound.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_wgmma.cuh"

namespace {

// ---- fp32 route: FMAs on the CUDA cores -----------------------------------

constexpr int CK = 8;         // input channels staged per chunk
constexpr int TCO = 64;       // output channels per block
constexpr int PT = 8;         // pixels per thread
constexpr int OT = 8;         // output channels per thread
constexpr int CO_GROUPS = TCO / OT;

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// x: (B, H, W, C) NHWC; wt: (9, C, Co) taps; y: (B, H, W, Co), all fp32.
// C % CK == 0 and Co % OT == 0 (checked by the entry point).
template <int TH, int TW, bool V2>
__global__ void __launch_bounds__(TH * TW / PT * CO_GROUPS, 2)
conv3x3_fma_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                   float* __restrict__ y, int H, int W, int C, int Co,
                   int co_tiles) {
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

  const float* xb = x + static_cast<long long>(b) * H * W * C;

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

template <int TH, int TW, bool V2>
int launch_fma(const void* x, const void* wt, void* y, int B, int H, int W,
               int C, int Co, cudaStream_t stream) {
  constexpr int NT = TH * TW / PT * CO_GROUPS;
  const int co_tiles = (Co + TCO - 1) / TCO;
  const long long z = static_cast<long long>(B) * co_tiles;
  const int gy = (H + TH - 1) / TH;
  if (z > 65535 || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + TW - 1) / TW, gy, static_cast<unsigned>(z));
  conv3x3_fma_kernel<TH, TW, V2><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt),
      static_cast<float*>(y), H, W, C, Co, co_tiles);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_fma(int variant, const void* x, const void* wt, void* y, int B,
                 int H, int W, int C, int Co, cudaStream_t st) {
  switch (variant) {
    case 0:  // P1: strips of 8 rows (the TPU's S), 32 columns
      return launch_fma<8, 32, false>(x, wt, y, B, H, W, C, Co, st);
    case 8:  // P2 at s2 = 8, 16, 32: 256 threads a block at each
      return launch_fma<8, 32, true>(x, wt, y, B, H, W, C, Co, st);
    case 16:
      return launch_fma<16, 16, true>(x, wt, y, B, H, W, C, Co, st);
    case 32:
      return launch_fma<32, 8, true>(x, wt, y, B, H, W, C, Co, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- bf16 route: one implicit GEMM on wgmma -------------------------------

using bf16 = __nv_bfloat16;

// The one tiling (PERF.md, section 6, has the others that were timed).
constexpr int BM = 64;                  // output pixels a warpgroup (one row)
constexpr int BN = 128;                 // output channels a block
constexpr int KC = 64;                  // input channels a K step: 128 bytes
constexpr int WGS = 2;                  // warpgroups a block: rows a K step
constexpr int STAGES = 3;
constexpr int AHEAD = STAGES - 1;       // stages loaded ahead of the one used
constexpr int WG_THREADS = 128;
constexpr int THREADS = WGS * WG_THREADS;
constexpr int A_TILE = BM * KC * 2;     // 64 pixels x KC, K-major, swizzled
constexpr int B_TILE = BN * KC * 2;     // 128 out channels x KC, the same
constexpr int STAGE_BYTES = WGS * A_TILE + B_TILE;
// 1024 bytes of slack to start the ring on a 1024-byte boundary
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
constexpr int ROW_STEP = THREADS / 8;   // tile rows one pass of copies fills

// x: (B, H, W, C) NHWC; wt: (9, Co, C) taps in the kernel's order, each
// transposed (C contiguous) by the wrapper; y: (B, H, W, Co); all bf16,
// 16-byte aligned, C and Co multiples of 8.
template <int ROWS, bool V2>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                     bf16* __restrict__ y, int H, int W, int C, int Co,
                     int co_tiles) {
  using namespace jg_hopper;
  static_assert(ROWS % WGS == 0, "rows are walked WGS at a time");
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS;
  const int warp = (tid % WG_THREADS) / 32;
  const int lane = tid % 32;
  const int b = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * BN;
  const int h0 = blockIdx.y * ROWS;
  const int w0 = blockIdx.x * BM;
  const int n_chunks = (C + KC - 1) / KC;  // channel chunks a tap
  const int n_steps = 9 * n_chunks;        // K steps a group of rows
  const int n_groups = (min(ROWS, H - h0) + WGS - 1) / WGS;
  const int total = n_groups * n_steps;

  // This thread's copies of a stage: the 16-byte channel chunk ch of tile
  // rows r0 + ROW_STEP i, which are pixel (row % 64) of warpgroup
  // (row / 64)'s input row (A) and output channel co0 + row (B).
  // Neighbouring threads read neighbouring 16 bytes of device memory, and
  // write 8 different bank groups of shared memory (the swizzle).
  const int ch = tid % 8;
  const int r0 = tid / 8;
  const bf16* xb = x + static_cast<long long>(b) * H * W * C;

  auto load_stage = [&](int g) {
    const uint32_t st = base + (g % STAGES) * STAGE_BYTES;
    const int group = g / n_steps;
    const int q = g % n_steps;
    const int tap = q / n_chunks;
    const int c0 = (q % n_chunks) * KC;
    const int dy = V2 ? tap % 3 : tap / 3;
    const int dx = V2 ? tap / 3 : tap % 3;
    const bool ch_ok = c0 + 8 * ch < C;
#pragma unroll
    for (int i = 0; i < WGS * BM / ROW_STEP; ++i) {
      const int w = (r0 + ROW_STEP * i) / BM;  // the warpgroup's row
      const int px = (r0 + ROW_STEP * i) % BM;
      const int hi = h0 + WGS * group + w + dy - 1;
      const int wi = w0 + px + dx - 1;
      const bool ok = ch_ok && hi >= 0 && hi < H && wi >= 0 && wi < W;
      const bf16* src =
          ok ? xb + (static_cast<long long>(hi) * W + wi) * C + c0 + 8 * ch
             : x;
      cp_async16(st + w * A_TILE + sw128_offset(px, ch), src, ok);
    }
#pragma unroll
    for (int i = 0; i < BN / ROW_STEP; ++i) {
      const int n = r0 + ROW_STEP * i;
      const bool ok = ch_ok && co0 + n < Co;
      const bf16* src =
          ok ? wt + (static_cast<long long>(tap) * Co + co0 + n) * C + c0 +
                   8 * ch
             : wt;
      cp_async16(st + WGS * A_TILE + sw128_offset(n, ch), src, ok);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int g = 0; g < AHEAD; ++g) {
    if (g < total) load_stage(g);
    cp_async_commit();
  }

  for (int g = 0; g < total; ++g) {
    cp_async_wait<AHEAD - 1>();  // this thread's copies of stage g landed
    fence_proxy_async();
    // everyone's have; every product of step g - 1 is done, so its slot
    // takes step g + AHEAD
    __syncthreads();
    if (g + AHEAD < total) load_stage(g + AHEAD);
    cp_async_commit();

    const int q = g % n_steps;
    const uint32_t st = base + (g % STAGES) * STAGE_BYTES;
    const uint32_t sa = st + wg * A_TILE;
    const uint32_t sb = st + WGS * A_TILE;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < KC / 16; ++t) {  // k16 slice t: 32 bytes on
      wgmma_ss_n128(acc, make_desc_sw128(sa + 32 * t),
                    make_desc_sw128(sb + 32 * t), (q > 0 || t > 0) ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    if (q == n_steps - 1) {
      // register i holds row 16 * warp + lane / 4 + 8 * ((i / 2) % 2) and
      // column 8 * (i / 4) + 2 * (lane % 4) + i % 2 of the m64n128 tile
      const int h = h0 + WGS * (g / n_steps) + wg;
      if (h < H) {
        bf16* yr = y + (static_cast<long long>(b) * H + h) * W * Co;
#pragma unroll
        for (int i = 0; i < BN / 2; i += 2) {
          const int wo = w0 + 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
          const int co = co0 + 8 * (i >> 2) + 2 * (lane & 3);
          if (wo < W && co < Co) {
            *reinterpret_cast<__nv_bfloat162*>(
                yr + static_cast<long long>(wo) * Co + co) =
                __floats2bfloat162_rn(acc[i], acc[i + 1]);
          }
        }
      }
    }
  }
}

template <int ROWS, bool V2>
int launch_wgmma(const void* x, const void* wt, void* y, int B, int H, int W,
                 int C, int Co, cudaStream_t stream) {
  auto kernel = conv3x3_wgmma_kernel<ROWS, V2>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_BYTES);
  // room for two blocks an SM
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  const int co_tiles = (Co + BN - 1) / BN;
  const long long z = static_cast<long long>(B) * co_tiles;
  const int gy = (H + ROWS - 1) / ROWS;
  if (z > 65535 || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + BM - 1) / BM, gy, static_cast<unsigned>(z));
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wt),
      static_cast<bf16*>(y), H, W, C, Co, co_tiles);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_wgmma(int variant, const void* x, const void* wt, void* y, int B,
                   int H, int W, int C, int Co, cudaStream_t st) {
  switch (variant) {
    case 0:  // P1: strips of 8 rows (the TPU's S)
      return launch_wgmma<8, false>(x, wt, y, B, H, W, C, Co, st);
    case 8:  // P2: strips of s2 rows
      return launch_wgmma<8, true>(x, wt, y, B, H, W, C, Co, st);
    case 16:
      return launch_wgmma<16, true>(x, wt, y, B, H, W, C, Co, st);
    case 32:
      return launch_wgmma<32, true>(x, wt, y, B, H, W, C, Co, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). x: contiguous (B, H, W, C);
// wt: contiguous (9, C, Co) taps; y: contiguous (B, H, W, Co), all in one
// dtype (0 = float32: FMA kernel; 1 = bfloat16: wgmma kernel), 16-byte
// aligned. variant: 0 = P1, or P2's s2 (8, 16, 32). Returns the launch's
// cudaError_t.
extern "C" int jg_conv3x3_tap(const void* x, const void* wt, void* y, int B,
                              int H, int W, int C, int Co, int variant,
                              int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || C % 8 != 0 ||
      Co % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt) |
       reinterpret_cast<uintptr_t>(y)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_fma(variant, x, wt, y, B, H, W, C, Co, st);
  if (dtype == 1) return dispatch_wgmma(variant, x, wt, y, B, H, W, C, Co, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* jg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
