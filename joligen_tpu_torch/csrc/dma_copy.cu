// Double-buffered copy for Hopper (sm_90a): kernel P3 of the port.
//
// Replaces the Pallas TPU kernel tools/bw_probe3.py::make_copy (kernel at
// :28, pallas_call at :80): an exact copy of an (n_rows, row) array from
// device memory through fast on-chip memory back to device memory, in chunks
// of chunk_rows rows, double-buffered.
//
// Mapping. The TPU kernel is one program that walks the chunks in order and
// DMAs a whole chunk (up to 4096 rows x 4 KiB = 16 MiB) into one of two VMEM
// slots. A Hopper block has at most 227 KB of shared memory and blocks run in
// parallel, so here a chunk is the unit of work of one block: block i copies
// chunk i (grid = n_chunks) through two fixed 16 KiB tiles of shared memory.
// Each thread moves 16-byte vectors: cp.async loads global -> shared into one
// tile while the other tile is stored shared -> global with vectorised
// stores. The WAR guard of the TPU kernel (:48-54: wait for a slot's
// outgoing DMA before loading into the slot again) is the barrier after each
// tile's store: the load that refills a tile is issued only after every
// thread has read that tile out. A chunk whose bytes are not a multiple of
// the tile ends in a partial tile (predicated).
//
// Bound. 2 bytes move per byte of the array (each read once, written once):
// 2 GiB for the probe's 1 GiB array, 0.64 ms at the 3.35 TB/s of the H100
// SXM data sheet (700 W). The chunking sets the grid: 4096-row chunks of a
// 1 GiB fp32 array are 64 blocks for 132 SMs, and 256-row chunks are 1024
// blocks, more than the card holds at once (48 registers a thread allow 5
// blocks a SM, 660 in all), so a partial second wave follows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int VECS_PER_THREAD = 4;
constexpr int TILE_VECS = THREADS * VECS_PER_THREAD;  // 16 KiB of uint4

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(THREADS)
dma_copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                long long chunk_vecs) {
  __shared__ uint4 tile[2][TILE_VECS];
  const long long base = static_cast<long long>(blockIdx.x) * chunk_vecs;
  const int n_tiles = static_cast<int>((chunk_vecs + TILE_VECS - 1) / TILE_VECS);
  const int tid = threadIdx.x;

  auto load = [&](int t, int slot) {
    const long long off = static_cast<long long>(t) * TILE_VECS;
#pragma unroll
    for (int k = 0; k < VECS_PER_THREAD; ++k) {
      const int v = k * THREADS + tid;
      if (off + v < chunk_vecs) cp_async16(&tile[slot][v], src + base + off + v);
    }
    cp_async_commit();
  };

  load(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t & 1;
    // the other tile was read out by tile t-1's store (barrier below)
    if (t + 1 < n_tiles) {
      load(t + 1, slot ^ 1);
      cp_async_wait<1>();  // tile t has landed, tile t+1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const long long off = static_cast<long long>(t) * TILE_VECS;
#pragma unroll
    for (int k = 0; k < VECS_PER_THREAD; ++k) {
      const int v = k * THREADS + tid;
      if (off + v < chunk_vecs) dst[base + off + v] = tile[slot][v];
    }
    __syncthreads();  // WAR guard: tile[slot] is read out before its refill
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Copies n_chunks chunks of
// chunk_bytes each from src to dst (both 16-byte aligned, chunk_bytes a
// multiple of 16). Returns the launch's cudaError_t.
extern "C" int jg_dma_copy(const void* src, void* dst, long long n_chunks,
                           long long chunk_bytes, void* stream) {
  if (n_chunks <= 0 || n_chunks > 0x7fffffffLL || chunk_bytes <= 0 ||
      chunk_bytes % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) %
              16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dma_copy_kernel<<<static_cast<unsigned>(n_chunks), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), chunk_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* jg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
