// Exact chunked copy for Hopper (sm_90a) through the Tensor Memory
// Accelerator: kernel P3 of the port.
//
// Replaces the Pallas TPU kernel tools/bw_probe3.py::make_copy (kernel at
// :28, pallas_call at :80): an exact copy of an (n_rows, row) array from
// device memory through fast on-chip memory back to device memory, in chunks
// of chunk_rows rows, a slot refilled only after its outgoing copy has read
// it out (:48-54), every outgoing copy drained before the end (:65-69).
//
// Bound. 2 bytes move per byte of the array (each read once, written once):
// 2 GiB for the probe's 1 GiB array, 0.641 ms at the 3.35 TB/s of the H100
// SXM data sheet (700 W). Nothing else bounds a copy, so the design is about
// keeping every SM's copies in flight with nothing between them.
//
// Design. The TPU kernel walks the chunks in order on one core. Here:
// - Work items, not chunks, set the grid. An item is one tile of TILE_BYTES
//   of one chunk; a chunk whose bytes are not a multiple of the tile ends in
//   one shorter item, so no item crosses a chunk edge (as the TPU's DMAs end
//   at chunk edges). The grid is persistent: one block on each SM, never
//   more blocks than items, and block b walks items b, b + grid, ...,
//   so the whole grid moves through the array together. Every chunking
//   keeps every SM busy (the earlier kernel, one block a chunk, left 68 of
//   132 SMs idle at 4096-row chunks of 1 GiB: 2.35 TB/s against 2.80 at
//   1024 rows).
// - One thread issues everything: 1D TMA bulk copies (no tensor map) load
//   items into a ring of STAGES tiles in dynamic shared memory, each stage
//   with an mbarrier armed for its item's bytes, and bulk copies store each
//   landed tile back. No thread touches the data, so no registers, address
//   arithmetic or barriers sit between the copies (a cp.async copy through
//   256 threads held 48 registers a thread and two barriers a tile).
// - The WAR guard of the TPU kernel becomes cp.async.bulk.wait_group.read
//   before a stage is refilled: the stage refilled after item k's store is
//   item k-1's, so only the newest store may still be reading.
// - Bytes in flight: seven 4 KiB loads a SM (28 KiB) while one tile's
//   store reads out, in 32,832 bytes of shared memory (under the 48 KB a
//   launch gets without opting in). On the H100 larger rings (up to 192 KiB
//   of loads in flight a SM) or two blocks a SM were no faster
//   (PERF.md section 6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ops/copy.py::TILE_BYTES holds the same value (its tiling of the plain
// version); one mbarrier phase counts at most 2^20 - 1 bytes
constexpr long long TILE_BYTES = 4096;
constexpr int STAGES = 8;
constexpr int THREADS = 32;
constexpr int SMEM_BYTES = STAGES * TILE_BYTES + STAGES * 8;  // ring, barriers
static_assert(SMEM_BYTES <= 48 * 1024, "above 48 KB a launch must opt in");
static_assert(TILE_BYTES < (1 << 20), "one mbarrier phase's byte count");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One block's walk over its items, blockIdx.x + k * gridDim.x for k = 0, 1,
// ...: the item's chunk and its tile in the chunk, advanced by gridDim.x
// items a step without a division.
struct Walk {
  long long chunk, tile;

  __device__ long long offset(long long chunk_bytes) const {
    return chunk * chunk_bytes + tile * TILE_BYTES;
  }
  __device__ uint32_t bytes(long long chunk_bytes) const {
    const long long left = chunk_bytes - tile * TILE_BYTES;
    return static_cast<uint32_t>(left < TILE_BYTES ? left : TILE_BYTES);
  }
  __device__ void step(long long chunk_step, long long tile_step,
                       long long tiles_per_chunk) {
    chunk += chunk_step;
    tile += tile_step;
    if (tile >= tiles_per_chunk) {
      tile -= tiles_per_chunk;
      ++chunk;
    }
  }
};

__global__ void __launch_bounds__(THREADS)
dma_copy_kernel(const char* __restrict__ src, char* __restrict__ dst,
                long long chunk_bytes, long long tiles_per_chunk,
                long long n_items) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  const uint32_t ring = smem_addr(smem);
  const uint32_t bars = ring + STAGES * TILE_BYTES;
  for (int s = 0; s < STAGES; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars + 8 * s)
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  const long long n_mine =
      (n_items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long chunk_step = gridDim.x / tiles_per_chunk;
  const long long tile_step = gridDim.x % tiles_per_chunk;
  // loads run up to STAGES items ahead of the stores
  Walk in{blockIdx.x / tiles_per_chunk, blockIdx.x % tiles_per_chunk};
  Walk out = in;
  int in_stage = 0, out_stage = 0;
  uint32_t out_phase = 0;
  auto load = [&]() {
    const uint32_t bar = bars + 8 * in_stage;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%2], [%3], %1, [%0];\n" ::"r"(bar),
        "r"(in.bytes(chunk_bytes)),
        "r"(ring + in_stage * static_cast<uint32_t>(TILE_BYTES)),
        "l"(src + in.offset(chunk_bytes))
        : "memory");
    in.step(chunk_step, tile_step, tiles_per_chunk);
    in_stage = in_stage + 1 == STAGES ? 0 : in_stage + 1;
  };

  long long issued = 0;
  for (; issued < n_mine && issued < STAGES; ++issued) load();
  for (long long k = 0; k < n_mine; ++k) {
    mbar_wait(bars + 8 * out_stage, out_phase);
    // the tile was written and is read by the async proxy only; the fence
    // orders the two across this thread's wait at no measurable cost
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
        "cp.async.bulk.commit_group;\n" ::"l"(dst + out.offset(chunk_bytes)),
        "r"(ring + out_stage * static_cast<uint32_t>(TILE_BYTES)),
        "r"(out.bytes(chunk_bytes))
        : "memory");
    out.step(chunk_step, tile_step, tiles_per_chunk);
    if (++out_stage == STAGES) {
      out_stage = 0;
      out_phase ^= 1;
    }
    if (k >= 1 && issued < n_mine) {
      // item k-1's stage (issued == k - 1 + STAGES) is refilled once its
      // store has read it out; item k's store may still be reading
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load();
      ++issued;
    }
  }
  // drain: no store may outlive the block's shared memory
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The launch's shape: plan[0..4] = grid, stages, dynamic shared memory
// bytes, tile bytes, work items.
int plan_launch(long long n_chunks, long long chunk_bytes, long long* plan) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles_per_chunk =
      (chunk_bytes + TILE_BYTES - 1) / TILE_BYTES;
  const long long n_items = n_chunks * tiles_per_chunk;
  plan[0] = n_items < sms ? n_items : sms;
  plan[1] = STAGES;
  plan[2] = SMEM_BYTES;
  plan[3] = TILE_BYTES;
  plan[4] = n_items;
  return 0;
}

bool valid(long long n_chunks, long long chunk_bytes) {
  return n_chunks > 0 && n_chunks <= 0x7fffffffLL && chunk_bytes > 0 &&
         chunk_bytes % 16 == 0;
}

}  // namespace

// Plain C entry points (loaded with ctypes); each returns a cudaError_t.

// Fills plan[0..4] with the grid, stages, dynamic shared memory bytes, tile
// bytes and work items that jg_dma_copy launches with on the current device.
extern "C" int jg_dma_copy_plan(long long n_chunks, long long chunk_bytes,
                                long long* plan) {
  if (!valid(n_chunks, chunk_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return plan_launch(n_chunks, chunk_bytes, plan);
}

// Copies n_chunks chunks of chunk_bytes each from src to dst (both 16-byte
// aligned, chunk_bytes a multiple of 16), as TMA bulk copies need.
extern "C" int jg_dma_copy(const void* src, void* dst, long long n_chunks,
                           long long chunk_bytes, void* stream) {
  if (!valid(n_chunks, chunk_bytes) ||
      (reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) %
              16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long plan[5];
  int err = plan_launch(n_chunks, chunk_bytes, plan);
  if (err != 0) return err;
  dma_copy_kernel<<<static_cast<unsigned>(plan[0]), THREADS, SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), static_cast<char*>(dst), chunk_bytes,
      plan[4] / n_chunks, plan[4]);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* jg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
