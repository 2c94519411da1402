// limit_rank (K27): LIMIT's keep mask over one batch and the running
// emitted count, in one launch with no host read.
//
// Replaces presto_tpu/ops/sort.py:87 `_limit_batch_impl`:
//   keep = row_valid & (rank_among_live < n - emitted)
// and the emitted-count `sum` the operator adds after it: the kernel
// reads `emitted` (a device int64) and writes
//   emitted + min(max(n - emitted, 0), live rows)
// into a new device int64, so a LIMIT over many batches carries its
// count on the device and the operator's limit-reached flag stays
// asynchronous.
//
// What bounds it on the H100: not bytes. At LIMIT_SCAN's largest call
// (2,097,152 rows) row_valid in and keep out are 4 MB, 1.25 us at
// 3.35 TB/s; the rest is launch latency and the scan's dependency
// between tiles. The old design spent three launches on that
// (count, a one-block scan of the tile counts, mark) and read row_valid
// twice. This one is a single-pass chained scan with a decoupled
// look-back (Merrill and Garland, 2016; K25 in radix_sort.cu uses the
// same status words):
//
//   - a block takes its tile number from an atomic counter, so a tile
//     only waits on tiles that already run; the block that takes the
//     last ticket sets the counter back to 0 for the next call;
//   - each thread loads 16 rows of row_valid as one 16-byte vector,
//     counts them with popc, and the block scans the threads' counts;
//   - warp 0 publishes the tile's aggregate, looks back over up to 32
//     earlier tiles at a time until an inclusive prefix, and publishes
//     its own inclusive prefix;
//   - each thread then keeps its live rows whose rank is under
//     n - emitted and stores 16 rows of keep with one vector store;
//   - the last tile writes the new emitted count.
// Where n - emitted <= 0 no row is kept: every block writes zeros and
// skips the look-back, and the count comes out as `emitted`.
//
// The status words, the ticket and the look-back are lookback.cuh's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

#define THREADS 256
#define VEC 16
#define TILE (THREADS * VEC)
#define WARPS (THREADS / 32)

typedef unsigned long long u64;

// any nonzero byte of w as 1 (torch's bools are 0 or 1 already)
__device__ __forceinline__ uint32_t ones(uint32_t w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  return w & 0x01010101u;
}

// the first `k` set bytes (each 0 or 1) of the four words, in row order
__device__ __forceinline__ void keep_first(uint32_t (&w)[4], int64_t k) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t bit = 1u << (8 * b);
      if (w[q] & bit) {
        if (k > 0)
          --k;
        else
          w[q] &= ~bit;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
limit_rank_kernel(const uint8_t* __restrict__ row_valid, int64_t n, int64_t limit,
                  const int64_t* __restrict__ emitted, uint8_t* __restrict__ keep,
                  int64_t* __restrict__ emitted_out, uint32_t* ticket, u64* status,
                  uint32_t epoch, uint32_t ntiles) {
  __shared__ uint32_t wsum[WARPS];
  __shared__ uint32_t before_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t t = presto_lb_ticket(ticket, ntiles);
  const bool last = t == ntiles - 1;
  const int64_t e = *emitted;
  const int64_t room = limit - e;
  const int64_t row0 = static_cast<int64_t>(t) * TILE + threadIdx.x * VEC;
  const bool whole = row0 + VEC <= n;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (room > 0) {
    if (whole && (reinterpret_cast<uintptr_t>(row_valid) & 15) == 0) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(row_valid + row0));
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
      for (int i = 0; i < VEC && row0 + i < n; ++i)
        w[i >> 2] |= static_cast<uint32_t>(row_valid[row0 + i]) << (8 * (i & 3));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = ones(w[q]);
    const uint32_t cnt = __popc(w[0]) + __popc(w[1]) + __popc(w[2]) + __popc(w[3]);
    // the block's exclusive scan of the threads' counts
    uint32_t x = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    uint32_t in_block = x - cnt, total = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      const uint32_t s = wsum[k];
      in_block += k < warp ? s : 0;
      total += s;
    }
    // warp 0: publish, look back, publish the inclusive prefix
    if (warp == 0) {
      const uint32_t prefix = presto_lb_prefix(status, t, epoch, total);
      if (lane == 0) before_tile = prefix;
    }
    __syncthreads();
    const int64_t before = static_cast<int64_t>(before_tile) + in_block;
    const int64_t allowed = room - before;
    if (allowed <= 0) {
      w[0] = w[1] = w[2] = w[3] = 0u;
    } else if (allowed < cnt) {
      keep_first(w, allowed);
    }
    if (last && threadIdx.x == 0) {
      const int64_t live = static_cast<int64_t>(before_tile) + total;
      *emitted_out = e + (live < room ? live : room);
    }
  } else if (last && threadIdx.x == 0) {
    *emitted_out = e;
  }
  if (whole) {
    __stcs(reinterpret_cast<uint4*>(keep + row0), make_uint4(w[0], w[1], w[2], w[3]));
  } else {
    for (int i = 0; i < VEC && row0 + i < n; ++i)
      keep[row0 + i] = static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_limit_tile() { return TILE; }

// row_valid: n bools; keep: n bools, 16-byte aligned; emitted,
// emitted_out: one int64 each; ticket: one uint32, 0 between calls;
// status: ceil(n / TILE) uint64 whose epochs are not `epoch` (zeroed
// once, per stream); epoch: 1 .. 2^30 - 1, new for every call on the
// stream. One launch; reads nothing back.
int presto_limit_rank(const void* row_valid, int64_t n, int64_t limit, const void* emitted,
                      void* keep, void* emitted_out, void* ticket, void* status,
                      uint32_t epoch, void* stream) {
  if (n < 1 || n > 0x7fffffffLL || epoch == 0 || epoch > 0x3fffffffu ||
      (reinterpret_cast<uintptr_t>(keep) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t ntiles = static_cast<uint32_t>((n + TILE - 1) / TILE);
  limit_rank_kernel<<<ntiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(row_valid), n, limit, static_cast<const int64_t*>(emitted),
      static_cast<uint8_t*>(keep), static_cast<int64_t*>(emitted_out),
      static_cast<uint32_t*>(ticket), static_cast<u64*>(status), epoch, ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
