// limit_rank (K27): LIMIT's keep mask over one batch and the running
// emitted count, with no host read.
//
// Replaces presto_tpu/ops/sort.py:87 `_limit_batch_impl`:
//   keep = row_valid & (rank_among_live < n - emitted)
// and the emitted-count `sum` the operator adds after it: the kernel
// reads `emitted` (a device int64) and writes emitted + kept into a
// new device int64, so a LIMIT over many batches carries its count on
// the device and the operator's limit-reached flag stays asynchronous.
//
// Three launches on one stream, as K2 (compact.cu):
//   1. count: each block counts the live rows of its tile of
//      TILE = THREADS x ITEMS rows (warp ballots + popc);
//   2. scan: one block turns the tile counts into exclusive offsets
//      (a block-wide scan in chunks of THREADS with a running carry)
//      and writes emitted + min(max(n - emitted, 0), live rows);
//   3. mark: each block recomputes its rows' ranks among the live rows
//      the same way and writes keep.
//
// What bounds it: bytes. row_valid is read twice (count and mark), keep
// written once; the tile counts are a few KB.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define ITEMS 4
#define TILE (THREADS * ITEMS)
#define WARPS (THREADS / 32)

// Exclusive rank of this lane's flag among the block's THREADS lanes
// for one round, and the round's total. All threads must call it.
__device__ __forceinline__ int block_rank(bool flag, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int in_warp = __popc(ballot & ((1u << lane) - 1u));
  __syncthreads();  // warp_sums may still be read from the last round
  if (lane == 0) warp_sums[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < WARPS; ++w) {
    const int s = warp_sums[w];
    before += w < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + in_warp;
}

__global__ void __launch_bounds__(THREADS)
count_kernel(const bool* __restrict__ row_valid, int64_t n, int32_t* __restrict__ tile_counts) {
  __shared__ int warp_sums[WARPS];
  const int64_t start = static_cast<int64_t>(blockIdx.x) * TILE;
  int count = 0;
  for (int it = 0; it < ITEMS; ++it) {
    const int64_t row = start + it * THREADS + threadIdx.x;
    int round_total;
    block_rank(row < n && row_valid[row], warp_sums, &round_total);
    count += round_total;
  }
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = count;
}

__global__ void __launch_bounds__(THREADS)
scan_kernel(const int32_t* __restrict__ tile_counts, int32_t ntiles,
            int64_t* __restrict__ tile_offsets, int64_t limit,
            const int64_t* __restrict__ emitted, int64_t* __restrict__ emitted_out) {
  __shared__ int64_t vals[THREADS];
  int64_t carry = 0;
  for (int base = 0; base < ntiles; base += THREADS) {
    const int i = base + threadIdx.x;
    const int64_t v = i < ntiles ? tile_counts[i] : 0;
    vals[threadIdx.x] = v;
    __syncthreads();
    for (int off = 1; off < THREADS; off <<= 1) {
      const int64_t add = threadIdx.x >= off ? vals[threadIdx.x - off] : 0;
      __syncthreads();
      vals[threadIdx.x] += add;
      __syncthreads();
    }
    if (i < ntiles) tile_offsets[i] = carry + vals[threadIdx.x] - v;
    carry += vals[THREADS - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int64_t e = *emitted;
    int64_t room = limit - e;
    if (room < 0) room = 0;
    *emitted_out = e + (carry < room ? carry : room);
  }
}

__global__ void __launch_bounds__(THREADS)
mark_kernel(const bool* __restrict__ row_valid, int64_t n, const int64_t* __restrict__ tile_offsets,
            int64_t limit, const int64_t* __restrict__ emitted, bool* __restrict__ keep) {
  __shared__ int warp_sums[WARPS];
  const int64_t start = static_cast<int64_t>(blockIdx.x) * TILE;
  const int64_t room = limit - *emitted;
  int64_t live_before = tile_offsets[blockIdx.x];
  for (int it = 0; it < ITEMS; ++it) {
    const int64_t row = start + it * THREADS + threadIdx.x;
    const bool live = row < n && row_valid[row];
    int round_total;
    const int rank = block_rank(live, warp_sums, &round_total);
    if (row < n) keep[row] = live && live_before + rank < room;
    live_before += round_total;
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_limit_tiles(int64_t n) { return static_cast<int>((n + TILE - 1) / TILE); }

// row_valid, keep: n bools; emitted, emitted_out: one int64 each;
// scratch: presto_limit_tiles(n) int32 followed by as many int64 (the
// int64 part 8-byte aligned).
int presto_limit_rank(const void* row_valid, int64_t n, int64_t limit, const void* emitted,
                      void* keep, void* emitted_out, void* counts, void* offsets,
                      void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = presto_limit_tiles(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool* rv = static_cast<const bool*>(row_valid);
  const int64_t* em = static_cast<const int64_t*>(emitted);
  count_kernel<<<ntiles, THREADS, 0, s>>>(rv, n, static_cast<int32_t*>(counts));
  scan_kernel<<<1, THREADS, 0, s>>>(static_cast<const int32_t*>(counts), ntiles,
                                    static_cast<int64_t*>(offsets), limit, em,
                                    static_cast<int64_t*>(emitted_out));
  mark_kernel<<<ntiles, THREADS, 0, s>>>(rv, n, static_cast<const int64_t*>(offsets), limit,
                                         em, static_cast<bool*>(keep));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
