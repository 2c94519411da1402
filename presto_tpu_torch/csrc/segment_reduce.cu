// segment_reduce (K6): the grouping arithmetic of the sort-based
// aggregation, over rows already sorted by their (h1, h2) row hashes.
//
// Replaces presto_tpu/ops/hashagg.py `_group_reduce` after its sort
// (:624-666): `common.boundaries(..., hashes=(h1, h2))`, the packed
// group ids `gid = cumsum(bnd) - 1`, `_sorted_reduce` of every state
// component into out_cap slots (:535), `_first_rows` (:516) and the
// overflow flag (groups > out_cap). The group ids stay internal: the
// caller reads only the slots, the first rows and the two flags, so no
// per-row id column is written. A row starts a group when it is live and the row
// before it is dead, or its h1, h2 or any key differs from that row's
// (two NULLs compare equal; a float NaN differs from itself, as the
// reference's `!=`). The kernel compares one group of at most
// PRESTO_MAX_KEYS key columns itself; the keys past it arrive as a
// per-row "changed" byte ORed by one presto_segment_key_changes launch
// per further group, so any number of keys works.
//
// Four launches on one stream:
//   1. seg_flags: one thread per row writes its boundary flag; each
//      1024-row tile counts its boundaries; the last live row is kept.
//   2. seg_scan: one block scans the tile counts into tile offsets and
//      writes the group count and the overflow flag.
//   3. seg_assign: per tile, a block scan of the flags gives every
//      group start its packed group id, and the group its first row.
//   4. seg_reduce: one warp per output slot. A live slot's warp walks
//      its group's rows [first row, next group's first row) with a lane
//      stride and combines the 32 partial results by a fixed shuffle
//      tree, so float sums are deterministic (no atomics); slots past
//      the group count get the reduction's identity and first row n-1.
//
// What bounds it: bytes. Each row's flags read h1, h2, the keys and
// row_valid of itself and its predecessor (the predecessor's are the
// neighbour lane's, served by L1), and every component's contribution is
// read once; the outputs are the first row and out_cap slots per
// component. Integer sums wrap like the reference's int64 segment_sum.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment.cuh"

#define TILE PRESTO_SEG_TILE
#define THREADS 256

struct SegArgs {
  const int64_t* h1;
  const int64_t* h2;
  KeyCols keys;
  // keys past the first group: 1 where row i's differ from row i - 1's
  // (presto_segment_key_changes, one launch per group), or null
  const uint8_t* key_changes;
  const bool* valid;
  int64_t n;
  Comps comps;
  int64_t out_cap;
};

__device__ __forceinline__ int64_t warp_max(int64_t v) {
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t w = __shfl_down_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

__global__ void __launch_bounds__(TILE)
seg_flags(const SegArgs a, uint8_t* __restrict__ flags, int64_t* __restrict__ tile_counts,
          int64_t* stats) {
  __shared__ int64_t warp_last[TILE / 32];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x;
  int b = 0;
  int64_t last = 0;
  if (i < a.n) {
    if (a.valid[i]) {
      last = i + 1;
      if (i == 0 || !a.valid[i - 1] || a.h1[i] != a.h1[i - 1] || a.h2[i] != a.h2[i - 1]) {
        b = 1;
      } else {
        b = presto_keys_differ(a.keys, i, i - 1) ||
                    (a.key_changes != nullptr && a.key_changes[i] != 0)
                ? 1
                : 0;
      }
    }
    flags[i] = static_cast<uint8_t>(b);
  }
  const int count = __syncthreads_count(b);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = count;
  last = warp_max(last);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_last[wid] = last;
  __syncthreads();
  if (wid == 0) {
    last = warp_max(warp_last[lane]);
    if (lane == 0 && last > 0)
      atomicMax(reinterpret_cast<unsigned long long*>(stats + 2),
                static_cast<unsigned long long>(last));
  }
}

__global__ void __launch_bounds__(TILE)
seg_scan(int64_t* __restrict__ tile_counts, int64_t ntiles, int64_t out_cap, int64_t* stats) {
  const int64_t total = presto_scan_tiles(tile_counts, ntiles);
  if (threadIdx.x == 0) {
    stats[0] = total;
    stats[1] = total > out_cap ? 1 : 0;
  }
}

__global__ void __launch_bounds__(TILE)
seg_assign(const SegArgs a, const uint8_t* __restrict__ flags,
           const int64_t* __restrict__ tile_offsets, int64_t* __restrict__ starts) {
  presto_assign_starts(flags, a.n, a.out_cap, tile_offsets, starts);
}

__global__ void __launch_bounds__(THREADS)
seg_reduce(const SegArgs a, const int64_t* __restrict__ starts, const int64_t* stats,
           int64_t* __restrict__ first_row) {
  const int64_t groups = stats[0];
  const int64_t live_end = stats[2];
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x / 32);
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
       g < a.out_cap; g += warps) {
    const bool live = g < groups;
    int64_t start = 0, end = 0;
    if (live) {
      start = starts[g];
      end = g + 1 < groups ? starts[g + 1] : live_end;
    }
    presto_reduce_slot(a.comps, a.valid, g, start, end, live, lane, nullptr);
    if (lane == 0) first_row[g] = live ? start : a.n - 1;
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_segment_tile() { return TILE; }

// ORs 1 into flags[i] (zeroed by the caller) where row i's keys of one
// group of at most PRESTO_MAX_KEYS columns differ from row i - 1's.
int presto_segment_key_changes(const int64_t* data, const int64_t* mask, const int32_t* dtypes,
                               int32_t nkeys, int64_t n, void* flags, void* stream) {
  return presto_launch_key_changes(data, mask, dtypes, nkeys, n, 1, flags, stream);
}

// Sorted h1[n], h2[n], keys (as in row_hash.cu: the first group),
// key_changes[n] for the keys past it (or null) and valid[n]; ncomp
// sorted contributions with their out[out_cap] slots, dtype and op
// codes. Writes first_row[out_cap] and stats[3] = {groups,
// overflow, last live row + 1}; stats must be zeroed by the caller.
// Scratch: flags[n] bytes, tiles[ceil(n / TILE)] and starts[out_cap + 1]
// int64s.
int presto_segment_reduce(const void* h1, const void* h2, const int64_t* key_data,
                          const int64_t* key_mask, const int32_t* key_dtypes, int32_t nkeys,
                          const void* key_changes, const void* valid, int64_t n,
                          const int64_t* contrib, const int64_t* out, const int32_t* dtypes, const int32_t* ops,
                          int32_t ncomp, int64_t out_cap, void* first_row,
                          void* stats, void* flags, void* tiles, void* starts, void* stream) {
  SegArgs a;
  if (!presto_fill_keys(&a.keys, key_data, key_mask, key_dtypes, nkeys) ||
      !presto_fill_comps(&a.comps, contrib, out, dtypes, ops, ncomp) || n < 1 || out_cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  a.h1 = static_cast<const int64_t*>(h1);
  a.h2 = static_cast<const int64_t*>(h2);
  a.key_changes = static_cast<const uint8_t*>(key_changes);
  a.valid = static_cast<const bool*>(valid);
  a.n = n;
  a.out_cap = out_cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* st = static_cast<int64_t*>(stats);
  int64_t* tile = static_cast<int64_t*>(tiles);
  const int64_t ntiles = (n + TILE - 1) / TILE;
  if (ntiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  seg_flags<<<static_cast<int>(ntiles), TILE, 0, s>>>(a, static_cast<uint8_t*>(flags), tile, st);
  seg_scan<<<1, TILE, 0, s>>>(tile, ntiles, out_cap, st);
  seg_assign<<<static_cast<int>(ntiles), TILE, 0, s>>>(a, static_cast<const uint8_t*>(flags), tile,
                                                        static_cast<int64_t*>(starts));
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t warps_per_block = THREADS / 32;
  int64_t want = (out_cap + warps_per_block - 1) / warps_per_block;
  int64_t cap = static_cast<int64_t>(sms) * 16;
  int blocks = static_cast<int>(want < cap ? want : cap);
  seg_reduce<<<blocks, THREADS, 0, s>>>(a, static_cast<const int64_t*>(starts), st,
                                        static_cast<int64_t*>(first_row));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
