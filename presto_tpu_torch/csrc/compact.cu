// compact: stable pack of a batch's live rows to the front.
//
// Replaces presto_tpu/batch.py `_compact_jit` (full: live rows first
// in input order, then the dead rows in input order — the
// `ops/common.partition_perm` permutation applied to every column) and
// `_compact_shrink_jit` (shrink: the first `out_cap` live rows into a
// smaller batch; output slots past the live count repeat the input's
// last row with mask False, as `jnp.nonzero(..., fill_value=cap-1)`
// does). The output row order IS the result, so this kernel and its
// plain version must agree exactly.
//
// What bounds it: bytes. Every column's data and mask are read once
// and written once (shrink: only the live rows are written), plus the
// row_valid lane mask; the scan state is a few KB. Design, three
// launches on one stream, no host round trip:
//   1. count: each block counts the live rows of its tile of
//      TILE = THREADS x ITEMS rows with warp ballots + popc;
//   2. scan: ONE block turns the per-tile counts into exclusive offsets
//      (a block-wide scan in chunks of THREADS with a running carry)
//      and writes the total live count;
//   3. scatter: each block recomputes its rows' local ranks the same
//      way (ballot + popc, warp totals through shared memory) and
//      writes every column's element (1, 4 or 8 bytes) and mask to its
//      rank. Live ranks inside a warp are consecutive, so the writes
//      of live rows stay mostly coalesced.
// Making it fast (one persistent block per SM with a decoupled
// look-back scan, vector loads) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_COLS 64
#define THREADS 256
#define ITEMS 4
#define TILE (THREADS * ITEMS)
#define WARPS (THREADS / 32)

struct CompactArgs {
  const void* data[MAX_COLS];
  const bool* mask[MAX_COLS];
  void* out_data[MAX_COLS];
  bool* out_mask[MAX_COLS];
  int32_t width[MAX_COLS];  // element size in bytes: 1, 2, 4 or 8
  int32_t ncols;
  const bool* row_valid;
  bool* out_row_valid;
  int64_t n;        // input rows
  int64_t out_cap;  // output rows
  int32_t shrink;   // 0: full permutation, 1: first out_cap live rows
};

__device__ __forceinline__ void copy_elem(const void* src, void* dst,
                                          int width, int64_t i, int64_t j) {
  switch (width) {
    case 1: static_cast<uint8_t*>(dst)[j] = static_cast<const uint8_t*>(src)[i]; break;
    case 2: static_cast<uint16_t*>(dst)[j] = static_cast<const uint16_t*>(src)[i]; break;
    case 4: static_cast<uint32_t*>(dst)[j] = static_cast<const uint32_t*>(src)[i]; break;
    default: static_cast<uint64_t*>(dst)[j] = static_cast<const uint64_t*>(src)[i]; break;
  }
}

// Exclusive rank of this lane's flag among the block's THREADS lanes
// for one round, and the round's total. All threads must call it.
__device__ __forceinline__ int block_rank(bool flag, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned ballot = __ballot_sync(0xffffffffu, flag);
  int in_warp = __popc(ballot & ((1u << lane) - 1u));
  __syncthreads();  // warp_sums may still be read from the last round
  if (lane == 0) warp_sums[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < WARPS; ++w) {
    int s = warp_sums[w];
    before += w < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + in_warp;
}

__global__ void __launch_bounds__(THREADS)
count_kernel(const bool* row_valid, int64_t n, int32_t* tile_counts) {
  __shared__ int warp_sums[WARPS];
  const int64_t start = static_cast<int64_t>(blockIdx.x) * TILE;
  int count = 0;
  for (int it = 0; it < ITEMS; ++it) {
    int64_t row = start + it * THREADS + threadIdx.x;
    bool live = row < n && row_valid[row];
    int round_total;
    block_rank(live, warp_sums, &round_total);
    count += round_total;
  }
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = count;
}

__global__ void __launch_bounds__(THREADS)
scan_kernel(const int32_t* tile_counts, int32_t ntiles, int32_t* tile_offsets,
            int32_t* total) {
  __shared__ int vals[THREADS];
  int carry = 0;
  for (int base = 0; base < ntiles; base += THREADS) {
    int i = base + threadIdx.x;
    int v = i < ntiles ? tile_counts[i] : 0;
    vals[threadIdx.x] = v;
    __syncthreads();
    // Hillis-Steele inclusive scan over THREADS entries
    for (int off = 1; off < THREADS; off <<= 1) {
      int add = threadIdx.x >= off ? vals[threadIdx.x - off] : 0;
      __syncthreads();
      vals[threadIdx.x] += add;
      __syncthreads();
    }
    if (i < ntiles) tile_offsets[i] = carry + vals[threadIdx.x] - v;
    carry += vals[THREADS - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void __launch_bounds__(THREADS)
scatter_kernel(const CompactArgs a, const int32_t* tile_offsets,
               const int32_t* total_live) {
  __shared__ int warp_sums[WARPS];
  const int64_t start = static_cast<int64_t>(blockIdx.x) * TILE;
  const int64_t live_total = *total_live;
  int64_t live_before = tile_offsets[blockIdx.x];  // live rows before this round
  for (int it = 0; it < ITEMS; ++it) {
    int64_t row = start + it * THREADS + threadIdx.x;
    bool in = row < a.n;
    bool live = in && a.row_valid[row];
    int round_total;
    int rank = block_rank(live, warp_sums, &round_total);
    if (in) {
      int64_t dst;
      if (live) {
        dst = live_before + rank;
      } else {
        // dead rows keep their order after every live row
        int64_t dead_rank = row - (live_before + rank);
        dst = a.shrink ? a.out_cap : live_total + dead_rank;
      }
      if (dst < a.out_cap) {
        for (int c = 0; c < a.ncols; ++c) {
          copy_elem(a.data[c], a.out_data[c], a.width[c], row, dst);
          a.out_mask[c][dst] = live && a.mask[c][row];
        }
        a.out_row_valid[dst] = live;
      }
    }
    live_before += round_total;
  }
  if (!a.shrink) return;
  // shrink: output slots past the live count take the input's last
  // row, masked off (the reference's nonzero fill_value = cap - 1)
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t j = live_total + static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       j < a.out_cap; j += stride) {
    for (int c = 0; c < a.ncols; ++c) {
      copy_elem(a.data[c], a.out_data[c], a.width[c], a.n - 1, j);
      a.out_mask[c][j] = false;
    }
    a.out_row_valid[j] = false;
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_compact_tiles(int64_t n) {
  return static_cast<int>((n + TILE - 1) / TILE);
}

// data/mask/out_data/out_mask/widths are host arrays of ncols device
// pointers (widths: element bytes). scratch is a device int32 buffer
// of 2 * presto_compact_tiles(n) + 1 entries.
int presto_compact(const int64_t* data, const int64_t* mask, const int64_t* out_data,
                   const int64_t* out_mask, const int32_t* widths, int32_t ncols,
                   const void* row_valid, void* out_row_valid, int64_t n,
                   int64_t out_cap, int32_t shrink, void* scratch, void* stream) {
  if (ncols > MAX_COLS || n < 1 || out_cap < 1 || (!shrink && out_cap != n))
    return static_cast<int>(cudaErrorInvalidValue);
  CompactArgs a;
  for (int c = 0; c < ncols; ++c) {
    a.data[c] = reinterpret_cast<const void*>(data[c]);
    a.mask[c] = reinterpret_cast<const bool*>(mask[c]);
    a.out_data[c] = reinterpret_cast<void*>(out_data[c]);
    a.out_mask[c] = reinterpret_cast<bool*>(out_mask[c]);
    a.width[c] = widths[c];
  }
  a.ncols = ncols;
  a.row_valid = static_cast<const bool*>(row_valid);
  a.out_row_valid = static_cast<bool*>(out_row_valid);
  a.n = n;
  a.out_cap = out_cap;
  a.shrink = shrink;

  int ntiles = presto_compact_tiles(n);
  int32_t* tile_counts = static_cast<int32_t*>(scratch);
  int32_t* tile_offsets = tile_counts + ntiles;
  int32_t* total = tile_offsets + ntiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  count_kernel<<<ntiles, THREADS, 0, s>>>(a.row_valid, n, tile_counts);
  scan_kernel<<<1, THREADS, 0, s>>>(tile_counts, ntiles, tile_offsets, total);
  scatter_kernel<<<ntiles, THREADS, 0, s>>>(a, tile_offsets, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
