// compact (K2): stable pack of a batch's live rows to the front.
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
// and written once (shrink: only the live rows are read and written),
// plus row_valid; the scan state is a few KB. At Q6's largest shrink
// (262,144 rows, 2,280 live, 3 columns) that is 0.1 us at 3.35 TB/s:
// the call is launch latency and host time. So it is a single launch,
// a chained scan with a decoupled look-back (lookback.cuh; ticket and
// status words cached per stream by the caller):
//
//   - a block takes a 2048-row tile by ticket; each thread loads eight
//     rows of row_valid as two 32-bit words, counts them with popc, and
//     the block scans the counts;
//   - warp 0 takes the tile's offset among the live rows from the
//     look-back and publishes its inclusive count;
//   - the block writes the tile's permutation into shared memory (its
//     live rows in order, then its dead rows in order) and then copies
//     column by column, consecutive threads on consecutive output rows,
//     so the stores are coalesced and the loads stay inside the tile;
//     a thread's eight loads of a column are all in flight before its
//     first store (a fixed trip count, the ragged end predicated; a
//     loop that stops at the tile's live count leaves a thread with one
//     load in flight at a time in its last rows).
//
// Both modes need the total live count, which only the last tile
// knows: the full mode places each dead row at total + its dead rank,
// the shrink mode fills the slots past the live count. A row tile that
// waited for the last tile could deadlock (blocks spinning on a later
// tile could fill the card before that tile's block is resident). So
// the launch carries tail tiles whose tickets come after every row
// tile: tail tile k waits for the last row tile's inclusive count
// (that block took an earlier ticket, so it runs) and writes row tile
// k's dead rows (full) or fill slots [k * TILE, (k + 1) * TILE)
// (shrink). A row tile that finds the count already published when its
// copy is done writes its own tail from the permutation it holds. Every
// row tile with a tail writes that tail's flag on every call, under the
// call's epoch: 1 where it wrote the tail, 0 where not; a tail tile
// that reads 1 under its own epoch exits at once. (So no flag a call
// leaves behind can stand for a later call's with the same epoch, as
// the calls of a replayed CUDA graph have.) (The same tails as a second
// launch were slower at each of Q6's calls measured on the H100:
// PERF.md, section 6.2.)

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

#define MAX_COLS 64
#define THREADS 256
#define VEC 8
#define TILE (THREADS * VEC)
#define WARPS (THREADS / 32)

typedef unsigned long long u64;

struct CompactArgs {
  const void* data[MAX_COLS];
  const uint8_t* mask[MAX_COLS];
  void* out_data[MAX_COLS];
  uint8_t* out_mask[MAX_COLS];
  int8_t width[MAX_COLS];  // element size in bytes: 1, 2, 4 or 8
  int32_t ncols;
  const uint8_t* row_valid;
  uint8_t* out_row_valid;  // null: another launch of the call writes it
  int64_t n;               // input rows
  int64_t out_cap;         // output rows
  int32_t shrink;          // 0: full permutation, 1: first out_cap live rows
  uint32_t* ticket;
  u64* status;     // the row tiles' look-back words
  u64* done;       // per tail: 1 if its row tile wrote it (this epoch)
  uint32_t epoch;
  uint32_t row_tiles;
  uint32_t tails;  // full: one a row tile (its dead rows); shrink: one a TILE fill slots
  uint32_t tiles;  // row tiles + tail tiles
};

__device__ __forceinline__ void copy_elem(const void* src, void* dst, int width, int64_t i,
                                          int64_t j) {
  switch (width) {
    case 1: static_cast<uint8_t*>(dst)[j] = static_cast<const uint8_t*>(src)[i]; break;
    case 2: static_cast<uint16_t*>(dst)[j] = static_cast<const uint16_t*>(src)[i]; break;
    case 4: static_cast<uint32_t*>(dst)[j] = static_cast<const uint32_t*>(src)[i]; break;
    default: static_cast<uint64_t*>(dst)[j] = static_cast<const uint64_t*>(src)[i]; break;
  }
}

// This thread's VEC rows of row_valid from `row0`, one live bit each.
__device__ __forceinline__ unsigned load_live(const CompactArgs& a, int64_t row0) {
  unsigned bits = 0;
  if (row0 + VEC <= a.n && (reinterpret_cast<uintptr_t>(a.row_valid + row0) & 3) == 0) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a.row_valid + row0);
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const uint32_t x = w[q];
#pragma unroll
      for (int k = 0; k < 4; ++k) bits |= ((x >> (8 * k)) & 0xffu) ? 1u << (4 * q + k) : 0u;
    }
  } else {
    for (int k = 0; k < VEC && row0 + k < a.n; ++k) bits |= a.row_valid[row0 + k] ? 1u << k : 0u;
  }
  return bits;
}

// The block's exclusive scan of the threads' live counts; `*total` gets
// the tile's. Every thread of the block must call it.
__device__ __forceinline__ int scan_live(int cnt, int* total) {
  __shared__ int wsum[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();  // wsum may still be read from an earlier call
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int before = x - cnt, all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    before += w < warp ? wsum[w] : 0;
    all += wsum[w];
  }
  *total = all;
  return before;
}

// The tile's permutation in shared memory: its live rows' tile offsets
// in order at [0, live), its dead rows' at [live, TILE).
__device__ __forceinline__ int tile_order(const CompactArgs& a, int64_t base, uint16_t* order,
                                          int* live_out) {
  const int row = threadIdx.x * VEC;
  const unsigned bits = load_live(a, base + row);
  int live;
  const int lo = scan_live(__popc(bits), &live);
  int li = lo, di = live + row - lo;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    if ((bits >> k) & 1u)
      order[li++] = static_cast<uint16_t>(row + k);
    else
      order[di++] = static_cast<uint16_t>(row + k);
  }
  *live_out = live;
  return lo;
}

// Column elements of one width: rows order[from, to) of the tile at
// `base` into output rows dst0 + j - from, with their masks (ANDed with
// `live`).
template <typename T>
__device__ __forceinline__ void copy_col(const void* src_, void* dst_, const uint8_t* mask,
                                         uint8_t* out_mask, int64_t base, const uint16_t* order,
                                         int from, int to, int64_t dst0, bool live) {
  const T* __restrict__ src = static_cast<const T*>(src_) + base;
  T* __restrict__ dst = static_cast<T*>(dst_) + (dst0 - from);
  const uint8_t* __restrict__ m = mask + base;
  uint8_t* __restrict__ om = out_mask + (dst0 - from);
  // a fixed trip count with the ragged end predicated, so every load of
  // the thread's VEC rows is in flight before the first store
  T v[VEC];
  uint8_t mv[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    const int j = from + q * THREADS + threadIdx.x;
    if (j < to) {
      const int r = order[j];
      v[q] = src[r];
      mv[q] = live ? m[r] : 0;
    }
  }
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    const int j = from + q * THREADS + threadIdx.x;
    if (j < to) {
      dst[j] = v[q];
      om[j] = mv[q];
    }
  }
}

// Rows order[from, to) of the tile at `base` into output rows dst0 + j
// - from: every column's element and mask, and row_valid.
__device__ __forceinline__ void copy_rows(const CompactArgs& a, int64_t base,
                                          const uint16_t* order, int from, int to, int64_t dst0,
                                          bool live) {
  for (int c = 0; c < a.ncols; ++c) {
    switch (a.width[c]) {
      case 1:
        copy_col<uint8_t>(a.data[c], a.out_data[c], a.mask[c], a.out_mask[c], base, order, from,
                          to, dst0, live);
        break;
      case 2:
        copy_col<uint16_t>(a.data[c], a.out_data[c], a.mask[c], a.out_mask[c], base, order,
                           from, to, dst0, live);
        break;
      case 4:
        copy_col<uint32_t>(a.data[c], a.out_data[c], a.mask[c], a.out_mask[c], base, order,
                           from, to, dst0, live);
        break;
      default:
        copy_col<uint64_t>(a.data[c], a.out_data[c], a.mask[c], a.out_mask[c], base, order,
                           from, to, dst0, live);
        break;
    }
  }
  if (a.out_row_valid != nullptr) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const int j = from + q * THREADS + threadIdx.x;
      if (j < to) a.out_row_valid[dst0 + j - from] = live ? 1 : 0;
    }
  }
}

// Output slots [lo, hi): the input's last row, masked off.
__device__ __forceinline__ void fill_rows(const CompactArgs& a, int64_t lo, int64_t hi) {
  for (int c = 0; c < a.ncols; ++c) {
    for (int64_t j = lo + threadIdx.x; j < hi; j += THREADS) {
      copy_elem(a.data[c], a.out_data[c], a.width[c], a.n - 1, j);
      a.out_mask[c][j] = 0;
    }
  }
  if (a.out_row_valid != nullptr)
    for (int64_t j = lo + threadIdx.x; j < hi; j += THREADS) a.out_row_valid[j] = 0;
}

// The tail of tile k once the total live count is known: row tile k's
// dead rows (full: `order` holds the tile's permutation and `before`
// the live rows before it) or the fill slots [k * TILE, (k + 1) * TILE)
// past the live count (shrink).
__device__ __forceinline__ void write_tail(const CompactArgs& a, uint32_t k,
                                           const uint16_t* order, int live, int64_t before,
                                           int64_t total) {
  const int64_t base = static_cast<int64_t>(k) * TILE;
  if (a.shrink) {
    const int64_t lo = base > total ? base : total;
    const int64_t hi = base + TILE < a.out_cap ? base + TILE : a.out_cap;
    if (lo < hi) fill_rows(a, lo, hi);
    return;
  }
  const int rows = a.n - base < TILE ? static_cast<int>(a.n - base) : TILE;
  // dead rows before this tile: its first row less the live rows before it
  copy_rows(a, base, order, live, rows, total + base - before, false);
}

// Tail tile k: unless row tile k flagged its tail written under this
// call's epoch, wait for the total live count (every row tile took its
// ticket before this one, so the last one runs) and write it. (A flag
// of 0, or one not yet written, leaves it to this tile; where both
// write, they write the same rows.)
__device__ __forceinline__ void tail_tile(const CompactArgs& a, uint32_t k, uint16_t* order) {
  __shared__ uint32_t counts[3];  // tail already written, all live rows, live rows before tile k
  if (threadIdx.x < 32) {
    u64 d = 0;
    if (threadIdx.x == 0) d = *reinterpret_cast<const volatile u64*>(a.done + k);
    d = __shfl_sync(0xffffffffu, d, 0);
    const bool done = static_cast<uint32_t>(d >> 34) == a.epoch && static_cast<uint32_t>(d) == 1;
    uint32_t total = 0, before = 0;
    if (!done) {
      total = presto_lb_wait_inclusive(a.status, a.row_tiles - 1, a.epoch);
      if (!a.shrink && k > 0) before = presto_lb_wait_inclusive(a.status, k - 1, a.epoch);
    }
    if (threadIdx.x == 0) {
      counts[0] = done;
      counts[1] = total;
      counts[2] = before;
    }
  }
  __syncthreads();
  if (counts[0]) return;
  int live = 0;
  if (!a.shrink) {
    tile_order(a, static_cast<int64_t>(k) * TILE, order, &live);
    __syncthreads();
  }
  write_tail(a, k, order, live, counts[2], counts[1]);
}

__global__ void __launch_bounds__(THREADS) compact_tiles(const CompactArgs a) {
  __shared__ uint16_t order[TILE];
  __shared__ uint32_t before_tile;
  __shared__ int64_t total_now;
  const uint32_t t = presto_lb_ticket(a.ticket, a.tiles);
  if (t >= a.row_tiles) {
    tail_tile(a, t - a.row_tiles, order);
    return;
  }
  const int64_t base = static_cast<int64_t>(t) * TILE;
  int live;
  tile_order(a, base, order, &live);
  if (threadIdx.x < 32) {
    const uint32_t prefix = presto_lb_prefix(a.status, t, a.epoch, static_cast<uint32_t>(live));
    if (threadIdx.x == 0) before_tile = prefix;
  }
  __syncthreads();
  const int64_t dst0 = before_tile;
  // shrink: only the live rows that fit
  const int64_t room = a.shrink ? a.out_cap - dst0 : live;
  const int to = room < live ? static_cast<int>(room < 0 ? 0 : room) : live;
  copy_rows(a, base, order, 0, to, dst0, true);
  // The tile's tail now, while its permutation is in shared memory, if
  // the total live count is published by now (one look, no wait: blocks
  // polling one word slow the look-back that publishes it); its tail
  // tile then finds it flagged and exits. The flag is written either
  // way.
  if (t >= a.tails) return;
  if (threadIdx.x == 0) {
    const u64 v = *reinterpret_cast<const volatile u64*>(a.status + a.row_tiles - 1);
    total_now = static_cast<uint32_t>(v >> 34) == a.epoch &&
                        ((v >> 32) & 3ULL) == PRESTO_LB_INCLUSIVE
                    ? static_cast<int64_t>(static_cast<uint32_t>(v))
                    : -1;
  }
  __syncthreads();
  const bool wrote = total_now >= 0;
  if (wrote) write_tail(a, t, order, live, dst0, total_now);
  if (threadIdx.x == 0)
    *reinterpret_cast<volatile u64*>(a.done + t) =
        presto_lb_word(a.epoch, PRESTO_LB_INCLUSIVE, wrote ? 1u : 0u);
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_compact_tile() { return TILE; }

// desc (host, int64): row_valid, out_row_valid (0: not written by this
// launch), then per column its data, mask, out_data, out_mask and
// element bytes. ticket: one uint32, 0 between calls; status:
// status_words >= ceil(n / TILE) + the tails (as many again, or
// ceil(out_cap / TILE) to shrink) uint64 whose epochs are not `epoch`;
// epoch: 1 .. 2^30 - 1, new for every call on the stream. One launch.
int presto_compact(const int64_t* desc, int32_t ncols, int64_t n, int64_t out_cap,
                   int32_t shrink, void* ticket, void* status, int64_t status_words,
                   uint32_t epoch, void* stream) {
  const int64_t row_tiles = (n + TILE - 1) / TILE;
  if (ncols < 0 || ncols > MAX_COLS || n < 1 || n > 0x7fffffffLL || out_cap < 1 ||
      (!shrink && out_cap != n) || epoch == 0 || epoch > 0x3fffffffu)
    return static_cast<int>(cudaErrorInvalidValue);
  // full: one tail a row tile (its dead rows); shrink: one a TILE fill
  // slots
  const int64_t tails = shrink ? (out_cap + TILE - 1) / TILE : row_tiles;
  if (status_words < row_tiles + tails) return static_cast<int>(cudaErrorInvalidValue);
  CompactArgs a;
  a.row_valid = reinterpret_cast<const uint8_t*>(desc[0]);
  a.out_row_valid = reinterpret_cast<uint8_t*>(desc[1]);
  for (int c = 0; c < ncols; ++c) {
    const int64_t* d = desc + 2 + 5 * c;
    a.data[c] = reinterpret_cast<const void*>(d[0]);
    a.mask[c] = reinterpret_cast<const uint8_t*>(d[1]);
    a.out_data[c] = reinterpret_cast<void*>(d[2]);
    a.out_mask[c] = reinterpret_cast<uint8_t*>(d[3]);
    a.width[c] = static_cast<int8_t>(d[4]);
  }
  a.ncols = ncols;
  a.n = n;
  a.out_cap = out_cap;
  a.shrink = shrink;
  a.ticket = static_cast<uint32_t*>(ticket);
  a.status = static_cast<u64*>(status);
  a.epoch = epoch;
  a.done = a.status + row_tiles;
  a.row_tiles = static_cast<uint32_t>(row_tiles);
  a.tails = static_cast<uint32_t>(tails);
  a.tiles = static_cast<uint32_t>(row_tiles + tails);
  compact_tiles<<<a.tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
