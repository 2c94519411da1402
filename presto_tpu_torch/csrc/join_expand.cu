// join_expand (K9): the expansion of a hash-join probe after K5's
// search, in both layouts, for inner, left and full joins.
//
// Replaces presto_tpu/ops/join.py `_expand_dispatch` (:540) with
// `_expand_aligned` (:578) and `_expand_general` (:609), the rest of
// family join_probe after the search (operators/join_ops.py
// `make_probe_kernel`), and the matched-flag fold of `_expand_from_enc`
// (:548-577) behind `probe_join_full` (:506):
//   * ALIGNED (every build hash run has length 1 and the output capacity
//     is the probe capacity): output slot i is probe row i. One thread
//     per row verifies its candidate (lo_enc >= 0; under verify="full"
//     also the key columns, `presto_keys_match`), gathers every build
//     column's data and mask at the candidate row under the verified
//     mask, and ANDs the probe columns' masks with the slot's liveness
//     (a left or full join keeps every live probe row, an inner join the
//     verified ones). Where the composed form issues two torch gathers
//     per column, this is one pass.
//   * GENERAL (duplicate-key builds, or an output capacity that is a
//     multiple of the probe's): per probe row emit = its candidate run
//     length (a left or full join emits at least one slot per live row).
//     Then an exclusive scan of the emit counts (per-tile sums, one block
//     over the tiles, a block scan per tile: K2's shape) gives each row
//     its first output slot, and the row's thread writes its own slots
//     [cum, cum + emit) clipped at the capacity: probe columns from the
//     row, build columns from candidate lo + k, verified by hash2 (when
//     the search did not check it) or by the key columns. A left join's
//     row with no verified candidate among its slots inside the
//     capacity keeps one slot with a NULL build side: the thread counts
//     its verified candidates itself, where the composed form
//     index_add_-ed a per-slot flag back onto the probe rows. Slots from
//     the total up to the capacity are written dead.
//   * FULL mode (either layout): what a left join emits, and besides a
//     store of 1 into matched[brow] for every verified slot, the running
//     per-build-row flags the outer tail (K11, join_outer.cu) reads.
//     Every writer stores the same value, so a plain byte store is
//     race-free and needs no atomic.
// The overflow flag (total > capacity) and the live-slot count stay on
// the device, as the operator's deferred check reads them.
//
// What bounds it: bytes. Aligned: per row lo_enc, row_valid and the
// probe masks read and written once, each build column's data and mask
// gathered once (random rows of the build) and written once. General:
// the same per output slot, plus lo_enc, row_valid and the run lengths
// per probe row. Under Q13's skew a thread writes dozens of slots: its
// writes are contiguous, but the warp's are not coalesced. Full mode
// adds one byte per verified slot.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather.cuh"
#include "probe_search.cuh"
#include "segment.cuh"

#define TILE PRESTO_SEG_TILE
#define THREADS 256
// Output columns of both sides (gather.cuh `Cols`): a probe column's
// value comes from the probe row, a build column's from the candidate
// row. dst is null for an aligned probe column, whose data passes
// through.

struct ExpandArgs {
  const int64_t* lo_enc;
  const bool* row_valid;
  int64_t n;  // probe rows
  const int64_t* run_len;
  const int64_t* build_hash2;
  const int64_t* probe_h2;  // null: the search already checked hash2
  int64_t nbuild;
  bool left;
  bool verify_full;
  KeyGroups probe_keys;
  KeyGroups build_keys;
  Cols cols;
  bool* live;
  int64_t out_cap;
  bool* matched;  // full mode: per build row, set where a slot verified
};

// Slot s gets probe row p and build row brow.
__device__ __forceinline__ void write_slot(const ExpandArgs& a, int64_t s, int64_t p,
                                           int64_t brow, bool verified, bool live) {
  a.live[s] = live;
  for (int c = 0; c < a.cols.ncols; ++c) {
    const bool build = a.cols.side[c] != 0;
    const int64_t r = build ? brow : p;
    if (a.cols.dst[c] != nullptr) copy_elem(a.cols.src[c], r, a.cols.dst[c], s, a.cols.size[c]);
    a.cols.dst_mask[c][s] = a.cols.src_mask[c][r] && (build ? verified : live);
  }
}

__device__ __forceinline__ int64_t block_sum(int64_t v) {
  int64_t total;
  block_exclusive_scan(v, &total);
  return total;
}

// -- aligned ---------------------------------------------------------------

__global__ void __launch_bounds__(TILE)
expand_aligned(const ExpandArgs a, unsigned long long* __restrict__ live_count) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x;
  int64_t live_n = 0;
  if (i < a.n) {
    const int64_t enc = a.lo_enc[i];
    bool verified = enc >= 0;
    const int64_t brow = enc > 0 ? enc : 0;
    if (verified && a.verify_full)
      verified = presto_keys_match(a.probe_keys, i, a.build_keys, brow);
    const bool live = a.left ? a.row_valid[i] : verified;
    write_slot(a, i, i, brow, verified, live);
    if (a.matched != nullptr && verified) a.matched[brow] = true;
    live_n = live ? 1 : 0;
  }
  const int64_t total = block_sum(live_n);
  if (threadIdx.x == 0 && total > 0)
    atomicAdd(live_count, static_cast<unsigned long long>(total));
}

// -- general ---------------------------------------------------------------

// Candidate count and emitted slots of probe row i.
__device__ __forceinline__ void row_counts(const ExpandArgs& a, int64_t i, int64_t* lo,
                                           int64_t* counts, int64_t* emit) {
  const int64_t enc = a.lo_enc[i];
  *lo = enc > 0 ? enc : 0;
  *counts = enc >= 0 ? a.run_len[enc] : 0;
  int64_t e = *counts;
  if (a.left) e = a.row_valid[i] ? (e > 0 ? e : 1) : 0;
  *emit = e;
}

__device__ __forceinline__ bool verify_candidate(const ExpandArgs& a, int64_t p, int64_t brow) {
  if (a.verify_full) return presto_keys_match(a.probe_keys, p, a.build_keys, brow);
  return a.probe_h2 == nullptr || a.probe_h2[p] == a.build_hash2[brow];
}

__global__ void __launch_bounds__(TILE)
expand_count(const ExpandArgs a, int64_t* __restrict__ tile_sums) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x;
  int64_t lo, counts, emit = 0;
  if (i < a.n) row_counts(a, i, &lo, &counts, &emit);
  const int64_t total = block_sum(emit);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// stats: [0] total slots wanted, [1] overflow, [2] live slots
__global__ void __launch_bounds__(TILE)
expand_scan(int64_t* __restrict__ tile_sums, int64_t ntiles, int64_t out_cap,
            int64_t* __restrict__ stats) {
  const int64_t total = presto_scan_tiles(tile_sums, ntiles);
  if (threadIdx.x == 0) {
    stats[0] = total;
    stats[1] = total > out_cap ? 1 : 0;
  }
}

__global__ void __launch_bounds__(TILE)
expand_write(const ExpandArgs a, const int64_t* __restrict__ tile_offsets,
             int64_t* __restrict__ stats) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x;
  int64_t lo = 0, counts = 0, emit = 0;
  if (i < a.n) row_counts(a, i, &lo, &counts, &emit);
  int64_t unused;
  const int64_t cum = tile_offsets[blockIdx.x] + block_exclusive_scan(emit, &unused);
  int64_t live_n = 0;
  if (emit > 0 && cum < a.out_cap) {
    const int64_t fit = a.out_cap - cum < emit ? a.out_cap - cum : emit;
    const int64_t last_build = a.nbuild - 1;
    bool unmatched = false;
    if (a.left) {
      // no verified candidate among the row's slots inside the capacity
      const int64_t m = counts < fit ? counts : fit;
      unmatched = a.row_valid[i];
      for (int64_t k = 0; k < m && unmatched; ++k) {
        const int64_t brow = lo + k < last_build ? lo + k : last_build;
        if (verify_candidate(a, i, brow)) unmatched = false;
      }
    }
    for (int64_t k = 0; k < fit; ++k) {
      const int64_t brow = lo + k < last_build ? lo + k : last_build;
      const bool verified = k < counts && verify_candidate(a, i, brow);
      const bool live = verified || (unmatched && k == 0);
      write_slot(a, cum + k, i, brow, verified, live);
      if (a.matched != nullptr && verified) a.matched[brow] = true;
      live_n += live ? 1 : 0;
    }
  }
  const int64_t total = block_sum(live_n);
  if (threadIdx.x == 0 && total > 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(stats + 2),
              static_cast<unsigned long long>(total));
}

// Slots from the total up to the capacity: dead, NULL, zero.
__global__ void __launch_bounds__(THREADS)
expand_fill(const ExpandArgs a, const int64_t* __restrict__ stats) {
  const int64_t total = stats[0];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = (total < a.out_cap ? total : a.out_cap) +
                   static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       s < a.out_cap; s += stride) {
    a.live[s] = false;
    for (int c = 0; c < a.cols.ncols; ++c) {
      zero_elem(a.cols.dst[c], s, a.cols.size[c]);
      a.cols.dst_mask[c][s] = false;
    }
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_expand_tile() { return TILE; }

// lo_enc[n] from K5 and the probe's row_valid[n]; the build's run_len
// and hash2[nbuild >= 1]; probe_h2[n] or null; probe and build key columns
// (nkeys each, flat, up to PRESTO_MAX_KEYS * PRESTO_MAX_KEY_GROUPS; read
// under verify_full only); ncols output columns
// (src data/mask, dst data/mask — dst data null for an aligned probe
// column — element size and side); matched[nbuild] (full mode, which
// needs left) or null. Writes live[out_cap], sets matched[brow] for every
// verified slot and, through `stats` (zeroed by the caller): aligned,
// stats[0] = live slots;
// general, stats = {total slots, overflow, live slots}.
// Scratch (general only): tiles[ceil(n / TILE)] int64s.
int presto_join_expand(int32_t aligned, const void* lo_enc, const void* row_valid, int64_t n,
                       const void* run_len, const void* build_hash2, const void* probe_h2,
                       int64_t nbuild, int32_t left, int32_t verify_full,
                       const int64_t* pkey_data, const int64_t* pkey_mask,
                       const int32_t* pkey_dtypes, const int64_t* bkey_data,
                       const int64_t* bkey_mask, const int32_t* bkey_dtypes, int32_t nkeys,
                       const int64_t* src, const int64_t* src_mask, const int64_t* dst,
                       const int64_t* dst_mask, const int32_t* sizes, const int32_t* sides,
                       int32_t ncols, void* live, int64_t out_cap, void* stats, void* tiles,
                       void* matched, void* stream) {
  ExpandArgs a;
  if (!presto_fill_cols(&a.cols, src, src_mask, dst, dst_mask, sizes, sides, ncols) || n < 1 ||
      out_cap < 1 || nbuild < 1 || (aligned && out_cap != n) || (matched != nullptr && !left))
    return static_cast<int>(cudaErrorInvalidValue);
  if (verify_full) {
    if (!presto_fill_key_groups(&a.probe_keys, pkey_data, pkey_mask, pkey_dtypes, nkeys) ||
        !presto_fill_key_groups(&a.build_keys, bkey_data, bkey_mask, bkey_dtypes, nkeys))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    a.probe_keys.ngroups = 0;
    a.build_keys.ngroups = 0;
  }
  a.lo_enc = static_cast<const int64_t*>(lo_enc);
  a.row_valid = static_cast<const bool*>(row_valid);
  a.n = n;
  a.run_len = static_cast<const int64_t*>(run_len);
  a.build_hash2 = static_cast<const int64_t*>(build_hash2);
  a.probe_h2 = static_cast<const int64_t*>(probe_h2);
  a.nbuild = nbuild;
  a.left = left != 0;
  a.verify_full = verify_full != 0;
  for (int c = 0; c < ncols; ++c)
    if (a.cols.dst[c] == nullptr && (!aligned || sides[c] != 0))
      return static_cast<int>(cudaErrorInvalidValue);
  a.live = static_cast<bool*>(live);
  a.out_cap = out_cap;
  a.matched = static_cast<bool*>(matched);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* st = static_cast<int64_t*>(stats);
  const int64_t ntiles = (n + TILE - 1) / TILE;
  if (ntiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (aligned) {
    expand_aligned<<<static_cast<int>(ntiles), TILE, 0, s>>>(
        a, reinterpret_cast<unsigned long long*>(st));
    return static_cast<int>(cudaGetLastError());
  }
  int64_t* tile = static_cast<int64_t*>(tiles);
  expand_count<<<static_cast<int>(ntiles), TILE, 0, s>>>(a, tile);
  expand_scan<<<1, TILE, 0, s>>>(tile, ntiles, out_cap, st);
  expand_write<<<static_cast<int>(ntiles), TILE, 0, s>>>(a, tile, st);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t want = (out_cap + THREADS - 1) / THREADS;
  int64_t cap = static_cast<int64_t>(sms) * 16;
  int blocks = static_cast<int>(want < cap ? want : cap);
  expand_fill<<<blocks, THREADS, 0, s>>>(a, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
