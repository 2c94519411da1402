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
//     Two launches:
//     - `expand_count`, one row a thread: the emit counts' exclusive
//       scan in one pass, a chained scan with a decoupled look-back
//       (lookback.cuh, as K27's), gives each row its first slot (`cum`,
//       saturated at 2^32 - 1). A left join's row also reads its
//       candidates inside the capacity until one verifies: a row with
//       none keeps one slot with a NULL build side (`unmatched`; the
//       composed form index_add_-ed a per-slot flag back onto the probe
//       rows). Each row writes, for the write launch's blocks that
//       start in its run, its index (`split`), and the last row writes
//       `stats`.
//     - `expand_slots`: the sequence of probe rows and output slots, a
//       row placed just before its first slot, is cut into blocks of
//       NV items (a merge path of the slots against the rows' offsets,
//       the load-balanced search of K19's merge path, whose splits the
//       count pass wrote). A block stages its rows' offsets, candidates
//       and flags in shared memory, each slot finds its row there by a
//       binary search, and then, column by column, consecutive threads
//       write consecutive slots: probe columns from the row, build
//       columns from candidate lo + k (contiguous within a run),
//       verified by hash2 (when the search did not check it) or by the
//       key columns. Slots from the total up to the capacity are
//       written dead in the same launch (a block with no live slot
//       zeroes its ranges 16 bytes a store). A row with zero emit costs
//       one item, so a block's work is bounded however skewed the runs
//       are.
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
// per probe row (twice: once a launch), and each row's offset written
// and read. Full mode adds one byte per verified slot.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather.cuh"
#include "lookback.cuh"
#include "probe_search.cuh"
#include "segment.cuh"

// rows of an aligned or count-pass block (one a thread)
#define TILE PRESTO_SEG_TILE
// the write launch: threads, items (rows or slots) a thread, a block
#define THREADS 256
#define ITEMS 4
#define NV (THREADS * ITEMS)
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

// stats: [0] total slots wanted (saturated), [1] overflow, [2] live
// slots, [3] the last row's place in the sequence of rows and slots
__global__ void __launch_bounds__(TILE)
expand_count(const ExpandArgs a, int64_t* __restrict__ cum, uint8_t* __restrict__ unmatched,
             int64_t* __restrict__ split, int64_t nsplit, int64_t* __restrict__ stats,
             uint32_t* ticket, unsigned long long* status, uint32_t epoch, uint32_t ntiles) {
  __shared__ uint32_t before_tile;
  const uint32_t t = presto_lb_ticket(ticket, ntiles);
  const int64_t i = static_cast<int64_t>(t) * TILE + threadIdx.x;
  int64_t lo = 0, counts = 0, emit = 0;
  if (i < a.n) row_counts(a, i, &lo, &counts, &emit);
  if (emit > static_cast<int64_t>(PRESTO_LB_MAX)) emit = PRESTO_LB_MAX;
  int64_t total;
  const int64_t excl = block_exclusive_scan(emit, &total);
  if (threadIdx.x < 32) {
    const uint32_t prefix = presto_lb_prefix(status, t, epoch, presto_lb_sat(total));
    if (threadIdx.x == 0) before_tile = prefix;
  }
  __syncthreads();
  if (i >= a.n) return;
  const int64_t sat = static_cast<int64_t>(PRESTO_LB_MAX);
  const int64_t c = static_cast<int64_t>(presto_lb_sat(before_tile + excl));
  const int64_t end = c + emit < sat ? c + emit : sat;
  cum[i] = c;
  if (a.left) {
    // no verified candidate among the row's slots inside the capacity
    bool none = a.row_valid[i];
    const int64_t fit = a.out_cap - c;
    const int64_t m = counts < fit ? counts : fit;
    const int64_t last_build = a.nbuild - 1;
    for (int64_t k = 0; k < m && none; ++k)
      if (verify_candidate(a, i, lo + k < last_build ? lo + k : last_build)) none = false;
    unmatched[i] = none ? 1 : 0;
  }
  // row i's place among rows and slots, and the next row's
  const int64_t place = i + (c < a.out_cap ? c : a.out_cap);
  if (i == a.n - 1) {
    stats[0] = end;
    stats[1] = end > a.out_cap ? 1 : 0;
    stats[2] = 0;
    stats[3] = place;
    return;
  }
  const int64_t next = i + 1 + (end < a.out_cap ? end : a.out_cap);
  // the write blocks whose first item lies in (place, next] start after row i
  for (int64_t b = place / NV + 1; b * NV <= next && b < nsplit; ++b) split[b] = i + 1;
}

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) { return x < y ? x : y; }

// Bytes [lo, hi) of p zeroed by the block, 16 at a time where aligned
// (every output array starts 16-byte aligned).
__device__ __forceinline__ void zero_bytes(void* p, int64_t lo, int64_t hi) {
  uint8_t* b = static_cast<uint8_t*>(p);
  const int64_t a = min64((lo + 15) & ~int64_t(15), hi);
  const int64_t z = hi & ~int64_t(15);
  for (int64_t x = lo + threadIdx.x; x < a; x += THREADS) b[x] = 0;
  uint4* v = reinterpret_cast<uint4*>(b);
  for (int64_t x = a / 16 + threadIdx.x; x < z / 16; x += THREADS) v[x] = make_uint4(0, 0, 0, 0);
  for (int64_t x = (z > a ? z : a) + threadIdx.x; x < hi; x += THREADS) b[x] = 0;
}

template <typename T>
__device__ __forceinline__ void write_column(const ExpandArgs& a, int c, const int64_t (&slot)[ITEMS],
                                             const int64_t (&row)[ITEMS],
                                             const int64_t (&brow)[ITEMS],
                                             const uint8_t (&flag)[ITEMS]) {
  const bool build = a.cols.side[c] != 0;
  const T* __restrict__ src = static_cast<const T*>(a.cols.src[c]);
  const bool* __restrict__ src_mask = a.cols.src_mask[c];
  T* __restrict__ dst = static_cast<T*>(a.cols.dst[c]);
  bool* __restrict__ dst_mask = a.cols.dst_mask[c];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t s = slot[k];
    if (s < 0) continue;
    if (row[k] >= 0) {
      const int64_t r = build ? brow[k] : row[k];
      dst[s] = src[r];
      // flag bit 0: verified, bit 1: live
      dst_mask[s] = src_mask[r] && ((flag[k] >> (build ? 0 : 1)) & 1);
    } else {
      dst[s] = T(0);
      dst_mask[s] = false;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
expand_slots(const ExpandArgs a, const int64_t* __restrict__ cum,
             const uint8_t* __restrict__ unmatched, const int64_t* __restrict__ split,
             int64_t* __restrict__ stats) {
  __shared__ int64_t s_cum[NV + 1];
  __shared__ int64_t s_lo[NV + 1];
  __shared__ int64_t s_cnt[NV + 1];
  __shared__ int64_t s_h2[NV + 1];
  __shared__ uint8_t s_un[NV + 1];
  const int64_t items = a.n + a.out_cap;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * NV;
  const int64_t d1 = min64(d0 + NV, items);
  const int64_t last_place = stats[3];
  const int64_t i0 = d0 == 0 ? 0 : (d0 > last_place ? a.n : split[blockIdx.x]);
  const int64_t i1 = d1 > last_place ? a.n : split[blockIdx.x + 1];
  const int64_t j0 = d0 - i0, j1 = d1 - i1;  // the block's slots
  const int64_t filled = min64(stats[0], a.out_cap);
  if (j0 >= filled) {
    // every slot of the block is dead: zeros in whole 16-byte stores
    zero_bytes(a.live, j0, j1);
    for (int c = 0; c < a.cols.ncols; ++c) {
      zero_bytes(a.cols.dst[c], j0 * a.cols.size[c], j1 * a.cols.size[c]);
      zero_bytes(a.cols.dst_mask[c], j0, j1);
    }
    return;
  }
  const int64_t r0 = i0 > 0 ? i0 - 1 : 0;    // rows staged: [r0, i1)
  const int nrows = static_cast<int>(i1 - r0);
  const bool h2_check = !a.verify_full && a.probe_h2 != nullptr;
  for (int q = threadIdx.x; q < nrows; q += THREADS) {
    const int64_t r = r0 + q;
    const int64_t enc = a.lo_enc[r];
    s_cum[q] = cum[r];
    s_lo[q] = enc > 0 ? enc : 0;
    s_cnt[q] = enc >= 0 ? a.run_len[enc] : 0;
    s_un[q] = a.left ? unmatched[r] : 0;
    if (h2_check) s_h2[q] = a.probe_h2[r];
  }
  __syncthreads();
  const int64_t last_build = a.nbuild - 1;
  int64_t slot[ITEMS], row[ITEMS], brow[ITEMS];
  uint8_t flag[ITEMS];
  int live_n = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t s = j0 + threadIdx.x + k * THREADS;
    slot[k] = s < j1 ? s : -1;
    row[k] = -1;
    brow[k] = 0;
    flag[k] = 0;
    if (s >= j1 || s >= filled) continue;
    // the last staged row whose first slot is at or before s
    int lo = 0, hi = nrows;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (s_cum[mid] <= s) lo = mid;
      else hi = mid;
    }
    const int64_t p = r0 + lo;
    const int64_t kk = s - s_cum[lo];
    const int64_t b = s_lo[lo] + kk < last_build ? s_lo[lo] + kk : last_build;
    bool verified = false;
    if (kk < s_cnt[lo]) {
      if (a.verify_full) verified = presto_keys_match(a.probe_keys, p, a.build_keys, b);
      else verified = !h2_check || s_h2[lo] == a.build_hash2[b];
    }
    const bool live = verified || (kk == 0 && s_un[lo] != 0);
    row[k] = p;
    brow[k] = b;
    flag[k] = static_cast<uint8_t>((verified ? 1 : 0) | (live ? 2 : 0));
    live_n += live ? 1 : 0;
    if (a.matched != nullptr && verified) a.matched[b] = true;
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if (slot[k] >= 0) a.live[slot[k]] = (flag[k] & 2) != 0;
  for (int c = 0; c < a.cols.ncols; ++c) {
    switch (a.cols.size[c]) {
      case 1: write_column<uint8_t>(a, c, slot, row, brow, flag); break;
      case 2: write_column<uint16_t>(a, c, slot, row, brow, flag); break;
      case 4: write_column<uint32_t>(a, c, slot, row, brow, flag); break;
      default: write_column<uint64_t>(a, c, slot, row, brow, flag); break;
    }
  }
  const int64_t total = block_sum(live_n);
  if (threadIdx.x == 0 && total > 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(stats + 2),
              static_cast<unsigned long long>(total));
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_expand_tile() { return TILE; }

int presto_expand_items() { return NV; }

// lo_enc[n] from K5 and the probe's row_valid[n]; the build's run_len
// and hash2[nbuild >= 1]; probe_h2[n] or null; probe and build key columns
// (nkeys each, flat, as presto_fill_key_groups takes them;
// read under verify_full only); ncols output columns
// (src data/mask, dst data/mask — dst data null for an aligned probe
// column — element size and side); matched[nbuild] (full mode, which
// needs left) or null. Writes live[out_cap], sets matched[brow] for every
// verified slot and writes `stats`: aligned, stats[0] = live slots
// (zeroed by the caller); general, stats[0..3] = {total slots
// (saturated at 2^32 - 1), overflow, live slots, the last row's place}.
// General only: scratch of n + ceil((n + out_cap) / NV) + 1 int64s and
// n bytes; ticket, status (ceil(n / TILE) words) and epoch as K27 takes
// them. Reads nothing back.
int presto_join_expand(int32_t aligned, const void* lo_enc, const void* row_valid, int64_t n,
                       const void* run_len, const void* build_hash2, const void* probe_h2,
                       int64_t nbuild, int32_t left, int32_t verify_full,
                       const int64_t* pkey_data, const int64_t* pkey_mask,
                       const int32_t* pkey_dtypes, const int64_t* bkey_data,
                       const int64_t* bkey_mask, const int32_t* bkey_dtypes, int32_t nkeys,
                       const int64_t* src, const int64_t* src_mask, const int64_t* dst,
                       const int64_t* dst_mask, const int32_t* sizes, const int32_t* sides,
                       int32_t ncols, void* live, int64_t out_cap, void* stats, void* scratch,
                       void* ticket, void* status, uint32_t epoch, void* matched,
                       void* stream) {
  ExpandArgs a;
  if (!presto_fill_cols(&a.cols, src, src_mask, dst, dst_mask, sizes, sides, ncols) || n < 1 ||
      n > 0x7fffffffLL || out_cap < 1 || out_cap > 0x7fffffffLL || nbuild < 1 ||
      (aligned && out_cap != n) || (matched != nullptr && !left))
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
  if (aligned) {
    expand_aligned<<<static_cast<int>(ntiles), TILE, 0, s>>>(
        a, reinterpret_cast<unsigned long long*>(st));
    return static_cast<int>(cudaGetLastError());
  }
  if (epoch == 0 || epoch > 0x3fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + out_cap + NV - 1) / NV;
  int64_t* cum = static_cast<int64_t*>(scratch);
  int64_t* split = cum + n;
  uint8_t* unmatched = reinterpret_cast<uint8_t*>(split + blocks + 1);
  expand_count<<<static_cast<unsigned>(ntiles), TILE, 0, s>>>(
      a, cum, unmatched, split, blocks + 1, st, static_cast<uint32_t*>(ticket),
      static_cast<unsigned long long*>(status), epoch, static_cast<uint32_t>(ntiles));
  expand_slots<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(a, cum, unmatched, split, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
