// segment_reduce (K6): the grouping arithmetic of the sort-based
// aggregation, over rows already sorted by their (h1, h2) row hashes.
//
// Replaces presto_tpu/ops/hashagg.py `_group_reduce` after its sort
// (:624-666): `common.boundaries(..., hashes=(h1, h2))`, the packed
// group ids `gid = cumsum(bnd) - 1`, `_sorted_reduce` of every state
// component into out_cap slots (:535), `_first_rows` (:516) and the
// overflow flag (groups > out_cap). The group ids stay internal: the
// caller reads only the slots, the first rows, the stats and each
// group's first row (`starts`, which K30 reads), so no per-row id
// column is written. A row starts a group when it is live and the row
// before it is dead, or its h1, h2 or any key differs from that row's
// (two NULLs compare equal; a float NaN differs from itself, as the
// reference's `!=`). Keys come in groups of at most PRESTO_MAX_KEYS
// columns (row_hash.cuh `KeyGroups`), so one launch compares any
// number of them.
//
// What bounds it: bytes. h1, h2, the keys and row_valid are read once
// for the boundaries (a row's predecessor is the neighbour lane's, an L1
// hit), every component's contribution once for the reduction; out_cap
// slots per component, the first rows and the starts are written once.
// At Q20's call (2,097,152 rows, 562,141 groups, out_cap 1,048,576) that
// is ~132 MB, 39 us at 3.35 TB/s. Its groups hold 1.25 live rows on
// average, so a warp a slot would leave 31 lanes idle and store each
// slot from a warp of its own. Two launches:
//
//   1. seg_ids: a 1024-row tile per block, tiles by ticket. Each thread
//      takes four rows strided by the block (so neighbouring lanes read
//      neighbouring rows), flags the rows that start a group, and the
//      ballots of the flags give each start its rank in the tile. The
//      tile's group offset comes from the chained scan of lookback.cuh
//      (status words and ticket cached per stream by the caller), and
//      every start g <= out_cap writes starts[g]. Each tile also
//      publishes the end of its last live row under the call's epoch;
//      the last tile takes the largest from there (looking back only
//      past tiles with no live row) and writes stats = {groups,
//      overflow, last live row + 1, live groups}.
//   2. seg_slots: one output slot per thread, consecutive threads on
//      consecutive slots, so every component, the first row and every
//      slot past the group count (the identity, first row n - 1) is a
//      coalesced store. A thread folds its group's rows in row order
//      when the group has at most THREAD_ROWS rows; a longer group
//      goes to its warp (lanes strided over the rows, a shuffle tree)
//      up to WARP_ROWS rows, and past that to the whole block (its
//      threads strided, a tree over the warps), so one long group never
//      serialises a thread. One block alone still crawls over a group
//      of a million rows (4.7 ms at 900,000 live rows on the H100, the
//      latency of one SM), so seg_ids also reduces every tile in which
//      no group starts (all its live rows continue the group before it)
//      into one partial a component, a block tree like the rest; the
//      block tier reads a long group's whole tiles as those partials
//      and only its first and last partial tile as rows. Which tier
//      reduces a group depends on its row count alone, and each tier
//      adds in a fixed order (a tile's partial, then the partials in
//      tile order): the same inputs give the same bits on every run (no
//      atomics). Integer sums wrap like the reference's int64
//      segment_sum; min and max let a NaN win.
//
// Row ids and counts are 32-bit in the look-back (the caller refuses
// 2^31 rows or more).

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"
#include "segment.cuh"

#define ID_THREADS 256
#define ID_ITEMS 4
#define ID_TILE (ID_THREADS * ID_ITEMS)
#define ID_WARPS (ID_THREADS / 32)
#define SLOT_THREADS 256
// The reduce tiers of seg_slots: a group of at most THREAD_ROWS rows is
// folded by one thread, of at most WARP_ROWS by a warp, of more by the
// block. Chosen by a sweep at Q20's call and a skewed call on the H100
// (`kernel_ab.py --variants`, which builds this source with others
// defined; PERF.md, section 6.2).
#ifndef THREAD_ROWS
#define THREAD_ROWS 16
#endif
#ifndef WARP_ROWS
#define WARP_ROWS 1024
#endif

static_assert(ID_ITEMS * ID_WARPS == 32, "warp 0 scans one ballot a lane");

typedef unsigned long long u64;

struct IdArgs {
  const int64_t* h1;
  const int64_t* h2;
  KeyGroups keys;
  Comps comps;
  const bool* valid;
  int64_t n;
  int64_t out_cap;
  int64_t* starts;  // [out_cap + 1]
  int64_t* stats;   // [4]
  uint32_t* ticket;
  u64* status;  // the tiles' look-back words
  u64* last;    // the tiles' last live rows, as look-back words
  u64* part;    // [ncomp][ntiles]: the partials of the tiles with no start
  uint32_t epoch;
  uint32_t ntiles;
};

struct SlotArgs {
  Comps comps;
  const bool* valid;
  const int64_t* starts;
  const int64_t* stats;
  int64_t* first_row;
  const u64* part;
  int64_t ntiles;
  int64_t n;
  int64_t out_cap;
};

__device__ __forceinline__ bool starts_group(const IdArgs& a, int64_t i) {
  if (i >= a.n || !a.valid[i]) return false;
  if (i == 0 || !a.valid[i - 1] || a.h1[i] != a.h1[i - 1] || a.h2[i] != a.h2[i - 1])
    return true;
  return presto_keys_differ(a.keys, i, i - 1);
}

// Warp 0 of the last tile: the end of the last live row of the input,
// `mine` where the tile has a live row, else the newest earlier tile's
// that has one (their words come from blocks with earlier tickets, so
// they run).
__device__ __forceinline__ uint32_t last_live_end(const u64* last, uint32_t t, uint32_t epoch,
                                                  uint32_t mine) {
  if (mine) return mine;
  const int lane = threadIdx.x & 31;
  for (int64_t k = static_cast<int64_t>(t) - 1; k >= 0; k -= 32) {
    const int64_t idx = k - lane;
    u64 v;
    bool ready;
    do {
      v = idx >= 0 ? *reinterpret_cast<const volatile u64*>(last + idx)
                   : presto_lb_word(epoch, PRESTO_LB_INCLUSIVE, 0);
      ready = static_cast<uint32_t>(v >> 34) == epoch;
    } while (!__all_sync(0xffffffffu, ready));
    const unsigned nz = __ballot_sync(0xffffffffu, static_cast<uint32_t>(v) != 0);
    if (nz) return __shfl_sync(0xffffffffu, static_cast<uint32_t>(v), __ffs(nz) - 1);
  }
  return 0;
}

// A tile in which no group starts: each component's partial over its
// live rows (they all continue the group that started before it), or
// the identity where it has none, for the block tier of seg_slots.
template <typename T>
__device__ __forceinline__ void tile_partial(const IdArgs& a, int c, int64_t base, bool any_live,
                                             u64* scratch) {
  const Comps& cs = a.comps;
  const int64_t end = base + ID_TILE < a.n ? base + ID_TILE : a.n;
  const T acc = any_live ? presto_block_reduce<T>(cs.contrib[c], a.valid, cs.op[c], base, end,
                                                  scratch)
                         : identity<T>(cs.op[c]);
  if (threadIdx.x == 0)
    reinterpret_cast<T*>(a.part + static_cast<int64_t>(c) * a.ntiles)[base / ID_TILE] = acc;
}

__global__ void __launch_bounds__(ID_THREADS) seg_ids(const IdArgs a) {
  __shared__ uint32_t ballots[32];  // [item * ID_WARPS + warp], in row order
  __shared__ uint32_t before[32];   // group starts of the tile before each
  __shared__ uint32_t warp_last[ID_WARPS];
  __shared__ uint32_t tile_before;
  __shared__ uint32_t tile_starts, tile_last;
  __shared__ u64 scratch[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t t = presto_lb_ticket(a.ticket, a.ntiles);
  const int64_t base = static_cast<int64_t>(t) * ID_TILE;
  unsigned mine = 0;  // bit `it`: this thread's row `it` starts a group
  uint32_t last = 0;  // the end of this thread's last live row, or 0
#pragma unroll
  for (int it = 0; it < ID_ITEMS; ++it) {
    const int64_t i = base + it * ID_THREADS + threadIdx.x;
    const bool b = starts_group(a, i);
    if (i < a.n && a.valid[i]) last = static_cast<uint32_t>(i + 1);
    const unsigned bal = __ballot_sync(0xffffffffu, b);
    if (lane == 0) ballots[it * ID_WARPS + warp] = bal;
    mine |= (b ? 1u : 0u) << it;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint32_t w = __shfl_down_sync(0xffffffffu, last, o);
    last = w > last ? w : last;
  }
  if (lane == 0) warp_last[warp] = last;
  __syncthreads();
  if (warp == 0) {
    const uint32_t c = __popc(ballots[lane]);
    uint32_t x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    before[lane] = x - c;
    const uint32_t total = __shfl_sync(0xffffffffu, x, 31);
    uint32_t tl = lane < ID_WARPS ? warp_last[lane] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const uint32_t w = __shfl_xor_sync(0xffffffffu, tl, o);
      tl = w > tl ? w : tl;
    }
    if (lane == 0) {
      *reinterpret_cast<volatile u64*>(a.last + t) =
          presto_lb_word(a.epoch, PRESTO_LB_INCLUSIVE, tl);
      tile_starts = total;
      tile_last = tl;
    }
    const uint32_t prefix = presto_lb_prefix(a.status, t, a.epoch, total);
    if (lane == 0) tile_before = prefix;
    if (t == a.ntiles - 1) {
      const uint32_t end = last_live_end(a.last, t, a.epoch, tl);
      if (lane == 0) {
        const int64_t groups = static_cast<int64_t>(prefix) + total;
        a.stats[0] = groups;
        a.stats[1] = groups > a.out_cap ? 1 : 0;
        a.stats[2] = end;
        // the live groups, min(groups, out_cap): the state's carried
        // count (agg_count reads it with no reduction of its own)
        a.stats[3] = groups < a.out_cap ? groups : a.out_cap;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < ID_ITEMS; ++it) {
    if ((mine >> it) & 1u) {
      const int k = it * ID_WARPS + warp;
      const int64_t g = static_cast<int64_t>(tile_before) + before[k] +
                        __popc(ballots[k] & ((1u << lane) - 1u));
      if (g <= a.out_cap) a.starts[g] = base + it * ID_THREADS + threadIdx.x;
    }
  }
  if (tile_starts != 0) return;
  const Comps& cs = a.comps;
  for (int c = 0; c < cs.ncomp; ++c) {
    switch (cs.dtype[c]) {
      case DT_I32: tile_partial<int32_t>(a, c, base, tile_last != 0, scratch); break;
      case DT_I64: tile_partial<int64_t>(a, c, base, tile_last != 0, scratch); break;
      case DT_F32: tile_partial<float>(a, c, base, tile_last != 0, scratch); break;
      default: tile_partial<double>(a, c, base, tile_last != 0, scratch); break;
    }
  }
}

// The rows of slot g's group: [starts[g], the next group's start, or
// the end of the last live row for the last group).
__device__ __forceinline__ int64_t group_end(const SlotArgs& a, int64_t g, int64_t groups) {
  return g + 1 < groups ? a.starts[g + 1] : a.stats[2];
}

template <typename T>
__device__ __forceinline__ void thread_comp(const Comps& cs, int c, const bool* valid,
                                            int64_t g, int64_t start, int64_t end) {
  static_cast<T*>(cs.out[c])[g] = presto_thread_reduce<T>(cs.contrib[c], valid, cs.op[c], start, end);
}

template <typename T>
__device__ __forceinline__ void warp_comp(const Comps& cs, int c, const bool* valid, int64_t g,
                                          int64_t start, int64_t end, int lane) {
  const T acc = presto_warp_reduce<T>(cs.contrib[c], valid, cs.op[c], start, end, true, lane);
  if (lane == 0) static_cast<T*>(cs.out[c])[g] = acc;
}

// A group of the block tier: the rows before its first whole tile, the
// partials seg_ids wrote for the whole tiles inside it (no group starts
// there), and the rows after its last whole tile, each reduced by the
// block and combined in that order; a group that holds no whole tile,
// row by row.
template <typename T>
__device__ __forceinline__ void block_comp(const SlotArgs& a, int c, int64_t g, int64_t start,
                                           int64_t end, u64* scratch) {
  const Comps& cs = a.comps;
  const int op = cs.op[c];
  const int64_t t_lo = start / ID_TILE + 1, t_hi = end / ID_TILE;
  T acc;
  if (t_lo < t_hi) {
    const T head = presto_block_reduce<T>(cs.contrib[c], a.valid, op, start, t_lo * ID_TILE,
                                          scratch);
    const T mid = presto_block_reduce<T>(a.part + static_cast<int64_t>(c) * a.ntiles, nullptr,
                                         op, t_lo, t_hi, scratch);
    const T tail = presto_block_reduce<T>(cs.contrib[c], a.valid, op, t_hi * ID_TILE, end,
                                          scratch);
    acc = combine(combine(head, mid, op), tail, op);
  } else {
    acc = presto_block_reduce<T>(cs.contrib[c], a.valid, op, start, end, scratch);
  }
  if (threadIdx.x == 0) static_cast<T*>(cs.out[c])[g] = acc;
}

__global__ void __launch_bounds__(SLOT_THREADS) seg_slots(const SlotArgs a) {
  __shared__ int nbig;
  __shared__ int64_t big[SLOT_THREADS];  // the block's slots of the block tier
  __shared__ u64 scratch[32];
  const int lane = threadIdx.x & 31;
  const Comps& cs = a.comps;
  const int64_t groups = a.stats[0];
  const int64_t g = static_cast<int64_t>(blockIdx.x) * SLOT_THREADS + threadIdx.x;
  const bool in = g < a.out_cap;
  const bool live = in && g < groups;
  int64_t start = 0, end = 0;
  if (live) {
    start = a.starts[g];
    end = group_end(a, g, groups);
  }
  const int64_t len = end - start;
  const int tier = len <= THREAD_ROWS ? 0 : (len <= WARP_ROWS ? 1 : 2);
  if (threadIdx.x == 0) nbig = 0;
  if (in) {
    a.first_row[g] = live ? start : a.n - 1;
    if (tier == 0) {
      for (int c = 0; c < cs.ncomp; ++c) {
        switch (cs.dtype[c]) {
          case DT_I32: thread_comp<int32_t>(cs, c, a.valid, g, start, end); break;
          case DT_I64: thread_comp<int64_t>(cs, c, a.valid, g, start, end); break;
          case DT_F32: thread_comp<float>(cs, c, a.valid, g, start, end); break;
          default: thread_comp<double>(cs, c, a.valid, g, start, end); break;
        }
      }
    }
  }
  // the warp tier: the warp takes its lanes' groups one after another
  for (unsigned wm = __ballot_sync(0xffffffffu, tier == 1); wm; wm &= wm - 1) {
    const int src = __ffs(wm) - 1;
    const int64_t s = __shfl_sync(0xffffffffu, start, src);
    const int64_t e = __shfl_sync(0xffffffffu, end, src);
    const int64_t gg = __shfl_sync(0xffffffffu, g, src);
    for (int c = 0; c < cs.ncomp; ++c) {
      switch (cs.dtype[c]) {
        case DT_I32: warp_comp<int32_t>(cs, c, a.valid, gg, s, e, lane); break;
        case DT_I64: warp_comp<int64_t>(cs, c, a.valid, gg, s, e, lane); break;
        case DT_F32: warp_comp<float>(cs, c, a.valid, gg, s, e, lane); break;
        default: warp_comp<double>(cs, c, a.valid, gg, s, e, lane); break;
      }
    }
  }
  // the block tier: the block takes its slots' groups one after another
  __syncthreads();
  if (tier == 2) big[atomicAdd(&nbig, 1)] = g;
  __syncthreads();
  const int nb = nbig;
  for (int j = 0; j < nb; ++j) {
    const int64_t gg = big[j];
    const int64_t s = a.starts[gg], e = group_end(a, gg, groups);
    for (int c = 0; c < cs.ncomp; ++c) {
      switch (cs.dtype[c]) {
        case DT_I32: block_comp<int32_t>(a, c, gg, s, e, scratch); break;
        case DT_I64: block_comp<int64_t>(a, c, gg, s, e, scratch); break;
        case DT_F32: block_comp<float>(a, c, gg, s, e, scratch); break;
        default: block_comp<double>(a, c, gg, s, e, scratch); break;
      }
    }
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_segment_tile() { return ID_TILE; }

// desc (host, int64): n, out_cap, ncomp, h1, h2, valid, stats[4],
// starts[out_cap + 1], first_row[out_cap], part[ncomp * ceil(n /
// ID_TILE)] (uint64 scratch), then per component its sorted
// contribution, its out[out_cap] slots and dtype | op << 8.
// Keys: flat host tables of nkeys columns (row_hash.cuh
// `presto_fill_key_groups`). ticket: one uint32, 0 between calls;
// status: status_words >= 2 * ceil(n / ID_TILE) uint64 whose epochs are
// not `epoch`; epoch: 1 .. 2^30 - 1, new for every call on the stream.
// Two launches; nothing to zero.
int presto_segment_reduce(const int64_t* desc, const int64_t* key_data,
                          const int64_t* key_mask, const int32_t* key_dtypes, int32_t nkeys,
                          void* ticket, void* status, int64_t status_words, uint32_t epoch,
                          void* stream) {
  const int64_t n = desc[0], out_cap = desc[1], ncomp = desc[2];
  if (n < 1 || n > 0x7fffffffLL || out_cap < 1 || ncomp < 0 || ncomp > PRESTO_MAX_COMPS ||
      epoch == 0 || epoch > 0x3fffffffu)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntiles = (n + ID_TILE - 1) / ID_TILE;
  if (status_words < 2 * ntiles) return static_cast<int>(cudaErrorInvalidValue);
  IdArgs a;
  if (!presto_fill_key_groups(&a.keys, key_data, key_mask, key_dtypes, nkeys))
    return static_cast<int>(cudaErrorInvalidValue);
  a.h1 = reinterpret_cast<const int64_t*>(desc[3]);
  a.h2 = reinterpret_cast<const int64_t*>(desc[4]);
  a.valid = reinterpret_cast<const bool*>(desc[5]);
  a.n = n;
  a.out_cap = out_cap;
  a.stats = reinterpret_cast<int64_t*>(desc[6]);
  a.starts = reinterpret_cast<int64_t*>(desc[7]);
  a.ticket = static_cast<uint32_t*>(ticket);
  a.status = static_cast<u64*>(status);
  a.last = a.status + ntiles;
  a.epoch = epoch;
  a.ntiles = static_cast<uint32_t>(ntiles);
  a.part = reinterpret_cast<u64*>(desc[9]);
  SlotArgs s;
  s.comps.ncomp = static_cast<int32_t>(ncomp);
  for (int j = 0; j < ncomp; ++j) {
    const int64_t* c = desc + 10 + 3 * j;
    s.comps.contrib[j] = reinterpret_cast<const void*>(c[0]);
    s.comps.out[j] = reinterpret_cast<void*>(c[1]);
    s.comps.dtype[j] = static_cast<int8_t>(c[2] & 0xff);
    s.comps.op[j] = static_cast<int8_t>(c[2] >> 8);
  }
  a.comps = s.comps;
  s.part = a.part;
  s.ntiles = ntiles;
  s.valid = a.valid;
  s.starts = a.starts;
  s.stats = a.stats;
  s.first_row = reinterpret_cast<int64_t*>(desc[8]);
  s.n = n;
  s.out_cap = out_cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  seg_ids<<<static_cast<unsigned>(ntiles), ID_THREADS, 0, st>>>(a);
  const int64_t blocks = (out_cap + SLOT_THREADS - 1) / SLOT_THREADS;
  seg_slots<<<static_cast<unsigned>(blocks), SLOT_THREADS, 0, st>>>(s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
