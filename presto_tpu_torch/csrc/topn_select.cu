// topn_select (K31 topn_select, K32 topn_sort): topn's fold step as a
// radix select of the first C rows of state ++ batch, then a sort of
// only those rows.
//
// Replaces presto_tpu/ops/sort.py:54 `_topn_step_impl`, which sorts the
// whole concatenation of state (C = state.capacity rows) and batch (B
// rows) to keep its first C rows. The step's result is the first C
// entries of the stable order of the N = C + B rows by K24's key words
// (sort_encode.cu; word 0 most significant, ~row_valid its top bit),
// ties by row index, so state rows before batch rows. K26
// (gather_rows.cu) then moves those C rows with the live mask j < n.
// Here the order of all N rows is never built:
//
// K31 topn_select: a most-significant-digit-first radix select over the
// words. Every row starts EQUAL to the (empty) prefix; `below` counts
// the rows already known to be smaller. A pass takes the next 8-bit
// digit that K24's masks say varies (read on the device), counts its
// values over the EQUAL rows (a shared-memory histogram per warp, one
// add per distinct digit of the warp's 32 rows, summed into a global
// one; each thread has four rows' loads in flight), and every block picks
// the same bucket b: the one that holds rank C - below among the EQUAL
// rows. Rows of a smaller digit become BELOW, of a larger one OUT, of b
// stay EQUAL (a byte per row, applied lazily in the next row loop).
// The passes stop as soon as below + equal <= M, the candidate cap
// (M >= C, fixed by the caller, the same in the plain version), or when
// the digits run out: then every EQUAL row has the same key, and only
// the first C - below of them by index can be among the first C. A
// stable count / scan / scatter (block counts, a prefix over the
// blocks, then over each block's warps, each warp a contiguous run of
// rows, ballots within it) writes the candidates' row indices in
// index order: every BELOW row, and the EQUAL rows (their first
// C - below by index when the digits ran out), then -1 up to M; and
// info = (candidates, passes, digits ran out, below), and the
// candidates' words, compacted and padded with all-ones words (K32's
// input, or K25's).
// All of it is one cooperative launch with a grid-wide sync after each
// pass: every block carries the same state in registers, so no pass
// needs the host or another launch.
//
// K32 topn_sort: one block of 1024 threads sorts the <= M candidates
// stably by their words (ties by candidate order, which is index
// order) in shared memory: the candidates' words (K31's compacted
// copy, read contiguously) are staged once, and a
// stable LSD radix sort moves 16-bit local indices between two buffers,
// one pass per 8-bit digit that varies among the candidates (the block
// ORs the words first). Each warp owns a contiguous run of the current
// order: it counts its digits with __match_any_sync, a scan (partial
// counts per quarter of the warps, one warp over the 256 digit totals)
// turns the per-warp counts into digit-major offsets, and the warp
// scatters in the same order (rank among equal digits of its lanes).
// It writes the first C row indices of the order as int64. Shared
// memory: M x (8W + 4) bytes plus TOPN_SORT_SCRATCH; M is chosen so
// that this fits the 227 KB a block may opt into. Where it does not fit
// even for M = C, the candidates' words go to K25 instead.
//
// What bounds them: bytes. The least the card could do for the step is
// read each row's key words once and write C indices; K31 reads word 0
// (or the word of the first varying digit) of every row in its first
// pass, then a byte of state per row and the current word of the EQUAL
// rows in each later pass, and writes one byte per row once. K32 reads
// M x W words and writes C indices; its passes run in shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define RADIX 256
#define MAX_WORDS 64
#define SEL_THREADS 512
#define SEL_WARPS (SEL_THREADS / 32)
#define SEL_ITEMS 4
#define SEL_TILE (SEL_THREADS * SEL_ITEMS)
#define SEL_MAX_GRID 2048
#define SORT_THREADS 1024
#define SORT_WARPS (SORT_THREADS / 32)
#define SORT_ITEMS 8
#define SORT_MAX_ROWS (SORT_THREADS * SORT_ITEMS)
// K32's shared memory besides the words and the two index buffers:
// per-warp digit counts (uint16), per-quarter partial counts and digit
// offsets (int32), per-word masks
#define SORT_SCRATCH (SORT_WARPS * RADIX * 2 + 5 * RADIX * 4 + MAX_WORDS * 8)

enum RowState : uint8_t { ST_OUT = 0, ST_BELOW = 1, ST_EQ = 2 };

// -- K31 --------------------------------------------------------------------

// What every block knows after a phase (all blocks compute the same).
struct SelState {
  long long below;  // rows known to be smaller than the prefix
  long long eq;     // rows equal to the prefix so far
  int last;         // digit whose histogram is complete, bucket not picked; -1
  int pw, ps, pb;   // a pick not applied to the row states yet: word, shift, bucket; pw -1
  int st_init;      // the row-state bytes have been written
  int passes;       // histogram passes run
};

struct SelArgs {
  const uint64_t* words;   // [nwords][n]
  int32_t nwords;
  int64_t n, cap, most;    // rows, C, M
  const int64_t* digits;   // [nwords]: bit d of word w set = byte d varies
  uint8_t* st;             // [n] row states
  int32_t* hist;           // [nwords * 8][RADIX], zeroed
  long long* blockcnt;     // [2 * grid]: BELOW and EQUAL rows per block
  int64_t* cand;           // [most]
  uint64_t* cand_words;    // [nwords][most]
  int64_t* info;           // [4]
  int64_t chunk;           // rows per block, a multiple of SEL_TILE
};

struct SelShared {
  int32_t h[SEL_WARPS][RADIX];  // per-warp histograms: no atomics across warps
  long long red[2][SEL_WARPS];
  int pick_b, pick_excl, pick_h;
};

__device__ __forceinline__ int digit_of(uint64_t w, int shift) {
  return static_cast<int>((w >> shift) & 0xFF);
}

// the bucket of the last histogram that holds rank C - below among the
// EQUAL rows (one warp scans the 256 counts); every thread of the block
// must call it
__device__ void take_pick(const SelArgs& a, SelState& s, SelShared& sm) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) {
    const int32_t* h = a.hist + static_cast<int64_t>(s.last) * RADIX;
    int32_t h8[RADIX / 32];
    long long run = 0;
#pragma unroll
    for (int k = 0; k < RADIX / 32; ++k) {
      h8[k] = h[lane * (RADIX / 32) + k];
      run += h8[k];
    }
    long long incl = run;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    long long excl = incl - run;
    const long long k = a.cap - s.below;  // >= 1 and <= eq: the bucket exists
#pragma unroll
    for (int j = 0; j < RADIX / 32; ++j) {
      if (excl < k && excl + h8[j] >= k) {
        sm.pick_b = lane * (RADIX / 32) + j;
        sm.pick_excl = static_cast<int>(excl);
        sm.pick_h = h8[j];
      }
      excl += h8[j];
    }
  }
  __syncthreads();
  s.below += sm.pick_excl;
  s.eq = sm.pick_h;
  s.pw = s.last >> 3;
  s.ps = 8 * (7 - (s.last & 7));
  s.pb = sm.pick_b;
  s.last = -1;
  __syncthreads();  // sm.pick_* are rewritten by the next pick
}

// row r's state after the pending pick, given its stored state `st`
// (ST_EQ for every row before the states are written); the byte is
// written where it changed. The states start as ST_OUT (the scratch is
// zeroed), so the first pick writes only the BELOW and EQUAL rows; with
// `force` and no pick every row is written as EQUAL.
__device__ __forceinline__ int classify(const SelArgs& a, const SelState& s, int st, uint64_t pv,
                                        bool have_pick, int64_t r, bool force) {
  int nst = st;
  if (st == ST_EQ && have_pick) {
    const int d0 = digit_of(pv, s.ps);
    nst = d0 < s.pb ? ST_BELOW : (d0 > s.pb ? ST_OUT : ST_EQ);
  }
  if (s.st_init ? nst != st : ((have_pick || force) && nst != ST_OUT))
    a.st[r] = static_cast<uint8_t>(nst);
  return nst;
}

// rows [r0, r0 + 16) of one thread once the states are written: their
// 16 state bytes in one load (ST_OUT past hi)
__device__ __forceinline__ void load_states16(const SelArgs& a, int64_t r0, int64_t hi,
                                              uint32_t w[4]) {
  if (r0 + 16 <= hi) {
    const uint4 v = *reinterpret_cast<const uint4*>(a.st + r0);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int64_t r = r0 + 4 * q + b;
      w[q] |= static_cast<uint32_t>(r < hi ? a.st[r] : ST_OUT) << (8 * b);
    }
  }
}

__device__ __forceinline__ int state_byte(const uint32_t w[4], int i) {
  return static_cast<int>((w[i >> 2] >> (8 * (i & 3))) & 0xFF);
}

// rows of state x among 16 state bytes
__device__ __forceinline__ int count_states16(const uint32_t w[4], uint32_t x4) {
  int c = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) c += __popc(__vcmpeq4(w[q], x4)) >> 3;
  return c;
}

// the EQUAL rows among [r0, r0 + 16) after the pending pick (states
// written where they change); `fn(r, pv)` for each row still EQUAL,
// pv its word of the pick (0 without one). Loads of a group of four
// rows go out together.
template <typename F>
__device__ __forceinline__ void for_equal16(const SelArgs& a, const SelState& s,
                                            const uint64_t* pword, int64_t r0, uint32_t w[4],
                                            F fn) {
  const bool have_pick = pword != nullptr;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    if (__vcmpeq4(w[g], 0x02020202u) == 0) continue;  // no EQUAL row here
    uint64_t pv[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      pv[b] = have_pick && state_byte(w, 4 * g + b) == ST_EQ ? pword[r0 + 4 * g + b] : 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = 4 * g + b;
      if (state_byte(w, i) != ST_EQ) continue;
      const int nst = classify(a, s, ST_EQ, pv[b], have_pick, r0 + i, false);
      if (nst != ST_EQ) w[g] = (w[g] & ~(0xFFu << (8 * b))) | (static_cast<uint32_t>(nst) << (8 * b));
      else fn(r0 + i, pv[b]);
    }
  }
}

// one histogram pass over digit t (MSD order) of the EQUAL rows; each
// thread takes SEL_ITEMS rows a round (their loads in flight together)
__device__ void hist_phase(const SelArgs& a, SelState& s, int t, SelShared& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int32_t* wh = sm.h[warp];
  for (int i = lane; i < RADIX; i += 32) wh[i] = 0;
  __syncwarp();
  const uint64_t* word = a.words + static_cast<int64_t>(t >> 3) * a.n;
  const int shift = 8 * (7 - (t & 7));
  const bool have_pick = s.pw >= 0;
  const uint64_t* pword = have_pick ? a.words + static_cast<int64_t>(s.pw) * a.n : word;
  const bool same = pword == word;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * a.chunk;
  const int64_t hi = lo + a.chunk < a.n ? lo + a.chunk : a.n;
  if (s.st_init) {
    // few rows are still EQUAL: 16 state bytes a thread in one load,
    // a word loaded only for an EQUAL row
    for (int64_t r0 = lo + 16 * tid; r0 < hi; r0 += 16 * SEL_THREADS) {
      uint32_t w4[4];
      load_states16(a, r0, hi, w4);
      for_equal16(a, s, have_pick ? pword : nullptr, r0, w4, [&](int64_t r, uint64_t pv) {
        atomicAdd(&wh[digit_of(same && have_pick ? pv : word[r], shift)], 1);
      });
    }
  }
  for (int64_t base = lo; !s.st_init && base < hi; base += SEL_TILE) {
    int st[SEL_ITEMS];
    uint64_t pv[SEL_ITEMS];
#pragma unroll
    for (int j = 0; j < SEL_ITEMS; ++j) {
      const int64_t r = base + j * SEL_THREADS + tid;
      st[j] = r < hi ? ST_EQ : ST_OUT;
    }
#pragma unroll
    for (int j = 0; j < SEL_ITEMS; ++j)
      pv[j] = st[j] == ST_EQ ? pword[base + j * SEL_THREADS + tid] : 0;
#pragma unroll
    for (int j = 0; j < SEL_ITEMS; ++j) {
      const int64_t r = base + j * SEL_THREADS + tid;
      if (st[j] == ST_EQ) st[j] = classify(a, s, ST_EQ, pv[j], have_pick, r, false);
      if (st[j] == ST_EQ && !same) pv[j] = word[r];
    }
#pragma unroll
    for (int j = 0; j < SEL_ITEMS; ++j) {
      const unsigned d = st[j] == ST_EQ ? digit_of(pv[j], shift) : RADIX;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (d < RADIX && (__ffs(peers) - 1) == lane) wh[d] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  int32_t* g = a.hist + static_cast<int64_t>(t) * RADIX;
  for (int i = tid; i < RADIX; i += SEL_THREADS) {
    int32_t c = 0;
    for (int w = 0; w < SEL_WARPS; ++w) c += sm.h[w][i];
    if (c) atomicAdd(&g[i], c);
  }
  if (have_pick) s.st_init = 1;
  s.pw = -1;
  s.last = t;
  s.passes += 1;
}

// sum of two per-thread values over the block, in every thread
__device__ void block_sum2(long long& x, long long& y, SelShared& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, o);
    y += __shfl_down_sync(0xffffffffu, y, o);
  }
  if (lane == 0) {
    sm.red[0][warp] = x;
    sm.red[1][warp] = y;
  }
  __syncthreads();
  x = y = 0;
  for (int w = 0; w < SEL_WARPS; ++w) {
    x += sm.red[0][w];
    y += sm.red[1][w];
  }
  __syncthreads();
}

// the last pick applied; BELOW and EQUAL rows per block
__device__ void count_phase(const SelArgs& a, SelState& s, SelShared& sm) {
  const int tid = threadIdx.x;
  const bool have_pick = s.pw >= 0;
  const uint64_t* pword = a.words + static_cast<int64_t>(have_pick ? s.pw : 0) * a.n;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * a.chunk;
  const int64_t hi = lo + a.chunk < a.n ? lo + a.chunk : a.n;
  long long nb = 0, ne = 0;
  if (s.st_init) {
    for (int64_t r0 = lo + 16 * tid; r0 < hi; r0 += 16 * SEL_THREADS) {
      uint32_t w4[4];
      load_states16(a, r0, hi, w4);
      if (have_pick) for_equal16(a, s, pword, r0, w4, [](int64_t, uint64_t) {});
      nb += count_states16(w4, 0x01010101u);
      ne += count_states16(w4, 0x02020202u);
    }
  }
  for (int64_t base = lo; !s.st_init && base < hi; base += SEL_TILE) {
    uint64_t pv[SEL_ITEMS];
#pragma unroll
    for (int j = 0; j < SEL_ITEMS; ++j) {
      const int64_t r = base + j * SEL_THREADS + tid;
      pv[j] = r < hi && have_pick ? pword[r] : 0;
    }
#pragma unroll
    for (int j = 0; j < SEL_ITEMS; ++j) {
      const int64_t r = base + j * SEL_THREADS + tid;
      if (r >= hi) continue;
      const int st = classify(a, s, ST_EQ, pv[j], have_pick, r, true);
      nb += st == ST_BELOW;
      ne += st == ST_EQ;
    }
  }
  block_sum2(nb, ne, sm);
  if (tid == 0) {
    a.blockcnt[2 * blockIdx.x] = nb;
    a.blockcnt[2 * blockIdx.x + 1] = ne;
  }
  s.st_init = 1;
  s.pw = -1;
}

// candidate `pos` is row r: its index and its words (loaded four at a
// time, so their latencies overlap)
__device__ __forceinline__ void write_candidate(const SelArgs& a, long long pos, int64_t r) {
  for (int w0 = 0; w0 < a.nwords; w0 += 4) {
    uint64_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = w0 + k < a.nwords ? a.words[static_cast<int64_t>(w0 + k) * a.n + r] : 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (w0 + k < a.nwords) a.cand_words[static_cast<int64_t>(w0 + k) * a.most + pos] = v[k];
  }
  a.cand[pos] = r;
}

// the candidates in index order: each warp takes a contiguous run of
// its block's rows, counts its BELOW and EQUAL rows (ballots), and after
// one block-wide prefix writes them in order
__device__ void scatter_phase(const SelArgs& a, const SelState& s, SelShared& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool ran_out = s.below + s.eq > a.most;
  const long long limit = ran_out ? a.cap - s.below : s.eq;
  long long before_b = 0, before_e = 0;
  for (int b = tid; b < static_cast<int>(blockIdx.x); b += SEL_THREADS) {
    before_b += a.blockcnt[2 * b];
    before_e += a.blockcnt[2 * b + 1];
  }
  block_sum2(before_b, before_e, sm);
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * a.chunk;
  const int64_t hi = lo + a.chunk < a.n ? lo + a.chunk : a.n;
  const int64_t wlo = lo + static_cast<int64_t>(warp) * (a.chunk / SEL_WARPS);
  const int64_t whi = wlo + a.chunk / SEL_WARPS < hi ? wlo + a.chunk / SEL_WARPS : hi;
  // each lane 16 consecutive rows of the warp's run a round
  int nb = 0, ne = 0;
  for (int64_t r0 = wlo + 16 * lane; r0 - 16 * lane < whi; r0 += 16 * 32) {
    uint32_t w4[4];
    load_states16(a, r0, whi, w4);
    nb += count_states16(w4, 0x01010101u);
    ne += count_states16(w4, 0x02020202u);
  }
  for (int o = 16; o > 0; o >>= 1) {
    nb += __shfl_xor_sync(0xffffffffu, nb, o);
    ne += __shfl_xor_sync(0xffffffffu, ne, o);
  }
  if (lane == 0) {
    sm.red[0][warp] = nb;
    sm.red[1][warp] = ne;
  }
  __syncthreads();
  for (int w = 0; w < warp; ++w) {
    before_b += sm.red[0][w];
    before_e += sm.red[1][w];
  }
  for (int64_t r0 = wlo + 16 * lane; r0 - 16 * lane < whi; r0 += 16 * 32) {
    uint32_t w4[4];
    load_states16(a, r0, whi, w4);
    const int cb = count_states16(w4, 0x01010101u), ce = count_states16(w4, 0x02020202u);
    int ib = cb, ie = ce;  // inclusive scans over the lanes
    for (int o = 1; o < 32; o <<= 1) {
      const int yb = __shfl_up_sync(0xffffffffu, ib, o), ye = __shfl_up_sync(0xffffffffu, ie, o);
      if (lane >= o) ib += yb, ie += ye;
    }
    long long rb = before_b + ib - cb, re = before_e + ie - ce;
    if (cb + ce) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int st = state_byte(w4, i);
        long long pos = -1;
        if (st == ST_BELOW) pos = rb++ + (re < limit ? re : limit);
        else if (st == ST_EQ && re < limit) pos = rb + re++;
        else if (st == ST_EQ) ++re;
        if (pos >= 0) write_candidate(a, pos, r0 + i);
      }
    }
    before_b += __shfl_sync(0xffffffffu, ib, 31);
    before_e += __shfl_sync(0xffffffffu, ie, 31);
  }
  const long long count = s.below + (s.eq < limit ? s.eq : limit);
  if (blockIdx.x == 0) {
    for (long long i = count + tid; i < a.most; i += SEL_THREADS) {
      a.cand[i] = -1;
      for (int w = 0; w < a.nwords; ++w)
        a.cand_words[static_cast<int64_t>(w) * a.most + i] = ~0ULL;
    }
    if (tid == 0) {
      a.info[0] = count;
      a.info[1] = s.passes;
      a.info[2] = ran_out;
      a.info[3] = s.below;
    }
  }
}

// phases 0 .. 8W-1 one digit each (MSD first), 8W the count, 8W + 1
// the scatter; a grid-wide sync after each phase that ran
__global__ void __launch_bounds__(SEL_THREADS, 2)
topn_select_kernel(SelArgs a) {
  __shared__ SelShared sm;
  SelState s;
  s.below = 0;
  s.eq = a.n;
  s.last = s.pw = -1;
  s.ps = s.pb = 0;
  s.st_init = 0;
  s.passes = 0;
  const int nd = 8 * a.nwords;
  for (int p = 0; p <= nd + 1; ++p) {
    bool synced = false;
    if (p <= nd && s.last >= 0) take_pick(a, s, sm);
    if (p < nd) {
      const bool varies = (a.digits[p >> 3] >> (7 - (p & 7))) & 1;
      if (varies && s.below + s.eq > a.most) {
        hist_phase(a, s, p, sm);
        synced = true;
      }
    } else if (p == nd) {
      count_phase(a, s, sm);
      synced = true;
    } else {
      scatter_phase(a, s, sm);
    }
    if (synced) cg::this_grid().sync();
  }
}

// -- K32 --------------------------------------------------------------------

// rows [0, cnt) of K32's order: warp w owns positions
// [w * seg, (w + 1) * seg), a multiple of 32
__device__ __forceinline__ int sort_seg(int cnt) {
  return ((cnt + SORT_THREADS - 1) / SORT_THREADS) * 32;
}

__global__ void __launch_bounds__(SORT_THREADS, 1)
topn_sort_kernel(const uint64_t* __restrict__ src, int nwords, int64_t stride,
                 const int64_t* __restrict__ cand, const int64_t* __restrict__ count_ptr,
                 int64_t most, int64_t cap, int64_t* __restrict__ perm) {
  extern __shared__ uint64_t smem[];
  uint64_t* keys = smem;                                        // [nwords][most]
  uint64_t* vary = keys + static_cast<int64_t>(nwords) * most;  // [MAX_WORDS]
  int32_t* part = reinterpret_cast<int32_t*>(vary + MAX_WORDS);  // [4][RADIX]
  int32_t* base = part + 4 * RADIX;                             // [RADIX]
  uint16_t* wcnt = reinterpret_cast<uint16_t*>(base + RADIX);   // [SORT_WARPS][RADIX]
  uint16_t* cur = wcnt + SORT_WARPS * RADIX;                    // [most]
  uint16_t* nxt = cur + most;                                   // [most]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cnt = static_cast<int>(count_ptr != nullptr ? *count_ptr : stride);
  for (int w = tid; w < nwords; w += SORT_THREADS) vary[w] = 0;
  // stage the candidates' words (contiguous: K31 compacted them), a
  // word's loads all in flight
  for (int w = 0; w < nwords; ++w) {
    const uint64_t* sw = src + static_cast<int64_t>(w) * stride;
    uint64_t* kw = keys + static_cast<int64_t>(w) * most;
    uint64_t v[SORT_ITEMS];
#pragma unroll
    for (int k = 0; k < SORT_ITEMS; ++k) {
      const int i = k * SORT_THREADS + tid;
      v[k] = i < cnt ? sw[i] : 0;
    }
#pragma unroll
    for (int k = 0; k < SORT_ITEMS; ++k) {
      const int i = k * SORT_THREADS + tid;
      if (i < cnt) kw[i] = v[k];
    }
  }
  for (int i = tid; i < cnt; i += SORT_THREADS) cur[i] = static_cast<uint16_t>(i);
  __syncthreads();
  // the digits that vary among the candidates
  for (int w = 0; w < nwords; ++w) {
    const uint64_t* kw = keys + static_cast<int64_t>(w) * most;
    const uint64_t k0 = kw[0];
    uint64_t x = 0;
    for (int i = tid; i < cnt; i += SORT_THREADS) x |= kw[i] ^ k0;
    for (int o = 16; o > 0; o >>= 1) x |= __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0 && x) atomicOr(reinterpret_cast<unsigned long long*>(&vary[w]), x);
  }
  __syncthreads();
  const int seg = sort_seg(cnt);
  const int iters = seg / 32;
  const unsigned lt = (1u << lane) - 1u;
  // the scan's thread roles: digit d, quarter q of the warps
  const int sd = tid & (RADIX - 1), sq = tid >> 8;
  for (int w = nwords - 1; w >= 0; --w) {
    const uint64_t vw = vary[w];
    const uint64_t* kw = keys + static_cast<int64_t>(w) * most;
    for (int shift = 0; shift < 64; shift += 8) {
      if (((vw >> shift) & 0xFF) == 0) continue;
      for (int i = lane; i < RADIX; i += 32) wcnt[warp * RADIX + i] = 0;
      __syncwarp();
      // count: each warp its run, in order; every item's digit and
      // peers first (independent), then the counts
      uint32_t dd[SORT_ITEMS];
      unsigned pp[SORT_ITEMS];
      uint16_t ll[SORT_ITEMS];
#pragma unroll
      for (int it = 0; it < SORT_ITEMS; ++it) {
        const int pos = warp * seg + it * 32 + lane;
        ll[it] = it < iters && pos < cnt ? cur[pos] : 0;
      }
#pragma unroll
      for (int it = 0; it < SORT_ITEMS; ++it) {
        const int pos = warp * seg + it * 32 + lane;
        dd[it] = it < iters && pos < cnt ? static_cast<uint32_t>((kw[ll[it]] >> shift) & 0xFF)
                                         : RADIX;
      }
#pragma unroll
      for (int it = 0; it < SORT_ITEMS; ++it)
        pp[it] = it < iters ? __match_any_sync(0xffffffffu, dd[it]) : 0u;
#pragma unroll
      for (int it = 0; it < SORT_ITEMS; ++it) {
        if (it < iters) {
          if (dd[it] < RADIX && (__ffs(pp[it]) - 1) == lane)
            wcnt[warp * RADIX + dd[it]] += __popc(pp[it]);
          __syncwarp();
        }
      }
      __syncthreads();
      // offsets, digit-major then by warp: per quarter of the warps a
      // partial count, one warp scans the 256 digit totals, then each
      // (digit, quarter) thread writes its warps' offsets
      {
        int32_t sum = 0;
#pragma unroll
        for (int v = 0; v < SORT_WARPS / 4; ++v) sum += wcnt[(sq * (SORT_WARPS / 4) + v) * RADIX + sd];
        part[sq * RADIX + sd] = sum;
      }
      __syncthreads();
      if (warp == 0) {
        int32_t t8[RADIX / 32];
        int32_t run = 0;
#pragma unroll
        for (int k = 0; k < RADIX / 32; ++k) {
          const int d = lane * (RADIX / 32) + k;
          t8[k] = part[d] + part[RADIX + d] + part[2 * RADIX + d] + part[3 * RADIX + d];
          run += t8[k];
        }
        int32_t incl = run;
        for (int o = 1; o < 32; o <<= 1) {
          const int32_t y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        int32_t excl = incl - run;
#pragma unroll
        for (int k = 0; k < RADIX / 32; ++k) {
          base[lane * (RADIX / 32) + k] = excl;
          excl += t8[k];
        }
      }
      __syncthreads();
      {
        int32_t run = base[sd];
        for (int q = 0; q < sq; ++q) run += part[q * RADIX + sd];
#pragma unroll
        for (int v = 0; v < SORT_WARPS / 4; ++v) {
          const int idx = (sq * (SORT_WARPS / 4) + v) * RADIX + sd;
          const int32_t c = wcnt[idx];
          wcnt[idx] = static_cast<uint16_t>(run);
          run += c;
        }
      }
      __syncthreads();
      // scatter: the same order, each row after the equal digits before it
#pragma unroll
      for (int it = 0; it < SORT_ITEMS; ++it) {
        if (it < iters) {
          const uint32_t d = dd[it];
          if (d < RADIX) nxt[wcnt[warp * RADIX + d] + __popc(pp[it] & lt)] = ll[it];
          __syncwarp();
          if (d < RADIX && (__ffs(pp[it]) - 1) == lane) wcnt[warp * RADIX + d] += __popc(pp[it]);
          __syncwarp();
        }
      }
      __syncthreads();
      uint16_t* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
  for (int64_t j0 = 0; j0 < cap; j0 += 4 * SORT_THREADS) {
    int64_t row[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t j = j0 + k * SORT_THREADS + tid;
      row[k] = j < cap ? (cand != nullptr ? cand[cur[j]] : cur[j]) : 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t j = j0 + k * SORT_THREADS + tid;
      if (j < cap) perm[j] = row[k];
    }
  }
}

// -- entry points -----------------------------------------------------------

static int g_select_grid[16];
static int g_sort_smem[16];
static int g_sort_optin[16];

static int select_grid(int dev) {
  if (dev < 0 || dev >= 16) return 0;
  if (g_select_grid[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topn_select_kernel, SEL_THREADS,
                                                  0);
    const int g = sms * per_sm;
    g_select_grid[dev] = g < SEL_MAX_GRID ? g : SEL_MAX_GRID;
  }
  return g_select_grid[dev];
}

static size_t round_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_topn_sort_scratch() { return SORT_SCRATCH; }
int presto_topn_sort_max_rows() { return SORT_MAX_ROWS; }

// bytes of K31's device scratch for n rows of nwords words
int64_t presto_topn_select_scratch(int64_t n, int32_t nwords) {
  return static_cast<int64_t>(round_up(static_cast<size_t>(n)) +
                              round_up(static_cast<size_t>(nwords) * 8 * RADIX * 4) +
                              round_up(2 * SEL_MAX_GRID * 8));
}

// K31: words [nwords][n] (K24's, unsigned in int64), digits [nwords]
// (K24's masks, on the device), cap = C, most = M (C <= M < n);
// scratch of presto_topn_select_scratch bytes; writes cand [most]
// int64, info [4] int64 and the candidates' words [nwords][most] (K32's
// or K25's input), in one cooperative launch.
int presto_topn_select(const void* words, int32_t nwords, int64_t n, int64_t cap, int64_t most,
                       const void* digits, void* scratch, void* cand, void* cand_words,
                       void* info, void* stream) {
  if (nwords < 1 || nwords > MAX_WORDS || n < 1 || n > 0x7fffffffLL || cap < 1 ||
      most < cap || most >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaGetDevice(&dev);
  const int gmax = select_grid(dev);
  if (gmax < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t tiles = (n + SEL_TILE - 1) / SEL_TILE;
  const int64_t per = (tiles + gmax - 1) / gmax;
  SelArgs a;
  a.words = static_cast<const uint64_t*>(words);
  a.nwords = nwords;
  a.n = n;
  a.cap = cap;
  a.most = most;
  a.digits = static_cast<const int64_t*>(digits);
  char* p = static_cast<char*>(scratch);
  a.st = reinterpret_cast<uint8_t*>(p);
  p += round_up(static_cast<size_t>(n));
  a.hist = reinterpret_cast<int32_t*>(p);
  p += round_up(static_cast<size_t>(nwords) * 8 * RADIX * 4);
  a.blockcnt = reinterpret_cast<long long*>(p);
  a.cand = static_cast<int64_t*>(cand);
  a.cand_words = static_cast<uint64_t*>(cand_words);
  a.info = static_cast<int64_t*>(info);
  a.chunk = per * SEL_TILE;
  const unsigned grid = static_cast<unsigned>((n + a.chunk - 1) / a.chunk);
  // the row states start as ST_OUT, and the histograms at 0
  cudaMemsetAsync(a.st, 0, static_cast<size_t>(n), st);
  cudaMemsetAsync(a.hist, 0, static_cast<size_t>(nwords) * 8 * RADIX * 4, st);
  void* kargs[] = {&a};
  cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(topn_select_kernel), dim3(grid),
                              dim3(SEL_THREADS), kargs, 0, st);
  return static_cast<int>(cudaGetLastError());
}

// K32: the first cap row indices (int64) of the stable order of the
// candidates by their words: K31's candidates' words keys [nwords][most]
// (stride most), cand [most] int64 and its count on the device (count,
// K31's info[0]); or, with cand and count null, the words of rows
// 0..n-1 themselves (stride n <= most).
int presto_topn_sort(const void* keys, int32_t nwords, int64_t stride, const void* cand,
                     const void* count, int64_t most, int64_t cap, void* perm, void* stream) {
  if (nwords < 1 || nwords > MAX_WORDS || stride < 1 || cap < 1 || most < cap ||
      most > SORT_MAX_ROWS || (cand == nullptr) != (count == nullptr) ||
      (cand == nullptr ? stride > most : stride != most))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 16) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sort_optin[dev] == 0)
    cudaDeviceGetAttribute(&g_sort_optin[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int64_t bytes = most * (8 * static_cast<int64_t>(nwords) + 4) + SORT_SCRATCH;
  if (bytes > g_sort_optin[dev]) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > g_sort_smem[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        topn_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    g_sort_smem[dev] = static_cast<int>(bytes);
  }
  topn_sort_kernel<<<1, SORT_THREADS, static_cast<size_t>(bytes), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(keys), nwords, stride, static_cast<const int64_t*>(cand),
      static_cast<const int64_t*>(count), most, cap, static_cast<int64_t*>(perm));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
