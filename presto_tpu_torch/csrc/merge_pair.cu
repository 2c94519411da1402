// merge_pair (K19): merge two sorted runs into one, by merge path over
// the rows' sort code.
//
// Replaces presto_tpu/ops/merge.py `_merge_pair_jit` (:97) with
// `_lex_count_below` (:65) and `_canonical_ops` (:49) (family merge).
// The merged order is the stable one with ties taking A first: A's row
// i lands at i + #(B rows strictly below it), B's row j at j + #(A rows
// at or below it), which is `merge_pair_plain`'s rank arithmetic.
//
// The runs are the sorted output of each task's ORDER BY, which sorts
// through K24 -> K25 -> K26 (sort_encode.cu, radix_sort.cu,
// gather_rows.cu): by the unsigned words of sort_code.cuh. This kernel
// compares rows by those very words, encoded as it reads them with the
// header's `sort_encode_rows` (~row_valid first, then per key its null
// rank and canonical value: DESC wraps, NaN last under ASC and DESC,
// -0.0 equal to +0.0), so it orders rows exactly as the sort did. Dead
// rows carry ~row_valid = 1 in the top bit, sort last in both runs and
// merge like any other rows.
//
// Merge path: block b owns output slots [b T, (b + 1) T), T = THREADS
// x PER. Warps 0 and 1 find the split (i, j), i + j = the tile's first
// and one past its last slot, with a 33-way search a round (each lane
// encodes one row of A and one of B into shared scratch and the warp
// ballots), ~5 rounds over a million rows. The block then encodes
// A[i0, i1) and B[j0, j1) into shared memory (coalesced reads,
// word-major), each thread finds its sub-split there and merges PER
// outputs serially, noting each output's source; last every column,
// mask and row_valid is copied to the tile's contiguous output range,
// coalesced writes and reads from two contiguous input ranges. The same
// predicate at both levels keeps ties A first across tile edges.
// Columns past INLINE_COLS are read from a device table, so any column
// count is one launch.
//
// What bounds it, measured on the H100: memory latency. A block is a
// chain of dependent steps (the split's rounds, the tile's encode, the
// copy), each a trip to memory, so each step issues every load it can
// before the first use: a search lane's two rows and a thread's PER
// rows (`sort_encode_rows`), each column's PER source rows. The split's
// rounds are the largest step (about half the time at MESH_ORDER's top
// merge). Measured slower there: a whole block searching together
// (eight times the random rows a round), two warps searching the next
// tile while six merge this one (a persistent block), several keys'
// loads at once (the registers cost a resident block). Each key is read
// twice (encode, copy; the second mostly from L2), every column once and
// written once. The byte floor counts every slot's row_valid and the
// live rows' data and masks, read once and written once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sort_code.cuh"

#define THREADS 256
#define MAX_KEYS 24
#define MAX_WORDS 25  // ceil((1 + MAX_KEYS * 65) / 64)
#define INLINE_COLS 24
// shared memory a tile aims at: its words and its source indices
#define TILE_BYTES (32 * 1024)

// one column: run A's and B's data and mask, the output's, element bytes
struct MergeCol {
  const void* src[2];
  const bool* mask[2];
  void* out;
  bool* out_mask;
  int64_t size;
};

struct MergeArgs {
  SortKey key[MAX_KEYS];
  MergeCol col[INLINE_COLS];
  const MergeCol* extra;  // device table of columns [INLINE_COLS, ncols)
  const bool* valid[2];
  bool* out_valid;
  int64_t n[2];
  int32_t nkeys, nwords, pos_valid, ncols;
};

// row x orders strictly before row y: words w[k * stride + x], unsigned
__device__ __forceinline__ bool code_less(const uint64_t* w, int64_t stride, int nwords, int x,
                                          int y) {
  for (int k = 0; k < nwords; ++k) {
    const uint64_t a = w[k * stride + x], b = w[k * stride + y];
    if (a != b) return a < b;
  }
  return false;
}

// The merge path's split at `diag` (the count of A rows among the first
// diag outputs), by one warp: each round samples 32 points of [lo, hi),
// each lane encoding A[p] and B[diag - 1 - p] together into its own
// scratch rows (lane, 32 + lane; stride 128), and keeps the sub-range
// where the ballot turns. A row is taken from A while A[p] <= B[diag -
// 1 - p].
__device__ int64_t warp_split(const MergeArgs& a, int64_t diag, uint64_t* scratch, int lane) {
  int64_t lo = diag > a.n[1] ? diag - a.n[1] : 0;
  int64_t hi = diag < a.n[0] ? diag : a.n[0];
  while (lo < hi) {
    // inside the loop both runs have rows: a lane past a short range
    // encodes row lo, and its vote is dropped
    const int64_t count = hi - lo;
    const bool few = count <= 32;
    const bool active = !few || lane < count;
    const int64_t p = !active ? lo
                      : few   ? lo + lane
                              : lo + (static_cast<int64_t>(lane + 1) * count) / 33;
    const int s[2] = {0, 1};
    const int64_t rr[2] = {p, diag - 1 - p};
    SortPacker pk[2] = {{scratch, 128, lane, 0, 0}, {scratch, 128, 32 + lane, 0, 0}};
    sort_encode_rows<2>(a.key, a.nkeys, a.valid, a.pos_valid, a.nwords, s, rr, pk);
    const bool take = active && !code_less(scratch, 128, a.nwords, 32 + lane, lane);
    const int t = __popc(__ballot_sync(0xffffffffu, take));
    if (few) {
      lo += t;
      hi = lo;
    } else {
      const int64_t nlo = t > 0 ? lo + (static_cast<int64_t>(t) * count) / 33 + 1 : lo;
      if (t < 32) hi = lo + (static_cast<int64_t>(t + 1) * count) / 33;
      lo = nlo;
    }
  }
  return lo;
}

// PER outputs of one column (out0 + q stride), data and mask: every
// load, then every store of a live one
template <typename T, int PER>
__device__ __forceinline__ void copy_col(const MergeCol& col, const int* from_b,
                                         const int64_t* row, const bool* live, int64_t out0,
                                         int stride) {
  T v[PER];
  bool m[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    v[q] = static_cast<const T*>(col.src[from_b[q]])[row[q]];
    m[q] = col.mask[from_b[q]][row[q]];
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    if (live[q]) {
      static_cast<T*>(col.out)[out0 + q * stride] = v[q];
      col.out_mask[out0 + q * stride] = m[q];
    }
  }
}

template <int PER>
__global__ void __launch_bounds__(THREADS) merge_path(const MergeArgs a) {
  extern __shared__ uint64_t smem[];  // [nwords][T] words, then T source indices
  __shared__ int64_t split[2];
  constexpr int T = THREADS * PER;
  const int W = a.nwords, tid = threadIdx.x;
  const int64_t total = a.n[0] + a.n[1];
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * T;
  const int64_t d1 = d0 + T < total ? d0 + T : total;
  // 1. the tile's two splits, warp 0 at d0 and warp 1 at d1, in the
  // words' space (free until the tile is loaded)
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < 2) {
    const int64_t i = warp_split(a, warp ? d1 : d0, smem + warp * 64, lane);
    if (lane == 0) split[warp] = i;
  }
  __syncthreads();
  const int64_t i0 = split[0], j0 = d0 - i0;
  const int n = static_cast<int>(d1 - d0);  // >= 1
  // sorted runs give i0 <= split[1] <= i0 + n; the clamp keeps runs that
  // are not sorted inside both
  int64_t na64 = split[1] - i0;
  const int64_t na_lo = n - (a.n[1] - j0), na_hi = a.n[0] - i0;
  na64 = na64 < na_lo ? na_lo : na64;
  na64 = na64 > na_hi ? na_hi : na64;
  na64 = na64 < 0 ? 0 : na64 > n ? n : na64;
  const int na = static_cast<int>(na64), nb = n - na;
  // 2. the tile's rows as words, A's first, then B's: PER rows a thread
  // (coalesced across the block), their loads in flight together; a row
  // past the tile encodes the tile's first row into a slot no one reads
  {
    int s[PER];
    int64_t rr[PER];
    SortPacker p[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int r = tid + q * THREADS;
      const int rc = r < n ? r : 0;
      s[q] = rc < na ? 0 : 1;
      rr[q] = s[q] ? j0 + (rc - na) : i0 + rc;
      p[q] = SortPacker{smem, T, r, 0, 0};
    }
    sort_encode_rows<PER>(a.key, a.nkeys, a.valid, a.pos_valid, W, s, rr, p);
  }
  __syncthreads();
  // 3. each thread's sub-split, then its PER outputs merged serially
  uint32_t* src = reinterpret_cast<uint32_t*>(smem + static_cast<int64_t>(W) * T);
  const int k0 = tid * PER < n ? tid * PER : n;
  int lo = k0 > nb ? k0 - nb : 0, hi = k0 < na ? k0 : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!code_less(smem, T, W, na + (k0 - 1 - mid), mid)) lo = mid + 1;
    else hi = mid;
  }
  int ii = lo, jj = k0 - lo;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    if (k0 + q < n) {
      const bool take_a = ii < na && (jj >= nb || !code_less(smem, T, W, na + jj, ii));
      src[k0 + q] = take_a ? ii++ : na + jj++;
    }
  }
  __syncthreads();
  // 4. every column to the tile's output range: outputs tid + q THREADS,
  // each column's loads for all of them before its stores
  int from_b[PER];
  int64_t row[PER];
  bool live[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int o = tid + q * THREADS;
    live[q] = o < n;
    const uint32_t si = src[live[q] ? o : 0];
    from_b[q] = si >= static_cast<uint32_t>(na);
    row[q] = from_b[q] ? j0 + (si - na) : i0 + si;
  }
  const int64_t out0 = d0 + tid;
  {
    bool v[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) v[q] = a.valid[from_b[q]][row[q]];
#pragma unroll
    for (int q = 0; q < PER; ++q)
      if (live[q]) a.out_valid[out0 + q * THREADS] = v[q];
  }
  for (int c = 0; c < a.ncols; ++c) {
    const MergeCol& col = c < INLINE_COLS ? a.col[c] : a.extra[c - INLINE_COLS];
    switch (col.size) {
      case 1: copy_col<uint8_t, PER>(col, from_b, row, live, out0, THREADS); break;
      case 2: copy_col<uint16_t, PER>(col, from_b, row, live, out0, THREADS); break;
      case 4: copy_col<uint32_t, PER>(col, from_b, row, live, out0, THREADS); break;
      default: copy_col<uint64_t, PER>(col, from_b, row, live, out0, THREADS); break;
    }
  }
}

// Outputs a thread merges for keys of `nwords` words: a power of two
// whose tile (words and source indices) stays near TILE_BYTES.
static int per_thread(int nwords) {
  const int fit = TILE_BYTES / (THREADS * (8 * nwords + 4));
  return fit >= 8 ? 8 : fit >= 4 ? 4 : fit >= 2 ? 2 : 1;
}

template <int PER>
static int launch(const MergeArgs& a, cudaStream_t stream) {
  const int T = THREADS * PER;
  const int bytes = T * (8 * a.nwords + 4);
  if (bytes > 48 * 1024) {  // a launch past 48 KB opts in first
    const cudaError_t e =
        cudaFuncSetAttribute(merge_path<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t blocks = (a.n[0] + a.n[1] + T - 1) / T;
  merge_path<PER><<<static_cast<unsigned>(blocks), THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_merge_max_keys() { return MAX_KEYS; }
int presto_merge_inline_cols() { return INLINE_COLS; }

// desc (host int64): nkeys, nwords, pos_valid, ncols, na, nb, A's and
// B's row_valid, the output row_valid; per key (nkeys) A's and B's
// data, A's and B's mask, dtype, desc, nulls_first, bit positions of
// its null rank and value, value bits; per column (the first
// INLINE_COLS) A's and B's data, A's and B's mask, the output's data
// and mask, element bytes. extra: the later columns' entries, on the
// device. The runs are sorted by the words these keys encode to.
int presto_merge_pair(const int64_t* desc, const void* extra, void* stream) {
  MergeArgs a;
  a.nkeys = static_cast<int32_t>(desc[0]);
  a.nwords = static_cast<int32_t>(desc[1]);
  a.pos_valid = static_cast<int32_t>(desc[2]);
  a.ncols = static_cast<int32_t>(desc[3]);
  a.n[0] = desc[4];
  a.n[1] = desc[5];
  if (a.nkeys < 0 || a.nkeys > MAX_KEYS || a.nwords < 1 || a.nwords > MAX_WORDS ||
      a.ncols < 0 || (a.ncols > INLINE_COLS && extra == nullptr) || a.n[0] < 0 || a.n[1] < 0 ||
      a.n[0] + a.n[1] > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  a.valid[0] = reinterpret_cast<const bool*>(desc[6]);
  a.valid[1] = reinterpret_cast<const bool*>(desc[7]);
  a.out_valid = reinterpret_cast<bool*>(desc[8]);
  const int64_t* d = desc + 9;
  for (int k = 0; k < a.nkeys; ++k, d += 10) {
    SortKey& key = a.key[k];
    key.data[0] = reinterpret_cast<const void*>(d[0]);
    key.data[1] = reinterpret_cast<const void*>(d[1]);
    key.mask[0] = reinterpret_cast<const bool*>(d[2]);
    key.mask[1] = reinterpret_cast<const bool*>(d[3]);
    key.dtype = static_cast<int32_t>(d[4]);
    key.desc = static_cast<int32_t>(d[5]);
    key.nulls_first = static_cast<int32_t>(d[6]);
    key.pos_rank = static_cast<int32_t>(d[7]);
    key.pos_value = static_cast<int32_t>(d[8]);
    key.width = static_cast<int32_t>(d[9]);
    if (key.dtype < S_BOOL || key.dtype > S_F64 || key.width < 1 || key.width > 64 ||
        key.pos_value + key.width > 64 * a.nwords)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int inline_cols = a.ncols < INLINE_COLS ? a.ncols : INLINE_COLS;
  for (int c = 0; c < inline_cols; ++c, d += 7) {
    MergeCol& col = a.col[c];
    col.src[0] = reinterpret_cast<const void*>(d[0]);
    col.src[1] = reinterpret_cast<const void*>(d[1]);
    col.mask[0] = reinterpret_cast<const bool*>(d[2]);
    col.mask[1] = reinterpret_cast<const bool*>(d[3]);
    col.out = reinterpret_cast<void*>(d[4]);
    col.out_mask = reinterpret_cast<bool*>(d[5]);
    col.size = d[6];
    if (col.size != 1 && col.size != 2 && col.size != 4 && col.size != 8)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  a.extra = static_cast<const MergeCol*>(extra);
  if (a.n[0] + a.n[1] == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (per_thread(a.nwords)) {
    case 8: return launch<8>(a, st);
    case 4: return launch<4>(a, st);
    case 2: return launch<2>(a, st);
    default: return launch<1>(a, st);
  }
}

}  // extern "C"
