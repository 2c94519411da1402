// distinct_set (K33): DISTINCT's fold as one hash-set insert and an
// append, with no sort.
//
// Replaces presto_tpu/ops/sort.py:106 `_distinct_step_impl` (the
// sort-based grouping of state ++ batch with zero aggregates). The
// rows of state ++ batch (ids 0 .. S+B-1, the state first) go into one
// hash set; a row is kept exactly when it is the first of its group in
// that order, and the kept rows are written in order. The state is
// already distinct and its live rows are a prefix of its slots, so its
// rows land where they lie and the batch's new rows follow them in
// batch order; a group's representative is its first row, so a state
// row always wins its group. Rows past the capacity are dropped (the
// output reads full, which makes the operator grow the state).
//
//   1. `distinct_insert`, one thread per live row: the row's hash h
//      (csrc/row_hash.cuh's first row hash, computed here) picks a
//      start slot (its low bits) in a power-of-two table of 64-bit
//      words (high 32 bits of h, then the row id; empty = all ones)
//      with at least 2 (S + B) words; linear probing. On an equal tag
//      the keys are compared: a NULL equals a NULL, other values are
//      equal when their bits are (floats by their float64 widening, so
//      -0.0 and +0.0 differ, as their hashes already keep them
//      apart). Equal rows take the
//      smaller id with atomicMin on the word, so the word ends holding
//      the group's first row. A row with a NaN key equals nothing, so
//      it is kept without entering the table. Each row records its word.
//   2. `distinct_append`, a chained scan over tiles of rows
//      (lookback.cuh): a row is kept when its word holds its id; the
//      tile's kept rows get their output slots from the scan and every
//      column is copied with coalesced stores. The owner of a word
//      empties it again, so the table (cached per stream by the caller)
//      is empty after every call and needs no clearing pass; a row that
//      reads an emptied word is not its owner either. Blocks whose
//      tickets come after the row tiles wait for the last row tile's
//      inclusive count and write the slots from there up to the
//      capacity dead.
//
// Bounds of the design: row ids and counts are 32-bit (the caller
// refuses more than 2^31 - 1 rows). The table fits the H100's 50 MB L2
// up to 2^22 words (S + B up to 2,097,152 rows); past it the random
// atomics go to HBM.
//
// The output is one allocation: every column's data (in key order,
// each at a 16-byte aligned offset, cap * its width), then every
// column's mask, then row_valid, each mask cap bytes rounded up to 16
// (`data_bytes`, `write_row`; ops/sort.py `distinct_layout` is its host
// twin).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather.cuh"
#include "lookback.cuh"
#include "row_hash.cuh"

#define THREADS 256
// Both kernels' launch bounds: with the block size alone, ptxas capped
// them at 32 registers and spilled (20-24 bytes of spill stores a
// thread); a minimum of one resident block lets them keep 40 registers
// with no spill (`nvcc -Xptxas -v`).
#define BOUNDS __launch_bounds__(THREADS, 1)
#define VEC 4
#define TILE (THREADS * VEC)
#define WARPS (THREADS / 32)
#define EMPTY 0xffffffffffffffffULL
// a row's recorded word: dead, or kept with no word (a NaN key)
#define SLOT_DEAD -1
#define SLOT_ALONE -2

typedef unsigned long long u64;

struct SetArgs {
  KeyGroups keys[2];  // the state's, the batch's: the same dtypes
  const bool* valid[2];
  int64_t rows0;  // S: batch row i is row S + i
  int64_t n;      // S + B
  u64* table;
  uint64_t mask;  // table words - 1
  int64_t* slot;  // per row: its word, SLOT_DEAD or SLOT_ALONE
};

__device__ __forceinline__ int elem_size(int32_t dtype) {
  switch (dtype) {
    case KD_I8: return 1;
    case KD_I16: return 2;
    case KD_I32:
    case KD_F32: return 4;
    default: return 8;
  }
}

__device__ __forceinline__ int64_t round16(int64_t x) { return (x + 15) & ~int64_t(15); }

__device__ __forceinline__ bool is_float(int32_t dtype) { return dtype == KD_F32 || dtype == KD_F64; }

// A present float key of row i is NaN.
__device__ __forceinline__ bool has_nan(const KeyGroups& k, int64_t i) {
  for (int g = 0; g < k.ngroups; ++g) {
    const KeyCols& c = presto_group(k, g);
    for (int j = 0; j < c.nkeys; ++j) {
      if (!is_float(c.dtype[j]) || !c.mask[j][i]) continue;
      const double v = c.dtype[j] == KD_F32
                           ? static_cast<double>(static_cast<const float*>(c.data[j])[i])
                           : static_cast<const double*>(c.data[j])[i];
      if (v != v) return true;
    }
  }
  return false;
}

// Row i of source a equals row p of source b (see the header).
__device__ __forceinline__ bool rows_equal(const KeyGroups& a, int64_t i, const KeyGroups& b,
                                           int64_t p) {
  for (int g = 0; g < a.ngroups; ++g) {
    const KeyCols& ca = presto_group(a, g);
    const KeyCols& cb = presto_group(b, g);
    for (int j = 0; j < ca.nkeys; ++j) {
      const bool m = ca.mask[j][i];
      if (m != cb.mask[j][p]) return false;
      if (m && presto_key_bits(ca, j, i) != presto_key_bits(cb, j, p)) return false;
    }
  }
  return true;
}

__device__ __forceinline__ int src_of(const SetArgs& a, int64_t r, int64_t* i) {
  const int s = r >= a.rows0 ? 1 : 0;
  *i = s ? r - a.rows0 : r;
  return s;
}

// Insert row r (source s, row i) with hash h; returns its word.
__device__ __forceinline__ int64_t insert_row(const SetArgs& a, int64_t r, int s, int64_t i,
                                              uint64_t h) {
  const uint32_t tag = static_cast<uint32_t>(h >> 32);
  const u64 mine = (static_cast<u64>(tag) << 32) | static_cast<uint32_t>(r);
  uint64_t pos = h & a.mask;
  for (;;) {
    u64 w = *reinterpret_cast<volatile u64*>(a.table + pos);
    if (w == EMPTY) {
      w = atomicCAS(a.table + pos, EMPTY, mine);
      if (w == EMPTY) return static_cast<int64_t>(pos);
    }
    if (static_cast<uint32_t>(w >> 32) == tag) {
      const int64_t o = static_cast<int64_t>(static_cast<uint32_t>(w));
      int64_t oi;
      const int os = src_of(a, o, &oi);
      if (rows_equal(a.keys[s], i, a.keys[os], oi)) {
        atomicMin(a.table + pos, mine);
        return static_cast<int64_t>(pos);
      }
    }
    pos = (pos + 1) & a.mask;
  }
}

__global__ void BOUNDS distinct_insert(const SetArgs a) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; r < a.n;
       r += stride) {
    int64_t i;
    const int s = src_of(a, r, &i);
    int64_t slot = SLOT_DEAD;
    if (a.valid[s][i]) {
      if (has_nan(a.keys[s], i)) {
        slot = SLOT_ALONE;
      } else {
        int64_t h1, h2;
        presto_row_hash_pair(a.keys[s], i, true, false, &h1, &h2);
        slot = insert_row(a, r, s, i, static_cast<uint64_t>(h1));
      }
    }
    a.slot[r] = slot;
  }
}

// Bytes of every column's data in the output: where the masks start.
__device__ __forceinline__ int64_t data_bytes(const KeyGroups& k, int64_t cap) {
  int64_t d = 0;
  for (int g = 0; g < k.ngroups; ++g) {
    const KeyCols& c = presto_group(k, g);
    for (int j = 0; j < c.nkeys; ++j) d += round16(cap * elem_size(c.dtype[j]));
  }
  return d;
}

// Slot `dst` of every column and of row_valid: row i of source s when
// `live`, else dead (zero data, masks clear). `moff`: data_bytes.
__device__ __forceinline__ void write_row(const SetArgs& a, uint8_t* out, int64_t cap,
                                          int64_t moff, int s, int64_t i, bool live,
                                          int64_t dst) {
  const KeyGroups& k = a.keys[s];
  const int64_t mstride = round16(cap);
  int64_t off = 0;
  bool* mask = reinterpret_cast<bool*>(out + moff);
  for (int g = 0; g < k.ngroups; ++g) {
    const KeyCols& kc = presto_group(k, g);
    for (int j = 0; j < kc.nkeys; ++j, mask += mstride) {
      const int size = elem_size(kc.dtype[j]);
      if (live) {
        copy_elem(kc.data[j], i, out + off, dst, size);
        mask[dst] = kc.mask[j][i];
      } else {
        zero_elem(out + off, dst, size);
        mask[dst] = false;
      }
      off += round16(cap * size);
    }
  }
  mask[dst] = live;  // row_valid follows the last mask
}

__global__ void BOUNDS
distinct_append(const SetArgs a, uint8_t* __restrict__ out, int64_t cap, uint32_t* ticket,
                u64* status, uint32_t epoch, uint32_t row_tiles, uint32_t ntiles) {
  __shared__ uint32_t counts[VEC][WARPS];
  __shared__ uint32_t offs[VEC][WARPS];
  __shared__ uint32_t before_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t t = presto_lb_ticket(ticket, ntiles);
  const int64_t moff = data_bytes(a.keys[0], cap);
  if (t >= row_tiles) {
    // a fill block: slots [total, cap) of its chunk are dead
    if (warp == 0) {
      const uint32_t total = row_tiles ? presto_lb_wait_inclusive(status, row_tiles - 1, epoch) : 0;
      if (lane == 0) before_tile = total;
    }
    __syncthreads();
    const int64_t lo = static_cast<int64_t>(t - row_tiles) * TILE;
    const int64_t from = lo > before_tile ? lo : static_cast<int64_t>(before_tile);
    const int64_t to = lo + TILE < cap ? lo + TILE : cap;
    for (int64_t dst = from + threadIdx.x; dst < to; dst += THREADS)
      write_row(a, out, cap, moff, 0, 0, false, dst);
    return;
  }
  const int64_t base = static_cast<int64_t>(t) * TILE;
  bool own[VEC];
  int64_t rows[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int64_t r = base + v * THREADS + threadIdx.x;
    rows[v] = r;
    bool o = false;
    if (r < a.n) {
      const int64_t slot = a.slot[r];
      if (slot == SLOT_ALONE) {
        o = true;
      } else if (slot >= 0) {
        u64* word = a.table + slot;
        o = static_cast<uint32_t>(*reinterpret_cast<volatile u64*>(word)) ==
            static_cast<uint32_t>(r);
        if (o) *word = EMPTY;
      }
    }
    own[v] = o;
    const unsigned bits = __ballot_sync(0xffffffffu, o);
    if (lane == 0) counts[v][warp] = __popc(bits);
  }
  __syncthreads();
  // the tile's counts in row order (v, then warp): one warp scans them
  if (warp == 0) {
    const uint32_t c = counts[lane / WARPS][lane % WARPS];
    uint32_t x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    offs[lane / WARPS][lane % WARPS] = x - c;
    const uint32_t total = __shfl_sync(0xffffffffu, x, 31);
    const uint32_t prefix = presto_lb_prefix(status, t, epoch, total);
    if (lane == 0) before_tile = prefix;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const unsigned bits = __ballot_sync(0xffffffffu, own[v]);
    if (!own[v]) continue;
    const int64_t dst = static_cast<int64_t>(before_tile) + offs[v][warp] + __popc(bits & below);
    if (dst >= cap) continue;
    int64_t i;
    const int s = src_of(a, rows[v], &i);
    write_row(a, out, cap, moff, s, i, true, dst);
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_distinct_tile() { return TILE; }

// State (S rows) and batch (B rows) key columns, nkeys each, flat as
// presto_fill_key_groups takes them, with the same dtypes; their
// row_valid; table: `words` (a power of two >= 2 (S + B)) uint64 words,
// all empty, and left empty; slots: S + B int64s; out: the output
// allocation (see the header) of cap slots; ticket (0 between calls),
// status (ceil((S + B) / TILE) + ceil(cap / TILE) words of another
// epoch) and epoch as K27 takes them. Two launches; reads nothing back.
int presto_distinct_set(const int64_t* skey_data, const int64_t* skey_mask,
                        const int64_t* bkey_data, const int64_t* bkey_mask,
                        const int32_t* dtypes, int32_t nkeys, const void* svalid, int64_t S,
                        const void* bvalid, int64_t B, void* table, int64_t words,
                        void* slots, void* out, int64_t cap, void* ticket, void* status,
                        uint32_t epoch, void* stream) {
  SetArgs a;
  const int64_t n = S + B;
  if (S < 0 || B < 0 || n > 0x7fffffffLL || cap < 1 || cap > 0x7fffffffLL || words < 2 * n ||
      (words & (words - 1)) != 0 || epoch == 0 || epoch > 0x3fffffffu ||
      !presto_fill_key_groups(&a.keys[0], skey_data, skey_mask, dtypes, nkeys) ||
      !presto_fill_key_groups(&a.keys[1], bkey_data, bkey_mask, dtypes, nkeys))
    return static_cast<int>(cudaErrorInvalidValue);
  a.valid[0] = static_cast<const bool*>(svalid);
  a.valid[1] = static_cast<const bool*>(bvalid);
  a.rows0 = S;
  a.n = n;
  a.table = static_cast<u64*>(table);
  a.mask = static_cast<uint64_t>(words - 1);
  a.slot = static_cast<int64_t*>(slots);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const int64_t want = (n + THREADS - 1) / THREADS;
    const int64_t most = static_cast<int64_t>(sms) * 8;
    distinct_insert<<<static_cast<int>(want < most ? want : most), THREADS, 0, st>>>(a);
  }
  const uint32_t row_tiles = static_cast<uint32_t>((n + TILE - 1) / TILE);
  const uint32_t ntiles = row_tiles + static_cast<uint32_t>((cap + TILE - 1) / TILE);
  distinct_append<<<ntiles, THREADS, 0, st>>>(a, static_cast<uint8_t*>(out), cap,
                                                static_cast<uint32_t*>(ticket),
                                                static_cast<u64*>(status), epoch, row_tiles,
                                                ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
