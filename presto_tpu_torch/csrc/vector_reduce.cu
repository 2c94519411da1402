// vector_reduce (K30): the reductions of VECTOR state components, whose
// state is K values per group: approx_percentile's int32 histogram of
// 1024 buckets (summed) and approx_distinct's int8 HyperLogLog
// registers (maxed).
//
// Replaces the 2-D half of presto_tpu/ops/hashagg.py: `_slot_reduce`
// (:884, the direct path's one-hot matmul / segment op over [rows, K]
// contributions), `_sorted_reduce` (:535) over the 2-D payload of
// `_group_reduce` (:647-655) and its axis-0 reduction for a global
// aggregation (:594-607). The reference's per-row contribution is a
// one-hot [rows, K] row; here a row brings one (index, value) pair and
// stands for the row holding `value` at `index` and 0 elsewhere, so
// nothing of [rows, K] is ever written (at one million rows the
// histogram's one-hot would be 4 GB).
//
// Entry points:
//   * presto_vector_direct: the direct path (K1's vector mode). Each
//     live row's slot is K1's mixed-radix code of its keys; its pair is
//     folded into table[slot, index]. A block folds its rows into a
//     shared-memory table when slots * K fits and then adds (or maxes)
//     the non-zero entries into the global table; otherwise every row
//     goes to the global table directly. Under "max" every register of
//     a slot that a live row reached is then raised to at least 0 (the
//     zero entries of the reference's one-hot row).
//   * presto_vector_segments: one block per output group over the rows
//     of that group, given K6's segment starts over rows in group order
//     (or, without them, one group of all rows: the global
//     aggregation). Sparse input: the pairs of those rows (already
//     moved into group order by K26), folded into a shared table of K
//     entries that starts at 0. Dense input: whole K-wide state rows
//     of up to PRESTO_MAX_SOURCES partial states, read through the sort
//     permutation with no concatenation (hashagg_merge), folded from
//     the reduction's identity. Groups past the live count get the
//     identity row. With a carry (the streaming aggregation, over
//     K8's segments): the carried group's K-wide row is folded into
//     group 0 when K8 found their keys equal, and the last live group's
//     row (the carry itself when the batch has no group) is written as
//     the new carry, as K8 does for the scalar components.
//
// Integer sums and maxima are exact, so the result does not depend on
// the order of the atomics.
//
// What bounds it: bytes for the dense merge (each partial row read once,
// each output row written once) and for the sparse folds the rows' pairs
// read once; the atomics on a few hot registers (a skewed group) can
// serialise, which shared memory absorbs per block.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_KEYS 8
#define MAX_SOURCES 8
// most shared-memory bytes a block's table may take (opted in past 48 KB)
#define SHARED_BYTES (160 * 1024)

enum { OP_SUM = 0, OP_MAX = 2 };
enum { DT_I8 = 1, DT_I32 = 3 };

struct SlotKeys {
  const int32_t* code[MAX_KEYS];
  const bool* mask[MAX_KEYS];
  int32_t domain[MAX_KEYS];
  int32_t nkeys;
};

// Dense K-wide rows of up to MAX_SOURCES states: row r of the
// concatenation lies in source s with off[s] <= r < off[s + 1].
struct Sources {
  const void* rows[MAX_SOURCES];
  int64_t off[MAX_SOURCES + 1];
  int32_t count;
};

__device__ __forceinline__ int32_t load_val(const void* p, int dt, int64_t i) {
  return dt == DT_I8 ? static_cast<int32_t>(static_cast<const int8_t*>(p)[i])
                     : static_cast<const int32_t*>(p)[i];
}

__device__ __forceinline__ void store_val(void* p, int dt, int64_t i, int32_t v) {
  if (dt == DT_I8) {
    static_cast<int8_t*>(p)[i] = static_cast<int8_t>(v);
  } else {
    static_cast<int32_t*>(p)[i] = v;
  }
}

// max of a signed byte in global memory, by a compare-and-swap on the
// 32-bit word that holds it
__device__ void atomic_max_i8(int8_t* addr, int8_t v) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(addr);
  unsigned int* word = reinterpret_cast<unsigned int*>(a & ~uintptr_t(3));
  const int shift = static_cast<int>(a & 3) * 8;
  unsigned int old = *word, assumed;
  do {
    assumed = old;
    const int8_t cur = static_cast<int8_t>((assumed >> shift) & 0xFF);
    if (cur >= v) return;
    const unsigned int next =
        (assumed & ~(0xFFu << shift)) | (static_cast<unsigned int>(static_cast<uint8_t>(v)) << shift);
    old = atomicCAS(word, assumed, next);
  } while (old != assumed);
}

__device__ __forceinline__ void global_fold(void* table, int dt, int op, int64_t at, int32_t v) {
  if (op == OP_SUM) {
    atomicAdd(static_cast<int32_t*>(table) + at, v);
  } else if (dt == DT_I8) {
    atomic_max_i8(static_cast<int8_t*>(table) + at, static_cast<int8_t>(v));
  } else {
    atomicMax(static_cast<int32_t*>(table) + at, v);
  }
}

__device__ __forceinline__ void shared_fold(int32_t* t, int op, int k, int32_t v) {
  if (op == OP_SUM) {
    atomicAdd(t + k, v);
  } else {
    atomicMax(t + k, v);
  }
}

__global__ void __launch_bounds__(THREADS)
vector_direct_rows(const SlotKeys keys, const bool* __restrict__ row_valid, int64_t n,
                   const int32_t* __restrict__ index, const void* value, void* table,
                   int32_t slots, int32_t K, int op, int dt, uint8_t* touched, bool use_shared) {
  extern __shared__ int32_t sh[];
  const int64_t cells = static_cast<int64_t>(slots) * K;
  if (use_shared) {
    for (int64_t c = threadIdx.x; c < cells; c += blockDim.x) sh[c] = 0;
    __syncthreads();
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!row_valid[i]) continue;
    int64_t slot = 0;
    for (int j = 0; j < keys.nkeys; ++j) {
      const int32_t dom = keys.domain[j];
      const int32_t c = keys.mask[j][i] ? keys.code[j][i] : dom;
      slot = slot * (dom + 1) + c;
    }
    if (op == OP_MAX) touched[slot] = 1;
    const int32_t v = load_val(value, dt, i);
    const int64_t at = slot * K + index[i];
    if (use_shared) {
      shared_fold(sh, op, static_cast<int>(at), v);
    } else {
      global_fold(table, dt, op, at, v);
    }
  }
  if (!use_shared) return;
  __syncthreads();
  for (int64_t c = threadIdx.x; c < cells; c += blockDim.x) {
    const int32_t v = sh[c];
    if (op == OP_SUM ? v != 0 : v > 0) global_fold(table, dt, op, c, v);
  }
}

// under "max": every register of a slot a live row reached is >= 0
__global__ void __launch_bounds__(THREADS)
vector_direct_floor(void* table, const uint8_t* __restrict__ touched, int32_t slots, int32_t K,
                    int dt) {
  const int64_t cells = static_cast<int64_t>(slots) * K;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; c < cells;
       c += stride) {
    if (touched[c / K] && load_val(table, dt, c) < 0) store_val(table, dt, c, 0);
  }
}

struct SegArgs {
  // sparse input (index != null) in group order
  const int32_t* index;
  const void* value;
  // dense input
  Sources src;
  const int64_t* perm;  // position -> row of the concatenated sources, or null
  const bool* valid;    // per position, or null (every row counts)
  // K6's group starts and stats ({groups, overflow, live end, live});
  // null: one group of all n rows
  const int64_t* starts;
  const int64_t* stats;
  int64_t n;
  void* out;
  int64_t out_cap;
  int32_t K;
  int32_t op;
  int32_t dt;
  int32_t ident;
  int32_t live_init;
  // the streaming carry ([K] in the output's dtype) or null; folded into
  // group 0 when *carry_same (K8's `same`); the new carry to carry_out
  const void* carry_in;
  const int64_t* carry_same;
  void* carry_out;
};

__device__ __forceinline__ int32_t fold(int op, int32_t a, int32_t b) {
  return op == OP_SUM ? a + b : (a > b ? a : b);
}

// Group g's folded value v at k as written: the carry folded into group
// 0 when K8 found their keys equal; the last live group's value also
// written as the new carry.
__device__ __forceinline__ void store_group(const SegArgs& a, int64_t g, int64_t live, int k,
                                            int32_t v) {
  if (a.carry_in != nullptr && g == 0 && *a.carry_same != 0)
    v = fold(a.op, v, load_val(a.carry_in, a.dt, k));
  store_val(a.out, a.dt, g * a.K + k, v);
  if (a.carry_in != nullptr && g == live - 1) store_val(a.carry_out, a.dt, k, v);
}

__global__ void __launch_bounds__(THREADS) vector_segments_kernel(const SegArgs a) {
  extern __shared__ int32_t sh[];
  const int64_t groups = a.stats != nullptr ? a.stats[0] : 1;
  const int64_t live = a.stats != nullptr ? a.stats[3] : 1;
  for (int64_t g = blockIdx.x; g < a.out_cap; g += gridDim.x) {
    const int64_t base = g * a.K;
    if (g >= live) {
      for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
        store_val(a.out, a.dt, base + k, a.ident);
        // no group in the batch: the carry passes through
        if (a.carry_in != nullptr && g == 0)
          store_val(a.carry_out, a.dt, k, load_val(a.carry_in, a.dt, k));
      }
      continue;
    }
    int64_t start = 0, end = a.n;
    if (a.starts != nullptr) {
      start = a.starts[g];
      end = g + 1 < groups ? a.starts[g + 1] : a.stats[2];
    }
    if (a.index != nullptr) {
      for (int k = threadIdx.x; k < a.K; k += blockDim.x) sh[k] = a.live_init;
      __syncthreads();
      for (int64_t p = start + threadIdx.x; p < end; p += blockDim.x) {
        if (a.valid != nullptr && !a.valid[p]) continue;
        shared_fold(sh, a.op, a.index[p], load_val(a.value, a.dt, p));
      }
      __syncthreads();
      for (int k = threadIdx.x; k < a.K; k += blockDim.x) store_group(a, g, live, k, sh[k]);
      __syncthreads();
    } else {
      for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
        int32_t acc = a.live_init;
        for (int64_t p = start; p < end; ++p) {
          if (a.valid != nullptr && !a.valid[p]) continue;
          const int64_t r = a.perm != nullptr ? a.perm[p] : p;
          int s = 0;
          while (s + 1 < a.src.count && r >= a.src.off[s + 1]) ++s;
          acc = fold(a.op, acc,
                     load_val(a.src.rows[s], a.dt, (r - a.src.off[s]) * a.K + k));
        }
        store_group(a, g, live, k, acc);
      }
    }
  }
}

static int sm_count() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

static bool valid_kind(int32_t op, int32_t dt) {
  return (op == OP_SUM && dt == DT_I32) || (op == OP_MAX && (dt == DT_I8 || dt == DT_I32));
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Key codes (int32), masks and domains of nkeys <= MAX_KEYS keys, as
// K1 takes them; row_valid[n]; the rows' pairs index[n] (int32) and
// value[n] (the table's dtype); table[slots, K], updated in place;
// touched: slots + 1 bytes, zeroed by the caller.
int presto_vector_direct(const int64_t* key_code, const int64_t* key_mask, const int32_t* domains,
                         int32_t nkeys, const void* row_valid, int64_t n, const void* index,
                         const void* value, void* table, int32_t slots, int32_t K, int32_t op,
                         int32_t dt, void* touched, void* stream) {
  if (nkeys < 0 || nkeys > MAX_KEYS || slots < 1 || K < 1 || !valid_kind(op, dt))
    return static_cast<int>(cudaErrorInvalidValue);
  SlotKeys keys;
  for (int j = 0; j < nkeys; ++j) {
    keys.code[j] = reinterpret_cast<const int32_t*>(key_code[j]);
    keys.mask[j] = reinterpret_cast<const bool*>(key_mask[j]);
    keys.domain[j] = domains[j];
  }
  keys.nkeys = nkeys;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t cells = static_cast<int64_t>(slots) * K;
  const int64_t smem = cells * 4;
  const bool use_shared = smem <= SHARED_BYTES;
  if (use_shared && smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(vector_direct_rows,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n > 0) {
    const int64_t want = (n + THREADS - 1) / THREADS;
    const int64_t most = static_cast<int64_t>(sm_count()) * (use_shared ? 1 : 8);
    const int blocks = static_cast<int>(want < most ? want : most);
    vector_direct_rows<<<blocks, THREADS, use_shared ? smem : 0, s>>>(
        keys, static_cast<const bool*>(row_valid), n, static_cast<const int32_t*>(index), value,
        table, slots, K, op, dt, static_cast<uint8_t*>(touched), use_shared);
  }
  if (op == OP_MAX) {
    const int64_t want = (cells + THREADS - 1) / THREADS;
    const int64_t most = static_cast<int64_t>(sm_count()) * 8;
    const int blocks = static_cast<int>(want < most ? want : most);
    vector_direct_floor<<<blocks, THREADS, 0, s>>>(table, static_cast<const uint8_t*>(touched),
                                                   slots, K, dt);
  }
  return static_cast<int>(cudaGetLastError());
}

// Sparse input: index/value per position (value in the output's dtype),
// src_rows null. Dense input: index null, src_rows/src_off the nsrc
// partial states ([rows_s, K] each, rows_s = off[s + 1] - off[s]) and
// perm (or null). valid: per position or null. starts/stats: K6's, or
// null for one group of all n positions. out[out_cap, K]. carry_in[K]
// (the output's dtype), carry_same (an int64 flag on the device) and
// carry_out[K]: the streaming carry, all null without one.
int presto_vector_segments(const void* index, const void* value, const int64_t* src_rows,
                           const int64_t* src_off, int32_t nsrc, const void* perm,
                           const void* valid, const void* starts, const void* stats, int64_t n,
                           void* out, int64_t out_cap, int32_t K, int32_t op, int32_t dt,
                           int32_t ident, int32_t live_init, const void* carry_in,
                           const void* carry_same, void* carry_out, void* stream) {
  if (out_cap < 1 || K < 1 || n < 0 || !valid_kind(op, dt) || nsrc < 0 || nsrc > MAX_SOURCES ||
      (index == nullptr && nsrc < 1) || ((starts == nullptr) != (stats == nullptr)) ||
      ((carry_in == nullptr) != (carry_same == nullptr)) ||
      ((carry_in == nullptr) != (carry_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  SegArgs a;
  a.index = static_cast<const int32_t*>(index);
  a.value = value;
  a.src.count = nsrc;
  for (int s = 0; s < nsrc; ++s) a.src.rows[s] = reinterpret_cast<const void*>(src_rows[s]);
  for (int s = 0; s <= nsrc && nsrc > 0; ++s) a.src.off[s] = src_off[s];
  a.perm = static_cast<const int64_t*>(perm);
  a.valid = static_cast<const bool*>(valid);
  a.starts = static_cast<const int64_t*>(starts);
  a.stats = static_cast<const int64_t*>(stats);
  a.n = n;
  a.out = out;
  a.out_cap = out_cap;
  a.K = K;
  a.op = op;
  a.dt = dt;
  a.ident = ident;
  a.live_init = live_init;
  a.carry_in = carry_in;
  a.carry_same = static_cast<const int64_t*>(carry_same);
  a.carry_out = carry_out;
  const int64_t smem = index != nullptr ? static_cast<int64_t>(K) * 4 : 0;
  if (smem > SHARED_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(vector_segments_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t most = static_cast<int64_t>(sm_count()) * 16;
  const int blocks = static_cast<int>(out_cap < most ? out_cap : most);
  vector_segments_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
