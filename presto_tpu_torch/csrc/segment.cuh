// segment.cuh: the grouping arithmetic shared by K6 (segment_reduce.cu,
// rows sorted by their row hashes) and K8 (stream_reduce.cu, rows
// already sorted by the group keys): state-component types and
// reductions, the block scans that turn per-row group starts into
// packed group ids, and the deterministic reductions of a group's rows
// by one thread, one warp or one block.
//
// A group's float sum is taken in an order fixed by its rows and the
// layout: one thread adds them in row order; a warp's lanes (a block's
// threads) stride over them and a fixed shuffle tree combines the
// partials. So the order of additions is the same on every run (no
// atomics). Integer sums wrap like the reference's int64 segment_sum.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_hash.cuh"

#define PRESTO_SEG_TILE 1024
#define PRESTO_MAX_COMPS 64

enum Dtype { DT_I32 = 0, DT_I64 = 1, DT_F32 = 2, DT_F64 = 3 };
enum Op { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };

// The state components one call reduces: contribution rows in, one
// value per output slot out.
struct Comps {
  const void* contrib[PRESTO_MAX_COMPS];
  void* out[PRESTO_MAX_COMPS];
  int8_t dtype[PRESTO_MAX_COMPS];
  int8_t op[PRESTO_MAX_COMPS];
  int32_t ncomp;
};

// Fill `c` from host arrays; false when ncomp is out of range.
static inline bool presto_fill_comps(Comps* c, const int64_t* contrib, const int64_t* out,
                                     const int32_t* dtypes, const int32_t* ops, int32_t ncomp) {
  if (ncomp < 0 || ncomp > PRESTO_MAX_COMPS) return false;
  for (int j = 0; j < ncomp; ++j) {
    c->contrib[j] = reinterpret_cast<const void*>(contrib[j]);
    c->out[j] = reinterpret_cast<void*>(out[j]);
    c->dtype[j] = static_cast<int8_t>(dtypes[j]);
    c->op[j] = static_cast<int8_t>(ops[j]);
  }
  c->ncomp = ncomp;
  return true;
}

template <typename T>
__device__ __forceinline__ T identity(int op);
template <>
__device__ __forceinline__ int32_t identity<int32_t>(int op) {
  return op == OP_SUM ? 0 : (op == OP_MIN ? INT32_MAX : INT32_MIN);
}
template <>
__device__ __forceinline__ int64_t identity<int64_t>(int op) {
  return op == OP_SUM ? 0 : (op == OP_MIN ? INT64_MAX : INT64_MIN);
}
template <>
__device__ __forceinline__ float identity<float>(int op) {
  return op == OP_SUM ? 0.0f
                      : (op == OP_MIN ? __int_as_float(0x7f7fffff) : -__int_as_float(0x7f7fffff));
}
template <>
__device__ __forceinline__ double identity<double>(int op) {
  return op == OP_SUM ? 0.0
                      : (op == OP_MIN ? __longlong_as_double(0x7fefffffffffffffLL)
                                      : -__longlong_as_double(0x7fefffffffffffffLL));
}

__device__ __forceinline__ int32_t add_wrap(int32_t x, int32_t y) {
  return static_cast<int32_t>(static_cast<uint32_t>(x) + static_cast<uint32_t>(y));
}
__device__ __forceinline__ int64_t add_wrap(int64_t x, int64_t y) {
  return static_cast<int64_t>(static_cast<uint64_t>(x) + static_cast<uint64_t>(y));
}
__device__ __forceinline__ float add_wrap(float x, float y) { return x + y; }
__device__ __forceinline__ double add_wrap(double x, double y) { return x + y; }

// min / max let a NaN win, as the reference's segment_min / segment_max
// (jnp.minimum / jnp.maximum) do, whatever the order of combination
// (x != x only for a NaN; CUDA's fmin / fmax would drop it).
template <typename T>
__device__ __forceinline__ T combine(T x, T y, int op) {
  if (op == OP_SUM) return add_wrap(x, y);
  if (x != x) return x;
  if (y != y) return y;
  if (op == OP_MIN) return y < x ? y : x;
  return y > x ? y : x;
}

// Key j of row i against key j of row p (NULL == NULL; a float NaN
// differs from itself, as the reference's `!=`).
__device__ __forceinline__ bool presto_key_differs(const KeyCols& k, int j, int64_t i, int64_t p) {
  const bool m = k.mask[j][i], pm = k.mask[j][p];
  if (m != pm) return true;
  if (!m) return false;
  const void* d = k.data[j];
  switch (k.dtype[j]) {
    case KD_I8: return static_cast<const int8_t*>(d)[i] != static_cast<const int8_t*>(d)[p];
    case KD_I16: return static_cast<const int16_t*>(d)[i] != static_cast<const int16_t*>(d)[p];
    case KD_I32: return static_cast<const int32_t*>(d)[i] != static_cast<const int32_t*>(d)[p];
    case KD_F32: return static_cast<const float*>(d)[i] != static_cast<const float*>(d)[p];
    case KD_F64: return static_cast<const double*>(d)[i] != static_cast<const double*>(d)[p];
    default: return static_cast<const int64_t*>(d)[i] != static_cast<const int64_t*>(d)[p];
  }
}

__device__ __forceinline__ bool presto_keys_differ(const KeyCols& k, int64_t i, int64_t p) {
  for (int j = 0; j < k.nkeys; ++j)
    if (presto_key_differs(k, j, i, p)) return true;
  return false;
}

__device__ __forceinline__ bool presto_keys_differ(const KeyGroups& k, int64_t i, int64_t p) {
  for (int g = 0; g < k.ngroups; ++g)
    if (presto_keys_differ(presto_group(k, g), i, p)) return true;
  return false;
}

// ORs `bit` into flags[i] where row i's keys of one group differ from
// row i - 1's: one launch per group of at most PRESTO_MAX_KEYS columns,
// so a boundary pass over rows in key order takes any number of keys
// (K13's partition and order keys).
__global__ void presto_key_changes_kernel(const KeyCols k, int64_t n, int bit,
                                          uint8_t* __restrict__ flags) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < 1 || i >= n) return;
  if (presto_keys_differ(k, i, i - 1)) flags[i] |= static_cast<uint8_t>(bit);
}

static inline int presto_launch_key_changes(const int64_t* data, const int64_t* mask,
                                            const int32_t* dtypes, int32_t nkeys, int64_t n,
                                            int32_t bit, void* flags, void* stream) {
  KeyCols k;
  if (!presto_fill_keys(&k, data, mask, dtypes, nkeys)) return static_cast<int>(cudaErrorInvalidValue);
  if (n < 2) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  presto_key_changes_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(k, n, bit,
                                                                   static_cast<uint8_t*>(flags));
  return static_cast<int>(cudaGetLastError());
}

struct ScanSum {
  __device__ __forceinline__ int64_t operator()(int64_t a, int64_t b) const { return a + b; }
};
struct ScanMax {
  __device__ __forceinline__ int64_t operator()(int64_t a, int64_t b) const { return b > a ? b : a; }
};
struct ScanMin {
  __device__ __forceinline__ int64_t operator()(int64_t a, int64_t b) const { return b < a ? b : a; }
};

// Exclusive scan of `v` under `op` (with identity `ident`) over the
// block (blockDim.x a multiple of 32, at most 1024); `*total` gets the
// whole block's result. Every thread of the block must call it.
template <typename OpT>
__device__ __forceinline__ int64_t block_exclusive_scan_op(int64_t v, int64_t ident, OpT op,
                                                           int64_t* total) {
  __shared__ int64_t warp_acc[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int64_t x = v;  // inclusive within the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = op(y, x);
  }
  int64_t ex = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) ex = ident;
  __syncthreads();  // warp_acc may still be read from an earlier call
  if (lane == 31) warp_acc[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int64_t w = lane < nw ? warp_acc[lane] : ident;
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = op(y, w);
    }
    if (lane < nw) warp_acc[lane] = w;
  }
  __syncthreads();
  const int64_t before = wid > 0 ? warp_acc[wid - 1] : ident;
  *total = warp_acc[nw - 1];
  return op(before, ex);
}

// Exclusive prefix sum of `v` over the block (see
// block_exclusive_scan_op).
__device__ __forceinline__ int64_t block_exclusive_scan(int64_t v, int64_t* total) {
  return block_exclusive_scan_op(v, 0, ScanSum(), total);
}

// One block scans ntiles per-tile counts in place into exclusive
// offsets; returns the total to every thread.
__device__ __forceinline__ int64_t presto_scan_tiles(int64_t* __restrict__ counts, int64_t ntiles) {
  const int64_t per = (ntiles + blockDim.x - 1) / blockDim.x;
  const int64_t lo = static_cast<int64_t>(threadIdx.x) * per;
  const int64_t hi = lo + per < ntiles ? lo + per : ntiles;
  int64_t s = 0;
  for (int64_t t = lo; t < hi; ++t) s += counts[t];
  int64_t total;
  int64_t off = block_exclusive_scan(s, &total);
  for (int64_t t = lo; t < hi; ++t) {
    const int64_t c = counts[t];
    counts[t] = off;
    off += c;
  }
  return total;
}

// Per PRESTO_SEG_TILE-row tile (one block of that many threads): the
// packed group id of every group start (flags[i] = 1) from the tile's
// offset and a block scan; starts[g] = its row, for g <= out_cap.
__device__ __forceinline__ void presto_assign_starts(const uint8_t* __restrict__ flags, int64_t n,
                                                     int64_t out_cap,
                                                     const int64_t* __restrict__ tile_offsets,
                                                     int64_t* __restrict__ starts) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * PRESTO_SEG_TILE + threadIdx.x;
  const int64_t b = i < n ? flags[i] : 0;
  int64_t total;
  const int64_t excl = block_exclusive_scan(b, &total);
  if (b) {
    const int64_t g = tile_offsets[blockIdx.x] + excl;
    if (g <= out_cap) starts[g] = i;
  }
}

// One warp reduces the live rows of [start, end) of a component; the
// result is in lane 0 (the identity when !live).
template <typename T>
__device__ __forceinline__ T presto_warp_reduce(const void* contrib, const bool* __restrict__ valid,
                                                int op, int64_t start, int64_t end, bool live,
                                                int lane) {
  T acc = identity<T>(op);
  if (live) {
    const T* __restrict__ src = static_cast<const T*>(contrib);
    for (int64_t r = start + lane; r < end; r += 32)
      if (valid[r]) acc = combine(acc, src[r], op);
    for (int o = 16; o > 0; o >>= 1) acc = combine(acc, __shfl_down_sync(0xffffffffu, acc, o), op);
  }
  return acc;
}

// Slot g of every component: the warp's reduction of its rows, then
// (fold != nullptr) combined with fold[c][0] — the streaming carry.
template <typename T>
__device__ __forceinline__ void presto_reduce_comp(const Comps& cs, int c, const bool* valid,
                                                   int64_t g, int64_t start, int64_t end,
                                                   bool live, int lane, const void* fold) {
  const int op = cs.op[c];
  T acc = presto_warp_reduce<T>(cs.contrib[c], valid, op, start, end, live, lane);
  if (lane == 0) {
    if (fold != nullptr) acc = combine(acc, static_cast<const T*>(fold)[0], op);
    static_cast<T*>(cs.out[c])[g] = acc;
  }
}

__device__ __forceinline__ void presto_reduce_slot(const Comps& cs, const bool* valid, int64_t g,
                                                   int64_t start, int64_t end, bool live,
                                                   int lane, const void* const* fold) {
  for (int c = 0; c < cs.ncomp; ++c) {
    const void* f = fold != nullptr ? fold[c] : nullptr;
    switch (cs.dtype[c]) {
      case DT_I32: presto_reduce_comp<int32_t>(cs, c, valid, g, start, end, live, lane, f); break;
      case DT_I64: presto_reduce_comp<int64_t>(cs, c, valid, g, start, end, live, lane, f); break;
      case DT_F32: presto_reduce_comp<float>(cs, c, valid, g, start, end, live, lane, f); break;
      default: presto_reduce_comp<double>(cs, c, valid, g, start, end, live, lane, f); break;
    }
  }
}

// One thread reduces the live rows of [start, end) of a component in
// row order (the identity for an empty range).
template <typename T>
__device__ __forceinline__ T presto_thread_reduce(const void* contrib,
                                                  const bool* __restrict__ valid, int op,
                                                  int64_t start, int64_t end) {
  T acc = identity<T>(op);
  const T* __restrict__ src = static_cast<const T*>(contrib);
  for (int64_t r = start; r < end; ++r)
    if (valid[r]) acc = combine(acc, src[r], op);
  return acc;
}

// The whole block (blockDim.x a multiple of 32, at most 1024) reduces
// the live rows of [start, end) of a component (every row when `valid`
// is null): its threads stride over the rows, a shuffle tree combines
// each warp's partials and warp 0 those of the warps, in a fixed order.
// The result is in thread 0. `scratch` is shared memory of at least 32
// words. Every thread of the block must call it.
template <typename T>
__device__ __forceinline__ T presto_block_reduce(const void* contrib,
                                                 const bool* __restrict__ valid, int op,
                                                 int64_t start, int64_t end,
                                                 unsigned long long* scratch) {
  T acc = identity<T>(op);
  const T* __restrict__ src = static_cast<const T*>(contrib);
  for (int64_t r = start + threadIdx.x; r < end; r += blockDim.x)
    if (valid == nullptr || valid[r]) acc = combine(acc, src[r], op);
  for (int o = 16; o > 0; o >>= 1) acc = combine(acc, __shfl_down_sync(0xffffffffu, acc, o), op);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  T* part = reinterpret_cast<T*>(scratch);
  __syncthreads();  // scratch may still be read from an earlier call
  if (lane == 0) part[wid] = acc;
  __syncthreads();
  if (wid == 0) {
    acc = lane < static_cast<int>(blockDim.x >> 5) ? part[lane] : identity<T>(op);
    for (int o = 16; o > 0; o >>= 1)
      acc = combine(acc, __shfl_down_sync(0xffffffffu, acc, o), op);
  }
  return acc;
}

__device__ __forceinline__ int presto_comp_size(int dtype) {
  return dtype == DT_I32 || dtype == DT_F32 ? 4 : 8;
}
