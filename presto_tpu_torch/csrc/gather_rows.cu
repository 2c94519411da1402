// gather_rows (K26): one launch moves every column of a batch (data and
// mask of each) and row_valid through a permutation, the second half of
// every sort of the port (after K24 and K25).
//
// Replaces the payload movement of presto_tpu/ops/common.py:232
// `sort_rows` (its variadic `lax.sort` carries every column; the port
// sorts a 32-bit row index and then moves each row once, here) and so
// of ops/sort.py:22 `_sort_batch_impl` and :54 `_topn_step_impl` (which
// keeps the first `cap` rows of state ++ batch and masks rows past `n`),
// the build's column permutation (ops/join.py:196) and the gathers of
// ops/hashagg.py `_group_reduce` (the sorted keys and contributions,
// and each group's first row).
//
// Output row j takes input row perm[j] for j < rows. The input may come
// from up to MAX_SOURCES sources: index p with off[s] <= p < off[s + 1]
// is row p - off[s] of source s (topn's state ++ batch, a merge's
// partial states, with no concatenation).
// live_j = row_valid[perm[j]] (true without a row_valid) and, with a
// limit (a device int64 the kernel reads), j < *limit; row_valid's
// output is live_j, and a mask array marked `and_live` is ANDed with it
// (topn: c.mask & live; the first rows of _group_reduce: m & (j <
// groups)). An array without a mask (hashes, contributions) is one
// array with no partner.
//
// What bounds it: bytes. Each output element is written once and its
// input read once (a random read: rows arrive in sorted order); the
// permutation is read once. One thread per output row walks the
// arrays, so the writes of a warp are coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather.cuh"

#define THREADS 256
#define MAX_ARRAYS 64
#define MAX_SOURCES 8
// source addresses one launch takes: arrays x sources
#define MAX_SLOTS 128

struct Arrays {
  const void* src[MAX_SLOTS];  // array c of source s at c * nsrc + s
  void* dst[MAX_ARRAYS];
  int8_t size[MAX_ARRAYS];
  int8_t and_live[MAX_ARRAYS];
  int32_t count;
  const bool* valid[MAX_SOURCES];
  int64_t off[MAX_SOURCES + 1];
  int32_t nsrc;
};

__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const Arrays a, const int64_t* __restrict__ perm, int64_t rows,
                   bool* out_valid, const int64_t* limit) {
  const int64_t lim = limit != nullptr ? *limit : rows;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; j < rows;
       j += stride) {
    const int64_t p = perm[j];
    int s = 0;
    while (s + 1 < a.nsrc && p >= a.off[s + 1]) ++s;
    const int64_t r = p - a.off[s];
    bool live = j < lim;
    if (a.valid[s] != nullptr) live = live && a.valid[s][r];
    if (out_valid != nullptr) out_valid[j] = live;
    for (int c = 0; c < a.count; ++c) {
      const void* src = a.src[c * a.nsrc + s];
      if (a.and_live[c]) {
        static_cast<bool*>(a.dst[c])[j] = live && static_cast<const bool*>(src)[r];
      } else {
        copy_elem(src, r, a.dst[c], j, a.size[c]);
      }
    }
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_gather_max_arrays() { return MAX_ARRAYS; }

// src: count * nsrc device addresses (array c of source s at
// c * nsrc + s); off: nsrc + 1 row offsets of the sources in the
// concatenation perm indexes (off[0] = 0); valid: nsrc row_valid
// addresses (all null when the sources have none); dst: count
// addresses; sizes: element bytes (1, 2, 4, 8); and_live: 1 for a mask
// ANDed with the row's liveness. out_valid and limit may be null.
int presto_gather_rows(const int64_t* src, int32_t nsrc, const int64_t* off,
                       const int64_t* valid, const int64_t* dst, const int32_t* sizes,
                       const int32_t* and_live, int32_t count, const void* perm, int64_t rows,
                       void* out_valid, const void* limit, void* stream) {
  if (count < 0 || count > MAX_ARRAYS || nsrc < 1 || nsrc > MAX_SOURCES ||
      count * nsrc > MAX_SLOTS || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Arrays a;
  for (int c = 0; c < count; ++c) {
    if (sizes[c] != 1 && sizes[c] != 2 && sizes[c] != 4 && sizes[c] != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    if (and_live[c] && sizes[c] != 1) return static_cast<int>(cudaErrorInvalidValue);
    for (int s = 0; s < nsrc; ++s)
      a.src[c * nsrc + s] = reinterpret_cast<const void*>(src[c * nsrc + s]);
    a.dst[c] = reinterpret_cast<void*>(dst[c]);
    a.size[c] = static_cast<int8_t>(sizes[c]);
    a.and_live[c] = static_cast<int8_t>(and_live[c] != 0);
  }
  a.count = count;
  for (int s = 0; s < nsrc; ++s) a.valid[s] = reinterpret_cast<const bool*>(valid[s]);
  for (int s = 0; s <= nsrc; ++s) a.off[s] = off[s];
  a.nsrc = nsrc;
  const int64_t want = (rows + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  gather_rows_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int64_t*>(perm), rows, static_cast<bool*>(out_valid),
      static_cast<const int64_t*>(limit));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
