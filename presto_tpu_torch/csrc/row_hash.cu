// row_hash (K3): both row hashes of every row of a batch, with the
// dead-row sentinels folded in, in one launch.
//
// Replaces presto_tpu/ops/join.py `_hash_batch` (the build's hashes,
// :173) and the hash half of presto_tpu/ops/hashagg.py `_group_reduce`
// (:619-623): `row_hash` and `row_hash2` of ops/common.py:167,177 over
// N key columns, then `where(valid, h, INT64_MAX)` (and for the join
// `where(valid, h2, INT64_MIN)`). The hash functions themselves live in
// row_hash.cuh, shared with the join probe (K5).
//
// The rows may come from up to MAX_SOURCES sources (a merge's partial
// states, presto_tpu/ops/hashagg.py:818 `merge_partials`, which the
// reference concatenates first): the hashes are written for their
// concatenation, with nothing concatenated.
//
// What bounds it: bytes. Each row reads its key data and masks and
// row_valid once and writes two int64s; the mixing is ~10 integer
// operations per key, far under the card's integer rate. One thread per
// row, grid-stride, so consecutive lanes read consecutive addresses.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_hash.cuh"

#define THREADS 256
#define MAX_SOURCES 8

// Up to MAX_SOURCES sources of rows with the same key columns (the
// partial states of a merge, hashagg_merge): row i of the output is row
// i - off[s] of source s, off[s] <= i < off[s + 1]. One source is a
// plain batch.
struct HashSources {
  KeyCols keys[MAX_SOURCES];
  const bool* valid[MAX_SOURCES];
  int64_t off[MAX_SOURCES + 1];
  int32_t count;
};

__global__ void __launch_bounds__(THREADS)
row_hash_kernel(const HashSources src, bool nulls_invalid, int64_t* __restrict__ h,
                int64_t* __restrict__ h2) {
  const int64_t n = src.off[src.count];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int s = 0;
    while (s + 1 < src.count && i >= src.off[s + 1]) ++s;
    const int64_t r = i - src.off[s];
    int64_t a, b;
    presto_row_hash_pair(src.keys[s], r, src.valid[s][r], nulls_invalid, &a, &b);
    h[i] = a;
    h2[i] = b;
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// nsrc sources of nkeys key columns each: key_data/key_mask hold
// nsrc * nkeys device addresses, source after source, dtypes the nkeys
// KeyDtype codes (the same in every source); valid: nsrc device
// addresses of row_valid; off: nsrc + 1 row offsets (off[0] = 0).
// Writes h[off[nsrc]] and h2[off[nsrc]].
int presto_row_hash(const int64_t* key_data, const int64_t* key_mask, const int32_t* dtypes,
                    int32_t nkeys, int32_t nsrc, const int64_t* valid, const int64_t* off,
                    int32_t nulls_invalid, void* h, void* h2, void* stream) {
  if (nsrc < 1 || nsrc > MAX_SOURCES) return static_cast<int>(cudaErrorInvalidValue);
  HashSources src;
  for (int s = 0; s < nsrc; ++s) {
    if (!presto_fill_keys(&src.keys[s], key_data + s * nkeys, key_mask + s * nkeys, dtypes,
                          nkeys))
      return static_cast<int>(cudaErrorInvalidValue);
    src.valid[s] = reinterpret_cast<const bool*>(valid[s]);
  }
  for (int s = 0; s <= nsrc; ++s) src.off[s] = off[s];
  src.count = nsrc;
  const int64_t n = off[nsrc];
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t want = (n + THREADS - 1) / THREADS;
  int64_t cap = static_cast<int64_t>(sms) * 8;
  int blocks = static_cast<int>(want < cap ? want : cap);
  row_hash_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      src, nulls_invalid != 0, static_cast<int64_t*>(h), static_cast<int64_t*>(h2));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
