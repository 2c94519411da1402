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
// What bounds it: bytes. Each row reads its key data and masks and
// row_valid once and writes two int64s; the mixing is ~10 integer
// operations per key, far under the card's integer rate. One thread per
// row, grid-stride, so consecutive lanes read consecutive addresses.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_hash.cuh"

#define THREADS 256

__global__ void __launch_bounds__(THREADS)
row_hash_kernel(const KeyCols keys, const bool* __restrict__ row_valid, int64_t n,
                bool nulls_invalid, int64_t* __restrict__ h, int64_t* __restrict__ h2) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int64_t a, b;
    presto_row_hash_pair(keys, i, row_valid[i], nulls_invalid, &a, &b);
    h[i] = a;
    h2[i] = b;
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// key_data/key_mask hold nkeys device addresses, dtypes their
// KeyDtype codes. Writes h[n] and h2[n].
int presto_row_hash(const int64_t* key_data, const int64_t* key_mask, const int32_t* dtypes,
                    int32_t nkeys, const void* row_valid, int64_t n, int32_t nulls_invalid,
                    void* h, void* h2, void* stream) {
  KeyCols keys;
  if (!presto_fill_keys(&keys, key_data, key_mask, dtypes, nkeys))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t want = (n + THREADS - 1) / THREADS;
  int64_t cap = static_cast<int64_t>(sms) * 8;
  int blocks = static_cast<int>(want < cap ? want : cap);
  row_hash_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, static_cast<const bool*>(row_valid), n, nulls_invalid != 0,
      static_cast<int64_t*>(h), static_cast<int64_t*>(h2));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
