// join_probe (K5): the candidate search of the hash-join probe, one
// thread per probe row.
//
// Replaces presto_tpu/ops/join.py `_probe_hashes` (:335) and
// `_search_enc` (:353-379) with `common.bounded_searchsorted`: per probe
// row
//   1. both key hashes (row_hash.cuh, the same device code that hashed
//      the build side in K3); a dead row or a NULL key gives the
//      INT64_MAX / INT64_MIN sentinels, which match nothing because the
//      build clipped its dead tail out of every bucket;
//   2. the lower bound of h inside its radix bucket
//      (`presto_search_candidate` in probe_search.cuh, the search K7's
//      semi join runs too). The reference bounds its loop by the
//      build's measured `search_depth`; here the loop runs while
//      lo < hi, which gives the same exact lower bound;
//   3. found = the slot holds h, and for a build whose hash runs all
//      have length 1 (`unique_runs`) under verify="hash" also hash2
//      matches; lo_enc = found ? slot : -1.
// Unless step 3 already checked hash2, it also writes the probe row's
// hash2, which the general expand uses to verify every candidate of a
// duplicate-key run (h2_out is null, and nothing is stored, otherwise).
//
// What bounds it: memory latency, not bytes. A probe row reads its keys
// (coalesced) and then ~log2(bucket size) + 3 dependent random reads of
// the build arrays (a bucket holds ~1 row at k ~ log2(build)); with one
// thread per row and tens of thousands of rows in flight, the gathers
// overlap. The byte floor counts the key reads, the build's arrays the
// search reads (hash2 only when step 3 checks it) and the outputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_search.cuh"

#define THREADS 256

__global__ void __launch_bounds__(THREADS)
probe_search(const KeyGroups keys, const bool* __restrict__ row_valid, int64_t n,
             const int64_t* __restrict__ sorted_hash, const int64_t* __restrict__ hash2,
             const int64_t* __restrict__ part_starts, int k, bool verify_hash2,
             int64_t* __restrict__ lo_enc, int64_t* __restrict__ h2_out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int64_t h, h2;
    presto_row_hash_pair(keys, i, row_valid[i], true, &h, &h2);
    bool found;
    const int64_t lo = presto_search_candidate(h, sorted_hash, part_starts, k, &found);
    if (found && verify_hash2) found = hash2[lo] == h2;
    lo_enc[i] = found ? lo : -1;
    if (h2_out != nullptr) h2_out[i] = h2;
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Probe keys (flat, as presto_fill_key_groups takes
// them, hashed over their groups in turn) against a build's sorted_hash[nbuild],
// hash2[nbuild] and part_starts[2^k + 1]; writes lo_enc[n] and, when
// h2_out is not null, h2[n].
int presto_join_probe(const int64_t* key_data, const int64_t* key_mask, const int32_t* dtypes,
                      int32_t nkeys, const void* row_valid, int64_t n,
                      const void* sorted_hash, const void* hash2, const void* part_starts,
                      int32_t k, int32_t verify_hash2, void* lo_enc, void* h2_out,
                      void* stream) {
  KeyGroups keys;
  if (!presto_fill_key_groups(&keys, key_data, key_mask, dtypes, nkeys) || k < 0 || k > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t want = (n + THREADS - 1) / THREADS;
  int64_t cap = static_cast<int64_t>(sms) * 16;
  int blocks = static_cast<int>(want < cap ? want : cap);
  probe_search<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, static_cast<const bool*>(row_valid), n, static_cast<const int64_t*>(sorted_hash),
      static_cast<const int64_t*>(hash2), static_cast<const int64_t*>(part_starts), k,
      verify_hash2 != 0, static_cast<int64_t*>(lo_enc), static_cast<int64_t*>(h2_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
