// semi_join (K7): the membership mark of a semi join (IN, EXISTS, and
// NOT IN / NOT EXISTS with `negate`), one thread per probe row, written
// straight into the probe batch's keep mask.
//
// Replaces presto_tpu/ops/join.py `semi_mark` (:708-737),
// `_semi_unique_fused` (:740), `_semi_resolve` (:747) and `_semi_scan`
// (:766-818) with its UNROLL-ed checks and `lax.while_loop`: per probe
// row
//   1. both key hashes (row_hash.cuh, as K3 hashed the build side); a
//      dead row or a NULL key is not `valid` and is never found;
//   2. the candidate run: the lower bound of h in its radix bucket
//      (`presto_search_candidate`, probe_search.cuh, the very search K5
//      runs for a join, so the two cannot disagree on a candidate);
//   3. the mark epilogue. A build whose hash runs all have length 1
//      (`unique_runs`) under verify="hash": the run start's hash2
//      decides. Otherwise the thread walks the whole run
//      [lo, lo + run_len[lo]) until a row's hash2 equals the probe's
//      (verify="hash") or its key columns equal the probe's
//      (verify="full", `presto_keys_match`). No depth bounds the walk:
//      the reference's while_loop also runs to the end of the run;
//   4. keep = found & valid, or with `negate` ~found & valid (NULL
//      probe keys are dropped either way, as in the reference).
//
// What bounds it: memory latency. Each row reads its keys (coalesced)
// and then ~log2(bucket size) + 2 dependent random reads of the build,
// plus one read per row of its run walked (hash2, or the key columns);
// one byte of keep mask is written. The byte floor counts the probe's
// keys and row_valid, the build arrays read once and the keep mask.

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_search.cuh"

#define THREADS 256

enum SemiMode { SEMI_UNIQUE_HASH = 0, SEMI_WALK_HASH = 1, SEMI_WALK_FULL = 2 };

__global__ void __launch_bounds__(THREADS)
semi_mark(const KeyGroups probe, const bool* __restrict__ row_valid, int64_t n,
          const int64_t* __restrict__ sorted_hash, const int64_t* __restrict__ hash2,
          const int64_t* __restrict__ part_starts, const int64_t* __restrict__ run_len, int k,
          int mode, const KeyGroups build, bool negate, bool* __restrict__ keep) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const bool valid = row_valid[i] && presto_keys_present(probe, i);
    bool found = false;
    if (valid) {
      int64_t h, h2;
      presto_row_hash_pair(probe, i, true, true, &h, &h2);
      bool cand;
      const int64_t lo = presto_search_candidate(h, sorted_hash, part_starts, k, &cand);
      if (cand) {
        if (mode == SEMI_UNIQUE_HASH) {
          found = hash2[lo] == h2;
        } else {
          const int64_t end = lo + run_len[lo];
          for (int64_t r = lo; r < end && !found; ++r)
            found = mode == SEMI_WALK_HASH ? hash2[r] == h2 : presto_keys_match(probe, i, build, r);
        }
      }
    }
    keep[i] = negate ? (valid && !found) : found;
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Probe keys (flat, as presto_fill_key_groups takes
// them, compared over their groups in turn) against a build's sorted_hash, hash2,
// part_starts[2^k + 1] and run_len; build keys (same count) only for
// mode SEMI_WALK_FULL. Writes keep[n].
int presto_semi_join(const int64_t* key_data, const int64_t* key_mask, const int32_t* dtypes,
                     int32_t nkeys, const void* row_valid, int64_t n, const void* sorted_hash,
                     const void* hash2, const void* part_starts, const void* run_len, int32_t k,
                     int32_t mode, const int64_t* build_data, const int64_t* build_mask,
                     const int32_t* build_dtypes, int32_t negate, void* keep, void* stream) {
  KeyGroups probe, build;
  if (!presto_fill_key_groups(&probe, key_data, key_mask, dtypes, nkeys) || k < 0 || k > 30 ||
      mode < SEMI_UNIQUE_HASH || mode > SEMI_WALK_FULL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == SEMI_WALK_FULL) {
    if (!presto_fill_key_groups(&build, build_data, build_mask, build_dtypes, nkeys))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    build.ngroups = 0;
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t want = (n + THREADS - 1) / THREADS;
  int64_t cap = static_cast<int64_t>(sms) * 16;
  int blocks = static_cast<int>(want < cap ? want : cap);
  semi_mark<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      probe, static_cast<const bool*>(row_valid), n, static_cast<const int64_t*>(sorted_hash),
      static_cast<const int64_t*>(hash2), static_cast<const int64_t*>(part_starts),
      static_cast<const int64_t*>(run_len), k, static_cast<int>(mode), build, negate != 0,
      static_cast<bool*>(keep));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
