// probe_search.cuh: the candidate search of a probe row and the key
// compare that verifies a candidate, as device functions. K5
// (join_probe.cu) and K7 (semi_join.cu) search with the same function,
// so a join and a semi join cannot disagree on a candidate; K7 and K9
// (join_expand.cu) compare keys with the same function, over up to
// PRESTO_MAX_KEY_GROUPS groups of key columns in turn.
//
// The search is the reference's presto_tpu/ops/join.py `_search_enc`
// (:353-379) over `common.bounded_searchsorted`: the probe row's radix
// bucket p = (h >> (64 - k)) + 2^(k-1) (arithmetic shift) bounds the
// search to [part_starts[p], part_starts[p + 1]); with k = 0 the whole
// live build [0, part_starts[1]). The loop runs while lo < hi, which
// gives the exact lower bound the reference's `search_depth` levels
// give.

#pragma once

#include <stdint.h>

#include "row_hash.cuh"

// Lower bound of hash `h` in its bucket of the sorted build; *found is
// true when that slot holds h (a candidate run starts there).
__device__ __forceinline__ int64_t presto_search_candidate(int64_t h,
                                                           const int64_t* __restrict__ sorted_hash,
                                                           const int64_t* __restrict__ part_starts,
                                                           int k, bool* found) {
  int64_t lo, hi;
  if (k > 0) {
    const int64_t p = (h >> (64 - k)) + (1LL << (k - 1));
    lo = part_starts[p];
    hi = part_starts[p + 1];
  } else {
    lo = 0;
    hi = part_starts[1];
  }
  const int64_t end = hi;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (sorted_hash[mid] < h) lo = mid + 1;
    else hi = mid;
  }
  *found = lo < end && sorted_hash[lo] == h;
  return lo;
}

__device__ __forceinline__ bool presto_key_is_float(int32_t dtype) {
  return dtype == KD_F32 || dtype == KD_F64;
}

__device__ __forceinline__ double presto_key_double(const KeyCols& k, int j, int64_t i) {
  switch (k.dtype[j]) {
    case KD_F32: return static_cast<double>(static_cast<const float*>(k.data[j])[i]);
    case KD_F64: return static_cast<const double*>(k.data[j])[i];
    default: return static_cast<double>(static_cast<int64_t>(presto_key_bits(k, j, i)));
  }
}

// Probe row i and build row r have equal keys, none NULL, over one key
// group: the reference's `(pd == bd[brow]) & pm & bm[brow]` per key
// column (integers compared as int64, floats as float64, so NaN matches
// nothing).
__device__ __forceinline__ bool presto_key_group_match(const KeyCols& p, int64_t i,
                                                       const KeyCols& b, int64_t r) {
  for (int j = 0; j < p.nkeys; ++j) {
    if (!p.mask[j][i] || !b.mask[j][r]) return false;
    if (presto_key_is_float(p.dtype[j]) || presto_key_is_float(b.dtype[j])) {
      if (presto_key_double(p, j, i) != presto_key_double(b, j, r)) return false;
    } else if (presto_key_bits(p, j, i) != presto_key_bits(b, j, r)) {
      return false;
    }
  }
  return true;
}

// The same over every key group in turn: a NULL in any group matches
// nothing.
__device__ __forceinline__ bool presto_keys_match(const KeyGroups& p, int64_t i,
                                                  const KeyGroups& b, int64_t r) {
  for (int g = 0; g < p.ngroups; ++g)
    if (!presto_key_group_match(p.g[g], i, b.g[g], r)) return false;
  return true;
}

// No key of row i, in any group, is NULL.
__device__ __forceinline__ bool presto_keys_present(const KeyGroups& k, int64_t i) {
  for (int g = 0; g < k.ngroups; ++g)
    for (int j = 0; j < k.g[g].nkeys; ++j)
      if (!k.g[g].mask[j][i]) return false;
  return true;
}
