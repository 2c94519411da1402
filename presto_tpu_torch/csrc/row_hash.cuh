// row_hash.cuh: the row hashes of the port's hashing kernels, as device
// functions. K3 (row_hash.cu) and K5 (join_probe.cu) both include this
// file, so a probe row and its build row are hashed by the same code.
//
// Bit for bit the reference's presto_tpu/ops/common.py `hash64` (a
// splitmix64 avalanche), `hash64b` (murmur3 fmix64), `row_hash`
// (combined by x31) and `row_hash2` (combined by x37):
//   * every value is mixed as the 64 bits of its int64 widening, and a
//     float as the bits of its float64 widening;
//   * a NULL lane mixes a fixed value instead of its data
//     (-0x61C8864680B583EB for hash64, 0x2545F4914F6CDD1D for hash64b);
//   * all arithmetic is uint64, so every shift is logical and every
//     multiply wraps, as in the reference's uint64 mixing.

#pragma once

#include <stdint.h>

#define PRESTO_MAX_KEYS 8
#define PRESTO_H_INVALID INT64_MAX
#define PRESTO_H2_INVALID INT64_MIN

enum KeyDtype { KD_I8 = 0, KD_I16 = 1, KD_I32 = 2, KD_I64 = 3, KD_F32 = 4, KD_F64 = 5 };

// Key columns of one call, passed to a kernel by value.
struct KeyCols {
  const void* data[PRESTO_MAX_KEYS];
  const bool* mask[PRESTO_MAX_KEYS];
  int32_t dtype[PRESTO_MAX_KEYS];
  int32_t nkeys;
};

// Fill `k` from host arrays of device addresses; false when nkeys is
// out of range.
static inline bool presto_fill_keys(KeyCols* k, const int64_t* data, const int64_t* mask,
                                    const int32_t* dtypes, int32_t nkeys) {
  if (nkeys < 1 || nkeys > PRESTO_MAX_KEYS) return false;
  for (int j = 0; j < nkeys; ++j) {
    k->data[j] = reinterpret_cast<const void*>(data[j]);
    k->mask[j] = reinterpret_cast<const bool*>(mask[j]);
    k->dtype[j] = dtypes[j];
  }
  k->nkeys = nkeys;
  return true;
}

__device__ __forceinline__ uint64_t presto_key_bits(const KeyCols& k, int j, int64_t i) {
  const void* p = k.data[j];
  switch (k.dtype[j]) {
    case KD_I8:
      return static_cast<uint64_t>(static_cast<int64_t>(static_cast<const int8_t*>(p)[i]));
    case KD_I16:
      return static_cast<uint64_t>(static_cast<int64_t>(static_cast<const int16_t*>(p)[i]));
    case KD_I32:
      return static_cast<uint64_t>(static_cast<int64_t>(static_cast<const int32_t*>(p)[i]));
    case KD_F32:
      return static_cast<uint64_t>(
          __double_as_longlong(static_cast<double>(static_cast<const float*>(p)[i])));
    case KD_F64:
      return static_cast<uint64_t>(__double_as_longlong(static_cast<const double*>(p)[i]));
    default:
      return static_cast<uint64_t>(static_cast<const int64_t*>(p)[i]);
  }
}

__device__ __forceinline__ uint64_t presto_hash64(uint64_t x, bool present) {
  if (!present) x = static_cast<uint64_t>(-0x61C8864680B583EBLL);
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

__device__ __forceinline__ uint64_t presto_hash64b(uint64_t x, bool present) {
  if (!present) x = 0x2545F4914F6CDD1DULL;
  x = (x ^ (x >> 33)) * 0xFF51AFD7ED558CCDULL;
  x = (x ^ (x >> 33)) * 0xC4CEB9FE1A85EC53ULL;
  return x ^ (x >> 33);
}

// Both hashes of row i. A dead row (row_valid false, or with
// nulls_invalid any NULL key) takes h = PRESTO_H_INVALID; with
// nulls_invalid (the join's rule) also h2 = PRESTO_H2_INVALID, without
// it (grouping, where NULL is a group) h2 keeps row_hash2.
__device__ __forceinline__ void presto_row_hash_pair(const KeyCols& k, int64_t i, bool row_valid,
                                                     bool nulls_invalid, int64_t* h_out,
                                                     int64_t* h2_out) {
  uint64_t h = 0, h2 = 0;
  bool live = row_valid;
  for (int j = 0; j < k.nkeys; ++j) {
    const bool m = k.mask[j][i];
    const uint64_t x = presto_key_bits(k, j, i);
    const uint64_t a = presto_hash64(x, m);
    const uint64_t b = presto_hash64b(x, m);
    h = j == 0 ? a : h * 31ULL + a;
    h2 = j == 0 ? b : h2 * 37ULL + b;
    if (nulls_invalid && !m) live = false;
  }
  *h_out = live ? static_cast<int64_t>(h) : PRESTO_H_INVALID;
  *h2_out = (live || !nulls_invalid) ? static_cast<int64_t>(h2) : PRESTO_H2_INVALID;
}
