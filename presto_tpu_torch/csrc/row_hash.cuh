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
// Key groups a K5, K7, K8 or K9 launch holds in its arguments; groups
// past these (more than PRESTO_MAX_KEYS * PRESTO_MAX_KEY_GROUPS = 24
// key columns) are read from a descriptor in device memory (`ext`), so
// those kernels take any number of keys. K3, K6 and K13 take any
// number over several launches.
#define PRESTO_MAX_KEY_GROUPS 3
#define PRESTO_H_INVALID INT64_MAX
#define PRESTO_H2_INVALID INT64_MIN

enum KeyDtype { KD_I8 = 0, KD_I16 = 1, KD_I32 = 2, KD_I64 = 3, KD_F32 = 4, KD_F64 = 5 };

// Key columns of one call, passed to a kernel by value. Its layout (168
// bytes) is also the layout of the device descriptor ops/common.py
// `key_group_args` builds for the groups past PRESTO_MAX_KEY_GROUPS.
struct KeyCols {
  const void* data[PRESTO_MAX_KEYS];
  const bool* mask[PRESTO_MAX_KEYS];
  int32_t dtype[PRESTO_MAX_KEYS];
  int32_t nkeys;
};
static_assert(sizeof(KeyCols) == 168, "KeyCols is the 21-word descriptor layout");

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

// Key columns in successive groups of at most PRESTO_MAX_KEYS columns,
// in key order: the first PRESTO_MAX_KEY_GROUPS by value, the rest in
// device memory.
struct KeyGroups {
  KeyCols g[PRESTO_MAX_KEY_GROUPS];
  const KeyCols* ext;
  int32_t ngroups;
};

// Group i of `k`.
__device__ __forceinline__ const KeyCols& presto_group(const KeyGroups& k, int i) {
  return i < PRESTO_MAX_KEY_GROUPS ? k.g[i] : k.ext[i - PRESTO_MAX_KEY_GROUPS];
}

// Fill `k` from flat host arrays of nkeys entries (groups of
// PRESTO_MAX_KEYS in order). With more than PRESTO_MAX_KEYS *
// PRESTO_MAX_KEY_GROUPS keys, data[nkeys] holds the device address of
// the descriptor of the later groups (one KeyCols each); false when
// nkeys is out of range or that address is missing.
static inline bool presto_fill_key_groups(KeyGroups* k, const int64_t* data, const int64_t* mask,
                                          const int32_t* dtypes, int32_t nkeys) {
  if (nkeys < 1) return false;
  k->ngroups = (nkeys + PRESTO_MAX_KEYS - 1) / PRESTO_MAX_KEYS;
  k->ext = nullptr;
  if (k->ngroups > PRESTO_MAX_KEY_GROUPS) {
    k->ext = reinterpret_cast<const KeyCols*>(data[nkeys]);
    if (k->ext == nullptr) return false;
  }
  for (int g = 0; g < k->ngroups && g < PRESTO_MAX_KEY_GROUPS; ++g) {
    const int lo = g * PRESTO_MAX_KEYS;
    const int m = nkeys - lo < PRESTO_MAX_KEYS ? nkeys - lo : PRESTO_MAX_KEYS;
    presto_fill_keys(&k->g[g], data + lo, mask + lo, dtypes + lo, m);
  }
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

// Mix the keys of one group of row i into the running hashes (`first`:
// no key mixed yet); clears *live on a NULL key.
__device__ __forceinline__ void presto_hash_group(const KeyCols& k, int64_t i, bool* first,
                                                  uint64_t* h, uint64_t* h2, bool* all_present) {
  for (int j = 0; j < k.nkeys; ++j) {
    const bool m = k.mask[j][i];
    const uint64_t x = presto_key_bits(k, j, i);
    const uint64_t a = presto_hash64(x, m);
    const uint64_t b = presto_hash64b(x, m);
    *h = *first ? a : *h * 31ULL + a;
    *h2 = *first ? b : *h2 * 37ULL + b;
    *first = false;
    if (!m) *all_present = false;
  }
}

__device__ __forceinline__ void presto_hash_finish(uint64_t h, uint64_t h2, bool row_valid,
                                                   bool all_present, bool nulls_invalid,
                                                   int64_t* h_out, int64_t* h2_out) {
  const bool live = row_valid && (all_present || !nulls_invalid);
  *h_out = live ? static_cast<int64_t>(h) : PRESTO_H_INVALID;
  *h2_out = (live || !nulls_invalid) ? static_cast<int64_t>(h2) : PRESTO_H2_INVALID;
}

// Both hashes of row i. A dead row (row_valid false, or with
// nulls_invalid any NULL key) takes h = PRESTO_H_INVALID; with
// nulls_invalid (the join's rule) also h2 = PRESTO_H2_INVALID, without
// it (grouping, where NULL is a group) h2 keeps row_hash2.
__device__ __forceinline__ void presto_row_hash_pair(const KeyCols& k, int64_t i, bool row_valid,
                                                     bool nulls_invalid, int64_t* h_out,
                                                     int64_t* h2_out) {
  uint64_t h = 0, h2 = 0;
  bool first = true, all_present = true;
  presto_hash_group(k, i, &first, &h, &h2, &all_present);
  presto_hash_finish(h, h2, row_valid, all_present, nulls_invalid, h_out, h2_out);
}

// The same over key groups: mixing the groups in turn into one running
// hash is the reference's row_hash / row_hash2 over all the keys.
__device__ __forceinline__ void presto_row_hash_pair(const KeyGroups& k, int64_t i,
                                                     bool row_valid, bool nulls_invalid,
                                                     int64_t* h_out, int64_t* h2_out) {
  uint64_t h = 0, h2 = 0;
  bool first = true, all_present = true;
  for (int g = 0; g < k.ngroups; ++g)
    presto_hash_group(presto_group(k, g), i, &first, &h, &h2, &all_present);
  presto_hash_finish(h, h2, row_valid, all_present, nulls_invalid, h_out, h2_out);
}
