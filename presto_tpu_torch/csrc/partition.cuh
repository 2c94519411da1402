// The destination of a row and the copy of one element, shared by K18
// (exchange_shuffle.cu, the mesh's wave) and K20 (exchange_partition.cu,
// the HTTP push's split).
#pragma once

#include <stdint.h>

// consumer of a row hash among w: floored |h| mod w, the reference's
// `jnp.abs(h) % w`. |INT64_MIN| stays INT64_MIN (abs through unsigned
// negation) and the remainder is floored, never the truncated C `%`,
// so the result lies in [0, w).
__device__ __forceinline__ int hash_dest(int64_t h, int w) {
  const int64_t a = h < 0 ? static_cast<int64_t>(0ULL - static_cast<uint64_t>(h)) : h;
  int64_t r = a % w;
  if (r < 0) r += w;
  return static_cast<int>(r);
}

// dst[j] = src[i] for elements of `size` bytes (1, 2, 4 or 8)
__device__ __forceinline__ void copy_elem(const void* src, int64_t i, void* dst, int64_t j,
                                          int64_t size) {
  switch (size) {
    case 1: static_cast<uint8_t*>(dst)[j] = static_cast<const uint8_t*>(src)[i]; break;
    case 2: static_cast<uint16_t*>(dst)[j] = static_cast<const uint16_t*>(src)[i]; break;
    case 4: static_cast<uint32_t*>(dst)[j] = static_cast<const uint32_t*>(src)[i]; break;
    default: static_cast<uint64_t*>(dst)[j] = static_cast<const uint64_t*>(src)[i]; break;
  }
}
