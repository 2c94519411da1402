// gather.cuh: element copies by byte width, shared by the kernels that
// move whole columns of any 1-, 2-, 4- or 8-byte type between row
// positions: K9 (join_expand.cu), K10 (cross_product.cu) and K11
// (join_outer.cu). A column's type does not matter to them, only its
// width, so one switch on the width serves every SQL type.

#pragma once

#include <stdint.h>

// Most output columns one launch takes (both join sides together).
#define PRESTO_MAX_COLS 64

__device__ __forceinline__ void copy_elem(const void* src, int64_t i, void* dst, int64_t j,
                                          int size) {
  switch (size) {
    case 1: static_cast<uint8_t*>(dst)[j] = static_cast<const uint8_t*>(src)[i]; break;
    case 2: static_cast<uint16_t*>(dst)[j] = static_cast<const uint16_t*>(src)[i]; break;
    case 4: static_cast<uint32_t*>(dst)[j] = static_cast<const uint32_t*>(src)[i]; break;
    default: static_cast<uint64_t*>(dst)[j] = static_cast<const uint64_t*>(src)[i]; break;
  }
}

__device__ __forceinline__ void zero_elem(void* dst, int64_t j, int size) {
  switch (size) {
    case 1: static_cast<uint8_t*>(dst)[j] = 0; break;
    case 2: static_cast<uint16_t*>(dst)[j] = 0; break;
    case 4: static_cast<uint32_t*>(dst)[j] = 0; break;
    default: static_cast<uint64_t*>(dst)[j] = 0; break;
  }
}

// Output columns of both sides. side[c]: 0 = probe column, 1 = build
// column. dst is null where a column's data passes through unchanged.
struct Cols {
  const void* src[PRESTO_MAX_COLS];
  const bool* src_mask[PRESTO_MAX_COLS];
  void* dst[PRESTO_MAX_COLS];
  bool* dst_mask[PRESTO_MAX_COLS];
  int8_t size[PRESTO_MAX_COLS];
  int8_t side[PRESTO_MAX_COLS];
  int32_t ncols;
};

// Fill `c` from host arrays of device addresses; false when ncols is
// out of range or an element size is not 1, 2, 4 or 8.
static inline bool presto_fill_cols(Cols* c, const int64_t* src, const int64_t* src_mask,
                                    const int64_t* dst, const int64_t* dst_mask,
                                    const int32_t* sizes, const int32_t* sides, int32_t ncols) {
  if (ncols < 0 || ncols > PRESTO_MAX_COLS) return false;
  for (int j = 0; j < ncols; ++j) {
    if (sizes[j] != 1 && sizes[j] != 2 && sizes[j] != 4 && sizes[j] != 8) return false;
    c->src[j] = reinterpret_cast<const void*>(src[j]);
    c->src_mask[j] = reinterpret_cast<const bool*>(src_mask[j]);
    c->dst[j] = reinterpret_cast<void*>(dst[j]);
    c->dst_mask[j] = reinterpret_cast<bool*>(dst_mask[j]);
    c->size[j] = static_cast<int8_t>(sizes[j]);
    c->side[j] = static_cast<int8_t>(sides[j]);
  }
  c->ncols = ncols;
  return true;
}
