// sort_code.cuh: the order-preserving key code of a row, as device
// functions. K24 (sort_encode.cu) writes it for K25 to sort by, and K19
// (merge_pair.cu) compares the rows of two sorted runs by it, so the
// merge orders rows exactly as the sort did: there is one copy of the
// order.
//
// A row's operands, most significant first, are ~row_valid (when given),
// then per key its null rank (mask under NULLS FIRST, else ~mask; left
// out for a key without a mask) and its canonical value: negated under
// DESC with the reference's wrap (-x in the key's width, so -INT_MIN ==
// INT_MIN; ~x for BOOLEAN), a float32 key negated as `-x` in float64
// (exact in float32, so it keeps a 32-bit code), 0 for NULL, every NaN
// one NaN coded above +inf, -0.0 as +0.0. Each operand becomes an
// unsigned code of its width (1 bit for a flag or BOOLEAN, 8 to 64 for
// integers, 32 or 64 for floats: the sign bit flipped for integers, the
// usual float transform), and the codes are packed MSB first, back to
// back, into as few 64-bit words as their widths allow: an operand may
// straddle two words. The Python planner (`ops/common.py`
// `sort_pack_plan`) gives each operand its bit position; the plain
// version in ops/common.py (`sort_encode_plain`) packs the same bits.
// Two rows compare as their words do, unsigned, word 0 first.

#pragma once

#include <stdint.h>

// dtype codes (ops/common.py SORT_DTYPES)
enum SortDtype { S_BOOL = 0, S_I8 = 1, S_I16 = 2, S_I32 = 3, S_I64 = 4, S_F32 = 5, S_F64 = 6 };

// One key of up to two sources (K24: rows [0, n0) and [n0, n); K19: runs
// A and B), with the bit positions of its operands.
struct SortKey {
  const void* data[2];
  const bool* mask[2];  // null: the key has no null-rank operand
  int32_t dtype;
  int32_t desc;
  int32_t nulls_first;
  int32_t pos_rank;   // bit position of the null rank
  int32_t pos_value;  // bit position of the value code
  int32_t width;      // bits of the value code
};

// The order-preserving code of a key's canonical value, from its raw bits
__device__ __forceinline__ uint64_t sort_code_of(uint64_t raw, int dt, bool desc, bool present) {
  switch (dt) {
    case S_BOOL: {
      uint64_t v = static_cast<uint8_t>(raw) != 0;
      if (desc) v ^= 1;
      return present ? v : 0;
    }
    case S_I8: {
      int8_t x = static_cast<int8_t>(static_cast<uint8_t>(raw));
      if (desc) x = static_cast<int8_t>(static_cast<uint8_t>(0u - static_cast<uint8_t>(x)));
      if (!present) x = 0;
      return static_cast<uint8_t>(x) ^ 0x80u;
    }
    case S_I16: {
      int16_t x = static_cast<int16_t>(static_cast<uint16_t>(raw));
      if (desc) x = static_cast<int16_t>(static_cast<uint16_t>(0u - static_cast<uint16_t>(x)));
      if (!present) x = 0;
      return static_cast<uint16_t>(x) ^ 0x8000u;
    }
    case S_I32: {
      int32_t x = static_cast<int32_t>(static_cast<uint32_t>(raw));
      if (desc) x = static_cast<int32_t>(0u - static_cast<uint32_t>(x));
      if (!present) x = 0;
      return static_cast<uint32_t>(x) ^ 0x80000000u;
    }
    case S_I64: {
      int64_t x = static_cast<int64_t>(raw);
      if (desc) x = static_cast<int64_t>(0ull - static_cast<uint64_t>(x));
      if (!present) x = 0;
      return static_cast<uint64_t>(x) ^ 0x8000000000000000ull;
    }
    case S_F32: {
      float f = __uint_as_float(static_cast<uint32_t>(raw));
      if (desc) f = -f;
      if (!present) f = 0.0f;
      uint32_t b = __float_as_uint(f);
      if ((b & 0x7fffffffu) > 0x7f800000u) return 0xffffffffull;  // every NaN
      if ((b & 0x7fffffffu) == 0) b = 0;                          // -0.0 as +0.0
      return (b & 0x80000000u) ? static_cast<uint32_t>(~b) : (b | 0x80000000u);
    }
    default: {
      double f = __longlong_as_double(static_cast<long long>(raw));
      if (desc) f = -f;
      if (!present) f = 0.0;
      uint64_t b = static_cast<uint64_t>(__double_as_longlong(f));
      if ((b & 0x7fffffffffffffffull) > 0x7ff0000000000000ull) return ~0ull;
      if ((b & 0x7fffffffffffffffull) == 0) b = 0;
      return (b & 0x8000000000000000ull) ? ~b : (b | 0x8000000000000000ull);
    }
  }
}

// The raw bits of R rows of a key: every load issued before any is
// used, the dtype's branch taken once for all of them.
template <int R>
__device__ __forceinline__ void sort_load_rows(const SortKey& key, const int* s, const int64_t* rr,
                                               uint64_t* raw) {
#define SORT_LOAD_ROWS(T)                                                   \
  {                                                                        \
    T v[R];                                                                \
    _Pragma("unroll") for (int q = 0; q < R; ++q) v[q] =                   \
        static_cast<const T*>(key.data[s[q]])[rr[q]];                      \
    _Pragma("unroll") for (int q = 0; q < R; ++q) raw[q] = v[q];           \
  }
  switch (key.dtype) {
    case S_BOOL:
    case S_I8: SORT_LOAD_ROWS(uint8_t) break;
    case S_I16: SORT_LOAD_ROWS(uint16_t) break;
    case S_I32:
    case S_F32: SORT_LOAD_ROWS(uint32_t) break;
    default: SORT_LOAD_ROWS(uint64_t) break;
  }
#undef SORT_LOAD_ROWS
}

// OR `code` (of `width` bits) in at bit `pos` (from the MSB of word 0),
// flushing finished words of row r to words[w * n + r]
struct SortPacker {
  uint64_t* words;
  int64_t n, r;
  uint64_t acc;
  int cur;
  __device__ void flush() {
    words[static_cast<int64_t>(cur) * n + r] = acc;
    acc = 0;
    ++cur;
  }
  __device__ void put(uint64_t code, int width, int pos) {
    const int w = pos >> 6, room = 64 - (pos & 63);
    while (cur < w) flush();
    if (width <= room) {
      acc |= code << (room - width);
    } else {
      acc |= code >> (width - room);
      flush();
      acc = code << (64 - (width - room));
    }
  }
};

// Every word of R rows, row q being row rr[q] of source s[q] (each a
// row that exists): ~row_valid at pos_valid when valid[0] is given
// (valid[s] is source s's row_valid), then each key's operands; the
// words past the last operand are flushed as zeros up to nwords. Each
// operand's loads for all R rows are issued before any is used, so a
// thread keeps R rows' reads in flight.
template <int R>
__device__ __forceinline__ void sort_encode_rows(const SortKey* keys, int nkeys,
                                                 const bool* const* valid, int pos_valid,
                                                 int nwords, const int* s, const int64_t* rr,
                                                 SortPacker* p) {
  if (valid[0] != nullptr) {
    bool v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = valid[s[q]][rr[q]];
#pragma unroll
    for (int q = 0; q < R; ++q) p[q].put(v[q] ? 0 : 1, 1, pos_valid);
  }
  for (int k = 0; k < nkeys; ++k) {
    const SortKey& key = keys[k];
    bool present[R];
    uint64_t raw[R];
    if (key.mask[0] != nullptr) {
#pragma unroll
      for (int q = 0; q < R; ++q) present[q] = key.mask[s[q]][rr[q]];
    } else {
#pragma unroll
      for (int q = 0; q < R; ++q) present[q] = true;
    }
    sort_load_rows<R>(key, s, rr, raw);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (key.mask[0] != nullptr)
        p[q].put(key.nulls_first ? (present[q] ? 1 : 0) : (present[q] ? 0 : 1), 1,
                 key.pos_rank);
      p[q].put(sort_code_of(raw[q], key.dtype, key.desc != 0, present[q]), key.width,
               key.pos_value);
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q)
    while (p[q].cur < nwords) p[q].flush();
}
