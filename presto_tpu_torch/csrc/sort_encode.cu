// sort_encode (K24): one pass over a batch that turns each row's sort
// operands into order-preserving unsigned key words for K25
// (radix_sort.cu), and a second that reports which 8-bit digits of
// each word vary over the rows.
//
// Replaces the operand building of presto_tpu/ops/common.py:232
// `sort_rows` (and the port's `key_sort_ops` + `_stable_order`): the
// operands, most significant first, are ~row_valid (when given), then
// per key its null rank (mask under NULLS FIRST, else ~mask; left out
// for a key without a mask) and its canonical value: negated under DESC
// with the reference's wrap (-x in the key's width, so -INT_MIN ==
// INT_MIN; ~x for BOOLEAN), a float32 key negated as `-x` in float64
// (exact in float32, so it keeps a 32-bit code), 0 for NULL, every NaN
// one NaN coded above +inf, -0.0 as +0.0. Each operand becomes an
// unsigned code of its width (1 bit for a flag or BOOLEAN, 8 to 64 for
// integers, 32 or 64 for floats: the sign bit flipped for integers, the
// usual float transform), and the codes are packed MSB first, back to
// back, into as few 64-bit words as their widths allow: an operand may
// straddle two words. The Python planner (`ops/common.py`
// `sort_pack_plan`) gives each operand its bit position; the plain
// version in ops/common.py packs the same bits.
//
// Two sources: rows [0, n0) come from the first pointer of every key
// and of row_valid, rows [n0, n) from the second (topn's state ++
// batch without a concatenation).
//
// The spread pass ORs every word and its complement over the rows (a
// bit varies iff both are set there); a one-block epilogue turns that
// into an 8-bit mask of varying digits per word, which the wrapper
// reads once per sort to plan K25's passes.
//
// What bounds it: bytes. Every key's data and mask and row_valid are
// read once and every word written once; the spread pass reads the
// words again. Made fast later by fusing the spread into the encode.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_SORT_KEYS 32
#define MAX_WORDS 64

// dtype codes (ops/common.py SORT_DTYPES)
enum SortDtype { S_BOOL = 0, S_I8 = 1, S_I16 = 2, S_I32 = 3, S_I64 = 4, S_F32 = 5, S_F64 = 6 };

struct EncodeKey {
  const void* data[2];
  const bool* mask[2];  // null: the key has no null-rank operand
  int32_t dtype;
  int32_t desc;
  int32_t nulls_first;
  int32_t pos_rank;   // bit position of the null rank
  int32_t pos_value;  // bit position of the value code
  int32_t width;      // bits of the value code
};

struct EncodeArgs {
  EncodeKey key[MAX_SORT_KEYS];
  int32_t nkeys;
  const bool* valid[2];  // null: no ~row_valid operand
  int32_t pos_valid;
  int32_t nwords;
  int64_t n0;  // rows of the first source
  int64_t n;   // rows in all
};

// the order-preserving code of a key's canonical value
__device__ __forceinline__ uint64_t value_code(const void* data, int64_t r, int dt, bool desc,
                                               bool present) {
  switch (dt) {
    case S_BOOL: {
      uint64_t v = static_cast<const uint8_t*>(data)[r] != 0;
      if (desc) v ^= 1;
      return present ? v : 0;
    }
    case S_I8: {
      int8_t x = static_cast<const int8_t*>(data)[r];
      if (desc) x = static_cast<int8_t>(static_cast<uint8_t>(0u - static_cast<uint8_t>(x)));
      if (!present) x = 0;
      return static_cast<uint8_t>(x) ^ 0x80u;
    }
    case S_I16: {
      int16_t x = static_cast<const int16_t*>(data)[r];
      if (desc) x = static_cast<int16_t>(static_cast<uint16_t>(0u - static_cast<uint16_t>(x)));
      if (!present) x = 0;
      return static_cast<uint16_t>(x) ^ 0x8000u;
    }
    case S_I32: {
      int32_t x = static_cast<const int32_t*>(data)[r];
      if (desc) x = static_cast<int32_t>(0u - static_cast<uint32_t>(x));
      if (!present) x = 0;
      return static_cast<uint32_t>(x) ^ 0x80000000u;
    }
    case S_I64: {
      int64_t x = static_cast<const int64_t*>(data)[r];
      if (desc) x = static_cast<int64_t>(0ull - static_cast<uint64_t>(x));
      if (!present) x = 0;
      return static_cast<uint64_t>(x) ^ 0x8000000000000000ull;
    }
    case S_F32: {
      float f = static_cast<const float*>(data)[r];
      if (desc) f = -f;
      if (!present) f = 0.0f;
      uint32_t b = __float_as_uint(f);
      if ((b & 0x7fffffffu) > 0x7f800000u) return 0xffffffffull;  // every NaN
      if ((b & 0x7fffffffu) == 0) b = 0;                          // -0.0 as +0.0
      return (b & 0x80000000u) ? static_cast<uint32_t>(~b) : (b | 0x80000000u);
    }
    default: {
      double f = static_cast<const double*>(data)[r];
      if (desc) f = -f;
      if (!present) f = 0.0;
      uint64_t b = static_cast<uint64_t>(__double_as_longlong(f));
      if ((b & 0x7fffffffffffffffull) > 0x7ff0000000000000ull) return ~0ull;
      if ((b & 0x7fffffffffffffffull) == 0) b = 0;
      return (b & 0x8000000000000000ull) ? ~b : (b | 0x8000000000000000ull);
    }
  }
}

// OR `code` (of `width` bits) in at bit `pos` (from the MSB of word 0),
// flushing finished words of row r
struct Packer {
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

__global__ void __launch_bounds__(THREADS)
encode_kernel(const EncodeArgs a, uint64_t* __restrict__ words) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; r < a.n;
       r += stride) {
    const int s = r < a.n0 ? 0 : 1;
    const int64_t rr = s ? r - a.n0 : r;
    Packer p{words, a.n, r, 0, 0};
    if (a.valid[0] != nullptr) p.put(a.valid[s][rr] ? 0 : 1, 1, a.pos_valid);
    for (int k = 0; k < a.nkeys; ++k) {
      const EncodeKey& key = a.key[k];
      bool present = true;
      if (key.mask[0] != nullptr) {
        present = key.mask[s][rr];
        p.put(key.nulls_first ? (present ? 1 : 0) : (present ? 0 : 1), 1, key.pos_rank);
      }
      p.put(value_code(key.data[s], rr, key.dtype, key.desc != 0, present), key.width,
            key.pos_value);
    }
    while (p.cur < a.nwords) p.flush();
  }
}

__device__ __forceinline__ unsigned long long warp_or(unsigned long long x) {
  for (int o = 16; o > 0; o >>= 1) x |= __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc[2w] |= OR of word w, acc[2w + 1] |= OR of ~word w (grid.y = words)
__global__ void __launch_bounds__(THREADS)
spread_kernel(const uint64_t* __restrict__ words, int64_t n,
              unsigned long long* __restrict__ acc) {
  const uint64_t* row = words + static_cast<int64_t>(blockIdx.y) * n;
  unsigned long long any1 = 0, any0 = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint64_t x = row[i];
    any1 |= x;
    any0 |= ~x;
  }
  any1 = warp_or(any1);
  any0 = warp_or(any0);
  if ((threadIdx.x & 31) == 0) {
    if (any1) atomicOr(&acc[2 * blockIdx.y], any1);
    if (any0) atomicOr(&acc[2 * blockIdx.y + 1], any0);
  }
}

// digits[w]: bit d set iff byte d (from the least significant) of word
// w varies over the rows
__global__ void digits_kernel(const unsigned long long* __restrict__ acc, int nwords,
                              int64_t* __restrict__ digits) {
  const int w = threadIdx.x;
  if (w >= nwords) return;
  const uint64_t vary = acc[2 * w] & acc[2 * w + 1];
  int64_t m = 0;
  for (int d = 0; d < 8; ++d)
    if ((vary >> (8 * d)) & 0xFF) m |= 1LL << d;
  digits[w] = m;
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_sort_max_keys() { return MAX_SORT_KEYS; }

int presto_sort_max_words() { return MAX_WORDS; }

// keys: host arrays of nkeys entries: data0, data1, mask0, mask1 (device
// addresses, mask 0 for a key without null rank), dtype, desc,
// nulls_first, pos_rank, pos_value, width; valid0/valid1 null for no
// ~row_valid operand. words: nwords * n uint64 (word-major); acc:
// 2 * nwords uint64 device scratch; digits: nwords int64.
int presto_sort_encode(const int64_t* data0, const int64_t* data1, const int64_t* mask0,
                       const int64_t* mask1, const int32_t* dtype, const int32_t* desc,
                       const int32_t* nulls_first, const int32_t* pos_rank,
                       const int32_t* pos_value, const int32_t* width, int32_t nkeys,
                       const void* valid0, const void* valid1, int32_t pos_valid,
                       int32_t nwords, int64_t n0, int64_t n, void* words, void* acc,
                       void* digits, void* stream) {
  if (nkeys < 0 || nkeys > MAX_SORT_KEYS || nwords < 1 || nwords > MAX_WORDS || n < 1 ||
      n0 < 0 || n0 > n)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeArgs a;
  for (int k = 0; k < nkeys; ++k) {
    EncodeKey& key = a.key[k];
    key.data[0] = reinterpret_cast<const void*>(data0[k]);
    key.data[1] = reinterpret_cast<const void*>(data1[k]);
    key.mask[0] = reinterpret_cast<const bool*>(mask0[k]);
    key.mask[1] = reinterpret_cast<const bool*>(mask1[k]);
    key.dtype = dtype[k];
    key.desc = desc[k];
    key.nulls_first = nulls_first[k];
    key.pos_rank = pos_rank[k];
    key.pos_value = pos_value[k];
    key.width = width[k];
    if (key.dtype < S_BOOL || key.dtype > S_F64 || key.width < 1 || key.width > 64)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  a.nkeys = nkeys;
  a.valid[0] = static_cast<const bool*>(valid0);
  a.valid[1] = static_cast<const bool*>(valid1);
  a.pos_valid = pos_valid;
  a.nwords = nwords;
  a.n0 = n0;
  a.n = n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t want = (n + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  uint64_t* w = static_cast<uint64_t*>(words);
  unsigned long long* ac = static_cast<unsigned long long*>(acc);
  encode_kernel<<<blocks, THREADS, 0, st>>>(a, w);
  cudaMemsetAsync(ac, 0, sizeof(unsigned long long) * 2 * nwords, st);
  spread_kernel<<<dim3(blocks < 264 ? blocks : 264, nwords), THREADS, 0, st>>>(w, n, ac);
  digits_kernel<<<1, MAX_WORDS, 0, st>>>(ac, nwords, static_cast<int64_t*>(digits));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
