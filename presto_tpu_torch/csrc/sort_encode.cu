// sort_encode (K24): one pass over a batch that turns each row's sort
// operands into order-preserving unsigned key words for K25
// (radix_sort.cu), and a second that reports which 8-bit digits of
// each word vary over the rows.
//
// Replaces the operand building of presto_tpu/ops/common.py:232
// `sort_rows` (and the port's `key_sort_ops` + `_stable_order`). The
// code itself, its operands (~row_valid, each key's null rank and
// canonical value) and their packing MSB first into 64-bit words, lives
// in sort_code.cuh: K19 (merge_pair.cu) merges the sorted runs that
// K24 -> K25 -> K26 make by comparing the same code, so the sort and
// the merge cannot disagree on an order. The Python planner
// (`ops/common.py` `sort_pack_plan`) gives each operand its bit
// position; `sort_encode_plain` packs the same bits.
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

#include "sort_code.cuh"

#define THREADS 256
#define MAX_SORT_KEYS 32
#define MAX_WORDS 64

struct EncodeArgs {
  SortKey key[MAX_SORT_KEYS];
  int32_t nkeys;
  const bool* valid[2];  // null: no ~row_valid operand
  int32_t pos_valid;
  int32_t nwords;
  int64_t n0;  // rows of the first source
  int64_t n;   // rows in all
};

__global__ void __launch_bounds__(THREADS)
encode_kernel(const EncodeArgs a, uint64_t* __restrict__ words) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; r < a.n;
       r += stride) {
    const int s = r < a.n0 ? 0 : 1;
    const int64_t rr = s ? r - a.n0 : r;
    SortPacker p{words, a.n, r, 0, 0};
    sort_encode_rows<1>(a.key, a.nkeys, a.valid, a.pos_valid, a.nwords, &s, &rr, &p);
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
    SortKey& key = a.key[k];
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
