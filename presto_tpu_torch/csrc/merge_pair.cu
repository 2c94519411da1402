// merge_pair (K19): merge two sorted runs into one by rank arithmetic.
//
// Replaces presto_tpu/ops/merge.py `_merge_pair_jit` (:97) with
// `_lex_count_below` (:65) and `_canonical_ops` (:49) (family merge):
// row i of run A goes to i + #(rows of B strictly below it), row j of
// B to j + #(rows of A at or below it), so ties keep A first; then
// every column is written at its slot. One thread per row of A and of
// B does a lexicographic binary search of the other run.
//
// The ranks form a permutation only if this kernel orders keys exactly
// as the runs were sorted. The runs come from the port's
// `common.sort_rows` (torch.sort per operand, least significant first),
// so the compare takes the same operands (`common.key_sort_ops`):
// ~row_valid first, then per key its null rank (mask under NULLS
// FIRST, ~mask otherwise) and its canonical value. A NULL's value is 0;
// DESC negates in the key's own width (torch's wrapping `-`, so
// INT64_MIN stays INT64_MIN; a bool is inverted) and widens float32 to
// float64 (`_negate_for_desc`); every NaN compares equal to NaN and
// after every number, under ASC and DESC alike, and -0.0 equals +0.0.
// (The reference merges floats through a totalOrder bitcast, which is
// lax.sort's order, not torch.sort's.)
//
// What bounds it: operations and latency, not bytes. Each thread does
// ceil(log2(n)) + 1 dependent rounds, each reading one row of every key
// of the other run from wherever it lies. The byte bound counts every
// key and column read once and the output written once. Up to 24 keys
// (three groups of 8, as K5 takes them) travel by value; one launch
// writes at most MAX_COLS columns, more go over several launches that
// repeat the search.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_KEYS 24
#define MAX_COLS 32

// dtype codes (the wrapper's MERGE_DTYPES)
enum { MD_BOOL = 0, MD_I8, MD_I16, MD_I32, MD_I64, MD_F32, MD_F64 };

struct Run {
  const void* data[MAX_KEYS];
  const bool* mask[MAX_KEYS];
  const bool* valid;
  int64_t n;
};

struct MergeKeys {
  Run a, b;
  int8_t dtype[MAX_KEYS];
  int8_t desc[MAX_KEYS];
  int8_t nulls_first[MAX_KEYS];
  int32_t nk;
};

// One key's canonical value: a float (widened; NaN flagged, its value
// 0) or an integer.
struct Canon {
  bool fl;
  bool nan;
  double f;
  int64_t i;
};

__device__ __forceinline__ Canon canon(const void* data, int64_t r, bool valid, int dtype,
                                       bool desc) {
  Canon c{false, false, 0.0, 0};
  switch (dtype) {
    case MD_BOOL: {
      const bool v = valid && static_cast<const bool*>(data)[r];
      c.i = (desc && valid) ? !v : v;
      break;
    }
    case MD_I8: {
      int8_t v = valid ? static_cast<const int8_t*>(data)[r] : 0;
      if (desc) v = static_cast<int8_t>(0u - static_cast<uint8_t>(v));
      c.i = v;
      break;
    }
    case MD_I16: {
      int16_t v = valid ? static_cast<const int16_t*>(data)[r] : 0;
      if (desc) v = static_cast<int16_t>(0u - static_cast<uint16_t>(v));
      c.i = v;
      break;
    }
    case MD_I32: {
      int32_t v = valid ? static_cast<const int32_t*>(data)[r] : 0;
      if (desc) v = static_cast<int32_t>(0u - static_cast<uint32_t>(v));
      c.i = v;
      break;
    }
    case MD_I64: {
      int64_t v = valid ? static_cast<const int64_t*>(data)[r] : 0;
      if (desc) v = static_cast<int64_t>(0ULL - static_cast<uint64_t>(v));
      c.i = v;
      break;
    }
    default: {
      double v = 0.0;
      if (valid)
        v = dtype == MD_F32 ? static_cast<double>(static_cast<const float*>(data)[r])
                            : static_cast<const double*>(data)[r];
      c.fl = true;
      c.nan = v != v;
      c.f = c.nan ? 0.0 : (desc ? -v : v);
      break;
    }
  }
  return c;
}

// -1 / 0 / 1: row x of run X against row y of run Y
__device__ __forceinline__ int cmp_rows(const MergeKeys& k, const Run& X, int64_t x, const Run& Y,
                                        int64_t y) {
  const bool vx = X.valid[x], vy = Y.valid[y];
  if (vx != vy) return vx ? -1 : 1;  // ~valid leads: live rows first
  for (int j = 0; j < k.nk; ++j) {
    const bool mx = X.mask[j][x], my = Y.mask[j][y];
    // null rank: mask under NULLS FIRST, ~mask otherwise (false first)
    const bool rx = k.nulls_first[j] ? mx : !mx;
    const bool ry = k.nulls_first[j] ? my : !my;
    if (rx != ry) return rx ? 1 : -1;
    const Canon cx = canon(X.data[j], x, mx, k.dtype[j], k.desc[j]);
    const Canon cy = canon(Y.data[j], y, my, k.dtype[j], k.desc[j]);
    if (cx.fl) {
      if (cx.nan != cy.nan) return cx.nan ? 1 : -1;
      if (cx.f < cy.f) return -1;
      if (cx.f > cy.f) return 1;
    } else {
      if (cx.i < cy.i) return -1;
      if (cx.i > cy.i) return 1;
    }
  }
  return 0;
}

struct MergeCols {
  const void* a[MAX_COLS];
  const bool* a_mask[MAX_COLS];
  const void* b[MAX_COLS];
  const bool* b_mask[MAX_COLS];
  void* out[MAX_COLS];
  bool* out_mask[MAX_COLS];
  int8_t size[MAX_COLS];
  int32_t ncols;
};

__device__ __forceinline__ void copy_elem(const void* src, int64_t i, void* dst, int64_t j,
                                          int size) {
  switch (size) {
    case 1: static_cast<uint8_t*>(dst)[j] = static_cast<const uint8_t*>(src)[i]; break;
    case 2: static_cast<uint16_t*>(dst)[j] = static_cast<const uint16_t*>(src)[i]; break;
    case 4: static_cast<uint32_t*>(dst)[j] = static_cast<const uint32_t*>(src)[i]; break;
    default: static_cast<uint64_t*>(dst)[j] = static_cast<const uint64_t*>(src)[i]; break;
  }
}

__global__ void __launch_bounds__(THREADS)
merge_pair(const MergeKeys k, const MergeCols cols, bool* __restrict__ out_valid,
           int write_valid) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t na = k.a.n, nb = k.b.n;
  if (t >= na + nb) return;
  const bool from_a = t < na;
  const Run& self = from_a ? k.a : k.b;
  const Run& other = from_a ? k.b : k.a;
  const int64_t r = from_a ? t : t - na;
  // A: rows of B strictly below (lower bound); B: rows of A at or
  // below (upper bound)
  int64_t lo = 0, hi = other.n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const int c = cmp_rows(k, other, mid, self, r);
    if (c < 0 || (!from_a && c == 0)) lo = mid + 1;
    else hi = mid;
  }
  const int64_t pos = r + lo;
  for (int j = 0; j < cols.ncols; ++j) {
    copy_elem(from_a ? cols.a[j] : cols.b[j], r, cols.out[j], pos, cols.size[j]);
    cols.out_mask[j][pos] = (from_a ? cols.a_mask[j] : cols.b_mask[j])[r];
  }
  if (write_valid) out_valid[pos] = self.valid[r];
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_merge_max_keys() { return MAX_KEYS; }
int presto_merge_max_cols() { return MAX_COLS; }

// Runs A (na rows) and B (nb rows), each sorted by the nk keys: host
// arrays of device addresses of each run's key data and masks, the key
// dtype codes, DESC and NULLS FIRST flags, and each run's row_valid.
// ncols output columns (<= MAX_COLS): A's and B's data and mask, the
// output data and mask of na + nb rows, element sizes. Writes
// out_valid too when write_valid.
int presto_merge_pair(const int64_t* a_data, const int64_t* a_mask, const int64_t* b_data,
                      const int64_t* b_mask, const int32_t* dtypes, const int32_t* desc,
                      const int32_t* nulls_first, int32_t nk, const void* a_valid, int64_t na,
                      const void* b_valid, int64_t nb, const int64_t* ca, const int64_t* ca_mask,
                      const int64_t* cb, const int64_t* cb_mask, const int64_t* out,
                      const int64_t* out_mask, const int32_t* sizes, int32_t ncols,
                      void* out_valid, int32_t write_valid, void* stream) {
  if (nk < 0 || nk > MAX_KEYS || ncols < 0 || ncols > MAX_COLS || na < 0 || nb < 0 ||
      na + nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  MergeKeys k;
  for (int j = 0; j < nk; ++j) {
    if (dtypes[j] < MD_BOOL || dtypes[j] > MD_F64) return static_cast<int>(cudaErrorInvalidValue);
    k.a.data[j] = reinterpret_cast<const void*>(a_data[j]);
    k.a.mask[j] = reinterpret_cast<const bool*>(a_mask[j]);
    k.b.data[j] = reinterpret_cast<const void*>(b_data[j]);
    k.b.mask[j] = reinterpret_cast<const bool*>(b_mask[j]);
    k.dtype[j] = static_cast<int8_t>(dtypes[j]);
    k.desc[j] = static_cast<int8_t>(desc[j] != 0);
    k.nulls_first[j] = static_cast<int8_t>(nulls_first[j] != 0);
  }
  k.nk = nk;
  k.a.valid = static_cast<const bool*>(a_valid);
  k.a.n = na;
  k.b.valid = static_cast<const bool*>(b_valid);
  k.b.n = nb;
  MergeCols c;
  for (int j = 0; j < ncols; ++j) {
    if (sizes[j] != 1 && sizes[j] != 2 && sizes[j] != 4 && sizes[j] != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    c.a[j] = reinterpret_cast<const void*>(ca[j]);
    c.a_mask[j] = reinterpret_cast<const bool*>(ca_mask[j]);
    c.b[j] = reinterpret_cast<const void*>(cb[j]);
    c.b_mask[j] = reinterpret_cast<const bool*>(cb_mask[j]);
    c.out[j] = reinterpret_cast<void*>(out[j]);
    c.out_mask[j] = reinterpret_cast<bool*>(out_mask[j]);
    c.size[j] = static_cast<int8_t>(sizes[j]);
  }
  c.ncols = ncols;
  const int64_t blocks = (na + nb + THREADS - 1) / THREADS;
  merge_pair<<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      k, c, static_cast<bool*>(out_valid), write_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
