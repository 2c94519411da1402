// window_frame_minmax (K15): framed min and max of a window's sorted
// relation, for integer, float and dictionary-coded string arguments.
//
// Replaces presto_tpu/ops/window.py `_rmq` (:80-107) as the aggregate
// arithmetic of :430-443 calls it: a row contributes its value when it
// is live, its argument is not NULL and its FILTER is true, else the
// reduction's identity (the type's largest / smallest finite value); a
// frame with no contributing row gives NULL. NaN wins, as
// jnp.minimum / jnp.maximum let it (no fmin / fmax, which drop it).
//
// Design and memory: the reference's sparse table holds ceil(log2 n)+1
// levels of n values (1.6 GB at 8,388,608 float64 rows). This kernel
// blocks it: leaves of WIN_LEAF = 32 rows (one warp each) reduce to
// one value and one "any contribution" byte, and the sparse table is
// built over the leaves only, ceil(log2(n/32))+1 levels of n/32
// entries (19 x 262,144 x 9 B = 45 MB at 8,388,608 rows). A query
// reduces the partial leaves at the frame's two ends row by row (at
// most 62 rows) and the whole leaves between them with two
// overlapping power-of-two table entries; a frame inside one or two
// leaves reads its rows directly.
//
// What bounds it: bytes (each row's value and masks read once, the
// output written once; the table is n/32 entries per level). Launches:
// the leaves, one per table level, the queries.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "window_frame.cuh"

#define WIN_LEAF 32
#define QUERY_THREADS 256

enum VDtype { V_I32 = 0, V_I64 = 1, V_F32 = 2, V_F64 = 3 };

struct MinMaxArgs {
  WinSeg seg;
  WinOrder order;
  WinFrame frame;
  int32_t is_max;
  const void* vals;
  const bool* vmask;
  const bool* fdata;
  const bool* fmask;
  void* table;  // levels x leaves values
  uint8_t* any;  // levels x leaves "holds a contribution" bytes
  int64_t leaves;
};

template <typename T>
__device__ __forceinline__ T mm_ident(bool is_max);
template <>
__device__ __forceinline__ int32_t mm_ident<int32_t>(bool is_max) { return is_max ? INT32_MIN : INT32_MAX; }
template <>
__device__ __forceinline__ int64_t mm_ident<int64_t>(bool is_max) { return is_max ? INT64_MIN : INT64_MAX; }
template <>
__device__ __forceinline__ float mm_ident<float>(bool is_max) { return is_max ? -FLT_MAX : FLT_MAX; }
template <>
__device__ __forceinline__ double mm_ident<double>(bool is_max) { return is_max ? -DBL_MAX : DBL_MAX; }

// min / max with NaN winning (x != x only for a NaN).
template <typename T>
__device__ __forceinline__ T mm_op(T a, T b, bool is_max) {
  if (a != a) return a;
  if (b != b) return b;
  return is_max ? (b > a ? b : a) : (b < a ? b : a);
}

template <typename T>
__device__ __forceinline__ bool mm_row(const MinMaxArgs& a, int64_t j, T* v) {
  bool w = j < a.seg.n && a.seg.valid[j] && a.vmask[j];
  if (w && a.fdata != nullptr) w = a.fdata[j] && a.fmask[j];
  *v = w ? static_cast<const T*>(a.vals)[j] : mm_ident<T>(a.is_max);
  return w;
}

template <typename T>
__global__ void mm_leaves(const MinMaxArgs a) {
  const int64_t leaf = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (leaf >= a.leaves) return;  // whole warps leave together
  T v;
  bool w = mm_row<T>(a, leaf * WIN_LEAF + lane, &v);
  for (int o = 16; o > 0; o >>= 1) v = mm_op(v, __shfl_xor_sync(0xffffffffu, v, o), a.is_max);
  w = __any_sync(0xffffffffu, w);
  if (lane == 0) {
    static_cast<T*>(a.table)[leaf] = v;
    a.any[leaf] = w;
  }
}

template <typename T>
__global__ void mm_level(const MinMaxArgs a, int level) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= a.leaves) return;
  const int64_t half = int64_t{1} << (level - 1);
  const T* prev = static_cast<const T*>(a.table) + (level - 1) * a.leaves;
  const uint8_t* pany = a.any + (level - 1) * a.leaves;
  T v = prev[b];
  uint8_t w = pany[b];
  if (b + half < a.leaves) {
    v = mm_op(v, prev[b + half], a.is_max);
    w |= pany[b + half];
  } else {
    v = mm_op(v, mm_ident<T>(a.is_max), a.is_max);
  }
  static_cast<T*>(a.table)[level * a.leaves + b] = v;
  a.any[level * a.leaves + b] = w;
}

template <typename T>
__global__ void mm_query(const MinMaxArgs a, T* __restrict__ out, bool* __restrict__ mask) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.seg.n) return;
  int64_t flo, fhi;
  win_frame(a.seg, a.order, a.frame, i, &flo, &fhi);
  // the reduction starts from the frame's first row, not from the
  // identity: the reference combines only the frame's own values, so a
  // frame of one +Inf row gives +Inf, not the identity
  T acc = mm_ident<T>(a.is_max);
  bool any = false;
  if (fhi >= flo) {
    const int64_t lb = flo / WIN_LEAF, hb = fhi / WIN_LEAF;
    T v;
    any = mm_row<T>(a, flo, &acc);
    if (hb - lb <= 1) {
      for (int64_t j = flo + 1; j <= fhi; ++j) {
        any |= mm_row<T>(a, j, &v);
        acc = mm_op(acc, v, a.is_max);
      }
    } else {
      for (int64_t j = flo + 1; j < (lb + 1) * WIN_LEAF; ++j) {
        any |= mm_row<T>(a, j, &v);
        acc = mm_op(acc, v, a.is_max);
      }
      for (int64_t j = hb * WIN_LEAF; j <= fhi; ++j) {
        any |= mm_row<T>(a, j, &v);
        acc = mm_op(acc, v, a.is_max);
      }
      const int64_t L = lb + 1, R = hb - 1;
      const int k = 63 - __clzll(static_cast<unsigned long long>(R - L + 1));
      const int64_t R2 = R - (int64_t{1} << k) + 1;
      const T* tab = static_cast<const T*>(a.table) + k * a.leaves;
      const uint8_t* tany = a.any + k * a.leaves;
      acc = mm_op(acc, mm_op(tab[L], tab[R2], a.is_max), a.is_max);
      any |= tany[L] || tany[R2];
    }
  }
  out[i] = acc;
  mask[i] = any && a.seg.valid[i];
}

template <typename T>
static void mm_launch(const MinMaxArgs& a, int levels, void* out, void* mask, cudaStream_t s) {
  const int threads = 256;
  const int64_t warps_per_block = threads / 32;
  mm_leaves<T><<<static_cast<unsigned>((a.leaves + warps_per_block - 1) / warps_per_block),
                 threads, 0, s>>>(a);
  for (int l = 1; l < levels; ++l)
    mm_level<T><<<static_cast<unsigned>((a.leaves + threads - 1) / threads), threads, 0, s>>>(a, l);
  mm_query<T><<<static_cast<unsigned>((a.seg.n + QUERY_THREADS - 1) / QUERY_THREADS),
                QUERY_THREADS, 0, s>>>(a, static_cast<T*>(out), static_cast<bool*>(mask));
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// table: levels x leaves values of the argument's dtype; any: levels x
// leaves bytes; leaves = ceil(n / 32), levels = ceil(log2(max(leaves,
// 2))) + 1.
int presto_window_frame_minmax(const WinSeg* seg, const WinOrder* order, const WinFrame* frame,
                               int32_t is_max, int32_t vdtype, const void* vals,
                               const void* vmask, const void* fdata, const void* fmask,
                               void* table, void* any, int64_t leaves, int32_t levels,
                               void* out, void* mask, void* stream) {
  if (seg->n < 1 || leaves != (seg->n + WIN_LEAF - 1) / WIN_LEAF || levels < 1 ||
      (int64_t{1} << (levels - 1)) < (leaves + 1) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  MinMaxArgs a;
  a.seg = *seg;
  a.order = *order;
  a.frame = *frame;
  a.is_max = is_max;
  a.vals = vals;
  a.vmask = static_cast<const bool*>(vmask);
  a.fdata = static_cast<const bool*>(fdata);
  a.fmask = static_cast<const bool*>(fmask);
  a.table = table;
  a.any = static_cast<uint8_t*>(any);
  a.leaves = leaves;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vdtype) {
    case V_I32: mm_launch<int32_t>(a, levels, out, mask, s); break;
    case V_I64: mm_launch<int64_t>(a, levels, out, mask, s); break;
    case V_F32: mm_launch<float>(a, levels, out, mask, s); break;
    case V_F64: mm_launch<double>(a, levels, out, mask, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
