// window_segments (K13): the partition and peer-group positions of
// every row of a window's sorted relation.
//
// Replaces presto_tpu/ops/window.py `_window_kernel_jit` :198-221 (the
// boundary compares, the cumsum / cummax scans and the segment_max
// ends). Input: rows sorted by (partition keys, order keys) with the
// live rows first (common.sort_rows sorts ~valid first). Output per
// row, int64: pid (partition index), pstart, pend (the partition's
// last live row), peer_start, peer_end and dense (the running count of
// peer-group starts). Padding rows carry the final group's ids and
// ends, as the reference's segment arithmetic gives them; with no live
// row every position is 0.
//
// What bounds it: bytes. Each row reads its keys twice (itself and its
// predecessor, the second from L1/L2) and writes 48 bytes. Design:
//   * presto_window_key_changes: one launch per group of at most
//     PRESTO_MAX_KEYS key columns ORs a "key changed against the
//     previous row" bit into a byte per row (bit 0 partition keys,
//     bit 1 order keys), NULL equal to NULL and NaN unequal to itself
//     (segment.cuh `presto_keys_differ`), so any number of keys works;
//   * three tile passes of WIN_TILE rows: per-tile counts, maxima and
//     minima of the boundary positions; one block scanning the tiles
//     (forward sums and maxima, backward minima); then each tile's
//     block scans with its carries. The ends come from a backward
//     min-scan of the next boundary: a live row's group ends just
//     before the next boundary or at the last live row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment.cuh"

#define WIN_TILE 1024
// tile aggregates in the scratch array, each ntiles long
enum { AG_PCOUNT = 0, AG_QCOUNT, AG_PMAX, AG_QMAX, AG_PMIN, AG_QMIN, AG_VALID, AG_NUM };

struct ScanMinI {
  __device__ __forceinline__ int64_t operator()(int64_t a, int64_t b) const { return b < a ? b : a; }
};

// Partition (p) and peer-group (q) boundary of row i.
__device__ __forceinline__ void win_bounds(const uint8_t* flags, const bool* valid, int64_t n,
                                           int has_part, int has_order, int64_t i, bool* p,
                                           bool* q) {
  if (i >= n) {
    *p = *q = false;
    return;
  }
  const bool v = valid[i];
  const bool base = v && (i == 0 || !valid[i - 1]);
  const uint8_t f = flags[i];
  *p = has_part ? (base || (v && (f & 1))) : (i == 0 && v);
  *q = has_order ? (base || (v && (f & 3))) : *p;
}

__global__ void __launch_bounds__(WIN_TILE)
seg_tiles(const uint8_t* flags, const bool* valid, int64_t n, int has_part, int has_order,
          int64_t ntiles, int64_t* agg) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * WIN_TILE + threadIdx.x;
  bool p, q;
  win_bounds(flags, valid, n, has_part, has_order, i, &p, &q);
  const bool v = i < n && valid[i];
  int64_t t;
  block_exclusive_scan(p, &t);
  if (threadIdx.x == 0) agg[AG_PCOUNT * ntiles + blockIdx.x] = t;
  block_exclusive_scan(q, &t);
  if (threadIdx.x == 0) agg[AG_QCOUNT * ntiles + blockIdx.x] = t;
  block_exclusive_scan(v, &t);
  if (threadIdx.x == 0) agg[AG_VALID * ntiles + blockIdx.x] = t;
  block_exclusive_scan_op(p ? i : 0, 0, ScanMax(), &t);
  if (threadIdx.x == 0) agg[AG_PMAX * ntiles + blockIdx.x] = t;
  block_exclusive_scan_op(q ? i : 0, 0, ScanMax(), &t);
  if (threadIdx.x == 0) agg[AG_QMAX * ntiles + blockIdx.x] = t;
  block_exclusive_scan_op(p ? i : INT64_MAX, INT64_MAX, ScanMinI(), &t);
  if (threadIdx.x == 0) agg[AG_PMIN * ntiles + blockIdx.x] = t;
  block_exclusive_scan_op(q ? i : INT64_MAX, INT64_MAX, ScanMinI(), &t);
  if (threadIdx.x == 0) agg[AG_QMIN * ntiles + blockIdx.x] = t;
}

// One block: exclusive forward scans (sum or max) of one aggregate
// over the tiles, in place.
template <typename OpT>
__device__ __forceinline__ void scan_tiles_forward(int64_t* a, int64_t ntiles, int64_t ident,
                                                   OpT op) {
  const int64_t per = (ntiles + blockDim.x - 1) / blockDim.x;
  const int64_t lo = static_cast<int64_t>(threadIdx.x) * per;
  const int64_t hi = lo + per < ntiles ? lo + per : ntiles;
  int64_t s = ident;
  for (int64_t t = lo; t < hi; ++t) s = op(s, a[t]);
  int64_t total;
  int64_t off = block_exclusive_scan_op(s, ident, op, &total);
  for (int64_t t = lo; t < hi; ++t) {
    const int64_t c = a[t];
    a[t] = off;
    off = op(off, c);
  }
}

// One block: exclusive backward min-scan over the tiles, in place
// (a[t] becomes the minimum over the tiles after t).
__device__ __forceinline__ void scan_tiles_backward_min(int64_t* a, int64_t ntiles) {
  const int64_t per = (ntiles + blockDim.x - 1) / blockDim.x;
  const int64_t chunk = static_cast<int64_t>(blockDim.x) - 1 - threadIdx.x;
  const int64_t lo = chunk * per;
  const int64_t hi = lo + per < ntiles ? lo + per : ntiles;
  int64_t s = INT64_MAX;
  for (int64_t t = lo; t < hi; ++t) s = a[t] < s ? a[t] : s;
  int64_t total;
  int64_t off = block_exclusive_scan_op(s, INT64_MAX, ScanMinI(), &total);
  for (int64_t t = hi - 1; t >= lo; --t) {
    const int64_t c = a[t];
    a[t] = off;
    off = c < off ? c : off;
  }
}

__global__ void __launch_bounds__(WIN_TILE)
seg_scan_tiles(int64_t* agg, int64_t ntiles) {
  int64_t total;
  {
    int64_t* a = agg + AG_VALID * ntiles;
    const int64_t per = (ntiles + blockDim.x - 1) / blockDim.x;
    const int64_t lo = static_cast<int64_t>(threadIdx.x) * per;
    const int64_t hi = lo + per < ntiles ? lo + per : ntiles;
    int64_t s = 0;
    for (int64_t t = lo; t < hi; ++t) s += a[t];
    block_exclusive_scan(s, &total);
    if (threadIdx.x == 0) agg[AG_NUM * ntiles] = total;  // live rows
  }
  scan_tiles_forward(agg + AG_PCOUNT * ntiles, ntiles, 0, ScanSum());
  scan_tiles_forward(agg + AG_QCOUNT * ntiles, ntiles, 0, ScanSum());
  scan_tiles_forward(agg + AG_PMAX * ntiles, ntiles, 0, ScanMax());
  scan_tiles_forward(agg + AG_QMAX * ntiles, ntiles, 0, ScanMax());
  scan_tiles_backward_min(agg + AG_PMIN * ntiles, ntiles);
  scan_tiles_backward_min(agg + AG_QMIN * ntiles, ntiles);
}

__global__ void __launch_bounds__(WIN_TILE)
seg_write(const uint8_t* flags, const bool* valid, int64_t n, int has_part, int has_order,
          int64_t ntiles, const int64_t* agg, int64_t* __restrict__ pid,
          int64_t* __restrict__ pstart, int64_t* __restrict__ pend,
          int64_t* __restrict__ peer_start, int64_t* __restrict__ peer_end,
          int64_t* __restrict__ dense) {
  const int64_t b = blockIdx.x;
  const int64_t i = b * WIN_TILE + threadIdx.x;
  const int64_t nv = agg[AG_NUM * ntiles];
  bool p, q;
  win_bounds(flags, valid, n, has_part, has_order, i, &p, &q);
  int64_t t;
  const int64_t pc = agg[AG_PCOUNT * ntiles + b] + block_exclusive_scan(p, &t) + p;
  const int64_t qc = agg[AG_QCOUNT * ntiles + b] + block_exclusive_scan(q, &t) + q;
  int64_t pm = block_exclusive_scan_op(p ? i : 0, 0, ScanMax(), &t);
  pm = pm > agg[AG_PMAX * ntiles + b] ? pm : agg[AG_PMAX * ntiles + b];
  pm = p && i > pm ? i : pm;
  int64_t qm = block_exclusive_scan_op(q ? i : 0, 0, ScanMax(), &t);
  qm = qm > agg[AG_QMAX * ntiles + b] ? qm : agg[AG_QMAX * ntiles + b];
  qm = q && i > qm ? i : qm;
  if (i < n) {
    pid[i] = pc - 1 > 0 ? pc - 1 : 0;
    pstart[i] = pm;
    dense[i] = qc;
    peer_start[i] = qm;
  }
  // the ends, over the tile's rows in reverse: the thread's row r2 and
  // the first boundary after it
  const int64_t r2 = b * WIN_TILE + (WIN_TILE - 1 - threadIdx.x);
  bool p2, q2;
  win_bounds(flags, valid, n, has_part, has_order, r2, &p2, &q2);
  int64_t np = block_exclusive_scan_op(p2 ? r2 : INT64_MAX, INT64_MAX, ScanMinI(), &t);
  int64_t nq = block_exclusive_scan_op(q2 ? r2 : INT64_MAX, INT64_MAX, ScanMinI(), &t);
  const int64_t cp = agg[AG_PMIN * ntiles + b], cq = agg[AG_QMIN * ntiles + b];
  np = cp < np ? cp : np;
  nq = cq < nq ? cq : nq;
  if (r2 < n) {
    const int64_t last = nv > 0 ? nv - 1 : 0;
    if (valid[r2]) {
      pend[r2] = (np < nv ? np : nv) - 1;
      peer_end[r2] = (nq < nv ? nq : nv) - 1;
    } else {
      pend[r2] = last;
      peer_end[r2] = last;
    }
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_window_tile() { return WIN_TILE; }

int presto_window_key_changes(const int64_t* data, const int64_t* mask, const int32_t* dtypes,
                              int32_t nkeys, int64_t n, int32_t bit, void* flags, void* stream) {
  return presto_launch_key_changes(data, mask, dtypes, nkeys, n, bit, flags, stream);
}

// scratch: AG_NUM * ntiles + 1 int64.
int presto_window_segments(const void* flags, const void* valid, int64_t n, int32_t has_part,
                           int32_t has_order, void* pid, void* pstart, void* pend,
                           void* peer_start, void* peer_end, void* dense, void* scratch,
                           void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t ntiles = (n + WIN_TILE - 1) / WIN_TILE;
  const uint8_t* f = static_cast<const uint8_t*>(flags);
  const bool* v = static_cast<const bool*>(valid);
  int64_t* agg = static_cast<int64_t*>(scratch);
  seg_tiles<<<static_cast<unsigned>(ntiles), WIN_TILE, 0, s>>>(f, v, n, has_part, has_order,
                                                                ntiles, agg);
  seg_scan_tiles<<<1, WIN_TILE, 0, s>>>(agg, ntiles);
  seg_write<<<static_cast<unsigned>(ntiles), WIN_TILE, 0, s>>>(
      f, v, n, has_part, has_order, ntiles, agg, static_cast<int64_t*>(pid),
      static_cast<int64_t*>(pstart), static_cast<int64_t*>(pend),
      static_cast<int64_t*>(peer_start), static_cast<int64_t*>(peer_end),
      static_cast<int64_t*>(dense));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
