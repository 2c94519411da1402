// cross_product (K10): the cross product of a nested-loop (cross) join,
// every probe row against every build row.
//
// Replaces presto_tpu/operators/misc_ops.py `_cross_product` (:119-136,
// family nested_loop, :143). Both sides arrive compacted (live rows
// first, K2), and the caller passes their live-row counts np and nb,
// which it has already read for the size guard. Output slot s < out_cap
// belongs to probe row pid = s / max(nb, 1) and build row
// bid = s % max(nb, 1), and is live when s < nb * np. pid and bid are
// clipped into the sides' capacities, as the reference clips them, so a
// dead slot still reads an in-bounds row. Every probe column and every
// build column (data, and mask & live) is gathered in one launch from
// one table of column pointers (gather.cuh `Cols`, as K9 passes them):
// one thread per output slot, grid-stride, with 64-bit slot arithmetic
// (out_cap reaches 2^24 and nb * np more).
//
// What bounds it: bytes. Each output slot writes every column's data
// and mask and its liveness once. The reads are near-free: a probe row
// is read by nb neighbouring slots (a broadcast within a warp) and the
// build side is small (a scalar subquery's one row, or a dimension
// table) and stays in L1/L2. Write coalescing is the design's point:
// neighbouring threads own neighbouring slots.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather.cuh"

#define THREADS 256

struct CrossArgs {
  int64_t np_cap;  // probe capacity
  int64_t nb_cap;  // build capacity
  int64_t np;      // live probe rows (the first np of the probe)
  int64_t nb;      // live build rows (the first nb of the build)
  Cols cols;
  bool* live;
  int64_t out_cap;
};

__global__ void __launch_bounds__(THREADS)
cross_gather(const CrossArgs a) {
  const int64_t div = a.nb > 1 ? a.nb : 1;
  const int64_t live_end = a.nb * a.np;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; s < a.out_cap;
       s += stride) {
    int64_t pid = s / div;
    int64_t bid = s - pid * div;
    const bool live = s < live_end;
    if (pid > a.np_cap - 1) pid = a.np_cap - 1;
    if (bid > a.nb_cap - 1) bid = a.nb_cap - 1;
    a.live[s] = live;
    for (int c = 0; c < a.cols.ncols; ++c) {
      const int64_t r = a.cols.side[c] != 0 ? bid : pid;
      copy_elem(a.cols.src[c], r, a.cols.dst[c], s, a.cols.size[c]);
      a.cols.dst_mask[c][s] = a.cols.src_mask[c][r] && live;
    }
  }
}

static int grid_for(int64_t work, int per_sm) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (work + THREADS - 1) / THREADS;
  const int64_t cap = static_cast<int64_t>(sms) * per_sm;
  const int64_t blocks = want < cap ? want : cap;
  return static_cast<int>(blocks > 0 ? blocks : 1);
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// np live probe rows of np_cap >= 1 and nb live build rows of
// nb_cap >= 1, both compacted; ncols output columns (src data/mask with
// np_cap or nb_cap rows by side, dst data/mask with out_cap rows,
// element size, side 0 = probe, 1 = build). Writes live[out_cap] and
// every column.
int presto_cross_product(int64_t np, int64_t np_cap, int64_t nb, int64_t nb_cap,
                         const int64_t* src, const int64_t* src_mask, const int64_t* dst,
                         const int64_t* dst_mask, const int32_t* sizes, const int32_t* sides,
                         int32_t ncols, void* live, int64_t out_cap, void* stream) {
  CrossArgs a;
  if (!presto_fill_cols(&a.cols, src, src_mask, dst, dst_mask, sizes, sides, ncols) ||
      np_cap < 1 || nb_cap < 1 || out_cap < 1 || np < 0 || np > np_cap || nb < 0 ||
      nb > nb_cap)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < ncols; ++c)
    if (a.cols.dst[c] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  a.np_cap = np_cap;
  a.nb_cap = nb_cap;
  a.np = np;
  a.nb = nb;
  a.live = static_cast<bool*>(live);
  a.out_cap = out_cap;
  cross_gather<<<grid_for(out_cap, 16), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
