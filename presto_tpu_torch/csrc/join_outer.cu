// join_outer (K11): the tail of a FULL OUTER join, the build rows that
// no probe row matched, with a NULL probe side.
//
// Replaces presto_tpu/ops/join.py `unmatched_build` (:689-705, family
// join_outer). One thread per build row (grid-stride): live =
// row_valid & ~matched, where `matched` holds the running flags that
// K9's full mode set over every probe batch. Every build column keeps
// its data (it passes through) and gets mask & live; every probe column
// is written zero with a false mask. The live count is summed on the
// device (a warp reduction and one atomic add per warp) for the
// operator's deferred compaction, so the host reads nothing here.
//
// What bounds it: bytes. row_valid and matched read once, each build
// column's mask read and written once, each probe column's data and
// mask written once, the liveness written once. It is one elementwise
// pass; it stays CUDA (Triton would do as well) so that the port keeps
// one toolchain and one loader.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather.cuh"

#define THREADS 256

struct OuterArgs {
  const bool* row_valid;
  const bool* matched;
  int64_t n;
  Cols cols;  // side 1: build (src_mask -> dst_mask); side 0: probe (zeroed)
  bool* live;
};

__global__ void __launch_bounds__(THREADS)
outer_tail(const OuterArgs a, unsigned long long* __restrict__ count) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  unsigned long long mine = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < a.n;
       i += stride) {
    const bool live = a.row_valid[i] && !a.matched[i];
    a.live[i] = live;
    mine += live ? 1 : 0;
    for (int c = 0; c < a.cols.ncols; ++c) {
      if (a.cols.side[c] != 0) {
        a.cols.dst_mask[c][i] = a.cols.src_mask[c][i] && live;
      } else {
        zero_elem(a.cols.dst[c], i, a.cols.size[c]);
        a.cols.dst_mask[c][i] = false;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) mine += __shfl_down_sync(0xffffffffu, mine, o);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(count, mine);
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// row_valid[n] and matched[n] of the build (n >= 1); ncols output
// columns of n rows: side 1 = build column (src_mask read, dst_mask
// written, data passes through: src and dst data unused), side 0 = probe
// column (dst data and dst_mask written; src unused). Writes live[n];
// count[1] (int64, zeroed by the caller) receives the live rows.
int presto_join_outer(const void* row_valid, const void* matched, int64_t n, const int64_t* src,
                      const int64_t* src_mask, const int64_t* dst, const int64_t* dst_mask,
                      const int32_t* sizes, const int32_t* sides, int32_t ncols, void* live,
                      void* count, void* stream) {
  OuterArgs a;
  if (!presto_fill_cols(&a.cols, src, src_mask, dst, dst_mask, sizes, sides, ncols) || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < ncols; ++c) {
    const bool build = sides[c] != 0;
    if (a.cols.dst_mask[c] == nullptr || (build && a.cols.src_mask[c] == nullptr) ||
        (!build && a.cols.dst[c] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  a.row_valid = static_cast<const bool*>(row_valid);
  a.matched = static_cast<const bool*>(matched);
  a.n = n;
  a.live = static_cast<bool*>(live);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (n + THREADS - 1) / THREADS;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  outer_tail<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
