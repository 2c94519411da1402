// exchange_partition (K20): one producer batch split by destination
// into ONE buffer, consumer after consumer, without a sort.
//
// Replaces presto_tpu/operators/exchange_ops.py `partition_segments`
// (:79, family exchange_partition; the hash is `partition_key_hash`
// :63, K3 here). The reference stable-sorts the batch's rows by
// destination (dest = floored |h| mod W for a live row, W for a dead
// one), carrying every column as a sort payload, and searchsorts the
// segment bounds; the worker's HTTP push (server/node.py) then reads
// the sorted batch and the bounds to the host once and slices one
// segment per consumer. K20 computes the same rows in the same order
// (K18's design with one producer and W + 1 bins in one output; the two
// share partition.cuh):
//
//   count    each block of THREADS rows keeps a [W + 1] histogram in
//            shared memory and writes it to hist[dest][block];
//   scan     one block turns hist into exclusive offsets in (dest,
//            block) order and writes bounds[c] = offs[c][0] for c =
//            0..W (int32, on the device: no host read between the
//            launches);
//   scatter  every row computes its slot: its block's offset for its
//            destination, the rows of earlier warps of the block with
//            the same destination (per-warp counts in shared memory)
//            and its rank within its warp (__match_any_sync + popc), so
//            the order is stable; a live row copies every column's
//            data and mask there, and every row writes row_valid.
//
// The dead tail [bounds[W], n) gets only row_valid = false: its payload
// is never read, because the push slices [bounds[c], bounds[c+1]) for
// c < W only. W need not be a power of two (at most MAX_W). The column
// table lives in device memory and the scatter loops over it, so no
// per-launch column cap applies.
//
// What bounds it: bytes. row_valid of every slot read and written, the
// hash and every column of each live row read once and written once
// (the hash is read again by the scatter), plus the histograms. The
// scatter's writes are uncoalesced across destinations (W + 1 streams
// per warp).

#include <cuda_runtime.h>
#include <stdint.h>

#include "partition.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)
#define MAX_W 64
#define SCAN_THREADS 1024

// destination of row r: floored |h| mod w when live, w when dead, -1
// past the end
__device__ __forceinline__ int part_dest(const int64_t* __restrict__ h,
                                         const bool* __restrict__ valid, int64_t n, int64_t r,
                                         int w) {
  if (r >= n) return -1;
  return valid[r] ? hash_dest(h[r], w) : w;
}

__global__ void __launch_bounds__(THREADS)
partition_count(const int64_t* __restrict__ h, const bool* __restrict__ valid, int64_t n, int w,
                int64_t blocks, int32_t* __restrict__ hist) {
  __shared__ int cnt[MAX_W + 1];
  for (int i = threadIdx.x; i <= w; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const int d = part_dest(h, valid, n, static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x, w);
  if (d >= 0) atomicAdd(&cnt[d], 1);
  __syncthreads();
  for (int i = threadIdx.x; i <= w; i += blockDim.x)
    hist[static_cast<int64_t>(i) * blocks + blockIdx.x] = cnt[i];
}

// one block: exclusive offsets over hist[(w + 1) * blocks] in (dest,
// block) order; each thread sums a contiguous run, the runs are scanned
// across the block, then each thread writes its run's offsets
__global__ void __launch_bounds__(SCAN_THREADS)
partition_scan(const int32_t* __restrict__ hist, int w, int64_t blocks,
               int32_t* __restrict__ offs, int32_t* __restrict__ bounds) {
  __shared__ int64_t warp_sums[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t total = static_cast<int64_t>(w + 1) * blocks;
  const int64_t per = (total + blockDim.x - 1) / blockDim.x;
  const int64_t lo = threadIdx.x * per;
  const int64_t hi = lo + per < total ? lo + per : total;
  int64_t v = 0;
  for (int64_t i = lo; i < hi; ++i) v += hist[i];
  int64_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int64_t s = lane < nwarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nwarps) warp_sums[lane] = s;
  }
  __syncthreads();
  int64_t run = (wid ? warp_sums[wid - 1] : 0) + x - v;
  for (int64_t i = lo; i < hi; ++i) {
    offs[i] = static_cast<int32_t>(run);
    if (i % blocks == 0) bounds[i / blocks] = static_cast<int32_t>(run);
    run += hist[i];
  }
}

// cols: src[nc] | src_mask[nc] | dst[nc] | dst_mask[nc] | size[nc]
// (int64 each)
__global__ void __launch_bounds__(THREADS)
partition_scatter(const int64_t* __restrict__ h, const bool* __restrict__ valid, int64_t n, int w,
                  int64_t blocks, const int32_t* __restrict__ offs,
                  const int64_t* __restrict__ ct, int nc, bool* __restrict__ out_valid) {
  __shared__ int wcnt[WARPS][MAX_W + 1];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < WARPS * (MAX_W + 1); i += blockDim.x) (&wcnt[0][0])[i] = 0;
  __syncthreads();
  const int64_t r = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int d = part_dest(h, valid, n, r, w);
  // lanes with the same destination (lanes past the end share -1)
  const unsigned same = __match_any_sync(0xffffffffu, d);
  const int rank = __popc(same & ((1u << lane) - 1u));
  if (d >= 0 && rank == 0) wcnt[wid][d] = __popc(same);
  __syncthreads();
  if (d < 0) return;
  int64_t pos = offs[static_cast<int64_t>(d) * blocks + blockIdx.x] + rank;
  for (int q = 0; q < wid; ++q) pos += wcnt[q][d];
  out_valid[pos] = d < w;
  if (d == w) return;  // the dead tail: row_valid only
  for (int k = 0; k < nc; ++k) {
    copy_elem(reinterpret_cast<const void*>(ct[k]), r, reinterpret_cast<void*>(ct[2 * nc + k]),
              pos, ct[4 * nc + k]);
    reinterpret_cast<bool*>(ct[3 * nc + k])[pos] = reinterpret_cast<const bool*>(ct[nc + k])[r];
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_partition_max_consumers() { return MAX_W; }
int presto_partition_block_rows() { return THREADS; }

// The three launches of one partition: h (int64) and valid (bool) of
// n >= 1 rows, w consumers; scratch hist and offs of (w + 1) * blocks
// int32 each (blocks = ceil(n / THREADS)); writes bounds[w + 1]
// (int32), out_valid[n] and, through the column table `cols`, every
// live row's data and mask.
int presto_exchange_partition(const void* h, const void* valid, int64_t n, int32_t w,
                              int64_t blocks, void* hist, void* offs, void* bounds,
                              const void* cols, int32_t nc, void* out_valid, void* stream) {
  if (w < 1 || w > MAX_W || n < 1 || n > 0x7fffffffLL || nc < 0 ||
      blocks != (n + THREADS - 1) / THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  partition_count<<<grid, THREADS, 0, st>>>(static_cast<const int64_t*>(h),
                                            static_cast<const bool*>(valid), n, w, blocks,
                                            static_cast<int32_t*>(hist));
  partition_scan<<<1, SCAN_THREADS, 0, st>>>(static_cast<const int32_t*>(hist), w, blocks,
                                             static_cast<int32_t*>(offs),
                                             static_cast<int32_t*>(bounds));
  partition_scatter<<<grid, THREADS, 0, st>>>(
      static_cast<const int64_t*>(h), static_cast<const bool*>(valid), n, w, blocks,
      static_cast<const int32_t*>(offs), static_cast<const int64_t*>(cols), nc,
      static_cast<bool*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
