// array_collect (K17): the collection step of array_agg / map_agg, one
// warp per output group.
//
// Replaces presto_tpu/operators/array_agg.py `_collect_kernel` (:66)
// after its sort and group boundaries (those are `common.sort_rows` and
// K13 `window_segments` here: `pid` is the reference's `gid_m`). Per
// group g < groups and per collection spec:
//   * the contributing rows of the group, in sorted (= arrival) order:
//     every live row, ANDed with the FILTER mask and, for map_agg, with
//     the key not being NULL (:106-112);
//   * each contributor's position among the group's contributors
//     (:114-121), its value and mask written to slot [g, pos] of the
//     [out_rows, W] block when pos < W (:127-135), map_agg's value to
//     the same slot of a second block (the two share positions);
//   * the group's length; a length past W raises the overflow flag;
//   * the group's first sorted row (`first_row`, :142-147), where the
//     caller gathers the group keys.
// Groups at or past `groups` write zero rows, zero lengths and first
// row n - 1, as the reference's empty segments give them.
//
// Design: a first pass, one thread per live row, writes each group's
// first row (`starts`, where pid changes). Then one warp per output
// group (grid-stride over out_rows) reads its rows [start, end) from
// two entries of `starts` (a binary search of pid per group, the first
// version, was latency-bound: 4.5 ms at ARR_ORDERS) and walks them in
// chunks of 32: a lane's row contributes or not, `__ballot_sync` / `__popc`
// give every contributor its position, and it copies its value (by
// byte width, gather.cuh) to its slot. After the walk the lanes write
// zero and a false mask to slots [length, W). So every slot of the
// group's row of the block has exactly one writer, which makes the
// result deterministic (the reference's scatter of several rows to one
// slot, whose order XLA leaves unspecified, cannot arise), the block
// needs no separate zero fill, and a warp's writes fall on consecutive
// addresses. One launch serves every spec of the call.
//
// What bounds it: bytes. The block and its mask (out_rows * W * (value
// size + 1) bytes per spec, twice for map_agg) are written once and
// dominate; order, pid, the values, masks and FILTER columns are read
// once, the values through `order` (a gather).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather.cuh"

#define COLLECT_MAX_SPECS 16
#define THREADS 256

// The collection specs of one launch: the value column (map_agg: its
// KEY column), map_agg's value column or null, the FILTER column or
// null (all in input row order), and their outputs.
struct CollectSpecs {
  const void* val[COLLECT_MAX_SPECS];
  const bool* val_mask[COLLECT_MAX_SPECS];
  const void* mval[COLLECT_MAX_SPECS];
  const bool* mval_mask[COLLECT_MAX_SPECS];
  const bool* filt[COLLECT_MAX_SPECS];
  const bool* filt_mask[COLLECT_MAX_SPECS];
  void* block[COLLECT_MAX_SPECS];
  bool* bmask[COLLECT_MAX_SPECS];
  void* mblock[COLLECT_MAX_SPECS];
  bool* mmask[COLLECT_MAX_SPECS];
  int64_t* lens[COLLECT_MAX_SPECS];
  int8_t size[COLLECT_MAX_SPECS];
  int8_t msize[COLLECT_MAX_SPECS];
  int32_t nspecs;
};

// starts[g] = the first sorted row of group g (g < groups); pid is
// non-decreasing over the nlive live rows, so a row whose pid differs
// from its predecessor's starts a group.
__global__ void __launch_bounds__(THREADS)
group_starts(const int64_t* __restrict__ pid, int64_t nlive, int64_t groups,
             int64_t* __restrict__ starts) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= nlive) return;
  const int64_t g = pid[r];
  if ((r == 0 || pid[r - 1] != g) && g < groups) starts[g] = r;
}

__global__ void __launch_bounds__(THREADS)
array_collect(const CollectSpecs s, const int64_t* __restrict__ order,
              const int64_t* __restrict__ starts, int64_t n, int64_t nlive, int64_t groups,
              int64_t out_rows, int width, int64_t* __restrict__ first_row,
              int32_t* __restrict__ overflow) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x / 32);
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
       g < out_rows; g += warps) {
    int64_t start = 0, end = 0;  // g < out_rows; groups may exceed it
    if (g < groups) {
      start = starts[g];
      end = g + 1 < groups ? starts[g + 1] : nlive;
    }
    if (lane == 0) first_row[g] = g < groups ? start : n - 1;
    for (int sp = 0; sp < s.nspecs; ++sp) {
      const int size = s.size[sp], msize = s.msize[sp];
      const bool is_map = s.mval[sp] != nullptr;
      const int64_t row0 = g * static_cast<int64_t>(width);
      int64_t count = 0;  // the group's contributors so far, warp-uniform
      for (int64_t base = start; base < end; base += 32) {
        const int64_t r = base + lane;
        bool c = false;
        int64_t src = 0;
        if (r < end) {
          src = order[r];
          c = s.filt[sp] == nullptr || (s.filt[sp][src] && s.filt_mask[sp][src]);
          if (is_map) c = c && s.val_mask[sp][src];
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, c);
        const int64_t pos = count + __popc(ballot & below);
        if (c && pos < width) {
          copy_elem(s.val[sp], src, s.block[sp], row0 + pos, size);
          s.bmask[sp][row0 + pos] = s.val_mask[sp][src];
          if (is_map) {
            copy_elem(s.mval[sp], src, s.mblock[sp], row0 + pos, msize);
            s.mmask[sp][row0 + pos] = s.mval_mask[sp][src];
          }
        }
        count += __popc(ballot);
      }
      for (int64_t j = (count < width ? count : width) + lane; j < width; j += 32) {
        zero_elem(s.block[sp], row0 + j, size);
        s.bmask[sp][row0 + j] = false;
        if (is_map) {
          zero_elem(s.mblock[sp], row0 + j, msize);
          s.mmask[sp][row0 + j] = false;
        }
      }
      if (lane == 0) {
        s.lens[sp][g] = count;
        if (count > width) *overflow = 1;
      }
    }
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_collect_max_specs() { return COLLECT_MAX_SPECS; }

// nspecs specs as host arrays of device addresses (mval, mval_mask,
// filt, filt_mask, mblock and mmask 0 where absent) with the value and
// map-value element sizes; order[n] (sorted row -> input row) and
// pid[n] (group of each sorted row, non-decreasing over the nlive live
// rows that come first). Writes every spec's block / bmask (and mblock
// / mmask) [out_rows, width] and lens[out_rows], first_row[out_rows],
// and sets overflow[0] (int32, zeroed by the caller) when a length
// exceeds width. Scratch: starts[groups] int64s (groups >= 1).
int presto_array_collect(const int64_t* val, const int64_t* val_mask, const int64_t* mval,
                         const int64_t* mval_mask, const int64_t* filt, const int64_t* filt_mask,
                         const int64_t* block, const int64_t* bmask, const int64_t* mblock,
                         const int64_t* mmask, const int64_t* lens, const int32_t* sizes,
                         const int32_t* msizes, int32_t nspecs, const void* order, const void* pid,
                         int64_t n, int64_t nlive, int64_t groups, int64_t out_rows, int32_t width,
                         void* first_row, void* overflow, void* starts, void* stream) {
  if (nspecs < 1 || nspecs > COLLECT_MAX_SPECS || n < 1 || nlive < 0 || nlive > n ||
      groups < 0 || groups > nlive || out_rows < 1 || width < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CollectSpecs s;
  for (int j = 0; j < nspecs; ++j) {
    const bool is_map = mval[j] != 0;
    if ((sizes[j] != 1 && sizes[j] != 2 && sizes[j] != 4 && sizes[j] != 8) ||
        (is_map && msizes[j] != 1 && msizes[j] != 2 && msizes[j] != 4 && msizes[j] != 8))
      return static_cast<int>(cudaErrorInvalidValue);
    s.val[j] = reinterpret_cast<const void*>(val[j]);
    s.val_mask[j] = reinterpret_cast<const bool*>(val_mask[j]);
    s.mval[j] = reinterpret_cast<const void*>(mval[j]);
    s.mval_mask[j] = reinterpret_cast<const bool*>(mval_mask[j]);
    s.filt[j] = reinterpret_cast<const bool*>(filt[j]);
    s.filt_mask[j] = reinterpret_cast<const bool*>(filt_mask[j]);
    s.block[j] = reinterpret_cast<void*>(block[j]);
    s.bmask[j] = reinterpret_cast<bool*>(bmask[j]);
    s.mblock[j] = reinterpret_cast<void*>(mblock[j]);
    s.mmask[j] = reinterpret_cast<bool*>(mmask[j]);
    s.lens[j] = reinterpret_cast<int64_t*>(lens[j]);
    s.size[j] = static_cast<int8_t>(sizes[j]);
    s.msize[j] = static_cast<int8_t>(is_map ? msizes[j] : 1);
  }
  s.nspecs = nspecs;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t warps_per_block = THREADS / 32;
  const int64_t want = (out_rows + warps_per_block - 1) / warps_per_block;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t* gs = static_cast<int64_t*>(starts);
  if (nlive > 0)
    group_starts<<<static_cast<unsigned>((nlive + THREADS - 1) / THREADS), THREADS, 0, st>>>(
        static_cast<const int64_t*>(pid), nlive, groups, gs);
  array_collect<<<blocks, THREADS, 0, st>>>(s, static_cast<const int64_t*>(order), gs, n, nlive,
                                            groups, out_rows, width,
                                            static_cast<int64_t*>(first_row),
                                            static_cast<int32_t*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
