// exchange_shuffle (K18): one hash-repartition wave of the mesh, every
// producer's live rows written straight into their consumer's batch.
//
// Replaces presto_tpu/parallel/shuffle.py `_wave_body` (:216) and the
// `_bucketize` (:119) / `_shuffle_core` (:145) it runs under shard_map
// (families spmd_shuffle and, after K12 ran the absorbed chain,
// spmd_fragment). The reference sorts each producer's rows by
// destination into [W, rows] send buffers, exchanges them with a tiled
// all_to_all and packs each consumer's received rows with a second
// sort. All W logical workers of the port's mesh share one card, so
// the wave computes the result of those steps, not the steps:
//
//   count   dest = floored |h| mod W for every live row (h from K3);
//           each block of THREADS rows keeps a [W] histogram in shared
//           memory and writes it to hist[consumer][block];
//   scan    one block per consumer turns its row of hist into exclusive
//           offsets in (producer, block) order and writes the
//           consumer's live count;
//   (host)  the wrapper reads the W counts once per wave, as the
//           reference does (shuffle.py:432), and allocates each
//           consumer's batch at quantized_capacity(count);
//   scatter every live row computes its slot: its block's offset, the
//           rows of earlier warps of the block with the same
//           destination (per-warp counts in shared memory) and its rank
//           within its warp (__match_any_sync + popc), so the order is
//           stable; then it copies its data and mask for every column
//           and sets row_valid;
//   pad     the slots after each consumer's count are zeroed, as the
//           reference's dead padding is.
//
// Consumer c thus holds producer 0's rows for c in input order, then
// producer 1's, ..., then dead padding: the reference's rows in the
// reference's order. A producer with no batch in a wave has 0 rows and
// adds nothing, so no zero pad batch is needed. |INT64_MIN| is
// INT64_MIN; the remainder is floored (as jnp `%` and torch.remainder),
// never the truncated C `%`, so no destination is negative. Dead rows
// go nowhere.
//
// What bounds it: bytes. Each producer's hash and row_valid are read
// twice (count and scatter), every live row's data and mask are read
// once and written once, each consumer's padding written once. The
// scatter's writes are uncoalesced across destinations (W streams per
// warp). Pointer tables live in device memory; one scatter launch
// copies at most MAX_COLS columns, more go over several launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "partition.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)
#define MAX_W 64
#define MAX_COLS 64
#define SCAN_THREADS 1024

// tab: hash[W] | valid[W] | n[W] | block_base[W + 1] (int64 each)
struct WaveTab {
  const int64_t* t;
  int w;
  __device__ const int64_t* hash(int p) const { return reinterpret_cast<const int64_t*>(t[p]); }
  __device__ const bool* valid(int p) const { return reinterpret_cast<const bool*>(t[w + p]); }
  __device__ int64_t n(int p) const { return t[2 * w + p]; }
  __device__ int64_t base(int p) const { return t[3 * w + p]; }
};

// the producer of block b and its first row
__device__ __forceinline__ void block_home(const WaveTab& tab, int64_t b, int* p, int64_t* row0) {
  int q = 0;
  while (q + 1 < tab.w && tab.base(q + 1) <= b) ++q;
  *p = q;
  *row0 = (b - tab.base(q)) * THREADS;
}

// destination of this thread's row, -1 when it is dead or past the end
__device__ __forceinline__ int row_dest(const WaveTab& tab, int p, int64_t r) {
  if (r >= tab.n(p) || !tab.valid(p)[r]) return -1;
  return hash_dest(tab.hash(p)[r], tab.w);
}

__global__ void __launch_bounds__(THREADS)
wave_count(const int64_t* __restrict__ t, int w, int64_t blocks, int32_t* __restrict__ hist) {
  __shared__ int cnt[MAX_W];
  __shared__ int sp;
  __shared__ int64_t srow0;
  const WaveTab tab{t, w};
  for (int i = threadIdx.x; i < w; i += blockDim.x) cnt[i] = 0;
  if (threadIdx.x == 0) {
    int p;
    int64_t r0;
    block_home(tab, blockIdx.x, &p, &r0);
    sp = p;
    srow0 = r0;
  }
  __syncthreads();
  const int d = row_dest(tab, sp, srow0 + threadIdx.x);
  if (d >= 0) atomicAdd(&cnt[d], 1);
  __syncthreads();
  for (int i = threadIdx.x; i < w; i += blockDim.x)
    hist[static_cast<int64_t>(i) * blocks + blockIdx.x] = cnt[i];
}

// one block per consumer: exclusive offsets over its [blocks] row of
// hist, and its live count
__global__ void __launch_bounds__(SCAN_THREADS)
wave_scan(const int32_t* __restrict__ hist, int64_t blocks, int64_t* __restrict__ offs,
          int64_t* __restrict__ counts) {
  __shared__ int64_t warp_sums[SCAN_THREADS / 32];
  __shared__ int64_t carry;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blocks;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t lo = 0; lo < blocks; lo += blockDim.x) {
    const int64_t i = lo + threadIdx.x;
    const int64_t v = i < blocks ? hist[row + i] : 0;
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
    if (i < blocks) offs[row + i] = carry + (wid ? warp_sums[wid - 1] : 0) + x - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sums[nwarps - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = carry;
}

// cols: src[W * nc] | src_mask[W * nc] | dst[W * nc] | dst_mask[W * nc]
//       | size[nc] | dst_valid[W] | cap[W]   (int64 each, producer- or
//       consumer-major: entry q * nc + k is column k of worker q)
struct ColTab {
  const int64_t* t;
  int w, nc;
  __device__ const void* src(int p, int k) const {
    return reinterpret_cast<const void*>(t[static_cast<int64_t>(p) * nc + k]);
  }
  __device__ const bool* src_mask(int p, int k) const {
    return reinterpret_cast<const bool*>(t[static_cast<int64_t>(w + p) * nc + k]);
  }
  __device__ void* dst(int c, int k) const {
    return reinterpret_cast<void*>(t[static_cast<int64_t>(2 * w + c) * nc + k]);
  }
  __device__ bool* dst_mask(int c, int k) const {
    return reinterpret_cast<bool*>(t[static_cast<int64_t>(3 * w + c) * nc + k]);
  }
  __device__ int size(int k) const { return static_cast<int>(t[4LL * w * nc + k]); }
  __device__ bool* dst_valid(int c) const {
    return reinterpret_cast<bool*>(t[4LL * w * nc + nc + c]);
  }
  __device__ int64_t cap(int c) const { return t[4LL * w * nc + nc + w + c]; }
};

__device__ __forceinline__ void zero_elem(void* dst, int64_t j, int size) {
  switch (size) {
    case 1: static_cast<uint8_t*>(dst)[j] = 0; break;
    case 2: static_cast<uint16_t*>(dst)[j] = 0; break;
    case 4: static_cast<uint32_t*>(dst)[j] = 0; break;
    default: static_cast<uint64_t*>(dst)[j] = 0; break;
  }
}

__global__ void __launch_bounds__(THREADS)
wave_scatter(const int64_t* __restrict__ t, const int64_t* __restrict__ ct, int w, int nc,
             int64_t blocks, const int64_t* __restrict__ offs, int col_lo, int col_hi,
             int write_valid) {
  __shared__ int wcnt[WARPS][MAX_W];
  __shared__ int sp;
  __shared__ int64_t srow0;
  const WaveTab tab{t, w};
  const ColTab cols{ct, w, nc};
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < WARPS * MAX_W; i += blockDim.x) (&wcnt[0][0])[i] = 0;
  if (threadIdx.x == 0) {
    int p;
    int64_t r0;
    block_home(tab, blockIdx.x, &p, &r0);
    sp = p;
    srow0 = r0;
  }
  __syncthreads();
  const int p = sp;
  const int64_t r = srow0 + threadIdx.x;
  const int d = row_dest(tab, p, r);
  // lanes with the same destination (dead lanes share -1)
  const unsigned same = __match_any_sync(0xffffffffu, d);
  const int rank = __popc(same & ((1u << lane) - 1u));
  if (d >= 0 && rank == 0) wcnt[wid][d] = __popc(same);
  __syncthreads();
  if (d < 0) return;
  int64_t pos = offs[static_cast<int64_t>(d) * blocks + blockIdx.x] + rank;
  for (int q = 0; q < wid; ++q) pos += wcnt[q][d];
  for (int k = col_lo; k < col_hi; ++k) {
    copy_elem(cols.src(p, k), r, cols.dst(d, k), pos, cols.size(k));
    cols.dst_mask(d, k)[pos] = cols.src_mask(p, k)[r];
  }
  if (write_valid) cols.dst_valid(d)[pos] = true;
}

// zero the slots [count, cap) of every consumer (grid: x over slots, y
// over consumers)
__global__ void __launch_bounds__(THREADS)
wave_pad(const int64_t* __restrict__ ct, int w, int nc, const int64_t* __restrict__ counts,
         int col_lo, int col_hi, int write_valid) {
  const ColTab cols{ct, w, nc};
  const int c = blockIdx.y;
  const int64_t cap = cols.cap(c);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = counts[c] + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < cap; j += stride) {
    for (int k = col_lo; k < col_hi; ++k) {
      zero_elem(cols.dst(c, k), j, cols.size(k));
      cols.dst_mask(c, k)[j] = false;
    }
    if (write_valid) cols.dst_valid(c)[j] = false;
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_wave_max_workers() { return MAX_W; }
int presto_wave_max_cols() { return MAX_COLS; }
int presto_wave_block_rows() { return THREADS; }

// Count and scan. tab: the device table above, for w producers whose
// blocks (THREADS rows each) total `blocks` >= 1. Scratch hist[w *
// blocks] int32; writes offs[w * blocks] and counts[w] (int64).
int presto_wave_count(const void* tab, int32_t w, int64_t blocks, void* hist, void* offs,
                      void* counts, void* stream) {
  if (w < 1 || w > MAX_W || blocks < 1 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  wave_count<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      static_cast<const int64_t*>(tab), w, blocks, static_cast<int32_t*>(hist));
  wave_scan<<<w, SCAN_THREADS, 0, st>>>(static_cast<const int32_t*>(hist), blocks,
                                        static_cast<int64_t*>(offs),
                                        static_cast<int64_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// Scatter columns [col_lo, col_hi) (at most MAX_COLS) of every live row
// to its consumer's slot and zero the padding after each consumer's
// count; `write_valid` also writes the consumers' row_valid (the first
// column run does). cols: the device column table above; max_cap the
// largest consumer capacity.
int presto_wave_scatter(const void* tab, const void* cols, int32_t w, int32_t nc, int64_t blocks,
                        const void* offs, const void* counts, int32_t col_lo, int32_t col_hi,
                        int32_t write_valid, int64_t max_cap, void* stream) {
  if (w < 1 || w > MAX_W || blocks < 1 || blocks > 0x7fffffffLL || col_lo < 0 ||
      col_hi > nc || col_hi - col_lo > MAX_COLS || col_hi < col_lo || max_cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  wave_scatter<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      static_cast<const int64_t*>(tab), static_cast<const int64_t*>(cols), w, nc, blocks,
      static_cast<const int64_t*>(offs), col_lo, col_hi, write_valid);
  int64_t pad_blocks = (max_cap + THREADS - 1) / THREADS;
  if (pad_blocks > 1024) pad_blocks = 1024;
  wave_pad<<<dim3(static_cast<unsigned>(pad_blocks), w), THREADS, 0, st>>>(
      static_cast<const int64_t*>(cols), w, nc, static_cast<const int64_t*>(counts), col_lo,
      col_hi, write_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
