// join_build (K4): the radix metadata of a hash join's build side, over
// build hashes already sorted ascending (torch.sort, stable).
//
// Replaces the arithmetic of presto_tpu/ops/join.py `build_for_backend`
// around its sort (CPU branch :276-318, device branch `_build_sorted`
// :205-229). From the sorted int64 hashes `sh[n]` (dead rows carry
// INT64_MAX and sit at the end) and the radix width k it writes:
//   * part_starts[2^k + 1]: where each top-k-bit hash bucket starts,
//     clipped at the first dead row. That is the exclusive prefix sum of
//     the bucket histogram; over sorted hashes it equals, for bucket p,
//     the lower bound of the bucket's smallest hash value, which is how
//     it is computed here (one thread per bucket, as the reference's
//     device branch does with searchsorted), with no atomics and no
//     scan. k = 0 gives [0, first dead row].
//   * run_len[n]: the length of every equal-hash run at its first row,
//     0 elsewhere (the CPU branch's layout; the dead run included).
//   * stats[3]: the first dead row (= live rows), the largest bucket
//     span and the longest live run. The caller reads stats once: it is
//     the build's one host sync, as at ops/join.py:269, and picks the
//     probe layout (`unique_runs` = longest run <= 1).
// The bucket of a hash is its top k bits read as a SIGNED number plus
// 2^(k-1) (an arithmetic shift), so bucket order is signed sort order.
//
// What bounds it: the reads of sh. Each run start finds its run's end by
// a galloping search (log of the run length), each bucket its start by a
// binary search of ~log2(n) levels that stay in L2 for the top levels;
// the output is 8 bytes per row plus 8 per bucket.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

__device__ __forceinline__ int64_t lower_bound(const int64_t* __restrict__ a, int64_t lo,
                                               int64_t hi, int64_t v) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// First index after row i whose hash differs from sh[i] (or n):
// galloping, then a binary search inside the last step.
__device__ __forceinline__ int64_t run_end(const int64_t* __restrict__ sh, int64_t i,
                                           int64_t n) {
  const int64_t v = sh[i];
  int64_t lo = i + 1, bound = 1;
  while (i + bound < n && sh[i + bound] == v) {
    lo = i + bound + 1;
    bound <<= 1;
  }
  int64_t hi = i + bound < n ? i + bound : n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (sh[mid] == v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Start of bucket p, clipped at the first dead row `fi`.
__device__ __forceinline__ int64_t bucket_start(const int64_t* __restrict__ sh, int64_t n,
                                                int k, int64_t p, int64_t fi) {
  const int64_t nb = k > 0 ? (1LL << k) : 1;
  if (p == 0 && k == 0) return 0;
  if (p >= nb) return fi;
  const uint64_t half = 1ULL << (k - 1);
  const int64_t bound = static_cast<int64_t>((static_cast<uint64_t>(p) ^ half) << (64 - k));
  const int64_t lb = lower_bound(sh, 0, n, bound);
  return lb < fi ? lb : fi;
}

__device__ __forceinline__ int64_t warp_max(int64_t v) {
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t w = __shfl_down_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// One thread: the first dead row, and the two maxima zeroed.
__global__ void build_init(const int64_t* __restrict__ sh, int64_t n, int64_t* stats) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    stats[0] = lower_bound(sh, 0, n, INT64_MAX);
    stats[1] = 0;
    stats[2] = 0;
  }
}

__global__ void __launch_bounds__(THREADS)
build_meta(const int64_t* __restrict__ sh, int64_t n, int k, int64_t* __restrict__ part_starts,
           int64_t* __restrict__ run_len, int64_t* stats) {
  __shared__ int64_t warp_span[THREADS / 32], warp_run[THREADS / 32];
  const int64_t fi = stats[0];
  const int64_t nb = k > 0 ? (1LL << k) : 1;
  const int64_t total = n > nb + 1 ? n : nb + 1;
  int64_t span = 0, run = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    if (t <= nb) {
      const int64_t s = bucket_start(sh, n, k, t, fi);
      part_starts[t] = s;
      if (t < nb) {
        const int64_t e = bucket_start(sh, n, k, t + 1, fi);
        span = e - s > span ? e - s : span;
      }
    }
    if (t < n) {
      int64_t len = 0;
      if (t == 0 || sh[t] != sh[t - 1]) {
        const int64_t e = run_end(sh, t, n);
        len = e - t;
        if (t < fi) {
          const int64_t live = (e < fi ? e : fi) - t;
          run = live > run ? live : run;
        }
      }
      run_len[t] = len;
    }
  }
  span = warp_max(span);
  run = warp_max(run);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    warp_span[wid] = span;
    warp_run[wid] = run;
  }
  __syncthreads();
  if (wid == 0) {
    span = lane < THREADS / 32 ? warp_span[lane] : 0;
    run = lane < THREADS / 32 ? warp_run[lane] : 0;
    span = warp_max(span);
    run = warp_max(run);
    if (lane == 0) {
      atomicMax(reinterpret_cast<unsigned long long*>(stats + 1),
                static_cast<unsigned long long>(span));
      atomicMax(reinterpret_cast<unsigned long long*>(stats + 2),
                static_cast<unsigned long long>(run));
    }
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// sorted_hash[n] -> part_starts[2^k + 1] (k = 0: 2 entries),
// run_len[n], stats[3] = {first dead row, max bucket span, max live run}.
int presto_join_build(const void* sorted_hash, int64_t n, int32_t k, void* part_starts,
                      void* run_len, void* stats, void* stream) {
  if (k < 0 || k > 30 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* sh = static_cast<const int64_t*>(sorted_hash);
  int64_t* st = static_cast<int64_t*>(stats);
  build_init<<<1, 32, 0, s>>>(sh, n, st);
  const int64_t nb = k > 0 ? (1LL << k) : 1;
  const int64_t total = n > nb + 1 ? n : nb + 1;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t want = (total + THREADS - 1) / THREADS;
  int64_t cap = static_cast<int64_t>(sms) * 8;
  int blocks = static_cast<int>(want < cap ? want : cap);
  build_meta<<<blocks, THREADS, 0, s>>>(sh, n, k, static_cast<int64_t*>(part_starts),
                                        static_cast<int64_t*>(run_len), st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
