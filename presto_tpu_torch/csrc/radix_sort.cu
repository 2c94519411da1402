// radix_sort (K25): a stable LSD radix sort of 64-bit key words that
// carries a 32-bit row index, the sort behind every sort-based family of
// the port (sort, topn, distinct, agg_step by sort, join_build,
// hashagg_merge, window, array_agg).
//
// Replaces the one variadic `lax.sort` of presto_tpu/ops/common.py:100
// `lex_perm` and :232 `sort_rows`, of ops/join.py:196 (the build's sort
// by hash) and of ops/hashagg.py:573 (the (h1, h2) sort): in the port
// the permutation comes from here and the payloads move afterwards in
// one launch (K26, gather_rows.cu).
//
// The key of row i is the concatenation words[0][i] . words[1][i] ...
// (word 0 most significant), each word unsigned after XOR with `flip`
// (the sign bit for signed int64 hash words, 0 for K24's codes). Rows
// with equal keys keep their input order. The wrapper passes the list
// of 8-bit digits to sort, least significant first; a digit that is the
// same on every row (K24 reports which) is left out, which changes
// nothing in the result.
//
// Per word, in LSD order of words:
//   gather   cur[i] = words[w][idx[i]] ^ flip (for the first word idx
//            is the identity, written here);
// then per digit of that word:
//   hist     each block of TILE rows counts its digits in shared memory
//            (one shared atomic per group of equal digits in a warp,
//            __match_any_sync) and writes them to hist[digit][block];
//   scan     one block per digit turns its row of hist into exclusive
//            offsets in block order and writes the digit's total;
//   scatter  each block scans the 256 totals into digit starts, and
//            every row goes to its digit's start + the rows of that digit
//            in earlier blocks + in earlier rounds and warps of this block
//            + its rank among equal digits of its warp (__match_any_sync
//            + popc, as K18's scatter): stable.
// finalize writes the permutation as int64 and, on request, the sorted
// word 0 (the join build's sorted hashes).
//
// What bounds it: bytes. Each digit pass reads the current key and
// index (12 bytes a row) twice (hist, scatter) and writes them once; a
// word costs one gather. The least the card could do is read every key
// word once and write the permutation once. Onesweep-style decoupled
// look-back, several digits per pass and a fused payload scatter are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define ITEMS 8
#define TILE (THREADS * ITEMS)
#define WARPS (THREADS / 32)
#define RADIX 256
#define SCAN_THREADS 1024
#define MAX_WORDS 64

__global__ void __launch_bounds__(THREADS)
gather_word(const uint64_t* __restrict__ word, const int32_t* idx_in,
            uint64_t* __restrict__ keys, int32_t* idx_out, int64_t n,
            uint64_t flip) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (idx_in == nullptr) {
      keys[i] = word[i] ^ flip;
      idx_out[i] = static_cast<int32_t>(i);
    } else {
      keys[i] = word[idx_in[i]] ^ flip;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
hist_kernel(const uint64_t* __restrict__ keys, int64_t n, int shift, int32_t* __restrict__ hist,
            int64_t nblocks) {
  __shared__ int h[RADIX];
  const int lane = threadIdx.x & 31;
  h[threadIdx.x] = 0;
  __syncthreads();
  const int64_t start = static_cast<int64_t>(blockIdx.x) * TILE;
  for (int it = 0; it < ITEMS; ++it) {
    const int64_t row = start + it * THREADS + threadIdx.x;
    const int d = row < n ? static_cast<int>((keys[row] >> shift) & 0xFF) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d >= 0 && (__ffs(peers) - 1) == lane) atomicAdd(&h[d], __popc(peers));
  }
  __syncthreads();
  hist[static_cast<int64_t>(threadIdx.x) * nblocks + blockIdx.x] = h[threadIdx.x];
}

// one block per digit: exclusive offsets over its row of hist (in
// place) and the digit's total
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(int32_t* __restrict__ hist, int64_t nblocks, int32_t* __restrict__ tot) {
  __shared__ int32_t warp_sums[SCAN_THREADS / 32];
  __shared__ int32_t carry;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int32_t* row = hist + static_cast<int64_t>(blockIdx.x) * nblocks;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t lo = 0; lo < nblocks; lo += blockDim.x) {
    const int64_t i = lo + threadIdx.x;
    const int32_t v = i < nblocks ? row[i] : 0;
    int32_t x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[wid] = x;
    __syncthreads();
    if (wid == 0) {
      int32_t s = lane < nwarps ? warp_sums[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      if (lane < nwarps) warp_sums[lane] = s;
    }
    __syncthreads();
    if (i < nblocks) row[i] = carry + (wid ? warp_sums[wid - 1] : 0) + x - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sums[nwarps - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) tot[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(THREADS)
scatter_kernel(const uint64_t* __restrict__ keys_in, const int32_t* __restrict__ idx_in,
               uint64_t* __restrict__ keys_out, int32_t* __restrict__ idx_out, int64_t n,
               int shift, const int32_t* __restrict__ hist, const int32_t* __restrict__ tot,
               int64_t nblocks) {
  __shared__ int32_t base[RADIX];
  __shared__ int32_t scan[RADIX];
  __shared__ int32_t wcnt[WARPS][RADIX];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // digit starts: exclusive scan of the 256 totals (THREADS == RADIX)
  const int32_t t = tot[threadIdx.x];
  scan[threadIdx.x] = t;
  __syncthreads();
  for (int off = 1; off < RADIX; off <<= 1) {
    const int32_t add = threadIdx.x >= off ? scan[threadIdx.x - off] : 0;
    __syncthreads();
    scan[threadIdx.x] += add;
    __syncthreads();
  }
  base[threadIdx.x] = scan[threadIdx.x] - t +
                      hist[static_cast<int64_t>(threadIdx.x) * nblocks + blockIdx.x];
  const int64_t start = static_cast<int64_t>(blockIdx.x) * TILE;
  for (int it = 0; it < ITEMS; ++it) {
    const int64_t row = start + it * THREADS + threadIdx.x;
    const bool in = row < n;
    const uint64_t k = in ? keys_in[row] : 0;
    const int d = in ? static_cast<int>((k >> shift) & 0xFF) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    for (int i = lane; i < RADIX; i += 32) wcnt[warp][i] = 0;
    __syncwarp();
    if (in && rank == 0) wcnt[warp][d] = __popc(peers);
    __syncthreads();  // base (first round) and every warp's counts
    if (in) {
      int32_t pos = base[d] + rank;
      for (int w = 0; w < warp; ++w) pos += wcnt[w][d];
      keys_out[pos] = k;
      idx_out[pos] = idx_in[row];
    }
    __syncthreads();
    int32_t s = 0;
    for (int w = 0; w < WARPS; ++w) s += wcnt[w][threadIdx.x];
    base[threadIdx.x] += s;
    __syncthreads();
  }
}

// perm[i] = idx[i] (i when no pass ran); sorted0[i] = word 0 of the
// row at position i: the sorted keys themselves when the last pass
// sorted word 0, else gathered through idx
__global__ void __launch_bounds__(THREADS)
finalize_kernel(const int32_t* __restrict__ idx, const uint64_t* __restrict__ keys,
                const uint64_t* __restrict__ word0, uint64_t flip, int64_t* __restrict__ perm,
                uint64_t* __restrict__ sorted0, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t p = idx == nullptr ? i : idx[i];
    perm[i] = p;
    if (sorted0 != nullptr) sorted0[i] = keys != nullptr ? keys[i] ^ flip : word0[p];
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_radix_tile() { return TILE; }

// words: host array of nwords device pointers (n uint64 each); passes:
// host array of 2 * npasses int32, (word, shift) least significant
// first, grouped by word; perm: n int64; sorted0: n uint64 or null;
// keys: 2n uint64, idx: 2n int32, hist: 256 * ceil(n / TILE) int32,
// tot: 256 int32 (device scratch).
int presto_radix_sort(const int64_t* words, int32_t nwords, int64_t n, uint64_t flip,
                      const int32_t* passes, int32_t npasses, void* perm, void* sorted0,
                      void* keys, void* idx, void* hist, void* tot, void* stream) {
  if (n < 1 || n > 0x7fffffffLL || nwords < 1 || nwords > MAX_WORDS || npasses < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int p = 0; p < npasses; ++p) {
    const int w = passes[2 * p], s = passes[2 * p + 1];
    if (w < 0 || w >= nwords || s < 0 || s > 56 || (s & 7))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nblocks = (n + TILE - 1) / TILE;
  const int gblocks = static_cast<int>((n + THREADS - 1) / THREADS < 132 * 16
                                           ? (n + THREADS - 1) / THREADS
                                           : 132 * 16);
  uint64_t* kb[2] = {static_cast<uint64_t*>(keys), static_cast<uint64_t*>(keys) + n};
  int32_t* ib[2] = {static_cast<int32_t*>(idx), static_cast<int32_t*>(idx) + n};
  int32_t* h = static_cast<int32_t*>(hist);
  int32_t* t = static_cast<int32_t*>(tot);
  int cur = 0, word = -1;
  bool have_idx = false;
  for (int p = 0; p < npasses; ++p) {
    const int w = passes[2 * p], s = passes[2 * p + 1];
    if (w != word) {
      gather_word<<<gblocks, THREADS, 0, st>>>(
          reinterpret_cast<const uint64_t*>(words[w]), have_idx ? ib[cur] : nullptr, kb[cur],
          ib[cur], n, flip);
      have_idx = true;
      word = w;
    }
    hist_kernel<<<static_cast<unsigned>(nblocks), THREADS, 0, st>>>(kb[cur], n, s, h, nblocks);
    scan_kernel<<<RADIX, SCAN_THREADS, 0, st>>>(h, nblocks, t);
    scatter_kernel<<<static_cast<unsigned>(nblocks), THREADS, 0, st>>>(
        kb[cur], ib[cur], kb[1 - cur], ib[1 - cur], n, s, h, t, nblocks);
    cur = 1 - cur;
  }
  finalize_kernel<<<gblocks, THREADS, 0, st>>>(
      have_idx ? ib[cur] : nullptr, word == 0 ? kb[cur] : nullptr,
      reinterpret_cast<const uint64_t*>(words[0]), flip, static_cast<int64_t*>(perm),
      static_cast<uint64_t*>(sorted0), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
