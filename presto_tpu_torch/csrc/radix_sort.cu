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
// with equal keys keep their input order. Digits are 8 bits, sorted
// least significant first: words from the last to the first, bytes
// from the low one up.
//
// A one-sweep LSD sort (Onesweep, Adinets and Merrill, 2022):
//
//   radix_hist  one launch reads every key word once and counts all
//               8 digits of every word (shared-memory atomics, then
//               global atomics): a digit's histogram does not depend
//               on the order of the rows. Its last block (ticket) turns
//               each histogram into exclusive bucket starts and writes
//               the pass table: the digits that vary (a digit with one
//               bucket holding all n rows is left out: it orders
//               nothing), least significant first, each with its own
//               look-back epoch. The host reads nothing.
//   radix_pass  one launch per candidate digit (8 per word); launch p
//               runs pass p of the table and exits at once when there
//               are fewer passes. Blocks of PASS_THREADS take tiles of
//               TILE rows from an atomic counter, so a tile only ever
//               waits on tiles already running. Each block ranks its
//               tile's digits per warp (__match_any_sync + popc:
//               stable), publishes its per-digit counts, and 256 of its
//               threads (one per digit) look back over earlier tiles
//               until an inclusive prefix (decoupled look-back); it
//               then stages the tile in shared memory in digit order
//               and writes it out, so consecutive threads store
//               consecutive addresses of one digit's run. The first
//               pass reads its word directly (the row index is
//               implicit); the first pass of every later word gathers
//               that word through the index; the last pass writes the
//               int64 permutation, and the sorted word 0 on request,
//               straight into the outputs. When no digit varies, launch
//               0 writes the identity permutation.
//
// Look-back status words are 64-bit: a 30-bit epoch, a 2-bit flag
// (aggregate / inclusive prefix) and a 32-bit count (n <= 2^31 - 1).
// Every pass takes a new epoch from the pass table, so one status array
// (tiles x 256 words) serves every pass and every call on a stream with
// no clearing: a word of another epoch reads as "not published yet".
//
// What bounds it: bytes. The histogram reads 8 bytes a row per word; a
// pass reads the key and index (12 bytes) and writes them (12); the
// first reads only its word (8), the last writes the permutation and
// the sorted word (16). At a one-word join build that is ~200 bytes a
// row; the least the card could do is read every word once and write
// the permutation once. On the H100 a pass at Q21's 16,777,216-row
// build takes about 1.5x the time its bytes need (chip_smoke.py's
// device time per launch). The block shape is the fastest of those
// tried (512 x 8 rows, two blocks an SM at 64 registers, against
// 256 x 16 at three blocks and 256 x 8 at four); a wider look-back
// window, a backoff and early counts changed nothing measurable. What
// remains is a tile's phases (load, rank, look-back, write) running one
// after another: prefetching the next tile would overlap them.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256  // radix_hist's block: one thread per bucket
#define PASS_THREADS 512
#define ITEMS 8
#define TILE (PASS_THREADS * ITEMS)
#define PASS_WARPS (PASS_THREADS / 32)
#define RADIX 256
#define DIGITS 8
#define MAX_WORDS 64
#define MAX_PASSES (MAX_WORDS * DIGITS)
#define HIST_BLOCKS_PER_SM 8
#define HIST_ITEMS 4
#define PASS_BLOCKS_PER_SM 2

#define FLAG_AGGREGATE 1ULL
#define FLAG_INCLUSIVE 2ULL
#define EPOCH_MASK 0x3fffffffu

typedef unsigned long long u64;

// the device pass table (the head of the scratch; zeroed once)
struct Plan {
  uint32_t npasses;
  uint32_t epoch;   // the last epoch handed out
  uint32_t ticket;  // radix_hist's last-block ticket (left at 0)
  uint32_t pad;
  uint32_t word[MAX_PASSES];
  uint32_t shift[MAX_PASSES];
  uint32_t pass_epoch[MAX_PASSES];
  uint32_t tiles[MAX_PASSES];  // each pass's tile counter
};

// scratch: Plan | hist [MAX_WORDS][DIGITS][RADIX] u32 (0 between
// calls) | starts [MAX_PASSES][RADIX] u32
#define HIST_OFFSET ((sizeof(Plan) + 255) / 256 * 256)
#define STARTS_OFFSET (HIST_OFFSET + sizeof(uint32_t) * MAX_WORDS * DIGITS * RADIX)
#define SCRATCH_BYTES (STARTS_OFFSET + sizeof(uint32_t) * MAX_PASSES * RADIX)

struct Words {
  const u64* p[MAX_WORDS];
};

__device__ __forceinline__ u64 status_word(uint32_t epoch, u64 flag, uint32_t count) {
  return (static_cast<u64>(epoch) << 34) | (flag << 32) | count;
}

// exclusive scan of one value per thread over an NT-thread block
// (returns the thread's exclusive prefix; `tot` gets the block total)
template <int NT>
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* wsum, uint32_t& tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  uint32_t before = 0;
  tot = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    const uint32_t s = wsum[w];
    before += w < warp ? s : 0;
    tot += s;
  }
  __syncthreads();  // wsum is reused by the next scan
  return before + x - v;
}

__global__ void __launch_bounds__(THREADS)
radix_hist(Words words, int nwords, int64_t n, u64 flip, uint32_t* __restrict__ hist,
           uint32_t* __restrict__ starts, Plan* plan) {
  __shared__ uint32_t h[DIGITS * RADIX];
  __shared__ uint32_t wsum[THREADS / 32];
  __shared__ uint32_t np, ep;
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int w = 0; w < nwords; ++w) {
    for (int i = threadIdx.x; i < DIGITS * RADIX; i += THREADS) h[i] = 0;
    __syncthreads();
    const u64* src = words.p[w];
    // HIST_ITEMS loads in flight per thread
    for (int64_t base = static_cast<int64_t>(blockIdx.x) * THREADS * HIST_ITEMS +
                        (threadIdx.x >> 5) * 32 * HIST_ITEMS + lane;
         base < n; base += stride * HIST_ITEMS) {
      u64 x[HIST_ITEMS];
#pragma unroll
      for (int k = 0; k < HIST_ITEMS; ++k) {
        const int64_t row = base + k * 32;
        x[k] = row < n ? src[row] ^ flip : 0;
      }
#pragma unroll
      for (int k = 0; k < HIST_ITEMS; ++k)
        if (base + k * 32 < n)
#pragma unroll
          for (int d = 0; d < DIGITS; ++d)
            atomicAdd(&h[d * RADIX + ((x[k] >> (8 * d)) & 0xFF)], 1u);
    }
    __syncthreads();
    uint32_t* g = hist + static_cast<int64_t>(w) * DIGITS * RADIX;
    for (int i = threadIdx.x; i < DIGITS * RADIX; i += THREADS)
      if (h[i]) atomicAdd(&g[i], h[i]);
    __syncthreads();
  }
  __threadfence();
  if (threadIdx.x == 0) last = atomicAdd(&plan->ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the pass table: varying digits, least significant first
  const int b = threadIdx.x;  // THREADS == RADIX: one bucket per thread
  if (b == 0) {
    np = 0;
    ep = plan->epoch;
  }
  __syncthreads();
  for (int w = nwords - 1; w >= 0; --w) {
    for (int d = 0; d < DIGITS; ++d) {
      uint32_t* hc = hist + (static_cast<int64_t>(w) * DIGITS + d) * RADIX;
      const uint32_t c = __ldcg(hc + b);
      hc[b] = 0;  // zero for the next call
      if (__syncthreads_or(static_cast<int64_t>(c) == n)) continue;
      uint32_t tot;
      const uint32_t excl = block_scan<THREADS>(c, wsum, tot);
      const uint32_t p = np;
      starts[p * RADIX + b] = excl;
      __syncthreads();  // every thread has read np
      if (b == 0) {
        uint32_t e = (ep + 1) & EPOCH_MASK;
        if (e == 0) e = 1;
        ep = e;
        plan->word[p] = w;
        plan->shift[p] = 8 * d;
        plan->pass_epoch[p] = e;
        plan->tiles[p] = 0;
        np = p + 1;
      }
      __syncthreads();
    }
  }
  if (b == 0) {
    plan->npasses = np;
    plan->epoch = ep;
    plan->ticket = 0;
  }
}

__global__ void __launch_bounds__(PASS_THREADS, PASS_BLOCKS_PER_SM)
radix_pass(int p, Words words, int64_t n, u64 flip, Plan* plan,
           const uint32_t* __restrict__ starts, u64* status, u64* __restrict__ kb0,
           u64* __restrict__ kb1, int32_t* __restrict__ ib0, int32_t* __restrict__ ib1,
           int64_t* __restrict__ perm, int64_t* __restrict__ sorted0) {
  __shared__ u64 stage[TILE];  // the tile in digit order: keys, then indices
  __shared__ uint16_t whist[PASS_WARPS][RADIX];  // < TILE
  __shared__ uint32_t lstart[RADIX];
  __shared__ int64_t gbase[RADIX];
  __shared__ uint32_t wsum[PASS_WARPS];
  __shared__ uint32_t tile_id;
  const int np = static_cast<int>(plan->npasses);
  if (np == 0) {  // no digit varies: the identity permutation
    if (p != 0) return;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x;
         i < n && i < static_cast<int64_t>(blockIdx.x + 1) * TILE; i += PASS_THREADS) {
      perm[i] = i;
      if (sorted0 != nullptr) sorted0[i] = static_cast<int64_t>(words.p[0][i]);
    }
    return;
  }
  if (p >= np) return;
  const int w = static_cast<int>(plan->word[p]);
  const int shift = static_cast<int>(plan->shift[p]);
  const uint32_t ep = plan->pass_epoch[p];
  const bool first = p == 0;
  const bool word_first = first || static_cast<int>(plan->word[p - 1]) != w;
  const bool last = p == np - 1;
  // the next pass starts a new word and reads only the indices
  const bool next_gathers = !last && static_cast<int>(plan->word[p + 1]) != w;
  // pass q writes buffer q & 1
  const u64* kin = (p & 1) ? kb0 : kb1;
  const int32_t* iin = (p & 1) ? ib0 : ib1;
  u64* kout = (p & 1) ? kb1 : kb0;
  int32_t* iout = (p & 1) ? ib1 : ib0;
  const u64* word = words.p[w];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_id = atomicAdd(&plan->tiles[p], 1u);
  for (int i = threadIdx.x; i < PASS_WARPS * RADIX; i += PASS_THREADS) (&whist[0][0])[i] = 0;
  __syncthreads();
  const int64_t t = tile_id;
  const int64_t tbase = t * TILE;
  const int tn = static_cast<int>(n - tbase < TILE ? n - tbase : TILE);

  // rows of warp k: [k * 32 * ITEMS, (k + 1) * 32 * ITEMS) of the tile,
  // item j of a lane at j * 32 + lane (coalesced loads, row order kept)
  const int r0 = warp * 32 * ITEMS + lane;
  u64 key[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t row = tbase + r0 + j * 32;
    key[j] = 0;
    if (r0 + j * 32 < tn) {
      if (first)
        key[j] = word[row] ^ flip;
      else if (word_first)
        key[j] = word[iin[row]] ^ flip;
      else
        key[j] = kin[row];
    }
  }
  // rank among equal digits of the warp, in row order; positions (< TILE)
  // two to a register
  const unsigned lt = (1u << lane) - 1u;
  uint32_t pos[ITEMS / 2];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const bool in = r0 + j * 32 < tn;
    const uint32_t d = in ? static_cast<uint32_t>(key[j] >> shift) & 0xFF : RADIX;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const uint32_t rank = (in ? whist[warp][d] : 0) + __popc(peers & lt);
    if (j & 1)
      pos[j >> 1] |= rank << 16;
    else
      pos[j >> 1] = rank;
    __syncwarp();
    if (in && lane == __ffs(peers) - 1)
      whist[warp][d] = static_cast<uint16_t>(whist[warp][d] + __popc(peers));
    __syncwarp();
  }
  __syncthreads();
  // per digit (thread b < RADIX): the warps' exclusive offsets, the
  // tile's count
  const int b = threadIdx.x;
  const bool digit_thread = b < RADIX;
  uint32_t cnt = 0;
  u64* mine = status + t * RADIX + b;
  if (digit_thread) {
#pragma unroll
    for (int k = 0; k < PASS_WARPS; ++k) {
      const uint32_t c = whist[k][b];
      whist[k][b] = static_cast<uint16_t>(cnt);
      cnt += c;
    }
    *reinterpret_cast<volatile u64*>(mine) =
        status_word(ep, t == 0 ? FLAG_INCLUSIVE : FLAG_AGGREGATE, cnt);
  }
  uint32_t tot;
  const uint32_t lst = block_scan<PASS_THREADS>(cnt, wsum, tot);
  if (digit_thread) lstart[b] = lst;
  __syncthreads();
  // stage the keys in digit order
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (r0 + j * 32 < tn) {
      const uint32_t d = static_cast<uint32_t>(key[j] >> shift) & 0xFF;
      const uint32_t at = ((pos[j >> 1] >> (16 * (j & 1))) & 0xFFFF) + lstart[d] + whist[warp][d];
      pos[j >> 1] = (j & 1) ? (pos[j >> 1] & 0xFFFF) | (at << 16)
                            : (pos[j >> 1] & 0xFFFF0000u) | at;
      stage[at] = key[j];
    }
  }
  // the indices, loaded while the look-back waits
  int32_t idx[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t row = tbase + r0 + j * 32;
    idx[j] = r0 + j * 32 < tn ? (first ? static_cast<int32_t>(row) : iin[row]) : 0;
  }
  // decoupled look-back: rows of digit b in earlier tiles
  uint32_t excl = 0;
  if (digit_thread && t > 0) {
    const volatile u64* s = status + (t - 1) * RADIX + b;
    for (;;) {
      const u64 v = *s;
      if (static_cast<uint32_t>(v >> 34) != ep || ((v >> 32) & 3ULL) == 0) continue;
      excl += static_cast<uint32_t>(v);
      if (((v >> 32) & 3ULL) == FLAG_INCLUSIVE) break;
      s -= RADIX;
    }
    *reinterpret_cast<volatile u64*>(mine) = status_word(ep, FLAG_INCLUSIVE, excl + cnt);
  }
  if (digit_thread) gbase[b] = static_cast<int64_t>(starts[p * RADIX + b]) + excl - lst;
  __syncthreads();
  // write the keys out in digit runs; keep each slot's digit for the
  // indices
  uint32_t dg[ITEMS / 4] = {};
  const bool keys_out = last ? sorted0 != nullptr && w == 0 : !next_gathers;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = j * PASS_THREADS + threadIdx.x;
    if (i < tn) {
      const u64 k = stage[i];
      const uint32_t d = static_cast<uint32_t>(k >> shift) & 0xFF;
      dg[j >> 2] |= d << (8 * (j & 3));
      if (keys_out) {
        const int64_t o = gbase[d] + i;
        if (last)
          sorted0[o] = static_cast<int64_t>(k ^ flip);
        else
          kout[o] = k;
      }
    }
  }
  __syncthreads();
  int32_t* sidx = reinterpret_cast<int32_t*>(stage);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (r0 + j * 32 < tn) sidx[(pos[j >> 1] >> (16 * (j & 1))) & 0xFFFF] = idx[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = j * PASS_THREADS + threadIdx.x;
    if (i < tn) {
      const uint32_t d = (dg[j >> 2] >> (8 * (j & 3))) & 0xFF;
      const int64_t o = gbase[d] + i;
      const int32_t x = sidx[i];
      if (last) {
        perm[o] = x;
        // word 0 had no varying digit: it is the same on every row
        if (sorted0 != nullptr && w != 0) sorted0[o] = static_cast<int64_t>(words.p[0][x]);
      } else {
        iout[o] = x;
      }
    }
  }
}

static int g_sms[16];

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_radix_tile() { return TILE; }

int64_t presto_radix_scratch_bytes() { return static_cast<int64_t>(SCRATCH_BYTES); }

// words: host array of nwords device pointers (n uint64 each); perm: n
// int64; sorted0: n uint64 or null; keys: 2n uint64 and idx: 2n int32
// (device scratch); scratch: presto_radix_scratch_bytes(), zeroed
// once, per stream; status: ceil(n / TILE) * 256 uint64, zeroed once,
// per stream. Launches 1 + 8 * nwords kernels and reads nothing back.
int presto_radix_sort(const int64_t* words, int32_t nwords, int64_t n, uint64_t flip,
                      void* perm, void* sorted0, void* keys, void* idx, void* scratch,
                      void* status, void* stream) {
  if (n < 1 || n > 0x7fffffffLL || nwords < 1 || nwords > MAX_WORDS)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 16) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sms[dev] == 0) cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Words ws = {};
  for (int w = 0; w < nwords; ++w) ws.p[w] = reinterpret_cast<const u64*>(words[w]);
  char* sc = static_cast<char*>(scratch);
  Plan* plan = reinterpret_cast<Plan*>(sc);
  uint32_t* hist = reinterpret_cast<uint32_t*>(sc + HIST_OFFSET);
  uint32_t* starts = reinterpret_cast<uint32_t*>(sc + STARTS_OFFSET);
  int64_t hgrid = (n + THREADS * HIST_ITEMS - 1) / (THREADS * HIST_ITEMS);
  if (hgrid > static_cast<int64_t>(g_sms[dev]) * HIST_BLOCKS_PER_SM)
    hgrid = static_cast<int64_t>(g_sms[dev]) * HIST_BLOCKS_PER_SM;
  radix_hist<<<static_cast<unsigned>(hgrid), THREADS, 0, st>>>(ws, nwords, n, flip, hist, starts,
                                                               plan);
  const unsigned tiles = static_cast<unsigned>((n + TILE - 1) / TILE);
  u64* kb = static_cast<u64*>(keys);
  int32_t* ib = static_cast<int32_t*>(idx);
  for (int p = 0; p < nwords * DIGITS; ++p)
    radix_pass<<<tiles, PASS_THREADS, 0, st>>>(
        p, ws, n, flip, plan, starts, static_cast<u64*>(status), kb, kb + n, ib, ib + n,
        static_cast<int64_t*>(perm), static_cast<int64_t*>(sorted0));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
