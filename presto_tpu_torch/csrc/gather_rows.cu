// gather_rows (K26): one call moves every column of a batch (data and
// mask of each) and row_valid through a permutation, the second half of
// every sort of the port (after K24 and K25).
//
// Replaces the payload movement of presto_tpu/ops/common.py:232
// `sort_rows` (its variadic `lax.sort` carries every column; the port
// sorts a 32-bit row index and then moves each row once, here) and so
// of ops/sort.py:22 `_sort_batch_impl` and :54 `_topn_step_impl` (which
// keeps the first `cap` rows of state ++ batch and masks rows past `n`),
// the build's column permutation (ops/join.py:196) and the gathers of
// ops/hashagg.py `_group_reduce` (the sorted keys and contributions,
// and each group's first row).
//
// Output row j takes input row perm[j] for j < rows. The input may come
// from up to MAX_SOURCES sources: index p with off[s] <= p < off[s + 1]
// is row p - off[s] of source s (topn's state ++ batch, a merge's
// partial states, with no concatenation).
// live_j = row_valid[perm[j]] (true without a row_valid) and, with a
// limit (a device int64 the kernel reads), j < *limit; row_valid's
// output is live_j, and a mask array marked `and_live` is ANDed with it
// (topn: c.mask & live; the first rows of _group_reduce: m & (j <
// groups)). An array without a mask (hashes, contributions) is one
// array with no partner.
//
// What bounds it on the H100: random reads. Rows a sort orders by value
// arrive in random order, so each live row's element of each array is
// a read of its own 32-byte sector (and HBM3 moves at least two),
// whatever the element's width: at ORDER_LINES (7 arrays, 6,000,012
// live rows of 16,777,216) that is ~1.3 GB of the ~2.1 GB the old
// design (one thread a row walking the arrays) moved; the byte
// bound (each element read once) counts 0.94 GB. Dead rows come last
// in slot order (K24 sorts them so) and read in sequence. So for a
// value order the design makes one random read a live row:
//
//   - the host (`gather_plan`, ops/common.py) packs a launch's arrays
//     into groups of at most 32 bytes a row: the wider elements at
//     offsets aligned to their width, then the bools (masks and
//     BOOLEAN columns) one bit each;
//   - a sequential pre-pass (`stage_records`) writes each live source
//     row's group as one record of 16 or 32 bytes, aligned, so one
//     sector, and the sources' row_valid as a bitmap (2 MB at 16.8M
//     rows, which stays in the L2);
//   - the gather (`gather_records`), one thread an output row, reads
//     the row's bit; a live row's groups come from their records
//     (unpacked through shared memory, one word a thread a bank), a
//     dead row's from its arrays (in sequence); each array's stores
//     are coalesced.
// At ORDER_LINES that is 0.87-0.92 ms against the old design's
// 1.32-1.37 and index_select's 1.07-1.08 (H100, PERF.md §6).
//
// Where the records pay depends on the order, which the host cannot
// see without a read of the device: a value order reads at random, but
// rows already near the sort's order (a window over lineitem by
// orderkey, the scan's own order) or ordered by a hash (a join build,
// a grouping: a key's rows stay together) share sectors, and there the
// pre-pass costs more than it saves (at Q21's build 0.80-0.85 ms
// against 0.65-0.77 read where they lie). So the kernels look: every
// block first reads the same PROBE adjacent pairs of the permutation,
// spread over it (from the L2 after the first block), and counts the
// pairs more than NEAR rows apart; a launch whose layout could pay
// (`gather_plan`: the random reads the records save, of the share of
// the sources beyond the L2, outweigh the pre-pass's bytes if every row
// read at random) carries `need`, the count at which they do, and all
// three kernels are launched: the pre-pass and the records' gather
// exit at once below `need` (~4 us each), the direct gather at or above
// it. Every block reads the same samples, so all agree. Measured
// (ORDER_LINES' arrays, H100, PERF.md §6): at 2^24 rows the records
// win 1.55x over a value order and 2.7x with every row live, and lose
// 1.2x over runs of four rows and 1.75x near the scan's order; at 2^21
// rows (50 MB, the L2) they never win.
//
// Where no layout can pay (few rows out of many, as topn's state
// gather, or sources that fit the L2), every array is read where it
// lies (`gather_direct`) in one launch: one thread an output row,
// DIRECT loads in flight before their stores, 26 registers, so that
// many rows are in flight; more loads a thread cost occupancy and time.
//
// Tried and not kept: a gather of four rows a thread, specialised by
// width, with only the bools packed into a word a row (slower than the
// old design at ORDER_LINES' shape); records of every row, dead ones
// too (1.08 ms at ORDER_LINES); several records' or arrays' loads in
// flight a thread (48-90 registers: fewer rows in flight, slower).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_ARRAYS 64
#define MAX_SOURCES 8
// source addresses one launch takes: arrays x sources
#define MAX_SLOTS 128
#define REC_WORDS 8  // a record: at most 32 bytes
#define DIRECT 2     // arrays read where they lie a thread loads before it stores
#define BLOCKS_PER_SM 8
#define PROBE THREADS  // adjacent pairs of the permutation a block samples
#define NEAR 8         // rows apart at most for two reads to count as near

struct Plan {
  const void* src[MAX_SLOTS];  // array c of source s at c * nsrc + s
  void* dst[MAX_ARRAYS];
  void* rec[MAX_ARRAYS];          // staged group g's records (stride[g] bytes a row)
  const bool* valid[MAX_SOURCES];  // every source's row_valid, or null
  int64_t off[MAX_SOURCES + 1];
  uint32_t* live;                 // the sources' row_valid as bits (staged launches with one)
  int8_t width[MAX_ARRAYS];       // array c's element bytes (1, 2, 4, 8)
  int8_t at[MAX_ARRAYS];          // its byte in its group's record
  int8_t bit[MAX_ARRAYS];         // -1: the element; 0-7: a bool as that bit of byte `at`
  int8_t and_live[MAX_ARRAYS];
  int8_t first[MAX_ARRAYS + 1];   // arrays [first[g], first[g + 1]) form group g
  int8_t stride[MAX_ARRAYS];      // 16 or 32 bytes a record
  int32_t count, ngroups, nstaged, nsrc;  // groups [0, nstaged) are staged
  int32_t need;  // far samples from which the staged way runs (0: always)
};

// the source of concatenated row p and its row there
template <bool MULTI>
__device__ __forceinline__ int source_of(const Plan& a, int64_t p, int64_t& r) {
  int s = 0;
  if (MULTI)
    while (s + 1 < a.nsrc && p >= a.off[s + 1]) ++s;
  r = p - a.off[s];
  return s;
}

// element of array c at row r of source s, widened to 64 bits
__device__ __forceinline__ unsigned long long load_elem(const Plan& a, int c, int s, int64_t r) {
  const void* p = a.src[c * a.nsrc + s];
  switch (a.width[c]) {
    case 8: return __ldg(static_cast<const unsigned long long*>(p) + r);
    case 4: return __ldg(static_cast<const unsigned int*>(p) + r);
    case 2: return __ldg(static_cast<const unsigned short*>(p) + r);
    default: return __ldg(static_cast<const unsigned char*>(p) + r);
  }
}

// Whether the staged way runs: PROBE pairs (perm[j], perm[j + 1]), of
// which at least `need` are more than NEAR rows apart. Thread t's j
// lies in the t-th of PROBE equal segments of [0, rows - 1), at a
// pseudo-random offset (a pair at each segment's start would fall on
// the same phase of any power-of-two pattern, such as runs of four).
// Every thread of the block calls it, at the start.
__device__ __forceinline__ bool stage_runs(const int64_t* __restrict__ perm, int64_t rows,
                                           int need) {
  if (need == 0) return true;
  bool far = false;
  if (rows > 1) {
    const int64_t t = threadIdx.x, seg = (rows - 1) / PROBE;
    const uint64_t h = static_cast<uint64_t>(t + 1) * 0x9E3779B97F4A7C15ull;
    const int64_t j = seg > 0 ? t * seg + static_cast<int64_t>((h >> 11) % seg)
                              : t * (rows - 1) / PROBE;
    const long long* p = reinterpret_cast<const long long*>(perm) + j;
    const long long d = __ldg(p + 1) - __ldg(p);
    far = d > NEAR || d < -NEAR;
  }
  return __syncthreads_count(far) >= need;
}

// A thread's record in shared memory: word w at sm[w * THREADS]
// (consecutive threads, consecutive banks).
__device__ __forceinline__ unsigned long long get_bytes(const uint32_t* sm, int at, int width) {
  const int w = at >> 2;
  if (width == 8)
    return sm[w * THREADS] | (static_cast<unsigned long long>(sm[(w + 1) * THREADS]) << 32);
  const uint32_t x = sm[w * THREADS] >> (8 * (at & 3));
  return width == 4 ? x : width == 2 ? (x & 0xFFFFu) : (x & 0xFFu);
}

__device__ __forceinline__ void store_elem(const Plan& a, int c, int64_t j, unsigned long long v,
                                           bool live) {
  if (a.and_live[c]) v = live && v != 0;
  void* dst = a.dst[c];
  switch (a.width[c]) {
    case 8: static_cast<unsigned long long*>(dst)[j] = v; break;
    case 4: static_cast<uint32_t*>(dst)[j] = static_cast<uint32_t>(v); break;
    case 2: static_cast<uint16_t*>(dst)[j] = static_cast<uint16_t>(v); break;
    default: static_cast<uint8_t*>(dst)[j] = static_cast<uint8_t>(v); break;
  }
}

// any nonzero byte of w as 1 in that byte
__device__ __forceinline__ uint32_t ones(uint32_t w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  return w & 0x01010101u;
}

// bit i of the result: whether byte i of x is nonzero
__device__ __forceinline__ uint32_t byte_bits(uint4 x) {
  const uint32_t w[4] = {ones(x.x), ones(x.y), ones(x.z), ones(x.w)};
  uint32_t bits = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    bits |= ((w[q] * 0x01020408u) >> 24 & 0xFu) << (4 * q);
  return bits;
}

// the pre-pass: each live source row's staged groups as records, and
// the live bitmap (lane 0 of a warp writes the word of its 32 rows)
template <bool MULTI>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
stage_records(const Plan a, int64_t total, const int64_t* __restrict__ perm, int64_t rows) {
  if (!stage_runs(perm, rows, a.need)) return;
  __shared__ uint32_t smem[REC_WORDS * THREADS];
  uint32_t* sm = smem + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * THREADS + (threadIdx.x & ~31);
       base < total; base += stride) {
    if (a.live != nullptr && lane == 0) {
      const bool* v = a.valid[0] + base;
      uint32_t word = 0u;
      if (!MULTI && base + 32 <= total && (reinterpret_cast<uintptr_t>(v) & 15) == 0) {
        const uint4* q = reinterpret_cast<const uint4*>(v);
        word = byte_bits(__ldg(q)) | (byte_bits(__ldg(q + 1)) << 16);
      } else {
        for (int i = 0; i < 32 && base + i < total; ++i) {
          int64_t r;
          const int s = source_of<MULTI>(a, base + i, r);
          word |= static_cast<uint32_t>(a.valid[s][r] != 0) << i;
        }
      }
      a.live[base >> 5] = word;
    }
    const int64_t p = base + lane;
    if (p >= total) continue;
    int64_t r;
    const int s = source_of<MULTI>(a, p, r);
    if (a.valid[0] != nullptr && !a.valid[s][r]) continue;  // read where it lies
    for (int g = 0; g < a.nstaged; ++g) {
#pragma unroll
      for (int w = 0; w < REC_WORDS; ++w) sm[w * THREADS] = 0u;
      for (int c = a.first[g]; c < a.first[g + 1]; ++c) {
        const unsigned long long v = load_elem(a, c, s, r);
        const int at = a.at[c], w = at >> 2;
        if (a.bit[c] >= 0) {
          sm[w * THREADS] |= static_cast<uint32_t>(v != 0) << (8 * (at & 3) + a.bit[c]);
        } else if (a.width[c] == 8) {
          sm[w * THREADS] = static_cast<uint32_t>(v);
          sm[(w + 1) * THREADS] = static_cast<uint32_t>(v >> 32);
        } else {
          sm[w * THREADS] |= static_cast<uint32_t>(v) << (8 * (at & 3));
        }
      }
      const int bytes = a.stride[g];
      uint4* out = reinterpret_cast<uint4*>(static_cast<char*>(a.rec[g]) + p * bytes);
      out[0] = make_uint4(sm[0], sm[THREADS], sm[2 * THREADS], sm[3 * THREADS]);
      if (bytes == 32)
        out[1] = make_uint4(sm[4 * THREADS], sm[5 * THREADS], sm[6 * THREADS], sm[7 * THREADS]);
    }
  }
}

// the gather of a staged launch: a live row's staged groups from their
// records, a dead row's from their arrays, the lone arrays where they lie
template <bool MULTI>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
gather_records(const Plan a, const int64_t* __restrict__ perm, int64_t rows,
               bool* __restrict__ out_valid, const int64_t* __restrict__ limit) {
  if (!stage_runs(perm, rows, a.need)) return;
  __shared__ uint32_t smem[REC_WORDS * THREADS];
  uint32_t* sm = smem + threadIdx.x;
  const int64_t lim = limit != nullptr ? *limit : rows;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; j < rows;
       j += stride) {
    const int64_t p = __ldg(reinterpret_cast<const long long*>(perm) + j);
    int64_t r;
    const int s = source_of<MULTI>(a, p, r);
    // the row is live in its source: its staged groups have records
    const bool in = a.live == nullptr || ((__ldg(a.live + (p >> 5)) >> (p & 31)) & 1u);
    const bool live = j < lim && in;
    for (int g = 0; g < a.nstaged; ++g) {
      if (in) {
        const int bytes = a.stride[g];
        const uint4* rec =
            reinterpret_cast<const uint4*>(static_cast<const char*>(a.rec[g]) + p * bytes);
        const uint4 x = __ldg(rec);
        sm[0] = x.x;
        sm[THREADS] = x.y;
        sm[2 * THREADS] = x.z;
        sm[3 * THREADS] = x.w;
        if (bytes == 32) {
          const uint4 y = __ldg(rec + 1);
          sm[4 * THREADS] = y.x;
          sm[5 * THREADS] = y.y;
          sm[6 * THREADS] = y.z;
          sm[7 * THREADS] = y.w;
        }
      }
      for (int c = a.first[g]; c < a.first[g + 1]; ++c) {
        unsigned long long v;
        if (in) {
          v = get_bytes(sm, a.at[c], a.width[c]);
          if (a.bit[c] >= 0) v = (v >> a.bit[c]) & 1u;
        } else {
          v = load_elem(a, c, s, r);
        }
        store_elem(a, c, j, v, live);
      }
    }
    for (int c = a.first[a.nstaged]; c < a.count; ++c)
      store_elem(a, c, j, load_elem(a, c, s, r), live);
    if (out_valid != nullptr) out_valid[j] = live;
  }
}

// the gather of a launch with nothing staged, or of a staged launch
// whose probe found the rows near: every array read where it lies,
// DIRECT loads in flight before their stores
template <bool MULTI>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
gather_direct(const Plan a, const int64_t* __restrict__ perm, int64_t rows,
              bool* __restrict__ out_valid, const int64_t* __restrict__ limit) {
  if (a.nstaged > 0 && stage_runs(perm, rows, a.need)) return;
  const int64_t lim = limit != nullptr ? *limit : rows;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; j < rows;
       j += stride) {
    const int64_t p = __ldg(reinterpret_cast<const long long*>(perm) + j);
    int64_t r;
    const int s = source_of<MULTI>(a, p, r);
    bool live = j < lim;
    if (a.valid[0] != nullptr) live = live && a.valid[s][r];
    for (int c0 = 0; c0 < a.count; c0 += DIRECT) {
      unsigned long long v[DIRECT];
#pragma unroll
      for (int k = 0; k < DIRECT; ++k)
        if (c0 + k < a.count) v[k] = load_elem(a, c0 + k, s, r);
#pragma unroll
      for (int k = 0; k < DIRECT; ++k)
        if (c0 + k < a.count) store_elem(a, c0 + k, j, v[k], live);
    }
    if (out_valid != nullptr) out_valid[j] = live;
  }
}

static int g_sms[16];

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_gather_max_arrays() { return MAX_ARRAYS; }

// the probe's samples and its NEAR, for the host's twin
int presto_gather_probe() { return PROBE; }
int presto_gather_near() { return NEAR; }

// desc: one int64 array, laid out as
//   nsrc, ngroups, nstaged, count, live, need,
//   off[nsrc + 1] (row offsets of the sources in the concatenation
//   perm indexes, off[0] = 0), valid[nsrc] (row_valid addresses, all 0
//   when the sources have none),
//   per group g: stride, its first array's index, its records' address
//   (the staged groups first: stride 16 or 32 and off[nsrc] records,
//   16-byte aligned; then the groups of one array: 0, index, 0),
//   per array c (in group order): dst, width, at, bit, and_live,
//   src[nsrc].
// live: ceil(off[nsrc] / 32) words for the bitmap where a staged launch
// has row_valid, else 0. need: 0 to PROBE, the far samples from which
// a staged launch runs its records (0: always), and then the direct
// gather below it; 0 without a staged group. and_live only on 1-byte
// arrays. perm: int64; out_valid and limit may be null. Launches on
// `stream` the pre-pass and the records' gather (with a staged group)
// and the direct gather (without one, or with need > 0).
int presto_gather_rows(const int64_t* desc, const void* perm, int64_t rows, void* out_valid,
                       const void* limit, void* stream) {
  Plan a;
  const int nsrc = static_cast<int>(desc[0]);
  a.nsrc = nsrc;
  a.ngroups = static_cast<int32_t>(desc[1]);
  a.nstaged = static_cast<int32_t>(desc[2]);
  a.count = static_cast<int32_t>(desc[3]);
  a.live = reinterpret_cast<uint32_t*>(desc[4]);
  a.need = static_cast<int32_t>(desc[5]);
  if (desc[5] < 0 || desc[5] > PROBE || (a.need > 0 && desc[2] == 0) || nsrc < 1 ||
      nsrc > MAX_SOURCES || a.count < 0 || a.count > MAX_ARRAYS ||
      a.count * nsrc > MAX_SLOTS || a.ngroups < 0 || a.ngroups > a.count || a.nstaged < 0 ||
      a.nstaged > a.ngroups || (a.ngroups == 0) != (a.count == 0) || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* o = desc + 6;
  for (int s = 0; s <= nsrc; ++s) a.off[s] = o[s];
  o += nsrc + 1;
  for (int s = 0; s < nsrc; ++s) a.valid[s] = reinterpret_cast<const bool*>(o[s]);
  o += nsrc;
  if ((a.live != nullptr) != (a.nstaged > 0 && a.valid[0] != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int g = 0; g < a.ngroups; ++g, o += 3) {
    const bool staged = g < a.nstaged;
    a.stride[g] = static_cast<int8_t>(o[0]);
    a.first[g] = static_cast<int8_t>(o[1]);
    a.rec[g] = reinterpret_cast<void*>(o[2]);
    if ((staged && ((o[0] != 16 && o[0] != 32) || o[2] == 0 || (o[2] & 15) != 0)) ||
        (!staged && (o[0] != 0 || o[2] != 0)) || (g == 0 ? o[1] != 0 : o[1] <= a.first[g - 1]))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  a.first[a.ngroups] = static_cast<int8_t>(a.count);
  for (int g = 0; g < a.ngroups; ++g) {
    const int n = a.first[g + 1] - a.first[g];
    if (n < 1 || (g >= a.nstaged && n != 1)) return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int c = 0; c < a.count; ++c, o += 5 + nsrc) {
    a.dst[c] = reinterpret_cast<void*>(o[0]);
    a.width[c] = static_cast<int8_t>(o[1]);
    a.at[c] = static_cast<int8_t>(o[2]);
    a.bit[c] = static_cast<int8_t>(o[3]);
    a.and_live[c] = static_cast<int8_t>(o[4] != 0);
    const int w = static_cast<int>(o[1]);
    if ((w != 1 && w != 2 && w != 4 && w != 8) || o[2] < 0 || o[2] % w != 0 ||
        o[2] + w > REC_WORDS * 4 || o[3] < -1 || o[3] > 7 || (o[3] >= 0 && w != 1) ||
        (a.and_live[c] && w != 1))
      return static_cast<int>(cudaErrorInvalidValue);
    for (int s = 0; s < nsrc; ++s) a.src[c * nsrc + s] = reinterpret_cast<const void*>(o[5 + s]);
  }
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 16) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sms[dev] == 0) cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
  const int64_t cap = static_cast<int64_t>(g_sms[dev]) * BLOCKS_PER_SM;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool multi = nsrc > 1;
  const int64_t total = a.off[nsrc];
  if (a.nstaged > 0 && total > 0) {
    int64_t want = (total + THREADS - 1) / THREADS;
    if (want > cap) want = cap;
    if (multi)
      stage_records<true><<<static_cast<unsigned>(want), THREADS, 0, st>>>(a, total,
                                                                          static_cast<const int64_t*>(perm), rows);
    else
      stage_records<false><<<static_cast<unsigned>(want), THREADS, 0, st>>>(a, total,
                                                                           static_cast<const int64_t*>(perm), rows);
  }
  int64_t want = (rows + THREADS - 1) / THREADS;
  if (want > cap) want = cap;
  const int64_t* pm = static_cast<const int64_t*>(perm);
  bool* ov = static_cast<bool*>(out_valid);
  const int64_t* lim = static_cast<const int64_t*>(limit);
  if (a.nstaged > 0 && multi)
    gather_records<true><<<static_cast<unsigned>(want), THREADS, 0, st>>>(a, pm, rows, ov, lim);
  else if (a.nstaged > 0)
    gather_records<false><<<static_cast<unsigned>(want), THREADS, 0, st>>>(a, pm, rows, ov, lim);
  if (a.nstaged == 0 || a.need > 0) {
    if (multi)
      gather_direct<true><<<static_cast<unsigned>(want), THREADS, 0, st>>>(a, pm, rows, ov, lim);
    else
      gather_direct<false><<<static_cast<unsigned>(want), THREADS, 0, st>>>(a, pm, rows, ov, lim);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
