// dynamic_filter (K21 df_bounds, K22 distinct_set, K23 apply_filter):
// the build side's running key bounds and bounded distinct key set, and
// the probe-side scan's narrowing of row_valid by a published filter.
//
// Replaces presto_tpu/execution/dynamic_filters.py `bounds_step`
// (:177), `distinct_set` (:210) and `apply_filter` (:242), family
// dynamic_filter.
//
// K21 df_bounds. One launch folds a batch's live, non-NaN keys into the
// running (min, max). Blocks grid-stride over the keys with 16-byte
// loads of the keys (and the matching bytes of the mask); a masked row,
// a NULL and a NaN contribute the dtype's identities (its max to the
// min, its lowest to the max), taken in the kernel. Each block reduces
// with warp shuffles and writes its partial; the last block to finish
// (__threadfence, then an atomic ticket) folds the partials and the
// running state into the 2-element output and resets the ticket, so
// the partials and ticket are scratch the wrapper allocates once per
// device and stream. Every zero comes out as +0.0 (keys and the
// running state alike), as the plain version has it, so a zero bound
// has one sign. One launch and one call from the host: the reduction
// takes a few microseconds on the device, less than a launch costs on
// the host.
//
// K22 distinct_set. The reference sorts the merged build column twice
// (dead lanes last, then the distinct values to the front) to keep at
// most DF_SET_MAX = 4096 values. Only 4096 values matter, so a bounded
// hash set replaces the sorts, in two launches:
//
//   insert  a grid sized to the card (at least one block per THREADS
//           rows, so a 4096-row build spreads over 16 blocks)
//           grid-strides over the rows. Each block dedupes its live,
//           non-NaN keys in an open-addressing table in shared memory
//           (a bounded probe: a crowded local table lets the key
//           through); a key new to the block goes on into a global
//           table of GLOBAL_SLOTS = 2 x DF_SET_MAX slots (atomicCAS),
//           GLOBAL_ROUND probes at a time. After each round the warp
//           counts the keys it made new (a ballot, one atomicAdd per
//           warp), so the count never waits on a lane with a long
//           probe; past DF_SET_MAX the overflow flag is set and every
//           warp stops at its next round. The block-local pass keeps
//           thousands of threads from contending for the same global
//           slots when the build has few distinct keys (nationkey has
//           25), and a slot is read before it is CASed, so a present
//           key costs one load.
//   pack    PACK_GRID blocks each own PACK_SLOTS table slots. Without
//           overflow, a block that owns a key stages every key of the
//           table (<= 32 KB) in shared memory, and its key's position
//           is its rank: the count of staged keys below it (the keys
//           are distinct; four threads split each count). No sort and
//           no grid sync: O(count) per key. The blocks pad the slots
//           at or past the count with the dtype max. The last block
//           (ticket) returns the table to EMPTY and the state to 0, on
//           the overflow path too, so the next call finds them so:
//           the table and state are scratch the wrapper keeps per
//           (device, stream), with no memset per call.
//
// Two launches, by measurement on the H100 (device time of a call): at
// Q20's 4,096-row build of 2,148 keys the rank pack over PACK_GRID
// blocks beat both a one-block bitonic pack sized to the next power of
// two and a single launch whose last insert block ranks every key; at
// 25 keys those two were a few microseconds faster, which a build that
// small does not feel.
//
// Keys are held as order-preserving 64-bit codes (integers with the
// sign bit flipped, floats by the IEEE total-order map after -0.0 is
// made +0.0, so the two zeros are one key, as the reference's
// dedupe treats them). An empty slot holds the all-ones code; a real
// key whose code is all ones (only an int64 key of INT64_MAX) is
// recorded by a separate flag, counted once and written last, so every
// value of every dtype can be a key. On overflow the count saturates at
// DF_SET_MAX + 1 (the reference's is exact there; no caller reads it:
// no set is published on overflow) and the values are not written.
//
// K23 apply_filter. Each block stages the set's first `count` values
// in shared memory (32 KB for 8-byte keys), then each row computes
// row_valid & mask & mn <= key <= mx (compared in the wider of the
// probe and build key types, torch's promotion, the port's deliberate
// difference from the reference) & (no set, or a lower-bound binary
// search over the staged values finds the key). `count`, `mn` and `mx`
// are device scalars, never read on the host.
//
// What bounds them: bytes. K21 and K22 read each key and mask once; K23
// reads key, mask and row_valid and writes row_valid. K22's hash
// probes are shared-memory atomics and its pack reads the table (64 KB)
// once per block from L2; K23 does log2(count) shared loads per row.

#include <cuda_runtime.h>
#include <stdint.h>

#define DF_SET_MAX 4096
#define GLOBAL_SLOTS (2 * DF_SET_MAX)
#define THREADS 256
#define LOCAL_SLOTS 2048
#define LOCAL_PROBES 8
#define GLOBAL_ROUND 8
#define INSERT_BLOCKS_PER_SM 4
#define PACK_SLOTS 64
#define PACK_SPLIT (THREADS / PACK_SLOTS)
#define PACK_GRID (GLOBAL_SLOTS / PACK_SLOTS)
#define APPLY_THREADS 512
#define EMPTY 0xffffffffffffffffULL

typedef unsigned long long u64;

// -- order-preserving 64-bit codes ------------------------------------------

__device__ __forceinline__ u64 code_of(int64_t v) {
  return static_cast<u64>(v) ^ 0x8000000000000000ULL;
}
__device__ __forceinline__ u64 code_of(int32_t v) {
  return code_of(static_cast<int64_t>(v));
}
__device__ __forceinline__ u64 code_of(int16_t v) {
  return code_of(static_cast<int64_t>(v));
}
__device__ __forceinline__ u64 code_of(int8_t v) {
  return code_of(static_cast<int64_t>(v));
}
__device__ __forceinline__ u64 code_of(float v) {
  const uint32_t b = __float_as_uint(v == 0.0f ? 0.0f : v);
  return static_cast<u64>((b & 0x80000000u) ? ~b : (b | 0x80000000u));
}
__device__ __forceinline__ u64 code_of(double v) {
  const u64 b = static_cast<u64>(__double_as_longlong(v == 0.0 ? 0.0 : v));
  return (b & 0x8000000000000000ULL) ? ~b : (b | 0x8000000000000000ULL);
}

template <typename T> __device__ T value_of(u64 c);
template <> __device__ int64_t value_of<int64_t>(u64 c) {
  return static_cast<int64_t>(c ^ 0x8000000000000000ULL);
}
template <> __device__ int32_t value_of<int32_t>(u64 c) {
  return static_cast<int32_t>(static_cast<int64_t>(c ^ 0x8000000000000000ULL));
}
template <> __device__ int16_t value_of<int16_t>(u64 c) {
  return static_cast<int16_t>(static_cast<int64_t>(c ^ 0x8000000000000000ULL));
}
template <> __device__ int8_t value_of<int8_t>(u64 c) {
  return static_cast<int8_t>(static_cast<int64_t>(c ^ 0x8000000000000000ULL));
}
template <> __device__ float value_of<float>(u64 c) {
  const uint32_t k = static_cast<uint32_t>(c);
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}
template <> __device__ double value_of<double>(u64 c) {
  return __longlong_as_double(static_cast<long long>(
      (c & 0x8000000000000000ULL) ? (c ^ 0x8000000000000000ULL) : ~c));
}

template <typename T> __device__ __forceinline__ T dtype_max();
template <> __device__ __forceinline__ int64_t dtype_max<int64_t>() { return 0x7fffffffffffffffLL; }
template <> __device__ __forceinline__ int32_t dtype_max<int32_t>() { return 0x7fffffff; }
template <> __device__ __forceinline__ int16_t dtype_max<int16_t>() { return 0x7fff; }
template <> __device__ __forceinline__ int8_t dtype_max<int8_t>() { return 0x7f; }
template <> __device__ __forceinline__ float dtype_max<float>() { return 3.402823466e+38f; }
template <> __device__ __forceinline__ double dtype_max<double>() {
  return 1.7976931348623157e+308;
}

template <typename T> __device__ __forceinline__ bool is_nan(T v) { return v != v; }

__device__ __forceinline__ uint32_t slot_of(u64 c) {
  c ^= c >> 33;
  c *= 0xff51afd7ed558ccdULL;
  c ^= c >> 33;
  c *= 0xc4ceb9fe1a85ec53ULL;
  c ^= c >> 33;
  return static_cast<uint32_t>(c);
}

// -- K21 --------------------------------------------------------------------

#define BOUNDS_THREADS 256
#define BOUNDS_WARPS (BOUNDS_THREADS / 32)
#define BOUNDS_MAX_GRID 1024

template <typename T> __device__ __forceinline__ T dtype_lowest();
template <> __device__ __forceinline__ int64_t dtype_lowest<int64_t>() {
  return static_cast<int64_t>(0x8000000000000000ULL);
}
template <> __device__ __forceinline__ int32_t dtype_lowest<int32_t>() {
  return static_cast<int32_t>(0x80000000u);
}
template <> __device__ __forceinline__ int16_t dtype_lowest<int16_t>() { return -0x8000; }
template <> __device__ __forceinline__ int8_t dtype_lowest<int8_t>() { return -0x80; }
template <> __device__ __forceinline__ float dtype_lowest<float>() { return -3.402823466e+38f; }
template <> __device__ __forceinline__ double dtype_lowest<double>() {
  return -1.7976931348623157e+308;
}

// -0.0 as +0.0 (integers unchanged)
template <typename T> __device__ __forceinline__ T canon(T v) {
  return v == T(0) ? T(0) : v;
}

// a warp shuffle of any key type (8- and 16-bit keys through int)
template <typename T> __device__ __forceinline__ T shfl_xor(T v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
template <> __device__ __forceinline__ int8_t shfl_xor<int8_t>(int8_t v, int o) {
  return static_cast<int8_t>(__shfl_xor_sync(0xffffffffu, static_cast<int>(v), o));
}
template <> __device__ __forceinline__ int16_t shfl_xor<int16_t>(int16_t v, int o) {
  return static_cast<int16_t>(__shfl_xor_sync(0xffffffffu, static_cast<int>(v), o));
}

template <typename T> __device__ __forceinline__ void fold(T v, T& lo, T& hi) {
  lo = v < lo ? v : lo;
  hi = v > hi ? v : hi;
}

// V keys of 16 bytes, and their V mask bytes, in one load each
template <typename T, int V> struct alignas(sizeof(T) * V) KeyPack { T v[V]; };
template <int V> struct alignas(V) MaskPack { uint8_t m[V]; };

// (lo, hi) of every thread folded into thread 0's
template <typename T> __device__ void block_minmax(T& lo, T& hi) {
  __shared__ T slo[BOUNDS_WARPS], shi[BOUNDS_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const T a = shfl_xor(lo, o), b = shfl_xor(hi, o);
    lo = a < lo ? a : lo;
    hi = b > hi ? b : hi;
  }
  if (lane == 0) {
    slo[warp] = lo;
    shi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < BOUNDS_WARPS; ++w) {
      lo = slo[w] < lo ? slo[w] : lo;
      hi = shi[w] > hi ? shi[w] : hi;
    }
}

template <typename T, int V>
__global__ void __launch_bounds__(BOUNDS_THREADS)
df_bounds(const T* __restrict__ data, const bool* __restrict__ mask, int64_t n,
          const T* __restrict__ mn, const T* __restrict__ mx, T* __restrict__ out, T* part,
          unsigned* ticket) {
  __shared__ bool last;
  T lo = dtype_max<T>(), hi = dtype_lowest<T>();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * BOUNDS_THREADS;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * BOUNDS_THREADS + threadIdx.x;
  const int64_t packs = n / V;
  const KeyPack<T, V>* kp = reinterpret_cast<const KeyPack<T, V>*>(data);
  const MaskPack<V>* mp = reinterpret_cast<const MaskPack<V>*>(mask);
  for (int64_t i = first; i < packs; i += stride) {
    const KeyPack<T, V> k = kp[i];
    const MaskPack<V> m = mp[i];
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (m.m[j] && !is_nan(k.v[j])) fold(canon(k.v[j]), lo, hi);
  }
  for (int64_t r = packs * V + first; r < n; r += stride)
    if (mask[r] && !is_nan(data[r])) fold(canon(data[r]), lo, hi);
  block_minmax(lo, hi);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = lo;
    part[2 * blockIdx.x + 1] = hi;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  lo = canon(*mn);
  hi = canon(*mx);
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += BOUNDS_THREADS) {
    const T a = __ldcg(part + 2 * b), c = __ldcg(part + 2 * b + 1);
    lo = a < lo ? a : lo;
    hi = c > hi ? c : hi;
  }
  __syncthreads();  // block_minmax's shared arrays are reused
  block_minmax(lo, hi);
  if (threadIdx.x == 0) {
    out[0] = lo;
    out[1] = hi;
    *ticket = 0;
  }
}

static int g_bounds_grid[16];

template <typename T>
int bounds(const void* data, const void* mask, int64_t n, const void* mn, const void* mx,
           void* out, void* scratch, cudaStream_t stream) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 16) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_bounds_grid[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    g_bounds_grid[dev] = sms * 4 < BOUNDS_MAX_GRID ? sms * 4 : BOUNDS_MAX_GRID;
  }
  const int v = static_cast<int>(16 / sizeof(T));
  const bool wide = (reinterpret_cast<uintptr_t>(data) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(mask) % v == 0);
  const int64_t work = (wide ? n / v : n) + BOUNDS_THREADS - 1;
  int64_t grid = work / BOUNDS_THREADS;
  if (grid > g_bounds_grid[dev]) grid = g_bounds_grid[dev];
  if (grid < 1) grid = 1;
  T* part = static_cast<T*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(static_cast<char*>(scratch) +
                                                 2 * BOUNDS_MAX_GRID * sizeof(int64_t));
  const T* d = static_cast<const T*>(data);
  const bool* m = static_cast<const bool*>(mask);
  const T* a = static_cast<const T*>(mn);
  const T* b = static_cast<const T*>(mx);
  T* o = static_cast<T*>(out);
  const unsigned g = static_cast<unsigned>(grid);
  if (wide)
    df_bounds<T, 16 / sizeof(T)><<<g, BOUNDS_THREADS, 0, stream>>>(d, m, n, a, b, o, part, ticket);
  else
    df_bounds<T, 1><<<g, BOUNDS_THREADS, 0, stream>>>(d, m, n, a, b, o, part, ticket);
  return static_cast<int>(cudaGetLastError());
}

// -- K22 --------------------------------------------------------------------

// scratch (u64): table[GLOBAL_SLOTS] (EMPTY between calls), then the
// state: count | overflow | all-ones key seen | pack ticket (0 between
// calls)
#define ST_COUNT 0
#define ST_OVF 1
#define ST_ONES 2
#define ST_TICKET 3
#define DF_SCRATCH_WORDS (GLOBAL_SLOTS + 4)

// true when `c` was not in the block's table yet, or the table is too
// crowded to say
__device__ __forceinline__ bool local_new(u64 c, u64* skeys) {
  volatile u64* vk = skeys;
  uint32_t s = slot_of(c) & (LOCAL_SLOTS - 1);
  for (int probe = 0; probe < LOCAL_PROBES; ++probe) {
    const u64 cur = vk[s];
    if (cur == c) return false;
    if (cur == EMPTY) {
      const u64 prev = atomicCAS(&skeys[s], EMPTY, c);
      if (prev == EMPTY) return true;
      if (prev == c) return false;
    }
    s = (s + 1) & (LOCAL_SLOTS - 1);
  }
  return true;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
df_insert(const T* __restrict__ data, const bool* __restrict__ mask, int64_t n, u64* gkeys,
          u64* st) {
  __shared__ u64 skeys[LOCAL_SLOTS];
  __shared__ int seen_ones;
  volatile u64* vst = st;
  volatile u64* vk = gkeys;
  for (int i = threadIdx.x; i < LOCAL_SLOTS; i += THREADS) skeys[i] = EMPTY;
  if (threadIdx.x == 0) seen_ones = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  // warp-uniform rows, so that a warp counts its new keys in one add
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * THREADS + (threadIdx.x & ~31); base < n;
       base += stride) {
    // another warp overflowed
    if (__shfl_sync(0xffffffffu, lane == 0 ? vst[ST_OVF] : 0ULL, 0)) return;
    const int64_t r = base + lane;
    bool fresh = false, pending = false;
    u64 c = EMPTY;
    if (r < n && mask[r]) {
      const T v = data[r];
      if (!is_nan(v)) {
        c = code_of(v);
        if (c == EMPTY)
          fresh = atomicExch(&seen_ones, 1) == 0 && atomicExch(&st[ST_ONES], 1ULL) == 0;
        else
          pending = local_new(c, skeys);
      }
    }
    // the global table, GLOBAL_ROUND probes at a time: after each round
    // the warp counts what it inserted, so the count (and the overflow
    // flag) never waits on a lane with a long probe
    uint32_t s = slot_of(c) & (GLOBAL_SLOTS - 1);
    int probes = 0;
    for (;;) {
      for (int k = 0; k < GLOBAL_ROUND && pending; ++k) {
        const u64 cur = vk[s];
        if (cur == c) {
          pending = false;
        } else if (cur == EMPTY) {
          const u64 prev = atomicCAS(&gkeys[s], EMPTY, c);
          if (prev == EMPTY || prev == c) {
            fresh = prev == EMPTY;
            pending = false;
          }
        }
        if (pending) {
          s = (s + 1) & (GLOBAL_SLOTS - 1);
          if (++probes == GLOBAL_SLOTS) {  // table full: more than DF_SET_MAX keys
            atomicExch(&st[ST_OVF], 1ULL);
            pending = false;
          }
        }
      }
      const unsigned got = __ballot_sync(0xffffffffu, fresh);
      fresh = false;
      if (lane == 0 && got != 0u &&
          atomicAdd(&st[ST_COUNT], static_cast<u64>(__popc(got))) + __popc(got) > DF_SET_MAX)
        atomicExch(&st[ST_OVF], 1ULL);
      // past overflow the table fills up and a probe would walk all of
      // it: every warp stops at the next round
      if (__shfl_sync(0xffffffffu, lane == 0 ? vst[ST_OVF] : 0ULL, 0)) return;
      if (!__any_sync(0xffffffffu, pending)) break;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
df_pack(u64* gkeys, u64* st, T* __restrict__ vals, int64_t* __restrict__ out_count,
        bool* __restrict__ out_ovf) {
  __shared__ u64 sk[DF_SET_MAX];
  __shared__ int fill;
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const u64 count = st[ST_COUNT];
  const bool ones = st[ST_ONES] != 0;
  const bool ovf = st[ST_OVF] != 0 || count > DF_SET_MAX;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *out_count = static_cast<int64_t>(ovf && count > DF_SET_MAX + 1 ? DF_SET_MAX + 1 : count);
    *out_ovf = ovf;
  }
  if (!ovf) {
    const int slot = blockIdx.x * PACK_SLOTS + threadIdx.x / PACK_SPLIT;
    const int part = threadIdx.x % PACK_SPLIT;
    const u64 mine = gkeys[slot];
    if (__syncthreads_or(mine != EMPTY)) {
      // every key of the table, in shared memory (in any order: a rank
      // does not depend on it)
      if (threadIdx.x == 0) fill = 0;
      __syncthreads();
      for (int s = threadIdx.x; s < GLOBAL_SLOTS; s += THREADS) {
        const u64 c = gkeys[s];
        const unsigned got = __ballot_sync(0xffffffffu, c != EMPTY);
        int at = 0;
        if (lane == 0 && got != 0u) at = atomicAdd(&fill, __popc(got));
        at = __shfl_sync(0xffffffffu, at, 0);
        if (c != EMPTY) sk[at + __popc(got & ((1u << lane) - 1u))] = c;
      }
      __syncthreads();
      const int keys = fill;
      uint32_t rank = 0;
      if (mine != EMPTY)
        for (int i = part; i < keys; i += PACK_SPLIT) rank += sk[i] < mine;
      // the PACK_SPLIT threads of a slot are adjacent lanes
      for (int o = 1; o < PACK_SPLIT; o <<= 1) rank += __shfl_xor_sync(0xffffffffu, rank, o);
      if (mine != EMPTY && part == 0) vals[rank] = value_of<T>(mine);
    }
    // the all-ones key sorts last; the slots past the count hold the
    // dtype max
    if (ones && blockIdx.x == 0 && threadIdx.x == 0) vals[count - 1] = value_of<T>(EMPTY);
    for (int i = blockIdx.x * (DF_SET_MAX / PACK_GRID) + threadIdx.x;
         i < (blockIdx.x + 1) * (DF_SET_MAX / PACK_GRID); i += THREADS)
      if (static_cast<u64>(i) >= count) vals[i] = dtype_max<T>();
  }
  // the last block returns the table and the state for the next call
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&st[ST_TICKET], 1ULL) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int s = threadIdx.x; s < GLOBAL_SLOTS; s += THREADS) gkeys[s] = EMPTY;
  if (threadIdx.x < 4) st[threadIdx.x] = 0;
}

static int g_insert_grid[16];

template <typename T>
int distinct_set(const void* data, const void* mask, int64_t n, void* scratch, void* vals,
                 void* count, void* ovf, cudaStream_t stream) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 16) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_insert_grid[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    g_insert_grid[dev] = sms * INSERT_BLOCKS_PER_SM;
  }
  u64* gkeys = static_cast<u64*>(scratch);
  u64* st = gkeys + GLOBAL_SLOTS;
  if (n > 0) {
    int64_t grid = (n + THREADS - 1) / THREADS;
    if (grid > g_insert_grid[dev]) grid = g_insert_grid[dev];
    df_insert<T><<<static_cast<unsigned>(grid), THREADS, 0, stream>>>(
        static_cast<const T*>(data), static_cast<const bool*>(mask), n, gkeys, st);
  }
  df_pack<T><<<PACK_GRID, THREADS, 0, stream>>>(gkeys, st, static_cast<T*>(vals),
                                                static_cast<int64_t*>(count),
                                                static_cast<bool*>(ovf));
  return static_cast<int>(cudaGetLastError());
}

// -- K23 --------------------------------------------------------------------

// the type two key types are compared in: a float type where either
// is one, as torch.promote_types ranks them; int64 for two integer
// types (any integer type holds both exactly, so int64 compares as
// torch's narrower promotion does; int32 for two int32 keys keeps the
// staged set at 16 KB)
template <typename A, typename B> struct Wide {
  typedef int64_t type;
};
template <> struct Wide<int32_t, int32_t> { typedef int32_t type; };
template <typename B> struct Wide<float, B> { typedef float type; };
template <typename A> struct Wide<A, float> { typedef float type; };
template <> struct Wide<float, float> { typedef float type; };
template <typename B> struct Wide<double, B> { typedef double type; };
template <typename A> struct Wide<A, double> { typedef double type; };
template <> struct Wide<double, double> { typedef double type; };
template <> struct Wide<double, float> { typedef double type; };
template <> struct Wide<float, double> { typedef double type; };

template <typename P, typename B>
__global__ void __launch_bounds__(APPLY_THREADS)
df_apply(const P* __restrict__ key, const bool* __restrict__ mask, const bool* __restrict__ valid,
         int64_t n, const B* __restrict__ mn, const B* __restrict__ mx,
         const B* __restrict__ set_vals, const int64_t* __restrict__ set_count, int has_set,
         bool* __restrict__ out) {
  typedef typename Wide<P, B>::type W;
  __shared__ W sv[DF_SET_MAX];
  int count = 0;
  if (has_set) {
    const int64_t c = *set_count;
    count = static_cast<int>(c < DF_SET_MAX ? c : DF_SET_MAX);
    for (int i = threadIdx.x; i < count; i += blockDim.x) sv[i] = static_cast<W>(set_vals[i]);
    __syncthreads();
  }
  const W lo = static_cast<W>(*mn), hi = static_cast<W>(*mx);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    bool keep = valid[r] && mask[r];
    if (keep) {
      const W x = static_cast<W>(key[r]);
      keep = x >= lo && x <= hi;
      if (keep && has_set) {
        int a = 0, b = count;  // first slot with sv >= x
        while (a < b) {
          const int mid = (a + b) >> 1;
          if (sv[mid] < x) a = mid + 1;
          else b = mid;
        }
        keep = a < count && sv[a] == x;
      }
    }
    out[r] = keep;
  }
}

template <typename P, typename B>
int apply_filter(const void* key, const void* mask, const void* valid, int64_t n, const void* mn,
                 const void* mx, const void* set_vals, const void* set_count, int has_set,
                 void* out, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int64_t grid = (n + APPLY_THREADS - 1) / APPLY_THREADS;
  if (grid > 132 * 4) grid = 132 * 4;
  df_apply<P, B><<<static_cast<unsigned>(grid), APPLY_THREADS, 0, stream>>>(
      static_cast<const P*>(key), static_cast<const bool*>(mask), static_cast<const bool*>(valid),
      n, static_cast<const B*>(mn), static_cast<const B*>(mx), static_cast<const B*>(set_vals),
      static_cast<const int64_t*>(set_count), has_set, static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}

// dtype codes: 0 int32, 1 int64, 2 float32, 3 float64, 4 int16, 5 int8
template <typename P>
int apply_for_build(int bt, const void* key, const void* mask, const void* valid, int64_t n,
                    const void* mn, const void* mx, const void* set_vals, const void* set_count,
                    int has_set, void* out, cudaStream_t st) {
  switch (bt) {
    case 0: return apply_filter<P, int32_t>(key, mask, valid, n, mn, mx, set_vals, set_count, has_set, out, st);
    case 1: return apply_filter<P, int64_t>(key, mask, valid, n, mn, mx, set_vals, set_count, has_set, out, st);
    case 2: return apply_filter<P, float>(key, mask, valid, n, mn, mx, set_vals, set_count, has_set, out, st);
    case 3: return apply_filter<P, double>(key, mask, valid, n, mn, mx, set_vals, set_count, has_set, out, st);
    case 4: return apply_filter<P, int16_t>(key, mask, valid, n, mn, mx, set_vals, set_count, has_set, out, st);
    case 5: return apply_filter<P, int8_t>(key, mask, valid, n, mn, mx, set_vals, set_count, has_set, out, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_df_set_max() { return DF_SET_MAX; }

int presto_df_bounds_scratch() {
  return static_cast<int>(2 * BOUNDS_MAX_GRID * sizeof(int64_t) + sizeof(int64_t));
}

// K21: out[0], out[1] = min(mn, live non-NaN keys), max(mx, ...) for n
// keys of dtype code `dt` under `mask` (mn, mx and out on the device;
// out holds two keys). scratch: presto_df_bounds_scratch() bytes,
// zeroed once; the kernel leaves its ticket at 0.
int presto_df_bounds(const void* data, const void* mask, int64_t n, int32_t dt, const void* mn,
                     const void* mx, void* out, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dt) {
    case 0: return bounds<int32_t>(data, mask, n, mn, mx, out, scratch, s);
    case 1: return bounds<int64_t>(data, mask, n, mn, mx, out, scratch, s);
    case 2: return bounds<float>(data, mask, n, mn, mx, out, scratch, s);
    case 3: return bounds<double>(data, mask, n, mn, mx, out, scratch, s);
    case 4: return bounds<int16_t>(data, mask, n, mn, mx, out, scratch, s);
    case 5: return bounds<int8_t>(data, mask, n, mn, mx, out, scratch, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
int presto_df_set_scratch_words() { return DF_SCRATCH_WORDS; }

// K22: the distinct set of `n` keys of dtype code `dt` under `mask`.
// scratch: presto_df_set_scratch_words() u64, the table EMPTY
// (all ones) and the rest 0 when first used, per stream (the kernels
// leave it so); writes vals[DF_SET_MAX] (the key dtype), count (int64)
// and overflow (bool).
int presto_distinct_set(const void* data, const void* mask, int64_t n, int32_t dt, void* scratch,
                        void* vals, void* count, void* ovf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dt) {
    case 0: return distinct_set<int32_t>(data, mask, n, scratch, vals, count, ovf, s);
    case 1: return distinct_set<int64_t>(data, mask, n, scratch, vals, count, ovf, s);
    case 2: return distinct_set<float>(data, mask, n, scratch, vals, count, ovf, s);
    case 3: return distinct_set<double>(data, mask, n, scratch, vals, count, ovf, s);
    case 4: return distinct_set<int16_t>(data, mask, n, scratch, vals, count, ovf, s);
    case 5: return distinct_set<int8_t>(data, mask, n, scratch, vals, count, ovf, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K23: out[r] = valid[r] & mask[r] & mn <= key[r] <= mx & (set member
// when has_set), for n probe rows of dtype code `pt` against a filter
// of dtype code `bt` (mn, mx, set values and the int64 count all on
// the device).
int presto_apply_filter(const void* key, const void* mask, const void* valid, int64_t n,
                        int32_t pt, int32_t bt, const void* mn, const void* mx,
                        const void* set_vals, const void* set_count, int32_t has_set, void* out,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pt) {
    case 0: return apply_for_build<int32_t>(bt, key, mask, valid, n, mn, mx, set_vals, set_count, has_set, out, s);
    case 1: return apply_for_build<int64_t>(bt, key, mask, valid, n, mn, mx, set_vals, set_count, has_set, out, s);
    case 2: return apply_for_build<float>(bt, key, mask, valid, n, mn, mx, set_vals, set_count, has_set, out, s);
    case 3: return apply_for_build<double>(bt, key, mask, valid, n, mn, mx, set_vals, set_count, has_set, out, s);
    case 4: return apply_for_build<int16_t>(bt, key, mask, valid, n, mn, mx, set_vals, set_count, has_set, out, s);
    case 5: return apply_for_build<int8_t>(bt, key, mask, valid, n, mn, mx, set_vals, set_count, has_set, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
