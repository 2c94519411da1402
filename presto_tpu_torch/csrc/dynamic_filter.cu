// dynamic_filter (K22 distinct_set, K23 apply_filter): the build side's
// bounded distinct key set, and the probe-side scan's narrowing of
// row_valid by a published filter.
//
// Replaces presto_tpu/execution/dynamic_filters.py `distinct_set`
// (:210) and `apply_filter` (:242), family dynamic_filter. (The running
// bounds, `bounds_step` :177, are K21, a Triton reduction in
// execution/dynamic_filters.py.)
//
// K22 distinct_set. The reference sorts the merged build column twice
// (dead lanes last, then the distinct values to the front) to keep at
// most DF_SET_MAX = 4096 values. Only 4096 values matter, so a bounded
// hash set replaces the sorts:
//
//   insert  each block takes ROWS rows and dedupes its live, non-NaN
//           keys in an open-addressing table in shared memory; a key
//           new to the block goes on into a global table of
//           GLOBAL_SLOTS = 2 x DF_SET_MAX slots (atomicCAS), which
//           counts the keys new to it. Past DF_SET_MAX the overflow
//           flag is set and every block, and every probe in flight,
//           stops early. The block-local
//           pass keeps thousands of threads from contending for the
//           same global slots when the build has few distinct keys
//           (nationkey has 25), and a slot is read before it is
//           CASed, so a present key costs one load.
//   pack    only without overflow: one block gathers the <= 4096 keys,
//           bitonic-sorts them in shared memory and writes them
//           ascending, padded with the dtype max, and the count.
//
// Keys are held as order-preserving 64-bit codes (integers with the
// sign bit flipped, floats by the IEEE total-order map after -0.0 is
// made +0.0, so the two zeros are one key, as the reference's
// dedupe treats them). An empty slot holds the all-ones code; a real
// key whose code is all ones (only an int64 key of INT64_MAX) is
// recorded by a separate flag and counted once, so every value of
// every dtype can be a key. On overflow the count saturates at
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
// What bounds them: bytes. K22 reads each key and mask once; K23
// reads key, mask and row_valid and writes row_valid. K22's hash
// probes are shared-memory atomics; K23 does log2(count) shared loads
// per row.

#include <cuda_runtime.h>
#include <stdint.h>

#define DF_SET_MAX 4096
#define GLOBAL_SLOTS (2 * DF_SET_MAX)
#define ROWS 1024
#define LOCAL_SLOTS (2 * ROWS)
#define THREADS 256
#define PACK_THREADS 1024
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

// -- K22 --------------------------------------------------------------------

// st: count | overflow | all-ones key seen (u64 each)
__device__ __forceinline__ void count_new(u64* st) {
  if (atomicAdd(&st[0], 1ULL) + 1 > DF_SET_MAX) atomicExch(&st[1], 1ULL);
}

__device__ void global_insert(u64 c, u64* gkeys, u64* st) {
  volatile u64* vk = gkeys;
  volatile u64* vst = st;
  uint32_t s = slot_of(c) & (GLOBAL_SLOTS - 1);
  for (int probe = 0; probe < GLOBAL_SLOTS; ++probe) {
    // past overflow the table fills up and a probe would walk all of
    // it: stop as soon as any thread has set the flag
    if (vst[1]) return;
    const u64 cur = vk[s];
    if (cur == c) return;
    if (cur == EMPTY) {
      const u64 prev = atomicCAS(&gkeys[s], EMPTY, c);
      if (prev == EMPTY) {
        count_new(st);
        return;
      }
      if (prev == c) return;
    }
    s = (s + 1) & (GLOBAL_SLOTS - 1);
  }
  atomicExch(&st[1], 1ULL);  // table full: more than DF_SET_MAX keys
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
df_insert(const T* __restrict__ data, const bool* __restrict__ mask, int64_t n,
          u64* gkeys, u64* st) {
  __shared__ u64 skeys[LOCAL_SLOTS];
  __shared__ int seen_ones, stop;
  volatile u64* vst = st;
  for (int i = threadIdx.x; i < LOCAL_SLOTS; i += blockDim.x) skeys[i] = EMPTY;
  if (threadIdx.x == 0) {
    seen_ones = 0;
    stop = vst[1] != 0;  // another block already overflowed
  }
  __syncthreads();
  if (stop) return;
  volatile u64* vk = skeys;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * ROWS;
  for (int j = threadIdx.x; j < ROWS; j += blockDim.x) {
    const int64_t r = base + j;
    if (r >= n || vst[1]) break;
    if (!mask[r]) continue;
    const T v = data[r];
    if (is_nan(v)) continue;
    const u64 c = code_of(v);
    if (c == EMPTY) {
      if (atomicExch(&seen_ones, 1) == 0 && atomicExch(&st[2], 1ULL) == 0) count_new(st);
      continue;
    }
    uint32_t s = slot_of(c) & (LOCAL_SLOTS - 1);
    for (;;) {
      const u64 cur = vk[s];
      if (cur == c) break;
      if (cur == EMPTY) {
        const u64 prev = atomicCAS(&skeys[s], EMPTY, c);
        if (prev == EMPTY) {
          global_insert(c, gkeys, st);
          break;
        }
        if (prev == c) break;
      }
      s = (s + 1) & (LOCAL_SLOTS - 1);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(PACK_THREADS)
df_pack(const u64* __restrict__ gkeys, const u64* __restrict__ st, T* __restrict__ vals,
        int64_t* __restrict__ out_count, bool* __restrict__ out_ovf) {
  __shared__ u64 sk[DF_SET_MAX];
  __shared__ int fill;
  const u64 count = st[0];
  const bool ovf = st[1] != 0 || count > DF_SET_MAX;
  if (threadIdx.x == 0) {
    *out_count = static_cast<int64_t>(ovf && count > DF_SET_MAX + 1 ? DF_SET_MAX + 1 : count);
    *out_ovf = ovf;
  }
  if (ovf) return;
  for (int i = threadIdx.x; i < DF_SET_MAX; i += blockDim.x) sk[i] = EMPTY;
  if (threadIdx.x == 0) fill = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < GLOBAL_SLOTS; s += blockDim.x) {
    const u64 c = gkeys[s];
    if (c != EMPTY) sk[atomicAdd(&fill, 1)] = c;
  }
  __syncthreads();
  // bitonic sort, ascending; the all-ones key (if seen) is the empty
  // code itself and sorts last among the real keys
  for (int k = 2; k <= DF_SET_MAX; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < DF_SET_MAX; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const u64 a = sk[i], b = sk[ixj];
          if ((a > b) == ((i & k) == 0)) {
            sk[i] = b;
            sk[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < DF_SET_MAX; i += blockDim.x)
    vals[i] = static_cast<u64>(i) < count ? value_of<T>(sk[i]) : dtype_max<T>();
}

template <typename T>
int distinct_set(const void* data, const void* mask, int64_t n, void* gkeys, void* st,
                 void* vals, void* count, void* ovf, cudaStream_t stream) {
  cudaMemsetAsync(gkeys, 0xff, GLOBAL_SLOTS * sizeof(u64), stream);
  cudaMemsetAsync(st, 0, 3 * sizeof(u64), stream);
  if (n > 0) {
    const unsigned grid = static_cast<unsigned>((n + ROWS - 1) / ROWS);
    df_insert<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(data),
                                               static_cast<const bool*>(mask), n,
                                               static_cast<u64*>(gkeys), static_cast<u64*>(st));
  }
  df_pack<T><<<1, PACK_THREADS, 0, stream>>>(static_cast<const u64*>(gkeys),
                                             static_cast<const u64*>(st), static_cast<T*>(vals),
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
int presto_df_table_slots() { return GLOBAL_SLOTS; }

// K22: the distinct set of `n` keys of dtype code `dt` under `mask`.
// Scratch gkeys[GLOBAL_SLOTS] and st[3] (u64); writes vals[DF_SET_MAX]
// (the key dtype), count (int64) and overflow (bool).
int presto_distinct_set(const void* data, const void* mask, int64_t n, int32_t dt, void* gkeys,
                        void* st, void* vals, void* count, void* ovf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dt) {
    case 0: return distinct_set<int32_t>(data, mask, n, gkeys, st, vals, count, ovf, s);
    case 1: return distinct_set<int64_t>(data, mask, n, gkeys, st, vals, count, ovf, s);
    case 2: return distinct_set<float>(data, mask, n, gkeys, st, vals, count, ovf, s);
    case 3: return distinct_set<double>(data, mask, n, gkeys, st, vals, count, ovf, s);
    case 4: return distinct_set<int16_t>(data, mask, n, gkeys, st, vals, count, ovf, s);
    case 5: return distinct_set<int8_t>(data, mask, n, gkeys, st, vals, count, ovf, s);
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
