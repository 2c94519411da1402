// direct_slot_reduce: one direct-path aggregation step for every state
// component of a batch, in one launch.
//
// Replaces presto_tpu/ops/hashagg.py `_slot_reduce` as `direct_step`
// calls it (one segment/one-hot reduction per state component, plus
// the `present` max over row_valid), for the small-domain slot table
// that `operators/aggregation.py` `_direct_domains` selects: every
// group key is dictionary-coded or boolean, so the group id is the
// mixed-radix combination of the key codes and needs no hashing.
//
// What bounds it: bytes. Each row is read once (key codes, key masks,
// row_valid, one contribution per component: Q1 reads ~125 bytes a
// row) and the slot table is tiny (Q1: 12 slots x 15 components), so
// the floor is the contribution bytes over HBM bandwidth. The design
// keeps the table out of HBM during the pass:
//   * a grid-stride loop over rows, one row per lane;
//   * each block keeps a private copy of the slot table in shared
//     memory when num_slots x components x 8 B fits (else it updates
//     the state in global memory directly);
//   * lanes of a warp that hit the same slot first combine their
//     values with a labeled-partition reduction (cooperative groups),
//     so one atomic per (warp, slot, component) reaches shared memory:
//     Q6's single slot would otherwise serialize all 32 lanes on one
//     address;
//   * at the end each block merges the slots it touched into the
//     global state with one atomic per (slot, component).
// The state is updated IN PLACE (the JAX reference is functional and
// returns new arrays); the wrapper documents that.
//
// Float sums are combined in an order that varies from run to run
// (atomics), so float64 results agree with the plain version to
// rounding, not bit for bit. Integer sums wrap like the reference's
// int64 segment_sum.
//
// float min/max use a compare-and-swap loop in which a NaN wins, as
// the reference's segment_min / segment_max let it: a NaN contribution
// replaces any value, and nothing replaces a NaN. The warp's combine
// does the same (NanMin / NanMax; cg::less / cg::greater would keep or
// drop the NaN depending on the order).

#include <cooperative_groups.h>
#include <cooperative_groups/reduce.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define MAX_KEYS 8
#define MAX_COMPS 64
#define THREADS 256
#define SMEM_LIMIT (48 * 1024)

enum Dtype { DT_I32 = 0, DT_I64 = 1, DT_F32 = 2, DT_F64 = 3 };
enum Op { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };

struct SlotReduceArgs {
  const int32_t* key_codes[MAX_KEYS];
  const bool* key_masks[MAX_KEYS];
  int32_t domains[MAX_KEYS];
  int32_t nkeys;
  const bool* row_valid;
  int64_t n;
  const void* contrib[MAX_COMPS];
  void* state[MAX_COMPS];
  int8_t dtype[MAX_COMPS];
  int8_t op[MAX_COMPS];
  int32_t ncomp;
  bool* present;
  int32_t num_slots;
};

// -- atomics -------------------------------------------------------------

__device__ __forceinline__ void atomic_op(int32_t* p, int32_t v, int op) {
  if (op == OP_SUM) atomicAdd(p, v);
  else if (op == OP_MIN) atomicMin(p, v);
  else atomicMax(p, v);
}

__device__ __forceinline__ void atomic_op(int64_t* p, int64_t v, int op) {
  if (op == OP_SUM)
    atomicAdd(reinterpret_cast<unsigned long long*>(p),
              static_cast<unsigned long long>(v));
  else if (op == OP_MIN)
    atomicMin(reinterpret_cast<long long*>(p), static_cast<long long>(v));
  else
    atomicMax(reinterpret_cast<long long*>(p), static_cast<long long>(v));
}

__device__ __forceinline__ void atomic_op(double* p, double v, int op) {
  if (op == OP_SUM) {
    atomicAdd(p, v);
    return;
  }
  unsigned long long* a = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *a, assumed;
  do {
    assumed = old;
    double cur = __longlong_as_double(assumed);
    if (cur != cur) return;  // a NaN stays
    if (v == v && (op == OP_MIN ? !(v < cur) : !(v > cur))) return;
    old = atomicCAS(a, assumed, __double_as_longlong(v));
  } while (old != assumed);
}

__device__ __forceinline__ void atomic_op(float* p, float v, int op) {
  if (op == OP_SUM) {
    atomicAdd(p, v);
    return;
  }
  unsigned int* a = reinterpret_cast<unsigned int*>(p);
  unsigned int old = *a, assumed;
  do {
    assumed = old;
    float cur = __uint_as_float(assumed);
    if (cur != cur) return;  // a NaN stays
    if (v == v && (op == OP_MIN ? !(v < cur) : !(v > cur))) return;
    old = atomicCAS(a, assumed, __float_as_uint(v));
  } while (old != assumed);
}

template <typename T>
__device__ __forceinline__ T identity(int op);
template <>
__device__ __forceinline__ int32_t identity<int32_t>(int op) {
  return op == OP_SUM ? 0 : (op == OP_MIN ? INT32_MAX : INT32_MIN);
}
template <>
__device__ __forceinline__ int64_t identity<int64_t>(int op) {
  return op == OP_SUM ? 0 : (op == OP_MIN ? INT64_MAX : INT64_MIN);
}
template <>
__device__ __forceinline__ float identity<float>(int op) {
  return op == OP_SUM ? 0.0f
                      : (op == OP_MIN ? __int_as_float(0x7f7fffff)
                                      : -__int_as_float(0x7f7fffff));
}
template <>
__device__ __forceinline__ double identity<double>(int op) {
  return op == OP_SUM ? 0.0
                      : (op == OP_MIN ? __longlong_as_double(0x7fefffffffffffffLL)
                                      : -__longlong_as_double(0x7fefffffffffffffLL));
}

// min / max with a NaN winning (x != x only for a NaN)
template <typename T>
struct NanMin {
  __device__ __forceinline__ T operator()(T a, T b) const {
    return a != a ? a : (b != b ? b : (b < a ? b : a));
  }
};
template <typename T>
struct NanMax {
  __device__ __forceinline__ T operator()(T a, T b) const {
    return a != a ? a : (b != b ? b : (b > a ? b : a));
  }
};

// Combine `v` across the lanes of `grp` (lanes of one warp holding the
// same slot) and let the group's first lane apply it to `dst`.
template <typename T>
__device__ __forceinline__ void group_apply(const cg::coalesced_group& grp,
                                            T* dst, T v, int op) {
  T r;
  if (op == OP_SUM) r = cg::reduce(grp, v, cg::plus<T>());
  else if (op == OP_MIN) r = cg::reduce(grp, v, NanMin<T>());
  else r = cg::reduce(grp, v, NanMax<T>());
  if (grp.thread_rank() == 0) atomic_op(dst, r, op);
}

// Address of slot `slot` of component `c`: shared tables use an 8-byte
// stride per entry whatever the component's width.
template <typename T>
__device__ __forceinline__ T* table_entry(const SlotReduceArgs& a,
                                          unsigned char* smem, bool use_smem,
                                          int c, int slot) {
  if (use_smem)
    return reinterpret_cast<T*>(smem + (static_cast<size_t>(c) * a.num_slots + slot) * 8);
  return reinterpret_cast<T*>(a.state[c]) + slot;
}

template <typename T>
__device__ __forceinline__ void contribute(const SlotReduceArgs& a,
                                           const cg::coalesced_group& grp,
                                           unsigned char* smem, bool use_smem,
                                           int c, int slot, int64_t row,
                                           bool live) {
  int op = a.op[c];
  T v = live ? reinterpret_cast<const T*>(a.contrib[c])[row] : identity<T>(op);
  group_apply(grp, table_entry<T>(a, smem, use_smem, c, slot), v, op);
}

template <typename T>
__device__ __forceinline__ void init_entry(const SlotReduceArgs& a,
                                           unsigned char* smem, int c, int slot) {
  *table_entry<T>(a, smem, true, c, slot) = identity<T>(a.op[c]);
}

template <typename T>
__device__ __forceinline__ void merge_entry(const SlotReduceArgs& a,
                                            unsigned char* smem, int c, int slot) {
  atomic_op(reinterpret_cast<T*>(a.state[c]) + slot,
            *table_entry<T>(a, smem, true, c, slot), a.op[c]);
}

__global__ void __launch_bounds__(THREADS)
slot_reduce_kernel(const SlotReduceArgs a, bool use_smem) {
  extern __shared__ __align__(8) unsigned char smem[];
  // shared layout (use_smem only): [ncomp][num_slots] 8-byte entries,
  // then one int "touched" flag per slot
  int* touched = reinterpret_cast<int*>(
      smem + static_cast<size_t>(a.ncomp) * a.num_slots * 8);
  const int drop = a.num_slots;

  if (use_smem) {
    for (int i = threadIdx.x; i < a.ncomp * a.num_slots; i += blockDim.x) {
      int c = i / a.num_slots, slot = i % a.num_slots;
      switch (a.dtype[c]) {
        case DT_I32: init_entry<int32_t>(a, smem, c, slot); break;
        case DT_I64: init_entry<int64_t>(a, smem, c, slot); break;
        case DT_F32: init_entry<float>(a, smem, c, slot); break;
        default: init_entry<double>(a, smem, c, slot); break;
      }
    }
    for (int s = threadIdx.x; s < a.num_slots; s += blockDim.x) touched[s] = 0;
    __syncthreads();
  }

  cg::thread_block_tile<32> warp = cg::tiled_partition<32>(cg::this_thread_block());
  // warp-uniform trip count: every lane of a warp runs every iteration
  // (lanes past n carry the drop slot), so the warp-wide partitions
  // below always see all 32 lanes
  const int64_t warps_total = static_cast<int64_t>(gridDim.x) * (blockDim.x / 32);
  const int64_t warp_id = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) +
                          threadIdx.x / 32;
  for (int64_t base = warp_id * 32; base < a.n; base += warps_total * 32) {
    const int64_t row = base + warp.thread_rank();
    bool live = row < a.n && a.row_valid[row];
    int slot = drop;
    if (live) {
      int gid = 0;
      for (int k = 0; k < a.nkeys; ++k) {
        int dom = a.domains[k];
        int code = a.key_masks[k][row] ? a.key_codes[k][row] : dom;
        gid = gid * (dom + 1) + code;
      }
      slot = gid;
    }
    cg::coalesced_group grp = cg::labeled_partition(warp, slot);
    if (slot != drop) {
      if (grp.thread_rank() == 0) {
        if (use_smem) touched[slot] = 1;
        else a.present[slot] = true;
      }
      for (int c = 0; c < a.ncomp; ++c) {
        switch (a.dtype[c]) {
          case DT_I32: contribute<int32_t>(a, grp, smem, use_smem, c, slot, row, live); break;
          case DT_I64: contribute<int64_t>(a, grp, smem, use_smem, c, slot, row, live); break;
          case DT_F32: contribute<float>(a, grp, smem, use_smem, c, slot, row, live); break;
          default: contribute<double>(a, grp, smem, use_smem, c, slot, row, live); break;
        }
      }
    }
  }
  if (!use_smem) return;
  __syncthreads();
  for (int s = threadIdx.x; s < a.num_slots; s += blockDim.x)
    if (touched[s]) a.present[s] = true;
  for (int i = threadIdx.x; i < a.ncomp * a.num_slots; i += blockDim.x) {
    int c = i / a.num_slots, slot = i % a.num_slots;
    if (!touched[slot]) continue;
    switch (a.dtype[c]) {
      case DT_I32: merge_entry<int32_t>(a, smem, c, slot); break;
      case DT_I64: merge_entry<int64_t>(a, smem, c, slot); break;
      case DT_F32: merge_entry<float>(a, smem, c, slot); break;
      default: merge_entry<double>(a, smem, c, slot); break;
    }
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Host arrays describe the device arrays: key_codes/key_masks/domains
// have nkeys entries, contrib/state/dtypes/ops have ncomp entries.
int presto_direct_slot_reduce(const int64_t* key_codes, const int64_t* key_masks,
                              const int32_t* domains, int32_t nkeys,
                              const void* row_valid, int64_t n,
                              const int64_t* contrib, const int64_t* state,
                              const int32_t* dtypes, const int32_t* ops,
                              int32_t ncomp, void* present, int32_t num_slots,
                              void* stream) {
  if (nkeys > MAX_KEYS || ncomp > MAX_COMPS || num_slots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  SlotReduceArgs a;
  for (int k = 0; k < nkeys; ++k) {
    a.key_codes[k] = reinterpret_cast<const int32_t*>(key_codes[k]);
    a.key_masks[k] = reinterpret_cast<const bool*>(key_masks[k]);
    a.domains[k] = domains[k];
  }
  a.nkeys = nkeys;
  a.row_valid = static_cast<const bool*>(row_valid);
  a.n = n;
  for (int c = 0; c < ncomp; ++c) {
    a.contrib[c] = reinterpret_cast<const void*>(contrib[c]);
    a.state[c] = reinterpret_cast<void*>(state[c]);
    a.dtype[c] = static_cast<int8_t>(dtypes[c]);
    a.op[c] = static_cast<int8_t>(ops[c]);
  }
  a.ncomp = ncomp;
  a.present = static_cast<bool*>(present);
  a.num_slots = num_slots;

  size_t table_bytes = (static_cast<size_t>(ncomp) * 8 + sizeof(int)) * num_slots;
  bool use_smem = table_bytes <= SMEM_LIMIT;
  size_t smem = use_smem ? table_bytes : 0;

  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t want = (n + THREADS - 1) / THREADS;
  int64_t cap = static_cast<int64_t>(sms) * 4;
  int blocks = static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
  slot_reduce_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a, use_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
