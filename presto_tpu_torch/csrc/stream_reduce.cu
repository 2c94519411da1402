// stream_reduce (K8): the grouping of a batch whose rows already arrive
// sorted by the group keys (ascending, nulls last), with no sort, and
// the streaming aggregation's fold of the group carried over from the
// previous batch.
//
// Replaces presto_tpu/ops/hashagg.py `presorted_reduce` (:775-813, the
// agg_step kernel's presorted branch, operators/aggregation.py:210) and
// presto_tpu/operators/aggregation.py `_stream_step_jit` (:650-720,
// family agg_stream):
//   * a row starts a group when it is live and its keys differ from
//     those of the PREVIOUS LIVE row (two NULLs compare equal; the
//     first live row always starts one). Dead rows may sit anywhere
//     between live rows (a filter upstream, the padded tail) and belong
//     to no group: this is not K6's rule, where a dead row ends a group;
//   * packed group ids from a scan of those starts, every state
//     component reduced per group into out_cap slots, each group's
//     first row, the group count and the overflow flag;
//   * with a carry (the streaming operator): the carried one-group state
//     is folded into slot 0 when its keys equal the first group's
//     (`same`), else it is complete and flagged for emission on its own;
//     the batch's last group becomes the new carry, and the emitted
//     slots are [0, groups - 1). A batch with no live row passes the
//     carry through.
//
// Five launches on one stream, no host round trip:
//   1. sr_tiles: per 1024-row tile, a block max-scan of live row indices
//      gives every live row its previous live row inside the tile, so
//      its start flag; each tile keeps its first and last live row and
//      counts its starts. The tile's first live row waits for step 2.
//   2. sr_scan: one block carries the last live row across tiles (an
//      exclusive max-scan of the tiles' last live rows), decides each
//      tile's first live row against it, then scans the tile counts
//      into offsets and writes the group
//      count, the overflow flag and the end of the live rows.
//   3. sr_assign: per tile, a block scan of the start flags gives each
//      group its first row (segment.cuh).
//   4. sr_reduce: one warp per output slot over its group's rows with a
//      fixed shuffle tree (segment.cuh's deterministic warp reduction);
//      the warp of slot 0 decides `same` and folds the carry in.
//   5. sr_carry (with a carry only): one warp writes the new carry and
//      the carry's emission flag.
//
// What bounds it: bytes. Keys and row_valid are read once per row (the
// previous live row's keys once more, mostly from L1), every
// contribution once; out_cap slots per component, the first rows and
// the slot validity are written once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment.cuh"

#define TILE PRESTO_SEG_TILE
#define THREADS 256

struct StreamArgs {
  KeyGroups keys;
  const bool* valid;
  int64_t n;
  Comps comps;
  int64_t out_cap;
  // the carried group: one row of keys (same dtypes as `keys`), its
  // validity and one value per component; `carry` false without one
  bool carry;
  KeyGroups carry_keys;
  const bool* carry_valid;
  const void* carry_comp[PRESTO_MAX_COMPS];
};

// Where the new carry goes (carry mode only).
struct CarryOut {
  KeyGroups keys;  // one row per key, written here
  void* comp[PRESTO_MAX_COMPS];
  bool* valid;
  bool* emit_carry;
};

__device__ __forceinline__ int key_size(int32_t dtype) {
  switch (dtype) {
    case KD_I8: return 1;
    case KD_I16: return 2;
    case KD_I32:
    case KD_F32: return 4;
    default: return 8;
  }
}

__device__ __forceinline__ void copy_bytes(const void* src, int64_t i, void* dst, int size) {
  switch (size) {
    case 1: *static_cast<uint8_t*>(dst) = static_cast<const uint8_t*>(src)[i]; break;
    case 2: *static_cast<uint16_t*>(dst) = static_cast<const uint16_t*>(src)[i]; break;
    case 4: *static_cast<uint32_t*>(dst) = static_cast<const uint32_t*>(src)[i]; break;
    default: *static_cast<uint64_t*>(dst) = static_cast<const uint64_t*>(src)[i]; break;
  }
}

// The carried group's keys of one group equal row r's (the reference's
// `where(cm & pm, cd == pd, ~cm & ~pm)` per key).
__device__ __forceinline__ bool carry_group_equals(const KeyCols& c, const KeyCols& k, int64_t r) {
  for (int j = 0; j < k.nkeys; ++j) {
    const bool cm = c.mask[j][0], m = k.mask[j][r];
    if (cm != m) return false;
    if (!m) continue;
    bool eq;
    switch (k.dtype[j]) {
      case KD_I8: eq = static_cast<const int8_t*>(c.data[j])[0] ==
                       static_cast<const int8_t*>(k.data[j])[r]; break;
      case KD_I16: eq = static_cast<const int16_t*>(c.data[j])[0] ==
                        static_cast<const int16_t*>(k.data[j])[r]; break;
      case KD_I32: eq = static_cast<const int32_t*>(c.data[j])[0] ==
                        static_cast<const int32_t*>(k.data[j])[r]; break;
      case KD_F32: eq = static_cast<const float*>(c.data[j])[0] ==
                        static_cast<const float*>(k.data[j])[r]; break;
      case KD_F64: eq = static_cast<const double*>(c.data[j])[0] ==
                        static_cast<const double*>(k.data[j])[r]; break;
      default: eq = static_cast<const int64_t*>(c.data[j])[0] ==
                    static_cast<const int64_t*>(k.data[j])[r]; break;
    }
    if (!eq) return false;
  }
  return true;
}

__device__ __forceinline__ bool carry_equals(const KeyGroups& c, const KeyGroups& k, int64_t r) {
  for (int g = 0; g < k.ngroups; ++g)
    if (!carry_group_equals(presto_group(c, g), presto_group(k, g), r)) return false;
  return true;
}

// stats: [0] groups, [1] overflow, [2] last live row + 1, [3] live
// groups min(groups, out_cap), [4] same (K6's layout in [0, 4), so K30
// folds vector states over these segments)
__global__ void __launch_bounds__(TILE)
sr_tiles(const StreamArgs a, uint8_t* __restrict__ flags, int64_t* __restrict__ tile_counts,
         int64_t* __restrict__ tile_first, int64_t* __restrict__ tile_last) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x;
  const bool live = i < a.n && a.valid[i];
  int64_t last;
  const int64_t prev = block_exclusive_scan_op(live ? i : -1, -1, ScanMax(), &last);
  int b = 0;
  if (live && prev >= 0) b = presto_keys_differ(a.keys, i, prev) ? 1 : 0;
  if (i < a.n) flags[i] = static_cast<uint8_t>(b);
  const int count = __syncthreads_count(b);
  int64_t first;
  block_exclusive_scan_op(live ? i : INT64_MAX, INT64_MAX, ScanMin(), &first);
  if (threadIdx.x == 0) {
    tile_counts[blockIdx.x] = count;
    tile_first[blockIdx.x] = first;  // INT64_MAX: no live row
    tile_last[blockIdx.x] = last;    // -1: no live row
  }
}

__global__ void __launch_bounds__(TILE)
sr_scan(const StreamArgs a, uint8_t* __restrict__ flags, int64_t* __restrict__ tile_counts,
        const int64_t* __restrict__ tile_first, const int64_t* __restrict__ tile_last,
        int64_t ntiles, int64_t* __restrict__ stats) {
  const int64_t per = (ntiles + blockDim.x - 1) / blockDim.x;
  const int64_t lo = static_cast<int64_t>(threadIdx.x) * per;
  const int64_t hi = lo + per < ntiles ? lo + per : ntiles;
  int64_t m = -1;
  for (int64_t t = lo; t < hi; ++t) m = tile_last[t] > m ? tile_last[t] : m;
  int64_t last_live;
  int64_t running = block_exclusive_scan_op(m, -1, ScanMax(), &last_live);
  for (int64_t t = lo; t < hi; ++t) {
    const int64_t f = tile_first[t];
    if (f < a.n) {
      const int b = running < 0 || presto_keys_differ(a.keys, f, running) ? 1 : 0;
      flags[f] = static_cast<uint8_t>(b);
      tile_counts[t] += b;
      running = tile_last[t];
    }
  }
  __syncthreads();
  const int64_t total = presto_scan_tiles(tile_counts, ntiles);
  if (threadIdx.x == 0) {
    stats[0] = total;
    stats[1] = total > a.out_cap ? 1 : 0;
    stats[2] = last_live + 1;
    stats[3] = total < a.out_cap ? total : a.out_cap;
    stats[4] = 0;
  }
}

__global__ void __launch_bounds__(TILE)
sr_assign(const StreamArgs a, const uint8_t* __restrict__ flags,
          const int64_t* __restrict__ tile_offsets, int64_t* __restrict__ starts) {
  presto_assign_starts(flags, a.n, a.out_cap, tile_offsets, starts);
}

__global__ void __launch_bounds__(THREADS)
sr_reduce(const StreamArgs a, const int64_t* __restrict__ starts, int64_t* stats,
          int64_t* __restrict__ first_row, bool* __restrict__ slot_valid) {
  const int64_t groups = stats[0];
  const int64_t live_end = stats[2];
  // emitted slots: every group, or with a carry all but the last
  const int64_t emitted = a.carry ? groups - 1 : groups;
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x / 32);
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
       g < a.out_cap; g += warps) {
    const bool live = g < groups;
    int64_t start = 0, end = 0;
    if (live) {
      start = starts[g];
      end = g + 1 < groups ? starts[g + 1] : live_end;
    }
    bool same = false;
    if (g == 0 && a.carry && live && a.carry_valid[0])
      same = carry_equals(a.carry_keys, a.keys, start);
    presto_reduce_slot(a.comps, a.valid, g, start, end, live, lane,
                       same ? a.carry_comp : nullptr);
    if (lane == 0) {
      first_row[g] = live ? start : a.n - 1;
      slot_valid[g] = g < emitted;
      if (g == 0) stats[4] = same ? 1 : 0;
    }
  }
}

__global__ void sr_carry(const StreamArgs a, const CarryOut o, const int64_t* __restrict__ stats,
                         const int64_t* __restrict__ first_row) {
  const int64_t groups = stats[0];
  const bool has_groups = groups > 0;
  const int lane = threadIdx.x;
  int64_t last = groups - 1 < a.out_cap - 1 ? groups - 1 : a.out_cap - 1;
  if (last < 0) last = 0;
  const int64_t row = first_row[last];
  for (int c = lane; c < a.comps.ncomp; c += 32) {
    const int size = presto_comp_size(a.comps.dtype[c]);
    if (has_groups) copy_bytes(a.comps.out[c], last, o.comp[c], size);
    else copy_bytes(a.carry_comp[c], 0, o.comp[c], size);
  }
  for (int g = 0; g < a.keys.ngroups; ++g) {
    const KeyCols& k = presto_group(a.keys, g);
    const KeyCols& c = presto_group(a.carry_keys, g);
    const KeyCols& ok = presto_group(o.keys, g);
    for (int j = lane; j < k.nkeys; j += 32) {
      const int size = key_size(k.dtype[j]);
      void* out_data = const_cast<void*>(ok.data[j]);
      bool* out_mask = const_cast<bool*>(ok.mask[j]);
      if (has_groups) {
        copy_bytes(k.data[j], row, out_data, size);
        *out_mask = k.mask[j][row];
      } else {
        copy_bytes(c.data[j], 0, out_data, size);
        *out_mask = c.mask[j][0];
      }
    }
  }
  if (lane == 0) {
    const bool carry_valid = a.carry_valid[0];
    *o.valid = has_groups ? true : carry_valid;
    *o.emit_carry = carry_valid && has_groups && stats[4] == 0;
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_stream_tile() { return TILE; }

// Keys (flat, as presto_fill_key_groups takes them, compared over their
// groups in turn) and valid[n] in key order; ncomp
// contributions with their out[out_cap] slots, dtype and op codes.
// Writes first_row[out_cap], slot_valid[out_cap], starts[out_cap + 1]
// (each group's first row) and stats[5] = {groups, overflow, last live
// row + 1, live groups, same}. With carry != 0 also reads the
// carry (carry_key_data/mask: one row per key, carry_valid[1],
// carry_comp: one value per component) and writes the new carry
// (out_key_data/mask, laid out as the keys are; out_comp, out_valid)
// and emit_carry[1].
// Scratch: flags[n] bytes and tiles[3 * ceil(n / TILE)] int64s.
int presto_stream_reduce(const int64_t* key_data, const int64_t* key_mask,
                         const int32_t* key_dtypes, int32_t nkeys, const void* valid, int64_t n,
                         const int64_t* contrib, const int64_t* out, const int32_t* dtypes,
                         const int32_t* ops, int32_t ncomp, int64_t out_cap, int32_t carry,
                         const int64_t* carry_key_data, const int64_t* carry_key_mask,
                         const void* carry_valid, const int64_t* carry_comp,
                         const int64_t* out_key_data, const int64_t* out_key_mask,
                         const int64_t* out_comp, void* out_valid, void* emit_carry,
                         void* first_row, void* slot_valid, void* stats, void* flags,
                         void* tiles, void* starts, void* stream) {
  StreamArgs a;
  if (!presto_fill_key_groups(&a.keys, key_data, key_mask, key_dtypes, nkeys) ||
      !presto_fill_comps(&a.comps, contrib, out, dtypes, ops, ncomp) || n < 1 || out_cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  a.valid = static_cast<const bool*>(valid);
  a.n = n;
  a.out_cap = out_cap;
  a.carry = carry != 0;
  CarryOut o;
  if (a.carry) {
    if (!presto_fill_key_groups(&a.carry_keys, carry_key_data, carry_key_mask, key_dtypes,
                                nkeys) ||
        !presto_fill_key_groups(&o.keys, out_key_data, out_key_mask, key_dtypes, nkeys))
      return static_cast<int>(cudaErrorInvalidValue);
    a.carry_valid = static_cast<const bool*>(carry_valid);
    for (int c = 0; c < ncomp; ++c) {
      a.carry_comp[c] = reinterpret_cast<const void*>(carry_comp[c]);
      o.comp[c] = reinterpret_cast<void*>(out_comp[c]);
    }
    o.valid = static_cast<bool*>(out_valid);
    o.emit_carry = static_cast<bool*>(emit_carry);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* st = static_cast<int64_t*>(stats);
  const int64_t ntiles = (n + TILE - 1) / TILE;
  if (ntiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int64_t* counts = static_cast<int64_t*>(tiles);
  int64_t* firsts = counts + ntiles;
  int64_t* lasts = firsts + ntiles;
  uint8_t* fl = static_cast<uint8_t*>(flags);
  sr_tiles<<<static_cast<int>(ntiles), TILE, 0, s>>>(a, fl, counts, firsts, lasts);
  sr_scan<<<1, TILE, 0, s>>>(a, fl, counts, firsts, lasts, ntiles, st);
  sr_assign<<<static_cast<int>(ntiles), TILE, 0, s>>>(a, fl, counts,
                                                       static_cast<int64_t*>(starts));
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t warps_per_block = THREADS / 32;
  int64_t want = (out_cap + warps_per_block - 1) / warps_per_block;
  int64_t cap = static_cast<int64_t>(sms) * 16;
  int blocks = static_cast<int>(want < cap ? want : cap);
  sr_reduce<<<blocks, THREADS, 0, s>>>(a, static_cast<const int64_t*>(starts), st,
                                       static_cast<int64_t*>(first_row),
                                       static_cast<bool*>(slot_valid));
  if (a.carry)
    sr_carry<<<1, 32, 0, s>>>(a, o, st, static_cast<const int64_t*>(first_row));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
