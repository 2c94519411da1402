// window_emit (K16): the ranking and positional window functions, and
// the scatter of every window output column back to input order.
//
// Replaces presto_tpu/ops/window.py :341-400 (row_number, rank,
// dense_rank, ntile with its larger-buckets-first split, percent_rank,
// cume_dist; lag, lead with an optional constant default,
// first_value, last_value, nth_value over any frame) and :445-455 (the
// return to input order, which the reference does with a second sort
// because scatters serialize on the TPU). Here row i of the sorted
// relation writes its value straight to out[iota[i]]: the sorted iota
// is a permutation, so every output slot is written exactly once.
// Columns K14 / K15 computed in sorted order ride along as "copy"
// specs and are scattered the same way.
//
// What bounds it: bytes (per spec, the segment positions it reads and
// one output value and mask per row; the scattered writes are 8-byte
// or narrower and land in random lines). One launch writes up to
// MAX_EMIT columns; the wrapper splits more across launches.
// percent_rank and cume_dist divide in IEEE float64 (no fast math).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "window_frame.cuh"

#define MAX_EMIT 16

enum EmitKind {
  EK_ROW_NUMBER = 0, EK_RANK, EK_DENSE_RANK, EK_NTILE, EK_PERCENT_RANK, EK_CUME_DIST,
  EK_LAG, EK_FIRST, EK_LAST, EK_NTH, EK_COPY
};

struct EmitSpec {
  int32_t kind;
  int32_t elem;         // bytes per value of src / out
  int32_t has_default;  // lag / lead
  int32_t out_float;    // ranking output is float64
  int64_t offset;       // lag distance (negative: lead), ntile / nth N
  int64_t default_bits; // the default in the low `elem` bytes
  WinFrame frame;
  const void* src;
  const bool* src_mask;
  void* out;
  bool* out_mask;
};

struct EmitArgs {
  WinSeg seg;
  WinOrder order;
  const int64_t* iota;
  EmitSpec spec[MAX_EMIT];
  int32_t nspec;
};

__device__ __forceinline__ void copy_elem(const void* src, int64_t j, void* dst, int64_t d,
                                          int elem) {
  switch (elem) {
    case 1: static_cast<uint8_t*>(dst)[d] = static_cast<const uint8_t*>(src)[j]; break;
    case 2: static_cast<uint16_t*>(dst)[d] = static_cast<const uint16_t*>(src)[j]; break;
    case 4: static_cast<uint32_t*>(dst)[d] = static_cast<const uint32_t*>(src)[j]; break;
    default: static_cast<uint64_t*>(dst)[d] = static_cast<const uint64_t*>(src)[j]; break;
  }
}

__device__ __forceinline__ void write_bits(int64_t bits, void* dst, int64_t d, int elem) {
  switch (elem) {
    case 1: static_cast<uint8_t*>(dst)[d] = static_cast<uint8_t>(bits); break;
    case 2: static_cast<uint16_t*>(dst)[d] = static_cast<uint16_t>(bits); break;
    case 4: static_cast<uint32_t*>(dst)[d] = static_cast<uint32_t>(bits); break;
    default: static_cast<int64_t*>(dst)[d] = bits; break;
  }
}

__device__ __forceinline__ int64_t clamp_row(int64_t j, int64_t n) {
  return j < 0 ? 0 : (j > n - 1 ? n - 1 : j);
}

__global__ void emit_kernel(const EmitArgs a) {
  const WinSeg& s = a.seg;
  const int64_t n = s.n;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t dst = a.iota[i];
  const bool v = s.valid[i];
  const int64_t ps = s.pstart[i];
  const int64_t psize = s.pend[i] - ps + 1;
  for (int c = 0; c < a.nspec; ++c) {
    const EmitSpec& e = a.spec[c];
    if (e.kind <= EK_CUME_DIST) {
      int64_t r = 0;
      double f = 0.0;
      switch (e.kind) {
        case EK_ROW_NUMBER: r = i - ps + 1; break;
        case EK_RANK: r = s.peer_start[i] - ps + 1; break;
        case EK_DENSE_RANK: r = s.dense[i] - s.dense[ps] + 1; break;
        case EK_NTILE: {
          const int64_t nt = e.offset > 1 ? e.offset : 1;
          const int64_t q = psize / nt, rem = psize % nt;
          const int64_t idx = i - ps, cutoff = rem * (q + 1);
          r = idx < cutoff ? idx / (q + 1 > 1 ? q + 1 : 1) + 1
                           : rem + (idx - cutoff) / (q > 1 ? q : 1) + 1;
          break;
        }
        case EK_PERCENT_RANK:
          f = psize > 1 ? static_cast<double>(s.peer_start[i] - ps) /
                              static_cast<double>(psize - 1 > 1 ? psize - 1 : 1)
                        : 0.0;
          break;
        default:  // cume_dist
          f = static_cast<double>(s.peer_end[i] - ps + 1) /
              static_cast<double>(psize > 1 ? psize : 1);
          break;
      }
      if (e.out_float) {
        if (e.kind < EK_PERCENT_RANK) f = static_cast<double>(r);
        static_cast<double*>(e.out)[dst] = f;
      } else {
        static_cast<int64_t*>(e.out)[dst] =
            e.kind >= EK_PERCENT_RANK ? static_cast<int64_t>(f) : r;
      }
      e.out_mask[dst] = v;
      continue;
    }
    if (e.kind == EK_COPY) {
      copy_elem(e.src, i, e.out, dst, e.elem);
      e.out_mask[dst] = e.src_mask[i];
      continue;
    }
    int64_t idx;
    bool m;
    if (e.kind == EK_LAG) {
      const int64_t j = i - e.offset;
      idx = clamp_row(j, n);
      const bool in_part = j >= 0 && j <= n - 1 && s.pid[idx] == s.pid[i] && s.valid[idx];
      m = in_part && e.src_mask[idx];
      if (e.has_default && !in_part) {
        write_bits(e.default_bits, e.out, dst, e.elem);
        e.out_mask[dst] = v;
        continue;
      }
    } else {
      int64_t flo, fhi;
      win_frame(s, a.order, e.frame, i, &flo, &fhi);
      if (e.kind == EK_FIRST) idx = flo;
      else if (e.kind == EK_LAST) idx = fhi;
      else idx = flo + ((e.offset > 1 ? e.offset : 1) - 1);
      const bool nonempty = fhi >= flo && idx >= flo && idx <= fhi;
      idx = clamp_row(idx, n);
      m = e.src_mask[idx] && nonempty;
    }
    copy_elem(e.src, idx, e.out, dst, e.elem);
    e.out_mask[dst] = m && v;
  }
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_window_emit(const WinSeg* seg, const WinOrder* order, const void* iota,
                       const EmitSpec* specs, int32_t nspec, void* stream) {
  if (seg->n < 1 || nspec < 1 || nspec > MAX_EMIT) return static_cast<int>(cudaErrorInvalidValue);
  EmitArgs a;
  a.seg = *seg;
  a.order = *order;
  a.iota = static_cast<const int64_t*>(iota);
  for (int c = 0; c < nspec; ++c) {
    a.spec[c] = specs[c];
    if (a.spec[c].kind < EK_ROW_NUMBER || a.spec[c].kind > EK_COPY ||
        (a.spec[c].elem != 1 && a.spec[c].elem != 2 && a.spec[c].elem != 4 &&
         a.spec[c].elem != 8))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  a.nspec = nspec;
  const int threads = 256;
  emit_kernel<<<static_cast<unsigned>((seg->n + threads - 1) / threads), threads, 0,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
