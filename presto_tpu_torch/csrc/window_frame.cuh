// window_frame.cuh: the frame arithmetic shared by the window kernels
// K14 (window_frame_sum.cu), K15 (window_frame_minmax.cu) and K16
// (window_emit.cu), so the three agree on every frame.
//
// Rows arrive sorted by (partition keys, order keys), live rows first;
// K13 (window_segments.cu) has computed per row the partition start
// and last live row and the peer group's start and last live row. A
// frame (ROWS or RANGE, each bound UNBOUNDED, CURRENT ROW or an offset)
// turns into the inclusive row range [flo, fhi] of each row, as the
// reference's `frame_of` computes it (presto_tpu/ops/window.py:244-283):
//   * ROWS offsets are position arithmetic clipped to the partition;
//   * RANGE offsets search the partition for the first row whose
//     canonical order value is >= (start) or > (end) the row's own
//     plus the offset (`_part_searchsorted`, :110-127). The canonical
//     value is the first order key widened to int64 or float64,
//     negated when DESC, with NULL pinned to the end it sorts to; a row
//     whose own key is NULL takes its peer group instead.

#pragma once

#include <math.h>
#include <stdint.h>

#include "row_hash.cuh"

// K13's per-row segment positions (int64, sorted order).
struct WinSeg {
  const int64_t* pid;
  const int64_t* pstart;
  const int64_t* pend;
  const int64_t* peer_start;
  const int64_t* peer_end;
  const int64_t* dense;
  const bool* valid;
  int64_t n;
};

// The first ORDER BY key in sorted order (present == 0: no ORDER BY).
struct WinOrder {
  const void* data;
  const bool* mask;
  int32_t dtype;  // KeyDtype
  int32_t desc;
  int32_t nulls_first;
  int32_t present;
};

enum { FB_UNBOUNDED = 0, FB_CURRENT = 1, FB_OFFSET = 2 };

// One frame: ROWS (range == 0) or RANGE; each bound's kind and signed
// offset (negative = PRECEDING), as int64 and as double.
struct WinFrame {
  int32_t range;
  int32_t s_kind;
  int32_t e_kind;
  int32_t pad;
  int64_t s_off_i;
  int64_t e_off_i;
  double s_off_f;
  double e_off_f;
};

__device__ __forceinline__ int64_t win_load_i(const void* d, int dtype, int64_t j) {
  switch (dtype) {
    case KD_I8: return static_cast<const int8_t*>(d)[j];
    case KD_I16: return static_cast<const int16_t*>(d)[j];
    case KD_I32: return static_cast<const int32_t*>(d)[j];
    default: return static_cast<const int64_t*>(d)[j];
  }
}

__device__ __forceinline__ double win_load_f(const void* d, int dtype, int64_t j) {
  if (dtype == KD_F32) return static_cast<double>(static_cast<const float*>(d)[j]);
  if (dtype == KD_F64) return static_cast<const double*>(d)[j];
  return static_cast<double>(win_load_i(d, dtype, j));
}

__device__ __forceinline__ bool win_sv_float(const WinOrder& o) {
  return o.present && (o.dtype == KD_F32 || o.dtype == KD_F64);
}

__device__ __forceinline__ int64_t win_sv_i(const WinOrder& o, int64_t j) {
  if (!o.present) return 0;
  if (!o.mask[j]) return o.nulls_first ? INT64_MIN : INT64_MAX;
  const int64_t v = win_load_i(o.data, o.dtype, j);
  return o.desc ? static_cast<int64_t>(0ull - static_cast<uint64_t>(v)) : v;
}

__device__ __forceinline__ double win_sv_f(const WinOrder& o, int64_t j) {
  if (!o.mask[j]) return o.nulls_first ? -INFINITY : INFINITY;
  const double v = win_load_f(o.data, o.dtype, j);
  return o.desc ? -v : v;
}

// First j in [lo, hi) whose canonical value is >= (left) or > the
// target, the value of row i plus the offset.
__device__ __forceinline__ int64_t win_search(const WinOrder& o, int64_t i, int64_t off_i,
                                              double off_f, int64_t lo, int64_t hi, bool left,
                                              int64_t n) {
  if (win_sv_float(o)) {
    const double t = win_sv_f(o, i) + off_f;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      const double mv = win_sv_f(o, mid < n - 1 ? mid : n - 1);
      if (left ? (mv >= t) : (mv > t)) hi = mid; else lo = mid + 1;
    }
  } else {
    const int64_t t = static_cast<int64_t>(static_cast<uint64_t>(win_sv_i(o, i)) +
                                           static_cast<uint64_t>(off_i));
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      const int64_t mv = win_sv_i(o, mid < n - 1 ? mid : n - 1);
      if (left ? (mv >= t) : (mv > t)) hi = mid; else lo = mid + 1;
    }
  }
  return lo;
}

// The inclusive frame [*flo, *fhi] of row i (empty when *fhi < *flo).
__device__ __forceinline__ void win_frame(const WinSeg& s, const WinOrder& o, const WinFrame& f,
                                          int64_t i, int64_t* flo, int64_t* fhi) {
  const int64_t ps = s.pstart[i], pe = s.pend[i];
  if (!f.range) {
    if (f.s_kind == FB_UNBOUNDED) *flo = ps;
    else if (f.s_kind == FB_CURRENT) *flo = i;
    else *flo = i + f.s_off_i > ps ? i + f.s_off_i : ps;
    if (f.e_kind == FB_UNBOUNDED) *fhi = pe;
    else if (f.e_kind == FB_CURRENT) *fhi = i;
    else *fhi = i + f.e_off_i < pe ? i + f.e_off_i : pe;
    return;
  }
  const bool ok = !o.present || o.mask[i];
  if (f.s_kind == FB_UNBOUNDED) *flo = ps;
  else if (f.s_kind == FB_CURRENT || !ok) *flo = s.peer_start[i];
  else *flo = win_search(o, i, f.s_off_i, f.s_off_f, ps, pe + 1, true, s.n);
  if (f.e_kind == FB_UNBOUNDED) *fhi = pe;
  else if (f.e_kind == FB_CURRENT || !ok) *fhi = s.peer_end[i];
  else *fhi = win_search(o, i, f.e_off_i, f.e_off_f, ps, pe + 1, false, s.n) - 1;
}
