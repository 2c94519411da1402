// window_frame_sum (K14): framed count, sum and avg of a window's
// sorted relation.
//
// Replaces presto_tpu/ops/window.py `range_sum`, `range_sum_dd` and
// `float_range_sum` (:285-339) with the aggregate arithmetic of
// :402-443. A row contributes when it is live, its argument is not
// NULL (count(*) has none) and its FILTER is true. Each frame's value
// is a difference of inclusive prefixes at its ends:
//   * count, and integer sums in int64 that wrap as the reference's
//     cumsum difference does;
//   * float sums (and avg) as double-double prefixes (hi, lo) built
//     with the two-sum combine, so a huge early value does not erase a
//     later frame's low bits (a plain float64 prefix difference
//     would); NaN, +Inf and -Inf are left out of the finite prefix and
//     counted with int64 prefixes, and re-applied only to the frames
//     that hold them (NaN wins; +Inf and -Inf together give NaN).
// The frame of each row comes from window_frame.cuh (the RANGE offset
// bounds by a per-row binary search inside the partition).
//
// What bounds it: bytes. The prefixes are written once and read twice
// per row (the frame ends, mostly from L2 for short frames). Four
// launches: per-tile totals, one block scanning the tiles, per-tile
// block scans writing the prefixes with their tile carries, and the
// per-row frame differences. Built without fast math: the two-sum
// needs IEEE additions in program order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "segment.cuh"
#include "window_frame.cuh"

#define WIN_TILE 1024

enum { FN_COUNT = 0, FN_SUM_INT = 1, FN_SUM_FLOAT = 2, FN_AVG = 3 };
// prefix planes: int64 count, then the int sum (FN_SUM_INT) or the
// NaN / +Inf / -Inf counts, then the double-double hi and lo
enum { PL_CNT = 0, PL_ISUM = 1, PL_NAN = 1, PL_PINF = 2, PL_NINF = 3, PL_HI = 4, PL_LO = 5 };

struct SumArgs {
  WinSeg seg;
  WinOrder order;
  WinFrame frame;
  int32_t fn;
  int32_t vdtype;
  const void* vals;
  const bool* vmask;
  const bool* fdata;
  const bool* fmask;
  int64_t* pre;  // planes of (n + ntiles) int64 each
  int64_t ntiles;
  int32_t nint;  // int64 planes
  int32_t dd;    // double-double planes present
};

struct ScanWrap {
  __device__ __forceinline__ int64_t operator()(int64_t a, int64_t b) const {
    return static_cast<int64_t>(static_cast<uint64_t>(a) + static_cast<uint64_t>(b));
  }
};

struct DD {
  double hi, lo;
};

__device__ __forceinline__ DD dd_combine(DD l, DD r) {
  const double s = l.hi + r.hi;
  const double bp = s - l.hi;
  const double e = (l.hi - (s - bp)) + (r.hi - bp);
  return DD{s, e + l.lo + r.lo};
}

__device__ __forceinline__ int64_t* plane(const SumArgs& a, int p) {
  return a.pre + static_cast<int64_t>(p) * (a.seg.n + a.ntiles);
}
__device__ __forceinline__ double* dplane(const SumArgs& a, int p) {
  return reinterpret_cast<double*>(plane(a, p));
}

// Row i's contributions: the int64 planes and the finite float part.
__device__ __forceinline__ void row_contrib(const SumArgs& a, int64_t i, int64_t* iv, DD* x) {
  for (int p = 0; p < 4; ++p) iv[p] = 0;
  *x = DD{0.0, 0.0};
  if (i >= a.seg.n) return;
  bool w = a.seg.valid[i];
  if (a.vals != nullptr) w = w && a.vmask[i];
  if (a.fdata != nullptr) w = w && a.fdata[i] && a.fmask[i];
  if (!w) return;
  iv[PL_CNT] = 1;
  if (a.fn == FN_SUM_INT) {
    iv[PL_ISUM] = win_load_i(a.vals, a.vdtype, i);
  } else if (a.fn != FN_COUNT) {
    const double v = win_load_f(a.vals, a.vdtype, i);
    if (isfinite(v)) x->hi = v;
    else if (isnan(v)) iv[PL_NAN] = 1;
    else if (v > 0) iv[PL_PINF] = 1;
    else iv[PL_NINF] = 1;
  }
}

// Inclusive double-double scan over the block (blockDim.x == WIN_TILE).
__device__ __forceinline__ DD dd_block_inclusive(DD x) {
  __shared__ double sh_hi[WIN_TILE], sh_lo[WIN_TILE];
  const int t = threadIdx.x;
  __syncthreads();
  sh_hi[t] = x.hi;
  sh_lo[t] = x.lo;
  __syncthreads();
  for (int off = 1; off < WIN_TILE; off <<= 1) {
    DD prev{0.0, 0.0};
    const bool has = t >= off;
    if (has) prev = DD{sh_hi[t - off], sh_lo[t - off]};
    __syncthreads();
    if (has) {
      x = dd_combine(prev, x);
      sh_hi[t] = x.hi;
      sh_lo[t] = x.lo;
    }
    __syncthreads();
  }
  return x;
}

__global__ void __launch_bounds__(WIN_TILE) fs_tiles(const SumArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * WIN_TILE + threadIdx.x;
  int64_t iv[4];
  DD x;
  row_contrib(a, i, iv, &x);
  for (int p = 0; p < a.nint; ++p) {
    int64_t t;
    block_exclusive_scan_op(iv[p], 0, ScanWrap(), &t);
    if (threadIdx.x == 0) plane(a, p)[a.seg.n + blockIdx.x] = t;
  }
  if (a.dd) {
    const DD tot = dd_block_inclusive(x);
    if (threadIdx.x == WIN_TILE - 1) {
      dplane(a, PL_HI)[a.seg.n + blockIdx.x] = tot.hi;
      dplane(a, PL_LO)[a.seg.n + blockIdx.x] = tot.lo;
    }
  }
}

// One block: the tiles' exclusive offsets, in place.
__global__ void __launch_bounds__(WIN_TILE) fs_scan_tiles(const SumArgs a) {
  const int64_t nt = a.ntiles;
  const int64_t per = (nt + blockDim.x - 1) / blockDim.x;
  const int64_t lo = static_cast<int64_t>(threadIdx.x) * per;
  const int64_t hi = lo + per < nt ? lo + per : nt;
  for (int p = 0; p < a.nint; ++p) {
    int64_t* c = plane(a, p) + a.seg.n;
    int64_t s = 0;
    for (int64_t t = lo; t < hi; ++t) s = ScanWrap()(s, c[t]);
    int64_t total;
    int64_t off = block_exclusive_scan_op(s, 0, ScanWrap(), &total);
    for (int64_t t = lo; t < hi; ++t) {
      const int64_t v = c[t];
      c[t] = off;
      off = ScanWrap()(off, v);
    }
  }
  if (a.dd) {
    double* ch = dplane(a, PL_HI) + a.seg.n;
    double* cl = dplane(a, PL_LO) + a.seg.n;
    DD s{0.0, 0.0};
    for (int64_t t = lo; t < hi; ++t) s = dd_combine(s, DD{ch[t], cl[t]});
    const DD incl = dd_block_inclusive(s);
    // exclusive: the inclusive value of the previous thread
    __shared__ double ex_hi[WIN_TILE], ex_lo[WIN_TILE];
    ex_hi[threadIdx.x] = incl.hi;
    ex_lo[threadIdx.x] = incl.lo;
    __syncthreads();
    DD off = threadIdx.x > 0 ? DD{ex_hi[threadIdx.x - 1], ex_lo[threadIdx.x - 1]} : DD{0.0, 0.0};
    for (int64_t t = lo; t < hi; ++t) {
      const DD v{ch[t], cl[t]};
      ch[t] = off.hi;
      cl[t] = off.lo;
      off = dd_combine(off, v);
    }
  }
}

__global__ void __launch_bounds__(WIN_TILE) fs_prefix(const SumArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * WIN_TILE + threadIdx.x;
  const bool in = i < a.seg.n;
  int64_t iv[4];
  DD x;
  row_contrib(a, i, iv, &x);
  for (int p = 0; p < a.nint; ++p) {
    int64_t t;
    const int64_t ex = block_exclusive_scan_op(iv[p], 0, ScanWrap(), &t);
    const int64_t base = plane(a, p)[a.seg.n + blockIdx.x];
    if (in) plane(a, p)[i] = ScanWrap()(ScanWrap()(base, ex), iv[p]);
  }
  if (a.dd) {
    const DD incl = dd_block_inclusive(x);
    const DD base{dplane(a, PL_HI)[a.seg.n + blockIdx.x], dplane(a, PL_LO)[a.seg.n + blockIdx.x]};
    const DD v = dd_combine(base, incl);
    if (in) {
      dplane(a, PL_HI)[i] = v.hi;
      dplane(a, PL_LO)[i] = v.lo;
    }
  }
}

__device__ __forceinline__ int64_t frame_diff(const int64_t* pre, int64_t flo, int64_t fhi,
                                              int64_t n) {
  if (fhi < flo) return 0;
  const int64_t h = pre[fhi < 0 ? 0 : (fhi > n - 1 ? n - 1 : fhi)];
  const int64_t l = flo > 0 ? pre[flo - 1 > n - 1 ? n - 1 : flo - 1] : 0;
  return static_cast<int64_t>(static_cast<uint64_t>(h) - static_cast<uint64_t>(l));
}

__global__ void fs_frames(const SumArgs a, void* __restrict__ out, bool* __restrict__ mask) {
  const int64_t n = a.seg.n;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t flo, fhi;
  win_frame(a.seg, a.order, a.frame, i, &flo, &fhi);
  const bool v = a.seg.valid[i];
  const int64_t runc = frame_diff(plane(a, PL_CNT), flo, fhi, n);
  if (a.fn == FN_COUNT) {
    static_cast<int64_t*>(out)[i] = runc;
    mask[i] = v;
    return;
  }
  mask[i] = runc > 0 && v;
  if (a.fn == FN_SUM_INT) {
    static_cast<int64_t*>(out)[i] = frame_diff(plane(a, PL_ISUM), flo, fhi, n);
    return;
  }
  double r = 0.0;
  if (fhi >= flo) {
    const double* H = dplane(a, PL_HI);
    const double* L = dplane(a, PL_LO);
    const int64_t at_hi = fhi < 0 ? 0 : (fhi > n - 1 ? n - 1 : fhi);
    const int64_t at_lo = flo - 1 < 0 ? 0 : (flo - 1 > n - 1 ? n - 1 : flo - 1);
    const double hl = flo > 0 ? H[at_lo] : 0.0;
    const double ll = flo > 0 ? L[at_lo] : 0.0;
    r = (H[at_hi] - hl) + (L[at_hi] - ll);
  }
  const int64_t nn = frame_diff(plane(a, PL_NAN), flo, fhi, n);
  const int64_t np = frame_diff(plane(a, PL_PINF), flo, fhi, n);
  const int64_t nm = frame_diff(plane(a, PL_NINF), flo, fhi, n);
  if (np > 0) r = INFINITY;
  if (nm > 0) r = -INFINITY;
  if (np > 0 && nm > 0) r = NAN;
  if (nn > 0) r = NAN;
  if (a.fn == FN_AVG) r = r / static_cast<double>(runc > 1 ? runc : 1);
  static_cast<double*>(out)[i] = r;
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int presto_window_tile() { return WIN_TILE; }

// pre: (fn >= FN_SUM_FLOAT ? 6 : 2) * (n + ntiles) int64 of scratch.
int presto_window_frame_sum(const WinSeg* seg, const WinOrder* order, const WinFrame* frame,
                            int32_t fn, const void* vals, const void* vmask, int32_t vdtype,
                            const void* fdata, const void* fmask, void* pre, void* out,
                            void* mask, void* stream) {
  if (seg->n < 1 || fn < FN_COUNT || fn > FN_AVG || (fn != FN_COUNT && vals == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  SumArgs a;
  a.seg = *seg;
  a.order = *order;
  a.frame = *frame;
  a.fn = fn;
  a.vdtype = vdtype;
  a.vals = vals;
  a.vmask = static_cast<const bool*>(vmask);
  a.fdata = static_cast<const bool*>(fdata);
  a.fmask = static_cast<const bool*>(fmask);
  a.pre = static_cast<int64_t*>(pre);
  a.ntiles = (seg->n + WIN_TILE - 1) / WIN_TILE;
  a.nint = fn == FN_COUNT ? 1 : (fn == FN_SUM_INT ? 2 : 4);
  a.dd = fn >= FN_SUM_FLOAT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned tiles = static_cast<unsigned>(a.ntiles);
  fs_tiles<<<tiles, WIN_TILE, 0, s>>>(a);
  fs_scan_tiles<<<1, WIN_TILE, 0, s>>>(a);
  fs_prefix<<<tiles, WIN_TILE, 0, s>>>(a);
  const int threads = 256;
  fs_frames<<<static_cast<unsigned>((seg->n + threads - 1) / threads), threads, 0, s>>>(
      a, out, static_cast<bool*>(mask));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
