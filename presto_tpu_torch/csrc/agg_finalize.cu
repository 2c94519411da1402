// agg_finalize (K29): one launch turns an aggregation's state into its
// output columns: every key column, aggregate column, mask and
// row_valid of the drain, written straight into the output capacity.
//
// Replaces presto_tpu/operators/aggregation.py:254
// `make_agg_finalize_kernel` (one jitted drain) and so
// presto_tpu/ops/hashagg.py:1005 `direct_finalize`, :1021
// `direct_intermediate` (the slot decode `_decode_slots` :967, each
// aggregate's `final`, `_pad_to_bucket` :990), :1038 `finalize` and
// :1055 `intermediate_batch`. The final functions are those of the
// reference's makers: sum / count / min / max (a value and a count
// mask), avg, the variance family, bool_and / bool_or, geometric_mean,
// skewness, kurtosis, entropy, checksum, and the two vector finals:
// approx_percentile's first bucket whose cumulative count reaches
// ceil(fraction * total), and approx_distinct's HyperLogLog estimate
// with the linear-counting correction.
//
// The columns come as a descriptor table in device memory, built by the
// host (ops/hashagg.py `_fin_agg_column`, ops/agg_kernels.py `FinColumn`),
// 16 int64 words per output column (see
// `Desc`). One grid covers them all: blockIdx.y picks the column; a
// scalar column is one thread per output row (grid-stride), a vector
// column one block per output row, its threads splitting the K counts or
// registers. Rows past `rows` (the direct path's pad up to its bucket)
// get zero data and a false mask, as the reference's pad does.
//
// Arithmetic follows the plain versions' torch expressions operation by
// operation, each rounded on its own: every product that feeds an
// addition is written __dmul_rn, which the compiler never contracts
// with the addition into one fma (each torch op rounds its result).
// Without fast math, `/` and `sqrt` are IEEE and `exp`, `log`, `pow`
// are the CUDA math library's, which torch's CUDA kernels call too. A
// float clamp keeps a NaN, as torch.clamp does.
//
// What bounds it: bytes for the scalar columns (each state array read
// once, each output written once), the launch for small drains (one
// launch in place of one torch op per key and aggregate), and for the
// vector finals the [rows, K] state read once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256

enum DataOp {
  OP_CONVERT = 0,  // s0 converted to the output dtype
  OP_AVG = 1,      // s0 / max(s1, 1)
  OP_VAR = 2,      // variance family: ia = pop, ib = sqrt
  OP_BOOL = 3,     // s0 > 0
  OP_GEOMEAN = 4,  // exp(s0 / max(s1, 1))
  OP_SKEW = 5,
  OP_KURT = 6,
  OP_ENTROPY = 7,  // f = ln 2
  OP_KEY = 8,      // direct slot decode: ia = domain, ib = stride
  OP_RV = 9,       // row_valid
  OP_PCTL = 10,    // vector: ia = K, f = fraction, aux = bucket values
  OP_HLL = 11,     // vector: ia = m, f = alpha * m * m
};

enum MaskKind {
  MK_RV = 0,       // rv(i)
  MK_CNT_GT = 1,   // rv(i) && aux_int64[i] > thr
  MK_F64_POS = 2,  // rv(i) && aux_double[i] > 0
  MK_PTR = 3,      // aux_bool[i] (a sort-path key's own mask)
  MK_OP = 4,       // computed by the data op
  MK_NONE = 5,     // no mask output
};

enum Dtype { DT_BOOL = 0, DT_I8 = 1, DT_I16 = 2, DT_I32 = 3, DT_I64 = 4, DT_F32 = 5, DT_F64 = 6 };

// One output column: 16 int64 words.
struct Desc {
  int64_t op, mask_kind;
  int64_t out, out_mask, out_dtype;
  int64_t s[5];
  int64_t s0_dtype, ia, ib, f_bits, aux, thr;
};
static_assert(sizeof(Desc) == 16 * sizeof(int64_t), "Desc is 16 words");

__device__ __forceinline__ bool is_float(int64_t dt) { return dt == DT_F32 || dt == DT_F64; }

__device__ __forceinline__ int64_t load_int(const void* p, int64_t dt, int64_t i) {
  switch (dt) {
    case DT_BOOL: return static_cast<const bool*>(p)[i] ? 1 : 0;
    case DT_I8: return static_cast<const int8_t*>(p)[i];
    case DT_I16: return static_cast<const int16_t*>(p)[i];
    case DT_I32: return static_cast<const int32_t*>(p)[i];
    default: return static_cast<const int64_t*>(p)[i];
  }
}

__device__ __forceinline__ double load_float(const void* p, int64_t dt, int64_t i) {
  return dt == DT_F32 ? static_cast<double>(static_cast<const float*>(p)[i])
                      : static_cast<const double*>(p)[i];
}

__device__ __forceinline__ void store_int(void* p, int64_t dt, int64_t i, int64_t v) {
  switch (dt) {
    case DT_BOOL: static_cast<bool*>(p)[i] = v != 0; break;
    case DT_I8: static_cast<int8_t*>(p)[i] = static_cast<int8_t>(v); break;
    case DT_I16: static_cast<int16_t*>(p)[i] = static_cast<int16_t>(v); break;
    case DT_I32: static_cast<int32_t*>(p)[i] = static_cast<int32_t>(v); break;
    case DT_F32: static_cast<float*>(p)[i] = static_cast<float>(v); break;
    case DT_F64: static_cast<double*>(p)[i] = static_cast<double>(v); break;
    default: static_cast<int64_t*>(p)[i] = v; break;
  }
}

__device__ __forceinline__ void store_float(void* p, int64_t dt, int64_t i, double v) {
  switch (dt) {
    case DT_BOOL: static_cast<bool*>(p)[i] = v != 0.0; break;
    case DT_I8: static_cast<int8_t*>(p)[i] = static_cast<int8_t>(v); break;
    case DT_I16: static_cast<int16_t*>(p)[i] = static_cast<int16_t>(v); break;
    case DT_I32: static_cast<int32_t*>(p)[i] = static_cast<int32_t>(v); break;
    case DT_I64: static_cast<int64_t*>(p)[i] = static_cast<int64_t>(v); break;
    case DT_F32: static_cast<float*>(p)[i] = static_cast<float>(v); break;
    default: static_cast<double*>(p)[i] = v; break;
  }
}

__device__ __forceinline__ void store_zero(void* p, int64_t dt, int64_t i) { store_int(p, dt, i, 0); }

// torch.clamp(x, min=lo) on a float: a NaN stays NaN
__device__ __forceinline__ double clamp_min(double x, double lo) { return x < lo ? lo : x; }

__device__ __forceinline__ const double* dptr(int64_t p) { return reinterpret_cast<const double*>(p); }
__device__ __forceinline__ const int64_t* iptr(int64_t p) { return reinterpret_cast<const int64_t*>(p); }

// The scalar data ops at state row i (i < rows).
__device__ void scalar_value(const Desc& d, int64_t i) {
  void* out = reinterpret_cast<void*>(d.out);
  switch (d.op) {
    case OP_CONVERT: {
      const void* s0 = reinterpret_cast<const void*>(d.s[0]);
      if (is_float(d.s0_dtype)) {
        store_float(out, d.out_dtype, i, load_float(s0, d.s0_dtype, i));
      } else {
        store_int(out, d.out_dtype, i, load_int(s0, d.s0_dtype, i));
      }
      break;
    }
    case OP_AVG: {
      const int64_t c = iptr(d.s[1])[i];
      store_float(out, d.out_dtype, i, dptr(d.s[0])[i] / static_cast<double>(c > 1 ? c : 1));
      break;
    }
    case OP_GEOMEAN: {
      const int64_t c = iptr(d.s[1])[i];
      store_float(out, d.out_dtype, i, exp(dptr(d.s[0])[i] / static_cast<double>(c > 1 ? c : 1)));
      break;
    }
    case OP_BOOL:
      store_int(out, d.out_dtype, i, iptr(d.s[0])[i] > 0 ? 1 : 0);
      break;
    case OP_VAR: {
      const int64_t n = iptr(d.s[0])[i];
      const double s = dptr(d.s[1])[i], ss = dptr(d.s[2])[i];
      const double nf = static_cast<double>(n > 1 ? n : 1);
      const double m2 = ss - (s * s) / nf;
      const double denom = d.ia ? nf : clamp_min(nf - 1.0, 1.0);
      double v = clamp_min(m2, 0.0) / denom;
      if (d.ib) v = sqrt(v);
      store_float(out, d.out_dtype, i, v);
      break;
    }
    case OP_SKEW:
    case OP_KURT: {
      const int64_t ni = iptr(d.s[0])[i];
      const double s1 = dptr(d.s[1])[i], s2 = dptr(d.s[2])[i];
      const double s3 = dptr(d.s[3])[i], s4 = dptr(d.s[4])[i];
      const double n = static_cast<double>(ni > 1 ? ni : 1);
      const double m = s1 / n;
      const double m2 = s2 / n - __dmul_rn(m, m);
      double v;
      if (d.op == OP_SKEW) {
        const double m3 = s3 / n - 3.0 * m * s2 / n + __dmul_rn(2.0, m * m * m);
        v = m3 / pow(clamp_min(m2, 1e-300), 1.5);
      } else {
        const double m4 =
            s4 / n - 4.0 * m * s3 / n + 6.0 * m * m * s2 / n - __dmul_rn(3.0, pow(m, 4.0));
        const double g2 = m4 / clamp_min(m2 * m2, 1e-300) - 3.0;
        v = (n - 1.0) / clamp_min((n - 2.0) * (n - 3.0), 1.0) * (__dmul_rn(n + 1.0, g2) + 6.0);
      }
      store_float(out, d.out_dtype, i, v);
      break;
    }
    case OP_ENTROPY: {
      const double total = dptr(d.s[0])[i], sclogc = dptr(d.s[1])[i];
      const double t = clamp_min(total, 1e-300);
      const double ent = (log(t) - sclogc / t) / __longlong_as_double(d.f_bits);
      store_float(out, d.out_dtype, i, clamp_min(ent, 0.0));
      break;
    }
    default: break;
  }
}

__device__ __forceinline__ bool row_live(const bool* rv, int64_t i) {
  return rv == nullptr || rv[i];
}

__device__ void scalar_column(const Desc& d, int64_t i, int64_t rows, const bool* rv) {
  void* out = reinterpret_cast<void*>(d.out);
  bool* om = reinterpret_cast<bool*>(d.out_mask);
  if (i >= rows) {
    store_zero(out, d.out_dtype, i);
    if (om != nullptr) om[i] = false;
    return;
  }
  const bool live = row_live(rv, i);
  if (d.op == OP_RV) {
    static_cast<bool*>(out)[i] = live;
    return;
  }
  if (d.op == OP_KEY) {
    const int64_t dom = d.ia;
    const int64_t code = (i / d.ib) % (dom + 1);
    store_int(out, d.out_dtype, i, code);
    om[i] = code < dom && live;
    return;
  }
  scalar_value(d, i);
  if (om == nullptr) return;
  bool m;
  switch (d.mask_kind) {
    case MK_CNT_GT: m = live && iptr(d.aux)[i] > d.thr; break;
    case MK_F64_POS: m = live && dptr(d.aux)[i] > 0.0; break;
    case MK_PTR: m = reinterpret_cast<const bool*>(d.aux)[i]; break;
    default: m = live; break;
  }
  om[i] = m;
}

// Block-wide sums over THREADS threads (every thread gets the result).
template <typename T>
__device__ T block_sum(T v, T* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  T t = 0;
  for (int w = 0; w < THREADS / 32; ++w) t += sh[w];
  return t;
}

// approx_percentile at row g: the first bucket whose cumulative count
// reaches max(ceil(fraction * total), 1); bucket 0 when none does (an
// empty group, whose mask is false).
__device__ void pctl_row(const Desc& d, int64_t g, bool live, int64_t* sh_i, int* sh_idx) {
  const int K = static_cast<int>(d.ia);
  const int32_t* counts = reinterpret_cast<const int32_t*>(d.s[0]) + g * K;
  const int per = (K + THREADS - 1) / THREADS;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < K ? lo + per : K;
  int64_t mine = 0;
  for (int k = lo; k < hi; ++k) mine += counts[k];
  // inclusive scan of the per-thread sums over the block
  __syncthreads();
  sh_i[threadIdx.x] = mine;
  __syncthreads();
  for (int o = 1; o < THREADS; o <<= 1) {
    const int64_t add = threadIdx.x >= o ? sh_i[threadIdx.x - o] : 0;
    __syncthreads();
    sh_i[threadIdx.x] += add;
    __syncthreads();
  }
  const int64_t total = sh_i[THREADS - 1];
  const double fraction = __longlong_as_double(d.f_bits);
  double target = ceil(fraction * static_cast<double>(total));
  target = target < 1.0 ? 1.0 : target;
  if (threadIdx.x == 0) *sh_idx = K;
  __syncthreads();
  int64_t run = sh_i[threadIdx.x] - mine;
  for (int k = lo; k < hi; ++k) {
    run += counts[k];
    if (static_cast<double>(run) >= target) {
      atomicMin(sh_idx, k);
      break;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int idx = *sh_idx < K ? *sh_idx : 0;
    store_float(reinterpret_cast<void*>(d.out), d.out_dtype, g, dptr(d.aux)[idx]);
    reinterpret_cast<bool*>(d.out_mask)[g] = live && total > 0;
  }
}

// approx_distinct at row g: alpha m^2 / sum 2^-max(r, 0), or m log(m /
// zeros) when that is at most 2.5 m and a register is still <= 0,
// rounded half to even.
__device__ void hll_row(const Desc& d, int64_t g, bool live, double* sh_d, int64_t* sh_i) {
  const int m = static_cast<int>(d.ia);
  const int8_t* regs = reinterpret_cast<const int8_t*>(d.s[0]) + g * m;
  double sum = 0.0;
  int64_t zeros = 0;
  for (int k = threadIdx.x; k < m; k += THREADS) {
    const int r = regs[k];
    sum += exp2(-static_cast<double>(r > 0 ? r : 0));
    zeros += r <= 0 ? 1 : 0;
  }
  sum = block_sum(sum, sh_d);
  zeros = block_sum(zeros, sh_i);
  if (threadIdx.x == 0) {
    double est = __longlong_as_double(d.f_bits) / sum;
    const double md = static_cast<double>(m);
    const double zf = static_cast<double>(zeros);
    const double small = md * log(md / (zf < 1.0 ? 1.0 : zf));
    if (est <= 2.5 * md && zf > 0.0) est = small;
    store_int(reinterpret_cast<void*>(d.out), d.out_dtype, g, static_cast<int64_t>(rint(est)));
    if (d.out_mask != 0) reinterpret_cast<bool*>(d.out_mask)[g] = live;
  }
}

__global__ void __launch_bounds__(THREADS)
agg_finalize_kernel(const Desc* __restrict__ desc, int64_t rows, int64_t cap,
                    const bool* __restrict__ rv) {
  __shared__ int64_t sh_i[THREADS];
  __shared__ double sh_d[THREADS / 32];
  __shared__ int sh_idx;
  const Desc d = desc[blockIdx.y];
  if (d.op == OP_PCTL || d.op == OP_HLL) {
    for (int64_t g = blockIdx.x; g < cap; g += gridDim.x) {
      if (g >= rows) {
        if (threadIdx.x == 0) {
          store_zero(reinterpret_cast<void*>(d.out), d.out_dtype, g);
          if (d.out_mask != 0) reinterpret_cast<bool*>(d.out_mask)[g] = false;
        }
        continue;
      }
      const bool live = row_live(rv, g);
      if (d.op == OP_PCTL) {
        pctl_row(d, g, live, sh_i, &sh_idx);
      } else {
        hll_row(d, g, live, sh_d, sh_i);
      }
    }
    return;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < cap;
       i += stride)
    scalar_column(d, i, rows, rv);
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// desc: ncols descriptors (16 int64 each) in device memory; rows: state
// rows; cap >= rows: output rows; rv: bool[rows] or null (every row
// live).
int presto_agg_finalize(const void* desc, int32_t ncols, int64_t rows, int64_t cap,
                        const void* rv, void* stream) {
  if (ncols < 1 || ncols > 65535 || rows < 0 || cap < rows || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t want = (cap + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 1024 ? want : 1024);
  dim3 grid(blocks, ncols);
  agg_finalize_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Desc*>(desc), rows, cap, static_cast<const bool*>(rv));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
