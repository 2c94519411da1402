// lookback.cuh: the single-pass chained scan with a decoupled look-back
// (Merrill and Garland, 2016), shared by K27 (limit_rank.cu), K33
// (distinct_set.cu) and K9's count pass (join_expand.cu).
//
// A block takes its tile number from an atomic ticket counter, so a
// tile only waits on tiles that already run; the block that takes the
// last ticket sets the counter back to 0 for the next call. Warp 0
// publishes the tile's aggregate, looks back over up to 32 earlier
// tiles at a time until it meets an inclusive prefix, and publishes its
// own inclusive prefix.
//
// Status words are 64-bit: a 30-bit epoch, a 2-bit flag (aggregate /
// inclusive prefix) and a 32-bit count. The host hands every call a new
// epoch, so one status array per stream serves every call with no
// clearing: a word of another epoch reads as "not published yet".
// Counts saturate at PRESTO_LB_MAX (K9's slot counts can pass 2^32;
// K27's and K33's rows stay under 2^31).

#pragma once

#include <stdint.h>

#define PRESTO_LB_AGGREGATE 1ULL
#define PRESTO_LB_INCLUSIVE 2ULL
#define PRESTO_LB_MAX 0xffffffffULL

__device__ __forceinline__ unsigned long long presto_lb_word(uint32_t epoch,
                                                             unsigned long long flag,
                                                             uint32_t count) {
  return (static_cast<unsigned long long>(epoch) << 34) | (flag << 32) | count;
}

__device__ __forceinline__ uint32_t presto_lb_sat(unsigned long long x) {
  return static_cast<uint32_t>(x < PRESTO_LB_MAX ? x : PRESTO_LB_MAX);
}

// The block's tile number. Every thread of the block must call it.
__device__ __forceinline__ uint32_t presto_lb_ticket(uint32_t* ticket, uint32_t ntiles) {
  __shared__ uint32_t tile_id;
  if (threadIdx.x == 0) {
    const uint32_t t = atomicAdd(ticket, 1u);
    if (t == ntiles - 1) *ticket = 0;  // every ticket is taken
    tile_id = t;
  }
  __syncthreads();
  return tile_id;
}

// Warp 0 only: publish tile t's aggregate `total`, look back, publish
// the inclusive prefix; returns the (saturated) sum of tiles 0 .. t-1
// to every lane.
__device__ __forceinline__ uint32_t presto_lb_prefix(unsigned long long* status, uint32_t t,
                                                     uint32_t epoch, uint32_t total) {
  const int lane = threadIdx.x & 31;
  unsigned long long* mine = status + t;
  if (t == 0) {
    if (lane == 0)
      *reinterpret_cast<volatile unsigned long long*>(mine) =
          presto_lb_word(epoch, PRESTO_LB_INCLUSIVE, total);
    return 0;
  }
  if (lane == 0)
    *reinterpret_cast<volatile unsigned long long*>(mine) =
        presto_lb_word(epoch, PRESTO_LB_AGGREGATE, total);
  unsigned long long prefix = 0;
  int64_t k = static_cast<int64_t>(t) - 1;  // the window's newest tile
  for (;;) {
    const int64_t idx = k - lane;
    unsigned long long v;
    bool ready;
    do {
      v = idx >= 0 ? *reinterpret_cast<const volatile unsigned long long*>(status + idx)
                   : presto_lb_word(epoch, PRESTO_LB_INCLUSIVE, 0);
      ready = static_cast<uint32_t>(v >> 34) == epoch && ((v >> 32) & 3ULL) != 0;
    } while (!__all_sync(0xffffffffu, ready));
    const unsigned inc =
        __ballot_sync(0xffffffffu, ((v >> 32) & 3ULL) == PRESTO_LB_INCLUSIVE);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    unsigned long long c = lane <= stop ? static_cast<uint32_t>(v) : 0ULL;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    prefix = presto_lb_sat(prefix + c);
    if (inc) break;
    k -= 32;
  }
  if (lane == 0)
    *reinterpret_cast<volatile unsigned long long*>(mine) =
        presto_lb_word(epoch, PRESTO_LB_INCLUSIVE, presto_lb_sat(prefix + total));
  return static_cast<uint32_t>(prefix);
}

// Spin (lane 0 of the calling warp) until tile t's inclusive prefix of
// this epoch is published; returns it to every lane of the warp. Only
// for a block whose ticket came after tile t's, so tile t runs.
__device__ __forceinline__ uint32_t presto_lb_wait_inclusive(const unsigned long long* status,
                                                             uint32_t t, uint32_t epoch) {
  unsigned long long v = 0;
  if ((threadIdx.x & 31) == 0) {
    do {
      v = *reinterpret_cast<const volatile unsigned long long*>(status + t);
    } while (!(static_cast<uint32_t>(v >> 34) == epoch &&
               ((v >> 32) & 3ULL) == PRESTO_LB_INCLUSIVE));
  }
  return static_cast<uint32_t>(__shfl_sync(0xffffffffu, v, 0));
}
