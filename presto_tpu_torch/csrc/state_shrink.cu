// state_shrink (K28): one launch copies the live prefix of every array
// of a packed sort-path aggregation state (each key's data and mask,
// each state component, vector components as whole K-wide rows, and
// `valid`) into new allocations of `cap` rows.
//
// Replaces presto_tpu/operators/aggregation.py:82-94 `_shrink_state`,
// whose jitted slice `d[:cap]` returns new arrays: the full-capacity
// buffers are freed once the caller drops them. A torch slice is a view
// that would keep them alive until the merge (ROADMAP C10); this copy
// does not.
//
// What bounds it: bytes, each byte of the prefixes read once and written
// once. blockIdx.y picks the array; the blocks of a row of the grid
// stride over its 16-byte words (every allocation starts 256-byte
// aligned), the last few bytes of an odd-sized array one at a time.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_ARRAYS 96

struct Copies {
  const uint8_t* src[MAX_ARRAYS];
  uint8_t* dst[MAX_ARRAYS];
  int64_t bytes[MAX_ARRAYS];
};

__global__ void __launch_bounds__(THREADS) state_shrink_kernel(const Copies c) {
  const int a = blockIdx.y;
  const int64_t bytes = c.bytes[a];
  const int64_t words = bytes / 16;
  const uint4* src = reinterpret_cast<const uint4*>(c.src[a]);
  uint4* dst = reinterpret_cast<uint4*>(c.dst[a]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t i = first; i < words; i += stride) dst[i] = src[i];
  const int64_t tail = words * 16 + first;
  if (tail < bytes && first < 16) c.dst[a][tail] = c.src[a][tail];
}

extern "C" {

const char* presto_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// src/dst: host arrays of count device addresses (each 16-byte
// aligned); bytes: the prefix of each to copy.
int presto_state_shrink(const int64_t* src, const int64_t* dst, const int64_t* bytes,
                        int32_t count, void* stream) {
  if (count < 1 || count > MAX_ARRAYS) return static_cast<int>(cudaErrorInvalidValue);
  Copies c;
  int64_t most = 0;
  for (int a = 0; a < count; ++a) {
    if ((src[a] | dst[a]) % 16 != 0 || bytes[a] < 0) return static_cast<int>(cudaErrorInvalidValue);
    c.src[a] = reinterpret_cast<const uint8_t*>(src[a]);
    c.dst[a] = reinterpret_cast<uint8_t*>(dst[a]);
    c.bytes[a] = bytes[a];
    most = bytes[a] > most ? bytes[a] : most;
  }
  const int64_t want = (most / 16 + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 1 ? 1 : (want < 256 ? want : 256));
  dim3 grid(blocks, count);
  state_shrink_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
