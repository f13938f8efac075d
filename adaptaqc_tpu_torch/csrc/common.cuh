// Shared device helpers for the package's kernels: complex64 as float2
// (PyTorch's interleaved layout), warp and block reductions.
#pragma once

#include <cuda_runtime.h>

namespace adaptaqc {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of `v` over the whole block; every thread must call it and gets the
// result. `red` is shared scratch of at least 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = (lane < nw) ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

}  // namespace adaptaqc

#define ADAPTAQC_RETURN_IF_ERR(expr)        \
  do {                                      \
    cudaError_t err_ = (expr);              \
    if (err_ != cudaSuccess) return err_;   \
  } while (0)
