// Shared device helpers for the package's kernels: complex64 as float2
// and complex128 as double2 (PyTorch's interleaved layouts), warp and block reductions, and the
// asynchronous copies into shared memory (mbarrier bulk copies, cp.async)
// that env_chain.cu and eigh_tridiag.cu share.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace adaptaqc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One thread: bulk-copy `bytes` (a multiple of 16) from global to this
// CTA's shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// One complex element (float2 or double2) by cp.async.
__device__ __forceinline__ void cp_async_elem(float2* dst, const float2* src) {
  cp_async8(dst, src);
}
__device__ __forceinline__ void cp_async_elem(double2* dst,
                                              const double2* src) {
  cp_async16(dst, src);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (float or double)
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of `v` over the whole block; every thread must call it and gets the
// result. `red` is shared scratch of at least 33 values.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T t = (lane < nw) ? red[lane] : T(0);
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
