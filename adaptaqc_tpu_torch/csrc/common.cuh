// Shared device helpers for the package's kernels: complex64 as float2
// and complex128 as double2 (PyTorch's interleaved layouts), warp and block reductions, and the
// asynchronous copies into shared memory (mbarrier bulk copies, cp.async)
// and the fp64 tensor-core product that the kernels share.
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

// An mbarrier of this CTA that completes a phase on `count` arrivals.
__device__ __forceinline__ void mbar_init_count(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// An arrival, with release semantics at cluster scope, on the mbarrier at
// bar's address in CTA `rank` of the cluster: what this CTA wrote before
// (ordered by a block barrier) is visible to that CTA once it has waited.
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          r)
      : "memory");
}

// Wait for the phase of parity `parity` of this CTA's mbarrier, acquiring
// at cluster scope what the arriving CTAs released.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// This thread's arrival on bar, expecting `bytes` more to complete.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// One thread: bulk-copy `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global memory into this CTA's shared memory, completing on
// bar (whose expected bytes the caller has set).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
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

// D += A B on the fp64 tensor cores, one warp: A 8 x 4 (thread: row
// lane / 4, column lane % 4), B 4 x 8 (row lane % 4, column lane / 4), D
// 8 x 8 (row lane / 4, columns 2 (lane % 4) + {0, 1}). mma.sync in fp64 is
// full IEEE double: the wide back-transform runs its complex128 products on
// this shape (at half the rate of dmma16 below), the streamed env chain on
// dmma16, each a complex product as four real ones.
__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// D += A B on the fp64 tensor cores at the full rate, one warp (m16n8k4:
// on an H100 m8n8k4 runs at 33.4 TFLOP/s, m16n8k4 and m16n8k16 at 66.5 and
// 67.0, tools/dmma_shapes.py): A 16 x 4 (thread: rows lane / 4 and lane /
// 4 + 8, column lane % 4), B 4 x 8 (row lane % 4, column lane / 4), D 16 x
// 8 (rows lane / 4 and lane / 4 + 8, columns 2 (lane % 4) + {0, 1}: d[0],
// d[1] the first row, d[2], d[3] the second).
__device__ __forceinline__ void dmma16(double (&d)[4], double a0, double a1,
                                       double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// cp.async of 16 (or 8) bytes that fills the destination with zeros
// instead of reading where `ok` is false (src is then not read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8_zfill(void* dst, const void* src,
                                                bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
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
