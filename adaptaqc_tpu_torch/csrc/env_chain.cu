// Environment-chain kernel of the sweep probes, for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel _env_kernel
// (ops/pallas_env.py:46). Given the B-form site tensors of the bra R and the
// ket L, each (n, 2, chi, chi) complex64, it returns the 2x2 local overlap
// matrix C[i, j] = <R| (|i><j| at site q) |L>:
//   forward   e' = sum_p A_p^H e B_p        over sites 0 .. q-1
//   backward  f' = sum_p conj(A_p) f B_p^T  over sites n-1 .. q+1
//   combine   C[i, j] = sum conj(A_i[a,x]) e[a,b] B_j[b,y] f[x,y]  at q.
//
// What bounds it on this card: the two chains are sequences of dependent
// chi^3 complex products (16 chi^3 real FMAs per site; 4.2 M at chi = 64),
// so one chain cannot spread over the card without a grid-wide barrier per
// site. The site stack (6.6 MB at n = 50, chi = 64) is far larger than an
// SM's shared memory, which the TPU kernel instead kept resident in VMEM.
// The design: the two chains are independent, so block 0 walks the forward
// chain and block 1 the backward chain, concurrently on two SMs. Each block
// keeps only its environment, one product temporary, the accumulator and
// the current site's two tensors in shared memory (five chi x (chi+1)
// padded tiles, 166 KB at chi = 64; the padding keeps the strided column
// reads of B^T conflict-free) and streams the sites from global memory. The
// snapshots e_q and f_q go to global memory and a second, one-block launch
// combines them: blocks cannot hand state to each other as the TPU's
// sequential grid did. All arithmetic is fp32 FMA on the CUDA cores; no
// tensor-core (TF32) path is used.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using adaptaqc::block_sum;

constexpr int kThreads = 256;

__device__ __forceinline__ void load_tile(float2* dst, const float2* src,
                                          int chi, int ld) {
  for (int idx = threadIdx.x; idx < chi * chi; idx += blockDim.x) {
    const int r = idx / chi, c = idx - r * chi;
    dst[r * ld + c] = src[idx];
  }
}

__device__ __forceinline__ void set_boundary(float2* dst, int chi, int ld) {
  for (int idx = threadIdx.x; idx < chi * chi; idx += blockDim.x) {
    const int r = idx / chi, c = idx - r * chi;
    dst[r * ld + c] = make_float2((r == 0 && c == 0) ? 1.f : 0.f, 0.f);
  }
}

// block 0: forward chain over sites [0, q); block 1: backward over (q, n).
__global__ void env_chain_kernel(const float2* __restrict__ br,
                                 const float2* __restrict__ bl,
                                 float2* __restrict__ snaps, int n, int chi,
                                 int q) {
  extern __shared__ float2 sm[];
  const int ld = chi + 1;
  const int tile = chi * ld;
  float2* E = sm;
  float2* M = E + tile;
  float2* acc = M + tile;
  float2* As = acc + tile;
  float2* Bs = As + tile;
  const bool fwd = blockIdx.x == 0;
  const int cc = chi * chi;
  const size_t site = (size_t)2 * cc;

  set_boundary(E, chi, ld);
  const int count = fwd ? q : n - 1 - q;
  for (int step = 0; step < count; ++step) {
    const int i = fwd ? step : n - 1 - step;
    for (int idx = threadIdx.x; idx < cc; idx += blockDim.x) {
      const int r = idx / chi, c = idx - r * chi;
      acc[r * ld + c] = make_float2(0.f, 0.f);
    }
    for (int p = 0; p < 2; ++p) {
      load_tile(As, br + i * site + p * cc, chi, ld);
      load_tile(Bs, bl + i * site + p * cc, chi, ld);
      __syncthreads();
      // fwd: M[a,y] = sum_b E[a,b] B[b,y];  bwd: M[a,y] = sum_b F[a,b] B[y,b]
      for (int idx = threadIdx.x; idx < cc; idx += blockDim.x) {
        const int a = idx / chi, y = idx - a * chi;
        float mr = 0.f, mi = 0.f;
        for (int b = 0; b < chi; ++b) {
          const float2 ev = E[a * ld + b];
          const float2 bv = fwd ? Bs[b * ld + y] : Bs[y * ld + b];
          mr = fmaf(ev.x, bv.x, fmaf(-ev.y, bv.y, mr));
          mi = fmaf(ev.x, bv.y, fmaf(ev.y, bv.x, mi));
        }
        M[a * ld + y] = make_float2(mr, mi);
      }
      __syncthreads();
      // fwd: acc[x,y] += sum_a conj(A[a,x]) M[a,y]
      // bwd: acc[x,y] += sum_a conj(A[x,a]) M[a,y]
      for (int idx = threadIdx.x; idx < cc; idx += blockDim.x) {
        const int x = idx / chi, y = idx - x * chi;
        float2 s = acc[x * ld + y];
        for (int a = 0; a < chi; ++a) {
          const float2 av = fwd ? As[a * ld + x] : As[x * ld + a];
          const float2 mv = M[a * ld + y];
          s.x = fmaf(av.x, mv.x, fmaf(av.y, mv.y, s.x));
          s.y = fmaf(av.x, mv.y, fmaf(-av.y, mv.x, s.y));
        }
        acc[x * ld + y] = s;
      }
      __syncthreads();
    }
    float2* t = E;
    E = acc;
    acc = t;
  }
  float2* out = snaps + (fwd ? 0 : cc);
  for (int idx = threadIdx.x; idx < cc; idx += blockDim.x) {
    const int r = idx / chi, c = idx - r * chi;
    out[idx] = E[r * ld + c];
  }
}

// C[i,j] = sum_{a,x} conj(A_i[a,x]) H_j[a,x], H_j = (e B_j) f^T.
__global__ void env_combine_kernel(const float2* __restrict__ br,
                                   const float2* __restrict__ bl,
                                   const float2* __restrict__ snaps,
                                   float2* __restrict__ out, int chi, int q) {
  extern __shared__ float2 sm[];
  __shared__ float red[33];
  const int ld = chi + 1;
  const int tile = chi * ld;
  const int cc = chi * chi;
  float2* E = sm;
  float2* F = E + tile;
  float2* Bs = F + tile;
  float2* G = Bs + tile;
  float2* H = G + tile;
  const size_t site = (size_t)2 * cc;
  load_tile(E, snaps, chi, ld);
  load_tile(F, snaps + cc, chi, ld);
  for (int jj = 0; jj < 2; ++jj) {
    load_tile(Bs, bl + q * site + jj * cc, chi, ld);
    __syncthreads();
    for (int idx = threadIdx.x; idx < cc; idx += blockDim.x) {
      const int a = idx / chi, y = idx - a * chi;
      float gr = 0.f, gi = 0.f;
      for (int b = 0; b < chi; ++b) {
        const float2 ev = E[a * ld + b], bv = Bs[b * ld + y];
        gr = fmaf(ev.x, bv.x, fmaf(-ev.y, bv.y, gr));
        gi = fmaf(ev.x, bv.y, fmaf(ev.y, bv.x, gi));
      }
      G[a * ld + y] = make_float2(gr, gi);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < cc; idx += blockDim.x) {
      const int a = idx / chi, x = idx - a * chi;
      float hr = 0.f, hi = 0.f;
      for (int y = 0; y < chi; ++y) {
        const float2 gv = G[a * ld + y], fv = F[x * ld + y];
        hr = fmaf(gv.x, fv.x, fmaf(-gv.y, fv.y, hr));
        hi = fmaf(gv.x, fv.y, fmaf(gv.y, fv.x, hi));
      }
      H[a * ld + x] = make_float2(hr, hi);
    }
    __syncthreads();
    for (int ii = 0; ii < 2; ++ii) {
      const float2* A = br + q * site + ii * cc;
      float cr = 0.f, ci = 0.f;
      for (int idx = threadIdx.x; idx < cc; idx += blockDim.x) {
        const int a = idx / chi, x = idx - a * chi;
        const float2 av = A[idx], hv = H[a * ld + x];
        cr += av.x * hv.x + av.y * hv.y;
        ci += av.x * hv.y - av.y * hv.x;
      }
      cr = block_sum(cr, red);
      ci = block_sum(ci, red);
      if (threadIdx.x == 0) out[ii * 2 + jj] = make_float2(cr, ci);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int env_chain_launch(const void* br, const void* bl, void* snaps,
                                void* out, int n, int chi, int q,
                                void* stream) {
  if (chi < 1 || chi > 64 || n < 1 || q < 0 || q >= n)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)5 * chi * (chi + 1) * sizeof(float2);
  cudaStream_t s = (cudaStream_t)stream;
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      env_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem));
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      env_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem));
  env_chain_kernel<<<2, kThreads, smem, s>>>(
      (const float2*)br, (const float2*)bl, (float2*)snaps, n, chi, q);
  ADAPTAQC_RETURN_IF_ERR(cudaGetLastError());
  env_combine_kernel<<<1, kThreads, smem, s>>>(
      (const float2*)br, (const float2*)bl, (const float2*)snaps,
      (float2*)out, chi, q);
  return (int)cudaGetLastError();
}
