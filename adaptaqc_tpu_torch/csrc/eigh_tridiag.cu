// Hermitian eigensolver of the bond truncation: three kernels for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernels in ops/pallas_eigh.py:
//   tridiag_kernel        <- _tridiag_kernel       (pallas_eigh.py:56)
//   teig_kernel           <- _teig_kernel          (pallas_eigh.py:194)
//   backtransform_kernel  <- _backtransform_kernel (pallas_eigh.py:136)
// Input is the m x m Hermitian Gram matrix of one two-qubit apply, m = 2 chi
// <= 128, complex64 (float2).
//
// What bounds them on this card: all three are latency bound, not FLOP or
// byte bound. The work is O(m^3) = 2M complex MACs at m = 128, but the
// Householder loop and the eigenvector Gram-Schmidt are m sequential steps,
// each a few block-wide barriers, and the Sturm bisection is 30 x m
// dependent divisions per lane. The designs therefore keep everything on
// chip and spend no launches inside the loops:
//   tridiag: one block; the whole m x m work matrix (128 KB at m = 128)
//     lives in dynamic shared memory for the m-1 reflector steps; the
//     matrix-vector product is warp-per-row (conflict-free rows, shuffle
//     reductions) and the rank-2 update touches each element once.
//   teig: one block, one thread per eigenvalue for bisection, LU and the
//     two inverse-iteration solves (no cross-thread traffic at all); the
//     m x m iterate sits in shared memory (64 KB) for the CGS2 pass, the
//     LU factors in global scratch laid out lane-fastest (coalesced).
//   backtransform: one warp per output column, the column held in
//     registers (4 values a lane), reflectors read through L1/L2.
// The Sturm recurrence, the LU and the solves use round-to-nearest
// intrinsics so that no multiply-add is contracted into an FMA: they
// compute the same operations, in the same order, as the plain PyTorch
// version (ops/eigh_kernels.py).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using adaptaqc::block_sum;
using adaptaqc::warp_sum;

constexpr int kMaxM = 128;

// ------------------------------------------------------------- tridiag
__global__ void tridiag_kernel(const float2* __restrict__ h,
                               float2* __restrict__ vrows,
                               float2* __restrict__ tau_out,
                               float* __restrict__ d_out,
                               float* __restrict__ e_out, int m) {
  extern __shared__ float2 smem[];
  float2* A = smem;     // m * m, row-major
  float2* v = A + m * m;  // reflector v_k
  float2* u = v + m;      // u = A v, then w
  __shared__ float red[33];
  __shared__ float sc[6];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;

  for (int idx = tid; idx < m * m; idx += nt) {
    A[idx] = h[idx];
    vrows[idx] = make_float2(0.f, 0.f);
  }
  for (int i = tid; i < m; i += nt) {
    tau_out[i] = make_float2(0.f, 0.f);
    e_out[i] = 0.f;
  }
  __syncthreads();

  for (int k = 0; k < m - 1; ++k) {
    float part = 0.f;
    for (int j = k + 2 + tid; j < m; j += nt) {
      const float2 c = A[j * m + k];
      part += c.x * c.x + c.y * c.y;
    }
    const float xnorm2 = block_sum(part, red);
    if (tid == 0) {
      const float2 alpha = A[(k + 1) * m + k];
      const float nrm = sqrtf(alpha.x * alpha.x + alpha.y * alpha.y + xnorm2);
      const bool active = nrm > 0.f;
      const float inv = active ? 1.f / nrm : 0.f;
      const float ahr = alpha.x * inv, ahi = alpha.y * inv;
      const float bh = (ahr >= 0.f) ? -1.f : 1.f;
      const float beta = active ? bh * nrm : 0.f;
      const float tr = active ? 1.f - ahr * bh : 0.f;
      const float ti = active ? -ahi * bh : 0.f;
      const float dr = ahr - bh, di = ahi;
      const float sdn = active ? dr * dr + di * di : 1.f;
      sc[0] = inv; sc[1] = dr; sc[2] = di; sc[3] = sdn; sc[4] = tr; sc[5] = ti;
      tau_out[k] = make_float2(tr, ti);
      e_out[k] = beta;
    }
    __syncthreads();
    const float inv = sc[0], dr = sc[1], di = sc[2], sdn = sc[3];
    const float tr = sc[4], ti = sc[5];
    for (int j = tid; j < m; j += nt) {
      float2 vj = make_float2(0.f, 0.f);
      if (j == k + 1) {
        vj = make_float2(1.f, 0.f);
      } else if (j > k + 1) {
        const float2 c = A[j * m + k];
        vj = make_float2((c.x * dr + c.y * di) * inv / sdn,
                         (c.y * dr - c.x * di) * inv / sdn);
      }
      v[j] = vj;
      vrows[k * m + j] = vj;
    }
    __syncthreads();
    // u = A v (v is zero on indices <= k)
    for (int i = warp; i < m; i += nw) {
      float ur = 0.f, ui = 0.f;
      for (int j = k + 1 + lane; j < m; j += 32) {
        const float2 a = A[i * m + j], vj = v[j];
        ur += a.x * vj.x - a.y * vj.y;
        ui += a.x * vj.y + a.y * vj.x;
      }
      ur = warp_sum(ur);
      ui = warp_sum(ui);
      if (lane == 0) u[i] = make_float2(ur, ui);
    }
    __syncthreads();
    // s = v^H u
    float sr = 0.f, si = 0.f;
    for (int j = k + 1 + tid; j < m; j += nt) {
      const float2 vj = v[j], uj = u[j];
      sr += vj.x * uj.x + vj.y * uj.y;
      si += vj.x * uj.y - vj.y * uj.x;
    }
    const float s_r = block_sum(sr, red);
    const float s_i = block_sum(si, red);
    // w = tau (u - (conj(tau) s / 2) v), written over u
    const float t2r = (tr * s_r + ti * s_i) * 0.5f;
    const float t2i = (tr * s_i - ti * s_r) * 0.5f;
    for (int j = tid; j < m; j += nt) {
      const float2 uj = u[j], vj = v[j];
      const float pr = uj.x - (t2r * vj.x - t2i * vj.y);
      const float pi = uj.y - (t2r * vj.y + t2i * vj.x);
      u[j] = make_float2(tr * pr - ti * pi, tr * pi + ti * pr);
    }
    __syncthreads();
    // A <- A - v w^H - w v^H
    for (int i = warp; i < m; i += nw) {
      const float2 vi = v[i], wi = u[i];
      for (int j = lane; j < m; j += 32) {
        const float2 vj = v[j], wj = u[j];
        float2 a = A[i * m + j];
        a.x -= (vi.x * wj.x + vi.y * wj.y) + (wi.x * vj.x + wi.y * vj.y);
        a.y -= (vi.y * wj.x - vi.x * wj.y) + (wi.y * vj.x - wi.x * vj.y);
        A[i * m + j] = a;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < m; i += nt) d_out[i] = A[i * m + i].x;
}

// ---------------------------------------------------------------- teig
__device__ __forceinline__ float guard(float x, float pivmin) {
  return (fabsf(x) < pivmin) ? ((x >= 0.f) ? pivmin : -pivmin) : x;
}

__device__ __forceinline__ float rsqrt_rn(float x) {
  return __frcp_rn(__fsqrt_rn(x));
}

__global__ void teig_kernel(const float* __restrict__ d_in,
                            const float* __restrict__ e_in,
                            const float* __restrict__ b0,
                            float* __restrict__ w_out,
                            float* __restrict__ z_out,
                            float* __restrict__ scratch, int m) {
  extern __shared__ float fsm[];
  float* d = fsm;        // m
  float* e = d + m;      // m, e[m-1] = 0
  float* e2 = e + m;     // m, e * e
  float* w = e2 + m;     // m
  float* v = w + m;      // m, CGS work column
  float* ov = v + m;     // m, CGS overlaps
  float* bb = ov + m;    // m * m, bb[i * m + j], column j = lane j
  __shared__ float red[33];
  __shared__ float sc[4];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  float* du = scratch;
  float* u1 = du + m * m;
  float* u2 = u1 + m * m;
  float* mr = u2 + m * m;
  float* sw = mr + m * m;

  for (int i = tid; i < m; i += nt) {
    d[i] = d_in[i];
    const float ei = (i < m - 1) ? e_in[i] : 0.f;
    e[i] = ei;
    e2[i] = __fmul_rn(ei, ei);
  }
  for (int idx = tid; idx < m * m; idx += nt) bb[idx] = b0[idx];
  __syncthreads();
  if (tid == 0) {
    float lo0 = __int_as_float(0x7f800000), hi0 = -__int_as_float(0x7f800000);
    for (int i = 0; i < m; ++i) {
      const float el = (i > 0) ? e[i - 1] : 0.f;
      const float rad = __fadd_rn(fabsf(e[i]), fabsf(el));
      lo0 = fminf(lo0, __fsub_rn(d[i], rad));
      hi0 = fmaxf(hi0, __fadd_rn(d[i], rad));
    }
    const float scale = fmaxf(fmaxf(fabsf(lo0), fabsf(hi0)), 1e-30f);
    const float p = __fmul_rn(1.2e-7f, scale);
    sc[0] = lo0;
    sc[1] = hi0;
    sc[2] = scale;
    sc[3] = fmaxf(1e-35f, __fmul_rn(p, p));
  }
  __syncthreads();
  const float lo0 = sc[0], hi0 = sc[1], scale = sc[2], pivmin = sc[3];
  const int j = tid;

  // Sturm bisection: lane j converges onto the j-th largest eigenvalue
  if (j < m) {
    float lo = lo0, hi = hi0;
    const float target = (float)(m - 1 - j);
    for (int r = 0; r < 30; ++r) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      float q = __fsub_rn(d[0], mid);
      if (fabsf(q) < pivmin) q = -pivmin;
      int cnt = (q < 0.f) ? 1 : 0;
      for (int i = 1; i < m; ++i) {
        q = __fsub_rn(__fsub_rn(d[i], mid), __fdiv_rn(e2[i - 1], q));
        if (fabsf(q) < pivmin) q = -pivmin;
        cnt += (q < 0.f) ? 1 : 0;
      }
      if ((float)cnt > target) hi = mid; else lo = mid;
    }
    w[j] = __fmul_rn(0.5f, __fadd_rn(lo, hi));
  }
  __syncthreads();

  if (j < m) {
    // shift lam_j = min_{l<=j} (w_l - (j-l) eps): coincident shifts split
    const float eps = __fmul_rn(1.2e-7f, scale);
    float lam = __fadd_rn(hi0, scale);
    for (int l = 0; l <= j; ++l)
      lam = fminf(lam, __fsub_rn(w[l], __fmul_rn((float)(j - l), eps)));
    // partial-pivoted LU of (T - lam I), one factorisation per lane
    float a_i = __fsub_rn(d[0], lam), s1_i = e[0];
    for (int i = 0; i < m - 1; ++i) {
      const float a_next = __fsub_rn(d[i + 1], lam);
      const float s1_next = e[i + 1];
      const float r2 = e[i];
      const bool swap = fabsf(r2) > fabsf(a_i);
      const float top0 = guard(swap ? r2 : a_i, pivmin);
      const float top1 = swap ? a_next : s1_i;
      const float top2 = swap ? s1_next : 0.f;
      const float bot0 = swap ? a_i : r2;
      const float bot1 = swap ? s1_i : a_next;
      const float bot2 = swap ? 0.f : s1_next;
      const float mlt = __fdiv_rn(bot0, top0);
      du[i * m + j] = top0;
      u1[i * m + j] = top1;
      u2[i * m + j] = top2;
      mr[i * m + j] = mlt;
      sw[i * m + j] = swap ? 1.f : 0.f;
      a_i = __fsub_rn(bot1, __fmul_rn(mlt, top1));
      s1_i = __fsub_rn(bot2, __fmul_rn(mlt, top2));
    }
    du[(m - 1) * m + j] = guard(a_i, pivmin);
    // two rounds of inverse iteration on column j of bb
    for (int rep = 0; rep < 2; ++rep) {
      for (int i = 0; i < m - 1; ++i) {
        const float mlt = mr[i * m + j];
        const bool s = sw[i * m + j] > 0.5f;
        const float bi = bb[i * m + j], bi1 = bb[(i + 1) * m + j];
        const float bt = s ? bi1 : bi;
        const float bo = s ? bi : bi1;
        bb[i * m + j] = bt;
        bb[(i + 1) * m + j] = __fsub_rn(bo, __fmul_rn(mlt, bt));
      }
      const float xn = __fdiv_rn(bb[(m - 1) * m + j], du[(m - 1) * m + j]);
      bb[(m - 1) * m + j] = xn;
      bb[(m - 2) * m + j] = __fdiv_rn(
          __fsub_rn(bb[(m - 2) * m + j], __fmul_rn(u1[(m - 2) * m + j], xn)),
          du[(m - 2) * m + j]);
      for (int i = m - 3; i >= 0; --i) {
        const float t = __fsub_rn(
            __fsub_rn(bb[i * m + j], __fmul_rn(u1[i * m + j], bb[(i + 1) * m + j])),
            __fmul_rn(u2[i * m + j], bb[(i + 2) * m + j]));
        bb[i * m + j] = __fdiv_rn(t, du[i * m + j]);
      }
      // scale by the max-abs first: a nearly singular shift leaves
      // |x| ~ 1/pivmin^2, whose square overflows float32
      float amax = 0.f;
      for (int i = 0; i < m; ++i) amax = fmaxf(amax, fabsf(bb[i * m + j]));
      if (amax > 0.f)
        for (int i = 0; i < m; ++i) bb[i * m + j] = __fdiv_rn(bb[i * m + j], amax);
      float nrm2 = 0.f;
      for (int i = 0; i < m; ++i)
        nrm2 = __fadd_rn(nrm2, __fmul_rn(bb[i * m + j], bb[i * m + j]));
      const float s = rsqrt_rn(fmaxf(nrm2, 1e-30f));
      for (int i = 0; i < m; ++i) bb[i * m + j] = __fmul_rn(bb[i * m + j], s);
    }
  }
  __syncthreads();

  // CGS2 across columns (descending order keeps clusters contiguous)
  for (int jj = 1; jj < m; ++jj) {
    for (int i = tid; i < m; i += nt) v[i] = bb[i * m + jj];
    __syncthreads();
    for (int pass = 0; pass < 2; ++pass) {
      for (int c = tid; c < jj; c += nt) {
        float s = 0.f;
        for (int i = 0; i < m; ++i) s += bb[i * m + c] * v[i];
        ov[c] = s;
      }
      __syncthreads();
      for (int i = warp; i < m; i += nw) {
        float s = 0.f;
        for (int c = lane; c < jj; c += 32) s += bb[i * m + c] * ov[c];
        s = warp_sum(s);
        if (lane == 0) v[i] -= s;
      }
      __syncthreads();
    }
    float part = 0.f;
    for (int i = tid; i < m; i += nt) part += v[i] * v[i];
    const float nrm2 = block_sum(part, red);
    const float s = rsqrt_rn(fmaxf(nrm2, 1e-30f));
    for (int i = tid; i < m; i += nt) bb[i * m + jj] = v[i] * s;
    __syncthreads();
  }
  for (int idx = tid; idx < m * m; idx += nt) z_out[idx] = bb[idx];
  for (int i = tid; i < m; i += nt) w_out[i] = w[i];
}

// ------------------------------------------------------- backtransform
// out[:, c] = H_0 H_1 ... H_{m-2} z[:, c]; one warp per column c.
__global__ void backtransform_kernel(const float2* __restrict__ vrows,
                                     const float2* __restrict__ tau,
                                     const float* __restrict__ z,
                                     float2* __restrict__ out, int m,
                                     int keep) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (c >= keep) return;  // uniform per warp
  float2 x[kMaxM / 32];
#pragma unroll
  for (int r = 0; r < kMaxM / 32; ++r) {
    const int i = lane + 32 * r;
    x[r] = make_float2(i < m ? z[i * m + c] : 0.f, 0.f);
  }
  for (int k = m - 2; k >= 0; --k) {
    const float2* vk = vrows + (size_t)k * m;
    float yr = 0.f, yi = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxM / 32; ++r) {
      const int i = lane + 32 * r;
      if (i < m) {
        const float2 vv = vk[i];
        yr += vv.x * x[r].x + vv.y * x[r].y;
        yi += vv.x * x[r].y - vv.y * x[r].x;
      }
    }
    yr = warp_sum(yr);
    yi = warp_sum(yi);
    const float2 t = tau[k];
#pragma unroll
    for (int r = 0; r < kMaxM / 32; ++r) {
      const int i = lane + 32 * r;
      if (i < m) {
        const float2 vv = vk[i];
        const float cvr = t.x * vv.x - t.y * vv.y;
        const float cvi = t.x * vv.y + t.y * vv.x;
        x[r].x -= cvr * yr - cvi * yi;
        x[r].y -= cvr * yi + cvi * yr;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxM / 32; ++r) {
    const int i = lane + 32 * r;
    if (i < m) out[i * keep + c] = x[r];
  }
}

}  // namespace

extern "C" {

int tridiag_launch(const void* h, void* vrows, void* tau, void* d, void* e,
                   int m, void* stream) {
  if (m < 2 || m > kMaxM) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(m * m + 2 * m) * sizeof(float2);
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      tridiag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  tridiag_kernel<<<1, 256, smem, (cudaStream_t)stream>>>(
      (const float2*)h, (float2*)vrows, (float2*)tau, (float*)d, (float*)e, m);
  return (int)cudaGetLastError();
}

int teig_launch(const void* d, const void* e, const void* b0, void* w, void* z,
                void* scratch, int m, void* stream) {
  if (m < 2 || m > kMaxM) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(m * m + 6 * m) * sizeof(float);
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      teig_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  teig_kernel<<<1, kMaxM, smem, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)e, (const float*)b0, (float*)w,
      (float*)z, (float*)scratch, m);
  return (int)cudaGetLastError();
}

int backtransform_launch(const void* vrows, const void* tau, const void* z,
                         void* out, int m, int keep, void* stream) {
  if (m < 2 || m > kMaxM || keep < 1 || keep > m)
    return (int)cudaErrorInvalidValue;
  const int warps = 4;
  const int blocks = (keep + warps - 1) / warps;
  backtransform_kernel<<<blocks, 32 * warps, 0, (cudaStream_t)stream>>>(
      (const float2*)vrows, (const float2*)tau, (const float*)z,
      (float2*)out, m, keep);
  return (int)cudaGetLastError();
}

const char* adaptaqc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
