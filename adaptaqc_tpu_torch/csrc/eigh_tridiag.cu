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
//   teig: one block of 16 warps. What bounded its first port (one thread
//     per eigenvalue, 4 warps) was the CGS2: 127 columns one after another,
//     each two serial 128-long dots a thread and five block barriers, 0.89
//     of its cycles at m = 128 (clock64() stamps). Now:
//     - multisection: the 512/m threads of an eigenvalue lane (4 at
//       m = 128, 8 at m = 64) count at every point the next k rounds of
//       bisection can visit, so 30 rounds take 15 (10) dependent Sturm
//       sweeps, and the eigenvalues equal the plain version's bit for bit;
//     - inverse iteration: one thread per lane as before, now all in
//       shared memory (the first port's global LU scratch put a load's
//       latency into every step of the dependent solves): the forward
//       sweep recomputes the LU as it eliminates, only du, u1 and a swap
//       bit a step are kept for the backward solve, u2 is recomputed from
//       e, and both recurrences carry their last values in registers;
//     - blocked CGS2 (BCGS2): panels of 16 columns, copied to a buffer of
//       16-byte rows; two block passes W = Q^T P, P -= Q W against all
//       earlier columns on every warp (register-tiled: 2 columns x 4
//       panel columns, or a row x 4, a thread), then CGS2 inside the panel
//       on one warp with the panel in registers and shuffle reductions:
//       six block barriers a panel instead of five a column. The iterate
//       sits in shared memory with an odd row stride (m + 1), so walking a
//       row and walking a column are both conflict-free;
//     - every division goes through div_rn: a zero dividend (most of the
//       e of a sweep's Grams are exact zeros) gets its signed-zero
//       quotient without the division's slow path.
//     What bounds it now: the dependent Sturm and solve recurrences, issue-
//     bound on the division sequence (0.34 of its cycles in the bisection,
//     0.19 in the inverse iteration at m = 128), and the in-panel CGS2,
//     whose columns each wait on a few shuffle reductions.
//     Its eigenvectors round differently from the plain column-by-column
//     CGS2 (equal to TOL_VEC on separated spectra; inside a degenerate
//     cluster they may rotate, and its projector is what is fixed).
//   backtransform: one warp per output column, the column held in
//     registers (4 values a lane), reflectors read through L1/L2.
// The Sturm recurrence, the LU and the solves use round-to-nearest
// intrinsics so that no multiply-add is contracted into an FMA: they
// compute the same operations, in the same order, as the plain PyTorch
// version (ops/eigh_kernels.py).

#include <cuda_runtime.h>
#include <stdint.h>

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
constexpr int kTeigThreads = 512;  // 16 warps
constexpr int kPanel = 16;         // columns of one CGS2 panel
constexpr int kBisectRounds = 30;  // the plain version's float32 rounds
static_assert(kBisectRounds % 2 == 0, "quadrisection takes rounds in pairs");
static_assert(kTeigThreads >= 4 * kMaxM, "four threads an eigenvalue lane");

// teig's dynamic shared memory, in floats: d, e, e2, w and the iterate (m
// rows of m + 1), then from a 16-byte boundary the LU factors du, u1 and
// the swap bits (4 words a lane), whose space the CGS2 reuses for the panel
// projections W and the panel itself (m x kPanel each).
__host__ __device__ inline int teig_lu_offset(int m) {
  return (4 * m + m * (m + 1) + 3) & ~3;
}
__host__ __device__ inline int teig_smem_floats(int m) {
  const int lu = 2 * m * m + 4 * m, panel = 2 * m * kPanel;
  return teig_lu_offset(m) + (lu > panel ? lu : panel);
}

__device__ __forceinline__ float guard(float x, float pivmin) {
  return (fabsf(x) < pivmin) ? ((x >= 0.f) ? pivmin : -pivmin) : x;
}

__device__ __forceinline__ float rsqrt_rn(float x) {
  return __frcp_rn(__fsqrt_rn(x));
}

// a / b rounded to nearest, as __fdiv_rn, but a zero dividend never takes
// the division's slow special-case path: its quotient is the signed zero
// of IEEE division, selected without a branch. The bond Grams of a sweep
// are block-diagonal to a large degree (three quarters of the off-diagonal
// e of bench.py's sweep are exact zeros), and their zero divisions made
// the bisection 2.6x slower.
__device__ __forceinline__ float div_rn(float a, float b) {
  const float q = __fdiv_rn(a == 0.f ? 1.f : a, b);
  return a == 0.f
             ? __int_as_float((__float_as_int(a) ^ __float_as_int(b)) &
                              0x80000000)
             : q;
}

// Sturm count: the number of negative pivots of T - x I (guarded as the
// plain version guards them).
__device__ __forceinline__ int sturm_count(const float* d, const float* e2,
                                           int m, float x, float pivmin) {
  float q = __fsub_rn(d[0], x);
  if (fabsf(q) < pivmin) q = -pivmin;
  int cnt = (q < 0.f) ? 1 : 0;
  for (int i = 1; i < m; ++i) {
    q = __fsub_rn(__fsub_rn(d[i], x), div_rn(e2[i - 1], q));
    if (fabsf(q) < pivmin) q = -pivmin;
    cnt += (q < 0.f) ? 1 : 0;
  }
  return cnt;
}

__device__ __forceinline__ float mid_rn(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}

// The point that bisection from [lo, hi] visits at heap node h (h >= 1:
// each bit below the leading one, from the top, takes the upper half if
// set), computed by the same chain of midpoints.
__device__ __forceinline__ float tree_point(float lo, float hi, int h) {
  for (int bit = 30 - __clz(h); bit >= 0; --bit) {
    const float md = mid_rn(lo, hi);
    if ((h >> bit) & 1) lo = md; else hi = md;
  }
  return mid_rn(lo, hi);
}

__global__ void __launch_bounds__(kTeigThreads, 1)
    teig_kernel(const float* __restrict__ d_in, const float* __restrict__ e_in,
                const float* __restrict__ b0, float* __restrict__ w_out,
                float* __restrict__ z_out, int m) {
  extern __shared__ __align__(16) float fsm[];
  const int ld = m + 1;  // odd row stride: row and column walks both
                         // fall in distinct banks
  float* d = fsm;                // m
  float* e = d + m;              // m, e[m-1] = 0
  float* e2 = e + m;             // m, e * e
  float* w = e2 + m;             // m
  float* bb = w + m;             // (m, ld): bb[i * ld + j], column j = lane j
  float* du = fsm + teig_lu_offset(m);  // (m, m) LU pivots, lane-fastest
  float* u1 = du + m * m;        // (m, m) first superdiagonal of U
  uint32_t* swb = reinterpret_cast<uint32_t*>(u1 + m * m);  // (4, m) swaps
  float* W = du;                 // (m, kPanel) panel projections and
  float* pan = W + m * kPanel;   // (m, kPanel) the panel: both reuse the LU
                                 // space once the iteration is done
  __shared__ float sc[4];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < m; i += nt) {
    d[i] = d_in[i];
    const float ei = (i < m - 1) ? e_in[i] : 0.f;
    e[i] = ei;
    e2[i] = __fmul_rn(ei, ei);
  }
  for (int idx = tid; idx < m * m; idx += nt)
    bb[(idx / m) * ld + idx % m] = b0[idx];
  if (tid == 0) {
    float lo0 = __int_as_float(0x7f800000), hi0 = -__int_as_float(0x7f800000);
    for (int i = 0; i < m; ++i) {
      const float el = (i > 0) ? e_in[i - 1] : 0.f;
      const float ei = (i < m - 1) ? e_in[i] : 0.f;
      const float rad = __fadd_rn(fabsf(ei), fabsf(el));
      lo0 = fminf(lo0, __fsub_rn(d_in[i], rad));
      hi0 = fmaxf(hi0, __fadd_rn(d_in[i], rad));
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

  // Sturm multisection: the tl threads of an eigenvalue lane (tl = 2^k, as
  // many as the block holds, at most a warp) count at the 2^k - 1 points
  // that the next k rounds of bisection can visit (thread 0 of the lane
  // repeats the first), then every thread walks the k rounds. The
  // intervals, and so w, equal the plain version's bit for bit: each point
  // is the same chain of midpoints.
  {
    int tl = 32;
    while (tl * m > nt) tl >>= 1;
    const int k = 31 - __clz(tl);
    const int jl = tid / tl, sub = tid % tl;
    const int j = min(jl, m - 1);
    const int base = lane & ~(tl - 1);
    const float target = (float)(m - 1 - j);
    float lo = lo0, hi = hi0;
    for (int r = 0; r < kBisectRounds; r += k) {
      const int kk = min(k, kBisectRounds - r);
      const float x = (sub >= 1 && sub < (1 << kk)) ? tree_point(lo, hi, sub)
                                                    : mid_rn(lo, hi);
      const int cnt = sturm_count(d, e2, m, x, pivmin);
      int node = 1;
      for (int l = 0; l < kk; ++l) {
        const int cn = __shfl_sync(0xffffffffu, cnt, base + node);
        const float mid = mid_rn(lo, hi);
        if ((float)cn > target) {
          hi = mid;
          node = 2 * node;
        } else {
          lo = mid;
          node = 2 * node + 1;
        }
      }
    }
    if (sub == 0 && jl < m) w[j] = mid_rn(lo, hi);
  }
  __syncthreads();

  const int j = tid;
  if (j < m) {
    // shift lam_j = min_{l<=j} (w_l - (j-l) eps): coincident shifts split
    const float eps = __fmul_rn(1.2e-7f, scale);
    float lam = __fadd_rn(hi0, scale);
    for (int l = 0; l <= j; ++l)
      lam = fminf(lam, __fsub_rn(w[l], __fmul_rn((float)(j - l), eps)));
    // two rounds of inverse iteration on column j of bb. The forward sweep
    // runs the partial-pivoted LU of (T - lam I) and eliminates as it goes
    // (the LU is recomputed each round: only du, u1 and the swap bits are
    // kept, in shared memory, for the backward solve; u2 = swap ? e[i+1] :
    // 0 is recomputed); both recurrences carry their last values in
    // registers.
    for (int rep = 0; rep < 2; ++rep) {
      float a_i = __fsub_rn(d[0], lam), s1_i = e[0];
      float carry = bb[j];
      uint32_t bits = 0;
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
        const float mlt = div_rn(bot0, top0);
        du[i * m + j] = top0;
        u1[i * m + j] = top1;
        bits |= (swap ? 1u : 0u) << (i & 31);
        if ((i & 31) == 31 || i == m - 2) {
          swb[(i >> 5) * m + j] = bits;
          bits = 0;
        }
        a_i = __fsub_rn(bot1, __fmul_rn(mlt, top1));
        s1_i = __fsub_rn(bot2, __fmul_rn(mlt, top2));
        const float bi1 = bb[(i + 1) * ld + j];
        const float bt = swap ? bi1 : carry;
        const float bo = swap ? carry : bi1;
        bb[i * ld + j] = bt;
        carry = __fsub_rn(bo, __fmul_rn(mlt, bt));
      }
      du[(m - 1) * m + j] = guard(a_i, pivmin);
      float x2 = div_rn(carry, du[(m - 1) * m + j]);
      bb[(m - 1) * ld + j] = x2;
      float x1 = div_rn(
          __fsub_rn(bb[(m - 2) * ld + j], __fmul_rn(u1[(m - 2) * m + j], x2)),
          du[(m - 2) * m + j]);
      bb[(m - 2) * ld + j] = x1;
      for (int i = m - 3; i >= 0; --i) {
        const bool sw = (swb[(i >> 5) * m + j] >> (i & 31)) & 1u;
        const float u2 = sw ? e[i + 1] : 0.f;
        const float t = __fsub_rn(
            __fsub_rn(bb[i * ld + j], __fmul_rn(u1[i * m + j], x1)),
            __fmul_rn(u2, x2));
        const float xi = div_rn(t, du[i * m + j]);
        bb[i * ld + j] = xi;
        x2 = x1;
        x1 = xi;
      }
      // scale by the max-abs first: a nearly singular shift leaves
      // |x| ~ 1/pivmin^2, whose square overflows float32
      float amax = 0.f;
      for (int i = 0; i < m; ++i) amax = fmaxf(amax, fabsf(bb[i * ld + j]));
      if (amax > 0.f)
        for (int i = 0; i < m; ++i)
          bb[i * ld + j] = div_rn(bb[i * ld + j], amax);
      float nrm2 = 0.f;
      for (int i = 0; i < m; ++i)
        nrm2 = __fadd_rn(nrm2, __fmul_rn(bb[i * ld + j], bb[i * ld + j]));
      const float s = rsqrt_rn(fmaxf(nrm2, 1e-30f));
      for (int i = 0; i < m; ++i) bb[i * ld + j] = __fmul_rn(bb[i * ld + j], s);
    }
  }
  __syncthreads();

  // Blocked CGS2 across columns (descending order keeps clusters
  // contiguous), kPanel columns a panel: two block passes W = Q^T P,
  // P -= Q W against every earlier column on all 16 warps, then CGS2 inside
  // the panel on one warp, in registers, with shuffle reductions and no
  // block barrier. Column 0 keeps its iterate, as in the plain version.
  float4* pan4 = reinterpret_cast<float4*>(pan);
  const float4* W4 = reinterpret_cast<const float4*>(W);
  for (int c0 = 0; c0 < m; c0 += kPanel) {
    const int pw = min(kPanel, m - c0);
    // the panel, zero-padded to kPanel columns, 16-byte rows
    for (int idx = tid; idx < m * kPanel; idx += nt) {
      const int i = idx / kPanel, p = idx % kPanel;
      pan[idx] = (p < pw) ? bb[i * ld + c0 + p] : 0.f;
    }
    __syncthreads();
    for (int pass = 0; c0 > 0 && pass < 2; ++pass) {
      // W[c][:] = Q[:, c]^T P for two columns c a thread
      const int half = (c0 + 1) / 2;
      for (int idx = tid; idx < half * (kPanel / 4); idx += nt) {
        const int ca = idx % half, pg = idx / half;
        const int cb = min(ca + half, c0 - 1);
        float4 wa = make_float4(0.f, 0.f, 0.f, 0.f), wb = wa;
        for (int i = 0; i < m; ++i) {
          const float qa = bb[i * ld + ca], qb = bb[i * ld + cb];
          const float4 pv = pan4[i * (kPanel / 4) + pg];
          wa.x = fmaf(qa, pv.x, wa.x); wa.y = fmaf(qa, pv.y, wa.y);
          wa.z = fmaf(qa, pv.z, wa.z); wa.w = fmaf(qa, pv.w, wa.w);
          wb.x = fmaf(qb, pv.x, wb.x); wb.y = fmaf(qb, pv.y, wb.y);
          wb.z = fmaf(qb, pv.z, wb.z); wb.w = fmaf(qb, pv.w, wb.w);
        }
        reinterpret_cast<float4*>(W)[ca * (kPanel / 4) + pg] = wa;
        if (ca + half < c0)
          reinterpret_cast<float4*>(W)[cb * (kPanel / 4) + pg] = wb;
      }
      __syncthreads();
      // P -= Q W
      for (int idx = tid; idx < m * (kPanel / 4); idx += nt) {
        const int i = idx % m, pg = idx / m;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c = 0; c < c0; ++c) {
          const float qv = bb[i * ld + c];
          const float4 wv = W4[c * (kPanel / 4) + pg];
          acc.x = fmaf(qv, wv.x, acc.x); acc.y = fmaf(qv, wv.y, acc.y);
          acc.z = fmaf(qv, wv.z, acc.z); acc.w = fmaf(qv, wv.w, acc.w);
        }
        float4 pv = pan4[i * (kPanel / 4) + pg];
        pv.x -= acc.x; pv.y -= acc.y; pv.z -= acc.z; pv.w -= acc.w;
        pan4[i * (kPanel / 4) + pg] = pv;
      }
      __syncthreads();
    }
    if (warp == 0) {
      constexpr int kRows = kMaxM / 32;
      float r[kRows][kPanel];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
#pragma unroll
        for (int p = 0; p < kPanel; ++p) {
          const int i = lane + 32 * k;
          r[k][p] = (i < m) ? pan[i * kPanel + p] : 0.f;
        }
#pragma unroll
      for (int p = 0; p < kPanel; ++p) {
        if (p >= pw || c0 + p == 0) continue;
        for (int pass = 0; pass < 2; ++pass) {
          float dots[kPanel];
#pragma unroll
          for (int qq = 0; qq < p; ++qq) {
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < kRows; ++k) s = fmaf(r[k][qq], r[k][p], s);
            dots[qq] = warp_sum(s);
          }
#pragma unroll
          for (int qq = 0; qq < p; ++qq)
#pragma unroll
            for (int k = 0; k < kRows; ++k)
              r[k][p] = fmaf(-dots[qq], r[k][qq], r[k][p]);
        }
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kRows; ++k) s = fmaf(r[k][p], r[k][p], s);
        const float scl = rsqrt_rn(fmaxf(warp_sum(s), 1e-30f));
#pragma unroll
        for (int k = 0; k < kRows; ++k) r[k][p] *= scl;
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k)
#pragma unroll
        for (int p = 0; p < kPanel; ++p) {
          const int i = lane + 32 * k;
          if (i < m && p < pw) bb[i * ld + c0 + p] = r[k][p];
        }
    }
    __syncthreads();
  }
  for (int idx = tid; idx < m * m; idx += nt)
    z_out[idx] = bb[(idx / m) * ld + idx % m];
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
                int m, void* stream) {
  if (m < 2 || m > kMaxM) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)teig_smem_floats(m) * sizeof(float);
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      teig_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  teig_kernel<<<1, kTeigThreads, smem, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)e, (const float*)b0, (float*)w,
      (float*)z, m);
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
