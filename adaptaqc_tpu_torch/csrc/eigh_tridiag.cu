// Hermitian eigensolver of the bond truncation: three kernels for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernels in ops/pallas_eigh.py:
//   tridiag_kernel        <- _tridiag_kernel       (pallas_eigh.py:56)
//   teig_kernel           <- _teig_kernel          (pallas_eigh.py:194)
//   backtransform_kernel  <- _backtransform_kernel (pallas_eigh.py:136)
// Input is the m x m Hermitian Gram matrix of one two-qubit apply, m = 2 chi
// <= 128, complex64 (float2), or a batch of P of them in one launch: the
// full-cost sweep applies every gate to its 3 or 7 probe states at once (the
// JAX package maps its kernels over the probes, which adds a grid dimension
// to each pallas_call). Every kernel indexes its matrix by a grid axis
// (tridiag and teig: one CTA a matrix; backtransform: its column panels on
// grid x, the matrix on grid y) and nothing is shared across the batch but
// teig's read-only right-hand side b0, so each matrix gets exactly the
// result of a launch of its own: its own active steps, its own dropped
// reflectors.
//
// What bounds them on this card: all three are latency bound, not FLOP or
// byte bound. The work is O(m^3) = 2M complex MACs at m = 128, but the
// Householder loop and the eigenvector Gram-Schmidt are m sequential steps,
// each a few block-wide barriers, and the Sturm bisection is 30 x m
// dependent divisions per lane. The designs therefore keep everything on
// chip and spend no launches inside the loops:
//   tridiag: one block of 1024 threads. Its first port (256 threads, the
//     m x m work matrix in shared memory) paid about 14 block barriers a
//     step, a thread-0 section for the reflector's scalars, a warp a row
//     with two shuffle trees for the matrix-vector product, and the
//     product and update over the whole matrix through shared memory.
//     Now the matrix lives in registers (16 entries a thread, 128 KB in
//     all at m = 128): the product and the rank-2 update touch only the
//     trailing block and read nothing from shared memory but broadcast
//     vectors; the scalars are formed by one group of four warps; a step
//     takes three block barriers. A step whose column is exactly zero
//     (the sweep's Grams have many: their right-bond padding leaves whole
//     rows and columns of H zero, and the residue of their rank-deficient
//     trailing blocks reaches zero) is an exact no-op: a run of them is
//     found by one scan of every column and costs no step at all.
//     Registers, not shared memory: with the matrix in shared memory the
//     product and update are bound by its bandwidth (the trailing block
//     read or written three times a step). What bounds it now: the rank-2
//     update, rounded as written (no FMA) so that A stays exactly
//     Hermitian, about half of its cycles at m = 128, and the latency of
//     a step's chain (three barriers and group 0's reduction of s).
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
//   backtransform: its first port was a warp a column walking the m-1
//     reflectors one after another, each a read of v_k through L1/L2 and
//     two shuffle trees. Now a CTA of 512 threads takes 8 columns; the
//     active reflectors (tau != 0) are copied once, transposed, into
//     shared memory by cp.async, grouped into compact-WY panels of 16 and
//     applied as small products in shared memory, three barriers a panel;
//     inactive reflectors (the identity) are dropped, so whole panels of
//     them go.
// The Sturm recurrence, the LU and the solves use round-to-nearest
// intrinsics so that no multiply-add is contracted into an FMA: they
// compute the same operations, in the same order, as the plain PyTorch
// version (ops/eigh_kernels.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using adaptaqc::cp_async8;
using adaptaqc::cp_async_commit;
using adaptaqc::cp_async_wait;
using adaptaqc::warp_sum;

constexpr int kMaxM = 128;

// ------------------------------------------------------------- complex
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// acc += a b
__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
}
// acc += conj(a) b
__device__ __forceinline__ void cfma_conj(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(-a.y, b.x, acc.y));
}

// ------------------------------------------------------------- tridiag
constexpr int kTriThreads = 1024;
constexpr int kTriGroups = kTriThreads / kMaxM;  // 8 row groups
// A thread holds kRows rows (tridiag_kernel's template parameter): 4, 8
// or 16, the fewest that cover m (kTriGroups * kRows >= m). The row loops
// are unrolled (the rows live in registers), and a step's time grows with
// their length even where the rows are idle: the same arithmetic at m = 64
// takes about two thirds of the time with 8 rows a thread as with 16, and
// at m = 32 with 4 rows about half (tools/eigh_variants.py).

// Below this, a column's sum of squares may have lost bits to gradual
// underflow (FLT_MIN / FLT_EPSILON): its norm is then taken scaled.
constexpr float kTinySquares = 0x1p-103f;

__device__ __forceinline__ void group0_sync() {  // the 128 threads of g = 0
  asm volatile("bar.sync 1, %0;\n" ::"n"(kMaxM) : "memory");
}

// Row r of the rows that row group g holds: the rows are dealt out
// cyclically, so that the trailing block stays spread over all eight
// groups to the last steps.
__device__ __forceinline__ int tri_row(int g, int r) {
  return g + kTriGroups * r;
}

// Sum of |A[j][c]|^2 over this thread's rows j > c (its column c), in one
// fixed order: the same function serves every place a column's squares
// are summed, so a column's partials are the same wherever they are taken.
template <int kRows>
__device__ __forceinline__ float column_squares(const float2 (&a)[kRows],
                                                int g, int c, int m) {
  float ss = 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = tri_row(g, r);
    if (j > c && j < m) ss = fmaf(a[r].x, a[r].x, fmaf(a[r].y, a[r].y, ss));
  }
  return ss;
}

// ||column k below the diagonal|| for a column whose sum of squares is
// tiny: scaled by its largest component, so that the reflector built from
// it stays unitary (the same value in every warp: xor-butterfly
// reductions).
__device__ __noinline__ float scaled_norm(const float2* col, int k, int m,
                                          int lane) {
  float amax = 0.f;
  for (int j = k + 1 + lane; j < m; j += 32)
    amax = fmaxf(amax, fmaxf(fabsf(col[j].x), fabsf(col[j].y)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float inv = 1.f / amax;
  float part = 0.f;
  for (int j = k + 1 + lane; j < m; j += 32) {
    const float cx = col[j].x * inv, cy = col[j].y * inv;
    part += cx * cx + cy * cy;
  }
  return amax * sqrtf(warp_sum(part));
}

// One CTA of 1024 threads; the matrix lives in registers: thread (g, li)
// holds column li of rows g, g+8, .., g+8(kRows-1). Shared memory carries
// only vectors. A step k:
//   top: ss = |alpha|^2 + |x|^2 of column k, summed from the eight row
//     groups' partials (every thread the same sum). Zero: the step and
//     every following step whose column is exactly zero are inactive
//     (tau = e = 0, v = e_{k+1}: the plain version's update subtracts
//     exact zeros there), found at once by a scan of every column's
//     squares;
//   1. thread (g, i) sums conj(A[j][i]) c_j over its rows j > k+1 (c =
//      column k, which its owners left in shared memory); the row group
//      of k+1 leaves row k+1; group 0 forms the reflector's scalars
//      (barrier);
//   2. group 0 forms u_i = A[i][k+1] + gam y_i, s = v^H u (four warps, a
//      named barrier) and w_i (barrier);
//   3. every thread updates its entries of the trailing block; the
//      owners of column k+1 leave it, and its partial squares, for the
//      next step (barrier).
// Only the trailing block is touched: rows and columns <= k are final.
template <int kRows>
__global__ void __launch_bounds__(kTriThreads, 1)
    tridiag_kernel(const float2* __restrict__ h, float2* __restrict__ vrows,
                   float2* __restrict__ tau_out, float* __restrict__ d_out,
                   float* __restrict__ e_out, int m, long long h_stride) {
  {  // this CTA's matrix of the batch; the outputs are contiguous in it
    const size_t b = blockIdx.x;
    h += b * (size_t)h_stride;
    vrows += b * (size_t)m * m;
    tau_out += b * m;
    d_out += b * m;
    e_out += b * m;
  }
  __shared__ float2 C[kMaxM];              // column k of A
  __shared__ float2 R1[kMaxM];             // row k+1 of A
  __shared__ float2 P[kTriGroups][kMaxM];  // the row groups' partial y
  __shared__ float2 V[kMaxM], W[kMaxM];    // v and w by row
  __shared__ float SS[kTriGroups][kMaxM];  // partial squares of a column
  __shared__ float2 S4[kMaxM / 32];        // group 0's warp shares of s
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int li = tid & (kMaxM - 1), g = tid / kMaxM;

  // h is exactly Hermitian (the caller symmetrises it: (h + h^H) / 2 is,
  // bit for bit), and so A stays from here on
  float2 a[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = tri_row(g, r);
    a[r] = (j < m && li < m) ? h[j * m + li] : make_float2(0.f, 0.f);
  }
  if (tid < m) vrows[(m - 1) * m + tid] = make_float2(0.f, 0.f);
  if (tid == 0) {
    tau_out[m - 1] = make_float2(0.f, 0.f);
    e_out[m - 1] = 0.f;
  }
  if (li == 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) C[tri_row(g, r)] = a[r];
    SS[g][0] = column_squares(a, g, 0, m);
  }
  __syncthreads();

  int k = 0;
  while (k < m - 1) {
    float ss = 0.f;
#pragma unroll
    for (int x = 0; x < kTriGroups; ++x) ss += SS[x][k];
    if (!(ss > 0.f)) {
      // inactive from k on: find the next column with a nonzero square
      __syncthreads();  // every thread has read SS[.][k]
      if (li < m) SS[g][li] = column_squares(a, g, li, m);
      __syncthreads();
      int next = m - 1;
      for (int base = k; base < m - 1; base += 32) {
        const int c = base + lane;
        float t = 0.f;
        if (c < m - 1)
#pragma unroll
          for (int x = 0; x < kTriGroups; ++x) t += SS[x][c];
        const unsigned mask = __ballot_sync(0xffffffffu, t > 0.f);
        if (mask) {
          next = base + __ffs(mask) - 1;
          break;
        }
      }
      for (int idx = tid; idx < (next - k) * m; idx += kTriThreads) {
        const int row = k + idx / m, col = idx % m;
        vrows[row * m + col] = make_float2(col == row + 1 ? 1.f : 0.f, 0.f);
      }
      for (int x = k + tid; x < next; x += kTriThreads) {
        tau_out[x] = make_float2(0.f, 0.f);
        e_out[x] = 0.f;
      }
      if (next < m - 1 && li == next) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) C[tri_row(g, r)] = a[r];
      }
      __syncthreads();
      k = next;
      continue;
    }
    const int k1 = k + 1;
    const bool own = li > k && li < m;

    // 1. y_i over this row group, and row k+1; group 0 forms the
    // reflector's scalars first
    float nrm = 0.f, tr = 0.f, ti = 0.f, bh = 0.f;
    float2 gam = make_float2(0.f, 0.f);
    if (g == 0) {
      const float2 alpha = C[k1];
      nrm = ss < kTinySquares ? scaled_norm(C, k, m, lane) : sqrtf(ss);
      const float inv = 1.f / nrm;
      const float ahr = alpha.x * inv, ahi = alpha.y * inv;
      bh = (ahr >= 0.f) ? -1.f : 1.f;
      tr = 1.f - ahr * bh;
      ti = -ahi * bh;
      const float dr = ahr - bh, di = ahi;
      const float gs = inv / (dr * dr + di * di);
      gam = make_float2(dr * gs, -di * gs);  // v_j = gam c_j
    }
    if (own) {
      float2 q = make_float2(0.f, 0.f);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = tri_row(g, r);
        if (j > k1 && j < m) cfma_conj(q, a[r], C[j]);  // uniform in a warp
      }
      P[g][li] = q;
      if (k1 % kTriGroups == g) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (tri_row(g, r) == k1) R1[li] = a[r];
      }
    }
    __syncthreads();

    // 2. the reflector, u = A v, s = v^H u, w = tau (u - (conj(tau) s/2) v)
    if (g == 0) {
      float2 share = make_float2(0.f, 0.f), vi = share, u = share;
      if (own) {
        vi = (li == k1) ? make_float2(1.f, 0.f) : cmul(gam, C[li]);
        float2 y = make_float2(0.f, 0.f);
#pragma unroll
        for (int x = 0; x < kTriGroups; ++x) {
          y.x += P[x][li].x;
          y.y += P[x][li].y;
        }
        const float2 gy = cmul(gam, y);
        u = make_float2(R1[li].x + gy.x, -R1[li].y + gy.y);  // A[i][k+1]
        cfma_conj(share, vi, u);
      }
      share.x = warp_sum(share.x);
      share.y = warp_sum(share.y);
      if (lane == 0) S4[warp] = share;
      group0_sync();
      float2 s = S4[0];
#pragma unroll
      for (int x = 1; x < kMaxM / 32; ++x) {
        s.x += S4[x].x;
        s.y += S4[x].y;
      }
      if (own) {
        const float t2r = (tr * s.x + ti * s.y) * 0.5f;
        const float t2i = (tr * s.y - ti * s.x) * 0.5f;
        const float pr = u.x - (t2r * vi.x - t2i * vi.y);
        const float pi = u.y - (t2r * vi.y + t2i * vi.x);
        V[li] = vi;
        W[li] = make_float2(tr * pr - ti * pi, tr * pi + ti * pr);
      }
      if (li < m) vrows[k * m + li] = (li <= k) ? make_float2(0.f, 0.f) : vi;
      if (li == k1) {
        tau_out[k] = make_float2(tr, ti);
        e_out[k] = bh * nrm;
      }
    }
    __syncthreads();

    // 3. A[j][i] -= v_j conj(w_i) + w_j conj(v_i) on the trailing block,
    // rounded as written (no contraction): the thread that holds A[i][j]
    // gets exactly the conjugate, so A stays exactly Hermitian
    if (own) {
      const float2 vb = V[li], wb = W[li];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = tri_row(g, r);
        if (j > k && j < m) {  // uniform in a warp
          const float2 va = V[j], wa = W[j];
          const float re = __fadd_rn(
              __fadd_rn(__fmul_rn(va.x, wb.x), __fmul_rn(va.y, wb.y)),
              __fadd_rn(__fmul_rn(wa.x, vb.x), __fmul_rn(wa.y, vb.y)));
          const float im = __fadd_rn(
              __fsub_rn(__fmul_rn(va.y, wb.x), __fmul_rn(va.x, wb.y)),
              __fsub_rn(__fmul_rn(wa.y, vb.x), __fmul_rn(wa.x, vb.y)));
          a[r] = make_float2(__fsub_rn(a[r].x, re), __fsub_rn(a[r].y, im));
        }
      }
      if (li == k1) {  // the next step's column
#pragma unroll
        for (int r = 0; r < kRows; ++r) C[tri_row(g, r)] = a[r];
        SS[g][k1] = column_squares(a, g, k1, m);
      }
    }
    __syncthreads();
    k = k1;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (tri_row(g, r) == li && li < m) d_out[li] = a[r].x;
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
                float* __restrict__ z_out, int m, long long d_stride,
                long long e_stride) {
  {  // this CTA's matrix of the batch (b0 is shared, read-only)
    const size_t b = blockIdx.x;
    d_in += b * (size_t)d_stride;
    e_in += b * (size_t)e_stride;
    w_out += b * m;
    z_out += b * (size_t)m * m;
  }
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
constexpr int kBtThreads = 512;
constexpr int kBtCols = 8;    // output columns of one CTA
constexpr int kBtPanel = 16;  // reflectors of one compact-WY panel
constexpr int kBtSplit = kBtThreads / (kBtPanel * kBtCols);  // 4 row phases
constexpr int kBtGSplit = kBtThreads / (kBtPanel * kBtPanel);  // 2 for G
constexpr int kBtMaxPanels = (kMaxM - 1 + kBtPanel - 1) / kBtPanel;
constexpr int kBtBlock = kBtPanel * kBtPanel;  // one panel's G or T
static_assert(kBtSplit * kBtPanel * kBtCols == kBtThreads, "Y tiling");
static_assert(kBtGSplit * kBtBlock == kBtThreads, "G tiling");

// The row stride of the transposed reflectors: odd, so that a warp walking
// a row or a column of them hits distinct banks.
__host__ __device__ inline int bt_ldv(int m) { return (m - 1) | 1; }
// backtransform's dynamic shared memory, in float2: the active reflectors
// transposed (m rows of bt_ldv), the CTA's columns of z (m x kBtCols),
// kBtGSplit partial V^H V blocks a panel (the first becomes T), the
// panel's kBtSplit partial V^H Z and its T V^H Z (kBtPanel x kBtCols).
__host__ __device__ inline int bt_smem_float2(int m) {
  return m * bt_ldv(m) + m * kBtCols + kBtGSplit * kBtMaxPanels * kBtBlock +
         (kBtSplit + 1) * kBtPanel * kBtCols;
}

// out[:, c0:c0+8] = H_0 H_1 ... H_{m-2} z[:, c0:c0+8], one CTA of 512
// threads for 8 columns of one matrix (8 CTAs a matrix at keep = 64). Reflectors with tau == 0
// are the identity and are dropped: the active ones (in order) are grouped
// into panels of 16, P = H_a ... H_b = I - V T V^H with the zlarft
// recurrence T[i][i] = tau_i, T[:i, i] = -tau_i T[:i, :i] (V[:, :i]^H v_i),
// and the panels are applied last first: Y = V^H Z, W = T Y, Z -= V W
// (three barriers a panel). Every T is built before the first panel is
// applied, a warp a panel. A dot over rows is split between the threads
// that take every kBtSplit-th (kBtGSplit-th) row.
__global__ void __launch_bounds__(kBtThreads)
    backtransform_kernel(const float2* __restrict__ vrows,
                         const float2* __restrict__ tau,
                         const float* __restrict__ z,
                         float2* __restrict__ out, int m, int keep,
                         long long v_stride, long long tau_stride,
                         long long z_stride) {
  {  // grid y: this CTA's matrix of the batch
    const size_t b = blockIdx.y;
    vrows += b * (size_t)v_stride;
    tau += b * (size_t)tau_stride;
    z += b * (size_t)z_stride;
    out += b * (size_t)m * keep;
  }
  extern __shared__ __align__(16) float2 bsm[];
  const int ldv = bt_ldv(m);
  float2* Vt = bsm;                   // Vt[r * ldv + s] = v_{act[s]}[r]
  float2* Z = Vt + m * ldv;           // (m, kBtCols)
  float2* G = Z + m * kBtCols;        // (kBtGSplit, kBtMaxPanels, kBtBlock)
  float2* Y = G + kBtGSplit * kBtMaxPanels * kBtBlock;  // (split, 16, 8)
  float2* Wp = Y + kBtSplit * kBtPanel * kBtCols;       // (16, 8)
  float2* T = G;                      // T of panel p over the first G
  __shared__ int act[kMaxM];
  __shared__ float2 tau_s[kMaxM];
  __shared__ int na_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kBtThreads / 32;
  const int c0 = blockIdx.x * kBtCols;
  const int cw = min(kBtCols, keep - c0);

  // the active reflectors, in order (a warp ballot a 32 of them)
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < m - 1; base += 32) {
      const int k = base + lane;
      const float2 t = (k < m - 1) ? tau[k] : make_float2(0.f, 0.f);
      const bool on = t.x != 0.f || t.y != 0.f;
      const unsigned mask = __ballot_sync(0xffffffffu, on);
      if (on) {
        const int pos = count + __popc(mask & ((1u << lane) - 1u));
        act[pos] = k;
        tau_s[pos] = t;
      }
      count += __popc(mask);
    }
    if (lane == 0) na_s = count;
  }
  for (int idx = tid; idx < m * kBtCols; idx += kBtThreads) {
    const int r = idx / kBtCols, c = idx % kBtCols;
    Z[idx] = make_float2(c < cw ? z[r * m + c0 + c] : 0.f, 0.f);
  }
  __syncthreads();
  const int na = na_s;
  // their lower trapezoids (v_k is zero above row k+1), transposed, by
  // cp.async, a warp a reflector; the zeros above are stored, not copied
  for (int sl = warp; sl < na; sl += kWarps) {
    const int k = act[sl];
    const float2* src = vrows + (size_t)k * m;
    for (int r = lane; r < m; r += 32) {
      if (r > k)
        cp_async8(Vt + r * ldv + sl, src + r);
      else
        Vt[r * ldv + sl] = make_float2(0.f, 0.f);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int npan = (na + kBtPanel - 1) / kBtPanel;
  // G = V^H V of every panel, strictly upper part: thread (h, i, j) sums
  // the rows r = h mod kBtGSplit
  {
    const int h = tid / kBtBlock, gi = (tid / kBtPanel) % kBtPanel,
              gj = tid % kBtPanel;
    for (int p = 0; p < npan; ++p) {
      const int s0 = p * kBtPanel, pn = min(kBtPanel, na - s0);
      if (gi < gj && gj < pn) {
        float2 gsum = make_float2(0.f, 0.f);
        for (int r = act[s0 + gi] + 1 + h; r < m; r += kBtGSplit)
          cfma_conj(gsum, Vt[r * ldv + s0 + gi], Vt[r * ldv + s0 + gj]);
        G[(h * kBtMaxPanels + p) * kBtBlock + gi * kBtPanel + gj] = gsum;
      }
    }
  }
  __syncthreads();
  // T of every panel, a warp a panel; lane l holds row l
  for (int p = warp; p < npan; p += kWarps) {
    const int s0 = p * kBtPanel, pn = min(kBtPanel, na - s0);
    float2* Tp = T + p * kBtBlock;
    float2 trow[kBtPanel];
#pragma unroll
    for (int i = 0; i < kBtPanel; ++i) {
      if (i < pn) {
        const float2 ti = tau_s[s0 + i];
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll
        for (int q = 0; q < i; ++q) {
          float2 gq = Tp[q * kBtPanel + i];
#pragma unroll
          for (int x = 1; x < kBtGSplit; ++x) {
            const float2 gx = G[(x * kBtMaxPanels + p) * kBtBlock +
                                q * kBtPanel + i];
            gq = make_float2(gq.x + gx.x, gq.y + gx.y);
          }
          if (q >= lane) cfma(acc, trow[q], gq);
        }
        const float2 ta = cmul(ti, acc);
        trow[i] = (lane < i) ? make_float2(-ta.x, -ta.y)
                             : (lane == i ? ti : make_float2(0.f, 0.f));
        __syncwarp();  // column i of G is read by every lane
        if (lane < kBtPanel) Tp[lane * kBtPanel + i] = trow[i];
        __syncwarp();
      }
    }
  }
  __syncthreads();

  const int h = tid / (kBtPanel * kBtCols);
  const int pi = (tid / kBtCols) % kBtPanel, pc = tid % kBtCols;
  for (int p = npan - 1; p >= 0; --p) {
    const int s0 = p * kBtPanel, pn = min(kBtPanel, na - s0);
    const float2* Tp = T + p * kBtBlock;
    if (pi < pn) {  // Y = V^H Z, in kBtSplit partial sums
      float2 y = make_float2(0.f, 0.f);
      for (int r = act[s0 + pi] + 1 + h; r < m; r += kBtSplit)
        cfma_conj(y, Vt[r * ldv + s0 + pi], Z[r * kBtCols + pc]);
      Y[(h * kBtPanel + pi) * kBtCols + pc] = y;
    }
    __syncthreads();
    if (h == 0 && pi < pn) {  // W = T Y
      float2 w = make_float2(0.f, 0.f);
      for (int i = pi; i < pn; ++i) {
        float2 y = Y[i * kBtCols + pc];
#pragma unroll
        for (int x = 1; x < kBtSplit; ++x) {
          const float2 yx = Y[(x * kBtPanel + i) * kBtCols + pc];
          y = make_float2(y.x + yx.x, y.y + yx.y);
        }
        cfma(w, Tp[pi * kBtPanel + i], y);
      }
      Wp[pi * kBtCols + pc] = w;
    }
    __syncthreads();
    {  // Z -= V W below the panel's first reflector
      float2 wc[kBtPanel];
#pragma unroll
      for (int i = 0; i < kBtPanel; ++i)
        wc[i] = (i < pn) ? Wp[i * kBtCols + pc] : make_float2(0.f, 0.f);
      for (int r = act[s0] + 1 + tid / kBtCols; r < m;
           r += kBtThreads / kBtCols) {
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < kBtPanel; ++i)
          if (i < pn) cfma(acc, Vt[r * ldv + s0 + i], wc[i]);
        float2& x = Z[r * kBtCols + pc];
        x = make_float2(x.x - acc.x, x.y - acc.y);
      }
    }
    __syncthreads();
  }
  for (int idx = tid; idx < m * kBtCols; idx += kBtThreads) {
    const int r = idx / kBtCols, c = idx % kBtCols;
    if (c < cw) out[r * keep + c0 + c] = Z[idx];
  }
}

}  // namespace

extern "C" {

// Every launcher takes a batch of `batch` matrices: the strides (in
// elements) between the matrices of each input; the outputs are contiguous
// in the batch. batch = 1 is the single-matrix launch.
constexpr int kMaxBatch = 65535;  // backtransform's grid y

int tridiag_launch(const void* h, void* vrows, void* tau, void* d, void* e,
                   int m, int batch, long long h_stride, void* stream) {
  if (m < 2 || m > kMaxM || batch < 1 || batch > kMaxBatch)
    return (int)cudaErrorInvalidValue;
  const float2* hh = (const float2*)h;
  float2 *v = (float2*)vrows, *t = (float2*)tau;
  float *dd = (float*)d, *ee = (float*)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (m <= kTriGroups * 4)
    tridiag_kernel<4><<<batch, kTriThreads, 0, st>>>(hh, v, t, dd, ee, m,
                                                     h_stride);
  else if (m <= kTriGroups * 8)
    tridiag_kernel<8><<<batch, kTriThreads, 0, st>>>(hh, v, t, dd, ee, m,
                                                     h_stride);
  else
    tridiag_kernel<16><<<batch, kTriThreads, 0, st>>>(hh, v, t, dd, ee, m,
                                                      h_stride);
  return (int)cudaGetLastError();
}

int teig_launch(const void* d, const void* e, const void* b0, void* w, void* z,
                int m, int batch, long long d_stride, long long e_stride,
                void* stream) {
  if (m < 2 || m > kMaxM || batch < 1 || batch > kMaxBatch)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)teig_smem_floats(m) * sizeof(float);
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      teig_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  teig_kernel<<<batch, kTeigThreads, smem, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)e, (const float*)b0, (float*)w,
      (float*)z, m, d_stride, e_stride);
  return (int)cudaGetLastError();
}

int backtransform_launch(const void* vrows, const void* tau, const void* z,
                         void* out, int m, int keep, int batch,
                         long long v_stride, long long tau_stride,
                         long long z_stride, void* stream) {
  if (m < 2 || m > kMaxM || keep < 1 || keep > m || batch < 1 ||
      batch > kMaxBatch)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)bt_smem_float2(m) * sizeof(float2);
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      backtransform_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem));
  const dim3 grid((keep + kBtCols - 1) / kBtCols, batch);
  backtransform_kernel<<<grid, kBtThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)vrows, (const float2*)tau, (const float*)z,
      (float2*)out, m, keep, v_stride, tau_stride, z_stride);
  return (int)cudaGetLastError();
}

// Marks a library whose eigensolver launchers take the batch arguments
// (tools that also load builds of older sources look for it).
int eigh_batched_launchers() { return 1; }

const char* adaptaqc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
