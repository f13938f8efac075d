// Hermitian eigensolver of the bond truncation: three kernels for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernels in ops/pallas_eigh.py:
//   tridiag_kernel        <- _tridiag_kernel       (pallas_eigh.py:56)
//   teig_kernel           <- _teig_kernel          (pallas_eigh.py:194)
//   backtransform_kernel  <- _backtransform_kernel (pallas_eigh.py:136)
// and, for 128 < m, the wide variants of the first two
// (tridiag_cluster_kernel, teig_cluster_kernel, at the end of this file),
// whose double instantiations serve complex128 at every m; the wide
// back-transform is csrc/backtransform_wide.cu, and K2 past its cluster's
// shared memory is csrc/tridiag_grid.cu.
// Input is the m x m Hermitian Gram matrix of one two-qubit apply, m = 2 chi
// <= 128, complex64 (float2), or a batch of P of them in one launch: the
// full-cost sweep applies every gate to its 3 or 7 probe states at once (the
// JAX package maps its kernels over the probes, which adds a grid dimension
// to each pallas_call). Every kernel indexes its matrix by a grid axis
// (tridiag and teig: one CTA a matrix, their wide variants one cluster a
// matrix;
// backtransform: its column panels on grid x, the matrix on grid y) and
// nothing is shared across the batch but
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <unordered_map>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using adaptaqc::cp_async16;
using adaptaqc::cp_async8;
using adaptaqc::cp_async_commit;
using adaptaqc::cp_async_wait;
using adaptaqc::mbar_init;
using adaptaqc::mbar_wait;
using adaptaqc::warp_sum;

constexpr int kMaxM = 128;  // the register, shared-memory designs below;
                            // the wide variants at the end take m up to
                            // 2048
// Every launcher takes a batch of `batch` matrices: the strides (in
// elements) between the matrices of each input; the outputs are contiguous
// in the batch. batch = 1 is the single-matrix launch.
constexpr int kMaxBatch = 65535;  // backtransform's grid y

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
// the same three in complex128 (the wide variants' double instantiation)
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ void cfma(double2& acc, double2 a, double2 b) {
  acc.x = fma(a.x, b.x, fma(-a.y, b.y, acc.x));
  acc.y = fma(a.x, b.y, fma(a.y, b.x, acc.y));
}
__device__ __forceinline__ void cfma_conj(double2& acc, double2 a, double2 b) {
  acc.x = fma(a.x, b.x, fma(a.y, b.y, acc.x));
  acc.y = fma(a.x, b.y, fma(-a.y, b.x, acc.y));
}

// ---------------------------------------------- float / double overloads
// The round-to-nearest intrinsics and the math functions by real type, so
// that one template body serves complex64 and complex128.
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float2 make_c(float x, float y) {
  return make_float2(x, y);
}
__device__ __forceinline__ double2 make_c(double x, double y) {
  return make_double2(x, y);
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
// (V: float2 or double2, the norm in its real type.)
template <typename V>
__device__ __noinline__ auto scaled_norm(const V* col, int k, int m, int lane)
    -> decltype(V::x) {
  using T = decltype(V::x);
  T amax = 0;
  for (int j = k + 1 + lane; j < m; j += 32)
    amax = max_(amax, max_(abs_(col[j].x), abs_(col[j].y)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = max_(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const T inv = T(1) / amax;
  T part = 0;
  for (int j = k + 1 + lane; j < m; j += 32) {
    const T cx = col[j].x * inv, cy = col[j].y * inv;
    part += cx * cx + cy * cy;
  }
  return amax * sqrt_(warp_sum(part));
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

template <typename T>
__device__ __forceinline__ T guard(T x, T pivmin) {
  return (abs_(x) < pivmin) ? ((x >= T(0)) ? pivmin : -pivmin) : x;
}

__device__ __forceinline__ float rsqrt_rn(float x) {
  return __frcp_rn(__fsqrt_rn(x));
}
__device__ __forceinline__ double rsqrt_rn(double x) {
  return __drcp_rn(__dsqrt_rn(x));
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
__device__ __forceinline__ double div_rn(double a, double b) {
  const double q = __ddiv_rn(a == 0.0 ? 1.0 : a, b);
  return a == 0.0 ? __longlong_as_double(
                        (__double_as_longlong(a) ^ __double_as_longlong(b)) &
                        (long long)0x8000000000000000ULL)
                  : q;
}

// Sturm count: the number of negative pivots of T - x I (guarded as the
// plain version guards them). kSquare: `e2` holds e itself, each e2[i]
// formed as it is read, mul_rn(e[i], e[i]), the same bits as the stored e2
// (tg_bisect_kernel's global-memory route reads d and e where they lie).
template <typename T, bool kSquare = false>
__device__ __forceinline__ int sturm_count(const T* d, const T* e2, int m,
                                           T x, T pivmin) {
  T q = sub_rn(d[0], x);
  if (abs_(q) < pivmin) q = -pivmin;
  int cnt = (q < T(0)) ? 1 : 0;
  for (int i = 1; i < m; ++i) {
    const T ee = kSquare ? mul_rn(e2[i - 1], e2[i - 1]) : e2[i - 1];
    q = sub_rn(sub_rn(d[i], x), div_rn(ee, q));
    if (abs_(q) < pivmin) q = -pivmin;
    cnt += (q < T(0)) ? 1 : 0;
  }
  return cnt;
}

template <typename T>
__device__ __forceinline__ T mid_rn(T a, T b) {
  return mul_rn(T(0.5), add_rn(a, b));
}

// The point that bisection from [lo, hi] visits at heap node h (h >= 1:
// each bit below the leading one, from the top, takes the upper half if
// set), computed by the same chain of midpoints.
template <typename T>
__device__ __forceinline__ T tree_point(T lo, T hi, int h) {
  for (int bit = 30 - __clz(h); bit >= 0; --bit) {
    const T md = mid_rn(lo, hi);
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

// ------------------------------------------------------ the wide variants
// For 128 < m (the JAX kernels' own reach, pallas_eigh.py's `supported`:
// 10 m^2 float32 words in 12 MiB of VMEM, ends at m = 560; past it the
// reference runs XLA's eigh and the port these kernels: past its CTAs'
// shared memory K2 runs its card-wide route, csrc/tridiag_grid.cu, and K3
// teig_grid, its own card-wide route). At m = 256 one complex64
// matrix is 512 KB, more than an SM's registers (256 KB) or shared memory
// (227 KB), so the designs above do not stretch. K4's wide design is
// csrc/backtransform_wide.cu (a cluster over the rows of each tile of
// output columns). K2 and K3 spread a matrix over a thread-block cluster
// of up to 16 CTAs: K2 its rows (tridiag_cluster_kernel: the trailing
// block split by rows, kept in the CTAs' shared memory, v and u exchanged
// through distributed shared memory), K3 its eigenvalue lanes and their
// columns of the iterate (teig_cluster_kernel; past that fit, teig_grid's
// launches over the whole card). The properties of the m <= 128 kernels
// carry over: the scaled norm of a tiny column, the
// exactly inactive step, eigenvalues equal to the plain version's bit for
// bit, and a batch equal to its P = 1 launches (fixed reduction orders,
// nothing shared across the batch but b0).
//
// They are templates on the real type T. float serves complex64 for
// 128 < m; double serves complex128 at every m >= 2. In double the
// constants are the plain version's float64 ones
// (ops/eigh_kernels.py _teig_constants: 60 bisection rounds, eps 2.3e-16,
// pivmin floor 1e-300) and the tiny-column threshold is DBL_MIN /
// DBL_EPSILON, as the plain version's finfo(float64).tiny / eps.
constexpr int kTcMaxM = 640;  // the most K2's cluster route takes (its
                              // rows in shared memory, complex64)

template <typename T>
struct Real;
template <>
struct Real<float> {
  using C = float2;
  static constexpr int kRounds = kBisectRounds;
  static constexpr float kEps = 1.2e-7f;       // teig's relative eps
  static constexpr float kPivFloor = 1e-35f;   // its pivmin floor
  static constexpr float kFloor = 1e-30f;      // its scale and norm floors
  static constexpr float kTiny = kTinySquares;
};
template <>
struct Real<double> {
  using C = double2;
  static constexpr int kRounds = 60;
  static constexpr double kEps = 2.3e-16;
  static constexpr double kPivFloor = 1e-300;
  static constexpr double kFloor = 1e-30;
  static constexpr double kTiny = 0x1p-970;
};

// Four reals of a 16-byte aligned row (one vector load in float, two in
// double).
template <typename T>
struct alignas(16) Quad {
  T x, y, z, w;
};

template <typename V>
__device__ __forceinline__ V warp_sum2(V v) {
  return make_c(warp_sum(v.x), warp_sum(v.y));
}

// K3's wide variant: teig_kernel's algorithm on a thread-block cluster of G
// CTAs a matrix (G = ceil(m / 32), at most 16; 8 where 16 does not fit),
// for complex64 at 128 < m <= 640 and complex128 at m <= 512, where every
// CTA's columns of the iterate fit in its shared memory (past that fit,
// teig_grid below). One
// CTA a matrix (the first design) ran every stage on one SM: the multisection
// with two threads a lane at m = 512 (30 dependent Sturm sweeps), the
// inverse iteration's LU and iterate in global memory (a round trip
// through L1/L2 in every step of the dependent solves), and the BCGS2 over
// one SM's L2 bandwidth with about six block barriers a column. Here:
//   - CTA r owns the eigenvalue lanes [r L, r L + L) (L = 32, or 16 at
//     m <= 16; a multiple of the CGS2 panel, so that each panel lies in one
//     CTA) and keeps their columns of the iterate in its shared memory
//     (m rows of L + 1 reals: walking a row and walking a column are both
//     conflict-free);
//   - multisection as in teig_kernel with 16 threads a lane (k = 4: 8
//     sweeps for the 30 float rounds, 15 for the 60 double ones), w equal
//     to the plain version's bit for bit;
//   - the shifts read every earlier eigenvalue: each CTA pulls the other
//     ranks' w through distributed shared memory after one cluster
//     barrier;
//   - inverse iteration a thread a lane, as before, with the LU factors du,
//     u1 and the swap bits in shared memory where they fit (complex64 to
//     m = 512, complex128 to m = 256), else in a global scratch; either way
//     the backward solve reads them, and the iterate, a few steps ahead in
//     a register ring (their addresses do not depend on the recurrence), so
//     no load waits on the chain;
//   - BCGS2 by panels of 16 columns in order, each inside its owner CTA.
//     Each CTA first publishes its columns to z (L2). Each of the two
//     passes: every CTA that holds earlier columns Q_r pulls the panel P
//     from z, forms W_r = Q_r^T P and its partial Y_r = Q_r W_r from its
//     own shared memory (cluster barrier); CTA s sums the partials of its
//     slice of rows from the other CTAs' shared memory, ranks in order,
//     and subtracts them from P in z (cluster barrier). So a batch, and a
//     rerun, equals its P = 1 launch bit for bit. Pulling P from the
//     owner's shared memory instead made its SM serve every CTA at once,
//     and the other CTAs' pulls held the owner at the barrier after them
//     for most of a panel's time at m = 504. Then the owner copies the panel
//     back and runs the CGS2 inside it on four warps (cgs2_panel): three
//     128-thread named barriers a column, the 16 dots of a pass summed at
//     once, no branch between the loads. Four cluster barriers a panel
//     (five on an owner's first);
//   - every division goes through div_rn, the recurrences through the
//     round-to-nearest intrinsics; b0 is shared, read-only, by the batch.
// A batch of P matrices is P clusters on grid x.
constexpr int kClThreads = 512;     // 16 warps a CTA
constexpr int kClMaxCluster = 16;
constexpr int kClLaneThreads = 16;  // multisection threads an eigenvalue
constexpr int kClCgsWarps = 4;      // the in-panel CGS2's warps
constexpr int kClCgsRowsSmem = 5;   // its rows a thread: m <= 640
constexpr int kClMaxM = 32 * kClCgsWarps * kClCgsRowsSmem;  // 640
static_assert(kPanel == 16, "the panel's row is four 4-real quads");

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// The LU factors of one CTA's lanes, in reals: du and u1 (m x L each,
// lane-fastest) and the swap bits (one word per 32 steps a lane, counted
// as a real each).
__host__ __device__ inline int cl_lu_reals(int m, int L) {
  return 2 * m * L + ((m + 31) / 32) * L;
}

// A CTA's dynamic shared memory, offsets in reals of T (16-byte aligned):
// d, e, e2, w (m each), the iterate's columns (m rows of ldb = L + 1), the
// projections W (L x kPanel), then one region holding the LU factors (where
// they are in shared memory) during the inverse iteration and the pulled
// panel, overwritten by the partial Q_r W_r, during the BCGS2.
struct ClLayout {
  int ldb, bb, W, X, total;
};
template <typename T>
__host__ __device__ inline ClLayout cl_layout(int m, int L, bool lu_smem) {
  ClLayout c;
  c.ldb = L + 1;
  c.bb = round4(4 * m);
  c.W = round4(c.bb + m * c.ldb);
  c.X = round4(c.W + L * kPanel);
  const int words = ((m + 31) / 32) * L;
  const int lu = 2 * m * L + (int)((words * 4 + sizeof(T) - 1) / sizeof(T));
  const int py = m * kPanel;
  c.total = c.X + (lu_smem && lu > py ? lu : py);
  return c;
}

// The lanes a CTA where a cluster holds at most `cap` CTAs: ceil(m / cap)
// rounded up to a multiple of kPanel (the cluster then has ceil(m / L)).
__host__ __device__ inline int cl_lanes(int m, int cap) {
  const int g0 = (m + 31) / 32 < cap ? (m + 31) / 32 : cap;
  const int L = (((m + g0 - 1) / g0 + kPanel - 1) / kPanel) * kPanel;
  return L > kPanel ? L : kPanel;
}

// The global scratch a matrix of the cluster route, in reals: each CTA's LU
// factors, where they do not fit in its shared memory.
inline long long teig_cluster_scratch_reals(int m) {
  long long most = 0;
  for (int cap : {kClMaxCluster, 8}) {
    const int L = cl_lanes(m, cap), G = (m + L - 1) / L;
    const long long need = (long long)G * cl_lu_reals(m, L);
    most = need > most ? need : most;
  }
  return most;
}

// One level of transpose_sum16: lanes that differ in bit `kBit` swap the
// halves of their first 2 kN sums, each keeping one half, summed.
template <int kN, int kBit, typename T, int kLen>
__device__ __forceinline__ void halve_sums(T (&x)[kLen], int lane) {
  const bool up = lane & kBit;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const T keep = up ? x[k + kN] : x[k];
    const T send = up ? x[k] : x[k + kN];
    x[k] = keep + __shfl_xor_sync(0xffffffffu, send, kBit);
  }
}

// The 16 sums of x[q] over a warp at once: each shuffle level halves the
// set a lane carries (lane bit 4 keeps the upper or lower 8, bit 3 the
// upper or lower 4 of those, ...), 16 shuffles in all where 16 warp_sums
// take 80; lane 2q (and 2q + 1) ends with the sum of x[q] in x[0].
template <typename T>
__device__ __forceinline__ void transpose_sum16(T (&x)[kPanel], int lane) {
  halve_sums<8, 16>(x, lane);
  halve_sums<4, 8>(x, lane);
  halve_sums<2, 4>(x, lane);
  halve_sums<1, 2>(x, lane);
  x[0] += __shfl_xor_sync(0xffffffffu, x[0], 1);
}

__device__ __forceinline__ void cgs_sync() {  // the in-panel CGS2's warps
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kClCgsWarps) : "memory");
}

// The in-panel CGS2 of columns [cl0, cl0 + pw) of the owner's iterate, on
// its first kClCgsWarps warps: thread t holds rows t + 32 kClCgsWarps k
// (k < kRows) of the current column in registers and reads only its own
// rows of the earlier ones; a pass's 16 dots are summed over each warp at
// once by transpose_sum16, then over the warps in a fixed order through
// `red` (double-buffered: one barrier a reduction), by lane q of every
// warp for dot q. No branch on p or on the rows: every thread reads all 16
// panel columns of its rows (a row past m is row m - 1 with a zero
// weight; columns past p take zero dots and drop out), so the loads of a
// pass issue back to back instead of waiting one after another behind
// branches (with a branch a column, the in-panel CGS2 took two to three
// times as long; skipping the columns past p by fours behind a uniform
// branch was slower again, except in double at m = 504); the update then
// zeroes the rows past m.
// Column 0 of the matrix keeps its iterate, as in the plain version.
template <int kRows, typename T>
__device__ __forceinline__ void cgs2_panel(T* bb, int ldb, int m, int c0,
                                           int cl0, int pw,
                                           T (*red)[kClCgsWarps][kPanel]) {
  const int t = threadIdx.x, lane = t & 31, wp = t >> 5;
  constexpr int kStride = 32 * kClCgsWarps;
  const T zero = 0;
  int row[kRows];
  bool live[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = t + kStride * k;
    live[k] = i < m;
    row[k] = (live[k] ? i : m - 1) * ldb + cl0;
  }
  // the sum over the warps of red[b][.][lane & 15], in warp order
  auto gather = [&](int b) {
    T s = red[b][0][lane & 15];
#pragma unroll
    for (int w = 1; w < kClCgsWarps; ++w) s += red[b][w][lane & 15];
    return s;
  };
  int buf = 0;
  for (int p = 0; p < pw; ++p) {
    if (c0 + p == 0) continue;
    T v[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) v[k] = live[k] ? bb[row[k] + p] : zero;
    for (int pass = 0; p > 0 && pass < 2; ++pass) {
      T part[kPanel];
#pragma unroll
      for (int q = 0; q < kPanel; ++q) {
        T s = zero;
#pragma unroll
        for (int k = 0; k < kRows; ++k) s = fma_(bb[row[k] + q], v[k], s);
        part[q] = s;
      }
      transpose_sum16(part, lane);
      if ((lane & 1) == 0) red[buf][wp][lane >> 1] = part[0];
      cgs_sync();
      const T dots = gather(buf);
      buf ^= 1;
#pragma unroll
      for (int q = 0; q < kPanel; ++q) {
        const T dq = __shfl_sync(0xffffffffu, dots, q);
        const T neg = q < p ? -dq : zero;
#pragma unroll
        for (int k = 0; k < kRows; ++k)
          v[k] = fma_(neg, bb[row[k] + q], v[k]);
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) v[k] = live[k] ? v[k] : zero;
    }
    T s = zero;
#pragma unroll
    for (int k = 0; k < kRows; ++k) s = fma_(v[k], v[k], s);
    s = warp_sum(s);
    if (lane == 0) red[buf][wp][0] = s;
    cgs_sync();
    const T tot = __shfl_sync(0xffffffffu, gather(buf), 0);
    buf ^= 1;
    const T scl = rsqrt_rn(max_(tot, Real<T>::kFloor));
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (live[k]) bb[row[k] + p] = v[k] * scl;
  }
}

// cgs2_panel with as many rows a thread as m needs, up to kClCgsRowsSmem.
template <typename T>
__device__ __forceinline__ void cgs2_panel_rows(
    T* bb, int ldb, int m, int c0, int cl0, int pw,
    T (*red)[kClCgsWarps][kPanel]) {
  const int rows = (m + 32 * kClCgsWarps - 1) / (32 * kClCgsWarps);
  switch (rows) {
    case 1: cgs2_panel<1>(bb, ldb, m, c0, cl0, pw, red); break;
    case 2: cgs2_panel<2>(bb, ldb, m, c0, cl0, pw, red); break;
    case 3: cgs2_panel<3>(bb, ldb, m, c0, cl0, pw, red); break;
    case 4: cgs2_panel<4>(bb, ldb, m, c0, cl0, pw, red); break;
    default: cgs2_panel<5>(bb, ldb, m, c0, cl0, pw, red); break;
  }
}

// Grid: batch x G CTAs of kClThreads, clusters of G along x (cluster b is
// matrix b). L: lanes a CTA; lu_smem: the LU factors in shared memory,
// else in `scratch` (batch x G x cl_lu_reals(m, L) reals).
template <typename T>
__global__ void __launch_bounds__(kClThreads, 1)
    teig_cluster_kernel(const T* __restrict__ d_in, const T* __restrict__ e_in,
                        const T* __restrict__ b0, T* __restrict__ w_out,
                        T* __restrict__ z_out, T* __restrict__ scratch, int m,
                        int L, int lu_smem, long long d_stride,
                        long long e_stride) {
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const size_t b = blockIdx.x / G;
  d_in += b * (size_t)d_stride;
  e_in += b * (size_t)e_stride;
  w_out += b * m;
  z_out += b * (size_t)m * m;
  const int j0 = rank * L;          // this CTA's first lane
  const int nl = min(L, m - j0);    // and its number of lanes
  const ClLayout lay = cl_layout<T>(m, L, lu_smem != 0);
  const int ldb = lay.ldb;
  extern __shared__ __align__(16) unsigned char csm_raw[];
  T* sm = reinterpret_cast<T*>(csm_raw);
  T* d = sm;
  T* e = d + m;
  T* e2 = e + m;
  T* w = e2 + m;
  // bb[i * ldb + jl]: row i of lane j0 + jl
  T* bb = sm + lay.bb;
  T* W = sm + lay.W;    // (L, kPanel)
  T* PY = sm + lay.X;   // (m, kPanel) the pulled panel, then Q_r W_r
  T* du = lu_smem ? sm + lay.X
                  : scratch + (b * G + rank) * (size_t)cl_lu_reals(m, L);
  T* u1 = du + (size_t)m * L;
  uint32_t* swb = reinterpret_cast<uint32_t*>(u1 + (size_t)m * L);
  __shared__ T sc[4];
  __shared__ T red[2][kClCgsWarps][kPanel];
  const int tid = threadIdx.x, lane = tid & 31;
  const T zero = 0;
  using Q4 = Quad<T>;

  for (int i = tid; i < m; i += kClThreads) {
    d[i] = d_in[i];
    const T ei = (i < m - 1) ? e_in[i] : zero;
    e[i] = ei;
    e2[i] = mul_rn(ei, ei);
  }
  for (int idx = tid; idx < m * L; idx += kClThreads) {
    const int i = idx / L, jl = idx - i * L;  // lanes past m: zero columns
    bb[i * ldb + jl] = jl < nl ? b0[(size_t)i * m + j0 + jl] : zero;
  }
  __syncthreads();
  if (tid == 0) {
    T lo0 = T(INFINITY), hi0 = -T(INFINITY);
    for (int i = 0; i < m; ++i) {
      const T rad = add_rn(abs_(e[i]), abs_(i > 0 ? e[i - 1] : zero));
      lo0 = min_(lo0, sub_rn(d[i], rad));
      hi0 = max_(hi0, add_rn(d[i], rad));
    }
    const T scale = max_(max_(abs_(lo0), abs_(hi0)), Real<T>::kFloor);
    const T p = mul_rn(Real<T>::kEps, scale);
    sc[0] = lo0;
    sc[1] = hi0;
    sc[2] = scale;
    sc[3] = max_(Real<T>::kPivFloor, mul_rn(p, p));
  }
  __syncthreads();
  const T lo0 = sc[0], hi0 = sc[1], scale = sc[2], pivmin = sc[3];

  // Sturm multisection of this CTA's lanes, tl threads a lane
  // (kClLaneThreads where the CTA holds them all at once, fewer past L = 32)
  {
    int tl = kClLaneThreads;
    while (tl > 2 && tl * L > kClThreads) tl >>= 1;
    const int k = 31 - __clz(tl);
    const int sub = tid % tl;
    const int base = lane & ~(tl - 1);
    for (int jb = 0; jb < nl; jb += kClThreads / tl) {
      const int jl = jb + tid / tl;
      const int j = j0 + min(jl, nl - 1);
      const T target = (T)(m - 1 - j);
      T lo = lo0, hi = hi0;
      for (int r = 0; r < Real<T>::kRounds; r += k) {
        const int kk = min(k, Real<T>::kRounds - r);
        const T x = (sub >= 1 && sub < (1 << kk)) ? tree_point(lo, hi, sub)
                                                  : mid_rn(lo, hi);
        const int cnt = sturm_count(d, e2, m, x, pivmin);
        int node = 1;
        for (int l = 0; l < kk; ++l) {
          const int cn = __shfl_sync(0xffffffffu, cnt, base + node);
          const T mid = mid_rn(lo, hi);
          if ((T)cn > target) {
            hi = mid;
            node = 2 * node;
          } else {
            lo = mid;
            node = 2 * node + 1;
          }
        }
      }
      if (sub == 0 && jl < nl) w[j] = mid_rn(lo, hi);
    }
  }
  // every rank's eigenvalues: pulled from their owners after one cluster
  // barrier (which also makes sure every CTA of the cluster has started)
  cluster.sync();
  for (int l = tid; l < m; l += kClThreads) {
    const int owner = l / L;
    if (owner != rank) w[l] = cluster.map_shared_rank(w, owner)[l];
  }
  __syncthreads();

  if (tid < nl) {
    const int jl = tid, j = j0 + jl;
    // shift lam_j = min_{l<=j} (w_l - (j-l) eps): coincident shifts split
    const T eps = mul_rn(Real<T>::kEps, scale);
    T lam = add_rn(hi0, scale);
    for (int l = 0; l <= j; ++l)
      lam = min_(lam, sub_rn(w[l], mul_rn((T)(j - l), eps)));
    // two rounds of inverse iteration on this lane's column, as in
    // teig_kernel; the backward solve runs in chunks of kAhead steps, each
    // loading the next chunk's factors and iterate rows before it solves
    constexpr int kAhead = 4;
    for (int rep = 0; rep < 2; ++rep) {
      T a_i = sub_rn(d[0], lam), s1_i = e[0];
      T carry = bb[jl];
      uint32_t bits = 0;
      for (int i = 0; i < m - 1; ++i) {
        const T a_next = sub_rn(d[i + 1], lam);
        const T s1_next = e[i + 1];
        const T r2 = e[i];
        const bool swap = abs_(r2) > abs_(a_i);
        const T top0 = guard(swap ? r2 : a_i, pivmin);
        const T top1 = swap ? a_next : s1_i;
        const T top2 = swap ? s1_next : zero;
        const T bot0 = swap ? a_i : r2;
        const T bot1 = swap ? s1_i : a_next;
        const T bot2 = swap ? zero : s1_next;
        const T mlt = div_rn(bot0, top0);
        du[(size_t)i * L + jl] = top0;
        u1[(size_t)i * L + jl] = top1;
        bits |= (swap ? 1u : 0u) << (i & 31);
        if ((i & 31) == 31 || i == m - 2) {
          swb[(i >> 5) * L + jl] = bits;
          bits = 0;
        }
        a_i = sub_rn(bot1, mul_rn(mlt, top1));
        s1_i = sub_rn(bot2, mul_rn(mlt, top2));
        const T bi1 = bb[(i + 1) * ldb + jl];
        const T bt = swap ? bi1 : carry;
        const T bo = swap ? carry : bi1;
        bb[i * ldb + jl] = bt;
        carry = sub_rn(bo, mul_rn(mlt, bt));
      }
      const T dlast = guard(a_i, pivmin);
      T x2 = div_rn(carry, dlast);
      bb[(m - 1) * ldb + jl] = x2;
      T x1 = div_rn(sub_rn(bb[(m - 2) * ldb + jl],
                           mul_rn(u1[(size_t)(m - 2) * L + jl], x2)),
                    du[(size_t)(m - 2) * L + jl]);
      bb[(m - 2) * ldb + jl] = x1;
      // the factors and iterate row of step i, read a chunk ahead of the
      // recurrence (past step 0 the reads repeat row 0, unused)
      T c_du[kAhead], c_u1[kAhead], c_u2[kAhead], c_b[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int i = max(m - 3 - k, 0);
        c_du[k] = du[(size_t)i * L + jl];
        c_u1[k] = u1[(size_t)i * L + jl];
        c_u2[k] = ((swb[(i >> 5) * L + jl] >> (i & 31)) & 1u) ? e[i + 1]
                                                             : zero;
        c_b[k] = bb[i * ldb + jl];
      }
      for (int i0 = m - 3; i0 >= 0; i0 -= kAhead) {
        T n_du[kAhead], n_u1[kAhead], n_u2[kAhead], n_b[kAhead];
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          const int i = max(i0 - kAhead - k, 0);
          n_du[k] = du[(size_t)i * L + jl];
          n_u1[k] = u1[(size_t)i * L + jl];
          n_u2[k] = ((swb[(i >> 5) * L + jl] >> (i & 31)) & 1u) ? e[i + 1]
                                                               : zero;
          n_b[k] = bb[i * ldb + jl];
        }
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          if (i0 - k >= 0) {
            const T t = sub_rn(sub_rn(c_b[k], mul_rn(c_u1[k], x1)),
                               mul_rn(c_u2[k], x2));
            const T xi = div_rn(t, c_du[k]);
            bb[(i0 - k) * ldb + jl] = xi;
            x2 = x1;
            x1 = xi;
          }
        }
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          c_du[k] = n_du[k];
          c_u1[k] = n_u1[k];
          c_u2[k] = n_u2[k];
          c_b[k] = n_b[k];
        }
      }
      // scale by the max-abs first: a nearly singular shift leaves
      // |x| ~ 1/pivmin^2, whose square overflows
      T amax = zero;
      for (int i = 0; i < m; ++i) amax = max_(amax, abs_(bb[i * ldb + jl]));
      if (amax > zero)
        for (int i = 0; i < m; ++i)
          bb[i * ldb + jl] = div_rn(bb[i * ldb + jl], amax);
      T nrm2 = zero;
      for (int i = 0; i < m; ++i)
        nrm2 = add_rn(nrm2, mul_rn(bb[i * ldb + jl], bb[i * ldb + jl]));
      const T s = rsqrt_rn(max_(nrm2, Real<T>::kFloor));
      for (int i = 0; i < m; ++i)
        bb[i * ldb + jl] = mul_rn(bb[i * ldb + jl], s);
    }
  }
  __syncthreads();

  // Distributed BCGS2 (see above). The panels move through z_out (L2),
  // not through the owner's shared memory, which every CTA would read at
  // once: each CTA first publishes its columns there; a pass pulls the
  // panel from it, and CTA rank's reductions of rows [r0, r1) write the
  // projected rows back to it; the owner copies the panel back before
  // its CGS2. The cluster barriers order these global accesses too
  // (release and acquire at cluster scope); reads bypass L1 (__ldcg).
  for (int idx = tid; idx < m * nl; idx += kClThreads) {
    const int i = idx / nl, jl = idx - i * nl;
    z_out[(size_t)i * m + j0 + jl] = bb[i * ldb + jl];
  }
  __syncthreads();
  const int R = (m + G - 1) / G;
  const int r0 = min(m, rank * R), r1 = min(m, r0 + R);
  Q4* PY4 = reinterpret_cast<Q4*>(PY);
  const Q4* W4 = reinterpret_cast<const Q4*>(W);
  for (int c0 = 0; c0 < m; c0 += kPanel) {
    const int o = c0 / L, cl0 = c0 - o * L;
    const int pw = min(kPanel, m - c0);
    const int ncols = max(0, min(nl, c0 - j0));  // own columns before c0
    const int nsrc = o + (cl0 > 0 ? 1 : 0);      // ranks that hold any
    for (int pass = 0; c0 > 0 && pass < 2; ++pass) {
      // the panel in z_out is current: after pass 0's exchange that takes
      // a cluster barrier, and so does the first panel of each owner (its
      // columns were published after its inverse iteration); the owner's
      // later panels were published then too
      if (pass > 0 || cl0 == 0)
        cluster.sync();
      else
        __syncthreads();
      if (ncols > 0) {
        for (int idx = tid; idx < m * kPanel; idx += kClThreads) {
          const int i = idx / kPanel, p = idx % kPanel;
          PY[idx] = p < pw ? __ldcg(z_out + (size_t)i * m + c0 + p) : zero;
        }
        __syncthreads();
        // W[c][p] = Q[:, c]^T P[:, p], four partial sums a thread
        for (int idx = tid; idx < ncols * kPanel; idx += kClThreads) {
          const int c = idx % ncols, p = idx / ncols;
          T a0 = zero, a1 = zero, a2 = zero, a3 = zero;
          int i = 0;
          for (; i + 4 <= m; i += 4) {
            a0 = fma_(bb[i * ldb + c], PY[i * kPanel + p], a0);
            a1 = fma_(bb[(i + 1) * ldb + c], PY[(i + 1) * kPanel + p], a1);
            a2 = fma_(bb[(i + 2) * ldb + c], PY[(i + 2) * kPanel + p], a2);
            a3 = fma_(bb[(i + 3) * ldb + c], PY[(i + 3) * kPanel + p], a3);
          }
          for (; i < m; ++i) a0 = fma_(bb[i * ldb + c], PY[i * kPanel + p], a0);
          W[c * kPanel + p] = (a0 + a1) + (a2 + a3);
        }
        __syncthreads();
        // the partial Q_r W_r, over the pulled panel
        for (int idx = tid; idx < m * (kPanel / 4); idx += kClThreads) {
          const int i = idx % m, pg = idx / m;
          Q4 acc = {zero, zero, zero, zero};
          for (int c = 0; c < ncols; ++c) {
            const T q = bb[i * ldb + c];
            const Q4 wv = W4[c * (kPanel / 4) + pg];
            acc.x = fma_(q, wv.x, acc.x); acc.y = fma_(q, wv.y, acc.y);
            acc.z = fma_(q, wv.z, acc.z); acc.w = fma_(q, wv.w, acc.w);
          }
          PY4[i * (kPanel / 4) + pg] = acc;
        }
      }
      cluster.sync();  // every partial is in place
      // P -= the partials' sum, ranks in order, on this CTA's rows
      for (int idx = tid; idx < (r1 - r0) * (kPanel / 4);
           idx += kClThreads) {
        const int i = r0 + idx / (kPanel / 4), pg = idx % (kPanel / 4);
        Q4 acc = {zero, zero, zero, zero};
        for (int s0 = 0; s0 < nsrc; s0 += 4) {
          Q4 v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (s0 + k < nsrc)
              v[k] = reinterpret_cast<const Q4*>(cluster.map_shared_rank(
                  PY, s0 + k))[i * (kPanel / 4) + pg];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (s0 + k < nsrc) {
              acc.x += v[k].x; acc.y += v[k].y;
              acc.z += v[k].z; acc.w += v[k].w;
            }
        }
        T* row = z_out + (size_t)i * m + c0 + 4 * pg;
        const T sub4[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (4 * pg + q < pw) row[q] = __ldcg(row + q) - sub4[q];
      }
    }
    if (c0 > 0) cluster.sync();  // the panel in z_out is projected
    if (rank == o) {
      if (c0 > 0) {
        for (int idx = tid; idx < m * pw; idx += kClThreads) {
          const int i = idx / pw, p = idx - i * pw;
          bb[i * ldb + cl0 + p] = __ldcg(z_out + (size_t)i * m + c0 + p);
        }
        __syncthreads();
      }
      if (tid < 32 * kClCgsWarps)
        cgs2_panel_rows(bb, ldb, m, c0, cl0, pw, red);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < m * nl; idx += kClThreads) {
    const int i = idx / nl, jl = idx - i * nl;
    z_out[(size_t)i * m + j0 + jl] = bb[i * ldb + jl];
  }
  for (int jl = tid; jl < nl; jl += kClThreads) w_out[j0 + jl] = w[j0 + jl];
  cluster.sync();  // no CTA leaves while another may read its memory
}

// K3's card-wide route, teig_grid: the same function as teig_cluster_kernel
// for the sizes whose iterate no cluster's shared memory holds (complex64
// m > 640, complex128 m > 512), at any m that device memory holds, and for
// the first `keep` eigenpairs only. The sweeps keep the top half (K4
// reads `keep` columns), and the first keep columns do not depend on the
// others: lane j's bisection reads lane j only, its shift only earlier
// eigenvalues, and CGS2 column j projects only against final columns < j.
// So keep = m / 2 does half the lanes and a quarter of the Gram-Schmidt.
// The cluster kernel's global-iterate route that it replaces ran every
// stage on one cluster of 16 SMs and spent 86-90% of its cycles in 128
// serial panels of four cluster barriers and an in-panel CGS2 that
// spilled and read L2 (tools/stage_clocks.py). Here the stages are
// separate launches from one host loop that reads nothing back
// (capturable in a CUDA graph), each as wide as its work:
//   - tg_bisect_kernel: the keep lanes' multisection, a warp a lane (k =
//     5: 6 Sturm sweeps for float's 30 rounds, 12 for double's 60), 8
//     lanes a CTA over as many CTAs as keep needs; every CTA takes the
//     Gershgorin bounds itself (min and max do not round, so any order
//     gives the same bounds), and w is the plain version's bit for bit;
//   - tg_invit_kernel: the shift and two rounds of inverse iteration, a
//     thread a lane, a warp a CTA. The iterate lives in z itself (row i of
//     lane j at z[i m + j], so a warp's accesses are coalesced), the LU
//     factors, multipliers and swap bits in `scratch`; every pass over a
//     column (the forward elimination, the backward solve, the
//     normalisation) reads its operands through a ring in shared memory
//     that cp.async fills a chunk of kTgChunk steps ahead (their addresses
//     do not depend on the recurrence, so no step waits on L2 for them);
//     the first round reads b0 in place, the second eliminates with the
//     first round's multipliers and swaps (the LU depends on the shift
//     alone: the same bits, and no division on its chain);
//   - block CGS2 over blocks of kB columns in order. Each block P (the
//     iterate's columns [c0, c0 + kB)) is projected twice against every
//     earlier column Q = z[:, :c0] by card-wide products: W = Q^T P as
//     partial sums over slabs of kTgSlab rows (tg_wpart_kernel, a CTA a
//     slab and a tile of Q's columns), summed in slab order
//     (tg_wsum_kernel), then P -= Q W (tg_update_kernel, a CTA a tile of
//     rows, Q and W staged by cp.async a tile ahead). Then CGS2 inside the
//     block (tg_inblock_kernel) on the block held in shared memory, its
//     rows split over a cluster of G = ceil(m / kTgInRows) CTAs (more
//     where a rank's rows would not fit a CTA; at most 16); each dot and
//     norm is summed over the CTA's warps, exchanged through distributed
//     shared memory and summed over the ranks in order, a block and a
//     cluster barrier a reduction (double-buffered slots). Every sum has a
//     fixed order whatever the grid, so a batch equals its P = 1 launches
//     bit for bit;
//   - the arithmetic is the plain version's: two passes against every
//     earlier column, column 0 kept, the same floors, div_rn and the
//     round-to-nearest intrinsics in the recurrences; products in exact
//     float32 or float64 FMAs (no TF32). In double the products stay on
//     DFMA (not DMMA): they are about a quarter of the time at keep = m / 2.
// What bounds it: the in-block CGS2, three dependent reductions a column
// (keep x 3 in all), each a block and a cluster barrier, then the lanes'
// serial recurrences (the multisection's Sturm sweeps and the inverse
// iteration's solves): tools/stage_clocks.py --kernels teig_grid gives
// each stage's device time, and with --variants the tuning choices above
// undone one at a time (128 rows and threads a rank against 256, the
// fewest ranks that hold the block, 16 threads a lane, slabs of 128, one
// Q column a thread in W).
// A batch of P matrices is P on the grid's batch axis (y, z in
// tg_wpart_kernel, clusters on x in tg_inblock_kernel).
constexpr int kTgThreads = 256;      // tg_bisect_kernel (over every SM)
constexpr int kTgLaneThreads = 32;   // its threads a lane: k = 5
constexpr int kTgBisectLanes = kTgThreads / kTgLaneThreads;  // 8
constexpr int kTgInvThreads = 32;    // tg_invit_kernel: lanes a CTA
constexpr int kTgChunk = 16;         // its rows a cp.async group
constexpr int kTgSlab = 64;          // rows of a W partial
constexpr int kTgProdThreads = 256;  // tg_wpart_kernel, tg_wsum_kernel
constexpr int kTgWCols = 2;          // its Q columns a thread in W
constexpr int kTgUpdThreads = 128;   // tg_update_kernel
constexpr int kTgUpdCols = 128;      // Q columns it stages at a time
constexpr int kTgInThreads = 128;    // tg_inblock_kernel
constexpr int kTgInWarps = kTgInThreads / 32;
constexpr int kTgInRows = 128;       // rows a rank it aims at
constexpr int kTgMaxCluster = 16;

// d (and e, e2) of one matrix into shared memory (each where its pointer is
// given: the global-memory kernels past the shared-memory fit take the
// bounds alone), with the Gershgorin bounds and their derived constants in
// sc: lo0, hi0, scale, pivmin (teig_cluster_kernel's, from exact
// block-wide min and max).
template <typename T, int kThreads>
__device__ __forceinline__ void tg_load_bounds(const T* __restrict__ d_in,
                                               const T* __restrict__ e_in,
                                               int m, T* d, T* e, T* e2,
                                               T* sc) {
  __shared__ T red[2][kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31;
  const T zero = 0;
  T lo = T(INFINITY), hi = -T(INFINITY);
  for (int i = tid; i < m; i += kThreads) {
    const T di = d_in[i];
    const T ei = i < m - 1 ? e_in[i] : zero;
    const T el = i > 0 ? e_in[i - 1] : zero;
    if (d) d[i] = di;
    if (e) e[i] = ei;
    if (e2) e2[i] = mul_rn(ei, ei);
    const T rad = add_rn(abs_(ei), abs_(el));
    lo = min_(lo, sub_rn(di, rad));
    hi = max_(hi, add_rn(di, rad));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min_(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max_(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    red[0][tid >> 5] = lo;
    red[1][tid >> 5] = hi;
  }
  __syncthreads();
  if (tid == 0) {
    T lo0 = red[0][0], hi0 = red[1][0];
    for (int w = 1; w < kThreads / 32; ++w) {
      lo0 = min_(lo0, red[0][w]);
      hi0 = max_(hi0, red[1][w]);
    }
    const T scale = max_(max_(abs_(lo0), abs_(hi0)), Real<T>::kFloor);
    const T p = mul_rn(Real<T>::kEps, scale);
    sc[0] = lo0;
    sc[1] = hi0;
    sc[2] = scale;
    sc[3] = max_(Real<T>::kPivFloor, mul_rn(p, p));
  }
  __syncthreads();
}

// Grid (ceil(keep / kTgBisectLanes), batch); dynamic shared memory 2 m
// reals (d and e2), or none with kGlobal: past where those fit (double
// past m = 14,518) every Sturm sweep reads d and e from global memory, where
// they stay resident in L1 and L2, squaring e as it goes.
template <typename T, bool kGlobal>
__global__ void __launch_bounds__(kTgThreads)
    tg_bisect_kernel(const T* __restrict__ d_in, const T* __restrict__ e_in,
                     T* __restrict__ w_out, int m, int keep,
                     long long d_stride, long long e_stride) {
  const size_t b = blockIdx.y;
  extern __shared__ __align__(16) unsigned char tg_raw[];
  T* d = kGlobal ? nullptr : reinterpret_cast<T*>(tg_raw);
  T* e2 = kGlobal ? nullptr : d + m;
  __shared__ T sc[4];
  const T* dg = d_in + b * (size_t)d_stride;
  const T* eg = e_in + b * (size_t)e_stride;
  tg_load_bounds<T, kTgThreads>(dg, eg, m, d, nullptr, e2, sc);
  const T pivmin = sc[3];
  constexpr int k = 5;  // log2(kTgLaneThreads): points a sweep 2^k - 1
  const int tid = threadIdx.x, lane = tid & 31;
  const int sub = tid % kTgLaneThreads;
  const int base = lane & ~(kTgLaneThreads - 1);
  const int j = blockIdx.x * kTgBisectLanes + tid / kTgLaneThreads;
  const T target = (T)(m - 1 - min(j, keep - 1));
  T lo = sc[0], hi = sc[1];
  for (int r = 0; r < Real<T>::kRounds; r += k) {
    const int kk = min(k, Real<T>::kRounds - r);
    const T x = (sub >= 1 && sub < (1 << kk)) ? tree_point(lo, hi, sub)
                                              : mid_rn(lo, hi);
    const int cnt = kGlobal ? sturm_count<T, true>(dg, eg, m, x, pivmin)
                            : sturm_count(d, e2, m, x, pivmin);
    int node = 1;
    for (int l = 0; l < kk; ++l) {
      const int cn = __shfl_sync(0xffffffffu, cnt, base + node);
      const T mid = mid_rn(lo, hi);
      if ((T)cn > target) {
        hi = mid;
        node = 2 * node;
      } else {
        lo = mid;
        node = 2 * node + 1;
      }
    }
  }
  if (sub == 0 && j < keep) w_out[b * (size_t)m + j] = mid_rn(lo, hi);
}

// The LU factors of a matrix in `scratch`: du, u1 and the multipliers ml
// (m x keep each, lane fastest), then the swap bits (ceil(m / 32) words a
// lane).
__host__ __device__ inline long long tg_lu_reals(int m, int keep,
                                                 int real_bytes) {
  const long long words = (long long)((m + 31) / 32) * keep;
  return 3LL * m * keep + (words * 4 + real_bytes - 1) / real_bytes;
}

// One real, global to shared, by cp.async (4 or 8 bytes).
__device__ __forceinline__ void cp_async_real(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   adaptaqc::smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_real(double* dst,
                                              const double* src) {
  cp_async8(dst, src);
}

// One 32-bit word, global to shared, by cp.async.
__device__ __forceinline__ void cp_async_word(uint32_t* dst,
                                              const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   adaptaqc::smem_addr(dst)),
               "l"(src)
               : "memory");
}

// tg_invit_kernel's dynamic shared memory, in reals: d, e (m each), w
// (keep), then its rings: three of reals and one of words, each two chunks
// of kTgChunk steps x kTgInvThreads lanes; with kGlobal (d, e and w read
// where they lie) the rings alone.
template <typename T, bool kGlobal = false>
__host__ __device__ inline int tg_invit_smem_reals(int m, int keep) {
  constexpr int kRing = 2 * kTgChunk * kTgInvThreads;
  return (kGlobal ? 0 : round4(2 * m + keep)) + 3 * kRing +
         (kRing * 4 + (int)sizeof(T) - 1) / (int)sizeof(T);
}

// Grid (ceil(keep / kTgInvThreads), batch); dynamic shared memory
// tg_invit_smem_reals<T, kGlobal>. kGlobal: past where d, e and w fit in
// shared memory (double past m = 8,488 at keep = m), the lanes read them
// from global memory, where they stay resident in L1 and L2 (every lane of
// a warp reads the same d[i] and e[i] at a step: one broadcast load); the
// arithmetic, and so every bit of z, is the shared-memory route's.
template <typename T, bool kGlobal>
__global__ void __launch_bounds__(kTgInvThreads)
    tg_invit_kernel(const T* __restrict__ d_in, const T* __restrict__ e_in,
                    const T* b0, const T* __restrict__ w_in, T* z,
                    T* __restrict__ scratch, int m, int keep,
                    long long d_stride, long long e_stride,
                    long long scratch_stride) {
  constexpr int kRing = 2 * kTgChunk * kTgInvThreads;
  const size_t b = blockIdx.y;
  extern __shared__ __align__(16) unsigned char tg_raw[];
  T* sm = reinterpret_cast<T*>(tg_raw);
  const T* dg = d_in + b * (size_t)d_stride;
  const T* eg = e_in + b * (size_t)e_stride;
  w_in += b * (size_t)m;
  T* ds = kGlobal ? nullptr : sm;
  T* es = kGlobal ? nullptr : sm + m;
  T* ws = kGlobal ? nullptr : sm + 2 * m;
  const T* d = kGlobal ? dg : ds;
  const T* w = kGlobal ? w_in : ws;
  T* ra = sm + (kGlobal ? 0 : round4(2 * m + keep));  // [2][kTgChunk][lanes]
  T* rb = ra + kRing;
  T* rc = rb + kRing;
  uint32_t* rs = reinterpret_cast<uint32_t*>(rc + kRing);
  __shared__ T sc[4];
  if (!kGlobal)
    for (int l = threadIdx.x; l < keep; l += kTgInvThreads) ws[l] = w_in[l];
  tg_load_bounds<T, kTgInvThreads>(dg, eg, m, ds, es, nullptr, sc);
  // e[i], 0 at i = m - 1 (as tg_load_bounds stores it)
  auto e = [&](int i) -> T {
    if (kGlobal) return i < m - 1 ? eg[i] : T(0);
    return es[i];
  };
  const int lt = threadIdx.x;
  const int j = blockIdx.x * kTgInvThreads + lt;
  if (j >= keep) return;
  const T hi0 = sc[1], scale = sc[2], pivmin = sc[3];
  const T zero = 0;
  z += b * (size_t)m * m;
  T* du = scratch + b * (size_t)scratch_stride;
  T* u1 = du + (size_t)m * keep;
  T* ml = u1 + (size_t)m * keep;
  uint32_t* swb = reinterpret_cast<uint32_t*>(ml + (size_t)m * keep);
  const size_t ld = m;
  auto slot = [&](int buf, int k) {
    return (buf * kTgChunk + k) * kTgInvThreads + lt;
  };
  // rows first .. first + n - 1 of this lane's column of the row-major
  // base (row stride m), in order, each to f(row, value), read a chunk
  // ahead through ring ra
  auto stream = [&](const T* base, int first, int n, auto&& f) {
    auto issue = [&](int c, int buf) {
#pragma unroll
      for (int k = 0; k < kTgChunk; ++k)
        cp_async_real(&ra[slot(buf, k)],
                      base + (size_t)(first + min(c + k, n - 1)) * ld + j);
      cp_async_commit();
    };
    issue(0, 0);
    int buf = 0;
    for (int c = 0; c < n; c += kTgChunk, buf ^= 1) {
      if (c + kTgChunk < n) {
        issue(c + kTgChunk, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
#pragma unroll
      for (int k = 0; k < kTgChunk; ++k)
        if (c + k < n) f(first + c + k, ra[slot(buf, k)]);
    }
  };
  // shift lam_j = min_{l<=j} (w_l - (j-l) eps): coincident shifts split
  const T eps = mul_rn(Real<T>::kEps, scale);
  T lam = add_rn(hi0, scale);
  for (int l = 0; l <= j; ++l)
    lam = min_(lam, sub_rn(w[l], mul_rn((T)(j - l), eps)));
  // the previous round's normalisation, applied as its rows are read: x /
  // amax (where amax > 0), then times s
  T amax = zero, s = T(1), dlast = zero;
  for (int rep = 0; rep < 2; ++rep) {
    const T* src = rep == 0 ? b0 : z;
    auto fix = [&](T x) {
      if (rep == 0) return x;
      return mul_rn(amax > zero ? div_rn(x, amax) : x, s);
    };
    // round 0: the LU of T - lam I with the forward elimination of the
    // iterate; round 1: the elimination with round 0's multipliers and
    // swaps (the same factors: the LU depends on lam alone)
    T carry = fix(src[j]);
    if (rep == 1) {
      auto issue = [&](int first, int buf) {
#pragma unroll
        for (int k = 0; k < kTgChunk; ++k) {
          const int i = min(first + k, m - 2);
          cp_async_real(&ra[slot(buf, k)], z + (i + 1) * ld + j);
          cp_async_real(&rb[slot(buf, k)], ml + (size_t)i * keep + j);
          cp_async_word(&rs[slot(buf, k)],
                        swb + (size_t)(i >> 5) * keep + j);
        }
        cp_async_commit();
      };
      issue(0, 0);
      int buf = 0;
      for (int i0 = 0; i0 < m - 1; i0 += kTgChunk, buf ^= 1) {
        if (i0 + kTgChunk < m - 1) {
          issue(i0 + kTgChunk, buf ^ 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
#pragma unroll
        for (int k = 0; k < kTgChunk; ++k) {
          const int i = i0 + k;
          if (i < m - 1) {
            const int o = slot(buf, k);
            const bool swap = (rs[o] >> (i & 31)) & 1u;
            const T bi1 = fix(ra[o]);
            const T bt = swap ? bi1 : carry;
            const T bo = swap ? carry : bi1;
            z[i * ld + j] = bt;
            carry = sub_rn(bo, mul_rn(rb[o], bt));
          }
        }
      }
    }
    T a_i = sub_rn(d[0], lam), s1_i = e(0);
    uint32_t bits = 0;
    if (rep == 0) stream(src, 1, m - 1, [&](int r, T x) {
      const int i = r - 1;
      const T a_next = sub_rn(d[i + 1], lam);
      const T s1_next = e(i + 1);
      const T r2 = e(i);
      const bool swap = abs_(r2) > abs_(a_i);
      const T top0 = guard(swap ? r2 : a_i, pivmin);
      const T top1 = swap ? a_next : s1_i;
      const T top2 = swap ? s1_next : zero;
      const T bot0 = swap ? a_i : r2;
      const T bot1 = swap ? s1_i : a_next;
      const T bot2 = swap ? zero : s1_next;
      const T mlt = div_rn(bot0, top0);
      du[(size_t)i * keep + j] = top0;
      u1[(size_t)i * keep + j] = top1;
      ml[(size_t)i * keep + j] = mlt;
      bits |= (swap ? 1u : 0u) << (i & 31);
      if ((i & 31) == 31 || i == m - 2) {
        swb[(size_t)(i >> 5) * keep + j] = bits;
        bits = 0;
      }
      a_i = sub_rn(bot1, mul_rn(mlt, top1));
      s1_i = sub_rn(bot2, mul_rn(mlt, top2));
      const T bi1 = fix(x);
      const T bt = swap ? bi1 : carry;
      const T bo = swap ? carry : bi1;
      z[i * ld + j] = bt;
      carry = sub_rn(bo, mul_rn(mlt, bt));
    });
    __threadfence_block();  // this lane's stores before its cp.async reads
    // the backward solve, its factors, swap words and rows a chunk ahead
    if (rep == 0) dlast = guard(a_i, pivmin);
    T x2 = div_rn(carry, dlast);
    z[(m - 1) * ld + j] = x2;
    T x1 = div_rn(sub_rn(z[(m - 2) * ld + j],
                         mul_rn(u1[(size_t)(m - 2) * keep + j], x2)),
                  du[(size_t)(m - 2) * keep + j]);
    z[(m - 2) * ld + j] = x1;
    amax = max_(abs_(x2), abs_(x1));
    auto issue = [&](int top, int buf) {
#pragma unroll
      for (int k = 0; k < kTgChunk; ++k) {
        const int i = max(top - k, 0);
        cp_async_real(&ra[slot(buf, k)], du + (size_t)i * keep + j);
        cp_async_real(&rb[slot(buf, k)], u1 + (size_t)i * keep + j);
        cp_async_real(&rc[slot(buf, k)], z + i * ld + j);
        cp_async_word(&rs[slot(buf, k)], swb + (size_t)(i >> 5) * keep + j);
      }
      cp_async_commit();
    };
    issue(m - 3, 0);
    int buf = 0;
    for (int i0 = m - 3; i0 >= 0; i0 -= kTgChunk, buf ^= 1) {
      if (i0 - kTgChunk >= 0) {
        issue(i0 - kTgChunk, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
#pragma unroll
      for (int k = 0; k < kTgChunk; ++k) {
        const int i = i0 - k;
        if (i >= 0) {
          const int o = slot(buf, k);
          const T u2 = ((rs[o] >> (i & 31)) & 1u) ? e(i + 1) : zero;
          const T t = sub_rn(sub_rn(rc[o], mul_rn(rb[o], x1)),
                             mul_rn(u2, x2));
          const T xi = div_rn(t, ra[o]);
          z[i * ld + j] = xi;
          amax = max_(amax, abs_(xi));
          x2 = x1;
          x1 = xi;
        }
      }
    }
    __threadfence_block();
    // scale by the max-abs first (a nearly singular shift leaves |x| ~
    // 1 / pivmin^2, whose square overflows), then to unit norm; the sum of
    // squares in row order
    T nrm2 = zero;
    stream(z, 0, m, [&](int, T x) {
      const T q = amax > zero ? div_rn(x, amax) : x;
      nrm2 = add_rn(nrm2, mul_rn(q, q));
    });
    s = rsqrt_rn(max_(nrm2, Real<T>::kFloor));
  }
  stream(z, 0, m, [&](int i, T x) {
    z[i * ld + j] = mul_rn(amax > zero ? div_rn(x, amax) : x, s);
  });
}

// The block's partial W = Q^T P over one slab of kTgSlab rows: grid
// (ceil(c0 / kTC), ceil(m / kTgSlab), batch); thread (columns ct + k kCT,
// quad) sums its kTgWCols x 4 entries over the slab's rows in order (a
// wider tile of Q reads P fewer times). Partial s of a matrix at wp + s
// c0 kB, W[c][p] at [c kB + p]. Dynamic shared memory: the slab's Q tile
// and P, kTgSlab (kTC + kB) reals.
template <typename T, int kB>
__global__ void __launch_bounds__(kTgProdThreads)
    tg_wpart_kernel(const T* __restrict__ z, T* __restrict__ scratch, int m,
                    int c0, int pw, long long scratch_stride) {
  constexpr int kQ = kB / 4;
  constexpr int kCT = kTgProdThreads / kQ;
  constexpr int kW = kTgWCols;
  constexpr int kTC = kCT * kW;
  using Q4 = Quad<T>;
  const size_t b = blockIdx.z;
  z += b * (size_t)m * m;
  T* wp = scratch + b * (size_t)scratch_stride;
  extern __shared__ __align__(16) unsigned char tg_raw[];
  T* Qs = reinterpret_cast<T*>(tg_raw);      // [kTgSlab][kTC]
  T* Ps = Qs + kTgSlab * kTC;                 // [kTgSlab][kB]
  const int tid = threadIdx.x;
  const int s = blockIdx.y, r0 = s * kTgSlab, nr = min(kTgSlab, m - r0);
  const int cb = blockIdx.x * kTC;
  const T zero = 0;
  for (int idx = tid; idx < nr * kTC; idx += kTgProdThreads) {
    const int i = idx / kTC, c = idx - i * kTC;
    Qs[idx] = cb + c < c0 ? z[(size_t)(r0 + i) * m + cb + c] : zero;
  }
  for (int idx = tid; idx < nr * kB; idx += kTgProdThreads) {
    const int i = idx / kB, p = idx - i * kB;
    Ps[idx] = p < pw ? z[(size_t)(r0 + i) * m + c0 + p] : zero;
  }
  __syncthreads();
  const int ct = tid / kQ, pq = tid - ct * kQ;
  const Q4* P4 = reinterpret_cast<const Q4*>(Ps);
  Q4 acc[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) acc[k] = {zero, zero, zero, zero};
  for (int i = 0; i < nr; ++i) {
    const Q4 pv = P4[i * kQ + pq];
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const T q = Qs[i * kTC + ct + k * kCT];
      acc[k].x = fma_(q, pv.x, acc[k].x);
      acc[k].y = fma_(q, pv.y, acc[k].y);
      acc[k].z = fma_(q, pv.z, acc[k].z);
      acc[k].w = fma_(q, pv.w, acc[k].w);
    }
  }
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    const int c = ct + k * kCT;
    if (cb + c < c0)
      reinterpret_cast<Q4*>(wp)[((size_t)s * c0 + cb + c) * kQ + pq] =
          acc[k];
  }
}

// W = the slab partials summed in slab order, into wp + wofs: grid
// (ceil(c0 kB / 4 / kTgProdThreads), batch), a thread a quad.
template <typename T, int kB>
__global__ void __launch_bounds__(kTgProdThreads)
    tg_wsum_kernel(T* __restrict__ scratch, int c0, int slabs, long long wofs,
                   long long scratch_stride) {
  using Q4 = Quad<T>;
  const size_t b = blockIdx.y;
  const Q4* wp = reinterpret_cast<const Q4*>(scratch + b * scratch_stride);
  Q4* W = reinterpret_cast<Q4*>(scratch + b * scratch_stride + wofs);
  const size_t n = (size_t)c0 * (kB / 4);
  const size_t idx = (size_t)blockIdx.x * kTgProdThreads + threadIdx.x;
  if (idx >= n) return;
  Q4 acc = wp[idx];
  for (int s = 1; s < slabs; ++s) {
    const Q4 v = wp[s * n + idx];
    acc.x = add_rn(acc.x, v.x);
    acc.y = add_rn(acc.y, v.y);
    acc.z = add_rn(acc.z, v.z);
    acc.w = add_rn(acc.w, v.w);
  }
  W[idx] = acc;
}

template <typename T, int kB>
constexpr size_t tg_update_smem_bytes() {
  constexpr int kTR = kTgUpdThreads / (kB / 4);
  return (round4(2 * kTR * (kTgUpdCols + 1)) + 2 * kTgUpdCols * kB) *
         sizeof(T);
}

// P -= Q W on a tile of rows: grid (ceil(m / kTR), batch); thread (row,
// quad) sums Q[i][c] W[c][p] over c in order and subtracts the sum from P.
// kTgUpdCols columns of Q and rows of W at a time go to shared memory by
// cp.async, the next ones in flight while the current ones are used.
template <typename T, int kB>
__global__ void __launch_bounds__(kTgUpdThreads)
    tg_update_kernel(T* __restrict__ z, const T* __restrict__ scratch, int m,
                     int c0, int pw, long long wofs,
                     long long scratch_stride) {
  constexpr int kQ = kB / 4;
  constexpr int kTR = kTgUpdThreads / kQ;
  constexpr int kCC = kTgUpdCols;
  using Q4 = Quad<T>;
  const size_t b = blockIdx.y;
  z += b * (size_t)m * m;
  const T* W = scratch + b * (size_t)scratch_stride + wofs;
  extern __shared__ __align__(16) unsigned char tg_raw[];
  // Qs[2][kTR][kCC + 1], then Ws[2][kCC][kB] (tg_update_smem_bytes)
  auto Qs = reinterpret_cast<T(*)[kTR][kCC + 1]>(tg_raw);
  auto Ws = reinterpret_cast<T(*)[kCC][kB]>(
      tg_raw + round4(2 * kTR * (kCC + 1)) * sizeof(T));
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kTR;
  const int row = tid / kQ, pq = tid - row * kQ;
  const T zero = 0;
  auto stage = [&](int buf, int cc) {
    for (int idx = tid; idx < kTR * kCC; idx += kTgUpdThreads) {
      const int r = idx / kCC, c = idx - r * kCC;
      if (r0 + r < m && cc + c < c0)
        cp_async_real(&Qs[buf][r][c], z + (size_t)(r0 + r) * m + cc + c);
      else
        Qs[buf][r][c] = zero;
    }
    constexpr int kChunks = kB * (int)sizeof(T) / 16;  // of a W row
    for (int idx = tid; idx < kCC * kChunks; idx += kTgUpdThreads) {
      const int c = idx / kChunks, k = idx - c * kChunks;
      T* dst = &Ws[buf][c][k * 16 / (int)sizeof(T)];
      if (cc + c < c0) {
        cp_async16(dst, W + (size_t)(cc + c) * kB + k * 16 / sizeof(T));
      } else {
#pragma unroll
        for (int l = 0; l < 16 / (int)sizeof(T); ++l) dst[l] = zero;
      }
    }
    cp_async_commit();
  };
  Q4 acc = {zero, zero, zero, zero};
  int buf = 0;
  if (c0 > 0) stage(0, 0);
  for (int cc = 0; cc < c0; cc += kCC) {
    if (cc + kCC < c0) {
      stage(buf ^ 1, cc + kCC);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kCC; ++c) {
      const T q = Qs[buf][row][c];
      const Q4 wv = reinterpret_cast<const Q4*>(Ws[buf][c])[pq];
      acc.x = fma_(q, wv.x, acc.x);
      acc.y = fma_(q, wv.y, acc.y);
      acc.z = fma_(q, wv.z, acc.z);
      acc.w = fma_(q, wv.w, acc.w);
    }
    __syncthreads();
    buf ^= 1;
  }
  const int i = r0 + row;
  if (i >= m) return;
  T* prow = z + (size_t)i * m + c0 + 4 * pq;
  const T sub4[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (4 * pq + k < pw) prow[k] = sub_rn(prow[k], sub4[k]);
}

// The 32 sums x[q] over a warp at once (transpose_sum16's levels, one
// more): afterwards x[0] of lane q is the sum of x[q].
template <typename T>
__device__ __forceinline__ void transpose_sum32(T (&x)[32], int lane) {
  halve_sums<16, 16>(x, lane);
  halve_sums<8, 8>(x, lane);
  halve_sums<4, 4>(x, lane);
  halve_sums<2, 2>(x, lane);
  halve_sums<1, 1>(x, lane);
}

// The in-block kernel's dynamic shared memory, in reals: the reduction
// slots [2][G][kB], then the block's rows, R x (kB + 16 bytes).
template <typename T, int kB>
__host__ __device__ constexpr int tg_in_ld() {
  return kB + 16 / (int)sizeof(T);
}
template <typename T, int kB>
__host__ __device__ inline long long tg_in_smem_reals(int G, int R) {
  return round4(2 * G * kB) + (long long)R * tg_in_ld<T, kB>();
}

// CGS2 inside the block of columns [c0, c0 + pw): grid batch x G, clusters
// of G on x; rank r holds rows [r R, r R + R) of the block in shared memory
// (16-byte rows padded by 16 bytes: a warp's rows fall on distinct banks).
// Each thread keeps its rows (t, t + kTgInThreads, ...) for the whole
// kernel. A pass reads only the columns before p, by groups of 8 behind a
// branch that is uniform over the CTA; its dots are summed over the
// thread's rows in order, over each warp by transpose_sum32, over the
// CTA's warps in order, then over the ranks in order from the slots that
// each rank posts into every rank (one block and one cluster barrier a
// reduction). kGlobal: past where a rank's rows fit in its shared memory
// (double past m = 13,056 at 16 ranks), each rank keeps its rows in the
// same layout in global memory (gblk + b gstride, row i at i kLd: its own
// rows only, so no other CTA reads them), the slots stay in shared memory;
// the arithmetic, and so every bit, is the shared-memory route's.
template <typename T, int kB, bool kGlobal>
__global__ void __launch_bounds__(kTgInThreads, 1)
    tg_inblock_kernel(T* __restrict__ z, int m, int c0, int pw, int R,
                      T* gblk, long long gstride) {
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const size_t b = blockIdx.x / G;
  z += b * (size_t)m * m;
  constexpr int kLd = tg_in_ld<T, kB>();
  constexpr int kGroups = kB / 8;
  using Q4 = Quad<T>;
  extern __shared__ __align__(16) unsigned char tg_raw[];
  T* slot = reinterpret_cast<T*>(tg_raw);
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int r0 = rank * R, nr = max(0, min(R, m - r0));
  T* blk = kGlobal ? gblk + b * (size_t)gstride + (size_t)r0 * kLd
                   : slot + round4(2 * G * kB);
  const T zero = 0;
  for (int idx = tid; idx < nr * kB; idx += kTgInThreads) {
    const int i = idx / kB, p = idx - i * kB;
    blk[i * kLd + p] = p < pw ? z[(size_t)(r0 + i) * m + c0 + p] : zero;
  }
  cluster.sync();  // the rows are in place, and every rank has started
  static_assert(kB == 32, "a dot a lane");
  __shared__ T red[2][kTgInWarps][kB];
  int buf = 0;
  // this warp's sum for dot `lane` (x): summed over the CTA's warps in order,
  // posted into every rank's slots (warp s to rank s, s + kTgInWarps, ..),
  // one cluster barrier, then summed over the ranks in order. The slots
  // and red are double-buffered: a rank
  // posts reduction n + 2 only after the barrier of n + 1, which every rank
  // passes after reading reduction n's slots.
  auto reduce = [&](T x) {
    red[buf][wp][lane] = x;
    __syncthreads();
    T cta = red[buf][0][lane];
#pragma unroll
    for (int w = 1; w < kTgInWarps; ++w) cta += red[buf][w][lane];
    for (int s = wp; s < G; s += kTgInWarps)
      cluster.map_shared_rank(slot, s)[(buf * G + rank) * kB + lane] = cta;
    cluster.sync();
    T tot = slot[buf * G * kB + lane];
#pragma unroll 4
    for (int s = 1; s < G; ++s) tot += slot[(buf * G + s) * kB + lane];
    buf ^= 1;
    return tot;
  };
  for (int p = 0; p < pw; ++p) {
    if (c0 + p == 0) continue;  // column 0 keeps its iterate
    for (int pass = 0; p > 0 && pass < 2; ++pass) {
      T part[kB];
#pragma unroll
      for (int q = 0; q < kB; ++q) part[q] = zero;
      for (int i = tid; i < nr; i += kTgInThreads) {
        const T* row = blk + i * kLd;
        const Q4* row4 = reinterpret_cast<const Q4*>(row);
        const T vi = row[p];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          if (8 * g < p) {
            const Q4 a = row4[2 * g], c = row4[2 * g + 1];
            const T x[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
            for (int k = 0; k < 8; ++k)
              part[8 * g + k] = fma_(x[k], vi, part[8 * g + k]);
          }
        }
      }
      transpose_sum32(part, lane);
      const T dots = reduce(part[0]);
      T neg[kB];
#pragma unroll
      for (int q = 0; q < kB; ++q) {
        const T dq = __shfl_sync(0xffffffffu, dots, q);
        neg[q] = q < p ? -dq : zero;
      }
      for (int i = tid; i < nr; i += kTgInThreads) {
        T* row = blk + i * kLd;
        const Q4* row4 = reinterpret_cast<const Q4*>(row);
        T vi = row[p];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          if (8 * g < p) {
            const Q4 a = row4[2 * g], c = row4[2 * g + 1];
            const T x[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
            for (int k = 0; k < 8; ++k) vi = fma_(neg[8 * g + k], x[k], vi);
          }
        }
        row[p] = vi;
      }
    }
    T sq = zero;
    for (int i = tid; i < nr; i += kTgInThreads) {
      const T vi = blk[i * kLd + p];
      sq = fma_(vi, vi, sq);
    }
    sq = warp_sum(sq);
    const T tot = __shfl_sync(0xffffffffu, reduce(sq), 0);
    const T scl = rsqrt_rn(max_(tot, Real<T>::kFloor));
    for (int i = tid; i < nr; i += kTgInThreads) blk[i * kLd + p] *= scl;
  }
  __syncthreads();  // the last column scaled by its rows' threads, read by all
  for (int idx = tid; idx < nr * pw; idx += kTgInThreads) {
    const int i = idx / pw, p = idx - i * pw;
    z[(size_t)(r0 + i) * m + c0 + p] = blk[i * kLd + p];
  }
  cluster.sync();  // no CTA leaves while another may still post to it
}

// K2's wide variant: tridiag_kernel's Householder steps on a thread-block
// cluster of G = ceil(m / 16) CTAs a matrix (at most 16; 8 where the card
// refuses 16), for complex64 at 128 < m <= 640 and complex128 at m <= 438,
// where every row fits in the cluster's shared memory (past that,
// csrc/tridiag_grid.cu's card-wide route). One CTA a matrix (the first design) used one SM of 132, kept A
// in global memory and streamed the trailing block through that SM's L1/L2
// three times a step (the product u half its cycles, the update the other
// half, tools/stage_clocks.py), divided per element in the rank-2 update,
// and paid a step for every exactly inactive column. Here:
//   - CTA r holds rows r, r + G, r + 2G, .. (dealt cyclically, as tri_row
//     deals them over row groups, so that the trailing block stays spread
//     over every CTA to the last steps), whole rows of m entries, in its
//     shared memory: all of its R = ceil(m / G) rows;
//   - a warp a row: u_i = sum_j A[i][j] v_j with a shuffle reduction, and
//     the rank-2 update over the row's trailing entries (coalesced, no
//     integer division), rounded as written, so that A stays exactly
//     Hermitian and each row, conjugated, is its column;
//   - one all-to-all exchange a step. A step k begins when its message
//     arrives: v, tau and whether the step is active, bulk-copied
//     (cp.async.bulk, completing on each CTA's mbarrier) by the owner of
//     row k from its shared memory into every CTA's. Every CTA forms u for
//     its rows below k and stores each u_i into every CTA's copy of u; it
//     then releases a per-CTA step counter in every CTA, and every warp
//     acquires all G counters (cheaper than a cluster barrier, which
//     would also wait for every thread of every CTA). Every
//     warp sums s = v^H u over the rows in order (the same sum in every warp
//     of every CTA, whatever G, so a batch and a rerun equal their P = 1
//     launch bit for bit), forms w_j from u_j and v_j with round-to-nearest
//     operations (the same bits wherever it is formed) and updates its rows,
//     summing each row's squares right of the diagonal as it goes. The
//     owner of row k + 1 updates that row first (it is its warp 0's first
//     row) and at once sends the next message: the reflector (sum of
//     squares, the scaled norm below the tiny threshold, the scalars, v) or
//     "inactive" where the sum is zero;
//   - inactive steps: a sum of rounded squares is zero exactly when each
//     square is, so the per-row flags find exactly the steps whose column
//     is zero, whatever the order of the sums. On an "inactive" message
//     every CTA posts its first flagged row and one cluster barrier later
//     the least of them is the next active step, whose owner sends its
//     reflector; the run between is written as identity rows (tau = e = 0)
//     by their rows' owners, with no step;
//   - the buffers that a faster CTA may write while a slower one still
//     reads them (v and u) are double-buffered by step; a CTA reaches a
//     step's buffers only after every CTA has posted the last step's u,
//     which each posts after it has read the buffers of the step before.
//     A block barrier ends each step (a row's warp changes between steps);
//   - the CTAs write d for their rows at the end, after which a last
//     cluster barrier keeps every CTA's shared memory alive until no other
//     CTA reads it.
// A batch of P matrices is P clusters on grid x.
constexpr int kTcMaxRows = 128;  // rows a CTA: its flags (40 at m = 640)
constexpr int kTcRowsPerCta = 16;  // G = ceil(m / 16), at most 16

// tridiag_cluster_kernel's dynamic shared memory, in complex elements: the
// rs rows a CTA holds (m each), then from a 16-byte boundary the messages
// (two buffers), u of every row (two buffers) and the CTA's own message
// (m + 2 each, rounded to 16 bytes: entries m and m + 1 carry tau and the
// active bit, and the bulk copy moves whole 16-byte units).
__host__ __device__ inline int tc_vec_elems(int m) { return (m + 3) & ~1; }
__host__ __device__ inline size_t tc_rows_elems(int m, int rs) {
  return ((size_t)rs * m + 1) & ~(size_t)1;
}
__host__ __device__ inline size_t tc_smem_elems(int m, int rs) {
  return tc_rows_elems(m, rs) + 5 * (size_t)tc_vec_elems(m);
}

// One thread: bulk-copy `bytes` (a multiple of 16) of this CTA's shared
// memory at src into CTA `rank`'s shared memory at the address of dst in
// this CTA, completing the bytes on that CTA's mbarrier at bar's address.
__device__ __forceinline__ void bulk_push_remote(void* dst, int rank,
                                                 const void* src,
                                                 uint32_t bytes,
                                                 uint64_t* bar) {
  uint32_t rdst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rdst) : "r"(adaptaqc::smem_addr(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rbar) : "r"(adaptaqc::smem_addr(bar)), "r"(rank));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(rdst),
      "r"(adaptaqc::smem_addr(src)), "r"(bytes), "r"(rbar)
      : "memory");
}

// A store of v to CTA-shared memory of the cluster with release semantics
// at cluster scope, and a load of this CTA's with acquire semantics.
__device__ __forceinline__ void st_release_cluster(int* p, int v) {
  asm volatile("st.release.cluster.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ int ld_acquire_cluster(const int* p) {
  int v;
  asm volatile("ld.acquire.cluster.s32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// This thread's arrival on bar, expecting `bytes` more to complete.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(adaptaqc::smem_addr(bar)), "r"(bytes)
               : "memory");
}

// w_j = tau (u_j - (conj(tau) s / 2) v_j), rounded as written: every CTA
// and warp that forms w_j gets the same bits.
template <typename V, typename T>
__device__ __forceinline__ V tc_w(V u, V v, T tr, T ti, T t2r, T t2i) {
  const T pr = sub_rn(u.x, sub_rn(mul_rn(t2r, v.x), mul_rn(t2i, v.y)));
  const T pi = sub_rn(u.y, add_rn(mul_rn(t2r, v.y), mul_rn(t2i, v.x)));
  return make_c(sub_rn(mul_rn(tr, pr), mul_rn(ti, pi)),
                add_rn(mul_rn(tr, pi), mul_rn(ti, pr)));
}

// Whether any square right of the diagonal of row i is nonzero (a warp).
template <typename V>
__device__ __forceinline__ bool tc_row_flag(const V* r, int i, int m,
                                            int lane) {
  using T = decltype(V::x);
  bool nz = false;
  for (int j = i + 1 + lane; j < m; j += 32) {
    const V a = r[j];
    nz |= mul_rn(a.x, a.x) > T(0) || mul_rn(a.y, a.y) > T(0);
  }
  return __any_sync(0xffffffffu, nz);
}

// Grid: batch x G CTAs of kClThreads, clusters of G along x (cluster b is
// matrix b); rs: the rows a CTA holds, ceil(m / G).
template <typename T>
__global__ void __launch_bounds__(kClThreads, 1)
    tridiag_cluster_kernel(const typename Real<T>::C* __restrict__ h,
                           typename Real<T>::C* __restrict__ vrows,
                           typename Real<T>::C* __restrict__ tau_out,
                           T* __restrict__ d_out, T* __restrict__ e_out,
                           int m, int rs, long long h_stride) {
  using V = typename Real<T>::C;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  {
    const size_t b = blockIdx.x / G;
    h += b * (size_t)h_stride;
    vrows += b * (size_t)m * m;
    tau_out += b * m;
    d_out += b * m;
    e_out += b * m;
  }
  extern __shared__ __align__(16) unsigned char tsm_raw[];
  const int mv = tc_vec_elems(m);
  V* As = reinterpret_cast<V*>(tsm_raw);      // this CTA's rows, m each
  V* Vv = As + tc_rows_elems(m, rs);          // v of a step, 2 buffers
  V* U = Vv + 2 * mv;                         // u of every row, 2 buffers
  V* Vc = U + 2 * mv;                         // this CTA's reflector
  __shared__ int cand[kClMaxCluster];   // every CTA's first flagged row
  __shared__ int uflag[kClMaxCluster];  // the steps whose u each CTA posted
  __shared__ int flag[kTcMaxRows];
  __shared__ T scal[3];                 // the reflector's tau and e
  __shared__ __align__(8) uint64_t vbar;  // a step's message in Vv
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kClThreads / 32;
  const int nr = (m - rank + G - 1) / G;  // rows rank + l G, l < nr
  const T zero = 0, one = 1;
  const V czero = make_c(zero, zero);
  auto row = [&](int l) -> V* { return As + (size_t)l * m; };
  // the first of this CTA's rows at or past i
  auto first_row = [&](int i) { return i > rank ? (i - rank + G - 1) / G : 0; };
  // a cluster barrier; a block barrier where the cluster is one CTA
  auto csync = [&] {
    if (G == 1)
      __syncthreads();
    else
      cluster.sync();
  };
  // the message of step c: v (entries c + 1 .. m - 1), tau at m and at
  // m + 1 whether the step is active, from a 16-byte aligned start
  auto msg_start = [&](int c) { return (c + 1) & ~(int)(16 / sizeof(V) - 1); };
  auto msg_bytes = [&](int c) {
    return (uint32_t)(((m + 2 - msg_start(c)) * sizeof(V) + 15) & ~15u);
  };
  // one warp: Vc's message of step c bulk-copied into every CTA's buffer p1
  auto send = [&](int c, int p1) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane < G) {
      const int a = msg_start(c);
      bulk_push_remote(Vv + (size_t)p1 * mv + a, lane, Vc + a, msg_bytes(c),
                       &vbar);
    }
  };
  // the sum of squares right of the diagonal, a lane's part of an entry
  auto sq = [&](V a) { return add_rn(mul_rn(a.x, a.x), mul_rn(a.y, a.y)); };

  // one warp: the reflector of row c (column c conjugated, ss its sum of
  // squares, or negative: summed here) into Vc and scal, sent as step c's
  // message into buffer p1
  auto reflector = [&](int c, T ss, int p1) {
    const V* r = row((c - rank) / G);
    if (ss < zero) {
      T part = zero;
      for (int j = c + 1 + lane; j < m; j += 32) part = add_rn(part, sq(r[j]));
      ss = warp_sum(part);
    }
    const T nrm = ss < Real<T>::kTiny ? scaled_norm(r, c, m, lane)
                                      : sqrt_(ss);
    const V alpha = r[c + 1];  // conj(A[c+1][c])
    const T inv = one / nrm;
    const T ahr = alpha.x * inv, ahi = -alpha.y * inv;
    const T bh = (ahr >= zero) ? -one : one;
    const T tr = one - ahr * bh, ti = -ahi * bh;
    const T dr = ahr - bh, di = ahi;
    const T gs = inv / (dr * dr + di * di);
    const V gam = make_c(dr * gs, -di * gs);  // v_j = gam conj(A[c][j])
    for (int j = c + 1 + lane; j < m; j += 32) {
      const V a = r[j];
      Vc[j] = j == c + 1 ? make_c(one, zero) : cmul(gam, make_c(a.x, -a.y));
    }
    if (lane == 0) {
      Vc[m] = make_c(tr, ti);
      Vc[m + 1] = make_c(one, zero);  // active
      scal[0] = tr;
      scal[1] = ti;
      scal[2] = bh * nrm;
    }
    send(c, p1);
  };
  // the least flagged row past kp over the cluster (m - 1: none): each
  // CTA posts its first (a scan of its flags), then a cluster barrier
  auto next_active = [&](int kp) {
    __syncthreads();
    if (warp == 0) {
      int c = m - 1;
      for (int base = first_row(kp + 1); base < nr; base += 32) {
        const int l = base + lane;
        const unsigned mask = __ballot_sync(0xffffffffu, l < nr && flag[l]);
        if (mask) {
          c = rank + (base + __ffs(mask) - 1) * G;
          break;
        }
      }
      if (lane < G) cluster.map_shared_rank(cand, lane)[rank] = c;
    }
    csync();
    return __reduce_min_sync(0xffffffffu, lane < G ? cand[lane] : m);
  };
  // identity rows, tau = e = 0, for this CTA's rows in [from, to)
  auto identity = [&](int from, int to) {
    for (int l = first_row(from) + warp; l < nr && rank + l * G < to;
         l += kWarps) {
      const int i = rank + l * G;
      for (int j = lane; j < m; j += 32)
        vrows[(size_t)i * m + j] = make_c(j == i + 1 ? one : zero, zero);
      if (lane == 0) {
        tau_out[i] = czero;
        e_out[i] = zero;
      }
    }
  };

  if (tid == 0) mbar_init(&vbar);
  if (tid < G) uflag[tid] = 0;
  for (int l = warp; l < nr; l += kWarps) {
    const V* src = h + (size_t)(rank + l * G) * m;
    V* dst = row(l);
    for (int j = lane; j < m; j += 32) dst[j] = src[j];
  }
  if (rank == (m - 1) % G) {
    for (int j = tid; j < m; j += kClThreads)
      vrows[(size_t)(m - 1) * m + j] = czero;
    if (tid == 0) {
      tau_out[m - 1] = czero;
      e_out[m - 1] = zero;
    }
  }
  __syncthreads();
  for (int l = warp; l < nr; l += kWarps) {
    const int i = rank + l * G;
    const bool f = tc_row_flag(row(l), i, m, lane);
    if (lane == 0) flag[l] = f;
  }
  cluster.sync();  // every CTA has started: remote stores may begin

  int k = next_active(-1);
  identity(0, k);
  if (k < m - 1 && rank == k % G && warp == 0) reflector(k, -one, 0);
  uint32_t vph = 0;  // vbar's phase
  for (int it = 0; k < m - 1;) {
    const int p = it & 1;
    V* vk = Vv + (size_t)p * mv;
    V* uk = U + (size_t)p * mv;
    if (tid == 0) mbar_expect_tx(&vbar, msg_bytes(k));
    mbar_wait(&vbar, vph);
    vph ^= 1;
    if (vk[m + 1].x == zero) {
      // row k's owner found its column zero: the next active step is the
      // least flagged row past k, whose owner forms and sends its
      // reflector into the same buffer (every CTA has read this message)
      const int kn = next_active(k);
      identity(k, kn);
      k = kn;
      if (k < m - 1 && rank == k % G && warp == 0) reflector(k, -one, p);
      continue;
    }
    const int k1 = k + 1;
    if (rank == k % G) {
      for (int j = tid; j < m; j += kClThreads)
        vrows[(size_t)k * m + j] = j <= k ? czero : vk[j];
      if (tid == 0) {
        tau_out[k] = make_c(scal[0], scal[1]);
        e_out[k] = scal[2];
      }
    }
    const T tr = vk[m].x, ti = vk[m].y;
    const int l0 = first_row(k1);
    // u_i = sum_j A[i][j] v_j for this CTA's rows below k, posted to all
    for (int l = l0 + warp; l < nr; l += kWarps) {
      const V* r = row(l);
      V acc = czero;
#pragma unroll 4
      for (int j = k1 + lane; j < m; j += 32) cfma(acc, r[j], vk[j]);
      acc = warp_sum2(acc);
      if (lane < G) cluster.map_shared_rank(uk, lane)[rank + l * G] = acc;
    }
    // every CTA's u: each CTA releases its post of step it to every CTA
    // (uflag, after a block barrier), and every warp acquires all of them
    __syncthreads();
    if (tid < G)
      st_release_cluster(cluster.map_shared_rank(uflag, tid) + rank, it + 1);
    for (;;) {
      const int f = lane < G ? ld_acquire_cluster(uflag + lane) : it + 1;
      if (__all_sync(0xffffffffu, f > it)) break;
    }
    __syncwarp();
    if (l0 + warp < nr) {
      V sp = czero;  // s = v^H u, in row order
#pragma unroll 4
      for (int j = k1 + lane; j < m; j += 32) cfma_conj(sp, vk[j], uk[j]);
      sp = warp_sum2(sp);
      const T half = T(0.5);
      const T t2r = mul_rn(add_rn(mul_rn(tr, sp.x), mul_rn(ti, sp.y)), half);
      const T t2i = mul_rn(sub_rn(mul_rn(tr, sp.y), mul_rn(ti, sp.x)), half);
      // A[i][j] -= v_i conj(w_j) + w_i conj(v_j) on the trailing entries,
      // rounded as written: the update of A[j][i] is exactly the conjugate
      for (int l = l0 + warp; l < nr; l += kWarps) {
        const int i = rank + l * G;
        V* r = row(l);
        const V va = vk[i], wa = tc_w(uk[i], va, tr, ti, t2r, t2i);
        T part = zero;  // the row's squares right of the diagonal
#pragma unroll 4
        for (int j = k1 + lane; j < m; j += 32) {
          const V vb = vk[j], wb = tc_w(uk[j], vb, tr, ti, t2r, t2i);
          const T re = add_rn(add_rn(mul_rn(va.x, wb.x), mul_rn(va.y, wb.y)),
                              add_rn(mul_rn(wa.x, vb.x), mul_rn(wa.y, vb.y)));
          const T im = add_rn(sub_rn(mul_rn(va.y, wb.x), mul_rn(va.x, wb.y)),
                              sub_rn(mul_rn(wa.y, vb.x), mul_rn(wa.x, vb.y)));
          const V a0 = r[j];
          const V a = make_c(sub_rn(a0.x, re), sub_rn(a0.y, im));
          r[j] = a;
          if (j > i) part = add_rn(part, sq(a));
        }
        // zero exactly when every square is: the row's column is inactive
        const T ss = warp_sum(part);
        if (lane == 0) flag[l] = ss > zero;
        // row k + 1 (warp 0's first row, where this CTA holds it) is
        // the next step: its owner sends its message at once, ahead of
        // its other rows, the reflector or "inactive"
        if (l == l0 && i == k1 && k1 < m - 1) {
          __syncwarp();  // the row's entries, written by other lanes
          if (ss > zero) {
            reflector(k1, ss, p ^ 1);
          } else {
            if (lane == 0) Vc[m + 1] = czero;
            send(k1, p ^ 1);
          }
        }
      }
    }
    // every row is updated before any warp reads it for the next step (a
    // row's warp changes from one step to the next)
    __syncthreads();
    k = k1;
    ++it;
  }
  for (int l = warp; l < nr; l += kWarps) {
    const int i = rank + l * G;
    if (lane == 0) d_out[i] = row(l)[i].x;
  }
  cluster.sync();  // no CTA leaves while another may read its memory
}

// The wide variants' launches for real type T: m from lo, batch matrices;
// `scratch` (teig: batch x teig_wide_scratch(m) reals) is the caller's, as
// every output.
// K3's cluster plan for m and real type T: the cluster size G, the lanes a
// CTA L (a multiple of kPanel), whether the LU factors fit in shared
// memory, and the dynamic shared memory a CTA. G = ceil(m / 32) CTAs where
// that is at most 8 or a cluster of 16 fits on the card (non-portable
// size, cudaOccupancyMaxActiveClusters), else 8 with longer lanes; only
// where the iterate's columns fit in shared memory and m <= kClMaxM. Returns
// a plan with G = 0 (and sets *err) where the cluster route does not take
// m: teig_grid takes it.
struct TeigPlan {
  int G, L, lu_smem;
  size_t smem;
};

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int grid, int G,
                                  size_t smem, cudaStream_t stream,
                                  int threads = kClThreads) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
TeigPlan teig_plan(int m, cudaError_t* err) {
  static TeigPlan cached[kClMaxM + 1] = {};
  *err = cudaErrorInvalidConfiguration;
  if (m > kClMaxM) return TeigPlan{};
  if (cached[m].G) return cached[m];
  int dev = 0, optin = 0;
  const void* fn = (const void*)teig_cluster_kernel<T>;
  cudaFuncAttributes fa;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess ||
      (*err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (*err = cudaFuncGetAttributes(&fa, fn)) != cudaSuccess ||
      (*err = cudaFuncSetAttribute(
           fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return TeigPlan{};
  const size_t budget = (size_t)optin - fa.sharedSizeBytes;
  for (int cap : {kClMaxCluster, 8}) {
    const int L = cl_lanes(m, cap);
    TeigPlan pl;
    pl.L = L;
    pl.G = (m + L - 1) / L;
    pl.lu_smem =
        (size_t)cl_layout<T>(m, L, true).total * sizeof(T) <= budget;
    pl.smem = (size_t)cl_layout<T>(m, L, pl.lu_smem).total * sizeof(T);
    if (pl.smem > budget) continue;
    if ((*err = cudaFuncSetAttribute(
             fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)pl.smem)) != cudaSuccess)
      return TeigPlan{};
    if (pl.G <= 8) {
      cached[m] = pl;
      return pl;
    }
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(attr, pl.G, pl.G, pl.smem, 0);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg) == cudaSuccess &&
        clusters >= 1) {
      cached[m] = pl;
      return pl;
    }
    cudaGetLastError();  // a refused query is not an error of the launch
  }
  *err = cudaErrorInvalidConfiguration;
  return TeigPlan{};
}

// teig_grid's plan for m and real type T: its block width kB, the CTAs G of
// the in-block kernel's cluster (the fewest whose shared memory holds the
// block's m rows, at least ceil(m / kTgInRows), at most kTgMaxCluster,
// checked to fit on the card past 8), the rows a rank R = ceil(m / G), the
// W partials' slabs and the in-block kernel's dynamic shared memory; and
// `global`, the stages that read their operands from global memory because
// they do not fit in one CTA's shared memory (each at keep = m, so the
// route is m's alone): kTgGlobalBisect (d and e2, 2 m reals: double past
// m = 14,518), kTgGlobalInvit (d, e and w with the rings: double past m =
// 8,488), kTgGlobalInblock (no cluster of 16 holds the block's rows:
// double past m = 13,056; G is then ceil(m / kTgInRows), at most 16, and
// the rows lie in `scratch`). Those stages compute the same bits as where
// they fit, and to m = 8,488 in double (every m the route takes in
// float to 16384) nothing reads from global memory. G = 0 (and *err set)
// where no cluster launches.
constexpr int kTgBlock = 32;  // columns a block of the BCGS2
constexpr int kTgGlobalBisect = 1, kTgGlobalInvit = 2, kTgGlobalInblock = 4;
struct TgPlan {
  int kB, G, R, slabs, global;
  size_t smem_in;
};

// The static shared memory of a kernel, in bytes (what the opt-in size
// leaves for its dynamic part is the rest); -1 on error.
inline long long tg_static_smem(const void* fn) {
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, fn) != cudaSuccess) return -1;
  return (long long)fa.sharedSizeBytes;
}

template <typename T, int kB>
TgPlan tg_plan_for(int m, cudaError_t* err) {
  int dev = 0, optin = 0;
  const void* fn = (const void*)tg_inblock_kernel<T, kB, false>;
  cudaFuncAttributes fa;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess ||
      (*err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (*err = cudaFuncGetAttributes(&fa, fn)) != cudaSuccess ||
      (*err = cudaFuncSetAttribute(
           fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return TgPlan{};
  const long long st_bisect =
      tg_static_smem((const void*)tg_bisect_kernel<T, false>);
  const long long st_invit =
      tg_static_smem((const void*)tg_invit_kernel<T, false>);
  if (st_bisect < 0 || st_invit < 0) {
    *err = cudaErrorInvalidDeviceFunction;
    return TgPlan{};
  }
  int global = 0;
  if (2LL * m * (long long)sizeof(T) + st_bisect > optin)
    global |= kTgGlobalBisect;
  if ((long long)tg_invit_smem_reals<T>(m, m) * (long long)sizeof(T) +
          st_invit > optin)
    global |= kTgGlobalInvit;
  const size_t budget = (size_t)optin - fa.sharedSizeBytes;
  auto fits = [&](const void* f, TgPlan& pl) {
    if ((*err = cudaFuncSetAttribute(
             f, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)pl.smem_in)) != cudaSuccess)
      return false;
    if (pl.G <= 8) return true;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg =
        cluster_config(attr, pl.G, pl.G, pl.smem_in, 0, kTgInThreads);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, f, &cfg) == cudaSuccess &&
        clusters >= 1)
      return true;
    cudaGetLastError();  // a refused query is not an error of the launch
    *err = cudaSuccess;
    return false;
  };
  // at least ceil(m / kTgInRows) CTAs: the column loop's shared-memory
  // reads, and its rows a thread, spread over more SMs
  const int g0 = min((m + kTgInRows - 1) / kTgInRows, kTgMaxCluster);
  for (int G = g0; G <= kTgMaxCluster; ++G) {
    TgPlan pl;
    pl.kB = kB;
    pl.G = G;
    pl.R = (m + G - 1) / G;
    pl.slabs = (m + kTgSlab - 1) / kTgSlab;
    pl.global = global;
    pl.smem_in = (size_t)tg_in_smem_reals<T, kB>(G, pl.R) * sizeof(T);
    if (pl.smem_in > budget) continue;
    if (fits(fn, pl)) return pl;
    if (*err != cudaSuccess) return TgPlan{};
  }
  // no cluster holds the rows: each rank keeps its rows in global memory
  const void* fg = (const void*)tg_inblock_kernel<T, kB, true>;
  if ((*err = cudaFuncSetAttribute(
           fg, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
      cudaSuccess)
    return TgPlan{};
  TgPlan pl;
  pl.kB = kB;
  pl.G = g0;
  pl.R = (m + g0 - 1) / g0;
  pl.slabs = (m + kTgSlab - 1) / kTgSlab;
  pl.global = global | kTgGlobalInblock;
  pl.smem_in = (size_t)round4(2 * g0 * kB) * sizeof(T);
  if (fits(fg, pl)) return pl;
  if (*err == cudaSuccess) *err = cudaErrorInvalidConfiguration;
  return TgPlan{};
}

template <typename T>
TgPlan tg_plan(int m, cudaError_t* err) {
  static std::unordered_map<int, TgPlan> cached;
  const auto it = cached.find(m);
  if (it != cached.end()) return it->second;
  const TgPlan pl = tg_plan_for<T, kTgBlock>(m, err);
  if (pl.G) cached[m] = pl;
  return pl;
}

// teig_grid's scratch a matrix, in reals of real_bytes: the LU factors
// during the inverse iteration, then, over them, the W partials (slabs x
// keep x kB) and W (keep x kB) from wofs, then from tg_blk_ofs the
// in-block kernel's rows where they lie in global memory (m rows of at most
// kB + 4 reals: tg_in_ld).
__host__ __device__ inline long long tg_wofs(int m, int keep, int kB) {
  return ((long long)((m + kTgSlab - 1) / kTgSlab) * keep * kB + 3) & ~3LL;
}
__host__ __device__ inline long long tg_blk_ofs(int m, int keep, int kB) {
  return (tg_wofs(m, keep, kB) + (long long)keep * kB + 3) & ~3LL;
}
inline long long tg_scratch_reals(int m, int keep, int kB, int real_bytes) {
  const long long lu = tg_lu_reals(m, keep, real_bytes);
  const long long prod = tg_blk_ofs(m, keep, kB) + (long long)m * (kB + 4);
  return lu > prod ? lu : prod;
}

template <typename T, int kB>
int tg_run(const T* d, const T* e, const T* b0, T* w, T* z, T* scratch,
           int m, int keep, int batch, long long d_stride,
           long long e_stride, long long scratch_stride, const TgPlan& pl,
           cudaStream_t st) {
  constexpr int kQ = kB / 4;
  constexpr int kTC = kTgProdThreads / kQ * kTgWCols;
  constexpr int kTR = kTgUpdThreads / kQ;
  const bool g_bisect = pl.global & kTgGlobalBisect;
  const bool g_invit = pl.global & kTgGlobalInvit;
  const bool g_in = pl.global & kTgGlobalInblock;
  auto* bisect = g_bisect ? tg_bisect_kernel<T, true>
                          : tg_bisect_kernel<T, false>;
  auto* invit = g_invit ? tg_invit_kernel<T, true> : tg_invit_kernel<T, false>;
  auto* inblock = g_in ? tg_inblock_kernel<T, kB, true>
                       : tg_inblock_kernel<T, kB, false>;
  const size_t sm_bisect = g_bisect ? 0 : 2 * (size_t)m * sizeof(T);
  const size_t sm_invit =
      (size_t)(g_invit ? tg_invit_smem_reals<T, true>(m, keep)
                       : tg_invit_smem_reals<T>(m, keep)) *
      sizeof(T);
  const size_t sm_update = tg_update_smem_bytes<T, kB>();
  const size_t sm_wpart = (size_t)kTgSlab * (kTC + kB) * sizeof(T);
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      bisect, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_bisect));
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      invit, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_invit));
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      tg_wpart_kernel<T, kB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm_wpart));
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      tg_update_kernel<T, kB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm_update));
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      inblock, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      inblock, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pl.smem_in));
  bisect<<<dim3((keep + kTgBisectLanes - 1) / kTgBisectLanes, batch),
           kTgThreads, sm_bisect, st>>>(d, e, w, m, keep, d_stride,
                                        e_stride);
  ADAPTAQC_RETURN_IF_ERR(cudaGetLastError());
  invit<<<dim3((keep + kTgInvThreads - 1) / kTgInvThreads, batch),
          kTgInvThreads, sm_invit, st>>>(d, e, b0, w, z, scratch, m, keep,
                                         d_stride, e_stride, scratch_stride);
  ADAPTAQC_RETURN_IF_ERR(cudaGetLastError());
  const long long wofs = tg_wofs(m, keep, kB);
  // the in-block kernel's rows where they lie in global memory: past W
  T* gblk = scratch + tg_blk_ofs(m, keep, kB);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      attr, batch * pl.G, pl.G, pl.smem_in, st, kTgInThreads);
  for (int c0 = 0; c0 < keep; c0 += kB) {
    const int pw = min(kB, keep - c0);
    for (int pass = 0; c0 > 0 && pass < 2; ++pass) {
      tg_wpart_kernel<T, kB>
          <<<dim3((c0 + kTC - 1) / kTC, pl.slabs, batch), kTgProdThreads,
             sm_wpart, st>>>(z, scratch, m, c0, pw, scratch_stride);
      tg_wsum_kernel<T, kB>
          <<<dim3((c0 * kQ + kTgProdThreads - 1) / kTgProdThreads, batch),
             kTgProdThreads, 0, st>>>(scratch, c0, pl.slabs, wofs,
                                      scratch_stride);
      tg_update_kernel<T, kB>
          <<<dim3((m + kTR - 1) / kTR, batch), kTgUpdThreads, sm_update,
             st>>>(
              z, scratch, m, c0, pw, wofs, scratch_stride);
    }
    ADAPTAQC_RETURN_IF_ERR(cudaLaunchKernelEx(&cfg, inblock, z, m, c0, pw,
                                              pl.R, gblk, scratch_stride));
  }
  return (int)cudaGetLastError();
}

// K2's cluster plan for m and real type T: the cluster size G, the rows a
// CTA R = ceil(m / G), all in its shared memory, and the dynamic shared
// memory a CTA. G = ceil(m / 16) CTAs where that is at most 8 or a cluster
// of that size fits on the card (non-portable size,
// cudaOccupancyMaxActiveClusters), else 8. Returns a plan with G = 0 (and
// sets *err) where the rows do not fit: the card-wide route
// (csrc/tridiag_grid.cu) takes m there.
struct TridiagPlan {
  int G, R;
  size_t smem;
};

template <typename T>
TridiagPlan tridiag_plan(int m, cudaError_t* err) {
  using V = typename Real<T>::C;
  static TridiagPlan cached[kTcMaxM + 1] = {};
  *err = cudaErrorInvalidConfiguration;
  if (m > kTcMaxM) return TridiagPlan{};
  if (cached[m].G) return cached[m];
  const void* fn = (const void*)tridiag_cluster_kernel<T>;
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess ||
      (*err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (*err = cudaFuncGetAttributes(&fa, fn)) != cudaSuccess ||
      (*err = cudaFuncSetAttribute(
           fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return TridiagPlan{};
  const size_t budget = (size_t)optin - fa.sharedSizeBytes;
  const int want = (m + kTcRowsPerCta - 1) / kTcRowsPerCta;
  for (int cap : {kClMaxCluster, 8}) {
    TridiagPlan pl;
    pl.G = want < cap ? want : cap;
    pl.R = (m + pl.G - 1) / pl.G;
    pl.smem = tc_smem_elems(m, pl.R) * sizeof(V);
    if (pl.R > kTcMaxRows || pl.smem > budget) continue;
    if ((*err = cudaFuncSetAttribute(
             fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)pl.smem)) != cudaSuccess)
      return TridiagPlan{};
    if (pl.G <= 8) {
      cached[m] = pl;
      return pl;
    }
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(attr, pl.G, pl.G, pl.smem, 0);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg) == cudaSuccess &&
        clusters >= 1) {
      cached[m] = pl;
      return pl;
    }
    cudaGetLastError();  // a refused query is not an error of the launch
  }
  *err = cudaErrorInvalidConfiguration;
  return TridiagPlan{};
}

template <typename T>
int tridiag_wide_run(const void* h, void* vrows, void* tau, void* d, void* e,
                     int m, int batch, long long h_stride, void* stream,
                     int lo) {
  using V = typename Real<T>::C;
  if (m < lo || batch < 1 || batch > kMaxBatch)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const TridiagPlan pl = tridiag_plan<T>(m, &err);
  if (pl.G == 0) return (int)err;
  const void* fn = (const void*)tridiag_cluster_kernel<T>;
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem));
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(attr, batch * pl.G, pl.G, pl.smem,
                                          (cudaStream_t)stream);
  ADAPTAQC_RETURN_IF_ERR(cudaLaunchKernelEx(
      &cfg, tridiag_cluster_kernel<T>, (const V*)h, (V*)vrows, (V*)tau,
      (T*)d, (T*)e, m, pl.R, h_stride));
  return (int)cudaGetLastError();
}

// K3's wide variant: the cluster route where its plan takes m (every CTA's
// columns of the iterate in shared memory; it computes all m eigenpairs),
// else teig_grid (the first `keep`). Either way w (batch x m) and z (batch x
// m x m, row stride m) hold the first keep eigenpairs.
template <typename T>
int teig_wide_run(const void* d, const void* e, const void* b0, void* w,
                  void* z, void* scratch, int m, int keep, int batch,
                  long long d_stride, long long e_stride,
                  long long scratch_stride, void* stream, int lo) {
  if (m < lo || keep < 1 || keep > m || batch < 1 || batch > kMaxBatch)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const TeigPlan pl = teig_plan<T>(m, &err);
  if (pl.G == 0) {
    const TgPlan tg = tg_plan<T>(m, &err);
    if (tg.G == 0) return (int)err;
    if (scratch_stride < tg_scratch_reals(m, keep, tg.kB, sizeof(T)))
      return (int)cudaErrorInvalidValue;
    return tg_run<T, kTgBlock>((const T*)d, (const T*)e, (const T*)b0, (T*)w,
                         (T*)z, (T*)scratch, m, keep, batch, d_stride,
                         e_stride, scratch_stride, tg, (cudaStream_t)stream);
  }
  const void* fn = (const void*)teig_cluster_kernel<T>;
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem));
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(attr, batch * pl.G, pl.G, pl.smem,
                                          (cudaStream_t)stream);
  ADAPTAQC_RETURN_IF_ERR(cudaLaunchKernelEx(
      &cfg, teig_cluster_kernel<T>, (const T*)d, (const T*)e, (const T*)b0,
      (T*)w, (T*)z, (T*)scratch, m, pl.L, pl.lu_smem, d_stride, e_stride));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

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

// K2's cluster route in complex64 (128 < m <= 640: every row in the
// cluster's shared memory).
int tridiag_wide_launch(const void* h, void* vrows, void* tau, void* d,
                        void* e, int m, int batch, long long h_stride,
                        void* stream) {
  return tridiag_wide_run<float>(h, vrows, tau, d, e, m, batch, h_stride,
                                 stream, kMaxM + 1);
}

// K2's cluster plan at m in float (f64 = 0, 128 < m) or double (2 <= m):
// the CTAs of the cluster that runs a matrix; 0 where its rows do not fit
// in the cluster's shared memory (complex64 past 640, complex128 past
// 438) or on error.
int tridiag_cluster_size(int m, int f64) {
  if (m < (f64 ? 2 : kMaxM + 1)) return 0;
  cudaError_t err = cudaSuccess;
  return (f64 ? tridiag_plan<double>(m, &err) : tridiag_plan<float>(m, &err))
      .G;
}

// The route K2's wide variant takes at m in float (f64 = 0, 128 < m) or
// double (2 <= m): 0 the cluster route where its rows fit in the cluster's
// shared memory, else 1, the card-wide route (csrc/tridiag_grid.cu, whose
// own plan says whether it launches); -1 below the wide variant's sizes.
int tridiag_routes(int m, int f64) {
  if (m < (f64 ? 2 : kMaxM + 1)) return -1;
  return tridiag_cluster_size(m, f64) > 0 ? 0 : 1;
}

// K3's wide scratch a matrix, in reals (of float: enough in double too),
// for every route and every keep <= m: the cluster route's LU factors, or
// teig_grid's (its LU factors, then its W partials).
long long teig_wide_scratch(int m) {
  const long long cl = m <= kClMaxM ? teig_cluster_scratch_reals(m) : 0;
  const long long tg = tg_scratch_reals(m, m, kTgBlock, (int)sizeof(float));
  // a multiple of 4 reals, so that every matrix's W is 16-byte aligned
  return ((cl > tg ? cl : tg) + 3) & ~3LL;
}

// The CTAs of the cluster that K3's cluster route runs a matrix on, at m in
// float (f64 = 0, 128 < m) or double (2 <= m); 0 where that route does not
// take m (see eigh_wide_routes).
int teig_cluster_size(int m, int f64) {
  if (m < (f64 ? 2 : kMaxM + 1)) return 0;
  cudaError_t err = cudaSuccess;
  return (f64 ? teig_plan<double>(m, &err) : teig_plan<float>(m, &err)).G;
}

// teig_grid's plan at m (the same lower bounds): out[0] its block width,
// out[1] the CTAs of its in-block cluster, out[2] the rows a rank of it,
// out[3] the slabs of the W partials, out[4] the stages that read from
// global memory (kTgGlobalBisect | kTgGlobalInvit | kTgGlobalInblock).
// Returns the CUDA error (0: planned).
int teig_grid_plan(int m, int f64, int* out) {
  if (m < (f64 ? 2 : kMaxM + 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const TgPlan pl =
      f64 ? tg_plan<double>(m, &err) : tg_plan<float>(m, &err);
  if (pl.G == 0) return (int)err;
  out[0] = pl.kB;
  out[1] = pl.G;
  out[2] = pl.R;
  out[3] = pl.slabs;
  out[4] = pl.global;
  return 0;
}

// The route K3's wide variant takes at m in float (f64 = 0, 128 < m) or
// double (2 <= m): 0 the cluster route, 1 teig_grid; -1 where neither
// launches. The wrapper counts each launch by it.
int eigh_wide_routes(int m, int f64) {
  if (teig_cluster_size(m, f64) > 0) return 0;
  int plan[4];
  return teig_grid_plan(m, f64, plan) == 0 ? 1 : -1;
}

int teig_wide_launch(const void* d, const void* e, const void* b0, void* w,
                     void* z, void* scratch, int m, int keep, int batch,
                     long long d_stride, long long e_stride,
                     long long scratch_stride, void* stream) {
  return teig_wide_run<float>(d, e, b0, w, z, scratch, m, keep, batch,
                              d_stride, e_stride, scratch_stride, stream,
                              kMaxM + 1);
}

// The same kernels in complex128 / float64 (K2's cluster route 2 <= m <=
// 438, K3 every m).
int tridiag_f64_launch(const void* h, void* vrows, void* tau, void* d,
                       void* e, int m, int batch, long long h_stride,
                       void* stream) {
  return tridiag_wide_run<double>(h, vrows, tau, d, e, m, batch, h_stride,
                                  stream, 2);
}

int teig_f64_launch(const void* d, const void* e, const void* b0, void* w,
                    void* z, void* scratch, int m, int keep, int batch,
                    long long d_stride, long long e_stride,
                    long long scratch_stride, void* stream) {
  return teig_wide_run<double>(d, e, b0, w, z, scratch, m, keep, batch,
                               d_stride, e_stride, scratch_stride, stream, 2);
}

// Marks a library whose eigensolver launchers take the batch arguments
// (tools that also load builds of older sources look for it).
int eigh_batched_launchers() { return 1; }

const char* adaptaqc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
