// K2's card-wide route: the Householder tridiagonalization of a Hermitian
// m x m Gram on every SM of the card, as a blocked reduction with LAPACK
// zhetrd / zlatrd's structure, for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel _tridiag_kernel
// (adaptaqc_tpu/ops/pallas_eigh.py:56) past what one thread-block cluster
// keeps in shared memory (complex64 m > 640, complex128 m > 438; the
// cluster route, tridiag_cluster_kernel in eigh_tridiag.cu, below it). Its
// outputs are those of the other routes and of the plain version
// (ops/eigh_kernels.py tridiag_plain): vrows (row k = v_k), tau, d and e,
// which K3 and K4 read unchanged.
//
// What held the cluster route back past its fit: one matrix on one cluster
// of at most 16 of the 132 SMs, most rows streamed from global memory
// (about 13 a CTA kept in shared memory at complex64 m = 2048, 6 in
// complex128), the trailing block read twice and written once a step,
// all of it scalar level-2 work with a cluster handshake a step. Here:
//   - one persistent kernel, one CTA of 512 threads an SM, launched
//     cooperatively (every CTA resident), with a grid barrier (a counter in
//     the workspace) between the phases that read what other CTAs wrote;
//   - the matrix lives whole in the workspace (m x m, row-major) and stays
//     exactly Hermitian: the trailing update computes the tiles on and below
//     the diagonal and writes each with its conjugate transpose, the
//     diagonal's imaginary part 0;
//   - panels of kNb processed columns. Column k of a panel:
//       A  each row j > k, on the warp that owns it (row j on warp
//          j mod warps, every CTA's warps numbered in order), brought up
//          to date with the panel's earlier V and W: c_j = A[j][k] -
//          sum_q V[j][q] conj(W[k][q]) + W[j][q] conj(V[k][q]); posted;
//          grid barrier;
//       B  every CTA reads the whole column into shared memory and forms
//          the same reflector from it (tridiag_plain's formulas: the norm
//          scaled below tiny / eps, beta's sign, ss > 0 the active test;
//          every sum in one fixed order in every CTA);
//       C  y_i = sum_{j > k} A[i][j] v_j over the stored (panel-start)
//          matrix, a warp a row: the one O(m^2) pass a column, spread over
//          every SM; with it the panel's a = W^H v and b = V^H v summed by
//          slabs of kSlab rows (lane q sums column q over the slab's rows
//          in order) on warps that hold no row; grid barrier;
//       D  every CTA sums the slabs' partials (8 groups of consecutive
//          slabs, then the groups in order) and s = v^H y in its own fixed
//          order, then s -= b^H a + a^H b (a warp's butterfly); each owner
//          forms w_i = tau (y_i - V_i a - W_i b - (conj(tau) s / 2) v_i)
//          for its rows, and every CTA forms w_{k+1} itself (the same
//          function, the same bits) for the next column's A;
//     so two grid barriers an active column;
//   - after a panel, A -= V W^H + W V^H on the trailing block in 64 x 64
//     tiles: complex128 on the fp64 tensor cores (DMMA m16n8k4, dmma16 in
//     common.cuh, a complex product as four real ones), complex64 in exact
//     float32 FFMA (no TF32); the same pass marks each trailing row that
//     has an entry off the diagonal whose square is nonzero (an integer OR,
//     whatever the order);
//   - a rank-deficient Gram's residue: a column at rounding level against
//     the largest column so far ends its panel (when it is smaller than the
//     last such column by 2^-20), so that its residue, measured against the
//     freshly updated stored matrix, shrinks by a rounding a step until it
//     reaches exact zero, as the unblocked steps' residue does; within a
//     panel it would stay at the rounding level of the panel-start matrix;
//   - inactive steps: a column whose squares below the diagonal sum to
//     exactly zero is the identity (tau = e = 0, v = e_{k+1}). A row's
//     flag says whether any of its squares off the diagonal is nonzero.
//     After an inactive step, with no active step yet in the panel, the
//     matrix is the stored one, so a column whose row's flag is clear is
//     inactive: a run of them is written as identity rows by every CTA
//     with no column step and no barrier. A column found inactive by its
//     step after an active one ends the panel, so that the flags are fresh
//     for the rest;
//   - every reduction is taken in one fixed order that depends on m alone
//     (warp butterflies, the CTA's tree, slabs in order), never on the
//     number of CTAs, and nothing is added by float atomics: a rerun, and
//     each matrix of a batch (the matrices one after another in the same
//     launch), equals its P = 1 launch bit for bit.
// Past kColumnSmem bytes of a CTA's shared memory (complex128 past m =
// 11,565: at m = 16384 the column alone is 256 KB), each CTA keeps its copy
// of the column and v in the workspace instead (its own m elements, read
// back by its own SM through L1), the rest as above: the same bits.
// What bounds it: the pass of y, which reads the trailing block once a
// column (m^3 / 3 complex elements in all, from L2 while the trailing
// block fits, complex64 to m = 2048, else from HBM), measured at about
// 1.4-1.5 TB/s on an H100 (tools/stage_clocks.py --kernels tridiag_grid:
// the pass and the barrier after it about half the time at m = 2048); then
// the two grid barriers and the column's dependent steps, about 6-8 us an
// active column in all.

#include <cuda_runtime.h>
#include <stdint.h>

#include <unordered_map>

#include "common.cuh"

namespace {

using adaptaqc::dmma16;
using adaptaqc::warp_sum;

constexpr int kGThreads = 512;  // a CTA, one an SM
constexpr int kGWarps = kGThreads / 32;
static_assert(kGWarps == 16, "cta_sum2 sums 16 warps' pairs in one warp");
constexpr int kNb = 32;         // processed columns a panel
constexpr int kSlab = 64;       // rows of an a / b partial
constexpr int kTile = 64;       // trailing update tile
constexpr int kLd = kNb + 4;    // a panel plane's row stride (reals):
                                // conflict-free DMMA fragment reads
constexpr int kLdc = kTile + 1;  // the staged tile's row stride
constexpr int kMaxCtas = 256;    // the most CTAs the plan takes
constexpr int kBatch = 8;        // loads a lane issues at once in the y pass
static_assert(kNb == 32, "lane q holds panel column q");

template <typename T>
struct GReal;
template <>
struct GReal<float> {
  using C = float2;
  static constexpr float kTiny = 0x1p-103f;  // FLT_MIN / FLT_EPSILON
  static constexpr float kNoise = 0x1p-26f;  // (2^10 FLT_EPSILON)^2
};
template <>
struct GReal<double> {
  using C = double2;
  static constexpr double kTiny = 0x1p-970;  // DBL_MIN / DBL_EPSILON
  static constexpr double kNoise = 0x1p-84;  // (2^10 DBL_EPSILON)^2
};

__device__ __forceinline__ float2 make_c(float x, float y) {
  return make_float2(x, y);
}
__device__ __forceinline__ double2 make_c(double x, double y) {
  return make_double2(x, y);
}
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_(double a, double b) {
  return fmax(a, b);
}

// Whether an entry's square is nonzero in either part: a column whose
// squares all round to zero sums to exactly zero, so the flags built from
// this test skip exactly the columns that the step would find inactive.
template <typename C>
__device__ __forceinline__ bool sq_nonzero(C a) {
  return a.x * a.x > decltype(a.x)(0) || a.y * a.y > decltype(a.x)(0);
}
template <typename C>
__device__ __forceinline__ C cmul(C a, C b) {
  return make_c(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// acc += a b
template <typename C>
__device__ __forceinline__ void cfma(C& acc, C a, C b) {
  acc.x = fma_(a.x, b.x, fma_(-a.y, b.y, acc.x));
  acc.y = fma_(a.x, b.y, fma_(a.y, b.x, acc.y));
}
// acc += a conj(b)
template <typename C>
__device__ __forceinline__ void cfma_cj(C& acc, C a, C b) {
  acc.x = fma_(a.x, b.x, fma_(a.y, b.y, acc.x));
  acc.y = fma_(a.y, b.x, fma_(-a.x, b.y, acc.y));
}
// acc += conj(a) b
template <typename C>
__device__ __forceinline__ void cfma_ca(C& acc, C a, C b) {
  acc.x = fma_(a.x, b.x, fma_(a.y, b.y, acc.x));
  acc.y = fma_(a.x, b.y, fma_(-a.y, b.x, acc.y));
}
template <typename C>
__device__ __forceinline__ C warp_sum2(C v) {
  return make_c(warp_sum(v.x), warp_sum(v.y));
}
template <typename C>
__device__ __forceinline__ C ldcg(const C* p) {
  return __ldcg(p);
}
template <typename C>
__device__ __forceinline__ void stcg(C* p, C v) {
  __stcg(p, v);
}

// The dynamic shared memory of a CTA, in bytes from its start: during the
// column steps the column, then v (m complex; in the workspace where
// gcol_global), and the slabs' partial sums of a and b in 8 groups (8 x 2
// kNb complex); during a trailing update over the same bytes, the panel
// planes (V and W of the tile's rows and columns, real and imaginary
// parts, 64 x kLd each) and then the staged tile; after the larger of the
// two, the panel's row flags (m bytes).
struct GSmem {
  size_t sl2, nz, total;
};
__host__ __device__ inline GSmem gsmem_of(int m, size_t cs, bool vglobal) {
  GSmem g;
  g.sl2 = vglobal ? 0 : ((size_t)m * cs + 15) & ~(size_t)15;
  const size_t col = g.sl2 + (size_t)8 * 2 * kNb * cs;
  const size_t planes = (size_t)8 * kTile * kLd * (cs / 2);
  g.nz = ((planes > col ? planes : col) + 15) & ~(size_t)15;
  g.total = g.nz + (((size_t)m + 15) & ~(size_t)15);
  return g;
}
// the most dynamic shared memory that keeps the column in shared memory:
// a rule of m and the dtype alone (so is the workspace), within what an
// H100 CTA takes beside the kernel's static buffers
constexpr size_t kColumnSmem = 200 * 1024;
__host__ __device__ inline bool gcol_global(int m, size_t cs) {
  return gsmem_of(m, cs, false).total > kColumnSmem;
}
template <typename T>
__host__ __device__ inline GSmem gsmem(int m) {
  const size_t cs = 2 * sizeof(T);
  return gsmem_of(m, cs, gcol_global(m, cs));
}

// The workspace of one launch, in bytes from its start: the matrix, the
// panel's V and W (m x kNb each), the column (m), y (m), the slabs' a / b
// partials (slabs x 2 x kNb), two buffers of row flags (2 x m ints), the
// barrier's counter and word (kMaxCtas words: one line each); where
// gcol_global, each CTA's column and v (kMaxCtas x m).
struct GLayout {
  size_t v, w, col, y, part, nz, bar, vc, total;
};
__host__ __device__ inline size_t galign(size_t x) {
  return (x + 255) & ~(size_t)255;
}
__host__ __device__ inline int gslabs(int m) {
  return (m + kSlab - 1) / kSlab;
}
__host__ __device__ inline GLayout glayout(int m, int csize) {
  GLayout l;
  l.v = galign((size_t)m * m * csize);
  l.w = l.v + galign((size_t)m * kNb * csize);
  l.col = l.w + galign((size_t)m * kNb * csize);
  l.y = l.col + galign((size_t)m * csize);
  l.part = l.y + galign((size_t)m * csize);
  l.nz = l.part + galign((size_t)gslabs(m) * 2 * kNb * csize);
  l.bar = l.nz + galign((size_t)2 * m * sizeof(int));
  l.vc = galign(l.bar + kMaxCtas * sizeof(unsigned));
  l.total = gcol_global(m, csize)
                ? l.vc + (size_t)kMaxCtas * m * csize
                : l.bar + kMaxCtas * sizeof(unsigned);
  return l;
}

// Every CTA: a grid barrier. Each CTA's thread 0 adds one to the counter
// (after a fence: the CTA's writes first) and waits until every CTA of
// this barrier has; the counter only grows, `target` tracks it. (The last
// arrival publishing the barrier's number in a word of its own, or a word
// a CTA that every waiter reads, measured slower.)
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(bar)
                   : "memory");
    } while ((int)(v - target) < 0);
  }
  __syncthreads();
}

// Stage clocks (tools/stage_clocks.py --kernels tridiag_grid builds the
// source with TRIDIAG_GRID_STAGES): CTA 0's thread 0 adds the cycles since
// the last stamp to the stage's counter.
#ifdef TRIDIAG_GRID_STAGES
__device__ long long g_tg_stage[16];
#define TG_STAGE(i)                                      \
  do {                                                   \
    if (threadIdx.x == 0 && blockIdx.x == 0) {           \
      const long long t_ = clock64();                    \
      g_tg_stage[i] += t_ - tg_last;                     \
      tg_last = t_;                                      \
    }                                                    \
  } while (0)
// and counts events in slots 13-15 (panels, columns found inactive by
// their step, panels ended by a residue column)
#define TG_COUNT(i)                                               \
  do {                                                            \
    if (threadIdx.x == 0 && blockIdx.x == 0) g_tg_stage[i] += 1;  \
  } while (0)
#else
#define TG_STAGE(i) \
  do {              \
  } while (0)
#define TG_COUNT(i) \
  do {              \
  } while (0)
#endif

// Sum of v over the CTA in one fixed order (warp butterflies, then warp
// 0 over the warps): every CTA gets the same bits for the same inputs.
template <typename T>
__device__ __forceinline__ T cta_sum(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T t = lane < kGWarps ? red[lane] : T(0);
    t = warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}
template <typename C, typename T>
__device__ __forceinline__ C cta_sum2(C v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v.x = warp_sum(v.x);
  v.y = warp_sum(v.y);
  __syncthreads();
  if (lane == 0) {
    red[warp] = v.x;
    red[16 + warp] = v.y;
  }
  __syncthreads();
  if (warp == 0) {
    T t = lane < 2 * kGWarps ? red[lane] : T(0);
    // lanes 0-15 the real parts, 16-31 the imaginary: sum each half
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[32] = t;
    if (lane == 16) red[33] = t;
  }
  __syncthreads();
  return make_c(red[32], red[33]);
}
template <typename T>
__device__ __forceinline__ T cta_max(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max_(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T t = lane < kGWarps ? red[lane] : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      t = max_(t, __shfl_xor_sync(0xffffffffu, t, o));
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// One warp: w_i = tau (y_i - sum_q (V[i][q] a_q + W[i][q] b_q) - t2 v_i)
// for row i, with p panel columns before this one (lane q reads column q).
// The owner of row i and every CTA that forms w_{k+1} for itself call this
// one function (not inlined: one instruction sequence) on the same values,
// so they get the same bits.
template <typename C, typename T>
__device__ __noinline__ C row_w(const C* V, const C* W, int i, int p, C yi,
                                C vi, C aq, C bq, T tr, T ti, T t2r, T t2i) {
  const int lane = threadIdx.x & 31;
  C t = make_c(T(0), T(0));
  if (lane < p) {
    cfma(t, ldcg(V + (size_t)i * kNb + lane), aq);
    cfma(t, ldcg(W + (size_t)i * kNb + lane), bq);
  }
  t = warp_sum2(t);
  const T pr = yi.x - t.x - (t2r * vi.x - t2i * vi.y);
  const T pi = yi.y - t.y - (t2r * vi.y + t2i * vi.x);
  return make_c(tr * pr - ti * pi, tr * pi + ti * pr);
}

// One CTA: A[i][j] -= sum_q V[i][q] conj(W[j][q]) + W[i][q] conj(V[j][q])
// on the tile (r0.., c0..) of the trailing block (ti >= tj: on or below
// the diagonal), written with its conjugate transpose, the diagonal's
// imaginary part 0; marks in nzn every row of the tile's rows and columns
// that has a nonzero entry off the diagonal. sm: the CTA's dynamic shared
// memory (the planes, then the staged tile).
template <typename T>
__device__ void load_planes(T* sm, const typename GReal<T>::C* V,
                            const typename GReal<T>::C* W, int r0, int c0,
                            int m, int p, int pc) {
  // planes: [XV re, XV im, XW re, XW im, YV re, YV im, YW re, YW im]
  using C = typename GReal<T>::C;
  constexpr int kPlane = kTile * kLd;
  for (int idx = threadIdx.x; idx < 2 * kTile * pc; idx += kGThreads) {
    const int side = idx / (kTile * pc);  // 0: rows (X), 1: columns (Y)
    const int rem = idx - side * kTile * pc;
    const int r = rem / pc, q = rem - r * pc;
    const int i = (side ? c0 : r0) + r;
    C vv = make_c(T(0), T(0)), ww = vv;
    if (i < m && q < p) {  // columns p..pc - 1 are zero: stale panels
      vv = ldcg(V + (size_t)i * kNb + q);
      ww = ldcg(W + (size_t)i * kNb + q);
    }
    T* base = sm + side * 4 * kPlane + r * kLd + q;
    base[0] = vv.x;
    base[kPlane] = vv.y;
    base[2 * kPlane] = ww.x;
    base[3 * kPlane] = ww.y;
  }
}

// The tile's product into the staged tile cs (64 x kLdc complex, over the
// planes once every warp has read them). complex128: DMMA m16n8k4, warp
// (wr, wc) the 16 x 16 block at (16 wr, 16 wc).
__device__ __noinline__ void tile_product(double* sm, double2* cs, int pc) {
  constexpr int kPlane = kTile * kLd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = (warp >> 2) * 16, Cc = (warp & 3) * 16;
  const int ar = R + (lane >> 2), ac = lane & 3;
  double dre[2][4] = {}, dim[2][4] = {};
  // pass 0: X = V (rows), Y = W (columns); pass 1: X = W, Y = V
  for (int pass = 0; pass < 2; ++pass) {
    const double* xr = sm + (pass ? 2 : 0) * kPlane;
    const double* yr = sm + 4 * kPlane + (pass ? 0 : 2) * kPlane;
    for (int q0 = 0; q0 < pc; q0 += 4) {
      const double a_re0 = xr[ar * kLd + q0 + ac];
      const double a_re1 = xr[(ar + 8) * kLd + q0 + ac];
      const double a_im0 = xr[kPlane + ar * kLd + q0 + ac];
      const double a_im1 = xr[kPlane + (ar + 8) * kLd + q0 + ac];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int br = Cc + 8 * n + (lane >> 2);
        const double b_re = yr[br * kLd + q0 + ac];
        const double b_im = yr[kPlane + br * kLd + q0 + ac];
        // (xr + i xi)(yr - i yi) = xr yr + xi yi + i (xi yr - xr yi)
        dmma16(dre[n], a_re0, a_re1, b_re);
        dmma16(dre[n], a_im0, a_im1, b_im);
        dmma16(dim[n], a_im0, a_im1, b_re);
        dmma16(dim[n], -a_re0, -a_re1, b_im);
      }
    }
  }
  __syncthreads();  // every warp has read the planes: cs reuses them
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int r = R + (lane >> 2), c = Cc + 8 * n + 2 * (lane & 3);
    cs[r * kLdc + c] = make_double2(dre[n][0], dim[n][0]);
    cs[r * kLdc + c + 1] = make_double2(dre[n][1], dim[n][1]);
    cs[(r + 8) * kLdc + c] = make_double2(dre[n][2], dim[n][2]);
    cs[(r + 8) * kLdc + c + 1] = make_double2(dre[n][3], dim[n][3]);
  }
}

// complex64: exact float32 FFMA, thread (tr, tc) rows 2 tr + {0, 1} and
// columns tc + 16 c (c < 4).
__device__ __noinline__ void tile_product(float* sm, float2* cs, int pc) {
  constexpr int kPlane = kTile * kLd;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  float2 acc[2][4] = {};
  for (int pass = 0; pass < 2; ++pass) {
    const float* xr = sm + (pass ? 2 : 0) * kPlane;
    const float* yr = sm + 4 * kPlane + (pass ? 0 : 2) * kPlane;
    for (int q = 0; q < pc; ++q) {
      float2 x[2], y[4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        x[a] = make_float2(xr[(2 * tr + a) * kLd + q],
                           xr[kPlane + (2 * tr + a) * kLd + q]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        y[c] = make_float2(yr[(tc + 16 * c) * kLd + q],
                           yr[kPlane + (tc + 16 * c) * kLd + q]);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) cfma_cj(acc[a][c], x[a], y[c]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      cs[(2 * tr + a) * kLdc + tc + 16 * c] = acc[a][c];
}

template <typename T>
__device__ void trailing_tile(T* sm, typename GReal<T>::C* A,
                              const typename GReal<T>::C* V,
                              const typename GReal<T>::C* W, int* nzn, int m,
                              int r0, int c0, int p, int pc, int* rowf,
                              int* colf) {
  using C = typename GReal<T>::C;
  const int tid = threadIdx.x;
  const bool diag = r0 == c0;
  if (tid < kTile) rowf[tid] = colf[tid] = 0;
  load_planes<T>(sm, V, W, r0, c0, m, p, pc);
  __syncthreads();
  C* cs = reinterpret_cast<C*>(sm);
  tile_product(sm, cs, pc);
  __syncthreads();
  // A - C on and below the diagonal, in place in cs; the rows' flags
  for (int idx = tid; idx < kTile * kTile; idx += kGThreads) {
    const int r = idx / kTile, c = idx - r * kTile;
    const int i = r0 + r, j = c0 + c;
    if (i >= m || j >= m || (diag && r < c)) continue;
    const C prod = cs[r * kLdc + c];
    C a = ldcg(A + (size_t)i * m + j);
    a.x = a.x - prod.x;
    a.y = i == j ? T(0) : a.y - prod.y;
    cs[r * kLdc + c] = a;
    stcg(A + (size_t)i * m + j, a);
    if (i != j && sq_nonzero(a)) {
      rowf[r] = 1;
      colf[c] = 1;
    }
  }
  __syncthreads();
  // the conjugate transpose: row c0 + c of A, columns r0 + r (r > c on a
  // diagonal tile)
  for (int idx = tid; idx < kTile * kTile; idx += kGThreads) {
    const int c = idx / kTile, r = idx - c * kTile;
    const int i = r0 + r, j = c0 + c;
    if (i >= m || j >= m || (diag && r <= c)) continue;
    const C a = cs[r * kLdc + c];
    stcg(A + (size_t)j * m + i, make_c(a.x, -a.y));
  }
  if (tid < kTile) {
    if (rowf[tid]) atomicOr(nzn + r0 + tid, 1);
    if (colf[tid]) atomicOr(nzn + c0 + tid, 1);
  }
  __syncthreads();
}

// Grid: one CTA an SM (cooperative launch); batch matrices one after
// another. h (batch x m x m at h_stride) exactly Hermitian; ws the
// workspace (glayout). Row i belongs to warp i mod warps, the warps of
// every CTA numbered in order: at m <= warps a row a warp, so that the y
// pass streams every trailing row at once and the slab tasks go to warps
// without a row. kVG: the column and v in the workspace (gcol_global).
template <typename T, bool kVG>
__global__ void __launch_bounds__(kGThreads, 1)
    tridiag_grid_kernel(const typename GReal<T>::C* __restrict__ h,
                        long long h_stride, unsigned char* __restrict__ ws,
                        typename GReal<T>::C* __restrict__ vrows_out,
                        typename GReal<T>::C* __restrict__ tau_out,
                        T* __restrict__ d_out, T* __restrict__ e_out, int m,
                        int batch) {
  using C = typename GReal<T>::C;
  const GLayout lay = glayout(m, (int)sizeof(C));
  const GSmem gs = gsmem<T>(m);
  C* A = reinterpret_cast<C*>(ws);
  C* V = reinterpret_cast<C*>(ws + lay.v);
  C* W = reinterpret_cast<C*>(ws + lay.w);
  C* col = reinterpret_cast<C*>(ws + lay.col);
  C* ybuf = reinterpret_cast<C*>(ws + lay.y);
  C* part = reinterpret_cast<C*>(ws + lay.part);
  int* nz = reinterpret_cast<int*>(ws + lay.nz);
  unsigned* bar = reinterpret_cast<unsigned*>(ws + lay.bar);

  extern __shared__ __align__(16) unsigned char gsm[];
  T* sm = reinterpret_cast<T*>(gsm);
  // the column, then v
  C* vs = kVG ? reinterpret_cast<C*>(ws + lay.vc) + (size_t)blockIdx.x * m
              : reinterpret_cast<C*>(gsm);
  C* sl2 = reinterpret_cast<C*>(gsm + gs.sl2);  // [8][2 kNb]
  unsigned char* nzs = gsm + gs.nz;
  __shared__ T red[34];
  __shared__ C sa[kNb], sb[kNb], svk[kNb], swk[kNb];
  __shared__ int rowf[kTile], colf[kTile];
  __shared__ int s_next;  // the end of a run of skipped columns

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = gridDim.x * kGWarps;
  const int gw = blockIdx.x * kGWarps + warp;
  const int chunk = (m + gridDim.x - 1) / gridDim.x;
  const int c_lo = blockIdx.x * chunk, c_hi = min(m, c_lo + chunk);
  const int nslab = gslabs(m);
  const T zero = 0, one = 1;
  const C czero = make_c(zero, zero);
  unsigned target = 0;
#ifdef TRIDIAG_GRID_STAGES
  long long tg_last = clock64();
#endif

  for (int b = 0; b < batch; ++b) {
    const C* hb = h + (size_t)b * h_stride;
    C* vrows = vrows_out + (size_t)b * m * m;
    C* tau = tau_out + (size_t)b * m;
    T* d = d_out + (size_t)b * m;
    T* e = e_out + (size_t)b * m;
    // the matrix into the workspace, each row's flag
    for (int i = gw; i < m; i += nwarps) {
      bool f = false;
      for (int j = lane; j < m; j += 32) {
        const C a = hb[(size_t)i * m + j];
        stcg(A + (size_t)i * m + j, a);
        f |= j != i && sq_nonzero(a);
      }
      f = __any_sync(0xffffffffu, f);
      if (lane == 0) stcg(nz + i, (int)f);
    }
    for (int j = c_lo + tid; j < c_hi; j += kGThreads)
      vrows[(size_t)(m - 1) * m + j] = czero;
    if (blockIdx.x == 0 && tid == 0) {
      tau[m - 1] = czero;
      e[m - 1] = zero;
    }
    grid_sync(bar, target);
    TG_STAGE(0);

    // identity row k (an inactive step), this CTA's chunk of it
    auto identity = [&](int k) {
      for (int j = c_lo + tid; j < c_hi; j += kGThreads)
        vrows[(size_t)k * m + j] = make_c(j == k + 1 ? one : zero, zero);
      if (blockIdx.x == 0 && tid == 0) {
        tau[k] = czero;
        e[k] = zero;
      }
    };

    int k = 0, par = 0;
    bool prev_in = true;  // "step -1" is inactive
    // the largest column sum of squares so far, and that of the last
    // column that ended its panel as rounding residue
    T ss_max = zero, ss_noise = zero;
    while (k < m - 1) {
      const int ks = k;
      const int* nzc = nz + par * m;
      int* nzn = nz + (par ^ 1) * m;
      for (int i = blockIdx.x * kGThreads + tid; i < m;
           i += gridDim.x * kGThreads)
        stcg(nzn + i, 0);
      for (int i = ks + tid; i < m; i += kGThreads)
        nzs[i] = ldcg(nzc + i) != 0;
      __syncthreads();
      TG_STAGE(1);
      TG_COUNT(13);
      int p = 0;
      while (k < m - 1 && p < kNb) {
        if (prev_in && !nzs[k]) {
          // zero since the panel's start, with the run of such columns
          // after it: identity rows up to the next flagged column
          if (tid == 0) s_next = m - 1;
          __syncthreads();
          for (int j = k + 1 + tid; j < m - 1; j += kGThreads)
            if (nzs[j]) {
              atomicMin(&s_next, j);
              break;
            }
          __syncthreads();
          const int kn = s_next;
          const int cw = c_hi - c_lo, nrun = kn - k;
          for (int idx = tid; idx < nrun * cw; idx += kGThreads) {
            const int r = k + idx / cw, j = c_lo + idx % cw;
            vrows[(size_t)r * m + j] = make_c(j == r + 1 ? one : zero, zero);
          }
          if (blockIdx.x == 0)
            for (int r = k + tid; r < kn; r += kGThreads) {
              tau[r] = czero;
              e[r] = zero;
            }
          k = kn;
          TG_STAGE(2);
          __syncthreads();  // s_next is read before it is set again
          continue;
        }
        // A: column k brought up to date with the panel, rows j > k
        for (int j = gw; j < m; j += nwarps) {
          if (j <= k) continue;
          const C a = lane == 0 ? ldcg(A + (size_t)j * m + k) : czero;
          C t = czero;
          if (lane < p) {
            cfma_cj(t, ldcg(V + (size_t)j * kNb + lane), swk[lane]);
            cfma_cj(t, ldcg(W + (size_t)j * kNb + lane), svk[lane]);
          }
          t = warp_sum2(t);
          if (lane == 0) stcg(col + j, make_c(a.x - t.x, a.y - t.y));
        }
        TG_STAGE(3);
        grid_sync(bar, target);
        TG_STAGE(4);
        // B: the reflector, in every CTA
        T part_ss = zero;
#pragma unroll 4
        for (int j = k + 1 + tid; j < m; j += kGThreads) {
          const C c = ldcg(col + j);
          vs[j] = c;
          part_ss = fma_(c.x, c.x, fma_(c.y, c.y, part_ss));
        }
        const T ss = cta_sum(part_ss, red);
        if (!(ss > zero)) {  // exactly inactive: ends the panel
          identity(k);
          prev_in = true;
          ++k;
          TG_STAGE(5);
          TG_COUNT(14);
          if (p > 0) break;
          continue;
        }
        // a column at rounding level against the largest so far (a
        // rank-deficient Gram's residue), smaller by 2^-20 than the last
        // such, ends the panel after its step: a trailing update starts
        // the next column from the stored matrix, against which the
        // residue shrinks by a rounding each step until it is exactly zero
        // (within a panel it stays at rounding level of the panel-start
        // matrix); a residue that does not shrink keeps its panel
        ss_max = max_(ss_max, ss);
        bool residue_end = false;
        if (ss < GReal<T>::kNoise * ss_max) {
          residue_end = ss_noise == zero || ss < ss_noise * T(0x1p-20);
          if (residue_end) {
            ss_noise = ss;
            TG_COUNT(15);
          }
        } else {
          ss_noise = zero;
        }
        T nrm;
        if (ss < GReal<T>::kTiny) {
          T am = zero;
          for (int j = k + 1 + tid; j < m; j += kGThreads)
            am = max_(am, max_(abs_(vs[j].x), abs_(vs[j].y)));
          const T amax = cta_max(am, red);
          const T inv = one / amax;
          T sc = zero;
          for (int j = k + 1 + tid; j < m; j += kGThreads) {
            const T cx = vs[j].x * inv, cy = vs[j].y * inv;
            sc = fma_(cx, cx, fma_(cy, cy, sc));
          }
          nrm = amax * sqrt_(cta_sum(sc, red));
        } else {
          nrm = sqrt_(ss);
        }
        const C alpha = vs[k + 1];
        const T inv = one / nrm;
        const T ahr = alpha.x * inv, ahi = alpha.y * inv;
        const T bh = ahr >= zero ? -one : one;
        const T tr = one - ahr * bh, ti = -ahi * bh;
        const T dr = ahr - bh, di = ahi;
        const T gs = inv / (dr * dr + di * di);
        const C gam = make_c(dr * gs, -di * gs);
        __syncthreads();  // alpha read before v overwrites it
        for (int j = k + 1 + tid; j < m; j += kGThreads)
          vs[j] = j == k + 1 ? make_c(one, zero) : cmul(gam, vs[j]);
        __syncthreads();
        for (int j = c_lo + tid; j < c_hi; j += kGThreads)
          vrows[(size_t)k * m + j] = j <= k ? czero : vs[j];
        if (blockIdx.x == 0 && tid == 0) {
          tau[k] = make_c(tr, ti);
          e[k] = bh * nrm;
        }
        TG_STAGE(5);
        // C: y = A v on the stored matrix, a warp a row, kBatch loads a
        // lane issued before their sums; the slabs' a = W^H v and b = V^H v
        // (lane q sums column q over the slab's rows in order) on the warps
        // from the last, which hold no row while m < warps. (Cutting the
        // rows into pieces on more warps as they shorten measured no
        // faster: the pass is bound by the bytes it reads.)
        for (int i = gw; i < m; i += nwarps) {
          if (i <= k) continue;
          const C* ar = A + (size_t)i * m;
          C acc = czero;
          for (int j0 = k + 1 + lane; j0 < m; j0 += 32 * kBatch) {
            C x[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u)
              x[u] = j0 + 32 * u < m ? ldcg(ar + j0 + 32 * u) : czero;
#pragma unroll
            for (int u = 0; u < kBatch; ++u)
              if (j0 + 32 * u < m) cfma(acc, x[u], vs[j0 + 32 * u]);
          }
          acc = warp_sum2(acc);
          if (lane == 0) stcg(ybuf + i, acc);
        }
        const int s0 = (k + 1) / kSlab;
        if (p > 0) {
          const int ntask = 2 * (nslab - s0);
          for (int t = nwarps - 1 - gw; t < ntask; t += nwarps) {
            const int s = s0 + (t >> 1), vec = t & 1;
            const C* X = vec ? V : W;
            C acc = czero;
            const int j1 = min(m, (s + 1) * kSlab);
            if (lane < p) {
#pragma unroll 8
              for (int j = max(k + 1, s * kSlab); j < j1; ++j)
                cfma_ca(acc, ldcg(X + (size_t)j * kNb + lane), vs[j]);
              stcg(part + ((size_t)s * 2 + vec) * kNb + lane, acc);
            }
          }
        }
        TG_STAGE(6);
        grid_sync(bar, target);
        TG_STAGE(7);
        // D: a and b (the slabs in order, in 8 groups of consecutive
        // slabs) and s in every CTA, then w
        if (p > 0) {
          const int ns = nslab - s0, L = (ns + 7) / 8;
          const int v = tid & 63, g = tid >> 6;
          C acc = czero;
          if ((v & 31) < p) {
#pragma unroll 4
            for (int t = 0; t < L; ++t) {
              const int s = s0 + g * L + t;
              if (s < nslab) {
                const C x = ldcg(part + (size_t)s * 2 * kNb + v);
                acc.x += x.x;
                acc.y += x.y;
              }
            }
          }
          sl2[g * 2 * kNb + v] = acc;
        }
        C sy = czero;
#pragma unroll 4
        for (int i = k + 1 + tid; i < m; i += kGThreads)
          cfma_ca(sy, vs[i], ldcg(ybuf + i));
        __syncthreads();
        if (p > 0 && tid < 2 * kNb) {
          C t = czero;
#pragma unroll
          for (int g = 0; g < 8; ++g) {
            const C x = sl2[g * 2 * kNb + tid];
            t.x += x.x;
            t.y += x.y;
          }
          (tid < kNb ? sa : sb)[tid & 31] = t;
        }
        sy = cta_sum2(sy, red);  // (its barriers also publish sa, sb)
        const C aq = lane < p ? sa[lane] : czero;
        const C bq = lane < p ? sb[lane] : czero;
        // s = v^H y - b^H a - a^H b: lane q's terms, then the warp's sum
        C u = czero;
        cfma_ca(u, bq, aq);
        cfma_ca(u, aq, bq);
        u = warp_sum2(u);
        const C s = make_c(sy.x - u.x, sy.y - u.y);
        const T half = T(0.5);
        const T t2r = (tr * s.x + ti * s.y) * half;
        const T t2i = (tr * s.y - ti * s.x) * half;
        for (int i = gw; i < m; i += nwarps) {
          if (i <= k) {
            if (lane == 0) {
              stcg(V + (size_t)i * kNb + p, czero);
              stcg(W + (size_t)i * kNb + p, czero);
            }
            continue;
          }
          const C w = row_w(V, W, i, p, ldcg(ybuf + i), vs[i], aq, bq, tr,
                            ti, t2r, t2i);
          if (lane == 0) {
            stcg(V + (size_t)i * kNb + p, vs[i]);
            stcg(W + (size_t)i * kNb + p, w);
          }
        }
        // row k + 1 of V and W for the next column's A, in every CTA
        if (warp == 0 && k + 1 < m - 1) {
          const C w1 = row_w(V, W, k + 1, p, ldcg(ybuf + k + 1), vs[k + 1],
                             aq, bq, tr, ti, t2r, t2i);
          C vq = czero, wq = czero;
          if (lane < p) {
            vq = ldcg(V + (size_t)(k + 1) * kNb + lane);
            wq = ldcg(W + (size_t)(k + 1) * kNb + lane);
          }
          if (lane == p) {
            vq = vs[k + 1];
            wq = w1;
          }
          svk[lane] = vq;
          swk[lane] = wq;
        }
        __syncthreads();
        ++p;
        prev_in = false;
        ++k;
        TG_STAGE(8);
        if (residue_end) break;
      }
      // the panel's end: d of its rows, then the trailing update
      const int kend = k == m - 1 ? m : k;
      if (p > 0) grid_sync(bar, target);
      for (int i = gw; i < kend; i += nwarps) {
        if (i < ks) continue;
        C t = czero;
        if (lane < p) {
          const C vq = ldcg(V + (size_t)i * kNb + lane);
          const C wq = ldcg(W + (size_t)i * kNb + lane);
          cfma_cj(t, vq, wq);
          cfma_cj(t, wq, vq);
        }
        t = warp_sum2(t);
        if (lane == 0) d[i] = ldcg(A + (size_t)i * m + i).x - t.x;
      }
      TG_STAGE(9);
      if (p > 0 && k < m - 1) {
        const int n = m - k, nt = (n + kTile - 1) / kTile;
        const int ntiles = nt * (nt + 1) / 2;
        const int pc = (p + 3) & ~3;
        for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
          int ti = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
          while (ti * (ti + 1) / 2 > t) --ti;
          while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
          const int tj = t - ti * (ti + 1) / 2;
          trailing_tile<T>(sm, A, V, W, nzn, m, k + kTile * ti,
                           k + kTile * tj, p, pc, rowf, colf);
        }
        TG_STAGE(10);
        grid_sync(bar, target);
        par ^= 1;
        TG_STAGE(11);
      }
    }
    grid_sync(bar, target);  // the next matrix reuses the workspace
    TG_STAGE(12);
  }
}

template <typename T>
const void* tridiag_grid_fn(int m) {
  return gcol_global(m, 2 * sizeof(T))
             ? (const void*)tridiag_grid_kernel<T, true>
             : (const void*)tridiag_grid_kernel<T, false>;
}

template <typename T>
int tridiag_grid_ctas_for(int m, cudaError_t* err) {
  int dev = 0, sms = 0, optin = 0, coop = 0, per_sm = 0;
  const void* fn = tridiag_grid_fn<T>(m);
  cudaFuncAttributes fa;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess ||
      (*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev)) != cudaSuccess ||
      (*err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (*err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                     dev)) != cudaSuccess ||
      (*err = cudaFuncGetAttributes(&fa, fn)) != cudaSuccess)
    return 0;
  const size_t smem = gsmem<T>(m).total;
  if (!coop || sms > kMaxCtas || smem + fa.sharedSizeBytes > (size_t)optin) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  if ((*err = cudaFuncSetAttribute(
           fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess ||
      (*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, kGThreads, smem)) != cudaSuccess)
    return 0;
  if (per_sm < 1) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  return sms;  // one CTA an SM
}

// The CTAs of the route's launch at m (one an SM; 0 and *err set where the
// column or the tiles do not fit in a CTA's shared memory), planned once an
// m.
template <typename T>
int tridiag_grid_ctas(int m, cudaError_t* err) {
  static std::unordered_map<int, int> cached;
  const auto it = cached.find(m);
  if (it != cached.end()) return it->second;
  const int ctas = tridiag_grid_ctas_for<T>(m, err);
  if (ctas) cached[m] = ctas;
  return ctas;
}

template <typename T>
int tridiag_grid_run(const void* h, void* ws, void* vrows, void* tau,
                     void* d, void* e, int m, int batch, long long h_stride,
                     void* stream) {
  using C = typename GReal<T>::C;
  if (m < 2 || batch < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const int ctas = tridiag_grid_ctas<T>(m, &err);
  if (ctas == 0) return (int)err;
  const GLayout lay = glayout(m, (int)sizeof(C));
  cudaStream_t st = (cudaStream_t)stream;
  unsigned char* w = (unsigned char*)ws;
  const void* fn = tridiag_grid_fn<T>(m);
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)gsmem<T>(m).total));
  ADAPTAQC_RETURN_IF_ERR(
      cudaMemsetAsync(w + lay.bar, 0, kMaxCtas * sizeof(unsigned), st));
  const C* hp = (const C*)h;
  C *vp = (C*)vrows, *tp = (C*)tau;
  T *dp = (T*)d, *ep = (T*)e;
  void* args[] = {(void*)&hp, (void*)&h_stride, (void*)&w, (void*)&vp,
                  (void*)&tp, (void*)&dp, (void*)&ep, (void*)&m,
                  (void*)&batch};
  ADAPTAQC_RETURN_IF_ERR(cudaLaunchCooperativeKernel(
      fn, dim3(ctas), dim3(kGThreads), args, gsmem<T>(m).total, st));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2's card-wide route on a batch of complex64 (float2) or complex128
// (double2) Hermitian matrices; ws: tridiag_grid_workspace(m, f64) bytes.
int tridiag_grid_launch(const void* h, void* ws, void* vrows, void* tau,
                        void* d, void* e, int m, int batch,
                        long long h_stride, void* stream) {
  return tridiag_grid_run<float>(h, ws, vrows, tau, d, e, m, batch, h_stride,
                                 stream);
}
int tridiag_grid_f64_launch(const void* h, void* ws, void* vrows, void* tau,
                            void* d, void* e, int m, int batch,
                            long long h_stride, void* stream) {
  return tridiag_grid_run<double>(h, ws, vrows, tau, d, e, m, batch,
                                  h_stride, stream);
}

// The route's workspace in bytes at m: the matrix, the panel, the vectors,
// the slabs' partials, the flags and the barrier's counter, and past the
// column's shared-memory fit each CTA's column; m and the dtype fix it.
long long tridiag_grid_workspace(int m, int f64) {
  if (m < 2) return 0;
  return (long long)glayout(m, f64 ? 16 : 8).total;
}

// The route's plan at m: out[0] its panel's columns, out[1] its CTAs (one
// an SM), out[2] the rows of a slab of a / b partials, out[3] a CTA's
// dynamic shared memory in bytes. Returns the CUDA error (0: planned).
int tridiag_grid_plan(int m, int f64, int* out) {
  if (m < 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const int ctas = f64 ? tridiag_grid_ctas<double>(m, &err)
                       : tridiag_grid_ctas<float>(m, &err);
  if (ctas == 0) return (int)err;
  out[0] = kNb;
  out[1] = ctas;
  out[2] = kSlab;
  out[3] = (int)(f64 ? gsmem<double>(m).total : gsmem<float>(m).total);
  return 0;
}

#ifdef TRIDIAG_GRID_STAGES
// The stage clocks' counters (CTA 0's cycles by stage) into out[16], then
// cleared.
int tridiag_grid_stages(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_tg_stage, 16 * sizeof(long long));
  if (err != cudaSuccess) return (int)err;
  static const long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(g_tg_stage, zero, sizeof(zero));
}
#endif

}  // extern "C"
