// The eigensolver's back-transform (K4) past the double-buffered cluster
// route's fit, for sm_90a: a card-wide column-strip apply with wide panels.
//
// Replaces the JAX package's Pallas TPU kernel _backtransform_kernel
// (ops/pallas_eigh.py:136) where the cluster design of
// backtransform_wide.cu no longer keeps two panel buffers beside its rows
// of z (complex128 m > 2816, complex64 m > 5888), and below that down to
// the measured crossover (bt_strip_route: complex128 m >= 1536, complex64
// m >= 3072): out = H_0 H_1 ... H_{m-2} z[:, :keep], H_k = I - tau_k v_k
// v_k^H, v_k row k of `vrows` (zero through entry k, one at k + 1), z
// real. An inactive reflector (tau_k = 0) is the identity and is dropped.
//
// What bounds it: 8 m^2 keep flops (2.2 TFLOP at m = 8192, keep = 4096:
// 32.8 ms at the fp64 tensor rate or the fp32 FFMA rate of an H100), and
// the bytes every panel moves through the working columns. The cluster
// design it replaces spent its time on the panels, not the products: a
// distributed-shared-memory exchange of Y and two mbarrier rounds every
// panel of 8 or 16 reflectors, and every wave of clusters read every panel
// again. Here:
//   - no cluster and no exchange. CTA x owns output columns [32 x, 32 x +
//     32) of one matrix, a strip (16 columns at m <= 4224, so that keep =
//     m / 2 makes up to 132 strips), kept in global memory (the wrapper's
//     `zbuf`, rows of the strip's columns). Y = V^H Z of a strip is a sum
//     over its own rows, taken by one CTA in one fixed order: a batch gives
//     the bits of its P = 1 launches, and a strip's bits do not depend on
//     the other strips;
//   - wide panels of kNb = 64 active reflectors, gathered once by the
//     preparation launch (strip_prep_kernel, grid panels x batch) with
//     their T (the zlarft recurrence), each panel's rows from 64 p on (its
//     first reflector is at least 64 p), rows at a stride of kLdv = 66
//     elements (conflict-free in both products' fragment reads below);
//   - one pass over a strip's rows a panel, fused: pass j applies the
//     update Z -= V_q W_q of panel q = npan - j (rows past its first
//     reflector) and, on the same chunk of rows just updated, accumulates
//     Y_p = V_p^H Z of the next panel p = q - 1, so Z crosses the memory
//     bus twice a panel (read and write) instead of three times; at the end
//     of the pass W_p = T_p Y_p. At m = 8192, keep = 4096 that is about 69
//     GB of Z traffic in complex128 (20.5 ms at 3.35 TB/s, under the
//     arithmetic's 32.8 ms);
//   - staging: each chunk of rows (kRows: 32 in complex128, 64 in
//     complex64) of both panels' V is bulk-copied (cp.async.bulk on an
//     mbarrier) from the workspace, where every CTA finds it in L2, and the
//     chunk of Z by cp.async, into a ring of two stages: the next chunk
//     loads under this chunk's products. A producer warp issues the copies
//     and the eight consumer warps only wait for them (issued by the
//     consumers themselves at each chunk's start, the copies held every
//     warp for about an eighth of the apply: PERF.md);
//   - arithmetic: complex128 on DMMA m16n8k4 (dmma16, the full fp64 tensor
//     rate): the update one 16 x 8 tile of Z a warp, Z's fragment the
//     accumulator, W's fragments in registers for the whole pass, the
//     4-reflector k steps taking reflectors {0, 1, 4, 5} + base so that the
//     fragment reads of V hit distinct banks in both products; Y two 16 x 8
//     tiles a warp (one in strips of 16) over the whole pass. complex64 in
//     exact float32 FFMA (no TF32): 2 x 4 complex outputs a thread in both
//     products (2 x 2 in strips of 16).
// The plan (strip width, panel, chunk rows, shared memory, workspace)
// depends on m and the dtype alone, and nothing of it caps m: the shared
// memory is fixed but for the panels' first rows (an int a panel), the
// workspace grows as m^2 (strip_ws), both defined to m = kMaxM = 16384.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using adaptaqc::bulk_copy;
using adaptaqc::cp_async16_zfill;
using adaptaqc::dmma16;
using adaptaqc::mbar_expect_tx;
using adaptaqc::mbar_init_count;
using adaptaqc::mbar_wait;

constexpr int kNb = 64;          // reflectors of a panel
constexpr int kThreads = 256;    // a CTA of the preparation; the apply's
                                 // consumer warps
constexpr int kApplyThreads = kThreads + 32;  // and its producer warp
constexpr int kLdv = kNb + 2;    // a panel row's stride, in elements
// at m <= kNarrowMax a strip has 16 columns (keep = m / 2: at most 132
// strips, one wave), else 32
constexpr int kNarrowMax = 4224;
constexpr int kAlign = 64;       // rows: the padded m, and panel p's first
                                 // row 64 p
constexpr int kPrepChunk = 64;   // rows the preparation stages at a time
constexpr int kMaxBatch = 65535;
constexpr int kMaxM = 16384;
// complex128 from it takes the strip route, complex64 from the other: the
// first sizes where it measured faster than the double-buffered cluster
// route on one H100 at keep = m / 2 (tools/bt_strip.py: the double route
// faster at complex128 m = 1280 and complex64 m = 2048; PERF.md)
constexpr int kStripFromF64 = 1536;
constexpr int kStripFromF32 = 3072;
static_assert(kThreads == 256 && kNb == 64,
              "the fragment and register tiles below");

__host__ __device__ inline int bt_strip_route(int m, int esize) {
  return m >= (esize == 16 ? kStripFromF64 : kStripFromF32);
}
// the columns of a strip at m
__host__ __device__ inline int bt_strip_cols(int m) {
  return m <= kNarrowMax ? 16 : 32;
}

template <typename T>
struct Cplx;
template <>
struct Cplx<float> {
  using V = float2;
  static constexpr int kRows = 64;  // rows of a chunk
};
template <>
struct Cplx<double> {
  using V = double2;
  static constexpr int kRows = 32;
};

__device__ __forceinline__ float2 mk(float x, float y) {
  return make_float2(x, y);
}
__device__ __forceinline__ double2 mk(double x, double y) {
  return make_double2(x, y);
}
// acc += a b
__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
}
__device__ __forceinline__ void cfma(double2& acc, double2 a, double2 b) {
  acc.x = fma(a.x, b.x, fma(-a.y, b.y, acc.x));
  acc.y = fma(a.x, b.y, fma(a.y, b.x, acc.y));
}
// acc += conj(a) b
__device__ __forceinline__ void cfma_conj(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(-a.y, b.x, acc.y));
}
__device__ __forceinline__ void cfma_conj(double2& acc, double2 a,
                                          double2 b) {
  acc.x = fma(a.x, b.x, fma(a.y, b.y, acc.x));
  acc.y = fma(a.x, b.y, fma(-a.y, b.x, acc.y));
}
// acc -= a b
__device__ __forceinline__ void cfms(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(-a.x, b.x, fmaf(a.y, b.y, acc.x));
  acc.y = fmaf(-a.x, b.y, fmaf(-a.y, b.x, acc.y));
}
template <typename V>
__device__ __forceinline__ V cmul(V a, V b) {
  return mk(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// The consumer warps' own block barrier (the producer warp is not in it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__host__ __device__ inline size_t round16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// The workspace of one matrix, bytes from its start: the active count and
// each panel's first reflector (ints), each panel's T (kNb x kNb,
// row-major, zero below the diagonal and in the slots past the active
// reflectors), then each panel's reflector block: panel p's rows from 64 p
// to mpad (m rounded up to kAlign), kLdv elements a row, entry i of a row
// its reflector i (zero above the reflector and past m).
struct StripWs {
  int npmax, mpad;
  size_t t_off, v_off, total;
};
__host__ __device__ inline StripWs strip_ws(int m, int esize) {
  StripWs w;
  w.npmax = (m - 1 + kNb - 1) / kNb;
  w.mpad = (m + kAlign - 1) / kAlign * kAlign;
  w.t_off = round16(4 * (size_t)(1 + w.npmax));
  w.v_off = w.t_off + (size_t)w.npmax * kNb * kNb * esize;
  const size_t rows = (size_t)w.npmax * w.mpad -
                      (size_t)kNb * w.npmax * (w.npmax - 1) / 2;
  w.total = w.v_off + rows * kLdv * esize;
  return w;
}
// panel p's block, bytes from the workspace's start
__host__ __device__ inline size_t strip_vblock(const StripWs& w, int p,
                                               int esize) {
  const size_t rows = (size_t)p * w.mpad - (size_t)kNb * p * (p - 1) / 2;
  return w.v_off + rows * kLdv * esize;
}
// the working columns of one matrix, bytes: ceil(keep / cols) strips of
// mpad rows of cols elements
__host__ __device__ inline size_t strip_zbuf(int m, int keep, int esize) {
  const int mpad = (m + kAlign - 1) / kAlign * kAlign;
  const int cols = bt_strip_cols(m);
  return (size_t)((keep + cols - 1) / cols) * mpad * cols * esize;
}

// strip_apply_kernel's dynamic shared memory, offsets in complex elements:
// two stages of (V of the updating panel, V of the accumulating panel:
// kRows x kLdv each; Z: kRows x (cols + 2)), then W (complex64: kNb x
// cols), then the panels' first rows (ints).
struct StripSmem {
  int rows, cols, ldz;
  size_t vq, vp, zs, stage, ws, k0, total_bytes;
};
__host__ __device__ inline StripSmem strip_smem(int m, int esize) {
  StripSmem s;
  s.rows = esize == 16 ? Cplx<double>::kRows : Cplx<float>::kRows;
  s.cols = bt_strip_cols(m);
  s.ldz = s.cols + 2;
  s.vq = 0;
  s.vp = (size_t)s.rows * kLdv;
  s.zs = 2 * (size_t)s.rows * kLdv;
  s.stage = s.zs + (size_t)s.rows * s.ldz;
  s.ws = 2 * s.stage;
  s.k0 = s.ws + (esize == 16 ? 0 : (size_t)kNb * s.cols);
  const int npmax = (m - 1 + kNb - 1) / kNb;
  s.total_bytes = s.k0 * esize + round16(4 * (size_t)npmax);
  return s;
}

// strip_prep_kernel's dynamic shared memory: the staged rows of the
// panel (kNb x (kPrepChunk + 1)), then G (kNb x kNb).
__host__ __device__ inline size_t strip_prep_smem(int esize) {
  return ((size_t)kNb * (kPrepChunk + 1) + (size_t)kNb * kNb) * esize;
}

#ifdef BT_STRIP_STAGES
// cycles of CTA (0, 0)'s thread 0 (a consumer) by stage: 0 waiting for a
// chunk (V and Z), 1 the update, its stores and the barrier after it, 2 Y,
// 3 W = T Y with its staging and barriers, 4 the whole apply, 5 the
// copies of the strip in and out
__device__ unsigned long long g_strip_stages[16];
#define STRIP_STAMP(t) \
  const long long t = (blockIdx.x | blockIdx.y | threadIdx.x) ? 0 : clock64()
#define STRIP_ADD(k, t0)                                               \
  do {                                                                 \
    if (!(blockIdx.x | blockIdx.y | threadIdx.x))                      \
      g_strip_stages[k] += (unsigned long long)(clock64() - (t0));     \
  } while (0)
#else
#define STRIP_STAMP(t)
#define STRIP_ADD(k, t0)
#endif

// Grid: panels (npmax) x batch. CTA p writes panel p's block and T (and
// CTA 0 the active count); a panel past the active reflectors is left
// unwritten: the apply stops before it. G = V^H V over the panel's rows,
// one chain an entry in row order; T row l by thread l: T[l][i] = -tau_i
// sum_{q = l}^{i - 1} T[l][q] G[q][i], in q order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    strip_prep_kernel(const typename Cplx<T>::V* __restrict__ vrows,
                      const typename Cplx<T>::V* __restrict__ tau,
                      unsigned char* __restrict__ ws, int m,
                      long long v_stride, long long tau_stride,
                      long long ws_stride) {
  using V = typename Cplx<T>::V;
  constexpr int es = (int)sizeof(V);
  {
    const size_t b = blockIdx.y;
    vrows += b * (size_t)v_stride;
    tau += b * (size_t)tau_stride;
    ws += b * (size_t)ws_stride;
  }
  const StripWs L = strip_ws(m, es);
  const int p = blockIdx.x;
  int* meta = reinterpret_cast<int*>(ws);
  V* tblk = reinterpret_cast<V*>(ws + L.t_off + (size_t)p * kNb * kNb * es);
  V* vblk = reinterpret_cast<V*>(ws + strip_vblock(L, p, es));
  extern __shared__ __align__(16) unsigned char psm[];
  V* tile = reinterpret_cast<V*>(psm);  // [kNb][kPrepChunk + 1]
  V* gm = tile + (size_t)kNb * (kPrepChunk + 1);  // [kNb][kNb]
  constexpr int kLd = kPrepChunk + 1;
  __shared__ int wcount[kThreads / 32];
  __shared__ int kref[kNb];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T zero = 0;
  const V czero = mk(zero, zero);

  // the active reflectors of panel p, in order, and the count
  const int s0 = p * kNb;
  if (tid < kNb) kref[tid] = m;  // m: no reflector, no rows
  __syncthreads();
  int na = 0;
  for (int base = 0; base < m - 1; base += kThreads) {
    const int k = base + tid;
    const V t = k < m - 1 ? tau[k] : czero;
    const bool on = t.x != zero || t.y != zero;
    const unsigned mask = __ballot_sync(0xffffffffu, on);
    if (lane == 0) wcount[warp] = __popc(mask);
    __syncthreads();
    int pos = na + __popc(mask & ((1u << lane) - 1u)), all = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      pos += w < warp ? wcount[w] : 0;
      all += wcount[w];
    }
    if (on && pos >= s0 && pos < s0 + kNb) kref[pos - s0] = k;
    na += all;
    __syncthreads();  // wcount is written again
  }
  if (p == 0 && tid == 0) meta[0] = na;
  if (s0 >= na) return;
  const int pn = min(kNb, na - s0);
  if (tid == 0) meta[1 + p] = kref[0];

  // stage the panel chunk by chunk from row 64 p: each reflector's
  // entries read along its row of vrows, then written to the block's rows;
  // G's upper entries (gi < gj), entry tid + 256 s of thread tid
  V g[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) g[s] = czero;
  for (int r0 = s0; r0 < L.mpad; r0 += kPrepChunk) {
    for (int idx = tid; idx < kNb * kPrepChunk; idx += kThreads) {
      const int i = idx / kPrepChunk, rr = idx % kPrepChunk, r = r0 + rr;
      const int k = kref[i];
      tile[i * kLd + rr] = (r < m && r > k) ? vrows[(size_t)k * m + r]
                                            : czero;
    }
    __syncthreads();
    for (int idx = tid; idx < kPrepChunk * kNb; idx += kThreads) {
      const int rr = idx / kNb, i = idx % kNb;
      vblk[(size_t)(r0 - s0 + rr) * kLdv + i] = tile[i * kLd + rr];
    }
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const int e = tid + kThreads * s, gi = e / kNb, gj = e % kNb;
      if (gi < gj) {
        for (int rr = 0; rr < kPrepChunk; ++rr)
          cfma_conj(g[s], tile[gi * kLd + rr], tile[gj * kLd + rr]);
      }
    }
    __syncthreads();  // the tile is staged again
  }
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const int e = tid + kThreads * s, gi = e / kNb, gj = e % kNb;
    if (gi < gj) gm[gi * kNb + gj] = g[s];
  }
  __syncthreads();

  // T row l by thread l, kept in the tile's space
  V* trow = tile;  // [kNb][kNb]
  if (tid < kNb) {
    const int l = tid;
    for (int i = 0; i < kNb; ++i) {
      V t = czero;
      if (i == l && l < pn) {
        t = tau[kref[l]];
      } else if (i > l && i < pn) {
        V acc = czero;
        for (int q = l; q < i; ++q) cfma(acc, trow[l * kNb + q], gm[q * kNb + i]);
        const V ta = cmul(tau[kref[i]], acc);
        t = mk(-ta.x, -ta.y);
      }
      trow[l * kNb + i] = t;
      tblk[l * kNb + i] = t;
    }
  }
}

// The reflectors of k step s of the update and of W's register fragments:
// lane k (lane % 4) takes reflector 8 (s / 2) + 2 (s % 2) + {0, 1, 4, 5}[k]
__device__ __forceinline__ int refl(int s, int k) {
  return 8 * (s >> 1) + 2 * (s & 1) + (k & 1) + 4 * (k >> 1);
}

// complex128: Z -= V W on one chunk (kRows = 32 rows), 16 x 8 tiles of Z,
// a warp a tile over the 16 k steps: 8 tiles in a strip of 32 columns, 4
// in a strip of 16 (warps 4-7 idle: splitting a tile's steps over two
// warps and summing their halves through shared memory measured slower).
// Tile t: rows 16 (t % 2) .., columns 8 (t / 2) ..; the even k steps on
// Z's fragment, the odd ones on a second accumulator, added at the end.
// W's fragments in wreg (k step s: W[refl(s, lane % 4)][8 (tile / 2) +
// lane / 4]). The new Z goes to Zs and to the chunk's rows of the strip in
// global memory (zc).
template <int COLS>
__device__ __forceinline__ void strip_update(const double2* Vq, double2* Zs,
                                             double2* zc,
                                             const double2 (&wreg)[16]) {
  constexpr int kLdz = COLS + 2;
  const int lane = threadIdx.x & 31, tile = threadIdx.x >> 5;
  if constexpr (COLS == 16) {
    if (tile >= 4) return;
  }
  const int ra = 16 * (tile & 1) + (lane >> 2), rb = ra + 8;
  const int ca = 8 * (tile >> 1) + 2 * (lane & 3);
  double zr[2][4], zi[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const double2 x = Zs[(j < 2 ? ra : rb) * kLdz + ca + (j & 1)];
    zr[0][j] = x.x;
    zi[0][j] = x.y;
    zr[1][j] = 0.0;
    zi[1][j] = 0.0;
  }
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const int i = refl(s, lane & 3);
    const double2 va = Vq[ra * kLdv + i], vb = Vq[rb * kLdv + i];
    const double2 w = wreg[s];
    // Z -= v w: real -v.x w.x + v.y w.y, imaginary -v.x w.y - v.y w.x
    dmma16(zr[s & 1], -va.x, -vb.x, w.x);
    dmma16(zr[s & 1], va.y, vb.y, w.y);
    dmma16(zi[s & 1], -va.x, -vb.x, w.y);
    dmma16(zi[s & 1], -va.y, -vb.y, w.x);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = j < 2 ? ra : rb;
    const double2 d = make_double2(zr[0][j] + zr[1][j], zi[0][j] + zi[1][j]);
    Zs[r * kLdz + ca + (j & 1)] = d;
    zc[r * COLS + ca + (j & 1)] = d;
  }
}

// complex128: Y += V^H Z over one chunk. Warp w: reflectors 16 (w % 4) ..
// and the COLS / 16 column tiles from (COLS / 2) (w / 4), over the
// chunk's rows four at a time in order; y[n][c]: n the tile, c = 0 real,
// 1 imaginary.
template <int COLS>
__device__ __forceinline__ void strip_accumulate(const double2* Vp,
                                                 const double2* Zs,
                                                 double (&y)[2][2][4]) {
  constexpr int kLdz = COLS + 2, kTiles = COLS / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ia = 16 * (warp & 3) + (lane >> 2);
  const int cb = (COLS / 2) * (warp >> 2) + (lane >> 2);
#pragma unroll 4
  for (int t = 0; t < Cplx<double>::kRows / 4; ++t) {
    const int l = 4 * t + (lane & 3);
    const double2 va = Vp[l * kLdv + ia], vb = Vp[l * kLdv + ia + 8];
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
      const double2 z = Zs[l * kLdz + cb + 8 * n];
      // conj(v) z: real v.x z.x + v.y z.y, imaginary v.x z.y - v.y z.x
      dmma16(y[n][0], va.x, vb.x, z.x);
      dmma16(y[n][0], va.y, vb.y, z.y);
      dmma16(y[n][1], va.x, vb.x, z.y);
      dmma16(y[n][1], -va.y, -vb.y, z.x);
    }
  }
}

// Y's fragments into Ys (kNb x COLS): rows 16 (w % 4) + lane / 4 (+ 8),
// columns (COLS / 2) (w / 4) + 8 n + 2 (lane % 4) + {0, 1}.
template <int COLS>
__device__ __forceinline__ void strip_stage_y(const double (&y)[2][2][4],
                                              double2* Ys) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ia = 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int n = 0; n < COLS / 16; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Ys[(ia + (j < 2 ? 0 : 8)) * COLS + (COLS / 2) * (warp >> 2) + 8 * n +
         2 * (lane & 3) + (j & 1)] = make_double2(y[n][0][j], y[n][1][j]);
}

// complex64 on FFMA: Z -= V W on one chunk (kRows = 64 rows). Warp w rows
// 8 w .. + 8: thread (ty = lane / 8, tx = lane % 8) rows 8 w + ty + 4 u
// (u < 2), columns 2 tx + 16 b + e (e < 2, b < COLS / 16), Z the
// accumulator, one chain an entry over the reflectors in order; two
// reflectors' operands a step, the next step's loaded before this one is
// used. The new Z goes to Zs and to the chunk's rows in global memory.
template <int COLS>
__device__ __forceinline__ void strip_update(const float2* Vq, float2* Zs,
                                             float2* zc, const float2* Ws) {
  constexpr int kLdz = COLS + 2, kB = COLS / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = lane >> 3, tx = lane & 7;
  const float2* v0 = Vq + (8 * warp + ty) * kLdv;
  const float2* v1 = v0 + 4 * kLdv;
  const float2* w0 = Ws + 2 * tx;
  float2 acc[2][2 * kB];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const float4 x = *reinterpret_cast<const float4*>(
          Zs + (8 * warp + ty + 4 * u) * kLdz + 2 * tx + 16 * b);
      acc[u][2 * b] = make_float2(x.x, x.y);
      acc[u][2 * b + 1] = make_float2(x.z, x.w);
    }
  // vv[u]: reflectors k, k + 1 of row u; ww[e][b]: W's row k + e, columns
  // 2 tx + 16 b + {0, 1}
  auto load = [&](int k, float4 (&vv)[2], float4 (&ww)[2][kB]) {
    vv[0] = *reinterpret_cast<const float4*>(v0 + k);
    vv[1] = *reinterpret_cast<const float4*>(v1 + k);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int b = 0; b < kB; ++b)
        ww[e][b] =
            *reinterpret_cast<const float4*>(w0 + (k + e) * COLS + 16 * b);
  };
  float4 vv[2], ww[2][kB];
  load(0, vv, ww);
#pragma unroll 2
  for (int k = 0; k < kNb; k += 2) {
    float4 vn[2], wn[2][kB];
    load(min(k + 2, kNb - 2), vn, wn);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float2 v[2], w[2 * kB];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        v[u] = e ? make_float2(vv[u].z, vv[u].w)
                 : make_float2(vv[u].x, vv[u].y);
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        w[2 * b] = make_float2(ww[e][b].x, ww[e][b].y);
        w[2 * b + 1] = make_float2(ww[e][b].z, ww[e][b].w);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int c = 0; c < 2 * kB; ++c) cfms(acc[u][c], v[u], w[c]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) vv[u] = vn[u];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int b = 0; b < kB; ++b) ww[e][b] = wn[e][b];
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int r = 8 * warp + ty + 4 * u, c = 2 * tx + 16 * b;
      const float4 x = make_float4(acc[u][2 * b].x, acc[u][2 * b].y,
                                   acc[u][2 * b + 1].x, acc[u][2 * b + 1].y);
      *reinterpret_cast<float4*>(Zs + r * kLdz + c) = x;
      *reinterpret_cast<float4*>(zc + r * COLS + c) = x;
    }
}

// complex64: Y += V^H Z over one chunk. Warp w reflectors 8 w .. + 8:
// thread (ty, tx) reflectors 8 w + 2 ty + a (a < 2), columns 2 tx + 16 b +
// e (b < COLS / 16), one chain an entry over the rows in order, the next
// row's operands loaded before this one's are used.
template <int COLS>
__device__ __forceinline__ void strip_accumulate(const float2* Vp,
                                                 const float2* Zs,
                                                 float2 (&y)[2][4]) {
  constexpr int kLdz = COLS + 2, kB = COLS / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = lane >> 3, tx = lane & 7;
  const float2* vp = Vp + 8 * warp + 2 * ty;
  const float2* zp = Zs + 2 * tx;
  auto load = [&](int l, float4& vv, float4 (&zz)[kB]) {
    vv = *reinterpret_cast<const float4*>(vp + l * kLdv);
#pragma unroll
    for (int b = 0; b < kB; ++b)
      zz[b] = *reinterpret_cast<const float4*>(zp + l * kLdz + 16 * b);
  };
  float4 vv, zz[kB];
  load(0, vv, zz);
#pragma unroll 4
  for (int l = 0; l < Cplx<float>::kRows; ++l) {
    float4 vn, zn[kB];
    load(min(l + 1, Cplx<float>::kRows - 1), vn, zn);
    const float2 v[2] = {make_float2(vv.x, vv.y), make_float2(vv.z, vv.w)};
    float2 z[2 * kB];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      z[2 * b] = make_float2(zz[b].x, zz[b].y);
      z[2 * b + 1] = make_float2(zz[b].z, zz[b].w);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 2 * kB; ++c) cfma_conj(y[a][c], v[a], z[c]);
    vv = vn;
#pragma unroll
    for (int b = 0; b < kB; ++b) zz[b] = zn[b];
  }
}

template <int COLS>
__device__ __forceinline__ void strip_stage_y(const float2 (&y)[2][4],
                                              float2* Ys) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = lane >> 3, tx = lane & 7;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < COLS / 8; ++c)
      Ys[(8 * warp + 2 * ty + a) * COLS + 2 * tx + 16 * (c >> 1) + (c & 1)] =
          y[a][c];
}

// Grid: strips (ceil(keep / COLS)) x batch, kApplyThreads a CTA. CTA x
// copies z's columns [COLS x, COLS x + COLS) into its strip of zbuf, runs
// npan + 1 fused passes (below), then copies the strip into out. Warps 0-7
// compute; warp 8 produces: for every chunk, in the passes' order, it
// waits until the chunk's stage is released (`empty`), then issues Z's
// rows by cp.async (each lane's completion an arrival on `full`) and both
// panels' V by bulk copies (lane 0, on the same mbarrier), so no consumer
// waits on an issue. A stage is released by each consumer warp when it is
// done with the chunk, except the last two chunks of a pass, whose stages
// the W staging reuses: they are released after it.
template <typename T, int COLS>
__global__ void __launch_bounds__(kApplyThreads, 1)
    strip_apply_kernel(const T* __restrict__ z,
                       typename Cplx<T>::V* __restrict__ out,
                       const unsigned char* __restrict__ ws,
                       typename Cplx<T>::V* __restrict__ zbuf, int m,
                       int keep, long long z_stride, long long ws_stride) {
  using V = typename Cplx<T>::V;
  constexpr int es = (int)sizeof(V);
  constexpr int kRows = Cplx<T>::kRows;
  constexpr bool kF64 = es == 16;
  constexpr int kLdz = COLS + 2;
  constexpr int kWarps = kThreads / 32;  // consumer warps
  STRIP_STAMP(t_all);
  const int x = blockIdx.x, nstrips = gridDim.x;
  const StripWs L = strip_ws(m, es);
  const StripSmem S = strip_smem(m, es);
  {
    const size_t b = blockIdx.y;
    z += b * (size_t)z_stride;
    out += b * (size_t)m * keep;
    ws += b * (size_t)ws_stride;
    zbuf += (b * nstrips + x) * (size_t)L.mpad * COLS;
  }
  V* zg = zbuf;  // this strip: mpad rows of COLS
  extern __shared__ __align__(16) unsigned char asm_raw[];
  V* sm = reinterpret_cast<V*>(asm_raw);
  V* Wsm = sm + S.ws;  // complex64: W (kNb x COLS)
  int* k0s = reinterpret_cast<int*>(sm + S.k0);
  __shared__ __align__(8) uint64_t full[2], empty[2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = x * COLS, cw = min(COLS, keep - c0);
  const T zero = 0;
  const V czero = mk(zero, zero);
  const int* meta = reinterpret_cast<const int*>(ws);
  const int npan = (meta[0] + kNb - 1) / kNb;
  for (int p = tid; p < npan; p += kApplyThreads) k0s[p] = meta[1 + p];
  if (tid == 0) {
    mbar_init_count(&full[0], 1);
    mbar_init_count(&full[1], 1);
    mbar_init_count(&empty[0], kWarps);
    mbar_init_count(&empty[1], kWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  STRIP_STAMP(t_in);
  for (int idx = tid; idx < L.mpad * COLS; idx += kApplyThreads) {
    const int r = idx / COLS, c = idx % COLS;
    zg[idx] = mk(r < m && c < cw ? z[(size_t)r * m + c0 + c] : zero, zero);
  }
  __syncthreads();
  STRIP_ADD(5, t_in);

  // the pass structure, the same for both roles: pass j updates with panel
  // q = npan - j (j > 0) the rows past its first reflector, from chunk
  // qfirst, and accumulates Y of panel p = q - 1 (p >= 0) on the chunks
  // from `first` (p's first reflector's, or q's in the last pass) to `last`
  struct Pass {
    int q, p, first, last, qfirst;
    bool hasq, hasp;
  };
  auto pass_of = [&](int j) {
    Pass ps;
    ps.q = npan - j;
    ps.p = ps.q - 1;
    ps.hasq = j > 0;
    ps.hasp = ps.p >= 0;
    ps.first = ((ps.hasp ? k0s[ps.p] : k0s[ps.q]) + 1) / kRows;
    ps.last = (m - 1) / kRows;
    ps.qfirst = ps.hasq ? (k0s[ps.q] + 1) / kRows : ps.last + 1;
    return ps;
  };
  // this warp's release of a stage (after its lanes' reads of it)
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) asm volatile(
        "mbarrier.arrive.release.cta.shared::cta.b64 _, [%0];\n" ::"r"(
            adaptaqc::smem_addr(&empty[st]))
        : "memory");
  };

  if (warp == kWarps) {
    // the producer
    uint32_t eparity[2] = {0u, 0u};
    int uses[2] = {0, 0};
    for (int j = 0; npan > 0 && j <= npan; ++j) {
      const Pass ps = pass_of(j);
      const size_t vq_off = ps.hasq ? strip_vblock(L, ps.q, es) : 0;
      const size_t vp_off = ps.hasp ? strip_vblock(L, ps.p, es) : 0;
      for (int c = ps.first; c <= ps.last; ++c) {
        const int st = (c - ps.first) & 1;
        if (uses[st]++ > 0) {
          mbar_wait(&empty[st], eparity[st]);
          eparity[st] ^= 1u;
        }
        const int r0 = c * kRows;
        V* base = sm + st * S.stage;
        constexpr int kPieces = COLS * es / 16;  // 16-byte pieces a row
        for (int idx = lane; idx < kRows * kPieces; idx += 32) {
          const int row = idx / kPieces, pc = idx % kPieces;
          cp_async16_zfill(reinterpret_cast<unsigned char*>(base + S.zs) +
                               (size_t)row * kLdz * es + 16 * pc,
                           reinterpret_cast<const unsigned char*>(
                               zg + (size_t)(r0 + row) * COLS) +
                               16 * pc,
                           true);
        }
        // this lane's copies complete as one more arrival on full[st]
        asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                         adaptaqc::smem_addr(&full[st]))
                     : "memory");
        __syncwarp();
        if (lane == 0) {
          const uint32_t bytes = (uint32_t)(kRows * kLdv * es);
          const bool upd = ps.hasq && c >= ps.qfirst;
          mbar_expect_tx(&full[st],
                         (ps.hasp ? bytes : 0u) + (upd ? bytes : 0u));
          if (ps.hasp)
            bulk_copy(base + S.vp,
                      ws + vp_off + (size_t)(r0 - kNb * ps.p) * kLdv * es,
                      bytes, &full[st]);
          if (upd)
            bulk_copy(base + S.vq,
                      ws + vq_off + (size_t)(r0 - kNb * ps.q) * kLdv * es,
                      bytes, &full[st]);
        }
      }
      if (!ps.hasp) break;
    }
  } else {
    // the consumers
    uint32_t parity[2] = {0u, 0u};
    double2 wreg[16];  // complex128: W's fragments for the update
#pragma unroll
    for (int s = 0; s < 16; ++s) wreg[s] = make_double2(0.0, 0.0);
    for (int j = 0; npan > 0 && j <= npan; ++j) {
      const Pass ps = pass_of(j);
      // Y's accumulators
      double yd[2][2][4] = {};
      float2 yf[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) yf[a][c] = make_float2(0.f, 0.f);
      for (int c = ps.first; c <= ps.last; ++c) {
        const int st = (c - ps.first) & 1;
        STRIP_STAMP(t_wait);
        mbar_wait(&full[st], parity[st]);
        parity[st] ^= 1u;
        STRIP_ADD(0, t_wait);
        V* base = sm + st * S.stage;
        if (ps.hasq && c >= ps.qfirst) {
          STRIP_STAMP(t_upd);
          V* zc = zg + (size_t)c * kRows * COLS;
          if constexpr (kF64)
            strip_update<COLS>(base + S.vq, base + S.zs, zc, wreg);
          else
            strip_update<COLS>(base + S.vq, base + S.zs, zc, Wsm);
          consumer_sync();  // Y reads every warp's new rows
          STRIP_ADD(1, t_upd);
        }
        if (ps.hasp) {
          STRIP_STAMP(t_y);
          if constexpr (kF64)
            strip_accumulate<COLS>(base + S.vp, base + S.zs, yd);
          else
            strip_accumulate<COLS>(base + S.vp, base + S.zs, yf);
          STRIP_ADD(2, t_y);
        }
        if (!ps.hasp || c < ps.last - 1) release(st);
      }
      if (!ps.hasp) break;
      // W = T Y for panel p: Y staged into stage 1's first buffer, W (in
      // complex128) into stage 0's, T read from the workspace; thread tid
      // row i = tid / 4, columns (tid % 4) + 4 b, T's row summed in order
      STRIP_STAMP(t_w);
      consumer_sync();  // every warp's Y done, every stage read
      V* Ys = sm + S.stage + S.vq;
      if constexpr (kF64)
        strip_stage_y<COLS>(yd, Ys);
      else
        strip_stage_y<COLS>(yf, Ys);
      consumer_sync();
      {
        const V* tp = reinterpret_cast<const V*>(ws + L.t_off) +
                      (size_t)ps.p * kNb * kNb;
        const int i = tid >> 2, cq = tid & 3;
        V acc[COLS / 4];
#pragma unroll
        for (int b = 0; b < COLS / 4; ++b) acc[b] = czero;
        // sixteen of T's entries in flight at a time (each an L2 round trip)
#pragma unroll 16
        for (int jj = 0; jj < kNb; ++jj) {
          const V t = __ldg(tp + i * kNb + jj);
#pragma unroll
          for (int b = 0; b < COLS / 4; ++b)
            cfma(acc[b], t, Ys[jj * COLS + cq + 4 * b]);
        }
        V* Wd = kF64 ? sm + S.vq : Wsm;
#pragma unroll
        for (int b = 0; b < COLS / 4; ++b) Wd[i * COLS + cq + 4 * b] = acc[b];
      }
      consumer_sync();
      if constexpr (kF64) {
        // (warps past the strip's tiles load W's rows past their own:
        // unused)
        const double2* Wd = reinterpret_cast<const double2*>(sm + S.vq);
#pragma unroll
        for (int t = 0; t < 16; ++t)
          wreg[t] = Wd[(refl(t, lane & 3) * COLS + 8 * (warp >> 1) +
                        (lane >> 2)) % (kNb * COLS)];
      }
      // the staging's generic writes before the bulk copies that refill
      // these stages, then the last two chunks' stages released
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int c = max(ps.first, ps.last - 1); c <= ps.last; ++c)
        release((c - ps.first) & 1);
      STRIP_ADD(3, t_w);
    }
  }
  STRIP_STAMP(t_out);
  __syncthreads();
  for (int idx = tid; idx < m * COLS; idx += kApplyThreads) {
    const int r = idx / COLS, c = idx % COLS;
    if (c < cw) out[(size_t)r * keep + c0 + c] = __ldcg(zg + idx);
  }
  STRIP_ADD(5, t_out);
  STRIP_ADD(4, t_all);
}

template <typename T, int COLS>
cudaError_t strip_attributes() {
  using V = typename Cplx<T>::V;
  static bool done = false;
  if (done) return cudaSuccess;
  const int es = (int)sizeof(V);
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      strip_apply_kernel<T, COLS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)strip_smem(kMaxM, es).total_bytes));
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      strip_prep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)strip_prep_smem(es)));
  done = true;
  return cudaSuccess;
}

template <typename T, int COLS>
int strip_run(const void* vrows, const void* tau, const void* z, void* out,
              void* ws, void* zbuf, int m, int keep, int batch,
              long long v_stride, long long tau_stride, long long z_stride,
              void* stream) {
  using V = typename Cplx<T>::V;
  const int es = (int)sizeof(V);
  ADAPTAQC_RETURN_IF_ERR((strip_attributes<T, COLS>()));
  cudaStream_t st = (cudaStream_t)stream;
  const StripWs L = strip_ws(m, es);
  strip_prep_kernel<T><<<dim3(L.npmax, batch), kThreads, strip_prep_smem(es),
                         st>>>((const V*)vrows, (const V*)tau,
                               (unsigned char*)ws, m, v_stride, tau_stride,
                               (long long)L.total);
  ADAPTAQC_RETURN_IF_ERR(cudaGetLastError());
  strip_apply_kernel<T, COLS>
      <<<dim3((keep + COLS - 1) / COLS, batch), kApplyThreads,
          strip_smem(m, es).total_bytes, st>>>(
          (const T*)z, (V*)out, (const unsigned char*)ws, (V*)zbuf, m, keep,
          z_stride, (long long)L.total);
  return (int)cudaGetLastError();
}

// The strip width's instantiation at m: strips of 16 columns to
// kNarrowMax, else 32.
template <typename T>
int strip_dispatch(const void* vrows, const void* tau, const void* z,
                   void* out, void* ws, void* zbuf, int m, int keep,
                   int batch, long long v_stride, long long tau_stride,
                   long long z_stride, void* stream) {
  if (m < 2 || m > kMaxM || keep < 1 || keep > m || batch < 1 ||
      batch > kMaxBatch)
    return (int)cudaErrorInvalidValue;
  if (bt_strip_cols(m) == 16)
    return strip_run<T, 16>(vrows, tau, z, out, ws, zbuf, m, keep, batch,
                            v_stride, tau_stride, z_stride, stream);
  return strip_run<T, 32>(vrows, tau, z, out, ws, zbuf, m, keep, batch,
                          v_stride, tau_stride, z_stride, stream);
}

}  // namespace

extern "C" {

// The route of the wide K4 at m (complex64 m > 128, complex128 m >= 2): 1
// the strip route, 0 the double-buffered cluster route
// (backtransform_wide.cu); -1 outside.
int backtransform_route(int m, int f64) {
  if (m < (f64 ? 2 : 129) || m > kMaxM) return -1;
  return bt_strip_route(m, f64 ? 16 : 8);
}

// The strip route's workspace of one matrix in bytes (the wrapper
// allocates batch times it); 0 outside 2 <= m <= 16384.
long long backtransform_strip_workspace(int m, int f64) {
  if (m < 2 || m > kMaxM) return 0;
  return (long long)strip_ws(m, f64 ? 16 : 8).total;
}

// Its working columns of one matrix in bytes, for `keep` columns.
long long backtransform_strip_zbuf(int m, int keep, int f64) {
  if (m < 2 || m > kMaxM || keep < 1 || keep > m) return 0;
  return (long long)strip_zbuf(m, keep, f64 ? 16 : 8);
}

// strip_apply_kernel's dynamic shared memory at m (0: the preparation's).
long long backtransform_strip_smem(int m, int f64) {
  if (m == 0) return (long long)strip_prep_smem(f64 ? 16 : 8);
  if (m < 2 || m > kMaxM) return 0;
  return (long long)strip_smem(m, f64 ? 16 : 8).total_bytes;
}

// out (batch, m, keep) = H_0 ... H_{m-2} z[:, :keep] for each matrix on the
// strip route, at any 2 <= m <= 16384 whatever the route at m (the
// wrapper takes it past the crossover; a timing script may force it
// below): ws batch x backtransform_strip_workspace(m, f64) bytes, zbuf
// batch x backtransform_strip_zbuf(m, keep, f64). Two launches on
// `stream`; returns the first launch error.
int backtransform_strip_launch(const void* vrows, const void* tau,
                               const void* z, void* out, void* ws,
                               void* zbuf, int m, int keep, int batch,
                               long long v_stride, long long tau_stride,
                               long long z_stride, int f64, void* stream) {
  return f64 ? strip_dispatch<double>(vrows, tau, z, out, ws, zbuf, m, keep,
                                      batch, v_stride, tau_stride, z_stride,
                                      stream)
             : strip_dispatch<float>(vrows, tau, z, out, ws, zbuf, m, keep,
                                     batch, v_stride, tau_stride, z_stride,
                                     stream);
}

#ifdef BT_STRIP_STAGES
// CTA (0, 0)'s cycles by stage since the last call (then zeroed).
int backtransform_strip_stages(unsigned long long* out) {
  ADAPTAQC_RETURN_IF_ERR(cudaDeviceSynchronize());
  ADAPTAQC_RETURN_IF_ERR(
      cudaMemcpyFromSymbol(out, g_strip_stages, sizeof(g_strip_stages)));
  const unsigned long long zeros[16] = {};
  return (int)cudaMemcpyToSymbol(g_strip_stages, zeros, sizeof(zeros));
}
#endif

}  // extern "C"
