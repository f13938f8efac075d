// The eigensolver's back-transform (K4) past the narrow design, for sm_90a:
// complex64 at 128 < m < 3072 and complex128 at m < 1536 (the launchers
// take m to 5888 and 2816, where a cluster keeps its rows of z beside two
// panel buffers; from those sizes on backtransform_strip.cu measured
// faster).
//
// Replaces the JAX package's Pallas TPU kernel _backtransform_kernel
// (ops/pallas_eigh.py:136): out = H_0 H_1 ... H_{m-2} z[:, :keep], with
// H_k = I - tau_k v_k v_k^H, v_k row k of `vrows` (zero through entry k,
// one at k + 1), z real. An inactive reflector (tau_k = 0) is the identity
// and is dropped; the sweep's Grams leave long runs of them.
//
// What bounds it on this card: 8 m^2 keep flops on the active reflectors
// (4.3 GFLOP at m = 1024, keep = 512: 0.06 ms at the fp32 peak; the fp64
// FFMA rate is half that), against m^2 complex elements of reflectors read
// once. Its first wide design (one CTA of 8 output columns a matrix, every
// reflector panel's G = V^H V and T formed again by each of those CTAs,
// m / 16 panels each behind five block barriers, the panel read in place
// at an m-element stride in complex128) took 5.63 ms at complex128
// m = 1024 on one H100, 6.9 times torch.ormqr. Here:
//   - one preparation launch (bt_prep_kernel), grid panels x batch: CTA p
//     finds the active reflectors (every CTA scans tau; no host read-back),
//     gathers those of panel p (kNb of them, in order) into a row-major
//     block of the workspace, its rows dealt to the apply's CTAs (below)
//     so that each CTA's slab is contiguous, with a row stride padded by 16
//     bytes (off any power of two, conflict-free in shared memory), and
//     forms the panel's G over all its threads and T = the zlarft
//     recurrence once, for every column tile;
//   - one apply launch (bt_apply_kernel), grid column tiles of kCols x a
//     cluster of G CTAs x batch. CTA g of a cluster holds rows g, g + G,
//     g + 2G, .. of its kCols columns of z (cyclic, so that every CTA keeps
//     about the same share of the rows below each panel's first reflector)
//     in shared memory, and for each panel, last first:
//       * waits for its slab of the panel (and T), bulk-copied
//         (cp.async.bulk, completing on an mbarrier) into one of two
//         buffers, and issues the next panel's copy into the other, so the
//         next panel loads while this one is applied; rows above the
//         panel's first reflector are zero and neither copied nor used;
//       * forms its partial Y = V_slab^H Z_slab (kNb x kCols), 4 x 4
//         register tiles a thread over an eighth of the rows, summed over
//         the eight by shuffles in a fixed tree;
//       * the exchange, through distributed shared memory and mbarriers
//         (no cluster barrier): column c of Y belongs to rank c mod G;
//         every rank stores its partial of each column into the owner's
//         buffer and arrives on the owner's mbarrier; the owner sums the G
//         partials in rank order (the same bits whatever the timing, and
//         a batch equal to its P = 1 launches), forms W = T Y for its
//         columns and stores them into every rank's W, arriving on each
//         one's second mbarrier;
//       * Z_slab -= V_slab W, 4 x 4 register tiles a thread.
//     Gathering all G partials in every CTA (the first version) took
//     3,000-10,000 cycles a panel, more than the products (clock64()
//     stamps, one H100).
// Past the shared-memory fit of two panel buffers (complex128 m >
// kDoubleMaxF64 = 2816: at m = 4096 a CTA's 256 rows of z take 147 KB, two
// panel buffers 139 KB; complex64 m > kDoubleMaxF32 = 5888) K4 runs the
// strip route of backtransform_strip.cu, which takes over below that fit
// too where it measured faster (bt_strip_route); the launchers here refuse
// those m.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using adaptaqc::dmma;
using adaptaqc::bulk_copy;
using adaptaqc::mbar_arrive_remote;
using adaptaqc::mbar_init;
using adaptaqc::mbar_init_count;
using adaptaqc::mbar_wait;
using adaptaqc::mbar_expect_tx;
using adaptaqc::mbar_wait_cluster;
using adaptaqc::smem_addr;

constexpr int kNb = 16;         // reflectors of a compact-WY panel
constexpr int kCols = 32;       // output columns of a cluster
constexpr int kThreads = 256;   // a CTA, in both launches
constexpr int kRowsCta = 128;   // rows a CTA aims at: G = ceil(m / 128),
constexpr int kRowsSmall = 64;  // or ceil(m / 64) at m <= 512
constexpr int kMaxCluster = 16;
constexpr int kChunk = 128;     // rows the preparation stages at a time
constexpr int kMaxBatch = 65535;
constexpr int kPlanCache = 8192;
constexpr int kDoubleMaxF64 = 2816;  // the last complex128 m whose rows
                                     // fit beside two buffers (R = 176
                                     // rows a CTA of 16: 222,912 bytes;
                                     // 192 rows: 240,128)
constexpr int kDoubleMaxF32 = 5888;  // complex64 (R = 368 rows: 225,984
                                     // bytes; 384 rows: 235,264)
static_assert(kNb == 16 && kCols == 32 && kThreads == 256,
              "the register tiles below: 4 x 4 outputs a thread");

__host__ __device__ inline int bt_max_m(int esize) {
  return esize == 16 ? kDoubleMaxF64 : kDoubleMaxF32;
}

template <typename T>
struct Cplx;
template <>
struct Cplx<float> {
  using V = float2;
};
template <>
struct Cplx<double> {
  using V = double2;
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
template <typename V>
__device__ __forceinline__ V cadd(V a, V b) {
  return mk(a.x + b.x, a.y + b.y);
}
template <typename V>
__device__ __forceinline__ V cmul(V a, V b) {
  return mk(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__host__ __device__ inline size_t round16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// The workspace of one matrix, in bytes from its start: the active count
// and each panel's first reflector (ints), each panel's T (nb x nb,
// row-major), then each panel's reflector block: G R rows (CTA g's rows,
// g + l G for l < R, at rows g R + l) of ldv elements, entry i of a row the
// panel's reflector i. ldv: the panel's nb entries and 16 bytes more, so a
// block's rows are 16-byte aligned and their stride is no power of two. A block holds m
// + kMaxCluster - 1 rows, as many as G R reaches for any cluster size, so
// the workspace depends on m and the dtype alone.
struct BtWs {
  int nb, npmax, ldv, slots;
  size_t t_off, v_off, t_bytes, v_bytes, total;
};
__host__ __device__ inline BtWs bt_ws(int m, int esize) {
  BtWs w;
  w.nb = kNb;
  w.npmax = (m - 1 + w.nb - 1) / w.nb;
  w.ldv = w.nb + 16 / esize;
  w.slots = m + kMaxCluster - 1;
  w.t_off = round16(4 * (size_t)(1 + w.npmax));
  w.t_bytes = (size_t)w.nb * w.nb * esize;
  w.v_off = w.t_off + (size_t)w.npmax * w.t_bytes;
  w.v_bytes = (size_t)w.slots * w.ldv * esize;
  w.total = w.v_off + (size_t)w.npmax * w.v_bytes;
  return w;
}

// bt_apply_kernel's dynamic shared memory, offsets in complex elements:
// the CTA's rows of z (Rp = R rounded up to 16, rows of ldz), two panel
// buffers (Rp rows of ldv), two T, the partial Y of this CTA's columns
// (c = g mod G) as every rank posts it (G x nb x ncmax, ncmax = ceil(cols
// / G)), their sum (nb x ncmax), W (nb x cols), then the panels' first
// reflectors (ints). ldz = cols + 4: the eight rows a warp reads at once in
// the partial Y fall on the fewest bank passes in either dtype.
struct BtSmem {
  int Rp, ldz, ldv, ncmax, nbuf, nb, cols;
  size_t zs, vb, tb, rv, yl, ws, k0, total_bytes;
};
__host__ __device__ inline BtSmem bt_smem(int m, int G, int R, int esize) {
  BtSmem s;
  s.nb = kNb;
  s.cols = kCols;
  s.nbuf = 2;
  s.Rp = (R + 15) & ~15;
  s.ldz = s.cols + 4;
  s.ldv = s.nb + 16 / esize;
  s.ncmax = (s.cols + G - 1) / G;
  s.zs = 0;
  s.vb = s.zs + (size_t)s.Rp * s.ldz;
  s.tb = s.vb + (size_t)s.nbuf * s.Rp * s.ldv;
  s.rv = s.tb + (size_t)s.nbuf * s.nb * s.nb;
  s.yl = s.rv + (size_t)G * s.nb * s.ncmax;
  s.ws = s.yl + (size_t)s.nb * s.ncmax;
  s.k0 = s.ws + (size_t)s.nb * s.cols;
  const int npmax = (m - 1 + s.nb - 1) / s.nb;
  s.total_bytes = s.k0 * esize + round16(4 * (size_t)npmax);
  return s;
}

// bt_prep_kernel's dynamic shared memory: the active list (m ints), then
// a staged chunk of the panel, nb rows of kChunk + 1 elements.
__host__ __device__ inline size_t bt_prep_smem(int m, int esize) {
  return round16(4 * (size_t)m) + (size_t)kNb * (kChunk + 1) * esize;
}

// One level of the shuffle tree that sums x over the eight lanes of a
// group (lane bits 0-2): lanes that differ in bit kBit swap halves of
// their first 2 kN sums, each keeping one half, summed.
template <int kN, int kBit, typename V>
__device__ __forceinline__ void halve(V (&x)[16], int lane) {
  const bool up = lane & kBit;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const V keep = up ? x[k + kN] : x[k];
    const V send = up ? x[k] : x[k + kN];
    x[k] = mk(keep.x + __shfl_xor_sync(0xffffffffu, send.x, kBit),
              keep.y + __shfl_xor_sync(0xffffffffu, send.y, kBit));
  }
}

// Grid: panels (npmax) x batch, kThreads a CTA. CTA p writes panel p's
// reflector block and T (panels of NB reflectors, the route's); CTA 0
// also the active count. A panel past the active reflectors is left
// unwritten: the apply stops before it.
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
    bt_prep_kernel(const typename Cplx<T>::V* __restrict__ vrows,
                   const typename Cplx<T>::V* __restrict__ tau,
                   unsigned char* __restrict__ ws, int m, int G, int R,
                   long long v_stride, long long tau_stride,
                   long long ws_stride) {
  using V = typename Cplx<T>::V;
  {
    const size_t b = blockIdx.y;
    vrows += b * (size_t)v_stride;
    tau += b * (size_t)tau_stride;
    ws += b * (size_t)ws_stride;
  }
  const BtWs L = bt_ws(m, (int)sizeof(V));
  const int p = blockIdx.x;
  int* meta = reinterpret_cast<int*>(ws);
  V* tblk = reinterpret_cast<V*>(ws + L.t_off + p * L.t_bytes);
  V* vblk = reinterpret_cast<V*>(ws + L.v_off + p * L.v_bytes);
  extern __shared__ __align__(16) unsigned char psm[];
  int* act = reinterpret_cast<int*>(psm);                       // m
  V* tile = reinterpret_cast<V*>(psm + round16(4 * (size_t)m));  // NB rows
  constexpr int kLd = kChunk + 1;
  __shared__ int wcount[kThreads / 32];
  __shared__ int kref[NB];
  __shared__ V gm[NB * NB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T zero = 0;
  const V czero = mk(zero, zero);

  // the active reflectors, in order
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
    if (on) act[pos] = k;
    na += all;
    __syncthreads();  // wcount is written again
  }
  if (p == 0 && tid == 0) meta[0] = na;
  const int s0 = p * NB;
  if (s0 >= na) return;
  const int pn = min(NB, na - s0);
  if (tid < NB) kref[tid] = tid < pn ? act[s0 + tid] : m;  // m: no rows
  if (tid == 0) meta[1 + p] = act[s0];
  // the slots past m (g + l G >= m, l < R) are zero rows
  for (int idx = tid; idx < G * NB; idx += kThreads) {
    const int g = idx / NB, i = idx % NB;
    for (int l = (m - g + G - 1) / G; l < R; ++l)
      vblk[((size_t)g * R + l) * L.ldv + i] = czero;
  }
  __syncthreads();

  // stage the panel chunk by chunk from its first reflector's row: each
  // reflector's entries (read along its row of vrows), then written to
  // the slots of their rows; G = V^H V, the strictly upper part, one entry
  // a thread with four partial sums (rows mod 4) combined in order
  const int gi = tid / NB, gj = tid % NB;
  V g4[4] = {czero, czero, czero, czero};
  for (int r0 = (kref[0] + 1) & ~(kChunk - 1); r0 < m; r0 += kChunk) {
    for (int idx = tid; idx < NB * kChunk; idx += kThreads) {
      const int i = idx / kChunk, rr = idx % kChunk, r = r0 + rr;
      const int k = kref[i];
      tile[i * kLd + rr] = (r < m && r > k) ? vrows[(size_t)k * m + r]
                                            : czero;
    }
    __syncthreads();
    for (int idx = tid; idx < kChunk * NB; idx += kThreads) {
      const int rr = idx / NB, i = idx % NB, r = r0 + rr;
      if (r < m)
        vblk[((size_t)(r % G) * R + r / G) * L.ldv + i] = tile[i * kLd + rr];
    }
    if (gi < gj) {
      for (int rr = 0; rr < kChunk; rr += 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cfma_conj(g4[j], tile[gi * kLd + rr + j], tile[gj * kLd + rr + j]);
      }
    }
    __syncthreads();  // the tile is staged again
  }
  if (gi < gj)
    gm[gi * NB + gj] = cadd(cadd(g4[0], g4[1]), cadd(g4[2], g4[3]));
  __syncthreads();

  // T by the zlarft recurrence: T[i][i] = tau_i, T[:i, i] = -tau_i
  // T[:i, :i] G[:i, i]; lane l holds row l
  if (warp == 0) {
    V trow[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      V next = czero;
      if (i < pn) {
        const V ti = tau[kref[i]];
        V acc = czero;
#pragma unroll
        for (int q = 0; q < i; ++q)
          if (q >= lane) cfma(acc, trow[q], gm[q * NB + i]);
        const V ta = cmul(ti, acc);
        next = lane < i ? mk(-ta.x, -ta.y) : (lane == i ? ti : czero);
      }
      trow[i] = next;
    }
    if (lane < NB) {
#pragma unroll
      for (int i = 0; i < NB; ++i) tblk[lane * NB + i] = trow[i];
    }
  }
}

// The partial Y = V^H Z over rows [l0, R) of a CTA's slab (Vs: rows of
// ldv, Zs: rows of ldz), kNb x kCols: each thread returns two entries y
// (reflector yi, column yc). complex64 on FFMA: a 4 x 4 tile (reflectors
// 4 ig + a, columns cg + 8 b) a thread over rows l = s mod 8, the next
// row's operands loaded while this one's are used, summed over the eight
// by shuffles in a fixed tree.
__device__ __forceinline__ void partial_y(const float2* Vs, const float2* Zs,
                                          int ldv, int ldz, int l0, int R,
                                          int tid, float2 (&y)[2],
                                          int (&yi)[2], int (&yc)[2]) {
  const int lane = tid & 31;
  const int s = lane & 7, tile = tid >> 3, ig = tile >> 3, cg = tile & 7;
  const float2 czero = make_float2(0.f, 0.f);
  float2 acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = czero;
  float2 v[4], zz[4];
  auto load = [&](int l, float2 (&vv)[4], float2 (&zv)[4]) {
    l = min(l, R - 1);
#pragma unroll
    for (int a = 0; a < 4; ++a) vv[a] = Vs[l * ldv + 4 * ig + a];
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) zv[bb] = Zs[l * ldz + cg + 8 * bb];
  };
  int l = l0 + ((s - l0) & 7);
  load(l, v, zz);
  for (; l < R; l += 8) {
    float2 vn[4], zn[4];
    load(l + 8, vn, zn);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) cfma_conj(acc[a * 4 + bb], v[a], zz[bb]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = vn[k];
      zz[k] = zn[k];
    }
  }
  halve<8, 4>(acc, lane);
  halve<4, 2>(acc, lane);
  halve<2, 1>(acc, lane);
  // lane s now holds the sums of tile entries 2 s and 2 s + 1
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int f = 2 * s + k;
    y[k] = acc[k];
    yi[k] = 4 * ig + (f >> 2);
    yc[k] = cg + 8 * (f & 3);
  }
}

// complex128 on the fp64 tensor cores (DMMA): warp w takes the 8 x 8 tile
// of reflectors 8 (w / 4) .. and columns 8 (w % 4) .., over the rows eight
// at a time (two steps of four, each into its own accumulators, the next
// eight rows' operands loaded while these are used); a complex product is
// four real ones, so eight chains are in flight, added at the end. Rows
// before l0 (the slab's stale rows) and past R weigh zero.
__device__ __forceinline__ void partial_y(const double2* Vs,
                                          const double2* Zs, int ldv,
                                          int ldz, int l0, int R, int tid,
                                          double2 (&y)[2], int (&yi)[2],
                                          int (&yc)[2]) {
  const int lane = tid & 31, warp = tid >> 5;
  const int i = 8 * (warp >> 2) + (lane >> 2);  // A's row, reflector i
  const int c = 8 * (warp & 3) + (lane >> 2);   // B's column
  const int k = lane & 3;                       // A's column, B's row
  const double2 zero2 = make_double2(0.0, 0.0);
  double acc[2][4][2] = {};  // [step parity][part][fragment]
  auto load = [&](int l8, double2 (&v)[2], double2 (&z)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = l8 + 4 * h + k;
      v[h] = (l >= l0 && l < R) ? Vs[l * ldv + i] : zero2;
      z[h] = l < R ? Zs[l * ldz + c] : zero2;
    }
  };
  int l8 = l0 & ~3;
  double2 v[2], z[2];
  load(l8, v, z);
  for (; l8 < R; l8 += 8) {
    double2 vn[2], zn[2];
    load(l8 + 8, vn, zn);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // conj(v) z: real v.x z.x + v.y z.y, imaginary v.x z.y - v.y z.x
      dmma(acc[h][0][0], acc[h][0][1], v[h].x, z[h].x);
      dmma(acc[h][1][0], acc[h][1][1], v[h].y, z[h].y);
      dmma(acc[h][2][0], acc[h][2][1], v[h].x, z[h].y);
      dmma(acc[h][3][0], acc[h][3][1], -v[h].y, z[h].x);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[h] = vn[h];
      z[h] = zn[h];
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    y[j] = make_double2(
        (acc[0][0][j] + acc[0][1][j]) + (acc[1][0][j] + acc[1][1][j]),
        (acc[0][2][j] + acc[0][3][j]) + (acc[1][2][j] + acc[1][3][j]));
    yi[j] = 8 * (warp >> 2) + (lane >> 2);
    yc[j] = 8 * (warp & 3) + 2 * k + j;
  }
}

// Z -= V W on rows [l0, R) of a CTA's slab (Ws: kNb x kCols). complex64
// on FFMA: warp w takes rows [base + 16 w, + 16), a 4 x 4 tile (rows + ty
// + 4 u, columns tx + 8 b) a thread, the next reflector's operands loaded
// while this one's are used.
__device__ __forceinline__ void update_z(const float2* Vs, const float2* Ws,
                                         float2* Zs, int ldv, int ldz, int l0,
                                         int R, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = lane & 7, ty = lane >> 3;
  const float2 czero = make_float2(0.f, 0.f);
  for (int base = 0; base < R; base += 16 * (kThreads / 32)) {
    const int lr = base + 16 * warp;
    if (lr >= R || lr + 16 <= l0) continue;
    float2 acc[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = czero;
    float2 w[4], v[4];
    auto load = [&](int i, float2 (&wv)[4], float2 (&vv)[4]) {
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) wv[bb] = Ws[i * kCols + tx + 8 * bb];
#pragma unroll
      for (int u = 0; u < 4; ++u) vv[u] = Vs[(lr + ty + 4 * u) * ldv + i];
    };
    load(0, w, v);
#pragma unroll 4
    for (int i = 0; i < kNb; ++i) {
      float2 wn[4], vn[4];
      load(min(i + 1, kNb - 1), wn, vn);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) cfma(acc[u * 4 + bb], v[u], w[bb]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w[k] = wn[k];
        v[k] = vn[k];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int row = lr + ty + 4 * u;
      if (row >= l0 && row < R) {
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          float2& x = Zs[row * ldz + tx + 8 * bb];
          x = make_float2(x.x - acc[u * 4 + bb].x, x.y - acc[u * 4 + bb].y);
        }
      }
    }
  }
}

// complex128 on DMMA: warp w takes the row tiles 8 t (t = w, w + 8, ..,
// those that reach past l0), all four column tiles of each, Z += (-V) W
// with Z's fragment as the accumulator; each thread stores only its rows
// at or past l0 (the rows before are stale in the slab).
__device__ __forceinline__ void update_z(const double2* Vs,
                                         const double2* Ws, double2* Zs,
                                         int ldv, int ldz, int l0, int R,
                                         int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int k = lane & 3;
  for (int rt = warp; 8 * rt < R; rt += kThreads / 32) {
    if (8 * rt + 8 <= l0) continue;
    const int l = 8 * rt + (lane >> 2);  // A's row and D's row
    double2 v[4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      v[ks] = (l >= l0 && l < R) ? Vs[l * ldv + 4 * ks + k]
                                 : make_double2(0.0, 0.0);
    double zr[4][2], zi[4][2];
#pragma unroll
    for (int ct = 0; ct < 4; ++ct)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const double2 x = Zs[l * ldz + 8 * ct + 2 * k + j];
        zr[ct][j] = x.x;
        zi[ct][j] = x.y;
      }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int ct = 0; ct < 4; ++ct) {
        const double2 w = Ws[(4 * ks + k) * kCols + 8 * ct + (lane >> 2)];
        // Z -= v w: real -v.x w.x + v.y w.y, imaginary -v.x w.y - v.y w.x
        dmma(zr[ct][0], zr[ct][1], -v[ks].x, w.x);
        dmma(zr[ct][0], zr[ct][1], v[ks].y, w.y);
        dmma(zi[ct][0], zi[ct][1], -v[ks].x, w.y);
        dmma(zi[ct][0], zi[ct][1], -v[ks].y, w.x);
      }
    if (l >= l0 && l < R) {
#pragma unroll
      for (int ct = 0; ct < 4; ++ct)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          Zs[l * ldz + 8 * ct + 2 * k + j] = make_double2(zr[ct][j],
                                                          zi[ct][j]);
    }
  }
}

// Grid: ceil(keep / COLS) column tiles x G x batch, clusters of (1, G, 1):
// cluster (x, b) applies every panel (of NB reflectors) to columns [x COLS,
// x COLS + COLS) of matrix b; NB and COLS are the route's. R: the rows a
// CTA holds, ceil(m / G). The exchange of a panel: column c of Y and W
// belongs to rank c mod G. Every rank posts its
// partial of column c into that rank's buffer (slot = the poster's rank)
// and arrives on its `ybar`; the owner sums the G slots in rank order,
// forms W = T Y for its columns, posts them into every rank's W and
// arrives on each one's `wbar`. Each buffer is read before any rank can
// post into it again (a rank posts the next panel's partials only after it
// has every rank's W of this one), so one of each suffices.
template <typename T, int NB, int COLS>
__global__ void __launch_bounds__(kThreads)
    bt_apply_kernel(const T* __restrict__ z,
                    typename Cplx<T>::V* __restrict__ out,
                    const unsigned char* __restrict__ ws, int m, int keep,
                    int R, long long z_stride, long long ws_stride) {
  using V = typename Cplx<T>::V;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int g = (int)cluster.block_rank();
  {
    const size_t b = blockIdx.z;
    z += b * (size_t)z_stride;
    out += b * (size_t)m * keep;
    ws += b * (size_t)ws_stride;
  }
  const BtWs L = bt_ws(m, (int)sizeof(V));
  const BtSmem S = bt_smem(m, G, R, (int)sizeof(V));
  const int ldz = S.ldz, ldv = S.ldv, Rp = S.Rp, ncmax = S.ncmax;
  extern __shared__ __align__(16) unsigned char asm_raw[];
  V* sm = reinterpret_cast<V*>(asm_raw);
  V* Zs = sm + S.zs;
  V* Vb = sm + S.vb;
  V* Tb = sm + S.tb;
  V* Rv = sm + S.rv;  // [rank][i][column / G] of this rank's columns
  V* Yl = sm + S.yl;  // [i][column / G]
  V* Ws = sm + S.ws;  // [i][column]
  int* k0s = reinterpret_cast<int*>(sm + S.k0);
  __shared__ __align__(8) uint64_t vbar[2];
  __shared__ __align__(8) uint64_t ybar, wbar;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * COLS, cw = min(COLS, keep - c0);
  const int nown = (COLS - g + G - 1) / G;  // columns g, g + G, ..
  const T zero = 0;
  const V czero = mk(zero, zero);
  const int* meta = reinterpret_cast<const int*>(ws);
  const int npan = (meta[0] + NB - 1) / NB;

  for (int p = tid; p < npan; p += kThreads) k0s[p] = meta[1 + p];
  if (tid == 0) {
    mbar_init(&vbar[0]);
    mbar_init(&vbar[1]);
    mbar_init_count(&ybar, G);
    mbar_init_count(&wbar, G);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int idx = tid; idx < Rp * COLS; idx += kThreads) {
    const int l = idx / COLS, c = idx % COLS, r = g + l * G;
    Zs[l * ldz + c] =
        mk(l < R && r < m && c < cw ? z[(size_t)r * m + c0 + c] : zero, zero);
  }
  // every CTA has started and initialised its barriers before any posts
  cluster.sync();
  // this CTA's first row below panel p's first reflector (its rows above
  // are zero in every reflector of the panel)
  auto first_row = [&](int p) {
    const int k = k0s[p];
    return k >= g ? min(R, (k - g) / G + 1) : 0;
  };
  // one thread: panel p's T and this CTA's rows of it into buffer `buf`
  auto issue = [&](int p, int buf) {
    const int l0 = first_row(p);
    const uint32_t vbytes = (uint32_t)((R - l0) * ldv * sizeof(V));
    const uint32_t tbytes = (uint32_t)L.t_bytes;
    mbar_expect_tx(&vbar[buf], vbytes + tbytes);
    bulk_copy(Tb + (size_t)buf * NB * NB, ws + L.t_off + p * L.t_bytes,
              tbytes, &vbar[buf]);
    if (vbytes)
      bulk_copy(Vb + ((size_t)buf * Rp + l0) * ldv,
                ws + L.v_off + p * L.v_bytes +
                    ((size_t)g * R + l0) * ldv * sizeof(V),
                vbytes, &vbar[buf]);
  };
  if (npan > 0 && tid == 0) issue(npan - 1, 0);

  for (int it = 0; it < npan; ++it) {
    const int p = npan - 1 - it, buf = it & 1;
    const int l0 = first_row(p);
    mbar_wait(&vbar[buf], (it >> 1) & 1);
    // the other buffer was last read before the barrier that ended the
    // previous panel
    if (tid == 0 && p > 0) issue(p - 1, buf ^ 1);
    const V* Vs = Vb + (size_t)buf * Rp * ldv;
    const V* Ts = Tb + (size_t)buf * NB * NB;

    // this CTA's partial Y = V^H Z, posted to the rank that owns each
    // entry's column, in this rank's slot: two entries a thread
    {
      V y[2];
      int yi[2], yc[2];
      partial_y(Vs, Zs, ldv, ldz, l0, R, tid, y, yi, yc);
#pragma unroll
      for (int k = 0; k < 2; ++k)
        cluster.map_shared_rank(Rv, yc[k] % G)[(g * NB + yi[k]) * ncmax +
                                               yc[k] / G] = y[k];
    }
    __syncthreads();
    if (tid < G) mbar_arrive_remote(&ybar, tid);
    mbar_wait_cluster(&ybar, it & 1);
    // this rank's columns of Y: the G partials summed in rank order
    for (int idx = tid; idx < NB * nown; idx += kThreads) {
      const int i = idx / nown, lc = idx % nown;
      V acc = czero;
      for (int r = 0; r < G; ++r)
        acc = cadd(acc, Rv[(r * NB + i) * ncmax + lc]);
      Yl[i * ncmax + lc] = acc;
    }
    __syncthreads();
    // W = T Y on these columns (T upper triangular), posted to every
    // rank: `split` threads an entry where a rank owns few columns
    // (reflectors j = q mod 4 of T's row, summed by two shuffles in a fixed
    // order, the posts shared), else one
    const int split = 4 * NB * nown <= kThreads ? 4 : 1;
    for (int base = 0; base < split * NB * nown; base += kThreads) {
      const int idx = base + tid, e = idx / split, q = idx % split;
      const bool on = e < NB * nown;
      const int i = on ? e / nown : 0, lc = on ? e % nown : 0;
      V acc = czero;
      for (int j = i + ((q - i) & (split - 1)); on && j < NB; j += split)
        cfma(acc, Ts[i * NB + j], Yl[j * ncmax + lc]);
      if (split == 4) {
        acc = cadd(acc, mk(__shfl_xor_sync(0xffffffffu, acc.x, 1),
                           __shfl_xor_sync(0xffffffffu, acc.y, 1)));
        acc = cadd(acc, mk(__shfl_xor_sync(0xffffffffu, acc.x, 2),
                           __shfl_xor_sync(0xffffffffu, acc.y, 2)));
      }
      const int c = lc * G + g;
      for (int r = q; on && r < G; r += split)
        cluster.map_shared_rank(Ws, r)[i * COLS + c] = acc;
    }
    __syncthreads();
    if (tid < G) mbar_arrive_remote(&wbar, tid);
    mbar_wait_cluster(&wbar, it & 1);
    update_z(Vs, Ws, Zs, ldv, ldz, l0, R, tid);
    __syncthreads();  // Z and both buffers are read again by the next panel
  }
  for (int idx = tid; idx < R * COLS; idx += kThreads) {
    const int l = idx / COLS, c = idx % COLS, r = g + l * G;
    if (r < m && c < cw) out[(size_t)r * keep + c0 + c] = Zs[l * ldz + c];
  }
  cluster.sync();  // no CTA leaves while another may still post to it
}

// The launch plan at m for real type T and `clusters` column tiles of one
// matrix: the cluster size G, the rows a CTA R = ceil(m / G), both
// launches' shared memory and the workspace a matrix. It depends on m and
// the tiles alone, never on the batch, so that a batch gets the bits of
// its P = 1 launches. The first
// choice is G0 = ceil(m / kRowsCta) (ceil(m / kRowsSmall) at m <= 512,
// where a panel is short work), at most 16. Where the card holds fewer
// than `clusters` of that size at once (cudaOccupancyMaxActiveClusters),
// so that a second wave would run a few clusters alone, a smaller G down
// to G0 / 2 whose clusters all fit is taken instead (longer slabs, one
// wave): complex128 at m = 1024 runs its 16 tiles on clusters of 6, 15
// of 8 fitting at once on an H100. G = 0 (and *err) where nothing
// launches. NB and COLS: the panel and column tile.
struct BtPlan {
  int G, R;
  size_t smem, prep_smem;
  long long ws;
};

template <typename T, int NB, int COLS>
BtPlan bt_plan(int m, int clusters, cudaError_t* err) {
  using V = typename Cplx<T>::V;
  // the last plan at each m and the tiles it was made for (a launch pays
  // no runtime queries once its size has been planned)
  static BtPlan cached[kPlanCache + 1] = {};
  static int cached_for[kPlanCache + 1] = {};
  if (m <= kPlanCache && cached[m].G && cached_for[m] == clusters)
    return cached[m];
  // the clusters of size G that the card holds at once, by m and G
  // (0 unknown, else count + 1)
  static int resident[kPlanCache + 1][kMaxCluster + 1] = {};
  const void* fn = (const void*)bt_apply_kernel<T, NB, COLS>;
  const void* prep = (const void*)bt_prep_kernel<T, NB>;
  int dev = 0, optin = 0;
  cudaFuncAttributes fa, fp;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess ||
      (*err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (*err = cudaFuncGetAttributes(&fa, fn)) != cudaSuccess ||
      (*err = cudaFuncGetAttributes(&fp, prep)) != cudaSuccess ||
      (*err = cudaFuncSetAttribute(
           fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return BtPlan{};
  const size_t budget = (size_t)optin - fa.sharedSizeBytes;
  const int rows = m <= 512 ? kRowsSmall : kRowsCta;
  const int want = (m + rows - 1) / rows;
  const int g0 = want < kMaxCluster ? want : kMaxCluster;
  auto plan_of = [&](int G) {
    BtPlan pl;
    pl.G = G;
    pl.R = (m + G - 1) / G;
    pl.smem = bt_smem(m, G, pl.R, (int)sizeof(V)).total_bytes;
    pl.prep_smem = bt_prep_smem(m, (int)sizeof(V));
    pl.ws = (long long)bt_ws(m, (int)sizeof(V)).total;
    return pl;
  };
  // how many clusters of G the card holds at once (0: none)
  auto held = [&](const BtPlan& pl) {
    int* c = m <= kPlanCache ? &resident[m][pl.G] : nullptr;
    if (c && *c) return *c - 1;
    int n = 0;
    if (pl.smem <= budget && pl.prep_smem <= (size_t)optin &&
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)pl.smem) == cudaSuccess) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      cfg.gridDim = dim3(1, pl.G, 1);
      cfg.blockDim = dim3(kThreads, 1, 1);
      cfg.dynamicSmemBytes = pl.smem;
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 1;
      attr[0].val.clusterDim.y = pl.G;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) n = 0;
    }
    cudaGetLastError();  // a refused query or size is no launch error
    if (c) *c = n + 1;
    return n;
  };
  BtPlan pick = {};
  for (int G = g0; G >= (g0 + 1) / 2; --G) {
    const BtPlan pl = plan_of(G);
    const int n = held(pl);
    if (n == 0) continue;
    if (pick.G == 0) pick = pl;
    if (n >= clusters) {
      pick = pl;
      break;
    }
  }
  if (pick.G == 0 && g0 > 8 && held(plan_of(8)) > 0) pick = plan_of(8);
  if (pick.G == 0) {
    *err = cudaErrorInvalidConfiguration;
    return pick;
  }
  // every launch may use up to the budget: set once, for any plan
  if ((*err = cudaFuncSetAttribute(
           fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)budget)) !=
          cudaSuccess ||
      (*err = cudaFuncSetAttribute(
           prep, cudaFuncAttributeMaxDynamicSharedMemorySize,
           optin - (int)fp.sharedSizeBytes)) != cudaSuccess)
    return BtPlan{};
  if (m <= kPlanCache) {
    cached[m] = pick;
    cached_for[m] = clusters;
  }
  return pick;
}

template <typename T, int NB, int COLS>
int bt_run_route(const void* vrows, const void* tau, const void* z,
                 void* out, void* ws, int m, int keep, int batch,
                 long long v_stride, long long tau_stride, long long z_stride,
                 void* stream) {
  using V = typename Cplx<T>::V;
  cudaError_t err = cudaSuccess;
  const int tiles = (keep + COLS - 1) / COLS;
  const BtPlan pl = bt_plan<T, NB, COLS>(m, tiles, &err);
  if (pl.G == 0) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int npmax = bt_ws(m, (int)sizeof(V)).npmax;
  bt_prep_kernel<T, NB><<<dim3(npmax, batch), kThreads, pl.prep_smem, st>>>(
      (const V*)vrows, (const V*)tau, (unsigned char*)ws, m, pl.G, pl.R,
      v_stride, tau_stride, pl.ws);
  ADAPTAQC_RETURN_IF_ERR(cudaGetLastError());
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(tiles, pl.G, batch);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = pl.G;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  ADAPTAQC_RETURN_IF_ERR(cudaLaunchKernelEx(
      &cfg, bt_apply_kernel<T, NB, COLS>, (const T*)z, (V*)out,
      (const unsigned char*)ws, m, keep, pl.R, z_stride, pl.ws));
  return (int)cudaGetLastError();
}

template <typename T>
int bt_run(const void* vrows, const void* tau, const void* z, void* out,
           void* ws, int m, int keep, int batch, long long v_stride,
           long long tau_stride, long long z_stride, void* stream, int lo) {
  if (m < lo || m > bt_max_m((int)sizeof(typename Cplx<T>::V)) || keep < 1 ||
      keep > m || batch < 1 || batch > kMaxBatch)
    return (int)cudaErrorInvalidValue;
  return bt_run_route<T, kNb, kCols>(vrows, tau, z, out, ws, m, keep, batch,
                                     v_stride, tau_stride, z_stride, stream);
}

template <typename T>
int bt_cluster_size(int m, int keep) {
  cudaError_t err = cudaSuccess;
  return bt_plan<T, kNb, kCols>(m, (keep + kCols - 1) / kCols, &err).G;
}

}  // namespace

extern "C" {

// The workspace of one matrix in bytes (the wrapper allocates batch times
// it), in complex64 (f64 = 0, 128 < m <= 5888) or complex128 (2 <= m <=
// 2816); 0 outside.
long long backtransform_workspace(int m, int f64) {
  if (m < (f64 ? 2 : 129) || m > bt_max_m(f64 ? 16 : 8)) return 0;
  return (long long)bt_ws(m, f64 ? 16 : 8).total;
}

// bt_apply_kernel's dynamic shared memory in bytes at m on a cluster of G
// CTAs (the sizes of backtransform_workspace); 0 outside.
long long backtransform_apply_smem(int m, int G, int f64) {
  if (m < (f64 ? 2 : 129) || m > bt_max_m(f64 ? 16 : 8) || G < 1 ||
      G > kMaxCluster)
    return 0;
  return (long long)bt_smem(m, G, (m + G - 1) / G, f64 ? 16 : 8)
      .total_bytes;
}

// The CTAs of the cluster over a column tile's rows at m, for `keep`
// columns of one matrix; 0 on error or outside.
int backtransform_cluster_size(int m, int keep, int f64) {
  if (m < (f64 ? 2 : 129) || m > bt_max_m(f64 ? 16 : 8) || keep < 1 ||
      keep > m)
    return 0;
  return f64 ? bt_cluster_size<double>(m, keep)
             : bt_cluster_size<float>(m, keep);
}

// out (batch, m, keep) = H_0 ... H_{m-2} z[:, :keep] for each matrix, in
// complex64 (128 < m <= 5888); ws: batch x backtransform_workspace(m, 0)
// bytes.
// Two launches on `stream`; returns the first launch error.
int backtransform_wide_launch(const void* vrows, const void* tau,
                              const void* z, void* out, void* ws, int m,
                              int keep, int batch, long long v_stride,
                              long long tau_stride, long long z_stride,
                              void* stream) {
  return bt_run<float>(vrows, tau, z, out, ws, m, keep, batch, v_stride,
                       tau_stride, z_stride, stream, 129);
}

// The same in complex128 / float64, at 2 <= m <= 2816.
int backtransform_f64_launch(const void* vrows, const void* tau,
                             const void* z, void* out, void* ws, int m,
                             int keep, int batch, long long v_stride,
                             long long tau_stride, long long z_stride,
                             void* stream) {
  return bt_run<double>(vrows, tau, z, out, ws, m, keep, batch, v_stride,
                        tau_stride, z_stride, stream, 2);
}

}  // extern "C"
