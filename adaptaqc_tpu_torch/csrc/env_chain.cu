// Environment-chain kernel of the sweep probes, for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel _env_kernel
// (ops/pallas_env.py:46). Given the B-form site tensors of the bra R and the
// ket L, each (n, 2, chi, chi) complex64, it returns the 2x2 local overlap
// matrix C[i, j] = <R| (|i><j| at site q) |L>:
//   forward   e' = sum_p A_p^H e B_p        over sites 0 .. q-1
//   backward  f' = sum_p conj(A_p) f B_p^T  over sites n-1 .. q+1
//   combine   C[i, j] = sum_{a,y} G_j[a,y] K_i[a,y],
//             G_j = e B_j, K_i = conj(A_i) f   at site q.
//
// What bounds it on this card: 32 chi^3 flops a site (8.4 MFLOP at chi =
// 64, 419 MFLOP for n = 50), about 6 us at the fp32 peak, but each chain is a
// sequence of dependent sites, so the time is the critical path of
// max(q, n-1-q) sites times the latency of one site. A site on one SM is
// bound by its FMA issue rate and its shared-memory loads (the first port,
// one block a chain with one output a thread and two loads an FMA, took
// 65 us a site at chi = 64).
//
// The design spreads each site over a thread-block cluster, so a site's
// latency is a cluster's, not an SM's:
//   - Each chain runs on its own cluster of `cs` CTAs (8, or 16 where the
//     non-portable size is allowed and two such clusters fit); the two
//     clusters run concurrently. CTA r owns a slab of s = ceil(chi / cs) rows
//     of the environment (ragged: the last slabs may be short or empty).
//   - Step 1, M_p = E B_p (forward) or F B_p^T (backward), for its own rows:
//     local data only. Backward reads B_p by columns; each thread walks the
//     contraction index rotated by its first column, so those reads fall in
//     distinct banks.
//   - Step 2 contracts over the slab's rows a: the CTA forms the partial
//     P_r = sum_{p, a in slab} conj(A_p[a, :])^T M_p[a, :] over all chi x chi
//     entries (forward; backward takes A_p's columns) and stores each row
//     of it straight into the shared memory of the CTA that owns that row
//     (distributed shared memory, cluster.map_shared_rank: posted stores,
//     where pulling the partials with remote loads cost a round trip each).
//     After one cluster barrier each CTA adds the cs partials it received,
//     ranks in a fixed order. That is one cluster barrier a site: the
//     receive buffers are double-buffered, so site i+1's stores cannot race
//     site i's sums.
//   - Products are register-tiled: 2 x 2 complex outputs a thread in step 1
//     (three loads feed 16 FMAs; smaller where a short slab would leave
//     fewer than four warps busy), 4 x 4 in step 2 (eight loads feed 64;
//     2 x 2 below chi = 64, so that every thread still has a tile).
//   - The sites stream in asynchronously: the next B_p (16 chi^2 contiguous
//     bytes) is one bulk copy (cp.async.bulk, completion on an mbarrier)
//     issued as soon as step 1 has read the current one, and the next slab
//     of A_p is a cp.async group issued a whole site ahead (double buffer).
//     Each CTA copies B_p for itself (the prefetch hides it: a CTA waits
//     about 100 cycles a site for it), where a multicast would add a
//     cluster-wide handshake before each buffer could be refilled.
//   - The combine runs in the cluster that finishes its chain last: each
//     cluster writes its snapshot to global memory, and the second to bump
//     a counter reads both back and computes C, again a slab of rows a CTA
//     with one cluster reduction at the end; it then resets the counter.
//     No second launch, and no cluster waits on the other.
// All arithmetic is fp32 FMA on the CUDA cores; no tensor-core (TF32) path.
//
// The wide variant (kWide) is the complex128 instantiation alone (below):
// at chi = 128 a site's B_p pair and the receive buffers each outgrow a
// CTA's 227 KB, so step 1 reads B_p straight from global memory (the whole
// ket stack stays in L2; __ldg), A's slab is single-buffered (its copy
// overlaps step 1), one more cluster barrier a site guards the single
// receive buffer, and the combine reads f from the snapshot in global
// memory (__ldcg). complex64 above chi = 64 runs csrc/env_chain_wide.cu.
//
// complex128 (env_chain_kernel<double2, true, true>, every chi <= 128): the
// wide variant in double, whose receive buffers would take 256 KB at
// chi = 128 on their own. So each CTA posts its partials into a buffer in
// global memory (the wrapper's, L2-resident: laid out as the shared
// receive buffers of every CTA of both clusters, one after another) and
// reads the cs partials of its rows back from there (__ldcg) after the
// cluster barrier, whose release and acquire order them; shared memory
// keeps A's slab, M, E and the combine's K (7 s chi double2: 224 KB at
// chi = 128 on 8 CTAs).
//
// What bounds it now (clock64() split, tools/stage_clocks.py): a site takes
// about 11k cycles at chi = 64 on 16 CTAs, about 4k each in steps 1 and 2
// (issue- and shared-memory-bound on a CTA's small share: 131k FMAs a
// step) and about 3k in the cluster barrier and the exchange of partials;
// the exchange moves chi^2 complex values into each CTA a site whatever the
// cluster size, so 16 CTAs beat 8 by about 1.3x, not 2x.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using adaptaqc::block_sum;
using adaptaqc::bulk_load;
using adaptaqc::cp_async_elem;
using adaptaqc::cp_async_commit;
using adaptaqc::cp_async_wait;
using adaptaqc::mbar_init;
using adaptaqc::mbar_wait;

constexpr int kThreads = 256;
constexpr int kMaxChi = 128;
constexpr int kNarrowMaxChi = 64;  // complex64 above it: env_chain_wide.cu

// Offsets (in complex elements) of the dynamic shared-memory buffers.
struct Layout {
  int B;       // 2 chi^2: B_0, B_1 of the current site (bulk-copy target;
               // none in the wide variant)
  int P[2];    // cs s chi each (>= chi^2): partial sums received from every
               // CTA of the cluster for this slab's rows, double-buffered
               // (single in the wide variant: P[1] == P[0])
  int A[2];    // 2 s chi each: the slab of A_0, A_1, double-buffered
               // (single in the wide variant)
  int M;       // 2 s chi: M_0, M_1 for the slab's rows
  int E;       // s chi: the slab's rows of the environment
  int total;
};

// (global_p: the partials go through global memory; P[0] then only holds
// the combine's K, 2 s chi)
__host__ __device__ inline Layout make_layout(int c, int s, int cs,
                                              bool wide, bool global_p) {
  Layout L;
  int off = 0;
  L.B = off;    off += wide ? 0 : 2 * c * c;
  L.P[0] = off; off += global_p ? 2 * s * c : cs * s * c;
  L.P[1] = off; off += wide ? 0 : cs * s * c;
  if (wide) L.P[1] = L.P[0];
  L.A[0] = off; off += 2 * s * c;
  L.A[1] = off; off += wide ? 0 : 2 * s * c;
  if (wide) L.A[1] = L.A[0];
  L.M = off;    off += 2 * s * c;
  L.E = off;    off += s * c;
  L.total = off;
  return L;
}

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
}

// acc += conj(a) b
__device__ __forceinline__ void cfma_conj(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(-a.y, b.x, acc.y));
}

// the same in complex128
__device__ __forceinline__ void cfma(double2& acc, double2 a, double2 b) {
  acc.x = fma(a.x, b.x, fma(-a.y, b.y, acc.x));
  acc.y = fma(a.x, b.y, fma(a.y, b.x, acc.y));
}
__device__ __forceinline__ void cfma_conj(double2& acc, double2 a,
                                          double2 b) {
  acc.x = fma(a.x, b.x, fma(a.y, b.y, acc.x));
  acc.y = fma(a.x, b.y, fma(-a.y, b.x, acc.y));
}

__device__ __forceinline__ float2 make_c(float x, float y) {
  return make_float2(x, y);
}
__device__ __forceinline__ double2 make_c(double x, double y) {
  return make_double2(x, y);
}

// How R is read: from shared memory, or from global memory through the
// read-only cache (the ket's site tensors) or around L1 (a snapshot the
// other cluster wrote during this launch).
enum RLoad { kShared, kGlobalRO, kGlobalCG };

template <int LD, typename V>
__device__ __forceinline__ V load_r(const V* p) {
  if (LD == kGlobalRO) return __ldg(p);
  if (LD == kGlobalCG) return __ldcg(p);
  return *p;
}

// out_p[a][y] = sum_b L_p[a][b] R_p(b, y) for p = 0, 1, a < rows, y < c;
// L_p = L + p * l_stride (conjugated if CONJ_L), R_p(b, y) = R[p * r_stride
// + b * c + y], or R[p * r_stride + y * c + b] if TRANS, read as LD says.
// out_p = out + p * s * c. Each thread owns RA rows x RY columns (y0,
// y0 + ny, ...).
template <bool TRANS, bool CONJ_L, int RA, int RY, int LD, typename V>
__device__ void slab_tiles(const V* L, int l_stride, const V* R,
                           int r_stride, V* out, int rows, int s, int c) {
  const int ny = (c + RY - 1) / RY;
  const int na = (rows + RA - 1) / RA;
  const int tiles = 2 * na * ny;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const int yg = t % ny;
    const int ag = (t / ny) % na;
    const int p = t / (ny * na);
    const V* Lp = L + p * l_stride;
    const V* Rp = R + p * r_stride;
    int ai[RA], yi[RY];
#pragma unroll
    for (int k = 0; k < RA; ++k) ai[k] = min(ag * RA + k, rows - 1);
#pragma unroll
    for (int k = 0; k < RY; ++k) yi[k] = min(yg + k * ny, c - 1);
    V acc[RA][RY];
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RY; ++j) acc[i][j] = V{};
    // transposed reads walk b from the thread's own offset: distinct banks
    int b = TRANS ? yg % c : 0;
#pragma unroll 4
    for (int it = 0; it < c; ++it) {
      V l[RA], r[RY];
#pragma unroll
      for (int k = 0; k < RA; ++k) {
        l[k] = Lp[ai[k] * c + b];
        if (CONJ_L) l[k].y = -l[k].y;
      }
#pragma unroll
      for (int k = 0; k < RY; ++k)
        r[k] = load_r<LD>(TRANS ? Rp + yi[k] * c + b : Rp + b * c + yi[k]);
#pragma unroll
      for (int i = 0; i < RA; ++i)
#pragma unroll
        for (int j = 0; j < RY; ++j) cfma(acc[i][j], l[i], r[j]);
      b = (b + 1 == c) ? 0 : b + 1;
    }
    V* op = out + p * s * c;
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        const int a = ag * RA + i, y = yg + j * ny;
        if (a < rows && y < c) op[a * c + y] = acc[i][j];
      }
  }
}

// The largest register tile that keeps four warps busy: 2 x 2, or 2 x 1
// or 1 x 1 where the slab is short (chi = 32 on 16 CTAs has 2 rows).
template <bool TRANS, bool CONJ_L, int LD = kShared, typename V>
__device__ void slab_times(const V* L, int l_stride, const V* R,
                           int r_stride, V* out, int rows, int s, int c) {
  const int busy = (int)blockDim.x / 2, ra = (rows + 1) / 2;
  if (2 * ra * ((c + 1) / 2) >= busy)
    slab_tiles<TRANS, CONJ_L, 2, 2, LD>(L, l_stride, R, r_stride, out, rows,
                                        s, c);
  else if (2 * ra * c >= busy)
    slab_tiles<TRANS, CONJ_L, 2, 1, LD>(L, l_stride, R, r_stride, out, rows,
                                        s, c);
  else
    slab_tiles<TRANS, CONJ_L, 1, 1, LD>(L, l_stride, R, r_stride, out, rows,
                                        s, c);
}

// This CTA's partial P[x][y] = sum_{p, a < rows} conj(A[p][a][x])
// M[p][a][y] for all x, y < c (A and M laid out [p][a][.] with s rows a
// block), RX x RY outputs a thread, each stored straight into the shared
// memory of the CTA that owns row x: slot R[rank][x - owner * s][y] of its
// receive buffer R (the same offset in every CTA). GLOBAL_P: R is instead
// the cluster's buffer in global memory, the owners' receive buffers one
// after another (cs s c each).
template <int RX, int RY, bool GLOBAL_P, typename V>
__device__ void partial_tiles(cg::cluster_group& cluster, const V* A,
                              const V* M, V* R, int rows, int s, int c,
                              int rank) {
  const int cs = (int)cluster.num_blocks();
  const int nx = (c + RX - 1) / RX, ny = (c + RY - 1) / RY;
  for (int t = threadIdx.x; t < nx * ny; t += blockDim.x) {
    const int yg = t % ny, xg = t / ny;
    int xi[RX], yi[RY];
#pragma unroll
    for (int k = 0; k < RX; ++k) xi[k] = min(xg + k * nx, c - 1);
#pragma unroll
    for (int k = 0; k < RY; ++k) yi[k] = min(yg + k * ny, c - 1);
    V acc[RX][RY];
#pragma unroll
    for (int i = 0; i < RX; ++i)
#pragma unroll
      for (int j = 0; j < RY; ++j) acc[i][j] = V{};
    for (int p = 0; p < 2; ++p) {
#pragma unroll 2
      for (int a = 0; a < rows; ++a) {
        const V* Ar = A + (p * s + a) * c;
        const V* Mr = M + (p * s + a) * c;
        V av[RX], mv[RY];
#pragma unroll
        for (int k = 0; k < RX; ++k) av[k] = Ar[xi[k]];
#pragma unroll
        for (int k = 0; k < RY; ++k) mv[k] = Mr[yi[k]];
#pragma unroll
        for (int i = 0; i < RX; ++i)
#pragma unroll
          for (int j = 0; j < RY; ++j) cfma_conj(acc[i][j], av[i], mv[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RX; ++i) {
      const int x = xg + i * nx;
      if (x >= c) continue;
      const int owner = x / s;
      V* dst = (GLOBAL_P ? R + (size_t)owner * cs * s * c
                         : cluster.map_shared_rank(R, owner)) +
               (rank * s + x - owner * s) * c;
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        const int y = yg + j * ny;
        if (y < c) dst[y] = acc[i][j];
      }
    }
  }
}

// 4 x 4 tiles where that keeps every thread busy (chi >= 64), else 2 x 2.
template <bool GLOBAL_P, typename V>
__device__ void partial_env(cg::cluster_group& cluster, const V* A,
                            const V* M, V* R, int rows, int s, int c,
                            int rank) {
  const int n4 = (c + 3) / 4;
  if (n4 * n4 >= (int)blockDim.x)
    partial_tiles<4, 4, GLOBAL_P>(cluster, A, M, R, rows, s, c, rank);
  else
    partial_tiles<2, 2, GLOBAL_P>(cluster, A, M, R, rows, s, c, rank);
}

// Issue the cp.async copies of site `site`'s slab of A_0, A_1 into dst laid
// out [p][a][x]: forward A_p[x0 + a][x] (rows), backward A_p[x][x0 + a].
template <typename V>
__device__ void load_a_slab(V* dst, const V* br, int site, int x0, int rows,
                            int s, int c, bool fwd) {
  const V* src = br + (size_t)site * 2 * c * c;
  const int total = 2 * rows * c;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int p, a, x;
    if (fwd) {  // x fastest: contiguous global reads
      x = idx % c;
      a = (idx / c) % rows;
      p = idx / (c * rows);
      cp_async_elem(dst + (p * s + a) * c + x,
                    src + p * c * c + (x0 + a) * c + x);
    } else {    // a fastest: each row's slab is contiguous
      a = idx % rows;
      x = (idx / rows) % c;
      p = idx / (rows * c);
      cp_async_elem(dst + (p * s + a) * c + x,
                    src + p * c * c + x * c + x0 + a);
    }
  }
}

// Grid: two clusters of cs CTAs; cluster 0 walks the forward chain over
// sites [0, q), cluster 1 the backward chain over (q, n). snaps (2, chi,
// chi) receives e_q and f_q; counter (one int, zero on entry) picks the
// cluster that combines; out (2, 2) receives C. V: float2 (complex64) or
// double2 (complex128); kWide: the wide variant (top of this file), run
// in complex128 alone; kGlobalP: the partials go through `partials` in
// global memory (2 cs cs s chi elements), not through shared memory.
template <typename V, bool kWide, bool kGlobalP>
__global__ void __launch_bounds__(kThreads, 1)
    env_chain_kernel(const V* __restrict__ br, const V* __restrict__ bl,
                     V* snaps, V* partials, int* counter, V* __restrict__ out,
                     int n, int c, int q) {
  using T = decltype(V::x);
  static_assert(kWide || !kGlobalP, "global partials are a wide mode");
  extern __shared__ __align__(128) unsigned char sm_raw[];
  V* sm = reinterpret_cast<V*>(sm_raw);
  __shared__ __align__(8) uint64_t bar;
  __shared__ T red[33];
  __shared__ V cpart[4];
  __shared__ int last_flag;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool fwd = blockIdx.x < (unsigned)cs;
  const int s = (c + cs - 1) / cs;
  const int x0 = rank * s;
  const int rows = max(0, min(s, c - x0));
  const Layout L = make_layout(c, s, cs, kWide, kGlobalP);
  V* B = sm + L.B;
  V* M = sm + L.M;
  V* E = sm + L.E;
  // this cluster's partials buffer (kGlobalP), and this CTA's receive
  // part of it
  V* Pg = kGlobalP ? partials + (fwd ? 0 : (size_t)cs * cs * s * c)
                   : nullptr;
  const V* Rg = kGlobalP ? Pg + (size_t)rank * cs * s * c : nullptr;
  const int cc = c * c;
  const size_t site = (size_t)2 * cc;
  const int count = fwd ? q : n - 1 - q;
  const int tid = threadIdx.x;

  if (tid == 0 && !kWide) mbar_init(&bar);
  for (int idx = tid; idx < s * c; idx += blockDim.x)
    E[idx] = make_c((x0 == 0 && idx == 0) ? T(1) : T(0), T(0));
  __syncthreads();

  // prefetch the first site
  if (count > 0 && !kWide) {
    const int i0 = fwd ? 0 : n - 1;
    if (tid == 0)
      bulk_load(B, bl + i0 * site, (uint32_t)(site * sizeof(V)), &bar);
    load_a_slab(sm + L.A[0], br, i0, x0, rows, s, c, fwd);
    cp_async_commit();
  }
  for (int step = 0; step < count; ++step) {
    const int i = fwd ? step : n - 1 - step;
    const int inext = fwd ? i + 1 : i - 1;
    const bool more = step + 1 < count;
    if (kWide) {
      // this site's slab of A lands while step 1 reads B_p from L2
      load_a_slab(sm + L.A[0], br, i, x0, rows, s, c, fwd);
      cp_async_commit();
      if (fwd)
        slab_times<false, false, kGlobalRO>(E, 0, bl + i * site, cc, M, rows,
                                            s, c);
      else
        slab_times<true, false, kGlobalRO>(E, 0, bl + i * site, cc, M, rows,
                                           s, c);
      cp_async_wait<0>();
      __syncthreads();
    } else {
      if (more) load_a_slab(sm + L.A[(step + 1) & 1], br, inext, x0, rows, s,
                            c, fwd);
      cp_async_commit();  // (an empty group on the last site)
      mbar_wait(&bar, step & 1);
      // step 1: M_p = E B_p (forward) or F B_p^T (backward), own rows
      if (fwd)
        slab_times<false, false>(E, 0, B, cc, M, rows, s, c);
      else
        slab_times<true, false>(E, 0, B, cc, M, rows, s, c);
      cp_async_wait<1>();  // this thread's copies of A (this site) landed
      __syncthreads();
      if (more && tid == 0)
        bulk_load(B, bl + inext * site, (uint32_t)(site * sizeof(V)), &bar);
    }
    // step 2: this CTA's partial sum over its rows, pushed to the rows'
    // owners; after the barrier each CTA adds what it received
    V* R = kGlobalP ? Pg : sm + L.P[step & 1];
    partial_env<kGlobalP>(cluster, sm + L.A[step & 1], M, R, rows, s, c,
                          rank);
    cluster.sync();
    for (int idx = tid; idx < rows * c; idx += blockDim.x) {
      V acc = V{};
      for (int r = 0; r < cs; ++r) {
        const V v = kGlobalP ? __ldcg(Rg + r * s * c + idx)
                             : sm[L.P[step & 1] + r * s * c + idx];
        acc.x += v.x;
        acc.y += v.y;
      }
      E[idx] = acc;
    }
    // the wide variant's single receive buffer: every CTA has summed it
    // before any CTA stores the next site's partials into it
    if (kWide)
      cluster.sync();
    else
      __syncthreads();
  }
  cp_async_wait<0>();

  // snapshot, then the counter decides which cluster combines
  V* snap = snaps + (fwd ? 0 : cc);
  for (int idx = tid; idx < rows * c; idx += blockDim.x)
    snap[x0 * c + idx] = E[idx];
  __threadfence();
  cluster.sync();
  if (rank == 0 && tid == 0) last_flag = atomicAdd(counter, 1);
  cluster.sync();
  const int last = *cluster.map_shared_rank(&last_flag, 0) == 1;
  cluster.sync();
  if (!last) return;
  __threadfence();

  // combine at site q: G_j = e B_j (slab rows), K_i = conj(A_i) f
  V* F = sm + L.P[0];
  V* K = kWide ? sm + L.P[0] : sm + L.A[1];
  const V* Bq = bl + q * site;
  const V* Aq = br + q * site;
  if (!kWide) {
    for (int idx = tid; idx < cc; idx += blockDim.x)
      F[idx] = __ldcg(snaps + cc + idx);
    for (int idx = tid; idx < 2 * cc; idx += blockDim.x) B[idx] = Bq[idx];
  }
  for (int idx = tid; idx < rows * c; idx += blockDim.x)
    E[idx] = __ldcg(snaps + x0 * c + idx);
  for (int idx = tid; idx < 2 * rows * c; idx += blockDim.x) {
    const int p = idx / (rows * c), rem = idx - p * rows * c;
    sm[L.A[0] + p * s * c + rem] = Aq[p * cc + x0 * c + rem];
  }
  __syncthreads();
  if (kWide) {
    slab_times<false, false, kGlobalRO>(E, 0, Bq, cc, M, rows, s, c);
    slab_times<false, true, kGlobalCG>(sm + L.A[0], s * c, snaps + cc, 0, K,
                                       rows, s, c);
  } else {
    slab_times<false, false>(E, 0, B, cc, M, rows, s, c);
    slab_times<false, true>(sm + L.A[0], s * c, F, 0, K, rows, s, c);
  }
  __syncthreads();
  T part[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int idx = tid; idx < rows * c; idx += blockDim.x) {
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const V g = M[jj * s * c + idx], k = K[ii * s * c + idx];
        part[(ii * 2 + jj) * 2] += g.x * k.x - g.y * k.y;
        part[(ii * 2 + jj) * 2 + 1] += g.x * k.y + g.y * k.x;
      }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) part[k] = block_sum(part[k], red);
  if (tid == 0)
    for (int k = 0; k < 4; ++k)
      cpart[k] = make_c(part[2 * k], part[2 * k + 1]);
  cluster.sync();
  if (rank == 0 && tid < 4) {
    V acc = V{};
    for (int r = 0; r < cs; ++r) {
      const V v = cluster.map_shared_rank(cpart, r)[tid];
      acc.x += v.x;
      acc.y += v.y;
    }
    out[tid] = acc;
    if (tid == 0) *counter = 0;
  }
  cluster.sync();  // keep every CTA's shared memory alive for rank 0's reads
}

// f64: the complex128 kernel (every chi), else the narrow complex64 one.
size_t smem_bytes(int c, int cs, bool f64) {
  const Layout L = make_layout(c, (c + cs - 1) / cs, cs, f64, f64);
  return (size_t)L.total * (f64 ? sizeof(double2) : sizeof(float2));
}

// The kernel that serves chi (as a function pointer for the attribute and
// occupancy calls).
const void* kernel_for(bool f64) {
  return f64 ? (const void*)env_chain_kernel<double2, true, true>
             : (const void*)env_chain_kernel<float2, false, false>;
}

cudaLaunchConfig_t make_config(cudaLaunchAttribute* attr, int cs, size_t smem,
                               cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * cs, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster size for chi: 16 CTAs where the non-portable size is allowed
// and two such clusters fit on the card at once, else 8; never more CTAs
// than rows. Returns 0 (and sets *err) if no size can be launched.
int pick_cluster(int c, bool f64, cudaError_t* err) {
  static int cached[2][kMaxChi + 1] = {{0}};
  if (cached[f64][c]) return cached[f64][c];
  const void* fn = kernel_for(f64);
  *err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (*err != cudaSuccess) return 0;
  for (int cs : {16, 8}) {
    const int use = cs < c ? cs : c;
    const size_t smem = smem_bytes(c, use, f64);
    *err = cudaFuncSetAttribute(fn,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
    if (*err != cudaSuccess) return 0;
    if (use <= 8) {
      cached[f64][c] = use;
      return use;
    }
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = make_config(attr, use, smem, 0);
    int clusters = 0;
    const cudaError_t q =
        cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (q == cudaSuccess && clusters >= 2) {
      cached[f64][c] = use;
      return use;
    }
    cudaGetLastError();  // a refused query is not an error of the launch
  }
  *err = cudaErrorInvalidConfiguration;
  return 0;
}

template <typename V, bool kWide, bool kGlobalP>
cudaError_t launch_chain(cudaLaunchConfig_t* cfg, const void* br,
                         const void* bl, void* snaps, void* partials,
                         void* counter, void* out, int n, int chi, int q) {
  return cudaLaunchKernelEx(cfg, env_chain_kernel<V, kWide, kGlobalP>,
                            (const V*)br, (const V*)bl, (V*)snaps,
                            (V*)partials, (int*)counter, (V*)out, n, chi, q);
}

int launch(const void* br, const void* bl, void* snaps, void* partials,
           void* counter, void* out, int n, int chi, int q, void* stream,
           bool f64) {
  if (chi < 1 || chi > (f64 ? kMaxChi : kNarrowMaxChi) || n < 1 || q < 0 ||
      q >= n || ((uintptr_t)br | (uintptr_t)bl) % 16 != 0 ||
      (f64 && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const int cs = pick_cluster(chi, f64, &err);
  if (cs == 0) return (int)err;
  const size_t smem = smem_bytes(chi, cs, f64);
  const void* fn = kernel_for(f64);
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = make_config(attr, cs, smem, (cudaStream_t)stream);
  if (f64)
    ADAPTAQC_RETURN_IF_ERR((launch_chain<double2, true, true>(
        &cfg, br, bl, snaps, partials, counter, out, n, chi, q)));
  else
    ADAPTAQC_RETURN_IF_ERR((launch_chain<float2, false, false>(
        &cfg, br, bl, snaps, partials, counter, out, n, chi, q)));
  return (int)cudaGetLastError();
}

}  // namespace

// The cluster size the launcher picks for chi (0 on error); f64: for the
// complex128 kernel.
extern "C" int env_chain_cluster_size(int chi, int f64) {
  if (chi < 1 || chi > (f64 ? kMaxChi : kNarrowMaxChi)) return 0;
  cudaError_t err = cudaSuccess;
  return pick_cluster(chi, f64 != 0, &err);
}

// counter must hold 0 and stay private to this stream's launches (the
// kernel leaves it at 0); br and bl must be 16-byte aligned. complex64,
// chi <= 64 (above: env_chain_wide_launch, the same arguments).
extern "C" int env_chain_launch(const void* br, const void* bl, void* snaps,
                                void* counter, void* out, int n, int chi,
                                int q, void* stream) {
  return launch(br, bl, snaps, nullptr, counter, out, n, chi, q, stream,
                false);
}

// The complex128 chain (1 <= chi <= 128): as env_chain_launch, and
// `partials` holds env_chain_f64_partials(chi) double2 of scratch.
extern "C" long long env_chain_f64_partials(int chi) {
  const int cs = env_chain_cluster_size(chi, 1);
  if (cs == 0) return 0;
  return 2LL * cs * cs * ((chi + cs - 1) / cs) * chi;
}

extern "C" int env_chain_f64_launch(const void* br, const void* bl,
                                    void* snaps, void* partials,
                                    void* counter, void* out, int n, int chi,
                                    int q, void* stream) {
  return launch(br, bl, snaps, partials, counter, out, n, chi, q, stream,
                true);
}
