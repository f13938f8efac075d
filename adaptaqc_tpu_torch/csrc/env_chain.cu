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
using adaptaqc::cp_async8;
using adaptaqc::cp_async_commit;
using adaptaqc::cp_async_wait;
using adaptaqc::mbar_init;
using adaptaqc::mbar_wait;

constexpr int kThreads = 256;
constexpr int kMaxChi = 64;

// Offsets (in float2) of the dynamic shared-memory buffers.
struct Layout {
  int B;       // 2 chi^2: B_0, B_1 of the current site (bulk-copy target)
  int P[2];    // cs s chi each (>= chi^2): partial sums received from every
               // CTA of the cluster for this slab's rows, double-buffered
  int A[2];    // 2 s chi each: the slab of A_0, A_1, double-buffered
  int M;       // 2 s chi: M_0, M_1 for the slab's rows
  int E;       // s chi: the slab's rows of the environment
  int total;
};

__host__ __device__ inline Layout make_layout(int c, int s, int cs) {
  Layout L;
  int off = 0;
  L.B = off;    off += 2 * c * c;
  L.P[0] = off; off += cs * s * c;
  L.P[1] = off; off += cs * s * c;
  L.A[0] = off; off += 2 * s * c;
  L.A[1] = off; off += 2 * s * c;
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

// out_p[a][y] = sum_b L_p[a][b] R_p(b, y) for p = 0, 1, a < rows, y < c;
// L_p = L + p * l_stride (conjugated if CONJ_L), R_p(b, y) = R[p * r_stride
// + b * c + y], or R[p * r_stride + y * c + b] if TRANS. out_p = out +
// p * s * c. Each thread owns RA rows x RY columns (y0, y0 + ny, ...).
template <bool TRANS, bool CONJ_L, int RA, int RY>
__device__ void slab_tiles(const float2* L, int l_stride, const float2* R,
                           int r_stride, float2* out, int rows, int s, int c) {
  const int ny = (c + RY - 1) / RY;
  const int na = (rows + RA - 1) / RA;
  const int tiles = 2 * na * ny;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const int yg = t % ny;
    const int ag = (t / ny) % na;
    const int p = t / (ny * na);
    const float2* Lp = L + p * l_stride;
    const float2* Rp = R + p * r_stride;
    int ai[RA], yi[RY];
#pragma unroll
    for (int k = 0; k < RA; ++k) ai[k] = min(ag * RA + k, rows - 1);
#pragma unroll
    for (int k = 0; k < RY; ++k) yi[k] = min(yg + k * ny, c - 1);
    float2 acc[RA][RY];
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RY; ++j) acc[i][j] = make_float2(0.f, 0.f);
    // transposed reads walk b from the thread's own offset: distinct banks
    int b = TRANS ? yg % c : 0;
#pragma unroll 4
    for (int it = 0; it < c; ++it) {
      float2 l[RA], r[RY];
#pragma unroll
      for (int k = 0; k < RA; ++k) {
        l[k] = Lp[ai[k] * c + b];
        if (CONJ_L) l[k].y = -l[k].y;
      }
#pragma unroll
      for (int k = 0; k < RY; ++k)
        r[k] = TRANS ? Rp[yi[k] * c + b] : Rp[b * c + yi[k]];
#pragma unroll
      for (int i = 0; i < RA; ++i)
#pragma unroll
        for (int j = 0; j < RY; ++j) cfma(acc[i][j], l[i], r[j]);
      b = (b + 1 == c) ? 0 : b + 1;
    }
    float2* op = out + p * s * c;
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
template <bool TRANS, bool CONJ_L>
__device__ void slab_times(const float2* L, int l_stride, const float2* R,
                           int r_stride, float2* out, int rows, int s, int c) {
  const int busy = (int)blockDim.x / 2, ra = (rows + 1) / 2;
  if (2 * ra * ((c + 1) / 2) >= busy)
    slab_tiles<TRANS, CONJ_L, 2, 2>(L, l_stride, R, r_stride, out, rows, s, c);
  else if (2 * ra * c >= busy)
    slab_tiles<TRANS, CONJ_L, 2, 1>(L, l_stride, R, r_stride, out, rows, s, c);
  else
    slab_tiles<TRANS, CONJ_L, 1, 1>(L, l_stride, R, r_stride, out, rows, s, c);
}

// This CTA's partial P[x][y] = sum_{p, a < rows} conj(A[p][a][x])
// M[p][a][y] for all x, y < c (A and M laid out [p][a][.] with s rows a
// block), RX x RY outputs a thread, each stored straight into the shared
// memory of the CTA that owns row x: slot R[rank][x - owner * s][y] of its
// receive buffer R (the same offset in every CTA).
template <int RX, int RY>
__device__ void partial_tiles(cg::cluster_group& cluster, const float2* A,
                              const float2* M, float2* R, int rows, int s,
                              int c, int rank) {
  const int nx = (c + RX - 1) / RX, ny = (c + RY - 1) / RY;
  for (int t = threadIdx.x; t < nx * ny; t += blockDim.x) {
    const int yg = t % ny, xg = t / ny;
    int xi[RX], yi[RY];
#pragma unroll
    for (int k = 0; k < RX; ++k) xi[k] = min(xg + k * nx, c - 1);
#pragma unroll
    for (int k = 0; k < RY; ++k) yi[k] = min(yg + k * ny, c - 1);
    float2 acc[RX][RY];
#pragma unroll
    for (int i = 0; i < RX; ++i)
#pragma unroll
      for (int j = 0; j < RY; ++j) acc[i][j] = make_float2(0.f, 0.f);
    for (int p = 0; p < 2; ++p) {
#pragma unroll 2
      for (int a = 0; a < rows; ++a) {
        const float2* Ar = A + (p * s + a) * c;
        const float2* Mr = M + (p * s + a) * c;
        float2 av[RX], mv[RY];
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
      float2* dst = cluster.map_shared_rank(R, owner) +
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
__device__ void partial_env(cg::cluster_group& cluster, const float2* A,
                            const float2* M, float2* R, int rows, int s,
                            int c, int rank) {
  const int n4 = (c + 3) / 4;
  if (n4 * n4 >= (int)blockDim.x)
    partial_tiles<4, 4>(cluster, A, M, R, rows, s, c, rank);
  else
    partial_tiles<2, 2>(cluster, A, M, R, rows, s, c, rank);
}

// Issue the cp.async copies of site `site`'s slab of A_0, A_1 into dst laid
// out [p][a][x]: forward A_p[x0 + a][x] (rows), backward A_p[x][x0 + a].
__device__ void load_a_slab(float2* dst, const float2* br, int site, int x0,
                            int rows, int s, int c, bool fwd) {
  const float2* src = br + (size_t)site * 2 * c * c;
  const int total = 2 * rows * c;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int p, a, x;
    if (fwd) {  // x fastest: contiguous global reads
      x = idx % c;
      a = (idx / c) % rows;
      p = idx / (c * rows);
      cp_async8(dst + (p * s + a) * c + x, src + p * c * c + (x0 + a) * c + x);
    } else {    // a fastest: each row's slab is contiguous
      a = idx % rows;
      x = (idx / rows) % c;
      p = idx / (rows * c);
      cp_async8(dst + (p * s + a) * c + x, src + p * c * c + x * c + x0 + a);
    }
  }
}

// Grid: two clusters of cs CTAs; cluster 0 walks the forward chain over
// sites [0, q), cluster 1 the backward chain over (q, n). snaps (2, chi,
// chi) receives e_q and f_q; counter (one int, zero on entry) picks the
// cluster that combines; out (2, 2) receives C.
__global__ void __launch_bounds__(kThreads, 1)
    env_chain_kernel(const float2* __restrict__ br,
                     const float2* __restrict__ bl, float2* snaps,
                     int* counter, float2* __restrict__ out, int n, int c,
                     int q) {
  extern __shared__ __align__(128) float2 sm[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float red[33];
  __shared__ float2 cpart[4];
  __shared__ int last_flag;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool fwd = blockIdx.x < (unsigned)cs;
  const int s = (c + cs - 1) / cs;
  const int x0 = rank * s;
  const int rows = max(0, min(s, c - x0));
  const Layout L = make_layout(c, s, cs);
  float2* B = sm + L.B;
  float2* M = sm + L.M;
  float2* E = sm + L.E;
  const int cc = c * c;
  const size_t site = (size_t)2 * cc;
  const int count = fwd ? q : n - 1 - q;
  const int tid = threadIdx.x;

  if (tid == 0) mbar_init(&bar);
  for (int idx = tid; idx < s * c; idx += blockDim.x)
    E[idx] = make_float2((x0 == 0 && idx == 0) ? 1.f : 0.f, 0.f);
  __syncthreads();

  // prefetch the first site
  if (count > 0) {
    const int i0 = fwd ? 0 : n - 1;
    if (tid == 0) bulk_load(B, bl + i0 * site, (uint32_t)(site * 8), &bar);
    load_a_slab(sm + L.A[0], br, i0, x0, rows, s, c, fwd);
    cp_async_commit();
  }
  for (int step = 0; step < count; ++step) {
    const int i = fwd ? step : n - 1 - step;
    const int inext = fwd ? i + 1 : i - 1;
    const bool more = step + 1 < count;
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
      bulk_load(B, bl + inext * site, (uint32_t)(site * 8), &bar);
    // step 2: this CTA's partial sum over its rows, pushed to the rows'
    // owners; after the barrier each CTA adds what it received
    float2* R = sm + L.P[step & 1];
    partial_env(cluster, sm + L.A[step & 1], M, R, rows, s, c, rank);
    cluster.sync();
    for (int idx = tid; idx < rows * c; idx += blockDim.x) {
      float2 acc = make_float2(0.f, 0.f);
      for (int r = 0; r < cs; ++r) {
        const float2 v = R[r * s * c + idx];
        acc.x += v.x;
        acc.y += v.y;
      }
      E[idx] = acc;
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // snapshot, then the counter decides which cluster combines
  float2* snap = snaps + (fwd ? 0 : cc);
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
  float2* F = sm + L.P[0];
  float2* K = sm + L.A[1];
  const float2* Bq = bl + q * site;
  const float2* Aq = br + q * site;
  for (int idx = tid; idx < cc; idx += blockDim.x)
    F[idx] = __ldcg(snaps + cc + idx);
  for (int idx = tid; idx < rows * c; idx += blockDim.x)
    E[idx] = __ldcg(snaps + x0 * c + idx);
  for (int idx = tid; idx < 2 * cc; idx += blockDim.x) B[idx] = Bq[idx];
  for (int idx = tid; idx < 2 * rows * c; idx += blockDim.x) {
    const int p = idx / (rows * c), rem = idx - p * rows * c;
    sm[L.A[0] + p * s * c + rem] = Aq[p * cc + x0 * c + rem];
  }
  __syncthreads();
  slab_times<false, false>(E, 0, B, cc, M, rows, s, c);
  slab_times<false, true>(sm + L.A[0], s * c, F, 0, K, rows, s, c);
  __syncthreads();
  float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int idx = tid; idx < rows * c; idx += blockDim.x) {
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float2 g = M[jj * s * c + idx], k = K[ii * s * c + idx];
        part[(ii * 2 + jj) * 2] += g.x * k.x - g.y * k.y;
        part[(ii * 2 + jj) * 2 + 1] += g.x * k.y + g.y * k.x;
      }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) part[k] = block_sum(part[k], red);
  if (tid == 0)
    for (int k = 0; k < 4; ++k)
      cpart[k] = make_float2(part[2 * k], part[2 * k + 1]);
  cluster.sync();
  if (rank == 0 && tid < 4) {
    float2 acc = make_float2(0.f, 0.f);
    for (int r = 0; r < cs; ++r) {
      const float2 v = cluster.map_shared_rank(cpart, r)[tid];
      acc.x += v.x;
      acc.y += v.y;
    }
    out[tid] = acc;
    if (tid == 0) *counter = 0;
  }
  cluster.sync();  // keep every CTA's shared memory alive for rank 0's reads
}

size_t smem_bytes(int c, int cs) {
  return (size_t)make_layout(c, (c + cs - 1) / cs, cs).total *
         sizeof(float2);
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
int pick_cluster(int c, cudaError_t* err) {
  static int cached[kMaxChi + 1] = {0};
  if (cached[c]) return cached[c];
  *err = cudaFuncSetAttribute(
      env_chain_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (*err != cudaSuccess) return 0;
  for (int cs : {16, 8}) {
    const int use = cs < c ? cs : c;
    const size_t smem = smem_bytes(c, use);
    *err = cudaFuncSetAttribute(env_chain_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
    if (*err != cudaSuccess) return 0;
    if (use <= 8) {
      cached[c] = use;
      return use;
    }
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = make_config(attr, use, smem, 0);
    int clusters = 0;
    const cudaError_t q =
        cudaOccupancyMaxActiveClusters(&clusters, env_chain_kernel, &cfg);
    if (q == cudaSuccess && clusters >= 2) {
      cached[c] = use;
      return use;
    }
    cudaGetLastError();  // a refused query is not an error of the launch
  }
  *err = cudaErrorInvalidConfiguration;
  return 0;
}

}  // namespace

// The cluster size the launcher picks for chi (0 on error).
extern "C" int env_chain_cluster_size(int chi) {
  if (chi < 1 || chi > kMaxChi) return 0;
  cudaError_t err = cudaSuccess;
  return pick_cluster(chi, &err);
}

// counter must hold 0 and stay private to this stream's launches (the
// kernel leaves it at 0); br and bl must be 16-byte aligned.
extern "C" int env_chain_launch(const void* br, const void* bl, void* snaps,
                                void* counter, void* out, int n, int chi,
                                int q, void* stream) {
  if (chi < 1 || chi > kMaxChi || n < 1 || q < 0 || q >= n ||
      ((uintptr_t)br | (uintptr_t)bl) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const int cs = pick_cluster(chi, &err);
  if (cs == 0) return (int)err;
  const size_t smem = smem_bytes(chi, cs);
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      env_chain_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
      env_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem));
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = make_config(attr, cs, smem, (cudaStream_t)stream);
  ADAPTAQC_RETURN_IF_ERR(cudaLaunchKernelEx(
      &cfg, env_chain_kernel, (const float2*)br, (const float2*)bl,
      (float2*)snaps, (int*)counter, (float2*)out, n, chi, q));
  return (int)cudaGetLastError();
}
