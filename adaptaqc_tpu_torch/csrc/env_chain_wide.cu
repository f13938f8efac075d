// The environment-chain kernel (K1) in complex64 for 64 < chi <= 128, for
// sm_90a.
//
// Replaces, with csrc/env_chain.cu (chi <= 64 and complex128) and
// csrc/env_chain_stream.cu (chi > 128), the JAX package's Pallas TPU
// kernel _env_kernel (ops/pallas_env.py:46): the 2x2 local overlap matrix
// C[i, j] = <R| (|i><j| at site q) |L> of the B-form site tensors (n, 2,
// chi, chi) of the bra R (A below) and the ket L (B):
//   forward   e' = sum_p A_p^H e B_p        over sites 0 .. q-1
//   backward  f' = sum_p conj(A_p) f B_p^T  over sites n-1 .. q+1
//   combine   C[i, j] = sum_{a,y} G_j[a,y] K_i[a,y],
//             G_j = e B_j, K_i = conj(A_i) f   at site q.
//
// What bounds it on this card: a site is 16 chi^3 real FMAs (33.6 M at chi
// = 128), and each chain is a sequence of dependent sites, so the time is
// the critical path of max(q, n-1-q) sites plus the combine. On a cluster
// of 16 SMs at 128 FP32 FMAs a clock each a site takes chi^3 / 128 clocks
// at the least (16,384 at chi = 128, about 8.3 us at 1.98 GHz): that is the
// design family's floor, 0.215 ms at n = 50, q = 25.
//
// The first wide design (the <float2, true, false> instantiation of
// env_chain.cu) gave each CTA of a 16-CTA cluster a slab of the
// environment's rows: every CTA read the site's whole B_p pair (256 KB at
// chi = 128) from L2 through __ldg four times over (2 x 2 register tiles),
// waited on L2, posted chi^2 partial sums a site into the owners' shared
// memory and crossed two cluster barriers a site (43 us a site at chi =
// 128, 1.0709 ms at q = 25 on one H100). Here:
//   - A cluster of 4 x 4 CTAs a chain, the two chains' clusters side by
//     side. CTA (i, j), rank 4 i + j, owns block (I_i, J_j) of the
//     environment: rows I_i = [i br, i br + br), columns J_j = [j bc, j bc +
//     bc), br = bc = ceil(chi / 4) (the last block ragged). It keeps rows
//     I_i of the environment whole (E_row, br x chi), its column block of
//     the site's B pair and its row block of the A pair: a quarter of each
//     operand, so no CTA reads a site's operand whole.
//   - Step 1: M_p = E_row B_p[:, J_j] (br x bc, depth chi). Step 2: the
//     partial P = sum_p A_p[I_i, :]^H M_p (chi x bc, depth 2 br): the rows
//     I_i's share of e'[:, J_j]. The backward chain runs the same two
//     products on its blocks as they lie in memory (B_p[J_j, :] rows, A_p's
//     columns I_i), read across rows: the same code, other strides.
//   - The operands arrive by TMA, one copy of a box of the site's two
//     matrices per block (tensor maps made by the launcher; the boxes are
//     as wide as the padded shared rows, the columns past chi zero), issued
//     by one thread a site ahead: B's block as soon as step 1 has read it,
//     A's as soon as step 2 has, completing on an mbarrier each. A warp's
//     own cp.async copies stalled its issue for 9,000-15,000 cycles a site,
//     and one bulk copy a row for as long (clock64() stamps, one H100).
//     Where chi or br is odd (no 16-byte rows) the copies are cp.async.
//   - The exchange, in two hops through distributed shared memory with no
//     cluster barrier in the loop: block x of P goes to its owner (x / br,
//     j), which sums the four partials of its column group in row order (a
//     reduce-scatter: 3 blocks of br x bc out of each CTA, where the first
//     design moved chi^2 in); the owner then posts its block of e' into
//     E_row of its row peers (an all-gather of as many bytes). Each hop is
//     remote stores, a block barrier and one release arrival a receiver
//     (mbarrier.arrive.release.cluster); the receiver waits on its own
//     mbarrier. Each buffer is written only after its readers have released
//     it, by plain (relaxed) arrivals on two more mbarriers whose waits are
//     normally long satisfied: the owners have summed before the next
//     site's partials land, the row peers have finished step 1 before the
//     next e' lands. (A release arrival costs a thread about 1,500 cycles
//     after a block barrier, clock64() stamps on one H100: the free signals
//     need none, since a CTA's reads of a buffer are used before its block
//     barrier.)
//   - Register tiles, picked from chi alone (wide_plan) to keep every
//     thread busy: step 1 4 x 2 complex outputs a thread at chi = 128 (E
//     read two depths at a time as 16 bytes, a broadcast within the warp),
//     3 x 2 at 96, 2 x 2 at 65; step 2 4 x 4, 3 x 3, 4 x 2; their depth
//     loops unrolled eight and four times (of 2, 4 and 8 each, the fastest
//     on one H100, tools/stage_clocks.py --variants).
//   - The combine runs in the cluster that finishes its chain last: every
//     owner writes its block of e_q or f_q to `snaps`, the second cluster
//     to bump the counter reads them back and each CTA forms G_j and K_i on
//     its block with the step-1 code, then one cluster reduction.
// All arithmetic is exact FP32 FMA on the CUDA cores (no TF32); every sum
// runs in a fixed order (a product's depth in order, the partials in row
// order, the combine's CTA sums in rank order), so a rerun gives the same
// bits. The bits depend on the 4 x 4 cluster and on chi, not on timing.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using adaptaqc::block_sum;
using adaptaqc::cp_async8_zfill;
using adaptaqc::cp_async_commit;
using adaptaqc::cp_async_wait;
using adaptaqc::mbar_arrive_remote;
using adaptaqc::mbar_expect_tx;
using adaptaqc::mbar_init_count;
using adaptaqc::mbar_wait;
using adaptaqc::mbar_wait_cluster;

constexpr int kThreads = 256;
constexpr int kGr = 4, kGc = 4, kCs = kGr * kGc;  // the cluster: 4 x 4
constexpr int kMinChi = 65, kMaxChi = 128;
constexpr int kMaxOwn = 4;  // ceil(32 * 32 / kThreads): a thread's block
                            // elements in the sum

// The plan at chi: blocks, strides, register tiles and the dynamic shared
// memory (offsets in complex elements). Depends on chi alone; mirrored in
// ops/env_kernel.py (wide_plan) and held equal on the card. The operands
// sit as they lie in global memory, so that every copy runs along rows:
// forward Bs[p][b][y] (rows of bc) and As[p][a][x] (rows of lde);
// backward Bs[p][y][b] (rows of ldb: two depths are one 16-byte read) and
// As[p][x][a] (rows of lda). Where chi and br are even (vec) each block is
// one TMA copy of a box of the site's two matrices (tensor maps made by the
// launcher), its rows as wide as these strides (the columns past the block
// read, or zero past chi); else cp.async, 8 bytes a lane. Every buffer
// starts on 128 bytes.
struct Plan {
  int br, bc;   // block rows and columns
  int ld;       // the depth of step 1: chi rounded up to even (a zero
                // column of E_row, a zero row of B)
  int lde;      // E_row's and the forward As's row stride (ld + 2: rows
                // read at once fall in other banks)
  int ldb;      // the backward Bs's row stride (ld + 2)
  int lda;      // the backward As's row stride (br rounded up to even, + 2
                // if br is even: the four rows a warp reads fall in
                // distinct banks)
  int ra, ry, rx, ry2;   // step 1's tile (ra x ry), step 2's (rx x ry2)
  bool vec;     // TMA copies: chi and br even
  int Bs, As, E, R, M, total;  // offsets; R: the partials received, kGr
                               // br bc; M: 2 br bc
};

// A thread's cost per depth step of a tile of r1 x r2 complex outputs when
// `tiles` tiles share the block: its rounds times 4 FMAs an output and
// (r1 + r2) loads, a load counted as two FMAs.
__host__ __device__ inline int tile_cost(int tiles, int r1, int r2) {
  return ((tiles + kThreads - 1) / kThreads) * (4 * r1 * r2 + 2 * (r1 + r2));
}

__host__ __device__ inline Plan wide_plan(int chi) {
  Plan P;
  P.br = (chi + kGr - 1) / kGr;
  P.bc = (chi + kGc - 1) / kGc;
  P.ld = chi + (chi & 1);
  const int s1[3][2] = {{4, 2}, {3, 2}, {2, 2}};
  const int s2[3][2] = {{4, 4}, {3, 3}, {4, 2}};
  int best = -1;
  for (int k = 0; k < 3; ++k) {
    const int r1 = s1[k][0], r2 = s1[k][1];
    const int tiles = 2 * ((P.br + r1 - 1) / r1) * ((P.bc + r2 - 1) / r2);
    const int c = tile_cost(tiles, r1, r2);
    if (best < 0 || c < best) {
      best = c;
      P.ra = r1;
      P.ry = r2;
    }
  }
  best = -1;
  for (int k = 0; k < 3; ++k) {
    const int r1 = s2[k][0], r2 = s2[k][1];
    const int tiles = ((chi + r1 - 1) / r1) * ((P.bc + r2 - 1) / r2);
    const int c = tile_cost(tiles, r1, r2);
    if (best < 0 || c < best) {
      best = c;
      P.rx = r1;
      P.ry2 = r2;
    }
  }
  P.lde = P.ld + 2;
  P.ldb = P.ld + 2;
  P.lda = (P.br + 2) & ~1;
  P.vec = chi % 2 == 0 && P.br % 2 == 0;
  const int bs = P.bc * P.ldb > P.ld * P.bc ? P.bc * P.ldb : P.ld * P.bc;
  const int as = P.ld * P.lda > P.br * P.lde ? P.ld * P.lda : P.br * P.lde;
  auto up = [](int x) { return (x + 15) & ~15; };  // 128 bytes
  int off = 0;
  P.Bs = off;  off += up(2 * bs);
  P.As = off;  off += up(2 * as);
  P.E = off;   off += up(P.br * P.lde);
  P.R = off;   off += up(kGr * P.br * P.bc);
  P.M = off;   off += 2 * P.br * P.bc;
  P.total = off;
  return P;
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

// Step 1 (and the combine's products): out[p][a][y] = sum_{b < ld}
// L_p[a][b] R_p(b, y) for p = 0, 1, a < rows, y < cols; L_p = L + p
// l_stride (rows of lde, conjugated if CONJ), R_p(b, y) = R[p r_stride +
// b rs + y] (rows of depth), or with RT R[p r_stride + y rs + b] (rows of
// columns: depths b, b + 1 one 16-byte read); out rows of bc, 2 br rows
// apart. Each thread owns RA rows x RY columns (y0, y0 + ny, ..): lanes on
// consecutive columns, the few rows of a warp read as 16-byte broadcasts of
// two depths. Rows and columns past the block are clamped on reads and
// dropped on stores.
template <int RA, int RY, bool CONJ, bool RT>
__device__ void block_times(const float2* L, int l_stride, const float2* R,
                            int r_stride, int rs, float2* out, int rows,
                            int cols, const Plan& P) {
  const int na = (rows + RA - 1) / RA, ny = (cols + RY - 1) / RY;
  const int tiles = 2 * na * ny;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const int yg = t % ny, ag = (t / ny) % na, p = t / (ny * na);
    const float2* Lp = L + p * l_stride;
    const float2* Rp = R + p * r_stride;
    int ai[RA], yi[RY];
#pragma unroll
    for (int k = 0; k < RA; ++k) ai[k] = min(ag * RA + k, rows - 1) * P.lde;
#pragma unroll
    for (int k = 0; k < RY; ++k)
      yi[k] = min(yg + k * ny, cols - 1) * (RT ? rs : 1);
    float2 acc[RA][RY];
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RY; ++j) acc[i][j] = make_float2(0.f, 0.f);
#pragma unroll 8
    for (int b = 0; b < P.ld; b += 2) {
      float4 l[RA], r[RY];
#pragma unroll
      for (int k = 0; k < RA; ++k)
        l[k] = *reinterpret_cast<const float4*>(Lp + ai[k] + b);
#pragma unroll
      for (int k = 0; k < RY; ++k) {
        if (RT) {
          r[k] = *reinterpret_cast<const float4*>(Rp + yi[k] + b);
        } else {
          const float2 r0 = Rp[b * rs + yi[k]], r1 = Rp[(b + 1) * rs + yi[k]];
          r[k] = make_float4(r0.x, r0.y, r1.x, r1.y);
        }
      }
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const float2 l0 = make_float2(l[i].x, CONJ ? -l[i].y : l[i].y);
        const float2 l1 = make_float2(l[i].z, CONJ ? -l[i].w : l[i].w);
#pragma unroll
        for (int j = 0; j < RY; ++j) {
          cfma(acc[i][j], l0, make_float2(r[j].x, r[j].y));
          cfma(acc[i][j], l1, make_float2(r[j].z, r[j].w));
        }
      }
    }
    float2* op = out + p * P.br * P.bc;
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        const int a = ag * RA + i, y = yg + j * ny;
        if (a < rows && y < cols) op[a * P.bc + y] = acc[i][j];
      }
  }
}

template <bool CONJ, bool RT>
__device__ void block_product(const float2* L, int l_stride, const float2* R,
                              int r_stride, int rs, float2* out, int rows,
                              int cols, const Plan& P) {
  if (P.ra == 4)
    block_times<4, 2, CONJ, RT>(L, l_stride, R, r_stride, rs, out, rows,
                                cols, P);
  else if (P.ra == 3)
    block_times<3, 2, CONJ, RT>(L, l_stride, R, r_stride, rs, out, rows,
                                cols, P);
  else
    block_times<2, 2, CONJ, RT>(L, l_stride, R, r_stride, rs, out, rows,
                                cols, P);
}

// Step 1 on the site's operands, in either chain's layout.
__device__ void step1(const float2* E, const float2* Bs, float2* M, int rows,
                      int cols, bool fwd, const Plan& P) {
  if (fwd)
    block_product<false, false>(E, 0, Bs, P.ld * P.bc, P.bc, M, rows, cols,
                                P);
  else
    block_product<false, true>(E, 0, Bs, P.bc * P.ldb, P.ldb, M, rows, cols,
                               P);
}

// The address of p in CTA `rank` of the cluster, as st.async and remote
// mbarrier operations take it.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(adaptaqc::smem_addr(p)), "r"(rank));
  return r;
}

// An arrival on the mbarrier at bar's address in CTA `rank`, ordering
// nothing: the signal that this CTA has read a buffer of that CTA's
// writes (its reads are done, their values used, before the block
// barrier that precedes the arrival).
__device__ __forceinline__ void mbar_arrive_free(uint64_t* bar, int rank) {
  asm volatile(
      "mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          cluster_addr(bar, rank))
      : "memory");
}

// Step 2: this CTA's partial P[x][y] = sum_p sum_{a < rows} conj(As_p(a, x))
// M[p][a][y] for every x < chi and y < cols, As_p(a, x) = As[p a_p + a aa
// + x ax], RX x RY outputs a thread (rows x0 + k nx, columns y0 + l ny),
// each stored straight into the receive buffer R of the CTA that owns row
// x (rank (x / br) kGc + j), in slot `slot` (this CTA's row block):
// R[slot][x mod br][y].
template <int RX, int RY>
__device__ void partial_post(cg::cluster_group& cluster, const float2* As,
                             int a_p, int aa, int ax, const float2* M,
                             float2* R, int rows, int cols, int chi, int j,
                             int slot, const Plan& P) {
  const int nx = (chi + RX - 1) / RX, ny = (cols + RY - 1) / RY;
  for (int t = threadIdx.x; t < nx * ny; t += blockDim.x) {
    const int yg = t % ny, xg = t / ny;
    int xi[RX], yi[RY];
#pragma unroll
    for (int k = 0; k < RX; ++k) xi[k] = min(xg + k * nx, chi - 1) * ax;
#pragma unroll
    for (int k = 0; k < RY; ++k) yi[k] = min(yg + k * ny, cols - 1);
    float2 acc[RX][RY];
#pragma unroll
    for (int i = 0; i < RX; ++i)
#pragma unroll
      for (int l = 0; l < RY; ++l) acc[i][l] = make_float2(0.f, 0.f);
    for (int p = 0; p < 2; ++p) {
      const float2* Ap = As + p * a_p;
      const float2* Mp = M + p * P.br * P.bc;
#pragma unroll 4
      for (int a = 0; a < rows; ++a) {
        float2 av[RX], mv[RY];
#pragma unroll
        for (int k = 0; k < RX; ++k) av[k] = Ap[a * aa + xi[k]];
#pragma unroll
        for (int k = 0; k < RY; ++k) mv[k] = Mp[a * P.bc + yi[k]];
#pragma unroll
        for (int i = 0; i < RX; ++i)
#pragma unroll
          for (int l = 0; l < RY; ++l) cfma_conj(acc[i][l], av[i], mv[l]);
      }
    }
#pragma unroll
    for (int i = 0; i < RX; ++i) {
      const int x = xg + i * nx;
      if (x >= chi) continue;
      const int owner = x / P.br;
      float2* dst = cluster.map_shared_rank(R, owner * kGc + j) +
                    (slot * P.br + x - owner * P.br) * P.bc;
#pragma unroll
      for (int l = 0; l < RY; ++l) {
        const int y = yg + l * ny;
        if (y < cols) dst[y] = acc[i][l];
      }
    }
  }
}

// Step 2 in either chain's layout of As, with the plan's tile.
__device__ void step2(cg::cluster_group& cluster, const float2* As,
                      const float2* M, float2* R, int rows, int cols,
                      int chi, int j, int slot, bool fwd, const Plan& P) {
  const int a_p = fwd ? P.br * P.lde : P.ld * P.lda;
  const int aa = fwd ? P.lde : 1, ax = fwd ? 1 : P.lda;
  if (P.rx == 4 && P.ry2 == 4)
    partial_post<4, 4>(cluster, As, a_p, aa, ax, M, R, rows, cols, chi, j,
                       slot, P);
  else if (P.rx == 3)
    partial_post<3, 3>(cluster, As, a_p, aa, ax, M, R, rows, cols, chi, j,
                       slot, P);
  else
    partial_post<4, 2>(cluster, As, a_p, aa, ax, M, R, rows, cols, chi, j,
                       slot, P);
}

// One thread: the TMA copy of the box at (c0, c1, c2) of tensor map tm (a
// site's two matrices) into dst, completing `bytes` on bar.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* tm,
                                        int c0, int c1, int c2,
                                        uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          adaptaqc::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(c2),
      "r"(adaptaqc::smem_addr(bar))
      : "memory");
}

// The cp.async copies of an operand block (where chi or br is odd):
// `nrows` rows, row r of row(r).len elements from global row(r).g into
// shared row(r).d, zeros after it up to `fill`; a warp a row, 8 bytes a
// lane.
struct Row {
  float2* d;
  const float2* g;
  int len;
};
template <typename RowOf>
__device__ void copy_rows(int nrows, int fill, RowOf row) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nrows; r += blockDim.x >> 5) {
    const Row w = row(r);
    for (int e = lane; e < fill; e += 32)
      cp_async8_zfill(w.d + e, e < w.len ? w.g + e : w.g, e < w.len);
  }
}

// The tensor maps of the two site stacks, one a block shape: B forward
// (box bc x chi x 2 at (y0, 0)), B backward (ldb x bc x 2 at (0, y0)), A
// forward (lde x br x 2 at (0, x0)), A backward (lda x chi x 2 at (x0, 0)).
struct Maps {
  CUtensorMap bf, bb, af, ab;
};

// site `site`'s column block of the B pair, y < cols, b < ld (the row past
// chi zero): forward Bs[p][b][y] = B_p[b][y0 + y], backward Bs[p][y][b] =
// B_p[y0 + y][b].
__device__ void load_b(float2* Bs, const float2* bl, const Maps& tm,
                       int site, int chi, int y0, int cols, bool fwd,
                       uint64_t* bar, const Plan& P) {
  if (P.vec) {
    if (threadIdx.x == 0)
      tma_box(Bs, fwd ? &tm.bf : &tm.bb, fwd ? y0 : 0, fwd ? 0 : y0,
              2 * site,
              (uint32_t)(2 * P.bc * (fwd ? chi : P.ldb) * sizeof(float2)),
              bar);
    return;
  }
  const float2* src = bl + (size_t)site * 2 * chi * chi;
  const size_t cc = (size_t)chi * chi;
  if (fwd)
    copy_rows(2 * P.ld, cols, [&](int r) {
      const int p = r >= P.ld, b = r - p * P.ld;
      return Row{Bs + r * P.bc, src + p * cc + (size_t)min(b, chi - 1) * chi
                 + y0, b < chi ? cols : 0};
    });
  else
    copy_rows(2 * cols, P.ld, [&](int r) {
      const int p = r >= cols, y = r - p * cols;
      return Row{Bs + (p * P.bc + y) * P.ldb,
                 src + p * cc + (size_t)(y0 + y) * chi, chi};
    });
}

// site `site`'s row block of the A pair, a < rows, x < chi (forward also
// the zero column at chi where ld holds one): forward As[p][a][x] =
// A_p[x0 + a][x], backward As[p][x][a] = A_p[x][x0 + a].
__device__ void load_a(float2* As, const float2* br, const Maps& tm,
                       int site, int chi, int x0, int rows, bool fwd,
                       uint64_t* bar, const Plan& P) {
  if (P.vec) {
    if (threadIdx.x == 0)
      tma_box(As, fwd ? &tm.af : &tm.ab, fwd ? 0 : x0, fwd ? x0 : 0,
              2 * site,
              (uint32_t)(2 * (fwd ? P.lde * P.br : P.lda * chi) *
                         sizeof(float2)),
              bar);
    return;
  }
  const float2* src = br + (size_t)site * 2 * chi * chi;
  const size_t cc = (size_t)chi * chi;
  if (fwd)
    copy_rows(2 * rows, P.ld, [&](int r) {
      const int p = r >= rows, a = r - p * rows;
      return Row{As + (p * P.br + a) * P.lde,
                 src + p * cc + (size_t)(x0 + a) * chi, chi};
    });
  else
    copy_rows(2 * chi, rows, [&](int r) {
      const int p = r >= chi, x = r - p * chi;
      return Row{As + (p * P.ld + x) * P.lda,
                 src + p * cc + (size_t)x * chi + x0, rows};
    });
}

// Wait for this CTA's oldest outstanding copy of one operand: its mbarrier
// phase (bulk copies) or, by cp.async groups, all but the newest `N`.
template <int N>
__device__ __forceinline__ void wait_copies(uint64_t* bar, uint32_t& phase,
                                            const Plan& P) {
  if (P.vec) {
    mbar_wait(bar, phase);
    phase ^= 1;
  } else {
    cp_async_wait<N>();
  }
  __syncthreads();
}

// Grid: two clusters of kCs CTAs; cluster 0 walks the forward chain over
// sites [0, q), cluster 1 the backward chain over (q, n). snaps (2, chi,
// chi) receives e_q and f_q; counter (one int, zero on entry) picks the
// cluster that combines, which leaves it at zero; out (2, 2) receives C.
__global__ void __launch_bounds__(kThreads, 1)
    env_chain_wide_kernel(const float2* __restrict__ br,
                          const float2* __restrict__ bl, float2* snaps,
                          int* counter, float2* __restrict__ out, int n,
                          int chi, int q, const __grid_constant__ Maps tm) {
  extern __shared__ __align__(128) unsigned char sm_raw[];
  float2* sm = reinterpret_cast<float2*>(sm_raw);
  // rfull: the partials of this CTA's block landed (kGr arrivals, one a
  // CTA of its column group); rfree: every owner of this column group has
  // summed (kGr); efull: the row peers' blocks of e' landed in E_row
  // (kGc); efree: every row peer has finished step 1 (kGc)
  __shared__ __align__(8) uint64_t rfull, rfree, efull, efree;
  // bbar, abar: the bulk copies of Bs, As landed (one phase a copy)
  __shared__ __align__(8) uint64_t bbar, abar;
  __shared__ float red[33];
  __shared__ float2 cpart[4];
  __shared__ int last_flag;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const bool fwd = blockIdx.x < (unsigned)kCs;
  const int i = rank / kGc, j = rank % kGc;
  const Plan P = wide_plan(chi);
  const int x0 = i * P.br, rows = max(0, min(P.br, chi - x0));
  const int y0 = j * P.bc, cols = max(0, min(P.bc, chi - y0));
  float2* Bs = sm + P.Bs;
  float2* As = sm + P.As;
  float2* E = sm + P.E;
  float2* R = sm + P.R;
  float2* M = sm + P.M;
  const int count = fwd ? q : n - 1 - q;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init_count(&rfull, kGr);
    mbar_init_count(&rfree, kGr);
    mbar_init_count(&efull, kGc);
    mbar_init_count(&efree, kGc);
    mbar_init_count(&bbar, 1);
    mbar_init_count(&abar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // E_row = rows I_i of |0><0|, with its zero column past chi
  for (int idx = tid; idx < P.br * P.lde; idx += blockDim.x)
    E[idx] = make_float2((x0 == 0 && idx == 0) ? 1.f : 0.f, 0.f);
  if (count > 0) {
    const int s0 = fwd ? 0 : n - 1;
    load_b(Bs, bl, tm, s0, chi, y0, cols, fwd, &bbar, P);
    cp_async_commit();
    load_a(As, br, tm, s0, chi, x0, rows, fwd, &abar, P);
    cp_async_commit();
  }
  uint32_t bph = 0, aph = 0;  // the phases of bbar, abar to wait for
  // every CTA's barriers are initialised before any CTA arrives on them
  cluster.sync();

  for (int step = 0; step < count; ++step) {
    const int site = fwd ? step : n - 1 - step;
    const int next = fwd ? site + 1 : site - 1;
    const bool more = step + 1 < count;
    const uint32_t ph = step & 1, prev = (step - 1) & 1;
    // stage: E_row complete
    if (step > 0) mbar_wait_cluster(&efull, prev);
    wait_copies<1>(&bbar, bph, P);  // Bs (this site) landed
    // stage: step 1, M_p = E_row B_p[:, J_j]
    step1(E, Bs, M, rows, cols, fwd, P);
    __syncthreads();  // E_row, Bs read; M written
    if (more) load_b(Bs, bl, tm, next, chi, y0, cols, fwd, &bbar, P);
    cp_async_commit();  // (an empty group on the last site)
    if (tid < kGc) mbar_arrive_free(&efree, i * kGc + tid);
    wait_copies<1>(&abar, aph, P);  // As (this site) landed
    // stage: step 2, the partial, posted to the owners once they have
    // summed the last site's
    if (step > 0) mbar_wait_cluster(&rfree, prev);
    step2(cluster, As, M, R, rows, cols, chi, j, i, fwd, P);
    __syncthreads();  // As read; every partial of this CTA posted
    if (more) load_a(As, br, tm, next, chi, x0, rows, fwd, &abar, P);
    cp_async_commit();
    if (tid < kGr) mbar_arrive_remote(&rfull, tid * kGc + j);
    // stage: the partials of this CTA's block landed
    mbar_wait_cluster(&rfull, ph);
    // stage: the sum in row order, then e' posted to the row peers
    float2 own[kMaxOwn];
#pragma unroll
    for (int k = 0; k < kMaxOwn; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < rows * cols) {
        const int xl = idx / cols, y = idx % cols;
        float2 acc = R[xl * P.bc + y];
#pragma unroll
        for (int r = 1; r < kGr; ++r) {
          const float2 v = R[(r * P.br + xl) * P.bc + y];
          acc.x += v.x;
          acc.y += v.y;
        }
        own[k] = acc;
      }
    }
    __syncthreads();  // R read
    if (tid < kGr) mbar_arrive_free(&rfree, tid * kGc + j);
    mbar_wait_cluster(&efree, ph);  // the row peers are done with E_row
#pragma unroll
    for (int k = 0; k < kMaxOwn; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < rows * cols) {
        const int xl = idx / cols, y = idx % cols;
#pragma unroll
        for (int r = 0; r < kGc; ++r)
          cluster.map_shared_rank(E, i * kGc + r)[xl * P.lde + y0 + y] =
              own[k];
      }
    }
    __syncthreads();
    if (tid < kGc) mbar_arrive_remote(&efull, i * kGc + tid);
    // stage: end of the site
  }
  if (count > 0) mbar_wait_cluster(&efull, (count - 1) & 1);
  cp_async_wait<0>();

  // snapshot of this CTA's block, then the counter decides which cluster
  // combines
  const int cc = chi * chi;
  float2* snap = snaps + (fwd ? 0 : cc);
  for (int idx = tid; idx < rows * cols; idx += blockDim.x) {
    const int xl = idx / cols, y = idx % cols;
    snap[(x0 + xl) * chi + y0 + y] = E[xl * P.lde + y0 + y];
  }
  __threadfence();
  cluster.sync();
  if (rank == 0 && tid == 0) last_flag = atomicAdd(counter, 1);
  cluster.sync();
  const int last = *cluster.map_shared_rank(&last_flag, 0) == 1;
  cluster.sync();
  if (!last) return;
  __threadfence();

  // combine at site q on block (I_i, J_j): G_p = e[I_i, :] B_p[:, J_j]
  // (into M), K_u = conj(A_u[I_i, :]) f[:, J_j] (into E's space), then the
  // four sums over the block of G_p K_u
  for (int idx = tid; idx < rows * chi; idx += blockDim.x) {
    const int a = idx / chi, b = idx % chi;
    E[a * P.lde + b] = __ldcg(snaps + (x0 + a) * chi + b);
  }
  // f[:, J_j] in R's space (kGr br >= ld rows of bc), with its zero row
  for (int idx = tid; idx < P.ld * cols; idx += blockDim.x) {
    const int b = idx / cols, y = idx % cols;
    R[b * P.bc + y] = b < chi ? __ldcg(snaps + cc + b * chi + y0 + y)
                              : make_float2(0.f, 0.f);
  }
  load_b(Bs, bl, tm, q, chi, y0, cols, true, &bbar, P);
  load_a(As, br, tm, q, chi, x0, rows, true, &abar, P);
  cp_async_commit();
  wait_copies<0>(&bbar, bph, P);
  wait_copies<0>(&abar, aph, P);
  step1(E, Bs, M, rows, cols, true, P);
  __syncthreads();  // E read: K goes into its space
  float2* K = E;
  block_product<true, false>(As, P.br * P.lde, R, 0, P.bc, K, rows, cols,
                            P);
  __syncthreads();
  float part[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int idx = tid; idx < rows * cols; idx += blockDim.x) {
    const int a = idx / cols, y = idx % cols;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float2 g = M[(p * P.br + a) * P.bc + y];
        const float2 k = K[(u * P.br + a) * P.bc + y];
        part[(u * 2 + p) * 2] += g.x * k.x - g.y * k.y;
        part[(u * 2 + p) * 2 + 1] += g.x * k.y + g.y * k.x;
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
    for (int r = 0; r < kCs; ++r) {
      const float2 v = cluster.map_shared_rank(cpart, r)[tid];
      acc.x += v.x;
      acc.y += v.y;
    }
    out[tid] = acc;
    if (tid == 0) *counter = 0;
  }
  cluster.sync();  // keep every CTA's shared memory alive for rank 0's reads
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (no link against libcuda); null where it is missing.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
    cudaGetLastError();
  }
  return fn;
}

// A site stack (2n matrices of chi x chi complex64, 8-byte elements) seen
// through boxes of w x h x 2; reads past chi fill zeros.
bool stack_map(CUtensorMap* m, EncodeTiled enc, const void* base, int n,
               int chi, int w, int h) {
  const cuuint64_t dims[3] = {(cuuint64_t)chi, (cuuint64_t)chi,
                              (cuuint64_t)(2 * n)};
  const cuuint64_t strides[2] = {(cuuint64_t)chi * 8,
                                 (cuuint64_t)chi * chi * 8};
  const cuuint32_t box[3] = {(cuuint32_t)w, (cuuint32_t)h, 2};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 3, const_cast<void*>(base),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

size_t smem_bytes(int chi) {
  return (size_t)wide_plan(chi).total * sizeof(float2);
}

cudaLaunchConfig_t make_config(cudaLaunchAttribute* attr, size_t smem,
                               cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * kCs, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Sets the kernel's attributes for chi's shared memory; the cluster size
// (kCs) where the card holds at least one such cluster, else 0 and *err.
int prepare(int chi, cudaError_t* err) {
  static int checked[kMaxChi + 1] = {0};
  const void* fn = (const void*)env_chain_wide_kernel;
  const size_t smem = smem_bytes(chi);
  if ((*err = cudaFuncSetAttribute(
           fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess ||
      (*err = cudaFuncSetAttribute(
           fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess)
    return 0;
  if (checked[chi]) return kCs;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = make_config(attr, smem, 0);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg) != cudaSuccess ||
      clusters < 1) {
    cudaGetLastError();  // a refused query is not an error of the launch
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  checked[chi] = 1;
  return kCs;
}

}  // namespace

// The plan at chi (65 <= chi <= 128) as ints: the cluster's CTAs, its grid
// (rows, columns), br, bc, ld, the tiles ra, ry, rx, ry2 and the dynamic
// shared memory in bytes (12 ints); returns 0, or cudaErrorInvalidValue
// outside the range. Reads no device state.
extern "C" int env_chain_wide_plan(int chi, int* out) {
  if (chi < kMinChi || chi > kMaxChi) return (int)cudaErrorInvalidValue;
  const Plan P = wide_plan(chi);
  const int v[12] = {kCs, kGr, kGc, P.br, P.bc, P.ld, P.ra, P.ry, P.rx,
                     P.ry2, (int)smem_bytes(chi), kThreads};
  for (int k = 0; k < 12; ++k) out[k] = v[k];
  return 0;
}

// The CTAs of a chain's cluster at chi (0 where nothing launches).
extern "C" int env_chain_wide_cluster_size(int chi) {
  if (chi < kMinChi || chi > kMaxChi) return 0;
  cudaError_t err = cudaSuccess;
  return prepare(chi, &err);
}

// complex64, 65 <= chi <= 128: as env_chain_launch (counter holds 0 and
// stays private to this stream's launches; br and bl 16-byte aligned).
extern "C" int env_chain_wide_launch(const void* br, const void* bl,
                                     void* snaps, void* counter, void* out,
                                     int n, int chi, int q, void* stream) {
  if (chi < kMinChi || chi > kMaxChi || n < 1 || q < 0 || q >= n ||
      ((uintptr_t)br | (uintptr_t)bl) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (prepare(chi, &err) == 0) return (int)err;
  const Plan P = wide_plan(chi);
  Maps tm = {};
  if (P.vec) {
    const EncodeTiled enc = encode_tiled();
    if (enc == nullptr ||
        !stack_map(&tm.bf, enc, bl, n, chi, P.bc, chi) ||
        !stack_map(&tm.bb, enc, bl, n, chi, P.ldb, P.bc) ||
        !stack_map(&tm.af, enc, br, n, chi, P.lde, P.br) ||
        !stack_map(&tm.ab, enc, br, n, chi, P.lda, chi))
      return (int)cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      make_config(attr, smem_bytes(chi), (cudaStream_t)stream);
  ADAPTAQC_RETURN_IF_ERR(cudaLaunchKernelEx(
      &cfg, env_chain_wide_kernel, (const float2*)br, (const float2*)bl,
      (float2*)snaps, (int*)counter, (float2*)out, n, chi, q, tm));
  return (int)cudaGetLastError();
}
