// Streamed environment-chain kernel for 128 < chi <= 1024, for sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel _env_kernel
// (ops/pallas_env.py:46) where the TPU route itself leaves the kernel: past
// its VMEM budget the reference computes the same 2x2 local overlap matrix
// with XLA (backends/mps_core.py:371 local_overlap_matrix). Same function
// as env_chain.cu:
//   forward   e' = sum_p A_p^H e B_p        over sites 0 .. q-1
//   backward  f' = sum_p conj(A_p) f B_p^T  over sites n-1 .. q+1
//   combine   C[i, j] = sum_{a,y} G_j[a,y] K_i[a,y],
//             G_j = e B_j, K_i = conj(A_i) f   at site q.
//
// What bounds it on this card: 32 chi^3 flops a chain step (4.3 GFLOP at
// chi = 512, 215 GFLOP for n = 50: 3.2 ms at the fp32 peak; eight times
// that at chi = 1024), so unlike the cluster kernels of env_chain.cu this
// size has enough work a site to fill the card. At chi = 512 an
// environment is 2 MB (4 MB in complex128; 8 and 16 MB at chi = 1024): a
// site's operands no longer fit in a CTA's, or a cluster's, shared memory.
//
// The design is the simplest one that spreads a site over the card:
//   - the environments live in global memory, in the wrapper's `work`
//     (6 chi^2 elements: E and F, then M_0, M_1 of each chain); the chain
//     starts from the wrapper's boundary environment |0><0|, read in place;
//   - a site is two launches of one shared-memory-tiled complex product,
//     both chains in the same launch (grid z = the products of the launch):
//       step 1  M_p = E B_p (forward) or F B_p^T (backward), p = 0, 1;
//       step 2  E' = sum_p A_p^H M_p or F' = sum_p conj(A_p) M_p, a
//               product over the depth (p, a) = 2 chi, written over E (F),
//               which step 2 does not read;
//   - the combine is one launch of four products (G_0, G_1, K_0, K_1) and
//     a one-block reduction of the four sums, ranks in a fixed order.
// The host loop issues 2 max(q, n-1-q) + 2 launches on the caller's stream,
// reads nothing back and never synchronises.
//
// The product: a CTA of 256 threads computes a 64 x 64 tile of its
// output, 4 x 4 complex outputs a thread (rows ty + 16 u, columns tx +
// 16 v), from 64 x 16 and 16 x 64 tiles of the two operands staged in
// shared memory; ragged edges load zeros. Each output is summed by one
// thread over the depth in order, p outer, a inner, as complex FMAs
// (cfma below): the order that tests/test_torch_reach.py emulates. No
// split of the depth, no atomics: a rerun gives the same bits.
// Out of scope here: tensor cores, TMA, clusters, pipelining.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using adaptaqc::block_sum;

constexpr int kTile = 64;     // output rows and columns a CTA
constexpr int kDepth = 16;    // depth of a staged tile
constexpr int kThreads = 256;  // 16 x 16, 4 x 4 outputs each
constexpr int kCombineThreads = 1024;
constexpr int kMinChi = 129;  // below: env_chain.cu's cluster kernels
constexpr int kMaxChi = 1024;  // any chi tiles: the cap is the port's reach
constexpr int kMaxJobs = 4;

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
}
__device__ __forceinline__ void cfma(double2& acc, double2 a, double2 b) {
  acc.x = fma(a.x, b.x, fma(-a.y, b.y, acc.x));
  acc.y = fma(a.x, b.y, fma(a.y, b.x, acc.y));
}

// One product C = L R of chi x chi outputs (row-major, C[i * chi + j]):
// C[i][j] = sum_{p < np} sum_{a < chi} L(i, p, a) R(p, a, j), with
//   L(i, p, a) = l[p l_p + i l_i + a l_a]   (conjugated if conj_l)
//   R(p, a, j) = r[p r_p + a r_a + j r_j]
// (strides in elements).
template <typename V>
struct Job {
  const V* l;
  const V* r;
  V* c;
  long long l_i, l_a, l_p, r_a, r_j, r_p;
  int np, conj_l;
};

template <typename V>
struct Jobs {
  Job<V> job[kMaxJobs];
};

// Grid: (ceil(chi / 64), ceil(chi / 64), jobs); block z runs job z.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    stream_product_kernel(const Jobs<V> jobs, int c) {
  using T = decltype(V::x);
  const Job<V> jb = jobs.job[blockIdx.z];
  __shared__ V Ls[kDepth][kTile + 1];
  __shared__ V Rs[kDepth][kTile + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const V zero = {T(0), T(0)};
  V acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = zero;
  for (int p = 0; p < jb.np; ++p) {
    const V* lp = jb.l + p * jb.l_p;
    const V* rp = jb.r + p * jb.r_p;
    for (int a0 = 0; a0 < c; a0 += kDepth) {
      // the operands' tiles, walking whichever index is contiguous in
      // global memory fastest across the threads
      for (int idx = tid; idx < kTile * kDepth; idx += kThreads) {
        const bool by_row = jb.l_i == 1;
        const int ii = by_row ? idx % kTile : idx / kDepth;
        const int kk = by_row ? idx / kTile : idx % kDepth;
        const int i = i0 + ii, a = a0 + kk;
        V v = zero;
        if (i < c && a < c) {
          v = lp[i * jb.l_i + a * jb.l_a];
          if (jb.conj_l) v.y = -v.y;
        }
        Ls[kk][ii] = v;
      }
      for (int idx = tid; idx < kTile * kDepth; idx += kThreads) {
        const bool by_col = jb.r_j == 1;
        const int jj = by_col ? idx % kTile : idx / kDepth;
        const int kk = by_col ? idx / kTile : idx % kDepth;
        const int j = j0 + jj, a = a0 + kk;
        Rs[kk][jj] = (j < c && a < c) ? rp[a * jb.r_a + j * jb.r_j] : zero;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kDepth; ++kk) {
        V l[4], r[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          l[u] = Ls[kk][ty + 16 * u];
          r[u] = Rs[kk][tx + 16 * u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) cfma(acc[u][v], l[u], r[v]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = i0 + ty + 16 * u, j = j0 + tx + 16 * v;
      if (i < c && j < c) jb.c[(size_t)i * c + j] = acc[u][v];
    }
}

// out[i * 2 + j] = sum_x G_j[x] K_i[x] over the chi^2 entries (g: G_0,
// G_1; k: K_0, K_1, each cc elements): one block, each thread's sums over
// its entries in order, then block_sum's fixed tree.
template <typename V>
__global__ void __launch_bounds__(kCombineThreads)
    stream_combine_kernel(const V* __restrict__ g, const V* __restrict__ k,
                          V* __restrict__ out, int cc) {
  using T = decltype(V::x);
  __shared__ T red[33];
  T part[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int idx = threadIdx.x; idx < cc; idx += kCombineThreads) {
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const V gv = g[jj * cc + idx], kv = k[ii * cc + idx];
        part[(ii * 2 + jj) * 2] += gv.x * kv.x - gv.y * kv.y;
        part[(ii * 2 + jj) * 2 + 1] += gv.x * kv.y + gv.y * kv.x;
      }
  }
#pragma unroll
  for (int x = 0; x < 8; ++x) part[x] = block_sum(part[x], red);
  if (threadIdx.x < 4) {
    V o;
    o.x = part[2 * threadIdx.x];
    o.y = part[2 * threadIdx.x + 1];
    out[threadIdx.x] = o;
  }
}

template <typename V>
cudaError_t launch_products(const Jobs<V>& jobs, int count, int c,
                            cudaStream_t stream) {
  const int tiles = (c + kTile - 1) / kTile;
  stream_product_kernel<V><<<dim3(tiles, tiles, count), kThreads, 0,
                             stream>>>(jobs, c);
  return cudaGetLastError();
}

// M_p = X S_p (site tensor S_p[a][j], fwd) or X S_p^T (S_p[j][a]), p = 0, 1
template <typename V>
void step1_jobs(Jobs<V>& jobs, int& count, const V* x, const V* site, V* m,
                int c, bool fwd) {
  const long long cc = (long long)c * c;
  for (int p = 0; p < 2; ++p) {
    Job<V>& j = jobs.job[count++];
    j.l = x;
    j.l_i = c;
    j.l_a = 1;
    j.l_p = 0;
    j.r = site + p * cc;
    j.r_a = fwd ? c : 1;
    j.r_j = fwd ? 1 : c;
    j.r_p = 0;
    j.c = m + p * cc;
    j.np = 1;
    j.conj_l = 0;
  }
}

// out = sum_p A_p^H M_p (fwd: L(x, p, a) = conj(A_p[a][x])) or sum_p
// conj(A_p) M_p (L(x, p, a) = conj(A_p[x][a])), M the two products of
// step 1 laid out [p][a][y]
template <typename V>
void step2_job(Jobs<V>& jobs, int& count, const V* site, const V* m, V* out,
               int c, bool fwd) {
  const long long cc = (long long)c * c;
  Job<V>& j = jobs.job[count++];
  j.l = site;
  j.l_i = fwd ? 1 : c;
  j.l_a = fwd ? c : 1;
  j.l_p = cc;
  j.r = m;
  j.r_a = c;
  j.r_j = 1;
  j.r_p = cc;
  j.c = out;
  j.np = 2;
  j.conj_l = 1;
}

template <typename V>
int run(const V* br, const V* bl, const V* e0, V* work, V* out, int n,
        int c, int q, cudaStream_t stream) {
  const long long cc = (long long)c * c;
  const long long site = 2 * cc;
  V* env[2] = {work, work + cc};          // E, F
  V* mm[2] = {work + 2 * cc, work + 4 * cc};  // M_0, M_1 of each chain
  const V* cur[2] = {e0, e0};
  const int count_of[2] = {q, n - 1 - q};
  const int steps = count_of[0] > count_of[1] ? count_of[0] : count_of[1];
  for (int s = 0; s < steps; ++s) {
    Jobs<V> jobs1 = {}, jobs2 = {};
    int n1 = 0, n2 = 0;
    for (int ch = 0; ch < 2; ++ch) {
      if (s >= count_of[ch]) continue;
      const bool fwd = ch == 0;
      const int i = fwd ? s : n - 1 - s;
      step1_jobs(jobs1, n1, cur[ch], bl + i * site, mm[ch], c, fwd);
      step2_job(jobs2, n2, br + i * site, mm[ch], env[ch], c, fwd);
      cur[ch] = env[ch];
    }
    ADAPTAQC_RETURN_IF_ERR(launch_products(jobs1, n1, c, stream));
    ADAPTAQC_RETURN_IF_ERR(launch_products(jobs2, n2, c, stream));
  }
  // combine at q: G_j = e B_j into mm[0], K_i = conj(A_i) f into mm[1]
  Jobs<V> jobs = {};
  int nj = 0;
  step1_jobs(jobs, nj, cur[0], bl + q * site, mm[0], c, true);
  for (int i = 0; i < 2; ++i) {
    Job<V>& j = jobs.job[nj++];
    j.l = br + q * site + i * cc;  // L(a, x) = conj(A_i[a][x])
    j.l_i = c;
    j.l_a = 1;
    j.l_p = 0;
    j.r = cur[1];                  // R(x, y) = f[x][y]
    j.r_a = c;
    j.r_j = 1;
    j.r_p = 0;
    j.c = mm[1] + i * cc;
    j.np = 1;
    j.conj_l = 1;
  }
  ADAPTAQC_RETURN_IF_ERR(launch_products(jobs, nj, c, stream));
  stream_combine_kernel<V><<<1, kCombineThreads, 0, stream>>>(
      mm[0], mm[1], out, (int)cc);
  return (int)cudaGetLastError();
}

}  // namespace

// The streamed chain, complex64 (f64 = 0) or complex128: br, bl (n, 2, chi,
// chi), e0 the boundary environment (chi, chi), work 6 chi^2 elements of
// scratch, out (2, 2); 128 < chi <= 1024, 0 <= q < n. Launches 2 max(q,
// n-1-q) + 2 kernels on `stream`; returns the first launch error.
extern "C" int env_chain_stream_launch(const void* br, const void* bl,
                                       const void* e0, void* work, void* out,
                                       int n, int chi, int q, int f64,
                                       void* stream) {
  if (chi < kMinChi || chi > kMaxChi || n < 1 || q < 0 || q >= n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    return run<double2>((const double2*)br, (const double2*)bl,
                        (const double2*)e0, (double2*)work, (double2*)out, n,
                        chi, q, st);
  return run<float2>((const float2*)br, (const float2*)bl, (const float2*)e0,
                     (float2*)work, (float2*)out, n, chi, q, st);
}
