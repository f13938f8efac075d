// Streamed environment-chain kernel for 128 < chi <= 8192, for sm_90a.
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
// that at chi = 1024); an environment is 2 MB at chi = 512 (4 MB in
// complex128; 8 and 16 MB at chi = 1024), so a site's operands live in
// global memory and the work is a chain of dense complex products: bound by
// operations, as cuBLAS's cgemm / zgemm would be.
//
// The host loop (run below):
//   - the environments live in the wrapper's `work` (6 chi^2 elements: E
//     and F, then M_0, M_1 of each chain, then the slices' partial sums);
//     the chain starts from the wrapper's boundary environment |0><0|;
//   - a site is two product launches, both chains in each (grid z = the
//     products times the depth slices):
//       step 1  M_p = E B_p (forward) or F B_p^T (backward), p = 0, 1;
//       step 2  E' = sum_p A_p^H M_p or F' = sum_p conj(A_p) M_p, a
//               product over the depth (p, a) = 2 chi, written over E (F),
//               which step 2 does not read;
//   - the combine is one launch of four products (G_0, G_1, K_0, K_1) and
//     a one-block reduction of the four sums, ranks in a fixed order;
//   - where a launch's CTAs fill its waves of the card's 132 SMs (times
//     the CTAs an SM holds) badly, below one wave above all, the plan
//     (plan_slices) splits the depth into S slices of whole depth tiles;
//     each slice writes its partial sums to `work`, and a second launch
//     (stream_reduce_kernel) adds the S partials of each output in slice
//     order.
// The host loop reads nothing back and never synchronises; no atomics, so
// a rerun gives the same bits.
//
// The product (designed for Hopper; this kernel's first version was a 64 x
// 64 tile of 4 x 4 outputs a thread on single-buffered 16-deep tiles, 48%
// of the fp32 peak at chi = 1024 and on DFMA in complex128):
//   - operand tiles reach shared memory by cp.async (16 bytes a copy; 8
//     in complex64 at odd chi), in a ring of STAGES depth tiles, so the
//     next tiles load while this one is multiplied; ragged edges are
//     zero-filled by the copy, and a zero adds exactly nothing;
//   - each operand keeps the layout it has in global memory (the index
//     that is contiguous there is contiguous in shared memory), padded so
//     that the fragment reads below are free of bank conflicts; a job's
//     layout pair (kind) picks one of four instantiations of the loop, so
//     products of both chains, whose layouts differ, share a launch;
//   - complex64 on FFMA in exact fp32 (no TF32): a 128 x 128 CTA tile of
//     512 threads (chi >= 512), else 64 x 64 of 128, 8 x 4 complex outputs
//     a thread, fragments read as 16-byte loads of two complex values;
//     each output is summed by one thread over its slice's depth in order
//     (cfma, p outer, a inner);
//   - complex128 on the fp64 tensor cores (DMMA, mma.sync m16n8k4, full
//     IEEE fp64): a 64 x 64 CTA tile of four warps, each a 32 x 32 tile of
//     2 x 4 mma tiles; a complex product is four real ones, into one
//     accumulator for the real part and one for the imaginary, per depth
//     step of 4.
// The bits of an output depend on the slice split (the plan fixes it by
// chi, dtype and launch), not on the CTA tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using adaptaqc::block_sum;
using adaptaqc::cp_async16_zfill;
using adaptaqc::cp_async8_zfill;
using adaptaqc::cp_async_commit;
using adaptaqc::cp_async_wait;
using adaptaqc::dmma16;

constexpr int kCombineThreads = 1024;
constexpr int kReduceThreads = 256;
constexpr int kMinChi = 129;   // below: env_chain.cu's cluster kernels
constexpr int kMaxChi = 8192;  // any chi tiles: the cap is the port's reach
constexpr int kMaxJobs = 4;
constexpr int kWaveCtas = 132;  // one wave: the H100 SXM's SMs

// The CTA tiles (ops/env_kernel.py STREAM_CONFIGS mirrors this table and
// plan_config / plan_slices): rows BM, columns BN, depth tile BK, threads,
// ring stages, complex elements a cp.async, and the CTAs an SM holds that
// the plan fills (a wave is kWaveCtas times that).
struct Config {
  int bm, bn, bk, threads, stages, vec, fill, tm, tn;
};
constexpr Config kConfigs[4] = {
    {128, 128, 16, 512, 3, 2, 1, 8, 4},  // 0: complex64, even chi >= 512
    {64, 64, 16, 128, 4, 2, 3, 8, 4},    // 1: complex64, even chi < 512
    {64, 64, 16, 128, 4, 1, 3, 8, 4},    // 2: complex64, odd chi (8 bytes)
    {64, 64, 8, 128, 4, 1, 2, 0, 0},     // 3: complex128 (DMMA)
};

int plan_config(int c, int f64) {
  if (f64) return 3;
  if (c % 2) return 2;
  return c >= 512 ? 0 : 1;
}

// Depth slices of a launch of `products` products of depth np * c: of S
// = 1 .. kMaxSlices (at most one depth tile a slice), the S whose waves of
// kWaveCtas * fill CTAs, each 1 / S of the depth, take the least time,
// ceil(ctas S / wave) / S; a split must give at least kWaveCtas CTAs, and
// a larger S must gain 10% over the best smaller one, to pay for its
// reduction.
constexpr int kMaxSlices = 16;

int plan_slices(int cfg, int c, int products, int np) {
  const Config& k = kConfigs[cfg];
  const int ctas =
      ((c + k.bm - 1) / k.bm) * ((c + k.bn - 1) / k.bn) * products;
  const int wave = kWaveCtas * k.fill;
  const int tiles = np * ((c + k.bk - 1) / k.bk);
  const int top = tiles < kMaxSlices ? tiles : kMaxSlices;
  int best = 1, best_w = (ctas + wave - 1) / wave;
  for (int s = 2; s <= top; ++s) {
    const int w = (ctas * s + wave - 1) / wave;
    if (ctas * s >= kWaveCtas && 10 * w * best < 9 * best_w * s) {  // w / s < 0.9 best_w / best
      best = s;
      best_w = w;
    }
  }
  return best;
}

// (products, np) of the launches the host loop makes: step 1 of both
// chains or one, step 2 of both or one; the combine is (4, 1).
constexpr int kLaunches[4][2] = {{4, 1}, {2, 1}, {2, 2}, {1, 2}};

long long plan_work(int c, int f64) {
  const int cfg = plan_config(c, f64);
  const long long cc = (long long)c * c;
  long long part = 0;
  for (int i = 0; i < 4; ++i) {
    const int p = kLaunches[i][0];
    const int s = plan_slices(cfg, c, p, kLaunches[i][1]);
    if (s > 1 && (long long)s * p > part) part = (long long)s * p;
  }
  return 6 * cc + part * cc;
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

// One product C = L R of chi x chi outputs (row-major, C[i * chi + j]):
// C[i][j] = sum_{p < np} sum_{a < chi} L(i, p, a) R(p, a, j), with
//   L(i, p, a) = l[p l_p + i l_i + a l_a]   (conjugated if conj_l)
//   R(p, a, j) = r[p r_p + a r_a + j r_j]
// (strides in elements). kind: the layout pair, set by the host (make_kind)
// from which index is contiguous (l_a == 1: "LK", else l_i == 1: "LM";
// r_j == 1: "RN", else r_a == 1: "RK") and conj_l.
template <typename V>
struct Job {
  const V* l;
  const V* r;
  V* c;
  long long l_i, l_a, l_p, r_a, r_j, r_p;
  int np, conj_l, kind;
};

template <typename V>
struct Jobs {
  Job<V> job[kMaxJobs];
};

// The four layout pairs the host loop uses: (L contiguous in a, R
// contiguous in j, conj L).
enum Kind : int {
  kLkRn = 0,      // step 1 forward, the combine's G_j
  kLkRk = 1,      // step 1 backward (B_p^T)
  kLmRnConj = 2,  // step 2 forward (A_p^H)
  kLkRnConj = 3,  // step 2 backward, the combine's K_i
};

// The rows of a CTA's tile its padded shared-memory layouts hold, in
// complex elements: L as [m][BK + PK] (LK) or [k][BM + PM] (LM), R as
// [k][BN + PM] (RN) or [n][BK + PK] (RK).
template <int BM, int BN, int BK, int PK, int PM>
struct Smem {
  static constexpr int kLk = BM * (BK + PK), kLm = BK * (BM + PM);
  static constexpr int kRn = BK * (BN + PM), kRk = BN * (BK + PK);
  static constexpr int kL = kLk > kLm ? kLk : kLm;
  static constexpr int kR = kRn > kRk ? kRn : kRk;
  static constexpr int kStage = kL + kR;
};

// Copies depth tile t of a job's L and R into one stage of the ring, by
// cp.async of VEC complex elements along each operand's contiguous index;
// out-of-range elements are zero-filled.
template <typename V, int BM, int BN, int BK, int PK, int PM, int NT,
          int VEC, bool LK, bool RN>
__device__ __forceinline__ void load_tile(const Job<V>& jb, int t, int ktp,
                                          int i0, int j0, int c, V* Ls,
                                          V* Rs) {
  const int p = t / ktp, a0 = (t % ktp) * BK;
  const V* lp = jb.l + p * jb.l_p;
  const V* rp = jb.r + p * jb.r_p;
  const int tid = threadIdx.x;
  auto copy = [](V* dst, const V* src, bool ok) {
    if (sizeof(V) * VEC == 16)
      cp_async16_zfill(dst, src, ok);
    else
      cp_async8_zfill(dst, src, ok);
  };
  if (LK) {
    constexpr int per = BK / VEC, total = BM * per;
    for (int idx = tid; idx < total; idx += NT) {
      const int m = idx / per, kk = (idx % per) * VEC;
      const int gi = i0 + m, ga = a0 + kk;
      const bool ok = gi < c && ga < c;
      copy(Ls + m * (BK + PK) + kk, ok ? lp + gi * jb.l_i + ga : lp, ok);
    }
  } else {
    constexpr int per = BM / VEC, total = BK * per;
    for (int idx = tid; idx < total; idx += NT) {
      const int kk = idx / per, m = (idx % per) * VEC;
      const int gi = i0 + m, ga = a0 + kk;
      const bool ok = gi < c && ga < c;
      copy(Ls + kk * (BM + PM) + m, ok ? lp + gi + ga * jb.l_a : lp, ok);
    }
  }
  if (RN) {
    constexpr int per = BN / VEC, total = BK * per;
    for (int idx = tid; idx < total; idx += NT) {
      const int kk = idx / per, n = (idx % per) * VEC;
      const int gj = j0 + n, ga = a0 + kk;
      const bool ok = gj < c && ga < c;
      copy(Rs + kk * (BN + PM) + n, ok ? rp + ga * jb.r_a + gj : rp, ok);
    }
  } else {
    constexpr int per = BK / VEC, total = BN * per;
    for (int idx = tid; idx < total; idx += NT) {
      const int n = idx / per, kk = (idx % per) * VEC;
      const int gj = j0 + n, ga = a0 + kk;
      const bool ok = gj < c && ga < c;
      copy(Rs + n * (BK + PK) + kk, ok ? rp + ga + gj * jb.r_j : rp, ok);
    }
  }
}

// The ring: tiles [t0, t1) of a job, STAGES deep; compute(Ls, Rs) is
// called once a tile, in order.
template <typename V, int BM, int BN, int BK, int PK, int PM, int NT,
          int VEC, int STAGES, bool LK, bool RN, typename F>
__device__ __forceinline__ void pipeline(const Job<V>& jb, int t0, int t1,
                                         int ktp, int i0, int j0, int c,
                                         V* smem, F&& compute) {
  using S = Smem<BM, BN, BK, PK, PM>;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (t0 + i < t1) {
      V* st = smem + i * S::kStage;
      load_tile<V, BM, BN, BK, PK, PM, NT, VEC, LK, RN>(jb, t0 + i, ktp, i0,
                                                       j0, c, st, st + S::kL);
    }
    cp_async_commit();
  }
  for (int t = t0; t < t1; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int tn = t + STAGES - 1;
    if (tn < t1) {
      V* st = smem + ((tn - t0) % STAGES) * S::kStage;
      load_tile<V, BM, BN, BK, PK, PM, NT, VEC, LK, RN>(jb, tn, ktp, i0, j0,
                                                       c, st, st + S::kL);
    }
    cp_async_commit();
    const V* st = smem + ((t - t0) % STAGES) * S::kStage;
    compute(st, st + S::kL);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------- complex64
// Thread (tm, tn) of the (BM / TM) x (BN / TN) grid owns TM rows and TN
// columns. Rows: LK m = tm + (BM / TM) u; LM m = 2 tm + 2 (BM / TM) (u /
// 2) + u % 2 (pairs, so that one 16-byte read gives two rows). Columns
// likewise by R's layout.
template <int BM, int BN, int BK, int NT, int VEC, int STAGES, int TM,
          int TN, bool LK, bool RN, bool CONJ>
__device__ __forceinline__ void product_f32(const Job<float2>& jb, int t0,
                                            int t1, int ktp, int c,
                                            float2* dst, float2* smem) {
  constexpr int PK = 2, PM = 0;
  constexpr int TMT = BM / TM, TNT = BN / TN;
  static_assert(TMT * TNT == NT, "the thread grid is the CTA");
  const int tid = threadIdx.x, tm = tid / TNT, tn = tid % TNT;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  float2 acc[TM][TN];
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int w = 0; w < TN; ++w) acc[u][w] = make_float2(0.f, 0.f);
  pipeline<float2, BM, BN, BK, PK, PM, NT, VEC, STAGES, LK, RN>(
      jb, t0, t1, ktp, i0, j0, c, smem,
      [&](const float2* Ls, const float2* Rs) {
#pragma unroll
        for (int kp = 0; kp < BK / 2; ++kp) {
          float2 a[TM][2], b[TN][2];
#pragma unroll
          for (int u = 0; u < TM; ++u) {
            if (LK) {
              const float4 v = *reinterpret_cast<const float4*>(
                  Ls + (tm + TMT * u) * (BK + PK) + 2 * kp);
              a[u][0] = make_float2(v.x, v.y);
              a[u][1] = make_float2(v.z, v.w);
            } else if (u % 2 == 0) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float4 v = *reinterpret_cast<const float4*>(
                    Ls + (2 * kp + h) * (BM + PM) + 2 * tm + 2 * TMT * (u / 2));
                a[u][h] = make_float2(v.x, v.y);
                a[u + 1][h] = make_float2(v.z, v.w);
              }
            }
          }
#pragma unroll
          for (int w = 0; w < TN; ++w) {
            if (!RN) {
              const float4 v = *reinterpret_cast<const float4*>(
                  Rs + (tn + TNT * w) * (BK + PK) + 2 * kp);
              b[w][0] = make_float2(v.x, v.y);
              b[w][1] = make_float2(v.z, v.w);
            } else if (w % 2 == 0) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float4 v = *reinterpret_cast<const float4*>(
                    Rs + (2 * kp + h) * (BN + PM) + 2 * tn + 2 * TNT * (w / 2));
                b[w][h] = make_float2(v.x, v.y);
                b[w + 1][h] = make_float2(v.z, v.w);
              }
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int u = 0; u < TM; ++u)
#pragma unroll
              for (int w = 0; w < TN; ++w) {
                if (CONJ)
                  cfma_conj(acc[u][w], a[u][h], b[w][h]);
                else
                  cfma(acc[u][w], a[u][h], b[w][h]);
              }
        }
      });
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int i = i0 + (LK ? tm + TMT * u : 2 * tm + 2 * TMT * (u / 2) + u % 2);
#pragma unroll
    for (int w = 0; w < TN; ++w) {
      const int j =
          j0 + (RN ? 2 * tn + 2 * TNT * (w / 2) + w % 2 : tn + TNT * w);
      if (i < c && j < c) dst[(size_t)i * c + j] = acc[u][w];
    }
  }
}

// --------------------------------------------------------------- complex128
// Warp w takes the 32 x 32 tile at rows 32 (w / (BN / 32)), columns 32 (w
// % (BN / 32)): 2 x 4 mma tiles of 16 x 8 (dmma16, m16n8k4: m8n8k4 runs at half
// the fp64 tensor rate on an H100), each with a real and an imaginary
// accumulator.
template <int BM, int BN, int BK, int NT, int STAGES, bool LK, bool RN,
          bool CONJ>
__device__ __forceinline__ void product_f64(const Job<double2>& jb, int t0,
                                            int t1, int ktp, int c,
                                            double2* dst, double2* smem) {
  constexpr int PK = 4, PM = 2;
  constexpr int WN = BN / 32;  // warps along a row of the CTA tile
  static_assert((BM / 32) * WN * 32 == NT, "a warp a 32 x 32 tile");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 32 * (warp / WN), wn = 32 * (warp % WN);
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int g = lane >> 2, t4 = lane & 3;
  double acc[2][4][2][4];  // [m tile][n tile][re, im][fragment]
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y)
#pragma unroll
      for (int z = 0; z < 2; ++z)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[x][y][z][f] = 0.0;
  pipeline<double2, BM, BN, BK, PK, PM, NT, 1, STAGES, LK, RN>(
      jb, t0, t1, ktp, i0, j0, c, smem,
      [&](const double2* Ls, const double2* Rs) {
#pragma unroll
        for (int ks = 0; ks < BK / 4; ++ks) {
          const int k = 4 * ks + t4;
          double2 a[2][2], b[4];
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = wm + 16 * x + 8 * h + g;
              a[x][h] = LK ? Ls[row * (BK + PK) + k] : Ls[k * (BM + PM) + row];
              if (CONJ) a[x][h].y = -a[x][h].y;
            }
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            const int col = wn + 8 * y + g;
            b[y] = RN ? Rs[k * (BN + PM) + col] : Rs[col * (BK + PK) + k];
          }
          // two passes, so that the second product into an accumulator
          // issues 16 products after the first (its latency hidden)
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y) {
              dmma16(acc[x][y][0], a[x][0].x, a[x][1].x, b[y].x);
              dmma16(acc[x][y][1], a[x][0].x, a[x][1].x, b[y].y);
            }
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y) {
              dmma16(acc[x][y][0], -a[x][0].y, -a[x][1].y, b[y].y);
              dmma16(acc[x][y][1], a[x][0].y, a[x][1].y, b[y].x);
            }
        }
      });
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int i = i0 + wm + 16 * x + 8 * (f / 2) + g;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int j = j0 + wn + 8 * y + 2 * t4 + f % 2;
        if (i < c && j < c)
          dst[(size_t)i * c + j] = make_double2(acc[x][y][0][f],
                                                acc[x][y][1][f]);
      }
    }
}

// The slice [t0, t1) of the job's depth tiles, and where its sums go: the
// output itself (S = 1) or the slice's partials in `part`.
template <typename V>
__device__ __forceinline__ void slice_of(const Job<V>& jb, int bk, int c,
                                         int products, int slices, V* part,
                                         int z, int s, int& ktp, int& t0,
                                         int& t1, V*& dst) {
  ktp = (c + bk - 1) / bk;
  const int tiles = jb.np * ktp;
  t0 = (int)((long long)s * tiles / slices);
  t1 = (int)((long long)(s + 1) * tiles / slices);
  dst = slices == 1 ? jb.c : part + (size_t)(s * products + z) * c * c;
}

// Grid: (ceil(chi / BN), ceil(chi / BM), products x slices); block z runs
// job z % products, depth slice z / products.
template <int CFG>
__global__ void __launch_bounds__(kConfigs[CFG].threads)
    stream_product_f32_kernel(const Jobs<float2> jobs, int products,
                              int slices, float2* part, int c) {
  constexpr Config k = kConfigs[CFG];
  extern __shared__ float4 smem_f32[];
  float2* smem = reinterpret_cast<float2*>(smem_f32);
  const int z = blockIdx.z % products, s = blockIdx.z / products;
  const Job<float2>& jb = jobs.job[z];
  int ktp, t0, t1;
  float2* dst;
  slice_of(jb, k.bk, c, products, slices, part, z, s, ktp, t0, t1, dst);
#define ADAPTAQC_F32(LK, RN, CJ)                                          \
  product_f32<k.bm, k.bn, k.bk, k.threads, k.vec, k.stages, k.tm, k.tn, LK, \
              RN, CJ>(jb, t0, t1, ktp, c, dst, smem)
  switch (jb.kind) {
    case kLkRn: ADAPTAQC_F32(true, true, false); break;
    case kLkRk: ADAPTAQC_F32(true, false, false); break;
    case kLmRnConj: ADAPTAQC_F32(false, true, true); break;
    default: ADAPTAQC_F32(true, true, true); break;
  }
#undef ADAPTAQC_F32
}

template <int CFG>
__global__ void __launch_bounds__(kConfigs[CFG].threads)
    stream_product_f64_kernel(const Jobs<double2> jobs, int products,
                              int slices, double2* part, int c) {
  constexpr Config k = kConfigs[CFG];
  extern __shared__ double2 smem_f64[];
  const int z = blockIdx.z % products, s = blockIdx.z / products;
  const Job<double2>& jb = jobs.job[z];
  int ktp, t0, t1;
  double2* dst;
  slice_of(jb, k.bk, c, products, slices, part, z, s, ktp, t0, t1, dst);
#define ADAPTAQC_F64(LK, RN, CJ)                                      \
  product_f64<k.bm, k.bn, k.bk, k.threads, k.stages, LK, RN, CJ>(     \
      jb, t0, t1, ktp, c, dst, smem_f64)
  switch (jb.kind) {
    case kLkRn: ADAPTAQC_F64(true, true, false); break;
    case kLkRk: ADAPTAQC_F64(true, false, false); break;
    case kLmRnConj: ADAPTAQC_F64(false, true, true); break;
    default: ADAPTAQC_F64(true, true, true); break;
  }
#undef ADAPTAQC_F64
}

// job z's output = the sum of its `slices` partials, in slice order.
template <typename V>
__global__ void __launch_bounds__(kReduceThreads)
    stream_reduce_kernel(const Jobs<V> jobs, int products, int slices,
                         const V* __restrict__ part, long long cc) {
  const long long total = products * cc;
  for (long long idx = blockIdx.x * (long long)kReduceThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kReduceThreads) {
    const int z = (int)(idx / cc);
    const long long x = idx % cc;
    V v = part[z * cc + x];
    for (int s = 1; s < slices; ++s) {
      const V w = part[((long long)s * products + z) * cc + x];
      v.x += w.x;
      v.y += w.y;
    }
    jobs.job[z].c[x] = v;
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

template <int CFG, typename V>
int smem_bytes() {
  constexpr Config k = kConfigs[CFG];
  constexpr int pk = sizeof(V) == 16 ? 4 : 2, pm = sizeof(V) == 16 ? 2 : 0;
  return k.stages * Smem<k.bm, k.bn, k.bk, pk, pm>::kStage * (int)sizeof(V);
}

template <int CFG>
cudaError_t launch_cfg(const Jobs<float2>& jobs, int products, int slices,
                       float2* part, int c, dim3 grid, cudaStream_t st) {
  static bool ready = false;
  const int bytes = smem_bytes<CFG, float2>();
  if (!ready) {
    ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
        stream_product_f32_kernel<CFG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
    ready = true;
  }
  stream_product_f32_kernel<CFG><<<grid, kConfigs[CFG].threads, bytes, st>>>(
      jobs, products, slices, part, c);
  return cudaGetLastError();
}

template <int CFG>
cudaError_t launch_cfg(const Jobs<double2>& jobs, int products, int slices,
                       double2* part, int c, dim3 grid, cudaStream_t st) {
  static bool ready = false;
  const int bytes = smem_bytes<CFG, double2>();
  if (!ready) {
    ADAPTAQC_RETURN_IF_ERR(cudaFuncSetAttribute(
        stream_product_f64_kernel<CFG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
    ready = true;
  }
  stream_product_f64_kernel<CFG><<<grid, kConfigs[CFG].threads, bytes, st>>>(
      jobs, products, slices, part, c);
  return cudaGetLastError();
}

// The products of `jobs` (all of depth np * c), then, where the plan
// splits their depth, the reduction of the slices.
template <typename V>
cudaError_t launch_products(const Jobs<V>& jobs, int products, int np, int c,
                            V* part, cudaStream_t st) {
  for (int i = 0; i < products; ++i)
    if (jobs.job[i].kind < 0 || jobs.job[i].np != np)
      return cudaErrorInvalidValue;
  const int cfg = plan_config(c, sizeof(V) == 16);
  const Config& k = kConfigs[cfg];
  const int slices = plan_slices(cfg, c, products, np);
  const dim3 grid((c + k.bn - 1) / k.bn, (c + k.bm - 1) / k.bm,
                  products * slices);
  cudaError_t err;
  if constexpr (sizeof(V) == 16) {
    err = launch_cfg<3>(jobs, products, slices, part, c, grid, st);
  } else {
    if (cfg == 0)
      err = launch_cfg<0>(jobs, products, slices, part, c, grid, st);
    else if (cfg == 1)
      err = launch_cfg<1>(jobs, products, slices, part, c, grid, st);
    else
      err = launch_cfg<2>(jobs, products, slices, part, c, grid, st);
  }
  ADAPTAQC_RETURN_IF_ERR(err);
  if (slices == 1) return cudaSuccess;
  const long long cc = (long long)c * c;
  const long long blocks = (products * cc + kReduceThreads - 1) /
                           kReduceThreads;
  stream_reduce_kernel<V><<<(int)(blocks < 4096 ? blocks : 4096),
                            kReduceThreads, 0, st>>>(jobs, products, slices,
                                                      part, cc);
  return cudaGetLastError();
}

// The job's layout pair from its strides; -1 where the kernel has none.
template <typename V>
int make_kind(const Job<V>& j) {
  const bool lk = j.l_a == 1, lm = j.l_i == 1;
  const bool rn = j.r_j == 1, rk = j.r_a == 1;
  if (lk && rn) return j.conj_l ? kLkRnConj : kLkRn;
  if (lk && rk && !j.conj_l) return kLkRk;
  if (lm && rn && j.conj_l) return kLmRnConj;
  return -1;
}

template <typename V>
Job<V>& add_job(Jobs<V>& jobs, int& count, const V* l, long long l_i,
                long long l_a, long long l_p, const V* r, long long r_a,
                long long r_j, long long r_p, V* c, int np, int conj_l) {
  Job<V>& j = jobs.job[count++];
  j.l = l;
  j.l_i = l_i;
  j.l_a = l_a;
  j.l_p = l_p;
  j.r = r;
  j.r_a = r_a;
  j.r_j = r_j;
  j.r_p = r_p;
  j.c = c;
  j.np = np;
  j.conj_l = conj_l;
  j.kind = make_kind(j);
  return j;
}

// M_p = X S_p (site tensor S_p[a][j], fwd) or X S_p^T (S_p[j][a]), p = 0, 1
template <typename V>
void step1_jobs(Jobs<V>& jobs, int& count, const V* x, const V* site, V* m,
                int c, bool fwd) {
  const long long cc = (long long)c * c;
  for (int p = 0; p < 2; ++p)
    add_job(jobs, count, x, c, 1, 0, site + p * cc, fwd ? c : 1,
            fwd ? 1 : c, 0, m + p * cc, 1, 0);
}

// out = sum_p A_p^H M_p (fwd: L(x, p, a) = conj(A_p[a][x])) or sum_p
// conj(A_p) M_p (L(x, p, a) = conj(A_p[x][a])), M the two products of
// step 1 laid out [p][a][y]
template <typename V>
void step2_job(Jobs<V>& jobs, int& count, const V* site, const V* m, V* out,
               int c, bool fwd) {
  const long long cc = (long long)c * c;
  add_job(jobs, count, site, fwd ? 1 : c, fwd ? c : 1, cc, m, c, 1, cc, out,
          2, 1);
}

template <typename V>
int run(const V* br, const V* bl, const V* e0, V* work, V* out, int n,
        int c, int q, cudaStream_t stream) {
  const long long cc = (long long)c * c;
  const long long site = 2 * cc;
  V* env[2] = {work, work + cc};              // E, F
  V* mm[2] = {work + 2 * cc, work + 4 * cc};  // M_0, M_1 of each chain
  V* part = work + 6 * cc;                    // the slices' partial sums
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
    ADAPTAQC_RETURN_IF_ERR(launch_products(jobs1, n1, 1, c, part, stream));
    ADAPTAQC_RETURN_IF_ERR(launch_products(jobs2, n2, 2, c, part, stream));
  }
  // combine at q: G_j = e B_j into mm[0], K_i = conj(A_i) f into mm[1]
  // (K_i(a, y) = sum_x conj(A_i[a][x]) f[x][y])
  Jobs<V> jobs = {};
  int nj = 0;
  step1_jobs(jobs, nj, cur[0], bl + q * site, mm[0], c, true);
  for (int i = 0; i < 2; ++i)
    add_job(jobs, nj, br + q * site + i * cc, c, 1, 0, cur[1], c, 1, 0,
            mm[1] + i * cc, 1, 1);
  ADAPTAQC_RETURN_IF_ERR(launch_products(jobs, nj, 1, c, part, stream));
  stream_combine_kernel<V><<<1, kCombineThreads, 0, stream>>>(
      mm[0], mm[1], out, (int)cc);
  return (int)cudaGetLastError();
}

}  // namespace

// Elements of scratch the streamed chain needs at chi (`work`): the
// environments and products (6 chi^2) and the most partial sums any of its
// launches keeps; 0 outside its reach.
extern "C" long long env_chain_stream_work(int chi, int f64) {
  if (chi < kMinChi || chi > kMaxChi) return 0;
  return plan_work(chi, f64);
}

// The plan of one launch: out[0] the CTA tile's config (kConfigs),
// out[1] the depth slices of a launch of `products` products of depth np
// chi. Returns 0, or an error outside the reach.
extern "C" int env_chain_stream_plan(int chi, int f64, int products, int np,
                                     int* out) {
  if (chi < kMinChi || chi > kMaxChi || products < 1 ||
      products > kMaxJobs || np < 1 || np > 2)
    return (int)cudaErrorInvalidValue;
  out[0] = plan_config(chi, f64);
  out[1] = plan_slices(out[0], chi, products, np);
  return 0;
}

// One step 2 of the forward chain alone, out = sum_p A_p^H M_p (a: a
// site's A_0, A_1; m: M_0, M_1; each (2, chi, chi); out (chi, chi)),
// through the launches the chain makes for it (its slices for one product
// of depth 2 chi, and their reduction), work as for the chain: for timing
// the product against one library call. Returns the first launch error.
extern "C" int env_chain_stream_step2(const void* a, const void* m,
                                      void* out, void* work,
                                      long long work_elems, int chi, int f64,
                                      void* stream) {
  if (chi < kMinChi || chi > kMaxChi || work_elems < plan_work(chi, f64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (f64) {
    Jobs<double2> jobs = {};
    int count = 0;
    step2_job(jobs, count, (const double2*)a, (const double2*)m,
              (double2*)out, chi, true);
    return (int)launch_products(jobs, 1, 2, chi, (double2*)work, st);
  }
  Jobs<float2> jobs = {};
  int count = 0;
  step2_job(jobs, count, (const float2*)a, (const float2*)m, (float2*)out,
            chi, true);
  return (int)launch_products(jobs, 1, 2, chi, (float2*)work, st);
}

// The streamed chain, complex64 (f64 = 0) or complex128: br, bl (n, 2, chi,
// chi), e0 the boundary environment (chi, chi), work
// env_chain_stream_work(chi, f64) elements of scratch (`work_elems`), out
// (2, 2); 128 < chi <= 8192, 0 <= q < n. Launches the products of max(q,
// n-1-q) + 1 steps, their reductions where they split, and the combine on
// `stream`; returns the first launch error.
extern "C" int env_chain_stream_launch(const void* br, const void* bl,
                                       const void* e0, void* work,
                                       long long work_elems, void* out,
                                       int n, int chi, int q, int f64,
                                       void* stream) {
  if (chi < kMinChi || chi > kMaxChi || n < 1 || q < 0 || q >= n ||
      work_elems < plan_work(chi, f64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    return run<double2>((const double2*)br, (const double2*)bl,
                        (const double2*)e0, (double2*)work, (double2*)out, n,
                        chi, q, st);
  return run<float2>((const float2*)br, (const float2*)bl, (const float2*)e0,
                     (float2*)work, (float2*)out, n, chi, q, st);
}
