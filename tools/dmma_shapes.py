"""The fp64 tensor-core (DMMA) shapes of mma.sync on one Hopper card: each
shape's fragment layout checked against a host product, then its rate.

    python3 tools/dmma_shapes.py

Builds a small CUDA program (the source below) with nvcc for sm_90a into
tools/_build/ and runs it. For m8n8k4 (the shape the wide back-transform
and the streamed env chain use), m16n8k4 and m16n8k16, it prints the worst
difference of one warp's product from the host's, then the TFLOP/s of a
full grid of warps, each issuing the shape on 8 independent accumulators in
a loop (CUDA events).
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "tools", "_build")

SOURCE = r"""
#include <cstdio>
#include <cmath>
#include <cuda_runtime.h>

// shape S: 0 m8n8k4, 1 m16n8k4, 2 m16n8k16. A (M x K) row-major, B (K x 8)
// row-major, C (M x 8) row-major; g = lane / 4, t = lane % 4.
template <int S> struct Shape;
template <> struct Shape<0> { static constexpr int M = 8, K = 4, NA = 1, NB = 1, NC = 2; };
template <> struct Shape<1> { static constexpr int M = 16, K = 4, NA = 2, NB = 1, NC = 4; };
template <> struct Shape<2> { static constexpr int M = 16, K = 16, NA = 8, NB = 4, NC = 4; };

template <int S> __device__ void mma(double* c, const double* a, const double* b);
template <> __device__ void mma<0>(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
}
template <> __device__ void mma<1>(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
template <> __device__ void mma<2>(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
                 "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// the assumed fragment layouts
template <int S> __device__ void a_rc(int i, int g, int t, int& r, int& k) {
  if (S == 0) { r = g; k = t; }
  else if (S == 1) { r = g + 8 * i; k = t; }
  else { r = g + 8 * (i % 2); k = t + 4 * (i / 2); }
}
template <int S> __device__ void b_rc(int i, int g, int t, int& k, int& n) {
  k = t + 4 * i; n = g;
}
template <int S> __device__ void c_rc(int i, int g, int t, int& r, int& n) {
  r = g + 8 * (i / 2); n = 2 * t + (i % 2);
}

template <int S> __global__ void layout(const double* A, const double* B, double* C) {
  using Sh = Shape<S>;
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  double a[Sh::NA], b[Sh::NB], c[Sh::NC];
  for (int i = 0; i < Sh::NA; ++i) { int r, k; a_rc<S>(i, g, t, r, k); a[i] = A[r * Sh::K + k]; }
  for (int i = 0; i < Sh::NB; ++i) { int k, n; b_rc<S>(i, g, t, k, n); b[i] = B[k * 8 + n]; }
  for (int i = 0; i < Sh::NC; ++i) c[i] = 0.0;
  mma<S>(c, a, b);
  for (int i = 0; i < Sh::NC; ++i) { int r, n; c_rc<S>(i, g, t, r, n); C[r * 8 + n] = c[i]; }
}

template <int S> __global__ void rate(double* out, int iters) {
  using Sh = Shape<S>;
  double a[Sh::NA], b[Sh::NB], c[8][Sh::NC];
  for (int i = 0; i < Sh::NA; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < Sh::NB; ++i) b[i] = 1e-3 * (threadIdx.x - i);
  for (int j = 0; j < 8; ++j) for (int i = 0; i < Sh::NC; ++i) c[j][i] = 0.0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma<S>(c[j], a, b);
  double s = 0.0;
  for (int j = 0; j < 8; ++j) for (int i = 0; i < Sh::NC; ++i) s += c[j][i];
  if (s == 12345.678) out[0] = s;
}

template <int S> void run(const char* name) {
  using Sh = Shape<S>;
  double hA[16 * 16], hB[16 * 8], hC[16 * 8];
  for (int i = 0; i < Sh::M * Sh::K; ++i) hA[i] = std::sin(1.0 + i);
  for (int i = 0; i < Sh::K * 8; ++i) hB[i] = std::cos(2.0 + 3 * i);
  double *A, *B, *C, *O;
  cudaMalloc(&A, sizeof hA); cudaMalloc(&B, sizeof hB); cudaMalloc(&C, sizeof hC); cudaMalloc(&O, 8);
  cudaMemcpy(A, hA, sizeof hA, cudaMemcpyHostToDevice);
  cudaMemcpy(B, hB, sizeof hB, cudaMemcpyHostToDevice);
  layout<S><<<1, 32>>>(A, B, C);
  cudaMemcpy(hC, C, sizeof hC, cudaMemcpyDeviceToHost);
  double worst = 0.0;
  for (int r = 0; r < Sh::M; ++r) for (int n = 0; n < 8; ++n) {
    double ref = 0.0;
    for (int k = 0; k < Sh::K; ++k) ref += hA[r * Sh::K + k] * hB[k * 8 + n];
    worst = std::fmax(worst, std::fabs(ref - hC[r * 8 + n]));
  }
  const int iters = 4096, blocks = 132 * 8, threads = 128;
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  rate<S><<<blocks, threads>>>(O, 16);
  cudaEventRecord(e0);
  rate<S><<<blocks, threads>>>(O, iters);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms = 0.f; cudaEventElapsedTime(&ms, e0, e1);
  const double flops = 2.0 * Sh::M * 8 * Sh::K * 8.0 * iters * blocks * (threads / 32);
  printf("dmma_shapes: %s layout worst |C - host| %.3e, %.2f TFLOP/s (%s)\n", name, worst,
         flops / (ms * 1e-3) / 1e12, cudaGetErrorString(cudaGetLastError()));
}

int main() {
  run<0>("m8n8k4");
  run<1>("m16n8k4");
  run<2>("m16n8k16");
  return 0;
}
"""


def main():
    os.makedirs(BUILD, exist_ok=True)
    src = os.path.join(BUILD, "dmma_shapes.cu")
    exe = os.path.join(BUILD, "dmma_shapes")
    with open(src, "w") as f:
        f.write(SOURCE)
    sys.path.insert(0, ROOT)
    from adaptaqc_tpu_torch.ops import cuda_lib
    subprocess.run([cuda_lib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-o", exe, src], check=True)
    subprocess.run([exe], check=True)


if __name__ == "__main__":
    main()
