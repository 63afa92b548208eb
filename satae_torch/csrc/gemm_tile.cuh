// One 64x64 output tile of out = act((A @ W) * scale + shift), float32 in,
// float32 accumulate, float32 out, on CUDA cores (no TF32).
//
// A is (M, K) and reaches the tile through a loader (`ATile`), so the same
// main loop serves the plain GEMM (RowMajorA in fused_gemm.cu) and the
// implicit-GEMM convolution (Im2colA in conv_bn_act.cu), which gathers its
// rows from an NHWC image instead of reading a materialised im2col matrix.
// W is row-major (K, N). Ragged edges in M, N and K are masked here: nothing
// is padded on the host (the TPU kernel's host-side padding to tile multiples,
// satae/kernels/matmul.py:62-69, was a Pallas tiling need, not semantics).
//
// Layout of the work: 256 threads as a 16x16 grid; thread (tx, ty) owns the
// 4x4 outputs at rows ty + 16 i and columns tx + 16 j, so a warp reads 16
// consecutive floats of the B tile and two broadcast words of the A tile per
// step. Each K step of 16 stages a 16x64 slice of A (stored k-major, padded
// by one word against bank conflicts) and a 16x64 slice of W in shared
// memory: 8.4 KB, no dynamic shared memory needed.
#pragma once

#include <cstddef>

#include "epilogue.cuh"

namespace satae {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;
// Each thread loads A rows (tid / kBK) + 16 e, e < 4, at column tid % kBK.
constexpr int kARowStep = kThreads / kBK;  // 16
constexpr int kAPerThread = kBM / kARowStep;  // 4
static_assert(kBK * kBN / kThreads == 4, "four W values per thread per step");

template <class ATile>
__device__ __forceinline__ void gemm_tile(const ATile& a,
                                          const float* __restrict__ w,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ shift,
                                          float* __restrict__ out, int M,
                                          int N, int K, int act) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int a_k = tid % kBK;
  const int a_r = tid / kBK;
  const int b_n = tid % kBN;
  const int b_k = tid / kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    float av[kAPerThread];
    a.fetch(k0 + a_k, av);
#pragma unroll
    for (int e = 0; e < kAPerThread; ++e) As[a_k][a_r + kARowStep * e] = av[e];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + b_k + 4 * e;
      const int n = n0 + b_n;
      Bs[b_k + 4 * e][b_n] =
          (k < K && n < N) ? w[static_cast<size_t>(k) * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ar[4], br[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) br[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) {
        out[static_cast<size_t>(row) * N + col] =
            epilogue(acc[i][j], scale[col], shift[col], act);
      }
    }
  }
}

}  // namespace satae
