// One 64x64 output tile of out = act((A @ B) * scale + shift), float32 in,
// float32 accumulate, float32 out, on CUDA cores (no TF32).
//
// A is (M, K) and B is (K, N) as the product sees them. Each reaches the tile
// through a loader that stages one 16-deep K slice into shared memory
// (`stage(k0, smem)`), so one main loop serves every operand layout:
//   A: RowMajorA (row-major (M, K)) and TransA (row-major (K, M)) in
//      fused_gemm.cu, Im2colA (patches gathered from an NHWC image) in
//      conv_bn_act.cu;
//   B: RowMajorB (row-major (K, N)) and TransB (row-major (N, K)) below.
// Each loader lets neighbouring threads read neighbouring addresses of its
// own layout, so a transposed operand is read in place, never copied. Ragged
// edges in M, N and K are masked in the loaders and the store: nothing is
// padded on the host (the TPU kernel's host-side padding to tile multiples,
// satae/kernels/matmul.py:62-69, was a Pallas tiling need, not semantics).
//
// Layout of the work: 256 threads as a 16x16 grid; thread (tx, ty) owns the
// 4x4 outputs at rows ty + 16 i and columns tx + 16 j, so a warp reads 16
// consecutive floats of the B tile and two broadcast words of the A tile per
// step. Both slices are stored k-major: As[k][m] (padded by one word against
// bank conflicts) and Bs[k][n] (padded only for TransB, whose stores run down
// a column): 8.4 KB, no dynamic shared memory needed.
#pragma once

#include <cstddef>

#include "epilogue.cuh"

namespace satae {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;
// A loaders that walk rows: thread tid loads rows (tid / kBK) + 16 e, e < 4,
// at column tid % kBK.
constexpr int kARowStep = kThreads / kBK;  // 16
constexpr int kAPerThread = kBM / kARowStep;  // 4
// Loaders that walk columns: thread tid loads column tid % 64 at rows
// (tid / 64) + 4 e, e < 4.
constexpr int kColStep = kThreads / kBN;  // 4
static_assert(kBK * kBN / kThreads == 4, "four B values per thread per step");
static_assert(kBM == kBN, "the column and row walks share one tile width");

using ATileSmem = float[kBK][kBM + 1];

// Stages an A loader with `fetch(k, v)`, which returns column k of the
// thread's four rows: the row-major and im2col loaders.
template <class RowFetch>
__device__ __forceinline__ void stage_fetched_rows(const RowFetch& a, int k0,
                                                   ATileSmem& As) {
  const int a_k = threadIdx.x % kBK;
  const int a_r = threadIdx.x / kBK;
  float av[kAPerThread];
  a.fetch(k0 + a_k, av);
#pragma unroll
  for (int e = 0; e < kAPerThread; ++e) As[a_k][a_r + kARowStep * e] = av[e];
}

// B as a row-major (K, N) buffer: a warp reads 32 consecutive n of one k.
struct RowMajorB {
  static constexpr int kPad = 0;
  const float* w;
  int N, K, n, k_lane;

  __device__ RowMajorB(const float* __restrict__ w_, int N_, int K_, int n0,
                       int tid)
      : w(w_), N(N_), K(K_), n(n0 + tid % kBN), k_lane(tid / kBN) {}

  __device__ __forceinline__ void stage(int k0,
                                        float (&Bs)[kBK][kBN + kPad]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + k_lane + kColStep * e;
      Bs[k_lane + kColStep * e][threadIdx.x % kBN] =
          (k < K && n < N) ? w[static_cast<size_t>(k) * N + n] : 0.f;
    }
  }
};

// B as a row-major (N, K) buffer read as (K, N) -- an nn.Linear weight
// (out, in) in the forward, or a (K, N) weight in the backward's dX = g W^T.
// A warp reads 16 consecutive k of two rows n.
struct TransB {
  static constexpr int kPad = 1;
  const float* rows[kAPerThread];
  bool valid[kAPerThread];
  int K, k_lane;

  __device__ TransB(const float* __restrict__ w, int N, int K_, int n0,
                    int tid)
      : K(K_), k_lane(tid % kBK) {
#pragma unroll
    for (int e = 0; e < kAPerThread; ++e) {
      const int n = n0 + tid / kBK + kARowStep * e;
      valid[e] = n < N;
      rows[e] = w + static_cast<size_t>(valid[e] ? n : 0) * K;
    }
  }

  __device__ __forceinline__ void stage(int k0,
                                        float (&Bs)[kBK][kBN + kPad]) const {
    const int k = k0 + k_lane;
#pragma unroll
    for (int e = 0; e < kAPerThread; ++e)
      Bs[k_lane][threadIdx.x / kBK + kARowStep * e] =
          (valid[e] && k < K) ? rows[e][k] : 0.f;
  }
};

template <class ATile, class BTile>
__device__ __forceinline__ void gemm_tile(const ATile& a, const BTile& b,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ shift,
                                          float* __restrict__ out, int M,
                                          int N, int K, int act) {
  __shared__ ATileSmem As;
  __shared__ float Bs[kBK][kBN + BTile::kPad];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    a.stage(k0, As);
    b.stage(k0, Bs);
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
