// K1 fused_gemm: out = act((A @ B) * scale + shift), float32.
//
// Replaces satae/kernels/matmul.py::_mm_kernel (the one pl.pallas_call of the
// JAX package, matmul.py:71), in both directions of its custom VJP:
//   forward (`fused_matmul`, `linear_pallas`): the encoder projection
//     (512 x 4096 @ 4096 x 64 when serving, 64 x 4096 when training), the
//     decoder projection, the head and the MLP layers;
//   backward (`_bwd`, matmul.py:100-118): dX = gs @ W^T and dW = X^T @ gs,
//     and the z = X @ W recompute for dscale, each one launch with
//     scale 1, shift 0 and no activation.
// The backward's operands are transposes of tensors that already exist, so
// the launcher takes `trans_a` (A is a row-major (K, M) buffer) and
// `trans_b` (B is a row-major (N, K) buffer) and reads them in place.
//
// Bound on an H100: at these shapes the product is small. The serving
// projection moves 9.4 MB and does 0.27 GFLOP, so at the float32 peak it is
// bound by operations (4.0 us against 2.8 us for the bytes); the batch-64
// training products are below 0.04 GFLOP each and far below launch latency.
// The kernel keeps the accumulator and the epilogue in registers (one pass
// over each operand, one write of out) and masks ragged tiles instead of
// padding copies. It uses CUDA cores in float32, not TF32 tensor cores, so it
// agrees with torch.matmul at allow_tf32=False to float32 rounding. With
// N <= 64 a long-K product runs only M/64 blocks (1 at batch 64): a split-K or
// wgmma version is later work.
#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace satae {

// A as a row-major (M, K) buffer; rows at or past M read as zero.
struct RowMajorA {
  const float* rows[kAPerThread];
  bool valid[kAPerThread];
  int K;

  __device__ RowMajorA(const float* __restrict__ x, int M, int K_, int m0,
                       int tid)
      : K(K_) {
#pragma unroll
    for (int e = 0; e < kAPerThread; ++e) {
      const int m = m0 + tid / kBK + kARowStep * e;
      valid[e] = m < M;
      rows[e] = x + static_cast<size_t>(valid[e] ? m : 0) * K;
    }
  }

  __device__ __forceinline__ void fetch(int k, float (&v)[kAPerThread]) const {
#pragma unroll
    for (int e = 0; e < kAPerThread; ++e)
      v[e] = (valid[e] && k < K) ? rows[e][k] : 0.f;
  }

  __device__ __forceinline__ void stage(int k0, ATileSmem& As) const {
    stage_fetched_rows(*this, k0, As);
  }
};

// A as a row-major (K, M) buffer read as (M, K) -- X^T in dW = X^T @ gs, or
// gs^T in the module-layout dW = gs^T @ X. A warp reads 32 consecutive m of
// one k.
struct TransA {
  const float* x;
  int M, K, m, k_lane;

  __device__ TransA(const float* __restrict__ x_, int M_, int K_, int m0,
                    int tid)
      : x(x_), M(M_), K(K_), m(m0 + tid % kBM), k_lane(tid / kBM) {}

  __device__ __forceinline__ void stage(int k0, ATileSmem& As) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + k_lane + kColStep * e;
      As[k_lane + kColStep * e][threadIdx.x % kBM] =
          (k < K && m < M) ? x[static_cast<size_t>(k) * M + m] : 0.f;
    }
  }
};

template <class ATile, class BTile>
__global__ void __launch_bounds__(kThreads)
    fused_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift, float* __restrict__ out,
                      int M, int N, int K, int act) {
  const ATile a(x, M, K, blockIdx.x * kBM, threadIdx.x);
  const BTile b(w, N, K, blockIdx.y * kBN, threadIdx.x);
  gemm_tile(a, b, scale, shift, out, M, N, K, act);
}

template <class ATile, class BTile>
int launch(const float* x, const float* w, const float* scale,
           const float* shift, float* out, int M, int N, int K, int act,
           void* stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  fused_gemm_kernel<ATile, BTile>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          x, w, scale, shift, out, M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace satae

extern "C" {

// out (M, N) = act((x @ w) * scale + shift), x row-major (M, K), w row-major
// (K, N): the serving entry. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int satae_fused_gemm(const float* x, const float* w, const float* scale,
                     const float* shift, float* out, int M, int N, int K,
                     int act, void* stream) {
  return satae::launch<satae::RowMajorA, satae::RowMajorB>(
      x, w, scale, shift, out, M, N, K, act, stream);
}

// The same product with either operand read transposed in place: with
// trans_a, x is a row-major (K, M) buffer; with trans_b, w is a row-major
// (N, K) buffer. Same return as satae_fused_gemm.
int satae_fused_gemm_t(const float* x, const float* w, const float* scale,
                       const float* shift, float* out, int M, int N, int K,
                       int act, int trans_a, int trans_b, void* stream) {
  using satae::RowMajorA;
  using satae::RowMajorB;
  using satae::TransA;
  using satae::TransB;
  if (trans_a) {
    return trans_b ? satae::launch<TransA, TransB>(x, w, scale, shift, out, M,
                                                   N, K, act, stream)
                   : satae::launch<TransA, RowMajorB>(x, w, scale, shift, out,
                                                      M, N, K, act, stream);
  }
  return trans_b ? satae::launch<RowMajorA, TransB>(x, w, scale, shift, out, M,
                                                    N, K, act, stream)
                 : satae::launch<RowMajorA, RowMajorB>(x, w, scale, shift, out,
                                                       M, N, K, act, stream);
}

const char* satae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
