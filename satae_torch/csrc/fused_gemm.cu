// K1 fused_gemm: out = act((x @ w) * scale + shift), float32.
//
// Replaces satae/kernels/matmul.py::_mm_kernel (the one pl.pallas_call of the
// JAX package, matmul.py:71) on the serving path: the encoder projection
// (512 x 4096 @ 4096 x 64) and the three MLP layers (K, N <= 128).
//
// Bound on an H100: at these shapes the product is small. The projection
// moves 9.4 MB and does 0.27 GFLOP, so at the float32 peak it is bound by
// operations (4.0 us against 2.8 us for the bytes); the MLP layers are far
// below launch latency. The kernel keeps the accumulator and the epilogue
// in registers (one pass over x, one write of out) and masks ragged tiles
// instead of padding copies. It uses CUDA cores in float32, not TF32 tensor
// cores, so it agrees with torch.matmul at allow_tf32=False to float32
// rounding. With N <= 64 the projection runs only M/64 = 8 blocks: a split-K
// or wgmma version is later work.
#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace satae {

// Rows of a row-major (M, K) matrix; rows at or past M read as zero.
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
};

__global__ void __launch_bounds__(kThreads)
    fused_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift, float* __restrict__ out,
                      int M, int N, int K, int act) {
  const RowMajorA a(x, M, K, blockIdx.x * kBM, threadIdx.x);
  gemm_tile(a, w, scale, shift, out, M, N, K, act);
}

}  // namespace satae

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int satae_fused_gemm(const float* x, const float* w, const float* scale,
                     const float* shift, float* out, int M, int N, int K,
                     int act, void* stream) {
  const dim3 grid((M + satae::kBM - 1) / satae::kBM,
                  (N + satae::kBN - 1) / satae::kBN);
  satae::fused_gemm_kernel<<<grid, satae::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      x, w, scale, shift, out, M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}

const char* satae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
