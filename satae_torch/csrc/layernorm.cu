// LayerNorm over the features of each row, optionally after a residual
// add, bf16 in and out, the statistics in float32:
//   h = x (+ r, rounded to bf16 once and written back to `sum`)
//   y = (h - mean(h)) / sqrt(var(h) + eps) * w + b
// with the biased variance of the row, w and b float32.
//
// Replaces no TPU kernel: the JAX package normalises only over a batch
// (BatchNorm, which folds into K1's and K2's epilogue). It was added for
// the ViT encoder that serving runs (satae_torch/models/vit.py): two
// LayerNorms a block and a final one, 25 a chip at Prithvi-EO-1.0-100M's
// depth 12, and the blocks' residual adds ride inside them (the add before
// a block's second norm, and the one before the next block's first).
//
// Bound on an H100: bytes alone, at 3.35 TB/s. A row of 768 reads x (and
// r) and writes y (and the sum) once: 3 KB, or 6 KB with the residual,
// against 10 operations an element; 589 rows of a chip with the residual
// move 3.6 MB (1.1 us).
//
// The post mode, for the Swin encoder's res-post-norm blocks
// (satae_torch/models/swin.py: x = x + LN(branch)), is a kernel of its own
// so that the pre-norm kernel's code, time and bits stay as they were:
//   sum = sum + (LN(branch) * w + b), the add in float32, rounded once,
// the residual stream `sum` read and written in place. It reads the branch
// and the stream and writes the stream: 3 bytes of bf16 an element.
//
// Design: one warp a row, eight rows a block; each lane holds its row's
// 16-byte vectors lane, lane + 32, ... in registers (N a multiple of 8, up
// to 1,024), so the row is read once: the sum for the mean, then the sum of
// squared deviations from it (two passes over registers, no cancellation),
// each a warp shuffle reduction. Built without --use_fast_math: the square
// root and the division stay correctly rounded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace satae {
namespace vit {

constexpr int kRowsPerBlock = 8;
constexpr int kMaxVecs = 4;  // 16-byte vectors a lane: N <= 32 * 4 * 8

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(p[j]);
    f[2 * j] = v.x;
    f[2 * j + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    p[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return u;
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
    layernorm_kernel(const __nv_bfloat16* x,
                     const __nv_bfloat16* __restrict__ r,
                     const float* __restrict__ w, const float* __restrict__ b,
                     __nv_bfloat16* sum,
                     __nv_bfloat16* __restrict__ y, int M, int N, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= M) return;
  const int vecs = N / 8;
  const size_t off = static_cast<size_t>(row) * N;
  float v[kMaxVecs][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int c = lane + 32 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) v[i][j] = 0.f;
    if (c < vecs) {
      // x may be `sum` itself (the residual stream updated in place): a
      // plain load, each vector read by the lane that then writes it
      unpack8(reinterpret_cast<const uint4*>(x + off)[c], v[i]);
      if (r != nullptr) {
        float e[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(r + off) + c), e);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i][j] += e[j];
        const uint4 h = pack8(v[i]);  // the sum as stored, in bf16
        reinterpret_cast<uint4*>(sum + off)[c] = h;
        unpack8(h, v[i]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[i][j];
    }
  }
  const float mean = warp_sum(s) / N;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    if (lane + 32 * i < vecs) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[i][j] - mean;
        q += d * d;
      }
    }
  }
  const float inv = 1.f / sqrtf(warp_sum(q) / N + eps);
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int c = lane + 32 * i;
    if (c < vecs) {
      const float4* wp = reinterpret_cast<const float4*>(w) + 2 * c;
      const float4* bp = reinterpret_cast<const float4*>(b) + 2 * c;
      const float4 w0 = __ldg(wp), w1 = __ldg(wp + 1);
      const float4 b0 = __ldg(bp), b1 = __ldg(bp + 1);
      const float ws[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[j] = (v[i][j] - mean) * inv * ws[j] + bs[j];
      reinterpret_cast<uint4*>(y + off)[c] = pack8(o);
    }
  }
}

// sum = sum + LN(x) * w + b: x the branch, sum the residual stream.
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    layernorm_post_kernel(const __nv_bfloat16* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ b,
                          __nv_bfloat16* __restrict__ sum, int M, int N,
                          float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= M) return;
  const int vecs = N / 8;
  const size_t off = static_cast<size_t>(row) * N;
  float v[kMaxVecs][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int c = lane + 32 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) v[i][j] = 0.f;
    if (c < vecs) {
      unpack8(__ldg(reinterpret_cast<const uint4*>(x + off) + c), v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[i][j];
    }
  }
  const float mean = warp_sum(s) / N;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    if (lane + 32 * i < vecs) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[i][j] - mean;
        q += d * d;
      }
    }
  }
  const float inv = 1.f / sqrtf(warp_sum(q) / N + eps);
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int c = lane + 32 * i;
    if (c < vecs) {
      const float4* wp = reinterpret_cast<const float4*>(w) + 2 * c;
      const float4* bp = reinterpret_cast<const float4*>(b) + 2 * c;
      const float4 w0 = __ldg(wp), w1 = __ldg(wp + 1);
      const float4 b0 = __ldg(bp), b1 = __ldg(bp + 1);
      const float ws[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      uint4* hp = reinterpret_cast<uint4*>(sum + off) + c;
      float h[8];
      unpack8(*hp, h);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        h[j] += (v[i][j] - mean) * inv * ws[j] + bs[j];
      *hp = pack8(h);
    }
  }
}

}  // namespace vit
}  // namespace satae

extern "C" {

// y (M, N) = LayerNorm(x (+ r)) with w and b (N,) float32; with r (not
// null) the bf16 sum x + r is written to `sum` (which may be x itself). x,
// r, sum and y bf16, contiguous, 16-byte aligned; N a multiple of 8, at
// most 1,024. One launch, ceil(M / 8) blocks of 8 rows.
int satae_layernorm_bf16(const void* x, const void* r, const void* w,
                         const void* b, void* sum, void* y, int M, int N,
                         float eps, void* stream) {
  using namespace satae::vit;
  if (M < 1 || N < 8 || N % 8 != 0 || N > 32 * kMaxVecs * 8 ||
      (r != nullptr && sum == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  layernorm_kernel<<<blocks, 32 * kRowsPerBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(r), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(sum),
      static_cast<__nv_bfloat16*>(y), M, N, eps);
  return static_cast<int>(cudaGetLastError());
}

// sum (M, N) += LayerNorm(x) with w and b (N,) float32: x the branch, sum
// the residual stream, updated in place; the add in float32, rounded once
// to bf16. x and sum bf16, contiguous, 16-byte aligned, not overlapping; N
// a multiple of 8, at most 1,024. One launch, ceil(M / 8) blocks of 8 rows.
int satae_layernorm_post_bf16(const void* x, const void* w, const void* b,
                              void* sum, int M, int N, float eps,
                              void* stream) {
  using namespace satae::vit;
  if (M < 1 || N < 8 || N % 8 != 0 || N > 32 * kMaxVecs * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  layernorm_post_kernel<<<blocks, 32 * kRowsPerBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(sum), M, N,
      eps);
  return static_cast<int>(cudaGetLastError());
}

const char* satae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
