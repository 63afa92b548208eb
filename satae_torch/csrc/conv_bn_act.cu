// K2 conv2d_bn_act: eval-mode act(BN(conv2d(x, w) + b)) as an implicit GEMM.
//
// Replaces satae/kernels/conv.py::conv2d_bn_act_infer, which runs XLA's
// im2col (conv_general_dilated_patches) and then the Pallas GEMM of
// satae/kernels/matmul.py::_mm_kernel. Here no im2col matrix exists: each
// block gathers the 3x3 patches of its 64 output pixels straight from the
// NHWC input while it stages a K slice in shared memory, with zero padding
// handled by predicates. At the serving chunk of 512 images that saves
// conv1's ~150 MB im2col buffer (131,072 x 288 floats) a write and a read.
//
// GEMM view: M = N_img * OH * OW output pixels, K = KH * KW * Cin, N = Cout.
// Column k of the patch matrix is tap (kh, kw) = divmod(k / Cin, KW) and
// channel k % Cin, so the weight is HWIO flattened to (KH * KW * Cin, Cout)
// (satae_torch/kernels/conv.py::pack_conv_weight). The output is NHWC, which
// is the (M, N) row-major result, written through the shared epilogue with
// the conv bias folded into the shift.
//
// Bound on an H100: conv0 (K = 27) moves more bytes than it has operations
// for and is bound by bytes; conv1-3 (K = 288..1152) by float32 operations.
// The kernel reads each input pixel from L2 up to 9 times (once per tap that
// covers it) rather than from device memory, and uses CUDA cores in float32.
#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace satae {

// Patch rows gathered from an NHWC image. Each thread fixes its four output
// pixels once (image base, top-left input coordinate) and per K step only
// splits its column into (kh, kw, ci).
struct Im2colA {
  const float* x;
  size_t base[kAPerThread];
  int ih0[kAPerThread];
  int iw0[kAPerThread];
  bool valid[kAPerThread];
  int H, W, Cin, KW, K;

  __device__ Im2colA(const float* __restrict__ x_, int M, int H_, int W_,
                     int Cin_, int KH, int KW_, int OH, int OW, int stride,
                     int pad, int m0, int tid)
      : x(x_), H(H_), W(W_), Cin(Cin_), KW(KW_), K(KH * KW_ * Cin_) {
#pragma unroll
    for (int e = 0; e < kAPerThread; ++e) {
      const int m = m0 + tid / kBK + kARowStep * e;
      valid[e] = m < M;
      const int mm = valid[e] ? m : 0;
      const int ow = mm % OW;
      const int t = mm / OW;
      const int oh = t % OH;
      const int n = t / OH;
      base[e] = static_cast<size_t>(n) * H * W * Cin;
      ih0[e] = oh * stride - pad;
      iw0[e] = ow * stride - pad;
    }
  }

  __device__ __forceinline__ void fetch(int k, float (&v)[kAPerThread]) const {
    if (k >= K) {
#pragma unroll
      for (int e = 0; e < kAPerThread; ++e) v[e] = 0.f;
      return;
    }
    const int tap = k / Cin;
    const int ci = k - tap * Cin;
    const int kh = tap / KW;
    const int kw = tap - kh * KW;
#pragma unroll
    for (int e = 0; e < kAPerThread; ++e) {
      const int ih = ih0[e] + kh;
      const int iw = iw0[e] + kw;
      const bool ok = valid[e] && ih >= 0 && ih < H && iw >= 0 && iw < W;
      v[e] = ok ? x[base[e] + (static_cast<size_t>(ih) * W + iw) * Cin + ci]
                : 0.f;
    }
  }

  __device__ __forceinline__ void stage(int k0, ATileSmem& As) const {
    stage_fetched_rows(*this, k0, As);
  }
};

__global__ void __launch_bounds__(kThreads)
    conv2d_bn_act_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ scale,
                         const float* __restrict__ shift,
                         float* __restrict__ out, int batch, int H, int W,
                         int Cin, int KH, int KW, int Cout, int OH, int OW,
                         int stride, int pad, int act) {
  const int M = batch * OH * OW;
  const Im2colA a(x, M, H, W, Cin, KH, KW, OH, OW, stride, pad,
                  blockIdx.x * kBM, threadIdx.x);
  const int K = KH * KW * Cin;
  const RowMajorB b(w, Cout, K, blockIdx.y * kBN, threadIdx.x);
  gemm_tile(a, b, scale, shift, out, M, Cout, K, act);
}

}  // namespace satae

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int satae_conv2d_bn_act(const float* x, const float* w, const float* scale,
                        const float* shift, float* out, int batch, int H,
                        int W, int Cin, int KH, int KW, int Cout, int OH,
                        int OW, int stride, int pad, int act, void* stream) {
  const int M = batch * OH * OW;
  const dim3 grid((M + satae::kBM - 1) / satae::kBM,
                  (Cout + satae::kBN - 1) / satae::kBN);
  satae::conv2d_bn_act_kernel<<<grid, satae::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      x, w, scale, shift, out, batch, H, W, Cin, KH, KW, Cout, OH, OW, stride,
      pad, act);
  return static_cast<int>(cudaGetLastError());
}

const char* satae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
