// K2 conv2d_bn_act: eval-mode act(BN(conv2d(x, w) + b)) as an implicit GEMM.
//
// Replaces satae/kernels/conv.py::conv2d_bn_act_infer, which runs XLA's
// im2col (conv_general_dilated_patches) and then the Pallas GEMM of
// satae/kernels/matmul.py::_mm_kernel. Here no im2col matrix exists: each
// block copies the 3x3 patches of its 64 output pixels straight from the
// NHWC input into its shared-memory stages with cp.async, out-of-image taps
// and rows past M zero-filled. At the serving chunk of 512 images that saves
// conv1's ~150 MB im2col buffer (131,072 x 288 floats) a write and a read.
//
// GEMM view: M = N_img * OH * OW output pixels, K = KH * KW * Cin, N = Cout.
// Column k of the patch matrix is tap (kh, kw) = divmod(k / Cin, KW) and
// channel k % Cin, so the weight is HWIO flattened to (KH * KW * Cin, Cout)
// (satae_torch/kernels/conv.py::pack_conv_weight), staged by gemm_tile.cuh's
// RowMajorB loader. The output is NHWC, which is the (M, N) row-major
// result, written through the shared epilogue with the conv bias folded into
// the shift. It runs gemm_tile.cuh's main loop: cp.async stages, 3xTF32
// mma.sync, float4 stores. No split-K: at every encoder layer of a 512-image
// chunk M >= 8,192 gives >= 128 tiles.
//
// Bound on an H100: conv0 (Cin 3, K = 27) moves 25 MB in and 67 MB out for
// 0.9 GFLOP and is bound by bytes (27.5 us); conv1-3 do 4.8 GFLOP each and
// are bound by operations (29 us at 3xTF32's 165 TFLOP/s). The design: with
// Cin % 4 == 0 (conv1-3) the 4 consecutive channels of one tap are one
// 16-byte copy; conv0 copies 4 bytes at a time. Each input pixel is read
// from L2 up to 9 times (once per tap that covers it), not from device
// memory. The N tile follows Cout: 32 wide for conv0 (Cout 32), so no tile is
// half empty, and its 67 MB output goes out in 16-byte stores.
#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace satae {

// Patch rows gathered from an NHWC image. The block fixes its 64 output
// pixels once, in a shared table (image offset, top-left input row and
// column); each thread keeps one column offset within a stage, so per stage
// it splits one k into (kh, kw, ci) and walks its rows.
struct Im2colA : KMajorLayout<kBM> {
  const float* x;
  const int* img;  // [kBM] offset of the pixel's image, in floats
  const int* ih0;  // [kBM] top-left input row; far negative past M
  const int* iw0;  // [kBM] top-left input column
  int H, W, Cin, KW;
  bool vec;

  __device__ Im2colA(const float* __restrict__ x_, const int* img_,
                     const int* ih0_, const int* iw0_, int H_, int W_,
                     int Cin_, int KW_)
      : x(x_), img(img_), ih0(ih0_), iw0(iw0_), H(H_), W(W_), Cin(Cin_),
        KW(KW_), vec(Cin_ % 4 == 0 && aligned16(x_)) {}

  __device__ __forceinline__ const float* tap(int r, int kh, int kw, int ci,
                                              bool& ok) const {
    const int ih = ih0[r] + kh, iw = iw0[r] + kw;
    ok = ok && static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
         static_cast<unsigned>(iw) < static_cast<unsigned>(W);
    return ok ? x + img[r] + (static_cast<size_t>(ih) * W + iw) * Cin + ci
              : x;
  }

  __device__ __forceinline__ void stage(float* s, int k0, int k_end) const {
    const int tid = threadIdx.x;
    // one column per thread per stage: 4 channels of one tap (Cin % 4 == 0,
    // so a 16-byte copy never straddles two taps), or one channel
    const int width = vec ? 4 : 1;
    const int per_row = kBK / width;
    const int kc = (tid % per_row) * width;
    const int k = k0 + kc;
    const int t = k / Cin;
    const int ci = k - t * Cin;
    const int kh = t / KW;
    const int kw = t - kh * KW;
    if (vec) {
      constexpr int kStep = kThreads / (kBK / 4);
#pragma unroll
      for (int i = 0; i < kBM / kStep; ++i) {
        const int r = tid / (kBK / 4) + kStep * i;
        bool ok = k < k_end;
        const float* src = tap(r, kh, kw, ci, ok);
        cp_async16(s + r * kLd + kc, src, ok);
      }
    } else {
      constexpr int kStep = kThreads / kBK;
#pragma unroll
      for (int i = 0; i < kBM / kStep; ++i) {
        const int r = tid / kBK + kStep * i;
        bool ok = k < k_end;
        const float* src = tap(r, kh, kw, ci, ok);
        cp_async4(s + r * kLd + kc, src, ok);
      }
    }
  }
};

// At least four blocks per SM, as their 55 KB of shared memory allow: the
// bound holds ptxas to <= 128 registers, where its own choice for the 32-wide
// tile spilled 4 bytes.
template <int kBN>
__global__ void __launch_bounds__(kThreads, 4)
    conv2d_bn_act_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ scale,
                         const float* __restrict__ shift,
                         float* __restrict__ out, int batch, int H, int W,
                         int Cin, int KH, int KW, int Cout, int OH, int OW,
                         int stride, int pad, int act) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int img[kBM], ih0[kBM], iw0[kBM];
  const int M = batch * OH * OW;
  const int K = KH * KW * Cin;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    const int m = m0 + r;
    if (m < M) {
      const int ow = m % OW, t = m / OW;
      const int oh = t % OH, n = t / OH;
      img[r] = n * H * W * Cin;
      ih0[r] = oh * stride - pad;
      iw0[r] = ow * stride - pad;
    } else {  // every tap of this row falls outside the image: zero-filled
      img[r] = 0;
      ih0[r] = -(1 << 28);
      iw0[r] = 0;
    }
  }
  __syncthreads();
  const Im2colA a(x, img, ih0, iw0, H, W, Cin, KW);
  const MNMajor<kBN> b(w, Cout, K, n0);
  Frag<kBN> f;
  mainloop<Im2colA, MNMajor<kBN>, kBN>(a, b, smem, 0, K, f);
  stage_acc<kBN>(f, smem);
  store_tile<kBN>(smem, out, M, Cout, m0, n0, scale, shift, act);
}

// Internal linkage: each library keeps its own `allowed` flags (a static
// local of an external template would be one symbol across every library
// loaded in the process).
namespace {

template <int kBN>
int launch(const float* x, const float* w, const float* scale,
           const float* shift, float* out, int batch, int H, int W, int Cin,
           int KH, int KW, int Cout, int OH, int OW, int stride, int pad,
           int act, cudaStream_t stream) {
  constexpr int smem = smem_bytes<Im2colA, MNMajor<kBN>, kBN>();
  auto kernel = conv2d_bn_act_kernel<kBN>;
  static unsigned allowed = 0;
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel), smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = batch * OH * OW;
  const dim3 grid((M + kBM - 1) / kBM, (Cout + kBN - 1) / kBN);
  kernel<<<grid, kThreads, smem, stream>>>(x, w, scale, shift, out, batch, H,
                                           W, Cin, KH, KW, Cout, OH, OW,
                                           stride, pad, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace satae

extern "C" {

// NHWC x, HWIO w flattened to (KH * KW * Cin, Cout), NHWC out; tile_n (32 or
// 64) output channels per tile. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int satae_conv2d_bn_act(const float* x, const float* w, const float* scale,
                        const float* shift, float* out, int batch, int H,
                        int W, int Cin, int KH, int KW, int Cout, int OH,
                        int OW, int stride, int pad, int act, int tile_n,
                        void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (tile_n == 32)
    return satae::launch<32>(x, w, scale, shift, out, batch, H, W, Cin, KH, KW,
                             Cout, OH, OW, stride, pad, act, s);
  if (tile_n == 64)
    return satae::launch<64>(x, w, scale, shift, out, batch, H, W, Cin, KH, KW,
                             Cout, OH, OW, stride, pad, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* satae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
