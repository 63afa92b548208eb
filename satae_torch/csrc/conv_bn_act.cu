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
//
// bf16 (x, w and out bf16; scale, shift and the sums float32): the same
// loops on bf16 stages and m16n8k16 bf16 mma. At 989 TFLOP/s conv0 (12.6 MB
// in, 33.6 MB out: 13.8 us), conv1 (50 MB: 15.0 us) and conv2 (7.5 us) are
// bound by bytes, conv3 by operations (4.8 GFLOP: 4.9 us, against 3.8 us of
// bytes). With Cin % 8 == 0 (conv1-3) the
// 8 channels of one tap are one 16-byte copy; an even Cin takes 4-byte
// copies. conv0's tap is 3 channels, 6 bytes: no tap is 4- or 16-byte
// aligned, so it takes the 2-byte path of gemm_tile.cuh, one ld.global.u16 +
// st.shared per element. Its K = 27 is one slice, so no stage overlaps
// another's loads there anyway.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace satae {

// Patch rows gathered from an NHWC image. The block fixes its 64 output
// pixels once, in a shared table (image offset, top-left input row and
// column); each thread keeps one column offset within a stage, so per stage
// it splits one k into (kh, kw, ci) and walks its rows.
template <class T>
struct Im2colA : KMajorLayout<T, kBM> {
  using KMajorLayout<T, kBM>::kLd;
  const T* x;
  const int* img;  // [kBM] offset of the pixel's image, in elements
  const int* ih0;  // [kBM] top-left input row; far negative past M
  const int* iw0;  // [kBM] top-left input column
  int H, W, Cin, KW, bytes;

  __device__ Im2colA(const T* __restrict__ x_, const int* img_,
                     const int* ih0_, const int* iw0_, int H_, int W_,
                     int Cin_, int KW_)
      : x(x_), img(img_), ih0(ih0_), iw0(iw0_), H(H_), W(W_), Cin(Cin_),
        KW(KW_), bytes(copy_bytes<T>(Cin_, x_)) {}

  __device__ __forceinline__ const T* tap(int r, int kh, int kw, int ci,
                                          bool& ok) const {
    const int ih = ih0[r] + kh, iw = iw0[r] + kw;
    ok = ok && static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
         static_cast<unsigned>(iw) < static_cast<unsigned>(W);
    return ok ? x + img[r] + (static_cast<size_t>(ih) * W + iw) * Cin + ci
              : x;
  }

  // one column per thread per stage: kBytes of consecutive channels of one
  // tap (Cin is a multiple of their count, so a copy never straddles two
  // taps)
  template <int kBytes>
  __device__ __forceinline__ void stage_w(T* s, int k0, int k_end) const {
    constexpr int kW = kBytes / static_cast<int>(sizeof(T));
    constexpr int kPerRow = kBK / kW;
    constexpr int kStep = kThreads / kPerRow;
    static_assert(kBM % kStep == 0, "the threads cover the tile's rows");
    const int kc = (threadIdx.x % kPerRow) * kW;
    const int k = k0 + kc;
    const int t = k / Cin;
    const int ci = k - t * Cin;
    const int kh = t / KW;
    const int kw = t - kh * KW;
#pragma unroll
    for (int i = 0; i < kBM / kStep; ++i) {
      const int r = threadIdx.x / kPerRow + kStep * i;
      bool ok = k < k_end;
      const T* src = tap(r, kh, kw, ci, ok);
      copy<kBytes>(s + r * kLd + kc, src, ok);
    }
  }

  __device__ __forceinline__ void stage(T* s, int k0, int k_end) const {
    if (bytes == 16) {
      stage_w<16>(s, k0, k_end);
    } else if (kIsF32<T> || bytes == 4) {
      stage_w<4>(s, k0, k_end);
    } else if constexpr (!kIsF32<T>) {
      stage_w<2>(s, k0, k_end);
    }
  }
};

// At least four blocks per SM, as their 55 KB of shared memory allow: the
// bound holds ptxas to <= 128 registers, where its own choice for the 32-wide
// float32 tile spilled 4 bytes.
template <class T, int kBN>
__global__ void __launch_bounds__(kThreads, 4)
    conv2d_bn_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const float* __restrict__ scale,
                         const float* __restrict__ shift, T* __restrict__ out,
                         int batch, int H, int W, int Cin, int KH, int KW,
                         int Cout, int OH, int OW, int stride, int pad,
                         int act) {
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
  const Im2colA<T> a(x, img, ih0, iw0, H, W, Cin, KW);
  const MNMajor<T, kBN> b(w, Cout, K, n0);
  Frag<kBN> f;
  mainloop<Im2colA<T>, MNMajor<T, kBN>, kBN>(a, b, reinterpret_cast<T*>(smem4),
                                             0, K, f);
  stage_acc<kBN>(f, smem);
  store_tile<kBN>(smem, out, M, Cout, m0, n0, scale, shift, act);
}

// Internal linkage: each library keeps its own `allowed` flags (a static
// local of an external template would be one symbol across every library
// loaded in the process).
namespace {

template <class T, int kBN>
int launch(const void* x, const void* w, const float* scale,
           const float* shift, void* out, int batch, int H, int W, int Cin,
           int KH, int KW, int Cout, int OH, int OW, int stride, int pad,
           int act, cudaStream_t stream) {
  constexpr int smem = smem_bytes<Im2colA<T>, MNMajor<T, kBN>, kBN>();
  auto kernel = conv2d_bn_act_kernel<T, kBN>;
  static unsigned allowed = 0;
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel), smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = batch * OH * OW;
  const dim3 grid((M + kBM - 1) / kBM, (Cout + kBN - 1) / kBN);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, shift,
      static_cast<T*>(out), batch, H, W, Cin, KH, KW, Cout, OH, OW, stride,
      pad, act);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_tile(const void* x, const void* w, const float* scale,
                const float* shift, void* out, int batch, int H, int W,
                int Cin, int KH, int KW, int Cout, int OH, int OW, int stride,
                int pad, int act, int tile_n, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (tile_n == 32)
    return launch<T, 32>(x, w, scale, shift, out, batch, H, W, Cin, KH, KW,
                         Cout, OH, OW, stride, pad, act, s);
  if (tile_n == 64)
    return launch<T, 64>(x, w, scale, shift, out, batch, H, W, Cin, KH, KW,
                         Cout, OH, OW, stride, pad, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

}  // namespace satae

extern "C" {

// NHWC x, HWIO w flattened to (KH * KW * Cin, Cout), NHWC out, all float32;
// tile_n (32 or 64) output channels per tile. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int satae_conv2d_bn_act(const float* x, const float* w, const float* scale,
                        const float* shift, float* out, int batch, int H,
                        int W, int Cin, int KH, int KW, int Cout, int OH,
                        int OW, int stride, int pad, int act, int tile_n,
                        void* stream) {
  return satae::launch_tile<float>(x, w, scale, shift, out, batch, H, W, Cin,
                                   KH, KW, Cout, OH, OW, stride, pad, act,
                                   tile_n, stream);
}

// satae_conv2d_bn_act with bf16 x, w and out; scale and shift float32, out
// rounded once (to nearest even) after the float32 epilogue.
int satae_conv2d_bn_act_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                             const float* scale, const float* shift,
                             __nv_bfloat16* out, int batch, int H, int W,
                             int Cin, int KH, int KW, int Cout, int OH,
                             int OW, int stride, int pad, int act, int tile_n,
                             void* stream) {
  return satae::launch_tile<__nv_bfloat16>(x, w, scale, shift, out, batch, H,
                                           W, Cin, KH, KW, Cout, OH, OW,
                                           stride, pad, act, tile_n, stream);
}

const char* satae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
