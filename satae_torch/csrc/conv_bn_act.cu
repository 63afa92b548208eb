// K2 conv2d_bn_act: eval-mode act(BN(conv2d(x, w) + b)) as an implicit GEMM.
//
// Replaces satae/kernels/conv.py:36 (conv2d_bn_act_infer), which runs XLA's
// im2col (conv_general_dilated_patches) and then the Pallas GEMM of
// satae/kernels/matmul.py::_mm_kernel. Here no im2col matrix exists: each
// block copies the 3x3 patches of its 64 output pixels straight from the
// NHWC input into its shared-memory stages with cp.async, out-of-image taps
// and rows past M zero-filled. At the serving chunk of 512 images that saves
// conv1's ~150 MB im2col buffer (131,072 x 288 floats) a write and a read.
//
// GEMM view: M = N_img * OH * OW output pixels, K = KH * KW * Cin, N = Cout.
// Column k of the patch matrix is tap (kh, kw) = divmod(k / Cin, KW) and
// channel k % Cin. The weight's layout follows the dtype
// (satae_torch/kernels/conv.py::pack_conv_weight): bf16 HWIO flattened to
// (KH * KW * Cin, Cout), staged by gemm_tile.cuh's MNMajor loader; float32
// the K-major (Cout, KH * KW * Cin) buffer, staged by its KMajor loader
// (the TF32 wgmma kernels below take only K-major operands, and every
// float32 kernel here reads the one layout).
// The output is NHWC, which is the (M, N) row-major result, written through
// the shared epilogue with the conv bias folded into the shift. It runs
// gemm_tile.cuh's main loop: cp.async stages, 3xTF32 mma.sync, float4
// stores. No split-K: at every encoder layer of a 512-image chunk M >=
// 8,192 gives >= 128 tiles.
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
// bf16 (x, w and out bf16; scale, shift and the sums float32). At 3.35
// TB/s and 989 TFLOP/s conv0 (12.6 MB in, 33.6 MB out: 13.8 us), conv1
// (50 MB: 15.0 us) and conv2 (7.6 us) are bound by bytes, conv3 by
// operations (4.8 GFLOP: 4.9 us, against 3.8 us of bytes). Two kernels on
// wgmma (entry satae_conv2d_bn_act_bf16_tma; the wrapper's
// satae_torch/kernels/conv.py::conv_route picks one):
//   conv_rows_kernel (conv0: K = 27, 6-byte taps): the block stages the
//     input rows its 128 output pixels read, whole and contiguous, with
//     16-byte cp.async, builds the patch tile in shared memory from them
//     and writes its 33.6 MB output -- the bound -- in 16-byte stores;
//   conv_im2col_tma_kernel (conv1-3): persistent 128 x 64 / 128 x 128
//     tiles, the patches brought by TMA in im2col mode (one load of 128
//     pixels x 64 or 32 channels of a tap: the hardware walks the stride-2
//     windows and zero-fills the padding), the HWIO weight by TMA read
//     MN-major, two consumer warpgroups on wgmma while the ring runs on
//     across tiles.
// float32 (3xTF32; entry satae_conv2d_bn_act_tma, the weight K-major: a
// (Cout, KH, KW, Cin) buffer) on the same two kernels: conv0 on
// conv_rows_kernel, each thread gathering its wgmma A fragments from the
// staged rows and splitting them in registers, m64n32k8 TF32 wgmmas;
// conv1-3 on conv_im2col_tma_kernel with 128 x 64 tiles and stages of 32
// channels, the weight's TF32 halves (split once per weight set, when the
// serving fold packs it: satae_torch/kernels/conv.py::split_tf32) both
// brought by TMA, A split in registers.
// Bound (above): conv0 by bytes (27.5 us), conv1-3 by operations (29 us).
// Stayed on the mma.sync loop above: layers none of these take, float32
// and bf16 -- channel counts TMA's im2col cannot cut into whole stages
// (bf16 Cin 5, 6, 8, 16 and Cin 32 with Cout > 64; float32 Cin not a
// multiple of 32), Cout not a multiple of 8, misaligned buffers: the 2-,
// 4- and 16-byte copies of gemm_tile.cuh.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_tile.cuh"
#include "wgmma_tile.cuh"

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

// The weight's loader: the K-major (Cout, K) buffer in float32, HWIO's
// (K, Cout) in bf16.
template <class T, int kBN>
using ConvB = std::conditional_t<kIsF32<T>, KMajor<T, kBN>, MNMajor<T, kBN>>;

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
  const ConvB<T, kBN> b(w, Cout, K, n0);
  Frag<kBN> f;
  mainloop<Im2colA<T>, ConvB<T, kBN>, kBN>(a, b, reinterpret_cast<T*>(smem4),
                                           0, K, f);
  stage_acc<kBN>(f, smem);
  store_tile<kBN>(smem, out, M, Cout, m0, n0, scale, shift, act);
}


// ---- on wgmma: bf16, and float32 as 3xTF32 ---------------------------------

namespace hopper {

// The im2col kernel's shared memory: a ring of stages, as many as fit
// beside the float32 epilogue tile. bf16: stages of 64 of K (A 16 KB + B
// kBN * 128 bytes). float32 (kBN 64 only: the 128-wide stage would leave
// a ring of two): stages of 32 of K, A 128 pixels x 32 floats (16 KB) and
// B's TF32 big and small halves, 64 x 32 floats each (16 KB): 5 x 32 + 36
// + 1 = 197 KB.
template <class T, int kBN>
__host__ __device__ constexpr int conv_ring() {
  return kIsF32<T> ? 5 : kBN == 64 ? 6 : 4;
}
template <class T, int kBN>
__host__ __device__ constexpr int conv_stage() {
  return 2 * kBox + (kIsF32<T> ? 2 * kBox : kBN * 128);
}
template <class T, int kBN>
__host__ __device__ constexpr int conv_smem() {
  return conv_ring<T, kBN>() * conv_stage<T, kBN>() +
         128 * (kBN + kOutPad) * 4 + 1024;
}
// Channels per im2col load: bf16, a 64-wide N tile takes two loads of 32
// (64-byte rows, 64-byte swizzle) per stage, a 128-wide one a load of 64
// (128-byte rows and swizzle); float32 one load of 32 (128-byte rows).
template <class T, int kBN>
__host__ __device__ constexpr int conv_channels() {
  return kIsF32<T> || kBN == 64 ? 32 : 64;
}

// conv1-3: 128 x kBN tiles of the implicit GEMM, one persistent block per
// SM walking tiles blockIdx.x, + gridDim.x, ... Threads 0-255 are two
// consumer warpgroups (rows 0-63 and 64-127 of a tile); thread 256, in a
// warp of its own, issues the TMA loads. Per stage: the patches of the
// tile's 128 output pixels by TMA in im2col mode -- the hardware walks the
// stride-2 windows across rows and images and zero-fills the padding --
// and the stage's weight box(es) by TMA. bf16: 64 of K a stage, as one
// load of 64 channels of one tap or two of 32, each into its region of the
// swizzled K-major layout; the HWIO weight, a row-major (K, Cout) buffer
// that wgmma reads MN-major; wgmma m64n{kBN}k16. float32: 32 of K a stage,
// one load of 32 channels of one tap (Cin a multiple of 32); the weight's
// TF32 big and small halves, two K-major (Cout, K) buffers split once per
// weight set (satae_torch/kernels/conv.py::split_tf32: every tile of every
// launch multiplies the same weight, so a split per stage repeated one
// split thousands of times, and one per launch cost a second kernel each
// call), one box of 64 x 32 floats of each per stage (map_w big, map_ws
// small), landing in the K-major swizzled layout wgmma reads;
// consume_tf32_presplit per
// warpgroup: its A fragments split in registers, then 12 TF32 wgmmas on
// the stage as TMA left it -- no shared-memory writes and no barrier
// between the warpgroups, so one's wgmmas run while the other splits. The
// ring
// runs on across tiles, so the producer loads the next tile while the
// consumers run the epilogue (through their own float32 tile, not the
// ring) and the block never drains between tiles. A gather by 128 threads
// with 16-byte cp.async into the same layout was slower at conv1-3 in bf16
// on an H100: its instructions, not the L2 or the ring's depth, set its
// rate.
template <class T, int kBN>
__global__ void __launch_bounds__(2 * kWg + 32, 1)
    conv_im2col_tma_kernel(const __grid_constant__ CUtensorMap map_w,
                           const __grid_constant__ CUtensorMap map_ws,
                           const __grid_constant__ CUtensorMap map_x,
                           const float* __restrict__ scale,
                           const float* __restrict__ shift,
                           T* __restrict__ out, int batch, int Cin,
                           int KH, int KW, int Cout, int OH, int OW,
                           int stride, int pad, int act) {
  constexpr bool kF32 = kIsF32<T>;
  constexpr int kRing = conv_ring<T, kBN>();
  constexpr int kCh = conv_channels<T, kBN>();
  constexpr int kA = 2 * kBox;  // A of a stage: 128 x 128 bytes
  constexpr int kStage = conv_stage<T, kBN>();
  constexpr int kDepth = kF32 ? kStageK32 : kStageK;
  constexpr int kLd = kBN + kOutPad;
  static_assert(!kF32 || kBN == 64, "float32 takes 64-wide N tiles");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kRing], empty[kRing];
  uint8_t* smem = align1024(smem_raw);
  float* cs = reinterpret_cast<float*>(smem + kRing * kStage);
  const int M = batch * OH * OW;
  const int K = KH * KW * Cin;
  const int m_tiles = (M + 127) / 128;
  const int tiles = m_tiles * ((Cout + kBN - 1) / kBN);
  const int n_slices = (K + kBK - 1) / kBK;
  const int n_stages = kF32 ? n_slices : (n_slices + 1) / 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 2 * kWg / 32);
    }
    bar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / kWg;
  if (threadIdx.x == 2 * kWg) {
    int g = 0;  // stages filled so far
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile % m_tiles * 128, n0 = tile / m_tiles * kBN;
      const int n = m0 / (OH * OW), oh = m0 % (OH * OW) / OW, ow = m0 % OW;
      for (int it = 0; it < n_stages; ++it, ++g) {
        const int s = g % kRing;
        if (g >= kRing) bar_wait(&empty[s], (g / kRing - 1) & 1);
        uint8_t* st = smem + s * kStage;
        const int k0 = it * kDepth;
        // the loads of A inside K (a bf16 32-channel stage may end after
        // one)
        const int loads = kF32 || kCh == 64 || k0 + 32 >= K ? 1 : 2;
        const int a_bytes = loads * 128 * kCh * static_cast<int>(sizeof(T));
        bar_expect(&full[s], a_bytes + (kStage - kA));
        for (int h = 0; h < loads; ++h) {
          const int k = k0 + kCh * h, t = k / Cin;
          tma_load_im2col(st + h * kBox, &map_x, &full[s], k - t * Cin,
                          ow * stride - pad, oh * stride - pad, n,
                          static_cast<uint16_t>(t % KW),
                          static_cast<uint16_t>(t / KW));
        }
        if constexpr (kF32) {
          tma_load(st + kA, &map_w, &full[s], k0, n0);
          tma_load(st + kA + kBox, &map_ws, &full[s], k0, n0);
        } else {
#pragma unroll
          for (int b = 0; b < kBN / 64; ++b)
            tma_load(st + kA + b * kBox, &map_w, &full[s], n0 + 64 * b, k0);
        }
      }
    }
  } else if (wg < 2) {
    float acc[kBN / 2];
    int g = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile % m_tiles * 128, n0 = tile / m_tiles * kBN;
      const Cols<8> cols =
          store_cols_of<kBN>(scale, shift, n0, Cout, threadIdx.x);
      if constexpr (kF32) {
        const auto raw = [smem](int s, const uint8_t*& ra,
                                const uint8_t*& rb) {
          ra = smem + s * kStage;
          rb = ra + kA;
        };
        consume_tf32_presplit(acc, raw, 64 * wg, full, empty, kRing,
                              n_stages, g);
      } else {
        // A: 64-channel loads are 128-byte rows, the warpgroups' halves 8
        // KB apart; 32-channel ones two tap regions of 64-byte rows, the
        // halves 4 KB apart in each
        const auto desc = [smem, wg](int s, int j, uint64_t& da,
                                     uint64_t& db) {
          const uint8_t* st = smem + s * kStage;
          da = kCh == 32
                   ? desc64(st + (j / 2) * kBox + wg * 4096 + 32 * (j % 2))
                   : desc_k<false>(st + wg * kBox, j);
          db = desc_k<true>(st + kA, j);
        };
        consume<kBN, 0, 1, kBN == 64>(acc, desc, full, empty, kRing,
                                      n_slices, g);
      }
      g += n_stages;
      // the previous tile's stores have read cs
      asm volatile("bar.sync 1, %0;\n" ::"n"(2 * kWg) : "memory");
      stage_wg_acc<kBN>(acc, cs, kLd, 64 * wg);
      asm volatile("bar.sync 1, %0;\n" ::"n"(2 * kWg) : "memory");
      store_rows<kBN>(cs, kLd, 128, out, M, Cout, m0, n0, cols, act,
                      threadIdx.x, 2 * kWg);
    }
  }
}

// conv0-like layers (K = KH * KW * Cin <= 32, Cout <= 32, Cout % 8 == 0):
// a tile of 128 output pixels that are whole output rows of one image.
// The block copies the input rows those pixels read, halo included (conv0:
// 9 rows of 64 x 3 values, 384 bytes each in bf16, 768 in float32,
// contiguous), with 16-byte cp.async into shared memory. One warpgroup,
// one 32-deep slice (K zero-padded to 32) per 64-row half.
// bf16: it builds the 128 x 32 patch tile from the rows in the 128-byte-
// swizzled K-major layout, and the HWIO weight as a K-major 32 x 32 tile;
// two m64n32k16 wgmmas per half.
// float32: no patch tile: per 64-row half, each thread gathers its wgmma A
// fragments (rows 16 w + g (+ 8), k q (+ 4) of each k8 step: 16 values)
// from the rows and splits them in registers, then 4 k8 steps of three
// m64n32k8 TF32 wgmmas (small*big, big*small, big*big), the first with
// scale-d 0; the K-major (Cout, K) weight is split once per block into
// K-major 32 x 32 big and small tiles. Both: the output in 16-byte
// stores.
// float32 asks for five blocks an SM (its ~36 KB of shared memory allow
// six): more warps to hide the gathers' and the stores' latency.
template <class T>
__global__ void __launch_bounds__(kWg, kIsF32<T> ? 5 : 1)
    conv_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, T* __restrict__ out,
                     int H, int W, int Cin, int KH, int KW, int Cout, int OH,
                     int OW, int stride, int pad, int act) {
  constexpr int kLd = 32 + kOutPad;
  constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  // bf16: as [128][64 bf16] 16 KB, bs [32][64 bf16] 4 KB, the rows; the
  // staging tile cs over as after the mma. float32: bs big and small
  // [32][32 floats] 4 KB each, the rows, then cs.
  constexpr int kB = kIsF32<T> ? 2 * 4096 : 2 * kBox + 4096;
  uint8_t* as = smem;
  uint8_t* bs = kIsF32<T> ? smem : smem + 2 * kBox;
  T* rows = reinterpret_cast<T*>(smem + kB);
  const int K = KH * KW * Cin;
  const int m0 = blockIdx.x * 128;
  const int n = m0 / (OH * OW), oh0 = m0 % (OH * OW) / OW;
  const int n_in = (128 / OW - 1) * stride + KH;
  const int ih_first = oh0 * stride - pad;
  const int row_elems = W * Cin, row_chunks = row_elems / kPer16;
  float* cs = reinterpret_cast<float*>(
      kIsF32<T> ? smem + kB + n_in * row_elems * 4 : smem);  // [128][kLd]
  // the input rows, rows outside the image not copied (never read)
  for (int i = threadIdx.x; i < n_in * row_chunks; i += kWg) {
    const int rr = i / row_chunks, cc = i - rr * row_chunks;
    const int ih = ih_first + rr;
    if (static_cast<unsigned>(ih) < static_cast<unsigned>(H))
      cp_async16(rows + rr * row_elems + cc * kPer16,
                 x + (static_cast<size_t>(n) * H + ih) * row_elems +
                     cc * kPer16,
                 true);
  }
  cp_async_commit();
  const Cols<8> cols = store_cols_of<32>(scale, shift, 0, Cout, threadIdx.x);
  // k -> (kh, kw, ci); kh -1 past K
  __shared__ int tap_kh[32], tap_kw[32], tap_ci[32];
  if (threadIdx.x < 32) {
    const int k = threadIdx.x, t = k / Cin;
    tap_kh[k] = k < K ? t / KW : -1;
    tap_kw[k] = t % KW;
    tap_ci[k] = k % Cin;
  }
  // patch value k of the pixel whose kh = 0 input row is rows' row_base
  // and whose kw = 0 input column is col0 (0 outside the image or past K)
  const auto patch = [&](int row_base, int col0, int k) -> T {
    const int kh = tap_kh[k];
    const int ih = ih_first + row_base + kh, iw = col0 + tap_kw[k];
    return kh >= 0 && static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
                   static_cast<unsigned>(iw) < static_cast<unsigned>(W)
               ? rows[(row_base + kh) * row_elems + iw * Cin + tap_ci[k]]
               : T(0.f);
  };
  if constexpr (kIsF32<T>) {
    // the weight, (Cout, K) K-major, split into K-major rows n of 32 k
    // (zeros past K and Cout): chunk c of row n at chunk c ^ (n % 8)
    for (int i = threadIdx.x; i < 32 * 8; i += kWg) {
      const int nn = i / 8, c = i % 8;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * c + e;
        v[e] = k < K && nn < Cout ? w[static_cast<size_t>(nn) * K + k] : 0.f;
      }
      split_store(bs, bs + 4096, nn * 128 + ((c ^ (nn & 7)) << 4), v);
    }
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    const int t = threadIdx.x;
    const int r = 16 * (t / 32) + (t % 32) / 4, q = t % 4;
    // one 64-row half at a time: one fragment set and one accumulator of
    // 16 live, so ptxas fits the kernel in fewer registers and more blocks
    // share an SM
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      uint32_t big[4][4], small[4][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {  // the fragment's rows r and r + 8
        const int p = 64 * h + r + 8 * u, oh_rel = p / OW;
        const int row_base = oh_rel * stride;
        const int col0 = (p - oh_rel * OW) * stride - pad;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = u; e < 4; e += 2)
            split_tf32(patch(row_base, col0, 8 * j + q + 4 * (e / 2)),
                       big[j][e], small[j][e]);
      }
      float acc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.f;
      fence_frag(big);
      fence_frag(small);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t db = desc128(bs + 32 * j, 16, 1024);
        const uint64_t ds = desc128(bs + 4096 + 32 * j, 16, 1024);
        mma_k8<32>(acc, small[j], db, j > 0);
        mma_k8<32>(acc, big[j], ds, 1);
        mma_k8<32>(acc, big[j], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      stage_wg_acc<32>(acc, cs, kLd, 64 * h);
    }
  } else {
    // the weight, (K, Cout) row-major, as K-major rows n of 64 k (zeros
    // past K and Cout); only k < 32 is multiplied
    for (int i = threadIdx.x; i < 32 * 4; i += kWg) {
      const int nn = i / 4, c = i % 4;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        unsigned short h[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int k = 8 * c + 2 * e + u;
          h[u] = k < K && nn < Cout
                     ? __bfloat16_as_ushort(
                           w[static_cast<size_t>(k) * Cout + nn])
                     : 0;
        }
        v[e] = h[0] | static_cast<uint32_t>(h[1]) << 16;
      }
      *reinterpret_cast<uint4*>(bs + nn * 128 + ((c ^ (nn & 7)) << 4)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    cp_async_wait<0>();
    __syncthreads();
    // the patches: row p is pixel m0 + p, chunk c holds k = 8c..8c+7; tap
    // (kh, kw) and channel ci of each k come from a table (no division per
    // element)
    const int p = threadIdx.x;
    const int oh_rel = p / OW, ow = p - oh_rel * OW;
    const int row_base = oh_rel * stride;  // input row of kh = 0, in rows
    const int col0 = ow * stride - pad;    // input column of kw = 0
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bf16 lo = patch(row_base, col0, 8 * c + 2 * e);
        const bf16 hi = patch(row_base, col0, 8 * c + 2 * e + 1);
        v[e] = __bfloat16_as_ushort(lo) |
               static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
      }
      *reinterpret_cast<uint4*>(as + p * 128 + ((c ^ (p & 7)) << 4)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    fence_async_smem();
    __syncthreads();
    float acc[2][16];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[h][i] = 0.f;
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wgmma_n32<0, 0>(acc[h], desc_k<false>(as + h * kBox, j),
                        desc_k<false>(bs, j), j);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    __syncthreads();  // the whole warpgroup's wgmmas have read as and bs
    stage_wg_acc<32>(acc[0], cs, kLd, 0);
    stage_wg_acc<32>(acc[1], cs, kLd, 64);
  }
  __syncthreads();
  store_rows<32>(cs, kLd, 128, out, m0 + 128, Cout, m0, 0, cols, act,
                 threadIdx.x, kWg);
}

}  // namespace hopper

// Internal linkage: each library keeps its own `allowed` flags (a static
// local of an external template would be one symbol across every library
// loaded in the process).
namespace {

template <class T, int kBN>
int launch(const void* x, const void* w, const float* scale,
           const float* shift, void* out, int batch, int H, int W, int Cin,
           int KH, int KW, int Cout, int OH, int OW, int stride, int pad,
           int act, cudaStream_t stream) {
  constexpr int smem = smem_bytes<Im2colA<T>, ConvB<T, kBN>, kBN>();
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


// One instantiation of the im2col kernel. bf16: the weight map MN-major
// (the (K, Cout) HWIO buffer, boxes of 64 n x 64 k). float32: two K-major
// maps (boxes of 32 k x 64 n) of the weight's TF32 halves in w_tf32 (big,
// then small: 2 x Cout x K floats).
template <class T, int kBN>
cudaError_t launch_im2col(const void* x, const void* w, const float* w_tf32,
                          const float* scale, const float* shift, void* out,
                          int batch, int H, int W, int Cin, int KH, int KW,
                          int Cout, int OH, int OW, int stride, int pad,
                          int act, cudaStream_t s) {
  constexpr int kElem = static_cast<int>(sizeof(T));
  CUtensorMap map_w, map_ws, map_x;
  const int K = KH * KW * Cin;
  cudaError_t err = cudaSuccess;
  if constexpr (kIsF32<T>) {
    if (w_tf32 == nullptr) return cudaErrorInvalidValue;
    err = hopper::make_map(&map_w, w_tf32, Cout, K, 64, 0, kElem);
    if (err == cudaSuccess)
      err = hopper::make_map(&map_ws, w_tf32 + static_cast<size_t>(Cout) * K,
                             Cout, K, 64, 0, kElem);
  } else {
    err = hopper::make_map(&map_w, w, K, Cout, 64, 0, kElem);
    map_ws = map_w;  // unread
  }
  if (err == cudaSuccess)
    err = hopper::make_im2col_map(&map_x, x, batch, H, W, Cin, KH, KW, stride,
                                  pad, hopper::conv_channels<T, kBN>(),
                                  kElem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  constexpr int smem = hopper::conv_smem<T, kBN>();
  auto kernel = hopper::conv_im2col_tma_kernel<T, kBN>;
  static unsigned allowed = 0;
  if (err == cudaSuccess)
    err = allow_smem(reinterpret_cast<const void*>(kernel), smem, allowed);
  if (err != cudaSuccess) return err;
  const int M = batch * OH * OW;
  const int tiles = (M + 127) / 128 * ((Cout + kBN - 1) / kBN);
  kernel<<<tiles < sms ? tiles : sms, 2 * hopper::kWg + 32, smem, s>>>(
      map_w, map_ws, map_x, scale, shift, static_cast<T*>(out), batch, Cin,
      KH, KW, Cout, OH, OW, stride, pad, act);
  return cudaSuccess;
}

// The wgmma kernels of T: tile_n 32 is the staged-rows kernel (conv0), 64
// (and in bf16 128) the im2col kernel with that N tile; the wrapper checks
// that the layer fits the kernel it names.
template <class T>
int launch_hopper(const void* x, const void* w, const float* w_tf32,
                  const float* scale, const float* shift, void* out,
                  int batch, int H, int W, int Cin, int KH, int KW, int Cout,
                  int OH, int OW, int stride, int pad, int act, int tile_n,
                  void* stream) {
  using hopper::kBox;
  const auto s = static_cast<cudaStream_t>(stream);
  if (tile_n == 32) {
    const int n_in = (128 / OW - 1) * stride + KH;
    const int rows = n_in * W * Cin * static_cast<int>(sizeof(T));
    // bf16: patch tile, weight tile, rows (the staging tile over the
    // patches); float32: split weight, rows, staging tile
    const int smem = kIsF32<T> ? 2 * 4096 + rows + 128 * (32 + kOutPad) * 4 +
                                     1024
                               : 2 * kBox + 4096 + rows + 1024;
    auto kernel = hopper::conv_rows_kernel<T>;
    static unsigned allowed = 0;
    const cudaError_t err =
        allow_smem(reinterpret_cast<const void*>(kernel), 96 * 1024, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<batch * OH * OW / 128, hopper::kWg, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), scale, shift,
        static_cast<T*>(out), H, W, Cin, KH, KW, Cout, OH, OW, stride, pad,
        act);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (tile_n == 64) {
    err = launch_im2col<T, 64>(x, w, w_tf32, scale, shift, out, batch, H, W, Cin,
                               KH, KW, Cout, OH, OW, stride, pad, act, s);
  } else if constexpr (!kIsF32<T>) {
    if (tile_n == 128)
      err = launch_im2col<T, 128>(x, w, w_tf32, scale, shift, out, batch, H, W,
                                  Cin, KH, KW, Cout, OH, OW, stride, pad,
                                  act, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace satae

extern "C" {

// NHWC x, the K-major (Cout, KH * KW * Cin) w, NHWC out, all float32;
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

// satae_conv2d_bn_act with bf16 x, w (HWIO flattened to (KH * KW * Cin,
// Cout)) and out; scale and shift float32, out
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

// satae_conv2d_bn_act_bf16 on wgmma: tile_n 32 takes the staged-rows
// kernel (K = KH * KW * Cin <= 32, Cout <= 32 and a multiple of 8, 128
// output pixels = whole output rows of one image, W * Cin a multiple of 8,
// x 16-byte aligned); 64 or 128 the im2col kernel, TMA for the patches and
// the weight (x and w 16-byte aligned, Cout a multiple of 8; tile_n 64:
// Cout <= 64 and Cin a multiple of 32, tile_n 128: Cin a multiple of 64).
// The wrapper (satae_torch/kernels/conv.py::conv_route) routes every other
// layer to satae_conv2d_bn_act_bf16.
int satae_conv2d_bn_act_bf16_tma(const __nv_bfloat16* x,
                                 const __nv_bfloat16* w, const float* scale,
                                 const float* shift, __nv_bfloat16* out,
                                 int batch, int H, int W, int Cin, int KH,
                                 int KW, int Cout, int OH, int OW, int stride,
                                 int pad, int act, int tile_n, void* stream) {
  return satae::launch_hopper<__nv_bfloat16>(x, w, nullptr, scale, shift,
                                             out, batch, H, W, Cin, KH, KW,
                                             Cout, OH, OW, stride, pad, act,
                                             tile_n, stream);
}

// satae_conv2d_bn_act on wgmma (3xTF32): w is the K-major (Cout, KH * KW *
// Cin) buffer, a (Cout, KH, KW, Cin) tensor (pack_conv_weight of a float32
// weight), w_tf32 its TF32 halves (conv.py::split_tf32: big, then small, 2
// * Cout * K floats, 16-byte aligned). tile_n 32 takes the staged-rows
// kernel (K <= 32, Cout <= 32 and a multiple of 8, 128 output pixels =
// whole output rows of one image, W * Cin a multiple of 4, x 16-byte
// aligned; reads w, not w_tf32); 64 the im2col kernel, TMA for the patches
// and w_tf32 (x 16-byte aligned, Cin a multiple of 32; reads w_tf32, not
// w). The wrapper (satae_torch/kernels/conv.py::conv_route) routes every
// other layer to satae_conv2d_bn_act, with the same w.
int satae_conv2d_bn_act_tma(const float* x, const float* w,
                            const float* w_tf32, const float* scale,
                            const float* shift, float* out, int batch, int H,
                            int W, int Cin, int KH, int KW, int Cout, int OH,
                            int OW, int stride, int pad, int act, int tile_n,
                            void* stream) {
  return satae::launch_hopper<float>(x, w, w_tf32, scale, shift, out, batch,
                                     H, W, Cin, KH, KW, Cout, OH, OW, stride,
                                     pad, act, tile_n, stream);
}

const char* satae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
