// K1's wide route: out = act((A @ B) * scale + shift) in bf16, A a
// row-major (M, K) buffer and B a row-major (K, N) one, the product
// accumulated and the epilogue taken in float32, rounded once to bf16 --
// the function of fused_gemm.cu's bf16 wgmma kernel, for the large
// products that kernel's 64 x 64 tiles leave far below the card.
//
// Extends the bf16 port of satae/kernels/matmul.py:36 (_mm_kernel, the
// JAX package's one pl.pallas_call) to the ViT encoder's linears
// (satae_torch/models/fast_infer.py::vit_encoder_infer): the patch
// embedding 37,632 x 1,536 x 768 and, per block at a 64-chip chunk (M =
// 37,696), qkv x 768 x 2,304, proj x 768 x 768, fc1 x 768 x 3,072 (GELU)
// and fc2 x 3,072 x 768. satae_torch/kernels/matmul.py::k1_wide picks this
// route by shape; every other K1 launch keeps fused_gemm.cu's kernels.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): by operations at every
// one of those shapes -- qkv does 133 GFLOP (135 us) against 235 MB (70
// us), fc1 and fc2 178 GFLOP (180 us) against 290 MB, at 500-600
// operations a byte, twice the card's 295.
//
// What the design does about it: it keeps the tensor cores fed.
//   - 128 x 256 output tiles, two consumer warpgroups of 64 x 256 each on
//     wgmma m64n256k16, the float32 accumulators (128 a thread) in
//     registers; setmaxnreg moves registers from the producer warpgroup
//     (40 a thread) to the consumers (232). A stage's 48 KB (A 128 x 64,
//     B 64 x 256) feed 4.2 MFLOP: 85 operations a byte of shared memory,
//     against the 64 x 64 tile's 43.
//   - One producer thread issues the TMA loads (128-byte swizzle, A one
//     128-row box, B four 64-wide boxes) into a ring of four 64-deep
//     stages, counted by a full and an empty mbarrier each.
//   - wgmma stays in flight across stages: a consumer issues stage i's four
//     wgmmas, waits until only they are pending (wgmma_wait<1>) and then
//     releases stage i - 1 to the producer. One float32 accumulator runs
//     down the tile's K, with no per-slice scratch and no FADD pass (a
//     64 x 256 warpgroup has no registers for a second set, and the
//     per-slice add is what serialises fused_gemm.cu's loop).
//   - Persistent: one block an SM walks the output tiles N-fastest within
//     each 128-row panel (tile t of the block is blockIdx.x + t *
//     gridDim.x), so an A panel is read from device memory about once and
//     B (at most 4.7 MB) stays in L2; the producer runs into the next
//     tile's stages while the consumers run the epilogue.
//   - The epilogue leaves by TMA: scale and shift per column (the tile's
//     256 shifts brought into shared memory while the main loop runs),
//     then the activation through epilogue.cuh's functions, one
//     instantiation per activation, rounded once to bf16 into a 64 x 64
//     staging box of shared memory, which one TMA store writes out while
//     the warpgroup fills its other box and then runs the next tile's main
//     loop; TMA leaves out the rows past M (the ragged last panel, which
//     its loads zero-fill).
//
// Arithmetic: per output, the exact bf16 products of each 16-deep wgmma
// step added to one float32 accumulator down all of K, the 64 x 64
// kernel's per-32-slice sums aside; the same values rounded in another
// order (tests/test_torch_port_k1_wide.py emulates it against satae's
// kernel; chip_smoke.py --vit holds it to one bf16 ulp + 1e-6 of the plain
// version, >= 99 % bit-equal).
//
// The plan the launcher takes: N a multiple of 256, K a multiple of 64,
// no split of K (k1_wide asks for enough tiles to fill a wave instead).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "gemm_tile.cuh"
#include "wgmma_tile.cuh"

namespace satae {
namespace hopper {

constexpr int kWideM = 128;                    // rows of a tile
constexpr int kWideN = 256;                    // columns of a tile
constexpr int kWideRing = 4;                   // stages of the ring
constexpr int kWideConsumers = 2;              // consumer warpgroups
constexpr int kWideThreads = (kWideConsumers + 1) * kWg;
constexpr int kWideA = kWideM * kStageK * 2;   // A bytes of a stage: 16 KB
constexpr int kWideB = kStageK * kWideN * 2;   // B bytes of a stage: 32 KB
constexpr int kWideStage = kWideA + kWideB;
// the ring, each consumer warpgroup's two output staging boxes (64 x 64
// bf16, 8 KB each) and the tile's 256 shifts, 1024-byte aligned, with the
// slack of aligning the base: 226 KB of the 227 a block may have
constexpr int kWideBoxesAt = kWideRing * kWideStage;
constexpr int kWideShiftsAt = kWideBoxesAt + kWideConsumers * 2 * kBox;
constexpr int kWideSmem = kWideShiftsAt + kWideN * 4 + 1024;

// The 64 x 64 box of shared memory at src (128-byte swizzle) into the
// tensor of `map` at coordinates (c0 innermost, c1), as one bulk async
// group of this thread's; TMA leaves out what lies outside the tensor.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

// v, read at this point of the program: an asm volatile stays after the
// setmaxnreg before it, and so does what is computed from it.
__device__ __forceinline__ int here(int v) {
  int r;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(r) : "r"(v));
  return r;
}

// The output tiles (128 x 256, N fastest) of an (M, N) output, counted
// where they are used, from the kernel's arguments: a count kept live
// across the consumers' main loop and epilogue was spilled.
__device__ __forceinline__ int wide_tiles(int M, int N) {
  return (here(M) + kWideM - 1) / kWideM * (here(N) / kWideN);
}

// Waits until at most kPending of this thread's bulk async groups are
// still reading their shared memory.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending)
               : "memory");
}

// epilogue.cuh's epilogue of activation kAct, known at compile time: with
// the activation a run-time value the compiler computed the sigmoid's
// expf and division for every value and selected, which took two thirds
// of qkv's epilogue (31 % of the launch, chip_smoke.py --vit on an H100).
template <int kAct>
__device__ __forceinline__ float wide_epilogue(float acc, float scale,
                                               float shift) {
  if constexpr (kAct == kActGelu)
    return epilogue_t<true>(acc, scale, shift, kAct);
  else
    return epilogue(acc, scale, shift, kAct);
}

// For each of the block's output tiles, out[m0:m0+128, n0:n0+256] =
// act((A @ B) * scale + shift) in bf16, act = kAct; threads 0-255 are the
// two consumer warpgroups (rows 64 w.. of the tile), thread 256 the
// producer.
template <int kAct>
__global__ void __launch_bounds__(kWideThreads, 1)
    fused_gemm_wide_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b,
                           const __grid_constant__ CUtensorMap map_out,
                           const float* __restrict__ scale,
                           const float* __restrict__ shift, int M, int N,
                           int K) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kWideRing], empty[kWideRing];
  uint8_t* smem = align1024(smem_raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideRing; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kWideConsumers * kWg / 32);
    }
    bar_init_fence();
  }
  __syncthreads();
  const int wg = static_cast<int>(threadIdx.x) / kWg;
  if (wg == kWideConsumers) {
    // the producer warpgroup hands its registers to the consumers; one
    // thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kWideConsumers * kWg) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_b))
                   : "memory");
      int g = 0;  // stages filled so far
      for (int tile = blockIdx.x; tile < wide_tiles(M, N);
           tile += gridDim.x) {
        const int n_tiles = here(N) / kWideN;
        const int m0 = tile / n_tiles * kWideM;
        const int n0 = tile % n_tiles * kWideN;
        for (int i = 0, n_k = here(K) / kStageK; i < n_k; ++i, ++g) {
          const int s = g % kWideRing;
          if (g >= kWideRing) bar_wait(&empty[s], (g / kWideRing - 1) & 1);
          uint8_t* st = smem + s * kWideStage;
          const int k = i * kStageK;
          bar_expect(&full[s], kWideStage);
          tma_load(st, &map_a, &full[s], k, m0);
#pragma unroll
          for (int b = 0; b < kWideN / 64; ++b)
            tma_load(st + kWideA + b * kBox, &map_b, &full[s], n0 + 64 * b,
                     k);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    float acc[kWideN / 2];
#pragma unroll
    for (int i = 0; i < kWideN / 2; ++i) acc[i] = 0.f;
    // this thread's rows of the tile (wgmma's accumulator layout: row
    // 16 warp + lane / 4 and 8 below, columns 8 j + 2 (lane % 4), + 1)
    const int t = static_cast<int>(threadIdx.x) % kWg;
    const int row_wg = 16 * (t / 32) + (t % 32) / 4;
    const int col = 2 * (t % 4);
    uint8_t* staging = smem + kWideBoxesAt + wg * 2 * kBox;
    float* shift_s = reinterpret_cast<float*>(smem + kWideShiftsAt);
    int g = 0;  // stages consumed so far
    for (int tile = blockIdx.x; tile < wide_tiles(M, N); tile += gridDim.x) {
      const int n_tiles = here(N) / kWideN;
      const int m0 = tile / n_tiles * kWideM;
      const int n0 = tile % n_tiles * kWideN;
      // the tile's shifts into shared memory, one a consumer thread, while
      // the main loop runs; both warpgroups have read the last tile's
      named_sync(3, kWideConsumers * kWg);
      if (shift != nullptr)
        cp_async4(shift_s + threadIdx.x, shift + n0 + threadIdx.x, true);
      else
        shift_s[threadIdx.x] = 0.f;
      cp_async_commit();
      for (int i = 0, n_k = here(K) / kStageK; i < n_k; ++i, ++g) {
        const int s = g % kWideRing;
        bar_wait(&full[s], (g / kWideRing) & 1);
        const uint8_t* st = smem + s * kWideStage;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kStageK / 16; ++j)
          wgmma_n256<0, 1>(acc, desc_k<false>(st + wg * (64 * 128), j),
                           desc_k<true>(st + kWideA, j), i > 0 || j > 0);
        wgmma_commit();
        fence_acc(acc);
        // stage i - 1's wgmmas have completed: release it
        wgmma_wait<1>();
        if (i > 0) {
          __syncwarp();
          if (t % 32 == 0) bar_arrive(&empty[(g - 1) % kWideRing]);
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      __syncwarp();
      if (t % 32 == 0) bar_arrive(&empty[(g - 1) % kWideRing]);
      cp_async_wait<0>();
      named_sync(3, kWideConsumers * kWg);  // every shift has landed
      // the epilogue, 64 columns at a time: into one of the warpgroup's
      // two staging boxes (swizzled as TMA reads them: 16-byte chunk jj of
      // row r at jj ^ (r % 8), no bank conflict), then out by one TMA
      // store, which runs on under the next tile's main loop; scale, which
      // the ViT's linears do not have, is read from device memory
#pragma unroll
      for (int c = 0; c < kWideN / 64; ++c) {
        uint8_t* box = staging + (c % 2) * kBox;
        if (t == 0) bulk_wait_read<1>();  // the store from this box is done
        named_sync(1 + wg, kWg);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * c + jj, n = 64 * c + 8 * jj + col;
          const float sc0 = scale ? __ldg(scale + n0 + n) : 1.f;
          const float sc1 = scale ? __ldg(scale + n0 + n + 1) : 1.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row_wg + 8 * h;
            *reinterpret_cast<__nv_bfloat162*>(
                box + r * 128 + ((jj ^ (r % 8)) << 4) + 2 * col) =
                __floats2bfloat162_rn(
                    wide_epilogue<kAct>(acc[4 * j + 2 * h], sc0, shift_s[n]),
                    wide_epilogue<kAct>(acc[4 * j + 2 * h + 1], sc1,
                                        shift_s[n + 1]));
          }
        }
        fence_async_smem();  // the writes, before TMA reads them
        named_sync(1 + wg, kWg);
        if (t == 0) tma_store(&map_out, box, n0 + 64 * c, m0 + 64 * wg);
      }
    }
    // the last stores have read their boxes before the block leaves
    if (t == 0) bulk_wait_read<0>();
  }
}


}  // namespace hopper

namespace {

// One launch of the wide kernel: tensor maps encoded per call on the host
// (A in 128-row boxes, B and out in 64 x 64 ones, 128-byte swizzle, zeros
// read and nothing written outside the buffers), a grid of one block an SM
// or one a tile, whichever is fewer.
template <int kAct>
int launch_wide(const void* x, const void* w, const float* scale,
                const float* shift, void* out, int M, int N, int K,
                cudaStream_t stream) {
  using namespace hopper;
  CUtensorMap map_a, map_b, map_out;
  cudaError_t err = make_map(&map_a, x, M, K, kWideM);
  if (err == cudaSuccess) err = make_map(&map_b, w, K, N, 64);
  if (err == cudaSuccess) err = make_map(&map_out, out, M, N, 64);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = fused_gemm_wide_kernel<kAct>;
  static unsigned allowed = 0;
  err = allow_smem(reinterpret_cast<const void*>(kernel), kWideSmem,
                   allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int sms[32] = {};  // SMs of each device, read once
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = dev < 32 ? sms[dev] : 0;
  if (n_sm == 0) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 32) sms[dev] = n_sm;
  }
  const int tiles = (M + kWideM - 1) / kWideM * (N / kWideN);
  kernel<<<tiles < n_sm ? tiles : n_sm, kWideThreads, kWideSmem, stream>>>(
      map_a, map_b, map_out, scale, shift, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace satae

extern "C" {

// out (M, N) = act((x @ w) * scale + shift), x a row-major (M, K) bf16
// buffer, w a row-major (K, N) one, out bf16 (M, N); scale and shift
// float32 (N,) or null (1 / 0); act none, relu, sigmoid or gelu. x, w and
// out 16-byte aligned; N a multiple of 256, K of 64. Launches on `stream`
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for a shape or activation the kernel does not take.
int satae_fused_gemm_bf16_wide(const __nv_bfloat16* x,
                               const __nv_bfloat16* w, const float* scale,
                               const float* shift, __nv_bfloat16* out, int M,
                               int N, int K, int act, void* stream) {
  using satae::hopper::kWideN;
  if (M < 1 || N < kWideN || N % kWideN != 0 || K < satae::hopper::kStageK ||
      K % satae::hopper::kStageK != 0 || act < satae::kActNone ||
      act > satae::kActGelu)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case satae::kActRelu:
      return satae::launch_wide<satae::kActRelu>(x, w, scale, shift, out, M,
                                                 N, K, s);
    case satae::kActSigmoid:
      return satae::launch_wide<satae::kActSigmoid>(x, w, scale, shift, out,
                                                    M, N, K, s);
    case satae::kActGelu:
      return satae::launch_wide<satae::kActGelu>(x, w, scale, shift, out, M,
                                                 N, K, s);
    default:
      return satae::launch_wide<satae::kActNone>(x, w, scale, shift, out, M,
                                                 N, K, s);
  }
}

const char* satae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
