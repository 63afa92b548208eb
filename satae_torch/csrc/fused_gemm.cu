// K1 fused_gemm: out = act((A @ B) * scale + shift), float32.
//
// Replaces satae/kernels/matmul.py::_mm_kernel (the one pl.pallas_call of the
// JAX package, matmul.py:71), in both directions of its custom VJP:
//   forward (`fused_matmul`, `linear_pallas`): the encoder projection
//     (512 x 4096 @ 4096 x 64 when serving, 64 x 4096 when training), the
//     decoder projection, the head and the MLP layers;
//   backward (`_bwd`, matmul.py:100-118): dX = gs @ W^T and dW = X^T @ gs,
//     and the z = X @ W recompute for dscale, each one launch with scale 1
//     and shift 0 (null pointers) and no activation.
// The backward's operands are transposes of tensors that already exist, so
// the launcher takes `trans_a` (A is a row-major (K, M) buffer) and
// `trans_b` (B is a row-major (N, K) buffer) and reads them in place.
//
// Bound on an H100, with the product done as 3xTF32 on tensor cores (three
// TF32 products per float32 product: 495 / 3 = 165 TFLOP/s): the serving
// projection 512 x 4096 x 64 moves 9.4 MB (2.8 us at 3.35 TB/s) and does
// 0.27 GFLOP (1.6 us), so it is bound by bytes; the batch-64 training
// products (64 x 4096 x 64: 2.1 MB, 0.63 us) and the small MLP products are
// bound by bytes too, and far below a launch's latency.
//
// What the design does about it. With N <= 64 and K = 4096 the output has
// only 8 tiles (serving) or 1 (batch 64) of 64 x 64, so a tile per block
// leaves the card idle and walks K serially. The grid is tiles x S instead:
// block (tile, s) multiplies the K range [s * k_per_split, (s + 1) *
// k_per_split) into a float32 partial tile, the plan (satae_torch/kernels/
// matmul.py::split_k_plan) choosing S for about one wave of blocks, each with
// >= 128 of K, on 64 x 32 tiles. With S > 1 each block writes its partial to
// a workspace of S * M * N floats and takes a ticket from its tile's int32
// counter (__threadfence, then atomicAdd). The block that arrives last sums
// the S partials in split order 0..S-1, so the result does not depend on
// which block finished last and repeats bitwise; it applies the epilogue,
// which is non-linear and needs the full sum, writes out and resets the
// counter to 0. One launch per call. That last block's read of S planes is
// the cost of the design: one SM reads them far below the card's rate,
// whether the loads sit in registers or in a cp.async ring, so the time per
// launch grows with S once the main loop is short. The plan takes 32-wide
// tiles, whose planes are half the bytes, and a split count near the optimum
// of `chip_smoke.py --split-sweep`, which times every split count on an
// H100.
// The wrapper owns the workspace and the counters (one buffer per device,
// kept zeroed by the kernel); the port launches on one stream, and two
// concurrent split-K launches would share the counters.
#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace satae {

using RowMajorA = KMajor<kBM>;
using TransA = MNMajor<kBM>;
template <int kBN>
using RowMajorB = MNMajor<kBN>;
template <int kBN>
using TransB = KMajor<kBN>;

// The last block of a tile: out = epilogue(sum of the S partials in split
// order). The S planes stream through a ring of kRing plane-sized slots of
// shared memory (the free stage ring) with cp.async, kRing - 1 planes in
// flight; each thread copies, and then adds, only its own quads, so no block
// barrier is needed. The same loads held in registers ran no faster and
// raised the kernel's register count (fewer blocks per SM on the main loop).
template <int kBN, int kRing>
__device__ __forceinline__ void reduce_partials(float* smem, const float* ws,
                                                float* out, int M, int N,
                                                int m0, int n0, int splits,
                                                const float* scale,
                                                const float* shift, int act) {
  constexpr int kPerRow = kBN / 4;
  constexpr int kStep = kThreads / kPerRow;
  constexpr int kQuads = kBM / kStep;
  constexpr int kSlot = kQuads * kThreads * 4;  // floats: one plane's tile
  const int c = (threadIdx.x % kPerRow) * 4;
  const int nv = N - (n0 + c) < 4 ? N - (n0 + c) : 4;  // <= 0: no columns
  const bool vec = N % 4 == 0 && aligned16(out) && aligned16(ws);
  const size_t plane = static_cast<size_t>(M) * N;
  size_t off[kQuads];
  bool ok[kQuads];
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int row = m0 + threadIdx.x / kPerRow + kStep * i;
    ok[i] = row < M && nv > 0;
    off[i] = ok[i] ? static_cast<size_t>(row) * N + n0 + c : 0;
  }
  // the thread's quad i of the plane in slot r
  auto slot = [&](int r, int i) {
    return smem + r * kSlot + (i * kThreads + threadIdx.x) * 4;
  };
  auto fetch = [&](int s) {
    if (s < splits) {
      const float* p = ws + s * plane;
#pragma unroll
      for (int i = 0; i < kQuads; ++i) {
        float* d = slot(s % kRing, i);
        if (vec) {
          cp_async16(d, ok[i] ? p + off[i] : ws, ok[i]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            cp_async4(d + j, ok[i] && j < nv ? p + off[i] + j : ws,
                      ok[i] && j < nv);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) fetch(s);
  float v[kQuads][4] = {};
  for (int s = 0; s < splits; ++s) {
    cp_async_wait<kRing - 2>();  // plane s has landed
    fetch(s + kRing - 1);  // into the slot of plane s - 1, read already
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const float4 q = *reinterpret_cast<const float4*>(slot(s % kRing, i));
      v[i][0] += q.x;
      v[i][1] += q.y;
      v[i][2] += q.z;
      v[i][3] += q.w;
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < kQuads; ++i)
    if (ok[i])
      store_quad(out, off[i], n0 + c, v[i], nv, vec, scale, shift, act);
}

template <class ATile, class BTile, int kBN>
__global__ void __launch_bounds__(kThreads)
    fused_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift, float* __restrict__ out,
                      float* __restrict__ ws, int* __restrict__ counters,
                      int M, int N, int K, int act, int k_per_split) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ bool last;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const ATile a(x, M, K, m0);
  const BTile b(w, N, K, n0);
  Frag<kBN> f;
  mainloop<ATile, BTile, kBN>(a, b, smem, k_begin, k_end, f);
  stage_acc<kBN>(f, smem);
  if (gridDim.z == 1) {
    store_tile<kBN>(smem, out, M, N, m0, n0, scale, shift, act);
    return;
  }
  // split-K: this block's raw partial into plane blockIdx.z of ws ...
  store_tile<kBN>(smem, ws + blockIdx.z * static_cast<size_t>(M) * N, M, N,
                  m0, n0, nullptr, nullptr, kActNone);
  __threadfence();
  __syncthreads();
  int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0)
    last = atomicAdd(counter, 1) == static_cast<int>(gridDim.z) - 1;
  __syncthreads();
  if (!last) return;
  // ... and the last of the tile's S blocks finishes it
  __threadfence();
  constexpr int kRing = kStages * stage_floats<ATile, BTile>() / (kBM * kBN);
  static_assert(kRing >= 2, "the fix-up needs two plane slots");
  reduce_partials<kBN, kRing < 8 ? kRing : 8>(smem, ws, out, M, N, m0, n0,
                                             gridDim.z, scale, shift, act);
  if (threadIdx.x == 0) *counter = 0;
}

// Internal linkage: each library keeps its own `allowed` flags (a static
// local of an external template would be one symbol across every library
// loaded in the process).
namespace {

template <class ATile, class BTile, int kBN>
int launch(const float* x, const float* w, const float* scale,
           const float* shift, float* out, float* ws, int* counters, int M,
           int N, int K, int act, int splits, int k_per_split,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<ATile, BTile, kBN>();
  auto kernel = fused_gemm_kernel<ATile, BTile, kBN>;
  static unsigned allowed = 0;
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel), smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, splits);
  kernel<<<grid, kThreads, smem, stream>>>(x, w, scale, shift, out, ws,
                                           counters, M, N, K, act,
                                           k_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <int kBN>
int launch_layout(const float* x, const float* w, const float* scale,
                  const float* shift, float* out, float* ws, int* counters,
                  int M, int N, int K, int act, int trans_a, int trans_b,
                  int splits, int k_per_split, cudaStream_t stream) {
  if (trans_a) {
    return trans_b ? launch<TransA, TransB<kBN>, kBN>(
                         x, w, scale, shift, out, ws, counters, M, N, K, act,
                         splits, k_per_split, stream)
                   : launch<TransA, RowMajorB<kBN>, kBN>(
                         x, w, scale, shift, out, ws, counters, M, N, K, act,
                         splits, k_per_split, stream);
  }
  return trans_b ? launch<RowMajorA, TransB<kBN>, kBN>(
                       x, w, scale, shift, out, ws, counters, M, N, K, act,
                       splits, k_per_split, stream)
                 : launch<RowMajorA, RowMajorB<kBN>, kBN>(
                       x, w, scale, shift, out, ws, counters, M, N, K, act,
                       splits, k_per_split, stream);
}

}  // namespace

}  // namespace satae

extern "C" {

// out (M, N) = act((A @ B) * scale + shift). A is x, a row-major (M, K)
// buffer, or with trans_a x read as the transpose of a row-major (K, M)
// buffer; B is w, row-major (K, N), or with trans_b the transpose of a
// row-major (N, K) buffer. scale / shift may be null (1 / 0). The plan:
// tile_n (32 or 64) columns per tile, `splits` K ranges of k_per_split (a
// multiple of 32) each; with splits > 1, `ws` holds splits * M * N floats and
// `counters` one zeroed int per tile. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a plan the
// kernel does not take.
int satae_fused_gemm(const float* x, const float* w, const float* scale,
                     const float* shift, float* out, float* ws, int* counters,
                     int M, int N, int K, int act, int trans_a, int trans_b,
                     int tile_n, int splits, int k_per_split, void* stream) {
  const bool plan_ok =
      (tile_n == 32 || tile_n == 64) && splits >= 1 && k_per_split > 0 &&
      static_cast<long long>(splits) * k_per_split >= K &&
      (splits == 1 || (ws != nullptr && counters != nullptr &&
                       k_per_split % satae::kBK == 0 &&
                       static_cast<long long>(splits - 1) * k_per_split < K));
  if (!plan_ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return tile_n == 32
             ? satae::launch_layout<32>(x, w, scale, shift, out, ws, counters,
                                        M, N, K, act, trans_a, trans_b, splits,
                                        k_per_split, s)
             : satae::launch_layout<64>(x, w, scale, shift, out, ws, counters,
                                        M, N, K, act, trans_a, trans_b, splits,
                                        k_per_split, s);
}

const char* satae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
