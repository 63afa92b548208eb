// K1 fused_gemm: out = act((A @ B) * scale + shift), operands and output
// float32 or bf16, the product accumulated and the epilogue taken in float32.
//
// Replaces satae/kernels/matmul.py:36 (_mm_kernel, the one pl.pallas_call of
// the JAX package, matmul.py:71), in both directions of its custom VJP:
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
// bound by bytes too, and far below a launch's latency. In bf16 (2 bytes an
// element, 989 TFLOP/s dense on the tensor cores) every one of these is
// bound by bytes: the serving projection moves 4.7 MB (1.4 us).
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
// In bf16 the partials stay float32 in the same workspace, and the last
// block rounds their sum to bf16 once, after the epilogue.
//
// Batched (satae_fused_gemm_batched / _batched_bf16): C independent products
// out[c] = act((A[c] @ B[c]) * scale[c] + shift[c]) in one launch, for the
// linears of the config-batched sweep (satae/train/vmap_sweep.py), where
// jax.vmap gives _mm_kernel's pallas_call a batch grid axis. The config
// joins the split in the grid's z: block z computes config z / S, split
// z % S, on config c's slices of x, w, scale, shift and out, its own S
// workspace planes and its own tile counters; a 2-D product is the same
// launch with C = 1. The plan is one for all configs, with
// every config's tiles counted toward the wave. Bound: the float32
// projection at C = 45 (45 x 64 x 4096 x 64) reads 94 MB (28 us at
// 3.35 TB/s) and does 1.5 GFLOP (9 us at 165 TFLOP/s 3xTF32): bytes, as
// every product of the sweep. Buffers TMA cannot read run on this mma.sync
// loop (satae_fused_gemm_batched / _batched_bf16: the head's 10-wide
// cotangent in the backward); every other batched product runs on the
// wgmma kernel below (satae_fused_gemm_batched_tma / _batched_bf16_tma).
// The wrapper owns the workspace and the counters (one buffer per device,
// kept zeroed by the kernel); the port launches on one stream, and two
// concurrent split-K launches would share the counters.
//
// Hopper's own instructions (hopper::fused_gemm_tma_kernel, float32 and
// bf16 instantiations; entries satae_fused_gemm_batched_tma /
// _batched_bf16_tma, C = 1 for a 2-D product; wgmma_tile.cuh holds its
// main loop). float32 is 3xTF32 on wgmma m64n64k8 (the split
// pass of wgmma_tile.cuh: A split in registers, B into K-major tiles),
// stages of 32 of K, bound as above (bytes at every product of the main
// paths). Bound at 3.35 TB/s and 989 TFLOP/s, every bf16 product of the
// main paths is bound by bytes: the serving
// projection 512 x 4096 x 64 and the decoder input 512 x 64 x 4096 move
// 4.8 MB (1.43 us), the batch-64 long products (64 x 4096 x 64, 64 x 64 x
// 4096) 1.06 MB (0.32 us), the head's products a few KB, far below a
// launch; at C = 45 the long products move 47.7 MB (14.2-14.4 us), the
// head's 0.56 and 0.27 us. So the design is about latency, and at C = 45
// about keeping the memory busy: a 64 x 64 tile per block and config, A
// and B brought by TMA (one thread, 128-byte swizzle, 3-D tensor maps
// whose outermost coordinate is the config, so ragged M, N and K are
// zero-filled by the hardware and no box reaches into the next config)
// into a ring of at most four 64-deep stages sized to the block's K, wgmma
// m64n64k16 from shared memory for all four operand layouts (transpose
// bits, no fragment packing). Short K (one split): the grid's z is sized
// to about one wave and each block walks its tile's configs; the ring runs
// on across them, so the next config's loads overlap this one's epilogue
// (at C = 45, 2,880 one-stage tiles, one block a tile is slower:
// scripts/time_kernel_variants.py, "no persistence"). Long K:
// the splits of a tile launched as one thread-block cluster
// (split_k_plan_tma: at K = 4096 16 splits of 256 for one tile, 8 of 512
// for the serving projection's 8, 4 of 1024 per config at C = 45) whose
// blocks reduce the float32 partials through distributed shared memory,
// each block 1/S of the tile, in split order. One launch per call, no
// workspace, no counters. float32 takes the mma.sync loop's plan
// (split_k_plan: at K = 4096 32 splits of 128 for one tile, 8 of 512 for
// the serving projection, 2 of 2,048 per config at C = 45), a cluster
// block holding 1, 2, 4 or 8 consecutive partials where the plan has more
// than 16, each summed from zero and staged apart; per output element the
// wgmma kernel then does the mma.sync loop's arithmetic in its order, and
// every float32 result is that loop's bit for bit (chip_smoke.py --ab
// holds it). Stayed on the mma.sync loop above: the
// buffers TMA cannot read, float32 and bf16 -- a base or row not 16-byte
// aligned: an odd K or N in bf16, K or N not a multiple of 4 in float32,
// odd offsets, the head's 10-wide cotangent in its backward (fc2's dX and
// dW); and the float32 launches chip_smoke.py --ab timed faster here, the
// same sums either way: N <= 16 (the head's forward: a 64-wide wgmma tile
// does 6x the work), an unbatched product split into parts of >= 512 of K
// (the serving projection: 16 stages in a row per cluster block), a
// batched one whose B is MN-major with >= 2^20 multiply-adds a config (the
// vmap path's 4096-wide dX and dW: the transposing split costs half)
// (satae_torch/kernels/matmul.py::k1_loader).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_tile.cuh"
#include "wgmma_tile.cuh"

namespace satae {

template <class T>
using RowMajorA = KMajor<T, kBM>;
template <class T>
using TransA = MNMajor<T, kBM>;
template <class T, int kBN>
using RowMajorB = MNMajor<T, kBN>;
template <class T, int kBN>
using TransB = KMajor<T, kBN>;

// Dynamic shared memory of a K1 block: the stage ring, or the output staging
// tile, or the fix-up's two float32 plane slots, whichever is largest (in
// float32 the ring always is).
template <class ATile, class BTile, int kBN>
__host__ __device__ constexpr int gemm_smem_bytes() {
  return smem_bytes<ATile, BTile, kBN>() > 2 * 4 * kBM * kBN
             ? smem_bytes<ATile, BTile, kBN>()
             : 2 * 4 * kBM * kBN;
}

// The last block of a tile: out = epilogue(sum of the S float32 partials in
// split order), rounded once to T. The S planes stream through a ring of
// kRing plane-sized slots of shared memory (the free stage ring) with
// cp.async, kRing - 1 planes in flight; each thread copies, and then adds,
// only its own quads, so no block barrier is needed. The same loads held in
// registers ran no faster and raised the kernel's register count (fewer
// blocks per SM on the main loop).
template <int kBN, int kRing, class T>
__device__ __forceinline__ void reduce_partials(float* smem, const float* ws,
                                                T* out, int M, int N, int m0,
                                                int n0, int splits,
                                                const float* scale,
                                                const float* shift, int act) {
  constexpr int kPerRow = kBN / 4;
  constexpr int kStep = kThreads / kPerRow;
  constexpr int kQuads = kBM / kStep;
  constexpr int kSlot = kQuads * kThreads * 4;  // floats: one plane's tile
  const int c = (threadIdx.x % kPerRow) * 4;
  const int nv = N - (n0 + c) < 4 ? N - (n0 + c) : 4;  // <= 0: no columns
  // a quad of the output is 4 * sizeof(T) bytes
  const bool vec = N % 4 == 0 && aligned(out, 4 * sizeof(T)) && aligned16(ws);
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
      store_vec<T, 4>(out, off[i], n0 + c, v[i], nv, vec, scale, shift, act);
}

// The minimum blocks per SM set ptxas's occupancy target. With the thread
// count alone ptxas (CUDA 12.8, sm_90a) held the float32 RowMajorA x TransB
// 32-wide instantiation to 64 registers and spilled 20 bytes. float32 asks
// for 4, the most its shared memory allows: every float32 instantiation
// then fits 128 registers without a spill (with 1, the config index and
// its offsets took the 64-wide RowMajorA x TransB one from 127 registers
// to 138, and 4 blocks per SM to 3). bf16 asks for 1: at 128 registers its
// 64-wide instantiations spill. Block z is split z % splits of config
// z / splits (config c's operands are the c-th of C contiguous slices, its
// split-K planes the c-th group of `splits` planes of ws, its tile
// counters the c-th group of gridDim.x * gridDim.y).
template <class T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 4 : 1;

template <class ATile, class BTile, int kBN>
__global__ void __launch_bounds__(kThreads, kMinBlocks<typename ATile::Elem>)
    fused_gemm_kernel(const typename ATile::Elem* __restrict__ x,
                      const typename ATile::Elem* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift,
                      typename ATile::Elem* __restrict__ out,
                      float* __restrict__ ws, int* __restrict__ counters,
                      int M, int N, int K, int act, int splits,
                      int k_per_split) {
  using T = typename ATile::Elem;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ bool last;
  const int c = blockIdx.z / splits, split = blockIdx.z - c * splits;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const ATile a(x + static_cast<size_t>(c) * M * K, M, K, m0);
  const BTile b(w + static_cast<size_t>(c) * K * N, N, K, n0);
  Frag<kBN> f;
  mainloop<ATile, BTile, kBN>(a, b, reinterpret_cast<T*>(smem4), k_begin,
                              k_end, f);
  stage_acc<kBN>(f, smem);
  // config c's epilogue operands, formed after the main loop (not kept
  // live through it)
  const size_t mn = static_cast<size_t>(M) * N;
  out += c * mn;
  if (scale != nullptr) scale += c * N;
  if (shift != nullptr) shift += c * N;
  if (splits == 1) {
    store_tile<kBN>(smem, out, M, N, m0, n0, scale, shift, act);
    return;
  }
  // split-K: this block's raw float32 partial into plane `split` of the
  // config's planes of ws ...
  ws += c * splits * mn;
  store_tile<kBN>(smem, ws + split * mn, M, N, m0, n0, nullptr, nullptr,
                  kActNone);
  __threadfence();
  __syncthreads();
  int* counter = counters + (c * gridDim.y + blockIdx.y) * gridDim.x +
                 blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  // ... and the last of the tile's S blocks finishes it
  __threadfence();
  constexpr int kRing = gemm_smem_bytes<ATile, BTile, kBN>() / (4 * kBM * kBN);
  static_assert(kRing >= 2, "the fix-up needs two plane slots");
  reduce_partials<kBN, kRing < 8 ? kRing : 8>(smem, ws, out, M, N, m0, n0,
                                             splits, scale, shift, act);
  if (threadIdx.x == 0) *counter = 0;
}


// ---- float32 and bf16 on wgmma, TMA and a cluster's split-K reduction ------

namespace hopper {

// Shared memory of a block of fused_gemm_tma_kernel, 1024-byte aligned,
// with the slack of aligning the base. bf16: a ring of `ring` stages (two
// 8 KB boxes each, 64 of K), then with one split the float32 staging tile
// of the epilogue (split-K stages its partial in the consumed ring).
// float32: the ring (stages of 32 of K), the warpgroup's two split Bs (big
// and small, 8 KB each), then a staging tile for each of the block's `sub`
// partials (one with one split). At C = 1, one split, the ring is the
// largest that leaves two blocks an SM: bf16 4 x 16 + 18 + 1 = 83 KB,
// float32 3 x 16 + 32 + 18 + 1 = 99 KB.
constexpr int kStaging = 64 * (64 + kOutPad) * 4;
__host__ __device__ constexpr int k1_smem_bytes(int ring, int splits,
                                                bool f32, int sub = 1) {
  return f32 ? ring * 2 * kBox + 4 * kBox + sub * kStaging + 1024
             : ring * 2 * kBox + (splits > 1 ? 0 : kStaging) + 1024;
}
__host__ __device__ constexpr int k1_max_ring(bool f32) {
  return f32 ? kMaxRing - 1 : kMaxRing;
}
// float32 split-K: a cluster holds at most 16 blocks, so a plan of more
// partials gives each block `sub` consecutive ones, the least power of two
// that makes 16 blocks enough (at most 8: 128 partials, split_k_plan's
// most).
constexpr int kMaxSub = 8;
__host__ __device__ constexpr int k1_sub(int splits) {
  return splits <= 16 ? 1 : splits <= 32 ? 2 : splits <= 64 ? 4 : 8;
}

// Config c's scale and shift of columns [n0, n0 + 64) into dst[0, 64) and
// dst[64, 128) by cp.async (thread t < 128 one value, 1 and 0 where the
// pointer is null or the column past N), landing while the main loop runs
// without holding registers through it; the epilogue reads them after
// cp_async_wait and a barrier.
__device__ __forceinline__ void load_cols(float* dst, const float* scale,
                                          const float* shift, int n0,
                                          int N) {
  const int t = static_cast<int>(threadIdx.x), col = n0 + t % 64;
  const float* p = t < 64 ? scale : shift;
  if (p != nullptr && col < N)
    cp_async4(dst + t, p + col, true);
  else
    dst[t] = t < 64 ? 1.f : 0.f;
  cp_async_commit();
}

// The block's cluster along z, the clusters along z, and the block's rank
// in its cluster; a launch without clusters has clusters of one block.
__device__ __forceinline__ int cluster_z() {
  unsigned r;
  asm("mov.u32 %0, %%clusterid.z;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ int clusters_z() {
  unsigned r;
  asm("mov.u32 %0, %%nclusterid.z;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ int cluster_blocks() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// The 32-deep slices of K range [k_begin, k_begin + k_per_split) of K.
__device__ __forceinline__ int slices_of(int K, int k_begin,
                                         int k_per_split) {
  return (min(K, k_begin + k_per_split) - k_begin + kBK - 1) / kBK;
}

// The ring stages of n_slices slices: two slices a bf16 stage, one a
// float32 stage.
template <class T>
__device__ __forceinline__ int stages_of(int n_slices) {
  return kIsF32<T> ? n_slices : (n_slices + 1) / 2;
}

// For c < C, the 64 x 64 tile (blockIdx.x, blockIdx.y) of out[c] =
// act((A[c] @ B[c]) * scale[c] + shift[c]) in T (bf16 or float32), A[c]
// (M, K) and B[c] (K, N) read by TMA through 3-D maps -- config c the
// outermost coordinate -- map_a (C row-major (M, K) buffers, or with kTA
// (K, M) ones) and map_b (C row-major (N, K) buffers, or with kTB (K, N)
// ones) into a ring of `ring` stages (bf16: 64 of K, one 64-wide box per
// operand; float32: 32 of K, one box K-major or two 32-wide ones MN-
// major). The unbatched K1 is C = 1. Threads 0-127 are the consumer
// warpgroup -- bf16: wgmma m64n64k16 from the ring, two scratch
// accumulators; float32: consume_tf32, A split in registers, B split into
// the K-major tiles bs, three m64n64k8 TF32 wgmmas per k8 step (two
// consumer warpgroups on 64 x 32 halves of the tile, the same sums, ran
// slower on an H100: one block an SM instead of two); thread 128, in a
// warp of its own, issues the TMA loads.
//
// One split (splits == 1): block z computes configs z, z + gridDim.z, ...
// of its tile (cluster_z and clusters_z: clusters of one block); the
// launcher sizes gridDim.z so that the grid is about the blocks the card
// holds at once, and at C = 1 the grid is one block a tile. The ring runs
// on across a block's configs, so the producer loads the next config's
// tile while the consumers run the epilogue outside the ring, through the
// float32 staging tile cs, in 16-byte stores.
//
// Split-K (splits > 1): the blocks of a tile are one thread-block cluster
// (1, 1, R): the config is the cluster's z and the block's rank r in it
// holds partials [r sub, (r + 1) sub) of the S splits (sub = 1, R = S; in
// float32 sub = S / R rounded up to a power of two where S > 16). Each
// stages its float32 partials in its own shared memory; after a cluster
// barrier block r sums rows [64 r / R, 64 (r + 1) / R) of the tile over
// the S partials, read through distributed shared memory in split order
// 0..S-1 (bitwise repeatable, the emulation's order), applies the
// epilogue, rounds once to T and stores; a second barrier keeps every
// partial alive until all have been read. Every block of the cluster
// reduces 1/R of the tile, so the fix-up no longer rests on one block, and
// nothing goes through device memory.
//
// kGelu: the instantiation whose epilogue is the GELU (act == kActGelu),
// built for bf16 with A row-major and B read from a (K, N) buffer, the ViT
// encoder's linears; every other instantiation's code has no GELU in it.
template <class T, bool kTA, bool kTB, bool kGelu = false>
__global__ void __launch_bounds__(kWg + 32, 1)
    fused_gemm_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b,
                          const float* __restrict__ scale,
                          const float* __restrict__ shift,
                          T* __restrict__ out, int C, int M, int N, int K,
                          int act, int splits, int k_per_split, int ring) {
  constexpr bool kF32 = kIsF32<T>;
  constexpr int kLd = 64 + kOutPad;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxRing], empty[kMaxRing];
  __shared__ __align__(16) float col_buf[2][128];  // load_cols, two configs
  uint8_t* smem = align1024(smem_raw);
  uint8_t* bs = smem + ring * 2 * kBox;  // float32: the split Bs
  // the staging tiles: float32 after the split Bs (one per partial), bf16
  // after the ring with one split, else in the consumed ring
  float* cs = reinterpret_cast<float*>(
      kF32 ? bs + 4 * kBox : splits == 1 ? bs : smem);
  constexpr int kPlane = 64 * kLd;  // floats of one staging tile
  const int m0 = blockIdx.x * 64, n0 = blockIdx.y * 64;
  const int c0 = cluster_z(), c_step = clusters_z();
  // the block holds partials [part0, part0 + n_parts) of the `splits`,
  // consecutive K ranges of k_per_split (bf16: one; float32: `sub` where
  // the plan has more partials than a cluster has blocks)
  const int ranks = cluster_blocks();
  const int sub = (splits + ranks - 1) / ranks;
  const int part0 = cluster_rank() * sub;
  const int n_parts = min(sub, splits - part0);
  const int k_begin = part0 * k_per_split;
  const int n_stages =
      stages_of<T>(slices_of(K, k_begin, n_parts * k_per_split));
  const size_t mn = static_cast<size_t>(M) * N;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kWg / 32);
    }
    bar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == kWg) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&map_a))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&map_b))
                 : "memory");
    constexpr int kDepth = kF32 ? kStageK32 : kStageK;
    int g = 0;  // stages filled so far
    for (int c = c0; c < C; c += c_step) {
      for (int i = 0; i < n_stages; ++i, ++g) {
        const int s = g % ring;
        if (g >= ring) bar_wait(&empty[s], (g / ring - 1) & 1);
        uint8_t* st = smem + s * 2 * kBox;
        const int k = k_begin + i * kDepth;
        bar_expect(&full[s], 2 * kBox);
        if (kF32 && kTA) {  // two boxes of 32 M x 32 k
          tma_load(st, &map_a, &full[s], m0, k, c);
          tma_load(st + kBox / 2, &map_a, &full[s], m0 + 32, k, c);
        } else {
          tma_load(st, &map_a, &full[s], kTA ? m0 : k, kTA ? k : m0, c);
        }
        if (kF32 && kTB) {  // two boxes of 32 N x 32 k
          tma_load(st + kBox, &map_b, &full[s], n0, k, c);
          tma_load(st + kBox + kBox / 2, &map_b, &full[s], n0 + 32, k, c);
        } else {
          tma_load(st + kBox, &map_b, &full[s], kTB ? n0 : k, kTB ? k : n0,
                   c);
        }
      }
    }
  } else if (threadIdx.x < kWg) {
    float acc[32];
    int g = 0;  // stages consumed so far
    for (int c = c0, i = 0; c < C; c += c_step, ++i) {
      // config c's epilogue columns (one split), in the slot the previous
      // config's epilogue is not reading
      float* cols_s = col_buf[i % 2];
      if (splits == 1)
        load_cols(cols_s, scale ? scale + c * N : nullptr,
                  shift ? shift + c * N : nullptr, n0, N);
      if constexpr (kF32) {
        const auto raw = [smem](int s, const uint8_t*& ra,
                                const uint8_t*& rb) {
          ra = smem + s * 2 * kBox;
          rb = ra + kBox;
        };
        // each partial from a fresh sum, all but the last staged as they
        // end (k_per_split is whole stages), the pipeline running on
        const auto done = [cs](int u, const float(&a)[32]) {
          stage_wg_acc<64>(a, cs + u * kPlane, kLd, 0);
        };
        consume_tf32<kTA, kTB>(acc, raw, bs, 0, full, empty, ring, n_stages,
                               g, 2, k_per_split / kStageK32, done);
        g += n_stages;
      } else {
        const auto desc = [smem](int s, int j, uint64_t& da, uint64_t& db) {
          const uint8_t* st = smem + s * 2 * kBox;
          da = desc_k<kTA>(st, j);
          db = desc_k<kTB>(st + kBox, j);
        };
        consume<64, kTA, kTB, true>(acc, desc, full, empty, ring,
                                    slices_of(K, k_begin, k_per_split), g);
        g += n_stages;
      }
      // the previous config's epilogue has read cs; split-K: the
      // warpgroup's wgmmas have read the ring
      asm volatile("bar.sync 1, %0;\n" ::"n"(kWg) : "memory");
      stage_wg_acc<64>(acc, cs + (n_parts - 1) * kPlane, kLd, 0);
      if (splits > 1) break;  // the cluster reduces the block's partials
      cp_async_wait<0>();  // this thread's columns have landed
      asm volatile("bar.sync 1, %0;\n" ::"n"(kWg) : "memory");
      const Cols<8> cols =
          store_cols_of<64>(cols_s, cols_s + 64, 0, 64, threadIdx.x);
      store_rows<64, T, kGelu>(cs, kLd, 64, out + c * mn, M, N, m0, n0, cols,
                               act, threadIdx.x, kWg);
    }
  }
  if (splits == 1) return;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial is staged
  const int S = splits;
  const int r = static_cast<int>(cluster.block_rank());
  const int c = c0;
  const int row_lo = r * 64 / ranks, row_hi = (r + 1) * 64 / ranks;
  out += c * mn;
  // thread i sums quad (i % 16) of rows row_lo + i / 16, ... (blockDim.x is
  // a multiple of 16: one column quad per thread, its scale and shift
  // loaded once); partial j sits in tile j % sub of block j / sub, and 16
  // remote loads of a quad are issued at a time before their in-order sum
  const int q4 = (threadIdx.x % 16) * 4;
  const bool vec = N % 4 == 0 && aligned(out, 4 * sizeof(T));
  const Cols<4> quad_cols(scale ? scale + c * N : nullptr,
                          shift ? shift + c * N : nullptr, n0 + q4, N);
  const int nv = N - (n0 + q4) < 4 ? N - (n0 + q4) : 4;
  for (int row = row_lo + static_cast<int>(threadIdx.x) / 16; row < row_hi;
       row += blockDim.x / 16) {
    if (m0 + row >= M || nv <= 0) break;
    float* mine = cs + row * kLd + q4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    // partial j0 + t: tile t % sub of block (j0 + t) / sub (sub a power of
    // two <= 16, so shifts and masks; bf16: 1, one partial a block)
    const int sub_log = __ffs(sub) - 1;
    for (int j0 = 0; j0 < S; j0 += 16) {
      float4 q[16];
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        if (j0 + t < S) {
          const int tile = kF32 ? t & (sub - 1) : 0;
          const int block = kF32 ? (j0 + t) >> sub_log : t;
          q[t] = *cluster.map_shared_rank(
              reinterpret_cast<float4*>(mine + tile * kPlane), block);
        }
      }
#pragma unroll
      for (int t = 0; t < 16; ++t) {  // split order
        if (j0 + t < S) {
          v[0] += q[t].x;
          v[1] += q[t].y;
          v[2] += q[t].z;
          v[3] += q[t].w;
        }
      }
    }
    store_cols<4, T, kGelu>(out, static_cast<size_t>(m0 + row) * N + n0 + q4,
                            v, quad_cols, nv, vec, act);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

}  // namespace hopper

// Internal linkage: each library keeps its own `allowed` flags (a static
// local of an external template would be one symbol across every library
// loaded in the process).
namespace {

template <class ATile, class BTile, int kBN>
int launch(const void* x, const void* w, const float* scale,
           const float* shift, void* out, float* ws, int* counters, int C,
           int M, int N, int K, int act, int splits, int k_per_split,
           cudaStream_t stream) {
  using T = typename ATile::Elem;
  constexpr int smem = gemm_smem_bytes<ATile, BTile, kBN>();
  auto kernel = fused_gemm_kernel<ATile, BTile, kBN>;
  static unsigned allowed = 0;
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel), smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, C * splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, shift,
      static_cast<T*>(out), ws, counters, M, N, K, act, splits, k_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <class T, int kBN>
int launch_layout(const void* x, const void* w, const float* scale,
                  const float* shift, void* out, float* ws, int* counters,
                  int C, int M, int N, int K, int act, int trans_a,
                  int trans_b, int splits, int k_per_split,
                  cudaStream_t stream) {
  if (trans_a) {
    return trans_b ? launch<TransA<T>, TransB<T, kBN>, kBN>(
                         x, w, scale, shift, out, ws, counters, C, M, N, K, act,
                         splits, k_per_split, stream)
                   : launch<TransA<T>, RowMajorB<T, kBN>, kBN>(
                         x, w, scale, shift, out, ws, counters, C, M, N, K, act,
                         splits, k_per_split, stream);
  }
  return trans_b ? launch<RowMajorA<T>, TransB<T, kBN>, kBN>(
                       x, w, scale, shift, out, ws, counters, C, M, N, K, act,
                       splits, k_per_split, stream)
                 : launch<RowMajorA<T>, RowMajorB<T, kBN>, kBN>(
                       x, w, scale, shift, out, ws, counters, C, M, N, K, act,
                       splits, k_per_split, stream);
}

// Checks the plan (C configs of `splits` blocks each along the grid's z, at
// most 65,535; no GELU, which only the wgmma kernel has), then launches the
// instantiation of T for it.
template <class T>
int launch_plan(const void* x, const void* w, const float* scale,
                const float* shift, void* out, float* ws, int* counters,
                int C, int M, int N, int K, int act, int trans_a, int trans_b,
                int tile_n, int splits, int k_per_split, void* stream) {
  const bool plan_ok =
      act != kActGelu && (tile_n == 32 || tile_n == 64) && C >= 1 &&
      splits >= 1 &&
      static_cast<long long>(C) * splits <= 65535 && k_per_split > 0 &&
      static_cast<long long>(splits) * k_per_split >= K &&
      (splits == 1 || (ws != nullptr && counters != nullptr &&
                       k_per_split % kBK == 0 &&
                       static_cast<long long>(splits - 1) * k_per_split < K));
  if (!plan_ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return tile_n == 32
             ? launch_layout<T, 32>(x, w, scale, shift, out, ws, counters, C,
                                    M, N, K, act, trans_a, trans_b, splits,
                                    k_per_split, s)
             : launch_layout<T, 64>(x, w, scale, shift, out, ws, counters, C,
                                    M, N, K, act, trans_a, trans_b, splits,
                                    k_per_split, s);
}


// The TMA instantiation of T (bf16 or float32) for the layout, over C
// configs; the plan is checked by the caller. Tensor maps are encoded per
// call on the host (a few hundred ns) and passed as __grid_constant__
// parameters: 128-byte boxes of 64 rows (K-major, and bf16's MN-major) or,
// for a float32 MN-major operand, of 32 rows of K.
template <class T, bool kTA, bool kTB, bool kGelu = false>
int launch_tma(const void* x, const void* w, const float* scale,
               const float* shift, void* out, int C, int M, int N, int K,
               int act, int splits, int k_per_split, cudaStream_t stream) {
  using hopper::kMaxRing;
  using hopper::make_map;
  constexpr bool kF32 = kIsF32<T>;
  constexpr int kElem = static_cast<int>(sizeof(T));
  constexpr int kDepth = kF32 ? hopper::kStageK32 : hopper::kStageK;
  constexpr int kMNRows = kF32 ? 32 : 64;  // box rows of an MN-major map
  CUtensorMap map_a, map_b;
  cudaError_t err = kTA ? make_map(&map_a, x, K, M, kMNRows, C, kElem)
                        : make_map(&map_a, x, M, K, 64, C, kElem);
  if (err == cudaSuccess)
    err = kTB ? make_map(&map_b, w, K, N, kMNRows, C, kElem)
              : make_map(&map_b, w, N, K, 64, C, kElem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int stages = (min(k_per_split, K) + kDepth - 1) / kDepth;
  // one split: two stages at least, so the producer runs a config ahead;
  // at C = 1 a full ring, whose shared memory holds two blocks an SM (a
  // grid of one block a tile, such as the serving decoder input's 512 tiles,
  // ran faster on an H100 at two blocks an SM than at three); split-K: the
  // partial is staged in the consumed ring
  constexpr int kRingMax = hopper::k1_max_ring(kF32);
  // float32: `sub` partials a block where a cluster of 16 holds fewer
  // blocks than the plan has partials (and a ring of two beside more than
  // four partials' staging tiles)
  const int sub = kF32 ? hopper::k1_sub(splits) : 1;
  const int ranks = (splits + sub - 1) / sub;
  const int ring_max = sub > 4 ? 2 : kRingMax;
  const int ring = splits == 1 && C == 1
                       ? ring_max
                       : max(2, stages < ring_max ? stages : ring_max);
  const int smem = hopper::k1_smem_bytes(ring, splits, kF32, sub);
  auto kernel = hopper::fused_gemm_tma_kernel<T, kTA, kTB, kGelu>;
  static unsigned allowed = 0;
  err = allow_smem(reinterpret_cast<const void*>(kernel),
                   kF32 ? hopper::k1_smem_bytes(2, 2, true, hopper::kMaxSub)
                        : hopper::k1_smem_bytes(kRingMax, 1, false),
                   allowed, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_tiles = (M + 63) / 64, n_tiles = (N + 63) / 64;
  const dim3 block(hopper::kWg + 32);
  T* o = static_cast<T*>(out);
  if (splits == 1) {
    // gridDim.z: the configs' tiles in about one wave of the blocks the
    // card holds at once (cached per device and ring), each block walking
    // C / gridDim.z configs of its tile
    static int resident[32][kMaxRing + 1] = {};
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = dev < 32 ? resident[dev][ring] : 0;
    if (blocks == 0) {
      int sms = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, static_cast<int>(block.x), smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      blocks = sms * max(per_sm, 1);
      if (dev < 32) resident[dev][ring] = blocks;
    }
    const int depth = max(1, blocks / (m_tiles * n_tiles));
    kernel<<<dim3(m_tiles, n_tiles, min(C, depth)), block, smem, stream>>>(
        map_a, map_b, scale, shift, o, C, M, N, K, act, 1, k_per_split,
        ring);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m_tiles, n_tiles, C * ranks);
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ranks;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, map_a, map_b, scale, shift, o, C, M,
                           N, K, act, splits, k_per_split, ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Checks a TMA plan (C configs; bf16 splits <= 16, a cluster of the
// tile's splits; float32 splits <= 128, a cluster of up to 16 blocks of
// k1_sub(splits) partials each; C * blocks <= 65,535; each split whole
// stages of K: a multiple of 64 in bf16, of 32 in float32; GELU in bf16
// with A row-major and B a (K, N) buffer only), then launches the layout's
// instantiation of T.
template <class T>
int launch_tma_plan(const void* x, const void* w, const float* scale,
                    const float* shift, void* out, int C, int M, int N,
                    int K, int act, int trans_a, int trans_b, int splits,
                    int k_per_split, void* stream) {
  constexpr int kDepth = kIsF32<T> ? hopper::kStageK32 : hopper::kStageK;
  const bool plan_ok =
      C >= 1 && K > 0 && splits >= 1 &&
      splits <= (kIsF32<T> ? 16 * hopper::kMaxSub : 16) &&
      static_cast<long long>(C) * splits <= 65535 && k_per_split > 0 &&
      k_per_split % kDepth == 0 &&
      static_cast<long long>(splits) * k_per_split >= K &&
      static_cast<long long>(splits - 1) * k_per_split < K;
  if (!plan_ok) return static_cast<int>(cudaErrorInvalidValue);
  // the kernel's flags say which operand is MN-major: A read from a (K, M)
  // buffer (trans_a), B from a row-major (K, N) one (not trans_b)
  const auto s = static_cast<cudaStream_t>(stream);
  if (act == kActGelu) {
    if constexpr (!kIsF32<T>) {
      if (!trans_a && !trans_b)
        return launch_tma<T, false, true, true>(x, w, scale, shift, out, C,
                                                M, N, K, act, splits,
                                                k_per_split, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (trans_a)
    return trans_b ? launch_tma<T, true, false>(x, w, scale, shift, out, C,
                                                M, N, K, act, splits,
                                                k_per_split, s)
                   : launch_tma<T, true, true>(x, w, scale, shift, out, C, M,
                                               N, K, act, splits,
                                               k_per_split, s);
  return trans_b ? launch_tma<T, false, false>(x, w, scale, shift, out, C, M,
                                               N, K, act, splits,
                                               k_per_split, s)
                 : launch_tma<T, false, true>(x, w, scale, shift, out, C, M,
                                              N, K, act, splits, k_per_split,
                                              s);
}

}  // namespace

}  // namespace satae

extern "C" {

// for c < C, out[c] (M, N) = act((A[c] @ B[c]) * scale[c] + shift[c]), all
// float32, in one launch of the mma.sync loop; a 2-D product is C = 1. A[c]
// is x's slice c, a row-major (M, K) buffer, or with trans_a read as the
// transpose of a row-major (K, M) buffer; B[c] is w's slice c, row-major
// (K, N), or with trans_b the transpose of a row-major (N, K) buffer; out
// holds C contiguous (M, N) slices. scale and shift are C x N, or null (1 /
// 0). One plan for every config: tile_n (32 or 64) columns per tile,
// `splits` K ranges of k_per_split (a multiple of 32) each; with splits >
// 1, ws holds C * splits * M * N floats and counters one zeroed int per
// tile of every config. Launches on `stream` and returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a plan the kernel does not
// take (C * splits above 65,535 among them).
int satae_fused_gemm_batched(const float* x, const float* w,
                             const float* scale, const float* shift,
                             float* out, float* ws, int* counters, int C,
                             int M, int N, int K, int act, int trans_a,
                             int trans_b, int tile_n, int splits,
                             int k_per_split, void* stream) {
  return satae::launch_plan<float>(x, w, scale, shift, out, ws, counters, C,
                                   M, N, K, act, trans_a, trans_b, tile_n,
                                   splits, k_per_split, stream);
}

// satae_fused_gemm_batched with bf16 x, w and out, on the bf16 mma.sync
// loop, for buffers TMA cannot read; scale, shift and the split-K
// workspace stay float32, and out is rounded once (to nearest even) after
// the float32 epilogue.
int satae_fused_gemm_batched_bf16(const __nv_bfloat16* x,
                                  const __nv_bfloat16* w, const float* scale,
                                  const float* shift, __nv_bfloat16* out,
                                  float* ws, int* counters, int C, int M,
                                  int N, int K, int act, int trans_a,
                                  int trans_b, int tile_n, int splits,
                                  int k_per_split, void* stream) {
  return satae::launch_plan<__nv_bfloat16>(
      x, w, scale, shift, out, ws, counters, C, M, N, K, act, trans_a,
      trans_b, tile_n, splits, k_per_split, stream);
}

// satae_fused_gemm_batched_bf16 on wgmma, with TMA loads and a cluster's
// split-K reduction: x and w (C contiguous slices each, in its layouts)
// 16-byte aligned with 16-byte-aligned rows (the wrapper routes other
// buffers to satae_fused_gemm_batched_bf16); config c is the outermost
// coordinate of 3-D tensor maps. The plan: `splits` (<= 16, one cluster
// per tile, C * splits <= 65,535) K ranges of k_per_split (a multiple of
// 64) each, on 64 x 64 tiles, the same for every config; one split runs a
// persistent grid. No workspace. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan or buffer the kernel does not take.
int satae_fused_gemm_batched_bf16_tma(const __nv_bfloat16* x,
                                      const __nv_bfloat16* w,
                                      const float* scale, const float* shift,
                                      __nv_bfloat16* out, int C, int M, int N,
                                      int K, int act, int trans_a,
                                      int trans_b, int splits,
                                      int k_per_split, void* stream) {
  return satae::launch_tma_plan<__nv_bfloat16>(
      x, w, scale, shift, out, C, M, N, K, act, trans_a, trans_b, splits,
      k_per_split, stream);
}

// satae_fused_gemm_batched on wgmma (3xTF32), with TMA loads and a
// cluster's split-K reduction: x and w as satae_fused_gemm_batched_bf16_tma
// takes them (the wrapper routes other buffers to
// satae_fused_gemm_batched). The plan: `splits` (<= 128, one cluster per
// tile of up to 16 blocks of 1, 2, 4 or 8 partials; C * splits <= 65,535)
// K ranges of k_per_split (a multiple of 32) each, on 64 x 64 tiles, the
// same for every config; one split runs a persistent grid. No workspace.
int satae_fused_gemm_batched_tma(const float* x, const float* w,
                                 const float* scale, const float* shift,
                                 float* out, int C, int M, int N, int K,
                                 int act, int trans_a, int trans_b,
                                 int splits, int k_per_split, void* stream) {
  return satae::launch_tma_plan<float>(x, w, scale, shift, out, C, M, N, K,
                                       act, trans_a, trans_b, splits,
                                       k_per_split, stream);
}

const char* satae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
