// Attention of a ViT block: out = softmax(q k^T / sqrt(64)) v per chip and
// head, over all of the chip's tokens (non-causal), bf16 operands and
// output, the scores, the softmax and the sums in float32.
//
// Replaces no TPU kernel: the JAX package has no attention (its models are
// the notebook's convolutional autoencoder and MLP). It was added for the
// ViT encoder that serving runs as a frozen feature extractor
// (satae_torch/models/vit.py, Prithvi-EO-1.0-100M's: 589 tokens, 12 heads
// of 64), whose attention no other kernel of the port computes.
//
// Input: qkv, the (B * L, 3 * H * 64) bf16 output of the block's qkv
// linear (K1), read in place: token row r holds q of head h at columns
// [h * 64, h * 64 + 64), k at H * 64 + h * 64, v at 2 * H * 64 + h * 64
// (timm's reshape (B, L, 3, H, 64)). Output: (B * L, H * 64) bf16, the
// heads side by side, which the block's proj linear reads as it is.
//
// Bound on an H100 (bf16 at 989 TFLOP/s dense, 3.35 TB/s): per chip and
// block at L = 589, 4 * L * L * 64 * 12 = 1.07 GFLOP (1.08 us) against 3.6
// MB read once and written once (1.08 us): at the ridge, so the kernel has
// to keep the tensor cores fed and read qkv about once. At d = 64 the
// softmax's exponentials (one per score: L^2 a head) cost the MUFU units
// about as long as the products cost the tensor cores, so they have to run
// under the products rather than between them.
//
// Design: FlashAttention-3's forward for sm_90a.
//   - A block walks tiles of 128 query rows of one (chip, head), the query
//     tile fastest, so the ceil(L / 128) tiles of a (chip, head) run side by
//     side and read its K and V from L2 after the first read; the grid is
//     one block an SM (persistent), so a block's next tile loads while its
//     last one finishes.
//   - Warp-specialised: one producer thread issues TMA loads from a 3-D
//     tensor map of qkv (64 columns x 128 rows x 1 chip boxes, 128-byte
//     swizzle; the map's per-chip bound zero-fills rows >= L, so no chip
//     reads its neighbour's tokens): Q into two buffers (the next tile's
//     while this one runs), K and V into a ring of kRing stages, each with
//     a full and an empty mbarrier (wgmma_tile.cuh's protocol). setmaxnreg
//     moves registers from the producer warpgroup (40) to the two consumer
//     warpgroups (232), which take 64 query rows each.
//   - S = Q K^T: wgmma m64n128k16 over d = 64 in four steps, Q and K both
//     K-major from their TMA tiles, nothing transposed.
//   - The online softmax in the accumulator registers: the row max over the
//     quad, exp2 with the 1/8 * log2 e scale folded into one FFMA
//     (ex2.approx.ftz), the row sums, the rescale of O. Keys >= L are
//     masked to -inf; the tile that holds them (the last, 589 = 4 * 128 +
//     77) is taken first, so the mask sits in the peeled first iteration.
//   - O += P V: P rounded to bf16 in registers, whose accumulator layout is
//     wgmma's A-fragment layout, fed as A from registers (wgmma_n64_rs); V
//     read straight from its [key][d] TMA tile as an MN-major B through
//     wgmma's transpose bit. No transposed copy of V exists.
//   - Overlap: the two consumer warpgroups take turns on named barriers
//     (ping-pong), so one issues its products while the other runs its
//     softmax; within a warpgroup, S_{j+1} = Q K_{j+1}^T is issued before
//     the softmax of S_j runs, and P_{j} V_{j} beside it.
//   - The output: O times 1/l, rounded once to bf16 into a 64 x 64 staging
//     box per warpgroup (swizzled), written by a TMA store over a 3-D map
//     of out that leaves out rows >= L.
//
// Arithmetic: S, the softmax, the sums and O in float32; P rounded once to
// bf16 before P V, l summed from the unrounded P; the keys walked in the
// same order by every block, no split across blocks, so two calls are
// bitwise equal. chip_smoke.py --vit holds it to one bf16 ulp + 2^-8 sum_j
// p_j |v_j| + 1e-6 of the plain version.
//
// Built without --use_fast_math: the division stays accurate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_tile.cuh"

namespace satae {
namespace vit {

using hopper::kWg;

constexpr int kD = 64;                  // head size
constexpr int kBQ = 128;                // query rows a tile
constexpr int kBK = 128;                // keys a K or V stage
constexpr int kRing = 3;                // K and V stages
constexpr int kConsumers = 2;           // consumer warpgroups, 64 rows each
constexpr int kThreads = (kConsumers + 1) * kWg;
constexpr int kTileBytes = kBQ * kD * 2;  // a Q, K or V box: 16 KB
constexpr int kOutBox = 64 * kD * 2;      // a warpgroup's output box: 8 KB
// shared memory from a 1024-byte-aligned base: two Q buffers, the K and V
// rings, the output boxes; 145 KB with the alignment slack
constexpr int kKAt = 2 * kTileBytes;
constexpr int kVAt = kKAt + kRing * kTileBytes;
constexpr int kOAt = kVAt + kRing * kTileBytes;
constexpr int kSmem = kOAt + kConsumers * kOutBox + 1024;
// named barriers: 1 + w, warpgroup w's turn to issue its products; 3 + w,
// warpgroup w's output box
constexpr int kPing = 1;
constexpr int kEpi = 3;

// 2^x (MUFU.EX2, flushing subnormals; relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two float32 values rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// bar.arrive on named barrier `id` of `n` threads: counts this thread and
// goes on.
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The 64 x 64 box of shared memory at src (128-byte swizzle) into the 3-D
// tensor of `map` at (c0 innermost, c1, c2), as one bulk async group of this
// thread's; TMA leaves out what lies outside the tensor.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Waits until none of this thread's bulk async groups reads shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Tile t of the launch: query rows q0.. of head h of chip `chip`, the query
// tile fastest.
struct Tile {
  int q0, h, chip;
  __device__ __forceinline__ Tile(long long t, int n_q, int H) {
    const long long rest = t / n_q;
    q0 = static_cast<int>(t - rest * n_q) * kBQ;
    h = static_cast<int>(rest % H);
    chip = static_cast<int>(rest / H);
  }
};

// The key tile taken j-th: the last one (which holds the keys >= L, if
// any) first, then the others in order.
__device__ __forceinline__ int key_tile(int j, int n_kt) {
  return j == 0 ? n_kt - 1 : j - 1;
}

// S = Q K^T of this warpgroup's 64 rows against a stage's 128 keys: four
// m64n128k16 wgmmas, Q and K K-major; committed, not awaited.
__device__ __forceinline__ void issue_s(float (&s)[64], const uint8_t* q,
                                        const uint8_t* k) {
  hopper::fence_acc(s);
  hopper::wgmma_fence();
#pragma unroll
  for (int j = 0; j < kD / 16; ++j)
    hopper::wgmma_n128<0, 0>(s, hopper::desc_k<false>(q, j),
                             hopper::desc_k<false>(k, j), j > 0);
  hopper::wgmma_commit();
  hopper::fence_acc(s);
}

// O += P V over a stage's 128 keys: eight m64n64k16 wgmmas, P from
// registers, V MN-major from its [key][d] tile; committed, not awaited.
__device__ __forceinline__ void issue_pv(float (&o)[32], uint32_t (&p)[8][4],
                                         const uint8_t* v) {
  hopper::fence_acc(o);
  hopper::fence_frag(p);
  hopper::wgmma_fence();
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j)
    hopper::wgmma_n64_rs<1>(o, p[j], hopper::desc_k<true>(v, j), 1);
  hopper::wgmma_commit();
  hopper::fence_acc(o);
}

// The online softmax of one stage's scores, in place: s becomes P =
// 2^((s - m) / 8 * log2 e) with m the running row max; a is the factor
// that takes the earlier O and l to the new max (1 on the first stage), l
// this thread's share of the row sums. Index 0 is the thread's row g, 1
// its row g + 8 (wgmma's accumulator layout: s[4j + e] is row g + 8 (e /
// 2), column 8j + 2 (lane % 4) + e % 2).
template <bool kFirst>
__device__ __forceinline__ void softmax(float (&s)[64], float (&m)[2],
                                        float (&l)[2], float (&a)[2]) {
  constexpr float kScale = 0.125f * 1.44269504088896341f;  // log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kFirst ? -INFINITY : m[r];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = quad_max(mx);  // finite: every stage holds a key < L
    a[r] = kFirst ? 1.f : ex2((m[r] - mx) * kScale);
    m[r] = mx;
    const float shift = -mx * kScale;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[4 * j + 2 * r] = ex2(fmaf(s[4 * j + 2 * r], kScale, shift));
      s[4 * j + 2 * r + 1] = ex2(fmaf(s[4 * j + 2 * r + 1], kScale, shift));
      sum += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
    }
    l[r] = kFirst ? sum : l[r] * a[r] + sum;
  }
}

// P as wgmma's A fragments, rounded to bf16: k step j (keys 16j..16j+15)
// holds accumulator columns 2j and 2j + 1.
__device__ __forceinline__ void to_frags(const float (&s)[64],
                                         uint32_t (&p)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    p[j][0] = pack(s[8 * j], s[8 * j + 1]);
    p[j][1] = pack(s[8 * j + 2], s[8 * j + 3]);
    p[j][2] = pack(s[8 * j + 4], s[8 * j + 5]);
    p[j][3] = pack(s[8 * j + 6], s[8 * j + 7]);
  }
}

__device__ __forceinline__ void rescale(float (&o)[32], const float (&a)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[4 * j] *= a[0];
    o[4 * j + 1] *= a[0];
    o[4 * j + 2] *= a[1];
    o[4 * j + 3] *= a[1];
  }
}

// One warp's arrival on an empty barrier, once its wgmmas have read the
// buffer.
__device__ __forceinline__ void release(uint64_t* b) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hopper::bar_arrive(b);
}

// For each tile t = blockIdx.x, + gridDim.x, ... of the n_tiles (query tile,
// head, chip): out[rows, head] = softmax(q k^T / 8) v. Threads 0-255 are the
// two consumer warpgroups (query rows 64 w.. of the tile), thread 256 the
// producer.
__global__ void __launch_bounds__(kThreads, 1)
    attention_kernel(const __grid_constant__ CUtensorMap map_qkv,
                     const __grid_constant__ CUtensorMap map_out, int L,
                     int H, long long n_tiles) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full[2], q_empty[2], k_full[kRing],
      k_empty[kRing], v_full[kRing], v_empty[kRing];
  uint8_t* smem = align1024(smem_raw);
  constexpr int kConsumerWarps = kConsumers * kWg / 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      bar_init(&q_full[i], 1);
      bar_init(&q_empty[i], kConsumerWarps);
    }
    for (int i = 0; i < kRing; ++i) {
      bar_init(&k_full[i], 1);
      bar_init(&k_empty[i], kConsumerWarps);
      bar_init(&v_full[i], 1);
      bar_init(&v_empty[i], kConsumerWarps);
    }
    bar_init_fence();
  }
  __syncthreads();
  const int n_kt = (L + kBK - 1) / kBK;  // key tiles, and query tiles
  const int wg = static_cast<int>(threadIdx.x) / kWg;
  if (wg == kConsumers) {
    // the producer warpgroup hands its registers to the consumers; one
    // thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers * kWg) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_qkv))
                   : "memory");
      const int E = H * kD;
      int g = 0;   // K and V stages filled so far
      int it = 0;  // tiles of this block so far
      for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
        const Tile tile(t, n_kt, H);
        const int qb = it % 2;
        if (it >= 2) bar_wait(&q_empty[qb], (it / 2 - 1) & 1);
        bar_expect(&q_full[qb], kTileBytes);
        tma_load(smem + qb * kTileBytes, &map_qkv, &q_full[qb],
                 tile.h * kD, tile.q0, tile.chip);
        for (int j = 0; j < n_kt; ++j, ++g) {
          const int s = g % kRing, k0 = key_tile(j, n_kt) * kBK;
          const uint32_t used = (g / kRing - 1) & 1;
          if (g >= kRing) bar_wait(&k_empty[s], used);
          bar_expect(&k_full[s], kTileBytes);
          tma_load(smem + kKAt + s * kTileBytes, &map_qkv, &k_full[s],
                   E + tile.h * kD, k0, tile.chip);
          if (g >= kRing) bar_wait(&v_empty[s], used);
          bar_expect(&v_full[s], kTileBytes);
          tma_load(smem + kVAt + s * kTileBytes, &map_qkv, &v_full[s],
                   2 * E + tile.h * kD, k0, tile.chip);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int t = static_cast<int>(threadIdx.x) % kWg;
    // this thread's rows of the warpgroup's 64 (wgmma's accumulator
    // layout) and its column pair
    const int row = 16 * (t / 32) + (t % 32) / 4, col = 2 * (t % 4);
    uint8_t* box = smem + kOAt + wg * kOutBox;
    // warpgroup 0 issues first
    if (wg == 1) named_arrive(kPing, 2 * kWg);
    int g = 0;  // K and V stages consumed so far
    int it = 0;
    for (long long tt = blockIdx.x; tt < n_tiles; tt += gridDim.x, ++it) {
      const Tile tile(tt, n_kt, H);
      const int qb = it % 2;
      const uint8_t* q = smem + qb * kTileBytes + wg * (64 * 128);
      float s[64], o[32], m[2], l[2], a[2];
      uint32_t p[8][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      bar_wait(&q_full[qb], (it / 2) & 1);
      // the first key tile, the one that holds the keys >= L
      {
        const int st = g % kRing;
        bar_wait(&k_full[st], (g / kRing) & 1);
        named_sync(kPing + wg, 2 * kWg);
        issue_s(s, q, smem + kKAt + st * kTileBytes);
        named_arrive(kPing + 1 - wg, 2 * kWg);
        wgmma_wait<0>();
        fence_acc(s);
        release(&k_empty[st]);
        const int k0 = (n_kt - 1) * kBK;
        if (k0 + kBK > L) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int key = k0 + 8 * j + col;
            if (key >= L) s[4 * j] = s[4 * j + 2] = -INFINITY;
            if (key + 1 >= L) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
          }
        }
        softmax<true>(s, m, l, a);
        to_frags(s, p);
      }
      // S_j issued before the softmax of S_j runs, beside P_{j-1} V_{j-1}
      for (int j = 1; j < n_kt; ++j) {
        const int sk = (g + j) % kRing, sv = (g + j - 1) % kRing;
        bar_wait(&k_full[sk], ((g + j) / kRing) & 1);
        named_sync(kPing + wg, 2 * kWg);
        issue_s(s, q, smem + kKAt + sk * kTileBytes);
        rescale(o, a);
        bar_wait(&v_full[sv], ((g + j - 1) / kRing) & 1);
        issue_pv(o, p, smem + kVAt + sv * kTileBytes);
        named_arrive(kPing + 1 - wg, 2 * kWg);
        wgmma_wait<1>();  // S_j
        fence_acc(s);
        release(&k_empty[sk]);
        softmax<false>(s, m, l, a);
        wgmma_wait<0>();  // P_{j-1} V_{j-1}
        fence_acc(o);
        fence_frag(p);
        release(&v_empty[sv]);
        to_frags(s, p);
      }
      // the last P V
      {
        const int sv = (g + n_kt - 1) % kRing;
        rescale(o, a);
        bar_wait(&v_full[sv], ((g + n_kt - 1) / kRing) & 1);
        issue_pv(o, p, smem + kVAt + sv * kTileBytes);
        wgmma_wait<0>();
        fence_acc(o);
        release(&v_empty[sv]);
        release(&q_empty[qb]);
        g += n_kt;
      }
      // O / l, rounded once to bf16, into the box (16-byte chunk c of row r
      // at c ^ (r % 8), as TMA reads it), then out by one TMA store that
      // leaves out rows >= L
      const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
      if (t == 0) bulk_wait_read();  // the last tile's store has read it
      named_sync(kEpi + wg, kWg);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = row + 8 * e;
          *reinterpret_cast<uint32_t*>(box + r * 128 + ((j ^ (r % 8)) << 4) +
                                       2 * col) =
              pack(o[4 * j + 2 * e] * inv[e], o[4 * j + 2 * e + 1] * inv[e]);
        }
      fence_async_smem();  // the writes, before TMA reads them
      named_sync(kEpi + wg, kWg);
      if (t == 0 && tile.q0 + 64 * wg < L)
        tma_store(&map_out, box, tile.h * kD, tile.q0 + 64 * wg, tile.chip);
    }
    // the last store has read its box before the block leaves
    if (t == 0) bulk_wait_read();
  }
}

}  // namespace vit
}  // namespace satae

extern "C" {

// out (B * L, H * 64) = attention over the L tokens of each of B chips, H
// heads of 64, from qkv (B * L, 3 * H * 64); both bf16, 16-byte aligned,
// contiguous. One launch of one block an SM (or one a tile, if fewer)
// walking the ceil(L / 128) * H * B query tiles; tensor maps encoded per
// call on the host.
int satae_attention_bf16(const void* qkv, void* out, int B, int L, int H,
                         void* stream) {
  using namespace satae::vit;
  using satae::hopper::make_map;
  if (B < 1 || B > 65535 || L < 1 || H < 1 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_qkv, map_out;
  cudaError_t err = make_map(&map_qkv, qkv, L, 3 * H * kD, kBQ, B);
  if (err == cudaSuccess) err = make_map(&map_out, out, L, H * kD, 64, B);
  if (err != cudaSuccess) return static_cast<int>(err);
  static unsigned allowed = 0;
  err = satae::allow_smem(reinterpret_cast<const void*>(attention_kernel),
                          kSmem, allowed);
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
  const long long tiles =
      static_cast<long long>((L + kBQ - 1) / kBQ) * H * B;
  const unsigned grid =
      static_cast<unsigned>(tiles < n_sm ? tiles : n_sm);
  attention_kernel<<<grid, kThreads, kSmem,
                     static_cast<cudaStream_t>(stream)>>>(map_qkv, map_out,
                                                          L, H, tiles);
  return static_cast<int>(cudaGetLastError());
}

const char* satae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
