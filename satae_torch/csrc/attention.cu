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
// [h * 64, h * 64 + 64), k at 3 * ... + H * 64 + h * 64, v at 2 * H * 64 +
// h * 64 (timm's reshape (B, L, 3, H, 64)). Output: (B * L, H * 64) bf16,
// the heads side by side, which the block's proj linear reads as it is.
//
// Bound on an H100 (bf16 at 989 TFLOP/s dense, 3.35 TB/s): per chip and
// block at L = 589, 4 * L * L * 64 * 12 = 1.07 GFLOP (1.08 us) against 3.6
// MB read once and written once (1.08 us): at the ridge.
//
// Design: FlashAttention-2's forward on mma.sync (m16n8k16, bf16 in,
// float32 accumulate). Block (q tile, head, chip): 4 warps, 16 query rows
// each, 64 query rows a block. The Q tile is staged once and held in
// registers as A fragments. The keys are walked in tiles of 64: K staged
// row-major [key][d] and V transposed [d][key], both padded to 72 elements
// a row so that every fragment load of a quad-row pattern hits 32 distinct
// banks. S = Q K^T per warp (16 x 64, float32), masked to -inf at keys >=
// L (the tail tile of 589 = 9 * 64 + 13), the online softmax in float32
// (running row max and sum, exp2 of the scaled difference), P rounded to
// bf16 straight from the S accumulators into A fragments, O += P V. The
// scores never leave registers. One pass over K and V per 64 query rows;
// no wgmma, no TMA, no double buffering (several blocks an SM hide the
// loads), which later work can add.
//
// Built without --use_fast_math: exp2f and the division stay accurate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace satae {
namespace vit {

constexpr int kD = 64;      // head size
constexpr int kBQ = 64;     // query rows a block
constexpr int kBK = 64;     // keys a tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = kD + 8;  // padded row of a staged tile, elements

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// elements k and k + 1 (k even) of a staged row, as one fragment register
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

__global__ void __launch_bounds__(kThreads)
    attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                     __nv_bfloat16* __restrict__ out, int L, int H) {
  __shared__ __align__(16) __nv_bfloat16 qs[kBQ * kLd];
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * kLd];
  __shared__ __align__(16) __nv_bfloat16 vt[kD * kLd];  // [d][key]
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y;
  const int E = H * kD;
  const size_t stride = 3 * static_cast<size_t>(E);  // a token's qkv row
  const __nv_bfloat16* base =
      qkv + static_cast<size_t>(blockIdx.z) * L * stride + h * kD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // the Q tile, rows past L zero: 8 vectors of 8 a row, a row's 128 bytes
  // read by 8 consecutive threads
  for (int i = tid; i < kBQ * 8; i += kThreads) {
    const int r = i / 8, c = (i % 8) * 8;
    uint4 v = zero;
    if (q0 + r < L)
      v = __ldg(reinterpret_cast<const uint4*>(base + (q0 + r) * stride + c));
    *reinterpret_cast<uint4*>(qs + r * kLd + c) = v;
  }
  __syncthreads();
  // this warp's 16 rows as A fragments, 4 slices of 16 of d
  uint32_t qa[4][4];
  const int wr = warp * 16;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const __nv_bfloat16* p = qs + (wr + g) * kLd + kc * 16 + 2 * t;
    qa[kc][0] = pair(p);
    qa[kc][1] = pair(p + 8 * kLd);
    qa[kc][2] = pair(p + 8);
    qa[kc][3] = pair(p + 8 * kLd + 8);
  }

  // scores scaled by 1/8, in log2 units
  const float sl2 = 0.125f * 1.44269504088896341f;
  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  // rows g (lo) and g + 8 (hi) of the warp's 16: running max and the
  // thread's share of the running sum
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  for (int k0 = 0; k0 < L; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    // K as it is, coalesced as the Q tile
    for (int i = tid; i < kBK * 8; i += kThreads) {
      const int r = i / 8, c = (i % 8) * 8;
      uint4 v = zero;
      if (k0 + r < L)
        v = __ldg(reinterpret_cast<const uint4*>(base + (k0 + r) * stride +
                                                 E + c));
      *reinterpret_cast<uint4*>(ks + r * kLd + c) = v;
    }
    // V transposed: consecutive threads take consecutive keys, so each
    // warp's 2-byte stores fill consecutive words of one d row
    for (int i = tid; i < kBK * 8; i += kThreads) {
      const int r = i % kBK, c = (i / kBK) * 8;
      uint4 v = zero;
      if (k0 + r < L)
        v = __ldg(reinterpret_cast<const uint4*>(base + (k0 + r) * stride +
                                                 2 * E + c));
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c + j) * kLd + r] = e[j];
    }
    __syncthreads();

    // S = Q K^T: 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* p = ks + (nt * 8 + g) * kLd + 2 * t;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        mma_bf16(s[nt], qa[kc], pair(p + kc * 16), pair(p + kc * 16 + 8));
    }
    if (k0 + kBK > L) {  // the tail: keys past L count for nothing
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int key = k0 + nt * 8 + 2 * t;
        if (key >= L) s[nt][0] = s[nt][2] = -INFINITY;
        if (key + 1 >= L) s[nt][1] = s[nt][3] = -INFINITY;
      }
    }
    // the online softmax: the new row max (finite: key k0 < L is real)
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    const float a_lo = exp2f((m_lo - mx_lo) * sl2);  // 0 on the first tile
    const float a_hi = exp2f((m_hi - mx_hi) * sl2);
    m_lo = mx_lo;
    m_hi = mx_hi;
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f((s[nt][0] - m_lo) * sl2);
      s[nt][1] = exp2f((s[nt][1] - m_lo) * sl2);
      s[nt][2] = exp2f((s[nt][2] - m_hi) * sl2);
      s[nt][3] = exp2f((s[nt][3] - m_hi) * sl2);
      rs_lo += s[nt][0] + s[nt][1];
      rs_hi += s[nt][2] + s[nt][3];
    }
    l_lo = l_lo * a_lo + rs_lo;
    l_hi = l_hi * a_hi + rs_hi;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      o[dt][0] *= a_lo;
      o[dt][1] *= a_lo;
      o[dt][2] *= a_hi;
      o[dt][3] *= a_hi;
    }
    // O += P V: P's A fragments from S tiles 2 kc and 2 kc + 1 (keys 16 kc
    // .. 16 kc + 15), V^T's rows as B fragments
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t pa[4] = {pack(s[2 * kc][0], s[2 * kc][1]),
                              pack(s[2 * kc][2], s[2 * kc][3]),
                              pack(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        const __nv_bfloat16* p = vt + (dt * 8 + g) * kLd + kc * 16 + 2 * t;
        mma_bf16(o[dt], pa, pair(p), pair(p + 8));
      }
    }
  }

  const float inv_lo = 1.f / quad_sum(l_lo);
  const float inv_hi = 1.f / quad_sum(l_hi);
  const int row_lo = q0 + wr + g, row_hi = row_lo + 8;
  __nv_bfloat16* o_lo = out +
                        (static_cast<size_t>(blockIdx.z) * L + row_lo) * E +
                        h * kD + 2 * t;
  __nv_bfloat16* o_hi = o_lo + 8 * static_cast<size_t>(E);
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    if (row_lo < L)
      *reinterpret_cast<uint32_t*>(o_lo + dt * 8) =
          pack(o[dt][0] * inv_lo, o[dt][1] * inv_lo);
    if (row_hi < L)
      *reinterpret_cast<uint32_t*>(o_hi + dt * 8) =
          pack(o[dt][2] * inv_hi, o[dt][3] * inv_hi);
  }
}

}  // namespace vit
}  // namespace satae

extern "C" {

// out (B * L, H * 64) = attention over the L tokens of each of B chips, H
// heads of 64, from qkv (B * L, 3 * H * 64); both bf16, 16-byte aligned,
// contiguous. One launch, blocks (ceil(L / 64), H, B).
int satae_attention_bf16(const void* qkv, void* out, int B, int L, int H,
                         void* stream) {
  using namespace satae::vit;
  if (B < 1 || B > 65535 || L < 1 || H < 1 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((L + kBQ - 1) / kBQ, H, B);
  attention_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<__nv_bfloat16*>(out), L, H);
  return static_cast<int>(cudaGetLastError());
}

const char* satae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
