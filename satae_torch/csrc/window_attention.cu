// Shifted-window cosine attention of a Swin Transformer V2 block, bf16 in
// and out, the scores, softmax and sums in float32. For each chip, window
// and head, over the 64 tokens of an 8 x 8 window of the rolled token grid:
//   S_ij = (q_i . k_j) * scale_h / (|q_i| |k_j|) + bias_h[i][j]
//          (- 100 where tokens i and j lie in different regions of a
//          shifted window),
//   out_i = sum_j softmax_j(S_ij) v_j,
// with q, k and v the head's 32-wide slices of the block's qkv linear.
//
// Replaces no TPU kernel: the JAX package has no attention. It was added
// for the Swin encoder that serving runs (satae_torch/models/swin.py:
// SatlasPretrain's Swin-v2-B, 24 blocks, heads of 32 over 64-token windows).
//
// No roll, partition or reverse copy exists: qkv is read in place, token
// rows chip by chip in (row, column) order of the unrolled grid, and the
// token at rolled position (y, x) is row ((y + s) mod side, (x + s) mod
// side) of its chip; its output is written to the same row of `out`. So a
// window of the rolled grid reads 64 rows at shifted indices and writes
// them back where they were, which is the roll, partition, reverse and
// inverse roll of torchvision's code.
//
// Bound on an H100: bytes. A window and head does 4 * 64 * 64 * 32 = 0.5
// MFLOP against 12 KB of q, k, v read and 4 KB written (32 FLOP a byte, a
// ninth of the ridge), so the design keeps the loads in flight: a block
// walks the windows of one head, its next window's q, k and v copied by
// cp.async into the second of two buffers while it computes this one. The
// head's bias (64 x 64 float32, folded from the CPB MLP at load time) is
// read once a block into registers, in the layout of the scores each
// thread holds. Blocks of one window's heads are neighbours in the grid,
// so one window's rows are read from L2 by every head at about one time.
//
// Per window, 4 warps of 16 query rows each: S = Q K^T on mma.sync
// m16n8k16 from the raw bf16 q and k (ldmatrix from padded rows, no bank
// conflict), then each row scaled by scale_h / |q_i| and each column by
// 1 / |k_j| in float32 (rounding q / |q| to bf16 first would be multiplied
// by scales of up to 100), the bias and mask added, a float32 softmax in
// registers (quad shuffles), P V on mma.sync with P from the score
// registers in bf16 and V through ldmatrix's transpose, the output divided
// by the row sum and stored through shared memory as 16-byte rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace satae {
namespace swin {

constexpr int kWin = 8;            // window side
constexpr int kTok = kWin * kWin;  // tokens a window
constexpr int kHead = 32;          // head width
constexpr int kWarps = 4;          // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kRow = kHead + 8;    // padded smem row: 80 bytes
constexpr int kMat = kTok * kRow;  // one of q, k, v in a buffer
constexpr int kBlocksPerSm = 3;

struct Geometry {
  int side;    // tokens along a side of the grid
  int nw;      // windows along a side
  int shift;   // the cyclic shift s
  int C;       // the width: heads * 32
  int64_t per_chip;  // windows a chip
};

// Row of token t (0..63) of window w in the unrolled token layout.
__device__ __forceinline__ int64_t token_row(const Geometry& g, int64_t w,
                                             int t) {
  const int64_t chip = w / g.per_chip;
  const int rem = static_cast<int>(w - chip * g.per_chip);
  const int wy = rem / g.nw, wx = rem - wy * g.nw;
  int y = wy * kWin + t / kWin + g.shift;
  int x = wx * kWin + t % kWin + g.shift;
  if (y >= g.side) y -= g.side;
  if (x >= g.side) x -= g.side;
  return (chip * g.side + y) * g.side + x;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Issue the copies of window w's q, k and v of head h into buffer `buf`.
__device__ __forceinline__ void load_window(const Geometry& g,
                                            const __nv_bfloat16* qkv,
                                            __nv_bfloat16* buf, int64_t w,
                                            int h) {
  // 3 matrices x 64 rows x 4 chunks of 16 bytes, 6 a thread
#pragma unroll
  for (int i = 0; i < 3 * kTok * 4 / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int mat = c / (kTok * 4), r = (c / 4) % kTok, part = c % 4;
    const int64_t row = token_row(g, w, r);
    const __nv_bfloat16* src =
        qkv + row * (3 * g.C) + mat * g.C + h * kHead + part * 8;
    cp_async16(buf + mat * kMat + r * kRow + part * 8, src);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Region of local index l (row or column) of a window: 0 away from the
// grid's last window, else 1 before the shift's seam and 2 after it.
__device__ __forceinline__ int region(bool last, int l, int shift) {
  return last ? (l < kWin - shift ? 1 : 2) : 0;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    window_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                            const float* __restrict__ bias,
                            const float* __restrict__ scale,
                            __nv_bfloat16* __restrict__ out, Geometry g,
                            int64_t windows) {
  __shared__ __align__(16) __nv_bfloat16 smem[2][3 * kMat];
  __shared__ float qs[kTok], ks[kTok];
  const int h = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;  // this thread's rows r0, r0 + 8
  const int c0 = (lane % 4) * 2;        // and columns n * 8 + c0 (+1)
  const float sc = scale[h];

  // the head's bias at this thread's scores
  float bb[8][4];
  {
    const float* bh = bias + static_cast<int64_t>(h) * kTok * kTok;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 lo = *reinterpret_cast<const float2*>(
          bh + r0 * kTok + n * 8 + c0);
      const float2 hi = *reinterpret_cast<const float2*>(
          bh + (r0 + 8) * kTok + n * 8 + c0);
      bb[n][0] = lo.x;
      bb[n][1] = lo.y;
      bb[n][2] = hi.x;
      bb[n][3] = hi.y;
    }
  }

  int64_t w = blockIdx.y;
  if (w >= windows) return;
  load_window(g, qkv, smem[0], w, h);
  for (int buf = 0; w < windows; w += gridDim.y, buf ^= 1) {
    const int64_t next = w + gridDim.y;
    if (next < windows) {
      load_window(g, qkv, smem[buf ^ 1], next, h);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    __nv_bfloat16* Qs = smem[buf];
    __nv_bfloat16* Ks = Qs + kMat;
    __nv_bfloat16* Vs = Ks + kMat;
    {  // threads 0-63 the keys' norms, 64-127 the queries'
      const int t = threadIdx.x % kTok;
      const __nv_bfloat16* row = (threadIdx.x < kTok ? Ks : Qs) + t * kRow;
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < kHead; j += 2) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(row + j));
        ss += v.x * v.x + v.y * v.y;
      }
      const float inv = 1.f / fmaxf(sqrtf(ss), 1e-12f);
      if (threadIdx.x < kTok)
        ks[t] = inv;
      else
        qs[t] = sc * inv;
    }
    __syncthreads();

    // S = Q K^T, 16 rows x 64 keys a warp
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHead / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, Qs + (warp * 16 + lane % 16) * kRow + kk * 16 +
                     (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, Ks + (np * 16 + (lane / 16) * 8 + lane % 8) * kRow +
                       kk * 16 + ((lane / 8) % 2) * 8);
        mma(s[2 * np], a, b[0], b[1]);
        mma(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // scale, bias, the shift's mask, and the softmax of rows r0, r0 + 8
    const int rem = static_cast<int>(w % g.per_chip);
    const bool last_y = g.shift > 0 && rem / g.nw == g.nw - 1;
    const bool last_x = g.shift > 0 && rem % g.nw == g.nw - 1;
    const float q0 = qs[r0], q1 = qs[r0 + 8];
    int lab0 = 0, lab1 = 0;
    if (last_y || last_x) {
      lab0 = region(last_y, r0 / kWin, g.shift) * 3 +
             region(last_x, r0 % kWin, g.shift);
      lab1 = region(last_y, (r0 + 8) / kWin, g.shift) * 3 +
             region(last_x, (r0 + 8) % kWin, g.shift);
    }
    float m0 = __int_as_float(0xff800000u), m1 = m0;  // -inf
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + c0 + (e & 1);
        float v = s[n][e] * (e < 2 ? q0 : q1) * ks[col] + bb[n][e];
        if (last_y || last_x) {
          const int lab = region(last_y, col / kWin, g.shift) * 3 +
                          region(last_x, col % kWin, g.shift);
          if (lab != (e < 2 ? lab0 : lab1)) v -= 100.f;
        }
        s[n][e] = v;
      }
      m0 = fmaxf(m0, fmaxf(s[n][0], s[n][1]));
      m1 = fmaxf(m1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    constexpr float kLog2e = 1.4426950408889634f;
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f((s[n][0] - m0) * kLog2e);
      s[n][1] = exp2f((s[n][1] - m0) * kLog2e);
      s[n][2] = exp2f((s[n][2] - m1) * kLog2e);
      s[n][3] = exp2f((s[n][3] - m1) * kLog2e);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }

    // O = P V, 16 rows x 32 a warp, P from the score registers
    float o[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTok / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, Vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kRow +
                         np * 16 + (lane / 16) * 8);
        mma(o[2 * np], a, b[0], b[1]);
        mma(o[2 * np + 1], a, b[2], b[3]);
      }
    }

    // the rows divided by their sums, staged in this warp's own q rows
    // (read by no other warp since the norms), then 16-byte stores
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    __syncwarp();
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      *reinterpret_cast<uint32_t*>(Qs + r0 * kRow + n * 8 + c0) =
          pack_bf16(o[n][0] * i0, o[n][1] * i0);
      *reinterpret_cast<uint32_t*>(Qs + (r0 + 8) * kRow + n * 8 + c0) =
          pack_bf16(o[n][2] * i1, o[n][3] * i1);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = lane + 32 * i;
      const int r = warp * 16 + c / 4, part = c % 4;
      const int64_t row = token_row(g, w, r);
      *reinterpret_cast<uint4*>(out + row * g.C + h * kHead + part * 8) =
          *reinterpret_cast<const uint4*>(Qs + r * kRow + part * 8);
    }
    __syncthreads();  // every warp done with this buffer before its reload
  }
}

}  // namespace swin
}  // namespace satae

extern "C" {

// out (chips * side^2, heads * 32) = the shifted-window cosine attention of
// qkv (chips * side^2, 3 * heads * 32), bias (heads, 64, 64) float32,
// scale (heads,) float32 (exp(min(logit_scale, ln 100))), shift the
// block's cyclic shift (0 or less than 8). bf16 buffers contiguous and
// 16-byte aligned; side a multiple of 8. One launch.
int satae_window_attention_bf16(const void* qkv, const void* bias,
                                const void* scale, void* out, int chips,
                                int side, int heads, int shift,
                                void* stream) {
  using namespace satae::swin;
  if (chips < 1 || side < kWin || side % kWin != 0 || heads < 1 ||
      shift < 0 || shift >= kWin || (shift > 0 && side == kWin))
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  Geometry g;
  g.side = side;
  g.nw = side / kWin;
  g.shift = shift;
  g.C = heads * kHead;
  g.per_chip = static_cast<int64_t>(g.nw) * g.nw;
  const int64_t windows = g.per_chip * chips;
  // about one wave: kBlocksPerSm blocks an SM over all heads
  int64_t groups = (static_cast<int64_t>(sms) * kBlocksPerSm + heads - 1) /
                   heads;
  if (groups > windows) groups = windows;
  if (groups > 65535) groups = 65535;
  const dim3 grid(heads, static_cast<unsigned>(groups));
  window_attention_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), g,
      windows);
  return static_cast<int>(cudaGetLastError());
}

const char* satae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
