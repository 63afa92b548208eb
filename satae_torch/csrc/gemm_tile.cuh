// The GEMM main loop that K1 (fused_gemm.cu) and K2 (conv_bn_act.cu) share:
// one 64 x kBN output tile (kBN = 32 or 64) of out = act((A @ B) * scale +
// shift), float32 in and out, on tensor cores as 3xTF32.
//
// A is (M, K) and B is (K, N) as the product sees them. Each reaches the tile
// through a loader that copies one kBK-deep K slice into a shared-memory
// stage with cp.async (`stage(smem, k0, k_end)`), so one main loop serves
// every operand layout:
//   KMajor<rows>:  a buffer whose K axis is contiguous -- RowMajorA (a
//                  row-major (M, K) A) and TransB (an (N, K) B, an nn.Linear
//                  weight). Shared layout [row][kBK + 4].
//   MNMajor<cols>: a buffer whose M or N axis is contiguous -- TransA (a
//                  row-major (K, M) A) and RowMajorB (a row-major (K, N) B).
//                  Shared layout [k][cols + 8].
//   Im2colA (conv_bn_act.cu): patches gathered from an NHWC image, in
//                  KMajor's shared layout.
// A transposed operand is read in place, never copied. Neighbouring threads
// copy neighbouring 16 bytes of the buffer (4 bytes where the row length or
// the pointer is not a multiple of 16 bytes). Ragged M, N and K edges and a
// split's K range are masked with cp.async's zero-fill form (source size 0),
// not with branches around loads: nothing is padded on the host.
//
// Pipeline: kStages = 3 stages of kBK = 32 in dynamic shared memory (55 KB
// at kBN = 64, so four blocks fit an SM; with four stages three fit, and K2
// ran slower on an H100). The loads of slice i + 2 are in flight
// (cp.async.commit_group / wait_group) while slice i is multiplied.
//
// Math: mma.sync.m16n8k8 TF32 with float32 accumulate. Each operand v is split
// into big = tf32(v) and small = tf32(v - big) (round to nearest, ties away,
// as cvt.rna does) and the tile accumulates small*big + big*small + big*big;
// the small*small term (below 2^-22 relative) is dropped. One TF32 product
// alone misses the port's 1e-4 + 1e-5*|ref| tolerance several times over at
// K = 4096. The tensor cores' float32 accumulation drops the low bits of
// each sum (it does not round to nearest), so an accumulator that runs down
// all of K drifts towards zero, at K = 4096 outside that tolerance on an H100
// (tests/test_torch_port_kernel_design.py models it). Each 32-deep slice therefore goes into fresh
// accumulators, added to the running sum with a rounded float32 add. An input
// of +-inf gives NaN (inf - inf in the split).
//
// Work split: 128 threads, 4 warps as 2 x 2 over the tile; a warp owns 32 x
// kBN/2 outputs, (2 x kBN/16) m16n8 accumulators. The paddings (+4 floats on
// K-major rows, +8 on MN-major rows and on the output staging rows) put the 32
// lanes of every fragment load, and of the accumulators' float2 stores, on 32
// distinct banks, and keep each row 16-byte aligned for cp.async and float4.
//
// Epilogue: the accumulators go through shared memory so that each thread
// then writes 16 consecutive bytes of a row (float4 where N and the pointer
// allow, else 4-byte stores): epilogue.cuh's arithmetic, or, for a split-K
// partial, the raw sums.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "epilogue.cuh"

namespace satae {

constexpr int kBM = 64;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 2;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kKPad = 4;
constexpr int kMNPad = 8;
constexpr int kOutPad = 8;

// ---- PTX ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies 16 bytes, or writes 16 zero bytes and reads nothing when !ok.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Copies 4 bytes, or writes a zero and reads nothing when !ok.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// cvt.rna.tf32.f32 (round to nearest, ties away from zero) on the bits: add
// half of the 13 dropped mantissa bits' range to the magnitude, clear them.
// Equal to the instruction for every finite v; the instruction itself is
// several SASS operations on sm_90 (it screens NaN and inf), these are two.
// A NaN whose payload lies only in the dropped bits becomes inf.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

// d += a @ b for one m16n8k8 TF32 fragment triple, float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- operand loaders -------------------------------------------------------

// Shared layout [row][kBK + kKPad] of a stage whose rows are M (or N) and
// whose columns are K.
template <int kRows>
struct KMajorLayout {
  static constexpr int kLd = kBK + kKPad;
  static constexpr int kSmemFloats = kRows * kLd;
  __device__ static float at(const float* s, int row, int k) {
    return s[row * kLd + k];
  }
};

// A buffer of `rows` rows of length K (K contiguous), rows row0.. of the tile.
template <int kRows>
struct KMajor : KMajorLayout<kRows> {
  using KMajorLayout<kRows>::kLd;
  const float* p;
  int rows, K, row0;
  bool vec;

  __device__ KMajor(const float* __restrict__ p_, int rows_, int K_, int row0_)
      : p(p_), rows(rows_), K(K_), row0(row0_),
        vec(K_ % 4 == 0 && aligned16(p_)) {}

  static_assert(kRows % (kThreads / (kBK / 4)) == 0 &&
                    kRows % (kThreads / kBK) == 0,
                "the threads cover the tile's rows evenly");

  __device__ __forceinline__ void stage(float* s, int k0, int k_end) const {
    const int tid = threadIdx.x;
    if (vec) {  // 8 threads copy one row's 32 floats; K % 4 == 0
      constexpr int kStep = kThreads / (kBK / 4);
      const int kc = (tid % (kBK / 4)) * 4;
      const int k = k0 + kc;
#pragma unroll
      for (int i = 0; i < kRows / kStep; ++i) {
        const int r = tid / (kBK / 4) + kStep * i;
        const bool ok = row0 + r < rows && k < k_end;
        cp_async16(s + r * kLd + kc,
                   ok ? p + static_cast<size_t>(row0 + r) * K + k : p, ok);
      }
    } else {  // a warp copies one row's 32 floats
      constexpr int kStep = kThreads / kBK;
      const int kk = tid % kBK;
      const int k = k0 + kk;
#pragma unroll
      for (int i = 0; i < kRows / kStep; ++i) {
        const int r = tid / kBK + kStep * i;
        const bool ok = row0 + r < rows && k < k_end;
        cp_async4(s + r * kLd + kk,
                  ok ? p + static_cast<size_t>(row0 + r) * K + k : p, ok);
      }
    }
  }
};

// A (K, cols) row-major buffer (cols contiguous), columns col0.. of the tile,
// staged as [k][kCols + kMNPad].
template <int kCols>
struct MNMajor {
  static constexpr int kLd = kCols + kMNPad;
  static constexpr int kSmemFloats = kBK * kLd;
  __device__ static float at(const float* s, int col, int k) {
    return s[k * kLd + col];
  }
  static_assert(kBK % (kThreads / (kCols / 4)) == 0 &&
                    kBK % (kThreads / kCols) == 0,
                "the threads cover the slice's k evenly");
  const float* p;
  int cols, col0;
  bool vec;

  __device__ MNMajor(const float* __restrict__ p_, int cols_, int /*K*/,
                     int col0_)
      : p(p_), cols(cols_), col0(col0_),
        vec(cols_ % 4 == 0 && aligned16(p_)) {}

  __device__ __forceinline__ void stage(float* s, int k0, int k_end) const {
    const int tid = threadIdx.x;
    if (vec) {  // kCols / 4 threads copy one k's row of the tile
      constexpr int kPerRow = kCols / 4;
      constexpr int kStep = kThreads / kPerRow;
      const int c = (tid % kPerRow) * 4;
      const bool col_ok = col0 + c < cols;
#pragma unroll
      for (int i = 0; i < kBK / kStep; ++i) {
        const int kr = tid / kPerRow + kStep * i;
        const int k = k0 + kr;
        const bool ok = col_ok && k < k_end;
        cp_async16(s + kr * kLd + c,
                   ok ? p + static_cast<size_t>(k) * cols + col0 + c : p, ok);
      }
    } else {
      constexpr int kStep = kThreads / kCols;
      const int c = tid % kCols;
      const bool col_ok = col0 + c < cols;
#pragma unroll
      for (int i = 0; i < kBK / kStep; ++i) {
        const int kr = tid / kCols + kStep * i;
        const int k = k0 + kr;
        const bool ok = col_ok && k < k_end;
        cp_async4(s + kr * kLd + c,
                  ok ? p + static_cast<size_t>(k) * cols + col0 + c : p, ok);
      }
    }
  }
};

// ---- main loop -------------------------------------------------------------

template <int kBN>
struct Frag {
  static constexpr int kWR = kBM / kWarpsM;  // rows per warp
  static constexpr int kWC = kBN / kWarpsN;  // columns per warp
  static constexpr int kMT = kWR / 16;  // m16 tiles per warp
  static constexpr int kNT = kWC / 8;   // n8 tiles per warp
  float acc[kMT][kNT][4];
};

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB only
// after this call), once per device; `allowed` is the kernel's own bit set.
inline cudaError_t allow_smem(const void* kernel, int bytes,
                              unsigned& allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 32 || (allowed >> dev & 1u)) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed |= 1u << dev;
  return err;
}

template <int kBN>
__device__ __forceinline__ void zero(Frag<kBN>& f) {
#pragma unroll
  for (int mt = 0; mt < Frag<kBN>::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Frag<kBN>::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) f.acc[mt][nt][e] = 0.f;
}

template <class ATile, class BTile>
__host__ __device__ constexpr int stage_floats() {
  return ATile::kSmemFloats + BTile::kSmemFloats;
}

// Dynamic shared memory of one block: the stage ring, which the output
// staging tile reuses after the last slice.
template <class ATile, class BTile, int kBN>
__host__ __device__ constexpr int smem_bytes() {
  return 4 * (kStages * stage_floats<ATile, BTile>() > kBM * (kBN + kOutPad)
                  ? kStages * stage_floats<ATile, BTile>()
                  : kBM * (kBN + kOutPad));
}

// Multiplies one staged slice into the warp's accumulators.
template <class ATile, class BTile, int kBN>
__device__ __forceinline__ void mma_slice(const float* As, const float* Bs,
                                          Frag<kBN>& f) {
  constexpr int kMT = Frag<kBN>::kMT, kNT = Frag<kBN>::kNT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = (warp % kWarpsM) * Frag<kBN>::kWR;
  const int wc = (warp / kWarpsM) * Frag<kBN>::kWC;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    uint32_t a_big[kMT][4], a_small[kMT][4], b_big[kNT][2], b_small[kNT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int r = wr + mt * 16 + g;
      split_tf32(ATile::at(As, r, kk + t), a_big[mt][0], a_small[mt][0]);
      split_tf32(ATile::at(As, r + 8, kk + t), a_big[mt][1], a_small[mt][1]);
      split_tf32(ATile::at(As, r, kk + t + 4), a_big[mt][2], a_small[mt][2]);
      split_tf32(ATile::at(As, r + 8, kk + t + 4), a_big[mt][3],
                 a_small[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int c = wc + nt * 8 + g;
      split_tf32(BTile::at(Bs, c, kk + t), b_big[nt][0], b_small[nt][0]);
      split_tf32(BTile::at(Bs, c, kk + t + 4), b_big[nt][1], b_small[nt][1]);
    }
    // term by term, so that kMT * kNT independent products separate two
    // that update the same accumulator
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        mma_tf32(f.acc[mt][nt], a_small[mt], b_big[nt]);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        mma_tf32(f.acc[mt][nt], a_big[mt], b_small[nt]);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        mma_tf32(f.acc[mt][nt], a_big[mt], b_big[nt]);
  }
}

// Accumulates A[:, k_begin:k_end] @ B[k_begin:k_end, :] into f over the ring
// of stages in `smem`. Ends with every copy landed and the ring free.
template <class ATile, class BTile, int kBN>
__device__ __forceinline__ void mainloop(const ATile& a, const BTile& b,
                                         float* smem, int k_begin, int k_end,
                                         Frag<kBN>& f) {
  zero(f);
  constexpr int kStage = stage_floats<ATile, BTile>();
  const int n_k = (k_end - k_begin + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) {
      float* st = smem + s * kStage;
      a.stage(st, k_begin + s * kBK, k_end);
      b.stage(st + ATile::kSmemFloats, k_begin + s * kBK, k_end);
    }
    cp_async_commit();
  }
  for (int it = 0; it < n_k; ++it) {
    cp_async_wait<kStages - 2>();  // slice it has landed (this thread's part)
    __syncthreads();  // ... everyone's part; slice it - 1's stage is free
    const int next = it + kStages - 1;
    if (next < n_k) {
      float* st = smem + (next % kStages) * kStage;
      a.stage(st, k_begin + next * kBK, k_end);
      b.stage(st + ATile::kSmemFloats, k_begin + next * kBK, k_end);
    }
    cp_async_commit();
    // the slice's products in fresh accumulators, then one rounded float32
    // add into the running sum (see the header)
    Frag<kBN> slice;
    zero(slice);
    const float* st = smem + (it % kStages) * kStage;
    mma_slice<ATile, BTile, kBN>(st, st + ATile::kSmemFloats, slice);
#pragma unroll
    for (int mt = 0; mt < Frag<kBN>::kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < Frag<kBN>::kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) f.acc[mt][nt][e] += slice.acc[mt][nt][e];
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ---- epilogue --------------------------------------------------------------

// Writes the accumulators into the staging tile [kBM][kBN + kOutPad] that
// reuses the ring (free after mainloop), and waits for the whole tile.
template <int kBN>
__device__ __forceinline__ void stage_acc(const Frag<kBN>& f, float* Cs) {
  constexpr int kLd = kBN + kOutPad;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = (warp % kWarpsM) * Frag<kBN>::kWR;
  const int wc = (warp / kWarpsM) * Frag<kBN>::kWC;
#pragma unroll
  for (int mt = 0; mt < Frag<kBN>::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Frag<kBN>::kNT; ++nt) {
      const int r = wr + mt * 16 + g, c = wc + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(Cs + r * kLd + c) =
          make_float2(f.acc[mt][nt][0], f.acc[mt][nt][1]);
      *reinterpret_cast<float2*>(Cs + (r + 8) * kLd + c) =
          make_float2(f.acc[mt][nt][2], f.acc[mt][nt][3]);
    }
  __syncthreads();
}

// Visits the tile's valid outputs four columns at a time: fn(row, col, n_valid)
// with each thread on 16 consecutive bytes of a row, a row's threads adjacent.
template <int kBN, class Fn>
__device__ __forceinline__ void for_tile_quads(int M, int N, int m0, int n0,
                                               Fn fn) {
  constexpr int kPerRow = kBN / 4;
  constexpr int kStep = kThreads / kPerRow;
  const int c = (threadIdx.x % kPerRow) * 4;
  if (n0 + c >= N) return;
  const int nv = N - (n0 + c) < 4 ? N - (n0 + c) : 4;
#pragma unroll
  for (int i = 0; i < kBM / kStep; ++i) {
    const int r = threadIdx.x / kPerRow + kStep * i;
    if (m0 + r < M) fn(r, c, nv);
  }
}

__device__ __forceinline__ float col_scale(const float* scale, int col) {
  return scale ? scale[col] : 1.f;
}
__device__ __forceinline__ float col_shift(const float* shift, int col) {
  return shift ? shift[col] : 0.f;
}

// out[m0.., n0..] = epilogue(v) of four consecutive values v of a row.
__device__ __forceinline__ void store_quad(float* out, size_t off, int col,
                                           const float (&v)[4], int nv,
                                           bool vec, const float* scale,
                                           const float* shift, int act) {
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = j < nv ? epilogue(v[j], col_scale(scale, col + j),
                             col_shift(shift, col + j), act)
                  : 0.f;
  if (vec && nv == 4) {
    *reinterpret_cast<float4*>(out + off) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nv) out[off + j] = o[j];
  }
}

// The tile's epilogue from the staging tile straight to out (M, N).
template <int kBN>
__device__ __forceinline__ void store_tile(const float* Cs, float* out, int M,
                                           int N, int m0, int n0,
                                           const float* scale,
                                           const float* shift, int act) {
  constexpr int kLd = kBN + kOutPad;
  const bool vec = N % 4 == 0 && aligned16(out);
  for_tile_quads<kBN>(M, N, m0, n0, [&](int r, int c, int nv) {
    const float* s = Cs + r * kLd + c;
    const float v[4] = {s[0], s[1], s[2], s[3]};
    store_quad(out, static_cast<size_t>(m0 + r) * N + n0 + c, n0 + c, v, nv,
               vec, scale, shift, act);
  });
}

}  // namespace satae
