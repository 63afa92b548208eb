// The GEMM main loop that K1 (fused_gemm.cu) and K2 (conv_bn_act.cu) share:
// one 64 x kBN output tile (kBN = 32 or 64) of out = act((A @ B) * scale +
// shift), with the operands and the output in T -- float32, on tensor cores
// as 3xTF32, or bf16 -- and the accumulators, scale, shift and epilogue in
// float32.
//
// A is (M, K) and B is (K, N) as the product sees them. Each reaches the tile
// through a loader that copies one kBK-deep K slice into a shared-memory
// stage with cp.async (`stage(smem, k0, k_end)`), so one main loop serves
// every operand layout:
//   KMajor<T, rows>:  a buffer whose K axis is contiguous -- RowMajorA (a
//                  row-major (M, K) A) and TransB (an (N, K) B, an nn.Linear
//                  weight). Shared layout [row][kBK + 16 bytes].
//   MNMajor<T, cols>: a buffer whose M or N axis is contiguous -- TransA (a
//                  row-major (K, M) A) and RowMajorB (a row-major (K, N) B).
//                  Shared layout [k][cols + 8].
//   Im2colA (conv_bn_act.cu): patches gathered from an NHWC image, in
//                  KMajor's shared layout.
// A transposed operand is read in place, never copied. Neighbouring threads
// copy neighbouring 16 bytes of the buffer where the row length and the
// pointer allow, else 4 bytes, else (bf16 only: an odd row length or an odd
// element offset) 2 bytes. cp.async has no 2-byte size, so those go through
// a register: an ld.global.u16 and a st.shared, zero for a masked element.
// Ragged M, N and K edges and a split's K range are masked with cp.async's
// zero-fill form (source size 0), not with branches around loads: nothing is
// padded on the host.
//
// Pipeline: kStages = 3 stages of kBK = 32 in dynamic shared memory (55 KB
// at kBN = 64 in float32, so four blocks fit an SM; with four stages three
// fit, and K2 ran slower on an H100; bf16 stages are half the bytes). The
// loads of slice i + 2 are in flight (cp.async.commit_group / wait_group)
// while slice i is multiplied.
//
// Math, float32: mma.sync.m16n8k8 TF32 with float32 accumulate. Each operand
// v is split into big = tf32(v) and small = tf32(v - big) (round to nearest,
// ties away, as cvt.rna does) and the tile accumulates small*big + big*small
// + big*big; the small*small term (below 2^-22 relative) is dropped. One TF32
// product alone misses the port's 1e-4 + 1e-5*|ref| tolerance several times
// over at K = 4096. An input of +-inf gives NaN (inf - inf in the split).
// Math, bf16: mma.sync.m16n8k16 bf16 with float32 accumulate, two k16 steps
// per slice and one product per step (a bf16 product is exact in float32).
// A bf16 fragment register holds two consecutive K values; from an MN-major
// stage they sit in two shared rows and are packed from two 16-bit loads.
// Both: the tensor cores' float32 accumulation drops the low bits of each
// sum (it does not round to nearest), so an accumulator that runs down all of
// K drifts towards zero, at K = 4096 outside the float32 tolerance on an
// H100 (tests/test_torch_port_kernel_design.py models it). Each 32-deep
// slice therefore goes into fresh accumulators, added to the running sum
// with a rounded float32 add. bf16 keeps the same fresh accumulator per
// slice: in that test's emulation at K = 4096 one accumulator stays within
// one bf16 ulp of satae's kernel but ~0.4 % of its outputs round the other
// way, while per slice every output there is bit-equal to satae's.
//
// Work split: 128 threads, 4 warps as 2 x 2 over the tile; a warp owns 32 x
// kBN/2 outputs, (2 x kBN/16) m16n8 accumulators. The paddings (16 bytes on
// K-major rows, 8 elements on MN-major rows and on the output staging rows)
// put the 32 lanes of every fragment load, and of the accumulators' float2
// stores, on 32 distinct banks (two lanes that read one 32-bit word of an
// MN-major bf16 row share it), and keep each row 16-byte aligned for
// cp.async and 16-byte stores.
//
// Epilogue: the float32 accumulators go through shared memory so that each
// thread then writes 16 consecutive bytes of a row (4 floats or 8 bf16 where
// N and the pointer allow, else one element at a time): epilogue.cuh's
// arithmetic in float32, then one rounding to T (round to nearest even,
// __float2bfloat16_rn, as .to(torch.bfloat16) rounds), or, for a split-K
// partial, the raw float32 sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "epilogue.cuh"

namespace satae {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 2;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMNPad = 8;
constexpr int kOutPad = 8;

template <class T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

// ---- PTX ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies 16 bytes, or writes 16 zero bytes and reads nothing when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Copies 4 bytes, or writes zeros and reads nothing when !ok.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// Copies 2 bytes through a register (cp.async has no 2-byte size), or
// writes a zero and reads nothing when !ok.
__device__ __forceinline__ void copy2(void* dst, const void* src, bool ok) {
  const unsigned short v = ok ? *static_cast<const unsigned short*>(src) : 0;
  *static_cast<unsigned short*>(dst) = v;
}

template <int kBytes>
__device__ __forceinline__ void copy(void* dst, const void* src, bool ok) {
  if constexpr (kBytes == 16) {
    cp_async16(dst, src, ok);
  } else if constexpr (kBytes == 4) {
    cp_async4(dst, src, ok);
  } else {
    static_assert(kBytes == 2, "copies of 16, 4 or 2 bytes");
    copy2(dst, src, ok);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return aligned(p, 16);
}

// The bytes of one copy for a buffer of T whose copied rows hold `row_len`
// elements: 16 where every row start stays 16-byte aligned, else 4 where it
// stays 4-byte aligned, else 2 (bf16 only).
template <class T>
__device__ __forceinline__ int copy_bytes(int row_len, const void* p) {
  constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));
  if (row_len % kPer16 == 0 && aligned16(p)) return 16;
  if (kIsF32<T> || (row_len % 2 == 0 && aligned(p, 4))) return 4;
  return 2;
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

// d += a @ b for one m16n8k16 bf16 fragment triple, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- operand loaders -------------------------------------------------------

// Shared layout [row][kBK + 16 bytes] of a stage whose rows are M (or N) and
// whose columns are K.
template <class T, int kRows>
struct KMajorLayout {
  using Elem = T;
  static constexpr int kLd = kBK + 16 / static_cast<int>(sizeof(T));
  static constexpr int kSmemElems = kRows * kLd;
  __device__ static T at(const T* s, int row, int k) {
    return s[row * kLd + k];
  }
  // elements k and k + 1 of a row (k even) as one bf16 fragment register
  __device__ static uint32_t pair(const T* s, int row, int k) {
    return *reinterpret_cast<const uint32_t*>(s + row * kLd + k);
  }
};

// A buffer of `rows` rows of length K (K contiguous), rows row0.. of the tile.
template <class T, int kRows>
struct KMajor : KMajorLayout<T, kRows> {
  using KMajorLayout<T, kRows>::kLd;
  const T* p;
  int rows, K, row0, bytes;

  __device__ KMajor(const T* __restrict__ p_, int rows_, int K_, int row0_)
      : p(p_), rows(rows_), K(K_), row0(row0_),
        bytes(copy_bytes<T>(K_, p_)) {}

  // kThreads / (kBK / w) threads cover a row's kBK elements in copies of w
  template <int kBytes>
  __device__ __forceinline__ void stage_w(T* s, int k0, int k_end) const {
    constexpr int kW = kBytes / static_cast<int>(sizeof(T));
    constexpr int kPerRow = kBK / kW;
    constexpr int kStep = kThreads / kPerRow;
    static_assert(kRows % kStep == 0, "the threads cover the tile's rows");
    const int kc = (threadIdx.x % kPerRow) * kW;
    const int k = k0 + kc;
#pragma unroll
    for (int i = 0; i < kRows / kStep; ++i) {
      const int r = threadIdx.x / kPerRow + kStep * i;
      const bool ok = row0 + r < rows && k < k_end;
      copy<kBytes>(s + r * kLd + kc,
                   ok ? p + static_cast<size_t>(row0 + r) * K + k : p, ok);
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

// A (K, cols) row-major buffer (cols contiguous), columns col0.. of the tile,
// staged as [k][kCols + kMNPad].
template <class T, int kCols>
struct MNMajor {
  using Elem = T;
  static constexpr int kLd = kCols + kMNPad;
  static constexpr int kSmemElems = kBK * kLd;
  __device__ static T at(const T* s, int col, int k) {
    return s[k * kLd + col];
  }
  // elements k and k + 1 (k even) of a column, from two shared rows, as one
  // bf16 fragment register: the lower k in the lower half
  __device__ static uint32_t pair(const T* s, int col, int k) {
    const auto* h = reinterpret_cast<const unsigned short*>(s);
    return static_cast<uint32_t>(h[k * kLd + col]) |
           static_cast<uint32_t>(h[(k + 1) * kLd + col]) << 16;
  }
  const T* p;
  int cols, col0, bytes;

  __device__ MNMajor(const T* __restrict__ p_, int cols_, int /*K*/,
                     int col0_)
      : p(p_), cols(cols_), col0(col0_), bytes(copy_bytes<T>(cols_, p_)) {}

  // kCols / w threads copy one k's row of the tile in copies of w
  template <int kBytes>
  __device__ __forceinline__ void stage_w(T* s, int k0, int k_end) const {
    constexpr int kW = kBytes / static_cast<int>(sizeof(T));
    constexpr int kPerRow = kCols / kW;
    constexpr int kStep = kThreads / kPerRow;
    static_assert(kBK % kStep == 0, "the threads cover the slice's k");
    const int c = (threadIdx.x % kPerRow) * kW;
    const bool col_ok = col0 + c < cols;
#pragma unroll
    for (int i = 0; i < kBK / kStep; ++i) {
      const int kr = threadIdx.x / kPerRow + kStep * i;
      const int k = k0 + kr;
      const bool ok = col_ok && k < k_end;
      copy<kBytes>(s + kr * kLd + c,
                   ok ? p + static_cast<size_t>(k) * cols + col0 + c : p, ok);
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
__host__ __device__ constexpr int stage_elems() {
  return ATile::kSmemElems + BTile::kSmemElems;
}

// Bytes of the stage ring.
template <class ATile, class BTile>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * stage_elems<ATile, BTile>() *
         static_cast<int>(sizeof(typename ATile::Elem));
}

// Dynamic shared memory of one block: the stage ring, which the float32
// output staging tile reuses after the last slice.
template <class ATile, class BTile, int kBN>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes<ATile, BTile>() > 4 * kBM * (kBN + kOutPad)
             ? ring_bytes<ATile, BTile>()
             : 4 * kBM * (kBN + kOutPad);
}

// Multiplies one staged slice into the warp's accumulators.
template <class ATile, class BTile, int kBN>
__device__ __forceinline__ void mma_slice(const typename ATile::Elem* As,
                                          const typename ATile::Elem* Bs,
                                          Frag<kBN>& f) {
  constexpr int kMT = Frag<kBN>::kMT, kNT = Frag<kBN>::kNT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = (warp % kWarpsM) * Frag<kBN>::kWR;
  const int wc = (warp / kWarpsM) * Frag<kBN>::kWC;
  if constexpr (kIsF32<typename ATile::Elem>) {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t a_big[kMT][4], a_small[kMT][4], b_big[kNT][2], b_small[kNT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int r = wr + mt * 16 + g;
        split_tf32(ATile::at(As, r, kk + t), a_big[mt][0], a_small[mt][0]);
        split_tf32(ATile::at(As, r + 8, kk + t), a_big[mt][1],
                   a_small[mt][1]);
        split_tf32(ATile::at(As, r, kk + t + 4), a_big[mt][2],
                   a_small[mt][2]);
        split_tf32(ATile::at(As, r + 8, kk + t + 4), a_big[mt][3],
                   a_small[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int c = wc + nt * 8 + g;
        split_tf32(BTile::at(Bs, c, kk + t), b_big[nt][0], b_small[nt][0]);
        split_tf32(BTile::at(Bs, c, kk + t + 4), b_big[nt][1],
                   b_small[nt][1]);
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
  } else {
    // m16n8k16 fragments: a row-major A's (g, 2t..2t+1), (g + 8, ..),
    // (g, 2t+8..), (g + 8, 2t+8..); a column-major B's (2t..2t+1, g),
    // (2t+8.., g)
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int r = wr + mt * 16 + g;
        a[mt][0] = ATile::pair(As, r, kk + 2 * t);
        a[mt][1] = ATile::pair(As, r + 8, kk + 2 * t);
        a[mt][2] = ATile::pair(As, r, kk + 2 * t + 8);
        a[mt][3] = ATile::pair(As, r + 8, kk + 2 * t + 8);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int c = wc + nt * 8 + g;
        b[nt][0] = BTile::pair(Bs, c, kk + 2 * t);
        b[nt][1] = BTile::pair(Bs, c, kk + 2 * t + 8);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_bf16(f.acc[mt][nt], a[mt], b[nt]);
    }
  }
}

// Accumulates A[:, k_begin:k_end] @ B[k_begin:k_end, :] into f over the ring
// of stages in `smem`. Ends with every copy landed and the ring free.
template <class ATile, class BTile, int kBN>
__device__ __forceinline__ void mainloop(const ATile& a, const BTile& b,
                                         typename ATile::Elem* smem,
                                         int k_begin, int k_end,
                                         Frag<kBN>& f) {
  using T = typename ATile::Elem;
  static_assert(std::is_same<T, typename BTile::Elem>::value,
                "A and B of one type");
  zero(f);
  constexpr int kStage = stage_elems<ATile, BTile>();
  const int n_k = (k_end - k_begin + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) {
      T* st = smem + s * kStage;
      a.stage(st, k_begin + s * kBK, k_end);
      b.stage(st + ATile::kSmemElems, k_begin + s * kBK, k_end);
    }
    cp_async_commit();
  }
  for (int it = 0; it < n_k; ++it) {
    cp_async_wait<kStages - 2>();  // slice it has landed (this thread's part)
    __syncthreads();  // ... everyone's part; slice it - 1's stage is free
    const int next = it + kStages - 1;
    if (next < n_k) {
      T* st = smem + (next % kStages) * kStage;
      a.stage(st, k_begin + next * kBK, k_end);
      b.stage(st + ATile::kSmemElems, k_begin + next * kBK, k_end);
    }
    cp_async_commit();
    // the slice's products in fresh accumulators, then one rounded float32
    // add into the running sum (see the header)
    Frag<kBN> slice;
    zero(slice);
    const T* st = smem + (it % kStages) * kStage;
    mma_slice<ATile, BTile, kBN>(st, st + ATile::kSmemElems, slice);
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

// Visits the tile's valid outputs kV columns at a time: fn(row, col,
// n_valid) with each thread on kV consecutive outputs of a row, a row's
// threads adjacent.
template <int kBN, int kV, class Fn>
__device__ __forceinline__ void for_tile_vecs(int M, int N, int m0, int n0,
                                              Fn fn) {
  constexpr int kPerRow = kBN / kV;
  constexpr int kStep = kThreads / kPerRow;
  const int c = (threadIdx.x % kPerRow) * kV;
  if (n0 + c >= N) return;
  const int nv = N - (n0 + c) < kV ? N - (n0 + c) : kV;
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

__device__ __forceinline__ void put(float* out, size_t i, float v) {
  out[i] = v;
}
__device__ __forceinline__ void put(bf16* out, size_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

// out[off..off + kV) = epilogue(v) of kV consecutive values v of a row, one
// store of 4 * kV (float32) or 2 * kV (bf16) bytes when `vec` and the row
// has them all, else one element at a time.
template <class T, int kV>
__device__ __forceinline__ void store_vec(T* out, size_t off, int col,
                                          const float (&v)[kV], int nv,
                                          bool vec, const float* scale,
                                          const float* shift, int act) {
  float o[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j)
    o[j] = j < nv ? epilogue(v[j], col_scale(scale, col + j),
                             col_shift(shift, col + j), act)
                  : 0.f;
  if (vec && nv == kV) {
    if constexpr (kIsF32<T>) {
      static_assert(kV == 4, "float4 stores");
      *reinterpret_cast<float4*>(out + off) =
          make_float4(o[0], o[1], o[2], o[3]);
    } else {
      static_assert(kV == 4 || kV == 8, "8- or 16-byte bf16 stores");
      uint32_t w[kV / 2];
#pragma unroll
      for (int j = 0; j < kV / 2; ++j) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * j], o[2 * j + 1]);
        w[j] = *reinterpret_cast<const uint32_t*>(&h);
      }
      if constexpr (kV == 8) {
        *reinterpret_cast<uint4*>(out + off) = make_uint4(w[0], w[1], w[2],
                                                          w[3]);
      } else {
        *reinterpret_cast<uint2*>(out + off) = make_uint2(w[0], w[1]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kV; ++j)
      if (j < nv) put(out, off + j, o[j]);
  }
}

// The tile's epilogue from the staging tile straight to out (M, N), 16 bytes
// of T per store.
template <int kBN, class T>
__device__ __forceinline__ void store_tile(const float* Cs, T* out, int M,
                                           int N, int m0, int n0,
                                           const float* scale,
                                           const float* shift, int act) {
  constexpr int kLd = kBN + kOutPad;
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  const bool vec = N % kV == 0 && aligned16(out);
  for_tile_vecs<kBN, kV>(M, N, m0, n0, [&](int r, int c, int nv) {
    const float* s = Cs + r * kLd + c;
    float v[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) v[j] = s[j];
    store_vec<T, kV>(out, static_cast<size_t>(m0 + r) * N + n0 + c, n0 + c,
                     v, nv, vec, scale, shift, act);
  });
}

}  // namespace satae
