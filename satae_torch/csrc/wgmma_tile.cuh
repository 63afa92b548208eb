// The main loop of K1 (fused_gemm.cu) and K2 (conv_bn_act.cu) on Hopper's
// own instructions: wgmma.mma_async, TMA (cp.async.bulk.tensor, tile and
// im2col modes) into an mbarrier ring, and the shared-memory layouts both
// of them read. It replaces, for buffers TMA can read, gemm_tile.cuh's
// mma.sync loop. The kernels on it replace satae/kernels/matmul.py:36
// (_mm_kernel) and satae/kernels/conv.py:36 (conv2d_bn_act_infer, whose
// GEMM is that kernel). The files' headers give each shape's bound; in
// bf16 (3.35 TB/s, 989 TFLOP/s) every K1 product of the main paths and
// conv0-2 are bound by bytes, conv3 by operations; in float32 (3xTF32 at
// 495 / 3 = 165 TFLOP/s) K1 and conv0 by bytes, conv1-3 by operations.
// Against the bytes: TMA brings whole tiles with no per-element
// instructions, and outputs leave in 16-byte stores; against the
// operations: wgmma from swizzled shared memory.
//
// bf16. Every stage holds 64 of K. An operand whose K axis is contiguous
// (K-major: a row-major A, an (N, K) B, conv patches) is kept as rows of
// 64 bf16 = 128 bytes; one whose M or N axis is contiguous (MN-major: a
// (K, M) A, a (K, N) B) as rows of one k holding 64 M or N values. Both
// use the 128-byte swizzle (16-byte chunk c of row r stored at chunk c ^
// (r % 8)), which is what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B and
// what conv0's patch build computes itself, in 1024-byte-aligned regions
// (conv patches of 32 channels: 64-byte rows and swizzle, desc64). A wgmma
// reads a 64-wide M or N block of an MN-major operand (one swizzle atom)
// through its transpose bit, so no fragment is packed and no operand is
// copied transposed. Descriptors: K-major, 8-row groups 1024 bytes apart
// (SBO), K step 16 = +32 bytes; MN-major, 8-k groups 1024 bytes apart
// (SBO), MN atoms LBO apart, K step 16 = +2048 bytes.
//
// float32 (3xTF32, wgmma m64nNk8 .tf32). Every stage holds 32 of K, again
// 128-byte rows: a K-major box is 64 rows x 32 floats, an MN-major one two
// boxes of 32 k x 32 M or N floats (4 KB each), 128-byte swizzle. The
// tensor cores read TF32 only K-major from shared memory (the PTX ISA has
// no transpose for .tf32), and 3xTF32 needs each operand split into big =
// tf32_rna(v) and small = tf32_rna(v - big) once per stage anyway, so the
// split pass also lays the operands out for wgmma:
//   A is split in registers: each consumer thread loads its wgmma A
//     fragments (rows 16w + g and + 8, k q and q + 4 of each k8 step: the
//     m16n8k8 layout per warp) from the raw stage in whichever layout TMA
//     landed it, 16 values a stage, and keeps big and small as TF32 bits;
//   B is split into two K-major 128-byte-swizzled tiles (big, small; 8 KB
//     each for 64 rows of N) in shared memory, which the wgmmas read by
//     descriptor: a K-major raw B chunk by chunk in place of offsets, an
//     MN-major one transposed on the way (a warp reads 32 N of one k row:
//     one 128-byte row, no bank conflict; writes 16-byte chunks of 8 rows
//     per phase to 8 distinct chunk columns: none either).
// In K1 the raw stage is released to the producer as soon as it is split,
// so the ring holds only raw tiles (16 KB a stage); its one consumer
// warpgroup keeps two split Bs (32 KB) and two fragment sets and splits
// stage i + 1 while stage i's wgmmas run (consume_tf32). K2's B is the
// weight, the same for every tile of a launch: it is split once per
// launch and TMA brings both halves into each stage, so its two consumer
// warpgroups split only their A fragments (consume_tf32_presplit).
// Operands already rounded to TF32 pass through the tensor cores exactly
// (they ignore the low 13 mantissa bits), so the products are
// gemm_tile.cuh's: per k8 step small*big, big*small, big*big into a
// scratch accumulator whose first product has scale-d 0, one fresh
// accumulator per 32-deep slice (= one stage), added to the running
// float32 sum with a rounded FADD.
//
// Arithmetic: gemm_tile.cuh's, which tests/test_torch_port_kernel_design.py
// emulates. In bf16 each 32-deep slice of K is two m64nNk16 products into a
// scratch accumulator, the first with scale-d 0, so every slice starts from
// zero; the slice is then added to the running float32 sum with a rounded
// FADD. A warpgroup with a 64-wide N issues both slices of a stage into two
// scratch accumulators as one batch, then adds them in order; with 128
// wide, one slice at a time into one scratch accumulator (three 64 x 128
// accumulators would not fit beside two consumer warpgroups), and the
// block's other consumer warpgroup keeps the tensor cores busy while one
// adds. No accumulator is read while a wgmma that writes it is in flight
// (an overlapped form, slice t + 1 issued before slice t is added, made
// ptxas serialise every wgmma: C7514).
//
// Pipeline: a ring of stages with a full and an empty mbarrier each. The
// producer, one thread issuing TMA, waits for an empty stage, fills it and
// arms its full barrier with the bytes to come; a consumer warpgroup waits
// for the full barrier, runs its wgmmas (float32: splits the stage first),
// and each of its warps arrives on the empty barrier once it no longer
// reads the stage.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gemm_tile.cuh"

namespace satae {
namespace hopper {

constexpr int kWg = 128;          // threads of a warpgroup
constexpr int kStageK = 64;       // K of one stage: a 128-byte bf16 row
constexpr int kStageK32 = 32;     // ... and a 128-byte float32 row
constexpr int kBox = 64 * 64 * 2;  // bytes of one 64 x 64 bf16 box, or of
                                   // 64 x 32 floats
constexpr int kMaxRing = 4;       // stages of a ring at most

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---- mbarrier --------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(b)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to the
// async proxy (TMA); a __syncthreads follows.
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(b))
               : "memory");
}

// One arrival that also expects `bytes` of TMA transfers on the barrier.
__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(b)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_addr(b);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// Orders this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) before later async-proxy reads of them (wgmma).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}


// ---- TMA -------------------------------------------------------------------

// The box at coordinates (c0 innermost, c1) of `map` into shared memory at
// dst, completing `bytes` on barrier b; outside the tensor it writes zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* b, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(b)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The same from a 3-D map (make_map with a depth): c2 is the outermost
// coordinate, the buffer of a stack of buffers.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* b, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(b)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The im2col box of `map` (a 4-D NHWC tensor map in im2col mode): pixels
// from input coordinates (w, h, n) on, each shifted by the filter tap (kw,
// kh), channels c.. of each, into shared memory at dst; zeros outside.
__device__ __forceinline__ void tma_load_im2col(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* b, int c, int w,
                                                int h, int n, uint16_t kw,
                                                uint16_t kh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(b)), "r"(c), "r"(w),
      "r"(h), "r"(n), "h"(kw), "h"(kh)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Pins the accumulator registers at this point of the program, so that the
// compiler neither reads them before a wgmma.wait_group nor moves them
// while a wgmma that writes them is in flight.
template <int kRegs>
__device__ __forceinline__ void fence_acc(float (&d)[kRegs]) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t desc128(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// A shared-memory matrix descriptor with the 64-byte swizzle (K-major rows
// of 32 bf16, 8-row groups 512 bytes apart), layout type 2.
__device__ __forceinline__ uint64_t desc64(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 | static_cast<uint64_t>(512 >> 4)
                                              << 32 |
         static_cast<uint64_t>(2) << 62;
}

// The descriptor of K step j (16 of K) of a 64-row (K-major) or MN-major
// region of a stage, whose 64-wide atoms (one TMA box each) lie kBox apart.
template <bool kMN>
__device__ __forceinline__ uint64_t desc_k(const uint8_t* region, int j) {
  return kMN ? desc128(region + 2048 * j, kBox, 1024)
             : desc128(region + 32 * j, 16, 1024);
}

// d (+)= A @ B for one m64n32k16 bf16 product, float32 accumulate;
// kTA / kTB: A / B MN-major in shared memory (wgmma's transpose bits).
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
}

// d (+)= A @ B for one m64n64k16 bf16 product, float32 accumulate;
// kTA / kTB: A / B MN-major in shared memory (wgmma's transpose bits).
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
}

// d (+)= A @ B for one m64n128k16 bf16 product, float32 accumulate;
// kTA / kTB: A / B MN-major in shared memory (wgmma's transpose bits).
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
}

// d (+)= A @ B for one m64n256k16 bf16 product, float32 accumulate (the
// wide K1 of gemm_wide.cu); kTA / kTB as above. B's four 64-wide MN atoms
// lie LBO apart in its descriptor.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
}


template <int kN, int kTA, int kTB>
__device__ __forceinline__ void mma_k16(float (&d)[kN / 2], uint64_t da,
                                        uint64_t db, int scale_d) {
  if constexpr (kN == 32) {
    wgmma_n32<kTA, kTB>(d, da, db, scale_d);
  } else if constexpr (kN == 64) {
    wgmma_n64<kTA, kTB>(d, da, db, scale_d);
  } else {
    static_assert(kN == 128, "wgmma N of 32, 64 or 128");
    wgmma_n128<kTA, kTB>(d, da, db, scale_d);
  }
}

// ---- the consumer's main loop ---------------------------------------------

// Issues 32-deep slice j (0 or 1) of ring stage s -- K steps 2j and 2j + 1
// -- into the scratch accumulator d; the first product has scale-d 0, so
// the slice starts from zero. desc(s, k, da, db) gives the descriptors of
// K step k of stage s.
template <int kN, int kTA, int kTB, class Desc>
__device__ __forceinline__ void issue_slice(float (&d)[kN / 2],
                                            const Desc& desc, int s, int j) {
  uint64_t da, db;
  desc(s, 2 * j, da, db);
  mma_k16<kN, kTA, kTB>(d, da, db, 0);
  desc(s, 2 * j + 1, da, db);
  mma_k16<kN, kTA, kTB>(d, da, db, 1);
}

// acc += d, one rounded float32 add per value, once d's wgmmas completed.
template <int kN>
__device__ __forceinline__ void add_slice(float (&acc)[kN / 2],
                                          float (&d)[kN / 2]) {
  fence_acc(d);
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] += d[i];
}

// acc (this warpgroup's 64 x kN outputs, wgmma's register layout) = the
// sum, in order, of the n_slices 32-deep slices held by the ring's stages
// g0, g0 + 1, ... (counted over the block's life: stage g sits in slot
// g % ring, its use g / ring). With kPair the two slices of a stage go into
// two scratch accumulators in one batch of four wgmmas, then both are
// added; otherwise each slice is issued, awaited and added alone. No
// accumulator is read while a wgmma that writes it may be in flight.
// Each consumer warp arrives once on a stage's empty barrier (its count is
// the consumer warps): one arrival per thread serialised ~0.4 us a stage
// on the barrier's word.
template <int kN, int kTA, int kTB, bool kPair, class Desc>
__device__ __forceinline__ void consume(float (&acc)[kN / 2],
                                        const Desc& desc, uint64_t* full,
                                        uint64_t* empty, int ring,
                                        int n_slices, int g0 = 0) {
  float d0[kN / 2], d1[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = d0[i] = d1[i] = 0.f;
  for (int t = 0; t < n_slices; t += 2) {
    const int g = g0 + t / 2, s = g % ring;
    const bool two = t + 1 < n_slices;
    bar_wait(&full[s], (g / ring) & 1);
    if constexpr (kPair) {
      // both slices of the stage, the second also where K ends inside the
      // stage (its data are zeros there; it is not added): no wgmma sits on
      // a divergent path (ptxas C7520)
      fence_acc(d0);
      fence_acc(d1);
      wgmma_fence();
      issue_slice<kN, kTA, kTB>(d0, desc, s, 0);
      issue_slice<kN, kTA, kTB>(d1, desc, s, 1);
      wgmma_commit();
      wgmma_wait<0>();
      add_slice<kN>(acc, d0);
      if (two) add_slice<kN>(acc, d1);
    } else {
      fence_acc(d0);
      wgmma_fence();
      issue_slice<kN, kTA, kTB>(d0, desc, s, 0);
      wgmma_commit();
      wgmma_wait<0>();
      add_slice<kN>(acc, d0);
      fence_acc(d0);
      wgmma_fence();
      issue_slice<kN, kTA, kTB>(d0, desc, s, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(d0);
      if (two) add_slice<kN>(acc, d0);
    }
    __syncwarp();  // the warp's wgmmas have completed: one arrival a warp
    if (threadIdx.x % 32 == 0) bar_arrive(&empty[s]);
  }
}

// ---- float32: 3xTF32 on wgmma --------------------------------------------

// d (+)= A @ B for one m64n32k8 TF32 product, float32 accumulate, A
// from registers (the warp's m16n8k8 fragment: rows g and g + 8 of its 16,
// k q and q + 4), B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A @ B for one m64n64k8 TF32 product, float32 accumulate, A
// from registers (the warp's m16n8k8 fragment: rows g and g + 8 of its 16,
// k q and q + 4), B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int kN>
__device__ __forceinline__ void mma_k8(float (&d)[kN / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  if constexpr (kN == 32) {
    wgmma_tf32_n32(d, a, db, scale_d);
  } else {
    static_assert(kN == 64, "TF32 wgmma N of 32 or 64");
    wgmma_tf32_n64(d, a, db, scale_d);
  }
}

// Element (r, k) of a raw float32 stage tile as TMA landed it with the
// 128-byte swizzle: K-major, rows r of 32 floats of K; MN-major (kMN),
// boxes of 32 r (4 KB) holding rows k of 32 floats of r.
template <bool kMN>
__device__ __forceinline__ float raw_at(const uint8_t* tile, int r, int k) {
  const int off =
      kMN ? (r >> 5) * 4096 + k * 128 + ((((r & 31) >> 2) ^ (k & 7)) << 4) +
                (r & 3) * 4
          : r * 128 + (((k >> 2) ^ (r & 7)) << 4) + (k & 3) * 4;
  return *reinterpret_cast<const float*>(tile + off);
}

// This thread's wgmma A fragments of a stage (4 k8 steps x 4 values), rows
// row0 + 16 w + g (+ 8) and k 8 j + q (+ 4) of the raw tile, split into
// TF32 big and small.
template <bool kMN>
__device__ __forceinline__ void load_a_tf32(const uint8_t* tile, int row0,
                                            uint32_t (&big)[4][4],
                                            uint32_t (&small)[4][4]) {
  const int t = threadIdx.x % kWg;
  const int r = row0 + 16 * (t / 32) + (t % 32) / 4, q = t % 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32(raw_at<kMN>(tile, r + 8 * (e % 2), 8 * j + q + 4 * (e / 2)),
                 big[j][e], small[j][e]);
}

__device__ __forceinline__ void split_store(uint8_t* big, uint8_t* small,
                                            int off, const float (&v)[4]) {
  uint32_t b[4], s[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(v[e], b[e], s[e]);
  *reinterpret_cast<uint4*>(big + off) = make_uint4(b[0], b[1], b[2], b[3]);
  *reinterpret_cast<uint4*>(small + off) = make_uint4(s[0], s[1], s[2], s[3]);
}

// The raw B of a stage (64 rows of N x 32 of K, K-major or MN-major as TMA
// landed it) split into the K-major 128-byte-swizzled tiles big and small
// (64 x 128 bytes each) by the warpgroup's 128 threads, 4 chunks of 4
// values each. K-major: chunk q of the raw tile is chunk q of both. MN-
// major: chunk (n, c) = k 4c..4c+3 of row n, stored at chunk c ^ (n % 8)
// of row n, is read from 4 rows k of the raw tile; a warp's 32 lanes take
// 32 n of one box at one c.
template <bool kMN>
__device__ __forceinline__ void split_b_tf32(const uint8_t* raw,
                                             uint8_t* big, uint8_t* small) {
  const int t = threadIdx.x % kWg;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = t + kWg * i;
    float v[4];
    if constexpr (kMN) {
      const int n = q & 63, c = q >> 6;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = raw_at<true>(raw, n, 4 * c + e);
      split_store(big, small, n * 128 + ((c ^ (n & 7)) << 4), v);
    } else {
      const float4 f = *reinterpret_cast<const float4*>(raw + 16 * q);
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
      split_store(big, small, 16 * q, v);
    }
  }
}

// Pins A fragment registers at this point of the program, so that they are
// all computed before a wgmma.fence (else ptxas injects warpgroup.arrives
// among the wgmmas that read them, C7519).
template <int kJ>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[kJ][4]) {
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// bar.sync on named barrier `id` by `n` threads.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Loads and splits this warpgroup's A fragments of a raw stage into (ab,
// as), and the stage's raw B into the K-major tiles at bs (big, then small
// 8 KB after), made visible to the wgmmas' async proxy.
template <bool kTA, bool kTB>
__device__ __forceinline__ void split_stage_tf32(const uint8_t* ra,
                                                 const uint8_t* rb, int row0,
                                                 uint32_t (&ab)[4][4],
                                                 uint32_t (&as)[4][4],
                                                 uint8_t* bs) {
  load_a_tf32<kTA>(ra, row0, ab, as);
  split_b_tf32<kTB>(rb, bs, bs + kBox);
  fence_async_smem();
}

// Issues one stage's 4 k8 steps of three m64n64k8 wgmmas (small*big,
// big*small, big*big) into the scratch accumulator d, the first with
// scale-d 0, and commits them; bs holds B's big tile, its small one 8 KB
// after.
__device__ __forceinline__ void issue_stage_tf32(float (&d)[32],
                                                 uint32_t (&ab)[4][4],
                                                 uint32_t (&as)[4][4],
                                                 const uint8_t* bs) {
  fence_frag(ab);
  fence_frag(as);
  fence_acc(d);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t big = desc128(bs + 32 * j, 16, 1024);
    const uint64_t small = desc128(bs + kBox + 32 * j, 16, 1024);
    mma_k8<64>(d, as[j], big, j > 0);
    mma_k8<64>(d, ab[j], small, 1);
    mma_k8<64>(d, ab[j], big, 1);
  }
  wgmma_commit();
}

// acc (this warpgroup's 64 x 64 outputs, wgmma's register layout) = the
// sum, in order, of the n_stages 32-deep stages g0, g0 + 1, ... of the ring
// (counted over the block's life: stage g sits in slot g % ring), as
// partials of `per` stages: at the end of each partial but the last,
// done(u, acc) takes partial u and acc restarts from zero. raw(s, a, b)
// gives the raw A and B tiles of slot s; this warpgroup (K1's one
// consumer) multiplies rows row0.. of A. Software-pipelined over two
// fragment sets and two split-B tiles (bs and bs + 16 KB): while stage i's
// wgmmas run, the warpgroup waits for stage i + 1, splits it
// (split_stage_tf32) into the other set and tile, and releases its raw
// slot to the producer; then it waits for the wgmmas, adds d to acc (one
// rounded FADD per value) and meets at named barrier `bar` (the
// warpgroup's own), after which every split of stage i + 1 is visible and
// every wgmma of stage i has read its tile. No register or tile that an
// in-flight wgmma reads is written, and d is read only after
// wgmma.wait_group.
template <bool kTA, bool kTB, class Raw, class Done>
__device__ __forceinline__ void consume_tf32(float (&acc)[32], const Raw& raw,
                                             uint8_t* bs, int row0,
                                             uint64_t* full, uint64_t* empty,
                                             int ring, int n_stages, int g0,
                                             int bar, int per,
                                             const Done& done) {
  constexpr int kBuf = 2 * kBox;  // one split B: big and small
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = d[i] = 0.f;
  uint32_t ab0[4][4], as0[4][4], ab1[4][4], as1[4][4];
  // waits for stage i and splits it into a set; the warp then releases it
  const auto split = [&](int i, uint32_t(&ab)[4][4], uint32_t(&as)[4][4],
                         uint8_t* tile) {
    const int g = g0 + i, s = g % ring;
    const uint8_t *ra, *rb;
    raw(s, ra, rb);
    bar_wait(&full[s], (g / ring) & 1);
    split_stage_tf32<kTA, kTB>(ra, rb, row0, ab, as, tile);
    __syncwarp();
    if (threadIdx.x % 32 == 0) bar_arrive(&empty[s]);
  };
  // stage i's slice into acc; where it ends a partial, hand acc over
  const auto finish = [&](int i) {
    wgmma_wait<0>();
    add_slice<64>(acc, d);
    if ((i + 1) % per == 0 && i + 1 < n_stages) {
      done((i + 1) / per - 1, acc);
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = 0.f;
    }
    named_sync(bar, kWg);
  };
  if (n_stages > 0) {
    split(0, ab0, as0, bs);
    named_sync(bar, kWg);
  }
  for (int i = 0; i < n_stages; i += 2) {
    issue_stage_tf32(d, ab0, as0, bs);
    if (i + 1 < n_stages) split(i + 1, ab1, as1, bs + kBuf);
    finish(i);
    if (i + 1 < n_stages) {
      issue_stage_tf32(d, ab1, as1, bs + kBuf);
      if (i + 2 < n_stages) split(i + 2, ab0, as0, bs);
      finish(i + 1);
    }
  }
}

// consume_tf32 for a ring whose stages hold B already split (K2: the
// weight's TF32 big and small halves, K-major, by TMA, small kBox after
// big): per stage this warpgroup waits for it, loads and splits its A
// fragments (rows row0.. of the K-major raw A), issues the 12 wgmmas on
// the stage itself, waits for them, adds d to acc and releases the stage
// (each warp, once its wgmmas have read it). Nothing is written to shared
// memory, so no barrier ties the warpgroup to another.
template <class Raw>
__device__ __forceinline__ void consume_tf32_presplit(
    float (&acc)[32], const Raw& raw, int row0, uint64_t* full,
    uint64_t* empty, int ring, int n_stages, int g0) {
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = d[i] = 0.f;
  for (int i = 0; i < n_stages; ++i) {
    const int g = g0 + i, s = g % ring;
    const uint8_t *ra, *rb;
    raw(s, ra, rb);
    bar_wait(&full[s], (g / ring) & 1);
    uint32_t ab[4][4], as[4][4];
    load_a_tf32<false>(ra, row0, ab, as);
    issue_stage_tf32(d, ab, as, rb);
    wgmma_wait<0>();
    add_slice<64>(acc, d);
    __syncwarp();  // the warp's wgmmas have read the stage
    if (threadIdx.x % 32 == 0) bar_arrive(&empty[s]);
  }
}

// Writes a warpgroup's accumulators (rows row0.. of the block's tile) into
// the float32 staging tile cs with row stride ld.
template <int kN>
__device__ __forceinline__ void stage_wg_acc(const float (&acc)[kN / 2],
                                             float* cs, int ld, int row0) {
  const int t = threadIdx.x % kWg;
  const int r = row0 + 16 * (t / 32) + (t % 32) / 4, c = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    *reinterpret_cast<float2*>(cs + r * ld + 8 * j + c) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(cs + (r + 8) * ld + 8 * j + c) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Each thread's kV epilogue columns, loaded once: scale (1 where null or
// past N) and shift (0).
template <int kV>
struct Cols {
  float scale[kV], shift[kV];
  __device__ __forceinline__ Cols(const float* sc, const float* sh, int col,
                                  int N) {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const bool in = col + j < N;
      scale[j] = sc && in ? sc[col + j] : 1.f;
      shift[j] = sh && in ? sh[col + j] : 0.f;
    }
  }
};

// out[off..off + kV) = epilogue(v) in T (float32, or bf16 rounded once to
// nearest even), one store of kV * sizeof(T) bytes (two 16-byte ones for 8
// floats) when `vec` and all kV columns exist (nv == kV), else element by
// element; with kGelu the GELU epilogue (epilogue_t).
template <int kV, class T, bool kGelu = false>
__device__ __forceinline__ void store_cols(T* out, size_t off,
                                           const float (&v)[kV],
                                           const Cols<kV>& cols, int nv,
                                           bool vec, int act) {
  float o[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j)
    o[j] = epilogue_t<kGelu>(v[j], cols.scale[j], cols.shift[j], act);
  if (vec && nv == kV) {
    if constexpr (kIsF32<T>) {
      static_assert(kV == 4 || kV == 8, "16-byte float32 stores");
#pragma unroll
      for (int j = 0; j < kV; j += 4)
        *reinterpret_cast<float4*>(out + off + j) =
            make_float4(o[j], o[j + 1], o[j + 2], o[j + 3]);
    } else {
      uint32_t w[kV / 2];
#pragma unroll
      for (int j = 0; j < kV / 2; ++j) {
        const __nv_bfloat162 h =
            __floats2bfloat162_rn(o[2 * j], o[2 * j + 1]);
        w[j] = *reinterpret_cast<const uint32_t*>(&h);
      }
      if constexpr (kV == 8) {
        *reinterpret_cast<uint4*>(out + off) = make_uint4(w[0], w[1], w[2],
                                                          w[3]);
      } else {
        static_assert(kV == 4, "8- or 16-byte bf16 stores");
        *reinterpret_cast<uint2*>(out + off) = make_uint2(w[0], w[1]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kV; ++j)
      if (j < nv) put(out, off + j, o[j]);
  }
}

// The epilogue columns of thread tid in store_rows<kN>: n0 + (tid % (kN /
// 8)) * 8 onwards. Loaded before the main loop, their latency hides
// behind it.
template <int kN>
__device__ __forceinline__ Cols<8> store_cols_of(const float* scale,
                                                 const float* shift, int n0,
                                                 int N, int tid) {
  return Cols<8>(scale, shift, n0 + (tid % (kN / 8)) * 8, N);
}

// The epilogue of rows [0, rows) x kN columns of the staging tile into out
// (M, N) at (m0, n0), in T, 16 bytes per store where N and out allow, by
// n_threads threads (thread index tid; n_threads a multiple of kN / 8, so
// each thread keeps one column chunk, whose scale and shift `cols` holds:
// store_cols_of); kGelu as store_cols.
template <int kN, class T, bool kGelu = false>
__device__ __forceinline__ void store_rows(const float* cs, int ld, int rows,
                                           T* out, int M, int N, int m0,
                                           int n0, const Cols<8>& cols,
                                           int act, int tid, int n_threads) {
  constexpr int kPerRow = kN / 8;
  const int c = (tid % kPerRow) * 8;
  if (n0 + c >= N) return;
  const int nv = N - (n0 + c) < 8 ? N - (n0 + c) : 8;
  const bool vec = N % (16 / static_cast<int>(sizeof(T))) == 0 &&
                   aligned16(out);
  for (int r = tid / kPerRow; r < rows; r += n_threads / kPerRow) {
    if (m0 + r >= M) break;
    const float4 lo = *reinterpret_cast<const float4*>(cs + r * ld + c);
    const float4 hi = *reinterpret_cast<const float4*>(cs + r * ld + c + 4);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    store_cols<8, T, kGelu>(out, static_cast<size_t>(m0 + r) * N + n0 + c, v,
                            cols, nv, vec, act);
  }
}

// ---- host ------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// A CUDA driver API function reached through the runtime (so the library
// needs no -lcuda); null if the installed CUDA lacks it.
inline void* driver_fn(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t err =
      cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? p : nullptr;
}

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn =
      reinterpret_cast<EncodeTiled>(driver_fn("cuTensorMapEncodeTiled"));
  return fn;
}

inline EncodeIm2col encode_im2col() {
  static EncodeIm2col fn =
      reinterpret_cast<EncodeIm2col>(driver_fn("cuTensorMapEncodeIm2col"));
  return fn;
}

// The tensor-map element type of a bf16 (2-byte) or float32 (4-byte)
// buffer.
inline CUtensorMapDataType map_type(int elem) {
  return elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// The im2col tensor map of an NHWC input (batch, H, W, C) of elements of
// `elem` bytes (2: bf16, 4: float32) for a KH x KW filter with `stride`
// and `pad`: each load brings 128 output pixels' taps, `channels` channels
// each, as 128-byte rows (128-byte swizzle: 64 bf16 or 32 floats) or
// 64-byte ones (64-byte swizzle: 32 bf16), zeros outside the image. C *
// elem must be a multiple of 16 and the base 16-byte aligned.
inline cudaError_t make_im2col_map(CUtensorMap* map, const void* x, int batch,
                                   int H, int W, int C, int KH, int KW,
                                   int stride, int pad, int channels,
                                   int elem = 2) {
  const EncodeIm2col encode = encode_im2col();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * elem,
                                 static_cast<cuuint64_t>(W) * C * elem,
                                 static_cast<cuuint64_t>(H) * W * C * elem};
  // the filter's top-left tap walks [-pad, W + pad - (KW - 1)) in steps of
  // `stride` (and likewise over H): the output pixels
  const int lower[2] = {-pad, -pad};
  const int upper[2] = {pad - (KW - 1), pad - (KH - 1)};
  const cuuint32_t elem_strides[4] = {1, static_cast<cuuint32_t>(stride),
                                      static_cast<cuuint32_t>(stride), 1};
  const CUresult r = encode(
      map, map_type(elem), 4, const_cast<void*>(x), dims, strides, lower,
      upper, static_cast<cuuint32_t>(channels), 128, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      channels * elem == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a row-major (rows, cols) buffer of elements of `elem`
// bytes (2: bf16, 4: float32) read in boxes of 128 bytes of columns (64
// bf16 or 32 floats) x box_rows rows, 128-byte swizzle, zeros outside the
// buffer. With a depth >= 1 the map is 3-D: dims (cols, rows, depth) over
// `depth` contiguous such buffers, strides (row bytes, buffer bytes),
// boxes of one buffer, so a box at a ragged edge never reaches into the
// next buffer. The base and the row stride must be 16-byte aligned (and so
// is the buffer stride, rows row strides).
inline cudaError_t make_map(CUtensorMap* map, const void* p, int rows,
                            int cols, int box_rows, int depth = 0,
                            int elem = 2) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * elem,
                                 static_cast<cuuint64_t>(rows) * cols * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, map_type(elem), depth >= 1 ? 3 : 2, const_cast<void*>(p), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
}  // namespace satae
