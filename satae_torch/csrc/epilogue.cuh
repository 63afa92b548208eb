// The GEMM epilogue that both hand-written kernels share, in float32 for
// float32 and bf16 operands alike:
//   out = act(acc * scale[col] + shift[col])
// It is the epilogue of satae/kernels/matmul.py::_mm_kernel. A plain linear
// layer is scale = 1, shift = bias; an eval-mode BatchNorm folds into
// scale = gamma * rsqrt(var + eps),
// shift = beta - mean * scale (+ bias * scale). A bf16 output is rounded
// once, after the activation (gemm_tile.cuh's store).
//
// Built without --use_fast_math: expf and erff stay the accurate libdevice
// routines, so the sigmoid matches torch.sigmoid and the GELU (the exact erf
// form, x * (1 + erf(x / sqrt(2))) / 2, ViT's MLP) torch's gelu to float32
// rounding.
#pragma once

namespace satae {

enum Act : int { kActNone = 0, kActRelu = 1, kActSigmoid = 2, kActGelu = 3 };

__device__ __forceinline__ float epilogue(float acc, float scale, float shift,
                                          int act) {
  float v = acc * scale + shift;
  if (act == kActRelu) {
    v = v < 0.f ? 0.f : v;  // NaN passes through, as in torch.relu
  } else if (act == kActSigmoid) {
    v = 1.f / (1.f + expf(-v));
  }
  return v;
}

// The epilogue of an instantiation that serves `act` == kActGelu (kGelu: the
// wgmma K1 of bf16 operands, fused_gemm.cu) or one of the others. The GELU
// is compiled only where kGelu is set: inlined into every unrolled store of
// the wgmma K1 for all activations, it lengthened that kernel's small
// launches by 0.5-0.8 us and the batched bf16 ones by up to 21 % on an H100,
// whatever their activation.
template <bool kGelu>
__device__ __forceinline__ float epilogue_t(float acc, float scale,
                                            float shift, int act) {
  if constexpr (kGelu) {
    const float v = acc * scale + shift;
    return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  } else {
    return epilogue(acc, scale, shift, act);
  }
}

}  // namespace satae
