// The GEMM epilogue that both hand-written kernels share, in float32 for
// float32 and bf16 operands alike:
//   out = act(acc * scale[col] + shift[col])
// It is the epilogue of satae/kernels/matmul.py::_mm_kernel. A plain linear
// layer is scale = 1, shift = bias; an eval-mode BatchNorm folds into
// scale = gamma * rsqrt(var + eps),
// shift = beta - mean * scale (+ bias * scale). A bf16 output is rounded
// once, after the activation (gemm_tile.cuh's store).
//
// Built without --use_fast_math: expf stays the accurate libdevice routine so
// the sigmoid matches torch.sigmoid to float32 rounding.
#pragma once

namespace satae {

enum Act : int { kActNone = 0, kActRelu = 1, kActSigmoid = 2 };

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

}  // namespace satae
