// What the HiFi-GAN kernels (vocoder_stage.cu and resblock.cu) share: the
// fp32 path's block size, lrelu and the bf16 operand buffers' row padding.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

namespace tc {

constexpr int kPad = 8;  // row padding of the shared buffers, in elements

}  // namespace tc

}  // namespace
