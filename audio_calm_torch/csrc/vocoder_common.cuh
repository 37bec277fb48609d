// Tiling of the HiFi-GAN kernels: the block size, lrelu and the shared
// buffers' row padding (vocoder_stage.cu and resblock.cu), and resblock.cu's
// per-warp tap loop of bf16 tensor-core products over weights packed in mma
// B-fragment order (see ops/vocoder_kernel.py `_mma_fragments`).
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

namespace tc {

constexpr int kWarps = kThreads / 32;
constexpr int kMT = 4;   // m16 row tiles per warp and chunk
constexpr int kNT = 4;   // n8 channel tiles per warp: 32 output channels
constexpr int kPad = 8;  // row padding of the shared buffers, in elements

// The accumulator tiles of one warp chunk: kMT x kNT tiles of m16 x n8.
struct Acc {
  float v[kMT][kNT][4];
};

// acc += sum over taps t < n_taps of A_t @ W_t, K = 16*KK deep. A_t's m16
// tiles come from `src` (bf16, row stride lds) at rows row_of(mt, t). W_t's
// fragments for this warp (lane applied) start at wq + t*tap_stride*KK*step
// uint4, one k16 slice every `step` uint4. Row addresses are computed once
// a tap; the B fragments of the next k16 slice load while this one's
// products run.
template <int KK, typename RowFn>
__device__ __forceinline__ void mma_taps(Acc& acc, const bf16* src, int lds,
                                         const uint4* __restrict__ wq, int step,
                                         int n_taps, int tap_stride, int nm,
                                         RowFn row_of) {
  static_assert(KK % 2 == 0, "the B double buffer alternates per k16 slice");
  const int lane = threadIdx.x & 31;
  const size_t tap_step = (size_t)tap_stride * KK * step;
  uint4 b[2][2];
  b[0][0] = __ldg(wq);
  b[0][1] = __ldg(wq + 32);
  for (int t = 0; t < n_taps; ++t) {
    const uint4* wt = wq + t * tap_step;
    const bf16* rows[kMT];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) rows[mt] = src + row_of(mt, t) * lds + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const int cb = kk & 1;
      if (kk + 1 < KK || t + 1 < n_taps) {
        const uint4* nx = kk + 1 < KK ? wt + (kk + 1) * step : wt + tap_step;
        b[cb ^ 1][0] = __ldg(nx);
        b[cb ^ 1][1] = __ldg(nx + 32);
      }
      const uint32_t bw[8] = {b[cb][0].x, b[cb][0].y, b[cb][0].z, b[cb][0].w,
                              b[cb][1].x, b[cb][1].y, b[cb][1].z, b[cb][1].w};
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (mt < nm) {
          uint32_t af[4];
          ldmatrix_x4(af, rows[mt] + kk * 16);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mma(acc.v[mt][nt], af, bw[2 * nt], bw[2 * nt + 1]);
        }
      }
    }
  }
}

__device__ __forceinline__ void init_acc(Acc& acc, const float* __restrict__ bias,
                                         int ch0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = ch0 + nt * 8 + 2 * (lane & 3);
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      acc.v[mt][nt][0] = b0; acc.v[mt][nt][1] = b1;
      acc.v[mt][nt][2] = b0; acc.v[mt][nt][3] = b1;
    }
  }
}

}  // namespace tc

}  // namespace
