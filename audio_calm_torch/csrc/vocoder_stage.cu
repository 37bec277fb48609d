// vocoder_stage: one HiFi-GAN generator stage in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_upsample_stage` / `_stage_kernel`
// (audio_calm_tpu/ops/pallas_vocoder.py). Per stage it computes
//   base = ConvTranspose1d_r(lrelu(x))        (or base = x: grouped variant)
//   for each MRF resblock (k = 3/7/11, dilations 1/3/5):
//     cur = base; per dilation d: cur += conv_k,1(lrelu(conv_k,d(lrelu(cur))))
//   out = mean over the resblocks of cur
// with every conv zero-padded exactly at the sequence edges [0, T_out).
//
// What bounds it on this card: operations. The resblocks do 126*C^2
// multiply-adds per output sample; at the V1 384-frame grid the three stages
// are about 7.2e11 FLOP against about 1e8 bytes of stage input and output,
// far above the H100's ~295 FLOP/byte ridge. The chain's intermediates are
// what must stay out of device memory: they are 126 convolutions' worth of
// [T, C] tensors.
//
// Design. One block per (time tile, batch row) with 256 threads. The tile's
// residual stream `cur` (fp32) and the conv operands (compute dtype) live in
// shared memory over the tile plus a halo each side: the stacked receptive
// field of the widest resblock, sum over d of (k-1)/2*(d+1) = 60 samples for
// k=11, dilations 1/3/5. Each conv shrinks the window of rows that feed the
// tile, and only those rows are computed. `cur` is zero outside [0, T_out)
// and each conv's output is zeroed there, which reproduces the reference's
// per-conv zero padding. Operands are rounded to the compute dtype and the
// products accumulate in fp32, as the TPU kernel feeds bf16 to the MXU. The
// TPU kernel's lane packing and block-Toeplitz weights are a VMEM/MXU device
// and are not carried over. Two paths, by compute dtype:
//
// bf16 operands (the serving path): tensor cores, mma.sync m16n8k16. A conv
// is a sum over taps j of [rows x C] @ W_j [C x C]; the A tile of tap j is
// the operand buffer shifted by (j - c) * d rows, read with ldmatrix (row
// addresses once a tap, the k16 slices unrolled). Eight warps split the
// output as C/32 channel groups x 8/(C/32) row groups; a warp holds 4 x 4
// accumulator tiles (64 rows x 32 channels). The weights do not fit in
// shared memory next to the window (one k=11 conv at C=128 is 352 KB), so
// the wrapper packs them into the mma B-fragment order and each warp reads
// its fragments from L2 with 16-byte loads, one k16 slice ahead. Two bf16
// operand buffers ping-pong: conv1 reads lrelu(cur) from ab0 and writes
// lrelu(conv1) to ab1; conv2 reads ab1, adds into cur and refreshes ab0.
// The upsample is a polyphase product (per output phase, k_up/r taps of
// C_in = 2C channels) on the tensor cores too, recomputed from the stage
// input per resblock (about 3% of the work) rather than held in a third
// buffer; its input tile is staged in ab1. Shared memory is Lp * (C+8) * 8 bytes
// (cur fp32 + two bf16 buffers, rows padded by 8 elements so that ldmatrix
// and the epilogue stores hit distinct banks); Lp is the largest multiple
// of 16*r that fits the 227 KB a block may use: 208 rows at C=128 (tile 88),
// 384 at C=64 (tile 264), 704 at C=32 (tile 584). The resblock sum lives in
// device memory (`acc`, fp32: the output itself when it is fp32), read and
// written once per resblock per tile.
//
// fp32 operands (parity runs): direct per-tap multiply-adds on CUDA cores,
// a tile of 8192 samples*channels (64 rows at C=128) so that each thread
// keeps its 32 accumulators of the resblock mean in registers; shared memory
// (tile + 2*halo) * (C+1) * 8 bytes, at most 190 KB.
//
// Layouts: x [B, T_in, C_in] and out [B, T_out, C] channels-last; the
// weights are one packed buffer in the compute dtype, per conv k*C_in*C
// elements: the upsample first (if any), then per resblock and dilation
// conv1, conv2. fp32: each conv [k][C_in][C] (the JAX kernel layout); bf16:
// each conv in mma B-fragment order (see ops/vocoder_kernel.py
// `_mma_fragments`). Biases are one fp32 buffer in the same order.

#include "common.cuh"

namespace {

constexpr int kMaxBlocks = 4;
constexpr int kMaxDil = 4;

struct StageArgs {
  int B, T_in, T_out, C_in, C, r, k_up, p_up;
  int tile, halo, ldc, ldh, Lp;
  float slope;
  int n_blocks;
  int ksize[kMaxBlocks];
  int n_dil[kMaxBlocks];
  int dil[kMaxBlocks][kMaxDil];
  long long w1[kMaxBlocks][kMaxDil];
  long long w2[kMaxBlocks][kMaxDil];
  int b1[kMaxBlocks][kMaxDil];
  int b2[kMaxBlocks][kMaxDil];
};

// Rows that feed the tile for resblock `blk`: [halo - h, halo + tile + h).
__device__ __forceinline__ int block_halo(const StageArgs& a, int blk) {
  const int c = (a.ksize[blk] - 1) / 2;
  int h = 0;
  for (int i = 0; i < a.n_dil[blk]; ++i) h += c * a.dil[blk][i] + c;
  return h;
}

// ---------------------------------------------------------------------------
// fp32 operands: CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kTileElems = 8192;              // tile * C
constexpr int kAcc = kTileElems / kThreads;   // accumulators per thread
constexpr int kRP = 4;                        // rows per thread in a conv pass

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// cur rows [lo, hi) <- the stage's base signal at positions s0 + row
// (zero outside [0, T_out)).
template <typename IO>
__device__ void load_base(float* cur, const IO* __restrict__ x,
                          const float* __restrict__ w, const float* __restrict__ bias,
                          const StageArgs& a, int b, int lo, int hi, int s0) {
  const int C = a.C;
  for (int e = threadIdx.x; e < (hi - lo) * C; e += kThreads) {
    const int p = lo + e / C, co = e % C;
    const int m = s0 + p;
    float v = 0.f;
    if (m >= 0 && m < a.T_out) {
      if (a.k_up == 0) {
        v = to_f(x[((size_t)b * a.T_in + m) * C + co]);
      } else {
        // torch ConvTranspose1d: out[t*r - p_up + kappa] += x[t] * w[kappa]
        v = bias[co];
        const int num = m + a.p_up;
        const int lo_num = num - a.k_up + 1;
        int t_lo = lo_num <= 0 ? -((-lo_num) / a.r) : (lo_num + a.r - 1) / a.r;
        int t_hi = num / a.r;
        t_lo = max(t_lo, 0);
        t_hi = min(t_hi, a.T_in - 1);
        for (int t = t_lo; t <= t_hi; ++t) {
          const int kappa = num - t * a.r;
          const IO* xr = x + ((size_t)b * a.T_in + t) * a.C_in;
          const float* wk = w + (size_t)kappa * a.C_in * C + co;
          for (int ci = 0; ci < a.C_in; ++ci)
            v = fmaf(lrelu(to_f(xr[ci]), a.slope), wk[(size_t)ci * C], v);
        }
      }
    }
    cur[p * a.ldc + co] = v;
  }
}

// One dilated conv over buffer rows [rlo, rhi).
//   kFirst: reads lrelu(cur), writes hb = mask(lrelu(conv))
//   else:   reads hb, adds the conv into cur at positions inside [0, T_out)
template <bool kFirst>
__device__ void conv_pass(float* cur, float* hb, const float* __restrict__ w,
                          const float* __restrict__ bias, const StageArgs& a,
                          int L, int k, int d, int rlo, int rhi, int s0) {
  const int C = a.C;
  const int ncg = C >> 2;
  const int nrg = kThreads / ncg;
  const int cg = threadIdx.x % ncg, rg = threadIdx.x / ncg;
  const int co = cg * 4;
  const int c = (k - 1) / 2;
  float bv[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bv[q] = bias[co + q];

  for (int p0 = rlo + rg * kRP; p0 < rhi; p0 += nrg * kRP) {
    float acc[kRP][4];
#pragma unroll
    for (int rr = 0; rr < kRP; ++rr)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[rr][q] = bv[q];

    for (int j = 0; j < k; ++j) {
      const int off = (j - c) * d;
      int rows[kRP];
#pragma unroll
      for (int rr = 0; rr < kRP; ++rr) rows[rr] = min(p0 + rr + off, L - 1);  // rows >= rhi are discarded
      const float* wj = w + (size_t)j * C * C + co;
#pragma unroll 4
      for (int ci = 0; ci < C; ++ci) {
        float wv[4];
        load4(wj + (size_t)ci * C, wv);
#pragma unroll
        for (int rr = 0; rr < kRP; ++rr) {
          const float v = kFirst ? lrelu(cur[rows[rr] * a.ldc + ci], a.slope)
                                 : hb[rows[rr] * a.ldh + ci];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[rr][q] = fmaf(v, wv[q], acc[rr][q]);
        }
      }
    }

#pragma unroll
    for (int rr = 0; rr < kRP; ++rr) {
      const int p = p0 + rr;
      if (p >= rhi) break;
      const int pos = s0 + p;
      const bool inside = pos >= 0 && pos < a.T_out;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (kFirst) {
          hb[p * a.ldh + co + q] = inside ? lrelu(acc[rr][q], a.slope) : 0.f;
        } else if (inside) {
          cur[p * a.ldc + co + q] += acc[rr][q];
        }
      }
    }
  }
}

template <typename IO>
__global__ void __launch_bounds__(kThreads)
stage_kernel(const IO* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, IO* __restrict__ out, StageArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.tile + 2 * a.halo;
  float* cur = reinterpret_cast<float*>(smem);
  float* hb = cur + (size_t)L * a.ldc;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * a.tile;
  const int s0 = t0 - a.halo;  // sequence position of buffer row 0

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int blk = 0; blk < a.n_blocks; ++blk) {
    const int k = a.ksize[blk], c = (k - 1) / 2;
    const int hblk = block_halo(a, blk);
    const int lo = a.halo - hblk, hi = a.halo + a.tile + hblk;
    load_base<IO>(cur, x, w, bias, a, b, lo, hi, s0);
    __syncthreads();
    int consumed = 0;
    for (int i = 0; i < a.n_dil[blk]; ++i) {
      const int d = a.dil[blk][i];
      const int r1lo = lo + consumed + c * d, r1hi = hi - consumed - c * d;
      conv_pass<true>(cur, hb, w + a.w1[blk][i], bias + a.b1[blk][i], a, L,
                      k, d, r1lo, r1hi, s0);
      __syncthreads();
      conv_pass<false>(cur, hb, w + a.w2[blk][i], bias + a.b2[blk][i], a, L,
                       k, 1, r1lo + c, r1hi - c, s0);
      __syncthreads();
      consumed += c * d + c;
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = threadIdx.x + i * kThreads;
      acc[i] += cur[(a.halo + e / a.C) * a.ldc + e % a.C];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int pos = t0 + e / a.C;
    if (pos < a.T_out)
      out[((size_t)b * a.T_out + pos) * a.C + e % a.C] =
          from_f<IO>(acc[i] / (float)a.n_blocks);
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 operands: tensor cores (mma.sync m16n8k16, fp32 accumulators)
// ---------------------------------------------------------------------------
namespace tc {

// This warp's channel group and its share [lo, hi) of m-tiles [mt_lo, mt_hi).
template <int C>
__device__ __forceinline__ void warp_share(int mt_lo, int mt_hi, int& ng, int& lo,
                                           int& hi) {
  constexpr int NG = C / 32, MW = kWarps / NG;
  const int warp = threadIdx.x >> 5;
  ng = warp % NG;
  const int per = (mt_hi - mt_lo + MW - 1) / MW;
  lo = mt_lo + (warp / NG) * per;
  hi = min(lo + per, mt_hi);
}

// One dilated conv whose output rows cover [rlo, rhi) (rounded out to m16
// tiles; rows outside the exact window are never used).
//   kFirst: src = ab0 (lrelu(cur)), dst = ab1 <- mask(lrelu(conv))
//   else:   src = ab1, cur += conv inside [0, T_out), dst = ab0 <- lrelu(cur)
template <int C, bool kFirst>
__device__ void conv(float* cur, const bf16* src, bf16* dst,
                     const bf16* __restrict__ w, const float* __restrict__ bias,
                     const StageArgs& a, int k, int d, int rlo, int rhi, int s0) {
  constexpr int LD = C + kPad, LDC = C + kPad, NG = C / 32;
  const int lane = threadIdx.x & 31;
  int ng, my_lo, my_hi;
  warp_share<C>(rlo / 16, (rhi + 15) / 16, ng, my_lo, my_hi);
  const int c = (k - 1) / 2;
  const uint4* wq = reinterpret_cast<const uint4*>(w) + ng * 64 + lane;
  for (int m0 = my_lo; m0 < my_hi; m0 += kMT) {
    const int nm = min(kMT, my_hi - m0);
    Acc acc;
    init_acc(acc, bias, ng * 32);
    const int row0 = m0 * 16 + (lane & 15);
    mma_taps<C / 16>(acc, src, LD, wq, NG * 64, k, 1, nm, [&](int mt, int tap) {
      return min(max(row0 + mt * 16 + (tap - c) * d, 0), a.Lp - 1);
    });
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (mt >= nm) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (m0 + mt) * 16 + (lane >> 2) + 8 * h;
        const int pos = s0 + p;
        const bool inside = pos >= 0 && pos < a.T_out;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int col = ng * 32 + nt * 8 + 2 * (lane & 3);
          const float v0 = acc.v[mt][nt][2 * h], v1 = acc.v[mt][nt][2 * h + 1];
          uint32_t packed = 0u;
          if (kFirst) {
            if (inside) packed = pack2(lrelu(v0, a.slope), lrelu(v1, a.slope));
          } else if (inside) {
            float2* cp = reinterpret_cast<float2*>(cur + p * LDC + col);
            float2 cv = *cp;
            cv.x += v0;
            cv.y += v1;
            *cp = cv;
            packed = pack2(lrelu(cv.x, a.slope), lrelu(cv.y, a.slope));
          }
          *reinterpret_cast<uint32_t*>(dst + p * LD + col) = packed;
        }
      }
    }
  }
}

// Upsample rows [0, Lp) of the window: base = ConvTranspose1d_r(lrelu(x)),
// one polyphase product per output phase ph (rows p = r*u + ph; tap i uses
// kernel row kappa0(ph) + r*i and staged input row u + shift(ph) - i).
// stg holds lrelu(x) in bf16 for x rows t_base .. t_base + n_stage - 1.
// Writes cur <- base (zero outside [0, T_out)) and ab0 <- lrelu(base).
template <int C>
__device__ void upsample(float* cur, const bf16* stg, bf16* ab0,
                         const bf16* __restrict__ w, const float* __restrict__ bias,
                         const StageArgs& a, int s0) {
  constexpr int LD = C + kPad, LDC = C + kPad, NG = C / 32;
  constexpr int CIN = 2 * C, LDS = CIN + kPad;  // HiFi-GAN halves the width
  const int lane = threadIdx.x & 31;
  const int n_taps = a.k_up / a.r;
  int ng, my_lo, my_hi;
  warp_share<C>(0, a.Lp / a.r / 16, ng, my_lo, my_hi);
  const uint4* wbase = reinterpret_cast<const uint4*>(w) + ng * 64 + lane;
  for (int ph = 0; ph < a.r; ++ph) {
    // taps of this phase: kernel rows kappa0 + r*i, input rows u + shift - i
    const int kappa0 = (ph + a.p_up) % a.r;
    const int shift = (ph + a.p_up) / a.r - a.p_up / a.r + n_taps - 1;
    const uint4* wq = wbase + (size_t)kappa0 * (CIN / 16) * NG * 64;
    for (int m0 = my_lo; m0 < my_hi; m0 += kMT) {
      const int nm = min(kMT, my_hi - m0);
      Acc acc;
      init_acc(acc, bias, ng * 32);
      const int row0 = m0 * 16 + (lane & 15) + shift;
      mma_taps<CIN / 16>(acc, stg, LDS, wq, NG * 64, n_taps, a.r, nm,
                         [&](int mt, int i) { return row0 + mt * 16 - i; });
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (mt >= nm) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = a.r * ((m0 + mt) * 16 + (lane >> 2) + 8 * h) + ph;
          const int pos = s0 + p;
          const bool inside = pos >= 0 && pos < a.T_out;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const int col = ng * 32 + nt * 8 + 2 * (lane & 3);
            const float v0 = inside ? acc.v[mt][nt][2 * h] : 0.f;
            const float v1 = inside ? acc.v[mt][nt][2 * h + 1] : 0.f;
            *reinterpret_cast<float2*>(cur + p * LDC + col) = make_float2(v0, v1);
            *reinterpret_cast<uint32_t*>(ab0 + p * LD + col) =
                pack2(lrelu(v0, a.slope), lrelu(v1, a.slope));
          }
        }
      }
    }
  }
}

// Staged upsample input: stg[sr] = bf16(lrelu(x[t_base + sr])), zero
// outside [0, T_in).
template <typename IO>
__device__ void stage_input(bf16* stg, const IO* __restrict__ x, const StageArgs& a,
                            int b, int s0) {
  const int n_taps = a.k_up / a.r;
  const int t_base = s0 / a.r + a.p_up / a.r - (n_taps - 1);
  const int n_stage = a.Lp / a.r + (a.r - 1 + a.p_up) / a.r - a.p_up / a.r + n_taps - 1;
  const int lds = a.C_in + kPad, half = a.C_in / 2;
  for (int e = threadIdx.x; e < n_stage * half; e += kThreads) {
    const int sr = e / half, ci = 2 * (e % half);
    const int t = t_base + sr;
    float v0 = 0.f, v1 = 0.f;
    if (t >= 0 && t < a.T_in) {
      const IO* xr = x + ((size_t)b * a.T_in + t) * a.C_in + ci;
      v0 = lrelu(to_f(xr[0]), a.slope);
      v1 = lrelu(to_f(xr[1]), a.slope);
    }
    *reinterpret_cast<uint32_t*>(stg + sr * lds + ci) = pack2(v0, v1);
  }
}

// Grouped variant: cur rows [lo, hi) <- x (zero outside [0, T_out)),
// ab0 <- lrelu(cur).
template <typename IO, int C>
__device__ void load_grouped(float* cur, bf16* ab0, const IO* __restrict__ x,
                             const StageArgs& a, int b, int lo, int hi, int s0) {
  constexpr int LD = C + kPad, LDC = C + kPad, HALF = C / 2;
  for (int e = threadIdx.x; e < (hi - lo) * HALF; e += kThreads) {
    const int p = lo + e / HALF, col = 2 * (e % HALF);
    const int m = s0 + p;
    float v0 = 0.f, v1 = 0.f;
    if (m >= 0 && m < a.T_out) {
      const IO* xr = x + ((size_t)b * a.T_in + m) * C + col;
      v0 = to_f(xr[0]);
      v1 = to_f(xr[1]);
    }
    *reinterpret_cast<float2*>(cur + p * LDC + col) = make_float2(v0, v1);
    *reinterpret_cast<uint32_t*>(ab0 + p * LD + col) =
        pack2(lrelu(v0, a.slope), lrelu(v1, a.slope));
  }
}

template <typename IO, int C>
__global__ void __launch_bounds__(kThreads, 1)
stage_kernel(const IO* __restrict__ x, const bf16* __restrict__ w,
             const float* __restrict__ bias, IO* __restrict__ out,
             float* __restrict__ acc_buf, StageArgs a) {
  constexpr int LD = C + kPad, LDC = C + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  float* cur = reinterpret_cast<float*>(smem);
  bf16* ab0 = reinterpret_cast<bf16*>(cur + (size_t)a.Lp * LDC);
  bf16* ab1 = ab0 + (size_t)a.Lp * LD;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * a.tile;
  const int s0 = t0 - a.halo;  // sequence position of buffer row 0

  for (int blk = 0; blk < a.n_blocks; ++blk) {
    const int k = a.ksize[blk], c = (k - 1) / 2;
    const int hblk = block_halo(a, blk);
    const int lo = a.halo - hblk, hi = a.halo + a.tile + hblk;
    if (a.k_up > 0) {
      stage_input<IO>(ab1, x, a, b, s0);
      __syncthreads();
      upsample<C>(cur, ab1, ab0, w, bias, a, s0);
    } else {
      load_grouped<IO, C>(cur, ab0, x, a, b, lo, hi, s0);
    }
    __syncthreads();
    int consumed = 0;
    for (int i = 0; i < a.n_dil[blk]; ++i) {
      const int d = a.dil[blk][i];
      const int r1lo = lo + consumed + c * d, r1hi = hi - consumed - c * d;
      conv<C, true>(cur, ab0, ab1, w + a.w1[blk][i], bias + a.b1[blk][i], a, k,
                    d, r1lo, r1hi, s0);
      __syncthreads();
      conv<C, false>(cur, ab1, ab0, w + a.w2[blk][i], bias + a.b2[blk][i], a, k,
                     1, r1lo + c, r1hi - c, s0);
      __syncthreads();
      consumed += c * d + c;
    }
    // resblock sum over the tile's rows, in fp32 device memory
    const bool last = blk == a.n_blocks - 1;
    const int rows = min(a.tile, a.T_out - t0);
    for (int e = threadIdx.x; e < rows * (C / 2); e += kThreads) {
      const int row = e / (C / 2), col = 2 * (e % (C / 2));
      const float2 v = *reinterpret_cast<const float2*>(cur + (a.halo + row) * LDC + col);
      const size_t idx = ((size_t)b * a.T_out + t0 + row) * C + col;
      float2* ap = reinterpret_cast<float2*>(acc_buf + idx);
      float2 s = v;
      if (blk > 0) {
        const float2 prev = *ap;
        s = make_float2(prev.x + v.x, prev.y + v.y);
      }
      if (!last) {
        *ap = s;
      } else {
        out[idx] = from_f<IO>(s.x / (float)a.n_blocks);
        out[idx + 1] = from_f<IO>(s.y / (float)a.n_blocks);
      }
    }
    __syncthreads();
  }
}

}  // namespace tc

template <typename IO>
int launch_simt(const void* x, const void* w, const float* bias, void* out,
                StageArgs a, cudaStream_t stream) {
  constexpr int kTileElems = simt::kTileElems;
  if (a.C % 4 != 0 || a.C > 128 || kTileElems % a.C != 0)
    return (int)cudaErrorInvalidValue;
  a.tile = kTileElems / a.C;
  a.ldc = a.C + 1;
  a.ldh = a.C + 1;
  const size_t L = (size_t)a.tile + 2 * a.halo;
  const size_t smem = L * (a.ldc + a.ldh) * 4;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = simt::stage_kernel<IO>;
  int e = set_smem(kern, smem);
  if (e) return e;
  const dim3 grid((a.T_out + a.tile - 1) / a.tile, a.B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const IO*>(x),
                                         static_cast<const float*>(w), bias,
                                         static_cast<IO*>(out), a);
  return (int)cudaGetLastError();
}

template <typename IO, int C>
int launch_tc_c(const void* x, const void* w, const float* bias, void* out,
                float* acc, StageArgs a, cudaStream_t stream) {
  const size_t per_row = (size_t)(C + tc::kPad) * 8;  // cur fp32 + 2 x bf16
  const int unit = 16 * a.r;
  a.Lp = (int)(kMaxSmem / per_row) / unit * unit;
  a.tile = a.Lp - 2 * a.halo;
  if (a.tile < unit) return (int)cudaErrorInvalidValue;
  if (a.k_up > 0) {
    const int n_taps = a.k_up / a.r;
    const int n_stage = a.Lp / a.r + (a.r - 1 + a.p_up) / a.r - a.p_up / a.r + n_taps - 1;
    if (a.C_in != 2 * C ||
        (size_t)n_stage * (a.C_in + tc::kPad) > (size_t)a.Lp * (C + tc::kPad))
      return (int)cudaErrorInvalidValue;
  }
  const size_t smem = a.Lp * per_row;
  auto kern = tc::stage_kernel<IO, C>;
  int e = set_smem(kern, smem);
  if (e) return e;
  const dim3 grid((a.T_out + a.tile - 1) / a.tile, a.B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const IO*>(x), static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<IO*>(out), acc, a);
  return (int)cudaGetLastError();
}

template <typename IO>
int launch_tc(const void* x, const void* w, const float* bias, void* out,
              float* acc, const StageArgs& a, cudaStream_t stream) {
  switch (a.C) {
    case 32: return launch_tc_c<IO, 32>(x, w, bias, out, acc, a, stream);
    case 64: return launch_tc_c<IO, 64>(x, w, bias, out, acc, a, stream);
    case 128: return launch_tc_c<IO, 128>(x, w, bias, out, acc, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// k_up == 0 selects the grouped variant (no upsample, C_in == C, r = 1).
// ksize[n_blocks], n_dil[n_blocks], dil[n_blocks * 4] (row-major, padded).
// acc: fp32 [B, T_out, C] resblock-sum scratch for the bf16-operand path
// (the output itself when io is fp32); unused with fp32 operands.
extern "C" int vocoder_stage(const void* x, const void* w, const float* bias,
                             void* out, void* acc, int io_bf16, int ct_bf16,
                             int B, int T_in, int C_in, int C, int r, int k_up,
                             int n_blocks, const int* ksize, const int* n_dil,
                             const int* dil, float slope, void* stream) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks || B < 1 || T_in < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  StageArgs a = {};
  a.B = B; a.T_in = T_in; a.C_in = C_in; a.C = C; a.slope = slope;
  a.n_blocks = n_blocks;
  long long woff = 0;
  int boff = 0;
  if (k_up > 0) {
    if (r < 1 || k_up % r != 0 || (k_up - r) % 2 != 0)
      return (int)cudaErrorInvalidValue;
    a.r = r; a.k_up = k_up; a.p_up = (k_up - r) / 2; a.T_out = T_in * r;
    woff = (long long)k_up * C_in * C;
    boff = C;
  } else {
    if (C_in != C) return (int)cudaErrorInvalidValue;
    a.r = 1; a.k_up = 0; a.p_up = 0; a.T_out = T_in;
  }
  int halo = 0;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int k = ksize[blk];
    if (k % 2 != 1 || n_dil[blk] < 1 || n_dil[blk] > kMaxDil)
      return (int)cudaErrorInvalidValue;
    a.ksize[blk] = k;
    a.n_dil[blk] = n_dil[blk];
    int hblk = 0;
    for (int i = 0; i < n_dil[blk]; ++i) {
      const int d = dil[blk * kMaxDil + i];
      a.dil[blk][i] = d;
      hblk += (k - 1) / 2 * d + (k - 1) / 2;
      a.w1[blk][i] = woff; woff += (long long)k * C * C;
      a.b1[blk][i] = boff; boff += C;
      a.w2[blk][i] = woff; woff += (long long)k * C * C;
      a.b2[blk][i] = boff; boff += C;
    }
    halo = hblk > halo ? hblk : halo;
  }
  // the upsample's output phases line up with buffer rows when the window
  // starts at a multiple of r
  a.halo = (halo + a.r - 1) / a.r * a.r;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ct_bf16) {
    float* accp = static_cast<float*>(io_bf16 ? acc : out);
    if (accp == nullptr) return (int)cudaErrorInvalidValue;
    return io_bf16 ? launch_tc<__nv_bfloat16>(x, w, bias, out, accp, a, st)
                   : launch_tc<float>(x, w, bias, out, accp, a, st);
  }
  return io_bf16 ? launch_simt<__nv_bfloat16>(x, w, bias, out, a, st)
                 : launch_simt<float>(x, w, bias, out, a, st);
}
