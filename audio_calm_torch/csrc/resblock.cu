// resblock: one HiFi-GAN MRF resblock (ResBlock1) in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_resblock` / `_resblock_kernel`
// (audio_calm_tpu/ops/pallas_vocoder.py:159-274). For x [B, T, C] it computes
//   per dilation d: x <- x + conv_k,1(lrelu(conv_k,d(lrelu(x))))
// with every conv input zero outside [0, T) (the reference's 'same' zero
// padding, applied at every link of the chain), operands rounded to the
// compute dtype, fp32 accumulation, an fp32 running residual and fp32 biases;
// the output is in x's dtype.
//
// What bounds it on this card: operations. A resblock does 2*n_d*k*C^2
// multiply-adds per sample (n_d dilations, two convs each) against 2*C values
// of input and output, e.g. 6.0e3 FLOP per byte at C=96, k=11 in bf16: far
// above the H100's ~295 FLOP/byte ridge. What must stay out of device memory
// are the 2*n_d intermediate [T, C] activations of the chain.
//
// Design. One block of 256 threads per (time tile, batch row). It recomputes
// a halo H = sum over d of (c*d + c), c = (k-1)/2, on each side of its tile
// (60 samples at k=11, dilations 1/3/5): the window holds Lp = tile + 2H rows,
// and each conv computes only the rows that still feed the tile. The wrapper
// (ops/vocoder_kernel.py `_resblock_plan`) picks Lp, the largest window that
// fits the 227 KB of shared memory a block may use, and pads the channels
// with zeros to the kernel's granule (exact: zero weights and biases keep
// the padded channels at zero, and lrelu(0) = 0). The TPU kernel's
// materialized halo windows and 128-lane packing are a Mosaic device and are
// not carried over. Two paths, by compute dtype:
//
// bf16 operands: tensor cores, mma.sync m16n8k16, C a multiple of 32 (32, 64,
// 96, 128, 192 or 256). A conv is a sum over taps j of [rows x C] @ W_j
// [C x C]: the A tile of tap j is the operand buffer shifted by (j - c) * d
// rows (ldmatrix), the weights stream from L2 in mma B-fragment order, one k16
// slice ahead (`mma_taps`, shared with vocoder_stage.cu). The work of a conv
// is dealt to the 8 warps in units of (32 output channels, 64 rows). Two bf16
// operand buffers ping-pong: conv1 reads lrelu(x) from ab0 and writes
// lrelu(conv1) (zero outside [0, T)) to ab1; conv2 reads ab1, adds the
// residual and refreshes ab0 with lrelu of the new residual. The residual
// itself is touched only in conv2's epilogue: the first dilation reads x
// from device memory, the last writes the output, and in between it lives in
// shared memory at C <= 64, else in a per-block fp32 scratch in device memory
// (L2-resident while the block runs), which leaves the shared memory to the
// two operand buffers and doubles the window at large C. Shared memory per
// window row: (C+8)*4 bytes, plus (C+8)*4 for the residual at C <= 64. Tiles
// at k = 11, dilations 1/3/5 (H = 60): C=32: 600 rows, 64: 280, 96: 424,
// 128: 296, 192: 168, 256: 88.
//
// fp32 operands (parity runs): direct per-tap multiply-adds on the CUDA
// cores, a thread computing 4 rows x 4 channels, C a multiple of 4; shared
// memory holds conv1's output and, at C <= 64, the residual (rows of C+1
// floats); above that the residual lives in the per-block scratch.
//
// Layouts: x and out [B, T, C] channels-last; the weights one buffer in the
// compute dtype, per dilation conv1 then conv2, k*C*C elements each: fp32
// [k][C_in][C_out] (the JAX kernel layout), bf16 in mma B-fragment order
// (ops/vocoder_kernel.py `_mma_fragments`); biases one fp32 buffer, C per
// conv in the same order.

#include "common.cuh"

namespace {

constexpr int kMaxDil = 4;
constexpr int kMaxK = 11;

struct ResArgs {
  int B, T, C, k, n_dil;
  int dil[kMaxDil];
  int halo, tile, Lp, ldc;
  float slope;
};

// ---------------------------------------------------------------------------
// fp32 operands: CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kRP = 4;  // rows per thread in a conv pass

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// One dilated conv over buffer rows [rlo, rhi).
//   conv1 (kSecond false): reads lrelu(cur), writes hb <- mask(lrelu(conv))
//   conv2: reads hb; v = cur + conv at positions inside [0, T): the last
//          dilation writes v to `out` on the tile's rows, the others to cur
template <typename IO, bool kSecond>
__device__ void conv_pass(float* cur, float* hb, IO* __restrict__ out,
                          const float* __restrict__ w, const float* __restrict__ bias,
                          const ResArgs& a, int d, int rlo, int rhi, int b, int s0,
                          bool last) {
  const int C = a.C, ldh = C + 1;
  const int ncg = C >> 2;
  const int nrg = kThreads / ncg;
  if ((int)threadIdx.x >= ncg * nrg) return;
  const int cg = threadIdx.x % ncg, rg = threadIdx.x / ncg;
  const int co = cg * 4;
  const int c = (a.k - 1) / 2;
  float bv[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bv[q] = bias[co + q];

  for (int p0 = rlo + rg * kRP; p0 < rhi; p0 += nrg * kRP) {
    float acc[kRP][4];
#pragma unroll
    for (int rr = 0; rr < kRP; ++rr)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[rr][q] = bv[q];

    for (int j = 0; j < a.k; ++j) {
      const int off = (j - c) * d;
      int rows[kRP];
#pragma unroll
      for (int rr = 0; rr < kRP; ++rr) rows[rr] = min(p0 + rr + off, a.Lp - 1);  // rows >= rhi are discarded
      const float* wj = w + (size_t)j * C * C + co;
      // each tap sums its C products apart, then joins the total: a chain
      // of k*C sequential adds would carry sqrt(k) times the rounding error
      float part[kRP][4] = {};
#pragma unroll 4
      for (int ci = 0; ci < C; ++ci) {
        float wv[4];
        load4(wj + (size_t)ci * C, wv);
#pragma unroll
        for (int rr = 0; rr < kRP; ++rr) {
          const float v = kSecond ? hb[rows[rr] * ldh + ci]
                                  : lrelu(cur[(size_t)rows[rr] * a.ldc + ci], a.slope);
#pragma unroll
          for (int q = 0; q < 4; ++q) part[rr][q] = fmaf(v, wv[q], part[rr][q]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRP; ++rr)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[rr][q] += part[rr][q];
    }

#pragma unroll
    for (int rr = 0; rr < kRP; ++rr) {
      const int p = p0 + rr;
      if (p >= rhi) break;
      const int pos = s0 + p;
      const bool inside = pos >= 0 && pos < a.T;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!kSecond) {
          hb[p * ldh + co + q] = inside ? lrelu(acc[rr][q], a.slope) : 0.f;
        } else if (inside) {
          float* cp = cur + (size_t)p * a.ldc + co + q;
          const float v = *cp + acc[rr][q];
          if (!last) {
            *cp = v;
          } else if (p >= a.halo && p < a.halo + a.tile) {
            out[((size_t)b * a.T + pos) * C + co + q] = from_f<IO>(v);
          }
        }
      }
    }
  }
}

template <typename IO>
__global__ void __launch_bounds__(kThreads)
resblock_kernel(const IO* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, IO* __restrict__ out,
                float* __restrict__ scratch, ResArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C;
  float* hb = reinterpret_cast<float*>(smem);
  float* cur = scratch != nullptr
                   ? scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * a.Lp * a.ldc
                   : hb + (size_t)a.Lp * (C + 1);
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * a.tile - a.halo;  // sequence position of row 0
  for (int e = threadIdx.x; e < a.Lp * C; e += kThreads) {
    const int p = e / C, ch = e % C;
    const int pos = s0 + p;
    cur[(size_t)p * a.ldc + ch] =
        pos >= 0 && pos < a.T ? to_f(x[((size_t)b * a.T + pos) * C + ch]) : 0.f;
  }
  __syncthreads();
  const int c = (a.k - 1) / 2;
  const size_t wconv = (size_t)a.k * C * C;
  int consumed = 0;
  for (int i = 0; i < a.n_dil; ++i) {
    const int d = a.dil[i];
    const int r1lo = consumed + c * d, r1hi = a.Lp - consumed - c * d;
    conv_pass<IO, false>(cur, hb, out, w + 2 * i * wconv, bias + 2 * i * C, a, d,
                         r1lo, r1hi, b, s0, false);
    __syncthreads();
    conv_pass<IO, true>(cur, hb, out, w + (2 * i + 1) * wconv, bias + (2 * i + 1) * C,
                        a, 1, r1lo + c, r1hi - c, b, s0, i == a.n_dil - 1);
    __syncthreads();
    consumed += c * d + c;
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 operands: tensor cores (mma.sync m16n8k16, fp32 accumulators)
// ---------------------------------------------------------------------------
namespace tc {

// One dilated conv whose output rows cover [rlo, rhi), rounded out to m16
// tiles (rows outside the exact window are computed but never used). The
// work is dealt to the warps in units of (32-channel group, kMT m16 tiles).
//   conv1 (kSecond false): src = ab0, dst = ab1 <- mask(lrelu(conv))
//   conv2: src = ab1; v = base + conv at positions inside [0, T), base = x on
//          the first dilation and the residual after it; the last dilation
//          writes v to `out` on the tile's rows, the others write the
//          residual and dst = ab0 <- lrelu(v) (zero outside [0, T))
template <typename IO, int C, bool kSecond>
__device__ void conv(const bf16* src, bf16* dst, float* cur, const IO* __restrict__ x,
                     IO* __restrict__ out, const bf16* __restrict__ w,
                     const float* __restrict__ bias, const ResArgs& a, int d, int rlo,
                     int rhi, int b, int s0, bool first, bool last) {
  constexpr int LD = C + kPad, NG = C / 32;
  const int lane = threadIdx.x & 31;
  const int c = (a.k - 1) / 2;
  const int mt_lo = rlo / 16, mt_hi = (rhi + 15) / 16;
  const int n_units = NG * ((mt_hi - mt_lo + kMT - 1) / kMT);
  for (int u = threadIdx.x >> 5; u < n_units; u += kWarps) {
    const int ng = u % NG;
    const int m0 = mt_lo + (u / NG) * kMT;
    const int nm = min(kMT, mt_hi - m0);
    const uint4* wq = reinterpret_cast<const uint4*>(w) + ng * 64 + lane;
    Acc acc;
    init_acc(acc, bias, ng * 32);
    const int row0 = m0 * 16 + (lane & 15);
    mma_taps<C / 16>(acc, src, LD, wq, NG * 64, a.k, 1, nm, [&](int mt, int tap) {
      return min(max(row0 + mt * 16 + (tap - c) * d, 0), a.Lp - 1);
    });
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (mt >= nm) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (m0 + mt) * 16 + (lane >> 2) + 8 * h;
        const int pos = s0 + p;
        const bool inside = pos >= 0 && pos < a.T;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int col = ng * 32 + nt * 8 + 2 * (lane & 3);
          const float v0 = acc.v[mt][nt][2 * h], v1 = acc.v[mt][nt][2 * h + 1];
          if (!kSecond) {
            *reinterpret_cast<uint32_t*>(dst + p * LD + col) =
                inside ? pack2(lrelu(v0, a.slope), lrelu(v1, a.slope)) : 0u;
            continue;
          }
          float2 v = make_float2(0.f, 0.f);
          float2* cp = reinterpret_cast<float2*>(cur + (size_t)p * a.ldc + col);
          if (inside) {
            float2 base;
            if (first) {
              const IO* xp = x + ((size_t)b * a.T + pos) * C + col;
              base = make_float2(to_f(xp[0]), to_f(xp[1]));
            } else {
              base = *cp;
            }
            v = make_float2(base.x + v0, base.y + v1);
          }
          if (last) {
            if (inside && p >= a.halo && p < a.halo + a.tile) {
              IO* op = out + ((size_t)b * a.T + pos) * C + col;
              op[0] = from_f<IO>(v.x);
              op[1] = from_f<IO>(v.y);
            }
          } else {
            if (inside) *cp = v;
            *reinterpret_cast<uint32_t*>(dst + p * LD + col) =
                pack2(lrelu(v.x, a.slope), lrelu(v.y, a.slope));
          }
        }
      }
    }
  }
}

template <typename IO, int C>
__global__ void __launch_bounds__(kThreads, 1)
resblock_kernel(const IO* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ bias, IO* __restrict__ out,
                float* __restrict__ scratch, ResArgs a) {
  constexpr int LD = C + kPad, HALF = C / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ab0 = reinterpret_cast<bf16*>(smem);
  bf16* ab1 = ab0 + (size_t)a.Lp * LD;
  float* cur = scratch != nullptr
                   ? scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * a.Lp * a.ldc
                   : reinterpret_cast<float*>(ab1 + (size_t)a.Lp * LD);
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * a.tile - a.halo;  // sequence position of row 0
  // ab0 <- bf16(lrelu(x)) over the window, zero outside [0, T)
  for (int e = threadIdx.x; e < a.Lp * HALF; e += kThreads) {
    const int p = e / HALF, col = 2 * (e % HALF);
    const int pos = s0 + p;
    float v0 = 0.f, v1 = 0.f;
    if (pos >= 0 && pos < a.T) {
      const IO* xp = x + ((size_t)b * a.T + pos) * C + col;
      v0 = to_f(xp[0]);
      v1 = to_f(xp[1]);
    }
    *reinterpret_cast<uint32_t*>(ab0 + p * LD + col) =
        pack2(lrelu(v0, a.slope), lrelu(v1, a.slope));
  }
  __syncthreads();
  const int c = (a.k - 1) / 2;
  const size_t wconv = (size_t)a.k * C * C;
  int consumed = 0;
  for (int i = 0; i < a.n_dil; ++i) {
    const int d = a.dil[i];
    const int r1lo = consumed + c * d, r1hi = a.Lp - consumed - c * d;
    conv<IO, C, false>(ab0, ab1, cur, x, out, w + 2 * i * wconv, bias + 2 * i * C, a, d,
                       r1lo, r1hi, b, s0, i == 0, false);
    __syncthreads();
    conv<IO, C, true>(ab1, ab0, cur, x, out, w + (2 * i + 1) * wconv,
                      bias + (2 * i + 1) * C, a, 1, r1lo + c, r1hi - c, b, s0, i == 0,
                      i == a.n_dil - 1);
    __syncthreads();
    consumed += c * d + c;
  }
}

}  // namespace tc

template <typename IO>
int launch_simt(const void* x, const void* w, const float* bias, void* out,
                float* scratch, ResArgs a, cudaStream_t stream) {
  if (a.C % 4 != 0) return (int)cudaErrorInvalidValue;
  a.ldc = scratch != nullptr ? a.C : a.C + 1;
  const size_t smem = (size_t)a.Lp * (a.C + 1) * 4 * (scratch != nullptr ? 1 : 2);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = simt::resblock_kernel<IO>;
  int e = set_smem(kern, smem);
  if (e) return e;
  const dim3 grid((a.T + a.tile - 1) / a.tile, a.B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const IO*>(x),
                                         static_cast<const float*>(w), bias,
                                         static_cast<IO*>(out), scratch, a);
  return (int)cudaGetLastError();
}

template <typename IO, int C>
int launch_tc_c(const void* x, const void* w, const float* bias, void* out,
                float* scratch, ResArgs a, cudaStream_t stream) {
  const size_t row = (size_t)(C + tc::kPad);
  const size_t smem = a.Lp * row * 4 + (scratch != nullptr ? 0 : a.Lp * row * 4);
  if (a.Lp % 16 != 0 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  a.ldc = scratch != nullptr ? C : C + tc::kPad;
  auto kern = tc::resblock_kernel<IO, C>;
  int e = set_smem(kern, smem);
  if (e) return e;
  const dim3 grid((a.T + a.tile - 1) / a.tile, a.B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const IO*>(x), static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<IO*>(out), scratch, a);
  return (int)cudaGetLastError();
}

template <typename IO>
int launch_tc(const void* x, const void* w, const float* bias, void* out,
              float* scratch, const ResArgs& a, cudaStream_t stream) {
  switch (a.C) {
    case 32: return launch_tc_c<IO, 32>(x, w, bias, out, scratch, a, stream);
    case 64: return launch_tc_c<IO, 64>(x, w, bias, out, scratch, a, stream);
    case 96: return launch_tc_c<IO, 96>(x, w, bias, out, scratch, a, stream);
    case 128: return launch_tc_c<IO, 128>(x, w, bias, out, scratch, a, stream);
    case 192: return launch_tc_c<IO, 192>(x, w, bias, out, scratch, a, stream);
    case 256: return launch_tc_c<IO, 256>(x, w, bias, out, scratch, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x, out [B, T, C] (float32 or bfloat16: io_bf16); w, bias as described at
// the top; dil[n_dil]; Lp the window rows (tile = Lp - 2H). scratch: fp32
// [ceil(T / tile) * B, Lp, C], the residual of each block, or null to keep
// the residual in shared memory.
extern "C" int fused_resblock(const void* x, const void* w, const float* bias,
                              void* out, void* scratch, int io_bf16, int ct_bf16,
                              int B, int T, int C, int k, int n_dil, const int* dil,
                              float slope, int Lp, void* stream) {
  if (B < 1 || T < 1 || C < 1 || C > 256 || k < 1 || k > kMaxK || k % 2 == 0 ||
      n_dil < 1 || n_dil > kMaxDil)
    return (int)cudaErrorInvalidValue;
  ResArgs a = {};
  a.B = B; a.T = T; a.C = C; a.k = k; a.n_dil = n_dil; a.slope = slope; a.Lp = Lp;
  const int c = (k - 1) / 2;
  for (int i = 0; i < n_dil; ++i) {
    if (dil[i] < 1) return (int)cudaErrorInvalidValue;
    a.dil[i] = dil[i];
    a.halo += c * dil[i] + c;
  }
  a.tile = Lp - 2 * a.halo;
  if (a.tile < 1) return (int)cudaErrorInvalidValue;
  float* scr = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ct_bf16)
    return io_bf16 ? launch_tc<__nv_bfloat16>(x, w, bias, out, scr, a, st)
                   : launch_tc<float>(x, w, bias, out, scr, a, st);
  return io_bf16 ? launch_simt<__nv_bfloat16>(x, w, bias, out, scr, a, st)
                 : launch_simt<float>(x, w, bias, out, scr, a, st);
}
