// resblock: one HiFi-GAN MRF resblock (ResBlock1) in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_resblock` / `_resblock_kernel`
// (audio_calm_tpu/ops/pallas_vocoder.py:159-274, pallas_call at :249), to
// which JAX sends every resblock of width C <= 128 that does not divide 128
// (the stage kernel takes the rest): the HiFi-GANs whose widths are not
// powers of two, e.g. V1's geometry at 384 initial channels, C = 96, 48, 24.
// For x [B, T, C] it computes
//   per dilation d: x <- x + conv_k,1(lrelu(conv_k,d(lrelu(x))))
// with every conv input zero outside [0, T) (the reference's 'same' zero
// padding, applied at every link of the chain), operands rounded to the
// compute dtype, fp32 accumulation, an fp32 running residual and fp32 biases;
// the output is in x's dtype.
//
// What bounds it on this card. A resblock does 2*n_d*k*C^2 multiply-adds per
// sample (n_d dilations, two convs each) against 2*C values of input and
// output: operations at k = 11 and at C >= 48 (6.0e3 FLOP a byte at C = 96,
// k = 11 in bf16, far above the H100's ~295 FLOP/byte ridge); at C = 24 and
// k = 3 or 7 the fp32 input and output (0.045 ms at the served lengths)
// weigh more than the products. So the chain's 2*n_d intermediate [T, C]
// activations stay out of device memory, x is read once and the output
// written once, and the products run on the tensor cores at the widths'
// own N.
//
// Layout. One block per (time tile, batch row). It recomputes a halo H =
// sum over d of (c*d + c), c = (k-1)/2, on each side of its tile (60 rows at
// k = 11, dilations 1/3/5): the window holds Lp = tile + 2H rows, and each
// conv computes only the 64-row groups that still feed the tile. The
// wrapper (ops/vocoder_kernel.py `resblock_plan`, a function of (C, k,
// dilations, T), never of B) chooses the plan and the kernel checks it. Two
// paths, by compute dtype:
//
// bf16 operands (namespace tc): warpgroup products, two warpgroups a block.
//  - A conv is a sum over taps j of A_j [rows x KP] W_j [KP x W]: wgmma
//    m64 NN k16 with both operands in shared memory (wgmma_ss_tb<NN>). A_j
//    is the bf16 operand buffer shifted by (j - c) d rows. The buffers are
//    laid out in 8-channel columns of 16-byte rows (element (row, ch) at
//    (ch / 8) Lp 8 + row 8 + ch % 8): the K-major, no-swizzle core matrix
//    is 8 consecutive rows of one column, so a shift by any number of rows
//    (3 or 5 with the dilation) is only a start address in the descriptor.
//    A swizzled layout would tie rows to 8-row phases. W_j is MN-major in
//    the no-swizzle layout of 8 x 8 core matrices. N is the width itself
//    (24, 48, 96 run unpadded; C is zero-padded only up to the next width),
//    in W / NN passes of NN output channels where the accumulators' registers
//    ask for it (C = 128, 192, 256); only k is padded, to KP = W rounded up
//    to 16, with zero channels in the buffers and zero weight rows: executed
//    / useful products 1.0 at C = 48 and 96, 1.33 at C = 24. A tap's
//    products are issued together and run while the next tap is issued.
//  - Weights through shared memory. The wrapper lays them out once a call
//    (`resblock_stream`), one [KP, NN] image a (dilation, conv, pass, tap)
//    in the order they are consumed, each the exact shared-memory image,
//    copied by cp.async.bulk into a ring of stages completed on mbarriers
//    (`Ring`): thread 0 fills it, and the warp that releases a stage last
//    refills it, so no warp is set aside for the copies and every thread
//    may hold 255 registers. Each weight crosses L2 once a block.
//  - The residual in registers. Warpgroup wg owns the 64-row groups wg, wg
//    + 2, ... of the window (R at most: `Width`) and keeps their fp32
//    residual in the accumulator layout across all dilations; conv2's
//    epilogue adds into it. Groups that leave the shrinking window are
//    dropped. No residual in device memory.
//  - Two bf16 operand buffers: conv1 reads lrelu(x) from ab0 and writes
//    mask(lrelu(conv1)) (zero outside [0, T)) to ab1; conv2 reads ab1 and
//    writes lrelu of the new residual to ab0; the last conv2 writes the
//    tile's rows to `out`. One block barrier a conv.
//  - The window is the most rows the registers hold, R (W + NN) / 2 fp32 of
//    residual and accumulator a thread: Lp = 256 at C = 96 (tile 136 at k
//    = 11), 512 at C = 48, 1024 at C = 24; 128 at C = 192 and 256, where k
//    = 11 keeps a tile of 8 rows.
//  - What bounds it now (PERF.md section 6, tools/resblock_probe.py
//    --phases): the products, both operands read from shared memory for
//    each m64 product, take 48-77% of the warps' cycles and the stage
//    releases waiting behind them 6-31%; the tensor cores idle in the
//    epilogues (9-26%) and the prologue's load of x (8-21%), the most at
//    k = 3. On an H100 80GB HBM3 at 700 W the 9 odd-width shapes take
//    0.168-0.653 ms, 3.4-6.1x less than the earlier mma.sync kernel and
//    2.6-6.0x their bound.
//
// fp32 operands (parity runs, namespace simt): direct per-tap multiply-adds
// on the CUDA cores, a thread computing 4 rows x 4 channels, C a multiple of
// 4; shared memory holds conv1's output and, at C <= 64, the residual (rows
// of C+1 floats); above that the residual lives in a per-block scratch in
// device memory.
//
// Layouts: x and out [B, T, C] channels-last; fp32 weights one buffer, per
// dilation conv1 then conv2, [k][C_in][C_out] each (the JAX kernel layout);
// bf16 weights the stream above; biases one fp32 buffer, C per conv in the
// same order.

#include "hopper.cuh"
#include "vocoder_common.cuh"

namespace {

constexpr int kMaxDil = 4;
constexpr int kMaxK = 11;

struct ResArgs {
  int B, T, C, k, n_dil;
  int dil[kMaxDil];
  int halo, tile, Lp, ldc, stages, margin;
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
// bf16 operands: warpgroup products (wgmma) on shared-memory operands, the
// weights through a ring of bulk copies
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kNC = 2;              // warpgroups a block
constexpr int kBlock = 128 * kNC;
constexpr int kWarps = 4 * kNC;
constexpr int kMaxStages = 8;       // weight ring stages at most
constexpr int kInflight = 1;        // taps whose products run while the next issues
constexpr int kHeader = 256;        // mbarriers, release counters, alignment slack

constexpr int kProbes = 8;  // phases a probe build counts

#ifdef RESBLOCK_PROBE
// Probe build (not the shipped library; audio_calm_torch/tools/
// resblock_probe.py --phases builds it): clock cycles of every warp, summed
// over warps and blocks, by phase: [0] the prologue (x loaded, buffers
// zeroed and filled), [1] waits for a ring stage to fill, [2] the products
// (issue, ring and wgmma waits, releases), [3] the epilogues, [4] the
// barriers between convs, [5] the waits for products to finish, [6] the
// releases of ring stages, [7] the kernel's start to its end.
__device__ unsigned long long g_probe_cycles[kProbes];
#define PROBE_T(v) const long long v = clock64()
#define PROBE_ADD(i, v) (probe[i] += clock64() - (v))
#else
#define PROBE_T(v)
#define PROBE_ADD(i, v)
#endif

// The kernel widths W (C is zero-padded up to the next): KP operand channels
// (W rounded up to 16), NN output channels a product covers (W / NN passes),
// R 64-row groups a warpgroup owns at most. A thread keeps R (W + NN) / 2
// fp32 of residual and accumulator. ops/vocoder_kernel.py keeps a copy
// (_RESBLOCK_WIDTHS) that it holds against resblock_limits.
template <int W> struct Width;
template <> struct Width<16> { static constexpr int KP = 16, NN = 16, R = 12; };
template <> struct Width<24> { static constexpr int KP = 32, NN = 24, R = 8; };
template <> struct Width<32> { static constexpr int KP = 32, NN = 32, R = 6; };
template <> struct Width<48> { static constexpr int KP = 48, NN = 48, R = 4; };
template <> struct Width<64> { static constexpr int KP = 64, NN = 64, R = 3; };
template <> struct Width<96> { static constexpr int KP = 96, NN = 96, R = 2; };
template <> struct Width<128> { static constexpr int KP = 128, NN = 64, R = 2; };
template <> struct Width<192> { static constexpr int KP = 192, NN = 96, R = 1; };
template <> struct Width<256> { static constexpr int KP = 256, NN = 64, R = 1; };

// The A descriptor of 64 rows from shared address `rows` of an operand
// buffer (K-major, no swizzle): 8-channel columns of 16-byte rows, `col`
// bytes apart (the leading byte offset), 8-row core matrices 128 bytes
// apart (the stride byte offset). A row shift is a start address.
__device__ __forceinline__ uint64_t a_desc(uint32_t rows, uint32_t col) {
  return gmma_desc(rows, col, 128, 0);
}

// The descriptor of k16 slice 0 of a weight image [KP][NN] (MN-major, no
// swizzle): 8 x 8 core matrices of 128 contiguous bytes (8 input channels
// of 16 bytes, output channels innermost), output-channel groups 128 bytes
// apart (the stride byte offset, for this layout) and input-channel groups
// 16 NN bytes apart (the leading byte offset), as CUTLASS's make_gmma_desc
// encodes LayoutType::INTERLEAVE for Major::MN; slice kk adds 2 NN.
template <int NN>
__device__ __forceinline__ uint64_t b_desc(uint32_t unit) {
  return gmma_desc(unit, 16 * NN, 128, 0);
}

// generic-proxy writes to shared memory before the async proxy (wgmma)
// reads them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Arrive on a counter in shared memory; the count before the arrival.
// Relaxed: a warp arrives once its products have finished reading the
// stage (wgmma_wait), so the reads are done, not only ordered.
__device__ __forceinline__ uint32_t count_arrival(uint32_t addr) {
  uint32_t old;
  asm volatile("atom.relaxed.cta.shared::cta.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "r"(addr)
               : "memory");
  return old;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2(a, b);
}

// The weight ring. The wrapper lays every [KP, NN] tap image of the launch
// out in the order the warps consume them (per dilation conv1's, then
// conv2's, per pass of NN output channels the k taps); unit u sits in stage
// u % stages, one bulk copy, full[s] completing on its bytes. Thread 0
// fills the ring before the first unit. After that no thread waits to
// refill: each warp counts its release of a unit on the stage's counter,
// and the warp whose release is the block's last of it issues unit u +
// stages into the stage.
struct Ring {
  uint32_t bars, data, bytes;  // mbarriers, stage 0, bytes a unit
  const char* src;             // the weight stream
  int stages, n_units;
  int wait_s = 0, rel_s = 0, rel_u = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t count(int s) const {
    return bars + 8 * kMaxStages + 4 * s;
  }
  __device__ __forceinline__ void issue(int u, int s) const {
    mbar_expect_tx(full(s), bytes);
    bulk_copy(data + s * bytes, src + (size_t)u * bytes, bytes, full(s));
  }
  // the shared address of the next unit, once it has landed
  __device__ __forceinline__ uint32_t wait(long long* probe) {
    const int s = wait_s;
    PROBE_T(t0);
    mbar_wait(full(s), phase);
    PROBE_ADD(1, t0);
    if (++wait_s == stages) {
      wait_s = 0;
      phase ^= 1;
    }
    return data + s * bytes;
  }
  // this warp's products have read the oldest unit it holds
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      const uint32_t old = count_arrival(count(rel_s));
      // wgmma read the stage and the copy engine writes it: both the async
      // proxy, so no proxy fence
      if ((old + 1) % kWarps == 0 && rel_u + stages < n_units) issue(rel_u + stages, rel_s);
    }
    ++rel_u;
    if (++rel_s == stages) rel_s = 0;
  }
};

template <int W>
using Res = float[Width<W>::R][W / 2];

// rows a buffer column holds: the widest window, whatever the plan's Lp,
// so that every shared address in a conv is a compile-time offset
template <int W>
constexpr int kLmax = 64 * kNC * Width<W>::R;

// One conv of the chain: output rows [lo, hi) of the window; this
// warpgroup computes its own groups (rows outside [lo, hi) are computed
// and never used; the epilogue skips a group that misses them), W / NN
// passes of NN output channels, a pass k ring units (one a tap), one wgmma
// a group and k16 slice. A tap's products are issued together; a unit is released
// once its products are done, kInflight taps later.
//   conv1 (kSecond false): src = ab0 -> dst = ab1 <- mask(lrelu(conv))
//   conv2: src = ab1; res += conv inside [0, T); the last dilation writes
//          res to `out` on the tile's rows, the others dst = ab0 <- lrelu(res)
//          (zero outside [0, T), where res stays zero)
template <typename IO, int W, bool kSecond>
__device__ __forceinline__ void conv(Res<W>& res, uint32_t src, bf16* dst,
                                     const float* __restrict__ bias,
                                     IO* __restrict__ out, const ResArgs& a,
                                     Ring& ring, int d, int lo, int hi, int s0,
                                     int b, bool last, long long* probe) {
  using L = Width<W>;
  constexpr int KP = L::KP, NN = L::NN, R = L::R, NP = W / NN, KS = KP / 16;
  constexpr uint32_t col = 16 * kLmax<W>;  // bytes between 8-channel columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, g = lane >> 2, q = lane & 3;
  const int c = (a.k - 1) / 2;
  bool act[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row0 = 64 * (wg + kNC * r);
    act[r] = row0 < a.Lp && row0 < hi && row0 + 64 > lo;
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    float acc[R][NN / 2];
#pragma unroll
    for (int j = 0; j < NN / 8; ++j) {
      const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + p * NN + 8 * j + 2 * q));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r][4 * j] = bv.x; acc[r][4 * j + 1] = bv.y;
        acc[r][4 * j + 2] = bv.x; acc[r][4 * j + 3] = bv.y;
      }
    }
    wgmma_fence();
    PROBE_T(t_prod);
    for (int t = 0; t < a.k; ++t) {
      const uint32_t unit = ring.wait(probe);
      // group 0's A for this tap: the buffer shifted by (t - c) d rows;
      // group r and slice kk add to the descriptors' address field only
      const uint64_t da = a_desc(src + 16 * (64 * wg + (t - c) * d), col);
      const uint64_t db = b_desc<NN>(unit);
      // every group issues, in straight-line code: a product under a
      // branch makes ptxas wait for each one before the next. A group
      // outside [lo, hi) computes rows nothing reads (at the plans' full
      // windows every group meets every conv's rows).
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          wgmma_ss_tb<NN>(acc[r], da + 2 * kk * (col >> 4) + 64 * kNC * r,
                          db + 2 * NN * kk, 1);
      }
      wgmma_commit();
      if (t >= kInflight) {
        PROBE_T(t_wait);
        wgmma_wait<kInflight>();  // tap t - kInflight is done: its unit is free
        PROBE_ADD(5, t_wait);
        PROBE_T(t_rel);
        ring.release();
        PROBE_ADD(6, t_rel);
      }
    }
    PROBE_T(t_wait);
    wgmma_wait<0>();
    PROBE_ADD(5, t_wait);
    for (int t = max(a.k - kInflight, 0); t < a.k; ++t) ring.release();
#pragma unroll
    for (int r = 0; r < R; ++r) fence_regs(acc[r]);
    PROBE_ADD(2, t_prod);
    PROBE_T(t_epi);
    // the epilogue of this pass: channels p NN .. p NN + NN - 1, element
    // (row, ch) of a buffer at (ch / 8) kLmax 8 + row 8 + ch % 8
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!act[r]) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * (wg + kNC * r) + 16 * (warp & 3) + g + 8 * h;
        const int pos = s0 + row;
        const bool inside = pos >= 0 && pos < a.T;
        // branch-free: a select or mask, not a branch a pair
        const uint32_t keep = inside ? 0xffffffffu : 0u;
        const bool store = last && inside && row >= a.halo && row < a.halo + a.tile;
        uint32_t* drow = reinterpret_cast<uint32_t*>(dst + row * 8 + 2 * q);
#pragma unroll
        for (int j = 0; j < NN / 8; ++j) {
          const int cb = p * NN / 8 + j;  // 8-channel column
          const float v0 = acc[r][4 * j + 2 * h], v1 = acc[r][4 * j + 2 * h + 1];
          uint32_t* dp = drow + cb * kLmax<W> * 4;
          if (!kSecond) {
            *dp = pack2(lrelu(v0, a.slope), lrelu(v1, a.slope)) & keep;
            continue;
          }
          float& x0 = res[r][4 * cb + 2 * h];
          float& x1 = res[r][4 * cb + 2 * h + 1];
          x0 += inside ? v0 : 0.f;  // res stays zero outside [0, T)
          x1 += inside ? v1 : 0.f;
          if (!last) {
            *dp = pack2(lrelu(x0, a.slope), lrelu(x1, a.slope));
          } else if (store) {
            store2(out + ((size_t)b * a.T + pos) * W + 8 * cb + 2 * q, x0, x1);
          }
        }
      }
    }
    PROBE_ADD(3, t_epi);
  }
  fence_proxy_async();  // the epilogue's writes, before the next conv's wgmma reads
}

// Shared memory, from a 128-byte aligned base: [full[kMaxStages] mbarriers,
// count[kMaxStages] release counters | ring: stages x [KP][NN] bf16 | margin
// | ab0 | ab1 | margin]. ab0 and ab1 are bf16 kLmax x KP in 8-channel columns
// (element (row, ch) at (ch / 8) kLmax 8 + row 8 + ch % 8), rows [0, Lp) in
// use; the margins, `a.margin`
// rows of 16 bytes, keep the widest tap shift of a 64-row group inside the
// allocation (those rows feed only rows outside [lo, hi)).
template <typename IO, int W>
__global__ void __launch_bounds__(kBlock, 1)
resblock_kernel(const IO* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ bias, IO* __restrict__ out, ResArgs a) {
  using L = Width<W>;
  constexpr int KP = L::KP, NN = L::NN, R = L::R, NP = W / NN;
  constexpr uint32_t kUnit = 2 * KP * NN;
  extern __shared__ unsigned char smem_raw[];
  long long probe[kProbes] = {};
  PROBE_T(t_start);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  unsigned char* smem = smem_raw + (base - raw);
  Ring ring{base, base + 128, kUnit, reinterpret_cast<const char*>(w), a.stages,
            2 * a.n_dil * NP * a.k};
  unsigned char* zone = smem + 128 + (size_t)a.stages * kUnit;  // margin, ab0, ab1, margin
  bf16* ab0 = reinterpret_cast<bf16*>(zone + 16 * a.margin);
  bf16* ab1 = ab0 + kLmax<W> * KP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, g = lane >> 2, q = lane & 3;
  const int c = (a.k - 1) / 2;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * a.tile - a.halo;  // sequence position of row 0
  // the residual of this warpgroup's groups <- x (zero outside [0, T)), in
  // the accumulator layout: every load issued before anything waits on one
  Res<W> res;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 64 * (wg + kNC * r) + 16 * (warp & 3) + g + 8 * h;
      const int pos = s0 + row;
      const bool inside = row < a.Lp && pos >= 0 && pos < a.T;
      const IO* xr = x + ((size_t)b * a.T + (inside ? pos : 0)) * W + 2 * q;
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const float2 v = inside ? load2(xr + 8 * j) : make_float2(0.f, 0.f);
        res[r][4 * j + 2 * h] = v.x;
        res[r][4 * j + 2 * h + 1] = v.y;
      }
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(ring.full(s), 1);
      asm volatile("st.shared.u32 [%0], 0;\n" ::"r"(ring.count(s)) : "memory");
    }
    mbar_init_fence();
    for (int u = 0; u < min(a.stages, ring.n_units); ++u) ring.issue(u, u);
  }
  // the operand channels [W, KP) of both buffers are zero: their weights
  // are zero, and 0 x garbage could be NaN. Other rows no conv wrote
  // (beyond Lp, in the margins, outside a conv's [lo, hi)) feed only rows
  // nothing reads: a product row reads its own A row alone.
  if constexpr (KP > W) {
    constexpr int kCols = (KP - W) / 8, kPer = kLmax<W> * kCols;  // 16-byte rows
    for (int e = threadIdx.x; e < 2 * kPer; e += kBlock) {
      const int buf = e / kPer, cb = W / 8 + (e % kPer) / kLmax<W>, row = e % kLmax<W>;
      reinterpret_cast<uint4*>(buf ? ab1 : ab0)[cb * kLmax<W> + row] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // ab0 <- bf16(lrelu(x)) on this warpgroup's rows
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 64 * (wg + kNC * r) + 16 * (warp & 3) + g + 8 * h;
      if (row >= a.Lp) continue;
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
        *reinterpret_cast<uint32_t*>(ab0 + (j * kLmax<W> + row) * 8 + 2 * q) =
            pack2(lrelu(res[r][4 * j + 2 * h], a.slope),
                  lrelu(res[r][4 * j + 2 * h + 1], a.slope));
    }
  }
  fence_proxy_async();
  __syncthreads();
  PROBE_ADD(0, t_start);
  const uint32_t src0 = smem_u32(ab0), src1 = smem_u32(ab1);
  int consumed = 0;
  for (int i = 0; i < a.n_dil; ++i) {
    const int d = a.dil[i];
    const int lo = consumed + c * d, hi = a.Lp - consumed - c * d;
    conv<IO, W, false>(res, src0, ab1, bias + 2 * i * W, out, a, ring, d, lo, hi, s0, b,
                       false, probe);
    PROBE_T(t_bar1);
    __syncthreads();
    PROBE_ADD(4, t_bar1);
    conv<IO, W, true>(res, src1, ab0, bias + (2 * i + 1) * W, out, a, ring, 1, lo + c,
                      hi - c, s0, b, i == a.n_dil - 1, probe);
    PROBE_T(t_bar2);
    __syncthreads();
    PROBE_ADD(4, t_bar2);
    consumed += c * d + c;
  }
#ifdef RESBLOCK_PROBE
  PROBE_ADD(7, t_start);
  if (lane == 0)
    for (int i = 0; i < kProbes; ++i)
      atomicAdd(&g_probe_cycles[i], (unsigned long long)probe[i]);
#endif
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

template <typename IO, int W>
int launch_tc_w(const void* x, const void* w, long long w_elems, const float* bias,
                void* out, ResArgs a, int kpad, int split, cudaStream_t stream) {
  using L = tc::Width<W>;
  // The plan comes from the wrapper (ops/vocoder_kernel.py `resblock_plan`);
  // refuse one the kernel cannot run.
  const size_t smem = tc::kHeader + (size_t)a.stages * 2 * L::KP * L::NN +
                      32 * (size_t)a.margin + 4 * (size_t)tc::kLmax<W> * L::KP;
  if (kpad != L::KP || split != L::NN || a.Lp % 64 != 0 ||
      a.Lp > tc::kLmax<W> || a.stages <= tc::kInflight ||
      a.stages > tc::kMaxStages ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  // the ring's bulk copies read every image: the buffer must hold them all
  if (w_elems != 2LL * a.n_dil * a.k * L::KP * W) return (int)cudaErrorInvalidValue;
  auto kern = tc::resblock_kernel<IO, W>;
  const int attr = set_smem(kern, kMaxSmem);
  if (attr) return attr;
  const dim3 grid((a.T + a.tile - 1) / a.tile, a.B);
  kern<<<grid, tc::kBlock, smem, stream>>>(
      static_cast<const IO*>(x), static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<IO*>(out), a);
  return (int)cudaGetLastError();
}

template <typename IO>
int launch_tc(const void* x, const void* w, long long w_elems, const float* bias,
              void* out, const ResArgs& a, int kpad, int split, cudaStream_t stream) {
  switch (a.C) {
#define RESBLOCK_WIDTH(W) \
    case W: return launch_tc_w<IO, W>(x, w, w_elems, bias, out, a, kpad, split, stream);
    RESBLOCK_WIDTH(16) RESBLOCK_WIDTH(24) RESBLOCK_WIDTH(32) RESBLOCK_WIDTH(48)
    RESBLOCK_WIDTH(64) RESBLOCK_WIDTH(96) RESBLOCK_WIDTH(128) RESBLOCK_WIDTH(192)
    RESBLOCK_WIDTH(256)
#undef RESBLOCK_WIDTH
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// The bf16 path's plan limits, which ops/vocoder_kernel.py keeps a copy of
// and checks on load: per width (W, KP, NN, R), then kNC, kMaxStages,
// kInflight and kHeader.
extern "C" void resblock_limits(int* out) {
  int n = 0;
  auto put = [&](int W, int KP, int NN, int R) {
    out[n++] = W; out[n++] = KP; out[n++] = NN; out[n++] = R;
  };
#define RESBLOCK_WIDTH(W) put(W, tc::Width<W>::KP, tc::Width<W>::NN, tc::Width<W>::R);
  RESBLOCK_WIDTH(16) RESBLOCK_WIDTH(24) RESBLOCK_WIDTH(32) RESBLOCK_WIDTH(48)
  RESBLOCK_WIDTH(64) RESBLOCK_WIDTH(96) RESBLOCK_WIDTH(128) RESBLOCK_WIDTH(192)
  RESBLOCK_WIDTH(256)
#undef RESBLOCK_WIDTH
  out[n++] = tc::kNC;
  out[n++] = tc::kMaxStages;
  out[n++] = tc::kInflight;
  out[n++] = tc::kHeader;
}

#ifdef RESBLOCK_PROBE
// Probe build: host[0..7] <- the phase cycles (tc::g_probe_cycles) summed
// over the launches since the last reset; reset != 0 then zeroes them.
extern "C" int resblock_probe(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, tc::g_probe_cycles,
                                       sizeof(tc::g_probe_cycles));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zeros[tc::kProbes] = {};
    e = cudaMemcpyToSymbol(tc::g_probe_cycles, zeros, sizeof(zeros));
  }
  return (int)e;
}
#endif

// x, out [B, T, C] (float32 or bfloat16: io_bf16); w (w_elems elements,
// checked against what the shapes read), bias as described at the top;
// dil[n_dil]; Lp the window rows (tile = Lp - 2H). bf16 operands (ct_bf16):
// C one of the kernel widths, kpad, split, stages the plan's KP, NN and ring
// stages. fp32 operands: scratch fp32 [ceil(T / tile) * B, Lp, C], the
// residual of each block, or null to keep it in shared memory.
extern "C" int fused_resblock(const void* x, const void* w, long long w_elems,
                              const float* bias, void* out, void* scratch, int io_bf16,
                              int ct_bf16, int B, int T, int C, int k, int n_dil,
                              const int* dil, float slope, int Lp, int kpad, int split,
                              int stages, void* stream) {
  if (B < 1 || T < 1 || C < 1 || C > 256 || k < 1 || k > kMaxK || k % 2 == 0 ||
      n_dil < 1 || n_dil > kMaxDil)
    return (int)cudaErrorInvalidValue;
  ResArgs a = {};
  a.B = B; a.T = T; a.C = C; a.k = k; a.n_dil = n_dil; a.slope = slope; a.Lp = Lp;
  a.stages = stages;
  const int c = (k - 1) / 2;
  for (int i = 0; i < n_dil; ++i) {
    if (dil[i] < 1) return (int)cudaErrorInvalidValue;
    a.dil[i] = dil[i];
    a.halo += c * dil[i] + c;
    a.margin = max(a.margin, c * dil[i]);  // the widest tap shift, in rows
  }
  a.tile = Lp - 2 * a.halo;
  if (a.tile < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ct_bf16)
    return io_bf16 ? launch_tc<__nv_bfloat16>(x, w, w_elems, bias, out, a, kpad, split, st)
                   : launch_tc<float>(x, w, w_elems, bias, out, a, kpad, split, st);
  if (w_elems != 2LL * n_dil * k * C * C) return (int)cudaErrorInvalidValue;
  float* scr = static_cast<float*>(scratch);
  return io_bf16 ? launch_simt<__nv_bfloat16>(x, w, bias, out, scr, a, st)
                 : launch_simt<float>(x, w, bias, out, scr, a, st);
}
