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
// Its bound is operations: the resblocks do 126*C^2 multiply-adds per output
// sample. At the V1 384-frame grid the three stages are about 7.2e11 FLOP
// against about 1e8 bytes of stage input and output, far above the H100's
// ~295 FLOP/byte ridge. The chain's intermediates must stay out of device
// memory: they are 126 convolutions' worth of [T, C] tensors.
//
// Layout. One block per (time tile, batch row). The tile's residual stream
// `cur` (fp32) and one bf16 operand buffer `ab1` live in shared memory over
// the tile plus a halo on each side. The halo is the stacked receptive field
// of the widest resblock, sum over d of (k-1)/2*(d+1) = 60 samples for k=11,
// dilations 1/3/5. Each conv shrinks the window of rows that feed the tile,
// and only those rows are computed. `cur` is zero outside [0, T_out) and each
// conv's output is zeroed there, which reproduces the reference's per-conv
// zero padding. Operands are rounded to the compute dtype and the products
// accumulate in fp32, as the TPU kernel feeds bf16 to the MXU. The TPU
// kernel's lane packing and block-Toeplitz weights are a VMEM/MXU device and
// are not carried over. There are two paths, by compute dtype.
//
// bf16 operands (the serving path) run on the tensor cores, mma.sync
// m16n8k16 (namespace tc). A conv is a sum over taps j of [rows x C] @ W_j
// [C x C]. The A tile of tap j is `ab1` shifted by (j - c) * d rows, read
// with ldmatrix.
//  - Warps. At C = 128 and C = 64, eight warps each hold 128 fp32
//    accumulators, 4 m16 tiles x 64 channels (C = 128: 2 channel groups x 4
//    row groups). At C = 32, twelve warps each hold 96, 6 m16 tiles x 32
//    channels: three warps to a scheduler hide more latency, and 96
//    accumulators fit the 168 registers a thread of a 384-thread block may
//    hold. Together the warps cover every output row of a conv in one pass,
//    so each staged weight slice is applied to all of the block's rows. The
//    row groups split a conv's m16 tiles evenly, dealt so that each
//    scheduler mixes heavier and lighter groups (`warp_tiles`).
//  - Weights, through shared memory once a block and conv. The wrapper packs
//    every k16 slice of the launch, a [16 x C] bf16 image that ldmatrix.trans
//    reads without bank conflicts (`slice_chunk`), into one stream in the
//    order the warps consume them. A ring of n stages holds a pair of slices
//    each (64*C bytes, one cp.async.bulk with mbarrier completion). The last
//    warp to release a stage refills it (`Ring`). Each slice crosses L2 once
//    a block: the L2 weight traffic of the three V1 stages at B=2 on the
//    384-frame grid is 5.97 / 1.23 / 0.30 GB a launch. The earlier design
//    streamed each warp's B fragments from L2 for every 64-row chunk, about
//    28 / 11.2 / 5.2 GB.
//  - One operand buffer. conv1's operand bf16(lrelu(cur)) is staged into
//    `ab1` before conv1 (`stage_lrelu`). Because the warps hold the whole
//    conv in registers, conv1 overwrites `ab1` with its output
//    mask(lrelu(conv1)) once every warp has read it. conv2 reads `ab1` and
//    adds into `cur`. The upsample is a polyphase product (per output phase,
//    k_up/r taps of C_in = 2C channels). It is recomputed from the stage
//    input per resblock (about 3% of the work) and its input tile is staged
//    in `ab1`.
//  - Window budget (`stage_plan` in ops/vocoder_kernel.py computes it and
//    launch_tc_c checks it). A row costs (C + 8) * 6 bytes: `cur` and `ab1`
//    are padded by 8 elements so that ldmatrix and the epilogues hit distinct
//    banks. Lp is the most rows, a multiple of 16*r, that fit 227 KB beside
//    a ring of 2 stages, capped at one pass of the accumulators. The ring
//    takes the rest. At the V1 widths this gives:
//      C=128: window 256, tile 136, 2 stages (16 KB);
//      C=64:  window 512, tile 392, 2 stages (8 KB);
//      C=32:  window 928, tile 808, 4 stages (8 KB).
//    The products executed are 1.46 / 1.17 / 1.08 times the useful ones,
//    against 1.71 / 1.24 / 1.11 with the earlier three buffers.
//  - The resblock sum lives in device memory (`acc`, fp32; the output itself
//    when it is fp32). It is read and written once per resblock per tile.
//  - What bounds it now. Mostly the mma.sync issue of eight or twelve warps,
//    two or three to a scheduler, at about a quarter of the dense bf16 peak,
//    and the halo's recompute. The ring's waits take a smaller part: in the
//    probe builds of audio_calm_torch/tools/vocoder_stage_probe.py the warps
//    wait for a stage to fill in about 13% of their cycles at C = 128 (7% at
//    C = 64, 2% at C = 32), and a ring that reads no weight bytes at all
//    runs about 10% faster at C = 128 (PERF.md section 6). No cluster is
//    kept: a 2-block multicast halves the weight reads instead of removing
//    them, so it could save at most that 10%. It was not timed on this ring.
//  - Why not wgmma. Its 64-row granularity on a window whose conv extents
//    shrink by 10-60 rows per conv would execute about 1.88x the useful
//    products at C = 128, against 1.46x with m16 tiles (both reckoned from
//    the tile walk).
//
// fp32 operands (the parity runs) use direct per-tap multiply-adds on the
// CUDA cores (namespace simt). The tile is 8192 samples*channels (64 rows at
// C=128), so that each thread keeps its 32 accumulators of the resblock mean
// in registers. Shared memory is (tile + 2*halo) * (C+1) * 8 bytes, at most
// 190 KB.
//
// Layouts: x [B, T_in, C_in] and out [B, T_out, C], channels-last. fp32
// weights are one buffer, per conv [k][C_in][C] (the JAX kernel layout): the
// upsample first (if any), then per resblock and dilation conv1, conv2. bf16
// weights are the slice stream above (ops/vocoder_kernel.py
// `weight_stream`). Biases are one fp32 buffer in the fp32 weights' order.

#include "vocoder_common.cuh"

namespace {

constexpr int kMaxBlocks = 4;
constexpr int kMaxDil = 4;

struct StageArgs {
  int B, T_in, T_out, C_in, C, r, k_up, p_up;
  int tile, halo, ldc, ldh, Lp, n_stages, n_slices;
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

constexpr int kMaxStages = 16;    // weight ring stages at most
constexpr int kBarBytes = 256;    // full[kMaxStages] mbarriers + release counters
constexpr int kMaxWarps = 12;     // Layout<C>::kWarps at most

#ifdef VOCODER_STAGE_PROBE
// Probe build (not the shipped library; audio_calm_torch/tools/
// vocoder_stage_probe.py builds it): per warp index, summed over blocks, the
// clock cycles spent waiting for a ring stage to fill and the cycles from
// the kernel's start to its end.
__device__ unsigned long long g_probe_cycles[kMaxWarps][2];
#endif

// The warp layout of width C: kWarps warps in NG channel groups of NW
// output channels x MW row groups; a warp holds MT x NT accumulator tiles
// (m16 x n8) for all of its rows of a conv, so one pass covers kRows rows.
// C >= 64: 8 warps of 128 accumulators (4 m-tiles x 64 channels). C = 32:
// 12 warps of 96 (6 m-tiles x 32 channels), three to a scheduler, within
// the 168 registers a thread may hold in a block of 384 (at C >= 64 the
// 12-warp layout spills and runs slower).
template <int C>
struct Layout {
  static constexpr int kWarps = C == 32 ? 12 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int NW = C >= 64 ? 64 : 32;
  static constexpr int NG = C / NW;
  static constexpr int MW = kWarps / NG;
  static constexpr int NT = NW / 8;
  static constexpr int MT = (C == 32 ? 96 : 128) / (4 * NT);
  static constexpr int kRows = MT * MW * 16;
};
static_assert(Layout<32>::kWarps <= kMaxWarps && Layout<128>::kWarps <= kMaxWarps,
              "kMaxWarps bounds every layout");

// Shared-memory image of one k16 weight slice, [16][C] bf16: row kr holds
// input channel 16*s + kr; its 16-byte chunk `ch` (output channels 8*ch ..
// 8*ch + 7) sits at chunk position slice_chunk(kr, ch), so that the eight
// rows one ldmatrix.trans matrix reads fall in eight distinct bank groups.
// ops/vocoder_kernel.py `_smem_slices` packs this image.
template <int C>
__device__ __forceinline__ int slice_chunk(int kr, int ch) {
  return C >= 64 ? ch ^ (kr & 7) : ch ^ ((kr >> 1) & 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// `bytes` contiguous bytes global -> shared by the copy engine; completion
// is counted on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Arrive on a counter in shared memory with acquire-release order; the
// count before the arrival.
__device__ __forceinline__ uint32_t count_arrival(uint32_t addr) {
  uint32_t old;
  asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "r"(addr)
               : "memory");
  return old;
}

// The weight ring. The wrapper lays every k16 weight slice of the launch
// out in the order the warps consume them (per resblock: the upsample's
// slices, per output phase its taps' kernel rows, then per dilation conv1's
// and conv2's, per tap and k16), 32*C bytes a slice. The warps take the
// slices in pairs, and a ring stage holds one pair: stage j % n holds pair
// j, the 64*C bytes at w + j*32*C, in one bulk copy; full[s] completes on
// the issuing thread's expect_tx and the copy's bytes. Thread 0 fills the
// ring before the first pair. After that no thread waits to refill: each
// warp counts its release of a stage on the stage's counter, and the warp
// whose release is the last of the block's (the last reader) issues pair
// j + n into it.
// It reads the count only after the next pair's fragments have loaded
// (`flush`), so the atomic's latency overlaps them; the next pair is never
// the one refilled (n >= 2).
template <int C>
struct Ring {
  static constexpr uint32_t kBytes = 64 * C;  // one pair of k16 slices
  uint32_t bars, addr;                        // mbarriers, stage 0 (shared)
  const bf16* data;                           // stage 0 (generic)
  const char* src;                            // the weight stream
  int n, total;                               // stages; pairs in the stream
  int j, stage;                               // the warps' next pair and its stage
  uint32_t phase;
  int pend_j = -1, pend_s = 0;                // lane 0: the pair released last
  uint32_t pend_count = 0;                    // lane 0: its count before the arrival
#ifdef VOCODER_STAGE_PROBE
  unsigned long long waited = 0;              // cycles in wait2's mbarrier wait
#endif

  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t count(int s) const {
    return bars + 8 * kMaxStages + 4 * s;
  }
  __device__ __forceinline__ void issue(int pair, int s) const {
#ifdef VOCODER_STAGE_PROBE_NO_WEIGHTS
    // probe build: the stage completes with no copy (its weights are stale),
    // so the kernel runs its schedule without reading the weight stream
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(full(s)) : "memory");
#else
    mbar_expect_tx(full(s), kBytes);
    bulk_copy(addr + s * kBytes, src + (size_t)pair * kBytes, kBytes, full(s));
#endif
  }
  // the slices of pair j, once they have landed
  __device__ __forceinline__ void wait2(const bf16*& w0, const bf16*& w1) {
#ifdef VOCODER_STAGE_PROBE
    const long long t = clock64();
    mbar_wait(full(stage), phase);
    waited += clock64() - t;
#else
    mbar_wait(full(stage), phase);
#endif
    w0 = data + (size_t)stage * 32 * C;
    w1 = w0 + 16 * C;
  }
  // the refill of the pair released last, if this warp read it last
  __device__ __forceinline__ void flush() {
    if ((threadIdx.x & 31) == 0 && pend_j >= 0) {
      if ((pend_count + 1) % Layout<C>::kWarps == 0 && pend_j + n < total) {
        // every warp has read the pair: order those reads before the copy
        // engine's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(pend_j + n, pend_s);
      }
      pend_j = -1;
    }
  }
  __device__ __forceinline__ void release2() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      pend_count = count_arrival(count(stage));
      pend_j = j;
      pend_s = stage;
    }
    ++j;
    if (++stage == n) {
      stage = 0;
      phase ^= 1;
    }
  }
};

template <int C>
using Accs = float[Layout<C>::MT][Layout<C>::NT][4];

template <int C>
__device__ __forceinline__ void init_bias(Accs<C>& acc, const float* __restrict__ bias,
                                          int n0) {
  using L = Layout<C>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < L::NT; ++nt) {
    const int col = n0 + nt * 8 + 2 * (lane & 3);
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt) {
      acc[mt][nt][0] = b0; acc[mt][nt][1] = b1;
      acc[mt][nt][2] = b0; acc[mt][nt][3] = b1;
    }
  }
}

// B fragments of this warp's NW channels from a staged k16 slice.
template <int C>
__device__ __forceinline__ void load_b(uint32_t (&b)[Layout<C>::NT][2], const bf16* ws,
                                       int n0) {
  using L = Layout<C>;
  const int lane = threadIdx.x & 31;
  const int kr = lane & 15;
#pragma unroll
  for (int np = 0; np < L::NT / 2; ++np) {
    const int ch = n0 / 8 + 2 * np + (lane >> 4);
    uint32_t r[4];
    ldmatrix_x4_trans(r, ws + kr * C + slice_chunk<C>(kr, ch) * 8);
    b[2 * np][0] = r[0]; b[2 * np][1] = r[1];
    b[2 * np + 1][0] = r[2]; b[2 * np + 1][1] = r[3];
  }
}

// acc += sum over n_taps taps of A_tap @ W_tap for this warp's m-tiles
// mt < nm and channels [n0, n0 + NW), K = 16*KK deep a tap (KK even), one
// ring slice per (tap, k16), taken two at a time. A_tap's m16 tile mt is
// read with ldmatrix from the bf16 buffer `src` (row stride lds) from
// window row row_of(mt, tap) on (each row clamped into [0, Lp)).
template <int C, typename RowFn>
__device__ __forceinline__ void product(Accs<C>& acc, Ring<C>& ring, const bf16* src,
                                        int lds, int KK, int n_taps, int nm, int n0,
                                        int Lp, RowFn row_of) {
  using L = Layout<C>;
  const int lane = threadIdx.x & 31;
  for (int t = 0; t < n_taps; ++t) {
    const bf16* rows[L::MT];
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt)
      rows[mt] = src + min(max(row_of(mt, t) + (lane & 15), 0), Lp - 1) * lds +
                 (lane >> 4) * 8;
#pragma unroll 1
    for (int kk = 0; kk < KK; kk += 2) {
      const bf16 *w0, *w1;
      ring.wait2(w0, w1);
      uint32_t b0[L::NT][2], b1[L::NT][2];
      load_b<C>(b0, w0, n0);
      load_b<C>(b1, w1, n0);
      ring.flush();
#pragma unroll
      for (int mt = 0; mt < L::MT; ++mt) {
        if (mt < nm) {
          uint32_t a0[4], a1[4];
          ldmatrix_x4(a0, rows[mt] + kk * 16);
          ldmatrix_x4(a1, rows[mt] + kk * 16 + 16);
#pragma unroll
          for (int nt = 0; nt < L::NT; ++nt) mma(acc[mt][nt], a0, b0[nt][0], b0[nt][1]);
#pragma unroll
          for (int nt = 0; nt < L::NT; ++nt) mma(acc[mt][nt], a1, b1[nt][0], b1[nt][1]);
        }
      }
      ring.release2();
    }
  }
}

// This warp's channel base n0 and its m-tiles [m0, m0 + nm) of
// [mt_lo, mt_hi): the tiles are split evenly over the MW row groups (their
// counts differ by at most one). Warps w, w + 4 (and w + 8) share a
// scheduler, so warps 4-7 take their slots in reverse and each scheduler
// mixes heavier and lighter row groups.
template <int C>
__device__ __forceinline__ void warp_tiles(int mt_lo, int mt_hi, int& n0, int& m0,
                                           int& nm) {
  using L = Layout<C>;
  const int warp = threadIdx.x >> 5;
  const int slot = warp >= 4 && warp < 8 ? 11 - warp : warp;  // 0-3 | 7-4 | 8-11
  n0 = (slot % L::NG) * L::NW;
  const int rg = slot / L::NG, n = mt_hi - mt_lo;
  m0 = mt_lo + rg * n / L::MW;
  nm = mt_lo + (rg + 1) * n / L::MW - m0;
}

// acc's rows through f(p, col, v0, v1): window row p = row_of(m-tile index,
// row in the tile), channels col and col + 1.
template <int C, typename RowFn, typename F>
__device__ __forceinline__ void epilogue(const Accs<C>& acc, int nm, int n0,
                                         RowFn row_of, F f) {
  using L = Layout<C>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt) {
    if (mt < nm) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = row_of(mt, (lane >> 2) + 8 * h);
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt)
          f(p, n0 + nt * 8 + 2 * (lane & 3), acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
}

// ab1 rows [lo, hi) <- bf16(lrelu(cur)): conv1's A operand.
template <int C>
__device__ void stage_lrelu(const float* cur, bf16* ab1, int lo, int hi, float slope) {
  constexpr int LD = C + kPad, HALF = C / 2;
  for (int e = threadIdx.x; e < (hi - lo) * HALF; e += Layout<C>::kThreads) {
    const int p = lo + e / HALF, col = 2 * (e % HALF);
    const float2 v = *reinterpret_cast<const float2*>(cur + p * LD + col);
    *reinterpret_cast<uint32_t*>(ab1 + p * LD + col) =
        pack2(lrelu(v.x, slope), lrelu(v.y, slope));
  }
}

// One dilated conv whose output rows cover [rlo, rhi) (rounded out to m16
// tiles; rows outside the exact window are never used), its A operand read
// from ab1. The warps hold the whole conv in their accumulators, so ab1 may
// take the output once every warp has read its operand:
//   kFirst: ab1 (bf16(lrelu(cur))) -> ab1 <- mask(lrelu(conv))
//   else:   ab1 (lrelu(conv1)) -> cur += conv inside [0, T_out)
template <int C, bool kFirst>
__device__ void conv(float* cur, bf16* ab1, const float* __restrict__ bias,
                     const StageArgs& a, int k, int d, int rlo, int rhi, int s0,
                     Ring<C>& ring) {
  constexpr int LD = C + kPad;
  int n0, m0, nm;
  warp_tiles<C>(rlo / 16, (rhi + 15) / 16, n0, m0, nm);
  const int c = (k - 1) / 2;
  Accs<C> acc;
  init_bias<C>(acc, bias, n0);
  product<C>(acc, ring, ab1, LD, C / 16, k, nm, n0, a.Lp,
             [&](int mt, int tap) { return (m0 + mt) * 16 + (tap - c) * d; });
  if (kFirst) __syncthreads();  // every warp has read ab1
  epilogue<C>(acc, nm, n0, [&](int mt, int row) { return (m0 + mt) * 16 + row; },
              [&](int p, int col, float v0, float v1) {
                const int pos = s0 + p;
                const bool inside = pos >= 0 && pos < a.T_out;
                if (kFirst) {
                  *reinterpret_cast<uint32_t*>(ab1 + p * LD + col) =
                      inside ? pack2(lrelu(v0, a.slope), lrelu(v1, a.slope)) : 0u;
                } else if (inside) {
                  float2* cp = reinterpret_cast<float2*>(cur + p * LD + col);
                  float2 cv = *cp;
                  cv.x += v0;
                  cv.y += v1;
                  *cp = cv;
                }
              });
}

// Upsample rows [0, Lp) of the window: base = ConvTranspose1d_r(lrelu(x)),
// one polyphase product per output phase ph (rows p = r*u + ph; tap i uses
// kernel row kappa0(ph) + r*i and staged input row u + shift(ph) - i).
// stg holds lrelu(x) in bf16 for x rows t_base .. t_base + n_stage - 1.
// Writes cur <- base (zero outside [0, T_out)).
template <int C>
__device__ void upsample(float* cur, const bf16* stg, const float* __restrict__ bias,
                         const StageArgs& a, int s0, Ring<C>& ring) {
  constexpr int LDC = C + kPad;
  constexpr int CIN = 2 * C, LDS = CIN + kPad;  // HiFi-GAN halves the width
  const int n_taps = a.k_up / a.r;
  int n0, m0, nm;
  warp_tiles<C>(0, a.Lp / a.r / 16, n0, m0, nm);
  for (int ph = 0; ph < a.r; ++ph) {
    const int shift = (ph + a.p_up) / a.r - a.p_up / a.r + n_taps - 1;
    Accs<C> acc;
    init_bias<C>(acc, bias, n0);
    product<C>(acc, ring, stg, LDS, CIN / 16, n_taps, nm, n0, a.Lp,
               [&](int mt, int i) { return (m0 + mt) * 16 + shift - i; });
    epilogue<C>(acc, nm, n0,
                [&](int mt, int row) { return a.r * ((m0 + mt) * 16 + row) + ph; },
                [&](int p, int col, float v0, float v1) {
                  const int pos = s0 + p;
                  const bool inside = pos >= 0 && pos < a.T_out;
                  *reinterpret_cast<float2*>(cur + p * LDC + col) =
                      inside ? make_float2(v0, v1) : make_float2(0.f, 0.f);
                });
  }
}

// Staged upsample input: stg[sr] = bf16(lrelu(x[t_base + sr])), zero
// outside [0, T_in).
template <typename IO, int C>
__device__ void stage_input(bf16* stg, const IO* __restrict__ x, const StageArgs& a,
                            int b, int s0) {
  const int n_taps = a.k_up / a.r;
  const int t_base = s0 / a.r + a.p_up / a.r - (n_taps - 1);
  const int n_stage = a.Lp / a.r + (a.r - 1 + a.p_up) / a.r - a.p_up / a.r + n_taps - 1;
  const int lds = a.C_in + kPad, half = a.C_in / 2;
  for (int e = threadIdx.x; e < n_stage * half; e += Layout<C>::kThreads) {
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

// Grouped variant: cur rows [lo, hi) <- x (zero outside [0, T_out)).
template <typename IO, int C>
__device__ void load_grouped(float* cur, const IO* __restrict__ x, const StageArgs& a,
                             int b, int lo, int hi, int s0) {
  constexpr int LDC = C + kPad, HALF = C / 2;
  for (int e = threadIdx.x; e < (hi - lo) * HALF; e += Layout<C>::kThreads) {
    const int p = lo + e / HALF, col = 2 * (e % HALF);
    const int m = s0 + p;
    float v0 = 0.f, v1 = 0.f;
    if (m >= 0 && m < a.T_out) {
      const IO* xr = x + ((size_t)b * a.T_in + m) * C + col;
      v0 = to_f(xr[0]);
      v1 = to_f(xr[1]);
    }
    *reinterpret_cast<float2*>(cur + p * LDC + col) = make_float2(v0, v1);
  }
}

// Shared memory: [mbarriers + release counters | weight ring: n_stages
// pairs of k16 slices | cur fp32 Lp x (C + kPad) | ab1 bf16 Lp x (C + kPad)].
template <typename IO, int C>
__global__ void __launch_bounds__(Layout<C>::kThreads, 1)
stage_kernel(const IO* __restrict__ x, const bf16* __restrict__ w,
             const float* __restrict__ bias, IO* __restrict__ out,
             float* __restrict__ acc_buf, StageArgs a) {
  constexpr int LDC = C + kPad;
#ifdef VOCODER_STAGE_PROBE
  const long long t_start = clock64();
#endif
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bars = smem_addr(smem);
  const bf16* ring_data = reinterpret_cast<const bf16*>(smem + kBarBytes);
  float* cur = reinterpret_cast<float*>(smem + kBarBytes + (size_t)a.n_stages * 64 * C);
  bf16* ab1 = reinterpret_cast<bf16*>(cur + (size_t)a.Lp * LDC);
  Ring<C> ring{bars, smem_addr(ring_data), ring_data, reinterpret_cast<const char*>(w),
               a.n_stages, a.n_slices / 2, 0, 0, 0u};
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.n_stages; ++s) {
      mbar_init(ring.full(s), 1);
      asm volatile("st.shared.u32 [%0], 0;\n" ::"r"(ring.count(s)) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < min(a.n_stages, a.n_slices / 2); ++s) ring.issue(s, s);
  }
  __syncthreads();
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * a.tile;
  const int s0 = t0 - a.halo;  // sequence position of buffer row 0

  for (int blk = 0; blk < a.n_blocks; ++blk) {
    const int k = a.ksize[blk], c = (k - 1) / 2;
    const int hblk = block_halo(a, blk);
    const int lo = a.halo - hblk, hi = a.halo + a.tile + hblk;
    if (a.k_up > 0) {
      stage_input<IO, C>(ab1, x, a, b, s0);
      __syncthreads();
      upsample<C>(cur, ab1, bias, a, s0, ring);
    } else {
      load_grouped<IO, C>(cur, x, a, b, lo, hi, s0);
    }
    __syncthreads();
    int consumed = 0;
    for (int i = 0; i < a.n_dil[blk]; ++i) {
      const int d = a.dil[blk][i];
      const int r1lo = lo + consumed + c * d, r1hi = hi - consumed - c * d;
      stage_lrelu<C>(cur, ab1, lo + consumed, hi - consumed, a.slope);
      __syncthreads();
      conv<C, true>(cur, ab1, bias + a.b1[blk][i], a, k, d, r1lo, r1hi, s0, ring);
      __syncthreads();
      conv<C, false>(cur, ab1, bias + a.b2[blk][i], a, k, 1, r1lo + c, r1hi - c, s0,
                     ring);
      __syncthreads();
      consumed += c * d + c;
    }
    // resblock sum over the tile's rows, in fp32 device memory
    const bool last = blk == a.n_blocks - 1;
    const int rows = min(a.tile, a.T_out - t0);
    for (int e = threadIdx.x; e < rows * (C / 2); e += Layout<C>::kThreads) {
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
#ifdef VOCODER_STAGE_PROBE
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&g_probe_cycles[threadIdx.x >> 5][0], ring.waited);
    atomicAdd(&g_probe_cycles[threadIdx.x >> 5][1],
              (unsigned long long)(clock64() - t_start));
  }
#endif
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
int launch_tc_c(const void* x, const void* w, long long w_elems, const float* bias,
                void* out, float* acc, StageArgs a, cudaStream_t stream) {
  // The plan (Lp, tile, n_stages) comes from the wrapper
  // (ops/vocoder_kernel.py `stage_plan`); refuse one the kernel cannot run.
  const size_t per_row = (size_t)(C + tc::kPad) * 6;  // cur fp32 + ab1 bf16
  const int unit = 16 * a.r;
  if (a.Lp % unit != 0 || a.Lp > tc::Layout<C>::kRows || a.tile != a.Lp - 2 * a.halo ||
      a.tile < unit || a.n_stages < 2 || a.n_stages > tc::kMaxStages)
    return (int)cudaErrorInvalidValue;
  if (a.k_up > 0) {
    const int n_taps = a.k_up / a.r;
    const int n_stage = a.Lp / a.r + (a.r - 1 + a.p_up) / a.r - a.p_up / a.r + n_taps - 1;
    if (a.C_in != 2 * C ||
        (size_t)n_stage * (a.C_in + tc::kPad) > (size_t)a.Lp * (C + tc::kPad))
      return (int)cudaErrorInvalidValue;
  }
  a.n_slices = 0;  // the weight stream's k16 slices (see tc::Ring)
  for (int blk = 0; blk < a.n_blocks; ++blk)
    a.n_slices += a.k_up * a.C_in / 16 + 2 * a.n_dil[blk] * a.ksize[blk] * C / 16;
  // the ring's bulk copies read every slice: the buffer must hold them all
  if (w_elems != (long long)a.n_slices * 16 * C) return (int)cudaErrorInvalidValue;
  const size_t smem = tc::kBarBytes + (size_t)a.n_stages * 64 * C + a.Lp * per_row;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = tc::stage_kernel<IO, C>;
  const int attr = set_smem(kern, kMaxSmem);
  if (attr) return attr;
  const dim3 grid((a.T_out + a.tile - 1) / a.tile, a.B);
  constexpr int kBlock = tc::Layout<C>::kThreads;
  kern<<<grid, kBlock, smem, stream>>>(
      static_cast<const IO*>(x), static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<IO*>(out), acc, a);
  return (int)cudaGetLastError();
}

template <typename IO>
int launch_tc(const void* x, const void* w, long long w_elems, const float* bias,
              void* out, float* acc, const StageArgs& a, cudaStream_t stream) {
  switch (a.C) {
    case 32: return launch_tc_c<IO, 32>(x, w, w_elems, bias, out, acc, a, stream);
    case 64: return launch_tc_c<IO, 64>(x, w, w_elems, bias, out, acc, a, stream);
    case 128: return launch_tc_c<IO, 128>(x, w, w_elems, bias, out, acc, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// The bf16 path's plan limits, which ops/vocoder_kernel.py keeps a copy of
// and checks on load: out[0..2] = Layout<C>::kRows at C = 32, 64, 128,
// out[3] = kBarBytes, out[4] = kMaxStages.
extern "C" void vocoder_stage_limits(int* out) {
  out[0] = tc::Layout<32>::kRows;
  out[1] = tc::Layout<64>::kRows;
  out[2] = tc::Layout<128>::kRows;
  out[3] = tc::kBarBytes;
  out[4] = tc::kMaxStages;
}

#ifdef VOCODER_STAGE_PROBE
// Probe build: host[w][0..1] <- the wait and kernel cycles of warp index w
// (kMaxWarps rows), summed over the launches since the last reset; reset != 0
// then zeroes them.
extern "C" int vocoder_stage_probe(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, tc::g_probe_cycles,
                                       sizeof(tc::g_probe_cycles));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zeros[tc::kMaxWarps][2] = {};
    e = cudaMemcpyToSymbol(tc::g_probe_cycles, zeros, sizeof(zeros));
  }
  return (int)e;
}
#endif

// k_up == 0 selects the grouped variant (no upsample, C_in == C, r = 1).
// w_elems: the elements of w (the fp32 weights or the bf16 slice stream),
// checked against what the shapes below read from it.
// ksize[n_blocks], n_dil[n_blocks], dil[n_blocks * 4] (row-major, padded).
// acc: fp32 [B, T_out, C] resblock-sum scratch for the bf16-operand path
// (the output itself when io is fp32); unused with fp32 operands.
// Lp, tile, n_stages: the bf16 path's tile plan (window rows, output rows a
// block, weight ring stages); unused with fp32 operands.
extern "C" int vocoder_stage(const void* x, const void* w, long long w_elems,
                             const float* bias, void* out, void* acc, int io_bf16,
                             int ct_bf16,
                             int B, int T_in, int C_in, int C, int r, int k_up,
                             int n_blocks, const int* ksize, const int* n_dil,
                             const int* dil, float slope, int Lp, int tile,
                             int n_stages, void* stream) {
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
    a.Lp = Lp; a.tile = tile; a.n_stages = n_stages;
    return io_bf16 ? launch_tc<__nv_bfloat16>(x, w, w_elems, bias, out, accp, a, st)
                   : launch_tc<float>(x, w, w_elems, bias, out, accp, a, st);
  }
  if (w_elems != woff) return (int)cudaErrorInvalidValue;
  return io_bf16 ? launch_simt<__nv_bfloat16>(x, w, bias, out, a, st)
                 : launch_simt<float>(x, w, bias, out, a, st);
}
