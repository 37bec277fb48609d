// attention_bwd: backward of the fused attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_bwd_kernel`, the backward of JAX
// `flash_attention` (audio_calm_tpu/ops/pallas_attention.py). Given the
// forward's inputs q [B, T, Hq, d], k/v [B, S, Hkv, d], key_valid [B, S]
// (uint8), its output o and the output's gradient dO (all [B, T, Hq, d]
// like q), it computes, per (batch, head),
//   P  = softmax(mask(q k^T * s))          recomputed
//   dV = P^T dO,  dP = dO V^T,  delta = rowsum(dO * O),
//   dS = P * (dP - delta),  dQ = dS K * s,  dK = dS^T Q * s
// with s = d^-1/2, GQA (query head h reads kv head h / (Hq / Hkv); the
// query heads of one kv head sum into its dK and dV), masked scores -1e30
// (a fully masked row keeps a uniform P over all S keys, as in the
// forward; keys beyond S have no weight at all), causal offset S - T, fp32
// softmax and sums, and the outputs in the input dtype. The TPU kernel keeps
// a whole [T, S] tile in VMEM per (batch, kv head); here the work is split
// the FlashAttention-2 way, in two launches, without atomics, so every
// output element is written by exactly one block and two launches on the
// same inputs give the same bits:
//
//   pass A (dq_kernel), one block per (query tile, query head, batch): a
//     first sweep over the key tiles gives each row's softmax max m and sum
//     l (online); delta comes from the row's dO and O. A second sweep
//     recomputes P, dP and dS per key tile and accumulates dQ. It writes
//     (m, 1/l, delta) per row for pass B.
//   pass B (dkv_kernel), one block per (key tile, kv head, batch): loops
//     over the query heads of the kv head and their query tiles, recomputes
//     P and dS from the stored row statistics, and accumulates dK and dV.
//
// m and 1/l are kept apart (not as a log-sum-exp): with every key masked,
// m = -1e30 and -1e30 + log(l) would round back to -1e30, losing the 1/S.
//
// What bounds it on this card. At the training shape (one Qwen2 layer of
// one microbatch slice: q/o/dO [16, 97, 12, 128], k/v [16, 97, 2, 128],
// bf16, causal) the five products are 2.3 GFLOP and the inputs and outputs
// 22.3 MB: 2.3 us at 989 TFLOP/s against 6.6 us at 3.35 TB/s, so bytes
// bound it, and only a kernel that keeps its operands on chip and its
// products on the tensor cores comes near. (At the DiT self-attention
// shape [2, 384, 16, 64], non-causal, with every key valid: 3.0 GFLOP and
// 6.3 MB, 3.1 us against 1.9 us, operations.) A CUDA-core kernel whose
// multiply-adds read both operands from shared memory is bound by that
// traffic instead, two orders of magnitude above. The bf16 path:
//
//   * runs all products on the tensor cores: mma.sync m16n8k16, bf16
//     operands read by ldmatrix / ldmatrix.trans, fp32 accumulators;
//   * keeps scores, probabilities and dS in registers: an accumulator
//     fragment of S or dS is packed to bf16 and fed straight back as the A
//     operand of the next product (dQ += dS K in pass A; pass B computes
//     the transposed products S^T = K Q^T and dP^T = V dO^T, so that P^T
//     and dS^T are A operands of dV += P^T dO and dK += dS^T Q). P and dS
//     are rounded to bf16 only as operands of those products (the forward's
//     P @ V rounds P the same way); the sums stay fp32;
//   * streams K/V tiles (pass A) and Q/dO tiles with their row statistics
//     (pass B) through a double-buffered ring of cp.async 16-byte copies,
//     so that the next tile's load overlaps the current tile's products;
//     rows are padded by 8 elements so that ldmatrix hits distinct banks;
//   * skips, under the causal mask, the key tiles (pass A) and query tiles
//     (pass B) that the mask zeroes, unless a query row of the batch has no
//     valid key at all (its P is uniform over every key);
//   * fills the card at the training shape: pass B's 32-key blocks alone
//     would be 4 x 2 x 16 = 128 blocks of 2 warps; each block runs up to 4
//     teams of 2 warps, which share the kv head's (query head, query tile)
//     items (6 heads x 4 tiles at GQA 12/2) round-robin, each with its own
//     ring, and sum their dK/dV in shared memory in a fixed order at the
//     end. Pass A reads the warps' Q and dO fragments from shared memory at
//     each use rather than holding them in registers, so that 3 blocks fit
//     an SM at d = 128 and its 384 blocks run as one wave;
//   * at long sequences (T or S >= 256, the DiT self-attention) the grids
//     fill the card on their own and the load traffic matters more: pass A
//     takes 128 query rows a block and pass B 64 keys a block (one team
//     where the grid covers the card four times), so each block streams
//     the other operand through its ring half as often as the short
//     shapes' tiles would.
//
// fp32 inputs (parity runs, not the training path) keep the CUDA-core code:
// four threads a row, tiles in shared memory, fp32 throughout.
//
// Layouts as in JAX: [B, T, H, d], contiguous, rows 16-byte aligned (the
// wrapper realigns). d is a template parameter (32, 48, 64, 96, 128); at
// d = 48 the loops over k16 slices run 3 times and delta's 6 chunks a row
// fall to the quad's threads 2, 2, 1, 1.

#include "common.cuh"

#include <math.h>

namespace {

constexpr float kMasked = -1e30f;

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kThreads = 128;
constexpr int kTPR = 4;                  // threads per row
constexpr int kRows = kThreads / kTPR;   // rows a block owns: 32
constexpr int kTile = 64;                // streamed rows (keys in A, queries in B)

// rows [r0, r0 + n) of one head (row stride `stride` elements) -> shared
// [n][D + 1] fp32; rows at or past `limit` are zero
template <int D>
__device__ void load_rows(float* dst, const float* __restrict__ src, size_t stride, int r0,
                          int n, int limit) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int r = e / D, dd = e % D;
    dst[r * (D + 1) + dd] = r0 + r < limit ? src[(size_t)(r0 + r) * stride + dd] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 16
  for (int dd = 0; dd < D; ++dd) acc = fmaf(a[dd], b[dd], acc);
  return acc;
}

// pass A: row statistics and dQ
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ o,
          const float* __restrict__ dout, const uint8_t* __restrict__ key_valid,
          float* __restrict__ dq, float4* __restrict__ stats, int Tq, int S, int Hq,
          int Hkv, int causal, float scale) {
  constexpr int LD = D + 1, LDP = kTile + 1;
  constexpr int DPT = D / kTPR, KPT = kTile / kTPR;
  extern __shared__ float sm[];
  float* Qs = sm;                 // [kRows][LD]
  float* Gs = Qs + kRows * LD;    // dO rows [kRows][LD]
  float* Ks = Gs + kRows * LD;    // [kTile][LD]
  float* Vs = Ks + kTile * LD;    // [kTile][LD]
  float* Ps = Vs + kTile * LD;    // dS [kRows][LDP]

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, row = tid / kTPR, sub = tid % kTPR;
  const int qi = q0 + row, shift = S - Tq;
  const bool live = qi < Tq;
  const uint8_t* valid = key_valid + (size_t)b * S;
  const size_t qstride = (size_t)Hq * D, kstride = (size_t)Hkv * D;
  const size_t qbase = ((size_t)b * Tq * Hq + h) * D;
  const float* kb = k + ((size_t)b * S * Hkv + hk) * D;
  const float* vb = v + ((size_t)b * S * Hkv + hk) * D;

  load_rows<D>(Qs, q + qbase, qstride, q0, kRows, Tq);
  load_rows<D>(Gs, dout + qbase, qstride, q0, kRows, Tq);
  float delta = 0.f;
  if (live) {
    const size_t row0 = qbase + (size_t)qi * qstride;
#pragma unroll 8
    for (int j = 0; j < DPT; ++j) {
      const int dd = sub + kTPR * j;
      delta = fmaf(dout[row0 + dd], o[row0 + dd], delta);
    }
  }
  delta = quad_sum(delta);

  // sweep 1: m and l of the row
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();  // Qs/Gs ready; the previous tile consumed
    load_rows<D>(Ks, kb, kstride, k0, kTile, S);
    __syncthreads();
    float sc[KPT];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kk = sub + kTPR * i, s = k0 + kk;
      sc[i] = -INFINITY;  // beyond the sequence: no weight at all
      if (s < S) {
        const bool ok = valid[s] != 0 && (!causal || s <= qi + shift);
        sc[i] = ok ? dot<D>(Qs + row * LD, Ks + kk * LD) * scale : kMasked;
      }
      mx = fmaxf(mx, sc[i]);
    }
    const float m_new = fmaxf(m, quad_max(mx));
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i)
      psum += sc[i] == -INFINITY ? 0.f : expf(sc[i] - m_new);
    l = l * expf(m - m_new) + quad_sum(psum);  // expf(-inf) = 0 on the first tile
    m = m_new;
  }
  const float inv_l = 1.f / l;
  if (live && sub == 0)
    stats[((size_t)b * Hq + h) * Tq + qi] = make_float4(m, inv_l, delta, 0.f);

  // sweep 2: dS per key tile, dQ += dS K
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();
    load_rows<D>(Ks, kb, kstride, k0, kTile, S);
    load_rows<D>(Vs, vb, kstride, k0, kTile, S);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kk = sub + kTPR * i, s = k0 + kk;
      float ds = 0.f;
      if (s < S) {
        const bool ok = valid[s] != 0 && (!causal || s <= qi + shift);
        const float sc = ok ? dot<D>(Qs + row * LD, Ks + kk * LD) * scale : kMasked;
        const float p = expf(sc - m) * inv_l;
        ds = p * (dot<D>(Gs + row * LD, Vs + kk * LD) - delta);
      }
      Ps[row * LDP + kk] = ds;
    }
    __syncwarp();  // the row's dS values come from the same warp
    for (int kk = 0; kk < kTile; ++kk) {
      const float ds = Ps[row * LDP + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] = fmaf(ds, Ks[kk * LD + sub + kTPR * j], acc[j]);
    }
  }
  if (live) {
    float* dst = dq + qbase + (size_t)qi * qstride;
#pragma unroll
    for (int j = 0; j < DPT; ++j) dst[sub + kTPR * j] = acc[j] * scale;
  }
}

// pass B: dK and dV
template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const uint8_t* __restrict__ key_valid, const float4* __restrict__ stats,
           float* __restrict__ dk, float* __restrict__ dv, int Tq, int S, int Hq, int Hkv,
           int causal, float scale) {
  constexpr int LD = D + 1, LDP = kTile + 1;
  constexpr int DPT = D / kTPR, QPT = kTile / kTPR;
  extern __shared__ float sm[];
  float* Ks = sm;                  // [kRows][LD]
  float* Vs = Ks + kRows * LD;     // [kRows][LD]
  float* Qs = Vs + kRows * LD;     // [kTile][LD]
  float* Gs = Qs + kTile * LD;     // dO [kTile][LD]
  float* Ps = Gs + kTile * LD;     // P [kRows][LDP]
  float* Ds = Ps + kRows * LDP;    // dS [kRows][LDP]
  float* Ms = Ds + kRows * LDP;    // [kTile] row max
  float* Ls = Ms + kTile;          // [kTile] 1 / row sum
  float* Dl = Ls + kTile;          // [kTile] delta

  const int s0 = blockIdx.x * kRows, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int tid = threadIdx.x, row = tid / kTPR, sub = tid % kTPR;
  const int sk = s0 + row, shift = S - Tq;
  const bool live = sk < S;
  const bool kv_ok = live && key_valid[(size_t)b * S + sk] != 0;
  const size_t qstride = (size_t)Hq * D, kstride = (size_t)Hkv * D;
  const size_t kbase = ((size_t)b * S * Hkv + hk) * D;

  load_rows<D>(Ks, k + kbase, kstride, s0, kRows, S);
  load_rows<D>(Vs, v + kbase, kstride, s0, kRows, S);

  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const size_t qbase = ((size_t)b * Tq * Hq + h) * D;
    const float4* st_h = stats + ((size_t)b * Hq + h) * Tq;
    for (int t0 = 0; t0 < Tq; t0 += kTile) {
      __syncthreads();  // Ks/Vs ready; the previous tile consumed
      load_rows<D>(Qs, q + qbase, qstride, t0, kTile, Tq);
      load_rows<D>(Gs, dout + qbase, qstride, t0, kTile, Tq);
      for (int r = tid; r < kTile; r += kThreads) {
        const float4 sv = t0 + r < Tq ? st_h[t0 + r] : make_float4(0.f, 0.f, 0.f, 0.f);
        Ms[r] = sv.x;
        Ls[r] = sv.y;
        Dl[r] = sv.z;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int qq = sub + kTPR * i, t = t0 + qq;
        float p = 0.f, ds = 0.f;
        if (live && t < Tq) {
          const bool ok = kv_ok && (!causal || sk <= t + shift);
          const float sc = ok ? dot<D>(Qs + qq * LD, Ks + row * LD) * scale : kMasked;
          p = expf(sc - Ms[qq]) * Ls[qq];
          ds = p * (dot<D>(Gs + qq * LD, Vs + row * LD) - Dl[qq]);
        }
        Ps[row * LDP + qq] = p;
        Ds[row * LDP + qq] = ds;
      }
      __syncwarp();  // the row's P and dS values come from the same warp
      for (int qq = 0; qq < kTile; ++qq) {
        const float p = Ps[row * LDP + qq], ds = Ds[row * LDP + qq];
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          dv_acc[j] = fmaf(p, Gs[qq * LD + sub + kTPR * j], dv_acc[j]);
          dk_acc[j] = fmaf(ds, Qs[qq * LD + sub + kTPR * j], dk_acc[j]);
        }
      }
    }
  }
  if (live) {
    float* dkr = dk + kbase + (size_t)sk * kstride;
    float* dvr = dv + kbase + (size_t)sk * kstride;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dkr[sub + kTPR * j] = dk_acc[j] * scale;
      dvr[sub + kTPR * j] = dv_acc[j];
    }
  }
}

template <int D>
constexpr size_t smem_a() {
  return sizeof(float) * (2 * kRows * (D + 1) + 2 * kTile * (D + 1) + kRows * (kTile + 1));
}

template <int D>
constexpr size_t smem_b() {
  return sizeof(float) *
         (2 * kRows * (D + 1) + 2 * kTile * (D + 1) + 2 * kRows * (kTile + 1) + 3 * kTile);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const uint8_t* valid, void* dq, void* dk, void* dv, float4* stats, int B,
           int Tq, int S, int Hq, int Hkv, int causal, cudaStream_t st) {
  const float scale = 1.0f / sqrtf((float)D);
  // the shared-memory sizes are fixed per instantiation: set them once
  static const int attr = [] {
    const int e = set_smem(dq_kernel<D>, smem_a<D>());
    return e != 0 ? e : set_smem(dkv_kernel<D>, smem_b<D>());
  }();
  if (attr != 0) return attr;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(dout);
  dq_kernel<D><<<dim3((Tq + kRows - 1) / kRows, Hq, B), kThreads, smem_a<D>(), st>>>(
      qt, kt, vt, static_cast<const float*>(o), gt, valid, static_cast<float*>(dq), stats,
      Tq, S, Hq, Hkv, causal, scale);
  const int e = (int)cudaGetLastError();
  if (e != 0) return e;
  dkv_kernel<D><<<dim3((S + kRows - 1) / kRows, Hkv, B), kThreads, smem_b<D>(), st>>>(
      qt, kt, vt, gt, valid, stats, static_cast<float*>(dk), static_cast<float*>(dv), Tq,
      S, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulators)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kPad = 8;  // row padding of the shared tiles, in elements
constexpr float kLog2e = 1.4426950408889634f;

// pass A: blocks of WA warps (a template parameter) of 16 query rows; key
// tiles of 64 (d <= 64) or 32 rows
template <int D> constexpr int kKeyTile = D <= 64 ? 64 : 32;
// pass B: teams of KW warps (a template parameter) of 16 keys, at most
// kThreadsB threads a block, share the (query head, query tile) items of a
// kv head; query tiles of kBQB rows
constexpr int kBQB = 32;
constexpr int kThreadsB = 256;

// rows [r0, r0 + n) of one head (row stride `stride` elements) -> shared
// [n][D + kPad], asynchronously, by threads `tid` of `nt`; rows at or past
// `limit` are zero
template <int D>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* __restrict__ src,
                                          size_t stride, int r0, int n, int limit,
                                          int tid, int nt) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int e = tid; e < n * CH; e += nt) {
    const int r = e / CH, ch = e % CH;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * (D + kPad) + ch * 8,
               ok ? src + (size_t)(r0 + r) * stride + ch * 8 : src, ok);
  }
}

// sum over 8 bf16 pairs of a[i] * b[i], fp32
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[i]));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv[i]));
    acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
  }
  return acc;
}

// Is some key in [0, hi] valid? (block-wide; hi < 0: none)
__device__ __forceinline__ bool any_valid(const uint8_t* valid, int hi) {
  bool any = false;
  for (int s = threadIdx.x; s <= hi; s += blockDim.x) any |= valid[s] != 0;
  return __syncthreads_or(any) != 0;
}

// pass A: row statistics and dQ
template <int D, int WA>
__global__ void __launch_bounds__(32 * WA, WA == 4 ? 3 : 2)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ o, const bf16* __restrict__ dout,
          const uint8_t* __restrict__ key_valid, bf16* __restrict__ dq,
          float4* __restrict__ stats, int Tq, int S, int Hq, int Hkv, int causal,
          float scale) {
  constexpr int BK = kKeyTile<D>, LD = D + kPad, KD = D / 16, ND = D / 8, NS = BK / 8;
  constexpr int BQ = 16 * WA, NT = 32 * WA;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BQ][LD]
  bf16* Gs = Qs + BQ * LD;                    // dO [BQ][LD]
  bf16* Ks = Gs + BQ * LD;                    // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                // [2][BK][LD]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int shift = S - Tq;
  const float sl2 = scale * kLog2e;  // scores in log2 units: exp2f below
  const uint8_t* valid = key_valid + (size_t)b * S;
  const size_t qstride = (size_t)Hq * D, kstride = (size_t)Hkv * D;
  const size_t qbase = ((size_t)b * Tq * Hq + h) * D;
  const bf16* kb = k + ((size_t)b * S * Hkv + hk) * D;
  const bf16* vb = v + ((size_t)b * S * Hkv + hk) * D;
  const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  // Causal: the block's rows see keys below kv_hi, and the keys above have
  // no weight if the first row (which sees the fewest) has a valid key;
  // otherwise a row may be fully masked, uniform over all S keys.
  int kv_hi = S;
  if (causal && any_valid(valid, min(q0 + shift, S - 1)))
    kv_hi = min(S, min(q0 + BQ, Tq) + shift);
  const int n_tiles = (kv_hi + BK - 1) / BK;

  copy_rows<D>(Qs, q + qbase, qstride, q0, BQ, Tq, tid, NT);
  copy_rows<D>(Gs, dout + qbase, qstride, q0, BQ, Tq, tid, NT);
  copy_rows<D>(Ks, kb, kstride, 0, BK, S, tid, NT);
  cp_async_commit();

  float delta[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float acc = 0.f;
    if (qrow[hr] < Tq) {
      const size_t off = qbase + (size_t)qrow[hr] * qstride;
      const uint4* po = reinterpret_cast<const uint4*>(o + off);
      const uint4* pg = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
      for (int c = qd; c < D / 8; c += 4) acc += dot8(__ldg(po + c), __ldg(pg + c));
    }
    delta[hr] = quad_sum(acc);
  }

  // this warp's A fragments of Q and dO are read from shared memory at each
  // use: holding them in registers costs a block an SM at d = 128
  const bf16* q_frag = Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const bf16* g_frag = Gs + (q_frag - Qs);
  // a warp whose 16 rows all lie past Tq computes nothing
  const bool warp_live = q0 + warp * 16 < Tq;
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};

  // sweep 1 over tiles 0 .. n_tiles - 1 (K only), sweep 2 over them again
  // (K and V), as one pipelined sequence
  for (int i = 0; i < 2 * n_tiles; ++i) {
    const bool sweep2 = i >= n_tiles;
    const int k0 = (sweep2 ? i - n_tiles : i) * BK;
    const bf16* Kt = Ks + (i & 1) * BK * LD;
    const bf16* Vt = Vs + (i & 1) * BK * LD;
    cp_async_wait<0>();
    __syncthreads();  // tile i visible to all; tile i - 1 consumed by all
    if (i + 1 < 2 * n_tiles) {
      const int j = i + 1, kn = (j >= n_tiles ? j - n_tiles : j) * BK;
      copy_rows<D>(Ks + (j & 1) * BK * LD, kb, kstride, kn, BK, S, tid, NT);
      if (j >= n_tiles) copy_rows<D>(Vs + (j & 1) * BK * LD, vb, kstride, kn, BK, S, tid, NT);
      cp_async_commit();
    }
    if (!warp_live) continue;

    // scores: s[nt] is the m16 x n8 tile of keys k0 + 8 nt ..
    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, q_frag + kk * 16);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma(s[2 * np], qa, kf[0], kf[1]);
        mma(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }
    // mask (rows g: elements 0, 1; g + 8: elements 2, 3), log2 units
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * qd + (e & 1);
        float val = -INFINITY;  // beyond the sequence: no weight at all
        if (key < S) {
          const bool ok = valid[key] != 0 && (!causal || key <= qrow[e >> 1] + shift);
          val = ok ? s[nt][e] * sl2 : kMasked;
        }
        s[nt][e] = val;
      }
    }

    if (!sweep2) {  // online max and sum; the quad's partial sums add up later
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hr], s[nt][2 * hr + 1]));
        const float m_new = fmaxf(m[hr], quad_max(mx));
        float psum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
          psum += exp2f(s[nt][2 * hr] - m_new) + exp2f(s[nt][2 * hr + 1] - m_new);
        l[hr] = l[hr] * exp2f(m[hr] - m_new) + psum;  // exp2f(-inf) = 0 on the first tile
        m[hr] = m_new;
      }
      continue;
    }
    if (i == n_tiles) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        inv_l[hr] = 1.f / quad_sum(l[hr]);
        if (qd == 0 && qrow[hr] < Tq)
          stats[((size_t)b * Hq + h) * Tq + qrow[hr]] =
              make_float4(m[hr], inv_l[hr], delta[hr], 0.f);
      }
    }

    // dP = dO V^T
    float dp[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ga[4];
      ldmatrix_x4(ga, g_frag + kk * 16);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t vf[4];
        ldmatrix_x4(vf, Vt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma(dp[2 * np], ga, vf[0], vf[1]);
        mma(dp[2 * np + 1], ga, vf[2], vf[3]);
      }
    }
    // dS = P * (dP - delta), in place of the scores
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const float p = exp2f(s[nt][e] - m[hr]) * inv_l[hr];
        s[nt][e] = p * (dp[nt][e] - delta[hr]);
      }
    }
    // dQ += dS K: dS tiles of keys 16 kp .. 16 kp + 15 are one k16 A operand
#pragma unroll
    for (int kp = 0; kp < NS / 2; ++kp) {
      const uint32_t da[4] = {pack2(s[2 * kp][0], s[2 * kp][1]),
                              pack2(s[2 * kp][2], s[2 * kp][3]),
                              pack2(s[2 * kp + 1][0], s[2 * kp + 1][1]),
                              pack2(s[2 * kp + 1][2], s[2 * kp + 1][3])};
#pragma unroll
      for (int dp2 = 0; dp2 < KD; ++dp2) {
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, Kt + (kp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                  dp2 * 16 + (lane >> 4) * 8);
        mma(acc[2 * dp2], da, kf[0], kf[1]);
        mma(acc[2 * dp2 + 1], da, kf[2], kf[3]);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (qrow[hr] < Tq) {
      bf16* dst = dq + qbase + (size_t)qrow[hr] * qstride + 2 * qd;
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<uint32_t*>(dst + j * 8) =
            pack2(acc[j][2 * hr] * scale, acc[j][2 * hr + 1] * scale);
    }
  }
}

// pass B: dK and dV. The block's work is the (query head, query tile)
// items of its kv head; team `tm` (KW warps) takes items tm, tm + teams, ...;
// warp `kw` of a team owns keys s0 + 16 kw ..
template <int D, int KW>
__global__ void __launch_bounds__(kThreadsB, D <= 64 ? 2 : 1)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const bf16* __restrict__ dout, const uint8_t* __restrict__ key_valid,
           const float4* __restrict__ stats, bf16* __restrict__ dk, bf16* __restrict__ dv,
           int Tq, int S, int Hq, int Hkv, int causal, float scale) {
  constexpr int BQ = kBQB, BK = 16 * KW, TT = 32 * KW;  // TT: a team's threads
  constexpr int LD = D + kPad, KD = D / 16, ND = D / 8;
  constexpr int RING = 2 * BQ * LD;  // Q and dO rows of one stage
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);   // [BK][LD]
  bf16* Vs = Ks + BK * LD;                     // [BK][LD]
  bf16* ring = Vs + BK * LD;                   // [teams][2 stages][Q, dO][BQ][LD]
  const int teams = blockDim.x / TT;
  float4* St = reinterpret_cast<float4*>(ring + teams * 2 * RING);  // [teams][2][BQ]

  const int s0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int tm = warp / KW, kw = warp % KW, ttid = tid % TT;
  const int shift = S - Tq;
  const float sl2 = scale * kLog2e;
  const uint8_t* valid = key_valid + (size_t)b * S;
  const size_t qstride = (size_t)Hq * D, kstride = (size_t)Hkv * D;
  const size_t kbase = ((size_t)b * S * Hkv + hk) * D;
  // this thread's two keys: g and g + 8 of its warp's 16
  int key[2];
  bool key_ok[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    key[hr] = s0 + kw * 16 + g + 8 * hr;
    key_ok[hr] = key[hr] < S && valid[key[hr]] != 0;
  }

  // Causal: queries before t_lo do not see the block's keys; they carry no
  // weight there unless a row is fully masked (then the first row is)
  int t_lo = 0;
  if (causal && any_valid(valid, min(shift, S - 1))) t_lo = max(0, s0 - shift) / 16 * 16;
  const int per_head = Tq > t_lo ? (Tq - t_lo + BQ - 1) / BQ : 0;
  const int n_all = group * per_head;
  const int n_items = n_all > tm ? (n_all - tm + teams - 1) / teams : 0;  // this team's

  bf16* my_ring = ring + tm * 2 * RING;
  float4* my_st = St + tm * 2 * BQ;
  auto fetch = [&](int j) {  // the team's j-th item into ring stage j & 1
    const int item = tm + j * teams;
    const int h = hk * group + item / per_head;
    const int t0 = t_lo + (item % per_head) * BQ;
    const size_t qbase = ((size_t)b * Tq * Hq + h) * D;
    bf16* dst = my_ring + (j & 1) * RING;
    copy_rows<D>(dst, q + qbase, qstride, t0, BQ, Tq, ttid, TT);
    copy_rows<D>(dst + BQ * LD, dout + qbase, qstride, t0, BQ, Tq, ttid, TT);
    const float4* st_h = stats + ((size_t)b * Hq + h) * Tq;
    for (int r = ttid; r < BQ; r += TT)
      cp_async16(my_st + (j & 1) * BQ + r, t0 + r < Tq ? st_h + t0 + r : st_h,
                 t0 + r < Tq);
  };

  copy_rows<D>(Ks, k + kbase, kstride, s0, BK, S, tid, blockDim.x);
  copy_rows<D>(Vs, v + kbase, kstride, s0, BK, S, tid, blockDim.x);
  if (n_items > 0) fetch(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // K/V rows from every team visible to all

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const bf16* kw_rows = Ks + (kw * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const bf16* vw_rows = Vs + (kw_rows - Ks);
  for (int i = 0; i < n_items; ++i) {
    cp_async_wait<0>();
    // the team's own barrier: item i visible to the team, item i - 1 consumed
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + tm), "r"(TT) : "memory");
    if (i + 1 < n_items) {
      fetch(i + 1);
      cp_async_commit();
    }
    const int t0 = t_lo + ((tm + i * teams) % per_head) * BQ;
    const bf16* Qt = my_ring + (i & 1) * RING;
    const bf16* Gt = Qt + BQ * LD;
    const float4* Sr = my_st + (i & 1) * BQ;

    // S^T = K Q^T and dP^T = V dO^T for the 32 queries: st[nt] is keys x
    // queries 8 nt ..
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, kw_rows + kk * 16);
      ldmatrix_x4(va, vw_rows + kk * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int off = (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8;
        uint32_t qb[4], gb[4];
        ldmatrix_x4(qb, Qt + off);
        ldmatrix_x4(gb, Gt + off);
        mma(st[2 * np], ka, qb[0], qb[1]);
        mma(st[2 * np + 1], ka, qb[2], qb[3]);
        mma(dpt[2 * np], va, gb[0], gb[1]);
        mma(dpt[2 * np + 1], va, gb[2], gb[3]);
      }
    }
    // P^T and dS^T in place, from the statistics of each query (column)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + 2 * qd + j, t = t0 + col;
        const float4 sv = Sr[col];  // (m, 1/l, delta); zero past Tq
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int e = 2 * hr + j;
          float p = 0.f;
          if (t < Tq && key[hr] < S) {
            const bool ok = key_ok[hr] && (!causal || key[hr] <= t + shift);
            p = exp2f((ok ? st[nt][e] * sl2 : kMasked) - sv.x) * sv.y;
          }
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - sv.z);
        }
      }
    }
    // dV += P^T dO and dK += dS^T Q: queries 16 kq .. are one k16 step
#pragma unroll
    for (int kq = 0; kq < 2; ++kq) {
      const uint32_t pa[4] = {pack2(st[2 * kq][0], st[2 * kq][1]),
                              pack2(st[2 * kq][2], st[2 * kq][3]),
                              pack2(st[2 * kq + 1][0], st[2 * kq + 1][1]),
                              pack2(st[2 * kq + 1][2], st[2 * kq + 1][3])};
      const uint32_t da[4] = {pack2(dpt[2 * kq][0], dpt[2 * kq][1]),
                              pack2(dpt[2 * kq][2], dpt[2 * kq][3]),
                              pack2(dpt[2 * kq + 1][0], dpt[2 * kq + 1][1]),
                              pack2(dpt[2 * kq + 1][2], dpt[2 * kq + 1][3])};
      const int row = kq * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int dp2 = 0; dp2 < KD; ++dp2) {
        uint32_t gb[4], qb[4];
        ldmatrix_x4_trans(gb, Gt + row * LD + dp2 * 16 + (lane >> 4) * 8);
        ldmatrix_x4_trans(qb, Qt + row * LD + dp2 * 16 + (lane >> 4) * 8);
        mma(dva[2 * dp2], pa, gb[0], gb[1]);
        mma(dva[2 * dp2 + 1], pa, gb[2], gb[3]);
        mma(dka[2 * dp2], da, qb[0], qb[1]);
        mma(dka[2 * dp2 + 1], da, qb[2], qb[3]);
      }
    }
  }

  // sum the teams' partial dK/dV in a fixed order (team 0 + 1 + ...), in
  // shared memory from the rings on: [team - 1][warp][dk, dv][ND * 4][32]
  if (teams > 1) {
    float* red = reinterpret_cast<float*>(ring);
    constexpr int PER = ND * 4 * 32;
    __syncthreads();  // every team done with its ring
    if (tm > 0) {
      float* dst = red + ((tm - 1) * KW + kw) * 2 * PER;
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dst[(j * 4 + e) * 32 + lane] = dka[j][e];
          dst[PER + (j * 4 + e) * 32 + lane] = dva[j][e];
        }
    }
    __syncthreads();
    if (tm > 0) return;
    for (int t2 = 1; t2 < teams; ++t2) {
      const float* src = red + ((t2 - 1) * KW + kw) * 2 * PER;
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dka[j][e] += src[(j * 4 + e) * 32 + lane];
          dva[j][e] += src[PER + (j * 4 + e) * 32 + lane];
        }
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (key[hr] < S) {
      const size_t off = kbase + (size_t)key[hr] * kstride + 2 * qd;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + j * 8) =
            pack2(dka[j][2 * hr] * scale, dka[j][2 * hr + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + j * 8) =
            pack2(dva[j][2 * hr], dva[j][2 * hr + 1]);
      }
    }
  }
}

template <int D, int WA>
constexpr size_t smem_a() {
  return sizeof(bf16) * (2 * 16 * WA + 4 * kKeyTile<D>) * (D + kPad);
}

// K/V rows, then the teams' rings and statistics, or, at the end, the
// partial sums of all teams but the first, whichever is larger
template <int D, int KW>
constexpr size_t smem_b(int teams) {
  const size_t rings = sizeof(bf16) * teams * 4 * kBQB * (D + kPad) +
                       sizeof(float4) * teams * 2 * kBQB;
  const size_t sums = sizeof(float) * (teams - 1) * KW * 2 * (D / 8) * 4 * 32;
  return sizeof(bf16) * 2 * 16 * KW * (D + kPad) + (rings > sums ? rings : sums);
}

template <int D, int WA, int KW>
int launch_tiles(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                 const bf16* dout, const uint8_t* valid, bf16* dq, bf16* dk, bf16* dv,
                 float4* stats, int B, int Tq, int S, int Hq, int Hkv, int causal,
                 cudaStream_t st) {
  constexpr int max_teams = kThreadsB / (32 * KW);
  static const int attr = [] {  // once per instantiation, for the most teams
    const int e = set_smem(dq_kernel<D, WA>, smem_a<D, WA>());
    return e != 0 ? e : set_smem(dkv_kernel<D, KW>, smem_b<D, KW>(max_teams));
  }();
  if (attr != 0) return attr;
  const float scale = 1.0f / sqrtf((float)D);
  dq_kernel<D, WA><<<dim3((Tq + 16 * WA - 1) / (16 * WA), Hq, B), 32 * WA,
                     smem_a<D, WA>(), st>>>(q, k, v, o, dout, valid, dq, stats, Tq, S,
                                            Hq, Hkv, causal, scale);
  const int e = (int)cudaGetLastError();
  if (e != 0) return e;
  // teams: as many as a kv head has items, up to the block's limit; one
  // when the grid alone fills the card several times over
  const int blocks = (S + 16 * KW - 1) / (16 * KW) * Hkv * B;
  const int items = Hq / Hkv * ((Tq + kBQB - 1) / kBQB);
  static const int sms = [] {
    int dev = 0, n = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const int teams = blocks >= 4 * sms ? 1 : items < max_teams ? items : max_teams;
  dkv_kernel<D, KW><<<dim3((S + 16 * KW - 1) / (16 * KW), Hkv, B), 32 * KW * teams,
                      smem_b<D, KW>(teams), st>>>(q, k, v, dout, valid, stats, dk, dv,
                                                  Tq, S, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const uint8_t* valid, void* dq, void* dk, void* dv, float4* stats, int B,
           int Tq, int S, int Hq, int Hkv, int causal, cudaStream_t st) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* ot = static_cast<const bf16*>(o);
  const bf16* gt = static_cast<const bf16*>(dout);
  bf16* dqt = static_cast<bf16*>(dq);
  bf16* dkt = static_cast<bf16*>(dk);
  bf16* dvt = static_cast<bf16*>(dv);
  // long sequences: 128-row query blocks and 64-key blocks, so that each
  // block streams the other operand through its ring half as often
  const int wa = Tq >= 256 ? 8 : 4, kw = S >= 256 ? 4 : 2;
  if (wa == 8 && kw == 4)
    return launch_tiles<D, 8, 4>(qt, kt, vt, ot, gt, valid, dqt, dkt, dvt, stats, B, Tq, S,
                                 Hq, Hkv, causal, st);
  if (wa == 8)
    return launch_tiles<D, 8, 2>(qt, kt, vt, ot, gt, valid, dqt, dkt, dvt, stats, B, Tq, S,
                                 Hq, Hkv, causal, st);
  if (kw == 4)
    return launch_tiles<D, 4, 4>(qt, kt, vt, ot, gt, valid, dqt, dkt, dvt, stats, B, Tq, S,
                                 Hq, Hkv, causal, st);
  return launch_tiles<D, 4, 2>(qt, kt, vt, ot, gt, valid, dqt, dkt, dvt, stats, B, Tq, S, Hq,
                               Hkv, causal, st);
}

}  // namespace tc

template <int D>
int launch_d(int is_bf16, const void* q, const void* k, const void* v, const void* o,
             const void* dout, const uint8_t* valid, void* dq, void* dk, void* dv,
             float4* stats, int B, int Tq, int S, int Hq, int Hkv, int causal,
             cudaStream_t st) {
  if (is_bf16)
    return tc::launch<D>(q, k, v, o, dout, valid, dq, dk, dv, stats, B, Tq, S, Hq, Hkv,
                         causal, st);
  return simt::launch<D>(q, k, v, o, dout, valid, dq, dk, dv, stats, B, Tq, S, Hq, Hkv,
                         causal, st);
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

extern "C" int attention_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* key_valid, void* dq, void* dk,
                             void* dv, void* stats, int is_bf16, int B, int Tq, int S,
                             int Hq, int Hkv, int D, int causal, void* stream) {
  if (B < 1 || Tq < 1 || S < 1 || Tq > 512 || S > 512 || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const uint8_t* valid = static_cast<const uint8_t*>(key_valid);
  float4* st4 = static_cast<float4*>(stats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_d<32>(is_bf16, q, k, v, o, dout, valid, dq, dk, dv, st4, B, Tq, S, Hq, Hkv, causal, st);
    case 48: return launch_d<48>(is_bf16, q, k, v, o, dout, valid, dq, dk, dv, st4, B, Tq, S, Hq, Hkv, causal, st);
    case 64: return launch_d<64>(is_bf16, q, k, v, o, dout, valid, dq, dk, dv, st4, B, Tq, S, Hq, Hkv, causal, st);
    case 96: return launch_d<96>(is_bf16, q, k, v, o, dout, valid, dq, dk, dv, st4, B, Tq, S, Hq, Hkv, causal, st);
    case 128: return launch_d<128>(is_bf16, q, k, v, o, dout, valid, dq, dk, dv, st4, B, Tq, S, Hq, Hkv, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
