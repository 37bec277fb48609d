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
// the FlashAttention-2 way, without atomics: every output element is
// written by one block, or summed from fp32 partials in a fixed order, so
// two launches on the same inputs give the same bits.
//
// What bounds it on this card. At the Qwen2 training slice (q/o/dO [16, 97,
// 12, 128], k/v [16, 97, 2, 128], bf16, causal) the five products of the
// attended pairs are 0.88 GFLOP and the inputs and outputs 22.3 MB: bytes
// bound it (6.6 us). At the DiT self-attention of a distillation student
// ([32, 384, 16, 64]) they are 27.8 GFLOP (28 us) and 201 MB (60 us),
// bytes again. What sets the time is neither: it is each
// block's serial chain (copy, product, softmax, product) and how many of
// them an SM holds, so the design shortens the chains, skips the work the
// mask zeroes and keeps enough blocks in flight. The bf16 path (namespace
// tc) runs three launches:
//
//   stats_kernel, one block per (64 query rows, head, batch): S = Q K^T
//     over the key tiles the rows see, the rows' softmax max m and sum l,
//     and delta from the rows of dO and O; writes (m, 1/l, delta, m + log2
//     l) a row. m and 1/l are kept apart (not only as a log-sum-exp): with
//     every key masked, m = -1e30 and -1e30 + log2(l) rounds back to
//     -1e30, losing the 1/S; a tile whose keys a row sees takes the one
//     exponent 2^(score - m - log2 l).
//   grads_kernel, dQ and dK/dV blocks in one launch: a dq block per (64
//     query rows, head, batch) takes per key tile S = Q K^T and dP = dO
//     V^T, dS = P (dP - delta) from the stored statistics, dQ += dS K; a
//     dkv block per (64 keys, kv head, batch, split) takes per (query head,
//     query tile) item of its split S^T = K Q^T and dP^T = V dO^T, P^T and
//     dS^T from the items' statistics, dV += P^T dO and dK += dS^T Q. One
//     split writes dK, dV in bf16; several write fp32 partials. dK/dV
//     blocks come first in the grid, and the dQ blocks fill their last
//     wave.
//   dkv_reduce_kernel (splits > 1): dK, dV = the partials added in split
//     order.
//
// Design, each block one warpgroup (4 warps) that computes and one
// producer warp that copies:
//   * every product is a warpgroup product (wgmma, fp32 accumulators): S,
//     dP, S^T and dP^T with both operands read from shared memory
//     (K-major); dQ += dS K, dV += P^T dO and dK += dS^T Q with dS, P^T and
//     dS^T from registers (the fp32 accumulator rounded to bf16 in place:
//     the accumulator and A-fragment layouts agree) and K, dO and Q read
//     MN-major. P and dS are rounded to bf16 only as those products'
//     operands; every sum stays fp32. A dkv block takes an item's 64
//     queries in two parts of 32 below d = 128 (S^T and dP^T then hold 16
//     registers each), so that 3 blocks share an SM up to d = 64;
//   * tiles of 64 rows come by TMA (cp.async.bulk.tensor) in the swizzle
//     of their row width (Slab, attention_tiles.cuh; d = 48 and 96 take
//     three slabs), zero past the sequence: the producer issues the block's
//     fixed tiles (Q and dO, or K and V) once and streams the others (K/V
//     tiles, or Q/dO tiles and their 1 KB of row statistics by a bulk copy)
//     through a ring of mbarrier-completed stages. The tensor maps are
//     encoded once a shape and get each launch's addresses;
//   * work the mask zeroes is skipped: key tiles with no valid key (their P
//     is exactly 0) and, causal, key tiles past a query tile's last
//     diagonal key and query tiles before a key tile's first diagonal
//     query; unless a query row sees no valid key (its P is uniform over
//     every key): per query tile in the statistics and dQ blocks, per batch
//     row in the dkv blocks. A tile of valid keys that every row sees takes
//     no per-score mask;
//   * the grid order lets blocks that stream the same tiles run together
//     and read them from L2 (a head's query tiles neighbours; a kv head's
//     key tiles neighbours where not causal), and the longest causal walks
//     first;
//   * the plan fills the card: where (key tiles x kv heads x batch) leaves
//     SMs idle, `splits` blocks share a key tile's items, the (query head,
//     query tile) pairs it sees in head-major order, each a contiguous
//     share; a split writes fp32 partials [splits][dK, dV][B, S, Hkv, d]
//     (4 bytes an element and split, written once and read once, against
//     the 2 bytes of a bf16 output element), which dkv_reduce_kernel adds
//     in split order. The number of splits is
//     ops/attention_kernel.attention_bwd_plan's, from the shape and the
//     card's SM count alone; the items of a split (attention_bwd_plan_items
//     mirrors them) depend on the data only through causal skipping, and
//     never on timing.
//
// fp32 inputs (parity runs, not the training path) keep the CUDA-core code
// (namespace simt): four threads a row, tiles in shared memory, fp32
// throughout, pass A (statistics in a first sweep, dQ in a second) and
// pass B (dK, dV).
//
// Layouts as in JAX: [B, T, H, d], contiguous, rows 16-byte aligned (the
// wrapper realigns). d is a template parameter (32, 48, 64, 96, 128). The
// row statistics are float4 (m, 1/l, delta, m + log2 l) at [B, Hq, Tp], Tp the
// query length rounded up to 64 (rows past T hold zeros), so that a query
// tile's 64 rows are one bulk copy.

#include "attention_tiles.cuh"
#include "common.cuh"

#include <math.h>

#include <array>
#include <map>
#include <mutex>

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
  // the shared-memory sizes (set_smem sets each once a device)
  int attr = set_smem(dq_kernel<D>, smem_a<D>());
  if (attr == 0) attr = set_smem(dkv_kernel<D>, smem_b<D>());
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
// bf16: warpgroup products (wgmma) on tiles that TMA copies in
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kT = kTileRows;  // query rows of a statistics / dQ block, keys of a dK/dV block
constexpr int kThreads = 160;  // one consumer warpgroup and one producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kStatBytes = kT * sizeof(float4);  // a query tile's row statistics

// ring stages: the statistics blocks' K tiles, the dQ blocks' K/V tiles and
// the dK/dV blocks' Q/dO tiles; more where the tiles are small (d <= 64)
constexpr int kStatsStages = 3;
template <int D>
__host__ __device__ constexpr int stages() { return D <= 64 ? 3 : 2; }

// The dK/dV blocks' products take an item's 64 queries QH at a time: S^T
// and dP^T of 32 queries hold 16 registers each, of 64 queries 32, beside
// dK and dV's d. Halves let 3 blocks share an SM up to d = 64 and 2 at d =
// 96; at d = 128 they still spill at 2 blocks, so one block of whole items.
template <int D>
__host__ __device__ constexpr int kv_queries() { return D == 128 ? 64 : 32; }
template <int D>
__host__ __device__ constexpr int kv_blocks() { return D <= 64 ? 3 : D == 96 ? 2 : 1; }

// shared memory: [barriers: 1 KB | fixed tiles | stages x streamed tiles |
// (dK/dV blocks) stages x row statistics], the tiles 1024-byte aligned;
// 1 KB of slack aligns the base
template <int D>
constexpr size_t smem_stats() { return 2048 + (size_t)Slab<D>::kTile * (1 + kStatsStages); }
template <int D>
constexpr size_t smem_grads() {
  return 2048 + (size_t)Slab<D>::kTile * (2 + 2 * stages<D>()) +
         (size_t)kStatBytes * stages<D>();
}

// the barriers at the base: [0] the fixed tiles, then full and empty (and
// the dQ blocks' second full) per stage
struct Bars {
  uint32_t base;
  int ns;
  __device__ uint32_t fixed() const { return base; }
  __device__ uint32_t full(int s) const { return base + 8 + 8 * s; }
  __device__ uint32_t full2(int s) const { return base + 8 + 8 * (ns + s); }
  __device__ uint32_t empty(int s) const { return base + 8 + 8 * (2 * ns + s); }
  __device__ void init() const {  // by one thread
    mbar_init(fixed(), 1);
    for (int s = 0; s < ns; ++s) {
      mbar_init(full(s), 1);
      mbar_init(full2(s), 1);
      mbar_init(empty(s), 128);
    }
    mbar_init_fence();
  }
};

__device__ __forceinline__ uint32_t aligned_base(const unsigned char* smem_raw) {
  return (smem_u32(smem_raw) + 1023) & ~1023u;
}

// one [64][D] tile of a [B, L, H, D] tensor map: rows r0 .. r0 + 63 of head
// h in batch row b, completion on `bar`
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int h, int r0, int b) {
  using L = Slab<D>;
#pragma unroll
  for (int c = 0; c < L::kCount; ++c)
    tma_load_4d(dst + c * L::kBytes, map, bar, c * L::W, h, r0, b);
}

// Is some key in [0, hi] valid? (warp-wide; hi < 0: none)
__device__ __forceinline__ bool any_valid(const uint8_t* valid, int hi, int lane) {
  bool seen = false;
  for (int s0 = 0; s0 <= hi && !seen; s0 += 32)
    seen = __any_sync(0xffffffffu, s0 + lane <= hi && valid[s0 + lane] != 0);
  return seen;
}

// keys k0 .. k0 + 63 valid, as 64 bits (0 past S; warp-wide)
__device__ __forceinline__ uint64_t tile_valid(const uint8_t* valid, int k0, int S, int lane) {
  const bool lo = k0 + lane < S && valid[k0 + lane] != 0;
  const bool hi = k0 + 32 + lane < S && valid[k0 + 32 + lane] != 0;
  return (uint64_t)__ballot_sync(0xffffffffu, hi) << 32 | __ballot_sync(0xffffffffu, lo);
}

// The key tiles 64 query rows from t0 walk (warp-wide). `seen`: the first
// row (which sees the fewest keys) sees a valid key, and so does every row.
// Then a tile with no valid key adds exactly nothing (its P is 2^(-1e30 -
// m) = 0) and is skipped (`skip`), and a causal walk stops at the tile
// holding the last row's diagonal key; else a row is uniform over all S
// keys, and every tile counts.
struct KeyWalk {
  int tiles;
  bool seen;
  __device__ KeyWalk(const uint8_t* valid, int T, int S, int t0, int causal, int lane) {
    const int all = (S + kT - 1) / kT, shift = S - T, t_last = min(T, t0 + kT) - 1;
    seen = any_valid(valid, causal ? min(S - 1, t0 + shift) : S - 1, lane);
    tiles = causal && seen ? min(all, (t_last + shift) / kT + 1) : all;
  }
  __device__ bool skip(uint64_t vm) const { return seen && vm == 0; }
};

// A 64 x 64 score tile in log2 units, masked: -inf past S (no weight at
// all), -1e30 for an invalid key or one past the row's diagonal. This
// thread's element e is row hr = (e >> 1) & 1, key 8 (e >> 2) + (e & 1)
// past k0 + 2 qd: `vq` the tile's validity bits from that key on, `lim`
// the keys left before S, `diag[hr]` the keys row hr sees from there.
__device__ __forceinline__ void mask_scores(float (&sc)[32], uint64_t vq, int lim,
                                            const int (&diag)[2], int causal, float sl2) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int hr = (e >> 1) & 1, c = 8 * (e >> 2) + (e & 1);
    float val = sc[e] * sl2;
    if (c >= lim)
      val = -INFINITY;
    else if (!((vq >> c) & 1) || (causal && c > diag[hr]))
      val = kMasked;
    sc[e] = val;
  }
}

// the k16 slice kp of an accumulator tile, rounded to bf16, as the
// A fragment of a register-A product (columns 16 kp .. 16 kp + 15 are the
// reduced dimension)
template <int N>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&x)[N], int kp) {
  a[0] = pack2(x[8 * kp], x[8 * kp + 1]);
  a[1] = pack2(x[8 * kp + 2], x[8 * kp + 3]);
  a[2] = pack2(x[8 * kp + 4], x[8 * kp + 5]);
  a[3] = pack2(x[8 * kp + 6], x[8 * kp + 7]);
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

// A block of 64 query rows: its grid index -> (first row, head, batch row).
// The query tiles of a head are neighbours, then the heads of a kv head, so
// that the blocks that stream the same K/V tiles run together and read them
// from L2; the last query tile (the longest causal walk) first.
struct QueryTile {
  int t0, h, b;
  __device__ QueryTile(int T, int Hq, int bid) {
    const int tiles = (T + kT - 1) / kT;
    t0 = (tiles - 1 - bid % tiles) * kT;
    h = bid / tiles % Hq;
    b = bid / tiles / Hq;
  }
};

// The row statistics of 64 query rows: stats[(b Hq + h) Tp + t] = (m, 1/l,
// delta, m + log2 l), m the max of the masked scores in log2 units, l the
// sum of 2^(score - m); zeros past T. A tile whose keys the row sees takes
// P = 2^(score - m - log2 l), one exponent; a masked one 2^(score - m) / l,
// which keeps a fully masked row's 1/S (-1e30 + log2 l rounds to -1e30).
template <int D>
__global__ void __launch_bounds__(kThreads, 3)
stats_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const bf16* __restrict__ o, const bf16* __restrict__ dout,
             const uint8_t* __restrict__ key_valid, float4* __restrict__ stats, int T, int S,
             int Hq, int Hkv, int B, int Tp, int causal, float scale) {
  using L = Slab<D>;
  constexpr int NS = kStatsStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const Bars bar{base, NS};
  const uint32_t Qs = base + 1024;
  auto Ks = [&](int s) { return Qs + L::kTile * (1 + s); };

  const QueryTile qt(T, Hq, blockIdx.x);
  const int hk = qt.h / (Hq / Hkv), shift = S - T;
  const uint8_t* valid = key_valid + (size_t)qt.b * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) bar.init();
  __syncthreads();
  const KeyWalk walk(valid, T, S, qt.t0, causal, lane);

  if (warp == 4) {  // the producer: Q, then the key tiles the rows see
    if (lane == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      mbar_expect_tx(bar.fixed(), L::kTile);
      load_tile<D>(Qs, &tq, bar.fixed(), qt.h, qt.t0, qt.b);
    }
    for (int i = 0, j = 0; i < walk.tiles; ++i) {
      if (walk.skip(tile_valid(valid, i * kT, S, lane))) continue;
      if (lane == 0) {
        const int s = j % NS;
        mbar_wait(bar.empty(s), ((j / NS) & 1) ^ 1);
        mbar_expect_tx(bar.full(s), L::kTile);
        load_tile<D>(Ks(s), &tk, bar.full(s), hk, i * kT, qt.b);
      }
      ++j;
    }
    return;
  }

  // warp w holds rows 16 w .. 16 w + 15; this thread rows 16 w + g (+ 8)
  const int g = lane >> 2, qd = lane & 3;
  const float sl2 = scale * kLog2e;
  // delta from this thread's 16-byte chunks qd, qd + 4, .. of its rows of
  // O and dO, every load issued before the first is used
  constexpr int CH = (D / 8 + 3) / 4;
  int pos[2];
  uint4 ov[2][CH], gv[2][CH];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    pos[hr] = qt.t0 + 16 * warp + g + 8 * hr;
    const size_t off = (((size_t)qt.b * T + min(pos[hr], T - 1)) * Hq + qt.h) * D;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const bool ok = pos[hr] < T && qd + 4 * i < D / 8;
      ov[hr][i] = ok ? __ldg(reinterpret_cast<const uint4*>(o + off) + qd + 4 * i) : uint4{};
      gv[hr][i] = ok ? __ldg(reinterpret_cast<const uint4*>(dout + off) + qd + 4 * i) : uint4{};
    }
  }
  float delta[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i) acc += dot8(ov[hr][i], gv[hr][i]);
    delta[hr] = quad_sum(acc);
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(bar.fixed(), 0);
  for (int i = 0, j = 0; i < walk.tiles; ++i) {
    const int k0 = i * kT;
    const uint64_t vm = tile_valid(valid, k0, S, lane);
    if (walk.skip(vm)) continue;
    const int s = j % NS;
    mbar_wait(bar.full(s), (j / NS) & 1);
    ++j;
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64>(sc, k_major<D>(Qs, kk), k_major<D>(Ks(s), kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    mbar_arrive(bar.empty(s));  // the scores are in registers: the stage is free
    // a tile of valid keys below every row's diagonal takes no mask
    if (vm == ~0ull && (!causal || k0 + kT - 1 <= qt.t0 + shift)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] *= sl2;
    } else {
      const int at = k0 + 2 * qd, diag[2] = {pos[0] + shift - at, pos[1] + shift - at};
      mask_scores(sc, vm >> (2 * qd), S - at, diag, causal, sl2);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int jc = 0; jc < 8; ++jc)
        mx = fmaxf(mx, fmaxf(sc[4 * jc + 2 * hr], sc[4 * jc + 2 * hr + 1]));
      const float m_new = fmaxf(m[hr], quad_max(mx));
      l[hr] *= ex2(m[hr] - m_new);  // 0 on the first tile
      m[hr] = m_new;
#pragma unroll
      for (int jc = 0; jc < 8; ++jc)  // this thread's share; the quad is summed at the end
        l[hr] += ex2(sc[4 * jc + 2 * hr] - m_new) + ex2(sc[4 * jc + 2 * hr + 1] - m_new);
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float lsum = quad_sum(l[hr]);
    if (qd == 0)
      stats[((size_t)qt.b * Hq + qt.h) * Tp + pos[hr]] =
          pos[hr] < T ? make_float4(m[hr], 1.f / lsum, delta[hr], m[hr] + log2f(lsum))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The arguments of the dQ and dK/dV blocks besides the tensor maps
struct GradArgs {
  const uint8_t* key_valid;
  const float4* stats;
  bf16 *dq, *dk, *dv;
  float* part;
  int T, S, Hq, Hkv, B, Tp, splits, causal;
  float scale;
};

// dQ of 64 query rows from the stored row statistics: per key tile S = Q
// K^T, dP = dO V^T, dS = P (dP - delta), dQ += dS K. `bid` decodes as
// QueryTile.
template <int D>
__device__ __forceinline__ void dq_block(const CUtensorMap& tq, const CUtensorMap& tk,
                                         const CUtensorMap& tv, const CUtensorMap& tg,
                                         const GradArgs& a, unsigned char* smem_raw,
                                         int bid) {
  const uint8_t* __restrict__ key_valid = a.key_valid;
  const float4* __restrict__ stats = a.stats;
  bf16* __restrict__ dq = a.dq;
  const int T = a.T, S = a.S, Hq = a.Hq, Hkv = a.Hkv, Tp = a.Tp, causal = a.causal;
  const float scale = a.scale;
  using L = Slab<D>;
  constexpr int NS = stages<D>(), NO = D / 2;
  const uint32_t base = aligned_base(smem_raw);
  const Bars bar{base, NS};
  const uint32_t Qs = base + 1024, Gs = Qs + L::kTile;
  auto Ks = [&](int s) { return Qs + L::kTile * (2 + 2 * s); };
  auto Vs = [&](int s) { return Ks(s) + L::kTile; };

  const QueryTile qt(T, Hq, bid);
  const int hk = qt.h / (Hq / Hkv), shift = S - T;
  const uint8_t* valid = key_valid + (size_t)qt.b * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) bar.init();
  __syncthreads();
  const KeyWalk walk(valid, T, S, qt.t0, causal, lane);

  if (warp == 4) {  // the producer: Q and dO, then K and V tile by tile
    if (lane == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tg);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      mbar_expect_tx(bar.fixed(), 2 * L::kTile);
      load_tile<D>(Qs, &tq, bar.fixed(), qt.h, qt.t0, qt.b);
      load_tile<D>(Gs, &tg, bar.fixed(), qt.h, qt.t0, qt.b);
    }
    for (int i = 0, j = 0; i < walk.tiles; ++i) {
      if (walk.skip(tile_valid(valid, i * kT, S, lane))) continue;
      if (lane == 0) {
        const int s = j % NS;
        mbar_wait(bar.empty(s), ((j / NS) & 1) ^ 1);
        mbar_expect_tx(bar.full(s), L::kTile);
        load_tile<D>(Ks(s), &tk, bar.full(s), hk, i * kT, qt.b);
        mbar_expect_tx(bar.full2(s), L::kTile);
        load_tile<D>(Vs(s), &tv, bar.full2(s), hk, i * kT, qt.b);
      }
      ++j;
    }
    return;
  }

  const int g = lane >> 2, qd = lane & 3;
  const float sl2 = scale * kLog2e;
  int pos[2];
  float m[2], il[2], dl[2], lse[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    pos[hr] = qt.t0 + 16 * warp + g + 8 * hr;  // < Tp; zero statistics past T
    const float4 sv = __ldg(stats + ((size_t)qt.b * Hq + qt.h) * Tp + pos[hr]);
    m[hr] = sv.x;
    il[hr] = sv.y;
    dl[hr] = sv.z;
    lse[hr] = sv.w;
  }
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;

  mbar_wait(bar.fixed(), 0);
  for (int i = 0, j = 0; i < walk.tiles; ++i) {
    const int k0 = i * kT;
    const uint64_t vm = tile_valid(valid, k0, S, lane);
    if (walk.skip(vm)) continue;
    const int s = j % NS;
    const uint32_t ph = (j / NS) & 1;
    ++j;
    float sc[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
    mbar_wait(bar.full(s), ph);
    mbar_wait(bar.full2(s), ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64>(sc, k_major<D>(Qs, kk), k_major<D>(Ks(s), kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64>(dp, k_major<D>(Gs, kk), k_major<D>(Vs(s), kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();  // no product in flight across the branches below
    fence_regs(sc);
    fence_regs(dp);
    // P, unmasked where the tile's keys are valid and below every row's
    // diagonal (rows past T have zero statistics: P = 0)
    if (vm == ~0ull && (!causal || k0 + kT - 1 <= qt.t0 + shift)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = ex2(fmaf(sc[e], sl2, -lse[(e >> 1) & 1]));
    } else {
      const int at = k0 + 2 * qd, diag[2] = {pos[0] + shift - at, pos[1] + shift - at};
      mask_scores(sc, vm >> (2 * qd), S - at, diag, causal, sl2);
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = ex2(sc[e] - m[(e >> 1) & 1]) * il[(e >> 1) & 1];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] *= dp[e] - dl[(e >> 1) & 1];  // dS
    uint32_t da[4][4];
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) a_frag(da[kp], sc, kp);
    wgmma_fence();
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) wgmma_rs_tb<D>(acc, da[kp], mn_major<D>(Ks(s), kp), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(bar.empty(s));  // this thread is done with stage s
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (pos[hr] >= T) continue;
    bf16* dst = dq + (((size_t)qt.b * T + pos[hr]) * Hq + qt.h) * D + 2 * qd;
#pragma unroll
    for (int jc = 0; jc < D / 8; ++jc)
      *reinterpret_cast<uint32_t*>(dst + 8 * jc) =
          pack2(acc[4 * jc + 2 * hr] * scale, acc[4 * jc + 2 * hr + 1] * scale);
  }
}

// dK and dV of 64 keys of one kv head, or this split's share of them: the
// items (query head g of the kv head's group, query tile t) that see the
// keys, head-major from query tile t_lo, the split's contiguous range of
// them. One split writes bf16 dK (scaled) and dV; several write fp32
// partials (dK unscaled) at part[split][dK, dV]. `bid` is the block's
// index among the dK/dV blocks.
template <int D, int QH = kv_queries<D>()>
__device__ __forceinline__ void dkv_block(const CUtensorMap& tq, const CUtensorMap& tk,
                                          const CUtensorMap& tv, const CUtensorMap& tg,
                                          const GradArgs& a, unsigned char* smem_raw,
                                          int bid) {
  const uint8_t* __restrict__ key_valid = a.key_valid;
  const float4* __restrict__ stats = a.stats;
  bf16* __restrict__ dk = a.dk;
  bf16* __restrict__ dv = a.dv;
  float* __restrict__ part = a.part;
  const int T = a.T, S = a.S, Hq = a.Hq, Hkv = a.Hkv, B = a.B, Tp = a.Tp;
  const int splits = a.splits, causal = a.causal;
  const float scale = a.scale;
  using L = Slab<D>;
  constexpr int NS = stages<D>(), NO = D / 2;
  const uint32_t base = aligned_base(smem_raw);
  const Bars bar{base, NS};
  const uint32_t Ks = base + 1024, Vs = Ks + L::kTile;
  auto Qs = [&](int s) { return Ks + L::kTile * (2 + 2 * s); };
  auto Gs = [&](int s) { return Qs(s) + L::kTile; };
  auto St = [&](int s) { return Ks + L::kTile * (2 + 2 * NS) + kStatBytes * s; };

  // the grid: (key tile, split, kv head, batch row). Causal, key tile 0
  // (the longest walk) first, the light tiles last; else the key tiles
  // that stream the same Q/dO tiles neighbours, so that they read them
  // from L2.
  const int key_tiles = (S + kT - 1) / kT, units = splits * Hkv * B;
  const int kt = causal ? bid / units : bid % key_tiles;
  const int rest = causal ? bid % units : bid / key_tiles;
  const int k0 = kt * kT, split = rest % splits, hk = rest / splits % Hkv;
  const int b = rest / splits / Hkv;
  const int group = Hq / Hkv, shift = S - T, tiles = (T + kT - 1) / kT;
  const uint8_t* valid = key_valid + (size_t)b * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) bar.init();
  __syncthreads();
  // When query row 0 (which sees the fewest keys) sees a valid key, so does
  // every row: then keys with no validity get no weight (a block of them
  // has no items), and causal query tiles before t_lo do not see the
  // block's keys. Else some row is uniform over every key.
  const uint64_t vkv = tile_valid(valid, k0, S, lane);
  const bool seen = any_valid(valid, causal ? min(shift, S - 1) : S - 1, lane);
  const int t_lo = causal && seen ? max(0, k0 - shift) / kT : 0;
  const int per_head = tiles - t_lo, n_all = seen && vkv == 0 ? 0 : group * per_head;
  const int lo = (int)((long long)split * n_all / splits);
  const int n_items = (int)((long long)(split + 1) * n_all / splits) - lo;

  if (warp == 4) {  // the producer: K and V, then the items' Q, dO and statistics
    if (lane == 0 && n_items > 0) {
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      tma_prefetch(&tq);
      tma_prefetch(&tg);
      mbar_expect_tx(bar.fixed(), 2 * L::kTile);
      load_tile<D>(Ks, &tk, bar.fixed(), hk, k0, b);
      load_tile<D>(Vs, &tv, bar.fixed(), hk, k0, b);
      for (int j = 0; j < n_items; ++j) {
        const int s = j % NS, item = lo + j;
        const int h = hk * group + item / per_head, t0 = (t_lo + item % per_head) * kT;
        mbar_wait(bar.empty(s), ((j / NS) & 1) ^ 1);
        mbar_expect_tx(bar.full(s), 2 * L::kTile + kStatBytes);
        load_tile<D>(Qs(s), &tq, bar.full(s), h, t0, b);
        load_tile<D>(Gs(s), &tg, bar.full(s), h, t0, b);
        bulk_copy(St(s), stats + ((size_t)b * Hq + h) * Tp + t0, kStatBytes, bar.full(s));
      }
    }
    return;
  }

  // warp w holds keys k0 + 16 w .. + 15; this thread keys 16 w + g (+ 8)
  const int g = lane >> 2, qd = lane & 3;
  const float sl2 = scale * kLog2e;
  int key[2];
  bool key_ok[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    key[hr] = k0 + 16 * warp + g + 8 * hr;
    key_ok[hr] = key[hr] < S && valid[key[hr]] != 0;
  }
  float dka[NO], dva[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;

  if (n_items > 0) mbar_wait(bar.fixed(), 0);
  for (int j = 0; j < n_items; ++j) {
    const int s = j % NS, t0 = (t_lo + (lo + j) % per_head) * kT;
    const float4* sr = reinterpret_cast<const float4*>(smem_raw + (St(s) - smem_u32(smem_raw)));
    // unmasked where every key is valid, every query below T and every key
    // below every query's diagonal; else zero past T and S
    const bool clean = vkv == ~0ull && t0 + kT <= T && (!causal || k0 + kT - 1 <= t0 + shift);
    mbar_wait(bar.full(s), (j / NS) & 1);
    // the item's 64 queries in parts of QH (kv_queries)
#pragma unroll
    for (int half = 0; half < kT / QH; ++half) {
      const uint32_t qh = Qs(s) + QH * half * L::kRowBytes, gh = Gs(s) + QH * half * L::kRowBytes;
      float st[QH / 2], dpt[QH / 2];
#pragma unroll
      for (int e = 0; e < QH / 2; ++e) st[e] = dpt[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<QH>(st, k_major<D>(Ks, kk), k_major<D>(qh, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<QH>(dpt, k_major<D>(Vs, kk), k_major<D>(gh, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);
      // P^T and dS^T in place from each query's (column's) statistics (m,
      // 1/l, delta, m + log2 l): this thread's columns QH half + 8 jc + 2 qd
      // + c1
      const int c0 = QH * half + 2 * qd, tlim = T - t0 - c0;
      int kdiag[2];  // the first such column offset that sees key hr (causal)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) kdiag[hr] = key[hr] - shift - t0 - c0;
#pragma unroll
      for (int jc = 0; jc < QH / 8; ++jc) {
#pragma unroll
        for (int c1 = 0; c1 < 2; ++c1) {
          const int c = 8 * jc + c1;
          const float4 sv = sr[c0 + c];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int e = 4 * jc + 2 * hr + c1;
            float p;
            if (clean) {
              p = ex2(fmaf(st[e], sl2, -sv.w));
            } else {
              p = 0.f;
              if (c < tlim && key[hr] < S) {
                const bool ok = key_ok[hr] && (!causal || c >= kdiag[hr]);
                p = ex2((ok ? st[e] * sl2 : kMasked) - sv.x) * sv.y;
              }
            }
            st[e] = p;
            dpt[e] = p * (dpt[e] - sv.z);
          }
        }
      }
      constexpr int KP = QH / 16;  // k16 slices of the part's queries
      uint32_t pa[KP][4], da[KP][4];
#pragma unroll
      for (int kp = 0; kp < KP; ++kp) {
        a_frag(pa[kp], st, kp);
        a_frag(da[kp], dpt, kp);
      }
      // dV += P^T dO and dK += dS^T Q over the part's queries
      wgmma_fence();
#pragma unroll
      for (int kp = 0; kp < KP; ++kp)
        wgmma_rs_tb<D>(dva, pa[kp], mn_major<D>(Gs(s), KP * half + kp), 1);
#pragma unroll
      for (int kp = 0; kp < KP; ++kp)
        wgmma_rs_tb<D>(dka, da[kp], mn_major<D>(Qs(s), KP * half + kp), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dva);
      fence_regs(dka);
    }
    mbar_arrive(bar.empty(s));  // this thread is done with stage s
  }

  const size_t n_el = (size_t)B * S * Hkv * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (key[hr] >= S) continue;
    const size_t off = (((size_t)b * S + key[hr]) * Hkv + hk) * D + 2 * qd;
    if (splits == 1) {
#pragma unroll
      for (int jc = 0; jc < D / 8; ++jc) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * jc) =
            pack2(dka[4 * jc + 2 * hr] * scale, dka[4 * jc + 2 * hr + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * jc) =
            pack2(dva[4 * jc + 2 * hr], dva[4 * jc + 2 * hr + 1]);
      }
    } else {
      float* pk = part + 2 * (size_t)split * n_el + off;
      float* pv = pk + n_el;
#pragma unroll
      for (int jc = 0; jc < D / 8; ++jc) {
        *reinterpret_cast<float2*>(pk + 8 * jc) =
            make_float2(dka[4 * jc + 2 * hr], dka[4 * jc + 2 * hr + 1]);
        *reinterpret_cast<float2*>(pv + 8 * jc) =
            make_float2(dva[4 * jc + 2 * hr], dva[4 * jc + 2 * hr + 1]);
      }
    }
  }
}

// The dQ and dK/dV blocks as one launch, dK/dV blocks first: each kind
// fills the other's last wave (measured faster than two launches at every
// shipped row, d = 128 included, where a block of either kind then holds
// dK/dV's 236 registers).
template <int D>
__global__ void __launch_bounds__(kThreads, kv_blocks<D>())
grads_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
             const GradArgs a, int n_dkv) {
  extern __shared__ unsigned char smem_raw[];
  if (blockIdx.x < n_dkv)
    dkv_block<D>(tq, tk, tv, tg, a, smem_raw, blockIdx.x);
  else
    dq_block<D>(tq, tk, tv, tg, a, smem_raw, blockIdx.x - n_dkv);
}

// dK, dV = the splits' fp32 partials added in split order (dK scaled), four
// elements a thread
__global__ void __launch_bounds__(256)
dkv_reduce_kernel(const float4* __restrict__ part, bf16* __restrict__ dk, bf16* __restrict__ dv,
              size_t n4, int splits, float scale) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < 2 * n4; i += stride) {
    const int which = i >= n4;  // 0: dK, 1: dV
    const size_t at = i - which * n4;
    float4 acc = part[which * n4 + at];
    for (int s = 1; s < splits; ++s) {
      const float4 x = part[(2 * (size_t)s + which) * n4 + at];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const float f = which ? 1.f : scale;
    *reinterpret_cast<uint2*>((which ? dv : dk) + 4 * at) =
        make_uint2(pack2(acc.x * f, acc.y * f), pack2(acc.z * f, acc.w * f));
  }
}

struct Maps {
  CUtensorMap q, k, v, g;
};

// The q, k, v and dO tensor maps of one call, [B, L, H, D] as {D, H, L, B},
// a box 64 rows of one head: each shape's are encoded once and kept; a call
// of a kept shape copies them and writes its own addresses in.
template <int D>
bool tensor_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout,
                 int B, int T, int S, int Hq, int Hkv) {
  static std::mutex mu;
  static std::map<std::array<int, 5>, Maps> kept;  // one per d instantiation
  const std::array<int, 5> shape = {B, T, S, Hq, Hkv};
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = kept.find(shape);
    if (it != kept.end()) {
      *m = it->second;
    } else {
      const size_t row = 2 * (size_t)D;
      const cuuint32_t box[4] = {(cuuint32_t)Slab<D>::W, 1, (cuuint32_t)kT, 1};
      const cuuint64_t qd[4] = {(cuuint64_t)D, (cuuint64_t)Hq, (cuuint64_t)T, (cuuint64_t)B};
      const cuuint64_t qs[3] = {row, row * Hq, row * Hq * T};
      const cuuint64_t kd[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)S, (cuuint64_t)B};
      const cuuint64_t ks[3] = {row, row * Hkv, row * Hkv * S};
      if (!encode<D>(&m->q, q, 4, qd, qs, box) || !encode<D>(&m->g, dout, 4, qd, qs, box) ||
          !encode<D>(&m->k, k, 4, kd, ks, box) || !encode<D>(&m->v, v, 4, kd, ks, box))
        return false;
      if (kept.size() >= 4096) kept.clear();  // a bound no training run nears
      kept.emplace(shape, *m);
      return true;
    }
  }
  const ReplaceAddress fn = replacer();
  return fn && fn(&m->q, const_cast<void*>(q)) == CUDA_SUCCESS &&
         fn(&m->g, const_cast<void*>(dout)) == CUDA_SUCCESS &&
         fn(&m->k, const_cast<void*>(k)) == CUDA_SUCCESS &&
         fn(&m->v, const_cast<void*>(v)) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const uint8_t* valid, void* dq, void* dk, void* dv, float4* stats, float* part,
           int B, int T, int S, int Hq, int Hkv, int causal, int splits, cudaStream_t st) {
  if (splits < 1 || (splits > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  // the shared-memory sizes (set_smem sets each once a device)
  int attr = set_smem(stats_kernel<D>, smem_stats<D>());
  if (attr == 0) attr = set_smem(grads_kernel<D>, smem_grads<D>());
  if (attr != 0) return attr;
  Maps m;
  if (!tensor_maps<D>(&m, q, k, v, dout, B, T, S, Hq, Hkv)) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)D);
  const int tiles = (T + kT - 1) / kT, Tp = tiles * kT, key_tiles = (S + kT - 1) / kT;
  stats_kernel<D><<<tiles * Hq * B, kThreads, smem_stats<D>(), st>>>(
      m.q, m.k, static_cast<const bf16*>(o), static_cast<const bf16*>(dout), valid, stats, T,
      S, Hq, Hkv, B, Tp, causal, scale);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  const GradArgs a{valid, stats, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), part, T, S, Hq, Hkv, B, Tp, splits, causal, scale};
  const int n_dq = tiles * Hq * B, n_dkv = key_tiles * Hkv * B * splits;
  grads_kernel<D><<<n_dkv + n_dq, kThreads, smem_grads<D>(), st>>>(m.q, m.k, m.v, m.g, a,
                                                                n_dkv);
  e = (int)cudaGetLastError();
  if (e != 0 || splits == 1) return e;
  const size_t n4 = (size_t)B * S * Hkv * D / 4;
  dkv_reduce_kernel<<<(unsigned)((2 * n4 + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const float4*>(part), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      n4, splits, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <int D>
int launch_d(int is_bf16, const void* q, const void* k, const void* v, const void* o,
             const void* dout, const uint8_t* valid, void* dq, void* dk, void* dv,
             float4* stats, float* part, int B, int Tq, int S, int Hq, int Hkv, int causal,
             int splits, cudaStream_t st) {
  if (is_bf16)
    return tc::launch<D>(q, k, v, o, dout, valid, dq, dk, dv, stats, part, B, Tq, S, Hq, Hkv,
                         causal, splits, st);
  return simt::launch<D>(q, k, v, o, dout, valid, dq, dk, dv, stats, B, Tq, S, Hq, Hkv,
                         causal, st);
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// stats: float4 [B, Hq, Tp] (Tp: Tq rounded up to 64); partials: fp32
// [splits, 2, B, S, Hkv, D] where splits > 1 (bf16 only; the plan's,
// ops/attention_kernel.attention_bwd_plan), else unused.
extern "C" int attention_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* key_valid, void* dq, void* dk,
                             void* dv, void* stats, void* partials, int is_bf16, int B,
                             int Tq, int S, int Hq, int Hkv, int D, int causal, int splits,
                             void* stream) {
  if (B < 1 || Tq < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const uint8_t* valid = static_cast<const uint8_t*>(key_valid);
  float4* st4 = static_cast<float4*>(stats);
  float* part = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define BWD_D(d)                                                                          \
  case d:                                                                                 \
    return launch_d<d>(is_bf16, q, k, v, o, dout, valid, dq, dk, dv, st4, part, B, Tq, S, \
                       Hq, Hkv, causal, splits, st);
    BWD_D(32)
    BWD_D(48)
    BWD_D(64)
    BWD_D(96)
    BWD_D(128)
#undef BWD_D
    default: return (int)cudaErrorInvalidValue;
  }
}
