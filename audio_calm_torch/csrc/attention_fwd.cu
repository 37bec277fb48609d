// attention_fwd: fused scaled dot-product attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `fused_attention` / `_attn_kernel` (K3,
// audio_calm_tpu/ops/pallas_attention.py:91) and `fused_attention_batched`
// / `_attn_kernel_batched` (K4, :181). Both compute one function,
//   out[b,t,h] = softmax_s(mask(q[b,t,h] . k[b,s,h/g] * d^-1/2)) @ v[b,s,h/g]
// with GQA (g = Hq / Hkv), a per-key validity mask key_valid[b,s], an
// optional causal mask with offset S - T (key s is seen by query t when
// s <= t + S - T), masked scores set to -1e30 and an fp32 softmax; the two
// TPU grids differ only in how programs are launched, so one kernel serves
// both call sites (DiT self/cross attention, Qwen2 causal GQA attention).
// A fully masked row gets a uniform average over all S keys, as with -1e30
// in the reference. No length limit: keys stream through the block.
//
// What bounds it on this card. At every served shape the bound is the
// bytes (q, k, v, out once): 0.07-0.3 us for a Qwen2 encode of one text
// (B = 1, 33-97 positions, d = 128), 0.35-2.8 us for the calm.yaml DiT
// heads (d = 48, T = 96-384, B = 2-4), 2.0 us for the causal ASR encode
// (L = 461). The kernel takes 3.6-12.6 us there (PERF.md section 6): what
// sets its time is a block's serial latency (copy, product, softmax,
// product, store), not the card's rates. So the design cuts that chain and
// the work on it: a block that waits on a load no work overlaps, a grid
// whose longest block is long (a causal tile's key walk), key tiles that a
// causal row never sees, instructions a score takes in the softmax.
//
// Design (bf16, the served path), per block one tile of 64 query rows:
// - The products are warpgroup products: one warpgroup (4 warps) owns the
//   64 rows and issues wgmma m64n64k16 for S = Q K^T (Q and K read from
//   shared memory by descriptors, both K-major) and m64nDk16 for O += P V
//   (P from registers, the fp32 score accumulator rounded to bf16 in place:
//   the accumulator and A-fragment layouts agree for 16-bit types; V read
//   MN-major, the transposed-B form). d = 48 is n48 and three k16 steps.
// - Tiles come by TMA (cp.async.bulk.tensor) into shared memory in the
//   swizzle of their row width (Slab in attention_tiles.cuh: 128-byte rows
//   where 64 divides d, else 64-byte, else 32-byte; d = 48 and 96 take three
//   slabs), zero-filled past the sequence by the copy. One producer warp
//   issues Q once and then K/V key tiles of 64 into a ring of
//   mbarrier-completed stages while the consumers compute. The C entry encodes the three tensor maps
//   once per shape and keeps them; a launch copies its shape's maps and
//   writes its tensors' addresses into them.
// - Causal tiles stop at the diagonal: a query tile walks only the key
//   tiles its last row sees (offset S - T included), and the grid launches
//   the heaviest query tiles first. The per-score mask runs only on tiles
//   that cross a diagonal or hold an invalid or missing key (their 64
//   validity bits are read a tile ahead); a clean tile folds the scale into
//   one multiply-add before ex2.approx.
// - GQA rows packed (attention_plan: the causal ASR encode), one tile
//   takes the g q heads of one kv head together, position-major (row =
//   t g + h): K/V are read once per kv head, and tiles of 64 / g positions
//   walk fewer key tiles along the diagonal. At the short text encodes it
//   measured slower (fewer blocks, the same chain) and is off.
// - Key split (attention_plan: a long key walk on a small grid): 2
//   consumer warpgroups take alternate key tiles of one query tile, each
//   through ring stages of its own (stages below), and merge (max, sum,
//   output) in shared memory, warpgroup 1 into 0, in a fixed order. No
//   atomics.
// The plan (packing, consumers) is a function of (T, S, Hq, Hkv, d,
// causal), never of B, and a block's work depends on its (tile, head,
// batch row) alone: row b of a batch equals the same row launched alone,
// bit for bit.
//
// fp32 (parity runs): a query tile of 32 rows in shared memory, four
// threads a row, each scoring 16 of the tile's 64 keys with fp32
// multiply-adds on CUDA cores; the row max and sum are combined with warp
// shuffles, and each thread accumulates d/4 output columns in registers.
//
// Layouts as in JAX: q [B, T, Hq, d], k/v [B, S, Hkv, d], out [B, T, Hq, d],
// key_valid [B, S] uint8; rows 16-byte aligned (the wrapper realigns). d is
// a template parameter (32, 48, 64, 96, 128).

#include "common.cuh"
#include "attention_tiles.cuh"

#include <math.h>

#include <array>
#include <map>
#include <mutex>

namespace {

constexpr int kThreads = 128;  // the fp32 path's block
constexpr int kBK = 64;        // keys per streamed tile
constexpr float kMasked = -1e30f;

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kBQ = 32;   // query rows per block
constexpr int kTPR = 4;   // threads per query row

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ key_valid,
                 float* __restrict__ out, int Tq, int S, int Hq, int Hkv,
                 int causal, float scale) {
  constexpr int LDQ = D + 1, LDK = D + 1, LDP = kBK + 1;
  constexpr int DPT = D / kTPR;       // output columns per thread
  constexpr int KPT = kBK / kTPR;     // scored keys per thread per tile
  extern __shared__ float sm[];
  float* Qs = sm;                     // [kBQ][LDQ]
  float* Ks = Qs + kBQ * LDQ;         // [kBK][LDK]
  float* Vs = Ks + kBK * LDK;         // [kBK][D]
  float* Ps = Vs + kBK * D;           // [kBQ][LDP]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, row = tid / kTPR, sub = tid % kTPR;
  const int qi = q0 + row;
  const int shift = S - Tq;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, dd = e % D, t = q0 + r;
    Qs[r * LDQ + dd] = t < Tq ? q[(((size_t)b * Tq + t) * Hq + h) * D + dd] : 0.f;
  }

  float o[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) o[j] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed (and Qs ready)
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, dd = e % D, s = k0 + r;
      const size_t src = (((size_t)b * S + s) * Hkv + hk) * D + dd;
      Ks[r * LDK + dd] = s < S ? k[src] : 0.f;
      Vs[r * D + dd] = s < S ? v[src] : 0.f;
    }
    __syncthreads();

    float sc[KPT];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kk = sub + kTPR * i, s = k0 + kk;
      if (s >= S) {
        sc[i] = -INFINITY;  // beyond the sequence: no weight at all
        continue;
      }
      float dot = 0.f;
#pragma unroll 16
      for (int dd = 0; dd < D; ++dd)
        dot = fmaf(Qs[row * LDQ + dd], Ks[kk * LDK + dd], dot);
      const bool ok = key_valid[(size_t)b * S + s] != 0 &&
                      (!causal || s <= qi + shift);
      sc[i] = ok ? dot * scale : kMasked;
      mx = fmaxf(mx, sc[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);  // 0 on the first tile
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = sc[i] == -INFINITY ? 0.f : expf(sc[i] - m_new);
      Ps[row * LDP + sub + kTPR * i] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's P values come from the same warp
#pragma unroll
    for (int j = 0; j < DPT; ++j) o[j] *= alpha;
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = Ps[row * LDP + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j) o[j] = fmaf(p, Vs[kk * D + sub + kTPR * j], o[j]);
    }
  }

  if (qi < Tq) {
    const float inv = 1.f / l;
    float* dst = out + (((size_t)b * Tq + qi) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) dst[sub + kTPR * j] = o[j] * inv;
  }
}

template <int D>
size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: warpgroup products (wgmma) on tiles that TMA copies in
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kRows = kTileRows;  // query rows a tile: the M of one warpgroup product
constexpr float kLog2e = 1.4426950408889634f;

// ring stages: two a consumer warpgroup, one in use and one in flight; four
// where the tiles are small (d <= 64), so the copies run further ahead.
// The count is a multiple of NC, so that key tile i's stage i % NS is only
// ever read by its warpgroup i % NC: a consumer then waits on a stage's
// barriers only after it consumed the stage's previous tile itself, never
// two phases ahead, where a parity wait cannot tell the phase it waits for
// from the one before and returns at once (were stage 0 shared, warpgroup
// 1 could read it as key tile NS before warpgroup 0's tile 0 landed)
template <int D, int NC>
__host__ __device__ constexpr int stages() { return D <= 64 ? 4 : 2 * NC; }

// shared memory: [barriers: 1 KB | Q tile | stages x (K tile, V tile)],
// the tiles 1024-byte aligned; 1 KB of slack aligns the base
template <int D, int NC>
constexpr size_t smem_bytes() {
  return 2048 + (size_t)Slab<D>::kTile * (1 + 2 * stages<D, NC>());
}

// blocks an SM is to hold: bounds the registers a thread (one warpgroup
// of 64 rows needs about 70 + d / 2 + 32 of them)
template <int D, int NC>
__host__ __device__ constexpr int min_blocks() {
  return NC == 1 ? (D <= 64 ? 3 : 2) : (D <= 48 ? 2 : 1);
}

// One block: a tile of 64 query rows of one (head or kv-head group, batch
// row), NC consumer warpgroups and one producer warp. Rows are positions
// t0 .. t0 + P - 1 of one q head (G = 1, P = 64) or, GQA rows packed, of
// the G = Hq / Hkv q heads of one kv head, position-major: row = (t - t0) G
// + h (P = 64 / G positions, P G rows). Consumer c takes key tiles c, c + NC,
// ... through the ring, each with its own running max, sum and output;
// they merge in a fixed order at the end. The grid is 1-D, decoded as
// ops/attention_kernel.plan_blocks mirrors it.
template <int D, int NC>
__global__ void __launch_bounds__(128 * NC + 32, min_blocks<D, NC>())
attention_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const uint8_t* __restrict__ key_valid,
                 bf16* __restrict__ out, int T, int S, int Hq, int gq, int G, int P,
                 int tiles, int groups, int B, int causal, float scale) {
  using L = Slab<D>;
  constexpr int NS = stages<D, NC>(), NO = D / 2;
  static_assert(NS % NC == 0, "a ring stage belongs to one consumer warpgroup");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t qbar = base;
  auto full_k = [&](int s) { return base + 8 + 8 * s; };  // K of stage s landed
  auto full_v = [&](int s) { return base + 8 + 8 * (NS + s); };  // V landed
  auto empty = [&](int s) { return base + 8 + 8 * (2 * NS + s); };  // stage free
  const uint32_t Qs = base + 1024;
  auto Ks = [&](int s) { return Qs + L::kTile * (1 + 2 * s); };
  auto Vs = [&](int s) { return Ks(s) + L::kTile; };

  // heaviest tiles first: the last query tile of every (head, batch row)
  const int bid = blockIdx.x;
  const int hg = bid % groups;
  const int b = (bid / groups) % B;
  const int tile = tiles - 1 - bid / (groups * B);
  const int hk = G > 1 ? hg : hg / gq;
  const int t0 = tile * P;
  const int t_last = min(T, t0 + P) - 1;
  const int shift = S - T;
  const uint8_t* valid = key_valid + (size_t)b * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 4 * NC && lane == 0) {  // the producer's descriptors, ahead of use
    tma_prefetch(&tq);
    tma_prefetch(&tk);
    tma_prefetch(&tv);
  }

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Key tiles the block walks. Causal: up to the tile that holds the last
  // row's diagonal key, unless a row of the tile sees no valid key (then
  // the reference averages all S keys: every tile). The first row sees the
  // fewest keys, so it decides; every warp finds the same answer.
  auto key_tiles = [&]() {
    const int kt_all = (S + kBK - 1) / kBK;
    if (!causal) return kt_all;
    const int lim = min(S, t0 + shift + 1);
    bool seen = false;
    for (int s0 = 0; s0 < lim && !seen; s0 += 32)
      seen = __any_sync(0xffffffffu, s0 + lane < lim && valid[s0 + lane] != 0);
    return seen ? min(kt_all, (t_last + shift) / kBK + 1) : kt_all;
  };
  auto load_kv = [&](int i) {  // key tile i into its stage, once it is free
    const int s = i % NS;
    mbar_wait(empty(s), ((i / NS) & 1) ^ 1);
    mbar_expect_tx(full_k(s), L::kTile);
    for (int c = 0; c < L::kCount; ++c)
      tma_load_4d(Ks(s) + c * L::kBytes, &tk, full_k(s), c * L::W, hk, i * kBK, b);
    mbar_expect_tx(full_v(s), L::kTile);
    for (int c = 0; c < L::kCount; ++c)
      tma_load_4d(Vs(s) + c * L::kBytes, &tv, full_v(s), c * L::W, hk, i * kBK, b);
  };

  if (warp == 4 * NC) {  // the producer: Q and key tile 0 at once, then the rest
    if (lane == 0) {
      mbar_expect_tx(qbar, L::kCount * L::kRowBytes * G * P);
      for (int c = 0; c < L::kCount; ++c)
        tma_load_5d(Qs + c * L::kBytes, &tq, qbar, c * L::W, 0, hg, t0, b);
      load_kv(0);  // every tile walks key tile 0
    }
    const int n_tiles = key_tiles();
    if (lane == 0)
      for (int i = 1; i < n_tiles; ++i) load_kv(i);
    return;
  }
  const int n_tiles = key_tiles();

  // a consumer: warp w of warpgroup wg holds rows 16 w .. 16 w + 15; this
  // thread rows r = 16 w + g and r + 8 (accumulator elements e >> 1)
  const int wg = warp >> 2, w = warp & 3, tid = threadIdx.x & 127;
  const int g = lane >> 2, qd = lane & 3;
  const float sl2 = scale * kLog2e;  // scores in log2 units: ex2 below
  int row[2], pos[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    row[hr] = 16 * w + g + 8 * hr;
    pos[hr] = row[hr] < G * P ? t0 + row[hr] / G : T;  // padding rows: unused
  }
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // key validity bytes of this warpgroup's next tile, read one tile ahead
  auto valid_at = [&](int k) { return k < S ? valid[k] : (uint8_t)0; };
  uint8_t v_lo = valid_at(wg * kBK + lane), v_hi = valid_at(wg * kBK + 32 + lane);
  mbar_wait(qbar, 0);
  for (int i = wg; i < n_tiles; i += NC) {
    const int s = i % NS, k0 = i * kBK;
    // the tile's key validity as 64 bits; a tile with every key valid and
    // below every row's diagonal takes no per-score mask
    const uint64_t vm = (uint64_t)__ballot_sync(0xffffffffu, v_hi != 0) << 32 |
                        __ballot_sync(0xffffffffu, v_lo != 0);
    const bool clean = vm == ~0ull && (!causal || k0 + kBK - 1 <= t0 + shift);
    v_lo = valid_at(k0 + NC * kBK + lane);
    v_hi = valid_at(k0 + NC * kBK + 32 + lane);
    mbar_wait(full_k(s), (i / NS) & 1);

    // S = Q K^T: 64 x 64 scores, d / 16 products
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

    // the tile's row max in log2 units: a clean tile keeps its raw scores
    // (the scale joins the exponent's multiply-add, k_s), a masked one
    // takes the scale and its mask constants here
    float mx[2] = {-INFINITY, -INFINITY};
    if (clean) {
#pragma unroll
      for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
      mx[0] *= sl2;
      mx[1] *= sl2;
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hr = (e >> 1) & 1, kc = 8 * (e >> 2) + 2 * qd + (e & 1);
        float val = sc[e] * sl2;
        if (k0 + kc >= S)
          val = -INFINITY;  // beyond the sequence: no weight at all
        else if (!((vm >> kc) & 1) || (causal && k0 + kc > pos[hr] + shift))
          val = kMasked;
        sc[e] = val;
        mx[hr] = fmaxf(mx[hr], val);
      }
    }
    const float k_s = clean ? sl2 : 1.f;
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      alpha[hr] = ex2(m[hr] - m_new);  // 0 on the first tile
      m[hr] = m_new;
      l[hr] *= alpha[hr];
    }
    // P rounded to bf16 as the A fragment of the k16 slice of keys 16 kp ..
    uint32_t pa[4][4];
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = 2 * kp + (e >> 2), hr = (e >> 1) & 1;
        p[e] = ex2(fmaf(sc[4 * j + (e & 3)], k_s, -m[hr]));  // 0 beyond the sequence
        l[hr] += p[e];  // this thread's share; the quad is summed at the end
      }
      pa[kp][0] = pack2(p[0], p[1]);
      pa[kp][1] = pack2(p[2], p[3]);
      pa[kp][2] = pack2(p[4], p[5]);
      pa[kp][3] = pack2(p[6], p[7]);
    }
#pragma unroll
    for (int i2 = 0; i2 < NO; ++i2) o[i2] *= alpha[(i2 >> 1) & 1];

    // O += P V
    mbar_wait(full_v(s), (i / NS) & 1);
    wgmma_fence();
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) wgmma_rs_tb<D>(o, pa[kp], mn_major<D>(Vs(s), kp), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(empty(s));  // this thread is done with stage s
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  if constexpr (NC > 1) {
    // merge: warpgroups 1 .. NC-1 leave (m, l, O) in the drained ring, each
    // thread at its own index; warpgroup 0 folds them in, in order
    float* scr = reinterpret_cast<float*>(smem + 1024 + L::kTile);
    named_barrier(1, 128 * NC);  // every consumer is done with the ring
    if (wg > 0) {
      float* mine = scr + (size_t)(wg - 1) * (NO + 4) * 128;
#pragma unroll
      for (int i = 0; i < NO; ++i) mine[i * 128 + tid] = o[i];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mine[(NO + hr) * 128 + tid] = m[hr];
        mine[(NO + 2 + hr) * 128 + tid] = l[hr];
      }
    }
    named_barrier(1, 128 * NC);
    if (wg > 0) return;
    for (int c = 1; c < NC && c < n_tiles; ++c) {
      const float* theirs = scr + (size_t)(c - 1) * (NO + 4) * 128;
      float a0[2], a1[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float mc = theirs[(NO + hr) * 128 + tid];
        const float m_new = fmaxf(m[hr], mc);
        a0[hr] = ex2(m[hr] - m_new);
        a1[hr] = ex2(mc - m_new);
        l[hr] = l[hr] * a0[hr] + theirs[(NO + 2 + hr) * 128 + tid] * a1[hr];
        m[hr] = m_new;
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const int hr = (i >> 1) & 1;
        o[i] = o[i] * a0[hr] + theirs[i * 128 + tid] * a1[hr];
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (row[hr] >= G * P || pos[hr] >= T) continue;
    const int h = G > 1 ? hg * G + row[hr] % G : hg;
    const float inv = 1.f / l[hr];
    bf16* dst = out + (((size_t)b * T + pos[hr]) * Hq + h) * D + 2 * qd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack2(o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
  }
}

struct Maps {
  CUtensorMap q, k, v;
};

// The q, k and v tensor maps of one call: each shape's are encoded once
// (cuTensorMapEncodeTiled) and kept; a call of a kept shape copies them and
// writes its own addresses in (cuTensorMapReplaceAddress).
template <int D>
bool tensor_maps(Maps* m, const void* q, const void* k, const void* v, int B, int T, int S,
                 int Hq, int Hkv, int G) {
  using L = Slab<D>;
  static std::mutex mu;
  static std::map<std::array<int, 6>, Maps> kept;  // one per d instantiation
  const std::array<int, 6> shape = {B, T, S, Hq, Hkv, G};
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = kept.find(shape);
    if (it != kept.end()) {
      *m = it->second;
    } else {
      const int P = kRows / G;
      const size_t row = 2 * (size_t)D;  // bytes of one head's vector
      // q [B, T, Hq, D] as {D, G, Hq / G, T, B}: a box is P positions of G heads
      const cuuint64_t qd[5] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)(Hq / G),
                                (cuuint64_t)T, (cuuint64_t)B};
      const cuuint64_t qs[4] = {row, row * G, row * Hq, row * Hq * T};
      const cuuint32_t qb[5] = {(cuuint32_t)L::W, (cuuint32_t)G, 1, (cuuint32_t)P, 1};
      // k, v [B, S, Hkv, D] as {D, Hkv, S, B}: a box is 64 keys of one kv head
      const cuuint64_t kd[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)S,
                                (cuuint64_t)B};
      const cuuint64_t ks[3] = {row, row * Hkv, row * Hkv * S};
      const cuuint32_t kb[4] = {(cuuint32_t)L::W, 1, (cuuint32_t)kBK, 1};
      if (!encode<D>(&m->q, q, 5, qd, qs, qb) || !encode<D>(&m->k, k, 4, kd, ks, kb) ||
          !encode<D>(&m->v, v, 4, kd, ks, kb))
        return false;
      if (kept.size() >= 4096) kept.clear();  // a bound no served session nears
      kept.emplace(shape, *m);
      return true;
    }
  }
  const ReplaceAddress fn = replacer();
  return fn && fn(&m->q, const_cast<void*>(q)) == CUDA_SUCCESS &&
         fn(&m->k, const_cast<void*>(k)) == CUDA_SUCCESS &&
         fn(&m->v, const_cast<void*>(v)) == CUDA_SUCCESS;
}

template <int D, int NC>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid, void* out,
           int B, int T, int S, int Hq, int Hkv, int pack, int causal, cudaStream_t st) {
  const int gq = Hq / Hkv, G = pack ? gq : 1, P = kRows / G;
  if (P < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (T + P - 1) / P, groups = Hq / G;
  Maps m;
  if (!tensor_maps<D>(&m, q, k, v, B, T, S, Hq, Hkv, G)) return (int)cudaErrorInvalidValue;
  auto kern = attention_kernel<D, NC>;
  const int attr = set_smem(kern, smem_bytes<D, NC>());
  if (attr != 0) return attr;
  kern<<<tiles * groups * B, 128 * NC + 32, smem_bytes<D, NC>(), st>>>(
      m.q, m.k, m.v, valid, static_cast<bf16*>(out), T, S, Hq, gq, G, P, tiles, groups, B,
      causal, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_nc(int consumers, const void* q, const void* k, const void* v,
              const uint8_t* valid, void* out, int B, int T, int S, int Hq, int Hkv,
              int pack, int causal, cudaStream_t st) {
  if (consumers == 1)
    return launch<D, 1>(q, k, v, valid, out, B, T, S, Hq, Hkv, pack, causal, st);
  if (consumers == 2)
    return launch<D, 2>(q, k, v, valid, out, B, T, S, Hq, Hkv, pack, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

template <int D>
int launch_simt(const void* q, const void* k, const void* v, const uint8_t* valid, void* out,
                int B, int T, int S, int Hq, int Hkv, int causal, cudaStream_t stream) {
  auto kern = simt::attention_kernel<D>;
  const int attr = set_smem(kern, simt::smem_bytes<D>());
  if (attr != 0) return attr;
  const dim3 grid((T + simt::kBQ - 1) / simt::kBQ, Hq, B);
  kern<<<grid, kThreads, simt::smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), valid, static_cast<float*>(out), T, S, Hq, Hkv, causal,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int is_bf16, int pack, int consumers, const void* q, const void* k,
             const void* v, const uint8_t* valid, void* out, int B, int T, int S, int Hq,
             int Hkv, int causal, cudaStream_t st) {
  if (is_bf16)
    return tc::launch_nc<D>(consumers, q, k, v, valid, out, B, T, S, Hq, Hkv, pack, causal,
                            st);
  return launch_simt<D>(q, k, v, valid, out, B, T, S, Hq, Hkv, causal, st);
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// pack: GQA rows packed (the G q heads of a kv head in one tile); consumers:
// warpgroups sharing a tile's keys (1 or 2). Both from the wrapper's
// attention_plan; the fp32 path takes neither.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             const void* key_valid, void* out, int is_bf16, int B, int T,
                             int S, int Hq, int Hkv, int D, int causal, int pack,
                             int consumers, void* stream) {
  if (B < 1 || T < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const uint8_t* valid = static_cast<const uint8_t*>(key_valid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define ATTN_D(d)                                                                        \
  case d:                                                                                \
    return launch_d<d>(is_bf16, pack, consumers, q, k, v, valid, out, B, T, S, Hq, Hkv, \
                       causal, st);
    ATTN_D(32)
    ATTN_D(48)
    ATTN_D(64)
    ATTN_D(96)
    ATTN_D(128)
#undef ATTN_D
    default: return (int)cudaErrorInvalidValue;
  }
}
