// attention_fwd: fused scaled dot-product attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `fused_attention` / `_attn_kernel` and
// `fused_attention_batched` / `_attn_kernel_batched`
// (audio_calm_tpu/ops/pallas_attention.py). Both compute the same function,
//   out[b,t,h] = softmax_s(mask(q[b,t,h] . k[b,s,h/g] * d^-1/2)) @ v[b,s,h/g]
// with GQA (g = Hq / Hkv), a per-key validity mask key_valid[b,s], an
// optional causal mask with offset S - T (key s is seen by query t when
// s <= t + S - T), masked scores set to -1e30 and an fp32 softmax; the two
// TPU grids differ only in how programs are launched, so one kernel serves
// both call sites (DiT self/cross attention, Qwen2 causal GQA attention).
// A fully masked row gets a uniform average over all S keys, as with -1e30
// in the reference.
//
// What bounds it on this card: at the main path's shapes (T, S <= 512,
// d = 64 or 128) the work is small, 4*T*S*d FLOP per (batch, head), and
// each launch moves under a few MB; the kernel is latency- and
// launch-bound, not bandwidth- or FLOP-bound. What it must avoid is the
// reference's [B, H, T, S] score and mask tensors in device memory.
//
// Design. One block of 128 threads per (query tile, head, batch); keys and
// values stream through shared memory in tiles of 64 under an online
// softmax (running max and sum per row, fp32). No mask tensor is built:
// validity and causality are tested per score from key_valid and the
// indices. Two paths, by dtype:
//
// bf16 (the serving path): tensor cores, mma.sync m16n8k16 with fp32
// accumulators, as FlashAttention-2 does it. A query tile of 64 rows, 16
// per warp; the warp keeps its Q fragments in registers, computes its
// 16 x 64 scores with K read by ldmatrix, masks and exponentiates them in
// registers, and feeds the probabilities straight back as the A operand of
// P @ V (V read by ldmatrix.trans). P is rounded to bf16 for that product,
// as the TPU kernel casts probs to v's dtype. Rows are padded by 8
// elements in shared memory so that ldmatrix hits distinct banks.
//
// fp32 (parity runs): a query tile of 32 rows in shared memory, four
// threads a row, each scoring 16 of the tile's 64 keys with fp32
// multiply-adds on CUDA cores; the row max and sum are combined with warp
// shuffles, and each thread accumulates d/4 output columns in registers.
//
// Layouts as in JAX: q [B, T, Hq, d], k/v [B, S, Hkv, d], out [B, T, Hq, d],
// key_valid [B, S] uint8. d is a template parameter (32, 64, 96, 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 64;   // keys per streamed tile
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
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulators)
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kPad = 8;           // row padding of the shared tiles, in elements

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) = low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// 64 rows [r0, r0 + 64) of one head (row stride `stride` elements) ->
// shared [64][D + kPad]; rows at or past `limit` are zero.
template <int D>
__device__ void load_rows(bf16* dst, const bf16* __restrict__ src, size_t stride,
                          int r0, int limit) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < 64 * CH; e += kThreads) {
    const int r = e / CH, ch = e % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * stride) + ch);
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + ch * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const uint8_t* __restrict__ key_valid,
                 bf16* __restrict__ out, int Tq, int S, int Hq, int Hkv,
                 int causal, float scale) {
  constexpr int LD = D + kPad, KD = D / 16, ND = D / 8, NS = kBK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [kBQ][LD]
  bf16* Ks = Qs + kBQ * LD;                   // [kBK][LD]
  bf16* Vs = Ks + kBK * LD;                   // [kBK][LD]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int shift = S - Tq;
  const bf16* kb = k + ((size_t)b * S * Hkv + hk) * D;
  const bf16* vb = v + ((size_t)b * S * Hkv + hk) * D;
  const uint8_t* valid = key_valid + (size_t)b * S;
  // this thread's two query rows: g and g + 8 of the warp's 16
  const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_rows<D>(Qs, q + ((size_t)b * Tq * Hq + h) * D, (size_t)Hq * D, q0, Tq);
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    load_rows<D>(Ks, kb, (size_t)Hkv * D, k0, S);
    load_rows<D>(Vs, vb, (size_t)Hkv * D, k0, S);
    __syncthreads();

    // scores: s[nt] is the m16 x n8 tile of keys k0 + 8 nt ..
    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma(s[2 * np], qf[kk], kf[0], kf[1]);
        mma(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // mask, online softmax (rows g: elements 0,1; g + 8: elements 2,3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * qd + (e & 1), hr = e >> 1;
        float val = -INFINITY;  // beyond the sequence: no weight at all
        if (key < S) {
          const bool ok = valid[key] != 0 && (!causal || key <= qrow[hr] + shift);
          val = ok ? s[nt][e] * scale : kMasked;
        }
        s[nt][e] = val;
        mx[hr] = fmaxf(mx[hr], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      alpha[hr] = expf(m[hr] - m_new);  // 0 on the first tile
      m[hr] = m_new;
      l[hr] *= alpha[hr];
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const float p = s[nt][e] == -INFINITY ? 0.f : expf(s[nt][e] - m[hr]);
        s[nt][e] = p;
        l[hr] += p;  // this thread's share; the quad is summed at the end
      }
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
      o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
    }

    // o += P @ V: the score tiles of keys 16 kp .. 16 kp + 15 are the A
    // operand of one k16 step
#pragma unroll
    for (int kp = 0; kp < NS / 2; ++kp) {
      const uint32_t pa[4] = {pack2(s[2 * kp][0], s[2 * kp][1]),
                              pack2(s[2 * kp][2], s[2 * kp][3]),
                              pack2(s[2 * kp + 1][0], s[2 * kp + 1][1]),
                              pack2(s[2 * kp + 1][2], s[2 * kp + 1][3])};
#pragma unroll
      for (int dp = 0; dp < KD; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vs + (kp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        mma(o[2 * dp], pa, vf[0], vf[1]);
        mma(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    if (qrow[hr] < Tq) {
      const float inv = 1.f / l[hr];
      bf16* dst = out + (((size_t)b * Tq + qrow[hr]) * Hq + h) * D + 2 * qd;
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<uint32_t*>(dst + j * 8) =
            pack2(o[j][2 * hr] * inv, o[j][2 * hr + 1] * inv);
    }
  }
}

template <int D>
size_t smem_bytes() {
  return sizeof(bf16) * (kBQ + 2 * kBK) * (D + kPad);
}

}  // namespace tc

template <typename T, int D, typename K>
int launch(K kern, size_t smem, int bq, const void* q, const void* k, const void* v,
           const uint8_t* valid, void* out, int B, int Tq, int S, int Hq, int Hkv,
           int causal, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Tq + bq - 1) / bq, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      valid, static_cast<T*>(out), Tq, S, Hq, Hkv, causal, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int is_bf16, const void* q, const void* k, const void* v,
             const uint8_t* valid, void* out, int B, int Tq, int S, int Hq, int Hkv,
             int causal, cudaStream_t st) {
  if (is_bf16)
    return launch<__nv_bfloat16, D>(tc::attention_kernel<D>, tc::smem_bytes<D>(), tc::kBQ,
                                    q, k, v, valid, out, B, Tq, S, Hq, Hkv, causal, st);
  return launch<float, D>(simt::attention_kernel<D>, simt::smem_bytes<D>(), simt::kBQ,
                          q, k, v, valid, out, B, Tq, S, Hq, Hkv, causal, st);
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             const void* key_valid, void* out, int is_bf16,
                             int B, int Tq, int S, int Hq, int Hkv, int D,
                             int causal, void* stream) {
  if (B < 1 || Tq < 1 || S < 1 || Tq > 512 || S > 512 || Hkv < 1 ||
      Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const uint8_t* valid = static_cast<const uint8_t*>(key_valid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_d<32>(is_bf16, q, k, v, valid, out, B, Tq, S, Hq, Hkv, causal, st);
    case 64: return launch_d<64>(is_bf16, q, k, v, valid, out, B, Tq, S, Hq, Hkv, causal, st);
    case 96: return launch_d<96>(is_bf16, q, k, v, valid, out, B, Tq, S, Hq, Hkv, causal, st);
    case 128: return launch_d<128>(is_bf16, q, k, v, valid, out, B, Tq, S, Hq, Hkv, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
