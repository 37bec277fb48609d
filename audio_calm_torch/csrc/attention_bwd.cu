// attention_bwd: backward of the fused attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_bwd_kernel`, the backward of JAX
// `flash_attention` (audio_calm_tpu/ops/pallas_attention.py). Given the
// forward's inputs q [B, T, Hq, d], k/v [B, S, Hkv, d], key_valid [B, S]
// (uint8), its output o and the output's gradient dO (all [B, T, Hq, d]
// like q), it computes, per (batch, head),
//   P  = softmax(mask(q k^T * s))          recomputed, fp32
//   dV = P^T dO,  dP = dO V^T,  delta = rowsum(dO * O),
//   dS = P * (dP - delta),  dQ = dS K * s,  dK = dS^T Q * s
// with s = d^-1/2, GQA (query head h reads kv head h / (Hq / Hkv); the
// query heads of one kv head sum into its dK and dV), masked scores -1e30
// (a fully masked row keeps a uniform P over all S keys, as in the
// forward), causal offset S - T, fp32 products and sums, and the outputs in
// the input dtype. The TPU kernel keeps a whole [T, S] tile in VMEM and
// recomputes the two forward products per (batch, kv head); here the work
// is split the FlashAttention-2 way, without atomics:
//
//   pass A, one block per (32 query rows, query head, batch): a first sweep
//     over the keys in tiles of 64 gives each row's softmax max m and sum l
//     (online, as the forward does); delta comes from the row's dO and O. A
//     second sweep recomputes P = exp(s - m) / l, dP and dS per key tile and
//     accumulates dQ in registers. It writes (m, 1/l, delta) per row for
//     pass B.
//   pass B, one block per (32 keys, kv head, batch): loops over the query
//     heads of the kv head and their query rows in tiles of 64, recomputes
//     P and dS from the stored row statistics, and accumulates dK and dV in
//     registers.
//
// m and 1/l are kept apart (not as a log-sum-exp): with every key masked,
// m = -1e30 and -1e30 + log(l) would round back to -1e30, losing the 1/S.
//
// What bounds it on this card: at the training shapes (T = S <= 97,
// d = 128, Hq/Hkv = 12/2, B = 16 a slice) the work is 5 * 2 * B*Hq*T*S*d
// = 2.3 GFLOP and about 22 MB a launch, so the bound is a few microseconds
// either way; this first version computes on the CUDA cores in fp32 (for
// bf16 inputs too, as JAX computes P, dO, V and dS in fp32), four threads a
// row, tiles in shared memory. Every multiply-add of its dot products reads
// both operands from shared memory (no register blocking), so shared-memory
// traffic bounds it, far above that bound. Tensor cores (mma.sync, as the
// forward uses) are the next step.
//
// Layouts as in JAX: [B, T, H, d], contiguous. d is a template parameter
// (32, 64, 96, 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTPR = 4;                  // threads per row
constexpr int kRows = kThreads / kTPR;   // rows a block owns: 32
constexpr int kTile = 64;                // streamed rows (keys in A, queries in B)
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// rows [r0, r0 + n) of one head (row stride `stride` elements) -> shared
// [n][D + 1] fp32; rows at or past `limit` are zero
template <int D, typename T>
__device__ void load_rows(float* dst, const T* __restrict__ src, size_t stride, int r0,
                          int n, int limit) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int r = e / D, dd = e % D;
    dst[r * (D + 1) + dd] = r0 + r < limit ? ld(src + (size_t)(r0 + r) * stride + dd) : 0.f;
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
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const T* __restrict__ dout,
          const uint8_t* __restrict__ key_valid, T* __restrict__ dq,
          float4* __restrict__ stats, int Tq, int S, int Hq, int Hkv, int causal,
          float scale) {
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
  const T* kb = k + ((size_t)b * S * Hkv + hk) * D;
  const T* vb = v + ((size_t)b * S * Hkv + hk) * D;

  load_rows<D>(Qs, q + qbase, qstride, q0, kRows, Tq);
  load_rows<D>(Gs, dout + qbase, qstride, q0, kRows, Tq);
  float delta = 0.f;
  if (live) {
    const size_t row0 = qbase + (size_t)qi * qstride;
#pragma unroll 8
    for (int j = 0; j < DPT; ++j) {
      const int dd = sub + kTPR * j;
      delta = fmaf(ld(dout + row0 + dd), ld(o + row0 + dd), delta);
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
    T* dst = dq + qbase + (size_t)qi * qstride;
#pragma unroll
    for (int j = 0; j < DPT; ++j) st(dst + sub + kTPR * j, acc[j] * scale);
  }
}

// pass B: dK and dV
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const uint8_t* __restrict__ key_valid,
           const float4* __restrict__ stats, T* __restrict__ dk, T* __restrict__ dv,
           int Tq, int S, int Hq, int Hkv, int causal, float scale) {
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
    T* dkr = dk + kbase + (size_t)sk * kstride;
    T* dvr = dv + kbase + (size_t)sk * kstride;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      st(dkr + sub + kTPR * j, dk_acc[j] * scale);
      st(dvr + sub + kTPR * j, dv_acc[j]);
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const uint8_t* valid, void* dq, void* dk, void* dv, float4* stats, int B,
           int Tq, int S, int Hq, int Hkv, int causal, cudaStream_t st) {
  const float scale = 1.0f / sqrtf((float)D);
  cudaError_t e = cudaFuncSetAttribute(
      dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a<D>());
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_b<D>());
  if (e != cudaSuccess) return (int)e;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  dq_kernel<T, D><<<dim3((Tq + kRows - 1) / kRows, Hq, B), kThreads, smem_a<D>(), st>>>(
      qt, kt, vt, static_cast<const T*>(o), gt, valid, static_cast<T*>(dq), stats, Tq, S,
      Hq, Hkv, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkv_kernel<T, D><<<dim3((S + kRows - 1) / kRows, Hkv, B), kThreads, smem_b<D>(), st>>>(
      qt, kt, vt, gt, valid, stats, static_cast<T*>(dk), static_cast<T*>(dv), Tq, S, Hq,
      Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int is_bf16, const void* q, const void* k, const void* v, const void* o,
             const void* dout, const uint8_t* valid, void* dq, void* dk, void* dv,
             float4* stats, int B, int Tq, int S, int Hq, int Hkv, int causal,
             cudaStream_t st) {
  if (is_bf16)
    return launch<__nv_bfloat16, D>(q, k, v, o, dout, valid, dq, dk, dv, stats, B, Tq, S,
                                    Hq, Hkv, causal, st);
  return launch<float, D>(q, k, v, o, dout, valid, dq, dk, dv, stats, B, Tq, S, Hq, Hkv,
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
    case 64: return launch_d<64>(is_bf16, q, k, v, o, dout, valid, dq, dk, dv, st4, B, Tq, S, Hq, Hkv, causal, st);
    case 96: return launch_d<96>(is_bf16, q, k, v, o, dout, valid, dq, dk, dv, st4, B, Tq, S, Hq, Hkv, causal, st);
    case 128: return launch_d<128>(is_bf16, q, k, v, o, dout, valid, dq, dk, dv, st4, B, Tq, S, Hq, Hkv, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
