// Device helpers shared by the hand-written kernels: scalar conversions,
// the shared-memory attribute (per device) and the bf16 tensor-core building blocks
// (ldmatrix, ldmatrix.trans, mma.sync m16n8k16 with fp32 accumulators, bf16
// pair packing). The HiFi-GAN kernels' own tiling sits in
// vocoder_common.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A kernel's dynamic shared-memory limit on the current device, raised to
// `smem` where it is lower: the attribute belongs to each device (a kernel
// first launched on one card needs it set again on another), and it only
// grows, so a launch that found it high enough never sees it lowered.
template <typename K>
int set_smem(K kern, size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> limit;
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return (int)got;
  const auto key = std::make_pair(reinterpret_cast<const void*>(kern), dev);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = limit.find(key);
  if (it != limit.end() && it->second >= smem) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) limit[key] = smem;
  return (int)e;
}

namespace tc {

using bf16 = __nv_bfloat16;

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

// c += a @ b: a the m16 x k16 A fragment, (b0, b1) the k16 x n8 B fragment
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

}  // namespace tc

}  // namespace
