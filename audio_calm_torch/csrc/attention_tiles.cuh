// Tiles of the attention kernels (attention_fwd.cu, attention_bwd.cu) on
// Hopper: [64 rows][d] bf16 tiles that TMA copies into shared memory in the
// swizzle of their row width and that wgmma reads through descriptors, the
// descriptors of a tile as a K-major or an MN-major operand, 2^x in one MUFU
// op, and the host's tensor-map encoding (cuTensorMapEncodeTiled, found
// through the runtime).
#pragma once

#include "hopper.cuh"

namespace {
namespace tc {

constexpr int kTileRows = 64;  // rows of a tile: the M of one warpgroup product

// 2^x in one MUFU op (ex2.approx.ftz: 2^-22 relative error; -inf -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A [64 rows][D] bf16 tile lies in shared memory as D / W slabs of 64 rows
// x W columns, rows of 2W bytes, in the swizzle of that row width (the
// layout TMA writes and wgmma reads): W = 64 (128-byte swizzle) where 64
// divides D, else 32 (64-byte), else 16 (32-byte). So d = 48 (three 32-byte
// slabs) and d = 96 (three 64-byte slabs) need no padding.
template <int D>
struct Slab {
  static constexpr int W = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr uint32_t kLayout = W == 64 ? 1 : W == 32 ? 2 : 3;  // descriptor
  static constexpr uint32_t kRowBytes = 2 * W;
  static constexpr uint32_t kBytes = kTileRows * kRowBytes;  // one slab
  static constexpr int kCount = D / W;
  static constexpr uint32_t kTile = kCount * kBytes;     // 64 rows x D
  static constexpr uint32_t kGroup = 8 * kRowBytes;      // 8 rows: a core group
};

// The descriptor of k16 slice kk of a K-major tile (the rows are M or N,
// d is the reduced dimension: Q as A, K as B of S = Q K^T): slice kk lies
// in slab 16 kk / W at byte 2 (16 kk % W) of each row.
template <int D>
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  using L = Slab<D>;
  const uint32_t at = tile + (16 * kk / L::W) * L::kBytes + 2 * (16 * kk % L::W);
  return gmma_desc(at, 16, L::kGroup, L::kLayout);
}

// The descriptor of rows 16 kp .. 16 kp + 15 of a tile as the MN-major B of
// a product that reduces over the tile's rows (V of O += P V: N = D across
// the slabs, LBO apart; SBO: 8 rows).
template <int D>
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kp) {
  using L = Slab<D>;
  return gmma_desc(tile + 16 * kp * L::kRowBytes, L::kBytes, L::kGroup, L::kLayout);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
typedef CUresult (*ReplaceAddress)(CUtensorMap*, void*);

// A CUDA API entry point found through the runtime (nullptr if missing)
inline void* cuda_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  return p;
}

inline EncodeTiled encoder() {
  static const EncodeTiled fn = (EncodeTiled)cuda_entry("cuTensorMapEncodeTiled");
  return fn;
}

inline ReplaceAddress replacer() {
  static const ReplaceAddress fn =
      (ReplaceAddress)cuda_entry("cuTensorMapReplaceAddress");
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first; `strides` in
// bytes for dimensions 1 ..), boxes of `box`, in the swizzle of W.
template <int D>
bool encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle swz = Slab<D>::W == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : Slab<D>::W == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc
}  // namespace
