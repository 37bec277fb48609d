// gemm: a batch-invariant bf16 matrix product for Hopper (sm_90a),
//   y [M, N] = x [M, K] w^T (+ bias)   with w [N, K]  (w_nk = 1, a Linear)
//   y [M, N] = x [M, K] w   (+ bias)   with w [K, N]  (w_nk = 0, LoRA's A, B)
// bf16 inputs, fp32 accumulation, the bias added in fp32, one rounding to
// bf16 at the end.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA.
// It exists because the served product needs a row of a batch to equal the
// same request served alone. cuBLAS picks its kernel (tile, split-K,
// reduction order) by the row count M, so a batched row summed its
// products in another order than the same row served alone, and the served
// audio and ASR ids depended on what a request was batched with. Here
// nothing that orders a row's sums depends on M: the tile's width BN and K
// cut into chunks of fixed boundaries come from (N, K) alone
// (ops/gemm_kernel.gemm_plan), each chunk is summed from zero, and the
// chunks are added in chunk order. Each output element is written by one
// thread, with no atomics, so two launches give the same bits and a row
// gives the same bits at any M and any position.
//
// What bounds it on this card (an H100: 132 SMs, 3.35 TB/s, 989 TFLOP/s
// bf16). At the served engine's shapes (tools/gemm_probe.ROWS) two kinds:
// - The Qwen2 projections of a B = 1 encode (M = 50-100) or of the /tts
//   pair (M = 194) read 0.2-27.5 MB of w for 0.1-0.6 MB of x: bytes bound
//   them (0.24-9.4 us). What sets their time is the loads a block keeps in
//   flight and the SMs that run blocks: a ring of 96 KB a block (two
//   blocks an SM) and, where the tiles alone leave SMs idle, the K chunks
//   spread over blocks of their own, whose fp32 partial sums cost a write,
//   a read and a second launch. Past that, the SMs' reads through L2: each
//   column tile reads x again and each row tile w (gate/up at M = 194:
//   about 110 MB through L2 for 27.5 MB from memory).
// - The DiT under CFG (M = 768) and the ASR encode's down_proj (M = 922)
//   are bound by operations (3.7-26 us): only warpgroup products come near
//   the rate, and a grid of whole tiles fills 132 SMs unevenly, so the
//   rounds of tiles an SM runs set the time; the warpgroups a tile (1 to
//   3, 64 rows each) are chosen for the fewest rounds. Each K chunk ends in
//   a drain of the products in flight, a cost of the batch invariance.
// PERF.md section 6 has the times against these bounds and cuBLAS.
//
// Design:
// - One producer warp keeps TMA 2-D tile copies (cp.async.bulk.tensor) of
//   x and w in flight, 64 columns of K a tile (128-byte rows in the
//   128-byte swizzle: the layout wgmma reads), into a ring of 4-8 stages
//   with full/empty mbarriers; rows past M, columns past N and K past K
//   are zero-filled by the copy.
// - NC consumer warpgroups (1 to 3) each own 64 rows of the block's tile
//   and issue wgmma m64nBNk16 from shared memory into fp32 registers: x
//   K-major, w K-major for [N, K] and MN-major for [K, N]; BN = 64 up to
//   N = 768 (LoRA's A, the k/v projections, calm.yaml's DiT), else 128. A
//   tile's products stay in flight while the next tile's are issued; a
//   stage is released once its products are done.
// - K chunks (the arithmetic) are whole tiles, chunk_steps k16 steps each,
//   from (N, K): the block either runs its tile's chunks one after
//   another, adding each chunk's sum to a running total in chunk order, or
//   (spread, where the tiles alone leave SMs idle) runs one chunk and
//   writes its fp32 sum to a scratch buffer [splits, M, N] that a second
//   kernel, gemm_reduce, adds in chunk order. Both do the same fp32
//   operations, so the choice, which follows M, changes no bit; nor does
//   the number of consumer warpgroups (a row's products are its
//   warpgroup's alone).
// - The epilogue adds the bias in fp32, rounds once, and stages the bf16
//   tile in shared memory for 16-byte stores.
//
// The C entry encodes the tensor maps once per shape and keeps them; a
// launch copies its shape's maps and writes its tensors' addresses in.

#include "common.cuh"
#include "hopper.cuh"

#include <array>
#include <map>
#include <mutex>

namespace {

using tc::bf16;

constexpr int BK = 64;                // K columns a tile: 128-byte rows
constexpr int KSTEP = 16;             // K of one wgmma
constexpr uint32_t kRowBytes = 2 * BK;
constexpr uint32_t kGroup = 8 * kRowBytes;  // 8 rows: a core group
constexpr uint32_t kSlab = 64 * kRowBytes;  // 64 rows of a tile

template <int BN, int NC>
struct Cfg {
  static constexpr int kThreads = 128 * NC + 32;
  static constexpr uint32_t kA = NC * kSlab;          // x: 64 NC rows
  static constexpr uint32_t kB = BN * kRowBytes;      // w: BN x 64 or 64 x BN
  static constexpr uint32_t kStage = kA + kB;
  static constexpr int kRing = (NC == 1 ? 98304 : 196608) / kStage;
  static constexpr int kStages = kRing > 8 ? 8 : kRing;
  static constexpr uint32_t kPitch = 2 * BN + 16;     // epilogue row, bytes
  static constexpr size_t kSmem = 2048 + (size_t)kStages * kStage;
  static_assert(NC * 64 * kPitch <= kStages * kStage, "epilogue fits the ring");
};

// The descriptor of k16 step kk of a K-major tile (x, or w [N, K]): step
// kk lies at byte 32 kk of each 128-byte row.
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  return gmma_desc(tile + 32 * kk, 16, kGroup, 1);
}

// The descriptor of k16 step kk of an MN-major w [K, N] tile: BN / 64
// slabs of 64 K rows x 64 N columns, kSlab apart (LBO); SBO: 8 K rows.
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kk) {
  return gmma_desc(tile + 16 * kk * kRowBytes, kSlab, kGroup, 1);
}

template <int BN, bool kKN>
__device__ __forceinline__ void product(float (&acc)[BN / 2], uint32_t a, uint32_t b,
                                        int kk, int scale_d) {
  if constexpr (kKN)
    wgmma_ss_tb<BN>(acc, k_major(a, kk), mn_major(b, kk), scale_d);
  else
    wgmma_ss<BN>(acc, k_major(a, kk), k_major(b, kk), scale_d);
}

// One block: rows m0 .. m0 + 64 NC - 1 (blockIdx.x) and columns n0 .. n0 +
// BN - 1 (blockIdx.y) of y. gridDim.z == 1: every chunk, summed in chunk
// order; gridDim.z == splits: chunk blockIdx.z alone, its fp32 sum to
// work.
template <int BN, int NC, bool kKN>
__global__ void __launch_bounds__(128 * NC + 32, NC == 1 ? 2 : 1)
gemm_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
            const bf16* __restrict__ bias, bf16* __restrict__ y, float* __restrict__ work,
            int M, int N, int K, int chunk_steps) {
  using C = Cfg<BN, NC>;
  constexpr int NS = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  auto full = [&](int s) { return base + 8 * s; };         // stage s landed
  auto empty = [&](int s) { return base + 8 * (NS + s); };  // stage s free
  auto As = [&](int s) { return base + 1024 + C::kStage * s; };
  auto Bs = [&](int s) { return As(s) + C::kA; };

  const int m0 = blockIdx.x * 64 * NC, n0 = blockIdx.y * BN;
  const int ksteps = (K + KSTEP - 1) / KSTEP;
  const int splits = (ksteps + chunk_steps - 1) / chunk_steps;
  const bool partial = gridDim.z > 1;
  const int s0 = partial ? blockIdx.z : 0, s1 = partial ? s0 + 1 : splits;
  auto chunk_len = [&](int s) { return min(chunk_steps, ksteps - s * chunk_steps); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * NC);
    }
    mbar_init_fence();
  }
  if (warp == 4 * NC && lane == 0) {
    tma_prefetch(&tx);
    tma_prefetch(&tw);
  }
  __syncthreads();

  if (warp == 4 * NC) {  // the producer
    for (int s = s0, it = 0; s < s1 && lane == 0; ++s) {
      const int len = chunk_len(s);
      for (int i = 0; 4 * i < len; ++i, ++it) {
        const int st = it % NS, k = KSTEP * s * chunk_steps + BK * i;
        mbar_wait(empty(st), ((it / NS) & 1) ^ 1);
        mbar_expect_tx(full(st), C::kStage);
        tma_load_2d(As(st), &tx, full(st), k, m0);
        if constexpr (kKN) {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load_2d(Bs(st) + c * kSlab, &tw, full(st), n0 + 64 * c, k);
        } else {
          tma_load_2d(Bs(st), &tw, full(st), k, n0);
        }
      }
    }
    return;
  }

  // a consumer: warp w of warpgroup wg holds rows 64 wg + 16 w .. + 15;
  // this thread rows r = 16 w + g and r + 8, columns 8 j + 2 q and + 1
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, q = lane & 3;
  float acc[BN / 2], tot[BN / 2];
  int it = 0;
  for (int s = s0; s < s1; ++s) {
    const int len = chunk_len(s);
    for (int i = 0; 4 * i < len; ++i, ++it) {
      const int st = it % NS;
      mbar_wait(full(st), (it / NS) & 1);
      const uint32_t a = As(st) + wg * kSlab, b = Bs(st);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) product<BN, kKN>(acc, a, b, kk, i > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous tile's products are done
      if (i > 0) mbar_arrive(empty((it - 1) % NS));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty((it - 1) % NS));
    if (!partial) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) tot[e] = s == s0 ? acc[e] : tot[e] + acc[e];
    }
  }

  const int r_lo = m0 + 64 * wg + 16 * w + g;
  if (partial) {  // this chunk's fp32 sum, in place for gemm_reduce
    float* dst = work + (size_t)s0 * M * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r_lo + 8 * hr, col = n0 + 8 * j + 2 * q;
        if (row >= M || col >= N) continue;
        float* p = dst + (size_t)row * N + col;
        if (N % 2 == 0) {
          *reinterpret_cast<float2*>(p) = make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
        } else {
          p[0] = acc[4 * j + 2 * hr];
          if (col + 1 < N) p[1] = acc[4 * j + 2 * hr + 1];
        }
      }
    return;
  }

  // the bias in fp32, one rounding, the bf16 tile through shared memory
  named_barrier(1, 128 * NC);  // every consumer is done with the ring
  unsigned char* epi = smem + 1024 + (size_t)wg * 64 * C::kPitch;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * q, col = n0 + c;
    const float b0 = bias && col < N ? __bfloat162float(bias[col]) : 0.f;
    const float b1 = bias && col + 1 < N ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<uint32_t*>(epi + (16 * w + g + 8 * hr) * C::kPitch + 2 * c) =
          tc::pack2(tot[4 * j + 2 * hr] + b0, tot[4 * j + 2 * hr + 1] + b1);
  }
  named_barrier(2 + wg, 128);
  const int t = threadIdx.x & 127;
  for (int v = t; v < 64 * BN / 8; v += 128) {
    const int r = v / (BN / 8), c = 8 * (v % (BN / 8));
    const int row = m0 + 64 * wg + r, col = n0 + c;
    if (row >= M || col >= N) continue;
    const unsigned char* src = epi + r * C::kPitch + 2 * c;
    bf16* dst = y + (size_t)row * N + col;
    if (N % 8 == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && col + e < N; ++e)
        dst[e] = reinterpret_cast<const bf16*>(src)[e];
    }
  }
}

// y = bf16(work[0] + work[1] + ... in that order, + bias), four outputs a
// thread where N % 4 == 0; the partials are read 4 chunks at a time ahead
// of their adds
__global__ void gemm_reduce(const float* __restrict__ work, const bf16* __restrict__ bias,
                            bf16* __restrict__ y, int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  if (N % 4 == 0) {
    const float4* w4 = reinterpret_cast<const float4*>(work);
    const size_t total4 = total / 4;
    for (size_t o = blockIdx.x * (size_t)blockDim.x + threadIdx.x; o < total4; o += stride) {
      float4 v = w4[o];
      for (int s0 = 1; s0 < splits; s0 += 4) {
        float4 u[4];
#pragma unroll
        for (int d = 0; d < 4; ++d)
          if (s0 + d < splits) u[d] = w4[(size_t)(s0 + d) * total4 + o];
#pragma unroll
        for (int d = 0; d < 4; ++d)
          if (s0 + d < splits) {
            v.x += u[d].x;
            v.y += u[d].y;
            v.z += u[d].z;
            v.w += u[d].w;
          }
      }
      if (bias) {
        const int c = (int)(4 * o % N);
        v.x += __bfloat162float(bias[c]);
        v.y += __bfloat162float(bias[c + 1]);
        v.z += __bfloat162float(bias[c + 2]);
        v.w += __bfloat162float(bias[c + 3]);
      }
      uint2 packed = make_uint2(tc::pack2(v.x, v.y), tc::pack2(v.z, v.w));
      *reinterpret_cast<uint2*>(y + 4 * o) = packed;
    }
    return;
  }
  for (size_t o = blockIdx.x * (size_t)blockDim.x + threadIdx.x; o < total; o += stride) {
    float v = work[o];
    for (int s = 1; s < splits; ++s) v += work[(size_t)s * total + o];
    if (bias) v += __bfloat162float(bias[o % N]);
    y[o] = __float2bfloat16_rn(v);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
typedef CUresult (*ReplaceAddress)(CUtensorMap*, void*);

// A CUDA API entry point found through the runtime (nullptr if missing)
void* cuda_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  return p;
}

// The 2-D bf16 tensor map of a row-major [rows, cols] matrix at `ptr`,
// boxes of box_rows x 64 columns in the 128-byte swizzle: encoded once per
// (rows, cols, box_rows) and kept; a call of a kept shape copies it and
// writes its own address in.
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  static const EncodeTiled encode = (EncodeTiled)cuda_entry("cuTensorMapEncodeTiled");
  static const ReplaceAddress replace =
      (ReplaceAddress)cuda_entry("cuTensorMapReplaceAddress");
  static std::mutex mu;
  static std::map<std::array<int, 3>, CUtensorMap> kept;
  if (!encode || !replace) return false;
  const std::array<int, 3> key = {rows, cols, box_rows};
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = kept.find(key);
    if (it == kept.end()) {
      const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
      const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
      const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
      const cuuint32_t ones[2] = {1, 1};
      if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                 strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                 CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return false;
      if (kept.size() >= 4096) kept.clear();  // a bound no served session nears
      kept.emplace(key, *map);
      return true;
    }
    *map = it->second;
  }
  return replace(map, const_cast<void*>(ptr)) == CUDA_SUCCESS;
}

// One launch of the product under a plan.
template <int BN, int NC, bool kKN>
int launch(const void* x, const void* w, const bf16* bias, bf16* y, float* work, int M,
           int N, int K, int chunk_steps, int splits, int spread, cudaStream_t st) {
  using C = Cfg<BN, NC>;
  CUtensorMap tx, tw;
  if (!tensor_map(&tx, x, M, K, 64 * NC) ||
      !(kKN ? tensor_map(&tw, w, K, N, 64) : tensor_map(&tw, w, N, K, BN)))
    return (int)cudaErrorInvalidValue;
  auto kern = gemm_kernel<BN, NC, kKN>;
  static const int attr = set_smem(kern, C::kSmem);  // once per instantiation
  if (attr != 0) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + 64 * NC - 1) / (64 * NC), (N + BN - 1) / BN, spread ? splits : 1);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = st;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, tx, tw, bias, y, work, M, N, K,
                                       chunk_steps);
  if (err != cudaSuccess || !spread) return (int)err;
  const size_t total = (size_t)M * N / (N % 4 == 0 ? 4 : 1);
  const int blocks = (int)((total + 255) / 256 < 8192 ? (total + 255) / 256 : 8192);
  gemm_reduce<<<blocks, 256, 0, st>>>(work, bias, y, M, N, splits);
  return (int)cudaGetLastError();
}

int launch_plan(int w_nk, int bn, int nc, const void* x, const void* w, const bf16* bias,
                bf16* y, float* work, int M, int N, int K, int chunk_steps, int splits,
                int spread, cudaStream_t st) {
#define GEMM_PLAN(BN_, NC_)                                                                \
  if (bn == BN_ && nc == NC_)                                                              \
    return w_nk ? launch<BN_, NC_, false>(x, w, bias, y, work, M, N, K, chunk_steps, splits, \
                                          spread, st)                                        \
                : launch<BN_, NC_, true>(x, w, bias, y, work, M, N, K, chunk_steps, splits,  \
                                         spread, st);
  GEMM_PLAN(64, 1)
  GEMM_PLAN(64, 2)
  GEMM_PLAN(64, 3)
  GEMM_PLAN(128, 1)
  GEMM_PLAN(128, 2)
  GEMM_PLAN(128, 3)
#undef GEMM_PLAN
  return (int)cudaErrorInvalidValue;
}

// the plan's checks -> splits, or -1
int plan_splits(int M, int N, int K, int w_nk, int bn, int nc, int chunk_steps) {
  if (M < 1 || N < 1 || K < 1 || K % 8 || (!w_nk && N % 8) || chunk_steps < 4 ||
      chunk_steps % 4 || (bn != 64 && bn != 128) || nc < 1 || nc > 3)
    return -1;
  return ((K + KSTEP - 1) / KSTEP + chunk_steps - 1) / chunk_steps;
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// The K tile and the k step the wrapper plans with (ops/gemm_kernel.py
// checks them).
extern "C" void gemm_limits(int* out) {
  out[0] = BK;
  out[1] = KSTEP;
}

// x [M, K], w [N, K] (w_nk) or [K, N], bias [N] or null, y [M, N]: bf16,
// contiguous, 16-byte aligned; K % 8 == 0, and N % 8 == 0 for w [K, N].
// The plan (ops/gemm_kernel.gemm_plan): bn, the tile's columns (64 or
// 128); nc, its consumer warpgroups (1 to 3; 64 rows each); chunk_steps,
// the k16 steps of a K chunk (the arithmetic; a multiple of 4); spread: 1
// runs each chunk in a block of its own through work, fp32 [splits, M,
// N], 0 all of a tile's chunks in one block; the bits are the same.
extern "C" int gemm_bf16(const void* x, const void* w, const void* bias, void* y,
                         void* work, int M, int N, int K, int w_nk, int bn, int nc,
                         int chunk_steps, int spread, void* stream) {
  const int splits = plan_splits(M, N, K, w_nk, bn, nc, chunk_steps);
  spread = spread && splits > 1;
  if (splits < 1 || (spread && !work)) return (int)cudaErrorInvalidValue;
  return launch_plan(w_nk, bn, nc, x, w, static_cast<const bf16*>(bias),
                     static_cast<bf16*>(y), static_cast<float*>(work), M, N, K, chunk_steps,
                     splits, spread, static_cast<cudaStream_t>(stream));
}
