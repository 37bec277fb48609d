// gemm: a batch-invariant bf16 matrix product for Hopper (sm_90a),
//   y [M, N] = x [M, K] w^T (+ bias)   with w [N, K]  (w_nk = 1, a Linear)
//   y [M, N] = x [M, K] w   (+ bias)   with w [K, N]  (w_nk = 0, LoRA's A, B)
// bf16 inputs, fp32 accumulation, the bias added in fp32, one rounding to
// bf16 at the end.
//
// Replaces no TPU kernel. The served product's bf16 projections went to
// cuBLAS, which picks its kernel (tile, split-K, reduction order) by the
// row count M: a row of a batched request then summed its products in
// another order than the same row served alone, and the served audio and
// ASR ids depended on what a request was batched with. Here nothing that
// orders a row's sums depends on M: one tile shape, and K cut into chunks
// chosen by the wrapper from (N, K) alone (ops/gemm_kernel.split_count),
// each chunk summed from zero and the chunks added in chunk order. Each
// output element is written by one thread, with no atomics, so two
// launches give the same bits and a row gives the same bits at any M and
// any position.
//
// Design: one block of 4 warps computes a 64 x 128 tile of y, 32 columns
// of K at a time, through a 3-stage cp.async ring of x and w tiles in
// shared memory (rows padded to keep ldmatrix free of bank conflicts);
// each warp holds a 32 x 64 fp32 accumulator and issues mma.sync m16n8k16
// on ldmatrix fragments (ldmatrix.trans for the [K, N] layout). At a small
// M (the wrapper's choice: a grid of tiles smaller than the card, partial
// sums of at most four times the weight's bytes) the chunks run in blocks
// of their own and write fp32 partials [splits, M, N] to a scratch buffer
// the wrapper allocates, which gemm_reduce adds in chunk order; elsewhere
// one block runs its tile's chunks one after the other and adds them in
// the same order. Both do the same fp32 operations, so the choice, which
// does depend on M, changes no bit.
//
// What bounds it on this card: at the served shapes the weights dominate
// the bytes (the B = 1 encode's down_proj reads 27.5 MB of w for 0.3 MB
// of x), so memory bounds it at small M; the split keeps enough blocks in
// flight to stream w at a small M (12 column tiles of down_proj alone fill
// 12 of 132 SMs). At large M the products bound it, and mma.sync reaches
// a fraction of the wgmma rate: a later design can move to wgmma on the
// same invariant plan.

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 128, BK = 32, STAGES = 3, THREADS = 128;
constexpr int LDA = BK + 8;     // x tile row (and w tile row, [N, K] layout)
constexpr int LDB_KN = BN + 8;  // w tile row, [K, N] layout
constexpr int A_STAGE = BM * LDA;
constexpr int B_STAGE = (BN * LDA > BK * LDB_KN) ? BN * LDA : BK * LDB_KN;

using tc::bf16;

template <bool kNK>
struct Gemm {
  bf16* As;
  bf16* Bs;
  const bf16* x;
  const bf16* w;
  int M, N, K, m0, n0, tid, lane, wm, wn;

  __device__ void load(int stage, int kt) {
    const int k0 = kt * BK;
    bf16* as = As + stage * A_STAGE;
    bf16* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < (BM * BK / 8) / THREADS; ++i) {
      const int c = tid + i * THREADS, r = c >> 2, cc = (c & 3) * 8;
      const bool ok = m0 + r < M && k0 + cc < K;
      cp_async16(as + r * LDA + cc, ok ? x + (size_t)(m0 + r) * K + k0 + cc : x, ok);
    }
#pragma unroll
    for (int i = 0; i < (BN * BK / 8) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      if (kNK) {
        const int r = c >> 2, cc = (c & 3) * 8;
        const bool ok = n0 + r < N && k0 + cc < K;
        cp_async16(bs + r * LDA + cc, ok ? w + (size_t)(n0 + r) * K + k0 + cc : w, ok);
      } else {
        const int r = c >> 4, cc = (c & 15) * 8;
        const bool ok = k0 + r < K && n0 + cc < N;
        cp_async16(bs + r * LDB_KN + cc, ok ? w + (size_t)(k0 + r) * N + n0 + cc : w, ok);
      }
    }
  }

  // acc = the products over K tiles [kt0, kt1), summed from zero in tile
  // order: the same operations wherever the chunk runs
  __device__ void chunk(float (&acc)[2][8][4], int kt0, int kt1) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;
    const int n_tiles = max(kt1 - kt0, 0);
    __syncthreads();  // the previous chunk's reads of the ring are done
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_tiles) load(s, kt0 + s);
      cp_async_commit();
    }
    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // tile i landed; every warp is done with tile i - 1
      if (i + STAGES - 1 < n_tiles) load((i + STAGES - 1) % STAGES, kt0 + i + STAGES - 1);
      cp_async_commit();
      const bf16* as = As + (i % STAGES) * A_STAGE;
      const bf16* bs = Bs + (i % STAGES) * B_STAGE;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[2][4], b[8][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          tc::ldmatrix_x4(a[mi], as + (wm * 32 + mi * 16 + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          uint32_t r[4];
          if (kNK) {
            const int n = wn * 64 + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
            tc::ldmatrix_x4(r, bs + n * LDA + kk + ((lane >> 3) & 1) * 8);
          } else {
            const int k = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
            tc::ldmatrix_x4_trans(r, bs + k * LDB_KN + wn * 64 + nj * 16 + (lane >> 4) * 8);
          }
          b[2 * nj][0] = r[0];
          b[2 * nj][1] = r[1];
          b[2 * nj + 1][0] = r[2];
          b[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) tc::mma(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    }
    cp_async_wait<0>();
  }
};

// splits: the K chunks of the arithmetic (from N and K). gridDim.z ==
// splits: chunk blockIdx.z alone, its fp32 partial to work (splits > 1);
// gridDim.z == 1: every chunk in this block, summed in chunk order, the
// very operations gemm_reduce does over the partials.
template <bool kNK>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
            const bf16* __restrict__ bias, bf16* __restrict__ y,
            float* __restrict__ work, int M, int N, int K, int splits,
            int tiles_per_split) {
  __shared__ __align__(16) bf16 As[STAGES * A_STAGE];
  __shared__ __align__(16) bf16 Bs[STAGES * B_STAGE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Gemm<kNK> g{As, Bs, x, w, M, N, K, (int)blockIdx.y * BM, (int)blockIdx.x * BN,
              tid, lane, warp >> 1, warp & 1};  // 2 x 2 warps of 32 x 64
  const int ktiles = (K + BK - 1) / BK;
  const bool partial = gridDim.z > 1;
  float acc[2][8][4], total[2][8][4];
  const int s0 = partial ? blockIdx.z : 0, s1 = partial ? s0 + 1 : splits;
  for (int s = s0; s < s1; ++s) {
    g.chunk(acc, s * tiles_per_split, min((s + 1) * tiles_per_split, ktiles));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          total[mi][ni][r] = s == s0 ? acc[mi][ni][r] : total[mi][ni][r] + acc[mi][ni][r];
  }

  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = g.m0 + g.wm * 32 + mi * 16 + gq + (r >> 1) * 8;
        const int col = g.n0 + g.wn * 64 + ni * 8 + 2 * t + (r & 1);
        if (row >= M || col >= N) continue;
        const size_t o = (size_t)row * N + col;
        if (partial) {
          work[(size_t)blockIdx.z * M * N + o] = total[mi][ni][r];
        } else {
          const float v = total[mi][ni][r] + (bias ? __bfloat162float(bias[col]) : 0.f);
          y[o] = __float2bfloat16_rn(v);
        }
      }
}

// y = bf16(work[0] + work[1] + ... in that order, + bias)
__global__ void gemm_reduce(const float* __restrict__ work, const bf16* __restrict__ bias,
                            bf16* __restrict__ y, int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  for (size_t o = blockIdx.x * (size_t)blockDim.x + threadIdx.x; o < total;
       o += (size_t)gridDim.x * blockDim.x) {
    float v = work[o];
    for (int s = 1; s < splits; ++s) v += work[(size_t)s * total + o];
    if (bias) v += __bfloat162float(bias[o % N]);
    y[o] = __float2bfloat16_rn(v);
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// The tile shape the wrapper plans with (ops/gemm_kernel.py checks it).
extern "C" void gemm_limits(int* out) {
  out[0] = BM;
  out[1] = BN;
  out[2] = BK;
}

// x [M, K], w [N, K] (w_nk) or [K, N], bias [N] or null, y [M, N]: bf16,
// contiguous, 16-byte aligned; K % 8 == 0, and N % 8 == 0 for w [K, N].
// splits: the K chunks (the arithmetic); spread: 1 runs them in parallel
// blocks through work, fp32 [splits, M, N] (the wrapper's choice for a
// grid smaller than the card), 0 in one block each; the bits are the same.
extern "C" int gemm_bf16(const void* x, const void* w, const void* bias, void* y,
                         void* work, int M, int N, int K, int w_nk, int splits,
                         int spread, void* stream) {
  const int ktiles = (K + BK - 1) / BK;
  if (M < 1 || N < 1 || K < 1 || K % 8 || (!w_nk && N % 8) || splits < 1 ||
      splits > ktiles || splits > 64 || (spread && splits > 1 && !work))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tps = (ktiles + splits - 1) / splits;
  const int gz = spread ? splits : 1;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, gz);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const bf16* bb = static_cast<const bf16*>(bias);
  bf16* yb = static_cast<bf16*>(y);
  float* wk = static_cast<float*>(work);
  if (w_nk)
    gemm_kernel<true><<<grid, THREADS, 0, st>>>(xb, wb, bb, yb, wk, M, N, K, splits, tps);
  else
    gemm_kernel<false><<<grid, THREADS, 0, st>>>(xb, wb, bb, yb, wk, M, N, K, splits, tps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || gz == 1) return (int)err;
  const size_t total = (size_t)M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  gemm_reduce<<<blocks, 256, 0, st>>>(wk, bb, yb, M, N, splits);
  return (int)cudaGetLastError();
}
