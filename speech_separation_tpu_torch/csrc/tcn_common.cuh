// Pieces shared by the Conv-TasNet trunk kernels (tcn_trunk.cu, the forward
// for serving and training, and tcn_train_backward.cu): the GEMM tile on WMMA
// bf16 fragments with fp32 accumulation, and the fixed-order reductions that
// make two runs agree bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace tcn {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 64;        // rows per GEMM tile (python: _TILE_ROWS)
constexpr int kBN = 128;       // output columns per GEMM tile (python: _TILE_COLS)
constexpr int kBK = 64;        // reduction depth per shared-memory stage
constexpr int kLdA = kBK + 8;  // bf16 row pitch of the A stage, [kBM][kLdA]
constexpr int kLdAT = kBM + 8; // the same, A transposed, [kBK][kLdAT]
constexpr int kLdB = kBN + 8;  // bf16 row pitch of the B stage, [kBK][kLdB]
constexpr int kLdBT = kBK + 8; // the same, B transposed, [kBN][kLdBT]
constexpr int kLdC = kBN + 4;  // fp32 row pitch of the accumulator tile
constexpr int kRowsB = 64;     // frames per CTA of the per-channel phases (= kBM)

// The operand stages and the fp32 accumulator tile share one shared-memory
// buffer: the tile is written only after the last stage has been read.
constexpr int kStageA = kBM * kLdA;  // = kBK * kLdAT
constexpr int kStageB = kBK * kLdB > kBN * kLdBT ? kBK * kLdB : kBN * kLdBT;
constexpr int kStageBytes = (kStageA + kStageB) * 2;
constexpr int kTileBytes = kBM * kLdC * 4;
constexpr int kGemmBytes = kStageBytes > kTileBytes ? kStageBytes : kTileBytes;

// Sums s and sq over the CTA in a fixed order; the totals land in thread 0.
__device__ inline void block_sum2(float& s, float& sq, float (*red)[kWarps]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  const int warp = threadIdx.x / 32;
  __syncthreads();  // red may still be read by a previous call
  if (threadIdx.x % 32 == 0) {
    red[0][warp] = s;
    red[1][warp] = sq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s = 0.f;
    sq = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      s += red[0][w];
      sq += red[1][w];
    }
  }
}

// The totals of an item's n partial (sum, sum of squares) pairs, in a fixed
// order, into out[0], out[1], which every thread may read on return.
__device__ inline void item_sum2(const float2* __restrict__ part, int n, float (*red)[kWarps],
                                 float* out) {
  float s = 0.f, sq = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    s += part[i].x;
    sq += part[i].y;
  }
  block_sum2(s, sq, red);
  if (threadIdx.x == 0) {
    out[0] = s;
    out[1] = sq;
  }
  __syncthreads();
}

// One item's gLN statistics from its n partial (sum, sum of squares) pairs:
// out[0] = mean, out[1] = 1 / sqrt(max(E[x^2] - mean^2, 0) + 1e-8).
__device__ inline void item_stats(const float2* __restrict__ part, int n, float inv_n,
                                  float (*red)[kWarps], float* out) {
  float s = 0.f, sq = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    s += part[i].x;
    sq += part[i].y;
  }
  block_sum2(s, sq, red);
  if (threadIdx.x == 0) {
    const float mu = __fmul_rn(s, inv_n);
    const float var = fmaxf(__fsub_rn(__fmul_rn(sq, inv_n), __fmul_rn(mu, mu)), 0.f);
    out[0] = mu;
    out[1] = 1.f / sqrtf(__fadd_rn(var, 1e-8f));
  }
  __syncthreads();
}

// The kBM x kBN tile at (row0, col0) of op(A) @ op(B) over the depth range
// [k_begin, k_end), fp32, both operands bf16 row-major in device memory:
//   A(m, d) = kTA ? a[d * lda + m] : a[m * lda + d]     (m < rows)
//   B(d, n) = kTB ? b[n * ldb + d] : b[d * ldb + n]     (n < cols)
// Loads are 16 bytes: lda, ldb, rows, cols, k_begin and, where the depth runs
// along a load (A not transposed, B transposed), k_end are multiples of 8.
// Out-of-range rows, columns and depth read as zero. smem is kGemmBytes,
// 128-byte aligned; returns the tile in it, which every thread may read.
template <bool kTA, bool kTB>
__device__ const float* gemm_tile(const bf16* __restrict__ a, int lda, const bf16* __restrict__ b,
                                  int ldb, int rows, int cols, int k_begin, int k_end, int row0,
                                  int col0, unsigned char* smem) {
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = sa + kStageA;
  float* sc = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32;
  const int wr = warp / 2;  // 16-row strip of the tile
  const int wc = warp % 2;  // 64-column half of the tile
  using LayoutA = typename std::conditional<kTA, wmma::col_major, wmma::row_major>::type;
  using LayoutB = typename std::conditional<kTB, wmma::col_major, wmma::row_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK / 8; i += kThreads) {
      if (kTA) {  // stage [kBK][kLdAT]: 8 rows of A per load
        const int d = i / (kBM / 8), m = (i % (kBM / 8)) * 8;
        const int gd = k0 + d, gm = row0 + m;
        *reinterpret_cast<uint4*>(sa + d * kLdAT + m) =
            (gd < k_end && gm < rows)
                ? *reinterpret_cast<const uint4*>(a + static_cast<size_t>(gd) * lda + gm)
                : zero;
      } else {  // stage [kBM][kLdA]: 8 depths per load
        const int m = i / (kBK / 8), d = (i % (kBK / 8)) * 8;
        const int gm = row0 + m, gd = k0 + d;
        *reinterpret_cast<uint4*>(sa + m * kLdA + d) =
            (gm < rows && gd < k_end)
                ? *reinterpret_cast<const uint4*>(a + static_cast<size_t>(gm) * lda + gd)
                : zero;
      }
    }
    for (int i = threadIdx.x; i < kBK * kBN / 8; i += kThreads) {
      if (kTB) {  // stage [kBN][kLdBT]: 8 depths per load
        const int n = i / (kBK / 8), d = (i % (kBK / 8)) * 8;
        const int gn = col0 + n, gd = k0 + d;
        *reinterpret_cast<uint4*>(sb + n * kLdBT + d) =
            (gn < cols && gd < k_end)
                ? *reinterpret_cast<const uint4*>(b + static_cast<size_t>(gn) * ldb + gd)
                : zero;
      } else {  // stage [kBK][kLdB]: 8 columns per load
        const int d = i / (kBN / 8), n = (i % (kBN / 8)) * 8;
        const int gd = k0 + d, gn = col0 + n;
        *reinterpret_cast<uint4*>(sb + d * kLdB + n) =
            (gd < k_end && gn < cols)
                ? *reinterpret_cast<const uint4*>(b + static_cast<size_t>(gd) * ldb + gn)
                : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> fa;
      if (kTA)
        wmma::load_matrix_sync(fa, sa + kk * kLdAT + wr * 16, kLdAT);
      else
        wmma::load_matrix_sync(fa, sa + wr * 16 * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> fb;
        if (kTB)
          wmma::load_matrix_sync(fb, sb + (wc * 64 + j * 16) * kLdBT + kk, kLdBT);
        else
          wmma::load_matrix_sync(fb, sb + kk * kLdB + wc * 64 + j * 16, kLdB);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(sc + wr * 16 * kLdC + wc * 64 + j * 16, acc[j], kLdC,
                            wmma::mem_row_major);
  __syncthreads();
  return sc;
}

__device__ inline float prelu(float x, float alpha) { return x >= 0.f ? x : __fmul_rn(alpha, x); }

}  // namespace tcn
