// Conv-TasNet TCN trunk for serving, for Hopper, sm_90a.
//
// Replaces speech_separation_tpu/ops/tcn_pallas.py::tcn_trunk_pallas (body
// _make_kernel), which models/tasnet_serving.py::pallas_apply runs for
// `cli separate --kernel pallas`. Every dilated block of the trunk, per block j
// over the arrays of stack_tcn_weights (gLN folded into its consumers):
//   (A) t1 = prelu(h @ We + b_e)                 bf16 store; stats of fp32 t1
//   (B) t2 = prelu(sum_t (A1 w_t) t1[k + t d - pad] + B1 sum_t w_t + b_dw - edge)
//                                                bf16 store; stats of fp32 t2
//   (C) rs = (t2 @ Wg) st2 + biasc - (mu2 st2) csum
//       h = bf16(h + rs[:, :cb]),  skip = bf16(skip + rs[:, cb:])
// with A1 = g1 st1, B1 = be1 - mu1 A1, st = 1 / sqrt(var + 1e-8) from one-pass
// per-item statistics over (K, ch). A tap outside [0, K) reads zero, and the
// edge term subtracts B1 w_t for it: the SAME zero-padding is of the normalised
// tensor. The roundings are the TPU kernel's, copied: h and skip stored bf16
// after every block, t1 and t2 stored bf16 with statistics from the fp32
// values, products of bf16 operands accumulated in fp32, epilogues in fp32
// (explicit _rn intrinsics, so no fused multiply-add changes a rounding).
//
// What bounds it on this card. At win 16 and 8 s (K = 8000 frames, cb 128,
// ch 256) the two 1x1 products cost 2 K 128 256 + 2 K 256 256 = 1.57 GFLOP per
// block per item: 33 GFLOP per item over 21 blocks, 2.1 TFLOP per 64-item
// batch. The intermediates t1 and t2 (4.1 MB each per item, bf16) go through
// device memory: about 26 MB per block per item, 35 GB per batch, ~10 ms at
// 3.35 TB/s. So the products' arithmetic bounds it, and they run on the
// tensor cores.
//
// What the design does about it. The TPU kernel holds an item's whole t1 slab
// in VMEM; here t1 alone is 4.1 MB per item against 227 KB of shared memory,
// and each gLN needs a reduction over all of an item's (K, ch) before the next
// phase may use it. So each block is three launches, made by a host loop in
// this file (launch order is the only synchronisation):
//   (A) expand_kernel: a 64-frame x 128-column tile of h @ We per CTA (WMMA
//       bf16 16x16x16 fragments, fp32 accumulators, operands staged through
//       shared memory 64 deep); the epilogue writes t1 and the tile's partial
//       sums of t1 and t1^2;
//   (B) depthwise_kernel: reduces the item's partials at entry in a fixed order,
//       then one thread per channel walks 64 frames with the dilated taps, the
//       edge correction and PReLU, writing t2 and its partial sums;
//   (C) project_kernel: reduces the second partials at entry, then the same
//       WMMA tile of t2 @ Wg with the folded epilogue updating h and skip in
//       place (each element is owned by one thread of one CTA).
// Partial sums are combined in a fixed order (warp butterflies, then warps in
// order, then tiles in order), never with float atomics, so two runs agree bit
// for bit. Ragged frames, channels and depths are masked or read as zero.
// Tensor-core tiles with wgmma and TMA, and a fused, L2-resident multi-block
// design that keeps t1 and t2 out of device memory, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 64;        // frames per GEMM tile (python: _TILE_ROWS)
constexpr int kBN = 128;       // output columns per GEMM tile (python: _TILE_COLS)
constexpr int kBK = 64;        // reduction depth per shared-memory stage
constexpr int kLdA = kBK + 8;  // bf16 row pitch of the A stage
constexpr int kLdB = kBN + 8;  // bf16 row pitch of the B stage
constexpr int kLdC = kBN + 4;  // fp32 row pitch of the accumulator tile
constexpr int kRowsB = 64;     // frames per CTA of the depthwise phase (= kBM)

// The operand stages and the fp32 accumulator tile share one shared-memory
// buffer: the tile is written only after the last stage has been read.
constexpr int kStageBytes = (kBM * kLdA + kBK * kLdB) * 2;
constexpr int kTileBytes = kBM * kLdC * 4;
constexpr int kGemmBytes = kStageBytes > kTileBytes ? kStageBytes : kTileBytes;

// Sums s and sq over the CTA in a fixed order; the totals land in thread 0.
__device__ void block_sum2(float& s, float& sq, float (*red)[kWarps]) {
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

// One item's gLN statistics from its n partial (sum, sum of squares) pairs:
// out[0] = mean, out[1] = 1 / sqrt(max(E[x^2] - mean^2, 0) + 1e-8).
__device__ void item_stats(const float2* __restrict__ part, int n, float inv_n,
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

// The kBM x kBN tile at (row0, col0) of a @ b, fp32. a is [rows,
// depth] and b [depth, cols], both bf16 row-major with depth and cols
// multiples of 8 (16-byte loads); out-of-range rows, columns and depth read as
// zero. smem is kGemmBytes, 128-byte aligned; returns the tile in it, which
// every thread may read on return.
__device__ const float* gemm_tile(const bf16* __restrict__ a, int rows, int depth,
                                  const bf16* __restrict__ b, int cols, int row0, int col0,
                                  unsigned char* smem) {
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = sa + kBM * kLdA;
  float* sc = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32;
  const int wr = warp / 2;  // 16-row strip of the tile
  const int wc = warp % 2;  // 64-column half of the tile
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int k0 = 0; k0 < depth; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8);
      const int c = (i % (kBK / 8)) * 8;
      const int gr = row0 + r, gc = k0 + c;
      *reinterpret_cast<uint4*>(sa + r * kLdA + c) =
          (gr < rows && gc < depth)
              ? *reinterpret_cast<const uint4*>(a + static_cast<size_t>(gr) * depth + gc)
              : zero;
    }
    for (int i = threadIdx.x; i < kBK * kBN / 8; i += kThreads) {
      const int r = i / (kBN / 8);
      const int c = (i % (kBN / 8)) * 8;
      const int gr = k0 + r, gc = col0 + c;
      *reinterpret_cast<uint4*>(sb + r * kLdB + c) =
          (gr < depth && gc < cols)
              ? *reinterpret_cast<const uint4*>(b + static_cast<size_t>(gr) * cols + gc)
              : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sa + wr * 16 * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
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

// (A) grid (ceil(K / kBM), ceil(ch / kBN), B). h [B, K, cb], we [cb, ch] bf16;
// vec [8, vdim] fp32 of this block; t1 [B, K, ch] bf16; part [B, gridDim.x *
// gridDim.y] (sum, sum of squares) of the fp32 t1.
__global__ void __launch_bounds__(kThreads)
expand_kernel(const bf16* __restrict__ h, const bf16* __restrict__ we,
              const float* __restrict__ vec, bf16* __restrict__ t1, float2* __restrict__ part,
              int k, int cb, int ch, int vdim) {
  __shared__ __align__(128) unsigned char smem[kGemmBytes];
  __shared__ float red[2][kWarps];
  const int item = blockIdx.z;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const float* tile =
      gemm_tile(h + static_cast<size_t>(item) * k * cb, k, cb, we, ch, row0, col0, smem);
  const float* b_e = vec;
  const float* a1 = vec + 6 * vdim;
  bf16* out = t1 + static_cast<size_t>(item) * k * ch;
  float s = 0.f, sq = 0.f;
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= k || gc >= ch) continue;
    const float y = __fadd_rn(tile[r * kLdC + c], b_e[gc]);
    const float v = y >= 0.f ? y : __fmul_rn(a1[gc], y);
    out[static_cast<size_t>(gr) * ch + gc] = __float2bfloat16(v);
    s += v;
    sq += v * v;
  }
  block_sum2(s, sq, red);
  if (threadIdx.x == 0)
    part[static_cast<size_t>(item) * gridDim.x * gridDim.y + blockIdx.x * gridDim.y + blockIdx.y] =
        make_float2(s, sq);
}

// (B) grid (ceil(K / kRowsB), 1, B). t1, t2 [B, K, ch] bf16; wdw [taps, ch]
// and vec [8, vdim] fp32 of this block; part1 [B, n_part1] from (A); part2
// [B, gridDim.x] of the fp32 t2.
__global__ void __launch_bounds__(kThreads)
depthwise_kernel(const bf16* __restrict__ t1, const float* __restrict__ wdw,
                 const float* __restrict__ vec, const float2* __restrict__ part1, int n_part1,
                 bf16* __restrict__ t2, float2* __restrict__ part2, int k, int ch, int vdim,
                 int taps, int dil, float inv_n) {
  __shared__ float red[2][kWarps];
  __shared__ float stats[2];
  const int item = blockIdx.z;
  item_stats(part1 + static_cast<size_t>(item) * n_part1, n_part1, inv_n, red, stats);
  const float mu1 = stats[0], st1 = stats[1];
  const float* g1 = vec + vdim;
  const float* be1 = vec + 2 * vdim;
  const float* b_dw = vec + 3 * vdim;
  const float* a2 = vec + 7 * vdim;
  const int pad = (taps - 1) * dil / 2;
  const int row0 = blockIdx.x * kRowsB;
  const int row1 = min(row0 + kRowsB, k);
  const bf16* src = t1 + static_cast<size_t>(item) * k * ch;
  bf16* dst = t2 + static_cast<size_t>(item) * k * ch;
  float s = 0.f, sq = 0.f;
  for (int c = threadIdx.x; c < ch; c += kThreads) {
    const float av = __fmul_rn(g1[c], st1);
    const float bv = __fsub_rn(be1[c], __fmul_rn(mu1, av));
    float wsum = 0.f;
    for (int t = 0; t < taps; ++t) wsum = __fadd_rn(wsum, wdw[t * ch + c]);
    const float beff = __fadd_rn(__fmul_rn(bv, wsum), b_dw[c]);
    for (int r = row0; r < row1; ++r) {
      float pre = beff;
      for (int t = 0; t < taps; ++t) {
        const int sr = r + t * dil - pad;
        const float x =
            (sr >= 0 && sr < k) ? __bfloat162float(src[static_cast<size_t>(sr) * ch + c]) : 0.f;
        pre = __fadd_rn(pre, __fmul_rn(__fmul_rn(av, wdw[t * ch + c]), x));
      }
      for (int t = 0; t < taps; ++t) {
        const int off = t * dil - pad;
        if (off != 0 && (r + off < 0 || r + off >= k))
          pre = __fsub_rn(pre, __fmul_rn(bv, wdw[t * ch + c]));
      }
      const float v = pre >= 0.f ? pre : __fmul_rn(a2[c], pre);
      dst[static_cast<size_t>(r) * ch + c] = __float2bfloat16(v);
      s += v;
      sq += v * v;
    }
  }
  block_sum2(s, sq, red);
  if (threadIdx.x == 0) part2[static_cast<size_t>(item) * gridDim.x + blockIdx.x] = make_float2(s, sq);
}

// (C) grid (ceil(K / kBM), ceil(2 cb / kBN), B). t2 [B, K, ch], wg [ch, 2 cb]
// bf16; vec [8, vdim] fp32 of this block; part2 [B, n_part2] from (B); h and
// skip [B, K, cb] bf16, updated in place.
__global__ void __launch_bounds__(kThreads)
project_kernel(const bf16* __restrict__ t2, const bf16* __restrict__ wg,
               const float* __restrict__ vec, const float2* __restrict__ part2, int n_part2,
               bf16* __restrict__ h, bf16* __restrict__ skip, int k, int cb, int ch, int vdim,
               float inv_n) {
  __shared__ __align__(128) unsigned char smem[kGemmBytes];
  __shared__ float red[2][kWarps];
  __shared__ float stats[2];
  const int item = blockIdx.z;
  item_stats(part2 + static_cast<size_t>(item) * n_part2, n_part2, inv_n, red, stats);
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const int out2 = 2 * cb;
  const float* tile =
      gemm_tile(t2 + static_cast<size_t>(item) * k * ch, k, ch, wg, out2, row0, col0, smem);
  const float st2 = stats[1];
  const float ms = __fmul_rn(stats[0], st2);
  const float* biasc = vec + 4 * vdim;
  const float* csum = vec + 5 * vdim;
  const size_t base = static_cast<size_t>(item) * k * cb;
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= k || gc >= out2) continue;
    const float bias2 = __fsub_rn(biasc[gc], __fmul_rn(ms, csum[gc]));
    const float rs = __fadd_rn(__fmul_rn(tile[r * kLdC + c], st2), bias2);
    bf16* dst = gc < cb ? h + base + static_cast<size_t>(gr) * cb + gc
                        : skip + base + static_cast<size_t>(gr) * cb + (gc - cb);
    *dst = __float2bfloat16(__fadd_rn(__bfloat162float(*dst), rs));
  }
}

}  // namespace

// Runs every block of the trunk. h [B, K, cb] bf16 holds h0 and is the carry
// (overwritten); skip [B, K, cb] bf16 must hold zeros and receives the skip
// sum. Scratch: t1 and t2 [B, K, ch] bf16, part B * (ceil(K/64) * ceil(ch/128)
// + ceil(K/64)) float2. we [N, cb, ch] and wg [N, ch, 2 cb] bf16, wdw [N, taps,
// ch] and vecs [N, 8, vdim] fp32 (stack_tcn_weights); dils is a host array of N
// dilations. cb and ch must be multiples of 8. Returns the first non-zero
// cudaGetLastError() of the launches, or 0.
extern "C" int sst_tcn_trunk(void* h, void* skip, void* t1, void* t2, void* part, const void* we,
                             const void* wdw, const void* wg, const void* vecs, const int* dils,
                             int batch, int k, int cb, int ch, int vdim, int taps, int n_blocks,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_tiles = (k + kBM - 1) / kBM;
  const dim3 grid_a(row_tiles, (ch + kBN - 1) / kBN, batch);
  const dim3 grid_b((k + kRowsB - 1) / kRowsB, 1, batch);
  const dim3 grid_c(row_tiles, (2 * cb + kBN - 1) / kBN, batch);
  const int n_part1 = grid_a.x * grid_a.y;
  const int n_part2 = grid_b.x;
  float2* part1 = static_cast<float2*>(part);
  float2* part2 = part1 + static_cast<size_t>(batch) * n_part1;
  const float inv_n = static_cast<float>(1.0 / (static_cast<double>(k) * ch));
  bf16* hb = static_cast<bf16*>(h);
  bf16* t1b = static_cast<bf16*>(t1);
  bf16* t2b = static_cast<bf16*>(t2);
  for (int j = 0; j < n_blocks; ++j) {
    const bf16* we_j = static_cast<const bf16*>(we) + static_cast<size_t>(j) * cb * ch;
    const float* wdw_j = static_cast<const float*>(wdw) + static_cast<size_t>(j) * taps * ch;
    const bf16* wg_j = static_cast<const bf16*>(wg) + static_cast<size_t>(j) * ch * 2 * cb;
    const float* vec_j = static_cast<const float*>(vecs) + static_cast<size_t>(j) * 8 * vdim;
    expand_kernel<<<grid_a, kThreads, 0, s>>>(hb, we_j, vec_j, t1b, part1, k, cb, ch, vdim);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    depthwise_kernel<<<grid_b, kThreads, 0, s>>>(t1b, wdw_j, vec_j, part1, n_part1, t2b, part2, k,
                                                 ch, vdim, taps, dils[j], inv_n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    project_kernel<<<grid_c, kThreads, 0, s>>>(t2b, wg_j, vec_j, part2, n_part2, hb,
                                               static_cast<bf16*>(skip), k, cb, ch, vdim, inv_n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
