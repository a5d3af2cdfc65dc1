// Conv-TasNet TCN trunk, forward, for serving and training, for Hopper, sm_90a.
//
// Replaces speech_separation_tpu/ops/tcn_pallas.py::tcn_trunk_pallas (body
// _make_kernel), which models/tasnet_serving.py::pallas_apply runs for
// `cli separate --kernel pallas`, and, as its training mode (sst_tcn_trunk_train),
// the forward of speech_separation_tpu/ops/tcn_train_pallas.py::_fwd_call (body
// _make_fwd_kernel), which train/steps.py::make_time_domain_steps runs with
// pallas_trunk=True. Every dilated block of the trunk, per block j
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
//
// Training mode (template flag kTrain; the serving instantiation is the code
// above unchanged). It computes the same trunk bit for bit and also stores what
// the backward (tcn_train_backward.cu) recomputes from: each block's input h
// (bf16, [N, B, K, cb], one device-to-device copy per block ahead of phase A,
// so a block's h is one [B K, cb] matrix for the weight-gradient products) and
// the four per-item statistics (mu1, st1, mu2, st2) of each block ([N, B, 4]
// fp32, written by the first CTA of phases B and C). At the training shape
// (16 x 4 s at win 16: K = 4000, 21 blocks) the saved h adds 21 x 16 MB = 344
// MB of writes to the ~17 GB that t1 and t2 move: the products still bound it.

#include "tcn_common.cuh"

namespace {

using namespace tcn;

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
  const float* tile = gemm_tile<false, false>(h + static_cast<size_t>(item) * k * cb, cb, we, ch,
                                              k, ch, 0, cb, row0, col0, smem);
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
// [B, gridDim.x] of the fp32 t2. kTrain: st [B, 4] of this block receives
// (mu1, st1) of each item.
template <bool kTrain>
__global__ void __launch_bounds__(kThreads)
depthwise_kernel(const bf16* __restrict__ t1, const float* __restrict__ wdw,
                 const float* __restrict__ vec, const float2* __restrict__ part1, int n_part1,
                 bf16* __restrict__ t2, float2* __restrict__ part2, int k, int ch, int vdim,
                 int taps, int dil, float inv_n, float* __restrict__ st) {
  __shared__ float red[2][kWarps];
  __shared__ float stats[2];
  const int item = blockIdx.z;
  item_stats(part1 + static_cast<size_t>(item) * n_part1, n_part1, inv_n, red, stats);
  const float mu1 = stats[0], st1 = stats[1];
  if constexpr (kTrain) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      st[item * 4 + 0] = mu1;
      st[item * 4 + 1] = st1;
    }
  }
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
// skip [B, K, cb] bf16, updated in place. kTrain: st [B, 4] of this block
// receives (mu2, st2) of each item.
template <bool kTrain>
__global__ void __launch_bounds__(kThreads)
project_kernel(const bf16* __restrict__ t2, const bf16* __restrict__ wg,
               const float* __restrict__ vec, const float2* __restrict__ part2, int n_part2,
               bf16* __restrict__ h, bf16* __restrict__ skip, int k, int cb, int ch, int vdim,
               float inv_n, float* __restrict__ st) {
  __shared__ __align__(128) unsigned char smem[kGemmBytes];
  __shared__ float red[2][kWarps];
  __shared__ float stats[2];
  const int item = blockIdx.z;
  item_stats(part2 + static_cast<size_t>(item) * n_part2, n_part2, inv_n, red, stats);
  if constexpr (kTrain) {
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
      st[item * 4 + 2] = stats[0];
      st[item * 4 + 3] = stats[1];
    }
  }
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const int out2 = 2 * cb;
  const float* tile = gemm_tile<false, false>(t2 + static_cast<size_t>(item) * k * ch, ch, wg,
                                              out2, k, out2, 0, ch, row0, col0, smem);
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

// Every block of the trunk; kTrain adds the residual stores (hb, st).
template <bool kTrain>
int run_trunk(void* h, void* skip, void* t1, void* t2, void* part, const void* we,
              const void* wdw, const void* wg, const void* vecs, const int* dils, void* hb,
              void* st, int batch, int k, int cb, int ch, int vdim, int taps, int n_blocks,
              cudaStream_t s) {
  const int row_tiles = (k + kBM - 1) / kBM;
  const dim3 grid_a(row_tiles, (ch + kBN - 1) / kBN, batch);
  const dim3 grid_b((k + kRowsB - 1) / kRowsB, 1, batch);
  const dim3 grid_c(row_tiles, (2 * cb + kBN - 1) / kBN, batch);
  const int n_part1 = grid_a.x * grid_a.y;
  const int n_part2 = grid_b.x;
  float2* part1 = static_cast<float2*>(part);
  float2* part2 = part1 + static_cast<size_t>(batch) * n_part1;
  const float inv_n = static_cast<float>(1.0 / (static_cast<double>(k) * ch));
  bf16* hbf = static_cast<bf16*>(h);
  bf16* t1b = static_cast<bf16*>(t1);
  bf16* t2b = static_cast<bf16*>(t2);
  const size_t h_elems = static_cast<size_t>(batch) * k * cb;
  for (int j = 0; j < n_blocks; ++j) {
    const bf16* we_j = static_cast<const bf16*>(we) + static_cast<size_t>(j) * cb * ch;
    const float* wdw_j = static_cast<const float*>(wdw) + static_cast<size_t>(j) * taps * ch;
    const bf16* wg_j = static_cast<const bf16*>(wg) + static_cast<size_t>(j) * ch * 2 * cb;
    const float* vec_j = static_cast<const float*>(vecs) + static_cast<size_t>(j) * 8 * vdim;
    float* st_j = nullptr;
    if constexpr (kTrain) {
      st_j = static_cast<float*>(st) + static_cast<size_t>(j) * batch * 4;
      cudaError_t err = cudaMemcpyAsync(static_cast<bf16*>(hb) + j * h_elems, hbf,
                                        h_elems * sizeof(bf16), cudaMemcpyDeviceToDevice, s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    expand_kernel<<<grid_a, kThreads, 0, s>>>(hbf, we_j, vec_j, t1b, part1, k, cb, ch, vdim);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    depthwise_kernel<kTrain><<<grid_b, kThreads, 0, s>>>(t1b, wdw_j, vec_j, part1, n_part1, t2b,
                                                         part2, k, ch, vdim, taps, dils[j], inv_n,
                                                         st_j);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    project_kernel<kTrain><<<grid_c, kThreads, 0, s>>>(t2b, wg_j, vec_j, part2, n_part2, hbf,
                                                       static_cast<bf16*>(skip), k, cb, ch, vdim,
                                                       inv_n, st_j);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
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
  return run_trunk<false>(h, skip, t1, t2, part, we, wdw, wg, vecs, dils, nullptr, nullptr, batch,
                          k, cb, ch, vdim, taps, n_blocks, static_cast<cudaStream_t>(stream));
}

// sst_tcn_trunk, and the training residuals: hb [N, B, K, cb] bf16 receives
// each block's input h, st [N, B, 4] fp32 its (mu1, st1, mu2, st2) per item.
extern "C" int sst_tcn_trunk_train(void* h, void* skip, void* t1, void* t2, void* part,
                                   const void* we, const void* wdw, const void* wg,
                                   const void* vecs, const int* dils, void* hb, void* st,
                                   int batch, int k, int cb, int ch, int vdim, int taps,
                                   int n_blocks, void* stream) {
  return run_trunk<true>(h, skip, t1, t2, part, we, wdw, wg, vecs, dils, hb, st, batch, k, cb, ch,
                         vdim, taps, n_blocks, static_cast<cudaStream_t>(stream));
}
