// Conv-TasNet TCN trunk, backward, for Hopper, sm_90a.
//
// Replaces speech_separation_tpu/ops/tcn_train_pallas.py::_bwd_call (body
// _make_bwd_kernel), the backward of tcn_trunk_train, which
// train/steps.py::make_time_domain_steps runs with pallas_trunk=True. It walks
// the blocks in reverse from the residuals of the training forward (each
// block's input h and its four gLN statistics, tcn_trunk.cu's training mode)
// and the skip sum's cotangent dskip, over the canonical arrays of
// stack_canonical (we [N, cb, ch] and wcat [N, ch, 2cb] bf16, wdw [N, taps, ch]
// and vecs [N, 10, vdim] fp32). Per block j, with the saved (mu1, s1, mu2, s2)
// and A1 = g1 s1, B1 = b1 - mu1 A1 (what the TPU kernel's P1 to P6 compute):
//   P1  t1 = bf16(prelu(h @ We + be))                              recompute
//   P2  d  = bf16(dwconv(A1 t1) + B1 sum w + bdw - edge)           recompute
//   P3  xh2 = (prelu(d) - mu2) s2,  n2 = bf16(g2 xh2 + b2),  drs = bf16([dh | dskip])
//       dn2 = drs @ Wcat^T,  dWcat += n2^T drs,  dbcat += sum drs,
//       dg2 += sum dn2 xh2,  db2 += sum dn2,  dxh2 = dn2 g2
//   P4  dt2 = s2 (bf16(dxh2) - mean(dxh2) - xh2 mean(dxh2 xh2)),
//       dd = where(d >= 0, dt2, a2 dt2),  da2 += sum dt2 min(d, 0),  dbdw += sum dd
//   P5  dn1[u] = sum_t w_t bf16(dd)[u - rel_t],  dw_t += sum_u bf16(dd)[u] n1[u + rel_t]
//       (n1 = A1 t1 + B1 inside [0, K), 0 outside), xh1 = (t1 - mu1) s1,
//       dg1 += sum dn1 xh1,  db1 += sum dn1,  dxh1 = dn1 g1
//   P6  dt1 = s1 (bf16(dxh1) - mean(dxh1) - xh1 mean(dxh1 xh1)),  y = h @ We + be,
//       dt1p = where(y >= 0, dt1, a1 dt1),  da1 += sum dt1 min(y, 0),  dbe += sum dt1p,
//       dWe += h^T bf16(dt1p),  dh += bf16(dt1p) @ We^T
// with rel_t = t d - (taps - 1) d / 2, the means over an item's (K, ch), and
// dh the fp32 carry (zero for the last block; dh0 after the first). The
// roundings are the TPU kernel's: recomputed t1 and d, n2, drs, dxh2, dd, dxh1
// and dt1p stored bf16, products of bf16 operands accumulated in fp32, sums
// and epilogues in fp32 with explicit _rn intrinsics.
//
// What bounds it on this card. At the training shape (16 x 4 s at win 16: B
// 16, K = 4000 frames, cb 128, ch 256, 21 blocks) the five products a block
// needs (the h @ We recompute, dn2, dWcat, dWe, dh) cost 14 B K cb ch = 29.4
// GFLOP, 617 GFLOP per pass: 0.62 ms at 989 TFLOP/s. The compulsory bytes
// (the saved h, dskip and dh0 in fp32, weights) are ~0.4 GB, 0.12 ms. So the
// products bound it. The hidden-width intermediates (t1, d, n2, dxh2, dd,
// dxh1, dt1p: 33 MB each per block, bf16) go through device memory here, ~10
// GB per pass.
//
// What the design does about it. The TPU kernel keeps an item's slabs in VMEM
// and runs one grid step per item; here an item's t1 is 2 MB against 227 KB
// of shared memory, and each gLN-backward mean spans an item's whole (K, ch),
// so each mean is a grid-wide barrier: a launch boundary, as in the forward.
// Per block, in launch order (the only synchronisation):
//   pack_drs        drs = bf16([dh | dskip]) and per-tile column sums (dbcat);
//   recompute_t1    P1, a WMMA GEMM tile with the PReLU epilogue;
//   recompute_d     P2, one thread per channel over 64 frames;
//   project_bwd     P3, the WMMA tile of drs @ Wcat^T with the gLN2 epilogue
//                   (n2, dxh2, column sums, per-tile partials of the two means);
//   wgrad + reduce  dWcat = n2^T drs over all B K frames, split in chunks of
//                   1024 frames, the chunks' partials summed in order;
//   dd_bwd          P4, one thread per channel;
//   dwconv_bwd      P5, the transposed dilated taps, dw and the gLN1 sums;
//   expand_bwd      P6, the h @ We recompute as a WMMA tile with the gLN1
//                   backward and PReLU epilogue, writing dt1p;
//   wgrad + reduce  dWe = h^T dt1p;
//   dh_update       dh += dt1p @ We^T, a WMMA tile added into the fp32 carry;
//   reduce          the per-tile vector and dw partials into dvec[j], dwdw[j].
// Every sum is taken in one fixed order (warp butterflies, warps in order,
// tiles and chunks in order), with no float atomics, so reruns agree bit for
// bit. Ragged frames and channels are masked or read as zero. wgmma, TMA,
// pipelined stages and fusing P4 into P5 are later work.
//
// P6 computes h @ We a second time (P1 computed it for t1) instead of keeping
// y: at the training shape that product is 2 B K cb ch = 4.2 GFLOP a block,
// 4.2 us at 989 TFLOP/s, while y kept in fp32 is 65.5 MB written and read
// again, 39 us at 3.35 TB/s. So the recompute is the cheaper side of the
// bound; it costs one WMMA pass more while the products run far from peak.

#include "tcn_common.cuh"

namespace {

using namespace tcn;

constexpr int kMaxTaps = 8;
constexpr int kSplit = 1024;  // frames per chunk of the weight-gradient products
constexpr int kVecRows = 10;  // rows of vecs (stack_canonical)

// Column sums of a kBM x kBN epilogue: each thread holds the sum over its rows
// of column threadIdx.x % kBN; adds the two threads of each column in order
// and stores sum into dst[c] for col0 + c < cols.
__device__ void store_col_sums(float v, float* __restrict__ dst, int col0, int cols,
                               float* __restrict__ colred) {
  __syncthreads();
  colred[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x < kBN && col0 + threadIdx.x < cols)
    dst[col0 + threadIdx.x] = __fadd_rn(colred[threadIdx.x], colred[threadIdx.x + kBN]);
}

// drs [B, K, 2 cb] = bf16([dh | dskip]); row 6 of vpart [B * tiles, 10, vdim]
// receives the tile's column sums of the rounded values. grid (tiles, 1, B).
__global__ void __launch_bounds__(kThreads)
pack_drs(const float* __restrict__ dh, const float* __restrict__ dskip, bf16* __restrict__ drs,
         float* __restrict__ vpart, int k, int cb, int vdim) {
  const int item = blockIdx.z;
  const int row0 = blockIdx.x * kRowsB, row1 = min(row0 + kRowsB, k);
  const size_t base = static_cast<size_t>(item) * k;
  float* dst = vpart + (static_cast<size_t>(item) * gridDim.x + blockIdx.x) * kVecRows * vdim;
  for (int c = threadIdx.x; c < 2 * cb; c += kThreads) {
    float s = 0.f;
    for (int r = row0; r < row1; ++r) {
      const size_t row = base + r;
      const float v = c < cb ? dh[row * cb + c] : dskip[row * cb + c - cb];
      const bf16 q = __float2bfloat16(v);
      drs[row * 2 * cb + c] = q;
      s = __fadd_rn(s, __bfloat162float(q));
    }
    dst[6 * vdim + c] = s;
  }
}

// P1. grid (ceil(K / kBM), ceil(ch / kBN), B). h [B, K, cb] and we [cb, ch]
// bf16; vec [10, vdim] fp32; t1 [B, K, ch] bf16.
__global__ void __launch_bounds__(kThreads)
recompute_t1(const bf16* __restrict__ h, const bf16* __restrict__ we, const float* __restrict__ vec,
             bf16* __restrict__ t1, int k, int cb, int ch, int vdim) {
  __shared__ __align__(128) unsigned char smem[kGemmBytes];
  const int item = blockIdx.z;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const float* tile = gemm_tile<false, false>(h + static_cast<size_t>(item) * k * cb, cb, we, ch,
                                              k, ch, 0, cb, row0, col0, smem);
  const float* be = vec;
  const float* a1 = vec + 8 * vdim;
  bf16* out = t1 + static_cast<size_t>(item) * k * ch;
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= k || gc >= ch) continue;
    const float y = __fadd_rn(tile[r * kLdC + c], be[gc]);
    out[static_cast<size_t>(gr) * ch + gc] = __float2bfloat16(prelu(y, a1[gc]));
  }
}

// P2. grid (ceil(K / kRowsB), 1, B). t1, d [B, K, ch] bf16; wdw [taps, ch],
// vec [10, vdim] fp32; st [B, 4] (mu1, s1, mu2, s2) of this block.
__global__ void __launch_bounds__(kThreads)
recompute_d(const bf16* __restrict__ t1, const float* __restrict__ wdw,
            const float* __restrict__ vec, const float* __restrict__ st, bf16* __restrict__ d,
            int k, int ch, int vdim, int taps, int dil) {
  const int item = blockIdx.z;
  const float mu1 = st[item * 4 + 0], s1 = st[item * 4 + 1];
  const float* g1 = vec + vdim;
  const float* b1 = vec + 2 * vdim;
  const float* bdw = vec + 3 * vdim;
  const int pad = (taps - 1) * dil / 2;
  const int row0 = blockIdx.x * kRowsB, row1 = min(row0 + kRowsB, k);
  const bf16* src = t1 + static_cast<size_t>(item) * k * ch;
  bf16* dst = d + static_cast<size_t>(item) * k * ch;
  for (int c = threadIdx.x; c < ch; c += kThreads) {
    const float av = __fmul_rn(g1[c], s1);
    const float bv = __fsub_rn(b1[c], __fmul_rn(mu1, av));
    float wsum = 0.f;
    for (int t = 0; t < taps; ++t) wsum = __fadd_rn(wsum, wdw[t * ch + c]);
    const float beff = __fadd_rn(__fmul_rn(bv, wsum), bdw[c]);
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
      dst[static_cast<size_t>(r) * ch + c] = __float2bfloat16(pre);
    }
  }
}

// P3. grid (ceil(K / kBM), ceil(ch / kBN), B). drs [B, K, 2 cb], wcat [ch,
// 2 cb], d [B, K, ch] bf16; writes n2 and dxh2 [B, K, ch] bf16, rows 4 and 5 of
// vpart, and part2 [B, gridDim.x * gridDim.y] (sum dxh2, sum dxh2 xh2).
__global__ void __launch_bounds__(kThreads)
project_bwd(const bf16* __restrict__ drs, const bf16* __restrict__ wcat,
            const bf16* __restrict__ d, const float* __restrict__ vec,
            const float* __restrict__ st, bf16* __restrict__ n2, bf16* __restrict__ dxh2,
            float* __restrict__ vpart, float2* __restrict__ part2, int k, int cb, int ch,
            int vdim) {
  __shared__ __align__(128) unsigned char smem[kGemmBytes];
  __shared__ float red[2][kWarps];
  __shared__ float colred[kThreads];
  const int item = blockIdx.z;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const float* tile = gemm_tile<false, true>(drs + static_cast<size_t>(item) * k * 2 * cb, 2 * cb,
                                             wcat, 2 * cb, k, ch, 0, 2 * cb, row0, col0, smem);
  const float mu2 = st[item * 4 + 2], s2 = st[item * 4 + 3];
  const float* g2 = vec + 4 * vdim;
  const float* b2 = vec + 5 * vdim;
  const float* a2 = vec + 9 * vdim;
  const size_t base = static_cast<size_t>(item) * k * ch;
  float s = 0.f, sq = 0.f, col_g = 0.f, col_b = 0.f;
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= k || gc >= ch) continue;
    const size_t at = base + static_cast<size_t>(gr) * ch + gc;
    const float xh = __fmul_rn(__fsub_rn(prelu(__bfloat162float(d[at]), a2[gc]), mu2), s2);
    n2[at] = __float2bfloat16(__fadd_rn(__fmul_rn(g2[gc], xh), b2[gc]));
    const float dn = tile[r * kLdC + c];
    col_g = __fadd_rn(col_g, __fmul_rn(dn, xh));
    col_b = __fadd_rn(col_b, dn);
    const float dx = __fmul_rn(dn, g2[gc]);
    dxh2[at] = __float2bfloat16(dx);
    s = __fadd_rn(s, dx);
    sq = __fadd_rn(sq, __fmul_rn(dx, xh));
  }
  float* dst = vpart + (static_cast<size_t>(item) * gridDim.x + blockIdx.x) * kVecRows * vdim;
  store_col_sums(col_g, dst + 4 * vdim, col0, ch, colred);
  store_col_sums(col_b, dst + 5 * vdim, col0, ch, colred);
  block_sum2(s, sq, red);
  if (threadIdx.x == 0)
    part2[static_cast<size_t>(item) * gridDim.x * gridDim.y + blockIdx.x * gridDim.y + blockIdx.y] =
        make_float2(s, sq);
}

// One chunk of a weight gradient over the flattened B K frames:
// part[chunk] [rows, cols] = a^T b over frames [chunk kSplit, (chunk + 1)
// kSplit), a [frames, rows] and b [frames, cols] bf16. grid (ceil(rows / kBM),
// ceil(cols / kBN), chunks).
__global__ void __launch_bounds__(kThreads)
wgrad(const bf16* __restrict__ a, const bf16* __restrict__ b, float* __restrict__ part,
      int frames, int rows, int cols) {
  __shared__ __align__(128) unsigned char smem[kGemmBytes];
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const int f0 = blockIdx.z * kSplit, f1 = min(f0 + kSplit, frames);
  const float* tile = gemm_tile<true, false>(a, rows, b, cols, rows, cols, f0, f1, row0, col0, smem);
  float* dst = part + static_cast<size_t>(blockIdx.z) * rows * cols;
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr < rows && gc < cols) dst[static_cast<size_t>(gr) * cols + gc] = tile[r * kLdC + c];
  }
}

// out[i] = sum over p in order of part[p len + i], i < len.
__global__ void __launch_bounds__(kThreads)
sum_parts(const float* __restrict__ part, int n_parts, int len, float* __restrict__ out) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < len; i += gridDim.x * kThreads) {
    float s = 0.f;
    for (int p = 0; p < n_parts; ++p) s = __fadd_rn(s, part[static_cast<size_t>(p) * len + i]);
    out[i] = s;
  }
}

// P4. grid (ceil(K / kRowsB), 1, B). d, dxh2 [B, K, ch] bf16 from P2, P3; the
// item's part2 sums; writes dd [B, K, ch] bf16 and rows 3 and 9 of vpart.
__global__ void __launch_bounds__(kThreads)
dd_bwd(const bf16* __restrict__ d, const bf16* __restrict__ dxh2, const float* __restrict__ vec,
       const float* __restrict__ st, const float2* __restrict__ part2, int n_part2,
       bf16* __restrict__ dd, float* __restrict__ vpart, int k, int ch, int vdim, float inv_n) {
  __shared__ float red[2][kWarps];
  __shared__ float sums[2];
  const int item = blockIdx.z;
  item_sum2(part2 + static_cast<size_t>(item) * n_part2, n_part2, red, sums);
  const float ma = __fmul_rn(sums[0], inv_n), mb = __fmul_rn(sums[1], inv_n);
  const float mu2 = st[item * 4 + 2], s2 = st[item * 4 + 3];
  const float* a2 = vec + 9 * vdim;
  const int row0 = blockIdx.x * kRowsB, row1 = min(row0 + kRowsB, k);
  const size_t base = static_cast<size_t>(item) * k * ch;
  float* dst = vpart + (static_cast<size_t>(item) * gridDim.x + blockIdx.x) * kVecRows * vdim;
  for (int c = threadIdx.x; c < ch; c += kThreads) {
    float col_a = 0.f, col_b = 0.f;
    for (int r = row0; r < row1; ++r) {
      const size_t at = base + static_cast<size_t>(r) * ch + c;
      const float dc = __bfloat162float(d[at]);
      const float xh = __fmul_rn(__fsub_rn(prelu(dc, a2[c]), mu2), s2);
      const float dx = __bfloat162float(dxh2[at]);
      const float dt2 = __fmul_rn(s2, __fsub_rn(__fsub_rn(dx, ma), __fmul_rn(xh, mb)));
      const float ddc = dc >= 0.f ? dt2 : __fmul_rn(a2[c], dt2);
      col_a = __fadd_rn(col_a, __fmul_rn(dt2, fminf(dc, 0.f)));
      col_b = __fadd_rn(col_b, ddc);
      dd[at] = __float2bfloat16(ddc);
    }
    dst[9 * vdim + c] = col_a;
    dst[3 * vdim + c] = col_b;
  }
}

// P5. grid (ceil(K / kRowsB), 1, B). dd, t1 [B, K, ch] bf16; writes dxh1 [B,
// K, ch] bf16, rows 1 and 2 of vpart, wpart [B * tiles, taps, ch] and part1
// [B, gridDim.x] (sum dxh1, sum dxh1 xh1).
__global__ void __launch_bounds__(kThreads)
dwconv_bwd(const bf16* __restrict__ dd, const bf16* __restrict__ t1,
           const float* __restrict__ wdw, const float* __restrict__ vec,
           const float* __restrict__ st, bf16* __restrict__ dxh1, float* __restrict__ vpart,
           float* __restrict__ wpart, float2* __restrict__ part1, int k, int ch, int vdim,
           int taps, int dil) {
  __shared__ float red[2][kWarps];
  const int item = blockIdx.z;
  const float mu1 = st[item * 4 + 0], s1 = st[item * 4 + 1];
  const float* g1 = vec + vdim;
  const float* b1 = vec + 2 * vdim;
  const int pad = (taps - 1) * dil / 2;
  const int row0 = blockIdx.x * kRowsB, row1 = min(row0 + kRowsB, k);
  const size_t base = static_cast<size_t>(item) * k * ch;
  const size_t p = static_cast<size_t>(item) * gridDim.x + blockIdx.x;
  float s = 0.f, sq = 0.f;
  for (int c = threadIdx.x; c < ch; c += kThreads) {
    const float av = __fmul_rn(g1[c], s1);
    const float bv = __fsub_rn(b1[c], __fmul_rn(mu1, av));
    float dw[kMaxTaps];
    for (int t = 0; t < taps; ++t) dw[t] = 0.f;
    float col_g = 0.f, col_b = 0.f;
    for (int r = row0; r < row1; ++r) {
      const float ddr = __bfloat162float(dd[base + static_cast<size_t>(r) * ch + c]);
      float dn1 = 0.f;
      for (int t = 0; t < taps; ++t) {
        const int rel = t * dil - pad;
        const int src = r - rel;  // conv transpose: dd is zero outside [0, K)
        if (src >= 0 && src < k)
          dn1 = __fadd_rn(dn1, __fmul_rn(wdw[t * ch + c],
                                         __bfloat162float(dd[base + static_cast<size_t>(src) * ch + c])));
        const int u = r + rel;  // the normalised input the tap read, zero-padded
        const float n1 = (u >= 0 && u < k)
                             ? __fadd_rn(__fmul_rn(av, __bfloat162float(t1[base + static_cast<size_t>(u) * ch + c])), bv)
                             : 0.f;
        dw[t] = __fadd_rn(dw[t], __fmul_rn(ddr, n1));
      }
      const float xh = __fmul_rn(__fsub_rn(__bfloat162float(t1[base + static_cast<size_t>(r) * ch + c]), mu1), s1);
      col_g = __fadd_rn(col_g, __fmul_rn(dn1, xh));
      col_b = __fadd_rn(col_b, dn1);
      const float dx = __fmul_rn(dn1, g1[c]);
      dxh1[base + static_cast<size_t>(r) * ch + c] = __float2bfloat16(dx);
      s = __fadd_rn(s, dx);
      sq = __fadd_rn(sq, __fmul_rn(dx, xh));
    }
    for (int t = 0; t < taps; ++t) wpart[(p * taps + t) * ch + c] = dw[t];
    vpart[(p * kVecRows + 1) * vdim + c] = col_g;
    vpart[(p * kVecRows + 2) * vdim + c] = col_b;
  }
  block_sum2(s, sq, red);
  if (threadIdx.x == 0) part1[p] = make_float2(s, sq);
}

// P6. grid (ceil(K / kBM), ceil(ch / kBN), B). h [B, K, cb], we [cb, ch], t1
// and dxh1 [B, K, ch] bf16; the item's part1 sums; writes dt1p [B, K, ch] bf16
// and rows 0 and 8 of vpart (per tile, at the tile's row index).
__global__ void __launch_bounds__(kThreads)
expand_bwd(const bf16* __restrict__ h, const bf16* __restrict__ we, const bf16* __restrict__ t1,
           const bf16* __restrict__ dxh1, const float* __restrict__ vec,
           const float* __restrict__ st, const float2* __restrict__ part1, int n_part1,
           bf16* __restrict__ dt1p, float* __restrict__ vpart, int k, int cb, int ch, int vdim,
           float inv_n) {
  __shared__ __align__(128) unsigned char smem[kGemmBytes];
  __shared__ float red[2][kWarps];
  __shared__ float sums[2];
  __shared__ float colred[kThreads];
  const int item = blockIdx.z;
  item_sum2(part1 + static_cast<size_t>(item) * n_part1, n_part1, red, sums);
  const float ma = __fmul_rn(sums[0], inv_n), mb = __fmul_rn(sums[1], inv_n);
  const float mu1 = st[item * 4 + 0], s1 = st[item * 4 + 1];
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const float* tile = gemm_tile<false, false>(h + static_cast<size_t>(item) * k * cb, cb, we, ch,
                                              k, ch, 0, cb, row0, col0, smem);
  const float* be = vec;
  const float* a1 = vec + 8 * vdim;
  const size_t base = static_cast<size_t>(item) * k * ch;
  float col_a = 0.f, col_b = 0.f;
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= k || gc >= ch) continue;
    const size_t at = base + static_cast<size_t>(gr) * ch + gc;
    const float y = __fadd_rn(tile[r * kLdC + c], be[gc]);
    const float xh = __fmul_rn(__fsub_rn(__bfloat162float(t1[at]), mu1), s1);
    const float dx = __bfloat162float(dxh1[at]);
    const float dt1 = __fmul_rn(s1, __fsub_rn(__fsub_rn(dx, ma), __fmul_rn(xh, mb)));
    const float g = y >= 0.f ? dt1 : __fmul_rn(a1[gc], dt1);
    col_a = __fadd_rn(col_a, __fmul_rn(dt1, fminf(y, 0.f)));
    col_b = __fadd_rn(col_b, g);
    dt1p[at] = __float2bfloat16(g);
  }
  float* dst = vpart + (static_cast<size_t>(item) * gridDim.x + blockIdx.x) * kVecRows * vdim;
  store_col_sums(col_a, dst + 8 * vdim, col0, ch, colred);
  store_col_sums(col_b, dst + 0 * vdim, col0, ch, colred);
}

// dh [B, K, cb] fp32 += dt1p @ We^T. grid (ceil(K / kBM), ceil(cb / kBN), B).
__global__ void __launch_bounds__(kThreads)
dh_update(const bf16* __restrict__ dt1p, const bf16* __restrict__ we, float* __restrict__ dh,
          int k, int cb, int ch) {
  __shared__ __align__(128) unsigned char smem[kGemmBytes];
  const int item = blockIdx.z;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const float* tile = gemm_tile<false, true>(dt1p + static_cast<size_t>(item) * k * ch, ch, we, ch,
                                             k, cb, 0, ch, row0, col0, smem);
  float* out = dh + static_cast<size_t>(item) * k * cb;
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= k || gc >= cb) continue;
    float* at = out + static_cast<size_t>(gr) * cb + gc;
    *at = __fadd_rn(*at, tile[r * kLdC + c]);
  }
}

int sum_into(const float* part, int n_parts, int len, float* out, cudaStream_t s) {
  const int blocks = min((len + kThreads - 1) / kThreads, 1024);
  sum_parts<<<blocks, kThreads, 0, s>>>(part, n_parts, len, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The trunk's backward. hb [N, B, K, cb] bf16 and st [N, B, 4] fp32: the
// training forward's residuals (sst_tcn_trunk_train); dskip [B, K, cb] fp32;
// we [N, cb, ch] and wcat [N, ch, 2 cb] bf16, wdw [N, taps, ch] and vecs [N,
// 10, vdim] fp32 (stack_canonical); dils a host array of N dilations. Outputs
// (fp32, each overwritten): dh [B, K, cb] (dh0), dwe, dwdw, dwcat and dvec of
// the canonical arrays' shapes. Scratch, carved in this order: bf16 —
// drs [B K 2cb], t1, d, n2 (later dt1p), dxh2 (later dxh1), dd [B K ch] each;
// fp32 — part2 [B tiles ceil(ch/128)] and part1 [B tiles] float2, vpart [B
// tiles, 10, vdim], wpart [B tiles, taps, ch], chunks [ceil(B K / 1024), max(ch
// 2cb, cb ch)], with tiles = ceil(K / 64). cb, ch multiples of 8, taps <= 8.
// Returns the first non-zero CUDA error of the launches, or 0.
extern "C" int sst_tcn_trunk_backward(const void* hb, const void* st, const void* dskip, void* dh,
                                      const void* we, const void* wdw, const void* wcat,
                                      const void* vecs, const int* dils, void* dwe, void* dwdw,
                                      void* dwcat, void* dvec, void* scratch16, void* scratch32,
                                      int batch, int k, int cb, int ch, int vdim, int taps,
                                      int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (k + kBM - 1) / kBM;
  const int ch_tiles = (ch + kBN - 1) / kBN;
  const int frames = batch * k;
  const int chunks = (frames + kSplit - 1) / kSplit;
  const size_t bkc = static_cast<size_t>(frames) * ch;
  bf16* drs = static_cast<bf16*>(scratch16);
  bf16* t1 = drs + static_cast<size_t>(frames) * 2 * cb;
  bf16* d = t1 + bkc;
  bf16* n2 = d + bkc;
  bf16* dxh2 = n2 + bkc;
  bf16* dd = dxh2 + bkc;
  bf16* dt1p = n2;    // n2 is dead once dWcat is summed
  bf16* dxh1 = dxh2;  // dxh2 is dead once dd is written
  float2* part2 = static_cast<float2*>(scratch32);
  float2* part1 = part2 + static_cast<size_t>(batch) * tiles * ch_tiles;
  float* vpart = reinterpret_cast<float*>(part1 + static_cast<size_t>(batch) * tiles);
  float* wpart = vpart + static_cast<size_t>(batch) * tiles * kVecRows * vdim;
  float* chunk = wpart + static_cast<size_t>(batch) * tiles * taps * ch;
  const float inv_n = static_cast<float>(1.0 / (static_cast<double>(k) * ch));

  const dim3 grid_rows(tiles, 1, batch);
  const dim3 grid_ch(tiles, ch_tiles, batch);
  const dim3 grid_cb(tiles, (cb + kBN - 1) / kBN, batch);
  const dim3 grid_wcat((ch + kBM - 1) / kBM, (2 * cb + kBN - 1) / kBN, chunks);
  const dim3 grid_we((cb + kBM - 1) / kBM, ch_tiles, chunks);
  const int n_vpart = batch * tiles;

  cudaError_t err = cudaMemsetAsync(dh, 0, static_cast<size_t>(frames) * cb * sizeof(float), s);
  if (err == cudaSuccess)  // lanes no phase writes (row 7, past ch or 2 cb) stay zero
    err = cudaMemsetAsync(vpart, 0, static_cast<size_t>(n_vpart) * kVecRows * vdim * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dhf = static_cast<float*>(dh);
  for (int j = n_blocks - 1; j >= 0; --j) {
    const bf16* h_j = static_cast<const bf16*>(hb) + static_cast<size_t>(j) * frames * cb;
    const float* st_j = static_cast<const float*>(st) + static_cast<size_t>(j) * batch * 4;
    const bf16* we_j = static_cast<const bf16*>(we) + static_cast<size_t>(j) * cb * ch;
    const bf16* wcat_j = static_cast<const bf16*>(wcat) + static_cast<size_t>(j) * ch * 2 * cb;
    const float* wdw_j = static_cast<const float*>(wdw) + static_cast<size_t>(j) * taps * ch;
    const float* vec_j = static_cast<const float*>(vecs) + static_cast<size_t>(j) * kVecRows * vdim;
    float* dwe_j = static_cast<float*>(dwe) + static_cast<size_t>(j) * cb * ch;
    float* dwdw_j = static_cast<float*>(dwdw) + static_cast<size_t>(j) * taps * ch;
    float* dwcat_j = static_cast<float*>(dwcat) + static_cast<size_t>(j) * ch * 2 * cb;
    float* dvec_j = static_cast<float*>(dvec) + static_cast<size_t>(j) * kVecRows * vdim;

    pack_drs<<<grid_rows, kThreads, 0, s>>>(dhf, static_cast<const float*>(dskip), drs, vpart, k,
                                            cb, vdim);
    recompute_t1<<<grid_ch, kThreads, 0, s>>>(h_j, we_j, vec_j, t1, k, cb, ch, vdim);
    recompute_d<<<grid_rows, kThreads, 0, s>>>(t1, wdw_j, vec_j, st_j, d, k, ch, vdim, taps,
                                               dils[j]);
    project_bwd<<<grid_ch, kThreads, 0, s>>>(drs, wcat_j, d, vec_j, st_j, n2, dxh2, vpart, part2,
                                             k, cb, ch, vdim);
    wgrad<<<grid_wcat, kThreads, 0, s>>>(n2, drs, chunk, frames, ch, 2 * cb);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (int e = sum_into(chunk, chunks, ch * 2 * cb, dwcat_j, s)) return e;
    dd_bwd<<<grid_rows, kThreads, 0, s>>>(d, dxh2, vec_j, st_j, part2, tiles * ch_tiles, dd, vpart,
                                          k, ch, vdim, inv_n);
    dwconv_bwd<<<grid_rows, kThreads, 0, s>>>(dd, t1, wdw_j, vec_j, st_j, dxh1, vpart, wpart,
                                              part1, k, ch, vdim, taps, dils[j]);
    expand_bwd<<<grid_ch, kThreads, 0, s>>>(h_j, we_j, t1, dxh1, vec_j, st_j, part1, tiles, dt1p,
                                            vpart, k, cb, ch, vdim, inv_n);
    wgrad<<<grid_we, kThreads, 0, s>>>(h_j, dt1p, chunk, frames, cb, ch);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (int e = sum_into(chunk, chunks, cb * ch, dwe_j, s)) return e;
    dh_update<<<grid_cb, kThreads, 0, s>>>(dt1p, we_j, dhf, k, cb, ch);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (int e = sum_into(vpart, n_vpart, kVecRows * vdim, dvec_j, s)) return e;
    if (int e = sum_into(wpart, n_vpart, taps * ch, dwdw_j, s)) return e;
  }
  return static_cast<int>(cudaSuccess);
}
