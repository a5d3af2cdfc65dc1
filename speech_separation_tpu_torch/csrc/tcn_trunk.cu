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
// batch, 2.1 ms at 989 TFLOP/s; the compulsory bytes (h0 in, skip out, the
// weights) take 0.02 ms. So the products bound it. What the earlier design
// (three launches a block, 63 a call) lost beside them was the traffic of the
// intermediates: t1 and t2 (4.1 MB each per item and block) went through
// device memory, 35 GB per batch. This design takes 21.8 ms there on an H100
// SXM at 700 W (PERF.md): the products take about a third of it; (B)'s taps
// and the epilogues, about 15 instructions an element at 8 warps an SM (the
// products' 128 accumulators a thread leave room for one CTA of 256
// threads), take most of the rest, and leaving their loads or stores out
// barely moves them (scripts/torch_probe_tcn.py).
//
// What the design does about it. The TPU kernel runs one item per grid step
// with all 21 blocks on chip; here one cooperative launch per call runs the
// whole trunk, with the TPU kernel's schedule fitted to the card
// (ops/tcn_cuda.py::trunk_plan picks the numbers from the card's SM count,
// shared memory and L2 size):
// - Items are owned by groups of CTAs, one CTA an SM. `groups` items are in
//   flight, each owned by a group of `ctas` CTAs that walks all the blocks of
//   its item, then takes the item `groups` further on. gLN statistics are per
//   item, so items are independent and every barrier is within one group: a
//   monotone arrival counter per group in device memory (release on arrival,
//   acquire on the wait, as in lstm_recurrence.cu), which traps if it never
//   fills. A CTA owns the 128-row tiles rank, rank + ctas, ... of its item in
//   every phase, so h and skip rows are only ever touched by their owner.
// - The group's scratch (t1, t2: [K, ch] bf16 each) and its item's h and skip
//   are sized so that `groups` items fit in an L2 budget below the 50 MB: t1
//   and t2 live in L2 between phases; device memory carries h0 in and skip out.
// - (A) and (C) run on the wgmma engine of tcn_common.cuh: per tile and pass
//   of 256 columns, a cp.async ring of 64-deep stages of the activation rows
//   and the transposed weights (We^T [ch, cb], Wg^T [2cb, ch], so both
//   operands are K-major) feeds two warpgroups' m64n256k16 products, whose
//   fp32 accumulators the epilogues read from registers: (A) adds the bias,
//   applies PReLU, stores t1 and sums (t1, t1^2); (C) applies the folded gLN2
//   and updates h and skip in place (skip is written, not added, in block 0,
//   and block 0 reads h0 and writes the carry, so nothing is zeroed or copied
//   ahead of the launch).
// - (B) is vectorised: per 64-channel slice of a tile, the tile's rows and
//   the taps' halo ((taps - 1) d rows) are staged in shared memory with
//   16-byte cp.async copies (the next slice's in flight while this one is
//   computed), and each thread takes 8 channels of 4 rows, with the folded
//   coefficients A1 w_t, B1 w_t, B1 sum w + b_dw in registers once per slice,
//   and one 16-byte store of t2 per row.
// - A block's per-column vectors and depthwise weights are copied into shared
//   memory once at its start; the epilogues stage their tile in the product's
//   ring and write 16-byte chunks of t1, h and skip, and (C) fetches the old
//   h and skip it adds to while it waits for its statistics.
// - Three barriers' worth of waiting become two a block: (B) needs every
//   CTA's t1 and statistics (barrier 1); (C)'s product needs only this CTA's
//   own t2 rows, so it runs before the wait for barrier 2, whose statistics
//   only the epilogue needs.
// Partial sums are combined in a fixed order (each thread's elements in
// order, warp butterflies, warps in order, then the group's CTAs in rank
// order, every CTA of a group summing the same partials the same way), never
// with float atomics, so two runs on one card agree bit for bit. Ragged
// frames, channels and depths are masked or read as zero.
//
// Training mode (template flag kTrain). It computes the same trunk bit for bit
// and also stores what the backward (tcn_train_backward.cu) recomputes from:
// each block's input h (bf16, [N, B, K, cb], each CTA copying its own rows
// ahead of (A), so a block's h is one [B K, cb] matrix for the weight-gradient
// products) and the four per-item statistics (mu1, st1, mu2, st2) of each
// block ([N, B, 4] fp32, written by the group's first CTA).
//
// With a non-null `timing` ([grid, kLaps] int64), thread 0 of each CTA adds up
// the %globaltimer nanoseconds it spent in each part of a block (Lap).

#include "tcn_common.cuh"

namespace {

using namespace tcn;

// SST_TRUNK_SKIP (tcn_common.cuh; probe builds only, scripts/torch_probe_tcn.py):
// a bit mask of work left out to see what each part costs. 1: t1's stores; 2:
// t2's stores; 4: h's and skip's stores; 8: (B)'s staging copies; 16: the
// products. The port builds with 0.

// The parts of a block that `timing` adds up (python: TRUNK_LAPS).
enum Lap {
  kLapCoefs,      // (A): the block's vectors into smem (and, training, the saved h)
  kLapExpand,     // (A): the products
  kLapExpandOut,  // (A): the epilogue, t1 out, the partial sums, the arrival
  kLapStats1,     // (B): the item's statistics of t1
  kLapDepthwise,  // (B): the taps, t2 out, the partial sums, the arrival
  kLapProject,    // (C): the products
  kLapProjectOut, // (C): the item's statistics of t2, the epilogue, h and skip out
  kLapWait,       // waiting at the group's barriers
  kLaps
};

struct TrunkParams {
  const bf16* h0;     // [B, K, cb] the trunk's input
  bf16* h;            // [B, K, cb] the carry
  bf16* skip;         // [B, K, cb] the skip sum
  bf16* t1;           // [groups, K, ch] scratch
  bf16* t2;           // [groups, K, ch] scratch
  float2* part;       // [groups, 2, ctas] (sum, sum of squares) per CTA
  int* counters;      // [groups] zero at the launch
  const bf16* we_t;   // [N, ch, cb]
  const float* wdw;   // [N, taps, ch]
  const bf16* wg_t;   // [N, 2 cb, ch]
  const float* vecs;  // [N, 8, vdim]
  long long* timing;  // [grid, kLaps] or null
  bf16* hb;           // kTrain: [N, B, K, cb]
  float* st;          // kTrain: [N, B, 4]
  int batch, k, cb, ch, vdim, taps, n_blocks, groups, ctas;
  int staging;  // bytes of smem before the block's Coefs: the ring or (B)'s buffers
  int dils[kMaxBlocks];
};

// One item's gLN statistics from the group's n partials (written by other
// CTAs, so read through L2), in rank order: out[0] = mean, out[1] = 1 /
// sqrt(max(E[x^2] - mean^2, 0) + 1e-8). Every CTA computes the same values.
__device__ void group_stats(const float2* part, int n, float inv_n, float (*red)[kWarps],
                            float* out) {
  float s = 0.f, sq = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float2 v = __ldcg(part + i);
    s = __fadd_rn(s, v.x);
    sq = __fadd_rn(sq, v.y);
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

// A thread's partial sums of x and x^2 over its values, one pair of running
// sums per position in its 8-value chunks (8 independent chains, not one),
// folded in position order at the end: a fixed order, so reruns agree.
struct Lanes {
  float s[8], sq[8];
};

__device__ __forceinline__ void lanes_zero(Lanes& l) {
#pragma unroll
  for (int e = 0; e < 8; ++e) l.s[e] = l.sq[e] = 0.f;
}

__device__ __forceinline__ void lanes_add(Lanes& l, const float (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    l.s[e] = __fadd_rn(l.s[e], v[e]);
    l.sq[e] = __fadd_rn(l.sq[e], __fmul_rn(v[e], v[e]));
  }
}

__device__ __forceinline__ void lanes_fold(const Lanes& l, float& s, float& sq) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    s = __fadd_rn(s, l.s[e]);
    sq = __fadd_rn(sq, l.sq[e]);
  }
}

// A block's per-column vectors in shared memory, loaded once at the block's
// start (python: trunk_smem_bytes): (A) b_e, a1 [ch]; (B) g1, be1, b_dw, a2
// [ch] and wdw [taps, ch]; (C) biasc, csum [2 cb].
struct Coefs {
  float *b_e, *a1, *g1, *be1, *b_dw, *a2, *wdw, *biasc, *csum;
};

__device__ __forceinline__ Coefs carve_coefs(float* base, int ch, int cb, int taps) {
  Coefs c;
  c.b_e = base;
  c.a1 = c.b_e + ch;
  c.g1 = c.a1 + ch;
  c.be1 = c.g1 + ch;
  c.b_dw = c.be1 + ch;
  c.a2 = c.b_dw + ch;
  c.wdw = c.a2 + ch;
  c.biasc = c.wdw + taps * ch;
  c.csum = c.biasc + 2 * cb;
  return c;
}

__device__ void load_coefs(const Coefs& c, const float* __restrict__ vec,
                           const float* __restrict__ wdw, int vdim, int ch, int cb, int taps) {
  for (int i = threadIdx.x; i < ch; i += kThreads) {
    c.b_e[i] = vec[i];
    c.g1[i] = vec[vdim + i];
    c.be1[i] = vec[2 * vdim + i];
    c.b_dw[i] = vec[3 * vdim + i];
    c.a1[i] = vec[6 * vdim + i];
    c.a2[i] = vec[7 * vdim + i];
  }
  for (int i = threadIdx.x; i < taps * ch; i += kThreads) c.wdw[i] = wdw[i];
  for (int i = threadIdx.x; i < 2 * cb; i += kThreads) {
    c.biasc[i] = vec[4 * vdim + i];
    c.csum[i] = vec[5 * vdim + i];
  }
}

// The epilogues first store the accumulators, raw, into the engine's ring
// (free after the product; compact code: one 8-byte store per accumulator
// pair at an immediate offset), then walk the tile in 16-byte chunks of
// output (8 columns of a row) in a rolled loop, neighbouring threads on
// neighbouring chunks: coalesced stores, and little code for the SM's
// instruction cache to hold. Pitches in floats.
constexpr int kAccPitch = kEngCols + 8;           // (A): the whole tile, rows 1,056 bytes apart
constexpr int kHalfCols = kEngCols / 2;           // (C) takes the tile in two halves
constexpr int kHalfPitch = kHalfCols + 4;         // rows 528 bytes apart
constexpr int kOldOffset = kEngRows * kHalfPitch * 4;  // (C)'s old h and skip after its half
constexpr int kOldHalf = kEngRows * kHalfCols * 2;     // bytes: one half's old values, bf16
static_assert(kEngRows * kAccPitch * 4 <= kEngRingBytes, "the staged (A) tile fits the ring");
static_assert(kOldOffset + 2 * kOldHalf <= kEngRingBytes, "the staged (C) half fits the ring");

// The accumulator columns [c0, c0 + kCols) of this thread, raw, into tile
// (fp32, pitch floats a row; the tile's column 0 is accumulator column c0).
template <int kCols>
__device__ __forceinline__ void store_acc(const float (&acc)[kEngAcc], float* tile, int pitch,
                                          int c0) {
  float* base = tile + acc_row(0) * pitch + acc_col(0) - c0;
#pragma unroll
  for (int i = 0; i < kEngAcc; i += 2) {
    const int col = (i >> 2) * 8;
    if (col >= c0 && col < c0 + kCols)
      *reinterpret_cast<float2*>(base + ((i >> 1) & 1) * 8 * pitch + col) =
          make_float2(acc[i], acc[i + 1]);
  }
}

// (A)'s epilogue: v = prelu(acc + b_e) for the tile at (row0, col0), the fp32
// values' sums into s, sq (each thread's chunks in order), t1 = bf16(v).
__device__ __forceinline__ void expand_epilogue(const float (&acc)[kEngAcc], const Coefs& cf,
                                                bf16* __restrict__ t1, int k, int ch, int row0,
                                                int col0, float& s, float& sq,
                                                unsigned char* stage) {
  float* tile = reinterpret_cast<float*>(stage);
  store_acc<kEngCols>(acc, tile, kAccPitch, 0);
  __syncthreads();
  // thread i takes column chunk i % 32 of every 8th row from row i / 32, with
  // its chunk's coefficients loaded once
  const int runs = min(kEngCols, ch - col0) / 8;  // 16-byte chunks of t1 a row
  const int rows = min(kEngRows, k - row0);
  const int q = threadIdx.x % 32, c = col0 + q * 8;
  Lanes lanes;
  lanes_zero(lanes);
  if (q < runs) {
    float b[8], a[8];
    load8(cf.b_e + c, b);
    load8(cf.a1 + c, a);
#pragma unroll 2
    for (int r = threadIdx.x / 32; r < rows; r += kThreads / 32) {
      float x[8], v[8];
      load8(tile + r * kAccPitch + q * 8, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = prelu(__fadd_rn(x[e], b[e]), a[e]);
      lanes_add(lanes, v);
      uint4 out;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      if (!(SST_TRUNK_SKIP & 1))
        *reinterpret_cast<uint4*>(t1 + static_cast<size_t>(row0 + r) * ch + c) = out;
    }
  }
  lanes_fold(lanes, s, sq);
  __syncthreads();  // the ring is free again
}

// (C), first part, right after the product: this tile pass's old h and skip
// values (block 0: h0's, and zeros for skip) start on their way into the
// ring behind the staged half, to land while the group's barrier is awaited.
__device__ __forceinline__ void fetch_old(const bf16* hin, const bf16* skip, bool first, int k,
                                          int cb, int row0, int col0, unsigned char* stage) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c_lo = col0 + half * kHalfCols;
    const int runs = max(0, min(kHalfCols, 2 * cb - c_lo)) / 8;
    const int n = min(kEngRows, k - row0) * runs;
    unsigned char* dst = stage + kOldOffset + half * kOldHalf;
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const int r = idx / runs, q = idx - r * runs;
      const int c = c_lo + q * 8;
      const size_t row = static_cast<size_t>(row0 + r) * cb;
      const bool ok = c < cb || !first;
      cp_async16(dst + (r * kHalfCols + q * 8) * 2, c < cb ? hin + row + c : skip + row + (c - cb),
                 ok);
    }
  }
  cp_async_commit();
}

// (C)'s epilogue: rs = acc st2 + biasc - ms csum for the tile at (row0, col0)
// of the 2 cb columns, h = bf16(old h + rs[:cb]), skip = bf16(old skip +
// rs[cb:]), a half tile at a time.
__device__ __forceinline__ void project_epilogue(const float (&acc)[kEngAcc], const Coefs& cf,
                                                 bf16* h, bf16* skip, int k, int cb, int row0,
                                                 int col0, float st2, float ms,
                                                 unsigned char* stage) {
  float* tile = reinterpret_cast<float*>(stage);
  cp_async_wait<0>();  // this thread's old values have landed
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    store_acc<kHalfCols>(acc, tile, kHalfPitch, half * kHalfCols);
    __syncthreads();  // the half and everyone's old values are in
    // thread i takes column chunk i % 16 of every 16th row from row i / 16,
    // with its chunk's bias folded once
    const int c_lo = col0 + half * kHalfCols;
    const int runs = max(0, min(kHalfCols, 2 * cb - c_lo)) / 8;
    const int rows = min(kEngRows, k - row0);
    const int q = threadIdx.x % 16, c = c_lo + q * 8;
    const bf16* old = reinterpret_cast<const bf16*>(stage + kOldOffset + half * kOldHalf);
    if (q < runs) {
      float bc[8], cs[8], bias2[8];
      load8(cf.biasc + c, bc);
      load8(cf.csum + c, cs);
#pragma unroll
      for (int e = 0; e < 8; ++e) bias2[e] = __fsub_rn(bc[e], __fmul_rn(ms, cs[e]));
      bf16* dst0 = c < cb ? h + c : skip + (c - cb);
#pragma unroll 2
      for (int r = threadIdx.x / 16; r < rows; r += kThreads / 16) {
        float x[8];
        load8(tile + r * kHalfPitch + q * 8, x);
        const uint4 o4 = *reinterpret_cast<const uint4*>(old + r * kHalfCols + q * 8);
        const __nv_bfloat162* o = reinterpret_cast<const __nv_bfloat162*>(&o4);
        uint4 out;
        __nv_bfloat162* w = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const float rs0 = __fadd_rn(__fmul_rn(x[e], st2), bias2[e]);
          const float rs1 = __fadd_rn(__fmul_rn(x[e + 1], st2), bias2[e + 1]);
          w[e / 2] = __floats2bfloat162_rn(__fadd_rn(__low2float(o[e / 2]), rs0),
                                           __fadd_rn(__high2float(o[e / 2]), rs1));
        }
        if (!(SST_TRUNK_SKIP & 4))
          *reinterpret_cast<uint4*>(dst0 + static_cast<size_t>(row0 + r) * cb) = out;
      }
    }
    __syncthreads();  // the half's staging may be reused
  }
}

// (B) over this CTA's tiles: t2 = bf16(prelu(pre)) and the fp32 values' sums
// into s, sq. Per unit (tile, 64-channel slice) the rows [row0 - pad, row0 +
// 128 + (taps - 1) d - pad) of t1 are staged in one of two buffers of smem
// (row-major, 128 bytes a row; rows outside [0, K) and channels past ch read
// zero), the next unit's copies in flight while one is computed.
// Thread (row lane tid / 8, channel group tid % 8) takes 8 channels of rows
// lane, lane + 32, lane + 64, lane + 96, with their folded coefficients in
// registers. kT >= taps bounds the coefficient arrays.
template <int kT>
__device__ __forceinline__ void depthwise(const TrunkParams& p, const Coefs& cf, int dil, const bf16* t1,
                          bf16* __restrict__ t2, int rank, float mu1, float st1, float& s,
                          float& sq, unsigned char* smem, int buf_bytes) {
  const int k = p.k, ch = p.ch, taps = p.taps;
  const int tiles = (k + kEngRows - 1) / kEngRows;
  const int pad = (taps - 1) * dil / 2;
  const int span = kEngRows + (taps - 1) * dil;
  const int slices = (ch + kSliceCh - 1) / kSliceCh;
  const int units = (tiles - rank + p.ctas - 1) / p.ctas * slices;
  const int cg = threadIdx.x % 8, lane_row = threadIdx.x / 8;
  Lanes lanes;
  lanes_zero(lanes);

  auto stage = [&](int u) {
    if (u >= units) return;
    const int r0 = (rank + (u / slices) * p.ctas) * kEngRows - pad;
    const int c0 = (u % slices) * kSliceCh;
    unsigned char* buf = smem + (u & 1) * buf_bytes;
    for (int c = threadIdx.x; c < span * 8; c += kThreads) {
      const int r = r0 + (c >> 3), cc = c0 + (c & 7) * 8;
      const bool ok = r >= 0 && r < k && cc < ch;
      if (!(SST_TRUNK_SKIP & 8))
        cp_async16(buf + c * 16, ok ? t1 + static_cast<size_t>(r) * ch + cc : t1, ok);
    }
  };

  stage(0);
  cp_async_commit();
  for (int u = 0; u < units; ++u) {
    stage(u + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of unit u have landed
    __syncthreads();             // everyone's have
    const int tile = rank + (u / slices) * p.ctas;
    const int c = (u % slices) * kSliceCh + cg * 8;  // this thread's first channel
    const unsigned char* buf = smem + (u & 1) * buf_bytes;
    if (c < ch) {
      float aw[kT][8], bw[kT][8], beff[8], a2[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float av = __fmul_rn(cf.g1[c + q], st1);
        const float bv = __fsub_rn(cf.be1[c + q], __fmul_rn(mu1, av));
        float wsum = 0.f;
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          const float w = t < taps ? cf.wdw[t * ch + c + q] : 0.f;
          if (t < taps) wsum = __fadd_rn(wsum, w);
          aw[t][q] = __fmul_rn(av, w);
          bw[t][q] = __fmul_rn(bv, w);
        }
        beff[q] = __fadd_rn(__fmul_rn(bv, wsum), cf.b_dw[c + q]);
        a2[q] = cf.a2[c + q];
      }
      const int rows = min(kEngRows, k - tile * kEngRows);
#pragma unroll 2
      for (int r = lane_row; r < rows; r += kThreads / 8) {
        const int gr = tile * kEngRows + r;
        float pre[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) pre[q] = beff[q];
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          if (t >= taps) break;
          const uint4 raw = *reinterpret_cast<const uint4*>(buf + ((r + t * dil) * 8 + cg) * 16);
          const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            pre[2 * q] = __fadd_rn(pre[2 * q], __fmul_rn(aw[t][2 * q], __low2float(x[q])));
            pre[2 * q + 1] = __fadd_rn(pre[2 * q + 1], __fmul_rn(aw[t][2 * q + 1], __high2float(x[q])));
          }
        }
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          if (t >= taps) break;
          const int off = t * dil - pad;
          if (off != 0 && (gr + off < 0 || gr + off >= k)) {
#pragma unroll
            for (int q = 0; q < 8; ++q) pre[q] = __fsub_rn(pre[q], bw[t][q]);
          }
        }
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = prelu(pre[q], a2[q]);
        lanes_add(lanes, v);
        uint4 out;
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
        for (int q = 0; q < 4; ++q) o[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
        if (!(SST_TRUNK_SKIP & 2))
          *reinterpret_cast<uint4*>(t2 + static_cast<size_t>(gr) * ch + c) = out;
      }
    }
    __syncthreads();  // the buffer may be staged again
  }
  cp_async_wait<0>();
  lanes_fold(lanes, s, sq);
}

// The whole trunk, grid groups x ctas, one CTA an SM (a cooperative launch).
template <bool kTrain, int kT>
__global__ void __launch_bounds__(kThreads, 1) trunk_kernel(const __grid_constant__ TrunkParams p) {
  extern __shared__ unsigned char smem_raw[];
  // staging (1,024-byte aligned for the swizzled stages), then the block's Coefs
  unsigned char* smem =
      smem_raw + ((1024u - (static_cast<unsigned>(__cvta_generic_to_shared(smem_raw)) & 1023u)) & 1023u);
  __shared__ float red[2][kWarps];
  __shared__ float stats[2];
  const int g = blockIdx.x / p.ctas, rank = blockIdx.x % p.ctas;
  const int k = p.k, cb = p.cb, ch = p.ch, vdim = p.vdim;
  const int tiles = (k + kEngRows - 1) / kEngRows;
  const float inv_n = static_cast<float>(1.0 / (static_cast<double>(k) * ch));
  int* counter = p.counters + g;
  bf16* t1 = p.t1 + static_cast<size_t>(g) * k * ch;
  bf16* t2 = p.t2 + static_cast<size_t>(g) * k * ch;
  float2* part1 = p.part + static_cast<size_t>(g) * 2 * p.ctas;
  float2* part2 = part1 + p.ctas;
  const bool timed = p.timing != nullptr;
  long long spent[kLaps] = {};
  long long mark = 0;
  auto lap = [&](int slot) {
    if (timed && threadIdx.x == 0) {
      const long long t = now_ns();
      spent[slot] += t - mark;
      mark = t;
    }
  };
  int arrivals = 0;  // this group's barriers so far
  float acc[kEngAcc];
  const Coefs cf = carve_coefs(reinterpret_cast<float*>(smem + p.staging), ch, cb, p.taps);

  for (int item = g; item < p.batch; item += p.groups) {
    const size_t hoff = static_cast<size_t>(item) * k * cb;
    bf16* h = p.h + hoff;
    bf16* skip = p.skip + hoff;
    for (int j = 0; j < p.n_blocks; ++j) {
      const bf16* hin = j == 0 ? p.h0 + hoff : h;
      const bf16* we_t = p.we_t + static_cast<size_t>(j) * ch * cb;
      const bf16* wg_t = p.wg_t + static_cast<size_t>(j) * 2 * cb * ch;
      if (timed && threadIdx.x == 0) mark = now_ns();
      // the previous block's (C) is done with the coefficients (the barrier
      // at its end); the engine's first barrier publishes these
      load_coefs(cf, p.vecs + static_cast<size_t>(j) * 8 * vdim,
                 p.wdw + static_cast<size_t>(j) * p.taps * ch, vdim, ch, cb, p.taps);

      // (A)
      if constexpr (kTrain) {
        bf16* hb = p.hb + (static_cast<size_t>(j) * p.batch + item) * k * cb;
        for (int tile = rank; tile < tiles; tile += p.ctas) {
          const int row0 = tile * kEngRows;
          const int n16 = (min(row0 + kEngRows, k) - row0) * cb / 8;
          const uint4* src = reinterpret_cast<const uint4*>(hin + static_cast<size_t>(row0) * cb);
          uint4* dst = reinterpret_cast<uint4*>(hb + static_cast<size_t>(row0) * cb);
          for (int i = threadIdx.x; i < n16; i += kThreads) dst[i] = src[i];
        }
      }
      lap(kLapCoefs);
      // (A), then (B), then (C). (A) and (C) share one call of the engine,
      // so its code appears once in the kernel.
      float s = 0.f, sq = 0.f;
      bool waited = false;
      float st2 = 0.f, ms = 0.f;
#pragma unroll 1
      for (int ph = 0; ph < 2; ++ph) {
        if (ph == 1) {
          block_sum2(s, sq, red);
          if (threadIdx.x == 0) part1[rank] = make_float2(s, sq);
          group_arrive(counter);
          lap(kLapExpandOut);
          group_wait(counter, ++arrivals * p.ctas);
          lap(kLapWait);
          group_stats(part1, p.ctas, inv_n, red, stats);
          const float mu1 = stats[0], st1 = stats[1];
          if constexpr (kTrain) {
            if (rank == 0 && threadIdx.x == 0) {
              p.st[(static_cast<size_t>(j) * p.batch + item) * 4 + 0] = mu1;
              p.st[(static_cast<size_t>(j) * p.batch + item) * 4 + 1] = st1;
            }
          }
          lap(kLapStats1);
          // (B)
          s = 0.f;
          sq = 0.f;
          depthwise<kT>(p, cf, p.dils[j], t1, t2, rank, mu1, st1, s, sq, smem,
                        staging_buffer_bytes(p.taps, p.dils[j]));
          block_sum2(s, sq, red);
          if (threadIdx.x == 0) part2[rank] = make_float2(s, sq);
          group_arrive(counter);
          lap(kLapDepthwise);
        }
        // (A): h @ We; (C): t2 @ Wg, which reads only this CTA's own t2 rows,
        // so its first pass runs before the wait for the statistics its
        // epilogue needs
        const bf16* a = ph == 0 ? hin : t2;
        const bf16* bt = ph == 0 ? we_t : wg_t;
        const int depth = ph == 0 ? cb : ch, cols = ph == 0 ? ch : 2 * cb;
        for (int tile = rank; tile < tiles; tile += p.ctas) {
          for (int col0 = 0; col0 < cols; col0 += kEngCols) {
            engine_tile(acc, a, depth, k, tile * kEngRows, bt, depth, cols, col0, depth, smem);
            if (ph == 0) {
              lap(kLapExpand);
              expand_epilogue(acc, cf, t1, k, ch, tile * kEngRows, col0, s, sq, smem);
              lap(kLapExpandOut);
              continue;
            }
            fetch_old(hin, skip, j == 0, k, cb, tile * kEngRows, col0, smem);
            lap(kLapProject);
            if (!waited) {
              group_wait(counter, ++arrivals * p.ctas);
              lap(kLapWait);
              group_stats(part2, p.ctas, inv_n, red, stats);
              st2 = stats[1];
              ms = __fmul_rn(stats[0], st2);
              if constexpr (kTrain) {
                if (rank == 0 && threadIdx.x == 0) {
                  p.st[(static_cast<size_t>(j) * p.batch + item) * 4 + 2] = stats[0];
                  p.st[(static_cast<size_t>(j) * p.batch + item) * 4 + 3] = st2;
                }
              }
              waited = true;
            }
            project_epilogue(acc, cf, h, skip, k, cb, tile * kEngRows, col0, st2, ms, smem);
          }
        }
      }
      __syncthreads();  // h and skip rows are written before the next block reads them
      lap(kLapProjectOut);
    }
  }
  if (timed && threadIdx.x == 0) {
    for (int i = 0; i < kLaps; ++i) p.timing[blockIdx.x * kLaps + i] = spent[i];
  }
}

// The staging area (the product's ring, or two of (B)'s buffers at the
// largest dilation) and, after it, the block's Coefs (python: trunk_smem_bytes).
int staging_bytes(int taps, int max_dil) {
  const int two = 2 * staging_buffer_bytes(taps, max_dil);
  return two > kEngRingBytes ? two : kEngRingBytes;
}

size_t coef_bytes(int cb, int ch, int taps) {
  return static_cast<size_t>((6 + taps) * ch + 4 * cb) * sizeof(float);
}

template <bool kTrain, int kT>
int launch(const TrunkParams& p, size_t smem, cudaStream_t s) {
  auto kernel = trunk_kernel<kTrain, kT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {const_cast<TrunkParams*>(&p)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(p.groups * p.ctas), dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it; the caller raises on the code
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kTrain>
int run_trunk(const void* h0, void* h, void* skip, void* t1, void* t2, void* part, void* counters,
              const void* we_t, const void* wdw, const void* wg_t, const void* vecs,
              const int* dils, void* timing, void* hb, void* st, int batch, int k, int cb, int ch,
              int vdim, int taps, int n_blocks, int groups, int ctas, cudaStream_t s) {
  if (batch < 1 || k < 1 || cb < 8 || ch < 8 || cb % 8 || ch % 8 || taps < 1 ||
      taps > kMaxTaps || n_blocks < 1 || n_blocks > kMaxBlocks || groups < 1 || ctas < 1 ||
      ctas > (k + kEngRows - 1) / kEngRows || vdim < ch || vdim < 2 * cb)
    return static_cast<int>(cudaErrorInvalidValue);
  TrunkParams p{};
  p.h0 = static_cast<const bf16*>(h0);
  p.h = static_cast<bf16*>(h);
  p.skip = static_cast<bf16*>(skip);
  p.t1 = static_cast<bf16*>(t1);
  p.t2 = static_cast<bf16*>(t2);
  p.part = static_cast<float2*>(part);
  p.counters = static_cast<int*>(counters);
  p.we_t = static_cast<const bf16*>(we_t);
  p.wdw = static_cast<const float*>(wdw);
  p.wg_t = static_cast<const bf16*>(wg_t);
  p.vecs = static_cast<const float*>(vecs);
  p.timing = static_cast<long long*>(timing);
  p.hb = static_cast<bf16*>(hb);
  p.st = static_cast<float*>(st);
  p.batch = batch;
  p.k = k;
  p.cb = cb;
  p.ch = ch;
  p.vdim = vdim;
  p.taps = taps;
  p.n_blocks = n_blocks;
  p.groups = groups;
  p.ctas = ctas;
  int max_dil = 1;
  for (int j = 0; j < n_blocks; ++j) {
    if (dils[j] < 1) return static_cast<int>(cudaErrorInvalidValue);
    p.dils[j] = dils[j];
    max_dil = dils[j] > max_dil ? dils[j] : max_dil;
  }
  p.staging = staging_bytes(taps, max_dil);
  const size_t smem = 1024 + p.staging + coef_bytes(cb, ch, taps);  // 1,024 for the alignment
  return taps <= 3 ? launch<kTrain, 3>(p, smem, s) : launch<kTrain, kMaxTaps>(p, smem, s);
}

}  // namespace

// Runs every block of the trunk in one cooperative launch of groups x ctas
// CTAs (ops/tcn_cuda.py::trunk_plan). h0 [B, K, cb] bf16 is read only; h [B,
// K, cb] bf16 receives the carry and skip [B, K, cb] bf16 the skip sum (no
// initial values needed). Scratch: t1 and t2 [groups, K, ch] bf16, part
// [groups, 2, ctas] float2, counters [groups] int32 holding zeros. we_t [N, ch,
// cb] and wg_t [N, 2 cb, ch] bf16 (stack_tcn_weights' we and wg, transposed),
// wdw [N, taps, ch] and vecs [N, 8, vdim] fp32; dils a host array of N <= 256
// dilations; timing null or [groups ctas, 8] int64 (Lap). cb and ch multiples of 8,
// taps <= 8. Returns the launch's CUDA error (a refused cooperative launch
// included), or 0.
extern "C" int sst_tcn_trunk(const void* h0, void* h, void* skip, void* t1, void* t2, void* part,
                             void* counters, const void* we_t, const void* wdw, const void* wg_t,
                             const void* vecs, const int* dils, void* timing, int batch, int k,
                             int cb, int ch, int vdim, int taps, int n_blocks, int groups,
                             int ctas, void* stream) {
  return run_trunk<false>(h0, h, skip, t1, t2, part, counters, we_t, wdw, wg_t, vecs, dils,
                          timing, nullptr, nullptr, batch, k, cb, ch, vdim, taps, n_blocks, groups,
                          ctas, static_cast<cudaStream_t>(stream));
}

// sst_tcn_trunk, and the training residuals: hb [N, B, K, cb] bf16 receives
// each block's input h, st [N, B, 4] fp32 its (mu1, st1, mu2, st2) per item.
extern "C" int sst_tcn_trunk_train(const void* h0, void* h, void* skip, void* t1, void* t2,
                                   void* part, void* counters, const void* we_t, const void* wdw,
                                   const void* wg_t, const void* vecs, const int* dils,
                                   void* timing, void* hb, void* st, int batch, int k, int cb,
                                   int ch, int vdim, int taps, int n_blocks, int groups, int ctas,
                                   void* stream) {
  return run_trunk<true>(h0, h, skip, t1, t2, part, counters, we_t, wdw, wg_t, vecs, dils, timing,
                         hb, st, batch, k, cb, ch, vdim, taps, n_blocks, groups, ctas,
                         static_cast<cudaStream_t>(stream));
}
