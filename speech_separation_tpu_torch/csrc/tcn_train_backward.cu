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
// products bound it.
//
// What the design does about it. The TPU kernel keeps an item's slabs in VMEM
// and runs one grid step per item. Here one cooperative launch a call runs
// every block of every item, laid out as the forward (tcn_trunk.cu) is, from
// ops/tcn_train_cuda.py::backward_plan (the card's SM count and shared
// memory):
// - `groups` items in flight, each owned by a group of `ctas` CTAs, one CTA an
//   SM, that walks its item's blocks in reverse, then takes the item `groups`
//   further on. CTA `rank` owns the 128-row tiles rank, rank + ctas, ... of
//   its item in every phase. The plan takes as many items at once as the SMs
//   allow (16 groups of 8 CTAs, 4 tiles each, at the training shape): a CTA
//   then writes each block's partials once and pays each phase's fixed costs
//   over several tiles. A block needs four barriers, each within the group (a
//   monotone release/acquire counter that traps if it never fills): after P1
//   (P2's taps read other tiles' t1), after P3 (the gLN2 means over the
//   item), after P4 (P5's transposed taps read other tiles' dd) and after P5
//   (the gLN1 means).
// - The group's slabs ([K, ch] bf16: t1, d, n2 then dt1p, dxh2 then dxh1, dd;
//   drs [K, 2cb]) live in device memory and L2. Only t1 and dd are read by
//   other tiles; the others are written and read back by their own CTA within
//   a block. dh (fp32, dh0 on return) is the carry, each tile updated by its
//   owner only, and written rather than added in the first block walked. The
//   dskip half of drs is the same in every block: written in an item's first.
// - All five products run on the wgmma engine of tcn_common.cuh, 128 output
//   columns a pass (m64n128k16: 64 accumulators a thread, where 128 left the
//   rest of the kernel too few registers and it spilled): h @ We (P1 and P6,
//   recomputed rather than kept: y in fp32 would be 4 MB an item and block
//   through L2; P6 takes t1 from it too) with We MN-major, dn2 = drs @ Wcat^T
//   and dh += dt1p @ We^T with K-major operands, and the weight gradients
//   n2^T drs and h^T dt1p with both operands MN-major, each over all this
//   CTA's tiles of an item in one product. wgmma transposes an MN-major
//   operand as it reads it, so no weight is transposed ahead of the launch.
// - A weight gradient is summed per CTA: its fp32 partial for the block kept
//   in device memory in the accumulators' register order (coalesced 16-byte
//   loads and stores), loaded into the accumulators when a group walks a
//   second item; the per-column sums of dvec and dwdw are summed in shared
//   memory over a block and added to a partial beside it. After every CTA's
//   last item a grid-wide counter (the only barrier across groups) opens the
//   final sums: each output element summed over the CTAs in order. No
//   split-K launches, no float atomics: reruns agree bit for bit.
// - P2, P4 and P5 work on 16-byte vectors of 8 channels: P2 and P5 stage a
//   tile's rows and the taps' halo per 64-channel slice in shared memory
//   (cp.async, the next slice's copies in flight; P5 stages dd and t1 and
//   makes two passes over them, each with half the live values), each thread
//   taking 8 channels of every 32nd row with its coefficients in registers;
//   P4 stages its own rows of d and dxh2 per 128-column pass. Column sums are
//   folded by warp shuffles and added in a fixed order through one exchange
//   in shared memory a phase and slice or pass.
// - The epilogues stage their tile in the engine's ring and walk it in
//   16-byte chunks of output, as the forward's do.
// Ragged frames and channels are masked or read as zero.
//
// With a non-null `timing` ([grid, kLaps] int64), thread 0 of each CTA adds up
// the %globaltimer nanoseconds it spent in each part of a block (Lap); the
// laps are compiled into a separate instance of the kernel, launched only
// then.

#include "tcn_common.cuh"

namespace {

using namespace tcn;

// SST_BWD_SKIP (probe builds only, scripts/torch_probe_tcn.py --backward): a
// bit mask of work left out to see what each part costs. 1: the
// weight-gradient partials' loads and stores; 2: the weight-gradient products
// and partials; 4: P5's staging copies. The port builds with 0.
#ifndef SST_BWD_SKIP
#define SST_BWD_SKIP 0
#endif

constexpr int kVecRows = 10;  // rows of vecs (stack_canonical)
// The products run the engine at 128 output columns a pass (wgmma
// m64n128k16): 64 fp32 accumulators a thread, not the forward's 128, leave
// the rest of the kernel its registers.
constexpr int kCols = 128;                  // output columns a pass (python: BWD_TILE_COLS)
constexpr int kAcc = kCols / 2;             // fp32 accumulators a thread
constexpr int kChunks = kCols / 8;          // 16-byte chunks of a pass's row: an epilogue's threads a row
constexpr int kLanes = kThreads / kChunks;  // rows an epilogue walks at once
constexpr int kRingBytes = engine_ring_bytes<kCols>();
constexpr int kAccPitch = kCols + 8;  // floats a row of a staged accumulator tile
constexpr int kSlotBytes = kEngRows * kCols * 2;  // P4: a bf16 input of one tile and pass
constexpr int kColRed = (2 + kMaxTaps) * kSliceCh * kWarps;  // floats of the column-sum exchange
constexpr int kBatch = 4;  // rows an epilogue thread loads before it computes: loads in flight
constexpr int kTileFloats = kEngRows * kCols;  // one weight-gradient tile's partial
static_assert(kEngRows * kAccPitch * 4 <= kRingBytes, "the staged tile fits the ring");

// The parts of a block that `timing` adds up (python: TRUNK_BWD_LAPS).
enum Lap {
  kLapCoefs,       // the block's vectors into smem
  kLapT1,          // P1: the h @ We products, t1 out
  kLapD,           // P2: the taps, d out
  kLapPack,        // P3: drs out
  kLapProject,     // P3: the drs @ Wcat^T products
  kLapProjectOut,  // P3: the epilogue, n2 and dxh2 out
  kLapWcat,        // P3: the dWcat products and partials
  kLapDd,          // P4: dd out
  kLapTaps,        // P5: the transposed taps, dxh1 out
  kLapExpand,      // P6: the h @ We products
  kLapExpandOut,   // P6: the epilogue, dt1p out
  kLapWe,          // P6: the dWe products and partials
  kLapDh,          // P6: the dt1p @ We^T products, dh out
  kLapWait,        // waiting at the barriers
  kLapFinal,       // the final sums over the CTAs
  kLaps
};

struct BwdParams {
  const bf16* hb;      // [N, B, K, cb] each block's input
  const float* st;     // [N, B, 4] (mu1, s1, mu2, s2)
  const float* dskip;  // [B, K, cb]
  float* dh;           // [B, K, cb] the carry, dh0 on return
  const bf16* we;      // [N, cb, ch]
  const bf16* wcat;    // [N, ch, 2 cb]
  const float* wdw;    // [N, taps, ch]
  const float* vecs;   // [N, 10, vdim]
  float* dwe;          // [N, cb, ch]
  float* dwdw;         // [N, taps, ch]
  float* dwcat;        // [N, ch, 2 cb]
  float* dvec;         // [N, 10, vdim]
  bf16 *t1, *d, *nd, *dx, *dd;  // [groups, K, ch]: nd holds n2, then dt1p; dx dxh2, then dxh1
  bf16* drs;           // [groups, K, 2 cb]
  float2* part;        // [groups, 2, ctas] (sum, sum of products) per CTA
  float* wpart;        // [grid, N, wtiles, kTileFloats] weight-gradient partials
  float* vpart;        // [grid, N, 10 + taps, vdim] column-sum partials
  int* counters;       // [groups + 1] zero at the launch; the last one grid-wide
  long long* timing;   // [grid, kLaps] or null
  int batch, k, cb, ch, vdim, taps, n_blocks, groups, ctas;
  int staging;         // bytes of smem before the block's Coefs
  int dils[kMaxBlocks];
};

// The weight-gradient tiles of a block: dWcat [ch, 2 cb], then dWe [cb, ch].
__host__ __device__ inline int cat_tiles_m(int ch) { return (ch + kEngRows - 1) / kEngRows; }
__host__ __device__ inline int cat_tiles_n(int cb) { return (2 * cb + kCols - 1) / kCols; }
__host__ __device__ inline int we_tiles_m(int cb) { return (cb + kEngRows - 1) / kEngRows; }
__host__ __device__ inline int we_tiles_n(int ch) { return (ch + kCols - 1) / kCols; }
__host__ __device__ inline int weight_tiles(int cb, int ch) {
  return cat_tiles_m(ch) * cat_tiles_n(cb) + we_tiles_m(cb) * we_tiles_n(ch);
}

// An item's means from the group's n partial (sum, sum of products) pairs
// (written by other CTAs, so read through L2), in rank order: out[0] = sum
// inv_n, out[1] = sum of products inv_n. Every CTA computes the same values.
__device__ void group_means(const float2* part, int n, float inv_n, float (*red)[kWarps],
                            float* out) {
  float s = 0.f, sq = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float2 v = __ldcg(part + i);
    s = __fadd_rn(s, v.x);
    sq = __fadd_rn(sq, v.y);
  }
  block_sum2(s, sq, red);
  if (threadIdx.x == 0) {
    out[0] = __fmul_rn(s, inv_n);
    out[1] = __fmul_rn(sq, inv_n);
  }
  __syncthreads();
}

__device__ __forceinline__ void zero8(float (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void unpack8(const uint4 raw, float (&v)[8]) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __low2float(x[q]);
    v[2 * q + 1] = __high2float(x[q]);
  }
}

// bf16(v), 16 bytes; r receives the rounded values.
__device__ __forceinline__ uint4 pack8(const float (&v)[8], float (&r)[8]) {
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    o[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    r[2 * q] = __low2float(o[q]);
    r[2 * q + 1] = __high2float(o[q]);
  }
  return out;
}

// Column sums of the CTA's threads added in a fixed order to rows of the
// block's sums in shared memory: thread (lane, chunk), chunk = tid % chunks
// (chunks a power of 2 up to 32), holds in v[s][e] its sum over its rows of
// column col0 + 8 chunk + e. The lanes of a warp are folded by shuffles (a
// fixed tree), the warps' sums added in warp order through colred, and the
// total added to rows[s][col0 + c], c < cols, for s < sums.
template <int kSums>
__device__ __forceinline__ void add_col_sums(float (&v)[kSums][8], int sums, int chunks, float* colred,
                             float* const (&rows)[kSums], int col0, int cols) {
  const int width = chunks * 8, warp = threadIdx.x / 32, q = threadIdx.x % 32;
  for (int o = chunks; o < 32; o <<= 1) {
#pragma unroll
    for (int s = 0; s < kSums; ++s) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[s][e] = __fadd_rn(v[s][e], __shfl_xor_sync(0xffffffffu, v[s][e], o));
    }
  }
  __syncthreads();  // colred may still be read by a previous call
  if (q < chunks) {
#pragma unroll
    for (int s = 0; s < kSums; ++s)
      if (s < sums) store8(colred + (s * kWarps + warp) * width + q * 8, v[s]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += kThreads) {
#pragma unroll
    for (int s = 0; s < kSums; ++s) {
      if (s >= sums) break;
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t = __fadd_rn(t, colred[(s * kWarps + w) * width + c]);
      rows[s][col0 + c] = __fadd_rn(rows[s][col0 + c], t);
    }
  }
}

// The accumulators to and from a weight-gradient partial, in register order:
// accumulator i of thread t at ((i / 4) kThreads + t) 4 + i % 4. The partials
// stream through L2 (evict-first loads and stores), so they do not push the
// group's slabs out of it.
__device__ __forceinline__ void load_partial(float (&acc)[kAcc], const float* p) {
#pragma unroll
  for (int i = 0; i < kAcc; i += 4) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p + ((i / 4) * kThreads + threadIdx.x) * 4));
    acc[i] = v.x;
    acc[i + 1] = v.y;
    acc[i + 2] = v.z;
    acc[i + 3] = v.w;
  }
}

__device__ __forceinline__ void store_partial(const float (&acc)[kAcc], float* p) {
#pragma unroll
  for (int i = 0; i < kAcc; i += 4)
    __stcs(reinterpret_cast<float4*>(p + ((i / 4) * kThreads + threadIdx.x) * 4),
           make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]));
}

// The accumulators, raw, into tile (fp32, kAccPitch floats a row), for every
// thread to read after the barrier.
__device__ __forceinline__ void stage_acc(const float (&acc)[kAcc], float* tile) {
  float* base = tile + acc_row(0) * kAccPitch + acc_col(0);
#pragma unroll
  for (int i = 0; i < kAcc; i += 2)
    *reinterpret_cast<float2*>(base + ((i >> 1) & 1) * 8 * kAccPitch + (i >> 2) * 8) =
        make_float2(acc[i], acc[i + 1]);
  __syncthreads();
}

// A block's per-column vectors and depthwise weights in shared memory, loaded
// once at the block's start (python: backward_smem_bytes).
struct Coefs {
  float* base;  // be, g1, b1, bdw, g2, b2, a1, a2 [ch] each, then wdw [taps, ch]
  int ch;
  __device__ __forceinline__ float* be() const { return base; }
  __device__ __forceinline__ float* g1() const { return base + ch; }
  __device__ __forceinline__ float* b1() const { return base + 2 * ch; }
  __device__ __forceinline__ float* bdw() const { return base + 3 * ch; }
  __device__ __forceinline__ float* g2() const { return base + 4 * ch; }
  __device__ __forceinline__ float* b2() const { return base + 5 * ch; }
  __device__ __forceinline__ float* a1() const { return base + 6 * ch; }
  __device__ __forceinline__ float* a2() const { return base + 7 * ch; }
  __device__ __forceinline__ float* wdw() const { return base + 8 * ch; }
};

__device__ void load_coefs(const Coefs& c, const float* __restrict__ vec,
                           const float* __restrict__ wdw, int vdim, int ch, int taps) {
  for (int i = threadIdx.x; i < ch; i += kThreads) {
    c.be()[i] = vec[i];
    c.g1()[i] = vec[vdim + i];
    c.b1()[i] = vec[2 * vdim + i];
    c.bdw()[i] = vec[3 * vdim + i];
    c.g2()[i] = vec[4 * vdim + i];
    c.b2()[i] = vec[5 * vdim + i];
    c.a1()[i] = vec[8 * vdim + i];
    c.a2()[i] = vec[9 * vdim + i];
  }
  for (int i = threadIdx.x; i < taps * ch; i += kThreads) c.wdw()[i] = wdw[i];
}

// What a block's phases read of one item: its slabs and vectors.
struct Block {
  const bf16* h;       // the block's input, the item's [K, cb]
  const bf16* we;      // [cb, ch]
  const bf16* wcat;    // [ch, 2 cb]
  float* dh;           // the item's carry [K, cb]
  const float* dskip;  // the item's [K, cb]
  float* wpart;        // this CTA's weight-gradient partials of the block
  float* csum;         // the block's column sums, shared memory [10 + taps, vdim]
  float mu1, s1, mu2, s2;
  int dil;
  bool first;          // the first block walked: the carry starts at zero
};

// P1 for one tile: t1 = bf16(prelu(h @ We + be)) into the group's slab.
__device__ __forceinline__ void recompute_t1(const BwdParams& p, const Coefs& cf, const Block& b, bf16* t1,
                             int row0, float (&acc)[kAcc], unsigned char* smem) {
  const int k = p.k, cb = p.cb, ch = p.ch, rows = min(kEngRows, k - row0);
  const float* tile = reinterpret_cast<const float*>(smem);
#pragma unroll 1
  for (int col0 = 0; col0 < ch; col0 += kCols) {
    engine_tile<false, true, kCols>(acc, b.h, cb, k, row0, b.we, ch, ch, col0, cb, smem);
    stage_acc(acc, reinterpret_cast<float*>(smem));
    // thread i takes column chunk i % kChunks of every kLanes-th row from row i / kChunks
    const int runs = min(kCols, ch - col0) / 8;
    const int q = threadIdx.x % kChunks, c = col0 + q * 8;
    if (q < runs) {
      float be[8], a1[8];
      load8(cf.be() + c, be);
      load8(cf.a1() + c, a1);
#pragma unroll 2
      for (int r = threadIdx.x / kChunks; r < rows; r += kLanes) {
        float x[8], v[8], rd[8];
        load8(tile + r * kAccPitch + q * 8, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = prelu(__fadd_rn(x[e], be[e]), a1[e]);
        *reinterpret_cast<uint4*>(t1 + static_cast<size_t>(row0 + r) * ch + c) = pack8(v, rd);
      }
    }
    __syncthreads();  // the ring is free again
  }
}

// P2 over this CTA's tiles: d = bf16(sum_t (A1 w_t) t1[r + t d - pad] + B1 sum w
// + bdw - edge). Per unit (tile, 64-channel slice) the rows [row0 - pad, row0 +
// 128 + (taps - 1) d - pad) of t1 are staged in one of two buffers (128 bytes
// a row; rows outside [0, K) and channels past ch read zero), the next unit's
// copies in flight while one is computed. Thread (row lane tid / 8, channel
// group tid % 8) takes 8 channels of every 32nd row, with their folded
// coefficients in registers. kT >= taps bounds the coefficient arrays.
template <int kT>
__device__ __forceinline__ void recompute_d(const BwdParams& p, const Coefs& cf, const Block& b, const bf16* t1,
                            bf16* __restrict__ d, int rank, unsigned char* smem, int buf_bytes) {
  const int k = p.k, ch = p.ch, taps = p.taps, dil = b.dil;
  const int tiles = (k + kEngRows - 1) / kEngRows;
  const int pad = (taps - 1) * dil / 2;
  const int span = kEngRows + (taps - 1) * dil;
  const int slices = (ch + kSliceCh - 1) / kSliceCh;
  const int units = (tiles - rank + p.ctas - 1) / p.ctas * slices;
  const int cg = threadIdx.x % 8, lane_row = threadIdx.x / 8;

  auto stage = [&](int u) {
    if (u >= units) return;
    const int r0 = (rank + (u / slices) * p.ctas) * kEngRows - pad;
    const int c0 = (u % slices) * kSliceCh;
    unsigned char* buf = smem + (u & 1) * buf_bytes;
    for (int c = threadIdx.x; c < span * 8; c += kThreads) {
      const int r = r0 + (c >> 3), cc = c0 + (c & 7) * 8;
      const bool ok = r >= 0 && r < k && cc < ch;
      cp_async16(buf + c * 16, ok ? t1 + static_cast<size_t>(r) * ch + cc : t1, ok);
    }
  };

  stage(0);
  cp_async_commit();
  for (int u = 0; u < units; ++u) {
    stage(u + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of unit u have landed
    __syncthreads();     // everyone's have
    const int tile = rank + (u / slices) * p.ctas;
    const int c = (u % slices) * kSliceCh + cg * 8;  // this thread's first channel
    const unsigned char* buf = smem + (u & 1) * buf_bytes;
    if (c < ch) {
      float aw[kT][8], bw[kT][8], beff[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float av = __fmul_rn(cf.g1()[c + q], b.s1);
        const float bv = __fsub_rn(cf.b1()[c + q], __fmul_rn(b.mu1, av));
        float wsum = 0.f;
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          const float w = t < taps ? cf.wdw()[t * ch + c + q] : 0.f;
          if (t < taps) wsum = __fadd_rn(wsum, w);
          aw[t][q] = __fmul_rn(av, w);
          bw[t][q] = __fmul_rn(bv, w);
        }
        beff[q] = __fadd_rn(__fmul_rn(bv, wsum), cf.bdw()[c + q]);
      }
      const int rows = min(kEngRows, k - tile * kEngRows);
#pragma unroll 2
      for (int r = lane_row; r < rows; r += kThreads / 8) {
        const int gr = tile * kEngRows + r;
        float pre[8], x[8], rd[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) pre[q] = beff[q];
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          if (t >= taps) break;
          unpack8(*reinterpret_cast<const uint4*>(buf + ((r + t * dil) * 8 + cg) * 16), x);
#pragma unroll
          for (int q = 0; q < 8; ++q) pre[q] = __fadd_rn(pre[q], __fmul_rn(aw[t][q], x[q]));
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
        *reinterpret_cast<uint4*>(d + static_cast<size_t>(gr) * ch + c) = pack8(pre, rd);
      }
    }
    __syncthreads();  // the buffer may be staged again
  }
  cp_async_wait<0>();
}

// P3, first part, for one tile: drs = bf16([dh | dskip]) (dh zero in the first
// block walked) into the group's slab, and the rounded values' column sums
// into row 6 of the block's sums. The dskip half is the same in every block of
// an item: it is written, and summed, in the item's first block only (the
// kernel keeps its sums). Thread i takes column chunk i % kChunks of every
// kLanes-th row from row i / kChunks, kBatch rows' loads in flight before it
// computes.
__device__ __forceinline__ void pack_drs(const BwdParams& p, const Block& b, bf16* drs, int row0, float* colred) {
  const int cb = p.cb, w = 2 * cb, rows = min(kEngRows, p.k - row0);
#pragma unroll 1
  for (int c0 = 0; c0 < w; c0 += kCols) {
    const int runs = min(kCols, w - c0) / 8;
    const int q = threadIdx.x % kChunks, c = c0 + q * 8;
    float sum[1][8];
    zero8(sum[0]);
    if (q < runs && (c < cb || b.first)) {
      const bool skip_half = c >= cb;
      const float* src = skip_half ? b.dskip + (c - cb) : b.dh + c;
      const bool zero = !skip_half && b.first;
#pragma unroll 1
      for (int rb = threadIdx.x / kChunks; rb < rows; rb += kBatch * kLanes) {
        float4 in[kBatch][2];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int r = rb + i * kLanes;
          if (r < rows && !zero) {
            const float4* at = reinterpret_cast<const float4*>(src + static_cast<size_t>(row0 + r) * cb);
            in[i][0] = __ldcg(at);
            in[i][1] = __ldcg(at + 1);
          } else {
            in[i][0] = in[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int r = rb + i * kLanes;
          if (r >= rows) break;
          float v[8] = {in[i][0].x, in[i][0].y, in[i][0].z, in[i][0].w,
                        in[i][1].x, in[i][1].y, in[i][1].z, in[i][1].w};
          float rd[8];
          *reinterpret_cast<uint4*>(drs + static_cast<size_t>(row0 + r) * w + c) = pack8(v, rd);
#pragma unroll
          for (int e = 0; e < 8; ++e) sum[0][e] = __fadd_rn(sum[0][e], rd[e]);
        }
      }
    }
    float* const dst[1] = {b.csum + 6 * p.vdim};
    add_col_sums<1>(sum, 1, kChunks, colred, dst, c0, min(kCols, w - c0));
  }
  __syncthreads();  // drs is in before the product reads it
}

// kBatch 16-byte loads of a bf16 slab's rows rb + kLanes i (i < kBatch, rows
// below `rows`) at column c, for the epilogues' threads.
__device__ __forceinline__ void load_rows(const bf16* slab, int ld, int row0, int rb, int rows,
                                          int c, uint4 (&out)[kBatch]) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const int r = rb + i * kLanes;
    out[i] = r < rows ? *reinterpret_cast<const uint4*>(slab + static_cast<size_t>(row0 + r) * ld + c)
                      : make_uint4(0u, 0u, 0u, 0u);
  }
}

// cp.async of a bf16 slab's rows [row0, row0 + 128) and columns [col0, col0 +
// kCols) into dst (a row's kChunks chunks in order; zero past the slab's K
// rows or `cols` columns), as one commit group.
__device__ __forceinline__ void fetch_pass(unsigned char* dst, const bf16* slab, int ld, int k,
                                           int row0, int col0, int cols) {
#pragma unroll
  for (int n = 0; n < kEngRows * kChunks / kThreads; ++n) {
    const int c = threadIdx.x + n * kThreads;
    const int r = c / kChunks, cc = col0 + (c % kChunks) * 8;
    const bool ok = row0 + r < k && cc < cols;
    cp_async16(dst + c * 16, ok ? slab + static_cast<size_t>(row0 + r) * ld + cc : slab, ok);
  }
  cp_async_commit();
}

// Row r's 8 values of this thread's chunk q in a fetched pass.
__device__ __forceinline__ void slot8(const unsigned char* slot, int r, int q, float (&v)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(slot + (r * kChunks + q) * 16), v);
}

// P3's epilogue for the staged dn2 tile at (row0, col0): xh2 = (prelu(d) -
// mu2) s2, n2 = bf16(g2 xh2 + b2), dxh2 = bf16(dn2 g2); column sums of dn2 xh2
// and dn2 into rows 4 and 5; the item sums of dxh2 and dxh2 xh2 added to s,
// sq (each row's, in channel order).
__device__ __forceinline__ void project_epilogue(const BwdParams& p, const Coefs& cf, const Block& b,
                                 const bf16* d, bf16* n2, bf16* dxh2, int row0, int col0,
                                 const float* tile, float* colred, float& s, float& sq) {
  const int ch = p.ch, rows = min(kEngRows, p.k - row0);
  const int runs = min(kCols, ch - col0) / 8;
  const int q = threadIdx.x % kChunks, c = col0 + q * 8;
  float sums[2][8];
  zero8(sums[0]);
  zero8(sums[1]);
  if (q < runs) {
    float g2[8], b2[8], a2[8];
    load8(cf.g2() + c, g2);
    load8(cf.b2() + c, b2);
    load8(cf.a2() + c, a2);
#pragma unroll 1
    for (int rb = threadIdx.x / kChunks; rb < rows; rb += kBatch * kLanes) {
      uint4 din[kBatch];
      load_rows(d, ch, row0, rb, rows, c, din);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int r = rb + i * kLanes;
        if (r >= rows) break;
        const size_t at = static_cast<size_t>(row0 + r) * ch + c;
        float dn[8], dv[8], n[8], dx[8], rd[8];
        load8(tile + r * kAccPitch + q * 8, dn);
        unpack8(din[i], dv);
        float rs = 0.f, rq = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xh = __fmul_rn(__fsub_rn(prelu(dv[e], a2[e]), b.mu2), b.s2);
          n[e] = __fadd_rn(__fmul_rn(g2[e], xh), b2[e]);
          sums[0][e] = __fadd_rn(sums[0][e], __fmul_rn(dn[e], xh));
          sums[1][e] = __fadd_rn(sums[1][e], dn[e]);
          dx[e] = __fmul_rn(dn[e], g2[e]);
          rs = __fadd_rn(rs, dx[e]);
          rq = __fadd_rn(rq, __fmul_rn(dx[e], xh));
        }
        s = __fadd_rn(s, rs);
        sq = __fadd_rn(sq, rq);
        *reinterpret_cast<uint4*>(n2 + at) = pack8(n, rd);
        *reinterpret_cast<uint4*>(dxh2 + at) = pack8(dx, rd);
      }
    }
  }
  float* const dst[2] = {b.csum + 4 * p.vdim, b.csum + 5 * p.vdim};
  add_col_sums<2>(sums, 2, kChunks, colred, dst, col0, min(kCols, ch - col0));
  __syncthreads();  // the staged tile may be overwritten; n2 and dxh2 are in
}

// A weight gradient's contribution of this CTA's tiles of an item, added to
// its partial: A^T [rows, m_total] and B [rows, n_total] MN-major, the rows of
// this CTA's tiles of two slabs (a and bm at row 0), the partial's 128 x 128
// tiles in order (m, n). One product a tile of the partial, its depth the
// CTA's tiles one after the other (segments of 128 rows, ctas tiles apart).
// `accumulate`: the partial already holds sums (else the products start it).
__device__ __forceinline__ void weight_grad(float (&acc)[kAcc], const BwdParams& p, int rank,
                                            const bf16* a, int m_total, const bf16* bm,
                                            int n_total, float* wpart, bool accumulate,
                                            unsigned char* smem) {
  if (SST_BWD_SKIP & 2) return;
  const int k = p.k, tiles = (k + kEngRows - 1) / kEngRows;
  const int mine = (tiles - rank + p.ctas - 1) / p.ctas;
  const int last = rank + (mine - 1) * p.ctas;  // this CTA's last tile
  const Segments seg{p.ctas * kEngRows, min(kEngRows, k - last * kEngRows)};
  const size_t row0 = static_cast<size_t>(rank) * kEngRows;
  float* part = wpart;
#pragma unroll 1
  for (int m0 = 0; m0 < m_total; m0 += kEngRows) {
#pragma unroll 1
    for (int n0 = 0; n0 < n_total; n0 += kCols, part += kTileFloats) {
      if (accumulate && !(SST_BWD_SKIP & 1)) load_partial(acc, part);
      engine_tile<true, true, kCols>(acc, a + row0 * m_total, m_total, m_total, m0,
                                     bm + row0 * n_total, n_total, n_total, n0,
                                     mine * kEngRows, smem, accumulate, seg);
      if (!(SST_BWD_SKIP & 1)) store_partial(acc, part);
    }
  }
}

// P4 over this CTA's tiles: dt2 = s2 (bf16(dxh2) - ma2 - xh2 mb2), dd =
// bf16(where(d >= 0, dt2, a2 dt2)) into the group's slab; column sums of dt2
// min(d, 0) and dd into rows 9 and 3. Per unit (128-column pass, tile) d and
// dxh2 are fetched into a pair of slots, the next unit's pair in flight.
__device__ __forceinline__ void dd_rows(const BwdParams& p, const Coefs& cf, const Block& b, const bf16* d,
                        const bf16* dxh2, bf16* dd, int rank, float ma2, float mb2,
                        float* colred, unsigned char* smem) {
  const int k = p.k, ch = p.ch;
  const int tiles = (k + kEngRows - 1) / kEngRows;
  const int mine = (tiles - rank + p.ctas - 1) / p.ctas;  // this CTA's tiles
  const int units = mine * ((ch + kCols - 1) / kCols);   // (pass, tile), passes outer
  // a unit's d and dxh2 in a pair of slots, the next unit's pair in flight
  auto stage = [&](int u) {
    if (u >= units) return;
    const int row0 = (rank + (u % mine) * p.ctas) * kEngRows, col0 = (u / mine) * kCols;
    unsigned char* buf = smem + (u & 1) * 2 * kSlotBytes;
    fetch_pass(buf, d, ch, k, row0, col0, ch);
    fetch_pass(buf + kSlotBytes, dxh2, ch, k, row0, col0, ch);
  };
  float sums[2][8];  // over this CTA's tiles, exchanged once a pass
  stage(0);
  for (int u = 0; u < units; ++u) {
    stage(u + 1);
    if (u + 1 < units)
      cp_async_wait<2>();  // unit u's two groups have landed
    else
      cp_async_wait<0>();
    __syncthreads();
    const int row0 = (rank + (u % mine) * p.ctas) * kEngRows, col0 = (u / mine) * kCols;
    const int rows = min(kEngRows, k - row0);
    const int runs = min(kCols, ch - col0) / 8;
    const int q = threadIdx.x % kChunks, c = col0 + q * 8;
    const unsigned char* bd = smem + (u & 1) * 2 * kSlotBytes;
    if (u % mine == 0) {
      zero8(sums[0]);
      zero8(sums[1]);
    }
    if (q < runs) {
      float a2[8];
      load8(cf.a2() + c, a2);
#pragma unroll 2
      for (int r = threadIdx.x / kChunks; r < rows; r += kLanes) {
        float dv[8], dx[8], out[8], rd[8];
        slot8(bd, r, q, dv);
        slot8(bd + kSlotBytes, r, q, dx);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xh = __fmul_rn(__fsub_rn(prelu(dv[e], a2[e]), b.mu2), b.s2);
          const float dt2 = __fmul_rn(b.s2, __fsub_rn(__fsub_rn(dx[e], ma2), __fmul_rn(xh, mb2)));
          out[e] = dv[e] >= 0.f ? dt2 : __fmul_rn(a2[e], dt2);
          sums[0][e] = __fadd_rn(sums[0][e], __fmul_rn(dt2, fminf(dv[e], 0.f)));
          sums[1][e] = __fadd_rn(sums[1][e], out[e]);
        }
        *reinterpret_cast<uint4*>(dd + static_cast<size_t>(row0 + r) * ch + c) = pack8(out, rd);
      }
    }
    if (u % mine == mine - 1) {
      float* const dst[2] = {b.csum + 9 * p.vdim, b.csum + 3 * p.vdim};
      add_col_sums<2>(sums, 2, kChunks, colred, dst, col0, min(kCols, ch - col0));
    }
    __syncthreads();  // the slots may be fetched again
  }
}

// P5 over this CTA's tiles: dn1[u] = sum_t w_t dd[u - rel_t], dw_t += sum_u
// dd[u] n1[u + rel_t] (n1 = A1 t1 + B1 inside [0, K), zero outside), xh1 =
// (t1 - mu1) s1, dxh1 = bf16(dn1 g1) into the group's slab; column sums of
// dn1 xh1, dn1 and dw_t into rows 1, 2 and 10 + t; the item sums of dxh1 and
// dxh1 xh1 added to s, sq (each row's, in channel order). Per unit (tile,
// 64-channel slice) dd's rows [row0 - lo, row0 + 128 + pad) (lo = (taps - 1) d
// - pad, the reach of the transposed taps) and t1's rows [row0 - pad, row0 +
// 128 + lo) are staged in a pair of buffers, the next unit's pair in flight;
// threads as in P2.
template <int kT>
__device__ __forceinline__ void taps_bwd(const BwdParams& p, const Coefs& cf, const Block& b, const bf16* dd,
                         const bf16* t1, bf16* __restrict__ dxh1, int rank, float* colred,
                         unsigned char* smem, int buf_bytes, float& s, float& sq) {
  const int k = p.k, ch = p.ch, taps = p.taps, dil = b.dil;
  const int tiles = (k + kEngRows - 1) / kEngRows;
  const int pad = (taps - 1) * dil / 2, lo = (taps - 1) * dil - pad;
  const int span = kEngRows + (taps - 1) * dil;
  const int slices = (ch + kSliceCh - 1) / kSliceCh;
  const int mine = (tiles - rank + p.ctas - 1) / p.ctas;  // this CTA's tiles
  const int units = mine * slices;
  const int cg = threadIdx.x % 8, lane_row = threadIdx.x / 8;

  auto stage = [&](int u) {
    if (u >= units) return;
    const int row0 = (rank + (u % mine) * p.ctas) * kEngRows;
    const int c0 = (u / mine) * kSliceCh;
    unsigned char* buf = smem + (u & 1) * 2 * buf_bytes;
    for (int c = threadIdx.x; c < span * 8; c += kThreads) {
      const int cc = c0 + (c & 7) * 8;
      const int rd = row0 - lo + (c >> 3), rt = row0 - pad + (c >> 3);
      const bool okd = rd >= 0 && rd < k && cc < ch, okt = rt >= 0 && rt < k && cc < ch;
      if (SST_BWD_SKIP & 4) continue;
      cp_async16(buf + c * 16, okd ? dd + static_cast<size_t>(rd) * ch + cc : dd, okd);
      cp_async16(buf + buf_bytes + c * 16, okt ? t1 + static_cast<size_t>(rt) * ch + cc : t1, okt);
    }
  };

  stage(0);
  cp_async_commit();
  for (int u = 0; u < units; ++u) {
    stage(u + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int tile = rank + (u % mine) * p.ctas;
    const int c0 = (u / mine) * kSliceCh;
    const int c = c0 + cg * 8;
    const unsigned char* bd = smem + (u & 1) * 2 * buf_bytes;
    const unsigned char* bt = bd + buf_bytes;
    // sums[0], sums[1]: dn1 xh1, dn1; sums[2 + t]: dw_t
    float sums[2 + kT][8];
#pragma unroll
    for (int t = 0; t < 2 + kT; ++t) zero8(sums[t]);
    const int rows = min(kEngRows, k - tile * kEngRows);
    // two passes over the staged rows, each with half the live values (one
    // pass holding both spilled registers): dn1 and what follows from it,
    // then dw
    if (c < ch) {
      float w[kT][8], g1[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        g1[q] = cf.g1()[c + q];
#pragma unroll
        for (int t = 0; t < kT; ++t) w[t][q] = t < taps ? cf.wdw()[t * ch + c + q] : 0.f;
      }
#pragma unroll 1
      for (int r = lane_row; r < rows; r += kThreads / 8) {
        const int gr = tile * kEngRows + r;
        float dn[8], x[8], dx[8], rd[8];
        zero8(dn);
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          if (t >= taps) break;
          unpack8(*reinterpret_cast<const uint4*>(bd + ((r + (taps - 1 - t) * dil) * 8 + cg) * 16), x);
#pragma unroll
          for (int q = 0; q < 8; ++q) dn[q] = __fadd_rn(dn[q], __fmul_rn(w[t][q], x[q]));
        }
        unpack8(*reinterpret_cast<const uint4*>(bt + ((r + pad) * 8 + cg) * 16), x);
        float rs = 0.f, rq = 0.f;  // this row's item sums, in channel order
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float xh = __fmul_rn(__fsub_rn(x[q], b.mu1), b.s1);
          sums[0][q] = __fadd_rn(sums[0][q], __fmul_rn(dn[q], xh));
          sums[1][q] = __fadd_rn(sums[1][q], dn[q]);
          dx[q] = __fmul_rn(dn[q], g1[q]);
          rs = __fadd_rn(rs, dx[q]);
          rq = __fadd_rn(rq, __fmul_rn(dx[q], xh));
        }
        s = __fadd_rn(s, rs);
        sq = __fadd_rn(sq, rq);
        *reinterpret_cast<uint4*>(dxh1 + static_cast<size_t>(gr) * ch + c) = pack8(dx, rd);
      }
    }
    if (c < ch) {
      float av[8], bv[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        av[q] = __fmul_rn(cf.g1()[c + q], b.s1);
        bv[q] = __fsub_rn(cf.b1()[c + q], __fmul_rn(b.mu1, av[q]));
      }
#pragma unroll 1
      for (int r = lane_row; r < rows; r += kThreads / 8) {
        const int gr = tile * kEngRows + r;
        float x[8], ddr[8];
        unpack8(*reinterpret_cast<const uint4*>(bd + ((r + lo) * 8 + cg) * 16), ddr);
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          if (t >= taps) break;
          const int u1 = gr + t * dil - pad;
          if (u1 < 0 || u1 >= k) continue;  // the normalised input is zero-padded
          unpack8(*reinterpret_cast<const uint4*>(bt + ((r + t * dil) * 8 + cg) * 16), x);
#pragma unroll
          for (int q = 0; q < 8; ++q)
            sums[2 + t][q] = __fadd_rn(sums[2 + t][q], __fmul_rn(ddr[q], __fadd_rn(__fmul_rn(av[q], x[q]), bv[q])));
        }
      }
    }
    float* dst[2 + kT];  // rows 1, 2, 10 + t
    dst[0] = b.csum + 1 * p.vdim;
    dst[1] = b.csum + 2 * p.vdim;
#pragma unroll
    for (int t = 0; t < kT; ++t) dst[2 + t] = b.csum + (kVecRows + (t < taps ? t : 0)) * p.vdim;
    add_col_sums<2 + kT>(sums, 2 + taps, 8, colred, dst, c0, min(kSliceCh, ch - c0));
    __syncthreads();  // the buffers may be staged again
  }
  cp_async_wait<0>();
}

// P6's epilogue for the staged y - be tile at (row0, col0): y = acc + be, t1 =
// bf16(prelu(y)) (recomputed, as P1 computed it), xh1 = (t1 - mu1) s1, dt1 =
// s1 (bf16(dxh1) - ma1 - xh1 mb1), dt1p = bf16(where(y >= 0, dt1, a1 dt1))
// into the group's slab; column sums of dt1 min(y, 0) and dt1p into rows 8
// and 0.
__device__ __forceinline__ void expand_epilogue(const BwdParams& p, const Coefs& cf, const Block& b,
                                const bf16* dxh1, bf16* dt1p, int row0, int col0,
                                float ma1, float mb1, const float* tile, float* colred) {
  const int ch = p.ch, rows = min(kEngRows, p.k - row0);
  const int runs = min(kCols, ch - col0) / 8;
  const int q = threadIdx.x % kChunks, c = col0 + q * 8;
  float sums[2][8];
  zero8(sums[0]);
  zero8(sums[1]);
  if (q < runs) {
    float be[8], a1[8];
    load8(cf.be() + c, be);
    load8(cf.a1() + c, a1);
#pragma unroll 1
    for (int rb = threadIdx.x / kChunks; rb < rows; rb += kBatch * kLanes) {
      uint4 xin[kBatch];
      load_rows(dxh1, ch, row0, rb, rows, c, xin);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int r = rb + i * kLanes;
        if (r >= rows) break;
        float x[8], v[8], tv[8], dx[8], out[8], rd[8];
        load8(tile + r * kAccPitch + q * 8, x);
        unpack8(xin[i], dx);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = prelu(__fadd_rn(x[e], be[e]), a1[e]);
        pack8(v, tv);  // t1 = bf16(prelu(y)), P1's bits: the same product and epilogue
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float y = __fadd_rn(x[e], be[e]);
          const float xh = __fmul_rn(__fsub_rn(tv[e], b.mu1), b.s1);
          const float dt1 = __fmul_rn(b.s1, __fsub_rn(__fsub_rn(dx[e], ma1), __fmul_rn(xh, mb1)));
          out[e] = y >= 0.f ? dt1 : __fmul_rn(a1[e], dt1);
          sums[0][e] = __fadd_rn(sums[0][e], __fmul_rn(dt1, fminf(y, 0.f)));
          sums[1][e] = __fadd_rn(sums[1][e], out[e]);
        }
        *reinterpret_cast<uint4*>(dt1p + static_cast<size_t>(row0 + r) * ch + c) = pack8(out, rd);
      }
    }
  }
  float* const dst[2] = {b.csum + 8 * p.vdim, b.csum + 0 * p.vdim};
  add_col_sums<2>(sums, 2, kChunks, colred, dst, col0, min(kCols, ch - col0));
  __syncthreads();  // the staged tile may be overwritten; dt1p is in
}

// dh [rows, cb] of the tile at (row0, col0) = (first ? 0 : dh) + the staged
// dt1p @ We^T tile.
__device__ __forceinline__ void dh_epilogue(const BwdParams& p, const Block& b, int row0, int col0,
                            const float* tile) {
  const int cb = p.cb, rows = min(kEngRows, p.k - row0);
  const int runs = min(kCols, cb - col0) / 8;
  const int q = threadIdx.x % kChunks, c = col0 + q * 8;
  if (q < runs) {
#pragma unroll 1
    for (int rb = threadIdx.x / kChunks; rb < rows; rb += kBatch * kLanes) {
      float4 old[kBatch][2];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int r = rb + i * kLanes;
        if (r < rows && !b.first) {
          const float4* at = reinterpret_cast<const float4*>(b.dh + static_cast<size_t>(row0 + r) * cb + c);
          old[i][0] = at[0];
          old[i][1] = at[1];
        } else {
          old[i][0] = old[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int r = rb + i * kLanes;
        if (r >= rows) break;
        float x[8];
        load8(tile + r * kAccPitch + q * 8, x);
        if (!b.first) {
          const float o[8] = {old[i][0].x, old[i][0].y, old[i][0].z, old[i][0].w,
                              old[i][1].x, old[i][1].y, old[i][1].z, old[i][1].w};
#pragma unroll
          for (int e = 0; e < 8; ++e) x[e] = __fadd_rn(o[e], x[e]);
        }
        store8(b.dh + static_cast<size_t>(row0 + r) * cb + c, x);
      }
    }
  }
  __syncthreads();  // the ring is free again
}

// After every CTA's last item: each weight gradient, dvec and dwdw element
// summed over the CTAs' partials in CTA order (read through L2: other CTAs
// wrote them), the grid's threads taking consecutive elements.
__device__ void final_sums(const BwdParams& p, int wtiles, int cat_tiles, int vrows) {
  const int grid = gridDim.x;
  const size_t first = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t step = static_cast<size_t>(grid) * kThreads;
  const size_t wstride = static_cast<size_t>(p.n_blocks) * wtiles * kTileFloats;
  const int cat_n = cat_tiles_n(p.cb), we_n = we_tiles_n(p.ch);
  const int cb = p.cb, ch = p.ch;
  for (size_t e = first; e < wstride; e += step) {
    float s = 0.f;
#pragma unroll 16
    for (int c = 0; c < grid; ++c) s = __fadd_rn(s, __ldcs(p.wpart + c * wstride + e));
    // e = ((j wtiles + wt) kTileFloats + f), f = ((i / 4) kThreads + t) 4 + i % 4
    const int f = static_cast<int>(e % kTileFloats);
    const size_t jt = e / kTileFloats;
    const int wt = static_cast<int>(jt % wtiles), j = static_cast<int>(jt / wtiles);
    const int i = (f / (4 * kThreads)) * 4 + f % 4, t = (f / 4) % kThreads;
    const int row = (t / 128) * 64 + ((t / 32) % 4) * 16 + (t % 32) / 4 + ((i >> 1) & 1) * 8;
    const int col = (i >> 2) * 8 + (t % 4) * 2 + (i & 1);
    if (wt < cat_tiles) {
      const int r = (wt / cat_n) * kEngRows + row, cc = (wt % cat_n) * kCols + col;
      if (r < ch && cc < 2 * cb) p.dwcat[(static_cast<size_t>(j) * ch + r) * 2 * cb + cc] = s;
    } else {
      const int w = wt - cat_tiles;
      const int r = (w / we_n) * kEngRows + row, cc = (w % we_n) * kCols + col;
      if (r < cb && cc < ch) p.dwe[(static_cast<size_t>(j) * cb + r) * ch + cc] = s;
    }
  }
  const size_t vstride = static_cast<size_t>(p.n_blocks) * vrows * p.vdim;
  for (size_t e = first; e < vstride; e += step) {
    float s = 0.f;
#pragma unroll 16
    for (int c = 0; c < grid; ++c) s = __fadd_rn(s, __ldcg(p.vpart + c * vstride + e));
    const int j = static_cast<int>(e / (static_cast<size_t>(vrows) * p.vdim));
    const int rem = static_cast<int>(e % (static_cast<size_t>(vrows) * p.vdim));
    const int row = rem / p.vdim, col = rem % p.vdim;
    if (row < kVecRows)
      p.dvec[(static_cast<size_t>(j) * kVecRows + row) * p.vdim + col] = s;
    else if (col < ch)
      p.dwdw[(static_cast<size_t>(j) * p.taps + row - kVecRows) * ch + col] = s;
  }
}

// The whole backward, grid groups x ctas, one CTA an SM (a cooperative launch).
template <int kT, bool kTimed>
__global__ void __launch_bounds__(kThreads, 1) backward_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  // staging (1,024-byte aligned for the swizzled stages), then the block's
  // Coefs and the column-sum exchange
  unsigned char* smem =
      smem_raw + ((1024u - (static_cast<unsigned>(__cvta_generic_to_shared(smem_raw)) & 1023u)) & 1023u);
  __shared__ float red[2][kWarps];
  __shared__ float means[2];
  const int g = blockIdx.x / p.ctas, rank = blockIdx.x % p.ctas;
  const int k = p.k, cb = p.cb, ch = p.ch, vdim = p.vdim;
  const int tiles = (k + kEngRows - 1) / kEngRows;
  const float inv_n = static_cast<float>(1.0 / (static_cast<double>(k) * ch));
  int* counter = p.counters + g;
  const size_t slab = static_cast<size_t>(g) * k * ch;
  bf16* t1 = p.t1 + slab;
  bf16* d = p.d + slab;
  bf16* nd = p.nd + slab;  // n2, then dt1p
  bf16* dx = p.dx + slab;  // dxh2, then dxh1
  bf16* dd = p.dd + slab;
  bf16* drs = p.drs + static_cast<size_t>(g) * k * 2 * cb;
  float2* part2 = p.part + static_cast<size_t>(g) * 2 * p.ctas;
  float2* part1 = part2 + p.ctas;
  const int vrows = kVecRows + p.taps;
  const int wtiles = weight_tiles(cb, ch);
  const int cat_tiles = cat_tiles_m(ch) * cat_tiles_n(cb);
  float* wpart = p.wpart + static_cast<size_t>(blockIdx.x) * p.n_blocks * wtiles * kTileFloats;
  float* vpart = p.vpart + static_cast<size_t>(blockIdx.x) * p.n_blocks * vrows * vdim;
  constexpr bool timed = kTimed;
  long long spent[kLaps] = {};
  long long mark = 0;
  auto lap = [&](int slot) {
    if (timed && threadIdx.x == 0) {
      const long long t = now_ns();
      spent[slot] += t - mark;
      mark = t;
    }
  };
  auto barrier = [&](int& arrivals) {
    group_arrive(counter);
    group_wait(counter, ++arrivals * p.ctas);
    lap(kLapWait);
  };
  int arrivals = 0;  // this group's barriers so far
  float acc[kAcc];
  const Coefs cf{reinterpret_cast<float*>(smem + p.staging), ch};
  float* colred = cf.wdw() + p.taps * ch;
  float* csum = colred + kColRed;  // [10 + taps, vdim]
  float* skip_sums = csum + vrows * vdim;  // [cb]: this CTA's sums of bf16(dskip) for its item
  if (timed && threadIdx.x == 0) mark = now_ns();

  // this CTA's column-sum partials start at zero
  for (size_t i = threadIdx.x; i < static_cast<size_t>(p.n_blocks) * vrows * vdim; i += kThreads)
    vpart[i] = 0.f;

  int walked = 0;  // items this group has walked
  for (int item = g; item < p.batch; item += p.groups, ++walked) {
    const size_t ioff = static_cast<size_t>(item) * k * cb;
    for (int j = p.n_blocks - 1; j >= 0; --j) {
      Block b;
      b.h = p.hb + static_cast<size_t>(j) * p.batch * k * cb + ioff;
      b.we = p.we + static_cast<size_t>(j) * cb * ch;
      b.wcat = p.wcat + static_cast<size_t>(j) * ch * 2 * cb;
      b.dh = p.dh + ioff;
      b.dskip = p.dskip + ioff;
      b.wpart = wpart + static_cast<size_t>(j) * wtiles * kTileFloats;
      b.csum = csum;
      const float* stj = p.st + (static_cast<size_t>(j) * p.batch + item) * 4;
      b.mu1 = stj[0];
      b.s1 = stj[1];
      b.mu2 = stj[2];
      b.s2 = stj[3];
      b.dil = p.dils[j];
      b.first = j == p.n_blocks - 1;
      const int buf_bytes = staging_buffer_bytes(p.taps, b.dil);
      // the previous block is done with the coefficients (the barrier before
      // its P6, and P6's epilogues end on a block barrier)
      load_coefs(cf, p.vecs + static_cast<size_t>(j) * kVecRows * vdim,
                 p.wdw + static_cast<size_t>(j) * p.taps * ch, vdim, ch, p.taps);
      for (int i = threadIdx.x; i < vrows * vdim; i += kThreads) csum[i] = 0.f;
      __syncthreads();
      lap(kLapCoefs);

      // P1
      for (int tile = rank; tile < tiles; tile += p.ctas)
        recompute_t1(p, cf, b, t1, tile * kEngRows, acc, smem);
      lap(kLapT1);
      barrier(arrivals);  // t1's halo comes from other CTAs

      // P2
      recompute_d<kT>(p, cf, b, t1, d, rank, smem, buf_bytes);
      lap(kLapD);

      // P3
      float s = 0.f, sq = 0.f;  // this CTA's sums of dxh2 and dxh2 xh2
      for (int tile = rank; tile < tiles; tile += p.ctas) {
        const int row0 = tile * kEngRows;
        pack_drs(p, b, drs, row0, colred);
        lap(kLapPack);
#pragma unroll 1
        for (int col0 = 0; col0 < ch; col0 += kCols) {
          engine_tile<false, false, kCols>(acc, drs, 2 * cb, k, row0, b.wcat, 2 * cb, ch, col0, 2 * cb, smem);
          lap(kLapProject);
          stage_acc(acc, reinterpret_cast<float*>(smem));
          project_epilogue(p, cf, b, d, nd, dx, row0, col0, reinterpret_cast<const float*>(smem),
                           colred, s, sq);
          lap(kLapProjectOut);
        }
      }
      weight_grad(acc, p, rank, nd, ch, drs, 2 * cb, b.wpart, walked > 0, smem);
      lap(kLapWcat);
      // the dskip half of row 6: summed in the item's first block, kept
      for (int c = threadIdx.x; c < cb; c += kThreads) {
        if (b.first)
          skip_sums[c] = csum[6 * vdim + cb + c];
        else
          csum[6 * vdim + cb + c] = skip_sums[c];
      }
      block_sum2(s, sq, red);
      if (threadIdx.x == 0) part2[rank] = make_float2(s, sq);
      barrier(arrivals);  // the gLN2 means
      group_means(part2, p.ctas, inv_n, red, means);
      const float ma2 = means[0], mb2 = means[1];

      // P4
      dd_rows(p, cf, b, d, dx, dd, rank, ma2, mb2, colred, smem);
      lap(kLapDd);
      barrier(arrivals);  // dd's halo comes from other CTAs

      // P5
      s = 0.f;
      sq = 0.f;
      taps_bwd<kT>(p, cf, b, dd, t1, dx, rank, colred, smem, buf_bytes, s, sq);
      block_sum2(s, sq, red);
      if (threadIdx.x == 0) part1[rank] = make_float2(s, sq);
      lap(kLapTaps);
      barrier(arrivals);  // the gLN1 means
      group_means(part1, p.ctas, inv_n, red, means);
      const float ma1 = means[0], mb1 = means[1];

      // P6
      for (int tile = rank; tile < tiles; tile += p.ctas) {
        const int row0 = tile * kEngRows;
#pragma unroll 1
        for (int col0 = 0; col0 < ch; col0 += kCols) {
          engine_tile<false, true, kCols>(acc, b.h, cb, k, row0, b.we, ch, ch, col0, cb, smem);
          lap(kLapExpand);
          stage_acc(acc, reinterpret_cast<float*>(smem));
          expand_epilogue(p, cf, b, dx, nd, row0, col0, ma1, mb1,
                          reinterpret_cast<const float*>(smem), colred);
          lap(kLapExpandOut);
        }
#pragma unroll 1
        for (int col0 = 0; col0 < cb; col0 += kCols) {
          engine_tile<false, false, kCols>(acc, nd, ch, k, row0, b.we, ch, cb, col0, ch, smem);
          stage_acc(acc, reinterpret_cast<float*>(smem));
          dh_epilogue(p, b, row0, col0, reinterpret_cast<const float*>(smem));
        }
        lap(kLapDh);
      }
      weight_grad(acc, p, rank, b.h, cb, nd, ch,
                  b.wpart + static_cast<size_t>(cat_tiles) * kTileFloats, walked > 0, smem);
      lap(kLapWe);
      // the block's column sums into this CTA's partial (each value of it
      // added by one thread: no barrier needed before the next block's zeroing
      // but the one after its coefficients)
      float* vp = vpart + static_cast<size_t>(j) * vrows * vdim;
#pragma unroll 1
      for (int i0 = threadIdx.x; i0 < vrows * vdim; i0 += 4 * kThreads) {
        float old[4];  // four loads in flight
#pragma unroll
        for (int u = 0; u < 4; ++u) old[u] = i0 + u * kThreads < vrows * vdim ? vp[i0 + u * kThreads] : 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i0 + u * kThreads < vrows * vdim)
            vp[i0 + u * kThreads] = __fadd_rn(old[u], csum[i0 + u * kThreads]);
      }
      __syncthreads();
    }
  }

  // every CTA's partials are in: the final sums
  group_arrive(p.counters + p.groups);
  group_wait(p.counters + p.groups, gridDim.x);
  lap(kLapWait);
  final_sums(p, wtiles, cat_tiles, vrows);
  lap(kLapFinal);
  if (timed && threadIdx.x == 0) {
    for (int i = 0; i < kLaps; ++i) p.timing[blockIdx.x * kLaps + i] = spent[i];
  }
}

// The staging area (the product's ring, or P5's two pairs of buffers at the
// largest dilation), then the block's Coefs and the column-sum exchange
// (python: backward_smem_bytes).
int staging_bytes(int taps, int max_dil) {
  const int four = 4 * staging_buffer_bytes(taps, max_dil);
  const int slots = 4 * kSlotBytes > kRingBytes ? 4 * kSlotBytes : kRingBytes;
  return four > slots ? four : slots;
}

size_t coef_bytes(int cb, int ch, int vdim, int taps) {
  return static_cast<size_t>((8 + taps) * ch + kColRed + (kVecRows + taps) * vdim + cb) *
         sizeof(float);
}

template <int kT, bool kTimed>
int launch(const BwdParams& p, size_t smem, cudaStream_t s) {
  auto kernel = backward_kernel<kT, kTimed>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {const_cast<BwdParams*>(&p)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(p.groups * p.ctas), dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it; the caller raises on the code
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The trunk's backward in one cooperative launch of groups x ctas CTAs
// (ops/tcn_train_cuda.py::backward_plan). hb [N, B, K, cb] bf16 and st [N, B,
// 4] fp32: the training forward's residuals (sst_tcn_trunk_train); dskip [B,
// K, cb] fp32; we [N, cb, ch] and wcat [N, ch, 2 cb] bf16, wdw [N, taps, ch]
// and vecs [N, 10, vdim] fp32 (stack_canonical); dils a host array of N <=
// 256 dilations. Outputs (fp32, each overwritten): dh [B, K, cb] (dh0), dwe,
// dwdw, dwcat and dvec of the canonical arrays' shapes. Scratch: slabs bf16,
// t1, d, n2/dt1p, dxh2/dxh1 and dd [groups, K, ch] each, then drs [groups, K,
// 2 cb]; part [groups, 2, ctas] float2; wpart [grid, N, wtiles, 128 x 128]
// and vpart [grid, N, 10 + taps, vdim] fp32 (wtiles = ceil(ch / 128) ceil(2
// cb / 128) + ceil(cb / 128) ceil(ch / 128)); counters [groups + 1] int32
// holding zeros; timing null or [groups ctas, 15] int64 (Lap). cb and ch
// multiples of 8, taps <= 8. Returns the launch's CUDA error (a refused
// cooperative launch included), or 0.
extern "C" int sst_tcn_trunk_backward(const void* hb, const void* st, const void* dskip, void* dh,
                                      const void* we, const void* wdw,
                                      const void* wcat, const void* vecs, const int* dils,
                                      void* dwe, void* dwdw, void* dwcat, void* dvec, void* slabs,
                                      void* part, void* wpart, void* vpart, void* counters,
                                      void* timing, int batch, int k, int cb, int ch, int vdim,
                                      int taps, int n_blocks, int groups, int ctas, void* stream) {
  if (batch < 1 || k < 1 || cb < 8 || ch < 8 || cb % 8 || ch % 8 || taps < 1 ||
      taps > kMaxTaps || n_blocks < 1 || n_blocks > kMaxBlocks || groups < 1 || groups > batch ||
      ctas < 1 || ctas > (k + kEngRows - 1) / kEngRows || vdim < ch || vdim < 2 * cb)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{};
  p.hb = static_cast<const bf16*>(hb);
  p.st = static_cast<const float*>(st);
  p.dskip = static_cast<const float*>(dskip);
  p.dh = static_cast<float*>(dh);
  p.we = static_cast<const bf16*>(we);
  p.wcat = static_cast<const bf16*>(wcat);
  p.wdw = static_cast<const float*>(wdw);
  p.vecs = static_cast<const float*>(vecs);
  p.dwe = static_cast<float*>(dwe);
  p.dwdw = static_cast<float*>(dwdw);
  p.dwcat = static_cast<float*>(dwcat);
  p.dvec = static_cast<float*>(dvec);
  const size_t gkc = static_cast<size_t>(groups) * k * ch;
  p.t1 = static_cast<bf16*>(slabs);
  p.d = p.t1 + gkc;
  p.nd = p.d + gkc;
  p.dx = p.nd + gkc;
  p.dd = p.dx + gkc;
  p.drs = p.dd + gkc;
  p.part = static_cast<float2*>(part);
  p.wpart = static_cast<float*>(wpart);
  p.vpart = static_cast<float*>(vpart);
  p.counters = static_cast<int*>(counters);
  p.timing = static_cast<long long*>(timing);
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
  const size_t smem = 1024 + p.staging + coef_bytes(cb, ch, vdim, taps);  // 1,024 for the alignment
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the laps are compiled in only where a timing buffer is passed
  if (p.timing != nullptr)
    return taps <= 3 ? launch<3, true>(p, smem, s) : launch<kMaxTaps, true>(p, smem, s);
  return taps <= 3 ? launch<3, false>(p, smem, s) : launch<kMaxTaps, false>(p, smem, s);
}
