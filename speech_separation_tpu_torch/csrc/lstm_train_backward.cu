// Backward through time of a (Bi)LSTM layer, for Hopper, sm_90a: one
// persistent cooperative launch over all steps.
//
// Replaces the Pallas TPU kernel speech_separation_tpu/ops/lstm_train_pallas.py
// (_bwd_call, body _make_bwd_kernel, packed variant included), the backward
// half of bilstm_train_pallas's custom_vjp. From the training forward's
// residuals (post-activation gates i, f, g, o in the compute type and c in
// fp32, written by sst_lstm_train_forward in lstm_recurrence.cu) and the
// upstream gradient dy of the hidden states, it walks each direction against
// its own scan order and emits the pre-activation gate gradients dgates:
//   dh  = dy_t + keep_{s+1} * (dgates_{s+1} @ U^T)      (the dh carry)
//   do  = dh * tanh(c) * o * (1 - o)
//   dc  = dc_carry + dh * o * (1 - tanh(c)^2)
//   di  = dc * g * i * (1 - i)
//   df  = dc * c_prev * f * (1 - f)       c_prev = keep_s * c of the step before
//   dg  = dc * i * (1 - g^2)
//   dc_carry = dc * f * keep_s
// with the (dh, dc) carries in fp32 and dgates stored in the compute type;
// the product reads the stored (rounded) dgates, as the reference does. The
// weight, bias and input gradients are large matrix products outside this
// kernel, as in the reference.
//
// Layout: gates, c_all and dgates are [D, B, T, .] and dy is [B, T, D * H],
// all indexed by real time t; a direction whose bit is set in reverse_mask
// scanned time backwards in the forward, so its "step before" is t + 1 and
// its backward walks t from 0 up. The keep gate [D, B, T] is indexed by scan
// step, as in the reference.
//
// What bounds it on this card: the recurrence is sequential over T steps;
// each step is a product [B, 4H] x [4H, H] per direction (1 M fp32 FMAs a
// direction at B = 32, H = 496), about 2 us of the card's fp32 FMA rate, so
// the step's latency (a barrier, the L2 round trip of dgates_{s+1}) matters
// as much as its arithmetic.
//
// What the design does about it (the TPU kernel kept U^T and both carries
// in VMEM across its sequential grid; here the grid is parallel):
// - one cooperative launch for all T steps; the grid is directions x row
//   blocks (groups of 16 batch rows) x unit slices (16 hidden units), every
//   block resident at once (cudaLaunchCooperativeKernel refuses a grid that
//   cannot be, rather than deadlock). ops/lstm_train_cuda.py::backward_plan
//   picks the groups a block owns and whether U stays in shared memory from
//   the card's SM count and shared memory;
// - a block keeps its slice U[d, j0:j0+16, :] in shared memory for the whole
//   call (128 KB fp32 at H = 496), so U is read from device memory once a
//   call, not once a step; where the slice does not fit (fp32, large H), the
//   same kernel streams it from L2 beside the dgates chunks instead;
// - each (direction, row, unit) is owned by one thread for the whole call,
//   so the dc carry lives in that thread's registers, and the thread loads
//   what its gate backward reads (gates, c, dy, keep) before the step's
//   barrier, so that latency overlaps the wait and the product;
// - a step waits at a barrier shared only by the blocks of its (direction,
//   row block): a monotone arrival counter in device memory, released on
//   arrival and acquired on the spin; dgates_{s+1} is then read in chunks
//   that bypass L1 (not coherent across SMs: a stale line would give a
//   wrong dh and no error): in fp32 256 columns at a time with cp.async.cg
//   into a ring of three buffers, two chunks ahead of the product; in bf16
//   (rows only 8-byte aligned at odd H, too little for cp.async.cg) 1,024
//   columns at a time with ld.global.cg through registers, one chunk ahead,
//   so a step at H = 496 waits on two round trips to L2 instead of eight;
// - fp32: plain FMA (no TF32), each lane an 8-row x 8-unit tile over an
//   eighth of its warp's 32 columns, every operand a 4-byte shared load that
//   2 or 4 lanes share, then a shuffle reduce-scatter; bf16:
//   mma.sync.m16n8k16 with fp32 accumulators (two n8 tiles). Both need more
//   than 128 registers a thread (the fp32 tile, the bf16 chunk in flight),
//   so both run one block an SM. The eight warps' partial sums are added in
//   a fixed order, and nothing on the data uses atomics, so reruns are
//   bit-identical.
// What still bounds it (scripts/torch_probe_lstm.py times it with
// the product or the loads switched off): in fp32 the product, then the
// per-step barrier and gate backward, then the L2 reads (each of the H/16
// blocks of a row group re-reads all of dgates_{s+1}); in bf16 the reads
// and the barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// Switches for scripts/torch_probe_lstm.py, which builds copies with
// -D flags; the port's build sets none. SST_BWD_SKIP_PRODUCT and
// SST_BWD_SKIP_LOADS leave out each step's product or its dgates loads (the
// copy's dgates are wrong by design); SST_BWD_FP32_BLOCKS_PER_SM,
// SST_BWD_BF16_BLOCKS_PER_SM and SST_BWD_TILE_UNROLL set the launch bounds'
// blocks an SM and the fp32 tile's column-loop unroll.
#ifndef SST_BWD_SKIP_PRODUCT
#define SST_BWD_SKIP_PRODUCT 0
#endif
#ifndef SST_BWD_SKIP_LOADS
#define SST_BWD_SKIP_LOADS 0
#endif
#ifndef SST_BWD_FP32_BLOCKS_PER_SM
#define SST_BWD_FP32_BLOCKS_PER_SM 1
#endif
#ifndef SST_BWD_BF16_BLOCKS_PER_SM
#define SST_BWD_BF16_BLOCKS_PER_SM 1
#endif
#ifndef SST_BWD_TILE_UNROLL
#define SST_BWD_TILE_UNROLL 2
#endif
#ifndef SST_BWD_BF16_CHUNK
#define SST_BWD_BF16_CHUNK 1024
#endif

namespace {

constexpr bool kProduct = !SST_BWD_SKIP_PRODUCT;
constexpr bool kLoads = !SST_BWD_SKIP_LOADS;
constexpr int kTileUnroll = SST_BWD_TILE_UNROLL;

constexpr int kRows = 16;      // batch rows of a group
constexpr int kUnits = 16;     // hidden units of a block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 16;  // row groups a block may own: B <= 256
constexpr int kPartialBytes = kWarps * kRows * kUnits * 4;

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using Vec = float4;  // four elements
  static constexpr int kPad = 8;  // row strides = 8 (mod 32) words: no bank conflicts
  static constexpr int kAcc = 64;  // a lane's sums in chunk_product
};
template <>
struct Elem<__nv_bfloat16> {
  using Vec = uint2;
  static constexpr int kPad = 8;  // row strides = 4 (mod 32) words
  static constexpr int kAcc = 8;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float4 zero_vec(float4) { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ uint2 zero_vec(uint2) { return make_uint2(0u, 0u); }

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void arrive_release(int* p) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(1) : "memory");
}

// Columns of 4H staged at a time: fp32 256 (a ring of three buffers), bf16
// a multiple of 256 (one buffer filled through registers: the wider, the
// fewer round trips to L2 a step, each thread holding chunk / 64 loads).
template <typename T>
constexpr int kChunk = sizeof(T) == 4 ? 256 : SST_BWD_BF16_CHUNK;
static_assert(SST_BWD_BF16_CHUNK % 256 == 0, "bf16 chunks are whole 256-column tiles");

template <typename T>
__host__ __device__ inline int padded_columns(int hidden) {
  return (4 * hidden + kChunk<T> - 1) / kChunk<T> * kChunk<T>;
}

// fp32 stages dgates with cp.async into a ring of three buffers, two chunks
// ahead of the product (its rows are 16-byte aligned at every H, and its
// product needs the registers); bf16 through registers into one buffer.
template <typename T>
constexpr int kBuffers = sizeof(T) == 4 ? 3 : 1;

// Blocks an SM the launch bounds leave registers for: the fp32 8 x 8 tile
// needs more than 128 a thread (at 128 it spills, and runs ~1.5x slower),
// and so does bf16's 1,024-column chunk in flight (16 8-byte loads a thread).
template <typename T>
constexpr int kBlocksPerSm =
    sizeof(T) == 4 ? SST_BWD_FP32_BLOCKS_PER_SM : SST_BWD_BF16_BLOCKS_PER_SM;

// Dynamic shared memory: warp partials, the staging buffers (a dgates chunk,
// and a chunk of U when U is streamed), then U's slice when resident.
template <typename T>
__host__ __device__ inline size_t smem_bytes(int hidden, bool resident) {
  const size_t as = kChunk<T> + Elem<T>::kPad;
  const size_t buffer = kRows * as + (resident ? 0 : kUnits * as);
  const size_t u_res = resident ? kUnits * (padded_columns<T>(hidden) + Elem<T>::kPad) : 0;
  return kPartialBytes + sizeof(T) * (kBuffers<T> * buffer + u_res);
}

// 16 bytes from device memory to shared memory without passing through L1
// (cp.async.cg), zero-filled where `valid` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// fp32: lane (ks, rs, uq) = (lane % 8, lane / 8 % 2, lane / 16) accumulates
// rows rs + 2 i (i < 8) by units uq + 2 n (n < 8) over columns 32 w + ks + 8 m
// (m < 4) of the chunk. Every operand is a 4-byte load that 2 or 4 lanes
// share (one shared-memory pass each: rows are 8 (mod 32) words apart), so 16
// passes feed 64 FMAs a lane, as many as the SM's FMA pipes take in that
// time; the 8 lanes of a (rs, uq) are summed in store_partials.
__device__ __forceinline__ void chunk_product(const float* sa, const float* ub, int us,
                                              float (&acc)[64], int warp, int lane) {
  constexpr int as = kChunk<float> + Elem<float>::kPad;
  const int ks = lane & 7;
  const int rs = (lane >> 3) & 1;
  const int uq = lane >> 4;
  const float* a_col = sa + rs * as + warp * 32 + ks;
  const float* b_col = ub + uq * us + warp * 32 + ks;
#pragma unroll (kTileUnroll)
  for (int m = 0; m < 4; ++m) {
    float a[8];
    float b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = a_col[2 * i * as + 8 * m];
#pragma unroll
    for (int n = 0; n < 8; ++n) b[n] = b_col[2 * n * us + 8 * m];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[8 * i + n] = fmaf(a[i], b[n], acc[8 * i + n]);
  }
}

// bf16: one m16n8k16 tile of the 16 rows for each 8 of the 16 units, over
// the warp's 32 columns of each 256 of the chunk; acc[4 nt + r] is fragment
// register c_r of tile nt.
__device__ __forceinline__ void chunk_product(const __nv_bfloat16* sa, const __nv_bfloat16* ub,
                                              int us, float (&acc)[8], int warp, int lane) {
  constexpr int as32 = (kChunk<__nv_bfloat16> + Elem<__nv_bfloat16>::kPad) / 2;
  const uint32_t* a32 = reinterpret_cast<const uint32_t*>(sa);
  const uint32_t* u32 = reinterpret_cast<const uint32_t*>(ub);
  const int us32 = us / 2;
  const int g = lane >> 2;
  const int c = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kChunk<__nv_bfloat16> / 128; ++ks) {
    const int kb = (ks / 2 * 256 + warp * 32 + ks % 2 * 16) / 2;
    const uint32_t a0 = a32[g * as32 + kb + c];
    const uint32_t a1 = a32[(g + 8) * as32 + kb + c];
    const uint32_t a2 = a32[g * as32 + kb + 4 + c];
    const uint32_t a3 = a32[(g + 8) * as32 + kb + 4 + c];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int n = nt * 8 + g;
      const uint32_t b0 = u32[n * us32 + kb + c];
      const uint32_t b1 = u32[n * us32 + kb + 4 + c];
      float* d = acc + 4 * nt;
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
}

// One reduce-scatter round between lanes `bit` apart: of `2 half` sums, a
// lane keeps the half its bit selects and adds its partner's copy of it.
template <int kHalf>
__device__ __forceinline__ void reduce_half(const float* in, float* out, int lane, int bit) {
  const bool hi = lane & bit;
#pragma unroll
  for (int q = 0; q < kHalf; ++q) {
    const float send = hi ? in[q] : in[q + kHalf];
    out[q] = (hi ? in[q + kHalf] : in[q]) + __shfl_xor_sync(0xffffffffu, send, bit);
  }
}

// partial[warp][row][unit] from a lane's accumulators. fp32: the 8 lanes of
// a (rs, uq) reduce-scatter their 64 sums (rows i = 8 q / 64) in three
// shuffle rounds, so lane ks ends with row i = ks, every unit, and every sum
// is added in the same order on every run.
__device__ __forceinline__ void store_partials(float* partial, float (&acc)[64], int warp,
                                               int lane) {
  float r4[32];
  float r2[16];
  float r1[8];
  reduce_half<32>(acc, r4, lane, 4);
  reduce_half<16>(r4, r2, lane, 2);
  reduce_half<8>(r2, r1, lane, 1);
  const int ks = lane & 7;
  const int rs = (lane >> 3) & 1;
  const int uq = lane >> 4;
  float* p = partial + warp * kRows * kUnits + (rs + 2 * ks) * kUnits + uq;
#pragma unroll
  for (int n = 0; n < 8; ++n) p[2 * n] = r1[n];
}

// bf16: acc[4 nt + r] is mma fragment register c_r of tile nt (units 8 nt ..).
__device__ __forceinline__ void store_partials(float* partial, float (&acc)[8], int warp,
                                               int lane) {
  float* p = partial + warp * kRows * kUnits;
  const int g = lane >> 2;
  const int c = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int u = nt * 8 + 2 * c;
    p[g * kUnits + u] = acc[4 * nt];
    p[g * kUnits + u + 1] = acc[4 * nt + 1];
    p[(g + 8) * kUnits + u] = acc[4 * nt + 2];
    p[(g + 8) * kUnits + u + 1] = acc[4 * nt + 3];
  }
}

// gates [D, B, T, 4H], dgates [D, B, T, 4H], u [D, H, 4H], dy [B, T, D * H]
// in T; c_all [D, B, T, H], keep [D, B, T] fp32; counters [D, row blocks]
// int32, zero at the launch. Grid (unit slices, row blocks, D); a row block
// is `groups` groups of 16 rows.
template <typename T, bool kKeep>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<T>)
lstm_bwd_persistent_kernel(const T* __restrict__ gates, const float* __restrict__ c_all,
                           const T* __restrict__ dy, const T* __restrict__ u,
                           const float* __restrict__ keep, T* dgates, int* counters, int batch,
                           int steps, int hidden, int reverse_mask, int groups, int resident) {
  using Vec = typename Elem<T>::Vec;
  constexpr int pad = Elem<T>::kPad;
  constexpr int chunk = kChunk<T>;
  constexpr int as = chunk + pad;
  constexpr int vecs_a = kRows * chunk / 4 / kThreads;   // fp32 4 a thread, bf16 chunk / 64
  constexpr int vecs_u = kUnits * chunk / 4 / kThreads;  // 4 a thread (fp32, U streamed)
  extern __shared__ float4 smem4[];
  float* partial = reinterpret_cast<float*>(smem4);

  const int d = blockIdx.z;
  const int dirs = gridDim.z;
  const int j0 = blockIdx.x * kUnits;
  const int g4h = 4 * hidden;
  const int k_pad = padded_columns<T>(hidden);
  const int nchunks = k_pad / chunk;
  const int us = resident ? k_pad + pad : as;
  const int buffer = kRows * as + (resident ? 0 : kUnits * as);  // one staging buffer
  T* bufs = reinterpret_cast<T*>(reinterpret_cast<char*>(smem4) + kPartialBytes);
  T* su_res = bufs + kBuffers<T> * buffer;  // U's slice, when resident
  const bool rev = (reverse_mask >> d) & 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* ud = u + static_cast<size_t>(d) * hidden * g4h;
  int* counter = counters + d * gridDim.y + blockIdx.y;
  const int arrivals = gridDim.x;

  if (resident) {  // the block's U slice, once for the call, zero past H and 4H
    const int per_row = k_pad / 4;
    for (int v = threadIdx.x; v < kUnits * per_row; v += kThreads) {
      const int unit = v / per_row;
      const int k = 4 * (v - unit * per_row);
      const int j = j0 + unit;
      *reinterpret_cast<Vec*>(su_res + unit * us + k) =
          (j < hidden && k < g4h) ? __ldg(reinterpret_cast<const Vec*>(ud + static_cast<size_t>(j) * g4h + k))
                                  : zero_vec(Vec{});
    }
  }

  float dc[kMaxGroups];
#pragma unroll
  for (int i = 0; i < kMaxGroups; ++i) dc[i] = 0.f;
  const int r = threadIdx.x / kUnits;  // the (row, unit) this thread owns in each group
  const int jj = threadIdx.x % kUnits;
  const int j = j0 + jj;

  // What the gate backward of (row, unit) reads besides dh: loaded before the
  // barrier (group 0) or before the group's product, so their latency from
  // device memory overlaps the wait and the product instead of following it.
  struct GateIn {
    float ig, fg, gg, og, c, c_prev, dy, k_step, k_next;
  };
  auto gate_inputs = [&](int g, int step, int t) {
    GateIn in{};
    const int rb = (blockIdx.y * groups + g) * kRows + r;
    if (rb < batch && j < hidden) {
      const size_t base = (static_cast<size_t>(d) * batch + rb) * steps;  // row (d, rb) of [D, B, T]
      const size_t row = base + t;
      const T* g4 = gates + row * g4h;
      in.ig = to_float(g4[j]);
      in.fg = to_float(g4[hidden + j]);
      in.gg = to_float(g4[2 * hidden + j]);
      in.og = to_float(g4[3 * hidden + j]);
      in.c = c_all[row * hidden + j];
      in.c_prev = step >= 1 ? c_all[(base + (rev ? t + 1 : t - 1)) * hidden + j] : 0.f;
      in.dy = to_float(dy[(static_cast<size_t>(rb) * steps + t) * dirs * hidden + d * hidden + j]);
      in.k_step = kKeep ? keep[base + step] : 1.f;
      in.k_next = (kKeep && step + 1 < steps) ? keep[base + step + 1] : 1.f;
    }
    return in;
  };

  for (int step = steps - 1; step >= 0; --step) {
    const int t = rev ? steps - 1 - step : step;
    const bool product = step + 1 < steps;
    const int t_next = rev ? t - 1 : t + 1;
    GateIn in = gate_inputs(0, step, t);
    if (product) {  // every block of this (direction, row block) has written step + 1
      if (threadIdx.x == 0) {
        const int target = (steps - 1 - step) * arrivals;
        // the acquire orders this block's later loads after the arrivals'
        // writes, and the block barrier hands that on to every thread; a
        // barrier that never fills (a fault elsewhere) ends the launch with an
        // error after a few seconds instead of holding the card
        for (long spins = 0; load_acquire(counter) < target; ++spins)
          if (spins > (1L << 24)) __trap();
      }
      __syncthreads();
    }
    for (int g = 0; g < groups; ++g) {
      const int b0 = (blockIdx.y * groups + g) * kRows;
      if (b0 >= batch) break;
      if (g > 0) in = gate_inputs(g, step, t);
      if (product) {
        float acc[Elem<T>::kAcc];
#pragma unroll
        for (int i = 0; i < Elem<T>::kAcc; ++i) acc[i] = 0.f;
        const size_t row0 = static_cast<size_t>(d) * batch * steps + t_next;  // (d, b = 0, t_next)
        if constexpr (kBuffers<T> == 3) {
          // chunk c into buffer c % 3 with cp.async, one commit group a chunk
          // (empty past the last), two chunks ahead of the product
          auto issue = [&](int c) {
            T* sa = bufs + (c % 3) * buffer;
#pragma unroll
            for (int m = 0; m < vecs_a; ++m) {
              const int v = threadIdx.x + kThreads * m;
              const int row = v / (chunk / 4);
              const int k = c * chunk + 4 * (v % (chunk / 4));
              const bool ok = b0 + row < batch && k < g4h;
              const T* src = dgates + (row0 + static_cast<size_t>(b0 + row) * steps) * g4h + k;
              cp_async16(sa + row * as + k - c * chunk, ok ? src : dgates, ok);
            }
            if (!resident) {
#pragma unroll
              for (int m = 0; m < vecs_u; ++m) {
                const int v = threadIdx.x + kThreads * m;
                const int unit = v / (chunk / 4);
                const int k = c * chunk + 4 * (v % (chunk / 4));
                const bool ok = j0 + unit < hidden && k < g4h;
                const T* src = ud + static_cast<size_t>(j0 + unit) * g4h + k;
                cp_async16(sa + kRows * as + unit * as + k - c * chunk, ok ? src : ud, ok);
              }
            }
          };
          if (kLoads) issue(0);
          asm volatile("cp.async.commit_group;" ::: "memory");
          if (kLoads && nchunks > 1) issue(1);
          asm volatile("cp.async.commit_group;" ::: "memory");
          for (int c = 0; c < nchunks; ++c) {
            // this thread's copies of chunk c have landed (those of c + 1 may not),
            asm volatile("cp.async.wait_group 1;" ::: "memory");
            // everyone's have, and chunk c - 1's buffer is free again
            __syncthreads();
            if (kLoads && c + 2 < nchunks) issue(c + 2);
            asm volatile("cp.async.commit_group;" ::: "memory");
            const T* sa = bufs + (c % 3) * buffer;
            if (kProduct)
              chunk_product(sa, resident ? su_res + c * chunk : sa + kRows * as, us, acc,
                            warp, lane);
          }
          __syncthreads();  // the last chunk is consumed before its buffer is reused
        } else {
          // through registers: chunk c + 1's loads in flight during c's product
          // (bf16 keeps U resident: its slice fits at every H <= 1024); at
          // H <= 512 a step is two chunks
          T* sa = bufs;
          Vec ra[vecs_a];
          auto fetch = [&](int k0) {
#pragma unroll
            for (int m = 0; m < vecs_a; ++m) {
              const int v = threadIdx.x + kThreads * m;
              const int row = v / (chunk / 4);
              const int k = k0 + 4 * (v % (chunk / 4));
              ra[m] = (b0 + row < batch && k < g4h)
                          ? __ldcg(reinterpret_cast<const Vec*>(
                                dgates + (row0 + static_cast<size_t>(b0 + row) * steps) * g4h + k))
                          : zero_vec(Vec{});
            }
          };
          if (kLoads) fetch(0);
          for (int c = 0; c < nchunks; ++c) {
#pragma unroll
            for (int m = 0; m < vecs_a; ++m) {
              const int v = threadIdx.x + kThreads * m;
              *reinterpret_cast<Vec*>(sa + (v / (chunk / 4)) * as + 4 * (v % (chunk / 4))) = ra[m];
            }
            __syncthreads();
            if (kLoads && c + 1 < nchunks) fetch((c + 1) * chunk);  // in flight during the product
            if (kProduct) chunk_product(sa, su_res + c * chunk, us, acc, warp, lane);
            __syncthreads();
          }
        }
        store_partials(partial, acc, warp, lane);
        __syncthreads();
      }

      float carry = 0.f;  // dc[g], selected without indexing the array at run time
#pragma unroll
      for (int i = 0; i < kMaxGroups; ++i)
        if (i == g) carry = dc[i];
      if (b0 + r < batch && j < hidden) {
        float dh_next = 0.f;
        if (product) {
#pragma unroll
          for (int w = 0; w < kWarps; ++w) dh_next += partial[(w * kRows + r) * kUnits + jj];
        }
        const float th = tanhf(in.c);
        const float cp = in.c_prev * in.k_step;
        const float dh = in.dy + dh_next * in.k_next;
        const float d_o = dh * th * in.og * (1.f - in.og);
        const float dcv = carry + dh * in.og * (1.f - th * th);
        const float d_i = dcv * in.gg * in.ig * (1.f - in.ig);
        const float d_f = dcv * cp * in.fg * (1.f - in.fg);
        const float d_g = dcv * in.ig * (1.f - in.gg * in.gg);
        T* dg4 = dgates + ((static_cast<size_t>(d) * batch + b0 + r) * steps + t) * g4h;
        dg4[j] = from_float<T>(d_i);
        dg4[hidden + j] = from_float<T>(d_f);
        dg4[2 * hidden + j] = from_float<T>(d_g);
        dg4[3 * hidden + j] = from_float<T>(d_o);
        carry = dcv * in.fg * in.k_step;
      }
#pragma unroll
      for (int i = 0; i < kMaxGroups; ++i)
        if (i == g) dc[i] = carry;
    }
    __syncthreads();  // the block's dgates of this step are written
    if (threadIdx.x == 0) arrive_release(counter);  // release: they are visible first
  }
}

template <typename T, bool kKeep>
int launch(const void* gates, const void* c_all, const void* dy, const void* u, const void* keep,
           void* dgates, void* counters, int dirs, int batch, int steps, int hidden,
           int reverse_mask, int groups, int resident, cudaStream_t stream) {
  if (kBuffers<T> == 1 && !resident)  // bf16 stages only dgates: U must be resident
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(hidden, resident != 0);
  auto kernel = lstm_bwd_persistent_kernel<T, kKeep>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((hidden + kUnits - 1) / kUnits,
                  (batch + groups * kRows - 1) / (groups * kRows), dirs);
  const T* g_ = static_cast<const T*>(gates);
  const float* c_ = static_cast<const float*>(c_all);
  const T* dy_ = static_cast<const T*>(dy);
  const T* u_ = static_cast<const T*>(u);
  const float* k_ = static_cast<const float*>(keep);
  T* dg_ = static_cast<T*>(dgates);
  int* ctr_ = static_cast<int*>(counters);
  void* args[] = {&g_, &c_, &dy_, &u_, &k_, &dg_, &ctr_, &batch, &steps, &hidden,
                  &reverse_mask, &groups, &resident};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid, dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it; the caller raises on the code
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* gates, const void* c_all, const void* dy, const void* u, const void* keep,
        void* dgates, void* counters, int dirs, int batch, int steps, int hidden,
        int reverse_mask, int groups, int resident, cudaStream_t stream) {
  if (keep)
    return launch<T, true>(gates, c_all, dy, u, keep, dgates, counters, dirs, batch, steps,
                           hidden, reverse_mask, groups, resident, stream);
  return launch<T, false>(gates, c_all, dy, u, nullptr, dgates, counters, dirs, batch, steps,
                          hidden, reverse_mask, groups, resident, stream);
}

}  // namespace

// Runs all `steps` steps, last scan step first, in one cooperative launch.
// keep may be null; counters [dirs, row blocks] int32 must hold zeros.
// bf16 != 0 selects __nv_bfloat16 gates, dy, u and dgates; otherwise fp32.
// groups (1 to 16 groups of 16 rows a block) and resident (U kept in shared
// memory) come from the caller's launch plan; the shared memory a block takes
// follows from them (smem_bytes). Returns the launch's error,
// cudaErrorInvalidValue for an inconsistent plan,
// cudaErrorCooperativeLaunchTooLarge for a grid that cannot be resident at
// once, or 0.
extern "C" int sst_lstm_train_backward(const void* gates, const void* c_all, const void* dy,
                                       const void* u, const void* keep, void* dgates,
                                       void* counters, int dirs, int batch, int steps, int hidden,
                                       int reverse_mask, int bf16, int groups, int resident,
                                       void* stream) {
  if (groups < 1 || groups > kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run<__nv_bfloat16>(gates, c_all, dy, u, keep, dgates, counters, dirs, batch, steps,
                              hidden, reverse_mask, groups, resident, s);
  return run<float>(gates, c_all, dy, u, keep, dgates, counters, dirs, batch, steps, hidden,
                    reverse_mask, groups, resident, s);
}
