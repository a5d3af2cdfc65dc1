// LSTM recurrence over precomputed input projections, for Hopper, sm_90a:
// one persistent cooperative launch over all time steps and both directions.
//
// Replaces two Pallas TPU kernels:
// - speech_separation_tpu/ops/lstm_pallas.py (lstm_pallas, body _make_kernel),
//   the serving recurrence that models/upit.py::upit_blstm_pallas_forward runs
//   (entry sst_lstm_recurrence);
// - the training forward of speech_separation_tpu/ops/lstm_train_pallas.py
//   (_fwd_call, body _make_fwd_kernel, packed variant included), which
//   models/upit.py::upit_blstm_train_forward runs (entry
//   sst_lstm_train_forward): the same recurrence, plus residual stores of the
//   post-activation gates (compute type) and of c (fp32) for the backward in
//   lstm_train_backward.cu, and an optional keep gate.
// Per step and direction:
//   z = xw_t + h @ U            (Keras gate order i, f, g, o along 4H)
//   c = sigmoid(z_f) * c + sigmoid(z_i) * tanh(z_g)
//   h = sigmoid(z_o) * tanh(c)
// with the (h, c) carry in fp32 and h rounded to the compute type (fp32 or
// bf16) before the product, as lstm_pallas does. Products of compute-type
// operands are exact in fp32 and accumulate in fp32. With a keep gate
// (sequence-packed rows), the carry is multiplied by keep[d, b, step] before
// the step, so utterances that share a row never see each other's state.
//
// A direction whose bit is set in reverse_mask walks time backwards over the
// whole padded length, which is what the reference's flip, scan and flip back
// computes (models/blstm.py:111,139), without copying any tensor. Every
// tensor with a time axis is indexed by real time t; only the keep gate is
// indexed by the direction's own scan step, as in the reference.
//
// What bounds it on this card: the recurrence is sequential over T steps, and
// each step is a small product [B, H] x [H, 4H] per direction (1 M FMAs a
// direction at B = 32, H = 496; 8 M at B = 256). At the training shape a
// step's latency bounds it: a barrier between the SMs that share h, an L2
// round trip for h_{s-1}, a product split over a block's warps. At the
// serving shape the fp32 product itself does (1 GFLOP a step, ~15 us at the
// card's fp32 rate).
//
// What the design does about it (the TPU kernel kept U and the carry in VMEM
// across its sequential grid; here the grid is parallel):
// - one cooperative launch for all T steps; the grid is directions x row
//   blocks (groups of 16 batch rows) x unit slices (16 hidden units and their
//   four gate columns g * H + j, 64 columns of U), every block resident at
//   once (cudaLaunchCooperativeKernel refuses a grid that cannot be, and the
//   caller raises). ops/lstm_cuda.py::forward_plan picks the groups a block
//   owns, how many it multiplies in one pass, whether U stays in shared
//   memory and whether the next pass's inputs are copied ahead from the
//   card's SM count and shared memory, and cuts a batch into as few row
//   slices as the resident grid holds at 16 groups a block (2,048 rows at
//   H = 128, 512 at H = 496), one launch each: at small H a launch of 256
//   rows fills the card with blocks of 2 groups each, and slices that run
//   one after another pay the step's fixed cost (the barrier, the L2 round
//   trip, the syncs and the epilogue) once a slice, where one launch of
//   eight times the rows pays the barrier once and walks its groups in
//   passes;
// - a block keeps its U slice transposed in shared memory for the whole call
//   ([64][H + 8], 127 KB fp32 at H = 496), so U is read from device memory
//   once a call; where the fp32 slice does not fit (H > 608), the same kernel
//   reads U through L1 from L2 (U never changes during the call, so cached
//   loads are safe);
// - each (direction, row, unit) is owned by one thread for the whole call,
//   so the gate math, c and h stay in that thread and c lives in registers;
//   xw_t (and the keep value) is loaded before the step's barrier or the
//   pass's product, so its latency overlaps them;
// - h_{s-1} is read back from `out` itself at t -/+ 1, already rounded to the
//   compute type, so there is no ping-pong buffer. The blocks of a (direction,
//   row block) meet at a monotone arrival counter in device memory each step,
//   released on arrival and acquired on the spin (no other fence); a spin
//   that is never satisfied traps instead of holding the card. h_{s-1} is
//   copied with cp.async.cg, every copy of a pass in flight at once
//   (ld.global.cg where rows are not 16-byte aligned): both bypass L1, which
//   is not coherent across SMs, so a stale line cannot give a wrong h;
// - a pass multiplies 1, 2 (fp32) or up to 8 (bf16) groups, the eight warps
//   splitting each group's reduction 8 / pass ways, so a block's syncs and
//   partial sums are paid once a pass, not once a group;
// - where a block walks several passes a step and shared memory holds
//   second buffers of a pass (kAhead: fp32 at H = 128 takes 120 KB, not the
//   83 KB of one; at H = 496 there is no room), the next pass's h_{s-1} and
//   xw_t are copied (cp.async) right after this pass's have landed, into the
//   other buffers, so they arrive during this pass's product and epilogue:
//   only the first pass of a step waits on L2 for h_{s-1}, and no pass waits
//   on device memory for xw_t, which bf16 did at each pass's first use (the
//   conversion to fp32 stalled where the load was issued);
// - fp32: plain FMA (no TF32): each lane an 8-row x 8-column tile over
//   4-column chunks of the reduction, every operand a 16-byte shared load that
//   lanes share, then a shuffle reduce and the warps' partial sums; it needs
//   166 to 234 registers a thread (one or two groups a pass), so one block
//   an SM. bf16: mma.sync.m16n8k16 with fp32 accumulators, eight n8 tiles a
//   warp. Partial sums are added in a fixed order and nothing uses atomics,
//   so reruns are bit-identical;
// - the training mode, the keep gate, the groups a pass and the copies ahead
//   are template arguments, so the serving instantiation carries no residual
//   store and no branch per element.
// What still bounds it (scripts/torch_probe_lstm.py times it with the product
// or the h loads switched off; H100 at B = 32 and 256, T = 501, H = 496): at
// the training shape the barrier, the gate math and the stores (about a third
// of the step in fp32, 60% in bf16), then the product; at the serving shape
// the fp32 product (two thirds of the step; the lane tile runs at ~60% of the
// FMA rate), and in bf16 the fixed cost of eight groups' epilogues. At
// DPRNN's H = 128 (2,048 rows, 16 groups a block, 8 fp32 passes of 2 groups
// a step, 35 us; clock laps of one block's thread 0 on an H100) a pass
// costs ~4.1 us: the product 1.75 (59% of the FMA rate), the epilogue's
// gate math over 2 groups 1.0, issuing the next pass's copies 0.5, the
// partial sums 0.3, the syncs 0.2; the barrier and the arrival ~1 us a step.
// bf16 takes 2 passes of 8 groups, 14.5 us a step, the epilogue 3.3 us a
// pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// Switches for scripts/torch_probe_lstm.py, which builds copies with -D
// flags; the port's build sets none. SST_FWD_SKIP_PRODUCT and
// SST_FWD_SKIP_LOADS leave out each step's product or its h_{s-1} loads (the
// copy's outputs are wrong by design).
#ifndef SST_FWD_SKIP_PRODUCT
#define SST_FWD_SKIP_PRODUCT 0
#endif
#ifndef SST_FWD_SKIP_LOADS
#define SST_FWD_SKIP_LOADS 0
#endif

namespace {

constexpr bool kProduct = !SST_FWD_SKIP_PRODUCT;
constexpr bool kLoads = !SST_FWD_SKIP_LOADS;

constexpr int kRows = 16;           // batch rows of a group
constexpr int kUnits = 16;          // hidden units of a block
constexpr int kCols = 4 * kUnits;   // their gate columns
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 16;      // row groups a block may own: 256 rows a launch
constexpr int kPad = 8;             // h and U rows: (depth + 8) elements
constexpr int kPartialBytes = kWarps * kRows * kCols * 4;
// a row's staged xw_t, its 64 gate columns plus 16, so that two neighbouring
// rows' 16 units of one gate fall in distinct banks
constexpr int kXStride = kCols + 16;

__host__ __device__ inline int padded_depth(int hidden) { return (hidden + 15) / 16 * 16; }

// Dynamic shared memory: the warps' partial sums, h_{s-1} of a pass's groups
// (twice over when the next pass's copies run ahead), U's slice transposed
// when resident, [64][depth + 8], and when ahead two buffers of a pass's
// xw_t, [16 pass][80].
template <typename T>
__host__ __device__ inline size_t smem_bytes(int hidden, bool resident, int pass, bool ahead) {
  const size_t kp = padded_depth(hidden);
  const int h_rows = kRows * pass * (ahead ? 2 : 1);
  const size_t x_elems = ahead ? 2 * kRows * pass * kXStride : 0;
  return kPartialBytes + sizeof(T) * ((h_rows + (resident ? kCols : 0)) * (kp + kPad) + x_elems);
}

// Whether every row of h is 16-byte aligned (H a multiple of 4 fp32 or 8
// bf16), so that h_{s-1} can be copied with cp.async.
template <typename T>
__device__ __forceinline__ bool async_rows(int hidden) {
  return hidden % (16 / static_cast<int>(sizeof(T))) == 0;
}

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kAcc = 64;  // a lane's sums: 8 rows x 8 columns
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kAcc = 32;  // eight m16n8 tiles
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void arrive_release(int* p) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(1) : "memory");
}

// One element of another block's output, past L1.
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 load_cg(const __nv_bfloat16* p) {
  const unsigned short bits = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return *reinterpret_cast<const __nv_bfloat16*>(&bits);
}

// 16 bytes from device memory to shared memory without passing through L1
// (cp.async.cg), zero-filled where `valid` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// h_{s-1} of a pass's `srows` rows into sa[r][k] (`src` is row 0's h at
// k = 0, rows `stride` elements apart), zero past H and past `nrows`, gated
// by each row's keep value (keep_row is row 0's, rows keep_stride apart).
// Aligned rows (async_rows): stage_start puts every 16-byte copy of the
// thread in flight at once (cp.async, one commit group), stage_land waits for
// them and gates the rows where they landed. Other rows: stage_scalar,
// element by element.
template <typename T>
__device__ __forceinline__ void stage_start(T* sa, int as, int srows, const T* src, size_t stride,
                                            int nrows, int hidden, int kp) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = kp / V;
  for (int v = threadIdx.x; v < srows * per_row; v += kThreads) {
    const int r = v / per_row;
    const int k = (v - r * per_row) * V;
    const bool ok = r < nrows && k < hidden;
    cp_async16(sa + r * as + k, ok ? src + r * stride + k : src, ok);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <typename T, bool kKeep>
__device__ __forceinline__ void stage_land(T* sa, int as, int srows, int nrows, int hidden, int kp,
                                           const float* keep_row, size_t keep_stride) {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  if (kKeep) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = kp / V;
    for (int v = threadIdx.x; v < srows * per_row; v += kThreads) {
      const int r = v / per_row;
      const int k = (v - r * per_row) * V;
      if (r >= nrows || k >= hidden) continue;
      const float kr = __ldg(keep_row + r * keep_stride);
      T* e = sa + r * as + k;
#pragma unroll
      for (int q = 0; q < V; ++q) e[q] = from_float<T>(to_float(e[q]) * kr);
    }
  }
}

template <typename T, bool kKeep>
__device__ __forceinline__ void stage_scalar(T* sa, int as, int srows, const T* src, size_t stride,
                                             int nrows, int hidden, int kp, const float* keep_row,
                                             size_t keep_stride) {
  for (int e = threadIdx.x; e < srows * kp; e += kThreads) {
    const int r = e / kp;
    const int k = e - r * kp;
    T v = from_float<T>(0.f);
    if (r < nrows && k < hidden) {
      v = load_cg(src + r * stride + k);
      if (kKeep) v = from_float<T>(to_float(v) * __ldg(keep_row + r * keep_stride));
    }
    sa[r * as + k] = v;
  }
}

// xw_t of a pass's `srows` rows for the block's 16 units, into
// sx[row][gate * 16 + unit] (rows kXStride apart), every 16-byte copy in
// flight at once (cp.async, one commit group): `src` is row 0's xw_t at
// gate 0, unit 0, rows `stride` elements apart, 16-byte aligned with H a
// multiple of 16 bytes' elements; zero past `nrows` and past H.
template <typename T>
__device__ __forceinline__ void stage_x(T* sx, int srows, const T* src, size_t stride, int nrows,
                                        int hidden, int j0) {
  constexpr int V = 16 / sizeof(T);
  constexpr int per_row = kCols / V;  // 16-byte chunks of a row's 64 columns
  for (int v = threadIdx.x; v < srows * per_row; v += kThreads) {
    const int row = v / per_row;
    const int c = (v % per_row) * V;  // gate c / 16, units c % 16 ..
    const int q = c / kUnits;
    const int jc = j0 + c % kUnits;
    const bool ok = row < nrows && jc < hidden;
    cp_async16(sx + row * kXStride + c, ok ? src + row * stride + q * hidden + jc : src, ok);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// fp32, U resident: lane (ks, rs, cq) = (lane % 2, lane / 2 % 2, lane / 4)
// accumulates rows rs + 2 i (i < 8) by columns cq + 8 n (n < 8: gate n / 2,
// unit 8 (n % 2) + cq) over the reduction in chunks of four, k = 4 (2 kw + ks
// + 2 wpg m) + 0..3, for warp kw of the wpg warps that share the group. Each
// operand is a 16-byte shared load (h rows and U's transposed rows are 8 or
// 24 (mod 32) words apart, so a quarter warp's loads fall in distinct banks,
// and lanes share them: 4 distinct addresses for h, 16 for U), so 16 loads
// feed 256 FMAs a lane.
__device__ __forceinline__ void product_resident(const float* sa, int as, const float* ut,
                                                 int us, int kp, float (&acc)[64], int kw,
                                                 int wpg, int lane) {
  const int ks = lane & 1;
  const int rs = (lane >> 1) & 1;
  const int cq = lane >> 2;
  const float* a_row = sa + rs * as;
  const float* b_row = ut + cq * us;
  for (int k = 4 * (2 * kw + ks); k < kp; k += 8 * wpg) {
    float4 a[8];
    float4 b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(a_row + 2 * i * as + k);
#pragma unroll
    for (int n = 0; n < 8; ++n) b[n] = *reinterpret_cast<const float4*>(b_row + 8 * n * us + k);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float& c = acc[8 * i + n];
        c = fmaf(a[i].x, b[n].x, c);
        c = fmaf(a[i].y, b[n].y, c);
        c = fmaf(a[i].z, b[n].z, c);
        c = fmaf(a[i].w, b[n].w, c);
      }
  }
}

// fp32, U streamed (H > 608): the same lanes' rows and columns, one
// reduction index at a time, k = 2 kw + ks + 2 wpg m, h a 4-byte shared load
// that 2 or 4 lanes share; U[d] read from device memory through L1 (rows 4H
// apart, bcol[n] the lane's column g * H + j, clamped into range), with k
// clamped below H, where h is zero.
__device__ __forceinline__ void product_streamed(const float* sa, int as, const float* ub,
                                                 int ustride, const int (&bcol)[8], int kp,
                                                 int hidden, float (&acc)[64], int kw, int wpg,
                                                 int lane) {
  const int ks = lane & 1;
  const int rs = (lane >> 1) & 1;
  const float* a_row = sa + rs * as;
#pragma unroll 2
  for (int k = 2 * kw + ks; k < kp; k += 2 * wpg) {
    float a[8];
    float b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = a_row[2 * i * as + k];
    const float* brow = ub + static_cast<size_t>(min(k, hidden - 1)) * ustride;
#pragma unroll
    for (int n = 0; n < 8; ++n) b[n] = __ldg(brow + bcol[n]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[8 * i + n] = fmaf(a[i], b[n], acc[8 * i + n]);
  }
}

// bf16: warp kw of the wpg that share the group multiplies k16 tiles kw,
// kw + wpg, ...: the group's 16 rows by the 64 columns, eight m16n8k16 tiles;
// acc[4 nt + r] is fragment register c_r of tile nt. ut is U's slice
// transposed, [64][us] bf16.
__device__ __forceinline__ void product_resident(const __nv_bfloat16* sa, int as,
                                                 const __nv_bfloat16* ut, int us, int kp,
                                                 float (&acc)[32], int kw, int wpg, int lane) {
  const uint32_t* a32 = reinterpret_cast<const uint32_t*>(sa);
  const uint32_t* u32 = reinterpret_cast<const uint32_t*>(ut);
  const int as32 = as / 2;
  const int us32 = us / 2;
  const int g = lane >> 2;
  const int c = lane & 3;
  for (int kt = kw; kt < kp / 16; kt += wpg) {
    const int kb = kt * 8;
    const uint32_t a0 = a32[g * as32 + kb + c];
    const uint32_t a1 = a32[(g + 8) * as32 + kb + c];
    const uint32_t a2 = a32[g * as32 + kb + 4 + c];
    const uint32_t a3 = a32[(g + 8) * as32 + kb + 4 + c];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
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

// partial[warp][row][column], rows 64 words apart, the columns' bit 4
// flipped on odd rows, so that two neighbouring rows of 16 columns fall in
// distinct banks when the epilogue reads them.
__device__ __forceinline__ int partial_index(int warp, int row, int col) {
  return (warp * kRows + row) * kCols + (col ^ ((row & 1) << 4));
}

// fp32: lanes ks = 0, 1 swap halves and add (one shuffle round), so lane ks
// keeps rows rs + 2 (4 ks + i), i < 4.
__device__ __forceinline__ void store_partials(float* partial, float (&acc)[64], int warp,
                                               int lane) {
  const bool hi = lane & 1;
  const int rs = (lane >> 1) & 1;
  const int cq = lane >> 2;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const float send = hi ? acc[q] : acc[q + 32];
    const float sum = (hi ? acc[q + 32] : acc[q]) + __shfl_xor_sync(0xffffffffu, send, 1);
    const int i = q / 8 + (hi ? 4 : 0);
    partial[partial_index(warp, rs + 2 * i, 8 * (q % 8) + cq)] = sum;
  }
}

// bf16: acc[4 nt + r] is mma fragment register c_r of tile nt (columns 8 nt ..).
__device__ __forceinline__ void store_partials(float* partial, float (&acc)[32], int warp,
                                               int lane) {
  const int g = lane >> 2;
  const int c = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + 2 * c;
    partial[partial_index(warp, g, col)] = acc[4 * nt];
    partial[partial_index(warp, g, col + 1)] = acc[4 * nt + 1];
    partial[partial_index(warp, g + 8, col)] = acc[4 * nt + 2];
    partial[partial_index(warp, g + 8, col + 1)] = acc[4 * nt + 3];
  }
}

// xw [D, B, T, 4H], u [D, H, 4H], out [B, T, D * H] in T; kTrain: gates
// [D, B, T, 4H] in T (post-activation i, f, g, o) and c_all [D, B, T, H]
// fp32; kKeep: keep [D, B, T] fp32 in scan order gates the carry (h and c)
// before the step. The launch covers batch rows row0 .. row0 + rows - 1 of
// the B = `batch` rows; counters [D, row blocks] int32, zero at the launch.
// Grid (unit slices, row blocks, D); a row block is `groups` groups of 16
// rows, multiplied `pass` groups at a time. kAhead (H a multiple of 16
// bytes' elements): two buffers of a pass's h_{s-1} and xw_t, each pass's
// copies started during the pass before it (the first pass's xw_t before
// the step's barrier), and the gates' xw_t read from shared memory.
template <typename T, bool kTrain, bool kKeep, bool kResident, int kPass, bool kAhead>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_persistent_kernel(const T* __restrict__ xw, const T* __restrict__ u, T* out,
                           T* __restrict__ gates_out, float* __restrict__ c_all,
                           const float* __restrict__ keep, int* counters, int batch, int row0,
                           int rows, int steps, int hidden, int reverse_mask, int groups) {
  constexpr int pass = kPass;
  constexpr int srows = pass * kRows;
  extern __shared__ float4 smem4[];
  float* partial = reinterpret_cast<float*>(smem4);
  const int kp = padded_depth(hidden);
  const int as = kp + kPad;
  T* sa = reinterpret_cast<T*>(reinterpret_cast<char*>(smem4) + kPartialBytes);
  T* su = sa + (kAhead ? 2 : 1) * srows * as;
  T* sx = su + (kResident ? kCols * as : 0);
  auto h_buf = [&](int pi) { return kAhead ? sa + (pi & 1) * srows * as : sa; };
  auto x_buf = [&](int pi) { return sx + (pi & 1) * srows * kXStride; };

  const int d = blockIdx.z;
  const int dirs = gridDim.z;
  const int j0 = blockIdx.x * kUnits;
  const int g4h = 4 * hidden;
  const bool rev = (reverse_mask >> d) & 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int wpg = kWarps / pass;  // warps that share a group's product
  const int pg = warp / wpg;      // this warp's group in the pass
  const int kw = warp % wpg;      // and its share of the reduction
  const T* ud = u + static_cast<size_t>(d) * hidden * g4h;
  int* counter = counters + d * gridDim.y + blockIdx.y;
  const int arrivals = gridDim.x;
  const size_t out_step = static_cast<size_t>(dirs) * hidden;  // out's stride of a time step
  const size_t drow = static_cast<size_t>(d) * batch + row0;  // row (d, row0) of [D, B, .]
  const int first = blockIdx.y * groups * kRows;  // the block's first row in the slice

  // U's slice transposed, su[column][k], once for the call, zero past H (k)
  // and past the last unit
  if (kResident) {
    for (int v = threadIdx.x; v < kp * kCols; v += kThreads) {
      const int k = v / kCols;
      const int col = v - k * kCols;
      const int j = j0 + col % kUnits;
      su[col * as + k] = (k < hidden && j < hidden)
                             ? ud[static_cast<size_t>(k) * g4h + (col / kUnits) * hidden + j]
                             : from_float<T>(0.f);
    }
  }
  int bcol[8];  // streamed fp32: the lane's columns of U[d]
  if (!kResident) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
      bcol[n] = (n >> 1) * hidden + min(j0 + 8 * (n & 1) + (lane >> 2), hidden - 1);
  }
  const bool async = kLoads && async_rows<T>(hidden);
  const size_t h_stride = static_cast<size_t>(steps) * out_step;  // h of row b + 1
  auto h_src = [&](int b0, int t_prev) {
    return out + (static_cast<size_t>(row0 + b0) * steps + t_prev) * out_step + d * hidden;
  };
  auto keep_src = [&](int b0, int step) {
    return kKeep ? keep + (drow + b0) * steps + step : nullptr;
  };
  // rows from group g0 on that are the block's and the slice's (a pass may
  // reach past both; those rows stage as zeros)
  auto own_rows = [&](int g0) { return min(rows - first, groups * kRows) - g0 * kRows; };
  auto start_copies = [&](int pi, int t_prev) {
    stage_start<T>(h_buf(pi), as, srows, h_src(first + pi * srows, t_prev), h_stride,
                   own_rows(pi * pass), hidden, kp);
  };
  auto start_x = [&](int pi, int t) {
    stage_x<T>(x_buf(pi), srows, xw + ((drow + first + pi * srows) * steps + t) * g4h,
               static_cast<size_t>(steps) * g4h, own_rows(pi * pass), hidden, j0);
  };

  float cst[kMaxGroups];
#pragma unroll
  for (int i = 0; i < kMaxGroups; ++i) cst[i] = 0.f;
  const int r = threadIdx.x / kUnits;  // the (row, unit) this thread owns in each group
  const int jj = threadIdx.x % kUnits;
  const int j = j0 + jj;

  // xw_t (unless staged ahead) and the keep value of (row, unit) in each
  // group of a pass: loaded before the barrier (the first pass) or before the
  // pass's product, so their latency overlaps the wait or the product.
  struct GateIn {
    float x[4];
    float k;
  };
  GateIn in[pass];
  auto gate_inputs = [&](int g0, int step, int t) {
#pragma unroll
    for (int p = 0; p < pass; ++p) {
      in[p] = GateIn{};
      in[p].k = 1.f;
      const int b = first + (g0 + p) * kRows + r;
      if (g0 + p < groups && b < rows && j < hidden) {
        const T* x = xw + ((drow + b) * steps + t) * g4h;
        if (!kAhead)
#pragma unroll
          for (int q = 0; q < 4; ++q) in[p].x[q] = to_float(x[q * hidden + j]);
        if (kKeep) in[p].k = keep[(drow + b) * steps + step];
      }
    }
  };

  for (int step = 0; step < steps; ++step) {
    const int t = rev ? steps - 1 - step : step;
    const int t_prev = rev ? t + 1 : t - 1;
    const bool product_step = step > 0;  // h_{-1} = 0: the first step is xw alone
    if (kAhead) start_x(0, t);
    gate_inputs(0, step, t);
    if (product_step) {  // every block of this (direction, row block) has written step - 1
      if (threadIdx.x == 0) {
        const int target = step * arrivals;
        // the acquire orders this block's later loads after the arrivals'
        // writes, and the block barrier hands that on to every thread; a
        // barrier that never fills (a fault elsewhere) ends the launch with an
        // error after a few seconds instead of holding the card
        for (long spins = 0; load_acquire(counter) < target; ++spins)
          if (spins > (1L << 24)) __trap();
      }
      __syncthreads();
      // the first pass's copies right after the barrier: started at the top of
      // the pass loop instead, ptxas scheduled the fp32 serving kernel
      // otherwise and it ran 13% slower (H100, B = 256, outputs identical)
      if (async) start_copies(0, t_prev);
    }
    for (int g0 = 0, pi = 0; g0 < groups; g0 += pass, ++pi) {
      const int b0 = first + g0 * kRows;
      if (b0 >= rows) break;
      if (g0 > 0) gate_inputs(g0, step, t);
      T* sp = h_buf(pi);
      if (kAhead) {  // this pass's copies were started a pass (or a barrier) ago
        if (product_step && async)
          stage_land<T, kKeep>(sp, as, srows, own_rows(g0), hidden, kp, keep_src(b0, step),
                               steps);
        else
          asm volatile("cp.async.wait_group 0;" ::: "memory");
        __syncthreads();
        // the next pass's, into the other buffers, whose last readers (the
        // product and epilogue of the pass before) are behind the barrier
        // above: they land during this pass's product and epilogue, so only
        // the first pass of a step waits a round trip to L2 for h_{s-1}
        if (g0 + pass < groups && b0 + pass * kRows < rows) {
          start_x(pi + 1, t);
          if (product_step && async) start_copies(pi + 1, t_prev);
        }
      } else if (product_step) {
        if (async) {
          if (pi > 0) start_copies(pi, t_prev);
          stage_land<T, kKeep>(sp, as, srows, own_rows(g0), hidden, kp, keep_src(b0, step),
                               steps);
        } else if (kLoads) {
          stage_scalar<T, kKeep>(sp, as, srows, h_src(b0, t_prev), h_stride, own_rows(g0),
                                 hidden, kp, keep_src(b0, step), steps);
        }
        __syncthreads();
      }
      if (product_step) {
        float acc[Elem<T>::kAcc];
#pragma unroll
        for (int i = 0; i < Elem<T>::kAcc; ++i) acc[i] = 0.f;
        if (kProduct) {
          const T* sg = sp + pg * kRows * as;
          if constexpr (kResident)
            product_resident(sg, as, su, as, kp, acc, kw, wpg, lane);
          else
            product_streamed(sg, as, ud, g4h, bcol, kp, hidden, acc, kw, wpg, lane);
        }
        store_partials(partial, acc, warp, lane);
        __syncthreads();
      }

#pragma unroll
      for (int p = 0; p < pass; ++p) {
        const int g = g0 + p;
        const int bg = b0 + p * kRows;
        if (g >= groups || bg >= rows) break;
        float z[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          z[q] = kAhead ? to_float(x_buf(pi)[(p * kRows + r) * kXStride + q * kUnits + jj])
                        : in[p].x[q];
        if (product_step) {
          float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int i = 0; i < wpg; ++i)  // the group's warps, in order
#pragma unroll
            for (int q = 0; q < 4; ++q)
              sum[q] += partial[partial_index(p * wpg + i, r, q * kUnits + jj)];
#pragma unroll
          for (int q = 0; q < 4; ++q) z[q] += sum[q];
        }
        float carry = 0.f;  // cst[g], selected without indexing the array at run time
#pragma unroll
        for (int i = 0; i < kMaxGroups; ++i)
          if (i == g) carry = cst[i];
        if (bg + r < rows && j < hidden) {
          const float ig = sigmoid(z[0]);
          const float fg = sigmoid(z[1]);
          const float gg = tanhf(z[2]);
          const float og = sigmoid(z[3]);
          const float cp = kKeep ? carry * in[p].k : carry;
          const float cn = fg * cp + ig * gg;
          const float hn = og * tanhf(cn);
          const size_t b = static_cast<size_t>(row0 + bg + r);
          out[(b * steps + t) * out_step + d * hidden + j] = from_float<T>(hn);
          if (kTrain) {
            const size_t row = (drow + bg + r) * steps + t;
            T* g4 = gates_out + row * g4h;
            g4[j] = from_float<T>(ig);
            g4[hidden + j] = from_float<T>(fg);
            g4[2 * hidden + j] = from_float<T>(gg);
            g4[3 * hidden + j] = from_float<T>(og);
            c_all[row * hidden + j] = cn;
          }
          carry = cn;
        }
#pragma unroll
        for (int i = 0; i < kMaxGroups; ++i)
          if (i == g) cst[i] = carry;
      }
    }
    __syncthreads();  // the block's h of this step is written
    if (threadIdx.x == 0) arrive_release(counter);  // release: it is visible first
  }
}

template <typename T, bool kTrain, bool kKeep, bool kResident, int kPass, bool kAhead>
int launch(const void* xw, const void* u, void* out, void* gates, void* c_all, const void* keep,
           void* counters, int dirs, int batch, int row0, int rows, int steps, int hidden,
           int reverse_mask, int groups, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(hidden, kResident, kPass, kAhead);
  auto kernel = lstm_fwd_persistent_kernel<T, kTrain, kKeep, kResident, kPass, kAhead>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((hidden + kUnits - 1) / kUnits, (rows + groups * kRows - 1) / (groups * kRows),
                  dirs);
  const T* x_ = static_cast<const T*>(xw);
  const T* u_ = static_cast<const T*>(u);
  T* o_ = static_cast<T*>(out);
  T* g_ = static_cast<T*>(gates);
  float* c_ = static_cast<float*>(c_all);
  const float* k_ = static_cast<const float*>(keep);
  int* ctr_ = static_cast<int*>(counters);
  void* args[] = {&x_, &u_, &o_, &g_, &c_, &k_, &ctr_, &batch, &row0, &rows, &steps, &hidden,
                  &reverse_mask, &groups};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid, dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it; the caller raises on the code
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// Groups multiplied in one pass (a power of two, from the launch plan, a
// template argument): the eight warps split the reduction of each group's
// product 8 / pass ways. fp32 takes one or two groups a pass (its lane tile
// leaves no registers for more inputs) and may stream U; bf16 keeps U
// resident (its slice fits at every H <= 1024) and takes 1, 2, 4 or 8 groups
// a pass. The plan runs the next pass's copies ahead (second h_{s-1} and
// xw_t buffers) only with U resident, more than one group a pass (with one, the second
// buffer's bytes would have held a pass of two) and rows of h and xw that
// cp.async can copy 16 bytes at a time (H a multiple of 16 bytes' elements,
// xw 16-byte aligned).
template <typename T, bool kTrain, bool kKeep>
int run(const void* xw, const void* u, void* out, void* gates, void* c_all, const void* keep,
        void* counters, int dirs, int batch, int row0, int rows, int steps, int hidden,
        int reverse_mask, int groups, int pass, int resident, int ahead, cudaStream_t stream) {
#define SST_FWD_LAUNCH(RESIDENT, PASS, AHEAD)                                                    \
  launch<T, kTrain, kKeep, RESIDENT, PASS, AHEAD>(xw, u, out, gates, c_all, keep, counters, dirs, \
                                                  batch, row0, rows, steps, hidden,              \
                                                  reverse_mask, groups, stream)
  if (ahead && (!resident || pass < 2 || hidden % (16 / sizeof(T)) ||
                reinterpret_cast<uintptr_t>(xw) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(T) == 4) {
    switch (pass) {
      case 1: return resident ? SST_FWD_LAUNCH(true, 1, false) : SST_FWD_LAUNCH(false, 1, false);
      case 2:
        if (ahead) return SST_FWD_LAUNCH(true, 2, true);
        return resident ? SST_FWD_LAUNCH(true, 2, false) : SST_FWD_LAUNCH(false, 2, false);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    if (!resident) return static_cast<int>(cudaErrorInvalidValue);
    switch (pass) {
      case 1: return SST_FWD_LAUNCH(true, 1, false);
      case 2: return ahead ? SST_FWD_LAUNCH(true, 2, true) : SST_FWD_LAUNCH(true, 2, false);
      case 4: return ahead ? SST_FWD_LAUNCH(true, 4, true) : SST_FWD_LAUNCH(true, 4, false);
      case 8: return ahead ? SST_FWD_LAUNCH(true, 8, true) : SST_FWD_LAUNCH(true, 8, false);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef SST_FWD_LAUNCH
}

bool bad_plan(int dirs, int batch, int row0, int rows, int steps, int hidden, int groups) {
  return dirs < 1 || dirs > 2 || rows < 1 || row0 < 0 || row0 + rows > batch || steps < 1 ||
         hidden < 1 || groups < 1 || groups > kMaxGroups;
}

}  // namespace

// Runs all `steps` steps of rows row0 .. row0 + rows - 1 in one cooperative
// launch; out [B, T, D * H] is also where each step reads h_{s-1}.
// counters [dirs, row blocks] int32 must hold zeros. bf16 != 0 selects
// __nv_bfloat16 xw, u and out; otherwise fp32. groups (1 to 16 groups of 16
// rows a block), pass (groups multiplied together: 1 or 2 in fp32, 1, 2, 4 or 8
// in bf16), resident (U kept in shared memory) and ahead (the next pass's
// h_{s-1} and xw_t copied during this pass) come from the caller's launch plan; the
// shared memory a block takes follows from them (smem_bytes).
// Returns the launch's error, cudaErrorInvalidValue for an inconsistent plan,
// cudaErrorCooperativeLaunchTooLarge for a grid that cannot be resident at
// once, or 0.
extern "C" int sst_lstm_recurrence(const void* xw, const void* u, void* out, void* counters,
                                   int dirs, int batch, int row0, int rows, int steps, int hidden,
                                   int reverse_mask, int bf16, int groups, int pass, int resident,
                                   int ahead, void* stream) {
  if (bad_plan(dirs, batch, row0, rows, steps, hidden, groups))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run<__nv_bfloat16, false, false>(xw, u, out, nullptr, nullptr, nullptr, counters, dirs,
                                            batch, row0, rows, steps, hidden, reverse_mask, groups,
                                            pass, resident, ahead, s);
  return run<float, false, false>(xw, u, out, nullptr, nullptr, nullptr, counters, dirs, batch,
                                  row0, rows, steps, hidden, reverse_mask, groups, pass, resident,
                                  ahead, s);
}

// The training forward: sst_lstm_recurrence plus the residuals gates
// [D, B, T, 4H] (compute type) and c_all [D, B, T, H] (fp32), and an optional
// keep gate [D, B, T] fp32 in each direction's scan order (null for none).
extern "C" int sst_lstm_train_forward(const void* xw, const void* u, void* out, void* gates,
                                      void* c_all, const void* keep, void* counters, int dirs,
                                      int batch, int row0, int rows, int steps, int hidden,
                                      int reverse_mask, int bf16, int groups, int pass,
                                      int resident, int ahead, void* stream) {
  if (bad_plan(dirs, batch, row0, rows, steps, hidden, groups))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (keep)
      return run<__nv_bfloat16, true, true>(xw, u, out, gates, c_all, keep, counters, dirs, batch,
                                            row0, rows, steps, hidden, reverse_mask, groups, pass,
                                            resident, ahead, s);
    return run<__nv_bfloat16, true, false>(xw, u, out, gates, c_all, nullptr, counters, dirs,
                                           batch, row0, rows, steps, hidden, reverse_mask, groups,
                                           pass, resident, ahead, s);
  }
  if (keep)
    return run<float, true, true>(xw, u, out, gates, c_all, keep, counters, dirs, batch, row0,
                                  rows, steps, hidden, reverse_mask, groups, pass, resident,
                                  ahead, s);
  return run<float, true, false>(xw, u, out, gates, c_all, nullptr, counters, dirs, batch, row0,
                                 rows, steps, hidden, reverse_mask, groups, pass, resident, ahead,
                                 s);
}
