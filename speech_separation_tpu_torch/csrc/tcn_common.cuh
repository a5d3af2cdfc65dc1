// Pieces shared by the Conv-TasNet trunk kernels (tcn_trunk.cu, the forward
// for serving and training, and tcn_train_backward.cu, the backward): the
// fixed-order reductions that make two runs agree bit for bit, and the Hopper
// product engine (a cp.async ring of shared-memory stages feeding wgmma
// m64n256k16, bf16 operands, K-major or MN-major, fp32 accumulators in
// registers), which both run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tcn {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;

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

// ---------------------------------------------------------------------------
// The Hopper product engine. A CTA of two warpgroups computes a kEngRows x
// kCols fp32 tile of A @ B over the depth range [0, depth): warpgroup w the
// rows [64 w, 64 w + 64), each with one wgmma.mma_async m64nNk16 (N = kCols,
// kEngCols = 256 for the forward, 128 for the backward) per 16 of depth and
// its kCols / 2 accumulators in registers. Each operand is K-major or
// MN-major in device memory (row-major, 16-byte rows: the leading dimensions
// and the row counts along a contiguous dimension multiples of 8):
//   A K-major   a[m * lda + d]  (A [rows, depth])
//   A MN-major  a[d * lda + m]  (A^T [depth, rows], as in a weight gradient)
//   B K-major   b[n * ldb + d]  (B^T [cols, depth])
//   B MN-major  b[d * ldb + n]  (B [depth, cols])
// and lands in shared memory in the 128-byte swizzled layout of its major
// mode: a 128-byte line holds 64 contiguous values (a row's depths, K-major;
// a depth's rows or columns, MN-major), 8 lines an atom of 1,024 bytes, the
// 16-byte chunk q of line r stored at chunk q ^ (r % 8), so the tensor cores'
// reads of 8 lines hit 8 different bank groups. K-major, a 64-deep stage is
// one line a row, 8 rows an atom, atoms 1,024 bytes apart (the stride byte
// offset); a 16-deep step starts 32 bytes further into the lines. MN-major,
// an atom holds 64 rows (or columns) at 8 depths, the 8 depth atoms of one
// 64-row block 1,024 bytes apart (the stride byte offset) and the 64-row
// blocks 8,192 bytes apart (the leading byte offset); a 16-deep step starts
// two atoms further, and wgmma transposes the operand as it reads it
// (imm-trans-a, imm-trans-b). Eight threads copy 128 contiguous bytes of
// device memory into one line. cp.async (through L2, zero-filled outside the
// matrix) keeps kEngStages - 1 stages in flight ahead of the stage being
// multiplied. Stages start on 1,024-byte boundaries.
#ifndef SST_TRUNK_SKIP
#define SST_TRUNK_SKIP 0  // probe builds only: see tcn_trunk.cu
#endif

constexpr int kEngRows = 128;   // rows per CTA tile (python: TRUNK_TILE_ROWS)
constexpr int kEngCols = 256;   // output columns per pass (python: TRUNK_TILE_COLS)
constexpr int kEngDepth = 64;   // depth per shared-memory stage
constexpr int kEngStages = 3;   // ring stages (python: TRUNK_STAGES)
constexpr int kEngAcc = kEngCols / 2;  // fp32 accumulators a thread: 64 x 256 / 128
constexpr int kEngStageA = kEngRows * kEngDepth * 2;
constexpr int kEngStageB = kEngCols * kEngDepth * 2;
constexpr int kEngStage = kEngStageA + kEngStageB;
constexpr int kEngRingBytes = kEngStages * kEngStage;
// The ring of an engine of kCols output columns (256, the forward's, or 128).
template <int kCols>
constexpr int engine_ring_bytes() { return kEngStages * (kEngStageA + kCols * kEngDepth * 2); }
constexpr int kMnBlock = 64 * kEngDepth * 2;  // bytes of a 64-row block of an MN-major stage

// 16 bytes from device memory to shared memory through L2 (cp.async.cg),
// zero-filled where `valid` is false (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}
// cp.async and st.shared write through the generic proxy; wgmma reads shared
// memory through the async proxy, which needs this fence in between.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor in the 128-byte swizzled layout: start
// address, leading byte offset, stride byte offset (each in 16-byte units),
// layout type 1 (128-byte swizzle) in bits 62-63. K-major operands use only
// the stride (1,024 bytes between 8-row atoms); MN-major ones both (above).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, unsigned lead = 16,
                                               unsigned stride = 1024) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a >> 4) & 0x3FFFu) | (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Pins the accumulators to this point of the instruction stream: the
// compiler sees the registers written here, so no read of them moves above
// the wait_group before it.
template <int kAcc>
__device__ __forceinline__ void wgmma_fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A(64 x 16) B(16 x 256) + (accumulate ? d : 0), A and B in shared memory,
// each K-major (kTransA, kTransB = 0) or MN-major (1), fp32 d.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[kEngAcc], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB)
      : "memory");
}

// The same with 128 output columns: d = A(64 x 16) B(16 x 128) (+ d).
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB)
      : "memory");
}

// One 16-deep product of a kCols-column tile (256 or 128).
template <int kCols, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_tile(float (&d)[kCols / 2], uint64_t da, uint64_t db,
                                           int accumulate) {
  if constexpr (kCols == 256)
    wgmma_m64n256k16<kTransA, kTransB>(d, da, db, accumulate);
  else
    wgmma_m64n128k16<kTransA, kTransB>(d, da, db, accumulate);
}

// An MN-major operand's depth in segments: depth k lies in memory at row
// (k / 128) stride + k % 128, the last segment holding last_rows rows (a
// weight gradient over a CTA's tiles, ctas tiles apart). stride 0: one
// contiguous run.
struct Segments {
  int stride = 0, last_rows = 0;
};

// One 64-deep stage at depth k0 of the rows (K-major) or the columns
// (MN-major) [row0, row0 + kRows) of an operand m with n_rows of them and
// leading dimension ld, into dst (1,024-byte aligned), swizzled.
template <int kRows, bool kMn>
__device__ __forceinline__ void stage_operand(unsigned char* dst, const bf16* __restrict__ m,
                                              int ld, int n_rows, int row0, int depth, int k0,
                                              Segments seg = {}) {
#pragma unroll
  for (int n = 0; n < kRows * 8 / kThreads; ++n) {
    const int c = threadIdx.x + n * kThreads;
    if (kMn) {  // c: depth c / (kRows / 8), chunk c % (kRows / 8) of its kRows values
      const int d = c / (kRows / 8), q = c % (kRows / 8);
      const int r = row0 + q * 8;
      int k = k0 + d;
      bool ok = r < n_rows && k < depth;
      if (seg.stride) {  // a stage lies within one 128-deep segment
        const int s = k >> 7, w = k & 127;
        ok = ok && (k < depth - 128 || w < seg.last_rows);
        k = s * seg.stride + w;
      }
      cp_async16(dst + (q >> 3) * kMnBlock + d * 128 + (((q & 7) ^ (d & 7)) << 4),
                 ok ? m + static_cast<size_t>(k) * ld + r : m, ok);
    } else {  // c: row c / 8, chunk c % 8 of its 64 depths
      const int line = c >> 3, q = c & 7;
      const int r = row0 + line, k = k0 + q * 8;
      const bool ok = r < n_rows && k < depth;
      cp_async16(dst + line * 128 + ((q ^ (line & 7)) << 4),
                 ok ? m + static_cast<size_t>(r) * ld + k : m, ok);
    }
  }
}

// The descriptor of the 16-deep step kk of a stage whose 64-row (or column)
// block `block` the product reads.
template <bool kMn>
__device__ __forceinline__ uint64_t step_desc(const unsigned char* stage, int block, int kk) {
  if (kMn) return sw128_desc(stage + block * kMnBlock + kk * 2048, kMnBlock, 1024);
  return sw128_desc(stage + block * (64 * 128) + kk * 32);
}

// acc (+)= A[row0 .. row0 + kEngRows) @ B[.., col0 .. col0 + kCols) over the
// depth, A with a_rows rows and B with b_rows columns in the major modes kMnA,
// kMnB (above), leading dimensions lda, ldb; rows and columns past the
// matrices and depths past `depth` read zero. With `accumulate` the products
// add to acc, else they replace it. ring is engine_ring_bytes<kCols>() of shared
// memory, 1,024-byte aligned, free on entry and on return. Every thread of the CTA
// calls it. One loop both fills the ring (its first kEngStages - 1 turns
// only that) and multiplies, so the copies and the products each appear once
// in the code: the kernels that call it run long stretches of straight-line
// code once per block, and the SM's instruction cache holds less of them the
// larger they are.
template <bool kMnA = false, bool kMnB = false, int kCols = kEngCols>
__device__ __forceinline__ void engine_tile(float (&acc)[kCols / 2], const bf16* __restrict__ a,
                                            int lda, int a_rows, int row0,
                                            const bf16* __restrict__ bt, int ldb, int b_rows,
                                            int col0, int depth, unsigned char* ring,
                                            bool accumulate = false, Segments seg = {}) {
  constexpr int kStage = kEngStageA + kCols * kEngDepth * 2;
  const int stages = (depth + kEngDepth - 1) / kEngDepth;
  const int wg = threadIdx.x / 128;
  if (!accumulate) {
    // the products replace acc: zeroing it here ends the old values' lives
    // (wgmma's operand reads them as far as the compiler knows), so the
    // registers are free between one tile's epilogue and the next product
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.f;
  }
#pragma unroll 1
  for (int s = 0; s < stages + kEngStages - 1; ++s) {
    const int u = s - (kEngStages - 1);  // the stage multiplied this turn
    if (u >= 0) {
      cp_async_wait<kEngStages - 2>();  // this thread's copies of stage u have landed
      fence_proxy_async();
      __syncthreads();  // everyone's have; stage u - 1 is no longer read
    }
    if (s < stages) {  // into the slot of stage u - 1
      unsigned char* st = ring + (s % kEngStages) * kStage;
      stage_operand<kEngRows, kMnA>(st, a, lda, a_rows, row0, depth, s * kEngDepth, seg);
      stage_operand<kCols, kMnB>(st + kEngStageA, bt, ldb, b_rows, col0, depth, s * kEngDepth, seg);
    }
    cp_async_commit();
    if (u >= 0) {
      const unsigned char* sa = ring + (u % kEngStages) * kStage;
      const unsigned char* sb = sa + kEngStageA;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kEngDepth / 16; ++kk)
        if (!(SST_TRUNK_SKIP & 16))
          wgmma_tile<kCols, kMnA, kMnB>(acc, step_desc<kMnA>(sa, wg, kk),
                                        step_desc<kMnB>(sb, 0, kk), accumulate || u + kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      wgmma_fence_acc(acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the caller
}

// The (row, column) of accumulator i of this thread in its warpgroup's 64 x
// 256 part of the tile (the wgmma D fragment): rows 16 (warp % 4) + lane / 4
// and 8 below it, column pairs 8 (i / 4) + 2 (lane % 4).
__device__ __forceinline__ int acc_row(int i) {
  return (threadIdx.x / 128) * 64 + ((threadIdx.x / 32) % 4) * 16 + (threadIdx.x % 32) / 4 +
         ((i >> 1) & 1) * 8;
}
__device__ __forceinline__ int acc_col(int i) { return (i >> 2) * 8 + (threadIdx.x % 4) * 2 + (i & 1); }

// ---------------------------------------------------------------------------
// Pieces of the persistent trunk kernels: their limits, the depthwise taps'
// staging, the barriers within a group of CTAs, the laps' clock.
constexpr int kMaxBlocks = 256;  // dilations carried in the launch parameters (python: TRUNK_MAX_BLOCKS)
constexpr int kMaxTaps = 8;      // python: TRUNK_MAX_TAPS
constexpr int kSliceCh = 64;     // channels a depthwise slice: 8 groups of 8 (python: TRUNK_SLICE)

// One staging buffer of the depthwise taps (the forward's (B), the backward's
// P2 and P5): a tile's rows and the taps' halo, 64 channels.
__host__ __device__ inline int staging_buffer_bytes(int taps, int dil) {
  return ((kEngRows + (taps - 1) * dil) * kSliceCh * 2 + 1023) / 1024 * 1024;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void arrive_release(int* p) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(1) : "memory");
}

__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// This CTA's writes so far are done; the release makes them visible to any
// CTA whose acquire sees the arrival.
__device__ __forceinline__ void group_arrive(int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) arrive_release(counter);
}

// Until `target` arrivals: the acquire orders this CTA's later loads after the
// arrivals' writes and the block barrier hands that on to every thread. A
// barrier that never fills (a fault elsewhere) ends the launch with an error
// after a few seconds instead of holding the card.
__device__ __forceinline__ void group_wait(const int* counter, int target) {
  if (threadIdx.x == 0) {
    for (long spins = 0; load_acquire(counter) < target; ++spins)
      if (spins > (1L << 24)) __trap();
  }
  __syncthreads();
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ inline float prelu(float x, float alpha) { return x >= 0.f ? x : __fmul_rn(alpha, x); }

}  // namespace tcn
