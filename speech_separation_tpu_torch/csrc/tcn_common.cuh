// Pieces shared by the Conv-TasNet trunk kernels (tcn_trunk.cu, the forward
// for serving and training, and tcn_train_backward.cu): the fixed-order
// reductions that make two runs agree bit for bit; the Hopper product engine
// (a cp.async ring of shared-memory stages feeding wgmma m64n256k16, bf16
// operands, fp32 accumulators in registers), which the forward runs; and the
// older GEMM tile on WMMA bf16 fragments, which the backward still runs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
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

// ---------------------------------------------------------------------------
// The Hopper product engine. A CTA of two warpgroups computes a kEngRows x
// kEngCols fp32 tile of A @ B over the depth range [0, depth): warpgroup w the
// rows [64 w, 64 w + 64), each with one wgmma.mma_async m64n256k16 per 16 of
// depth and its 128 accumulators in registers. Both operands are K-major in
// device memory (A [rows, depth] and B^T [cols, depth], row-major, 16-byte
// rows: depth and the leading dimensions multiples of 8) and K-major in
// shared memory in the 128-byte swizzled layout: a 64-deep stage holds each
// row's 64 values in one 128-byte line, 8 lines an atom of 1,024 bytes
// (stride byte offset), the 16-byte chunk q of line r stored at chunk q ^ (r
// % 8), so the tensor cores' reads of 8 lines at one depth hit 8 different
// bank groups. A 16-deep step starts 32 bytes further into the lines.
// Thread i's 16-byte copies c = i + 256 n take line c / 8, chunk c % 8: 8
// threads read one 128-byte run of a row and fill one line. cp.async (through
// L2, zero-filled outside the matrix) keeps kEngStages - 1 stages in flight
// ahead of the stage being multiplied. Stages start on 1,024-byte boundaries.
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

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzled layout: start address, leading byte offset 16 (unused by this
// layout), stride byte offset 1,024 (between 8-line atoms), each in 16-byte
// units, layout type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a >> 4) & 0x3FFFu) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
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
__device__ __forceinline__ void wgmma_fence_acc(float (&d)[kEngAcc]) {
#pragma unroll
  for (int i = 0; i < kEngAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A(64 x 16) B(16 x 256) + (accumulate ? d : 0), both K-major in shared
// memory, fp32 d.
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
      " %128, %129, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// One 64-deep stage of the rows [row0, row0 + kRows) of a K-major matrix m
// [n_rows, depth] (leading dimension ld) at depth k0, into dst (1,024-byte
// aligned), swizzled.
template <int kRows>
__device__ __forceinline__ void stage_kmajor(unsigned char* dst, const bf16* __restrict__ m, int ld,
                                             int n_rows, int row0, int depth, int k0) {
#pragma unroll
  for (int n = 0; n < kRows * 8 / kThreads; ++n) {
    const int c = threadIdx.x + n * kThreads;
    const int line = c >> 3, q = c & 7;
    const int r = row0 + line, k = k0 + q * 8;
    const bool ok = r < n_rows && k < depth;
    cp_async16(dst + line * 128 + ((q ^ (line & 7)) << 4),
               ok ? m + static_cast<size_t>(r) * ld + k : m, ok);
  }
}

// acc = A[row0 .. row0 + kEngRows) @ B[.., col0 .. col0 + kEngCols) over the
// depth, with A [a_rows, depth] (leading dimension lda) and B^T [b_rows,
// depth] (ldb); rows and columns past the matrices read zero. ring is
// kEngRingBytes of shared memory, 1,024-byte aligned, free on entry and on
// return. Every thread of the CTA calls it. One loop both fills the ring
// (its first kEngStages - 1 turns only that) and multiplies, so the copies
// and the products each appear once in the code: the kernels that call it
// run long stretches of straight-line code once per block, and the SM's
// instruction cache holds less of them the larger they are.
__device__ __forceinline__ void engine_tile(float (&acc)[kEngAcc], const bf16* __restrict__ a,
                                            int lda, int a_rows, int row0,
                                            const bf16* __restrict__ bt, int ldb, int b_rows,
                                            int col0, int depth, unsigned char* ring) {
  const int stages = (depth + kEngDepth - 1) / kEngDepth;
  const int wg = threadIdx.x / 128;
#pragma unroll 1
  for (int s = 0; s < stages + kEngStages - 1; ++s) {
    const int u = s - (kEngStages - 1);  // the stage multiplied this turn
    if (u >= 0) {
      cp_async_wait<kEngStages - 2>();  // this thread's copies of stage u have landed
      fence_proxy_async();
      __syncthreads();  // everyone's have; stage u - 1 is no longer read
    }
    if (s < stages) {  // into the slot of stage u - 1
      unsigned char* st = ring + (s % kEngStages) * kEngStage;
      stage_kmajor<kEngRows>(st, a, lda, a_rows, row0, depth, s * kEngDepth);
      stage_kmajor<kEngCols>(st + kEngStageA, bt, ldb, b_rows, col0, depth, s * kEngDepth);
    }
    cp_async_commit();
    if (u >= 0) {
      const unsigned char* sa = ring + (u % kEngStages) * kEngStage + wg * (64 * 128);
      const unsigned char* sb = ring + (u % kEngStages) * kEngStage + kEngStageA;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kEngDepth / 16; ++kk)
        if (!(SST_TRUNK_SKIP & 16))
          wgmma_m64n256k16(acc, sw128_desc(sa + kk * 32), sw128_desc(sb + kk * 32), u + kk > 0);
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

__device__ inline float prelu(float x, float alpha) { return x >= 0.f ? x : __fmul_rn(alpha, x); }

}  // namespace tcn
