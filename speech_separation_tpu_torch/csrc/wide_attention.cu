// Attention probabilities at wide heads, softmax(Q K^T * scale), for Hopper,
// sm_90a: one launch a call.
//
// Replaces no TPU kernel: the JAX package has no TF-GridNet. It serves the
// full-band self-attention of models/tfgridnet.py, whose heads flatten a
// frame's (channel, frequency) plane: Q and K rows of E x F = 4 x 129 = 516
// values, V rows of 32 x 129 = 4,128, over L = T frames (1,253 at 10 s).
// SDPA's flash kernel stops at head size 256, and neither width is a
// multiple of 16 or 64, so nothing in the port computed it.
//
// What it computes: for each of N = batch x heads items, P [L, L] in bf16,
// P[i, j] = exp(s_ij - max_j s_ij) / sum_j exp(s_ij - max_j s_ij), with
// s_ij = scale * q_i . k_j. The products run on the tensor cores (bf16
// operands, fp32 sums); the row maximum and sum stay fp32 and each
// probability is rounded once, to nearest even, into bf16. P.V is a plain
// large product that the caller leaves to cuBLAS (ops/wide_attention_cuda.py).
//
// What bounds it on this card: reading Q and K (2 N L d bf16) and writing P
// (N L^2 bf16) against 2 N L^2 d operations, ~283 operations a byte at d =
// 516 and L = 1,253: at the bf16 ridge of ~295, so bytes and operations
// bound it alike (16 x 10 s with 4 heads: 366 MB, 0.109 ms; 104 GFLOP,
// 0.105 ms).
//
// What the design does about it:
// - a block owns 64 query rows of one item (16 a warp) and walks every key
//   tile of 64 keys twice: the first pass keeps each row's running maximum
//   and sum (the online softmax's rescaling, fp32), the second recomputes
//   the scores and writes exp(s - max) / sum. Recomputing doubles the
//   products but keeps P written once and no fp32 score matrix in memory,
//   for any L;
// - each score tile is sum over chunks of 32 depth values of
//   mma.sync.m16n8k16 (eight n8 tiles a warp), Q's and K's chunks staged in
//   shared memory by all 128 threads, the next chunk loaded into registers
//   while this one multiplies (two buffers, one barrier a chunk), rows 80
//   bytes apart so the fragment reads of a warp hit 32 distinct banks;
// - the ragged edges are handled here and nothing is padded in device
//   memory: depth past d and query or key rows past L are zeros in shared
//   memory, keys past L score -inf and are not written; 8-byte loads where
//   d is a multiple of 4 and the pointers allow it (d = 516), else 2-byte;
// - a warp stages its 16 rows of a probability tile in shared memory and
//   writes them row by row, 32 consecutive bf16 a store, whatever L's parity.
// ops/wide_attention_cuda.py::wide_attention_scores_plain is the same
// function in PyTorch (fp32 scores, softmax, cast), the CPU's path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 64;     // query rows a block
constexpr int kKeys = 64;     // keys a tile
constexpr int kDepth = 32;    // depth a chunk: two k16 steps
constexpr int kStride = kDepth + 8;  // bf16 a staged row (80 bytes)
constexpr int kOutStride = kKeys + 8;  // bf16 a staged probability row
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kElems = kRows * kDepth / kThreads;  // values a thread stages a chunk, of Q and of K

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = uint2;
};
template <>
struct Vec<1> {
  using T = unsigned short;
};

// One chunk of Q and K held in registers between its load and its store.
template <int V>
struct Staged {
  typename Vec<V>::T q[kElems / V];
  typename Vec<V>::T k[kElems / V];
};

// Rows row0 .. row0 + 63 of src [L, d], depth c0 .. c0 + 31; zeros past L and d.
template <int V>
__device__ __forceinline__ void load_chunk(typename Vec<V>::T (&out)[kElems / V],
                                           const __nv_bfloat16* src, int row0, int c0, int L,
                                           int d) {
  using T = typename Vec<V>::T;
#pragma unroll
  for (int i = 0; i < kElems / V; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int row = row0 + e / (kDepth / V);
    const int col = c0 + (e % (kDepth / V)) * V;
    T v{};
    if (row < L && col < d) v = *reinterpret_cast<const T*>(src + static_cast<size_t>(row) * d + col);
    out[i] = v;
  }
}

template <int V>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* dst,
                                            const typename Vec<V>::T (&in)[kElems / V]) {
  using T = typename Vec<V>::T;
#pragma unroll
  for (int i = 0; i < kElems / V; ++i) {
    const int e = threadIdx.x + i * kThreads;
    *reinterpret_cast<T*>(dst + (e / (kDepth / V)) * kStride + (e % (kDepth / V)) * V) = in[i];
  }
}

// acc[4 nt + r] += the warp's 16 rows of sq by keys 8 nt .. 8 nt + 7 of sk,
// over the chunk's 32 depth values (mma fragment register c_r of tile nt).
__device__ __forceinline__ void multiply_chunk(const __nv_bfloat16* sq, const __nv_bfloat16* sk,
                                               float (&acc)[32], int warp, int lane) {
  const uint32_t* a32 = reinterpret_cast<const uint32_t*>(sq + warp * 16 * kStride);
  const uint32_t* b32 = reinterpret_cast<const uint32_t*>(sk);
  constexpr int s32 = kStride / 2;
  const int g = lane >> 2;
  const int c = lane & 3;
#pragma unroll
  for (int kt = 0; kt < kDepth / 16; ++kt) {
    const int kb = kt * 8;
    const uint32_t a0 = a32[g * s32 + kb + c];
    const uint32_t a1 = a32[(g + 8) * s32 + kb + c];
    const uint32_t a2 = a32[g * s32 + kb + 4 + c];
    const uint32_t a3 = a32[(g + 8) * s32 + kb + 4 + c];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = nt * 8 + g;
      const uint32_t b0 = b32[n * s32 + kb + c];
      const uint32_t b1 = b32[n * s32 + kb + 4 + c];
      float* dd = acc + 4 * nt;
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(dd[0]), "+f"(dd[1]), "+f"(dd[2]), "+f"(dd[3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// q, k [N, L, d] bf16; p [N, L, L] bf16. Block b: item b / row_blocks, query
// rows 64 (b % row_blocks) ... scale_log2 is scale x log2(e): the scores are
// kept in base 2, so exp(s - max) is exp2f of their difference.
template <int V>
__global__ void __launch_bounds__(kThreads)
wide_attention_scores_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k, __nv_bfloat16* __restrict__ p,
                             int L, int d, float scale_log2, int row_blocks) {
  __shared__ __align__(16) __nv_bfloat16 sq[2][kRows * kStride];
  __shared__ __align__(16) __nv_bfloat16 sk[2][kKeys * kStride];
  __shared__ __align__(16) __nv_bfloat16 so[kRows * kOutStride];
  const int item = blockIdx.x / row_blocks;
  const int row0 = (blockIdx.x % row_blocks) * kRows;
  const size_t plane = static_cast<size_t>(L) * d;
  const __nv_bfloat16* qn = q + item * plane;
  const __nv_bfloat16* kn = k + item * plane;
  __nv_bfloat16* pn = p + static_cast<size_t>(item) * L * L;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int chunks = (d + kDepth - 1) / kDepth;
  const int steps = ((L + kKeys - 1) / kKeys) * chunks;
  const float inf = __int_as_float(0x7f800000);
  // rows g and g + 8 of the warp: the running maximum (the same in the four
  // lanes of a quad) and this lane's share of the running sum
  float run_max[2] = {-inf, -inf};
  float run_sum[2] = {0.f, 0.f};
  float inv[2] = {0.f, 0.f};
  for (int pass = 0; pass < 2; ++pass) {
    Staged<V> st;
    load_chunk<V>(st.q, qn, row0, 0, L, d);
    load_chunk<V>(st.k, kn, 0, 0, L, d);
    store_chunk<V>(sq[0], st.q);
    store_chunk<V>(sk[0], st.k);
    __syncthreads();
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int s = 0; s < steps; ++s) {
      const int tile = s / chunks;
      const int chunk = s - tile * chunks;
      const bool more = s + 1 < steps;
      if (more) {
        const int nt = (s + 1) / chunks;
        const int nc = (s + 1) - nt * chunks;
        load_chunk<V>(st.q, qn, row0, nc * kDepth, L, d);
        load_chunk<V>(st.k, kn, nt * kKeys, nc * kDepth, L, d);
      }
      multiply_chunk(sq[s & 1], sk[s & 1], acc, warp, lane);
      if (chunk == chunks - 1) {
        const int key0 = tile * kKeys;
        if (pass == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float m = -inf;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int key = key0 + nt * 8 + 2 * c + j;
                if (key < L) m = fmaxf(m, acc[4 * nt + 2 * h + j] * scale_log2);
              }
            }
            const float next = fmaxf(run_max[h], quad_max(m));
            float sum = run_sum[h] * exp2f(run_max[h] - next);
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int key = key0 + nt * 8 + 2 * c + j;
                if (key < L) sum += exp2f(acc[4 * nt + 2 * h + j] * scale_log2 - next);
              }
            }
            run_max[h] = next;
            run_sum[h] = sum;
          }
        } else {
          __nv_bfloat16* tile_rows = so + warp * 16 * kOutStride;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              const float e0 = exp2f(acc[4 * nt + 2 * h] * scale_log2 - run_max[h]) * inv[h];
              const float e1 = exp2f(acc[4 * nt + 2 * h + 1] * scale_log2 - run_max[h]) * inv[h];
              *reinterpret_cast<__nv_bfloat162*>(tile_rows + (g + 8 * h) * kOutStride + nt * 8 +
                                                 2 * c) = __floats2bfloat162_rn(e0, e1);
            }
          }
          __syncwarp();
          for (int r = 0; r < 16; ++r) {
            const int row = row0 + warp * 16 + r;
            if (row >= L) break;
            __nv_bfloat16* dst = pn + static_cast<size_t>(row) * L + key0;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int col = lane + 32 * j;
              if (key0 + col < L) dst[col] = tile_rows[r * kOutStride + col];
            }
          }
          __syncwarp();
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      }
      if (more) {
        store_chunk<V>(sq[(s + 1) & 1], st.q);
        store_chunk<V>(sk[(s + 1) & 1], st.k);
      }
      __syncthreads();
    }
    if (pass == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) inv[h] = 1.f / quad_sum(run_sum[h]);
    }
  }
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

// q, k [items, L, d] bf16 and p [items, L, L] bf16, contiguous; p = softmax
// over each row of q k^T * scale. 8-byte loads where d % 4 == 0 and q and k
// are 8-byte aligned, else 2-byte. Returns cudaGetLastError() after the
// launch.
extern "C" int sst_wide_attention_scores(const void* q, const void* k, void* p, int items, int L,
                                         int d, float scale, void* stream) {
  if (items < 0 || L < 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (items == 0 || L == 0) return static_cast<int>(cudaGetLastError());
  const int row_blocks = (L + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(items) * row_blocks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  auto* pb = static_cast<__nv_bfloat16*>(p);
  const float scale_log2 = scale * 1.4426950408889634f;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned(q, 8) && aligned(k, 8)) {
    wide_attention_scores_kernel<4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        qb, kb, pb, L, d, scale_log2, row_blocks);
  } else {
    wide_attention_scores_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        qb, kb, pb, L, d, scale_log2, row_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
