// Nearest-codebook search for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel speech_separation_tpu/ops/vq_pallas.py
// (nearest_code_pallas -> _nearest_code_impl, body _nearest_kernel): for each
// row x_n of flat [N, D], the index of the codebook column e_k of codebook
// [D, K] with the least score ||e_k||^2 - 2 x_n . e_k (the squared distance
// less ||x_n||^2, which is the same for every k), with no [N, K] score matrix
// in device memory.
//
// Arithmetic: plain fp32 FMA, the reference's Precision.HIGHEST (no TF32 and
// no tensor cores: TF32 keeps ~3 decimal digits and flips near-tie argmins).
// Each dot product sums over d = 0..D-1 in order, and the score is
// fmaf(-2, dot, ||e||^2), which rounds exactly as ||e||^2 - 2 * dot does.
// Exact ties go to the lowest index, as jnp.argmin and torch.argmin do: each
// thread visits its codes in ascending order with a strict <, and the merge
// across threads compares (score, index) lexicographically.
//
// What bounds it on this card: 2*N*D*K operations against 4*(N*D + D*K + N)
// compulsory bytes. At the codec's shapes (N = 12,800, D = 64, K = 512 and
// N = 51,200, D = 16, K = 512) that is ~100 operations a byte, five times the
// fp32 ridge of 67e12 / 3.35e12 = 20, so operations bound it: ~12.5 us each.
//
// What the design does about it:
// - a block of 256 threads (8 warps) owns 64 rows, staged once in shared
//   memory as [D][64];
// - the codebook streams through shared memory 128 codes at a time, as
//   [D][128], and each chunk's ||e||^2 is computed once per block;
// - each thread computes an 8-row by 4-code register tile: per d, two
//   broadcast 16-byte loads of x and four conflict-free loads of e feed 32
//   FMAs, so the FMA pipes, not shared memory, set the pace;
// - a warp covers 8 rows by the chunk's 128 codes; its 32 lanes keep a
//   running (score, index) per row and are merged by shuffles at the end;
// - 64 rows a block keeps the codebook's re-reads from L2 to N/64 times its
//   size (25 MB at N = 12,800), and gives 200 blocks there and 800 at
//   N = 51,200, all resident at once on 132 SMs.
// Only the real K is visited (the ragged last chunk is masked), so no
// FLT_MAX padding is needed; ragged N is masked on load and on store.
// Shared memory is (64 + 128) * D * 4 + 512 bytes, 48.5 KB at D = 64, so the
// launch opts in to dynamic shared memory above 48 KB; D <= 256 fits.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kRows = 64;          // rows a block
constexpr int kCodes = 128;        // codes a shared-memory chunk
constexpr int kThreads = 256;      // 8 warps
constexpr int kRowsPerWarp = 8;    // kRows / 8 warps
constexpr int kCodesPerLane = 4;   // kCodes / 32 lanes
constexpr int kMaxDim = 256;

__global__ void __launch_bounds__(kThreads)
nearest_code_kernel(const float* __restrict__ flat, const float* __restrict__ codebook,
                    int* __restrict__ out, int rows, int dim, int codes) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [dim][kRows]
  float* es = smem + dim * kRows;            // [dim][kCodes]
  float* esq = es + dim * kCodes;            // [kCodes]

  const int n0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // the block's rows, transposed; rows past N are zero and never stored
  for (int i = threadIdx.x; i < kRows * dim; i += kThreads) {
    const int r = i / dim;
    const int d = i - r * dim;
    const int n = n0 + r;
    xs[d * kRows + r] = n < rows ? flat[static_cast<size_t>(n) * dim + d] : 0.f;
  }

  float best[kRowsPerWarp];
  int best_idx[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    best[r] = __int_as_float(0x7f800000);  // +inf
    best_idx[r] = INT_MAX;
  }

  for (int k0 = 0; k0 < codes; k0 += kCodes) {
    __syncthreads();  // xs written (first chunk); the previous chunk consumed
    for (int i = threadIdx.x; i < dim * kCodes; i += kThreads) {
      const int d = i / kCodes;
      const int c = i - d * kCodes;
      const int k = k0 + c;
      es[i] = k < codes ? codebook[static_cast<size_t>(d) * codes + k] : 0.f;
    }
    __syncthreads();
    if (threadIdx.x < kCodes) {
      float s = 0.f;
      for (int d = 0; d < dim; ++d) {
        const float e = es[d * kCodes + threadIdx.x];
        s = fmaf(e, e, s);
      }
      esq[threadIdx.x] = s;
    }
    __syncthreads();

    float acc[kRowsPerWarp][kCodesPerLane] = {};
    const float* xrow = xs + warp * kRowsPerWarp;
#pragma unroll 4
    for (int d = 0; d < dim; ++d) {
      const float4 xa = *reinterpret_cast<const float4*>(xrow + d * kRows);
      const float4 xb = *reinterpret_cast<const float4*>(xrow + d * kRows + 4);
      const float x[kRowsPerWarp] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      float e[kCodesPerLane];
#pragma unroll
      for (int j = 0; j < kCodesPerLane; ++j) e[j] = es[d * kCodes + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int j = 0; j < kCodesPerLane; ++j) acc[r][j] = fmaf(x[r], e[j], acc[r][j]);
    }

#pragma unroll
    for (int j = 0; j < kCodesPerLane; ++j) {
      const int c = lane + 32 * j;
      if (k0 + c < codes) {  // the ragged last chunk: codes past K are skipped
        const float sq = esq[c];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float score = fmaf(-2.f, acc[r][j], sq);
          if (score < best[r]) {
            best[r] = score;
            best_idx[r] = k0 + c;
          }
        }
      }
    }
  }

  // merge the 32 lanes' (score, index) per row; every lane ends with the result
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      const float other = __shfl_xor_sync(0xffffffffu, best[r], offset);
      const int other_idx = __shfl_xor_sync(0xffffffffu, best_idx[r], offset);
      if (other < best[r] || (other == best[r] && other_idx < best_idx[r])) {
        best[r] = other;
        best_idx[r] = other_idx;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int n = n0 + warp * kRowsPerWarp + r;
    // a row whose every score is NaN keeps no index: it gets 0
    if (lane == r && n < rows) out[n] = best_idx[r] == INT_MAX ? 0 : best_idx[r];
  }
}

}  // namespace

// flat [rows, dim] fp32, codebook [dim, codes] fp32, both contiguous;
// out [rows] int32. 1 <= dim <= 256, codes >= 1. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a shape it does not take).
extern "C" int sst_nearest_code(const void* flat, const void* codebook, void* out, int rows,
                                int dim, int codes, void* stream) {
  if (rows < 0 || dim < 1 || dim > kMaxDim || codes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = (static_cast<size_t>(kRows + kCodes) * dim + kCodes) * sizeof(float);
  // the opt-in above 48 KB, once per device and size (a runtime API call per
  // launch would add host time to every search)
  static size_t opted_in[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024 && (device >= 64 || smem > opted_in[device])) {
    err = cudaFuncSetAttribute(nearest_code_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 64) opted_in[device] = smem;
  }
  const int blocks = (rows + kRows - 1) / kRows;
  nearest_code_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(flat), static_cast<const float*>(codebook),
      static_cast<int*>(out), rows, dim, codes);
  return static_cast<int>(cudaGetLastError());
}
