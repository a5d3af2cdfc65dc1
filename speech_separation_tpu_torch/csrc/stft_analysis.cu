// Fused STFT analysis (framing + Blackman window + DFT) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel speech_separation_tpu/ops/stft_pallas.py
// (stft_pallas -> _stft_pallas_padded, body _make_kernel): every frame of a
// fade-padded signal is multiplied by the windowed DFT basis [size, 2*bins]
// (cos block, then -sin block), and only the spectrum [B, F, 2*bins] is
// written. The framed [F, size] intermediate never exists in device memory.
//
// What bounds it on this card: at size 256 the product does 2*256 flops per
// output value, 2*256*258 per frame, and reads 128 new samples per frame, so
// it is compute-bound in fp32 (the DSP runs at full fp32, as the reference's
// Precision.HIGHEST does: no TF32, no tensor cores). The basis is 264,192
// bytes in fp32, more than a block's 227 KB of shared memory.
//
// What the design does about it:
// - grid (column tile, frame tile, batch); each block computes a 64-frame by
//   64-column tile of the output with 256 threads and a 4x4 register tile
//   per thread (plain fp32 FMA);
// - the block's overlapping sample chunk, (tile_frames - 1) * shift + size
//   samples, is loaded once into shared memory and frames are read from it
//   by offset (frame f starts at f * shift), never gathered in memory;
// - the basis is streamed through shared memory 32 rows at a time for the
//   block's 64 columns only, so it never has to fit whole; it stays in L2;
// - 2*bins = 258 is not a multiple of the column tile: the ragged column
//   tile, the last frame tile and the chunk past the signal's end are masked.
// Tensor-core DFT (3xTF32 or wgmma) and TMA loads are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTileFrames = 64;
constexpr int kTileCols = 64;
constexpr int kTileK = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stft_analysis_kernel(const float* __restrict__ signal, const float* __restrict__ basis,
                     float* __restrict__ out, int samples, int frames, int size, int shift,
                     int cols) {
  extern __shared__ float smem[];
  const int chunk_len = (kTileFrames - 1) * shift + size;
  float* chunk = smem;                // [chunk_len] samples of this frame tile
  float* btile = smem + chunk_len;    // [kTileK][kTileCols] slice of the basis

  const int b = blockIdx.z;
  const int f0 = blockIdx.y * kTileFrames;
  const int c0 = blockIdx.x * kTileCols;
  const float* sig = signal + static_cast<size_t>(b) * samples;
  const long s0 = static_cast<long>(f0) * shift;
  for (int i = threadIdx.x; i < chunk_len; i += kThreads) {
    const long s = s0 + i;
    chunk[i] = s < samples ? sig[s] : 0.f;
  }

  const int tx = threadIdx.x % 16;  // columns c0 + tx + 16 * q
  const int ty = threadIdx.x / 16;  // frames  f0 + ty + 16 * r
  float acc[4][4] = {};
  for (int k0 = 0; k0 < size; k0 += kTileK) {
    __syncthreads();  // chunk written (first pass) and the last btile consumed
    for (int i = threadIdx.x; i < kTileK * kTileCols; i += kThreads) {
      const int n = k0 + i / kTileCols;
      const int c = c0 + i % kTileCols;
      btile[i] = (n < size && c < cols) ? basis[static_cast<size_t>(n) * cols + c] : 0.f;
    }
    __syncthreads();
    const int kmax = min(kTileK, size - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float a[4];
      float w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = chunk[(ty + 16 * r) * shift + k0 + kk];
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = btile[kk * kTileCols + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a[r], w[q], acc[r][q]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int f = f0 + ty + 16 * r;
    if (f >= frames) continue;
    float* row = out + (static_cast<size_t>(b) * frames + f) * cols;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + tx + 16 * q;
      if (c < cols) row[c] = acc[r][q];
    }
  }
}

}  // namespace

// signal [batch, samples] fp32, already fade- and frame-padded;
// basis [size, cols] fp32 with cols = 2 * (size / 2 + 1);
// out [batch, frames, cols] fp32. Returns cudaGetLastError() after the launch.
extern "C" int sst_stft_analysis(const void* signal, const void* basis, void* out, int batch,
                                 int samples, int frames, int size, int shift, int cols,
                                 void* stream) {
  const int chunk_len = (kTileFrames - 1) * shift + size;
  const size_t smem = static_cast<size_t>(chunk_len + kTileK * kTileCols) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stft_analysis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((cols + kTileCols - 1) / kTileCols, (frames + kTileFrames - 1) / kTileFrames,
                  batch);
  stft_analysis_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(signal), static_cast<const float*>(basis),
      static_cast<float*>(out), samples, frames, size, shift, cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
