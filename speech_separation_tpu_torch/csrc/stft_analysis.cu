// Fused STFT analysis (framing + Blackman window + real FFT) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel speech_separation_tpu/ops/stft_pallas.py
// (stft_pallas -> _stft_pallas_padded, body _make_kernel), which multiplies
// every frame of a fade-padded signal by the windowed DFT basis. That dense
// product was the TPU's choice (it had no FFT); here each frame gets a real
// FFT, and the spectrum is the same function: fade pads of size - shift,
// trailing zero frames, the symmetric Blackman window, bins 0..size/2.
//
// What bounds it on this card: a real FFT needs ~2.5 N log2 N operations a
// frame (5.1 k at N = 256), so the function is bound by bytes: each sample
// read once, each complex bin written once (8 bytes for every 4 read at
// N = 256, shift = 128).
//
// What the design does about it:
// - a block takes one utterance and a tile of frames, and stages the tile's
//   overlapping sample chunk, (tile - 1) * shift + size samples, straight
//   from the unpadded signal with 16-byte loads; the fade offset is folded
//   into the index and samples outside [0, samples) read as zero, so no
//   padded copy of the signal exists;
// - each frame's size real points are taken as size/2 complex points
//   z[m] = w[2m] x[2m] + i w[2m+1] x[2m+1], the window applied as the first
//   FFT stage reads them from the chunk;
// - the size/2-point complex FFT runs as Stockham radix-4 stages (a radix-2
//   stage last when log2(size/2) is odd) between two shared-memory buffers,
//   one butterfly a thread at a time, natural order out, no bit reversal;
// - the split step turns Z into bins X[k] = E + W^k O, E = (Z[k] + Z*[M-k])/2,
//   O = -i (Z[k] - Z*[M-k])/2, and writes interleaved complex64 [B, F, bins, 2]
//   with consecutive threads on consecutive bins (the tile's rows are one
//   contiguous range), so the wrapper returns a view of it with no copy;
// - twiddles come from a table built in float64 on the host and rounded to
//   fp32 (window[size], then exp(-2 pi i k / size) for k < size), read
//   through the read-only cache: no fast-math sines.
// ops/stft_cuda.py::stft_fft_plain repeats this decomposition in PyTorch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline int tile_frames(int half) {
  const int t = 2048 / half;
  return t < 1 ? 1 : (t > 64 ? 64 : t);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float sample_at(const float* row, long s, int samples) {
  return (s >= 0 && s < samples) ? __ldg(row + s) : 0.f;
}

// One radix-4 Stockham stage over every frame of the tile: input element
// q + s (p + r n/4) of each frame, output q + s (4 p + r), for butterfly
// j = p s + q. `load(frame, index)` gives the input point.
template <typename Load>
__device__ __forceinline__ void radix4_stage(Load load, float2* __restrict__ y, int frames,
                                             int half, int n, int s, const float2* __restrict__ tw,
                                             int tw_step) {
  const int quarter = half / 4;  // butterflies a frame; n / 4 * s
  const int n1 = n / 4;
  for (int i = threadIdx.x; i < frames * quarter; i += kThreads) {
    const int fr = i / quarter;
    const int j = i - fr * quarter;
    const int p = j / s;
    const int q = j - p * s;
    const float2 a = load(fr, q + s * p);
    const float2 b = load(fr, q + s * (p + n1));
    const float2 c = load(fr, q + s * (p + 2 * n1));
    const float2 d = load(fr, q + s * (p + 3 * n1));
    const float2 apc = make_float2(a.x + c.x, a.y + c.y);
    const float2 amc = make_float2(a.x - c.x, a.y - c.y);
    const float2 bpd = make_float2(b.x + d.x, b.y + d.y);
    const float2 jbmd = make_float2(d.y - b.y, b.x - d.x);  // i (b - d)
    float2* out = y + fr * half + q + s * 4 * p;
    out[0] = make_float2(apc.x + bpd.x, apc.y + bpd.y);
    out[s] = cmul(__ldg(tw + p * tw_step), make_float2(amc.x - jbmd.x, amc.y - jbmd.y));
    out[2 * s] = cmul(__ldg(tw + 2 * p * tw_step), make_float2(apc.x - bpd.x, apc.y - bpd.y));
    out[3 * s] = cmul(__ldg(tw + 3 * p * tw_step), make_float2(amc.x + jbmd.x, amc.y + jbmd.y));
  }
}

__global__ void __launch_bounds__(kThreads)
stft_fft_kernel(const float* __restrict__ signal, const float* __restrict__ table,
                float2* __restrict__ out, int samples, int frames, int size, int shift, int pad) {
  extern __shared__ float4 smem4[];
  const int half = size / 2;
  const int tile = tile_frames(half);
  const int chunk_len = (tile - 1) * shift + size;
  const int chunk_alloc = (chunk_len + 3 + 3) & ~3;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * tile;
  const int nfr = min(tile, frames - f0);
  const float* row = signal + static_cast<size_t>(b) * samples;
  const long s_begin = static_cast<long>(f0) * shift - pad;

  // Stage the chunk: sample s_begin + i at chunk[i]. The chunk starts `lead`
  // floats into shared memory so that 16-byte groups of the signal land on
  // 16-byte shared addresses.
  const long first = static_cast<long>(reinterpret_cast<uintptr_t>(row) / 4) + s_begin;
  const int head = static_cast<int>(((4 - first % 4) % 4 + 4) % 4);
  float* chunk = reinterpret_cast<float*>(smem4) + ((4 - head) & 3);
  const int groups = max(0, (chunk_len - head) / 4);
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    const int i = head + 4 * g;
    const long s = s_begin + i;
    float4 v;
    if (s >= 0 && s + 3 < samples) {
      v = __ldg(reinterpret_cast<const float4*>(row + s));
    } else {
      v = make_float4(sample_at(row, s, samples), sample_at(row, s + 1, samples),
                      sample_at(row, s + 2, samples), sample_at(row, s + 3, samples));
    }
    *reinterpret_cast<float4*>(chunk + i) = v;
  }
  for (int i = threadIdx.x; i < min(head, chunk_len); i += kThreads)
    chunk[i] = sample_at(row, s_begin + i, samples);
  for (int i = head + 4 * groups + threadIdx.x; i < chunk_len; i += kThreads)
    chunk[i] = sample_at(row, s_begin + i, samples);
  __syncthreads();

  const float* window = table;
  const float2* tw = reinterpret_cast<const float2*>(table + size);  // exp(-2 pi i k / size)
  float2* buf[2] = {reinterpret_cast<float2*>(reinterpret_cast<float*>(smem4) + chunk_alloc),
                    reinterpret_cast<float2*>(reinterpret_cast<float*>(smem4) + chunk_alloc) +
                        tile * half};

  // First stage (n = half, s = 1), reading windowed (even, odd) pairs from the chunk.
  auto from_chunk = [&](int fr, int m) {
    const float* x = chunk + fr * shift + 2 * m;
    return make_float2(x[0] * __ldg(window + 2 * m), x[1] * __ldg(window + 2 * m + 1));
  };
  radix4_stage(from_chunk, buf[0], nfr, half, half, 1, tw, 2);
  __syncthreads();
  int cur = 0;
  int n = half / 4;
  int s = 4;
  for (; n >= 4; n /= 4, s *= 4) {
    const float2* x = buf[cur];
    auto from_buf = [&](int fr, int m) { return x[fr * half + m]; };
    radix4_stage(from_buf, buf[cur ^ 1], nfr, half, n, s, tw, size / n);
    cur ^= 1;
    __syncthreads();
  }
  if (n == 2) {  // radix-2 stage, s = half / 2: y[q] = a + b, y[q + s] = a - b
    const float2* x = buf[cur];
    float2* y = buf[cur ^ 1];
    for (int i = threadIdx.x; i < nfr * s; i += kThreads) {
      const int fr = i / s;
      const int q = i - fr * s;
      const float2 a = x[fr * half + q];
      const float2 c = x[fr * half + q + s];
      y[fr * half + q] = make_float2(a.x + c.x, a.y + c.y);
      y[fr * half + q + s] = make_float2(a.x - c.x, a.y - c.y);
    }
    cur ^= 1;
    __syncthreads();
  }

  // Split step to bins 0..half, written as one contiguous range of the tile's rows.
  const float2* z = buf[cur];
  const int bins = half + 1;
  float2* dst = out + (static_cast<size_t>(b) * frames + f0) * bins;
  for (int i = threadIdx.x; i < nfr * bins; i += kThreads) {
    const int fr = i / bins;
    const int k = i - fr * bins;
    const float2 zk = z[fr * half + (k == half ? 0 : k)];
    const float2 zm = z[fr * half + (k == 0 ? 0 : half - k)];  // conj taken below
    const float2 e = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
    const float2 o = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
    const float2 w = __ldg(tw + k);
    const float2 wo = cmul(w, o);
    dst[i] = make_float2(e.x + wo.x, e.y + wo.y);
  }
}

}  // namespace

// signal [batch, samples] fp32, unpadded; table [3 * size] fp32 (window, then
// size complex twiddles); out [batch, frames, size / 2 + 1] complex64. size a
// power of two in [16, 1024], shift dividing it, pad = size - shift with
// fading, else 0. Returns cudaGetLastError() after the launch.
extern "C" int sst_stft_analysis(const void* signal, const void* table, void* out, int batch,
                                 int samples, int frames, int size, int shift, int pad,
                                 void* stream) {
  if (size < 16 || size > 1024 || (size & (size - 1)) != 0 || shift < 1 || size % shift != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int half = size / 2;
  const int tile = tile_frames(half);
  const int chunk_len = (tile - 1) * shift + size;
  const int chunk_alloc = (chunk_len + 3 + 3) & ~3;
  const size_t smem = static_cast<size_t>(chunk_alloc) * sizeof(float) +
                      2 * static_cast<size_t>(tile) * half * sizeof(float2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stft_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((frames + tile - 1) / tile, batch);
  stft_fft_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(signal), static_cast<const float*>(table),
      static_cast<float2*>(out), samples, frames, size, shift, pad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
