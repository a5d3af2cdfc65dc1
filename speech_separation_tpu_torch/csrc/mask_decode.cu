// Conv-TasNet's mask head and decoder in one pass, for Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves the mask head and the
// decoder to XLA around its Pallas trunk. It serves the streaming engine's
// model call (models/tasnet_serving.py::cuda_apply), whose tail as PyTorch
// operations is the mask bias add, the sigmoid, the product with the encoder's
// features, a transposing copy, the kernel's flip, cuDNN's transposed conv and
// its bias, and the cast to fp32: some eight launches a window, the conv
// alone ~1.6 ms at batch 1 (cuDNN's dgrad kernel) for ~33 MFLOP.
//
// The function: v = sigmoid(logit + mask_b) * feats, rounded once to bf16;
// each frame's win taps are v @ dec_k (bf16 operands, fp32 sums); each output
// sample is the fp32 sum of the taps of the frames that cover it, plus the
// decoder's bias. Frame t writes tap j to sample t * stride + left - j, flax's
// "SAME" ConvTranspose (transpose_kernel=False), left =
// models/tasnet.py::conv_transpose_pads(win, stride)[0].
//
// What bounds it on this card: latency. A 0.5 s hop on 1.5 s of context (K =
// 800 frames, N = 256 channels, 2 speakers, win 40) reads ~1.3 MB and needs
// ~33 MFLOP on the tensor cores: well under a microsecond of either, against
// a launch's few microseconds.
//
// What the design does about it:
// - one launch, no atomics: a block owns kTileFrames frames' worth of output
//   samples of one (item, speaker) and recomputes the halo frames at its edges
//   (frames that reach into a neighbour's tile), so blocks share nothing;
//   K = 800 gives 50 tiles a speaker, 100 blocks at batch 1 on 132 SMs;
// - the block stages its frames' v (bias, sigmoid and product done on the
//   way in, fp32, one rounding to bf16) and the whole decoder kernel in shared
//   memory, with 16-byte loads of the logits and the kernel (the features,
//   channels-first as the encoder leaves them, along the frames); rows are
//   padded by 16 bytes so that ldmatrix's eight rows fall in distinct banks;
// - the tap product (32 staged frames x win taps x N channels) runs on
//   mma.sync m16n8k16 (bf16 in, fp32 accumulators), one warp an (m16, n8)
//   tile of the taps, ldmatrix for the fragments; the taps go to shared
//   memory, and each thread then sums the two (or three) taps of an output
//   sample in fp32 and writes it once, coalesced.
// ops/mask_decode_cuda.py::mask_decode_plain is the same function in PyTorch,
// the CPU's path and the card tests' reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileFrames = 16;  // frames' worth of output samples a block owns
constexpr int kRows = 32;        // frames a block stages: its tile and halos, two m16 tiles
constexpr int kPad = 8;          // bf16 a staged row carries past its channels: 16 bytes
constexpr int kMaxChannels = 512;
constexpr int kMaxWin = 64;

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int ceil_div(int a, int b) { return -floor_div(-a, b); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16 x 16, row-major) @ b (16 x 8, column-major), bf16 in, fp32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __low2float(h);
    v[2 * i + 1] = __high2float(h);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// logits [B, K, S * N] bf16 (the mask product, bias not added); mask_b [S * N]
// bf16; feats [B, N, K] bf16 (the encoder's channels-first output); dec_k
// [win, N] bf16; dec_b [1] bf16; out [B, S, samples] fp32. Grid (tiles, S, B).
__global__ void __launch_bounds__(kThreads)
mask_decode_kernel(const __nv_bfloat16* __restrict__ logits,
                   const __nv_bfloat16* __restrict__ mask_b,
                   const __nv_bfloat16* __restrict__ feats,
                   const __nv_bfloat16* __restrict__ dec_k,
                   const __nv_bfloat16* __restrict__ dec_b, float* __restrict__ out, int frames,
                   int channels, int win, int stride, int left, int samples) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int depth = (channels + 15) & ~15;  // the product's depth: whole k16 steps
  const int ld = depth + kPad;              // bf16 a staged row
  const int win8 = (win + 7) & ~7;  // taps padded to whole n8 tiles
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [kRows][ld]
  __nv_bfloat16* k_s = v_s + kRows * ld;                          // [win8][ld]
  float* taps_s = reinterpret_cast<float*>(k_s + win8 * ld);      // [kRows][win8]

  const int tile = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int speakers = gridDim.y;
  const int o0 = tile * kTileFrames * stride;
  const int o1 = min(o0 + kTileFrames * stride, samples);
  // the frames that reach [o0, o1): frame t covers samples
  // [t * stride + left - win + 1, t * stride + left]
  const int t_lo = max(0, ceil_div(o0 - left, stride));
  const int t_hi = min(frames - 1, floor_div(o1 - 1 - left + win - 1, stride));
  const int nf = t_hi - t_lo + 1;  // <= kRows by the entry's check
  const int chunks = channels / 8, padded = depth / 8;  // 16-byte chunks of a row

  // stage v = bf16(sigmoid(logit + mask_b) * feats) for frames t_lo..t_hi,
  // rows past them and channels past N (to the product's depth) zero; a warp
  // walks the rows of one chunk of 8 channels, so its feats loads run along
  // the frames
  const size_t row_stride = static_cast<size_t>(speakers) * channels;
  const __nv_bfloat16* lg = logits + static_cast<size_t>(b) * frames * row_stride + s * channels;
  for (int i = threadIdx.x; i < kRows * padded; i += kThreads) {
    const int r = i % kRows, c = i / kRows;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (r < nf && c < chunks) {
      const int t = t_lo + r;
      float l[8], m[8], v[8];
      unpack8(*reinterpret_cast<const uint4*>(lg + t * row_stride + 8 * c), l);
      unpack8(*reinterpret_cast<const uint4*>(mask_b + s * channels + 8 * c), m);
      const __nv_bfloat16* f = feats + (static_cast<size_t>(b) * channels + 8 * c) * frames + t;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float fk = __bfloat162float(f[static_cast<size_t>(k) * frames]);
        v[k] = fk * (1.f / (1.f + expf(-(l[k] + m[k]))));
      }
      packed = pack8(v);
    }
    *reinterpret_cast<uint4*>(v_s + r * ld + 8 * c) = packed;
  }
  // the decoder kernel, taps past win and channels past N zero
  for (int i = threadIdx.x; i < win8 * padded; i += kThreads) {
    const int j = i / padded, c = i % padded;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (j < win && c < chunks) {
      packed = *reinterpret_cast<const uint4*>(dec_k + j * channels + 8 * c);
    }
    *reinterpret_cast<uint4*>(k_s + j * ld + 8 * c) = packed;
  }
  __syncthreads();

  // taps[r][j] = sum_c v[r][c] dec_k[j][c]: a warp an (m16, n8) tile, two
  // accumulators over alternate 16-channel steps
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int task = warp; task < 2 * (win8 / 8); task += kWarps) {
    const int m0 = (task & 1) * 16, n0 = (task >> 1) * 8;
    if (m0 >= nf) continue;  // the whole warp: rows of zeros only
    const __nv_bfloat16* a_row = v_s + (m0 + (lane & 15)) * ld + ((lane >> 4) << 3);
    const __nv_bfloat16* b_row = k_s + (n0 + (lane & 7)) * ld + (((lane >> 3) & 1) << 3);
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 2
    for (int k0 = 0; k0 < depth; k0 += 32) {
      uint32_t a[4], bf[2];
      ldmatrix_x4(a, a_row + k0);
      ldmatrix_x2(bf, b_row + k0);
      mma_bf16(acc[0], a, bf);
      if (k0 + 16 < depth) {  // depth is a multiple of 16, not always of 32
        ldmatrix_x4(a, a_row + k0 + 16);
        ldmatrix_x2(bf, b_row + k0 + 16);
        mma_bf16(acc[1], a, bf);
      }
    }
    const int g = lane >> 2, q = 2 * (lane & 3);
    float* t0 = taps_s + (m0 + g) * win8 + n0 + q;
    float* t1 = t0 + 8 * win8;
    t0[0] = acc[0][0] + acc[1][0];
    t0[1] = acc[0][1] + acc[1][1];
    t1[0] = acc[0][2] + acc[1][2];
    t1[1] = acc[0][3] + acc[1][3];
  }
  __syncthreads();

  // each sample: its frames' taps in frame order, then the bias
  const float bias = __bfloat162float(*dec_b);
  float* dst = out + (static_cast<size_t>(b) * speakers + s) * samples;
  for (int o = o0 + threadIdx.x; o < o1; o += kThreads) {
    const int first = max(t_lo, ceil_div(o - left, stride));
    const int last = min(t_hi, floor_div(o - left + win - 1, stride));
    float acc = 0.f;
    for (int t = first; t <= last; ++t) acc += taps_s[(t - t_lo) * win8 + t * stride + left - o];
    dst[o] = acc + bias;
  }
}

}  // namespace

// logits [batch, frames, speakers * channels], mask_b [speakers * channels],
// feats [batch, channels, frames], dec_k [win, channels], dec_b [1], all bf16
// and contiguous, logits, mask_b and dec_k 16-byte aligned;
// out [batch, speakers, samples] fp32, every sample written. channels a
// multiple of 8 up to 512, win 2 to 64, a block's tile and halos within 32
// frames (stride = win / 2 does), 1 <= samples <= frames * stride. Returns
// cudaGetLastError() after the launch.
extern "C" int sst_mask_decode(const void* logits, const void* mask_b, const void* feats,
                               const void* dec_k, const void* dec_b, void* out, int batch,
                               int frames, int speakers, int channels, int win, int stride,
                               int left, int samples, void* stream) {
  if (batch < 1 || batch > 65535 || speakers < 1 || speakers > 65535 || frames < 1 ||
      channels < 8 || channels > kMaxChannels || channels % 8 != 0 || win < 2 ||
      win > kMaxWin || stride < 1 || left < 0 || left > win - 1 || samples < 1 ||
      samples > frames * stride || kTileFrames + (win + stride - 2) / stride + 1 > kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int win8 = (win + 7) & ~7;
  const int depth = (channels + 15) & ~15;
  const size_t smem = static_cast<size_t>(kRows + win8) * (depth + kPad) * 2 +
                      static_cast<size_t>(kRows) * win8 * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mask_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (samples + kTileFrames * stride - 1) / (kTileFrames * stride);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(speakers),
                  static_cast<unsigned>(batch));
  mask_decode_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(logits), static_cast<const __nv_bfloat16*>(mask_b),
      static_cast<const __nv_bfloat16*>(feats), static_cast<const __nv_bfloat16*>(dec_k),
      static_cast<const __nv_bfloat16*>(dec_b), static_cast<float*>(out), frames, channels, win,
      stride, left, samples);
  return static_cast<int>(cudaGetLastError());
}
