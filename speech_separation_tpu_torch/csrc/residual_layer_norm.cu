// Residual add and LayerNorm in one pass, for Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package has no SepFormer. It serves the
// pre-LN transformer layers of models/sepformer.py, where every residual add
// of the fp32 stream is followed by the LayerNorm of the next product (the
// next in-projection, FFN or, last, the stack's final norm), and
// models/tfgridnet.py, whose channels-last stream adds each half's branch and
// normalises the next half's input over its 128 channels (eps 1e-5). Written as
// PyTorch operations those are three passes over the stream: x + y (read
// fp32 x and bf16 y, write fp32), LayerNorm (read and write fp32) and the
// cast to the product's bf16 (read fp32, write bf16), 24 bytes an element.
// This kernel reads x and y once and writes x + y (fp32, over x) and
// LN(x + y) (bf16 or fp32): 12 bytes an element with a bf16 branch and bf16
// rows. With no y it only normalises (the first norm of a stack): 6 bytes.
//
// What bounds it on this card: bytes. LayerNorm does ~8 operations an
// element against 12 bytes, far below the ridge, so the least time is the
// compulsory traffic over 3.35 TB/s (SepFormer's 16 x 10 s batch: 324,000
// rows of 256, 1.00 GB a call, 0.30 ms).
//
// What the design does about it:
// - one warp a row, eight rows a block of 256 threads; a lane holds its
//   chunks of V consecutive elements (chunk k of the row at lane k % 32), so
//   each load and store of the warp covers 32 consecutive chunks: 16-byte
//   fp32 and 8-byte bf16 accesses where d and the pointers allow V = 4;
//   lanes past d are masked;
// - the row stays in registers (at most 32 values a lane, d <= 1024): the
//   mean is a warp shuffle sum, then the centred variance is summed from the
//   same registers, so nothing is read twice and the statistics are two-pass
//   fp32 (no catastrophic cancellation);
// - x + y is the fp32 sum PyTorch's x + y.float() computes, bit for bit,
//   written in place over x; the normed rows are rounded once, to nearest
//   even, into the output's dtype;
// - gamma and beta (d floats each) come through the read-only cache, shared
//   by every row.
// ops/layer_norm_cuda.py::residual_layer_norm_plain is the same function in
// PyTorch (x + y.float(), F.layer_norm, a cast), the CPU's and autograd's
// path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // rows a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDim = 1024;  // 32 values a lane

template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
    v[0] = __low2float(a); v[1] = __high2float(a); v[2] = __low2float(b); v[3] = __high2float(b);
  } else if constexpr (V == 2) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
    v[0] = __low2float(a); v[1] = __high2float(a);
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

template <int V>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 t;
    t.x = *reinterpret_cast<const uint32_t*>(&a);
    t.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = t;
  } else if constexpr (V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// x [rows, dim] fp32 (x + y written back over it where y is given); y
// [rows, dim] bf16 or fp32, or null; out [rows, dim] bf16 or fp32. A lane
// holds C chunks of V elements: chunk lane + 32 c of the row.
template <int V, int C>
__global__ void __launch_bounds__(kThreads)
residual_layer_norm_kernel(float* __restrict__ x, const void* __restrict__ y,
                           const float* __restrict__ gamma, const float* __restrict__ beta,
                           void* __restrict__ out, int rows, int dim, int y_bf16, int out_bf16,
                           float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: one row a warp
  const int chunks = dim / V;
  const size_t base = static_cast<size_t>(row) * dim;
  float v[C][V];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = lane + 32 * c;
    if (k < chunks) {
      const size_t at = base + static_cast<size_t>(k) * V;
      load_f32<V>(x + at, v[c]);
      if (y != nullptr) {
        float w[V];
        if (y_bf16) {
          load_bf16<V>(static_cast<const __nv_bfloat16*>(y) + at, w);
        } else {
          load_f32<V>(static_cast<const float*>(y) + at, w);
        }
#pragma unroll
        for (int i = 0; i < V; ++i) v[c][i] += w[i];
        store_f32<V>(x + at, v[c]);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) sum += v[c][i];
    }
  }
  const float mean = warp_sum(sum) / static_cast<float>(dim);
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (lane + 32 * c < chunks) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = v[c][i] - mean;
        sq = fmaf(d, d, sq);
      }
    }
  }
  const float rstd = 1.f / sqrtf(warp_sum(sq) / static_cast<float>(dim) + eps);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = lane + 32 * c;
    if (k < chunks) {
      float g[V], b[V], o[V];
      load_f32<V>(gamma + k * V, g);
      load_f32<V>(beta + k * V, b);
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = fmaf((v[c][i] - mean) * rstd, g[i], b[i]);
      const size_t at = base + static_cast<size_t>(k) * V;
      if (out_bf16) {
        store_bf16<V>(static_cast<__nv_bfloat16*>(out) + at, o);
      } else {
        store_f32<V>(static_cast<float*>(out) + at, o);
      }
    }
  }
}

template <int V, int C>
cudaError_t launch(float* x, const void* y, const float* gamma, const float* beta, void* out,
                   int rows, int dim, int y_bf16, int out_bf16, float eps, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  residual_layer_norm_kernel<V, C><<<blocks, kThreads, 0, stream>>>(x, y, gamma, beta, out, rows,
                                                                     dim, y_bf16, out_bf16, eps);
  return cudaGetLastError();
}

// The fewest chunks a lane, as a power of two, that cover dim.
template <int V>
cudaError_t dispatch_chunks(float* x, const void* y, const float* gamma, const float* beta,
                            void* out, int rows, int dim, int y_bf16, int out_bf16, float eps,
                            cudaStream_t stream) {
  const int per_lane = (dim / V + 31) / 32;
  if (per_lane <= 1) return launch<V, 1>(x, y, gamma, beta, out, rows, dim, y_bf16, out_bf16, eps, stream);
  if (per_lane <= 2) return launch<V, 2>(x, y, gamma, beta, out, rows, dim, y_bf16, out_bf16, eps, stream);
  if (per_lane <= 4) return launch<V, 4>(x, y, gamma, beta, out, rows, dim, y_bf16, out_bf16, eps, stream);
  if constexpr (V <= 2) {
    if (per_lane <= 8) return launch<V, 8>(x, y, gamma, beta, out, rows, dim, y_bf16, out_bf16, eps, stream);
    if (per_lane <= 16) return launch<V, 16>(x, y, gamma, beta, out, rows, dim, y_bf16, out_bf16, eps, stream);
    if constexpr (V == 1) {
      return launch<V, 32>(x, y, gamma, beta, out, rows, dim, y_bf16, out_bf16, eps, stream);
    }
  } else {
    return launch<V, 8>(x, y, gamma, beta, out, rows, dim, y_bf16, out_bf16, eps, stream);
  }
  return cudaErrorInvalidValue;
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// x [rows, dim] fp32, read, and overwritten with x + y where y is given; y
// [rows, dim] bf16 (y_bf16 1) or fp32, or null; gamma, beta [dim] fp32; out
// [rows, dim] bf16 (out_bf16 1) or fp32, LN(x + y) with eps added to the
// variance (SepFormer's 1e-6, TF-GridNet's 1e-5). Every
// array contiguous, 1 <= dim <= 1024. Chunks of 4 elements where dim and
// every pointer allow 16-byte fp32 accesses, else 2, else 1. Returns
// cudaGetLastError() after the launch.
extern "C" int sst_residual_layer_norm(void* x, const void* y, const void* gamma, const void* beta,
                                       void* out, int rows, int dim, int y_bf16, int out_bf16,
                                       float eps, void* stream) {
  if (rows < 0 || dim < 1 || dim > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  float* xf = static_cast<float*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ybytes = y_bf16 ? 2 : 4;
  const int obytes = out_bf16 ? 2 : 4;
  auto fits = [&](int v) {
    return dim % v == 0 && aligned(x, 4 * v) && aligned(y, ybytes * v) && aligned(gamma, 4 * v) &&
           aligned(beta, 4 * v) && aligned(out, obytes * v);
  };
  cudaError_t err;
  if (fits(4)) {
    err = dispatch_chunks<4>(xf, y, g, b, out, rows, dim, y_bf16, out_bf16, eps, s);
  } else if (fits(2)) {
    err = dispatch_chunks<2>(xf, y, g, b, out, rows, dim, y_bf16, out_bf16, eps, s);
  } else {
    err = dispatch_chunks<1>(xf, y, g, b, out, rows, dim, y_bf16, out_bf16, eps, s);
  }
  return static_cast<int>(err);
}
