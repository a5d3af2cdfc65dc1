// Backward through time of a (Bi)LSTM layer, for Hopper, sm_90a.
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
// What bounds it on this card: the recurrence is sequential over T steps, and
// each step is a product [B, 4H] x [4H, H] per direction (4H = 1984 at
// H = 496), with U re-read from L2 every step, as in the forward.
//
// What the design does about it:
// - one launch per step from a host loop in this file; the dgates tensor of
//   the step before, which every block finished in the previous launch, is
//   itself the dh carry, so nothing else is exchanged between blocks;
// - a block owns 32 batch rows x 32 hidden units: it computes its slice of
//   dgates_{s+1} @ U^T (a reduction over 4H, streamed through shared memory
//   32 columns at a time, masked where ragged) and then the gate backward of
//   those units, whose four gate columns it writes;
// - dc is updated in place, since each (direction, row, unit) is owned by one
//   thread; the keep gate is a template flag.
// Tensor-core products and a persistent kernel are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;     // batch rows per block
constexpr int kUnits = 32;    // hidden units per block
constexpr int kDepth = 32;    // reduction tile over 4H
constexpr int kThreads = 256;

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

// gates [D, B, T, 4H], dgates [D, B, T, 4H], u [D, H, 4H], dy [B, T, D * H]
// in T; c_all [D, B, T, H], dc [D, B, H], keep [D, B, T] fp32. Computes scan
// step `step` of every direction.
template <typename T, bool kKeep>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_step_kernel(const T* __restrict__ gates, const float* __restrict__ c_all,
                     const T* __restrict__ dy, const T* __restrict__ u, float* __restrict__ dc,
                     const float* __restrict__ keep, T* __restrict__ dgates, int batch,
                     int steps, int hidden, int step, int reverse_mask) {
  __shared__ float sg[kRows][kDepth + 1];
  __shared__ float su[kDepth][kUnits + 1];

  const int d = blockIdx.z;
  const int dirs = gridDim.z;
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;
  const bool rev = (reverse_mask >> d) & 1;
  const int t = rev ? steps - 1 - step : step;
  const int g4h = 4 * hidden;
  const T* ud = u + static_cast<size_t>(d) * hidden * g4h;

  const int tx = threadIdx.x % 16;  // units j0 + tx + 16 * q
  const int ty = threadIdx.x / 16;  // rows  b0 + ty + 16 * r
  float acc[2][2] = {};             // [row][unit] of dgates_{s+1} @ U^T

  if (step + 1 < steps) {  // the same for every block of a launch
    const int t_next = rev ? t - 1 : t + 1;
    for (int k0 = 0; k0 < g4h; k0 += kDepth) {
      for (int i = threadIdx.x; i < kRows * kDepth; i += kThreads) {
        const int rb = b0 + i / kDepth;
        const int k = k0 + i % kDepth;
        sg[i / kDepth][i % kDepth] =
            (rb < batch && k < g4h)
                ? to_float(dgates[((static_cast<size_t>(d) * batch + rb) * steps + t_next) * g4h + k])
                : 0.f;
      }
      for (int i = threadIdx.x; i < kDepth * kUnits; i += kThreads) {
        const int jj = i / kDepth;
        const int kk = i % kDepth;
        const int j = j0 + jj;
        const int k = k0 + kk;
        su[kk][jj] = (j < hidden && k < g4h) ? to_float(ud[static_cast<size_t>(j) * g4h + k]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kDepth; ++kk) {
        const float a0 = sg[ty][kk];
        const float a1 = sg[ty + 16][kk];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float w = su[kk][tx + 16 * q];
          acc[0][q] = fmaf(a0, w, acc[0][q]);
          acc[1][q] = fmaf(a1, w, acc[1][q]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rb = b0 + ty + 16 * r;
    if (rb >= batch) continue;
    const size_t base = (static_cast<size_t>(d) * batch + rb) * steps;  // row (d, rb) of [D, B, T]
    const size_t row = base + t;
    const float k_step = kKeep ? keep[base + step] : 1.f;
    const float k_next = (kKeep && step + 1 < steps) ? keep[base + step + 1] : 1.f;
    const T* g4 = gates + row * g4h;
    T* dg4 = dgates + row * g4h;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = j0 + tx + 16 * q;
      if (j >= hidden) continue;
      const float ig = to_float(g4[j]);
      const float fg = to_float(g4[hidden + j]);
      const float gg = to_float(g4[2 * hidden + j]);
      const float og = to_float(g4[3 * hidden + j]);
      const float th = tanhf(c_all[row * hidden + j]);
      float cp = 0.f;
      if (step >= 1) cp = c_all[(base + (rev ? t + 1 : t - 1)) * hidden + j] * k_step;
      const float dh = to_float(dy[(static_cast<size_t>(rb) * steps + t) * dirs * hidden +
                                   d * hidden + j]) +
                       acc[r][q] * k_next;
      const size_t s = (static_cast<size_t>(d) * batch + rb) * hidden + j;
      const float d_o = dh * th * og * (1.f - og);
      const float dcv = dc[s] + dh * og * (1.f - th * th);
      const float d_i = dcv * gg * ig * (1.f - ig);
      const float d_f = dcv * cp * fg * (1.f - fg);
      const float d_g = dcv * ig * (1.f - gg * gg);
      dg4[j] = from_float<T>(d_i);
      dg4[hidden + j] = from_float<T>(d_f);
      dg4[2 * hidden + j] = from_float<T>(d_g);
      dg4[3 * hidden + j] = from_float<T>(d_o);
      dc[s] = dcv * fg * k_step;
    }
  }
}

template <typename T, bool kKeep>
int run_steps(const void* gates, const void* c_all, const void* dy, const void* u, void* dc,
              const void* keep, void* dgates, int dirs, int batch, int steps, int hidden,
              int reverse_mask, cudaStream_t stream) {
  const dim3 grid((hidden + kUnits - 1) / kUnits, (batch + kRows - 1) / kRows, dirs);
  for (int step = steps - 1; step >= 0; --step) {
    lstm_bwd_step_kernel<T, kKeep><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(gates), static_cast<const float*>(c_all),
        static_cast<const T*>(dy), static_cast<const T*>(u), static_cast<float*>(dc),
        static_cast<const float*>(keep), static_cast<T*>(dgates), batch, steps, hidden, step,
        reverse_mask);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

template <typename T>
int run(const void* gates, const void* c_all, const void* dy, const void* u, void* dc,
        const void* keep, void* dgates, int dirs, int batch, int steps, int hidden,
        int reverse_mask, cudaStream_t stream) {
  if (keep)
    return run_steps<T, true>(gates, c_all, dy, u, dc, keep, dgates, dirs, batch, steps, hidden,
                              reverse_mask, stream);
  return run_steps<T, false>(gates, c_all, dy, u, dc, nullptr, dgates, dirs, batch, steps,
                             hidden, reverse_mask, stream);
}

}  // namespace

// Runs all `steps` steps, last scan step first. dc [D, B, H] fp32 must hold
// zeros; keep may be null. bf16 != 0 selects __nv_bfloat16 gates, dy, u and
// dgates; otherwise fp32. Returns the first non-zero cudaGetLastError() of
// the launches, or 0.
extern "C" int sst_lstm_train_backward(const void* gates, const void* c_all, const void* dy,
                                       const void* u, void* dc, const void* keep, void* dgates,
                                       int dirs, int batch, int steps, int hidden,
                                       int reverse_mask, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run<__nv_bfloat16>(gates, c_all, dy, u, dc, keep, dgates, dirs, batch, steps, hidden,
                              reverse_mask, s);
  return run<float>(gates, c_all, dy, u, dc, keep, dgates, dirs, batch, steps, hidden,
                    reverse_mask, s);
}
