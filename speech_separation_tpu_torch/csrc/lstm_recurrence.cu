// LSTM recurrence over precomputed input projections, for Hopper, sm_90a.
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
// Both directions of a BiLSTM layer run in one call (grid z = direction).
// A direction whose bit is set in reverse_mask walks time backwards over the
// whole padded length, which is what the reference's flip, scan and flip back
// computes (models/blstm.py:111,139), without copying any tensor. Every
// tensor with a time axis is indexed by real time t; only the keep gate is
// indexed by the direction's own scan step, as in the reference.
//
// What bounds it on this card: the recurrence is sequential over T steps, and
// each step is a small product [B, H] x [H, 4H] per direction: at H = 496
// the recurrent matrix is 3.9 MB in fp32 per direction, far above a block's
// 227 KB of shared memory, so it is re-read from L2 every step. CUDA blocks
// carry nothing from one launch to the next (unlike the sequential TPU grid
// that keeps the carry in VMEM scratch), so the carry lives in device memory.
//
// What the design does about it:
// - one launch per time step, issued by a host loop in this file, so launch
//   order is the only synchronisation between steps;
// - h ping-pongs between two fp32 buffers (every block reads all of h_in);
//   c is updated in place, since each (direction, row, unit) is owned by one
//   thread;
// - a block owns 32 batch rows x 32 hidden units and all four gate columns
//   g * H + j of those units, so the gate math and the c/h update stay inside
//   the block with no exchange; U is streamed through shared memory 32 rows at
//   a time, and each thread keeps a 2 x 2 x 4 register tile of gate sums;
// - H = 496 needs no padding to a tile multiple: the ragged unit, row and
//   reduction tiles are masked;
// - the training mode and the keep gate are template flags, so the serving
//   instantiation carries no residual store and no branch per element.
// A persistent kernel with a grid barrier per step, or a thread-block cluster
// sharing U through distributed shared memory, and tensor-core products are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;     // batch rows per block
constexpr int kUnits = 32;    // hidden units per block (times 4 gate columns)
constexpr int kDepth = 32;    // reduction tile over H
constexpr int kThreads = 256;

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

// xw [D, B, T, 4H], u [D, H, 4H] in T; h_in, h_out, c [D, B, H] fp32;
// out [B, T, D * H] in T. Computes time step `step` of every direction.
// kTrain: also gates [D, B, T, 4H] in T (post-activation i, f, g, o) and
// c_all [D, B, T, H] fp32. kKeep: keep [D, B, T] fp32 in scan order gates
// the carry (h and c) before the step.
template <typename T, bool kTrain, bool kKeep>
__global__ void __launch_bounds__(kThreads)
lstm_step_kernel(const T* __restrict__ xw, const T* __restrict__ u,
                 const float* __restrict__ h_in, float* __restrict__ h_out,
                 float* __restrict__ c, T* __restrict__ out, T* __restrict__ gates_out,
                 float* __restrict__ c_all, const float* __restrict__ keep, int batch,
                 int steps, int hidden, int step, int reverse_mask) {
  __shared__ float sh[kRows][kDepth + 1];
  __shared__ float su[kDepth][4 * kUnits];

  const int d = blockIdx.z;
  const int dirs = gridDim.z;
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;
  const int t = ((reverse_mask >> d) & 1) ? steps - 1 - step : step;
  const int gates = 4 * hidden;
  const T* ud = u + static_cast<size_t>(d) * hidden * gates;
  const float* hd = h_in + static_cast<size_t>(d) * batch * hidden;

  const int tx = threadIdx.x % 16;  // units j0 + tx + 16 * q
  const int ty = threadIdx.x / 16;  // rows  b0 + ty + 16 * r
  float acc[2][2][4] = {};          // [row][unit][gate]

  for (int k0 = 0; k0 < hidden; k0 += kDepth) {
    for (int i = threadIdx.x; i < kRows * kDepth; i += kThreads) {
      const int rb = b0 + i / kDepth;
      const int k = k0 + i % kDepth;
      float v = (rb < batch && k < hidden) ? hd[static_cast<size_t>(rb) * hidden + k] : 0.f;
      if (kKeep && rb < batch) v *= keep[(static_cast<size_t>(d) * batch + rb) * steps + step];
      sh[i / kDepth][i % kDepth] = to_float(from_float<T>(v));
    }
    for (int i = threadIdx.x; i < kDepth * 4 * kUnits; i += kThreads) {
      const int kk = i / (4 * kUnits);
      const int col = i % (4 * kUnits);
      const int k = k0 + kk;
      const int j = j0 + col % kUnits;
      su[kk][col] = (k < hidden && j < hidden)
                        ? to_float(ud[static_cast<size_t>(k) * gates + (col / kUnits) * hidden + j])
                        : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kDepth; ++kk) {
      const float a0 = sh[ty][kk];
      const float a1 = sh[ty + 16][kk];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float w = su[kk][g * kUnits + tx + 16 * q];
          acc[0][q][g] = fmaf(a0, w, acc[0][q][g]);
          acc[1][q][g] = fmaf(a1, w, acc[1][q][g]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rb = b0 + ty + 16 * r;
    if (rb >= batch) continue;
    const size_t row = (static_cast<size_t>(d) * batch + rb) * steps + t;  // [D, B, T]
    const T* x = xw + row * gates;
    const float kr = kKeep ? keep[(static_cast<size_t>(d) * batch + rb) * steps + step] : 1.f;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = j0 + tx + 16 * q;
      if (j >= hidden) continue;
      const float ig = sigmoid(to_float(x[j]) + acc[r][q][0]);
      const float fg = sigmoid(to_float(x[hidden + j]) + acc[r][q][1]);
      const float gg = tanhf(to_float(x[2 * hidden + j]) + acc[r][q][2]);
      const float og = sigmoid(to_float(x[3 * hidden + j]) + acc[r][q][3]);
      const size_t s = (static_cast<size_t>(d) * batch + rb) * hidden + j;
      const float cp = kKeep ? c[s] * kr : c[s];
      const float cn = fg * cp + ig * gg;
      const float hn = og * tanhf(cn);
      c[s] = cn;
      h_out[s] = hn;
      out[(static_cast<size_t>(rb) * steps + t) * dirs * hidden + d * hidden + j] =
          from_float<T>(hn);
      if (kTrain) {
        T* g4 = gates_out + row * gates;
        g4[j] = from_float<T>(ig);
        g4[hidden + j] = from_float<T>(fg);
        g4[2 * hidden + j] = from_float<T>(gg);
        g4[3 * hidden + j] = from_float<T>(og);
        c_all[row * hidden + j] = cn;
      }
    }
  }
}

template <typename T, bool kTrain, bool kKeep>
int run_steps(const void* xw, const void* u, void* h_a, void* h_b, void* c, void* out,
              void* gates, void* c_all, const void* keep, int dirs, int batch, int steps,
              int hidden, int reverse_mask, cudaStream_t stream) {
  const dim3 grid((hidden + kUnits - 1) / kUnits, (batch + kRows - 1) / kRows, dirs);
  for (int s = 0; s < steps; ++s) {
    float* h_in = static_cast<float*>(s % 2 ? h_b : h_a);
    float* h_out = static_cast<float*>(s % 2 ? h_a : h_b);
    lstm_step_kernel<T, kTrain, kKeep><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(xw), static_cast<const T*>(u), h_in, h_out,
        static_cast<float*>(c), static_cast<T*>(out), static_cast<T*>(gates),
        static_cast<float*>(c_all), static_cast<const float*>(keep), batch, steps, hidden, s,
        reverse_mask);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

template <typename T>
int run_train(const void* xw, const void* u, void* h_a, void* h_b, void* c, void* out,
              void* gates, void* c_all, const void* keep, int dirs, int batch, int steps,
              int hidden, int reverse_mask, cudaStream_t stream) {
  if (keep)
    return run_steps<T, true, true>(xw, u, h_a, h_b, c, out, gates, c_all, keep, dirs, batch,
                                    steps, hidden, reverse_mask, stream);
  return run_steps<T, true, false>(xw, u, h_a, h_b, c, out, gates, c_all, nullptr, dirs, batch,
                                   steps, hidden, reverse_mask, stream);
}

}  // namespace

// Runs all `steps` time steps. h_a must hold the initial h (zeros) and c the
// initial cell state (zeros); h_b is scratch of the same shape [D, B, H].
// bf16 != 0 selects __nv_bfloat16 xw, u and out; otherwise fp32.
// Returns the first non-zero cudaGetLastError() of the launches, or 0.
extern "C" int sst_lstm_recurrence(const void* xw, const void* u, void* h_a, void* h_b, void* c,
                                   void* out, int dirs, int batch, int steps, int hidden,
                                   int reverse_mask, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_steps<__nv_bfloat16, false, false>(xw, u, h_a, h_b, c, out, nullptr, nullptr,
                                                  nullptr, dirs, batch, steps, hidden,
                                                  reverse_mask, s);
  return run_steps<float, false, false>(xw, u, h_a, h_b, c, out, nullptr, nullptr, nullptr, dirs,
                                        batch, steps, hidden, reverse_mask, s);
}

// The training forward: sst_lstm_recurrence plus the residuals gates
// [D, B, T, 4H] (compute type) and c_all [D, B, T, H] (fp32), and an optional
// keep gate [D, B, T] fp32 in each direction's scan order (null for none).
extern "C" int sst_lstm_train_forward(const void* xw, const void* u, void* h_a, void* h_b,
                                      void* c, void* out, void* gates, void* c_all,
                                      const void* keep, int dirs, int batch, int steps,
                                      int hidden, int reverse_mask, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_train<__nv_bfloat16>(xw, u, h_a, h_b, c, out, gates, c_all, keep, dirs, batch,
                                    steps, hidden, reverse_mask, s);
  return run_train<float>(xw, u, h_a, h_b, c, out, gates, c_all, keep, dirs, batch, steps,
                          hidden, reverse_mask, s);
}
