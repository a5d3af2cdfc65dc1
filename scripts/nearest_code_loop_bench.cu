// The product loop of csrc/nearest_code.cu alone, at several register tiles,
// on one NVIDIA GPU: how many FMAs a clock an SM each tiling's loop of
// shared-memory loads and FMAs sustains, with nothing else in the kernel.
//
// From the root of the repo (the binary goes to the git-ignored build folder):
//
//   mkdir -p speech_separation_tpu_torch/.kernel_build && \
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o speech_separation_tpu_torch/.kernel_build/loop_bench \
//       scripts/nearest_code_loop_bench.cu && speech_separation_tpu_torch/.kernel_build/loop_bench
//
// One CTA of 256 threads an SM on every SM; x [rows][68] and e [64][512] in
// shared memory as the kernel lays them out (R rows and C codes a thread, LR
// lanes of a warp along rows); 200 passes over 64 dims. Prints one line per
// tiling: milliseconds and FMAs a clock an SM at the card's largest SM clock.
#include <cstdio>

#include <cuda_runtime.h>

template <int R, int C, int LR>
__global__ void __launch_bounds__(256, 1) product(float* out, int reps) {
  constexpr int LC = 32 / LR, WC = 512 / (C * LC);
  constexpr int TR = R * LR * (8 / WC);
  constexpr int kStride = 68;
  extern __shared__ __align__(16) float sm[];
  float* es = sm;             // [64][512]
  float* xs = sm + 64 * 512;  // [TR][kStride]
  for (int i = threadIdx.x; i < 64 * 512 + TR * kStride; i += 256) sm[i] = (i % 97) * 1e-3f;
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rl = lane / LC, cl = lane % LC, rw = warp / WC, cw = warp % WC;
  const float* x = xs + (rw * R * LR + rl) * kStride;
  const float* e = es + cw * C * LC + cl * 4;
  float acc[R][C] = {};
  for (int rep = 0; rep < reps; ++rep) {
    for (int d = 0; d < 64; d += 4) {
      float4 xv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) xv[i] = *reinterpret_cast<const float4*>(x + LR * i * kStride + d);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float ev[C];
#pragma unroll
        for (int v = 0; v < C; v += 4) {
          const float4 e4 = *reinterpret_cast<const float4*>(e + (d + q) * 512 + (v / 4) * 4 * LC);
          ev[v] = e4.x, ev[v + 1] = e4.y, ev[v + 2] = e4.z, ev[v + 3] = e4.w;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float xq = q == 0 ? xv[i].x : q == 1 ? xv[i].y : q == 2 ? xv[i].z : xv[i].w;
#pragma unroll
          for (int v = 0; v < C; ++v) acc[i][v] = fmaf(xq, ev[v], acc[i][v]);
        }
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int v = 0; v < C; ++v) s += acc[i][v];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

// the same loop with its loads issued one step ahead: the next 4 dims' x
// and the next dim's e before the FMAs of the current dim
template <int R, int C, int LR>
__global__ void __launch_bounds__(256, 1) product_ahead(float* out, int reps) {
  constexpr int LC = 32 / LR, WC = 512 / (C * LC);
  constexpr int TR = R * LR * (8 / WC);
  constexpr int kStride = 68;
  extern __shared__ __align__(16) float sm[];
  float* es = sm;
  float* xs = sm + 64 * 512;
  for (int i = threadIdx.x; i < 64 * 512 + TR * kStride; i += 256) sm[i] = (i % 97) * 1e-3f;
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rl = lane / LC, cl = lane % LC, rw = warp / WC, cw = warp % WC;
  const float* x = xs + (rw * R * LR + rl) * kStride;
  const float* e = es + cw * C * LC + cl * 4;
  float acc[R][C] = {};
  for (int rep = 0; rep < reps; ++rep) {
    float4 xv[R], xn[R];
    float4 ec[C / 4], en[C / 4];
#pragma unroll
    for (int i = 0; i < R; ++i) xv[i] = *reinterpret_cast<const float4*>(x + LR * i * kStride);
#pragma unroll
    for (int v = 0; v < C; v += 4) ec[v / 4] = *reinterpret_cast<const float4*>(e + (v / 4) * 4 * LC);
    for (int d = 0; d < 64; d += 4) {
      const int dn = d + 4 < 64 ? d + 4 : d;
#pragma unroll
      for (int i = 0; i < R; ++i) xn[i] = *reinterpret_cast<const float4*>(x + LR * i * kStride + dn);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = q < 3 ? d + q + 1 : dn;
#pragma unroll
        for (int v = 0; v < C; v += 4)
          en[v / 4] = *reinterpret_cast<const float4*>(e + row * 512 + (v / 4) * 4 * LC);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float xq = q == 0 ? xv[i].x : q == 1 ? xv[i].y : q == 2 ? xv[i].z : xv[i].w;
#pragma unroll
          for (int v = 0; v < C; ++v) {
            const float4 e4 = ec[v / 4];
            const float ev = v % 4 == 0 ? e4.x : v % 4 == 1 ? e4.y : v % 4 == 2 ? e4.z : e4.w;
            acc[i][v] = fmaf(xq, ev, acc[i][v]);
          }
        }
#pragma unroll
        for (int v = 0; v < C / 4; ++v) ec[v] = en[v];
      }
#pragma unroll
      for (int i = 0; i < R; ++i) xv[i] = xn[i];
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int v = 0; v < C; ++v) s += acc[i][v];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

template <int R, int C, int LR, bool kAhead = false>
void bench(float* out, int sms, double clock_hz) {
  constexpr int LC = 32 / LR, WC = 512 / (C * LC);
  constexpr int TR = R * LR * (8 / WC);
  const int smem = (64 * 512 + TR * 68) * 4;
  auto kernel = kAhead ? product_ahead<R, C, LR> : product<R, C, LR>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int reps = 200;
  kernel<<<sms, 256, smem>>>(out, reps);
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  cudaEventRecord(start);
  for (int r = 0; r < 5; ++r) kernel<<<sms, 256, smem>>>(out, reps);
  cudaEventRecord(end);
  cudaEventSynchronize(end);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, start, end);
  ms /= 5;
  const double fmas = double(sms) * 256 * reps * 64.0 * R * C;
  printf("%2d rows x %2d codes, %d row lanes%s: %.3f ms, %.1f FMAs a clock an SM (%s)\n", R, C,
         LR, kAhead ? ", loads a step ahead" : "", ms, fmas / (ms * 1e-3) / clock_hz / sms,
         cudaGetErrorString(cudaGetLastError()));
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  int clock_khz = 0;
  cudaDeviceGetAttribute(&clock_khz, cudaDevAttrClockRate, 0);
  printf("%s, %d SMs, SM clock %d MHz\n", prop.name, prop.multiProcessorCount, clock_khz / 1000);
  float* out = nullptr;
  cudaMalloc(&out, prop.multiProcessorCount * 256 * sizeof(float));
  const double hz = clock_khz * 1e3;
  bench<4, 8, 4>(out, prop.multiProcessorCount, hz);
  bench<8, 4, 1>(out, prop.multiProcessorCount, hz);
  bench<8, 8, 4>(out, prop.multiProcessorCount, hz);
  bench<8, 8, 1>(out, prop.multiProcessorCount, hz);
  bench<8, 16, 4>(out, prop.multiProcessorCount, hz);
  bench<2, 16, 1>(out, prop.multiProcessorCount, hz);
  bench<4, 8, 4, true>(out, prop.multiProcessorCount, hz);
  bench<8, 8, 4, true>(out, prop.multiProcessorCount, hz);
  bench<8, 16, 4, true>(out, prop.multiProcessorCount, hz);
  cudaFree(out);
  return 0;
}
