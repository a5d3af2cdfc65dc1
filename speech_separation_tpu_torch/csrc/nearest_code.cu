// Nearest-codebook search for Hopper, sm_90a: one persistent launch a call,
// every group of a residual-VQ stage in it.
//
// Replaces the Pallas TPU kernel speech_separation_tpu/ops/vq_pallas.py
// (nearest_code_pallas -> _nearest_code_impl, body _nearest_kernel): for each
// row x_n and each group g, the index of the column e_gk of codebook [G, S, K]
// with the least score ||e_gk||^2 - 2 x_ng . e_gk (the squared distance less
// ||x_ng||^2, the same for every k), where x_ng is columns g*S .. g*S + S - 1
// of row n of flat [N, >= G*S] (any row stride, columns contiguous). One call
// with G = 1 is the plain [N, D] x [D, K] search. No [N, K] score matrix ever
// reaches device memory.
//
// Arithmetic, unchanged from the first port of this kernel, so every pick is
// its pick bit for bit and reruns are bit-identical: plain fp32 FMA, the
// reference's Precision.HIGHEST (no TF32, no tensor cores); each dot product
// and each ||e||^2 sums d = 0..S-1 in order with fmaf from 0; the score is
// fmaf(-2, dot, ||e||^2). Exact ties go to the lowest index (a thread visits
// its codes in ascending order with a strict <, and every merge compares
// (score, index) lexicographically); a row whose scores are all NaN gets 0.
//
// What bounds it on this card: 2*N*G*S*K fp32 operations against
// 4*(N*G*S + G*S*K + N*G) compulsory bytes. At the codec's shapes (the deep
// search N = 12,800, S = 64, K = 512; a skip stage N = 51,200, G = 4 groups of
// S = 16, K = 512) that is ~100 operations a byte, five times the fp32 ridge
// of 67e12 / 3.35e12 = 20, so operations bound it: 12.5 us deep, 50 us a skip
// stage. The design (figures from scripts/torch_probe_vq.py and
// scripts/nearest_code_loop_bench.cu, NVIDIA H100 80GB HBM3, 700 W):
//
// 1. Persistent and balanced. search_plan (ops/vq_cuda.py) launches
//    min(units, SMs x CTAs an SM) CTAs, one an SM at these shapes (255
//    registers a thread). A work unit is 16 rows: resident (below), of every
//    group at once, so a skip stage is 3,200 units and not 4 launches;
//    streamed, of one group, group-major. CTA c owns the contiguous units
//    [c q + min(c, r), ...), q or q + 1 of them (q, r = divmod(units, CTAs)),
//    so no CTA holds more than one unit above another: the deep search deals
//    800 units as 6 or 7 (the busiest SM 7 / 6.06 of the mean; the first
//    port's 200 blocks of 64 rows left 68 SMs two and 64 one), a skip stage
//    3,200 as 24 or 25. A CTA walks its units two at a time (a 32-row step
//    at 8 rows a thread); a lone unit at the end of its range runs as a
//    16-row step at 4 rows a thread, so the 16-row balance costs no 32-row
//    tile.
// 2. Codebooks resident. A CTA loads every group's [S][K] codebook into
//    shared memory once a call (16-byte cp.async where K % 4 == 0, else
//    4-byte; codes past K zero-filled to a multiple of 512): 128 KB deep, 4 x
//    32 KB a skip stage. ||e||^2 is then summed once per code, every thread
//    taking its own codes, each in order. Where G x S x Kpad x 4 bytes and the
//    row stages exceed the block's shared memory (up to S = 256, K = 4,096),
//    the codebook of a unit's group streams instead through a double-buffered
//    cp.async ring of [32 dims][512 codes] blocks: each dot product still
//    sums d in order, carried in registers from block to block, and ||e||^2
//    likewise; search_plan chooses, the tests reach both.
// 3. Rows double-buffered. The next step's rows are staged by cp.async
//    (16-byte where the rows allow it) while the current step computes,
//    row-major, each group's S columns in a segment rounded to 4 floats and
//    the row to an odd multiple of 4, so the four row groups a warp reads hit
//    four distinct 16-byte bank groups. Which copies a thread issues is
//    worked out once a launch (no division a copy). Rows past N are
//    zero-filled and never stored.
// 4. Register tile. 8 warps of 32 lanes; lane (r = lane / 8, c = lane % 8)
//    of warp w computes rows r + 4i (i < 8) against codes w*64 + c*4 + j and
//    w*64 + 32 + c*4 + j (j < 4) of each 512-code chunk: 8 x 8 = 64
//    accumulators. Per 4 dims, eight 16-byte loads of x and eight of e feed
//    256 FMAs: 16 of 272 instructions in the inner loop are loads. Shared
//    memory serves a 16-byte warp load in four wavefronts however many lanes
//    share an address, so the loop asks one wavefront per 4 FMAs, the rate
//    the FMA pipe takes them. The loop alone sustains 88 FMAs a clock an SM
//    (69% of 128; scripts/nearest_code_loop_bench.cu), against 73 for 4 rows
//    x 8 codes and 91 for 8 x 16 (whose 64-row steps would cost item 1's
//    balance); loads issued a step ahead gain nothing (88.7).
// 5. Merge. A thread's running (score, index) per row carries over the
//    chunks. At a step's end the 8 lanes along a row group's codes merge as a
//    reduce-scatter (at each lane bit a lane keeps half its rows and takes its
//    partner's candidates for them: 3 shuffle rounds of 4, 2 and 1 rows, not
//    3 of 8), so each lane ends with one row; the 8 warps merge through shared
//    memory; one thread a (row, group) writes its index, all in lexicographic
//    (score, index) order. No atomics, no [N, K] matrix.
//
// Measured (scripts/torch_probe_vq.py, NVIDIA H100 80GB HBM3, 700 W): the
// deep search 35.0 us (the first port in the same run: 53.0), one skip group
// 45.0 us (53.8), a skip stage 142.6 us in one launch (the first port's
// four: 206.1). The deep search's time is 7.3 us and 3.8 us a unit a CTA
// (at 1 to 28 units); its 16 rows' products alone would take 3.0 us at the
// loop's 88 FMAs a clock. What bounds it is the FMA loop's rate and, at
// S = 16, a step's work around the products: a copy without them takes 12.5
// us deep and 62.4 us a skip stage (the compare alone 16 us there, 4
// instructions a score against 16 FMAs).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

// Probe switch: the copies of scripts/torch_probe_vq.py set SST_VQ_SKIP by -D
// to leave work out, their picks wrong by design: 1 the rows' staging, 2 the
// codebook's staging, 4 the compare (each score summed instead, so the
// products stay live), 16 the products (the scores are then the codes'
// ||e||^2). The port builds 0.
#ifndef SST_VQ_SKIP
#define SST_VQ_SKIP 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                            // rows a thread in a full step
constexpr int kCodes = 8;                           // codes a thread, in vectors of 4
constexpr int kRowLanes = 4;                        // lanes along rows
constexpr int kCodeLanes = 32 / kRowLanes;          // lanes along codes
constexpr int kChunkCodes = 512;                    // codes a chunk
constexpr int kWarpCodes = kCodes * kCodeLanes;     // codes a warp in a chunk
constexpr int kCodeWarps = kChunkCodes / kWarpCodes;
constexpr int kRowWarps = kWarps / kCodeWarps;
constexpr int kStepRows = kRows * kRowLanes * kRowWarps;  // rows a full step: two units
constexpr int kUnitRows = kStepRows / 2;            // rows a work unit
constexpr int kStreamDims = 32;                     // dims a streamed codebook block
constexpr int kMaxDim = 256;
constexpr int kNorms = kChunkCodes / kThreads;  // streamed ||e||^2 a thread carries
static_assert(kRowWarps * kCodeWarps == kWarps, "the warps must tile a step");

// a group's S columns in a staged row: S rounded to 4 (16-byte aligned)
__host__ __device__ constexpr int segment(int s) { return (s + 3) / 4 * 4; }
// a staged row of gs groups: their segments, then to an odd multiple of 4
// floats, so the row groups a warp reads hit distinct 16-byte bank groups
__host__ __device__ constexpr int row_stride(int s, int gs) {
  return gs * segment(s) / 4 % 2 == 0 ? gs * segment(s) + 4 : gs * segment(s);
}
__host__ __device__ constexpr int pad_codes(int k) {
  return (k + kChunkCodes - 1) / kChunkCodes * kChunkCodes;
}

// dynamic shared memory: the codebooks (resident: every group's [S][Kpad])
// or the ring (two [32][512] blocks), two row stages [kStepRows][row
// stride], ||e||^2 of the resident codes or of one chunk, the merge's
// (score, index) of the step's groups x kCodeWarps x kStepRows
__host__ __device__ constexpr size_t smem_bytes(int s, int k, int groups, bool resident) {
  return 4 * (resident ? static_cast<size_t>(groups) * s * pad_codes(k)
                       : 2 * kStreamDims * kChunkCodes) +
         4 * 2 * kStepRows * row_stride(s, resident ? groups : 1) +
         4 * (resident ? static_cast<size_t>(groups) * pad_codes(k) : kChunkCodes) +
         8 * (resident ? groups : 1) * kCodeWarps * kStepRows;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 or 4 bytes, zero-filled where !valid (then nothing is read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Args {
  const float* flat;
  const float* codebook;
  int* out;
  long long ld;  // flat's row stride, in floats
  int rows, groups, dim, codes, tiles, units;
  int step_groups;  // groups a step covers: all of them (resident) or one (streamed)
  bool rows16, codes16, resident;
};

// Which copies of a step's rows a thread issues: the copy `src` floats into
// a row (and `dst` into its staged row) of rows row, row + row_step, ...
// Computed once a launch, so the copies need no division. A staged row has
// at most kThreads copies (the entry refuses more).
struct RowCopies {
  int row, row_step, src, dst;
};

__device__ RowCopies row_copies(const Args& a) {
  const int vec = a.rows16 ? 4 : 1;  // floats a copy
  const int per_group = a.dim / vec, per_row = a.step_groups * per_group;
  RowCopies m;
  const int v = threadIdx.x % per_row, j = v / per_group, c = vec * (v % per_group);
  m.row_step = kThreads / per_row;
  m.row = threadIdx.x < m.row_step * per_row ? static_cast<int>(threadIdx.x) / per_row : INT_MAX;
  m.src = j * a.dim + c;
  m.dst = j * segment(a.dim) + c;
  return m;
}

__device__ __forceinline__ void copy_row_part(const Args& a, float* dst, const float* src,
                                              bool valid) {
  if (a.rows16) {
    cp_async16(dst, valid ? src : a.flat, valid);
  } else {
    cp_async4(dst, valid ? src : a.flat, valid);
  }
}

// rows n0 .. n0 + count - 1 of the step's groups g0 .. into xs [count][row
// stride], group j's columns at segment j; rows past N zero-filled
__device__ void stage_rows(const Args& a, const RowCopies& m, float* xs, int g0, int n0,
                           int count) {
  if (SST_VQ_SKIP & 1) return;
  const int stride = row_stride(a.dim, a.step_groups);
  const float* base = a.flat + static_cast<size_t>(g0) * a.dim;
  for (int r = m.row; r < count; r += m.row_step) {
    copy_row_part(a, xs + r * stride + m.dst, base + static_cast<size_t>(n0 + r) * a.ld + m.src,
                  n0 + r < a.rows);
  }
}

// codebook[g][d0 .. d0 + nd)[k0 .. k0 + width) into es [nd][stride], codes
// past K zero-filled
__device__ void stage_codes(const Args& a, float* es, int stride, int g, int d0, int nd, int k0,
                            int width) {
  if (SST_VQ_SKIP & 2) return;
  const float* base = a.codebook + (static_cast<size_t>(g) * a.dim + d0) * a.codes;
  if (a.codes16) {
    const int per_row = width / 4;
    for (int i = threadIdx.x; i < nd * per_row; i += kThreads) {
      const int d = i / per_row, c = 4 * (i - d * per_row);
      const bool valid = k0 + c < a.codes;  // K % 4 == 0: a vector is all in or all out
      cp_async16(es + d * stride + c,
                 valid ? base + static_cast<size_t>(d) * a.codes + k0 + c : a.codebook, valid);
    }
  } else {
    for (int i = threadIdx.x; i < nd * width; i += kThreads) {
      const int d = i / width, c = i - d * width;
      const bool valid = k0 + c < a.codes;
      cp_async4(es + d * stride + c,
                valid ? base + static_cast<size_t>(d) * a.codes + k0 + c : a.codebook, valid);
    }
  }
}

// the thread's code v (v < kCodes) within its warp's codes: vectors of 4,
// the lanes along codes side by side, so codes ascend with v
__device__ __forceinline__ int code_of(int v) { return (v / 4) * 4 * kCodeLanes + v % 4; }

// acc[i][v] += x[row i][d0 + dd] * e[dd][code v] for dd < nd, in order; x at
// the thread's first row (its R rows kRowLanes apart, row-major with stride
// stride, d0 a multiple of 4), e [nd][estride] at the thread's first code
template <int R>
__device__ __forceinline__ void accumulate(float (&acc)[R][kCodes], const float* x, int stride,
                                           const float* e, int estride, int d0, int nd) {
  if (SST_VQ_SKIP & 16) return;
  const int main = nd & ~3;
  for (int dd = 0; dd < main; dd += 4) {
    float4 xv[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      xv[i] = *reinterpret_cast<const float4*>(x + kRowLanes * i * stride + d0 + dd);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* er = e + (dd + q) * estride;
      float ev[kCodes];
#pragma unroll
      for (int v = 0; v < kCodes; v += 4) {
        const float4 e4 = *reinterpret_cast<const float4*>(er + code_of(v));
        ev[v] = e4.x, ev[v + 1] = e4.y, ev[v + 2] = e4.z, ev[v + 3] = e4.w;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float xq = q == 0 ? xv[i].x : q == 1 ? xv[i].y : q == 2 ? xv[i].z : xv[i].w;
#pragma unroll
        for (int v = 0; v < kCodes; ++v) acc[i][v] = fmaf(xq, ev[v], acc[i][v]);
      }
    }
  }
  for (int dd = main; dd < nd; ++dd) {
    const float* er = e + dd * estride;
    float ev[kCodes];
#pragma unroll
    for (int v = 0; v < kCodes; v += 4) {
      const float4 e4 = *reinterpret_cast<const float4*>(er + code_of(v));
      ev[v] = e4.x, ev[v + 1] = e4.y, ev[v + 2] = e4.z, ev[v + 3] = e4.w;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float xq = x[kRowLanes * i * stride + d0 + dd];
#pragma unroll
      for (int v = 0; v < kCodes; ++v) acc[i][v] = fmaf(xq, ev[v], acc[i][v]);
    }
  }
}

// the chunk's scores into the running (score, index): codes in ascending order
template <int R>
__device__ __forceinline__ void compare(const float (&acc)[R][kCodes], const float* esq, int k0,
                                        int first, int codes, float (&best)[R], int (&idx)[R]) {
#pragma unroll
  for (int v = 0; v < kCodes; ++v) {
    const int c = first + code_of(v);
    if (k0 + c < codes) {
      const float sq = esq[c];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float score = fmaf(-2.f, acc[i][v], sq);
        if (SST_VQ_SKIP & 4) {
          best[i] += score;
        } else if (score < best[i]) {
          best[i] = score;
          idx[i] = k0 + c;
        }
      }
    }
  }
}

__device__ __forceinline__ void take(float& best, int& idx, float other, int other_idx) {
  if (other < best || (other == best && other_idx < idx)) {
    best = other;
    idx = other_idx;
  }
}

struct Smem {
  float* es;      // resident [S][Kpad], or the ring's two [32][512] blocks
  float* esq;     // [Kpad] resident, [512] streamed
  float* mscore;  // [kCodeWarps][kStepRows]
  int* midx;
};

// One step: the R * kRowLanes * kRowWarps rows n0 .. staged in xs (row
// stride `stride`, group j's columns at segment j) against every code of
// groups g0 .. g0 + step_groups - 1, one group after another; writes their
// indices.
// ||e||^2 of every code of groups g_begin .. g_end - 1 of the resident
// codebooks, each summed over d in order
__device__ void code_norms(const Args& a, const Smem& sm, int kpad, int g_begin, int g_end) {
  for (int i = g_begin * kpad + threadIdx.x; i < g_end * kpad; i += kThreads) {
    const int g = i / kpad, k = i - g * kpad;
    const float* e = sm.es + static_cast<size_t>(g) * a.dim * kpad + k;
    float s = 0.f;
    for (int d = 0; d < a.dim; ++d) s = fmaf(e[d * kpad], e[d * kpad], s);
    sm.esq[i] = s;
  }
}

template <int R>
__device__ void search_step(const Args& a, const Smem& sm, const float* xs, int stride, int kpad,
                            int g0, int n0) {
  constexpr int rows = R * kRowLanes * kRowWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_lane = lane / kCodeLanes, code_lane = lane % kCodeLanes;
  const int row_warp = warp / kCodeWarps, code_warp = warp % kCodeWarps;
  const int row0 = row_warp * R * kRowLanes + row_lane;  // the thread's rows: + kRowLanes i
  const int lead = code_warp * kWarpCodes + code_lane * 4;  // its first code in a chunk
  const int chunks = kpad / kChunkCodes;

  for (int j = 0; j < a.step_groups; ++j) {
    const int g = g0 + j;
    const float* x = xs + row0 * stride + j * segment(a.dim);
    float best[R];
    int idx[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      best[i] = __int_as_float(0x7f800000);  // +inf
      idx[i] = INT_MAX;
    }
    for (int cc = 0; cc < chunks; ++cc) {
      const int k0 = cc * kChunkCodes;
      float acc[R][kCodes] = {};
      if (a.resident) {
        const float* book = sm.es + static_cast<size_t>(g) * a.dim * kpad + k0 + lead;
        accumulate<R>(acc, x, stride, book, kpad, 0, a.dim);
        compare<R>(acc, sm.esq + g * kpad + k0, k0, lead, a.codes, best, idx);
        continue;
      }
      // streamed: [32][512] blocks of this chunk through the two-block ring,
      // ||e||^2 of the thread's codes carried from block to block
      const int dblocks = (a.dim + kStreamDims - 1) / kStreamDims;
      float sq[kNorms] = {};
      stage_codes(a, sm.es, kChunkCodes, g, 0, min(kStreamDims, a.dim), k0, kChunkCodes);
      cp_commit();
      for (int b = 0; b < dblocks; ++b) {
        const int d0 = b * kStreamDims, nd = min(kStreamDims, a.dim - d0);
        if (b + 1 < dblocks) {
          stage_codes(a, sm.es + ((b + 1) & 1) * kStreamDims * kChunkCodes, kChunkCodes, g,
                      d0 + kStreamDims, min(kStreamDims, a.dim - d0 - kStreamDims), k0,
                      kChunkCodes);
          cp_commit();
          cp_wait<1>();
        } else {
          cp_wait<0>();
        }
        __syncthreads();
        const float* blk = sm.es + (b & 1) * kStreamDims * kChunkCodes;
        accumulate<R>(acc, x, stride, blk + lead, kChunkCodes, d0, nd);
#pragma unroll
        for (int h = 0; h < kNorms; ++h) {
          for (int d = 0; d < nd; ++d) {
            const float e = blk[d * kChunkCodes + threadIdx.x + h * kThreads];
            sq[h] = fmaf(e, e, sq[h]);
          }
        }
        __syncthreads();  // this block is consumed before block b + 2 lands in it
      }
#pragma unroll
      for (int h = 0; h < kNorms; ++h) sm.esq[threadIdx.x + h * kThreads] = sq[h];
      __syncthreads();
      compare<R>(acc, sm.esq, k0, lead, a.codes, best, idx);
      // the next chunk writes esq only after the ring's barriers
    }

    // merge the lanes along codes of each row (the warps along codes below)
    // as a reduce-scatter: at each lane bit, a lane keeps half its rows and
    // takes its partner's candidates for them, so a lane ends with one row
    // (3 shuffle rounds of 4, 2, 1 rows for 8 rows, not 3 of 8)
    int held = 0;       // the lane's first row, counted in the thread's rows
    int repeated = 0;   // lane bits along which lanes end with the same row
#pragma unroll
    for (int bit = kCodeLanes / 2, n = R; bit >= 1; bit /= 2) {
      if (n > 1) {
        const bool upper = code_lane & bit;
#pragma unroll
        for (int k = 0; k < n / 2; ++k) {
          const float send = upper ? best[k] : best[k + n / 2];
          const int send_idx = upper ? idx[k] : idx[k + n / 2];
          best[k] = upper ? best[k + n / 2] : best[k];
          idx[k] = upper ? idx[k + n / 2] : idx[k];
          take(best[k], idx[k], __shfl_xor_sync(0xffffffffu, send, bit),
               __shfl_xor_sync(0xffffffffu, send_idx, bit));
        }
        held += upper ? n / 2 : 0;
        n /= 2;
      } else {
        take(best[0], idx[0], __shfl_xor_sync(0xffffffffu, best[0], bit),
             __shfl_xor_sync(0xffffffffu, idx[0], bit));
        repeated |= bit;
      }
    }
    float* mscore = sm.mscore + j * kCodeWarps * kStepRows;
    int* midx = sm.midx + j * kCodeWarps * kStepRows;
    constexpr int kLeft = R > kCodeLanes ? R / kCodeLanes : 1;  // rows a lane ends with
#pragma unroll
    for (int k = 0; k < kLeft; ++k) {
      if ((code_lane & repeated) == 0) {
        mscore[code_warp * kStepRows + row0 + kRowLanes * (held + k)] = best[k];
        midx[code_warp * kStepRows + row0 + kRowLanes * (held + k)] = idx[k];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * a.step_groups; i += kThreads) {
    const int j = i / rows, r = i - j * rows, n = n0 + r;
    const float* mscore = sm.mscore + j * kCodeWarps * kStepRows;
    const int* midx = sm.midx + j * kCodeWarps * kStepRows;
    float b = mscore[r];
    int k = midx[r];
    for (int w = 1; w < kCodeWarps; ++w) take(b, k, mscore[w * kStepRows + r], midx[w * kStepRows + r]);
    // a row whose every score is NaN keeps no index: it gets 0
    if (n < a.rows) a.out[static_cast<size_t>(n) * a.groups + g0 + j] = k == INT_MAX ? 0 : k;
  }
}

// units u and u + 1 where both lie in u's group and range (a full step), or u alone
__device__ __forceinline__ int step_units(const Args& a, int u, int u1) {
  return u + 1 < u1 && (u + 1) / a.tiles == u / a.tiles ? 2 : 1;
}

// 64 accumulators a thread: one CTA an SM (255 registers a thread)
__global__ void __launch_bounds__(kThreads, 1)
nearest_code_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int stride = row_stride(a.dim, a.step_groups);
  const int kpad = pad_codes(a.codes);
  Smem sm;
  sm.es = smem;
  float* xs = sm.es + (a.resident ? static_cast<size_t>(a.groups) * a.dim * kpad
                                  : 2 * kStreamDims * kChunkCodes);  // [2][kStepRows][stride]
  sm.esq = xs + 2 * kStepRows * stride;
  sm.mscore = sm.esq + (a.resident ? a.groups * kpad : kChunkCodes);
  sm.midx = reinterpret_cast<int*>(sm.mscore + a.step_groups * kCodeWarps * kStepRows);

  const int q = a.units / gridDim.x, rem = a.units % gridDim.x;
  const int u0 = blockIdx.x * q + min(static_cast<int>(blockIdx.x), rem);
  const int u1 = u0 + q + (static_cast<int>(blockIdx.x) < rem ? 1 : 0);

  // resident: every group's codebook, once a call ([G * S][Kpad], codes past
  // K zero-filled); streamed: a unit's group streams in search_step
  if (a.resident) stage_codes(a, sm.es, kpad, 0, 0, a.groups * a.dim, 0, kpad);
  const RowCopies copies = row_copies(a);
  int count = step_units(a, u0, u1);
  stage_rows(a, copies, xs, u0 / a.tiles, (u0 % a.tiles) * kUnitRows, count * kUnitRows);
  cp_commit();

  for (int u = u0, buf = 0, step = count; u < u1; u += step, step = count, buf ^= 1) {
    const int g0 = u / a.tiles, n0 = (u - g0 * a.tiles) * kUnitRows;
    cp_wait<0>();
    __syncthreads();  // this step's rows (and the codebooks) landed; the last step is done
    if (a.resident && u == u0) {
      code_norms(a, sm, kpad, 0, a.groups);
      __syncthreads();
    }
    if (u + step < u1) {  // the next step's rows, while this one computes
      const int next = u + step;
      count = step_units(a, next, u1);
      stage_rows(a, copies, xs + (buf ^ 1) * kStepRows * stride, next / a.tiles,
                 (next % a.tiles) * kUnitRows, count * kUnitRows);
      cp_commit();
    }
    if (step == 2) {
      search_step<kRows>(a, sm, xs + buf * kStepRows * stride, stride, kpad, g0, n0);
    } else {
      search_step<kRows / 2>(a, sm, xs + buf * kStepRows * stride, stride, kpad, g0, n0);
    }
  }
}

}  // namespace

// flat [rows, >= groups * dim] fp32 with row stride ld floats and contiguous
// columns; codebook [groups, dim, codes] fp32 contiguous; out [rows, groups]
// int32. ctas, resident and smem from ops/vq_cuda.py::search_plan (smem must
// be this file's own figure for (dim, codes, resident)). 1 <= dim <= 256,
// codes >= 1, groups >= 1. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int sst_nearest_code(const void* flat, const void* codebook, void* out, int rows,
                                int ld, int groups, int dim, int codes, int ctas, int resident,
                                int smem, void* stream) {
  if (rows < 0 || groups < 1 || dim < 1 || dim > kMaxDim || codes < 1 || ctas < 1 ||
      ld < groups * dim ||
      static_cast<size_t>(smem) != smem_bytes(dim, codes, groups, resident != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  Args a;
  a.flat = static_cast<const float*>(flat);
  a.codebook = static_cast<const float*>(codebook);
  a.out = static_cast<int*>(out);
  a.ld = ld;
  a.rows = rows;
  a.groups = groups;
  a.dim = dim;
  a.codes = codes;
  a.tiles = (rows + kUnitRows - 1) / kUnitRows;
  a.step_groups = resident ? groups : 1;  // resident: a unit is a row tile of every group
  a.units = a.tiles * (resident ? 1 : groups);
  a.rows16 = reinterpret_cast<uintptr_t>(flat) % 16 == 0 && ld % 4 == 0 && dim % 4 == 0;
  a.codes16 = reinterpret_cast<uintptr_t>(codebook) % 16 == 0 && codes % 4 == 0;
  a.resident = resident != 0;
  // a CTA stages a step's rows in one pass of its threads (row_copies)
  const int row_copies_needed = a.step_groups * (a.rows16 ? dim / 4 : dim);
  if (ctas > a.units || row_copies_needed > kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the opt-in above 48 KB, once per device and size (a runtime API call per
  // launch would add host time to every search)
  static size_t opted_in[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024 && (device >= 64 || static_cast<size_t>(smem) > opted_in[device])) {
    err = cudaFuncSetAttribute(nearest_code_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 64) opted_in[device] = smem;
  }
  nearest_code_kernel<<<ctas, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
