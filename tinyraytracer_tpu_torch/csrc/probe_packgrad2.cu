// Winner-field gather and scalar-sum table probe (P3) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel scripts/probe_packgrad2.py:77 (`run`, whose
// pallas_call at :86 runs `kernel_C` :26 and `kernel_D` :48 over a grid
// of GRID = 512 steps). Each step, over a (S, L) = (16, 256) tile and
// B = 16 bounces, with row = (lane + sub) mod 24:
// - C: each element adds fields 0-7 of the (32, 24) table `pay` at
//   column (row + b) mod 24, in field order, to its running total (a
//   one-hot (32, 24) x (24, S*L) matmul on the TPU's MXU; each output
//   has one nonzero term, so the product is the gathered value exactly);
//   out (16, 256).
// - D: for p < 4, the tile's sums of c, 2c, 3c and 4c with
//   c = (row == p) * (lane + b), added into rows 0-3, columns 0-3 of a
//   (24, 128) table; zeros elsewhere.
// Their plain PyTorch twins are `packgrad2_reference` in
// utils/probes.py. C adds in the body's order, so it equals the JAX body
// and the twin bit for bit; D's terms are integers whose sums stay below
// 2^24, exact in any order: bit for bit too.
//
// Design. A CUDA block is one grid step, 256 threads, thread t the lane
// t of every sublane; the GRID steps run as GRID blocks side by side and
// each stores the whole output block (a race of identical values, so
// GRID = 1 and GRID = 512 give the same bits).
// - C copies `pay` (3 KB) into shared memory; a thread walks its 16
//   elements, each through the B bounces, gathering by index: 8 shared
//   loads and 8 adds an element and bounce. A warp's 32 lanes read 24
//   consecutive columns of one field: no bank conflict.
// - D keeps a thread's 16 partial sums in registers over sublanes and
//   bounces; a warp-shuffle tree and the 8 warps in order then give the
//   16 table entries.
//
// What bounds it: FP32 operations (utils/probes.py OPS_PER_ELEMENT: 8 an
// element and bounce for C; 32 for D, plus lane + b once a lane and
// bounce); C moves 3 KB in and 16 KB out.

#include <cuda_runtime.h>

namespace {

constexpr int kS = 16;
constexpr int kL = 256;
constexpr int kNA = 24;
constexpr int kF = 32;
constexpr int kFields = 8;
constexpr int kP = 4;
constexpr int kCols = 128;
constexpr int kWarps = kL / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kL) gather_kernel(
    const float* __restrict__ pay, float* __restrict__ out, int bounces) {
  __shared__ float spay[kF * kNA];
  const int l = threadIdx.x;
  for (int i = l; i < kF * kNA; i += kL) spay[i] = pay[i];
  __syncthreads();
#pragma unroll 1
  for (int s = 0; s < kS; ++s) {
    const int row = (l + s) % kNA;
    float acc = 0.0f;
#pragma unroll 1
    for (int b = 0; b < bounces; ++b) {
      const int col = (row + b) % kNA;
      float tot = acc;
#pragma unroll
      for (int i = 0; i < kFields; ++i) tot = tot + spay[i * kNA + col];
      acc = tot;
    }
    out[s * kL + l] = acc;
  }
}

__global__ void __launch_bounds__(kL) table_kernel(float* __restrict__ out,
                                                   int bounces) {
  __shared__ float part[kWarps][kP * 4];
  const int l = threadIdx.x;
  const int lane = l & 31;
  const int w = l >> 5;
  float acc[kP * 4];
#pragma unroll
  for (int j = 0; j < kP * 4; ++j) acc[j] = 0.0f;
  const float lf = (float)l;
#pragma unroll 1
  for (int b = 0; b < bounces; ++b) {
    const float lb = lf + (float)b;
#pragma unroll 1
    for (int s = 0; s < kS; ++s) {
      const float rowf = (float)((l + s) % kNA);
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const float m = rowf == (float)p ? 1.0f : 0.0f;
        const float c = m * lb;
        acc[4 * p] = acc[4 * p] + c;
        acc[4 * p + 1] = acc[4 * p + 1] + c * 2.0f;
        acc[4 * p + 2] = acc[4 * p + 2] + c * 3.0f;
        acc[4 * p + 3] = acc[4 * p + 3] + c * 4.0f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kP * 4; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(kFull, v, off);
    if (lane == 0) part[w][j] = v;
  }
  __syncthreads();
  for (int i = l; i < kNA * kCols; i += kL) {
    const int r = i / kCols;
    const int k = i % kCols;
    float v = 0.0f;
    if (r < kP && k < 4) {
      v = part[0][4 * r + k];
#pragma unroll
      for (int u = 1; u < kWarps; ++u) v = v + part[u][4 * r + k];
    }
    out[i] = v;
  }
}

}  // namespace

extern "C" {

// Kernel `which` (0: C, the gather from `pay`, (32, 24) f32 in device
// memory, into a (16, 256) out; 1: D, the table, into a (24, 128) out;
// pay unused) over `grid` grid steps of `bounces` bounces. Returns the
// launch's cudaError_t; does not synchronise.
int tinyrt_probe_packgrad2(const float* pay, float* out, int which, int grid,
                           int bounces, void* stream) {
  if (grid < 1 || bounces < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (which == 0)
    gather_kernel<<<grid, kL, 0, st>>>(pay, out, bounces);
  else if (which == 1)
    table_kernel<<<grid, kL, 0, st>>>(out, bounces);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
