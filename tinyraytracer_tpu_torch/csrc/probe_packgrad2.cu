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
// t of every sublane; the GRID steps run as GRID blocks side by side.
// Every block computes the whole output block, and only the last one
// stores it: the TPU's out_specs map every step to block (0, 0), which
// stays in VMEM across the grid and is written back once. The other
// blocks keep their results live by comparing each with `sentinel`, a
// NaN passed at launch that nvcc cannot fold, and storing on a match
// that never comes. Whichever block stores, the bits are the same.
// - C copies fields 0-7 of `pay` into a shared table of 16-byte cells,
//   tab[h][c] = fields 4h..4h+3 of column c mod 24 for c < 48: one
//   element's gather is two LDS.128 (its columns sit 768 bytes apart), in
//   field order. The table holds the 24 columns twice, so within a run of
//   24 bounces the column is row + j with no wrap; (row + 24) mod 24 =
//   row, so every run starts at the element's row. A thread runs 4
//   elements (sublanes) side by side: 4 independent add chains. The 8
//   lanes of a 16-byte access phase read 8 consecutive columns mod 24,
//   distinct mod 8 (24 is a multiple of 8): no bank conflict.
// - D's masks m_p = (row == p) do not depend on the bounce: sublanes
//   run outside the bounce loop, 4 at a time, their 16 masks made once;
//   lane + b is carried as a float incremented by 1 (exact below 2^24,
//   the same bits as lane + (float)b). A thread's 16 partial sums stay in
//   registers; a warp-shuffle tree and the 8 warps in order give the 16
//   table entries, and the storing block writes the table as three
//   16-byte stores a thread.
//
// What bounds it (H100, utils/probes.py and chip_smoke.py phase 23): C's
// gathers read 32 bytes an element and bounce from shared memory, which
// serves 128 bytes a SM and clock: 8 wavefronts a warp and bounce, 32 us
// at the probe's GRID (33 on the SMs that hold 4 blocks), above its issue
// bound and far above its FP32 one (OPS_PER_ELEMENT: 8 an element and
// bounce). Each element keeps its own gather, as a winner-field gather
// must, so the design cuts what surrounds it (no `%`, two 16-byte loads,
// 4 add chains a thread: 25 -> 12 instructions an element and bounce)
// and runs at that traffic. D reads nothing; its issue bound (32 counted
// operations an element and bounce, each one instruction, plus the
// lane + b add and the loop) sets its time, and the design takes the
// masks and `%` out of its loop (48 -> 33). Nothing is read from device
// memory but C's 3 KB; 16 KB (C) or 12 KB (D) are written, once: the
// 512 blocks' stores of one block had cost nothing measurable.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kS = 16;
constexpr int kL = 256;
constexpr int kNA = 24;
constexpr int kP = 4;
constexpr int kCols = 128;
constexpr int kWarps = kL / 32;
constexpr int kE = 4;          // sublanes a thread runs side by side
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wrap_row(int r) {
  return r >= kNA ? r - kNA : r;
}

__global__ void __launch_bounds__(kL, 4) gather_kernel(
    const float* __restrict__ pay, float* __restrict__ out, int bounces,
    float sentinel) {
  __shared__ float4 tab[2][2 * kNA];
  const int l = threadIdx.x;
  if (l < 4 * kNA) {
    const int h = l / (2 * kNA);
    const int col = (l % (2 * kNA)) % kNA;
    const float* f = pay + 4 * h * kNA + col;
    tab[h][l % (2 * kNA)] = make_float4(f[0], f[kNA], f[2 * kNA],
                                        f[3 * kNA]);
  }
  __syncthreads();
  const bool last = blockIdx.x == gridDim.x - 1;
  int row = l % kNA;
#pragma unroll 1
  for (int s = 0; s < kS; s += kE) {
    const float4* p[kE];
    float acc[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      p[e] = &tab[0][wrap_row(row + e)];
      acc[e] = 0.0f;
    }
#pragma unroll 1
    for (int b0 = 0; b0 < bounces; b0 += kNA) {
      const int n = min(bounces - b0, kNA);
#pragma unroll 1
      for (int j = 0; j < n; ++j) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float4 lo = p[e][j];
          const float4 hi = p[e][j + 2 * kNA];
          float tot = acc[e];
          tot = tot + lo.x;
          tot = tot + lo.y;
          tot = tot + lo.z;
          tot = tot + lo.w;
          tot = tot + hi.x;
          tot = tot + hi.y;
          tot = tot + hi.z;
          tot = tot + hi.w;
          acc[e] = tot;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (last || acc[e] == sentinel) out[(s + e) * kL + l] = acc[e];
    row = wrap_row(row + kE);
  }
}

__global__ void __launch_bounds__(kL) table_kernel(float* __restrict__ out,
                                                   int bounces,
                                                   float sentinel) {
  __shared__ float part[kWarps][kP * 4];
  __shared__ float sums[kP * 4];
  const int l = threadIdx.x;
  const int lane = l & 31;
  const int w = l >> 5;
  float acc[kP * 4];
#pragma unroll
  for (int j = 0; j < kP * 4; ++j) acc[j] = 0.0f;
  const float lf = (float)l;
  int row = l % kNA;
#pragma unroll 1
  for (int s = 0; s < kS; s += kE) {
    float m[kE][kP];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int r = wrap_row(row + e);
#pragma unroll
      for (int q = 0; q < kP; ++q) m[e][q] = r == q ? 1.0f : 0.0f;
    }
    float lb = lf;
#pragma unroll 1
    for (int b = 0; b < bounces; ++b) {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
#pragma unroll
        for (int q = 0; q < kP; ++q) {
          const float c = m[e][q] * lb;
          acc[4 * q] = acc[4 * q] + c;
          acc[4 * q + 1] = acc[4 * q + 1] + c * 2.0f;
          acc[4 * q + 2] = acc[4 * q + 2] + c * 3.0f;
          acc[4 * q + 3] = acc[4 * q + 3] + c * 4.0f;
        }
      }
      lb = lb + 1.0f;
    }
    row = wrap_row(row + kE);
  }
#pragma unroll
  for (int j = 0; j < kP * 4; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(kFull, v, off);
    if (lane == 0) part[w][j] = v;
  }
  __syncthreads();
  if (l < kP * 4) {
    float v = part[0][l];
#pragma unroll
    for (int u = 1; u < kWarps; ++u) v = v + part[u][l];
    sums[l] = v;
    if (v == sentinel) out[(l / 4) * kCols + l % 4] = v;
  }
  if (blockIdx.x != gridDim.x - 1) return;
  __syncthreads();
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int q = 0; q < kNA * kCols / 4 / kL; ++q) {
    const int i = l + q * kL;          // 16-byte cell i: row i / 32
    const int r = i / (kCols / 4);
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i % (kCols / 4) == 0 && r < kP)
      x = make_float4(sums[4 * r], sums[4 * r + 1], sums[4 * r + 2],
                      sums[4 * r + 3]);
    o[i] = x;
  }
}

}  // namespace

extern "C" {

// Kernel `which` (0: C, the gather from `pay`, (32, 24) f32 in device
// memory, into a (16, 256) out; 1: D, the table, into a (24, 128) out,
// 16-byte aligned; pay unused) over `grid` grid steps of `bounces`
// bounces, the last step storing out. Returns the launch's cudaError_t;
// does not synchronise.
int tinyrt_probe_packgrad2(const float* pay, float* out, int which, int grid,
                           int bounces, void* stream) {
  if (grid < 1 || bounces < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sentinel = std::nanf("");
  if (which == 0)
    gather_kernel<<<grid, kL, 0, st>>>(pay, out, bounces, sentinel);
  else if (which == 1)
    table_kernel<<<grid, kL, 0, st>>>(out, bounces, sentinel);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Kernel `which` (0: C, 1: D) as the card runs it: info[0] its resident
// blocks of 256 a SM, info[1] its registers a thread. Returns a
// cudaError_t.
int tinyrt_probe_packgrad2_info(int which, int* info) {
  if (which != 0 && which != 1) return (int)cudaErrorInvalidValue;
  const void* fn = which == 0 ? (const void*)gather_kernel
                              : (const void*)table_kernel;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], fn, kL, 0);
  info[1] = attr.numRegs;
  return (int)e;
}

}  // extern "C"
