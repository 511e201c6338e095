// Gradient scatter-add probe (P2) for Hopper (sm_90a): per-lane values
// reaching a small (24 x 16) table, by a scatter (kernel A) and by masked
// sums (kernel B).
//
// Replaces the TPU kernel scripts/probe_packgrad.py:71 (`run`, whose
// pallas_call at :73 runs `kernel_A` :26 and `kernel_B` :48 over a grid
// of GRID = 1024 steps). Each step computes, for a (S, L) = (32, 256)
// tile and B = 16 bounces, c = lane * 1e-3 + sub + b and the row
// (lane + sub) mod 24:
// - A: table[row][k] += c * (k + 1) for the K = 16 columns (a one-hot
//   matmul on the TPU's MXU), written into a (24, 128) block with zeros
//   in columns 16-127;
// - B: per row p, the sums of m * c and 2 * m * c with m = (row == p),
//   over lanes and then sublanes, into row 0, columns 2p and 2p + 1.
// Their plain PyTorch twins are `packgrad_reference` in
// utils/probes.py, which run these operations in this file's order: the
// twin equals the kernel bit for bit (the tolerance of the tests and of
// chip_smoke.py is 1e-5 of the table's largest entry, that of the fused
// kernels' gradient tables).
//
// Design. A CUDA block is one grid step: 256 threads, thread t the lane
// t of every sublane, in warps of 32 lanes; the GRID steps run as GRID
// blocks side by side and each stores its whole (24, 128) block to the
// one output (a race of identical values: every block computes the same
// bits, so GRID = 1 and GRID = 1024 give the same output).
// - A scatters without atomics into a table in shared memory a warp
//   (rows padded to 20 floats, 16-byte aligned), one writer a row a
//   sublane step. The lanes that share a row (__match_any_sync) share it
//   at every sublane, since row(l, s) = (row(l, 0) + s) mod 24 moves
//   every row alike: the group, its first lane (the writer) and the
//   largest group are found once. Each step the writer adds the others'
//   16 values to its own in lane order (their c by a shuffle; the
//   products are theirs, bit for bit), then reads its row, adds and
//   stores it as four 16-byte accesses. The row advances by one a step,
//   no `%`. A warp's writers hold 24 distinct rows, consecutive mod 24:
//   each quarter-warp phase of a 16-byte access touches 8 consecutive
//   rows, whose chunks (5 r + q) mod 8 fill the 8 bank quads once, so no
//   access conflicts. At the end the 8 warp tables are added in warp
//   order. The probe's rows are consecutive across a warp's 32 lanes:
//   lanes j and j + 24 share a row (j < 8), so 24 writers of 32 lanes.
// - B keeps each thread's 48 partial sums in registers over bounces and
//   sublanes; at the end a warp-shuffle tree (offsets 16, 8, 4, 2, 1) and
//   the 8 warps in order give row 0.
// No float atomics: two launches give the same bits.
//
// What bounds it: FP32 operations (utils/probes.py OPS_PER_ELEMENT: 34
// per element and bounce for A, 98 for B), and nearer the instructions
// issued and, for A, the shared-memory traffic of the scatter: 24 rows of
// 16 floats read and written a warp and sublane step, 12.9 GB at the
// probe's GRID, against 128 bytes a clock a SM (utils/probes.py
// `shared_bytes`). A's loop issues 106 SASS instructions a lane and step
// (every lane issues the partner's 16 products and adds): on an H100 at
// 1.98 GHz its issue bound, 0.43 ms, lies above the traffic's, 0.39 ms.
// Nothing is read from device memory and 12 KB are written.

#include <cuda_runtime.h>

namespace {

constexpr int kS = 32;
constexpr int kL = 256;
constexpr int kNA = 24;
constexpr int kK = 16;
constexpr int kCols = 128;
constexpr int kWarps = kL / 32;
constexpr int kPad = kK + 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kL) scatter_kernel(float* __restrict__ out,
                                                     int bounces) {
  __shared__ __align__(16) float tab[kWarps][kNA][kPad];
  const int l = threadIdx.x;
  const int lane = l & 31;
  const int w = l >> 5;
  for (int i = lane; i < kNA * kPad; i += 32) (&tab[w][0][0])[i] = 0.0f;
  __syncwarp();
  const float lf = (float)l * 1e-3f;
  const int row0 = l % kNA;
  const unsigned same = __match_any_sync(kFull, row0);
  const unsigned others = same & (same - 1u);   // the group but its first
  const bool writer = (same & (0u - same)) == (1u << lane);
  const int most = (int)__reduce_max_sync(kFull, (unsigned)__popc(same));
#pragma unroll 1
  for (int b = 0; b < bounces; ++b) {
    int row = row0;
#pragma unroll 1
    for (int s = 0; s < kS; ++s) {
      const float c = (lf + (float)s) + (float)b;
      float v[kK];
#pragma unroll
      for (int k = 0; k < kK; ++k) v[k] = c * (float)(k + 1);
      unsigned rest = others;
#pragma unroll 1
      for (int t = 1; t < most; ++t) {   // the group's lanes in order
        const float cm = __shfl_sync(kFull, c, rest ? __ffs(rest) - 1 : lane);
        if (rest) {
#pragma unroll
          for (int k = 0; k < kK; ++k) v[k] = v[k] + cm * (float)(k + 1);
        }
        rest &= rest - 1u;
      }
      if (writer) {
        float4* r = reinterpret_cast<float4*>(&tab[w][row][0]);
#pragma unroll
        for (int q = 0; q < kK / 4; ++q) {
          float4 a = r[q];
          a.x = a.x + v[4 * q];
          a.y = a.y + v[4 * q + 1];
          a.z = a.z + v[4 * q + 2];
          a.w = a.w + v[4 * q + 3];
          r[q] = a;
        }
      }
      __syncwarp();
      row = row == kNA - 1 ? 0 : row + 1;
    }
  }
  __syncthreads();
  for (int i = l; i < kNA * kCols; i += kL) {
    const int r = i / kCols;
    const int k = i % kCols;
    float v = 0.0f;
    if (k < kK) {
      v = tab[0][r][k];
#pragma unroll
      for (int u = 1; u < kWarps; ++u) v = v + tab[u][r][k];
    }
    out[i] = v;
  }
}

__global__ void __launch_bounds__(kL) masked_kernel(float* __restrict__ out,
                                                    int bounces) {
  __shared__ float part[kWarps][2 * kNA];
  const int l = threadIdx.x;
  const int lane = l & 31;
  const int w = l >> 5;
  float acc[2 * kNA];
#pragma unroll
  for (int j = 0; j < 2 * kNA; ++j) acc[j] = 0.0f;
  const float lf = (float)l * 1e-3f;
#pragma unroll 1
  for (int b = 0; b < bounces; ++b) {
#pragma unroll 1
    for (int s = 0; s < kS; ++s) {
      const float c = (lf + (float)s) + (float)b;
      const float rowf = (float)((l + s) % kNA);
#pragma unroll
      for (int p = 0; p < kNA; ++p) {
        const float m = rowf == (float)p ? 1.0f : 0.0f;
        const float mc = m * c;
        acc[2 * p] = acc[2 * p] + mc;
        acc[2 * p + 1] = acc[2 * p + 1] + mc * 2.0f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2 * kNA; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(kFull, v, off);
    if (lane == 0) part[w][j] = v;
  }
  __syncthreads();
  for (int i = l; i < kNA * kCols; i += kL) {
    float v = 0.0f;
    if (i < 2 * kNA) {
      v = part[0][i];
#pragma unroll
      for (int u = 1; u < kWarps; ++u) v = v + part[u][i];
    }
    out[i] = v;
  }
}

}  // namespace

extern "C" {

// Kernel `which` (0: A, the scatter; 1: B, the masked sums) over `grid`
// grid steps of `bounces` bounces, each storing the (24, 128) f32 block
// to out. Returns the launch's cudaError_t; does not synchronise.
int tinyrt_probe_packgrad(float* out, int which, int grid, int bounces,
                          void* stream) {
  if (grid < 1 || bounces < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (which == 0)
    scatter_kernel<<<grid, kL, 0, st>>>(out, bounces);
  else if (which == 1)
    masked_kernel<<<grid, kL, 0, st>>>(out, bounces);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Kernel `which` (0: A, 1: B) as the card runs it: info[0] its resident
// blocks of 256 a SM, info[1] its registers a thread. Returns a
// cudaError_t.
int tinyrt_probe_packgrad_info(int which, int* info) {
  if (which != 0 && which != 1) return (int)cudaErrorInvalidValue;
  const void* fn = which == 0 ? (const void*)scatter_kernel
                              : (const void*)masked_kernel;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], fn, kL, 0);
  info[1] = attr.numRegs;
  return (int)e;
}

}  // extern "C"
