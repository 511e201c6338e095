// Block-shape probe (P1) for Hopper (sm_90a): K = 2 000 chained steps
// y = y * 1.000001 + x; y = (y > 2) ? y - 2 : y on every element of one
// resident block.
//
// Replaces the TPU kernel scripts/probe_sublanes.py:23 (`make(shape)`,
// whose pallas_call at :36 runs the chain over a grid of GRID = 512
// steps on blocks of shape (1, 1024), (8, 128), (8, 1024), (16, 1024)
// and (1, 8192)). On the TPU the question was whether a (1, N) block
// wastes 7 of 8 sublanes. The card has no sublanes: a block is
// n = S * L independent chains, so the shape only sets the threads and
// the chains a thread carries.
//
// Its plain PyTorch twin is `sublanes_reference` in utils/probes.py,
// which runs the same operations (--fmad=false: the multiply and the add
// round apart): the kernel equals it bit for bit. XLA contracts the
// multiply-add on the CPU, so the JAX body differs by a few ulps
// (tests/test_torch_probes.py states them).
//
// Design: a CUDA block per grid step, min(n, 1024) threads, each taking
// elements t, t + 1024, ... (so a (1, 8192) block gives a thread 8
// chains, one after another); the GRID steps run side by side, each
// storing the whole block to the one output (a race of identical values:
// GRID = 1 and GRID = 512 give the same bits). The chain is in
// registers, unrolled by 4.
//
// What bounds it: FP32 operations, 4 a step in utils/sol.py's rule (the
// multiply, the add, the compare and the subtract; the select is not
// counted; the probe's own rate counts 3); a float in and one out an
// element.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads) chain_kernel(
    const float* __restrict__ x, float* __restrict__ out, int n, int iters) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float xv = x[e];
    float y = xv;
#pragma unroll 4
    for (int k = 0; k < iters; ++k) {
      y = y * 1.000001f + xv;
      y = y > 2.0f ? y - 2.0f : y;
    }
    out[e] = y;
  }
}

}  // namespace

extern "C" {

// The chain over `grid` grid steps of an n-element block: x and out (n,)
// f32 in device memory, `iters` steps. Returns the launch's cudaError_t;
// does not synchronise.
int tinyrt_probe_sublanes(const float* x, float* out, int n, int grid,
                          int iters, void* stream) {
  if (n < 1 || grid < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  const int threads = n < kMaxThreads ? n : kMaxThreads;
  chain_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
