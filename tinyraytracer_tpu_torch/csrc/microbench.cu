// Measured-mix microbenchmark (P5) for Hopper (sm_90a): the FP32 rate the
// card sustains on five op mixes, in utils/sol.py's counting units.
//
// Replaces the TPU kernel scripts/probe_vpu_microbench.py:40 (`run_mix`,
// with its mixes fma3 :86, selmix :95, sphere :108 and transc :128). The
// probe timed a fori_loop of exact op counts over a resident (32, 256)
// tile; here every thread runs three chains in registers for `iters`
// iterations and writes their sum (below). Its plain PyTorch twin is
// `microbench_reference` in utils/microbench.py, which also times it
// (`measure`) and holds the rates that utils/sol.py's
// `pct_of_sol_measured` divides by.
//
// The mixes (MIX, counted operations an iteration of the three chains):
// - kFma (6): x = fma(x, a, b) per chain with an explicit __fmaf_rn,
//   counted 2 a fused multiply-add as the probe counts it: the data
//   sheet's FP32 peak.
// - kSelect (6): the probe's selmix as the kernels are built
//   (--fmad=false): compare, multiply, add, select, multiply, max, add;
//   the select is not counted (sol.py counts no select).
// - kSphere (72): common.cuh's sphere_hit_t and the running-minimum
//   compare, the candidate row K1 and K2 run, on each chain: 3 x
//   sol.OPS_SPHERE_ROW. The ray's origin is (v, v, v) for a chain's value
//   v; the constants put the sphere ahead of every origin, so each test
//   hits (disc > 0: IEEE sqrtf's fast path) and the fold keeps v. Each
//   chain also keeps its last hit distance, which the output adds in, so
//   the result carries the row's arithmetic.
// - kTransc (13): the probe's transc in the port's idiom: 1.0f/sqrtf for
//   rsqrt (common.cuh), an IEEE divide, the cube root as
//   expf(logf(x) * (1/3)); every input stays near 1, off the slow paths.
// - kQuad (135): common.cuh's quad_hit_t and the fold, 3 x
//   sol.OPS_QUAD_ROW, the row of cornell_box's 18 quads. Chain x tests
//   quad row 0 from origin (x, x, x) along (y, y, y), y row 1 from (y, y,
//   y) along (z, z, z), z row 2 from (z, z, z) along (x, x, x): with both
//   the origin and the direction varying, no plane or edge dot product is
//   loop-invariant (in K1 they vary from row to row), and with a row per
//   chain no product is shared between two tests. Every test hits ahead (an IEEE divide on its fast
//   path); the last hit distances join the output as for kSphere.
//
// Output: x + y + z, then, for kSphere and kQuad, + tx + ty + tz (the
// last iteration's hit distances: 0 after no iteration).
//
// The constants arrive as a kernel parameter, so nvcc folds none of them;
// the loop runs kUnroll iterations a pass (iters must be a multiple), so
// its body is one back edge whose instructions chip_smoke.py counts.
//
// What bounds it: instruction issue, by design (no memory traffic beyond
// one float in and one out a thread). The grid is one full wave: every SM
// at the occupancy __launch_bounds__ asks for (8 blocks of 256 threads),
// each warp with three independent chains in flight.

#include <cstring>

#include "common.cuh"

namespace {

using namespace tinyrt;

constexpr int kThreads = 256;
constexpr int kMinBlocks = 8;
constexpr int kUnroll = 4;
constexpr int kConsts = 38;

enum Mix { kFma = 0, kSelect = 1, kSphere = 2, kTransc = 3, kQuad = 4 };

// k[0], k[1]: y = x * k[0] and z = x * k[1] at the start (the probe's);
// k[2..]: the mix's constants (utils/microbench.py CONSTS); kQuad's are
// three rows of quad_hit_t's 12 (n, n.corner, av, ca, bv, cb).
struct Consts {
  float k[kConsts];
};

__device__ __forceinline__ float quad_row_t(const float* q, float o,
                                            float d) {
  return quad_hit_t(q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8],
                    q[9], q[10], q[11], o, o, o, d, d, d);
}

// One iteration of the three chains; tx, ty, tz take the candidate mixes'
// hit distances.
template <int MIX>
__device__ __forceinline__ void mix_step(float& x, float& y, float& z,
                                         float& tx, float& ty, float& tz,
                                         const Consts& c) {
  if (MIX == kFma) {
    x = __fmaf_rn(x, c.k[2], c.k[5]);
    y = __fmaf_rn(y, c.k[3], c.k[5]);
    z = __fmaf_rn(z, c.k[4], c.k[5]);
  } else if (MIX == kSelect) {
    const bool lt = x < y;
    const float xa = x * c.k[2] + c.k[3];
    x = lt ? xa : y;
    y = fmaxf(y * c.k[4], z);
    z = z + c.k[5];
  } else if (MIX == kSphere) {
    tx = sphere_hit_t(c.k[2], c.k[3], c.k[4], c.k[5], x, x, x, c.k[6],
                      c.k[7], c.k[8]);
    x = tx < x ? tx : x;
    ty = sphere_hit_t(c.k[2], c.k[3], c.k[4], c.k[5], y, y, y, c.k[6],
                      c.k[7], c.k[8]);
    y = ty < y ? ty : y;
    tz = sphere_hit_t(c.k[2], c.k[3], c.k[4], c.k[5], z, z, z, c.k[6],
                      c.k[7], c.k[8]);
    z = tz < z ? tz : z;
  } else if (MIX == kQuad) {
    tx = quad_row_t(c.k + 2, x, y);
    x = tx < x ? tx : x;
    ty = quad_row_t(c.k + 14, y, z);
    y = ty < y ? ty : y;
    tz = quad_row_t(c.k + 26, z, x);
    z = tz < z ? tz : z;
  } else {
    x = 1.0f / sqrtf(fmaxf(x * x + c.k[2], c.k[3]));
    y = (y + c.k[4]) / (x + c.k[5]);
    z = expf(logf(fmaxf(z + c.k[6], c.k[3])) * c.k[7]);
  }
}

template <int MIX>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    microbench_kernel(const float* __restrict__ in, float* __restrict__ out,
                      int n, int iters, Consts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x = in[i];
  float y = x * c.k[0];
  float z = x * c.k[1];
  float tx = 0.0f, ty = 0.0f, tz = 0.0f;
#pragma unroll 1
  for (int it = 0; it < iters; it += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) mix_step<MIX>(x, y, z, tx, ty, tz, c);
  }
  out[i] = (MIX == kSphere || MIX == kQuad) ? x + y + z + tx + ty + tz
                                             : x + y + z;
}

template <int MIX>
cudaError_t launch(const float* in, float* out, int n, int iters,
                   const Consts& c, cudaStream_t st) {
  const int blocks = (n + kThreads - 1) / kThreads;
  microbench_kernel<MIX><<<blocks, kThreads, 0, st>>>(in, out, n, iters, c);
  return cudaGetLastError();
}

template <int MIX>
cudaError_t wave(int& threads) {
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, microbench_kernel<MIX>, kThreads, 0);
  threads = sms * blocks * kThreads;
  return e;
}

}  // namespace

extern "C" {

// Runs mix `mix` (0 fma, 1 select, 2 sphere, 3 transcendental, 4 quad) for
// `iters` iterations (a multiple of 4) on n threads, thread i starting
// from in[i] and writing out[i], with the kConsts constants at `consts`
// (host memory). Returns the launch's cudaError_t; does not synchronise.
int tinyrt_microbench(const float* in, float* out, int n, int mix, int iters,
                      const float* consts, void* stream) {
  if (n < 0 || iters < 0 || iters % kUnroll) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Consts c;
  memcpy(c.k, consts, sizeof(c.k));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mix) {
    case kFma:
      return (int)launch<kFma>(in, out, n, iters, c, st);
    case kSelect:
      return (int)launch<kSelect>(in, out, n, iters, c, st);
    case kSphere:
      return (int)launch<kSphere>(in, out, n, iters, c, st);
    case kTransc:
      return (int)launch<kTransc>(in, out, n, iters, c, st);
    case kQuad:
      return (int)launch<kQuad>(in, out, n, iters, c, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Threads of one full wave of mix `mix` on the current device (SMs x
// resident blocks x 256), or minus a cudaError_t.
int tinyrt_microbench_wave(int mix) {
  int threads = 0;
  cudaError_t e = cudaErrorInvalidValue;
  switch (mix) {
    case kFma:
      e = wave<kFma>(threads);
      break;
    case kSelect:
      e = wave<kSelect>(threads);
      break;
    case kSphere:
      e = wave<kSphere>(threads);
      break;
    case kTransc:
      e = wave<kTransc>(threads);
      break;
    case kQuad:
      e = wave<kQuad>(threads);
      break;
  }
  return e == cudaSuccess ? threads : -(int)e;
}

}  // extern "C"
