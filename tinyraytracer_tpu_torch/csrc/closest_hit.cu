// Closest-hit selection kernel (K3) for Hopper (sm_90a).
//
// Replaces the TPU kernel tinyraytracer_tpu/ops/intersect_pallas.py:166
// (`_closest_hit_kernel`, launched by `closest_hit_pallas`): for each ray
// of a batch, the detached closest hit over a compacted scene, spheres
// then quads, returned as the screening t and the winner's global
// primitive id (spheres-then-quads, through `index_map`; -1 = miss). The
// modular differentiable path (ops/trace.py) calls it twice per bounce:
// the winner of each ray, and the occluder test of each NEE shadow ray.
// Its plain PyTorch twin is `closest_hit_reference` in
// ops/intersect_kernel.py.
//
// Design: one thread per ray, 256 threads per block, the grid over the
// rays. The TPU kernel's (rows, 512-ray tile) candidate matrix in VMEM
// becomes, per thread, a walk over the real sphere rows and then the real
// quad rows with a strict `<` running minimum: the first row at the
// minimum wins, which is the TPU kernel's "min, then lowest row at the
// min" (intersect_pallas.py:233-241). Inert pad rows (centers at 1e30,
// zero quad normals) never hit, so they are not walked. Rows are AoS
// float4s (sphere: c, r^2; quad: n, dp | av, ca | bv, cb) that all threads
// of a warp read together through `__ldg`: broadcast loads. Rays are read
// in place through two strides per array, so an (R, 3) tensor or a view of
// three (R,) components goes in without a transpose copy.
//
// The hit tests are the Pallas kernel's (intersect_pallas.py:185-231), op
// for op, not common.cuh's: they also bound t below MISS. Built with
// --fmad=false, f32 literals as JAX rounds them (1e-3f, 3.0e38f, 1e-12f),
// IEEE sqrt and division, so the twin gives the same bits.
//
// What bounds it: memory. A ray reads 24 bytes and writes 8, and a
// config-5 scene (2 spheres, 6 quads) costs ~350 FP32 operations per ray,
// so at 3.35 TB/s and 67 TFLOP/s the bytes take longer. Left for later:
// nothing much; at a few microseconds per call, launch overhead is of the
// same size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTMin = 1e-3f;
constexpr float kMiss = 3.0e38f;
constexpr int kThreads = 256;

// Sphere (c, r^2): the near root, else the far one, in [T_MIN, MISS).
__device__ __forceinline__ float sphere_t(float4 s, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz) {
  const float ocx = ox - s.x;
  const float ocy = oy - s.y;
  const float ocz = oz - s.z;
  const float half_b = ocx * dx + ocy * dy + ocz * dz;
  const float c_term = ocx * ocx + ocy * ocy + ocz * ocz - s.w;
  const float disc = half_b * half_b - c_term;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t0 = -half_b - sq;
  const float t1 = -half_b + sq;
  const float ts = (t0 >= kTMin && t0 < kMiss)
                       ? t0
                       : ((t1 >= kTMin && t1 < kMiss) ? t1 : kMiss);
  return disc >= 0.0f ? ts : kMiss;
}

// Quad plane (n, dp = n.corner) and planar rows (av, ca), (bv, cb):
// half-open [0, 1) coordinates, t in [T_MIN, MISS). The |n.d| guard comes
// before the clamp, so a grazing ray is no hit.
__device__ __forceinline__ float quad_t(float4 a, float4 b, float4 c,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  float den = a.x * dx + a.y * dy + a.z * dz;
  const bool ok_den = fabsf(den) >= 1e-12f;
  den = ok_den ? den : 1e-12f;
  const float tq = (a.w - (a.x * ox + a.y * oy + a.z * oz)) / den;
  const float al =
      (b.x * ox + b.y * oy + b.z * oz) + tq * (b.x * dx + b.y * dy + b.z * dz) -
      b.w;
  const float be =
      (c.x * ox + c.y * oy + c.z * oz) + tq * (c.x * dx + c.y * dy + c.z * dz) -
      c.w;
  const bool ok = ok_den && tq >= kTMin && tq < kMiss && al >= 0.0f &&
                  al < 1.0f && be >= 0.0f && be < 1.0f;
  return ok ? tq : kMiss;
}

__global__ void __launch_bounds__(kThreads)
    closest_hit_kernel(const float* __restrict__ o, long long o_ray,
                       long long o_comp, const float* __restrict__ d,
                       long long d_ray, long long d_comp,
                       const float4* __restrict__ sph, int n_sph,
                       const float4* __restrict__ quad, int n_quad,
                       int q_row0, const int* __restrict__ index_map,
                       float* __restrict__ t_out, int* __restrict__ j_out,
                       int n_rays) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float* po = o + r * o_ray;
  const float* pd = d + r * d_ray;
  const float ox = po[0], oy = po[o_comp], oz = po[2 * o_comp];
  const float dx = pd[0], dy = pd[d_comp], dz = pd[2 * d_comp];

  float best = kMiss;
  int win = -1;
  for (int k = 0; k < n_sph; ++k) {
    const float t = sphere_t(__ldg(sph + k), ox, oy, oz, dx, dy, dz);
    if (t < best) {  // strict: the first row at the minimum keeps the win
      best = t;
      win = k;
    }
  }
  for (int k = 0; k < n_quad; ++k) {
    const float t = quad_t(__ldg(quad + 3 * k), __ldg(quad + 3 * k + 1),
                           __ldg(quad + 3 * k + 2), ox, oy, oz, dx, dy, dz);
    if (t < best) {
      best = t;
      win = q_row0 + k;
    }
  }
  t_out[r] = best;
  j_out[r] = win >= 0 ? __ldg(index_map + win) : -1;
}

}  // namespace

extern "C" {

// Closest hit of n_rays rays on `stream`. Ray r's origin component c is
// o[r * o_ray + c * o_comp] (direction likewise). `sph` (n_sph, 4) and
// `quad` (n_quad, 12) are the real compacted rows, 16-byte aligned;
// quad k is compacted row q_row0 + k; `index_map` sends a compacted row to
// its global primitive id. Writes t (f32) and j (i32, -1 = miss). Returns
// the launch's cudaError_t (0 on success); does not synchronise.
int tinyrt_closest_hit(const float* o, long long o_ray, long long o_comp,
                       const float* d, long long d_ray, long long d_comp,
                       const float* sph, int n_sph, const float* quad,
                       int n_quad, int q_row0, const int* index_map,
                       float* t_out, int* j_out, int n_rays, void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  closest_hit_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      o, o_ray, o_comp, d, d_ray, d_comp,
      reinterpret_cast<const float4*>(sph), n_sph,
      reinterpret_cast<const float4*>(quad), n_quad, q_row0, index_map,
      t_out, j_out, n_rays);
  return (int)cudaGetLastError();
}

}  // extern "C"
