// Closest-hit selection kernel (K3) for Hopper (sm_90a).
//
// Replaces the TPU kernel tinyraytracer_tpu/ops/intersect_pallas.py:166
// (`_closest_hit_kernel`, launched by `closest_hit_pallas`): for each ray
// of a batch, the detached closest hit over a compacted scene, spheres
// then quads, returned as the screening t and the winner's global
// primitive id (spheres-then-quads, through `index_map`; -1 = miss). The
// modular differentiable path (ops/trace.py) calls it twice per bounce:
// the winner of each ray, and the occluder test of each NEE shadow ray,
// which needs only t. Its plain PyTorch twin is `closest_hit_reference`
// in ops/intersect_kernel.py.
//
// The TPU kernel's (rows, 512-ray tile) candidate matrix in VMEM becomes,
// per ray, a walk over the real sphere rows and then the real quad rows
// with a strict `<` running minimum: the first row at the minimum wins,
// which is the TPU kernel's "min, then lowest row at the min"
// (intersect_pallas.py:233-241). Inert pad rows (centers at 1e30, zero
// quad normals) never hit, so they are not walked.
//
// The hit tests are the Pallas kernel's (intersect_pallas.py:185-231), op
// for op, not common.cuh's: they also bound t below MISS. Built with
// --fmad=false, f32 literals as JAX rounds them (1e-3f, 3.0e38f, 1e-12f),
// IEEE sqrt and division, so the twin gives the same bits.
//
// What bounds it: instruction issue, not bytes. A ray reads 24 bytes and
// writes 8 (4 for a shadow ray), but with --fmad=false every multiply and
// add issues alone and an IEEE sqrt or divide is a sequence with a
// slow-path check: ~46 SASS instructions per sphere row and ~72 per quad
// row, ~520 a config-5 ray (2 spheres, 6 quads), which on 132 SMs
// issuing 4 warp instructions a clock takes longer than its bytes at
// 3.35 TB/s. So the design spends issue slots on the tests alone:
// - Rows from the parameter bank. A scene of at most kBankRows real rows
//   (ops/intersect_kernel.py BANK_MAX_ROWS) is passed by value in the
//   kernel's parameters (BankRows, packed on the host) and walked with
//   compile-time indices: the rows are constant-bank operands, with no
//   loads, no address arithmetic, and the winner's global id a constant
//   too (no index_map gather). Larger scenes take the global route, the
//   same walk over rows read through `__ldg`.
// - A t-only launch (j_out null) for shadow rays: no winner is tracked or
//   stored.
// - Off the slow paths of IEEE sqrt and divide, which a whole warp takes
//   when one lane needs them: a sphere miss takes the root of 1 (sqrtf's
//   slow path takes 0; the root only matters where the discriminant is
//   >= 0), and a ray on a quad's plane divides -den (a zero numerator
//   takes the divide's slow path; its t is a miss either way). Same bits.
// - A thread per ray in blocks of 128: the least tail of 128, 256, 512.
// Measured and dropped (PERF.md): 2 and 4 rays a thread, a resident
// grid looping over rays, and a warp vote skipping a quad's planar
// coordinates.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float kTMin = 1e-3f;
constexpr float kMiss = 3.0e38f;
constexpr int kThreads = 128;
constexpr int kBankRows = 48;    // ops/intersect_kernel.py BANK_MAX_ROWS

// The rows of a small scene as the host packs them (intersect_kernel.py
// pack_bank): sphere k (c, r^2), quad k (n, dp | av, ca | bv, cb), and the
// global id of sphere k at gid[k], of quad k at gid[kBankRows + k].
struct BankRows {
  float4 sph[kBankRows];
  float4 quad[kBankRows][3];
  int gid[2 * kBankRows];
};
static_assert(sizeof(BankRows) == 3456, "intersect_kernel.py BANK_BYTES");

// Sphere (c, r^2): the near root, else the far one, in [T_MIN, MISS). The
// root is the TPU kernel's sqrt(max(disc, 0)) wherever it is used (disc
// >= 0); a miss takes sqrtf(1), off sqrtf's slow path for 0.
__device__ __forceinline__ float sphere_t(float4 s, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz) {
  const float ocx = ox - s.x;
  const float ocy = oy - s.y;
  const float ocz = oz - s.z;
  const float half_b = ocx * dx + ocy * dy + ocz * dz;
  const float c_term = ocx * ocx + ocy * ocy + ocz * ocz - s.w;
  const float disc = half_b * half_b - c_term;
  const float sq = sqrtf(disc >= 0.0f ? disc : 1.0f);
  const float t0 = -half_b - sq;
  const float t1 = -half_b + sq;
  const float ts = (t0 >= kTMin && t0 < kMiss)
                       ? t0
                       : ((t1 >= kTMin && t1 < kMiss) ? t1 : kMiss);
  return disc >= 0.0f ? ts : kMiss;
}

// Quad plane (n, dp = n.corner) and planar rows (av, ca), (bv, cb):
// half-open [0, 1) coordinates, t in [T_MIN, MISS). The |n.d| guard comes
// before the clamp, so a grazing ray is no hit. A ray starting on the
// plane (a scattered or shadow ray leaving the quad) has a zero numerator,
// which sends the IEEE divide to its slow path; its t, +-0, is below
// T_MIN, so it divides -den instead: t = -1, the same miss.
__device__ __forceinline__ float quad_t(float4 a, float4 b, float4 c,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  float den = a.x * dx + a.y * dy + a.z * dz;
  const bool ok_den = fabsf(den) >= 1e-12f;
  den = ok_den ? den : 1e-12f;
  const float num = a.w - (a.x * ox + a.y * oy + a.z * oz);
  const float tq = (num != 0.0f ? num : -den) / den;
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

// One ray and its running minimum (and, with kJ, its winner).
template <bool kJ>
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float best;
  int win;

  __device__ __forceinline__ void take(float t, int id) {
    if (t < best) {  // strict: the first row at the minimum keeps the win
      best = t;
      if (kJ) win = id;
    }
  }

  __device__ __forceinline__ void sphere(float4 s, int id) {
    take(sphere_t(s, ox, oy, oz, dx, dy, dz), id);
  }

  __device__ __forceinline__ void quad(float4 a, float4 b, float4 c, int id) {
    take(quad_t(a, b, c, ox, oy, oz, dx, dy, dz), id);
  }
};

// Rows in the parameter bank, walked with compile-time indices: `win` is
// the global id itself. The row counts are uniform, so each row costs one
// uniform compare and branch besides its test.
struct Bank {
  BankRows rows;
  int n_sph, n_quad;

  template <class R>
  __device__ __forceinline__ void walk(R& ray) const {
#pragma unroll
    for (int k = 0; k < kBankRows; ++k) {
      if (k >= n_sph) break;
      ray.sphere(rows.sph[k], rows.gid[k]);
    }
#pragma unroll
    for (int k = 0; k < kBankRows; ++k) {
      if (k >= n_quad) break;
      ray.quad(rows.quad[k][0], rows.quad[k][1], rows.quad[k][2],
               rows.gid[kBankRows + k]);
    }
  }

  __device__ __forceinline__ int global_id(int win) const { return win; }
};

// Rows in device memory (AoS float4s, 16-byte aligned), read through
// `__ldg` by all lanes of a warp together (broadcast loads); `win` is the
// compacted row, mapped through index_map.
struct Global {
  const float4* sph;
  const float4* quad;
  const int* index_map;
  int n_sph, n_quad, q_row0;

  template <class R>
  __device__ __forceinline__ void walk(R& ray) const {
    for (int k = 0; k < n_sph; ++k) ray.sphere(__ldg(sph + k), k);
    for (int k = 0; k < n_quad; ++k) {
      ray.quad(__ldg(quad + 3 * k), __ldg(quad + 3 * k + 1),
               __ldg(quad + 3 * k + 2), q_row0 + k);
    }
  }

  __device__ __forceinline__ int global_id(int win) const {
    return win >= 0 ? __ldg(index_map + win) : -1;
  }
};

// Ray r's origin component c is o[r * o_ray + c * o_comp] (direction
// likewise): an (R, 3) tensor or a view of three (R,) components goes in
// as it is, neighbouring threads reading neighbouring rays.
struct Rays {
  const float* o;
  long long o_ray, o_comp;
  const float* d;
  long long d_ray, d_comp;
};

template <class Rows, bool kJ>
__global__ void __launch_bounds__(kThreads)
    closest_hit_kernel(const Rays rays, const Rows rows,
                       float* __restrict__ t_out, int* __restrict__ j_out,
                       long long n_rays) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  const float* po = rays.o + r * rays.o_ray;
  const float* pd = rays.d + r * rays.d_ray;
  Ray<kJ> ray{__ldg(po),
              __ldg(po + rays.o_comp),
              __ldg(po + 2 * rays.o_comp),
              __ldg(pd),
              __ldg(pd + rays.d_comp),
              __ldg(pd + 2 * rays.d_comp),
              kMiss,
              -1};
  rows.walk(ray);
  t_out[r] = ray.best;
  if (kJ) j_out[r] = rows.global_id(ray.win);
}

template <class Rows>
cudaError_t launch(const Rays& rays, const Rows& rows, float* t_out,
                   int* j_out, long long n_rays, cudaStream_t st) {
  const unsigned blocks = (unsigned)((n_rays + kThreads - 1) / kThreads);
  if (j_out != nullptr) {
    closest_hit_kernel<Rows, true>
        <<<blocks, kThreads, 0, st>>>(rays, rows, t_out, j_out, n_rays);
  } else {
    closest_hit_kernel<Rows, false>
        <<<blocks, kThreads, 0, st>>>(rays, rows, t_out, j_out, n_rays);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Closest hit of n_rays rays on `stream`, a thread per ray in blocks of
// kThreads. Ray r's origin component c is o[r * o_ray + c * o_comp]
// (direction likewise). With `bank` (the BankRows bytes of a scene of at
// most 48 real rows) the rows come from the kernel's parameters; else
// from `sph` (n_sph, 4) and `quad` (n_quad, 12), the real compacted rows,
// 16-byte aligned, quad k being compacted row q_row0 + k, and `index_map`
// sending a compacted row to its global primitive id. Writes t (f32)
// and, unless j_out is null, j (i32, -1 = miss). Returns the launch's
// cudaError_t (0 on success); does not synchronise.
int tinyrt_closest_hit(const float* o, long long o_ray, long long o_comp,
                       const float* d, long long d_ray, long long d_comp,
                       const void* bank, const float* sph, int n_sph,
                       const float* quad, int n_quad, int q_row0,
                       const int* index_map, float* t_out, int* j_out,
                       long long n_rays, void* stream) {
  if (n_rays <= 0) return 0;
  const Rays rays{o, o_ray, o_comp, d, d_ray, d_comp};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bank != nullptr) {
    if (n_sph + n_quad > kBankRows) return (int)cudaErrorInvalidValue;
    Bank rows;
    memcpy(&rows.rows, bank, sizeof(BankRows));
    rows.n_sph = n_sph;
    rows.n_quad = n_quad;
    return (int)launch(rays, rows, t_out, j_out, n_rays, st);
  }
  const Global rows{reinterpret_cast<const float4*>(sph),
                    reinterpret_cast<const float4*>(quad), index_map, n_sph,
                    n_quad, q_row0};
  return (int)launch(rays, rows, t_out, j_out, n_rays, st);
}

}  // extern "C"
