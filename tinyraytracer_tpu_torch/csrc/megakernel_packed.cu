// Packed path-tracing megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel tinyraytracer_tpu/ops/megakernel_packed.py:125
// (`_make_packed_kernel`, with the shading of ops/megakernel.py:206
// `_shade_bounce` and the sample loop of :365 `_regen_sample_loop`): the
// whole forward sampler for scenes of a few dozen primitives, one launch
// per image. Its plain PyTorch twin is `render_packed_reference` in
// ops/megakernel_packed.py.
//
// Design: one thread per pixel, 16x16 pixels per block. Each thread runs
// the sample loop and, inside it, up to max_bounces bounces. Per pixel
// this is the op sequence of a lane of the TPU kernel's regeneration
// loop: sample s takes its camera ray from stream 0 and bounce b from
// stream 1 + b of pcg4d(pid, spp_offset + s, stream, seed); a path that
// died only adds +0.0 there until the lane folds it, so leaving the
// bounce loop at death changes nothing; the budget kills without a
// background add; the accumulator folds samples in order; the mean is a
// multiply by the f32-rounded 1/spp the host passes. The RNG keys off the
// pixel id alone, so the TPU's (S, L) lane tiling is not needed and the
// output is written as (H, W, 3).
//
// The scene table (spheres of 13 floats, then quads of 24: geometry,
// then kind, albedo, fuzz, ior, emission) and the 32-word camera vector
// are copied into shared memory at block start and walked at run time,
// spheres first, then quads, with the strict `<` first minimum of the TPU
// kernel (its tie-break decides the Cornell light/ceiling z-fight). No
// primitive count is compiled in; the table's size sets the dynamic
// shared memory.
//
// What bounds it: FP32 ALU work and warp divergence. Memory traffic is
// negligible: the table and camera once per block, one float3 out per
// pixel. Deliberately simple, for later work: paths of different lengths
// diverge inside a warp (per-warp regeneration or path compaction would
// cut that); the material lobes are computed for every hit and selected,
// as the TPU kernel does, where branching on the winner's kind would
// skip work; the table is read from shared memory per primitive per
// bounce, and no acceleration structure is used.
//
// Where the numbers could drift from the reference, and what is done:
// - Literals: a bare `1.0` is a double and would promote the expression.
//   Every literal is an f32, rounded as JAX rounds Python floats:
//   2*pi -> 6.2831855f, 1/3 -> 0.33333334f, T_MIN -> 1e-3f,
//   MISS -> 3.0e38f, and the 1e-12f, 1e-7f and 1e-30f floors.
// - FMA contraction: nvcc would fuse a*b+c. That moves the quad hit
//   distance by ulps, and the Cornell light lies exactly in the ceiling
//   plane, so ulps decide which quad wins and bias the image. The library
//   is built with --fmad=false (see _build.py).
// - No --use_fast_math: sqrtf and `/` stay IEEE. The TPU kernel's
//   normalisation is rsqrt, approximate on XLA; here it is 1.0f/sqrtf(x),
//   which the twin computes identically.
// - (1-cos)^5 is x2 = x*x; x4 = x2*x2; x4*x, XLA's integer_pow order.
// - A uniform is (float)(int)(bits >> 8) * 2^-24: exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTMin = 1e-3f;
constexpr float kMiss = 3.0e38f;
constexpr float kTwoPi = 6.2831855f;
constexpr float kThird = 0.33333334f;
constexpr float kInv2p24 = 5.9604645e-08f;
constexpr int kCamWords = 32;
constexpr int kSphStride = 13;   // c(3) r2 | material(9)
constexpr int kQuadStride = 24;  // n(3) dp av(3) ca bv(3) cb nhat(3) | material(9)
constexpr int kSphFields = 4;
constexpr int kQuadFields = 15;
constexpr int kBlockX = 16;
constexpr int kBlockY = 16;

__device__ __forceinline__ void pcg4d(uint32_t& x, uint32_t& y, uint32_t& z,
                                      uint32_t& w) {
  x = x * 1664525u + 1013904223u;
  y = y * 1664525u + 1013904223u;
  z = z * 1664525u + 1013904223u;
  w = w * 1664525u + 1013904223u;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
}

__device__ __forceinline__ float to_uniform(uint32_t bits) {
  return (float)(int)(bits >> 8) * kInv2p24;
}

__device__ __forceinline__ void uniform4(uint32_t pid, uint32_t sample,
                                         uint32_t stream, uint32_t seed,
                                         float& u1, float& u2, float& u3,
                                         float& u4) {
  uint32_t x = pid, y = sample, z = stream, w = seed;
  pcg4d(x, y, z, w);
  u1 = to_uniform(x);
  u2 = to_uniform(y);
  u3 = to_uniform(z);
  u4 = to_uniform(w);
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float inv = 1.0f / sqrtf(fmaxf(x * x + y * y + z * z, 1e-30f));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// Winner payload: normal source (quad unit normal, or sphere center) and
// the material block. All zero on a miss, as in the TPU kernel.
struct Payload {
  float isq, ax, ay, az;
  float kind, ar, ag, ab, fuzz, ior, er, eg, eb;
};

__device__ __forceinline__ void closest_hit(const float* tab, int n_sph,
                                            int n_quad, float ox, float oy,
                                            float oz, float dx, float dy,
                                            float dz, float& best,
                                            Payload& w) {
  best = kMiss;
  int win = -1;
  bool win_quad = false;
  for (int k = 0; k < n_sph; ++k) {
    const float* p = tab + k * kSphStride;
    // sphere quadratic, near-then-far root (sphere.rs:29-54)
    const float ocx = ox - p[0];
    const float ocy = oy - p[1];
    const float ocz = oz - p[2];
    const float half_b = ocx * dx + ocy * dy + ocz * dz;
    const float c_term = ocx * ocx + ocy * ocy + ocz * ocz - p[3];
    const float disc = half_b * half_b - c_term;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float t0 = -half_b - sq;
    const float t1 = -half_b + sq;
    float ts = t0 >= kTMin ? t0 : (t1 >= kTMin ? t1 : kMiss);
    ts = disc >= 0.0f ? ts : kMiss;
    if (ts < best) {   // strict: the first minimum keeps the win
      best = ts;
      win = k * kSphStride;
      win_quad = false;
    }
  }
  const float* quads = tab + n_sph * kSphStride;
  for (int j = 0; j < n_quad; ++j) {
    const float* p = quads + j * kQuadStride;
    // plane + planar coordinates, half-open [0, 1) (quad.rs:33-54)
    float den = p[0] * dx + p[1] * dy + p[2] * dz;
    const bool ok_den = fabsf(den) >= 1e-12f;
    den = ok_den ? den : 1e-12f;
    const float tq = (p[3] - (p[0] * ox + p[1] * oy + p[2] * oz)) / den;
    const float al = (p[4] * ox + p[5] * oy + p[6] * oz) +
                     tq * (p[4] * dx + p[5] * dy + p[6] * dz) - p[7];
    const float be = (p[8] * ox + p[9] * oy + p[10] * oz) +
                     tq * (p[8] * dx + p[9] * dy + p[10] * dz) - p[11];
    const bool ok = ok_den && tq >= kTMin && al >= 0.0f && al < 1.0f &&
                    be >= 0.0f && be < 1.0f;
    const float ts = ok ? tq : kMiss;
    if (ts < best) {
      best = ts;
      win = n_sph * kSphStride + j * kQuadStride;
      win_quad = true;
    }
  }
  if (win < 0) {
    w = Payload{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    return;
  }
  const float* p = tab + win;
  const float* m;
  if (win_quad) {
    w.isq = 1.0f;
    w.ax = p[12];
    w.ay = p[13];
    w.az = p[14];
    m = p + kQuadFields;
  } else {
    w.isq = 0.0f;
    w.ax = p[0];
    w.ay = p[1];
    w.az = p[2];
    m = p + kSphFields;
  }
  w.kind = m[0];
  w.ar = m[1];
  w.ag = m[2];
  w.ab = m[3];
  w.fuzz = m[4];
  w.ior = m[5];
  w.er = m[6];
  w.eg = m[7];
  w.eb = m[8];
}

// One bounce's shading (cpu.rs:47-62), op for op as _shade_bounce.
// HAS_MET / HAS_DIE drop a material kind that no valid primitive uses:
// its lobe is only taken through its own winner select, so this is
// value-preserving. SKY lerps a gradient background on the miss y.
template <bool HAS_MET, bool HAS_DIE, bool SKY>
__device__ __forceinline__ void shade_bounce(
    float& ox, float& oy, float& oz, float& dx, float& dy, float& dz,
    float& tr, float& tg, float& tb, float& cr, float& cg, float& cb,
    bool& alive, float best_t, bool hit, const Payload& w, float u1,
    float u2, float u3, float u4, const float* cam) {
  const bool hit_live = alive && hit;
  const bool miss_live = alive && !hit;

  const float t = hit ? best_t : 1.0f;
  const float p_x = ox + t * dx;
  const float p_y = oy + t * dy;
  const float p_z = oz + t * dz;
  // outward normal: quad -> unit plane normal, sphere -> p - c
  const bool quad = w.isq > 0.5f;
  float onx = quad ? w.ax : p_x - w.ax;
  float ony = quad ? w.ay : p_y - w.ay;
  float onz = quad ? w.az : p_z - w.az;
  normalize3(onx, ony, onz);
  // hittable/mod.rs:34-40 face flip
  const bool front = (dx * onx + dy * ony + dz * onz) < 0.0f;
  const float sgn = front ? 1.0f : -1.0f;
  const float nx = onx * sgn;
  const float ny = ony * sgn;
  const float nz = onz * sgn;

  float bg_r = cam[20], bg_g = cam[21], bg_b = cam[22];
  if (SKY) {
    const float tmix = 0.5f * (dy + 1.0f);
    bg_r = bg_r + tmix * (cam[24] - bg_r);
    bg_g = bg_g + tmix * (cam[25] - bg_g);
    bg_b = bg_b + tmix * (cam[26] - bg_b);
  }
  const float mlf = miss_live ? 1.0f : 0.0f;
  const float hlf = hit_live ? 1.0f : 0.0f;
  cr = cr + mlf * tr * bg_r + hlf * tr * w.er;
  cg = cg + mlf * tg * bg_g + hlf * tg * w.eg;
  cb = cb + mlf * tb * bg_b + hlf * tb * w.eb;

  // uniform in unit ball, inverse CDF (vec3extend.rs:15-30)
  const float theta = kTwoPi * u1;
  const float cphi = 1.0f - 2.0f * u2;
  const float sphi = sqrtf(fmaxf(0.0f, 1.0f - cphi * cphi));
  const float rr = expf(logf(fmaxf(u3, 1e-30f)) * kThird);
  const float bx = rr * sphi * cosf(theta);
  const float by = rr * sphi * sinf(theta);
  const float bz = rr * cphi;
  const float bnorm =
      1.0f / sqrtf(fmaxf(bx * bx + by * by + bz * bz, 1e-30f));

  // Lambertian (lambertian.rs:16-22)
  float lx = nx + bx * bnorm;
  float ly = ny + by * bnorm;
  float lz = nz + bz * bnorm;
  if (fabsf(lx) < 1e-7f && fabsf(ly) < 1e-7f && fabsf(lz) < 1e-7f) {
    lx = nx;
    ly = ny;
    lz = nz;
  }
  float sx = lx, sy = ly, sz = lz;

  if (HAS_MET || HAS_DIE) {
    // shared reflection (metal.rs:18-25 / dielectric reflect branch)
    const float ddn = dx * nx + dy * ny + dz * nz;
    const float rx = dx - 2.0f * ddn * nx;
    const float ry = dy - 2.0f * ddn * ny;
    const float rz = dz - 2.0f * ddn * nz;
    float mx = 0.0f, my = 0.0f, mz = 0.0f;
    float gx = 0.0f, gy = 0.0f, gz = 0.0f;
    if (HAS_MET) {
      mx = rx + w.fuzz * bx;
      my = ry + w.fuzz * by;
      mz = rz + w.fuzz * bz;
    }
    if (HAS_DIE) {
      // dielectric (dielectric.rs:26-46)
      const float eta = front ? 1.0f / w.ior : w.ior;
      const float cosv = fminf(-(nx * dx + ny * dy + nz * dz), 1.0f);
      const float sinv = sqrtf(fmaxf(0.0f, 1.0f - cosv * cosv));
      const bool tir = eta * sinv > 1.0f;
      const float sr0 = (1.0f - eta) / (1.0f + eta);
      const float r0 = sr0 * sr0;
      const float x = 1.0f - cosv;
      const float x2 = x * x;
      const float x4 = x2 * x2;
      const float refl = r0 + (1.0f - r0) * (x4 * x);
      const bool choose_reflect = tir || (refl > u4);
      // refract (vec3extend.rs:79-84), 1e-12 floor at grazing incidence
      const float qx = eta * (dx + nx * cosv);
      const float qy = eta * (dy + ny * cosv);
      const float qz = eta * (dz + nz * cosv);
      const float plen2 = qx * qx + qy * qy + qz * qz;
      const float par = -sqrtf(fmaxf(fabsf(1.0f - plen2), 1e-12f));
      gx = choose_reflect ? rx : qx + par * nx;
      gy = choose_reflect ? ry : qy + par * ny;
      gz = choose_reflect ? rz : qz + par * nz;
    }
    const bool is_lam = w.kind < 0.5f;
    if (HAS_MET && HAS_DIE) {
      const bool is_met = w.kind >= 0.5f && w.kind < 1.5f;
      sx = is_lam ? lx : (is_met ? mx : gx);
      sy = is_lam ? ly : (is_met ? my : gy);
      sz = is_lam ? lz : (is_met ? mz : gz);
    } else if (HAS_MET) {
      sx = is_lam ? lx : mx;
      sy = is_lam ? ly : my;
      sz = is_lam ? lz : mz;
    } else {
      sx = is_lam ? lx : gx;
      sy = is_lam ? ly : gy;
      sz = is_lam ? lz : gz;
    }
  }
  normalize3(sx, sy, sz);

  const bool absorbed = w.kind >= 2.5f;  // LIGHT = 3
  const bool scat = hit_live && !absorbed;
  const float sf = scat ? 1.0f : 0.0f;
  const float inv_sf = 1.0f - sf;
  tr = tr * (inv_sf + sf * w.ar);
  tg = tg * (inv_sf + sf * w.ag);
  tb = tb * (inv_sf + sf * w.ab);
  if (scat) {
    ox = p_x;
    oy = p_y;
    oz = p_z;
    dx = sx;
    dy = sy;
    dz = sz;
  }
  alive = scat;
}

template <bool HAS_MET, bool HAS_DIE, bool SKY>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    packed_kernel(const float* __restrict__ cam_g,
                  const float* __restrict__ tab_g, int nw, int n_sph,
                  int n_quad, float* __restrict__ out, int width, int height,
                  uint32_t seed, uint32_t spp_offset, int spp,
                  int max_bounces, float inv_spp) {
  extern __shared__ float smem[];  // camera vector, then the scene table
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < kCamWords + nw; i += blockDim.x * blockDim.y) {
    smem[i] = i < kCamWords ? cam_g[i] : tab_g[i - kCamWords];
  }
  __syncthreads();
  const float* cam = smem;
  const float* tab = smem + kCamWords;

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  const uint32_t pid = (uint32_t)y * (uint32_t)width + (uint32_t)x;
  const float px = (float)x;
  const float py = (float)y;

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < spp; ++s) {
    const uint32_t samp = spp_offset + (uint32_t)s;
    // jittered thin-lens camera ray, stream 0
    float r1, r2, r3, r4;
    uniform4(pid, samp, 0u, seed, r1, r2, r3, r4);
    const float u = (px + r1) * cam[18];  // pointgen.rs:41-42
    const float v = (py + r2) * cam[19];
    const float rad = sqrtf(r3);  // defocus disk, polar form
    const float th = kTwoPi * r4;
    const float cth = cosf(th);
    const float sth = sinf(th);
    float ox = cam[0] + rad * cth * cam[12] + rad * sth * cam[15];
    float oy = cam[1] + rad * cth * cam[13] + rad * sth * cam[16];
    float oz = cam[2] + rad * cth * cam[14] + rad * sth * cam[17];
    float dx = cam[3] + u * cam[6] - v * cam[9] - ox;
    float dy = cam[4] + u * cam[7] - v * cam[10] - oy;
    float dz = cam[5] + u * cam[8] - v * cam[11] - oz;
    normalize3(dx, dy, dz);  // ray.rs:13

    float tr = 1.0f, tg = 1.0f, tb = 1.0f;
    float cr = 0.0f, cg = 0.0f, cb = 0.0f;
    bool alive = true;
    for (int b = 0; b < max_bounces && alive; ++b) {
      float best;
      Payload w;
      closest_hit(tab, n_sph, n_quad, ox, oy, oz, dx, dy, dz, best, w);
      float u1, u2, u3, u4;  // scatter randomness: stream 1 + bounce
      uniform4(pid, samp, 1u + (uint32_t)b, seed, u1, u2, u3, u4);
      shade_bounce<HAS_MET, HAS_DIE, SKY>(ox, oy, oz, dx, dy, dz, tr, tg, tb,
                                          cr, cg, cb, alive, best,
                                          best < kMiss, w, u1, u2, u3, u4,
                                          cam);
    }
    acc_r = acc_r + cr;
    acc_g = acc_g + cg;
    acc_b = acc_b + cb;
  }
  float* o = out + 3 * (size_t)pid;
  o[0] = acc_r * inv_spp;
  o[1] = acc_g * inv_spp;
  o[2] = acc_b * inv_spp;
}

template <bool HAS_MET, bool HAS_DIE, bool SKY>
cudaError_t launch(const float* cam, const float* tab, int nw, int n_sph,
                   int n_quad, float* out, int width, int height,
                   uint32_t seed, uint32_t spp_offset, int spp,
                   int max_bounces, float inv_spp, cudaStream_t stream) {
  auto kernel = packed_kernel<HAS_MET, HAS_DIE, SKY>;
  const size_t smem = sizeof(float) * (size_t)(kCamWords + nw);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY);
  kernel<<<grid, block, smem, stream>>>(cam, tab, nw, n_sph, n_quad, out,
                                        width, height, seed, spp_offset, spp,
                                        max_bounces, inv_spp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Renders (height, width, 3) f32 mean radiance into `out` on `stream`.
// Returns the launch's cudaError_t (0 on success); does not synchronise.
int tinyrt_megakernel_packed(const float* cam, const float* tab, int nw,
                             int n_sph, int n_quad, float* out, int width,
                             int height, unsigned int seed,
                             unsigned int spp_offset, int spp,
                             int max_bounces, float inv_spp, int has_met,
                             int has_die, int sky, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int key = (has_met ? 4 : 0) | (has_die ? 2 : 0) | (sky ? 1 : 0);
#define TINYRT_CASE(K, M, D, S)                                          \
  case K:                                                                \
    return (int)launch<M, D, S>(cam, tab, nw, n_sph, n_quad, out, width, \
                                height, seed, spp_offset, spp,           \
                                max_bounces, inv_spp, st);
  switch (key) {
    TINYRT_CASE(0, false, false, false)
    TINYRT_CASE(1, false, false, true)
    TINYRT_CASE(2, false, true, false)
    TINYRT_CASE(3, false, true, true)
    TINYRT_CASE(4, true, false, false)
    TINYRT_CASE(5, true, false, true)
    TINYRT_CASE(6, true, true, false)
    default:
      TINYRT_CASE(7, true, true, true)
  }
#undef TINYRT_CASE
}

const char* tinyrt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
