// Device code shared by the forward megakernels: megakernel_packed.cu (K1,
// the packed scene table) and megakernel.cu (K2, the classic row layout).
// Both compile the same pcg4d RNG, hit tests, shading, camera ray and
// per-pixel sampler from here, so a pixel runs the same operations in the
// same order whichever kernel renders it. The plain PyTorch twins of this
// code are ops/megakernel.py (`shade_bounce`, `dense_closest_hit`,
// `lockstep_render`) and ops/rng.py.
//
// The sampler (`render_pixel`) is the TPU kernels' per-lane regeneration
// loop (tinyraytracer_tpu/ops/megakernel.py:365, `_regen_sample_loop`)
// written per thread: one loop whose every pass runs one bounce of the
// thread's current sample. When the path dies or spends max_bounces, the
// thread folds the sample's colour and, on the next pass, takes the camera
// ray of its next sample. A warp therefore runs as many passes as its
// busiest thread has bounces over all its samples, where a per-sample
// loop with a bounce loop inside would run every sample until the warp's
// longest path of that sample ends. Only the threads that start a sample
// diverge, around the camera ray; the closest hit and the shading run
// with the warp converged. The per-pixel op sequence is that of the
// lockstep twin: sample s takes its camera ray from stream 0 and bounce b
// (counted within the sample) from stream 1 + b of pcg4d(pid,
// spp_offset + s, stream, seed); the budget kills without a background
// add; samples fold in order into an accumulator from +0.0; the mean is a
// multiply by the f32-rounded 1/spp the host passes. The RNG keys off the
// pixel id alone, so any mapping of pixels and samples to threads gives
// the same image.
//
// Where the numbers could drift from the reference, and what is done:
// - Literals: a bare `1.0` is a double and would promote the expression.
//   Every literal is an f32, rounded as JAX rounds Python floats:
//   2*pi -> 6.2831855f, 1/3 -> 0.33333334f, T_MIN -> 1e-3f,
//   MISS -> 3.0e38f, and the 1e-12f, 1e-7f, 1e-24f and 1e-30f floors.
// - FMA contraction: nvcc would fuse a*b+c. That moves the quad hit
//   distance by ulps, and the Cornell light lies exactly in the ceiling
//   plane, so ulps decide which quad wins and bias the image. The library
//   is built with --fmad=false (see _build.py).
// - No --use_fast_math: sqrtf and `/` stay IEEE. The TPU kernels'
//   normalisation is rsqrt, approximate on XLA; here it is 1.0f/sqrtf(x),
//   which the twin computes identically.
// - (1-cos)^5 is x2 = x*x; x4 = x2*x2; x4*x, XLA's integer_pow order.
// - A uniform is (float)(int)(bits >> 8) * 2^-24: exact.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace tinyrt {

constexpr float kTMin = 1e-3f;
constexpr float kMiss = 3.0e38f;
constexpr float kTwoPi = 6.2831855f;
constexpr float kThird = 0.33333334f;
constexpr float kInv2p24 = 5.9604645e-08f;
constexpr int kCamWords = 32;
// Forward blocks of 16x8 threads, one pixel each: a warp covers a 16x2
// tile, so its camera rays stay coherent. On the H100, 128-thread blocks
// were as fast as or faster than 256 (16x16) and 64 (8x8) at every
// config (PERF.md, the launch-shape sweep): a block holds its SM slot
// until its slowest warp ends, and smaller blocks free slots sooner.
constexpr int kBlockX = 16;
constexpr int kBlockY = 8;
// A grid of fewer blocks than the card holds at once (one wave) spreads
// each pixel's samples over enough threads for this many waves.
constexpr int kSplitWaves = 4;

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
// the material block. All zero on a miss.
struct Payload {
  float isq, ax, ay, az;
  float kind, ar, ag, ab, fuzz, ior, er, eg, eb;
};

__device__ __forceinline__ Payload miss_payload() {
  return Payload{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
}

// Sphere (center c, radius^2 r2) hit distance: the near root, else the
// far one, at t >= T_MIN; MISS when neither (sphere.rs:29-54).
__device__ __forceinline__ float sphere_hit_t(float cx, float cy, float cz,
                                              float r2, float ox, float oy,
                                              float oz, float dx, float dy,
                                              float dz) {
  const float ocx = ox - cx;
  const float ocy = oy - cy;
  const float ocz = oz - cz;
  const float half_b = ocx * dx + ocy * dy + ocz * dz;
  const float c_term = ocx * ocx + ocy * ocy + ocz * ocz - r2;
  const float disc = half_b * half_b - c_term;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t0 = -half_b - sq;
  const float t1 = -half_b + sq;
  const float ts = t0 >= kTMin ? t0 : (t1 >= kTMin ? t1 : kMiss);
  return disc >= 0.0f ? ts : kMiss;
}

// Quad hit distance from its plane (normal n, dp = n.corner) and planar
// coordinate rows (av, ca), (bv, cb), half-open [0, 1) bounds; MISS when
// none (quad.rs:33-54). A zero normal (pad row) fails the den guard.
__device__ __forceinline__ float quad_hit_t(float nx, float ny, float nz,
                                            float dp, float avx, float avy,
                                            float avz, float ca, float bvx,
                                            float bvy, float bvz, float cb,
                                            float ox, float oy, float oz,
                                            float dx, float dy, float dz) {
  float den = nx * dx + ny * dy + nz * dz;
  const bool ok_den = fabsf(den) >= 1e-12f;
  den = ok_den ? den : 1e-12f;
  const float tq = (dp - (nx * ox + ny * oy + nz * oz)) / den;
  const float al = (avx * ox + avy * oy + avz * oz) +
                   tq * (avx * dx + avy * dy + avz * dz) - ca;
  const float be = (bvx * ox + bvy * oy + bvz * oz) +
                   tq * (bvx * dx + bvy * dy + bvz * dz) - cb;
  const bool ok = ok_den && tq >= kTMin && al >= 0.0f && al < 1.0f &&
                  be >= 0.0f && be < 1.0f;
  return ok ? tq : kMiss;
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

// Jittered thin-lens camera ray for pixel (px, py), stream 0
// (pointgen.rs:38-51, camera.rs:58-66, ray.rs:13).
__device__ __forceinline__ void camera_ray(const float* cam, float px,
                                           float py, uint32_t pid,
                                           uint32_t samp, uint32_t seed,
                                           float& ox, float& oy, float& oz,
                                           float& dx, float& dy, float& dz) {
  float r1, r2, r3, r4;
  uniform4(pid, samp, 0u, seed, r1, r2, r3, r4);
  const float u = (px + r1) * cam[18];  // pointgen.rs:41-42
  const float v = (py + r2) * cam[19];
  const float rad = sqrtf(r3);  // defocus disk, polar form
  const float th = kTwoPi * r4;
  const float cth = cosf(th);
  const float sth = sinf(th);
  ox = cam[0] + rad * cth * cam[12] + rad * sth * cam[15];
  oy = cam[1] + rad * cth * cam[13] + rad * sth * cam[16];
  oz = cam[2] + rad * cth * cam[14] + rad * sth * cam[17];
  dx = cam[3] + u * cam[6] - v * cam[9] - ox;
  dy = cam[4] + u * cam[7] - v * cam[10] - oy;
  dz = cam[5] + u * cam[8] - v * cam[11] - oz;
  normalize3(dx, dy, dz);
}

// What a forward launch renders: samples [spp_offset, +spp) of a
// (height, width) image. With split == 1 each thread folds all samples of
// its pixel and writes the mean to out[3 * pid .. +3). With split > 1 the
// samples of a pixel are cut into `split` contiguous parts, one thread
// each (blockIdx.z is the part), and each thread writes every sample's
// colour to samples[(s * width * height + pid) * 3 .. +3), which
// fold_kernel (megakernel.cu) adds up in sample order.
struct Frame {
  float* out;
  float* samples;
  int width, height;
  uint32_t seed, spp_offset;
  int spp, max_bounces, split;
  float inv_spp;
};

// Renders part `part` of pixel (x, y)'s samples (see Frame), one bounce
// per pass of a single loop. Every thread of the warp calls it, those
// outside the image too (they run no pass): the loop's one back edge is
// a vote of the whole warp. With the exit test on the thread's own
// counters instead, the compiler threads the not-yet-ended path straight
// back to the loop head, which makes a bounce loop inside a sample loop
// again, with the warp reconverging at the end of every sample.
// `scene.closest_hit(ox, oy, oz, dx, dy, dz, best, w)` is the kernel's
// own search: the strict-`<` first minimum over spheres, then quads, and
// the winner's payload (zero on a miss).
template <bool HAS_MET, bool HAS_DIE, bool SKY, class Scene>
__device__ __forceinline__ void render_pixel(const float* cam,
                                             const Scene& scene,
                                             const Frame& f, int x, int y,
                                             int part) {
  const bool in_image = x < f.width && y < f.height;
  const uint32_t pid = (uint32_t)y * (uint32_t)f.width + (uint32_t)x;
  const int s_end = (int)((long long)f.spp * (part + 1) / f.split);
  int s = (int)((long long)f.spp * part / f.split);
  bool active = in_image && s < s_end;  // more parts than samples: none
  const float px = (float)x;
  const float py = (float)y;
  const size_t npix = (size_t)f.width * (size_t)f.height;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float tr = 1.0f, tg = 1.0f, tb = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  bool alive = true;
  int b = 0;  // bounce within the current sample
  while (__any_sync(0xffffffffu, active)) {
    if (active) {
      const uint32_t samp = f.spp_offset + (uint32_t)s;
      if (b == 0) {  // a new sample: its camera ray, stream 0
        camera_ray(cam, px, py, pid, samp, f.seed, ox, oy, oz, dx, dy, dz);
        tr = tg = tb = 1.0f;
        cr = cg = cb = 0.0f;
        alive = true;
      }
      float best;
      Payload w;
      scene.closest_hit(ox, oy, oz, dx, dy, dz, best, w);
      float u1, u2, u3, u4;  // scatter randomness: stream 1 + bounce
      uniform4(pid, samp, 1u + (uint32_t)b, f.seed, u1, u2, u3, u4);
      shade_bounce<HAS_MET, HAS_DIE, SKY>(ox, oy, oz, dx, dy, dz, tr, tg,
                                          tb, cr, cg, cb, alive, best,
                                          best < kMiss, w, u1, u2, u3, u4,
                                          cam);
      ++b;
      // the sample ends when the path died or spent the budget (which
      // kills it without a background add)
      if (!alive || b == f.max_bounces) {
        if (f.split > 1) {
          float* c = f.samples + ((size_t)s * npix + pid) * 3;
          c[0] = cr;
          c[1] = cg;
          c[2] = cb;
        } else {
          acc_r = acc_r + cr;
          acc_g = acc_g + cg;
          acc_b = acc_b + cb;
        }
        b = 0;
        active = ++s < s_end;
      }
    }
  }
  if (in_image && f.split == 1) {
    float* o = f.out + 3 * (size_t)pid;
    o[0] = acc_r * f.inv_spp;
    o[1] = acc_g * f.inv_spp;
    o[2] = acc_b * f.inv_spp;
  }
}

// The grid of a forward launch: the image in blocks, times the parts.
inline dim3 forward_grid(const Frame& f) {
  return dim3((f.width + kBlockX - 1) / kBlockX,
              (f.height + kBlockY - 1) / kBlockY, f.split);
}

// Sample parts per pixel (Frame::split) for a (height, width) image of
// spp samples rendered by `kernel` with `smem` bytes of dynamic shared
// memory: 1 when the grid fills one wave of the card, else enough parts
// for kSplitWaves waves, at most spp. Under one wave the slowest pixels
// set the kernel's time; their samples then run side by side.
template <class Kernel>
cudaError_t sample_split(Kernel kernel, size_t smem, int width, int height,
                         int spp, int& split) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kBlockX * kBlockY, smem);
  }
  if (e != cudaSuccess) return e;
  const long long wave = (long long)per_sm * sms;
  const long long blocks = (long long)((width + kBlockX - 1) / kBlockX) *
                           ((height + kBlockY - 1) / kBlockY);
  split = blocks >= wave
              ? 1
              : (int)std::min<long long>(
                    spp, (kSplitWaves * wave + blocks - 1) / blocks);
  return cudaSuccess;
}

// Calls launcher.template run<HAS_MET, HAS_DIE, SKY>() for the runtime
// flags: each combination is its own kernel, with the absent lobes and
// the sky lerp compiled out.
template <class Launcher>
cudaError_t dispatch_kinds(bool has_met, bool has_die, bool sky,
                           const Launcher& launcher) {
  const int key = (has_met ? 4 : 0) | (has_die ? 2 : 0) | (sky ? 1 : 0);
  switch (key) {
    case 0: return launcher.template run<false, false, false>();
    case 1: return launcher.template run<false, false, true>();
    case 2: return launcher.template run<false, true, false>();
    case 3: return launcher.template run<false, true, true>();
    case 4: return launcher.template run<true, false, false>();
    case 5: return launcher.template run<true, false, true>();
    case 6: return launcher.template run<true, true, false>();
    default: return launcher.template run<true, true, true>();
  }
}

}  // namespace tinyrt
