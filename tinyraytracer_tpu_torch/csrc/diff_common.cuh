// Device code shared by the fused differentiable kernels: K5
// (diffkernel_packed.cu, the flat table in shared memory, class-level
// surrogate scopes, a per-thread accumulator in shared or local memory)
// and K4
// (diffkernel.cu, the flat table in global memory, a row list per
// surrogate class, a per-thread column of a global accumulator). Both run
// the same estimator, function by function in the order of their plain
// PyTorch twin `packed_diff_reference` (ops/diffkernel_packed.py), which
// names each step after the TPU kernels' functions: shade, advance,
// color_adds, shadow_vis, softshadow, quad_cov, silhouette, bounce_adj.
//
// What differs between the kernels is a template argument or a pointer:
//   Scope - which table rows carry surrogates: ClassScope (K5: rows
//     0..n-1 of a class, or none) or RowScope (K4: a device list of rows
//     per class: all, none or a subset);
//   StridedAcc - where a thread's gradient terms go (shared, local or
//     global memory, see there);
//   the table pointer in Args: shared (K5) or global (K4) memory.
// The estimator's switches (Flags: NEE, silhouette, metal, dielectric)
// are template arguments too, so each combination compiles what it runs.
//
// Each kernel renders the NEE image first in an image kernel (image_thread:
// a thread per pixel and sample part, at the registers phase 1 needs),
// then runs on a grid that the card holds at once, each thread looping
// over pixels with the replay and the adjoint in per-lane regeneration
// loops (diff_thread), a chunk of its replay saved in its own slots.
//
// Numerics as common.cuh: built with --fmad=false, 1.0f/sqrtf for the
// TPU's rsqrt, x2*x2*x for the fifth power, literals rounded as JAX rounds
// them (1/pi -> 0.31830987f, 16 pi -> 50.265484f, 1 - 1e-3 -> 0.999f);
// sigmoid is 1/(1+expf(-x)) here and in the twin.

#pragma once

#include "common.cuh"

namespace tinyrt {
namespace diff {

constexpr int kSphF = 15;   // cx cy cz r2 r | kind alb(3) fuzz ior emit(3) mat
constexpr int kQuadF = 31;  // n dp av ca bv cb | qc qu qv | material block
constexpr int kMatOffS = 5;
constexpr int kGeoOffQ = 12;
constexpr int kMatOffQ = 21;
constexpr int kLightF = 12;  // corner(3) u(3) v(3) emit(3)
constexpr float kInvPi = 0.31830987f;
constexpr float kGeomMax = 50.265484f;
constexpr float kShadowScale = 0.999f;
constexpr float kInvWqe = 20.0f;
constexpr float kFar = 3.0e30f;
constexpr uint32_t kNeeStream = 0x40000000u;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ void cross3(float ax, float ay, float az,
                                       float bx, float by, float bz,
                                       float& cx, float& cy, float& cz) {
  cx = ay * bz - az * by;
  cy = az * bx - ax * bz;
  cz = ax * by - ay * bx;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// jnp.sign / torch.sign
__device__ __forceinline__ float sgnf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

__device__ __forceinline__ float b2f(bool b) { return b ? 1.0f : 0.0f; }

struct Args {
  const float* cam;  // shared memory
  const float* tab;  // the flat table: shared (K5) or global (K4) memory
  int n_sph, n_quad, n_lights, nm, light_quad, light_off;
  uint32_t seed;
  // accumulator offsets
  int a_q, a_m, a_l, a_b, a_loss;
};

// Fills the table layout and the accumulator offsets [sphere 4 | quad 9 |
// material 8 | light 12 per row | background 3 | loss 1]; returns the
// accumulator width.
inline int set_layout(Args& a, int n_sph, int n_quad, int n_lights, int nm,
                      int light_quad) {
  a.n_sph = n_sph;
  a.n_quad = n_quad;
  a.n_lights = n_lights;
  a.nm = nm;
  a.light_quad = light_quad;
  a.light_off = n_sph * kSphF + n_quad * kQuadF;
  a.a_q = 4 * n_sph;
  a.a_m = a.a_q + 9 * n_quad;
  a.a_l = a.a_m + 8 * nm;
  a.a_b = a.a_l + kLightF * n_lights;
  a.a_loss = a.a_b + 3;
  return a.a_loss + 1;
}

// Surrogate scope of K5: the first n_s spheres and n_q quads (a class is
// all of its rows or none).
struct ClassScope {
  int n_s, n_q;
  __device__ __forceinline__ int sph(int k) const { return k; }
  __device__ __forceinline__ int quad(int k) const { return k; }
};

// Surrogate scope of K4: one device list of table rows per class, so one
// code path serves dense (every row), off (none) and a subset.
struct RowScope {
  const int* s;
  const int* q;
  int n_s, n_q;
  __device__ __forceinline__ int sph(int k) const { return __ldg(s + k); }
  __device__ __forceinline__ int quad(int k) const { return __ldg(q + k); }
};

// A thread's gradient accumulator: entry j at p[j * stride]. K5 points
// it at the thread's column of a [na][128] block of shared memory (stride
// 128) or, when na does not fit there, at a local array (stride 1); K4 at
// the thread's column of a global [na][threads] scratch (stride threads),
// where a warp's adds coalesce. Zero terms are skipped, which changes no
// bit: a sum that starts at +0 never becomes -0, and x + (+-0) == x
// otherwise. Most dense-scope surrogate terms are exact zeros (the sigmoid
// saturates a few radii from a sphere), and each skipped add saves a read
// and a write.
struct StridedAcc {
  float* p;
  size_t stride;
  __device__ __forceinline__ void add(int j, float v) const {
    if (v != 0.0f) p[(size_t)j * stride] += v;
  }
};

// Ray state entering a bounce (the TPU kernel's 11 state rows).
struct State {
  float ox, oy, oz, dx, dy, dz, tr, tg, tb, alive, pd;
};

// Winner fields, all zero on a miss.
struct Winner {
  float isq, cx, cy, cz, rad, kind, ar, ag, ab, fuzz, ior, er, eg, eb, mat;
  float qcx, qcy, qcz, qux, quy, quz, qvx, qvy, qvz;
};

// Closest hit over spheres then quads, strict `<` first minimum; the
// winner's index (sphere i, or n_sph + quad j), -1 on a miss.
__device__ __forceinline__ float closest_hit(const Args& a, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, int& win) {
  float best = kMiss;
  win = -1;
  for (int i = 0; i < a.n_sph; ++i) {
    const float* p = a.tab + i * kSphF;
    const float ts =
        sphere_hit_t(p[0], p[1], p[2], p[3], ox, oy, oz, dx, dy, dz);
    if (ts < best) {
      best = ts;
      win = i;
    }
  }
  const float* quads = a.tab + a.n_sph * kSphF;
  for (int j = 0; j < a.n_quad; ++j) {
    const float* p = quads + j * kQuadF;
    const float ts = quad_hit_t(p[0], p[1], p[2], p[3], p[4], p[5], p[6],
                                p[7], p[8], p[9], p[10], p[11], ox, oy, oz,
                                dx, dy, dz);
    if (ts < best) {
      best = ts;
      win = a.n_sph + j;
    }
  }
  return best;
}

__device__ __forceinline__ Winner winner_fields(const Args& a, int win) {
  Winner w;
  w.isq = w.cx = w.cy = w.cz = w.rad = 0.0f;
  w.qcx = w.qcy = w.qcz = w.qux = w.quy = w.quz = w.qvx = w.qvy = w.qvz =
      0.0f;
  w.kind = w.ar = w.ag = w.ab = w.fuzz = w.ior = w.er = w.eg = w.eb =
      w.mat = 0.0f;
  if (win < 0) return w;
  const float* m;
  if (win < a.n_sph) {
    const float* p = a.tab + win * kSphF;
    w.cx = p[0];
    w.cy = p[1];
    w.cz = p[2];
    w.rad = p[4];
    m = p + kMatOffS;
  } else {
    const float* p = a.tab + a.n_sph * kSphF + (win - a.n_sph) * kQuadF;
    w.isq = 1.0f;
    const float* q = p + kGeoOffQ;
    w.qcx = q[0];
    w.qcy = q[1];
    w.qcz = q[2];
    w.qux = q[3];
    w.quy = q[4];
    w.quz = q[5];
    w.qvx = q[6];
    w.qvy = q[7];
    w.qvz = q[8];
    m = p + kMatOffQ;
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
  w.mat = m[9];
  return w;
}

// Every per-bounce intermediate the color, the state update and the
// adjoint read (the TPU kernel's `shade` dict).
struct Shade {
  bool hit, quad_w, is_lam, is_met, is_die, use0, front, cos_clip, cref;
  float hlf, mlf, gate_e, scf;
  float ocx, ocy, ocz, hb, sq_safe, wnx, wny, wnz, dden, t_quad, t;
  float p_x, p_y, p_z, rho, sx_o, sy_o, sz_o, qlen, qx_o, qy_o, qz_o;
  float sgn, nx, ny, nz;
  // NEE
  bool nee_on;
  int kpick;
  float nu1, nu2, lux, luy, luz, lvx, lvy, lvz, ler, leg, leb;
  float tlx, tly, tlz, r2l, r2g, dist, idist, wlx, wly, wlz;
  float lnx, lny, lnz, area, ainv, lnux, lnuy, lnuz;
  float cosx, cy_raw, cosy, graw, geom, activef;
  // scatter
  float bx, by, bz, invl, sdx, sdy, sdz, sdn;
  float eta, cosv, ppx, ppy, ppz, zk, kk, par;
};

template <class F>
__device__ __forceinline__ void shade(const Args& a, uint32_t pid,
                                      uint32_t samp, int b, const State& s,
                                      float best_t, const Winner& w,
                                      Shade& g) {
  g.hit = best_t < kMiss;
  const bool alive = s.alive > 0.5f;
  const bool hit_live = alive && g.hit;
  const bool miss_live = alive && !g.hit;
  g.hlf = b2f(hit_live);
  g.mlf = b2f(miss_live);

  g.ocx = s.ox - w.cx;
  g.ocy = s.oy - w.cy;
  g.ocz = s.oz - w.cz;
  g.hb = dot3(g.ocx, g.ocy, g.ocz, s.dx, s.dy, s.dz);
  const float cterm = dot3(g.ocx, g.ocy, g.ocz, g.ocx, g.ocy, g.ocz) -
                      w.rad * w.rad;
  const float disc = g.hb * g.hb - cterm;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  g.sq_safe = fmaxf(sq, 1e-8f);
  const float t0 = -g.hb - sq;
  const float t1 = -g.hb + sq;
  g.use0 = t0 >= kTMin;
  const float t_sph = g.use0 ? t0 : t1;
  cross3(w.qux, w.quy, w.quz, w.qvx, w.qvy, w.qvz, g.wnx, g.wny, g.wnz);
  float dden = dot3(g.wnx, g.wny, g.wnz, s.dx, s.dy, s.dz);
  g.dden = fabsf(dden) < 1e-12f ? 1e-12f : dden;
  const float num = dot3(g.wnx, g.wny, g.wnz, w.qcx - s.ox, w.qcy - s.oy,
                         w.qcz - s.oz);
  g.t_quad = num / g.dden;
  g.quad_w = w.isq > 0.5f;
  const float t_diff = g.quad_w ? g.t_quad : t_sph;
  g.t = g.hit ? t_diff : 1.0f;
  g.p_x = s.ox + g.t * s.dx;
  g.p_y = s.oy + g.t * s.dy;
  g.p_z = s.oz + g.t * s.dz;
  const float mx = g.p_x - w.cx;
  const float my = g.p_y - w.cy;
  const float mz = g.p_z - w.cz;
  g.rho = sqrtf(fmaxf(dot3(mx, my, mz, mx, my, mz), 1e-24f));
  g.sx_o = mx / g.rho;
  g.sy_o = my / g.rho;
  g.sz_o = mz / g.rho;
  g.qlen = sqrtf(fmaxf(dot3(g.wnx, g.wny, g.wnz, g.wnx, g.wny, g.wnz),
                       1e-24f));
  g.qx_o = g.wnx / g.qlen;
  g.qy_o = g.wny / g.qlen;
  g.qz_o = g.wnz / g.qlen;
  const float n_ox = g.quad_w ? g.qx_o : g.sx_o;
  const float n_oy = g.quad_w ? g.qy_o : g.sy_o;
  const float n_oz = g.quad_w ? g.qz_o : g.sz_o;
  g.front = dot3(s.dx, s.dy, s.dz, n_ox, n_oy, n_oz) < 0.0f;
  g.sgn = g.front ? 1.0f : -1.0f;
  g.nx = n_ox * g.sgn;
  g.ny = n_oy * g.sgn;
  g.nz = n_oz * g.sgn;

  g.is_lam = w.kind < 0.5f;
  g.is_met = w.kind >= 0.5f && w.kind < 1.5f;
  g.is_die = w.kind >= 1.5f && w.kind < 2.5f;
  const bool is_light = w.kind >= 2.5f;
  if (F::nee) {
    const bool nee_sampled = g.quad_w && is_light;
    g.gate_e = g.hlf * (1.0f - s.pd * b2f(nee_sampled));
  } else {
    g.gate_e = g.hlf;
  }

  g.nee_on = F::nee && a.n_lights > 0;
  if (g.nee_on) {
    float nu3, nu4;
    uniform4(pid, samp, kNeeStream + (uint32_t)b, a.seed, g.nu1, g.nu2, nu3,
             nu4);
    int k = (int)(nu3 * (float)a.n_lights);
    k = k < 0 ? 0 : (k > a.n_lights - 1 ? a.n_lights - 1 : k);
    g.kpick = k;
    const float* l = a.tab + a.light_off + k * kLightF;
    const float lcx = l[0], lcy = l[1], lcz = l[2];
    g.lux = l[3];
    g.luy = l[4];
    g.luz = l[5];
    g.lvx = l[6];
    g.lvy = l[7];
    g.lvz = l[8];
    g.ler = l[9];
    g.leg = l[10];
    g.leb = l[11];
    const float yx = lcx + g.nu1 * g.lux + g.nu2 * g.lvx;
    const float yy = lcy + g.nu1 * g.luy + g.nu2 * g.lvy;
    const float yz = lcz + g.nu1 * g.luz + g.nu2 * g.lvz;
    g.tlx = yx - g.p_x;
    g.tly = yy - g.p_y;
    g.tlz = yz - g.p_z;
    g.r2l = dot3(g.tlx, g.tly, g.tlz, g.tlx, g.tly, g.tlz);
    g.r2g = fmaxf(g.r2l, 1e-12f);
    g.dist = sqrtf(g.r2g);
    g.idist = 1.0f / g.dist;
    g.wlx = g.tlx * g.idist;
    g.wly = g.tly * g.idist;
    g.wlz = g.tlz * g.idist;
    cross3(g.lux, g.luy, g.luz, g.lvx, g.lvy, g.lvz, g.lnx, g.lny, g.lnz);
    g.area = sqrtf(fmaxf(dot3(g.lnx, g.lny, g.lnz, g.lnx, g.lny, g.lnz),
                         1e-24f));
    g.ainv = 1.0f / g.area;
    g.lnux = g.lnx * g.ainv;
    g.lnuy = g.lny * g.ainv;
    g.lnuz = g.lnz * g.ainv;
    g.cosx = dot3(g.nx, g.ny, g.nz, g.wlx, g.wly, g.wlz);
    g.cy_raw = dot3(g.lnux, g.lnuy, g.lnuz, g.wlx, g.wly, g.wlz);
    g.cosy = fabsf(g.cy_raw);
    g.graw = g.cosx * g.cosy * g.area * (float)a.n_lights / g.r2g;
    g.geom = fminf(g.graw, kGeomMax);
    g.activef = b2f(hit_live && g.is_lam && g.cosx > 0.0f);
  }

  float su1, su2, su3, su4;
  uniform4(pid, samp, 1u + (uint32_t)b, a.seed, su1, su2, su3, su4);
  const float theta = kTwoPi * su1;
  const float cphi = 1.0f - 2.0f * su2;
  const float sphi = sqrtf(fmaxf(1.0f - cphi * cphi, 0.0f));
  const float rr = expf(logf(fmaxf(su3, 1e-30f)) * kThird);
  g.bx = rr * sphi * cosf(theta);
  g.by = rr * sphi * sinf(theta);
  g.bz = rr * cphi;
  const float bnorm =
      1.0f / sqrtf(fmaxf(g.bx * g.bx + g.by * g.by + g.bz * g.bz, 1e-24f));
  const float lx = g.nx + g.bx * bnorm;
  const float ly = g.ny + g.by * bnorm;
  const float lz = g.nz + g.bz * bnorm;
  const bool degen =
      fabsf(lx) < 1e-7f && fabsf(ly) < 1e-7f && fabsf(lz) < 1e-7f;
  float dnx = degen ? g.nx : lx;
  float dny = degen ? g.ny : ly;
  float dnz = degen ? g.nz : lz;
  float rfx = 0.0f, rfy = 0.0f, rfz = 0.0f;
  if (F::met || F::die) {
    g.sdn = dot3(s.dx, s.dy, s.dz, g.nx, g.ny, g.nz);
    rfx = s.dx - 2.0f * g.sdn * g.nx;
    rfy = s.dy - 2.0f * g.sdn * g.ny;
    rfz = s.dz - 2.0f * g.sdn * g.nz;
  }
  float mex = 0.0f, mey = 0.0f, mez = 0.0f;
  if (F::met) {
    mex = rfx + w.fuzz * g.bx;
    mey = rfy + w.fuzz * g.by;
    mez = rfz + w.fuzz * g.bz;
  }
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  g.cos_clip = false;
  g.cref = false;
  if (F::die) {
    g.eta = g.front ? 1.0f / fmaxf(w.ior, 1e-6f) : w.ior;
    const float mcos_raw = -(g.nx * s.dx + g.ny * s.dy + g.nz * s.dz);
    g.cos_clip = mcos_raw < 1.0f;
    g.cosv = fminf(mcos_raw, 1.0f);
    const float sinv = sqrtf(fmaxf(1.0f - g.cosv * g.cosv, 0.0f));
    const bool tir = g.eta * sinv > 1.0f;
    const float sr0 = (1.0f - g.eta) / (1.0f + g.eta);
    const float r0 = sr0 * sr0;
    const float x = 1.0f - g.cosv;
    const float x2 = x * x;
    const float reflp = r0 + (1.0f - r0) * (x2 * x2 * x);
    g.cref = tir || (reflp > su4);
    g.ppx = g.eta * (s.dx + g.nx * g.cosv);
    g.ppy = g.eta * (s.dy + g.ny * g.cosv);
    g.ppz = g.eta * (s.dz + g.nz * g.cosv);
    const float plen2 = dot3(g.ppx, g.ppy, g.ppz, g.ppx, g.ppy, g.ppz);
    g.zk = 1.0f - plen2;
    g.kk = fmaxf(fabsf(g.zk), 1e-12f);
    g.par = -sqrtf(g.kk);
    gx = g.cref ? rfx : g.ppx + g.par * g.nx;
    gy = g.cref ? rfy : g.ppy + g.par * g.ny;
    gz = g.cref ? rfz : g.ppz + g.par * g.nz;
  }
  if (F::met && F::die) {
    dnx = g.is_lam ? dnx : (g.is_met ? mex : gx);
    dny = g.is_lam ? dny : (g.is_met ? mey : gy);
    dnz = g.is_lam ? dnz : (g.is_met ? mez : gz);
  } else if (F::met) {
    dnx = g.is_lam ? dnx : mex;
    dny = g.is_lam ? dny : mey;
    dnz = g.is_lam ? dnz : mez;
  } else if (F::die) {
    dnx = g.is_lam ? dnx : gx;
    dny = g.is_lam ? dny : gy;
    dnz = g.is_lam ? dnz : gz;
  }
  g.invl = 1.0f / sqrtf(fmaxf(dot3(dnx, dny, dnz, dnx, dny, dnz), 1e-24f));
  g.sdx = dnx * g.invl;
  g.sdy = dny * g.invl;
  g.sdz = dnz * g.invl;
  g.scf = b2f(hit_live && !is_light);
}

__device__ __forceinline__ State advance(const Shade& g, const State& s,
                                         const Winner& w) {
  const float scf = g.scf;
  const float inv = 1.0f - scf;
  State n;
  n.ox = inv * s.ox + scf * g.p_x;
  n.oy = inv * s.oy + scf * g.p_y;
  n.oz = inv * s.oz + scf * g.p_z;
  n.dx = inv * s.dx + scf * g.sdx;
  n.dy = inv * s.dy + scf * g.sdy;
  n.dz = inv * s.dz + scf * g.sdz;
  n.tr = s.tr * (inv + scf * w.ar);
  n.tg = s.tg * (inv + scf * w.ag);
  n.tb = s.tb * (inv + scf * w.ab);
  n.alive = scf;
  n.pd = scf * b2f(g.is_lam);
  return n;
}

__device__ __forceinline__ float shadow_vis(const Args& a, const Shade& g) {
  if (!g.nee_on) return 1.0f;
  int win;
  const float occ =
      closest_hit(a, g.p_x, g.p_y, g.p_z, g.wlx, g.wly, g.wlz, win);
  return b2f(!(occ < g.dist * kShadowScale));
}

__device__ __forceinline__ void color_adds(const Shade& g, const State& s,
                                           const Winner& w, float vis,
                                           const float* cam, float& cr,
                                           float& cg, float& cb) {
  cr = g.mlf * s.tr * cam[20] + g.gate_e * s.tr * w.er;
  cg = g.mlf * s.tg * cam[21] + g.gate_e * s.tg * w.eg;
  cb = g.mlf * s.tb * cam[22] + g.gate_e * s.tb * w.eb;
  if (g.nee_on) {
    const float sc = g.activef * vis * g.geom * kInvPi;
    cr = cr + sc * s.tr * w.ar * g.ler;
    cg = cg + sc * s.tg * w.ag * g.leg;
    cb = cb + sc * s.tb * w.ab * g.leb;
  }
}

// ---- per-sphere soft shadow ------------------------------------------------
struct SoftSph {
  float cxx, cxy, cxz, s_along, s_cl, ex, ey, ez, dsep, wsoft, vs, r_abs;
};

__device__ __forceinline__ SoftSph softshadow_one(const Args& a, int i,
                                                  const Shade& g) {
  const float* p = a.tab + i * kSphF;
  const float cxs = p[0], cys = p[1], czs = p[2], srs = p[4];
  SoftSph o;
  o.r_abs = fabsf(srs);
  o.cxx = cxs - g.p_x;
  o.cxy = cys - g.p_y;
  o.cxz = czs - g.p_z;
  o.s_along = o.cxx * g.wlx + o.cxy * g.wly + o.cxz * g.wlz;
  o.s_cl = fminf(fmaxf(o.s_along, 0.0f), g.dist);
  o.ex = g.p_x + o.s_cl * g.wlx - cxs;
  o.ey = g.p_y + o.s_cl * g.wly - cys;
  o.ez = g.p_z + o.s_cl * g.wlz - czs;
  o.dsep = sqrtf(fmaxf(o.ex * o.ex + o.ey * o.ey + o.ez * o.ez, 1e-12f));
  o.wsoft = 0.25f * o.r_abs + 1e-6f;
  o.vs = sigmoid((o.dsep - o.r_abs) / o.wsoft);
  return o;
}

// ---- per-quad edge coverage (quad_cov_fwd / adj) ----------------------------
struct QuadCov {
  float qcx, qcy, qcz, qux, quy, quz, qvx, qvy, qvz;
  float nx, ny, nz, wx, wy, wz, inv_nn, dsafe, tpar, prx, pry, prz;
  float s1, s2, s3, s4, cov;
  bool den_ok;
};

__device__ __forceinline__ QuadCov quad_cov(const Args& a, int j, float ax,
                                            float ay, float az, float bx,
                                            float by, float bz) {
  const float* q = a.tab + a.n_sph * kSphF + j * kQuadF + kGeoOffQ;
  QuadCov f;
  f.qcx = q[0];
  f.qcy = q[1];
  f.qcz = q[2];
  f.qux = q[3];
  f.quy = q[4];
  f.quz = q[5];
  f.qvx = q[6];
  f.qvy = q[7];
  f.qvz = q[8];
  f.nx = f.quy * f.qvz - f.quz * f.qvy;
  f.ny = f.quz * f.qvx - f.qux * f.qvz;
  f.nz = f.qux * f.qvy - f.quy * f.qvx;
  const float nn = fmaxf(f.nx * f.nx + f.ny * f.ny + f.nz * f.nz, 1e-30f);
  f.inv_nn = 1.0f / nn;
  f.wx = f.nx * f.inv_nn;
  f.wy = f.ny * f.inv_nn;
  f.wz = f.nz * f.inv_nn;
  const float dp = f.nx * f.qcx + f.ny * f.qcy + f.nz * f.qcz;
  const float den = f.nx * bx + f.ny * by + f.nz * bz;
  f.den_ok = fabsf(den) > 1e-8f;
  f.dsafe = f.den_ok ? den : 1.0f;
  f.tpar = (dp - (f.nx * ax + f.ny * ay + f.nz * az)) / f.dsafe;
  f.prx = ax + f.tpar * bx - f.qcx;
  f.pry = ay + f.tpar * by - f.qcy;
  f.prz = az + f.tpar * bz - f.qcz;
  const float al = (f.pry * f.qvz - f.prz * f.qvy) * f.wx +
                   (f.prz * f.qvx - f.prx * f.qvz) * f.wy +
                   (f.prx * f.qvy - f.pry * f.qvx) * f.wz;
  const float be = (f.quy * f.prz - f.quz * f.pry) * f.wx +
                   (f.quz * f.prx - f.qux * f.prz) * f.wy +
                   (f.qux * f.pry - f.quy * f.prx) * f.wz;
  f.s1 = sigmoid(al * kInvWqe);
  f.s2 = sigmoid((1.0f - al) * kInvWqe);
  f.s3 = sigmoid(be * kInvWqe);
  f.s4 = sigmoid((1.0f - be) * kInvWqe);
  f.cov = f.s1 * f.s2 * f.s3 * f.s4;
  return f;
}

// ccov -> the quad's 9 gradients (added to accumulators at..at+9) and,
// with need_seg, the segment cotangents ca (origin) and cb (direction).
template <class Acc>
__device__ __forceinline__ void quad_cov_adj(const QuadCov& f, float ccov,
                                             float ax, float ay, float az,
                                             float bx, float by, float bz,
                                             const Acc& acc, int at,
                                             bool need_seg, float* ca,
                                             float* cb) {
  const float cal = ccov * f.cov * (f.s2 - f.s1) * kInvWqe;
  const float cbe = ccov * f.cov * (f.s4 - f.s3) * kInvWqe;
  const float cprx =
      cal * (f.qvy * f.wz - f.qvz * f.wy) + cbe * (f.wy * f.quz - f.wz * f.quy);
  const float cpry =
      cal * (f.qvz * f.wx - f.qvx * f.wz) + cbe * (f.wz * f.qux - f.wx * f.quz);
  const float cprz =
      cal * (f.qvx * f.wy - f.qvy * f.wx) + cbe * (f.wx * f.quy - f.wy * f.qux);
  float cqv_x = cal * (f.wy * f.prz - f.wz * f.pry);
  float cqv_y = cal * (f.wz * f.prx - f.wx * f.prz);
  float cqv_z = cal * (f.wx * f.pry - f.wy * f.prx);
  float cqu_x = cbe * (f.pry * f.wz - f.prz * f.wy);
  float cqu_y = cbe * (f.prz * f.wx - f.prx * f.wz);
  float cqu_z = cbe * (f.prx * f.wy - f.pry * f.wx);
  const float cwx = cal * (f.pry * f.qvz - f.prz * f.qvy) +
                    cbe * (f.quy * f.prz - f.quz * f.pry);
  const float cwy = cal * (f.prz * f.qvx - f.prx * f.qvz) +
                    cbe * (f.quz * f.prx - f.qux * f.prz);
  const float cwz = cal * (f.prx * f.qvy - f.pry * f.qvx) +
                    cbe * (f.qux * f.pry - f.quy * f.prx);
  const float wdc = f.wx * cwx + f.wy * cwy + f.wz * cwz;
  float cnx = cwx * f.inv_nn - 2.0f * f.wx * wdc;
  float cny = cwy * f.inv_nn - 2.0f * f.wy * wdc;
  float cnz = cwz * f.inv_nn - 2.0f * f.wz * wdc;
  const float ctp = (cprx * bx + cpry * by + cprz * bz) * b2f(f.den_ok);
  float cqc_x = -cprx;
  float cqc_y = -cpry;
  float cqc_z = -cprz;
  const float cN = ctp / f.dsafe;
  const float cD = -ctp * f.tpar / f.dsafe;
  cnx = cnx + cN * (f.qcx - ax) + cD * bx;
  cny = cny + cN * (f.qcy - ay) + cD * by;
  cnz = cnz + cN * (f.qcz - az) + cD * bz;
  cqc_x = cqc_x + cN * f.nx;
  cqc_y = cqc_y + cN * f.ny;
  cqc_z = cqc_z + cN * f.nz;
  cqu_x = cqu_x + (f.qvy * cnz - f.qvz * cny);
  cqu_y = cqu_y + (f.qvz * cnx - f.qvx * cnz);
  cqu_z = cqu_z + (f.qvx * cny - f.qvy * cnx);
  cqv_x = cqv_x + (cny * f.quz - cnz * f.quy);
  cqv_y = cqv_y + (cnz * f.qux - cnx * f.quz);
  cqv_z = cqv_z + (cnx * f.quy - cny * f.qux);
  acc.add(at + 0, cqc_x);
  acc.add(at + 1, cqc_y);
  acc.add(at + 2, cqc_z);
  acc.add(at + 3, cqu_x);
  acc.add(at + 4, cqu_y);
  acc.add(at + 5, cqu_z);
  acc.add(at + 6, cqv_x);
  acc.add(at + 7, cqv_y);
  acc.add(at + 8, cqv_z);
  if (need_seg) {
    ca[0] = cprx - cN * f.nx;
    ca[1] = cpry - cN * f.ny;
    ca[2] = cprz - cN * f.nz;
    cb[0] = cprx * f.tpar + cD * f.nx;
    cb[1] = cpry * f.tpar + cD * f.ny;
    cb[2] = cprz * f.tpar + cD * f.nz;
  }
}

__device__ __forceinline__ float shadow_gate(const QuadCov& f,
                                             const Shade& g) {
  return b2f(f.den_ok && f.tpar > 1e-3f && f.tpar < g.dist * kShadowScale);
}

// Cotangents of the ray state entering a bounce (the TPU kernel's cin /
// cout: origin, direction, throughput).
struct Cot {
  float ox, oy, oz, dx, dy, dz, tr, tg, tb;
};

// One bounce backwards: recompute its shading, apply the hand VJPs, add
// the parameter terms to acc and return the entering state's cotangent.
// The surrogate chains run over the rows of `sc`.
template <class F, class Acc, class Scope>
__device__ __forceinline__ void bounce_adj(const Args& a, const Scope& sc, uint32_t pid,
                           uint32_t samp, int b, const State& s, float best_t,
                           int win, float vis, Cot& c, float chr, float chg,
                           float chb, const Acc& acc) {
  const Winner w = winner_fields(a, win);
  Shade g;
  shade<F>(a, pid, samp, b, s, best_t, w, g);
  const float T1r = s.tr, T1g = s.tg, T1b = s.tb;
  const float scf = g.scf;
  const float inv_s = 1.0f - scf;
  const float nx = g.nx, ny = g.ny, nz = g.nz;

  // A5 scatter
  float cT1r = c.tr * (inv_s + scf * w.ar);
  float cT1g = c.tg * (inv_s + scf * w.ag);
  float cT1b = c.tb * (inv_s + scf * w.ab);
  float calb_r = scf * c.tr * T1r;
  float calb_g = scf * c.tg * T1g;
  float calb_b = scf * c.tb * T1b;
  float cpx = scf * c.ox;
  float cpy = scf * c.oy;
  float cpz = scf * c.oz;
  float cox = inv_s * c.ox;
  float coy = inv_s * c.oy;
  float coz = inv_s * c.oz;
  const float csdx = scf * c.dx;
  const float csdy = scf * c.dy;
  const float csdz = scf * c.dz;
  float cdx = inv_s * c.dx;
  float cdy = inv_s * c.dy;
  float cdz = inv_s * c.dz;
  const float dot_c = g.sdx * csdx + g.sdy * csdy + g.sdz * csdz;
  const float cdnx = g.invl * (csdx - g.sdx * dot_c);
  const float cdny = g.invl * (csdy - g.sdy * dot_c);
  const float cdnz = g.invl * (csdz - g.sdz * dot_c);
  const float lamf = b2f(g.is_lam);
  float cnx = lamf * cdnx;
  float cny = lamf * cdny;
  float cnz = lamf * cdnz;
  float creflx = 0.0f, crefly = 0.0f, creflz = 0.0f;
  float cfuzz = 0.0f, cior = 0.0f;
  if (F::met) {
    const float metf = b2f(g.is_met);
    creflx = metf * cdnx;
    crefly = metf * cdny;
    creflz = metf * cdnz;
    cfuzz = metf * (g.bx * cdnx + g.by * cdny + g.bz * cdnz);
  }
  if (F::die) {
    const float dief = b2f(g.is_die);
    const float creff = b2f(g.cref);
    creflx = creflx + dief * creff * cdnx;
    crefly = crefly + dief * creff * cdny;
    creflz = creflz + dief * creff * cdnz;
    const float refr_f = dief * (1.0f - creff);
    const float cfx = refr_f * cdnx;
    const float cfy = refr_f * cdny;
    const float cfz = refr_f * cdnz;
    float cppx = cfx, cppy = cfy, cppz = cfz;
    const float cpar = nx * cfx + ny * cfy + nz * cfz;
    cnx = cnx + g.par * cfx;
    cny = cny + g.par * cfy;
    cnz = cnz + g.par * cfz;
    const float live_k = b2f(fabsf(g.zk) > 1e-12f);
    const float cpl = cpar * 0.5f * sgnf(g.zk) * live_k / sqrtf(g.kk);
    cppx = cppx + 2.0f * cpl * g.ppx;
    cppy = cppy + 2.0f * cpl * g.ppy;
    cppz = cppz + 2.0f * cpl * g.ppz;
    const float ceta = (s.dx + nx * g.cosv) * cppx +
                       (s.dy + ny * g.cosv) * cppy +
                       (s.dz + nz * g.cosv) * cppz;
    cdx = cdx + g.eta * cppx;
    cdy = cdy + g.eta * cppy;
    cdz = cdz + g.eta * cppz;
    cnx = cnx + g.eta * g.cosv * cppx;
    cny = cny + g.eta * g.cosv * cppy;
    cnz = cnz + g.eta * g.cosv * cppz;
    const float ccos = g.eta * (nx * cppx + ny * cppy + nz * cppz);
    const float cnd = -ccos * b2f(g.cos_clip);
    cnx = cnx + cnd * s.dx;
    cny = cny + cnd * s.dy;
    cnz = cnz + cnd * s.dz;
    cdx = cdx + cnd * nx;
    cdy = cdy + cnd * ny;
    cdz = cdz + cnd * nz;
    const float frontf = b2f(g.front);
    const float iors = fmaxf(w.ior, 1e-6f);
    cior = ceta * (frontf * (-1.0f / (iors * iors)) + (1.0f - frontf));
  }
  if (F::met || F::die) {
    const float ndotcr = nx * creflx + ny * crefly + nz * creflz;
    cdx = cdx + creflx - 2.0f * ndotcr * nx;
    cdy = cdy + crefly - 2.0f * ndotcr * ny;
    cdz = cdz + creflz - 2.0f * ndotcr * nz;
    cnx = cnx - 2.0f * g.sdn * creflx - 2.0f * ndotcr * s.dx;
    cny = cny - 2.0f * g.sdn * crefly - 2.0f * ndotcr * s.dy;
    cnz = cnz - 2.0f * g.sdn * creflz - 2.0f * ndotcr * s.dz;
  }

  // A4 NEE
  const int n_s = sc.n_s;
  const int n_q = sc.n_q;
  if (g.nee_on) {
    const float s_base = g.activef * vis * kInvPi;
    const float geomf = g.geom;
    cT1r = cT1r + s_base * geomf * w.ar * g.ler * chr;
    cT1g = cT1g + s_base * geomf * w.ag * g.leg * chg;
    cT1b = cT1b + s_base * geomf * w.ab * g.leb * chb;
    calb_r = calb_r + s_base * geomf * T1r * g.ler * chr;
    calb_g = calb_g + s_base * geomf * T1g * g.leg * chg;
    calb_b = calb_b + s_base * geomf * T1b * g.leb * chb;
    const float cler = s_base * geomf * T1r * w.ar * chr;
    const float cleg = s_base * geomf * T1g * w.ag * chg;
    const float cleb = s_base * geomf * T1b * w.ab * chb;
    const float ghat = s_base * (chr * T1r * w.ar * g.ler +
                                 chg * T1g * w.ag * g.leg +
                                 chb * T1b * w.ab * g.leb);
    const float cvr = ghat * geomf;
    const float cgraw = ghat * b2f(g.graw < kGeomMax);
    float cwlx = 0.0f, cwly = 0.0f, cwlz = 0.0f, cdist = 0.0f;
    if (n_s || n_q) {
      // v_total = v_spheres * v_quads with one shared ratio clamp
      float v_s = 1.0f;
      for (int k = 0; k < n_s; ++k) {
        v_s = v_s * softshadow_one(a, sc.sph(k), g).vs;
      }
      float v_q = 1.0f;
      bool any_q = false;
      for (int k = 0; k < n_q; ++k) {
        const int j = sc.quad(k);
        if (j == a.light_quad) continue;
        const QuadCov f =
            quad_cov(a, j, g.p_x, g.p_y, g.p_z, g.wlx, g.wly, g.wlz);
        const float vq = fmaxf(1.0f - shadow_gate(f, g) * f.cov, 1e-3f);
        v_q = any_q ? v_q * vq : vq;
        any_q = true;
      }
      const float cv_t = cvr / fmaxf(v_s * v_q, 1e-3f);
      if (n_s) {
        const float cv = cv_t * v_q;
        float spx = 0.0f, spy = 0.0f, spz = 0.0f;
        for (int k = 0; k < n_s; ++k) {
          const int i = sc.sph(k);
          const SoftSph p = softshadow_one(a, i, g);
          const float srs = a.tab[i * kSphF + 4];
          const float cvs = cv * v_s / fmaxf(p.vs, 1e-6f);
          const float czs = cvs * (p.vs * (1.0f - p.vs));
          const float w2 = p.wsoft * p.wsoft;
          const float csr_abs =
              czs * (-(p.wsoft) - (p.dsep - p.r_abs) * 0.25f) / w2;
          const float cdsep = czs / p.wsoft;
          const float inv_dsep = 1.0f / p.dsep;
          const float cex = cdsep * p.ex * inv_dsep;
          const float cey = cdsep * p.ey * inv_dsep;
          const float cez = cdsep * p.ez * inv_dsep;
          float cscx = -cex, cscy = -cey, cscz = -cez;
          spx = spx + cex;
          spy = spy + cey;
          spz = spz + cez;
          const float cs_cl = cex * g.wlx + cey * g.wly + cez * g.wlz;
          const bool in_rng = p.s_along > 0.0f && p.s_along < g.dist;
          const float cs_along = in_rng ? cs_cl : 0.0f;
          cdist = cdist + (p.s_along >= g.dist ? cs_cl : 0.0f);
          cscx = cscx + cs_along * g.wlx;
          cscy = cscy + cs_along * g.wly;
          cscz = cscz + cs_along * g.wlz;
          spx = spx - cs_along * g.wlx;
          spy = spy - cs_along * g.wly;
          spz = spz - cs_along * g.wlz;
          cwlx = cwlx + cex * p.s_cl + cs_along * p.cxx;
          cwly = cwly + cey * p.s_cl + cs_along * p.cxy;
          cwlz = cwlz + cez * p.s_cl + cs_along * p.cxz;
          const int d = 4 * i;
          acc.add(d + 0, cscx);
          acc.add(d + 1, cscy);
          acc.add(d + 2, cscz);
          acc.add(d + 3, csr_abs * sgnf(srs));
        }
        cpx = cpx + spx;
        cpy = cpy + spy;
        cpz = cpz + spz;
      }
      if (n_q) {
        const float cv = cv_t * v_s;
        float qpx = 0.0f, qpy = 0.0f, qpz = 0.0f;
        float qwx = 0.0f, qwy = 0.0f, qwz = 0.0f;
        for (int k = 0; k < n_q; ++k) {
          const int j = sc.quad(k);
          if (j == a.light_quad) continue;
          const QuadCov f =
              quad_cov(a, j, g.p_x, g.p_y, g.p_z, g.wlx, g.wly, g.wlz);
          const float gate = shadow_gate(f, g);
          const float vq_raw = 1.0f - gate * f.cov;
          const float vq = fmaxf(vq_raw, 1e-3f);
          float cvq = cv * v_q / fmaxf(vq, 1e-6f);
          cvq = vq_raw > 1e-3f ? cvq : 0.0f;
          float ca[3], cb[3];
          quad_cov_adj(f, -gate * cvq, g.p_x, g.p_y, g.p_z, g.wlx, g.wly,
                       g.wlz, acc, a.a_q + 9 * j, true, ca, cb);
          qpx = qpx + ca[0];
          qpy = qpy + ca[1];
          qpz = qpz + ca[2];
          qwx = qwx + cb[0];
          qwy = qwy + cb[1];
          qwz = qwz + cb[2];
        }
        cpx = cpx + qpx;
        cpy = cpy + qpy;
        cpz = cpz + qpz;
        cwlx = cwlx + qwx;
        cwly = cwly + qwy;
        cwlz = cwlz + qwz;
      }
    }
    const float nlf = (float)a.n_lights;
    const float f_cx = cgraw * g.cosy * g.area * nlf / g.r2g;
    const float f_cy = cgraw * g.cosx * g.area * nlf / g.r2g;
    float carea = cgraw * g.cosx * g.cosy * nlf / g.r2g;
    const float live_r2 = b2f(g.r2l > 1e-12f);
    float cr2 = -cgraw * g.graw / g.r2g * live_r2;
    cnx = cnx + f_cx * g.wlx;
    cny = cny + f_cx * g.wly;
    cnz = cnz + f_cx * g.wlz;
    cwlx = cwlx + f_cx * nx;
    cwly = cwly + f_cx * ny;
    cwlz = cwlz + f_cx * nz;
    const float ccy = f_cy * sgnf(g.cy_raw);
    const float clnux = ccy * g.wlx;
    const float clnuy = ccy * g.wly;
    const float clnuz = ccy * g.wlz;
    cwlx = cwlx + ccy * g.lnux;
    cwly = cwly + ccy * g.lnuy;
    cwlz = cwlz + ccy * g.lnuz;
    float clnx = clnux * g.ainv;
    float clny = clnuy * g.ainv;
    float clnz = clnuz * g.ainv;
    const float cainv = g.lnx * clnux + g.lny * clnuy + g.lnz * clnuz;
    carea = carea - g.ainv * g.ainv * cainv;
    clnx = clnx + carea * g.lnux;
    clny = clny + carea * g.lnuy;
    clnz = clnz + carea * g.lnuz;
    float clux, cluy, cluz, clvx, clvy, clvz;
    cross3(g.lvx, g.lvy, g.lvz, clnx, clny, clnz, clux, cluy, cluz);
    cross3(clnx, clny, clnz, g.lux, g.luy, g.luz, clvx, clvy, clvz);
    float ctlx = cwlx * g.idist;
    float ctly = cwly * g.idist;
    float ctlz = cwlz * g.idist;
    const float cidist = g.tlx * cwlx + g.tly * cwly + g.tlz * cwlz;
    cdist = cdist - g.idist * g.idist * cidist;
    cr2 = cr2 + cdist * 0.5f * g.idist * live_r2;
    ctlx = ctlx + 2.0f * cr2 * g.tlx;
    ctly = ctly + 2.0f * cr2 * g.tly;
    ctlz = ctlz + 2.0f * cr2 * g.tlz;
    cpx = cpx - ctlx;
    cpy = cpy - ctly;
    cpz = cpz - ctlz;
    clux = clux + g.nu1 * ctlx;
    cluy = cluy + g.nu1 * ctly;
    cluz = cluz + g.nu1 * ctlz;
    clvx = clvx + g.nu2 * ctlx;
    clvy = clvy + g.nu2 * ctly;
    clvz = clvz + g.nu2 * ctlz;
    const int d = a.a_l + kLightF * g.kpick;
    acc.add(d + 0, ctlx);
    acc.add(d + 1, ctly);
    acc.add(d + 2, ctlz);
    acc.add(d + 3, clux);
    acc.add(d + 4, cluy);
    acc.add(d + 5, cluz);
    acc.add(d + 6, clvx);
    acc.add(d + 7, clvy);
    acc.add(d + 8, clvz);
    acc.add(d + 9, cler);
    acc.add(d + 10, cleg);
    acc.add(d + 11, cleb);
  }

  // A3 emission + A2 background
  const float* cam = a.cam;
  cT1r = cT1r + g.gate_e * chr * w.er + g.mlf * chr * cam[20];
  cT1g = cT1g + g.gate_e * chg * w.eg + g.mlf * chg * cam[21];
  cT1b = cT1b + g.gate_e * chb * w.eb + g.mlf * chb * cam[22];
  {
    const int d = a.a_b;
    acc.add(d + 0, g.mlf * T1r * chr);
    acc.add(d + 1, g.mlf * T1g * chg);
    acc.add(d + 2, g.mlf * T1b * chb);
  }

  // A1 silhouette
  if (F::sil && (n_s || n_q)) {
    const float cF = cT1r * T1r + cT1g * T1g + cT1b * T1b;
    const bool live = s.alive > 0.5f;
    const float t_lim = g.hit ? best_t : kFar;
    for (int k = 0; k < n_s; ++k) {
      const int i = sc.sph(k);
      const float* p = a.tab + i * kSphF;
      const float cxs = p[0], cys = p[1], czs = p[2], srs = p[4];
      const float r_abs = fabsf(srs);
      const bool ws = win == i;
      const float cx_ = cxs - s.ox;
      const float cy_ = cys - s.oy;
      const float cz_o = czs - s.oz;
      const float s_along = cx_ * s.dx + cy_ * s.dy + cz_o * s.dz;
      const float s_hit = fmaxf(s_along, kTMin);
      const float s_blk = fminf(fmaxf(s_along, kTMin), t_lim);
      const float s_eff = ws ? s_hit : s_blk;
      const float ex = s.ox + s_eff * s.dx - cxs;
      const float ey = s.oy + s_eff * s.dy - cys;
      const float ez = s.oz + s_eff * s.dz - czs;
      const float dmin = sqrtf(fmaxf(ex * ex + ey * ey + ez * ez, 1e-12f));
      const float wsil = 0.05f * r_abs + 1e-5f;
      const float cov = sigmoid((r_abs - dmin) / wsil);
      float pp = ws ? cov : 1.0f - cov;
      pp = live ? pp : 1.0f;
      const float cp = cF / fmaxf(pp, 1e-3f);
      const float sign = ws ? 1.0f : -1.0f;
      const float ccov = live ? cp * sign : 0.0f;
      const float czz = ccov * cov * (1.0f - cov);
      const float w2 = wsil * wsil;
      const float cr_abs = czz * (wsil - (r_abs - dmin) * 0.05f) / w2;
      const float cdmin = -czz / wsil;
      const float inv_dmin = 1.0f / dmin;
      const float cex = cdmin * ex * inv_dmin;
      const float cey = cdmin * ey * inv_dmin;
      const float cez = cdmin * ez * inv_dmin;
      const float cs_eff = cex * s.dx + cey * s.dy + cez * s.dz;
      const float m_hit = b2f(s_along > kTMin);
      const float m_blk = b2f(s_along > kTMin && s_along < t_lim);
      const float cs_along = (ws ? m_hit : m_blk) * cs_eff;
      const int d = 4 * i;
      acc.add(d + 0, -cex + cs_along * s.dx);
      acc.add(d + 1, -cey + cs_along * s.dy);
      acc.add(d + 2, -cez + cs_along * s.dz);
      acc.add(d + 3, cr_abs * sgnf(srs));
    }
    for (int k = 0; k < n_q; ++k) {
      const int j = sc.quad(k);
      const QuadCov f = quad_cov(a, j, s.ox, s.oy, s.oz, s.dx, s.dy, s.dz);
      const bool wq_win = win == a.n_sph + j;
      const float gate =
          b2f(f.den_ok && f.tpar > kTMin && f.tpar < t_lim);
      float pp = wq_win ? f.cov : 1.0f - gate * f.cov;
      pp = live ? pp : 1.0f;
      const float cp = cF / fmaxf(pp, 1e-3f);
      const float sgn_ev = wq_win ? 1.0f : -gate;
      const float ccov = live ? cp * sgn_ev : 0.0f;
      quad_cov_adj(f, ccov, s.ox, s.oy, s.oz, s.dx, s.dy, s.dz,
                   acc, a.a_q + 9 * j, false, nullptr, nullptr);
    }
  }

  // A0 normal -> point -> t -> geometry
  const float cnox = g.sgn * cnx;
  const float cnoy = g.sgn * cny;
  const float cnoz = g.sgn * cnz;
  const float quadf = w.isq;
  const float sphf = 1.0f - quadf;
  const float sd_n = g.sx_o * cnox + g.sy_o * cnoy + g.sz_o * cnoz;
  const float cmx = sphf * (cnox - g.sx_o * sd_n) / g.rho;
  const float cmy = sphf * (cnoy - g.sy_o * sd_n) / g.rho;
  const float cmz = sphf * (cnoz - g.sz_o * sd_n) / g.rho;
  cpx = cpx + cmx;
  cpy = cpy + cmy;
  cpz = cpz + cmz;
  float c_cx = -cmx;
  float c_cy = -cmy;
  float c_cz = -cmz;
  const float qd_n = g.qx_o * cnox + g.qy_o * cnoy + g.qz_o * cnoz;
  float cwnx = quadf * (cnox - g.qx_o * qd_n) / g.qlen;
  float cwny = quadf * (cnoy - g.qy_o * qd_n) / g.qlen;
  float cwnz = quadf * (cnoz - g.qz_o * qd_n) / g.qlen;
  const float ct = (cpx * s.dx + cpy * s.dy + cpz * s.dz) * g.hlf;
  cox = cox + cpx;
  coy = coy + cpy;
  coz = coz + cpz;
  cdx = cdx + g.t * cpx;
  cdy = cdy + g.t * cpy;
  cdz = cdz + g.t * cpz;
  const float sphtf = sphf * g.hlf;
  const float root_sgn = 2.0f * b2f(g.use0) - 1.0f;
  const float chbv = ct * sphtf * (-1.0f - root_sgn * g.hb / g.sq_safe);
  const float cct = ct * sphtf * (root_sgn * 0.5f / g.sq_safe);
  const float cocx = chbv * s.dx + 2.0f * cct * g.ocx;
  const float cocy = chbv * s.dy + 2.0f * cct * g.ocy;
  const float cocz = chbv * s.dz + 2.0f * cct * g.ocz;
  const float crad = cct * (-2.0f * w.rad);
  cdx = cdx + chbv * g.ocx;
  cdy = cdy + chbv * g.ocy;
  cdz = cdz + chbv * g.ocz;
  cox = cox + cocx;
  coy = coy + cocy;
  coz = coz + cocz;
  c_cx = c_cx - cocx;
  c_cy = c_cy - cocy;
  c_cz = c_cz - cocz;
  const float qtf = quadf * g.hlf;
  const float cnum = ct * qtf / g.dden;
  const float cden = -ct * qtf * g.t_quad / g.dden;
  cwnx = cwnx + cnum * (w.qcx - s.ox) + cden * s.dx;
  cwny = cwny + cnum * (w.qcy - s.oy) + cden * s.dy;
  cwnz = cwnz + cnum * (w.qcz - s.oz) + cden * s.dz;
  const float cqc_x = cnum * g.wnx;
  const float cqc_y = cnum * g.wny;
  const float cqc_z = cnum * g.wnz;
  cox = cox - cnum * g.wnx;
  coy = coy - cnum * g.wny;
  coz = coz - cnum * g.wnz;
  cdx = cdx + cden * g.wnx;
  cdy = cdy + cden * g.wny;
  cdz = cdz + cden * g.wnz;
  float cqux, cquy, cquz, cqvx, cqvy, cqvz;
  cross3(w.qvx, w.qvy, w.qvz, cwnx, cwny, cwnz, cqux, cquy, cquz);
  cross3(cwnx, cwny, cwnz, w.qux, w.quy, w.quz, cqvx, cqvy, cqvz);

  // the winner's and its material's terms
  if (win >= 0) {
    if (win < a.n_sph) {
      const int d = 4 * win;
      acc.add(d + 0, c_cx);
      acc.add(d + 1, c_cy);
      acc.add(d + 2, c_cz);
      acc.add(d + 3, crad);
    } else {
      const int d = a.a_q + 9 * (win - a.n_sph);
      acc.add(d + 0, cqc_x);
      acc.add(d + 1, cqc_y);
      acc.add(d + 2, cqc_z);
      acc.add(d + 3, cqux);
      acc.add(d + 4, cquy);
      acc.add(d + 5, cquz);
      acc.add(d + 6, cqvx);
      acc.add(d + 7, cqvy);
      acc.add(d + 8, cqvz);
    }
  }
  {
    const int d = a.a_m + 8 * (int)w.mat;
    acc.add(d + 0, calb_r);
    acc.add(d + 1, calb_g);
    acc.add(d + 2, calb_b);
    acc.add(d + 3, cfuzz);
    acc.add(d + 4, cior);
    acc.add(d + 5, g.gate_e * chr * T1r);
    acc.add(d + 6, g.gate_e * chg * T1g);
    acc.add(d + 7, g.gate_e * chb * T1b);
  }
  c.ox = cox;
  c.oy = coy;
  c.oz = coz;
  c.dx = cdx;
  c.dy = cdy;
  c.dz = cdz;
  c.tr = cT1r;
  c.tg = cT1g;
  c.tb = cT1b;
}

// What one launch computes (see diff_thread): the pixels [pix0, pix0 +
// npix) of an image `width` pixels wide, in row-major order (a mesh
// shard's range, or the whole image). A pixel's id, and so its RNG and
// camera ray, is the image's own; the image, target and sample scratch
// are indexed by its place in the range. The loss scale (cam[23]) counts
// the whole image's pixels.
struct Launch {
  int pix0, npix, width, spp, mb, na;
  int slots;  // save slots per thread: k samples x mb bounces
  uint32_t spp_offset;
  float inv_spp;
};


// Whether [pix0, pix0 + npix) is a non-empty range of a (height, width)
// image.
inline bool range_in_image(int pix0, int npix, int width, int height) {
  return width > 0 && height > 0 && pix0 >= 0 && npix > 0 &&
         (long long)pix0 + npix <= (long long)width * height;
}

// A save slot: the 14 words a live bounce keeps for its adjoint (state,
// winner t and index, shadow visibility), then the sample's live-bounce
// count (written in its first slot when the sample ends) and a pad, so
// that a slot is four 128-bit accesses.
constexpr int kSlotVec = 4;  // float4 per slot

__device__ __forceinline__ void save_bounce(float4* sl, const State& s,
                                            float best, int win, float vis) {
  sl[0] = make_float4(s.ox, s.oy, s.oz, s.dx);
  sl[1] = make_float4(s.dy, s.dz, s.tr, s.tg);
  sl[2] = make_float4(s.tb, s.alive, s.pd, best);
  sl[3] = make_float4(__int_as_float(win), vis, 0.0f, 0.0f);
}

__device__ __forceinline__ void load_bounce(const float4* sl, State& s,
                                            float& best, int& win,
                                            float& vis) {
  const float4 v0 = sl[0], v1 = sl[1], v2 = sl[2], v3 = sl[3];
  s.ox = v0.x;
  s.oy = v0.y;
  s.oz = v0.z;
  s.dx = v0.w;
  s.dy = v1.x;
  s.dz = v1.y;
  s.tr = v1.z;
  s.tg = v1.w;
  s.tb = v2.x;
  s.alive = v2.y;
  s.pd = v2.z;
  best = v2.w;
  win = __float_as_int(v3.x);
  vis = v3.y;
}

__device__ __forceinline__ int sample_length(const float4* sl) {
  return __float_as_int(reinterpret_cast<const float*>(sl)[14]);
}

// Phase 1, the forward NEE image, in the image kernel: pixel
// blockIdx.x * blockDim.x + threadIdx.x of the range, samples [s0, s1) of
// part blockIdx.y of `split`. One bounce per pass of a loop whose only
// back edge is a vote of the whole warp (every thread of the warp runs
// it, those past the range too). A lane starts its next sample as soon as its
// path ends and adds each sample's colour to the pixel's sum in sample
// order from +0.0, so the image keeps the bits of a sample loop, and
// writes the mean to img. With split > 1 it writes each sample's colour
// to samples[(s * npix + pix) * 3 ..] instead, for fold_kernel to add up
// in the same order.
template <class F>
__device__ __forceinline__ void image_thread(const Args& a, const Launch& L,
                                             int split,
                                             float* __restrict__ samples,
                                             float* __restrict__ img) {
  const float* cam = a.cam;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;  // in the range
  const int s1 = (int)((long long)L.spp * (blockIdx.y + 1) / split);
  const int gpix = L.pix0 + pix;
  const uint32_t pid = (uint32_t)gpix;
  const float px = (float)(gpix % L.width);
  const float py = (float)(gpix / L.width);
  float ar = 0.0f, ag = 0.0f, ab = 0.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  State s;
  int sidx = (int)((long long)L.spp * blockIdx.y / split), b = 0;
  bool active = pix < L.npix && sidx < s1;
  while (__any_sync(0xffffffffu, active)) {
    if (active) {
      const uint32_t samp = L.spp_offset + (uint32_t)sidx;
      if (b == 0) {
        camera_ray(cam, px, py, pid, samp, a.seed, s.ox, s.oy, s.oz, s.dx,
                   s.dy, s.dz);
        s.tr = s.tg = s.tb = 1.0f;
        s.alive = 1.0f;
        s.pd = 0.0f;
        cr = cg = cb = 0.0f;
      }
      int win;
      const float best =
          closest_hit(a, s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, win);
      const Winner w = winner_fields(a, win);
      Shade g;
      shade<F>(a, pid, samp, b, s, best, w, g);
      const float vis = shadow_vis(a, g);
      float dr, dg, db;
      color_adds(g, s, w, vis, cam, dr, dg, db);
      cr = cr + dr;
      cg = cg + dg;
      cb = cb + db;
      s = advance(g, s, w);
      ++b;
      if (!(s.alive > 0.5f) || b == L.mb) {
        if (split > 1) {
          float* c = samples + ((size_t)sidx * L.npix + pix) * 3;
          c[0] = cr;
          c[1] = cg;
          c[2] = cb;
        } else {
          ar = ar + cr;
          ag = ag + cg;
          ab = ab + cb;
        }
        b = 0;
        active = ++sidx < s1;
      }
    }
  }
  if (pix < L.npix && split == 1) {
    img[3 * (size_t)pix + 0] = ar * L.inv_spp;
    img[3 * (size_t)pix + 1] = ag * L.inv_spp;
    img[3 * (size_t)pix + 2] = ab * L.inv_spp;
  }
}

// The pixels of one thread's warp, one pixel per lane and round: pixel
// base + lane of the range, base = warp's first thread + r x (threads of
// the grid).
// Every thread of the grid runs it, those without a pixel too: every loop
// below ends on a vote of the whole warp (__any_sync), and that vote is
// the loop's only back edge. With the exit test on a thread's own
// counters instead, nvcc threads an unfinished path straight back to the
// loop head and rebuilds the nested sample/bounce loops, the warp then
// waiting at every sample for its longest path (csrc/common.cuh,
// render_pixel).
//
// Per pixel, in the order of the twin `packed_diff_reference`:
//   (phase 1, the NEE image, ran in the image kernel: image_thread);
//   phase 2, the cotangent 2 (img - target) / (npix 3 spp) and the pixel's
//     squared error (added at a.a_loss);
//   phase 3, in chunks: stage R replays samples, one bounce per pass, and
//     saves each live bounce in the thread's next slot; a lane starts
//     another sample while a path of mb bounces still fits in L.slots.
//     Stage A then walks the chunk's samples in ascending order and each
//     sample's bounces in descending order through bounce_adj. Each stage
//     is a loop of its own: in one loop the lanes would drift into
//     different stages and a warp would pay for both bodies in a pass.
// The bounces after a path ended are skipped: the TPU kernels replay
// them, and their terms are exact zeros (the twin's replay_dead test
// holds that). A thread adds its terms in the order of a loop over its
// pixels, samples ascending, bounces descending.
template <class F, class Acc, class Scope>
__device__ __forceinline__ void diff_thread(
    const Args& a, const Scope& sc, const Launch& L,
    const float* __restrict__ target, const float* __restrict__ img,
    float4* __restrict__ saves, const Acc& acc) {
  const float* cam = a.cam;
  const int lane = threadIdx.x & 31;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nt = gridDim.x * blockDim.x;
  for (int base = tid - lane; base < L.npix; base += nt) {
    const int pix = base + lane;  // in the range
    const bool in = pix < L.npix;
    const int gpix = L.pix0 + pix;
    const uint32_t pid = (uint32_t)gpix;
    const float px = (float)(gpix % L.width);
    const float py = (float)(gpix / L.width);

    // ---- phase 2: the loss cotangent and the pixel's squared error, from
    // the image kernel's image (phase 1)
    float chr = 0.0f, chg = 0.0f, chb = 0.0f;
    if (in) {
      const float npixf = cam[23];
      const float dr = img[3 * (size_t)pix + 0] - target[3 * (size_t)pix + 0];
      const float dg = img[3 * (size_t)pix + 1] - target[3 * (size_t)pix + 1];
      const float db = img[3 * (size_t)pix + 2] - target[3 * (size_t)pix + 2];
      const float cscale = 2.0f / (npixf * 3.0f * (float)L.spp);
      chr = cscale * dr;
      chg = cscale * dg;
      chb = cscale * db;
      acc.add(a.a_loss, dr * dr + dg * dg + db * db);
    }

    // ---- phase 3: chunks of replay (stage R) and adjoint (stage A)
    State s;
    int b = 0;
    int next = 0;  // the first sample not yet replayed
    bool more = in;
    while (__any_sync(0xffffffffu, more)) {
      const int first = next;
      int off = 0, start = 0;
      b = 0;
      bool rep = more;
      while (__any_sync(0xffffffffu, rep)) {
        if (rep) {
          const uint32_t samp = L.spp_offset + (uint32_t)next;
          if (b == 0) {
            camera_ray(cam, px, py, pid, samp, a.seed, s.ox, s.oy, s.oz,
                       s.dx, s.dy, s.dz);
            s.tr = s.tg = s.tb = 1.0f;
            s.alive = 1.0f;
            s.pd = 0.0f;
            start = off;
          }
          int win;
          const float best =
              closest_hit(a, s.ox, s.oy, s.oz, s.dx, s.dy, s.dz, win);
          const Winner w = winner_fields(a, win);
          Shade g;
          shade<F>(a, pid, samp, b, s, best, w, g);
          const float vis = shadow_vis(a, g);
          save_bounce(saves + (size_t)off * kSlotVec, s, best, win, vis);
          s = advance(g, s, w);
          ++b;
          ++off;
          if (!(s.alive > 0.5f) || b == L.mb) {
            reinterpret_cast<float*>(saves + (size_t)start * kSlotVec)[14] =
                __int_as_float(b);
            b = 0;
            ++next;
            rep = next < L.spp && off + L.mb <= L.slots;
          }
        }
      }
      more = more && next < L.spp;

      int j = first, len = 0;
      start = 0;
      Cot c{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      bool adj = in && first < next;
      if (adj) {
        len = sample_length(saves);
        b = len - 1;
      }
      while (__any_sync(0xffffffffu, adj)) {
        if (adj) {
          State sb;
          float best, vis;
          int win;
          load_bounce(saves + (size_t)(start + b) * kSlotVec, sb, best, win,
                      vis);
          bounce_adj<F>(a, sc, pid, L.spp_offset + (uint32_t)j, b, sb, best,
                        win, vis, c, chr, chg, chb, acc);
          if (b > 0) {
            --b;
          } else if (++j < next) {
            start += len;
            len = sample_length(saves + (size_t)start * kSlotVec);
            b = len - 1;
            c = Cot{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
          } else {
            adj = false;
          }
        }
      }
    }
  }
}

// The estimator's switches: NEE, the silhouette surrogates, the metal and
// the dielectric chains. Each combination is its own kernel, with the
// absent parts compiled out (as dispatch_kinds does for the forward
// kernels).
template <bool NEE, bool SIL, bool MET, bool DIE>
struct Flags {
  static constexpr bool nee = NEE, sil = SIL, met = MET, die = DIE;
};

// Calls launcher.template run<Flags<...>>() for the run-time switches.
// Every combination is built: render_value_and_grad takes nee and
// silhouette from its caller, and the scene decides metal and dielectric.
// ops/diff_schedule.py's variant_key names the same 16 cases.
template <class Launcher>
cudaError_t dispatch_flags(bool nee, bool sil, bool met, bool die,
                           const Launcher& l) {
  const int key = (nee ? 8 : 0) | (sil ? 4 : 0) | (met ? 2 : 0) |
                  (die ? 1 : 0);
  switch (key) {
    case 0: return l.template run<Flags<false, false, false, false>>();
    case 1: return l.template run<Flags<false, false, false, true>>();
    case 2: return l.template run<Flags<false, false, true, false>>();
    case 3: return l.template run<Flags<false, false, true, true>>();
    case 4: return l.template run<Flags<false, true, false, false>>();
    case 5: return l.template run<Flags<false, true, false, true>>();
    case 6: return l.template run<Flags<false, true, true, false>>();
    case 7: return l.template run<Flags<false, true, true, true>>();
    case 8: return l.template run<Flags<true, false, false, false>>();
    case 9: return l.template run<Flags<true, false, false, true>>();
    case 10: return l.template run<Flags<true, false, true, false>>();
    case 11: return l.template run<Flags<true, false, true, true>>();
    case 12: return l.template run<Flags<true, true, false, false>>();
    case 13: return l.template run<Flags<true, true, false, true>>();
    case 14: return l.template run<Flags<true, true, true, false>>();
    default: return l.template run<Flags<true, true, true, true>>();
  }
}

// Blocks of `kernel` (kBlock threads, `smem` bytes of dynamic shared
// memory) one SM holds at once, and the SMs of the current device.
template <class Kernel>
cudaError_t occupancy(Kernel kernel, int block, size_t smem, int* per_sm,
                      int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess && smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, block,
                                                      smem);
  }
  return e;
}

// The stages a launcher of K5 or K4 times when it is given events (while
// a profiler records: utils/profiling.stage_events): the image kernel
// with its fold, the replay-and-adjoint kernel, the reduce. Stage k runs
// from events[k] to events[k + 1].
enum Stage { kStageImage = 0, kStageAdjoint = 1, kStageReduce = 2,
             kStageEnd = 3 };

// Records boundary k on `st` when `events` is set; nothing otherwise.
inline cudaError_t mark_stage(void* const* events, int k, cudaStream_t st) {
  return events == nullptr
             ? cudaSuccess
             : cudaEventRecord(static_cast<cudaEvent_t>(events[k]), st);
}

}  // namespace diff
}  // namespace tinyrt
