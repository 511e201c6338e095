// Classic-layout path-tracing megakernel (K2) for Hopper (sm_90a).
//
// Replaces the TPU kernel tinyraytracer_tpu/ops/megakernel.py:489
// (`_make_kernel` in its default regen mode, launched from `_run_kernel`,
// :1139): the whole forward sampler for scenes of any size, one launch per
// image. It runs the same per-pixel sampler as K1 (common.cuh) and differs
// in the scene layout and the closest-hit search. Its plain PyTorch twin
// is `render_flat_reference` in ops/megakernel.py.
//
// Design: one thread per pixel in blocks of 16x8, the grid over (W, H)
// and, for an image of less than one wave of the card, over parts of
// each pixel's samples (common.cuh: the sampler, the block shape and the
// split rule). The TPU kernel's dense (rows, rays) candidate matrix, its
// row-streamed fold and its one-hot payload product become, per thread:
// - a walk over the real sphere rows, then the real quad rows, read from
//   device memory through the read-only path (`__ldg`), with the strict
//   `<` running minimum (the TPU kernel's first index at the minimum; its
//   streamed fold keeps the same winner, megakernel.py:731). Rows are AoS
//   float4s (sphere: c, r^2; quad: n, dp | av, ca | bv, cb), and all the
//   threads of a warp read the same row, so each load is a broadcast; the
//   8 000-sphere geometry is 128 KB and lives in L1/L2. Inert pad rows
//   never win and are not walked.
// - one fetch of the winner's 16-float payload row by index after the
//   walk, in place of the one-hot (16, NA) @ (NA, TR) product.
// - with AABBs, the sphere rows in blocks of `chunk` with the TPU kernel's
//   clamped base min(i*chunk, ns-chunk); the thread skips a block when
//   its own ray does not enter the block's AABB at max(near, 1e-3) <= far
//   before its current best hit: JAX's slab test with its 1e-24
//   reciprocal guard, op for op (megakernel.py:767-807). The TPU decides
//   per tile of rays (one lane's entry keeps a block in); this decides per
//   thread. A re-walked overlap row of the clamped tail block never wins
//   again under strict `<`, as in the TPU fold.
//
// What bounds it: FP32 issue. A sphere row costs about 25-30 operations
// per bounce segment (with --fmad=false every add and multiply is its own
// instruction), a quad row about 35, and shading plus the camera ray a
// few hundred per segment; memory traffic is one float3 out per pixel
// (and, when the samples are split, 12 bytes per sample to a scratch and
// back). Idle lanes are what the design fights: the sampler regenerates
// per lane, so a warp pays its busiest lane's bounce total over all its
// samples, not every sample's longest path; under one wave the slowest
// pixels set the time, so their samples run on several threads and
// fold_kernel adds the colours up in sample order. Culled blocks save
// work only when the whole warp skips them. Tried and dropped: the real
// rows staged in shared memory per block (no faster than the read-only
// broadcast at config 4). Not done: a warp-level cull vote (a warp walks
// the union of its lanes' blocks, about 15 % more rows than one lane: the
// most a vote could save), a BVH-like ordering of the rows.

#include "common.cuh"

namespace {

using namespace tinyrt;

// Compacted rows in device memory (scene_table.FlatScene).
struct FlatScene {
  const float4* sph;   // (ns): cx cy cz r2
  const float4* quad;  // (nq, 3): n dp | av ca | bv cb
  const float4* pay;   // (NA, 4): 16-float payload rows
  const float4* aabb;  // (n_blocks, 2): min, 0 | max, 0
  int n_sph, ns, n_quad, q_row0, n_blocks, chunk;

  __device__ __forceinline__ void sphere_row(int k, float ox, float oy,
                                             float oz, float dx, float dy,
                                             float dz, float& best,
                                             int& win) const {
    const float4 s = __ldg(sph + k);
    const float ts =
        sphere_hit_t(s.x, s.y, s.z, s.w, ox, oy, oz, dx, dy, dz);
    if (ts < best) {  // strict: the first minimum keeps the win
      best = ts;
      win = k;
    }
  }

  __device__ __forceinline__ void closest_hit(float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              float& best,
                                              Payload& w) const {
    best = kMiss;
    int win = -1;
    if (n_blocks > 0) {
      // slab-test reciprocals, shared by every block's AABB test
      const float inv_dx = 1.0f / (fabsf(dx) < 1e-24f ? 1e-24f : dx);
      const float inv_dy = 1.0f / (fabsf(dy) < 1e-24f ? 1e-24f : dy);
      const float inv_dz = 1.0f / (fabsf(dz) < 1e-24f ? 1e-24f : dz);
      for (int i = 0; i < n_blocks; ++i) {
        const int base = min(i * chunk, ns - chunk);
        const float4 mn = __ldg(aabb + 2 * i);
        const float4 mx = __ldg(aabb + 2 * i + 1);
        const float tx0 = (mn.x - ox) * inv_dx;
        const float tx1 = (mx.x - ox) * inv_dx;
        const float ty0 = (mn.y - oy) * inv_dy;
        const float ty1 = (mx.y - oy) * inv_dy;
        const float tz0 = (mn.z - oz) * inv_dz;
        const float tz1 = (mx.z - oz) * inv_dz;
        const float t_near = fmaxf(fminf(tx0, tx1),
                                   fmaxf(fminf(ty0, ty1), fminf(tz0, tz1)));
        const float t_far = fminf(fmaxf(tx0, tx1),
                                  fminf(fmaxf(ty0, ty1), fmaxf(tz0, tz1)));
        const float lo = fmaxf(t_near, kTMin);
        if (!(lo <= t_far && lo < best)) continue;
        const int end = min(base + chunk, n_sph);
        for (int k = base; k < end; ++k) {
          sphere_row(k, ox, oy, oz, dx, dy, dz, best, win);
        }
      }
    } else {
      for (int k = 0; k < n_sph; ++k) {
        sphere_row(k, ox, oy, oz, dx, dy, dz, best, win);
      }
    }
    for (int j = 0; j < n_quad; ++j) {
      const float4 a = __ldg(quad + 3 * j);
      const float4 b = __ldg(quad + 3 * j + 1);
      const float4 c = __ldg(quad + 3 * j + 2);
      const float ts = quad_hit_t(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                                  c.x, c.y, c.z, c.w, ox, oy, oz, dx, dy, dz);
      if (ts < best) {
        best = ts;
        win = q_row0 + j;
      }
    }
    if (win < 0) {
      w = miss_payload();
      return;
    }
    // payload row: isq c(3) | nhat(3) kind | albedo(3) fuzz | ior emit(3)
    const float4 p0 = __ldg(pay + 4 * win);
    const float4 p1 = __ldg(pay + 4 * win + 1);
    const float4 p2 = __ldg(pay + 4 * win + 2);
    const float4 p3 = __ldg(pay + 4 * win + 3);
    const bool quad_win = p0.x > 0.5f;
    w.isq = p0.x;
    w.ax = quad_win ? p1.x : p0.y;
    w.ay = quad_win ? p1.y : p0.z;
    w.az = quad_win ? p1.z : p0.w;
    w.kind = p1.w;
    w.ar = p2.x;
    w.ag = p2.y;
    w.ab = p2.z;
    w.fuzz = p2.w;
    w.ior = p3.x;
    w.er = p3.y;
    w.eg = p3.z;
    w.eb = p3.w;
  }
};

template <bool HAS_MET, bool HAS_DIE, bool SKY>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    flat_kernel(const float* __restrict__ cam_g, FlatScene scene, Frame f) {
  __shared__ float cam[kCamWords];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < kCamWords) cam[tid] = cam_g[tid];
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  render_pixel<HAS_MET, HAS_DIE, SKY>(cam, scene, f, x, y, blockIdx.z);
}

// Adds up each pixel's per-sample colours in sample order and writes the
// mean: the fold render_pixel does when a thread owns all samples.
__global__ void fold_kernel(const float* __restrict__ samples,
                            float* __restrict__ out, int npix, int spp,
                            float inv_spp) {
  const int pid = blockIdx.x * blockDim.x + threadIdx.x;
  if (pid >= npix) return;
  float r = 0.0f, g = 0.0f, b = 0.0f;
  for (int s = 0; s < spp; ++s) {
    const float* c = samples + ((size_t)s * npix + pid) * 3;
    r = r + c[0];
    g = g + c[1];
    b = b + c[2];
  }
  out[3 * (size_t)pid] = r * inv_spp;
  out[3 * (size_t)pid + 1] = g * inv_spp;
  out[3 * (size_t)pid + 2] = b * inv_spp;
}

// Launches the kernel for `f` or, with `split` set, only writes the
// sample split a launch of f's image takes (common.cuh, sample_split).
struct FlatLaunch {
  const float* cam;
  FlatScene scene;
  Frame f;
  cudaStream_t stream;
  int* split;

  template <bool HAS_MET, bool HAS_DIE, bool SKY>
  cudaError_t run() const {
    auto kernel = flat_kernel<HAS_MET, HAS_DIE, SKY>;
    if (split != nullptr) {
      return sample_split(kernel, 0, f.width, f.height, f.spp, *split);
    }
    kernel<<<forward_grid(f), dim3(kBlockX, kBlockY), 0, stream>>>(
        cam, scene, f);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Renders samples [spp_offset, +spp) of a (height, width) image on
// `stream`: the mean radiance into `out` (H, W, 3) when split is 1; with
// split > 1 each sample's colour into `samples` (spp, H * W, 3), for
// tinyrt_fold_samples. `sph` (ns, 4), `quad` (nq, 12) and `pay` (NA, 16)
// are 16-byte aligned f32 rows; n_sph / n_quad real rows are walked; quad
// j's payload row is q_row0 + j. `aabb` (n_blocks, 8), or null with
// n_blocks 0, turns on the cull over blocks of `chunk` sphere rows.
// Returns the launch's cudaError_t (0 on success); does not synchronise.
int tinyrt_megakernel_flat(const float* cam, const float* sph, int n_sph,
                           int ns, const float* quad, int n_quad,
                           const float* pay, int q_row0, const float* aabb,
                           int n_blocks, int chunk, float* out,
                           float* samples, int width, int height,
                           unsigned int seed, unsigned int spp_offset,
                           int spp, int max_bounces, float inv_spp,
                           int split, int has_met, int has_die, int sky,
                           void* stream) {
  const FlatScene scene{reinterpret_cast<const float4*>(sph),
                        reinterpret_cast<const float4*>(quad),
                        reinterpret_cast<const float4*>(pay),
                        reinterpret_cast<const float4*>(aabb),
                        n_sph, ns, n_quad, q_row0, n_blocks, chunk};
  const Frame f{out, samples, width, height, seed, spp_offset, spp,
                max_bounces, split, inv_spp};
  const FlatLaunch launch{cam, scene, f, static_cast<cudaStream_t>(stream),
                          nullptr};
  return (int)dispatch_kinds(has_met != 0, has_die != 0, sky != 0, launch);
}

// The sample split (parts per pixel) of a launch of this image on the
// current device, or minus the cudaError_t of the query.
int tinyrt_megakernel_flat_split(int width, int height, int spp,
                                 int has_met, int has_die, int sky) {
  int split = 0;
  const Frame f{nullptr, nullptr, width, height, 0u, 0u, spp, 0, 1, 0.0f};
  const FlatLaunch query{nullptr, FlatScene{}, f, nullptr, &split};
  const cudaError_t e =
      dispatch_kinds(has_met != 0, has_die != 0, sky != 0, query);
  return e == cudaSuccess ? split : -(int)e;
}

// out (npix, 3) = the in-order sum over s of samples (spp, npix, 3), times
// inv_spp. Returns the launch's cudaError_t; does not synchronise.
int tinyrt_fold_samples(const float* samples, float* out, int npix, int spp,
                        float inv_spp, void* stream) {
  const int threads = 256;
  fold_kernel<<<(npix + threads - 1) / threads, threads, 0,
                static_cast<cudaStream_t>(stream)>>>(samples, out, npix, spp,
                                                     inv_spp);
  return (int)cudaGetLastError();
}

}  // extern "C"
