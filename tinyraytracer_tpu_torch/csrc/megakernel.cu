// Classic-layout path-tracing megakernel (K2) for Hopper (sm_90a).
//
// Replaces the TPU kernel tinyraytracer_tpu/ops/megakernel.py:489
// (`_make_kernel` in its default regen mode, launched from `_run_kernel`,
// :1139): the whole forward sampler for scenes of any size, one launch per
// image. It runs the same per-pixel sampler as K1 (common.cuh) and differs
// in the scene layout and the closest-hit search. Its plain PyTorch twin
// is `render_flat_reference` in ops/megakernel.py.
//
// Design: one thread per pixel in blocks of 16x8, the grid over the image
// rows that the launch's pixel range spans (the whole image, or a mesh
// shard's range: parallel/sharded.py) and, for a range of less than one
// wave of the card, over parts of each pixel's samples (common.cuh: the
// sampler, the range, the block shape and the split rule). The TPU
// kernel's dense (rows, rays) candidate matrix, its row-streamed fold and
// its one-hot payload product become, per thread, one of three searches
// over the compacted rows (the host's route: ops/megakernel.py), then one
// fetch of the winner's 16-float payload row by index in place of the
// one-hot (16, NA) @ (NA, TR) product. Rows are AoS float4s (sphere: c,
// r^2; quad: n, dp | av, ca | bv, cb) read through the read-only path
// (`__ldg`); inert pad rows never win and are not walked.
// - Dense (FlatScene): every real sphere row, then every real quad row,
//   with the strict `<` running minimum (the TPU kernel's first index at
//   the minimum; its streamed fold keeps the same winner,
//   megakernel.py:731). All the threads of a warp read the same row, so
//   each load is a broadcast.
// - Culled (FlatScene with AABBs, above AUTO_CULL_ROWS): the sphere rows
//   in blocks of `chunk` with the TPU kernel's clamped base
//   min(i*chunk, ns-chunk); the thread skips a block when its own ray
//   does not enter the block's AABB at max(near, 1e-3) <= far before its
//   current best hit: JAX's slab test with its 1e-24 reciprocal guard, op
//   for op (megakernel.py:767-807). A re-walked overlap row of the
//   clamped tail block never wins again under strict `<`.
// - BVH (BvhScene, mid-size scenes): each thread walks a threaded BVH
//   (ops/bvh.py's build, one row a leaf) with no stack: an inner node's
//   box is slab-tested over [max(near, 1e-3), min(far, best)] and the
//   walk descends on entry, else takes the node's miss link; a leaf tests
//   its row with the dense search's own sphere_hit_t / quad_hit_t and
//   takes it when t < best, or t == best from a lower row. Each tested
//   row gives the dense t bit for bit, and a row the walk skips lies in a
//   box entered only after the best hit, so the winner (t, row) is the
//   dense search's, exact ties included, as long as the hit tests' own
//   f32 rounding keeps a reported hit inside the row's box (padded 5e-5
//   a side). A ray tested from about a thousand units away breaks that:
//   the dense search can report a "hit" outside a small sphere, which a
//   box culls (PERF.md §6: one sample in 405 million at the final
//   scene's full size). The node loads diverge across a warp; the tree
//   (32 bytes a node) lives in L1/L2.
//
// What bounds it: FP32 issue over the tests a ray runs. A sphere row costs
// about 25-30 operations per bounce segment (with --fmad=false every add
// and multiply is its own instruction), a quad row about 35, a box test
// about 20, and shading plus the camera ray a few hundred per segment;
// memory traffic is one float3 out per pixel (and, when the samples are
// split, 12 bytes per sample to a scratch and back). The dense search
// runs every row; the walk runs a few dozen node and row tests on a
// 500-sphere scene, at a lower rate than the dense broadcast loop: its
// node loads form a dependent chain, and a warp runs its busiest lane's
// steps and both kinds of step where its lanes disagree (the counting
// instantiation's walk counters measure both). Idle lanes are what the
// sampler fights: it regenerates per lane, so a warp pays its busiest
// lane's bounce total over all its samples, not every sample's longest
// path; under one wave the slowest pixels set the time, so their samples
// run on several threads and fold_kernel adds the colours up in sample
// order. Culled blocks save work only when the whole warp skips them.
// Tried and dropped: the real rows staged in shared memory per block (no
// faster than the read-only broadcast at config 4), a warp-level cull
// vote (a warp walks the union of its lanes' blocks, about 15 % more rows
// than one lane: the most a vote could save).
//
// Media (HAS_MED: FlatMedScene, BvhMedScene, launched by
// tinyrt_megakernel_flat with n_med > 0): a ConstantMedium is one more row, after
// the quads (its payload row after theirs), tested by common.cuh's
// medium_hit_t: the boundary's two roots, then the free-flight distance
// from the medium's own draw. The dense and culled searches test every
// medium after the quads; in the walk a medium is a leaf whose box is
// its boundary's. A medium's hit lies between its boundary's roots, so
// inside that box, and the walk's cull keeps the dense winner as for a
// sphere. The sampled distance makes paths long: a camera ray inside a
// thin fog, or a path inside a dense ball, scatters every few units, so
// media move path lengths and lane divergence as well as the tests.

#include "common.cuh"

namespace {

using namespace tinyrt;

// Media rows (scene_table.medium_rows): medium k is two float4s, (c xyz,
// r^2) and (-1/density, 0, 0, 0), and payload row m_row0 + k.
struct MedRows {
  const float4* med;
  int n_med, m_row0;
};

// Medium k's hit distance (common.cuh, medium_hit_t).
__device__ __forceinline__ float medium_row_t(const MedRows& m, int k,
                                              float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              float best,
                                              const MedKey& key) {
  const float4 a = __ldg(m.med + 2 * k);
  const float4 b = __ldg(m.med + 2 * k + 1);
  return medium_hit_t(a.x, a.y, a.z, a.w, b.x, ox, oy, oz, dx, dy, dz, best,
                      key, (uint32_t)k);
}

// The winner's payload: row `win` of `pay` (NA, 16), or the miss payload
// for -1. Row: isq c(3) | nhat(3) kind | albedo(3) fuzz | ior emit(3).
__device__ __forceinline__ void load_payload(const float4* pay, int win,
                                             Payload& w) {
  if (win < 0) {
    w = miss_payload();
    return;
  }
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

// Slab-test reciprocals of a direction, with JAX's 1e-24 guard.
__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) < 1e-24f ? 1e-24f : d);
}

// The ray's entry into the box [mn, mx] at max(near, 1e-3), and its exit.
__device__ __forceinline__ void slab(float mnx, float mny, float mnz,
                                     float mxx, float mxy, float mxz,
                                     float ox, float oy, float oz,
                                     float inv_dx, float inv_dy,
                                     float inv_dz, float& lo, float& far) {
  const float tx0 = (mnx - ox) * inv_dx;
  const float tx1 = (mxx - ox) * inv_dx;
  const float ty0 = (mny - oy) * inv_dy;
  const float ty1 = (mxy - oy) * inv_dy;
  const float tz0 = (mnz - oz) * inv_dz;
  const float tz1 = (mxz - oz) * inv_dz;
  const float t_near = fmaxf(fminf(tx0, tx1),
                             fmaxf(fminf(ty0, ty1), fminf(tz0, tz1)));
  far = fminf(fmaxf(tx0, tx1), fminf(fmaxf(ty0, ty1), fmaxf(tz0, tz1)));
  lo = fmaxf(t_near, kTMin);
}

// Compacted rows in device memory (scene_table.FlatScene), searched
// densely, or by blocks with AABBs. closest_hit returns the lane's tests:
// rows, plus blocks where it culls (`search<true>`, FlatMedScene's: and
// every medium after the quads).
struct FlatScene {
  static constexpr bool kCountsWalk = true;
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

  template <bool MED>
  __device__ __forceinline__ int search(float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float& best, int& win,
                                        const MedRows& m,
                                        const MedKey& key) const {
    best = kMiss;
    win = -1;
    int tests = n_quad;
    if (n_blocks > 0) {
      const float inv_dx = safe_inv(dx);
      const float inv_dy = safe_inv(dy);
      const float inv_dz = safe_inv(dz);
      for (int i = 0; i < n_blocks; ++i) {
        const int base = min(i * chunk, ns - chunk);
        const float4 mn = __ldg(aabb + 2 * i);
        const float4 mx = __ldg(aabb + 2 * i + 1);
        float lo, t_far;
        slab(mn.x, mn.y, mn.z, mx.x, mx.y, mx.z, ox, oy, oz, inv_dx, inv_dy,
             inv_dz, lo, t_far);
        ++tests;
        if (!(lo <= t_far && lo < best)) continue;
        const int end = min(base + chunk, n_sph);
        tests += end - base;
        for (int k = base; k < end; ++k) {
          sphere_row(k, ox, oy, oz, dx, dy, dz, best, win);
        }
      }
    } else {
      tests += n_sph;
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
    if (MED) {
      tests += m.n_med;
      for (int k = 0; k < m.n_med; ++k) {
        const float ts = medium_row_t(m, k, ox, oy, oz, dx, dy, dz, best,
                                      key);
        if (ts < best) {
          best = ts;
          win = m.m_row0 + k;
        }
      }
    }
    return tests;
  }

  __device__ __forceinline__ int closest_hit(float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float& best, Payload& w) const {
    int win;
    const int tests =
        search<false>(ox, oy, oz, dx, dy, dz, best, win, MedRows{}, MedKey{});
    load_payload(pay, win, w);
    return tests;
  }
};

// FlatScene with media (HAS_MED).
struct FlatMedScene : FlatScene {
  static constexpr bool kHasMed = true;
  MedRows m;

  __device__ __forceinline__ int closest_hit(float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float& best, Payload& w,
                                             const MedKey& key) const {
    int win;
    const int tests =
        search<true>(ox, oy, oz, dx, dy, dz, best, win, m, key);
    load_payload(pay, win, w);
    return tests;
  }
};

// The same rows searched by a threaded BVH (scene_table.FlatScene.nodes):
// node i is two float4s, (min xyz, leaf) and (max xyz, miss), the ints
// stored as their bits. An inner node has leaf -1 and its first child at
// i + 1 (DFS preorder); a leaf holds one row, sphere k as k and quad j as
// q_row0 + j, medium k (BvhMedScene) as m_row0 + k; miss is the node
// after i's subtree, n_nodes after the last. closest_hit returns the
// lane's tests: nodes visited, leaves included.
struct BvhScene {
  static constexpr bool kCountsWalk = true;
  const float4* sph;    // (ns): cx cy cz r2
  const float4* quad;   // (nq, 3): n dp | av ca | bv cb
  const float4* pay;    // (NA, 4): 16-float payload rows
  const float4* nodes;  // (n_nodes, 2)
  int n_nodes, q_row0;

  template <bool MED>
  __device__ __forceinline__ int walk(float ox, float oy, float oz, float dx,
                                      float dy, float dz, float& best,
                                      int& win, const MedRows& m,
                                      const MedKey& key) const {
    best = kMiss;
    win = -1;
    const float inv_dx = safe_inv(dx);
    const float inv_dy = safe_inv(dy);
    const float inv_dz = safe_inv(dz);
    int node = 0, tests = 0;
    while (node < n_nodes) {
      ++tests;
      const float4 a = __ldg(nodes + 2 * node);
      const float4 b = __ldg(nodes + 2 * node + 1);
      const int row = __float_as_int(a.w);
      if (row >= 0) {
        float ts;
        if (MED && row >= m.m_row0) {
          ts = medium_row_t(m, row - m.m_row0, ox, oy, oz, dx, dy, dz, best,
                            key);
        } else if (row < q_row0) {
          const float4 s = __ldg(sph + row);
          ts = sphere_hit_t(s.x, s.y, s.z, s.w, ox, oy, oz, dx, dy, dz);
        } else {
          const float4* q = quad + 3 * (row - q_row0);
          const float4 qa = __ldg(q);
          const float4 qb = __ldg(q + 1);
          const float4 qc = __ldg(q + 2);
          ts = quad_hit_t(qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w,
                          qc.x, qc.y, qc.z, qc.w, ox, oy, oz, dx, dy, dz);
        }
        // the lowest row at the least t, as the dense search's first
        // minimum in row order
        if (ts < best || (ts == best && row < win)) {
          best = ts;
          win = row;
        }
        node = __float_as_int(b.w);
      } else {
        float lo, t_far;
        slab(a.x, a.y, a.z, b.x, b.y, b.z, ox, oy, oz, inv_dx, inv_dy,
             inv_dz, lo, t_far);
        node = lo <= fminf(t_far, best) ? node + 1 : __float_as_int(b.w);
      }
    }
    return tests;
  }

  __device__ __forceinline__ int closest_hit(float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float& best, Payload& w) const {
    int win;
    const int tests =
        walk<false>(ox, oy, oz, dx, dy, dz, best, win, MedRows{}, MedKey{});
    load_payload(pay, win, w);
    return tests;
  }
};

// BvhScene with media (HAS_MED).
struct BvhMedScene : BvhScene {
  static constexpr bool kHasMed = true;
  MedRows m;

  __device__ __forceinline__ int closest_hit(float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float& best, Payload& w,
                                             const MedKey& key) const {
    int win;
    const int tests = walk<true>(ox, oy, oz, dx, dy, dz, best, win, m, key);
    load_payload(pay, win, w);
    return tests;
  }
};

template <bool HAS_MET, bool HAS_DIE, bool SKY, bool COUNT, class Scene>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    flat_kernel(const float* __restrict__ cam_g, Scene scene, Frame f) {
  __shared__ float cam[kCamWords];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < kCamWords) cam[tid] = cam_g[tid];
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = f.row0 + blockIdx.y * blockDim.y + threadIdx.y;
  render_pixel<HAS_MET, HAS_DIE, SKY, COUNT>(cam, scene, f, x, y,
                                             blockIdx.z);
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

// Launches the kernel for `f` over `scene` (its counting instantiation
// when f.counts is set) or, with `split` set, only writes the sample split
// a launch of f's image takes (common.cuh, sample_split; that of the
// kernel that does not count).
template <class Scene>
struct FlatLaunch {
  const float* cam;
  Scene scene;
  Frame f;
  cudaStream_t stream;
  int* split;

  template <bool HAS_MET, bool HAS_DIE, bool SKY>
  cudaError_t run() const {
    if (split == nullptr && f.counts != nullptr) {
      return go(flat_kernel<HAS_MET, HAS_DIE, SKY, true, Scene>);
    }
    return go(flat_kernel<HAS_MET, HAS_DIE, SKY, false, Scene>);
  }

  template <class Kernel>
  cudaError_t go(Kernel kernel) const {
    if (split != nullptr) {
      return sample_split(kernel, 0, f.width, f.rows, f.spp, *split);
    }
    kernel<<<forward_grid(f), dim3(kBlockX, kBlockY), 0, stream>>>(
        cam, scene, f);
    return cudaGetLastError();
  }
};

template <class Scene>
cudaError_t dispatch_flat(const float* cam, const Scene& scene,
                          const Frame& f, cudaStream_t stream, int* split,
                          int has_met, int has_die, int sky) {
  const FlatLaunch<Scene> launch{cam, scene, f, stream, split};
  return dispatch_kinds(has_met != 0, has_die != 0, sky != 0, launch);
}

}  // namespace

extern "C" {

// Renders samples [spp_offset, +spp) of the pixels [pix0, pix0 + npix) of
// a (height, width) image on `stream` (common.cuh, Frame): the mean
// radiance into `out` (npix, 3) when split is 1; with split > 1 each
// sample's colour into `samples` (spp, npix, 3), for tinyrt_fold_samples.
// `sph` (ns, 4), `quad` (nq, 12) and `pay` (NA, 16) are 16-byte aligned
// f32 rows; n_sph / n_quad real rows are searched; quad j's payload row
// is q_row0 + j. `aabb` (n_blocks, 8), or null with n_blocks 0, turns on
// the cull over blocks of `chunk` sphere rows; `nodes` (n_nodes, 8), or
// null with n_nodes 0, the BVH walk instead (BvhScene: its links and rows
// are trusted). `counts`, or null, is the device's counter buffer, as
// tinyrt_megakernel_packed's. `med` (n_med, 8), 16-byte aligned f32 rows
// (scene_table.medium_rows), medium k's payload row m_row0 + k (after the
// quads'), or null with n_med 0: with n_med > 0 the HAS_MED kernel
// (FlatMedScene, BvhMedScene) runs, and every route also tests the media:
// the dense and culled searches after the quads, the walk at their leaves
// (`nodes` then holds them); with `counts` it adds its segments that
// ended in a medium to counts[4]. Returns the launch's cudaError_t (0 on
// success; cudaErrorInvalidValue for a range outside the image, for both
// AABBs and nodes, or for n_med < 0); does not synchronise.
int tinyrt_megakernel_flat(const float* cam, const float* sph, int n_sph,
                           int ns, const float* quad, int n_quad,
                           const float* pay, int q_row0, const float* aabb,
                           int n_blocks, int chunk, const float* nodes,
                           int n_nodes, float* out, float* samples,
                           int width, int height, unsigned int seed,
                           unsigned int spp_offset, int spp,
                           int max_bounces, float inv_spp, int split,
                           int has_met, int has_die, int sky, int pix0,
                           int npix, unsigned long long* counts,
                           void* stream, const float* med, int n_med,
                           int m_row0) {
  Frame f = make_frame(out, samples, width, height, pix0, npix, seed,
                       spp_offset, spp, max_bounces, split, inv_spp);
  if (f.npix == 0 || (n_blocks > 0 && n_nodes > 0) || n_med < 0) {
    return (int)cudaErrorInvalidValue;
  }
  f.counts = counts;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BvhScene bvh{reinterpret_cast<const float4*>(sph),
                     reinterpret_cast<const float4*>(quad),
                     reinterpret_cast<const float4*>(pay),
                     reinterpret_cast<const float4*>(nodes), n_nodes,
                     q_row0};
  const FlatScene flat{reinterpret_cast<const float4*>(sph),
                       reinterpret_cast<const float4*>(quad),
                       reinterpret_cast<const float4*>(pay),
                       reinterpret_cast<const float4*>(aabb),
                       n_sph, ns, n_quad, q_row0, n_blocks, chunk};
  cudaError_t e;
  if (n_med > 0) {
    const MedRows m{reinterpret_cast<const float4*>(med), n_med, m_row0};
    e = n_nodes > 0
            ? dispatch_flat(cam, BvhMedScene{bvh, m}, f, s, nullptr,
                            has_met, has_die, sky)
            : dispatch_flat(cam, FlatMedScene{flat, m}, f, s, nullptr,
                            has_met, has_die, sky);
  } else {
    e = n_nodes > 0 ? dispatch_flat(cam, bvh, f, s, nullptr, has_met,
                                    has_die, sky)
                    : dispatch_flat(cam, flat, f, s, nullptr, has_met,
                                    has_die, sky);
  }
  return (int)e;
}

// The sample split (parts per pixel) of a launch over `rows` image rows of
// `width` pixels (the rows a range spans) on the current device, by the
// kernel of the BVH walk when `bvh` is set, else of the dense or culled
// search, its HAS_MED instantiation when `med` is set; or minus the
// cudaError_t of the query.
int tinyrt_megakernel_flat_split(int width, int rows, int spp, int has_met,
                                 int has_die, int sky, int bvh, int med) {
  int split = 0;
  const Frame f = make_frame(nullptr, nullptr, width, rows, 0, width * rows,
                             0u, 0u, spp, 0, 1, 0.0f);
  if (f.npix == 0) return -(int)cudaErrorInvalidValue;
  cudaError_t e;
  if (med) {
    e = bvh ? dispatch_flat(nullptr, BvhMedScene{}, f, nullptr, &split,
                            has_met, has_die, sky)
            : dispatch_flat(nullptr, FlatMedScene{}, f, nullptr, &split,
                            has_met, has_die, sky);
  } else {
    e = bvh ? dispatch_flat(nullptr, BvhScene{}, f, nullptr, &split,
                            has_met, has_die, sky)
            : dispatch_flat(nullptr, FlatScene{}, f, nullptr, &split,
                            has_met, has_die, sky);
  }
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
