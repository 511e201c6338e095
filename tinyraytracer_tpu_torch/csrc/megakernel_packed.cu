// Packed path-tracing megakernel (K1) for Hopper (sm_90a).
//
// Replaces the TPU kernel tinyraytracer_tpu/ops/megakernel_packed.py:125
// (`_make_packed_kernel`, with the shading of ops/megakernel.py:206
// `_shade_bounce` and the sample loop of :365 `_regen_sample_loop`): the
// whole forward sampler for scenes of a few dozen primitives, one launch
// per image. Its plain PyTorch twin is `render_packed_reference` in
// ops/megakernel_packed.py. The sampler, shading and hit tests are
// common.cuh's, shared with K2 (megakernel.cu).
//
// Design: one thread per pixel in blocks of 16x8, running the sampler of
// common.cuh (render_pixel): one bounce per pass of a single loop, a lane
// starting its next sample as soon as its path ends, and, for an image of
// less than one wave of the card, each pixel's samples split over several
// threads and folded in sample order afterwards (fold_kernel in
// megakernel.cu). The scene table (spheres of 13 floats, then quads of
// 24: geometry, then kind, albedo, fuzz, ior, emission) and the 32-word
// camera vector are copied into shared memory at block start and walked
// at run time, spheres first, then quads, with the strict `<` first
// minimum of the TPU kernel (its tie-break decides the Cornell
// light/ceiling z-fight). No primitive count is compiled in; the table's
// size sets the dynamic shared memory.
//
// What bounds it: FP32 ALU work and idle lanes. Memory traffic is
// negligible: the table and camera once per block, one float3 out per
// pixel. Deliberately simple, for later work: the material lobes are
// computed for every hit and selected, as the TPU kernel does, where
// branching on the winner's kind would skip work; the table is read from
// shared memory per primitive per bounce, and no acceleration structure
// is used.

#include "common.cuh"

namespace {

using namespace tinyrt;

constexpr int kSphStride = 13;   // c(3) r2 | material(9)
constexpr int kQuadStride = 24;  // n(3) dp av(3) ca bv(3) cb nhat(3) | material(9)
constexpr int kSphFields = 4;
constexpr int kQuadFields = 15;

// The scene table in shared memory.
struct PackedScene {
  const float* tab;
  int n_sph, n_quad;

  __device__ __forceinline__ void closest_hit(float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              float& best,
                                              Payload& w) const {
    best = kMiss;
    int win = -1;
    bool win_quad = false;
    for (int k = 0; k < n_sph; ++k) {
      const float* p = tab + k * kSphStride;
      const float ts = sphere_hit_t(p[0], p[1], p[2], p[3], ox, oy, oz, dx,
                                    dy, dz);
      if (ts < best) {  // strict: the first minimum keeps the win
        best = ts;
        win = k * kSphStride;
        win_quad = false;
      }
    }
    const float* quads = tab + n_sph * kSphStride;
    for (int j = 0; j < n_quad; ++j) {
      const float* p = quads + j * kQuadStride;
      const float ts =
          quad_hit_t(p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8],
                     p[9], p[10], p[11], ox, oy, oz, dx, dy, dz);
      if (ts < best) {
        best = ts;
        win = n_sph * kSphStride + j * kQuadStride;
        win_quad = true;
      }
    }
    if (win < 0) {
      w = miss_payload();
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
};

template <bool HAS_MET, bool HAS_DIE, bool SKY>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    packed_kernel(const float* __restrict__ cam_g,
                  const float* __restrict__ tab_g, int nw, int n_sph,
                  int n_quad, Frame f) {
  extern __shared__ float smem[];  // camera vector, then the scene table
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < kCamWords + nw; i += blockDim.x * blockDim.y) {
    smem[i] = i < kCamWords ? cam_g[i] : tab_g[i - kCamWords];
  }
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const PackedScene scene{smem + kCamWords, n_sph, n_quad};
  render_pixel<HAS_MET, HAS_DIE, SKY>(smem, scene, f, x, y, blockIdx.z);
}

// Launches the kernel for `f` or, with `split` set, only writes the
// sample split a launch of f's image takes (common.cuh, sample_split).
struct PackedLaunch {
  const float* cam;
  const float* tab;
  int nw, n_sph, n_quad;
  Frame f;
  cudaStream_t stream;
  int* split;

  template <bool HAS_MET, bool HAS_DIE, bool SKY>
  cudaError_t run() const {
    auto kernel = packed_kernel<HAS_MET, HAS_DIE, SKY>;
    const size_t smem = sizeof(float) * (size_t)(kCamWords + nw);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    if (split != nullptr) {
      return sample_split(kernel, smem, f.width, f.height, f.spp, *split);
    }
    kernel<<<forward_grid(f), dim3(kBlockX, kBlockY), smem, stream>>>(
        cam, tab, nw, n_sph, n_quad, f);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Renders samples [spp_offset, +spp) of a (height, width) image on
// `stream`: the mean radiance into `out` (H, W, 3) when split is 1; with
// split > 1 each sample's colour into `samples` (spp, H * W, 3), for
// tinyrt_fold_samples. Returns the launch's cudaError_t (0 on success);
// does not synchronise.
int tinyrt_megakernel_packed(const float* cam, const float* tab, int nw,
                             int n_sph, int n_quad, float* out,
                             float* samples, int width, int height,
                             unsigned int seed, unsigned int spp_offset,
                             int spp, int max_bounces, float inv_spp,
                             int split, int has_met, int has_die, int sky,
                             void* stream) {
  const Frame f{out, samples, width, height, seed, spp_offset, spp,
                max_bounces, split, inv_spp};
  const PackedLaunch launch{cam, tab, nw, n_sph, n_quad, f,
                            static_cast<cudaStream_t>(stream), nullptr};
  return (int)dispatch_kinds(has_met != 0, has_die != 0, sky != 0, launch);
}

// The sample split (parts per pixel) of a launch of this image and table
// size on the current device, or minus the cudaError_t of the query.
int tinyrt_megakernel_packed_split(int nw, int width, int height, int spp,
                                   int has_met, int has_die, int sky) {
  int split = 0;
  const Frame f{nullptr, nullptr, width, height, 0u, 0u, spp, 0, 1, 0.0f};
  const PackedLaunch query{nullptr, nullptr, nw, 0, 0, f, nullptr, &split};
  const cudaError_t e =
      dispatch_kinds(has_met != 0, has_die != 0, sky != 0, query);
  return e == cudaSuccess ? split : -(int)e;
}

const char* tinyrt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
