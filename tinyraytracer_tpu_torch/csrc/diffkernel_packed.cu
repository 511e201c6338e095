// Packed fused differentiable kernel (K5) for Hopper (sm_90a).
//
// Replaces the TPU kernel tinyraytracer_tpu/ops/diffkernel_packed.py:240
// (`_make_packed_diff_kernel`): the training objective of scenes of at
// most 48 primitives and 16 spheres in one launch. Its plain PyTorch twin
// is `packed_diff_reference` in ops/diffkernel_packed.py. The estimator
// (shade, advance, color_adds, shadow_vis, the surrogates, bounce_adj and
// the per-pixel phases) lives in diff_common.cuh, shared with K4.
//
// Design: one thread per pixel, 128 pixels per block. A thread runs its
// pixel's whole estimator (diff_pixel), so the loss cotangent of phase 2
// is local and no grid-wide synchronisation is needed. The replay's saves
// are a global scratch laid out [bounce][word][pixel], so that a warp's
// stores and loads coalesce.
// Gradients go into a per-thread accumulator (local memory) laid out
// [sphere 4 | quad 9 | material 8 | light 12 per row | background 3 |
// loss 1]. The block sums it with warp shuffles and then over its 4 warps
// in a fixed order into one row of partial sums per block; a second small
// kernel sums the rows over blocks in block order. Every sum has a fixed
// order, so two launches give the same bits (float atomics would not).
//
// The scene table is the JAX package's flat table, read as it is from
// shared memory and walked at run time; the estimator's switches (NEE,
// silhouette, metal and dielectric chains, surrogate classes) are run-time
// arguments that skip exactly what the TPU kernel compiles out.
//
// What bounds it: FP32 work (several shadings per bounce, the surrogates'
// per-sphere and per-quad chains) and the per-thread register and local
// memory footprint of the adjoint, not bandwidth: the scratch is written
// and read once per live bounce, the table and camera once per block.

#include "diff_common.cuh"

namespace {

using namespace tinyrt;
using namespace tinyrt::diff;

constexpr int kMaxAcc = 1024;  // ops/diffkernel.py DIFF_PACKED_MAX_ACC
constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;

struct Launch {
  int nw, npix, width, spp, mb, na;
  uint32_t spp_offset;
  float inv_spp;
};

__global__ void __launch_bounds__(kBlock)
    diff_kernel(const float* __restrict__ cam_g, const float* __restrict__ tab_g,
                Args a, ClassScope sc, Launch L,
                const float* __restrict__ target,
                float* __restrict__ img, float* __restrict__ saves,
                float* __restrict__ part) {
  extern __shared__ float smem[];  // camera, table, then kWarps x na sums
  for (int i = threadIdx.x; i < kCamWords + L.nw; i += kBlock) {
    smem[i] = i < kCamWords ? cam_g[i] : tab_g[i - kCamWords];
  }
  __syncthreads();
  a.cam = smem;
  a.tab = smem + kCamWords;

  float acc[kMaxAcc];
  for (int j = 0; j < L.na; ++j) acc[j] = 0.0f;

  const int pix = blockIdx.x * kBlock + threadIdx.x;
  if (pix < L.npix) {
    diff_pixel(a, sc, pix, L.width, L.spp, L.mb, L.spp_offset, L.inv_spp,
               target, img, saves + pix, (size_t)L.npix, LocalAcc{acc});
  }

  // ---- block sum of the accumulators, fixed order
  float* red = smem + kCamWords + L.nw;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = 0; j < L.na; ++j) {
    float v = acc[j];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp * L.na + j] = v;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < L.na; j += kBlock) {
    float v = red[j];
    for (int k = 1; k < kWarps; ++k) v = v + red[k * L.na + j];
    part[(size_t)blockIdx.x * L.na + j] = v;
  }
}

// Sums the per-block partial rows in block order; the loss entry is then
// divided by npix * 3 (the mean over pixels and channels).
__global__ void reduce_kernel(const float* __restrict__ part, int blocks,
                              int na, int loss_idx, float loss_div,
                              float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= na) return;
  float v = 0.0f;
  for (int b = 0; b < blocks; ++b) v = v + part[(size_t)b * na + j];
  out[j] = j == loss_idx ? v / loss_div : v;
}

}  // namespace

extern "C" {

// Runs K5 on `stream`: writes the (height, width, 3) image into `img` and
// the summed gradient accumulator (see the file comment) into `acc`.
// `saves` holds max_bounces x 14 x npix floats of scratch, `part`
// ceil(npix / 128) x na. Returns the first launch's cudaError_t (0 on
// success); does not synchronise.
int tinyrt_diff_packed(const float* cam, const float* tab, int nw, int n_sph,
                       int n_quad, int n_lights, int nm, int light_quad,
                       const float* target, float* img, float* saves,
                       float* part, float* acc, int width, int height,
                       unsigned int seed, unsigned int spp_offset, int spp,
                       int max_bounces, float inv_spp, int nee, int sil,
                       int has_met, int has_die, int surr_sph, int surr_quad,
                       void* stream) {
  Args a{};
  const int na = set_layout(a, n_sph, n_quad, n_lights, nm, light_quad);
  a.nee = nee != 0;
  a.sil = sil != 0;
  a.has_met = has_met != 0;
  a.has_die = has_die != 0;
  a.seed = seed;
  const ClassScope sc{surr_sph ? n_sph : 0, surr_quad ? n_quad : 0};
  Launch L;
  L.nw = nw;
  L.npix = width * height;
  L.width = width;
  L.spp = spp;
  L.mb = max_bounces;
  L.na = na;
  L.spp_offset = spp_offset;
  L.inv_spp = inv_spp;
  if (L.na > kMaxAcc) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (L.npix + kBlock - 1) / kBlock;
  const size_t smem = sizeof(float) * ((size_t)kCamWords + nw +
                                       (size_t)kWarps * L.na);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        diff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  diff_kernel<<<blocks, kBlock, smem, st>>>(cam, tab, a, sc, L, target, img,
                                            saves, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float loss_div = (float)(width * height) * 3.0f;
  reduce_kernel<<<(L.na + 127) / 128, 128, 0, st>>>(part, blocks, L.na,
                                                    a.a_loss, loss_div, acc);
  return (int)cudaGetLastError();
}

}  // extern "C"
